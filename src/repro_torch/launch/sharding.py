"""Partition-spec resolver over a ``RankMesh`` (port of
``repro.launch.sharding``): parameter-leaf key paths -> per-dim mesh axes,
the cut of a leaf into one rank's piece, and the mesh-aware consensus
backend.

Weights are sharded two ways on top of the FL (server, client) layout:

* **TP** over the "model" axis — the head / expert / feature dimension the
  leaf's table entry names, with a fallback dimension when the preferred one
  is not divisible by the axis size (e.g. kv-heads=8 on a 16-wide model
  axis: fall back to the head_dim).
* **FSDP** over the "replica" axis (train, R>1) or the "data" axis (serve) —
  a second weight dimension, ZeRO-3 style.

Rules are *name-keyed and right-aligned*: a leaf path's last weight-name
component selects (tp_dims, fsdp_dims) as negative dim indices, so the same
table covers plain leaves (d, h, hd), scanned stacks (periods, d, h, hd) and
DFL client copies (M, N, periods, d, h, hd).  Any leading dims not claimed
by the table get the *lead spec* — ("server", "client") for DFL state, ()
for serve — and everything else is replicated.

A spec is a ``PartitionSpec``: one entry per leading dim, each ``None``
(whole), an axis name, or a tuple of names (split over them, the first
major); dims past its length are whole.  It is a leaf of the port's trees.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import consensus as cns
from repro_torch.launch.mesh import RankMesh
from repro_torch.tree import DictKey, tree_leaves, tree_map_with_path


class PartitionSpec:
    """Per-dim mesh axes of one leaf: ``PartitionSpec("server", None,
    ("replica", "model"))``.  Compares equal to the tuple of its entries;
    indexing and iteration go over them."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        # a one-name tuple is that name, as JAX's PartitionSpec reads it
        self.dims = tuple(d[0] if isinstance(d, tuple) and len(d) == 1
                          else d for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self) -> int:
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.dims == other.dims
        return isinstance(other, tuple) and self.dims == other

    def __hash__(self) -> int:
        return hash(self.dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.dims!r}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes dim ``dim`` is split over, major first."""
        e = self.dims[dim] if dim < len(self.dims) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)

    def used_axes(self) -> Tuple[str, ...]:
        return tuple(a for i in range(len(self.dims)) for a in self.axes(i))


P = PartitionSpec

# name -> (tp candidate dims, fsdp candidate dims), negative = from the right
_RULES: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    "embed":   ((-2,), (-1,)),
    "head":    ((-1,), (-2,)),
    "w_q":     ((-2,), (-3,)),
    "w_k":     ((-2, -1), (-3,)),
    "w_v":     ((-2, -1), (-3,)),
    "w_o":     ((-3,), (-1,)),
    "b_q":     ((-2,), ()),
    "b_k":     ((-2,), ()),
    "b_v":     ((-2,), ()),
    "gate":    ((-1,), (-2,)),
    "up":      ((-1,), (-2,)),
    "down":    ((-2,), (-1,)),
    # MoE expert tables: expert-parallel first, feature-parallel fallback
    "w_gate":  ((-3, -1), (-2,)),
    "w_up":    ((-3, -1), (-2,)),
    "w_down":  ((-3, -2), (-1,)),
    # MLA
    "w_dq":    ((-1,), (-2,)),
    "w_uq":    ((-2,), (-3,)),
    "w_dkv":   ((), (-2,)),          # shared latent projection: TP-replicated
    "w_ukv":   ((-2,), (-3,)),
    # Mamba
    "in_proj": ((-1,), (-2,)),
    "conv_w":  ((-1,), ()),
    "conv_b":  ((-1,), ()),
    "out_proj": ((-2,), (-1,)),
}
# everything else (norm scales, router, biases, a_log, dt_bias, d_skip,
# scalar counters) is replicated beyond the lead spec.

_ATTN_LEAVES = frozenset(
    ("w_q", "w_k", "w_v", "w_o", "b_q", "b_k", "b_v"))


def _leaf_name(path: Tuple) -> str:
    """Last dict-key component of a tree path."""
    for entry in reversed(path):
        if isinstance(entry, DictKey):
            return str(entry.key)
    return ""


def _spec_for_leaf(name: str, ndim: int, shape: Tuple[int, ...],
                   lead: Tuple[Optional[str], ...], tp_axis: Optional[str],
                   tp_size: int, fsdp_axis: Optional[str], fsdp_size: int,
                   mesh_shape: Dict[str, int]) -> PartitionSpec:
    entry = [None] * ndim
    for i, ax in enumerate(lead):
        if i < ndim and ax is not None:
            entry[i] = ax
    n_lead = len(lead)
    tp_dims, fsdp_dims = _RULES.get(name, ((), ()))

    def place(axis: Optional[str], size: int, cands: Sequence[int]) -> None:
        if axis is None or size <= 1:
            return
        for c in cands:
            i = ndim + c
            if i < n_lead or i < 0:
                continue
            if entry[i] is None and shape[i] % size == 0:
                entry[i] = axis
                return

    place(tp_axis, tp_size, tp_dims)
    place(fsdp_axis, fsdp_size, fsdp_dims)
    return PartitionSpec(*entry)


def _tree_specs(tree: Any, lead: Tuple[Optional[str], ...], mesh,
                tp_axis: Optional[str], fsdp_axis: Optional[str],
                attn_tp: bool = True) -> Any:
    """``attn_tp=False`` replicates the attention projections instead of TP
    (archs whose head count does not divide the model axis)."""
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    tp = shape.get(tp_axis, 1) if tp_axis else 1
    fs = shape.get(fsdp_axis, 1) if fsdp_axis else 1

    def leaf_spec(path, leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim == 0:
            return PartitionSpec()
        name = _leaf_name(path)
        use_tp = tp_axis if (attn_tp or name not in _ATTN_LEAVES) else None
        return _spec_for_leaf(name, leaf.ndim, tuple(leaf.shape), lead,
                              use_tp, tp, fsdp_axis, fs, shape)

    return tree_map_with_path(leaf_spec, tree)


# ---------------------------------------------------------------------------
# public resolvers
# ---------------------------------------------------------------------------


def fl_param_specs(params: Any, mesh, *,
                   tp_axis: Optional[str] = "model") -> Any:
    """DFL client params: leaves (M, N, *w) on the FL mesh."""
    return _tree_specs(params, ("server", "client"), mesh,
                       tp_axis=tp_axis, fsdp_axis="replica")


def serve_param_specs(params: Any, mesh, *, fsdp: bool = True,
                      attn_tp: bool = True) -> Any:
    """Serving params on the ("data","model") mesh: TP over "model" always;
    2-D (FSDP over "data") only when ``fsdp``."""
    return _tree_specs(params, (), mesh, tp_axis="model",
                       fsdp_axis="data" if fsdp else None, attn_tp=attn_tp)


def fl_batch_spec(mesh, batch_div_replica: bool,
                  batch_over_model: bool = False) -> PartitionSpec:
    """Per-epoch batch leaves (T_C, M, N, b, ...)."""
    axes = []
    if batch_div_replica:
        axes.append("replica")
    if batch_over_model:
        axes.append("model")
    b_axis = tuple(axes) if axes else None
    return PartitionSpec(None, "server", "client", b_axis)


def fl_state_specs(state: Any, mesh, *,
                   tp_axis: Optional[str] = "model") -> Any:
    """Specs of a ``DFLState`` (params + opt + scalars).  The error-feedback
    residual is server-level wire state (leaves ``(M, *w)``), so it takes
    the ``('server',)`` lead of the server aggregates."""
    specs = _tree_specs(state, ("server", "client"), mesh,
                        tp_axis=tp_axis, fsdp_axis="replica")
    ef = getattr(state, "ef_residual", None)
    if ef is not None and hasattr(specs, "_replace"):
        specs = specs._replace(ef_residual=_tree_specs(
            ef, ("server",), mesh, tp_axis=tp_axis, fsdp_axis="replica"))
    return specs


def fl_server_specs(server_tree: Any, mesh, *,
                    tp_axis: Optional[str] = "model") -> Any:
    """Server-aggregate tree (leaves ``(M, *w)``): the 'server' lead plus
    the client tree's TP / FSDP placement — the leaf specs the shard_map
    consensus backend gossips over."""
    return _tree_specs(server_tree, ("server",), mesh,
                       tp_axis=tp_axis, fsdp_axis="replica")


def named(tree_specs: Any, mesh) -> Any:
    """The identity: a port spec names its mesh axes already (the
    reference wraps each in a ``NamedSharding``)."""
    del mesh
    return tree_specs


# ---------------------------------------------------------------------------
# a leaf's piece on one rank
# ---------------------------------------------------------------------------


def local_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh) -> Tuple[int, ...]:
    """The shape of one rank's piece of a ``shape`` leaf under ``spec``."""
    out = []
    for i, n in enumerate(shape):
        k = int(np.prod([mesh.shape[a] for a in spec.axes(i)],
                        dtype=np.int64))
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {spec.axes(i)} ({k} pieces)")
        out.append(n // k)
    return tuple(out)


def shard_slices(shape: Sequence[int], spec: PartitionSpec, mesh,
                 rank: Optional[int] = None) -> Tuple[slice, ...]:
    """Index of ``rank``'s piece of a ``shape`` leaf: along a dim split
    over axes (a, b), the piece's position is ``coord_a * size_b +
    coord_b``."""
    c = mesh.coords(rank)
    local = local_shape(shape, spec, mesh)
    out = []
    for i, n in enumerate(local):
        pos = 0
        for a in spec.axes(i):
            pos = pos * mesh.shape[a] + c[a]
        out.append(slice(pos * n, (pos + 1) * n))
    return tuple(out)


def local_shard(x, spec: PartitionSpec, mesh, rank: Optional[int] = None):
    """``rank``'s piece of the leaf ``x`` (a view)."""
    return x[shard_slices(tuple(x.shape), spec, mesh, rank)]


def first_copy(spec: PartitionSpec, mesh, rank: Optional[int] = None
               ) -> bool:
    """Whether ``rank`` holds the first copy of its piece: coordinate 0 on
    every axis the spec does not split over.  A replicated piece's copies
    can differ after a quantized round (each rank draws its own dither);
    the first copy is the one the reference returns to the host."""
    used = set(spec.used_axes())
    c = mesh.coords(rank)
    return all(c[a] == 0 for a in mesh.axis_names if a not in used)


def assemble(pieces: Sequence[Any], spec: PartitionSpec, mesh):
    """The global leaf from every rank's piece (``pieces[r]`` rank r's), a
    replicated piece taken from its first copy."""
    import torch
    shape = [n * int(np.prod([mesh.shape[a] for a in spec.axes(i)],
                             dtype=np.int64))
             for i, n in enumerate(pieces[0].shape)]
    out = torch.empty(shape, dtype=pieces[0].dtype, device=pieces[0].device)
    for r, piece in enumerate(pieces):
        if first_copy(spec, mesh, r):
            out[shard_slices(shape, spec, mesh, r)] = piece
    return out


# ---------------------------------------------------------------------------
# the mesh-aware consensus backend
# ---------------------------------------------------------------------------


def fl_consensus_backend(topo: Any, mesh, server_tree: Any, *,
                         tp_axis: Optional[str] = "model",
                         block: Optional[int] = None,
                         compression: str = "none",
                         error_feedback: bool = False,
                         wire: str = "simulated",
                         staleness: int = 0) -> Any:
    """A ``consensus.ShardMapBackend`` gossiping ``server_tree``-shaped
    aggregates (leaves ``(M, *w)``; only their shapes are read) over the
    mesh's 'server' axis with ``fl_server_specs`` placement, seeded with the
    topology's static mixing matrix (a per-epoch ``A_p`` still overrides
    it).  ``mesh`` is a ``launch.mesh.RankMesh`` (each rank then holds its
    piece of its server's row) or a bare ``torch.distributed`` group of M
    ranks, one server a rank.  A ``compression`` other than ``"none"``
    wraps it in a ``consensus.CompressedBackend``; ``wire="physical"``
    makes every round gather the int8 / packed-int4 codes of the rank's
    whole local tree as one bucket (one int8 and one f32 ``all_gather`` a
    round).  ``staleness=s > 0`` pipelines the wire rounds and needs
    ``wire="physical"`` with a quantizer (the backends raise otherwise).
    Inject the result through ``DFLConfig.consensus_backend``."""
    m = topo.num_servers
    lead = {int(leaf.shape[0]) for leaf in tree_leaves(server_tree)}
    if lead != {m}:
        raise ValueError(f"server_tree leaves must lead with M={m} servers, "
                         f"got leading sizes {sorted(lead)}")
    a_np = topo.mixing_matrix() if m > 1 else np.ones((1, 1))
    kw = {} if block is None else {"block": block}
    if isinstance(mesh, RankMesh):
        specs = fl_server_specs(server_tree, mesh, tp_axis=tp_axis)
        backend = cns.ShardMapBackend(
            mesh, a_np, topo.t_server, specs,
            counted=[first_copy(s, mesh) for s in tree_leaves(specs)],
            staleness=staleness, **kw)
    else:
        backend = cns.ShardMapBackend(mesh, a_np, topo.t_server,
                                      staleness=staleness, **kw)
    if compression != "none":
        from repro_torch.comm.compressors import make_compressor
        backend = cns.CompressedBackend(
            backend, make_compressor(compression),
            error_feedback=error_feedback, wire=wire)
    return backend


# ---------------------------------------------------------------------------
# serving cache specs
# ---------------------------------------------------------------------------


def serve_cache_specs(cache: Any, mesh, batch: int,
                      attn_tp: bool = True) -> Any:
    """KV / SSM cache specs.

    batch > 1: shard batch over "data" (heads/features over "model").
    batch == 1 (long_500k): shard the *sequence* dim of length-proportional
    caches over "data"; state-shaped leaves (SSM) shard heads over "model".
    """
    data = mesh.shape.get("data", 1)
    model = mesh.shape.get("model", 1)
    b_axis = "data" if (batch > 1 and batch % data == 0) else None

    def leaf_spec(path, leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim == 0:
            return PartitionSpec()
        name = _leaf_name(path)
        nd = leaf.ndim
        shape = tuple(leaf.shape)
        entry = [None] * nd
        # batch dim: caches under a stack carry (periods, b, ...) or
        # (b, ...) — the first dim whose size == batch
        b_dim = next((i for i, s in enumerate(shape) if s == batch), None)
        if b_dim is not None and b_axis is not None:
            entry[b_dim] = b_axis
        if name in ("k", "v"):                       # (.., b, n, kvh, hd)
            if shape[-2] % model == 0:
                entry[nd - 2] = "model"
            elif attn_tp and shape[-1] % model == 0:
                # hd-sharded cache only when the attention itself is TP'd
                entry[nd - 1] = "model"
            if b_axis is None and batch == 1 and shape[-3] % data == 0:
                entry[nd - 3] = "data"               # seq-sharded cache
        elif name in ("c_kv", "k_rope"):             # MLA latent (.., b, n, r)
            if shape[-1] % model == 0:
                entry[nd - 1] = "model"
            if b_axis is None and batch == 1 and shape[-2] % data == 0:
                entry[nd - 2] = "data"
        elif name == "conv":                         # (.., b, w-1, ch)
            if shape[-1] % model == 0:
                entry[nd - 1] = "model"
        elif name == "ssm":                          # (.., b, nh, ds, hd)
            if shape[-3] % model == 0:
                entry[nd - 3] = "model"
        elif name == "pos":                          # (.., b, n)
            if b_axis is None and batch == 1 and shape[-1] % data == 0:
                entry[nd - 1] = "data"
        elif name in ("cross_k", "cross_v"):         # (.., b, enc, kvh, hd)
            if shape[-2] % model == 0:
                entry[nd - 2] = "model"
            elif shape[-1] % model == 0:
                entry[nd - 1] = "model"
        return PartitionSpec(*entry)

    return tree_map_with_path(leaf_spec, cache)
