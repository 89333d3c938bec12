"""A client cut over ranks: the hand-written counterpart of what GSPMD
inserts around the reference's local period.

Under the reference's plans a client's weights are cut over "replica"
(FSDP, ZeRO-3 style: ``launch.sharding.fl_param_specs(..., tp_axis=None)``)
and its batch over "replica" and, under ``batch_over_model``, over
"model" (``launch.sharding.fl_batch_spec``); GSPMD then gathers a layer's
weights before its forward and backward and reduces its gradients after.
``ClientShards`` does that by hand for one rank, as the leaf provider of
``models.transformer.ApplyOptions``:

* ``top(params)``: the leaves outside the layer stacks (embeddings, head,
  final norms) whole, gathered once a forward (``_Top``); their gradients,
  summed over every use, reduced once in the backward.
* ``run(path, layer, fn, *inputs)``: one layer (``_Layer``).  The forward
  gathers the layer's pieces, runs the block without a tape and frees the
  whole leaves; the backward gathers them again, recomputes the block with
  a tape and takes its gradients, then reduces them to the rank's pieces.
  So autograd keeps a layer's input, never its gathered weights: a rank
  holds its pieces, the top-level leaves and one layer whole at a time.

A unit's gather is one ``consensus.gather_pieces`` (site ``fsdp_gather``)
over the ranks that hold the pieces; its reduction one
``consensus.reduce_to_pieces`` (site ``grad_reduce``) over the ranks the
batch splits over: the whole-leaf gradients of the rank's batch shard are
summed, divided by the shard count (equal shards: the mean of the shards'
mean gradients is the client's mean gradient), and cut to the rank's
piece.  A leaf that is not cut (a norm scale, a bias, the router, a dim
the degree does not divide) passes whole and gets the averaged gradient.
Every rank runs the same units in the same order, so the collectives
match up.

Under tensor parallelism (``launch.tp``) a leaf may be cut over "replica"
and "model" along two dims: the gathers and reductions here run over
"replica" only, and the rank keeps its piece over "model", which the
layers multiply as it is.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import consensus as cns
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map_with_path,
                              tree_unflatten)

#: top-level keys of a params tree whose entries are layers (a ``stack``
#: entry's leaves carry a leading period axis, a ``prefix`` entry's do not)
_LAYER_KEYS = ("stack", "prefix")


def _cut_dim(spec, axes: Sequence[str]) -> Optional[int]:
    """The one dim ``spec`` cuts over the client's gather ``axes``, ``None``
    for a leaf whose pieces are whole over them.  A dim cut over other
    axes ("model", under tensor parallelism: ``launch.tp``) stays the
    rank's piece and is never gathered here."""
    dims = [i for i in range(len(spec)) if set(spec.axes(i)) & set(axes)]
    if len(dims) > 1 or any(set(spec.axes(i)) - set(axes) for i in dims):
        raise ValueError(f"{spec} cuts over {tuple(axes)} along more than "
                         f"one dim, or one dim over other axes too; a "
                         f"client's leaf is gathered along one")
    return dims[0] if dims else None


def _layer_path(path: Tuple) -> Optional[Tuple]:
    """The key of the layer a leaf at ``path`` belongs to (("stack", i),
    ("prefix", i), ("encoder", "stack", i)), ``None`` for a top-level
    leaf."""
    keys = [getattr(e, "key", getattr(e, "idx", None)) for e in path]
    if keys and keys[0] in _LAYER_KEYS:
        return tuple(keys[:2])
    if keys[:2] == ["encoder", "stack"]:
        return tuple(keys[:3])
    return None


def _layer_keys(tree: Any) -> list:
    """Per leaf of ``tree`` (tree order), its layer's key or ``None``."""
    out: list = []
    tree_map_with_path(lambda path, _: out.append(_layer_path(path)), tree)
    return out


class ClientShards:
    """One rank's pieces of a client and the groups they cross.

    ``specs`` is the spec tree of a whole client (one ``PartitionSpec`` a
    leaf over its own dims: the FL lead dims dropped); ``gather_group``
    the ranks over ``gather_axes`` that hold one leaf's pieces (this rank's
    position among them: ``pos`` of ``k``); ``batch_group`` the ranks the
    client's batch splits over (``None``: not split)."""

    def __init__(self, mesh, specs: Any, gather_group, batch_group,
                 gather_axes: Sequence[str]):
        self.mesh, self.specs = mesh, specs
        self.gather_group, self.batch_group = gather_group, batch_group
        self.gather_axes = tuple(gather_axes)
        ranks = mesh.ranks_over(self.gather_axes)
        self.pos, self.k = ranks.index(mesh.rank), len(ranks)
        self._units: Dict[Tuple, list] = {}
        self._layers = _layer_keys(specs)
        self._top_dims = self._dims_of(
            [s for s, lay in zip(tree_leaves(specs), self._layers)
             if lay is None])

    def _dims_of(self, specs, drop: int = 0) -> list:
        out = []
        for s in specs:
            d = _cut_dim(s, self.gather_axes)
            if d is not None:
                if d < drop:
                    raise ValueError(f"{s} cuts a stack's period axis")
                d -= drop
            out.append(d)
        return out

    def unit_dims(self, path: Tuple) -> list:
        """Per leaf of the layer at ``path`` (tree order), the dim its
        pieces are cut along (a stack's period axis dropped)."""
        if path not in self._units:
            sub = self.specs
            for key in path:
                sub = sub[key]
            self._units[path] = self._dims_of(
                tree_leaves(sub), drop=0 if path[0] == "prefix" else 1)
        return self._units[path]

    # -- the two collectives of a unit ------------------------------------

    def gather(self, dims, pieces) -> list:
        return cns.gather_pieces(pieces, dims, self.gather_group)

    def reduce(self, dims, grads) -> list:
        return cns.reduce_to_pieces(grads, dims, self.batch_group, self.pos,
                                    self.k)

    # -- the provider ------------------------------------------------------

    def top(self, params: Any) -> Any:
        """``params`` with every leaf outside the layer stacks whole."""
        leaves, treedef = tree_flatten(params)
        if len(self._layers) != len(leaves):
            raise ValueError(f"a tree of {len(leaves)} leaves against "
                             f"{len(self._layers)} leaf specs")
        idx = [i for i, lay in enumerate(self._layers) if lay is None]
        whole = _Top.apply(self, self._top_dims, *(leaves[i] for i in idx))
        for i, w in zip(idx, whole):
            leaves[i] = w
        return tree_unflatten(treedef, leaves)

    def run(self, path: Tuple, layer: Any, fn, *inputs):
        """``fn(layer_whole, *inputs) -> (x, aux)`` on the layer at
        ``path``, gathered for its forward and again for its backward."""
        pieces, treedef = tree_flatten(layer)
        return _Layer.apply(self, self.unit_dims(path), treedef, fn,
                            len(inputs), *inputs, *pieces)


class _Top(torch.autograd.Function):
    """The top-level leaves: forward, their whole leaves; backward, the
    gradients summed over every use, reduced to the pieces."""

    @staticmethod
    def forward(ctx, shards: ClientShards, dims, *pieces):
        ctx.shards, ctx.dims = shards, dims
        return tuple(shards.gather(dims, pieces))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ctx.shards.reduce(ctx.dims, list(grads)))


class _Layer(torch.autograd.Function):
    """One layer: gathered, run and freed in the forward; gathered again,
    recomputed and differentiated in the backward, its gradients reduced
    to the pieces."""

    @staticmethod
    def forward(ctx, shards: ClientShards, dims, treedef, fn, n_in: int,
                *args):
        ins, pieces = args[:n_in], args[n_in:]
        whole = shards.gather(dims, pieces)
        out, aux = fn(tree_unflatten(treedef, whole), *ins)
        del whole
        ctx.shards, ctx.dims, ctx.treedef, ctx.fn = shards, dims, treedef, fn
        ctx.n_in = n_in
        ctx.save_for_backward(*ins, *pieces)
        if not isinstance(aux, torch.Tensor):
            aux = torch.zeros((), dtype=torch.float32, device=out.device)
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        saved = ctx.saved_tensors
        n_in = ctx.n_in
        ins, pieces = saved[:n_in], saved[n_in:]
        whole = ctx.shards.gather(ctx.dims, pieces)
        need = ctx.needs_input_grad[5:5 + n_in]
        with torch.enable_grad():
            xs = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(ins, need)]
            ws = [w.detach().requires_grad_(True) for w in whole]
            del whole
            out, aux = ctx.fn(tree_unflatten(ctx.treedef, ws), *xs)
        outs, gs = [out], [g_out]
        if isinstance(aux, torch.Tensor) and aux.requires_grad:
            outs.append(aux)
            gs.append(g_aux)
        wanted = [x for x in xs if x is not None and x.requires_grad]
        got = torch.autograd.grad(outs, wanted + ws, gs, allow_unused=True)
        del outs, out, aux
        g_in = iter(got[:len(wanted)])
        in_grads = [next(g_in) if x is not None and x.requires_grad
                    else None for x in xs]
        g_ws = [torch.zeros_like(w) if g is None else g
                for g, w in zip(got[len(wanted):], ws)]
        del ws, got
        return (None,) * 5 + tuple(in_grads) + tuple(
            ctx.shards.reduce(ctx.dims, g_ws))
