"""The DFL algorithm (Algorithm 1) as a PyTorch epoch step: port of
``repro.core.dfl``.

One epoch step is the paper's full cycle:

    1. local period     — T_C SGD steps of every client of the (M, N) grid
                          (Eq. 3)
    2. aggregation      — mean over the client axis       (Eq. 4)
    3. consensus period — T_S rounds W <- A W             (Eq. 5/7)
    4. broadcast        — server model back to its N clients

State layout as in the reference: every parameter leaf carries leading axes
``(M, N, *w)``; optimizer state follows it.  Two differences of form, none
of arithmetic:

* The reference vmaps ``value_and_grad`` over the client grid; here the
  local step loops over the M*N clients in Python and updates each one as
  soon as its gradient is ready.  Clients are independent during the local
  period, so the numbers are the same, and one client's gradients and
  activations are live at a time.
* The step consumes its input state like a donated jit argument: the client
  parameter (and optimizer-state, and error-feedback residual) buffers are
  updated in place, so a full copy of the (M, N) model is never held twice.

Compressed consensus (``DFLConfig.compression``) runs the simulated wire
(quantize once a period; the default) or the physical wire (codes every
round), both ``consensus.CompressedBackend``.  Its stochastic rounding is
keyed by the reference's rng stream: ``DFLState.wire_key`` holds threefry key data
(``comm.prng``) that the epoch splits as the reference splits its ``rng`` —
once per local step, then once for the consensus key (``dfl.py:637`` of the
reference) — so the port's codes are the reference's on either wire.

Directed federation (``DFLConfig(mixing="push_sum")``): each consensus
period is a fresh ratio consensus (``consensus.init_push_sum``: the
numerator is the epoch's server aggregates, the weight 1) over the
column-stochastic ``P = A'`` of the topology's row-stochastic A; the
servers take the ratio, and the period's terminal weight rides along in
``DFLState.psum_weight`` as a diagnostic.

Dynamic federation (``DFLConfig.dynamic=True``): the epoch step takes a
third operand, a ``schedule.EpochSchedule`` of tensors on the state's
device — the ``(M, N)`` participation mask, the epoch's ``(M, M)`` mixing
matrix ``A_p`` and, for Chebyshev, its ``lam2``.  Every client trains its
local period, as in the reference; non-participants then get their
start-of-epoch model and optimizer state back (``carry_forward``'s select,
done in place from copies of their slices taken before the local period,
for which the step reads the mask to the host once an epoch), Eq. 4
becomes the masked mean (``masked_server_mean``), and the consensus period
runs on ``A_p``.  The static and the masked mean share one operation (a
sum over the participating clients divided by their count), so an
all-ones mask on the static graph is bitwise the static step.  Server
drop and rejoin change M and live in ``engine.DynamicFederationEngine``.

Byzantine servers (``DFLConfig.byzantine``, dynamic only): after the
masked mean, the rows marked by ``EpochSchedule.byz`` replace their
aggregate with an attack (``apply_byzantine``) before the consensus
period, keyed by a split of the same key stream (the injection's key is
split off before the consensus key, as the reference splits its rng).  A
robust backend (trimmed mean, median, clipped) with ``metrics="full"``
reports its per-source screen activity in ``DFLMetrics.screen_rejected``.

The multi-process wire (``DFLConfig.consensus_backend`` a mesh-bound
``consensus.ShardMapBackend``, bare or inside a ``CompressedBackend``): the
step runs rank-locally, in this process's ``RankRole`` (``rank_role``).
One process a server (a bare group, or a mesh (M, 1, 1, 1)): its grid is
``(rows this rank holds, N)``; ``init_dfl_state`` builds only those rows;
the step takes the pipeline's full ``(T_C, M, N, ...)`` draw and the full
schedule and reads its rows of them; the consensus period crosses the
group.  The metrics that reduce over servers go through
``consensus.all_reduce_``: the losses (exact: the other ranks add zeros),
the grad norm's and the disagreement's sums (within rounding of the
one-process sums), the drift's max (exact); an ``inlier_shift`` attack's
honest envelope (max and min, exact).  The push-sum weight is replicated
on every rank.

A server row sharded over ranks (a ``launch.mesh.RankMesh`` whose client,
replica or model axis exceeds 1, ``tp_axis=None``) computes the same
function as the one-process step, as GSPMD does the reference's: a rank
holds its clients ``[c_lo, c_hi)`` of its server (the "client" axis), its
pieces of each leaf (FSDP over "replica", ``launch.sharding.local_shard``)
and trains them on its share of each client's batch
(``launch.sharding.fl_batch_spec``: over "replica", and over "model" under
``batch_over_model``).  With cut leaves the loss takes them through
``launch.fsdp.ClientShards`` (``ApplyOptions.provider``, bound through the
loss's ``with_provider``): a layer gathered for its forward and again for
its backward, its gradients averaged over the batch's ranks and cut to the
rank's pieces; with whole leaves and a split batch the gradients are
averaged after the backward.  Eq. 4 sums the rank's clients, then over
the client group, then divides by N.  The losses
are the mean of a client's shares, the grad norm and the drift count a
replicated leaf once (its first copy), the disagreement is the backend's
over the mesh.  Refused there, each by name: tensor parallelism over
"model" (``tp_axis="model"``), and a dynamic, push-sum or robust config.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import prng
from repro_torch.comm.compressors import make_compressor
from repro_torch.core import consensus as cns
from repro_torch.core.topology import FLTopology
from repro_torch.kernels.ref import fma
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

LossFn = Callable[[Any, Any, Any], Tuple[torch.Tensor, Any]]
# (params, batch, rng) -> (scalar loss, aux)


class DFLState(NamedTuple):
    """Carried across epochs. ``client_params`` leaves: (M, N, *w).
    ``rng`` is the ``torch.Generator`` handed to the loss (which may ignore
    it, as the LM and regression losses do).  ``ef_residual`` is the
    per-server compression residual (leaves (M, *w)) under compressed
    consensus with error feedback, else ``None``.  ``wire_key`` is the
    threefry key data (``comm.prng``) the wire's dither is keyed from,
    split as the reference splits its rng; ``None`` when nothing uses it.
    ``psum_weight`` is the last push-sum period's terminal ``(M,)`` weight
    under ``mixing='push_sum'`` (ones before the first), else ``None``; it
    never seeds the next period."""

    client_params: Any
    opt_state: Any
    epoch: int
    rng: Optional[torch.Generator] = None
    ef_residual: Optional[Any] = None
    wire_key: Optional[np.ndarray] = None
    psum_weight: Optional[torch.Tensor] = None


class DFLMetrics(NamedTuple):
    """Per-epoch diagnostics.  The static step returns them on the host;
    the dynamic step leaves them on the state's device for the engine's one
    read-back a dispatch."""

    loss: torch.Tensor                 # (T_C, M, N) per local step per client
    server_disagreement: torch.Tensor  # ||W - 1 wbar'||_F after consensus (Lemma 1 LHS)
    client_drift: torch.Tensor         # max_ij ||w^{ij} - w^i_p|| before aggregation (Lemma 3 LHS)
    grad_norm: torch.Tensor            # mean per-client grad norm of last local step
    # (M,) per-SOURCE robust-screen activity: how many of server j's values
    # the receivers' trimmed_mean/median/clipped screens discarded in this
    # epoch's consensus period.  Set only under a robust backend with
    # metrics="full" (a fact of the config); None everywhere else.
    screen_rejected: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class DFLConfig:
    topology: FLTopology
    consensus_mode: str = "gossip"   # gossip | gossip_blocked | collapsed | chebyshev | exact_mean | none
    # "symmetric": A doubly stochastic (Eq. 6), the paper.
    # "row_stochastic": naive directed gossip with the same W <- A W update
    # (converges to the Perron-weighted average).
    # "push_sum": ratio consensus with P = A' (unbiased on a directed graph;
    # the terminal weights in DFLState.psum_weight).
    mixing: str = "symmetric"
    # Chebyshev products a period (default ceil(sqrt(T_S)))
    chebyshev_rounds: Optional[int] = None
    # "full": compute the Lemma-1/Lemma-3 diagnostics every epoch; "light":
    # skip them (zeros).
    metrics: str = "full"
    # each local iteration's per-client batch in this many sequential
    # microbatches, the mean gradient applied once (identical math to Eq. 3)
    grad_microbatches: int = 1
    # lossy inter-server compression: "none" | "int8[:chunk]" |
    # "int4[:chunk]" | "top_k:ratio" | "random_k:ratio"
    # (comm.compressors.make_compressor); anything but "none" wraps the
    # backend in consensus.CompressedBackend
    compression: str = "none"
    # carry each server's compression residual in DFLState.ef_residual and
    # fold it into the next period's message (comm.error_feedback)
    error_feedback: bool = False
    # "simulated": compress once per period and mix the decoded messages;
    # "physical": the codes are the wire, every round.  Ignored without
    # compression.
    wire: str = "simulated"
    # bounded staleness: gossip round t mixes the neighbours' messages of
    # round t - staleness (gossip_scan_stale; on the physical wire the
    # pipelined rounds, kernel 8)
    staleness: int = 0
    # dynamic federation: the epoch step takes a schedule.EpochSchedule
    # operand (participation mask, per-epoch A_p, optional lam2)
    dynamic: bool = False
    # adversarial servers (schedule.ByzantineSchedule): marked servers
    # replace their aggregate before gossip (apply_byzantine); needs
    # dynamic=True, whose EpochSchedule.byz carries the per-row codes
    byzantine: Optional[Any] = None
    # an explicit consensus backend (consensus.ConsensusBackend), used in
    # place of one built from consensus_mode / compression / wire: the
    # launcher injects the multi-process wire's this way
    # (launch.sharding.fl_consensus_backend)
    consensus_backend: Optional[Any] = None


# ---------------------------------------------------------------------------
# helpers on the (M, N, ...) layout
# ---------------------------------------------------------------------------


def replicate_to_clients(params: Any, m: int, n: int) -> Any:
    """Initial broadcast: shared w_0 across all servers and clients (a
    materialised copy per client, since the local period updates each in
    place).  Always a copy: at one client a contiguous leaf would
    otherwise be returned as it is, so the local period would write into
    the caller's params, and a rank's piece cut along a leaf's first dim
    would keep the whole leaf's storage alive."""
    return tree_map(lambda p: p[None, None].expand((m, n) + tuple(p.shape))
                    .clone(memory_format=torch.contiguous_format), params)


def _client_sum_over(x: torch.Tensor, count: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Eq. 4's one operation: the sum over the client axis divided by the
    per-server ``count`` ((M,), on ``x``'s device).  The static and the
    masked mean both go through it, so they round alike.  With ``group``
    the server's clients sit on several ranks: this rank's sum is summed
    over them (site ``client_mean``) before the division."""
    c = count.reshape((-1,) + (1,) * (x.dim() - 2)).to(x.dtype)
    s = x.sum(dim=1)
    if group is not None:
        cns.all_reduce_(s, group, site="client_mean")
    return s / c


def _full_count(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    return torch.full((x.shape[0],), x.shape[1] if n is None else n,
                      dtype=x.dtype, device=x.device)


def server_mean(client_tree: Any, group=None,
                n: Optional[int] = None) -> Any:
    """Eq. 4: w^i = (1/N) sum_j w^{ij}  — mean over the client axis; with
    ``group`` the tree holds this rank's clients of the server's ``n``,
    the others on the group's ranks."""
    return tree_map(lambda x: _client_sum_over(x, _full_count(x, n), group),
                    client_tree)


def masked_server_mean(client_tree: Any, mask: torch.Tensor) -> Any:
    """Eq. 4 under partial participation: server i's mean over its
    participating set ``{j : mask[i, j] = 1}``.  Non-participants carry
    their broadcast model (``carry_forward``), so a fully idle server's
    plain mean over its N copies is its previous model.  An all-ones mask
    is ``server_mean`` bitwise (``x * 1`` is ``x``, and both divide the same
    sum by the same count)."""
    cnt = mask.sum(dim=1)                                     # (M,)
    safe = torch.clamp(cnt, min=1.0)

    def leaf(x):
        mk = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2)).to(
            x.dtype)
        s = _client_sum_over(x * mk, safe)
        sel = (cnt > 0).reshape((-1,) + (1,) * (s.dim() - 1))
        return torch.where(sel, s, _client_sum_over(x, _full_count(x)))

    return tree_map(leaf, client_tree)


def carry_forward(mask: torch.Tensor, new_tree: Any, old_tree: Any) -> Any:
    """Per-client participation select: leaves with a leading ``(M, N)``
    client grid take ``new`` where ``mask`` is set and ``old`` where it is
    not; shared leaves (e.g. the step count) always advance.  (The epoch
    step restores its non-participants in place instead: its local period
    overwrites the old buffers.)"""
    grid = tuple(mask.shape)

    def leaf(nl, ol):
        if _on_grid(nl, grid):
            mk = mask.reshape(grid + (1,) * (nl.dim() - 2))
            return torch.where(mk > 0, nl, ol)
        return nl

    return tree_map(leaf, new_tree, old_tree)


def apply_byzantine(server_tree: Any, codes: Any, key: Optional[np.ndarray],
                    attacks: Tuple[Any, ...], row0: int = 0,
                    group=None) -> Any:
    """Inject the scheduled attacks into the pre-gossip server tree.

    ``codes`` is the (M,) per-row attack marking of
    ``schedule.ByzantineSchedule.codes`` (0 = honest, k+1 = attacks[k]), a
    tensor or an array (read to the host: the rows to rewrite are chosen
    there); ``attacks`` the tuple of ``schedule.ByzantineAttack``; ``key``
    the threefry key data of the injection (``comm.prng``; only
    ``scaled_noise`` reads it).  Honest rows pass through bitwise untouched
    (a leaf with no attacked row is returned as it is, the others are
    copied and their attacked rows rewritten).

    ``sign_flip`` sends ``-scale * w``; ``scaled_noise`` sends ``w + scale *
    N(0, I)`` with the reference's draw: leaf ``l`` takes key
    ``split(key, n_leaves)[l]``, attack ``k`` folds ``k`` into it, and row
    ``r`` is that normal array's row ``r`` (``prng.normal``, within 4 ulps
    of ``jax.random.normal``); ``inlier_shift`` sends the honest
    coordinatewise envelope's ``scale`` quantile, ``h_min + scale * (h_max -
    h_min)`` over the ``codes == 0`` rows (an attacker keeps its own value
    when no honest row exists).  On float32 leaves ``scale * x + y`` is one
    fused multiply-add, as XLA compiles it inside the reference's jitted
    epoch step (its eager ops round twice).  ``row0`` is the federation
    row of the tree's first row.  Under the multi-process wire the tree
    holds a rank's own rows and ``group`` is the group of every server's
    rank: ``codes`` are then the federation's (M,) codes (on every rank, so
    who attacks is a host fact), and ``inlier_shift`` reduces the honest
    rows' envelope over the group (``consensus.all_reduce_`` with "max" of
    the masked rows and of their negation, site ``"inlier_shift"``: exact,
    so the attacked rows are the one-process step's bit for bit)."""
    fed = np.asarray(codes.detach().cpu() if isinstance(codes, torch.Tensor)
                     else codes, dtype=np.int64).reshape(-1)
    leaves, treedef = tree_flatten(server_tree)
    if not attacks or not fed.any():
        return server_tree
    codes = (fed if group is None
             else fed[row0:row0 + leaves[0].shape[0]])
    honest = np.nonzero(fed == 0)[0]
    needs_key = any(a.kind == "scaled_noise" and (codes == i + 1).any()
                    for i, a in enumerate(attacks))
    if needs_key and key is None:
        raise ValueError("a scaled_noise attack draws its noise from a key: "
                         "pass the injection's threefry key data")
    leaf_keys = (prng.split(key, len(leaves)) if key is not None
                 else [None] * len(leaves))
    out_leaves = []
    for leaf, leaf_key in zip(leaves, leaf_keys):
        out = leaf
        for idx, atk in enumerate(attacks):
            rows = np.nonzero(codes == idx + 1)[0].tolist()
            if group is not None and atk.kind == "inlier_shift":
                # every rank enters the reductions, attacker or not
                if not (fed == idx + 1).any() or not honest.size:
                    continue
                target = _honest_envelope(leaf, codes == 0, atk.scale,
                                          group)
                if rows and out is leaf:
                    out = leaf.clone()
                for r in rows:
                    out[r] = target
                continue
            if not rows:
                continue
            if out is leaf:
                out = leaf.clone()
            if atk.kind == "sign_flip":
                neg = _scalar(-atk.scale, leaf)
                for r in rows:
                    out[r] = neg * leaf[r]
            elif atk.kind == "scaled_noise":
                k = prng.fold_in(leaf_key, idx)
                per_row = leaf[0].numel()
                for r in rows:
                    noise = prng.normal(k, tuple(leaf.shape[1:]),
                                        dtype=leaf.dtype, device=leaf.device,
                                        start=(row0 + r) * per_row)
                    out[r] = _scale_add(atk.scale, noise, leaf[r])
            elif honest.size:                           # inlier_shift
                idx_t = torch.as_tensor(honest, device=leaf.device)
                h = leaf.index_select(0, idx_t)
                hmin, hmax = h.amin(dim=0), h.amax(dim=0)
                target = _scale_add(atk.scale, hmax - hmin, hmin)
                for r in rows:
                    out[r] = target
        out_leaves.append(out)
    return tree_unflatten(treedef, out_leaves)


def _honest_envelope(leaf: torch.Tensor, honest_here: np.ndarray,
                     scale: float, group) -> torch.Tensor:
    """``h_min + scale * (h_max - h_min)`` over the honest rows of the whole
    federation, from this rank's rows (``honest_here`` marks its honest
    ones): the coordinatewise max of the masked rows and of their negation
    reduced with "max" over ``group``.  A bf16 / f16 leaf reduces in f32
    (exact both ways)."""
    mask = torch.as_tensor(honest_here, device=leaf.device).reshape(
        (-1,) + (1,) * (leaf.dim() - 1))
    work = (leaf.float() if leaf.dtype in (torch.bfloat16, torch.float16)
            else leaf)
    ninf = torch.full((), float("-inf"), dtype=work.dtype,
                      device=leaf.device)
    hmax = torch.where(mask, work, ninf).amax(dim=0).contiguous()
    nmin = torch.where(mask, -work, ninf).amax(dim=0).contiguous()
    cns.all_reduce_(hmax, group, "max", site="inlier_shift")
    cns.all_reduce_(nmin, group, "max", site="inlier_shift")
    hmax, hmin = hmax.to(leaf.dtype), (-nmin).to(leaf.dtype)
    return _scale_add(scale, hmax - hmin, hmin)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scale as a 0-d tensor in the leaf's dtype: JAX rounds a
    weakly typed scalar to the array's dtype (bf16 too) before the product,
    where torch would keep it in float32."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _scale_add(scale: float, x: torch.Tensor, y: torch.Tensor,
               step: int = 1 << 24) -> torch.Tensor:
    """``scale * x + y``: one rounding on float32 (``kernels.ref.fma``, over
    runs of ``step`` elements to bound its float64 transients), two in the
    leaf dtype otherwise."""
    if x.dtype != torch.float32:
        return y + _scalar(scale, x) * x
    out = torch.empty_like(y)
    xf, yf, of = x.reshape(-1), y.reshape(-1), out.view(-1)
    s = torch.full((1,), scale, dtype=torch.float32, device=x.device)
    for lo in range(0, xf.numel(), step):
        of[lo:lo + step] = fma(s, xf[lo:lo + step], yf[lo:lo + step])
    return out


def broadcast_to_clients(server_tree: Any, n: int) -> Any:
    """End-of-epoch broadcast: every client restarts from its server model."""
    return tree_map(lambda s: s[:, None].expand(
        (s.shape[0], n) + tuple(s.shape[1:])).contiguous(), server_tree)


def _broadcast_into(client_tree: Any, server_tree: Any) -> None:
    """``broadcast_to_clients`` written into the existing client buffers."""
    for c, s in zip(tree_leaves(client_tree), tree_leaves(server_tree)):
        c.copy_(s[:, None].expand_as(c))


def disagreement_norm(server_tree: Any) -> torch.Tensor:
    """||W - 1 wbar'||_F over the stacked server models (Lemma 1 LHS), as
    ``sum_i ||w_i||^2 - M ||wbar||^2`` per leaf with f32 accumulation (the
    reference's formula; it rounds like the reference where the
    disagreement is far below the model's norm)."""
    total = None
    for leaf in tree_leaves(server_tree):
        m = leaf.shape[0]
        s_sq = torch.sum(torch.square(leaf), dtype=torch.float32)
        mean = leaf.mean(dim=0, dtype=torch.float32)
        term = s_sq - m * torch.sum(torch.square(mean))
        total = term if total is None else total + term
    return torch.sqrt(torch.clamp(total, min=0.0))


def max_client_drift(client_tree: Any, server_tree: Any) -> torch.Tensor:
    """max_{ij} ||w^{ij} - w^i|| (Lemma 3 LHS), as
    ``sum c^2 - 2 sum c*s + sum s^2`` per (i, j) with f32 accumulation."""
    return torch.sqrt(torch.clamp(torch.max(
        _drift_sq(client_tree, server_tree)), min=0.0))


def _drift_sq(client_tree: Any, server_tree: Any,
              counted: Optional[list] = None) -> torch.Tensor:
    """Per (i, j), ``max_client_drift``'s squared distance summed over the
    leaves (those ``counted`` marks: a rank's first copies)."""
    sq = None
    for k, (c, s) in enumerate(zip(tree_leaves(client_tree),
                                   tree_leaves(server_tree))):
        if counted is not None and not counted[k]:
            continue
        dims = tuple(range(2, c.dim()))
        sb = s[:, None]
        term = (_sum_over(torch.square(c), dims)
                - 2.0 * _sum_over(c * sb, dims)
                + _sum_over(torch.square(sb), dims))
        sq = term if sq is None else sq + term
    if sq is None:
        c = tree_leaves(client_tree)[0]
        sq = torch.zeros(c.shape[:2], dtype=torch.float32, device=c.device)
    return sq


def _sum_over(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    if not dims:
        return x.float()
    return torch.sum(x, dim=dims, dtype=torch.float32)


def resolve_backend(cfg: DFLConfig):
    """The ``consensus.ConsensusBackend`` this config's consensus period runs
    through: the injected ``cfg.consensus_backend`` if any, else one built
    from ``consensus_mode`` (``None`` for consensus_mode='none')."""
    if cfg.consensus_backend is not None:
        return cfg.consensus_backend
    topo = cfg.topology
    m = topo.num_servers
    a_np = topo.mixing_matrix() if m > 1 else np.ones((1, 1))
    return cns.make_backend(cfg.consensus_mode, a_np, topo.t_server,
                            chebyshev_rounds=cfg.chebyshev_rounds,
                            compression=cfg.compression,
                            error_feedback=cfg.error_feedback,
                            wire=cfg.wire, staleness=cfg.staleness)


def active_compressor(cfg: DFLConfig):
    """The compressor this config's consensus period runs through, or
    ``None`` when the wire is exact (an injected backend first)."""
    backend = cfg.consensus_backend
    if backend is not None:
        return backend.compressor if getattr(backend, "compressed",
                                             False) else None
    if cfg.compression != "none" and cfg.consensus_mode != "none":
        return make_compressor(cfg.compression)
    return None


def wants_error_feedback(cfg: DFLConfig) -> bool:
    """Whether this config carries an EF residual in ``DFLState`` (an
    injected backend first)."""
    backend = cfg.consensus_backend
    if backend is not None:
        return bool(getattr(backend, "compressed", False)
                    and backend.error_feedback)
    return (cfg.compression != "none" and cfg.error_feedback
            and cfg.consensus_mode != "none")


def active_wire(cfg: DFLConfig) -> Tuple[str, int]:
    """``(wire mode, wire block)`` of the compression layer: the block is
    the byte layout's partitioning the ledger counts."""
    backend = cfg.consensus_backend
    if backend is not None and getattr(backend, "compressed", False):
        return backend.wire, backend.wire_block
    return cfg.wire, cns.DEFAULT_GOSSIP_BLOCK


class RankRole(NamedTuple):
    """Where this process sits in a federation on the multi-process wire
    (``rank_role``).  It holds the server rows ``[lo, hi)`` and, of each,
    the clients ``[c_lo, c_hi)``; the consensus period crosses ``group``,
    the metrics reduce over ``world``.  The rest is set only on a
    ``sharded`` row (a mesh whose client, replica or model axis exceeds
    1): the ``mesh``; ``client_group``, the ranks of one server's clients
    (Eq. 4); ``shard_group``, the ranks that hold pieces or copies of one
    client (replica x model); ``batch_group``, the ranks its batch splits
    over, under ``batch_spec`` of the draw; ``gather_group`` over
    ``gather_axes``, the ranks of one cut leaf's pieces; ``specs``, each
    client leaf's spec over its own dims (tree order); ``counted``, per
    leaf, whether this rank's piece is its first copy (a sum over ranks
    counts a replicated leaf once); ``first``, whether this rank is its
    client's first (replica 0, model 0); ``tp``, under tensor parallelism
    (leaves cut over "model"), the ``launch.tp.ModelParallel`` of its model
    axis, else ``None``."""

    lo: int
    hi: int
    c_lo: int
    c_hi: int
    group: Any
    world: Any
    mesh: Any = None
    client_group: Any = None
    shard_group: Any = None
    batch_group: Any = None
    batch_spec: Any = None
    gather_group: Any = None
    gather_axes: Tuple[str, ...] = ()
    specs: Optional[list] = None
    counted: Optional[list] = None
    first: bool = True
    tp: Any = None

    @property
    def sharded(self) -> bool:
        return self.mesh is not None


def rank_role(cfg: DFLConfig) -> Optional[RankRole]:
    """This process's ``RankRole`` under a mesh-bound injected backend (the
    multi-process wire), else ``None``.  On a sharded row it makes the
    row's groups, in one order on every rank.  A client cut over "model"
    (``tp_axis="model"``) runs tensor parallel (``launch.tp``) when it is a
    dense decoder (qwen3, gemma2, command_r), the encoder-decoder
    (Seamless-M4T: its encoder and the decoder's cross-attention over a
    rank's heads), the vision frontend (InternVL2), of the MoE and MLA
    families (Mixtral, DeepSeek-V2: the experts cut by expert or by d_ff,
    MLA's latent projections) or Mamba-2 (Mamba2-780M, and Jamba's mamba,
    attention and MoE layers: a rank's heads); its replicated leaves (the
    norms, the router, ``w_dkv``, ``a_log``, ``dt_bias``, ``d_skip``) are
    counted once a TP group in the metrics (``counted``).  Refused there,
    each by name: a leaf the step multiplies as a piece that the axis
    leaves whole (``launch.sharding.tp_refusal``), a Mamba head count the
    axis does not divide (the loss's ``with_tp``), a batch split over
    "model" as well, and a dynamic, push-sum or robust config."""
    backend = cfg.consensus_backend
    if backend is None or not getattr(backend, "mesh_bound", False):
        return None
    inner = getattr(backend, "inner", backend)
    lo, hi = inner.rows
    n = cfg.topology.clients_per_server
    if not getattr(inner, "sharded", False):
        return RankRole(lo, hi, 0, n, inner.group, inner.view.world)
    from repro_torch.launch import sharding as shd
    mesh = inner.mesh
    specs = [shd.layer_spec(x, 1) for x in tree_leaves(inner.leaf_specs)]
    tp_cut = any(shd.model_dim(x) is not None for x in specs)
    why = shd.tp_refusal(inner.leaf_specs)
    if why is not None:
        raise ValueError(
            f"{why}: this backend's leaf specs cut a client's weights over "
            f"the 'model' axis (tp_axis='model'), which the rank-local step "
            f"runs for the dense decoders (qwen3, gemma2, command_r), the "
            f"encoder-decoder (seamless), the vision frontend (internvl2), "
            f"the MoE and MLA families (mixtral, deepseek_v2) and Mamba-2 "
            f"(mamba2, jamba) on heads, d_ff and vocab the axis divides.  "
            f"Build the backend with tp_axis=None (and batch_over_model="
            f"True, as the plans of smollm_360m and internvl2_1b), or on a "
            f"model axis that divides them")
    if tp_cut and "model" in inner.batch_spec.axes(3):
        raise ValueError("a client's leaves cut over 'model' and its batch "
                         "split over 'model' too: tensor parallelism runs "
                         "the same tokens on every model rank (build the "
                         "backend with batch_over_model=False)")
    if cfg.dynamic or cfg.mixing == "push_sum" or cfg.byzantine is not None \
            or getattr(backend, "robust", False):
        raise ValueError(
            "a server row sharded over ranks runs the static step: a "
            "dynamic, push-sum or robust config (a per-epoch mask or A_p, "
            "the ratio weight, an attack and its screen) on a sharded row "
            "is not ported; run it on a mesh (M, 1, 1, 1) or a group of M "
            "ranks")
    per, c = n // mesh.shape["client"], mesh.coords()["client"]
    if per * mesh.shape["client"] != n:
        raise ValueError(f"N={n} clients do not split over the mesh's "
                         f"{mesh.shape['client']} client ranks")
    # the axes a layer's pieces are gathered over (FSDP); a piece over
    # "model" is the rank's own under TP
    gather_axes = tuple(a for a in mesh.axis_names if a != "model"
                        and any(a in x.used_axes() for x in specs))
    batch_axes = inner.batch_spec.axes(3)
    # the groups, in one order on every rank (gloo needs it)
    client_group = mesh.group_over(("client",))
    shard_group = mesh.group_over(("replica", "model"))
    batch_group = mesh.group_over(batch_axes)
    gather_group = mesh.group_over(gather_axes)
    tp = None
    if tp_cut:
        from repro_torch.launch.tp import ModelParallel
        tp = ModelParallel.of(mesh)
    coords = mesh.coords()
    return RankRole(
        lo, hi, c * per, (c + 1) * per, inner.group, inner.view.world,
        mesh=mesh, client_group=client_group, shard_group=shard_group,
        batch_group=batch_group, batch_spec=inner.batch_spec,
        gather_group=gather_group, gather_axes=gather_axes, specs=specs,
        counted=[shd.first_copy(shd.PartitionSpec(
            "server", "client", *x.dims), mesh) for x in specs],
        first=coords["replica"] == 0 and coords["model"] == 0, tp=tp)


def _cut(params: Any, role: RankRole) -> Any:
    """This rank's pieces of the whole leaves ``params`` (views)."""
    if not role.sharded:
        return params
    from repro_torch.launch import sharding as shd
    leaves, treedef = tree_flatten(params)
    if len(leaves) != len(role.specs):
        raise ValueError(f"{len(leaves)} parameter leaves against the "
                         f"backend's {len(role.specs)} leaf specs")
    return tree_unflatten(treedef, [shd.local_shard(x, sp, role.mesh)
                                    for x, sp in zip(leaves, role.specs)])


def _compresses(cfg: DFLConfig) -> bool:
    topo = cfg.topology
    return (active_compressor(cfg) is not None and topo.num_servers > 1
            and topo.t_server > 0)


# ---------------------------------------------------------------------------
# per-client slicing of the (M, N, ...) layout
# ---------------------------------------------------------------------------


def _client_slice(tree: Any, i: int, j: int, grid: Tuple[int, int]) -> Any:
    """Client (i, j)'s view of every leaf with a leading (M, N) grid; shared
    leaves (e.g. the optimizer's step count) pass through."""
    return tree_map(lambda x: x[i, j] if _on_grid(x, grid) else x, tree)


def _client_write(tree: Any, new: Any, i: int, j: int,
                  grid: Tuple[int, int]) -> Any:
    """Write client (i, j)'s ``new`` leaves into ``tree``'s grid leaves in
    place; shared leaves take ``new``'s value."""
    def leaf(x, nx):
        if _on_grid(x, grid):
            x[i, j].copy_(nx)
            return x
        return nx
    return tree_map(leaf, tree, new)


def _on_grid(x: Any, grid: Tuple[int, int]) -> bool:
    return (isinstance(x, torch.Tensor) and x.dim() >= 2
            and tuple(x.shape[:2]) == grid)


# ---------------------------------------------------------------------------
# the epoch step builder
# ---------------------------------------------------------------------------


def build_dfl_epoch_step(
    cfg: DFLConfig,
    loss_fn: LossFn,
    optimizer: Optimizer,
) -> Callable[..., Tuple[DFLState, DFLMetrics]]:
    """Return ``epoch_step(state, batches) -> (state, metrics)``, or under
    ``cfg.dynamic`` ``epoch_step(state, batches, sched)`` with ``sched`` a
    ``schedule.EpochSchedule`` of tensors on the state's device.

    ``batches`` leaves are ``(T_C, M, N, *per_client_batch)`` — one
    microbatch per client per local iteration.  The step updates
    ``state``'s buffers in place (see the module docstring)."""
    topo = cfg.topology
    m, n = topo.num_servers, topo.clients_per_server
    # the rows this process holds: all M, or a rank's own under the
    # multi-process wire (the consensus period then crosses the group), and
    # of each its clients: all N, or on a sharded row a rank's own pieces
    # of its clients on its share of their batches
    role = rank_role(cfg)
    lo, hi, group = ((0, m, None) if role is None
                     else (role.lo, role.hi, role.group))
    c_lo, c_hi = (0, n) if role is None else (role.c_lo, role.c_hi)
    rows = hi - lo
    grid = (rows, c_hi - c_lo)
    world = None if role is None else role.world
    sharded = role is not None and role.sharded
    counted = None if not sharded else role.counted
    if sharded and (role.gather_axes or role.tp is not None) \
            and not hasattr(loss_fn, "with_provider"):
        raise ValueError(
            "this rank holds pieces of its client's leaves (cut over "
            f"{role.gather_axes or ('model',)}): the loss must take its "
            "leaves through ApplyOptions.provider (and .tp) — make it with "
            "models.transformer.make_loss_fn, whose with_provider and "
            "with_tp the step binds to the client's pieces")
    # under tensor parallelism the loss runs the rank's TP pieces (bound
    # here: it refuses the families whose TP is not ported)
    tp_loss = (loss_fn.with_tp(role.tp) if sharded and role.tp is not None
               else loss_fn)
    if cfg.mixing not in ("symmetric", "row_stochastic", "push_sum"):
        raise ValueError(f"unknown mixing interpretation {cfg.mixing!r}")
    if cfg.mixing == "symmetric" and topo.mixing == "out_degree" and m > 1:
        raise ValueError(
            "topology.mixing='out_degree' emits a row-stochastic (generally "
            "not doubly stochastic) A: running it through the symmetric "
            "gossip path would silently converge to the biased "
            "Perron-weighted average — choose DFLConfig(mixing='push_sum') "
            "(unbiased) or mixing='row_stochastic' (the explicit biased "
            "baseline)")
    if cfg.metrics not in ("full", "light"):
        raise ValueError(f"unknown metrics level {cfg.metrics!r}")
    if cfg.staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {cfg.staleness}")
    if cfg.staleness and cfg.mixing == "push_sum":
        raise ValueError(
            "bounded staleness is undefined under mixing='push_sum': the "
            "exact (M,) weight recursion has no delayed twin, so a stale "
            "numerator over a fresh weight breaks mass conservation — use "
            "staleness=0 or a symmetric/row_stochastic mixing")
    if cfg.staleness and cfg.consensus_mode == "none":
        raise ValueError("staleness > 0 with consensus_mode='none' is "
                         "meaningless: there are no gossip rounds to delay")
    backend = resolve_backend(cfg)
    # compression wire state is a static fact of the config: without it the
    # step never touches the wire key or the residual
    compressed = (backend is not None
                  and getattr(backend, "compressed", False)
                  and m > 1 and topo.t_server > 0)
    if backend is not None and cfg.mixing != "symmetric" \
            and not backend.supports_directed:
        raise ValueError(
            f"consensus backend {backend.name!r} is undefined for "
            f"mixing={cfg.mixing!r}: the directed paths need the literal "
            f"W <- A W / ratio-consensus update — use one of ('gossip', "
            f"'gossip_blocked', 'collapsed', 'none')")
    full = cfg.metrics == "full"
    # the attack kinds and scales are facts of the step; WHO attacks is the
    # per-epoch EpochSchedule.byz operand
    byz_attacks = (tuple(cfg.byzantine.attacks)
                   if cfg.byzantine is not None else ())
    if byz_attacks and not cfg.dynamic:
        raise ValueError(
            "DFLConfig.byzantine needs dynamic=True: the per-epoch attacker "
            "codes ride the EpochSchedule operand (use engine.make_engine, "
            "which sets it)")
    # the robust screen's readout is a fact of the config (a robust backend
    # and full metrics)
    screen_stats = (backend is not None and backend.robust and full)
    n_micro = max(cfg.grad_microbatches, 1)
    push_sum = cfg.mixing == "push_sum"
    # a batch split with every leaf whole on the rank: the whole-leaf
    # gradients averaged over the batch's ranks after the backward; with
    # cut leaves the provider reduces each unit's inside it
    batch_mean = sharded and role.batch_group is not None \
        and not role.gather_axes
    bound = {}

    def loss_for(client_params):
        """The loss this rank runs: ``loss_fn`` (under TP its ``with_tp``),
        or on a rank holding leaves cut over "replica" the same loss with
        its leaves through the client's
        ``launch.fsdp.ClientShards`` (made at the first epoch, when the
        tree's layout is known; its groups are the role's)."""
        if not (sharded and role.gather_axes):
            return tp_loss
        if "loss" not in bound:
            from repro_torch.launch.fsdp import ClientShards
            specs = tree_unflatten(tree_flatten(client_params)[1],
                                   role.specs)
            bound["loss"] = tp_loss.with_provider(ClientShards(
                role.mesh, specs, role.gather_group, role.batch_group,
                role.gather_axes))
        return bound["loss"]

    def reduced(grads: list) -> list:
        if not batch_mean:
            return grads
        return [cns.reduce_to_pieces([g], [None], role.batch_group, 0, 1)[0]
                for g in grads]

    def client_grad(loss_fn, p_ij, batch_ij, rng):
        """(loss, grads) of one client at its own params, averaged over
        ``n_micro`` sequential microbatches.  A leaf the loss never reads
        (a mamba block's ``ln2``) gets a zero gradient, as ``jax.grad``
        gives it.  On a sharded row: this rank's pieces and batch share,
        the gradients the client's (averaged over the batch's ranks), the
        loss this share's."""
        leaves, treedef = tree_flatten(p_ij)
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        params = tree_unflatten(treedef, live)
        if n_micro == 1:
            loss, _aux = loss_fn(params, batch_ij, rng)
            grads = torch.autograd.grad(loss, live, materialize_grads=True)
            return loss.detach(), tree_unflatten(treedef,
                                                 reduced(list(grads)))

        def split(leaf):
            b = leaf.shape[0]
            if b % n_micro:
                raise ValueError(f"per-client batch {b} does not split into "
                                 f"{n_micro} microbatches")
            return leaf.reshape((n_micro, b // n_micro) + tuple(leaf.shape[1:]))

        micro = tree_map(split, batch_ij)
        acc = [torch.zeros_like(leaf) for leaf in leaves]
        losses = []
        for k in range(n_micro):
            mloss, _aux = loss_fn(params, tree_map(lambda x: x[k], micro),
                                  rng)
            g = torch.autograd.grad(mloss, live, materialize_grads=True)
            # accumulate in the PARAM dtype, each microgradient scaled by
            # 1/n first, as the reference does
            acc = [a + (x / n_micro).to(a.dtype) for a, x in zip(acc, g)]
            losses.append(mloss.detach())
        return torch.stack(losses).mean(), tree_unflatten(treedef,
                                                          reduced(acc))

    def local_period(state: DFLState, batches: Any):
        """T_C SGD steps of every client, in place; the losses and the last
        step's grad norm stay on the device."""
        params, opt_state = state.client_params, state.opt_state
        t_c = tree_leaves(batches)[0].shape[0]
        device = tree_leaves(params)[0].device
        run_loss = loss_for(params)
        # kept on the device: no host sync inside the client loop
        losses = torch.zeros((t_c,) + grid, dtype=torch.float32,
                             device=device)
        gnorm = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(t_c):
            batch_t = tree_map(lambda x: x[t], batches)
            sq = None
            new_shared = opt_state
            for i in range(rows):
                for j in range(grid[1]):
                    p_ij = _client_slice(params, i, j, grid)
                    loss, grads = client_grad(
                        run_loss, p_ij,
                        tree_map(lambda x: x[i, j], batch_t), state.rng)
                    with torch.no_grad():
                        new_p, new_s = optimizer.update(
                            grads, _client_slice(opt_state, i, j, grid), p_ij)
                        _client_write(params, new_p, i, j, grid)
                        new_shared = _client_write(opt_state, new_s, i, j,
                                                   grid)
                        losses[t, i, j] = loss.float()
                        if full:
                            g_sq = sum(
                                (torch.sum(torch.square(g),
                                           dtype=torch.float32)
                                 for k, g in enumerate(tree_leaves(grads))
                                 if counted is None or counted[k]),
                                torch.zeros((), dtype=torch.float32,
                                            device=device))
                            sq = g_sq if sq is None else sq + g_sq
                    del grads
            # every client advanced the shared leaves (the step count) from
            # the same value, so the last client's are everyone's
            opt_state = new_shared
            if full:
                if world is not None:
                    sq = cns.all_reduce_(sq.reshape(1).clone(), world,
                                         site="metrics")[0]
                gnorm = torch.sqrt(sq / (m * n))
        if world is not None:
            if sharded and role.batch_group is not None:
                # a client's loss: the mean of its batch shares' losses
                cns.all_reduce_(losses, role.batch_group, site="metrics")
                losses /= cns.group_size_rank(role.batch_group)[0]
            # the federation's (T_C, M, N) losses: every other rank adds
            # zeros to this rank's clients (a client's first rank only),
            # so each loss arrives exactly
            every = torch.zeros((t_c, m, n), dtype=torch.float32,
                                device=device)
            if role.first:
                every[:, lo:hi, c_lo:c_hi] = losses
            losses = cns.all_reduce_(every, world, site="metrics")
        return params, opt_state, losses, gnorm

    def run_epoch(state: DFLState, batches: Any, mask=None, a_p=None,
                  lam2=None, byz=None) -> Tuple[DFLState, DFLMetrics]:
        """One epoch; ``mask`` None is the static step (full participation,
        the static matrix); ``byz`` the epoch's attack codes.  Metrics stay
        on the device."""
        device = tree_leaves(state.client_params)[0].device
        if sharded:
            # this rank's clients' share of the federation's draw
            from repro_torch.launch.sharding import batch_piece
            batches = batch_piece(batches, role.batch_spec, role.mesh)
        elif group is not None:
            # this rank's rows of the federation's draw and schedule (the
            # attack codes stay whole: apply_byzantine reads them all)
            batches = tree_map(lambda x: x[:, lo:hi], batches)
            if mask is not None:
                mask = mask[lo:hi]
        # Lemma 3 LHS needs each client's start-of-epoch server model w^i_p
        # (== the broadcast client params at entry), which the in-place
        # local period overwrites: keep a copy
        start_server = (tree_map(lambda x: x[:, 0].clone(),
                                 state.client_params) if full else None)
        # the non-participants' start-of-epoch model and optimizer state:
        # their local period runs (as the reference's does) and is undone
        idle = ([] if mask is None else
                [tuple(ij) for ij in (mask.detach().cpu() == 0).nonzero()
                 .tolist()])
        saved = [(ij, tree_map(torch.clone, _client_slice(
                      state.client_params, *ij, grid)),
                  tree_map(torch.clone, _client_slice(
                      state.opt_state, *ij, grid))) for ij in idle]

        # ---- 1. local period: T_C client SGD iterations (Eq. 3) ----
        params, opt_state, losses, gnorm = local_period(state, batches)

        with torch.no_grad():
            # non-participants carry their start-of-epoch model and
            # optimizer state through the epoch; shared leaves (the step
            # count) keep advancing, so the tree _client_write returns for
            # them is dropped
            for (i, j), p_old, o_old in saved:
                _client_write(params, p_old, i, j, grid)
                _client_write(opt_state, o_old, i, j, grid)
            del saved
            if full:
                # per client, the squared distance over this rank's first
                # copies, summed over the client's ranks
                dsq = _drift_sq(params, start_server, counted)
                del start_server
                if sharded and role.shard_group is not None:
                    cns.all_reduce_(dsq, role.shard_group, site="metrics")
                drift = torch.sqrt(torch.clamp(torch.max(dsq), min=0.0))
                if world is not None:
                    drift = cns.all_reduce_(drift.reshape(1).clone(), world,
                                            "max", site="metrics")[0]
            else:
                drift = torch.zeros((), dtype=torch.float32, device=device)

            # ---- 2. aggregation at each server (Eq. 4) ----
            if sharded:
                server = server_mean(params, role.client_group, n)
            else:
                server = (server_mean(params) if mask is None
                          else masked_server_mean(params, mask))

            # the key follows the reference's rng: one split per local step,
            # then the injection's key and the consensus key split off
            key, ef_res = state.wire_key, state.ef_residual
            psw = state.psum_weight
            if key is not None:
                for _ in range(tree_leaves(batches)[0].shape[0]):
                    key = prng.split(key)[0]

            # ---- 2b. adversarial injection: marked servers replace their
            # aggregate before gossip (the message the federation receives,
            # and what a robust backend must screen) ----
            if byz_attacks:
                bkey = None
                if key is not None:
                    key, bkey = prng.split(key)
                server = apply_byzantine(server, byz, bkey, byz_attacks,
                                         row0=lo, group=group)

            # ---- 3. consensus period: T_S gossip rounds (Eq. 5/7) ----
            screen = (torch.zeros((m,), dtype=torch.float32, device=device)
                      if screen_stats else None)
            ckey = None
            if compressed:
                if key is None:
                    raise ValueError("compressed consensus needs "
                                     "DFLState.wire_key (init_dfl_state's "
                                     "wire_key=prng.key(seed))")
                key, ckey = prng.split(key)
            if push_sum and m > 1 and topo.t_server > 0 \
                    and backend is not None:
                # a fresh ratio consensus each period: numerator = this
                # epoch's aggregates, weight 1 (the carried weight is a
                # diagnostic, never a seed)
                # (the weight is the federation's (M,), on every rank)
                ps = cns.PushSumState(server, torch.ones(
                    (m,), dtype=torch.float32, device=device))
                if compressed:
                    ps, ef_res = backend.mix_push_sum_compressed(
                        ps, a_p, residual=ef_res, key=ckey)
                else:
                    ps = backend.mix_push_sum(ps, a_p)
                server = cns.PushSumState(ps.values,
                                          ps.weight[lo:hi]).ratio()
                psw = ps.weight
                del ps
            elif compressed:
                server, ef_res = backend.mix_compressed(
                    server, a_p, residual=ef_res, key=ckey, lam2=lam2)
            elif m > 1 and topo.t_server > 0 and backend is not None:
                if screen_stats:
                    server, screen = backend.mix_stats(server, a_p,
                                                       lam2=lam2)
                else:
                    server = backend.mix(server, a_p, lam2=lam2)
            if not full:
                disagreement = torch.zeros((), dtype=torch.float32,
                                           device=device)
            elif group is not None:
                # over the server group, or a sharded row's pieces over
                # the mesh (each piece's first copy counted once)
                disagreement = getattr(backend, "inner",
                                       backend).disagreement(server)
            else:
                disagreement = disagreement_norm(server)

            # ---- 4. broadcast w^i_p back to C_i (every client) ----
            _broadcast_into(params, server)
            del server

        new_state = DFLState(params, opt_state, state.epoch + 1, state.rng,
                             ef_res, key, psw)
        return new_state, DFLMetrics(loss=losses,
                                     server_disagreement=disagreement,
                                     client_drift=drift, grad_norm=gnorm,
                                     screen_rejected=screen)

    def epoch_step(state: DFLState, batches: Any
                   ) -> Tuple[DFLState, DFLMetrics]:
        state, mt = run_epoch(state, batches)
        # the static step's metrics are host tensors: reading them waits
        # for the device
        return state, DFLMetrics(*(None if x is None else x.float().cpu()
                                   for x in mt))

    def epoch_step_dynamic(state: DFLState, batches: Any, sched: Any
                           ) -> Tuple[DFLState, DFLMetrics]:
        """Dynamic variant: ``sched`` is an ``EpochSchedule(mask, mixing[,
        lam2, byz])`` of tensors on the state's device."""
        if byz_attacks and sched.byz is None:
            raise ValueError("DFLConfig.byzantine needs the epoch's attack "
                             "codes in EpochSchedule.byz")
        if tuple(sched.mask.shape) != (m, n):
            raise ValueError(f"participation mask of shape "
                             f"{tuple(sched.mask.shape)} for an {(m, n)} "
                             f"grid")
        return run_epoch(state, batches, sched.mask, sched.mixing,
                         sched.lam2, sched.byz if byz_attacks else None)

    return epoch_step_dynamic if cfg.dynamic else epoch_step


def build_consensus_replay(cfg: DFLConfig) -> Optional[Callable]:
    """The consensus period alone, for wall-clock attribution.

    ``replay(server_tree, a_p, lam2) -> mixed_tree`` runs the T_S-round
    consensus period of the epoch step — the same backend
    (``resolve_backend``) and the same branches: push-sum (plain or
    compressed), ``mix_compressed`` on either wire, ``mix`` — on a server
    tree.  The engine's span tracer times it (the result is dropped) to
    split one epoch step's wall time into local-period and gossip-period
    estimates; spans carry ``method="consensus-replay"`` to say that they
    are an estimate.  Under compression the replay uses the fixed key
    ``prng.key(0)`` and a zero error-feedback residual of its own, so it
    never reads or writes the state's ``wire_key`` or ``ef_residual``.  The
    backends update their own period buffers in place, so the caller hands
    the replay a server tree it may consume (the engine passes a copy).
    Returns ``None`` when there is no consensus period to time (M == 1,
    T_S == 0, or consensus_mode='none'), and under the multi-process wire,
    whose period is a collective that every rank would have to enter."""
    topo = cfg.topology
    if topo.num_servers == 1 or topo.t_server == 0 \
            or rank_role(cfg) is not None:
        return None
    backend = resolve_backend(cfg)
    if backend is None:
        return None
    compressed = getattr(backend, "compressed", False)
    ef = wants_error_feedback(cfg)

    def replay(server_tree: Any, a_p: torch.Tensor,
               lam2: Optional[torch.Tensor] = None) -> Any:
        key = prng.key(0) if compressed else None
        residual = (tree_map(torch.zeros_like, server_tree)
                    if compressed and ef else None)
        if cfg.mixing == "push_sum":
            ps0 = cns.init_push_sum(server_tree)
            if compressed:
                ps, _ = backend.mix_push_sum_compressed(
                    ps0, a_p, residual=residual, key=key)
            else:
                ps = backend.mix_push_sum(ps0, a_p)
            return ps.ratio()
        if compressed:
            mixed, _ = backend.mix_compressed(
                server_tree, a_p, residual=residual, key=key, lam2=lam2)
            return mixed
        return backend.mix(server_tree, a_p, lam2=lam2)

    return replay


def init_dfl_state(cfg: DFLConfig, params: Any, optimizer: Optimizer,
                   rng: Optional[torch.Generator] = None,
                   wire_key: Optional[np.ndarray] = None) -> DFLState:
    """Replicate shared w_0 (Alg. 1 'Initialize') and build optimizer state.
    Under compressed consensus ``wire_key`` (threefry key data, e.g.
    ``prng.key(seed)`` where the reference passes ``jax.random.key(seed)``)
    is required, and error feedback adds a zero residual (leaves
    ``(M, *w)``).  Under ``mixing='push_sum'`` the state carries a unit
    per-server weight.  Under the multi-process wire (``rank_role``) the
    client grid, the optimizer state and the residual hold this rank's rows
    only, and on a sharded row its clients of each and its pieces of each
    leaf (cut from the whole ``params``: ``launch.sharding.local_shard``);
    the push-sum weight stays the federation's ``(M,)``."""
    topo = cfg.topology
    role = rank_role(cfg)
    rows, clients = topo.num_servers, topo.clients_per_server
    if role is not None:
        rows, clients = role.hi - role.lo, role.c_hi - role.c_lo
        params = _cut(params, role)
    client_params = replicate_to_clients(params, rows, clients)
    ef = None
    if _compresses(cfg):
        if wire_key is None:
            raise ValueError("compressed consensus keys its dither from "
                             "wire_key: pass wire_key=prng.key(seed)")
        if wants_error_feedback(cfg):
            ef = tree_map(lambda p: torch.zeros(
                (rows,) + tuple(p.shape), dtype=p.dtype,
                device=p.device), params)
    psw = (torch.ones((topo.num_servers,), dtype=torch.float32,
                      device=tree_leaves(client_params)[0].device)
           if cfg.mixing == "push_sum" else None)
    return DFLState(client_params, optimizer.init(client_params), 0, rng,
                    ef, None if wire_key is None else np.asarray(
                        wire_key, dtype=np.uint32), psw)


# ---------------------------------------------------------------------------
# baselines the paper compares against (conceptually)
# ---------------------------------------------------------------------------


def build_fedavg_epoch_step(topology: FLTopology, loss_fn: LossFn,
                            optimizer: Optimizer) -> Callable:
    """Classic single-server FedAvg: DFL with consensus_mode='exact_mean'."""
    cfg = DFLConfig(topology=topology, consensus_mode="exact_mean")
    return build_dfl_epoch_step(cfg, loss_fn, optimizer)


def build_local_only_epoch_step(topology: FLTopology, loss_fn: LossFn,
                                optimizer: Optimizer) -> Callable:
    """No-communication ablation (lower bound on agreement)."""
    cfg = DFLConfig(topology=topology, consensus_mode="none")
    return build_dfl_epoch_step(cfg, loss_fn, optimizer)
