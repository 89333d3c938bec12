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
``consensus.ShardMapBackend``, bare or inside a ``CompressedBackend``): one
process a server, and the step runs rank-locally.  Its grid is ``(rows this
rank holds, N)``; ``init_dfl_state`` builds only those rows; the step takes
the pipeline's full ``(T_C, M, N, ...)`` draw and the full schedule and
reads its rows of them; the consensus period crosses the group.  The
metrics that reduce over servers go through ``consensus.all_reduce_``: the
losses (exact: the other ranks add zeros), the grad norm's and the
disagreement's sums (within rounding of the one-process sums), the drift's
max (exact); an ``inlier_shift`` attack's honest envelope (max and min,
exact).  The push-sum weight is replicated on every rank.  A mesh whose
client, replica or model axes exceed 1 (a server row over several ranks)
is refused here: its clients' local period would need FSDP / TP.
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
    materialised copy per client, since the local period updates each)."""
    return tree_map(lambda p: p[None, None].expand((m, n) + tuple(p.shape))
                    .contiguous(), params)


def _client_sum_over(x: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Eq. 4's one operation: the sum over the client axis divided by the
    per-server ``count`` ((M,), on ``x``'s device).  The static and the
    masked mean both go through it, so they round alike."""
    c = count.reshape((-1,) + (1,) * (x.dim() - 2)).to(x.dtype)
    return x.sum(dim=1) / c


def _full_count(x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[0],), x.shape[1], dtype=x.dtype,
                      device=x.device)


def server_mean(client_tree: Any) -> Any:
    """Eq. 4: w^i = (1/N) sum_j w^{ij}  — mean over the client axis."""
    return tree_map(lambda x: _client_sum_over(x, _full_count(x)),
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
    sq = None
    for c, s in zip(tree_leaves(client_tree), tree_leaves(server_tree)):
        dims = tuple(range(2, c.dim()))
        sb = s[:, None]
        term = (_sum_over(torch.square(c), dims)
                - 2.0 * _sum_over(c * sb, dims)
                + _sum_over(torch.square(sb), dims))
        sq = term if sq is None else sq + term
    return torch.sqrt(torch.clamp(torch.max(sq), min=0.0))


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


def mesh_rows(cfg: DFLConfig) -> Optional[Tuple[int, int, Any]]:
    """``(lo, hi, group)`` of the federation rows ``[lo, hi)`` this process
    holds under a mesh-bound injected backend (the multi-process wire),
    else ``None``."""
    backend = cfg.consensus_backend
    if backend is None or not getattr(backend, "mesh_bound", False):
        return None
    inner = getattr(backend, "inner", backend)
    if getattr(inner, "sharded", False):
        raise ValueError(
            "the rank-local epoch step trains whole client rows, one server "
            "a rank: this backend's mesh has client, replica or model axes "
            "above 1, so a server's row spans several ranks, and training "
            "such a client needs the local period sharded (FSDP / TP), which "
            "the port does not have.  Train on a mesh (M, 1, 1, 1) or a "
            "group of M ranks; the sharded row runs the consensus period "
            "alone (ShardMapBackend.mix)")
    lo, hi = inner.rows
    return lo, hi, inner.group


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
    # multi-process wire (the consensus period then crosses the group)
    local = mesh_rows(cfg)
    lo, hi, group = (0, m, None) if local is None else local
    rows = hi - lo
    grid = (rows, n)
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

    def client_grad(p_ij, batch_ij, rng):
        """(loss, grads) of one client at its own params, averaged over
        ``n_micro`` sequential microbatches.  A leaf the loss never reads
        (a mamba block's ``ln2``) gets a zero gradient, as ``jax.grad``
        gives it."""
        leaves, treedef = tree_flatten(p_ij)
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        params = tree_unflatten(treedef, live)
        if n_micro == 1:
            loss, _aux = loss_fn(params, batch_ij, rng)
            grads = torch.autograd.grad(loss, live, materialize_grads=True)
            return loss.detach(), tree_unflatten(treedef, list(grads))

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
        return torch.stack(losses).mean(), tree_unflatten(treedef, acc)

    def local_period(state: DFLState, batches: Any):
        """T_C SGD steps of every client, in place; the losses and the last
        step's grad norm stay on the device."""
        params, opt_state = state.client_params, state.opt_state
        t_c = tree_leaves(batches)[0].shape[0]
        device = tree_leaves(params)[0].device
        # kept on the device: no host sync inside the client loop
        losses = torch.zeros((t_c, rows, n), dtype=torch.float32,
                             device=device)
        gnorm = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(t_c):
            batch_t = tree_map(lambda x: x[t], batches)
            sq = None
            new_shared = opt_state
            for i in range(rows):
                for j in range(n):
                    p_ij = _client_slice(params, i, j, grid)
                    loss, grads = client_grad(
                        p_ij, tree_map(lambda x: x[i, j], batch_t), state.rng)
                    with torch.no_grad():
                        new_p, new_s = optimizer.update(
                            grads, _client_slice(opt_state, i, j, grid), p_ij)
                        _client_write(params, new_p, i, j, grid)
                        new_shared = _client_write(opt_state, new_s, i, j,
                                                   grid)
                        losses[t, i, j] = loss.float()
                        if full:
                            g_sq = sum(torch.sum(torch.square(g),
                                                 dtype=torch.float32)
                                       for g in tree_leaves(grads))
                            sq = g_sq if sq is None else sq + g_sq
                    del grads
            # every client advanced the shared leaves (the step count) from
            # the same value, so the last client's are everyone's
            opt_state = new_shared
            if full:
                if group is not None:
                    sq = cns.all_reduce_(sq.reshape(1).clone(), group,
                                         site="metrics")[0]
                gnorm = torch.sqrt(sq / (m * n))
        if group is not None:
            # the federation's (T_C, M, N) losses: every other rank adds
            # zeros to this rank's rows, so each loss arrives exactly
            every = torch.zeros((t_c, m, n), dtype=torch.float32,
                                device=device)
            every[:, lo:hi] = losses
            losses = cns.all_reduce_(every, group, site="metrics")
        return params, opt_state, losses, gnorm

    def run_epoch(state: DFLState, batches: Any, mask=None, a_p=None,
                  lam2=None, byz=None) -> Tuple[DFLState, DFLMetrics]:
        """One epoch; ``mask`` None is the static step (full participation,
        the static matrix); ``byz`` the epoch's attack codes.  Metrics stay
        on the device."""
        device = tree_leaves(state.client_params)[0].device
        if group is not None:
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
                drift = max_client_drift(params, start_server)
                del start_server
                if group is not None:
                    drift = cns.all_reduce_(drift.reshape(1).clone(), group,
                                            "max", site="metrics")[0]
            else:
                drift = torch.zeros((), dtype=torch.float32, device=device)

            # ---- 2. aggregation at each server (Eq. 4) ----
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
                disagreement = cns.disagreement_over(server, group, m)
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
            or mesh_rows(cfg) is not None:
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
    per-server weight.  Under the multi-process wire (``mesh_rows``) the
    client grid, the optimizer state and the residual hold this rank's rows
    only; the push-sum weight stays the federation's ``(M,)``."""
    topo = cfg.topology
    local = mesh_rows(cfg)
    rows = topo.num_servers if local is None else local[1] - local[0]
    client_params = replicate_to_clients(params, rows,
                                         topo.clients_per_server)
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
