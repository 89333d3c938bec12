"""Server-side consensus updates (Eq. 5/7): port of ``repro.core.consensus``.

A consensus round is ``W <- A W`` over the leading server axis of every
leaf.  The plain functions (``mix_pytree``, ``gossip_scan``,
``gossip_collapsed``) mirror the reference leaf by leaf and serve as the
port's own reference.  The backends — what the epoch step runs — flatten
the server tree ONCE per period to an ``(M, D)`` matrix and run each round
through ``repro_torch.kernels.ops.consensus_mix``: the CUDA kernel on the
card, its plain version on the CPU.  Leaves gossip independently
(``gossip_scan`` in the reference), so mixing the concatenation is the same
operator.

**Simulated wire** (``CompressedBackend(wire="simulated")``, the default):
each server's message is compressed ONCE per period and the period mixes
the decoded messages, ``inner.mix(D(C(W)))``, as the reference's
``CompressedBackend._wire`` does.  Routes:

* a quantizer without error feedback: the round trip and the period's
  first operator run as one pass of kernel 4 per leaf
  (``StochasticQuantizer.mix`` → ``ops.quantized_consensus_mix``), then
  the rest of the period on kernel 1.  The first operator is ``A`` for
  gossip and gossip_blocked (then T_S - 1 rounds), ``A^{T_S}`` for
  collapsed and ``J/M`` for exact_mean (nothing after);
* a quantizer with error feedback: the residual needs the decoded message
  itself, so the message is kernel 4 with ``A = I`` (exact: products by 1
  and 0, sums with 0), ``comm.error_feedback.ef_roundtrip``, and then the
  inner backend's whole period;
* top-k, random-k and identity: their round trips in plain PyTorch ops
  (no TPU kernel computes them), then the inner backend's period.

The dither is ``jax.random.uniform`` of the reference's per-leaf key
(``comm.prng.uniform``), bitwise, so the codes are the reference's.

**Physical wire.**  ``CompressedBackend(wire="physical")`` makes int8/int4
codes what every gossip round ships: each round encodes each server's DELTA
against the receivers' shared decoded reference (``gossip_scan_wire`` per
leaf, ``gossip_scan_wire_bucketed`` with the whole tree as one padded
bucket), and dequantizes and mixes after.  Every step runs on the wire
kernels through ``repro_torch.kernels.ops``: the encode of round 0
(kernel 6), then per round the bucketed round (kernel 7), its
bounded-staleness form (kernel 8, ``staleness >= 1``) or the per-leaf
round (kernel 5).  The dither is the reference's keyed hash
(``comm.compressors.wire_dither``), so the codes are the reference's.
Error feedback tracks round 0's transmission.  The state buffers of a
period are updated in place by the kernels; a period allocates its
(M, D_pad) buffers once.

Leaf dtypes: a tree of one dtype (f32 or bf16) mixes as one slab of that
dtype through kernel 1, whose rounds sum in f32 and round once to the
leaves' dtype (the Pallas ``_mix_kernel``'s rule); a tree of mixed dtypes
mixes leaf by leaf.  The reference's core contracts with ``tensordot`` in
the leaf dtype, A cast down to it, and never calls its kernel: in bf16 the
two differ by about one bf16 step a round.  The wires keep their kernels
f32 and carry a bf16 bucket cast up (exact), rounding to bf16 where the
reference stores the bucket's dtype: each round's iterate and output, the
error-feedback correction and residual.

**Dynamic federation.**  Every backend takes a per-epoch ``A_p`` (a tensor
on the tree's device) in place of its static matrix.  ``gossip_scan_tv``
runs a per-round stack of matrices, ``gossip_scan_stale`` the
bounded-staleness rounds (round t mixes the iterate of round t - s), and
``gossip_chebyshev`` the Chebyshev semi-iteration, whose products A·w are
one kernel-1 launch each; its affine step stays plain tensor code.

**Push-sum** (directed federation, ratio consensus): a numerator tree and
an ``(M,)`` weight, both mixed with the column-stochastic ``P = A'`` of a
row-stochastic ``A`` (``PushSumState``, ``init_push_sum``,
``gossip_push_sum``, ``_blocked``, ``_tv`` and every backend's
``mix_push_sum``); the read-out ``ratio()`` divides the numerator by the
weight.  The numerator runs through the same execution strategies as
``mix`` — each round one launch of kernel 1 with ``P`` on the card, which
takes any (M, M) matrix — and the weight is a plain f32 matvec on the
tree's device, as in the reference.  On the simulated wire kernel 4 fuses
the round trip with the first operator ``P``; on the physical wire the
numerator's codes ride kernels 6 and 7 under ``P`` and the weight stays
exact.  Staleness has no push-sum form and is refused.

**Robust screens** (Byzantine-screening gossip): ``trimmed_mean[:f]`` and
``median`` rank each coordinate's supported values per receiver and
average the kept ones (``_rank_keep_block``: plain tensor ops over column
blocks of ``RANK_SCREEN_BLOCK``, no TPU kernel computes them); ``clipped``
builds a state-dependent effective matrix ``C`` from tree-wide Gram
distances every round and runs ``W <- C W`` through kernel 1.  Each has
``mix_stats``, the per-source screen-activity counts.  They refuse
push-sum (``supports_directed = False``) and the physical wire; on the
simulated wire their first operator is the identity (kernel 4 decodes on
``A = I``) and the screen runs the whole period.

**The multi-process wire** (the reference's shard_map programs): one
process a server over a ``torch.distributed`` group, each rank holding its
own rows.  Every collective goes through ``all_gather_rows``,
``ring_exchange`` or ``all_reduce_``, which count calls and bytes per dtype
(``collective_counts``) and, on gloo, move a CUDA tensor through a pinned
host buffer per collective site (gloo aborts on a device pointer).
``make_gossip_shard_map`` is the plain program (kernel 1's row form a
block and round) or the bucketed wire (one int8 and one f32 gather a
round; kernel 6, then the row forms of kernels 7 or 8), row r bitwise row
r of ``gossip_scan_wire_bucketed``; ``make_ring_gossip`` exchanges with the
two ring neighbours; ``ShardMapBackend`` is the backend, also inside
``CompressedBackend``.

Modes: ``gossip``, ``gossip_blocked``, ``collapsed``, ``chebyshev``,
``exact_mean``, ``trimmed_mean[:f]``, ``median``, ``clipped[:mult]`` and
``none``; both wires around them (the physical wire around the first two),
bounded staleness on and off the wire, and push-sum over the first three.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import compressors as _compressors
from repro_torch.comm import prng
from repro_torch.comm.error_feedback import ef_roundtrip
from repro_torch.core.topology import lambda_2 as tp_lambda_2
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import fma
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

DEFAULT_GOSSIP_BLOCK = 4_194_304


def _mix_leaf(a: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """new[i] = sum_j a[i, j] * leaf[j, ...], contracted in the leaf dtype."""
    return torch.tensordot(a.to(device=leaf.device, dtype=leaf.dtype), leaf,
                           dims=([1], [0]))


def mix_pytree(a: torch.Tensor, tree: Any) -> Any:
    """One consensus round ``W <- A W`` applied to every leaf."""
    return tree_map(lambda leaf: _mix_leaf(a, leaf), tree)


def gossip_scan(a: torch.Tensor, tree: Any, t_server: int) -> Any:
    """Faithful T_S-round consensus, leaf by leaf (the plain reference)."""
    def leaf_loop(leaf):
        for _ in range(t_server):
            leaf = _mix_leaf(a, leaf)
        return leaf
    return tree_map(leaf_loop, tree)


def _flatten(tree: Any):
    """The server tree as ONE (M, D) matrix in its leaves' one dtype (a new
    buffer, leaves concatenated row-wise in leaf order) and the function
    that splits an (M, D) matrix back into views in the tree's shapes."""
    leaves, treedef = tree_flatten(tree)
    m = leaves[0].shape[0]
    flat = torch.cat([leaf.reshape(m, -1) for leaf in leaves], dim=1)

    def split(mat: torch.Tensor) -> Any:
        out, off = [], 0
        for leaf in leaves:
            size = leaf[0].numel()
            out.append(mat[:, off:off + size].reshape(leaf.shape))
            off += size
        return tree_unflatten(treedef, out)

    return flat, split


def _leafwise_if_mixed(fn: Callable[[Any], Any], tree: Any):
    """``fn(tree)`` on a tree of one dtype; a tree of mixed dtypes runs
    ``fn`` leaf by leaf, each leaf in its own dtype (the reference mixes
    every leaf in its dtype).  ``None`` when the tree has one dtype."""
    leaves, treedef = tree_flatten(tree)
    if kops.one_dtype(leaves, "the gossip backends"):
        return None
    return tree_unflatten(treedef, [fn(leaf) for leaf in leaves])


def _f32_on(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return a.to(device=like.device, dtype=torch.float32).contiguous()


def gossip_scan_stale(a: torch.Tensor, tree: Any, t_server: int,
                      staleness: int) -> Any:
    """Bounded-staleness consensus: round ``t`` mixes the ``s``-round-old
    iterate, ``W_(t+1) = A W_(t-s)``, and holds ``W_(t+1) = W_t`` while no
    delayed iterate exists yet (``t < s``).  In exact arithmetic the period
    is ``A^(T_S // (s+1))``, the contraction ``schedule.SigmaTracker``
    budgets for.  ``staleness=0`` IS ``gossip_scan`` (the call branches to
    it, so the degeneration is bitwise).  Otherwise the tree is flattened
    once to (M, D) and every mixing round is one ``ops.consensus_mix`` (one
    kernel-1 launch on the card) into a new buffer; the last s + 1 iterates
    are kept."""
    if staleness <= 0:
        return gossip_scan(a, tree, t_server)
    if t_server == 0:
        return tree
    mixed = _leafwise_if_mixed(
        lambda t: gossip_scan_stale(a, t, t_server, staleness), tree)
    if mixed is not None:
        return mixed
    flat, split = _flatten(tree)
    a32 = _f32_on(a, flat)
    hist = [flat] * (staleness + 1)     # hist[u] = W_(t-s+u), clamped to W_0
    for t in range(t_server):
        new = kops.consensus_mix(a32, hist[0]) if t >= staleness else hist[-1]
        hist = hist[1:] + [new]
    return split(hist[-1])


def gossip_scan_tv(a_rounds: torch.Tensor, tree: Any) -> Any:
    """Time-varying consensus: round t applies ``a_rounds[t]``, a
    ``(T_S, M, M)`` stack with one matrix per ROUND of one period (a stack
    of T_S copies of A is ``gossip_scan(A, tree, T_S)``).  The tree is
    flattened once to (M, D); each round is one ``ops.consensus_mix`` (one
    kernel-1 launch on the card), ping-ponging two buffers."""
    if a_rounds.shape[0] == 0:
        return tree
    mixed = _leafwise_if_mixed(lambda t: gossip_scan_tv(a_rounds, t), tree)
    if mixed is not None:
        return mixed
    flat, split = _flatten(tree)
    stack = _f32_on(a_rounds, flat)
    src, dst = flat, torch.empty_like(flat)
    for t in range(stack.shape[0]):
        kops.consensus_mix(stack[t], src, out=dst)
        src, dst = dst, src
    return split(src)


def gossip_scan_blocked(a: torch.Tensor, tree: Any, t_server: int,
                        block: int = DEFAULT_GOSSIP_BLOCK) -> Any:
    """T_S rounds streamed over fixed-size column blocks of the flattened
    ``(M, D)`` server matrix: block-major, round-minor, which is the same
    operator since blocks mix independently, with a working set of one
    block.  Each round goes through ``ops.consensus_mix``."""
    return kops.consensus_mix_pytree(a, tree, rounds=t_server, block=block)


def collapse_mixing(a: np.ndarray, t_server: int) -> np.ndarray:
    """A_eff = A^{T_S} (host-side, float64). Doubly stochastic by closure."""
    return np.linalg.matrix_power(np.asarray(a, dtype=np.float64), t_server)


def gossip_collapsed(a_eff: torch.Tensor, tree: Any) -> Any:
    """Single-round application of the collapsed operator A^{T_S}."""
    return mix_pytree(a_eff, tree)


# ---------------------------------------------------------------------------
# push-sum (ratio consensus) for directed graphs
# ---------------------------------------------------------------------------


class PushSumState(NamedTuple):
    """Numerator tree (leaves ``(M, *w)``) and per-server weight ``(M,)``
    (float32, positive, summing to M under mixing); ``ratio()`` of a fresh
    state is the values themselves."""

    values: Any
    weight: torch.Tensor

    def ratio(self) -> Any:
        """The read-out z_i = num_i / w_i, the weight cast to each leaf's
        dtype first (as the reference casts it)."""
        return tree_map(
            lambda v: v / self.weight.reshape((-1,) + (1,) * (v.dim() - 1))
            .to(device=v.device, dtype=v.dtype), self.values)


def init_push_sum(tree: Any) -> PushSumState:
    """Start of a consensus period: numerator = the server models, weight =
    1 for every server (reset every period, as the reference does: a
    carried weight would bring the Perron bias back)."""
    leaf = tree_leaves(tree)[0]
    return PushSumState(tree, torch.ones((leaf.shape[0],),
                                         dtype=torch.float32,
                                         device=leaf.device))


def _transpose(a: torch.Tensor) -> torch.Tensor:
    """``P = A'`` as a contiguous matrix (the kernels read A row-major)."""
    return a.transpose(0, 1).contiguous()


def _push_weight(p: torch.Tensor, weight: torch.Tensor,
                 rounds: int) -> torch.Tensor:
    """``rounds`` rounds of the weight recursion ``w <- P w``: an (M,) f32
    matvec on the weight's device."""
    p = p.to(device=weight.device, dtype=torch.float32)
    for _ in range(rounds):
        weight = (p @ weight.to(p.dtype)).to(weight.dtype)
    return weight


def gossip_push_sum(a: torch.Tensor, state: PushSumState,
                    t_server: int) -> PushSumState:
    """T_S rounds of push-sum over a ROW-stochastic ``a`` (support: a
    directed graph with self-loops, e.g. ``topology.out_degree_weights``):
    numerator and weight both mixed with ``P = a'``.  The numerator runs
    through ``ops.consensus_mix_pytree`` (one kernel-1 launch a round on the
    card); they meet only at ``ratio()``."""
    if t_server == 0:
        return state
    p = _transpose(a)
    return PushSumState(
        kops.consensus_mix_pytree(p, state.values, rounds=t_server),
        _push_weight(p, state.weight, t_server))


def gossip_push_sum_blocked(a: torch.Tensor, state: PushSumState,
                            t_server: int,
                            block: int = DEFAULT_GOSSIP_BLOCK
                            ) -> PushSumState:
    """Blocked push-sum: the numerator streamed over column blocks of
    ``block`` (``BlockedGossipBackend.mix_push_sum``), the weight by the
    matvec."""
    if t_server == 0:
        return state
    return BlockedGossipBackend(None, t_server, block=block).mix_push_sum(
        state, a)


def gossip_push_sum_tv(a_rounds: torch.Tensor,
                       state: PushSumState) -> PushSumState:
    """Time-varying push-sum: round t mixes with ``a_rounds[t]'``, a
    ``(T_S, M, M)`` stack of row-stochastic matrices (``gossip_scan_tv``'s
    layout).  Each transpose is column stochastic, so both sums are kept."""
    if a_rounds.shape[0] == 0:
        return state
    p_rounds = a_rounds.transpose(1, 2).contiguous()
    weight = state.weight
    for t in range(p_rounds.shape[0]):
        weight = _push_weight(p_rounds[t], weight, 1)
    return PushSumState(gossip_scan_tv(p_rounds, state.values), weight)


# ---------------------------------------------------------------------------
# Chebyshev-accelerated gossip (beyond-paper)
# ---------------------------------------------------------------------------


def chebyshev_coefficients(a: np.ndarray, rounds: int) -> float:
    """The contraction sigma of ``rounds`` Chebyshev steps (for reporting),
    from lambda_2 of the symmetric mixing matrix."""
    ev = np.sort(np.abs(np.linalg.eigvalsh(a)))[::-1]
    lam2 = ev[1] if len(ev) > 1 else 0.0
    if lam2 == 0.0:
        return 0.0
    # |T_k(1/lam2)|^{-1} with T_k the Chebyshev polynomial of the first kind
    x = 1.0 / lam2
    return float(1.0 / np.cosh(rounds * np.arccosh(x)))


def gossip_chebyshev(a: torch.Tensor, tree: Any, rounds: int, lam2) -> Any:
    """Chebyshev semi-iterative consensus,
    ``w_k = 2 c_k/(lam2 c_{k+1}) A w_{k-1} - (c_{k-1}/c_{k+1}) w_{k-2}`` with
    ``c_k = cosh(k acosh(1/lam2))``, in the reference's ratio form, which
    never forms c_k (it overflows f32 within a few rounds for a small
    lam2)::

        alpha_k = 2x / (2x - r_k),  beta_k = r_k / (2x - r_k),
        r_{k+1} = 1 / (2x - r_k),   x = 1/lam2,  r_1 = lam2

    ``lam2`` is a host float (the static topology) or a float32 tensor (the
    per-epoch estimate of a dynamic schedule), clamped below at 1e-6 as in
    the reference.  The tree is flattened once to (M, D): each product
    ``A w`` is one ``ops.consensus_mix`` (one kernel-1 launch on the card),
    ``rounds`` in all; the affine step ``alpha * mixed - beta * prev`` is
    plain tensor code, with the coefficients computed in f32 as the
    reference computes them (on bf16 leaves in f32, rounded once to bf16,
    as the reference's ``(alpha * m - beta * p).astype(m.dtype)``).  Three
    (M, D) buffers rotate."""
    if rounds == 0:
        return tree
    if isinstance(lam2, (int, float)) and lam2 <= 0.0:
        return kops.consensus_mix_pytree(a, tree, rounds=1)
    mixed = _leafwise_if_mixed(
        lambda t: gossip_chebyshev(a, t, rounds, lam2), tree)
    if mixed is not None:
        return mixed
    flat, split = _flatten(tree)
    a32 = _f32_on(a, flat)
    x = 1.0 / torch.clamp(torch.as_tensor(lam2, dtype=torch.float32,
                                          device=flat.device), min=1e-6)
    r = 1.0 / x          # r_1 = c_0 / c_1 = lam2
    w_prev = flat
    w_cur = kops.consensus_mix(a32, flat)   # k = 1: the first iterate is A w
    spare = None
    for _ in range(1, rounds):
        denom = 2.0 * x - r
        alpha, beta = 2.0 * x / denom, r / denom
        mixed = kops.consensus_mix(a32, w_cur, out=spare)
        if mixed.dtype == torch.float32:
            mixed.mul_(alpha)
            mixed.sub_(w_prev.mul_(beta))   # w_prev is not read again
        else:
            mixed.copy_(alpha * mixed.float() - beta * w_prev.float())
        w_prev, w_cur, spare = w_cur, mixed, w_prev
        r = 1.0 / denom
    return split(w_cur)


def lambda2_traced(a: torch.Tensor) -> torch.Tensor:
    """|lambda_2| of a symmetric mixing-matrix tensor, as a float32 scalar
    on its device (a tiny (M, M) eigendecomposition): the fallback of a
    spectral backend called with an ``A_p`` but no estimate; the engine
    passes ``topology.lambda_2`` of the host matrix instead."""
    if a.shape[0] < 2:
        return torch.zeros((), dtype=torch.float32, device=a.device)
    ev = torch.sort(torch.abs(torch.linalg.eigvalsh(a.float()))).values
    return ev[-2].float()


# ---------------------------------------------------------------------------
# quantized-wire gossip: the per-round physical wire
# ---------------------------------------------------------------------------

def _wire_leaves(tree: Any):
    """The leaves of a tree the wire takes: float32 or bfloat16 (carried in
    f32, exactly); other dtypes raise."""
    leaves, treedef = tree_flatten(tree)
    kops.one_dtype(leaves, "the wire")
    return leaves, treedef


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (f32) rounded to ``dtype`` and held in f32 again, in place:
    the wire kernels stay f32, and a bf16 value cast up is exact."""
    if dtype != torch.float32:
        x.copy_(x.to(dtype))
    return x


def _wire_dither_rows(key, m: int, nb: int, blk: int, *, leaf: int,
                      rnd: int, blk_pad: Optional[int] = None,
                      device: Any = "cpu") -> torch.Tensor:
    """(m, nb * blk_pad) dither of one round of one leaf of the per-leaf
    wire: cell (leaf, rnd, server, block) over the ``blk`` real elements of
    each block, zero over its pad to ``blk_pad``; 0.5 everywhere without a
    key (the reference's deterministic rounding)."""
    blk_pad = blk if blk_pad is None else blk_pad
    out = torch.zeros((m, nb, blk_pad), dtype=torch.float32, device=device)
    if key is None:
        out[:, :, :blk] = 0.5
    else:
        for s in range(m):
            for b in range(nb):
                _compressors.wire_dither(key, blk, leaf=leaf, rnd=rnd,
                                         server=s, block=b,
                                         out=out[s, b, :blk])
    return out.reshape(m, nb * blk_pad)


def _leaf_blocks(flat: torch.Tensor, block: int, chunk: int):
    """The per-leaf wire layout of one (m, d) leaf: ``nb`` blocks of
    ``blk = min(block, d)`` elements, each zero-padded to ``blk_pad``, a
    chunk multiple (zeros never raise an absmax and code to 0, so the pad
    is bitwise neutral).  Returns ``(rows (m, nb * blk_pad), blk, nb,
    blk_pad)``."""
    m, d = flat.shape
    blk = min(block, d)
    nb = -(-d // blk)
    blk_pad = -(-blk // chunk) * chunk
    rows = torch.zeros((m, nb * blk), dtype=torch.float32,
                       device=flat.device)
    rows[:, :d] = flat                  # a bf16 leaf cast up: exact
    padded = torch.zeros((m, nb, blk_pad), dtype=torch.float32,
                         device=flat.device)
    padded[:, :, :blk] = rows.reshape(m, nb, blk)
    return padded.reshape(m, nb * blk_pad), blk, nb, blk_pad


def _leaf_unblock(rows: torch.Tensor, d: int, blk: int, nb: int,
                  blk_pad: int) -> torch.Tensor:
    m = rows.shape[0]
    return rows.reshape(m, nb, blk_pad)[:, :, :blk].reshape(m, nb * blk)[
        :, :d]


def gossip_scan_wire(a: torch.Tensor, tree: Any, t_server: int, codec,
                     key=None, *, block: int = DEFAULT_GOSSIP_BLOCK) -> Any:
    """Per-round quantized-wire gossip in the per-leaf layout (the
    reference's ``gossip_scan_wire``): every round, every server encodes
    the DELTA between its iterate and the receivers' shared decoded
    reference, every receiver adds the decoded deltas to its reference of
    every sender and mixes the references::

        delta_t = W_t - R_(t-1)          (encoded; crosses the wire)
        R_t     = R_(t-1) + D(C(delta_t))
        W_(t+1) = A R_t                  (R_(-1) = 0)

    Each leaf is cut into blocks of ``min(block, d)`` elements with its own
    dither cell (leaf, round, server, block).  Per leaf: one encode
    (kernel 6), then T_S per-leaf rounds (kernel 5), each of which also
    re-encodes the next round's deltas (the last re-encode is never
    consumed and reuses its round's dither).  A leaf of another dtype than
    f32 rides in f32 (exact), and each round's mixed iterate is rounded to
    the leaf's dtype, as the reference stores it; the next round's deltas
    are then re-encoded from the rounded iterate (kernel 6 again)."""
    if t_server == 0:
        return tree
    leaves, treedef = _wire_leaves(tree)
    m = leaves[0].shape[0]
    a32 = a.to(device=leaves[0].device, dtype=torch.float32)
    out = []
    for li, leaf in enumerate(leaves):
        flat = leaf.reshape(m, -1)
        d = flat.shape[1]
        w, blk, nb, blk_pad = _leaf_blocks(flat, block, codec.chunk)

        def dither(rnd, li=li, blk=blk, nb=nb, blk_pad=blk_pad):
            return _wire_dither_rows(key, m, nb, blk, leaf=li,
                                     rnd=rnd, blk_pad=blk_pad,
                                     device=w.device)

        ref = torch.zeros_like(w)
        u = dither(0)
        codes, scales = kops.quantized_gossip_encode(
            w, ref, u, *_code_buffers(w, codec.chunk), bits=codec.bits,
            chunk=codec.chunk)
        mixed = w
        for t in range(t_server):
            if t + 1 < t_server:
                u = dither(t + 1)
            kops.quantized_gossip_round(a32, codes, scales, ref, mixed, u,
                                        bits=codec.bits, chunk=codec.chunk)
            if leaf.dtype != torch.float32:
                _round_to(mixed, leaf.dtype)
                if t + 1 < t_server:
                    kops.quantized_gossip_encode(
                        mixed, ref, u, codes, scales, bits=codec.bits,
                        chunk=codec.chunk)
        out.append(_leaf_unblock(mixed, d, blk, nb, blk_pad)
                   .reshape(leaf.shape).to(leaf.dtype))
    return tree_unflatten(treedef, out)


def _code_buffers(x: torch.Tensor, chunk: int):
    """Uninitialised ``(codes, scales)`` buffers for the encode of an
    (m, d) f32 operand: (m, d) int8 and (m, d / chunk) f32."""
    m, d = x.shape
    return (torch.empty((m, d), dtype=torch.int8, device=x.device),
            torch.empty((m, d // chunk), dtype=torch.float32,
                        device=x.device))


def _bucket_layout(leaves, block: int, chunk: int):
    """``(d_tot, d_pad)`` of the bucketed layout of a server tree."""
    d_tot = sum(leaf[0].numel() for leaf in leaves)
    blk, nb = _compressors.bucket_block(d_tot, block, chunk)
    return d_tot, blk * nb


def _bucket_flat(leaves, d_pad: int) -> torch.Tensor:
    """(m, d_pad) f32 bucket of a server tree's leaves, flattened row-wise
    in leaf order, zero tail.  Every leaf is first cast to the FIRST leaf's
    dtype, the bucket's one wire dtype (as the reference's
    ``_bucket_flat``); a bf16 value then sits in the f32 bucket exactly."""
    m = leaves[0].shape[0]
    flat = torch.zeros((m, d_pad), dtype=torch.float32,
                       device=leaves[0].device)
    off = 0
    for leaf in leaves:
        size = leaf[0].numel()
        flat[:, off:off + size] = leaf.reshape(m, size).to(leaves[0].dtype)
        off += size
    return flat


def _bucket_split(flat: torch.Tensor, leaves, treedef,
                  via: torch.dtype = torch.float32) -> Any:
    """Invert ``_bucket_flat``: the bucket's leaves in their shapes and
    dtypes (the pad tail is dropped), rounded to ``via`` first where the
    reference stores the bucket in its wire dtype.  An f32 leaf of an f32
    bucket is a view."""
    out, off = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        out.append(flat[:, off:off + size].reshape(leaf.shape).to(via)
                   .to(leaf.dtype))
        off += size
    return tree_unflatten(treedef, out)


def _bucket_dither_rows(key, m: int, d_pad: int, *, rnd: int,
                        out: torch.Tensor) -> torch.Tensor:
    """(m, d_pad) dither of one round of the bucketed wire, into ``out``:
    one cell (leaf 0, rnd, server, block 0) per server over the whole
    bucket, or 0.5 without a key."""
    if key is None:
        return out.fill_(0.5)
    for s in range(m):
        _compressors.wire_dither(key, d_pad, leaf=0, rnd=rnd, server=s,
                                 block=0, out=out[s])
    return out


def _bucketed_period(a: torch.Tensor, flat: torch.Tensor, t_server: int,
                     codec, key, staleness: int,
                     shipped: Optional[Callable] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The bucketed recursion on a (m, d_pad) f32 bucket; returns the
    iterate buffer after ``t_server`` rounds.  ``shipped(codes, scales)``
    is called with round 0's codes and scales while they still exist (the
    error-feedback hook).  ``dtype`` is the bucket's wire dtype: the
    reference carries the iterate in it, so for bf16 each round's iterate
    is rounded to bf16 before the next round encodes it (kernel 7 fuses
    the re-encode of the unrounded one, so kernel 6 encodes again; kernel
    8 encodes first and reads a rounded copy)."""
    m, d_pad = flat.shape
    bits, chunk = codec.bits, codec.chunk
    a32 = a.to(device=flat.device, dtype=torch.float32)
    ref = torch.zeros_like(flat)
    acc = torch.zeros_like(flat)
    u = torch.empty_like(flat)

    def dither(rnd):
        return _bucket_dither_rows(key, m, d_pad, rnd=rnd, out=u)

    if staleness == 0:
        codes, scales = kops.quantized_gossip_encode(
            flat, ref, dither(0), *_code_buffers(flat, chunk), bits=bits,
            chunk=chunk)
        if shipped is not None:
            shipped(codes, scales)
        w = None if dtype == torch.float32 else torch.empty_like(flat)
        for t in range(t_server):
            if t + 1 < t_server:    # the last re-encode is never consumed
                dither(t + 1)
            kops.bucketed_gossip_round(a32, codes, scales, ref, acc, u,
                                       bits=bits, chunk=chunk)
            if w is not None and t + 1 < t_server:
                kops.quantized_gossip_encode(
                    _round_to(w.copy_(acc), dtype), ref, u, codes, scales,
                    bits=bits, chunk=chunk)
        return acc
    # the ring of the last `staleness` in-flight (codes, scales): zero codes
    # and unit scales decode to nothing, so the pre-fill is inert; round t
    # consumes slot t % s (round t - s's payload) and ships into it
    ring_c = torch.zeros((staleness, m, d_pad), dtype=torch.int8,
                         device=flat.device)
    ring_s = torch.ones((staleness, m, d_pad // chunk), dtype=torch.float32,
                        device=flat.device)
    w = flat
    for t in range(t_server):
        slot = t % staleness
        kops.bucketed_gossip_round_pipelined(
            a32, ring_c[slot], ring_s[slot], w, ref, acc, dither(t),
            bits=bits, chunk=chunk)
        if t == 0 and shipped is not None:   # slot 0 holds round 0's
            shipped(ring_c[0], ring_s[0])     # codes until round s
        if t >= staleness:          # a delayed buffer has landed
            if dtype == torch.float32:
                w = acc
            else:
                if w is flat:
                    w = torch.empty_like(flat)
                _round_to(w.copy_(acc), dtype)
    return w


def gossip_scan_wire_bucketed(a: torch.Tensor, tree: Any, t_server: int,
                              codec, key=None, *,
                              block: int = DEFAULT_GOSSIP_BLOCK,
                              staleness: int = 0) -> Any:
    """BUCKETED quantized-wire gossip (the reference's
    ``gossip_scan_wire_bucketed``): the whole tree is one zero-padded
    (M, D_pad) bucket (``comm.compressors.bucket_block``), and server i
    carries its own reference row r_i and a running accumulator acc_i::

        delta_t = W_t - r_(t-1)                (encoded; crosses the wire)
        r_t     = r_(t-1) + D(C(delta_t))_i
        acc_t   = acc_(t-1) + sum_j a[i,j] D(C(delta_t))_j
        W_(t+1) = acc_t

    ``staleness=0``: one encode (kernel 6), then T_S bucketed rounds
    (kernel 7).  ``staleness=s >= 1``: T_S pipelined rounds (kernel 8);
    round t consumes round t-s's codes from an s-deep ring, and the iterate
    stays frozen until the first delayed buffer lands.  Returns views of
    the result bucket in the tree's shapes."""
    if t_server == 0:
        return tree
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    leaves, treedef = _wire_leaves(tree)
    _, d_pad = _bucket_layout(leaves, block, codec.chunk)
    dtype = leaves[0].dtype
    out = _bucketed_period(a, _bucket_flat(leaves, d_pad), t_server, codec,
                           key, staleness, dtype=dtype)
    return _bucket_split(out, leaves, treedef, via=dtype)


def bucketed_roundtrip_tree(codec, tree: Any, key=None, *,
                            block: int = DEFAULT_GOSSIP_BLOCK,
                            rnd: int = 0) -> Any:
    """One wire round-trip of a server tree in the bucketed layout: what
    round ``rnd`` of the bucketed wire ships of each server's own model
    (the reference's error-feedback oracle)."""
    leaves, treedef = _wire_leaves(tree)
    m = leaves[0].shape[0]
    _, d_pad = _bucket_layout(leaves, block, codec.chunk)
    flat = _bucket_flat(leaves, d_pad)
    u = _bucket_dither_rows(key, m, d_pad, rnd=rnd,
                            out=torch.empty_like(flat))
    codes, scales = kops.quantized_gossip_encode(
        flat, torch.zeros_like(flat), u, *_code_buffers(flat, codec.chunk),
        bits=codec.bits, chunk=codec.chunk)
    y = (codes.reshape(m, -1, codec.chunk).float()
         * scales[..., None]).reshape(m, d_pad)
    return _bucket_split(y, leaves, treedef)


def wire_roundtrip_tree(codec, tree: Any, key=None, *,
                        block: int = DEFAULT_GOSSIP_BLOCK,
                        rnd: int = 0) -> Any:
    """One wire round-trip of a server tree in the per-leaf layout: what
    round ``rnd`` of ``gossip_scan_wire`` ships of each server's own model
    (the reference's round-0 oracle of the per-leaf wire)."""
    leaves, treedef = _wire_leaves(tree)
    m = leaves[0].shape[0]
    out = []
    for li, leaf in enumerate(leaves):
        flat = leaf.reshape(m, -1)
        d = flat.shape[1]
        rows, blk, nb, blk_pad = _leaf_blocks(flat, block, codec.chunk)
        u = _wire_dither_rows(key, m, nb, blk, leaf=li, rnd=rnd,
                              blk_pad=blk_pad, device=rows.device)
        codes, scales = kops.quantized_gossip_encode(
            rows, torch.zeros_like(rows), u, *_code_buffers(rows, codec.chunk),
            bits=codec.bits, chunk=codec.chunk)
        y = (codes.reshape(m, -1, codec.chunk).float()
             * scales[..., None]).reshape(rows.shape)
        out.append(_leaf_unblock(y, d, blk, nb, blk_pad).reshape(leaf.shape)
                   .to(leaf.dtype))
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# the multi-process wire: one process (rank) per server over a
# torch.distributed group; every collective of it goes through
# ``all_gather_rows``, ``ring_exchange`` or ``all_reduce_``
# ---------------------------------------------------------------------------

#: what the collective helpers did since ``reset_collective_counts()``:
#: ``calls``, ``bytes`` (what this rank SENT) and host ``op_seconds`` per
#: ``"op:dtype"``, the ``calls`` and ``site_bytes`` per collective
#: ``sites``, their total ``seconds`` and, of them, the ``staging_s`` of
#: the copies between the device and the pinned host buffers
_COLL: Dict[str, Any] = {"calls": {}, "bytes": {}, "op_seconds": {},
                         "sites": {}, "site_bytes": {}, "seconds": 0.0,
                         "staging_s": 0.0}
#: pinned host buffers of the staged collectives, one per collective site
_STAGING: Dict[str, torch.Tensor] = {}


def reset_collective_counts() -> None:
    _COLL["calls"], _COLL["bytes"], _COLL["op_seconds"] = {}, {}, {}
    _COLL["sites"], _COLL["site_bytes"] = {}, {}
    _COLL["seconds"] = _COLL["staging_s"] = 0.0


def collective_counts() -> Dict[str, Any]:
    """A copy of this rank's collective ledger (see ``_COLL``)."""
    return {"calls": dict(_COLL["calls"]), "bytes": dict(_COLL["bytes"]),
            "op_seconds": dict(_COLL["op_seconds"]),
            "sites": dict(_COLL["sites"]),
            "site_bytes": dict(_COLL["site_bytes"]),
            "seconds": _COLL["seconds"], "staging_s": _COLL["staging_s"]}


def _count(op: str, x: torch.Tensor, t0: float, sends: int = 1,
           site: str = "") -> None:
    """Count one call of ``op`` on ``x`` at ``site`` that started at
    ``t0``."""
    k = f"{op}:{str(x.dtype).replace('torch.', '')}"
    dt = time.perf_counter() - t0
    _COLL["calls"][k] = _COLL["calls"].get(k, 0) + 1
    _COLL["sites"][site] = _COLL["sites"].get(site, 0) + 1
    n = sends * x.numel() * x.element_size()
    _COLL["bytes"][k] = _COLL["bytes"].get(k, 0) + n
    _COLL["site_bytes"][site] = _COLL["site_bytes"].get(site, 0) + n
    _COLL["op_seconds"][k] = _COLL["op_seconds"].get(k, 0.0) + dt
    _COLL["seconds"] += dt


class DryGroup:
    """A stand-in process group of ``size`` ranks, this process being
    ``rank``: the collective helpers accept it, count the call and its bytes
    as for a real group, and move nothing (the gathered output is left
    unwritten, a reduction leaves its input).  On ``meta`` tensors it runs
    a rank's consensus program without a world (the dry run's collective
    record)."""

    def __init__(self, size: int, rank: int = 0):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a group of {size}")
        self.size, self.rank = int(size), int(rank)

    def __repr__(self) -> str:
        return f"DryGroup(size={self.size}, rank={self.rank})"


def group_size_rank(group) -> Tuple[int, int]:
    """``(world size, this process's rank)`` of ``group``."""
    if isinstance(group, DryGroup):
        return group.size, group.rank
    return dist.get_world_size(group), dist.get_rank(group)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` through host memory: a CUDA tensor on
    a gloo group.  Gloo moves host buffers; the staging through pinned host
    memory IS its transport for device tensors (NCCL takes them as they
    are)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(site: str, shape, dtype: torch.dtype) -> torch.Tensor:
    """The pinned host buffer of collective site ``site``, grown to hold a
    ``shape`` tensor of ``dtype`` and viewed as one."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = _STAGING.get(site)
    if buf is None or buf.numel() < n:
        _STAGING.pop(site, None)
        buf = torch.empty((max(n, 1),), dtype=torch.uint8, pin_memory=True)
        _STAGING[site] = buf
    return buf[:n].view(dtype).view(tuple(shape))


def release_staging() -> None:
    """Free the pinned host buffers of every collective site, and the
    pinned blocks the allocator caches (a long-lived rank between phases
    of different sizes); the next call at a site allocates its buffer
    again."""
    _STAGING.clear()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None and torch.cuda.is_available():
        empty()


def _to_host(x: torch.Tensor, site: str) -> torch.Tensor:
    t0 = time.perf_counter()
    h = _host(site, x.shape, x.dtype)
    h.copy_(x)                  # a device-to-host copy waits for the device
    _COLL["staging_s"] += time.perf_counter() - t0
    return h


def _to_device(dst: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    dst.copy_(h)
    torch.cuda.current_stream(dst.device).synchronize()
    _COLL["staging_s"] += time.perf_counter() - t0
    return dst


def all_gather_rows(x: torch.Tensor, group, *,
                    out: Optional[torch.Tensor] = None,
                    site: str = "all_gather") -> torch.Tensor:
    """Every rank's ``(rows, ...)`` tensor stacked in rank order, ``(M *
    rows, ...)``: the port of ``jax.lax.all_gather`` over the server axis.
    ``out`` (contiguous, on ``x``'s device) receives it; ``site`` names the
    pinned host buffers of a staged call.  On gloo every rank sends its
    rows to every peer at once in one ``batch_isend_irecv`` (gloo's own
    ring all_gather runs its M - 1 steps one after another, 3-4x slower
    over loopback at four ranks); other backends take
    ``dist.all_gather``.  Counts one call and ``x``'s bytes; a collective
    error is raised as it comes."""
    t0 = time.perf_counter()
    m, r = group_size_rank(group)
    x = x.contiguous()
    shape = (m * x.shape[0],) + tuple(x.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if tuple(out.shape) != shape or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {shape} tensor")
    if isinstance(group, DryGroup):
        pass
    elif dist.get_backend(group) == "gloo":
        staged = x.is_cuda
        send = _to_host(x, site + ":send") if staged else x
        recv = _host(site + ":recv", shape, x.dtype) if staged else out
        parts = recv.chunk(m)
        ops = []
        for k in range(1, m):
            dst, src = (r + k) % m, (r - k) % m
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(group, dst), group))
            ops.append(dist.P2POp(dist.irecv, parts[src],
                                  dist.get_global_rank(group, src), group))
        for work in (dist.batch_isend_irecv(ops) if ops else []):
            work.wait()
        parts[r].copy_(send)
        if staged:
            _to_device(out, recv)
    else:
        dist.all_gather(list(out.chunk(m)), x, group=group)
    _count("all_gather", x, t0, site=site)
    return out


def ring_exchange(x: torch.Tensor, group, *,
                  site: str = "ring") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(left, right)``: ring neighbour ``rank - 1``'s and ``rank + 1``'s
    copy of ``x``, exchanged in one ``batch_isend_irecv`` (the port of
    ``jax.lax.ppermute`` with the forward and backward ring permutations).
    Counts one call and the bytes of the two sends."""
    t0 = time.perf_counter()
    m, r = group_size_rank(group)
    x = x.contiguous()
    if m == 1:                      # a ring of one: the self-loop
        return x, x
    if isinstance(group, DryGroup):
        _count("ring_exchange", x, t0, sends=2, site=site)
        return torch.empty_like(x), torch.empty_like(x)
    staged = _staged(x, group)
    send = _to_host(x, site + ":send") if staged else x
    left = (_host(site + ":left", x.shape, x.dtype) if staged
            else torch.empty_like(x))
    right = (_host(site + ":right", x.shape, x.dtype) if staged
             else torch.empty_like(x))
    nxt = dist.get_global_rank(group, (r + 1) % m)
    prv = dist.get_global_rank(group, (r - 1) % m)
    ops = [dist.P2POp(dist.isend, send, nxt, group),
           dist.P2POp(dist.isend, send, prv, group),
           dist.P2POp(dist.irecv, left, prv, group),
           dist.P2POp(dist.irecv, right, nxt, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        left = _to_device(torch.empty_like(x), left)
        right = _to_device(torch.empty_like(x), right)
    _count("ring_exchange", x, t0, sends=2, site=site)
    return left, right


def all_reduce_(x: torch.Tensor, group, op: str = "sum", *,
                site: str = "all_reduce") -> torch.Tensor:
    """``x`` reduced over the ranks in place (``op`` ``"sum"`` or
    ``"max"``): the one helper through which the epoch step's metrics
    reduce over servers.  Counts one call and ``x``'s bytes."""
    t0 = time.perf_counter()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if isinstance(group, DryGroup):
        pass
    elif _staged(x, group):
        h = _to_host(x, site)
        dist.all_reduce(h, op=red, group=group)
        _to_device(x, h)
    else:
        dist.all_reduce(x, op=red, group=group)
    _count("all_reduce", x, t0, site=site)
    return x


# -- the intra-client collectives: a client cut over ranks ------------------


def _flat_of(leaves) -> torch.Tensor:
    kops.one_dtype(leaves, "an intra-client collective")
    return torch.cat([x.reshape(-1) for x in leaves])


def gather_pieces(pieces, dims, group, *,
                  site: str = "fsdp_gather") -> list:
    """The whole leaves of one unit (a layer, or a model's top-level
    leaves) from every rank's pieces, in one ``all_gather_rows`` over
    ``group`` of their concatenation: ``pieces[i]`` is cut along dim
    ``dims[i]`` into as many pieces as ``group`` has ranks, a rank's piece
    at its group rank (``launch.mesh.RankMesh.ranks_over``); a ``None``
    dim is a leaf every rank holds whole, returned as it is.  One
    collective a unit, whatever its leaf count."""
    cut = [p for p, d in zip(pieces, dims) if d is not None]
    if not cut or group is None:
        return list(pieces)
    k, _ = group_size_rank(group)
    got = all_gather_rows(_flat_of(cut)[None], group, site=site)
    out, off = [], 0
    for p, d in zip(pieces, dims):
        if d is None:
            out.append(p)
            continue
        n = p.numel()
        parts = got[:, off:off + n].reshape((k,) + tuple(p.shape))
        shape = list(p.shape)
        shape[d] *= k
        out.append(parts.movedim(0, d).reshape(shape))
        off += n
    return out


def reduce_to_pieces(grads, dims, group, pos: int, k: int, *,
                     site: str = "grad_reduce") -> list:
    """Each rank's piece of the mean over ``group`` of one unit's
    whole-leaf gradients: one ``all_reduce_`` (sum) of their concatenation
    divided by the group's size, then each leaf cut along ``dims[i]`` into
    ``k`` pieces and the one at ``pos`` kept (a ``None`` dim: the whole
    leaf, a replicated leaf's averaged gradient).  gloo has no
    reduce-scatter, so the whole sum crosses and the rank slices its piece
    from it: the sum a reduce-scatter would give, at twice its bytes.
    ``group`` None (the batch not split) reduces nothing."""
    if group is not None:
        flat = _flat_of(grads)
        all_reduce_(flat, group, site=site)
        flat.div_(group_size_rank(group)[0])
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()
        grads = out
    return [g if d is None else g.narrow(d, pos * (g.shape[d] // k),
                                         g.shape[d] // k).contiguous()
            for g, d in zip(grads, dims)]



# -- shard_map gossip: the rank-local programs ------------------------------


def _check_shard_map(codec, with_shipped: bool, staleness: int) -> None:
    if with_shipped and codec is None:
        raise ValueError("with_shipped is the wire codec's error-feedback "
                         "hook; it needs codec=")
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if staleness and codec is None:
        raise ValueError(
            "bounded staleness needs the delta-coded wire (codec=): the "
            "plain shard_map path gossips raw state, which has no "
            "innovation stream to consume late — build with a quantizer "
            "codec or use staleness=0")


class _ServerView(NamedTuple):
    """Where this rank sits on the server axis: the ``group`` of the ranks
    that share its other coordinates, its ``m`` servers, this rank's
    server ``idx``, its row-major position ``sub`` over the ``n_other``
    positions of the other axes (the wire's dither coordinate is ``idx *
    n_other + sub``), and the ``world`` group a federation-wide reduction
    crosses."""

    group: Any
    m: int
    idx: int
    sub: int
    n_other: int
    world: Any


def _server_view(mesh, axis_name: str) -> _ServerView:
    """The ``axis_name`` axis of a ``launch.mesh.RankMesh``; a bare group
    (``None`` for the default one, a ``torch.distributed`` group or a
    ``DryGroup``) is the one-axis mesh of its ranks, one server a rank.
    The only place that tells the two apart."""
    if mesh is None or isinstance(mesh, (dist.ProcessGroup, DryGroup)):
        m, rank = group_size_rank(mesh)
        return _ServerView(mesh, m, rank, 0, 1, mesh)
    sub, n_other = mesh.other_index(axis_name)
    return _ServerView(mesh.group(axis_name), mesh.shape[axis_name],
                       mesh.coords()[axis_name], sub, n_other,
                       mesh.world_group())


def disagreement_over(server_tree: Any, group, m: int) -> torch.Tensor:
    """``sqrt(sum_i |w_i|^2 - M |mean|^2)`` of the federation from one
    rank's whole rows: the squared norms and the row sums all-reduced over
    ``group``."""
    total = None
    for leaf in tree_leaves(server_tree):
        s_sq = torch.sum(torch.square(leaf), dtype=torch.float32).reshape(1)
        col = leaf.sum(dim=0, dtype=torch.float32)
        all_reduce_(s_sq, group, site="metrics")
        all_reduce_(col, group, site="metrics")
        term = s_sq[0] - m * torch.sum(torch.square(col / m))
        total = term if total is None else total + term
    return torch.sqrt(torch.clamp(total, min=0.0))


def _check_leaf_count(tree: Any, leaf_specs: Any) -> None:
    if leaf_specs is not None and \
            len(tree_leaves(tree)) != len(tree_leaves(leaf_specs)):
        raise ValueError(f"a tree of {len(tree_leaves(tree))} leaves "
                         f"against {len(tree_leaves(leaf_specs))} leaf specs")


class _ShardProgram:
    """What both shard_map programs hold: the mesh (or bare group) and its
    server axis, read once into ``view`` when the program first runs."""

    def __init__(self, mesh, t_server: int, block: int, leaf_specs=None,
                 axis_name: str = "server"):
        self.mesh, self.t_server, self.block = mesh, t_server, block
        self.leaf_specs, self.axis_name = leaf_specs, axis_name

    @functools.cached_property
    def view(self) -> _ServerView:
        return _server_view(self.mesh, self.axis_name)


class _ShardPlain(_ShardProgram):
    """The plain shard_map program, ``run(a, local_tree)``: each leaf of the
    rank's ``(1, ...)`` rows (its piece of its server's row, on a mesh),
    flattened in its own dtype (bf16 stays bf16 on the wire) and cut into
    blocks of ``min(block, d)`` with a zero-padded tail, runs T_S rounds a
    block of one ``all_gather_rows`` over the server group and kernel 1's
    row form with A's own row, leaf after leaf.  The piece k of server i
    mixes with the pieces k of the other servers only."""

    def __call__(self, a: torch.Tensor, tree: Any) -> Any:
        if self.t_server == 0:
            return tree
        _check_leaf_count(tree, self.leaf_specs)
        view = self.view
        m, idx = view.m, view.idx
        leaves, treedef = tree_flatten(tree)
        kops.one_dtype(leaves, "the shard_map gossip")
        out = []
        for leaf in leaves:
            rows = leaf.shape[0]
            a_row = _f32_on(a, leaf)[idx * rows:(idx + 1) * rows] \
                .contiguous()
            flat = leaf.reshape(rows, -1)
            d = flat.shape[1]
            blk = max(min(self.block, d), 1)
            nb = -(-d // blk)
            buf = torch.zeros((rows, nb * blk), dtype=leaf.dtype,
                              device=leaf.device)
            buf[:, :d] = flat
            gathered = torch.empty((m * rows, blk), dtype=leaf.dtype,
                                   device=leaf.device)
            nxt = torch.empty((rows, blk), dtype=leaf.dtype,
                              device=leaf.device)
            for b in range(nb):
                w = buf[:, b * blk:(b + 1) * blk]
                for _ in range(self.t_server):
                    all_gather_rows(w, view.group, out=gathered,
                                    site="plain")
                    kops.consensus_mix_rows(a_row, gathered, out=nxt)
                    w.copy_(nxt)
            out.append(buf[:, :d].reshape(leaf.shape))
        return tree_unflatten(treedef, out)


class _ShardWire(_ShardProgram):
    """The bucketed quantized-wire shard_map program, ``run(a, local_tree,
    key=None)`` (``(mixed, shipped)`` with ``with_shipped``): the rank's
    whole local tree (on a mesh: its pieces of its server's row) is one
    zero-padded (1, D_pad) f32 bucket (``_bucket_layout`` /
    ``_bucket_flat``), and every round is ONE int8 ``all_gather_rows`` of
    codes (int4 packed two a byte) plus ONE f32 one of scales over the
    server group, whatever the leaf count.  The rank keeps its own reference
    row and accumulator; round 0 encodes on kernel 6, each round then runs
    kernel 7's row form (staleness 0) or kernel 8's (staleness s >= 1, the
    gathered codes in an (s, M, D_pad) in-flight ring pre-filled with zero
    codes and unit scales).  The dither's server coordinate is ``idx *
    n_other + sub`` (``_ServerView``; the rank on a bare group), so the
    pieces of one server row draw distinct noise.  ``gather_codes=False``
    ships the same code values at f32 width.  Row ``rank`` of the result
    is bitwise row ``rank`` of ``gossip_scan_wire_bucketed`` under the same
    key; on a mesh, the piece k of server i is row ``i * n_other + k`` of
    it on the (M * n_other)-row problem of every piece under ``A ⊗ I``."""

    def __init__(self, mesh, t_server: int, block: int, codec,
                 stochastic: bool, gather_codes: bool, with_shipped: bool,
                 staleness: int, leaf_specs=None, axis_name: str = "server"):
        super().__init__(mesh, t_server, block, leaf_specs, axis_name)
        self.codec, self.stochastic = codec, stochastic
        self.gather_codes, self.with_shipped = gather_codes, with_shipped
        self.staleness = staleness

    def __call__(self, a: torch.Tensor, tree: Any, key=None):
        if self.stochastic and key is None:
            raise ValueError(
                "this wire program was built stochastic=True and needs the "
                "rounding key; build with stochastic=False for "
                "deterministic round-to-nearest")
        if self.t_server == 0:      # nothing crosses the wire (or is shipped)
            return ((tree, tree_map(torch.zeros_like, tree))
                    if self.with_shipped else tree)
        codec = self.codec
        _check_leaf_count(tree, self.leaf_specs)
        leaves, treedef = _wire_leaves(tree)
        _, d_pad = _bucket_layout(leaves, self.block, codec.chunk)
        dtype = leaves[0].dtype
        sent = []

        def shipped(codes, scales):
            rows = codes.shape[0]
            sent.append((codes.reshape(rows, -1, codec.chunk).float()
                         * scales[..., None]).reshape(rows, d_pad))

        out = self.period(a, _bucket_flat(leaves, d_pad),
                          key if self.stochastic else None,
                          shipped=shipped if self.with_shipped else None,
                          dtype=dtype)
        mixed = _bucket_split(out, leaves, treedef, via=dtype)
        if not self.with_shipped:
            return mixed
        return mixed, _bucket_split(sent[0], leaves, treedef)

    def _gather(self, group, codes: torch.Tensor, scales: torch.Tensor,
                g_codes: torch.Tensor, g_scales: torch.Tensor) -> None:
        """One round's collective pair into ``g_codes`` / ``g_scales``."""
        codec = self.codec
        payload = (_compressors.pack_int4(codes) if codec.bits == 4
                   else codes)
        if self.gather_codes and codec.bits == 8:
            all_gather_rows(payload, group, out=g_codes, site="codes")
        else:
            wide = payload.float() if not self.gather_codes else payload
            got = all_gather_rows(wide, group, site="codes").to(torch.int8)
            g_codes.copy_(_compressors.unpack_int4(got, g_codes.shape[1])
                          if codec.bits == 4 else got)
        all_gather_rows(scales, group, out=g_scales, site="scales")

    def period(self, a: torch.Tensor, flat: torch.Tensor, key,
               shipped: Optional[Callable] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``_bucketed_period`` of the rank's own (rows, D_pad) f32 bucket:
        the iterate after T_S rounds.  ``shipped(codes, scales)`` receives
        round 0's own codes and scales (the error-feedback hook)."""
        codec = self.codec
        view = self.view
        group, m, idx = view.group, view.m, view.idx
        rows, d_pad = flat.shape
        bits, chunk, nc = codec.bits, codec.chunk, d_pad // codec.chunk
        a_rows = _f32_on(a, flat)[idx * rows:(idx + 1) * rows].contiguous()
        ref = torch.zeros_like(flat)
        acc = torch.zeros_like(flat)
        u = torch.empty_like(flat)
        codes = torch.empty((rows, d_pad), dtype=torch.int8,
                            device=flat.device)
        scales = torch.empty((rows, nc), dtype=torch.float32,
                             device=flat.device)

        def dither(rnd):
            if key is None:
                return u.fill_(0.5)
            for i in range(rows):
                _compressors.wire_dither(
                    key, d_pad, leaf=0, rnd=rnd,
                    server=(idx * rows + i) * view.n_other + view.sub,
                    block=0, out=u[i])
            return u

        s = self.staleness
        if s == 0:
            kops.quantized_gossip_encode(flat, ref, dither(0), codes, scales,
                                         bits=bits, chunk=chunk)
            if shipped is not None:
                shipped(codes, scales)
            g_codes = torch.empty((m * rows, d_pad), dtype=torch.int8,
                                  device=flat.device)
            g_scales = torch.empty((m * rows, nc), dtype=torch.float32,
                                   device=flat.device)
            w = None if dtype == torch.float32 else torch.empty_like(flat)
            for t in range(self.t_server):
                self._gather(group, codes, scales, g_codes, g_scales)
                if t + 1 < self.t_server:   # the last re-encode is unused
                    dither(t + 1)
                kops.bucketed_gossip_round_rows(
                    a_rows, g_codes, g_scales, ref, acc, u, codes, scales,
                    row0=idx * rows, bits=bits, chunk=chunk)
                if w is not None and t + 1 < self.t_server:
                    kops.quantized_gossip_encode(
                        _round_to(w.copy_(acc), dtype), ref, u, codes,
                        scales, bits=bits, chunk=chunk)
            return acc
        ring_c = torch.zeros((s, m * rows, d_pad), dtype=torch.int8,
                             device=flat.device)
        ring_s = torch.ones((s, m * rows, nc), dtype=torch.float32,
                            device=flat.device)
        w = flat
        for t in range(self.t_server):
            slot = t % s
            kops.bucketed_gossip_round_pipelined_rows(
                a_rows, ring_c[slot], ring_s[slot], w, ref, acc, dither(t),
                codes, scales, bits=bits, chunk=chunk)
            if t == 0 and shipped is not None:
                shipped(codes, scales)
            # this round's codes, consumed s rounds from now
            self._gather(group, codes, scales, ring_c[slot], ring_s[slot])
            if t >= s:              # a delayed buffer has landed
                if dtype == torch.float32:
                    w = acc
                else:
                    if w is flat:
                        w = torch.empty_like(flat)
                    _round_to(w.copy_(acc), dtype)
        return w


def make_gossip_shard_map(mesh, t_server: int, leaf_specs: Any = None, *,
                          axis_name: str = "server",
                          block: int = 16_777_216, codec=None,
                          stochastic: bool = True,
                          gather_codes: bool = True,
                          with_shipped: bool = False,
                          staleness: int = 0) -> Callable:
    """T_S-round gossip as a rank-local program (the reference's
    ``make_gossip_shard_map``).  ``mesh`` is a ``launch.mesh.RankMesh``
    whose ``axis_name`` axis holds the M servers, each rank holding its
    piece of its server's row cut by ``leaf_specs`` (the specs of the
    ``(M, *w)`` server tree, ``launch.sharding.fl_server_specs``); or a bare
    ``torch.distributed`` group of M processes, rank r holding server r.
    Each round gathers over the ranks that share this rank's other
    coordinates only.

    Returns ``run(a, local_tree)`` (plain) or ``run(a, local_tree,
    key=None)`` (``codec=`` a quantizer): ``a`` the full ``(M, M)`` operator
    (A, or A' for a push-sum numerator), read row-wise; ``local_tree`` the
    rank's leading ``(1, ...)`` rows.  The plain program is ``_ShardPlain``,
    the bucketed wire ``_ShardWire``.  ``with_shipped`` returns ``(mixed,
    shipped)`` with ``shipped`` round 0's own decoded transmission;
    ``staleness=s > 0`` needs the codec; ``t_server == 0`` is the
    identity.  A leaf replicated over the other axes keeps one copy a rank
    (on the wire the copies draw distinct dither and drift apart, as the
    reference's devices' do)."""
    _check_shard_map(codec, with_shipped, staleness)
    if codec is None:
        return _ShardPlain(mesh, t_server, block, leaf_specs, axis_name)
    return _ShardWire(mesh, t_server, block, codec, stochastic,
                      gather_codes, with_shipped, staleness, leaf_specs,
                      axis_name)


# -- ring gossip over the neighbour exchange ---------------------------------


def ring_gossip_step(w: torch.Tensor, group, *, self_weight: float,
                     neighbor_weight: float) -> torch.Tensor:
    """One ring round on the rank's rows: ``self·w + nb·(left + right)``
    with the two ring neighbours' copies from ``ring_exchange``."""
    left, right = ring_exchange(w, group)
    return (self_weight * w + neighbor_weight * (left + right)).to(w.dtype)


def make_ring_gossip(group, t_server: int, self_weight: float,
                     neighbor_weight: float, *, codec=None,
                     stochastic: bool = True,
                     gather_codes: bool = True) -> Callable:
    """T_S-round ring gossip over ``group`` (the reference's
    ``make_ring_gossip``): ``run(local_tree, key=None)``.

    With ``codec=`` a quantizer the neighbours exchange codes and scales
    instead of floats: each round every leaf encodes its DELTA against the
    receivers' decoded reference of it (``codec.encode_block`` over the
    rank's flattened leaf, dither ``wire_dither(key, length, leaf=li,
    rnd=t, server=rank, block=0)``), ships the one code buffer to both
    neighbours, and every rank adds the decoded deltas to its three
    references (self, left, right) and mixes them one weighted term per
    add.  ``gather_codes=False`` is the simulated twin: the same code
    values at f32 width, bitwise the same result."""
    if codec is not None and not isinstance(
            codec, _compressors.StochasticQuantizer):
        raise ValueError("the ring wire ships quantizer codes; codec= must "
                         "be an int8/int4 StochasticQuantizer")

    def run(tree: Any, key=None) -> Any:
        if codec is None:
            for _ in range(t_server):
                tree = tree_map(lambda x: ring_gossip_step(
                    x, group, self_weight=self_weight,
                    neighbor_weight=neighbor_weight), tree)
            return tree
        if stochastic and key is None:
            raise ValueError("this wire program was built stochastic=True "
                             "and needs the rounding key")
        _, rank = group_size_rank(group)
        leaves, treedef = tree_flatten(tree)
        out = []
        for li, leaf in enumerate(leaves):
            flat = leaf.reshape(-1)
            length = flat.numel()
            r_self, r_left, r_right = (torch.zeros(
                (length,), dtype=torch.float32, device=flat.device)
                for _ in range(3))
            for t in range(t_server):
                delta = flat.float() - r_self
                dither = (0.5 if key is None or not stochastic else
                          _compressors.wire_dither(
                              key, length, leaf=li, rnd=t, server=rank,
                              block=0, device=flat.device))
                codes, scales = codec.encode_block(delta, dither)
                wire = codes if gather_codes else codes.float()
                lc, rc = ring_exchange(wire, group, site="ring_codes")
                ls, rs = ring_exchange(scales, group, site="ring_scales")
                r_self = r_self + codec.decode_block(codes, scales, length)
                r_left = r_left + codec.decode_block(lc.to(codes.dtype), ls,
                                                     length)
                r_right = r_right + codec.decode_block(rc.to(codes.dtype),
                                                       rs, length)
                acc = self_weight * r_self
                acc = acc + neighbor_weight * r_left
                acc = acc + neighbor_weight * r_right
                flat = acc.to(leaf.dtype)
            out.append(flat.reshape(leaf.shape))
        return tree_unflatten(treedef, out)

    return run


# ---------------------------------------------------------------------------
# consensus backends: one interface over every execution strategy
# ---------------------------------------------------------------------------


class ConsensusBackend:
    """One consensus period behind one interface: ``mix(tree, a_p, lam2)``
    runs it on a server-leading pytree.  ``a_p`` is an optional per-epoch
    ``(M, M)`` mixing matrix; ``None`` selects the static matrix the
    backend was built with.  ``lam2`` is the optional per-epoch spectral
    estimate, read by ``needs_spectral`` backends (Chebyshev) and ignored
    by the rest.  ``supports_directed`` says whether the update is the
    literal ``W <- A W`` (so a row-stochastic A is well defined, and
    ``mix_push_sum`` runs ratio consensus through the same strategy)."""

    name = "?"
    supports_directed = True
    needs_spectral = False
    robust = False
    staleness = 0
    # bound to a process group of one rank a server (shard_map): the trees
    # it mixes hold the rank's own rows, and M cannot change
    mesh_bound = False

    def __init__(self, a_static: Optional[np.ndarray], t_server: int):
        self.a_static = (None if a_static is None
                         else torch.as_tensor(np.asarray(a_static),
                                              dtype=torch.float32))
        self.t_server = t_server

    def _resolve(self, a_p: Optional[torch.Tensor]) -> torch.Tensor:
        if a_p is not None:
            return a_p
        if self.a_static is None:
            raise ValueError(f"{self.name!r} backend was built without a "
                             f"static mixing matrix; pass a per-epoch A_p")
        return self.a_static

    def mix(self, tree: Any, a_p: Optional[torch.Tensor] = None,
            lam2=None) -> Any:
        """T_S rounds of ``W <- A W`` over the leading server axis."""
        del lam2
        return self._mix(tree, self._resolve(a_p))

    def _mix(self, tree: Any, a: torch.Tensor) -> Any:
        raise NotImplementedError

    def mix_stats(self, tree: Any, a_p: Optional[torch.Tensor] = None,
                  lam2=None):
        """``mix`` plus the period's per-source screen-activity counts,
        ``(mixed, rejected)`` with ``rejected[j]`` how many of server j's
        values its receivers' screens discarded or clipped (float32, on the
        tree's device).  A backend that screens nothing returns ``mix`` and
        zeros; the robust backends return their own counts."""
        return (self.mix(tree, a_p, lam2=lam2),
                _zero_counts(self._resolve(a_p), tree))

    def mix_push_sum(self, state: PushSumState,
                     a_p: Optional[torch.Tensor] = None) -> PushSumState:
        """Ratio consensus: the numerator through this backend's strategy
        with ``P = A'``, the weight by the ``(M,)`` matvec.  Refused where
        the update is not the literal ``W <- A W``, and under staleness (the
        exact weight recursion has no delayed twin)."""
        self._check_push_sum()
        return PushSumState(self.mix_numerator(state.values, a_p),
                            self.push_weight(state.weight, a_p))

    def _check_push_sum(self) -> None:
        if not self.supports_directed:
            raise ValueError(
                f"consensus backend {self.name!r} has no ratio-consensus "
                f"analogue: its value update is not the literal W <- A W, "
                f"so a numerator/weight pair mixed by it would be "
                f"inconsistent")
        if self.staleness:
            raise ValueError(
                f"consensus backend {self.name!r} has staleness="
                f"{self.staleness}, but ratio consensus mixes a "
                f"numerator/weight PAIR and the exact (M,) weight recursion "
                f"has no delayed twin — a stale numerator over a fresh "
                f"weight breaks mass conservation; use staleness=0 with "
                f"push-sum")

    def mix_numerator(self, tree: Any, a_p: Optional[torch.Tensor] = None
                      ) -> Any:
        """The push-sum numerator's period: ``mix`` with ``P = A'``."""
        return self._mix(tree, _transpose(self._resolve(a_p)))

    def push_weight(self, weight: torch.Tensor,
                    a_p: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The push-sum weight's period: T_S rounds of ``w <- P w``."""
        return _push_weight(_transpose(self._resolve(a_p)), weight,
                            self.t_server)

    def first_round(self, a_p: Optional[torch.Tensor], m: int, lam2=None,
                    transpose: bool = False):
        """The period split after its first operator: ``(first, rest)``,
        ``first`` the (M, M) operator of the first round (``None`` for an
        empty period) and ``rest(tree)`` the rest of the period; with
        ``transpose`` the push-sum numerator's period (``P = A'``).  The
        simulated wire fuses ``first`` into kernel 4."""
        raise NotImplementedError


class GossipBackend(ConsensusBackend):
    """T_S rounds on the tree flattened once to ``(M, D)``: each round one
    ``ops.consensus_mix`` (one kernel launch on the card).  With
    ``staleness=s > 0`` the plain mix is ``gossip_scan_stale`` (the
    physical-wire wrapper pipelines the codes instead)."""

    name = "gossip"

    def __init__(self, a_static, t_server, *, staleness: int = 0):
        super().__init__(a_static, t_server)
        self.staleness = staleness

    def _mix(self, tree, a):
        if self.staleness:
            return gossip_scan_stale(a, tree, self.t_server, self.staleness)
        return kops.consensus_mix_pytree(a, tree, rounds=self.t_server)

    def first_round(self, a_p, m, lam2=None, transpose=False):
        return _first_of_rounds(self._resolve(a_p), self.t_server, None,
                                transpose)


class BlockedGossipBackend(ConsensusBackend):
    """``gossip_scan_blocked``: the rounds streamed over fixed-size column
    blocks (one kernel launch per block per round on the card)."""

    name = "gossip_blocked"

    def __init__(self, a_static, t_server, *,
                 block: int = DEFAULT_GOSSIP_BLOCK, staleness: int = 0):
        super().__init__(a_static, t_server)
        self.block = block
        self.staleness = staleness

    def _mix(self, tree, a):
        if self.staleness:
            # the delayed history would multiply the blocked working set by
            # s + 1 for nothing: the unblocked stale rounds, as the
            # reference does
            return gossip_scan_stale(a, tree, self.t_server, self.staleness)
        return gossip_scan_blocked(a, tree, self.t_server, block=self.block)

    def first_round(self, a_p, m, lam2=None, transpose=False):
        return _first_of_rounds(self._resolve(a_p), self.t_server,
                                self.block, transpose)


def _first_of_rounds(a: torch.Tensor, t_server: int, block: Optional[int],
                     transpose: bool = False):
    """``first_round`` of T_S literal rounds of ``a`` (of ``a'`` with
    ``transpose``)."""
    if t_server == 0:
        return None, lambda tree: tree
    if transpose:
        a = _transpose(a)
    return a, lambda tree: kops.consensus_mix_pytree(
        a, tree, rounds=t_server - 1, block=block)


class CollapsedBackend(ConsensusBackend):
    """One round with ``A_eff = A^{T_S}``: host-side float64 collapse of the
    static matrix, in-program collapse of a per-epoch ``A_p``."""

    name = "collapsed"

    def __init__(self, a_static, t_server):
        super().__init__(a_static, t_server)
        self._eff_static = (None if a_static is None else torch.as_tensor(
            collapse_mixing(np.asarray(a_static), t_server),
            dtype=torch.float32))

    def _eff(self, a_p: Optional[torch.Tensor]) -> torch.Tensor:
        if a_p is None:
            if self._eff_static is None:
                raise ValueError("'collapsed' backend was built without a "
                                 "static mixing matrix; pass a per-epoch A_p")
            return self._eff_static
        eff = torch.eye(a_p.shape[0], dtype=a_p.dtype, device=a_p.device)
        for _ in range(self.t_server):
            eff = a_p @ eff
        return eff

    def mix(self, tree, a_p=None, lam2=None):
        del lam2
        return kops.consensus_mix_pytree(self._eff(a_p), tree, rounds=1)

    # push-sum: (A^{T_S})' == (A')^{T_S}, one collapsed round of the
    # transpose for the numerator and for the weight
    def mix_numerator(self, tree, a_p=None):
        return kops.consensus_mix_pytree(_transpose(self._eff(a_p)), tree,
                                         rounds=1)

    def push_weight(self, weight, a_p=None):
        return _push_weight(_transpose(self._eff(a_p)), weight, 1)

    def first_round(self, a_p, m, lam2=None, transpose=False):
        eff = self._eff(a_p)
        return (_transpose(eff) if transpose else eff), lambda tree: tree


class ChebyshevBackend(ConsensusBackend):
    """Chebyshev semi-iterative gossip (``gossip_chebyshev``), ``rounds``
    products a period (default ceil(sqrt(T_S))).  Its spectral datum rides
    beside the matrix: ``lambda_2(A)`` of the static topology, computed on
    the host at construction, or the per-epoch ``lam2`` of a dynamic
    schedule; a per-epoch ``A_p`` without one falls back to
    ``lambda2_traced``.  The affine recursion has negative coefficients,
    so it has no directed (push-sum) analogue."""

    name = "chebyshev"
    supports_directed = False
    needs_spectral = True

    def __init__(self, a_static, t_server, *, rounds: Optional[int] = None):
        super().__init__(a_static, t_server)
        self.lam2 = (None if a_static is None
                     else tp_lambda_2(np.asarray(a_static)))
        self.rounds = rounds or max(1, int(np.ceil(np.sqrt(max(t_server,
                                                               1)))))

    def mix(self, tree, a_p=None, lam2=None):
        a = self._resolve(a_p)
        if lam2 is None:
            lam2 = self.lam2 if a_p is None else lambda2_traced(a_p)
        if lam2 is None:
            raise ValueError("'chebyshev' was built without a static mixing "
                             "matrix; pass (a_p, lam2) per call")
        return gossip_chebyshev(a, tree, self.rounds, lam2)

    def first_round(self, a_p, m, lam2=None, transpose=False):
        # the recursion reads the decoded message itself (w_0), so the
        # simulated wire's kernel-4 pass decodes on A = I (exact) and the
        # whole recursion follows
        return torch.eye(m), lambda tree: self.mix(tree, a_p, lam2=lam2)


class ExactMeanBackend(ConsensusBackend):
    """The idealised sigma_A = 0 limit (hierarchical FL with a root
    aggregator): ignores the mixing matrix, so directed mixing is undefined
    for it."""

    name = "exact_mean"
    supports_directed = False

    def _mix(self, tree, a):
        return tree_map(lambda x: x.mean(dim=0, keepdim=True).expand(x.shape),
                        tree)

    def first_round(self, a_p, m, lam2=None, transpose=False):
        return torch.full((m, m), 1.0 / m), lambda tree: tree


# ---------------------------------------------------------------------------
# robust (Byzantine-screening) gossip: trimmed mean / median / clipped
# ---------------------------------------------------------------------------

#: columns of one block of the rank screens: the screen is coordinatewise,
#: so a leaf is screened block by block (all T_S rounds on a block, then
#: the next), which is the same result as whole leaves.  The workspace of a
#: block is about (M(M-1)/2 + 14) bytes a column: 0.34 GB at M = 4.
RANK_SCREEN_BLOCK = 1 << 24


def _support(a: torch.Tensor) -> torch.Tensor:
    """Boolean (M, M) gossip support of a mixing matrix: every positive
    entry plus the diagonal — a server always counts its OWN value among
    the screened candidates, even on graphs whose self-weight is 0."""
    return (a > 0) | torch.eye(a.shape[0], dtype=torch.bool, device=a.device)


def _trim_rule(f: int) -> Callable[[int], tuple]:
    """The trimmed mean's kept ranks, ``f <= r < c - f``, as an inclusive
    range of a neighbourhood of ``c`` values."""
    return lambda c: (f, c - f - 1)


def _median_rule(c: int) -> tuple:
    """The median's kept ranks: the middle one, or the middle two of an
    even neighbourhood (their mean)."""
    return (c - 1) // 2, c // 2


def _rank_keep_block(sup: np.ndarray, x: torch.Tensor, rule,
                     rejected: torch.Tensor) -> torch.Tensor:
    """One rank-screened round on an (M, B) block of one leaf: the port of
    the reference's ``_rank_keep_mean_stats``.

    Receiver ``i`` ranks the supported values ``x[j]`` (``sup[i, j]``) of
    each coordinate, ties broken by source index, which is the reference's
    stable double argsort over values with non-neighbours set to +inf: the
    rank of ``j`` is the number of supported ``k`` whose value sorts before
    it (``x[k] < x[j]``, or equal with ``k < j``), plus the non-neighbours
    of lower index where ``x[j]`` is +inf itself.  ``rule(c)`` gives the
    inclusive range of kept ranks; the kept values are summed in source
    order (in f32; a bf16 leaf rounds the sum to bf16, as ``jnp.sum``
    upcasts it) and divided by their count in the leaf dtype.  A receiver
    with nothing kept holds its own value.  Receivers with the same support
    share one screen.  ``rejected[j]`` (int64) gains the (receiver,
    coordinate) pairs that discarded ``x[j]``."""
    m, width = x.shape
    # before[k][j]: x[k] sorts before x[j]; only the pairs k < j are
    # compared, the rest is their complement
    before = [[None] * m for _ in range(m)]
    for j in range(m):
        for k in range(j + 1, m):
            later_first = x[k] < x[j]
            before[k][j] = later_first
            before[j][k] = ~later_first
    rows: dict = {}
    for i in range(m):
        rows.setdefault(tuple(bool(v) for v in sup[i]), []).append(i)
    out = torch.empty_like(x)
    for key, receivers in rows.items():
        srcs = [j for j in range(m) if key[j]]
        lo, hi = rule(len(srcs))
        acc = torch.zeros((width,), dtype=torch.float32, device=x.device)
        kcnt = torch.zeros((width,), dtype=torch.int16, device=x.device)
        for j in srcs:
            rank = torch.zeros((width,), dtype=torch.int16, device=x.device)
            for k in srcs:
                if k != j:
                    rank += before[k][j]
            n_inf = sum(1 for k in range(j) if not key[k])
            if n_inf:
                rank += torch.isposinf(x[j]).to(torch.int16) * n_inf
            keep = (rank >= lo) & (rank <= hi)
            acc += torch.where(keep, x[j].float(), 0.0)
            kcnt += keep
            rejected[j] += len(receivers) * (width - keep.sum())
        mean = acc.to(x.dtype) / torch.clamp(kcnt, min=1).to(x.dtype)
        for i in receivers:
            out[i] = torch.where(kcnt > 0, mean, x[i])
    return out


def _rank_scan_stats(a: torch.Tensor, tree: Any, t_server: int, rule,
                     block: int = RANK_SCREEN_BLOCK):
    """T_S rank-screened rounds: ``(tree, rejected)``, ``rejected[j]`` the
    (receiver, coordinate, round, leaf) count of server j's discarded
    values this period, float32 on the tree's device.  The support is read
    to the host once a period; each leaf is screened in column blocks of
    ``block``, all rounds on a block before the next (the reference's
    per-leaf round loop, reordered: columns screen independently)."""
    leaves, treedef = tree_flatten(tree)
    m = leaves[0].shape[0]
    device = leaves[0].device
    rejected = torch.zeros((m,), dtype=torch.int64, device=device)
    if t_server == 0:
        return tree, rejected.float()
    sup = _support(a.to(device)).cpu().numpy()
    out = []
    for leaf in leaves:
        flat = leaf.reshape(m, -1)
        res = torch.empty_like(flat)
        for lo in range(0, flat.shape[1], block):
            w = flat[:, lo:lo + block]
            for _ in range(t_server):
                w = _rank_keep_block(sup, w, rule, rejected)
            res[:, lo:lo + block] = w
        out.append(res.reshape(leaf.shape))
    return tree_unflatten(treedef, out), rejected.float()


def trimmed_mean_mix(a: torch.Tensor, tree: Any, f: int) -> Any:
    """One coordinatewise-trimmed-mean screening round: per receiver and
    coordinate, discard the ``f`` largest and ``f`` smallest supported
    values and average the rest (unweighted).  With ``f=0`` it is the plain
    masked neighbour mean, summed in source order."""
    return gossip_scan_trimmed(a, tree, 1, f)


def median_mix(a: torch.Tensor, tree: Any) -> Any:
    """One coordinatewise-median screening round (the mean of the two
    middle ranks when the neighbourhood is even)."""
    return gossip_scan_median(a, tree, 1)


def gossip_scan_trimmed(a: torch.Tensor, tree: Any, t_server: int,
                        f: int) -> Any:
    """T_S rounds of trimmed-mean screening."""
    return gossip_scan_trimmed_stats(a, tree, t_server, f)[0]


def gossip_scan_median(a: torch.Tensor, tree: Any, t_server: int) -> Any:
    """T_S rounds of coordinatewise-median screening."""
    return gossip_scan_median_stats(a, tree, t_server)[0]


def gossip_scan_trimmed_stats(a: torch.Tensor, tree: Any, t_server: int,
                              f: int):
    """``gossip_scan_trimmed`` plus the per-source screen-activity counts."""
    if f < 0:
        raise ValueError(f"trimmed mean needs f >= 0, got {f}")
    return _rank_scan_stats(a, tree, t_server, _trim_rule(f))


def gossip_scan_median_stats(a: torch.Tensor, tree: Any, t_server: int):
    """``gossip_scan_median`` plus the per-source screen-activity counts."""
    return _rank_scan_stats(a, tree, t_server, _median_rule)


def _clip_from_d2(a: torch.Tensor, d2: torch.Tensor, clip_mult: float):
    """The clipped effective matrix and its per-source counts from the
    (M, M) squared tree-wide distances (the reference's
    ``clip_weights_stats`` after its Gram loop)."""
    m = a.shape[0]
    off = _support(a) & ~torch.eye(m, dtype=torch.bool, device=a.device)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    masked = torch.where(off, dist, torch.full_like(dist, float("inf")))
    srt = torch.sort(masked, dim=1).values
    k = off.sum(dim=1)
    med = torch.gather(srt, 1, torch.clamp((k - 1) // 2, min=0)[:, None])[:, 0]
    tau = clip_mult * med                 # inf for an isolated receiver
    fac = torch.where(dist > 0.0,
                      torch.clamp(tau[:, None] / torch.clamp(dist, min=1e-30),
                                  max=1.0),
                      torch.ones_like(dist))
    c_off = torch.where(off, a.float() * fac, torch.zeros_like(fac))
    clipped = (off & (fac < 1.0)).sum(dim=0).float()          # per source
    return c_off + torch.diag(1.0 - c_off.sum(dim=1)), clipped


def _gram_d2(a: torch.Tensor, leaves) -> torch.Tensor:
    """Squared tree-wide distances ``||x_i - x_j||^2`` through the Gram
    identity, accumulated leaf by leaf in leaf order, in f32."""
    m = a.shape[0]
    d2 = torch.zeros((m, m), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        x = leaf.reshape(m, -1).float()
        g = x @ x.T
        sq = torch.diagonal(g)
        d2 = d2 + (sq[:, None] + sq[None, :] - 2.0 * g)
    return d2


def clip_weights_stats(a: torch.Tensor, tree: Any, clip_mult: float = 1.0):
    """Self-centred clipping as an effective per-round mixing matrix, and
    ``clipped[j]``, how many receivers clipped sender j's innovation.

    Receiver ``i`` clips every neighbour's innovation against its own
    model: the off-diagonal weight becomes ``a[i,j] * min(1, tau_i /
    ||x_j - x_i||)`` and the clipped mass returns to the self-loop.
    ``tau_i`` is ``clip_mult`` times the median tree-wide distance from i
    to its neighbours.  Distances come from the Gram identity, one (M, M)
    product a leaf (``torch.matmul``, as the reference's ``@``)."""
    a = a.to(device=tree_leaves(tree)[0].device, dtype=torch.float32)
    return _clip_from_d2(a, _gram_d2(a, tree_leaves(tree)), clip_mult)


def clip_weights(a: torch.Tensor, tree: Any,
                 clip_mult: float = 1.0) -> torch.Tensor:
    """``clip_weights_stats`` without the counts."""
    return clip_weights_stats(a, tree, clip_mult)[0]


def clipped_mix(a: torch.Tensor, tree: Any, clip_mult: float = 1.0) -> Any:
    """One clipped-gossip round: the effective matrix, then the weighted
    round with it (kernel 1 on the card)."""
    return kops.consensus_mix_pytree(clip_weights(a, tree, clip_mult), tree,
                                     rounds=1)


def gossip_scan_clipped_stats(a: torch.Tensor, tree: Any, t_server: int,
                              clip_mult: float = 1.0):
    """T_S rounds of clipped gossip and the per-source counts of links whose
    clip factor bit (``fac < 1``), summed over rounds and receivers.

    The effective matrix depends on the whole tree's current state, so the
    rounds cannot run per leaf.  A tree of one dtype is flattened once to
    (M, D): each round builds ``C`` from the Gram products of the leaves'
    column ranges and runs ``W <- C W`` as one ``ops.consensus_mix`` (one
    kernel-1 launch on the card, ``C`` in f32), ping-ponging two buffers.
    A tree of mixed dtypes mixes leaf by leaf with the round's ``C``."""
    leaves, treedef = tree_flatten(tree)
    m = leaves[0].shape[0]
    a = a.to(device=leaves[0].device, dtype=torch.float32)
    clipped = torch.zeros((m,), dtype=torch.float32, device=a.device)
    if t_server == 0:
        return tree, clipped
    if not kops.one_dtype(leaves, "clipped gossip"):
        for _ in range(t_server):
            c, hit = clip_weights_stats(a, tree, clip_mult)
            tree = kops.consensus_mix_pytree(c, tree, rounds=1)
            clipped = clipped + hit
        return tree, clipped
    flat, split = _flatten(tree)
    spans, off = [], 0
    for leaf in leaves:
        spans.append((off, off + leaf[0].numel()))
        off += leaf[0].numel()
    src, dst = flat, torch.empty_like(flat)
    for _ in range(t_server):
        d2 = _gram_d2(a, [src[:, lo:hi] for lo, hi in spans])
        c, hit = _clip_from_d2(a, d2, clip_mult)
        kops.consensus_mix(c, src, out=dst)
        src, dst = dst, src
        clipped = clipped + hit
    return split(src), clipped


def gossip_scan_clipped(a: torch.Tensor, tree: Any, t_server: int,
                        clip_mult: float = 1.0) -> Any:
    """T_S rounds of clipped gossip."""
    return gossip_scan_clipped_stats(a, tree, t_server, clip_mult)[0]


class TrimmedMeanBackend(ConsensusBackend):
    """Coordinatewise trimmed-mean gossip (``gossip_scan_trimmed``).

    Construction fails when the static graph is past the breakdown point
    (some supported neighbourhood, self included, has ``c <= 2f`` values).
    ``f == 0`` requests no screening, so the backend runs the exact
    weighted schedule, ``GossipBackend``'s own (kernel 1 every round):
    bitwise the unprotected ``'gossip'`` backend."""

    name = "trimmed_mean"
    supports_directed = False
    robust = True

    def __init__(self, a_static, t_server, *, f: int = 1):
        super().__init__(a_static, t_server)
        if f < 0:
            raise ValueError(f"trimmed mean needs f >= 0, got {f}")
        self.f = f
        if a_static is not None and f > 0:
            a = np.asarray(a_static)
            cnt = int(((a > 0) | np.eye(a.shape[0], dtype=bool))
                      .sum(axis=1).min())
            if cnt <= 2 * f:
                raise ValueError(
                    f"trimmed_mean with f={f} is past its breakdown point "
                    f"on this graph: a server has only {cnt} supported "
                    f"values (self included) but the screen discards "
                    f"2f={2 * f} per coordinate and needs > 2f survivors' "
                    f"worth of margin; lower f or densify the graph")

    def _mix(self, tree, a):
        return self.mix_stats(tree, a)[0]

    def mix_stats(self, tree, a_p=None, lam2=None):
        a = self._resolve(a_p)
        if self.f == 0:
            # no screening requested: the exact weighted schedule, with
            # identically zero counts
            return (kops.consensus_mix_pytree(a, tree, rounds=self.t_server),
                    _zero_counts(a, tree))
        return gossip_scan_trimmed_stats(a, tree, self.t_server, self.f)

    def first_round(self, a_p, m, lam2=None, transpose=False):
        if self.f == 0:
            return _first_of_rounds(self._resolve(a_p), self.t_server, None,
                                    transpose)
        return _screen_first_round(self, a_p, m)


class MedianBackend(ConsensusBackend):
    """Coordinatewise-median gossip (``gossip_scan_median``): tolerates any
    minority of attackers per neighbourhood (breakdown point f < c/2)."""

    name = "median"
    supports_directed = False
    robust = True

    def _mix(self, tree, a):
        return gossip_scan_median(a, tree, self.t_server)

    def mix_stats(self, tree, a_p=None, lam2=None):
        return gossip_scan_median_stats(self._resolve(a_p), tree,
                                        self.t_server)

    def first_round(self, a_p, m, lam2=None, transpose=False):
        return _screen_first_round(self, a_p, m)


class ClippedGossipBackend(ConsensusBackend):
    """Clipped gossip (``gossip_scan_clipped``): neighbour innovations
    norm-clipped against the receiver's own model through the effective
    matrix ``clip_weights``, so each round is the weighted round (kernel 1
    on the card) and an agreed tree is a fixed point (``C == A``)."""

    name = "clipped"
    supports_directed = False
    robust = True

    def __init__(self, a_static, t_server, *, clip_mult: float = 1.0):
        super().__init__(a_static, t_server)
        if not clip_mult > 0.0:
            raise ValueError(f"clipped needs clip_mult > 0, got {clip_mult}")
        self.clip_mult = clip_mult

    def _mix(self, tree, a):
        return gossip_scan_clipped(a, tree, self.t_server,
                                   clip_mult=self.clip_mult)

    def mix_stats(self, tree, a_p=None, lam2=None):
        return gossip_scan_clipped_stats(self._resolve(a_p), tree,
                                         self.t_server,
                                         clip_mult=self.clip_mult)

    def first_round(self, a_p, m, lam2=None, transpose=False):
        return _screen_first_round(self, a_p, m)


def _zero_counts(a: torch.Tensor, tree: Any) -> torch.Tensor:
    return torch.zeros((a.shape[0],), dtype=torch.float32,
                       device=tree_leaves(tree)[0].device)


def _screen_first_round(backend: ConsensusBackend, a_p, m: int):
    """A screen has no first operator to fuse: the simulated wire's kernel-4
    pass decodes on ``A = I`` (exact) and the screen runs the whole
    period."""
    return torch.eye(m), lambda tree: backend.mix(tree, a_p)


class ShardMapBackend(ConsensusBackend):
    """The multi-process wire's backend (the reference's ``ShardMapBackend``):
    the plain ``make_gossip_shard_map`` program over a
    ``launch.mesh.RankMesh`` with ``leaf_specs`` (each rank holding its piece
    of its server's row) or a bare ``torch.distributed`` group of M ranks
    (rank r holding server r), with the mixing matrix an operand (a
    per-epoch ``A_p`` overrides the static one).  ``rows`` are the server
    rows this rank holds (a piece of), so the epoch step runs rank-locally
    (``dfl.build_dfl_epoch_step``; on a server row sharded over further
    axes, ``sharded``, with ``batch_spec`` its share of the batch); being
    bound to the mesh's size it cannot survive fault surgery that changes
    M (``mesh_bound``).  Push-sum mixes
    the numerator with A' through the same program and the ``(M,)``
    weight, replicated on every rank, identically on each.  ``wire_runner``
    builds the bucketed wire programs (``CompressedBackend(wire=
    "physical")``)."""

    name = "shard_map"
    mesh_bound = True

    def __init__(self, mesh, a_static, t_server, leaf_specs: Any = None, *,
                 axis_name: str = "server", counted=None,
                 block: int = 16_777_216, staleness: int = 0,
                 batch_spec=None):
        super().__init__(a_static, t_server)
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        #: the mesh or bare group as given, and its server axis
        self.mesh, self.axis_name = mesh, axis_name
        self.leaf_specs = leaf_specs
        #: per leaf, whether this rank's piece enters a federation-wide sum
        #: (its first copy, ``launch.sharding.first_copy``); needed only
        #: when a server's row spans several ranks
        self.counted = None if counted is None else list(counted)
        self.block = block
        self.staleness = staleness
        self._run = make_gossip_shard_map(mesh, t_server, leaf_specs,
                                          axis_name=axis_name, block=block)
        view = self.view = self._run.view
        self.num_servers, self.rank = view.m, view.idx
        #: the server group each round crosses, and whether a server's row
        #: spans several ranks (its pieces over the other axes)
        self.group = view.group
        self.sharded = view.n_other > 1
        if self.a_static is not None and \
                self.a_static.shape[0] != self.num_servers:
            raise ValueError(
                f"the shard_map backend runs one server a rank along the "
                f"server axis: a {self.a_static.shape[0]}-server mixing "
                f"matrix on {self.num_servers} servers")
        #: the federation rows this rank holds (a piece of), [lo, hi)
        self.rows = (view.idx, view.idx + 1)
        #: on a mesh, the spec of the epoch's (T_C, M, N, b, ...) draw
        #: (``launch.sharding.fl_batch_spec``): which share of its clients'
        #: batches this rank trains on
        self.batch_spec = batch_spec
        self._wire_runners: Dict[tuple, _ShardWire] = {}

    def disagreement(self, server_tree: Any) -> torch.Tensor:
        """``disagreement_over`` the federation from this rank's rows or
        pieces: a piece's column sums cross the server group, and each
        piece's terms (its first copy's, its sums counted once) cross the
        whole mesh in one reduction."""
        if not self.sharded:
            return disagreement_over(server_tree, self.group,
                                     self.num_servers)
        if self.counted is None:
            raise ValueError(
                "a server row sharded over ranks sums each piece once: "
                "build the backend with counted= (each leaf's first copy, "
                "launch.sharding.first_copy; fl_consensus_backend does)")
        m = self.num_servers
        leaves = tree_leaves(server_tree)
        parts = torch.zeros((2, len(leaves)), dtype=torch.float32,
                            device=leaves[0].device)
        for i, (leaf, keep) in enumerate(zip(leaves, self.counted)):
            col = leaf.sum(dim=0, dtype=torch.float32)
            all_reduce_(col, self.group, site="metrics")
            if keep:
                parts[0, i] = torch.sum(torch.square(leaf),
                                        dtype=torch.float32)
                if self.rank == 0:
                    parts[1, i] = m * torch.sum(torch.square(col / m))
        all_reduce_(parts, self.view.world, site="metrics")
        return torch.sqrt(torch.clamp((parts[0] - parts[1]).sum(), min=0.0))

    def _mix(self, tree, a):
        if self.staleness:
            raise ValueError(
                "shard_map bounded staleness rides the delta-coded wire "
                "only (make_gossip_shard_map refuses codec=None): wrap "
                "with a physical-wire CompressedBackend or use staleness=0")
        return self._run(a, tree)

    def wire_runner(self, codec, *, stochastic: bool = True,
                    gather_codes: bool = True,
                    with_shipped: bool = False) -> "_ShardWire":
        """The physical-wire twin of this backend's program (same group and
        block, the codec's codes on the wire), built on demand and cached
        per mode; the backend's ``staleness`` threads through."""
        k = (codec, bool(stochastic), bool(gather_codes),
             bool(with_shipped), self.staleness)
        if k not in self._wire_runners:
            self._wire_runners[k] = make_gossip_shard_map(
                self.mesh, self.t_server, self.leaf_specs,
                axis_name=self.axis_name, block=self.block, codec=codec,
                stochastic=stochastic, gather_codes=gather_codes,
                with_shipped=with_shipped, staleness=self.staleness)
        return self._wire_runners[k]

    def first_round(self, a_p, m, lam2=None, transpose=False):
        # the simulated wire decodes the rank's own message on A = I
        # (kernel 4, exact) and the whole period then crosses the group
        a = self._resolve(a_p)
        rest = ((lambda tree: self._mix(tree, _transpose(a))) if transpose
                else (lambda tree: self._mix(tree, a)))
        return torch.eye(m), rest


def _ef_residual_into(res: torch.Tensor, flat: torch.Tensor,
                      codes: torch.Tensor, scales: torch.Tensor, lo: int,
                      chunk: int, step: int = 1 << 22) -> None:
    """``res <- flat - codes * scales`` over bucket columns [lo, lo + n),
    with one rounding (``fma(-q, s, x)``), in column blocks of ``step``."""
    n = res.shape[1]
    for a0 in range(0, n, step):
        a1 = min(n, a0 + step)
        cols = torch.arange(lo + a0, lo + a1, device=flat.device)
        res[:, a0:a1] = fma(-codes[:, lo + a0:lo + a1].float(),
                            scales[:, cols // chunk],
                            flat[:, lo + a0:lo + a1])


class CompressedBackend(ConsensusBackend):
    """The compression layer around a gossip backend (the reference's
    ``CompressedBackend``).

    ``wire="simulated"`` (default): each server's message is compressed once
    a period and the inner backend mixes the decoded messages (routes in the
    module docstring); with error feedback the residual is ``corrected -
    D(C(corrected))`` (``comm.error_feedback.ef_roundtrip``).  With the
    identity compressor every output is exactly the inner backend's.

    ``wire="physical"``: the codes are what every round ships
    (``gossip_scan_wire_bucketed``, the whole tree as one bucket, one code
    and one scale buffer per server and round).  Only the int8/int4
    quantizers define a wire byte format, and only the literal T_S-round
    schedules (gossip, gossip_blocked, shard_map) have a per-round wire;
    around a ``ShardMapBackend`` the rounds run its ``wire_runner``
    program, each rank on its own rows (the simulated wire round-trips the
    rank's own message, then runs the plain program).  Error feedback
    tracks the round-0 transmission of each server's own model:
    the residual is ``corrected - D(round-0 codes)``, computed from the
    period's own round-0 codes and scales (``bucketed_roundtrip_tree``
    would encode the same input with the same dither again), with the
    subtraction and the decode's product in one rounding, as the
    reference's jitted program rounds it."""

    compressed = True

    def __init__(self, inner: ConsensusBackend, compressor, *,
                 error_feedback: bool = True, wire: str = "simulated",
                 wire_block: Optional[int] = None):
        if getattr(inner, "compressed", False):
            raise ValueError("refusing to wrap an already-compressed "
                             "backend: double compression double-counts "
                             "wire bytes and compounds loss")
        if wire not in ("simulated", "physical"):
            raise ValueError(f"wire must be 'simulated' or 'physical', "
                             f"got {wire!r}")
        if wire == "physical":
            if getattr(inner, "robust", False):
                raise ValueError(
                    f"wire='physical' ships quantized codes, but the robust "
                    f"screening backend {inner.name!r} must rank/clip every "
                    f"neighbor's plaintext values before mixing")
            if not isinstance(compressor, _compressors.StochasticQuantizer):
                raise ValueError(
                    "wire='physical' ships quantized codes through the "
                    "collectives; only the int8/int4 quantizers define a "
                    "wire byte format")
            if inner.name not in ("gossip", "gossip_blocked", "shard_map"):
                raise ValueError(
                    f"wire='physical' re-quantizes at every gossip hop, so "
                    f"it needs the literal T_S-round W <- A W schedule; "
                    f"backend {inner.name!r} has no per-round wire — use "
                    f"'gossip', 'gossip_blocked' or the shard_map backend")
        if getattr(inner, "staleness", 0) and wire != "physical":
            raise ValueError(
                "bounded staleness + wire='simulated' is incoherent: the "
                "simulated wire quantizes ONCE per period (no per-round "
                "in-flight buffers exist to be late) — use wire='physical' "
                "or staleness=0")
        super().__init__(None, inner.t_server)
        self.inner = inner
        self.compressor = compressor
        self.error_feedback = error_feedback
        self.wire = wire
        self.wire_block = (getattr(inner, "block", None) or wire_block
                           or DEFAULT_GOSSIP_BLOCK)
        self.a_static = inner.a_static
        self.staleness = getattr(inner, "staleness", 0)
        self.name = f"compressed[{inner.name}+{compressor.name}" + (
            "+wire" if wire == "physical" else "") + "]"
        self.supports_directed = inner.supports_directed
        self.needs_spectral = inner.needs_spectral
        self.mesh_bound = inner.mesh_bound
        if wire == "simulated" and getattr(inner, "sharded", False):
            raise ValueError(
                "the simulated wire round-trips each server's whole leaves "
                "(their chunks and dither span the full row); a server row "
                "sharded over ranks rides wire='physical', whose bucket is "
                "the rank's own pieces")
        # the federation row of the trees' first row (a rank's own rows)
        self._row0 = getattr(inner, "rows", (0, 0))[0]

    def _mix_simulated(self, tree: Any, a_p: Optional[torch.Tensor], *,
                       residual: Optional[Any], key, lam2=None,
                       push_sum: bool = False):
        """One simulated-wire period: ``(mixed tree, new EF residual)``;
        with ``push_sum`` the inner backend's numerator period (``P =
        A'``)."""
        codec = self.compressor

        def period(msg):
            if push_sum:
                return self.inner.mix_numerator(msg, a_p)
            return self.inner.mix(msg, a_p, lam2=lam2)

        row0 = self._row0
        if residual is not None and self.error_feedback:
            msg, residual = ef_roundtrip(codec, tree, residual, key,
                                         row0=row0)
            return period(msg), residual
        leaves, treedef = tree_flatten(tree)
        if not isinstance(codec, _compressors.StochasticQuantizer) or any(
                leaf.dtype != torch.float32 for leaf in leaves):
            # the reference rounds a bf16 message to bf16 before it mixes
            # it, so only an f32 tree fuses the first operator
            msg = _compressors.roundtrip_tree(codec, tree, key, row0=row0)
            return period(msg), residual
        # the round trip and the first operator in one pass of kernel 4
        first, rest = self.inner.first_round(a_p, leaves[0].shape[0],
                                             lam2=lam2, transpose=push_sum)
        mixed = [codec.mix(leaf, None if key is None else prng.fold_in(key, i),
                           first, row0=row0) for i, leaf in enumerate(leaves)]
        return rest(tree_unflatten(treedef, mixed)), residual

    def mix_compressed(self, tree: Any, a_p: Optional[torch.Tensor] = None,
                       *, residual: Optional[Any] = None, key=None,
                       lam2=None):
        """One compressed period: ``(mixed tree, new EF residual)``.
        ``key`` is the period's threefry key data (``None``: deterministic
        rounding).  On the physical wire, with error feedback the residual
        is folded into the message first and the new residual is written
        into ``residual``'s own buffers (consumed like a donated argument);
        the mixed leaves are views of one (M, D_pad) buffer."""
        if self.wire == "simulated":
            return self._mix_simulated(tree, a_p, residual=residual, key=key,
                                       lam2=lam2)
        a = self._resolve(a_p)
        codec = self.compressor
        leaves, treedef = _wire_leaves(tree)
        dtype = leaves[0].dtype
        _, d_pad = _bucket_layout(leaves, self.wire_block, codec.chunk)
        ef = residual is not None and self.error_feedback
        shipped = None
        if ef and all(leaf.dtype == torch.float32 for leaf in leaves):
            # f32: fold the residual into the bucket in place
            flat = _bucket_flat(leaves, d_pad)
            res_leaves = tree_flatten(residual)[0]
            m, off, spans = flat.shape[0], 0, []
            for leaf in res_leaves:
                size = leaf[0].numel()
                flat[:, off:off + size] += leaf.reshape(m, size)
                spans.append((leaf.view(m, size), off))
                off += size

            def shipped(codes, scales):
                for res, lo in spans:
                    _ef_residual_into(res, flat, codes, scales, lo,
                                      codec.chunk)
        elif ef:
            # other dtypes: the correction x + e in the leaf's dtype, and
            # the residual c - q with q the decode rounded to it, as the
            # reference computes them leaf by leaf
            res_leaves = tree_flatten(residual)[0]
            corrected = [x + e.to(x.dtype) for x, e in zip(leaves,
                                                            res_leaves)]
            flat = _bucket_flat(corrected, d_pad)

            def shipped(codes, scales):
                m, off = flat.shape[0], 0
                sent = (codes.reshape(m, -1, codec.chunk).float()
                        * scales[..., None]).reshape(m, -1)
                for res, c in zip(res_leaves, corrected):
                    size = c[0].numel()
                    q = sent[:, off:off + size].reshape(c.shape).to(c.dtype)
                    res.copy_(c - q)
                    off += size
        else:
            flat = _bucket_flat(leaves, d_pad)
        if isinstance(self.inner, ShardMapBackend):
            run = self.inner.wire_runner(codec, stochastic=key is not None,
                                         with_shipped=ef)
            out = run.period(a, flat, key, shipped=shipped, dtype=dtype)
        else:
            out = _bucketed_period(a, flat, self.t_server, codec, key,
                                   self.staleness, shipped=shipped,
                                   dtype=dtype)
        return _bucket_split(out, leaves, treedef, via=dtype), residual

    def mix_push_sum_compressed(self, state: PushSumState,
                                a_p: Optional[torch.Tensor] = None, *,
                                residual: Optional[Any] = None, key=None):
        """One compressed push-sum period: ``(PushSumState, new EF
        residual)``.  The numerator rides the wire — on the simulated wire
        the inner backend's numerator period of the decoded messages (kernel
        4 fusing the round trip with ``P``), on the physical wire the codes
        of every round under ``P`` — and the ``(M,)`` weight recursion stays
        exact."""
        if not self.supports_directed:
            raise ValueError(f"consensus backend {self.name!r} has no "
                             f"ratio-consensus analogue")
        if self.wire == "physical":
            values, residual = self.mix_compressed(
                state.values, _transpose(self._resolve(a_p)),
                residual=residual, key=key)
        else:
            values, residual = self._mix_simulated(
                state.values, a_p, residual=residual, key=key,
                push_sum=True)
        return PushSumState(values, self.inner.push_weight(state.weight,
                                                           a_p)), residual

    def mix(self, tree, a_p=None, lam2=None):
        return self.mix_compressed(tree, a_p, lam2=lam2)[0]

    def mix_push_sum(self, state, a_p=None):
        return self.mix_push_sum_compressed(state, a_p)[0]


def make_backend(mode: str, a_static: Optional[np.ndarray], t_server: int, *,
                 chebyshev_rounds: Optional[int] = None,
                 block: int = DEFAULT_GOSSIP_BLOCK,
                 compression: str = "none",
                 error_feedback: bool = False,
                 wire: str = "simulated",
                 staleness: int = 0) -> Optional[ConsensusBackend]:
    """Map a ``DFLConfig.consensus_mode`` string to a backend (``None`` for
    ``"none"``: no inter-server communication).  The robust screens take an
    optional argument after a colon: ``"trimmed_mean[:f]"`` (default f=1)
    and ``"clipped[:mult]"`` (default 1.0); ``"median"`` takes none.
    ``compression`` other than ``"none"`` wraps the backend in a
    ``CompressedBackend`` on the ``wire`` given.  ``staleness`` needs the
    literal T_S-round schedules (gossip, gossip_blocked):
    ``gossip_scan_stale`` without compression, the pipelined codes on the
    physical wire."""
    base, _, arg = mode.partition(":")
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if staleness and base not in ("gossip", "gossip_blocked"):
        raise ValueError(
            f"bounded staleness needs the literal T_S-round W <- A W "
            f"schedule (round t consumes round t-s's messages); mode "
            f"{mode!r} has no per-round message stream to delay — use "
            f"'gossip'/'gossip_blocked' or staleness=0")
    if mode == "none":
        return None
    if mode == "gossip":
        backend = GossipBackend(a_static, t_server, staleness=staleness)
    elif mode == "gossip_blocked":
        backend = BlockedGossipBackend(a_static, t_server, block=block,
                                       staleness=staleness)
    elif mode == "collapsed":
        backend = CollapsedBackend(a_static, t_server)
    elif mode == "chebyshev":
        backend = ChebyshevBackend(a_static, t_server,
                                   rounds=chebyshev_rounds)
    elif mode == "exact_mean":
        backend = ExactMeanBackend(a_static, t_server)
    elif base == "trimmed_mean":
        if arg and not arg.isdigit():
            raise ValueError(f"bad trimmed_mean spec {mode!r}: expected "
                             f"'trimmed_mean[:f]' with integer f >= 0")
        backend = TrimmedMeanBackend(a_static, t_server,
                                     f=int(arg) if arg else 1)
    elif base == "median":
        if arg:
            raise ValueError(f"bad median spec {mode!r}: the coordinatewise "
                             f"median takes no parameter")
        backend = MedianBackend(a_static, t_server)
    elif base == "clipped":
        try:
            clip_mult = float(arg) if arg else 1.0
        except ValueError:
            raise ValueError(f"bad clipped spec {mode!r}: expected "
                             f"'clipped[:mult]' with float mult > 0")
        backend = ClippedGossipBackend(a_static, t_server,
                                       clip_mult=clip_mult)
    else:
        raise ValueError(f"unknown consensus mode {mode!r}")
    if compression != "none":
        backend = CompressedBackend(
            backend, _compressors.make_compressor(compression),
            error_feedback=error_feedback, wire=wire, wire_block=block)
    return backend
