"""Public kernel entry points of the port, dispatched by tensor device.

For a CPU tensor each op runs its plain PyTorch version
(``repro_torch.kernels.ref``); for a CUDA tensor it launches its Hopper
kernel or raises — there is no path from a CUDA tensor to the plain
version.  Port of ``repro.kernels.ops.consensus_mix_pytree``,
``repro.kernels.ops.rmsnorm``, ``repro.kernels.ops.flash_attention`` and
``repro.kernels.ops.ssd_scan``, plus entry points for the simulated wire's
kernel 4 and the physical wire's kernels (the reference's wire paths call
jnp code; the port's call these on every period and round), and the row
forms of kernels 1, 7 and 8 that a rank of the multi-process wire runs on
its own rows of a gathered round.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import consensus_mix as _cm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.tree import tree_flatten, tree_unflatten


def reset_launch_counts() -> None:
    _cm.launches = 0
    _fa.launches = 0
    _fa.mode_launches.clear()
    _rn.fwd_launches = 0
    _rn.bwd_launches = 0
    _ssd.launches = 0
    _cm.quant_mix_launches = 0
    _cm.pipelined_instances.clear()
    for counts in (_cm.wire_launches, _cm.row_launches):
        for name in counts:
            counts[name] = 0


def launch_counts() -> Dict[str, int]:
    return {"consensus_mix": _cm.launches, "flash_attention": _fa.launches,
            "rmsnorm_fwd": _rn.fwd_launches, "rmsnorm_bwd": _rn.bwd_launches,
            "ssd_scan": _ssd.launches,
            "quantized_consensus_mix": _cm.quant_mix_launches,
            **_cm.wire_launches, **_cm.row_launches}


def flash_attention_mode_counts() -> Dict[str, int]:
    """Kernel 3's launches since the last ``reset_launch_counts()`` by mode
    (``flash_attention.mode_key``); they sum to its ``launch_counts()``."""
    return dict(_fa.mode_launches)


def wire_pipelined_instance_counts() -> Dict[str, int]:
    """Kernel 8's launches (square and row form) since the last
    ``reset_launch_counts()`` by the instance each took
    (``consensus_mix.pipelined_instances``); they sum to its two
    ``launch_counts()`` entries."""
    return dict(_cm.pipelined_instances)


# ---------------------------------------------------------------------------
# consensus mixing
# ---------------------------------------------------------------------------


def consensus_mix(a: torch.Tensor, w: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A @ W`` for W (M, D), f32 or bf16 (an f32 sum, W's dtype out): the
    CUDA kernel on the card (into ``out``, which must not overlap ``w``),
    the plain version on the CPU."""
    if w.is_cuda:
        if out is None:
            out = torch.empty_like(w)
        return _cm.consensus_mix_cuda(_a32(a, w), w, out)
    res = _ref.consensus_mix_ref(a, w)
    if out is None:
        return res
    return out.copy_(res)


def consensus_mix_rows(a: torch.Tensor, w: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 1's row form, ``A_rows @ W`` for A_rows (M_out, M) and W (M,
    D) (f32 or bf16, an f32 sum, W's dtype out): what one rank of the
    multi-process wire keeps of a gathered round.  The CUDA kernel on the
    card (into ``out``, which must not overlap ``w``), the plain version on
    the CPU."""
    if w.is_cuda:
        if out is None:
            out = torch.empty((a.shape[0], w.shape[1]), dtype=w.dtype,
                              device=w.device)
        return _cm.consensus_mix_rows_cuda(_a32(a, w), w, out)
    res = _ref.consensus_mix_ref(a, w)
    return res if out is None else out.copy_(res)


#: the leaf dtypes the consensus kernels take (kernel 1 has an instance of
#: each; the wires carry bf16 in f32, exactly)
MIX_DTYPES = (torch.float32, torch.bfloat16)


def one_dtype(leaves, what: str = "consensus_mix_pytree") -> bool:
    """Whether every leaf has the first leaf's dtype: such a tree mixes as
    one flattened (M, D) slab of that dtype; a tree of mixed dtypes mixes
    leaf by leaf, each in its own dtype, as the reference's ``_mix_leaf``
    does.  Leaves of other dtypes than f32 and bf16 raise."""
    for leaf in leaves:
        if leaf.dtype not in MIX_DTYPES:
            raise TypeError(f"{what} takes float32 or bfloat16 leaves, got "
                            f"{leaf.dtype}")
    return all(leaf.dtype == leaves[0].dtype for leaf in leaves)


def consensus_mix_pytree(a: torch.Tensor, tree: Any, rounds: int = 1,
                         block: Optional[int] = None) -> Any:
    """``rounds`` rounds of ``W <- A W`` over every leaf (leading server axis
    M), through ONE flattened ``(M, D)`` matrix in the leaves' dtype (f32
    or bf16 on the card): the leaves are concatenated once, the rounds
    ping-pong between two (M, D) buffers, and the result is split back into
    views of the final buffer.  ``block`` streams the rounds over column
    blocks of that width (block-major, round-minor — the same operator,
    since columns mix independently).  Each round sums in f32 and rounds
    once to the leaves' dtype.  A tree of mixed dtypes runs leaf by leaf."""
    leaves, treedef = tree_flatten(tree)
    if not leaves or rounds == 0:
        return tree
    if not one_dtype(leaves):
        return tree_unflatten(treedef, [
            consensus_mix_pytree(a, leaf, rounds, block) for leaf in leaves])
    m = leaves[0].shape[0]
    sizes = [leaf[0].numel() for leaf in leaves]
    flat = torch.cat([leaf.reshape(m, -1) for leaf in leaves], dim=1)
    d = flat.shape[1]
    other = torch.empty_like(flat)
    a = _a32(a, flat)
    step = d if block is None else block
    for lo in range(0, d, max(step, 1)):
        hi = min(d, lo + step)
        src, dst = flat[:, lo:hi], other[:, lo:hi]
        for _ in range(rounds):
            consensus_mix(a, src, out=dst)
            src, dst = dst, src
    # every block ran the same number of rounds, so all end in one buffer
    result = other if rounds % 2 else flat
    out, off = [], 0
    for leaf, size in zip(leaves, sizes):
        out.append(result[:, off:off + size].reshape(leaf.shape))
        off += size
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# the simulated wire (kernel 4)
# ---------------------------------------------------------------------------


def quantized_consensus_mix(a: torch.Tensor, w: torch.Tensor,
                            dither: torch.Tensor, *, bits: int = 8,
                            chunk: int = 256,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Kernel 4: ``A · D(C(w; dither))`` for (M, D) f32 ``w`` and dither in
    [0, 1), ``chunk`` dividing D: the CUDA kernel on the card, the plain
    version on the CPU.  ``out`` (default: a new tensor) may be ``w`` or
    ``dither`` itself.  Other bits, dtypes or a chunk that does not divide
    D raise, as the TPU kernel refuses them."""
    for name, t in (("w", w), ("dither", dither)):
        if t.dtype != torch.float32:
            raise TypeError(f"quantized_consensus_mix takes float32 only; "
                            f"{name} is {t.dtype}")
    if w.is_cuda:
        if out is None:
            out = torch.empty_like(w)
        return _cm.quantized_consensus_mix_cuda(
            _a32(a, w), w, dither, out, bits=bits, chunk=chunk)
    res = _ref.quantized_consensus_mix_ref(a, w, dither, bits=bits,
                                           chunk=chunk)
    return res if out is None else out.copy_(res)


# ---------------------------------------------------------------------------
# the physical wire (kernels 5-8): codes (M, D) int8 (int4 values unpacked),
# scales (M, D/chunk) f32, every other operand (M, D) f32
#
# On both devices each entry point updates its state operands (codes,
# scales, ref, acc) in place and writes its product into the buffers it is
# given (the encode's codes and scales, the per-leaf round's ``mixed``), so
# a gossip period allocates nothing per round.  A caller that needs an input
# afterwards passes a clone.
# ---------------------------------------------------------------------------


def _a32(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return a.to(device=like.device, dtype=torch.float32).contiguous()


def _store(dests, results):
    for dst, res in zip(dests, results):
        if dst is not res:
            dst.copy_(res)
    return dests


def quantized_gossip_encode(w, ref, dither, codes, scales, *, bits: int = 8,
                            chunk: int = 256):
    """Kernel 6: ``codes, scales <- C(w - ref; dither)`` -> ``(codes,
    scales)``."""
    if w.is_cuda:
        return _cm.quantized_gossip_encode_cuda(w, ref, dither, codes, scales,
                                                bits=bits, chunk=chunk)
    return _store((codes, scales), _ref.quantized_gossip_encode_ref(
        w, ref, dither, bits=bits, chunk=chunk))


def bucketed_gossip_round(a, codes, scales, ref, acc, dither, *,
                          bits: int = 8, chunk: int = 256):
    """Kernel 7: one bucketed wire round, in place -> ``(acc, ref, codes,
    scales)``."""
    if codes.is_cuda:
        return _cm.bucketed_gossip_round_cuda(
            _a32(a, codes), codes, scales, ref, acc, dither,
            bits=bits, chunk=chunk)
    return _store((acc, ref, codes, scales), _ref.bucketed_gossip_round_ref(
        a, codes, scales, ref, acc, dither, bits=bits, chunk=chunk))


def bucketed_gossip_round_pipelined(a, codes, scales, w, ref, acc, dither, *,
                                    bits: int = 8, chunk: int = 256):
    """Kernel 8: one bounded-staleness wire round over the DELAYED
    ``(codes, scales)``, in place (they leave holding this round's shipped
    codes) -> ``(acc, ref, codes, scales)``; ``acc`` may be ``w`` itself."""
    if codes.is_cuda:
        return _cm.bucketed_gossip_round_pipelined_cuda(
            _a32(a, codes), codes, scales, w, ref, acc, dither,
            bits=bits, chunk=chunk)
    return _store((acc, ref, codes, scales),
                  _ref.bucketed_gossip_round_pipelined_ref(
                      a, codes, scales, w, ref, acc, dither, bits=bits,
                      chunk=chunk))


def bucketed_gossip_round_rows(a, codes, scales, ref, acc, dither, codes_out,
                               scales_out, *, row0: int, bits: int = 8,
                               chunk: int = 256):
    """Kernel 7's row form: A's own rows ``a`` (M_out, M), the gathered
    ``codes``/``scales`` of all M rows (read only), the own ``ref``, ``acc``
    (in place) and ``dither``; the next codes and scales into ``codes_out``
    / ``scales_out`` -> ``(acc, ref, codes_out, scales_out)``."""
    if codes.is_cuda:
        return _cm.bucketed_gossip_round_rows_cuda(
            _a32(a, codes), codes, scales, ref, acc, dither, codes_out,
            scales_out, row0=row0, bits=bits, chunk=chunk)
    return _store((acc, ref, codes_out, scales_out),
                  _ref.bucketed_gossip_round_rows_ref(
                      a, codes, scales, ref, acc, dither, row0=row0,
                      bits=bits, chunk=chunk))


def bucketed_gossip_round_pipelined_rows(a, codes, scales, w, ref, acc,
                                         dither, codes_out, scales_out, *,
                                         bits: int = 8, chunk: int = 256):
    """Kernel 8's row form: the DELAYED gathered ``codes``/``scales`` of
    all M rows (read only), A's own rows, the own ``w``, ``ref``, ``acc``
    (``acc`` may be ``w``) and ``dither``; this round's codes and scales
    into ``codes_out`` / ``scales_out`` -> ``(acc, ref, codes_out,
    scales_out)``."""
    if codes.is_cuda:
        return _cm.bucketed_gossip_round_pipelined_rows_cuda(
            _a32(a, codes), codes, scales, w, ref, acc, dither, codes_out,
            scales_out, bits=bits, chunk=chunk)
    return _store((acc, ref, codes_out, scales_out),
                  _ref.bucketed_gossip_round_pipelined_ref(
                      a, codes, scales, w, ref, acc, dither, bits=bits,
                      chunk=chunk))


def quantized_gossip_round(a, codes, scales, ref, mixed, dither, *,
                           bits: int = 8, chunk: int = 256):
    """Kernel 5: one per-leaf wire round, in place on ``codes``, ``scales``
    and ``ref``, the mixed iterates into ``mixed`` -> ``(mixed, ref, codes,
    scales)``."""
    if codes.is_cuda:
        return _cm.quantized_gossip_round_cuda(
            _a32(a, codes), codes, scales, ref, mixed, dither,
            bits=bits, chunk=chunk)
    return _store((mixed, ref, codes, scales), _ref.quantized_gossip_round_ref(
        a, codes, scales, ref, dither, bits=bits, chunk=chunk))


# ---------------------------------------------------------------------------
# rmsnorm  (model layout: (..., d))
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: the CUDA forward/backward pair on the
    card (the forward alone, with no ``rstd``, where autograd will not ask
    for a gradient), the differentiable plain version on the CPU."""
    if not x.is_cuda:
        return _ref.rmsnorm_ref(x, scale, eps)
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        y = _rn.RMSNormFn.apply(x2, scale, eps)
    else:
        y, _ = _rn.rmsnorm_fwd_cuda(x2, scale, eps, need_rstd=False)
    return y.reshape(*lead, d)


# Rows cut over ranks: x (rows, d) this rank's columns of rows d_norm wide.
# The two statistics functions give a (rows,) f32 vector that the caller
# sums over the ranks before the pass that takes it.


def rmsnorm_sumsq(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The rows' f32 sums of squares over x's columns: kernel 2's forward
    statistics launch on the card, the plain version on the CPU."""
    if not x.is_cuda:
        return _ref.rmsnorm_sumsq_ref(x)
    return _rn.rmsnorm_sumsq_cuda(x, scale)


def rmsnorm_given(x: torch.Tensor, scale: torch.Tensor, eps: float,
                  ss: torch.Tensor, d_norm: int):
    """``(y, rstd)`` of x's columns normalised by the whole rows' sums of
    squares ``ss``: kernel 2's forward on the card, the plain version on
    the CPU."""
    if not x.is_cuda:
        return _ref.rmsnorm_given_ref(x, scale, eps, ss, d_norm)
    return _rn.rmsnorm_fwd_cuda(x, scale, eps, ss=ss, d_norm=d_norm)


def rmsnorm_dot(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """The rows' f32 sums of ``g * scale * x`` over x's columns: kernel 2's
    backward statistics launch on the card, the plain version on the
    CPU."""
    if not x.is_cuda:
        return _ref.rmsnorm_dot_ref(x, scale, g)
    return _rn.rmsnorm_dot_cuda(x, scale, rstd, g)


def rmsnorm_given_bwd(x: torch.Tensor, scale: torch.Tensor,
                      rstd: torch.Tensor, g: torch.Tensor, dot: torch.Tensor,
                      d_norm: int):
    """``(dx, dscale)`` of ``rmsnorm_given`` given the whole rows' sums
    ``dot`` of g * scale * x: kernel 2's backward on the card, the plain
    version on the CPU."""
    if not x.is_cuda:
        return _ref.rmsnorm_given_bwd_ref(x, scale, rstd, g, dot, d_norm)
    return _rn.rmsnorm_bwd_cuda(x, scale, rstd, g, dot=dot, d_norm=d_norm)


# ---------------------------------------------------------------------------
# flash attention  (model layout: q (b, sq, h, hd), k/v (b, sk, kvh, hd))
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention with end-aligned queries -> (b, sq, h, hd) in q's dtype:
    the CUDA kernel on the card (forward only; it reads the layout through
    its strides and masks its ragged edges, so nothing is transposed or
    padded), the plain version on the CPU."""
    if not q.is_cuda:
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale)


# ---------------------------------------------------------------------------
# SSD scan  (model layout: xs (b,s,nh,hd), bs/cs (b,s,g,ds), dt (b,s,nh))
# ---------------------------------------------------------------------------


def ssd_scan(xs: torch.Tensor, bs: torch.Tensor, cs: torch.Tensor,
             dt: torch.Tensor, a_coef: torch.Tensor, *, chunk: int = 128):
    """Kernel 9 with ``ssd_chunked``'s contract -> (y (b, s, nh, hd) f32,
    final state (b, nh, ds, hd) f32), over chunks of ``min(chunk, s)``
    steps, B and C read from group 0: the CUDA kernel on the card (forward
    only: operands that need a gradient raise; it reads the layout through
    its strides, so B and C are never broadcast to the heads), the plain
    version on the CPU."""
    if not xs.is_cuda:
        return _ref.ssd_scan_chunked_ref(xs, bs, cs, dt, a_coef, chunk=chunk)
    return _ssd.ssd_scan_cuda(xs, bs, cs, dt, a_coef.to(torch.float32),
                              chunk=chunk)
