"""Kernel 2: RMSNorm forward and backward on the card (CUDA C++).

Replaces ``repro.kernels.rmsnorm.rmsnorm_2d`` (the Pallas TPU kernel, body
``_rmsnorm_kernel``), which computes ``x * rsqrt(mean(x^2) + eps) * scale``
per row with an f32 reduction — the function the JAX models call as
``repro.models.modules.rmsnorm_apply``.  The TPU kernel has no backward
(JAX differentiates ``rmsnorm_apply``); training on the card needs one, so
``csrc/rmsnorm.cu`` has a backward too, wrapped with the forward in a
``torch.autograd.Function``.  The source's note says what bounds the pair
and how the design answers.

Most calls are small (a decode step's rows, a client step's 256 x 960), so
the host path is what a call costs: the C functions are bound once, the
checks are the ones the kernels need, outputs come from ``torch.empty``,
and each wrapper makes one ctypes call on PyTorch's current stream, raising
if it returns a CUDA error.  The plain versions are
``repro_torch.kernels.ref.rmsnorm_ref`` and ``rmsnorm_bwd_ref``;
``repro_torch.kernels.ops.rmsnorm`` picks between them by device.

Rows cut over ranks (Mamba's gated norm under tensor parallelism) take
two launches a pass: a statistics launch (``rmsnorm_sumsq_cuda``,
``rmsnorm_dot_cuda``) whose (rows,) f32 output the caller sums over the
ranks, then the pass given that sum and the whole row's width
(``ss=`` / ``dot=`` with ``d_norm=``).  Each launch counts one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: forward / backward launches since the last ``ops.reset_launch_counts()``
#: (a backward call counts one, though it runs two kernels)
fwd_launches = 0
bwd_launches = 0

#: the widest row the kernels take (16 elements a thread, 32 warps a row)
MAX_D = 16384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the bound C functions, set on first use
_fwd = _bwd = _scratch_rows = None


def _bind() -> None:
    global _fwd, _bwd, _scratch_rows
    lib = _build.load("rmsnorm")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd, bwd, rows = lib.rmsnorm_fwd, lib.rmsnorm_bwd, \
        lib.rmsnorm_bwd_scratch_rows
    fwd.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                    ctypes.c_float, i32, i32, ptr]
    bwd.argtypes = [ptr, i64, ptr, ptr, i64, ptr, ptr, ptr, i32, ptr, ptr,
                    ptr, i32, i32, i32, i32, ptr]
    rows.argtypes = [i32] * 4
    for fn in (fwd, bwd, rows):
        fn.restype = i32
    if lib.rmsnorm_max_d() != MAX_D:
        raise RuntimeError("csrc/rmsnorm.cu and rmsnorm.py disagree on the "
                           "widest row")
    _fwd, _bwd, _scratch_rows = fwd, bwd, rows


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    """Raise on what the kernels do not take; else x's dtype code.  (Every
    attribute read here costs host time on each of a step's ~100 calls, so
    the checks are the kernels' needs and no more.)"""
    if not x.is_cuda:
        raise ValueError("the rmsnorm kernels take CUDA tensors only")
    code = _DTYPES.get(x.dtype)
    if code is None or scale.dtype != x.dtype:
        raise TypeError(f"the rmsnorm kernels take float32 or bfloat16, one "
                        f"dtype for x and scale; got {x.dtype}, "
                        f"{scale.dtype}")
    shape = x.shape
    if len(shape) != 2 or scale.shape != shape[1:]:
        raise ValueError(f"the rmsnorm kernels take x (rows, d) and scale "
                         f"(d,), got {tuple(shape)} and "
                         f"{tuple(scale.shape)}")
    if not 1 <= shape[1] <= MAX_D:
        raise ValueError(f"the rmsnorm kernels take 1 <= d <= {MAX_D}, got "
                         f"d={shape[1]}")
    if x.stride(1) != 1 or scale.stride(0) != 1:
        raise ValueError("the rmsnorm kernels need unit column stride")
    if scale.get_device() != x.get_device():
        raise ValueError("x and scale must be on one device")
    return code


def _stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on x's device, read on every call (the
    binding ``torch.cuda.current_stream().cuda_stream`` ends in, without
    the Stream object it builds)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _row_stats(t: torch.Tensor, x: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is a (rows,) f32 vector of x's rows on its
    device."""
    if t.dim() != 1 or t.shape[0] != x.shape[0] \
            or t.dtype != torch.float32 \
            or t.get_device() != x.get_device() or t.stride(0) != 1:
        raise ValueError(f"{what} must be the rows' (rows,) float32")


def _launch_fwd(x, scale, eps, y, rstd, ss_in, ss_out, d_norm) -> None:
    global fwd_launches
    code = _check(x, scale)
    rows, d = x.shape
    if not rows:
        return
    if _fwd is None:
        _bind()
    xp, sp, sx = x.data_ptr(), scale.data_ptr(), x.stride(0)
    es = x.element_size()
    vec = not (xp | sp | (sx | d) * es) & 15
    err = _fwd(xp, sx, sp, None if y is None else y.data_ptr(),
               None if rstd is None else rstd.data_ptr(),
               None if ss_in is None else ss_in.data_ptr(),
               None if ss_out is None else ss_out.data_ptr(), d_norm, rows,
               d, eps, code, vec, _stream(x))
    if err:
        raise RuntimeError(f"rmsnorm forward launch failed: CUDA error "
                           f"{err}")
    fwd_launches += 1


def rmsnorm_fwd_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
                     need_rstd: bool = True, ss: torch.Tensor = None,
                     d_norm: int = 0):
    """``(y, rstd)``: y (rows, d) in x's dtype, rstd (rows,) f32 — or None
    with ``need_rstd=False``, when no backward will follow.  With ``ss``
    (the rows' (rows,) f32 sums of squares over all ``d_norm`` columns of
    which x holds d), the rows are normalised by those instead of their
    own."""
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    rstd = x.new_empty((x.shape[0],), dtype=torch.float32) if need_rstd \
        else None
    if ss is not None:
        _row_stats(ss, x, "ss")
        if d_norm < x.shape[1]:
            raise ValueError(f"a row of d_norm={d_norm} columns cannot hold "
                             f"x's {x.shape[1]}")
    _launch_fwd(x, scale, eps, y, rstd, ss, None, d_norm if ss is not None
                else 0)
    return y, rstd


def rmsnorm_sumsq_cuda(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The rows' f32 sums of squares over x's columns (``(rows,)``), the
    forward's statistics launch (``scale`` as the forward takes it)."""
    ss = x.new_empty((x.shape[0],), dtype=torch.float32)
    _launch_fwd(x, scale, 0.0, None, None, None, ss, 0)
    return ss


def _launch_bwd(x, scale, rstd, g, dot_in, dot_out, d_norm):
    """The backward launch -> (dx, dscale), or ``(None, None)`` in the
    statistics mode (``dot_out``)."""
    global bwd_launches
    code = _check(x, scale)
    rows, d = x.shape
    if g.shape != x.shape or g.dtype != x.dtype \
            or g.get_device() != x.get_device() or g.stride(1) != 1:
        raise ValueError("g must match x in shape, dtype and device, with "
                         "unit column stride")
    _row_stats(rstd, x, "rstd")
    stats = dot_out is not None
    dx = None if stats else torch.empty_like(
        x, memory_format=torch.contiguous_format)
    dscale = None if stats else torch.empty_like(scale)
    if not rows:
        return dx, None if stats else dscale.zero_()
    if _bwd is None:
        _bind()
    xp, sp, gp, sx, sg = (x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                          x.stride(0), g.stride(0))
    es = x.element_size()
    vec = not (xp | sp | gp | (sx | sg | d) * es) & 15
    part = None if stats else x.new_empty(
        (_scratch_rows(rows, d, code, vec), d), dtype=torch.float32)
    err = _bwd(xp, sx, sp, gp, sg, rstd.data_ptr(),
               None if dot_in is None else dot_in.data_ptr(),
               None if dot_out is None else dot_out.data_ptr(), d_norm,
               None if stats else dx.data_ptr(),
               None if stats else dscale.data_ptr(),
               None if stats else part.data_ptr(), rows, d, code, vec,
               _stream(x))
    if err:
        raise RuntimeError(f"rmsnorm backward launch failed: CUDA error "
                           f"{err}")
    bwd_launches += 1
    return dx, dscale


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor,
                     rstd: torch.Tensor, g: torch.Tensor, *,
                     dot: torch.Tensor = None, d_norm: int = 0):
    """``(dx, dscale)`` of the forward above for upstream gradient ``g``:
    dx (rows, d) in x's dtype, dscale (d,) in scale's, summed over rows in
    an order fixed by the shape (no atomics: equal inputs, equal bits).
    With ``dot`` (the rows' (rows,) f32 sums of g * scale * x over all
    ``d_norm`` columns, as ``rmsnorm_fwd_cuda``'s ``ss``), dx takes their
    mean from it."""
    if dot is not None:
        _row_stats(dot, x, "dot")
        if d_norm < x.shape[1]:
            raise ValueError(f"a row of d_norm={d_norm} columns cannot hold "
                             f"x's {x.shape[1]}")
    return _launch_bwd(x, scale, rstd, g, dot, None,
                       d_norm if dot is not None else 0)


def rmsnorm_dot_cuda(x: torch.Tensor, scale: torch.Tensor,
                     rstd: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The rows' f32 sums of ``g * scale * x`` over x's columns
    (``(rows,)``), the backward's statistics launch."""
    dot = x.new_empty((x.shape[0],), dtype=torch.float32)
    _launch_bwd(x, scale, rstd, g, None, dot, 0)
    return dot


class RMSNormFn(torch.autograd.Function):
    """The CUDA forward and backward of RMSNorm over x (rows, d)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = rmsnorm_fwd_cuda(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        if g.stride(1) != 1:
            g = g.contiguous()
        dx, dscale = rmsnorm_bwd_cuda(x, scale, rstd, g)
        return dx, dscale, None
