"""Kernel 2: RMSNorm forward and backward on the card (Triton).

Replaces ``repro.kernels.rmsnorm.rmsnorm_2d`` (the Pallas TPU kernel, body
``_rmsnorm_kernel``), which computes ``x * rsqrt(mean(x^2) + eps) * scale``
per row with an f32 reduction — the function the JAX models call as
``repro.models.modules.rmsnorm_apply``.  The TPU kernel has no backward
(JAX differentiates ``rmsnorm_apply``); training on the card needs one, so
the backward is a Triton kernel too, wrapped with the forward in a
``torch.autograd.Function``.

What bounds it on an H100: a row reduction plus an elementwise scale, a few
flops per byte, so memory — in principle.  At the main path's shape (256
rows of d = 960, f32: about 1 MB in, 1 MB out) the bytes take well under a
microsecond at 3.35 TB/s, so the launch itself (a few microseconds) bounds
it; 65 norms a forward and 65 a backward per client step make that the
cost that counts.  Design, kept simple and right first:

* forward: one program per block of ``BLOCK_R`` rows, the whole row in one
  ``BLOCK_D = next_pow2(d)`` tile (1024 for 960, masked), the mean of
  squares in f32, output in x's dtype, ``rstd`` saved per row;
* backward: one program per ``ROWS_PER_PROG`` rows computes
  ``dx = rstd*(g*s) - x*rstd^3*mean(g*s*x)`` row by row and a partial
  ``sum g*x*rstd`` over its rows; a second small kernel sums the partials
  over programs into ``dscale``.  No atomics, so the sum order is fixed.

``triton`` is imported when a kernel is first launched, never when this
module is imported: the CPU-only test machine has no triton.
"""
from __future__ import annotations

import torch

#: forward / backward launches since the last ``ops.reset_launch_counts()``
fwd_launches = 0
bwd_launches = 0

BLOCK_R = 4
ROWS_PER_PROG = 16

# module globals the @triton.jit bodies resolve at compile time; bound by
# _kernels() on first use
triton = None
tl = None
_KERNELS = None


def _kernels():
    """Import triton and define the kernels (once)."""
    global triton, tl, _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    import triton as _triton
    import triton.language as _tl
    triton, tl = _triton, _tl

    @triton.jit
    def rmsnorm_fwd(x_ptr, s_ptr, y_ptr, rstd_ptr, rows, d, stride_x,
                    stride_y, eps, BLOCK_R: tl.constexpr,
                    BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        r = pid * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.arange(0, BLOCK_D)
        rmask = r < rows
        cmask = c < d
        m = rmask[:, None] & cmask[None, :]
        x = tl.load(x_ptr + r[:, None] * stride_x + c[None, :], mask=m,
                    other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=1) / d
        rstd = 1.0 / tl.sqrt(ms + eps)
        s = tl.load(s_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        y = x * rstd[:, None] * s[None, :]
        tl.store(y_ptr + r[:, None] * stride_y + c[None, :],
                 y.to(y_ptr.dtype.element_ty), mask=m)
        tl.store(rstd_ptr + r, rstd, mask=rmask)

    @triton.jit
    def rmsnorm_bwd(x_ptr, s_ptr, g_ptr, rstd_ptr, dx_ptr, part_ptr, rows, d,
                    stride_x, stride_g, stride_dx,
                    ROWS_PER_PROG: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        c = tl.arange(0, BLOCK_D)
        cmask = c < d
        s = tl.load(s_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        acc = tl.zeros([BLOCK_D], dtype=tl.float32)
        for i in range(ROWS_PER_PROG):
            r = pid * ROWS_PER_PROG + i
            m = cmask & (r < rows)
            x = tl.load(x_ptr + r * stride_x + c, mask=m,
                        other=0.0).to(tl.float32)
            g = tl.load(g_ptr + r * stride_g + c, mask=m,
                        other=0.0).to(tl.float32)
            rstd = tl.load(rstd_ptr + r, mask=r < rows, other=0.0)
            gs = g * s
            mean_gsx = tl.sum(gs * x, axis=0) / d
            dx = rstd * gs - x * (rstd * rstd * rstd) * mean_gsx
            tl.store(dx_ptr + r * stride_dx + c,
                     dx.to(dx_ptr.dtype.element_ty), mask=m)
            acc += g * x * rstd
        tl.store(part_ptr + pid * d + c, acc, mask=cmask)

    @triton.jit
    def column_sum(part_ptr, out_ptr, n_parts, d, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        c = pid * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = c < d
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p in range(0, n_parts):
            acc += tl.load(part_ptr + p * d + c, mask=cmask, other=0.0)
        tl.store(out_ptr + c, acc.to(out_ptr.dtype.element_ty), mask=cmask)

    _KERNELS = (rmsnorm_fwd, rmsnorm_bwd, column_sum)
    return _KERNELS


def _block_d(d: int) -> int:
    return 1 << max(d - 1, 0).bit_length()


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if not (x.is_cuda and scale.is_cuda) or x.device != scale.device:
        raise ValueError("the rmsnorm kernels take CUDA tensors on one device")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm kernels take x (rows, d) and scale (d,), "
                         f"got {tuple(x.shape)} and {tuple(scale.shape)}")
    if x.stride(1) != 1 or not scale.is_contiguous():
        raise ValueError("rmsnorm kernels need unit column stride")
    if _block_d(x.shape[1]) > 16384:
        raise ValueError(f"d={x.shape[1]} exceeds the one-tile row of the "
                         f"rmsnorm kernel (16384)")


def rmsnorm_fwd_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """``(y, rstd)``: y (rows, d) in x's dtype, rstd (rows,) f32."""
    global fwd_launches
    _check(x, scale)
    fwd, _, _ = _kernels()
    rows, d = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows:
        fwd[(triton.cdiv(rows, BLOCK_R),)](
            x, scale, y, rstd, rows, d, x.stride(0), y.stride(0), eps,
            BLOCK_R=BLOCK_R, BLOCK_D=_block_d(d), num_warps=4)
        fwd_launches += 1
    return y, rstd


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor,
                     rstd: torch.Tensor, g: torch.Tensor):
    """``(dx, dscale)`` of the forward above for upstream gradient ``g``."""
    global bwd_launches
    _check(x, scale)
    if g.shape != x.shape or g.stride(1) != 1:
        raise ValueError("g must match x with unit column stride")
    _, bwd, colsum = _kernels()
    rows, d = x.shape
    dx = torch.empty_like(x)
    n_parts = triton.cdiv(rows, ROWS_PER_PROG)
    part = torch.empty((max(n_parts, 1), d), dtype=torch.float32,
                       device=x.device)
    dscale = torch.empty_like(scale)
    if rows:
        bwd[(n_parts,)](x, scale, g, rstd, dx, part, rows, d, x.stride(0),
                        g.stride(0), dx.stride(0),
                        ROWS_PER_PROG=ROWS_PER_PROG, BLOCK_D=_block_d(d),
                        num_warps=4)
        colsum[(triton.cdiv(d, 256),)](part, dscale, n_parts, d,
                                       BLOCK_C=256, num_warps=4)
        bwd_launches += 1
    else:
        dscale.zero_()
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """Triton forward and backward of RMSNorm over x (rows, d)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = rmsnorm_fwd_cuda(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_cuda(x, scale, rstd, g.contiguous())
        return dx, dscale, None
