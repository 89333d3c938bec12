"""Kernel 1: one consensus round ``W <- A W`` on the card (CUDA C++).

Replaces ``repro.kernels.consensus_mix.consensus_mix_2d`` (the Pallas TPU
kernel).  The source is ``csrc/consensus_mix.cu``; its note says what bounds
it and how the design answers.  ``consensus_mix_cuda`` checks its operands,
launches on PyTorch's current stream, raises on a launch error and counts
its launches in ``launches``.  Its plain version is
``repro_torch.kernels.ref.consensus_mix_ref``; ``repro_torch.kernels.ops``
picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the last ``ops.reset_launch_counts()``
launches = 0
_MAX_M = 64


def _lib():
    lib = _build.load("consensus_mix")
    fn = lib.consensus_mix_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def consensus_mix_cuda(a: torch.Tensor, w: torch.Tensor,
                       out: torch.Tensor) -> torch.Tensor:
    """``out <- a @ w`` on the card.  a: (M, M) f32 contiguous, M <= 64;
    w, out: (M, D) f32 CUDA views with unit column stride (any row stride,
    so a column block of a wider buffer works); ``out`` must not overlap
    ``w``.  f32 only: other dtypes raise, nothing is cast."""
    global launches
    if not (a.is_cuda and w.is_cuda and out.is_cuda):
        raise ValueError("consensus_mix_cuda takes CUDA tensors only")
    if a.device != w.device or out.device != w.device:
        raise ValueError("a, w and out must be on one device")
    for name, t in (("a", a), ("w", w), ("out", out)):
        if t.dtype != torch.float32:
            raise TypeError(f"consensus_mix_cuda takes float32 only; {name} "
                            f"is {t.dtype} (bf16 leaves are a later slice)")
    if w.dim() != 2 or out.shape != w.shape:
        raise ValueError(f"w and out must be one (M, D) shape, got "
                         f"{tuple(w.shape)} and {tuple(out.shape)}")
    m, d = w.shape
    if not 1 <= m <= _MAX_M:
        raise ValueError(f"consensus_mix_cuda takes 1 <= M <= {_MAX_M}, "
                         f"got M={m}")
    if a.shape != (m, m) or not a.is_contiguous():
        raise ValueError(f"a must be a contiguous ({m}, {m}) matrix")
    if d and (w.stride(1) != 1 or out.stride(1) != 1):
        raise ValueError("w and out need unit column stride")
    if d and m > 1 and (w.stride(0) < d or out.stride(0) < d):
        raise ValueError("row stride shorter than the row")
    if d and _overlap(w, out):
        raise ValueError("out must not overlap w (ping-pong two buffers)")
    ld_w = w.stride(0) if m > 1 else d
    ld_o = out.stride(0) if m > 1 else d
    fn = _lib()
    err = fn(a.data_ptr(), m, w.data_ptr(), ld_w, out.data_ptr(), ld_o, d,
             torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"consensus_mix kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def _overlap(x: torch.Tensor, y: torch.Tensor) -> bool:
    def span(t):
        lo = t.data_ptr()
        hi = lo + ((t.shape[0] - 1) * t.stride(0) + t.shape[1]) * 4
        return lo, hi
    (a0, a1), (b0, b1) = span(x), span(y)
    return a0 < b1 and b0 < a1
