"""Kernel 9: the Mamba-2 SSD chunked scan on the card (CUDA C++).

Replaces ``repro.kernels.ssd_scan.ssd_scan_bhs`` (the Pallas TPU kernel).
The source is ``csrc/ssd_scan.cu``; its note says what bounds it and how the
design answers.  ``ssd_scan_cuda`` takes the model layout — x ``(b, s, nh,
hd)``, B and C ``(b, s, 1, ds)``, dt ``(b, s, nh)`` — reads it through its
strides, checks its operands, launches on PyTorch's current stream, raises
on a launch error and counts its launches in ``launches``.  Its plain
version is ``repro_torch.kernels.ref.ssd_scan_chunked_ref``;
``repro_torch.kernels.ops.ssd_scan`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the last ``ops.reset_launch_counts()``
launches = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most dynamic shared memory a block may take on a Hopper SM
MAX_SMEM = 232_448


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(head_dim: int, d_state: int, chunk: int) -> int:
    """Dynamic shared memory one block of the kernel takes."""
    return int(_lib().ssd_scan_smem_bytes(head_dim, d_state, chunk))


def _check(xs, bs, cs, dt, a_coef) -> None:
    ts = {"xs": xs, "bs": bs, "cs": cs, "dt": dt, "a_coef": a_coef}
    if not all(t.is_cuda for t in ts.values()):
        raise ValueError("ssd_scan_cuda takes CUDA tensors only")
    if any(t.device != xs.device for t in ts.values()):
        raise ValueError("all operands of ssd_scan_cuda must be on one device")
    if xs.dtype not in _DTYPES or bs.dtype != xs.dtype \
            or cs.dtype != xs.dtype:
        raise TypeError(f"ssd_scan_cuda takes float32 or bfloat16 x, B and C "
                        f"of one dtype; got {xs.dtype}, {bs.dtype}, "
                        f"{cs.dtype}")
    if dt.dtype != torch.float32 or a_coef.dtype != torch.float32:
        raise TypeError(f"ssd_scan_cuda takes float32 dt and a_coef; got "
                        f"{dt.dtype}, {a_coef.dtype}")
    if xs.dim() != 4 or bs.dim() != 4 or cs.shape != bs.shape \
            or dt.dim() != 3 or a_coef.dim() != 1:
        raise ValueError(f"xs (b, s, nh, hd), bs/cs (b, s, g, ds), dt "
                         f"(b, s, nh) and a_coef (nh,) expected, got "
                         f"{[tuple(t.shape) for t in ts.values()]}")
    b, s, nh, hd = xs.shape
    ds = bs.shape[-1]
    if bs.shape[:2] != (b, s) or tuple(dt.shape) != (b, s, nh) \
            or a_coef.shape[0] != nh:
        raise ValueError(f"operand shapes do not fit xs {tuple(xs.shape)}: "
                         f"{[tuple(t.shape) for t in ts.values()]}")
    if hd % 4 or not 4 <= hd <= 128:
        raise ValueError(f"ssd_scan_cuda takes head_dim a multiple of 4 up "
                         f"to 128, got {hd}")
    if ds % 8 or not 8 <= ds <= 128:
        raise ValueError(f"ssd_scan_cuda takes d_state a multiple of 8 up to "
                         f"128, got {ds}")
    for name, t in (("xs", xs), ("bs", bs), ("cs", cs)):
        if t.stride(-1) != 1 or any(st % 4 for st in t.stride()[:-1]) \
                or t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name} needs a unit last stride, other strides "
                             f"that are multiples of 4 and a "
                             f"4-element-aligned start")


def ssd_scan_cuda(xs: torch.Tensor, bs: torch.Tensor, cs: torch.Tensor,
                  dt: torch.Tensor, a_coef: torch.Tensor, *, chunk: int):
    """The SSD scan of xs (b, s, nh, hd) with B/C group 0 of (b, s, g, ds),
    dt (b, s, nh) and a_coef (nh,) over chunks of ``min(chunk, s)`` steps,
    on the card -> (y (b, s, nh, hd) f32, final state (b, nh, ds, hd) f32).
    Forward only: neither package has a backward of the kernel, so operands
    that need a gradient raise."""
    global launches
    _check(xs, bs, cs, dt, a_coef)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, bs, cs, dt, a_coef)):
        raise RuntimeError("ssd_scan_cuda is forward only (the TPU kernel has "
                           "no backward); run it under torch.no_grad() or "
                           "inference_mode()")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    b, s, nh, hd = xs.shape
    ds = bs.shape[-1]
    y = torch.empty((b, s, nh, hd), dtype=torch.float32, device=xs.device)
    state = torch.empty((b, nh, ds, hd), dtype=torch.float32,
                        device=xs.device)
    if not b * s:
        return y, state.zero_()
    q = min(chunk, s)
    if smem_bytes(hd, ds, q) > MAX_SMEM:
        raise ValueError(f"chunk {q} at head_dim {hd}, d_state {ds} needs "
                         f"{smem_bytes(hd, ds, q)} bytes of shared memory, "
                         f"over the {MAX_SMEM} a block may take")
    a32 = a_coef.contiguous()
    strides = (ctypes.c_longlong * 10)(*xs.stride()[:3], *bs.stride()[:2],
                                       *cs.stride()[:2], *dt.stride())
    err = _lib().ssd_scan_fwd(
        xs.data_ptr(), bs.data_ptr(), cs.data_ptr(), dt.data_ptr(),
        a32.data_ptr(), y.data_ptr(), state.data_ptr(), _DTYPES[xs.dtype],
        b, s, nh, hd, ds, q, strides,
        torch.cuda.current_stream(xs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state
