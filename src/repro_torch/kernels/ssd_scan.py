"""Kernel 9: the Mamba-2 SSD chunked scan on the card (CUDA C++).

Replaces ``repro.kernels.ssd_scan.ssd_scan_bhs`` (the Pallas TPU kernel).
The source is ``csrc/ssd_scan.cu``; its note says what bounds it and how the
design answers.  ``ssd_scan_cuda`` takes the model layout — x ``(b, s, nh,
hd)``, B and C ``(b, s, 1, ds)``, dt ``(b, s, nh)`` — reads it through its
strides, checks its operands, takes the passes' workspace from PyTorch's
allocator, launches the passes on PyTorch's current stream (read on
every call through the raw binding, without the Stream object), raises on
a launch error and counts its calls in ``launches``.  Its plain
version is ``repro_torch.kernels.ref.ssd_scan_chunked_ref``;
``repro_torch.kernels.ops.ssd_scan`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the last ``ops.reset_launch_counts()`` (one a call,
#: though a call runs its passes as three device kernels)
launches = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most dynamic shared memory a block may take on a Hopper SM
MAX_SMEM = 232_448
#: the device kernels a call launches, in order (``ssd_scan_blocks``' order)
PASSES = ("prefix and C.B' (a, b)", "chunk states and state pass (c, d)",
          "output (e)")

# the bound C functions, set on first use
_fwd = _lib = None


def _bind() -> ctypes.CDLL:
    global _fwd, _lib
    if _lib is None:
        lib = _build.load("ssd_scan")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fwd = lib.ssd_scan_fwd
        fwd.argtypes = [ptr] * 8 + [i32] * 7 + [ctypes.POINTER(i64), ptr]
        fwd.restype = i32
        lib.ssd_scan_work_bytes.argtypes = [i32] * 6
        lib.ssd_scan_work_bytes.restype = i64
        lib.ssd_scan_smem_bytes.argtypes = [i32] * 4
        lib.ssd_scan_smem_bytes.restype = i64
        lib.ssd_scan_blocks.argtypes = [i32] * 6 + [ctypes.POINTER(i64)]
        lib.ssd_scan_blocks.restype = None
        _fwd, _lib = fwd, lib
    return _lib


def smem_bytes(head_dim: int, d_state: int, chunk: int) -> int:
    """The most dynamic shared memory a block of the three launches takes
    with f32 operands (bf16 ones take no more)."""
    return int(_bind().ssd_scan_smem_bytes(head_dim, d_state, chunk, 0))


def blocks(b: int, s: int, nh: int, head_dim: int, d_state: int,
           chunk: int) -> dict:
    """Blocks of each device kernel of one call, keyed by ``PASSES``."""
    out = (ctypes.c_longlong * len(PASSES))()
    _bind().ssd_scan_blocks(b, s, nh, head_dim, d_state, chunk, out)
    return dict(zip(PASSES, map(int, out)))


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
    code = _DTYPES[xs.dtype]
    lib = _bind()
    smem = lib.ssd_scan_smem_bytes(hd, ds, q, code)
    if smem > MAX_SMEM:
        raise ValueError(f"chunk {q} at head_dim {hd}, d_state {ds} needs "
                         f"{smem} bytes of shared memory, over the "
                         f"{MAX_SMEM} a block may take")
    work = torch.empty(lib.ssd_scan_work_bytes(b, s, nh, hd, ds, q),
                       dtype=torch.uint8, device=xs.device)
    a32 = a_coef.contiguous()
    strides = (ctypes.c_longlong * 10)(*xs.stride()[:3], *bs.stride()[:2],
                                       *cs.stride()[:2], *dt.stride())
    err = _fwd(xs.data_ptr(), bs.data_ptr(), cs.data_ptr(), dt.data_ptr(),
               a32.data_ptr(), y.data_ptr(), state.data_ptr(),
               work.data_ptr(), code, b, s, nh, hd, ds, q, strides,
               torch._C._cuda_getCurrentRawStream(xs.get_device()))
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state
