"""Kernel 3: flash-attention forward on the card (CUDA C++).

Replaces ``repro.kernels.flash_attention.flash_attention_bhsd`` (the Pallas
TPU kernel).  The source is ``csrc/flash_attention.cu``; its note says what
bounds it and how the design answers.  ``flash_attention_cuda`` takes the
model layout — q ``(b, sq, h, hd)``, k/v ``(b, sk, kvh, hd)`` — reads it
through its strides, checks its operands, launches on PyTorch's current
stream (read on every call through the raw binding, without the Stream
object), raises on a launch error and counts its launches in ``launches``,
and by mode in ``mode_launches``.
Its plain version is ``repro_torch.kernels.ref.attention_ref``;
``repro_torch.kernels.ops.flash_attention`` picks between them by device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

#: kernel launches since the last ``ops.reset_launch_counts()``
launches = 0
#: the same launches by mode, keyed ``mode_key(...)``
mode_launches: dict = {}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# the bound C functions, set on first use
_fwd = _lib = None


def _bind() -> ctypes.CDLL:
    global _fwd, _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        i32 = ctypes.c_int
        fwd = lib.flash_attention_fwd
        fwd.argtypes = [ctypes.c_void_p] * 4 + [i32] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), i32, i32, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
        fwd.restype = i32
        lib.flash_attention_smem_bytes.argtypes = [i32, i32]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        lib.flash_attention_blocks.argtypes = [i32] * 4
        lib.flash_attention_blocks.restype = ctypes.c_longlong
        lib.flash_attention_encode_ns.argtypes = []
        lib.flash_attention_encode_ns.restype = ctypes.c_longlong
        _fwd, _lib = fwd, lib
    return _lib


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory one block of the kernel's ``dtype`` instance
    takes at ``head_dim``."""
    return int(_bind().flash_attention_smem_bytes(head_dim, _DTYPES[dtype]))


def encode_ns() -> int:
    """Host nanoseconds the last bf16 call spent encoding its three TMA
    descriptors."""
    return int(_bind().flash_attention_encode_ns())


def blocks(b: int, sq: int, h: int, kvh: int) -> int:
    """Blocks of one launch: (query tile, batch, KV head, head group)."""
    return int(_bind().flash_attention_blocks(b, sq, h, kvh))


def mode_key(dtype: torch.dtype, group: int, head_dim: int, causal: bool,
             window: Optional[int], softcap: Optional[float]) -> str:
    """``dtype/group/head_dim/causal/window/softcap``, e.g.
    ``bfloat16/2/128/True/4096/50.0``: the key of ``mode_launches``."""
    return "/".join(map(str, (str(dtype).split(".")[-1], group, head_dim,
                              causal, window, softcap)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                        f"one dtype for q, k and v; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (b, sq, h, hd) and k, v (b, sk, kvh, hd) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (same batch and head_dim, h a multiple of kvh)")
    if hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"flash_attention_cuda takes head_dim a multiple of "
                         f"8 up to 128, got {hd}")
    # f32: 16-byte cp.async copies; bf16: TMA, whose global strides are
    # multiples of 16 bytes from a 16-byte-aligned start
    unit = 4 if q.dtype == torch.float32 else 8
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % unit for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a unit head_dim stride, other "
                             f"strides that are multiples of {unit} and a "
                             f"16-byte-aligned start ({q.dtype})")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (b, sq, h, hd) over k/v (b, sk, kvh, hd) on the card,
    queries end-aligned; returns (b, sq, h, hd) in q's dtype.  Forward only:
    the kernel has no backward, so inputs that need a gradient raise."""
    global launches
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention_cuda is forward only (the TPU "
                           "kernel has no backward); run it under "
                           "torch.no_grad() or inference_mode()")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    if not b * sq:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if _fwd is None:
        _bind()
    err = _fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               _DTYPES[q.dtype], b, sq, sk, h, kvh, hd, strides, int(causal),
               window or 0, softcap or 0.0, scale,
               torch._C._cuda_getCurrentRawStream(q.get_device()))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    key = mode_key(q.dtype, h // kvh, hd, bool(causal), window, softcap)
    mode_launches[key] = mode_launches.get(key, 0) + 1
    return out
