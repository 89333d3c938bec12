"""Threefry-2x32 keys and random bits, bitwise equal to ``jax.random``'s.

The physical wire's dither (``comm.compressors.wire_dither``) keys a
per-element hash with four threefry ``fold_in``s of the epoch's consensus
key, and that key is split off the epoch rng once an epoch.  These are O(1)
scalar operations, so they run here in numpy ``uint32`` on the key data (the
``(2,)`` array ``jax.random.key_data`` returns), with JAX's default
``jax_threefry_partitionable=True`` semantics:

* ``key(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``fold_in(k, data)`` is ``threefry2x32(k, [data >> 32, data & mask])``;
* ``split(k, n)[i]`` is ``threefry2x32(k, [i >> 32, i & mask])``, so for
  ``n <= 2**32`` the i-th split key equals ``fold_in(k, i)``.

The simulated wire's dither is ``jax.random.uniform(k, shape)`` over a whole
leaf, so ``random_bits`` and ``uniform`` run the cipher per element, on the
tensor's own device: the 32 bits of row-major flat index ``e`` are
``x0 ^ x1`` with ``(x0, x1) = threefry2x32(k, (e >> 32, e & mask))``, and
``uniform`` keeps their top 23 bits as the mantissa of a float in [1, 2)
and subtracts 1.  torch has no ``uint32`` arithmetic, so the cipher runs in
int64 ops masked to 32 bits (about 165 elementwise ops an element), in
blocks of whole rows of about ``BLOCK`` elements.

``normal`` is ``jax.random.normal``: a uniform draw on ``[nextafter(-1, 0),
1)`` (the bits as above; a bfloat16 draw keeps the low 8 bits of each
element's 32, as jax draws 8 bits for fewer than 8 mantissa bits) and ``sqrt(2) * erf_inv(u)``.  XLA's float32 ``erf_inv`` is
Giles' single-precision polynomial in ``w = -log1p(-u^2)``, which
``erf_inv`` copies with each step ``c + p * w`` as one fused multiply-add;
``torch.log1p`` is not XLA's ``log1p`` in the last bit, so ``erf_inv`` is
within 2 float32 ulps of XLA's and a float32 draw within 4 ulps of the
reference's (about 99% of elements bitwise); a bfloat16 draw, rounded from
them, is bitwise (``tests/test_torch_robust.py``).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import fma

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: elements of one block of ``random_bits`` / ``uniform``: bounds the int64
#: transients to a few hundred MB
BLOCK = 1 << 24


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x0: int, x1: int) -> tuple:
    """The threefry-2x32 block cipher (20 rounds) of one counter pair."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _pair(data: int) -> tuple:
    data = int(data)
    if data < 0:
        data &= (1 << 64) - 1
    return (data >> 32) & _MASK, data & _MASK


def key(seed: int) -> np.ndarray:
    """Key data of ``jax.random.key(seed)``."""
    return np.array(_pair(seed), dtype=np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    """Key data of ``jax.random.fold_in(k, data)``."""
    return np.array(threefry2x32(k, *_pair(data)), dtype=np.uint32)


def split(k, num: int = 2) -> np.ndarray:
    """``(num, 2)`` key data of ``jax.random.split(k, num)``."""
    return np.array([threefry2x32(k, *_pair(i)) for i in range(num)],
                    dtype=np.uint32).reshape(num, 2)


# ---------------------------------------------------------------------------
# random bits and uniform floats over a whole array, on its device
# ---------------------------------------------------------------------------


def _threefry_(k0: int, k1: int, x0: torch.Tensor,
               x1: torch.Tensor) -> None:
    """``threefry2x32`` of every counter pair ``(x0, x1)`` (int64 tensors
    holding uint32 values), in place."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0.add_(ks[0]).bitwise_and_(_MASK)
    x1.add_(ks[1]).bitwise_and_(_MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            high = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_and_(_MASK).bitwise_or_(
                high).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_MASK)


def _bits(k, lo: int, hi: int, device: Any) -> torch.Tensor:
    """(hi - lo,) int64 tensor: the 32 random bits of flat indices
    [lo, hi)."""
    e = torch.arange(lo, hi, dtype=torch.int64, device=device)
    x0 = e >> 32
    x1 = e.bitwise_and_(_MASK)
    _threefry_(int(k[0]), int(k[1]), x0, x1)
    return x0.bitwise_xor_(x1)


def _rows_view(out: torch.Tensor) -> torch.Tensor:
    """``out`` as an (R, n) view with unit column stride (``view`` raises
    where the rows of ``out`` cannot be merged without a copy)."""
    n = out.shape[-1] if out.dim() else 1
    rows = out.view(-1, n)
    if n > 1 and rows.stride(1) != 1:
        raise ValueError("out needs unit stride along its last axis")
    return rows


def _fill_rows(k, rows: torch.Tensor, start: int, block: int, fill) -> None:
    """Row-block loop shared by ``random_bits`` and ``uniform``: row r of
    ``rows`` holds flat indices ``start + r * n + [0, n)``."""
    r_tot, n = rows.shape
    if r_tot == 0 or n == 0:
        return
    step = max(1, block // n)
    for r0 in range(0, r_tot, step):
        r1 = min(r_tot, r0 + step)
        bits = _bits(k, start + r0 * n, start + r1 * n, rows.device)
        fill(rows[r0:r1], bits.view(r1 - r0, n))


def random_bits(k, shape: Tuple[int, ...], *, device: Any = "cpu",
                block: int = BLOCK) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of uint32
    values."""
    out = torch.empty(tuple(shape), dtype=torch.int64, device=device)
    _fill_rows(k, _rows_view(out), 0, block,
               lambda dst, bits: dst.copy_(bits))
    return out


def uniform(k, shape: Tuple[int, ...], *, device: Any = "cpu",
            out: Optional[torch.Tensor] = None, start: int = 0,
            block: int = BLOCK) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)), bitwise.

    ``out`` receives it in place: a float32 tensor of ``shape`` whose rows
    (the last axis) have unit stride, e.g. the real columns of a padded
    buffer.  ``start`` offsets the flat index, so ``out`` may hold a
    contiguous run of whole rows of a larger array (server ``s`` of an
    ``(M, *w)`` leaf starts at ``s * prod(w)``)."""
    if out is None:
        out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    elif tuple(out.shape) != tuple(shape) or out.dtype != torch.float32:
        raise ValueError(f"out must be float32 of shape {tuple(shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    one = torch.ones((), dtype=torch.float32, device=out.device)

    def fill(dst, bits):
        mant = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
        torch.sub(mant.to(torch.int32).view(torch.float32), one, out=dst)
    _fill_rows(k, _rows_view(out), start, block, fill)
    return out


# ---------------------------------------------------------------------------
# normal draws (jax.random.normal)
# ---------------------------------------------------------------------------

# Giles' single-precision erfinv coefficients, highest power first, for
# w < 5 (in w - 2.5) and w >= 5 (in sqrt(w) - 3): XLA's ErfInv32
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' polynomial), on ``x``'s device:
    ``erf_inv(+-1) = +-inf``."""
    x = x.float()
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lo = torch.tensor(_ERFINV_LO, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_HI, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LO)):
        p = fma(p, t, torch.where(lt, lo[i], hi[i]))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def normal(k, shape: Tuple[int, ...], *, dtype: torch.dtype = torch.float32,
           device: Any = "cpu", start: int = 0,
           block: int = BLOCK) -> torch.Tensor:
    """``jax.random.normal(key, full_shape, dtype)`` restricted to the
    elements of flat index ``[start, start + prod(shape))`` (a run of whole
    rows of a larger array), in ``dtype`` (float32 or bfloat16): float32
    within 4 ulps of the reference, bfloat16 bitwise (module docstring)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normal draws float32 or bfloat16, got {dtype}")
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if dtype == torch.float32:
        nmant, one, lo = 23, 0x3F800000, float(
            np.nextafter(np.float32(-1.0), np.float32(0.0)))
    else:
        nmant, one, lo = 7, 0x3F80, -(1.0 - 2.0 ** -8)
    # hi - lo rounds to 2 in either dtype, and u * 2 is exact
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype)

    def fill(dst, bits):
        if dtype == torch.float32:
            mant = bits.bitwise_right_shift_(32 - nmant).bitwise_or_(one)
            u = mant.to(torch.int32).view(torch.float32) - 1.0
        else:
            # fewer than 8 mantissa bits: jax draws 8 random bits
            mant = bits.bitwise_and_(0xFF).bitwise_right_shift_(
                8 - nmant).bitwise_or_(one)
            u = (mant.to(torch.int16).view(torch.bfloat16) - 1.0).float()
        u = torch.clamp((u * 2.0 + lo).to(dtype), min=lo)
        dst.copy_(sqrt2.to(dst.device) * erf_inv(u).to(dtype))
    _fill_rows(k, _rows_view(out), start, block, fill)
    return out
