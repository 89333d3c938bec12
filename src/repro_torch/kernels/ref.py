"""Plain PyTorch versions of the port's kernels.

The wrappers in ``repro_torch.kernels.ops`` run these for CPU tensors; the
CPU tests hold them against the JAX package (its Pallas kernels in
interpret mode and ``repro.kernels.ref``), and ``chip_smoke.py`` holds each
Hopper kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def consensus_mix_ref(a_eff: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """W <- A_eff W.  a_eff: (M, M); w: (M, D); f32 contraction, W's dtype."""
    return torch.einsum("ij,jd->id", a_eff.float(), w.float()).to(w.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, reduced in
    f32, returned in x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6):
    """Closed-form backward of ``rmsnorm_ref`` for x (rows, d), the formula
    the Triton backward computes: with ``r = rsqrt(mean(x^2) + eps)``,

        dx     = r * (g * s) - x * r^3 * mean(g * s * x)
        dscale = sum_rows g * x * r

    Returns ``(dx in x's dtype, dscale in scale's dtype)``."""
    xf, gf, sf = x.float(), g.float(), scale.float()
    r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    gs = gf * sf
    dx = r * gs - xf * r ** 3 * torch.mean(gs * xf, dim=-1, keepdim=True)
    dscale = torch.sum(gf * xf * r, dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive GQA attention.  q: (b, sq, h, hd); k/v: (b, sk, kvh, hd) ->
    (b, sq, h, hd) in q's dtype, scores and softmax in f32.

    Queries sit at the END of the keys: query i has position
    ``i + sk - sq``; ``causal`` lets it see keys j <= that position and
    ``window`` only keys j > position - window.  ``softcap`` caps the scores
    as ``softcap * tanh(s / softcap)``; ``scale`` defaults to
    ``1/sqrt(hd)``.  A row that sees no key at all is **0**, as the TPU
    kernel's ``l == 0`` guard makes it (``repro.kernels.ref.attention_ref``
    averages v over such a row instead; the two agree on every other row).
    """
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    kf = torch.repeat_interleave(k.float(), group, dim=2)
    vf = torch.repeat_interleave(v.float(), group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    scores = torch.where(mask, scores, torch.full((), -1e30,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1) * mask.any(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)
