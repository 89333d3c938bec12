"""Plain PyTorch versions of the port's kernels.

The wrappers in ``repro_torch.kernels.ops`` run these for CPU tensors; the
CPU tests hold them against the JAX package (its Pallas kernels in
interpret mode and ``repro.kernels.ref``), and ``chip_smoke.py`` holds each
Hopper kernel against them on the card.
"""
from __future__ import annotations

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
