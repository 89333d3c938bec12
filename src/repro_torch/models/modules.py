"""Model building blocks: port of the dense path of ``repro.models.modules``.

Same conventions as the reference: ``<name>_init(gen, ..., device)`` builds a
plain dict of tensors with the reference's leaf names and layouts, and
``<name>_apply(params, x, ...)`` is a pure function.  Compute happens in
``x.dtype``.  ``rmsnorm_apply`` goes through ``repro_torch.kernels.ops``
(the Triton kernel on the card).  Attention takes the reference branch of
``dispatch_attend`` only; the Pallas flash-attention path is the serving
slice's kernel (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops


def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu") -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(params: Dict, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    return kops.rmsnorm(x, params["scale"], eps)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (half,)
    angles = positions[..., None].float() * freqs                 # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                         # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, reference path)
# ---------------------------------------------------------------------------


def attention_init(gen, cfg: ArchConfig, dtype=torch.float32,
                   device="cpu") -> Dict:
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim()
    p = {
        "w_q": _dense_init(gen, (d, h, hd), dtype, device),
        "w_k": _dense_init(gen, (d, kvh, hd), dtype, device),
        "w_v": _dense_init(gen, (d, kvh, hd), dtype, device),
        "w_o": _dense_init(gen, (h, hd, d), dtype, device,
                           scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.use_bias:
        p["b_q"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["b_k"] = torch.zeros((kvh, hd), dtype=dtype, device=device)
        p["b_v"] = torch.zeros((kvh, hd), dtype=dtype, device=device)
        p["b_o"] = torch.zeros((d,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def _project_qkv(params, xq, xkv, cfg: ArchConfig, positions_q, positions_k,
                 *, use_rope: bool):
    q = torch.einsum("bsd,dhk->bshk", xq, params["w_q"])
    k = torch.einsum("bsd,dhk->bshk", xkv, params["w_k"])
    v = torch.einsum("bsd,dhk->bshk", xkv, params["w_v"])
    if "b_q" in params:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    if "q_norm" in params:
        q = rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_apply(params["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, positions_q, cfg.rope_theta)
        k = apply_rope(k, positions_k, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """GQA: repeat kv heads up to the q-head count."""
    kvh = k.shape[2]
    if kvh == h:
        return k
    return torch.repeat_interleave(k, h // kvh, dim=2)


def mha_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor], *,
               attn_softcap: Optional[float],
               scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention. q: (b, sq, h, hd); k/v: (b, sk, kvh, hd);
    mask: (sq, sk) boolean.  Materialises the (b, h, sq, sk) scores."""
    b, sq, h, hd = q.shape
    vd = v.shape[-1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    scores = softcap(scores, attn_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full((), -1e30,
                                                      device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.reshape(b, sq, h, vd)


def causal_mask(sq: int, sk: int, q_offset: int = 0,
                window: Optional[int] = None, device="cpu") -> torch.Tensor:
    """(sq, sk) boolean mask; query i attends key j iff j <= i+off and within
    the sliding window (if any)."""
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    m = kpos[None, :] <= qpos[:, None]
    if window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def dispatch_attend(q, k, v, *, causal: bool, window: Optional[int],
                    attn_softcap: Optional[float],
                    scale: Optional[float] = None,
                    attn_impl: str = "reference") -> torch.Tensor:
    """Full-sequence attention, the reference's ``mha_attend`` branch."""
    if attn_impl != "reference":
        raise NotImplementedError(
            f"attn_impl={attn_impl!r}: the flash-attention kernel arrives "
            f"with the serving slice (ROADMAP.md)")
    sq, sk = q.shape[1], k.shape[1]
    if causal or window is not None:
        mask = causal_mask(sq, sk, q_offset=sk - sq, window=window,
                           device=q.device)
    else:
        mask = None
    return mha_attend(q, k, v, mask, attn_softcap=attn_softcap, scale=scale)


def attention_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                    layer_kind: str = "global",
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    attn_impl: str = "reference") -> torch.Tensor:
    """Self-attention over a full sequence."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    window = cfg.sliding_window if layer_kind == "local" else None
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions,
                           use_rope=True)
    out = dispatch_attend(q, k, v, causal=causal, window=window,
                          attn_softcap=cfg.attn_logit_softcap,
                          attn_impl=attn_impl)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), params["w_o"])
    if "b_o" in params:
        y = y + params["b_o"]
    return y


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, d: int, ff: int, dtype=torch.float32, device="cpu") -> Dict:
    return {
        "gate": _dense_init(gen, (d, ff), dtype, device),
        "up": _dense_init(gen, (d, ff), dtype, device),
        "down": _dense_init(gen, (ff, d), dtype, device),
    }


def _act(x, kind: str):
    # the reference's jax.nn.gelu is the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(params: Dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = _act(torch.einsum("bsd,df->bsf", x, params["gate"]), act)
    h = h * torch.einsum("bsd,df->bsf", x, params["up"])
    return torch.einsum("bsf,fd->bsd", h, params["down"])
