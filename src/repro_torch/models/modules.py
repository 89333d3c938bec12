"""Model building blocks: port of the dense path of ``repro.models.modules``.

Same conventions as the reference: ``<name>_init(gen, ..., device)`` builds a
plain dict of tensors with the reference's leaf names and layouts, and
``<name>_apply(params, x, ...)`` is a pure function.  Compute happens in
``x.dtype``.  ``rmsnorm_apply`` goes through ``repro_torch.kernels.ops``
(the CUDA kernel on the card).  ``dispatch_attend`` routes a
full-sequence attention as the reference does: ``attn_impl="kernel"`` (the
reference's ``"pallas"``) to ``kernels.ops.flash_attention`` (the CUDA
kernel on the card), else to ``attend_chunked`` above
``FULL_ATTEND_MAX_KEYS`` keys and to ``mha_attend`` below.  An
encoder-decoder's cross-attention (``attention_apply(kv_override=...)``)
is never given ``attn_impl`` by the reference's blocks, so it always takes
the reference route.  Incremental decode (``attention_cache_init`` /
``attention_decode_step``, ``cross_attention_decode_step``) keeps a
ring-buffer KV cache and attends it with ``mha_attend``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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
                   device="cpu", cross: bool = False) -> Dict:
    """GQA attention weights; ``cross`` (an encoder-decoder's
    cross-attention) has no q/k norms."""
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
    if cfg.qk_norm and not cross:
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
    """Reference attention. q: (b, sq, h, hd); k/v: (b, sk, kvh, hd).
    mask: boolean (sq, sk), (b, sq, sk) or (b, 1, sq, sk), broadcast over
    the (b, h, sq, sk) scores as the reference does: a leading axis of
    length b is the batch axis.  Materialises the scores — fine for decode
    (sq = 1) and short sequences; long ones go to ``attend_chunked``."""
    b, sq, h, hd = q.shape
    vd = v.shape[-1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    scores = softcap(scores, attn_softcap)
    if mask is not None:
        while mask.dim() < scores.dim():
            mask = (mask[:, None] if mask.dim() >= 2 and mask.shape[0] == b
                    else mask[None])
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


def _chunk_mask(lo: int, n: int, sk: int, sq: int, causal: bool,
                window: Optional[int], device) -> torch.Tensor:
    """(sq, n) validity of keys lo .. lo+n-1 (queries end-aligned)."""
    q_pos = torch.arange(sq, device=device) + (sk - sq)
    k_pos = lo + torch.arange(n, device=device)
    valid = (k_pos[None, :] < sk).expand(sq, n)
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    return valid


def _attend_fwd_impl(q, k, v, causal, window, cap, scale, chunk):
    """Online-softmax forward over key chunks.  q: (b, sq, h, hd); k/v:
    (b, sk, h, {hd, vd}).  Returns (out (b, sq, h, vd) f32, lse (b, h, sq))."""
    b, sq, h, _ = q.shape
    sk, vd = k.shape[1], v.shape[-1]
    qf = q.float() * scale
    m = torch.full((b, h, sq), -math.inf, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, vd), device=q.device)
    for lo in range(0, sk, chunk):
        k_c, v_c = k[:, lo:lo + chunk].float(), v[:, lo:lo + chunk].float()
        s = softcap(torch.einsum("bqhd,bkhd->bhqk", qf, k_c), cap)
        valid = _chunk_mask(lo, k_c.shape[1], sk, sq, causal, window,
                            q.device)
        s = torch.where(valid, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        safe_m = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.where(valid, torch.exp(s - safe_m[..., None]), 0.0)
        alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - safe_m))
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    v_c)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    lse = torch.where(l > 0.0, m + torch.log(torch.where(l > 0.0, l, 1.0)),
                      -math.inf)
    return out.transpose(1, 2), lse


class _AttendChunked(torch.autograd.Function):
    """``attend_chunked``'s core with a flash-style backward: the scores are
    recomputed chunk by chunk from (q, k, v, lse), so neither direction
    keeps a (b, h, sq, sk) tensor.  Port of ``repro.models.modules.
    _attend_core`` (``custom_vjp``) and ``_attend_core_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale, chunk):
        out, lse = _attend_fwd_impl(q, k, v, causal, window, cap, scale,
                                    chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, cap, scale, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, cap, scale, chunk = ctx.args
        sq, sk = q.shape[1], k.shape[1]
        qf = q.float() * scale
        doutf = dout.float().transpose(1, 2)                  # (b, h, sq, vd)
        delta = (doutf * out.float().transpose(1, 2)).sum(-1)  # (b, h, sq)
        lse_safe = torch.where(torch.isinf(lse), 0.0, lse)
        dq = torch.zeros(q.shape, device=q.device)
        dks, dvs = [], []
        for lo in range(0, sk, chunk):
            k_c, v_c = k[:, lo:lo + chunk].float(), v[:, lo:lo + chunk].float()
            s = softcap(torch.einsum("bqhd,bkhd->bhqk", qf, k_c), cap)
            valid = _chunk_mask(lo, k_c.shape[1], sk, sq, causal, window,
                                q.device)
            p = torch.where(valid, torch.exp(s - lse_safe[..., None]), 0.0)
            dvs.append(torch.einsum("bhqk,bhqd->bkhd", p, doutf))
            dp = torch.einsum("bhqd,bkhd->bhqk", doutf, v_c)
            ds = p * (dp - delta[..., None])
            if cap is not None:
                ds = ds * (1.0 - torch.square(s / cap))
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_c) * scale
            dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
        dk, dv = torch.cat(dks, 1), torch.cat(dvs, 1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   attn_softcap: Optional[float] = None,
                   scale: Optional[float] = None,
                   chunk: int = 512) -> torch.Tensor:
    """Memory-efficient (online-softmax) attention over ``chunk``-key slices,
    with the flash-style backward of ``_AttendChunked``: peak transient
    O(b*h*sq*chunk) instead of O(b*h*sq*sk) in both directions.  Queries sit
    at the END of the keys.  Returns f32 (b, sq, h, vd), as the reference's
    ``attend_chunked`` does."""
    h, hd = q.shape[2], q.shape[3]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    chunk = min(chunk, k.shape[1])
    return _AttendChunked.apply(q, k, v, causal, window, attn_softcap, scale,
                                chunk)


# sk above this uses attend_chunked on the reference full-sequence path
FULL_ATTEND_MAX_KEYS = 1024


def dispatch_attend(q, k, v, *, causal: bool, window: Optional[int],
                    attn_softcap: Optional[float],
                    scale: Optional[float] = None,
                    attn_impl: str = "reference") -> torch.Tensor:
    """Route a full-sequence attention: ``"kernel"`` to the flash-attention
    op (the CUDA kernel on the card, ``attention_ref`` on the CPU),
    ``"reference"`` to ``attend_chunked`` above ``FULL_ATTEND_MAX_KEYS``
    keys and to ``mha_attend`` at or below it."""
    if attn_impl == "kernel":
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=attn_softcap, scale=scale)
    if attn_impl != "reference":
        raise ValueError(f"attn_impl must be 'reference' or 'kernel', got "
                         f"{attn_impl!r}")
    if k.shape[1] > FULL_ATTEND_MAX_KEYS:
        return attend_chunked(q, k, v, causal=causal, window=window,
                              attn_softcap=attn_softcap, scale=scale)
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
                    kv_override: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    attn_impl: str = "reference") -> torch.Tensor:
    """Self-attention over a full sequence, or cross-attention over the
    memory ``kv_override`` (b, s_mem, d): queries without rope from ``x``,
    keys and values from the memory, with their biases, no mask."""
    if kv_override is None:
        return attention_apply_kv(params, x, cfg, layer_kind=layer_kind,
                                  positions=positions, causal=causal,
                                  attn_impl=attn_impl)[0]
    q = torch.einsum("bsd,dhk->bshk", x, params["w_q"])
    if "b_q" in params:
        q = q + params["b_q"]
    k, v = cross_kv(params, kv_override, bias=True)
    out = dispatch_attend(q, k, v, causal=False, window=None,
                          attn_softcap=cfg.attn_logit_softcap,
                          attn_impl=attn_impl)
    return _out_proj(params, out, x.dtype)


def cross_kv(params: Dict, memory: torch.Tensor, *, bias: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values (b, s_mem, kvh, hd) of the memory;
    with their biases (the full-sequence cross-attention) or without them
    (what the reference's prefill writes into the cross cache)."""
    k = torch.einsum("bsd,dhk->bshk", memory, params["w_k"])
    v = torch.einsum("bsd,dhk->bshk", memory, params["w_v"])
    if bias and "b_k" in params:
        k, v = k + params["b_k"], v + params["b_v"]
    return k, v


def _out_proj(params: Dict, out: torch.Tensor, dtype) -> torch.Tensor:
    y = torch.einsum("bshk,hkd->bsd", out.to(dtype), params["w_o"])
    if "b_o" in params:
        y = y + params["b_o"]
    return y


def attention_apply_kv(params: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                       layer_kind: str = "global",
                       positions: Optional[torch.Tensor] = None,
                       causal: bool = True, attn_impl: str = "reference"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``attention_apply`` that also returns the layer's k and v
    (b, s, kvh, hd), which a prefill writes into the cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    window = cfg.sliding_window if layer_kind == "local" else None
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions,
                           use_rope=True)
    out = dispatch_attend(q, k, v, causal=causal, window=window,
                          attn_softcap=cfg.attn_logit_softcap,
                          attn_impl=attn_impl)
    return _out_proj(params, out, x.dtype), k, v


# -- incremental decode ------------------------------------------------------


def attention_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                         layer_kind: str, dtype=torch.bfloat16,
                         device="cpu") -> Dict:
    """Ring-buffer KV cache.  Local layers only keep ``sliding_window``
    slots; ``pos`` is the true position of each slot (-1: empty)."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    n = min(max_len, cfg.sliding_window) if (
        layer_kind == "local" and cfg.sliding_window) else max_len
    return {
        "k": torch.zeros((batch, n, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, n, kvh, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, n), -1, dtype=torch.int32, device=device),
    }


def attention_decode_step(params: Dict, x: torch.Tensor, cache: Dict,
                          position: int, cfg: ArchConfig, *,
                          layer_kind: str = "global"
                          ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (b, 1, d); ``position``: the int position of
    the token (one for the whole batch — synchronous decode).  Writes the
    token's k, v and position into slot ``position % n`` of ``cache`` IN
    PLACE (the reference returns a new cache; the port saves the copy) and
    returns ``(y, cache)``."""
    b = x.shape[0]
    n = cache["k"].shape[1]
    pos_b = torch.full((b, 1), position, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(params, x, x, cfg, pos_b, pos_b, use_rope=True)
    slot = position % n
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][:, slot] = position
    cpos = cache["pos"]
    window = cfg.sliding_window if layer_kind == "local" else None
    valid = (cpos >= 0) & (cpos <= position)
    if window is not None:
        valid = valid & (cpos > position - window)
    out = mha_attend(q, cache["k"], cache["v"], valid[:, None, :],
                     attn_softcap=cfg.attn_logit_softcap)
    return _out_proj(params, out, x.dtype), cache


def cross_attention_decode_step(params: Dict, x: torch.Tensor,
                                cross_k: torch.Tensor,
                                cross_v: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention over the cached memory keys and values,
    as the reference's ``_block_decode`` computes it: no query bias, no
    output bias and no softcap (its prefill's cross-attention adds them;
    the biases start at zero, so the two agree on fresh weights)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["w_q"])
    out = mha_attend(q, cross_k.to(x.dtype), cross_v.to(x.dtype), None,
                     attn_softcap=None)
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), params["w_o"])


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
