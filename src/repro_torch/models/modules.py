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

DeepSeek-V2's multi-head latent attention (``mla_*``) and the
mixture-of-experts FFN (``moe_*``) follow the reference line by line.  MLA's
full-sequence attention calls ``dispatch_attend`` without ``attn_impl`` in
the reference, so it always takes the reference route (its q/k head dim,
192, is also past the flash kernel's 128); its decode cache is the latent
``c_kv`` and the shared ``k_rope``, written at ``position`` (clamped to the
last slot, as ``dynamic_update_slice`` does, not a ring).  The MoE routes in
f32, dispatches by a gather of token indices and combines slot by slot in
``x.dtype``; the expert matmuls are batched einsums.  Both take a
``launch.tp.ModelParallel`` (``tp``) as the attention and the MLP do: a
rank then runs its heads, its q latent columns and its experts (or their
d_ff columns), and the partial sums are reduced over "model".  The
cross-attention, the decode steps and the cache take it too: a rank
attends with its q heads over its cache of the kv heads they read
(``tp_kv_range``), and where the serve mesh leaves the attention whole
(``attention_tp``: ``attn_tp=False``) it runs every head.
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
    # scaled in place: one f32 buffer at a time (an expert tensor of Jamba
    # is 12.9 GB in f32)
    return t.mul_(std).to(dtype)


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


def attention_tp(tp):
    """``tp`` where the attention runs over the rank's heads, ``None``
    where it runs whole on every rank: a ``launch.tp.ModelParallel`` built
    with ``attn_tp=False`` (the serve mesh's layout where the heads do not
    divide the axis, ``launch.sharding.serve_param_specs(attn_tp=False)``:
    the attention leaves replicated, the MLP and the vocab still cut)."""
    return tp if tp is not None and tp.attn_tp else None


def tp_kv_range(cfg: ArchConfig, tp) -> Tuple[int, int]:
    """The kv heads ``[lo, hi)`` a rank's q heads read under ``tp`` (every
    kv head without it): its own ``kvh / size`` where the kv heads divide
    the axis, else those its q heads ``[p h / size, (p + 1) h / size)``
    read, the group ratio kept (Qwen3 at TP 16, qwen3-smoke at TP 4)."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    if tp is None:
        return 0, kvh
    if kvh % tp.size == 0:
        n = kvh // tp.size
        return tp.pos * n, (tp.pos + 1) * n
    hl, g = h // tp.size, h // kvh
    q_lo = tp.pos * hl
    return q_lo // g, (q_lo + hl - 1) // g + 1


def _kv_index(cfg: ArchConfig, tp) -> Optional[torch.Tensor]:
    """The index, among the kv heads ``tp_kv_range`` gives a rank, of the
    kv head each of its q heads reads, or ``None`` where GQA's own repeat
    (``_expand_kv``) picks them."""
    hl, g = cfg.num_heads // tp.size, cfg.num_heads // cfg.num_kv_heads
    kv_lo, kv_hi = tp_kv_range(cfg, tp)
    idx = (tp.pos * hl + torch.arange(hl)) // g - kv_lo
    nkv = kv_hi - kv_lo
    if hl % nkv == 0 and torch.equal(
            idx, torch.arange(nkv).repeat_interleave(hl // nkv)):
        return None
    return idx


def _read_kv(k: torch.Tensor, v: torch.Tensor, kv_idx
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kv heads each q head reads (``_kv_index``), or ``k``, ``v`` as
    they are."""
    if kv_idx is None:
        return k, v
    kv_idx = kv_idx.to(k.device)
    return k.index_select(2, kv_idx), v.index_select(2, kv_idx)


def attention_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                    layer_kind: str = "global",
                    positions: Optional[torch.Tensor] = None,
                    kv_override: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    attn_impl: str = "reference", tp=None) -> torch.Tensor:
    """Self-attention over a full sequence, or cross-attention over the
    memory ``kv_override`` (b, s_mem, d): queries without rope from ``x``,
    keys and values from the memory, with their biases, no mask.  Under
    ``tp`` either runs the rank's heads (``_tp_attention_params``): q after
    ``tp.copy`` of ``x``, ``w_o`` row-parallel and reduced.  The memory is
    whole on every rank, and each rank reads it for its own heads only, so
    its gradient is partial: the caller passes it through ``tp.copy`` once
    (``models.transformer._trunk_inputs``, site ``tp_memory``)."""
    if kv_override is None:
        return attention_apply_kv(params, x, cfg, layer_kind=layer_kind,
                                  positions=positions, causal=causal,
                                  attn_impl=attn_impl, tp=tp)[0]
    tp = attention_tp(tp)
    kv_idx = None
    if tp is not None:
        params, kv_idx = _tp_attention_params(params, cfg, tp)
        x = tp.copy(x)
    q = torch.einsum("bsd,dhk->bshk", x, params["w_q"])
    if "b_q" in params:
        q = q + params["b_q"]
    k, v = _read_kv(*cross_kv(params, kv_override, bias=True), kv_idx)
    out = dispatch_attend(q, k, v, causal=False, window=None,
                          attn_softcap=cfg.attn_logit_softcap,
                          attn_impl=attn_impl)
    return _out_proj(params, out, x.dtype, tp)


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


def cross_cache_kv(params: Dict, memory: torch.Tensor, cfg: ArchConfig,
                   tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What a prefill writes into the cross cache: the memory's keys and
    values without their biases, under ``tp`` of the rank's kv heads
    (``tp_kv_range``)."""
    tp = attention_tp(tp)
    if tp is not None:
        params = _tp_attention_params(params, cfg, tp)[0]
    return cross_kv(params, memory, bias=False)


def _out_proj(params: Dict, out: torch.Tensor, dtype, tp=None
              ) -> torch.Tensor:
    """The output projection; under ``tp`` (a ``launch.tp.ModelParallel``)
    row-parallel over the rank's heads, the partial sums reduced over
    "model" before ``b_o`` is added once."""
    y = torch.einsum("bshk,hkd->bsd", out.to(dtype), params["w_o"])
    if tp is not None:
        y = tp.reduce(y)
    if "b_o" in params:
        y = y + params["b_o"]
    return y


def _tp_attention_params(params: Dict, cfg: ArchConfig, tp
                         ) -> Tuple[Dict, Optional[torch.Tensor]]:
    """The attention leaves a TP rank multiplies, and the index of the kv
    head each of its q heads reads (``None``: GQA's own repeat).  Its q
    heads are ``[p h / tp, (p + 1) h / tp)``; with the kv heads cut they
    read its kv heads ``[p kvh / tp, ...)``, the group ratio kept.  Under
    the head-dim fallback (``launch.sharding.KV_HD_FALLBACK``) ``w_k`` /
    ``w_v`` are gathered whole over "model" and cut to the kv heads its q
    heads read (``tp_kv_range``); a kv leaf held whole is cut so too, and
    kv leaves held as those heads already (a serving rank's,
    ``launch.serve.serve_pieces``) are read as they are.  A replicated
    leaf read for these heads only (``q_norm``, ``k_norm``, a whole kv
    bias) has its gradient summed over "model"."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim()
    hl = params["w_q"].shape[-2]
    if hl * tp.size != h:
        raise ValueError(f"w_q holds {hl} of {h} heads on a model axis of "
                         f"{tp.size}")
    p = dict(params)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = {"scale": tp.replicated(p[name]["scale"])}
    w_k = params["w_k"]
    if w_k.shape[-2] * tp.size == kvh and kvh % tp.size == 0:
        return p, None
    # kv heads held whole, gathered whole from head-dim pieces, or held as
    # its own: this rank's q heads read kv heads [kv_lo, kv_hi)
    kv_lo, kv_hi = tp_kv_range(cfg, tp)
    if w_k.shape[-1] == hd and w_k.shape[-2] == kv_hi - kv_lo < kvh:
        return p, _kv_index(cfg, tp)
    kv = [params["w_k"], params["w_v"]]
    kv = (tp.gather(kv, -1) if w_k.shape[-1] != hd
          else [tp.replicated(w) for w in kv])
    p["w_k"], p["w_v"] = (w[..., kv_lo:kv_hi, :] for w in kv)
    for name in ("b_k", "b_v"):
        if name in p:
            p[name] = tp.replicated(p[name])[kv_lo:kv_hi]
    return p, _kv_index(cfg, tp)


def attention_apply_kv(params: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                       layer_kind: str = "global",
                       positions: Optional[torch.Tensor] = None,
                       causal: bool = True, attn_impl: str = "reference",
                       tp=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``attention_apply`` that also returns the layer's k and v
    (b, s, kvh, hd), which a prefill writes into the cache.  Under ``tp``
    (a ``launch.tp.ModelParallel``) the rank runs its own heads:
    column-parallel q / k / v after ``tp.copy``, row-parallel ``w_o``
    (``_tp_attention_params``); k and v are then its kv heads'
    (``tp_kv_range``), before any repeat to its q heads."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    window = cfg.sliding_window if layer_kind == "local" else None
    tp = attention_tp(tp)
    kv_idx = None
    if tp is not None:
        params, kv_idx = _tp_attention_params(params, cfg, tp)
        x = tp.copy(x)
    q, k, v = _project_qkv(params, x, x, cfg, positions, positions,
                           use_rope=True)
    out = dispatch_attend(q, *_read_kv(k, v, kv_idx), causal=causal,
                          window=window,
                          attn_softcap=cfg.attn_logit_softcap,
                          attn_impl=attn_impl)
    return _out_proj(params, out, x.dtype, tp), k, v


# -- incremental decode ------------------------------------------------------


def attention_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                         layer_kind: str, dtype=torch.bfloat16,
                         device="cpu", kv_heads: Optional[int] = None
                         ) -> Dict:
    """Ring-buffer KV cache of ``kv_heads`` heads (default: every kv head;
    a TP rank's ``tp_kv_range``).  Local layers only keep
    ``sliding_window`` slots; ``pos`` is the true position of each slot
    (-1: empty)."""
    kvh, hd = kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim()
    n = min(max_len, cfg.sliding_window) if (
        layer_kind == "local" and cfg.sliding_window) else max_len
    return {
        "k": torch.zeros((batch, n, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, n, kvh, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, n), -1, dtype=torch.int32, device=device),
    }


def attention_decode_step(params: Dict, x: torch.Tensor, cache: Dict,
                          position: int, cfg: ArchConfig, *,
                          layer_kind: str = "global", tp=None
                          ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (b, 1, d); ``position``: the int position of
    the token (one for the whole batch — synchronous decode).  Writes the
    token's k, v and position into slot ``position % n`` of ``cache`` IN
    PLACE (the reference returns a new cache; the port saves the copy) and
    returns ``(y, cache)``.  Under ``tp`` the rank's heads, as
    ``attention_apply_kv`` runs them, against its cache of its kv heads."""
    b = x.shape[0]
    n = cache["k"].shape[1]
    tp = attention_tp(tp)
    kv_idx = None
    if tp is not None:
        params, kv_idx = _tp_attention_params(params, cfg, tp)
        x = tp.copy(x)
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
    out = mha_attend(q, *_read_kv(cache["k"], cache["v"], kv_idx),
                     valid[:, None, :], attn_softcap=cfg.attn_logit_softcap)
    return _out_proj(params, out, x.dtype, tp), cache


def cross_attention_decode_step(params: Dict, x: torch.Tensor,
                                cross_k: torch.Tensor,
                                cross_v: torch.Tensor,
                                cfg: Optional[ArchConfig] = None,
                                tp=None) -> torch.Tensor:
    """One token's cross-attention over the cached memory keys and values,
    as the reference's ``_block_decode`` computes it: no query bias, no
    output bias and no softcap (its prefill's cross-attention adds them;
    the biases start at zero, so the two agree on fresh weights).  Under
    ``tp`` (``cfg`` given) the rank's q heads against its cross cache of
    their kv heads, ``w_o`` row-parallel and reduced."""
    tp = attention_tp(tp)
    kv_idx = None
    if tp is not None:
        params, kv_idx = _tp_attention_params(params, cfg, tp)
        x = tp.copy(x)
    q = torch.einsum("bsd,dhk->bshk", x, params["w_q"])
    k, v = _read_kv(cross_k.to(x.dtype), cross_v.to(x.dtype), kv_idx)
    out = mha_attend(q, k, v, None, attn_softcap=None)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), params["w_o"])
    return y if tp is None else tp.reduce(y)


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


def mlp_apply(params: Dict, x: torch.Tensor, act: str = "silu",
              tp=None) -> torch.Tensor:
    """The gated MLP; under ``tp`` (a ``launch.tp.ModelParallel``) over the
    rank's d_ff columns: ``gate`` / ``up`` column-parallel after
    ``tp.copy``, ``down`` row-parallel, its partial sums reduced."""
    if tp is not None:
        x = tp.copy(x)
    h = _act(torch.einsum("bsd,df->bsf", x, params["gate"]), act)
    h = h * torch.einsum("bsd,df->bsf", x, params["up"])
    y = torch.einsum("bsf,fd->bsd", h, params["down"])
    return y if tp is None else tp.reduce(y)


# ---------------------------------------------------------------------------
# MLA -- multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ArchConfig, dtype=torch.float32, device="cpu") -> Dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": _dense_init(gen, (d, m.q_lora_rank), dtype, device),
        "q_norm": rmsnorm_init(m.q_lora_rank, dtype, device),
        "w_uq": _dense_init(gen, (m.q_lora_rank, h, qh), dtype, device),
        "w_dkv": _dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                             dtype, device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, device),
        "w_ukv": _dense_init(gen, (m.kv_lora_rank, h,
                                   m.qk_nope_head_dim + m.v_head_dim),
                             dtype, device),
        "w_o": _dense_init(gen, (h, m.v_head_dim, d), dtype, device,
                           scale=1.0 / math.sqrt(h * m.v_head_dim)),
    }


def _mla_qkv(params, x, cfg: ArchConfig, positions, tp=None):
    """Returns q (b, s, h, qh), the latent c_kv (b, s, r) and the shared
    k_rope (b, s, rope).  Under ``tp`` (``_tp_mla_params``) q is the
    rank's heads: its piece of the q latent is gathered whole first."""
    m = cfg.mla
    cq = torch.einsum("bsd,dr->bsr", x, params["w_dq"])
    if tp is not None:
        cq = tp.gather_latent(cq)
    cq = rmsnorm_apply(params["q_norm"], cq, cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"])
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    dkv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"])
    c_kv, k_rope = torch.split(dkv, [m.kv_lora_rank, m.qk_rope_head_dim],
                               dim=-1)
    c_kv = rmsnorm_apply(params["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return torch.cat([q_nope, q_rope], dim=-1), c_kv, k_rope


def _mla_scale(cfg: ArchConfig) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _mla_attend(params, q, c_kv, k_rope, mask, cfg: ArchConfig,
                causal: Optional[bool] = None) -> torch.Tensor:
    """Expand the latent to per-head K/V and attend: with ``causal`` a
    full sequence through ``dispatch_attend``'s reference route, else
    (decode) ``mha_attend`` under ``mask``."""
    m = cfg.mla
    ukv = torch.einsum("bsr,rhk->bshk", c_kv, params["w_ukv"])
    k_nope, v = torch.split(ukv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    if causal is not None:
        out = dispatch_attend(q, k, v, causal=causal, window=None,
                              attn_softcap=None, scale=_mla_scale(cfg))
    else:
        out = mha_attend(q, k, v, mask, attn_softcap=None,
                         scale=_mla_scale(cfg))
    return torch.einsum("bshk,hkd->bsd", out.to(q.dtype), params["w_o"])


def _tp_mla_params(params: Dict, cfg: ArchConfig, tp) -> Dict:
    """This rank's MLA weights under ``tp`` (a ``launch.tp.ModelParallel``):
    ``w_dq`` its columns of the q latent, ``w_uq`` / ``w_ukv`` / ``w_o``
    its heads ``[p h / tp, (p + 1) h / tp)`` as the pieces hold them;
    ``w_dkv``, ``q_norm`` and ``kv_norm`` read whole but feeding only its
    heads, so through ``tp.replicated`` (their gradients summed)."""
    hl = params["w_uq"].shape[-2]
    if hl * tp.size != cfg.num_heads or \
            params["w_ukv"].shape[-2] != hl or params["w_o"].shape[0] != hl:
        raise ValueError(f"MLA pieces of {hl} heads do not cut "
                         f"{cfg.num_heads} heads over {tp.size} model ranks")
    p = dict(params)
    for name in ("q_norm", "kv_norm"):
        p[name] = {"scale": tp.replicated(params[name]["scale"])}
    p["w_dkv"] = tp.replicated(params["w_dkv"])
    return p


def mla_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig,
              positions: Optional[torch.Tensor] = None,
              tp=None) -> torch.Tensor:
    return mla_apply_latent(params, x, cfg, positions, tp)[0]


def mla_apply_latent(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                     positions: Optional[torch.Tensor] = None, tp=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mla_apply`` that also returns the latent c_kv and k_rope, which a
    prefill writes into the cache.  Under ``tp`` (a
    ``launch.tp.ModelParallel``) the rank runs its heads after
    ``tp.copy`` (``_tp_mla_params``) and reduces ``w_o``'s partial sums;
    c_kv and k_rope are then the same on every rank."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    if tp is not None:
        params = _tp_mla_params(params, cfg, tp)
        x = tp.copy(x)
    q, c_kv, k_rope = _mla_qkv(params, x, cfg, positions, tp)
    y = _mla_attend(params, q, c_kv, k_rope, None, cfg, causal=True)
    return y if tp is None else tp.reduce(y), c_kv, k_rope


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cpu") -> Dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def mla_decode_step(params: Dict, x: torch.Tensor, cache: Dict,
                    position: int, cfg: ArchConfig, absorbed: bool = False,
                    tp=None) -> Tuple[torch.Tensor, Dict]:
    """One-token MLA decode.  Writes the token's latent, k_rope and position
    into slot ``min(position, max_len - 1)`` of ``cache`` IN PLACE: the
    reference's ``dynamic_update_slice`` clamps an index past the end, so
    a token past ``max_len`` overwrites the last slot (not a ring).
    ``absorbed`` attends the latent cache directly
    (``_mla_attend_absorbed``), as the reference's decode does.  Under
    ``tp`` (a ``launch.tp.ModelParallel``) the rank's heads
    (``_tp_mla_params``: its piece of the q latent gathered whole, its
    ``w_uq`` / ``w_ukv`` / ``w_o`` heads) against the whole latent cache,
    which ``w_dkv`` and ``kv_norm``, read whole, fill alike on every rank;
    ``w_o``'s partial sums reduced."""
    b = x.shape[0]
    pos_b = torch.full((b, 1), position, dtype=torch.int64, device=x.device)
    if tp is not None:
        params = _tp_mla_params(params, cfg, tp)
        x = tp.copy(x)
    q, c_kv, k_rope = _mla_qkv(params, x, cfg, pos_b, tp)
    slot = min(position, cache["c_kv"].shape[1] - 1)
    cache["c_kv"][:, slot] = c_kv[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, slot] = k_rope[:, 0].to(cache["k_rope"].dtype)
    cache["pos"][:, slot] = position
    cpos = cache["pos"]
    mask = ((cpos >= 0) & (cpos <= position))[:, None, :]
    if absorbed:
        y = _mla_attend_absorbed(params, q, cache["c_kv"], cache["k_rope"],
                                 mask, cfg)
    else:
        y = _mla_attend(params, q, cache["c_kv"].to(x.dtype),
                        cache["k_rope"].to(x.dtype), mask, cfg)
    return (y if tp is None else tp.reduce(y)), cache


def _mla_attend_absorbed(params, q, c_kv, k_rope, mask, cfg: ArchConfig):
    """W_UK folded into the query and W_UV into the output, so the latent
    cache is attended directly, in f32; the output cast to q's dtype before
    ``w_o``.  The same function as ``_mla_attend`` (associativity)."""
    m = cfg.mla
    w_uk, w_uv = torch.split(params["w_ukv"],
                             [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    q_lat = torch.einsum("bthk,rhk->bthr", q_nope.float(), w_uk.float())
    scores = (torch.einsum("bthr,bsr->bhts", q_lat, c_kv.float())
              + torch.einsum("bthk,bsk->bhts", q_rope.float(),
                             k_rope.float())) * _mla_scale(cfg)
    scores = torch.where(mask[:, None] if mask.dim() == 3 else mask, scores,
                         torch.full((), -1e30, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhts,bsr->bthr", probs, c_kv.float())
    out = torch.einsum("bthr,rhv->bthv", ctx, w_uv.float())
    return torch.einsum("bthv,hvd->btd", out.to(q.dtype), params["w_o"])


# ---------------------------------------------------------------------------
# MoE -- top-k capacity-based dispatch (einsum experts)
# ---------------------------------------------------------------------------


def moe_init(gen, cfg: ArchConfig, dtype=torch.float32, device="cpu") -> Dict:
    moe = cfg.moe
    d = cfg.d_model
    e, ff = moe.num_experts, moe.d_ff_expert
    p = {
        "router": _dense_init(gen, (d, e), dtype, device, scale=0.02),
        "w_gate": _dense_init(gen, (e, d, ff), dtype, device),
        "w_up": _dense_init(gen, (e, d, ff), dtype, device),
        "w_down": _dense_init(gen, (e, ff, d), dtype, device),
    }
    if moe.num_shared_experts:
        p["shared"] = mlp_init(gen, d, moe.num_shared_experts *
                               (moe.d_ff_shared or moe.d_ff_expert), dtype,
                               device)
    return p


def moe_route(params: Dict, tokens: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router of ``moe_apply`` over tokens (g, tg, d): f32 logits, a
    softmax, the top k (ties to the lower expert, as ``lax.top_k``), the
    gates renormalised with ``+ 1e-9``.  Returns probs (g, tg, e) f32,
    gates (g, tg, k) f32 and expert indices (g, tg, k) int64."""
    logits = torch.einsum("gtd,de->gte", tokens.float(),
                          params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def moe_dispatch(gate_idx: torch.Tensor, num_experts: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each (token, slot)'s position in its expert's buffer: an exclusive
    cumsum over the (token, slot) pairs, token-major; ``keep`` where it is
    below ``capacity``; and the slot table (g, e, capacity) of token ids,
    ``tg`` (the drop sentinel) where a slot holds none.  gate_idx:
    (g, tg, k).  Returns (pos, keep, slot_token)."""
    g, tg, k = gate_idx.shape
    e = num_experts
    e_onehot = torch.nn.functional.one_hot(gate_idx, e)
    flat = e_onehot.reshape(g, tg * k, e)
    pos = ((torch.cumsum(flat, dim=1) - flat).reshape(g, tg, k, e)
           * e_onehot).sum(-1)                                # (g, tg, k)
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, capacity)
    grange = torch.arange(g, device=gate_idx.device)[:, None]
    token_ids = torch.arange(tg, device=gate_idx.device).expand(g, tg)
    slot_token = torch.full((g, e, capacity + 1), tg, dtype=torch.int64,
                            device=gate_idx.device)
    for slot in range(k):
        slot_token[grange, gate_idx[:, :, slot], safe_pos[:, :, slot]] = \
            token_ids
    return pos, keep, slot_token[:, :, :capacity]


def _tp_experts(params: Dict, cfg: ArchConfig, tp) -> int:
    """The first expert of this rank's expert-parallel piece under ``tp``
    (its ``w_gate`` holds experts ``[lo, lo + e / tp)``), or -1 for the
    feature-parallel fallback (``launch.sharding.MOE_DFF_FALLBACK``: every
    expert, the rank's d_ff columns)."""
    e, ff = cfg.moe.num_experts, cfg.moe.d_ff_expert
    el, fl = params["w_gate"].shape[0], params["w_gate"].shape[-1]
    if el * tp.size == e and fl == ff:
        return tp.pos * el
    if el == e and fl * tp.size == ff:
        return -1
    raise ValueError(f"expert pieces {tuple(params['w_gate'].shape)} cut "
                     f"neither {e} experts nor their d_ff {ff} over "
                     f"{tp.size} model ranks")


def moe_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig,
              capacity_factor: float = 1.25, no_drop: bool = False,
              groups: int = 1, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-based dispatch with group-limited routing: the b*s
    tokens split into ``groups`` groups (only when they divide evenly and
    not under ``no_drop``), each with capacity ``int(capacity_factor * tg
    * k / e)`` (at least 1), or every token under ``no_drop``.  Returns
    (output in x's dtype, the Switch load-balance aux loss
    ``e * sum(me * ce) * router_aux_weight``).

    Under ``tp`` (a ``launch.tp.ModelParallel``) every rank routes every
    token from ``x`` as it is (the router replicated, the routing and the
    aux loss the same everywhere); the experts read ``tp.copy(x)``.  A rank
    of expert-parallel pieces keeps its experts' part of the slot table
    and combines the (token, slot) pairs routed to them (the others left
    out, as a dropped pair is); under the d_ff fallback it runs every
    expert on its columns (``_tp_experts``).  The gates pass through
    ``tp.copy`` (site ``tp_gates``): their gradient is partial on a rank,
    the aux loss's whole, so the router's sums to one process's.  The
    routed partial sum is reduced, then the shared experts (column / row
    parallel, ``mlp_apply``) added, in the reference's order."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    t = b * s
    g = groups if (not no_drop and t % max(groups, 1) == 0) else 1
    tg = t // g
    tokens = x.reshape(g, tg, d)
    probs, gate_vals, gate_idx = moe_route(params, tokens, cfg)

    me = probs.mean((0, 1))
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, gate_idx.reshape(-1),
        torch.ones((gate_idx.numel(),), dtype=torch.float32,
                   device=x.device)) / (t * k)
    aux = e * torch.sum(me * ce) * moe.router_aux_weight

    capacity = tg if no_drop else max(1, int(capacity_factor * tg * k / e))
    pos, keep, slot_token = moe_dispatch(gate_idx, e, capacity)
    gate_vals = gate_vals * keep
    # this rank's experts [lo, lo + el) (all of them without tp or under
    # the d_ff fallback)
    lo, el, expert_tokens = 0, e, tokens
    if tp is not None:
        gate_vals = tp.copy(gate_vals, site="tp_gates")
        expert_tokens = tp.copy(tokens)
        first = _tp_experts(params, cfg, tp)
        if first >= 0:
            lo, el = first, params["w_gate"].shape[0]
            slot_token = slot_token[:, lo:lo + el]

    # the gather of token vectors by the slot table; token id tg reads the
    # zero row appended as its sentinel
    tokens_pad = torch.cat([expert_tokens,
                            tokens.new_zeros((g, 1, d))], dim=1)
    grange = torch.arange(g, device=x.device)[:, None]
    expert_in = tokens_pad[grange, slot_token.reshape(g, el * capacity)
                           ].reshape(g, el, capacity, d)
    del tokens_pad
    h = _act(torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"]),
             cfg.act)
    h = h * torch.einsum("gecd,edf->gecf", expert_in, params["w_up"])
    del expert_in
    flat_out = torch.einsum("gecf,efd->gecd", h, params["w_down"]
                            ).reshape(g, el * capacity, d)
    del h
    # combine slot by slot in x's dtype; a dropped (token, slot) adds
    # nothing (the reference reads its zero sentinel slot ``capacity``),
    # nor does one routed to another rank's expert
    y = torch.zeros((g, tg, d), dtype=x.dtype, device=x.device)
    for slot in range(k):
        ex = gate_idx[:, :, slot] - lo
        mine = keep[:, :, slot]
        if el != e:
            mine = mine & (ex >= 0) & (ex < el)
            ex = torch.where(mine, ex, 0)
        idx = ex * capacity + torch.where(mine, pos[:, :, slot], 0)
        picked = flat_out[grange, idx]
        y = y + torch.where(mine[..., None], picked * gate_vals[
            :, :, slot, None].to(x.dtype), 0)
    if tp is not None:
        y = tp.reduce(y)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], tokens, cfg.act, tp)
    return y.reshape(b, s, d), aux
