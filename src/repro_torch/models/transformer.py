"""Decoder and encoder-decoder stacks: port of ``repro.models.transformer``
for the dense GQA path (with Gemma-2's local/global windows, softcaps and
post-norms), the Mamba-2 path (``mamba`` layers, ``models.mamba``), the
vision-patch frontend (InternVL2: patch embeddings ahead of the tokens) and
the encoder-decoder (Seamless-M4T: ``encode`` over frame embeddings, then
decoder blocks with cross-attention and a cross K/V cache).  MoE and MLA
archs raise ``NotImplementedError``.

The parameter tree has the reference's layout exactly — ``embed``,
``final_norm``, optional ``head``, ``stack``: a tuple of one block dict
per layer of a period, every leaf stacked over ``n_periods``, and for an
encoder-decoder ``encoder``: ``{"stack": (block,), "final_norm"}`` — so
the reference's parameters carry over leaf by leaf (``params_from_numpy``).
Where the reference scans over periods, this loops over them.

Public API
----------
    init_params(gen, cfg, dtype, device)        -> params tree
    params_from_numpy(tree, device)             -> params tree
    encode(params, cfg, frames)                 -> encoder memory
    forward(params, cfg, batch)                 -> (logits, aux_loss)
    make_loss_fn(cfg)                           -> loss_fn(params, batch, rng)
    init_cache(cfg, batch, max_len, dtype)      -> cache
    prefill(params, cfg, batch)                 -> (logits, cache)
    decode_step(params, cfg, token, cache)      -> (logits, cache)

The cache is a plain dict with the reference's key paths: ``position``,
``prefix`` (empty on the ported paths) and ``stack``, one dict per layer of
a period with every leaf stacked over periods: a ring-buffer KV cache for an
attention layer, the conv window and SSM state for a ``mamba`` layer, and
for an encoder-decoder the memory's ``cross_k`` / ``cross_v``.
``position`` is a 0-dim int32 tensor kept on the CPU: the decode step needs
it on the host to pick the ring slot, and a device copy would cost a
synchronisation per step.
``decode_step`` updates the cache's tensors in place.  Prefill and decode
run under ``torch.inference_mode()``: no autograd tape is recorded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import modules as nn
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class ApplyOptions:
    """Knobs threaded through the apply path (no param-structure impact)."""

    # "reference" (mha_attend / attend_chunked; ssd_chunked in a mamba
    # layer) or "kernel" (the flash-attention op, and in a mamba layer the
    # SSD-scan op: the CUDA kernels on the card); the reference calls the
    # latter "pallas"
    attn_impl: str = "reference"


DEFAULT_OPTS = ApplyOptions()


@dataclasses.dataclass(frozen=True)
class StackPlan:
    num_prefix: int          # unscanned leading layers (0 on the ported paths)
    period: int              # layers per stacked step
    n_periods: int


def _check_ported(cfg: ArchConfig) -> None:
    """MoE and MLA blocks (Mixtral, DeepSeek-V2, the Jamba hybrid) are later
    slices of the port: they raise, naming the block."""
    later = [name for name, v in (("MoE", cfg.moe), ("MLA", cfg.mla))
             if v is not None]
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} blocks are not ported yet "
            f"(ROADMAP.md, Queue 1); the port runs dense GQA and mamba "
            f"layers, the vision-patch frontend and the encoder-decoder")


def stack_plan(cfg: ArchConfig) -> StackPlan:
    _check_ported(cfg)
    period = len(cfg.layer_pattern)
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into periods of {period}")
    return StackPlan(0, period, cfg.num_layers // period)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ArchConfig, kind: str, dtype=torch.float32,
               device="cpu", cross: bool = False) -> Dict:
    """One block's parameters.  A ``mamba`` block keeps the reference's
    ``ln2`` leaf, which its forward never reads, and has no ``ffn`` when
    ``d_ff == 0``, so the tree has the reference's key paths.  ``cross``
    (an encoder-decoder's decoder block) adds ``cross_ln`` and
    ``cross_attn``."""
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": nn.rmsnorm_init(d, dtype, device),
                         "ln2": nn.rmsnorm_init(d, dtype, device)}
    if kind == "mamba":
        p["mixer"] = mamba_mod.mamba_init(gen, cfg, dtype, device)
    else:
        p["mixer"] = nn.attention_init(gen, cfg, dtype, device)
    if cfg.d_ff > 0:
        p["ffn"] = nn.mlp_init(gen, d, cfg.d_ff, dtype, device)
    if cfg.final_logit_softcap is not None:  # gemma2 family: post-norms
        p["post_ln1"] = nn.rmsnorm_init(d, dtype, device)
        p["post_ln2"] = nn.rmsnorm_init(d, dtype, device)
    if cross:
        p["cross_ln"] = nn.rmsnorm_init(d, dtype, device)
        p["cross_attn"] = nn.attention_init(gen, cfg, dtype, device,
                                            cross=True)
    return p


def block_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, kind: str,
                *, memory: Optional[torch.Tensor] = None,
                opts: ApplyOptions = DEFAULT_OPTS,
                causal: bool = True) -> torch.Tensor:
    """Full-sequence pre-norm block; with ``memory``, a decoder block's
    cross-attention over it (on the reference route, as in the
    reference)."""
    h = nn.rmsnorm_apply(params["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        mix = mamba_mod.mamba_apply(params["mixer"], h, cfg,
                                    impl=_ssd_impl(opts))
    else:
        mix = nn.attention_apply(params["mixer"], h, cfg, layer_kind=kind,
                                 causal=causal, attn_impl=opts.attn_impl)
    return _block_rest(params, x, mix, cfg, cross=_cross(params, cfg, memory))


def _cross(params: Dict, cfg: ArchConfig, memory: Optional[torch.Tensor]):
    """A decoder block's full-sequence cross-attention over ``memory`` as a
    function of the normed residual (``None`` without memory): the
    reference calls ``attention_apply(kv_override=...)`` without
    ``attn_impl``, so it always takes the reference route."""
    if memory is None or "cross_attn" not in params:
        return None
    return lambda h: nn.attention_apply(params["cross_attn"], h, cfg,
                                        kv_override=memory)


def _ssd_impl(opts: ApplyOptions) -> str:
    return "kernel" if opts.attn_impl == "kernel" else "reference"


def _block_rest(params: Dict, x: torch.Tensor, mix: torch.Tensor,
                cfg: ArchConfig, *, cross=None) -> torch.Tensor:
    """The block after its mixer: (post-norm,) residual, the
    cross-attention ``cross`` (a function of the normed residual, for a
    decoder block), then the FFN."""
    if "post_ln1" in params:
        mix = nn.rmsnorm_apply(params["post_ln1"], mix, cfg.norm_eps)
    x = x + mix
    if cross is not None:
        x = x + cross(nn.rmsnorm_apply(params["cross_ln"], x, cfg.norm_eps))
    if "ffn" in params:
        h = nn.rmsnorm_apply(params["ln2"], x, cfg.norm_eps)
        ff = nn.mlp_apply(params["ffn"], h, cfg.act)
        if "post_ln2" in params:
            ff = nn.rmsnorm_apply(params["post_ln2"], ff, cfg.norm_eps)
        x = x + ff
    return x


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device="cpu") -> Dict:
    """Random parameters from ``gen`` (a generator on ``device``).  Each
    stacked leaf is allocated once and filled layer by layer, so the peak is
    the weights plus one layer (the values are those of stacking the
    per-layer trees)."""
    plan = stack_plan(cfg)
    d = cfg.d_model
    vp = cfg.padded_vocab_size
    params: Dict[str, Any] = {
        "embed": nn._dense_init(gen, (vp, d), dtype, device, scale=0.02),
        "final_norm": nn.rmsnorm_init(d, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = nn._dense_init(gen, (d, vp), dtype, device)
    cross = cfg.encdec is not None
    params["stack"] = _stacked_init(
        lambda i: block_init(gen, cfg, cfg.pattern_for_layer(i), dtype,
                             device, cross=cross),
        plan.period, plan.n_periods)
    if cross:
        params["encoder"] = {
            "stack": _stacked_init(
                lambda i: block_init(gen, cfg, "global", dtype, device),
                1, cfg.encdec.num_encoder_layers),
            "final_norm": nn.rmsnorm_init(d, dtype, device),
        }
    return params


def _stacked_init(make_block, period: int, n_periods: int) -> Tuple:
    """``period`` block trees, each leaf stacked over ``n_periods``: blocks
    are drawn period by period, layer by layer (``make_block(i)``), and
    copied into their slot of a leaf allocated once."""
    stacked = [None] * period
    for p in range(n_periods):
        for i in range(period):
            blk = make_block(i)
            if stacked[i] is None:
                stacked[i] = tree_map(lambda t: t.new_empty(
                    (n_periods, *t.shape)), blk)
            tree_map(lambda dst, t: dst[p].copy_(t), stacked[i], blk)
    return tuple(stacked)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """The reference's parameters (numpy arrays under the same key paths,
    e.g. ``jax.tree.map(np.asarray, params)``) as the port's tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True))
                    .to(device), tree)


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.final_logit_softcap is not None:  # gemma family scales embeddings
        # sqrt(d) rounded to the activation dtype first, as the reference
        # does (jnp.asarray(..., x.dtype)); the rounded value, exact in
        # x.dtype, then scales on the host side of the op, so the product
        # rounds once in both frameworks (bf16 at d = 4608: 68.0, not 67.88)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def _head(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = nn.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["head"])
    logits = nn.softcap(logits, cfg.final_logit_softcap)
    if cfg.padded_vocab_size != cfg.vocab_size:   # mask vocab-padding ids
        pad_ids = torch.arange(logits.shape[-1],
                               device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_ids, -1e30)
    return logits


def _run_stack(params, cfg: ArchConfig, x: torch.Tensor, *, memory=None,
               causal=True, opts: ApplyOptions = DEFAULT_OPTS) -> torch.Tensor:
    plan = stack_plan(cfg)
    for i, layer in _per_layer(params["stack"], plan.n_periods):
        x = block_apply(layer, x, cfg, cfg.pattern_for_layer(i),
                        memory=memory, opts=opts, causal=causal)
    return x


def encode(params, cfg: ArchConfig, frames: torch.Tensor,
           opts: ApplyOptions = DEFAULT_OPTS) -> torch.Tensor:
    """The encoder of an encoder-decoder over ``frames`` (b, enc_len, d),
    the frontend's precomputed embeddings: non-causal global blocks (their
    attention on the flash kernel under ``attn_impl="kernel"``), then the
    encoder's final norm."""
    enc = params["encoder"]
    x = frames
    for _, layer in _per_layer(enc["stack"],
                               cfg.encdec.num_encoder_layers):
        x = block_apply(layer, x, cfg, "global", opts=opts, causal=False)
    return nn.rmsnorm_apply(enc["final_norm"], x, cfg.norm_eps)


def _trunk_inputs(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                  opts: ApplyOptions):
    """``(x, memory)``: the token embeddings, with a vision frontend's patch
    embeddings ahead of them, and an encoder-decoder's encoder memory
    (``None`` otherwise)."""
    memory = None
    if cfg.encdec is not None:
        memory = encode(params, cfg, batch["frames"], opts)
    x = _embed(params, cfg, batch["tokens"])
    if cfg.frontend is not None and cfg.frontend.kind == "vision_patches":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x, memory


def _per_layer(stack, n_periods: int):
    """``(i, tree)`` for every layer in order, ``i`` its index in the
    period and ``tree`` views into the stacked leaves (params or cache).
    Each leaf is unbound once: in training its backward is then one stack
    of the per-layer grads, not one full-size zero-fill per layer."""
    per_block = []
    for blk in stack:
        leaves, treedef = tree_flatten(blk)
        per_block.append((treedef, [leaf.unbind(0) for leaf in leaves]))
    for p in range(n_periods):
        for i, (treedef, unbound) in enumerate(per_block):
            yield i, tree_unflatten(treedef, [u[p] for u in unbound])


def forward_hidden(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
                   opts: ApplyOptions = DEFAULT_OPTS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trunk only: final hidden states over the token positions (pre-head)
    and the aux loss (0 on the ported paths).  ``batch`` keys by family:
    text ``tokens`` (b, s); vlm ``patch_embeds`` (b, p, d) and ``tokens``;
    audio ``frames`` (b, enc_len, d) and ``tokens`` (b, dec_len)."""
    n_text = batch["tokens"].shape[1]
    x, memory = _trunk_inputs(params, cfg, batch, opts)
    x = _run_stack(params, cfg, x, memory=memory, opts=opts)
    return (x[:, -n_text:],
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            opts: ApplyOptions = DEFAULT_OPTS
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (logits over the token part, aux loss)."""
    x, aux = forward_hidden(params, cfg, batch, opts=opts)
    return _head(params, cfg, x), aux


LOSS_CHUNK = 512     # sequence positions per head/loss chunk


def make_loss_fn(cfg: ArchConfig, opts: ApplyOptions = DEFAULT_OPTS,
                 loss_chunk: int = LOSS_CHUNK):
    """Next-token cross-entropy, the head and logsumexp taken over
    ``loss_chunk``-position slices so the peak logits tensor is
    (b, chunk, vocab).  Signature matches ``repro_torch.core.dfl.LossFn``."""

    def loss_fn(params, batch, rng):
        del rng
        x, aux = forward_hidden(params, cfg, batch, opts=opts)
        xs = x[:, :-1]                                       # predict t+1
        targets = batch["tokens"][:, 1:]
        b, sm1, _ = xs.shape
        chunk = min(loss_chunk, sm1)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, sm1, chunk):
            logits = _head(params, cfg, xs[:, lo:lo + chunk]).float()
            t_c = targets[:, lo:lo + chunk]
            lse = torch.logsumexp(logits, dim=-1)            # (b, chunk)
            tgt = torch.gather(logits, -1, t_c[..., None])[..., 0]
            total = total + (lse - tgt).sum()
        nll_mean = total / (b * sm1)
        return nll_mean + aux, {"nll": nll_mean, "aux": aux}

    return loss_fn


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu",
               enc_len: Optional[int] = None) -> Dict:
    """An empty cache for ``batch`` sequences of up to ``max_len`` tokens;
    an encoder-decoder's cross K/V hold ``enc_len`` memory positions
    (default ``int(max_len * encoder_len_ratio)``, as the reference)."""
    plan = stack_plan(cfg)

    def stacked(i):
        kind = cfg.pattern_for_layer(i)
        if kind == "mamba":
            one = mamba_mod.mamba_cache_init(cfg, batch, dtype, device)
        else:
            one = nn.attention_cache_init(cfg, batch, max_len, kind, dtype,
                                          device)
        blk = {"mixer": one}
        if cfg.encdec is not None:
            n = (int(max_len * cfg.encdec.encoder_len_ratio)
                 if enc_len is None else enc_len)
            shape = (batch, n, cfg.num_kv_heads, cfg.resolved_head_dim())
            blk["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
            blk["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
        return tree_map(lambda t: t[None].repeat(
            plan.n_periods, *([1] * t.dim())), blk)

    return {"position": torch.zeros((), dtype=torch.int32),
            "prefix": (),
            "stack": tuple(stacked(i) for i in range(plan.period))}


def _block_decode(params, cache, x, cfg: ArchConfig, kind: str,
                  position: int) -> torch.Tensor:
    """One block of a decode step; writes its k/v (an attention layer) or
    its conv window and SSM state (a mamba layer) into ``cache``."""
    h = nn.rmsnorm_apply(params["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        mix, _ = mamba_mod.mamba_decode_step(params["mixer"], h,
                                             cache["mixer"], cfg)
    else:
        mix, _ = nn.attention_decode_step(params["mixer"], h, cache["mixer"],
                                          position, cfg, layer_kind=kind)
    cross = None
    if "cross_k" in cache:
        def cross(hh):
            return nn.cross_attention_decode_step(
                params["cross_attn"], hh, cache["cross_k"], cache["cross_v"])
    return _block_rest(params, x, mix, cfg, cross=cross)


@torch.inference_mode()
def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One synchronous decode step. token: (b, 1) int.  Updates ``cache``'s
    tensors in place and returns ``(logits (b, 1, v), cache)`` with
    ``position`` advanced by one."""
    plan = stack_plan(cfg)
    position = int(cache["position"])
    x = _embed(params, cfg, token)
    for (i, layer), (_, layer_cache) in zip(
            _per_layer(params["stack"], plan.n_periods),
            _per_layer(cache["stack"], plan.n_periods)):
        x = _block_decode(layer, layer_cache, x, cfg,
                          cfg.pattern_for_layer(i), position)
    cache["position"] = torch.tensor(position + 1, dtype=torch.int32)
    return _head(params, cfg, x), cache


@torch.inference_mode()
def prefill(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            max_len: Optional[int] = None, cache_dtype=torch.bfloat16,
            opts: ApplyOptions = DEFAULT_OPTS) -> Tuple[torch.Tensor, Dict]:
    """Run the full prompt and build a cache ready for decode: per layer,
    the full-sequence block whose attention goes through
    ``dispatch_attend(attn_impl=opts.attn_impl)``, recording its K/V (padded
    to the cache, or the last ``n`` keys in ring order where the cache is
    shorter than the sequence: a sliding-window layer, or any layer when
    ``max_len`` is shorter); a mamba layer's ``mamba_prefill`` (its scan on
    kernel 9 under ``attn_impl="kernel"``) records its conv window and final
    SSM state.  ``batch`` as ``forward_hidden`` takes it: a vision
    frontend's patches sit ahead of the tokens and count as positions
    (``max_len`` defaults to the token count, as in the reference); an
    encoder-decoder encodes ``frames`` first, and each decoder block's
    cross-attention (reference route) records the memory's K/V without their
    biases, as the reference's prefill does.  Returns the last position's
    logits (b, 1, v)."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    max_len = max_len or tokens.shape[1]
    x, memory = _trunk_inputs(params, cfg, batch, opts)
    seq = x.shape[1]
    plan = stack_plan(cfg)
    cache = init_cache(cfg, b, max_len, cache_dtype, x.device,
                       enc_len=None if memory is None else memory.shape[1])
    positions = torch.arange(seq, device=x.device).expand(b, seq)
    for (i, layer), (_, layer_cache) in zip(
            _per_layer(params["stack"], plan.n_periods),
            _per_layer(cache["stack"], plan.n_periods)):
        h = nn.rmsnorm_apply(layer["ln1"], x, cfg.norm_eps)
        slots = layer_cache["mixer"]
        kind = cfg.pattern_for_layer(i)
        if kind == "mamba":
            mix, filled = mamba_mod.mamba_prefill(
                layer["mixer"], h, cfg, conv_cache_dtype=slots["conv"].dtype,
                impl=_ssd_impl(opts))
        else:
            mix, k, v = nn.attention_apply_kv(
                layer["mixer"], h, cfg, layer_kind=kind, positions=positions,
                attn_impl=opts.attn_impl)
            filled = _attention_fill(k, v, positions, slots["k"].shape[1],
                                     cache_dtype)
        for key, val in filled.items():
            slots[key].copy_(val)
        if memory is not None:
            ck, cv = nn.cross_kv(layer["cross_attn"], memory, bias=False)
            layer_cache["cross_k"].copy_(ck)
            layer_cache["cross_v"].copy_(cv)
        x = _block_rest(layer, x, mix, cfg,
                        cross=_cross(layer, cfg, memory))
    cache["position"] = torch.tensor(seq, dtype=torch.int32)
    return _head(params, cfg, x[:, -1:]), cache


def _attention_fill(k, v, positions, n: int, cache_dtype) -> Dict:
    """An attention layer's cache slots after the prompt: its K/V padded to
    the cache's ``n`` slots, or the last ``n`` keys in ring order for a
    sliding-window layer shorter than the prompt."""
    if n >= k.shape[1]:
        return {"k": _pad_to(k, n), "v": _pad_to(v, n),
                "pos": _pad_to(positions, n, fill=-1)}
    return _ring_pack(k, v, positions, n, cache_dtype)


def _pad_to(arr: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """``arr`` padded with ``fill`` along axis 1 to length ``n``."""
    if arr.shape[1] == n:
        return arr
    pad = arr.new_full((arr.shape[0], n - arr.shape[1], *arr.shape[2:]),
                       fill)
    return torch.cat([arr, pad], dim=1)


def _ring_pack(k, v, positions, n, cache_dtype) -> Dict:
    """Pack the last ``n`` keys of a longer prompt into ring order: the
    entry of position p sits at slot p % n."""
    kk, vv, pp = k[:, -n:], v[:, -n:], positions[:, -n:]
    order = torch.argsort(pp[0] % n)
    return {"k": kk[:, order].to(cache_dtype),
            "v": vv[:, order].to(cache_dtype),
            "pos": pp[:, order].to(torch.int32)}
