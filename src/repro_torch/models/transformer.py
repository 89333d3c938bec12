"""Decoder and encoder-decoder stacks: port of ``repro.models.transformer``
for the dense GQA path (with Gemma-2's local/global windows, softcaps and
post-norms), the Mamba-2 path (``mamba`` layers, ``models.mamba``), the
vision-patch frontend (InternVL2: patch embeddings ahead of the tokens), the
encoder-decoder (Seamless-M4T: ``encode`` over frame embeddings, then
decoder blocks with cross-attention and a cross K/V cache), the MoE FFN
(Mixtral; Jamba's hybrid period of mamba and attention layers with MoE on
every other one) and MLA with a dense first layer (DeepSeek-V2).

The parameter tree has the reference's layout exactly — ``embed``,
``final_norm``, optional ``head``, ``stack``: a tuple of one block dict
per layer of a period, every leaf stacked over ``n_periods``; ``prefix``:
a tuple of unstacked blocks ahead of the stack (DeepSeek's dense first
layer, ``num_prefix`` of ``stack_plan``); and for an encoder-decoder
``encoder``: ``{"stack": (block,), "final_norm"}`` — so the reference's
parameters carry over leaf by leaf (``params_from_numpy``).  A period is
``lcm(len(layer_pattern), moe_period)`` layers, so a layer's kind and
whether its FFN is MoE are the same in every period.  Where the reference
scans over periods, this loops over them.

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
``prefix`` (one unstacked dict per prefix layer) and ``stack``, one dict
per layer of a period with every leaf stacked over periods: a ring-buffer
KV cache for an attention layer, the latent ``c_kv`` / ``k_rope`` for an
MLA layer, the conv window and SSM state for a ``mamba`` layer, and for an
encoder-decoder the memory's ``cross_k`` / ``cross_v``.
``position`` is a 0-dim int32 tensor kept on the CPU: the decode step needs
it on the host to pick the ring slot, and a device copy would cost a
synchronisation per step.
``decode_step`` updates the cache's tensors in place.  Prefill and decode
run under ``torch.inference_mode()``: no autograd tape is recorded.  Under
tensor parallelism (``ApplyOptions.tp``, ``decode_step(tp=)``, a
``launch.tp.ModelParallel``) they run a rank's pieces, cache and vocab
slice for every family; ``serve_tp_refusal`` names a Mamba or MLA head
count the axis does not divide.
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
    # exact MoE: every expert takes every token (capacity = tokens), as
    # serving and the decode tests run it; else capacity_factor * t * k / e
    # tokens an expert, the rest dropped (training)
    moe_no_drop: bool = False
    capacity_factor: float = 1.25
    # group-limited routing: the tokens split into this many groups, each
    # routed with its own capacity (not under moe_no_drop)
    moe_groups: int = 1
    # where the training forward takes its parameters from (``None``: the
    # params tree as given).  A provider has ``top(params)``, the params
    # with every leaf outside the layer stacks whole, and ``run(path,
    # layer, fn, *inputs)``, ``fn(layer_whole, *inputs)`` for the layer
    # at ``path`` (("stack", i), ("prefix", i), ("encoder", "stack", 0))
    # given its tree as the params hold it: ``launch.fsdp.ClientShards``,
    # a client cut over ranks, gathers and reduces there
    provider: Optional[Any] = None
    # tensor parallelism over "model" (``None``: none): a
    # ``launch.tp.ModelParallel``, whose rank then holds and multiplies its
    # pieces of the dense layers (heads, d_ff columns, vocab rows) and
    # reduces between them
    tp: Optional[Any] = None

    def moe_kw(self) -> Dict[str, Any]:
        return {"capacity_factor": self.capacity_factor,
                "no_drop": self.moe_no_drop, "groups": self.moe_groups}


DEFAULT_OPTS = ApplyOptions()
# a decode step's MoE, as the reference's ``_block_decode`` calls it
_DECODE_MOE = {"no_drop": True}


@dataclasses.dataclass(frozen=True)
class StackPlan:
    num_prefix: int          # unstacked leading layers (DeepSeek's dense one)
    period: int              # layers per stacked step
    n_periods: int


_MOE_PERIOD = {"all": 1, "every_2": 2, "all_but_first": 1, None: 1}


def stack_plan(cfg: ArchConfig) -> StackPlan:
    """A period of ``lcm(len(layer_pattern), moe_period)`` layers after
    ``num_prefix`` = 1 dense layer under ``all_but_first`` MoE.  A depth
    whose layers after the prefix do not fill whole periods raises (the
    reference asserts it, and truncates when asserts are stripped)."""
    pattern = cfg.moe.layer_pattern if cfg.moe else None
    num_prefix = 1 if pattern == "all_but_first" else 0
    period = math.lcm(len(cfg.layer_pattern), _MOE_PERIOD[pattern])
    rest = cfg.num_layers - num_prefix
    if rest % period:
        raise ValueError(f"{cfg.name}: {rest} layers after {num_prefix} "
                         f"prefix layer(s) do not split into periods of "
                         f"{period}")
    return StackPlan(num_prefix, period, rest // period)


def _layer_flags(cfg: ArchConfig, abs_idx: int) -> Tuple[str, bool]:
    """(kind, is_moe) of the layer at absolute index ``abs_idx``."""
    return cfg.pattern_for_layer(abs_idx), cfg.is_moe_layer(abs_idx)


def _period_flags(cfg: ArchConfig, plan: StackPlan) -> list:
    """``_layer_flags`` of each layer of a stacked period, by its index in
    the period: every period repeats them."""
    return [_layer_flags(cfg, plan.num_prefix + i) for i in range(plan.period)]


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ArchConfig, kind: str, dtype=torch.float32,
               device="cpu", cross: bool = False, *,
               is_moe: bool = False) -> Dict:
    """One block's parameters.  A ``mamba`` block keeps the reference's
    ``ln2`` leaf, which its forward never reads when it has no FFN; a block
    has an MoE ``ffn`` when ``is_moe``, else a dense one when ``d_ff > 0``
    and its kind is not ``mamba_only``, so the tree has the reference's key
    paths.  A non-mamba block of an MLA config has the MLA mixer.  As in the
    reference's code, a ``mamba_only`` block is the ATTENTION (or MLA) mixer
    with global attention and no FFN: only ``kind == "mamba"`` selects the
    SSM mixer, and only ``"local"`` a window.  ``cross`` (an
    encoder-decoder's decoder block) adds ``cross_ln`` and
    ``cross_attn``."""
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": nn.rmsnorm_init(d, dtype, device),
                         "ln2": nn.rmsnorm_init(d, dtype, device)}
    if kind == "mamba":
        p["mixer"] = mamba_mod.mamba_init(gen, cfg, dtype, device)
    elif cfg.mla is not None:
        p["mixer"] = nn.mla_init(gen, cfg, dtype, device)
    else:
        p["mixer"] = nn.attention_init(gen, cfg, dtype, device)
    if is_moe:
        p["ffn"] = nn.moe_init(gen, cfg, dtype, device)
    elif cfg.d_ff > 0 and kind != "mamba_only":
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
                *, is_moe: bool = False,
                memory: Optional[torch.Tensor] = None,
                opts: ApplyOptions = DEFAULT_OPTS,
                causal: bool = True) -> Tuple[torch.Tensor, Any]:
    """Full-sequence pre-norm block -> (x, its MoE aux loss; 0.0 without);
    with ``memory``, a decoder block's cross-attention over it (on the
    reference route, as in the reference).  An MLA mixer always takes the
    reference route (the reference gives it no ``attn_impl``)."""
    h = nn.rmsnorm_apply(params["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        mix = mamba_mod.mamba_apply(params["mixer"], h, cfg,
                                    impl=_ssd_impl(opts), tp=opts.tp)
    elif cfg.mla is not None:
        mix = nn.mla_apply(params["mixer"], h, cfg, tp=opts.tp)
    else:
        mix = nn.attention_apply(params["mixer"], h, cfg, layer_kind=kind,
                                 causal=causal, attn_impl=opts.attn_impl,
                                 tp=opts.tp)
    return _block_rest(params, x, mix, cfg,
                       cross=_cross(params, cfg, memory, opts.tp),
                       moe_kw=opts.moe_kw() if is_moe else None, tp=opts.tp)


def _cross(params: Dict, cfg: ArchConfig, memory: Optional[torch.Tensor],
           tp=None):
    """A decoder block's full-sequence cross-attention over ``memory`` as a
    function of the normed residual (``None`` without memory), on the
    rank's heads under ``tp``: the reference calls
    ``attention_apply(kv_override=...)`` without ``attn_impl``, so it
    always takes the reference route."""
    if memory is None or "cross_attn" not in params:
        return None
    return lambda h: nn.attention_apply(params["cross_attn"], h, cfg,
                                        kv_override=memory, tp=tp)


def _ssd_impl(opts: ApplyOptions) -> str:
    return "kernel" if opts.attn_impl == "kernel" else "reference"


def _block_rest(params: Dict, x: torch.Tensor, mix: torch.Tensor,
                cfg: ArchConfig, *, cross=None,
                moe_kw: Optional[Dict[str, Any]] = None, tp=None
                ) -> Tuple[torch.Tensor, Any]:
    """The block after its mixer: (post-norm,) residual, the
    cross-attention ``cross`` (a function of the normed residual, for a
    decoder block), then the FFN: ``moe_apply(**moe_kw)`` for an MoE block
    (``moe_kw`` given), else the dense MLP.  Returns (x, the MoE's aux loss;
    0.0 for a dense block, as the reference)."""
    aux = 0.0
    if "post_ln1" in params:
        mix = nn.rmsnorm_apply(params["post_ln1"], mix, cfg.norm_eps)
    x = x + mix
    if cross is not None:
        x = x + cross(nn.rmsnorm_apply(params["cross_ln"], x, cfg.norm_eps))
    if "ffn" in params:
        h = nn.rmsnorm_apply(params["ln2"], x, cfg.norm_eps)
        if moe_kw is not None:
            ff, aux = nn.moe_apply(params["ffn"], h, cfg, **moe_kw, tp=tp)
        else:
            ff = nn.mlp_apply(params["ffn"], h, cfg.act, tp)
        if "post_ln2" in params:
            ff = nn.rmsnorm_apply(params["post_ln2"], ff, cfg.norm_eps)
        x = x + ff
    return x, aux


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

    flags = _period_flags(cfg, plan)

    def layer(i):
        kind, is_moe = flags[i]
        return block_init(gen, cfg, kind, dtype, device, cross=cross,
                          is_moe=is_moe)

    params["stack"] = _stacked_init(layer, plan.period, plan.n_periods)
    if plan.num_prefix:
        # DeepSeek-style dense first layer(s), with the wide dense d_ff
        dense = dataclasses.replace(cfg, d_ff=0)
        prefix = []
        for i in range(plan.num_prefix):
            blk = block_init(gen, dense, cfg.pattern_for_layer(i), dtype,
                             device, cross=cross)
            blk["ffn"] = nn.mlp_init(gen, d, cfg.d_ff or
                                     cfg.moe.d_ff_expert * 8, dtype, device)
            prefix.append(blk)
        params["prefix"] = tuple(prefix)
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
    copied into their slot of a leaf allocated once (one period: each leaf
    is the block's own, viewed with a leading axis of 1)."""
    stacked = [None] * period
    for p in range(n_periods):
        for i in range(period):
            blk = make_block(i)
            if n_periods == 1:
                stacked[i] = tree_map(lambda t: t[None], blk)
                continue
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


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor,
           tp=None) -> torch.Tensor:
    """The token embeddings; under ``tp`` a vocab-parallel lookup in the
    rank's rows, summed over "model" (``launch.tp.ModelParallel.embed``),
    Gemma's scale after the sum."""
    x = params["embed"][tokens] if tp is None else tp.embed(
        params["embed"], tokens)
    if cfg.final_logit_softcap is not None:  # gemma family scales embeddings
        # sqrt(d) rounded to the activation dtype first, as the reference
        # does (jnp.asarray(..., x.dtype)); the rounded value, exact in
        # x.dtype, then scales on the host side of the op, so the product
        # rounds once in both frameworks (bf16 at d = 4608: 68.0, not 67.88)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def _head(params, cfg: ArchConfig, x: torch.Tensor,
          tp=None) -> torch.Tensor:
    """The final norm and the logits; under ``tp`` the rank's vocab slice
    of them (its ``embed`` rows, transposed, or ``head`` columns) after
    ``tp.copy``, the padding mask on the global ids ``v_lo + j``."""
    x = nn.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if tp is not None:
        x = tp.copy(x)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["head"])
    logits = nn.softcap(logits, cfg.final_logit_softcap)
    if cfg.padded_vocab_size != cfg.vocab_size:   # mask vocab-padding ids
        n = logits.shape[-1]
        lo = 0 if tp is None else tp.vocab_lo(n)
        pad_ids = torch.arange(lo, lo + n,
                               device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_ids, -1e30)
    return logits


def _run_stack(params, cfg: ArchConfig, x: torch.Tensor, *, memory=None,
               causal=True, opts: ApplyOptions = DEFAULT_OPTS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefix layers (dense), then the stack -> (x, the MoE layers' aux
    losses summed in f32; 0 without MoE layers)."""
    plan = stack_plan(cfg)
    flags = _period_flags(cfg, plan)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(params.get("prefix", ())):
        x, _ = _layer_apply(opts, ("prefix", i), blk, x, memory, cfg,
                            cfg.pattern_for_layer(i), False, causal)
    for i, layer in _per_layer(params["stack"], plan.n_periods):
        kind, is_moe = flags[i]
        x, a = _layer_apply(opts, ("stack", i), layer, x, memory, cfg, kind,
                            is_moe, causal)
        if is_moe:
            aux = aux + a
    return x, aux


def _layer_apply(opts: ApplyOptions, path: Tuple, layer, x: torch.Tensor,
                 memory, cfg: ArchConfig, kind: str, is_moe: bool,
                 causal: bool):
    """``block_apply`` of the layer at ``path``, through ``opts.provider``
    when there is one."""
    def fn(p, xx, mem):
        return block_apply(p, xx, cfg, kind, is_moe=is_moe, memory=mem,
                           opts=opts, causal=causal)

    if opts.provider is None:
        return fn(layer, x, memory)
    return opts.provider.run(path, layer, fn, x, memory)


def encode(params, cfg: ArchConfig, frames: torch.Tensor,
           opts: ApplyOptions = DEFAULT_OPTS) -> torch.Tensor:
    """The encoder of an encoder-decoder over ``frames`` (b, enc_len, d),
    the frontend's precomputed embeddings: non-causal global blocks (their
    attention on the flash kernel under ``attn_impl="kernel"``), then the
    encoder's final norm."""
    params = _provided(params, opts)
    enc = params["encoder"]
    x = frames
    for i, layer in _per_layer(enc["stack"],
                               cfg.encdec.num_encoder_layers):
        x, _ = _layer_apply(opts, ("encoder", "stack", i), layer, x, None,
                            cfg, "global", False, False)
    return nn.rmsnorm_apply(enc["final_norm"], x, cfg.norm_eps)


def _provided(params, opts: ApplyOptions):
    """``params`` with the leaves outside the layer stacks as
    ``opts.provider`` gives them (the tree itself without a provider, or
    when they are already given: the loss, the forward and the encoder
    take them once a call)."""
    if opts.provider is None or isinstance(params, _Provided):
        return params
    return _Provided(opts.provider.top(params))


class _Provided(dict):
    """A params tree whose top-level leaves the provider has given."""


def _trunk_inputs(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                  opts: ApplyOptions):
    """``(x, memory)``: the token embeddings, with a vision frontend's patch
    embeddings ahead of them, and an encoder-decoder's encoder memory
    (``None`` otherwise).  Under tensor parallelism the memory, whole on
    every rank, passes through ``tp.copy`` once (site ``tp_memory``): each
    decoder layer's cross-attention reads it for the rank's heads only, so
    its gradient is summed over "model" before the encoder's backward."""
    memory = None
    if cfg.encdec is not None:
        memory = encode(params, cfg, batch["frames"], opts)
        if nn.attention_tp(opts.tp) is not None:
            memory = opts.tp.copy(memory, "tp_memory")
    x = _embed(params, cfg, batch["tokens"], opts.tp)
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
    and the aux loss (the MoE layers' load-balance losses summed; 0 without
    MoE).  ``batch`` keys by family:
    text ``tokens`` (b, s); vlm ``patch_embeds`` (b, p, d) and ``tokens``;
    audio ``frames`` (b, enc_len, d) and ``tokens`` (b, dec_len)."""
    params = _provided(params, opts)
    n_text = batch["tokens"].shape[1]
    x, memory = _trunk_inputs(params, cfg, batch, opts)
    x, aux = _run_stack(params, cfg, x, memory=memory, opts=opts)
    return x[:, -n_text:], aux


def forward(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            opts: ApplyOptions = DEFAULT_OPTS
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (logits over the token part, aux loss)."""
    params = _provided(params, opts)
    x, aux = forward_hidden(params, cfg, batch, opts=opts)
    return _head(params, cfg, x, opts.tp), aux


LOSS_CHUNK = 512     # sequence positions per head/loss chunk


def make_loss_fn(cfg: ArchConfig, opts: ApplyOptions = DEFAULT_OPTS,
                 loss_chunk: int = LOSS_CHUNK):
    """Next-token cross-entropy, the head and logsumexp taken over
    ``loss_chunk``-position slices so the peak logits tensor is
    (b, chunk, vocab); the loss is the mean nll plus the aux loss.
    Signature matches ``repro_torch.core.dfl.LossFn``; its
    ``with_provider(p)`` is the same loss with ``ApplyOptions.provider``
    set to ``p`` (the rank-local epoch step binds a cut client's there),
    and ``with_tp(tp)`` with ``ApplyOptions.tp`` set to a
    ``launch.tp.ModelParallel``: the rank's logits are then its vocab
    slice, their logsumexp and target logit reduced over "model"
    (``ModelParallel.cross_entropy``).  ``with_tp`` refuses, by name, a
    Mamba head count the axis does not divide (``tp_refusal``)."""
    tp = opts.tp

    def loss_fn(params, batch, rng):
        del rng
        params = _provided(params, opts)
        x, aux = forward_hidden(params, cfg, batch, opts=opts)
        xs = x[:, :-1]                                       # predict t+1
        targets = batch["tokens"][:, 1:]
        b, sm1, _ = xs.shape
        chunk = min(loss_chunk, sm1)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, sm1, chunk):
            logits = _head(params, cfg, xs[:, lo:lo + chunk], tp).float()
            t_c = targets[:, lo:lo + chunk]
            if tp is not None:
                total = total + tp.cross_entropy(logits, t_c).sum()
                continue
            lse = torch.logsumexp(logits, dim=-1)            # (b, chunk)
            tgt = torch.gather(logits, -1, t_c[..., None])[..., 0]
            total = total + (lse - tgt).sum()
        nll_mean = total / (b * sm1)
        return nll_mean + aux, {"nll": nll_mean, "aux": aux}

    loss_fn.with_provider = lambda provider: make_loss_fn(
        cfg, dataclasses.replace(opts, provider=provider), loss_chunk)

    def with_tp(mp):
        why = tp_refusal(cfg, mp.size)
        if why is not None:
            raise ValueError(why)
        return make_loss_fn(cfg, dataclasses.replace(opts, tp=mp),
                            loss_chunk)

    loss_fn.with_tp = with_tp
    return loss_fn


def tp_refusal(cfg: ArchConfig, size: int) -> Optional[str]:
    """Why a client of ``cfg`` cannot run tensor parallel over "model"
    (``launch.tp``) on ``size`` model ranks, by name, or ``None`` for the
    dense decoders, the encoder-decoder (Seamless-M4T), the vision
    frontend (InternVL2), the MoE and MLA families (Mixtral, DeepSeek-V2)
    and Mamba-2 (Mamba2-780M; Jamba's mamba, attention and MoE layers):
    a Mamba head count ``size`` does not divide is refused (a rank runs
    whole heads).  A head count that leaves attention leaves whole beside
    cut ones is refused by ``launch.sharding.tp_refusal``."""
    plan = stack_plan(cfg)
    kinds = {k for k, _ in _period_flags(cfg, plan)}
    if "mamba" in kinds:
        nh = cfg.mamba.num_heads(cfg.d_model)
        if nh % size:
            return (f"tensor parallelism over 'model' runs a rank's Mamba "
                    f"heads: {nh} heads do not divide over {size} model "
                    f"ranks")
    return None


def serve_tp_refusal(cfg: ArchConfig, size: int) -> Optional[str]:
    """Why ``cfg`` cannot be served tensor parallel over "model" on
    ``size`` model ranks, by name, or ``None``: every family is served so
    (the attention families, the MoE family's drop-free experts on a rank,
    MLA's absorbed decode on a rank's heads, the SSM state on a rank's
    heads), but a rank runs whole Mamba heads and whole MLA heads, so a
    Mamba or MLA head count ``size`` does not divide is refused.  Attention
    heads that do not divide it run whole on every rank
    (``attn_tp=False``)."""
    why = tp_refusal(cfg, size)
    if why is not None:
        return why.replace("tensor parallelism over 'model'",
                           "serving tensor parallel over 'model'")
    if cfg.mla is not None and cfg.num_heads % size:
        return (f"serving tensor parallel over 'model' runs a rank's MLA "
                f"heads: {cfg.num_heads} heads do not divide over {size} "
                f"model ranks")
    return None


def _check_serve_tp(cfg: ArchConfig, tp) -> None:
    why = None if tp is None else serve_tp_refusal(cfg, tp.size)
    if why is not None:
        raise ValueError(why)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu",
               enc_len: Optional[int] = None, tp=None) -> Dict:
    """An empty cache for ``batch`` sequences of up to ``max_len`` tokens;
    an encoder-decoder's cross K/V hold ``enc_len`` memory positions
    (default ``int(max_len * encoder_len_ratio)``, as the reference).
    Under ``tp`` (a ``launch.tp.ModelParallel``) a rank's cache: each
    attention layer's K/V and the cross K/V hold the kv heads its q heads
    read (``models.modules.tp_kv_range``; every head under
    ``attn_tp=False``), an MLA layer's latent whole (the same on every
    rank), a mamba layer's conv window of its heads' x channels and of B
    and C and the SSM state of its heads (``mamba_cache_init(tp=)``)."""
    _check_serve_tp(cfg, tp)
    plan = stack_plan(cfg)
    kv_lo, kv_hi = nn.tp_kv_range(cfg, nn.attention_tp(tp))

    def block(kind):
        if kind == "mamba":
            one = mamba_mod.mamba_cache_init(cfg, batch, dtype, device, tp)
        elif cfg.mla is not None:
            one = nn.mla_cache_init(cfg, batch, max_len, dtype, device)
        else:
            one = nn.attention_cache_init(cfg, batch, max_len, kind, dtype,
                                          device, kv_hi - kv_lo)
        blk = {"mixer": one}
        if cfg.encdec is not None:
            n = (int(max_len * cfg.encdec.encoder_len_ratio)
                 if enc_len is None else enc_len)
            shape = (batch, n, kv_hi - kv_lo, cfg.resolved_head_dim())
            blk["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
            blk["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
        return blk

    def stacked(kind):
        return tree_map(lambda t: t[None].repeat(
            plan.n_periods, *([1] * t.dim())), block(kind))

    return {"position": torch.zeros((), dtype=torch.int32),
            "prefix": tuple(block(cfg.pattern_for_layer(i))
                            for i in range(plan.num_prefix)),
            "stack": tuple(stacked(kind)
                           for kind, _ in _period_flags(cfg, plan))}


def _block_decode(params, cache, x, cfg: ArchConfig, kind: str,
                  is_moe: bool, position: int, tp=None) -> torch.Tensor:
    """One block of a decode step; writes its k/v (an attention layer), its
    latent (MLA: the absorbed decode, as the reference's) or its conv
    window and SSM state (a mamba layer) into ``cache``.  An MoE FFN runs
    drop-free.  Under ``tp`` a block runs the rank's heads against its
    cache (attention, cross-attention, MLA, a mamba layer), the MLP its
    d_ff columns and the MoE its experts (or their d_ff columns)."""
    h = nn.rmsnorm_apply(params["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        mix, _ = mamba_mod.mamba_decode_step(params["mixer"], h,
                                             cache["mixer"], cfg, tp)
    elif cfg.mla is not None:
        mix, _ = nn.mla_decode_step(params["mixer"], h, cache["mixer"],
                                    position, cfg, absorbed=True, tp=tp)
    else:
        mix, _ = nn.attention_decode_step(params["mixer"], h, cache["mixer"],
                                          position, cfg, layer_kind=kind,
                                          tp=tp)
    cross = None
    if "cross_k" in cache:
        def cross(hh):
            return nn.cross_attention_decode_step(
                params["cross_attn"], hh, cache["cross_k"], cache["cross_v"],
                cfg, tp)
    return _block_rest(params, x, mix, cfg, cross=cross,
                       moe_kw=_DECODE_MOE if is_moe else None, tp=tp)[0]


def _layers(params, cache, cfg: ArchConfig, plan: StackPlan):
    """``(layer params, layer cache, kind, is_moe)`` for every layer in
    order: the prefix layers (dense FFN), then the stack's."""
    for i, blk in enumerate(params.get("prefix", ())):
        yield blk, cache["prefix"][i], cfg.pattern_for_layer(i), False
    flags = _period_flags(cfg, plan)
    for (i, layer), (_, layer_cache) in zip(
            _per_layer(params["stack"], plan.n_periods),
            _per_layer(cache["stack"], plan.n_periods)):
        yield (layer, layer_cache) + flags[i]


@torch.inference_mode()
def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: Dict,
                tp=None) -> Tuple[torch.Tensor, Dict]:
    """One synchronous decode step. token: (b, 1) int.  Updates ``cache``'s
    tensors in place and returns ``(logits (b, 1, v), cache)`` with
    ``position`` advanced by one.  Under ``tp`` (a
    ``launch.tp.ModelParallel``) ``params`` are the rank's pieces and
    ``cache`` its cache (``init_cache(tp=)``): the vocab-parallel
    embedding, each block on the rank's heads and d_ff columns, and the
    logits the rank's vocab slice (``ModelParallel.gather_logits`` makes
    them whole)."""
    _check_serve_tp(cfg, tp)
    plan = stack_plan(cfg)
    position = int(cache["position"])
    x = _embed(params, cfg, token, tp)
    for layer, layer_cache, kind, is_moe in _layers(params, cache, cfg, plan):
        x = _block_decode(layer, layer_cache, x, cfg, kind, is_moe, position,
                          tp)
    cache["position"] = torch.tensor(position + 1, dtype=torch.int32)
    return _head(params, cfg, x, tp), cache


@torch.inference_mode()
def prefill(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            max_len: Optional[int] = None, cache_dtype=torch.bfloat16,
            opts: ApplyOptions = DEFAULT_OPTS) -> Tuple[torch.Tensor, Dict]:
    """Run the full prompt and build a cache ready for decode: per layer,
    the full-sequence block whose attention goes through
    ``dispatch_attend(attn_impl=opts.attn_impl)``, recording its K/V (padded
    to the cache, or the last ``n`` keys in ring order where the cache is
    shorter than the sequence: a sliding-window layer, or any layer when
    ``max_len`` is shorter); an MLA layer (always the reference route)
    records its latent ``c_kv`` and ``k_rope`` (``max_len`` must cover the
    prompt, as in the reference); a mamba layer's ``mamba_prefill`` (its
    scan on kernel 9 under ``attn_impl="kernel"``) records its conv window
    and final SSM state; an MoE FFN runs with ``opts.moe_kw()``.  ``batch``
    as ``forward_hidden`` takes it: a vision frontend's patches sit ahead
    of the tokens and count as positions (``max_len`` defaults to the token
    count, as in the reference); an encoder-decoder encodes ``frames``
    first, and each decoder block's cross-attention (reference route)
    records the memory's K/V without their biases, as the reference's
    prefill does.  Returns the last position's logits (b, 1, v).  Under
    ``opts.tp`` (a ``launch.tp.ModelParallel``) ``params`` are the rank's
    pieces: every block runs the rank's heads (kernel 3 and kernel 9 on
    them on the kernel route), d_ff columns and experts, the cache is the
    rank's (``init_cache(tp=)``) and the logits its vocab slice."""
    tp = opts.tp
    _check_serve_tp(cfg, tp)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    max_len = max_len or tokens.shape[1]
    x, memory = _trunk_inputs(params, cfg, batch, opts)
    seq = x.shape[1]
    plan = stack_plan(cfg)
    cache = init_cache(cfg, b, max_len, cache_dtype, x.device,
                       enc_len=None if memory is None else memory.shape[1],
                       tp=tp)
    positions = torch.arange(seq, device=x.device).expand(b, seq)
    moe_kw = opts.moe_kw()
    for layer, layer_cache, kind, is_moe in _layers(params, cache, cfg, plan):
        h = nn.rmsnorm_apply(layer["ln1"], x, cfg.norm_eps)
        slots = layer_cache["mixer"]
        if kind == "mamba":
            mix, filled = mamba_mod.mamba_prefill(
                layer["mixer"], h, cfg, conv_cache_dtype=slots["conv"].dtype,
                impl=_ssd_impl(opts), tp=tp)
        elif cfg.mla is not None:
            mix, c_kv, k_rope = nn.mla_apply_latent(layer["mixer"], h, cfg,
                                                    positions, tp)
            if seq > slots["c_kv"].shape[1]:
                raise ValueError(f"an MLA cache of {slots['c_kv'].shape[1]} "
                                 f"positions cannot hold a {seq}-position "
                                 f"prompt")
            filled = {"c_kv": c_kv, "k_rope": k_rope, "pos": positions}
        else:
            mix, k, v = nn.attention_apply_kv(
                layer["mixer"], h, cfg, layer_kind=kind, positions=positions,
                attn_impl=opts.attn_impl, tp=tp)
            filled = _attention_fill(k, v, positions, slots["k"].shape[1],
                                     cache_dtype)
        for key, val in filled.items():
            # the slots past the prompt keep their empty values (0, pos -1)
            slots[key][:, :val.shape[1]].copy_(val)
        if memory is not None:
            ck, cv = nn.cross_cache_kv(layer["cross_attn"], memory, cfg, tp)
            layer_cache["cross_k"].copy_(ck)
            layer_cache["cross_v"].copy_(cv)
        x, _ = _block_rest(layer, x, mix, cfg,
                           cross=_cross(layer, cfg, memory, tp),
                           moe_kw=moe_kw if is_moe else None, tp=tp)
    cache["position"] = torch.tensor(seq, dtype=torch.int32)
    return _head(params, cfg, x[:, -1:], tp), cache


def _attention_fill(k, v, positions, n: int, cache_dtype) -> Dict:
    """An attention layer's cache slots after the prompt: its K/V for the
    first slots of the cache's ``n``, or the last ``n`` keys in ring order
    for a sliding-window layer shorter than the prompt."""
    if n >= k.shape[1]:
        return {"k": k, "v": v, "pos": positions}
    return _ring_pack(k, v, positions, n, cache_dtype)


def _ring_pack(k, v, positions, n, cache_dtype) -> Dict:
    """Pack the last ``n`` keys of a longer prompt into ring order: the
    entry of position p sits at slot p % n."""
    kk, vv, pp = k[:, -n:], v[:, -n:], positions[:, -n:]
    order = torch.argsort(pp[0] % n)
    return {"k": kk[:, order].to(cache_dtype),
            "v": vv[:, order].to(cache_dtype),
            "pos": pp[:, order].to(torch.int32)}
