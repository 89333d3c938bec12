"""Architecture configuration dataclasses (a copy of ``repro.configs.base``).

The port keeps its own copy so that it imports nothing of the JAX package.
Each ported architecture is a module ``repro_torch/configs/<id>.py`` exposing
``CONFIG: ArchConfig`` (the published size) and ``smoke_config()`` (a reduced
member of the same family for CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0            # per shared expert
    router_aux_weight: float = 0.01  # load-balance loss weight (kept client-local)
    # which decoder layers are MoE: "all" | "every_2" | "all_but_first"
    layer_pattern: str = "all"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba2 / SSD block."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder extras (seamless-m4t)."""

    num_encoder_layers: int = 24
    # ratio of encoder input length to the nominal shape seq_len
    encoder_len_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class FrontendStub:
    """Modality frontend carve-out: precomputed embeddings of this shape are
    fed by ``input_specs`` instead of raw pixels / waveforms."""

    kind: str                 # "vision_patches" | "audio_frames"
    num_tokens: int           # patches or frames prepended / encoded
    embed_dim: int            # must equal d_model after the (stubbed) projector


# ---------------------------------------------------------------------------
# main architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str                      # citation from the assignment table
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    # attention flavour ------------------------------------------------------
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    # per-layer attention pattern, cycled over layers. entries:
    #   "global" (full causal), "local" (sliding window), "mamba"
    layer_pattern: Sequence[str] = ("global",)
    rope_theta: float = 10_000.0
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                # silu | gelu
    # optional sub-systems ---------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendStub] = None
    # which input shapes this arch supports for decode at 500k context
    supports_long_context: bool = False
    long_context_skip_reason: str = ""

    # -- derived -------------------------------------------------------------
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        """Embedding/unembedding tables round the vocab up to a multiple of
        128 so the vocab dim shards cleanly over a 16-wide TP axis (seamless
        256206 -> 256256, mamba2 50280 -> 50304, internvl 151655 -> 151680).
        Logits for the padding ids are masked to -inf in the head; token ids
        never reach them."""
        return ((self.vocab_size + 127) // 128) * 128

    def pattern_for_layer(self, idx: int) -> str:
        return self.layer_pattern[idx % len(self.layer_pattern)]

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None:
            return False
        p = self.moe.layer_pattern
        if p == "all":
            return True
        if p == "every_2":
            return idx % 2 == 1
        if p == "all_but_first":
            return idx > 0
        raise ValueError(p)

    def param_count(self) -> int:
        """Total parameters (embedding + blocks + head), analytic."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k + shared)."""
        return _param_count(self, active_only=True)


def _attn_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    if cfg.mla is not None:
        m = cfg.mla
        q_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        p = d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * q_head          # q down/up
        p += d * (m.kv_lora_rank + m.qk_rope_head_dim)                          # kv down (+shared rope)
        p += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)  # kv up
        p += cfg.num_heads * m.v_head_dim * d                                    # out proj
        return p
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    return q + kv + o


def _mlp_params(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff  # gated: gate, up, down


def _mamba_params(cfg: ArchConfig) -> int:
    m = cfg.mamba
    d = cfg.d_model
    di = m.d_inner(d)
    nh = m.num_heads(d)
    # standard mamba2 in_proj size: d -> (2*di + 2*n_groups*d_state + nh)
    n_groups = 1
    p = d * (2 * di + 2 * n_groups * m.d_state + nh)
    p += m.d_conv * (di + 2 * n_groups * m.d_state)  # conv1d over x,B,C
    p += nh * 2                                       # A_log, D
    p += di                                           # norm
    p += di * d                                       # out_proj
    return p


def _block_params(cfg: ArchConfig, idx: int, active_only: bool) -> int:
    d = cfg.d_model
    pat = cfg.pattern_for_layer(idx)
    p = 2 * d  # two rmsnorms
    if pat == "mamba":
        p += _mamba_params(cfg)
    else:
        p += _attn_params(cfg)
    if cfg.is_moe_layer(idx):
        moe = cfg.moe
        n_live = (moe.top_k if active_only else moe.num_experts)
        p += n_live * _mlp_params(d, moe.d_ff_expert)
        p += moe.num_shared_experts * _mlp_params(d, moe.d_ff_shared or moe.d_ff_expert)
        p += d * moe.num_experts  # router
    elif pat != "mamba" or cfg.d_ff > 0:
        if cfg.d_ff > 0:
            p += _mlp_params(d, cfg.d_ff)
    return p


def _param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    p = cfg.vocab_size * d  # embedding
    if not cfg.tie_embeddings:
        p += cfg.vocab_size * d
    p += d  # final norm
    for i in range(cfg.num_layers):
        p += _block_params(cfg, i, active_only)
    if cfg.encdec is not None:
        # encoder blocks (full attention, no moe) + cross-attn in decoder
        for _ in range(cfg.encdec.num_encoder_layers):
            p += 2 * d + _attn_params(cfg) + _mlp_params(d, cfg.d_ff)
        p += cfg.num_layers * (d + _attn_params(cfg))  # cross-attn + its norm
    return p


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
