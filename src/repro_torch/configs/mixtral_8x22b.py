"""Mixtral-8x22B [arXiv:2401.04088] — 8-expert top-2 MoE with sliding-window
attention (window per the Mixtral family).  All layers MoE + SWA, so the KV
cache is window-bounded and long_500k decode is supported."""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                       # all FFNs are expert FFNs
    vocab_size=32768,
    sliding_window=4096,
    layer_pattern=("local",),     # SWA on every layer
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384,
                  layer_pattern="all"),
    supports_long_context=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-smoke", num_layers=2, d_model=128,
        num_heads=8, num_kv_heads=2, head_dim=16, vocab_size=512,
        sliding_window=32,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                      layer_pattern="all"))
