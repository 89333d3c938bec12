"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887] —
Mamba:attention 7:1 interleave in 8-layer blocks, MoE (16 experts top-2)
every other layer.  Attention layers use full causal attention in the
published model; Mamba layers make the arch O(1)-state for most of the
stack, so long_500k decode runs (the 9 attention layers keep a full-length
KV — 500k × 8 KV heads shards 16-way over the model axis)."""
import dataclasses

from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    # 8-layer period: attention at index 4, mamba elsewhere (1:7)
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "global", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  layer_pattern="every_2"),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
    supports_long_context=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        # keep the family (mamba + attention + MoE) at smoke scale with a
        # 2-layer period instead of the full 8-layer block
        layer_pattern=("mamba", "global"),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                      layer_pattern="every_2"),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                          chunk_size=8))
