"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family] — GQA with per-head q/k RMSNorm."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    supports_long_context=False,
    long_context_skip_reason="pure full-attention, uncompressed KV",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
