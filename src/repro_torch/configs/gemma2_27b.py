"""Gemma2-27B [arXiv:2408.00118] — alternating local/global attention,
attn+final logit softcaps, pre+post norms, tied embeddings."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    sliding_window=4096,
    layer_pattern=("local", "global"),
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    act="gelu",
    # local layers bound half the KV; global layers shard KV heads 16-way
    supports_long_context=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="gemma2-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        sliding_window=32)
