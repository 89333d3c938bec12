"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01] — dense GQA, no biases."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    use_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    supports_long_context=False,
    long_context_skip_reason="pure full-attention, uncompressed KV",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="command-r-smoke", num_layers=2, d_model=128,
        num_heads=8, num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512)
