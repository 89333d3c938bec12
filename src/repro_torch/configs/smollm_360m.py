"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-135M family] — llama-style small."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    supports_long_context=False,
    long_context_skip_reason="pure full-attention, uncompressed KV",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="smollm-smoke", num_layers=2, d_model=120,
        num_heads=3, num_kv_heads=1, head_dim=40, d_ff=256, vocab_size=512)
