"""InternVL2-1B [arXiv:2404.16821] — Qwen2-0.5B language backbone; the
InternViT vision tower + MLP projector is the assignment's stub carve-out:
``input_specs`` feeds 256 precomputed patch embeddings at d_model."""
import dataclasses

from repro_torch.configs.base import ArchConfig, FrontendStub

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    use_bias=True,                # qwen2 family uses qkv biases
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend=FrontendStub(kind="vision_patches", num_tokens=256,
                          embed_dim=896),
    supports_long_context=False,
    long_context_skip_reason="pure full-attention backbone, uncompressed KV",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        frontend=FrontendStub(kind="vision_patches", num_tokens=16,
                              embed_dim=128))
