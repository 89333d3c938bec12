"""SeamlessM4T-large-v2 [arXiv:2308.11596] — encoder-decoder; the speech
frontend (mel + conformer feature extractor) is the assignment's stub
carve-out: ``input_specs`` feeds precomputed frame embeddings (B, T, d)."""
import dataclasses

from repro_torch.configs.base import ArchConfig, EncDecConfig, FrontendStub

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=24,                 # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    use_bias=True,
    encdec=EncDecConfig(num_encoder_layers=24, encoder_len_ratio=1.0),
    frontend=FrontendStub(kind="audio_frames", num_tokens=0, embed_dim=1024),
    supports_long_context=False,
    long_context_skip_reason=(
        "enc-dec with full bidirectional encoder attention and full decoder "
        "KV; no sliding-window/compressed variant at 500k"),
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="seamless-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        encdec=EncDecConfig(num_encoder_layers=2, encoder_len_ratio=1.0),
        frontend=FrontendStub(kind="audio_frames", num_tokens=0, embed_dim=128))
