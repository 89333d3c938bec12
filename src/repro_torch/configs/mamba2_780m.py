"""Mamba2-780M [arXiv:2405.21060] — attention-free SSD (state-space duality).
O(1) decode state: the flagship long_500k architecture."""
import dataclasses

from repro_torch.configs.base import ArchConfig, MambaConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1536,
    num_heads=1,              # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                   # no separate MLP: mamba block is the mixer+ffn
    vocab_size=50280,
    layer_pattern=("mamba",),
    tie_embeddings=True,
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
    supports_long_context=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", num_layers=2, d_model=128,
        vocab_size=512,
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                          chunk_size=8))
