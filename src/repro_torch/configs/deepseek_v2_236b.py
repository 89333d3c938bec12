"""DeepSeek-V2 236B (21B active) [arXiv:2405.04434] — MLA (kv_lora 512) +
160 routed experts top-6 + 2 shared experts; dense first layer (d_ff 12288)."""
import dataclasses

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,             # MLA: per-head K/V expanded from the latent
    d_ff=12288,                   # dense first layer
    vocab_size=102400,
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2, d_ff_shared=1536,
                  layer_pattern="all_but_first"),
    supports_long_context=False,
    long_context_skip_reason=(
        "MLA latent KV is compact (~36 GB at 500k) but has no head axis to "
        "shard; blockwise latent-sharded attention is future work "
        "(DESIGN.md §4)"),
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-smoke", num_layers=3, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      num_shared_experts=2, d_ff_shared=64,
                      layer_pattern="all_but_first"))
