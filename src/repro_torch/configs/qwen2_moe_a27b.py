"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) vocab=151936; 60 routed experts top-4 with
d_ff=1408 + 4 shared experts (fused width 5632).  60 % 16 != 0, so experts
use tensor-parallel FFN width sharding (expert_mlp -> model), see
DESIGN.md §Arch-applicability.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,               # per-expert width (routed)
    vocab_size=151936,
    mixer="gqa",
    mlp="swiglu",
    norm="rms",
    use_qkv_bias=True,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=60, top_k=4, expert_d_ff=1408, num_shared=4,
                  shared_d_ff=5632, capacity_factor=1.25,
                  normalize_weights=True, expert_sharding="tp"),
    scan_layers=True,
    remat="save_boundaries",
    max_seq_len=32768,
    rules_overrides={"experts": None, "expert_mlp": "model"},
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-moe-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=96, num_shared=2,
                      shared_d_ff=192, expert_sharding="tp"),
        remat="none", max_seq_len=256)
