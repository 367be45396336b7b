"""deepseek-v2-lite-16b — MLA + MoE [arXiv:2405.04434].

27L d_model=2048 16H vocab=102400; MLA kv_lora=512 (+64 rope); MoE: layer 0
dense (d_ff 10944), layers 1-26: 64 routed top-6 + 2 shared (d_ff 1408).
The assignment line lists both "64e top-6" and "160 routed"; the HF config
for V2-Lite is 64 routed (160 belongs to full V2) — see DESIGN.md.
64 experts / 16-way model axis -> expert parallelism (4 experts/shard).
"""
import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,          # MLA: latent KV shared; heads for q
    head_dim=128,             # v head dim
    d_ff=1408,
    vocab_size=102400,
    mixer="mla",
    mla=MLAConfig(kv_lora=512, qk_nope=128, qk_rope=64, v_dim=128),
    mlp="swiglu",
    norm="rms",
    rope_theta=1e4,
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408, num_shared=2,
                  shared_d_ff=2816, capacity_factor=1.25,
                  normalize_weights=False, routed_scale=1.0,
                  expert_sharding="ep"),
    moe_dense_layers=(0,),
    dense_d_ff=10944,
    scan_layers=True,
    remat="save_boundaries",
    max_seq_len=32768,
    rules_overrides={"experts": "model", "expert_mlp": None},
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-lite-smoke", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16,
        mla=MLAConfig(kv_lora=32, qk_nope=16, qk_rope=8, v_dim=16),
        d_ff=96, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=96, num_shared=2,
                      shared_d_ff=192, normalize_weights=False,
                      expert_sharding="ep"),
        moe_dense_layers=(0,), dense_d_ff=256,
        remat="none", max_seq_len=256)
