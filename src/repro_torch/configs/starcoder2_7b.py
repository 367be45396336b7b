"""starcoder2-7b — GQA + RoPE, non-gated GELU MLP [arXiv:2402.19173].

32L d_model=4608 36H (kv=4) d_ff=18432 vocab=49152; LayerNorm with bias.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    mixer="gqa",
    mlp="gelu",
    norm="layernorm",
    use_qkv_bias=True,
    rope_theta=1e5,
    scan_layers=True,
    remat="save_boundaries",
    max_seq_len=32768,
    rules_overrides={"kv_heads": None, "cache_heads": None,
                     "heads": None, "act_heads": None},
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="starcoder2-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        remat="none", max_seq_len=256)
