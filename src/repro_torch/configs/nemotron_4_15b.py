"""nemotron-4-15b — GQA, squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (kv=8) d_ff=24576 vocab=256000; non-gated squared-ReLU
FFN, partial RoPE (50%), LayerNorm1p.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mixer="gqa",
    mlp="relu2",
    norm="layernorm1p",
    rope_theta=1e4,
    rope_frac=0.5,
    scan_layers=True,
    remat="save_boundaries",
    max_seq_len=32768,
    rules_overrides={"kv_heads": None, "cache_heads": None},
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="nemotron-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        remat="none", max_seq_len=256)
