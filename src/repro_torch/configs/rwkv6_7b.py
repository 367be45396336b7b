"""rwkv6-7b — Finch: attention-free, data-dependent decay [arXiv:2404.05892].

32L d_model=4096 d_ff=14336 vocab=65536; head_size 64 -> 64 WKV heads.
Sub-quadratic (O(1) decode state) -> runs the long_500k cell.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,           # d_model / head_size
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    mixer="rwkv6",
    mlp="relu2",            # channel-mix uses squared ReLU
    norm="layernorm",
    rwkv=RWKVConfig(head_size=64, ts_rank=32, decay_rank=64),
    scan_layers=True,
    remat="save_boundaries",
    sub_quadratic=True,
    max_seq_len=1 << 20,
    rules_overrides={"seq": None},
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="rwkv6-smoke", num_layers=2, d_model=64, num_heads=2,
        num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=512,
        rwkv=RWKVConfig(head_size=32, ts_rank=8, decay_rank=8),
        remat="none", max_seq_len=256)
