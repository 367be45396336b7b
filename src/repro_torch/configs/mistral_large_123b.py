"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (kv=8) d_ff=28672 vocab=32768; the FSDP+TP+SP stress
architecture of the pool (123B params, 2.0 TB of fp32 optimizer + bf16
weights before sharding).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    mixer="gqa",
    mlp="swiglu",
    norm="rms",
    rope_theta=1e6,
    scan_layers=True,
    remat="save_boundaries",
    max_seq_len=32768,
    microbatch=1,
    rules_overrides={"seq": "model",   # sequence-parallel residual stream
                     "kv_heads": None, "cache_heads": None},
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mistral-large-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        remat="none", max_seq_len=256, microbatch=0,
        rules_overrides={})
