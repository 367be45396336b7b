"""hymba-1.5b — parallel attention + Mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (kv=5) head_dim=64 d_ff=5504 vocab=32001 ssm_state=16;
sliding window 1024 on all but 3 global layers (first/middle/last); meta
tokens elided (DESIGN.md §7).  Hybrid SSM+attention -> runs long_500k.
"""
import dataclasses

from repro_torch.configs.base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    mixer="hymba",
    mamba=MambaConfig(d_inner=1600, state_size=16, dt_rank=100,
                      conv_kernel=4),
    mlp="swiglu",
    norm="rms",
    rope_theta=1e4,
    attn_window=1024,
    global_layers=(0, 15, 31),
    scan_layers=False,          # heterogeneous window pattern
    remat="save_boundaries",
    sub_quadratic=True,
    max_seq_len=1 << 20,
    rules_overrides={"kv_heads": None, "heads": None, "act_heads": None,
                     "cache_heads": None,
                     # vocab 32001 divides nothing
                     "vocab": None, "act_vocab": None},
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="hymba-smoke", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16,
        mamba=MambaConfig(d_inner=64, state_size=4, dt_rank=8, conv_kernel=4),
        d_ff=128, vocab_size=512, attn_window=16, global_layers=(0, 1),
        remat="none", max_seq_len=256)
