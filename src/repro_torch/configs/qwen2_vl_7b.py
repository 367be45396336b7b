"""qwen2-vl-7b — M-RoPE, dynamic resolution [arXiv:2409.12191].

28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064.  Backbone only: the
ViT frontend is a stub; input_specs() provides token ids plus (3, B, S)
M-RoPE position ids (temporal/height/width); patch embeds may be passed as
`embeds` to replace token embedding lookups.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    mixer="gqa",
    mlp="swiglu",
    norm="rms",
    use_qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    scan_layers=True,
    remat="save_boundaries",
    max_seq_len=32768,
    rules_overrides={"kv_heads": None, "cache_heads": None,
                     "heads": None, "act_heads": None},  # 28 q / 4 kv heads not divisible by 16
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        mrope_sections=(2, 3, 3), remat="none", max_seq_len=256)
