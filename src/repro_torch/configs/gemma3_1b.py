"""gemma3-1b — 5:1 local:global attention [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (kv=1) head_dim=256 d_ff=6912 vocab=262144; sliding
window 512 on local layers, every 6th layer global; qk-norm; sandwich
norms; tied embeddings scaled by sqrt(d); rope 10k local / 1M global.
Sub-quadratic in practice (local layers keep ring-buffer KV; ~4 global
layers with 1 KV head) -> runs the long_500k cell.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    mixer="gqa",
    mlp="geglu",
    norm="rms",
    qk_norm=True,
    sandwich_norm=True,
    rope_theta=1e6,
    rope_local_theta=1e4,
    attn_window=512,
    global_layer_every=6,
    embed_scale=True,
    tie_embeddings=True,
    scan_layers=False,          # heterogeneous local/global layers
    remat="save_boundaries",
    sub_quadratic=True,
    max_seq_len=1 << 20,
    rules_overrides={"kv_heads": None, "heads": None,
                     "cache_heads": None, "act_heads": None},
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-smoke", num_layers=6, d_model=64, num_heads=2,
        num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=512,
        attn_window=16, global_layer_every=3, remat="none", max_seq_len=256)
