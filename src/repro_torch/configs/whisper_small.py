"""whisper-small — enc-dec audio backbone [arXiv:2212.04356].

12+12L d_model=768 12H d_ff=3072 vocab=51865; conv frontend is a STUB:
input_specs() provides precomputed (B, 1500, 768) frame embeddings.
Decoder positions are learned; the table is sized by max_seq_len so the
32k stress shapes lower (Whisper's real decoder context is 448 — these
cells exercise the serving system, not the speech model; see DESIGN.md).
"""
import dataclasses

from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,              # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51872,   # real 51865, padded to a multiple of 32
                        # so vocab/logits shard over the model axis
                        # (standard embedding padding)
    mixer="gqa",
    mlp="gelu",
    norm="layernorm",
    enc_dec=EncDecConfig(enc_layers=12, enc_seq=1500, enc_d_ff=3072),
    scan_layers=True,
    remat="save_boundaries",
    max_seq_len=32768,
    rules_overrides={"kv_heads": None, "cache_heads": None,
                     "heads": None, "act_heads": None},
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        enc_dec=EncDecConfig(enc_layers=2, enc_seq=30, enc_d_ff=128),
        remat="none", max_seq_len=256)
