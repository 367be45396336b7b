"""Architecture configuration schema.

One `ModelConfig` instance per assigned architecture lives in
src/repro_torch/configs/<arch>.py, a copy of the reference's with the same
shapes; `smoke()` returns a reduced same-family config for CPU tests.
All structural options are data, so a single model implementation
(models/transformer.py, models/encdec.py) serves every arch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.models.moe import MoEConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    ts_rank: int = 32          # token-shift lora rank (Finch W1/W2)
    decay_rank: int = 64       # decay lora rank


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_inner: int = 0           # 0 -> d_model
    state_size: int = 16
    dt_rank: int = 0           # 0 -> ceil(d_model / 16)
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 12
    enc_seq: int = 1500        # whisper audio frames after conv stub
    enc_d_ff: int = 3072


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    mixer: str = "gqa"         # gqa | mla | rwkv6 | hymba
    mlp: str = "swiglu"        # swiglu | geglu | gelu | relu2
    norm: str = "rms"          # rms | layernorm | layernorm1p
    use_qkv_bias: bool = False
    sandwich_norm: bool = False

    rope_theta: float = 1e4
    rope_frac: float = 1.0
    rope_local_theta: Optional[float] = None     # gemma3 local layers
    mrope_sections: Optional[Tuple[int, ...]] = None
    qk_norm: bool = False
    logit_softcap: Optional[float] = None
    embed_scale: bool = False                    # multiply embed by sqrt(d)
    tie_embeddings: bool = False

    # layer pattern: window size for local layers; indices of global layers
    attn_window: Optional[int] = None
    global_layer_every: Optional[int] = None     # gemma3: every 6th global
    global_layers: Tuple[int, ...] = ()          # hymba: explicit indices

    moe: Optional[MoEConfig] = None
    moe_dense_layers: Tuple[int, ...] = ()       # deepseek: layer 0 dense
    dense_d_ff: int = 0                          # width of those layers
    mla: Optional[MLAConfig] = None
    rwkv: Optional[RWKVConfig] = None
    mamba: Optional[MambaConfig] = None
    enc_dec: Optional[EncDecConfig] = None

    max_seq_len: int = 8192                      # learned-pos table sizing
    scan_layers: bool = True
    remat: str = "save_boundaries"               # none|save_boundaries|full
    attn_kv_chunk: int = 1024                    # blockwise attention chunk
    sub_quadratic: bool = False                  # eligible for long_500k

    # Per-arch sharding-rule overrides (logical axis -> mesh axis or None).
    rules_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # 0 -> derive from global batch / mesh; else samples per microbatch step.
    microbatch: int = 0

    def __post_init__(self):
        if self.mixer in ("gqa", "hymba", "mla"):
            if self.num_heads % max(1, self.num_kv_heads):
                raise ValueError("num_heads must divide by num_kv_heads")

    @property
    def is_encdec(self) -> bool:
        return self.enc_dec is not None

    def layer_is_global(self, idx: int) -> bool:
        """True if layer `idx` uses full-context attention."""
        if self.attn_window is None:
            return True
        if self.global_layers:
            return idx in self.global_layers
        if self.global_layer_every:
            return (idx + 1) % self.global_layer_every == 0
        return False

    def rope_theta_for(self, idx: int) -> float:
        if self.rope_local_theta is not None and not self.layer_is_global(idx):
            return self.rope_local_theta
        return self.rope_theta


def params_in_millions(cfg: ModelConfig) -> float:
    from repro_torch.models.registry import build
    from repro_torch.models.common import param_count
    return param_count(build(cfg).param_specs()) / 1e6
