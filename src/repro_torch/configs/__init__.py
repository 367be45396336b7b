"""Architecture registry: --arch <id> -> ModelConfig (full or smoke).

All ten assigned architectures from the public pool, with the exact shapes
from the assignment (see each module's docstring for its source).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.configs import (deepseek_v2_lite_16b, gemma3_1b, hymba_1_5b,
                           mistral_large_123b, nemotron_4_15b,
                           qwen2_moe_a27b, qwen2_vl_7b, rwkv6_7b,
                           starcoder2_7b, whisper_small)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "rwkv6-7b": rwkv6_7b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "gemma3-1b": gemma3_1b,
    "starcoder2-7b": starcoder2_7b,
    "nemotron-4-15b": nemotron_4_15b,
    "mistral-large-123b": mistral_large_123b,
    "whisper-small": whisper_small,
    "hymba-1.5b": hymba_1_5b,
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}")
    mod = _MODULES[arch]
    return mod.smoke() if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}
