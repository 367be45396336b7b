"""Model registry: ModelConfig -> model object (TransformerLM | EncDecLM)."""
from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import TransformerLM

Model = Union[TransformerLM, EncDecLM]


def build(cfg: ModelConfig) -> Model:
    if cfg.is_encdec:
        return EncDecLM(cfg)
    return TransformerLM(cfg)
