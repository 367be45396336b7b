"""Assigned input shapes and meta-tensor stand-ins for the dry run.

Four shapes per LM architecture (40 cells total):
  train_4k     seq 4096,    global_batch 256   -> train_step
  prefill_32k  seq 32768,   global_batch 32    -> prefill (serve)
  decode_32k   seq 32768,   global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288,  global_batch 1     -> serve_step; SSM/hybrid/
                                                  local-attention archs only

`input_specs()` returns meta tensors (shape and dtype, no storage) for
every model input — no device allocation ever happens in the dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import MeshSharding


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: long_500k needs "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins for the model inputs of this cell."""
    b = shape.global_batch
    i32 = torch.int32

    def meta(*dims, dtype=i32):
        return torch.empty(dims, dtype=dtype, device="meta")

    specs: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = meta(b, shape.seq_len)
        if shape.kind == "train":
            specs["labels"] = meta(b, shape.seq_len)
        if cfg.mrope_sections:
            specs["mrope_positions"] = meta(3, b, shape.seq_len)
        if cfg.is_encdec:
            specs["frames"] = meta(b, cfg.enc_dec.enc_seq, cfg.d_model,
                                   dtype=torch.bfloat16)
    else:
        specs["tokens"] = meta(b, 1)
        if cfg.mrope_sections:
            specs["mrope_positions"] = meta(3, b, 1)
    return specs


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, rules
                    ) -> Dict[str, MeshSharding]:
    """Shardings of the batch inputs (batch dim over pod+data)."""
    batch_rule = rules.get("batch")
    out = {}
    for k in input_specs(cfg, shape):
        if k == "mrope_positions":
            spec = (None, batch_rule, None)
        elif k == "frames":
            spec = (batch_rule, None, None)
        else:
            spec = (batch_rule, None)
        out[k] = MeshSharding(mesh, spec)
    return out
