"""Serving step construction: decode / prefill functions + cache shardings.

The steps run eagerly on the device their parameters and cache live on,
and write the cache in place (the caller's cache is consumed, as the
reference donates it).  `abstract_cache` builds the cache on the meta
device for the dry run; `cache_shardings` gives each cache leaf its
partition spec by its dict key and rank, as the reference does by tree
path.
"""
from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch

from repro_torch.launch.mesh import MeshSharding

Pytree = Any


def make_decode_step(model, rules=None):
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens, rules)
    return decode_step


def make_prefill_step(model, rules=None):
    def prefill_step(params, batch, cache):
        if model.cfg.is_encdec:
            # enc-dec prefill: encode + teacher-forced decoder pass.
            cache = model.start_cache(params, batch["frames"], cache, rules)
            logits, _ = model.forward(params, batch, rules)
            return logits[:, -1], cache
        return model.prefill(params, batch, cache, rules)
    return prefill_step


def abstract_cache(model, batch_size: int, max_seq: int,
                   dtype=torch.bfloat16) -> Pytree:
    """The cache as meta tensors, for the dry run (no allocation): the
    shapes and dtypes of `model.init_cache`'s."""
    return model.init_cache(batch_size=batch_size, max_seq=max_seq,
                            dtype=dtype, device="meta")


def _cache_spec(key: str, ndim: int, rules: Mapping[str, Any]
                ) -> Tuple[Any, ...]:
    """Partition spec for one cache leaf, by key name + rank.

    Layout conventions (models/transformer.py, models/encdec.py):
      k, v            (B, S, KH, D)    [+leading L when stacked]
      kv_pos          (B, S)           [+L]
      c_kv, k_rope    (B, S, R)        [+L]
      wkv             (B, H, K, V)     [+L]
      shift           (B, D)           [+L]
      conv            (B, K-1, E)      [+L]
      ssm             (B, E, N)        [+L]
      self_k/v, cross_k/v (L, B, S, H, D)   (whisper; always stacked)
      index           scalar [+L]
      slot_pos        (B,)
    """
    b = rules.get("batch")
    seq = rules.get("cache_seq")
    heads = rules.get("cache_heads")
    mlp = rules.get("act_mlp")
    base = {
        "k": (4, (b, seq, heads, None)),
        "v": (4, (b, seq, heads, None)),
        "kv_pos": (2, (b, seq)),
        "c_kv": (3, (b, seq, None)),
        "k_rope": (3, (b, seq, None)),
        "wkv": (4, (b, heads, None, None)),
        "shift": (2, (b, None)),
        "conv": (3, (b, None, mlp)),
        "ssm": (3, (b, mlp, None)),
        "self_k": (4, (b, seq, heads, None)),
        "self_v": (4, (b, seq, heads, None)),
        # cross-attention K/V cover enc_seq (1500 frames) — not a power of
        # two, so never sharded on seq.
        "cross_k": (4, (b, None, heads, None)),
        "cross_v": (4, (b, None, heads, None)),
        "slot_pos": (1, (b,)),
        "index": (0, ()),
    }
    if key not in base:
        return ()
    rank, spec = base[key]
    if ndim == rank:
        return spec
    if ndim == rank + 1:                      # stacked over layers
        return (None,) + tuple(spec)
    return ()


def cache_shardings(cache_shapes: Pytree, mesh, rules) -> Pytree:
    """Shardings for every cache leaf (same tree structure).  A leaf's
    key is the innermost dict key above it; the `index` cursors, Python
    ints in the port's cache, are rank 0."""
    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        return MeshSharding(mesh, _cache_spec(
            key or "", getattr(node, "ndim", 0), rules))
    return walk(cache_shapes, None)

