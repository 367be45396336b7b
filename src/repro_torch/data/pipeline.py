"""Deterministic, stateless, sharded synthetic LM data pipeline.

Fault-tolerance property: batch contents are a pure function of
(seed, step, shard), so a restarted or re-sharded job resumes exactly —
no iterator state to checkpoint.  Each data-parallel shard slices its rows
from the global batch by shard index; elastic re-sharding (different
data-parallel degree after a failure) re-partitions the same global batch.

The generator is a counter-based hash (a pure numpy splitmix64, no device
state), packing documents of power-law lengths with EOS separators —
enough distributional structure for throughput-faithful benchmarking.
Batches are NumPy arrays; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

EOS = 0


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512


def global_batch_at(step: int, cfg: DataConfig) -> Dict[str, np.ndarray]:
    """The full (global_batch, seq_len) batch for `step` — pure function.

    Each row is an arithmetic token progression (stride in {1,2,3}, start
    hashed from (seed, step, row)) chopped into documents by EOS — a
    *learnable* synthetic distribution (the model can infer the stride from
    context and predict successors), unlike pure hash noise, while staying
    deterministic and stateless for fault-tolerant restarts.
    """
    b, s = cfg.global_batch, cfg.seq_len
    base = (np.uint64(cfg.seed) << np.uint64(32)) + np.uint64(step)
    row = np.arange(b, dtype=np.uint64)[:, None]
    h = _splitmix64(base * np.uint64(1_000_003) + row * np.uint64(7919))
    v = np.uint64(max(2, cfg.vocab_size - 1))
    start = (h % v).astype(np.int64)
    stride = ((h >> np.uint64(17)) % np.uint64(3)).astype(np.int64) + 1
    j = np.arange(s, dtype=np.int64)[None, :]
    tokens = ((start + stride * j) % np.int64(v)).astype(np.int32) + 1
    # EOS document boundaries, pseudo-random per row.
    doc_h = _splitmix64(h + np.uint64(13) + np.uint64(0))
    period = np.maximum(np.uint64(2), doc_h % np.uint64(2 * cfg.mean_doc_len))
    boundary = (j.astype(np.uint64) % period) == (period - np.uint64(1))
    tokens = np.where(boundary, EOS, tokens)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = EOS
    return {"tokens": tokens, "labels": labels}


def shard_batch(batch: Dict[str, np.ndarray], shard: int, num_shards: int
                ) -> Dict[str, np.ndarray]:
    b = batch["tokens"].shape[0]
    if b % num_shards:
        raise ValueError(f"global batch {b} not divisible by {num_shards}")
    per = b // num_shards
    lo = shard * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


class DataLoader:
    """Step-indexed loader with one-batch lookahead prefetch."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self._next: Optional[Tuple[int, Dict[str, np.ndarray]]] = None

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        if self._next is not None and self._next[0] == step:
            out = self._next[1]
        else:
            out = shard_batch(global_batch_at(step, self.cfg), self.shard,
                              self.num_shards)
        # Prefetch the next step eagerly (cheap on the host; a real
        # cluster would fill it on a background thread).
        self._next = (step + 1,
                      shard_batch(global_batch_at(step + 1, self.cfg),
                                  self.shard, self.num_shards))
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
