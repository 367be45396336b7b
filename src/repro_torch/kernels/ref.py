"""NumPy oracles for the RST kernels.

These replay the engine semantics at tile granularity with no kernel
machinery, a copy of the reference package's oracles (repro.kernels.ref)
that the port can import without JAX.
"""
from __future__ import annotations

import numpy as np


def _tile_indices(stride: int, wset: int, base: int, n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.int64)
    return base + (i * stride) % wset


def rst_read_checksum_ref(buf: np.ndarray, stride: int, wset: int, base: int,
                          n: int, burst_rows: int) -> np.ndarray:
    """Elementwise float32 sum of every (burst_rows, LANE) tile the RST
    traversal reads; oracle for kernels.rst_read.rst_read."""
    rows, lane = buf.shape
    tiles = buf.reshape(rows // burst_rows, burst_rows, lane).astype(np.float64)
    idx = _tile_indices(stride, wset, base, n)
    out = np.zeros((burst_rows, lane), dtype=np.float64)
    # Periodic stream: count visits per tile, then one weighted sum.
    uniq, counts = np.unique(idx, return_counts=True)
    for tile_id, count in zip(uniq, counts):
        out += tiles[tile_id] * count
    return out.astype(np.float32)


def rst_write_ref(buf: np.ndarray, stride: int, wset: int, base: int,
                  n: int, burst_rows: int) -> np.ndarray:
    """Replay the write engine: tile at T[i] gets payload (i+1); last write
    wins; untouched tiles keep previous content.  Oracle for rst_write."""
    rows, lane = buf.shape
    out = buf.copy().reshape(rows // burst_rows, burst_rows, lane)
    idx = _tile_indices(stride, wset, base, n)
    # Last write wins: the final payload of tile t is 1 + max{i : T[i] = t}.
    last = {}
    for i, t in enumerate(idx):
        last[int(t)] = i + 1
    for t, payload in last.items():
        out[t] = np.asarray(payload, dtype=buf.dtype)
    return out.reshape(rows, lane)
