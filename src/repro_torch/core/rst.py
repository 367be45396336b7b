"""RST address-stream generation (paper Eq. 1), host- and device-side.

The address computation is deliberately trivial — `A + (i*S) % W` — because
the paper's engine computes it "with simple arithmetic, which in turn leads
to fewer FPGA resources and potentially higher frequency".  On the GPU the
same property matters for a different reason: each CUDA block computes its own
tile offsets from the four runtime scalars, so the index arithmetic must stay
a handful of integer operations beside the loads it addresses.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.params import RSTParams
from repro_torch.device import resolve_device


def addresses_np(p: RSTParams, count: int | None = None) -> np.ndarray:
    """First `count` (default: one period, capped at N) transaction addresses."""
    if count is None:
        count = min(p.n, p.period)
    i = np.arange(count, dtype=np.int64)
    return p.a + (i * p.s) % p.w


def addresses_torch(p: RSTParams, count: int, *,
                    device: "torch.device | str | None" = None
                    ) -> torch.Tensor:
    """The first `count` addresses as an int64 tensor on `device`
    (default: the CUDA card)."""
    i = torch.arange(count, dtype=torch.int64, device=resolve_device(device))
    return p.a + (i * p.s) % p.w


def block_params(p: RSTParams, block_bytes: int) -> Tuple[int, int, int]:
    """Translate byte-level RST params into kernel tile-index terms.

    Returns (stride_blocks, wset_blocks, base_block) such that the block
    index of transaction i is `base_block + (i * stride_blocks) % wset_blocks`
    when S >= block_bytes, matching Eq. 1 at block granularity.  These three
    integers are exactly what the kernels take as runtime arguments.
    """
    if block_bytes <= 0 or block_bytes & (block_bytes - 1):
        raise ValueError(f"block_bytes must be a power of 2, got {block_bytes}")
    stride_blocks = max(1, p.s // block_bytes)
    wset_blocks = max(1, p.w // block_bytes)
    base_block = p.a // block_bytes
    return stride_blocks, wset_blocks, base_block


def checksum_ref(data: np.ndarray, p: RSTParams, elem_bytes: int) -> np.ndarray:
    """Oracle for the read-engine checksum: sum of every element each burst
    touches, over all N transactions (with wraparound repeats).

    `data` is the flat working buffer; the engine reads B bytes at each
    address T[i] and accumulates.  Used to validate the RST kernels.
    """
    flat = np.asarray(data).reshape(-1)
    epb = p.b // elem_bytes                      # elements per burst
    total = np.zeros((), dtype=np.float64)
    addrs = p.a + (np.arange(p.n, dtype=np.int64) * p.s) % p.w
    starts = addrs // elem_bytes
    for st in starts:
        total += flat[st:st + epb].astype(np.float64).sum()
    return total
