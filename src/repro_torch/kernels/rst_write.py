"""RST write engine (paper Sec. III-C-1, write module) as a CUDA kernel.

Port of the Pallas TPU kernel ``repro.kernels.rst_write.rst_write``.  One
RST transaction fills the ``(burst_rows, 128)`` tile at block index
``base + (i * stride) % wset`` with ``float32(i + 1)`` cast to the
buffer's dtype.  Tiles the traversal never touches keep their contents,
and a revisited tile (N > W/S) ends with the payload of its last write.

The reference donates its buffer (``input_output_aliases``); PyTorch has
no donation, so `rst_write` writes IN PLACE into the caller's tensor and
returns that same tensor.

On the card `rst_write` launches ``rst_write_launch`` from
``csrc/rst.cu``, one CTA a transaction, laid out as ``fill_`` lays out
its blocks.  Its CTAs run in no order, so every transaction stores the
final payload of its tile, ``1 + max{j < n : T[j] = T[i]}``, and racing
stores to one tile carry identical bytes (design note in the source).  On a CPU tensor `rst_write` runs `rst_write_plain`, which
replays the stream and lets the last write of each tile win.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rst_read import (DTYPE_CODES, LANE, SUBLANE,
                                          check_buffer, stream_scalars,
                                          tile_indices)

WRITE_DTYPES = (torch.float32, torch.bfloat16)


def rst_write_plain(params, buf: torch.Tensor, *, grid_txns: int,
                    burst_rows: int = SUBLANE) -> torch.Tensor:
    """The write engine in plain PyTorch, in place: the last write of each
    tile (the largest transaction index that maps to it) wins."""
    tiles = check_buffer(buf, burst_rows, WRITE_DTYPES)
    stride, wset, base, n = stream_scalars(params, grid_txns, tiles)
    idx = tile_indices(stride, wset, base, n, buf.device)
    last = torch.full((tiles,), -1, dtype=torch.int64, device=buf.device)
    last.scatter_reduce_(0, idx, torch.arange(n, device=buf.device),
                         reduce="amax")
    touched = torch.nonzero(last >= 0).reshape(-1)
    payload = (last[touched] + 1).to(torch.float32).to(buf.dtype)
    view = buf.view(tiles, burst_rows * LANE)
    view[touched] = payload[:, None].expand(-1, burst_rows * LANE)
    return buf


def rst_write(params, buf: torch.Tensor, *, grid_txns: int,
              burst_rows: int = SUBLANE) -> torch.Tensor:
    """Run the RST write engine over `buf`, in place; returns `buf`.

    params: int32[4] = (stride_blocks, wset_blocks, base_block, n_txns).
    `buf` is (rows, LANE) float32 or bfloat16 and contiguous.  A CUDA
    tensor launches the kernel; a CPU tensor runs `rst_write_plain`.
    """
    if buf.device.type == "cpu":
        return rst_write_plain(params, buf, grid_txns=grid_txns,
                               burst_rows=burst_rows)
    tiles = check_buffer(buf, burst_rows, WRITE_DTYPES)
    stride, wset, base, n = stream_scalars(params, grid_txns, tiles)
    if n == 0:
        return buf
    status = _build.library().rst_write_launch(
        buf.device.index, buf.data_ptr(), DTYPE_CODES[buf.dtype],
        burst_rows * LANE * buf.element_size(), stride, wset, base, n,
        torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(status, "rst_write")
    rst_write.launches += 1
    return buf


rst_write.launches = 0
