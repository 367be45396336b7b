"""RST read engine (paper Sec. III-C-1, read module) as a CUDA kernel.

Port of the Pallas TPU kernel ``repro.kernels.rst_read.rst_read``.  One
RST transaction reads one ``(burst_rows, 128)`` tile at block index
``base + (i * stride) % wset`` (Eq. 1 at tile granularity); the engine
returns the float32 elementwise sum of every tile it read, a checksum that
proves the bytes were touched.

On the card `rst_read` launches ``rst_read_launch`` from ``csrc/rst.cu``:
the stream is cut into contiguous chunks, one per CTA, each CTA sums its
chunk in registers from 16-byte loads, and a second pass adds the
per-CTA partial tiles in a fixed order (design note in the source).
`stride`, `wset`, `base` and `n` stay runtime arguments, so one binary
serves every RST variant (paper challenge C2); only the tile shape is
fixed per call.  On a CPU tensor `rst_read` runs `rst_read_plain`, the
same function in plain PyTorch.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build

LANE = 128          # minor dim of the working buffer, as in the reference
SUBLANE = 8         # burst_rows granularity, as in the reference
THREADS = 256       # 16-byte vectors per CTA slice of a tile
CTAS_PER_SM = 4     # CTAs over the card's SMs for one stream
MIN_TXNS_PER_CTA = 16

# dtype codes of csrc/rst.cu.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_buffer(buf: torch.Tensor, burst_rows: int,
                 dtypes: Sequence[torch.dtype]) -> int:
    """Validate the working buffer, with the reference kernels' texts for
    the checks they make; returns its number of tiles."""
    rows, lane = buf.shape if buf.dim() == 2 else (0, tuple(buf.shape))
    if lane != LANE:
        raise ValueError(f"buffer minor dim must be {LANE}, got {lane}")
    if burst_rows <= 0:
        raise ValueError(f"burst_rows must be a multiple of {SUBLANE}")
    if rows % burst_rows:
        raise ValueError(f"rows ({rows}) % burst_rows ({burst_rows}) != 0")
    if burst_rows % SUBLANE:
        raise ValueError(f"burst_rows must be a multiple of {SUBLANE}")
    if buf.dtype not in dtypes:
        raise ValueError(
            f"buffer dtype {buf.dtype} not supported; use one of "
            f"{[str(d) for d in dtypes]}")
    if not buf.is_contiguous():
        raise ValueError("buffer must be contiguous")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {buf.device}")
    if buf.device.type == "cuda" and buf.data_ptr() % 16:
        raise ValueError("buffer must start on a 16-byte boundary")
    return rows // burst_rows


def stream_scalars(params, grid_txns: int, tiles: int
                   ) -> Tuple[int, int, int, int]:
    """(stride, wset, base, n_eff) from the int32[4] operand, with n
    clamped to the grid as the TPU grid clamps it; checks that every tile
    index ``base + (i * stride) % wset`` lies inside the buffer."""
    values = torch.as_tensor(params).reshape(-1).tolist()
    if len(values) != 4:
        raise ValueError(
            f"params must be (stride, wset, base, n), got {values}")
    stride, wset, base, n = (int(v) for v in values)
    if wset < 1 or stride < 0 or base < 0:
        raise ValueError(
            f"need wset >= 1, stride >= 0, base >= 0; got {values}")
    if base + wset > tiles:
        raise ValueError(
            f"base + wset = {base + wset} tiles exceeds the buffer's "
            f"{tiles} tiles")
    if grid_txns < 1:
        raise ValueError(f"grid_txns must be positive, got {grid_txns}")
    return stride, wset, base, max(0, min(n, grid_txns))


def tile_indices(stride: int, wset: int, base: int, n: int,
                 device: torch.device) -> torch.Tensor:
    """Tile index of each transaction i < n, int64."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return base + (i * stride) % wset


def launch_shape(buf: torch.Tensor, n: int, tile_vecs: int
                 ) -> Tuple[int, int]:
    """(CTAs along the stream, threads per CTA) for one launch: enough
    CTAs to fill every SM a few times, each with at least a few
    transactions."""
    sms = torch.cuda.get_device_properties(buf.device).multi_processor_count
    n_ctas = max(1, min(-(-n // MIN_TXNS_PER_CTA), CTAS_PER_SM * sms))
    return n_ctas, min(THREADS, tile_vecs)


def rst_read_plain(params, buf: torch.Tensor, *, grid_txns: int,
                   burst_rows: int = SUBLANE) -> torch.Tensor:
    """The read engine in plain PyTorch: gather the tiles, sum in
    float32."""
    tiles = check_buffer(buf, burst_rows, tuple(DTYPE_CODES))
    stride, wset, base, n = stream_scalars(params, grid_txns, tiles)
    idx = tile_indices(stride, wset, base, n, buf.device)
    view = buf.reshape(tiles, burst_rows * LANE)
    out = view.index_select(0, idx).sum(0, dtype=torch.float32)
    return out.reshape(burst_rows, LANE)


def rst_read(params, buf: torch.Tensor, *, grid_txns: int,
             burst_rows: int = SUBLANE) -> torch.Tensor:
    """Run the RST read engine over `buf`.

    Args:
      params: int32[4] = (stride_blocks, wset_blocks, base_block, n_txns);
        blocks are `(burst_rows, LANE)` tiles.  Transactions past
        `grid_txns` are not run, as on the TPU grid.
      buf: the working buffer, (rows, LANE) float32, bfloat16 or int8,
        contiguous, rows % burst_rows == 0.
      grid_txns: the reference kernel's grid size (its clamp on n).
      burst_rows: rows per burst tile; burst bytes = burst_rows*LANE*itemsize.

    Returns:
      float32[burst_rows, LANE] elementwise checksum of every tile read,
      on `buf`'s device.  A CUDA tensor launches the kernel; a CPU tensor
      runs `rst_read_plain`.
    """
    if buf.device.type == "cpu":
        return rst_read_plain(params, buf, grid_txns=grid_txns,
                              burst_rows=burst_rows)
    tiles = check_buffer(buf, burst_rows, tuple(DTYPE_CODES))
    stride, wset, base, n = stream_scalars(params, grid_txns, tiles)
    tile_elems = burst_rows * LANE
    tile_bytes = tile_elems * buf.element_size()
    n_ctas, threads = launch_shape(buf, n, tile_bytes // 16)
    partial = torch.empty((n_ctas, tile_elems), dtype=torch.float32,
                          device=buf.device)
    out = torch.empty((burst_rows, LANE), dtype=torch.float32,
                      device=buf.device)
    lib = _build.library()
    status = lib.rst_read_launch(
        buf.device.index, buf.data_ptr(), DTYPE_CODES[buf.dtype],
        tile_bytes, stride, wset, base, n, n_ctas, threads,
        partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(status, "rst_read")
    rst_read.launches += 1
    return out


rst_read.launches = 0
