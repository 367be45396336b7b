"""Concurrent-access RST read engines (DESIGN.md §8/§9/§13) as CUDA kernels.

Port of the Pallas TPU kernels ``repro.kernels.rst_contend``: N read
engines share the card's memory under grant-based arbitration.  The N
streams merge into one step sequence ``j``; rotation
``g = j // (bb * N)`` hands every engine a grant of ``bb`` consecutive
beats, so step ``j`` is transaction ``t_raw = g * bb + r % bb`` of engine
``k = r // bb`` (``r = j % (bb * N)``).  ``bb = 1`` is per-transaction
round robin, ``bb >= n`` an exclusive whole-stream grant.  The per-engine
grid is padded up to whole grants; steps with ``t_raw >= n`` read nothing.

* `rst_contend_read`: every engine has the same ``(stride, wset, base,
  n)``, engine k's window at block ``base + k * wset``; the int32[6]
  operand is ``(stride, wset, base, n, N, bb)``.
* `rst_contend_mix_read`: each engine has its own row of an
  int32[N+1, 4] table, header ``(N, bb, 0, 0)`` then
  ``(stride_k, wset_k, base_k, n_k)`` with the window offset folded into
  ``base_k`` (`ops.mix_params_operand`).

Both return the float32 sum of every tile read.  On the card they launch
``csrc/rst_contend.cu``, whose CTAs take the merged steps round by round
so that the grant order is what the card has in flight (design note in
the source).  On a CPU tensor they run `rst_contend_read_plain` /
`rst_contend_mix_read_plain`, which build the whole grant sequence with
tensor ops.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rst_read import (DTYPE_CODES, LANE, SUBLANE,
                                          check_buffer, launch_shape,
                                          sum_scratch)

INDEX_BATCH = 256            # steps a CTA indexes at once (kBatch)
SHARED_MEMORY_LIMIT = 232448  # bytes of shared memory a Hopper CTA may use
# Length of ops.contended_params_operand's int32 operand, and the row
# width of ops.mix_params_operand's table.
CONTENDED_OPERAND_LEN = 6
MIX_ROW = 4


def shared_memory_bytes(num_engines: int = 0) -> int:
    """Shared memory of one CTA of the contention kernels: a batch of
    int64 step indices and, for a mix of `num_engines` engines, its
    int32[N+1, 4] table."""
    table = (num_engines + 1) * MIX_ROW * 4 if num_engines else 0
    return INDEX_BATCH * 8 + table


def check_shared_memory(num_engines: int) -> None:
    """Raise if a mix of `num_engines` engines cannot fit its table in the
    shared memory of one CTA."""
    smem = shared_memory_bytes(num_engines)
    if smem > SHARED_MEMORY_LIMIT:
        raise ValueError(
            f"a mix of {num_engines} engines needs {smem} bytes of shared "
            f"memory, more than the {SHARED_MEMORY_LIMIT} a CTA may use")


def check_engines(buf: torch.Tensor, burst_rows: int, num_engines: int,
                  burst_beats: int) -> int:
    """The reference kernels' argument checks, with their texts; returns
    the buffer's number of tiles."""
    tiles = check_buffer(buf, burst_rows, tuple(DTYPE_CODES))
    if num_engines < 1:
        raise ValueError(f"num_engines must be >= 1, got {num_engines}")
    if burst_beats < 1:
        raise ValueError(f"burst_beats must be >= 1, got {burst_beats}")
    return tiles


def total_steps(grid_txns: int, num_engines: int, burst_beats: int) -> int:
    """Merged steps of one run: the per-engine grid padded up to whole
    grants, times the engine count."""
    if grid_txns < 1:
        raise ValueError(f"grid_txns must be positive, got {grid_txns}")
    return -(-grid_txns // burst_beats) * burst_beats * num_engines


def grant_positions(steps: int, num_engines: int, burst_beats: int,
                    device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(engine k, transaction t_raw) of every merged step j < steps, int64
    (the reference's `_grant_position`)."""
    j = torch.arange(steps, dtype=torch.int64, device=device)
    per_round = burst_beats * num_engines
    r = j % per_round
    return r // burst_beats, (j // per_round) * burst_beats + r % burst_beats


def _window_check(lo: int, wset: int, tiles: int, what: str) -> None:
    if lo + wset > tiles:
        raise ValueError(
            f"{what} ends at tile {lo + wset}, past the buffer's {tiles} "
            f"tiles")


def contend_scalars(params, tiles: int, num_engines: int,
                    burst_beats: int) -> Tuple[int, int, int, int]:
    """(stride, wset, base, n) of the int32[6] operand, after checking
    that its engine count and grant size are the launch's and that every
    engine's window lies inside the buffer."""
    values = torch.as_tensor(params).reshape(-1).tolist()
    if len(values) != CONTENDED_OPERAND_LEN:
        raise ValueError(
            f"params must be (stride, wset, base, n, num_engines, "
            f"burst_beats), got {values}")
    stride, wset, base, n, engines, bb = (int(v) for v in values)
    if (engines, bb) != (num_engines, burst_beats):
        raise ValueError(
            f"operand names {engines} engines with {bb}-beat grants, the "
            f"launch {num_engines} with {burst_beats}")
    if wset < 1 or stride < 0 or base < 0:
        raise ValueError(
            f"need wset >= 1, stride >= 0, base >= 0; got {values}")
    _window_check(base, num_engines * wset, tiles, "the last engine's window")
    return stride, wset, base, n


def mix_rows(table, tiles: int, num_engines: int,
             burst_beats: int) -> List[List[int]]:
    """The per-engine rows of the int32[N+1, 4] mix table, after checking
    its shape (with the reference's text), its header and that every
    engine's window lies inside the buffer."""
    table = torch.as_tensor(table)
    if tuple(table.shape) != (num_engines + 1, MIX_ROW):
        raise ValueError(
            f"mix table must be int32[{num_engines + 1}, {MIX_ROW}] "
            f"(header + one row per engine), got {tuple(table.shape)}")
    header, *rows = table.tolist()
    if header[:2] != [num_engines, burst_beats]:
        raise ValueError(
            f"mix table header {header} names another engine count or "
            f"grant size than the launch ({num_engines}, {burst_beats})")
    for k, (stride, wset, base, _) in enumerate(rows):
        if wset < 1 or stride < 0 or base < 0:
            raise ValueError(
                f"engine {k}: need wset >= 1, stride >= 0, base >= 0; got "
                f"{rows[k]}")
        _window_check(base, wset, tiles, f"engine {k}'s window")
    return rows


def _checksum(buf: torch.Tensor, burst_rows: int, tiles: int,
              idx: torch.Tensor) -> torch.Tensor:
    view = buf.reshape(tiles, burst_rows * LANE)
    out = view.index_select(0, idx).sum(0, dtype=torch.float32)
    return out.reshape(burst_rows, LANE)


def contend_tile_indices(params, tiles: int, *, grid_txns: int,
                         num_engines: int, burst_beats: int,
                         device: torch.device) -> torch.Tensor:
    """Tile index of every step of `rst_contend_read` that reads, in the
    merged step order."""
    stride, wset, base, n = contend_scalars(params, tiles, num_engines,
                                            burst_beats)
    k, t = grant_positions(total_steps(grid_txns, num_engines, burst_beats),
                           num_engines, burst_beats, device)
    keep = t < n
    k, t = k[keep], t[keep]
    return base + k * wset + (t * stride) % wset


def mix_tile_indices(table, tiles: int, *, grid_txns: int, num_engines: int,
                     burst_beats: int, device: torch.device) -> torch.Tensor:
    """Tile index of every step of `rst_contend_mix_read` that reads, in
    the merged step order."""
    rows = torch.tensor(mix_rows(table, tiles, num_engines, burst_beats),
                        dtype=torch.int64, device=device)
    k, t = grant_positions(total_steps(grid_txns, num_engines, burst_beats),
                           num_engines, burst_beats, device)
    stride, wset, base, n = rows[k].unbind(1)
    keep = t < n
    return base[keep] + (t[keep] * stride[keep]) % wset[keep]


def rst_contend_read_plain(params, buf: torch.Tensor, *, grid_txns: int,
                           num_engines: int, burst_beats: int = 1,
                           burst_rows: int = SUBLANE) -> torch.Tensor:
    """The contended read engines in plain PyTorch: the whole grant
    sequence as tensors, gated steps masked out, then a gather and a
    float32 sum."""
    tiles = check_engines(buf, burst_rows, num_engines, burst_beats)
    idx = contend_tile_indices(params, tiles, grid_txns=grid_txns,
                               num_engines=num_engines,
                               burst_beats=burst_beats, device=buf.device)
    return _checksum(buf, burst_rows, tiles, idx)


def rst_contend_mix_read_plain(table, buf: torch.Tensor, *, grid_txns: int,
                               num_engines: int, burst_beats: int = 1,
                               burst_rows: int = SUBLANE) -> torch.Tensor:
    """The mix of read engines in plain PyTorch, each engine gated on its
    own n."""
    tiles = check_engines(buf, burst_rows, num_engines, burst_beats)
    idx = mix_tile_indices(table, tiles, grid_txns=grid_txns,
                           num_engines=num_engines, burst_beats=burst_beats,
                           device=buf.device)
    return _checksum(buf, burst_rows, tiles, idx)


def _scratch(buf: torch.Tensor, steps: int, burst_rows: int):
    """(n_ctas, threads, tile_bytes, partial, out) of one launch."""
    tile_bytes = burst_rows * LANE * buf.element_size()
    n_ctas, threads = launch_shape(buf, steps, tile_bytes // 16)
    return (n_ctas, threads, tile_bytes,
            *sum_scratch(buf, n_ctas, burst_rows))


def rst_contend_read(params, buf: torch.Tensor, *, grid_txns: int,
                     num_engines: int, burst_beats: int = 1,
                     burst_rows: int = SUBLANE) -> torch.Tensor:
    """Run N grant-interleaved RST read engines over `buf`.

    Args:
      params: int32[6] = (stride_blocks, wset_blocks, base_block, n_txns,
        num_engines, burst_beats), on the host; blocks are
        `(burst_rows, LANE)` tiles and engine k's window starts at block
        ``base_block + k * wset_blocks``.
      buf: the shared working buffer, (rows, LANE) float32, bfloat16 or
        int8, contiguous, covering every engine's window.
      grid_txns: the reference kernel's per-engine grid size.
      num_engines, burst_beats: the engine count and grant size (1 =
        round robin; >= n_txns = exclusive); must equal the operand's.
      burst_rows: rows per burst tile.

    Returns:
      float32[burst_rows, LANE] elementwise checksum of every tile read
      by every engine, on `buf`'s device.  A CUDA tensor launches the
      kernel; a CPU tensor runs `rst_contend_read_plain`.
    """
    if buf.device.type == "cpu":
        return rst_contend_read_plain(params, buf, grid_txns=grid_txns,
                                      num_engines=num_engines,
                                      burst_beats=burst_beats,
                                      burst_rows=burst_rows)
    tiles = check_engines(buf, burst_rows, num_engines, burst_beats)
    stride, wset, base, n = contend_scalars(params, tiles, num_engines,
                                            burst_beats)
    steps = total_steps(grid_txns, num_engines, burst_beats)
    n_ctas, threads, tile_bytes, partial, out = _scratch(buf, steps,
                                                         burst_rows)
    status = _build.library().rst_contend_read_launch(
        buf.device.index, buf.data_ptr(), DTYPE_CODES[buf.dtype], tile_bytes,
        stride, wset, base, n, num_engines, burst_beats, steps, n_ctas,
        threads, partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(status, "rst_contend_read")
    rst_contend_read.launches += 1
    return out


def rst_contend_mix_read(table, buf: torch.Tensor, *, grid_txns: int,
                         num_engines: int, burst_beats: int = 1,
                         burst_rows: int = SUBLANE) -> torch.Tensor:
    """Run a heterogeneous mix of grant-interleaved RST read engines.

    Args:
      table: int32[num_engines + 1, 4] on the host: the header
        ``(num_engines, burst_beats, 0, 0)``, then engine k's
        ``(stride_blocks, wset_blocks, base_block, n_txns)`` with its
        window offset folded into ``base_block``.
      buf, grid_txns, num_engines, burst_beats, burst_rows: as in
        `rst_contend_read`.

    Returns:
      float32[burst_rows, LANE] elementwise checksum of every tile read,
      each engine's steps past its own n gated out.  A CUDA tensor
      launches the kernel, after copying the table to the card; a CPU
      tensor runs `rst_contend_mix_read_plain`.
    """
    if buf.device.type == "cpu":
        return rst_contend_mix_read_plain(table, buf, grid_txns=grid_txns,
                                          num_engines=num_engines,
                                          burst_beats=burst_beats,
                                          burst_rows=burst_rows)
    tiles = check_engines(buf, burst_rows, num_engines, burst_beats)
    rows = mix_rows(table, tiles, num_engines, burst_beats)
    check_shared_memory(num_engines)
    steps = total_steps(grid_txns, num_engines, burst_beats)
    n_ctas, threads, tile_bytes, partial, out = _scratch(buf, steps,
                                                         burst_rows)
    # The kernel reads the table from device memory.  From pinned host
    # memory the upload is queued on the stream like the launch, and the
    # host does not wait for the card.
    dev_table = torch.tensor([[num_engines, burst_beats, 0, 0]] + rows,
                             dtype=torch.int32, pin_memory=True).to(
                                 buf.device, non_blocking=True)
    status = _build.library().rst_contend_mix_read_launch(
        buf.device.index, buf.data_ptr(), DTYPE_CODES[buf.dtype], tile_bytes,
        dev_table.data_ptr(), num_engines, steps, n_ctas, threads,
        partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(status, "rst_contend_mix_read")
    rst_contend_mix_read.launches += 1
    return out


rst_contend_read.launches = 0
rst_contend_mix_read.launches = 0
