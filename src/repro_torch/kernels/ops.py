"""Host-side wrappers around the RST engines: operand packing, working
buffers and bandwidth measurement.

This is the device-side counterpart of the paper's parameter module: it
packs :class:`repro_torch.core.params.RSTParams` (byte-level, as the host
thinks of them) into the int32[4] operand (tile-level, as the engines
consume it) and runs the kernels.  ``measure_read_bandwidth`` and its
siblings are what the `cuda` backend of core/engine.py calls, the
``measure_contended_*`` pair for multi-engine contention.  On the card the
number is the achieved device-memory bandwidth of one RST stream (or of N
grant-interleaved ones) spread over every SM, timed with CUDA events;
with ``device="cpu"`` the plain PyTorch versions run and the seconds are
host time, good for checking results only.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine_mix import EngineMix
from repro_torch.core.params import RSTParams
from repro_torch.core.rst import block_params
from repro_torch.core.timing_model import _grant_beats
from repro_torch.device import resolve_device
from repro_torch.kernels.rst_contend import (rst_contend_mix_read,
                                             rst_contend_read)
from repro_torch.kernels.rst_read import LANE, SUBLANE, rst_read
from repro_torch.kernels.rst_write import rst_write

# Timed runs per measurement after one warm-up; the median is reported.
# On the card each run times CALLS_PER_RUN back-to-back calls, so the
# host's per-call overhead overlaps the kernels instead of being timed.
TIMED_RUNS = 5
CALLS_PER_RUN = 10


def tile_bytes(dtype: torch.dtype, burst_rows: int = SUBLANE) -> int:
    return burst_rows * LANE * dtype.itemsize


def grid_bucket(n_txns: int, floor: int = 16) -> int:
    """Round a transaction count up to the next power of two.

    The reference bucketed its static Pallas grid so that RST variants
    shared one compiled kernel in interpret mode.  The CUDA kernels take
    every scalar at run time and need no bucketing; the port buckets the
    CPU path only, where the reference bucketed, so both packages pack the
    same operands.  A bucketed grid never changes the result: the grid
    only clamps n, and the bucket is >= n.
    """
    if n_txns <= 0:
        raise ValueError(f"n_txns must be positive, got {n_txns}")
    return max(floor, 1 << (n_txns - 1).bit_length())


def default_grid(n_txns: int, device: torch.device) -> int:
    """Grid the measure_* wrappers use when the caller passes none:
    bucketed on the CPU, where the reference ran in interpret mode, and
    exact on the card."""
    return grid_bucket(n_txns) if device.type == "cpu" else n_txns


_INT32_MAX = 2 ** 31 - 1


def _require_int32_index_range(stride_b: int, wset_b: int, base_b: int,
                               n: int, num_engines: int = 1) -> None:
    """Reject configurations whose index arithmetic overflows int32.

    The reference's BlockSpec index maps run in int32 and compute
    ``base + k * wset + (t * stride) % wset`` with ``t <= n - 1`` and
    ``k < num_engines``.  The CUDA kernels index in 64 bits, but the
    operand is int32 and the port keeps the reference's bounds, so both
    packages accept and refuse the same configurations.
    """
    worst_product = max(n - 1, 0) * stride_b
    worst_block = base_b + num_engines * wset_b
    if worst_product > _INT32_MAX or worst_block > _INT32_MAX:
        raise ValueError(
            f"RST operand overflows the int32 index maps: "
            f"(n-1)*stride_blocks={worst_product}, base+span="
            f"{worst_block} (limit {_INT32_MAX}); shrink N/S/W/A or "
            f"split the sweep")


def params_operand(p: RSTParams, dtype: torch.dtype,
                   burst_rows: int = SUBLANE,
                   grid_txns: int | None = None) -> torch.Tensor:
    """Pack byte-level RST params into the int32[4] operand (on the host:
    the kernels take its four values as launch arguments)."""
    tb = tile_bytes(dtype, burst_rows)
    if p.b != tb:
        raise ValueError(
            f"burst B={p.b} does not match tile bytes {tb} "
            f"(burst_rows={burst_rows}, "
            f"dtype={str(dtype).removeprefix('torch.')}); the "
            f"burst is the kernel's tile (DESIGN.md §2)")
    stride_b, wset_b, base_b = block_params(p, tb)
    n = p.n if grid_txns is None else min(p.n, grid_txns)
    _require_int32_index_range(stride_b, wset_b, base_b, n)
    return torch.tensor([stride_b, wset_b, base_b, n], dtype=torch.int32)


def make_working_buffer(p: RSTParams, dtype: torch.dtype,
                        generator: Optional[torch.Generator] = None, *,
                        num_engines: int = 1,
                        device: "torch.device | str | None" = None
                        ) -> torch.Tensor:
    """Allocate the working set as (rows, LANE) on `device` (default: the
    card): A + W bytes of the given dtype (the kernels address from
    ``base_block = A // tile`` upward, so the buffer must cover the base
    offset too), with W times `num_engines` for the contention kernels'
    disjoint per-engine windows.

    Without a generator the content is ``index % 251`` computed as the
    reference computes it: the index converted to float32 (rounded to
    nearest even above 2**24 elements, as XLA's iota rounds), then a
    float32 remainder; with one, standard normal values drawn from it.
    """
    dev = resolve_device(device)
    span = p.a + num_engines * p.w
    rows = span // (LANE * dtype.itemsize)
    if rows * LANE * dtype.itemsize != span:
        raise ValueError(
            f"A+{num_engines}*W={span} not a whole number of ({LANE},) rows")
    return _fill_buffer(rows, dtype, generator, dev)


def _fill_buffer(rows: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """(rows, LANE) of the default content, or standard normal values
    drawn from `generator`."""
    if generator is None:
        index = torch.arange(rows * LANE, dtype=torch.int64, device=device)
        # fmod of non-negative float32 values is exact.
        base = torch.fmod(index.to(torch.float32), 251.0)
        return base.reshape(rows, LANE).to(dtype)
    return torch.randn((rows, LANE), generator=generator, device=device,
                       dtype=torch.float32).to(dtype)


def from_reference(buf_np: np.ndarray, operand_np: np.ndarray, *,
                   device: "torch.device | str | None" = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference package's working buffer and int32 operand, as numpy
    arrays, turned into the port's tensors on `device` (default: the
    card).  A bfloat16 buffer (numpy's ml_dtypes type) keeps its bits."""
    dev = resolve_device(device)
    arr = np.array(buf_np, order="C", copy=True)
    if arr.dtype.name == "bfloat16":
        buf = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        buf = torch.from_numpy(arr)
    operand = torch.tensor(np.asarray(operand_np).tolist(), dtype=torch.int32)
    return buf.to(dev), operand.to(dev)


@dataclasses.dataclass(frozen=True)
class BandwidthSample:
    bytes_moved: int
    seconds: float
    checksum: np.ndarray

    @property
    def gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9 if self.seconds > 0 else 0.0


def time_median(fn: Callable[[], object], device: torch.device) -> float:
    """Median seconds per call of `fn` (already warmed up) over
    TIMED_RUNS runs: on the card CUDA events around CALLS_PER_RUN
    back-to-back calls, on the CPU the host clock around one call."""
    times = []
    for _ in range(TIMED_RUNS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS_PER_RUN):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / CALLS_PER_RUN)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def measure_read_bandwidth(p: RSTParams, *, dtype: torch.dtype = torch.float32,
                           burst_rows: int = SUBLANE,
                           grid_txns: int | None = None,
                           device: "torch.device | str | None" = None
                           ) -> BandwidthSample:
    """One RST read stream over a fresh working buffer; the checksum is
    the engine's float32 tile sum."""
    dev = resolve_device(device)
    grid = grid_txns or default_grid(p.n, dev)
    operand = params_operand(p, dtype, burst_rows, grid)
    buf = make_working_buffer(p, dtype, device=dev)

    def run():
        return rst_read(operand, buf, grid_txns=grid, burst_rows=burst_rows)

    out = run()   # warm-up: builds and loads the kernel library on first use
    seconds = time_median(run, dev)
    return BandwidthSample(bytes_moved=min(p.n, grid) * p.b, seconds=seconds,
                           checksum=out.cpu().numpy())


def contended_params_operand(p: RSTParams, num_engines: int,
                             dtype: torch.dtype, burst_rows: int = SUBLANE,
                             grid_txns: int | None = None,
                             burst_beats: int = 1) -> torch.Tensor:
    """Pack byte-level RST params + engine count + grant size into the
    int32[6] operand of the concurrent-access kernel (on the host)."""
    base = params_operand(p, dtype, burst_rows, grid_txns)
    # The N disjoint per-engine windows span base + N*wset blocks — wider
    # than the single-engine range params_operand already validated.
    stride_b, wset_b, base_b = block_params(p, tile_bytes(dtype, burst_rows))
    n = p.n if grid_txns is None else min(p.n, grid_txns)
    _require_int32_index_range(stride_b, wset_b, base_b, n,
                               num_engines=num_engines)
    return torch.cat(
        [base, torch.tensor([num_engines, burst_beats], dtype=torch.int32)])


def _resolve_grant_beats(arbitration: str, burst_beats: int,
                         grid_txns: int) -> int:
    """Map the arbitration-policy axis onto the kernel's grant size via
    the timing model's shared `_grant_beats` table (one set of policy
    names and validations), clamped to the per-engine grid: a grant
    cannot exceed the stream, and an unclamped grant would pad the grid
    with gated steps that read nothing."""
    return min(_grant_beats(arbitration, burst_beats, grid_txns), grid_txns)


def measure_contended_bandwidth(p: RSTParams, *, num_engines: int,
                                arbitration: str = "round_robin",
                                burst_beats: int = 1,
                                dtype: torch.dtype = torch.float32,
                                burst_rows: int = SUBLANE,
                                grid_txns: int | None = None,
                                device: "torch.device | str | None" = None
                                ) -> BandwidthSample:
    """N read engines sharing the card's memory (DESIGN.md §8/§9): the
    grant-interleaved traversal of `timing_model.contended_throughput`
    run on the device, at the requested arbitration granularity
    (round-robin beats, `burst_beats`-sized grants, or exclusive
    whole-stream grants).  Each engine owns a disjoint W-byte window of
    one shared buffer; bytes moved counts every engine (N·n·B over the
    kernel time), so `gbps` is the aggregate under contention."""
    if num_engines < 1:
        raise ValueError(f"num_engines must be >= 1, got {num_engines}")
    dev = resolve_device(device)
    grid = grid_txns or default_grid(p.n, dev)
    bb = _resolve_grant_beats(arbitration, burst_beats, grid)
    operand = contended_params_operand(p, num_engines, dtype, burst_rows,
                                       grid, bb)
    buf = make_working_buffer(p, dtype, num_engines=num_engines, device=dev)

    def run():
        return rst_contend_read(operand, buf, grid_txns=grid,
                                num_engines=num_engines, burst_beats=bb,
                                burst_rows=burst_rows)

    out = run()
    seconds = time_median(run, dev)
    return BandwidthSample(
        bytes_moved=num_engines * min(p.n, grid) * p.b, seconds=seconds,
        checksum=out.cpu().numpy())


def _mix_block_rows(mix: EngineMix, dtype: torch.dtype, burst_rows: int,
                    grid_txns: int | None) -> Tuple[list, int]:
    """Per-engine (stride, wset, base, n) block rows for the mix kernel.

    Engine k's disjoint window is laid out directly after engine k-1's:
    its row's base block folds in the cumulative working-set offset, so
    the kernel's index stays the three-term homogeneous form.  Every row
    is int32-guarded individually — one oversized entry must name itself
    rather than hide behind the mix's aggregate span.

    Returns (rows, span_blocks) where span_blocks is the buffer extent
    in tiles.
    """
    tb = tile_bytes(dtype, burst_rows)
    rows = []
    offset_b = 0
    span_b = 0
    for k, (p, op) in enumerate(mix.entries):
        if op != "read":
            raise ValueError(
                f"the contention kernel measures read engines only; entry "
                f"{k} of mix {mix.describe()!r} is {op!r} — route "
                f"write/duplex engines through the sim/torchgrid placement "
                f"paths (DESIGN.md §13)")
        if p.b != tb:
            raise ValueError(
                f"entry {k} burst B={p.b} does not match tile bytes {tb} "
                f"(burst_rows={burst_rows}, "
                f"dtype={str(dtype).removeprefix('torch.')}); the burst "
                f"is the kernel's tile shared by every engine in the mix "
                f"(DESIGN.md §2/§13)")
        stride_b, wset_b, base_b = block_params(p, tb)
        base_k = base_b + offset_b
        n = p.n if grid_txns is None else min(p.n, grid_txns)
        _require_int32_index_range(stride_b, wset_b, base_k, n)
        rows.append([stride_b, wset_b, base_k, n])
        offset_b += wset_b
        span_b = max(span_b, base_k + wset_b)
    return rows, span_b


def mix_params_operand(mix: EngineMix, dtype: torch.dtype,
                       burst_rows: int = SUBLANE,
                       grid_txns: int | None = None,
                       burst_beats: int = 1) -> torch.Tensor:
    """Pack a heterogeneous EngineMix into the int32[N+1, 4] table of
    `rst_contend_mix_read` (on the host): a header row (num_engines,
    burst_beats, 0, 0) followed by one per-engine row, each int32-guarded
    on its own index arithmetic."""
    rows, _ = _mix_block_rows(mix, dtype, burst_rows, grid_txns)
    header = [len(mix), burst_beats, 0, 0]
    return torch.tensor([header] + rows, dtype=torch.int32)


def make_mix_working_buffer(mix: EngineMix, dtype: torch.dtype,
                            generator: Optional[torch.Generator] = None, *,
                            burst_rows: int = SUBLANE,
                            grid_txns: int | None = None,
                            device: "torch.device | str | None" = None
                            ) -> torch.Tensor:
    """Allocate one shared working buffer on `device` (default: the card)
    covering every engine's disjoint window under the `_mix_block_rows`
    layout (engine k's window directly after engine k-1's, past its own
    base offset), with `make_working_buffer`'s content."""
    dev = resolve_device(device)
    _, span_b = _mix_block_rows(mix, dtype, burst_rows, grid_txns)
    return _fill_buffer(span_b * burst_rows, dtype, generator, dev)


def measure_contended_mix_bandwidth(mix: EngineMix, *,
                                    arbitration: str = "round_robin",
                                    burst_beats: int = 1,
                                    dtype: torch.dtype = torch.float32,
                                    burst_rows: int = SUBLANE,
                                    grid_txns: int | None = None,
                                    device: "torch.device | str | None" = None
                                    ) -> BandwidthSample:
    """A heterogeneous mix of read engines sharing the card's memory: the
    per-engine generalization of `measure_contended_bandwidth`.  A
    uniform mix delegates to the homogeneous wrapper outright (the same
    reduction rule every layer of the contention stack applies), so the
    mixed kernel only ever runs for genuinely heterogeneous traffic.
    Bytes moved counts every engine's own burst size over its own
    stream, so `gbps` is the aggregate under the mixed load."""
    uni = mix.uniform_entry()
    if uni is not None:
        p, op = uni
        if op != "read":
            raise ValueError(
                f"the contention kernel measures read engines only; mix "
                f"{mix.describe()!r} is all-{op} — route write/duplex "
                f"engines through the sim/torchgrid placement paths "
                f"(DESIGN.md §13)")
        return measure_contended_bandwidth(
            p, num_engines=len(mix), arbitration=arbitration,
            burst_beats=burst_beats, dtype=dtype, burst_rows=burst_rows,
            grid_txns=grid_txns, device=device)
    dev = resolve_device(device)
    grid = grid_txns or default_grid(max(p.n for p in mix.params), dev)
    bb = _resolve_grant_beats(arbitration, burst_beats, grid)
    table = mix_params_operand(mix, dtype, burst_rows, grid, burst_beats=bb)
    buf = make_mix_working_buffer(mix, dtype, burst_rows=burst_rows,
                                  grid_txns=grid, device=dev)

    def run():
        return rst_contend_mix_read(table, buf, grid_txns=grid,
                                    num_engines=len(mix), burst_beats=bb,
                                    burst_rows=burst_rows)

    out = run()
    seconds = time_median(run, dev)
    return BandwidthSample(
        bytes_moved=sum(min(p.n, grid) * p.b for p in mix.params),
        seconds=seconds, checksum=out.cpu().numpy())


def measure_write_bandwidth(p: RSTParams, *,
                            dtype: torch.dtype = torch.float32,
                            burst_rows: int = SUBLANE,
                            grid_txns: int | None = None,
                            device: "torch.device | str | None" = None
                            ) -> BandwidthSample:
    """One RST write stream over a fresh working buffer, in place.  The
    checksum is the buffer's first 8 rows after the write, as float32.
    Unlike the reference, which times its first (compiling) call, the
    port warms up first: every write stores the same bytes, so the timed
    runs leave the buffer as one run would."""
    dev = resolve_device(device)
    grid = grid_txns or default_grid(p.n, dev)
    operand = params_operand(p, dtype, burst_rows, grid)
    buf = make_working_buffer(p, dtype, device=dev)

    def run():
        return rst_write(operand, buf, grid_txns=grid, burst_rows=burst_rows)

    run()
    seconds = time_median(run, dev)
    return BandwidthSample(bytes_moved=min(p.n, grid) * p.b, seconds=seconds,
                           checksum=buf[:8].to(torch.float32).cpu().numpy())


def measure_duplex_bandwidth(p: RSTParams, *,
                             dtype: torch.dtype = torch.float32,
                             burst_rows: int = SUBLANE,
                             grid_txns: int | None = None,
                             device: "torch.device | str | None" = None
                             ) -> BandwidthSample:
    """Mixed read/write traffic: both RST engines traverse one working
    buffer (the paper's duplex mode, Sec. III-C-1 — read and write modules
    run concurrently on one channel).  The two kernels run back to back on
    one stream; bytes moved counts both directions (2·N·B over the time
    of the pair).  The checksum is the read engine's on the fresh buffer,
    taken in the warm-up before any write; the timed pairs then read what
    the write left, the same number of bytes."""
    dev = resolve_device(device)
    grid = grid_txns or default_grid(p.n, dev)
    operand = params_operand(p, dtype, burst_rows, grid)
    buf = make_working_buffer(p, dtype, device=dev)

    def run():
        chk = rst_read(operand, buf, grid_txns=grid, burst_rows=burst_rows)
        rst_write(operand, buf, grid_txns=grid, burst_rows=burst_rows)
        return chk

    chk = run()
    checksum = chk.cpu().numpy()
    seconds = time_median(run, dev)
    return BandwidthSample(bytes_moved=2 * min(p.n, grid) * p.b,
                           seconds=seconds, checksum=checksum)
