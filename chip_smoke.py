"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card's name, count, and nvidia-smi's name and power
     limit; exits non-zero without a CUDA card;
  2. build: compiles src/repro_torch/kernels/csrc/rst.cu for sm_90a and
     prints what ptxas reports for each kernel (registers, shared memory);
  3. kernels against their plain PyTorch versions on the card: the cases
     of the reference's kernel tests at small size in every dtype, the
     grid clamp, and the main path's full-size traversals (f32, 4 KiB
     tiles, 65536 transactions), which must agree exactly;
  4. main path: read, write and duplex points through
     Sweep(HBM, backend="cuda") -> Engine -> CudaBackend -> kernels, with
     the launch counters set to 0 just before and read just after (the
     single-tile hammer traversal runs from L2, and is labelled so); then
     the bench CLI on the headline sim experiments and the device rung;
  5. report: kernel, plain and library times beside the bound, one JSON
     line of kernels, the nvidia-smi line, and the final JSON line.

It imports torch and the port (repro_torch) only.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet: 3.35 TB/s device memory, 67 TFLOP/s float32 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

TILE_ROWS = 8                    # burst_rows: 8 x 128 float32 = 4 KiB
FULL_N = 65536                   # transactions of a full-size point
# Traversals of the main path: (stride, window) in 4 KiB tiles.  seq and
# strided4 sweep a 256 MiB window, five times the card's 50 MB L2.
# hammer (S = W) revisits one tile, which stays in L2; its window is 64
# tiles because the operand's int32 guard, kept from the reference,
# refuses (n - 1) * S/B > 2**31 - 1, and one tile is all it touches.
PATTERNS = {"seq": (1, 65536), "strided4": (4, 65536), "hammer": (64, 64)}

# Cases of tests/kernels/test_rst_kernels.py (burst_rows, stride, wset, n)
# and (burst_rows, stride, wset, n, base).
READ_CASES = [(8, 1, 8, 8), (8, 1, 8, 20), (8, 2, 16, 16), (8, 4, 8, 9),
              (16, 1, 4, 7), (8, 8, 8, 5)]
WRITE_CASES = [(8, 1, 8, 8, 0), (8, 3, 8, 12, 0), (8, 2, 8, 3, 2),
               (16, 1, 6, 4, 1)]

HEADLINES = ["tREFI_est_ns=3900", "tREFI_est_ns=7800",
             "page_hit=106.7ns;page_closed=122.2ns;page_miss=137.8ns",
             "default_seq_gbps=6.64", "default_seq_gbps=18.06",
             "w8k_s4k_gbps=6.64;w256m_s4k_gbps=2.51",
             "total_gbps=424.9", "total_gbps=36.1", "spread=22cyc",
             "min_gbps=13.28"]
HEADLINE_EXPERIMENTS = ("fig4_refresh,table4_idle_latency,"
                        "fig6_address_mapping,fig7_locality,"
                        "table5_total_throughput,table6_switch_latency,"
                        "fig8_switch_throughput")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def environment():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    phase("1. environment")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device: {name}; count: {count}; nvidia-smi: {smi}", flush=True)
    return name, count, smi


def build():
    from repro_torch.kernels import _build

    phase("2. build")
    path, log = _build.build()
    print(f"built {os.path.relpath(path, ROOT)} with {_build.nvcc()}")
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    _build.library()


def numpy_buffer(rows: int, dtype, seed: int):
    """tests/kernels/test_rst_kernels.py::_mk, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-4, 5, size=(rows, 128),
                                          dtype=np.int8))
    else:
        x = torch.from_numpy(
            rng.standard_normal((rows, 128)).astype(np.float32)).to(dtype)
    return x.cuda()


def full_params(pattern: str):
    from repro_torch.core import RSTParams

    tile = TILE_ROWS * 128 * 4
    stride, window = PATTERNS[pattern]
    return RSTParams(n=FULL_N, b=tile, s=tile * stride, w=tile * window)


def compare_kernels(errors):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_read import rst_read, rst_read_plain
    from repro_torch.kernels.rst_write import rst_write, rst_write_plain

    phase("3. kernels against their plain versions, on the card")
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        rtol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        for burst_rows, stride, wset, n in READ_CASES:
            buf = numpy_buffer(wset * burst_rows, dtype, seed=0)
            params = torch.tensor([stride, wset, 0, n], dtype=torch.int32)
            kw = dict(grid_txns=max(n, 4), burst_rows=burst_rows)
            got = rst_read(params, buf, **kw)
            want = rst_read_plain(params, buf, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4)
            errors["rst_read"] = max(errors["rst_read"],
                                     (got - want).abs().max().item())
        print(f"rst_read {dtype}: {len(READ_CASES)} cases agree "
              f"(rtol {rtol}, atol 1e-4)")
    buf = numpy_buffer(64, torch.float32, seed=0)
    params = torch.tensor([1, 8, 0, 99], dtype=torch.int32)
    got = rst_read(params, buf, grid_txns=16)
    torch.testing.assert_close(got, rst_read_plain(params, buf, grid_txns=16),
                               rtol=1e-5, atol=1e-4)
    print("rst_read: n beyond the grid is clamped to the grid")
    for dtype in (torch.float32, torch.bfloat16):
        for burst_rows, stride, wset, n, base in WRITE_CASES:
            src = numpy_buffer((base + wset) * burst_rows, dtype, seed=1)
            params = torch.tensor([stride, wset, base, n], dtype=torch.int32)
            kw = dict(grid_txns=max(n, 4), burst_rows=burst_rows)
            got = rst_write(params, src.clone(), **kw)
            want = rst_write_plain(params, src.clone(), **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"rst_write {dtype} case {(burst_rows, stride, wset, n, base)}"
                     f" differs from its plain version")
        print(f"rst_write {dtype}: {len(WRITE_CASES)} cases equal exactly")

    for pattern in PATTERNS:
        p = full_params(pattern)
        operand = ops.params_operand(p, torch.float32, TILE_ROWS)
        buf = ops.make_working_buffer(p, torch.float32)
        got = rst_read(operand, buf, grid_txns=p.n)
        want = rst_read_plain(operand, buf, grid_txns=p.n)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"full-size rst_read {pattern}: max abs err "
                 f"{(got - want).abs().max().item()} (must be exact)")
        got_w = rst_write(operand, buf.clone(), grid_txns=p.n)
        want_w = rst_write_plain(operand, buf.clone(), grid_txns=p.n)
        torch.cuda.synchronize()
        if not torch.equal(got_w, want_w):
            fail(f"full-size rst_write {pattern} differs from plain")
        print(f"full size {pattern} (n={p.n}, W={p.w >> 10} KiB, "
              f"B={p.b}): read checksum sum {got.sum().item():.0f} and "
              f"written buffer equal their plain versions exactly")
        del buf, got_w, want_w


def expected_checksum(p, op: str) -> float:
    """The checksum the cuda backend reports for (p, op), from the plain
    versions on a fresh working buffer: the read engine's tile sum, or
    the first 8 rows of the buffer after the write."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_read import rst_read_plain
    from repro_torch.kernels.rst_write import rst_write_plain

    operand = ops.params_operand(p, torch.float32, TILE_ROWS)
    buf = ops.make_working_buffer(p, torch.float32)
    if op == "write":
        out = rst_write_plain(operand, buf, grid_txns=p.n)[:8]
    else:
        out = rst_read_plain(operand, buf, grid_txns=p.n)
    return out.to(torch.float64).sum().item()


def main_path():
    import torch

    from repro_torch.core import HBM, Sweep
    from repro_torch.kernels.rst_read import rst_read
    from repro_torch.kernels.rst_write import rst_write

    phase("4. main path: Sweep(HBM, backend='cuda') -> Engine -> CudaBackend")
    sweep = Sweep(HBM, backend="cuda")
    names = {}
    for pattern in PATTERNS:
        names[full_params(pattern)] = pattern
        for op in ("read", "write", "duplex"):
            sweep.add(full_params(pattern), op=op)
    rst_read.launches = 0
    rst_write.launches = 0
    results = sweep.run()
    launches = {"rst_read": rst_read.launches, "rst_write": rst_write.launches}
    torch.cuda.synchronize()
    print(f"launches during the main path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the main path launched {name} no time")
    for r in results:
        p, op = r.point.params, r.point.op
        pattern = names[p]
        want = (2 if op == "duplex" else 1) * p.n * p.b
        gbps = r.value.gbps
        if r.value.detail["bytes"] != want:
            fail(f"{pattern} {op}: moved {r.value.detail['bytes']} bytes, "
                 f"want {want}")
        if not (math.isfinite(gbps) and gbps > 0):
            fail(f"{pattern} {op}: gbps {gbps} is not a positive number")
        if r.value.detail["checksum"] != expected_checksum(p, op):
            fail(f"{pattern} {op}: checksum {r.value.detail['checksum']} "
                 f"!= {expected_checksum(p, op)} from the plain versions")
        # A stream of distinct tiles far larger than L2 comes from device
        # memory and cannot beat its data-sheet rate.  strided4 reads its
        # 64 MiB of tiles four times, partly from L2, and hammer one tile.
        if pattern == "seq" and gbps > 1.1 * PEAK_BYTES_PER_S / 1e9:
            fail(f"{pattern} {op}: {gbps:.1f} GB/s exceeds the card's "
                 f"{PEAK_BYTES_PER_S / 1e9:.0f} GB/s: work was skipped")
        label = {"hammer": "hammer (one tile, L2-resident)",
                 "strided4": "strided4 (revisits partly from L2)"}.get(
                     pattern, pattern)
        print(f"main path {label} {op}: {gbps:.1f} GB/s, checksum sum "
              f"{r.value.detail['checksum']:.0f}, "
              f"{r.value.detail['seconds'] * 1e3:.4f} ms, "
              f"{r.value.detail['bytes']:.0f} bytes")
    return launches


def bench_cli():
    phase("4b. bench CLI: python -m repro_torch.bench --quick")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", "--quick",
         "--experiments", HEADLINE_EXPERIMENTS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        check=False)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        fail(f"repro_torch.bench exited {proc.returncode}")
    for text in HEADLINES:
        if text not in proc.stdout:
            fail(f"bench output lacks the headline {text!r}")
    print("bench headlines match the paper's numbers")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` calls, CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(launches, errors, smi):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rst_read import (rst_read, rst_read_plain,
                                              tile_indices)
    from repro_torch.kernels.rst_write import rst_write, rst_write_plain

    phase("5. report: times at the main path's shapes (f32, B = 4 KiB, "
          "n = 65536)")
    print(f"card: {smi}")
    rows = {}
    for pattern in PATTERNS:
        p = full_params(pattern)
        operand = ops.params_operand(p, torch.float32, TILE_ROWS)
        stride, wset, base, n = operand.tolist()
        buf = ops.make_working_buffer(p, torch.float32)
        view = buf.view(-1, TILE_ROWS * 128)
        idx = tile_indices(stride, wset, base, n, buf.device)
        unique = torch.unique(idx).numel()
        tile = p.b
        # Least bytes: each input tile read once and the checksum tile
        # written once (read); each touched tile written once (write).
        read_bytes = unique * tile + tile
        write_bytes = unique * tile
        # One float32 add per element read; a store is no operation.
        read_ops_ms = n * tile / 4 / PEAK_F32_FLOP_PER_S * 1e3
        read_bytes_ms = read_bytes / PEAK_BYTES_PER_S * 1e3
        write_bound = write_bytes / PEAK_BYTES_PER_S * 1e3
        lo, hi = int(idx.min()), int(idx.max()) + 1
        window = view[lo:hi] if hi - lo == unique else view[idx.unique()]
        kw = dict(grid_txns=n)
        read = {
            "ms": cuda_ms(lambda: rst_read(operand, buf, **kw), 20),
            "plain_ms": cuda_ms(lambda: rst_read_plain(operand, buf, **kw), 3),
            "library_ms": cuda_ms(
                lambda: window.sum(0, dtype=torch.float32), 20),
            "bound_ms": max(read_bytes_ms, read_ops_ms),
            "bound_by": ("bytes" if read_bytes_ms >= read_ops_ms
                         else "operations")}
        fill = window.clone() if hi - lo != unique else window
        write = {
            "ms": cuda_ms(lambda: rst_write(operand, buf, **kw), 20),
            "plain_ms": cuda_ms(lambda: rst_write_plain(operand, buf, **kw), 3),
            "library_ms": cuda_ms(lambda: fill.fill_(1.0), 20),
            "bound_ms": write_bound, "bound_by": "bytes"}
        for kernel, t in (("rst_read", read), ("rst_write", write)):
            label = f"{pattern}_l2" if pattern == "hammer" else pattern
            gbps = n * tile / (t["ms"] * 1e-3) / 1e9
            print(f"{kernel} {label}: kernel_ms={t['ms']:.5f} "
                  f"plain_ms={t['plain_ms']:.5f} "
                  f"library_ms={t['library_ms']:.5f} "
                  f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) "
                  f"gbps={gbps:.1f} "
                  f"launches={launches[kernel]} card={smi}")
            rows[(kernel, pattern)] = t
        del buf, window, fill
    kernels = []
    for kernel, replaces in (("rst_read", "src/repro/kernels/rst_read.py:61"),
                             ("rst_write",
                              "src/repro/kernels/rst_write.py:45")):
        t = rows[(kernel, "seq")]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rst.cu",
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": errors[kernel], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return kernels


def main() -> None:
    name, count, smi = environment()
    sys.path.insert(0, SRC)
    build()
    errors = {"rst_read": 0.0, "rst_write": 0.0}
    compare_kernels(errors)
    launches = main_path()
    bench_cli()
    kernels = measure(launches, errors, smi)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
