"""Benchmark CLI of the port, in the shape of the reference's
``benchmarks/run.py``.

Every paper table/figure is a registered `Experiment`
(repro_torch/core/experiments.py); `bench_experiments` runs each one on the
`sim` backend per applicable memory spec and prints
``name,us_per_call,derived`` CSV rows.  `us_per_call` is host wall time of
the run; `derived` carries the headline quantity the paper reports for
that artifact (each experiment's `summarize`).  The device rungs below are
not paper artifacts: `bench_table3_resources` reports the engine's
on-chip footprint per tile, and `bench_h100_rst_kernel` measures RST read,
write and duplex streams with the CUDA kernels on the card, naming the
card beside each number.  With no CUDA card the device rung fails: a host
time is never printed as a device number.

``--json PATH`` also writes the rows (plus totals) as JSON;
``--experiments name1,name2`` restricts the registry suite (unknown names
fail with the registered list).

Run: PYTHONPATH=src python -m repro_torch.bench [--quick] [--json PATH]
         [--experiments NAMES]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    dt = (time.perf_counter() - t0) * 1e6
    return out, dt


# Specs the registry-driven rows run over by default: the paper's measured
# pair (the reference harness's row names).  Experiments that set
# `bench_specs` override this per experiment.
BENCH_SPEC_NAMES = ("hbm", "ddr4")

# The device rung's traversals: (stride, window) in 4 KiB tiles.  The
# 256 MiB window (65536 tiles) is the paper's pseudo-channel window and
# five times the H100's 50 MB L2, so the sequential and strided streams
# read device memory.  "hammer" (S = W) revisits one tile, which stays in
# L2: it measures the cache, and is labelled so.  Its window is 64 tiles
# because the operand's int32 guard, kept from the reference, refuses
# (n - 1) * S/B > 2**31 - 1; one tile is all it touches either way.
H100_PATTERNS = {"seq": (1, 65536), "strided4": (4, 65536),
                 "hammer": (64, 64)}


def resolve_experiments(names):
    """Resolve a comma-separated experiment filter against the registry;
    exits with the registered list on an unknown name."""
    from repro_torch.core.experiments import all_experiments, get_experiment

    if not names:
        return all_experiments()
    try:
        return [get_experiment(n.strip()) for n in names.split(",")]
    except ValueError as e:
        raise SystemExit(f"repro_torch.bench: {e}")


def bench_experiments(quick=False, experiments=None):
    """One row per (registered experiment, applicable spec), on `sim`.
    Single-spec experiments keep their bare row name; multi-spec ones are
    suffixed with the spec."""
    from repro_torch.core import spec_by_name
    from repro_torch.core.experiments import run_experiment

    rows = []
    for exp in resolve_experiments(experiments):
        specs = [spec_by_name(n)
                 for n in (exp.bench_specs or BENCH_SPEC_NAMES)]
        available = [s for s in specs if exp.available_on(s)]
        label = exp.bench_label or exp.name
        for spec in available:
            res, dt = _timed(lambda: run_experiment(
                exp, spec, quick=quick, bench=True))
            name = label if len(available) == 1 else f"{label}_{spec.name}"
            rows.append((name, dt, exp.summary(spec, res)))
    return rows


def bench_table3_resources():
    """Table III analogue: the engine's on-chip footprint per RST tile
    (vs FPGA LUTs/BRAM).  The CUDA read engine keeps the tile's running
    sum in registers (one 16-byte slot per thread) and uses no shared
    memory; the two 256-bit control registers become 64 bytes of launch
    arguments."""
    import torch

    from repro_torch.kernels import ops

    def run():
        tile = ops.tile_bytes(torch.float32)
        return {"smem_tile_bytes": 0, "register_tile_bytes": tile,
                "register_bytes": 2 * 32}

    res, dt = _timed(run)
    return [("table3_resources_h100", dt,
             f"smem_tile_bytes={res['smem_tile_bytes']};"
             f"register_tile_bytes={res['register_tile_bytes']};"
             f"register_bytes={res['register_bytes']}")]


def bench_h100_rst_kernel(quick=False):
    """The RST engines on the CUDA card: read, write and duplex bandwidth
    of one stream, for sequential and 4-tile-strided traversals of a
    256 MiB window and a single-tile (L2-resident) one.  Raises without a
    card."""
    import torch

    from repro_torch.core.params import RSTParams
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        raise RuntimeError("bench_h100_rst_kernel needs a CUDA card")
    card = torch.cuda.get_device_name(0)
    tile = ops.tile_bytes(torch.float32)
    n = 16384 if quick else 65536
    measurers = {"read": ops.measure_read_bandwidth,
                 "write": ops.measure_write_bandwidth,
                 "duplex": ops.measure_duplex_bandwidth}
    rows = []
    for name, (s_tiles, w_tiles) in H100_PATTERNS.items():
        p = RSTParams(n=n, b=tile, s=tile * s_tiles, w=tile * w_tiles)
        label = f"{name}_l2" if name == "hammer" else name
        for op, measure in measurers.items():
            sample, dt = _timed(lambda m=measure, p=p: m(p))
            rows.append((f"h100_rst_{op}_{label}", dt,
                         f"bytes={sample.bytes_moved};"
                         f"gbps={sample.gbps:.1f};device={card}"))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write rows as JSON at PATH")
    ap.add_argument("--experiments", metavar="NAMES", default=None,
                    help="comma-separated experiment names to benchmark "
                         "(default: every registered experiment); unknown "
                         "names fail with the registered list")
    args = ap.parse_args(argv)
    q = args.quick
    if args.json:
        json_dir = os.path.dirname(os.path.abspath(args.json))
        if os.path.isdir(args.json) or not os.path.isdir(json_dir):
            ap.error(f"--json: {args.json!r} is not a writable file path")

    print("name,us_per_call,derived")
    suites = [
        lambda: bench_experiments(q, args.experiments),
        bench_table3_resources,
        lambda: bench_h100_rst_kernel(q),
    ]
    rows: List[dict] = []
    failures = 0
    t0 = time.perf_counter()
    for suite in suites:
        try:
            for name, us, derived in suite():
                print(f"{name},{us:.0f},{derived}", flush=True)
                rows.append({"name": name, "us_per_call": round(us, 1),
                             "derived": derived})
        except Exception as e:  # report the suite and go on to the next
            failures += 1
            print(f"ERROR,{suite},{type(e).__name__}: {e}", file=sys.stderr)
    wall_us = (time.perf_counter() - t0) * 1e6

    if args.json:
        payload = {"benchmark": "shuhai-campaign-torch", "quick": q,
                   "unix_time": time.time(), "wall_us": round(wall_us, 1),
                   "suite_us_total":
                       round(sum(r["us_per_call"] for r in rows), 1),
                   "failures": failures, "rows": rows}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")

    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
