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

``--grid`` runs only the grid-evaluation ladder (`bench_grid`): the
10,368-point HBM cross-product through the batched `torchgrid` tier on
the card, against the per-point NumPy model on a sample.

The campaign surfaces are the reference CLI's, on `sim`:
``--roofline`` (the measured-envelope rungs per spec), ``--tune`` (the
`layout_autotune` rungs through the `CampaignService`), and the default
suite's `oracle_autotune` row (the closed-form `MemoryOracle`, modeled).
``--service`` runs the campaign-service soak (DESIGN.md §10): a
duplicate-heavy batch served through `CampaignService` against a
fault-injected `sim` primary at each ``--fault-rate`` (comma list,
default ``0,0.01,0.1``) with `sim` fallback, asserting zero dropped
requests, coalesced duplicates and, at the highest non-zero rate, a
degraded response; ``--qps-target`` makes a floor of the sustained QPS
(host wall clock).  ``--catalog [PATH]`` prints the registry-generated
experiment catalog, or splices it between this package's catalog
markers in PATH (README.md).

``--json PATH`` also writes the rows (plus totals) as JSON;
``--experiments name1,name2`` restricts the registry suite (unknown names
fail with the registered list).  ``--engines N|MIX``, ``--arbitration
POLICY`` and ``--burst B`` override the contention experiments' engine
ladder (or custom engine mix) and grant granularity, as in the
reference's CLI.

Run: PYTHONPATH=src python -m repro_torch.bench [--quick] [--json PATH]
         [--experiments NAMES] [--engines N|MIX]
         [--arbitration POLICY [--burst B]] [--grid] [--roofline]
         [--tune] [--service [--fault-rate RATES] [--qps-target QPS]]
         [--catalog [PATH]]
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


def engine_ladder(max_engines):
    """The --engines N override: powers of two up to (and including) N."""
    if max_engines < 1:
        raise SystemExit(
            f"repro_torch.bench: --engines must be >= 1, got {max_engines}")
    ladder = []
    k = 1
    while k < max_engines:
        ladder.append(k)
        k *= 2
    ladder.append(max_engines)
    return tuple(ladder)


def parse_engines_arg(text):
    """Resolve the --engines value: a bare integer N (engine-count ladder)
    or a heterogeneous mix spec like '2r+1w+1d' (DESIGN.md §13).  Returns
    the int for the ladder form, the validated spec string for the mix
    form; exits with the accepted grammar on anything else."""
    from repro_torch.core.engine_mix import parse_mix_spec

    if text.isdigit():
        n = int(text)
        engine_ladder(n)        # validates >= 1 up front, not per suite
        return n
    try:
        parse_mix_spec(text)
    except ValueError as e:
        raise SystemExit(f"repro_torch.bench: --engines: {e}")
    return text


def bench_experiments(quick=False, experiments=None, engines=None,
                      arbitration=None, burst=None):
    """One row per (registered experiment, applicable spec), on `sim`.
    Single-spec experiments keep their bare row name; multi-spec ones are
    suffixed with the spec.  `engines` (--engines) replaces the engine
    ladder of every experiment with an "engines" option when an int, or
    the custom blend of every experiment with a "custom_mix" option when
    a mix spec; `arbitration`/`burst` (--arbitration/--burst) select the
    grant granularity for every experiment exposing that axis."""
    from repro_torch.core import spec_by_name
    from repro_torch.core.experiments import run_experiment

    rows = []
    for exp in resolve_experiments(experiments):
        specs = [spec_by_name(n)
                 for n in (exp.bench_specs or BENCH_SPEC_NAMES)]
        available = [s for s in specs if exp.available_on(s)]
        label = exp.bench_label or exp.name
        overrides = {}
        if isinstance(engines, int) and "engines" in exp.defaults:
            overrides["engines"] = engine_ladder(engines)
        elif isinstance(engines, str) and "custom_mix" in exp.defaults:
            overrides["custom_mix"] = engines
        if arbitration is not None and "arbitration" in exp.defaults:
            overrides["arbitration"] = arbitration
            if arbitration != "burst" and "burst_beats" in exp.defaults:
                # round_robin/exclusive fix the grant size; an
                # experiment's default burst_beats (e.g. the contended-
                # latency classes' 8) would fail validation.
                overrides["burst_beats"] = 1
        if burst is not None and "burst_beats" in exp.defaults:
            overrides["burst_beats"] = burst
        for spec in available:
            res, dt = _timed(lambda: run_experiment(
                exp, spec, quick=quick, bench=True, **overrides))
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


def grid_axes(quick=False):
    """The grid ladder's HBM cross-product (the reference ladder's axes):
    n = 2^17, 18 RST tuples x 4 policies x 3 ops x N in {1, 2, 4, 8} x
    4 grants x 3 placements = 10,368 points; --quick cuts it as the
    reference does.  Every lane is exactly periodic (pow2 everything, no
    exclusive grants), so the batched tier evaluates a two-window
    steady state per lane while the per-point NumPy path expands every
    command."""
    from repro_torch.core import HBM, RSTParams
    from repro_torch.core.address_mapping import policies_for
    from repro_torch.core.timing_torch import GridAxes

    n = 1 << 15 if quick else 1 << 17
    nparams = 6 if quick else 18
    params = tuple(RSTParams(n=n, b=32, s=256 << (i % 6),
                             w=(256 << (i % 6)) * (1 << (i // 6)))
                   for i in range(nparams))
    return GridAxes(
        params=params,
        policies=(None,) + tuple(policies_for(HBM))[:3],
        ops=("read", "write", "duplex"),
        num_engines=(1, 4) if quick else (1, 2, 4, 8),
        arbitrations=((("round_robin", 1), ("burst", 4)) if quick else
                      (("round_robin", 1), ("burst", 2), ("burst", 4),
                       ("burst", 8))),
        placements=("same_channel", "same_switch", "cross_switch"))


def grid_sample(axes, quick=False):
    """An evenly spaced sample of the grid's points: (lane index, point)."""
    pts = axes.sweep_points()
    step = max(1, len(pts) // (8 if quick else 48))
    return list(range(0, len(pts), step)), pts[::step]


def grid_mix_requests(axes, quick=False):
    """The ladder's heterogeneous engine-mix requests: three blends over
    the first grid tuples at n = 2^11, short enough that every blend
    stays on the stacked mixed-lane evaluator."""
    import dataclasses

    from repro_torch.core import EngineMix

    reqs = []
    for p in axes.params[: 3 if quick else 6]:
        mp = dataclasses.replace(p, n=1 << 11)
        for spec_str in ("3r+1w", "2r+2w", "2r+1w+1d"):
            mix = EngineMix.from_spec(spec_str, mp)
            reqs.append(("cont", mp, None, "read", len(mix),
                         "round_robin", 1, "same_channel", mix))
    return reqs


def bench_grid(quick=False):
    """The grid-evaluation ladder on the card: per-point NumPy on a
    sample, the whole cross-product through `torchgrid` cold and warm,
    the same split over `grid_mesh()`, and heterogeneous engine-mix
    lanes.  Raises without a card."""
    import torch

    from repro_torch.core import HBM, Sweep
    from repro_torch.core import timing_torch
    from repro_torch.launch.mesh import grid_mesh

    if not torch.cuda.is_available():
        raise RuntimeError("bench_grid needs a CUDA card")
    card = torch.cuda.get_device_name(0)
    axes = grid_axes(quick)
    _, sample = grid_sample(axes, quick)

    # Rung 1: the per-point NumPy model on the sample (the path the
    # batched tier exists to retire).
    def run_numpy():
        sweep = Sweep(HBM, backend="sim")
        for pt in sample:
            sweep.add_point(pt)
        sweep.run()
    _, numpy_us = _timed(run_numpy)
    numpy_pps = len(sample) / (numpy_us * 1e-6)
    rows = [("grid_per_point_numpy", numpy_us,
             f"sampled={len(sample)};pts_per_s={numpy_pps:.0f}")]

    # Rung 2: the whole cross-product in batched calls on the card.
    cold, cold_us = _timed(lambda: timing_torch.evaluate_grid(HBM, axes))
    warm, warm_us = _timed(lambda: timing_torch.evaluate_grid(HBM, axes))
    pps = warm.size / (warm_us * 1e-6)
    rows.append(("grid_torch_batched", warm_us,
                 f"points={warm.size};pts_per_s={pps:.0f};"
                 f"cold_s={cold_us * 1e-6:.3f};"
                 f"speedup_vs_numpy={pps / numpy_pps:.0f}x;device={card}"))

    # Rung 3: the lane axis split over every visible card.
    mesh = grid_mesh()
    timing_torch.evaluate_grid(HBM, axes, mesh=mesh)
    shard, shard_us = _timed(
        lambda: timing_torch.evaluate_grid(HBM, axes, mesh=mesh))
    rows.append(("grid_sharded", shard_us,
                 f"points={shard.size};devices={len(mesh)};"
                 f"pts_per_s={shard.size / (shard_us * 1e-6):.0f}"))

    # Rung 4: heterogeneous engine-mix lanes.
    mix_reqs = grid_mix_requests(axes, quick)
    timing_torch.evaluate_points(HBM, mix_reqs)
    _, mix_us = _timed(lambda: timing_torch.evaluate_points(HBM, mix_reqs))
    rows.append(("grid_hetero_mix", mix_us,
                 f"points={len(mix_reqs)};"
                 f"pts_per_s={len(mix_reqs) / (mix_us * 1e-6):.0f}"))
    return rows


def bench_oracle_autotune():
    """Framework integration: oracle efficiency + KV layout choice (the
    closed-form MemoryOracle at its defaults: modeled, not measured)."""
    from repro_torch.core import AccessPattern, MemoryOracle, choose_layout
    oracle = MemoryOracle()

    def run():
        eff = oracle.efficiency(AccessPattern(4096, 4096, 1 << 28))
        lay = choose_layout(oracle, {"seq": 32768, "kv_heads": 8,
                                     "head_dim": 128}, 2,
                            iterate_dim="seq",
                            fetch_dims=("kv_heads", "head_dim"))
        return eff, lay
    (eff, lay), dt = _timed(run)
    return [("oracle_autotune", dt,
             f"seq_eff={eff:.3f};kv_layout={'/'.join(lay.dims)}")]


def bench_roofline(quick):
    """Measured-envelope rungs: the empirical roofline per spec, on sim."""
    from repro_torch.core import spec_by_name
    from repro_torch.core.roofline_empirical import measure_envelope

    rows = []
    for name in BENCH_SPEC_NAMES:
        spec = spec_by_name(name)
        env, dt = _timed(lambda: measure_envelope(spec, quick=quick))
        tiers = ";".join(
            f"{''.join(w[0] for w in plc.split('_'))}"
            f"={env.placement_gbps[plc]:.2f}"
            for plc in ("same_channel", "same_switch", "cross_switch"))
        rows.append((f"roofline_envelope_{name}", dt,
                     f"peak_gbps={env.peak_gbps:.2f};"
                     f"knee_ai={env.knee_ai():.0f};{tiers}"))
    return rows


def bench_tune(quick):
    """Layout-autotune rungs, routed through the CampaignService so the
    rung exercises the dedup/coalescing path the tuner ships with.

    Asserts the service invariants on every run: responses ok, reports
    carry a measured winner, duplicate requests coalesce, and the search
    measured no more configs than its candidate space."""
    from repro_torch.service import CampaignService, ExperimentRequest

    svc = CampaignService("sim", "sim")
    rows = []
    for name in BENCH_SPEC_NAMES:
        req = ExperimentRequest.make("layout_autotune", name, quick=quick)
        resp, dt = _timed(lambda: svc.submit(req))
        assert resp.ok, f"layout_autotune[{name}] failed: {resp.error}"
        rep = resp.result
        assert rep.evaluations <= rep.candidates
        rows.append((f"layout_autotune_{name}", dt,
                     f"winner={rep.winner.describe()};"
                     f"gbps={rep.winner_gbps:.2f};"
                     f"evals={rep.evaluations}/{rep.candidates};"
                     f"nominal={rep.nominal_fraction:.2f}"))
        dup, dup_dt = _timed(lambda: svc.submit(req))
        assert dup.coalesced and dup.result == rep
        rows.append((f"layout_autotune_{name}_dedup", dup_dt,
                     "coalesced=True"))
    return rows


def parse_fault_rates(text):
    """Parse the --fault-rate comma list; exits cleanly on bad values."""
    rates = []
    for part in text.split(","):
        part = part.strip()
        try:
            rate = float(part)
        except ValueError:
            raise SystemExit(
                f"repro_torch.bench: --fault-rate: {part!r} is not a "
                f"number (expected a comma list like '0,0.01,0.1')")
        if not 0.0 <= rate <= 1.0:
            raise SystemExit(
                f"repro_torch.bench: --fault-rate must be in [0, 1], got "
                f"{rate}")
        rates.append(rate)
    if not rates:
        raise SystemExit("repro_torch.bench: --fault-rate: empty rate list")
    return tuple(rates)


def _service_request_mix(quick, n_requests):
    """A duplicate-heavy mixed batch over the hbm/ddr4 registry: ~16
    distinct request keys cycled (deterministically shuffled) out to
    `n_requests`, so coalescing has something to prove."""
    import numpy as np

    from repro_torch.service import ExperimentRequest

    templates = []
    for spec in BENCH_SPEC_NAMES:
        templates += [
            ExperimentRequest.make("fig6_address_mapping", spec, quick=True),
            ExperimentRequest.make("table4_idle_latency", spec, n=512),
            ExperimentRequest.make("fig4_refresh", spec, quick=True),
            ExperimentRequest.make("fig7_locality", spec, quick=True),
            ExperimentRequest.make("fig9_channel_contention", spec,
                                   quick=True),
            ExperimentRequest.make("table5_total_throughput", spec, n=2048),
            ExperimentRequest.make("duplex_rw_sweep", spec, quick=True),
            ExperimentRequest.make("contention_scaling_sweep", spec,
                                   quick=True),
            ExperimentRequest.make("engine_mix_sweep", spec, quick=True),
        ]
    reqs = [templates[i % len(templates)] for i in range(n_requests)]
    order = np.random.default_rng(0).permutation(len(reqs))
    return [reqs[i] for i in order]


def bench_service(quick=False, fault_rates=(0.0, 0.01, 0.1),
                  qps_target=None):
    """Campaign-service soak: one row per fault rate (DESIGN.md §10).

    Serves the mixed batch through `CampaignService` with a
    fault-injected sim primary (transient/timeout/corrupt mix) and a
    clean sim fallback, full oracle validation, then asserts the service
    invariants before reporting: zero dropped requests at every rate,
    duplicates coalesced (executed < requests), every response either
    oracle-validated or degraded-with-reason, and >= 1 exercised
    fallback at the highest non-zero rate.  `qps` is host wall clock.
    """
    from repro_torch.core import engine as engine_mod
    from repro_torch.service import (CampaignService, RetryPolicy,
                                     register_fault_injected)

    n_requests = 200 if quick else 1000
    requests = _service_request_mix(quick, n_requests)
    max_rate = max(fault_rates)
    rows = []
    for rate in fault_rates:
        primary = f"sim+faults@{rate:g}"
        register_fault_injected(
            "sim", name=primary, rate=rate, seed=7,
            kinds=("transient", "timeout", "corrupt", "unsupported"),
            weights=(0.5, 0.2, 0.15, 0.15), timeout_s=0.2, override=True)
        try:
            svc = CampaignService(
                primary, "sim", retry=RetryPolicy(max_attempts=8),
                validate_fraction=1.0, seed=11)
            responses, dt = _timed(lambda: svc.submit_all(requests))
            st = svc.stats
            assert st.dropped == 0, (
                f"service dropped {st.dropped} requests at rate {rate}")
            assert all(r.ok for r in responses), (
                f"non-ok responses at rate {rate}: "
                f"{[r.error for r in responses if not r.ok][:3]}")
            assert st.executed < st.requests and st.deduped > 0, (
                f"no coalescing at rate {rate}: {st}")
            assert all(r.validated is True or r.validated is None
                       or (r.degraded and r.degraded_reason)
                       for r in responses), (
                f"unvalidated, undegraded response at rate {rate}")
            if rate == max_rate and rate > 0:
                assert st.degraded >= 1, (
                    f"no fallback exercised at rate {rate}: {st}")
            if qps_target is not None:
                assert st.sustained_qps >= qps_target, (
                    f"sustained QPS {st.sustained_qps:.0f} below target "
                    f"{qps_target:.0f} at rate {rate}")
            rows.append((
                f"service_soak_fault{rate:g}", dt,
                f"requests={st.requests};executed={st.executed};"
                f"deduped={st.deduped};retries={st.retries};"
                f"degraded={st.degraded};breaker_opens={st.breaker_opens};"
                f"quarantines={st.quarantines};validated={st.validated};"
                f"dropped={st.dropped};qps={st.sustained_qps:.0f}"))
        finally:
            engine_mod._BACKEND_REGISTRY.pop(primary, None)
    return rows


def emit_catalog(target: str) -> None:
    """Print the registry-generated experiment catalog ("-") or splice it
    between this package's catalog markers of a markdown file (e.g.
    README.md)."""
    from repro_torch.core.experiments import (CATALOG_BEGIN, CATALOG_END,
                                              catalog_markdown)
    md = catalog_markdown()
    if target == "-":
        print(md)
        return
    with open(target) as f:
        text = f.read()
    lo, hi = text.find(CATALOG_BEGIN), text.find(CATALOG_END)
    if lo < 0 or hi < 0:
        raise SystemExit(
            f"--catalog: {target} has no '{CATALOG_BEGIN}' .. "
            f"'{CATALOG_END}' markers to splice between")
    with open(target, "w") as f:
        f.write(text[:lo] + md + text[hi + len(CATALOG_END):])
    print(f"updated experiment catalog in {target}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write rows as JSON at PATH")
    ap.add_argument("--experiments", metavar="NAMES", default=None,
                    help="comma-separated experiment names to benchmark "
                         "(default: every registered experiment); unknown "
                         "names fail with the registered list")
    ap.add_argument("--engines", metavar="N|MIX", default=None,
                    help="override the engine-count ladder of the "
                         "contention experiments with powers of two up to "
                         "N (e.g. 16 -> 1,2,4,8,16), or — as a mix spec "
                         "like 2r+1w+1d — the custom blend of the "
                         "engine-mix experiments (DESIGN.md §13)")
    ap.add_argument("--arbitration", metavar="POLICY", default=None,
                    choices=("round_robin", "burst", "exclusive"),
                    help="shared-port arbitration granularity for every "
                         "experiment exposing the axis (DESIGN.md §9): "
                         "round_robin, burst, or exclusive")
    ap.add_argument("--burst", type=int, metavar="B", default=None,
                    help="beats per arbitration grant (with "
                         "--arbitration burst)")
    ap.add_argument("--grid", action="store_true",
                    help="run only the grid-evaluation ladder on the card "
                         "(per-point NumPy, torchgrid cold and warm, "
                         "sharded, mixed lanes)")
    ap.add_argument("--catalog", metavar="PATH", nargs="?", const="-",
                    default=None,
                    help="emit the registry-generated experiment catalog "
                         "and exit: to stdout, or spliced between this "
                         "package's catalog markers of PATH (README.md)")
    ap.add_argument("--service", action="store_true",
                    help="run the campaign-service fault-injection soak "
                         "instead of the registry benches (DESIGN.md §10)")
    ap.add_argument("--roofline", action="store_true",
                    help="run the measured-envelope rungs "
                         "(core/roofline_empirical.py, on sim) instead of "
                         "the registry benches")
    ap.add_argument("--tune", action="store_true",
                    help="run the layout-autotune rungs through the "
                         "campaign service (on sim) instead of the "
                         "registry benches")
    ap.add_argument("--fault-rate", metavar="RATES", default=None,
                    help="comma list of injected fault rates in [0, 1] for "
                         "--service (default: 0,0.01,0.1)")
    ap.add_argument("--qps-target", type=float, metavar="QPS", default=None,
                    help="with --service: fail if sustained QPS falls "
                         "below this at any fault rate")
    args = ap.parse_args(argv)
    if not args.service:
        if args.fault_rate is not None:
            ap.error("--fault-rate only applies with --service")
        if args.qps_target is not None:
            ap.error("--qps-target only applies with --service")
    if sum((args.service, args.grid, args.roofline, args.tune)) > 1:
        ap.error("--service, --grid, --roofline and --tune are separate "
                 "modes")
    fault_rates = (parse_fault_rates(args.fault_rate)
                   if args.fault_rate is not None else (0.0, 0.01, 0.1))
    if args.qps_target is not None and args.qps_target <= 0:
        ap.error(f"--qps-target must be > 0, got {args.qps_target:g}")
    if args.engines is not None:
        args.engines = parse_engines_arg(args.engines)
    if args.burst is not None and args.burst < 1:
        ap.error(f"--burst must be >= 1, got {args.burst}")
    if args.burst is not None and args.arbitration != "burst":
        ap.error("--burst only applies with --arbitration burst "
                 "(round_robin and exclusive fix the grant size)")
    if args.catalog is not None:
        emit_catalog(args.catalog)
        return
    q = args.quick
    if args.json:
        json_dir = os.path.dirname(os.path.abspath(args.json))
        if os.path.isdir(args.json) or not os.path.isdir(json_dir):
            ap.error(f"--json: {args.json!r} is not a writable file path")

    print("name,us_per_call,derived")
    if args.grid:
        suites = [lambda: bench_grid(q)]
    elif args.service:
        suites = [lambda: bench_service(q, fault_rates, args.qps_target)]
    elif args.roofline:
        suites = [lambda: bench_roofline(q)]
    elif args.tune:
        suites = [lambda: bench_tune(q)]
    else:
        suites = [
            lambda: bench_experiments(q, args.experiments, args.engines,
                                      args.arbitration, args.burst),
            bench_table3_resources,
            lambda: bench_h100_rst_kernel(q),
            bench_oracle_autotune,
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
        payload = {"benchmark": ("shuhai-grid-torch" if args.grid
                                 else "shuhai-campaign-service-torch"
                                 if args.service
                                 else "shuhai-roofline-torch"
                                 if args.roofline
                                 else "shuhai-tune-torch" if args.tune
                                 else "shuhai-campaign-torch"), "quick": q,
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
