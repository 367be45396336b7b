"""Declarative experiment registry: each paper table/figure as one spec.

The paper's closing claim is that Shuhai "can be easily generalized to
other FPGA boards or other generations of memory" — this module is that
claim as code.  Every artifact of Sec. V/VI is a single :class:`Experiment`
object: a *plan* that lays an ``(RSTParams × policy × channel × op)`` grid
for any :class:`~repro_torch.core.hwspec.MemorySpec`, and a named *derive* reducer
that turns the evaluated grid back into the table/figure quantities.  One
generic runner, :func:`run_experiment`, lowers any spec onto
:class:`~repro_torch.core.sweep.Sweep` for batched (memoized, channel-broadcast)
execution on any registered backend.

Beyond the paper's read-only artifacts, a write-path family (Sec. IV as
first-class workloads: ``table5_write_throughput``, ``fig7_write_locality``,
``duplex_rw_sweep``) exercises the write and duplex directions of the
timing model / CUDA kernels on every registered memory system.

The entry points are thin views over this registry:
`ShuhaiCampaign.suite_*` (deprecated shims) and `repro_torch.bench`
(CSV/JSON rows via each experiment's `summarize`).  None of them contain
grid logic of their own.

Extending the library (DESIGN.md §6):

* new memory generation — ``hwspec.register_spec`` + an
  ``address_mapping.register_policies`` table; every experiment whose
  requirements the spec meets runs unchanged (HBM3/DDR3 ship built in);
* new execution substrate — subclass ``engine.Backend`` and
  ``engine.register_backend`` it;
* new measurement — build an :class:`Experiment` and
  :func:`register_experiment` it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.address_mapping import DEFAULT_POLICY, policies_for
from repro_torch.core.channels import topology_for
from repro_torch.core.engine_mix import EngineMix
from repro_torch.core.hwspec import HBM, MemorySpec
from repro_torch.core.latency import LatencyModule
from repro_torch.core.params import RSTParams
from repro_torch.core.engine import get_backend
from repro_torch.core.sweep import (KIND_CONTENTION, KIND_LATENCY,
                              KIND_THROUGHPUT, Sweep, SweepPoint)
from repro_torch.core.switch import PLACEMENTS, SwitchModel
from repro_torch.core.timing_model import (_contended_latency_delay,
                                     refresh_interval_estimate)

MB = 1024**2

# One planned grid entry: the caller-meaningful key the derive reducer will
# see, plus the sweep point that produces its value.
PlannedPoint = Tuple[Any, SweepPoint]
Plan = Callable[[MemorySpec, Mapping[str, Any]], List[PlannedPoint]]
Derive = Callable[[MemorySpec, List[Tuple[Any, Any]], Mapping[str, Any]], Any]


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One paper table/figure as a declarative spec.

    `plan` builds the keyed grid for a memory spec + options; `derive`
    reduces the keyed sweep values to the artifact's result structure.
    `summarize` renders the one-line headline used by repro_torch.bench;
    `flatten` renders (key, value) CSV rows for the example driver.
    `defaults` are the canonical paper options; `quick` overlays them for
    fast CI runs; `bench` overlays them for the benchmark harness.
    """

    name: str                       # registry key, e.g. "fig6_address_mapping"
    artifact: str                   # paper reference, e.g. "Fig. 6"
    title: str
    plan: Plan
    derive: Derive
    defaults: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    quick: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    bench: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    requires_switch: bool = False
    summarize: Optional[Callable[[MemorySpec, Any], str]] = None
    flatten: Optional[Callable[[MemorySpec, Any], List[Tuple[str, str]]]] = None
    # Historical benchmark row prefix, where it differs from `name` (keeps
    # BENCH_*.json perf trajectories comparable across the redesign).
    bench_label: Optional[str] = None
    # Spec names repro_torch.bench times this experiment on.  None keeps
    # the harness default (the paper's measured hbm/ddr4 pair — widening it
    # would rename historical BENCH_*.json rows); the write/duplex family
    # opts into all four registered systems explicitly.
    bench_specs: Optional[Tuple[str, ...]] = None

    def available_on(self, spec: MemorySpec) -> bool:
        return spec.has_switch or not self.requires_switch

    def summary(self, spec: MemorySpec, result: Any) -> str:
        """One-line headline; falls back to a repr for experiments that
        register no `summarize` of their own."""
        if self.summarize is not None:
            return self.summarize(spec, result)
        return repr(result)[:120]

    def rows(self, spec: MemorySpec, result: Any) -> List[Tuple[str, str]]:
        """(key, value) CSV rows; falls back to one repr row for
        experiments that register no `flatten` of their own."""
        if self.flatten is not None:
            return self.flatten(spec, result)
        return [("result", repr(result)[:120])]

    def options(self, *, quick: bool = False, bench: bool = False,
                **overrides) -> Dict[str, Any]:
        """defaults <- bench overlay <- quick overlay <- explicit overrides
        (None-valued overrides fall back to the layered value)."""
        out = dict(self.defaults)
        if bench:
            out.update(self.bench)
        if quick:
            out.update(self.quick)
        out.update({k: v for k, v in overrides.items() if v is not None})
        unknown = set(out) - set(self.defaults)
        if unknown:
            raise TypeError(
                f"{self.name}: unknown option(s) {sorted(unknown)}; "
                f"valid: {sorted(self.defaults)}")
        return out


_EXPERIMENT_REGISTRY: Dict[str, Experiment] = {}


def register_experiment(exp: Experiment, *, override: bool = False
                        ) -> Experiment:
    if exp.name in _EXPERIMENT_REGISTRY and not override:
        raise ValueError(
            f"experiment {exp.name!r} already registered; pass "
            f"override=True to replace it")
    _EXPERIMENT_REGISTRY[exp.name] = exp
    return exp


def get_experiment(name: str) -> Experiment:
    exp = _EXPERIMENT_REGISTRY.get(name)
    if exp is None:
        raise ValueError(f"unknown experiment {name!r}; registered: "
                         f"{list(_EXPERIMENT_REGISTRY)}")
    return exp


def all_experiments() -> List[Experiment]:
    """Every registered experiment, registration (= paper) order."""
    return list(_EXPERIMENT_REGISTRY.values())


def experiments_for(spec: MemorySpec) -> List[Experiment]:
    return [e for e in all_experiments() if e.available_on(spec)]


def plan_experiment(experiment: "Experiment | str", spec: MemorySpec = HBM,
                    *, quick: bool = False, bench: bool = False,
                    **options) -> Tuple[List[PlannedPoint], Dict[str, Any]]:
    """Resolve options and lay one experiment's keyed grid WITHOUT
    executing it.

    This is the request-level entry point: the campaign service
    (repro/service/campaign.py) lowers each accepted request through it,
    then batches the returned points onto its own (coalescing, fault-
    tolerant) Sweep and finishes with `Experiment.derive`.  Returns the
    ``(key, SweepPoint)`` pairs in plan order plus the resolved options
    `derive` must be called with.
    """
    exp = (get_experiment(experiment) if isinstance(experiment, str)
           else experiment)
    if not exp.available_on(spec):
        raise ValueError(
            f"experiment {exp.name!r} needs an inter-channel switch, which "
            f"the {spec.name} controller does not have (Sec. IV-D)")
    opts = exp.options(quick=quick, bench=bench, **options)
    return exp.plan(spec, opts), opts


def backend_capability_gap(backend, planned: List[PlannedPoint]
                           ) -> Optional[str]:
    """Why `backend` cannot execute a plan — None when it can.

    Serial-latency points need per-transaction timers
    (`supports_latency`, DESIGN.md §2); contention points need a
    multi-engine path (`supports_contention`, DESIGN.md §8).  The
    campaign service uses a non-None gap as a degradation trigger
    (cuda -> sim) instead of an error.
    """
    impl = get_backend(backend) if isinstance(backend, str) else backend
    if not impl.supports_latency and any(
            pt.kind == KIND_LATENCY for _, pt in planned):
        return (f"needs serial-latency measurements, which backend "
                f"{impl.name!r} does not provide (supports_latency=False)")
    if not impl.supports_contention and any(
            pt.kind == KIND_CONTENTION for _, pt in planned):
        return (f"needs multi-engine contention support, which backend "
                f"{impl.name!r} does not provide "
                f"(supports_contention=False)")
    return None


def run_experiment(experiment: "Experiment | str", spec: MemorySpec = HBM,
                   backend: str = "sim", *, quick: bool = False,
                   bench: bool = False, **options) -> Any:
    """Lower one experiment spec onto a Sweep and reduce the results.

    The whole grid executes as one batched `Sweep.run()` (memoized,
    channel-broadcast on deterministic backends); `derive` only ever sees
    ``(key, value)`` pairs in plan order.
    """
    exp = (get_experiment(experiment) if isinstance(experiment, str)
           else experiment)
    planned, opts = plan_experiment(exp, spec, quick=quick, bench=bench,
                                    **options)
    gap = backend_capability_gap(backend, planned)
    if gap is not None:
        raise ValueError(
            f"experiment {exp.name!r} {gap}; use the sim backend "
            f"(DESIGN.md §2/§8)")
    sweep = Sweep(spec, backend)
    for _, pt in planned:
        sweep.add_point(pt)
    values = [r.value for r in sweep.run()]
    keyed = [(key, v) for (key, _), v in zip(planned, values)]
    return exp.derive(spec, keyed, opts)


# ---------------------------------------------------------------------------
# grid/derive helpers
# ---------------------------------------------------------------------------


def _tp_point(p: RSTParams, policy=None, channel=0, dst_channel=None,
              op="read") -> SweepPoint:
    return SweepPoint(p, policy, channel, dst_channel, op, KIND_THROUGHPUT)


def _lat_point(p: RSTParams, channel=0, dst_channel=None,
               switch_enabled=None, op="read", num_engines=1,
               arbitration="round_robin", burst_beats=1) -> SweepPoint:
    return SweepPoint(p, None, channel, dst_channel, op, KIND_LATENCY,
                      switch_enabled, num_engines=num_engines,
                      arbitration=arbitration, burst_beats=burst_beats)


def _cont_point(p: RSTParams, num_engines, policy=None, channel=0,
                dst_channel=None, op="read", arbitration="round_robin",
                burst_beats=1, placement="same_channel",
                mix=None) -> SweepPoint:
    return SweepPoint(p, policy, channel, dst_channel, op, KIND_CONTENTION,
                      num_engines=num_engines, arbitration=arbitration,
                      burst_beats=burst_beats, placement=placement, mix=mix)


def _bursts(spec: MemorySpec, bursts) -> Tuple[int, ...]:
    return tuple(bursts) if bursts else (spec.min_burst, 2 * spec.min_burst)


def _categories(spec: MemorySpec, trace, extra_cycles: int = 0
                ) -> Dict[str, float]:
    module = LatencyModule()
    return module.category_latencies(module.capture(trace), spec,
                                     extra_cycles)


# ---------------------------------------------------------------------------
# Fig. 4 — refresh spikes
# ---------------------------------------------------------------------------


def _fig4_plan(spec, o):
    p = RSTParams(n=o["n"], b=spec.min_burst, s=64, w=0x1000000)
    return [(p, _lat_point(p))]


def _fig4_derive(spec, keyed, o):
    (p, trace), = keyed
    return {
        "latency_cycles": trace.cycles,
        "refresh_hits": trace.refresh_hits,
        "estimated_refresh_interval_ns":
            refresh_interval_estimate(trace, spec),
        "params": p,
    }


register_experiment(Experiment(
    name="fig4_refresh",
    artifact="Fig. 4",
    title="Serial-read latency timeline with periodic refresh spikes",
    plan=_fig4_plan,
    derive=_fig4_derive,
    defaults={"n": 1024},
    summarize=lambda spec, r:
        f"tREFI_est_ns={r['estimated_refresh_interval_ns']:.0f}",
    flatten=lambda spec, r: [
        ("tREFI_ns", f"{r['estimated_refresh_interval_ns']:.0f}"),
        ("spikes", str(int(r["refresh_hits"].sum()))),
    ],
))


# ---------------------------------------------------------------------------
# Fig. 5 / Table IV — idle page hit/closed/miss latency
# ---------------------------------------------------------------------------


def _table4_plan(spec, o):
    # The paper's two-stride probe: a small stride isolates hit+closed, a
    # page-crossing stride forces misses.  Switch disabled (footnote 6/9).
    small = RSTParams(n=o["n"], b=spec.min_burst, s=128, w=0x1000000)
    large = RSTParams(n=o["n"], b=spec.min_burst, s=128 * 1024, w=0x1000000)
    return [("small", _lat_point(small)), ("large", _lat_point(large))]


def _table4_derive(spec, keyed, o):
    traces = dict(keyed)
    cats_small = _categories(spec, traces["small"])
    cats_large = _categories(spec, traces["large"])
    return {
        name: {"cycles": cyc, "ns": cyc * spec.cycle_ns}
        for name, cyc in (("page_hit", cats_small["hit"]),
                          ("page_closed", cats_small["closed"]),
                          ("page_miss", cats_large["miss"]))
    }


register_experiment(Experiment(
    name="table4_idle_latency",
    artifact="Table IV / Fig. 5",
    title="Idle page hit/closed/miss latency",
    plan=_table4_plan,
    derive=_table4_derive,
    defaults={"n": 1024},
    summarize=lambda spec, r:
        ";".join(f"{k}={v['ns']:.1f}ns" for k, v in r.items()),
    flatten=lambda spec, r: [
        (k, f"{v['cycles']}cyc/{v['ns']:.1f}ns") for k, v in r.items()],
))


# ---------------------------------------------------------------------------
# Fig. 6 — address-mapping policy × stride × burst throughput
# ---------------------------------------------------------------------------


def _fig6_plan(spec, o):
    out = []
    for policy in policies_for(spec):
        for b in _bursts(spec, o["bursts"]):
            for s in o["strides"]:
                if s < b:
                    continue
                p = RSTParams(n=o["n"], b=b, s=s, w=o["w"])
                out.append(((policy, b, s), _tp_point(p, policy=policy)))
    return out


def _fig6_derive(spec, keyed, o):
    results = {policy: {b: {} for b in _bursts(spec, o["bursts"])}
               for policy in policies_for(spec)}
    for (policy, b, s), r in keyed:
        results[policy][b][s] = r.gbps
    return results


def _fig6_summarize(spec, r):
    per_s = r[DEFAULT_POLICY[spec.name]][spec.min_burst]
    best_seq = per_s[min(per_s)]
    return f"default_seq_gbps={best_seq:.2f};policies={len(r)}"


register_experiment(Experiment(
    name="fig6_address_mapping",
    artifact="Fig. 6",
    title="Throughput for every address-mapping policy x stride x burst",
    plan=_fig6_plan,
    derive=_fig6_derive,
    defaults={"strides": (64, 128, 256, 512, 1024, 2048, 4096, 8192,
                          16384, 32768),
              "bursts": None, "w": 0x10000000, "n": 4096},
    quick={"strides": (64, 1024, 8192), "n": 1024},
    summarize=_fig6_summarize,
    flatten=lambda spec, r: [
        (f"{pol}_B{b}_S{s}", f"{gbps:.2f}")
        for pol, per_b in r.items()
        for b, per_s in per_b.items()
        for s, gbps in per_s.items()],
))


# ---------------------------------------------------------------------------
# Fig. 7 — working-set locality (W=8K vs W=256M)
# ---------------------------------------------------------------------------

_FIG7_WINDOWS = (8 * 1024, 256 * MB)


def _fig7_plan(spec, o, op="read"):
    # Combinations with S < B or S > W violate the RST constraints
    # (Table I) and are omitted — consumers must guard lookups.
    out = []
    for w in _FIG7_WINDOWS:
        for b in _bursts(spec, o["bursts"]):
            for s in o["strides"]:
                if s < b or s > w:
                    continue
                p = RSTParams(n=o["n"], b=b, s=s, w=w)
                out.append(((w, b, s), _tp_point(p, op=op)))
    return out


def _fig7_derive(spec, keyed, o):
    results = {w: {b: {} for b in _bursts(spec, o["bursts"])}
               for w in _FIG7_WINDOWS}
    for (w, b, s), r in keyed:
        results[w][b][s] = r.gbps
    return results


def _fig7_summarize(spec, r):
    b, s = spec.min_burst, 4096
    try:
        local, base = r[8 * 1024][b][s], r[256 * MB][b][s]
    except KeyError as e:
        # The headline point must exist; a miss is a bug, not a skip.
        raise KeyError(
            f"locality result is missing burst={b} stride={s}: {e}; "
            f"available strides per window: "
            f"{ {w: sorted(per_b.get(b, {})) for w, per_b in r.items()} }"
        ) from e
    return f"w8k_s4k_gbps={local:.2f};w256m_s4k_gbps={base:.2f}"


register_experiment(Experiment(
    name="fig7_locality",
    artifact="Fig. 7",
    title="W=8K (locality) vs W=256M (baseline) throughput",
    plan=_fig7_plan,
    derive=_fig7_derive,
    defaults={"strides": (64, 256, 1024, 4096, 16384), "bursts": None,
              "n": 4096},
    quick={"n": 1024},
    summarize=_fig7_summarize,
    flatten=lambda spec, r: [
        (f"W{w}_B{b}_S{s}", f"{gbps:.2f}")
        for w, per_b in r.items()
        for b, per_s in per_b.items()
        for s, gbps in per_s.items()],
))


# ---------------------------------------------------------------------------
# Table V — aggregate throughput, all channels
# ---------------------------------------------------------------------------


def _table5_params(spec, o) -> RSTParams:
    return RSTParams(n=o["n"], b=spec.min_burst, s=spec.min_burst,
                     w=0x10000000)


def _table5_plan(spec, o, op="read"):
    # All M engines hit their local channels simultaneously; channels are
    # independent (footnote 11), so the sweep evaluates one and broadcasts.
    p = _table5_params(spec, o)
    return [(c, _tp_point(p, channel=c, op=op))
            for c in range(spec.num_channels)]


def _table5_derive(spec, keyed, o):
    per_channel = [r.gbps for _, r in keyed]
    return {
        "per_channel_gbps": float(np.mean(per_channel)),
        "num_channels": len(per_channel),
        "total_gbps": float(np.sum(per_channel)),
        "theoretical_gbps": spec.peak_total_gbps,
        # The grid's parameters, so register-faithful hosts (the
        # ShuhaiCampaign shim) can mirror them into their engines.
        "params": _table5_params(spec, o),
    }


register_experiment(Experiment(
    name="table5_total_throughput",
    artifact="Table V",
    title="Aggregate sequential-read throughput over all channels",
    plan=_table5_plan,
    derive=_table5_derive,
    defaults={"n": 8192},
    bench_label="table5_total",
    summarize=lambda spec, r: (f"total_gbps={r['total_gbps']:.1f};"
                               f"per_channel={r['per_channel_gbps']:.2f}"),
    flatten=lambda spec, r: [("total_gbps", f"{r['total_gbps']:.1f}")],
))


# ---------------------------------------------------------------------------
# Table VI — switch distance latency (switched specs only)
# ---------------------------------------------------------------------------


def _table6_plan(spec, o):
    small = RSTParams(n=o["n"], b=spec.min_burst, s=128, w=0x1000000)
    large = RSTParams(n=o["n"], b=spec.min_burst, s=128 * 1024, w=0x1000000)
    out = []
    for ch in range(spec.num_channels):
        for label, p in (("small", small), ("large", large)):
            out.append(((ch, label),
                        _lat_point(p, channel=ch,
                                   dst_channel=o["dst_channel"],
                                   switch_enabled=True)))
    return out


def _table6_derive(spec, keyed, o):
    sw = SwitchModel(topology_for(spec), enabled=True)
    traces = dict(keyed)
    out = {}
    for ch in range(spec.num_channels):
        extra = sw.distance_extra_cycles(ch, o["dst_channel"]) + \
            spec.switch_penalty
        cats = _categories(spec, traces[(ch, "small")], extra)
        cats_miss = _categories(spec, traces[(ch, "large")], extra)
        out[ch] = {"hit": cats["hit"], "closed": cats["closed"],
                   "miss": cats_miss["miss"]}
    return out


register_experiment(Experiment(
    name="table6_switch_latency",
    artifact="Table VI",
    title="Idle latency from every AXI channel to one channel, switch on",
    plan=_table6_plan,
    derive=_table6_derive,
    defaults={"dst_channel": 0, "n": 1024},
    requires_switch=True,
    summarize=lambda spec, r: (
        f"hit_ch0={r[0]['hit']}cyc;"
        f"hit_ch{max(r)}={r[max(r)]['hit']}cyc;"
        f"spread={r[max(r)]['hit'] - r[0]['hit']}cyc"),
    flatten=lambda spec, r: [
        (f"ch{ch}_hit", f"{r[ch]['hit']}cyc")
        for ch in range(0, spec.num_channels,
                        topology_for(spec).axi_per_switch)],
))


# ---------------------------------------------------------------------------
# Fig. 8 — switch throughput (switched specs only)
# ---------------------------------------------------------------------------


def _fig8_plan(spec, o):
    # One AXI channel per mini-switch; the non-blocking switch broadcasts.
    out = []
    step = topology_for(spec).axi_per_switch
    for sw in range(spec.num_channels // step):
        ch = sw * step
        for s in o["strides"]:
            p = RSTParams(n=o["n"], b=2 * spec.min_burst, s=s, w=0x1000000)
            out.append(((ch, s),
                        _tp_point(p, channel=ch,
                                  dst_channel=o["dst_channel"])))
    return out


def _fig8_derive(spec, keyed, o):
    out = {}
    for (ch, s), r in keyed:
        out.setdefault(ch, {})[s] = r.gbps
    return out


def _fig8_summarize(spec, r):
    s0 = min(next(iter(r.values())))
    vals = [r[ch][s0] for ch in r]
    return f"min_gbps={min(vals):.2f};max_gbps={max(vals):.2f}"


register_experiment(Experiment(
    name="fig8_switch_throughput",
    artifact="Fig. 8",
    title="Throughput from one AXI channel per mini-switch, switch on",
    plan=_fig8_plan,
    derive=_fig8_derive,
    defaults={"dst_channel": 0, "strides": (64, 256, 1024, 4096),
              "n": 200000},
    bench={"strides": (64, 1024)},
    requires_switch=True,
    summarize=_fig8_summarize,
    flatten=lambda spec, r: [
        (f"ch{ch}_S{s}", f"{per_s[s]:.2f}")
        for ch, per_s in r.items() for s in per_s],
))


# ---------------------------------------------------------------------------
# Write-path experiment family (paper Sec. IV; write-bandwidth results of
# Choi et al. 2020 and the duplex findings of Li et al. 2020).  These run
# on every registered memory system and are benchmarked on all four
# built-ins (bench_specs), not just the measured hbm/ddr4 pair.
# ---------------------------------------------------------------------------

_ALL_BUILTIN_SPECS = ("hbm", "ddr4", "hbm3", "ddr3")

# The write variants reuse the read experiments' plan/derive/summarize
# bodies with the traffic direction flipped — one grid definition per
# artifact, so a grid fix applies to both directions.
register_experiment(Experiment(
    name="table5_write_throughput",
    artifact="Table V (write)",
    title="Aggregate sequential-write throughput over all channels",
    plan=functools.partial(_table5_plan, op="write"),
    derive=_table5_derive,
    defaults={"n": 8192},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=lambda spec, r: (f"total_gbps={r['total_gbps']:.1f};"
                               f"per_channel={r['per_channel_gbps']:.2f}"),
    flatten=lambda spec, r: [("total_gbps", f"{r['total_gbps']:.1f}")],
))


register_experiment(Experiment(
    name="fig7_write_locality",
    artifact="Fig. 7 (write)",
    title="Write-path W=8K (locality) vs W=256M (baseline) throughput",
    plan=functools.partial(_fig7_plan, op="write"),
    derive=_fig7_derive,
    defaults={"strides": (64, 256, 1024, 4096, 16384), "bursts": None,
              "n": 4096},
    quick={"n": 1024},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=_fig7_summarize,
    flatten=lambda spec, r: [
        (f"W{w}_B{b}_S{s}", f"{gbps:.2f}")
        for w, per_b in r.items()
        for b, per_s in per_b.items()
        for s, gbps in per_s.items()],
))


_DUPLEX_OPS = ("read", "write", "duplex")


def _duplex_plan(spec, o):
    # Same RST tuple in all three directions so the derive can report the
    # duplex penalty as a ratio against pure reads at each stride.  The
    # true sequential point (S = min burst) is always present — it anchors
    # the summarize headline.
    strides = dict.fromkeys(
        (spec.min_burst,) + tuple(s for s in o["strides"]
                                  if s >= spec.min_burst))
    out = []
    for s in strides:
        p = RSTParams(n=o["n"], b=spec.min_burst, s=s, w=o["w"])
        for op in _DUPLEX_OPS:
            out.append(((op, s), _tp_point(p, op=op)))
    return out


def _duplex_derive(spec, keyed, o):
    results = {op: {} for op in _DUPLEX_OPS}
    for (op, s), r in keyed:
        results[op][s] = r.gbps
    return results


def _duplex_summarize(spec, r):
    s0 = spec.min_burst           # the sequential anchor the plan pins
    ratio = r["duplex"][s0] / r["read"][s0] if r["read"][s0] else 0.0
    return (f"seq_read_gbps={r['read'][s0]:.2f};"
            f"seq_write_gbps={r['write'][s0]:.2f};"
            f"seq_duplex_gbps={r['duplex'][s0]:.2f};"
            f"duplex_ratio={ratio:.2f}")


register_experiment(Experiment(
    name="duplex_rw_sweep",
    artifact="Sec. IV (duplex)",
    title="Read vs write vs mixed read/write throughput across strides",
    plan=_duplex_plan,
    derive=_duplex_derive,
    defaults={"strides": (64, 256, 1024, 4096, 16384), "w": 0x10000000,
              "n": 4096},
    quick={"strides": (64, 1024, 4096), "n": 1024},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=_duplex_summarize,
    flatten=lambda spec, r: [
        (f"{op}_S{s}", f"{gbps:.2f}")
        for op, per_s in r.items() for s, gbps in per_s.items()],
))


# ---------------------------------------------------------------------------
# Per-transaction instrumentation + multi-engine contention family
# (DESIGN.md §8; the serial write-latency classes the op-aware latency
# module captures, and the shared-port contention scenarios of Choi et
# al. 2020 / Zohouri & Matsuoka 2019).  All three run on every registered
# memory system and are benchmarked on all four built-ins.
# ---------------------------------------------------------------------------


def _table4w_plan(spec, o):
    # The Table-IV two-stride probe, driven through the *write* module: a
    # small stride isolates hit+closed (no precharge, read anchors), a
    # page-crossing stride forces tWR-bearing misses.
    small = RSTParams(n=o["n"], b=spec.min_burst, s=128, w=0x1000000)
    large = RSTParams(n=o["n"], b=spec.min_burst, s=128 * 1024, w=0x1000000)
    return [("small", _lat_point(small, op="write")),
            ("large", _lat_point(large, op="write"))]


def _table4w_derive(spec, keyed, o):
    traces = dict(keyed)
    module = LatencyModule(op="write", counter_bits=o["counter_bits"])
    cats_small = module.category_latencies(module.capture(traces["small"]),
                                           spec)
    cats_large = module.category_latencies(module.capture(traces["large"]),
                                           spec)
    out = {
        name: {"cycles": cyc, "ns": cyc * spec.cycle_ns}
        for name, cyc in (("page_hit", cats_small["hit"]),
                          ("page_closed", cats_small["closed"]),
                          ("page_miss", cats_large["miss"]))
    }
    # The write-direction delta the capture path used to silently drop:
    # miss latency above the read anchor = the write-recovery segment.
    out["write_recovery"] = {
        "cycles": out["page_miss"]["cycles"] - spec.lat_page_miss,
        "ns": (out["page_miss"]["cycles"] - spec.lat_page_miss)
              * spec.cycle_ns,
    }
    return out


register_experiment(Experiment(
    name="table4_write_latency_classes",
    artifact="Table IV (write)",
    title="Serial write latency classes (tWR-bearing page-miss path)",
    plan=_table4w_plan,
    derive=_table4w_derive,
    defaults={"n": 1024, "counter_bits": 8},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=lambda spec, r: (
        ";".join(f"{k}={v['ns']:.1f}ns" for k, v in r.items()
                 if k != "write_recovery")
        + f";tWR={r['write_recovery']['cycles']}cyc"),
    flatten=lambda spec, r: [
        (k, f"{v['cycles']}cyc/{v['ns']:.1f}ns") for k, v in r.items()],
))


def _fig9_plan(spec, o):
    # One sequential-stream engine ladder on one shared channel port —
    # the Fig. 9-style scaling curve of a multi-PE design (Choi et al.).
    # `arbitration`/`burst_beats` select the grant granularity (§9);
    # `benchmarks.run --arbitration POLICY --burst B` overrides them.
    p = RSTParams(n=o["n"], b=spec.min_burst, s=spec.min_burst, w=o["w"])
    return [(n_eng, _cont_point(p, n_eng, op=o["op"],
                                arbitration=o["arbitration"],
                                burst_beats=o["burst_beats"]))
            for n_eng in o["engines"]]


def _fig9_derive(spec, keyed, o):
    return {
        n_eng: {
            "aggregate_gbps": r.aggregate_gbps,
            "per_engine_gbps": r.per_engine_gbps,
            "queueing_delay_cycles": r.queueing_delay_cycles,
            "bound": r.bound,
        }
        for n_eng, r in keyed
    }


def _fig9_summarize(spec, r):
    n1, nmax = min(r), max(r)
    agg1, aggn = r[n1]["aggregate_gbps"], r[nmax]["aggregate_gbps"]
    scaling = aggn / (nmax / n1 * agg1) if agg1 else 0.0
    return (f"agg_x{n1}={agg1:.2f};agg_x{nmax}={aggn:.2f};"
            f"per_engine_x{nmax}={r[nmax]['per_engine_gbps']:.2f};"
            f"qdelay_x{nmax}={r[nmax]['queueing_delay_cycles']:.1f}cyc;"
            f"scaling={scaling:.2f}")


register_experiment(Experiment(
    name="fig9_channel_contention",
    artifact="Fig. 9 (contention)",
    title="N engines sharing one channel port: aggregate + per-engine",
    plan=_fig9_plan,
    derive=_fig9_derive,
    defaults={"engines": (1, 2, 4, 8), "n": 4096, "w": 0x1000000,
              "op": "read", "arbitration": "round_robin", "burst_beats": 1},
    quick={"engines": (1, 4), "n": 1024},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=_fig9_summarize,
    flatten=lambda spec, r: [
        (f"N{n_eng}_{key}", f"{val:.2f}" if isinstance(val, float) else val)
        for n_eng, per in r.items() for key, val in per.items()],
))


def _cont_sweep_plan(spec, o):
    out = []
    for n_eng in o["engines"]:
        for s in o["strides"]:
            if s < spec.min_burst:
                continue
            p = RSTParams(n=o["n"], b=spec.min_burst, s=s, w=o["w"])
            out.append(((n_eng, s),
                        _cont_point(p, n_eng, op=o["op"],
                                    arbitration=o["arbitration"],
                                    burst_beats=o["burst_beats"])))
    return out


def _cont_sweep_derive(spec, keyed, o):
    gbps: Dict[int, Dict[int, float]] = {}
    queueing: Dict[int, Dict[int, float]] = {}
    for (n_eng, s), r in keyed:
        gbps.setdefault(n_eng, {})[s] = r.aggregate_gbps
        queueing.setdefault(n_eng, {})[s] = r.queueing_delay_cycles
    base = gbps[min(gbps)]
    n1 = min(gbps)
    efficiency = {
        n_eng: {s: (per_s[s] / ((n_eng / n1) * base[s]) if base[s] else 0.0)
                for s in per_s}
        for n_eng, per_s in gbps.items()
    }
    return {"gbps": gbps, "efficiency": efficiency, "queueing": queueing}


def _cont_sweep_summarize(spec, r):
    nmax = max(r["gbps"])
    s0 = min(r["gbps"][nmax])
    return (f"agg_x{nmax}_S{s0}={r['gbps'][nmax][s0]:.2f};"
            f"eff_x{nmax}_S{s0}={r['efficiency'][nmax][s0]:.2f};"
            f"qdelay_x{nmax}_S{s0}={r['queueing'][nmax][s0]:.1f}cyc")


register_experiment(Experiment(
    name="contention_scaling_sweep",
    artifact="contention (scaling)",
    title="Engine-count x stride contention grid with scaling efficiency",
    plan=_cont_sweep_plan,
    derive=_cont_sweep_derive,
    defaults={"engines": (1, 2, 4, 8), "strides": (64, 1024, 4096),
              "w": 0x1000000, "n": 4096, "op": "read",
              "arbitration": "round_robin", "burst_beats": 1},
    quick={"engines": (1, 4), "strides": (64, 1024), "n": 1024},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=_cont_sweep_summarize,
    flatten=lambda spec, r: [
        (f"N{n_eng}_S{s}", f"{gbps:.2f}")
        for n_eng, per_s in r["gbps"].items() for s, gbps in per_s.items()],
))


# ---------------------------------------------------------------------------
# Arbitration-aware contention family (DESIGN.md §9): grant-granularity
# ladders, the cross-channel placement split of Fig. 9, and the contended
# latency classes the doubled-anchor classifier separates.  All three run
# on every registered memory system and are benchmarked on all four
# built-ins.
# ---------------------------------------------------------------------------


def _arb_ladder(o) -> List[Tuple[str, int]]:
    """(policy, burst_beats) rungs: round robin, the burst ladder, and the
    exclusive serialized bound — ordered by grant size."""
    return ([("round_robin", 1)]
            + [("burst", bb) for bb in o["burst_ladder"]]
            + [("exclusive", 1)])


def _arb_sweep_plan(spec, o):
    p = RSTParams(n=o["n"], b=spec.min_burst, s=spec.min_burst, w=o["w"])
    out = []
    for n_eng in o["engines"]:
        for policy, bb in _arb_ladder(o):
            out.append(((n_eng, policy, bb),
                        _cont_point(p, n_eng, op=o["op"], arbitration=policy,
                                    burst_beats=bb)))
    return out


def _arb_sweep_derive(spec, keyed, o):
    out: Dict[int, Dict] = {}
    for (n_eng, policy, bb), r in keyed:
        per = out.setdefault(n_eng, {"burst": {}})
        entry = {
            "aggregate_gbps": r.aggregate_gbps,
            "queueing_delay_cycles": r.queueing_delay_cycles,
            # Measuring backends put no such key in detail (the Backend
            # protocol doesn't require it); NaN marks "not modeled".
            "grant_head_wait_cycles":
                r.detail.get("grant_head_wait_cycles", float("nan")),
            "bound": r.bound,
        }
        if policy == "burst":
            per["burst"][bb] = entry
        else:
            per[policy] = entry
    return out


def _arb_sweep_summarize(spec, r):
    nmax = max(r)
    per = r[nmax]
    bb_max = max(per["burst"])
    rr, ex = per["round_robin"], per["exclusive"]
    burst = per["burst"][bb_max]
    # How much of the round-robin collapse does the largest burst grant
    # claw back, relative to the serialized (exclusive) bound?
    span = ex["aggregate_gbps"] - rr["aggregate_gbps"]
    recovered = ((burst["aggregate_gbps"] - rr["aggregate_gbps"]) / span
                 if span else 1.0)
    return (f"rr_x{nmax}={rr['aggregate_gbps']:.2f};"
            f"burst{bb_max}_x{nmax}={burst['aggregate_gbps']:.2f};"
            f"exclusive_x{nmax}={ex['aggregate_gbps']:.2f};"
            f"recovered={recovered:.2f}")


register_experiment(Experiment(
    name="arbitration_granularity_sweep",
    artifact="contention (arbitration)",
    title="Grant-granularity ladder: round robin -> burst grants -> exclusive",
    plan=_arb_sweep_plan,
    derive=_arb_sweep_derive,
    defaults={"engines": (2, 4), "burst_ladder": (4, 16, 64),
              "n": 4096, "w": 0x1000000, "op": "read"},
    quick={"engines": (4,), "burst_ladder": (16,), "n": 1024},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=_arb_sweep_summarize,
    flatten=lambda spec, r: [
        (f"N{n_eng}_{policy if policy != 'burst' else f'burst{bb}'}",
         f"{entry['aggregate_gbps']:.2f}")
        for n_eng, per in r.items()
        for policy, bb, entry in (
            [("round_robin", 1, per["round_robin"])]
            + [("burst", bb, e) for bb, e in per["burst"].items()]
            + [("exclusive", 1, per["exclusive"])])],
))


def _fig9x_plan(spec, o):
    # The Fig. 9 engine ladder split by fabric placement: one shared port
    # (the PR 4 worst case), different channels of one mini-switch (the
    # switch-aggregate term), and channels across the lateral bridge (the
    # cross-switch collapse).  Flat fabrics degrade cross_switch to
    # same_switch inside the engine (detail["placement_degraded"]).
    p = RSTParams(n=o["n"], b=spec.min_burst, s=spec.min_burst, w=o["w"])
    out = []
    for placement in o["placements"]:
        for n_eng in o["engines"]:
            out.append(((placement, n_eng),
                        _cont_point(p, n_eng, op=o["op"],
                                    arbitration=o["arbitration"],
                                    burst_beats=o["burst_beats"],
                                    placement=placement)))
    return out


def _fig9x_derive(spec, keyed, o):
    out: Dict[str, Dict[int, Dict]] = {}
    for (placement, n_eng), r in keyed:
        out.setdefault(placement, {})[n_eng] = {
            "aggregate_gbps": r.aggregate_gbps,
            "per_engine_gbps": r.per_engine_gbps,
            "bound": r.bound,
            "degraded": bool(r.detail.get("placement_degraded", 0.0)),
        }
    return out


def _fig9x_summarize(spec, r):
    nmax = max(next(iter(r.values())))
    parts = [f"{plc}_x{nmax}={per[nmax]['aggregate_gbps']:.2f}"
             for plc, per in r.items()]
    same = r.get("same_switch", {}).get(nmax)
    cross = r.get("cross_switch", {}).get(nmax)
    if same and cross and same["aggregate_gbps"]:
        parts.append(
            f"cross_ratio={cross['aggregate_gbps'] / same['aggregate_gbps']:.2f}")
    return ";".join(parts)


register_experiment(Experiment(
    name="fig9_cross_switch_contention",
    artifact="Fig. 9 (placement)",
    title="Engine ladder split by placement: same channel/switch/cross-switch",
    plan=_fig9x_plan,
    derive=_fig9x_derive,
    defaults={"engines": (1, 2, 4), "placements": PLACEMENTS,
              "n": 4096, "w": 0x1000000, "op": "read",
              "arbitration": "round_robin", "burst_beats": 1},
    quick={"engines": (1, 4), "n": 1024},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=_fig9x_summarize,
    flatten=lambda spec, r: [
        (f"{plc}_N{n_eng}", f"{per['aggregate_gbps']:.2f}")
        for plc, per_n in r.items() for n_eng, per in per_n.items()],
))


def _cont_lat_plan(spec, o):
    # A hit-regime stream captured under contention: grant heads carry the
    # arbitration rotation's wait, grant riders post at the uncontended
    # anchors — the bimodal distribution classify_contended separates.
    # N=1 is always planned: it is the baseline the queueing shift is
    # derived from (the shift the contended capture sees is (N-1)*B*mean
    # of the uncontended trace, DESIGN.md §9).
    p = RSTParams(n=o["n"], b=spec.min_burst, s=128, w=0x1000000)
    engines = dict.fromkeys((1,) + tuple(o["engines"]))
    return [(n_eng, _lat_point(p, op=o["op"], num_engines=n_eng,
                               arbitration=o["arbitration"],
                               burst_beats=o["burst_beats"]))
            for n_eng in engines]


def _cont_lat_derive(spec, keyed, o):
    traces = dict(keyed)
    base = traces[1]
    module = LatencyModule(op=o["op"], counter_bits=o["counter_bits"])
    out = {}
    for n_eng, trace in traces.items():
        # The shift the trace actually carries is the timing model's own
        # delay vector (grant heads pay the rotation; sample 0 is always
        # a head), so the classifier anchors can never drift from the
        # model's queueing formula.
        delay = _contended_latency_delay(base.cycles, n_eng,
                                         o["arbitration"], o["burst_beats"])
        head_wait = float(delay[0]) if len(delay) else 0.0
        counts = module.classify_contended(module.capture(trace), spec,
                                           head_wait)
        out[n_eng] = {"counts": counts,
                      "grant_head_wait_cycles": head_wait,
                      "mean_cycles": float(np.mean(trace.cycles))}
    return out


def _cont_lat_summarize(spec, r):
    nmax = max(r)
    c = r[nmax]["counts"]
    queued = sum(v for k, v in c.items() if k.endswith("_queued"))
    unqueued = sum(v for k, v in c.items()
                   if not k.endswith("_queued") and k != "refresh")
    return (f"x{nmax}_queued={queued};x{nmax}_unqueued={unqueued};"
            f"head_wait_x{nmax}={r[nmax]['grant_head_wait_cycles']:.1f}cyc;"
            f"mean_x{nmax}={r[nmax]['mean_cycles']:.1f}cyc")


register_experiment(Experiment(
    name="contended_latency_classes",
    artifact="Table IV (contended)",
    title="Contended serial-latency classes under burst-grant arbitration",
    plan=_cont_lat_plan,
    derive=_cont_lat_derive,
    defaults={"engines": (4,), "arbitration": "burst", "burst_beats": 8,
              "n": 1024, "op": "read", "counter_bits": 16},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=_cont_lat_summarize,
    flatten=lambda spec, r: [
        (f"N{n_eng}_{cls}", str(cnt))
        for n_eng, per in r.items() for cls, cnt in per["counts"].items()],
))


# ---------------------------------------------------------------------------
# Heterogeneous engine-mix family (DESIGN.md §13): named read/write/duplex
# blends of the Fig. 9 contention ladder — per-engine (params, op) tuples
# instead of N identical engines.  Runs on every registered memory system
# and is benchmarked on all four built-ins.
# ---------------------------------------------------------------------------

_MIX_PRESETS = (("read_heavy", "3r+1w"),
                ("write_heavy", "1r+3w"),
                ("balanced", "2r+2w"),
                ("duplex_spiked", "2r+1w+1d"))


def _mix_sweep_plan(spec, o):
    # Every engine in a named blend shares one RST tuple (sequential
    # stream, min burst) so the blends differ only in their traffic-
    # direction composition — the axis this family isolates.  The
    # arbitration rungs replay the §9 grant ladder under each blend.
    p = RSTParams(n=o["n"], b=spec.min_burst, s=spec.min_burst, w=o["w"])
    mixes = list(o["mixes"])
    if o["custom_mix"]:
        mixes.append(("custom", o["custom_mix"]))
    out = []
    for label, spec_str in mixes:
        mix = EngineMix.from_spec(spec_str, p)
        for policy, bb in o["arbitrations"]:
            out.append(((label, policy, bb),
                        _cont_point(p, len(mix), arbitration=policy,
                                    burst_beats=bb, mix=mix)))
    return out


def _mix_sweep_derive(spec, keyed, o):
    out: Dict[str, Dict] = {}
    for (label, policy, bb), r in keyed:
        out.setdefault(label, {})[(policy, bb)] = {
            "aggregate_gbps": r.aggregate_gbps,
            "per_engine_gbps": r.per_engine_gbps,
            "queueing_delay_cycles": r.queueing_delay_cycles,
            "op_switch_cycles": r.detail.get("op_switch_cycles",
                                             float("nan")),
            "bound": r.bound,
            "mix": r.mix.describe() if r.mix is not None else None,
        }
    return out


def _mix_sweep_summarize(spec, r):
    rung = next(iter(next(iter(r.values()))))   # first arbitration rung
    parts = [f"{label}={per[rung]['aggregate_gbps']:.2f}"
             for label, per in r.items()]
    opsw = max(per[rung]["op_switch_cycles"] for per in r.values())
    parts.append(f"max_opsw={opsw:.0f}cyc")
    return ";".join(parts)


register_experiment(Experiment(
    name="engine_mix_sweep",
    artifact="contention (mixes)",
    title="Heterogeneous engine blends: read/write/duplex mixes x grants",
    plan=_mix_sweep_plan,
    derive=_mix_sweep_derive,
    defaults={"mixes": _MIX_PRESETS, "custom_mix": None,
              "arbitrations": (("round_robin", 1), ("burst", 8),
                               ("exclusive", 1)),
              "n": 4096, "w": 0x1000000},
    quick={"mixes": _MIX_PRESETS[:2],
           "arbitrations": (("round_robin", 1),), "n": 1024},
    bench_specs=_ALL_BUILTIN_SPECS,
    summarize=_mix_sweep_summarize,
    flatten=lambda spec, r: [
        (f"{label}_{policy if policy != 'burst' else f'burst{bb}'}",
         f"{per[(policy, bb)]['aggregate_gbps']:.2f}")
        for label, per in r.items() for (policy, bb) in per],
))
