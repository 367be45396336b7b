"""Empirical (measured) machine roofline, ERT-style, on the sweep stack.

An analytic roofline divides nominal datasheet numbers; Shuhai's point
is that nominal numbers lie.  This module derives
the machine roofline the way the Empirical Roofline Toolkit does — by
*measuring*: a flop-intensity ladder is crossed with the RST sweep axes
(address policy x burst x stride x engine count x placement) and every
probe is a `SweepPoint` evaluated through a registered backend (sim /
cuda / torchgrid), so probes memoize, coalesce, and replay like any other
campaign point.  The reduction is a `RooflineEnvelope`:

- ``placement_gbps`` — best measured *per-engine* bandwidth per placement
  tier (same_channel / same_switch / cross_switch), the Choi et al.
  well-placed-vs-crossing split as numbers instead of folklore;
- ``policy_gbps`` — best aggregate bandwidth per address policy, i.e. a
  per-policy knee position;
- ``attainable(AI) = min(peak_flops, AI * bw)`` with the knee at
  ``peak_flops / bw`` — evaluated against the *measured* peak, not the
  wire rate.

The whole harness is itself the registered experiment family
``roofline_empirical`` (plan/derive, quick overlay, catalog row), and
`config_ceiling_gbps` exposes the fabric-side capacity bound that the
layout autotuner (`core/autotune.py`) uses to prune its search without
ever mispruning a possible winner.

On ``cuda`` every probe is a contention measurement on the card
(``rst_contend_read``), which runs at B = the kernel's tile: pass
``bursts=(tile,)`` with strides of whole tiles, and a window far larger
than the card's L2 for the numbers to be the memory's.  The card ignores
the address policy, so its per-policy entries repeat one mapping, and
the same_switch / cross_switch tiers are the card's per-port numbers
capped by the modeled U280 fabric, not card numbers.

Chip peaks (for the compute ceiling) resolve through the
`core/hwspec.py` chip registry (`chip_by_name`), not a hardcoded part.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.address_mapping import policies_for
from repro_torch.core.channels import topology_for
from repro_torch.core.engine import placement_port_counts
from repro_torch.core.experiments import (Experiment, PlannedPoint,
                                          _bursts, _cont_point,
                                          register_experiment,
                                          run_experiment)
from repro_torch.core.hwspec import HBM, ChipSpec, MemorySpec, chip_by_name
from repro_torch.core.params import RSTParams
from repro_torch.core.switch import PLACEMENTS, SwitchModel

MB = 1024 * 1024

# Arithmetic intensities (FLOP/byte) the envelope tabulates by default:
# 1/16 (stream-like) up to 1024 (compute-bound), the classic ERT ladder.
DEFAULT_AI_LADDER: Tuple[float, ...] = tuple(
    float(2 ** k) for k in range(-4, 11))


@dataclasses.dataclass(frozen=True)
class EnvelopePoint:
    """One measured probe that fed the envelope (aggregate GB/s)."""

    policy: str
    placement: str
    num_engines: int
    burst: int
    stride: int
    gbps: float


@dataclasses.dataclass(frozen=True)
class RooflineEnvelope:
    """A measured machine roofline: bandwidth tiers plus a compute peak.

    ``placement_gbps`` holds the best *per-engine* rate seen on each
    placement tier; ``placement_aggregate_gbps`` the best aggregate.
    ``peak_gbps`` is the best aggregate over all probes and anchors the
    default `attainable` / `knee_ai` roofline.
    """

    spec_name: str
    chip_name: str
    peak_flops: float                       # FLOP/s compute ceiling
    nominal_gbps: float                     # datasheet per-channel wire rate
    peak_gbps: float                        # best measured aggregate GB/s
    placement_gbps: Dict[str, float]        # tier -> per-engine peak GB/s
    placement_aggregate_gbps: Dict[str, float]
    policy_gbps: Dict[str, float]           # policy -> aggregate peak GB/s
    points: Tuple[EnvelopePoint, ...]
    ai_ladder: Tuple[float, ...]

    def attainable(self, ai: float, *, gbps: Optional[float] = None) -> float:
        """min(peak_flops, AI * bw) in FLOP/s; bw defaults to peak_gbps."""
        bw = (self.peak_gbps if gbps is None else gbps) * 1e9
        return min(self.peak_flops, ai * bw)

    def knee_ai(self, *, gbps: Optional[float] = None) -> float:
        """Arithmetic intensity where the roofline bends (FLOP/byte)."""
        bw = (self.peak_gbps if gbps is None else gbps) * 1e9
        return self.peak_flops / bw

    def ladder(self, *, gbps: Optional[float] = None
               ) -> Tuple[Tuple[float, float], ...]:
        """(AI, attainable FLOP/s) at each rung of the AI ladder."""
        return tuple((ai, self.attainable(ai, gbps=gbps))
                     for ai in self.ai_ladder)

    def fraction_of_nominal(self, gbps: float, *, ports: int = 1) -> float:
        """Choi-style %-of-nominal: measured rate over ports x wire rate."""
        return gbps / (ports * self.nominal_gbps)


def config_ceiling_gbps(spec: MemorySpec, placement: str,
                        num_engines: int) -> float:
    """Sound fabric-side upper bound on a config's aggregate GB/s.

    The bound multiplies the number of distinct AXI ports the placement
    gives `num_engines` engines by the per-channel wire rate, then clamps
    by the mini-switch / lateral-bridge capacity term for the *effective*
    placement (cross_switch degrades to same_switch on switchless
    fabrics).  No number of the models can exceed it — per-port
    throughput is wire-rate-limited and the switch caps are modeled as
    hard ceilings — which is what lets the autotuner prune on it without
    risking the exhaustive-grid argmax.  A probe measured on the card
    (`cuda`) is not wire-rate-limited and can exceed it: the bound is the
    modeled fabric's, not the card's.
    """
    switch = SwitchModel(topology_for(spec))
    effective, counts = placement_port_counts(switch, placement, num_engines)
    bound = len(counts) * spec.peak_channel_gbps
    cap = switch.capacity_cap_gbps(effective)
    if cap is not None:
        bound = min(bound, cap)
    return bound


def build_envelope(spec: MemorySpec, chip: ChipSpec,
                   points: Tuple[EnvelopePoint, ...], *,
                   ai_ladder: Tuple[float, ...] = DEFAULT_AI_LADDER
                   ) -> RooflineEnvelope:
    """Reduce measured probes to a `RooflineEnvelope` (pure; no backend)."""
    if not points:
        raise ValueError("cannot build a roofline envelope from zero points")
    placement_eng: Dict[str, float] = {}
    placement_agg: Dict[str, float] = {}
    policy_gbps: Dict[str, float] = {}
    for pt in points:
        per_engine = pt.gbps / pt.num_engines
        placement_eng[pt.placement] = max(
            placement_eng.get(pt.placement, 0.0), per_engine)
        placement_agg[pt.placement] = max(
            placement_agg.get(pt.placement, 0.0), pt.gbps)
        policy_gbps[pt.policy] = max(policy_gbps.get(pt.policy, 0.0), pt.gbps)
    return RooflineEnvelope(
        spec_name=spec.name,
        chip_name=chip.name,
        peak_flops=float(chip.peak_bf16_flops),
        nominal_gbps=spec.peak_channel_gbps,
        peak_gbps=max(placement_agg.values()),
        placement_gbps=placement_eng,
        placement_aggregate_gbps=placement_agg,
        policy_gbps=policy_gbps,
        points=tuple(points),
        ai_ladder=tuple(ai_ladder))


def measure_envelope(spec: MemorySpec = HBM, backend: str = "sim", *,
                     quick: bool = False, **options: Any) -> RooflineEnvelope:
    """Measure the machine roofline through a registered backend.

    Thin wrapper over ``run_experiment("roofline_empirical", ...)`` so
    callers that don't care about the registry get one obvious entry
    point; options are the experiment's (strides/bursts/engines/n/w/
    chip/ai_ladder).
    """
    return run_experiment("roofline_empirical", spec, backend,
                          quick=quick, **options)


# ---------------------------------------------------------------------------
# Experiment registration


def _roofline_plan(spec: MemorySpec,
                   o: Mapping[str, Any]) -> List[PlannedPoint]:
    out: List[PlannedPoint] = []
    for pol in policies_for(spec):
        for b in _bursts(spec, o["bursts"]):
            for s in o["strides"]:
                if s < b:
                    continue
                p = RSTParams(n=o["n"], b=b, s=s, w=o["w"])
                for n_eng in o["engines"]:
                    for plc in PLACEMENTS:
                        out.append(((pol, b, s, n_eng, plc),
                                    _cont_point(p, n_eng, policy=pol,
                                                placement=plc)))
    return out


def _roofline_derive(spec: MemorySpec, keyed: List[Tuple[Any, Any]],
                     o: Mapping[str, Any]) -> RooflineEnvelope:
    chip = chip_by_name(o["chip"])
    points = tuple(
        EnvelopePoint(policy=pol, placement=plc, num_engines=n_eng,
                      burst=b, stride=s, gbps=float(res.aggregate_gbps))
        for (pol, b, s, n_eng, plc), res in keyed)
    return build_envelope(spec, chip, points,
                          ai_ladder=tuple(o["ai_ladder"]))


def _roofline_summary(spec: MemorySpec, env: RooflineEnvelope) -> str:
    tiers = " ".join(
        f"{plc}={env.placement_gbps[plc]:.2f}"
        for plc in PLACEMENTS if plc in env.placement_gbps)
    return (f"peak={env.peak_gbps:.2f}GB/s knee_ai={env.knee_ai():.0f} "
            f"per-engine[{tiers}]")


def _roofline_rows(spec: MemorySpec,
                   env: RooflineEnvelope) -> List[Tuple[str, str]]:
    rows: List[Tuple[str, str]] = [
        ("peak_gbps", f"{env.peak_gbps:.3f}"),
        ("knee_ai", f"{env.knee_ai():.3f}"),
    ]
    rows += [(f"per_engine_gbps[{plc}]", f"{env.placement_gbps[plc]:.3f}")
             for plc in PLACEMENTS if plc in env.placement_gbps]
    rows += [(f"policy_gbps[{pol}]", f"{gbps:.3f}")
             for pol, gbps in sorted(env.policy_gbps.items())]
    return rows


register_experiment(Experiment(
    name="roofline_empirical",
    artifact="roofline (ERT)",
    title="Measured roofline: policy x burst x stride x engines x placement",
    plan=_roofline_plan,
    derive=_roofline_derive,
    defaults={"strides": (64, 256, 1024, 8192), "bursts": None,
              "engines": (1, 4), "n": 2048, "w": 16 * MB,
              "chip": "tpu_v5e", "ai_ladder": DEFAULT_AI_LADDER},
    quick={"strides": (64, 1024), "n": 1024},
    summarize=_roofline_summary,
    flatten=_roofline_rows,
))
