"""Layout autotuning: oracle-level advice plus a registry-native tuner.

Two layers, one idea — exactly as an FPGA programmer reads Shuhai's
output to pick an address mapping policy, the framework maps candidate
layouts to access patterns and lets the calibrated model rank them.

The oracle layer (`LayoutCandidate` / `score_layouts` / `choose_layout`
and the `advise_*` helpers) ranks array dimension orders with the
closed-form `MemoryOracle`; the `oracle_autotune` rung of
``python -m repro_torch.bench`` drives it.

The registry layer is the measured counterpart: `tune_layout(workload,
spec, backend, budget)` searches (address policy x burst_beats x
arbitration x placement x EngineMix) with a seeded successive-halving
bracket whose every probe is a `SweepPoint` — probes memoize and
coalesce through the normal `Sweep` machinery (and, via the
`layout_autotune` experiment family this module registers, through the
`CampaignService` resilience layer).  Pruning uses the *sound* fabric
capacity bound `config_ceiling_gbps` from `core/roofline_empirical.py`,
so the returned winner always matches the exhaustive-grid argmax over
the same knob space (pinned by tests/test_torch_autotune.py against the
`torchgrid` grid).

The ceilings are the modeled fabric's (U280 wire rates and switch
capacities).  On the ``cuda`` backend every probe is a measurement on the
card, which can exceed its config's ceiling many times over; the
halving then prunes on a bound that does not hold there, and the
winner is the best of the configs it measured, not provably the
exhaustive argmax.  The JAX package behaves the same on ``pallas``.
`TuneReport.nominal_fraction` divides by the modeled wire rate of the
spec, not by any rate of the card.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.address_mapping import policies_for
from repro_torch.core.engine_mix import EngineMix, parse_mix_spec
from repro_torch.core.experiments import (Experiment, PlannedPoint, _cont_point,
                                    register_experiment)
from repro_torch.core.hwspec import HBM, MemorySpec
from repro_torch.core.oracle import AccessPattern, MemoryOracle
from repro_torch.core.params import RSTParams
from repro_torch.core.roofline_empirical import (MB, RooflineEnvelope,
                                           config_ceiling_gbps)
from repro_torch.core.sweep import KIND_CONTENTION, Sweep, SweepPoint
from repro_torch.core.switch import PLACEMENTS

DEFAULT_ARBITRATIONS: Tuple[str, ...] = ("round_robin", "burst", "exclusive")


# ---------------------------------------------------------------------------
# Oracle layer — closed-form layout advice


@dataclasses.dataclass(frozen=True)
class LayoutCandidate:
    """An array layout: named dims in storage order (major -> minor)."""

    dims: Tuple[str, ...]
    sizes: Dict[str, int]
    itemsize: int

    def stride_of(self, dim: str) -> int:
        """Bytes between consecutive indices of `dim`."""
        stride = self.itemsize
        for d in reversed(self.dims):
            if d == dim:
                return stride
            stride *= self.sizes[d]
        raise KeyError(dim)

    @property
    def total_bytes(self) -> int:
        n = self.itemsize
        for d in self.dims:
            n *= self.sizes[d]
        return n

    def access_pattern(self, iterate_dim: str,
                       fetch_dims: Sequence[str]) -> AccessPattern:
        """Pattern of sweeping `iterate_dim` while fetching `fetch_dims`
        at each step.

        The contiguous run (burst) is the product of trailing dims that are
        all fetched.  Fetched dims *outside* that run turn one logical fetch
        into a strided gather: the effective stride is the smallest stride
        among those dims (each burst jumps by it), which is what penalizes
        layouts that interleave a non-fetched dim (e.g. `seq`) between
        fetched ones — exactly a bad address-mapping policy in paper terms.
        """
        run = self.itemsize
        contig: List[str] = []
        for d in reversed(self.dims):
            if d in fetch_dims:
                run *= self.sizes[d]
                contig.append(d)
            else:
                break
        non_contig = [d for d in fetch_dims if d not in contig]
        if non_contig:
            stride = min(self.stride_of(d) for d in non_contig)
        else:
            stride = self.stride_of(iterate_dim)
        return AccessPattern(
            burst_bytes=run,
            stride_bytes=max(stride, run),
            working_set_bytes=self.total_bytes,
        )


def score_layouts(oracle: MemoryOracle, sizes: Dict[str, int], itemsize: int,
                  iterate_dim: str, fetch_dims: Sequence[str],
                  fixed_minor: Sequence[str] = ()
                  ) -> List[Tuple[float, LayoutCandidate]]:
    """Score every permutation of dims (minus `fixed_minor`, kept minormost)
    by modeled effective bandwidth for the given access."""
    free = [d for d in sizes if d not in fixed_minor]
    out = []
    for perm in itertools.permutations(free):
        cand = LayoutCandidate(dims=tuple(perm) + tuple(fixed_minor),
                               sizes=dict(sizes), itemsize=itemsize)
        bw = oracle.effective_bandwidth(
            cand.access_pattern(iterate_dim, fetch_dims))
        out.append((bw, cand))
    out.sort(key=lambda t: -t[0])
    return out


def choose_layout(oracle: MemoryOracle, sizes: Dict[str, int], itemsize: int,
                  iterate_dim: str, fetch_dims: Sequence[str],
                  fixed_minor: Sequence[str] = ()) -> LayoutCandidate:
    return score_layouts(oracle, sizes, itemsize, iterate_dim, fetch_dims,
                         fixed_minor)[0][1]


def advise_microbatch(
    oracle: MemoryOracle,
    *,
    param_bytes_per_device: float,
    opt_state_bytes_per_device: float,
    act_bytes_per_sample: float,
    max_microbatch: int,
    slack: float = 0.9,
) -> int:
    """Largest power-of-two microbatch (per device) whose live working set
    fits in HBM with `slack` headroom.  Returns at least 1."""
    budget = oracle.chip.hbm_bytes * slack
    fixed = param_bytes_per_device + opt_state_bytes_per_device
    mb = 1
    while (mb * 2 <= max_microbatch
           and fixed + act_bytes_per_sample * mb * 2 <= budget):
        mb *= 2
    return mb


def advise_remat(oracle: MemoryOracle, *, layer_act_bytes: float,
                 num_layers: int, budget_fraction: float = 0.35) -> str:
    """Pick an activation-checkpoint policy: 'none' | 'save_boundaries' |
    'full' based on whether saved activations fit the HBM budget share."""
    budget = oracle.chip.hbm_bytes * budget_fraction
    if layer_act_bytes * num_layers * 4 <= budget:   # keep everything (~4x)
        return "none"
    if layer_act_bytes * num_layers <= budget:       # boundaries only
        return "save_boundaries"
    return "full"


# ---------------------------------------------------------------------------
# Registry layer — measured knob search


@dataclasses.dataclass(frozen=True)
class LayoutConfig:
    """One point of the tuner's knob space.

    `engines` is either a homogeneous engine count or an `EngineMix`
    grammar string ("2r+1w"); together with the RST params it fixes the
    SweepPoint the config measures as.
    """

    policy: str
    arbitration: str
    burst_beats: int
    placement: str
    engines: "int | str"

    def describe(self) -> str:
        arb = (f"burst{self.burst_beats}" if self.arbitration == "burst"
               else self.arbitration)
        eng = (self.engines if isinstance(self.engines, str)
               else f"x{self.engines}")
        return f"{self.policy}/{arb}/{self.placement}/{eng}"


@dataclasses.dataclass(frozen=True)
class TuneRound:
    """One successive-halving rung: what was measured, what it pruned."""

    rung: int
    configs: Tuple[LayoutConfig, ...]
    gbps: Tuple[float, ...]
    best_gbps: float
    pruned: int


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """The tuner's answer: winner, search trajectory, and headroom."""

    spec_name: str
    params: RSTParams
    op: str
    winner: LayoutConfig
    winner_gbps: float
    candidates: int                  # canonical knob-space size
    evaluations: int                 # configs actually measured
    trajectory: Tuple[TuneRound, ...]
    nominal_fraction: float          # winner vs engines x wire rate (Choi)
    envelope_headroom: Optional[float] = None   # winner vs measured peak


def _mix_engines(engines: "int | str") -> int:
    return (len(parse_mix_spec(engines)) if isinstance(engines, str)
            else int(engines))


def _as_params(workload: "RSTParams | AccessPattern",
               spec: MemorySpec) -> RSTParams:
    if isinstance(workload, AccessPattern):
        return workload.to_rst(spec)
    return workload.validate(spec)


def _config_point(params: RSTParams, op: str, cfg: LayoutConfig
                  ) -> SweepPoint:
    mix = (EngineMix.from_spec(cfg.engines, params)
           if isinstance(cfg.engines, str) else None)
    return _cont_point(params, _mix_engines(cfg.engines), policy=cfg.policy,
                       op=op, arbitration=cfg.arbitration,
                       burst_beats=cfg.burst_beats, placement=cfg.placement,
                       mix=mix)


def _canonical_configs(spec: MemorySpec, *,
                       policies: Optional[Sequence[str]],
                       arbitrations: Sequence[str],
                       burst_beats: Sequence[int],
                       placements: Sequence[str],
                       mixes: Sequence["int | str"]) -> List[LayoutConfig]:
    """The knob cross-product with redundant spellings collapsed.

    Arbitration only exists between >= 2 engines: every single-engine
    candidate canonicalizes to ("round_robin", 1) — the timing model is
    bit-identical across grant policies at N=1 (pinned by the optimality
    tests) — which is where the tuner's structural savings over the
    exhaustive grid come from.
    """
    pols = tuple(policies) if policies else tuple(policies_for(spec))
    arb_pairs: List[Tuple[str, int]] = []
    for arb in arbitrations:
        for pair in ([("burst", int(bb)) for bb in burst_beats]
                     if arb == "burst" else [(arb, 1)]):
            if pair not in arb_pairs:
                arb_pairs.append(pair)
    configs: List[LayoutConfig] = []
    seen = set()
    for pol in pols:
        for engines in mixes:
            single = _mix_engines(engines) == 1
            for arb, bb in ([("round_robin", 1)] if single else arb_pairs):
                for plc in placements:
                    cfg = LayoutConfig(pol, arb, bb, plc, engines)
                    if cfg not in seen:
                        seen.add(cfg)
                        configs.append(cfg)
    return configs


def _ordered_bracket(spec: MemorySpec, configs: Sequence[LayoutConfig], *,
                     seed: int, budget: Optional[int]) -> List[LayoutConfig]:
    """Ceiling-descending measurement order with a seeded tie-break.

    Sorting by the sound capacity bound front-loads configs that *could*
    win; the seeded permutation breaks ties reproducibly so equal-bound
    flat fabrics still get a deterministic (but seed-dependent) order.
    `budget` truncates the bracket to at most that many measurements.
    """
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(len(configs))
    decorated = sorted(
        zip(configs, ranks),
        key=lambda t: (-config_ceiling_gbps(
            spec, t[0].placement, _mix_engines(t[0].engines)), int(t[1])))
    ordered = [cfg for cfg, _ in decorated]
    return ordered if budget is None else ordered[:int(budget)]


def _replay_search(ordered: Sequence[LayoutConfig],
                   ceilings: Mapping[LayoutConfig, float],
                   score_batch: Callable[[List[LayoutConfig]], List[float]],
                   *, eta: int) -> Tuple[Tuple[TuneRound, ...],
                                         Dict[LayoutConfig, float],
                                         LayoutConfig, float]:
    """Bound-guided successive halving over a pre-ordered bracket.

    Each rung measures the top 1/eta of the remaining bracket, then
    prunes every unmeasured config whose capacity ceiling cannot beat
    the incumbent.  Because the ceilings are sound upper bounds, pruning
    never discards a config that could strictly improve on the best
    measured score — the winner equals the argmax over the full bracket.
    The same function replays offline from recorded scores (experiment
    `derive`) or online against a backend (`tune_layout`): the
    trajectory is a pure function of (order, scores).
    """
    if not ordered:
        raise ValueError("empty tuning bracket: no candidate configs")
    remaining = list(ordered)
    measured: Dict[LayoutConfig, float] = {}
    rounds: List[TuneRound] = []
    best_cfg = remaining[0]
    best = float("-inf")
    rung = 0
    while remaining:
        k = max(1, -(-len(remaining) // eta))     # ceil-div
        batch = remaining[:k]
        gbps = [float(v) for v in score_batch(batch)]
        for cfg, val in zip(batch, gbps):
            measured[cfg] = val
            if val > best:
                best, best_cfg = val, cfg
        rest = remaining[k:]
        kept = [cfg for cfg in rest if ceilings[cfg] > best]
        rounds.append(TuneRound(rung=rung, configs=tuple(batch),
                                gbps=tuple(gbps), best_gbps=best,
                                pruned=len(rest) - len(kept)))
        remaining = kept
        rung += 1
    return tuple(rounds), measured, best_cfg, best


class LayoutTuner:
    """Measures `LayoutConfig` probes as SweepPoints through one Sweep.

    Scores are cached per probe identity — the full 8-field contention
    key, mirroring the Sweep memo — so re-scoring a config re-uses the
    prior measurement, and batched rungs flow through a single coalescing
    `Sweep.run()` call.
    """

    def __init__(self, spec: MemorySpec, backend: str = "sim", *,
                 sweep: Optional[Sweep] = None):
        self.spec = spec
        self.sweep = (sweep if sweep is not None
                      else Sweep(spec, backend, coalesce=True))
        self._score_cache: Dict[Tuple[Any, ...], float] = {}
        self._batch: Dict[Tuple[Any, ...], float] = {}

    @staticmethod
    def _probe_key(pt: SweepPoint) -> Tuple[Any, ...]:
        return (pt.params, pt.policy, pt.op, pt.num_engines, pt.arbitration,
                pt.burst_beats, pt.placement, pt.mix)

    def scores(self, points: Sequence[SweepPoint]) -> List[float]:
        """Aggregate GB/s per point; all cache misses share one run()."""
        missing = [pt for pt in points
                   if self._probe_key(pt) not in self._score_cache]
        if missing:
            before = len(self.sweep.points)
            for pt in missing:
                self.sweep.add_point(pt)
            for pt, res in zip(missing, self.sweep.run()[before:]):
                self._batch[self._probe_key(pt)] = float(
                    res.value.aggregate_gbps)
        return [self._score(pt) for pt in points]

    def _score(self, pt: SweepPoint) -> float:
        key = (pt.params, pt.policy, pt.op, pt.num_engines,
               pt.arbitration, pt.burst_beats, pt.placement, pt.mix)
        hit = self._score_cache.get(key)
        if hit is None:
            hit = self._measure(pt.params, pt.policy, pt.op, pt.num_engines,
                                pt.arbitration, pt.burst_beats, pt.placement,
                                pt.mix)
            self._score_cache[key] = hit
        return hit

    def _measure(self, params: RSTParams, policy: Optional[str], op: str,
                 num_engines: int, arbitration: str, burst_beats: int,
                 placement: str, mix: Optional[EngineMix]) -> float:
        key = (params, policy, op, num_engines, arbitration, burst_beats,
               placement, mix)
        hit = self._batch.pop(key, None)
        if hit is not None:
            return hit
        pt = SweepPoint(params, policy, op=op, kind=KIND_CONTENTION,
                        num_engines=num_engines, arbitration=arbitration,
                        burst_beats=burst_beats, placement=placement, mix=mix)
        before = len(self.sweep.points)
        self.sweep.add_point(pt)
        return float(self.sweep.run()[before:][0].value.aggregate_gbps)


def _mk_report(spec: MemorySpec, params: RSTParams, op: str,
               winner: LayoutConfig, best: float, candidates: int,
               evaluations: int, rounds: Tuple[TuneRound, ...],
               envelope: Optional[RooflineEnvelope]) -> TuneReport:
    nominal = _mix_engines(winner.engines) * spec.peak_channel_gbps
    return TuneReport(
        spec_name=spec.name, params=params, op=op, winner=winner,
        winner_gbps=best, candidates=candidates, evaluations=evaluations,
        trajectory=rounds, nominal_fraction=best / nominal,
        envelope_headroom=(None if envelope is None
                           else best / envelope.peak_gbps))


def tune_layout(workload: "RSTParams | AccessPattern",
                spec: MemorySpec = HBM, backend: str = "sim",
                budget: Optional[int] = None, *,
                op: str = "read", seed: int = 0, eta: int = 2,
                policies: Optional[Sequence[str]] = None,
                arbitrations: Sequence[str] = DEFAULT_ARBITRATIONS,
                burst_beats: Sequence[int] = (4, 8),
                placements: Sequence[str] = PLACEMENTS,
                mixes: Sequence["int | str"] = (1, 2, 4),
                sweep: Optional[Sweep] = None,
                envelope: Optional[RooflineEnvelope] = None) -> TuneReport:
    """Pick the best memory-layout knobs for a workload, by measuring.

    Searches (address policy x arbitration/burst x placement x engine
    mix) with a seeded bound-guided successive-halving bracket.  Every
    probe is a SweepPoint through `backend` (pass `sweep=` to share a
    warm memo across tunes); `budget` caps the number of distinct
    measurements.  With an unlimited budget the winner provably equals
    the exhaustive argmax over the same knob space.
    """
    params = _as_params(workload, spec)
    configs = _canonical_configs(
        spec, policies=policies, arbitrations=arbitrations,
        burst_beats=burst_beats, placements=placements, mixes=mixes)
    ordered = _ordered_bracket(spec, configs, seed=seed, budget=budget)
    ceilings = {cfg: config_ceiling_gbps(spec, cfg.placement,
                                         _mix_engines(cfg.engines))
                for cfg in configs}
    tuner = LayoutTuner(spec, backend, sweep=sweep)

    def score_batch(batch: List[LayoutConfig]) -> List[float]:
        return tuner.scores([_config_point(params, op, cfg) for cfg in batch])

    rounds, measured, winner, best = _replay_search(
        ordered, ceilings, score_batch, eta=eta)
    return _mk_report(spec, params, op, winner, best, len(configs),
                      len(measured), rounds, envelope)


# ---------------------------------------------------------------------------
# Experiment registration — the tuner as a reproducible campaign citizen


def _tune_params(spec: MemorySpec, o: Mapping[str, Any]) -> RSTParams:
    b = int(o["b"]) if o["b"] else spec.min_burst
    return RSTParams(n=o["n"], b=b, s=max(int(o["s"]), b),
                     w=o["w"]).validate(spec)


def _tune_plan(spec: MemorySpec, o: Mapping[str, Any]) -> List[PlannedPoint]:
    params = _tune_params(spec, o)
    configs = _canonical_configs(
        spec, policies=o["policies"], arbitrations=o["arbitrations"],
        burst_beats=o["burst_beats"], placements=o["placements"],
        mixes=o["mixes"])
    ordered = _ordered_bracket(spec, configs, seed=o["seed"],
                               budget=o["budget"])
    return [(cfg, _config_point(params, o["op"], cfg)) for cfg in ordered]


def _tune_derive(spec: MemorySpec, keyed: List[Tuple[Any, Any]],
                 o: Mapping[str, Any]) -> TuneReport:
    """Replay the halving schedule offline from recorded probe values.

    The plan emits the full bracket in measurement order; the replay
    consumes exactly the scores the online search would have requested,
    so the service path and `tune_layout` return identical reports.
    """
    params = _tune_params(spec, o)
    table = {cfg: float(res.aggregate_gbps) for cfg, res in keyed}
    ordered = [cfg for cfg, _ in keyed]
    ceilings = {cfg: config_ceiling_gbps(spec, cfg.placement,
                                         _mix_engines(cfg.engines))
                for cfg in ordered}
    rounds, measured, winner, best = _replay_search(
        ordered, ceilings, lambda batch: [table[cfg] for cfg in batch],
        eta=int(o["eta"]))
    candidates = len(_canonical_configs(
        spec, policies=o["policies"], arbitrations=o["arbitrations"],
        burst_beats=o["burst_beats"], placements=o["placements"],
        mixes=o["mixes"]))
    return _mk_report(spec, params, o["op"], winner, best, candidates,
                      len(measured), rounds, envelope=None)


def _tune_summary(spec: MemorySpec, rep: TuneReport) -> str:
    return (f"winner={rep.winner.describe()} {rep.winner_gbps:.2f}GB/s "
            f"evals={rep.evaluations}/{rep.candidates} "
            f"nominal={rep.nominal_fraction:.2f}")


def _tune_rows(spec: MemorySpec, rep: TuneReport) -> List[Tuple[str, str]]:
    rows = [("winner", rep.winner.describe()),
            ("winner_gbps", f"{rep.winner_gbps:.3f}"),
            ("evaluations", str(rep.evaluations)),
            ("candidates", str(rep.candidates)),
            ("nominal_fraction", f"{rep.nominal_fraction:.3f}")]
    rows += [(f"rung[{r.rung}]",
              f"measured={len(r.configs)} best={r.best_gbps:.3f} "
              f"pruned={r.pruned}") for r in rep.trajectory]
    return rows


register_experiment(Experiment(
    name="layout_autotune",
    artifact="autotuner",
    title="Layout autotune: policy x arbitration x placement x mix search",
    plan=_tune_plan,
    derive=_tune_derive,
    defaults={"b": None, "s": 64, "w": 16 * MB, "n": 2048, "op": "read",
              "policies": None, "arbitrations": DEFAULT_ARBITRATIONS,
              "burst_beats": (4, 8), "placements": PLACEMENTS,
              "mixes": (1, 2, 4), "budget": None, "seed": 0, "eta": 2},
    quick={"mixes": (1, 4), "burst_beats": (4,), "n": 1024},
    summarize=_tune_summary,
    flatten=_tune_rows,
))
