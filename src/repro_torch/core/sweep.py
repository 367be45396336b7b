"""Batch-first campaign sweeps over (RSTParams × policy × channel) grids.

The paper's value is exhaustive measurement: every point of Figs. 4–8 and
Tables IV–VI is one (policy, stride, burst, window, channel) evaluation.  A
:class:`Sweep` makes that the unit of work — the host plans a whole grid,
then one :meth:`Sweep.run` evaluates it batched:

* **Memoization** — on the ``sim`` backend the timing model is a pure
  function of (spec, mapping policy, params, op), so repeated grid points
  are evaluated once and served from cache afterwards.
* **Channel independence** — the paper's channels are independent
  (footnote 11) and the switch datapath is non-blocking (Fig. 8), so a
  throughput point is computed for one channel and *broadcast* to every
  channel that requests it; only the (currently neutral) switch scale is
  applied per channel.  Latency points fold 32 AXI channels down to the
  8 distinct switch distances (Table VI rows repeat within a mini-switch).

`ShuhaiCampaign` (core/bench_host.py) builds one Sweep per suite; see
DESIGN.md §4 for the architecture.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import timing_model
from repro_torch.core.engine import Engine, get_backend
from repro_torch.core.engine_mix import EngineMix, normalize_mix
from repro_torch.core.hwspec import HBM, MemorySpec
from repro_torch.core.params import RSTParams

KIND_THROUGHPUT = "throughput"
KIND_LATENCY = "latency"
KIND_CONTENTION = "contention"


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One campaign grid point (an engine configuration plus a trigger).

    The contention fields carry two spellings of the engine set: the
    homogeneous ``num_engines`` count and the heterogeneous ``mix`` of
    per-engine ``(params, op)`` entries (DESIGN.md §13).  Construction
    normalizes them onto one canonical form — a *uniform* mix folds back
    into ``(params, op, num_engines)`` with ``mix=None``, a genuinely
    mixed mix pins ``num_engines``/``params``/``op`` to its entry count
    and entry 0 — so the memo/flight keys built from these fields cannot
    fork on spelling (REPRO-C001 honesty).
    """

    params: RSTParams
    policy: Optional[str] = None
    channel: int = 0
    dst_channel: Optional[int] = None
    op: str = "read"
    kind: str = KIND_THROUGHPUT
    switch_enabled: Optional[bool] = None   # latency runs only
    num_engines: int = 1                    # contention + contended latency
    arbitration: str = "round_robin"        # shared-port grant policy (§9)
    burst_beats: int = 1                    # beats per grant ("burst" only)
    placement: str = "same_channel"         # contention runs only
    mix: Optional[EngineMix] = None         # heterogeneous engine set (§13)

    def __post_init__(self):
        if self.mix is None:
            return
        if self.kind == KIND_LATENCY:
            # Contended-latency points observe the engine named by
            # (params, op) — never rewrite it to the mix's entry 0.  Only
            # a uniform mix equal to the observed engine reduces to the
            # homogeneous spelling; a mismatched uniform mix is left for
            # serial_latencies' membership check to reject.
            n = len(self.mix)
            if self.mix.uniform_entry() == (self.params, self.op):
                object.__setattr__(self, "mix", None)
            object.__setattr__(self, "num_engines", n)
            return
        mix, p, op, n = normalize_mix(self.mix, self.params, self.op,
                                      self.num_engines)
        object.__setattr__(self, "mix", mix)
        object.__setattr__(self, "params", p)
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "num_engines", n)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """One evaluated point; `value` is a ThroughputResult or LatencyTrace."""

    point: SweepPoint
    value: object
    cached: bool


@dataclasses.dataclass
class SweepStats:
    points: int = 0
    evaluated: int = 0

    @property
    def cache_hits(self) -> int:
        return self.points - self.evaluated


class Sweep:
    """Planner + batched executor for a grid of campaign points."""

    def __init__(self, spec: MemorySpec = HBM, backend: str = "sim", *,
                 coalesce: bool = False):
        self.spec = spec
        self.backend = backend
        self.backend_impl = get_backend(backend)
        self.stats = SweepStats()
        self._points: List[SweepPoint] = []
        self._engines: Dict[int, Engine] = {}
        # Unscaled throughput results keyed by (params, policy, op); latency
        # traces keyed by (params, policy, enabled, extra_cycles, op, N,
        # arbitration, burst_beats, mix); contention results keyed by
        # (params, policy, op, N, arbitration, burst_beats, placement,
        # mix).  sim only.
        self._tp_cache: Dict[Tuple, timing_model.ThroughputResult] = {}
        self._lat_cache: Dict[Tuple, timing_model.LatencyTrace] = {}
        self._cont_cache: Dict[Tuple, timing_model.ContentionResult] = {}
        # In-flight coalescing (opt-in): duplicate points issue ONE
        # evaluation per Sweep lifetime even on NON-deterministic backends
        # — the campaign service's batching path (DESIGN.md §10), where a
        # fault-injected or measuring backend must not be re-hit for the
        # same point twice in one batch, and a retried `run()` resumes
        # from the points already served instead of re-evaluating them.
        # Distinct from the memo caches above, which only deterministic
        # backends get (their results are pure functions of the key).
        self.coalesce = coalesce
        self._flight: Dict[Tuple, object] = {}
        # Memo-cache keys filled by the grid prefill (batch-capable
        # deterministic backends) whose first per-point serve must still
        # report cached=False — prefilling is an execution strategy, not
        # a cache hit, so run() results stay identical to the per-point
        # path.
        self._fresh: set = set()

    # ------------------------------------------------------------- planning
    def add(self, params: RSTParams, *, policy: Optional[str] = None,
            channel: int = 0, dst_channel: Optional[int] = None,
            op: str = "read") -> "Sweep":
        """Queue one throughput point; returns self for chaining."""
        self._points.append(SweepPoint(params, policy, channel, dst_channel,
                                       op, KIND_THROUGHPUT))
        return self

    def add_latency(self, params: RSTParams, *, policy: Optional[str] = None,
                    channel: int = 0, dst_channel: Optional[int] = None,
                    switch_enabled: Optional[bool] = None,
                    op: str = "read", num_engines: int = 1,
                    arbitration: str = "round_robin",
                    burst_beats: int = 1,
                    mix: Optional[EngineMix] = None) -> "Sweep":
        """Queue one serial-latency point (op: "read" or "write").
        ``num_engines > 1`` makes it a *contended* trace at the given
        arbitration granularity (DESIGN.md §9); `mix` names the full
        heterogeneous engine set sharing the port while ``(params, op)``
        stays the observed engine (DESIGN.md §13).  Returns self for
        chaining."""
        self._points.append(SweepPoint(params, policy, channel, dst_channel,
                                       op, KIND_LATENCY, switch_enabled,
                                       num_engines=num_engines,
                                       arbitration=arbitration,
                                       burst_beats=burst_beats,
                                       mix=mix))
        return self

    def add_contention(self, params: RSTParams, *, num_engines: int = 1,
                       policy: Optional[str] = None, channel: int = 0,
                       dst_channel: Optional[int] = None,
                       op: str = "read", arbitration: str = "round_robin",
                       burst_beats: int = 1,
                       placement: str = "same_channel",
                       mix: Optional[EngineMix] = None) -> "Sweep":
        """Queue one multi-engine contention point (N engines sharing a
        channel port / mini-switch at the given arbitration granularity
        and placement, DESIGN.md §8/§9).  `mix` supersedes
        ``params``/``op``/``num_engines`` with a heterogeneous per-engine
        tuple (DESIGN.md §13); the point normalizes on construction, so a
        uniform mix is indistinguishable from the homogeneous spelling.
        Returns self for chaining."""
        self._points.append(SweepPoint(params, policy, channel, dst_channel,
                                       op, KIND_CONTENTION,
                                       num_engines=num_engines,
                                       arbitration=arbitration,
                                       burst_beats=burst_beats,
                                       placement=placement,
                                       mix=mix))
        return self

    def add_point(self, pt: SweepPoint) -> "Sweep":
        """Queue an already-built point (the experiment registry's path)."""
        self._points.append(pt)
        return self

    def add_grid(self, params: Iterable[RSTParams], *,
                 policies: Sequence[Optional[str]] = (None,),
                 channels: Sequence[int] = (0,),
                 dst_channel: Optional[int] = None,
                 op: str = "read") -> List[SweepPoint]:
        """Queue the full product policies × params × channels (policy-major
        order); returns the points queued, in order, so callers can key
        their result tables."""
        added = []
        for pol, p, ch in itertools.product(policies, params, channels):
            self.add(p, policy=pol, channel=ch, dst_channel=dst_channel, op=op)
            added.append(self._points[-1])
        return added

    @property
    def points(self) -> List[SweepPoint]:
        return list(self._points)

    # ------------------------------------------------------------ execution
    def _engine(self, channel: int) -> Engine:
        eng = self._engines.get(channel)
        if eng is None:
            eng = Engine(channel=channel, spec=self.spec, backend=self.backend)
            self._engines[channel] = eng
        return eng

    def _flight_lookup(self, key: Tuple) -> Tuple[object, bool]:
        """(cached value or None, hit) from the in-flight coalescing map."""
        if not self.coalesce:
            return None, False
        hit = key in self._flight
        return (self._flight[key] if hit else None), hit

    def _run_throughput(self, pt: SweepPoint) -> Tuple[object, bool]:
        eng = self._engine(pt.channel)
        if not self.backend_impl.deterministic:
            # Real measurements are per-point; no memoization — but with
            # coalescing on, duplicate points share one evaluation.
            key = ("tp", pt.params, pt.policy, pt.op, pt.channel,
                   pt.dst_channel)
            cached, hit = self._flight_lookup(key)
            if hit:
                return cached, True
            self.stats.evaluated += 1
            res = eng.evaluate_throughput(
                pt.params, policy=pt.policy, dst_channel=pt.dst_channel,
                op=pt.op)
            if self.coalesce:
                self._flight[key] = res
            return res, False
        key = (pt.params, pt.policy, pt.op)
        base = self._tp_cache.get(key)
        cached = base is not None and key not in self._fresh
        self._fresh.discard(key)
        if base is None:
            p = pt.params.validate(self.spec)
            base = self.backend_impl.throughput(
                self.spec, p, eng._mapping(pt.policy), op=pt.op)
            self._tp_cache[key] = base
            self.stats.evaluated += 1
        # Channel broadcast: location only enters through the switch scale
        # (the non-blocking datapath carries every traffic direction).
        scale = eng.throughput_scale(pt.dst_channel)
        if scale != 1.0:
            base = dataclasses.replace(base, gbps=base.gbps * scale)
        return base, cached

    def _run_contention(self, pt: SweepPoint) -> Tuple[object, bool]:
        eng = self._engine(pt.channel)
        if not self.backend_impl.deterministic:
            key = ("cont", pt.params, pt.policy, pt.op, pt.num_engines,
                   pt.arbitration, pt.burst_beats, pt.placement, pt.mix,
                   pt.channel, pt.dst_channel)
            cached, hit = self._flight_lookup(key)
            if hit:
                return cached, True
            self.stats.evaluated += 1
            res = eng.evaluate_contention(
                pt.params, num_engines=pt.num_engines, policy=pt.policy,
                dst_channel=pt.dst_channel, op=pt.op,
                arbitration=pt.arbitration, burst_beats=pt.burst_beats,
                placement=pt.placement, mix=pt.mix)
            if self.coalesce:
                self._flight[key] = res
            return res, False
        key = (pt.params, pt.policy, pt.op, pt.num_engines,
               pt.arbitration, pt.burst_beats, pt.placement, pt.mix)
        base = self._cont_cache.get(key)
        cached = base is not None and key not in self._fresh
        self._fresh.discard(key)
        if base is None:
            p = pt.params.validate(self.spec)
            base = eng._contention_unscaled(
                p, num_engines=pt.num_engines, policy=pt.policy, op=pt.op,
                arbitration=pt.arbitration, burst_beats=pt.burst_beats,
                placement=pt.placement, mix=pt.mix)
            self._cont_cache[key] = base
            self.stats.evaluated += 1
        # Channel broadcast, like throughput: location only enters through
        # the non-blocking switch datapath scale.
        scale = eng.throughput_scale(pt.dst_channel)
        if scale != 1.0:
            base = dataclasses.replace(
                base, aggregate_gbps=base.aggregate_gbps * scale)
        return base, cached

    def _run_latency(self, pt: SweepPoint) -> Tuple[object, bool]:
        eng = self._engine(pt.channel)
        if not self.backend_impl.deterministic:
            key = ("lat", pt.params, pt.policy, pt.switch_enabled, pt.op,
                   pt.num_engines, pt.arbitration, pt.burst_beats, pt.mix,
                   pt.channel, pt.dst_channel)
            cached, hit = self._flight_lookup(key)
            if hit:
                return cached, True
            self.stats.evaluated += 1
            res = eng.evaluate_latency(
                pt.params, policy=pt.policy, dst_channel=pt.dst_channel,
                switch_enabled=pt.switch_enabled, op=pt.op,
                num_engines=pt.num_engines, arbitration=pt.arbitration,
                burst_beats=pt.burst_beats, mix=pt.mix)
            if self.coalesce:
                self._flight[key] = res
            return res, False
        enabled, extra = eng.latency_config(pt.dst_channel, pt.switch_enabled)
        key = (pt.params, pt.policy, enabled, extra, pt.op,
               pt.num_engines, pt.arbitration, pt.burst_beats, pt.mix)
        trace = self._lat_cache.get(key)
        cached = trace is not None
        if trace is None:
            trace = eng.evaluate_latency(
                pt.params, policy=pt.policy, dst_channel=pt.dst_channel,
                switch_enabled=pt.switch_enabled, op=pt.op,
                num_engines=pt.num_engines, arbitration=pt.arbitration,
                burst_beats=pt.burst_beats, mix=pt.mix)
            self._lat_cache[key] = trace
            self.stats.evaluated += 1
        return trace, cached

    def _grid_prefill(self) -> None:
        """Batch-evaluate every uncached deterministic throughput and
        contention point through the backend's grid path — one batched
        call (``timing_torch.evaluate_points``) instead of one host
        dispatch per point — and fill the memo caches the per-point loop
        then serves from.  Keys are built from the same field tuples as
        `_run_throughput` / `_run_contention`; `_fresh` marks prefilled
        keys so their first serve still reports cached=False.  Latency
        points are left to the per-point path (no batched latency)."""
        reqs: List[Tuple] = []
        keys: List[Tuple[str, Tuple]] = []
        seen: set = set()
        for pt in self._points:
            if pt.kind == KIND_THROUGHPUT:
                kind = "tp"
                key: Tuple = (pt.params, pt.policy, pt.op)
                req: Tuple = ("tp", pt.params, pt.policy, pt.op)
                if key in self._tp_cache:
                    continue
            elif pt.kind == KIND_CONTENTION:
                kind = "cont"
                key = (pt.params, pt.policy, pt.op,
                       pt.num_engines, pt.arbitration,
                       pt.burst_beats, pt.placement, pt.mix)
                req = ("cont", pt.params, pt.policy, pt.op,
                       pt.num_engines, pt.arbitration,
                       pt.burst_beats, pt.placement, pt.mix)
                if key in self._cont_cache:
                    continue
            else:
                continue
            if (kind, key) in seen or key in self._fresh:
                continue
            seen.add((kind, key))
            reqs.append(req)
            keys.append((kind, key))
        if not reqs:
            return
        # De-duplicate before evaluating: `keys` holds distinct entries.
        results = self.backend_impl.evaluate_points(self.spec, reqs)
        for (kind, key), res in zip(keys, results):
            cache = self._tp_cache if kind == "tp" else self._cont_cache
            cache[key] = res
            self._fresh.add(key)
        self.stats.evaluated += len(reqs)

    def run(self) -> List[SweepResult]:
        """Evaluate every queued point; results align with `points` order."""
        if self.backend_impl.deterministic and getattr(
                self.backend_impl, "supports_grid", False):
            self._grid_prefill()
        out: List[SweepResult] = []
        for pt in self._points:
            self.stats.points += 1
            if pt.kind == KIND_THROUGHPUT:
                value, cached = self._run_throughput(pt)
            elif pt.kind == KIND_CONTENTION:
                value, cached = self._run_contention(pt)
            else:
                value, cached = self._run_latency(pt)
            out.append(SweepResult(point=pt, value=value, cached=cached))
        return out
