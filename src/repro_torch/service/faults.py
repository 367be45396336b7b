"""Fault injection: a Backend wrapper that breaks on schedule.

The campaign service's resilience layer (retry, circuit breakers,
degradation, validation — service/campaign.py) is only trustworthy if its
failure handling is *exercised*, deterministically, in tests and soak
runs.  :class:`FaultInjectingBackend` wraps any registered backend and
injects failures drawn from a :class:`FaultScript`:

* ``transient``   — raises :class:`TransientBackendError` (retryable);
* ``timeout``     — raises :class:`BackendTimeout` carrying simulated
                    elapsed seconds (retryable, charged against the
                    request's virtual-clock deadline);
* ``permanent``   — raises :class:`PermanentBackendError` (fail fast);
* ``unsupported`` — raises :class:`UnsupportedCapability` (degrade to a
                    capable backend);
* ``corrupt``     — returns the inner backend's result with the headline
                    quantity scaled by ``CORRUPT_SCALE`` — a silent wrong
                    answer only the service's oracle validation catches.

Faults come from three sources, checked in order: an explicit script (a
queue of :class:`Fault` entries, consumed one per backend call — exact
failure choreography for tests), a :class:`~repro_torch.runtime.fault_tolerance.
HealthSource` (the same failure vocabulary as ``FaultTolerantLoop``:
``SimulatedHealth.kill(node)`` is an outage — every call fails transient
until ``revive``; ``make_slow(node, f)`` past the timeout threshold
injects timeouts), and a seeded random rate (soak runs; no wall-clock or
global-RNG dependence anywhere).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import (Backend, BackendTimeout,
                               PermanentBackendError, TransientBackendError,
                               UnsupportedCapability, get_backend,
                               register_backend)
from repro_torch.runtime.fault_tolerance import HealthSource

FAULT_KINDS = ("transient", "timeout", "permanent", "unsupported", "corrupt")

# Corrupted results are scaled by this factor: far outside the oracle
# validation tolerance, so a sampled validation always catches it, but
# finite/positive so nothing downstream traps on inf/NaN first.
CORRUPT_SCALE = 2.5


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected failure; `seconds` is the simulated elapsed time a
    timeout burns (charged to the virtual clock, never slept)."""

    kind: str
    detail: str = ""
    seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid: {FAULT_KINDS}")


class FaultScript:
    """Deterministic fault source: scripted queue, health outages, rate.

    `draw()` is consulted once per backend call and returns the fault to
    inject (or None).  Sources in priority order:

    1. the scripted queue (`script(...)`) — entries are consumed FIFO,
       one per call; a literal ``None`` entry means "this call is clean"
       (spacing faults exactly);
    2. a `HealthSource` — while `node` is missing from ``alive_nodes()``
       the backend is down (transient outage); a reported step time above
       `slow_timeout_s` injects a timeout of that duration;
    3. a seeded random rate — each call faults with probability `rate`,
       drawing the kind from `kinds` (uniform unless `weights` given).
    """

    def __init__(self, rate: float = 0.0, seed: int = 0,
                 kinds: Sequence[str] = ("transient",),
                 weights: Optional[Sequence[float]] = None,
                 timeout_s: float = 1.0,
                 health: Optional[HealthSource] = None, node: int = 0,
                 slow_timeout_s: float = 2.0):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        unknown = set(kinds) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(
                f"unknown fault kind(s) {sorted(unknown)}; valid: "
                f"{FAULT_KINDS}")
        if weights is not None and len(weights) != len(kinds):
            raise ValueError(
                f"weights must match kinds ({len(kinds)}), got "
                f"{len(weights)}")
        self.rate = rate
        self.kinds = tuple(kinds)
        self.weights = (None if weights is None
                        else tuple(w / sum(weights) for w in weights))
        self.timeout_s = timeout_s
        self.health = health
        self.node = node
        self.slow_timeout_s = slow_timeout_s
        self._rng = np.random.default_rng(seed)
        self._queue: Deque[Optional[Fault]] = deque()

    def script(self, *faults: Optional[Fault]) -> "FaultScript":
        """Queue explicit faults (None = one clean call); returns self."""
        self._queue.extend(faults)
        return self

    def _rate_fault(self) -> Optional[Fault]:
        if not self.rate or float(self._rng.random()) >= self.rate:
            return None
        kind = self.kinds[int(self._rng.choice(len(self.kinds),
                                               p=self.weights))]
        return Fault(kind, detail=f"injected {kind} (rate={self.rate})",
                     seconds=self.timeout_s if kind == "timeout" else 0.0)

    def draw(self) -> Optional[Fault]:
        if self._queue:
            return self._queue.popleft()
        if self.health is not None:
            if self.node not in self.health.alive_nodes():
                return Fault("transient",
                             detail=f"backend node {self.node} down "
                                    f"(HealthSource outage)")
            t = self.health.step_times().get(self.node)
            if t is not None and t > self.slow_timeout_s:
                return Fault("timeout",
                             detail=f"backend node {self.node} slow: "
                                    f"{t:.1f}s > {self.slow_timeout_s:.1f}s",
                             seconds=float(t))
        return self._rate_fault()


class FaultInjectingBackend(Backend):
    """Wraps a registered backend, injecting scripted/random failures.

    Declared non-deterministic regardless of the inner backend: injected
    faults and corruption break the purity the sweep memoizer relies on
    (the service's in-flight coalescing is the dedup story instead).
    Capability flags mirror the inner backend.  `calls` counts every
    measurement call that reached this wrapper; `injected` counts the
    faults actually delivered, by kind.
    """

    deterministic = False
    injects_faults = True

    def __init__(self, inner, script: FaultScript,
                 name: Optional[str] = None):
        self.inner: Backend = (get_backend(inner) if isinstance(inner, str)
                               else inner)
        self.script = script
        self.name = name or f"{self.inner.name}+faults"
        self.supports_latency = self.inner.supports_latency
        self.supports_contention = self.inner.supports_contention
        self.calls = 0
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}

    def _maybe_fault(self, what: str) -> Optional[Fault]:
        """Raise the drawn fault, or return it if it corrupts the result."""
        self.calls += 1
        fault = self.script.draw()
        if fault is None:
            return None
        self.injected[fault.kind] += 1
        where = f"{self.name}.{what}"
        if fault.kind == "transient":
            raise TransientBackendError(
                f"{where}: {fault.detail or 'injected transient failure'}")
        if fault.kind == "timeout":
            raise BackendTimeout(
                f"{where}: {fault.detail or 'injected timeout'} "
                f"({fault.seconds:.1f}s elapsed)",
                seconds=fault.seconds or self.script.timeout_s)
        if fault.kind == "permanent":
            raise PermanentBackendError(
                f"{where}: {fault.detail or 'injected permanent failure'}")
        if fault.kind == "unsupported":
            raise UnsupportedCapability(
                f"backend {self.name!r}: "
                f"{fault.detail or f'injected capability loss for {what}'}")
        return fault                     # "corrupt": caller scales result

    def throughput(self, spec, p, mapping, *, op="read"):
        corrupt = self._maybe_fault(f"throughput[{op}]")
        res = self.inner.throughput(spec, p, mapping, op=op)
        if corrupt is not None:
            res = dataclasses.replace(res, gbps=res.gbps * CORRUPT_SCALE)
        return res

    def latency(self, spec, p, mapping, *, switch_enabled,
                switch_extra_cycles, op="read", num_engines=1,
                arbitration="round_robin", burst_beats=1, mix=None):
        corrupt = self._maybe_fault(f"latency[{op}]")
        res = self.inner.latency(
            spec, p, mapping, switch_enabled=switch_enabled,
            switch_extra_cycles=switch_extra_cycles, op=op,
            num_engines=num_engines, arbitration=arbitration,
            burst_beats=burst_beats, mix=mix)
        if corrupt is not None:
            res = dataclasses.replace(res,
                                      cycles=res.cycles * CORRUPT_SCALE)
        return res

    def contended_throughput(self, spec, p, mapping, *, num_engines,
                             op="read", arbitration="round_robin",
                             burst_beats=1, mix=None):
        corrupt = self._maybe_fault(f"contended_throughput[{op}]")
        res = self.inner.contended_throughput(
            spec, p, mapping, num_engines=num_engines, op=op,
            arbitration=arbitration, burst_beats=burst_beats, mix=mix)
        if corrupt is not None:
            res = dataclasses.replace(
                res, aggregate_gbps=res.aggregate_gbps * CORRUPT_SCALE)
        return res


def register_fault_injected(inner="sim", *, name: Optional[str] = None,
                            script: Optional[FaultScript] = None,
                            override: bool = False,
                            **script_kwargs) -> FaultInjectingBackend:
    """Build a FaultInjectingBackend and register it under `name`.

    Pass a prebuilt `script` for exact choreography, or `script_kwargs`
    (rate/seed/kinds/...) to build one.  The returned wrapper is resolvable
    through `get_backend(name)` like any backend, so Sweeps and the
    campaign service address it by name.
    """
    if script is not None and script_kwargs:
        raise ValueError("pass either script= or script kwargs, not both")
    backend = FaultInjectingBackend(
        inner, script or FaultScript(**script_kwargs), name=name)
    register_backend(backend, override=override)
    return backend
