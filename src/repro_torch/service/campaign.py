"""Fault-tolerant campaign service: the experiment registry as a server.

`CampaignService` accepts :class:`ExperimentRequest`\\ s (spec ×
experiment × param overrides — "what bandwidth would I get for layout
X?"), deduplicates them against already-served responses, lowers each
distinct request through :func:`~repro_torch.core.experiments.plan_experiment`,
and executes the planned grid on a coalescing
:class:`~repro_torch.core.sweep.Sweep` behind a resilience layer (DESIGN.md
§10):

* **retry** — transient backend failures (the taxonomy of
  core/engine.py) retry with deterministic exponential backoff + jitter
  on a *virtual* clock: delays are charged, never slept, so tests and
  soak runs are exactly reproducible and sustained QPS is not an
  artifact of sleeping;
* **deadlines** — each request has a virtual-seconds budget; timeouts
  and backoffs consume it, and exhaustion degrades rather than hangs;
* **circuit breakers** — per-backend; consecutive failures open the
  circuit and requests route around the sick backend until a half-open
  probe recovers it;
* **graceful degradation** — when the primary backend's breaker is open,
  a capability is unsupported (cuda has no per-transaction timers), the
  retry budget or deadline is exhausted, requests transparently fall back
  to the `fallback` backend (sim) with ``degraded=True`` and the reason
  recorded — never silently dropped;
* **validation** — a sampled fraction of responses is re-checked against
  the `_timing_reference` loop oracle; a mismatch (e.g. an injected
  corruption) quarantines the producing backend — wrong answers are worse
  than no answers.

Every retried `Sweep.run()` resumes from the points already served (the
sweep's in-flight coalescing cache), so a transient at point 37 of 100
re-evaluates 63 points, not 100.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import _timing_reference as _reference
from repro_torch.core.address_mapping import get_mapping
from repro_torch.core.engine import (BackendTimeout, Engine,
                               PermanentBackendError, TransientBackendError,
                               UnsupportedCapability, classify_backend_error,
                               get_backend)
from repro_torch.core.experiments import (backend_capability_gap, get_experiment,
                                    plan_experiment)
from repro_torch.core.hwspec import spec_by_name
from repro_torch.core.sweep import (KIND_CONTENTION, KIND_LATENCY,
                              KIND_THROUGHPUT, Sweep)
from repro_torch.service.retry import CircuitBreaker, RetryPolicy


def _freeze(value: Any) -> Any:
    """Overrides must be hashable (the request IS its dedup key)."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    return value


@dataclasses.dataclass(frozen=True)
class ExperimentRequest:
    """One client request: spec × experiment × option overrides.

    Frozen and hashable — equal requests ARE duplicates, and the service
    serves them from one evaluation.  Build with :meth:`make`, which
    freezes override values.
    """

    experiment: str
    spec: str = "hbm"
    overrides: Tuple[Tuple[str, Any], ...] = ()
    quick: bool = False

    @classmethod
    def make(cls, experiment: str, spec: str = "hbm", *,
             quick: bool = False, **overrides) -> "ExperimentRequest":
        return cls(experiment, spec,
                   tuple(sorted((k, _freeze(v))
                                for k, v in overrides.items())), quick)


@dataclasses.dataclass
class ServiceResponse:
    """The service's answer to one request — never silently absent.

    `ok=False` responses carry `error`; degraded responses carry the
    backend actually used plus `degraded_reason`; `validated` is True
    (oracle check passed), False (mismatch — the producer was
    quarantined), or None (not sampled / not oracle-checkable).
    `coalesced` marks a response served from a previous identical
    request's evaluation.
    """

    request: ExperimentRequest
    ok: bool
    result: Any = None
    backend: str = ""
    attempts: int = 0
    retries: int = 0
    degraded: bool = False
    degraded_reason: Optional[str] = None
    validated: Optional[bool] = None
    coalesced: bool = False
    error: Optional[str] = None
    elapsed_s: float = 0.0              # virtual seconds


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0                   # submitted
    executed: int = 0                   # distinct evaluations (not deduped)
    completed: int = 0                  # ok responses served (incl. deduped)
    failed: int = 0                     # not-ok responses served
    deduped: int = 0                    # served from the response cache
    retries: int = 0
    breaker_opens: int = 0
    degraded: int = 0                   # distinct degraded executions
    quarantines: int = 0
    validated: int = 0                  # oracle checks run
    validation_mismatches: int = 0
    sustained_qps: float = 0.0          # responses / wall-second, submit_all

    @property
    def dropped(self) -> int:
        """Requests that never got a response — the invariant is 0."""
        return self.requests - self.completed - self.failed


@dataclasses.dataclass
class _Outcome:
    """One backend's verdict on one request (internal)."""

    ok: bool
    status: str = "ok"      # unsupported|transient_exhausted|deadline|
    reason: str = ""        # permanent|breaker
    values: Optional[List[Any]] = None
    attempts: int = 0
    retries: int = 0


class CampaignService:
    """Retrying, deduplicating, degrading front-end over the registry.

    `primary`/`fallback` are registered backend names; `fallback=None`
    disables degradation (capability gaps and exhausted budgets become
    `ok=False` responses instead).  All randomness (backoff jitter,
    validation sampling) comes from one seeded generator; all time is the
    virtual clock `now` — the service is wall-clock-free except for the
    `sustained_qps` statistic.
    """

    def __init__(self, primary: str = "sim",
                 fallback: Optional[str] = "sim", *,
                 retry: RetryPolicy = RetryPolicy(),
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 5.0,
                 deadline_s: float = 60.0,
                 validate_fraction: float = 0.25,
                 validate_rtol: float = 1e-6,
                 seed: int = 0):
        if not 0.0 <= validate_fraction <= 1.0:
            raise ValueError(
                f"validate_fraction must be in [0, 1], got "
                f"{validate_fraction}")
        self.primary = primary
        self.fallback = None if fallback == primary else fallback
        for name in (primary,) + ((self.fallback,) if self.fallback else ()):
            get_backend(name)            # unknown names fail at build time
        self.retry = retry
        self.deadline_s = deadline_s
        self.validate_fraction = validate_fraction
        self.validate_rtol = validate_rtol
        self.now = 0.0                   # virtual seconds
        self.stats = ServiceStats()
        self._rng = np.random.default_rng(seed)
        self._breakers: Dict[str, CircuitBreaker] = {
            name: CircuitBreaker(name=name,
                                 failure_threshold=breaker_threshold,
                                 reset_timeout_s=breaker_reset_s)
            for name in {primary, *((self.fallback,) if self.fallback
                                    else ())}}
        self._responses: Dict[ExperimentRequest, ServiceResponse] = {}
        self._oracle_cache: Dict[Tuple, Any] = {}
        self._engines: Dict[Tuple[str, int], Engine] = {}
        self._wall_s = 0.0

    def breaker(self, backend: str) -> CircuitBreaker:
        return self._breakers[backend]

    # ------------------------------------------------------------- intake
    def submit(self, request: ExperimentRequest) -> ServiceResponse:
        """Serve one request: from the dedup cache, or by executing it."""
        self.stats.requests += 1
        cached = self._responses.get(request)
        if cached is not None:
            self.stats.deduped += 1
            resp = dataclasses.replace(cached, request=request,
                                       coalesced=True)
        else:
            resp = self._execute(request)
            self._responses[request] = resp
        if resp.ok:
            self.stats.completed += 1
        else:
            self.stats.failed += 1
        return resp

    def submit_all(self, requests: Sequence[ExperimentRequest]
                   ) -> List[ServiceResponse]:
        """Serve a batch; updates `stats.sustained_qps` from wall time
        (the only wall-clock use in the service — reporting, not
        behavior)."""
        t0 = time.perf_counter()
        out = [self.submit(r) for r in requests]
        self._wall_s += time.perf_counter() - t0
        if self._wall_s > 0:
            self.stats.sustained_qps = (
                (self.stats.completed + self.stats.failed) / self._wall_s)
        return out

    # ---------------------------------------------------------- execution
    def _execute(self, req: ExperimentRequest) -> ServiceResponse:
        start = self.now
        self.stats.executed += 1
        try:
            exp = get_experiment(req.experiment)
            spec = spec_by_name(req.spec)
            planned, opts = plan_experiment(exp, spec, quick=req.quick,
                                            **dict(req.overrides))
        except (ValueError, TypeError) as e:
            return ServiceResponse(request=req, ok=False,
                                   error=f"bad request: {e}")

        order = [self.primary] + ([self.fallback] if self.fallback else [])
        degraded_reason: Optional[str] = None
        last_error: Optional[str] = None
        attempts = retries = 0
        for backend_name in order:
            is_primary = backend_name == self.primary
            breaker = self._breakers[backend_name]
            impl = get_backend(backend_name)

            gap = backend_capability_gap(impl, planned)
            if gap is not None:
                reason = f"experiment {exp.name!r} {gap}"
                if is_primary and self.fallback:
                    degraded_reason = degraded_reason or reason
                    continue
                last_error = reason
                break
            if not breaker.allow(self.now):
                reason = (f"circuit breaker for backend {backend_name!r} "
                          f"is {'quarantined' if breaker.quarantined else 'open'}")
                if is_primary and self.fallback:
                    degraded_reason = degraded_reason or reason
                    continue
                last_error = reason
                break

            outcome = self._attempt(spec, planned, backend_name, breaker,
                                    deadline=start + self.deadline_s)
            attempts += outcome.attempts
            retries += outcome.retries
            if outcome.ok:
                keyed = [(key, v) for (key, _), v in
                         zip(planned, outcome.values)]
                result = exp.derive(spec, keyed, opts)
                validated = None
                if float(self._rng.random()) < self.validate_fraction:
                    validated = self._validate(spec, planned,
                                               outcome.values, impl)
                    if validated is False:
                        self.stats.validation_mismatches += 1
                        self.stats.quarantines += 1
                        opens_before = breaker.opens
                        breaker.quarantine(self.now)
                        self.stats.breaker_opens += (breaker.opens
                                                     - opens_before)
                        if is_primary and self.fallback:
                            degraded_reason = (
                                f"validation mismatch against the timing "
                                f"oracle; backend {backend_name!r} "
                                f"quarantined")
                            continue
                        # No fallback left: serve it, flagged.
                degraded = backend_name != self.primary
                if degraded:
                    self.stats.degraded += 1
                return ServiceResponse(
                    request=req, ok=True, result=result,
                    backend=backend_name, attempts=attempts,
                    retries=retries, degraded=degraded,
                    degraded_reason=degraded_reason if degraded else None,
                    validated=validated, elapsed_s=self.now - start)

            if (outcome.status in ("unsupported", "transient_exhausted",
                                   "deadline", "breaker")
                    and is_primary and self.fallback):
                degraded_reason = degraded_reason or outcome.reason
                continue
            last_error = outcome.reason
            break

        return ServiceResponse(
            request=req, ok=False, error=last_error or degraded_reason,
            attempts=attempts, retries=retries,
            elapsed_s=self.now - start)

    def _attempt(self, spec, planned, backend_name: str,
                 breaker: CircuitBreaker, deadline: float) -> _Outcome:
        """Run one request's whole grid on one backend, with retry.

        The Sweep is built once with coalescing on, so each retry resumes
        from the points already evaluated instead of starting over."""
        sweep = Sweep(spec, backend_name, coalesce=True)
        for _, pt in planned:
            sweep.add_point(pt)
        attempts = retries = 0
        while True:
            if not breaker.allow(self.now):
                return _Outcome(
                    ok=False, status="breaker",
                    reason=f"circuit breaker for backend {backend_name!r} "
                           f"opened mid-request",
                    attempts=attempts, retries=retries)
            attempts += 1
            try:
                results = sweep.run()
            except Exception as exc:
                cls = classify_backend_error(exc)
                if isinstance(exc, BackendTimeout):
                    self.now += max(0.0, exc.seconds)
                if cls is UnsupportedCapability:
                    # A capability gap is a routing fact, not backend
                    # sickness — degrade without denting the breaker.
                    return _Outcome(ok=False, status="unsupported",
                                    reason=str(exc), attempts=attempts,
                                    retries=retries)
                opens_before = breaker.opens
                breaker.record_failure(self.now)
                self.stats.breaker_opens += breaker.opens - opens_before
                if cls is PermanentBackendError:
                    return _Outcome(
                        ok=False, status="permanent",
                        reason=f"{type(exc).__name__}: {exc}",
                        attempts=attempts, retries=retries)
                # Transient: back off (virtual), mind budget + deadline.
                if attempts >= self.retry.max_attempts:
                    return _Outcome(
                        ok=False, status="transient_exhausted",
                        reason=f"retry budget exhausted after {attempts} "
                               f"attempts on backend {backend_name!r}: "
                               f"{exc}",
                        attempts=attempts, retries=retries)
                retries += 1
                self.stats.retries += 1
                self.now += self.retry.backoff_s(retries, self._rng)
                if self.now > deadline:
                    return _Outcome(
                        ok=False, status="deadline",
                        reason=f"deadline ({self.deadline_s:.1f}s virtual) "
                               f"exceeded after {attempts} attempts on "
                               f"backend {backend_name!r}",
                        attempts=attempts, retries=retries)
                continue
            breaker.record_success()
            return _Outcome(ok=True, values=[r.value for r in results],
                            attempts=attempts, retries=retries)

    # --------------------------------------------------------- validation
    @staticmethod
    def _validatable(pt, value) -> bool:
        """Points the `_timing_reference` loop oracle can re-derive:
        model-backed results only (a real measurement has no oracle)."""
        if pt.kind == KIND_THROUGHPUT:
            return getattr(value, "bound", "measured") != "measured"
        if pt.kind == KIND_LATENCY:
            return pt.num_engines == 1
        if pt.kind == KIND_CONTENTION:
            return (getattr(value, "bound", "measured") != "measured"
                    and pt.placement == "same_channel")
        return False

    def _engine(self, spec, channel: int) -> Engine:
        key = (spec.name, channel)
        eng = self._engines.get(key)
        if eng is None:
            eng = Engine(channel=channel, spec=spec, backend="sim")
            self._engines[key] = eng
        return eng

    def _oracle_value(self, spec, pt, scaled: bool):
        """Reference-oracle expectation for one point, memoized — 1000
        duplicate soak requests cost a handful of loop-oracle runs."""
        key = (spec.name, pt, scaled)
        if key in self._oracle_cache:
            return self._oracle_cache[key]
        mapping = get_mapping(spec, pt.policy)
        p = pt.params.validate(spec)
        eng = self._engine(spec, pt.channel)
        scale = eng.throughput_scale(pt.dst_channel) if scaled else 1.0
        if pt.kind == KIND_THROUGHPUT:
            val = _reference.throughput(p, mapping, spec,
                                        op=pt.op).gbps * scale
        elif pt.kind == KIND_LATENCY:
            enabled, extra = eng.latency_config(pt.dst_channel,
                                                pt.switch_enabled)
            fn = (_reference.serial_read_latencies if pt.op == "read"
                  else _reference.serial_write_latencies)
            val = fn(p, mapping, spec, switch_enabled=enabled,
                     switch_extra_cycles=extra).cycles
        elif pt.mix is not None:
            val = _reference.contended_throughput_mix(
                pt.mix, mapping, spec, arbitration=pt.arbitration,
                burst_beats=pt.burst_beats).aggregate_gbps * scale
        else:
            val = _reference.contended_throughput(
                p, mapping, spec, num_engines=pt.num_engines, op=pt.op,
                arbitration=pt.arbitration,
                burst_beats=pt.burst_beats).aggregate_gbps * scale
        self._oracle_cache[key] = val
        return val

    def _validate(self, spec, planned, values, impl) -> Optional[bool]:
        """Re-check one sampled point of a response against the loop
        oracle; None when the plan has no oracle-checkable point."""
        candidates = [(pt, v) for (_, pt), v in zip(planned, values)
                      if self._validatable(pt, v)]
        if not candidates:
            return None
        pt, value = candidates[int(self._rng.integers(len(candidates)))]
        # Deterministic backends get the switch datapath scale from the
        # sweep layer; measuring/wrapped backends serve unscaled results.
        expected = self._oracle_value(spec, pt, scaled=impl.deterministic)
        self.stats.validated += 1
        if pt.kind == KIND_LATENCY:
            got = value.cycles
            return bool(len(got) == len(expected)
                        and np.allclose(got, expected,
                                        rtol=self.validate_rtol))
        got = (value.gbps if pt.kind == KIND_THROUGHPUT
               else value.aggregate_gbps)
        return bool(np.isclose(got, expected, rtol=self.validate_rtol))
