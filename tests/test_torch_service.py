"""The port's campaign service (`repro_torch.service`), its retry policy,
circuit breaker and fault injection, and the campaign surfaces of the
CLIs (the experiment catalog, `--service`/`--tune`/`--roofline`),
against the reference on the CPU.

The cases are those of tests/service/test_{campaign_service,faults,
retry}.py.  Where the reference puts `pallas` in the role of the device
backend, these put `cuda`, registered on its CPU path
(`CudaBackend(device="cpu")`).  With a `sim` primary and the same seeds
the port's service must answer exactly as the reference's does: every
`ServiceStats` field but the wall-clock `sustained_qps`, and every
response's backend, flags, retries, virtual time, error and result.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.service as ref_service
import repro_torch.core as port_core
from repro.core import engine as ref_engine_mod
from repro_torch import bench
from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import (BackendTimeout, CudaBackend,
                                     PermanentBackendError,
                                     TransientBackendError,
                                     UnsupportedCapability, get_backend)
from repro_torch.core.experiments import (CATALOG_BEGIN, CATALOG_END,
                                          catalog_markdown, catalog_rows)
from repro_torch.kernels.rst_contend import rst_contend_read
from repro_torch.runtime import SimulatedHealth
from repro_torch.service import (CORRUPT_SCALE, FAULT_KINDS,
                                 CampaignService, ExperimentRequest, Fault,
                                 FaultInjectingBackend, FaultScript,
                                 RetryPolicy, register_fault_injected)
from repro_torch.service.retry import (CLOSED, HALF_OPEN, OPEN,
                                       CircuitBreaker)
from test_torch_contend import as_port_text
from test_torch_core import assert_same

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
QUICK_TP = dict(experiment="fig6_address_mapping", quick=True)
TILE = 4096
P = port_core.RSTParams(n=256, b=64, s=1024, w=0x100000)
MAPPING = port_core.get_mapping(port_core.HBM)


@pytest.fixture
def registered():
    """Names registered through `reg` are removed from the port's
    registry afterwards (and from the reference's, for `ref=True`)."""
    names = []

    def reg(inner, name, *, ref=False, **kwargs):
        names.append((name, ref))
        fn = (ref_service.register_fault_injected if ref
              else register_fault_injected)
        return fn(inner, name=name, override=True, **kwargs)
    yield reg
    for name, ref in names:
        (ref_engine_mod if ref else engine_mod)._BACKEND_REGISTRY.pop(
            name, None)


@pytest.fixture
def cpu_cuda():
    """The registered `cuda` backend swapped for its CPU path (the
    kernels' plain versions), restored afterwards."""
    original = get_backend("cuda")
    port_core.register_backend(CudaBackend(device="cpu"), override=True)
    try:
        yield
    finally:
        port_core.register_backend(original, override=True)


def scripted(reg, *faults, inner="sim", name="sim+test"):
    return reg(inner, name, script=FaultScript().script(*faults))


# ------------------------------------------------------------------- retry


class TestRetryPolicy:
    def test_exponential_schedule_without_jitter(self):
        pol = RetryPolicy(base_delay_s=0.1, multiplier=2.0, max_delay_s=1.0,
                          jitter=0.0)
        rng = np.random.default_rng(0)
        delays = [pol.backoff_s(k, rng) for k in (1, 2, 3, 4, 5, 6)]
        assert delays == [0.1, 0.2, 0.4, 0.8, 1.0, 1.0]

    @pytest.mark.parametrize("jitter", [0.0, 0.5, 1.0])
    def test_schedule_equals_reference(self, jitter):
        kw = dict(base_delay_s=0.05, multiplier=2.0, max_delay_s=2.0,
                  jitter=jitter)
        got_rng, want_rng = (np.random.default_rng(7),
                             np.random.default_rng(7))
        got = [RetryPolicy(**kw).backoff_s(k, got_rng) for k in range(1, 9)]
        want = [ref_service.RetryPolicy(**kw).backoff_s(k, want_rng)
                for k in range(1, 9)]
        assert got == want
        for k, d in zip(range(1, 9), got):
            full = min(0.05 * 2.0 ** (k - 1), 2.0)
            assert full * (1 - jitter) <= d <= full

    @pytest.mark.parametrize("bad", [
        dict(max_attempts=0), dict(base_delay_s=-1.0),
        dict(multiplier=0.5), dict(jitter=1.5)])
    def test_rejects_bad_parameters(self, bad):
        with pytest.raises(ValueError) as got:
            RetryPolicy(**bad)
        with pytest.raises(ValueError) as want:
            ref_service.RetryPolicy(**bad)
        assert str(got.value) == str(want.value)

    def test_rejects_retry_zero(self):
        with pytest.raises(ValueError, match="retry"):
            RetryPolicy().backoff_s(0, np.random.default_rng(0))


class TestCircuitBreaker:
    def test_opens_after_consecutive_failures(self):
        br = CircuitBreaker(failure_threshold=3)
        for _ in range(2):
            br.record_failure(now=0.0)
        assert br.state == CLOSED and br.allow(0.0)
        br.record_failure(now=0.0)
        assert br.state == OPEN and not br.allow(0.0)
        assert br.opens == 1

    def test_success_resets_the_failure_count(self):
        br = CircuitBreaker(failure_threshold=3)
        br.record_failure(0.0)
        br.record_failure(0.0)
        br.record_success()
        br.record_failure(0.0)
        br.record_failure(0.0)
        assert br.state == CLOSED

    def test_half_open_probe_recloses_on_success(self):
        br = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0)
        br.record_failure(now=10.0)
        assert not br.allow(14.0)
        assert br.allow(15.0)
        assert br.state == HALF_OPEN
        br.record_success()
        assert br.state == CLOSED and br.allow(15.0)

    def test_half_open_probe_failure_reopens(self):
        br = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0)
        br.record_failure(now=0.0)
        assert br.allow(5.0)
        br.record_failure(now=5.0)
        assert br.state == OPEN and not br.allow(9.9)
        assert br.allow(10.0)
        assert br.opens == 2

    def test_quarantine_never_half_opens(self):
        br = CircuitBreaker(failure_threshold=5, reset_timeout_s=1.0)
        br.quarantine(now=0.0)
        assert br.quarantined and not br.allow(1e9)
        br.reset()
        assert br.state == CLOSED and not br.quarantined and br.allow(0.0)

    def test_rejects_bad_threshold(self):
        with pytest.raises(ValueError, match="failure_threshold"):
            CircuitBreaker(failure_threshold=0)

    def test_transitions_equal_reference(self):
        """One script of calls drives both breakers through the same
        states."""
        ops = [("f", 0.0), ("f", 0.5), ("a", 1.0), ("f", 1.0), ("a", 2.0),
               ("a", 6.5), ("s", 6.5), ("f", 7.0), ("f", 7.0), ("f", 7.0),
               ("a", 8.0), ("a", 12.1), ("f", 12.1), ("a", 16.0), ("q", 20),
               ("a", 1e6), ("r", 0), ("a", 0.0)]
        got, want = (CircuitBreaker(name="x", failure_threshold=3,
                                    reset_timeout_s=5.0),
                     ref_service.CircuitBreaker(name="x",
                                                failure_threshold=3,
                                                reset_timeout_s=5.0))
        for op, now in ops:
            outs = []
            for br in (got, want):
                out = {"f": lambda: br.record_failure(now),
                       "s": br.record_success,
                       "a": lambda: br.allow(now),
                       "q": lambda: br.quarantine(now),
                       "r": br.reset}[op]()
                outs.append((out, br.state, br.opens, br.quarantined))
            assert outs[0] == outs[1], (op, now)


# ------------------------------------------------------------------ faults


class TestFaultScript:
    def test_scripted_queue_is_fifo_with_clean_gaps(self):
        s = FaultScript().script(Fault("transient"), None, Fault("permanent"))
        assert s.draw().kind == "transient"
        assert s.draw() is None
        assert s.draw().kind == "permanent"
        assert s.draw() is None

    @pytest.mark.parametrize("rate,seed", [(0.3, 5), (0.1, 7), (1.0, 0)])
    def test_rate_draws_equal_reference(self, rate, seed):
        kinds = ("transient", "timeout", "corrupt", "unsupported")
        weights = (0.5, 0.2, 0.15, 0.15)
        got = FaultScript(rate=rate, seed=seed, kinds=kinds, weights=weights)
        want = ref_service.FaultScript(rate=rate, seed=seed, kinds=kinds,
                                       weights=weights)
        for _ in range(200):
            g, w = got.draw(), want.draw()
            assert (g is None) == (w is None)
            if g is not None:
                assert (g.kind, g.detail, g.seconds) == (w.kind, w.detail,
                                                         w.seconds)

    def test_health_outage_and_slowness(self):
        health = SimulatedHealth(num_nodes=2)
        s = FaultScript(health=health, node=1, slow_timeout_s=2.0)
        assert s.draw() is None
        health.kill(1)
        assert s.draw().kind == "transient"
        health.revive(1)
        assert s.draw() is None
        health.make_slow(1, 4.0)
        f = s.draw()
        assert f.kind == "timeout" and f.seconds == pytest.approx(4.0)

    def test_validates_inputs(self):
        with pytest.raises(ValueError, match="rate"):
            FaultScript(rate=1.5)
        with pytest.raises(ValueError, match="kind"):
            FaultScript(kinds=("transient", "flaky"))
        with pytest.raises(ValueError, match="weights"):
            FaultScript(kinds=("transient",), weights=(0.5, 0.5))
        with pytest.raises(ValueError, match="kind"):
            Fault("nope")
        assert FAULT_KINDS == ref_service.FAULT_KINDS
        assert CORRUPT_SCALE == ref_service.CORRUPT_SCALE


class TestFaultInjectingBackend:
    @pytest.mark.parametrize("kind,exc", [
        ("transient", TransientBackendError),
        ("timeout", BackendTimeout),
        ("permanent", PermanentBackendError),
        ("unsupported", UnsupportedCapability),
    ])
    def test_raising_kinds(self, kind, exc):
        be = FaultInjectingBackend("sim", FaultScript().script(
            Fault(kind, seconds=1.5)))
        with pytest.raises(exc) as got:
            be.throughput(port_core.HBM, P, MAPPING)
        want_be = ref_service.FaultInjectingBackend(
            "sim", ref_service.FaultScript().script(
                ref_service.Fault(kind, seconds=1.5)))
        with pytest.raises(Exception) as want:
            want_be.throughput(ref_core.HBM, ref_core.RSTParams(
                **dataclasses.asdict(P)), ref_core.get_mapping(ref_core.HBM))
        assert str(got.value) == str(want.value)
        assert be.injected[kind] == 1 and be.calls == 1

    def test_timeout_carries_virtual_seconds(self):
        be = FaultInjectingBackend("sim", FaultScript().script(
            Fault("timeout", seconds=2.5)))
        with pytest.raises(BackendTimeout) as ei:
            be.throughput(port_core.HBM, P, MAPPING)
        assert ei.value.seconds == pytest.approx(2.5)

    def test_corrupt_scales_every_result_kind(self):
        clean = get_backend("sim")
        be = FaultInjectingBackend("sim", FaultScript().script(
            Fault("corrupt"), Fault("corrupt"), Fault("corrupt")))
        tp = be.throughput(port_core.HBM, P, MAPPING)
        assert tp.gbps == pytest.approx(
            clean.throughput(port_core.HBM, P, MAPPING).gbps * CORRUPT_SCALE)
        lat = be.latency(port_core.HBM, P, MAPPING, switch_enabled=False,
                         switch_extra_cycles=0)
        ref = clean.latency(port_core.HBM, P, MAPPING, switch_enabled=False,
                            switch_extra_cycles=0)
        assert lat.cycles[0] == pytest.approx(ref.cycles[0] * CORRUPT_SCALE)
        cont = be.contended_throughput(port_core.HBM, P, MAPPING,
                                       num_engines=4)
        refc = clean.contended_throughput(port_core.HBM, P, MAPPING,
                                          num_engines=4)
        assert cont.aggregate_gbps == pytest.approx(
            refc.aggregate_gbps * CORRUPT_SCALE)
        assert be.injected["corrupt"] == 3

    def test_clean_calls_delegate_and_count(self):
        be = FaultInjectingBackend("sim", FaultScript())
        got = be.throughput(port_core.HBM, P, MAPPING)
        assert got.gbps == get_backend("sim").throughput(
            port_core.HBM, P, MAPPING).gbps
        assert be.calls == 1 and sum(be.injected.values()) == 0

    @pytest.mark.parametrize("inner", ["sim", "cuda", "torchgrid"])
    def test_mirrors_inner_capabilities_but_not_determinism(self, inner):
        be = FaultInjectingBackend(inner, FaultScript())
        impl = get_backend(inner)
        assert (be.supports_latency, be.supports_contention) == (
            impl.supports_latency, impl.supports_contention)
        assert not be.deterministic and be.injects_faults
        assert be.name == f"{inner}+faults"

    def test_register_fault_injected_roundtrip(self, registered):
        be = registered("sim", "sim+t", rate=0.0)
        assert get_backend("sim+t") is be
        with pytest.raises(ValueError, match="not both"):
            register_fault_injected("sim", name="sim+t2",
                                    script=FaultScript(), rate=0.5)
        assert "sim+t2" not in port_core.available_backends()

    def test_corrupt_over_cuda_scales_the_measurement(self, cpu_cuda):
        p = port_core.RSTParams(n=16, b=TILE, s=TILE, w=16 * TILE)
        be = FaultInjectingBackend("cuda", FaultScript().script(
            Fault("corrupt")))
        res = be.contended_throughput(port_core.HBM, p, MAPPING,
                                      num_engines=2)
        assert res.bound == "measured" and res.aggregate_gbps > 0
        assert be.injected["corrupt"] == 1


# --------------------------------------------------------------- service


class TestDedupAndCoalescing:
    def test_duplicate_requests_served_from_one_evaluation(self):
        svc = CampaignService("sim", "sim", validate_fraction=0.0)
        reqs = [ExperimentRequest.make(**QUICK_TP)] * 6 + [
            ExperimentRequest.make("table4_idle_latency", n=512)] * 4
        out = svc.submit_all(reqs)
        assert all(r.ok for r in out)
        assert svc.stats.requests == 10 and svc.stats.executed == 2
        assert svc.stats.deduped == 8 and svc.stats.dropped == 0
        assert sum(r.coalesced for r in out) == 8
        assert out[1].result == out[0].result

    def test_distinct_overrides_are_distinct_keys(self):
        svc = CampaignService("sim", "sim", validate_fraction=0.0)
        svc.submit(ExperimentRequest.make("table4_idle_latency", n=512))
        svc.submit(ExperimentRequest.make("table4_idle_latency", n=256))
        assert svc.stats.executed == 2 and svc.stats.deduped == 0

    def test_unhashable_override_values_are_frozen(self):
        r = ExperimentRequest.make("fig7_locality", strides=[64, 1024],
                                   quick=True)
        assert r.overrides == (("strides", (64, 1024)),)
        assert dataclasses.astuple(r) == dataclasses.astuple(
            ref_service.ExperimentRequest.make(
                "fig7_locality", strides=[64, 1024], quick=True))
        hash(r)


class TestRetry:
    def test_transient_failures_retry_to_success(self, registered):
        scripted(registered, Fault("transient"), Fault("timeout",
                                                       seconds=0.5))
        svc = CampaignService("sim+test", "sim", validate_fraction=0.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert r.ok and not r.degraded
        assert r.attempts == 3 and r.retries == 2
        assert svc.stats.retries == 2
        assert svc.now >= 0.5
        assert r.elapsed_s == pytest.approx(svc.now)

    def test_retries_resume_from_coalesced_points(self, registered):
        be = scripted(registered, None, Fault("transient"))
        svc = CampaignService("sim+test", "sim", validate_fraction=0.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert r.ok and r.retries == 1
        assert be.injected["transient"] == 1
        assert be.calls - 1 >= 2

    def test_permanent_failure_fails_fast_no_retry(self, registered):
        scripted(registered, Fault("permanent"))
        svc = CampaignService("sim+test", "sim", validate_fraction=0.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert not r.ok and r.retries == 0
        assert "PermanentBackendError" in r.error
        assert svc.stats.failed == 1 and svc.stats.dropped == 0

    def test_retry_exhaustion_degrades_to_fallback(self, registered):
        registered("sim", "sim+dead", rate=1.0, kinds=("transient",))
        svc = CampaignService("sim+dead", "sim",
                              retry=RetryPolicy(max_attempts=3),
                              validate_fraction=0.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert r.ok and r.degraded and r.backend == "sim"
        assert "retry budget exhausted" in r.degraded_reason
        assert svc.stats.degraded == 1 and svc.stats.dropped == 0

    def test_retry_exhaustion_without_fallback_fails(self, registered):
        registered("sim", "sim+dead", rate=1.0, kinds=("transient",))
        svc = CampaignService("sim+dead", fallback=None,
                              retry=RetryPolicy(max_attempts=2),
                              validate_fraction=0.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert not r.ok and "retry budget exhausted" in r.error

    def test_deadline_exceeded_degrades(self, registered):
        registered("sim", "sim+slow", rate=1.0, kinds=("timeout",),
                   timeout_s=10.0)
        svc = CampaignService("sim+slow", "sim", deadline_s=15.0,
                              retry=RetryPolicy(max_attempts=10),
                              validate_fraction=0.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert r.ok and r.degraded
        assert "deadline" in r.degraded_reason


class TestBreakerAndDegradation:
    def test_breaker_opens_and_routes_around_backend(self, registered):
        down = registered("sim", "sim+down", rate=1.0, kinds=("transient",))
        svc = CampaignService("sim+down", "sim",
                              retry=RetryPolicy(max_attempts=2),
                              breaker_threshold=2, breaker_reset_s=1e9,
                              validate_fraction=0.0)
        r1 = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert r1.ok and r1.degraded
        assert svc.breaker("sim+down").state == "open"
        assert svc.stats.breaker_opens == 1
        calls_before = down.calls
        r2 = svc.submit(ExperimentRequest.make("table4_idle_latency", n=512))
        assert r2.ok and r2.degraded
        assert "circuit breaker" in r2.degraded_reason
        assert down.calls == calls_before

    def test_half_open_probe_recovers_backend(self, registered):
        scripted(registered, Fault("transient"))
        svc = CampaignService("sim+test", "sim",
                              retry=RetryPolicy(max_attempts=1,
                                                base_delay_s=0.0),
                              breaker_threshold=1, breaker_reset_s=0.5,
                              validate_fraction=0.0)
        svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert svc.breaker("sim+test").state == "open"
        svc.now += 1.0
        r = svc.submit(ExperimentRequest.make("table4_idle_latency", n=512))
        assert r.ok and not r.degraded
        assert svc.breaker("sim+test").state == "closed"

    @pytest.mark.parametrize("request_kw", [
        dict(experiment="table4_idle_latency", n=512),
        dict(experiment="table4_idle_latency"),
        dict(experiment="contended_latency_classes", quick=True)])
    def test_capability_gap_degrades_cuda_to_sim(self, cpu_cuda,
                                                 request_kw):
        """cuda has no per-transaction timers: a latency experiment on a
        cuda-primary service degrades to sim, with the reason the
        reference gives for pallas."""
        svc = CampaignService("cuda", "sim", validate_fraction=0.0)
        r = svc.submit(ExperimentRequest.make(**request_kw))
        ref = ref_service.CampaignService("pallas", "sim",
                                          validate_fraction=0.0)
        want = ref.submit(ref_service.ExperimentRequest.make(**request_kw))
        assert r.ok and r.degraded and r.backend == "sim"
        assert "serial-latency" in r.degraded_reason
        assert r.degraded_reason == as_port_text(want.degraded_reason)
        assert_same(r.result, want.result)
        assert svc.stats.degraded == 1

    def test_unsupported_fault_degrades_without_breaker_damage(
            self, registered):
        scripted(registered, Fault("unsupported"))
        svc = CampaignService("sim+test", "sim", breaker_threshold=1,
                              validate_fraction=0.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert r.ok and r.degraded
        assert svc.breaker("sim+test").state == "closed"

    def test_bad_request_is_a_clean_failure(self):
        svc = CampaignService("sim", "sim")
        r = svc.submit(ExperimentRequest.make("no_such_experiment"))
        assert not r.ok and "unknown experiment" in r.error
        r2 = svc.submit(ExperimentRequest.make(**QUICK_TP, nope=3))
        assert not r2.ok and "bad request" in r2.error
        assert svc.stats.dropped == 0


class TestValidation:
    def test_clean_backend_validates_true(self):
        svc = CampaignService("sim", "sim", validate_fraction=1.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert r.ok and r.validated is True
        assert svc.stats.validated == 1
        assert svc.stats.validation_mismatches == 0

    def test_corrupt_backend_is_quarantined_and_degraded(self, registered):
        registered("sim", "sim+lying", rate=1.0, kinds=("corrupt",))
        svc = CampaignService("sim+lying", "sim", validate_fraction=1.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert r.ok and r.degraded and r.backend == "sim"
        assert "validation mismatch" in r.degraded_reason
        assert r.validated is True
        assert svc.stats.validation_mismatches == 1
        assert svc.stats.quarantines == 1
        br = svc.breaker("sim+lying")
        assert br.quarantined and not br.allow(1e12)

    def test_validate_fraction_zero_never_validates(self):
        svc = CampaignService("sim", "sim", validate_fraction=0.0)
        r = svc.submit(ExperimentRequest.make(**QUICK_TP))
        assert r.validated is None and svc.stats.validated == 0

    def test_rejects_bad_fraction(self):
        with pytest.raises(ValueError, match="validate_fraction"):
            CampaignService("sim", validate_fraction=1.5)

    def test_unknown_backend_fails_at_build_time(self):
        with pytest.raises(ValueError, match="unknown backend"):
            CampaignService("no_such_backend")


# ------------------------------------------------ equal to the reference


SOAK_MIX = [
    dict(experiment="fig6_address_mapping", quick=True),
    dict(experiment="table4_idle_latency", n=512),
    dict(experiment="fig4_refresh", quick=True),
    dict(experiment="fig7_locality", quick=True),
    dict(experiment="table5_total_throughput", n=2048),
    dict(experiment="fig6_address_mapping", spec="ddr4", quick=True),
    dict(experiment="table4_idle_latency", spec="ddr4", n=512),
    dict(experiment="duplex_rw_sweep", spec="ddr4", quick=True),
]


def _flags(resp):
    return (resp.ok, resp.backend, resp.attempts, resp.retries,
            resp.degraded, resp.degraded_reason, resp.validated,
            resp.coalesced, resp.error, resp.elapsed_s)


def _stats(svc):
    st = dataclasses.asdict(svc.stats)
    st.pop("sustained_qps")
    return st, svc.stats.dropped


def _serve_both(registered, rate, mix, n_requests, *, seed=11,
                kinds=("transient", "timeout", "corrupt", "unsupported"),
                weights=(0.5, 0.2, 0.15, 0.15), max_attempts=8):
    name = f"sim+soak@{rate:g}"
    kw = dict(rate=rate, seed=7, kinds=kinds, weights=weights,
              timeout_s=0.2)
    registered("sim", name, **kw)
    registered("sim", name, ref=True, **kw)
    svc = CampaignService(name, "sim",
                          retry=RetryPolicy(max_attempts=max_attempts),
                          validate_fraction=1.0, seed=seed)
    ref = ref_service.CampaignService(
        name, "sim", retry=ref_service.RetryPolicy(
            max_attempts=max_attempts), validate_fraction=1.0, seed=seed)
    reqs = [mix[i % len(mix)] for i in range(n_requests)]
    got = svc.submit_all([ExperimentRequest.make(**r) for r in reqs])
    want = ref.submit_all([ref_service.ExperimentRequest.make(**r)
                           for r in reqs])
    return svc, ref, got, want


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.3])
def test_service_answers_equal_reference(registered, rate):
    """A fault-injected sim primary, the same seeds: the same stats, the
    same per-response flags, the same results."""
    svc, ref, got, want = _serve_both(registered, rate, SOAK_MIX, 48)
    assert _stats(svc) == _stats(ref)
    assert [_flags(g) for g in got] == [_flags(w) for w in want]
    for g, w in zip(got[:len(SOAK_MIX)], want):
        assert_same(g.result, w.result, g.request.experiment)
    assert svc.now == ref.now


def test_1000_requests_at_10pct_fault_rate(registered):
    """The reference's soak: 1000 mixed requests, 10 % injected faults —
    zero dropped, every response validated or degraded with a reason,
    duplicates coalesced; and the reference's stats and flags."""
    svc, ref, out, want = _serve_both(registered, 0.1, SOAK_MIX, 1000)
    st = svc.stats
    assert len(out) == 1000 and st.dropped == 0
    assert all(r.ok for r in out)
    assert all(r.validated is True or (r.degraded and r.degraded_reason)
               for r in out)
    assert st.executed == len(SOAK_MIX) < st.requests
    assert st.deduped == 1000 - len(SOAK_MIX)
    assert st.sustained_qps > 0
    assert _stats(svc) == _stats(ref)
    assert [_flags(g) for g in out] == [_flags(w) for w in want]


# ------------------------------------------------------------- on `cuda`


def _tile_tune(**kw):
    return ExperimentRequest.make(
        "layout_autotune", b=TILE, s=TILE, w=64 * TILE, n=32,
        mixes=kw.pop("mixes", (1, 4)), burst_beats=(16,), **kw)


class TestCudaPrimary:
    """The service over `cuda` (its CPU path here), the path
    chip_smoke.py drives on the card."""

    def test_tile_requests_are_served_by_cuda(self, cpu_cuda):
        svc = CampaignService("cuda", "sim", validate_fraction=1.0, seed=0)
        reqs = [_tile_tune(), ExperimentRequest.make(
            "roofline_empirical", chip="h100_sxm", bursts=(TILE,),
            strides=(TILE, 4 * TILE), engines=(1, 4), n=32, w=64 * TILE)]
        out = svc.submit_all(reqs + reqs)
        for r in out:
            assert r.ok and r.backend == "cuda" and r.degraded is False
            # A measurement has no oracle: never validated.
            assert r.validated is None
        assert [r.coalesced for r in out] == [False, False, True, True]
        assert svc.stats.executed == 2 and svc.stats.dropped == 0
        rep = out[0].result
        assert rep.candidates == 60 and rep.evaluations <= 60

    def test_paper_bursts_fail_cleanly_without_fallback(self, cpu_cuda):
        """32-byte bursts match no kernel tile: a permanent error, served
        as ok=False by no backend, as the reference does on pallas."""
        svc = CampaignService("cuda", "sim", validate_fraction=1.0, seed=0)
        r = svc.submit(ExperimentRequest.make("fig6_address_mapping"))
        ref = ref_service.CampaignService("pallas", "sim",
                                          validate_fraction=1.0, seed=0)
        want = ref.submit(ref_service.ExperimentRequest.make(
            "fig6_address_mapping"))
        assert not r.ok and r.backend == "" and not r.degraded
        assert "burst B=32 does not match tile bytes 4096" in r.error
        assert r.error == as_port_text(want.error)
        assert (r.attempts, r.retries) == (want.attempts, want.retries)

    def test_mix_with_a_writer_is_refused(self, cpu_cuda):
        svc = CampaignService("cuda", "sim", validate_fraction=1.0, seed=0)
        r = svc.submit(_tile_tune(mixes=("2r+1w",)))
        assert not r.ok and not r.degraded and r.backend == ""
        assert "cuda kernel measures read traffic only" in r.error
        ref = ref_service.CampaignService("pallas", "sim",
                                          validate_fraction=1.0, seed=0)
        want = ref.submit(ref_service.ExperimentRequest.make(
            "layout_autotune", b=TILE, s=TILE, w=64 * TILE, n=32,
            mixes=("2r+1w",), burst_beats=(16,)))
        assert r.error == as_port_text(want.error)

    def test_transient_over_cuda_resumes(self, cpu_cuda, registered):
        be = registered("cuda", "cuda+faults", script=FaultScript().script(
            None, None, None, Fault("transient")))
        svc = CampaignService("cuda+faults", "sim", validate_fraction=1.0,
                              seed=0)
        r = svc.submit(_tile_tune())
        assert r.ok and r.backend == "cuda+faults" and not r.degraded
        assert r.retries == 1 and be.injected["transient"] == 1
        # 60 probes, one failed call: nothing measured twice.
        assert be.calls == 60 + 1

    def test_corrupt_over_cuda_is_served_unflagged(self, cpu_cuda,
                                                   registered):
        """A measured result has no oracle (`_validatable`), so a
        corruption injected over cuda is served as it is, as the
        reference serves one over pallas."""
        registered("cuda", "cuda+lying", rate=1.0, kinds=("corrupt",))
        svc = CampaignService("cuda+lying", "sim", validate_fraction=1.0,
                              seed=0)
        r = svc.submit(_tile_tune())
        assert r.ok and not r.degraded and r.validated is None
        assert svc.stats.validation_mismatches == 0
        assert svc.stats.quarantines == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_service_on_the_card(cuda_device):
    """The registered `cuda` backend on the card: a tile-shaped tune is
    measured there (rst_contend_read launched 51 times a probe), a latency
    request degrades to sim, paper bursts fail cleanly."""
    svc = CampaignService("cuda", "sim", validate_fraction=1.0, seed=0)
    before = rst_contend_read.launches
    tuned, dup, lat, paper = svc.submit_all([
        _tile_tune(), _tile_tune(),
        ExperimentRequest.make("table4_idle_latency"),
        ExperimentRequest.make("fig6_address_mapping")])
    torch.cuda.synchronize()
    assert tuned.ok and tuned.backend == "cuda" and not tuned.degraded
    assert dup.coalesced and dup.result == tuned.result
    assert rst_contend_read.launches - before == 60 * 51
    assert lat.ok and lat.backend == "sim" and lat.degraded
    assert not paper.ok and "does not match tile bytes" in paper.error
    assert svc.stats.executed == 3 and svc.stats.dropped == 0


# -------------------------------------------------------- campaign CLIs


def _drop_qps(rows):
    return [(n, ";".join(kv for kv in d.split(";")
                         if not kv.startswith("qps="))) for n, _, d in rows]


def test_bench_service_rows_equal_reference():
    from benchmarks import run as ref_bench
    got = bench.bench_service(quick=True, fault_rates=(0.0, 0.1))
    want = ref_bench.bench_service(quick=True, fault_rates=(0.0, 0.1))
    assert _drop_qps(got) == _drop_qps(want)
    assert "dropped=0" in got[-1][2] and "degraded=0" not in got[-1][2]
    assert "sim+faults@0.1" not in port_core.available_backends()


@pytest.mark.parametrize("suite", ["bench_tune", "bench_roofline"])
def test_bench_rungs_equal_reference(suite):
    from benchmarks import run as ref_bench
    got = getattr(bench, suite)(True)
    want = getattr(ref_bench, suite)(True)
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]


def test_bench_oracle_row_equals_reference():
    from benchmarks import run as ref_bench
    (name, _, derived), = bench.bench_oracle_autotune()
    (ref_name, _, ref_derived), = ref_bench.bench_oracle_autotune()
    assert (name, derived) == (ref_name, ref_derived)


@pytest.mark.parametrize("argv,text", [
    (["--fault-rate", "0.1"], "--fault-rate only applies with --service"),
    (["--qps-target", "5"], "--qps-target only applies with --service"),
    (["--service", "--tune"], "separate modes"),
    (["--service", "--qps-target", "0"], "--qps-target must be > 0")])
def test_bench_campaign_flag_errors(argv, text, capsys):
    with pytest.raises(SystemExit):
        bench.main(argv)
    assert text in capsys.readouterr().err


@pytest.mark.parametrize("text,msg", [("0,abc", "is not a number"),
                                      ("0,1.5", "must be in [0, 1]")])
def test_parse_fault_rates_rejects(text, msg):
    with pytest.raises(SystemExit, match=msg.replace("[", r"\[")):
        bench.parse_fault_rates(text)
    assert bench.parse_fault_rates("0, 0.01,0.1") == (0.0, 0.01, 0.1)


def test_catalog_covers_the_registry_and_the_card():
    rows = {r[0]: r for r in catalog_rows()}
    assert list(rows) == [e.name for e in port_core.all_experiments()]
    backends = {name: r[3].split(", ") for name, r in rows.items()}
    # Latency plans run on sim alone; throughput and contention plans on
    # every substrate (cuda and torchgrid included).
    assert backends["table4_idle_latency"] == ["sim"]
    for name in ("fig6_address_mapping", "fig9_channel_contention",
                 "roofline_empirical", "layout_autotune"):
        assert backends[name] == ["sim", "cuda", "torchgrid"], name
    ref_rows = {r[0]: r for r in ref_core.experiments.catalog_rows()}
    for name, row in rows.items():
        assert row[:3] == ref_rows[name][:3] and row[4] == ref_rows[name][4]


def test_catalog_leaves_out_fault_injected_backends(registered):
    before = catalog_markdown()
    registered("sim", "sim+catalog", rate=0.0)
    registered("cuda", "cuda+catalog", rate=0.0)
    assert catalog_markdown() == before
    assert "+catalog" not in before


def test_readme_holds_both_catalogs_in_sync():
    readme = open(os.path.join(ROOT, "README.md")).read()
    assert catalog_markdown() in readme
    assert ref_core.experiments.catalog_markdown() in readme
    lo, hi = readme.find(CATALOG_BEGIN), readme.find(CATALOG_END)
    ref_lo = readme.find(ref_core.experiments.CATALOG_BEGIN)
    ref_hi = readme.find(ref_core.experiments.CATALOG_END)
    assert 0 <= lo < hi and 0 <= ref_lo < ref_hi
    assert hi < ref_lo or ref_hi < lo          # two separate blocks


def test_catalog_cli_splices_only_its_own_block(tmp_path, capsys):
    readme = open(os.path.join(ROOT, "README.md")).read()
    stale = readme.replace(catalog_markdown(),
                           f"{CATALOG_BEGIN}\nstale\n{CATALOG_END}")
    target = tmp_path / "README.md"
    target.write_text(stale)
    bench.main(["--catalog", str(target)])
    assert target.read_text() == readme
    bench.main(["--catalog"])
    assert catalog_markdown() in capsys.readouterr().out
    bare = tmp_path / "bare.md"
    bare.write_text("no markers\n")
    with pytest.raises(SystemExit, match="markers"):
        bench.main(["--catalog", str(bare)])


def test_bench_service_cli_runs_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", "--service", "--quick",
         "--fault-rate", "0,0.1"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "service_soak_fault0", "service_soak_fault0.1"]
