"""The port's fault-tolerance runtime (`repro_torch.runtime`) against the
reference (`repro.runtime`), on the cases of
tests/substrate/test_runtime_serving.py: the straggler detector, the mesh
ladder and the fault-tolerant loop over a simulated health source.  Each
case runs on both packages and must give the same answer.
"""
import inspect

import pytest

import repro.runtime as ref_rt
import repro_torch.runtime as rt
from repro.runtime import fault_tolerance as ref_ft
from repro_torch.runtime import fault_tolerance as ft

BOTH = [pytest.param(rt, id="port"), pytest.param(ref_rt, id="reference")]


def test_public_surface_matches_reference():
    assert rt.__all__ == ref_rt.__all__
    names = sorted(n for n, v in vars(ref_ft).items()
                   if inspect.isclass(v) and v.__module__ == ref_ft.__name__)
    assert names == sorted(n for n, v in vars(ft).items()
                           if inspect.isclass(v)
                           and v.__module__ == ft.__name__)


class TestStragglerDetector:
    @pytest.mark.parametrize("pkg", BOTH)
    def test_flags_persistent_straggler(self, pkg):
        det = pkg.StragglerDetector(threshold=1.5, patience=3)
        times = {i: 1.0 for i in range(8)}
        times[3] = 4.0
        evicted = []
        for _ in range(5):
            evicted = det.observe(times)
        assert 3 in evicted

    @pytest.mark.parametrize("pkg", BOTH)
    def test_transient_blip_not_flagged(self, pkg):
        det = pkg.StragglerDetector(threshold=1.5, patience=3)
        base = {i: 1.0 for i in range(8)}
        det.observe({**base, 2: 5.0})
        for _ in range(5):
            out = det.observe(base)
        assert out == []

    def test_empty_step_times_raises_cleanly(self):
        det = rt.StragglerDetector()
        det.observe({0: 1.0, 1: 1.0})
        with pytest.raises(RuntimeError, match="no step times") as got:
            det.observe({})
        ref = ref_rt.StragglerDetector()
        ref.observe({0: 1.0, 1: 1.0})
        with pytest.raises(RuntimeError) as want:
            ref.observe({})
        assert str(got.value) == str(want.value)
        assert det.observe({0: 1.0, 1: 1.0}) == []

    def test_eviction_sequence_equals_reference(self):
        """A long, uneven trace: the same evictions, step for step."""
        got, want = rt.StragglerDetector(), ref_rt.StragglerDetector()
        for step in range(60):
            times = {n: 1.0 + 0.05 * ((n * 7 + step) % 5) for n in range(6)}
            if 10 <= step < 30:
                times[2] = 3.5
            if step % 9 == 0:
                times[4] = 6.0
            assert got.observe(times) == want.observe(times), step
            if step == 35:
                got.forget(2)
                want.forget(2)


class TestMeshLadder:
    @pytest.mark.parametrize("chips,rung", [
        (512, (2, 16, 16)), (400, (1, 16, 16)), (256, (1, 16, 16)),
        (130, (1, 8, 16)), (64, (1, 4, 16))])
    def test_rungs(self, chips, rung):
        assert rt.MeshLadder().best_for(chips) == rung
        assert ref_rt.MeshLadder().best_for(chips) == rung

    def test_below_the_last_rung_raises(self):
        with pytest.raises(RuntimeError) as got:
            rt.MeshLadder().best_for(8)
        with pytest.raises(RuntimeError) as want:
            ref_rt.MeshLadder().best_for(8)
        assert str(got.value) == str(want.value)


class TestSimulatedHealth:
    def test_kill_revive_slow(self):
        for pkg in (rt, ref_rt):
            h = pkg.SimulatedHealth(num_nodes=4)
            h.kill(1)
            h.make_slow(2, 3.0)
            assert h.alive_nodes() == [0, 2, 3]
            assert h.step_times() == {0: 1.0, 2: 3.0, 3: 1.0}
            h.revive(1)
            assert h.alive_nodes() == [0, 1, 2, 3]

    def test_health_source_is_abstract(self):
        with pytest.raises(NotImplementedError):
            rt.HealthSource().alive_nodes()
        with pytest.raises(NotImplementedError):
            rt.HealthSource().step_times()


def _recovering_run(pkg):
    health = pkg.SimulatedHealth(num_nodes=128)
    saved = {"step": 0}
    fail_at = {17}

    def step_fn(step):
        if step in fail_at:
            fail_at.remove(step)
            health.kill(99)
            raise RuntimeError("simulated node loss")
        return {"step": step}

    def save_fn(step):
        saved["step"] = step

    def restore_fn():
        return saved["step"] + 1

    remeshes = []
    loop = pkg.FaultTolerantLoop(
        step_fn=step_fn, save_fn=save_fn, restore_fn=restore_fn,
        health=health, on_remesh=remeshes.append, checkpoint_every=5)
    return loop.run(0, 30), remeshes


class TestFaultTolerantLoop:
    def test_recovers_from_failure(self):
        out, remeshes = _recovering_run(rt)
        assert out["failures"] == 1
        assert len(out["remesh_events"]) == 1
        # 127 nodes * 4 chips = 508 -> falls back to the single-pod mesh.
        assert remeshes == [(1, 16, 16)]
        assert out["steps"] >= 25
        assert (out, remeshes) == _recovering_run(ref_rt)

    @pytest.mark.parametrize("pkg", BOTH)
    def test_straggler_evicted_during_run(self, pkg):
        health = pkg.SimulatedHealth(num_nodes=8)
        health.make_slow(5, 4.0)
        loop = pkg.FaultTolerantLoop(
            step_fn=lambda s: {"step": s}, save_fn=lambda s: None,
            restore_fn=lambda: 0, health=health, checkpoint_every=100)
        out = loop.run(0, 10)
        assert 5 in out["evictions"]

    @pytest.mark.parametrize("pkg", BOTH)
    def test_gives_up_after_max_failures(self, pkg):
        health = pkg.SimulatedHealth(num_nodes=128)

        def step_fn(step):
            raise RuntimeError("persistent failure")

        loop = pkg.FaultTolerantLoop(
            step_fn=step_fn, save_fn=lambda s: None, restore_fn=lambda: 0,
            health=health, max_failures=2)
        with pytest.raises(RuntimeError, match="persistent"):
            loop.run(0, 5)
        assert loop.failures == 3

    @pytest.mark.parametrize("pkg", BOTH)
    def test_failure_budget_resets_after_sustained_progress(self, pkg):
        health = pkg.SimulatedHealth(num_nodes=128)
        fail_at = {10, 40, 70, 100, 130}

        def step_fn(step):
            if step in fail_at:
                fail_at.remove(step)
                raise RuntimeError("spaced node loss")
            return {"step": step}

        loop = pkg.FaultTolerantLoop(
            step_fn=step_fn, save_fn=lambda s: None,
            restore_fn=lambda: 0, health=health, max_failures=2,
            reset_after_clean_steps=20, checkpoint_every=1000)
        out = loop.run(0, 150)
        assert out["failures"] == 5

    @pytest.mark.parametrize("pkg", BOTH)
    def test_clustered_failures_still_abort(self, pkg):
        health = pkg.SimulatedHealth(num_nodes=128)
        calls = {"n": 0}

        def step_fn(step):
            calls["n"] += 1
            if calls["n"] % 2 == 0:
                raise RuntimeError("clustered failure")
            return {"step": step}

        loop = pkg.FaultTolerantLoop(
            step_fn=step_fn, save_fn=lambda s: None,
            restore_fn=lambda: 0, health=health, max_failures=3,
            reset_after_clean_steps=20)
        with pytest.raises(RuntimeError, match="clustered"):
            loop.run(0, 100)

    def test_checkpoints_and_history_equal_reference(self):
        def run(pkg):
            saves = []
            health = pkg.SimulatedHealth(num_nodes=16)
            health.make_slow(3, 2.5)
            loop = pkg.FaultTolerantLoop(
                step_fn=lambda s: {"step": s, "sq": s * s},
                save_fn=saves.append, restore_fn=lambda: 0, health=health,
                checkpoint_every=7)
            return loop.run(3, 40), saves
        assert run(rt) == run(ref_rt)
