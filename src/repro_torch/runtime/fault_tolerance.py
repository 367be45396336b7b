"""Fault-tolerance runtime: heartbeats, straggler detection, elastic retry.

Scope note: the *policies* here are real and unit-tested; the failure
signals are injected through `HealthSource` so the same controller drives
either simulated failures (tests, examples, the campaign service's fault
injection) or real ones (on a cluster: torch.distributed heartbeats and
collective timeouts).

Design for 1000+ nodes (DESIGN.md §4):
  * deterministic stateless data => restart needs only
    (checkpoint, step), no data-iterator state;
  * elastic re-mesh: on node loss, the controller restores the latest
    checkpoint onto the largest usable (pods, data, model) mesh from the
    configured ladder, re-lowering the step function;
  * straggler mitigation: per-host step-time EWMA; hosts slower than
    median * threshold for `patience` consecutive steps are reported for
    eviction (evict & re-mesh rather than backup workers, since
    collectives are synchronous).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class HealthSource:
    """Pluggable source of node-health signals."""

    def alive_nodes(self) -> List[int]:
        raise NotImplementedError

    def step_times(self) -> Dict[int, float]:
        """Most recent per-host step wall time (seconds)."""
        raise NotImplementedError


class SimulatedHealth(HealthSource):
    """Scripted failures/stragglers for tests and examples."""

    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes
        self._dead: set = set()
        self._slow: Dict[int, float] = {}
        self.base_step_time = 1.0

    def kill(self, node: int):
        self._dead.add(node)

    def revive(self, node: int):
        self._dead.discard(node)

    def make_slow(self, node: int, factor: float):
        self._slow[node] = factor

    def alive_nodes(self) -> List[int]:
        return [n for n in range(self.num_nodes) if n not in self._dead]

    def step_times(self) -> Dict[int, float]:
        return {n: self.base_step_time * self._slow.get(n, 1.0)
                for n in self.alive_nodes()}


@dataclasses.dataclass
class StragglerDetector:
    """EWMA-based detector: flags hosts persistently slower than the fleet."""

    threshold: float = 1.5      # x median
    patience: int = 3           # consecutive flagged steps
    alpha: float = 0.3          # EWMA smoothing

    def __post_init__(self):
        self._ewma: Dict[int, float] = {}
        self._strikes: Dict[int, int] = {}

    def observe(self, step_times: Dict[int, float]) -> List[int]:
        """Feed one step's per-host times; returns hosts to evict.

        A strike requires BOTH the smoothed and the instantaneous time to
        exceed the threshold — a single transient blip (preemption, GC)
        decays out of the EWMA without accumulating strikes.

        Raises RuntimeError on an empty `step_times`: no reporting host
        means every node died (or the HealthSource broke), which is a
        recover/re-mesh situation — not a "median of nothing" numpy
        warning that silently turns the eviction math into NaNs.
        """
        if not step_times:
            raise RuntimeError(
                "StragglerDetector.observe got no step times: every node "
                "is dead (or the HealthSource returned nothing); recover "
                "and re-mesh before resuming straggler detection")
        for n, t in step_times.items():
            prev = self._ewma.get(n, t)
            self._ewma[n] = (1 - self.alpha) * prev + self.alpha * t
        med = float(np.median(list(self._ewma.values())))
        med_now = float(np.median(list(step_times.values())))
        evict = []
        for n, e in self._ewma.items():
            slow_now = step_times.get(n, 0.0) > self.threshold * med_now
            if e > self.threshold * med and slow_now:
                self._strikes[n] = self._strikes.get(n, 0) + 1
            else:
                self._strikes[n] = 0
            if self._strikes[n] >= self.patience:
                evict.append(n)
        return evict

    def forget(self, node: int) -> None:
        self._ewma.pop(node, None)
        self._strikes.pop(node, None)


@dataclasses.dataclass(frozen=True)
class MeshLadder:
    """Usable mesh configurations, largest first: (pods, data, model)."""

    rungs: Tuple[Tuple[int, int, int], ...] = (
        (2, 16, 16), (1, 16, 16), (1, 8, 16), (1, 4, 16))

    def best_for(self, alive_chips: int) -> Tuple[int, int, int]:
        for rung in self.rungs:
            p, d, m = rung
            if p * d * m <= alive_chips:
                return rung
        raise RuntimeError(
            f"only {alive_chips} chips alive; below minimum rung "
            f"{self.rungs[-1]}")


@dataclasses.dataclass
class FaultTolerantLoop:
    """Drives step_fn with checkpoint/restart + elastic re-mesh policies.

    step_fn(step) -> metrics dict; raise to signal a failure.
    on_remesh(rung) re-lowers for a new topology and restores state.

    The abort budget is *windowed*: `max_failures` bounds the failures
    seen since the last sustained-progress reset, and the budget resets
    after `reset_after_clean_steps` consecutive clean steps.  A global
    (never-resetting) count would eventually abort arbitrarily long runs
    that each recovered fine — ten node losses over a month of training
    is healthy attrition, ten in quick succession is an outage.
    `failures` still reports the total (all-time) count.
    """

    step_fn: Callable[[int], Dict]
    save_fn: Callable[[int], None]
    restore_fn: Callable[[], int]            # -> step to resume from
    health: HealthSource
    ladder: MeshLadder = MeshLadder()
    on_remesh: Optional[Callable[[Tuple[int, int, int]], None]] = None
    checkpoint_every: int = 50
    max_failures: int = 10
    reset_after_clean_steps: int = 50

    def __post_init__(self):
        self.detector = StragglerDetector()
        self.failures = 0               # all-time, for reporting
        self._window_failures = 0       # since last clean-streak reset
        self._clean_streak = 0
        self.evictions: List[int] = []
        self.remesh_events: List[Tuple[int, Tuple[int, int, int]]] = []

    def run(self, start_step: int, num_steps: int) -> Dict:
        step = start_step
        history = []
        while step < start_step + num_steps:
            try:
                metrics = self.step_fn(step)
            except Exception:
                self.failures += 1
                self._window_failures += 1
                self._clean_streak = 0
                if self._window_failures > self.max_failures:
                    raise
                step = self._recover(step)
                continue
            history.append(metrics)
            self._clean_streak += 1
            if (self._clean_streak >= self.reset_after_clean_steps
                    and self._window_failures):
                self._window_failures = 0
            # Straggler policy.
            for node in self.detector.observe(self.health.step_times()):
                if node not in self.evictions:
                    self.evictions.append(node)
                    self.detector.forget(node)
            if (step + 1) % self.checkpoint_every == 0:
                self.save_fn(step)
            step += 1
        return {"steps": len(history), "failures": self.failures,
                "evictions": self.evictions,
                "remesh_events": self.remesh_events,
                "history": history}

    def _recover(self, failed_step: int) -> int:
        alive = len(self.health.alive_nodes())
        rung = self.ladder.best_for(alive * self._chips_per_node())
        if self.on_remesh is not None:
            self.on_remesh(rung)
        self.remesh_events.append((failed_step, rung))
        return self.restore_fn()

    def _chips_per_node(self) -> int:
        # 4 chips per host, as on the reference's hosts; configurable
        # if needed.
        return 4
