"""Retry policy and circuit breaker for the campaign service.

Both primitives are wall-clock-free: backoff delays are *computed* (from
a caller-owned seeded RNG) and charged to the service's virtual clock,
never slept; the breaker's recovery timeout compares against whatever
"now" the caller passes in.  Tests and soak runs are therefore exactly
reproducible — same seed, same schedule of retries and breaker
transitions (DESIGN.md §10).
"""
from __future__ import annotations

import dataclasses

import numpy as np

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Deterministic exponential backoff with bounded jitter.

    Retry `k` (1-based) backs off ``min(base * multiplier**(k-1), max)``
    seconds, shrunk by up to `jitter` fraction via the caller's seeded
    RNG (full-jitter-style de-synchronisation without wall-clock or
    global-RNG dependence).  `max_attempts` bounds attempts per request
    per backend, the first try included.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.5

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1, got {self.multiplier}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(
                f"jitter must be in [0, 1], got {self.jitter}")

    def backoff_s(self, retry: int, rng: np.random.Generator) -> float:
        """Virtual seconds to wait before retry `retry` (1-based)."""
        if retry < 1:
            raise ValueError(f"retry must be >= 1, got {retry}")
        base = min(self.base_delay_s * self.multiplier ** (retry - 1),
                   self.max_delay_s)
        if not self.jitter:
            return base
        return base * (1.0 - self.jitter * float(rng.random()))


class CircuitOpenError(RuntimeError):
    """A call was refused because the backend's breaker is open."""


@dataclasses.dataclass
class CircuitBreaker:
    """Per-backend breaker: closed -> open -> half-open -> closed.

    `failure_threshold` consecutive failures open the circuit; while
    open, `allow(now)` refuses until `reset_timeout_s` of (virtual) time
    has passed, then admits one half-open probe — a success recloses, a
    failure re-opens.  `quarantine(now)` is the validation path's
    hard-open: the breaker never half-opens again until `reset()`
    (a backend caught returning *wrong* results is not trusted back on a
    timer; DESIGN.md §10).
    """

    name: str = ""
    failure_threshold: int = 5
    reset_timeout_s: float = 5.0

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got "
                f"{self.failure_threshold}")
        self.state = CLOSED
        self.opens = 0                   # transitions into OPEN, all-time
        self.quarantined = False
        self._consecutive_failures = 0
        self._opened_at = 0.0

    def allow(self, now: float) -> bool:
        """May a call proceed at (virtual) time `now`?  Transitions
        OPEN -> HALF_OPEN when the recovery timeout has elapsed."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.quarantined:
                return False
            if now - self._opened_at >= self.reset_timeout_s:
                self.state = HALF_OPEN
                return True
            return False
        return True                      # HALF_OPEN: admit the probe

    def _open(self, now: float) -> None:
        if self.state != OPEN:
            self.state = OPEN
            self.opens += 1
        self._opened_at = now

    def record_success(self) -> None:
        self._consecutive_failures = 0
        self.state = CLOSED

    def record_failure(self, now: float) -> None:
        self._consecutive_failures += 1
        if (self.state == HALF_OPEN
                or self._consecutive_failures >= self.failure_threshold):
            self._open(now)

    def quarantine(self, now: float) -> None:
        """Hard-open: refuse every call until an explicit `reset()`."""
        self._open(now)
        self.quarantined = True

    def reset(self) -> None:
        """Operator override: back to closed, quarantine lifted."""
        self.state = CLOSED
        self.quarantined = False
        self._consecutive_failures = 0
