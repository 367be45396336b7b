"""Heterogeneous engine mixes: ordered per-engine ``(params, op)`` tuples.

The contention stack grew up around *N identical engines* — one
:class:`~repro_torch.core.params.RSTParams` tuple and one traffic direction,
scaled by ``num_engines`` (Shuhai Fig. 9).  Real HBM consumers mix
readers, writers, and duplex streams with different RST tuples — the
regime where Choi et al. ("When HLS Meets FPGA HBM") report
30%→90%-of-nominal swings.  :class:`EngineMix` is that workload as a
value: an ordered tuple of per-engine ``(params, op)`` entries, threaded
through ``timing_model.contended_throughput_mix`` →
``Backend``/``Engine``/``Sweep`` cache keys (DESIGN.md §13).

Two invariants anchor the refactor:

* **normalization** — the old ``num_engines: int`` spelling and an
  all-identical mix are the *same request*: every layer normalizes a
  uniform mix back to the homogeneous ``(params, op, N)`` form
  (:meth:`EngineMix.uniform_entry`), so memo/flight keys cannot fork on
  spelling and the homogeneous path stays bit-identical.
* **ordering matters** — entry order is grant order: round-robin and
  burst grants rotate over entries in sequence, exclusive concatenates
  whole streams in entry order, and per-engine address windows tile
  consecutively (engine k's window starts at ``sum(w_j for j < k)``).

:func:`parse_mix_spec` is the CLI grammar (``--engines 2r+1w+1d`` in
the reference CLI): ``COUNT OP [+ COUNT OP ...]`` with ops ``r``/``w``/``d``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Optional, Tuple

from repro_torch.core.params import RSTParams

#: Traffic directions an engine entry may carry (mirrors timing_model.OPS).
MIX_OPS = ("read", "write", "duplex")

#: CLI shorthand for --engines mix specs, e.g. "2r+1w+1d".
_OP_SHORTHAND = {"r": "read", "w": "write", "d": "duplex"}

#: The accepted --engines grammar, quoted verbatim by parse errors.
MIX_SPEC_GRAMMAR = (
    "COUNTop[+COUNTop...] with op one of r (read), w (write), d (duplex) "
    "— e.g. '2r+1w+1d' = 2 readers + 1 writer + 1 duplex engine; "
    "a bare integer N means N identical engines")

_TERM_RE = re.compile(r"^(\d+)([rwd])$")


@dataclasses.dataclass(frozen=True)
class EngineMix:
    """An ordered tuple of per-engine ``(params, op)`` entries.

    Frozen and hashable so it can sit directly in ``Sweep``/``Engine``
    memo keys and service request keys (REPRO-C001..C004).
    """

    entries: Tuple[Tuple[RSTParams, str], ...]

    def __post_init__(self):
        if not self.entries:
            raise ValueError("EngineMix needs at least one (params, op) "
                             "entry")
        entries = tuple((p, op) for p, op in self.entries)
        for p, op in entries:
            if not isinstance(p, RSTParams):
                raise TypeError(
                    f"EngineMix entry params must be RSTParams, got "
                    f"{type(p).__name__}")
            if op not in MIX_OPS:
                raise ValueError(
                    f"unknown op {op!r} in EngineMix; valid: {MIX_OPS}")
        object.__setattr__(self, "entries", entries)

    # ------------------------------------------------------------- views
    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    @property
    def num_engines(self) -> int:
        return len(self.entries)

    @property
    def params(self) -> Tuple[RSTParams, ...]:
        return tuple(p for p, _ in self.entries)

    @property
    def ops(self) -> Tuple[str, ...]:
        return tuple(op for _, op in self.entries)

    @property
    def is_uniform(self) -> bool:
        """True when every engine carries the same (params, op) entry —
        the homogeneous case every layer reduces back to."""
        return all(e == self.entries[0] for e in self.entries[1:])

    def uniform_entry(self) -> Optional[Tuple[RSTParams, str]]:
        """The single (params, op) of a uniform mix, else None."""
        return self.entries[0] if self.is_uniform else None

    def validate(self, spec) -> "EngineMix":
        for p, _ in self.entries:
            p.validate(spec)
        return self

    def describe(self) -> str:
        """Compact run-length spelling, e.g. '2r+1w+1d' (grant order)."""
        runs = []
        for p, op in self.entries:
            if runs and runs[-1][1] == op and runs[-1][2] == p:
                runs[-1][0] += 1
            else:
                runs.append([1, op, p])
        return "+".join(f"{n}{op[0]}" for n, op, _ in runs)

    # ------------------------------------------------------------ builders
    @classmethod
    def uniform(cls, p: RSTParams, op: str, num_engines: int) -> "EngineMix":
        """The homogeneous mix the old ``num_engines`` spelling names."""
        if num_engines < 1:
            raise ValueError(
                f"num_engines must be >= 1, got {num_engines}")
        return cls(((p, op),) * num_engines)

    @classmethod
    def of(cls, entries: Iterable[Tuple[RSTParams, str]]) -> "EngineMix":
        return cls(tuple(entries))

    @classmethod
    def from_spec(cls, spec_str: str, p: RSTParams) -> "EngineMix":
        """Build a mix from a '2r+1w+1d' spec with one shared RST tuple."""
        return cls(tuple((p, op) for op in parse_mix_spec(spec_str)))


def parse_mix_spec(spec_str: str) -> Tuple[str, ...]:
    """Parse a ``2r+1w+1d`` mix spec into an op tuple, grant order.

    Raises ValueError quoting :data:`MIX_SPEC_GRAMMAR` on any malformed
    spec (the ``benchmarks.run --engines`` UX, DESIGN.md §13).
    """
    ops = []
    for term in str(spec_str).strip().split("+"):
        m = _TERM_RE.match(term.strip())
        if not m:
            raise ValueError(
                f"bad engine-mix term {term.strip()!r} in "
                f"{spec_str!r}; accepted grammar: {MIX_SPEC_GRAMMAR}")
        count, op = int(m.group(1)), _OP_SHORTHAND[m.group(2)]
        if count < 1:
            raise ValueError(
                f"engine count must be >= 1 in term {term.strip()!r}; "
                f"accepted grammar: {MIX_SPEC_GRAMMAR}")
        ops.extend([op] * count)
    if not ops:
        raise ValueError(
            f"empty engine-mix spec {spec_str!r}; accepted grammar: "
            f"{MIX_SPEC_GRAMMAR}")
    return tuple(ops)


def normalize_mix(mix: Optional[EngineMix], p: RSTParams, op: str,
                  num_engines: int
                  ) -> Tuple[Optional[EngineMix], RSTParams, str, int]:
    """Collapse the two contention spellings onto one canonical form.

    Returns ``(mix, params, op, num_engines)`` where a uniform mix has
    been folded back into the homogeneous ``(params, op, N)`` spelling
    (``mix=None``), and a genuinely mixed mix keeps its entry-0 params/op
    as the representative with ``num_engines == len(mix)``.  Every cache
    key built from the normalized tuple is therefore identical for
    ``num_engines=N`` and ``EngineMix.uniform(p, op, N)`` — the REPRO-C001
    honesty requirement of the refactor.
    """
    if mix is None:
        return None, p, op, num_engines
    uni = mix.uniform_entry()
    if uni is not None:
        return None, uni[0], uni[1], len(mix)
    return mix, mix.entries[0][0], mix.entries[0][1], len(mix)
