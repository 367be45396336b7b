"""Latency module: bounded capture list + page-state classification.

Mirrors the hardware latency module of Sec. III-C-4: a list of `depth`
entries (synthesis parameter, 1024 in the paper's build), each a
`counter_bits`-wide saturating register holding one serial latency in
cycles.  On top of the raw capture we provide the analyses the paper
performs: clustering latencies into page-hit / page-closed / page-miss
(Table IV) and estimating the refresh interval (Fig. 4).

The module is *per-transaction instrumentation*, not a read-only probe:

* **op-aware** — ``op`` selects which engine module's traffic the capture
  list holds.  Write misses carry the write-recovery segment tWR (the
  precharge a miss requires waits out the previous write, DESIGN.md §7),
  so the write-mode miss anchor sits tWR above the read anchor; duplex
  traffic is half writes on average, so its miss anchor shifts by tWR/2.
  Classifying a write capture with read anchors mis-bins tWR-bearing
  misses as refresh on specs where tWR exceeds the 8-cycle refresh
  margin (e.g. the modeled HBM3's 11-cycle tWR).
* **width-aware** — ``counter_bits`` is the synthesis parameter of the
  capture registers (8 in the RTL, hence the historical 255 clamp).
  Classification derives its anchors *and* the refresh threshold from
  the saturation point: anchors clamp to the counter maximum, and the
  refresh threshold clamps to one below it so saturated samples still
  bin as refresh when the miss anchor approaches the counter ceiling —
  with the old unclamped ``miss + 8`` threshold, a distant Table-VI
  crossing (or contention-inflated ``extra_cycles``) near 255 made the
  threshold unreachable, refresh counts collapsed to 0, and every
  saturated sample mis-binned as "miss".  Widening ``counter_bits``
  removes the saturation entirely (a 16-bit build of the RTL register).
* **contention-aware** — a contended capture (``num_engines > 1`` on the
  engine, DESIGN.md §9) is *bimodal* under burst-grant arbitration: the
  grant-head transactions carry the arbitration rotation's queueing
  delay while the beats riding a grant post at the uncontended anchors.
  :meth:`LatencyModule.classify_contended` therefore classifies against
  *doubled* anchor ladders — the base ``hit/closed/miss`` plus
  ``hit_queued/closed_queued/miss_queued`` shifted by the grant-head
  wait — so a contended capture splits into its two populations instead
  of smearing between anchors.  With a zero queueing shift the queued
  ladder collapses onto the base one and the counts reduce exactly to
  :meth:`LatencyModule.classify`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Union

import numpy as np

from repro_torch.core.engine_mix import EngineMix
from repro_torch.core.hwspec import MemorySpec
from repro_torch.core.timing_model import LatencyTrace

DEFAULT_DEPTH = 1024
DEFAULT_COUNTER_BITS = 8   # the paper's 8-bit saturating registers

# Traffic directions the capture list can hold, mirroring the timing
# model's ops: the miss anchor shifts by tWR for writes, tWR/2 for duplex.
CAPTURE_OPS = ("read", "write", "duplex")

# Anchor classes of a contended capture (DESIGN.md §9): the base ladder
# plus its queueing-shifted twin.  Order matters — argmin takes the first
# minimum, so base classes win ties when the queueing shift is zero and
# classify_contended reduces exactly to classify.
CONTENDED_STATES = ("hit", "closed", "miss",
                    "hit_queued", "closed_queued", "miss_queued")

# Narrowest unsigned dtype covering each legal counter width.
_WIDTH_DTYPES = ((8, np.uint8), (16, np.uint16), (32, np.uint32))


@dataclasses.dataclass
class LatencyModule:
    """One hardware latency-capture list plus its classification logic.

    `depth` and `counter_bits` are synthesis parameters (list length and
    register width); `op` declares which engine module feeds the list so
    the page-state anchors include the direction's timing segments.
    """

    depth: int = DEFAULT_DEPTH
    counter_bits: int = DEFAULT_COUNTER_BITS
    op: str = "read"

    def __post_init__(self):
        if self.depth <= 0:
            raise ValueError(f"depth must be positive, got {self.depth}")
        if not 1 <= self.counter_bits <= 32:
            raise ValueError(
                f"counter_bits must be in [1, 32], got {self.counter_bits}")
        if self.op not in CAPTURE_OPS:
            raise ValueError(
                f"unknown op {self.op!r}; valid: {CAPTURE_OPS}")
        self._dtype = next(d for bits, d in _WIDTH_DTYPES
                           if self.counter_bits <= bits)

    @property
    def saturate(self) -> int:
        """Largest value a capture register can hold."""
        return (1 << self.counter_bits) - 1

    def capture(self, trace: LatencyTrace) -> np.ndarray:
        """Store up to `depth` latencies, saturating like the RTL."""
        lat = np.minimum(np.round(trace.cycles[: self.depth]), self.saturate)
        return lat.astype(self._dtype)

    def anchors(self, spec: MemorySpec, extra_cycles: int = 0
                ) -> Dict[str, int]:
        """Page-state anchor latencies for this module's traffic direction.

        `extra_cycles` shifts all anchors (switch penalty + distance, or a
        contention queueing term) so the same classifier serves Table IV
        (switch off), Table VI (on) and contended captures.  Write misses
        add tWR (duplex: tWR/2) to the miss anchor, matching
        `timing_model.serial_latencies`.  Anchors clamp to the counter's
        saturation point — a saturated register can never read higher.
        """
        miss_extra = 0.0
        if self.op == "write":
            miss_extra = spec.ns_to_cycles(spec.t_wr_ns)
        elif self.op == "duplex":
            miss_extra = 0.5 * spec.ns_to_cycles(spec.t_wr_ns)
        raw = {
            "hit": spec.lat_page_hit + extra_cycles,
            "closed": spec.lat_page_closed + extra_cycles,
            "miss": int(round(spec.lat_page_miss + extra_cycles
                              + miss_extra)),
        }
        return {name: min(int(v), self.saturate) for name, v in raw.items()}

    def _refresh_threshold(self, anchors: Dict[str, int]) -> int:
        """Samples strictly above this bin as refresh-stalled.

        Normally `miss + 8` (the paper's spike margin), but clamped to one
        below the saturation point so saturated samples remain detectable;
        never below the miss anchor itself (when the miss anchor saturates
        the counter, refresh and miss are indistinguishable — widen
        `counter_bits`)."""
        return max(min(anchors["miss"] + 8, self.saturate - 1),
                   anchors["miss"])

    def _nearest_anchor(self, captured: np.ndarray,
                        anchors: Dict[str, int]) -> tuple:
        """(nearest-anchor index array, refresh-inflated mask); argmin takes
        the first minimum, preserving the hit < closed < miss tie-break of
        the original per-sample scan."""
        c = np.asarray(captured, dtype=np.int64)
        vals = np.array([anchors["hit"], anchors["closed"], anchors["miss"]],
                        dtype=np.int64)
        nearest = np.argmin(np.abs(c[:, None] - vals[None, :]), axis=1)
        refresh = c > self._refresh_threshold(anchors)
        return nearest, refresh

    def classify(self, captured: np.ndarray, spec: MemorySpec,
                 extra_cycles: int = 0) -> Dict[str, int]:
        """Count page states by matching against this op's anchor latencies."""
        nearest, refresh = self._nearest_anchor(
            captured, self.anchors(spec, extra_cycles))
        counts = {name: int(np.count_nonzero(~refresh & (nearest == k)))
                  for k, name in enumerate(("hit", "closed", "miss"))}
        counts["refresh"] = int(np.count_nonzero(refresh))
        return counts

    def contended_anchors(self, spec: MemorySpec, queueing_cycles: float,
                          extra_cycles: int = 0) -> Dict[str, int]:
        """The doubled anchor ladder of a contended capture (DESIGN.md §9).

        `queueing_cycles` is the grant-head arbitration wait the contended
        trace's shifted population carries
        (``ContentionResult.detail["grant_head_wait_cycles"]``, or the
        round-robin mean when every transaction pays it).  The queued
        ladder clamps to the counter's saturation point exactly like the
        base one — a large rotation wait is precisely what pushes an
        8-bit capture into saturation.
        """
        out = dict(self.anchors(spec, extra_cycles))
        for name in ("hit", "closed", "miss"):
            out[f"{name}_queued"] = min(
                int(round(out[name] + queueing_cycles)), self.saturate)
        return out

    def classify_contended(self, captured: np.ndarray, spec: MemorySpec,
                           queueing_cycles: float,
                           extra_cycles: int = 0) -> Dict[str, int]:
        """Count the six contended classes plus refresh.

        A burst-grant contended capture is bimodal — grant heads pay the
        rotation wait, riders post at the uncontended anchors — so the
        classifier matches against both ladders at once, and *each
        population keeps its own refresh threshold*: a rider that
        stalled behind a refresh sits 8+ cycles above the base miss
        anchor (far below the queued ladder — a single shared threshold
        above ``miss_queued`` would silently rebin every rider refresh
        spike as miss), while a refresh-stalled grant head sits above
        ``miss_queued + 8``.  Both thresholds clamp to the saturation
        point like :meth:`_refresh_threshold`.  With
        ``queueing_cycles=0`` the queued ladder collapses onto the base
        one and the counts reduce exactly to :meth:`classify` (all
        ``*_queued`` counts zero).
        """
        anchors = self.contended_anchors(spec, queueing_cycles, extra_cycles)
        c = np.asarray(captured, dtype=np.int64)
        vals = np.array([anchors[k] for k in CONTENDED_STATES],
                        dtype=np.int64)
        nearest = np.argmin(np.abs(c[:, None] - vals[None, :]), axis=1)
        base_thresh = self._refresh_threshold(anchors)
        queued_thresh = max(min(anchors["miss_queued"] + 8,
                                self.saturate - 1), anchors["miss_queued"])
        refresh = np.where(nearest < 3, c > base_thresh, c > queued_thresh)
        counts = {name: int(np.count_nonzero(~refresh & (nearest == k)))
                  for k, name in enumerate(CONTENDED_STATES)}
        counts["refresh"] = int(np.count_nonzero(refresh))
        return counts

    @classmethod
    def for_mix_entry(cls, mix: EngineMix, index: int, *,
                      depth: int = DEFAULT_DEPTH,
                      counter_bits: int = DEFAULT_COUNTER_BITS
                      ) -> "LatencyModule":
        """A capture module bound to one engine of a heterogeneous mix.

        The module's ``op`` is that entry's *own* traffic direction, so
        its anchors carry the entry's timing segments (a write entry's
        miss anchor sits tWR above a read entry's, DESIGN.md §13) —
        classifying every engine of a mixed capture against one shared
        op's anchors re-introduces the PR 4 cross-binning bug class.
        """
        return cls(depth=depth, counter_bits=counter_bits,
                   op=mix.entries[index][1])

    @staticmethod
    def modal_latency(captured: np.ndarray) -> int:
        """The dominant (modal) latency — the paper's per-category number."""
        vals, freq = np.unique(captured, return_counts=True)
        return int(vals[np.argmax(freq)])

    def category_latencies(self, captured: np.ndarray, spec: MemorySpec,
                           extra_cycles: int = 0) -> Dict[str, int]:
        """Per-category modal latency, for reproducing Table IV/VI rows."""
        nearest, refresh = self._nearest_anchor(
            captured, self.anchors(spec, extra_cycles))
        c = np.asarray(captured, dtype=np.int64)
        out: Dict[str, int] = {}
        for k, name in enumerate(("hit", "closed", "miss")):
            vals = c[~refresh & (nearest == k)]   # refresh samples excluded
            out[name] = int(np.median(vals)) if vals.size else -1
        return out


def classify_mix_contended(captures: Sequence[np.ndarray], spec: MemorySpec,
                           mix: EngineMix,
                           queueing_cycles: Union[float, Sequence[float]],
                           extra_cycles: int = 0, *,
                           depth: int = DEFAULT_DEPTH,
                           counter_bits: int = DEFAULT_COUNTER_BITS
                           ) -> List[Dict[str, int]]:
    """Classify per-engine contended captures of a heterogeneous mix.

    ``captures[k]`` is engine k's capture list, classified against that
    entry's *own* op anchors (``LatencyModule.for_mix_entry``) — a write
    entry's miss population binds to the tWR-shifted write-miss anchor
    while its read neighbours keep the unshifted one, so mixed-direction
    captures never cross-bin (the PR 4 bug class, DESIGN.md §13).
    `queueing_cycles` is the grant-head arbitration wait, a scalar shared
    by every engine or one value per engine (a mixed rotation's waits
    differ engine to engine).  Returns one contended-count dict per
    engine, entry order.
    """
    if len(captures) != len(mix):
        raise ValueError(
            f"got {len(captures)} capture lists for a {len(mix)}-engine "
            f"mix; one per entry, entry order")
    qs = np.broadcast_to(
        np.asarray(queueing_cycles, dtype=np.float64), (len(mix),))
    out: List[Dict[str, int]] = []
    for k, cap in enumerate(captures):
        mod = LatencyModule.for_mix_entry(mix, k, depth=depth,
                                          counter_bits=counter_bits)
        out.append(mod.classify_contended(cap, spec, float(qs[k]),
                                          extra_cycles))
    return out
