"""Event-level DRAM timing model for the `sim` backend (vectorized).

Two entry points, mirroring the two measurement modes of the paper's engine
module (Sec. III-C-1), both *direction-aware* — the engine has independent
read and write modules, and Sec. IV treats writes and mixed read/write
traffic as first-class workloads:

* :func:`serial_latencies` — the latency mode: exactly one outstanding
  transaction; the (i+1)-th is issued only after the i-th returns.
  Reproduces Fig. 4 (refresh spikes), Fig. 5 / Table IV (page hit / closed /
  miss), Table VI (switch distance).  ``op="write"`` adds the write-recovery
  segment (tWR) to the page-miss path: the precharge a miss requires must
  wait out the previous write's recovery.  :func:`serial_read_latencies`
  remains the read-only alias.

* :func:`throughput` — the saturating mode: the engine always asserts the
  address-valid signals, the controller reorders inside a window.  Modeled as
  a steady-state resource-bound analysis at DRAM *column-command*
  granularity:

    - data bus:       1 command (= bus_bytes) per AXI cycle,
    - bank group:     1 command per tCCD_L per bank group (tCCD_S across
                      groups) — this is what makes bank-group interleaving
                      (paper Sec. V-D) and the LSB "BG" bit of the default
                      RGBCG policy matter,
    - bank:           row activations serialize at tRC per bank; write
                      traffic extends each activation by tWR (write
                      recovery before precharge), duplex by tWR/2,
    - turnaround:     duplex traffic reverses the bus direction; the
                      modeled controller groups reads and writes within a
                      reorder window, paying one read->write plus one
                      write->read turnaround (tRTW + tWTR) per window,
    - tFAW:           at most 4 activations per tFAW window,
    - refresh:        (1 - tRFC/tREFI) de-rating,
    - scheduler:      calibrated constant inefficiency.

  ``op="read"`` reproduces the pre-write-path numbers bit-for-bit (the
  direction overheads are exactly zero).

* :func:`contended_throughput` — N engines sharing one channel /
  mini-switch port (DESIGN.md §8/§9): the engines' streams are interleaved
  (engine k over its own W-byte window at ``A + k*W``) and the shared
  stream runs through the same three bounds, so contention *emerges* from
  interleaving — row thrash in shared banks, shortened bank-group runs —
  rather than being asserted.  The *arbitration granularity* is an axis
  (``arbitration``, ``burst_beats``): ``"round_robin"`` alternates engines
  every transaction (the worst case, and the bit-identical ``burst_beats=1``
  special case of ``"burst"``), ``"burst"`` grants each engine
  ``burst_beats`` consecutive transactions per rotation (preserving
  row-buffer locality inside a grant — the lever Choi et al. 2020 show
  moves multi-PE designs from ~30% to ~90% of nominal), and
  ``"exclusive"`` serializes whole streams (each engine runs to completion
  before the next — the upper grant-size bound that ``burst`` converges to
  as ``burst_beats`` grows).  Reports the aggregate/per-engine bandwidth
  split plus per-policy queueing-delay terms; bit-identical to
  :func:`throughput` at ``num_engines=1`` under every policy.

* contended *latency* — :func:`serial_latencies` accepts the same
  ``num_engines`` / ``arbitration`` / ``burst_beats`` axes and feeds the
  per-engine queueing delay back into the per-transaction trace:
  round-robin shifts every transaction by the mean arbitration wait,
  burst grants concentrate the same mean wait onto each grant-head
  transaction (a bimodal contended distribution — the new latency classes
  `core/latency.py` classifies), and exclusive grants pay one up-front
  whole-stream wait.  ``num_engines=1`` is bit-identical to the
  uncontended trace.

Cross-channel contention — streams landing on *different* channels of the
same (or a distant) mini-switch — is the switch fabric's business, not the
DRAM's: see ``core/switch.py`` (per-mini-switch aggregate and lateral-link
capacity terms) and ``Engine.evaluate_contention(placement=...)``.

Both functions are NumPy array code end to end (DESIGN.md §3):

* Page-state classification is a segment analysis: a stable argsort groups
  the stream by bank, a shifted-array comparison finds each transaction's
  previous same-bank access, and hit/closed/miss falls out of one row
  comparison.  The only remaining Python loop in the serial model iterates
  over *refresh epochs* (~tREFI of simulated time each), not transactions.
* The throughput bounds are segment reductions over reorder-window chunks:
  per-window distinct-bank-group counts via a row-wise sort, per-window
  per-bank activation counts via ``np.bincount`` on a (window, bank) key.

The loop-based reference implementation is preserved verbatim in
:mod:`repro_torch.core._timing_reference`; parity tests pin this module to it.

  Calibration anchors (see tests/core/test_timing_model.py):
    HBM  sequential read  B=32  -> 13.27 GB/s  (Table V)
    DDR4 sequential read  B=64  -> 18.0  GB/s  (Table V)
    HBM  B=32 W=8K  S=4K        -> ~6.7 GB/s   (Sec. V-E)
    HBM  B=32 W=256M S=4K       -> ~2.4 GB/s   (Sec. V-E)
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.address_mapping import AddressMapping
from repro_torch.core.engine_mix import EngineMix
from repro_torch.core.hwspec import MemorySpec
from repro_torch.core.params import RSTParams

# Page states, following Sec. V-B.
PAGE_HIT, PAGE_CLOSED, PAGE_MISS = "hit", "closed", "miss"
_STATE_NAMES = np.array((PAGE_HIT, PAGE_CLOSED, PAGE_MISS))

# Cap on how many transactions we expand when the stream is periodic.
_MAX_EXPAND = 1 << 16
# Reorder-window size (transactions) of the modeled controller.
_REORDER_WINDOW = 64

# Traffic directions of the engine module: its read module, its write
# module, or both running concurrently over one channel (Sec. III-C-1).
OPS = ("read", "write", "duplex")
# Arbitration granularities of the shared channel port (DESIGN.md §9):
# per-transaction round robin (the worst case), burst grants of
# `burst_beats` consecutive transactions per engine per rotation, and
# exclusive whole-stream grants (the serialized upper bound).
ARBITRATION_POLICIES = ("round_robin", "burst", "exclusive")
# Serial latency is one-transaction-at-a-time; a duplex direction has no
# meaning there (there is never a second in-flight transaction to turn the
# bus around for).
SERIAL_OPS = ("read", "write")


def _grant_beats(arbitration: str, burst_beats: int, txns: int) -> int:
    """Transactions one engine issues per arbitration grant.

    ``round_robin`` is defined as the one-beat grant (and rejects any other
    ``burst_beats`` so a mismatched pair fails loudly instead of silently
    meaning something else); ``burst`` grants ``burst_beats`` beats;
    ``exclusive`` grants the whole stream — equivalently ``burst`` with
    ``burst_beats >= txns``, which is exactly how ``burst`` converges to
    the serialized bound as the grant grows.  Burst grants clamp to the
    stream length: a grant cannot outlast the stream, and an unclamped
    size would inflate the grant-head wait terms past the physical
    maximum of the other engines' whole streams (the device-side kernel
    clamps identically).
    """
    if arbitration not in ARBITRATION_POLICIES:
        raise ValueError(f"unknown arbitration {arbitration!r}; valid: "
                         f"{ARBITRATION_POLICIES}")
    if burst_beats < 1:
        raise ValueError(f"burst_beats must be >= 1, got {burst_beats}")
    if arbitration != "burst" and burst_beats != 1:
        raise ValueError(
            f"burst_beats={burst_beats} only applies to the 'burst' policy; "
            f"{arbitration!r} fixes the grant size (round_robin: 1 beat, "
            f"exclusive: the whole stream)")
    if arbitration == "round_robin":
        return 1
    if arbitration == "exclusive":
        return max(1, txns)
    return min(burst_beats, max(1, txns))


def _direction_overheads(spec: MemorySpec, op: str) -> Tuple[float, float]:
    """(per-reorder-window turnaround cycles, per-activation extra cycles)
    for one traffic direction.

    Reads: zero on both axes — the read path is bit-identical to the
    pre-write-path model.  Writes: each row activation is extended by the
    write recovery tWR (the precharge closing the row must wait it out).
    Duplex: half the activations are writes (tWR/2 on average), and the
    modeled controller groups reads and writes inside each reorder window,
    paying one read->write plus one write->read bus turnaround per window.
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; valid: {OPS}")
    if op == "read":
        return 0.0, 0.0
    wr_cyc = spec.ns_to_cycles(spec.t_wr_ns)
    if op == "write":
        return 0.0, wr_cyc
    turnaround = spec.ns_to_cycles(spec.t_rtw_ns + spec.t_wtr_ns)
    return turnaround, 0.5 * wr_cyc


def _turnaround_between(spec: MemorySpec, prev_op: str, next_op: str) -> float:
    """Bus-turnaround cycles between two consecutive arbitration grants.

    A grant boundary between engines of the *same* direction costs nothing
    extra (the homogeneous model already prices intra-stream effects).  A
    boundary where the bus direction reverses pays the DRAM turnaround
    segments: tRTW when the earlier grant could end on a read and the
    later one starts with a write, tWTR for the write->read reversal.
    Duplex grants drive both directions, so they pay the reversal on both
    edges against a pure-read or pure-write neighbor and nothing against
    another duplex grant (the per-window duplex turnaround of
    `_direction_overheads` already covers intra-grant reversals).
    """
    if prev_op == next_op:
        return 0.0
    cost = 0.0
    if prev_op in ("read", "duplex") and next_op in ("write", "duplex"):
        cost += spec.ns_to_cycles(spec.t_rtw_ns)
    if prev_op in ("write", "duplex") and next_op in ("read", "duplex"):
        cost += spec.ns_to_cycles(spec.t_wtr_ns)
    return cost


@dataclasses.dataclass
class LatencyTrace:
    """Result of a serial-latency run."""

    cycles: np.ndarray          # per-transaction latency, AXI cycles (float)
    states: list                # per-transaction page state
    refresh_hits: np.ndarray    # bool: transaction stalled behind a refresh

    def ns(self, spec: MemorySpec) -> np.ndarray:
        return self.cycles * spec.cycle_ns


def _expand_addresses(p: RSTParams) -> np.ndarray:
    n = min(p.n, _MAX_EXPAND)
    i = np.arange(n, dtype=np.int64)
    return p.a + (i * p.s) % p.w


@functools.lru_cache(maxsize=32)
def _command_addresses(a: int, s: int, w: int, n: int, b: int,
                       bus_bytes: int) -> Tuple[np.ndarray, int]:
    """Expanded (read-only) column-command address stream + txns used.

    The stream depends only on the RST tuple and the bus width — NOT on the
    address-mapping policy — so one expansion serves every policy of an
    address-mapping sweep at equal (B, S, W).  Arrays are marked read-only;
    `decode` never mutates its input.
    """
    p = RSTParams(n=n, b=b, s=s, w=w, a=a)
    txn_addrs = _expand_addresses(p)
    cmds_per_txn = max(1, b // bus_bytes)
    # Bound total modeled commands: the stream is periodic, so a prefix is
    # representative; without this, multi-MB bursts explode the expansion.
    max_txns = max(16, _MAX_EXPAND // cmds_per_txn)
    if len(txn_addrs) > max_txns:
        txn_addrs = txn_addrs[:max_txns]
    offs = np.arange(cmds_per_txn, dtype=np.int64) * bus_bytes
    addrs = (txn_addrs[:, None] + offs[None, :]).reshape(-1)
    addrs.flags.writeable = False
    return addrs, len(txn_addrs)


def _prev_same_bank(bank: np.ndarray) -> np.ndarray:
    """Index of the previous transaction touching the same bank, -1 if none.

    Stable argsort groups the stream by bank while preserving issue order
    inside each group, so each group's predecessor is one shifted-array
    comparison away.
    """
    n = len(bank)
    prev = np.full(n, -1, dtype=np.int64)
    if n > 1:
        order = np.argsort(bank, kind="stable")
        sorted_bank = bank[order]
        same = sorted_bank[1:] == sorted_bank[:-1]
        prev[order[1:]] = np.where(same, order[:-1], -1)
    return prev


def _contended_latency_delay(base_cycles: np.ndarray, num_engines: int,
                             arbitration: str, burst_beats: int
                             ) -> np.ndarray:
    """Per-transaction queueing-delay addition (cycles) for a serial trace.

    The shift a contended capture list sees (DESIGN.md §9), built from the
    uncontended trace's own service times: under round robin every
    transaction waits out one mean service from each of the other N-1
    engines; under burst grants only each grant-head transaction pays the
    rotation — (N-1)·B·mean — while the B-1 beats riding its grant pay
    zero (same mean as round robin, bimodal distribution); under exclusive
    grants the whole capture rides one grant and the first transaction
    pays the engine-mean whole-stream wait, (N-1)/2 streams.

    The delay is a post-hoc shift on the issue path: the refresh schedule
    stays that of the engine's own service stream (each engine refreshes
    its windows independently of who holds the arbitration grant).
    """
    n = len(base_cycles)
    bb = _grant_beats(arbitration, burst_beats, n)
    delay = np.zeros(n, dtype=np.float64)
    if num_engines <= 1 or n == 0:
        return delay
    if arbitration == "exclusive":
        delay[0] = 0.5 * (num_engines - 1) * float(np.sum(base_cycles))
    else:
        mean_service = float(np.mean(base_cycles))
        delay[::bb] = (num_engines - 1) * bb * mean_service
    return delay


def _contended_latency_delay_mix(base_cycles: np.ndarray, mix: EngineMix,
                                 observed: Tuple[RSTParams, str],
                                 mapping: AddressMapping, spec: MemorySpec, *,
                                 switch_enabled: bool,
                                 switch_extra_cycles: int,
                                 arbitration: str, burst_beats: int
                                 ) -> np.ndarray:
    """Per-transaction queueing-delay addition for a *mixed* serial trace.

    The observed engine is the mix entry equal to ``observed`` (its first
    occurrence fixes the grant position).  Under round-robin/burst grants
    each grant-head transaction waits out one grant from every *other*
    engine — ``bb`` times the sum of their own mean service times, each
    taken from that engine's own uncontended serial trace (per-engine
    service times, not N-1 copies of one shared mean).  Under exclusive
    grants the whole capture rides one grant: the first transaction waits
    out the complete streams of the engines granted *before* it in entry
    order — the mix names the position, so no homogeneous engine-mean
    averaging applies.
    """
    n = len(base_cycles)
    bb = _grant_beats(arbitration, burst_beats, n)
    delay = np.zeros(n, dtype=np.float64)
    if len(mix) <= 1 or n == 0:
        return delay
    k0 = mix.entries.index(observed)
    if arbitration == "exclusive":
        total = 0.0
        for j, (p_j, op_j) in enumerate(mix.entries):
            if j >= k0:
                break
            t = serial_latencies(p_j, mapping, spec, op=op_j,
                                 switch_enabled=switch_enabled,
                                 switch_extra_cycles=switch_extra_cycles)
            total += float(np.sum(t.cycles))
        delay[0] = total
    else:
        total = 0.0
        for j, (p_j, op_j) in enumerate(mix.entries):
            if j == k0:
                continue
            t = serial_latencies(p_j, mapping, spec, op=op_j,
                                 switch_enabled=switch_enabled,
                                 switch_extra_cycles=switch_extra_cycles)
            total += float(np.mean(t.cycles))
        delay[::bb] = bb * total
    return delay


def serial_latencies(
    p: RSTParams,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    op: str = "read",
    switch_enabled: bool = False,
    switch_extra_cycles: int = 0,
    num_engines: int = 1,
    arbitration: str = "round_robin",
    burst_beats: int = 1,
    mix: Optional[EngineMix] = None,
) -> LatencyTrace:
    """Simulate N serial transactions and return per-transaction latencies.

    `op` selects the engine module: ``"read"`` (the paper's measured mode)
    or ``"write"``, where a page miss additionally pays the write-recovery
    segment tWR — the precharge the miss requires must wait out the
    previous write to that bank.  Page-hit and page-closed writes post at
    the read anchors (no precharge on their path).  ``"duplex"`` is
    rejected: serial mode never has a second in-flight transaction to turn
    the bus around for.

    `switch_extra_cycles` is the distance-dependent addition from
    core/switch.py (Table VI); `switch_enabled` alone adds the flat
    7-cycle penalty (paper footnote 9).

    `num_engines` > 1 produces a *contended* trace: the per-engine
    queueing delay of the shared port (DESIGN.md §9) is fed back into the
    per-transaction latencies via `_contended_latency_delay` — every
    transaction under round robin, grant heads only under burst grants (a
    bimodal distribution the contended classifier in core/latency.py
    separates), one up-front stream wait under exclusive grants.  Page
    states and refresh bookkeeping are those of the engine's own stream;
    ``num_engines=1`` is bit-identical to the uncontended trace under
    every policy.

    `mix` names a heterogeneous set of co-resident engines
    (DESIGN.md §13): ``(p, op)`` selects the *observed* engine and must
    be one of the mix entries; the queueing delay fed back into the
    trace sums the *other* entries' own per-engine service times
    (`_contended_latency_delay_mix`) instead of N-1 copies of one shared
    mean.  Every mix op must be serial-capable (read/write — duplex has
    no serial meaning), and a uniform mix normalizes to the homogeneous
    ``num_engines=len(mix)`` path bit-identically.

    Vectorized over refresh epochs: between two refreshes no bank is ever
    closed by the controller, so the page state of every transaction in the
    epoch is a pure function of its previous same-bank access — closed if
    that access predates the epoch (the refresh closed the bank), otherwise
    hit/miss by row comparison.  Each outer iteration therefore commits one
    whole epoch (~tREFI / page-hit-latency transactions) at once.
    """
    if op not in SERIAL_OPS:
        raise ValueError(
            f"serial latency measures one outstanding transaction; op must "
            f"be one of {SERIAL_OPS}, got {op!r}")
    if mix is not None:
        for _, op_k in mix.entries:
            if op_k not in SERIAL_OPS:
                raise ValueError(
                    f"serial latency measures one outstanding transaction; "
                    f"every mix op must be one of {SERIAL_OPS}, got {op_k!r}")
        if (p, op) not in mix.entries:
            raise ValueError(
                "serial_latencies(mix=...) observes the engine named by "
                "(p, op); that (params, op) pair must be one of the mix "
                "entries")
        num_engines = len(mix)
        if mix.uniform_entry() is not None:
            mix = None          # a uniform mix IS the homogeneous request
    if num_engines < 1:
        raise ValueError(f"num_engines must be >= 1, got {num_engines}")
    _grant_beats(arbitration, burst_beats, 1)   # validate the pair eagerly
    p.validate(spec)
    addrs = _expand_addresses(p)
    dec = mapping.decode(addrs)
    bank = np.asarray(mapping.bank_id_from(dec))
    row = np.asarray(dec["R"])
    n = len(addrs)

    base_extra = (spec.switch_penalty if switch_enabled else 0) + (
        switch_extra_cycles if switch_enabled else 0)

    prev_idx = _prev_same_bank(bank)
    rowmatch = np.zeros(n, dtype=bool)
    has_prev = np.nonzero(prev_idx >= 0)[0]
    rowmatch[has_prev] = row[has_prev] == row[prev_idx[has_prev]]

    # Write misses carry the write-recovery segment; hit/closed do not
    # precharge, so the read anchors apply unchanged (DESIGN.md §7).
    wr_extra = spec.ns_to_cycles(spec.t_wr_ns) if op == "write" else 0.0
    c_hit = float(spec.lat_page_hit + base_extra)
    c_closed = float(spec.lat_page_closed + base_extra)
    c_miss = float(spec.lat_page_miss + base_extra) + wr_extra
    # No epoch can span more transactions than tREFI / min-latency; slicing
    # to this cap keeps total work O(N) instead of O(N * epochs).
    epoch_cap = int(spec.t_refi_ns / spec.cycles_to_ns(spec.lat_page_hit)) + 2

    lat = np.zeros(n, dtype=np.float64)
    codes = np.zeros(n, dtype=np.int8)        # 0=hit, 1=closed, 2=miss
    refresh_hits = np.zeros(n, dtype=bool)

    pos = 0
    now_ns = 0.0
    next_refresh = spec.t_refi_ns
    while pos < n:
        # Refresh closes all banks; a transaction arriving during the
        # refresh cycle stalls until it completes (Sec. V-A).
        stall_ns = 0.0
        while now_ns >= next_refresh:
            refresh_end = next_refresh + spec.t_rfc_ns
            if now_ns < refresh_end:
                stall_ns = refresh_end - now_ns
                refresh_hits[pos] = True
            next_refresh += spec.t_refi_ns

        cap = epoch_cap
        while True:
            end = min(n, pos + cap)
            # Closed iff first same-bank access since the epoch's refresh.
            closed = prev_idx[pos:end] < pos
            cyc = np.where(closed, c_closed,
                           np.where(rowmatch[pos:end], c_hit, c_miss))
            cyc[0] += spec.ns_to_cycles(stall_ns)
            # Seeding the cumsum with now_ns reproduces the reference's
            # sequential `now += cycles_to_ns(c)` fold bit-for-bit — epoch
            # boundaries regularly land exactly on a refresh instant (all
            # times are integer cycles), so the >= below is rounding-critical.
            starts = np.cumsum(
                np.concatenate(([now_ns], cyc[:-1] * spec.cycle_ns)))
            crossed = np.nonzero(starts >= next_refresh)[0]
            if crossed.size or end == n:
                break
            cap *= 2  # stall pushed the epoch past the cap; widen and retry

        k = int(crossed[0]) if crossed.size else end - pos
        sl = slice(pos, pos + k)
        lat[sl] = cyc[:k]
        codes[sl] = np.where(closed[:k], 1, np.where(rowmatch[sl], 0, 2))
        if crossed.size:
            now_ns = float(starts[k])   # txn pos+k re-enters the refresh check
        pos += k

    if mix is not None:
        lat = lat + _contended_latency_delay_mix(
            lat, mix, (p, op), mapping, spec,
            switch_enabled=switch_enabled,
            switch_extra_cycles=switch_extra_cycles,
            arbitration=arbitration, burst_beats=burst_beats)
    elif num_engines > 1:
        lat = lat + _contended_latency_delay(lat, num_engines, arbitration,
                                             burst_beats)
    return LatencyTrace(cycles=lat, states=_STATE_NAMES[codes].tolist(),
                        refresh_hits=refresh_hits)


def serial_read_latencies(
    p: RSTParams,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    switch_enabled: bool = False,
    switch_extra_cycles: int = 0,
) -> LatencyTrace:
    """Read-module alias of :func:`serial_latencies` (the paper's measured
    latency mode)."""
    return serial_latencies(p, mapping, spec, op="read",
                            switch_enabled=switch_enabled,
                            switch_extra_cycles=switch_extra_cycles)


@dataclasses.dataclass(frozen=True)
class ThroughputResult:
    gbps: float
    bound: str                    # "bus/ccd" | "bank" | "faw"
    detail: Dict[str, float]

    def __repr__(self):
        return f"ThroughputResult({self.gbps:.2f} GB/s, bound={self.bound})"


def throughput(
    p: RSTParams,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    op: str = "read",
) -> ThroughputResult:
    """Steady-state achievable throughput of one engine on one channel.

    `op` is the traffic direction: ``"read"``, ``"write"``, or ``"duplex"``
    (the read and write modules running concurrently, Sec. III-C-1).  The
    command-issue machinery is shared — the write module saturates WA/WD
    the same way the read module saturates RA — but writes extend each row
    activation by the write recovery tWR, and duplex traffic additionally
    pays the read<->write bus turnaround (tRTW + tWTR) once per reorder
    window.  Sequential (bus-bound) streams therefore measure direction-
    symmetric while activation-heavy streams lose bandwidth on the write
    path, matching the write results of Choi et al. 2020 / Li et al. 2020.
    """
    turnaround_cyc, act_extra_cyc = _direction_overheads(spec, op)
    p.validate(spec)
    cmds_per_txn = max(1, p.b // spec.bus_bytes_per_cycle)
    # Expand bursts into column commands: a B-byte burst is B/bus_bytes
    # commands at consecutive bus-width offsets.  This matters: under the
    # default RGBCG policy the LSB mapped bit is a bank-group bit, so the
    # commands *within* one 64-byte burst already alternate bank groups —
    # the very reason the default policy sustains wire rate (Sec. V-D).
    # The stream is policy-independent, so the cached expansion is shared
    # across every mapping policy probed at equal (B, S, W) — the dominant
    # pattern of the fig6_address_mapping experiment.
    addrs, txns_used = _command_addresses(
        p.a, p.s, p.w, min(p.n, _MAX_EXPAND), p.b, spec.bus_bytes_per_cycle)
    n = len(addrs)
    dec = mapping.decode(addrs)
    bank = np.asarray(mapping.bank_id_from(dec))
    row = np.asarray(dec["R"])
    bg = np.asarray(dec["BG"])

    bounds, total_acts = _stream_bounds(spec, bank, row, bg,
                                        turnaround_cyc, act_extra_cyc)
    bound_name = max(bounds, key=bounds.get)
    steady_cycles = bounds[bound_name]

    eff = (1.0 - spec.t_rfc_ns / spec.t_refi_ns) * (1.0 - spec.sched_overhead)
    total_bytes = txns_used * p.b
    seconds = spec.cycles_to_ns(steady_cycles) * 1e-9
    gbps = total_bytes / seconds / 1e9 * eff if seconds > 0 else 0.0
    # A channel can never beat its wire rate.
    gbps = min(gbps, spec.peak_channel_gbps)

    return ThroughputResult(
        gbps=gbps,
        bound=bound_name,
        detail={**bounds, "txns": float(n), "cmds_per_txn": float(cmds_per_txn),
                "total_acts": float(total_acts), "efficiency": eff},
    )


def _stream_bounds(spec: MemorySpec, bank: np.ndarray, row: np.ndarray,
                   bg: np.ndarray, turnaround_cyc: float,
                   act_extra_cyc: float) -> Tuple[Dict[str, float], int]:
    """The three resource bounds of one decoded column-command stream.

    Shared by :func:`throughput` (one engine's stream) and
    :func:`contended_throughput` (N engines' streams round-robin
    multiplexed onto one shared port) — the scheduler model does not care
    who issued a command, only what it touches.  Returns
    ``({"bus/ccd", "bank", "faw"} -> cycles, total_activations)``.
    """
    n = len(bank)
    ccd_l_cyc = spec.ns_to_cycles(spec.t_ccd_l_ns)
    win = _REORDER_WINDOW
    nw_full, rem = divmod(n, win)

    # --- command-issue bound (data bus + bank-group tCCD_L) ----------------
    # Within a reorder-window chunk the scheduler interleaves commands from G
    # distinct bank groups, so the aggregate command rate is
    # min(1 cmd/cycle, G / tCCD_L).  Interleaving across bank-group *runs* is
    # only possible while two runs coexist in the reorder window, so G is
    # capped by window / (2 * mean run length): long single-BG runs (paper
    # Fig. 6b, RBC with small S) serialize at tCCD_L even though the full
    # stream eventually touches every group.  The per-window distinct-group
    # count is a segment reduction: sort each window row, count transitions.
    transitions = int(np.count_nonzero(bg[1:] != bg[:-1]))
    run_len = n / (transitions + 1)
    g_cap = max(1.0, _REORDER_WINDOW / (2.0 * run_len))
    issue_cycles = 0.0
    if nw_full:
        srt = np.sort(bg[:nw_full * win].reshape(nw_full, win), axis=1)
        uniq = 1 + np.count_nonzero(srt[:, 1:] != srt[:, :-1], axis=1)
        g = np.minimum(uniq.astype(np.float64), g_cap)
        issue_cycles += float(np.sum(win / np.minimum(1.0, g / ccd_l_cyc)))
    if rem:
        g = min(float(len(np.unique(bg[nw_full * win:]))), g_cap)
        issue_cycles += rem / min(1.0, g / ccd_l_cyc)
    # Duplex: one read->write plus one write->read turnaround per window.
    nw_total = nw_full + (1 if rem else 0)
    issue_cycles += turnaround_cyc * nw_total

    # --- bank bound (row activations serialize at tRC per bank) ------------
    # An activation happens whenever a bank is accessed with a different row
    # than its currently open one — i.e. whenever the previous same-bank
    # command (shifted-array comparison over the bank-grouped stream) used a
    # different row, or there is none.  Activations to *different* banks
    # overlap only while both live in the reorder window, so the bound is
    # computed per window: sum over windows of (max activations to any one
    # bank in that window) * tRC.  A stream that rotates banks slowly (runs
    # longer than the window) therefore serializes fully, as the real
    # controller does.  Per-(window, bank) counts come from one bincount.
    prev_idx = _prev_same_bank(bank)
    act = prev_idx < 0
    has_prev = np.nonzero(~act)[0]
    act[has_prev] = row[has_prev] != row[prev_idx[has_prev]]
    total_acts = int(np.count_nonzero(act))
    t_rc_cyc = spec.ns_to_cycles(spec.t_rc_ns)
    bank_cycles = 0.0
    if total_acts:
        act_idx = np.nonzero(act)[0]
        key = (act_idx // win) * spec.num_banks + bank[act_idx]
        counts = np.bincount(key, minlength=nw_total * spec.num_banks)
        per_window_max = counts.reshape(nw_total, spec.num_banks).max(axis=1)
        # Writes hold the row open tWR longer before the next activation's
        # precharge may start (duplex: half the activations are writes).
        bank_cycles = float(per_window_max.sum()) * (t_rc_cyc + act_extra_cyc)

    # --- four-activate-window bound ----------------------------------------
    faw_cycles = total_acts * spec.ns_to_cycles(spec.t_faw_ns) / 4.0

    bounds = {"bus/ccd": issue_cycles, "bank": bank_cycles, "faw": faw_cycles}
    return bounds, total_acts


# ---------------------------------------------------------------------------
# Multi-engine contention (N engines sharing one channel / mini-switch port)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ContentionResult:
    """N engines' streams multiplexed onto one shared channel port.

    `aggregate_gbps` is the shared port's total; `queueing_delay_cycles`
    is the *mean* arbitration wait one transaction spends behind the other
    N-1 engines (per-beat wait under round robin; the same mean
    concentrated onto grant heads under burst grants — the head's wait is
    `detail["grant_head_wait_cycles"]`; half the whole-stream rotation
    under exclusive grants).  `arbitration`/`burst_beats` record the
    granularity the result was computed under; `placement` records which
    fabric path the engines shared (``same_channel`` here — the
    cross-channel placements are built by `Engine.evaluate_contention`).

    `mix` records the heterogeneous engine mix the result was computed
    for, or ``None`` for the homogeneous N-identical-engines case — a
    uniform :class:`EngineMix` normalizes to ``None`` (DESIGN.md §13), so
    both spellings of the same workload produce equal results.
    """

    num_engines: int
    aggregate_gbps: float
    bound: str          # "bus/ccd" | "bank" | "faw" | "switch" | "lateral"
    queueing_delay_cycles: float
    detail: Dict[str, float]
    arbitration: str = "round_robin"
    burst_beats: int = 1
    placement: str = "same_channel"
    mix: Optional[EngineMix] = None

    @property
    def per_engine_gbps(self) -> float:
        """Bandwidth-share of one engine (fair round-robin arbitration)."""
        return self.aggregate_gbps / self.num_engines

    def __repr__(self):
        return (f"ContentionResult(N={self.num_engines}, "
                f"{self.aggregate_gbps:.2f} GB/s aggregate, "
                f"bound={self.bound}, arbitration={self.arbitration})")


def _contended_command_addresses(p: RSTParams, bus_bytes: int,
                                 num_engines: int, *,
                                 arbitration: str = "round_robin",
                                 burst_beats: int = 1
                                 ) -> Tuple[np.ndarray, int]:
    """Grant-interleaved column-command stream of N identical engines.

    Engine k traverses its own W-byte window at base ``A + k*W`` (disjoint
    windows, the Choi et al. 2020 multi-PE layout), and the shared port
    rotates grants of `_grant_beats` consecutive transactions per engine:
    one beat under round robin (t0e0, t0e1, ..., t1e0), `burst_beats`
    under burst grants (t0e0..t{B-1}e0, t0e1..), the whole stream under
    exclusive grants (engine-major).  A trailing partial grant round
    rotates the remainder the same way.  The total modeled command budget
    is the single-engine `_MAX_EXPAND` cap, split across engines, so
    contention analyses cost the same as single-engine ones.  For
    ``num_engines == 1`` every policy reduces exactly to
    `_command_addresses` — the read path is bit-identical.
    """
    txn = _expand_addresses(p)
    cmds_per_txn = max(1, p.b // bus_bytes)
    max_txns = max(16, (_MAX_EXPAND // cmds_per_txn) // num_engines)
    if len(txn) > max_txns:
        txn = txn[:max_txns]
    bb = _grant_beats(arbitration, burst_beats, len(txn))
    engine_offs = np.arange(num_engines, dtype=np.int64) * p.w
    # Full grant rounds: (round, engine, beat) flatten rotates bb-beat
    # grants across engines; bb=1 degenerates to the row-major (txn,
    # engine) round-robin flatten, element for element.
    nfull = (len(txn) // bb) * bb
    full = txn[:nfull].reshape(-1, bb)
    parts = [(full[:, None, :] + engine_offs[None, :, None]).reshape(-1)]
    if nfull < len(txn):
        rem = txn[nfull:]
        parts.append((engine_offs[:, None] + rem[None, :]).reshape(-1))
    inter = np.concatenate(parts) if len(parts) > 1 else parts[0]
    offs = np.arange(cmds_per_txn, dtype=np.int64) * bus_bytes
    addrs = (inter[:, None] + offs[None, :]).reshape(-1)
    return addrs, len(txn)


def _queueing_terms(arbitration: str, grant_beats: int, num_engines: int,
                    txns_per_engine: int, mean_service: float
                    ) -> Tuple[float, float]:
    """(mean queueing delay, grant-head wait) in cycles for one policy.

    Round robin: every transaction waits out one transaction from each of
    the other N-1 engines.  Burst grants concentrate the rotation onto the
    grant-head transaction — the head waits out the other engines' whole
    grants ((N-1)·B·service) while the B-1 beats riding its grant wait
    zero — so the mean keeps the (N-1)·service form, evaluated at the
    policy's *own* (usually much better) service time, while the
    distribution turns bimodal.  Exclusive grants pay one whole-stream
    rotation up front; engine k waits k streams, so the engine-mean is
    (N-1)/2 streams and the head (the last engine) waits N-1.
    """
    if arbitration == "exclusive":
        stream = txns_per_engine * mean_service
        return 0.5 * (num_engines - 1) * stream, (num_engines - 1) * stream
    head = (num_engines - 1) * grant_beats * mean_service
    return (num_engines - 1) * mean_service, head


def _contended_throughput_uniform(
    p: RSTParams,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    num_engines: int = 1,
    op: str = "read",
    arbitration: str = "round_robin",
    burst_beats: int = 1,
) -> ContentionResult:
    """Steady-state throughput of N *identical* engines on one port.

    The original homogeneous contention model, preserved verbatim so the
    uniform branch of :func:`contended_throughput_mix` — and therefore
    the :func:`contended_throughput` thin wrapper — stays bit-identical
    to the pre-mix path.

    Models the scenario family of Choi et al. 2020 / Zohouri & Matsuoka
    2019: several compute engines (PEs) multiplexed onto one HBM
    pseudo-channel through the mini-switch.  Each engine issues the same
    RST stream over its own W-byte window (base ``A + k*W``); the shared
    port rotates arbitration grants across engines, and the interleaved
    stream runs through the same three resource bounds as a single
    engine's (`_stream_bounds`) — interleaving is what creates the
    contention: engines share banks but occupy different rows, so row
    locality that survives one engine's stride is destroyed by its
    neighbors' interleaved activations, while short bank-group runs can
    actually *improve* bus utilization (the same effect as Fig. 6's
    policy interleaving).

    `arbitration` is the granularity of that rotation (DESIGN.md §9):

    * ``"round_robin"`` — one transaction per engine per round, the
      worst case (every beat lands between two other engines' row
      activations) and the policy PR 4 shipped;
    * ``"burst"`` — ``burst_beats`` consecutive transactions per grant,
      so row-buffer locality survives *inside* a grant and only the
      grant boundaries thrash — the knob real AXI interconnects expose;
    * ``"exclusive"`` — each engine's whole stream runs to completion,
      the serialized bound ``burst`` converges to as the grant grows
      (``burst_beats >= txns`` is bit-identical to it).

    Two sharing terms come out:

    * **bandwidth sharing** — ``aggregate_gbps`` is clamped at the shared
      port's wire rate; ``per_engine_gbps = aggregate / N`` under fair
      arbitration.
    * **queueing delay** — the mean arbitration wait of one transaction
      (see `_queueing_terms`), plus the grant-head wait in
      ``detail["grant_head_wait_cycles"]``: burst grants keep the mean of
      round robin but concentrate it onto grant heads.

    For ``num_engines == 1`` the result is bit-identical to
    :func:`throughput` (same stream, same bounds, same float ops) with a
    zero queueing term under every policy — pinned by the N=1 parity
    tests; ``arbitration="round_robin"`` is bit-identical to the
    pre-arbitration (PR 4) contended path.
    """
    if num_engines < 1:
        raise ValueError(f"num_engines must be >= 1, got {num_engines}")
    turnaround_cyc, act_extra_cyc = _direction_overheads(spec, op)
    p.validate(spec)
    cmds_per_txn = max(1, p.b // spec.bus_bytes_per_cycle)
    addrs, txns_per_engine = _contended_command_addresses(
        p, spec.bus_bytes_per_cycle, num_engines,
        arbitration=arbitration, burst_beats=burst_beats)
    bb = _grant_beats(arbitration, burst_beats, txns_per_engine)
    dec = mapping.decode(addrs)
    bank = np.asarray(mapping.bank_id_from(dec))
    row = np.asarray(dec["R"])
    bg = np.asarray(dec["BG"])

    bounds, total_acts = _stream_bounds(spec, bank, row, bg,
                                        turnaround_cyc, act_extra_cyc)
    bound_name = max(bounds, key=bounds.get)
    steady_cycles = bounds[bound_name]

    eff = (1.0 - spec.t_rfc_ns / spec.t_refi_ns) * (1.0 - spec.sched_overhead)
    total_txns = txns_per_engine * num_engines
    total_bytes = total_txns * p.b
    seconds = spec.cycles_to_ns(steady_cycles) * 1e-9
    gbps = total_bytes / seconds / 1e9 * eff if seconds > 0 else 0.0
    # The *shared port* can never beat its wire rate.
    gbps = min(gbps, spec.peak_channel_gbps)

    mean_service = steady_cycles / total_txns if total_txns else 0.0
    queueing, head_wait = _queueing_terms(
        arbitration, bb, num_engines, txns_per_engine, mean_service)

    return ContentionResult(
        num_engines=num_engines,
        aggregate_gbps=gbps,
        bound=bound_name,
        queueing_delay_cycles=queueing,
        detail={**bounds, "txns": float(len(bank)),
                "cmds_per_txn": float(cmds_per_txn),
                "txns_per_engine": float(txns_per_engine),
                "total_acts": float(total_acts),
                "mean_service_cycles": mean_service,
                "grant_head_wait_cycles": head_wait,
                "grant_beats": float(bb),
                "efficiency": eff},
        arbitration=arbitration,
        burst_beats=burst_beats,
    )


def contended_throughput(
    p: RSTParams,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    num_engines: int = 1,
    op: str = "read",
    arbitration: str = "round_robin",
    burst_beats: int = 1,
) -> ContentionResult:
    """Steady-state throughput of N *identical* engines sharing one port.

    The homogeneous spelling of :func:`contended_throughput_mix` — a
    thin wrapper building ``EngineMix.uniform(p, op, num_engines)`` and
    delegating, so the old ``num_engines: int`` contract and an
    all-identical mix are the *same request* by construction (DESIGN.md
    §13) and stay bit-identical under every arbitration policy.  The
    model itself (grant interleaving, the three resource bounds, the
    per-policy queueing terms) is documented on
    :func:`_contended_throughput_uniform`, whose result this returns
    unchanged; ``num_engines == 1`` stays bit-identical to
    :func:`throughput` with a zero queueing term under every policy.
    """
    if num_engines < 1:
        raise ValueError(f"num_engines must be >= 1, got {num_engines}")
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; valid: {OPS}")
    return contended_throughput_mix(
        EngineMix.uniform(p, op, num_engines), mapping, spec,
        arbitration=arbitration, burst_beats=burst_beats)


def contended_throughput_mix(
    mix: EngineMix,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    arbitration: str = "round_robin",
    burst_beats: int = 1,
) -> ContentionResult:
    """Steady-state throughput of a heterogeneous engine mix on one port.

    The general contention entry point (DESIGN.md §13): `mix` is an
    ordered tuple of per-engine ``(params, op)`` entries — readers,
    writers, and duplex streams with their own RST tuples — multiplexed
    onto one shared channel port in entry (grant) order.  This is the
    workload regime of Choi et al. 2020 (mixed-direction multi-PE
    designs swinging 30%→90% of nominal) that the homogeneous
    N-identical-engines model cannot name.

    A *uniform* mix (every entry identical) normalizes to the
    homogeneous path and returns its result bit-identically, with
    ``mix=None`` on the result — ``contended_throughput(num_engines=N)``
    and ``EngineMix.uniform(p, op, N)`` are indistinguishable down to
    the float ops and the memo keys built from them.  A genuinely mixed
    mix runs the grant-interleaved per-command model
    (:func:`_contended_throughput_mixed`): per-engine service times,
    per-command direction overheads, and op-aware bus-reversal segments
    at grant boundaries between engines of different directions.  The
    loop oracle `_timing_reference.contended_throughput_mix` pins every
    float of the mixed path at 1e-9.
    """
    uni = mix.uniform_entry()
    if uni is not None:
        return _contended_throughput_uniform(
            uni[0], mapping, spec, num_engines=len(mix), op=uni[1],
            arbitration=arbitration, burst_beats=burst_beats)
    return _contended_throughput_mixed(
        mix, mapping, spec, arbitration=arbitration, burst_beats=burst_beats)


def _mixed_grant_schedule(counts: List[int], bb: int, arbitration: str
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(engine, txn-within-engine, grant-engine-sequence) of a mixed rotation.

    Grant order is entry order.  Round-robin/burst rotate grants of at
    most ``bb`` transactions across the engines that still have
    transactions left (an exhausted engine drops out of the rotation, as
    a real arbiter's request lines deassert); exclusive concatenates
    whole streams engine-major.  For equal counts this reproduces the
    homogeneous `_contended_command_addresses` order element for element:
    full ``bb``-beat rounds, then the engine-major remainder.
    """
    n_eng = len(counts)
    if arbitration == "exclusive":
        order_eng = np.repeat(np.arange(n_eng, dtype=np.int64),
                              np.asarray(counts, dtype=np.int64))
        order_txn = np.concatenate(
            [np.arange(c, dtype=np.int64) for c in counts])
        grants = np.array([k for k in range(n_eng) if counts[k] > 0],
                          dtype=np.int64)
        return order_eng, order_txn, grants
    eng_l: List[int] = []
    txn_l: List[int] = []
    grant_l: List[int] = []
    pos = [0] * n_eng
    active = True
    while active:
        active = False
        for k in range(n_eng):
            take = min(bb, counts[k] - pos[k])
            if take <= 0:
                continue
            active = True
            eng_l.extend([k] * take)
            txn_l.extend(range(pos[k], pos[k] + take))
            grant_l.append(k)
            pos[k] += take
    return (np.asarray(eng_l, dtype=np.int64),
            np.asarray(txn_l, dtype=np.int64),
            np.asarray(grant_l, dtype=np.int64))


def _stream_bounds_mixed(spec: MemorySpec, bank: np.ndarray, row: np.ndarray,
                         bg: np.ndarray, turn_cmd: np.ndarray,
                         extra_cmd: np.ndarray, op_switch_cycles: float
                         ) -> Tuple[Dict[str, float], int]:
    """Per-command generalization of `_stream_bounds` for mixed streams.

    Same three bounds, but the direction overheads are per-*command*
    arrays (each command carries its issuing engine's op): each reorder
    window pays the window-*mean* duplex turnaround, each row activation
    extends tRC by the activating engine's own write-recovery term
    (weighted bincount instead of count * constant), and the issue bound
    carries the grant-boundary bus-reversal segments accumulated by the
    caller.  With uniform per-command arrays every term reduces to the
    homogeneous formula (the mean is the constant; the weighted per-bank
    max is the count max times the constant weight).
    """
    n = len(bank)
    ccd_l_cyc = spec.ns_to_cycles(spec.t_ccd_l_ns)
    win = _REORDER_WINDOW
    nw_full, rem = divmod(n, win)

    transitions = int(np.count_nonzero(bg[1:] != bg[:-1]))
    run_len = n / (transitions + 1)
    g_cap = max(1.0, _REORDER_WINDOW / (2.0 * run_len))
    issue_cycles = 0.0
    if nw_full:
        srt = np.sort(bg[:nw_full * win].reshape(nw_full, win), axis=1)
        uniq = 1 + np.count_nonzero(srt[:, 1:] != srt[:, :-1], axis=1)
        g = np.minimum(uniq.astype(np.float64), g_cap)
        issue_cycles += float(np.sum(win / np.minimum(1.0, g / ccd_l_cyc)))
        issue_cycles += float(np.sum(
            turn_cmd[:nw_full * win].reshape(nw_full, win).mean(axis=1)))
    if rem:
        g = min(float(len(np.unique(bg[nw_full * win:]))), g_cap)
        issue_cycles += rem / min(1.0, g / ccd_l_cyc)
        issue_cycles += float(np.mean(turn_cmd[nw_full * win:]))
    issue_cycles += op_switch_cycles
    nw_total = nw_full + (1 if rem else 0)

    prev_idx = _prev_same_bank(bank)
    act = prev_idx < 0
    has_prev = np.nonzero(~act)[0]
    act[has_prev] = row[has_prev] != row[prev_idx[has_prev]]
    total_acts = int(np.count_nonzero(act))
    t_rc_cyc = spec.ns_to_cycles(spec.t_rc_ns)
    bank_cycles = 0.0
    if total_acts:
        act_idx = np.nonzero(act)[0]
        key = (act_idx // win) * spec.num_banks + bank[act_idx]
        weights = t_rc_cyc + extra_cmd[act_idx]
        sums = np.bincount(key, weights=weights,
                           minlength=nw_total * spec.num_banks)
        bank_cycles = float(
            sums.reshape(nw_total, spec.num_banks).max(axis=1).sum())

    faw_cycles = total_acts * spec.ns_to_cycles(spec.t_faw_ns) / 4.0
    bounds = {"bus/ccd": issue_cycles, "bank": bank_cycles, "faw": faw_cycles}
    return bounds, total_acts


def _contended_throughput_mixed(
    mix: EngineMix,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    arbitration: str = "round_robin",
    burst_beats: int = 1,
) -> ContentionResult:
    """Grant-interleaved contention model of a genuinely mixed engine set.

    Engine k issues its own RST stream over its own disjoint window —
    the window base is offset by ``sum(w_j for j < k)``, the
    heterogeneous analog of the homogeneous ``A + k*W`` layout — and the
    shared port rotates `_grant_beats`-sized grants in entry order
    (`_mixed_grant_schedule`).  The interleaved per-command stream runs
    through the per-command resource bounds (`_stream_bounds_mixed`),
    and every grant boundary between engines of different directions
    pays the bus-reversal segments (`_turnaround_between`).  Queueing
    terms generalize the homogeneous ones engine by engine: a
    transaction's arbitration wait sums the *other* engines' own
    per-grant service times instead of N-1 copies of one shared mean,
    and the steady-state cycles split across engines in proportion to
    their command-stream share.
    """
    mix.validate(spec)
    n_eng = len(mix)
    bus = spec.bus_bytes_per_cycle
    over = [_direction_overheads(spec, op_k) for _, op_k in mix.entries]
    turn_e = np.array([t for t, _ in over], dtype=np.float64)
    extra_e = np.array([x for _, x in over], dtype=np.float64)
    cmds_e = np.array([max(1, p_k.b // bus) for p_k, _ in mix.entries],
                      dtype=np.int64)
    # Shared command budget: the single-engine _MAX_EXPAND cap split
    # across engines at the widest per-transaction command count,
    # mirroring the homogeneous budget rule.
    max_txns = max(16, (_MAX_EXPAND // int(cmds_e.max())) // n_eng)
    streams = []
    for p_k, _ in mix.entries:
        t = _expand_addresses(p_k)
        streams.append(t[:max_txns] if len(t) > max_txns else t)
    counts = [len(t) for t in streams]
    bb = _grant_beats(arbitration, burst_beats, max(counts))
    order_eng, order_txn, grants = _mixed_grant_schedule(
        counts, bb, arbitration)

    # Absolute per-transaction addresses: engine k's own stream (which
    # already carries its A) plus its cumulative window offset, gathered
    # in grant order.
    w_offs = np.concatenate(([0], np.cumsum(
        np.array([p_k.w for p_k, _ in mix.entries], dtype=np.int64))))[:-1]
    flat = np.concatenate([streams[k] + w_offs[k] for k in range(n_eng)])
    starts = np.concatenate(
        ([0], np.cumsum(np.asarray(counts, dtype=np.int64))))[:-1]
    txn_addr = flat[starts[order_eng] + order_txn]

    # Ragged command expansion: each transaction carries its own engine's
    # B/bus_bytes column commands at consecutive bus-width offsets.
    slot_cmds = cmds_e[order_eng]
    total_cmds = int(slot_cmds.sum())
    slot_of = np.repeat(np.arange(len(order_eng), dtype=np.int64), slot_cmds)
    first_cmd = np.cumsum(slot_cmds) - slot_cmds
    within = np.arange(total_cmds, dtype=np.int64) - first_cmd[slot_of]
    addrs = txn_addr[slot_of] + within * bus
    eng_cmd = order_eng[slot_of]

    dec = mapping.decode(addrs)
    bank = np.asarray(mapping.bank_id_from(dec))
    row = np.asarray(dec["R"])
    bg = np.asarray(dec["BG"])

    # Bus-reversal segments at grant boundaries between different ops:
    # an (engine, engine) cost table gathered along the grant sequence.
    pair_cost = np.array(
        [[_turnaround_between(spec, oi, oj) for oj in mix.ops]
         for oi in mix.ops], dtype=np.float64)
    op_switch = (float(pair_cost[grants[:-1], grants[1:]].sum())
                 if len(grants) > 1 else 0.0)

    bounds, total_acts = _stream_bounds_mixed(
        spec, bank, row, bg, turn_e[eng_cmd], extra_e[eng_cmd], op_switch)
    bound_name = max(bounds, key=bounds.get)
    steady_cycles = bounds[bound_name]

    eff = (1.0 - spec.t_rfc_ns / spec.t_refi_ns) * (1.0 - spec.sched_overhead)
    total_txns = int(sum(counts))
    total_bytes = int(sum(
        c * p_k.b for c, (p_k, _) in zip(counts, mix.entries)))
    seconds = spec.cycles_to_ns(steady_cycles) * 1e-9
    gbps = total_bytes / seconds / 1e9 * eff if seconds > 0 else 0.0
    # The *shared port* can never beat its wire rate.
    gbps = min(gbps, spec.peak_channel_gbps)

    mean_service = steady_cycles / total_txns if total_txns else 0.0
    # Per-engine per-transaction service: the steady-state cycles split
    # in proportion to each engine's share of the command stream.
    mean_e = (steady_cycles * cmds_e.astype(np.float64) / total_cmds
              if total_cmds else np.zeros(n_eng, dtype=np.float64))
    counts_f = np.asarray(counts, dtype=np.float64)
    if arbitration == "exclusive":
        stream_e = counts_f * mean_e
        waits = np.concatenate(([0.0], np.cumsum(stream_e)[:-1]))
        queueing = float(np.mean(waits))
        head_wait = float(waits[-1])
    else:
        rot_e = float(mean_e.sum()) - mean_e   # sum_{j != k} mean_j
        queueing = float(np.mean(rot_e))
        head_wait = float(bb * rot_e.max())

    return ContentionResult(
        num_engines=n_eng,
        aggregate_gbps=gbps,
        bound=bound_name,
        queueing_delay_cycles=queueing,
        detail={**bounds, "txns": float(len(bank)),
                "cmds_per_txn": total_cmds / total_txns if total_txns else 0.0,
                "txns_per_engine": total_txns / n_eng,
                "total_acts": float(total_acts),
                "mean_service_cycles": mean_service,
                "grant_head_wait_cycles": head_wait,
                "grant_beats": float(bb),
                "op_switch_cycles": op_switch,
                "mix_size": float(n_eng),
                "efficiency": eff},
        arbitration=arbitration,
        burst_beats=burst_beats,
        mix=mix,
    )


def refresh_interval_estimate(trace: LatencyTrace, spec: MemorySpec) -> float:
    """Estimate tREFI (ns) from latency spikes, as the paper does in V-A."""
    lat = trace.cycles
    thresh = np.median(lat) + 10.0
    spike_idx = np.nonzero(lat > thresh)[0]
    if len(spike_idx) < 2:
        return math.nan
    # Time of each spike = cumulative latency up to it.
    t = np.cumsum(spec.cycles_to_ns(lat))
    spike_times = t[spike_idx]
    return float(np.mean(np.diff(spike_times)))
