"""Pre-vectorization reference implementation of the DRAM timing model.

This is the original per-transaction Python-loop model, kept verbatim as the
golden oracle for the vectorized implementation in
:mod:`repro_torch.core.timing_model`.  The parity tests
(tests/core/test_timing_parity.py) assert that the vectorized model matches
these loops transaction-for-transaction across the hit/closed/miss, refresh,
and bank-group-run regimes on both HBM and DDR4.

The write path extends the loops the same way it extends the vectorized
model (one extra term per site, DESIGN.md §7): `serial_write_latencies`
adds the write-recovery segment to the page-miss branch, and `throughput`
takes the direction overheads (per-window turnaround, per-activation tWR)
from the shared `_direction_overheads` table and applies them inside the
per-window loops.

The arbitration axis (DESIGN.md §9) extends `contended_throughput` the
same way: the grant-interleaved stream is built with explicit per-grant /
per-engine / per-beat Python loops (grant size from the shared
`_grant_beats` table: 1 for round robin, `burst_beats` for burst grants,
the whole stream for exclusive), and `serial_contended_latencies` applies
the per-transaction queueing-delay feedback with an explicit per-
transaction loop.

Do not optimize this module: its value is being slow and obviously correct.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.address_mapping import AddressMapping
from repro_torch.core.engine_mix import EngineMix
from repro_torch.core.hwspec import MemorySpec
from repro_torch.core.params import RSTParams
from repro_torch.core.timing_model import (_MAX_EXPAND, _REORDER_WINDOW,
                                     PAGE_CLOSED, PAGE_HIT, PAGE_MISS,
                                     ContentionResult, LatencyTrace,
                                     ThroughputResult, _direction_overheads,
                                     _expand_addresses, _grant_beats,
                                     _turnaround_between)


def serial_read_latencies(
    p: RSTParams,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    switch_enabled: bool = False,
    switch_extra_cycles: int = 0,
) -> LatencyTrace:
    """Reference serial-latency loop: one transaction per Python iteration."""
    p.validate(spec)
    addrs = _expand_addresses(p)
    dec = mapping.decode(addrs)
    bank = np.asarray(mapping.bank_id(addrs))
    row = dec["R"]

    base_extra = (spec.switch_penalty if switch_enabled else 0) + (
        switch_extra_cycles if switch_enabled else 0)

    open_row: Dict[int, int] = {}
    now_ns = 0.0
    next_refresh = spec.t_refi_ns
    lat = np.zeros(len(addrs), dtype=np.float64)
    states = []
    refresh_hits = np.zeros(len(addrs), dtype=bool)

    for i in range(len(addrs)):
        stall_ns = 0.0
        # Refresh closes all banks; a transaction arriving during the
        # refresh cycle stalls until it completes (Sec. V-A).
        while now_ns >= next_refresh:
            open_row.clear()
            refresh_end = next_refresh + spec.t_rfc_ns
            if now_ns < refresh_end:
                stall_ns = refresh_end - now_ns
                refresh_hits[i] = True
            next_refresh += spec.t_refi_ns

        b, r = int(bank[i]), int(row[i])
        if b in open_row and open_row[b] == r:
            state, cyc = PAGE_HIT, spec.lat_page_hit
        elif b not in open_row:
            state, cyc = PAGE_CLOSED, spec.lat_page_closed
        else:
            state, cyc = PAGE_MISS, spec.lat_page_miss
        open_row[b] = r

        total_cycles = cyc + base_extra + spec.ns_to_cycles(stall_ns)
        lat[i] = total_cycles
        states.append(state)
        now_ns += spec.cycles_to_ns(total_cycles)

    return LatencyTrace(cycles=lat, states=states, refresh_hits=refresh_hits)


def serial_write_latencies(
    p: RSTParams,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    switch_enabled: bool = False,
    switch_extra_cycles: int = 0,
) -> LatencyTrace:
    """Reference serial-write loop: the read loop plus the write-recovery
    segment on the page-miss branch (a miss precharges, and the precharge
    must wait out the previous write to that bank)."""
    p.validate(spec)
    addrs = _expand_addresses(p)
    dec = mapping.decode(addrs)
    bank = np.asarray(mapping.bank_id(addrs))
    row = dec["R"]

    base_extra = (spec.switch_penalty if switch_enabled else 0) + (
        switch_extra_cycles if switch_enabled else 0)
    wr_cycles = spec.ns_to_cycles(spec.t_wr_ns)

    open_row: Dict[int, int] = {}
    now_ns = 0.0
    next_refresh = spec.t_refi_ns
    lat = np.zeros(len(addrs), dtype=np.float64)
    states = []
    refresh_hits = np.zeros(len(addrs), dtype=bool)

    for i in range(len(addrs)):
        stall_ns = 0.0
        while now_ns >= next_refresh:
            open_row.clear()
            refresh_end = next_refresh + spec.t_rfc_ns
            if now_ns < refresh_end:
                stall_ns = refresh_end - now_ns
                refresh_hits[i] = True
            next_refresh += spec.t_refi_ns

        b, r = int(bank[i]), int(row[i])
        if b in open_row and open_row[b] == r:
            state, cyc = PAGE_HIT, spec.lat_page_hit
        elif b not in open_row:
            state, cyc = PAGE_CLOSED, spec.lat_page_closed
        else:
            state, cyc = PAGE_MISS, spec.lat_page_miss
        open_row[b] = r

        # Float-op ordering mirrors the vectorized model exactly:
        # (integer anchor + switch extra) first, then the tWR segment,
        # then the refresh stall — the parity tests are bit-exact.
        recovery = wr_cycles if state == PAGE_MISS else 0.0
        total_cycles = (float(cyc + base_extra) + recovery
                        + spec.ns_to_cycles(stall_ns))
        lat[i] = total_cycles
        states.append(state)
        now_ns += spec.cycles_to_ns(total_cycles)

    return LatencyTrace(cycles=lat, states=states, refresh_hits=refresh_hits)


def throughput(
    p: RSTParams,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    op: str = "read",
) -> ThroughputResult:
    """Reference throughput model: per-window dict loops.

    Direction-aware like the vectorized model: per-window bus turnaround
    for duplex, per-activation write recovery for write/duplex, zeros for
    read (so read parity also pins the original pre-write-path loops).
    """
    turnaround_cyc, act_extra_cyc = _direction_overheads(spec, op)
    p.validate(spec)
    txn_addrs = _expand_addresses(p)
    cmds_per_txn = max(1, p.b // spec.bus_bytes_per_cycle)
    max_txns = max(16, _MAX_EXPAND // cmds_per_txn)
    if len(txn_addrs) > max_txns:
        txn_addrs = txn_addrs[:max_txns]
    offs = np.arange(cmds_per_txn, dtype=np.int64) * spec.bus_bytes_per_cycle
    addrs = (txn_addrs[:, None] + offs[None, :]).reshape(-1)
    n = len(addrs)
    dec = mapping.decode(addrs)
    bank = np.asarray(mapping.bank_id(addrs))
    row = np.asarray(dec["R"])
    bg = np.asarray(dec["BG"])

    ccd_l_cyc = spec.ns_to_cycles(spec.t_ccd_l_ns)

    # --- command-issue bound (data bus + bank-group tCCD_L) ----------------
    transitions = int(np.count_nonzero(bg[1:] != bg[:-1]))
    run_len = n / (transitions + 1)
    g_cap = max(1.0, _REORDER_WINDOW / (2.0 * run_len))
    issue_cycles = 0.0
    num_windows = 0
    for lo in range(0, n, _REORDER_WINDOW):
        chunk_bg = bg[lo:lo + _REORDER_WINDOW]
        g = min(float(len(np.unique(chunk_bg))), g_cap)
        rate = min(1.0, g / ccd_l_cyc)           # commands per cycle
        issue_cycles += len(chunk_bg) / rate
        num_windows += 1
    issue_cycles += turnaround_cyc * num_windows

    # --- bank bound (row activations serialize at tRC per bank) ------------
    open_row: Dict[int, int] = {}
    total_acts = 0
    t_rc_cyc = spec.ns_to_cycles(spec.t_rc_ns)
    bank_cycles = 0.0
    for lo in range(0, n, _REORDER_WINDOW):
        acts_in_window: Dict[int, int] = {}
        for i in range(lo, min(lo + _REORDER_WINDOW, n)):
            b_, r_ = int(bank[i]), int(row[i])
            if open_row.get(b_) != r_:
                acts_in_window[b_] = acts_in_window.get(b_, 0) + 1
                open_row[b_] = r_
                total_acts += 1
        if acts_in_window:
            bank_cycles += max(acts_in_window.values()) * (t_rc_cyc
                                                           + act_extra_cyc)

    # --- four-activate-window bound ----------------------------------------
    faw_cycles = total_acts * spec.ns_to_cycles(spec.t_faw_ns) / 4.0

    bounds = {"bus/ccd": issue_cycles, "bank": bank_cycles, "faw": faw_cycles}
    bound_name = max(bounds, key=bounds.get)
    steady_cycles = bounds[bound_name]

    eff = (1.0 - spec.t_rfc_ns / spec.t_refi_ns) * (1.0 - spec.sched_overhead)
    total_bytes = len(txn_addrs) * p.b
    seconds = spec.cycles_to_ns(steady_cycles) * 1e-9
    gbps = total_bytes / seconds / 1e9 * eff if seconds > 0 else 0.0
    gbps = min(gbps, spec.peak_channel_gbps)

    return ThroughputResult(
        gbps=gbps,
        bound=bound_name,
        detail={**bounds, "txns": float(n), "cmds_per_txn": float(cmds_per_txn),
                "total_acts": float(total_acts), "efficiency": eff},
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
    """Reference contention model: explicit per-grant/per-engine loops.

    Builds the grant-interleaved command stream one transaction at a time
    — grant round by grant round, each engine issuing its grant's beats
    consecutively over its own W-byte window at A + k*W (round robin is
    the one-beat grant, exclusive the whole-stream grant) — then replays
    the per-window dict loops of :func:`throughput` over the shared
    stream.  The vectorized `timing_model.contended_throughput` must
    match this to float-associativity tolerance at every (policy,
    burst_beats, N), and must be bit-identical to the single-engine read
    path when num_engines == 1.
    """
    if num_engines < 1:
        raise ValueError(f"num_engines must be >= 1, got {num_engines}")
    turnaround_cyc, act_extra_cyc = _direction_overheads(spec, op)
    p.validate(spec)
    txn = _expand_addresses(p)
    cmds_per_txn = max(1, p.b // spec.bus_bytes_per_cycle)
    max_txns = max(16, (_MAX_EXPAND // cmds_per_txn) // num_engines)
    if len(txn) > max_txns:
        txn = txn[:max_txns]
    bb = _grant_beats(arbitration, burst_beats, len(txn))
    addr_list = []
    pos = 0
    while pos < len(txn):                     # one arbitration grant round
        hi = min(pos + bb, len(txn))
        for k in range(num_engines):          # rotate the grant over engines
            for t in range(pos, hi):          # bb consecutive beats
                base = int(txn[t]) + k * p.w
                for c in range(cmds_per_txn):  # burst -> column commands
                    addr_list.append(base + c * spec.bus_bytes_per_cycle)
        pos = hi
    addrs = np.asarray(addr_list, dtype=np.int64)
    n = len(addrs)
    dec = mapping.decode(addrs)
    bank = np.asarray(mapping.bank_id(addrs))
    row = np.asarray(dec["R"])
    bg = np.asarray(dec["BG"])

    ccd_l_cyc = spec.ns_to_cycles(spec.t_ccd_l_ns)

    # --- command-issue bound (data bus + bank-group tCCD_L) ----------------
    transitions = int(np.count_nonzero(bg[1:] != bg[:-1]))
    run_len = n / (transitions + 1)
    g_cap = max(1.0, _REORDER_WINDOW / (2.0 * run_len))
    issue_cycles = 0.0
    num_windows = 0
    for lo in range(0, n, _REORDER_WINDOW):
        chunk_bg = bg[lo:lo + _REORDER_WINDOW]
        g = min(float(len(np.unique(chunk_bg))), g_cap)
        rate = min(1.0, g / ccd_l_cyc)           # commands per cycle
        issue_cycles += len(chunk_bg) / rate
        num_windows += 1
    issue_cycles += turnaround_cyc * num_windows

    # --- bank bound (row activations serialize at tRC per bank) ------------
    open_row: Dict[int, int] = {}
    total_acts = 0
    t_rc_cyc = spec.ns_to_cycles(spec.t_rc_ns)
    bank_cycles = 0.0
    for lo in range(0, n, _REORDER_WINDOW):
        acts_in_window: Dict[int, int] = {}
        for i in range(lo, min(lo + _REORDER_WINDOW, n)):
            b_, r_ = int(bank[i]), int(row[i])
            if open_row.get(b_) != r_:
                acts_in_window[b_] = acts_in_window.get(b_, 0) + 1
                open_row[b_] = r_
                total_acts += 1
        if acts_in_window:
            bank_cycles += max(acts_in_window.values()) * (t_rc_cyc
                                                           + act_extra_cyc)

    # --- four-activate-window bound ----------------------------------------
    faw_cycles = total_acts * spec.ns_to_cycles(spec.t_faw_ns) / 4.0

    bounds = {"bus/ccd": issue_cycles, "bank": bank_cycles, "faw": faw_cycles}
    bound_name = max(bounds, key=bounds.get)
    steady_cycles = bounds[bound_name]

    eff = (1.0 - spec.t_rfc_ns / spec.t_refi_ns) * (1.0 - spec.sched_overhead)
    total_txns = len(txn) * num_engines
    total_bytes = total_txns * p.b
    seconds = spec.cycles_to_ns(steady_cycles) * 1e-9
    gbps = total_bytes / seconds / 1e9 * eff if seconds > 0 else 0.0
    gbps = min(gbps, spec.peak_channel_gbps)

    mean_service = steady_cycles / total_txns if total_txns else 0.0
    # Per-policy queueing, spelled out (mirrors timing_model._queueing_terms):
    # round robin / burst share the per-rotation mean, burst concentrates it
    # onto grant heads; exclusive pays half the whole-stream rotation.
    if arbitration == "exclusive":
        stream = len(txn) * mean_service
        queueing = 0.5 * (num_engines - 1) * stream
        head_wait = (num_engines - 1) * stream
    else:
        queueing = (num_engines - 1) * mean_service
        head_wait = (num_engines - 1) * bb * mean_service

    return ContentionResult(
        num_engines=num_engines,
        aggregate_gbps=gbps,
        bound=bound_name,
        queueing_delay_cycles=queueing,
        detail={**bounds, "txns": float(n),
                "cmds_per_txn": float(cmds_per_txn),
                "txns_per_engine": float(len(txn)),
                "total_acts": float(total_acts),
                "mean_service_cycles": mean_service,
                "grant_head_wait_cycles": head_wait,
                "grant_beats": float(bb),
                "efficiency": eff},
        arbitration=arbitration,
        burst_beats=burst_beats,
    )


def contended_throughput_mix(
    mix: EngineMix,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    arbitration: str = "round_robin",
    burst_beats: int = 1,
) -> ContentionResult:
    """Reference mixed-engine contention model: per-grant/per-beat loops.

    The heterogeneous analog of :func:`contended_throughput`: engine k
    issues its own RST stream over its own window (base offset
    ``sum(w_j for j < k)``), grants rotate in entry order with exhausted
    engines dropping out, each command carries its issuing engine's own
    direction overheads (window-mean turnaround, per-activation write
    recovery), and every grant boundary between engines of different
    directions pays the bus-reversal segments (`_turnaround_between`).
    A uniform mix delegates to the homogeneous reference loop —
    bit-identical by construction — and the vectorized
    `timing_model.contended_throughput_mix` must match this at every
    (policy, burst_beats, mix) to float-associativity tolerance.
    """
    uni = mix.uniform_entry()
    if uni is not None:
        return contended_throughput(
            uni[0], mapping, spec, num_engines=len(mix), op=uni[1],
            arbitration=arbitration, burst_beats=burst_beats)
    mix.validate(spec)
    n_eng = len(mix)
    bus = spec.bus_bytes_per_cycle

    # Per-engine scalars: direction overheads, commands per transaction,
    # window base offsets, truncated streams under the shared budget.
    turn_e, extra_e, cmds_e, w_off, streams = [], [], [], [], []
    off = 0
    max_cmds = max(max(1, p_k.b // bus) for p_k, _ in mix.entries)
    max_txns = max(16, (_MAX_EXPAND // max_cmds) // n_eng)
    for p_k, op_k in mix.entries:
        t_cyc, x_cyc = _direction_overheads(spec, op_k)
        turn_e.append(t_cyc)
        extra_e.append(x_cyc)
        cmds_e.append(max(1, p_k.b // bus))
        w_off.append(off)
        off += p_k.w
        txn = _expand_addresses(p_k)
        if len(txn) > max_txns:
            txn = txn[:max_txns]
        streams.append(txn)
    counts = [len(t) for t in streams]
    bb = _grant_beats(arbitration, burst_beats, max(counts))

    # Grant-interleaved command stream, one grant at a time.  Each
    # command remembers its engine's per-window turnaround share and
    # per-activation extra; grant_ops records the boundary sequence.
    addr_list, turn_list, extra_list, grant_ops = [], [], [], []
    if arbitration == "exclusive":
        for k in range(n_eng):
            if counts[k] == 0:
                continue
            grant_ops.append(mix.entries[k][1])
            for t in range(counts[k]):
                base = int(streams[k][t]) + w_off[k]
                for c in range(cmds_e[k]):
                    addr_list.append(base + c * bus)
                    turn_list.append(turn_e[k])
                    extra_list.append(extra_e[k])
    else:
        pos = [0] * n_eng
        active = True
        while active:                         # one arbitration grant round
            active = False
            for k in range(n_eng):            # rotate grants in entry order
                take = min(bb, counts[k] - pos[k])
                if take <= 0:
                    continue
                active = True
                grant_ops.append(mix.entries[k][1])
                for t in range(pos[k], pos[k] + take):
                    base = int(streams[k][t]) + w_off[k]
                    for c in range(cmds_e[k]):
                        addr_list.append(base + c * bus)
                        turn_list.append(turn_e[k])
                        extra_list.append(extra_e[k])
                pos[k] += take
    addrs = np.asarray(addr_list, dtype=np.int64)
    n = len(addrs)
    bank = np.asarray(mapping.bank_id(addrs))
    dec = mapping.decode(addrs)
    row = np.asarray(dec["R"])
    bg = np.asarray(dec["BG"])

    ccd_l_cyc = spec.ns_to_cycles(spec.t_ccd_l_ns)

    # --- command-issue bound (data bus + bank-group tCCD_L) ----------------
    transitions = int(np.count_nonzero(bg[1:] != bg[:-1]))
    run_len = n / (transitions + 1)
    g_cap = max(1.0, _REORDER_WINDOW / (2.0 * run_len))
    issue_cycles = 0.0
    for lo in range(0, n, _REORDER_WINDOW):
        chunk_bg = bg[lo:lo + _REORDER_WINDOW]
        g = min(float(len(np.unique(chunk_bg))), g_cap)
        rate = min(1.0, g / ccd_l_cyc)           # commands per cycle
        issue_cycles += len(chunk_bg) / rate
        # Window-mean turnaround: each command's engine contributes its
        # own duplex turnaround share to the window it lands in.
        turn_sum = 0.0
        for i in range(lo, min(lo + _REORDER_WINDOW, n)):
            turn_sum += turn_list[i]
        issue_cycles += turn_sum / len(chunk_bg)
    # Bus-reversal segments at grant boundaries between different ops.
    op_switch = 0.0
    for gi in range(1, len(grant_ops)):
        op_switch += _turnaround_between(spec, grant_ops[gi - 1],
                                         grant_ops[gi])
    issue_cycles += op_switch

    # --- bank bound (row activations serialize at tRC per bank) ------------
    open_row: Dict[int, int] = {}
    total_acts = 0
    t_rc_cyc = spec.ns_to_cycles(spec.t_rc_ns)
    bank_cycles = 0.0
    for lo in range(0, n, _REORDER_WINDOW):
        acts_in_window: Dict[int, float] = {}
        for i in range(lo, min(lo + _REORDER_WINDOW, n)):
            b_, r_ = int(bank[i]), int(row[i])
            if open_row.get(b_) != r_:
                # The activating engine's own write-recovery term.
                acts_in_window[b_] = (acts_in_window.get(b_, 0.0)
                                      + t_rc_cyc + extra_list[i])
                open_row[b_] = r_
                total_acts += 1
        if acts_in_window:
            bank_cycles += max(acts_in_window.values())

    # --- four-activate-window bound ----------------------------------------
    faw_cycles = total_acts * spec.ns_to_cycles(spec.t_faw_ns) / 4.0

    bounds = {"bus/ccd": issue_cycles, "bank": bank_cycles, "faw": faw_cycles}
    bound_name = max(bounds, key=bounds.get)
    steady_cycles = bounds[bound_name]

    eff = (1.0 - spec.t_rfc_ns / spec.t_refi_ns) * (1.0 - spec.sched_overhead)
    total_txns = sum(counts)
    total_cmds = sum(c * cmds for c, cmds in zip(counts, cmds_e))
    total_bytes = sum(c * p_k.b
                      for c, (p_k, _) in zip(counts, mix.entries))
    seconds = spec.cycles_to_ns(steady_cycles) * 1e-9
    gbps = total_bytes / seconds / 1e9 * eff if seconds > 0 else 0.0
    gbps = min(gbps, spec.peak_channel_gbps)

    mean_service = steady_cycles / total_txns if total_txns else 0.0
    # Per-engine service: steady cycles split by command-stream share;
    # queueing spelled per engine (mirrors _contended_throughput_mixed).
    mean_k = [steady_cycles * cmds_e[k] / total_cmds if total_cmds else 0.0
              for k in range(n_eng)]
    if arbitration == "exclusive":
        waits = []
        acc = 0.0
        for k in range(n_eng):
            waits.append(acc)
            acc += counts[k] * mean_k[k]
        queueing = sum(waits) / n_eng
        head_wait = waits[-1]
    else:
        rot = [sum(mean_k[j] for j in range(n_eng) if j != k)
               for k in range(n_eng)]
        queueing = sum(rot) / n_eng
        head_wait = bb * max(rot)

    return ContentionResult(
        num_engines=n_eng,
        aggregate_gbps=gbps,
        bound=bound_name,
        queueing_delay_cycles=queueing,
        detail={**bounds, "txns": float(n),
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


def serial_contended_latencies(
    p: RSTParams,
    mapping: AddressMapping,
    spec: MemorySpec,
    *,
    num_engines: int = 1,
    arbitration: str = "round_robin",
    burst_beats: int = 1,
    op: str = "read",
    switch_enabled: bool = False,
    switch_extra_cycles: int = 0,
    mix: EngineMix = None,
) -> LatencyTrace:
    """Reference contended serial latencies: per-transaction delay loop.

    Runs the uncontended reference loop for `op`, then walks the trace one
    transaction at a time adding the queueing-delay feedback (DESIGN.md
    §9): every transaction under round robin, each grant-head transaction
    under burst grants, one up-front whole-stream wait under exclusive
    grants.  `timing_model.serial_latencies(num_engines=N, ...)` must be
    bit-exact against this at every (policy, burst_beats, N).

    `mix` names heterogeneous co-resident engines: ``(p, op)`` selects
    the observed entry, grant-head waits sum the *other* entries' own
    trace means one engine at a time, and exclusive grants wait out the
    complete streams of the entries granted earlier (entry order).  A
    uniform mix delegates to the homogeneous branch bit-identically.
    """
    if mix is not None:
        if (p, op) not in mix.entries:
            raise ValueError(
                "serial_contended_latencies(mix=...) observes the engine "
                "named by (p, op); that pair must be one of the mix entries")
        num_engines = len(mix)
        if mix.uniform_entry() is not None:
            mix = None
    base_fn = (serial_write_latencies if op == "write"
               else serial_read_latencies)
    base = base_fn(p, mapping, spec, switch_enabled=switch_enabled,
                   switch_extra_cycles=switch_extra_cycles)
    n = len(base.cycles)
    bb = _grant_beats(arbitration, burst_beats, n)
    if num_engines < 1:
        raise ValueError(f"num_engines must be >= 1, got {num_engines}")
    if num_engines == 1 or n == 0:
        return base
    lat = base.cycles.copy()
    if mix is not None:
        k0 = mix.entries.index((p, op))
        if arbitration == "exclusive":
            total = 0.0
            for j in range(k0):               # engines granted before us
                p_j, op_j = mix.entries[j]
                fn_j = (serial_write_latencies if op_j == "write"
                        else serial_read_latencies)
                t_j = fn_j(p_j, mapping, spec,
                           switch_enabled=switch_enabled,
                           switch_extra_cycles=switch_extra_cycles)
                total += float(np.sum(t_j.cycles))
            lat[0] = lat[0] + total
        else:
            total = 0.0
            for j, (p_j, op_j) in enumerate(mix.entries):
                if j == k0:
                    continue
                fn_j = (serial_write_latencies if op_j == "write"
                        else serial_read_latencies)
                t_j = fn_j(p_j, mapping, spec,
                           switch_enabled=switch_enabled,
                           switch_extra_cycles=switch_extra_cycles)
                total += float(np.mean(t_j.cycles))
            for i in range(n):
                if i % bb == 0:               # grant-head transaction
                    lat[i] = lat[i] + bb * total
        return LatencyTrace(cycles=lat, states=base.states,
                            refresh_hits=base.refresh_hits)
    if arbitration == "exclusive":
        lat[0] = lat[0] + 0.5 * (num_engines - 1) * float(np.sum(base.cycles))
    else:
        mean_service = float(np.mean(base.cycles))
        for i in range(n):
            if i % bb == 0:                   # grant-head transaction
                lat[i] = lat[i] + (num_engines - 1) * bb * mean_service
    return LatencyTrace(cycles=lat, states=base.states,
                        refresh_hits=base.refresh_hits)
