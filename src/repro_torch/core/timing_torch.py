"""Batched PyTorch evaluation of the throughput timing model (the grid tier).

The NumPy model (`core/timing_model.py`) evaluates one (params, policy,
op, contention) point per host call; a campaign cross-product over the
paper's knobs — policy x burst x arbitration x placement x N engines —
is 10^4..10^6 points and therefore bounded by Python dispatch.  This
module evaluates the segment-reduction throughput analysis as tensor
operations over a leading *lane* axis, so a whole grid is a handful of
batched calls on the card:

* :func:`throughput` / :func:`contended_throughput` /
  :func:`contended_throughput_mix` — single-point mirrors of the NumPy
  entry points (same result dataclasses, same detail keys).  The
  ``torchgrid`` backend routes per-point protocol calls here.
* :func:`evaluate_points` — the batch primitive: a flat list of point
  requests evaluated together.  ``Sweep.run()`` uses it to prefill its
  memo caches on grid-capable backends.
* :func:`evaluate_grid` — the cross-product planner: :class:`GridAxes`
  -> host prep -> batched evaluation -> :class:`GridResult`, optionally
  split over a list of devices (``launch/mesh.py``).

It is the counterpart of the reference's `timing_jax.py`, whose
``jit(vmap(point))`` evaluators become plain functions of ``[L]`` and
``[L, cap]`` tensors (`_grid_eval`, `_mix_eval`); the host prep, the
lane routing and the result mapping are the reference's.  Integers are
int32/int64 and floats float64, as there.  Agreement with the NumPy
model is within :data:`REL_TOLERANCE`: both compute the same float64
formulas, and only summation order and the padded command tail differ.
Integer outputs match exactly; the *bound name* can legitimately flip
when two resource bounds tie within float noise, so name assertions
apply only away from ties.

Every entry point evaluates on the CUDA card unless it is given
``device="cpu"``.  Lanes routed ``numpy``/``mixnumpy`` (streams the
batched evaluators decline) run the NumPy model per lane on the host,
as in the reference.  Serial latency stays NumPy-only: the ``torchgrid``
backend reports ``supports_latency=False``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import timing_model
from repro_torch.core.address_mapping import AddressMapping, get_mapping
from repro_torch.core.channels import topology_for
from repro_torch.core.engine import (PLACEMENTS, combine_placement,
                                     combine_placement_ports,
                                     placement_mix_slices,
                                     placement_port_counts)
from repro_torch.core.engine_mix import EngineMix, normalize_mix
from repro_torch.core.hwspec import MemorySpec
from repro_torch.core.params import RSTParams
from repro_torch.core.switch import SwitchModel
from repro_torch.core.timing_model import (_MAX_EXPAND, _REORDER_WINDOW,
                                           ContentionResult, ThroughputResult,
                                           _direction_overheads, _grant_beats,
                                           _mixed_grant_schedule,
                                           _turnaround_between)
from repro_torch.device import resolve_device

#: Documented NumPy<->torch agreement bound (relative) for float outputs —
#: both paths compute the same float64 formulas; only summation order and
#: command-capacity padding differ.
REL_TOLERANCE = 1e-9

_WIN = _REORDER_WINDOW
_BOUND_NAMES = ("bus/ccd", "bank", "faw")
_ROUTES = ("full", "periodic", "numpy", "mixfull", "mixnumpy")


# --------------------------------------------------------------- host prep
@functools.lru_cache(maxsize=None)
def _segment_table(mapping: AddressMapping
                   ) -> Tuple[Tuple[int, int, int, int, int], ...]:
    """(bit_pos, mask, row_weight, bg_weight, bank_weight) per segment.

    Mirrors ``AddressMapping.decode``: MSB-first fields, a field split
    across segments reassembling as ``(prev << n) | piece`` — i.e. each
    segment contributes ``piece << trailing_width`` where trailing_width
    sums the later segments of the *same* field.  Bank weights fold
    ``bank_id_from`` in directly (BG segments carry an extra
    ``<< bank_bits``).  Column segments never enter the bounds and are
    dropped.
    """
    entries = []
    pos = mapping.mapped_bits
    for f, n in mapping.fields:
        pos -= n
        entries.append((f, n, pos))
    trail = {"R": 0, "BG": 0, "B": 0, "C": 0}
    out = []
    for f, n, p in reversed(entries):
        shift = trail[f]
        trail[f] += n
        if f == "C":
            continue
        row_w = (1 << shift) if f == "R" else 0
        bg_w = (1 << shift) if f == "BG" else 0
        if f == "BG":
            bank_w = (1 << shift) << mapping.spec.bank_bits
        elif f == "B":
            bank_w = 1 << shift
        else:
            bank_w = 0
        out.append((p, (1 << n) - 1, row_w, bg_w, bank_w))
    out.reverse()
    return tuple(out)


def _bucket(n: int, quantum: int) -> int:
    """Smallest ``quantum * 2^k >= n``: command capacities and lane chunks
    come from a small ladder of sizes."""
    size = quantum
    while size < n:
        size *= 2
    return size


# -------------------------------------------------------- the evaluators
def _decode(d: Dict[str, torch.Tensor], addr: torch.Tensor, lsb: int,
            nseg: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row, bank-group and bank ids of ``[L, cap]`` byte addresses via each
    lane's segment table (column segments dropped; pad segments have a
    zero mask)."""
    m = addr >> lsb
    row = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    bg = torch.zeros_like(row)
    bank = torch.zeros_like(row)
    for k in range(nseg):
        piece = ((m >> d["seg_pos"][:, k:k + 1])
                 & d["seg_mask"][:, k:k + 1]).to(torch.int32)
        row = row + piece * d["seg_row"][:, k:k + 1]
        bg = bg + piece * d["seg_bg"][:, k:k + 1]
        bank = bank + piece * d["seg_bank"][:, k:k + 1]
    return row, bg, bank


def _interleave(d: Dict[str, torch.Tensor], i: torch.Tensor, bus: int):
    """Grant-interleaved stream (_contended_command_addresses): engine and
    transaction index of every command slot, plus its byte offset inside
    the transaction.  Full bb-beat rounds flatten as (round, engine,
    beat); the trailing partial round is engine-major.  eng=1
    degenerates to the plain single-engine expansion, slot for slot."""
    txns, eng = d["txns"][:, None], d["eng"][:, None]
    cmds, bb = d["cmds"][:, None], d["bb"][:, None]
    q = i // cmds
    off = ((i % cmds) * bus).to(torch.int64)
    nfull = (txns // bb) * bb
    split = nfull * eng
    ebb = eng * bb
    m_full = q % ebb
    e_full = m_full // bb
    t_full = (q // ebb) * bb + m_full % bb
    # Negative inside the full rounds; floor division keeps it harmless
    # there, and the where() below never selects it.
    q2 = q - split
    rem = torch.clamp(txns - nfull, min=1)
    in_full = q < split
    e = torch.where(in_full, e_full, q2 // rem)
    t = torch.where(in_full, t_full, nfull + q2 % rem)
    return e, t, off


def _prev_same_bank(bank_s: torch.Tensor, i: torch.Tensor,
                    nb: int) -> torch.Tensor:
    """Previous same-bank slot of every slot (-1 for none) via one
    exclusive running max per bank (the shifted-argsort of
    timing_model._prev_same_bank, without the sort)."""
    lanes, cap = bank_s.shape
    prev = torch.full((lanes, cap), -1, dtype=torch.int32,
                      device=bank_s.device)
    head = prev[:, :1]
    for b in range(nb):
        is_b = bank_s == b
        cand = torch.where(is_b, i, -1)
        run = torch.cummax(cand, dim=1).values
        run_excl = torch.cat([head, run[:, :-1]], dim=1)
        prev = torch.where(is_b, run_excl, prev)
    return prev


def _window_onehot(ids: torch.Tensor, nw: int, count: int) -> torch.Tensor:
    """``[L, nw, WIN, count]`` one-hot of per-slot ids by reorder window;
    sentinel ids (== count) match nothing."""
    ar = torch.arange(count, dtype=ids.dtype, device=ids.device)
    return ids.view(ids.shape[0], nw, _WIN)[..., None] == ar


def _spec_terms(spec: MemorySpec):
    return {"nbg": 1 << spec.bankgroup_bits, "nb": spec.num_banks,
            "bus": spec.bus_bytes_per_cycle, "lsb": spec.addr_lsb,
            "ccd_l": spec.ns_to_cycles(spec.t_ccd_l_ns),
            "t_rc": spec.ns_to_cycles(spec.t_rc_ns),
            "faw4": spec.ns_to_cycles(spec.t_faw_ns) / 4.0,
            "cycle_ns": spec.cycle_ns, "peak": spec.peak_channel_gbps}


def _finish(c, d, issue, bank_cycles, faw, acts_f, totalf, txnef, bytes_):
    """The three bounds -> GB/s, bound index and queueing terms, per lane
    (shared tail of both evaluators)."""
    bounds = torch.stack([issue, bank_cycles, faw], dim=1)
    steady = bounds.max(dim=1).values
    seconds = steady * c["cycle_ns"] * 1e-9
    gbps = torch.where(seconds > 0.0,
                       bytes_ / torch.clamp(seconds, min=1e-300) / 1e9
                       * d["eff"], 0.0)
    gbps = torch.clamp(gbps, max=c["peak"])
    mean_service = torch.where(
        txnef > 0.0, steady / torch.clamp(txnef, min=1.0), 0.0)
    engf = d["eng"].to(torch.float64)
    bbf = d["bb"].to(torch.float64)
    stream = d["txns"].to(torch.float64) * mean_service
    is_excl = d["excl"] > 0
    queueing = torch.where(is_excl, 0.5 * (engf - 1.0) * stream,
                           (engf - 1.0) * mean_service)
    head = torch.where(is_excl, (engf - 1.0) * stream,
                       (engf - 1.0) * bbf * mean_service)
    return {"gbps": gbps, "bidx": torch.argmax(bounds, dim=1),
            "issue": issue, "bank": bank_cycles, "faw": faw,
            "acts": acts_f, "cmds_total": totalf,
            "mean_service": mean_service, "queueing": queueing,
            "head": head}


def _grid_eval(spec: MemorySpec, d: Dict[str, torch.Tensor], cap: int,
               nseg: int, periodic: bool) -> Dict[str, torch.Tensor]:
    """Evaluate homogeneous lanes of `cap`-command streams on `spec`.

    One lane = one (params, mapping, op, engines, arbitration) unit; the
    lane's command stream, address decode and the three resource bounds
    of ``timing_model._stream_bounds`` are computed from its columns in
    `d` (``[L]`` scalars, ``[L, nseg]`` segment tables).  Lanes are padded
    to `cap` commands; invalid slots carry sentinel bank/bank-group ids
    one past the real range so every windowed reduction ignores them.

    ``periodic=True`` is the steady-state fast path (cap = two reorder
    windows): eligible lanes (see `_unit_row`) have an address stream
    that is exactly periodic from command 0 with period dividing the
    reorder window, so every window past the first is identical — the
    evaluator computes the cold window plus one steady window and
    extrapolates the remaining ``nwin - 1`` windows in closed form.
    Integer quantities match the full expansion exactly; float
    quantities differ only by multiply-vs-repeated-add rounding.
    """
    c = _spec_terms(spec)
    nw = cap // _WIN
    lanes = d["txns"].shape[0]
    dev = d["txns"].device
    i = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    if periodic:
        totalf, txnef, nwinf = d["totalf"], d["txnef"], d["nwinf"]
        valid = torch.ones((lanes, cap), dtype=torch.bool, device=dev)
    else:
        total = d["txns"] * d["eng"] * d["cmds"]
        totalf = total.to(torch.float64)
        txnef = (d["txns"] * d["eng"]).to(torch.float64)
        valid = i < total[:, None]

    e, t, off = _interleave(d, i, c["bus"])
    # (t*S) mod W == (t mod (W//S)) * S for pow2 S <= W: keeps the
    # product inside int64 for any valid RST tuple.
    addr = (d["a"][:, None] + (t % d["wos"][:, None]).to(torch.int64)
            * d["s"][:, None] + e.to(torch.int64) * d["w"][:, None] + off)
    row, bg, bank = _decode(d, addr, c["lsb"], nseg)
    bg_s = torch.where(valid, bg, c["nbg"])
    bank_s = torch.where(valid, bank, c["nb"])

    # --- command-issue bound (data bus + bank-group tCCD_L) ------------
    diffs = (bg_s[:, 1:] != bg_s[:, :-1]) & valid[:, 1:]
    if periodic:
        # Transitions are periodic in i from i=1 on: window 0 contributes
        # its 63 interior pairs, every later window the 64 pairs starting
        # at its boundary — all equal to window 1's by periodicity.
        s0 = diffs[:, :_WIN - 1].sum(dim=1).to(torch.float64)
        s1 = diffs[:, _WIN - 1:].sum(dim=1).to(torch.float64)
        trans = s0 + s1 * (nwinf - 1.0)
    else:
        trans = diffs.sum(dim=1).to(torch.float64)
    run_len = totalf / (trans + 1.0)
    g_cap = torch.clamp(_WIN / (2.0 * run_len), min=1.0)
    uniq = _window_onehot(bg_s, nw, c["nbg"]).any(dim=2).sum(dim=2)
    if periodic:
        # All windows share window 1's bank-group population (the
        # address stream itself is periodic from command 0).
        g1 = torch.minimum(uniq[:, 1].to(torch.float64), g_cap)
        denom1 = torch.clamp(g1 / c["ccd_l"], max=1.0)
        per_w = _WIN / torch.clamp(denom1, min=1e-300)
        issue = nwinf * per_w + d["turn"] * nwinf
    else:
        wlen = torch.clamp(
            total[:, None] - torch.arange(nw, dtype=torch.int32,
                                          device=dev)[None, :] * _WIN,
            0, _WIN)
        g = torch.minimum(uniq.to(torch.float64), g_cap[:, None])
        denom = torch.clamp(g / c["ccd_l"], max=1.0)
        per = torch.where(wlen > 0, wlen.to(torch.float64)
                          / torch.clamp(denom, min=1e-300), 0.0)
        nw_used = (wlen > 0).sum(dim=1).to(torch.float64)
        issue = per.sum(dim=1) + d["turn"] * nw_used

    # --- bank bound (activations serialize at tRC per bank) ------------
    prev = _prev_same_bank(bank_s, i, c["nb"])
    row_prev = torch.gather(row, 1, torch.clamp(prev, 0, cap - 1).long())
    act = valid & ((prev < 0) | (row_prev != row))
    actw = act.view(lanes, nw, _WIN)
    counts = (actw[..., None] & _window_onehot(bank_s, nw, c["nb"])).sum(
        dim=2)
    pwmax = counts.max(dim=2).values
    if periodic:
        # Window 1 is the steady state: the activation pattern repeats
        # with the stream period (first-touch activations all land in
        # window 0), so windows 1..nwin-1 are identical.
        per_window_acts = actw.sum(dim=2).to(torch.float64)
        acts_f = (per_window_acts[:, 0]
                  + per_window_acts[:, 1] * (nwinf - 1.0))
        pwf = pwmax.to(torch.float64)
        pw_sum = pwf[:, 0] + pwf[:, 1] * (nwinf - 1.0)
    else:
        acts_f = act.sum(dim=1).to(torch.float64)
        pw_sum = pwmax.sum(dim=1).to(torch.float64)
    bank_cycles = pw_sum * (c["t_rc"] + d["extra"])

    # --- four-activate-window bound ------------------------------------
    faw = acts_f * c["faw4"]
    return _finish(c, d, issue, bank_cycles, faw, acts_f, totalf, txnef,
                   txnef * d["bf"])


def _mix_eval(spec: MemorySpec, d: Dict[str, torch.Tensor], cap: int,
              nseg: int, max_n: int) -> Dict[str, torch.Tensor]:
    """Evaluate *mixed-engine* lanes on `spec`.

    The heterogeneous sibling of :func:`_grid_eval`: one lane = one
    stackable :class:`EngineMix` unit — every engine has the same
    transaction count and commands-per-transaction (ragged mixes fall
    back to the NumPy mixed model per lane), but carries its *own* RST
    tuple and direction overheads in padded per-engine ``[L, max_n]``
    stacks (pad entries repeat engine 0 and are never gathered: the
    computed engine index stays below the lane's real engine count).
    The grant-interleave index math is the homogeneous one; per-engine
    address terms, per-window *mean* turnaround, the activation weights
    of the bank bound, and the host-computed grant-boundary bus-reversal
    cost (``bcost``) generalize the scalar lane fields.  Mixed lanes
    never take the periodic fast path.
    """
    c = _spec_terms(spec)
    nw = cap // _WIN
    lanes = d["txns"].shape[0]
    dev = d["txns"].device
    i = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    total = d["txns"] * d["eng"] * d["cmds"]
    totalf = total.to(torch.float64)
    txnef = (d["txns"] * d["eng"]).to(torch.float64)
    valid = i < total[:, None]

    e, t, off = _interleave(d, i, c["bus"])
    e_c = torch.clamp(e, 0, max_n - 1).long()
    a_e = torch.gather(d["stk_a"], 1, e_c)     # absolute base incl. window
    s_e = torch.gather(d["stk_s"], 1, e_c)
    wos_e = torch.gather(d["stk_wos"], 1, e_c)
    addr = a_e + (t % wos_e).to(torch.int64) * s_e + off
    row, bg, bank = _decode(d, addr, c["lsb"], nseg)
    bg_s = torch.where(valid, bg, c["nbg"])
    bank_s = torch.where(valid, bank, c["nb"])

    # --- command-issue bound (data bus + bank-group tCCD_L) ------------
    diffs = (bg_s[:, 1:] != bg_s[:, :-1]) & valid[:, 1:]
    trans = diffs.sum(dim=1).to(torch.float64)
    run_len = totalf / (trans + 1.0)
    g_cap = torch.clamp(_WIN / (2.0 * run_len), min=1.0)
    uniq = _window_onehot(bg_s, nw, c["nbg"]).any(dim=2).sum(dim=2)
    wlen = torch.clamp(
        total[:, None] - torch.arange(nw, dtype=torch.int32,
                                      device=dev)[None, :] * _WIN, 0, _WIN)
    wlenf = wlen.to(torch.float64)
    g = torch.minimum(uniq.to(torch.float64), g_cap[:, None])
    denom = torch.clamp(g / c["ccd_l"], max=1.0)
    per = torch.where(wlen > 0, wlenf / torch.clamp(denom, min=1e-300), 0.0)
    # Per-window *mean* of the per-command turnaround (each command
    # contributes its issuing engine's duplex share), plus the
    # host-computed grant-boundary bus-reversal segments.
    turn_i = torch.where(valid, torch.gather(d["stk_turn"], 1, e_c), 0.0)
    tw = turn_i.view(lanes, nw, _WIN).sum(dim=2)
    per_turn = torch.where(wlen > 0, tw / torch.clamp(wlenf, min=1.0), 0.0)
    issue = per.sum(dim=1) + per_turn.sum(dim=1) + d["bcost"]

    # --- bank bound (activations serialize at tRC per bank) ------------
    prev = _prev_same_bank(bank_s, i, c["nb"])
    row_prev = torch.gather(row, 1, torch.clamp(prev, 0, cap - 1).long())
    act = valid & ((prev < 0) | (row_prev != row))
    # Each activation extends tRC by its own engine's write-recovery
    # term: weighted per-(window, bank) sums instead of counts.
    w_i = torch.where(act, c["t_rc"] + torch.gather(d["stk_extra"], 1, e_c),
                      0.0)
    sums = (w_i.view(lanes, nw, _WIN)[..., None]
            * _window_onehot(bank_s, nw, c["nb"]).to(torch.float64)).sum(
                dim=2)
    pwmax = sums.max(dim=2).values
    acts_f = act.sum(dim=1).to(torch.float64)
    bank_cycles = pwmax.sum(dim=1)

    # --- four-activate-window bound ------------------------------------
    faw = acts_f * c["faw4"]
    # Equal counts and commands-per-txn make every engine's service share
    # identical, so the homogeneous queueing forms apply.
    out = _finish(c, d, issue, bank_cycles, faw, acts_f, totalf, txnef,
                  d["bytesf"])
    out["opsw"] = d["bcost"]
    return out


# ------------------------------------------------- unit batching + results
# A "unit" is one same-channel lane: (params, mapping, op, engine_count,
# arbitration, requested_burst_beats).  Placement points decompose into
# per-port units (engine.placement_port_counts) and are recombined
# host-side (engine.combine_placement), exactly like
# Engine._contention_unscaled.
_Unit = Tuple[RSTParams, AddressMapping, str, int, str, int]

# A mixed-engine lane: (mix, mapping, arbitration, requested_burst_beats).
# Only genuinely mixed EngineMix values appear here — uniform mixes
# normalize to a homogeneous _Unit before the units dict is built, so the
# two spellings share lanes (and memo keys).
_MixUnit = Tuple[EngineMix, AddressMapping, str, int]


def _efficiency(spec: MemorySpec) -> float:
    return ((1.0 - spec.t_rfc_ns / spec.t_refi_ns)
            * (1.0 - spec.sched_overhead))


def _unit_row(spec: MemorySpec, unit: _Unit) -> Dict[str, object]:
    """Host-side scalar row for one lane (mirrors the caps and clamps of
    _command_addresses / _contended_command_addresses).

    Also decides periodic eligibility: the grant-interleaved stream
    repeats exactly with period ``cmds * wos`` commands for one engine
    (the interleave is the identity), and with period
    ``cmds * eng * bb * (wos // gcd(bb, wos))`` for multiple engines when
    the per-engine stream has no partial grant round (``txns % bb == 0``
    — always true for pow2 txns and grant sizes).  A lane is eligible
    when that period divides one reorder window and the stream spans at
    least two whole windows, so window 1 onward are identical and the
    evaluator can extrapolate instead of expanding."""
    p, mapping, op, count, arbitration, burst_beats = unit
    turn, extra = _direction_overheads(spec, op)
    cmds = max(1, p.b // spec.bus_bytes_per_cycle)
    max_txns = max(16, (_MAX_EXPAND // cmds) // count)
    txns = min(p.n, _MAX_EXPAND, max_txns)
    bb = _grant_beats(arbitration, burst_beats, txns)
    wos = p.w // p.s
    total = txns * count * cmds
    if count == 1:
        period = cmds * wos
    elif txns % bb == 0:
        period = cmds * count * bb * (wos // math.gcd(bb, wos))
    else:
        period = 0
    periodic = (0 < period <= _WIN and _WIN % period == 0
                and total >= 2 * _WIN and total % _WIN == 0)
    return {"txns": txns, "eng": count, "cmds": cmds, "bb": bb,
            "excl": int(arbitration == "exclusive"),
            "a": p.a, "s": p.s, "w": p.w, "wos": wos, "b": p.b,
            "turn": turn, "extra": extra, "seg": _segment_table(mapping),
            "periodic": periodic, "totalf": float(total),
            "txnef": float(txns * count), "nwinf": float(total // _WIN),
            "unit": unit}


def _mix_row(spec: MemorySpec, unit: _MixUnit) -> Dict[str, object]:
    """Host-side row for one *mixed* lane.

    Mirrors `_contended_throughput_mixed`'s caps exactly: the shared
    command budget splits `_MAX_EXPAND` across engines at the widest
    per-transaction command count, per-engine streams truncate to it,
    and grant beats clamp against the longest stream.  The grant-boundary
    bus-reversal cost (`bcost`) is data-independent of the addresses, so
    it is summed host-side along the real `_mixed_grant_schedule` grant
    sequence and added to the issue bound as a scalar.  A lane is
    *stackable* (eligible for `_mix_eval`) when every engine has the
    same transaction count and commands-per-transaction — the padded
    parameter stacks then share the homogeneous interleave index math;
    ragged mixes fall back to the NumPy mixed model per lane.  Mixed
    lanes are never periodic: engines may disagree on period, which is
    what routes them off the homogeneous fast path in the first place.
    """
    mix, mapping, arbitration, burst_beats = unit
    mix.validate(spec)
    n_eng = len(mix)
    bus = spec.bus_bytes_per_cycle
    over = [_direction_overheads(spec, op_k) for op_k in mix.ops]
    cmds_e = [max(1, p_k.b // bus) for p_k in mix.params]
    max_txns = max(16, (_MAX_EXPAND // max(cmds_e)) // n_eng)
    counts = [min(p_k.n, _MAX_EXPAND, max_txns) for p_k in mix.params]
    bb = _grant_beats(arbitration, burst_beats, max(counts))
    _, _, grants = _mixed_grant_schedule(counts, bb, arbitration)
    pair_cost = np.array(
        [[_turnaround_between(spec, oi, oj) for oj in mix.ops]
         for oi in mix.ops], dtype=np.float64)
    bcost = (float(pair_cost[grants[:-1], grants[1:]].sum())
             if len(grants) > 1 else 0.0)
    w_offs = np.concatenate(([0], np.cumsum(
        np.array([p_k.w for p_k in mix.params], dtype=np.int64))))[:-1]
    stackable = len(set(counts)) == 1 and len(set(cmds_e)) == 1
    total = int(sum(c * cm for c, cm in zip(counts, cmds_e)))
    total_txns = int(sum(counts))
    bytesf = float(sum(c * p_k.b for c, p_k in zip(counts, mix.params)))
    return {"txns": counts[0], "eng": n_eng, "cmds": cmds_e[0], "bb": bb,
            "excl": int(arbitration == "exclusive"),
            "stk_a": np.array(
                [p_k.a + int(w_offs[k])
                 for k, p_k in enumerate(mix.params)], dtype=np.int64),
            "stk_s": np.array([p_k.s for p_k in mix.params],
                              dtype=np.int64),
            "stk_wos": np.array([p_k.w // p_k.s for p_k in mix.params],
                                dtype=np.int32),
            "stk_turn": np.array([t for t, _ in over], dtype=np.float64),
            "stk_extra": np.array([x for _, x in over], dtype=np.float64),
            "bcost": bcost, "bytesf": bytesf,
            "seg": _segment_table(mapping), "periodic": False,
            "stackable": stackable, "totalf": float(total),
            "txnef": float(total_txns), "mix": mix, "mix_unit": unit}


_I32 = ("txns", "eng", "cmds", "bb", "excl", "wos")
_I64 = ("a", "s", "w")
_F64 = ("turn", "extra", "totalf", "txnef", "nwinf")

#: Longest command stream the full-expansion evaluator will materialize.
#: Non-periodic lanes past this fall back to the NumPy model per lane —
#: the windowed one-hot reductions are O(commands x banks) per lane, so
#: an unbounded cap would trade the whole batch's memory for a tail the
#: batched path cannot amortize anyway.
_FULL_KERNEL_MAX_CMDS = 8192

#: Lane-chunk budget in command slots: one evaluator call materializes at
#: most ~budget x num_banks one-hot elements at a time.
_LANE_SLOT_BUDGET = 1 << 21

_OUT_KEYS = ("gbps", "issue", "bank", "faw", "acts", "cmds_total",
             "mean_service", "queueing", "head")


@dataclasses.dataclass
class GridSplit:
    """Where one evaluation's wall time went, and how its lanes were
    routed.

    ``prep_s`` is host time building lane rows and column arrays;
    ``device_s`` wall time from the columns' copy to the device to the
    results' copy back (it ends in a synchronize); ``host_lanes_s`` the
    ``numpy``/``mixnumpy`` lanes' per-lane NumPy evaluation; ``map_s``
    the mapping of lane outputs onto points.  ``routes`` counts lanes
    per route.
    """

    prep_s: float = 0.0
    device_s: float = 0.0
    host_lanes_s: float = 0.0
    map_s: float = 0.0
    routes: Dict[str, int] = dataclasses.field(default_factory=dict)


def _seg_columns(cols: Dict[str, np.ndarray], padded, nseg: int) -> None:
    lanes = len(padded)
    seg = np.zeros((lanes, nseg, 5), dtype=np.int64)
    for j, r in enumerate(padded):
        for k, ent in enumerate(r["seg"]):
            seg[j, k] = ent
    cols["seg_pos"] = seg[:, :, 0]
    cols["seg_mask"] = seg[:, :, 1]
    cols["seg_row"] = seg[:, :, 2].astype(np.int32)
    cols["seg_bg"] = seg[:, :, 3].astype(np.int32)
    cols["seg_bank"] = seg[:, :, 4].astype(np.int32)


def _evaluate(evaluator, cols: Dict[str, np.ndarray], n: int,
              device: Optional[torch.device], mesh,
              split: GridSplit) -> Dict[str, np.ndarray]:
    """Copy host columns to the device (or split them over the mesh), run
    `evaluator` on each part, and bring the first `n` lanes back as
    float64/int64 arrays."""
    t0 = time.perf_counter()
    if mesh is not None:
        from repro_torch.launch.mesh import shard_grid
        shards = {k: shard_grid(v, mesh, pad=False)[0]
                  for k, v in cols.items()}
        parts = [{k: v[j] for k, v in shards.items()}
                 for j in range(len(mesh))]
    else:
        parts = [{k: torch.from_numpy(v).to(device)
                  for k, v in cols.items()}]
    outs = []
    for part in parts:
        out = evaluator(part)
        flat = torch.stack([out[k].to(torch.float64) for k in _OUT_KEYS]
                           + ([out["opsw"].to(torch.float64)]
                              if "opsw" in out else []), dim=1)
        outs.append((flat, out["bidx"]))
    flat = np.concatenate([f.cpu().numpy() for f, _ in outs])[:n]
    bidx = np.concatenate([b.cpu().numpy() for _, b in outs])[:n]
    split.device_s += time.perf_counter() - t0
    res = {k: flat[:, j] for j, k in enumerate(_OUT_KEYS)}
    if flat.shape[1] > len(_OUT_KEYS):
        res["opsw"] = flat[:, len(_OUT_KEYS)]
    res["bidx"] = bidx.astype(np.int64)
    return res


def _run_batch(spec: MemorySpec, rows: Sequence[Dict[str, object]],
               periodic: bool, device: Optional[torch.device], mesh=None,
               split: Optional[GridSplit] = None) -> Dict[str, np.ndarray]:
    """One batched evaluation over host rows -> dict of [len(rows)]
    output arrays.  Under a mesh, pads the lane axis to the device count
    (padding lanes repeat row 0 and are sliced off).  Off-mesh, wide
    batches of long streams split into fixed-size lane chunks to bound
    the evaluator's working set."""
    split = GridSplit() if split is None else split
    n = len(rows)
    if periodic:
        cap = 2 * _WIN
    else:
        cap = _bucket(max(r["txns"] * r["eng"] * r["cmds"] for r in rows),
                      _WIN)
    if mesh is None:
        chunk = _bucket(max(1, _LANE_SLOT_BUDGET // cap), 1)
        if n > chunk:
            parts = [_run_batch(spec, rows[lo:lo + chunk], periodic,
                                device, split=split)
                     for lo in range(0, n, chunk)]
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
    t0 = time.perf_counter()
    nseg = max(len(r["seg"]) for r in rows)
    lanes = n + (-n) % len(mesh) if mesh is not None else n

    cols: Dict[str, np.ndarray] = {}
    padded = list(rows) + [rows[0]] * (lanes - n)
    for k in _I32:
        cols[k] = np.array([r[k] for r in padded], dtype=np.int32)
    for k in _I64:
        cols[k] = np.array([r[k] for r in padded], dtype=np.int64)
    for k in _F64:
        cols[k] = np.array([r[k] for r in padded], dtype=np.float64)
    cols["bf"] = np.array([r["b"] for r in padded], dtype=np.float64)
    cols["eff"] = np.full(lanes, _efficiency(spec), dtype=np.float64)
    _seg_columns(cols, padded, nseg)
    split.prep_s += time.perf_counter() - t0
    return _evaluate(
        lambda d: _grid_eval(spec, d, cap, nseg, periodic),
        cols, n, device, mesh, split)


_MIX_I32 = ("txns", "eng", "cmds", "bb", "excl")
_MIX_F64 = ("bcost", "bytesf", "totalf", "txnef")
_MIX_STACKS = (("stk_a", np.int64), ("stk_s", np.int64),
               ("stk_wos", np.int32), ("stk_turn", np.float64),
               ("stk_extra", np.float64))


def _run_mix_batch(spec: MemorySpec, rows: Sequence[Dict[str, object]],
                   device: Optional[torch.device], mesh=None,
                   split: Optional[GridSplit] = None
                   ) -> Dict[str, np.ndarray]:
    """One batched `_mix_eval` call over stackable mixed rows.

    Same chunking/mesh-padding discipline as `_run_batch`; additionally
    pads the engine axis to a shared pow2 width, repeating each lane's
    engine-0 stack entry (pad entries are never gathered — the engine
    index stays below the lane's real engine count).
    """
    split = GridSplit() if split is None else split
    n = len(rows)
    cap = _bucket(max(int(r["totalf"]) for r in rows), _WIN)
    max_n = _bucket(max(int(r["eng"]) for r in rows), 1)
    if mesh is None:
        chunk = _bucket(max(1, _LANE_SLOT_BUDGET // cap), 1)
        if n > chunk:
            parts = [_run_mix_batch(spec, rows[lo:lo + chunk], device,
                                    split=split)
                     for lo in range(0, n, chunk)]
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
    t0 = time.perf_counter()
    nseg = max(len(r["seg"]) for r in rows)
    lanes = n + (-n) % len(mesh) if mesh is not None else n

    cols: Dict[str, np.ndarray] = {}
    padded = list(rows) + [rows[0]] * (lanes - n)
    for k in _MIX_I32:
        cols[k] = np.array([r[k] for r in padded], dtype=np.int32)
    for k in _MIX_F64:
        cols[k] = np.array([r[k] for r in padded], dtype=np.float64)
    for k, dt in _MIX_STACKS:
        arr = np.empty((lanes, max_n), dtype=dt)
        for j, r in enumerate(padded):
            v = r[k]
            arr[j, :len(v)] = v
            arr[j, len(v):] = v[0]
        cols[k] = arr
    cols["eff"] = np.full(lanes, _efficiency(spec), dtype=np.float64)
    _seg_columns(cols, padded, nseg)
    split.prep_s += time.perf_counter() - t0
    return _evaluate(
        lambda d: _mix_eval(spec, d, cap, nseg, max_n),
        cols, n, device, mesh, split)


def _numpy_rows(spec: MemorySpec, rows: Sequence[Dict[str, object]]
                ) -> Dict[str, np.ndarray]:
    """NumPy-model lanes the evaluators decline (non-periodic streams past
    `_FULL_KERNEL_MAX_CMDS`): same output schema, computed by
    `timing_model.contended_throughput` per lane on the host."""
    keys = ("gbps", "bidx", "issue", "bank", "faw", "acts", "cmds_total",
            "mean_service", "queueing", "head")
    out = {k: np.empty(len(rows), dtype=np.float64) for k in keys}
    for j, r in enumerate(rows):
        p, mapping, op, count, arb, bb_req = r["unit"]
        res = timing_model.contended_throughput(
            p, mapping, spec, num_engines=count, op=op, arbitration=arb,
            burst_beats=bb_req)
        out["gbps"][j] = res.aggregate_gbps
        out["bidx"][j] = _BOUND_NAMES.index(res.bound)
        out["issue"][j] = res.detail["bus/ccd"]
        out["bank"][j] = res.detail["bank"]
        out["faw"][j] = res.detail["faw"]
        out["acts"][j] = res.detail["total_acts"]
        out["cmds_total"][j] = res.detail["txns"]
        out["mean_service"][j] = res.detail["mean_service_cycles"]
        out["queueing"][j] = res.queueing_delay_cycles
        out["head"][j] = res.detail["grant_head_wait_cycles"]
    out["bidx"] = out["bidx"].astype(np.int64)
    return out


def _numpy_mix_rows(spec: MemorySpec, rows: Sequence[Dict[str, object]]
                    ) -> Dict[str, np.ndarray]:
    """NumPy-model mixed lanes `_mix_eval` declines (ragged
    counts/commands, or streams past `_FULL_KERNEL_MAX_CMDS`): same
    output schema, computed by `timing_model.contended_throughput_mix`
    per lane on the host."""
    keys = ("gbps", "bidx", "issue", "bank", "faw", "acts", "cmds_total",
            "mean_service", "queueing", "head", "opsw")
    out = {k: np.empty(len(rows), dtype=np.float64) for k in keys}
    for j, r in enumerate(rows):
        mix, mapping, arb, bb_req = r["mix_unit"]
        res = timing_model.contended_throughput_mix(
            mix, mapping, spec, arbitration=arb, burst_beats=bb_req)
        out["gbps"][j] = res.aggregate_gbps
        out["bidx"][j] = _BOUND_NAMES.index(res.bound)
        out["issue"][j] = res.detail["bus/ccd"]
        out["bank"][j] = res.detail["bank"]
        out["faw"][j] = res.detail["faw"]
        out["acts"][j] = res.detail["total_acts"]
        out["cmds_total"][j] = res.detail["txns"]
        out["mean_service"][j] = res.detail["mean_service_cycles"]
        out["queueing"][j] = res.queueing_delay_cycles
        out["head"][j] = res.detail["grant_head_wait_cycles"]
        out["opsw"][j] = res.detail.get("op_switch_cycles", 0.0)
    out["bidx"] = out["bidx"].astype(np.int64)
    return out


def _route(row: Dict[str, object]) -> str:
    if "mix_unit" in row:
        if row["stackable"] and row["totalf"] <= _FULL_KERNEL_MAX_CMDS:
            return "mixfull"
        return "mixnumpy"
    if row["periodic"]:
        return "periodic"
    if row["txns"] * row["eng"] * row["cmds"] > _FULL_KERNEL_MAX_CMDS:
        return "numpy"
    return "full"


def _run_rows(spec: MemorySpec, rows: Sequence[Dict[str, object]],
              device: Optional[torch.device], mesh=None,
              split: Optional[GridSplit] = None) -> Dict[str, np.ndarray]:
    """Evaluate host rows, routing each lane to the periodic evaluator,
    the full-expansion evaluator, or the NumPy model (see `_route`), and
    merge the outputs back into original row order as float64/int64
    arrays."""
    split = GridSplit() if split is None else split
    n = len(rows)
    routes = [_route(r) for r in rows]
    merged: Dict[str, np.ndarray] = {}
    for route in _ROUTES:
        idxs = [j for j in range(n) if routes[j] == route]
        if not idxs:
            continue
        split.routes[route] = split.routes.get(route, 0) + len(idxs)
        sub = [rows[j] for j in idxs]
        if route in ("numpy", "mixnumpy"):
            t0 = time.perf_counter()
            out = (_numpy_rows(spec, sub) if route == "numpy"
                   else _numpy_mix_rows(spec, sub))
            split.host_lanes_s += time.perf_counter() - t0
        elif route == "mixfull":
            out = _run_mix_batch(spec, sub, device, mesh, split)
        else:
            out = _run_batch(spec, sub, route == "periodic", device, mesh,
                             split)
        for k, v in out.items():
            if k not in merged:
                dt = np.int64 if k == "bidx" else np.float64
                merged[k] = np.empty(n, dtype=dt)
            merged[k][idxs] = v
    return merged


def _tp_result(spec: MemorySpec, rows, out, j: int) -> ThroughputResult:
    return ThroughputResult(
        gbps=float(out["gbps"][j]),
        bound=_BOUND_NAMES[int(out["bidx"][j])],
        detail={"bus/ccd": float(out["issue"][j]),
                "bank": float(out["bank"][j]),
                "faw": float(out["faw"][j]),
                "txns": float(out["cmds_total"][j]),
                "cmds_per_txn": float(rows[j]["cmds"]),
                "total_acts": float(out["acts"][j]),
                "efficiency": _efficiency(spec)})


def _cont_result(spec: MemorySpec, rows, out, j: int, arbitration: str,
                 burst_beats: int) -> ContentionResult:
    r = rows[j]
    return ContentionResult(
        num_engines=int(r["eng"]),
        aggregate_gbps=float(out["gbps"][j]),
        bound=_BOUND_NAMES[int(out["bidx"][j])],
        queueing_delay_cycles=float(out["queueing"][j]),
        detail={"bus/ccd": float(out["issue"][j]),
                "bank": float(out["bank"][j]),
                "faw": float(out["faw"][j]),
                "txns": float(out["cmds_total"][j]),
                "cmds_per_txn": float(r["cmds"]),
                "txns_per_engine": float(r["txns"]),
                "total_acts": float(out["acts"][j]),
                "mean_service_cycles": float(out["mean_service"][j]),
                "grant_head_wait_cycles": float(out["head"][j]),
                "grant_beats": float(r["bb"]),
                "efficiency": _efficiency(spec)},
        arbitration=arbitration,
        burst_beats=burst_beats)


def _cont_result_mix(spec: MemorySpec, rows, out, j: int,
                     arbitration: str, burst_beats: int) -> ContentionResult:
    r = rows[j]
    mix: EngineMix = r["mix"]
    txnef = float(r["txnef"])
    return ContentionResult(
        num_engines=len(mix),
        aggregate_gbps=float(out["gbps"][j]),
        bound=_BOUND_NAMES[int(out["bidx"][j])],
        queueing_delay_cycles=float(out["queueing"][j]),
        detail={"bus/ccd": float(out["issue"][j]),
                "bank": float(out["bank"][j]),
                "faw": float(out["faw"][j]),
                "txns": float(out["cmds_total"][j]),
                "cmds_per_txn": float(r["totalf"]) / txnef if txnef else 0.0,
                "txns_per_engine": txnef / len(mix),
                "total_acts": float(out["acts"][j]),
                "mean_service_cycles": float(out["mean_service"][j]),
                "grant_head_wait_cycles": float(out["head"][j]),
                "grant_beats": float(r["bb"]),
                "op_switch_cycles": float(out["opsw"][j]),
                "mix_size": float(len(mix)),
                "efficiency": _efficiency(spec)},
        arbitration=arbitration,
        burst_beats=burst_beats,
        mix=mix)


def _switch_for(spec: MemorySpec) -> SwitchModel:
    # Matches Engine._switch_model for an engine built without an explicit
    # switch: the placement combine sees identical capacity terms.
    return SwitchModel(topology_for(spec), enabled=True)


# ----------------------------------------------------------- public: points
def throughput(p: RSTParams, mapping: AddressMapping, spec: MemorySpec, *,
               op: str = "read",
               device: "torch.device | str | None" = None
               ) -> ThroughputResult:
    """Batched-tier mirror of :func:`timing_model.throughput`.

    Same signature (plus `device`), same result type, same detail keys;
    float fields agree within :data:`REL_TOLERANCE`, integer fields
    exactly.
    """
    dev = resolve_device(device)
    unit: _Unit = (p.validate(spec), mapping, op, 1, "round_robin", 1)
    rows = [_unit_row(spec, unit)]
    out = _run_rows(spec, rows, dev)
    return _tp_result(spec, rows, out, 0)


def contended_throughput(p: RSTParams, mapping: AddressMapping,
                         spec: MemorySpec, *, num_engines: int = 1,
                         op: str = "read",
                         arbitration: str = "round_robin",
                         burst_beats: int = 1,
                         device: "torch.device | str | None" = None
                         ) -> ContentionResult:
    """Batched-tier mirror of :func:`timing_model.contended_throughput`
    (same-channel placement; the cross-channel placements are combined by
    the engine/evaluate_points layer, as on the NumPy path)."""
    if num_engines < 1:
        raise ValueError(f"num_engines must be >= 1, got {num_engines}")
    dev = resolve_device(device)
    unit: _Unit = (p.validate(spec), mapping, op, num_engines,
                   arbitration, burst_beats)
    rows = [_unit_row(spec, unit)]
    out = _run_rows(spec, rows, dev)
    return _cont_result(spec, rows, out, 0, arbitration, burst_beats)


def contended_throughput_mix(mix: EngineMix, mapping: AddressMapping,
                             spec: MemorySpec, *,
                             arbitration: str = "round_robin",
                             burst_beats: int = 1,
                             device: "torch.device | str | None" = None
                             ) -> ContentionResult:
    """Batched-tier mirror of :func:`timing_model.contended_throughput_mix`.

    A uniform mix delegates to the homogeneous :func:`contended_throughput`
    (keeping its periodic fast path and bit-for-bit agreement with the
    homogeneous spelling); a genuinely mixed mix runs a stacked
    `_mix_eval` lane (or the NumPy mixed model for ragged/oversized
    lanes) and agrees with `timing_model.contended_throughput_mix` within
    :data:`REL_TOLERANCE`.
    """
    uni = mix.uniform_entry()
    if uni is not None:
        return contended_throughput(
            uni[0], mapping, spec, num_engines=len(mix), op=uni[1],
            arbitration=arbitration, burst_beats=burst_beats, device=device)
    dev = resolve_device(device)
    unit: _MixUnit = (mix.validate(spec), mapping, arbitration, burst_beats)
    rows = [_mix_row(spec, unit)]
    out = _run_rows(spec, rows, dev)
    return _cont_result_mix(spec, rows, out, 0, arbitration, burst_beats)


def evaluate_points(spec: MemorySpec, reqs: Sequence[Tuple], *,
                    mesh=None, device: "torch.device | str | None" = None,
                    split: Optional[GridSplit] = None) -> List[object]:
    """Evaluate a flat batch of sweep-style requests together.

    Each request is ``("tp", params, policy, op)`` or ``("cont", params,
    policy, op, num_engines, arbitration, burst_beats, placement)``,
    optionally extended with a ninth ``mix`` element (an
    :class:`EngineMix` or None) — exactly the memo-key fields of
    ``Sweep``'s deterministic caches.  Mix requests normalize first
    (uniform mix -> the homogeneous spelling, sharing its lanes and memo
    keys); genuinely mixed placements decompose the entry tuple
    *contiguously* across the per-port engine counts, re-normalizing each
    port's sub-mix, and recombine through
    ``engine.combine_placement_ports``.  Placement requests decompose
    into per-port units and recombine through the same switch-capacity
    model as ``Engine._contention_unscaled``; duplicate units across the
    batch evaluate once.  Returns result objects aligned with `reqs`.
    With `mesh` (a device list from ``launch.mesh.grid_mesh``) the lanes
    are split over its devices and `device` is not used.  A `split`
    given by the caller is filled with the lanes' routes and host/device
    times, as `GridResult.split` is for `evaluate_grid`.
    """
    dev = None if mesh is not None else resolve_device(device)
    units: Dict[object, int] = {}
    plans: List[Tuple] = []
    sw: Optional[SwitchModel] = None
    for req in reqs:
        if req[0] == "tp":
            _, p, policy, op = req
            unit: _Unit = (p.validate(spec), get_mapping(spec, policy),
                           op, 1, "round_robin", 1)
            units.setdefault(unit, len(units))
            plans.append(("tp", unit, None))
        elif req[0] == "cont":
            if len(req) == 9:
                _, p, policy, op, n_eng, arb, bb, placement, mix = req
            else:
                _, p, policy, op, n_eng, arb, bb, placement = req
                mix = None
            if n_eng < 1:
                raise ValueError(
                    f"num_engines must be >= 1, got {n_eng}")
            mix, p, op, n_eng = normalize_mix(mix, p, op, n_eng)
            p = p.validate(spec)
            mapping = get_mapping(spec, policy)
            if placement not in PLACEMENTS:
                raise ValueError(f"unknown placement {placement!r}; "
                                 f"valid: {PLACEMENTS}")
            if mix is not None:
                mix.validate(spec)
                if placement == "same_channel":
                    munit: _MixUnit = (mix, mapping, arb, bb)
                    units.setdefault(munit, len(units))
                    plans.append(("mix", munit, (arb, bb)))
                    continue
                sw = sw or _switch_for(spec)
                effective, counts = placement_port_counts(
                    sw, placement, n_eng)
                ports = []
                for lo, hi in placement_mix_slices(counts):
                    sub = EngineMix.of(mix.entries[lo:hi])
                    uni = sub.uniform_entry()
                    if uni is not None:
                        u: object = (uni[0], mapping, uni[1], len(sub),
                                     arb, bb)
                    else:
                        u = (sub, mapping, arb, bb)
                    units.setdefault(u, len(units))
                    ports.append((hi - lo, u))
                plans.append(("mixpl", ports, (n_eng, arb, bb, placement,
                                               effective, mix)))
                continue
            if placement == "same_channel":
                effective, counts = placement, [n_eng]
            else:
                sw = sw or _switch_for(spec)
                effective, counts = placement_port_counts(
                    sw, placement, n_eng)
            cunits = {c: (p, mapping, op, c, arb, bb)
                      for c in set(counts)}
            for u in cunits.values():
                units.setdefault(u, len(units))
            plans.append(("cont", cunits, (n_eng, arb, bb, placement,
                                           effective, counts)))
        else:
            raise ValueError(f"unknown request kind {req[0]!r}")
    if not plans:
        return []
    ordered = sorted(units, key=units.get)
    rows = [_mix_row(spec, u) if isinstance(u[0], EngineMix)
            else _unit_row(spec, u) for u in ordered]
    out = _run_rows(spec, rows, dev, mesh, split)

    results: List[object] = []
    for plan in plans:
        if plan[0] == "tp":
            results.append(_tp_result(spec, rows, out, units[plan[1]]))
            continue
        if plan[0] == "mix":
            munit, (arb, bb) = plan[1], plan[2]
            results.append(_cont_result_mix(
                spec, rows, out, units[munit], arb, bb))
            continue
        if plan[0] == "mixpl":
            ports, (n_eng, arb, bb, placement, effective, mix) = \
                plan[1], plan[2]
            port_results = []
            for count, u in ports:
                jdx = units[u]
                if isinstance(u[0], EngineMix):
                    port_results.append(
                        (count, _cont_result_mix(spec, rows, out, jdx,
                                                 arb, bb)))
                else:
                    port_results.append(
                        (count, _cont_result(spec, rows, out, jdx,
                                             arb, bb)))
            results.append(combine_placement_ports(
                sw, placement, effective, n_eng, port_results,
                arbitration=arb, burst_beats=bb, mix=mix))
            continue
        _, cunits, (n_eng, arb, bb, placement, effective, counts) = plan
        per_count = {c: _cont_result(spec, rows, out, units[u], arb, bb)
                     for c, u in cunits.items()}
        if placement == "same_channel":
            results.append(per_count[n_eng])
        else:
            results.append(combine_placement(
                sw, placement, effective, n_eng, counts, per_count,
                arbitration=arb, burst_beats=bb))
    return results


# ------------------------------------------------------------- public: grid
@dataclasses.dataclass(frozen=True)
class GridAxes:
    """One experiment cross-product, in Sweep-cache-key axis order.

    The flat point order is ``itertools.product(params, policies, ops,
    num_engines, arbitrations, placements)`` — rightmost axis fastest —
    matching the field order of the Sweep memo keys, so lane ``i`` of a
    :class:`GridResult` is the point ``sweep_points()[i]`` and the two
    orderings compare element for element.  ``arbitrations`` entries are
    ``(arbitration, burst_beats)`` pairs, validated like the per-point
    path.  ``kind="throughput"`` evaluates single-engine throughput
    points and requires the contention axes to stay at their defaults.
    """

    params: Tuple[RSTParams, ...]
    policies: Tuple[Optional[str], ...] = (None,)
    ops: Tuple[str, ...] = ("read",)
    num_engines: Tuple[int, ...] = (1,)
    arbitrations: Tuple[Tuple[str, int], ...] = (("round_robin", 1),)
    placements: Tuple[str, ...] = ("same_channel",)
    kind: str = "contention"

    def __post_init__(self):
        if self.kind not in ("throughput", "contention"):
            raise ValueError(f"unknown grid kind {self.kind!r}")
        if not self.params:
            raise ValueError("GridAxes needs at least one params point")
        if self.kind == "throughput" and (
                self.num_engines != (1,)
                or self.arbitrations != (("round_robin", 1),)
                or self.placements != ("same_channel",)):
            raise ValueError("throughput grids fix the contention axes "
                             "(num_engines/arbitrations/placements)")
        for n in self.num_engines:
            if n < 1:
                raise ValueError(f"num_engines must be >= 1, got {n}")
        for pl in self.placements:
            if pl not in PLACEMENTS:
                raise ValueError(f"unknown placement {pl!r}; "
                                 f"valid: {PLACEMENTS}")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.params), len(self.policies), len(self.ops),
                len(self.num_engines), len(self.arbitrations),
                len(self.placements))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def product(self) -> Iterator[Tuple]:
        return itertools.product(self.params, self.policies, self.ops,
                                 self.num_engines, self.arbitrations,
                                 self.placements)

    def sweep_points(self) -> List[object]:
        """The same cross-product as per-point SweepPoints, in lane
        order — the bridge grid-equivalence tests compare along."""
        from repro_torch.core.sweep import (KIND_CONTENTION, KIND_THROUGHPUT,
                                            SweepPoint)
        pts = []
        for p, pol, op, n, (arb, bb), pl in self.product():
            if self.kind == "throughput":
                pts.append(SweepPoint(p, pol, op=op,
                                      kind=KIND_THROUGHPUT))
            else:
                pts.append(SweepPoint(p, pol, op=op,
                                      kind=KIND_CONTENTION,
                                      num_engines=n, arbitration=arb,
                                      burst_beats=bb, placement=pl))
        return pts


@dataclasses.dataclass
class GridResult:
    """Stacked outputs of one :func:`evaluate_grid` call, lane-major.

    ``gbps``/``bound``/``queueing_delay_cycles`` are flat arrays over the
    cross-product (``axes.shape`` row-major, ``sweep_points()`` order);
    ``gbps`` is aggregate GB/s (equals single-engine throughput for
    ``kind="throughput"``).  ``split`` says where the wall time went and
    how the lanes were routed.  Full per-point result dataclasses
    materialize lazily through :meth:`results` — building 10^5 Python
    detail dicts would dominate the batched evaluation itself.
    """

    spec: MemorySpec
    axes: GridAxes
    gbps: np.ndarray
    bound: np.ndarray
    queueing_delay_cycles: np.ndarray
    elapsed_seconds: float
    _builder: object = dataclasses.field(repr=False, compare=False)
    split: GridSplit = dataclasses.field(default_factory=GridSplit)

    @property
    def size(self) -> int:
        return len(self.gbps)

    @property
    def points_per_second(self) -> float:
        return (self.size / self.elapsed_seconds
                if self.elapsed_seconds > 0 else float("inf"))

    def sweep_points(self) -> List[object]:
        return self.axes.sweep_points()

    def results(self) -> List[object]:
        """Materialized per-point result objects, lane order."""
        if not hasattr(self, "_materialized"):
            self._materialized = self._builder()
        return self._materialized

    def result(self, i: int) -> object:
        return self.results()[i]


def evaluate_grid(spec: MemorySpec, axes: GridAxes, *, mesh=None,
                  device: "torch.device | str | None" = None) -> GridResult:
    """Evaluate one experiment cross-product in batched calls.

    Expands `axes` to its unit grid (params x policies x ops x
    engine-counts x arbitrations — placements share per-port units),
    evaluates every unit lane in batched calls on `device` (the card by
    default), and maps units back onto the point cross-product.  With
    `mesh` (a device list from ``launch.mesh.grid_mesh``) the unit batch
    is split over its devices, padding explicitly via ``shard_grid``.

    Point lane ``i`` corresponds to ``axes.sweep_points()[i]``; a
    per-point ``Sweep`` over those points matches within
    :data:`REL_TOLERANCE` of the NumPy path.
    """
    t0 = time.perf_counter()
    dev = None if mesh is not None else resolve_device(device)
    split = GridSplit()
    mappings = [get_mapping(spec, pol) for pol in axes.policies]
    for op in axes.ops:
        _direction_overheads(spec, op)   # validate ops eagerly
    for arb, bb in axes.arbitrations:
        _grant_beats(arb, bb, 1 << 30)   # validate pairs eagerly
    for p in axes.params:
        p.validate(spec)

    # Engine-counts needed per (N, placement), plus the per-port combine
    # recipe for non-same_channel placements.
    sw: Optional[SwitchModel] = None
    recipes: Dict[Tuple[int, str], Tuple[str, List[int]]] = {}
    needed = set()
    for n in axes.num_engines:
        for pl in axes.placements:
            if pl == "same_channel":
                recipes[(n, pl)] = (pl, [n])
                needed.add(n)
            else:
                sw = sw or _switch_for(spec)
                effective, counts = placement_port_counts(sw, pl, n)
                recipes[(n, pl)] = (effective, counts)
                needed.update(counts)
    ucounts = sorted(needed)
    cpos = {c: k for k, c in enumerate(ucounts)}

    # Unit grid: product(params, policies, ops, ucounts, arbitrations),
    # one lane each; host rows built per unit, then broadcast.
    unit_rows: List[Dict[str, object]] = []
    for p, mapping, op, c, (arb, bb) in itertools.product(
            axes.params, mappings, axes.ops, ucounts, axes.arbitrations):
        unit_rows.append(_unit_row(spec, (p, mapping, op, c, arb, bb)))
    split.prep_s += time.perf_counter() - t0
    out = _run_rows(spec, unit_rows, dev, mesh, split)

    # Map units onto points.  Unit flat index of (ip, ipol, iop, ic, ia):
    # (((ip*npol + ipol)*nop + iop)*ncnt + ic)*narb + ia.
    t1 = time.perf_counter()
    npm, npol, nop, nn, narb, npl = axes.shape
    ncnt = len(ucounts)
    ip = np.arange(npm).reshape(npm, 1, 1, 1, 1, 1)
    ipol = np.arange(npol).reshape(1, npol, 1, 1, 1, 1)
    iop = np.arange(nop).reshape(1, 1, nop, 1, 1, 1)
    ia = np.arange(narb).reshape(1, 1, 1, 1, narb, 1)
    base = (((ip * npol + ipol) * nop + iop) * ncnt)
    bound_tbl = np.array(_BOUND_NAMES)

    gbps = np.empty(axes.shape, dtype=np.float64)
    bound = np.empty(axes.shape, dtype=object)
    queueing = np.empty(axes.shape, dtype=np.float64)
    for j, n in enumerate(axes.num_engines):
        for k, pl in enumerate(axes.placements):
            effective, counts = recipes[(n, pl)]
            if pl == "same_channel":
                idx = ((base + cpos[n]) * narb + ia)[..., 0, :, 0]
                gbps[:, :, :, j, :, k] = out["gbps"][idx]
                bound[:, :, :, j, :, k] = bound_tbl[out["bidx"][idx]]
                queueing[:, :, :, j, :, k] = out["queueing"][idx]
                continue
            # Per-port combine, vectorized over the sub-grid: the count
            # multiset is fixed per (N, placement), so the capacity cap
            # and dominant-port choice are, too (engine.combine_placement
            # materializes the same recipe per point on results()).
            mult = {c: counts.count(c) for c in set(counts)}
            raw = np.zeros((npm, npol, nop, narb))
            qsum = np.zeros((npm, npol, nop, narb))
            for c, m in mult.items():
                idxc = ((base + cpos[c]) * narb + ia)[..., 0, :, 0]
                raw += m * out["gbps"][idxc]
                qsum += m * c * out["queueing"][idxc]
            dom = ((base + cpos[max(counts)]) * narb + ia)[..., 0, :, 0]
            bnd = bound_tbl[out["bidx"][dom]].astype(object)
            agg = raw.copy()
            cap = sw.capacity_cap_gbps(effective)
            if cap is not None:
                capped = raw > cap
                agg = np.where(capped, cap, raw)
                lateral = sw.topology.lateral_gbps
                name = ("lateral" if effective == "cross_switch"
                        and lateral is not None and cap == lateral
                        else "switch")
                bnd = np.where(capped, name, bnd)
            gbps[:, :, :, j, :, k] = agg
            bound[:, :, :, j, :, k] = bnd
            queueing[:, :, :, j, :, k] = qsum / n
    split.map_s += time.perf_counter() - t1

    def build() -> List[object]:
        res: List[object] = []
        for (ip_, _), (ipol_, _), (iop_, _), (_, n), \
                (ia_, (arb, bb)), (_, pl) in itertools.product(
                enumerate(axes.params), enumerate(axes.policies),
                enumerate(axes.ops), enumerate(axes.num_engines),
                enumerate(axes.arbitrations), enumerate(axes.placements)):

            def uidx(c: int) -> int:
                return ((((ip_ * npol + ipol_) * nop + iop_) * ncnt
                         + cpos[c]) * narb + ia_)

            if axes.kind == "throughput":
                res.append(_tp_result(spec, unit_rows, out, uidx(1)))
                continue
            effective, counts = recipes[(n, pl)]
            if pl == "same_channel":
                res.append(_cont_result(spec, unit_rows, out, uidx(n),
                                        arb, bb))
                continue
            per_count = {c: _cont_result(spec, unit_rows, out, uidx(c),
                                         arb, bb) for c in set(counts)}
            res.append(combine_placement(
                _switch_for(spec), pl, effective, n, counts, per_count,
                arbitration=arb, burst_beats=bb))
        return res

    return GridResult(spec=spec, axes=axes, gbps=gbps.reshape(-1),
                      bound=bound.reshape(-1),
                      queueing_delay_cycles=queueing.reshape(-1),
                      elapsed_seconds=time.perf_counter() - t0,
                      _builder=build, split=split)
