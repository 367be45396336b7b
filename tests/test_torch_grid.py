"""The port's grid tier (`repro_torch.core.timing_torch`, the `torchgrid`
backend, the Sweep prefill, `grid_cross_product` and the mesh helpers)
against the reference, on the CPU.

The cases are those of tests/core/test_timing_differential.py and
tests/core/test_grid_equivalence.py with `torchgrid` in the role of
`jaxgrid`.  The oracle is the reference's NumPy model
(`repro.core.timing_model`) or a per-point `repro.core.Sweep` on `sim`,
at rel 1e-9; the reference's `timing_jax` is never imported.  Each of
the tier's five entry points is also pinned against the port's own NumPy
model (`repro_torch.core.timing_model`), the pairing the port's
repro-lint (REPRO-O004) requires.  Bound
names are compared only away from ties (the three bounds tied within
1e-9), where float noise may pick either.
"""
import collections

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import timing_model as ref_tm
from repro.core.engine_mix import EngineMix as RefMix
from repro.core.experiments import run_experiment as ref_run
from repro_torch.core import timing_model as tm
from repro_torch.core import timing_torch as tt
from repro_torch.core.engine import TorchGridBackend
from repro_torch.core.engine_mix import EngineMix
from repro_torch.core.experiments import run_experiment as port_run
from repro_torch.launch.mesh import grid_mesh, grid_padding, shard_grid

REL = tt.REL_TOLERANCE
MB = 1024**2
SPECS = {"hbm": (port_core.HBM, ref_core.HBM),
         "ddr4": (port_core.DDR4, ref_core.DDR4)}
_DETAIL_BOUNDS = ("bus/ccd", "bank", "faw")


def _tied(res) -> bool:
    """The leading bound is within REL of another: either name is right."""
    vals = sorted(res.detail[b] for b in _DETAIL_BOUNDS)
    return vals[-1] - vals[-2] <= REL * abs(vals[-1])


def _assert_contention_close(got, want, case):
    assert got.aggregate_gbps == pytest.approx(want.aggregate_gbps,
                                               rel=REL), case
    if not _tied(want):
        assert got.bound == want.bound, case
    assert got.queueing_delay_cycles == pytest.approx(
        want.queueing_delay_cycles, rel=REL, abs=1e-9), case
    assert got.detail["total_acts"] == want.detail["total_acts"], case
    assert got.detail["txns"] == want.detail["txns"], case
    assert got.detail["mean_service_cycles"] == pytest.approx(
        want.detail["mean_service_cycles"], rel=REL, abs=1e-9), case
    for bound in _DETAIL_BOUNDS:
        assert got.detail[bound] == pytest.approx(want.detail[bound],
                                                  rel=REL), (bound, case)


def _both(spec_name, policy, kw):
    port_spec, ref_spec = SPECS[spec_name]
    return (port_spec, port_core.RSTParams(**kw),
            port_core.get_mapping(port_spec, policy),
            ref_spec, ref_core.RSTParams(**kw),
            ref_core.get_mapping(ref_spec, policy))


def _port_mix(entries):
    return EngineMix(tuple((port_core.RSTParams(**kw), op)
                           for kw, op in entries))


def _ref_mix(entries):
    return RefMix(tuple((ref_core.RSTParams(**kw), op)
                        for kw, op in entries))


@pytest.fixture
def cpu_torchgrid():
    """The registered `torchgrid` backend swapped for one that evaluates
    on the CPU, restored afterwards."""
    original = port_core.get_backend("torchgrid")
    port_core.register_backend(TorchGridBackend(device="cpu"),
                               override=True)
    try:
        yield
    finally:
        port_core.register_backend(original, override=True)


# ---------------------------------------------------------------------------
# Single points on every lane route (test_timing_differential.py's cases).
# ---------------------------------------------------------------------------

REGRESSION_CASES = [
    # (spec, policy, params kwargs, op, N, arbitration, burst_beats)
    # -- "full" lane: small streams, full expansion
    ("hbm", None, dict(n=512, b=32, s=128, w=0x1000000), "read",
     1, "round_robin", 1),
    ("hbm", None, dict(n=512, b=32, s=1024, w=8192), "write",
     4, "burst", 4),
    ("hbm", "RBC", dict(n=256, b=64, s=2048, w=0x100000), "duplex",
     2, "round_robin", 1),
    ("hbm", None, dict(n=300, b=32, s=64, w=0x1000000), "read",
     3, "burst", 3),          # non-pow2 N and burst
    ("hbm", None, dict(n=128, b=32, s=32, w=0x1000000), "read",
     2, "exclusive", 1),
    ("ddr4", None, dict(n=512, b=64, s=256, w=0x1000000), "read",
     2, "burst", 8),
    ("ddr4", "RCB", dict(n=512, b=128, s=4096, w=0x1000000), "write",
     4, "round_robin", 1),
    # -- "periodic" lane: exactly-periodic large streams
    ("hbm", None, dict(n=1 << 16, b=32, s=1024, w=4096), "read",
     1, "round_robin", 1),
    ("hbm", None, dict(n=1 << 16, b=32, s=1024, w=8192), "write",
     4, "burst", 4),
    ("hbm", "BRC", dict(n=1 << 16, b=32, s=1024, w=1024), "duplex",
     2, "burst", 2),
    ("ddr4", None, dict(n=1 << 16, b=64, s=2048, w=8192), "read",
     8, "burst", 8),
    # -- "numpy" lane: large stream, not periodic
    ("hbm", None, dict(n=1 << 15, b=32, s=1024, w=4096), "read",
     2, "exclusive", 1),
    ("hbm", None, dict(n=40_000, b=32, s=512, w=0x1000000), "read",
     4, "round_robin", 1),
]


@pytest.mark.parametrize(
    "spec_name,policy,kw,op,num_engines,arbitration,burst_beats",
    REGRESSION_CASES,
    ids=[f"{c[0]}_{c[1]}_n{c[2]['n']}_s{c[2]['s']}_{c[3]}_N{c[4]}_{c[5]}{c[6]}"
         for c in REGRESSION_CASES])
def test_contended_point_matches_reference(spec_name, policy, kw, op,
                                           num_engines, arbitration,
                                           burst_beats):
    port_spec, p, m, ref_spec, rp, rm = _both(spec_name, policy, kw)
    want = ref_tm.contended_throughput(
        rp, rm, ref_spec, num_engines=num_engines, op=op,
        arbitration=arbitration, burst_beats=burst_beats)
    got = tt.contended_throughput(
        p, m, port_spec, num_engines=num_engines, op=op,
        arbitration=arbitration, burst_beats=burst_beats, device="cpu")
    _assert_contention_close(got, want, (spec_name, policy, kw, op,
                                         num_engines, arbitration))


def test_regression_cases_cover_every_lane():
    lanes = set()
    for spec_name, policy, kw, op, num_engines, arb, bb in REGRESSION_CASES:
        spec = SPECS[spec_name][0]
        unit = (port_core.RSTParams(**kw),
                port_core.get_mapping(spec, policy), op, num_engines,
                arb, bb)
        lanes.add(tt._route(tt._unit_row(spec, unit)))
    assert lanes == {"full", "periodic", "numpy"}, lanes


@pytest.mark.parametrize("spec_name,policy,kw,op,num_engines,arb,bb", [
    c for c in REGRESSION_CASES if c[2]["n"] == 1 << 16])
def test_periodic_extrapolation_equals_full_expansion(spec_name, policy, kw,
                                                      op, num_engines, arb,
                                                      bb):
    """The steady-state lane (two windows, extrapolated) gives the same
    integers as expanding every command, and floats within REL."""
    spec = SPECS[spec_name][0]
    unit = (port_core.RSTParams(**kw), port_core.get_mapping(spec, policy),
            op, num_engines, arb, bb)
    row = tt._unit_row(spec, unit)
    assert row["periodic"]
    cpu = torch.device("cpu")
    ext = tt._run_batch(spec, [row], True, cpu)
    full = tt._run_batch(spec, [row], False, cpu)
    for k in ("acts", "cmds_total", "bidx"):
        assert ext[k][0] == full[k][0], k
    for k in ("gbps", "issue", "bank", "faw", "mean_service", "queueing",
              "head"):
        assert ext[k][0] == pytest.approx(full[k][0], rel=REL), k


TP_CASES = [
    ("hbm", None, dict(n=1024, b=32, s=128, w=0x1000000)),
    ("hbm", "RBC", dict(n=1024, b=32, s=1024, w=0x1000000)),
    ("hbm", None, dict(n=1024, b=32, s=4096, w=8192)),
    ("ddr4", None, dict(n=1024, b=64, s=128, w=0x1000000)),
    ("ddr4", "RBC", dict(n=1024, b=64, s=2048, w=0x1000000)),
]


@pytest.mark.parametrize("op", ["read", "write", "duplex"])
@pytest.mark.parametrize("spec_name,policy,kw", TP_CASES,
                         ids=[f"{c[0]}_{c[1]}_s{c[2]['s']}" for c in TP_CASES])
def test_throughput_matches_reference(spec_name, policy, kw, op):
    port_spec, p, m, ref_spec, rp, rm = _both(spec_name, policy, kw)
    want = ref_tm.throughput(rp, rm, ref_spec, op=op)
    got = tt.throughput(p, m, port_spec, op=op, device="cpu")
    assert got.gbps == pytest.approx(want.gbps, rel=REL)
    assert got.bound == want.bound
    assert got.detail["total_acts"] == want.detail["total_acts"]
    assert got.detail["txns"] == want.detail["txns"]
    for bound in _DETAIL_BOUNDS:
        assert got.detail[bound] == pytest.approx(want.detail[bound],
                                                  rel=REL), bound


# ---------------------------------------------------------------------------
# Heterogeneous engine mixes: both mixed lanes, and the uniform reduction.
# ---------------------------------------------------------------------------

MIX_CASES = [
    # (id, spec, policy, [(params kwargs, op), ...], arbitration, bb)
    # -- "mixfull" lane: equal counts and cmds/txn, small streams
    ("hbm_rw_rr", "hbm", None,
     [(dict(n=512, b=32, s=32, w=0x100000), "read"),
      (dict(n=512, b=32, s=32, w=0x100000), "write")],
     "round_robin", 1),
    ("hbm_3r1w_burst4", "hbm", None,
     [(dict(n=512, b=32, s=1024, w=0x100000), "read")] * 3
     + [(dict(n=512, b=32, s=1024, w=0x100000), "write")],
     "burst", 4),
    ("hbm_duplex_excl_rbc", "hbm", "RBC",
     [(dict(n=256, b=32, s=128, w=0x100000), "read"),
      (dict(n=256, b=32, s=2048, w=8192), "duplex")],
     "exclusive", 1),
    ("ddr4_rw_burst8", "ddr4", None,
     [(dict(n=512, b=64, s=64, w=0x100000), "read"),
      (dict(n=512, b=64, s=2048, w=0x100000), "write")],
     "burst", 8),
    # -- "mixnumpy" lane: ragged counts / mismatched cmds-per-txn
    ("hbm_ragged_counts", "hbm", None,
     [(dict(n=1024, b=32, s=128, w=0x100000), "read"),
      (dict(n=300, b=32, s=1024, w=8192), "write")],
     "round_robin", 1),
    ("hbm_ragged_cmds", "hbm", None,
     [(dict(n=512, b=32, s=128, w=0x100000), "read"),
      (dict(n=512, b=128, s=2048, w=0x100000), "write")],
     "burst", 2),
    ("hbm_big_stream", "hbm", None,
     [(dict(n=1 << 15, b=32, s=1024, w=0x1000000), "read"),
      (dict(n=1 << 15, b=32, s=1024, w=0x1000000), "write")],
     "round_robin", 1),
]


@pytest.mark.parametrize(
    "spec_name,policy,entries,arbitration,burst_beats",
    [c[1:] for c in MIX_CASES], ids=[c[0] for c in MIX_CASES])
def test_mix_point_matches_reference(spec_name, policy, entries,
                                     arbitration, burst_beats):
    port_spec, ref_spec = SPECS[spec_name]
    want = ref_tm.contended_throughput_mix(
        _ref_mix(entries), ref_core.get_mapping(ref_spec, policy), ref_spec,
        arbitration=arbitration, burst_beats=burst_beats)
    got = tt.contended_throughput_mix(
        _port_mix(entries), port_core.get_mapping(port_spec, policy),
        port_spec, arbitration=arbitration, burst_beats=burst_beats,
        device="cpu")
    _assert_contention_close(got, want, entries)
    assert got.detail["op_switch_cycles"] == pytest.approx(
        want.detail["op_switch_cycles"], rel=REL, abs=1e-9)


def test_mix_cases_cover_both_mix_lanes():
    lanes = set()
    for _id, spec_name, policy, entries, arb, bb in MIX_CASES:
        spec = SPECS[spec_name][0]
        unit = (_port_mix(entries), port_core.get_mapping(spec, policy),
                arb, bb)
        lanes.add(tt._route(tt._mix_row(spec, unit)))
    assert lanes == {"mixfull", "mixnumpy"}, lanes


def test_uniform_mix_routes_to_homogeneous_lanes():
    """A uniform EngineMix never reaches the mixed lanes: it delegates to
    the homogeneous path bit-identically."""
    p = port_core.RSTParams(n=512, b=32, s=128, w=0x1000000)
    m = port_core.get_mapping(port_core.HBM)
    mix = EngineMix.uniform(p, "read", 4)
    via_mix = tt.contended_throughput_mix(mix, m, port_core.HBM,
                                          device="cpu")
    homo = tt.contended_throughput(p, m, port_core.HBM, num_engines=4,
                                   device="cpu")
    assert via_mix.aggregate_gbps == homo.aggregate_gbps
    assert via_mix.bound == homo.bound
    assert via_mix.mix is None
    want = ref_tm.contended_throughput(
        ref_core.RSTParams(n=512, b=32, s=128, w=0x1000000),
        ref_core.get_mapping(ref_core.HBM), ref_core.HBM, num_engines=4)
    assert via_mix.aggregate_gbps == pytest.approx(want.aggregate_gbps,
                                                   rel=REL)


# ---------------------------------------------------------------------------
# evaluate_points: plain, mixed and placement requests.
# ---------------------------------------------------------------------------


def _ref_value(req):
    """The reference's per-point value of one request, through a
    per-point Sweep on `sim` (placements combined as the Engine does)."""
    spec = ref_core.HBM
    sw = ref_core.Sweep(spec, backend="sim")
    if req[0] == "tp":
        _, p, pol, op = req
        sw.add(ref_core.RSTParams(**p.__dict__), policy=pol, op=op)
    else:
        _, p, pol, op, n, arb, bb, pl = req[:8]
        mix = req[8] if len(req) > 8 else None
        rmix = None if mix is None else RefMix(tuple(
            (ref_core.RSTParams(**q.__dict__), o) for q, o in mix.entries))
        sw.add_contention(ref_core.RSTParams(**p.__dict__), policy=pol,
                          op=op, num_engines=n, arbitration=arb,
                          burst_beats=bb, placement=pl, mix=rmix)
    (res,) = sw.run()
    return res.value


def test_evaluate_points_matches_reference():
    p0 = port_core.RSTParams(n=512, b=32, s=128, w=0x1000000)
    p1 = port_core.RSTParams(n=512, b=32, s=2048, w=8192)
    mix = EngineMix(((p0, "read"), (p1, "write")))
    mix4 = EngineMix(((p0, "read"), (p0, "read"), (p1, "write"),
                      (p0, "duplex")))
    uni = EngineMix.uniform(p0, "read", 2)
    reqs = [
        ("tp", p0, None, "read"),
        ("tp", p1, "RBC", "write"),
        ("cont", p0, None, "read", 4, "burst", 4, "same_channel"),
        ("cont", p1, None, "duplex", 2, "round_robin", 1, "same_channel"),
        ("cont", p0, None, "read", 4, "round_robin", 1, "same_switch"),
        ("cont", p1, "RBC", "write", 3, "burst", 2, "cross_switch"),
        ("cont", p0, None, "read", 2, "round_robin", 1, "same_channel",
         mix),
        ("cont", p1, "RBC", "write", 2, "burst", 2, "same_channel", mix),
        ("cont", p0, None, "read", 2, "round_robin", 1, "same_channel",
         uni),
        ("cont", p0, None, "read", 4, "round_robin", 1, "same_switch",
         mix4),
        ("cont", p0, None, "read", 4, "exclusive", 1, "cross_switch",
         mix4),
    ]
    got = tt.evaluate_points(port_core.HBM, reqs, device="cpu")
    assert len(got) == len(reqs)
    for req, res in zip(reqs, got):
        want = _ref_value(req)
        if req[0] == "tp":
            assert res.gbps == pytest.approx(want.gbps, rel=REL), req
            assert res.bound == want.bound, req
            continue
        assert res.aggregate_gbps == pytest.approx(want.aggregate_gbps,
                                                   rel=REL), req
        assert res.bound == want.bound, req
        assert res.queueing_delay_cycles == pytest.approx(
            want.queueing_delay_cycles, rel=REL, abs=1e-9), req
        assert (res.mix is None) == (want.mix is None), req


def test_evaluate_points_fills_the_callers_split():
    """The split counts each distinct lane once, under the route
    `_route` gives its row, and every route of the HBM cases shows."""
    reqs, want = [], collections.Counter()
    for spec_name, policy, kw, op, n, arb, bb in REGRESSION_CASES:
        if spec_name != "hbm":
            continue
        p = port_core.RSTParams(**kw)
        reqs.append(("cont", p, policy, op, n, arb, bb, "same_channel"))
        want[tt._route(tt._unit_row(port_core.HBM, (
            p, port_core.get_mapping(port_core.HBM, policy), op, n, arb,
            bb)))] += 1
    for _id, spec_name, policy, entries, arb, bb in MIX_CASES:
        if spec_name != "hbm":
            continue
        mix = _port_mix(entries)
        reqs.append(("cont", mix.params[0], policy, "read", len(mix), arb,
                     bb, "same_channel", mix))
        want[tt._route(tt._mix_row(port_core.HBM, (
            mix, port_core.get_mapping(port_core.HBM, policy), arb,
            bb)))] += 1
    split = tt.GridSplit()
    got = tt.evaluate_points(port_core.HBM, reqs + reqs[:2], device="cpu",
                             split=split)
    assert split.routes == dict(want)
    assert set(split.routes) == set(tt._ROUTES)
    assert split.prep_s > 0 and split.device_s > 0
    assert split.host_lanes_s > 0       # the numpy and mixnumpy lanes
    assert [r.aggregate_gbps for r in got[-2:]] == [
        r.aggregate_gbps for r in got[:2]]


def test_evaluate_points_rejects_bad_requests():
    p = port_core.RSTParams(n=64, b=32, s=64, w=0x10000)
    with pytest.raises(ValueError, match="num_engines"):
        tt.evaluate_points(port_core.HBM, [
            ("cont", p, None, "read", 0, "round_robin", 1, "same_channel")],
            device="cpu")
    with pytest.raises(ValueError, match="placement"):
        tt.evaluate_points(port_core.HBM, [
            ("cont", p, None, "read", 2, "round_robin", 1, "nowhere")],
            device="cpu")
    with pytest.raises(ValueError, match="request kind"):
        tt.evaluate_points(port_core.HBM, [("lat", p)], device="cpu")
    assert tt.evaluate_points(port_core.HBM, [], device="cpu") == []


# ---------------------------------------------------------------------------
# Every entry point against the port's own NumPy model.
# ---------------------------------------------------------------------------


def _port_value(req):
    """The port's NumPy model on one same-channel request of
    `evaluate_points`."""
    spec = port_core.HBM
    m = port_core.get_mapping(spec, req[2])
    if req[0] == "tp":
        return tm.throughput(req[1], m, spec, op=req[3])
    _, p, _, op, n, arb, bb, _ = req[:8]
    if len(req) > 8:
        return tm.contended_throughput_mix(req[8], m, spec,
                                           arbitration=arb, burst_beats=bb)
    return tm.contended_throughput(p, m, spec, num_engines=n, op=op,
                                   arbitration=arb, burst_beats=bb)


@pytest.mark.parametrize("op", ["read", "write", "duplex"])
@pytest.mark.parametrize("spec_name,policy,kw", TP_CASES,
                         ids=[f"{c[0]}_{c[1]}_s{c[2]['s']}" for c in TP_CASES])
def test_throughput_matches_port_model(spec_name, policy, kw, op):
    spec, p, m = _both(spec_name, policy, kw)[:3]
    want = tm.throughput(p, m, spec, op=op)
    got = tt.throughput(p, m, spec, op=op, device="cpu")
    assert got.gbps == pytest.approx(want.gbps, rel=REL)
    assert got.bound == want.bound
    assert got.detail["total_acts"] == want.detail["total_acts"]


@pytest.mark.parametrize(
    "spec_name,policy,kw,op,num_engines,arbitration,burst_beats",
    REGRESSION_CASES,
    ids=[f"{c[0]}_{c[1]}_n{c[2]['n']}_s{c[2]['s']}_{c[3]}_N{c[4]}_{c[5]}{c[6]}"
         for c in REGRESSION_CASES])
def test_contended_point_matches_port_model(spec_name, policy, kw, op,
                                            num_engines, arbitration,
                                            burst_beats):
    spec, p, m = _both(spec_name, policy, kw)[:3]
    axes = dict(num_engines=num_engines, op=op, arbitration=arbitration,
                burst_beats=burst_beats)
    want = tm.contended_throughput(p, m, spec, **axes)
    got = tt.contended_throughput(p, m, spec, device="cpu", **axes)
    _assert_contention_close(got, want, (spec_name, kw, axes))


@pytest.mark.parametrize(
    "spec_name,policy,entries,arbitration,burst_beats",
    [c[1:] for c in MIX_CASES], ids=[c[0] for c in MIX_CASES])
def test_mix_point_matches_port_model(spec_name, policy, entries,
                                      arbitration, burst_beats):
    spec = SPECS[spec_name][0]
    m = port_core.get_mapping(spec, policy)
    axes = dict(arbitration=arbitration, burst_beats=burst_beats)
    want = tm.contended_throughput_mix(_port_mix(entries), m, spec, **axes)
    got = tt.contended_throughput_mix(_port_mix(entries), m, spec,
                                      device="cpu", **axes)
    _assert_contention_close(got, want, entries)
    assert got.detail["op_switch_cycles"] == pytest.approx(
        want.detail["op_switch_cycles"], rel=REL, abs=1e-9)


def test_evaluate_points_matches_port_model():
    p0 = port_core.RSTParams(n=512, b=32, s=128, w=0x1000000)
    p1 = port_core.RSTParams(n=512, b=32, s=2048, w=8192)
    mix = EngineMix(((p0, "read"), (p1, "write")))
    reqs = [
        ("tp", p0, None, "read"),
        ("tp", p1, "RBC", "duplex"),
        ("cont", p0, None, "read", 4, "burst", 4, "same_channel"),
        ("cont", p1, "RBC", "write", 3, "round_robin", 1, "same_channel"),
        ("cont", p0, None, "read", 2, "exclusive", 1, "same_channel", mix),
    ]
    got = tt.evaluate_points(port_core.HBM, reqs, device="cpu")
    for req, res in zip(reqs, got):
        want = _port_value(req)
        if req[0] == "tp":
            assert res.gbps == pytest.approx(want.gbps, rel=REL), req
        else:
            assert res.aggregate_gbps == pytest.approx(
                want.aggregate_gbps, rel=REL), req
            assert res.queueing_delay_cycles == pytest.approx(
                want.queueing_delay_cycles, rel=REL, abs=1e-9), req
        assert res.bound == want.bound, req


def test_evaluate_grid_matches_port_model():
    axes_kw = dict(_small_axes(port_core.RSTParams),
                   placements=("same_channel",))
    axes = tt.GridAxes(**axes_kw)
    grid = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
    for i, pt in enumerate(axes.sweep_points()):
        want = tm.contended_throughput(
            pt.params, port_core.get_mapping(port_core.HBM, pt.policy),
            port_core.HBM, num_engines=pt.num_engines, op=pt.op,
            arbitration=pt.arbitration, burst_beats=pt.burst_beats)
        assert grid.gbps[i] == pytest.approx(want.aggregate_gbps,
                                             rel=REL), (i, pt)
        assert grid.bound[i] == want.bound, (i, pt)


# ---------------------------------------------------------------------------
# evaluate_grid against per-point Sweeps (test_grid_equivalence.py).
# ---------------------------------------------------------------------------


def _small_axes(params_cls):
    return dict(
        params=tuple(params_cls(n=512, b=32, s=64 << i, w=16 * MB)
                     for i in range(3)),
        policies=(None, "RBC"),
        ops=("read", "write"),
        num_engines=(1, 2, 4),
        arbitrations=(("round_robin", 1), ("burst", 4)),
        placements=("same_channel", "same_switch", "cross_switch"))


def _ref_sweep(axes_kw, kind="contention"):
    """Per-point reference values over the same cross-product, in lane
    order, through `repro.core.Sweep(backend="sim")`."""
    import itertools
    sw = ref_core.Sweep(ref_core.HBM, backend="sim")
    for p, pol, op, n, (arb, bb), pl in itertools.product(
            axes_kw["params"], axes_kw["policies"], axes_kw["ops"],
            axes_kw.get("num_engines", (1,)),
            axes_kw.get("arbitrations", (("round_robin", 1),)),
            axes_kw.get("placements", ("same_channel",))):
        if kind == "throughput":
            sw.add(p, policy=pol, op=op)
        else:
            sw.add_contention(p, policy=pol, op=op, num_engines=n,
                              arbitration=arb, burst_beats=bb, placement=pl)
    return sw.run()


class TestGridMatchesPerPointSweep:
    def test_element_for_element_vs_reference_sim(self):
        axes = tt.GridAxes(**_small_axes(port_core.RSTParams))
        grid = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
        swept = _ref_sweep(_small_axes(ref_core.RSTParams))
        assert grid.size == len(swept) == axes.size
        pts = axes.sweep_points()
        for i, sr in enumerate(swept):
            assert (pts[i].num_engines, pts[i].placement, pts[i].op) == (
                sr.point.num_engines, sr.point.placement, sr.point.op)
            assert grid.gbps[i] == pytest.approx(
                sr.value.aggregate_gbps, rel=REL), (i, pts[i])
            assert grid.bound[i] == sr.value.bound, (i, pts[i])
            assert grid.queueing_delay_cycles[i] == pytest.approx(
                sr.value.queueing_delay_cycles, rel=REL, abs=1e-9)

    def test_element_for_element_vs_torchgrid_sweep(self, cpu_torchgrid):
        axes = tt.GridAxes(**_small_axes(port_core.RSTParams))
        grid = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
        sw = port_core.Sweep(port_core.HBM, backend="torchgrid")
        for pt in axes.sweep_points():
            sw.add_point(pt)
        for i, sr in enumerate(sw.run()):
            assert grid.gbps[i] == pytest.approx(
                sr.value.aggregate_gbps, rel=1e-12), i

    def test_lazy_results_match_flat_arrays(self):
        axes = tt.GridAxes(**_small_axes(port_core.RSTParams))
        grid = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
        res = grid.results()
        assert len(res) == grid.size
        assert grid.result(5) is res[5]
        for i, r in enumerate(res):
            assert r.aggregate_gbps == pytest.approx(grid.gbps[i],
                                                     rel=1e-12)
            assert r.bound == grid.bound[i]

    def test_throughput_kind_matches_reference(self):
        def kw(params_cls):
            return dict(
                params=tuple(params_cls(n=512, b=32, s=128 << i, w=16 * MB)
                             for i in range(3)),
                policies=(None,) + tuple(
                    port_core.policies_for(port_core.HBM))[:2],
                ops=("read", "write", "duplex"))
        axes = tt.GridAxes(**kw(port_core.RSTParams), kind="throughput")
        grid = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
        swept = _ref_sweep(kw(ref_core.RSTParams), kind="throughput")
        for i, sr in enumerate(swept):
            assert grid.gbps[i] == pytest.approx(sr.value.gbps, rel=REL), i
            assert grid.bound[i] == sr.value.bound, i
        assert grid.results()[0].gbps == pytest.approx(grid.gbps[0],
                                                       rel=1e-12)

    def test_split_counts_every_lane(self):
        axes = tt.GridAxes(**_small_axes(port_core.RSTParams))
        grid = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
        # 3 params x 2 policies x 2 ops x engine counts {1, 2, 4} x 2 arbs.
        assert sum(grid.split.routes.values()) == 3 * 2 * 2 * 3 * 2
        assert grid.split.prep_s > 0 and grid.split.device_s > 0
        assert grid.points_per_second > 0


def test_grid_axes_validate():
    p = port_core.RSTParams(n=64, b=32, s=64, w=0x10000)
    with pytest.raises(ValueError, match="grid kind"):
        tt.GridAxes(params=(p,), kind="latency")
    with pytest.raises(ValueError, match="at least one"):
        tt.GridAxes(params=())
    with pytest.raises(ValueError, match="fix the contention axes"):
        tt.GridAxes(params=(p,), num_engines=(2,), kind="throughput")
    with pytest.raises(ValueError, match="num_engines"):
        tt.GridAxes(params=(p,), num_engines=(0,))
    with pytest.raises(ValueError, match="placement"):
        tt.GridAxes(params=(p,), placements=("nowhere",))


def test_grid_acceptance_ten_thousand_points():
    """A >=10,000-point cross-product matches the reference's per-point
    Sweep on `sim` within rel 1e-9 everywhere."""
    def kw(params_cls):
        return dict(
            params=tuple(params_cls(n=256, b=32, s=64 << (i % 5),
                                    w=MB << (i // 5)) for i in range(25)),
            policies=(None,) + tuple(
                port_core.policies_for(port_core.HBM)),
            ops=("read", "write", "duplex"),
            num_engines=(1, 2, 4),
            arbitrations=(("round_robin", 1), ("burst", 2), ("burst", 8)),
            placements=("same_channel", "same_switch", "cross_switch"))
    axes = tt.GridAxes(**kw(port_core.RSTParams))
    assert axes.size >= 10_000
    grid = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
    swept = _ref_sweep(kw(ref_core.RSTParams))
    want = np.array([sr.value.aggregate_gbps for sr in swept])
    np.testing.assert_allclose(grid.gbps, want, rtol=REL)
    want_q = np.array([sr.value.queueing_delay_cycles for sr in swept])
    np.testing.assert_allclose(grid.queueing_delay_cycles, want_q,
                               rtol=REL, atol=1e-9)
    bounds = np.array([sr.value.bound for sr in swept])
    assert (grid.bound == bounds).all()


def test_lane_chunking_matches_one_batch(monkeypatch):
    """Wide batches split into lane chunks give the unchunked answer."""
    axes = tt.GridAxes(**_small_axes(port_core.RSTParams))
    whole = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
    monkeypatch.setattr(tt, "_LANE_SLOT_BUDGET", 4 * 512)
    chunked = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
    np.testing.assert_array_equal(chunked.gbps, whole.gbps)
    np.testing.assert_array_equal(chunked.bound, whole.bound)


# ---------------------------------------------------------------------------
# The backend, the Sweep prefill and the experiment.
# ---------------------------------------------------------------------------


def test_torchgrid_backend_capabilities():
    be = port_core.get_backend("torchgrid")
    assert isinstance(be, TorchGridBackend)
    assert port_core.available_backends() == ["sim", "cuda", "torchgrid"]
    assert (be.deterministic, be.supports_grid, be.supports_contention,
            be.supports_latency) == (True, True, True, False)
    assert be.device is None        # the card, unless asked otherwise
    with pytest.raises(port_core.UnsupportedCapability, match="torchgrid"):
        TorchGridBackend(device="cpu").latency(
            port_core.HBM, port_core.RSTParams(n=8, b=32, s=64, w=4096),
            port_core.get_mapping(port_core.HBM), switch_enabled=False,
            switch_extra_cycles=0)


def test_entry_points_need_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = port_core.RSTParams(n=64, b=32, s=64, w=0x10000)
    m = port_core.get_mapping(port_core.HBM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.throughput(p, m, port_core.HBM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.evaluate_grid(port_core.HBM, tt.GridAxes(params=(p,)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_core.Sweep(port_core.HBM, backend="torchgrid").add(p).run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grid_mesh()


def test_sweep_prefill_reports_uncached_first_serve(cpu_torchgrid):
    p = port_core.RSTParams(n=512, b=32, s=128, w=0x1000000)
    q = port_core.RSTParams(n=512, b=32, s=1024, w=8192)
    sw = port_core.Sweep(port_core.HBM, backend="torchgrid")
    sw.add(p).add(p, op="write").add(p)
    sw.add_contention(q, num_engines=4, arbitration="burst", burst_beats=4)
    sw.add_contention(q, num_engines=4, arbitration="burst", burst_beats=4)
    sw.add_contention(q, num_engines=2, placement="cross_switch")
    first = sw.run()
    assert [r.cached for r in first] == [False, False, True, False, True,
                                         False]
    assert sw.stats.evaluated == 4          # distinct keys, one batch
    again = sw.run()
    assert all(r.cached for r in again)
    assert sw.stats.evaluated == 4
    ref = ref_core.Sweep(ref_core.HBM, backend="sim")
    rp = ref_core.RSTParams(n=512, b=32, s=128, w=0x1000000)
    rq = ref_core.RSTParams(n=512, b=32, s=1024, w=8192)
    ref.add(rp).add(rp, op="write").add(rp)
    ref.add_contention(rq, num_engines=4, arbitration="burst",
                       burst_beats=4)
    ref.add_contention(rq, num_engines=4, arbitration="burst",
                       burst_beats=4)
    ref.add_contention(rq, num_engines=2, placement="cross_switch")
    for got, want in zip(first, ref.run()):
        assert got.cached == want.cached
        g = getattr(got.value, "aggregate_gbps", None) or got.value.gbps
        w = getattr(want.value, "aggregate_gbps", None) or want.value.gbps
        assert g == pytest.approx(w, rel=REL)


@pytest.mark.parametrize("spec_name", ["hbm", "ddr4"])
def test_grid_cross_product_matches_reference(cpu_torchgrid, spec_name):
    port_spec, ref_spec = SPECS[spec_name]
    want = ref_run("grid_cross_product", ref_spec, "sim", quick=True)
    for backend in ("torchgrid", "sim"):
        got = port_run("grid_cross_product", port_spec, backend, quick=True)
        assert got["points"] == want["points"]
        assert list(got["gbps"]) == list(want["gbps"])
        for k, v in want["gbps"].items():
            assert got["gbps"][k] == pytest.approx(v, rel=REL), k
        assert got["best"]["key"] == want["best"]["key"]
        assert got["worst"]["key"] == want["worst"]["key"]
    exp = port_core.get_experiment("grid_cross_product")
    assert exp.summary(port_spec, got) == ref_core.get_experiment(
        "grid_cross_product").summary(ref_spec, want)


# ---------------------------------------------------------------------------
# Mesh helpers (tests/launch/test_mesh.py) and the sharded grid.
# ---------------------------------------------------------------------------


class TestGridPadding:
    def test_divisible_needs_no_padding(self):
        assert grid_padding(16, 8) == 0
        assert grid_padding(8, 8) == 0
        assert grid_padding(5, 1) == 0

    def test_remainder_pad_count(self):
        assert grid_padding(27, 8) == 5
        assert grid_padding(9, 8) == 7
        assert grid_padding(1, 8) == 7

    def test_remainder_errors_when_pad_disabled(self):
        with pytest.raises(ValueError) as exc:
            grid_padding(27, 8, pad=False)
        msg = str(exc.value)
        assert "27" in msg and "8" in msg
        assert "remainder 3" in msg
        assert "5 repeated rows" in msg

    def test_rejects_degenerate_inputs(self):
        with pytest.raises(ValueError):
            grid_padding(0, 8)
        with pytest.raises(ValueError):
            grid_padding(8, 0)


class TestShardGrid:
    def test_27_rows_over_8_cpu_parts(self):
        mesh = grid_mesh(8, device="cpu")
        assert mesh == [torch.device("cpu")] * 8
        arr = np.arange(27 * 3, dtype=np.float64).reshape(27, 3)
        parts, extra = shard_grid(arr, mesh)
        assert extra == grid_padding(27, 8) == 5
        assert [tuple(t.shape) for t in parts] == [(4, 3)] * 8
        host = torch.cat(parts).numpy()
        np.testing.assert_array_equal(host[:27], arr)
        np.testing.assert_array_equal(host[27:],
                                      np.repeat(arr[-1:], 5, axis=0))
        with pytest.raises(ValueError, match="remainder 3"):
            shard_grid(arr, mesh, pad=False)

    def test_round_trips_divisible_array(self):
        arr = np.arange(12, dtype=np.float64).reshape(6, 2)
        parts, extra = shard_grid(arr, grid_mesh(device="cpu"))
        assert extra == 0 and len(parts) == 1
        np.testing.assert_array_equal(parts[0].numpy(), arr)

    def test_scalar_rejected(self):
        with pytest.raises(ValueError):
            shard_grid(np.float64(3.0), grid_mesh(device="cpu"))

    def test_mesh_size_validated(self):
        with pytest.raises(ValueError):
            grid_mesh(0, device="cpu")


def test_sharded_grid_equals_unsharded():
    """evaluate_grid over an 8-part CPU mesh equals the unsharded
    evaluation, with 27 unit lanes (3 params x 3 ops x 3 counts), which do
    not divide 8 (the explicit pad path)."""
    axes = tt.GridAxes(
        params=tuple(port_core.RSTParams(n=512, b=32, s=64 << i,
                                         w=16 * MB) for i in range(3)),
        ops=("read", "write", "duplex"),
        num_engines=(1, 2, 4),
        placements=("same_channel", "same_switch", "cross_switch"))
    base = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
    assert sum(base.split.routes.values()) == 27
    sharded = tt.evaluate_grid(port_core.HBM, axes,
                               mesh=grid_mesh(8, device="cpu"))
    np.testing.assert_allclose(sharded.gbps, base.gbps, rtol=1e-12)
    np.testing.assert_array_equal(sharded.bound, base.bound)
    np.testing.assert_allclose(sharded.queueing_delay_cycles,
                               base.queueing_delay_cycles,
                               rtol=1e-12, atol=1e-12)
    mix = EngineMix.from_spec("2r+1w+1d", port_core.RSTParams(
        n=256, b=32, s=64, w=MB))
    req = [("cont", mix.params[0], None, "read", 4, "round_robin", 1,
            "same_channel", mix)]
    one = tt.evaluate_points(port_core.HBM, req, device="cpu")[0]
    split = tt.evaluate_points(port_core.HBM, req,
                               mesh=grid_mesh(8, device="cpu"))[0]
    assert split.aggregate_gbps == one.aggregate_gbps


# ---------------------------------------------------------------------------
# On the card only: every evaluator route equals the CPU evaluation.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_evaluation_equals_cpu(cuda_device):
    axes = tt.GridAxes(**_small_axes(port_core.RSTParams))
    card = tt.evaluate_grid(port_core.HBM, axes, device=cuda_device)
    host = tt.evaluate_grid(port_core.HBM, axes, device="cpu")
    assert card.split.device_s > 0
    np.testing.assert_allclose(card.gbps, host.gbps, rtol=REL)
    np.testing.assert_allclose(card.queueing_delay_cycles,
                               host.queueing_delay_cycles, rtol=REL,
                               atol=1e-9)
    assert (card.bound == host.bound).all()
    for spec_name, policy, kw, op, n, arb, bb in REGRESSION_CASES:
        spec, p, m = _both(spec_name, policy, kw)[:3]
        got = tt.contended_throughput(p, m, spec, num_engines=n, op=op,
                                      arbitration=arb, burst_beats=bb,
                                      device=cuda_device)
        want = tt.contended_throughput(p, m, spec, num_engines=n, op=op,
                                       arbitration=arb, burst_beats=bb,
                                       device="cpu")
        _assert_contention_close(got, want, kw)
    for _id, spec_name, policy, entries, arb, bb in MIX_CASES:
        spec = SPECS[spec_name][0]
        m = port_core.get_mapping(spec, policy)
        got, want = (tt.contended_throughput_mix(
            _port_mix(entries), m, spec, arbitration=arb, burst_beats=bb,
            device=d) for d in (cuda_device, "cpu"))
        _assert_contention_close(got, want, _id)
