"""The port's host-side core (repro_torch.core) against the reference
(repro.core): spec and policy registries, address decoding, RST block
terms, topology tables, engine mixes, latency anchors and the timing
model.  Integers must be equal, floats equal to rel 1e-9.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import engine_mix as ref_mix
from repro.core import timing_model as ref_tm
from repro_torch.core import engine as port_engine
from repro_torch.core import engine_mix as port_mix
from repro_torch.core import timing_model as port_tm

REL = 1e-9
SPEC_NAMES = ("hbm", "ddr4", "hbm3", "ddr3")


def assert_same(got, want, path="result"):
    """Recursive equality of a port result and a reference result:
    dataclasses by field name (the two packages have their own classes),
    ints and strings exactly, floats to rel 1e-9, arrays elementwise."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert dataclasses.is_dataclass(got), f"{path}: {got!r}"
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name),
                        f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert isinstance(got, dict), f"{path}: {type(got)}"
        assert list(got) == [k for k in want] or set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), f"{path}: {type(got)}"
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, path
        if want.dtype.kind in "fc":
            np.testing.assert_allclose(got, want, rtol=REL, atol=0,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (float, np.floating)):
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert got == pytest.approx(want, rel=REL, abs=0), path
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


def spec_pair(name):
    return port_core.spec_by_name(name), ref_core.spec_by_name(name)


def params_pair(**kw):
    return port_core.RSTParams(**kw), ref_core.RSTParams(**kw)


def mapping_pairs():
    for name in SPEC_NAMES:
        ps, rs = spec_pair(name)
        for policy in [None] + list(ref_core.policies_for(rs)):
            yield name, policy


# ---------------------------------------------------------------- registries


def test_registries_match():
    assert port_core.available_specs() == ref_core.available_specs()
    for name in SPEC_NAMES:
        ps, rs = spec_pair(name)
        assert_same(ps, rs, name)
        assert list(port_core.policies_for(ps)) == list(
            ref_core.policies_for(rs))
    assert port_core.available_topologies() == ref_core.available_topologies()


@pytest.mark.parametrize("name,policy", list(mapping_pairs()))
def test_decoded_addresses_match(name, policy):
    ps, rs = spec_pair(name)
    pm, rm = port_core.get_mapping(ps, policy), ref_core.get_mapping(rs, policy)
    assert_same(pm, rm, f"{name}/{policy}")
    rng = np.random.default_rng(7)
    addrs = rng.integers(0, 1 << 33, size=512, dtype=np.int64)
    assert_same(pm.decode(addrs), rm.decode(addrs))
    np.testing.assert_array_equal(pm.bank_id(addrs), rm.bank_id(addrs))


@pytest.mark.parametrize("b,s,w,a,n", [
    (64, 64, 1 << 20, 0, 100), (4096, 8192, 1 << 16, 4096 * 3, 9),
    (32, 1 << 20, 1 << 20, 0, 7), (256, 64, 1 << 12, 128, 300)])
def test_block_params_and_addresses_match(b, s, w, a, n):
    pp, rp = params_pair(n=n, b=b, s=s, w=w, a=a)
    assert pp.period == rp.period and pp.pack() == rp.pack()
    for tile in (64, 4096):
        assert port_core.block_params(pp, tile) == ref_core.block_params(
            rp, tile)
    np.testing.assert_array_equal(port_core.addresses_np(pp),
                                  ref_core.addresses_np(rp))
    np.testing.assert_array_equal(
        port_core.addresses_torch(pp, n, device="cpu").numpy(),
        ref_core.addresses_np(rp, n))


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_topology_tables_match(name):
    ps, rs = spec_pair(name)
    pt, rt = port_core.topology_for(ps), ref_core.topology_for(rs)
    assert_same(pt, rt, name)
    chans = range(rt.num_axi_channels)
    for src in chans:
        for dst in range(rt.num_pseudo_channels):
            assert (pt.crossing_extra_cycles(src, dst)
                    == rt.crossing_extra_cycles(src, dst))
    psw = port_core.SwitchModel(pt, enabled=True)
    rsw = ref_core.SwitchModel(rt, enabled=True)
    for placement in ref_core.PLACEMENTS:
        assert psw.capacity_cap_gbps(placement) == rsw.capacity_cap_gbps(
            placement)
    for src in chans:
        assert (psw.throughput_scale(src, 0) == rsw.throughput_scale(src, 0))
        assert (psw.total_extra_cycles(src, 0)
                == rsw.total_extra_cycles(src, 0))


@pytest.mark.parametrize("text", ["3r+1w", "2r+1w+1d", "4d", "1r", "r",
                                  "2x", "0r", "2r++1w", ""])
def test_engine_mix_parse_matches(text):
    try:
        want = ref_mix.parse_mix_spec(text)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            port_mix.parse_mix_spec(text)
        assert str(ei.value) == str(e)
        return
    assert port_mix.parse_mix_spec(text) == want
    pp, rp = params_pair(n=64, b=64, s=64, w=1 << 16)
    pm = port_mix.EngineMix.from_spec(text, pp)
    rm = ref_mix.EngineMix.from_spec(text, rp)
    assert pm.describe() == rm.describe() and pm.ops == rm.ops
    for n in (1, 3):
        assert_same(port_mix.normalize_mix(pm, pp, "read", n),
                    ref_mix.normalize_mix(rm, rp, "read", n))
    assert_same(port_mix.normalize_mix(
        port_mix.EngineMix.uniform(pp, "write", 3), pp, "read", 1),
        ref_mix.normalize_mix(
            ref_mix.EngineMix.uniform(rp, "write", 3), rp, "read", 1))


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_latency_anchors_match(name):
    ps, rs = spec_pair(name)
    for op in ("read", "write", "duplex"):
        pl = port_core.LatencyModule(op=op)
        rl = ref_core.LatencyModule(op=op)
        for extra in (0, 5, 22):
            assert_same(pl.anchors(ps, extra), rl.anchors(rs, extra))
            assert_same(pl.contended_anchors(ps, 3.5, extra),
                        rl.contended_anchors(rs, 3.5, extra))
        captured = np.array([pl.anchors(ps)["hit"]] * 5 + [200, 255],
                            dtype=np.int64)
        assert_same(pl.classify(captured, ps), rl.classify(captured, rs))


# -------------------------------------------------------------- timing model


def _model_params():
    return [dict(n=512, b=b, s=s, w=w)
            for b, s, w in ((64, 64, 1 << 20), (64, 1024, 1 << 24),
                            (256, 4096, 0x10000000), (32, 128, 8192))]


@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("op", ["read", "write", "duplex"])
def test_throughput_matches(name, op):
    ps, rs = spec_pair(name)
    for kw in _model_params():
        if kw["b"] < rs.min_burst:
            continue
        pp, rp = params_pair(**kw)
        for policy in [None] + list(ref_core.policies_for(rs))[:2]:
            assert_same(
                port_tm.throughput(pp, port_core.get_mapping(ps, policy), ps,
                                   op=op),
                ref_tm.throughput(rp, ref_core.get_mapping(rs, policy), rs,
                                  op=op))


@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("op,switch,engines,arb,bb", [
    ("read", False, 1, "round_robin", 1), ("write", True, 1, "round_robin", 1),
    ("read", False, 4, "burst", 4), ("read", True, 2, "exclusive", 1)])
def test_serial_latencies_match(name, op, switch, engines, arb, bb):
    ps, rs = spec_pair(name)
    pp, rp = params_pair(n=600, b=rs.min_burst, s=64, w=0x1000000)
    kw = dict(op=op, switch_enabled=switch,
              switch_extra_cycles=5 if switch else 0, num_engines=engines,
              arbitration=arb, burst_beats=bb)
    pt = port_tm.serial_latencies(pp, port_core.get_mapping(ps), ps, **kw)
    rt = ref_tm.serial_latencies(rp, ref_core.get_mapping(rs), rs, **kw)
    assert_same(pt, rt)
    assert port_tm.refresh_interval_estimate(pt, ps) == pytest.approx(
        ref_tm.refresh_interval_estimate(rt, rs), rel=REL)


@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("engines,arb,bb,op", [
    (1, "round_robin", 1, "read"), (4, "round_robin", 1, "write"),
    (4, "burst", 8, "read"), (3, "exclusive", 1, "duplex")])
def test_contended_throughput_matches(name, engines, arb, bb, op):
    ps, rs = spec_pair(name)
    pp, rp = params_pair(n=256, b=rs.min_burst, s=rs.min_burst, w=1 << 20)
    kw = dict(num_engines=engines, op=op, arbitration=arb, burst_beats=bb)
    assert_same(
        port_tm.contended_throughput(pp, port_core.get_mapping(ps), ps, **kw),
        ref_tm.contended_throughput(rp, ref_core.get_mapping(rs), rs, **kw))


@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("text", ["3r+1w", "2r+1w+1d"])
def test_contended_mix_matches(name, text):
    ps, rs = spec_pair(name)
    pp, rp = params_pair(n=256, b=rs.min_burst, s=rs.min_burst, w=1 << 20)
    pm = port_mix.EngineMix.from_spec(text, pp)
    rm = ref_mix.EngineMix.from_spec(text, rp)
    for arb, bb in (("round_robin", 1), ("burst", 4)):
        assert_same(
            port_tm.contended_throughput_mix(pm, port_core.get_mapping(ps),
                                             ps, arbitration=arb,
                                             burst_beats=bb),
            ref_tm.contended_throughput_mix(rm, ref_core.get_mapping(rs), rs,
                                            arbitration=arb, burst_beats=bb))


# ------------------------------------------------------------------ engines


def test_backend_registry_and_capabilities():
    assert port_core.available_backends()[:2] == ["sim", "cuda"]
    be = port_core.get_backend("cuda")
    assert isinstance(be, port_core.CudaBackend)
    ref = ref_core.get_backend("pallas")
    assert (be.deterministic, be.supports_latency,
            be.supports_contention) == (ref.deterministic,
                                        ref.supports_latency,
                                        ref.supports_contention) == (
        False, False, True)
    pp, _ = params_pair(n=16, b=4096, s=4096, w=16 * 4096)
    with pytest.raises(ValueError, match="read traffic only"):
        be.contended_throughput(port_core.HBM, pp, None, num_engines=2,
                                op="write")
    with pytest.raises(port_core.UnsupportedCapability, match="'cuda'"):
        be.latency(port_core.HBM, pp, None, switch_enabled=False,
                   switch_extra_cycles=0, mix=None)
    with pytest.raises(ValueError, match="unknown op"):
        be.throughput(port_core.HBM, pp, None, op="scribble")


def test_classify_backend_error_cuda_markers():
    classify = port_engine.classify_backend_error
    transient = port_engine.TransientBackendError
    permanent = port_engine.PermanentBackendError
    assert classify(torch.cuda.OutOfMemoryError("CUDA out of memory.")) \
        is transient
    assert classify(RuntimeError("CUDA error: out of memory")) is transient
    assert classify(RuntimeError(
        "CUDA error: the launch timed out and was terminated")) is transient
    assert classify(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) is permanent
    assert classify(RuntimeError("out of memory")) is permanent
    assert classify(ValueError("bad")) is permanent
    assert classify(TimeoutError()) is transient
    assert classify(port_core.UnsupportedCapability("x")) \
        is port_core.UnsupportedCapability


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_engine_evaluate_matches(name):
    ps, rs = spec_pair(name)
    pe = port_core.Engine(channel=0, spec=ps)
    re_ = ref_core.Engine(channel=0, spec=rs)
    pp, rp = params_pair(n=256, b=rs.min_burst, s=rs.min_burst, w=1 << 20)
    dst = 3 if rs.has_switch else None
    assert_same(pe.evaluate_throughput(pp, dst_channel=dst, op="duplex"),
                re_.evaluate_throughput(rp, dst_channel=dst, op="duplex"))
    for placement in ref_core.PLACEMENTS:
        assert_same(
            pe.evaluate_contention(pp, num_engines=4, placement=placement,
                                   arbitration="burst", burst_beats=2),
            re_.evaluate_contention(rp, num_engines=4, placement=placement,
                                    arbitration="burst", burst_beats=2))
    pe.configure_write(pp)
    re_.configure_write(rp)
    np.testing.assert_array_equal(pe.capture_latency_list("write", depth=64),
                                  re_.capture_latency_list("write", depth=64))
