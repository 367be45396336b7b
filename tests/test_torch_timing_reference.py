"""The port's loop oracle (`repro_torch.core._timing_reference`) against the
reference's loop oracle, bit for bit, and against the port's vectorized
timing model at rel 1e-9, on the cases of tests/core/test_timing_parity.py
(copied below as data, with specs named instead of imported).

Bit for bit means: every float equal with ``==``, every array equal
element for element, every state and bound name equal.  The 1e-9 bar
against the vectorized model is the reference's own parity bar.
"""
import inspect
import math

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import _timing_reference as ref_loop
from repro.core.engine_mix import EngineMix as RefEngineMix
from repro_torch.core import _timing_reference as loop
from repro_torch.core import timing_model as vec
from repro_torch.core.engine_mix import EngineMix

MB = 1024**2
REL = 1e-9

SERIAL_CASES = [
    # (id, spec, policy, params kwargs, serial kwargs)
    ("hbm_hit_regime", "hbm", None,
     dict(n=1024, b=32, s=128, w=0x1000000), {}),
    ("hbm_miss_regime", "hbm", None,
     dict(n=1024, b=32, s=128 * 1024, w=0x1000000), {}),
    ("hbm_refresh_fig4", "hbm", None,
     dict(n=2048, b=32, s=64, w=0x1000000), {}),
    ("hbm_switch_table6", "hbm", None,
     dict(n=1024, b=32, s=128, w=0x1000000),
     dict(switch_enabled=True, switch_extra_cycles=22)),
    ("hbm_switch_miss", "hbm", None,
     dict(n=1024, b=32, s=128 * 1024, w=0x1000000),
     dict(switch_enabled=True, switch_extra_cycles=5)),
    ("hbm_bankgroup_runs_rbc", "hbm", "RBC",
     dict(n=1024, b=32, s=1024, w=0x1000000), {}),
    ("hbm_brc_row_thrash", "hbm", "BRC",
     dict(n=1024, b=32, s=1024, w=0x1000000), {}),
    ("hbm_locality_w8k", "hbm", None,
     dict(n=1024, b=32, s=4096, w=8 * 1024), {}),
    ("ddr4_hit_regime", "ddr4", None,
     dict(n=1024, b=64, s=128, w=0x1000000), {}),
    ("ddr4_miss_regime", "ddr4", None,
     dict(n=1024, b=64, s=128 * 1024, w=0x1000000), {}),
    ("ddr4_refresh_fig4", "ddr4", None,
     dict(n=2048, b=64, s=64, w=0x1000000), {}),
    ("ddr4_rbc_strided", "ddr4", "RBC",
     dict(n=1024, b=64, s=2048, w=0x1000000), {}),
    ("single_txn", "hbm", None, dict(n=1, b=32, s=32, w=0x1000000), {}),
    ("tiny_window_wrap", "hbm", None, dict(n=5, b=32, s=32, w=32), {}),
]

THROUGHPUT_CASES = [
    # (id, spec, policy, params kwargs)
    ("hbm_seq_table5", "hbm", None, dict(n=8192, b=32, s=32, w=0x10000000)),
    ("hbm_rbc_short_runs", "hbm", "RBC",
     dict(n=4096, b=64, s=128, w=0x10000000)),
    ("hbm_rbc_long_runs", "hbm", "RBC",
     dict(n=4096, b=64, s=2048, w=0x10000000)),
    ("hbm_brc_bank_bound", "hbm", "BRC",
     dict(n=4096, b=32, s=1024, w=0x10000000)),
    ("hbm_locality_w8k", "hbm", None, dict(n=4096, b=32, s=4096, w=8 * 1024)),
    ("hbm_locality_w256m", "hbm", None,
     dict(n=4096, b=32, s=4096, w=256 * MB)),
    ("hbm_multi_cmd_burst", "hbm", None,
     dict(n=4096, b=256, s=2048, w=0x10000000)),
    ("hbm_big_n_truncated", "hbm", None,
     dict(n=200000, b=64, s=1024, w=0x1000000)),
    ("hbm_far_stride", "hbm", None, dict(n=4096, b=32, s=32768, w=0x10000000)),
    ("ddr4_seq_table5", "ddr4", None, dict(n=8192, b=64, s=64, w=0x10000000)),
    ("ddr4_rbc_strided", "ddr4", "RBC",
     dict(n=4096, b=64, s=2048, w=0x10000000)),
    ("ddr4_partial_window", "ddr4", "RCBI", dict(n=100, b=64, s=64, w=1 << 20)),
]

CONTENTION_CASES = [
    # (id, spec, policy, params kwargs)
    ("hbm_seq_shared_port", "hbm", None, dict(n=2048, b=32, s=32, w=0x1000000)),
    ("hbm_strided", "hbm", None, dict(n=2048, b=32, s=1024, w=0x1000000)),
    ("hbm_rbc_runs", "hbm", "RBC", dict(n=2048, b=32, s=2048, w=0x1000000)),
    ("ddr4_seq", "ddr4", None, dict(n=2048, b=64, s=64, w=0x1000000)),
    ("ddr4_far_stride", "ddr4", None, dict(n=2048, b=64, s=4096, w=0x1000000)),
    ("hbm_multi_cmd_burst", "hbm", None,
     dict(n=1024, b=256, s=2048, w=0x1000000)),
]

ARBITRATION_CASES = [
    ("round_robin", 1), ("burst", 2), ("burst", 8), ("burst", 16),
    ("exclusive", 1),
]
ARB_IDS = [f"{pol}{bb}" if pol == "burst" else pol
           for pol, bb in ARBITRATION_CASES]

CONTENDED_LATENCY_CASES = [
    ("hbm_hit_regime", "hbm", dict(n=1024, b=32, s=128, w=0x1000000)),
    ("hbm_miss_regime", "hbm", dict(n=1024, b=32, s=128 * 1024, w=0x1000000)),
    ("ddr4_hit_regime", "ddr4", dict(n=1024, b=64, s=128, w=0x1000000)),
]

MIX_CASES = [
    # (id, spec, policy, [(params kwargs, op), ...])
    ("hbm_read_write_seq", "hbm", None,
     [(dict(n=1024, b=32, s=32, w=0x100000), "read"),
      (dict(n=1024, b=32, s=32, w=0x100000), "write")]),
    ("hbm_3r1w_strided", "hbm", None,
     [(dict(n=1024, b=32, s=1024, w=0x100000), "read")] * 3
     + [(dict(n=1024, b=32, s=1024, w=0x100000), "write")]),
    ("hbm_duplex_spiked_rbc", "hbm", "RBC",
     [(dict(n=512, b=32, s=128, w=0x100000), "read"),
      (dict(n=512, b=32, s=128, w=0x100000), "read"),
      (dict(n=512, b=32, s=2048, w=0x100000), "write"),
      (dict(n=512, b=32, s=2048, w=0x100000), "duplex")]),
    ("hbm_ragged_tuples", "hbm", None,
     [(dict(n=1024, b=32, s=128, w=0x100000), "read"),
      (dict(n=300, b=64, s=4096, w=8192), "write"),
      (dict(n=512, b=32, s=1024, w=0x1000000), "read")]),
    ("ddr4_balanced", "ddr4", None,
     [(dict(n=512, b=64, s=64, w=0x100000), "read"),
      (dict(n=512, b=64, s=64, w=0x100000), "write"),
      (dict(n=512, b=64, s=2048, w=0x100000), "read"),
      (dict(n=512, b=64, s=2048, w=0x100000), "write")]),
]

BOUNDS = ("bus/ccd", "bank", "faw")


def _ids(cases):
    return [c[0] for c in cases]


def _setup(spec_name, policy, kw):
    """(port spec, mapping, params), (reference spec, mapping, params)."""
    ps, rs = port_core.spec_by_name(spec_name), ref_core.spec_by_name(
        spec_name)
    return ((ps, port_core.get_mapping(ps, policy), port_core.RSTParams(**kw)),
            (rs, ref_core.get_mapping(rs, policy), ref_core.RSTParams(**kw)))


def _mixes(entries):
    return (EngineMix(tuple((port_core.RSTParams(**kw), op)
                            for kw, op in entries)),
            RefEngineMix(tuple((ref_core.RSTParams(**kw), op)
                               for kw, op in entries)))


def assert_bitwise(got, want, path="result"):
    """Exact equality of a port loop-oracle result and the reference's:
    dataclasses by field name, dicts by key, arrays element for element
    (with their dtype), floats with ``==`` (NaN equal to NaN)."""
    if hasattr(want, "__dataclass_fields__"):
        assert type(got).__name__ == type(want).__name__, path
        for name in want.__dataclass_fields__:
            assert_bitwise(getattr(got, name), getattr(want, name),
                           f"{path}.{name}")
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_bitwise(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bitwise(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


def _assert_trace(got, want):
    np.testing.assert_array_equal(got.cycles, want.cycles)
    assert got.states == want.states
    np.testing.assert_array_equal(got.refresh_hits, want.refresh_hits)


# ---------------------------------------------------------- serial latency


@pytest.mark.parametrize("op", ["read", "write"])
@pytest.mark.parametrize("spec,policy,kw,skw", [c[1:] for c in SERIAL_CASES],
                         ids=_ids(SERIAL_CASES))
def test_serial_latencies_loop_matches_reference(spec, policy, kw, skw, op):
    (ps, pm, pp), (rs, rm, rp) = _setup(spec, policy, kw)
    fn, ref_fn = ((loop.serial_read_latencies, ref_loop.serial_read_latencies)
                  if op == "read" else
                  (loop.serial_write_latencies,
                   ref_loop.serial_write_latencies))
    got = fn(pp, pm, ps, **skw)
    assert_bitwise(got, ref_fn(rp, rm, rs, **skw))
    # The reference's own bar: the vectorized model is bit-exact too.
    _assert_trace(vec.serial_latencies(pp, pm, ps, op=op, **skw), got)


@pytest.mark.parametrize("spec,policy,kw,skw", [c[1:] for c in SERIAL_CASES],
                         ids=_ids(SERIAL_CASES))
def test_serial_read_latencies_parity(spec, policy, kw, skw):
    """The port's vectorized read alias against the port's loop oracle,
    bit for bit (tests/core/test_timing_parity.py's pairing)."""
    ps, pm, pp = _setup(spec, policy, kw)[0]
    got = vec.serial_read_latencies(pp, pm, ps, **skw)
    _assert_trace(got, loop.serial_read_latencies(pp, pm, ps, **skw))


# --------------------------------------------------------------- throughput


def _assert_model_close(got, want, fields):
    assert got.bound == want.bound
    for f in fields:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=REL), f
    assert got.detail["total_acts"] == want.detail["total_acts"]
    assert got.detail["txns"] == want.detail["txns"]
    for bound in BOUNDS:
        assert got.detail[bound] == pytest.approx(want.detail[bound],
                                                  rel=REL), bound


@pytest.mark.parametrize("op", ["read", "write", "duplex"])
@pytest.mark.parametrize("spec,policy,kw", [c[1:] for c in THROUGHPUT_CASES],
                         ids=_ids(THROUGHPUT_CASES))
def test_throughput_loop_matches_reference(spec, policy, kw, op):
    (ps, pm, pp), (rs, rm, rp) = _setup(spec, policy, kw)
    got = loop.throughput(pp, pm, ps, op=op)
    assert_bitwise(got, ref_loop.throughput(rp, rm, rs, op=op))
    model = vec.throughput(pp, pm, ps, op=op)
    _assert_model_close(model, got, ("gbps",))
    assert model.detail["cmds_per_txn"] == got.detail["cmds_per_txn"]


@pytest.mark.parametrize("num_engines", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("spec,policy,kw", [c[1:] for c in CONTENTION_CASES],
                         ids=_ids(CONTENTION_CASES))
def test_contended_throughput_loop_matches_reference(spec, policy, kw,
                                                     num_engines):
    (ps, pm, pp), (rs, rm, rp) = _setup(spec, policy, kw)
    got = loop.contended_throughput(pp, pm, ps, num_engines=num_engines)
    assert_bitwise(got, ref_loop.contended_throughput(
        rp, rm, rs, num_engines=num_engines))
    _assert_model_close(
        vec.contended_throughput(pp, pm, ps, num_engines=num_engines), got,
        ("aggregate_gbps", "queueing_delay_cycles"))


@pytest.mark.parametrize("arbitration,burst_beats", ARBITRATION_CASES,
                         ids=ARB_IDS)
@pytest.mark.parametrize("num_engines", [1, 2, 3, 4])
@pytest.mark.parametrize("spec,policy,kw", [c[1:] for c in CONTENTION_CASES],
                         ids=_ids(CONTENTION_CASES))
def test_arbitration_loop_matches_reference(spec, policy, kw, num_engines,
                                            arbitration, burst_beats):
    (ps, pm, pp), (rs, rm, rp) = _setup(spec, policy, kw)
    axes = dict(num_engines=num_engines, arbitration=arbitration,
                burst_beats=burst_beats)
    got = loop.contended_throughput(pp, pm, ps, **axes)
    assert_bitwise(got, ref_loop.contended_throughput(rp, rm, rs, **axes))
    model = vec.contended_throughput(pp, pm, ps, **axes)
    _assert_model_close(model, got,
                        ("aggregate_gbps", "queueing_delay_cycles"))
    assert model.detail["grant_head_wait_cycles"] == pytest.approx(
        got.detail["grant_head_wait_cycles"], rel=REL)


@pytest.mark.parametrize("op", ["read", "write", "duplex"])
def test_contended_write_directions_match_reference(op):
    (ps, pm, pp), (rs, rm, rp) = _setup("hbm", None, CONTENTION_CASES[1][3])
    for arbitration, bb in ARBITRATION_CASES:
        axes = dict(num_engines=3, op=op, arbitration=arbitration,
                    burst_beats=bb)
        got = loop.contended_throughput(pp, pm, ps, **axes)
        assert_bitwise(got, ref_loop.contended_throughput(rp, rm, rs, **axes))
        _assert_model_close(vec.contended_throughput(pp, pm, ps, **axes),
                            got, ("aggregate_gbps", "queueing_delay_cycles"))


# ------------------------------------------------------ contended latencies


@pytest.mark.parametrize("op", ["read", "write"])
@pytest.mark.parametrize("arbitration,burst_beats", ARBITRATION_CASES,
                         ids=ARB_IDS)
@pytest.mark.parametrize("spec,kw", [c[1:] for c in CONTENDED_LATENCY_CASES],
                         ids=_ids(CONTENDED_LATENCY_CASES))
def test_contended_latencies_loop_matches_reference(spec, kw, arbitration,
                                                    burst_beats, op):
    (ps, pm, pp), (rs, rm, rp) = _setup(spec, None, kw)
    for num_engines in (1, 2, 4):
        axes = dict(op=op, num_engines=num_engines, arbitration=arbitration,
                    burst_beats=burst_beats)
        got = loop.serial_contended_latencies(pp, pm, ps, **axes)
        assert_bitwise(got, ref_loop.serial_contended_latencies(
            rp, rm, rs, **axes))
        _assert_trace(vec.serial_latencies(pp, pm, ps, **axes), got)


# -------------------------------------------------------------------- mixes


@pytest.mark.parametrize("arbitration,burst_beats", ARBITRATION_CASES,
                         ids=ARB_IDS)
@pytest.mark.parametrize("spec,policy,entries", [c[1:] for c in MIX_CASES],
                         ids=_ids(MIX_CASES))
def test_contended_mix_loop_matches_reference(spec, policy, entries,
                                              arbitration, burst_beats):
    (ps, pm, _), (rs, rm, _) = _setup(spec, policy, entries[0][0])
    mix, ref_mix = _mixes(entries)
    axes = dict(arbitration=arbitration, burst_beats=burst_beats)
    got = loop.contended_throughput_mix(mix, pm, ps, **axes)
    assert_bitwise(got, ref_loop.contended_throughput_mix(ref_mix, rm, rs,
                                                          **axes))
    model = vec.contended_throughput_mix(mix, pm, ps, **axes)
    _assert_model_close(model, got,
                        ("aggregate_gbps", "queueing_delay_cycles"))
    for key in ("op_switch_cycles", "grant_head_wait_cycles"):
        assert model.detail[key] == pytest.approx(got.detail[key],
                                                  rel=REL), key


# --------------------------------------------------------------- the module


def test_loop_oracle_is_the_reference_loops():
    """The port's oracle keeps the per-transaction loops the parity tests
    derive their authority from, and its public functions are the
    reference's."""
    public = sorted(n for n, f in vars(ref_loop).items()
                    if inspect.isfunction(f) and not n.startswith("_")
                    and f.__module__ == ref_loop.__name__)
    assert public == sorted(
        n for n, f in vars(loop).items()
        if inspect.isfunction(f) and not n.startswith("_")
        and f.__module__ == loop.__name__)
    for fn in (loop.serial_read_latencies, loop.serial_write_latencies):
        assert "for i in range(len(addrs))" in inspect.getsource(fn)


def test_loop_oracle_rejects_what_the_reference_rejects():
    (ps, pm, pp), (rs, rm, rp) = _setup("hbm", None, CONTENTION_CASES[0][3])
    for kwargs in (dict(num_engines=0), dict(num_engines=2,
                                             arbitration="lottery"),
                   dict(num_engines=2, arbitration="round_robin",
                        burst_beats=4)):
        with pytest.raises(Exception) as want:
            ref_loop.contended_throughput(rp, rm, rs, **kwargs)
        with pytest.raises(Exception) as got:
            loop.contended_throughput(pp, pm, ps, **kwargs)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)
