"""The port's `MemoryOracle`, layout API and measured layout tuner against
the reference, on the CPU.

The cases are those of tests/core/test_oracle_autotune.py and
tests/core/test_autotune_optimality.py.  Oracle values and tuner reports
must equal the reference's (the tuner field for field, on `sim`, for all
four specs).  The exhaustive oracle of the optimality cases is the port's
`torchgrid` grid evaluated on the CPU, in place of the reference's
`jaxgrid`.  On `cuda` (its plain versions on the CPU here) a tuner report
must equal its own replay from the scores it measured.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import autotune as ref_tune
from repro_torch.core import autotune as tune
from repro_torch.core import engine as engine_mod
from repro_torch.core import timing_torch
from repro_torch.core.address_mapping import policies_for
from repro_torch.core.engine import CudaBackend
from repro_torch.core.roofline_empirical import config_ceiling_gbps
from repro_torch.core.sweep import KIND_CONTENTION, SweepPoint
from repro_torch.service import CampaignService, ExperimentRequest
from repro_torch.service.faults import register_fault_injected
from test_torch_core import assert_same

SPEC_NAMES = ("hbm", "ddr4", "hbm3", "ddr3")
GRID_ARBS = (("round_robin", 1), ("burst", 4), ("exclusive", 1))
TRI_PLACEMENTS = ("same_channel", "same_switch", "cross_switch")
TILE = 4096


def _small_params(spec, pkg=port_core):
    b = max(64, spec.min_burst)
    return pkg.RSTParams(n=512, b=b, s=b, w=1 << 22)


def _tune_kwargs():
    return dict(arbitrations=("round_robin", "burst", "exclusive"),
                burst_beats=(4,), placements=TRI_PLACEMENTS, mixes=(1, 4))


def _pair(name):
    return port_core.spec_by_name(name), ref_core.spec_by_name(name)


@pytest.fixture
def counting(request):
    """A fault-free fault-injected wrapper over `sim` (it counts the
    calls that reach it); removed afterwards."""
    name = "counting-sim-autotune"
    be = register_fault_injected("sim", name=name, rate=0.0, override=True)
    yield name, be
    engine_mod._BACKEND_REGISTRY.pop(name, None)


@pytest.fixture
def cpu_cuda():
    """The registered `cuda` backend swapped for its CPU path."""
    original = port_core.get_backend("cuda")
    port_core.register_backend(CudaBackend(device="cpu"), override=True)
    try:
        yield
    finally:
        port_core.register_backend(original, override=True)


# ------------------------------------------------------------------ oracle


PATTERNS = [(4096, 4096, 1 << 28), (64, 65536, 1 << 28), (32, 32, 1 << 10),
            (100, 300, 5000), (1 << 20, 1 << 20, 1 << 30), (8, 4, 16)]


@pytest.mark.parametrize("pattern", PATTERNS, ids=str)
def test_oracle_efficiency_matches_reference(pattern):
    got = port_core.MemoryOracle()
    want = ref_core.MemoryOracle()
    gp, wp = port_core.AccessPattern(*pattern), ref_core.AccessPattern(
        *pattern)
    assert_same(gp.to_rst(port_core.HBM), wp.to_rst(ref_core.HBM))
    assert got.efficiency(gp) == want.efficiency(wp)
    assert got.effective_bandwidth(gp) == want.effective_bandwidth(wp)


def test_oracle_defaults_and_paper_numbers():
    oracle = port_core.MemoryOracle()
    assert oracle.chip.name == ref_core.MemoryOracle().chip.name == "tpu_v5e"
    assert oracle.reference_spec.name == "hbm"
    # Sequential large-burst traversal ~ 13.27/14.4 = 92 % of wire rate.
    eff = oracle.efficiency(port_core.AccessPattern(4096, 4096, 1 << 28))
    assert eff == pytest.approx(0.922, rel=0.02)
    cont = oracle.effective_bandwidth(port_core.AccessPattern(
        4096, 4096, 1 << 28))
    strided = oracle.effective_bandwidth(port_core.AccessPattern(
        64, 65536, 1 << 28))
    assert cont > 2 * strided
    # v5e: 197e12 / 819e9 ~ 240 FLOP/byte.
    assert oracle.arithmetic_intensity_needed() == pytest.approx(240.5,
                                                                 rel=0.01)


@pytest.mark.parametrize("chip", ["tpu_v5e", "h100_sxm"])
def test_oracle_roofline_terms(chip):
    """The reference's terms on its chip; on the H100 SXM the same
    formulas over the data-sheet peaks (modeled, not measured)."""
    spec = port_core.chip_by_name(chip)
    oracle = port_core.MemoryOracle(chip=spec)
    cases = [(1e15, 1e12, 0.0, 256), (1e12, 1e13, 1e11, 8), (0.0, 1e9, 1e12, 1)]
    for flops, hbm, coll, chips in cases:
        t = oracle.roofline_terms(flops, hbm, coll, chips)
        assert t["compute_s"] == flops / (chips * spec.peak_bf16_flops)
        assert t["memory_s"] == hbm / (chips * spec.hbm_bandwidth)
        assert t["collective_s"] == coll / (chips * spec.ici_link_bandwidth)
        if chip == "tpu_v5e":
            want = ref_core.MemoryOracle().roofline_terms(flops, hbm, coll,
                                                          chips)
            assert t == want
    assert oracle.arithmetic_intensity_needed() == spec.ridge_intensity
    assert oracle.hbm_fits(spec.hbm_bytes * 0.5)
    assert not oracle.hbm_fits(spec.hbm_bytes * 0.95)
    if chip == "tpu_v5e":
        ref = ref_core.MemoryOracle()
        for gib in (10, 14, 15, 17):
            assert oracle.hbm_fits(gib * 1024**3) == ref.hbm_fits(
                gib * 1024**3)


# -------------------------------------------------------------- layout API


LAYOUT_CASES = [
    ({"seq": 32768, "kv_heads": 8, "head_dim": 128}, 2, "seq",
     ("kv_heads", "head_dim"), ()),
    ({"a": 1024, "b": 64, "c": 128}, 4, "a", ("b", "c"), ()),
    ({"batch": 16, "seq": 4096, "d": 512}, 2, "batch", ("d",), ("d",)),
    ({"x": 64, "y": 64, "z": 64, "w": 4}, 4, "x", ("y", "w"), ()),
]


@pytest.mark.parametrize("sizes,itemsize,iterate,fetch,fixed", LAYOUT_CASES,
                         ids=lambda v: str(v)[:24])
def test_score_and_choose_layout_match_reference(sizes, itemsize, iterate,
                                                 fetch, fixed):
    got = port_core.score_layouts(port_core.MemoryOracle(), sizes, itemsize,
                                  iterate, fetch, fixed)
    want = ref_core.score_layouts(ref_core.MemoryOracle(), sizes, itemsize,
                                  iterate, fetch, fixed)
    assert [(bw, c.dims) for bw, c in got] == [(bw, c.dims)
                                                for bw, c in want]
    bws = [bw for bw, _ in got]
    assert bws == sorted(bws, reverse=True) and bws[0] > 0
    for (_, g), (_, w) in zip(got, want):
        assert_same(g.access_pattern(iterate, fetch),
                    w.access_pattern(iterate, fetch))
        assert g.total_bytes == w.total_bytes
    best = port_core.choose_layout(port_core.MemoryOracle(), sizes,
                                   itemsize, iterate, fetch, fixed)
    assert best.dims == want[0][1].dims


def test_kv_cache_layout_prefers_contiguous_seq():
    best = port_core.choose_layout(
        port_core.MemoryOracle(), {"seq": 32768, "kv_heads": 8,
                                   "head_dim": 128}, itemsize=2,
        iterate_dim="seq", fetch_dims=("kv_heads", "head_dim"))
    assert best.dims[0] == "seq"


@pytest.mark.parametrize("act_mib,max_mb", [(256, 64), (1, 1024), (4096, 8),
                                            (64, 1)])
def test_advise_microbatch_matches_reference(act_mib, max_mb):
    kw = dict(param_bytes_per_device=4 * 1024**3,
              opt_state_bytes_per_device=6 * 1024**3,
              act_bytes_per_sample=act_mib * 1024**2, max_microbatch=max_mb)
    got = port_core.advise_microbatch(port_core.MemoryOracle(), **kw)
    assert got == ref_core.advise_microbatch(ref_core.MemoryOracle(), **kw)
    assert 1 <= got <= max(1, max_mb)


@pytest.mark.parametrize("layer_mib,layers,want", [
    (1, 12, "none"), (40, 88, "save_boundaries"), (400, 88, "full")])
def test_advise_remat_policies(layer_mib, layers, want):
    kw = dict(layer_act_bytes=layer_mib * 1024**2, num_layers=layers)
    assert port_core.advise_remat(port_core.MemoryOracle(), **kw) == want
    assert ref_core.advise_remat(ref_core.MemoryOracle(), **kw) == want


# ------------------------------------------------------- tuner vs reference


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_tune_layout_equals_reference(name):
    """Winner, trajectory, evaluations, candidates: field for field."""
    ps, rs = _pair(name)
    got = port_core.tune_layout(_small_params(ps), ps, "sim",
                                **_tune_kwargs())
    want = ref_core.tune_layout(_small_params(rs, ref_core), rs, "sim",
                                **_tune_kwargs())
    assert_same(got, want)
    assert (got.evaluations, got.candidates) == (want.evaluations,
                                                 want.candidates)
    assert got.winner_gbps == want.winner_gbps
    assert [r.configs for r in got.trajectory] == [
        tuple(tune.LayoutConfig(*dataclasses.astuple(c)) for c in r.configs)
        for r in want.trajectory]


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_winner_matches_exhaustive_torchgrid(name):
    """Tuner winner == the argmax of the exhaustive grid (torchgrid on the
    CPU), with strictly fewer evaluations than the grid has points."""
    spec = port_core.spec_by_name(name)
    p = _small_params(spec)
    axes = timing_torch.GridAxes(
        params=(p,), policies=tuple(policies_for(spec)), ops=("read",),
        num_engines=(1, 4), arbitrations=GRID_ARBS,
        placements=TRI_PLACEMENTS)
    assert axes.size <= 256, "keep the exhaustive oracle small"
    grid = timing_torch.evaluate_grid(spec, axes, device="cpu")
    report = port_core.tune_layout(p, spec, "sim", **_tune_kwargs())
    assert report.winner_gbps == pytest.approx(float(np.max(grid.gbps)),
                                               rel=1e-9)
    assert report.evaluations < axes.size
    lane = [i for i, pt in enumerate(grid.sweep_points())
            if (pt.policy, pt.arbitration, pt.burst_beats, pt.placement,
                pt.num_engines) == (report.winner.policy,
                                    report.winner.arbitration,
                                    report.winner.burst_beats,
                                    report.winner.placement,
                                    report.winner.engines)]
    assert lane, "tuner winner must be a grid point"
    assert float(grid.gbps[lane[0]]) == pytest.approx(report.winner_gbps,
                                                      rel=1e-9)
    # The sound-ceiling invariant that makes the pruning exact here.
    for gbps, pt in zip(grid.gbps, grid.sweep_points()):
        assert float(gbps) <= config_ceiling_gbps(
            spec, pt.placement, pt.num_engines) * (1 + 1e-9)


def test_single_engine_arbitration_collapse():
    p = _small_params(port_core.HBM)
    sweep = port_core.Sweep(port_core.HBM, "sim")
    for arb, bb in (("round_robin", 1), ("exclusive", 1), ("burst", 8)):
        sweep.add_point(SweepPoint(p, "RBC", kind=KIND_CONTENTION,
                                   num_engines=1, arbitration=arb,
                                   burst_beats=bb, placement="same_switch"))
    vals = [r.value.aggregate_gbps for r in sweep.run()]
    assert vals[0] == vals[1] == vals[2]


@pytest.mark.parametrize("seed", [3, 11])
def test_same_seed_bit_identical_report(seed):
    p = _small_params(port_core.HBM)
    r1 = port_core.tune_layout(p, port_core.HBM, "sim", seed=seed,
                               **_tune_kwargs())
    r2 = port_core.tune_layout(p, port_core.HBM, "sim", seed=seed,
                               **_tune_kwargs())
    assert r1 == r2
    want = ref_core.tune_layout(_small_params(ref_core.HBM, ref_core),
                                ref_core.HBM, "sim", seed=seed,
                                **_tune_kwargs())
    assert_same(r1, want)
    r0 = port_core.tune_layout(p, port_core.HBM, "sim", **_tune_kwargs())
    assert r1.winner_gbps == r0.winner_gbps


def test_warm_sweep_retune_hits_cache(counting):
    name, backend = counting
    p = _small_params(port_core.HBM)
    sweep = port_core.Sweep(port_core.HBM, name, coalesce=True)
    r1 = port_core.tune_layout(p, port_core.HBM, name, sweep=sweep,
                               **_tune_kwargs())
    calls_after_first = backend.calls
    assert calls_after_first == r1.evaluations
    r2 = port_core.tune_layout(p, port_core.HBM, name, sweep=sweep,
                               **_tune_kwargs())
    assert backend.calls == calls_after_first
    assert r2 == r1


def test_uniform_mix_retune_folds_onto_the_warm_sweep(counting):
    """A read-only uniform mix string ("4r") folds into the homogeneous
    N = 4 key (`normalize_mix`), so a re-tune over the same Sweep only
    evaluates the configs the first tune did not measure."""
    name, backend = counting
    p = _small_params(port_core.HBM)
    sweep = port_core.Sweep(port_core.HBM, name, coalesce=True)
    first = port_core.tune_layout(p, port_core.HBM, name, sweep=sweep,
                                  **_tune_kwargs())
    measured = {(c.policy, c.arbitration, c.burst_beats, c.placement,
                 c.engines) for r in first.trajectory for c in r.configs}
    calls = backend.calls
    kw = dict(_tune_kwargs(), mixes=("4r",))
    folded = port_core.tune_layout(p, port_core.HBM, name, sweep=sweep, **kw)
    new = [c for r in folded.trajectory for c in r.configs
           if (c.policy, c.arbitration, c.burst_beats, c.placement, 4)
           not in measured]
    assert backend.calls - calls == len(new)
    alone = port_core.tune_layout(p, port_core.HBM, "sim", **kw)
    assert folded == alone
    want = ref_core.tune_layout(_small_params(ref_core.HBM, ref_core),
                                ref_core.HBM, "sim", **kw)
    assert_same(folded, want)


def test_budget_truncates_bracket():
    p = _small_params(port_core.HBM)
    full = port_core.tune_layout(p, port_core.HBM, "sim", **_tune_kwargs())
    capped = port_core.tune_layout(p, port_core.HBM, "sim", 10,
                                   **_tune_kwargs())
    assert capped.evaluations <= 10 < full.evaluations
    assert capped.winner_gbps <= full.winner_gbps
    assert capped.candidates == full.candidates
    assert_same(capped, ref_core.tune_layout(
        _small_params(ref_core.HBM, ref_core), ref_core.HBM, "sim", 10,
        **_tune_kwargs()))


def test_engine_mix_configs_tune():
    kw = dict(mixes=(1, "2r+1w"), arbitrations=("round_robin",),
              burst_beats=(1,))
    report = port_core.tune_layout(_small_params(port_core.HBM),
                                   port_core.HBM, "sim", **kw)
    assert report.winner.engines in (1, "2r+1w")
    assert report.evaluations <= report.candidates
    assert_same(report, ref_core.tune_layout(
        _small_params(ref_core.HBM, ref_core), ref_core.HBM, "sim", **kw))


def test_service_roundtrip_and_dedup():
    """layout_autotune through the CampaignService: the derived report,
    duplicates coalesced, and the offline replay equal to the direct
    search and to the reference's."""
    svc = CampaignService("sim", "sim")
    req = ExperimentRequest.make("layout_autotune", "hbm", quick=True)
    resp = svc.submit(req)
    assert resp.ok and isinstance(resp.result, tune.TuneReport)
    dup = svc.submit(req)
    assert dup.coalesced and dup.result == resp.result
    direct = port_core.run_experiment("layout_autotune", port_core.HBM,
                                      "sim", quick=True)
    assert direct == resp.result
    assert_same(direct, ref_core.run_experiment(
        "layout_autotune", ref_core.HBM, "sim", quick=True))
    env = svc.submit(ExperimentRequest.make("roofline_empirical", "hbm",
                                            quick=True))
    assert env.ok and env.result.peak_gbps > 0


def test_tuner_probes_share_the_sweep_memo():
    p = _small_params(port_core.HBM)
    sweep = port_core.Sweep(port_core.HBM, "sim", coalesce=True)
    port_core.tune_layout(p, port_core.HBM, "sim", sweep=sweep,
                          **_tune_kwargs())
    evaluated_once = sweep.stats.evaluated
    port_core.tune_layout(p, port_core.HBM, "sim", sweep=sweep,
                          **_tune_kwargs())
    assert sweep.stats.evaluated == evaluated_once
    assert sweep.stats.cache_hits > 0


def test_registration_matches_reference():
    got = port_core.get_experiment("layout_autotune")
    want = ref_core.get_experiment("layout_autotune")
    assert (got.artifact, got.title, got.defaults, got.quick) == (
        want.artifact, want.title, want.defaults, want.quick)
    rep = port_core.run_experiment("layout_autotune", port_core.HBM, "sim",
                                   quick=True)
    ref_rep = ref_core.run_experiment("layout_autotune", ref_core.HBM,
                                      "sim", quick=True)
    assert got.summary(port_core.HBM, rep) == want.summary(ref_core.HBM,
                                                           ref_rep)
    assert got.flatten(port_core.HBM, rep) == want.flatten(ref_core.HBM,
                                                           ref_rep)


@pytest.mark.parametrize("cfg", [
    ("RBC", "burst", 4, "same_switch", 4), ("RCB", "exclusive", 1,
                                            "cross_switch", "2r+1w"),
    ("BRC", "round_robin", 1, "same_channel", 1)])
def test_layout_config_describe_matches_reference(cfg):
    assert tune.LayoutConfig(*cfg).describe() == ref_tune.LayoutConfig(
        *cfg).describe()


def test_empty_bracket_raises_the_reference_text():
    with pytest.raises(ValueError) as got:
        tune._replay_search([], {}, lambda b: [], eta=2)
    with pytest.raises(ValueError) as want:
        ref_tune._replay_search([], {}, lambda b: [], eta=2)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ on `cuda`


def replay(report, spec, configs, *, seed=0, eta=2):
    """The report's trajectory replayed from the scores it measured."""
    table = {c: g for r in report.trajectory
             for c, g in zip(r.configs, r.gbps)}
    ordered = tune._ordered_bracket(spec, configs, seed=seed, budget=None)
    ceilings = {c: config_ceiling_gbps(spec, c.placement,
                                       tune._mix_engines(c.engines))
                for c in configs}
    return tune._replay_search(ordered, ceilings,
                               lambda batch: [table[c] for c in batch],
                               eta=eta), table


def test_cuda_tune_at_the_tile_equals_its_replay(cpu_cuda):
    """On `cuda` (plain versions on the CPU: the scores are host times)
    at a 4 KiB-tile shape, the report is a pure function of the bracket
    order and the scores it measured, and its winner is their argmax."""
    spec = port_core.HBM
    p = port_core.RSTParams(n=32, b=TILE, s=TILE, w=64 * TILE)
    kw = dict(arbitrations=("round_robin", "burst", "exclusive"),
              burst_beats=(16,), placements=TRI_PLACEMENTS, mixes=(1, 4))
    report = port_core.tune_layout(p, spec, "cuda", **kw)
    configs = tune._canonical_configs(
        spec, policies=None, arbitrations=kw["arbitrations"],
        burst_beats=kw["burst_beats"], placements=kw["placements"],
        mixes=kw["mixes"])
    assert report.candidates == len(configs) == 60
    (rounds, measured, winner, best), table = replay(report, spec, configs)
    assert rounds == report.trajectory
    assert (winner, best) == (report.winner, report.winner_gbps)
    assert report.evaluations == len(measured) == len(table)
    assert best == max(table.values())
    assert all(g > 0 for g in table.values())
