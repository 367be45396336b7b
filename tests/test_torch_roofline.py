"""The port's measured roofline (`repro_torch.core.roofline_empirical`) and
chip registry against the reference, on the CPU.

The invariants are those of tests/core/test_roofline_envelope.py: the
envelope math (attainable monotone and bounded, the knee, the ladder),
the placement tiers ordered same_channel >= same_switch >= cross_switch,
`config_ceiling_gbps` bounding every probe, and Shuhai's fraction of
nominal.  The port's envelope on `sim` and on `torchgrid` (evaluated on
the CPU) must equal the reference's on `sim` at rel 1e-9.
"""
import dataclasses

import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import roofline_empirical as ref_rf
from repro_torch.core import roofline_empirical as rf
from repro_torch.core.engine import CudaBackend, TorchGridBackend
from repro_torch.core.switch import PLACEMENTS
from test_torch_core import assert_same

CHIP = port_core.chip_by_name("tpu_v5e")
ALL_SPECS = ("hbm", "ddr4", "hbm3", "ddr3")
TILE = 4096


def _synthetic_envelope(gbps_values):
    points = tuple(
        rf.EnvelopePoint(policy="RBC", placement="same_channel",
                         num_engines=1, burst=64, stride=64, gbps=g)
        for g in gbps_values)
    return rf.build_envelope(port_core.HBM, CHIP, points)


@pytest.fixture
def cpu_backends():
    """The registered `torchgrid` and `cuda` backends swapped for ones
    that run on the CPU, restored afterwards."""
    originals = [port_core.get_backend(n) for n in ("torchgrid", "cuda")]
    port_core.register_backend(TorchGridBackend(device="cpu"),
                               override=True)
    port_core.register_backend(CudaBackend(device="cpu"), override=True)
    try:
        yield
    finally:
        for be in originals:
            port_core.register_backend(be, override=True)


# ---------------------------------------------------------------- registry


def test_chip_registry_holds_reference_chip_and_h100():
    assert port_core.available_chips() == ["tpu_v5e", "h100_sxm"]
    got = dataclasses.asdict(port_core.chip_by_name("tpu_v5e"))
    assert got == dataclasses.asdict(ref_core.chip_by_name("tpu_v5e"))
    assert port_core.TPU_V5E.ridge_intensity == \
        ref_core.TPU_V5E.ridge_intensity
    h100 = port_core.chip_by_name("h100_sxm")
    assert h100 is port_core.H100_SXM
    assert (h100.peak_bf16_flops, h100.hbm_bandwidth, h100.hbm_bytes,
            h100.vmem_bytes, h100.ici_link_bandwidth, h100.ici_links) == (
        989.4e12, 3.35e12, 80 * 10**9, 132 * 228 * 1024, 25e9, 18)
    assert h100.ridge_intensity == pytest.approx(295.3, abs=0.05)


def test_chip_registry_rejects_duplicates_and_unknowns():
    with pytest.raises(ValueError, match="already registered"):
        port_core.register_chip(port_core.H100_SXM)
    assert port_core.register_chip(port_core.H100_SXM, override=True) is \
        port_core.H100_SXM
    with pytest.raises(ValueError, match="unknown chip"):
        port_core.chip_by_name("h200")


# ----------------------------------------------------------- envelope math


@pytest.mark.parametrize("ais", [
    [1e-3, 0.5, 2.0, 64.0, 1e6], [3.0, 1.0, 2.0], [1e4, 1e-2]])
def test_attainable_monotone_and_bounded(ais):
    env = _synthetic_envelope([10.0, 20.0])
    for ai in ais:
        val = env.attainable(ai)
        assert val <= env.peak_flops
        assert val <= ai * env.peak_gbps * 1e9 * (1 + 1e-12)
    vals = [env.attainable(ai) for ai in sorted(ais)]
    assert all(lo <= hi for lo, hi in zip(vals, vals[1:]))


@pytest.mark.parametrize("gbps", [[16.0], [1e-3, 500.0, 20.0],
                                  [3.0, 3.0, 2.5]])
def test_envelope_upper_bounds_its_points(gbps):
    env = _synthetic_envelope(gbps)
    assert env.peak_gbps == max(gbps)
    for pt in env.points:
        assert pt.gbps <= env.peak_gbps
        assert env.attainable(1.0, gbps=pt.gbps) <= env.attainable(1.0)


def test_knee_and_ladder():
    env = _synthetic_envelope([16.0])
    knee = env.knee_ai()
    assert env.attainable(knee) == pytest.approx(env.peak_flops)
    assert env.attainable(knee / 2) == pytest.approx(env.peak_flops / 2)
    assert env.attainable(knee * 8) == env.peak_flops
    assert env.knee_ai(gbps=8.0) > knee
    rungs = env.ladder()
    assert len(rungs) == len(env.ai_ladder) == len(rf.DEFAULT_AI_LADDER)
    for ai, flops in rungs:
        assert flops == env.attainable(ai)


def test_build_envelope_rejects_empty():
    with pytest.raises(ValueError):
        rf.build_envelope(port_core.HBM, CHIP, ())


# -------------------------------------------------------- measured on sim


@pytest.mark.parametrize("spec_name", ALL_SPECS)
def test_measured_tiers_ordered_and_ceiling_bounds_probes(spec_name):
    spec = port_core.spec_by_name(spec_name)
    env = rf.measure_envelope(spec, quick=True)
    sc = env.placement_gbps["same_channel"]
    ss = env.placement_gbps["same_switch"]
    cs = env.placement_gbps["cross_switch"]
    assert sc >= ss >= cs
    assert set(env.placement_gbps) == set(PLACEMENTS)
    assert env.spec_name == spec.name and env.chip_name == CHIP.name
    for pt in env.points:
        ceiling = rf.config_ceiling_gbps(spec, pt.placement, pt.num_engines)
        assert pt.gbps <= ceiling * (1 + 1e-9)
        assert ceiling == ref_rf.config_ceiling_gbps(
            ref_core.spec_by_name(spec_name), pt.placement, pt.num_engines)


def test_capped_fabric_orders_strictly():
    env = rf.measure_envelope(port_core.HBM3, quick=True)
    assert env.placement_gbps["cross_switch"] < \
        env.placement_gbps["same_switch"]


def test_fraction_of_nominal_matches_shuhai():
    env = rf.measure_envelope(port_core.HBM, quick=True)
    frac = env.fraction_of_nominal(env.placement_gbps["same_channel"])
    assert 0.85 <= frac <= 1.0
    agg = env.placement_aggregate_gbps["same_switch"]
    assert env.fraction_of_nominal(agg, ports=4) <= 1.0


def test_policy_knees_cover_every_policy():
    env = rf.measure_envelope(port_core.HBM, quick=True)
    assert set(env.policy_gbps) == set(port_core.policies_for(
        port_core.HBM))
    knees = {pol: env.knee_ai(gbps=g) for pol, g in env.policy_gbps.items()}
    best = max(env.policy_gbps, key=lambda k: env.policy_gbps[k])
    assert knees[best] == min(knees.values())


@pytest.mark.parametrize("backend", ["sim", "torchgrid"])
def test_envelope_equals_reference(cpu_backends, backend):
    """The port's envelope on `sim` and on `torchgrid` is the reference's
    on `sim`, field for field (floats at rel 1e-9)."""
    want = ref_rf.measure_envelope(ref_core.HBM, "sim", quick=True)
    got = rf.measure_envelope(port_core.HBM, backend, quick=True)
    assert_same(got, want, f"envelope/{backend}")
    exp = port_core.get_experiment("roofline_empirical")
    assert exp.summary(port_core.HBM, got) == ref_core.get_experiment(
        "roofline_empirical").summary(ref_core.HBM, want)


# ------------------------------------------------------- the card's shapes


def test_cuda_backend_needs_the_card_shapes(cpu_backends):
    """On `cuda` every probe is a contention kernel at B = its tile: the
    experiment's default bursts (32/64 B) are refused, and the card's
    shapes (bursts=(tile,), whole-tile strides) run every probe, one per
    policy (the card ignores the policy)."""
    with pytest.raises(ValueError, match="does not match tile bytes"):
        rf.measure_envelope(port_core.HBM, "cuda", quick=True)
    env = rf.measure_envelope(
        port_core.HBM, "cuda", chip="h100_sxm", bursts=(TILE,),
        strides=(TILE, 4 * TILE), engines=(1, 4), n=16, w=16 * TILE)
    policies = port_core.policies_for(port_core.HBM)
    assert len(env.points) == len(policies) * 2 * 2 * len(PLACEMENTS)
    assert env.chip_name == "h100_sxm"
    assert env.peak_flops == 989.4e12
    assert set(env.policy_gbps) == set(policies)
    assert all(pt.gbps > 0 for pt in env.points)
    # The cross-channel tiers are the per-port samples capped by the
    # modeled fabric: never above its capacity term.
    sw = port_core.SwitchModel(port_core.topology_for(port_core.HBM))
    for pt in env.points:
        if pt.placement != "same_channel":
            assert pt.gbps <= sw.capacity_cap_gbps(pt.placement) + 1e-9


# ------------------------------------------ launch/roofline: the report


def test_report_rows_equal_reference():
    """The measured report's rows and markdown for the same sim envelope
    (the reference's default chip, so the knees are comparable)."""
    from repro.launch import roofline as ref_report
    from repro_torch.launch import roofline as report
    assert report.REPORT_FIELDS == ref_report.REPORT_FIELDS
    assert report.DEFAULT_CHIP == "h100_sxm"
    for spec_name in ALL_SPECS:
        got = rf.measure_envelope(port_core.spec_by_name(spec_name),
                                  quick=True)
        want = ref_rf.measure_envelope(ref_core.spec_by_name(spec_name),
                                       quick=True)
        rows = report.envelope_report_rows(got)
        assert_same(rows, ref_report.envelope_report_rows(want))
        assert [tuple(r) for r in rows] == [report.REPORT_FIELDS] * len(rows)
        assert report.report_markdown(rows) == ref_report.report_markdown(
            ref_report.envelope_report_rows(want))


def test_report_cli_on_sim_matches_reference(tmp_path, capsys, monkeypatch):
    import json
    import sys

    from repro.launch import roofline as ref_report
    from repro_torch.launch import roofline as report
    out, js = tmp_path / "r.md", tmp_path / "r.json"
    report.main(["--measured", "--quick", "--chip", "tpu_v5e", "--out",
                 str(out), "--json-out", str(js)])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["roofline", "--measured", "--quick"])
    ref_report.main()
    assert got == capsys.readouterr().out
    assert out.read_text() == got
    assert len(json.loads(js.read_text())) == 4
    # The default chip is the card's: same bandwidths, its own knees.
    report.main(["--measured", "--quick"])
    h100 = capsys.readouterr().out
    assert h100 != got and h100.count("| measured |") == 4


def test_report_cli_refuses_what_it_cannot_do(cpu_backends, capsys,
                                             tmp_path):
    """At its defaults the measured report probes 32-byte bursts, which
    no CUDA kernel tile matches: `--backend cuda` raises the burst text,
    with no fallback.  Without --measured it runs the analytic mode, as
    the reference does: on a directory without dry-run records it prints
    the table's header and returns (exit code 0)."""
    from repro_torch.launch import roofline as report
    with pytest.raises(ValueError,
                       match="burst B=32 does not match tile bytes 4096"):
        report.main(["--measured", "--backend", "cuda"])
    assert capsys.readouterr().out == ""
    assert report.main(["--in-dir", str(tmp_path)]) is None
    out = capsys.readouterr().out
    assert out.splitlines() == [
        "| arch | shape | mesh | compute ms | memory ms | collective ms |"
        " dominant | useful FLOP frac | roofline frac | peak GiB |",
        "|---|---|---|---|---|---|---|---|---|---|"]
