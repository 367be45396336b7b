"""The bench's `sweep_grid_hbm` row and the two examples that need no LM
(`repro_torch.examples.shuhai_campaign`, `.autotune_layout`) against the
reference's `benchmarks/run.py` and `examples/*.py`, on the CPU.
"""
import json
import re
import runpy
import sys
from pathlib import Path

import pytest

import repro_torch.core as port_core
from repro_torch import bench
from repro_torch.core.engine import CudaBackend
from repro_torch.core.experiments import experiments_for
from repro_torch.examples import autotune_layout, shuhai_campaign

REPO = Path(__file__).resolve().parents[1]
BURST_REFUSAL = re.compile(r"burst B=\d+ does not match tile bytes 4096")
CAPABILITY_REFUSALS = ("(supports_latency=False)",
                       "the concurrent-access cuda kernel measures read "
                       "traffic only")


def _reference_script(name, argv, monkeypatch, capsys):
    """stdout and stderr of the reference's examples/<name>.py."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(str(REPO / "examples" / name), run_name="__main__")
    return capsys.readouterr()


@pytest.fixture
def cpu_cuda_backend():
    """The registered `cuda` backend swapped for one that runs the
    kernels' plain versions on the CPU, restored afterwards."""
    original = port_core.get_backend("cuda")
    port_core.register_backend(CudaBackend(device="cpu"), override=True)
    try:
        yield
    finally:
        port_core.register_backend(original, override=True)


# ------------------------------------------------------- sweep_grid_hbm
@pytest.mark.parametrize("quick", [True, False])
def test_sweep_grid_row_matches_reference(quick):
    from benchmarks import run as ref_bench
    got = bench.bench_sweep_grid(quick)
    want = ref_bench.bench_sweep_grid(quick)
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]
    assert got[0][0] == "sweep_grid_hbm"


def test_default_suite_prints_the_sweep_grid_row(tmp_path, capsys):
    """Between the experiments and the resources, as the reference orders
    its suite; the device rung fails without a card and the run exits 1
    after writing every other row."""
    out = tmp_path / "bench.json"
    with pytest.raises(SystemExit):
        bench.main(["--quick", "--experiments", "fig4_refresh", "--json",
                    str(out)])
    capsys.readouterr()
    rows = json.loads(out.read_text())["rows"]
    assert [r["name"] for r in rows] == [
        "fig4_refresh_hbm", "fig4_refresh_ddr4", "sweep_grid_hbm",
        "table3_resources_h100", "oracle_autotune"]
    assert rows[2]["derived"] == bench.bench_sweep_grid(True)[0][2]


# ------------------------------------------------------------- examples
def test_campaign_on_sim_prints_what_the_reference_prints(monkeypatch,
                                                          capsys):
    argv = ["--specs", "hbm", "--experiments",
            "table5_total_throughput,duplex_rw_sweep"]
    shuhai_campaign.main(argv)
    got = capsys.readouterr()
    want = _reference_script("shuhai_campaign.py", argv, monkeypatch, capsys)
    assert got.out == want.out
    assert got.err == want.err
    assert got.out.count("\n") > 5


def test_campaign_csv_and_skips_match_the_reference(tmp_path, monkeypatch,
                                                    capsys):
    """--csv, and an explicitly requested experiment the spec cannot run
    (a switch suite on DDR4), reported as the reference reports it."""
    port_csv, ref_csv = tmp_path / "port.csv", tmp_path / "ref.csv"
    argv = ["--specs", "ddr4", "--experiments",
            "fig4_refresh,table6_switch_latency"]
    shuhai_campaign.main(argv + ["--csv", str(port_csv)])
    got = capsys.readouterr()
    want = _reference_script("shuhai_campaign.py",
                             argv + ["--csv", str(ref_csv)], monkeypatch,
                             capsys)
    assert port_csv.read_text() == ref_csv.read_text()
    assert got.err == want.err
    assert "skipping table6_switch_latency on ddr4" in got.err
    assert got.out.replace("port.csv", "ref.csv") == want.out


def test_campaign_rejects_unknown_names():
    with pytest.raises(SystemExit, match="unknown memory spec 'bogus'"):
        shuhai_campaign.main(["--specs", "bogus"])
    with pytest.raises(SystemExit, match="shuhai_campaign: "):
        shuhai_campaign.main(["--experiments", "no_such_experiment"])


def test_campaign_on_cuda_refuses_and_never_falls_back(cpu_cuda_backend,
                                                       capsys):
    """On `cuda` every experiment of HBM is refused, for its burst or for
    a capability the card's kernels lack, and none is answered by `sim`."""
    shuhai_campaign.main(["--specs", "hbm", "--backend", "cuda"])
    got = capsys.readouterr()
    assert got.out.strip().splitlines() == ["system,experiment,key,value"]
    refusals = dict(re.findall(r"skipping (\S+) on hbm/cuda: (.*)",
                               got.err))
    names = [exp.name for exp in experiments_for(port_core.HBM)]
    assert sorted(refusals) == sorted(names)
    burst = [n for n in names if BURST_REFUSAL.search(refusals[n])]
    capability = [n for n in names
                  if any(t in refusals[n] for t in CAPABILITY_REFUSALS)]
    assert sorted(burst + capability) == sorted(names)
    assert "burst B=32 does not match tile bytes 4096" in got.err


def test_autotune_layout_prints_what_the_reference_prints(monkeypatch,
                                                          capsys):
    autotune_layout.main()
    got = capsys.readouterr().out
    want = _reference_script("autotune_layout.py", [], monkeypatch,
                             capsys).out
    assert got == want
    for title in ("KV cache (decode sweeps seq):",
                  "Saved activations (backward sweeps layers):",
                  "Expert weights (dispatch sweeps experts):"):
        assert title in got


# ------------------------------------------------------- quickstart
def _sections(text):
    """{section number: its lines} of a quickstart's output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"=== (\d)\. ", line)
        if m:
            cur = int(m.group(1))
        if cur is not None and line.strip():
            out.setdefault(cur, []).append(line)
    return out


def test_quickstart_on_the_cpu_prints_what_the_reference_prints(
        monkeypatch, capsys):
    """`--device cpu`: sections 1 (Shuhai on the simulated U280) and 3
    (the memory oracle) print the reference script's lines; step 2's
    checksum (the plain version of rst_read) equals the reference's
    (Pallas interpret mode) within rel 1e-6; it ends with quickstart OK."""
    from repro_torch.examples import quickstart
    sample = quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out
    ref = _reference_script("quickstart.py", [], monkeypatch, capsys).out
    gs, rs = _sections(got), _sections(ref)
    assert gs[1] == rs[1] and gs[3] == rs[3]
    checksum = re.compile(r"(\d+) bytes read, checksum\[0,0\]=([\d.]+)")
    (gb, gc), (rb, rc) = checksum.search(got).groups(), \
        checksum.search(ref).groups()
    assert gb == rb
    assert float(sample.checksum[0, 0]) == pytest.approx(float(rc),
                                                         rel=1e-6)
    assert got.rstrip().endswith("quickstart OK")
    assert "RST read engine (plain PyTorch on cpu)" in got
    assert "finite=True on cpu" in got
