"""The port's main path as a whole against the reference: every ported
experiment on every registered spec through the `sim` backend, a Sweep
through the `cuda` backend's CPU path, the bench CLI, and the rule that
the port loads neither JAX nor the reference package.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.experiments import run_experiment as ref_run
from repro.kernels import ops as ref_ops
from repro_torch import bench
from repro_torch.core.engine import CudaBackend
from repro_torch.core.experiments import all_experiments
from repro_torch.core.experiments import run_experiment as port_run
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels.rst_read import rst_read
from repro_torch.kernels.rst_write import rst_write
from test_torch_contend import as_port_text
from test_torch_core import SPEC_NAMES, assert_same

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")

PORTED = ["fig4_refresh", "table4_idle_latency", "fig6_address_mapping",
          "fig7_locality", "table5_total_throughput",
          "table6_switch_latency", "fig8_switch_throughput",
          "table5_write_throughput", "fig7_write_locality",
          "duplex_rw_sweep", "table4_write_latency_classes",
          "fig9_channel_contention", "contention_scaling_sweep",
          "arbitration_granularity_sweep", "fig9_cross_switch_contention",
          "contended_latency_classes", "engine_mix_sweep",
          "grid_cross_product", "roofline_empirical", "layout_autotune"]


def test_registry_holds_the_ported_experiments():
    assert [e.name for e in all_experiments()] == PORTED
    for exp in all_experiments():
        ref = ref_core.get_experiment(exp.name)
        assert (exp.artifact, exp.title, exp.defaults, exp.quick,
                exp.bench, exp.requires_switch, exp.bench_label,
                exp.bench_specs) == (
            ref.artifact, ref.title, ref.defaults, ref.quick, ref.bench,
            ref.requires_switch, ref.bench_label, ref.bench_specs)


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("spec_name", SPEC_NAMES)
def test_experiment_matches_reference(name, spec_name):
    ps = port_core.spec_by_name(spec_name)
    rs = ref_core.spec_by_name(spec_name)
    exp = port_core.get_experiment(name)
    if not exp.available_on(ps):
        with pytest.raises(ValueError, match="switch"):
            port_run(name, ps, quick=True)
        return
    got = port_run(name, ps, "sim", quick=True)
    want = ref_run(name, rs, "sim", quick=True)
    assert_same(got, want, f"{name}/{spec_name}")
    assert exp.summary(ps, got) == ref_core.get_experiment(name).summary(
        rs, want)


CONTENTION_EXPERIMENTS = [
    "fig9_channel_contention", "contention_scaling_sweep",
    "arbitration_granularity_sweep", "fig9_cross_switch_contention",
    "contended_latency_classes", "engine_mix_sweep"]


def test_cuda_backend_refuses_what_it_lacks(cpu_cuda_backend):
    """Latency has no timers on the card.  The contention experiments run
    at the paper's 32-byte bursts and a mix with a writer, which the
    contention kernels refuse exactly as the reference's `pallas` kernels
    do: the same exception type, and the same text with the reference's
    substrate names read as the port's."""
    with pytest.raises(ValueError, match="supports_latency=False"):
        port_run("table4_idle_latency", port_core.HBM, "cuda", quick=True)
    for name in CONTENTION_EXPERIMENTS:
        with pytest.raises(Exception) as want:
            ref_run(name, ref_core.HBM, "pallas", quick=True)
        with pytest.raises(Exception) as got:
            port_run(name, port_core.HBM, "cuda", quick=True)
        assert type(got.value) is type(want.value) is ValueError, name
        assert str(got.value) == as_port_text(str(want.value)), name


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


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts the calls the measurements make to the kernel wrappers (on
    the CPU no kernel launches, so the launch counters stay put)."""
    calls = {"rst_read": 0, "rst_write": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(port_ops, "rst_read", spy("rst_read", rst_read))
    monkeypatch.setattr(port_ops, "rst_write", spy("rst_write", rst_write))
    return calls


TILE = 4096


@pytest.mark.parametrize("s_tiles,w_tiles,a_tiles,n", [
    (1, 16, 0, 16), (2, 16, 0, 24), (4, 8, 2, 9), (8, 8, 0, 5)])
def test_sweep_through_cuda_backend_on_cpu(cpu_cuda_backend, wrapper_calls,
                                           s_tiles, w_tiles, a_tiles, n):
    kw = dict(n=n, b=TILE, s=TILE * s_tiles, w=TILE * w_tiles,
              a=TILE * a_tiles)
    sweep = port_core.Sweep(port_core.HBM, backend="cuda")
    for op in ("read", "write", "duplex"):
        sweep.add(port_core.RSTParams(**kw), op=op)
    launches = (rst_read.launches, rst_write.launches)
    results = sweep.run()
    # Read once warm plus 5 timed; write the same; duplex both, 6 times.
    assert wrapper_calls == {"rst_read": 12, "rst_write": 12}
    assert (rst_read.launches, rst_write.launches) == launches
    measurers = {"read": ref_ops.measure_read_bandwidth,
                 "write": ref_ops.measure_write_bandwidth,
                 "duplex": ref_ops.measure_duplex_bandwidth}
    for r in results:
        want = measurers[r.point.op](ref_core.RSTParams(**kw))
        assert r.value.bound == "measured" and not r.cached
        assert r.value.detail["bytes"] == want.bytes_moved
        assert r.value.gbps > 0
        assert r.value.detail["checksum"] == pytest.approx(
            float(np.sum(np.asarray(want.checksum), dtype=np.float64)),
            rel=1e-6)


def test_engine_register_flow_on_cuda_backend(cpu_cuda_backend):
    p = port_core.RSTParams(n=8, b=TILE, s=TILE, w=16 * TILE)
    eng = port_core.Engine(channel=0, spec=port_core.HBM, backend="cuda")
    eng.configure_read(p)
    eng.configure_write(p)
    assert eng.read_throughput().detail["bytes"] == 8 * TILE
    assert eng.write_throughput().detail["bytes"] == 8 * TILE
    assert eng.duplex_throughput().detail["bytes"] == 2 * 8 * TILE
    with pytest.raises(port_core.UnsupportedCapability, match="'cuda'"):
        eng.capture_latency_list("read")


def test_bench_experiment_rows_match_reference():
    from benchmarks import run as ref_bench
    names = "fig4_refresh,table5_total_throughput,duplex_rw_sweep"
    got = bench.bench_experiments(True, names)
    want = ref_bench.bench_experiments(True, names)
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]


def test_bench_device_rung_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.bench_h100_rst_kernel(quick=True)
    rows = bench.bench_table3_resources()
    assert rows[0][2] == ("smem_tile_bytes=0;register_tile_bytes=4096;"
                          "register_bytes=64")


# ------------------------------------------------------------- isolation


def _port_modules():
    mods = []
    pkg_root = os.path.join(SRC, "repro_torch")
    for dirpath, _, files in os.walk(pkg_root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), SRC)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _foreign(name):
    return name == "jax" or name.startswith(("jax.", "jaxlib")) or \
        name == "repro" or name.startswith("repro.")


def test_port_imports_neither_jax_nor_reference():
    mods = _port_modules()
    assert {"repro_torch.kernels.rst_read", "repro_torch.core.timing_torch",
            "repro_torch.core.roofline_empirical",
            "repro_torch.launch.mesh", "repro_torch.core._timing_reference",
            "repro_torch.core.oracle", "repro_torch.core.autotune",
            "repro_torch.runtime", "repro_torch.runtime.fault_tolerance",
            "repro_torch.service", "repro_torch.service.campaign",
            "repro_torch.service.faults", "repro_torch.service.retry",
            "repro_torch.launch.roofline", "repro_torch.analysis.lint",
            "repro_torch.analysis.kernel_shapes",
            "repro_torch.examples.shuhai_campaign",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.gemma3_1b", "repro_torch.models",
            "repro_torch.models.common", "repro_torch.models.attention",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.transformer", "repro_torch.models.encdec",
            "repro_torch.models.registry", "repro_torch.serving",
            "repro_torch.serving.engine",
            "repro_torch.examples.serve_lm", "repro_torch.optim",
            "repro_torch.optim.schedule", "repro_torch.optim.adamw",
            "repro_torch.optim.compression", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.checkpoint",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.launch.train",
            "repro_torch.examples.train_lm"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_sources_import_neither_jax_nor_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    for f in files:
        tree = ast.parse(open(f).read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _foreign(name), f"{f} imports {name}"
