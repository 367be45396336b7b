"""The port's dry run (repro_torch.launch.dryrun, .comm_analysis) and the
analytic half of its roofline (repro_torch.launch.roofline) against the
reference's, on the CPU.

* `_shape_rules` and `_n_micro` equal the reference's for all 80 cells;
* `run_cells(..., compile_=False)` lowers 66 cells and skips 14, and a
  traced cell at `smoke()` size on an 8-way (2, 2, 2) mesh (the
  reference's mini dry run, tests/launch/test_launch.py) has every key
  the roofline reads, with `argument_bytes` equal to the sum of the
  reference's shard-shape bytes (the reference's side in a subprocess
  with 8 forced host devices) and its traced figures under the
  upper-bound keys; on a 1 x 1 mesh the argument bytes equal the bytes
  of the tensors a step holds, and the traced figures are the device's;
* the trace: FLOPs equal FlopCounterMode's; the one-layer-per-kind
  shortcut's operations, FLOPs, bytes and matrix products equal the
  whole-depth trace for every arch and step kind, and its estimated peak
  is within 15 % of it; the shortcut is taken by the operation count,
  not the clock; `remat_duplication` is 1.0 without remat and above 1
  with;
* `collective_bytes` on hand-worked cases;
* the analytic roofline: `active_params`, `tokens_of`, `model_flops` and
  `analytic_terms` equal the reference's (rel 1e-12) for all 40 cells x
  2 meshes at each cell's `n_micro`; on one set of records,
  `analyze_cell`, `to_markdown`, `analytic_report_rows`, `advise` and
  `main()`'s output equal the reference's on `--chip tpu_v5e`.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.launch import roofline as ref_roofline
from repro.launch import shapes as ref_shapes
from repro.launch import train as ref_train
from repro_torch.configs import get_config
from repro_torch.launch import comm_analysis, dryrun, roofline, shapes, train
from repro_torch.launch import serve as serve_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch import optim
from repro_torch.models.common import (DEFAULT_RULES, ParamSpec,
                                       init_params, param_shapes,
                                       tree_leaves, tree_unflatten)
from repro_torch.models.registry import build
from test_torch_launch import RefMesh, ref_shape_rules

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s, m) for a in ARCH_IDS for s in ref_shapes.SHAPES
         for m in MESHES]


def _child(code, timeout=900):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ------------------------------------------------------- rules, n_micro


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_shape_rules_and_n_micro_equal_the_reference(arch, shape, mesh):
    rd = ref_shape_rules()
    dims, names = MESHES[mesh]
    cfg, rcfg = get_config(arch), ref_config(arch)
    s, rs = shapes.SHAPES[shape], ref_shapes.SHAPES[shape]
    pm, rm = make_mesh(dims, names), RefMesh(dims, names)
    rules = dryrun._shape_rules(train.make_rules(cfg, pm), s, pm, cfg)
    assert rules == rd._shape_rules(ref_train.make_rules(rcfg, rm), rs, rm,
                                    rcfg)
    assert outcome(dryrun._n_micro, cfg, s, pm) == \
        outcome(rd._n_micro, rcfg, rs, rm)


def outcome(fn, *args):
    """fn's value, or the name of what it raised (long_500k's batch of
    one has no shard per data rank: both packages divide by zero, and
    neither calls it for a serving cell)."""
    try:
        return fn(*args)
    except ZeroDivisionError as e:
        return type(e).__name__


# ------------------------------------------------------- cells


def test_lowering_every_cell():
    rs = dryrun.run_cells(ARCH_IDS, list(shapes.SHAPES), [False, True],
                          None, compile_=False)
    st = [r["status"] for r in rs]
    assert len(st) == 80
    assert (st.count("LOWERED"), st.count("SKIP"), st.count("FAIL")) == \
        (66, 14, 0)
    assert torch.cuda.is_initialized() is False
    assert sorted(rs[0]) == ["arch", "kind", "lower_s", "mesh", "n_micro",
                             "shape", "status"]


MINI = ["gemma3-1b", "rwkv6-7b", "deepseek-v2-lite-16b"]
MINI_SHAPE = ("mini", 64, 8, "train")

REF_MINI = textwrap.dedent("""
    import os, json, math
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    jax.devices()
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.launch import train as train_lib
    from repro.launch.dryrun import _shape_rules
    from repro.launch.mesh import make_mesh
    from repro.launch.shapes import ShapeSpec, batch_shardings, input_specs
    from repro.models.registry import build
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    shape = ShapeSpec(*{shape!r})
    out = {{}}

    def nbytes(leaves, shardings):
        return sum(math.prod(s.shard_shape(l.shape)) * l.dtype.itemsize
                   for l, s in zip(leaves, shardings))

    for arch in {archs!r}:
        cfg = get_config(arch, smoke=True)
        model = build(cfg)
        rules = _shape_rules(train_lib.make_rules(cfg, mesh), shape, mesh,
                             cfg)
        st = train_lib.abstract_state(model)
        sh = train_lib.state_shardings(model.param_specs(), rules, mesh)
        b = input_specs(cfg, shape)
        bs = batch_shardings(cfg, shape, mesh, rules)
        out[arch] = (nbytes(jax.tree.leaves(st), jax.tree.leaves(sh))
                     + nbytes([b[k] for k in b], [bs[k] for k in b]))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def mini_records():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    port = {arch: dryrun.lower(get_config(arch, smoke=True),
                               ShapeSpec(*MINI_SHAPE), mesh)
            for arch in MINI}
    port["cuda"] = torch.cuda.is_initialized()
    ref = _child(REF_MINI.format(archs=MINI, shape=MINI_SHAPE))
    return port, ref


@pytest.mark.parametrize("arch", MINI)
def test_traced_mini_cell(arch, mini_records):
    port, ref = mini_records
    rec = port[arch]
    assert port["cuda"] is False
    assert rec["status"] == "OK" and rec["n_micro"] >= 1
    assert rec["trace_mode"] == "full"
    # The model axis splits what the trace holds whole: the traced
    # figures are upper bounds, under keys of their own.
    assert rec["trace_scope"] == "data_shard"
    mem, cost = rec["memory"], rec["cost"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes", "peak_per_device_gib",
                        "output_bytes_upper", "temp_bytes_upper",
                        "peak_upper_gib"}
    assert mem["argument_bytes"] == ref[arch]
    assert (mem["output_bytes"], mem["temp_bytes"],
            mem["peak_per_device_gib"]) == (None, None, None)
    assert mem["alias_bytes"] < mem["argument_bytes"] < \
        mem["argument_bytes"] + mem["temp_bytes_upper"]
    assert mem["output_bytes_upper"] > mem["alias_bytes"]
    assert mem["peak_upper_gib"] > mem["argument_bytes"] / 2**30 > 0
    assert (cost["flops"], cost["bytes_accessed"]) == (None, None)
    assert cost["flops_upper"] > 0 and cost["bytes_accessed_upper"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["remat_dup"] == 1.0        # smoke configs: remat "none"
    full = {**rec, "arch": arch, "shape": "train_4k", "mesh": "2x16x16",
            "kind": "train"}
    row = roofline.analyze_cell(full)      # every key the roofline reads
    assert row["peak_gib"] is None and row["hlo_raw_flops"] is None
    assert "| None |" in roofline.to_markdown([row], [])


def _held(*trees):
    return sum(t.numel() * t.element_size() for tr in trees
               for t in tree_leaves(tr) if isinstance(t, torch.Tensor))


def test_argument_bytes_equal_the_tensors_a_step_holds():
    """Phase 11b of chip_smoke.py at smoke size on the CPU: on a 1 x 1
    mesh the dry run's argument bytes are the bytes of the state, cache
    and batch tensors the real step takes, and the traced figures stand
    under the reference's keys (the trace is the device's own step)."""
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = get_config("gemma3-1b", smoke=True)
    model = build(cfg)
    gen = torch.Generator().manual_seed(0)
    rec = dryrun.lower(cfg, ShapeSpec("card_train", 32, 4, "train"), mesh)
    state = train.init_state(model, cfg, device="cpu")
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    assert rec["memory"]["argument_bytes"] == _held(state, batch)
    assert rec["n_micro"] == 1 and rec["trace_scope"] == "device"
    assert rec["memory"]["temp_bytes"] > 0 and rec["cost"]["flops"] > 0
    assert not any(k.endswith(("_upper", "_upper_gib"))
                   for k in {**rec["memory"], **rec["cost"]})
    train.make_train_step(model, cfg, None, optim.AdamWConfig())(state,
                                                                 batch)
    rec = dryrun.lower(cfg, ShapeSpec("card_decode", 64, 4, "decode"), mesh)
    params = init_params(gen, model.param_specs(), device="cpu")
    cache = model.init_cache(batch_size=4, max_seq=64, device="cpu")
    tokens = torch.zeros((4, 1), dtype=torch.int32)
    assert rec["memory"]["argument_bytes"] == _held(params, cache, tokens)
    assert rec["memory"]["alias_bytes"] == _held(cache)
    assert rec["trace_scope"] == "device"
    serve_lib.make_decode_step(model)(params, cache, tokens)


# ------------------------------------------------------- the trace


def _inputs(cfg, kind, b=2, s=32):
    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    if kind == "decode":
        return {"tokens": meta(b, 1)}
    out = {"tokens": meta(b, s)}
    if kind == "train":
        out["labels"] = meta(b, s)
    if cfg.mrope_sections:
        out["mrope_positions"] = meta(3, b, s)
    if cfg.is_encdec:
        out["frames"] = meta(b, cfg.enc_dec.enc_seq, cfg.d_model,
                             dtype=torch.bfloat16)
    return out


STEP_KINDS = {"train": ("train", "none"),
              "train-remat": ("train", "save_boundaries"),
              "prefill": ("prefill", "none"), "decode": ("decode", "none")}


@pytest.mark.parametrize("step", sorted(STEP_KINDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shortcut_equals_the_whole_depth(arch, step):
    kind, remat = STEP_KINDS[step]
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    inputs = _inputs(cfg, kind)
    short = dryrun.traced_cost(cfg, kind, inputs, 64, shortcut=True)
    full = dryrun.traced_cost(cfg, kind, inputs, 64, shortcut=False)
    assert (short["trace_mode"], full["trace_mode"]) == ("shortcut", "full")
    for key in dryrun._ADDITIVE:
        assert short[key] == full[key], key
    assert abs(short["peak"] / full["peak"] - 1) <= 0.15
    assert full["flops_micro"] > 0 and full["peak"] > 0


def test_shortcut_is_decided_by_the_operation_count(monkeypatch):
    """The shortcut is taken iff the one-of-each trace's operations,
    scaled to the whole depth, exceed SHORTCUT_OPS: the same cell takes
    the same trace however loaded the host is."""
    cfg = get_config("gemma3-1b", smoke=True)
    inputs = _inputs(cfg, "decode")
    base = dryrun.trace_step(dryrun.depth_config(
        cfg, {k: 1 for k in dryrun.layer_kinds(cfg)}), "decode", inputs, 64)
    kinds = dryrun.layer_kinds(cfg)
    estimate = base["ops"] * sum(kinds.values()) / len(kinds)
    for limit, mode in ((estimate, "full"), (estimate - 1, "shortcut")):
        monkeypatch.setattr(dryrun, "SHORTCUT_OPS", limit)
        assert dryrun.traced_cost(cfg, "decode", inputs, 64)["trace_mode"] \
            == mode


def test_records_say_which_trace_ran(tmp_path, monkeypatch):
    """A written record keeps "trace_mode" and "trace_scope"; a
    production mesh's traced figures are upper bounds, and the report
    prints no peak for it."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, smoke=True))
    (rec,) = dryrun.run_cells(["gemma3-1b"], ["decode_32k"], [False],
                              str(tmp_path))
    (path,) = tmp_path.glob("*.json")
    written = json.loads(path.read_text())
    assert written == json.loads(json.dumps(rec))
    assert (written["trace_mode"], written["trace_scope"]) == \
        ("full", "data_shard")
    assert "trace" not in written
    assert written["memory"]["peak_per_device_gib"] is None
    assert written["memory"]["peak_upper_gib"] > 0
    assert roofline.analyze_cell(written)["peak_gib"] is None


def test_layer_kinds_and_depth_configs():
    cfg = get_config("gemma3-1b")
    kinds = dryrun.layer_kinds(cfg)
    assert kinds == {(False, False): 22, (True, False): 4}
    small = dryrun.depth_config(cfg, {(False, False): 2, (True, False): 1})
    assert small.num_layers == 3 and dryrun.layer_kinds(small) == \
        {(False, False): 2, (True, False): 1}
    ds = get_config("deepseek-v2-lite-16b")
    assert dryrun.layer_kinds(ds) == {(True, True): 1, (True, False): 26}
    small = dryrun.depth_config(ds, {(True, True): 1, (True, False): 2})
    assert small.moe_dense_layers == (0,) and small.num_layers == 3
    wh = get_config("whisper-small")
    small = dryrun.depth_config(wh, {("enc",): 1, ("dec",): 2})
    assert (small.enc_dec.enc_layers, small.num_layers) == (1, 2)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_trace_flops_equal_flop_counter_mode(kind):
    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                              remat="save_boundaries")
    inputs = _inputs(cfg, kind)
    got = dryrun.trace_step(cfg, kind, inputs, 64)
    model = build(cfg)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            state = train.abstract_state(model)
            _, grads = train.step_grads(model, state.master, inputs, None)
            optim.apply(tree_unflatten(state.master, grads), state,
                        optim.AdamWConfig(), 1.0)
        else:
            params = param_shapes(model.param_specs())
            cache = serve_lib.abstract_cache(model, 2, 64)
            with torch.no_grad():
                if kind == "prefill":
                    serve_lib.make_prefill_step(model)(params, inputs, cache)
                else:
                    serve_lib.make_decode_step(model)(params, cache,
                                                      inputs["tokens"])
    assert got["flops_micro"] + got["flops_once"] == fc.get_total_flops()
    assert got["flops_micro"] > 0


def test_remat_duplication():
    base = get_config("gemma3-1b", smoke=True)
    counts = {}
    for policy in ("none", "save_boundaries"):
        cfg = dataclasses.replace(base, remat=policy)
        counts[policy] = dryrun.trace_step(cfg, "train",
                                           _inputs(cfg, "train"), 64)
    none = counts["none"]["matmuls"]
    assert comm_analysis.remat_duplication(none, none) == 1.0
    assert comm_analysis.remat_duplication(
        counts["save_boundaries"]["matmuls"], none) > 1.0
    assert comm_analysis.remat_duplication(3, 0) == 1.0
    # the same matrix products, the forward's dispatched twice
    assert counts["save_boundaries"]["flops_micro"] > \
        counts["none"]["flops_micro"]


# ------------------------------------------------------- collectives


TWO_LEAVES = {"a": ParamSpec((8, 6), ("embed", "mlp")),
              "b": ParamSpec((6, 8), ("mlp", "embed"))}


def test_collective_bytes_two_leaves_train():
    """data 2 x model 2, bf16, 2 microbatches.  a: spec (data, model),
    shard (4, 3), gathered over data to (8, 3) = 24 elements; b likewise.
    all-gather 2 leaves x 2 passes x 24 x 2 B = 192 B; reduce-scatter
    2 x 2 x 12 x 2 B = 96 B."""
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = train.make_rules(get_config("gemma3-1b"), mesh)
    rules.update(embed="data", mlp="model")
    out = comm_analysis.collective_bytes("train", TWO_LEAVES, rules, mesh,
                                         tokens=64, n_micro=2)
    assert out == {"all-gather": 192.0, "reduce-scatter": 96.0,
                   "total": 288.0, "all-gather_count": 4.0,
                   "reduce-scatter_count": 4.0}


def test_collective_bytes_two_leaves_decode():
    """Decode, 3 sequences per device.  Both leaves gathered once (96 B).
    b's input dimension (mlp) is split over model: a residual combine of
    3 rows x its gathered width 8 x 2 B = 48 B.  A stacked v cache
    (L=2, B=4, S=16, KH=2, D=4) with its sequence split over model
    (2 ways) and batch over data: per layer one token's row (2, 1, 2, 4)
    in float32 = 64 B, twice."""
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = dict(DEFAULT_RULES, embed="data", mlp="model", batch="data",
                 cache_seq="model", cache_heads=None)
    cache = {"stack": {"mixer": {
        "v": torch.empty((2, 4, 16, 2, 4), device="meta"),
        "k": torch.empty((2, 4, 16, 2, 4), device="meta")}}}
    shard = serve_lib.cache_shardings(cache, mesh, rules)
    out = comm_analysis.collective_bytes(
        "decode", TWO_LEAVES, rules, mesh, tokens=3, cache=cache,
        cache_shardings=shard)
    assert out == {"all-gather": 96.0, "all-reduce": 48.0 + 128.0,
                   "total": 272.0, "all-gather_count": 2.0,
                   "all-reduce_count": 3.0}


# ------------------------------------------------------- analytic roofline


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_equal_the_reference(arch):
    assert roofline.active_params(arch) == ref_roofline.active_params(arch)


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_analytic_terms_equal_the_reference(arch, shape, mesh):
    dims, names = MESHES[mesh]
    s = shapes.SHAPES[shape]
    # a record carries n_micro for training; analyze_cell reads 1 else
    n_micro = (dryrun._n_micro(get_config(arch), s, make_mesh(dims, names))
               if s.kind == "train" else 1)
    assert roofline.tokens_of(shape) == ref_roofline.tokens_of(shape)
    assert roofline.model_flops(arch, shape) == pytest.approx(
        ref_roofline.model_flops(arch, shape), rel=1e-12)
    got = roofline.analytic_terms(arch, shape, mesh, n_micro)
    ref = ref_roofline.analytic_terms(arch, shape, mesh, n_micro)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-12), k


def _records():
    """Dry-run records as both packages write them: OK cells of three
    kinds on both meshes, and the skipped long_500k cells."""
    recs = []
    for i, (arch, shape) in enumerate([
            ("gemma3-1b", "train_4k"), ("gemma3-1b", "decode_32k"),
            ("qwen2-moe-a2.7b", "prefill_32k"), ("rwkv6-7b", "long_500k"),
            ("mistral-large-123b", "train_4k"),
            ("deepseek-v2-lite-16b", "decode_32k")]):
        for mesh in MESHES:
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "kind": ref_shapes.SHAPES[shape].kind, "status": "OK",
                   "memory": {"peak_per_device_gib": 1.5 + i},
                   "cost": {"flops": 1e12 * (i + 1),
                            "bytes_accessed": 1e9},
                   "collectives": {"total": 1e6 * i}}
            if rec["kind"] == "train":
                rec["n_micro"] = 8 if mesh == "16x16" else 4
            recs.append(rec)
    for arch in ("starcoder2-7b", "whisper-small"):
        ok, reason = ref_shapes.cell_is_runnable(
            ref_config(arch), ref_shapes.SHAPES["long_500k"])
        recs.append({"arch": arch, "shape": "long_500k", "mesh": "16x16",
                     "kind": "decode", "status": "SKIP", "reason": reason})
    return recs


def test_analytic_report_equals_the_reference(tmp_path, capsys,
                                              monkeypatch):
    from repro.core.hwspec import chip_by_name as ref_chip
    from repro_torch.core.hwspec import chip_by_name
    recs = _records()
    for i, r in enumerate(recs):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    chip, rchip = chip_by_name("tpu_v5e"), ref_chip("tpu_v5e")
    rows = [roofline.analyze_cell(r, chip) for r in recs]
    rrows = [ref_roofline.analyze_cell(r, rchip) for r in recs]
    assert rows == rrows and rows.count(None) == 2
    rows = [r for r in rows if r]
    assert [roofline.advise(r) for r in rows] == \
        [ref_roofline.advise(r) for r in rows]
    skips = [r for r in recs if r["status"] == "SKIP"]
    assert roofline.to_markdown(rows, skips) == \
        ref_roofline.to_markdown(rows, skips)
    assert roofline.analytic_report_rows(rows, chip) == \
        ref_roofline.analytic_report_rows(rows, rchip)
    assert roofline.load_records(str(tmp_path)) == \
        ref_roofline.load_records(str(tmp_path))
    got_md, ref_md = tmp_path / "p.md", tmp_path / "r.md"
    roofline.main(["--in-dir", str(tmp_path), "--chip", "tpu_v5e",
                   "--out", str(got_md), "--json-out",
                   str(tmp_path / "p.out")])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [
        "roofline", "--in-dir", str(tmp_path), "--chip", "tpu_v5e", "--out",
        str(ref_md), "--json-out", str(tmp_path / "r.out")])
    ref_roofline.main()
    assert got == capsys.readouterr().out
    assert "Worst roofline fraction:" in got
    assert got_md.read_text() == ref_md.read_text()
    assert json.loads((tmp_path / "p.out").read_text()) == \
        json.loads((tmp_path / "r.out").read_text())


def test_analytic_report_on_the_default_chip(tmp_path, capsys):
    for i, r in enumerate(_records()):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    roofline.main(["--in-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("| analytic |") == 12
    rows = [roofline.analyze_cell(r) for r in _records()]
    assert {r["chip"] for r in rows if r} == {"h100_sxm"}
