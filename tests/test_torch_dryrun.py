"""The port's dry run (repro_torch.launch.dryrun, .comm_analysis) and the
analytic half of its roofline (repro_torch.launch.roofline) against the
reference's, on the CPU.

* `_shape_rules` and `_n_micro` equal the reference's for all 80 cells;
* `run_cells(..., compile_=False)` lowers 66 cells and skips 14, and a
  traced cell at `smoke()` size on an 8-way (2, 2, 2) mesh (the
  reference's mini dry run, tests/launch/test_launch.py) has every key
  the roofline reads, with `argument_bytes` equal to the sum of the
  reference's shard-shape bytes and to XLA's `memory_analysis()`, and
  its per-device peak within PEAK_TO_REF of XLA's (PEAK_TO_REF_OF for
  an arch measured apart; the reference's side
  in a subprocess with 8 forced host devices), all under the
  reference's keys (the trace is partitioned over the mesh); on a
  1 x 1 mesh the argument bytes equal the bytes of the tensors a step
  holds, and the plain trace is the device's; deepseek's mini prefill
  over a slot-split cache moves no bool tensor and holds no float32
  routing tensor at its peak;
* the trace: FLOPs equal FlopCounterMode's; the shortcut over periods
  of the layer pattern (kept in the model's order) gives the whole-depth
  trace's operations, FLOPs, bytes, matrix products and peak for every
  arch and step kind at smoke() and at deeper depths, one with a
  remainder among them; the shortcut is taken by the operation count,
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
from repro_torch.models import moe
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


# 16x16 cells the partitioned trace once failed on, by their cause: the
# MoE dispatch's groups split over the data axis, a view of rwkv6's
# d_model split over both mesh axes, whisper's 1500 frames, which 16 does
# not divide.  These trace in about 30 s or less each on one core; the
# train steps of qwen2-moe-a2.7b, deepseek-v2-lite-16b and rwkv6-7b take
# longer and are traced by chip_smoke.py (phase 11c).
REPAIRED = [("qwen2-moe-a2.7b", "prefill_32k"),
            ("deepseek-v2-lite-16b", "prefill_32k"),
            ("rwkv6-7b", "long_500k"), ("whisper-small", "train_4k"),
            ("whisper-small", "prefill_32k"), ("whisper-small", "decode_32k")]


@pytest.mark.parametrize("arch,shape", REPAIRED)
def test_repaired_cell_traces_partitioned(arch, shape):
    rec = dryrun.lower_cell(arch, shape, False)
    assert rec["status"] == "OK", rec
    assert (rec["partitioned"], rec["trace_scope"]) == (True, "device")
    assert rec["memory"]["peak_per_device_gib"] > 0
    assert rec["cost"]["flops"] > 0
    assert rec["collectives_traced"]["total"] > 0


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


MINI = ["gemma3-1b", "rwkv6-7b", "deepseek-v2-lite-16b", "qwen2-moe-a2.7b",
        "whisper-small"]
MINI_SHAPE = ("mini", 64, 8, "train")
# The mini cells, each (shape, attn_kv_chunk or None for the config's):
# the train step, a prefill of 64 tokens, a decode step over 64 slots
# (scored whole), and one over 256 slots in chunks of 32, so the chunked
# path runs on both sides from the same config.
MINI_CELLS = {"train": (MINI_SHAPE, None),
              "prefill": (("mini", 64, 8, "prefill"), None),
              "decode": (("mini", 64, 8, "decode"), None),
              "decode_chunked": (("mini", 256, 8, "decode"), 32)}
# Where an arch's cell differs: qwen2-moe trains 32 x 256 tokens, four
# routing groups of GROUP_SIZE (2048), one on each (pod, data) rank, so
# the groups are routed split, as in its production train_4k and
# prefill_32k cells.
MINI_SHAPES = {("qwen2-moe-a2.7b", "train"): ("mini", 256, 32, "train")}
# whisper's encoder frames at mini size, which the model axis (2) does
# not divide, as 16 does not divide its production cells' 1500.
MINI_ENC_SEQ = 15


def mini_cells(arch):
    """`MINI_CELLS` with `arch`'s own shapes."""
    return {cell: (MINI_SHAPES.get((arch, cell), shape), kv_chunk)
            for cell, (shape, kv_chunk) in MINI_CELLS.items()}


def mini_config(cfg, kv_chunk):
    """The mini cell's config from `cfg` (an arch's `smoke()`, the port's
    or the reference's): `kv_chunk` if given, whisper's MINI_ENC_SEQ
    frames."""
    if kv_chunk:
        cfg = dataclasses.replace(cfg, attn_kv_chunk=kv_chunk)
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, enc_dec=dataclasses.replace(
            cfg.enc_dec, enc_seq=MINI_ENC_SEQ))
    return cfg


REF_MINI = textwrap.dedent("""
    import dataclasses, os, json, math, re
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    jax.devices()
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import optim
    from repro.configs import get_config
    from repro.launch import serve as serve_lib
    from repro.launch import train as train_lib
    from repro.launch.dryrun import _n_micro, _shape_rules
    from repro.launch.hlo_analysis import (_OP_RE, _shape_bytes,
                                           collective_bytes)
    from repro.launch.mesh import make_mesh
    from repro.launch.shapes import ShapeSpec, batch_shardings, input_specs
    from repro.models.common import param_sharding, param_shapes
    from repro.models.registry import build
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {{}}

    def nbytes(leaves, shardings):
        return sum(math.prod(s.shard_shape(l.shape)) * l.dtype.itemsize
                   for l, s in zip(leaves, shardings))

    def largest(hlo):
        big = {{}}
        for line in hlo.splitlines():
            m = None if "-done(" in line else _OP_RE.search(line)
            if m:
                op = m.group("op")
                big[op] = max(big.get(op, 0), _shape_bytes(m.group("shapes")))
        return big

    def compile_cell(cfg, shape):
        # The reference dry run's cell (launch/dryrun.py lower_cell) at
        # this shape.
        model = build(cfg)
        specs = model.param_specs()
        rules = _shape_rules(train_lib.make_rules(cfg, mesh), shape, mesh,
                             cfg)
        b = input_specs(cfg, shape)
        bs = batch_shardings(cfg, shape, mesh, rules)
        with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh):
            if shape.kind == "train":
                st = train_lib.abstract_state(model)
                sh = train_lib.state_shardings(specs, rules, mesh)
                step = train_lib.make_train_step(
                    model, cfg, rules, optim.AdamWConfig(),
                    n_micro=_n_micro(cfg, shape, mesh))
                co = jax.jit(step, in_shardings=(sh, bs),
                             out_shardings=(sh, None),
                             donate_argnums=(0,)).lower(st, b).compile()
                shard_bytes = (nbytes(jax.tree.leaves(st),
                                      jax.tree.leaves(sh))
                               + nbytes([b[k] for k in b], [bs[k] for k in b]))
            else:
                ps = jax.tree.map(lambda s: NamedSharding(mesh, s),
                                  param_sharding(specs, rules))
                params = param_shapes(specs, dtype=jnp.bfloat16)
                cache = serve_lib.abstract_cache(model, shape.global_batch,
                                                 shape.seq_len)
                cs = serve_lib.cache_shardings(cache, mesh, rules)
                if shape.kind == "prefill":
                    step = serve_lib.make_prefill_step(model, rules)
                    co = jax.jit(step, in_shardings=(ps, bs, cs),
                                 out_shardings=(None, cs),
                                 donate_argnums=(2,)).lower(
                                     params, b, cache).compile()
                else:
                    step = serve_lib.make_decode_step(model, rules)
                    co = jax.jit(step, in_shardings=(ps, cs, bs["tokens"]),
                                 out_shardings=(None, cs),
                                 donate_argnums=(1,)).lower(
                                     params, cache, b["tokens"]).compile()
                shard_bytes = None
        ma = co.memory_analysis()
        ca = co.cost_analysis() or {{}}
        ca = ca[0] if isinstance(ca, list) else ca
        hlo = co.as_text()
        return {{
            "shard_bytes": shard_bytes,
            "memory": {{
                "argument_bytes": int(ma.argument_size_in_bytes),
                "output_bytes": int(ma.output_size_in_bytes),
                "temp_bytes": int(ma.temp_size_in_bytes),
                "alias_bytes": int(ma.alias_size_in_bytes),
                "peak_per_device_gib": round(
                    (ma.argument_size_in_bytes + ma.output_size_in_bytes
                     + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
                    / 2**30, 3)}},
            "cost": {{"flops": float(ca.get("flops", 0.0)),
                      "bytes_accessed": float(ca.get("bytes accessed",
                                                     0.0))}},
            "collectives": collective_bytes(hlo),
            "largest": largest(hlo)}}

    for arch, cells in {cells!r}.items():
        out[arch] = {{}}
        for cell, (shape, kv_chunk) in cells.items():
            cfg = get_config(arch, smoke=True)
            if kv_chunk:
                cfg = dataclasses.replace(cfg, attn_kv_chunk=kv_chunk)
            if cfg.is_encdec:
                cfg = dataclasses.replace(cfg, enc_dec=dataclasses.replace(
                    cfg.enc_dec, enc_seq={enc_seq}))
            out[arch][cell] = compile_cell(cfg, ShapeSpec(*shape))
    print(json.dumps(out))
""")
# The port's per-device peak over XLA's on the mini train cells, measured
# on the CPU first: 1.071 gemma3, 0.770 rwkv6, 0.659 deepseek-v2-lite
# (smoke() size, PERF.md §6); the band holds it within 0.5-2x of XLA's.
PEAK_TO_REF = (0.5, 2.0)
# qwen2-moe's mini train peak, 0.476 of XLA's measured first (the routing
# one-hots of four groups of 2048 tokens hold most of both), held in a
# band of its own: its batched products keep batch and heads split
# (`models.common.contract`), so the copies DTensor's einsum gathered are
# gone (0.501 before, inside PEAK_TO_REF by 0.001).  Since the routing
# makes its dispatch and combine in bf16 from their factors, each where
# it is used (`models.moe.route_factors`), with no float32 copy beside
# them, the MoE mini train peaks are held in bands of their own,
# measured first: qwen2-moe 0.362 (was 0.476), deepseek-v2-lite 0.486
# (was 0.659, in PEAK_TO_REF).
PEAK_TO_REF_OF = {"qwen2-moe-a2.7b": (0.33, 0.40),
                  "deepseek-v2-lite-16b": (0.44, 0.54)}
# gemma3's traced all-gather bytes over XLA's on the four mini cells,
# measured first (PERF.md §6): train 1.453, prefill 0.500, decode
# 0.590, chunked decode 0.736.  XLA on the CPU gathers weights in
# float32 where the port gathers bf16 (the lower end: prefill is
# weights alone), and the port's all-gather holds what XLA moves as an
# all-to-all (the upper end).  Before the gather of a split cache was
# hoisted out of the chunk loop and the loss kept vocab-split, the
# chunked decode was 1.928 and train 1.716.
GATHER_TO_REF = (0.45, 1.6)
# gemma3's traced FLOPs over XLA's on the cells whose XLA program has no
# loop (gemma3's layers are unscanned; prefill and decode at the default
# kv_chunk), measured first: prefill 0.874, decode 0.617.  The port
# counts matrix products (FlopCounterMode's formulas), XLA elementwise
# work too, which weighs most in a decode step.
FLOPS_TO_REF = (0.55, 1.0)
# gemma3's decode 0.531 since its q, k and v products are cut on their
# weights' input dimension over the model axis, as XLA's are (was 0.617,
# when each rank computed them whole), in a band of its own.
FLOPS_TO_REF_OF = {("gemma3-1b", "decode"): (0.48, 0.58)}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_per_device_gib"}
# The checks each mini cell is held to against XLA: "largest" (no
# all-gather above XLA's largest), "gather" (GATHER_TO_REF), "flops"
# (FLOPS_TO_REF, on cells whose XLA program has no loop: gemma3's
# layers are unscanned, so its prefill and decode HLO holds each once).
# Each arch is held where it was measured inside the bands.  Since the
# batched products keep batch and heads split (`models.common.contract`)
# and a move between split dimensions is an all-to-all, measured first:
# qwen2-moe's all-gather 0.779 / 0.879 / 0.833 / 0.833 x XLA's (train /
# prefill / decode / chunked decode; was 22.6 / 3.50 / 1.79 / 3.92), its
# train's largest 262,144 B against 524,288 (was 41,943,040); whisper's
# 0.994 / 0.802 / 1.019 / 1.019 (was 2.39 / 1.127 / 1.92 / 1.92);
# rwkv6's 0.914 / 0.689 / 0.917 / 0.917 (was 3.12 / 2.24 / 1.15 /
# 1.15), its train's largest 65,536 B, XLA's (was 81,920);
# deepseek-v2-lite's prefill and decodes 1.199 / 0.703 / 1.000 (0.668
# / 0.593 / 0.886 since each rank makes its MLA mask from the
# positions: `test_deepseek_prefill_on_a_split_slot_cache`).  Since
# the experts' input is reduced once onto the weights' split and the
# routing weights' gradient stays split on the experts (models/moe.py),
# deepseek's train is held too: all-gather 0.997 x XLA's, largest
# 163,840 B, XLA's (was 1.713 and 327,680).
HELD = ("largest", "gather")
HELD_TO_REF = {
    "gemma3-1b": {"train": HELD, "prefill": HELD + ("flops",),
                  "decode": HELD + ("flops",), "decode_chunked": HELD},
    "rwkv6-7b": {cell: HELD for cell in MINI_CELLS},
    "deepseek-v2-lite-16b": {cell: HELD for cell in MINI_CELLS},
    "qwen2-moe-a2.7b": {cell: HELD for cell in MINI_CELLS},
    "whisper-small": {cell: HELD for cell in MINI_CELLS}}
# Cells whose "gather" check holds a band of their own, measured first:
# the gathers the port used to add on top of its weights' are gone (the
# update's float32 moments gathered to meet partial-sum gradients, and
# the sandwich norm's partial sum reduced twice, then gathered), and
# what is left is each weight gathered once in bf16, where XLA on the
# CPU gathers it in float32 and, in a train step, again in the
# backward: gemma3's train 0.422 (was 0.954), gemma3's prefill 0.393
# (was 0.500), rwkv6's train 0.398 (was 0.914), whisper's train 0.447
# (was 0.994; its sublayers' outputs, reduced once now before its
# norms) x XLA's.  gemma3's decode 0.387 (was 0.590): its q, k and v
# weights, split on their input dimension over the data axis, move that
# split to the model axis, which holds them whole, as XLA's
# collective-permutes do (`models.common.project`), where they were
# gathered; what is left is the weights XLA gathers too, in bf16.
# gemma3's train 0.365 since each rank attends and projects its rows of
# queries (was 0.422).
GATHER_TO_REF_OF = {("gemma3-1b", "train"): (0.35, 0.5),
                    ("gemma3-1b", "prefill"): (0.35, 0.5),
                    ("gemma3-1b", "decode"): (0.35, 0.5),
                    ("rwkv6-7b", "train"): (0.35, 0.5),
                    ("whisper-small", "train"): (0.35, 0.5)}


@pytest.fixture(scope="module")
def mini_records():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    port = {}
    for arch in MINI:
        port[arch] = {}
        for cell, (shape, kv_chunk) in mini_cells(arch).items():
            cfg = mini_config(get_config(arch, smoke=True), kv_chunk)
            memo = {}
            rec = dryrun.lower(cfg, ShapeSpec(*shape), mesh, memo=memo)
            # The trace's largest collective result of each kind, over
            # the traces the record was made from.
            largest = {}
            for trace in memo.values():
                for kind, n in trace["coll_largest"].items():
                    largest[kind] = max(largest.get(kind, 0), n)
            port[arch][cell] = (rec, largest)
    port["cuda"] = torch.cuda.is_initialized()
    ref = _child(REF_MINI.format(
        cells={arch: mini_cells(arch) for arch in MINI},
        enc_seq=MINI_ENC_SEQ))
    return port, ref


@pytest.mark.parametrize("arch", MINI)
def test_traced_mini_cell(arch, mini_records):
    port, ref = mini_records
    rec, xla = port[arch]["train"][0], ref[arch]["train"]
    assert port["cuda"] is False
    assert rec["status"] == "OK" and rec["n_micro"] >= 1
    assert rec["trace_mode"] == "full"
    # The model axis and FSDP split the step: the trace is partitioned,
    # and its figures are the device's, under the reference's keys.
    assert (rec["trace_scope"], rec["partitioned"]) == ("device", True)
    mem, cost = rec["memory"], rec["cost"]
    assert set(mem) == set(xla["memory"]) == MEMORY_KEYS
    assert set(cost) == set(xla["cost"]) == {"flops", "bytes_accessed"}
    assert mem["argument_bytes"] == xla["shard_bytes"] == \
        xla["memory"]["argument_bytes"]
    assert mem["alias_bytes"] < mem["argument_bytes"] < \
        mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["output_bytes"] > mem["alias_bytes"]
    assert mem["peak_per_device_gib"] > 0
    peak = (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
            - mem["alias_bytes"])
    x = xla["memory"]
    ref_peak = (x["argument_bytes"] + x["output_bytes"] + x["temp_bytes"]
                - x["alias_bytes"])
    print(f"{arch}: peak {peak} bytes, XLA's {ref_peak} "
          f"(ratio {peak / ref_peak:.3f}); flops {cost['flops']:.4e}, "
          f"XLA's {xla['cost']['flops']:.4e}")
    lo, hi = PEAK_TO_REF_OF.get(arch, PEAK_TO_REF)
    assert lo <= peak / ref_peak <= hi
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["collectives_traced"]["total"] > 0
    assert rec["remat_dup"] == 1.0        # smoke configs: remat "none"
    full = {**rec, "arch": arch, "shape": "train_4k", "mesh": "2x16x16",
            "kind": "train"}
    row = roofline.analyze_cell(full)      # every key the roofline reads
    assert row["peak_gib"] == mem["peak_per_device_gib"] > 0
    assert row["hlo_raw_flops"] == cost["flops"] > 0
    assert "| None |" not in roofline.to_markdown([row], [])


# The reference's serving caches carry an int32 `index` cursor (4 B) that
# the port keeps as a Python int, so XLA's arguments (and, donated, its
# aliases) are 4 B more.  Where a prefill overwrites the donated cache
# without reading it, XLA drops it: its arguments lack the cache.
INDEX_BYTES = 4


def unread_bytes(cfg, shape, mesh):
    """The (argument, aliased) bytes, as the port holds them, that XLA's
    compiled serving step of `cfg` at `shape` on `mesh` drops because the
    step never reads them.  A prefill drops a donated cache leaf it
    overwrites whole: a decoder-only GQA model's whole cache (the prompt
    fills every slot; gemma3's ring is zeroed first), hymba's attention
    cache (its Mamba state is read), whisper's cross-attention cache
    (written by `start_cache`).  whisper's decode
    step never reads the encoder's weights or the cross-attention's key
    and value projections (the cache holds their outputs), which jit
    drops from its arguments."""
    rules = dryrun._shape_rules(train.make_rules(cfg, mesh), shape, mesh,
                                cfg)
    model = build(cfg)
    cache = serve_lib.abstract_cache(model, shape.global_batch,
                                     shape.seq_len)
    c_shard = serve_lib.cache_shardings(cache, mesh, rules)
    if shape.kind == "prefill" and cfg.is_encdec:
        cross = sum(dryrun.local_bytes(cache[k], c_shard[k])
                    for k in ("cross_k", "cross_v"))
        return cross, cross
    if shape.kind == "prefill" and cfg.mixer == "gqa":
        whole = dryrun.local_bytes(cache, c_shard)
        return whole, whole
    if shape.kind == "prefill" and cfg.mixer == "hymba":
        # The attention's cache, which the prompt fills (its Mamba state
        # is read).
        attn = sum(dryrun.local_bytes(e["mixer"]["attn"],
                                      sh["mixer"]["attn"])
                   for e, sh in zip(cache["list"], c_shard["list"]))
        return attn, attn
    if shape.kind == "decode" and cfg.is_encdec:
        specs = model.param_specs()
        params = param_shapes(specs)
        p_shard = dryrun._param_shardings(specs, rules, mesh)
        unread = 0
        for path in (("enc_layers",), ("enc_final_norm",),
                     ("dec_layers", "cross_attn", "wk"),
                     ("dec_layers", "cross_attn", "wv")):
            t, sh = params, p_shard
            for k in path:
                t, sh = t[k], sh[k]
            unread += dryrun.local_bytes(t, sh)
        return unread, 0
    return 0, 0


@pytest.mark.parametrize("cell", sorted(MINI_CELLS))
@pytest.mark.parametrize("arch", MINI)
def test_mini_cell_against_xla(arch, cell, mini_records):
    """Every mini cell beside the reference's compiled one: argument and
    alias bytes as the two programs hold them; and the checks of
    HELD_TO_REF: no all-gather larger than XLA's largest, the traced
    all-gather bytes within GATHER_TO_REF of XLA's (GATHER_TO_REF_OF
    where a cell has its own), and on the cells with
    no loop in XLA's program the FLOPs within FLOPS_TO_REF (or
    FLOPS_TO_REF_OF).  Each cell
    prints the whole comparison."""
    port, ref = mini_records
    (rec, largest), xla = port[arch][cell], ref[arch][cell]
    kind = MINI_CELLS[cell][0][3]
    assert rec["status"] == "OK" and rec["partitioned"] is True
    mem, x = rec["memory"], xla["memory"]
    held = (x["argument_bytes"], x["alias_bytes"])
    if kind == "train":
        assert held == (mem["argument_bytes"], mem["alias_bytes"])
    else:
        shape, kv_chunk = mini_cells(arch)[cell]
        args_unread, alias_unread = unread_bytes(
            mini_config(get_config(arch, smoke=True), kv_chunk),
            ShapeSpec(*shape), make_mesh((2, 2, 2), ("pod", "data", "model")))
        assert held == (mem["argument_bytes"] - args_unread + INDEX_BYTES,
                        mem["alias_bytes"] - alias_unread + INDEX_BYTES)
    gather = rec["collectives_traced"].get("all-gather", 0.0)
    ref_gather = xla["collectives"].get("all-gather", 0.0)
    big, ref_big = (largest.get("all-gather", 0),
                    xla["largest"].get("all-gather", 0))
    flops, ref_flops = rec["cost"]["flops"], xla["cost"]["flops"]
    peak = mem["argument_bytes"] + mem["output_bytes"] + \
        mem["temp_bytes"] - mem["alias_bytes"]
    ref_peak = x["argument_bytes"] + x["output_bytes"] + x["temp_bytes"] \
        - x["alias_bytes"]
    print(f"{arch} {cell}: all-gather {gather:.0f} B, XLA's {ref_gather:.0f}"
          f" (ratio {gather / ref_gather:.3f}); all-to-all "
          f"{rec['collectives_traced'].get('all-to-all', 0.0):.0f} B, XLA's "
          f"{xla['collectives'].get('all-to-all', 0.0):.0f}; largest "
          f"all-gather {big} B, XLA's {ref_big}; flops {flops:.4e}, XLA's "
          f"{ref_flops:.4e} (ratio {flops / ref_flops:.3f}); peak {peak} "
          f"B, XLA's {ref_peak} (ratio {peak / ref_peak:.3f})")
    held = HELD_TO_REF.get(arch, {}).get(cell, ())
    if "largest" in held:
        assert 0 < big <= ref_big
    if "gather" in held:
        lo, hi = GATHER_TO_REF_OF.get((arch, cell), GATHER_TO_REF)
        assert lo <= gather / ref_gather <= hi
    if "flops" in held:
        lo, hi = FLOPS_TO_REF_OF.get((arch, cell), FLOPS_TO_REF)
        assert lo <= flops / ref_flops <= hi


def test_deepseek_prefill_on_a_split_slot_cache():
    """deepseek's smoke() prefill on the mini mesh, its latent cache
    split on slots (the prefill's rules), traced partitioned: no
    collective moves a bool tensor (each rank makes its rows' mask from
    the positions, `models.attention._latent_attention_split`), and no
    float32 tensor of the routing's (..., T, E, C) shape is live at the
    peak (`models.moe.route_factors` makes the dispatch and combine in
    the compute dtype); the step's values are held against the plain
    step's on two ranks (tests/test_torch_partitioned_values.py)."""
    arch = "deepseek-v2-lite-16b"
    shape, kv_chunk = mini_cells(arch)["prefill"]
    cfg = mini_config(get_config(arch, smoke=True), kv_chunk)
    spec = ShapeSpec(*shape)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    with dryrun.sites() as traces:
        rec = dryrun.lower(cfg, spec, mesh)
    assert rec["status"] == "OK" and rec["partitioned"]
    assert rec["trace_mode"] == "full"
    trace = traces[-1]                    # the whole depth's
    assert trace["layers"] == cfg.num_layers
    rules = dryrun._shape_rules(train.make_rules(cfg, mesh), spec, mesh, cfg)
    assert rules["cache_seq"] == "model"
    routed = (cfg.moe.num_experts,
              moe.capacity(min(moe.GROUP_SIZE, spec.global_batch
                               * spec.seq_len), cfg.moe))
    moved = {dtype for _, dtype, _, _ in trace["collectives"]}
    live = [(dtype, shape) for _, dtype, shape in trace["peak_live"]]
    print(f"{arch} mini prefill: collectives of {sorted(map(str, moved))}; "
          f"peak {trace['peak']} B at {trace['peak_site']}")
    assert torch.bool not in moved and torch.bfloat16 in moved
    assert not any(dtype == torch.float32 and shape[-2:] == routed
                   for dtype, shape in live)


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
    assert rec["partitioned"] is False     # the plain trace is the device's
    assert rec["memory"]["temp_bytes"] > 0 and rec["cost"]["flops"] > 0
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["cost"]) == {"flops", "bytes_accessed"}
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


def at_depth(cfg, layers):
    """`cfg` with `layers` layers (the encoder-decoder: in each stack)."""
    if cfg.is_encdec:
        return dataclasses.replace(cfg, num_layers=layers,
                                   enc_dec=dataclasses.replace(
                                       cfg.enc_dec, enc_layers=layers))
    return dataclasses.replace(cfg, num_layers=layers)


# Depths beyond smoke()'s, each arch's layers then cut into more periods
# than two: gemma3's pattern of three at 7 layers (two periods and a
# remainder of one) and at 10 (three and one, extrapolated from one
# period and two); deepseek's dense layer and four MoE layers; six
# periods of the other archs, extrapolated from two and three (a stacked
# leaf of one layer changes the ops of a one-layer trace).  hymba's
# smoke() global layers (0, 1) and the irregular (0, 3, 5) of 6 layers
# have no period shorter than half the depth and trace whole.
DEPTHS = [("gemma3-1b", 7), ("gemma3-1b", 10), ("deepseek-v2-lite-16b", 5),
          ("rwkv6-7b", 6), ("qwen2-moe-a2.7b", 6), ("mistral-large-123b", 6),
          ("whisper-small", 6), ("hymba-1.5b", 6)]


@pytest.mark.parametrize("step", sorted(STEP_KINDS))
@pytest.mark.parametrize("arch,layers",
                         [(a, None) for a in ARCH_IDS] + DEPTHS)
def test_shortcut_equals_the_whole_depth(arch, layers, step):
    """The shortcut gives the whole-depth trace's additive counts and
    peak.  A MoE serving step keeps its layers' auxiliary losses (a
    4-byte scalar each) live for up to two layers, one more from the
    third layer on than a trace of two periods shows: its extrapolated
    peak may be up to 4 B a period above the whole depth's."""
    kind, remat = STEP_KINDS[step]
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
    if layers is not None:
        cfg = at_depth(cfg, layers)
        if arch == "hymba-1.5b":
            cfg = dataclasses.replace(cfg, global_layers=(0, 3, 5))
    inputs = _inputs(cfg, kind)
    short = dryrun.traced_cost(cfg, kind, inputs, 64, shortcut=True)
    full = dryrun.traced_cost(cfg, kind, inputs, 64, shortcut=False)
    periods = dryrun.layer_period(cfg)[2]
    assert short["trace_mode"] == ("shortcut" if periods >= 2 else "full")
    assert full["trace_mode"] == "full"
    assert (arch == "hymba-1.5b") == (periods < 2)
    for key in dryrun._ADDITIVE:
        assert short[key] == full[key], key
    if cfg.moe is not None and kind != "train":
        assert 0 <= short["peak"] - full["peak"] <= 4 * periods
    else:
        assert short["peak"] == full["peak"]
    assert full["flops_micro"] > 0 and full["peak"] > 0


def test_shortcut_is_decided_by_the_operation_count(monkeypatch):
    """The shortcut is taken iff the one-period trace's operations,
    scaled to the whole depth, exceed SHORTCUT_OPS: the same cell takes
    the same trace however loaded the host is."""
    cfg = get_config("gemma3-1b", smoke=True)
    inputs = _inputs(cfg, "decode")
    one = dryrun.depth_config(cfg, 1)
    base = dryrun.trace_step(one, "decode", inputs, 64)
    estimate = base["ops"] * cfg.num_layers / one.num_layers
    for limit, mode in ((estimate, "full"), (estimate - 1, "shortcut")):
        monkeypatch.setattr(dryrun, "SHORTCUT_OPS", limit)
        assert dryrun.traced_cost(cfg, "decode", inputs, 64)["trace_mode"] \
            == mode


def test_records_say_which_trace_ran(tmp_path, monkeypatch):
    """A written record keeps "trace_mode", "trace_scope" and
    "partitioned"; a production mesh's trace is partitioned, its figures
    the device's under the reference's keys, and the report prints its
    peak."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, smoke=True))
    (rec,) = dryrun.run_cells(["gemma3-1b"], ["decode_32k"], [False],
                              str(tmp_path))
    (path,) = tmp_path.glob("*.json")
    written = json.loads(path.read_text())
    assert written == json.loads(json.dumps(rec))
    assert (written["trace_mode"], written["trace_scope"],
            written["partitioned"]) == ("full", "device", True)
    assert "trace" not in written
    assert set(written["memory"]) == MEMORY_KEYS
    assert set(written["cost"]) == {"flops", "bytes_accessed"}
    assert written["memory"]["peak_per_device_gib"] > 0
    assert written["cost"]["flops"] > 0
    assert written["collectives_traced"]["total"] > 0
    assert roofline.analyze_cell(written)["peak_gib"] == \
        written["memory"]["peak_per_device_gib"]


def test_layer_kinds_and_depth_configs():
    """The layer pattern's periods, and the configs cut to some of them
    in the model's order: gemma3's 26 layers are four periods of five
    local and one global layer and two local layers more; deepseek's
    dense layer is the head of 26 MoE layers; whisper's period is one
    encoder and one decoder layer; hymba's global layers (0, 15, 31)
    repeat no period shorter than the model."""
    cfg = get_config("gemma3-1b")
    assert dryrun.layer_period(cfg) == (0, 6, 4)
    small = dryrun.depth_config(cfg, 1)
    assert small.num_layers == 8
    assert dryrun.layer_sequence(small) == dryrun.layer_sequence(cfg)[:8]
    assert dryrun.layer_sequence(dryrun.depth_config(cfg, 2)) == \
        dryrun.layer_sequence(cfg)[:14]
    assert dryrun.depth_config(cfg, 4).global_layers == \
        tuple(i for i in range(26) if cfg.layer_is_global(i))
    ds = get_config("deepseek-v2-lite-16b")
    assert dryrun.layer_period(ds) == (1, 1, 26)
    small = dryrun.depth_config(ds, 2)
    assert small.moe_dense_layers == (0,) and small.num_layers == 3
    wh = get_config("whisper-small")
    assert dryrun.layer_period(wh) == (0, 2, 12)
    small = dryrun.depth_config(wh, 2)
    assert (small.enc_dec.enc_layers, small.num_layers) == (2, 2)
    assert dryrun.layer_period(get_config("hymba-1.5b"))[2] == 1


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


def test_a_move_between_split_dimensions_is_an_all_to_all():
    """Inside `gspmd_choices`, `Shard(0)` to `Shard(1)` over the model
    axis of the mini mesh is one all-to-all whose result is the local
    part (1/2 of the tensor's bytes), and no all-gather: each device
    holds its part, not the whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    shape = (8, 12, 6)
    with dryrun.one_rank(mesh) as dm, dryrun.gspmd_choices():
        split = DTensor.from_local(
            torch.empty(4, 12, 6, device="meta"), dm,
            [Replicate(), Replicate(), Shard(0)], run_check=False,
            shape=shape, stride=(72, 6, 1))
        tr = dryrun._Trace()
        with tr:
            moved = split.redistribute(dm, [Replicate(), Replicate(),
                                            Shard(1)])
    assert tuple(moved.to_local().shape) == (8, 6, 6)
    assert dict(tr.collectives) == {"all-to-all": 8 * 12 * 6 * 4 // 2,
                                    "all-to-all_count": 1}


def test_a_flatten_of_an_unevenly_cut_dimension_is_gathered_first():
    """rwkv6-7b long_500k's WKV output, (1, 1, 64 heads, 64) with its heads
    split over data and model (256 ways, uneven), flattened to (1, 1,
    4096): the view gathers the model axis first (a local view of 16 of
    the 64 values rank 0 holds would fail)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = make_mesh((16, 16), ("data", "model"))
    with dryrun.one_rank(mesh) as dm, dryrun.gspmd_choices():
        heads = DTensor.from_local(
            torch.empty(1, 1, 1, 64, device="meta"), dm,
            [Shard(2), Shard(2)], run_check=False, shape=(1, 1, 64, 64),
            stride=(4096, 4096, 64, 1))
        flat = heads.reshape(1, 1, 4096)
    assert tuple(flat.placements[0:1]) == (Shard(2),)
    assert not flat.placements[1].is_shard()
    assert tuple(flat.to_local().shape) == (1, 1, 256)


def _two_leaves_decode(kv_chunk):
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = dict(DEFAULT_RULES, embed="data", mlp="model", batch="data",
                 cache_seq="model", cache_heads=None)
    cache = {"stack": {"mixer": {
        "v": torch.empty((2, 4, 16, 2, 4), device="meta"),
        "k": torch.empty((2, 4, 16, 2, 4), device="meta")}}}
    shard = serve_lib.cache_shardings(cache, mesh, rules)
    return comm_analysis.collective_bytes(
        "decode", TWO_LEAVES, rules, mesh, tokens=3, cache=cache,
        cache_shardings=shard, kv_chunk=kv_chunk)


def test_collective_bytes_two_leaves_decode():
    """Decode, 3 sequences per device.  Both leaves gathered once (96 B).
    b's input dimension (mlp) is split over model: a residual combine of
    3 rows x its gathered width 8 x 2 B = 48 B.  A stacked k and v cache
    (L=2, B=4, S=16, KH=2, D=4) with its sequence split over model
    (2 ways) and batch over data, scanned in chunks of 4: as the
    reference's XLA program does, each leaf is cast to float32 and
    gathered whole over its sequence once a layer, at the device's batch:
    (2, 16, 2, 4) x 4 B = 1024 B, two layers, two leaves."""
    assert _two_leaves_decode(4) == {
        "all-gather": 96.0 + 4096.0, "all-reduce": 48.0, "total": 4240.0,
        "all-gather_count": 6.0, "all-reduce_count": 1.0}


def test_collective_bytes_two_leaves_decode_scored_whole():
    """The same cache scored whole (no chunk, or one no shorter than the
    cache): the partial softmax is combined, k and v sharing one
    all-reduce of one token's row (2, 1, 2, 4) in float32 = 64 B a
    layer, twice."""
    for kv_chunk in (None, 16, 5):
        assert _two_leaves_decode(kv_chunk) == {
            "all-gather": 96.0, "all-reduce": 48.0 + 128.0,
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
