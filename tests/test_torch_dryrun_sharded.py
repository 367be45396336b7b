"""The dry run's partitioned trace (repro_torch.launch.dryrun) on the CPU,
at `smoke()` size.  A cell whose mesh splits its step is traced as rank
0 of a DeviceMesh of the cell's shape, over a one-rank fake process
group that lives only inside the trace.

(a) Forced on a 1 x 1 mesh, and on a (4, 1) data-only mesh under rules
    that split no weight (`embed` None), the partitioned trace equals
    the plain trace exactly (FLOPs, bytes, temp, output, peak), for the
    serving steps and, on 1 x 1, for training.  Training on (4, 1) adds
    what one device's batch on whole weights cannot hold, the
    data-parallel gradient reduction: FLOPs equal, more bytes, and the
    traced collectives reductions and gathers.
(b) Under the mini dry run's data-plus-FSDP rules (tests/launch/
    test_launch.py's MINI_DRYRUN: heads, vocab, mlp and experts None) on
    (2, 2, 2), the per-device FLOPs times the data degree 4 against the
    1 x 1 trace's at the same global batch: equal exactly where the step
    splits only its batch (rwkv6's training); what the model axis
    splits as well is exact with its term: gemma3's training attends
    and projects each rank's rows of queries (sequence parallelism), its
    decode
    cache is split over the model axis (its attention split 8 ways),
    and the decode steps' products with weights larger than them (q,
    k, v, rwkv6's inputs, the unembedding) move the weights' split to
    the model axis, which holds both whole (`models.common.project`);
    deepseek keeps its
    experts and routing whole on every rank under these rules (as the
    reference's GSPMD program does), which the ratio bounds.
(c) A warm and a cold DTensor propagation cache give identical figures,
    and a partitioned train step traced twice gives the same peak (a
    storage made at the address of one that is gone is counted anew).
(d) `logical_constraint` returns a plain tensor as the same object and
    redistributes a DTensor; `write_rows_` on a split cache writes this
    rank's rows; `batched` and `slot_positions` make this rank's part.
(e) No process group after importing the launch modules, nor after a
    trace.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models.common import (DEFAULT_RULES, batched,
                                       logical_constraint, slot_positions,
                                       write_rows_)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
MINI = ["gemma3-1b", "rwkv6-7b", "deepseek-v2-lite-16b"]
# The mini dry run's rules: only the batch and FSDP split.
WHOLE = ("heads", "act_heads", "kv_heads", "cache_heads", "vocab",
         "act_vocab", "mlp", "act_mlp", "experts", "expert_mlp")


def _cell(kind):
    return ShapeSpec("mini", 64, 8, kind)


def _with_rules(cfg, **rules):
    return dataclasses.replace(
        cfg, rules_overrides={**cfg.rules_overrides, **rules})


def _figures(rec):
    mem, cost = rec["memory"], rec["cost"]
    return {"flops": cost["flops"], "bytes": cost["bytes_accessed"],
            "temp": mem["temp_bytes"], "output": mem["output_bytes"],
            "arguments": mem["argument_bytes"],
            "peak": mem["peak_per_device_gib"]}


# ------------------------------------------------------- (a)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh", ["1x1", "4x1"])
def test_forced_partitioned_trace_equals_the_plain_trace(mesh, kind):
    cfg = get_config("gemma3-1b", smoke=True)
    if mesh == "4x1":
        cfg = _with_rules(cfg, embed=None)
    m = make_mesh((1, 1) if mesh == "1x1" else (4, 1), ("data", "model"))
    plain = dryrun.lower(cfg, _cell(kind), m, partitioned=False)
    split = dryrun.lower(cfg, _cell(kind), m, partitioned=True)
    assert (plain["partitioned"], split["partitioned"]) == (False, True)
    assert dryrun.lower(cfg, _cell(kind), m)["partitioned"] is False
    got, want = _figures(split), _figures(plain)
    if mesh == "4x1" and kind == "train":
        # The gradients of weights every rank holds whole are reduced
        # over the data axis (reductions, and the gathers after them).
        assert got["flops"] == want["flops"]
        assert got["bytes"] > want["bytes"]
        traced = split["collectives_traced"]
        assert traced["total"] > 0
        assert set(traced) <= {"all-reduce", "all-gather",
                               "reduce-scatter", "total",
                               "all-reduce_count", "all-gather_count",
                               "reduce-scatter_count"}
        return
    assert got == want
    assert split["collectives_traced"]["total"] == 0


# ------------------------------------------------------- (b)


def _attention_flops(cfg, batch, slots):
    """Score and value FLOPs of one decode step over `slots` cached
    tokens: 2 products of 2 x heads x head_dim x slots a row a layer."""
    total = 0
    for i in range(cfg.num_layers):
        n = slots
        if cfg.attn_window is not None and not cfg.layer_is_global(i):
            n = min(cfg.attn_window, slots)
        total += 4 * batch * cfg.num_heads * cfg.head_dim * n
    return total


def _moved_flops(cfg, batch):
    """FLOPs of one decode step's products with a weight split on its
    input dimension over the data axis and larger than the product,
    whose split `project` moves to the model axis, which holds both
    whole: GQA's q, k and v, rwkv6's time-mix inputs (the token shift's
    five rates, r, k, v, g and the decay's first factor) and
    channel-mix ones (k, r), and the unembedding."""
    d = cfg.d_model
    if cfg.mixer == "rwkv6":
        layer = (5 * cfg.rwkv.ts_rank + 5 * d + cfg.rwkv.decay_rank
                 + cfg.d_ff)
    else:
        layer = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    return 2 * batch * d * (cfg.num_layers * layer + cfg.vocab_size)


# Per-device FLOPs x 4 over the 1 x 1 trace's where the step keeps some
# products whole on more than one rank (deepseek-v2-lite's experts and
# routing: measured 1.353 train, 1.068 decode): the bound it stays under.
KEPT_WHOLE = {("deepseek-v2-lite-16b", "train"): 1.5,
              ("deepseek-v2-lite-16b", "decode"): 1.5}


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", MINI)
def test_data_parallel_flops_are_a_quarter_of_the_whole(arch, kind):
    cfg = _with_rules(get_config(arch, smoke=True),
                      **{k: None for k in WHOLE})
    split = dryrun.lower(cfg, _cell(kind),
                         make_mesh((2, 2, 2), ("pod", "data", "model")))
    whole = dryrun.lower(cfg, _cell(kind),
                         make_mesh((1, 1), ("data", "model")))
    assert (split["partitioned"], whole["partitioned"]) == (True, False)
    per_device, total = split["cost"]["flops"], whole["cost"]["flops"]
    if (arch, kind) in KEPT_WHOLE:
        assert total <= 4 * per_device <= KEPT_WHOLE[arch, kind] * total
        return
    if kind == "decode":
        # The products with weights larger than them are cut on the
        # weights' input dimension over the model axis; and gemma3's
        # cache's sequence is split over the model axis too
        # (`_shape_rules`: its heads are not), so each rank scores and
        # sums half the slots of its sequences.
        moved = _moved_flops(cfg, 8)
        attention = (_attention_flops(cfg, 8, 64) if arch == "gemma3-1b"
                     else 0)
        assert 4 * per_device == total - attention // 2 - moved // 2
        return
    if (arch, kind) == ("gemma3-1b", "train"):
        # Each rank attends its half of the rows over every head and
        # projects its rows' output: the score and value products (4 B
        # H S^2 D a layer) and the output projection (2 B S H D d), and
        # their backward's two products each (smoke() recomputes
        # nothing).
        heads = 8 * 64 * cfg.num_heads * cfg.head_dim
        split = 3 * heads * (4 * 64 + 2 * cfg.d_model) * cfg.num_layers
        assert 4 * per_device == total - split // 2
        return
    assert 4 * per_device == total


# ------------------------------------------------------- (c)


def test_figures_do_not_depend_on_the_propagation_cache():
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache

    cfg = get_config("gemma3-1b", smoke=True)
    mesh = make_mesh((2, 2), ("data", "model"))
    warm = dryrun.lower(cfg, _cell("decode"), mesh)
    again = dryrun.lower(cfg, _cell("decode"), mesh)
    _clear_sharding_prop_cache()
    cold = dryrun.lower(cfg, _cell("decode"), mesh)
    assert warm["partitioned"] is True
    assert _figures(warm) == _figures(again) == _figures(cold)
    assert warm["collectives_traced"] == cold["collectives_traced"]


def test_a_partitioned_train_trace_repeats():
    """whisper's mini train cell, whose collectives' waits hand on new
    storages on the meta device: twice the same figures."""
    from test_torch_dryrun import mini_cells, mini_config
    shape, kv_chunk = mini_cells("whisper-small")["train"]
    cfg = mini_config(get_config("whisper-small", smoke=True), kv_chunk)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    first, second = (dryrun.lower(cfg, ShapeSpec(*shape), mesh)
                     for _ in range(2))
    assert first["partitioned"] is True
    assert _figures(first) == _figures(second)
    assert first["collectives_traced"] == second["collectives_traced"]


# ------------------------------------------------------- (d)


def test_logical_constraint_keeps_a_plain_tensor_and_splits_a_dtensor():
    x = torch.ones(4, 6)
    rules = dict(DEFAULT_RULES, batch="data")
    assert logical_constraint(x, rules, "batch", None) is x
    with pytest.raises(KeyError):
        logical_constraint(x, rules, "no-such-axis")
    mesh = make_mesh((2, 2), ("data", "model"))
    with dryrun.one_rank(mesh) as dm:
        whole = DTensor.from_local(torch.ones(4, 6), dm,
                                   [Replicate(), Replicate()],
                                   run_check=False)
        split = logical_constraint(whole, rules, "batch", None)
        assert tuple(split.placements) == (Shard(0), Replicate())
        assert tuple(split.to_local().shape) == (2, 6)
        assert logical_constraint(split, dict(rules, batch=None), "batch",
                                  None).placements == (Replicate(),
                                                       Replicate())


def test_write_rows_writes_this_ranks_rows_of_a_split_cache():
    """A (4, 8) cache split over rows (data) and slots (model): rank 0
    holds rows 0-1 and slots 0-3.  Rows whose slot falls in its part
    take their value; the others are left as they were."""
    mesh = make_mesh((2, 2), ("data", "model"))
    with dryrun.one_rank(mesh) as dm:
        cache = DTensor.from_local(torch.zeros(2, 4), dm,
                                   [Shard(0), Shard(1)], run_check=False)
        values = DTensor.from_local(torch.tensor([5.0, 7.0]), dm,
                                    [Shard(0), Replicate()],
                                    run_check=False)
        slots = torch.tensor([1, 6, 3, 0])      # whole: one per row
        write_rows_(cache, slots, values)
        assert cache.to_local().tolist() == [[0, 5, 0, 0], [0, 0, 0, 0]]
    plain = torch.zeros(4, 8)
    write_rows_(plain, slots, torch.tensor([5.0, 7.0, 1.0, 2.0]))
    assert plain[0, 1] == 5 and plain[1, 6] == 7 and plain[3, 0] == 2


def test_factories_make_this_ranks_part():
    """`batched` makes a state or mask split as its operand's batch,
    and `slot_positions` a cache's slot positions split as its rows and
    slots: rank 0 holds rows 0-1 and, of a slot-split cache, slots 0-3.
    On plain tensors both make the whole tensor, as the eager steps
    did."""
    mesh = make_mesh((2, 2), ("data", "model"))
    with dryrun.one_rank(mesh) as dm:
        rows = DTensor.from_local(torch.ones(2, 6), dm,
                                  [Shard(0), Replicate()], run_check=False)
        state = batched(torch.zeros, rows, (4, 3, 5), dtype=torch.float32)
        assert (tuple(state.shape), tuple(state.placements)) == \
            ((4, 3, 5), (Shard(0), Replicate()))
        assert torch.equal(state.to_local(), torch.zeros(2, 3, 5))
        cache = DTensor.from_local(torch.zeros(2, 4, 3), dm,
                                   [Shard(0), Shard(1)], run_check=False)
        pos = slot_positions(cache)
        assert (tuple(pos.shape), tuple(pos.placements)) == \
            ((4, 8), (Shard(0), Shard(1)))
        assert pos.to_local().tolist() == [[0, 1, 2, 3]] * 2
    assert torch.equal(batched(torch.full, torch.ones(4), (4, 1), 7,
                               dtype=torch.long), torch.full((4, 1), 7))
    assert torch.equal(slot_positions(torch.zeros(3, 8, 2)),
                       torch.arange(8)[None].expand(3, 8))


# ------------------------------------------------------- (e)


def test_no_process_group_outside_a_trace():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.train\n"
            "import repro_torch.launch.serve, repro_torch.launch.roofline\n"
            "import repro_torch.launch.mesh, repro_torch.launch.shapes\n"
            "print(dist.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"
    rec = dryrun.lower(get_config("gemma3-1b", smoke=True), _cell("decode"),
                       make_mesh((2, 2), ("data", "model")))
    assert rec["partitioned"] is True
    assert dist.is_initialized() is False
    assert json.loads(json.dumps(rec)) == rec
