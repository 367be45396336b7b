"""Multi-pod dry run: lower + trace every (arch x shape x mesh) cell.

The port's counterpart of the reference's dry run, which lowers each
cell's step for 512 placeholder devices and compiles it.  Here nothing
is allocated on any device and no card is initialised: the production
mesh is a plain description of its axes (`launch.mesh.Mesh`), and every
state, cache and batch leaf is a meta tensor.

"Lowering" builds the abstract state (train) or bf16 parameters and
cache (prefill, decode), the batch, and their shardings on the mesh;
with ``--no-compile`` a record stops there, status ``LOWERED``.
"Compiling" traces one device's step and records, with the reference's
keys:

  * memory — `argument_bytes` is exact: each argument leaf's per-device
    bytes under its placements (an uneven dimension rounded up, as XLA
    pads it); the donated arguments (the state in training, the cache
    in serving) are `alias_bytes`, as `donate_argnums` makes them.
    `temp_bytes` is the peak of live bytes the step makes on the device
    (counted when an op makes a tensor, uncounted when it is freed),
    less the step's new outputs, which are `output_bytes` with the
    aliased arguments.  Training traces one microbatch's forward,
    backward and update.
  * cost — `flops` by `torch.utils.flop_counter`'s formula table, the
    one `FlopCounterMode` applies (the tests hold the two equal),
    counted in the same dispatch pass as the bytes; `bytes_accessed`
    the sum of each dispatched op's input and output bytes (view ops,
    which move nothing, left out); forward and backward count
    `n_micro` times, the update once.  XLA's `cost_analysis` counts a
    scanned loop body once (a stacked model's layers, the
    microbatches); the trace counts every layer and every microbatch.
  * collectives and remat_dup — `launch/comm_analysis.py`, from the
    placements; "collectives_traced" holds the collectives the trace
    dispatched, in the same schema (result bytes per kind).

Which step is traced: where no weight is split and no mesh axis but the
data axes is wider than one (a 1 x 1 mesh, or pure data parallelism),
the device's batch on whole weights, on meta tensors — the plain trace.
Everywhere else (the production meshes: the model axis and FSDP split
the weights) the step is partitioned: every argument is a DTensor over
a DeviceMesh of the cell's shape and axis names, its local tensor rank
0's meta shard; the models' sharding hints redistribute; and what the
trace counts is rank 0's local ops and collectives (`one_rank`,
`trace_step`).  The process group is a one-rank fake group that lives
only inside the trace.  DTensor's propagation decides how each op is
split, with the choices `gspmd_choices` makes GSPMD-like, but for the
models' batched products, which `models.common.contract` splits as
GSPMD splits a dot (batch and heads both kept split); where DTensor
gathers what GSPMD would keep split, the figures are this program's
own.  Every record says "trace_scope": "device", and "partitioned"
which trace ran.  A partitioned op costs several times a plain one's
host time (DTensor's propagation, cached per op and shape).

Python time per op on meta tensors is high, so a scan over chunks
(`models.common.scan`, the SSM mixers' counterpart of the reference's
lax.scan(jax.checkpoint(step))) is counted by its trip count, as XLA
runs a compiled loop body by its trip count: the trace runs the first
and last SCAN_RUN trips and each other trip stands in with the tensors
a run trip leaves, its forward and backward adding a run trip's
increment to every additive count and reaching the live bytes a run
trip reaches (`_Trace.scan`; "scan_trips_counted" says how many were
counted, "scan_collectives" what collectives they added).  Every count
and the peak equal those of running every trip (the tests hold them on
a plain and a partitioned trace, in every step kind).  Attention still
goes by query and key chunks, so where the whole depth would dispatch
more than SHORTCUT_OPS operations (counted in the trace of one period
of the layer pattern, the scans' counted trips included) a cell takes
a shortcut.  The model's layers are a head (deepseek's dense layers),
periods of its pattern (gemma3's five local layers and a global one;
one layer where all are alike; one encoder and one decoder layer) and
a remainder (`layer_period`); the shortcut traces the model cut to a
few periods,
each cut in the model's order with its head and remainder
(`depth_config`): one period and two, or two and three where the first
period's ops differ from the next ones' and five periods cost less
than the whole.  FLOPs, bytes, matrix products and collectives are the
smaller trace's plus one period's increment for each further period,
which equals the whole-depth trace.  So is the peak: each trace keeps
the live bytes at each of its ops, the two traces' ops are matched
period by period (`_repeated_blocks`), and each op of the whole step
holds its bytes in the smaller trace plus one increment a period; the
peak is the largest of these.  The tests hold the shortcut equal to the
whole-depth trace for every arch and step kind, at smoke() size and at
deeper ones (a MoE serving step keeps a 4-byte scalar a layer longer
from its third layer on, so its peak may come out up to 4 B a period
high).  A pattern of fewer than two periods (hymba's global layers 0,
15 and 31) traces whole, each layer's scans counted.  A record's
"trace_mode" says "full" or "shortcut".

`run_on_rank` runs the same partitioned step for real on a card, as
rank 0 (chip_smoke.py's phase 11e holds the trace's memory to it).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out-dir build/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import logging
import math
import os
import time
import traceback
import weakref
from array import array
from collections import Counter
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import optim
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.launch.comm_analysis import (MATMUL_OPS, collective_bytes,
                                              remat_duplication)
from repro_torch.launch.mesh import (MeshSharding, axis_sizes, data_axes,
                                     dp_degree, make_production_mesh)
from repro_torch.launch.shapes import (SHAPES, ShapeSpec, batch_shardings,
                                       cell_is_runnable, input_specs)
from repro_torch.models.common import (counting_scans, param_sharding,
                                       param_shapes, remat, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.models.registry import build


def _shape_rules(rules: Dict[str, Any], shape: ShapeSpec, mesh, cfg
                 ) -> Dict[str, Any]:
    """Per-shape rule adjustments on top of per-arch rules."""
    rules = dict(rules)
    if shape.kind == "train" and rules.get("seq") is None:
        # Sequence-parallel residual stream for every training cell: the
        # remat-saved layer boundaries shard over the model axis (Megatron
        # SP); _layer_forward's enter_tp/exit_tp gathers activations, not
        # weights, at region boundaries.
        rules["seq"] = "model"
    if shape.name == "long_500k":
        # batch=1 is unshardable; shard the KV-cache sequence instead.
        rules["batch"] = None
    if shape.kind in ("decode", "prefill"):
        # Shard the KV cache over the model axis: heads when they divide it,
        # otherwise the sequence dimension.  GSPMD combines the partial
        # softmax of a cache scored whole and gathers one scanned in
        # chunks, once a layer (`comm_analysis`).  MLA's latent cache has
        # no heads dimension, so it always seq-shards.
        if (cfg.mixer == "mla" or rules.get("cache_heads") != "model") \
                and rules.get("cache_seq") is None:
            rules["cache_seq"] = "model"
    return rules


def _n_micro(cfg, shape: ShapeSpec, mesh) -> int:
    per_shard = shape.global_batch // dp_degree(mesh)
    mb = cfg.microbatch or max(1, 8192 // shape.seq_len)
    mb = min(mb, per_shard)
    return max(1, per_shard // mb)


# ---------------------------------------------------------------------------
# Bytes under placements
# ---------------------------------------------------------------------------


def local_bytes(tree, shardings) -> int:
    """Per-device bytes of every tensor leaf of `tree` under the
    matching `MeshSharding` of `shardings` (same structure)."""
    total = 0
    for t, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        if isinstance(t, torch.Tensor):
            total += math.prod(sh.shard_shape(t.shape)) * t.element_size()
    return total


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def whole_bytes(tree) -> int:
    """Bytes of every tensor leaf of `tree`, unsharded."""
    return sum(_nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (this rank's shard); a tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# One rank of the mesh
# ---------------------------------------------------------------------------


def _fake_backend(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup
    return FakeProcessGroup._create_internal(
        common_opts.group_rank, common_opts.group_size, backend_opts)


@contextlib.contextmanager
def one_rank(mesh, device_type: str = "cpu"):
    """Rank 0 of `mesh`'s devices, alone in this process: a fake process
    group of the mesh's device count (every collective returns a buffer
    of its result's shape and moves nothing), and a DeviceMesh of the
    mesh's shape and axis names over it, yielded.  The group is
    destroyed on exit, so it lives only inside a trace.

    The backend is registered here, from torch's own FakeProcessGroup
    through `dist.Backend.register_backend`, rather than by importing
    torch.testing._internal.distributed.fake_pg, which registers the
    same class as a side effect of its import: the port then leans on
    no testing module, and nothing is registered before a trace asks."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.Backend.register_backend("fake", _fake_backend, extended_api=True,
                                  devices=["cpu", "cuda"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=math.prod(mesh.shape))
    # DTensor warns of each multi-axis reduction it splits in two; the
    # trace counts them, so the warnings are kept to errors meanwhile.
    quiet = logging.getLogger("torch.distributed.tensor")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    try:
        yield init_device_mesh(device_type, tuple(mesh.shape),
                               mesh_dim_names=tuple(mesh.mesh_dim_names))
    finally:
        quiet.setLevel(level)
        dist.destroy_process_group()


@contextlib.contextmanager
def gspmd_choices():
    """Four of DTensor's choices made as GSPMD makes them, for a trace.

    An op's sharding: of the strategies DTensor can carry out (finite
    cost), the one that cuts least of what every input holds whole on a
    mesh axis, then changes fewest input placements, then leaves the
    smallest output on the device, then is cheapest by DTensor's cost
    model.  DTensor's own choice is the cheapest alone, and its model
    prices only the inputs' moves: it may cut a replicated operand
    (free) so the device computes a part the program never split (a
    later view that divides that dimension then fails), or leave a
    large output whole on every rank.

    A view that splits a dimension split over a mesh axis into pieces
    that axis does not divide: the input is gathered first, as for a
    reshape, where DTensor's strategy for `view` refuses (it may not
    move data; GSPMD reshards); and where the reshape would split a new
    dimension into pieces no device holds whole, the input is gathered
    further (`_whole_pieces`).

    A move from one split dimension to another is an all-to-all over the
    mesh axis's group, as GSPMD emits it: the local tensor cut into one
    chunk a device along the new split dimension, the chunks exchanged
    (`all_to_all_single`) and joined along the old one, so each device
    holds its part, not the whole (DTensor's own path for a CPU mesh
    gathers the whole and slices it).  It is the same on the meta device
    and on a card, so the host's trace and `run_on_rank` are one
    program.  For that reason too a strategy that would make a split
    input a partial sum is not taken (torch 2.11 may offer nothing
    else, and cannot carry it out: the inputs are then replicated on
    that mesh axis), and `flip` (a cumulative sum's backward), which
    torch 2.11 has no strategy for, has one here (`_flip_strategy`).

    A `scatter` (a sort's backward) has a strategy of its own, neither
    torch's (`_scatter_strategy`): it keeps the split of a dimension it
    does not write along, as torch 2.13's does (torch 2.11's replicates
    every operand), and it keeps a partial-sum input and source a
    partial sum, which neither does (torch 2.13's sort backward
    scatters a partial gradient into zeros made from it, a partial sum
    too, and its own strategy would all-reduce both).  Likewise an `add`
    of a partial sum or mean and a whole tensor, or of partial sums over
    different axes, may stay partial (`_partial_kept`), and a `silu` of
    a partial sum may reduce-scatter it (`_partial_scattered`), as torch
    2.13's strategies offer: torch 2.11's reduce the partial operand.

    `_select_min_cost_strategy`, the strategies of `view`,
    `_unsafe_view`, `flip` and `scatter`, `shard_dim_alltoall` and the
    derivation of strategies from decompositions (`_DERIVING`, which
    the trace leaves out) are swapped for the trace and restored after
    it."""
    from itertools import chain

    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import _decompositions
    from torch.distributed.tensor import _sharding_prop as prop
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops

    chosen = prop._select_min_cost_strategy
    moved = placement_types.shard_dim_alltoall
    propagator = DTensor._op_dispatcher.sharding_propagator
    views = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
    flip = torch.ops.aten.flip.default
    aten = torch.ops.aten
    scatters = (aten.scatter.src, aten.scatter_.src, aten.scatter.value,
                aten.scatter_.value)
    adds = (aten.add.Tensor,)
    acts = (aten.silu.default,)
    strict = {op: (propagator.op_strategy_funcs.get(op),
                   propagator.op_to_schema_info.get(op))
              for op in (*views, flip, *scatters, *adds, *acts)}

    def wanted(spec, have):
        return [w.placements for w in
                (spec.input_specs if spec.input_specs is not None
                 else [spec.output_spec] * len(have))]

    def unmade(spec, op_schema) -> set:
        """The mesh axes on which `spec` would make a split input a
        partial sum."""
        have = [a.placements for a in op_schema.args_spec]
        return {m for h, w in zip(have, wanted(spec, have))
                for m, (a, b) in enumerate(zip(h, w))
                if a.is_shard() and b.is_partial()}

    def made(spec, op_schema):
        """`spec`, or where it would make a split input a partial sum
        (torch 2.11 may offer no other strategy, and cannot carry it
        out), `spec` with every input and output replicated on those
        mesh axes: always a strategy, the inputs gathered or reduced."""
        axes = unmade(spec, op_schema) if op_schema is not None else set()
        if not axes:
            return spec
        return _replicated_on(spec, axes)

    def select(strategy, op_schema=None):
        specs = strategy.strategies
        if op_schema is None or len(specs) == 1:
            return made(chosen(strategy, op_schema), op_schema)
        costs = [float(sum(chain.from_iterable(s.redistribute_cost)))
                 for s in specs]
        if min(costs) < 0:           # DTensor's own local-chunking case
            return made(chosen(strategy, op_schema), op_schema)

        def key(i):
            spec = specs[i]
            have = [a.placements for a in op_schema.args_spec]
            want = wanted(spec, have)
            split_in = [any(not h[d].is_replicate() for h in have)
                        for d in range(len(have[0]))] if have else []
            # Cutting what every input holds whole on a mesh axis, each
            # input placement changed, then an output left whole where
            # it could be split: GSPMD's order of avoidance.
            invented = sum(not split_in[d] and not w[d].is_replicate()
                           for w in want for d in range(len(w)))
            changes = sum(a != b for h, w in zip(have, want)
                          for a, b in zip(h, w))
            out = spec.output_specs
            out = out[0] if isinstance(out, (tuple, list)) else out
            parts = math.prod(n for p, n in zip(
                out.placements, out.mesh.shape) if p.is_shard()) \
                if out is not None else 1
            # A split input made a partial sum: DTensor cannot carry it
            # out (torch 2.11 prices it finite); last, as the infinite.
            return (math.isinf(costs[i]) or bool(unmade(spec, op_schema)),
                    invented, changes, -parts, costs[i])
        return made(specs[min(range(len(specs)), key=key)], op_schema)

    def all_to_all(local, gather_dim, shard_dim, mesh, mesh_dim):
        # DTensor pads both dimensions to a multiple of the axis first.
        n = mesh.size(mesh_dim)
        parts = local.unflatten(shard_dim, (n, -1)).movedim(shard_dim, 0)
        moved = funcol.all_to_all_single(parts.contiguous(), None, None,
                                         (mesh, mesh_dim))
        if hasattr(moved, "wait"):
            moved = moved.wait()
        return torch.cat(moved.unbind(0), dim=gather_dim)

    # A strategy derived by running an op's decomposition (on a cache
    # miss; torch 2.11 for softplus and others) runs it on meta tensors
    # of the global shapes: host work, which a trace leaves out
    # (`_Trace`), or a cold cache would count what a warm one does not.
    # The method is an instance's on torch 2.13 and static on 2.11:
    # wrapped as it is found.
    decomp = getattr(_decompositions, "DecompShardingStrategy", None)
    derive = None if decomp is None else \
        decomp.__dict__.get("propagate_strategy")
    if derive is not None:
        kind = type(derive) if isinstance(
            derive, (staticmethod, classmethod)) else None
        func = derive.__func__ if kind else derive

        def derived(*args, **kwargs):
            global _DERIVING
            _DERIVING += 1
            try:
                return func(*args, **kwargs)
            finally:
                _DERIVING -= 1
        decomp.propagate_strategy = kind(derived) if kind else derived
    prop._select_min_cost_strategy = select
    placement_types.shard_dim_alltoall = all_to_all
    for op in views:
        _view_ops.register_op_strategy_map(op, torch.Tensor.view,
                                           schema_info=RuntimeSchemaInfo(1))
        propagator.op_strategy_funcs[op] = _whole_pieces(
            propagator.op_strategy_funcs[op])
    propagator.register_op_strategy(flip, _flip_strategy,
                                    RuntimeSchemaInfo(1))
    for op in scatters:
        propagator.register_op_strategy(op, _scatter_strategy,
                                        RuntimeSchemaInfo(1))
    # torch 2.11's pointwise strategies (2.13 derives these ops' from a
    # single mesh axis's, which offer what these add: left alone).
    for ops, offer in ((adds, _partial_kept), (acts, _partial_scattered)):
        for op in ops:
            if op in propagator.op_strategy_funcs:
                propagator.op_strategy_funcs[op] = offer(
                    propagator.op_strategy_funcs[op])
    try:
        yield
    finally:
        if derive is not None:
            decomp.propagate_strategy = derive
        prop._select_min_cost_strategy = chosen
        placement_types.shard_dim_alltoall = moved
        for op, (func, info) in strict.items():
            if func is None:
                propagator.op_strategy_funcs.pop(op, None)
            else:
                propagator.op_strategy_funcs[op] = func
            if info is None:
                propagator.op_to_schema_info.pop(op, None)
            else:
                propagator.op_to_schema_info[op] = info


# Set while DTensor derives a strategy from an op's decomposition.
_DERIVING = 0


def _with_placements(spec, placements):
    """The DTensor spec `spec` with `placements` (its shard order, where
    the torch has one, made anew)."""
    return dataclasses.replace(
        spec, placements=tuple(placements),
        **({"shard_order": None} if hasattr(spec, "shard_order") else {}))


def _replicated_on(spec, axes):
    """The op strategy `spec` with every input and output placement on
    the mesh axes `axes` replicated."""
    from torch.distributed.tensor._op_schema import OpSpec

    def replicated(s):
        if s is None:
            return None
        return _with_placements(s, [Replicate() if m in axes else p
                                    for m, p in enumerate(s.placements)])
    out = spec.output_specs
    out = (tuple(replicated(o) for o in out)
           if isinstance(out, (tuple, list)) else replicated(out))
    return OpSpec(output_specs=out,
                  input_specs=(None if spec.input_specs is None else
                               tuple(replicated(s)
                                     for s in spec.input_specs)),
                  redistribute_cost=spec.redistribute_cost)


def _flip_strategy(op_schema):
    """`flip`'s strategy: each input placement kept, but a dimension the
    flip reverses is gathered first (a device's part of it would be
    another device's)."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import \
        generate_redistribute_costs

    src, dims = op_schema.args_schema[:2]
    flipped = {d % len(src.shape) for d in dims}
    out = []
    for have in src.strategies:
        spec = have.output_spec
        places = tuple(Replicate() if p.is_shard() and p.dim in flipped
                       else p for p in spec.placements)
        want = DTensorSpec(spec.mesh, places, tensor_meta=spec.tensor_meta)
        out.append(OpSpec(output_specs=DTensorSpec(spec.mesh, places),
                          input_specs=(want,),
                          redistribute_cost=[
                              generate_redistribute_costs(src, want)]))
    return OpStrategy(out)


def _scatter_strategy(op_schema):
    """`scatter`'s strategy (the backward of the routing's sort): a
    dimension other than the one it writes along may stay split where
    the input, the index and a tensor source all have its size, each
    device scattering into its own part; or every operand replicated,
    as torch 2.13's strategy offers (torch 2.11's offers only the
    second, and would gather each routing group's (T, E) index and
    source).  And, on each mesh axis where the input and a tensor source
    are the same partial sum, that sum kept: the index replicated there,
    each rank scattering its share, no collective.  `scatter(self, dim,
    index, src)` is linear in (self, src) taken together when every rank
    holds the same index, so the ranks' outputs sum to the scatter of
    the sums.  Neither torch offers it: torch 2.13's sort backward
    scatters the partial gradient of the sorted values into zeros made
    from it (`new_zeros`, a partial sum too), and would all-reduce both.
    A `scatter.value` (the sum would hold the value once a rank) and a
    partial input with a whole source are not offered it."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy, generate_redistribute_costs)

    src, dim, index = op_schema.args_schema[:3]
    shape = src.shape
    dim %= len(shape)
    source = [a for a in op_schema.args_schema[3:4]
              if isinstance(a, OpStrategy)]
    shapes = [index.shape] + [a.shape for a in source]
    n = 2 + len(shapes)                # output, input, index[, source]
    options = [[Replicate()] * n] + [
        [Shard(d)] * n for d in range(len(shape))
        if d != dim and all(len(s) == len(shape) and s[d] == shape[d]
                            for s in shapes)]
    specs = expand_to_full_mesh_op_strategy(src.mesh, op_schema,
                                            options).strategies
    have = [a.strategies[0].output_spec.placements for a in (src, *source)]
    axes = {m for m, (p, *q) in enumerate(zip(*have))
            if q == [p] and p.is_partial() and p.reduce_op == "sum"}

    def kept(s):
        return _with_placements(s, [have[0][m] if m in axes else p
                                    for m, p in enumerate(s.placements)])
    offered = []
    for spec in specs if axes else ():
        ins = spec.input_specs
        if not all(s.placements[m].is_replicate() for s in ins
                   for m in axes):
            continue
        ins = [s if i == 1 else kept(s) for i, s in enumerate(ins)]
        offered.append(OpSpec(
            output_specs=kept(spec.output_spec), input_specs=ins,
            redistribute_cost=[generate_redistribute_costs(a, s)
                               for a, s in zip((src, index, *source), ins)]))
    specs = offered + specs
    if op_schema.is_inplace_op():       # the input's placements kept
        specs = [s for s in specs if s.output_spec.placements ==
                 s.input_specs[0].placements == have[0]]
    return OpStrategy(specs)


def _partial_kept(add: Callable) -> Callable:
    """`add`, a pointwise strategy that follows one operand, made to
    offer too, on each mesh axis where one operand of two is a partial
    sum or mean and the other is whole, the partial one kept: the whole
    operand made a partial sum (each rank keeps its share) or mean (each
    rank keeps it whole), no collective, and the output one, as torch
    2.13's strategy offers, where torch 2.11's follows the whole operand
    and all-reduces the partial one (a gradient accumulated from a whole
    and a partial part; the MoE layers' aux losses, each a mean over
    split routing groups, added up), or follows one operand and reduces
    the other's partial sum on the axes the first holds whole (a global
    norm's squares, partial sums over different axes, added up)."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import \
        generate_redistribute_costs

    def strategy(op_schema):
        out = add(op_schema)
        args = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
        if len(args) != 2 or len({a.shape for a in args}) != 1:
            return out
        have = [a.strategies[0].output_spec.placements for a in args]
        parts = {m: p if p.is_partial() else q
                 for m, (p, q) in enumerate(zip(*have))
                 if p.is_partial() != q.is_partial()
                 and (p if p.is_partial() else q).reduce_op in ("sum", "avg")
                 and (q if p.is_partial() else p).is_replicate()}
        if not parts:
            return out

        def partial(s):
            return _with_placements(s, [parts.get(m, p)
                                        for m, p in enumerate(s.placements)])
        kept = []
        for spec in out.strategies:
            ins = spec.input_specs
            if ins is None or not all(
                    s.placements[m] in (Replicate(), parts[m])
                    for s in ins for m in parts):
                continue
            ins = [partial(s) for s in ins]
            kept.append(OpSpec(
                output_specs=partial(spec.output_spec), input_specs=ins,
                redistribute_cost=[generate_redistribute_costs(a, s)
                                   for a, s in zip(args, ins)]))
        return OpStrategy(kept + list(out.strategies))
    return strategy


def _partial_scattered(unary: Callable) -> Callable:
    """`unary`, the pointwise strategy of an op that is not linear, made
    to offer too, where its input is a partial sum on some mesh axes, the
    sum reduce-scattered there onto a dimension no other axis splits,
    the output split so, as torch 2.13's strategy offers, where torch
    2.11's all-reduces it (the MoE experts' gate product, a partial sum
    over the data axis in a decode step).  The dimensions are offered
    least padded first (a dimension the axes do not divide is padded to
    a multiple of them), as a tie is taken in order."""
    import itertools

    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import \
        generate_redistribute_costs

    def strategy(op_schema):
        out = unary(op_schema)
        arg = op_schema.args_schema[0]
        if not isinstance(arg, OpStrategy):
            return out
        have = arg.strategies[0].output_spec
        sizes = have.mesh.shape
        axes = [m for m, p in enumerate(have.placements)
                if p.is_partial() and p.reduce_op == "sum"]
        if not axes:
            return out
        free = [d for d in range(len(arg.shape))
                if not any(p.is_shard() and p.dim == d
                           for p in have.placements)]
        offered = []
        for dims in itertools.product(free, repeat=len(axes)):
            place = list(have.placements)
            for m, d in zip(axes, dims):
                place[m] = Shard(d)
            parts = {d: math.prod(sizes[m] for m, e in zip(axes, dims)
                                  if e == d) for d in dims}
            padded = math.prod(-(-arg.shape[d] // n) * n / arg.shape[d]
                               for d, n in parts.items())
            spec = _with_placements(have, place)
            offered.append((padded, OpSpec(
                output_specs=spec, input_specs=[spec],
                redistribute_cost=[generate_redistribute_costs(arg, spec)])))
        offered.sort(key=lambda o: o[0])
        return OpStrategy([s for _, s in offered] + list(out.strategies))
    return strategy


def _whole_pieces(reshape: Callable) -> Callable:
    """`reshape`, DTensor's strategy for a reshape, made to split a new
    dimension only into pieces every device holds whole.

    DTensor checks a dimension made from a split one against each mesh
    axis that splits it, one at a time, not against their product: (1,
    131072, D) split over data and model (256 ways) viewed as (32, 4096,
    D) would give a batch of 32 split 256 ways, which no device's local
    view can hold.  Nor does it check a flattened dimension whose split
    part those axes cut unevenly: rwkv6's (1, 1, 64 heads, 64) split 256
    ways on its heads, flattened to (1, 1, 4096).  Where a new dimension
    is split over more than one axis and their product does not divide
    it, or its split part, the input is gathered over the last of those
    axes and the view propagated again, as GSPMD reshards a reshape."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops._view_ops import (Flatten, InputDim,
                                                         dim_maps)
    from torch.distributed.tensor._ops.utils import \
        generate_redistribute_costs

    def overcut(spec, rules, shape, src_shape) -> Optional[int]:
        """The last mesh axis of an output dimension a split or a flatten
        made (not one the view keeps as it is) that its axes cut
        unevenly."""
        mesh_shape = spec.mesh.shape
        for d, cmd in enumerate(rules):
            axes = [m for m, p in enumerate(spec.placements)
                    if p.is_shard() and p.dim == d]
            if len(axes) < 2 or isinstance(cmd, InputDim):
                continue
            size = shape[d]
            if isinstance(cmd, Flatten) and isinstance(cmd.input_dims[0],
                                                       InputDim):
                size = src_shape[cmd.input_dims[0].input_dim]
            if size % math.prod(mesh_shape[m] for m in axes):
                return axes[-1]
        return None

    def strategy(op_schema):
        out = reshape(op_schema)
        src, size = op_schema.args_schema[:2]
        rules = dim_maps[torch.Tensor.view](src, size)
        known = math.prod(n for n in size if n != -1)
        shape = [math.prod(src.shape) // known if n == -1 else n
                 for n in size]
        fitted = []
        for spec, have in zip(out.strategies, src.strategies):
            while (axis := overcut(spec.output_spec, rules, shape,
                                   src.shape)) is not None:
                want = list(spec.input_specs[0].placements)
                want[axis] = Replicate()
                gathered = _with_placements(have.output_spec, want)
                (spec,) = reshape(dataclasses.replace(
                    op_schema, args_schema=(OpStrategy([OpSpec(gathered)]),
                                            *op_schema.args_schema[1:])
                )).strategies
                spec.redistribute_cost = [
                    generate_redistribute_costs(src, spec.input_specs[0])]
            fitted.append(spec)
        return OpStrategy(fitted)
    return strategy


def on_rank(tree, shardings, device_mesh, device="meta"):
    """Every tensor leaf of `tree` (global shapes) as a DTensor on
    `device_mesh` under the matching `MeshSharding` of `shardings`: its
    local tensor is rank 0's shard (an uneven dimension rounded up, as
    `local_bytes` counts it), on the meta device or, for a run on a
    card, zeros there (so an index read from it stays in range).  Other
    leaves are kept."""
    def leaf(t, sh):
        if not isinstance(t, torch.Tensor):
            return t
        shape = sh.shard_shape(t.shape)
        local = (torch.empty(shape, dtype=t.dtype, device="meta")
                 if device == "meta" else
                 torch.zeros(shape, dtype=t.dtype, device=device))
        return DTensor.from_local(local, device_mesh, sh.placements(),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return tree_unflatten(tree, [leaf(t, sh) for t, sh in
                                 zip(tree_leaves(tree),
                                     tree_leaves(shardings))])


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


# Ops that hand a collective's result on as it is: no new memory.  On
# the meta device their output is another storage than their input, so
# it is followed as a view of it.
PASS_THROUGH = frozenset({"_c10d_functional::wait_tensor",
                          "_c10d_functional::_wrap_tensor_autograd"})


# The collectives DTensor dispatches, by the reference's names.
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_to_all_single": "all-to-all"}


# Set by `sites()`: one entry per trace run meanwhile.
_SITES: Optional[list] = None


@contextlib.contextmanager
def sites():
    """While active, every trace keeps where in the port's code each
    collective it dispatched came from (kind, dtype, result shape and
    the two innermost frames of the port) and where its peak was
    reached, with the storages then live ("peak_live": bytes, dtype and
    shape as made, most bytes first).  Yields the list of one entry per
    trace (`--sites`)."""
    global _SITES
    kept, _SITES = _SITES, []
    try:
        yield _SITES
    finally:
        _SITES = kept


def _site() -> str:
    """The two innermost frames of the port's code, and in a backward
    pass the autograd node that runs (its frames are the engine's
    caller's)."""
    here = [f for f in traceback.extract_stack()
            if "repro_torch" in f.filename
            and not f.filename.endswith("dryrun.py")]
    where = " <- ".join(f"{f.filename.rsplit('repro_torch/', 1)[1]}:"
                        f"{f.lineno}" for f in reversed(here[-2:]))
    node = torch._C._current_autograd_node()
    return where if node is None else f"{node.name()} in {where}"


class _Trace(TorchDispatchMode):
    """Counts, over the ops dispatched on this device while it is active:
    the ops, FLOPs (by FlopCounterMode's formulas), bytes read and
    written, matrix products, the result bytes of each kind of
    collective, and the live bytes of the storages the ops make, with
    their peak.  A storage is counted when an op makes it and uncounted
    when the last tensor the ops returned on it (views included) is
    freed.  Storages made before it, the arguments', are never counted.

    On DTensors it sees each op three ways: the DTensor op itself, which
    it hands back to DTensor (NotImplemented); the op on fake tensors of
    the global shapes, which DTensor's sharding propagation runs to
    learn the result's shape (not counted: its output is a FakeTensor,
    and a cached propagation runs none, so the counts do not depend on
    the cache); and the ops on this rank's local tensors, the
    collectives among them, which are the device's and are counted.
    An op on no tensor of `device_type` (the meta device, or the
    card's) is host work, such as the propagator's shard arithmetic on
    small CPU tensors, and is not counted either; so is an op that
    DTensor runs, on a cache miss, to derive a strategy from an op's
    decomposition (`gspmd_choices`), or a cold cache would count what a
    warm one does not."""

    def __init__(self, device_type: str = "meta"):
        super().__init__()
        self.device_type = device_type
        self.live = self.peak = 0
        # The most live bytes since a scan trip's window began (`_begin`).
        self.high = 0
        # While set, ops make and free storages but add no count: the
        # tensors a counted scan trip stands in with (`scan`).
        self.muted = False
        self.counted_trips = 0
        # The collectives the counted trips added: none where no trip
        # issues one.
        self.trip_collectives: Counter = Counter()
        self.ops = self.flops = self.bytes = self.matmuls = 0
        self.collectives: Counter = Counter()
        self.largest: Counter = Counter()     # kind -> largest result
        self.sites: Optional[Counter] = None if _SITES is None else Counter()
        self.peak_site = ""
        # With `sites`: each storage's dtype and shape as made, and the
        # (bytes, dtype, shape) of every storage live at the peak, most
        # bytes first.
        self.made: Dict[int, tuple] = {}
        self.peak_live: list = []
        # With `timeline` set: each op's name and the most live bytes
        # while it ran (`traced_cost`'s shortcut reads them).
        self.names: Optional[list] = None
        self.lives: Optional[list] = None
        self.window = 0
        # storage address -> [tensors, bytes, address] of the storage
        # made there last
        self.holders: Dict[int, list] = {}

    def _release(self, held: list) -> None:
        held[0] -= 1
        if not held[0]:
            self.live -= held[1]
            self._forget(held)

    def _forget(self, held: list) -> None:
        if self.holders.get(held[2]) is held:
            del self.holders[held[2]]

    def _hold(self, t: torch.Tensor, new: bool) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        held = self.holders.get(key)
        if new:
            # A collective's result whose wait hands on another storage
            # (the meta device's) keeps its record through the tensor
            # the wait returned, but not its address: once the storage
            # is freed the record leaves `holders`, so a storage that no
            # counted op makes there later (the next such wait's) counts
            # no view onto it.
            held = self.holders[key] = [0, storage.nbytes(), key]
            weakref.finalize(storage, self._forget, held)
            self.live += held[1]
            if self.sites is not None:
                self.made[key] = (t.dtype, tuple(t.shape))
            if self.live > self.peak and self.sites is not None:
                self.peak_live = sorted(
                    ((h[1], *self.made[h[2]]) for h in self.holders.values()),
                    key=lambda r: -r[0])
                big = ", ".join(f"{str(d)[6:]}{list(shape)} {n} B"
                                for n, d, shape in self.peak_live[:3])
                self.peak_site = f"{_site()} (largest live {big})"
            self.peak = max(self.peak, self.live)
            self.window = max(self.window, self.live)
            self.high = max(self.high, self.live)
        elif held is None:
            return                               # an argument's storage
        held[0] += 1
        weakref.finalize(t, self._release, held)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if _DERIVING or any(isinstance(o, FakeTensor) for o in outs):
            return out                           # sharding propagation
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if all(t.device.type != self.device_type for t in ins + outs):
            return out                           # host work
        name = func.name()
        if name in PASS_THROUGH:
            for o, i in zip(outs, ins):
                held = self.holders.get(i.untyped_storage()._cdata)
                if held is not None and o is not i:
                    held[0] += 1
                    weakref.finalize(o, self._release, held)
            return out
        self.window = self.live
        rets = func._schema.returns
        if not self.muted:
            self._count(func, name, rets, args, kwargs, out, ins, outs)
        inputs = {t.untyped_storage()._cdata for t in ins}
        for i, o in enumerate(outs):
            aliased = i < len(rets) and rets[i].alias_info is not None
            self._hold(o, not aliased
                       and o.untyped_storage()._cdata not in inputs)
        if self.names is not None:
            self.names.append(name)
            self.lives.append(self.window)
        return out

    def _count(self, func, name, rets, args, kwargs, out, ins, outs):
        self.ops += 1
        if name in MATMUL_OPS:
            self.matmuls += 1
        kind = COLLECTIVES.get(name.partition("::")[2])
        if kind is not None:
            nbytes = sum(_nbytes(o) for o in outs)
            self.collectives[kind] += nbytes
            self.collectives[kind + "_count"] += 1
            self.largest[kind] = max(self.largest[kind], nbytes)
            if self.sites is not None:
                self.sites[kind, outs[0].dtype, tuple(outs[0].shape),
                           _site()] += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        views = bool(rets) and all(r.alias_info is not None
                                   and not r.alias_info.is_write
                                   for r in rets)
        if not views:
            self.bytes += sum(_nbytes(t) for t in ins + outs)

    # -- scans: the reference's lax.scan(jax.checkpoint(step)) ------------

    @contextlib.contextmanager
    def _muted(self):
        kept, self.muted = self.muted, True
        try:
            yield
        finally:
            self.muted = kept

    def _begin(self) -> tuple:
        """A trip's window begins: the counts so far, and the most live
        bytes of the enclosing window, which this one's `high` restarts."""
        mark = (self.ops, self.flops, self.bytes, self.matmuls,
                Counter(self.collectives), Counter(self.sites or ()),
                self.live, self.high)
        self.high = self.live
        return mark

    def _end(self, mark: tuple) -> tuple:
        """The window begun at `mark` ends: its increment, the counts it
        added, the change of the live bytes and the most live bytes above
        its start."""
        ops, flops, nbytes, matmuls, coll, sites, live, high = mark
        inc = (self.ops - ops, self.flops - flops, self.bytes - nbytes,
               self.matmuls - matmuls, Counter(self.collectives) - coll,
               Counter(self.sites or ()) - sites, self.live - live,
               self.high - live)
        self.high = max(high, self.high)
        return inc

    def _stand_in(self, inc: tuple, layouts) -> list:
        """A trip counted, not run: tensors of `layouts` made, the most
        live bytes of its window reached (a scratch buffer for what the
        run trip held meanwhile), and its increment `inc` added."""
        ops, flops, nbytes, matmuls, coll, sites, _, high = inc
        start = self.live
        with self._muted():
            made = [_made(t) for t in layouts]
            extra = start + high - self.live
            if extra > 0:
                device = next(t[4] for t in layouts if t is not None)
                torch.empty(extra, dtype=torch.uint8, device=device)
        self.ops += ops
        self.flops += flops
        self.bytes += nbytes
        self.matmuls += matmuls
        self.collectives.update(coll)
        self.trip_collectives.update(coll)
        if self.sites is not None:
            self.sites.update(sites)
        return made

    def scan(self, step: Callable, carry, xs):
        """`models.common.scan` while the trace runs (`counting_scans`):
        the trips over dimension 1 of `xs`, of which a scan of more than
        2 * SCAN_RUN trips runs the first and last SCAN_RUN and counts
        the others (`_Scan`).  Its trips are alike once the first is
        run: each dispatches the same ops, on tensors of the same shapes,
        and leaves the same tensors; the first differs (its carry is
        the caller's), and in a backward pass the last and the first
        (no gradient comes to the last carry, none goes to the first).
        So trips 1 and 2 give a trip's forward increment, the backward
        of trips n - 2 and n - 3 (between identity marks on their
        outputs and inputs, `_Mark`) a trip's backward increment, and
        each trip between is a stand-in (`_StandIn`): under the same
        checkpoint as a run trip, it makes the tensors a run trip leaves
        and reaches the same most live bytes, and adds that trip's
        counts; in a backward pass likewise, the gradients of its
        inputs.  Every additive count and the peak are then those of
        running every trip, which the tests hold.  Where the two trips
        measured in the forward pass differ, every trip is run."""
        n = xs[0].shape[1]
        counted = n > 2 * SCAN_RUN
        trips = _Scan(self)
        ys = []
        grad = torch.is_grad_enabled()
        for i in range(n):
            if counted and SCAN_RUN <= i < n - SCAN_RUN and trips.alike():
                # The slices (views) and the checkpoint's own ops (a
                # recomputation's detaches) are in the run trip's
                # increment; without autograd no slice is needed.
                with self._muted():
                    x_i = [x[:, i] for x in xs] if grad else []
                    out = trips.stand_in(carry, *x_i)
            elif counted and 1 <= i < SCAN_RUN:
                mark = self._begin()
                out = step(carry, *[x[:, i] for x in xs])
                trips.forward.append((self._end(mark),
                                      [_layout(t) for t in out]))
            elif counted and grad and n - SCAN_RUN <= i < n - 1:
                out = trips.marked(step, carry, [x[:, i] for x in xs])
            else:
                out = step(carry, *[x[:, i] for x in xs])
            carry, y = out
            ys.append(y)
        return carry, torch.stack(ys, dim=1)


# A counted scan runs this many trips at each end (`_Trace.scan`); a
# scan of no more than twice as many runs every trip.
SCAN_RUN = 3


def _layout(t) -> Optional[tuple]:
    """What `_made` needs to make a tensor laid out as `t` (a DTensor: its
    local tensor, mesh and placements), read without dispatching an op;
    None for None."""
    if t is None:
        return None
    local = t._local_tensor if isinstance(t, DTensor) else t
    return (t.requires_grad, tuple(local.shape), local.stride(), local.dtype,
            local.device, t._spec if isinstance(t, DTensor) else None)


def _made(layout: Optional[tuple]):
    """An uninitialised tensor of `layout` (`_layout`'s), or None."""
    if layout is None:
        return None
    _, shape, stride, dtype, device, spec = layout
    local = torch.empty_strided(shape, stride, dtype=dtype, device=device)
    return local if spec is None else DTensor(local, spec,
                                              requires_grad=False)


class _Scan:
    """One counted scan's measurements (`_Trace.scan`): each run trip's
    forward increment with its outputs' layouts, and each marked trip's
    backward increment with its inputs' gradients' layouts."""

    def __init__(self, trace: _Trace):
        self.trace = trace
        self.forward: list = []
        self.backward: list = []
        # A stand-in trip, under the checkpoint a run trip takes.
        self.stand_in = remat(functools.partial(_StandIn.apply, self),
                              "full")

    def alike(self) -> bool:
        return len(self.forward) == 2 and \
            self.forward[0] == self.forward[1]

    def forward_trip(self) -> tuple:
        self.trace.counted_trips += 1
        inc, layouts = self.forward[0]
        return tuple(self.trace._stand_in(inc, layouts))

    def backward_trip(self) -> list:
        if len(self.backward) != 2 or self.backward[0] != self.backward[1]:
            raise RuntimeError(
                "a counted scan's marked trips differ in their backward "
                "pass: its other trips cannot be counted")
        inc, layouts = self.backward[0]
        return self.trace._stand_in(inc, layouts)

    def marked(self, step: Callable, carry, x_i: list):
        """A trip run with identity marks on its inputs and outputs, whose
        backward pass is measured between them."""
        ins = [carry, *x_i]
        # The marks' callbacks hold no tensor, which would outlive the
        # trip's.
        needs = [t.requires_grad for t in ins]
        window = []

        def begin(grads):
            window.append(self.trace._begin())

        def end(grads):
            it = iter(grads)
            self.backward.append((self.trace._end(window.pop()), [
                _layout(next(it)) if need else None for need in needs]))

        out = step(*_marked(self.trace, end, ins))
        return tuple(_marked(self.trace, begin, list(out)))


def _marked(trace: _Trace, note: Callable, ts: list) -> list:
    """`ts`, those that require a gradient through a `_Mark` calling
    `note` in the backward pass (the mark's views made unseen by the
    trace's counts)."""
    at = [i for i, t in enumerate(ts) if t.requires_grad]
    with trace._muted():
        got = _Mark.apply(note, *[ts[i] for i in at])
    out = list(ts)
    for i, t in zip(at, got):
        out[i] = t
    return out


class _Mark(torch.autograd.Function):
    """The identity, whose backward calls `note` with the gradients."""

    @staticmethod
    def forward(ctx, note, *ts):
        ctx.note = note
        ctx.set_materialize_grads(False)
        return ts

    @staticmethod
    def backward(ctx, *grads):
        ctx.note(grads)
        return (None, *grads)


class _StandIn(torch.autograd.Function):
    """A scan trip counted, not run (`_Scan`): its forward makes its
    outputs and its backward the gradients of its inputs, each adding a
    run trip's counts.  It saves its carry, as a run trip's ops save
    theirs, so that the trip's checkpoint holds its inputs as a run
    trip's does; the saved carry is never read, so nothing is
    recomputed."""

    @staticmethod
    def forward(ctx, trips, carry, *x_i):
        ctx.trips = trips
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(carry)
        out = trips.forward_trip()
        ctx.mark_non_differentiable(*[
            t for t, layout in zip(out, trips.forward[0][1])
            if t is not None and not layout[0]])
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.trips.backward_trip())


# The counts that add up layer by layer.
_ADDITIVE = ("ops", "flops_micro", "flops_once", "bytes_micro",
             "bytes_once", "matmuls", "out_bytes")
# A whole-depth trace estimated to dispatch more operations than this
# takes the shortcut over periods of the layer pattern (at ~0.1 ms of
# Python an op on meta tensors, about 10 s of host time; a partitioned
# trace's ops take several times longer, DTensor's propagation
# included).
SHORTCUT_OPS = 100_000


def trace_step(cfg, kind: str, inputs: Dict[str, torch.Tensor],
               cache_len: int, rules=None, *, mesh=None,
               shardings: Optional[Dict[str, MeshSharding]] = None,
               device="meta", n_micro: int = 1,
               before_step: Optional[Callable[[list], None]] = None,
               timeline: bool = False) -> Dict[str, Any]:
    """Trace one step of `cfg`'s model: `inputs` its (micro)batch,
    `cache_len` the serving cache's slots.

    Without `mesh` the step runs on meta tensors as they are: the
    device's batch on whole weights.  With `mesh` (a `launch.mesh.Mesh`)
    it is partitioned: `inputs` are the global microbatch and
    `shardings` theirs, every argument (the state, or the bf16 params
    and the cache, and the batch) is a DTensor over `one_rank(mesh)`
    whose local tensor is rank 0's shard (`on_rank`, on `device`), the
    models' `logical_constraint` hints redistribute, and what is counted
    is rank 0's.  With `n_micro` > 1 the step runs the first of that
    many microbatches of `inputs` (a view: each rank's first rows).
    `before_step`, if given, is called with the local tensors of every
    argument once they are made, before the step runs.  With `timeline`
    the result also holds "timeline": each counted op's name and the
    most live bytes while it ran, in order.  A scan of more than
    2 * SCAN_RUN trips runs a few and counts the others (`_Trace.scan`).

    Returns the `_ADDITIVE` counts, the peak and the collectives:
    "micro" parts are forward and backward (train) or the serving step,
    "once" the update; "coll_largest" the largest result of each kind;
    "scan_trips_counted" the scan trips counted, not run, and
    "scan_collectives" the collectives they added (none where no trip
    issues one)."""
    model = build(cfg)
    specs = model.param_specs()
    tr = _Trace(torch.device(device).type)
    if timeline:
        tr.names, tr.lives = [], array("q")
    with contextlib.ExitStack() as scope:
        if mesh is not None:
            dm = scope.enter_context(one_rank(
                mesh, "cpu" if device == "meta" else
                torch.device(device).type))
            scope.enter_context(implicit_replication())
            scope.enter_context(gspmd_choices())
            inputs = {k: on_rank(v, shardings[k], dm, device)
                      for k, v in inputs.items()}
        batch = _first_micro(inputs, n_micro)
        if kind == "train":
            state = train_lib.abstract_state(model)
            if mesh is not None:
                state = on_rank(state, train_lib.state_shardings(
                    specs, rules, mesh), dm, device)
            if before_step is not None:
                before_step([_local(t) for t in tree_leaves((state, inputs))
                             if isinstance(t, torch.Tensor)])
            inputs = batch
            with tr, counting_scans(tr.scan):
                loss, grads = train_lib.step_grads(model, state.master,
                                                   inputs, rules)
                micro = (tr.flops, tr.bytes, Counter(tr.collectives))
                _, state, metrics = optim.apply(
                    tree_unflatten(state.master, grads), state,
                    optim.AdamWConfig(), 1.0)
                del grads
            outputs = [loss, metrics["grad_norm"]]
        else:
            params = param_shapes(specs, dtype=torch.bfloat16)
            cache = serve_lib.abstract_cache(model,
                                             inputs["tokens"].shape[0],
                                             cache_len)
            if mesh is not None:
                params = on_rank(params, _param_shardings(specs, rules, mesh),
                                 dm, device)
                cache = on_rank(cache, serve_lib.cache_shardings(
                    cache, mesh, rules), dm, device)
            if before_step is not None:
                before_step([_local(t) for t in
                             tree_leaves((params, cache, inputs))
                             if isinstance(t, torch.Tensor)])
            inputs = batch
            with torch.no_grad(), tr, counting_scans(tr.scan):
                if kind == "prefill":
                    step = serve_lib.make_prefill_step(model, rules)
                    logits, cache = step(params, inputs, cache)
                else:
                    step = serve_lib.make_decode_step(model, rules)
                    logits, cache = step(params, cache, inputs["tokens"])
            micro = (tr.flops, tr.bytes, Counter(tr.collectives))
            outputs = [logits]
        out_bytes = sum(_nbytes(_local(t)) for t in outputs)
    if tr.sites is not None:
        _SITES.append({"kind": kind, "layers": cfg.num_layers,
                       "peak": tr.peak, "peak_site": tr.peak_site,
                       "peak_live": tr.peak_live,
                       "collectives": tr.sites})
    out = {"flops_micro": micro[0], "flops_once": tr.flops - micro[0],
           "bytes_micro": micro[1], "bytes_once": tr.bytes - micro[1],
           "coll_micro": micro[2], "coll_once": tr.collectives - micro[2],
           "coll_largest": tr.largest, "ops": tr.ops,
           "matmuls": tr.matmuls, "peak": tr.peak, "out_bytes": out_bytes,
           "scan_trips_counted": tr.counted_trips,
           "scan_collectives": tr.trip_collectives}
    if timeline:
        out["timeline"] = (tr.names, tr.lives)
    return out


def _first_micro(batch: Dict[str, torch.Tensor], n_micro: int
                 ) -> Dict[str, torch.Tensor]:
    """The first of `n_micro` microbatches of `batch`: each leaf's first
    rows on every rank (its batch dimension's local part divided by
    `n_micro`), as views."""
    if n_micro == 1:
        return batch
    out = {}
    for k, v in batch.items():
        bdim = 1 if k == "mrope_positions" else 0
        local = _local(v).narrow(bdim, 0, _local(v).shape[bdim] // n_micro)
        if not isinstance(v, DTensor):
            out[k] = local
            continue
        shape = list(v.shape)
        shape[bdim] //= n_micro
        shape = tuple(shape)
        out[k] = DTensor.from_local(
            local, v.device_mesh, v.placements, run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride())
    return out


def _param_shardings(specs, rules, mesh):
    """The bf16 parameters' shardings: each leaf the mesh and its spec."""
    return tree_map(lambda s: MeshSharding(mesh, s),
                    param_sharding(specs, rules),
                    is_leaf=lambda x: isinstance(x, tuple))


# ---------------------------------------------------------------------------
# Periods of the layer pattern
# ---------------------------------------------------------------------------


def layer_sequence(cfg) -> list:
    """Each layer's kind, in the model's order: ("enc",) then ("dec",)
    for the encoder-decoder, else (global attention, dense)."""
    if cfg.is_encdec:
        return ([("enc",)] * cfg.enc_dec.enc_layers
                + [("dec",)] * cfg.num_layers)
    return [(cfg.layer_is_global(i), i in cfg.moe_dense_layers)
            for i in range(cfg.num_layers)]


def layer_period(cfg) -> tuple:
    """(head, period, count): the model's layers are `head` fixed layers
    (the dense prefix), then `count` periods of `period` layers of its
    local/global pattern, then the first layers of one more period (the
    remainder).  The encoder-decoder's period is one encoder and one
    decoder layer, its head the layers one stack has beyond the
    other's."""
    if cfg.is_encdec:
        n = min(cfg.enc_dec.enc_layers, cfg.num_layers)
        return cfg.enc_dec.enc_layers + cfg.num_layers - 2 * n, 2, n
    head = len(cfg.moe_dense_layers)
    rest = layer_sequence(cfg)[head:]
    period = next(p for p in range(1, len(rest) + 1)
                  if all(rest[i] == rest[i - p]
                         for i in range(p, len(rest))))
    return head, period, len(rest) // period


def depth_config(cfg, periods: int) -> Any:
    """`cfg` with its head, `periods` periods of its layer pattern and its
    remainder, in the model's order (global layers named explicitly)."""
    head, period, count = layer_period(cfg)
    if cfg.is_encdec:
        cut = count - periods
        return dataclasses.replace(
            cfg, num_layers=cfg.num_layers - cut,
            enc_dec=dataclasses.replace(
                cfg.enc_dec, enc_layers=cfg.enc_dec.enc_layers - cut))
    kinds = layer_sequence(cfg)
    n = cfg.num_layers - (count - periods) * period
    changes: Dict[str, Any] = {"num_layers": n}
    if cfg.attn_window is not None:
        changes["global_layers"] = tuple(
            i for i in range(n)
            if kinds[i if i < head else head + (i - head) % period][0])
        changes["global_layer_every"] = None
    return dataclasses.replace(cfg, **changes)


def _repeated_blocks(one: list, two: list) -> Optional[list]:
    """Where the ops of the trace of two periods (`two`, op names) repeat
    a period: `two` is `one` with blocks of ops inserted, each a copy of
    the block that follows it (the next period's forward, or backward, or
    update).  Returns, for each op of `two`, the index of its op in `one`,
    or -1 for an inserted one, with each block as early as it can stand
    (the period first in time); None if `two` is not such a copy."""
    match = [-1] * len(two)
    i = j = 0
    window = 16
    while j < len(two):
        if i < len(one) and one[i] == two[j]:
            match[j] = i
            i, j = i + 1, j + 1
            continue
        extra = (len(two) - j) - (len(one) - i)
        ahead = one[i:i + window]
        size = next((n for n in range(1, extra + 1)
                     if (not ahead or two[j + n] == ahead[0])
                     and two[j + n:j + n + len(ahead)] == ahead
                     and two[j:j + n] == two[j - n:j]), None)
        if size is None:
            return None
        start = j
        while start > 0 and match[start - 1] >= 0 \
                and two[start - 1] == two[start + size - 1]:
            match[start + size - 1] = match[start - 1]
            match[start - 1] = -1
            start -= 1
        j += size
    return match if i == len(one) else None


def _peak_of(low, high, periods: int, base: int) -> Optional[int]:
    """The peak live bytes of the step over `periods` periods, from the
    timelines (`trace_step`'s "timeline") of the traces of `base`
    periods (`low`) and of one more (`high`).  Each op of `low` and its
    op in `high` hold the bytes of one more period later on: so each op
    of the whole step, the ops of the last period among them, holds its
    bytes in `low` plus one increment a period more.  The first period's
    ops, inserted in `high`, follow the line of the next period's
    counterpart in `low`.  None where the two do not align period by
    period."""
    (names0, lives0), (names1, lives1) = low, high
    match = _repeated_blocks(names0, names1)
    if match is None:
        return None
    more = periods - base
    peak = max(lives0[i] + more * (lives1[j] - lives0[i])
               for j, i in enumerate(match) if i >= 0)
    j = 0
    while j < len(match):
        if match[j] >= 0:
            j += 1
            continue
        end = j
        while end < len(match) and match[end] < 0:
            end += 1
        if end + end - j > len(match):
            return None
        for n in range(j, end):
            first = lives0[match[n + end - j]]
            peak = max(peak, first + more * (lives1[n] - first))
        j = end
    return peak


def traced_cost(cfg, kind: str, inputs, cache_len: int, rules=None,
                *, mesh=None, shardings=None,
                shortcut: Optional[bool] = None,
                memo: Optional[dict] = None) -> Dict[str, Any]:
    """`trace_step` of the whole model, or with `shortcut` its
    extrapolation from the model cut to one period of its layer pattern
    and to two, or to two and three (`depth_config`, each in the model's
    order with the head and the remainder): every additive count is the
    smaller trace's plus one period's increment for each further
    period, and the peak is `_peak_of` the two traces' timelines.  A
    pattern of fewer than two periods (hymba's explicit global layers),
    or two traces that do not match period by period, trace whole.  By
    default the shortcut is taken when the whole depth would dispatch
    more than SHORTCUT_OPS operations, scaled from the one-period
    trace's count.  The result's "trace_mode" says which was done.
    `memo` keeps traces across calls: a plain trace depends on the
    config, the inputs' shapes and the cache length, not on the rules,
    which are hints; a partitioned one on the mesh and the rules too.
    Each trace counts its scans by their trip count (`_Trace.scan`):
    the counts and the peak are those of running every trip, and
    "scan_trips_counted" adds up as the additive counts do."""
    memo = {} if memo is None else memo

    def trace(c, timeline=False):
        key = (repr(c), kind, cache_len, tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items())))
        if mesh is not None:
            key += (mesh, repr(sorted(rules.items())), repr(shardings))
        if key in memo and (not timeline or "timeline" in memo[key]):
            return memo[key]
        memo[key] = trace_step(c, kind, inputs, cache_len, rules, mesh=mesh,
                               shardings=shardings, timeline=timeline)
        return memo[key]

    count = layer_period(cfg)[2]
    if shortcut is False or count < 2:
        return {**trace(cfg), "trace_mode": "full"}
    one = depth_config(cfg, 1)
    cost = trace(one, timeline=True)
    estimate = cost["ops"] * len(layer_sequence(cfg)) \
        / len(layer_sequence(one))
    if shortcut is None and estimate <= SHORTCUT_OPS:
        return {**trace(cfg), "trace_mode": "full"}
    # From two periods and three where five cost less than the whole:
    # the first period's ops may differ from the next ones' (a stacked
    # leaf of one layer, a sum begun in the first layer); else, or where
    # those do not align, from one period and two.
    for base in ((2, 1) if count > 5 else (1,)):
        low = trace(depth_config(cfg, base), timeline=True)
        high = trace(depth_config(cfg, base + 1), timeline=True)
        peak = (high["peak"] if count == base + 1 else
                _peak_of(low["timeline"], high["timeline"], count, base))
        if peak is not None:
            break
    for out in memo.values():
        out.pop("timeline", None)
    if peak is None:
        return {**trace(cfg), "trace_mode": "full"}
    more = count - base
    total = dict(low, trace_mode="shortcut", peak=peak)
    for key in (*_ADDITIVE, "scan_trips_counted"):
        total[key] += more * (high[key] - low[key])
    for key in ("coll_micro", "coll_once", "scan_collectives"):
        total[key] = Counter({
            c: low[key][c] + more * (high[key][c] - low[key][c])
            for c in set(low[key]) | set(high[key])})
    total["coll_largest"] = low["coll_largest"] | high["coll_largest"]
    return total


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _trace_inputs(specs, shardings, n_micro: int, partitioned: bool
                  ) -> Dict[str, torch.Tensor]:
    """The microbatch the trace runs: each batch leaf with its batch
    dimension divided by `n_micro`, at its global shape for a
    partitioned trace, else at its per-device shape."""
    out = {}
    for k, v in specs.items():
        shape = list(v.shape if partitioned
                     else shardings[k].shard_shape(v.shape))
        bdim = 1 if k == "mrope_positions" else 0
        shape[bdim] //= n_micro
        out[k] = torch.empty(shape, dtype=v.dtype, device="meta")
    return out


def _splits_the_step(mesh, whole_weights: bool) -> bool:
    """Whether a trace of the device's batch on whole weights would not
    be the device's own step: a weight is split, or a mesh axis other
    than the data axes is wider than one."""
    return not whole_weights or any(
        n > 1 for a, n in axis_sizes(mesh).items()
        if a not in data_axes(mesh))


def _collective_record(cost, n_micro: int) -> Dict[str, float]:
    """The traced collectives in `collective_bytes`'s schema: result
    bytes per kind, "total" and "<kind>_count", the forward and
    backward's counted `n_micro` times."""
    both = Counter()
    for key, v in cost["coll_micro"].items():
        both[key] += n_micro * v
    for key, v in cost["coll_once"].items():
        both[key] += v
    out = {k: float(v) for k, v in sorted(both.items())
           if not k.endswith("_count")}
    out["total"] = float(sum(out.values()))
    out.update({k: float(v) for k, v in sorted(both.items())
                if k.endswith("_count")})
    return out


def lower(cfg, shape: ShapeSpec, mesh, compile_: bool = True,
          memo: Optional[dict] = None, *,
          partitioned: Optional[bool] = None,
          shortcut: Optional[bool] = None) -> Dict[str, Any]:
    """Lower (and, with `compile_`, trace) one step of `cfg` at `shape`
    on `mesh`; returns the record's fields after its naming keys.  The
    trace is partitioned over `mesh` where `_splits_the_step`, unless
    `partitioned` says otherwise; `shortcut` is `traced_cost`'s."""
    result: Dict[str, Any] = {}
    model = build(cfg)
    rules = _shape_rules(train_lib.make_rules(cfg, mesh), shape, mesh, cfg)
    t0 = time.time()

    specs = model.param_specs()
    b_specs = input_specs(cfg, shape)
    b_shard = batch_shardings(cfg, shape, mesh, rules)
    n_micro = 1
    if shape.kind == "train":
        n_micro = _n_micro(cfg, shape, mesh)
        result["n_micro"] = n_micro
        state = train_lib.abstract_state(model)
        s_shard = train_lib.state_shardings(specs, rules, mesh)
        args = local_bytes(state, s_shard) + local_bytes(b_specs, b_shard)
        alias = local_bytes(state, s_shard)
        whole_weights = alias == whole_bytes(state)
        cache = c_shard = None
    else:
        params = param_shapes(specs, dtype=torch.bfloat16)
        p_shard = _param_shardings(specs, rules, mesh)
        cache = serve_lib.abstract_cache(model, shape.global_batch,
                                         shape.seq_len)
        c_shard = serve_lib.cache_shardings(cache, mesh, rules)
        alias = local_bytes(cache, c_shard)
        batch = (b_specs if shape.kind == "prefill"
                 else {"tokens": b_specs["tokens"]})
        p_local = local_bytes(params, p_shard)
        whole_weights = p_local == whole_bytes(params)
        args = (p_local
                + local_bytes(batch, {k: b_shard[k] for k in batch}) + alias)
    result["lower_s"] = round(time.time() - t0, 1)
    if not compile_:
        result["status"] = "LOWERED"
        return result

    t1 = time.time()
    if partitioned is None:
        partitioned = _splits_the_step(mesh, whole_weights)
    inputs = _trace_inputs(b_specs, b_shard, n_micro, partitioned)
    if shape.kind == "decode":
        inputs = {"tokens": inputs["tokens"]}
    split = ({"mesh": mesh, "shardings": {k: b_shard[k] for k in inputs}}
             if partitioned else {})
    cost = traced_cost(cfg, shape.kind, inputs, shape.seq_len, rules,
                       memo=memo, shortcut=shortcut, **split)
    if shape.kind == "train" and cfg.remat != "none":
        plain = traced_cost(dataclasses.replace(cfg, remat="none"), "train",
                            inputs, shape.seq_len, rules, memo=memo,
                            shortcut=shortcut, **split)
        remat_dup = remat_duplication(cost["matmuls"], plain["matmuls"])
    else:
        remat_dup = 1.0        # nothing is recomputed without a backward
    result["compile_s"] = round(time.time() - t1, 1)
    result["trace_mode"] = cost["trace_mode"]
    result["scan_trips_counted"] = cost["scan_trips_counted"]
    result["scan_collectives"] = dict(cost["scan_collectives"])
    result["trace_scope"] = "device"
    result["partitioned"] = partitioned

    out = cost["out_bytes"] + alias
    temp = max(0, cost["peak"] - cost["out_bytes"])
    result["memory"] = {
        "argument_bytes": int(args),
        "output_bytes": int(out),
        "temp_bytes": int(temp),
        "alias_bytes": int(alias),
        "peak_per_device_gib": round((args + out + temp - alias) / 2**30, 3),
    }
    result["cost"] = {
        "flops": float(n_micro * cost["flops_micro"] + cost["flops_once"]),
        "bytes_accessed": float(n_micro * cost["bytes_micro"]
                                + cost["bytes_once"]),
    }
    tokens = math.prod(b_shard["tokens"].shard_shape(inputs["tokens"].shape)
                       if partitioned else inputs["tokens"].shape)
    # hymba's and the encoder-decoder's decode attention take no chunk.
    result["collectives"] = collective_bytes(
        shape.kind, specs, rules, mesh, tokens=tokens, n_micro=n_micro,
        cache=cache, cache_shardings=c_shard,
        kv_chunk=cfg.attn_kv_chunk if cfg.mixer == "gqa" else None)
    result["collectives_traced"] = _collective_record(cost, n_micro)
    result["remat_dup"] = round(remat_dup, 3)
    result["status"] = "OK"
    return result


def run_on_rank(cfg, shape: ShapeSpec, mesh, device,
                before_step: Optional[Callable[[list], None]] = None
                ) -> Dict[str, Any]:
    """One step of `cfg` at `shape` as rank 0 of `mesh`, run for real on
    `device` (a card): the partitioned program `lower` traces, with
    every argument's local tensor made there (zeros; the whole batch,
    of which the step takes the first microbatch) and every collective
    returning an allocated, unfilled buffer.  Values mean nothing;
    memory is the point.  `before_step` is `trace_step`'s.  Returns
    `trace_step`'s counts."""
    rules = _shape_rules(train_lib.make_rules(cfg, mesh), shape, mesh, cfg)
    b_shard = batch_shardings(cfg, shape, mesh, rules)
    inputs = input_specs(cfg, shape)
    if shape.kind == "decode":
        inputs = {"tokens": inputs["tokens"]}
    n_micro = _n_micro(cfg, shape, mesh) if shape.kind == "train" else 1
    return trace_step(cfg, shape.kind, inputs, shape.seq_len, rules,
                      mesh=mesh, shardings={k: b_shard[k] for k in inputs},
                      device=device, n_micro=n_micro,
                      before_step=before_step)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               compile_: bool = True, memo: Optional[dict] = None
               ) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    runnable, reason = cell_is_runnable(cfg, shape)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
    }
    if not runnable:
        result["status"] = "SKIP"
        result["reason"] = reason
        return result
    mesh = make_production_mesh(multi_pod=multi_pod)
    result.update(lower(cfg, shape, mesh, compile_, memo=memo))
    return result


def run_cells(archs, shapes, meshes, out_dir: Optional[str],
              compile_: bool = True) -> list:
    results, memo = [], {}
    for multi_pod in meshes:
        for arch in archs:
            for shape_name in shapes:
                tag = (f"{arch}|{shape_name}|"
                       f"{'2x16x16' if multi_pod else '16x16'}")
                try:
                    r = lower_cell(arch, shape_name, multi_pod, compile_,
                                   memo)
                except Exception as e:  # a failing cell is a bug: surface it
                    r = {"arch": arch, "shape": shape_name,
                         "mesh": "2x16x16" if multi_pod else "16x16",
                         "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc()[-2000:]}
                if r["status"] == "OK":
                    how = "partitioned" if r["partitioned"] else "plain"
                    note = (f"trace={r['compile_s']}s ({r['trace_mode']}, "
                            f"{how}) peak="
                            f"{r['memory']['peak_per_device_gib']}GiB")
                else:
                    note = r.get("reason", r.get("error", ""))[:120]
                print(f"[{r['status']:7s}] {tag} {note}", flush=True)
                results.append(r)
                if out_dir:
                    os.makedirs(out_dir, exist_ok=True)
                    fname = tag.replace("|", "_").replace("/", "-") + ".json"
                    with open(os.path.join(out_dir, fname), "w") as f:
                        json.dump({k: v for k, v in r.items()
                                   if k != "trace"}, f, indent=1)
                gc.collect()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--sites", type=int, default=0, metavar="N",
                    help="print, for each trace, the N collective sites "
                         "with the most bytes and where its peak was")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    with sites() if args.sites else contextlib.nullcontext() as kept:
        results = run_cells(archs, shapes, meshes, args.out_dir,
                            compile_=not args.no_compile)
    for t in kept or ():
        print(f"sites: {t['kind']} trace of {t['layers']} layers, peak "
              f"{t['peak']} B at {t['peak_site']}")
        by_bytes = sorted(t["collectives"].items(), key=lambda kv: -kv[1]
                          * math.prod(kv[0][2]) * kv[0][1].itemsize)
        for (kind, dtype, shape, where), n in by_bytes[:args.sites]:
            nbytes = n * math.prod(shape) * dtype.itemsize
            print(f"  {kind:14s} {n:5d} x {str(dtype)[6:]}{list(shape)} = "
                  f"{nbytes} B  {where}")
    n_ok = sum(r["status"] == "OK" for r in results)
    n_low = sum(r["status"] == "LOWERED" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n== dry-run: {n_ok} OK, {n_low} LOWERED, {n_skip} SKIP, "
          f"{n_fail} FAIL of {len(results)} cells ==")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
