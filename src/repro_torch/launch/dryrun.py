"""Multi-pod dry run: lower + trace every (arch x shape x mesh) cell.

The port's counterpart of the reference's dry run, which lowers each
cell's step for 512 placeholder devices and compiles it.  Here nothing
is allocated on any device and no card is initialised: the production
mesh is a plain description of its axes (`launch.mesh.Mesh`), and every
state, cache and batch leaf is a meta tensor.

"Lowering" builds the abstract state (train) or bf16 parameters and
cache (prefill, decode), the batch, and their shardings on the mesh;
with ``--no-compile`` a record stops there, status ``LOWERED``.
"Compiling" traces the step on meta tensors at the per-device
microbatch and records, with the reference's keys:

  * memory — `argument_bytes` is exact: each argument leaf's per-device
    bytes under its placements (an uneven dimension rounded up, as XLA
    pads it); the donated arguments (the state in training, the cache
    in serving) are `alias_bytes`, as `donate_argnums` makes them.
    `temp_bytes` is the peak of live meta-tensor bytes the step makes
    (counted when an op makes a tensor, uncounted when it is freed),
    less the step's new outputs, which are `output_bytes` with the
    aliased arguments.  Training traces one microbatch's forward,
    backward and update.
  * cost — `flops` by `torch.utils.flop_counter`'s formula table, the
    one `FlopCounterMode` applies (the tests hold the two equal),
    counted in the same dispatch pass as the bytes; `bytes_accessed`
    the sum of each dispatched op's input and output bytes (view ops,
    which move nothing, left out); forward and
    backward count `n_micro` times, the update once.  XLA's
    `cost_analysis` counts a scanned loop body once (a stacked model's
    layers, the microbatches); the trace counts every layer and every
    microbatch.
  * collectives and remat_dup — `launch/comm_analysis.py`.

The trace runs the device's batch on whole weights: it is the device's
own step only when no weight is sharded and no mesh axis but the data
axes is wider than one (a 1 x 1 mesh, or pure data parallelism).  The
record's "trace_scope" says which: "device", and the figures above
stand under the reference's keys; or "data_shard" (the production
meshes, whose model axis and FSDP split the weights, activations and
gradients the trace holds whole), and then `output_bytes`,
`temp_bytes`, `peak_per_device_gib`, `flops` and `bytes_accessed` are
null and the trace's figures, upper bounds of the device's, stand under
`output_bytes_upper`, `temp_bytes_upper`, `peak_upper_gib`,
`flops_upper` and `bytes_accessed_upper`.

Python time per op on meta tensors is high (the SSM scans go chunk by
chunk, attention by query and key chunks), so where the whole depth
would dispatch more than SHORTCUT_OPS operations (counted in the trace
of one layer of each kind) a cell takes a shortcut: one layer of each distinct
kind (local or global window, dense or MoE, encoder or decoder), and
once more with one more layer of each kind.  FLOPs, bytes and matrix
products are then the base plus each kind's increment times its
count less one, which equals the whole-depth trace (layers of one kind
cost the same; held equal at smoke() size by the tests).  The peak is
estimated: extrapolated the same way in training, where each layer's
boundary and gradients stay live, and the largest traced peak in
serving, where each layer's work is freed.  It depends on where in the
layer order the kinds fall, which the shortcut does not keep, and the
tests hold it within 15 % of the whole-depth trace at smoke() size.  A
record's "trace_mode" says "full" or "shortcut".

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out-dir build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time
import traceback
import weakref
from collections import Counter
from typing import Any, Dict, Optional

import torch
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
from repro_torch.models.common import (param_sharding, param_shapes,
                                       tree_leaves, tree_map, tree_unflatten)
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
        # otherwise the sequence dimension (flash-decode style; GSPMD
        # inserts the partial-softmax combine).  MLA's latent cache has no
        # heads dimension, so it always seq-shards.
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


# The traced figures, and their names where the trace is not the
# device's own step (an upper bound of the device's).
_UPPER = {"memory": {"output_bytes": "output_bytes_upper",
                     "temp_bytes": "temp_bytes_upper",
                     "peak_per_device_gib": "peak_upper_gib"},
          "cost": {"flops": "flops_upper",
                   "bytes_accessed": "bytes_accessed_upper"}}


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


class _Trace(TorchDispatchMode):
    """Counts, over the ops dispatched while it is active: the ops, FLOPs
    (by FlopCounterMode's formulas), bytes read and written, matrix products,
    and the live bytes of the tensors the ops make (each counted
    when made, uncounted when freed) with their peak.  Tensors made
    before it, the arguments, are never counted."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.ops = self.flops = self.bytes = self.matmuls = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.name() in MATMUL_OPS:
            self.matmuls += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        rets = func._schema.returns
        views = bool(rets) and all(r.alias_info is not None
                                   and not r.alias_info.is_write
                                   for r in rets)
        if not views:
            ins = tree_flatten((args, kwargs))[0]
            self.bytes += sum(_nbytes(t) for t in ins + outs
                              if isinstance(t, torch.Tensor))
        for i, o in enumerate(outs):
            if i < len(rets) and rets[i].alias_info is not None:
                continue                         # a view or in place
            n = o.untyped_storage().nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(o, self._free, n)
        return out


# The counts that add up layer by layer.
_ADDITIVE = ("ops", "flops_micro", "flops_once", "bytes_micro",
             "bytes_once", "matmuls", "out_bytes")
# A whole-depth trace estimated to dispatch more operations than this
# takes the one-layer-per-kind shortcut (at ~0.1 ms of Python an op on
# meta tensors, about 10 s of host time).
SHORTCUT_OPS = 100_000


def trace_step(cfg, kind: str, inputs: Dict[str, torch.Tensor],
               cache_len: int, rules=None) -> Dict[str, int]:
    """Trace one step of `cfg`'s model on meta tensors: `inputs` are the
    device's (micro)batch, `cache_len` the serving cache's slots.
    Returns the `_ADDITIVE` counts and the peak: "micro" parts are
    forward and backward (train) or the serving step, "once" the
    update."""
    model = build(cfg)
    tr = _Trace()
    if kind == "train":
        state = train_lib.abstract_state(model)
        with tr:
            loss, grads = train_lib.step_grads(model, state.master, inputs,
                                               rules)
            micro = (tr.flops, tr.bytes)
            _, state, metrics = optim.apply(
                tree_unflatten(state.master, grads), state,
                optim.AdamWConfig(), 1.0)
            del grads
        outputs = [loss, metrics["grad_norm"]]
    else:
        params = param_shapes(model.param_specs(), dtype=torch.bfloat16)
        cache = serve_lib.abstract_cache(model, inputs["tokens"].shape[0],
                                         cache_len)
        with torch.no_grad(), tr:
            if kind == "prefill":
                step = serve_lib.make_prefill_step(model, rules)
                logits, cache = step(params, inputs, cache)
            else:
                step = serve_lib.make_decode_step(model, rules)
                logits, cache = step(params, cache, inputs["tokens"])
        micro = (tr.flops, tr.bytes)
        outputs = [logits]
    return {"flops_micro": micro[0], "flops_once": tr.flops - micro[0],
            "bytes_micro": micro[1], "bytes_once": tr.bytes - micro[1],
            "ops": tr.ops, "matmuls": tr.matmuls, "peak": tr.peak,
            "out_bytes": sum(_nbytes(t) for t in outputs)}


# ---------------------------------------------------------------------------
# One layer of each kind
# ---------------------------------------------------------------------------


def layer_kinds(cfg) -> Counter:
    """How many layers of each distinct kind the model has: ("enc",) /
    ("dec",) for the encoder-decoder, else (global attention, dense)."""
    if cfg.is_encdec:
        return Counter({("enc",): cfg.enc_dec.enc_layers,
                        ("dec",): cfg.num_layers})
    return Counter((cfg.layer_is_global(i), i in cfg.moe_dense_layers)
                   for i in range(cfg.num_layers))


def depth_config(cfg, counts) -> Any:
    """`cfg` with `counts[kind]` layers of each kind: dense layers first
    (the stacked models' prefix), global layers named explicitly."""
    if cfg.is_encdec:
        return dataclasses.replace(
            cfg, num_layers=counts[("dec",)],
            enc_dec=dataclasses.replace(cfg.enc_dec,
                                        enc_layers=counts[("enc",)]))
    order = sorted(counts, key=lambda k: (not k[1], k[0]))
    kinds = [k for k in order for _ in range(counts[k])]
    n_dense = sum(1 for k in kinds if k[1])
    changes: Dict[str, Any] = {
        "num_layers": len(kinds),
        "moe_dense_layers": tuple(range(n_dense)),
    }
    if cfg.attn_window is not None:
        changes["global_layers"] = tuple(i for i, k in enumerate(kinds)
                                         if k[0])
        changes["global_layer_every"] = None
    return dataclasses.replace(cfg, **changes)


def traced_cost(cfg, kind: str, inputs, cache_len: int, rules=None,
                *, shortcut: Optional[bool] = None,
                memo: Optional[dict] = None) -> Dict[str, Any]:
    """`trace_step` of the whole model, or with `shortcut` its
    extrapolation from one layer of each kind and one more of each.  By
    default the shortcut is taken when the whole depth would dispatch
    more than SHORTCUT_OPS operations, scaled from the one-of-each
    trace's count.  The result's "trace_mode" says which was done.
    `memo` keeps traces across
    calls: a trace depends on the config, the inputs' shapes and the
    cache length, not on the rules, which are hints."""
    def trace(c):
        key = (repr(c), kind, cache_len, tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items())))
        if memo is not None and key in memo:
            return memo[key]
        out = trace_step(c, kind, inputs, cache_len, rules)
        if memo is not None:
            memo[key] = out
        return out

    full = layer_kinds(cfg)
    base = Counter({k: 1 for k in full})
    if shortcut is False or base == full:
        return {**trace(cfg), "trace_mode": "full"}
    cost = trace(depth_config(cfg, base))
    estimate = cost["ops"] * sum(full.values()) / sum(base.values())
    if shortcut is None and estimate <= SHORTCUT_OPS:
        return {**trace(cfg), "trace_mode": "full"}
    total = dict(cost, trace_mode="shortcut")
    for k, n in full.items():
        if n == 1:
            continue
        more = trace(depth_config(cfg, base + Counter({k: 1})))
        for key in _ADDITIVE:
            total[key] += (n - 1) * (more[key] - cost[key])
        # Training keeps each layer's boundary and gradients, so its peak
        # grows with depth; a serving step frees each layer's work.
        total["peak"] = (total["peak"] + (n - 1) * (more["peak"]
                                                    - cost["peak"])
                         if kind == "train"
                         else max(total["peak"], more["peak"]))
    return total


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _trace_inputs(specs, shardings, n_micro: int) -> Dict[str, torch.Tensor]:
    """The device's microbatch: each batch leaf's per-device shape with
    its batch dimension divided by `n_micro`."""
    out = {}
    for k, v in specs.items():
        shape = list(shardings[k].shard_shape(v.shape))
        bdim = 1 if k == "mrope_positions" else 0
        shape[bdim] //= n_micro
        out[k] = torch.empty(shape, dtype=v.dtype, device="meta")
    return out


def lower(cfg, shape: ShapeSpec, mesh, compile_: bool = True,
          memo: Optional[dict] = None) -> Dict[str, Any]:
    """Lower (and, with `compile_`, trace) one step of `cfg` at `shape`
    on `mesh`; returns the record's fields after its naming keys."""
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
        p_shard = tree_map(lambda s: MeshSharding(mesh, s),
                           param_sharding(specs, rules),
                           is_leaf=lambda x: isinstance(x, tuple))
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
    inputs = _trace_inputs(b_specs, b_shard, n_micro)
    if shape.kind == "decode":
        inputs = {"tokens": inputs["tokens"]}
    cost = traced_cost(cfg, shape.kind, inputs, shape.seq_len, rules,
                       memo=memo)
    if shape.kind == "train" and cfg.remat != "none":
        plain = traced_cost(dataclasses.replace(cfg, remat="none"), "train",
                            inputs, shape.seq_len, rules, memo=memo)
        remat_dup = remat_duplication(cost["matmuls"], plain["matmuls"])
    else:
        remat_dup = 1.0        # nothing is recomputed without a backward
    result["compile_s"] = round(time.time() - t1, 1)
    result["trace_mode"] = cost["trace_mode"]
    # The trace holds whole weights and the device's batch.
    sizes = axis_sizes(mesh)
    per_device = whole_weights and all(
        n == 1 for a, n in sizes.items() if a not in data_axes(mesh))
    result["trace_scope"] = "device" if per_device else "data_shard"

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
    tokens = math.prod(inputs["tokens"].shape)
    result["collectives"] = collective_bytes(
        shape.kind, specs, rules, mesh, tokens=tokens, n_micro=n_micro,
        cache=cache, cache_shardings=c_shard)
    result["remat_dup"] = round(remat_dup, 3)
    if not per_device:
        for block, names in _UPPER.items():
            for key, upper in names.items():
                result[block][upper] = result[block][key]
                result[block][key] = None
    result["status"] = "OK"
    return result


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
                    mem = r["memory"]
                    peak = (f"peak={mem['peak_per_device_gib']}GiB"
                            if r["trace_scope"] == "device" else
                            f"peak<={mem['peak_upper_gib']}GiB")
                    note = (f"trace={r['compile_s']}s ({r['trace_mode']}, "
                            f"{r['trace_scope']}) {peak}")
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
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = run_cells(archs, shapes, meshes, args.out_dir,
                        compile_=not args.no_compile)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_low = sum(r["status"] == "LOWERED" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n== dry-run: {n_ok} OK, {n_low} LOWERED, {n_skip} SKIP, "
          f"{n_fail} FAIL of {len(results)} cells ==")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
