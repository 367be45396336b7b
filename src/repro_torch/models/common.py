"""Shared model substrate: parameter specs, logical-axis rules, norms, and
the carrier that moves a parameter tree between NumPy and torch.

Sharding follows the reference's MaxText convention: every parameter and
activation is annotated with *logical* axis names, and a per-run rules
table maps them to mesh axes ("pod", "data", "model").  The port keeps
the table, `resolve` and `logical_constraint` with the reference's
signatures.  The dry run reads the parameters' specs as placements on a
device mesh (`launch/mesh.py`, `launch/train.state_shardings`) and, for
a mesh that splits the step, runs it on DTensors: there
`logical_constraint` redistributes to the hint's placements,
`token_positions` / `slot_positions` make positions split as the tokens
or the cache slots are, `batched` makes a mask or state split as its
operand's batch, `take_rows` looks an embedding up on its split rows,
`reduce_over` all-reduces a partial result, `contract` runs a batched
product with its batch and heads kept split, `project` a layer's
product with a weight split as GSPMD splits it, `aligned` moves a
split to the mesh axis of the tensor it is multiplied with,
`partial_as` makes a whole tensor a partial sum to add to one,
`placed_grads` gives a layer's weight gradients their weights' split
as they are made, and `write_rows_` / `write_columns_` write a cache on
this rank's shard.  `scan`, the chunk loops of the SSM mixers, hands its
trips to the dry run's trace while one runs (`counting_scans`), which
counts most of them by their trip count.
The eager single-card steps apply no placement: on a plain tensor each
does what the model wrote, and nothing more.

A parameter tree is a nested dict/list of tensors with the reference's
keys; the models are plain functions over it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_global_tensor_info, compute_local_shape_and_global_offset)
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import placements

Pytree = Any

# ---------------------------------------------------------------------------
# Logical axis -> mesh axis rules
# ---------------------------------------------------------------------------

# Default rules for the production mesh ("pod", "data", "model").  A rule
# value may be None (replicated), a mesh-axis name, or a tuple of names.
DEFAULT_RULES: Dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,             # residual-stream seq sharding ("model") = SP
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_exp": "model",
    "cache_seq": None,
    "cache_heads": "model",
    # parameters
    "embed": "data",         # FSDP axis
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "kv_lora": None,
    "conv": None,
    "state": None,
    "layers": None,
    "act_vocab": "model",
}


def resolve(rules: Mapping[str, Any], axes: Sequence[Optional[str]]
            ) -> Tuple[Any, ...]:
    """Translate logical axes to a partition spec (a tuple of mesh axes)."""
    spec = []
    for ax in axes:
        if ax is None:
            spec.append(None)
        else:
            if ax not in rules:
                raise KeyError(f"no sharding rule for logical axis {ax!r}")
            spec.append(rules[ax])
    # Drop trailing Nones for tidier specs.
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def logical_constraint(x: torch.Tensor, rules: Mapping[str, Any],
                       *axes: Optional[str]) -> torch.Tensor:
    """Sharding hint by logical axis names.  The axes are resolved (an
    unknown name raises, as in the reference).  A DTensor is
    redistributed to the placements they resolve to on its mesh; any
    other tensor is returned as it is, the same object (the eager
    single-card steps apply no placement)."""
    spec = resolve(rules, axes)
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def is_split(dt: DTensor, dim: int) -> bool:
    """Whether `dt`'s dimension `dim` is split over a mesh axis wider
    than one device."""
    return any(p.is_shard() and p.dim == dim and n > 1
               for p, n in zip(dt.placements, dt.device_mesh.shape))


def reduce_over(local: torch.Tensor, like: DTensor, dim: int,
                op: str = "sum") -> torch.Tensor:
    """`local`, a partial result on this rank, reduced (`op` "sum" or
    "max") over the mesh axes that split `like`'s dimension `dim`: one
    all-reduce, as a local tensor."""
    mesh = like.device_mesh
    over = [p.is_shard() and p.dim == dim and n > 1
            for p, n in zip(like.placements, mesh.shape)]
    if not any(over):
        return local
    part = DTensor.from_local(
        local, mesh, [Partial(op) if o else Replicate() for o in over],
        run_check=False, shape=local.shape, stride=local.stride())
    return part.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def contract(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """`torch.einsum(equation, *operands)`: a product with batch letters.
    On plain tensors it is that call.  Over DTensors it is split as GSPMD
    splits a dot with batch dimensions, on each mesh axis: the letter
    that axis splits in an operand stays split (where operands split
    different letters, the largest operand's), every operand holding
    that letter is split on it too (a move between split dimensions is
    an all-to-all) and the others are gathered; the einsum runs on the
    local tensors; the result is split on that letter where it keeps
    it, and a partial sum where it is contracted.  A DTensor einsum
    would instead flatten the batch letters for a bmm, and DTensor's
    reshape keeps only the first of two split parts: heads split with
    the batch would be gathered.  Each operand's gradient is a partial
    sum on the axes that split a letter it lacks."""
    if not any(isinstance(t, DTensor) for t in operands):
        return torch.einsum(equation, *operands)
    mesh = operands[0].device_mesh
    ins, out = equation.split("->")
    ins = ins.split(",")
    size = {c: n for letters, t in zip(ins, operands)
            for c, n in zip(letters, t.shape)}
    kept = []                    # each mesh axis's split letter, or None
    for m, n in enumerate(mesh.shape):
        split = [(t.numel(), -i, ins[i][t.placements[m].dim])
                 for i, t in enumerate(operands)
                 if n > 1 and t.placements[m].is_shard()]
        kept.append(max(split)[2] if split else None)
    local = []
    for letters, t in zip(ins, operands):
        held = [c is not None and c in letters for c in kept]
        # A partial sum is reduced (scattered where the axis splits a
        # letter it holds).
        want = [Shard(letters.index(c)) if h else Replicate()
                for c, h in zip(kept, held)]
        # An operand already placed is not redistributed: its gradient,
        # a partial sum where it lacks a split letter, stays one for its
        # producer (summed over a scan's trips and reduced once, as
        # GSPMD's), not reduced back to its whole placement at each use.
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        local.append(t.to_local(grad_placements=[
            p if c is None or h else Partial()
            for c, h, p in zip(kept, held, want)]))
    res = torch.einsum(equation, *local)
    places = [Replicate() if c is None else Shard(out.index(c)) if c in out
              else Partial() for c in kept]
    return DTensor.from_local(
        res, mesh, places, run_check=False,
        shape=tuple(size[c] for c in out),
        stride=tuple(compute_global_tensor_info(res, mesh, places)[1]))


def project(equation: str, x: torch.Tensor, w: torch.Tensor
            ) -> torch.Tensor:
    """`torch.einsum(equation, x, w)`: activations `x` times a weight
    `w`.  On plain tensors it is that call.  Over DTensors it is split
    as GSPMD splits a layer's product: on a mesh axis that splits a
    dimension of the activations the weight lacks (their batch, on the
    data axes), a weight split there (FSDP's input dimension) is
    gathered first, and the activations keep their split, unless the
    product is smaller than the weight (a decode step's few tokens) and
    another axis of that size holds both whole: the weight's split then
    moves to that axis (`_SwapSplit`, one permutation of the shards, as
    XLA's collective-permute), the activations are cut on that
    dimension there, and the product's partial sum over it is reduced
    at once (an all-reduce of the few tokens' product, as XLA's).  On an
    axis that splits only the weight, the weight keeps its split, not
    gathered (the activations are cut to match where its letter is
    contracted).  The product then runs as `contract` runs it.  In a
    one-token step (no axis splits what the product keeps of the
    activations, as for a batch of one; the product smaller than the
    weight) each partial sum a contracted dimension leaves is
    all-reduced at once, a few hundred values, as XLA's program does:
    the result keeps the split of the weight's other dimensions, and
    the next product takes it split where its weight splits the same
    letter.  Left partial, the first elementwise op on it scattered it
    on the batch of one, and the next product gathered it back."""
    if isinstance(x, DTensor) and isinstance(w, DTensor):
        ins, out = equation.split("->")
        xs, ws = ins.split(",")
        mesh = w.device_mesh
        # The partial product each rank would reduce, against the
        # weight it would gather.
        product = x.to_local().numel() * math.prod(
            n for c, n in zip(ws, w.shape) if c in out)
        for c in ws:
            if c in xs and c not in out:
                product //= x.to_local().shape[xs.index(c)]
        places, moved = list(w.placements), []
        for m, (p, q, n) in enumerate(zip(w.placements, x.placements,
                                          mesh.shape)):
            if not (n > 1 and p.is_shard() and q.is_shard()
                    and xs[q.dim] not in ws):
                continue
            idle = [a for a, k in enumerate(mesh.shape)
                    if k == n and places[a].is_replicate()
                    and x.placements[a].is_replicate()]
            if (idle and ws[p.dim] in xs and ws[p.dim] not in out
                    and product < w.to_local().numel() * n):
                w = _SwapSplit.apply(w, m, idle[0])
                places = list(w.placements)
                moved.append(idle[0])
            else:
                places[m] = Replicate()
        w = w.redistribute(mesh, places)
        y = contract(equation, x, w)
        # A one-token step: no axis splits what the product keeps of
        # the activations, and the product is smaller than the weight.
        one_token = product < w.to_local().numel() and not any(
            q.is_shard() and n > 1 and xs[q.dim] in out
            for q, n in zip(x.placements, mesh.shape))
        if moved or one_token:
            return y.redistribute(mesh, [
                Replicate() if a in moved or (one_token and p.is_partial())
                else p for a, p in enumerate(y.placements)])
        return y
    return contract(equation, x, w)


def aligned(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t`, to be combined elementwise with `like` (of `t`'s rank).  On
    plain tensors it is `t`.  Over DTensors, where `t` splits a dimension
    on one mesh axis and `like` splits it on another of the same size,
    each whole where the other splits, `t`'s split moves to `like`'s axis
    (`_SwapSplit`, one permutation of the shards, as XLA's
    collective-permute) instead of either being gathered."""
    if not (isinstance(t, DTensor) and isinstance(like, DTensor)):
        return t
    shape = t.device_mesh.shape
    for a in range(len(shape)):
        for b in range(len(shape)):
            p, q = t.placements[a], like.placements[b]
            if (a != b and shape[a] == shape[b] > 1 and p.is_shard()
                    and p == q and t.placements[b].is_replicate()
                    and like.placements[a].is_replicate()):
                t = _SwapSplit.apply(t, a, b)
    return t


def partial_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t`, to be added to `like`.  On plain tensors it is `t`.  Over
    DTensors, on each mesh axis where `like` is a partial sum and `t` is
    whole, `t` is made a partial sum too (each rank keeps its share,
    which moves nothing), so that their sum stays a partial sum, reduced
    once where it is next placed, as GSPMD adds partial sums; not `like`
    all-reduced for the sum, which torch 2.11's strategy for `add`
    chooses (torch 2.13's chooses this)."""
    if not (isinstance(t, DTensor) and isinstance(like, DTensor)):
        return t
    axes = [a for a, (p, q) in enumerate(zip(t.placements, like.placements))
            if p.is_replicate() and q.is_partial() and q.reduce_op == "sum"]
    return _AsPartial.apply(t, axes) if axes else t


def cut_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t`, to be multiplied elementwise by `like` (of `t`'s trailing
    dimensions, as broadcasting aligns them).  On plain tensors it is
    `t`.  Over DTensors, on each mesh axis where `t` is whole and `like`
    splits a dimension, `t` is cut to that split (each rank keeps its
    slice, which moves nothing), as GSPMD places the product and torch
    2.13's strategy for it does; torch 2.11's gathers `like` instead.
    The gradient is left as it comes, as for a cut DTensor makes inside
    an op."""
    if not (isinstance(t, DTensor) and isinstance(like, DTensor)):
        return t
    lead = t.ndim - like.ndim
    places = [Shard(q.dim + lead) if p.is_replicate() and q.is_shard()
              and n > 1 else p for p, q, n in zip(
                  t.placements, like.placements, t.device_mesh.shape)]
    return _Cut.apply(t, places) if places != list(t.placements) else t


class _Cut(torch.autograd.Function):
    """A DTensor redistributed from whole to split on some mesh axes (a
    slice on each rank); its gradient passes as it comes."""

    @staticmethod
    def forward(ctx, t, places):
        return t.redistribute(t.device_mesh, places)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AsPartial(torch.autograd.Function):
    """A DTensor whole on the mesh axes `axes` made a partial sum there:
    each rank keeps its share, the local tensor over the axes' size (a
    power of two on a production mesh: exact).  The gradient, the
    output's, takes the input's placements."""

    @staticmethod
    def forward(ctx, t, axes):
        ctx.placements = t.placements
        mesh = t.device_mesh
        local = t.to_local() / math.prod(mesh.shape[a] for a in axes)
        return DTensor.from_local(
            local, mesh, [Partial() if a in axes else p
                          for a, p in enumerate(t.placements)],
            run_check=False, shape=t.shape, stride=t.stride())

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


class _SwapSplit(torch.autograd.Function):
    """A DTensor whose split on mesh axis `a` moves to axis `b`, of the
    same size, where it is whole: each rank's shard goes to the rank
    whose coordinates on the two axes are swapped, one permutation over
    the mesh's ranks.  The gradient goes back the same way."""

    @staticmethod
    def forward(ctx, t, a, b):
        ctx.axes, ctx.placements = (a, b), t.placements
        return _swapped(t, a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.axes
        moved = list(ctx.placements)
        moved[a], moved[b] = moved[b], moved[a]
        grad = grad.redistribute(grad.device_mesh, moved)
        return _swapped(grad, b, a), None, None


def _swapped(t: DTensor, a: int, b: int) -> DTensor:
    from torch.distributed import _functional_collectives as funcol

    mesh = t.device_mesh
    ranks = mesh.mesh
    dst = dict(zip(ranks.flatten().tolist(),
                   ranks.transpose(a, b).flatten().tolist()))
    local = t.to_local()
    # `permute_tensor` sends each rank's whole tensor, flattened.
    moved = funcol.permute_tensor(local.reshape(-1),
                                  [dst[r] for r in range(len(dst))],
                                  torch.distributed.group.WORLD)
    if hasattr(moved, "wait"):
        moved = moved.wait()
    moved = moved.view(local.shape)
    places = list(t.placements)
    places[a], places[b] = places[b], places[a]
    return DTensor.from_local(moved, mesh, places, run_check=False,
                              shape=t.shape, stride=t.stride())


def token_positions(tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
    """(B, S) positions start .. start + S - 1 on every row of `tokens`
    (B, S, ...), one arange expanded.  For a DTensor the arange is this
    rank's rows, split as the tokens' rows are."""
    b, s = tokens.shape[:2]
    if not isinstance(tokens, DTensor):
        return torch.arange(start, start + s, device=tokens.device)[None] \
            .expand(b, s)
    local = tokens.to_local()
    steps = torch.arange(start, start + s, device=local.device)[None] \
        .expand(local.shape[0], s)
    return DTensor.from_local(
        steps, tokens.device_mesh,
        [p if p.is_shard() and p.dim == 0 else Replicate()
         for p in tokens.placements],
        run_check=False, shape=(b, s), stride=steps.stride())


def batched(factory: Callable, like: torch.Tensor, shape: Sequence[int],
            *args, **kwargs) -> torch.Tensor:
    """`factory(shape, *args, **kwargs)` on `like`'s device (a mask or a
    state made whole, such as `torch.zeros`).  For a DTensor `like` it
    is split as `like`'s batch (dimension 0) is: each rank makes its own
    rows only."""
    if not isinstance(like, DTensor):
        return factory(shape, *args, **kwargs, device=like.device)
    mesh = like.device_mesh
    places = [p if p.is_shard() and p.dim == 0 else Replicate()
              for p in like.placements]
    local = factory(compute_local_shape_and_global_offset(
        shape, mesh, places)[0], *args, **kwargs,
        device=like.to_local().device)
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=tuple(shape),
                              stride=contiguous_stride(*shape))


def slot_positions(cache: torch.Tensor) -> torch.Tensor:
    """(B, S) positions 0 .. S - 1 of a cache leaf's S slots (B, S, ...)
    on every row, one arange expanded.  For a DTensor they are split as
    the leaf's rows and slots are."""
    b, s = cache.shape[:2]
    if not isinstance(cache, DTensor):
        return torch.arange(s, device=cache.device)[None].expand(b, s)
    mesh = cache.device_mesh
    places = [p if p.is_shard() and p.dim in (0, 1) else Replicate()
              for p in cache.placements]
    (rows, n), offset = compute_local_shape_and_global_offset(
        (b, s), mesh, places)
    steps = torch.arange(offset[1], offset[1] + n,
                         device=cache.to_local().device)[None].expand(rows, n)
    return DTensor.from_local(steps, mesh, places, run_check=False,
                              shape=(b, s), stride=steps.stride())


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]`: the rows of an embedding table.  A DTensor table
    larger than the lookup's result keeps its split columns, as GSPMD
    keeps a gather's operand split on a dimension the gather passes
    through: each rank looks up every id on its own columns (the ids
    gathered over those axes, not the table), and the result, split on
    its last dimension there, takes the ids' placements (an all-to-all
    of the result, or its gather).  A smaller table is gathered over every
    axis but the one that splits its rows (as FSDP gathers a weight
    before use).  Where its rows are split, each rank looks up the ids
    its rows hold (zeros for the others) and the lookups are summed over
    the rows' axes, one all-reduce of the result: no rank holds the
    whole table."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    if table.numel() <= ids.numel() * table.shape[1]:
        table = table.redistribute(mesh, [
            Replicate() if p.is_shard() and p.dim != 0 else p
            for p in table.placements])
    if not is_split(table, 0) and not is_split(table, 1):
        return table[ids]
    ids_p = [Replicate() if t.is_shard() else p
             for t, p in zip(table.placements, ids.placements)]
    out_p = [Shard(ids.ndim) if t.is_shard() and t.dim == 1 else p
             for t, p in zip(table.placements, ids_p)]
    ids_l = ids.redistribute(mesh, ids_p).to_local()
    local = table.to_local()
    at = ids_l - compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)[1][0]
    inside = (at >= 0) & (at < local.shape[0])
    rows = F.embedding(at.clamp(0, local.shape[0] - 1), local)
    rows = reduce_over(torch.where(inside[..., None], rows, 0), table, 0)
    shape = (*ids.shape, table.shape[1])
    rows = DTensor.from_local(rows, mesh, out_p, run_check=False,
                              shape=shape, stride=contiguous_stride(*shape))
    if out_p == ids_p:
        return rows
    return rows.redistribute(mesh, ids.placements)


def contiguous_stride(*shape: int) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape`."""
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


def write_rows_(dst: torch.Tensor, slots: torch.Tensor,
                values: torch.Tensor) -> None:
    """`dst[b, slots[b]] = values[b]` for every row b of `dst`, in place:
    one cache slot a row.  A DTensor is written on this rank's shard."""
    if isinstance(dst, DTensor):
        _write_shard_(dst, slots, values, per_row=True)
    else:
        rows = torch.arange(dst.shape[0], device=dst.device)
        dst.index_put_((rows, slots), values)


def write_columns_(dst: torch.Tensor, slots, values: torch.Tensor) -> None:
    """`dst[:, slots] = values`, in place: the same cache slots (a tensor
    or a slice) in every row.  A DTensor is written on this rank's
    shard."""
    if isinstance(dst, DTensor):
        _write_shard_(dst, slots, values, per_row=False)
    else:
        dst[:, slots] = values


def _as_shard(t, dst: DTensor, dims, shape, offset) -> torch.Tensor:
    """The part of `t` that goes with this rank's shard of `dst`, as a
    local tensor: `dims[d]` is `t`'s dimension for `dst`'s dimension d
    (None where `t` has none, and for the slot dimension, which `t`
    keeps whole); `shape` and `offset` are the shard's."""
    if isinstance(t, DTensor):
        want = [Shard(dims[p.dim])
                if p.is_shard() and dims[p.dim] is not None
                else Replicate() for p in dst.placements]
        return t.redistribute(dst.device_mesh, want).to_local()
    for d, td in enumerate(dims):
        if td is not None and shape[d] != dst.shape[d]:
            t = t.narrow(td, offset[d], shape[d])
    return t


def _write_shard_(dst: DTensor, slots, values, *, per_row: bool) -> None:
    """`write_rows_` / `write_columns_` on this rank's shard of `dst`:
    the rows it holds take their values.  Where the slot dimension is
    whole on the rank, that is the plain write on the local tensors.
    Where it is split, a slot outside this rank's part is left as it is
    (the rank that holds it writes it): the slot indices are clamped
    into the shard and the write masked, so no index leaves it."""
    local = dst.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, dst.device_mesh, dst.placements)
    n_rows, n_slots = local.shape[:2]
    # values' dimension for each of dst's: one slot a row drops dim 1.
    dims = [0, None] + [d - 1 if per_row else d
                        for d in range(2, dst.ndim)]
    vals = _as_shard(values, dst, dims, shape, offset)
    if isinstance(slots, slice):
        if not is_split(dst, 1):
            local[:, slots] = vals
            return
        slots = torch.arange(slots.start or 0, slots.stop,
                             device=local.device)
    if per_row:
        at = _as_shard(slots, dst, [0] + [None] * (dst.ndim - 1), shape,
                       offset)
        r = torch.arange(n_rows, device=local.device)
        if not is_split(dst, 1):
            local.index_put_((r, at), vals)
            return
        at = at.long() - offset[1]
        inside = (at >= 0) & (at < n_slots)
        at = at.clamp(0, n_slots - 1)
        keep = inside.view(n_rows, *[1] * (vals.ndim - 1))
        local[r, at] = torch.where(keep, vals, local[r, at])
        return
    if not is_split(dst, 1):
        local[:, slots] = vals
        return
    # The same slots for every row: each slot of the shard takes the
    # last value written to it (the highest index, as a sequential
    # write leaves it), or keeps its own.
    at = slots.long() - offset[1]
    inside = (at >= 0) & (at < n_slots)
    at = at.clamp(0, n_slots - 1)
    ids = torch.arange(at.shape[0], device=local.device)
    owner = torch.full((n_slots,), -1, dtype=torch.long,
                       device=local.device).scatter_reduce_(
        0, at, torch.where(inside, ids, -1), "amax")
    hit = (owner >= 0).view(1, n_slots, *[1] * (local.ndim - 2))
    local.copy_(torch.where(hit, vals.index_select(1, owner.clamp(min=0)),
                            local))


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: Pytree,
             is_leaf: Callable[[Any], bool] = lambda x: False) -> Pytree:
    """Map `fn` over the leaves of a nested dict/list/tuple/NamedTuple,
    calling it in `tree_leaves` order (dict keys sorted); dicts keep their
    key order."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        done = {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_unflatten(tree: Pytree, leaves: Sequence) -> Pytree:
    """`tree`'s structure with `leaves` (in `tree_leaves` order) in place
    of its own."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_leaves(tree: Pytree,
                is_leaf: Callable[[Any], bool] = lambda x: False) -> list:
    """Leaves in the reference's order: dict keys sorted, lists in order."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v, is_leaf)]
    return [tree]


def first_tensor(tree) -> torch.Tensor:
    """The first tensor of a tree, in `tree_leaves` order."""
    return next(t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def tree_index(tree: Pytree, i: int) -> Pytree:
    """Slice `i` of every tensor of a stacked tree (views); other leaves
    are kept."""
    return tree_map(lambda t: t[i] if isinstance(t, torch.Tensor) else t,
                    tree)


def tree_unbind(stack: Pytree) -> list:
    """The per-layer trees of a stacked tree, as views: each leaf is
    unbound once, so a backward pass stacks the layers' gradients into
    the stacked leaf in one step.  Each layer's tree goes through
    `placed_grads`."""
    leaves = tree_leaves(stack)
    parts = [torch.unbind(t) for t in leaves]
    return [placed_grads(tree_unflatten(stack, [p[i] for p in parts]))
            for i in range(leaves[0].shape[0])]


class _PlacedGrad(torch.autograd.Function):
    """The identity on a DTensor, whose gradient takes its placements."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and grad.placements != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def placed_grads(tree: Pytree) -> Pytree:
    """A layer's parameters, as they are.  Where autograd records, each
    DTensor leaf's gradient takes the leaf's placements as soon as the
    layer's backward has made it: a partial sum over the batch's axes is
    reduce-scattered onto the weight's split once a layer, as XLA's
    scanned backward does, not held whole on every rank until the
    update.  Plain tensors, and any leaf outside autograd, are returned
    as they are."""
    if not torch.is_grad_enabled():
        return tree
    return tree_map(lambda t: _PlacedGrad.apply(t)
                    if isinstance(t, DTensor) and t.requires_grad else t,
                    tree)


# ---------------------------------------------------------------------------
# Rematerialization (the reference's jax.checkpoint sites)
# ---------------------------------------------------------------------------


def _is_unbatched_product(op, args) -> bool:
    """An un-batched matrix product: `mm`/`addmm`, or the batch-1 `bmm`
    that `torch.einsum` lowers a product without batch dimensions to."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return True
    return op is torch.ops.aten.bmm.default and args[0].shape[0] == 1


def _dots_policy(ctx, op, *args, **kwargs):
    # jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    if _is_unbatched_product(op, args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, policy: str) -> Callable:
    """`fn` under the reference's remat policy `policy`, while autograd
    records: "none" runs it as it is; "save_boundaries" and "full" (both
    `nothing_saveable` in the reference) keep only its inputs and
    recompute the rest in the backward pass; "dots" keeps the outputs of
    the un-batched matrix products as well.  Values never change."""
    if policy == "none":
        return fn
    if policy in ("save_boundaries", "full"):
        context = None
    elif policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)
    else:
        raise ValueError(f"unknown remat policy {policy!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if context is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context)
    return wrapped


# While the dry run traces a step (`launch.dryrun.trace_step`): the loop
# that runs a scan's trips and counts the rest, `scan`'s signature.
_counted_scan: Optional[Callable] = None


@contextlib.contextmanager
def counting_scans(loop: Callable):
    """While active, `scan` hands its trips to `loop(step, carry, xs)`."""
    global _counted_scan
    kept, _counted_scan = _counted_scan, loop
    try:
        yield
    finally:
        _counted_scan = kept


def scan(step: Callable, carry: torch.Tensor, xs: Sequence[torch.Tensor]
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `jax.lax.scan(jax.checkpoint(step), carry, xs)`
    over dimension 1 of `xs` (the chunks of a chunked recurrence):
    `step(carry, *x_i)` returns (carry, y_i) for the slices `x[:, i]`,
    each trip under `remat(step, "full")`.  Returns the last carry and
    the y_i stacked on dimension 1.  A Python loop over the trips; while
    the dry run traces a step (`counting_scans`), its loop instead, which
    runs a few trips and counts the others by their increment."""
    step = remat(step, "full")
    if _counted_scan is not None:
        return _counted_scan(step, carry, xs)
    ys = []
    for i in range(xs[0].shape[1]):
        carry, y = step(carry, *(x[:, i] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _to_tensor(leaf, device: torch.device, dtype) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bf16: via float32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))    # owned, writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Pytree, *, device=None,
                      dtype: Optional[torch.dtype] = None) -> Pytree:
    """Carry a tree of arrays (NumPy, or anything `np.asarray` takes, such
    as the reference's parameters) into tensors on `device` (the card
    unless the caller names the CPU).  `dtype` casts the floating leaves;
    integer leaves keep theirs."""
    dev = resolve_device(device)
    return tree_map(lambda leaf: _to_tensor(leaf, dev, dtype), tree)


def params_to_numpy(tree: Pytree) -> Pytree:
    """The inverse of `params_from_numpy`: tensors become NumPy arrays on
    the host (bf16 as float32), each a copy; other leaves are returned as
    they are."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.numpy())      # a copy: caches change in place
    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def init_std(spec: ParamSpec) -> float:
    """Standard deviation of a random leaf (0 for zeros/ones): 1/sqrt(d)
    for `embed`, fan-in scaled otherwise (`small`: fan-in over all but
    the last axis)."""
    if spec.init in ("zeros", "ones"):
        return 0.0
    if spec.init == "embed":
        # 1/sqrt(d_model): unit-variance activations after the sqrt(d)
        # embed_scale, and O(1) logits under tied embeddings.
        return spec.scale / math.sqrt(spec.shape[-1])
    fan_in = spec.shape[0] if len(spec.shape) >= 1 else 1
    if len(spec.shape) >= 2:
        fan_in = math.prod(spec.shape[:-1]) if spec.init == "small" \
            else spec.shape[0]
    return spec.scale / math.sqrt(max(1, fan_in))


def _init_leaf(generator: torch.Generator, spec: ParamSpec, dtype,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * init_std(spec)).to(device=device, dtype=dtype)


def init_params(generator: torch.Generator, specs: Pytree,
                dtype: torch.dtype = torch.bfloat16, device=None) -> Pytree:
    """Random parameters with the reference's distributions, drawn from
    `generator` leaf by leaf in the reference's leaf order, on `device`
    (the card unless the caller names the CPU).  The values differ from
    the reference's (another generator); carry those across with
    `params_from_numpy` to compute the same thing."""
    dev = resolve_device(device)
    return tree_map(lambda s: _init_leaf(generator, s, dtype, dev), specs,
                    is_leaf=_is_spec)


def param_axes(specs: Pytree) -> Pytree:
    return tree_map(lambda s: s.axes, specs, is_leaf=_is_spec)


def param_shapes(specs: Pytree, dtype=torch.bfloat16) -> Pytree:
    """Meta tensors of each leaf's shape and dtype (no storage)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"),
                    specs, is_leaf=_is_spec)


def param_count(specs: Pytree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs, _is_spec))


def param_sharding(specs: Pytree, rules: Mapping[str, Any]) -> Pytree:
    return tree_map(lambda s: resolve(rules, s.axes), specs,
                    is_leaf=_is_spec)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.float()
    if plus_one:
        s = s + 1.0
    return (y * s).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], *, eps: float = 1e-5,
               plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    s = scale.float()
    if plus_one:
        s = s + 1.0     # nemotron "layernorm1p"
    y = y * s
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def apply_norm(x, p, kind: str):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p.get("bias"))
    if kind == "layernorm1p":
        return layer_norm(x, p["scale"], p.get("bias"), plus_one=True)
    raise ValueError(f"unknown norm {kind!r}")


def norm_spec(d: int, kind: str) -> Dict[str, ParamSpec]:
    if kind == "rms":
        return {"scale": ParamSpec((d,), ("act_embed",), "ones")}
    if kind in ("layernorm", "layernorm1p"):
        init = "zeros" if kind == "layernorm1p" else "ones"
        return {"scale": ParamSpec((d,), ("act_embed",), init),
                "bias": ParamSpec((d,), ("act_embed",), "zeros")}
    raise ValueError(kind)


# `gelu` is the tanh approximation, as the reference's
# jax.nn.gelu(approximate=True); torch's default is the exact erf form.
ACTIVATIONS: Dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
    "relu": F.relu,
}


def stack_specs(spec: Pytree, n: int) -> Pytree:
    """Prepend a `layers` axis to every ParamSpec (stacked layers)."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                            s.scale),
        spec, is_leaf=_is_spec)
