"""Shared model substrate: parameter specs, logical-axis rules, norms, and
the carrier that moves a parameter tree between NumPy and torch.

Sharding follows the reference's MaxText convention: every parameter and
activation is annotated with *logical* axis names, and a per-run rules
table maps them to mesh axes ("pod", "data", "model").  The port keeps
the table, `resolve` and `logical_constraint` with the reference's
signatures.  The dry run reads the parameters' specs as placements on a
device mesh (`launch/mesh.py`, `launch/train.state_shardings`); the
eager single-card steps apply none: `logical_constraint` returns its
input unchanged.

A parameter tree is a nested dict/list of tensors with the reference's
keys; the models are plain functions over it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device

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
    unknown name raises, as in the reference) and `x` is returned
    unchanged: the eager single-card steps apply no placement."""
    resolve(rules, axes)
    return x


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
    the stacked leaf in one step."""
    leaves = tree_leaves(stack)
    parts = [torch.unbind(t) for t in leaves]
    return [tree_unflatten(stack, [p[i] for p in parts])
            for i in range(leaves[0].shape[0])]


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
