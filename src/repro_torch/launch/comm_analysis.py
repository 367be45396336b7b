"""Collective-byte and remat accounting for the roofline.

The port's counterpart of the reference's `launch/hlo_analysis.py`.  The
reference parses the partitioned HLO of a compiled step and sums the
result-shape bytes of every collective op; the port compiles no HLO, so
this module derives the same dict from what the dry run knows: each
parameter's and cache leaf's partition spec on the mesh.

`collective_bytes` counts, per device, the result bytes of the
collectives the DTensor placements imply (the reference's convention: result
shape, not ring traffic):

  all-gather      every parameter split over a data axis (FSDP) is
                  gathered to its model-axis shard in the compute dtype,
                  once per pass (per microbatch in training, once in a
                  serving step);
  reduce-scatter  training: each such parameter's gradient, reduced back
                  to its shard once per microbatch;
  all-reduce      training: the gradient of a parameter replicated over
                  the data axes, when there is more than one data shard;
                  decode: the residual-stream combine of every
                  row-parallel weight (its input dimension split over a
                  model axis: one new token's output row per sequence,
                  per layer), and, for an attention cache whose
                  sequence is split and which is scored whole (no
                  longer than `kv_chunk`), the partial-softmax combine
                  of its value-side leaf (one new token's row, in
                  float32, per layer; k and v share it);
  all-gather      decode, too: an attention cache whose sequence is
                  split and which is scored in chunks (longer than
                  `kv_chunk`, which divides it) is cast to float32 and
                  gathered whole over its sequence once a layer, k and v
                  each, at the device's batch, before the chunk loop.

That is what the reference's partitioned HLO holds for these cells
(`hlo_analysis.collective_bytes`): XLA combines a cache it scores whole
and gathers one it scans in chunks, hoisted out of the scan.  No
all-to-all is counted here, as the placements of the parameters and
the cache do not give one: XLA's moves of activations between split
dimensions (the MoE dispatch's, MLA's chunked decode, which moves its
expanded keys and values from the sequence to the heads where the
port gathers the latent) are in the partitioned trace's
"collectives_traced" instead, where the port makes them.

The dict keeps the reference's schema: bytes per op kind, "total", and
"<op>_count".  `remat_duplication` is the ratio of matrix products
dispatched in a traced step under the arch's remat policy to those
under "none": 1.0 when nothing is recomputed (the reference counts
duplicate fusion names in the HLO instead).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, Mapping, Optional

from torch.distributed.tensor import Replicate

from repro_torch.launch.mesh import (data_axes, dp_degree, local_shape,
                                     placements)
from repro_torch.models.common import ParamSpec, resolve, tree_leaves

# Matrix products as the dispatcher sees them (`torch.einsum` lowers to
# bmm; `nn.Linear`-style calls to mm/addmm).
MATMUL_OPS = frozenset({"aten::mm", "aten::bmm", "aten::addmm",
                        "aten::baddbmm"})

# The step's compute dtype (bf16) and the partial results' (float32).
COMPUTE_BYTES, PARTIAL_BYTES = 2, 4

# Attention cache leaves by their rank unstacked: the value-side leaf of
# each cache carries the combine (k and v share it); the key and value
# leaves are gathered for a chunked decode (MLA's latent cache is not).
_COMBINE_KEYS = {"v": 4, "c_kv": 3, "self_v": 4}
_GATHER_KEYS = {"k": 4, "v": 4, "self_k": 4, "self_v": 4}


def _input_dim(axes) -> Optional[int]:
    """The contracted dimension of a weight: its first logical axis that
    is not the stacked-layers or the experts axis (weights are laid out
    input first)."""
    for d, ax in enumerate(axes):
        if ax not in ("layers", "experts"):
            return d
    return None


def collective_bytes(kind: str, param_specs, rules: Mapping[str, Any], mesh,
                     *, tokens: int, n_micro: int = 1, cache=None,
                     cache_shardings=None,
                     kv_chunk: Optional[int] = None) -> Dict[str, float]:
    """Per-device result bytes of each collective kind one step implies.

    `param_specs` is the model's ParamSpec tree and `rules` the cell's
    logical-axis rules; `tokens` the tokens one device processes per pass
    (decode: its sequences); `cache`/`cache_shardings` the decode cache
    (meta tensors) and its shardings; `kv_chunk` the chunk its decode
    attention scans the cache in (None: scored whole).
    """
    out: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    on_data = [n in data_axes(mesh) for n in mesh.mesh_dim_names]
    dp = dp_degree(mesh)
    passes = n_micro if kind == "train" else 1

    def add(op, nbytes, n=1):
        out[op] += float(nbytes) * n
        counts[op] += n

    for ps in tree_leaves(param_specs, lambda x: isinstance(x, ParamSpec)):
        places = placements(mesh, resolve(rules, ps.axes))
        local = math.prod(local_shape(mesh, places, ps.shape))
        fsdp = any(p.is_shard() and d for p, d in zip(places, on_data))
        # The weight as a step uses it: gathered over the data axes.
        gathered = local_shape(mesh, [Replicate() if d else p for p, d
                                      in zip(places, on_data)], ps.shape)
        if fsdp:
            add("all-gather", math.prod(gathered) * COMPUTE_BYTES, passes)
        if kind == "train":
            if fsdp:
                add("reduce-scatter", local * COMPUTE_BYTES, n_micro)
            elif dp > 1:
                add("all-reduce", local * COMPUTE_BYTES, n_micro)
        if kind == "decode":
            d = _input_dim(ps.axes)
            if d is not None and any(p.is_shard() and p.dim == d and not on
                                     for p, on in zip(places, on_data)):
                layers = ps.shape[0] if ps.axes[0] == "layers" else 1
                add("all-reduce", tokens * gathered[-1] * COMPUTE_BYTES,
                    layers)

    if kind == "decode" and cache is not None:
        for key, leaf, sh in _cache_leaves(cache, cache_shardings):
            rank = _GATHER_KEYS.get(key, _COMBINE_KEYS.get(key))
            if rank is None or leaf.ndim not in (rank, rank + 1):
                continue
            seq = 1 + (leaf.ndim - rank)            # (L,) B, S, ...
            if not any(p.is_shard() and p.dim == seq
                       for p in sh.placements()):
                continue
            row = list(sh.shard_shape(leaf.shape))
            layers = row[0] if leaf.ndim == rank + 1 else 1
            row = row[seq - 1:]
            slots = leaf.shape[seq]
            if kv_chunk and slots > kv_chunk and not slots % kv_chunk:
                if key in _GATHER_KEYS:
                    row[1] = slots                  # the sequence whole
                    add("all-gather", math.prod(row) * PARTIAL_BYTES,
                        layers)
            elif key in _COMBINE_KEYS:
                row[1] = 1                          # one new token
                add("all-reduce", math.prod(row) * PARTIAL_BYTES, layers)

    total = dict(out)
    total["total"] = float(sum(out.values()))
    total.update({f"{k}_count": float(v) for k, v in counts.items()})
    return total


def _cache_leaves(cache, shardings, key=None):
    """(innermost dict key, leaf, sharding) of every tensor cache leaf."""
    if isinstance(cache, dict):
        for k in cache:
            yield from _cache_leaves(cache[k], shardings[k], k)
    elif isinstance(cache, (list, tuple)):
        for c, s in zip(cache, shardings):
            yield from _cache_leaves(c, s, key)
    elif hasattr(cache, "ndim"):
        yield key, cache, shardings


def remat_duplication(matmuls: int, matmuls_without_remat: int) -> float:
    """Matrix products dispatched under the remat policy over those
    without remat: 1.0 means no duplicate recompute."""
    if not matmuls_without_remat:
        return 1.0
    return matmuls / matmuls_without_remat
