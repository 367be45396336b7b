"""Gradient compression with error feedback (distributed-optimization trick).

int8 block-quantized gradients cut cross-pod all-reduce bytes 4x (bf16->i8
wire format).  Error feedback accumulates the quantization residual locally
and re-adds it next step, preserving convergence (Karimireddy et al., 2019).

The reference sums over a mesh axis inside shard_map (`psum`); the port
sums over a `torch.distributed` process group (`all_reduce`), which must
be initialised: without one `compressed_psum` raises rather than skip the
reduction.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

Pytree = Any
BLOCK = 256


class ErrorFeedback(NamedTuple):
    residual: Pytree


def init_error_feedback(params: Pytree) -> ErrorFeedback:
    return ErrorFeedback(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of a flat fp32 array."""
    n = x.numel()
    pad = (-n) % BLOCK
    xf = F.pad(x.reshape(-1), (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(xf), dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    # torch.round rounds half to even, as jnp.round does.
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    xf = q.float() * scale
    n = 1
    for s in shape:
        n *= s
    return xf.reshape(-1)[:n].reshape(shape)


def compress_decompress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-trip a gradient leaf; returns (lossy value, residual)."""
    q, scale = _quantize(g.float())
    deq = _dequantize(q, scale, g.shape)
    return deq, g.float() - deq


def compressed_psum(grads: Pytree, group=None,
                    ef: Optional[ErrorFeedback] = None
                    ) -> Tuple[Pytree, Optional[ErrorFeedback]]:
    """Sum of int8-quantized gradients over the ranks of `group` (the
    default group when None), with error feedback: quantize (+ stored
    residual), all-reduce the dequantized values, keep the new residual
    locally."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("compressed_psum needs an initialised "
                           "torch.distributed process group")

    def one(g, r):
        g = g.float() + (r if r is not None else 0.0)
        deq, resid = compress_decompress(g)
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        return deq, resid

    flat_g = tree_leaves(grads)
    flat_r = (tree_leaves(ef.residual) if ef is not None
              else [None] * len(flat_g))
    pairs = [one(g, r) for g, r in zip(flat_g, flat_r)]
    summed = tree_unflatten(grads, [p[0] for p in pairs])
    if ef is None:
        return summed, None
    return summed, ErrorFeedback(tree_unflatten(grads,
                                                [p[1] for p in pairs]))


def wire_bytes_saved(params: Pytree) -> Tuple[int, int]:
    """(bf16 wire bytes, int8+scale wire bytes) for one all-reduce."""
    n = sum(p.numel() for p in tree_leaves(params))
    bf16 = 2 * n
    i8 = n + 4 * ((n + BLOCK - 1) // BLOCK)
    return bf16, i8
