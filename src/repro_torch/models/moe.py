"""Mixture-of-Experts FFN: top-k routing with capacity-based einsum dispatch.

The reference's GSPMD-style dense dispatch (one-hot combine tensors, no
gather/scatter): tokens are routed to `capacity` slots per expert, in
groups of `GROUP_SIZE` tokens.  Shared experts run densely for every
token and are fused into one wide FFN.  The port keeps the reference's
priority order exactly: top-k ties go to the lower expert index, and the
k-th choices of earlier tokens take capacity first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.common import contract, partial_as


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared: int = 0
    shared_d_ff: int = 0            # total width of the fused shared FFN
    capacity_factor: float = 1.25
    normalize_weights: bool = True  # renormalize top-k gates to sum to 1
    routed_scale: float = 1.0
    expert_sharding: str = "ep"     # "ep" | "tp"
    aux_loss_coef: float = 0.001

    @property
    def padded_experts(self) -> int:
        return self.num_experts


def capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts)
    return max(cap, cfg.top_k, 1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot; an index outside [0, n) gives a zero row, as
    jax.nn.one_hot does (torch's F.one_hot raises instead)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with ties broken toward the lower index
    (jax.lax.top_k's order; torch.topk promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with capacity.

    logits: (..., T, E), the leading dimensions routing groups, each
    routed alone (the reference's `jax.vmap(route)` over its groups).
    Returns (dispatch (..., T, E, C) {0,1} float, combine (..., T, E, C)
    float, aux_loss (...)).  `moe_ffn` makes the two from their factors
    in its compute dtype (`route_factors`).
    """
    kept, gated, slots, aux = route_factors(logits, cfg, torch.float32)
    return spread(kept, slots), spread(gated, slots), aux


def route_factors(logits: torch.Tensor, cfg: MoEConfig, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """`route`'s dispatch and combine as factors, each of which `spread`
    makes whole: (kept (..., T, K, E) {0,1}, gated (..., T, K, E) gate
    weights, slots (..., T, K, C) {0,1}, all three in `dtype`, aux_loss
    (...) float32).

    Each (..., T, E, C) tensor is made in `dtype` directly: a token's
    top-k experts are distinct, so at most one k contributes to each
    (t, e, c), and the product is one term rounded once, the float32
    result cast to `dtype` bit for bit, with no float32 (..., T, E, C)
    tensor made.
    """
    t = logits.shape[-2]
    e = cfg.num_experts
    k = cfg.top_k
    c = capacity(t, cfg)
    groups = logits.shape[:-2]
    probs = torch.softmax(logits.float(), dim=-1)

    gate_vals, gate_idx = _top_k(probs, k)                     # (.., T, K)
    if cfg.normalize_weights:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    gate_vals = gate_vals * cfg.routed_scale

    # Position of each (token, k) assignment in its expert's buffer.
    onehot = _one_hot(gate_idx, e)                             # (.., T, K, E)
    # Priority: k-th choice of earlier tokens first (standard GSPMD order).
    flat = onehot.transpose(-3, -2).reshape(*groups, k * t, e)
    pos_flat = torch.cumsum(flat, dim=-2) - flat               # slots used
    pos = pos_flat.reshape(*groups, k, t, e).transpose(-3, -2)
    within_cap = (pos < c) & (onehot > 0)

    slots = _one_hot((pos * onehot).sum(-1).to(torch.int64), c).to(dtype)
    keep = within_cap.any(-1)                                  # (.., T, K)
    kept = (onehot * keep[..., None]).to(dtype)
    gated = (onehot * (gate_vals * keep)[..., None]).to(dtype)

    # Load-balancing auxiliary loss (Switch/GShard form).
    me = probs.mean(-2)                                        # (.., E)
    ce = onehot.sum(-2).mean(-2)                               # frac routed
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce, dim=-1)
    return kept, gated, slots, aux


def spread(a: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """A routing tensor (..., T, E, C) from its factors: `a` (..., T, K,
    E) over the capacity slots `slots` (..., T, K, C)."""
    return torch.einsum("...tke,...tkc->...tec", a, slots)


def _expert_ffn(xe: torch.Tensor, p: Dict, act) -> torch.Tensor:
    """xe: (E, C', d_model) -> (E, C', d_model); gated (SwiGLU-style)."""
    h_g = contract("ecd,edf->ecf", xe, p["w_gate"])
    h_u = contract("ecd,edf->ecf", xe, p["w_up"])
    h = act(h_g) * h_u
    return contract("ecf,efd->ecd", h, p["w_down"])


def _experts_input(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The experts' input `xe` (E, G, C, D): where the dispatch
    contracted split tokens it is a partial sum, reduced here once, as
    XLA's program reduces it: scattered onto D over the mesh axes that
    split the experts' weights `w` (E, D, F) on theirs (FSDP), so the
    expert products keep those weights split, and all-reduced over the
    other axes.  Not a partial sum each product reduces again, nor one
    the backward gathers.  A plain tensor as it is."""
    if not isinstance(xe, DTensor):
        return xe
    return xe.redistribute(xe.device_mesh, [
        p if not p.is_partial() else
        Shard(3) if q.is_shard() and q.dim == 1 else Replicate()
        for p, q in zip(xe.placements, w.placements)])


class _SplitOnExperts(torch.autograd.Function):
    """The routing weights `w` (..., T, E, C) split on E over the mesh
    axes that split the experts' output `ye` (E, ...) and that hold `w`
    whole: each rank takes its experts' part.  The gradient stays split
    as GSPMD keeps it (the routing's backward reduces over E where it
    sums), not gathered back onto the whole weights."""

    @staticmethod
    def forward(ctx, w, ye):
        return w.redistribute(w.device_mesh, [
            Shard(w.ndim - 2) if q.is_shard() and q.dim == 0
            and p.is_replicate() else p
            for p, q in zip(w.placements, ye.placements)])

    @staticmethod
    def backward(ctx, grad):
        return grad, None


GROUP_SIZE = 2048


def moe_ffn(x: torch.Tensor, p: Dict, cfg: MoEConfig, act,
            group_size: int = GROUP_SIZE
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (out, aux_loss).

    Tokens are routed in groups of `group_size` (GShard-style): capacity,
    and with it the (tokens, E, C) dispatch tensors, scales with the
    group, not the full batch.
    """
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    gs = min(group_size, t)
    if t % gs:
        gs = t          # fall back to one group for odd tiny batches
    g = t // gs
    xg = xt.reshape(g, gs, d)
    logits = torch.einsum("gtd,de->gte", xg, p["router"])
    # (g, gs, E, C) one-hots in compute dtype: values are {0,1} / gate
    # weights, bf16 is exact for the former and ample for the latter.
    # Each is made from its factors where it is used, so a serving step
    # holds one at a time: the dispatch is freed before the experts run
    # and the combine made after them, when the experts' input (and the
    # product's own layout, which the reshape copies) is freed too.
    kept, gated, slots, aux = route_factors(logits, cfg, x.dtype)
    aux = aux.mean()
    xe = _experts_input(contract("gtec,gtd->egcd", spread(kept, slots), xg),
                        p["w_gate"])
    e, _, c, _ = xe.shape
    xe = xe.reshape(e, g * c, d)
    ye = _expert_ffn(xe, p, act).reshape(e, g, c, d)
    del xe
    combine = spread(gated, slots)
    if isinstance(ye, DTensor):
        combine = _SplitOnExperts.apply(combine, ye)
    out = contract("egcd,gtec->gtd", ye, combine).reshape(t, d)

    if cfg.num_shared:
        hg = torch.einsum("td,df->tf", xt, p["shared_gate"])
        hu = torch.einsum("td,df->tf", xt, p["shared_up"])
        shared = torch.einsum("tf,fd->td", act(hg) * hu, p["shared_down"])
        out = partial_as(out, shared) + shared
    return out.reshape(b, s, d), aux
