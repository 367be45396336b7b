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

    logits: (T, E).  Returns (dispatch (T, E, C) {0,1} float,
    combine (T, E, C) float, aux_loss scalar).
    """
    t = logits.shape[0]
    e = cfg.num_experts
    c = capacity(t, cfg)
    probs = torch.softmax(logits.float(), dim=-1)

    gate_vals, gate_idx = _top_k(probs, cfg.top_k)             # (T, K)
    if cfg.normalize_weights:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    gate_vals = gate_vals * cfg.routed_scale

    # Position of each (token, k) assignment in its expert's buffer.
    onehot = _one_hot(gate_idx, e)                              # (T, K, E)
    # Priority: k-th choice of earlier tokens first (standard GSPMD order).
    flat = onehot.transpose(0, 1).reshape(cfg.top_k * t, e)     # (K*T, E)
    pos_flat = torch.cumsum(flat, dim=0) - flat                 # slots used
    pos = pos_flat.reshape(cfg.top_k, t, e).transpose(0, 1)     # (T, K, E)
    within_cap = (pos < c) & (onehot > 0)

    slot_onehot = _one_hot((pos * onehot).sum(-1).to(torch.int64), c)
    keep = within_cap.any(-1)                                   # (T, K)
    dispatch = torch.einsum("tke,tkc->tec", onehot * keep[..., None],
                            slot_onehot)
    combine = torch.einsum("tke,tkc->tec",
                           onehot * (gate_vals * keep)[..., None],
                           slot_onehot)

    # Load-balancing auxiliary loss (Switch/GShard form).
    me = probs.mean(0)                                          # (E,)
    ce = onehot.sum(1).mean(0)                                  # frac routed
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce)
    return dispatch, combine, aux


def _expert_ffn(xe: torch.Tensor, p: Dict, act) -> torch.Tensor:
    """xe: (E, C', d_model) -> (E, C', d_model); gated (SwiGLU-style)."""
    h_g = torch.einsum("ecd,edf->ecf", xe, p["w_gate"])
    h_u = torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    h = act(h_g) * h_u
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


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
    routed = [route(lg, cfg) for lg in logits]
    dispatch = torch.stack([r[0] for r in routed])
    combine = torch.stack([r[1] for r in routed])
    aux = torch.stack([r[2] for r in routed]).mean()
    # (g, gs, E, C) one-hots in compute dtype: values are {0,1} / gate
    # weights, bf16 is exact for the former and ample for the latter.
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    xe = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    e, _, c, _ = xe.shape
    ye = _expert_ffn(xe.reshape(e, g * c, d), p, act).reshape(e, g, c, d)
    out = torch.einsum("egcd,gtec->gtd", ye, combine).reshape(t, d)

    if cfg.num_shared:
        hg = torch.einsum("td,df->tf", xt, p["shared_gate"])
        hu = torch.einsum("td,df->tf", xt, p["shared_up"])
        out = out + torch.einsum("tf,fd->td", act(hg) * hu, p["shared_down"])
    return out.reshape(b, s, d), aux
