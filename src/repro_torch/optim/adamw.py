"""AdamW with fp32 master weights.

The state holds float32 master weights and moments for every parameter
leaf; the model computes in bf16 params cast from the master each step
(mixed precision: compute and gradient dtype bf16, update math fp32).
The update is the reference's term by term (`apply`); it is not
`torch.optim.AdamW`, whose decoupled decay and eps placement give other
numbers.  `apply` consumes the state it is given: the master weights and
moments are updated in place (the reference donates them) and returned
in the new state.  The state's shardings on a device mesh are
`launch/train.state_shardings`'s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.models.common import (first_tensor, params_from_numpy,
                                       params_to_numpy, tree_leaves,
                                       tree_map)

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    master: Pytree          # fp32 master weights
    m: Pytree
    v: Pytree


def init(params: Pytree) -> AdamWState:
    """Master weights (float32 copies of `params`) and zero moments, on
    the params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32,
                         device=first_tensor(params).device),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def apply(grads: Pytree, state: AdamWState, cfg: AdamWConfig,
          lr_scale: "torch.Tensor | float" = 1.0
          ) -> Tuple[Pytree, AdamWState, dict]:
    """Returns (new bf16 params, new state, metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)

    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale

    def upd(g, master, m, v):
        g = g.float() * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * master
        master.copy_(master - lr * delta)

    for g, ma, m, v in zip(tree_leaves(grads), tree_leaves(state.master),
                           tree_leaves(state.m), tree_leaves(state.v)):
        upd(g, ma, m, v)
    params = tree_map(lambda p: p.to(torch.bfloat16), state.master)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, master=state.master, m=state.m,
                              v=state.v), metrics


def state_from_numpy(state, device=None) -> AdamWState:
    """Carry an AdamW state of NumPy arrays (the reference's, through
    `np.asarray`, or `state_to_numpy`'s) into tensors on `device` (the
    card unless the caller names the CPU): step int32, the rest as
    stored."""
    step, master, m, v = state
    return AdamWState(
        step=params_from_numpy(np.asarray(step, np.int32), device=device),
        master=params_from_numpy(master, device=device),
        m=params_from_numpy(m, device=device),
        v=params_from_numpy(v, device=device))


def state_to_numpy(state: AdamWState) -> AdamWState:
    """The inverse of `state_from_numpy`: an AdamWState of host NumPy
    copies."""
    return AdamWState(*(params_to_numpy(part) for part in state))
