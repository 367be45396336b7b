"""Training step construction + the runnable training loop.

`make_train_step` builds the (state, batch) -> (state, metrics) function
with bf16 compute / fp32 master AdamW and gradient accumulation over
microbatches (one microbatch's activations live at a time, and
`cfg.remat` decides how many of them).  The step runs eagerly, one
PyTorch operation after another, on the device its state lives on.

The loop (`run_training`, `main`) composes it with the data pipeline
and checkpointing.  `state_shardings` gives the state's shardings on a
device mesh (the dry run reads their placements and per-device shapes);
the eager single-card step keeps `rules` as hints, as the models keep
`logical_constraint`, and applies no placement.

Run: PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b
[--full] [--device cpu]  (without --device it runs on the CUDA card and
fails where there is none).
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, DataLoader
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import MeshSharding
from repro_torch.models.common import (DEFAULT_RULES, init_params,
                                       param_sharding, param_shapes,
                                       tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.registry import build

Pytree = Any

# The step's compute dtype: params are cast from the float32 master to it
# each step, as the reference casts to bf16.
COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def make_rules(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """DEFAULT_RULES + per-arch overrides, filtered to existing mesh axes.
    `mesh` is a `launch.mesh.Mesh` (`mesh_dim_names`), anything with
    `axis_names`, or a sequence of axis names."""
    rules = dict(DEFAULT_RULES)
    rules.update(cfg.rules_overrides)
    names = set(getattr(mesh, "mesh_dim_names", None)
                or getattr(mesh, "axis_names", mesh))

    def filt(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        vv = tuple(a for a in v if a in names)
        return vv if vv else None

    return {k: filt(v) for k, v in rules.items()}


def state_shardings(specs, rules, mesh) -> optim.AdamWState:
    """The AdamW state's shardings: each master/m/v leaf the mesh and its
    parameter's spec (`param_sharding`), `step` replicated."""
    def named():
        return tree_map(lambda s: MeshSharding(mesh, s),
                        param_sharding(specs, rules),
                        is_leaf=lambda x: isinstance(x, tuple))
    return optim.AdamWState(step=MeshSharding(mesh, ()), master=named(),
                            m=named(), v=named())


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def lm_loss(model, params, batch, rules) -> Tuple[torch.Tensor, Dict]:
    logits, aux = model.forward(params, batch, rules)
    labels = batch["labels"].long()
    ls = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(ls, -1, labels[..., None])[..., 0]
    loss = nll.mean()
    # z-loss keeps the softmax normalizer bounded at bf16 scale.
    zl = 1e-4 * torch.square(torch.logsumexp(logits, dim=-1)).mean()
    total = loss + zl + aux
    return total, {"ce": loss, "aux": aux}


def _split_micro(key: str, x: torch.Tensor, n: int) -> torch.Tensor:
    """Reshape a batch leaf to (n_micro, per_micro, ...)."""
    if key == "mrope_positions":                # (3, B, S)
        b = x.shape[1]
        y = x.reshape(x.shape[0], n, b // n, x.shape[2])
        return torch.movedim(y, 1, 0)
    b = x.shape[0]
    return x.reshape((n, b // n) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def step_grads(model, master: Pytree, batch: Dict[str, torch.Tensor], rules,
               *, n_micro: int = 1, dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, list]:
    """The train step's loss and float32 gradient leaves (in
    `tree_leaves` order): params cast from the float32 `master` to
    `dtype` (COMPUTE_DTYPE unless given), `lm_loss`, autograd; with
    n_micro > 1 the gradients are accumulated over the micro-batches and
    averaged, as is the loss.  A leaf the loss does not reach gets
    zeros, as in the reference."""
    leaves = [p.to(dtype or COMPUTE_DTYPE).requires_grad_()
              for p in tree_leaves(master)]
    params = tree_unflatten(master, leaves)

    def grads_of(mb):
        loss, _ = lm_loss(model, params, mb, rules)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    if n_micro <= 1:
        loss, grads = grads_of(batch)
        return loss, [g.float() for g in grads]
    micro_batch = {k: _split_micro(k, v, n_micro) for k, v in batch.items()}
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(n_micro):
        lo, grads = grads_of({k: v[i] for k, v in micro_batch.items()})
        for a, g in zip(acc, grads):
            a.add_(g.float())
        loss = loss + lo
    return loss / n_micro, [g / n_micro for g in acc]


def make_train_step(model, cfg: ModelConfig, rules,
                    opt_cfg: optim.AdamWConfig, *, n_micro: int = 1,
                    lr_schedule=None):
    def train_step(state: optim.AdamWState, batch: Dict[str, torch.Tensor]):
        loss, grads = step_grads(model, state.master, batch, rules,
                                 n_micro=n_micro)
        lr_scale = (lr_schedule(state.step) if lr_schedule is not None
                    else 1.0)
        _, new_state, metrics = optim.apply(
            tree_unflatten(state.master, grads), state, opt_cfg, lr_scale)
        metrics = {**metrics, "loss": loss}
        return new_state, metrics

    return train_step


def init_state(model, cfg: ModelConfig, generator=None,
               dtype=torch.bfloat16, device=None) -> optim.AdamWState:
    """Random params (`init_params`, from `generator`, by default one
    seeded 0 on `device`) and their AdamW state, on `device` (the card
    unless the caller names the CPU)."""
    dev = resolve_device(device)
    gen = (generator if generator is not None
           else torch.Generator(device=dev).manual_seed(0))
    params = init_params(gen, model.param_specs(), dtype=dtype, device=dev)
    return optim.init(params)


def abstract_state(model) -> optim.AdamWState:
    """Meta-tensor state (shapes and dtypes, no storage) for dry runs
    and checkpoint templates."""
    def f32():
        return param_shapes(model.param_specs(), dtype=torch.float32)
    return optim.AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        master=f32(), m=f32(), v=f32())


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def run_training(arch: str, *, steps: int = 20, smoke: bool = True,
                 global_batch: int = 8, seq_len: int = 128,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 10,
                 n_micro: int = 1, log_every: int = 5,
                 device=None) -> Dict:
    """Single-host training loop (the end-to-end example's), on
    `device` (the card unless the caller names the CPU)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    model = build(cfg)
    if cfg.is_encdec:
        raise NotImplementedError("use examples/train_lm.py LM archs")
    opt_cfg = optim.AdamWConfig(lr=3e-4)
    state = init_state(model, cfg, device=dev)
    lr_sched = functools.partial(optim.warmup_cosine, warmup_steps=10,
                                 total_steps=max(steps, 20))
    step_fn = make_train_step(model, cfg, None, opt_cfg, n_micro=n_micro,
                              lr_schedule=lr_sched)
    data = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                 global_batch=global_batch))
    ck = None
    if checkpoint_dir:
        from repro_torch.checkpoint import Checkpointer
        ck = Checkpointer(checkpoint_dir)

    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if ck is not None and (step + 1) % checkpoint_every == 0:
            ck.save(step, state)
        if step % log_every == 0:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
    if ck is not None:
        ck.wait()
    dt = time.perf_counter() - t0
    return {"losses": losses, "seconds": dt,
            "tokens_per_s": steps * global_batch * seq_len / dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full config (needs the card's memory)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run_training(args.arch, steps=args.steps, smoke=not args.full,
                       global_batch=args.global_batch, seq_len=args.seq_len,
                       checkpoint_dir=args.checkpoint_dir,
                       device=args.device)
    print(f"done: final loss {out['losses'][-1]:.4f}, "
          f"{out['tokens_per_s']:.0f} tok/s")


if __name__ == "__main__":
    main()
