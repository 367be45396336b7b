"""The port's training path (repro_torch.launch.train, the backward pass
through repro_torch.models with `cfg.remat`, the example) against
the reference's, on the CPU.

Tolerances, each measured against what the float32 arithmetic of the two
packages allows:

* backward in float32, all ten archs at `smoke()` on carried weights: the
  loss to rel 1e-6; every gradient leaf to rtol 1e-4 with an absolute
  floor of GRAD_ATOL times the leaf's largest |gradient| (5e-4; 2e-3 for
  whisper, whose float32 gradient is itself 1.8e-3 off a float64
  evaluation in relative error norm, where the port's is 4.9e-4 off the
  reference's), and each leaf's relative error norm within GRAD_NORM
  (2e-4; 1e-3 for whisper).  The largest measured: 2.3e-4 and 1.0e-4
  (qwen2-vl), 6.8e-4 and 4.9e-4 (whisper);
* remat: every policy's gradients equal "none"'s within 1e-6 (relative
  to the leaf's largest |gradient|);
* the bf16 train step: bf16 cannot be held elementwise (torch rounds to
  bf16 after every operation, XLA once per fusion), so the loss is held
  to the reference's within rel 1e-3, and grad_norm, master, m and v
  after the step to the float32 step (the reference's gradient at the
  float32 master, then its AdamW): the port's relative error (norm over
  all leaves) at most BF16_FACTOR = 1.25 times the reference's bf16
  step's, plus 2e-3 (half a bf16 ulp) for grad_norm; the step's AdamW on
  its own gradients equals the reference's AdamW on them to rel 1e-6.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import optim as ropt
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.data import DataConfig as RefDataConfig
from repro.data import global_batch_at as ref_batch_at
from repro.launch import train as rtrain
from repro.models.common import init_params as ref_init
from repro.models.registry import build as ref_build
from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataLoader
from repro_torch.launch import train as ttrain
from repro_torch.models.common import (init_params, params_from_numpy,
                                       tree_leaves, tree_map)
from repro_torch.models.registry import build
from repro_torch.optim.adamw import state_from_numpy, state_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
B, S = 2, 32
GRAD_ATOL = {"whisper-small": 2e-3}
GRAD_NORM = {"whisper-small": 1e-3}
BF16_FACTOR = 1.25


def _batch(cfg, seed=7):
    """tokens (and whisper's frames, qwen2-vl's M-RoPE streams) from a
    seed, as NumPy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_dec.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        batch["mrope_positions"] = rng.integers(0, 64, (3, B, S))
    return batch


def _port_loss(model, params, batch, labels):
    """The loss of tests/models/test_archs_smoke.py::test_train_step_no_nans."""
    logits, aux = model.forward(params, batch)
    ll = torch.log_softmax(logits, dim=-1)
    return -torch.gather(ll, -1, labels[..., None]).mean() + aux


def _port_grads(model, params, batch, labels):
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss = _port_loss(model, params, batch, labels)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), grads


# ------------------------------------------------------------ backward


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_float32_gradients_equal_reference(arch):
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    rm, model = ref_build(rcfg), build(cfg)
    rparams = ref_init(jax.random.key(1), rm.param_specs(),
                       dtype=jnp.float32)
    batch = _batch(cfg)
    labels = np.roll(batch["tokens"], -1, axis=1)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def ref_loss(p):
        logits, aux = rm.forward(p, rbatch)
        ll = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(ll, jnp.asarray(labels)[..., None],
                                    axis=-1).mean() + aux

    rloss, rgrads = jax.jit(jax.value_and_grad(ref_loss))(rparams)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams),
                               device="cpu")
    loss, grads = _port_grads(model, params,
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                              torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-6)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rgrads)[0]]
    ref_leaves = jax.tree.leaves(rgrads)
    assert len(grads) == len(ref_leaves)
    atol = GRAD_ATOL.get(arch, 5e-4)
    norm_tol = GRAD_NORM.get(arch, 2e-4)
    for path, g, r in zip(paths, grads, ref_leaves):
        r = np.asarray(r, np.float64)
        g = g.double().numpy()
        assert g.shape == r.shape, path
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=atol * scale,
                                   err_msg=f"{arch} {path}")
        if scale > 0:
            rel = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert rel <= norm_tol, (arch, path, rel)
    assert float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads))) > 0


def test_smoke_train_step_as_the_reference_test():
    """tests/models/test_archs_smoke.py::test_train_step_no_nans on the
    port, for every arch: finite loss, a nonzero finite grad norm, and an
    SGD step of 0.1 that does not raise the loss by 0.5."""
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        model = build(cfg)
        params = init_params(torch.Generator().manual_seed(1),
                             model.param_specs(), torch.float32,
                             device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        labels = torch.roll(batch["tokens"], -1, dims=1)
        loss, grads = _port_grads(model, params, batch, labels)
        gnorm = float(optim.global_norm(list(grads)))
        assert np.isfinite(float(loss)) and np.isfinite(gnorm), arch
        assert gnorm > 0, arch
        stepped = [p - 0.1 * g for p, g in zip(tree_leaves(params), grads)]
        it = iter(stepped)
        with torch.no_grad():
            loss2 = _port_loss(model, tree_map(lambda _: next(it), params),
                               batch, labels)
        assert float(loss2) < float(loss) + 0.5, arch


# ------------------------------------------------------------ remat


def _remat_grads(arch, policy):
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=policy)
    model = build(cfg)
    params = init_params(torch.Generator().manual_seed(4),
                         model.param_specs(), torch.float32, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 9).items()}
    labels = torch.roll(batch["tokens"], -1, dims=1)
    return _port_grads(model, params, batch, labels)


REMAT_ARCHS = ["starcoder2-7b", "gemma3-1b", "rwkv6-7b", "hymba-1.5b",
               "whisper-small"]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_changes_no_value(arch):
    loss0, g0 = _remat_grads(arch, "none")
    for policy in ("save_boundaries", "full", "dots"):
        loss, g = _remat_grads(arch, policy)
        assert float(loss) == float(loss0), (arch, policy)
        for a, b in zip(g, g0):
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= 1e-6 * scale, (arch, policy)


class _SavedBytes:
    """Bytes autograd keeps for the backward pass outside checkpointed
    regions (a checkpoint keeps its region's inputs only)."""

    def __init__(self):
        self.bytes = 0

    def pack(self, t):
        self.bytes += t.numel() * t.element_size()
        return t


def _saved_bytes(arch, policy):
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=policy)
    model = build(cfg)
    params = init_params(torch.Generator().manual_seed(4),
                         model.param_specs(), torch.float32, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 9).items()}
    counter = _SavedBytes()
    with torch.autograd.graph.saved_tensors_hooks(counter.pack, lambda t: t):
        model.forward(params, batch)
    return counter.bytes


@pytest.mark.parametrize("arch", ["starcoder2-7b", "gemma3-1b",
                                  "whisper-small"])
def test_remat_keeps_fewer_activations(arch):
    none = _saved_bytes(arch, "none")
    boundaries = _saved_bytes(arch, "save_boundaries")
    assert boundaries < none / 2, (arch, none, boundaries)


class _Products(TorchDispatchMode):
    """Counts matrix products, un-batched (mm, addmm, batch-1 bmm) and
    batched (bmm)."""

    def __init__(self):
        super().__init__()
        self.unbatched = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.unbatched += 1
        elif func is torch.ops.aten.bmm.default:
            if args[0].shape[0] == 1:
                self.unbatched += 1
            else:
                self.batched += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_recomputes_batched_products_only():
    """In the backward pass "full" recomputes the layers' products; "dots"
    recomputes the batched (attention) ones as "full" does, and none of
    the un-batched ones, whose outputs it kept."""
    counts = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(get_config("starcoder2-7b", smoke=True),
                                  remat=policy)
        model = build(cfg)
        params = init_params(torch.Generator().manual_seed(4),
                             model.param_specs(), torch.float32,
                             device="cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 9).items()}
        logits, _ = model.forward(params, batch)
        bwd = _Products()
        with bwd:
            torch.autograd.grad(logits.square().mean(), leaves)
        counts[policy] = bwd
    none_b, full_b, dots_b = (counts[p] for p in ("none", "full", "dots"))
    assert full_b.batched > none_b.batched
    assert dots_b.batched == full_b.batched
    assert full_b.unbatched > none_b.unbatched
    assert dots_b.unbatched == none_b.unbatched


# ------------------------------------------------------------ train step


def _split_case(cfg):
    batch = ref_batch_at(0, RefDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=S, global_batch=4, seed=1))
    if cfg.mrope_sections:
        batch["mrope_positions"] = np.random.default_rng(4).integers(
            0, 64, (3, 4, S))
    return batch


def test_split_micro_equals_reference():
    batch = _split_case(get_config("qwen2-vl-7b", smoke=True))
    for key, val in batch.items():
        ref = np.asarray(rtrain._split_micro(key, jnp.asarray(val), 2))
        got = ttrain._split_micro(key, torch.from_numpy(val), 2).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=key)
    assert ttrain._split_micro(
        "mrope_positions", torch.from_numpy(batch["mrope_positions"]),
        2).shape == (2, 3, 2, S)


def _relnorm(got, ref):
    a = np.concatenate([np.ravel(np.asarray(x, np.float64))
                        for x in jax.tree.leaves(got)])
    b = np.concatenate([np.ravel(np.asarray(x, np.float64))
                        for x in jax.tree.leaves(ref)])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


class _Float32Numpy:
    """The reference train module's `jnp` with bfloat16 read as float32,
    so its step computes in float32."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


class StepCase:
    """One train step of both packages from the same carried AdamWState
    (the reference's init, at step 4, so the schedule is past warm-up)
    and batch."""

    def __init__(self, arch, n_micro):
        self.rcfg = ref_config(arch, smoke=True)
        self.cfg = get_config(arch, smoke=True)
        self.rm, self.model = ref_build(self.rcfg), build(self.cfg)
        self.n_micro = n_micro
        rstate = rtrain.init_state(self.rm, self.rcfg, jax.random.key(3))
        self.rstate = rstate._replace(step=jnp.asarray(4, jnp.int32))
        self.carried = ropt.AdamWState(*jax.tree.map(np.asarray,
                                                     tuple(self.rstate)))
        batch = _split_case(self.cfg)
        self.rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        self.pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        self.rsched = functools.partial(ropt.warmup_cosine, warmup_steps=2,
                                        total_steps=10)
        self.tsched = functools.partial(optim.warmup_cosine,
                                        warmup_steps=2, total_steps=10)

    def run(self):
        """(reference's new state and metrics, port's)."""
        rnew, rmet = jax.jit(rtrain.make_train_step(
            self.rm, self.rcfg, None, ropt.AdamWConfig(),
            n_micro=self.n_micro, lr_schedule=self.rsched))(
            self.rstate, self.rbatch)
        step = ttrain.make_train_step(self.model, self.cfg, None,
                                      optim.AdamWConfig(),
                                      n_micro=self.n_micro,
                                      lr_schedule=self.tsched)
        pnew, pmet = step(state_from_numpy(self.carried, device="cpu"),
                          self.pbatch)
        assert int(pnew.step) == 5
        assert pmet["loss"].dtype == torch.float32
        return rnew, rmet, state_to_numpy(pnew), pmet


@pytest.mark.parametrize("arch,n_micro", [("gemma3-1b", 1),
                                          ("qwen2-vl-7b", 2),
                                          ("starcoder2-7b", 2)])
def test_float32_train_step_equals_reference(arch, n_micro, monkeypatch):
    """The step's logic (cast, micro-batching with qwen2-vl's M-RoPE
    split, schedule before the increment, AdamW) with the compute dtype
    set to float32 in both packages: loss rel 1e-6, grad_norm rel 1e-4,
    m and v within the backward test's gradient tolerance (relative error
    norm 2e-4, 4e-4 for v, a square; measured up to 1.2e-4 and 1.5e-4 on
    starcoder2), master by relative error norm 1e-5 (measured up to
    3.4e-7) and no weight more than one learning rate apart (where a
    gradient is as small as its float32 error, AdamW's normalised step,
    about ±0.5 lr here, may change sign; measured at most 1.5 % of lr)."""
    monkeypatch.setattr(rtrain, "jnp", _Float32Numpy())
    monkeypatch.setattr(ttrain, "COMPUTE_DTYPE", torch.float32)
    case = StepCase(arch, n_micro)
    rnew, rmet, pnew, pmet = case.run()
    np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(pmet["lr"]), float(rmet["lr"]),
                               rtol=1e-6)
    assert _relnorm(pnew.m, rnew.m) <= 2e-4
    assert _relnorm(pnew.v, rnew.v) <= 4e-4
    assert _relnorm(pnew.master, rnew.master) <= 1e-5
    lr = float(rmet["lr"])
    for a, b in zip(jax.tree.leaves(pnew.master),
                    jax.tree.leaves(rnew.master)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=lr)


@pytest.mark.parametrize("arch,n_micro", [("gemma3-1b", 1),
                                          ("starcoder2-7b", 2)])
def test_bf16_train_step_against_reference(arch, n_micro):
    """The shipped bf16 step, held to the float32 step of the reference
    (its gradient at the float32 master, then its AdamW) no worse than
    BF16_FACTOR times the reference's own bf16 step; then the step's
    AdamW on the step's own gradients, exactly.  (qwen2-vl's bf16
    gradient at smoke() size is 66-74 % off its float32 one in the
    reference itself, so its step is held in float32 above.)"""
    case = StepCase(arch, n_micro)
    rnew, rmet, pn, pmet = case.run()
    (_, _), g32 = jax.jit(jax.value_and_grad(
        lambda p: rtrain.lm_loss(case.rm, p, case.rbatch, None),
        has_aux=True))(case.rstate.master)
    _, s32, m32 = ropt.apply(g32, case.rstate, ropt.AdamWConfig(),
                             case.rsched(case.rstate.step))
    np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]),
                               rtol=1e-3)
    gn32 = float(m32["grad_norm"])
    ref_err = abs(float(rmet["grad_norm"]) - gn32) / gn32
    got_err = abs(float(pmet["grad_norm"]) - gn32) / gn32
    assert got_err <= BF16_FACTOR * ref_err + 2e-3, (got_err, ref_err)
    for part in ("master", "m", "v"):
        ref_err = _relnorm(getattr(rnew, part), getattr(s32, part))
        got_err = _relnorm(getattr(pn, part), getattr(s32, part))
        assert got_err <= BF16_FACTOR * ref_err, (part, got_err, ref_err)

    # The step's AdamW on the step's own gradients, exactly.
    state = state_from_numpy(case.carried, device="cpu")
    loss, grads = ttrain.step_grads(case.model, state.master, case.pbatch,
                                    None, n_micro=n_micro)
    assert float(loss) == float(pmet["loss"])
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), state.master)
    _, again, ametrics = optim.apply(gtree, state, optim.AdamWConfig(),
                                     case.tsched(4))
    an = state_to_numpy(again)
    for part in ("master", "m", "v"):
        for a, b in zip(jax.tree.leaves(getattr(an, part)),
                        jax.tree.leaves(getattr(pn, part))):
            np.testing.assert_array_equal(a, b)
    assert float(ametrics["grad_norm"]) == float(pmet["grad_norm"])
    ref_grads = jax.tree.map(jnp.asarray, tree_map(lambda g: g.numpy(),
                                                   gtree))
    _, rs, rmm = ropt.apply(ref_grads, case.rstate, ropt.AdamWConfig(),
                            case.rsched(case.rstate.step))
    for part in ("master", "m", "v"):
        for a, b in zip(jax.tree.leaves(getattr(an, part)),
                        jax.tree.leaves(getattr(rs, part))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_allclose(float(ametrics["grad_norm"]),
                               float(rmm["grad_norm"]), rtol=1e-6)


def test_make_rules_reads_axis_names():
    cfg = get_config("gemma3-1b", smoke=True)
    rcfg = ref_config("gemma3-1b", smoke=True)

    class Mesh:
        axis_names = ("data", "model")
    for mesh in (Mesh(), ("data", "model"), ["pod", "data"]):
        ref_mesh = Mesh() if isinstance(mesh, Mesh) else \
            type("M", (), {"axis_names": tuple(mesh)})()
        assert ttrain.make_rules(cfg, mesh) == rtrain.make_rules(rcfg,
                                                                 ref_mesh)


def test_lm_loss_equals_reference():
    arch = "starcoder2-7b"
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    rm, model = ref_build(rcfg), build(cfg)
    rparams = ref_init(jax.random.key(6), rm.param_specs(),
                       dtype=jnp.float32)
    batch = _split_case(cfg)
    rtotal, rparts = rtrain.lm_loss(rm, rparams,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()}, None)
    total, parts = ttrain.lm_loss(
        model, params_from_numpy(jax.tree.map(np.asarray, rparams),
                                 device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    np.testing.assert_allclose(float(total), float(rtotal), rtol=1e-6)
    np.testing.assert_allclose(float(parts["ce"]), float(rparts["ce"]),
                               rtol=1e-6)


def test_init_and_abstract_state():
    cfg = get_config("starcoder2-7b", smoke=True)
    model = build(cfg)
    st = ttrain.init_state(model, cfg, device="cpu")
    ab = ttrain.abstract_state(model)
    ref_ab = rtrain.abstract_state(ref_build(ref_config("starcoder2-7b",
                                                        smoke=True)))
    assert st.step.dtype == ab.step.dtype == torch.int32
    for part in ("master", "m", "v"):
        for a, b, r in zip(tree_leaves(getattr(st, part)),
                           tree_leaves(getattr(ab, part)),
                           jax.tree.leaves(getattr(ref_ab, part))):
            assert a.dtype == b.dtype == torch.float32
            assert b.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape) == tuple(r.shape)
    # the master is the bf16 draw, upcast
    for a in tree_leaves(st.master):
        assert torch.equal(a, a.bfloat16().float())


# ------------------------------------------------------------ system


def test_training_reduces_loss(monkeypatch):
    """tests/test_system.py::test_training_reduces_loss on the port.  From
    the reference's init (carried weights), the port's 25 losses follow
    the reference's run_training within 5e-3 (bf16 compute; measured
    1.5e-3) and the last is more than 0.1 below the first, as the
    reference's test asserts.  From the port's own draw (another
    generator) the losses are noisy step to step (another batch each
    step, ±0.1): the mean of the last five must be 0.1 below the mean of
    the first five (the last loss alone falls by 0.04 there)."""
    kw = dict(steps=25, smoke=True, global_batch=4, seq_len=64,
              log_every=100)
    own = ttrain.run_training("gemma3-1b", device="cpu", **kw)["losses"]
    assert np.isfinite(own).all()
    assert np.mean(own[-5:]) < np.mean(own[:5]) - 0.1, own

    ref = rtrain.run_training("gemma3-1b", **kw)["losses"]
    cfg = ref_config("gemma3-1b", smoke=True)
    rstate = rtrain.init_state(ref_build(cfg), cfg)
    carried = ropt.AdamWState(*jax.tree.map(np.asarray, tuple(rstate)))
    monkeypatch.setattr(ttrain, "init_state",
                        lambda *a, **k: state_from_numpy(carried,
                                                         device="cpu"))
    losses = ttrain.run_training("gemma3-1b", device="cpu", **kw)["losses"]
    np.testing.assert_allclose(losses, ref, rtol=0, atol=5e-3)
    assert losses[-1] < losses[0] - 0.1, losses


def test_checkpoint_restart_resumes_exactly(tmp_path):
    """tests/test_system.py::test_checkpoint_restart_resumes_exactly on
    the port: 6 steps uninterrupted against 3, save, restore, 3 more."""
    cfg = get_config("starcoder2-7b", smoke=True)
    model = build(cfg)
    step_fn = ttrain.make_train_step(model, cfg, None, optim.AdamWConfig())
    data = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=2))

    def run(state, lo, hi):
        for s in range(lo, hi):
            batch = {k: torch.from_numpy(v)
                     for k, v in data.batch_at(s).items()}
            state, _ = step_fn(state, batch)
        return state

    def fresh():
        return ttrain.init_state(model, cfg,
                                 torch.Generator().manual_seed(5),
                                 device="cpu")

    ref = run(fresh(), 0, 6)
    ck = Checkpointer(str(tmp_path))
    mid = run(fresh(), 0, 3)
    ck.save(2, mid)
    mid = run(mid, 3, 4)            # the async save must not see this
    ck.wait()
    resumed = run(ck.restore(ttrain.abstract_state(model), device="cpu"),
                  3, 6)
    assert int(resumed.step) == 6
    for a, b in zip(tree_leaves(ref.master), tree_leaves(resumed.master)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("starcoder2-7b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.init_state(build(cfg), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run_training("starcoder2-7b", steps=1)


def test_run_training_refuses_encdec():
    with pytest.raises(NotImplementedError):
        ttrain.run_training("whisper-small", steps=1, device="cpu")


def _run(args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_lm_example_restarts_after_a_failure(tmp_path):
    proc = _run(["repro_torch.examples.train_lm", "--device", "cpu",
                 "--with-failure", "--steps", "24", "--global-batch", "4",
                 "--seq-len", "64", "--ckpt-dir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "restored checkpoint @ step 9" in out
    # steps 10 and 11 run twice: 12 before the failure, 14 after
    assert "done: 26 steps, 1 failures" in out and "on cpu" in out
    assert "(improved)" in out


def test_launch_train_module_runs_on_the_cpu(tmp_path):
    proc = _run(["repro_torch.launch.train", "--arch", "starcoder2-7b",
                 "--steps", "4", "--global-batch", "2", "--seq-len", "32",
                 "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    assert "step    0 loss" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1].startswith("done: final loss")


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-7b", "gemma3-1b",
                                  "qwen2-moe-a2.7b"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch,
                                                monkeypatch):
    """One train step (two micro-batches) from the same carried state and
    batch on the card and on the CPU, float32 compute with TF32 off, held
    as the float32 step is held to the reference above: loss rel 1e-5, m
    and v by relative error norm 2e-4 and 4e-4, master by relative error
    norm 1e-5 (measured 1.2e-6 on starcoder2) and no weight more than one
    learning rate apart.  (After a second step the moments differ by up
    to 2.7e-3: AdamW's normalised first step moves the weights whose
    gradient is as small as its rounding error by up to ±lr either
    way.)"""
    monkeypatch.setattr(ttrain, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_config(arch, smoke=True)
    model = build(cfg)
    carried = state_to_numpy(ttrain.init_state(
        model, cfg, torch.Generator().manual_seed(8), device="cpu"))
    batch = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=4)).batch_at(0)
    runs = []
    for dev in ("cpu", cuda_device):
        step = ttrain.make_train_step(model, cfg, None, optim.AdamWConfig(),
                                      n_micro=2)
        state, met = step(state_from_numpy(carried, device=dev),
                          {k: torch.from_numpy(v).to(dev)
                           for k, v in batch.items()})
        runs.append((float(met["loss"]), float(met["lr"]),
                     state_to_numpy(state)))
    (lc, lr, sc), (lg, _, sg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    assert _relnorm(sg.m, sc.m) <= 2e-4
    assert _relnorm(sg.v, sc.v) <= 4e-4
    assert _relnorm(sg.master, sc.master) <= 1e-5
    for a, b in zip(jax.tree.leaves(sg.master), jax.tree.leaves(sc.master)):
        np.testing.assert_allclose(a, b, rtol=0, atol=lr)


def test_step_grads_gives_zeros_for_an_unused_leaf():
    """A leaf the loss does not reach gets a zero gradient (the
    reference's jax.grad gives zeros), not None."""
    cfg = get_config("starcoder2-7b", smoke=True)
    model = build(cfg)
    st = ttrain.init_state(model, cfg, device="cpu")
    master = dict(st.master, unused=torch.ones(3, 2))
    batch = {k: torch.from_numpy(v) for k, v in DataLoader(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=2)).batch_at(
            0).items()}
    loss, grads = ttrain.step_grads(model, master, batch, None)
    leaves = tree_leaves(master)
    assert len(grads) == len(leaves)
    for g, p in zip(grads, leaves):
        assert g.dtype == torch.float32 and g.shape == p.shape
    unused = [g for g, p in zip(grads, leaves) if p.shape == (3, 2)]
    assert len(unused) == 1 and float(unused[0].abs().sum()) == 0
    assert torch.isfinite(loss)
