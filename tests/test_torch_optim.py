"""The port's optimizer pieces (repro_torch.optim) against the reference's
(repro.optim), on the CPU, on the same NumPy inputs made from a seed.

Tolerances: schedules rel 1e-6; AdamW's master, m, v, bf16 params and
metrics rel 1e-6 with an absolute floor of 1e-7 (float32 arithmetic in
the same order; `pow` and `sqrt` may round differently in the last
place); compression's int8 codes and scales bit for bit, its residual
identity `deq + resid == g` to rtol 1e-6 (the reference's), wire bytes
exactly.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import optim as ropt
from repro.optim import compression as rcomp
from repro_torch import optim
from repro_torch.optim import compression as tcomp
from repro_torch.optim.adamw import state_from_numpy, state_to_numpy

REL = 1e-6
ABS = 1e-7


def close(got, ref, rtol=REL, atol=ABS):
    ref = np.asarray(ref, dtype=np.float64)
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), ref,
                               rtol=rtol, atol=atol)


# ------------------------------------------------------------ schedules


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=10, total_steps=100),
    dict(warmup_steps=0, total_steps=50, min_ratio=0.0),
    dict(warmup_steps=25, total_steps=150, min_ratio=0.2),
])
def test_warmup_cosine_matches_reference(kw):
    steps = np.arange(201)
    ref = np.asarray(jax.vmap(lambda s: ropt.warmup_cosine(s, **kw))(steps))
    got = optim.warmup_cosine(torch.from_numpy(steps), **kw)
    assert got.dtype == torch.float32
    close(got, ref, atol=0)
    for s in (0, 7, 10, 55, 100, 200):
        one = optim.warmup_cosine(s, **kw)
        assert one.dtype == torch.float32 and one.ndim == 0
        close(one, ref[s], atol=0)
        t = optim.warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw)
        close(t, ref[s], atol=0)


@pytest.mark.parametrize("warmup", [0, 1, 10, 64])
def test_constant_with_warmup_matches_reference(warmup):
    steps = np.arange(201)
    ref = np.asarray(jax.vmap(lambda s: ropt.constant_with_warmup(
        s, warmup_steps=warmup))(steps))
    got = optim.constant_with_warmup(torch.from_numpy(steps),
                                     warmup_steps=warmup)
    assert got.dtype == torch.float32
    close(got, ref, atol=0)
    assert optim.constant_with_warmup(3, warmup_steps=warmup).ndim == 0


def test_schedule_reference_cases():
    """tests/substrate/test_optim_data_ckpt.py::TestSchedules."""
    def f(s):
        return float(optim.warmup_cosine(s, warmup_steps=10,
                                         total_steps=100))
    assert f(0) == 0.0
    assert f(10) == pytest.approx(1.0, abs=0.02)
    assert f(100) == pytest.approx(0.1, abs=0.01)
    assert f(55) < f(20)


# ------------------------------------------------------------ AdamW


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": r(8, 16), "b": r(16), "layers": [{"k": r(4, 4, 2)},
                                                  {"k": r(4, 4, 2)}]}


def _state(seed, step):
    """A carried AdamWState as NumPy: master, positive v, any m."""
    m = _tree(seed + 1, 0.1)
    v = jax.tree.map(np.abs, _tree(seed + 2, 0.01))
    return ropt.AdamWState(step=np.asarray(step, np.int32),
                           master=_tree(seed), m=m, v=v)


def _ref(state_np):
    return ropt.AdamWState(*jax.tree.map(jnp.asarray, tuple(state_np)))


def _close_state(got, ref):
    got = state_to_numpy(got)
    assert int(got.step) == int(np.asarray(ref.step))
    for part in ("master", "m", "v"):
        for g, r in zip(jax.tree.leaves(getattr(got, part)),
                        jax.tree.leaves(getattr(ref, part))):
            close(g, r)


@pytest.mark.parametrize("grad_scale,clip_active", [(0.05, False),
                                                    (10.0, True)])
@pytest.mark.parametrize("cfg", [
    ropt.AdamWConfig(),
    ropt.AdamWConfig(lr=1e-2, weight_decay=0.0, grad_clip=0.0),
    ropt.AdamWConfig(lr=3e-3, b1=0.8, b2=0.99, eps=1e-6, grad_clip=2.0),
])
def test_apply_matches_reference_over_steps(cfg, grad_scale, clip_active):
    """Four steps of `apply` on carried grads, state and lr_scale: the
    state, the bf16 params and the metrics after each."""
    tcfg = optim.AdamWConfig(**cfg.__dict__)
    ref = _ref(_state(0, 3))
    port = state_from_numpy(_state(0, 3), device="cpu")
    for i in range(4):
        g = _tree(100 + i, grad_scale)
        lr_scale = 0.5 + 0.125 * i
        rp, ref, rm = ropt.apply(jax.tree.map(jnp.asarray, g), ref, cfg,
                                 jnp.float32(lr_scale))
        tp, port, tm = optim.apply(
            jax.tree.map(torch.from_numpy, g), port, tcfg,
            torch.tensor(lr_scale, dtype=torch.float32))
        _close_state(port, ref)
        for a, b in zip(jax.tree.leaves(jax.tree.map(
                lambda x: np.asarray(x, np.float32), rp)),
                jax.tree.leaves(tp, is_leaf=torch.is_tensor)):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.float().numpy(), a)
        close(tm["grad_norm"], rm["grad_norm"])
        close(tm["lr"], rm["lr"])
        clipped = cfg.grad_clip and float(rm["grad_norm"]) > cfg.grad_clip
        assert bool(clipped) == (clip_active and bool(cfg.grad_clip))


def test_apply_with_a_float_lr_scale_and_default_config():
    ref = _ref(_state(5, 0))
    port = state_from_numpy(_state(5, 0), device="cpu")
    g = _tree(9, 0.3)
    _, ref, _ = ropt.apply(jax.tree.map(jnp.asarray, g), ref,
                           ropt.AdamWConfig())
    _, port, _ = optim.apply(jax.tree.map(torch.from_numpy, g), port,
                             optim.AdamWConfig())
    _close_state(port, ref)


def test_init_matches_reference():
    params = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)}
    ref = ropt.init(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                 params))
    port = optim.init({"w": torch.from_numpy(params["w"]).bfloat16()})
    assert port.step.dtype == torch.int32 and int(port.step) == 0
    assert port.master["w"].dtype == torch.float32
    close(port.master["w"], ref.master["w"], atol=0)
    assert float(port.m["w"].abs().sum()) == 0
    assert float(port.v["w"].abs().sum()) == 0


def test_state_numpy_round_trip():
    st = _state(2, 11)
    port = state_from_numpy(st, device="cpu")
    assert isinstance(port, optim.AdamWState)
    assert port.step.dtype == torch.int32 and port.step.ndim == 0
    back = state_to_numpy(port)
    assert int(back.step) == 11
    for a, b in zip(jax.tree.leaves(tuple(back)[1:]),
                    jax.tree.leaves(tuple(st)[1:])):
        np.testing.assert_array_equal(a, b)


class TestAdamWReferenceCases:
    """tests/substrate/test_optim_data_ckpt.py::TestAdamW, on the port."""

    def _setup(self):
        params = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
                  "b": torch.zeros((4,), dtype=torch.bfloat16)}
        return params, optim.init(params)

    def test_init_dtypes(self):
        _, state = self._setup()
        assert state.master["w"].dtype == torch.float32
        assert state.m["w"].dtype == torch.float32

    def test_step_moves_params(self):
        params, state = self._setup()
        grads = {k: torch.ones(p.shape) for k, p in params.items()}
        new_params, new_state, metrics = optim.apply(
            grads, state, optim.AdamWConfig(lr=1e-2))
        assert int(new_state.step) == 1
        assert not np.allclose(new_params["w"].float().numpy(), 1.0)
        assert float(metrics["grad_norm"]) > 0

    def test_grad_clip(self):
        params, state = self._setup()
        big = {k: 1e6 * torch.ones(p.shape) for k, p in params.items()}
        new_params, _, _ = optim.apply(
            big, state, optim.AdamWConfig(lr=1e-2, grad_clip=1.0))
        assert bool(torch.isfinite(new_params["w"].float()).all())

    def test_convergence_quadratic(self):
        state = optim.init({"w": torch.zeros(8, dtype=torch.bfloat16)})
        cfg = optim.AdamWConfig(lr=5e-2, weight_decay=0.0)
        for _ in range(200):
            g = {"w": state.master["w"] - 3.0}
            _, state, _ = optim.apply(g, state, cfg)
        np.testing.assert_allclose(state.master["w"].numpy(), 3.0,
                                   atol=0.15)


# ------------------------------------------------------------ compression


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((257,), 5.0),
                                         ((3, 256), 1e-3), ((7, 9, 5), 40.0),
                                         ((256,), 0.0)])
def test_quantize_codes_and_scales_equal_reference(shape, scale):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    if g.size > 10:
        g.reshape(-1)[:4] = [0.5, -0.5, 1.5, -2.5]   # half-way codes
    rq, rs = rcomp._quantize(jnp.asarray(g))
    tq, ts = tcomp._quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    rdeq, rres = rcomp.compress_decompress(jnp.asarray(g))
    tdeq, tres = tcomp.compress_decompress(torch.from_numpy(g))
    np.testing.assert_array_equal(tdeq.numpy(), np.asarray(rdeq))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(rres))


def test_round_half_to_even_like_jnp_round():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


class TestCompressionReferenceCases:
    """tests/substrate/test_optim_data_ckpt.py::TestCompression."""

    def test_roundtrip_error_small(self):
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(
            1000).astype(np.float32))
        _, resid = optim.compress_decompress(g)
        assert float(resid.norm() / g.norm()) < 0.01

    def test_error_feedback_preserves_sum(self):
        g = torch.from_numpy((np.random.default_rng(1).standard_normal(
            257) * 5).astype(np.float32))
        deq, resid = optim.compress_decompress(g)
        np.testing.assert_allclose((deq + resid).numpy(), g.numpy(),
                                   rtol=1e-6)

    def test_wire_bytes(self):
        bf16, i8 = optim.wire_bytes_saved({"w": torch.zeros(1024, 1024)})
        assert bf16 == 2 * 1024 * 1024
        assert i8 < 0.55 * bf16


def test_wire_bytes_equal_reference():
    shapes = {"a": (1000,), "b": [(3, 7), (256, 3)], "c": (1,)}
    ref = jax.tree.map(lambda s: jnp.zeros(s), shapes,
                       is_leaf=lambda x: isinstance(x, tuple))
    port = jax.tree.map(lambda s: torch.zeros(s), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    assert optim.wire_bytes_saved(port) == ropt.wire_bytes_saved(ref)


def test_init_error_feedback_zeros():
    ef = optim.init_error_feedback({"w": torch.ones(3, 2,
                                                    dtype=torch.bfloat16)})
    assert ef.residual["w"].dtype == torch.float32
    assert float(ef.residual["w"].abs().sum()) == 0


@pytest.fixture
def one_rank_group():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_compressed_psum_on_one_rank_equals_reference_psum(one_rank_group):
    """On one rank the sum is the rank's own dequantized value; the
    reference's psum over a one-device axis gives the same."""
    g = _tree(21, 2.0)
    r = jax.tree.map(lambda a: 0.01 * a, _tree(22))
    ref_sum, ref_ef = jax.vmap(
        lambda gg, rr: rcomp.compressed_psum(gg, "i", rcomp.ErrorFeedback(rr)),
        axis_name="i")(jax.tree.map(lambda a: jnp.asarray(a)[None], g),
                       jax.tree.map(lambda a: jnp.asarray(a)[None], r))
    tg = jax.tree.map(torch.from_numpy, g)
    got, ef = optim.compressed_psum(
        tg, one_rank_group,
        optim.ErrorFeedback(jax.tree.map(torch.from_numpy, r)))
    for a, b in zip(jax.tree.leaves(ref_sum),
                    jax.tree.leaves(got, is_leaf=torch.is_tensor)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a)[0])
    for a, b in zip(jax.tree.leaves(ref_ef.residual),
                    jax.tree.leaves(ef.residual, is_leaf=torch.is_tensor)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a)[0])
    plain, none = optim.compressed_psum(tg, one_rank_group)
    assert none is None
    np.testing.assert_array_equal(
        plain["w"].numpy(), optim.compress_decompress(tg["w"])[0].numpy())


def test_compressed_psum_without_a_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        optim.compressed_psum({"w": torch.ones(4)})
