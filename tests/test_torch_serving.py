"""The port's serving engine (repro_torch.serving) and its example against
the reference's (repro.serving, examples/serve_lm.py), on the CPU.

Both engines run the same requests over the same weights: the
reference's float32 `init_params`, carried into the port with
`params_from_numpy`.  Generated tokens, ServingStats and the chosen KV
layout must be equal (greedy tokens are exact).  The reference's own
engine tests (tests/substrate/test_runtime_serving.py) run on the port,
and `reset_slot` is held to the reference's on both cache layouts
(cache tensors: rtol 1e-4 with an absolute floor of 1e-4 times
max(1, max|ref|); kv_pos equal).
"""
import dataclasses
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.common import init_params as ref_init
from repro.models.registry import build as ref_build
from repro.serving import ContinuousBatchingEngine as RefEngine
from repro.serving import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.examples import serve_lm
from repro_torch.models.common import params_from_numpy, params_to_numpy
from repro_torch.models.registry import build
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServingStats)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4


def close(got, ref, what=""):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def tree_close(got, ref, path="cache"):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            tree_close(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            tree_close(g, r, f"{path}[{i}]")
    else:
        ref = np.asarray(ref)
        got = np.broadcast_to(np.asarray(got), ref.shape)
        if ref.dtype.kind in "iub":
            np.testing.assert_array_equal(got, ref, err_msg=path)
        else:
            close(got, ref, path)


class Pair:
    """One arch at smoke size: the reference model and parameters, and
    the port's model on the same (carried) parameters."""

    def __init__(self, arch, seed=0):
        self.rm = ref_build(ref_config(arch, smoke=True))
        self.m = build(get_config(arch, smoke=True))
        self.cfg = self.m.cfg
        self.rparams = ref_init(jax.random.key(seed), self.rm.param_specs(),
                                dtype=jnp.float32)
        self.params = params_from_numpy(
            jax.tree.map(np.asarray, self.rparams), device="cpu")

    def engine(self, **kw):
        return ContinuousBatchingEngine(self.m, self.params, device="cpu",
                                        **kw)


@pytest.fixture(scope="module")
def starcoder():
    return Pair("starcoder2-7b")


@pytest.fixture(scope="module")
def gemma():
    return Pair("gemma3-1b")


def _requests(cls, vocab, n, seed):
    """Mixed prompt lengths, 3 to 40 tokens: more requests than slots, and
    prompts longer than gemma3-smoke's 16-slot window."""
    rng = np.random.default_rng(seed)
    lengths = [3, 40, 7, 18, 5, 25, 11, 4][:n]
    return [cls(rid=i, prompt=[int(t) for t in rng.integers(1, vocab, ln)],
                max_new_tokens=4 + i % 3) for i, ln in enumerate(lengths)]


@pytest.mark.parametrize("pair_name", ["starcoder", "gemma"])
def test_engine_matches_reference_engine(pair_name, request):
    pair = request.getfixturevalue(pair_name)
    kw = dict(slots=3, max_seq=64, eos_id=-1)
    ref = RefEngine(pair.rm, pair.rparams, dtype=jnp.float32, **kw)
    eng = pair.engine(**kw)
    ref_reqs = _requests(RefRequest, pair.cfg.vocab_size, 8, seed=1)
    reqs = _requests(Request, pair.cfg.vocab_size, 8, seed=1)
    for r in ref_reqs:
        ref.submit(r)
    for r in reqs:
        eng.submit(r)
    ref_stats = ref.run_until_drained()
    stats = eng.run_until_drained()
    for a, b in zip(reqs, ref_reqs):
        assert (a.rid, a.done, a.generated) == (b.rid, b.done, b.generated)
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    assert stats.admitted == 8 and stats.completed == 8
    assert (eng.kv_layout.dims, eng.kv_layout.sizes,
            eng.kv_layout.itemsize) == (ref.kv_layout.dims,
                                        ref.kv_layout.sizes,
                                        ref.kv_layout.itemsize)
    assert eng.kv_layout.dims == ("seq", "kv_heads", "head_dim")
    tree_close(params_to_numpy(eng.cache),
               jax.tree.map(np.asarray, ref.cache))


def test_engine_refuses_what_the_reference_refuses(starcoder):
    eng = starcoder.engine(slots=2, max_seq=16)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid=0, prompt=[]))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.submit(Request(rid=1, prompt=[1] * 10, max_new_tokens=7))
    whisper = build(get_config("whisper-small", smoke=True))
    with pytest.raises(ValueError, match="decoder-only"):
        ContinuousBatchingEngine(whisper, {}, slots=1, max_seq=8,
                                 device="cpu")
    assert ServingStats() == ServingStats(0, 0, 0, 0, 0)


def test_engine_defaults_to_the_card(starcoder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(starcoder.m, starcoder.params, slots=1,
                                 max_seq=8)


# ------------------------------------- the reference's engine tests


def test_single_request_matches_offline_decode(starcoder):
    """Engine output == plain greedy decode of the same prompt."""
    model, params = starcoder.m, starcoder.params
    prompt = [5, 17, 99, 3]
    eng = starcoder.engine(slots=2, max_seq=32, eos_id=-1)
    req = Request(rid=0, prompt=list(prompt), max_new_tokens=4)
    eng.submit(req)
    eng.run_until_drained()
    assert req.done and len(req.generated) == 4

    cache = model.init_cache(batch_size=1, max_seq=32, dtype=torch.float32,
                             device="cpu")
    toks = list(prompt)
    out = []
    for t in range(len(prompt) + 3):
        logits, cache = model.decode_step(params, cache,
                                          torch.tensor([[toks[t]]]))
        if t >= len(prompt) - 1:
            nxt = int(logits[0].argmax())
            out.append(nxt)
            if len(toks) <= t + 1:
                toks.append(nxt)
        if len(out) == 4:
            break
    assert req.generated == out


def test_concurrent_mixed_length_requests(starcoder):
    eng = starcoder.engine(slots=2, max_seq=48, eos_id=-1)
    reqs = [Request(rid=i, prompt=[i + 1] * (3 + 2 * i), max_new_tokens=3)
            for i in range(4)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats.completed == 4
    assert all(r.done and len(r.generated) == 3 for r in reqs)
    assert stats.admitted == 4          # slot reuse: more requests than slots


def test_isolation_between_slots(starcoder):
    """A request's output must not depend on its co-resident slotmate."""
    eng1 = starcoder.engine(slots=2, max_seq=32, eos_id=-1)
    req_a = Request(rid=0, prompt=[7, 8, 9], max_new_tokens=3)
    eng1.submit(Request(rid=9, prompt=[1] * 10, max_new_tokens=2))
    eng1.submit(req_a)
    eng1.run_until_drained()

    eng2 = starcoder.engine(slots=2, max_seq=32, eos_id=-1)
    req_b = Request(rid=0, prompt=[7, 8, 9], max_new_tokens=3)
    eng2.submit(req_b)
    eng2.run_until_drained()
    assert req_a.generated == req_b.generated


# ------------------------------------------------------- reset_slot


@pytest.mark.parametrize("arch", ["gemma3-1b", "starcoder2-7b",
                                  "deepseek-v2-lite-16b", "rwkv6-7b",
                                  "hymba-1.5b"])
def test_reset_slot_matches_reference(arch):
    """After a prefill and two slotted decode steps, reset slot 1: the
    list layout (gemma3, hymba) and the stacked one (starcoder2, rwkv6,
    deepseek with its unstacked prefix) against the reference's."""
    pair = Pair(arch, seed=3)
    rm, m = pair.rm, pair.m
    tokens = np.random.default_rng(4).integers(0, pair.cfg.vocab_size,
                                               (3, 12))
    rc = rm.init_cache(batch_size=3, max_seq=24, dtype=jnp.float32)
    c = m.init_cache(batch_size=3, max_seq=24, dtype=torch.float32,
                     device="cpu")
    _, rc = jax.jit(rm.prefill)(pair.rparams,
                                {"tokens": jnp.asarray(tokens[:, :8])}, rc)
    _, c = m.prefill(pair.params, {"tokens": torch.from_numpy(tokens[:, :8])},
                     c)
    rc = rm.enable_slots(rc, 3)
    c = m.enable_slots(c, 3)
    rc["slot_pos"] = jnp.asarray([8, 8, 8], jnp.int32)
    c["slot_pos"][:] = 8
    decode = jax.jit(rm.decode_step)
    for t in (8, 9):
        _, rc = decode(pair.rparams, rc, jnp.asarray(tokens[:, t:t + 1]))
        _, c = m.decode_step(pair.params, c,
                             torch.from_numpy(tokens[:, t:t + 1]))
    layout = "list" if "list" in c else "stack"
    assert layout == ("list" if arch in ("gemma3-1b", "hymba-1.5b")
                      else "stack")
    rc = jax.jit(rm.reset_slot, static_argnums=1)(rc, 1)
    c = m.reset_slot(c, 1)
    got, ref = params_to_numpy(c), jax.tree.map(np.asarray, rc)
    tree_close(got, ref)
    assert int(got["slot_pos"][1]) == 0 and int(got["slot_pos"][0]) == 10


# ----------------------------------------------------------- example


def test_serve_lm_example_matches_reference_script(monkeypatch, capsys):
    """Both scripts on the reference's init_params(key(0)) weights: the
    same completed count, step count and tokens of the first three
    requests."""
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    runpy.run_path(str(REPO / "examples" / "serve_lm.py"),
                   run_name="__main__")
    ref_out = capsys.readouterr().out

    def carried(generator, specs, dtype, device):
        rp = ref_init(jax.random.key(0),
                      ref_build(ref_config("starcoder2-7b",
                                           smoke=True)).param_specs(),
                      dtype=jnp.float32)
        return params_from_numpy(jax.tree.map(np.asarray, rp),
                                 device=device, dtype=dtype)

    monkeypatch.setattr(serve_lm, "init_params", carried)
    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out

    def summary(text):
        lines = text.splitlines()
        done = next(ln for ln in lines if ln.startswith("completed"))
        reqs = [ln for ln in lines if ln.startswith("  req ")]
        layout = next(ln for ln in lines if ln.startswith("engine:"))
        return layout, done.split(" (")[0], reqs

    assert summary(out) == summary(ref_out)
    assert summary(out)[1] == "completed 10/10 requests in 37 engine steps"
    assert len(summary(out)[2]) == 3
    tokens = next(ln for ln in out.splitlines() if ln.startswith("tokens:"))
    assert tokens.startswith("tokens: prefill=50 decode=80 (")
    assert tokens.endswith("tok/s on cpu)")


# ------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pair_name", ["starcoder", "gemma"])
def test_engine_on_the_card_matches_the_cpu(cuda_device, pair_name,
                                            request):
    """The engine on the card (its default device) serves the requests of
    the reference comparison with the CPU engine's tokens and stats."""
    pair = request.getfixturevalue(pair_name)
    kw = dict(slots=3, max_seq=64, eos_id=-1)
    cpu = pair.engine(**kw)
    card = ContinuousBatchingEngine(
        pair.m, params_from_numpy(params_to_numpy(pair.params)), **kw)
    assert card.device.type == "cuda"
    runs = []
    for eng in (cpu, card):
        reqs = _requests(Request, pair.cfg.vocab_size, 8, seed=1)
        for r in reqs:
            eng.submit(r)
        runs.append((eng.run_until_drained(), [r.generated for r in reqs]))
    assert dataclasses.asdict(runs[1][0]) == dataclasses.asdict(runs[0][0])
    assert runs[1][1] == runs[0][1]
