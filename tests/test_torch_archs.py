"""The ten architectures of the port (repro_torch.configs, .models) against
the reference's at `smoke()` size, on the CPU.

Each case builds the reference's float32 parameters with its own
`init_params(jax.random.key(2), ...)`, carries them into the port with
`params_from_numpy`, and runs the same tokens through both.  Tolerances:

* whole-model logits and cache tensors in float32: rtol 1e-4 with an
  absolute floor of 1e-4 times max(1, max|ref|); greedy tokens (argmax)
  and integer cache entries (kv_pos, index) equal;
* bfloat16 parameters: not elementwise.  Rounding to bf16 after every
  op (torch) or once per fusion (XLA) takes different paths: on whisper
  the reference's own bf16 logits are 48 % of the logit scale off its
  float32 logits at worst.  So the port's bf16 logits must be as close to
  the reference's float32 logits as the reference's bf16 logits are: the
  largest and the root-mean-square error each within BF16_FACTOR = 1.25
  times the reference's;
* decode against the port's own forward: rtol/atol 5e-3, the reference
  test's (tests/models/test_archs_smoke.py).

The reference's model functions run jitted, as its serving engine runs
them; one reference run per architecture is shared by the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.configs.base import params_in_millions as ref_millions
from repro.models.common import init_params as ref_init
from repro.models.registry import build as ref_build
from repro_torch.configs import ARCH_IDS as PORT_ARCH_IDS
from repro_torch.configs import get_config
from repro_torch.configs.base import params_in_millions
from repro_torch.models.common import (ParamSpec, init_params, init_std,
                                       param_count, params_from_numpy,
                                       params_to_numpy, tree_leaves)
from repro_torch.models.registry import build

RTOL = ATOL = 1e-4
BF16_FACTOR = 1.25
B, S = 2, 32                 # forward batch
PREFILL, STEPS = 20, 6       # prefill past the 16-slot window, then wrap
MAX_SEQ = 32


def close(got, ref, tol=RTOL, what=""):
    ref = np.asarray(ref, dtype=np.float64)
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().float()
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                               err_msg=what)


def tree_close(got, ref, path="cache"):
    """A port cache tree (NumPy leaves, ints for `index`) against the
    reference's, key by key.  The port's `index` is one int where the
    reference's stacked layout carries one equal copy per layer."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, sorted(got), sorted(ref))
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
            close(got, ref, what=path)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _batch(cfg, tokens, seed=5):
    """The same batch for both packages: tokens, whisper's frames, and
    qwen2-vl's three distinct M-RoPE position streams."""
    b, s = tokens.shape
    ref = {"tokens": jnp.asarray(tokens, jnp.int32)}
    port = {"tokens": torch.from_numpy(tokens)}
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        frames = rng.standard_normal(
            (b, cfg.enc_dec.enc_seq, cfg.d_model)).astype(np.float32)
        ref["frames"] = jnp.asarray(frames)
        port["frames"] = torch.from_numpy(frames)
    if cfg.mrope_sections:
        mr = rng.integers(0, 64, (3, b, s))
        ref["mrope_positions"] = jnp.asarray(mr, jnp.int32)
        port["mrope_positions"] = torch.from_numpy(mr)
    return ref, port


class Case:
    """One architecture: the reference's parameters, model and runs, and
    the port's model on the carried parameters."""

    def __init__(self, arch):
        self.arch = arch
        self.rcfg = ref_config(arch, smoke=True)
        self.cfg = get_config(arch, smoke=True)
        self.rm, self.m = ref_build(self.rcfg), build(self.cfg)
        self.rparams = ref_init(jax.random.key(2), self.rm.param_specs(),
                                dtype=jnp.float32)
        self.host = jax.tree.map(np.asarray, self.rparams)
        self.params = params_from_numpy(self.host, device="cpu")
        self.tokens = _tokens(self.cfg, B, S + STEPS, seed=3)
        self.rbatch, self.pbatch = _batch(self.cfg, self.tokens[:, :S])
        self.rlogits, self.raux = jax.jit(self.rm.forward)(self.rparams,
                                                           self.rbatch)
        self._trace = None

    def reference_trace(self):
        """Logits and cache of the reference after prefill (or whisper's
        start_cache) and after each decode step."""
        if self._trace is None:
            rm, rp = self.rm, self.rparams
            cache = rm.init_cache(batch_size=B, max_seq=MAX_SEQ,
                                  dtype=jnp.float32)
            trace = []
            if self.cfg.is_encdec:
                cache = jax.jit(rm.start_cache)(rp, self.rbatch["frames"],
                                                cache)
                start = 0
            else:
                lg, cache = jax.jit(rm.prefill)(
                    rp, {"tokens": jnp.asarray(self.tokens[:, :PREFILL])},
                    cache)
                start = PREFILL
            trace.append((None if self.cfg.is_encdec else np.asarray(lg),
                          jax.tree.map(np.asarray, cache)))
            decode = jax.jit(rm.decode_step)
            for t in range(start, start + STEPS):
                lg, cache = decode(rp, cache,
                                   jnp.asarray(self.tokens[:, t:t + 1]))
                trace.append((np.asarray(lg),
                              jax.tree.map(np.asarray, cache)))
            self._trace = trace
        return self._trace


@pytest.fixture(scope="module", params=ARCH_IDS)
def case(request):
    return Case(request.param)


def _spec_tree(specs):
    if isinstance(specs, ParamSpec) or type(specs).__name__ == "ParamSpec":
        return (tuple(specs.shape), tuple(specs.axes), specs.init,
                specs.scale)
    if isinstance(specs, dict):
        return {k: _spec_tree(v) for k, v in specs.items()}
    return [_spec_tree(v) for v in specs]


# ------------------------------------------------------------- configs


def test_arch_ids_and_configs_equal_the_reference():
    assert PORT_ARCH_IDS == ARCH_IDS
    for arch in ARCH_IDS:
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(arch, smoke)) == \
                dataclasses.asdict(ref_config(arch, smoke)), (arch, smoke)
    with pytest.raises(KeyError):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_on_full_and_smoke_configs(arch):
    for smoke in (False, True):
        rspecs = ref_build(ref_config(arch, smoke)).param_specs()
        specs = build(get_config(arch, smoke)).param_specs()
        assert _spec_tree(specs) == _spec_tree(rspecs)
    assert param_count(build(get_config(arch)).param_specs()) == \
        sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
            ref_build(ref_config(arch)).param_specs(),
            is_leaf=lambda x: hasattr(x, "axes")))
    assert params_in_millions(get_config(arch)) == \
        ref_millions(ref_config(arch))


# ------------------------------------------------------------- forward


def test_forward_logits_and_aux(case):
    logits, aux = case.m.forward(case.params, case.pbatch)
    assert logits.dtype == torch.float32
    close(logits, case.rlogits, what=f"{case.arch} logits")
    close(torch.as_tensor(aux), case.raux, what=f"{case.arch} aux")
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(case.rlogits).argmax(-1))


def test_prefill_decode_logits_and_cache(case):
    """Prefill (or whisper's start_cache), then decode steps that wrap the
    local layers' ring: logits and the whole cache tree, step by step."""
    m, p, cfg = case.m, case.params, case.cfg
    cache = m.init_cache(batch_size=B, max_seq=MAX_SEQ, dtype=torch.float32,
                         device="cpu")
    trace = case.reference_trace()
    if cfg.is_encdec:
        cache = m.start_cache(p, case.pbatch["frames"], cache)
        start = 0
    else:
        lg, cache = m.prefill(p, {"tokens": torch.from_numpy(
            case.tokens[:, :PREFILL])}, cache)
        close(lg, trace[0][0], what=f"{case.arch} prefill logits")
        start = PREFILL
    tree_close(params_to_numpy(cache), trace[0][1], f"{case.arch} cache@0")
    for i, t in enumerate(range(start, start + STEPS), 1):
        lg, cache = m.decode_step(p, cache, torch.from_numpy(
            case.tokens[:, t:t + 1]))
        close(lg, trace[i][0], what=f"{case.arch} step {i} logits")
        np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                      trace[i][0].argmax(-1))
        tree_close(params_to_numpy(cache), trace[i][1],
                   f"{case.arch} cache@{i}")


@pytest.mark.parametrize("case", ["gemma3-1b", "whisper-small",
                                  "starcoder2-7b"], indirect=True)
def test_bf16_forward(case):
    """The reference's init in bf16 is its float32 draw cast, so both
    packages take the carried float32 parameters cast to bf16 (and bf16
    frames for whisper, as tests/models/test_archs_smoke.py feeds).  Three
    archs: a list and a stacked layout, rms and layernorm, the enc-dec."""
    rp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), case.rparams)
    p = params_from_numpy(case.host, device="cpu", dtype=torch.bfloat16)
    rb, pb = dict(case.rbatch), dict(case.pbatch)
    if case.cfg.is_encdec:
        rb["frames"] = rb["frames"].astype(jnp.bfloat16)
        pb["frames"] = pb["frames"].to(torch.bfloat16)
    rl, _ = jax.jit(case.rm.forward)(rp, rb)
    logits, _ = case.m.forward(p, pb)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    f32 = np.asarray(case.rlogits, np.float64)

    def errors(x):
        d = np.asarray(x, np.float64) - f32
        return np.abs(d).max(), np.sqrt(np.mean(d ** 2))

    (ref_max, ref_rms), (got_max, got_rms) = errors(rl), errors(logits)
    assert got_max <= BF16_FACTOR * ref_max, (case.arch, got_max, ref_max)
    assert got_rms <= BF16_FACTOR * ref_rms, (case.arch, got_rms, ref_rms)


# ------------------------------------------ port-only checks of decode


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "whisper-small"])
def test_decode_matches_forward(arch):
    """The reference test's check on the port: greedy decode through the
    cache equals the teacher-forced forward (MoE at non-binding
    capacity, as there)."""
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    model = build(cfg)
    params = init_params(torch.Generator().manual_seed(2),
                         model.param_specs(), torch.float32, device="cpu")
    b, s = 2, 8
    tokens = torch.from_numpy(_tokens(cfg, b, s, seed=3))
    batch = {"tokens": tokens}
    if cfg.mrope_sections:
        pos = torch.arange(s)[None].expand(b, s)
        batch["mrope_positions"] = pos[None].expand(3, b, s)
    full, _ = model.forward(params, batch)
    cache = model.init_cache(batch_size=b, max_seq=s + 4,
                             dtype=torch.float32, device="cpu")
    steps = []
    for t in range(s):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        steps.append(lg)
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=5e-3,
                               atol=5e-3)


def test_whisper_decode_matches_forward():
    cfg = get_config("whisper-small", smoke=True)
    model = build(cfg)
    params = init_params(torch.Generator().manual_seed(2),
                         model.param_specs(), torch.float32, device="cpu")
    b, s = 2, 8
    tokens = torch.from_numpy(_tokens(cfg, b, s, seed=3))
    frames = torch.randn(b, cfg.enc_dec.enc_seq, cfg.d_model,
                         generator=torch.Generator().manual_seed(4))
    full, _ = model.forward(params, {"tokens": tokens, "frames": frames})
    cache = model.init_cache(batch_size=b, max_seq=s + 4,
                             dtype=torch.float32, device="cpu")
    cache = model.start_cache(params, frames, cache)
    steps = []
    for t in range(s):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        steps.append(lg)
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=5e-3,
                               atol=5e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_own_init_params(arch, dtype):
    """The port's init_params: every leaf's shape and dtype, zeros and
    ones exact, and each random leaf's sample std within 6 standard
    errors (6 / sqrt(2 n) relative) of the reference's target."""
    specs = build(get_config(arch, smoke=True)).param_specs()
    params = init_params(torch.Generator().manual_seed(0), specs, dtype,
                         device="cpu")
    is_spec = lambda x: isinstance(x, ParamSpec)         # noqa: E731
    leaves = tree_leaves(params)
    spec_leaves = tree_leaves(specs, is_spec)
    assert len(leaves) == len(spec_leaves)
    for t, s in zip(leaves, spec_leaves):
        assert tuple(t.shape) == s.shape and t.dtype == dtype
        if s.init in ("zeros", "ones"):
            assert bool((t == (s.init == "ones")).all())
            continue
        n = t.numel()
        band = 6 / np.sqrt(2 * n)
        assert abs(t.float().std().item() / init_std(s) - 1) < band, \
            (arch, s, t.float().std().item(), init_std(s))


def test_forward_blockwise_attention_matches():
    """gemma3 with a KV chunk of 8: the forward's local and global layers
    take the online-softmax branch (32 tokens), and so does decode over
    a 32-slot global cache."""
    rcfg = dataclasses.replace(ref_config("gemma3-1b", smoke=True),
                               attn_kv_chunk=8)
    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                              attn_kv_chunk=8)
    rm, m = ref_build(rcfg), build(cfg)
    rp = ref_init(jax.random.key(5), rm.param_specs(), dtype=jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    tokens = _tokens(cfg, B, S, seed=6)
    rl, _ = jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(tokens)})
    logits, _ = m.forward(p, {"tokens": torch.from_numpy(tokens)})
    close(logits, rl, what="gemma3 kv_chunk=8 logits")
    rc = rm.init_cache(batch_size=B, max_seq=32, dtype=jnp.float32)
    c = m.init_cache(batch_size=B, max_seq=32, dtype=torch.float32,
                     device="cpu")
    decode = jax.jit(rm.decode_step)
    for t in range(4):
        rlg, rc = decode(rp, rc, jnp.asarray(tokens[:, t:t + 1]))
        lg, c = m.decode_step(p, c, torch.from_numpy(tokens[:, t:t + 1]))
        close(lg, rlg, what=f"gemma3 kv_chunk=8 step {t}")
    tree_close(params_to_numpy(c), jax.tree.map(np.asarray, rc))


def test_embeds_replace_token_lookup():
    """qwen2-vl's patch embeddings passed as `embeds`."""
    rcfg, cfg = ref_config("qwen2-vl-7b", smoke=True), \
        get_config("qwen2-vl-7b", smoke=True)
    rm, m = ref_build(rcfg), build(cfg)
    rp = ref_init(jax.random.key(7), rm.param_specs(), dtype=jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    emb = np.random.default_rng(8).standard_normal(
        (B, 12, cfg.d_model)).astype(np.float32)
    rl, _ = jax.jit(rm.forward)(rp, {"embeds": jnp.asarray(emb)})
    logits, _ = m.forward(p, {"embeds": torch.from_numpy(emb)})
    close(logits, rl, what="qwen2-vl embeds logits")


# ------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_card_matches_the_cpu(cuda_device, arch):
    """The same weights and tokens on the card and on the CPU: forward
    logits, then prefill (or start_cache) and decode steps with their
    caches, within the float32 tolerance above (TF32 off)."""
    cfg = get_config(arch, smoke=True)
    model = build(cfg)
    host = init_params(torch.Generator().manual_seed(2),
                       model.param_specs(), torch.float32, device="cpu")
    card = params_from_numpy(params_to_numpy(host), device=cuda_device)
    tokens = torch.from_numpy(_tokens(cfg, B, PREFILL + STEPS, seed=3))
    _, batch = _batch(cfg, tokens[:, :PREFILL].numpy())
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for params, dev in ((host, "cpu"), (card, cuda_device)):
            b = {k: v.to(dev) for k, v in batch.items()}
            logits, _ = model.forward(params, b)
            cache = model.init_cache(batch_size=B, max_seq=MAX_SEQ,
                                     dtype=torch.float32, device=dev)
            if cfg.is_encdec:
                cache = model.start_cache(params, b["frames"], cache)
                start = 0
            else:
                _, cache = model.prefill(params, {"tokens": b["tokens"]},
                                         cache)
                start = PREFILL
            steps = []
            for t in range(start, start + STEPS):
                lg, cache = model.decode_step(
                    params, cache, tokens[:, t:t + 1].to(dev))
                steps.append(lg)
            runs.append((logits, torch.stack(steps, 1),
                         params_to_numpy(cache)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (cpu_logits, cpu_steps, cpu_cache), (logits, steps, cache) = runs
    close(logits, cpu_logits.numpy(), what=f"{arch} card forward")
    close(steps, cpu_steps.numpy(), what=f"{arch} card decode")
    tree_close(cache, cpu_cache, f"{arch} card cache")
