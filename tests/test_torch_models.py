"""The port's LM layers (repro_torch.models.{common,attention,moe,ssm})
against the reference's (repro.models.*), on the CPU.

Every case draws its inputs from a seed with NumPy, runs them through
both packages and compares.  Tolerance of a single layer in float32:
rtol 1e-5 and an absolute floor of 1e-6 times the reference's largest
magnitude (at least 1e-6): XLA's exp and tanh on the CPU are fast
approximations, about 1e-7 relative, where torch's are exact to 1e-10.
Integer and boolean results (masks, dispatch one-hots, top-k choices)
must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm

RTOL = 1e-5
ATOL = 1e-6


def close(got, ref, rtol=RTOL, atol=ATOL):
    """`got` (a tensor) against `ref` (a JAX/NumPy array) within rtol and
    an absolute floor of atol times max(1, max|ref|)."""
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * scale)


def jref(fn, *args, **kwargs):
    """The reference's `fn`, jitted (as its engine runs it): arrays and
    dicts of arrays are traced, every other argument is static."""
    def dynamic(v):
        return isinstance(v, (jax.Array, dict))
    pos = [i for i, a in enumerate(args) if dynamic(a)]
    dyn = {k: v for k, v in kwargs.items() if dynamic(v)}
    static = {k: v for k, v in kwargs.items() if k not in dyn}

    def call(arrays, dyn_kwargs):
        full = list(args)
        for i, a in zip(pos, arrays):
            full[i] = a
        return fn(*full, **dyn_kwargs, **static)
    return jax.jit(call)([args[i] for i in pos], dyn)


def rnd(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(*arrays):
    """The same arrays as JAX arrays and as torch tensors."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


# ------------------------------------------------------------ common


class TestNormsAndActivations:
    @pytest.mark.parametrize("plus_one", [False, True])
    def test_rms_norm(self, plus_one):
        (x, s), (tx, ts) = both(rnd(0, (2, 5, 24), 3.0), rnd(1, (24,)))
        close(t_common.rms_norm(tx, ts, plus_one=plus_one),
              jref(r_common.rms_norm, x, s, plus_one=plus_one))

    @pytest.mark.parametrize("plus_one,with_bias", [(False, True),
                                                    (True, True),
                                                    (False, False)])
    def test_layer_norm(self, plus_one, with_bias):
        (x, s, b), (tx, ts, tb) = both(rnd(2, (2, 5, 24), 2.0) + 1.5,
                                       rnd(3, (24,)), rnd(4, (24,)))
        close(t_common.layer_norm(tx, ts, tb if with_bias else None,
                                  plus_one=plus_one),
              jref(r_common.layer_norm, x, s, b if with_bias else None,
                   plus_one=plus_one))

    @pytest.mark.parametrize("kind", ["rms", "layernorm", "layernorm1p"])
    def test_apply_norm_and_spec(self, kind):
        spec_r = r_common.norm_spec(16, kind)
        spec_t = t_common.norm_spec(16, kind)
        assert {k: (v.shape, v.axes, v.init) for k, v in spec_t.items()} == \
            {k: (v.shape, v.axes, v.init) for k, v in spec_r.items()}
        p = {k: rnd(5 + i, (16,)) for i, k in enumerate(sorted(spec_r))}
        x = rnd(9, (3, 4, 16), 2.0)
        close(t_common.apply_norm(torch.from_numpy(x),
                                  {k: torch.from_numpy(v)
                                   for k, v in p.items()}, kind),
              jref(r_common.apply_norm, jnp.asarray(x),
                   {k: jnp.asarray(v) for k, v in p.items()},
                   kind))
        with pytest.raises(ValueError):
            t_common.apply_norm(torch.from_numpy(x), p, "batchnorm")

    @pytest.mark.parametrize("name", sorted(r_common.ACTIVATIONS))
    def test_activations(self, name):
        assert set(t_common.ACTIVATIONS) == set(r_common.ACTIVATIONS)
        x = rnd(10, (4, 64), 4.0)
        close(t_common.ACTIVATIONS[name](torch.from_numpy(x)),
              jref(r_common.ACTIVATIONS[name], jnp.asarray(x)))

    def test_gelu_is_the_tanh_form(self):
        # The exact erf GELU, torch's default, differs from the reference
        # by more than the tolerance: the port must not use it.
        x = torch.from_numpy(rnd(11, (256,), 3.0))
        ref = jref(r_common.ACTIVATIONS["gelu"], jnp.asarray(x.numpy()))
        exact = torch.nn.functional.gelu(x)
        assert np.abs(exact.numpy() - np.asarray(ref)).max() > 1e-4
        close(t_common.ACTIVATIONS["gelu"](x), ref)


class TestSpecsAndTrees:
    def test_param_spec_rejects_mismatched_axes(self):
        with pytest.raises(ValueError):
            t_common.ParamSpec((2, 3), ("embed",))

    def test_stack_count_axes_shapes_sharding(self):
        def specs(mod):
            return {"a": mod.ParamSpec((8, 4), ("embed", "mlp")),
                    "b": [mod.ParamSpec((4,), ("act_embed",), "ones")],
                    "c": {"d": mod.ParamSpec((2, 3, 5), ("embed", None,
                                                         "vocab"), "small")}}
        rs = r_common.stack_specs(specs(r_common), 3)
        ts = t_common.stack_specs(specs(t_common), 3)
        assert t_common.param_count(ts) == r_common.param_count(rs)
        assert t_common.param_axes(ts) == r_common.param_axes(rs)
        shapes = t_common.param_shapes(ts, torch.float32)
        assert shapes["c"]["d"].shape == (3, 2, 3, 5)
        assert shapes["c"]["d"].device.type == "meta"
        rshard = r_common.param_sharding(rs, r_common.DEFAULT_RULES)
        tshard = t_common.param_sharding(ts, t_common.DEFAULT_RULES)
        assert tshard["a"] == tuple(rshard["a"])
        assert tshard["c"]["d"] == tuple(rshard["c"]["d"])

    def test_rules_table_and_resolve(self):
        assert t_common.DEFAULT_RULES == r_common.DEFAULT_RULES
        axes = ("batch", None, "act_heads", None)
        assert t_common.resolve(t_common.DEFAULT_RULES, axes) == \
            tuple(r_common.resolve(r_common.DEFAULT_RULES, axes))
        with pytest.raises(KeyError):
            t_common.resolve(t_common.DEFAULT_RULES, ("nope",))

    def test_logical_constraint_is_identity(self):
        x = torch.ones(2, 3)
        assert t_common.logical_constraint(
            x, t_common.DEFAULT_RULES, "batch", "act_embed") is x
        with pytest.raises(KeyError):
            t_common.logical_constraint(x, t_common.DEFAULT_RULES, "nope")

    def test_params_round_trip_and_bf16(self):
        tree = {"w": jnp.asarray(rnd(12, (3, 4))),
                "l": [jnp.asarray(rnd(13, (2,))).astype(jnp.bfloat16)],
                "i": jnp.arange(3, dtype=jnp.int32)}
        host = jax.tree.map(np.asarray, tree)
        p = t_common.params_from_numpy(host, device="cpu")
        assert p["w"].dtype == torch.float32
        assert p["l"][0].dtype == torch.bfloat16
        assert p["i"].dtype == torch.int32
        back = t_common.params_to_numpy(p)
        np.testing.assert_array_equal(back["w"], host["w"])
        np.testing.assert_array_equal(back["l"][0],
                                      host["l"][0].astype(np.float32))
        cast = t_common.params_from_numpy(host, device="cpu",
                                          dtype=torch.bfloat16)
        assert cast["w"].dtype == torch.bfloat16
        assert cast["i"].dtype == torch.int32

    def test_init_params_distributions(self):
        specs = {"n": t_common.ParamSpec((64, 512), ("embed", "mlp")),
                 "s": t_common.ParamSpec((16, 8, 256), ("embed", None,
                                                        None), "small"),
                 "e": t_common.ParamSpec((512, 64), ("vocab", "embed"),
                                         "embed", 0.5),
                 "z": t_common.ParamSpec((7,), ("act_embed",), "zeros"),
                 "o": t_common.ParamSpec((7,), ("act_embed",), "ones")}
        g = torch.Generator().manual_seed(0)
        p = t_common.init_params(g, specs, torch.float32, device="cpu")
        # 32k draws: the sample std is within 2 % of the target's.
        for k, want in (("n", 1 / 8), ("s", 1 / np.sqrt(128)),
                        ("e", 0.5 / 8)):
            assert p[k].shape == specs[k].shape
            assert abs(p[k].std().item() / want - 1) < 0.02, k
        assert torch.equal(p["z"], torch.zeros(7))
        assert torch.equal(p["o"], torch.ones(7))
        again = t_common.init_params(torch.Generator().manual_seed(0), specs,
                                     torch.float32, device="cpu")
        assert all(torch.equal(p[k], again[k]) for k in p)


# --------------------------------------------------------- attention


class TestRope:
    # Eager reference: under jit XLA rewrites theta ** freqs, and at
    # positions near 2000 the float32 angle (ulp 1.2e-4 rad there) moves
    # by more than the tolerance between the two compilations of the
    # reference itself.  Eager, the reference and the port agree.
    @pytest.mark.parametrize("rot_frac,theta", [(1.0, 1e4), (0.5, 1e4),
                                                (1.0, 1e6), (0.3, 1e5)])
    def test_apply_rope(self, rot_frac, theta):
        x = rnd(20, (2, 9, 3, 32))
        pos = np.random.default_rng(21).integers(0, 2000, (2, 9))
        (jx, jp), (tx, tp) = both(x, pos)
        close(t_attn.apply_rope(tx, tp, theta=theta, rot_frac=rot_frac),
              r_attn.apply_rope(jx, jp, theta=theta, rot_frac=rot_frac))

    def test_rope_table(self):
        pos = np.arange(0, 600, 7)
        s_r, c_r = r_attn.rope_table(jnp.asarray(pos), 64, 1e4)
        s_t, c_t = t_attn.rope_table(torch.from_numpy(pos), 64, 1e4)
        close(s_t, s_r)
        close(c_t, c_r)

    @pytest.mark.parametrize("sections,d", [((2, 3, 3), 16),
                                            ((16, 24, 24), 128)])
    def test_apply_mrope_distinct_streams(self, sections, d):
        # Three different position streams, so a slot that takes the wrong
        # component (or a transposed (d/2, B, S) layout) shows.
        x = rnd(22, (2, 6, 2, d))
        pos = np.random.default_rng(23).integers(0, 500, (3, 2, 6))
        (jx, jp), (tx, tp) = both(x, pos)
        close(t_attn.apply_mrope(tx, tp, sections, theta=1e6),
              r_attn.apply_mrope(jx, jp, sections, theta=1e6))

    def test_mrope_validates_sections(self):
        with pytest.raises(ValueError):
            t_attn.apply_mrope(torch.zeros(1, 2, 1, 16),
                               torch.zeros(3, 1, 2, dtype=torch.long),
                               (2, 2, 2))


class TestMask:
    @pytest.mark.parametrize("causal,window,with_len", [
        (True, None, False), (True, 3, False), (False, None, True),
        (True, 4, True), (False, 2, False)])
    def test_make_mask(self, causal, window, with_len):
        rng = np.random.default_rng(30)
        q_pos = rng.integers(0, 12, (2, 5))
        kv_pos = rng.integers(-1, 12, (2, 9))
        kv_len = rng.integers(1, 12, (2,))
        ref = jref(r_attn.make_mask, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                   causal=causal, window=window,
                   kv_len=jnp.asarray(kv_len) if with_len
                   else None)
        got = t_attn.make_mask(torch.from_numpy(q_pos),
                               torch.from_numpy(kv_pos), causal=causal,
                               window=window,
                               kv_len=torch.from_numpy(kv_len) if with_len
                               else None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _attention_case(seed, b, sq, skv, h, kh, d, dv, mask_kind):
    rng = np.random.default_rng(seed)
    q = rnd(seed, (b, sq, h, d))
    k = rnd(seed + 1, (b, skv, kh, d))
    v = rnd(seed + 2, (b, skv, kh, dv))
    if mask_kind == "causal":
        mask = np.tril(np.ones((sq, skv), bool), k=skv - sq)
        mask = np.broadcast_to(mask, (b, sq, skv)).copy()
    else:
        mask = rng.random((b, sq, skv)) < 0.6
    return q, k, v, mask


class TestGQAAttention:
    @pytest.mark.parametrize("case", [
        # (sq, skv, h, kh, d, dv, kv_chunk, q_chunk, mask): the plain
        # branch (no chunk; Skv <= chunk; Skv not divisible), the
        # online-softmax branch (Skv > chunk and divisible) and the
        # q-chunked branch (Sq > q_chunk, divisible, with kv_chunk set).
        (7, 7, 4, 2, 16, 16, None, 4096, "causal"),
        (5, 8, 4, 4, 8, 8, 8, 4096, "random"),
        (5, 12, 4, 2, 8, 8, 8, 4096, "random"),
        (6, 32, 4, 1, 16, 8, 8, 4096, "random"),
        (16, 16, 6, 3, 8, 8, 4, 4096, "causal"),
        (16, 24, 4, 2, 8, 8, 8, 4, "random"),
        (12, 12, 2, 1, 8, 8, 4, 4, "causal"),
    ])
    def test_branches_match(self, case):
        sq, skv, h, kh, d, dv, kv_chunk, q_chunk, mk = case
        q, k, v, m = _attention_case(40, 2, sq, skv, h, kh, d, dv, mk)
        (jq, jk, jv, jm), (tq, tk, tv, tm) = both(q, k, v, m)
        close(t_attn.gqa_attention(tq, tk, tv, tm, kv_chunk=kv_chunk,
                                   q_chunk=q_chunk),
              jref(r_attn.gqa_attention, jq, jk, jv, jm, kv_chunk=kv_chunk,
                   q_chunk=q_chunk))

    def test_softcap_and_scale(self):
        q, k, v, m = _attention_case(41, 2, 6, 16, 4, 2, 8, 8, "causal")
        (jq, jk, jv, jm), (tq, tk, tv, tm) = both(q * 4, k * 4, v, m)
        for chunk in (None, 4):
            close(t_attn.gqa_attention(tq, tk, tv, tm, softcap=5.0,
                                       scale=0.3, kv_chunk=chunk),
                  jref(r_attn.gqa_attention, jq, jk, jv, jm, softcap=5.0,
                       scale=0.3, kv_chunk=chunk))

    def test_fully_masked_chunks_contribute_zero(self):
        # kv_pos = -1 slots in whole chunks, as in an unfilled decode cache.
        q, k, v, m = _attention_case(42, 2, 1, 16, 4, 1, 8, 8, "random")
        m[:, :, 4:12] = False
        m[:, :, 0] = True
        (jq, jk, jv, jm), (tq, tk, tv, tm) = both(q, k, v, m)
        got = t_attn.gqa_attention(tq, tk, tv, tm, kv_chunk=4)
        close(got, jref(r_attn.gqa_attention, jq, jk, jv, jm, kv_chunk=4))
        # Garbage in the masked slots changes nothing.
        tk2, tv2 = tk.clone(), tv.clone()
        tk2[:, 4:12] = 1e4
        tv2[:, 4:12] = -1e4
        torch.testing.assert_close(
            t_attn.gqa_attention(tq, tk2, tv2, tm, kv_chunk=4), got,
            rtol=0, atol=0)

    def test_rejects_indivisible_heads(self):
        with pytest.raises(ValueError):
            t_attn.gqa_attention(torch.zeros(1, 2, 3, 4),
                                 torch.zeros(1, 2, 2, 4),
                                 torch.zeros(1, 2, 2, 4),
                                 torch.ones(1, 2, 2, dtype=torch.bool))

    def test_projections_and_qk_norm(self):
        x = rnd(43, (2, 5, 16))
        p = {"wq": rnd(44, (16, 4, 8)), "wk": rnd(45, (16, 2, 8)),
             "wv": rnd(46, (16, 2, 8)), "wo": rnd(47, (4, 8, 16)),
             "q_norm": rnd(48, (8,)), "k_norm": rnd(49, (8,))}
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        rq, rk, rv = jref(r_attn.qkv_project, jnp.asarray(x), jp)
        tq, tk, tv = t_attn.qkv_project(torch.from_numpy(x), tp)
        for got, ref in ((tq, rq), (tk, rk), (tv, rv)):
            close(got, ref)
        rqn, rkn = jref(r_attn.maybe_qk_norm, rq, rk, jp)
        tqn, tkn = t_attn.maybe_qk_norm(tq, tk, tp)
        close(tqn, rqn)
        close(tkn, rkn)
        close(t_attn.out_project(tq, tp), jref(r_attn.out_project, rq, jp))
        del tp["q_norm"]
        assert t_attn.maybe_qk_norm(tq, tk, tp) == (tq, tk)


class TestMLA:
    H, NOPE, ROPE, VD, LORA, D = 4, 8, 4, 8, 16, 32

    def _params(self):
        h, nope, rope, vd, lora, d = (self.H, self.NOPE, self.ROPE, self.VD,
                                      self.LORA, self.D)
        p = {"wq": rnd(50, (d, h, nope + rope), 0.2),
             "w_dkv": rnd(51, (d, lora), 0.2),
             "kv_norm": rnd(52, (lora,)) + 1.0,
             "w_kr": rnd(53, (d, rope), 0.2),
             "w_uk": rnd(54, (lora, h, nope), 0.2),
             "w_uv": rnd(55, (lora, h, vd), 0.2),
             "wo": rnd(56, (h, vd, d), 0.2)}
        return ({k: jnp.asarray(v) for k, v in p.items()},
                {k: torch.from_numpy(v) for k, v in p.items()})

    def _kw(self):
        return dict(num_heads=self.H, qk_nope=self.NOPE, qk_rope=self.ROPE,
                    v_dim=self.VD, rope_theta=1e4)

    @pytest.mark.parametrize("kv_chunk", [None, 4])
    def test_forward_without_cache(self, kv_chunk):
        jp, tp = self._params()
        x = rnd(57, (2, 8, self.D))
        pos = np.broadcast_to(np.arange(8), (2, 8)).copy()
        mask = np.tril(np.ones((8, 8), bool))[None].repeat(2, 0)
        (jx, jpos, jm), (tx, tpos, tm) = both(x, pos, mask)
        ro, _ = jref(r_attn.mla_forward, jx, jp, jpos, mask=jm,
                     kv_chunk=kv_chunk,
                     **self._kw())
        to, tc = t_attn.mla_forward(tx, tp, tpos, mask=tm, kv_chunk=kv_chunk,
                                    **self._kw())
        close(to, ro)
        assert tc == {}

    def test_cached_prefill_then_per_slot_decode(self):
        jp, tp = self._params()
        slots = 12
        rc = {"c_kv": jnp.zeros((2, slots, self.LORA)),
              "k_rope": jnp.zeros((2, slots, self.ROPE)),
              "index": jnp.zeros((), jnp.int32)}
        tc = {"c_kv": torch.zeros(2, slots, self.LORA),
              "k_rope": torch.zeros(2, slots, self.ROPE), "index": 0}
        x = rnd(58, (2, 6, self.D))
        kv_pos = np.broadcast_to(np.arange(slots), (2, slots))
        pos = np.broadcast_to(np.arange(6), (2, 6)).copy()
        mask = pos[:, :, None] >= kv_pos[:, None, :]
        (jx, jpos, jm), (tx, tpos, tm) = both(x, pos, mask)
        ro, rc = jref(r_attn.mla_forward, jx, jp, jpos, mask=jm, cache=rc,
                      **self._kw())
        to, tc = t_attn.mla_forward(tx, tp, tpos, mask=tm, cache=tc,
                                    **self._kw())
        close(to, ro)
        # One token per row at the rows' own positions (6 and 9).
        x1 = rnd(59, (2, 1, self.D))
        pos1 = np.array([[6], [9]])
        mask1 = pos1[:, :, None] >= kv_pos[:, None, :]
        (jx, jpos, jm), (tx, tpos, tm) = both(x1, pos1, mask1)
        ro, rc = jref(r_attn.mla_forward, jx, jp, jpos, mask=jm, cache=rc,
                      **self._kw())
        to, tc = t_attn.mla_forward(tx, tp, tpos, mask=tm, cache=tc,
                                    **self._kw())
        close(to, ro)
        close(tc["c_kv"], rc["c_kv"])
        close(tc["k_rope"], rc["k_rope"])
        assert tc["index"] == int(rc["index"]) == 7


# ---------------------------------------------------------------- moe

MOE = r_moe.MoEConfig(num_experts=8, top_k=2, expert_d_ff=16,
                      capacity_factor=2.0)


def _port_moe(cfg):
    return t_moe.MoEConfig(**dataclasses.asdict(cfg))


class TestMoE:
    @pytest.mark.parametrize("cfg,t", [
        (MOE, 32),
        (r_moe.MoEConfig(num_experts=2, top_k=1, expert_d_ff=8,
                         capacity_factor=0.25), 64),          # drops
        (r_moe.MoEConfig(num_experts=6, top_k=3, expert_d_ff=8,
                         normalize_weights=False, routed_scale=2.5), 20),
    ])
    def test_route_matches(self, cfg, t):
        logits = rnd(60, (t, cfg.num_experts), 2.0)
        rd, rcmb, raux = jref(r_moe.route, jnp.asarray(logits), cfg)
        td, tcmb, taux = t_moe.route(torch.from_numpy(logits), _port_moe(cfg))
        np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
        close(tcmb, rcmb)
        close(taux, raux)
        assert t_moe.capacity(t, _port_moe(cfg)) == r_moe.capacity(t, cfg)

    def test_capacity_drops_counted(self):
        cfg = r_moe.MoEConfig(num_experts=2, top_k=1, expert_d_ff=8,
                              capacity_factor=0.25)
        logits = rnd(61, (64, 2))
        td, _, _ = t_moe.route(torch.from_numpy(logits), _port_moe(cfg))
        rd, _, _ = jref(r_moe.route, jnp.asarray(logits), cfg)
        kept = float(td.sum())
        assert kept == float(rd.sum())
        assert kept <= 2 * t_moe.capacity(64, _port_moe(cfg))
        assert kept < 64                       # some assignments dropped

    def test_top_k_ties_go_to_the_lower_index(self):
        # Equal logits in groups: jax.lax.top_k takes the lower expert.
        logits = np.tile(np.array([0.0, 1.0, 1.0, 0.5, 1.0, 0.5, 0.0, 1.0],
                                  np.float32), (16, 1))
        rd, rcmb, _ = jref(r_moe.route, jnp.asarray(logits), MOE)
        td, tcmb, _ = t_moe.route(torch.from_numpy(logits), _port_moe(MOE))
        np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
        close(tcmb, rcmb)
        assert set(np.nonzero(td.numpy()[0].sum(-1))[0]) == {1, 2}

    def _params(self, cfg, d=16, seed=62):
        e, f = cfg.num_experts, cfg.expert_d_ff
        p = {"router": rnd(seed, (d, e), 0.5),
             "w_gate": rnd(seed + 1, (e, d, f), 0.1),
             "w_up": rnd(seed + 2, (e, d, f), 0.1),
             "w_down": rnd(seed + 3, (e, f, d), 0.1)}
        if cfg.num_shared:
            p["shared_gate"] = rnd(seed + 4, (d, cfg.shared_d_ff), 0.1)
            p["shared_up"] = rnd(seed + 5, (d, cfg.shared_d_ff), 0.1)
            p["shared_down"] = rnd(seed + 6, (cfg.shared_d_ff, d), 0.1)
        return ({k: jnp.asarray(v) for k, v in p.items()},
                {k: torch.from_numpy(v) for k, v in p.items()})

    @pytest.mark.parametrize("cfg,shape,group", [
        (MOE, (2, 16, 16), 2048),
        (r_moe.MoEConfig(num_experts=4, top_k=1, expert_d_ff=8,
                         num_shared=2, shared_d_ff=16), (2, 16, 16), 2048),
        (MOE, (2, 16, 16), 8),                  # four groups of 8 tokens
        (MOE, (3, 5, 16), 4),                   # odd: one group of 15
        (r_moe.MoEConfig(num_experts=2, top_k=1, expert_d_ff=8,
                         capacity_factor=0.25), (2, 32, 16), 2048),
    ])
    def test_moe_ffn_matches(self, cfg, shape, group):
        jp, tp = self._params(cfg)
        x = rnd(70, shape)
        for name in ("silu", "gelu"):
            ro, raux = jref(r_moe.moe_ffn, jnp.asarray(x), jp, cfg,
                            r_common.ACTIVATIONS[name],
                            group_size=group)
            to, taux = t_moe.moe_ffn(torch.from_numpy(x), tp, _port_moe(cfg),
                                     t_common.ACTIVATIONS[name],
                                     group_size=group)
            close(to, ro)
            close(taux, raux)
        assert t_moe.GROUP_SIZE == r_moe.GROUP_SIZE == 2048


# ---------------------------------------------------------------- ssm


def _wkv_inputs(seed, b=2, s=32, h=2, k=8, v=8, extreme=False):
    rng = np.random.default_rng(seed)
    r = rnd(seed, (b, s, h, k))
    kk = rnd(seed + 1, (b, s, h, k))
    vv = rnd(seed + 2, (b, s, h, v))
    lo, hi = (1e-5, 1.0) if extreme else (0.5, 0.999)
    w = rng.uniform(lo, hi, (b, s, h, k)).astype(np.float32)
    u = rnd(seed + 3, (h, k), 0.5)
    s0 = rnd(seed + 4, (b, h, k, v), 0.3)
    return r, kk, vv, w, u, s0


def _mamba_inputs(seed, b=2, s=32, e=8, n=4):
    rng = np.random.default_rng(seed)
    u = rnd(seed, (b, s, e))
    dt = rng.uniform(0.01, 0.5, (b, s, e)).astype(np.float32)
    A = -rng.uniform(0.1, 2.0, (e, n)).astype(np.float32)
    B = rnd(seed + 1, (b, s, n))
    C = rnd(seed + 2, (b, s, n))
    D = rnd(seed + 3, (e,))
    h0 = rnd(seed + 4, (b, e, n), 0.3)
    return u, dt, A, B, C, D, h0


class TestSSM:
    @pytest.mark.parametrize("fn", ["wkv6_scan", "wkv6_chunked"])
    @pytest.mark.parametrize("extreme", [False, True])
    def test_wkv6_forms_match_reference(self, fn, extreme):
        args = _wkv_inputs(80, extreme=extreme)
        jargs, targs = both(*args)
        ry, rs = jref(getattr(r_ssm, fn), *jargs)
        ty, ts = getattr(t_ssm, fn)(*targs)
        close(ty, ry)
        close(ts, rs)

    @pytest.mark.parametrize("fn", ["mamba_scan", "mamba_chunked"])
    def test_mamba_forms_match_reference(self, fn):
        jargs, targs = both(*_mamba_inputs(81))
        ry, rh = jref(getattr(r_ssm, fn), *jargs)
        ty, th = getattr(t_ssm, fn)(*targs)
        close(ty, ry)
        close(th, rh)

    def test_chunked_needs_whole_chunks(self):
        _, targs = both(*_wkv_inputs(82, s=20))
        with pytest.raises(ValueError):
            t_ssm.wkv6_chunked(*targs)
        _, margs = both(*_mamba_inputs(82, s=20))
        with pytest.raises(ValueError):
            t_ssm.mamba_chunked(*margs)

    @pytest.mark.parametrize("with_state", [False, True])
    @pytest.mark.parametrize("k", [1, 4])
    def test_causal_conv1d(self, with_state, k):
        x, w, b, st = rnd(83, (2, 7, 6)), rnd(84, (k, 6)), rnd(85, (6,)), \
            rnd(86, (2, k - 1, 6))
        (jx, jw, jb, jst), (tx, tw, tb, tst) = both(x, w, b, st)
        ro, rs = jref(r_ssm.causal_conv1d, jx, jw, jb,
                      jst if with_state else None)
        to, ts = t_ssm.causal_conv1d(tx, tw, tb, tst if with_state else None)
        close(to, ro)
        close(ts, rs)

    @pytest.mark.parametrize("prev_ndim", [None, 2, 3])
    def test_token_shift(self, prev_ndim):
        x = rnd(87, (2, 5, 4))
        prev = {None: None, 2: rnd(88, (2, 4)), 3: rnd(88, (2, 1, 4))}[
            prev_ndim]
        ref = jref(r_ssm.token_shift, jnp.asarray(x), None if prev is None
                   else jnp.asarray(prev))
        got = t_ssm.token_shift(torch.from_numpy(x), None if prev is None
                                else torch.from_numpy(prev))
        close(got, ref)

    def _rwkv_params(self, d=32, hs=8, rank=4):
        h = d // hs
        shapes = {"mu_x": (d,), "mu_r": (d,), "mu_k": (d,), "mu_v": (d,),
                  "mu_g": (d,), "mu_w": (d,), "ts_w1": (d, 5, rank),
                  "ts_w2": (5, rank, d), "w0": (d,), "w_lora_a": (d, rank),
                  "w_lora_b": (rank, d), "u": (h, hs), "wr": (d, h, hs),
                  "wk": (d, h, hs), "wv": (d, h, hs), "wg": (d, d),
                  "wo": (d, d), "gn_scale": (h, hs), "gn_bias": (h, hs)}
        p = {k: rnd(90 + i, s, 0.2) for i, (k, s) in
             enumerate(sorted(shapes.items()))}
        return ({k: jnp.asarray(v) for k, v in p.items()},
                {k: torch.from_numpy(v) for k, v in p.items()})

    @pytest.mark.parametrize("s,chunked,with_state", [
        (32, True, False), (32, False, True), (5, True, True),
        (1, True, True)])
    def test_rwkv6_time_mix(self, s, chunked, with_state):
        jp, tp = self._rwkv_params()
        x = rnd(110, (2, s, 32))
        st = {"shift": rnd(111, (2, 32)), "wkv": rnd(112, (2, 4, 8, 8), 0.3)}
        rst = {k: jnp.asarray(v) for k, v in st.items()} if with_state \
            else None
        tst = {k: torch.from_numpy(v) for k, v in st.items()} if with_state \
            else None
        ro, rs = jref(r_ssm.rwkv6_time_mix, jnp.asarray(x), jp, num_heads=4,
                      state=rst, chunked=chunked)
        to, ts = t_ssm.rwkv6_time_mix(torch.from_numpy(x), tp, num_heads=4,
                                      state=tst, chunked=chunked)
        close(to, ro)
        close(ts["wkv"], rs["wkv"])
        close(ts["shift"], rs["shift"])

    def test_rwkv6_channel_mix(self):
        d, f = 16, 24
        p = {"mu_k": rnd(120, (d,)), "mu_r": rnd(121, (d,)),
             "wk": rnd(122, (d, f), 0.3), "wv": rnd(123, (f, d), 0.3),
             "wr": rnd(124, (d, d), 0.3)}
        x = rnd(125, (2, 6, d))
        st = {"shift": rnd(126, (2, d))}
        for state in (None, st):
            rst = None if state is None else \
                {"shift": jnp.asarray(st["shift"])}
            ro, rs = jref(r_ssm.rwkv6_channel_mix, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in p.items()}, rst)
            to, ts = t_ssm.rwkv6_channel_mix(
                torch.from_numpy(x),
                {k: torch.from_numpy(v) for k, v in p.items()},
                None if state is None else
                {"shift": torch.from_numpy(st["shift"])})
            close(to, ro)
            close(ts["shift"], rs["shift"])

    def test_group_norm(self):
        y = rnd(127, (2, 3, 4, 8), 3.0) + 2.0
        s, b = rnd(128, (4, 8)), rnd(129, (4, 8))
        (jy, js, jb), (ty, ts, tb) = both(y, s, b)
        close(t_ssm._group_norm(ty, ts, tb),
              jref(r_ssm._group_norm, jy, js, jb))

    @pytest.mark.parametrize("s,chunked,with_state", [
        (32, True, False), (32, False, False), (7, True, True),
        (1, True, True)])
    def test_mamba_mixer(self, s, chunked, with_state):
        d, e, n, rank, k = 16, 16, 4, 4, 4
        shapes = {"in_proj": (d, 2 * e), "conv_w": (k, e), "conv_b": (e,),
                  "x_proj": (e, rank + 2 * n), "dt_proj": (rank, e),
                  "dt_bias": (e,), "A_log": (e, n), "D": (e,),
                  "out_proj": (e, d)}
        p = {key: rnd(130 + i, sh, 0.3) for i, (key, sh) in
             enumerate(sorted(shapes.items()))}
        x = rnd(150, (2, s, d))
        st = {"conv": rnd(151, (2, k - 1, e)), "ssm": rnd(152, (2, e, n))}
        ro, rs = jref(
            r_ssm.mamba_mixer, jnp.asarray(x),
            {kk: jnp.asarray(v) for kk, v in p.items()},
            state={kk: jnp.asarray(v) for kk, v in st.items()}
            if with_state else None, chunked=chunked)
        to, ts = t_ssm.mamba_mixer(
            torch.from_numpy(x), {kk: torch.from_numpy(v)
                                  for kk, v in p.items()},
            state={kk: torch.from_numpy(v) for kk, v in st.items()}
            if with_state else None, chunked=chunked)
        close(to, ro)
        close(ts["conv"], rs["conv"])
        close(ts["ssm"], rs["ssm"])
