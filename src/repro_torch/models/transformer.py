"""Unified decoder-only LM covering all assigned decoder architectures.

One implementation, configured entirely by `ModelConfig`:

  mixer:  GQA (full / sliding-window / M-RoPE / partial-RoPE / qk-norm /
          softcap), MLA (deepseek), RWKV6 (attn-free), Hymba (parallel
          attention + Mamba heads)
  ffn:    gated (swiglu/geglu) or plain (gelu/relu2) dense, or MoE with
          shared experts
  stack:  homogeneous archs keep stacked layer params (`layers`, a leading
          layer axis, the reference's scan_layers=True layout) and loop
          over its slices; heterogeneous archs (gemma3 5:1 local:global,
          hymba 3 global layers) keep a `layer_list` so each layer can own
          its window/cache size.

The decode path maintains a per-layer cache: GQA -> (k, v, kv_pos), with a
ring buffer of `window` slots for local layers; MLA -> compressed
(c_kv, k_rope); RWKV6/Mamba -> recurrent state (+ token-shift tail).
The cache's tensors are written in place (`decode_step`, `prefill` and
`reset_slot` return the same dict structure as the reference, holding
the same tensors): the caller's old cache is consumed.  Its `index`
entries are Python ints; the stacked layout keeps one `index` for the
stack where the reference carries one equal copy per layer.

`cfg.remat` decides what a backward pass through `forward` keeps, as
the reference's jax.checkpoint sites do: with any policy but "none" each
layer runs under `common.remat` (the unscanned list's layers and the
stacked layers; deepseek's dense prefix layers are not wrapped, as in the
reference), so its activations are recomputed in the backward pass
instead of being kept.  Remat changes memory, never values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (ACTIVATIONS, ParamSpec, apply_norm,
                                       first_tensor, logical_constraint,
                                       norm_spec, placed_grads, project,
                                       remat, stack_specs, take_rows,
                                       token_positions, tree_index,
                                       tree_unbind, write_columns_,
                                       write_rows_)
from repro_torch.models.moe import moe_ffn

REMAT_POLICIES = ("none", "save_boundaries", "full", "dots")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _gqa_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_qkv_bias:
        p["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), "zeros")
        p["bk"] = ParamSpec((kh, hd), ("kv_heads", "head_dim"), "zeros")
        p["bv"] = ParamSpec((kh, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        p["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    return p


def _mla_specs(cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope + m.qk_rope
    return {
        "wq": ParamSpec((d, h, qk), ("embed", "heads", "head_dim")),
        "w_dkv": ParamSpec((d, m.kv_lora), ("embed", "kv_lora")),
        "kv_norm": ParamSpec((m.kv_lora,), ("kv_lora",), "ones"),
        "w_kr": ParamSpec((d, m.qk_rope), ("embed", "head_dim")),
        "w_uk": ParamSpec((m.kv_lora, h, m.qk_nope),
                          ("kv_lora", "heads", "head_dim")),
        "w_uv": ParamSpec((m.kv_lora, h, m.v_dim),
                          ("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((h, m.v_dim, d), ("heads", "head_dim", "embed")),
    }


def _rwkv_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    r = cfg.rwkv
    h = d // r.head_size
    k = r.head_size

    def mu():
        return ParamSpec((d,), ("act_embed",), "zeros")

    return {
        "mu_x": mu(), "mu_r": mu(), "mu_k": mu(), "mu_v": mu(),
        "mu_g": mu(), "mu_w": mu(),
        "ts_w1": ParamSpec((d, 5, r.ts_rank), ("embed", None, None), "small"),
        "ts_w2": ParamSpec((5, r.ts_rank, d), (None, None, "act_embed"),
                           "small"),
        "w0": ParamSpec((d,), ("act_embed",), "zeros"),
        "w_lora_a": ParamSpec((d, r.decay_rank), ("embed", None), "small"),
        "w_lora_b": ParamSpec((r.decay_rank, d), (None, "act_embed"), "small"),
        "u": ParamSpec((h, k), ("heads", "head_dim"), "zeros"),
        "wr": ParamSpec((d, h, k), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, h, k), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, h, k), ("embed", "heads", "head_dim")),
        "wg": ParamSpec((d, d), ("embed", "mlp")),
        "wo": ParamSpec((d, d), ("mlp", "embed")),
        "gn_scale": ParamSpec((h, k), ("heads", "head_dim"), "ones"),
        "gn_bias": ParamSpec((h, k), ("heads", "head_dim"), "zeros"),
    }


def _rwkv_cmix_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), ("act_embed",), "zeros"),
        "mu_r": ParamSpec((d,), ("act_embed",), "zeros"),
        "wk": ParamSpec((d, f), ("embed", "mlp")),
        "wv": ParamSpec((f, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", "mlp")),
    }


def _mamba_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    m = cfg.mamba
    e = m.d_inner or d
    rank = m.dt_rank or max(1, math.ceil(d / 16))
    n = m.state_size
    return {
        "in_proj": ParamSpec((d, 2 * e), ("embed", "mlp")),
        "conv_w": ParamSpec((m.conv_kernel, e), ("conv", "act_mlp"), "small"),
        "conv_b": ParamSpec((e,), ("act_mlp",), "zeros"),
        "x_proj": ParamSpec((e, rank + 2 * n), ("mlp", None)),
        "dt_proj": ParamSpec((rank, e), (None, "act_mlp"), "small"),
        "dt_bias": ParamSpec((e,), ("act_mlp",), "ones"),
        "A_log": ParamSpec((e, n), ("mlp", "state"), "zeros"),
        "D": ParamSpec((e,), ("mlp",), "ones"),
        "out_proj": ParamSpec((e, d), ("mlp", "embed")),
    }


def _mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    gated = cfg.mlp in ("swiglu", "geglu")
    p = {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if gated:
        p["w_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return p


def _moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    m = cfg.moe
    f = m.expert_d_ff
    p = {
        "router": ParamSpec((d, m.num_experts), ("embed", None), "small"),
        "w_gate": ParamSpec((m.num_experts, d, f),
                            ("experts", "embed", "expert_mlp")),
        "w_up": ParamSpec((m.num_experts, d, f),
                          ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec((m.num_experts, f, d),
                            ("experts", "expert_mlp", "embed")),
    }
    if m.num_shared:
        fs = m.shared_d_ff
        p["shared_gate"] = ParamSpec((d, fs), ("embed", "mlp"))
        p["shared_up"] = ParamSpec((d, fs), ("embed", "mlp"))
        p["shared_down"] = ParamSpec((fs, d), ("mlp", "embed"))
    return p


def _layer_specs(cfg: ModelConfig, layer_idx: int) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": norm_spec(cfg.d_model, cfg.norm),
                         "ln2": norm_spec(cfg.d_model, cfg.norm)}
    if cfg.sandwich_norm:
        p["ln1_post"] = norm_spec(cfg.d_model, cfg.norm)
        p["ln2_post"] = norm_spec(cfg.d_model, cfg.norm)
    if cfg.mixer == "gqa":
        p["attn"] = _gqa_specs(cfg)
    elif cfg.mixer == "mla":
        p["attn"] = _mla_specs(cfg)
    elif cfg.mixer == "rwkv6":
        p["attn"] = _rwkv_specs(cfg)
    elif cfg.mixer == "hymba":
        p["attn"] = _gqa_specs(cfg)
        del p["attn"]["wo"]   # fuse_out projects the combined heads
        p["mamba"] = _mamba_specs(cfg)
        e = (cfg.mamba.d_inner or cfg.d_model)
        p["attn_out_norm"] = {"scale": ParamSpec((e,), ("act_mlp",), "ones")}
        p["mamba_out_norm"] = {"scale": ParamSpec((e,), ("act_mlp",), "ones")}
        p["fuse_out"] = ParamSpec((e, cfg.d_model), ("mlp", "embed"))
    else:
        raise ValueError(cfg.mixer)
    if cfg.mixer == "rwkv6":
        p["mlp"] = _rwkv_cmix_specs(cfg)
    elif cfg.moe is not None and layer_idx not in cfg.moe_dense_layers:
        p["mlp"] = _moe_specs(cfg)
    elif cfg.moe is not None:
        p["mlp"] = _mlp_specs(cfg, cfg.dense_d_ff or cfg.d_ff)
    else:
        p["mlp"] = _mlp_specs(cfg)
    return p


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           "embed"),
        "final_norm": norm_spec(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    if cfg.scan_layers and not cfg.moe_dense_layers:
        specs["layers"] = stack_specs(_layer_specs(cfg, -1), cfg.num_layers)
    elif cfg.scan_layers:
        # deepseek: dense prefix layers unstacked + homogeneous stacked rest.
        n_prefix = len(cfg.moe_dense_layers)
        specs["prefix_layers"] = [
            _layer_specs(cfg, i) for i in cfg.moe_dense_layers]
        specs["layers"] = stack_specs(
            _layer_specs(cfg, n_prefix), cfg.num_layers - n_prefix)
    else:
        specs["layer_list"] = [
            _layer_specs(cfg, i) for i in range(cfg.num_layers)]
    return specs


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _dense_mlp(x, p, cfg: ModelConfig):
    act = ACTIVATIONS["silu" if cfg.mlp == "swiglu" else
                      "gelu" if cfg.mlp in ("geglu", "gelu") else "relu2"]
    up = torch.einsum("bsd,df->bsf", x, p["w_up"])
    if "w_gate" in p:
        gate = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        h = act(gate) * up
    else:
        h = act(up)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])


def _ring_write(cache, k, v, pos):
    """Decode: slot b's token lands at pos[b] % slots, so mixed-progress
    sequences (continuous batching) coexist.  Writes `cache` in place."""
    slots = cache["k"].shape[1]
    write_at = pos[:, 0].long() % slots                            # (B,)
    write_rows_(cache["k"], write_at, k[:, 0].to(cache["k"].dtype))
    write_rows_(cache["v"], write_at, v[:, 0].to(cache["v"].dtype))
    write_rows_(cache["kv_pos"], write_at,
                pos[:, 0].to(cache["kv_pos"].dtype))


def _prefill_write(cache, k, v, pos, slot_idx):
    """Prefill: zero the cache and keep the last len(slot_idx) tokens at
    `slot_idx` (kv_pos -1 elsewhere).  Writes `cache` in place."""
    take = len(slot_idx)
    at = torch.from_numpy(slot_idx).to(k.device)
    b = k.shape[0]
    cache["k"].zero_()
    cache["v"].zero_()
    cache["kv_pos"].fill_(-1)
    write_columns_(cache["k"], at, k[:, -take:].to(cache["k"].dtype))
    write_columns_(cache["v"], at, v[:, -take:].to(cache["v"].dtype))
    write_columns_(cache["kv_pos"], at,
                   pos[:, -take:].expand(b, take).to(cache["kv_pos"].dtype))


def _gqa_forward(x, p, cfg: ModelConfig, positions, *, window, theta,
                 cache=None, rules=None):
    s = x.shape[1]
    q, k, v = attn.qkv_project(x, p)
    if cfg.use_qkv_bias:
        q = q + p["bq"][None, None]
        k = k + p["bk"][None, None]
        v = v + p["bv"][None, None]
    q, k = attn.maybe_qk_norm(q, k, p)
    pos = positions["pos"]
    if cfg.mrope_sections:
        q = attn.apply_mrope(q, positions["mrope"], cfg.mrope_sections,
                             theta=theta)
        k = attn.apply_mrope(k, positions["mrope"], cfg.mrope_sections,
                             theta=theta)
    else:
        q = attn.apply_rope(q, pos, theta=theta, rot_frac=cfg.rope_frac)
        k = attn.apply_rope(k, pos, theta=theta, rot_frac=cfg.rope_frac)
    if rules is not None:
        # Under sequence parallelism, queries whose heads no axis splits
        # keep the residual stream's split of their rows: each rank
        # attends its rows over every head (`attn._row_axes`), and the
        # output stays split as the stream is.
        rows = ("seq" if rules.get("seq") is not None
                and rules.get("act_heads") is None else None)
        q = logical_constraint(q, rules, "batch", rows, "act_heads", None)
        k = logical_constraint(k, rules, "batch", None, "cache_heads", None)
        v = logical_constraint(v, rules, "batch", None, "cache_heads", None)

    new_cache = None
    if cache is not None:
        slots = cache["k"].shape[1]
        if s == 1:
            _ring_write(cache, k, v, pos)
        else:
            # Prefill: keep the last `slots` tokens, each at slot
            # (token_position % slots) so subsequent decode ring-writes
            # (index % slots) evict exactly the oldest token.
            take = min(s, slots)
            _prefill_write(cache, k, v, pos, np.arange(s - take, s) % slots)
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "kv_pos": cache["kv_pos"], "index": cache["index"] + s}
    if cache is not None and s == 1:
        kv_pos = cache["kv_pos"]
        mask = attn.make_mask(pos, kv_pos, window=window)
        mask &= (kv_pos >= 0)[:, None, :]
        o = attn.gqa_attention(q, cache["k"], cache["v"], mask,
                               softcap=cfg.logit_softcap,
                               kv_chunk=cfg.attn_kv_chunk)
    else:
        mask = attn.make_mask(pos, pos, window=window)
        o = attn.gqa_attention(q, k, v, mask, softcap=cfg.logit_softcap,
                               kv_chunk=cfg.attn_kv_chunk)
    return attn.out_project(o, p), new_cache


def _mixer_forward(x, p, cfg: ModelConfig, positions, layer_idx_global,
                   *, window, theta, cache=None, rules=None):
    if cfg.mixer == "gqa":
        return _gqa_forward(x, p["attn"], cfg, positions, window=window,
                            theta=theta, cache=cache, rules=rules)
    if cfg.mixer == "mla":
        m = cfg.mla
        # The mask is made in mla_forward from the positions: causal
        # against the positional cache (no ring: slot i holds token i),
        # on each rank for its own rows where the cache's slots are split.
        out, new_cache = attn.mla_forward(
            x, p["attn"], positions["pos"], num_heads=cfg.num_heads,
            qk_nope=m.qk_nope, qk_rope=m.qk_rope, v_dim=m.v_dim,
            rope_theta=cfg.rope_theta, window=window,
            kv_chunk=cfg.attn_kv_chunk, cache=cache)
        return out, (None if cache is None else new_cache)
    if cfg.mixer == "rwkv6":
        h = cfg.d_model // cfg.rwkv.head_size
        return ssm.rwkv6_time_mix(x, p["attn"], num_heads=h, state=cache)
    if cfg.mixer == "hymba":
        return _hymba_fused(x, p, cfg, positions, window=window, theta=theta,
                            cache=cache, rules=rules)
    raise ValueError(cfg.mixer)


def _hymba_fused(x, p, cfg: ModelConfig, positions, *, window, theta,
                 cache=None, rules=None):
    """Hymba: attention heads and Mamba heads in parallel, per-path RMS
    norm, averaged, then one output projection."""
    b, s, _ = x.shape
    pos = positions["pos"]
    # attention to flat head outputs (no wo: fuse_out plays that role).
    q, k, v = attn.qkv_project(x, p["attn"])
    q = attn.apply_rope(q, pos, theta=theta, rot_frac=cfg.rope_frac)
    k = attn.apply_rope(k, pos, theta=theta, rot_frac=cfg.rope_frac)
    a_cache = cache["attn"] if cache is not None else None
    a_new = None
    if a_cache is not None:
        if s == 1:
            _ring_write(a_cache, k, v, pos)
        else:
            # The reference's hymba prefill keeps the last `slots` tokens
            # in the first slots (not at position % slots, as gqa does).
            take = min(s, a_cache["k"].shape[1])
            _prefill_write(a_cache, k, v, pos, np.arange(take))
        a_new = {"k": a_cache["k"], "v": a_cache["v"],
                 "kv_pos": a_cache["kv_pos"], "index": a_cache["index"] + s}
    if a_cache is not None and s == 1:
        kv_pos = a_cache["kv_pos"]
        mask = attn.make_mask(pos, kv_pos, window=window)
        mask &= (kv_pos >= 0)[:, None, :]
        o = attn.gqa_attention(q, a_cache["k"], a_cache["v"], mask)
    else:
        mask = attn.make_mask(pos, pos, window=window)
        o = attn.gqa_attention(q, k, v, mask, kv_chunk=cfg.attn_kv_chunk)
    a_flat = o.reshape(b, s, -1)

    m_state = cache["mamba"] if cache is not None else None
    m_out, m_new = ssm.mamba_mixer(x, p["mamba"], state=m_state)
    if rules is not None:
        # The Mamba heads' output projection leaves a partial sum, which
        # its norm reads twice: reduced once, onto the residual stream's
        # placement, first.
        m_out = logical_constraint(m_out, rules, "batch", "seq", "act_embed")

    fused = 0.5 * (attn._rms(a_flat, p["attn_out_norm"]["scale"])
                   + attn._rms(m_out, p["mamba_out_norm"]["scale"]))
    out = torch.einsum("bse,ed->bsd", fused, p["fuse_out"])
    new_cache = None
    if cache is not None:
        new_cache = {"attn": a_new, "mamba": m_new}
    return out, new_cache


def _ffn_forward(x, p, cfg: ModelConfig, layer_idx, cache=None):
    """Returns (out, aux_loss, new_cache)."""
    if cfg.mixer == "rwkv6":
        out, new = ssm.rwkv6_channel_mix(x, p["mlp"], cache)
        return out, 0.0, new
    if cfg.moe is not None and layer_idx not in cfg.moe_dense_layers:
        act = ACTIVATIONS["silu" if cfg.mlp == "swiglu" else "gelu"]
        out, aux = moe_ffn(x, p["mlp"], cfg.moe, act)
        return out, aux, None
    return _dense_mlp(x, p["mlp"], cfg), 0.0, None


def _layer_forward(x, p, cfg: ModelConfig, positions, layer_idx,
                   cache=None, rules=None):
    window = cfg.attn_window if (cfg.attn_window is not None
                                 and not cfg.layer_is_global(layer_idx)) \
        else None
    theta = cfg.rope_theta_for(layer_idx)
    seq_parallel = rules is not None and rules.get("seq") is not None
    if rules is not None:
        x = logical_constraint(x, rules, "batch", "seq", "act_embed")

    def enter_tp(h):
        # Megatron-SP region boundary (a hint; see common.logical_constraint).
        if seq_parallel:
            return logical_constraint(h, rules, "batch", None, "act_embed")
        return h

    def exit_tp(h):
        # A row-parallel output is a partial sum over the model axis: it
        # takes the residual stream's placement before it is used, one
        # reduction (a reduce-scatter under sequence parallelism, else an
        # all-reduce, as XLA's program does), so a norm, which reads its
        # input more than once, does not reduce it at each read.
        if rules is not None:
            return logical_constraint(h, rules, "batch", "seq", "act_embed")
        return h

    h = enter_tp(apply_norm(x, p["ln1"], cfg.norm))
    mix_cache = cache["mixer"] if cache is not None else None
    mix, mix_new = _mixer_forward(h, p, cfg, positions, layer_idx,
                                  window=window, theta=theta,
                                  cache=mix_cache, rules=rules)
    mix = exit_tp(mix)
    if cfg.sandwich_norm:
        mix = apply_norm(mix, p["ln1_post"], cfg.norm)
    x = x + mix

    h = enter_tp(apply_norm(x, p["ln2"], cfg.norm))
    ffn_cache = cache.get("ffn") if cache is not None else None
    f, aux, ffn_new = _ffn_forward(h, p, cfg, layer_idx, ffn_cache)
    f = exit_tp(f)
    if cfg.sandwich_norm:
        f = apply_norm(f, p["ln2_post"], cfg.norm)
    x = x + f

    new_cache = None
    if cache is not None:
        new_cache = {"mixer": mix_new}
        if ffn_new is not None:
            new_cache["ffn"] = ffn_new
    return x, aux, new_cache


# ---------------------------------------------------------------------------
# Stacked layers: the reference's jax.lax.scan sites as loops over slices
# ---------------------------------------------------------------------------


def _store_slice(stack, new, i: int) -> None:
    """Write layer `i`'s new cache entry into the stack.  Entries written
    in place are views of the stack already; replaced ones are copied."""
    for key, val in new.items():
        if isinstance(val, dict):
            _store_slice(stack[key], val, i)
        elif isinstance(val, torch.Tensor):
            dst = stack[key][i]
            if val.data_ptr() != dst.data_ptr() or val.shape != dst.shape:
                dst.copy_(val)


def _sync_index(tree, idx) -> None:
    """Set every `index` entry of a cache tree to `idx`."""
    if isinstance(tree, dict):
        if "index" in tree:
            tree["index"] = idx
        for v in tree.values():
            _sync_index(v, idx)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransformerLM:
    cfg: ModelConfig

    # -- specs ---------------------------------------------------------------
    def param_specs(self):
        return param_specs(self.cfg)

    # -- embedding -----------------------------------------------------------
    def _embed(self, params, batch):
        cfg = self.cfg
        if "embeds" in batch and batch["embeds"] is not None:
            x = batch["embeds"].to(params["embed"].dtype)
        else:
            # Negative ids count from the end and ids past the table take
            # its last row, as the reference's gather does.
            tokens = batch["tokens"].long()
            v = params["embed"].shape[0]
            tokens = torch.where(tokens < 0, tokens + v, tokens)
            x = take_rows(params["embed"], tokens.clamp(0, v - 1))
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        return x

    def _positions(self, batch, start=0):
        tokens = batch.get("tokens")
        src = tokens if tokens is not None else batch["embeds"]
        pos = batch.get("positions")
        if pos is None:
            pos = token_positions(src, start)
        out = {"pos": pos}
        if self.cfg.mrope_sections:
            mr = batch.get("mrope_positions")
            if mr is None:
                mr = pos[None].expand(3, *pos.shape)
            out["mrope"] = mr
        return out

    def _logits(self, params, x, rules=None):
        cfg = self.cfg
        x = apply_norm(x, params["final_norm"], cfg.norm)
        if rules is not None:
            x = logical_constraint(x, rules, "batch", None, "act_embed")
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        logits = project("bsd,dv->bsv", x, head).float()
        if rules is not None:
            logits = logical_constraint(logits, rules, "batch", None,
                                        "act_vocab")
        return logits

    # -- forward (training / prefill without cache) ---------------------------
    def forward(self, params, batch, rules=None):
        """Returns (logits (B,S,V) fp32, aux_loss scalar)."""
        cfg = self.cfg
        if cfg.remat not in REMAT_POLICIES:
            raise ValueError(cfg.remat)
        x = self._embed(params, batch)
        positions = self._positions(batch)
        if cfg.scan_layers:
            x, aux_total = self._run_stacked(params, x, positions, rules)
        else:
            def one_layer(h, lp, i):
                out, aux, _ = _layer_forward(h, lp, cfg, positions, i,
                                             rules=rules)
                return out, aux

            one_layer = remat(one_layer, cfg.remat)
            aux_total = 0.0
            for i, lp in enumerate(params["layer_list"]):
                x, aux = one_layer(x, placed_grads(lp), i)
                aux_total = aux_total + aux
        return self._logits(params, x, rules), aux_total

    def _run_stacked(self, params, x, positions, rules):
        cfg = self.cfg
        aux_total = 0.0
        n_prefix = len(cfg.moe_dense_layers)
        for i, lp in enumerate(params.get("prefix_layers", [])):
            x, aux, _ = _layer_forward(x, placed_grads(lp), cfg, positions,
                                       cfg.moe_dense_layers[i], rules=rules)
            aux_total = aux_total + aux

        def body(h, lp):
            out, a, _ = _layer_forward(h, lp, cfg, positions, n_prefix,
                                       rules=rules)
            return out, a

        body = remat(body, cfg.remat)
        for lp in tree_unbind(params["layers"]):
            x, a = body(x, lp)
            aux_total = aux_total + a
        return x, aux_total

    # -- KV cache ------------------------------------------------------------
    def init_cache(self, batch_size: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16, device=None):
        """Zeroed decode state on `device` (the card unless the caller
        names the CPU)."""
        cfg = self.cfg
        dev = resolve_device(device)
        entries = [self._layer_cache(cfg, i, batch_size, max_seq, dtype, dev)
                   for i in range(cfg.num_layers)]
        if cfg.scan_layers and not self._heterogeneous():
            n_prefix = len(cfg.moe_dense_layers)
            stacked = _stack_entries(entries[n_prefix:])
            return {"prefix": entries[:n_prefix], "stack": stacked,
                    "index": 0}
        return {"list": entries, "index": 0}

    def _heterogeneous(self) -> bool:
        cfg = self.cfg
        return (cfg.attn_window is not None
                and any(cfg.layer_is_global(i) != cfg.layer_is_global(0)
                        for i in range(cfg.num_layers)))

    def _layer_cache(self, cfg, i, b, max_seq, dtype, dev):
        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        if cfg.mixer in ("gqa", "hymba"):
            window = (cfg.attn_window
                      if cfg.attn_window is not None
                      and not cfg.layer_is_global(i) else None)
            slots = min(window, max_seq) if window else max_seq
            kv = {
                "k": zeros(b, slots, cfg.num_kv_heads, cfg.head_dim),
                "v": zeros(b, slots, cfg.num_kv_heads, cfg.head_dim),
                "kv_pos": torch.full((b, slots), -1, dtype=torch.int32,
                                     device=dev),
                "index": 0,
            }
            if cfg.mixer == "gqa":
                return {"mixer": kv}
            m = cfg.mamba
            e = m.d_inner or cfg.d_model
            return {"mixer": {
                "attn": kv,
                "mamba": {
                    "conv": zeros(b, m.conv_kernel - 1, e),
                    "ssm": zeros(b, e, m.state_size, dt=torch.float32),
                }}}
        if cfg.mixer == "mla":
            m = cfg.mla
            return {"mixer": {
                "c_kv": zeros(b, max_seq, m.kv_lora),
                "k_rope": zeros(b, max_seq, m.qk_rope),
                "index": 0,
            }}
        if cfg.mixer == "rwkv6":
            h = cfg.d_model // cfg.rwkv.head_size
            k = cfg.rwkv.head_size
            return {
                "mixer": {"shift": zeros(b, cfg.d_model),
                          "wkv": zeros(b, h, k, k, dt=torch.float32)},
                "ffn": {"shift": zeros(b, cfg.d_model)},
            }
        raise ValueError(cfg.mixer)

    # -- decode --------------------------------------------------------------
    def decode_step(self, params, cache, tokens, rules=None):
        """One token per sequence. tokens: (B, 1). Returns (logits, cache).

        If the cache carries `slot_pos` (B,), each sequence decodes at its
        own position (continuous batching); otherwise all sequences share
        the global `index` cursor.  The cache is updated in place.
        """
        if "slot_pos" in cache:
            pos = cache["slot_pos"][:, None].long()
        else:
            pos = torch.full_like(tokens, cache["index"], dtype=torch.long)
        batch = {"tokens": tokens, "positions": pos}
        logits, new_cache = self._run_cached(params, batch, cache, rules, 1)
        if "slot_pos" in cache:
            new_cache["slot_pos"] = cache["slot_pos"] + 1
        return logits[:, -1], new_cache

    def _run_cached(self, params, batch, cache, rules, s, last=False):
        """The layers over `batch` (`s` tokens a row) with the cache, for
        decode and prefill alike: returns (logits, new cache).  With
        `last` and sharding rules, the logits of each row's last position
        only (`prefill`)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = self._positions(batch)
        idx = cache["index"]
        if "list" in cache:
            if "layer_list" not in params:
                raise ValueError("list cache requires unscanned layers")
            new_entries = []
            for i, lp in enumerate(params["layer_list"]):
                e = dict(cache["list"][i])
                _sync_index(e, idx)
                x, _, new_e = _layer_forward(x, lp, cfg, positions, i,
                                             cache=e, rules=rules)
                new_entries.append(new_e)
            new_cache = {"list": new_entries, "index": idx + s}
        else:
            n_prefix = len(cfg.moe_dense_layers)
            new_prefix = []
            for i, lp in enumerate(params.get("prefix_layers", [])):
                e = dict(cache["prefix"][i])
                _sync_index(e, idx)
                x, _, new_e = _layer_forward(x, lp, cfg, positions,
                                             cfg.moe_dense_layers[i],
                                             cache=e, rules=rules)
                new_prefix.append(new_e)
            stack = cache["stack"]
            for i in range(first_tensor(stack).shape[0]):
                entry = tree_index(stack, i)
                _sync_index(entry, idx)
                x, _, new_e = _layer_forward(
                    x, tree_index(params["layers"], i), cfg, positions,
                    n_prefix, cache=entry, rules=rules)
                _store_slice(stack, new_e, i)
            _sync_index(stack, idx + s)
            new_cache = {"prefix": new_prefix, "stack": stack,
                         "index": idx + s}
        if last and rules is not None:
            x = x[:, -1:]
        return self._logits(params, x, rules), new_cache

    # -- slot management (continuous batching; serving/engine.py) ----------
    def enable_slots(self, cache, batch_size: int):
        """Add per-sequence decode cursors to a freshly-initialized cache."""
        out = dict(cache)
        out["slot_pos"] = torch.zeros((batch_size,), dtype=torch.int32,
                                      device=first_tensor(cache).device)
        return out

    def reset_slot(self, cache, slot: int):
        """Invalidate one sequence's state so a new request can use it:
        its tensors are zeroed and its kv_pos set to -1, in place, in the
        list and the stacked layouts alike."""
        def walk(node, stacked):
            if isinstance(node, dict):
                for k, v in node.items():
                    if k == "kv_pos":
                        (v[:, slot] if stacked else v[slot]).fill_(-1)
                    elif k != "index":
                        walk(v, stacked)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v, stacked)
            elif isinstance(node, torch.Tensor) and node.ndim:
                (node[:, slot] if stacked else node[slot]).zero_()

        for k, v in cache.items():
            if k == "slot_pos":
                v[slot] = 0
            elif k != "index":
                walk(v, k == "stack")
        return cache

    # -- prefill -------------------------------------------------------------
    def prefill(self, params, batch, cache, rules=None):
        """Run the full prompt, writing caches; returns (last_logits, cache).
        The eager step (no sharding rules) makes every position's logits,
        as the reference's program makes them, and keeps the last.  A
        step with sharding rules (the dry run's, partitioned or not, and
        a card's rank) unembeds only the last position: the (B, S, V)
        float32 logits and their bf16 product, a prefill's largest
        tensors, are never made (fewer bytes than XLA's program moves)."""
        src = batch.get("tokens")
        s = (src if src is not None else batch["embeds"]).shape[1]
        logits, new_cache = self._run_cached(params, batch, cache, rules, s,
                                             last=True)
        return logits[:, -1], new_cache


def _stack_entries(entries):
    """Stack per-layer cache entries along a new leading layer axis."""
    first = entries[0]
    if isinstance(first, dict):
        return {k: _stack_entries([e[k] for e in entries]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(entries)
    return first            # `index`: one int for the stack
