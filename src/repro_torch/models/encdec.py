"""Encoder-decoder transformer (Whisper-style) — audio backbone.

The conv frontend is a stub, as in the reference: callers provide
precomputed frame embeddings (B, enc_seq, d_model).  Encoder:
bidirectional self-attention with sinusoidal positions.  Decoder: causal
self-attention (+ KV cache) and cross-attention to the encoder output
(cross K/V precomputed once by `start_cache`).  The reference's
jax.lax.scan over stacked layers is a loop over their slices; the decode
cache is written in place (the caller's old cache is consumed) and its
`index` is a Python int.  With any `cfg.remat` but "none", each encoder
and decoder layer of `encode`/`forward` runs under a checkpoint that
keeps only its inputs (the reference's plain jax.checkpoint, whatever
the policy's name).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (ACTIVATIONS, ParamSpec, apply_norm,
                                       batched, contract, logical_constraint,
                                       norm_spec, remat, slot_positions,
                                       stack_specs, take_rows,
                                       token_positions, tree_unbind,
                                       write_columns_)


def _attn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }


def _mlp_specs(cfg: ModelConfig, f: int) -> Dict[str, Any]:
    d = cfg.d_model
    return {"w_up": ParamSpec((d, f), ("embed", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "embed"))}


def _enc_layer(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": norm_spec(cfg.d_model, cfg.norm),
            "attn": _attn_specs(cfg),
            "ln2": norm_spec(cfg.d_model, cfg.norm),
            "mlp": _mlp_specs(cfg, cfg.enc_dec.enc_d_ff)}


def _dec_layer(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": norm_spec(cfg.d_model, cfg.norm),
            "self_attn": _attn_specs(cfg),
            "ln_x": norm_spec(cfg.d_model, cfg.norm),
            "cross_attn": _attn_specs(cfg),
            "ln2": norm_spec(cfg.d_model, cfg.norm),
            "mlp": _mlp_specs(cfg, cfg.d_ff)}


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    ed = cfg.enc_dec
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           "embed"),
        "dec_pos": ParamSpec((cfg.max_seq_len, cfg.d_model),
                             (None, "embed"), "embed", scale=0.02),
        "enc_layers": stack_specs(_enc_layer(cfg), ed.enc_layers),
        "enc_final_norm": norm_spec(cfg.d_model, cfg.norm),
        "dec_layers": stack_specs(_dec_layer(cfg), cfg.num_layers),
        "final_norm": norm_spec(cfg.d_model, cfg.norm),
    }


def _sinusoid(length: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mha(x, p, mask, kv=None, kv_chunk=None):
    q = contract("bsd,dhk->bshk", x, p["wq"])
    src = x if kv is None else kv
    k = contract("bsd,dhk->bshk", src, p["wk"])
    v = contract("bsd,dhk->bshk", src, p["wv"])
    o = attn.gqa_attention(q, k, v, mask, kv_chunk=kv_chunk)
    return contract("bshk,hkd->bsd", o, p["wo"])


def _mha_cached(x, p, mask, k, v):
    q = contract("bsd,dhk->bshk", x, p["wq"])
    o = attn.gqa_attention(q, k, v, mask)
    return contract("bshk,hkd->bsd", o, p["wo"])


def _mlp(h, p):
    up = torch.einsum("bsd,df->bsf", h, p["w_up"])
    return torch.einsum("bsf,fd->bsd", ACTIVATIONS["gelu"](up), p["w_down"])


def _settled(t, rules):
    """A sublayer's output, a partial sum over the model axis where its
    last product contracted split heads, on the residual stream's
    placement: one all-reduce (or reduce-scatter) before the next norm,
    which reads its input more than once, would reduce it at each read."""
    if rules is None:
        return t
    return logical_constraint(t, rules, "batch", None, "act_embed")


def _remat(body, cfg: ModelConfig):
    return remat(body, "none" if cfg.remat == "none" else "full")


@dataclasses.dataclass(frozen=True)
class EncDecLM:
    cfg: ModelConfig

    def param_specs(self):
        return param_specs(self.cfg)

    # -- encoder ---------------------------------------------------------
    def encode(self, params, frames, rules=None):
        cfg = self.cfg
        b, s, _ = frames.shape
        x = frames.to(params["embed"].dtype)
        x = x + _sinusoid(s, cfg.d_model, x.device).to(x.dtype)[None]
        full = batched(torch.ones, x, (b, s, s), dtype=torch.bool)
        if rules is not None:
            x = logical_constraint(x, rules, "batch", None, "act_embed")
            full = logical_constraint(full, rules, "batch", None, None)

        def body(h, lp):
            if rules is not None:
                h = logical_constraint(h, rules, "batch", None, "act_embed")
            y = apply_norm(h, lp["ln1"], cfg.norm)
            h = h + _settled(_mha(y, lp["attn"], full,
                                  kv_chunk=cfg.attn_kv_chunk), rules)
            y = apply_norm(h, lp["ln2"], cfg.norm)
            return h + _settled(_mlp(y, lp["mlp"]), rules)

        body = _remat(body, cfg)
        for lp in tree_unbind(params["enc_layers"]):
            x = body(x, lp)
        return apply_norm(x, params["enc_final_norm"], cfg.norm)

    # -- decoder (teacher-forced training / prefill) ----------------------
    def forward(self, params, batch, rules=None):
        """batch: {tokens (B,S), frames (B,enc_seq,D)} -> (logits, aux)."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"], rules)
        tokens = batch["tokens"].long()
        b, s = tokens.shape
        x = take_rows(params["embed"], tokens)
        x = x + params["dec_pos"][:s][None].to(x.dtype)
        pos = token_positions(tokens)
        causal = attn.make_mask(pos, pos)
        xs_full = batched(torch.ones, tokens, (b, s, enc.shape[1]),
                          dtype=torch.bool)
        if rules is not None:
            x = logical_constraint(x, rules, "batch", None, "act_embed")
            causal = logical_constraint(causal, rules, "batch", None, None)
            xs_full = logical_constraint(xs_full, rules, "batch", None, None)

        def body(h, lp):
            if rules is not None:
                h = logical_constraint(h, rules, "batch", None, "act_embed")
            y = apply_norm(h, lp["ln1"], cfg.norm)
            h = h + _settled(_mha(y, lp["self_attn"], causal,
                                  kv_chunk=cfg.attn_kv_chunk), rules)
            y = apply_norm(h, lp["ln_x"], cfg.norm)
            h = h + _settled(_mha(y, lp["cross_attn"], xs_full, kv=enc),
                             rules)
            y = apply_norm(h, lp["ln2"], cfg.norm)
            return h + _settled(_mlp(y, lp["mlp"]), rules)

        body = _remat(body, cfg)
        for lp in tree_unbind(params["dec_layers"]):
            x = body(x, lp)
        x = apply_norm(x, params["final_norm"], cfg.norm)
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"]).float()
        if rules is not None:
            logits = logical_constraint(logits, rules, "batch", None,
                                        "act_vocab")
        return logits, 0.0

    # -- decode ------------------------------------------------------------
    def init_cache(self, batch_size: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16, device=None):
        """Zeroed decode state on `device` (the card unless the caller
        names the CPU)."""
        cfg = self.cfg
        dev = resolve_device(device)
        L, h, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
        enc_seq = cfg.enc_dec.enc_seq

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "self_k": zeros(L, batch_size, max_seq, h, hd),
            "self_v": zeros(L, batch_size, max_seq, h, hd),
            "cross_k": zeros(L, batch_size, enc_seq, h, hd),
            "cross_v": zeros(L, batch_size, enc_seq, h, hd),
            "index": 0,
        }

    def start_cache(self, params, frames, cache, rules=None):
        """Encode once and precompute cross-attention K/V."""
        enc = self.encode(params, frames, rules)
        cross = params["dec_layers"]["cross_attn"]
        ks = contract("bsd,ldhk->lbshk", enc, cross["wk"])
        vs = contract("bsd,ldhk->lbshk", enc, cross["wv"])
        return {**cache, "cross_k": ks.to(cache["cross_k"].dtype),
                "cross_v": vs.to(cache["cross_v"].dtype)}

    def decode_step(self, params, cache, tokens, rules=None):
        """One token per sequence at the shared `index`; the self-attention
        cache is written in place (at `index`, clamped to the cache as the
        reference's dynamic_update_slice is)."""
        cfg = self.cfg
        idx = cache["index"]
        b = tokens.shape[0]
        x = take_rows(params["embed"], tokens.long())
        at = min(max(int(idx), 0), params["dec_pos"].shape[0] - 1)
        x = x + params["dec_pos"][at:at + 1][None].to(x.dtype)
        pos = batched(torch.full, tokens, (b, 1), idx, dtype=torch.long)
        slots = cache["self_k"].shape[2]
        self_mask = attn.make_mask(pos, slot_positions(cache["self_k"][0]))
        cross_mask = batched(torch.ones, tokens,
                             (b, 1, cache["cross_k"].shape[2]),
                             dtype=torch.bool)
        write = min(max(int(idx), 0), slots - 1)
        for i, lp in enumerate(tree_unbind(params["dec_layers"])):
            sk, sv = cache["self_k"][i], cache["self_v"][i]
            y = apply_norm(x, lp["ln1"], cfg.norm)
            kq = contract("bsd,dhk->bshk", y, lp["self_attn"]["wk"])
            vq = contract("bsd,dhk->bshk", y, lp["self_attn"]["wv"])
            span = slice(write, write + 1)
            write_columns_(sk, span, kq.to(sk.dtype))
            write_columns_(sv, span, vq.to(sv.dtype))
            x = x + _settled(_mha_cached(y, lp["self_attn"], self_mask, sk,
                                         sv), rules)
            y = apply_norm(x, lp["ln_x"], cfg.norm)
            x = x + _settled(_mha_cached(y, lp["cross_attn"], cross_mask,
                                         cache["cross_k"][i],
                                         cache["cross_v"][i]), rules)
            y = apply_norm(x, lp["ln2"], cfg.norm)
            x = x + _settled(_mlp(y, lp["mlp"]), rules)
        x = apply_norm(x, params["final_norm"], cfg.norm)
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"]).float()
        new_cache = {**cache, "index": idx + 1}
        return logits[:, -1], new_cache

