"""Attention mixers: GQA (full / sliding-window / partial-RoPE / M-RoPE /
qk-norm / logit-softcap), blockwise (memory-bounded) attention, and MLA
(DeepSeek-V2 multi-head latent attention with compressed KV cache).

All functions are pure functions of tensors; parameters are dict trees
built from ParamSpecs in transformer.py.  Softmax statistics are computed
in float32 with the reference's explicit math (NEG_INF scores, `where`
masking, online softmax over KV chunks), so a masked slot (kv_pos = -1)
or a fully masked chunk contributes exactly zero.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_table(positions: torch.Tensor, rot_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables: positions (...,) -> (..., rot_dim/2)."""
    freqs = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                         device=positions.device) / rot_dim
    inv = 1.0 / (theta ** freqs)
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 1e4, rot_frac: float = 1.0) -> torch.Tensor:
    """Rotate the first rot_frac of head_dim. x: (B, S, H, D); pos: (B, S)."""
    d = x.shape[-1]
    rot = int(d * rot_frac)
    rot -= rot % 2
    if rot == 0:
        return x
    sin, cos = rope_table(positions, rot, theta)        # (B, S, rot/2)
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Tuple[int, ...], *, theta: float = 1e6
                ) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (B, S, H, D); positions: (3, B, S) = (temporal, height, width) ids.
    `sections` gives the per-component split of D/2 frequency slots, e.g.
    (16, 24, 24) for D=128.
    """
    d = x.shape[-1]
    if sum(sections) * 2 != d:
        raise ValueError(f"mrope sections {sections} do not tile head_dim {d}")
    sin_full, cos_full = [], []
    for comp, _ in enumerate(sections):
        # Frequency slots owned by this component use its position stream.
        s, c = rope_table(positions[comp], d, theta)     # (B, S, d/2)
        sin_full.append(s)
        cos_full.append(c)
    # Slot j of the d/2 frequency slots takes component comp_of_slot[j]:
    # slots are laid out section by section.  The reference indexes
    # stack[comp_of_slot, :, :, slot], whose broadcast axis comes first,
    # (d/2, B, S); the port moves the slot axis forward before indexing
    # so both index arrays are adjacent and the layout is explicit.
    comp_of_slot = torch.from_numpy(
        np.repeat(np.arange(len(sections)), np.asarray(sections))
    ).to(x.device)
    slot = torch.arange(d // 2, device=x.device)
    sin = torch.stack(sin_full, 0).permute(0, 3, 1, 2)[comp_of_slot, slot]
    cos = torch.stack(cos_full, 0).permute(0, 3, 1, 2)[comp_of_slot, slot]
    # (d/2, B, S) -> (B, S, 1, d/2)
    sin = torch.movedim(sin, 0, -1)[:, :, None, :]
    cos = torch.movedim(cos, 0, -1)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Mask construction
# ---------------------------------------------------------------------------


def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean (..., Sq, Skv) mask; True = attend.

    q_pos: (B, Sq) token positions of queries; kv_pos: (B, Skv).
    window: sliding-window size (attend iff q_pos - kv_pos < window).
    kv_len: (B,) valid cache length for decode.
    """
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    shape = torch.broadcast_shapes(q.shape, k.shape)
    m = torch.ones(shape, dtype=torch.bool, device=q.device)
    if causal:
        m &= k <= q
    if window is not None:
        m &= (q - k) < window
    if kv_len is not None:
        m &= k < kv_len[:, None, None]
    return m


# ---------------------------------------------------------------------------
# Core attention (GQA, optionally blockwise over KV)
# ---------------------------------------------------------------------------


def _scores(q, k, scale, softcap):
    # q: (B, Sq, G, KH, D) k: (B, Skv, KH, D)
    s = torch.einsum("bqghd,bkhd->bghqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, *, scale: Optional[float] = None,
                  softcap: Optional[float] = None,
                  kv_chunk: Optional[int] = None,
                  q_chunk: int = 4096) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, H, D); k/v: (B, Skv, KH, Dv); mask: (B, Sq, Skv) bool.
    Returns (B, Sq, H, Dv).  When kv_chunk is set, Skv is longer than it
    and divides by it, the KV axis is processed in chunks with
    online-softmax running statistics (`_attention_online`), and a query
    axis longer than q_chunk (and divisible by it) is processed q_chunk
    rows at a time (`_attention_q_chunked`); otherwise the scores are
    computed whole (`_attention_plain`).
    """
    b, sq, h, d = q.shape
    if kv_chunk and sq > q_chunk and sq % q_chunk == 0:
        return _attention_q_chunked(q, k, v, mask, scale=scale,
                                    softcap=softcap, kv_chunk=kv_chunk,
                                    q_chunk=q_chunk)
    kh = k.shape[2]
    if h % kh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kh}")
    qg = q.reshape(b, sq, h // kh, kh, d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if not kv_chunk or k.shape[1] % kv_chunk or k.shape[1] <= kv_chunk:
        o = _attention_plain(qg, k, v, mask, scale, softcap)
    else:
        o = _attention_online(qg, k, v, mask, scale, softcap, kv_chunk)
    return o.reshape(b, sq, h, v.shape[3]).to(q.dtype)


def _attention_q_chunked(q, k, v, mask, *, scale, softcap, kv_chunk,
                         q_chunk):
    """The reference's jax.lax.map over q_chunk rows of queries."""
    b, sq, h, _ = q.shape
    outs = [gqa_attention(q[:, i:i + q_chunk], k, v, mask[:, i:i + q_chunk],
                          scale=scale, softcap=softcap, kv_chunk=kv_chunk,
                          q_chunk=q_chunk)
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(b, sq, h, v.shape[3])


def _attention_plain(qg, k, v, mask, scale, softcap):
    """Whole-score softmax; returns (B, Sq, G, KH, Dv) float32."""
    s = _scores(qg, k, scale, softcap)                  # (B,G,KH,Sq,Skv)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bghqk,bkhd->bqghd", p, v.float())


def _attention_online(qg, k, v, mask, scale, softcap, kv_chunk):
    """Blockwise over KV with running max/denominator (online softmax),
    one chunk after another in the reference's scan order; returns
    (B, Sq, G, KH, Dv) float32."""
    b, sq, g, kh, _ = qg.shape
    dv = v.shape[3]
    m_run = torch.full((b, g, kh, sq), NEG_INF, dtype=torch.float32,
                       device=qg.device)
    l_run = torch.zeros((b, g, kh, sq), dtype=torch.float32,
                        device=qg.device)
    acc = torch.zeros((b, g, kh, sq, dv), dtype=torch.float32,
                      device=qg.device)
    for c0 in range(0, k.shape[1], kv_chunk):
        k_i = k[:, c0:c0 + kv_chunk]
        v_i = v[:, c0:c0 + kv_chunk]
        mask_i = mask[:, None, None, :, c0:c0 + kv_chunk]
        s = _scores(qg, k_i, scale, softcap)             # (B,G,KH,Sq,C)
        s = torch.where(mask_i, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        # Masked slots contribute exactly zero even in fully-masked chunks
        # (where s == m_new == NEG_INF and the naive exp would give 1).
        p = torch.where(mask_i, torch.exp(s - m_new[..., None]), 0.0)
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bghqk,bkhd->bghqd", p, v_i.float())
        m_run = m_new
    o = acc / torch.clamp_min(l_run[..., None], 1e-37)
    return torch.movedim(o, 3, 1)                        # (B,Sq,G,KH,Dv)


# ---------------------------------------------------------------------------
# Projection helpers (GQA)
# ---------------------------------------------------------------------------


def qkv_project(x: torch.Tensor, p: Dict
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return q, k, v


def out_project(o: torch.Tensor, p: Dict) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def maybe_qk_norm(q, k, p, eps=1e-6):
    """Per-head RMS norm of q and k (gemma3)."""
    if "q_norm" not in p:
        return q, k
    return _rms(q, p["q_norm"], eps), _rms(k, p["k_norm"], eps)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-KV attention
# ---------------------------------------------------------------------------


def mla_forward(x: torch.Tensor, p: Dict, positions: torch.Tensor, *,
                num_heads: int, qk_nope: int, qk_rope: int, v_dim: int,
                rope_theta: float, mask: torch.Tensor,
                kv_chunk: Optional[int] = None,
                cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Multi-head latent attention.

    Cache (decode) stores only (c_kv, k_rope): kv_lora + qk_rope floats per
    token per layer.  The cache's tensors are written in place and
    returned in the new entry: the caller's old cache is consumed.
    Decode (one token) writes each row at its own position, which must be
    below the cache's length; a longer write starts at `index`, moved
    back so that it fits, as the reference's dynamic_update_slice does.

    Returns (attn_out (B,S,D_model), new_cache_entries).
    """
    b, s, _ = x.shape
    # Queries.
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])        # (B,S,H,nope+rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, theta=rope_theta)

    # Compressed KV + shared rope key.
    c_kv = torch.einsum("bsd,dc->bsc", x, p["w_dkv"])    # (B,S,kv_lora)
    c_kv = _rms(c_kv, p["kv_norm"])
    k_rope = torch.einsum("bsd,dk->bsk", x, p["w_kr"])   # (B,S,rope)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        theta=rope_theta)[:, :, 0]

    if cache is not None:
        idx = cache["index"]
        c_full, kr_full = cache["c_kv"], cache["k_rope"]
        if s == 1:
            # Per-slot positional write (continuous batching).
            rows = torch.arange(b, device=x.device)
            at = positions[:, 0].long()
            c_full.index_put_((rows, at), c_kv[:, 0].to(c_full.dtype))
            kr_full.index_put_((rows, at), k_rope[:, 0].to(kr_full.dtype))
        else:
            start = min(max(int(idx), 0), c_full.shape[1] - s)
            c_full[:, start:start + s] = c_kv.to(c_full.dtype)
            kr_full[:, start:start + s] = k_rope.to(kr_full.dtype)
        new_cache = {"c_kv": c_full, "k_rope": kr_full, "index": idx + s}
        c_use, kr_use = c_full, kr_full
    else:
        new_cache = {}
        c_use, kr_use = c_kv, k_rope

    # Expand keys/values from the latent explicitly, as the reference does.
    k_nope = torch.einsum("bsc,chk->bshk", c_use, p["w_uk"])
    v = torch.einsum("bsc,chk->bshk", c_use, p["w_uv"])
    kh = k_nope.shape[2]
    kr_b = kr_use[:, :, None, :].expand(*kr_use.shape[:2], kh, qk_rope)
    k = torch.cat([k_nope, kr_b], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)

    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    o = gqa_attention(q_full, k, v, mask, scale=scale, kv_chunk=kv_chunk)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, new_cache
