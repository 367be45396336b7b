"""Attention mixers: GQA (full / sliding-window / partial-RoPE / M-RoPE /
qk-norm / logit-softcap), blockwise (memory-bounded) attention, and MLA
(DeepSeek-V2 multi-head latent attention with compressed KV cache).

All functions are pure functions of tensors; parameters are dict trees
built from ParamSpecs in transformer.py.  Softmax statistics are computed
in float32 with the reference's explicit math (NEG_INF scores, `where`
masking, online softmax over KV chunks), so a masked slot (kv_pos = -1)
or a fully masked chunk contributes exactly zero.  A DTensor cache whose
slots are split (decode on a mesh) runs the program the reference's XLA
compiles for it, on each rank's local tensors (`_attention_split_slots`),
and so do grouped queries whose heads a mesh axis cuts across KV groups,
or whose rows sequence parallelism splits: each rank attends its rows
over every head (`_attention_split_rows`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.common import (contiguous_stride, contract, cut_as,
                                       is_split, project, reduce_over,
                                       slot_positions, write_columns_,
                                       write_rows_)

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
    window: sliding-window size (attend iff q_pos - kv_pos < window,
    compared as kv_pos > q_pos - window: the (B, Sq, 1) shift broadcasts
    into the boolean mask, and no integer (B, Sq, Skv) difference is
    made).
    kv_len: (B,) valid cache length for decode.
    """
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    # Made from its operands, so a mask of split positions is split too.
    m = (torch.ones_like(q, dtype=torch.bool)
         & torch.ones_like(k, dtype=torch.bool))
    if causal:
        m &= k <= q
    if window is not None:
        m &= k > q - window
    if kv_len is not None:
        m &= k < kv_len[:, None, None]
    return m


# ---------------------------------------------------------------------------
# Core attention (GQA, optionally blockwise over KV)
# ---------------------------------------------------------------------------


def _scores(q, k, scale, softcap):
    # q: (B, Sq, G, KH, D) k: (B, Skv, KH, D)
    s = contract("bqghd,bkhd->bghqk", q.float(), k.float()) * scale
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
    rows = _row_axes(q, k, q_chunk)
    if rows:
        return _attention_split_rows(q, k, v, mask, rows, scale=scale,
                                     softcap=softcap, kv_chunk=kv_chunk,
                                     q_chunk=q_chunk)
    if kv_chunk and sq > q_chunk and sq % q_chunk == 0:
        return _attention_q_chunked(q, k, v, mask, scale=scale,
                                    softcap=softcap, kv_chunk=kv_chunk,
                                    q_chunk=q_chunk)
    kh = k.shape[2]
    if h % kh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kh}")
    qg = q.reshape(b, sq, h // kh, kh, d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if isinstance(k, DTensor) and is_split(k, 1):
        o = _attention_split_slots(qg, k, v, mask, scale, softcap, kv_chunk)
    elif not kv_chunk or k.shape[1] % kv_chunk or k.shape[1] <= kv_chunk:
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
    return contract("bghqk,bkhd->bqghd", p, v.float())


def _attention_online(qg, k, v, mask, scale, softcap, kv_chunk):
    """Blockwise over KV with running max/denominator (online softmax),
    one chunk after another in the reference's scan order; returns
    (B, Sq, G, KH, Dv) float32."""
    # The running statistics are made from the queries (so split
    # queries split them too); the accumulator starts as one zero per
    # row, which the first chunk's sum broadcasts to (B,G,KH,Sq,Dv).
    m_run = torch.full_like(qg[..., 0], NEG_INF,
                            dtype=torch.float32).movedim(1, -1)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros_like(m_run[..., None])
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
        acc = acc * alpha[..., None] + contract(
            "bghqk,bkhd->bghqd", p, v_i.float())
        m_run = m_new
    o = acc / torch.clamp_min(l_run[..., None], 1e-37)
    return torch.movedim(o, 3, 1)                        # (B,Sq,G,KH,Dv)


def _row_axes(q, k, q_chunk) -> list:
    """The mesh axes over which `gqa_attention` splits DTensor queries
    (B, Sq, H, D) on their rows, or [] where it keeps them as they are.

    Grouped queries (G = H / KH of them a KV head, G > 1) are viewed as
    (B, Sq, G, KH, D), G outer.  A split of H keeps to that view only
    where each piece is whole groups (G divisible by the axes that split
    H); otherwise the view would gather H, and each rank would score
    every head.  Those axes split the rows instead, and so do the axes
    on which the caller has split the queries' rows already (sequence
    parallelism); both where they divide Sq and `q_chunk`.  Queries
    whole on an axis stay whole there (each rank scores every head, as
    XLA's program does), and decode over a slot-split cache
    (`_attention_split_slots`) is left as it is."""
    if not isinstance(q, DTensor) or (isinstance(k, DTensor)
                                      and is_split(k, 1)):
        return []
    mesh = q.device_mesh
    axes = [m for m, (p, n) in enumerate(zip(q.placements, mesh.shape))
            if n > 1 and p not in (Shard(0), Replicate())]
    if q.shape[2] == k.shape[2] or not axes or any(
            q.placements[m] not in (Shard(1), Shard(2)) for m in axes):
        return []
    heads = math.prod(mesh.shape[m] for m in axes
                      if q.placements[m] == Shard(2))
    if (q.shape[2] // k.shape[2]) % heads == 0:
        axes = [m for m in axes if q.placements[m] == Shard(1)]
    parts = math.prod(mesh.shape[m] for m in axes)
    if not axes or q.shape[1] % parts or q_chunk % parts:
        return []
    return axes


def _attention_split_rows(q, k, v, mask, axes, *, scale, softcap, kv_chunk,
                          q_chunk):
    """`gqa_attention` over DTensor queries whose rows the mesh axes
    `axes` split, or are to split (`_row_axes`), on this rank's tensors,
    as the reference's XLA program splits it: the queries and the mask's
    query rows are split on their rows over `axes` (an all-to-all from a
    split of the heads), k and v are whole there (gathered where split,
    their gradients partial sums) and split as the queries' batch on the
    other axes, and each rank attends its rows over every head,
    `q_chunk / n` rows at a time where the whole would take `q_chunk` (n
    the ranks over `axes`).  The output goes back to the heads' split on
    the axes that split them (an all-to-all) and keeps its rows split on
    the others."""
    mesh = q.device_mesh

    def placed(row):
        """The placements for the local program: `row` over `axes`, the
        batch split as the queries' is, whole on the other axes."""
        return [row if m in axes else
                Shard(0) if p == Shard(0) else Replicate()
                for m, p in enumerate(q.placements)]

    qp, kp, mp = placed(Shard(1)), placed(Replicate()), placed(Shard(1))
    kg = [Partial() if m in axes else p for m, p in enumerate(kp)]
    q_l = q.redistribute(mesh, qp).to_local()
    k_l, v_l = (t.redistribute(mesh, kp).to_local(grad_placements=kg)
                for t in (k, v))
    mask_l = mask.redistribute(mesh, mp).to_local()
    n = math.prod(mesh.shape[m] for m in axes)
    o = gqa_attention(q_l, k_l, v_l, mask_l, scale=scale, softcap=softcap,
                      kv_chunk=kv_chunk, q_chunk=q_chunk // n)
    shape = (*q.shape[:3], v.shape[3])
    o = DTensor.from_local(o.contiguous(), mesh, qp, run_check=False,
                           shape=shape, stride=contiguous_stride(*shape))
    return o.redistribute(mesh, [q.placements[m] if m in axes else p
                                 for m, p in enumerate(qp)])


def _attention_split_slots(qg, k, v, mask, scale, softcap, kv_chunk):
    """Attention over DTensors whose cache slots are split over mesh
    axes (decode on a mesh), as the reference's XLA program runs it, on
    this rank's tensors; returns (B, Sq, G, KH, Dv) float32.

    Chunked (the cache longer than `kv_chunk`, which divides it): k and
    v are cast to float32 and gathered whole over their slots once a
    call, before the chunk loop, with the mask; the chunks then run in
    order on the local tensors.  Whole: each rank scores its own slots
    and the softmax is combined across the axes (the row max, the
    denominator and the output each all-reduced)."""
    mesh = k.device_mesh
    online = bool(kv_chunk) and not (k.shape[1] % kv_chunk
                                     or k.shape[1] <= kv_chunk)
    kp = [Replicate() if online and p.is_shard() and p.dim == 1 else p
          for p in k.placements]
    # The queries, the mask and the output go with k's batch and heads.
    qp = [Shard({0: 0, 2: 3}[p.dim]) if p.is_shard() and p.dim != 1
          else Replicate() for p in kp]
    mp = [Shard({0: 0, 1: 2}[p.dim]) if p.is_shard() and p.dim != 2
          else Replicate() for p in kp]
    if online:
        k, v = k.float(), v.float()
    k_l, v_l = (t.redistribute(mesh, kp).to_local() for t in (k, v))
    q_l = qg.redistribute(mesh, qp).to_local()
    mask_l = mask.redistribute(mesh, mp).to_local()
    if online:
        o = _attention_online(q_l, k_l, v_l, mask_l, scale, softcap, kv_chunk)
    else:
        def over(t, op):
            return reduce_over(t, k, 1, op)
        s = _scores(q_l, k_l, scale, softcap)
        s = torch.where(mask_l[:, None, None], s, NEG_INF)
        e = torch.exp(s - over(s.amax(dim=-1, keepdim=True), "max"))
        p = e / over(e.sum(dim=-1, keepdim=True), "sum")
        o = over(contract("bghqk,bkhd->bqghd", p, v_l.float()), "sum")
    shape = (*qg.shape[:4], v.shape[3])
    return DTensor.from_local(o.contiguous(), mesh, qp, run_check=False,
                              shape=shape, stride=contiguous_stride(*shape))


# ---------------------------------------------------------------------------
# Projection helpers (GQA)
# ---------------------------------------------------------------------------


def qkv_project(x: torch.Tensor, p: Dict
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(project("bsd,dhk->bshk", x, p[w])
                 for w in ("wq", "wk", "wv"))


def out_project(o: torch.Tensor, p: Dict) -> torch.Tensor:
    return project("bshk,hkd->bsd", o, p["wo"])


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    # Over DTensors, a scale split where x is whole cuts x (hymba's fused
    # heads' norms), whatever the torch's strategy for the product.
    return (cut_as(xf * torch.rsqrt(var + eps), scale)
            * scale.float()).to(x.dtype)


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
                rope_theta: float, window: Optional[int] = None,
                kv_chunk: Optional[int] = None,
                cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Multi-head latent attention.

    Cache (decode) stores only (c_kv, k_rope): kv_lora + qk_rope floats per
    token per layer.  The cache's tensors are written in place and
    returned in the new entry: the caller's old cache is consumed.
    Decode (one token) writes each row at its own position, which must be
    below the cache's length; a longer write starts at `index`, moved
    back so that it fits, as the reference's dynamic_update_slice does.

    The mask is made from `positions` and `window`, causal against the
    keys' positions (the cache is positional, no ring: slot i holds
    token i).  Where the cache's slots are split (a DTensor on a mesh),
    each rank makes its own rows' (`_latent_attention_split`), and no
    mask is moved.

    Returns (attn_out (B,S,D_model), new_cache_entries).
    """
    split = (cache is not None and isinstance(cache["c_kv"], DTensor)
             and is_split(cache["c_kv"], 1))
    if not split:
        kv_pos = positions if cache is None else slot_positions(cache["c_kv"])
        mask = make_mask(positions, kv_pos, window=window)
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
            at = positions[:, 0].long()
            write_rows_(c_full, at, c_kv[:, 0].to(c_full.dtype))
            write_rows_(kr_full, at, k_rope[:, 0].to(kr_full.dtype))
        else:
            start = min(max(int(idx), 0), c_full.shape[1] - s)
            span = slice(start, start + s)
            write_columns_(c_full, span, c_kv.to(c_full.dtype))
            write_columns_(kr_full, span, k_rope.to(kr_full.dtype))
        new_cache = {"c_kv": c_full, "k_rope": kr_full, "index": idx + s}
        c_use, kr_use = c_full, kr_full
    else:
        new_cache = {}
        c_use, kr_use = c_kv, k_rope

    if split:
        o = _latent_attention_split(q_nope, q_rope, c_use, kr_use, p,
                                    positions, window, qk_nope, qk_rope,
                                    kv_chunk)
    else:
        o = _latent_attention(q_nope, q_rope, c_use, kr_use, p["w_uk"],
                              p["w_uv"], mask, qk_nope, qk_rope, kv_chunk)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, new_cache


def _latent_attention(q_nope, q_rope, c, kr, w_uk, w_uv, mask, qk_nope,
                      qk_rope, kv_chunk):
    """Attention over keys and values expanded from the latent `c` and
    the shared rope key `kr`; returns (B, S, H, v_dim)."""
    # Expand keys/values from the latent explicitly, as the reference does.
    k_nope = contract("bsc,chk->bshk", c, w_uk)
    v = contract("bsc,chk->bshk", c, w_uv)
    kh = k_nope.shape[2]
    kr_b = kr[:, :, None, :].expand(*kr.shape[:2], kh, qk_rope)
    k = torch.cat([k_nope, kr_b], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)

    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    return gqa_attention(q_full, k, v, mask, scale=scale, kv_chunk=kv_chunk)


def _latent_attention_split(q_nope, q_rope, c, kr, p, positions, window,
                            qk_nope, qk_rope, kv_chunk):
    """`_latent_attention` over a DTensor latent cache whose slots are
    split (decode or prefill on a mesh), on each rank's local tensors:
    the latent and the rope key are gathered whole over their slots once
    a call (in the cache's dtype), and each rank expands and attends its
    rows and the heads its weights hold.  (XLA instead expands each
    device's slots and moves the float32 keys and values to the heads,
    an all-to-all of about the same bytes.)  The mask is made on each
    rank for its rows and every slot, from the queries' `positions`
    (B, S) and `window` (causal, slot i holding token i), as
    `mla_forward` makes it whole: only the positions move, never a
    (B, S, Skv) mask."""
    mesh = c.device_mesh
    rows = [q.is_shard() and q.dim == 0 for q in c.placements]
    heads = [not r and w.is_shard() and w.dim == 1
             for r, w in zip(rows, p["w_uk"].placements)]
    cp = [Shard(0) if r else Replicate() for r in rows]
    wp = [Shard(1) if h else Replicate() for h in heads]
    qp = [Shard(0) if r else Shard(2) if h else Replicate()
          for r, h in zip(rows, heads)]
    if not isinstance(positions, DTensor):
        positions = DTensor.from_local(positions, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
    local = [*(t.redistribute(mesh, qp).to_local() for t in (q_nope, q_rope)),
             *(t.redistribute(mesh, cp).to_local() for t in (c, kr)),
             *(p[w].redistribute(mesh, wp).to_local()
               for w in ("w_uk", "w_uv"))]
    mask = make_mask(positions.redistribute(mesh, cp).to_local(),
                     slot_positions(local[2]), window=window)
    o = _latent_attention(*local, mask, qk_nope, qk_rope, kv_chunk)
    shape = (*q_nope.shape[:3], p["w_uv"].shape[2])
    return DTensor.from_local(o.contiguous(), mesh, qp, run_check=False,
                              shape=shape, stride=contiguous_stride(*shape))
