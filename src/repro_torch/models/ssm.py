"""State-space mixers: RWKV6 (Finch) time/channel mix and Mamba (for Hymba).

Each recurrence has two forms, as in the reference: a naive `*_scan`,
sequential over time, and a *chunked* closed form (log-space decays,
chunk = 16 tokens) in which the (t, j) pairs of a chunk are matmuls and
a loop over chunks carries the recurrent state.  The reference's
jax.lax.scan(jax.checkpoint(step)) loops are `common.scan` here, a
Python loop with the same math in the same order: each chunk runs under
a checkpoint (`common.remat`, whatever `cfg.remat` says), so a backward
pass recomputes a chunk's pair tensors instead of keeping them for every
chunk of every layer; the dry run's trace runs a few chunks and counts
the others.  The chunks' batched products go through `common.contract`,
so a partitioned step runs each rank's rows and channels in every chunk
with no collective.

Numerics: per-channel log decays are clamped at LOG_DECAY_MIN = -8
(per-token decay 3.4e-4), which bounds every exponent in the chunked
form by chunk*8 = 128 < log(float32 max).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.common import (aligned, batched, contract, project,
                                       scan)

CHUNK = 16
LOG_DECAY_MIN = -8.0


# ---------------------------------------------------------------------------
# RWKV6 (Finch) — data-dependent decay WKV
# ---------------------------------------------------------------------------


def wkv6_scan(r, k, v, w, u, state0):
    """Naive reference: sequential over time.

    r/k: (B,S,H,K); v: (B,S,H,V); w: (B,S,H,K) decays in (0,1);
    u: (H,K) bonus; state0: (B,H,K,V).
    Returns (y (B,S,H,V), state (B,H,K,V)).
    """
    r, k, v, w = (t.float() for t in (r, k, v, w))
    s = state0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = contract("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(contract("bhk,bhkv->bhv", r[:, t],
                           s + u[None, :, :, None] * kv))
        s = w[:, t, ..., None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_chunked(r, k, v, w, u, state0, *, chunk: int = CHUNK):
    """Chunked closed form of the WKV6 recurrence (log-space, exact up to
    the LOG_DECAY_MIN clamp)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not a multiple of chunk {chunk}")
    n = s // chunk
    f32 = torch.float32
    rc = r.float().reshape(b, n, chunk, h, dk)
    kc = k.float().reshape(b, n, chunk, h, dk)
    vc = v.float().reshape(b, n, chunk, h, dv)
    lw = torch.clamp_min(torch.log(w.float()), LOG_DECAY_MIN)
    lwc = lw.reshape(b, n, chunk, h, dk)

    ones = torch.ones((chunk, chunk), dtype=f32, device=r.device)
    tri_lower = torch.tril(ones, diagonal=-1)                  # j < t
    eye = torch.eye(chunk, dtype=f32, device=r.device)

    def step(state, r_i, k_i, v_i, lw_i):
        c = torch.cumsum(lw_i, dim=1)              # inclusive cumsum
        c_prev = c - lw_i                          # cum up to t-1
        m = c[:, chunk // 2]                       # (B,H,K) midpoint shift
        # inter-chunk: y_t += (r_t * exp(c_prev)) @ state
        r_decay = r_i * torch.exp(c_prev)
        y_inter = contract("bchk,bhkv->bchv", r_decay, state)
        # intra-chunk: A[t,j] = sum_k r_t k_j exp(c_prev_t - c_j), j < t.
        # Invalid (j >= t) pairs can overflow to +inf before masking, so
        # mask with `where` (0*inf would be NaN).
        r_sh = r_i * torch.exp(c_prev - m[:, None])
        k_sh = k_i * torch.exp(m[:, None] - c)
        a = contract("bthk,bjhk->bhtj", r_sh, k_sh)
        a = torch.where(tri_lower > 0, a, 0.0)
        # bonus diagonal: r_t . (u * k_t)
        diag = contract("bthk,bthk->bht", r_i, u[None, None] * k_i)
        a = a + diag[..., None] * eye
        y_intra = contract("bhtj,bjhv->bthv", a, v_i)
        # state update: S' = exp(sum lw) * S + sum_j exp(c_last - c_j) k_j v_j
        c_last = c[:, -1]                          # (B,H,K)
        k_tail = k_i * torch.exp(c_last[:, None] - c)
        state = (torch.exp(c_last)[..., None] * state
                 + contract("bjhk,bjhv->bhkv", k_tail, v_i))
        return state, y_inter + y_intra

    state, ys = scan(step, state0.float(), (rc, kc, vc, lwc))
    return ys.reshape(b, s, h, dv), state


def token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """x_{t-1} stream; `prev` is the last token of the previous segment
    (decode cache), zeros at sequence start."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None, :] if prev.ndim == 2 else prev
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv6_time_mix(x: torch.Tensor, p: Dict, *, num_heads: int,
                   state: Optional[Dict] = None,
                   chunked: bool = True) -> Tuple[torch.Tensor, Dict]:
    """RWKV6 attention-free mixer (Finch ddlerp token shift).

    x: (B,S,D). Returns (out, new_state).
    """
    b, s, d = x.shape
    dk = d // num_heads
    prev_x = state["shift"] if state is not None else None
    xprev = token_shift(x, prev_x)
    xx = xprev - x

    # Finch data-dependent token shift: one fused W1 (D, 5R), tanh, then a
    # per-stream W2 (R, D); streams ordered (r, k, v, g, w).
    base = x + xx * p["mu_x"]
    r5 = torch.tanh(project("bsd,dnr->bsnr", base, p["ts_w1"]))
    dyn = project("bsnr,nrd->bsnd", r5, p["ts_w2"])
    streams = {}
    for i, name in enumerate(("r", "k", "v", "g", "w")):
        mix = p[f"mu_{name}"][None, None] + dyn[:, :, i]
        streams[name] = x + xx * mix
    r = project("bsd,dhk->bshk", streams["r"], p["wr"])
    k = project("bsd,dhk->bshk", streams["k"], p["wk"])
    v = project("bsd,dhk->bshk", streams["v"], p["wv"])
    g = F.silu(project("bsd,de->bse", streams["g"], p["wg"]))
    # Data-dependent decay (the Finch contribution).
    wdyn = project("bsr,rd->bsd",
                   torch.tanh(project("bsd,dr->bsr", streams["w"],
                                      p["w_lora_a"])),
                   p["w_lora_b"])
    w = torch.exp(-torch.exp((p["w0"][None, None] + wdyn).float()))
    w = w.reshape(b, s, num_heads, dk)

    s0 = (state["wkv"] if state is not None else
          batched(torch.zeros, x, (b, num_heads, dk, dk),
                  dtype=torch.float32))
    fn = wkv6_chunked if (chunked and s % CHUNK == 0 and s > 1) else wkv6_scan
    y, s_new = fn(r, k, v, w, p["u"], s0)

    # Per-head group norm, then gate and project out.
    y = _group_norm(y, p["gn_scale"], p["gn_bias"])
    y = y.reshape(b, s, d) * g
    out = project("bse,ed->bsd", y.to(x.dtype), p["wo"])
    new_state = {"shift": x[:, -1], "wkv": s_new}
    return out, new_state


def _group_norm(y, scale, bias, eps=64e-5):
    # y: (B,S,H,V) normalized per head (RWKV uses GroupNorm(H) with eps*64).
    f = y.float()
    mu = f.mean(-1, keepdim=True)
    var = f.var(-1, keepdim=True, correction=0)
    yn = (f - mu) * torch.rsqrt(var + eps)
    return yn * scale[None, None] + bias[None, None]


def rwkv6_channel_mix(x: torch.Tensor, p: Dict,
                      state: Optional[Dict] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    prev_x = state["shift"] if state is not None else None
    xprev = token_shift(x, prev_x)
    xx = xprev - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    k = project("bsd,df->bsf", xk, p["wk"])
    k = torch.square(F.relu(k))
    kv = project("bsf,fd->bsd", k, p["wv"])
    r = torch.sigmoid(project("bsd,de->bse", xr, p["wr"]))
    return aligned(r, kv) * kv, {"shift": x[:, -1]}


# ---------------------------------------------------------------------------
# Mamba (selective SSM) — Hymba's parallel head
# ---------------------------------------------------------------------------


def mamba_scan(u, dt, A, B, C, D, h0):
    """Reference: u (B,S,E), dt (B,S,E), A (E,N), B/C (B,S,N), D (E),
    h0 (B,E,N). Returns (y (B,S,E), h)."""
    u, dt, B, C = (t.float() for t in (u, dt, B, C))
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        u_t, dt_t, b_t, c_t = u[:, t], dt[:, t], B[:, t], C[:, t]
        da = torch.exp(dt_t[..., None] * A[None])        # (B,E,N)
        h = da * h + (dt_t * u_t)[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("ben,bn->be", h, c_t) + D[None] * u_t)
    return torch.stack(ys, dim=1), h


def mamba_chunked(u, dt, A, B, C, D, h0, *, chunk: int = CHUNK):
    """Chunked closed form of the selective-SSM recurrence.

    Exponent factorization: cum decay for channel e, state n over tokens is
    A[e,n] * cumsum(dt)[t,e], so pairwise decay uses dt-cumsum differences.
    """
    b, s, e = u.shape
    n_state = A.shape[1]
    if s % chunk:
        raise ValueError(f"seq {s} not a multiple of chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    uc = u.float().reshape(b, nc, chunk, e)
    dtc = dt.float().reshape(b, nc, chunk, e)
    Bc = B.float().reshape(b, nc, chunk, n_state)
    Cc = C.float().reshape(b, nc, chunk, n_state)
    Af = A.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=u.device))

    def step(h, u_i, dt_i, b_i, c_i):
        dc = torch.cumsum(dt_i, dim=1)                   # (B,C,E) inclusive
        # inter: y_t += C_t . (exp(A * dc_t) * h)
        decay_t = torch.exp(contract("bce,en->bcen", dc, Af))
        y_inter = contract("bcn,bcen->bce", c_i, decay_t * h[:, None])
        # intra: y_t[e] += sum_{j<=t} dt_j u_j[e] *
        #                  sum_n C_t[n] B_j[n] exp(A[e,n] (dc_t - dc_j)[e])
        # Mask delta *before* exp: j > t gives positive exponents that can
        # overflow even though those pairs are discarded.
        delta = dc[:, :, None, :] - dc[:, None, :, :]    # (B,t,j,E)
        delta = torch.where(tri[None, :, :, None] > 0, delta, 0.0)
        expf = torch.exp(contract("btje,en->btjen", delta, Af))
        if isinstance(expf, DTensor):
            # One product over DTensors: C_t B_j alone would be whole on
            # every rank, and its gradient, a partial sum over the
            # channels' split, reduced in every chunk; here the
            # gradients of B and C stay partial sums over the chunks.
            pair = contract("btjen,btn,bjn->btje", expf, c_i, b_i)
        else:
            cb = contract("btn,bjn->btjn", c_i, b_i)     # (B,t,j,N)
            pair = contract("btjen,btjn->btje", expf, cb)
        pair = pair * tri[None, :, :, None]
        du = dt_i * u_i                                  # (B,C,E)
        y_intra = contract("btje,bje->bte", pair, du)
        # state update: exp(A (dc_last - dc_j)) has non-positive exponent.
        dc_last = dc[:, -1]                              # (B,E)
        tail = torch.exp(contract(
            "bje,en->bjen", dc_last[:, None] - dc, Af))
        h = (torch.exp(contract("be,en->ben", dc_last, Af)) * h
             + contract("bjen,bje,bjn->ben", tail, du, b_i))
        return h, y_inter + y_intra + D[None, None] * u_i

    h, ys = scan(step, h0.float(), (uc, dtc, Bc, Cc))
    return ys.reshape(b, s, e), h


def causal_conv1d(x, w, bias, state=None):
    """Depthwise causal conv. x: (B,S,E), w: (K,E). state: (B,K-1,E).

    A sum of shifted products, as the reference computes it (no
    F.conv1d, which the card would run in TF32 by default)."""
    k = w.shape[0]
    if state is None:
        state = batched(torch.zeros, x, (x.shape[0], k - 1, x.shape[2]),
                        dtype=x.dtype)
    xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return out + bias[None, None], new_state


def _in_project(x, w):
    """The two halves of `x`'s product with the input projection `w`
    (D, 2E): the SSM's input and its gate.  On plain tensors, and for a
    one-token step, one product, chunked.  Over DTensors of a sequence
    each half of the weight takes the whole weight's split (its columns
    over the model axis) and is projected on its own: the product's
    halves, split there, would be gathered to be chunked (two
    bfloat16[32, 32768, 200] a layer of a 32k prefill), where the
    weight's half is a few hundred kilobytes.  A one-token step's
    product is smaller than the weight, so it keeps the one product."""
    if not isinstance(w, DTensor) or x.shape[1] == 1:
        return torch.einsum("bsd,de->bse", x, w).chunk(2, dim=-1)
    return [project("bsd,de->bse", x,
                    half.redistribute(w.device_mesh, w.placements))
            for half in w.chunk(2, dim=-1)]


def mamba_mixer(x: torch.Tensor, p: Dict, *, state: Optional[Dict] = None,
                chunked: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Mamba block. x: (B,S,D) -> (B,S,D)."""
    b, s, _ = x.shape
    xin, z = _in_project(x, p["in_proj"])
    conv_state = state["conv"] if state is not None else None
    xin, conv_new = causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin)
    n_state = p["A_log"].shape[1]
    proj = torch.einsum("bse,ek->bsk", xin, p["x_proj"])
    if isinstance(proj, DTensor):
        # The partial sum over the channels' split is reduced once here,
        # not in every chunk of the scan that reads B and C.
        proj = proj.redistribute(proj.device_mesh, [
            Replicate() if q.is_partial() else q for q in proj.placements])
    dt_rank = p["dt_proj"].shape[0]
    dt_lo, Bm, Cm = torch.split(
        proj, [dt_rank, n_state, proj.shape[-1] - dt_rank - n_state], dim=-1)
    dt = F.softplus(torch.einsum("bsr,re->bse", dt_lo, p["dt_proj"])
                    + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"].float())
    h0 = (state["ssm"] if state is not None else
          batched(torch.zeros, x, (b, xin.shape[-1], n_state),
                  dtype=torch.float32))
    fn = mamba_chunked if (chunked and s % CHUNK == 0 and s > 1) else mamba_scan
    y, h = fn(xin, dt, A, Bm, Cm, p["D"], h0)
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, {"conv": conv_new, "ssm": h}
