"""State-space mixers: RWKV6 (Finch) time/channel mix and Mamba (for Hymba).

Each recurrence has two forms, as in the reference: a naive `*_scan`,
sequential over time, and a *chunked* closed form (log-space decays,
chunk = 16 tokens) in which the (t, j) pairs of a chunk are matmuls and
a loop over chunks carries the recurrent state.  The reference's
jax.lax.scan loops are explicit Python loops here, with the same math in
the same order.

Numerics: per-channel log decays are clamped at LOG_DECAY_MIN = -8
(per-token decay 3.4e-4), which bounds every exponent in the chunked
form by chunk*8 = 128 < log(float32 max).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
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

    state = state0.float()
    ys = []
    for i in range(n):
        r_i, k_i, v_i, lw_i = rc[:, i], kc[:, i], vc[:, i], lwc[:, i]
        c = torch.cumsum(lw_i, dim=1)              # inclusive cumsum
        c_prev = c - lw_i                          # cum up to t-1
        m = c[:, chunk // 2]                       # (B,H,K) midpoint shift
        # inter-chunk: y_t += (r_t * exp(c_prev)) @ state
        r_decay = r_i * torch.exp(c_prev)
        y_inter = torch.einsum("bchk,bhkv->bchv", r_decay, state)
        # intra-chunk: A[t,j] = sum_k r_t k_j exp(c_prev_t - c_j), j < t.
        # Invalid (j >= t) pairs can overflow to +inf before masking, so
        # mask with `where` (0*inf would be NaN).
        r_sh = r_i * torch.exp(c_prev - m[:, None])
        k_sh = k_i * torch.exp(m[:, None] - c)
        a = torch.einsum("bthk,bjhk->bhtj", r_sh, k_sh)
        a = torch.where(tri_lower > 0, a, 0.0)
        # bonus diagonal: r_t . (u * k_t)
        diag = torch.einsum("bthk,bthk->bht", r_i, u[None, None] * k_i)
        a = a + diag[..., None] * eye
        y_intra = torch.einsum("bhtj,bjhv->bthv", a, v_i)
        # state update: S' = exp(sum lw) * S + sum_j exp(c_last - c_j) k_j v_j
        c_last = c[:, -1]                          # (B,H,K)
        k_tail = k_i * torch.exp(c_last[:, None] - c)
        state = (torch.exp(c_last)[..., None] * state
                 + torch.einsum("bjhk,bjhv->bhkv", k_tail, v_i))
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(b, s, h, dv)
    return y, state


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
    r5 = torch.tanh(torch.einsum("bsd,dnr->bsnr", base, p["ts_w1"]))
    dyn = torch.einsum("bsnr,nrd->bsnd", r5, p["ts_w2"])
    streams = {}
    for i, name in enumerate(("r", "k", "v", "g", "w")):
        mix = p[f"mu_{name}"][None, None] + dyn[:, :, i]
        streams[name] = x + xx * mix
    r = torch.einsum("bsd,dhk->bshk", streams["r"], p["wr"])
    k = torch.einsum("bsd,dhk->bshk", streams["k"], p["wk"])
    v = torch.einsum("bsd,dhk->bshk", streams["v"], p["wv"])
    g = F.silu(torch.einsum("bsd,de->bse", streams["g"], p["wg"]))
    # Data-dependent decay (the Finch contribution).
    wdyn = torch.einsum("bsr,rd->bsd",
                        torch.tanh(torch.einsum("bsd,dr->bsr", streams["w"],
                                                p["w_lora_a"])),
                        p["w_lora_b"])
    w = torch.exp(-torch.exp((p["w0"][None, None] + wdyn).float()))
    w = w.reshape(b, s, num_heads, dk)

    s0 = (state["wkv"] if state is not None else
          torch.zeros((b, num_heads, dk, dk), dtype=torch.float32,
                      device=x.device))
    fn = wkv6_chunked if (chunked and s % CHUNK == 0 and s > 1) else wkv6_scan
    y, s_new = fn(r, k, v, w, p["u"], s0)

    # Per-head group norm, then gate and project out.
    y = _group_norm(y, p["gn_scale"], p["gn_bias"])
    y = y.reshape(b, s, d) * g
    out = torch.einsum("bse,ed->bsd", y.to(x.dtype), p["wo"])
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
    k = torch.einsum("bsd,df->bsf", xk, p["wk"])
    k = torch.square(F.relu(k))
    kv = torch.einsum("bsf,fd->bsd", k, p["wv"])
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["wr"]))
    return r * kv, {"shift": x[:, -1]}


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

    h = h0.float()
    ys = []
    for i in range(nc):
        u_i, dt_i, b_i, c_i = uc[:, i], dtc[:, i], Bc[:, i], Cc[:, i]
        dc = torch.cumsum(dt_i, dim=1)                   # (B,C,E) inclusive
        # inter: y_t += C_t . (exp(A * dc_t) * h)
        decay_t = torch.exp(torch.einsum("bce,en->bcen", dc, Af))
        y_inter = torch.einsum("bcn,bcen->bce", c_i, decay_t * h[:, None])
        # intra: y_t[e] += sum_{j<=t} dt_j u_j[e] *
        #                  sum_n C_t[n] B_j[n] exp(A[e,n] (dc_t - dc_j)[e])
        # Mask delta *before* exp: j > t gives positive exponents that can
        # overflow even though those pairs are discarded.
        delta = dc[:, :, None, :] - dc[:, None, :, :]    # (B,t,j,E)
        delta = torch.where(tri[None, :, :, None] > 0, delta, 0.0)
        expf = torch.exp(torch.einsum("btje,en->btjen", delta, Af))
        cb = torch.einsum("btn,bjn->btjn", c_i, b_i)     # (B,t,j,N)
        pair = (torch.einsum("btjen,btjn->btje", expf, cb)
                * tri[None, :, :, None])
        du = dt_i * u_i                                  # (B,C,E)
        y_intra = torch.einsum("btje,bje->bte", pair, du)
        # state update: exp(A (dc_last - dc_j)) has non-positive exponent.
        dc_last = dc[:, -1]                              # (B,E)
        tail = torch.exp(torch.einsum(
            "bje,en->bjen", dc_last[:, None] - dc, Af))
        h = (torch.exp(torch.einsum("be,en->ben", dc_last, Af)) * h
             + torch.einsum("bjen,bje,bjn->ben", tail, du, b_i))
        ys.append(y_inter + y_intra + D[None, None] * u_i)
    return torch.stack(ys, dim=1).reshape(b, s, e), h


def causal_conv1d(x, w, bias, state=None):
    """Depthwise causal conv. x: (B,S,E), w: (K,E). state: (B,K-1,E).

    A sum of shifted products, as the reference computes it (no
    F.conv1d, which the card would run in TF32 by default)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return out + bias[None, None], new_state


def mamba_mixer(x: torch.Tensor, p: Dict, *, state: Optional[Dict] = None,
                chunked: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Mamba block. x: (B,S,D) -> (B,S,D)."""
    b, s, _ = x.shape
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = xz.chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xin, conv_new = causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin)
    n_state = p["A_log"].shape[1]
    proj = torch.einsum("bse,ek->bsk", xin, p["x_proj"])
    dt_rank = p["dt_proj"].shape[0]
    dt_lo, Bm, Cm = torch.split(
        proj, [dt_rank, n_state, proj.shape[-1] - dt_rank - n_state], dim=-1)
    dt = F.softplus(torch.einsum("bsr,re->bse", dt_lo, p["dt_proj"])
                    + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"].float())
    h0 = (state["ssm"] if state is not None else
          torch.zeros((b, xin.shape[-1], n_state), dtype=torch.float32,
                      device=x.device))
    fn = mamba_chunked if (chunked and s % CHUNK == 0 and s > 1) else mamba_scan
    y, h = fn(xin, dt, A, Bm, Cm, p["D"], h0)
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, {"conv": conv_new, "ssm": h}
