"""Mamba2 SSD (state-space duality, arXiv:2405.21060): port of
``repro.models.ssm``.

Prefill uses the chunked SSD algorithm: within a chunk the recurrence is a
masked, decay-weighted quadratic form (batched matmuls); across chunks a
loop carries the ``[B, heads, d_state, head_dim]`` state in float32.
Decode is the O(1) recurrence ``h = a·h + dt·(B ⊗ x)``, ``y = C·h + D·x``
plus a conv state holding the last ``d_conv - 1`` pre-conv inputs.

The reference computes SSD outside any Pallas kernel, so plain tensor
contractions are its port.  The casts are the reference's, at the same
points: ``dt·x`` and the chunk states rounded to the activations' dtype,
``C·B`` rounded to bf16 before its decay weighting, the state scan and
the decode recurrence in float32.  ``ssm_decode`` updates the state it is
given in place (the reference returns a new one).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    return s, d_in, nh


def ssm_specs(cfg: ModelConfig) -> dict:
    s, d_in, nh = _dims(cfg)
    d = cfg.d_model
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        "wz": ParamSpec((d, d_in), ("embed", "ssm_inner")),
        "wx": ParamSpec((d, d_in), ("embed", "ssm_inner")),
        "wbc": ParamSpec((d, 2 * s.n_groups * s.d_state), ("embed", "ssm_state")),
        "wdt": ParamSpec((d, nh), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.d_conv, conv_dim), (None, "ssm_inner"), scale=0.5),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "A_log": ParamSpec((nh,), ("ssm_inner",), init="zeros"),  # A = -exp(0) = -1
        "dt_bias": ParamSpec((nh,), ("ssm_inner",), init="zeros"),
        "D": ParamSpec((nh,), ("ssm_inner",), init="ones"),
        "norm": ParamSpec((d_in,), ("ssm_inner",), init="ones"),
        "wo": ParamSpec((d_in, d), ("ssm_inner", "embed")),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq, in xbc's dtype. xbc: [B, S, C]; w: [K, C]."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i : i + s] * w[i]
    return F.silu(out + b)


def _segsum_decay(la_c: torch.Tensor) -> torch.Tensor:
    """la_c: [..., Lc] log-decays -> L[i, j] = exp(Σ_{j<t<=i} la), 0 above
    the diagonal."""
    lc = la_c.shape[-1]
    cs = torch.cumsum(la_c, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=la_c.device))
    return torch.where(mask, torch.exp(diff), torch.zeros((), device=la_c.device))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """x [B, S, nh, hd]; dt [B, S, nh] (post-softplus, f32); A [nh]
    (negative); Bm, Cm [B, S, G, ds].  Returns (y [B, S, nh, hd], final
    state f32 [B, nh, ds, hd])."""
    b, s, nh, hd = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk
    rep = nh // g
    dtype = x.dtype

    xc = x.reshape(b, nc, chunk, nh, hd)
    dtc = dt.reshape(b, nc, chunk, nh).float()
    Bc = Bm.reshape(b, nc, chunk, g, ds).repeat_interleave(rep, dim=3)  # [B,NC,L,nh,ds]
    Cc = Cm.reshape(b, nc, chunk, g, ds).repeat_interleave(rep, dim=3)
    dtx = (dtc[..., None] * xc.float()).to(dtype)  # [B,NC,L,nh,hd]

    la_t = (dtc * A).transpose(2, 3)  # log decay [B,NC,nh,L]
    Lmat = _segsum_decay(la_t)  # [B,NC,nh,L,L]

    # intra-chunk (quadratic)
    cb = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)  # in x's dtype, as the reference
    y_intra = torch.einsum("bchls,bcshp->bclhp", (cb.float() * Lmat).to(dtype), dtx)

    # chunk-final states
    cum = torch.cumsum(la_t, dim=-1)  # [B,NC,nh,L]
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum(
        "bcshn,bcshp->bchnp",
        (Bc.float() * decay_to_end.transpose(2, 3)[..., None]).to(dtype),
        dtx,
    )  # [B,NC,nh,ds,hd]
    chunk_decay = torch.exp(cum[..., -1])  # [B,NC,nh]

    h = torch.zeros(b, nh, ds, hd, dtype=torch.float32, device=x.device) if h0 is None else h0.float()
    h_prev = []
    for c in range(nc):  # the state entering each chunk
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c].float()
    h_prev = torch.stack(h_prev, dim=1)  # [B,NC,nh,ds,hd]

    # inter-chunk contribution
    in_decay = torch.exp(cum).transpose(2, 3)  # [B,NC,L,nh]
    y_inter = torch.einsum(
        "bclhn,bchnp->bclhp", (Cc.float() * in_decay[..., None]).to(dtype), h_prev.to(dtype)
    )
    y = (y_intra + y_inter).reshape(b, sp, nh, hd)[:, :s]
    return y, h


def ssm_fwd(p: dict, cfg: ModelConfig, u: torch.Tensor):
    """Full-sequence Mamba2 block. u: [B, S, D] -> (y [B, S, D], final state
    {'h' f32 [B, nh, ds, hd], 'conv' [B, d_conv - 1, C], 'pos' int32 [B]})."""
    s, d_in, nh = _dims(cfg)
    b, slen, _ = u.shape
    dt_ = u.dtype
    ng = s.n_groups * s.d_state
    z = u @ p["wz"].to(dt_)
    x = u @ p["wx"].to(dt_)
    bc = u @ p["wbc"].to(dt_)
    dt_raw = u @ p["wdt"].to(dt_)

    xbc_pre = torch.cat([x, bc], dim=-1)
    xbc = _causal_conv(xbc_pre, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    x, bc = xbc[..., :d_in], xbc[..., d_in:]
    Bm = bc[..., :ng].reshape(b, slen, s.n_groups, s.d_state)
    Cm = bc[..., ng:].reshape(b, slen, s.n_groups, s.d_state)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = x.reshape(b, slen, nh, s.head_dim)
    y, h_last = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(b, slen, d_in)

    # gated RMSNorm, then the output projection
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + cfg.norm_eps) * p["norm"].float()).to(dt_)
    out = y @ p["wo"].to(dt_)

    # the conv state holds the PRE-conv inputs of the last d_conv - 1 steps
    take = min(s.d_conv - 1, slen)
    conv_state = u.new_zeros(b, s.d_conv - 1, xbc_pre.shape[-1])
    conv_state[:, s.d_conv - 1 - take :] = xbc_pre[:, slen - take :]
    pos = torch.full((b,), slen, dtype=torch.int32, device=u.device)
    return out, {"h": h_last, "conv": conv_state, "pos": pos}


def ssm_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, state: dict):
    """Single-token recurrence. u: [B, 1, D]; ``state`` updated in place
    and returned."""
    s, d_in, nh = _dims(cfg)
    b = u.shape[0]
    dt_ = u.dtype
    ng = s.n_groups * s.d_state
    u1 = u[:, 0]
    z = u1 @ p["wz"].to(dt_)
    x = u1 @ p["wx"].to(dt_)
    bc = u1 @ p["wbc"].to(dt_)
    dt_raw = u1 @ p["wdt"].to(dt_)

    xbc = torch.cat([x, bc], dim=-1)  # [B, C]
    window = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # [B, K, C]
    conv_out = (window * p["conv_w"].to(dt_)[None]).sum(dim=1) + p["conv_b"].to(dt_)
    xbc_act = F.silu(conv_out)
    x_act, bc_act = xbc_act[..., :d_in], xbc_act[..., d_in:]
    rep = nh // s.n_groups
    Bh = bc_act[..., :ng].reshape(b, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    Ch = bc_act[..., ng:].reshape(b, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)  # [B, nh]
    xh = x_act.reshape(b, nh, s.head_dim).float()
    h = state["h"] * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh.float() * dt[..., None], xh
    )
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), h)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(b, d_in)

    y = y * F.silu(z.float())
    var = (y * y).mean(dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + cfg.norm_eps) * p["norm"].float()).to(dt_)
    out = (y @ p["wo"].to(dt_))[:, None, :]
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    state["pos"].add_(1)
    return out, state


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None) -> dict:
    s, d_in, nh = _dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        "h": torch.zeros(batch, nh, s.d_state, s.head_dim, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, s.d_conv - 1, conv_dim, dtype=dtype, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
    }
