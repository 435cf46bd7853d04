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

Over a model axis (``layers.enable_activation_sharding``) the block runs
tensor parallel under the reference's placement, which it does not
change: ``wz`` / ``wx`` columns, ``wdt``, ``A_log``, ``dt_bias``, ``D`` and
``norm`` split by heads (a rank holds nh/M heads, d_in/M channels of z
and x), ``wbc`` whole, ``wo`` by rows, and ``conv_w`` / ``conv_b`` split
evenly over ``conv_dim = d_in + 2·ng·ds``:

* the input enters through ``sharding.copy_to``, and so does ``wbc``:
  every rank needs all of B and C (one group feeds every head).  As the
  reference's partitioner does, each rank projects its 1/M of B/C's
  columns and the outputs are gathered over 'model'; the gathered
  output's gradient, a part on each rank, is summed and cut back
  (``sharding.gather_reduce_scatter``), and the gradients of ``wbc`` and
  of the input are sums over the ranks;
* the conv's channels are the rank's x channels and every B/C channel,
  which its even slice of ``conv_w`` / ``conv_b`` is not (mamba2 at M = 2:
  2176 conv channels a rank against 2048 of x).  The two leaves are tiny
  ([d_conv + 1, conv_dim] together), so each rank gathers them whole in
  one all-gather and takes the columns it needs; their gradient, a part
  on each rank, is summed and cut back to the rank's even slice
  (``sharding.gather_reduce_scatter``);
* SSD runs on the rank's heads with no collective;
* the gated RMSNorm's mean runs over the whole ``d_in``: the float32 sum
  of squares is all-reduced over 'model' before the rsqrt, its gradient
  too (``sharding.sum_over``);
* ``wo`` is row-parallel: the partial sums end in ``sharding.reduce_from``.

Under sequence parallelism (``layers.SEQ_SHARD``) the input is every
position, gathered over 'model' (``layers.region_in``), the conv and the
chunked scan run on the whole sequence, ``wo``'s partial sums are
reduce-scattered back to this rank's positions and ``wbc`` is used as it
is, its gradient summed by ``sharding.sync_grads``.

The cache keeps the reference's placement (``launch.mesh.cache_pspec_for``):
``h`` splits with the rank's heads; ``conv`` splits conv_dim evenly, as
``conv_w`` does, so a rank's shard holds pre-conv inputs that other ranks'
``wx`` columns produce.  Prefill gathers the prompt's last ``d_conv - 1``
x inputs over 'model' and keeps its slice; each decode step gathers the
conv shards, the new token's x inputs and the conv weights in one
all-gather ([B, d_conv - 1, conv_dim] + [B, d_in] + B/C's [B, 2·ng·ds] +
[d_conv + 1, conv_dim] a layer) and writes its slice of the new window:
with the norm's and ``wo``'s all-reduces, three collectives a layer and
step.
A block whose leaves the placement keeps whole (nothing divides the model
axis) runs whole on every model rank and sums nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.train import sharding


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
    the diagonal.  The exponent is masked to -inf above the diagonal before
    the exponential: there it is a sum of -la, which overflows float32 at a
    256-step chunk, and the reference's exp-then-mask then gives the
    backward 0 · inf = NaN (ROADMAP C.20).  The values are the same."""
    lc = la_c.shape[-1]
    cs = torch.cumsum(la_c, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=la_c.device))
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


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


def _split(p: dict, cfg: ModelConfig):
    """The mesh when this rank holds a slice of the block's heads, else
    None (the block whole on every model rank).  The placement splits
    d_in, the heads and conv_dim (so B/C's 2·ng·ds columns too) wherever
    the model axis divides them, which for every config is all or none of
    them; another split raises, and so does a split of heads that read
    more than one B/C group (every config has one)."""
    mesh = layers.model_parallel()
    if mesh is None:
        return None
    s, d_in, nh = _dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    split = (p["wx"].shape[-1] < d_in, p["wdt"].shape[-1] < nh, p["conv_w"].shape[-1] < conv_dim)
    if not any(split):
        return None
    if not all(split) or s.n_groups > 1:
        raise ValueError(f"{cfg.name}: over a model axis of {layers._ACT_MODEL_SIZE} the SSM block splits"
                         f" d_in {d_in}, nh {nh} and conv_dim {conv_dim} as {split} with {s.n_groups}"
                         " B/C groups: they split together, and only where one group feeds every head")
    return mesh


def _model_index(mesh) -> int:
    return mesh.axis_index(layers._ACT_MODEL_AXIS)


def _gather_last(ts: list, mesh) -> list:
    """Each tensor of ``ts`` (this rank's even slice of a last dim split
    over the model axis) whole along that dim, in one all-gather."""
    n = [t.numel() for t in ts]
    every = sharding.all_gather(torch.cat([t.flatten() for t in ts])[None], mesh, layers._ACT_MODEL_AXIS, 0)
    out, off = [], 0
    for t, k in zip(ts, n):
        part = every[:, off : off + k].reshape(every.shape[0], *t.shape)  # [M, ..., c]
        out.append(part.movedim(0, -2).flatten(-2))
        off += k
    return out


def _my_slice(n: int, mesh) -> slice:
    """This rank's even slice of ``n`` over the model axis."""
    w = n // mesh.axis_size(layers._ACT_MODEL_AXIS)
    return slice(_model_index(mesh) * w, (_model_index(mesh) + 1) * w)


def _mine(t: torch.Tensor, d_in: int, x_local: int, mesh) -> torch.Tensor:
    """The channels this rank convolves out of a whole last dim of
    ``conv_dim``: its x channels, then every B/C channel."""
    lo = _model_index(mesh) * x_local
    return torch.cat([t[..., lo : lo + x_local], t[..., d_in:]], dim=-1)


def _conv_wb(p: dict, dtype) -> torch.Tensor:
    """conv_w over conv_b, [K + 1, c] in ``dtype`` (this rank's slice of
    conv_dim under a split)."""
    return torch.cat([p["conv_w"].to(dtype), p["conv_b"].to(dtype)[None]], dim=0)


def _conv_params(p: dict, cfg: ModelConfig, mesh, dtype):
    """(conv_w [K, C'], conv_b [C']) in ``dtype`` for the channels this rank
    convolves: all of them without a split; under one, this rank's x
    channels and every B/C channel, out of the leaves gathered whole (one
    all-gather; the gradient summed and cut back to this rank's slice)."""
    wb = _conv_wb(p, dtype)
    if mesh is not None:
        wb = sharding.gather_reduce_scatter(wb, mesh, layers._ACT_MODEL_AXIS, 1)
        wb = _mine(wb, _dims(cfg)[1], p["wx"].shape[-1], mesh)
    return wb[:-1], wb[-1]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """The gated RMSNorm in float32, its mean over the whole d_in: under a
    split, this rank's sum of squares all-reduced over 'model'."""
    _s, d_in, _nh = _dims(cfg)
    yf = (y * F.silu(z.float()).to(y.dtype)).float()
    ss = (yf * yf).sum(dim=-1, keepdim=True)
    if mesh is not None:
        ss = sharding.sum_over(ss, mesh, layers._ACT_MODEL_AXIS)
    return yf * torch.rsqrt(ss / d_in + cfg.norm_eps) * scale.float()


def ssm_fwd(p: dict, cfg: ModelConfig, u: torch.Tensor, state: bool = True):
    """Full-sequence Mamba2 block. u: [B, S, D] -> (y [B, S, D], final state
    {'h' f32 [B, nh, ds, hd], 'conv' [B, d_conv - 1, C], 'pos' int32 [B]},
    or None without ``state``).  Over a model axis (module docstring): this
    rank's heads of 'h' and its slice of 'conv' as ``conv_w`` splits it."""
    s, d_in, nh = _dims(cfg)
    dt_ = u.dtype
    ng = s.n_groups * s.d_state
    mesh = _split(p, cfg)
    wbc = p["wbc"]
    u = layers.region_in(u, mesh is not None)  # the region's entry (every position under SEQ_SHARD)
    b, slen, _ = u.shape
    if mesh is not None:  # wbc's output feeds every rank's heads
        wbc = layers.region_weight(wbc)
    z = u @ p["wz"].to(dt_)
    x = u @ p["wx"].to(dt_)
    if mesh is None:
        bc = u @ wbc.to(dt_)
    else:  # this rank's columns, gathered; each rank's gradient of them summed back
        bc = u @ wbc[:, _my_slice(2 * ng, mesh)].to(dt_)
        bc = sharding.gather_reduce_scatter(bc, mesh, layers._ACT_MODEL_AXIS, bc.dim() - 1)
    dt_raw = u @ p["wdt"].to(dt_)
    x_local, nh_local = x.shape[-1], dt_raw.shape[-1]

    xbc_pre = torch.cat([x, bc], dim=-1)
    xbc = _causal_conv(xbc_pre, *_conv_params(p, cfg, mesh, dt_))
    x, bc = xbc[..., :x_local], xbc[..., x_local:]
    Bm = bc[..., :ng].reshape(b, slen, s.n_groups, s.d_state)
    Cm = bc[..., ng:].reshape(b, slen, s.n_groups, s.d_state)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = x.reshape(b, slen, nh_local, s.head_dim)
    y, h_last = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(b, slen, x_local)

    # gated RMSNorm, then the output projection (row-parallel under a split)
    y = _gated_norm(y, z, p["norm"], cfg, mesh).to(dt_)
    out = layers.region_out(y @ p["wo"].to(dt_), mesh is not None)
    if not state:
        return out, None

    # the conv state holds the PRE-conv inputs of the last d_conv - 1 steps
    take = min(s.d_conv - 1, slen)
    tail = xbc_pre[:, slen - take :]
    if mesh is not None:  # every x channel, then this rank's slice as conv_w's
        tail = torch.cat([*_gather_last([tail[..., :x_local]], mesh), tail[..., x_local:]], dim=-1)
        tail = tail[..., _my_slice(tail.shape[-1], mesh)]
    conv_state = u.new_zeros(b, s.d_conv - 1, tail.shape[-1])
    conv_state[:, s.d_conv - 1 - take :] = tail
    pos = torch.full((b,), slen, dtype=torch.int32, device=u.device)
    return out, {"h": h_last, "conv": conv_state, "pos": pos}


def ssm_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, state: dict):
    """Single-token recurrence. u: [B, 1, D]; ``state`` updated in place
    and returned (over a model axis: this rank's shards, module
    docstring)."""
    s, d_in, nh = _dims(cfg)
    b = u.shape[0]
    dt_ = u.dtype
    ng = s.n_groups * s.d_state
    mesh = _split(p, cfg)
    u1 = u[:, 0]
    z = u1 @ p["wz"].to(dt_)
    x = u1 @ p["wx"].to(dt_)
    wbc = p["wbc"] if mesh is None else p["wbc"][:, _my_slice(2 * ng, mesh)]
    bc = u1 @ wbc.to(dt_)
    dt_raw = u1 @ p["wdt"].to(dt_)
    x_local, nh_local = x.shape[-1], dt_raw.shape[-1]

    old, x_all, wb = state["conv"], x, _conv_wb(p, dt_)
    if mesh is not None:  # the whole window and conv weights: shards, new x and B/C inputs in one all-gather
        x_all, bc, old, wb = _gather_last([x, bc, old, wb], mesh)
        wb = _mine(wb, d_in, x_local, mesh)
    window = torch.cat([old, torch.cat([x_all, bc], dim=-1)[:, None, :]], dim=1)  # [B, K, C]
    w, cb = wb[:-1], wb[-1]
    mine = window if mesh is None else _mine(window, d_in, x_local, mesh)
    conv_out = (mine * w[None]).sum(dim=1) + cb
    xbc_act = F.silu(conv_out)
    x_act, bc_act = xbc_act[..., :x_local], xbc_act[..., x_local:]
    rep = nh_local // s.n_groups  # this rank's heads
    Bh = bc_act[..., :ng].reshape(b, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    Ch = bc_act[..., ng:].reshape(b, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)  # [B, nh]
    xh = x_act.reshape(b, nh_local, s.head_dim).float()
    h = state["h"] * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh.float() * dt[..., None], xh
    )
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), h)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(b, x_local)

    y = _gated_norm(y, z, p["norm"], cfg, mesh).to(dt_)
    out = (y @ p["wo"].to(dt_))[:, None, :]
    if mesh is not None:
        out = sharding.reduce_from(out, mesh, layers._ACT_MODEL_AXIS)
    keep = window[:, 1:] if mesh is None else window[:, 1:, _my_slice(window.shape[-1], mesh)]
    state["h"].copy_(h)
    state["conv"].copy_(keep)
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
