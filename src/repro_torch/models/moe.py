"""Mixture-of-Experts layer: token-choice top-k routing, shared experts,
capacity-based dispatch (port of ``repro.models.moe``).

Both of the reference's dispatch rules are kept, each with its own groups,
capacity and drop order, under the same module switch ``MOE_IMPL``:

  * 'einsum' (the default) — tokens in groups of ``MOE_GROUP_SIZE``,
    capacity ``ceil(group·k/E·cf)`` per expert and group, filled
    slot-major: slot j's tokens, in token order, after every earlier
    slot's;
  * 'scatter' — one group of all B·S tokens, capacity ``ceil(n·k/E·cf)``,
    filled token-major over the flattened (token, slot) pairs.

Tokens past an expert's capacity are dropped.  The reference writes the
dispatch and combine as dense one-hot einsums; here they are index
scatters and gathers around one batched matmul per expert weight: a kept
(token, slot) pair's row lands in its (expert, position) row of an
``[E, rows, D]`` buffer, and the expert outputs come back by the same index.
They select the same rows: each buffer row holds at most one token, so the
one-hot sums add only zeros to it.  The positions come from integer
cumulative counts over each slot's one-hot expert choice.  The combine runs
in the reference's order and dtype: y accumulated in bf16 over the slots.
The router runs in float32, the top-k probabilities are renormalised, and
the Switch-style load-balancing loss is returned beside y.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.train import sharding


def moe_specs(cfg: ModelConfig) -> dict:
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.n_routed, mo.d_ff_expert
    p = {
        "router": ParamSpec((d, e), ("embed", "experts"), scale=0.02),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
    }
    if mo.n_shared:
        fs = mo.d_ff_shared or mo.d_ff_expert * mo.n_shared
        p["shared"] = {
            "wi_gate": ParamSpec((d, fs), ("embed", "mlp")),
            "wi_up": ParamSpec((d, fs), ("embed", "mlp")),
            "wo": ParamSpec((fs, d), ("mlp", "embed")),
        }
    return p


MOE_IMPL = "einsum"  # 'einsum' (grouped, slot-major) | 'scatter' (one group, token-major)
MOE_GROUP_SIZE = 256  # tokens per dispatch group (t5x-style)


def _router(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x: [..., D] -> (probs f32 [..., E], top_p f32 [..., k] renormalised,
    top_e int64 [..., k])."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _aux_loss(cfg: ModelConfig, probs: torch.Tensor, top_e: torch.Tensor) -> torch.Tensor:
    """Switch-style load balancing: E · Σ_e mean prob_e · routed share_e.

    Over the batch axes of a mesh both means are the global batch's: the
    sums are all-reduced (the probabilities' with the gradient passed
    through, so each rank's backward gives its rows' share)."""
    e = cfg.moe.n_routed
    counts = torch.bincount(top_e.reshape(-1), minlength=e).float()
    if layers._ACT_BATCH_SIZE == 1:
        me = probs.reshape(-1, e).mean(dim=0)
        ce = counts / top_e.numel()
    else:
        mesh, axes = layers._ACT_MESH, layers._ACT_BATCH_AXES
        rows = probs.numel() // e * layers._ACT_BATCH_SIZE  # every rank routes as many rows
        me = sharding.reduce_from(probs.reshape(-1, e).sum(dim=0), mesh, axes) / rows
        ce = layers.batch_sum(counts) / (top_e.numel() * layers._ACT_BATCH_SIZE)
    return (me * ce).sum() * e * cfg.moe.aux_loss_weight


def _rank_in_expert(choice: torch.Tensor, n_experts: int) -> torch.Tensor:
    """choice: int [G, m] expert per entry -> int [G, m]: how many earlier
    entries of the same row chose the same expert."""
    oh = F.one_hot(choice, n_experts)  # [G, m, E]
    return (oh.cumsum(dim=1) - oh).gather(-1, choice[..., None])[..., 0]


def route_einsum(p: dict, cfg: ModelConfig, x: torch.Tensor) -> dict:
    """The grouped rule's routing of x [B, S, D]: 'top_e' / 'top_p' [G, gsz,
    k], 'pos' (position in the expert's buffer) and 'keep' [G, gsz, k],
    'capacity', 'aux'."""
    mo = cfg.moe
    b, s, d = x.shape
    n, e, k = b * s, mo.n_routed, mo.top_k
    gsz = min(MOE_GROUP_SIZE, n)
    if n % gsz:
        raise ValueError(f"MoE dispatch needs B·S <= {MOE_GROUP_SIZE} or a multiple of it, got {n}")
    g = n // gsz
    probs, top_p, top_e = _router(p, cfg, x.reshape(g, gsz, d))
    capacity = int(math.ceil(gsz * k / e * mo.capacity_factor))
    fill = torch.zeros(g, e, dtype=torch.int64, device=x.device)
    pos = torch.empty_like(top_e)
    for j in range(k):  # slot-major: slot j after every earlier slot
        ej = top_e[..., j]
        pos[..., j] = fill.gather(1, ej) + _rank_in_expert(ej, e)
        fill += F.one_hot(ej, e).sum(dim=1)
    return {"top_e": top_e, "top_p": top_p, "pos": pos, "keep": pos < capacity,
            "capacity": capacity, "aux": _aux_loss(cfg, probs, top_e)}


def route_scatter(p: dict, cfg: ModelConfig, x: torch.Tensor) -> dict:
    """The one-group rule's routing of x [B, S, D]: the fields of
    ``route_einsum`` with one group of all B·S tokens, filled token-major."""
    mo = cfg.moe
    b, s, d = x.shape
    n, e, k = b * s, mo.n_routed, mo.top_k
    probs, top_p, top_e = _router(p, cfg, x.reshape(1, n, d))
    capacity = int(math.ceil(n * k / e * mo.capacity_factor))
    pos = _rank_in_expert(top_e.reshape(1, n * k), e).reshape(1, n, k)
    return {"top_e": top_e, "top_p": top_p, "pos": pos, "keep": pos < capacity,
            "capacity": capacity, "aux": _aux_loss(cfg, probs, top_e)}


def _experts(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """[E, rows, D] through each expert's gated MLP, one batched matmul per
    weight."""
    h = F.silu(torch.bmm(xe, p["wi_gate"].to(xe.dtype))) * torch.bmm(xe, p["wi_up"].to(xe.dtype))
    return torch.bmm(h, p["wo"].to(xe.dtype))


def _dispatch_combine(p: dict, cfg: ModelConfig, x: torch.Tensor, r: dict) -> torch.Tensor:
    """Scatter the kept (token, slot) rows into per-expert buffers, run the
    experts, gather each slot's output back and combine over the slots in
    bf16, weighted by the renormalised probabilities."""
    b, s, d = x.shape
    top_e, pos, keep, cap = r["top_e"], r["pos"], r["keep"], r["capacity"]
    g, gsz, k = top_e.shape
    e = cfg.moe.n_routed
    rows = g * cap  # buffer rows per expert: (group, position)
    grp = torch.arange(g, device=x.device)[:, None, None]
    # a dropped pair goes to a spare last row, so no step waits on the host
    # to count the kept ones
    dest = torch.where(keep, top_e * rows + grp * cap + pos, e * rows)  # [G, gsz, k]
    tok = torch.arange(g * gsz, device=x.device).reshape(g, gsz, 1).expand(g, gsz, k)
    buf = x.new_zeros(e * rows + 1, d)
    buf[dest.reshape(-1)] = x.reshape(g * gsz, d)[tok.reshape(-1)]
    out = _experts(p, buf[:-1].reshape(e, rows, d)).reshape(e * rows, d)
    dest = dest.clamp(max=e * rows - 1)  # a dropped pair's weight is 0
    y = x.new_zeros(g, gsz, d)
    for j in range(k):
        w = r["top_p"][..., j].to(x.dtype) * keep[..., j].to(x.dtype)  # [G, gsz]
        y = y + w[..., None] * out[dest[..., j]]
    return y.reshape(b, s, d)


def moe_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor):
    if MOE_IMPL == "einsum":
        return moe_fwd_einsum(p, cfg, x)
    return moe_fwd_scatter(p, cfg, x)


def _with_shared(p: dict, cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return y + layers.mlp_fwd(p["shared"], cfg, x) if cfg.moe.n_shared else y


def moe_fwd_einsum(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped dispatch (the reference's GShard/t5x rule). x: [B, S, D] ->
    (y [B, S, D], aux loss f32)."""
    r = route_einsum(p, cfg, x)
    return _with_shared(p, cfg, x, _dispatch_combine(p, cfg, x, r)), r["aux"]


def moe_fwd_scatter(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-group dispatch (the reference's scatter rule). x: [B, S, D] ->
    (y [B, S, D], aux loss f32)."""
    r = route_scatter(p, cfg, x)
    return _with_shared(p, cfg, x, _dispatch_combine(p, cfg, x, r)), r["aux"]
