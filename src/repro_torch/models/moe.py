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

Over a mesh (``layers.enable_activation_sharding``) a rank holds its rows
of the global batch and, where the model axis M divides E, E/M of the
experts and E/M router columns (expert parallelism; the reference's
placement, ``("experts", ...)``): the router's logits are gathered whole,
so every model rank routes alike, each rank's buffers take only its
experts' pairs, and its partial y joins the shared expert's
(column/row-parallel) in one model all-reduce (``_moe``).  The groups are
the global batch's under both rules: where one spans the data ranks, the
ranks exchange their choices ('einsum': an all-gather of the top-k
experts) or their per-expert counts ('scatter': an exclusive prefix), so
capacities, positions and drops are the unsplit run's, and the experts of
such a group run as the reference's placement of the buffer splits them
over the data ranks (``_experts_over``).  Where every data rank holds
every row of a batch the data axis does not divide
(``layers.rows_context``, the reference's fallback to replication), the
groups and capacities are those of those rows alone, and nothing is
exchanged over 'data'.  The load-balancing loss is the global batch's.
Under sequence parallelism (``layers.SEQ_SHARD``) the layer's input is
gathered over 'model' first (``layers.region_in``), so the router sees
every position and the groups, capacities and drops are
those of the run without it; the split partials are reduce-scattered
back to this rank's positions, a whole layer's output cut to them, and a
router the model axis does not split takes the aux loss's gradient from
this rank's positions only (``_aux_loss``'s ``own``).
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


def _ep(p: dict, cfg: ModelConfig):
    """The mesh when this rank holds a slice of the experts (expert
    parallelism: the 'experts' dim split over the model axis), else None."""
    mesh = layers.model_parallel()
    return mesh if mesh is not None and p["router"].shape[-1] < cfg.moe.n_routed else None


def _router(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x: [..., D] -> (probs f32 [..., E], top_p f32 [..., k] renormalised,
    top_e int64 [..., k]).  Under expert parallelism ``x`` is the region's
    input (``copy_to``) and the router's E/M columns' logits are gathered
    whole, so every model rank routes the same."""
    logits = x.float() @ p["router"].float()
    mesh = _ep(p, cfg)
    if mesh is not None:
        logits = sharding.gather_from(logits, mesh, "model", -1)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _aux_loss(cfg: ModelConfig, probs: torch.Tensor, top_e: torch.Tensor, own: tuple | None = None) -> torch.Tensor:
    """Switch-style load balancing: E · Σ_e mean prob_e · routed share_e.

    Over the batch axes of a mesh both means are the global batch's: the
    sums are all-reduced (the probabilities' with the gradient passed
    through, so each rank's backward gives its rows' share).  ``own``
    (B, S): a router the model axis does not split, run on every position
    under sequence parallelism — its probabilities' sum is each model
    rank's positions' all-reduced over 'model' too, so that its gradient,
    like the layer output's, is this rank's positions' part."""
    e = cfg.moe.n_routed
    counts = _counts(top_e, e).float()
    n_ranks = layers.batch_ranks()
    split = layers._ACT_BATCH_AXES if n_ranks > 1 else ()
    if own is not None:
        mesh, axes = layers._ACT_MESH, split + (layers._ACT_MODEL_AXIS,)
        rows = probs.numel() // e * n_ranks
        mine = layers.own_positions(probs.reshape(*own, e)).reshape(-1, e)
        me = sharding.reduce_from(mine.sum(dim=0), mesh, axes) / rows
        ce = layers.batch_sum(counts) / (top_e.numel() * n_ranks)
    elif n_ranks == 1:
        me = probs.reshape(-1, e).mean(dim=0)
        ce = counts / top_e.numel()
    else:
        mesh, axes = layers._ACT_MESH, split
        rows = probs.numel() // e * n_ranks  # every rank routes as many rows
        me = sharding.reduce_from(probs.reshape(-1, e).sum(dim=0), mesh, axes) / rows
        ce = layers.batch_sum(counts) / (top_e.numel() * n_ranks)
    return (me * ce).sum() * e * cfg.moe.aux_loss_weight


def _own(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple | None:
    """x's (B, S) when ``_aux_loss`` takes this rank's positions' share: a
    router the model axis does not split, under sequence parallelism."""
    return tuple(x.shape[:2]) if layers._SEQ and _ep(p, cfg) is None else None


def _counts(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """int64 [E]: how many (token, slot) pairs chose each expert (a scatter
    add: its shape does not depend on the data, so a fake tensor traces)."""
    idx = top_e.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int64, device=idx.device).scatter_add_(0, idx, torch.ones_like(idx))


def _rank_in_expert(choice: torch.Tensor, n_experts: int) -> torch.Tensor:
    """choice: int [G, m] expert per entry -> int [G, m]: how many earlier
    entries of the same row chose the same expert."""
    oh = F.one_hot(choice, n_experts)  # [G, m, E]
    return (oh.cumsum(dim=1) - oh).gather(-1, choice[..., None])[..., 0]


def _slot_major(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """top_e: [G, gsz, k] -> each (token, slot)'s position in its expert's
    buffer of its group, slot-major: slot j's tokens, in token order, after
    every earlier slot's."""
    g = top_e.shape[0]
    fill = torch.zeros(g, n_experts, dtype=torch.int64, device=top_e.device)
    pos = torch.empty_like(top_e)
    for j in range(top_e.shape[-1]):
        ej = top_e[..., j]
        pos[..., j] = fill.gather(1, ej) + _rank_in_expert(ej, n_experts)
        fill += F.one_hot(ej, n_experts).sum(dim=1)
    return pos


def _spread() -> tuple:
    """(batch ranks D, this rank's index over the batch axes): the rows of
    a mesh's global batch are split over D ranks, this rank's the
    index-th slice (1, 0 without a mesh, or where every rank holds every
    row: ``layers.rows_context``)."""
    n_ranks = layers.batch_ranks()
    if n_ranks == 1:
        return 1, 0
    return n_ranks, layers._ACT_MESH.axis_index(layers._ACT_BATCH_AXES)


def route_einsum(p: dict, cfg: ModelConfig, x: torch.Tensor) -> dict:
    """The grouped rule's routing of x [B, S, D] (this rank's rows over a
    mesh): 'top_e' / 'top_p' [G, gsz, k], 'pos' (position in the expert's
    buffer) and 'keep' [G, gsz, k], 'grp' (each token's group, counted from
    the first one this rank holds) [G, gsz], 'groups', 'capacity', 'aux'.

    The groups are the global batch's (``MOE_GROUP_SIZE`` tokens of the
    rows in order): where one spans several data ranks (every decode step,
    and any rank whose B/D·S is not a multiple of the group) the ranks
    all-gather their experts' choices, fill those groups as the unsplit run
    does, and keep their own tokens ([1, B/D·S, k] then)."""
    mo = cfg.moe
    b, s, d = x.shape
    n, e, k = b * s, mo.n_routed, mo.top_k
    n_ranks, me = _spread()
    total = n * n_ranks
    gsz = min(MOE_GROUP_SIZE, total)
    if total % gsz:
        raise ValueError(f"MoE dispatch needs B·S <= {MOE_GROUP_SIZE} or a multiple of it, got {total}")
    capacity = int(math.ceil(gsz * k / e * mo.capacity_factor))
    if n % gsz == 0:  # whole groups of this rank's own tokens
        g = n // gsz
        probs, top_p, top_e = _router(p, cfg, x.reshape(g, gsz, d))
        pos = _slot_major(top_e, e)
        grp = torch.arange(g, device=x.device)[:, None].expand(g, gsz)
        return {"top_e": top_e, "top_p": top_p, "pos": pos, "keep": pos < capacity, "grp": grp, "groups": g,
                "capacity": capacity, "spans": False, "aux": _aux_loss(cfg, probs, top_e, _own(p, cfg, x))}
    probs, top_p, top_e = _router(p, cfg, x.reshape(1, n, d))
    every = sharding.all_gather(top_e[0], layers._ACT_MESH, layers._ACT_BATCH_AXES, 0)  # [total, k]
    pos = _slot_major(every.reshape(total // gsz, gsz, k), e).reshape(total, k)[me * n : (me + 1) * n]
    grp = torch.arange(me * n, (me + 1) * n, device=x.device)[None] // gsz
    return {"top_e": top_e, "top_p": top_p, "pos": pos[None], "keep": pos[None] < capacity, "grp": grp,
            "groups": total // gsz, "capacity": capacity, "spans": True,
            "aux": _aux_loss(cfg, probs, top_e, _own(p, cfg, x))}


def route_scatter(p: dict, cfg: ModelConfig, x: torch.Tensor) -> dict:
    """The one-group rule's routing of x [B, S, D]: the fields of
    ``route_einsum`` with one group of all B·S tokens of the global batch,
    filled token-major: over a mesh a rank's (token, slot) pairs come after
    every earlier data rank's (their per-expert counts, one all-gather),
    and the capacity is the global batch's."""
    mo = cfg.moe
    b, s, d = x.shape
    n, e, k = b * s, mo.n_routed, mo.top_k
    n_ranks, _ = _spread()
    probs, top_p, top_e = _router(p, cfg, x.reshape(1, n, d))
    capacity = int(math.ceil(n * n_ranks * k / e * mo.capacity_factor))
    pos = _rank_in_expert(top_e.reshape(1, n * k), e).reshape(1, n, k)
    if n_ranks > 1:
        counts = _counts(top_e, e)
        pos = pos + sharding.exclusive_prefix(counts, layers._ACT_MESH, layers._ACT_BATCH_AXES)[top_e]
    return {"top_e": top_e, "top_p": top_p, "pos": pos, "keep": pos < capacity,
            "grp": torch.zeros(1, n, dtype=torch.int64, device=x.device), "groups": 1,
            "capacity": capacity, "spans": n_ranks > 1, "aux": _aux_loss(cfg, probs, top_e, _own(p, cfg, x))}


def _experts(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """[E, rows, D] through each expert's gated MLP, one batched matmul per
    weight."""
    h = F.silu(torch.bmm(xe, p["wi_gate"].to(xe.dtype))) * torch.bmm(xe, p["wi_up"].to(xe.dtype))
    return torch.bmm(h, p["wo"].to(xe.dtype))


def _experts_over(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """``_experts`` of a buffer that holds this rank's tokens of groups
    spanning the data ranks (every other row zero), as the reference's
    placement of the buffer splits the work over those ranks: where the
    rows divide, each data rank sums the ranks' buffers over its slice of
    the rows (``reduce_scatter``), runs it and the slices are gathered back
    (``fsdp_gather``: its gradient summed and sliced back); else the buffers are summed whole on every data
    rank and the model dim of ``wi_gate`` / ``wi_up``'s contraction is
    split over them, the partial products summed (``reduce_from``; each
    sum's gradient summed back, ``copy_to``), ``wo`` run whole."""
    mesh, axes = layers._ACT_MESH, layers._ACT_BATCH_AXES
    n, i = mesh.axis_size(axes), mesh.axis_index(axes)
    rows, d = buf.shape[1], buf.shape[2]
    if rows % n == 0:
        out = _experts(p, sharding.reduce_scatter(buf, mesh, axes, 1))
        return sharding.fsdp_gather(out, (None, axes, None), mesh)
    if d % n:
        return _experts(p, buf)
    c = slice(i * d // n, (i + 1) * d // n)
    whole = sharding.copy_to(sharding.reduce_from(buf, mesh, axes), mesh, axes)[..., c]
    gu = torch.cat([torch.bmm(whole, p[w][:, c].to(buf.dtype)) for w in ("wi_gate", "wi_up")], dim=-1)
    g, u = sharding.copy_to(sharding.reduce_from(gu, mesh, axes), mesh, axes).chunk(2, dim=-1)
    return torch.bmm(F.silu(g) * u, p["wo"].to(buf.dtype))


def _dispatch_combine(p: dict, cfg: ModelConfig, x: torch.Tensor, r: dict, top_p: torch.Tensor) -> torch.Tensor:
    """Scatter the kept (token, slot) rows into per-expert buffers, run the
    experts, gather each slot's output back and combine over the slots in
    bf16, weighted by the renormalised probabilities ``top_p``.

    Under expert parallelism this rank holds experts [e0, e0 + E/M): only
    their pairs fill its buffers, and y is this rank's partial sum.  Where
    the groups span the data ranks, the buffer is every group's and the
    experts run through ``_experts_over``."""
    b, s, d = x.shape
    top_e, pos, keep, cap = r["top_e"], r["pos"], r["keep"], r["capacity"]
    g, gsz, k = top_e.shape
    e = p["wi_gate"].shape[0]  # this rank's experts
    e0 = 0
    if e < cfg.moe.n_routed:
        e0 = layers._ACT_MESH.axis_index(layers._ACT_MODEL_AXIS) * e
        keep = keep & (top_e >= e0) & (top_e < e0 + e)
    rows = r["groups"] * cap  # buffer rows per expert: (group, position)
    # a dropped pair (or another rank's expert) goes to a spare last row,
    # so no step waits on the host to count the kept ones
    dest = torch.where(keep, (top_e - e0) * rows + r["grp"][..., None] * cap + pos, e * rows)  # [G, gsz, k]
    tok = torch.arange(g * gsz, device=x.device).reshape(g, gsz, 1).expand(g, gsz, k)
    buf = x.new_zeros(e * rows + 1, d)
    buf[dest.reshape(-1)] = x.reshape(g * gsz, d)[tok.reshape(-1)]
    buf = buf[:-1].reshape(e, rows, d)
    out = (_experts_over(p, buf) if r["spans"] else _experts(p, buf)).reshape(e * rows, d)
    dest = dest.clamp(max=e * rows - 1)  # a dropped pair's weight is 0
    y = x.new_zeros(g, gsz, d)
    for j in range(k):
        w = top_p[..., j].to(x.dtype) * keep[..., j].to(x.dtype)  # [G, gsz]
        y = y + w[..., None] * out[dest[..., j]]
    return y.reshape(b, s, d)


def moe_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor):
    if MOE_IMPL == "einsum":
        return moe_fwd_einsum(p, cfg, x)
    return moe_fwd_scatter(p, cfg, x)


def _moe(p: dict, cfg: ModelConfig, x: torch.Tensor, route) -> tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch, combine and add the shared expert.  Over the model
    axis the split parts — this rank's experts (expert parallelism) and the
    shared expert's hidden columns (Megatron's MLP) — take the region's
    input (``copy_to``) and sum their partial outputs in ONE
    ``reduce_from``; replicated experts (E not divisible by the model axis)
    run whole on every model rank and add after it.  The probabilities
    enter the region through ``copy_to`` too, so each rank's partial
    gradient of them is summed over the model ranks."""
    mesh = layers.model_parallel()
    ep = _ep(p, cfg) is not None
    fs = cfg.moe.d_ff_shared or cfg.moe.d_ff_expert * cfg.moe.n_shared
    shared_tp = bool(cfg.moe.n_shared) and layers.mlp_split(p["shared"], fs)
    xc = layers.region_in(x, ep or shared_tp)
    xr = xc if ep or layers._SEQ else x  # the router's rows: every position under SEQ_SHARD
    r = route(p, cfg, xr)
    top_p = sharding.copy_to(r["top_p"], mesh) if ep else r["top_p"]
    routed = _dispatch_combine(p, cfg, xr, r, top_p)
    partial = [routed] if ep else []  # partial sums over 'model'
    y = None if ep else layers.region_out(routed, False)  # whole experts: this rank's positions
    if cfg.moe.n_shared and shared_tp:
        partial.append(layers.mlp_fwd(p["shared"], cfg, xc, d_ff=fs, reduce=False))
    elif cfg.moe.n_shared:  # whole, per position: on this rank's positions
        shared = layers.mlp_fwd(p["shared"], cfg, x, d_ff=fs)
        y = shared if y is None else y + shared
    if partial:
        summed = layers.region_out(sum(partial[1:], partial[0]), True)
        y = summed if y is None else summed + y
    return y, r["aux"]


def moe_fwd_einsum(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped dispatch (the reference's GShard/t5x rule). x: [B, S, D] ->
    (y [B, S, D], aux loss f32)."""
    return _moe(p, cfg, x, route_einsum)


def moe_fwd_scatter(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-group dispatch (the reference's scatter rule). x: [B, S, D] ->
    (y [B, S, D], aux loss f32)."""
    return _moe(p, cfg, x, route_scatter)
