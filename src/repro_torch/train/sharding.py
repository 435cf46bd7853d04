"""What GSPMD does for the reference implicitly, written out over process
groups.

The reference has no such module: it places each parameter with a
``NamedSharding`` and XLA's SPMD partitioner inserts every collective.  The
port runs one process per grid point of a ``launch.mesh.GridMesh`` and
does that work here, by placement (``models.params`` tuples):

* ``shard_of`` / ``local_tree`` slice full tensors into this rank's shards,
  and ``gather_to_root`` gathers every rank's shard back whole on rank 0
  (checkpoints);
* ``fsdp_gather`` all-gathers the dims a leaf keeps over the batch axes
  ('pod', 'data') before the leaf is used; its backward sums the gradient
  over those ranks and keeps this rank's slice (a reduce-scatter).
  ``gather_weights`` gathers parameters so, several shards in one
  all-gather (and one reduce-scatter back), their bytes counted in
  ``GATHERED`` while the gathered copies are alive (``models.transformer``
  gathers one stacked block's leaves at a time);
* ``copy_to`` (identity forward, all-reduce backward) and ``reduce_from``
  (all-reduce forward, identity backward): Megatron's two operators at the
  edges of a tensor-parallel region on the model axis; ``sum_over`` (an
  all-reduce both ways: a statistic summed over the ranks' slices, as the
  SSM's gated norm takes) and ``gather_reduce_scatter`` (a gather whose
  backward is FSDP's: a small leaf gathered whole for work split over the
  ranks, as the SSM's conv weights);
* ``vocab_parallel_embed`` and ``vocab_parallel_ce``: the embedding lookup
  and the cross-entropy with the vocabulary split over the model axis (a
  max and two sum all-reduces for the log-sum-exp, the gold logit from the
  rank that owns it);
* ``seq_gather`` (all-gather forward, reduce-scatter backward) and
  ``seq_scatter`` (reduce-scatter forward, all-gather backward): the
  edges of a tensor-parallel region under sequence parallelism
  (``models.layers.SEQ_SHARD``), where the residual stream between them
  holds this rank's S/M positions;
* ``sync_grads`` sums the gradient of a leaf over the batch axes it is
  replicated on (and over 'model' for the leaves that act on the sequence
  shards), and ``global_norm`` counts each distinct shard once;
* for expert parallelism (``models.moe``): ``exclusive_prefix`` (per-expert
  counts of the ranks before this one over the batch axes) and
  ``reduce_scatter`` (sum, then this rank's slice; backward an
  all-gather), which with ``fsdp_gather`` moves an expert buffer's
  capacity rows to the data rank that owns them and back.

Every differentiable operator is a ``torch.autograd.Function``.  Over gloo
a CUDA tensor's collective runs on a host copy (the ranks share one card,
or there is none); over NCCL it runs on the card.

Every collective is counted by kind in ``KINDS`` — the reference's five
HLO kinds, each with its calls and the bytes of its result (the rule of
the reference's HLO parser: a gather's whole output, a reduce's tensor, a
reduce-scatter's input, a point-to-point message) — under real and dry
meshes alike.  ``send`` and ``recv`` count as 'collective-permute'.  Every
reduce-scatter (``psum_scatter``: FSDP's backward, the MoE buffers' and
the sequence's) is one on the wire too (``torch.distributed``'s
``reduce_scatter_single``, or ``reduce_scatter_tensor`` where the torch
build has no other), which sends half the bytes of an all-reduce.

A dry mesh (``launch.mesh.dry_grid_mesh``, backend 'dry') joins no world:
on it each collective takes fake tensors only (``FakeTensorMode``; a real
tensor raises), records its kind and returns a fake tensor of the result's
shape, dtype and device, and never reaches ``_wire`` or
``torch.distributed``.  That is how the dry run traces one rank's program
at a production mesh in one process.
"""

from __future__ import annotations

import math
import time
import weakref

import torch
import torch.distributed as dist

from repro_torch.device import is_fake

# -- collectives (host copies under gloo) --------------------------------------

# this process's collectives so far: host-clock seconds (host copies
# included; a collective waits for its peers), calls, and the bytes this
# rank sends on a ring of n ranks: 2(n-1)/n of an all-reduce's tensor,
# (n-1)/n of a reduce-scatter's input, n-1 times an all-gather's shard, a
# point-to-point message whole
COMM = {"seconds": 0.0, "calls": 0, "bytes": 0}

# the reference's collective kinds (its HLO parser's)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# this process's collectives by kind, real and dry: calls and result bytes
KINDS = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}


def reset_kinds() -> None:
    """Zero ``KINDS``."""
    for v in KINDS.values():
        v["count"] = v["bytes"] = 0


def kinds_snapshot() -> dict:
    """A copy of ``KINDS``."""
    return {k: dict(v) for k, v in KINDS.items()}


def record_kind(kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` whose result holds ``nbytes``."""
    KINDS[kind]["count"] += 1
    KINDS[kind]["bytes"] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dry(mesh, t: torch.Tensor | None = None) -> bool:
    """True when ``mesh`` is a dry mesh (then ``t``, if given, must be a
    fake tensor: a real one raises)."""
    if mesh.backend != "dry":
        return False
    if t is not None and not is_fake(t):
        raise ValueError(f"a dry mesh takes fake tensors only (FakeTensorMode), got a real {t.dtype}"
                         f"{list(t.shape)} on {t.device}")
    return True


def _count(t0: float, nbytes: float) -> None:
    COMM["seconds"] += time.perf_counter() - t0
    COMM["calls"] += 1
    COMM["bytes"] += int(nbytes)


def _wire(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` where ``mesh``'s backend can run a collective on it."""
    if mesh.backend == "dry":
        raise RuntimeError("a dry mesh runs no collective")
    t = t.detach()
    return t.cpu() if mesh.backend == "gloo" and t.is_cuda else t.contiguous()


def all_reduce(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over the ranks of ``axes``."""
    if mesh.axis_size(axes) == 1:
        return t.detach().clone()
    record_kind("all-reduce", _nbytes(t))
    return _reduce(t, mesh, axes, op)


def _reduce(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``all_reduce``'s work, uncounted."""
    if dry(mesh, t):
        return t.detach().new_empty(t.shape)
    t0 = time.perf_counter()
    w = _wire(t, mesh)
    w = w.clone() if w.data_ptr() == t.data_ptr() else w
    dist.all_reduce(w, op=op, group=mesh.group(axes))
    out = w.to(t.device)
    n = mesh.axis_size(axes)
    _count(t0, 2 * (n - 1) * _nbytes(w) / n)
    return out


def _reduce_scatter_op():
    """``torch.distributed``'s reduce-scatter of one tensor: the newer
    name where this torch build has it."""
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def psum_scatter(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``t`` summed over the ranks of ``axes``, this rank's slice of
    ``dim`` kept: one reduce-scatter (over gloo on a host copy), counted as
    a 'reduce-scatter' of ``t``'s bytes (the reference's HLO rule)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t.detach().clone()
    record_kind("reduce-scatter", _nbytes(t))
    shape = list(t.shape)
    shape[dim] //= n
    if dry(mesh, t):
        return t.detach().new_empty(shape)
    t0 = time.perf_counter()
    w = _wire(t, mesh).movedim(dim, 0).contiguous()  # the reduce-scatter splits dim 0, rank by rank
    out = w.new_empty((w.shape[0] // n, *w.shape[1:]))
    _reduce_scatter_op()(out, w, group=mesh.group(axes))
    _count(t0, (n - 1) * _nbytes(w) / n)
    return out.movedim(0, dim).contiguous().to(t.device)


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The shards of ``axes`` concatenated along ``dim`` (shard i from the
    rank at index i over ``axes``)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t.detach()
    record_kind("all-gather", n * _nbytes(t))
    if dry(mesh, t):
        shape = list(t.shape)
        shape[dim] *= n
        return t.detach().new_empty(shape)
    t0 = time.perf_counter()
    w = _wire(t, mesh)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=mesh.group(axes))
    out = torch.cat(parts, dim=dim).to(t.device)
    _count(t0, (n - 1) * _nbytes(w))
    return out


def send(t: torch.Tensor, mesh, dst: int) -> None:
    """``t`` to global rank ``dst`` (point to point, blocking)."""
    record_kind("collective-permute", _nbytes(t))
    if dry(mesh, t):
        return
    t0 = time.perf_counter()
    w = _wire(t, mesh)
    dist.send(w, dst)
    _count(t0, _nbytes(w))


def recv(shape, dtype, device, mesh, src: int) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from global rank ``src``, on
    ``device`` (on a dry mesh: a fake one, made under ``FakeTensorMode``)."""
    if dry(mesh):
        out = torch.empty(shape, dtype=dtype, device=device)
        dry(mesh, out)  # outside FakeTensorMode this is a real tensor: raise
        record_kind("collective-permute", _nbytes(out))
        return out
    t0 = time.perf_counter()
    on_card = mesh.backend == "nccl" and torch.device(device).type == "cuda"
    w = torch.empty(shape, dtype=dtype, device=device if on_card else "cpu")
    dist.recv(w, src)
    record_kind("collective-permute", _nbytes(w))
    out = w.to(device)
    _count(t0, _nbytes(w))
    return out


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _chunk(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


# -- placement: slicing and gathering whole tensors -----------------------------


def shard_of(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under placement ``spec`` (a copy)."""
    return full[shard_index(full.shape, spec, mesh)].contiguous().clone()


def gather_to_root(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor | None:
    """The whole tensor on rank 0 (None on the others), from every rank's
    shard in one gather over the world: a checkpoint's writer needs it
    whole, the other ranks do not.  A leaf placed on no axis (every entry
    None, or ``()``: the int8 moments) is whole on rank 0 already."""
    if mesh.size == 1 or all(e is None for e in spec):
        return local.detach() if mesh.rank == 0 else None
    t0 = time.perf_counter()
    w = _wire(local, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.size)] if mesh.rank == 0 else None
    dist.gather(w, parts, dst=0, group=mesh.group(tuple(mesh.axis_names)))
    record_kind("all-gather", mesh.size * _nbytes(w))
    _count(t0, _nbytes(w))
    if mesh.rank:
        return None
    shape = [n * (mesh.axis_size(e) if e is not None else 1) for n, e in zip(local.shape, spec)]
    out = torch.empty(shape, dtype=w.dtype, device=w.device)
    for r, part in enumerate(parts):  # a replicated shard arrives from each replica: the same values
        idx = tuple(slice(None) if e is None else slice(mesh.axis_index(e, r) * n, (mesh.axis_index(e, r) + 1) * n)
                    for n, e in zip(local.shape, spec))
        out[idx] = part
    return out.to(local.device)


def shard_index(shape, spec: tuple, mesh) -> tuple:
    """The index of this rank's shard in a whole tensor of ``shape``."""
    idx = []
    for n, e in zip(shape, spec):
        if e is None:
            idx.append(slice(None))
        else:
            size = n // mesh.axis_size(e)
            idx.append(slice(mesh.axis_index(e) * size, (mesh.axis_index(e) + 1) * size))
    return tuple(idx)


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tensor tree and its placement tree."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def local_tree(tree, specs, mesh):
    """Every leaf's shard on this rank."""
    return zip_map(lambda t, s: shard_of(t, s, mesh), tree, specs)


def _batch_entry(entry, mesh) -> bool:
    axes = _entry_axes(entry)
    return bool(axes) and all(a in ("pod", "data") and a in mesh.axis_names for a in axes)


# -- FSDP ------------------------------------------------------------------------


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        out = local
        for dim, axes in dims:
            out = all_gather(out, mesh, axes, dim)
        return out

    @staticmethod
    def backward(ctx, grad):
        for dim, axes in reversed(ctx.dims):
            grad = psum_scatter(grad, ctx.mesh, axes, dim)
        return grad, None, None


def _fsdp_dims(spec: tuple, mesh) -> tuple:
    """(dim, axes) of each dim ``spec`` splits over batch axes of ``mesh``."""
    return tuple((d, _entry_axes(e)) for d, e in enumerate(spec) if _batch_entry(e, mesh) and mesh.axis_size(e) > 1)


def fsdp_gather(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """``local`` with the dims it keeps over the batch axes gathered whole
    (its dims over 'model' stay this rank's); the gradient is summed over
    those ranks and sliced back to this rank's shard (a reduce-scatter)."""
    dims = _fsdp_dims(spec, mesh)
    return _FsdpGather.apply(local, mesh, dims) if dims else local


class _FlatGather(torch.autograd.Function):
    """Shards that each keep one dim (``dims``) over ``axes``, gathered in
    one all-gather of the shards laid end to end (FSDP's flat parameter);
    the backward is one reduce-scatter of their gradients laid out the
    same way."""

    @staticmethod
    def forward(ctx, mesh, axes, dims, *locals):
        n = mesh.axis_size(axes)
        ctx.mesh, ctx.axes, ctx.dims = mesh, axes, dims
        ctx.moved = [t.movedim(d, 0).shape for t, d in zip(locals, dims)]
        flat = torch.cat([t.movedim(d, 0).reshape(-1) for t, d in zip(locals, dims)])
        rows = all_gather(flat, mesh, axes, 0).view(n, -1)  # row i: the shards of the rank at index i
        outs, off = [], 0
        for shape, d in zip(ctx.moved, dims):
            size = math.prod(shape)
            outs.append(rows[:, off : off + size].reshape(n * shape[0], *shape[1:]).movedim(0, d))
            off += size
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.mesh.axis_size(ctx.axes)
        rows = torch.cat([g.movedim(d, 0).reshape(n, -1) for g, d in zip(grads, ctx.dims)], dim=1)
        local = psum_scatter(rows, ctx.mesh, ctx.axes, 0)[0]
        outs, off = [], 0
        for shape, d in zip(ctx.moved, ctx.dims):
            size = math.prod(shape)
            outs.append(local[off : off + size].view(shape).movedim(0, d))
            off += size
        return (None, None, None, *outs)


# FSDP's gathered weights (``gather_weights``) alive in this process: their
# bytes now, and the most at any time since ``reset_gathered``
GATHERED = {"alive": 0, "peak": 0}


def reset_gathered() -> None:
    """Start ``GATHERED['peak']`` again from the bytes alive now."""
    GATHERED["peak"] = GATHERED["alive"]


def _untrack(nbytes: int) -> None:
    GATHERED["alive"] -= nbytes


def _track(out: torch.Tensor) -> torch.Tensor:
    nbytes = _nbytes(out)
    GATHERED["alive"] += nbytes
    GATHERED["peak"] = max(GATHERED["peak"], GATHERED["alive"])
    weakref.finalize(out, _untrack, nbytes)
    return out


def gather_weights(locals: list, specs: list, mesh) -> list:
    """``fsdp_gather`` of parameter shards under their placements
    ``specs`` (each keeps at most one dim over the batch axes, as the
    placement rules place them): those over the same axes, of one dtype,
    in one all-gather (``_FlatGather``; the backward one reduce-scatter).
    Each gathered copy's bytes are counted in ``GATHERED`` until it dies
    (a ``weakref.finalize``; a copy autograd saves for the backward lives
    until that backward has run)."""
    out = list(locals)
    groups: dict = {}
    for i, (t, spec) in enumerate(zip(locals, specs)):
        dims = _fsdp_dims(spec, mesh)
        if len(dims) > 1:
            raise ValueError(f"placement {spec} splits {len(dims)} dims over the batch axes; FSDP gathers one")
        if dims:
            groups.setdefault((dims[0][1], t.dtype), []).append((i, dims[0][0]))
    for (axes, _dtype), members in groups.items():
        gathered = _FlatGather.apply(mesh, axes, tuple(d for _, d in members), *(locals[i] for i, _ in members))
        for (i, _), g in zip(members, gathered):
            out[i] = _track(g)
    return out


def gather_tree(tree, specs, mesh):
    """Every leaf of a parameter tree gathered, one leaf at a time
    (``gather_weights``): for a caller that gathers once and serves many
    calls; the model's own paths gather one block at a time
    (``models.transformer``)."""
    return zip_map(lambda t, s: gather_weights([t], [s], mesh)[0], tree, specs)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return psum_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``x`` summed over the ranks of ``axes``, this rank's slice of
    ``dim`` kept (a reduce-scatter); the gradient is all-gathered."""
    return _ReduceScatter.apply(x, mesh, axes, dim) if mesh.axis_size(axes) > 1 else x


def exclusive_prefix(counts: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``counts`` (an integer vector, no gradient) over the ranks
    that come before this one over ``axes``: where this rank's entries
    start in an order that runs rank by rank (one all-gather)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return torch.zeros_like(counts)
    every = all_gather(counts[None], mesh, axes, 0)  # [n, ...], row i from the rank at index i
    return every[: mesh.axis_index(axes)].sum(dim=0)


# -- Megatron's operators on the model axis -------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_over(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """Partial sums all-reduced over ``axes`` into a value every rank there
    then uses: the gradient is all-reduced too (``copy_to`` of
    ``reduce_from``), since each rank's use contributes a part of it."""
    return copy_to(reduce_from(x, mesh, axes), mesh, axes)


def gather_reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Shards over ``axes`` concatenated along ``dim`` for work that is split
    over those ranks: each rank's gradient of the whole is a part, so the
    backward sums them and keeps this rank's slice (a reduce-scatter, as
    FSDP's backward)."""
    axes = _entry_axes(axes)
    return _FsdpGather.apply(x, mesh, ((dim, axes),)) if mesh.axis_size(axes) > 1 else x


def copy_to(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """Identity forward, gradient all-reduced over ``axes``: the entry of a
    tensor-parallel region (and a replicated weight used inside one)."""
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """Partial sums all-reduced over ``axes``, gradient passed through: the
    exit of a tensor-parallel region."""
    return _ReduceFrom.apply(x, mesh, axes)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return _chunk(grad, ctx.dim, m.axis_size(ctx.axes), m.axis_index(ctx.axes)).contiguous(), None, None, None


def gather_from(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Shards over ``axes`` concatenated along ``dim``; the gradient is this
    rank's slice (every rank holds the same upstream gradient)."""
    return _Gather.apply(x, mesh, axes, dim)


# -- the sequence over the model axis (Megatron's sequence parallelism) ---------


def seq_gather(x: torch.Tensor, mesh, axes="model", dim: int = 1) -> torch.Tensor:
    """The entry of a tensor-parallel region under sequence parallelism:
    the ranks' positions concatenated along ``dim`` (an all-gather); each
    rank's gradient of the whole is a part, so the backward sums them and
    keeps this rank's positions (a 'reduce-scatter')."""
    axes = _entry_axes(axes)
    return _FsdpGather.apply(x, mesh, ((dim, axes),)) if mesh.axis_size(axes) > 1 else x


def seq_scatter(x: torch.Tensor, mesh, axes="model", dim: int = 1) -> torch.Tensor:
    """The exit of a tensor-parallel region under sequence parallelism:
    the partial sums summed, this rank's positions along ``dim`` kept (a
    'reduce-scatter'); the gradient is all-gathered."""
    return _ReduceScatter.apply(x, mesh, axes, dim) if mesh.axis_size(axes) > 1 else x


# -- the vocabulary over the model axis -----------------------------------------


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor, mesh, axes="model",
                         seq: bool = False) -> torch.Tensor:
    """Rows ``tokens`` of an embedding whose vocabulary is split over
    ``axes`` (``table`` this rank's [V/M, D] rows): each rank looks up the
    tokens it owns, zeros elsewhere, and the partial rows are summed — with
    ``seq`` (sequence parallelism) in a reduce-scatter that keeps this
    rank's positions of ``tokens`` [B, S]."""
    v = table.shape[0]
    local = tokens - mesh.axis_index(axes) * v
    mine = (local >= 0) & (local < v)
    rows = table[local.clamp(0, v - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return seq_scatter(rows, mesh, axes, 1) if seq else reduce_from(rows, mesh, axes)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, z_loss, mesh, axes):
        v = logits.shape[-1]
        local = labels - mesh.axis_index(axes) * v
        mine = (local >= 0) & (local < v)
        m = all_reduce(logits.amax(dim=-1), mesh, axes, dist.ReduceOp.MAX)
        s = all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, axes)
        lse = m + torch.log(s)
        gold = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
        gold = all_reduce(torch.where(mine, gold, torch.zeros_like(gold)), mesh, axes)
        ctx.save_for_backward(logits, lse, local.clamp(0, v - 1), mine)
        ctx.z_loss = z_loss
        return (lse - gold) + z_loss * lse**2

    @staticmethod
    def backward(ctx, grad):
        logits, lse, idx, mine = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None]) * (grad * (1 + 2 * ctx.z_loss * lse))[..., None]
        d.scatter_add_(-1, idx[..., None], torch.where(mine, -grad, torch.zeros_like(grad))[..., None])
        return d, None, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, z_loss: float, mesh,
                      axes="model") -> torch.Tensor:
    """Per-position CE + z-loss, float32, of logits whose vocabulary is split
    over ``axes`` (``logits`` this rank's [..., V/M] columns; ``labels``
    global ids, any value at positions the caller masks)."""
    return _VocabParallelCE.apply(logits, labels.clamp(min=0), z_loss, mesh, axes)


# -- gradients -------------------------------------------------------------------


def sync_grads(params, specs, mesh, seq_keys=()) -> None:
    """Sum, in place, each leaf's ``.grad`` over the batch axes its
    placement does not shard it on (the axes its FSDP gather does shard it
    on were summed by that gather's backward).  A leaf without a gradient
    gets zeros first, as under ``jax.grad``.

    ``seq_keys``: under sequence parallelism, the top-level keys of
    ``params`` whose leaves act on the sequence shards.  Such a leaf that
    the model axis does not split holds on each model rank the part of its
    gradient from that rank's positions (a norm applied to them, a
    sublayer's output kept for them) or heads, so it is summed over
    'model' too, in the same all-reduce (Megatron's sequence-parallel
    gradient all-reduce)."""
    batch = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def go(p, spec, seq):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        used = {a for e in spec for a in _entry_axes(e)}
        over = batch + (("model",) if seq and "model" in mesh.axis_names else ())
        rest = tuple(a for a in over if a not in used)
        if mesh.axis_size(rest) > 1:
            p.grad.copy_(all_reduce(p.grad, mesh, rest))

    for k in params:
        zip_map(lambda p, spec, seq=k in seq_keys: go(p, spec, seq), params[k], specs[k])


def global_norm(grads, specs, mesh) -> torch.Tensor:
    """The global L2 norm of a sharded gradient tree: each leaf's sum of
    squares counted on one replica of each shard (the rank at index 0 on
    every axis the leaf is not split over), summed over the world."""
    pairs = _pairs(grads, specs)
    total = torch.zeros((), device=pairs[0][0].device)
    for g, spec in pairs:
        used = {a for e in spec for a in _entry_axes(e)}
        if not any(mesh.coords[a] for a in mesh.axis_names if a not in used):
            total = total + torch.linalg.vector_norm(g, dtype=torch.float32).square()
    return torch.sqrt(all_reduce(total, mesh, tuple(mesh.axis_names)))


def _pairs(tree, specs) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _pairs(tree[k], specs[k])]
    return [(tree, specs)]
