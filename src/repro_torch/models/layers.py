"""Core layers: norms, RoPE, attention (self and cross), MLP.

Port of ``repro.models.layers``.  Conventions are the reference's:
  * activations bf16, softmax/norm statistics f32;
  * attention is computed with KV heads repeated to full heads; the KV
    *cache* stores only ``n_kv_heads``;
  * decode uses a position-indexed cache update; sliding-window layers use a
    ring buffer of ``window`` slots.

Full-sequence attention (training / prefill) goes through kernel B.6's
wrapper ``kernels.flash_kernel.flash_attention`` at every length: causal
self-attention, the non-causal encoder self-attention and cross-attention
to an encoder's memory, whose S and T need no alignment (the kernel masks
keys past T; ``ops.flash_attention`` keeps the reference wrapper's
128-alignment refusal for non-causal calls, which the reference's model
never meets: it runs XLA attention there).  On CUDA tensors that is the
hand-written kernel, on CPU tensors its plain version.  Single-token
decode attention stays plain PyTorch, as the reference computes it outside
any Pallas kernel, but with the kernel's numerics: scores and P·V in
float32.  The reference's decode rounds scores and probabilities to bf16;
beside the kernel's float32 prefill that alone parts decode from the full
forward by 0.058 of max|logit| at one layer of full-width qwen1.5-0.5b on
an H100, past the 0.05 the reference's consistency test allows.  The
decode cache is updated in place (the reference returns a new cache),
which saves a copy of the whole cache per step.

Over a mesh (``enable_activation_sharding``, set by the training driver on
each rank of a ``launch.mesh.GridMesh``) the layers run tensor parallel on
the model axis, following each leaf's placement, read from its local shape
against ``cfg``: attention is column-parallel (this rank's H/M query heads
and Kv/M KV heads; B.6 on the local heads) and its output projection
row-parallel, ending in the model all-reduce; the MLP is column-parallel
``wi_gate`` / ``wi_up`` / ``wi`` and row-parallel ``wo``.  A leaf that
``validate_divisibility`` replicated over 'model' is computed whole on
every model rank: K/V whose heads do not divide (each rank projects every
KV head and keeps those its query heads read), or a whole sublayer, which
then needs no all-reduce.  The region's edges are ``train.sharding``'s
``copy_to`` / ``reduce_from``; a replicated weight used inside a region
passes through ``copy_to`` too, so its gradient is summed over the model
ranks.  ``constrain_batch`` / ``constrain_seq`` check a local activation
against the placement the reference's constraint would give it.

Sequence parallelism (``SEQ_SHARD``, the reference's flag; Megatron's
scheme): where the model axis M > 1 divides S, the residual stream
between the sublayers of a full-sequence forward is each model rank's
S/M positions (``seq_parallel``; the blocks set ``seq_context``).  Each
sublayer's input then enters through ``region_in`` — every position
gathered (``sharding.seq_gather``: all-gather forward, reduce-scatter
backward) in place of ``copy_to`` — and leaves through ``region_out``: a
split sublayer's partial sums reduce-scattered to this rank's positions
(``sharding.seq_scatter``) in place of ``reduce_from``, a whole one's
output cut to them.  The norms run on the rank's positions, and so does a
whole MLP (it is per position).  A weight the model axis does not split
then holds a part of its gradient on each model rank (from its positions
or its heads), summed over 'model' by ``sharding.sync_grads``; inside a
split region such a weight is therefore used as it is
(``region_weight``), not through ``copy_to``.  Cross-attention's memory
(the encoder's output) stays whole on every rank and enters through
``copy_to``.  Decode never shards the sequence.

Serving over a mesh (``transformer.prefill`` / ``decode_step``): the rows
of the global batch are split over the batch axes where they divide it,
else every batch rank holds every row (``rows_split``, the reference's
fallback to replication; the layers then run under
``rows_context(False)``, and ``batch_ranks`` is 1).  The cache
is placed by ``launch.mesh.cache_pspec_for`` — its KV heads over 'model'
where they divide it, else its slots over the slot axes (the model axis,
or every axis for a batch of one).  Prefill runs ``attention_fwd`` (B.6
on this rank's heads) and projects the cache's K/V again, as the
reference's prefill does: this rank's KV heads, or every KV head when
``wk`` / ``wv`` are whole.  ``attention_decode`` with ``slot_axes`` reads
a cache whose slots are split: the rank that owns the new token's slot
writes it, every rank
scores the query heads it needs (all of them, gathered over 'model' when
the heads are split) against its own slots in float32, and the partial
softmaxes are merged over the slot axes — a max all-reduce, then one sum
all-reduce of the (sum of exp, P·V) pairs (flash-decoding,
``merge_softmax``) — before the result is cut to this rank's heads for
the row-parallel ``wo``.  ``cross_attention_decode`` reads the memory's
cache the same way (its KV heads, or its positions split), and MLA's
decode merges over its latent slots (``models.mla``).  A sublayer whose
query heads do not divide the model axis runs whole on every model rank
and sums nothing over it.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import flash_kernel
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.train import sharding

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# activation sharding: the model-axis context of the layers
#
# Disabled (None) unless a mesh is installed; then the batch axes
# ('pod'/'data') and the model axis of the rank's GridMesh.
# ---------------------------------------------------------------------------

_ACT_MESH = None
_ACT_BATCH_AXES: tuple | None = None
_ACT_MODEL_AXIS: str | None = None
_ACT_BATCH_SIZE: int = 1
_ACT_MODEL_SIZE: int = 1
_ACT_VOCAB: int | None = None


def enable_activation_sharding(mesh, model_axis: str = "model", vocab_size: int | None = None):
    """Run the layers on this rank of ``mesh`` (a ``GridMesh``): batch over
    'pod'/'data', heads / mlp / vocabulary over ``model_axis``.
    ``vocab_size`` (the model's) tells the embedding and the loss head
    whether the vocabulary is split (it is when the model axis divides it,
    ``validate_divisibility``'s rule)."""
    global _ACT_MESH, _ACT_BATCH_AXES, _ACT_MODEL_AXIS, _ACT_BATCH_SIZE, _ACT_MODEL_SIZE, _ACT_VOCAB
    _ACT_MESH = mesh
    _ACT_BATCH_AXES = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    _ACT_MODEL_AXIS = model_axis if model_axis in mesh.axis_names else None
    _ACT_BATCH_SIZE = math.prod(mesh.shape[a] for a in _ACT_BATCH_AXES)
    _ACT_MODEL_SIZE = mesh.shape[model_axis] if _ACT_MODEL_AXIS else 1
    _ACT_VOCAB = vocab_size


def disable_activation_sharding():
    global _ACT_MESH, _ACT_BATCH_AXES, _ACT_MODEL_AXIS, _ACT_BATCH_SIZE, _ACT_MODEL_SIZE, _ACT_VOCAB
    _ACT_MESH = _ACT_BATCH_AXES = _ACT_MODEL_AXIS = _ACT_VOCAB = None
    _ACT_BATCH_SIZE = _ACT_MODEL_SIZE = 1


SEQ_SHARD = False  # Megatron-style sequence parallelism for the residual
# stream (the reference's flag): [B, S, D] between the sublayers holds this
# rank's S/M positions where the model axis divides S (``seq_parallel``).

_SEQ = False  # True while a sublayer runs on a sequence shard (``seq_context``)


def model_parallel():
    """The mesh when the layers run tensor parallel (model axis > 1), else
    None."""
    return _ACT_MESH if _ACT_MODEL_SIZE > 1 else None


def vocab_parallel():
    """The mesh when the vocabulary is split over the model axis, else None."""
    if _ACT_MODEL_SIZE > 1 and _ACT_VOCAB is not None and _ACT_VOCAB % _ACT_MODEL_SIZE == 0:
        return _ACT_MESH
    return None


def seq_parallel(seq_len: int) -> bool:
    """True when ``SEQ_SHARD`` splits a residual stream of ``seq_len``
    positions over the model axis here: a model axis > 1 that divides it
    (the reference's ``constrain_seq`` rule; else the stream stays whole,
    as its fallback to ``constrain_batch``)."""
    return SEQ_SHARD and _ACT_MODEL_SIZE > 1 and seq_len % _ACT_MODEL_SIZE == 0


@contextlib.contextmanager
def seq_context(on: bool):
    """Run the sublayers inside on this rank's sequence shard (``on``):
    each region's entry gathers the positions (``sharding.seq_gather``) and
    its exit scatters them (``seq_scatter``), or keeps this rank's where
    the sublayer runs whole (``own_positions``).  Set per block, so that a
    block's recompute under remat runs as its forward did."""
    global _SEQ
    saved, _SEQ = _SEQ, on
    try:
        yield
    finally:
        _SEQ = saved


def own_positions(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's S/M positions of ``t`` along ``dim`` (its index over
    the model axis)."""
    n = t.shape[dim] // _ACT_MODEL_SIZE
    return t.narrow(dim, _ACT_MESH.axis_index(_ACT_MODEL_AXIS) * n, n)


def region_in(x: torch.Tensor, split: bool) -> torch.Tensor:
    """The input of a sublayer over the model axis: under sequence
    parallelism every position, gathered; else, where the sublayer is
    ``split`` over the ranks, the region's entry (``copy_to``)."""
    if _SEQ:
        return sharding.seq_gather(x, _ACT_MESH, _ACT_MODEL_AXIS, 1)
    return sharding.copy_to(x, _ACT_MESH) if split else x


def region_out(y: torch.Tensor, split: bool) -> torch.Tensor:
    """The output of a sublayer over the model axis: a ``split`` one's
    partial sums summed (``reduce_from``; under sequence parallelism
    ``seq_scatter``, keeping this rank's positions); a whole one's as it
    is (under sequence parallelism: this rank's positions)."""
    if _SEQ:
        return sharding.seq_scatter(y, _ACT_MESH, _ACT_MODEL_AXIS, 1) if split else own_positions(y)
    return sharding.reduce_from(y, _ACT_MESH) if split else y


def region_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight the model axis does not split, used inside a split
    region: its gradient is each rank's part, summed over 'model' here
    (``copy_to``), or under sequence parallelism with the sequence-sharded
    leaves' in ``sharding.sync_grads``."""
    return w if _SEQ else sharding.copy_to(w, _ACT_MESH)


_ROWS_SPLIT = True  # False while a serving call holds every row of its batch on each batch rank


def rows_split(batch: int) -> bool:
    """The reference's rule for a global batch of ``batch`` rows over the
    batch axes (``constrain_batch``'s fallback): split where they divide
    it, else whole on every batch rank."""
    return batch % _ACT_BATCH_SIZE == 0


def local_rows(batch: int) -> tuple[int, int]:
    """This rank's rows [lo, hi) of a global batch of ``batch`` rows, by
    ``rows_split``: its share where the batch axes divide ``batch``, else
    every row (every row too without a mesh)."""
    if _ACT_MESH is None or not rows_split(batch):
        return 0, batch
    i = _ACT_MESH.axis_index(_ACT_BATCH_AXES)
    return i * batch // _ACT_BATCH_SIZE, (i + 1) * batch // _ACT_BATCH_SIZE


@contextlib.contextmanager
def rows_context(split: bool):
    """Run the layers inside on rows split over the batch axes (``split``)
    or on every row of the batch, replicated over them: then no
    collective over the batch axes combines rows (``batch_ranks`` is 1),
    and FSDP's weight gathers stay as they are."""
    global _ROWS_SPLIT
    saved, _ROWS_SPLIT = _ROWS_SPLIT, split
    try:
        yield
    finally:
        _ROWS_SPLIT = saved


def batch_ranks() -> int:
    """The ranks the rows are split over: the batch axes' size, or 1 where
    every rank holds every row (``rows_context``) or there is no mesh."""
    return _ACT_BATCH_SIZE if _ROWS_SPLIT else 1


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the batch axes (no gradient): a count or metric
    over the global batch.  Itself without a mesh, or where the rows are
    whole on every rank."""
    if batch_ranks() == 1:
        return t
    return sharding.all_reduce(t, _ACT_MESH, _ACT_BATCH_AXES)


def constrain_seq(x: torch.Tensor, global_shape: tuple | None = None):
    """[B, S, D]: under ``SEQ_SHARD``, where the model axis divides S,
    check that ``x`` is this rank's [B/D, S/M, D] shard of
    ``global_shape`` (B whole where D does not divide it); else this is
    ``constrain_batch(x, 0, global_shape=...)``."""
    if _ACT_MESH is None or global_shape is None or len(global_shape) != 3 or not seq_parallel(global_shape[1]):
        return constrain_batch(x, 0, global_shape=global_shape)
    b, s, d = global_shape
    want = (b // _ACT_BATCH_SIZE if b % _ACT_BATCH_SIZE == 0 else b, s // _ACT_MODEL_SIZE, d)
    if tuple(x.shape) != want:
        raise ValueError(f"activation {tuple(x.shape)} is not this rank's sequence shard {want} of"
                         f" {tuple(global_shape)}")
    return x


def constrain_batch(x: torch.Tensor, batch_dim: int = 0, heads_dim: int | None = None,
                    global_shape: tuple | None = None):
    """Check that the local activation ``x`` is this rank's shard of a
    tensor of ``global_shape`` under the reference's constraint: batch dim
    over ('pod', 'data') and ``heads_dim`` over 'model' where they divide,
    other dims whole.  Returns ``x``; a no-op without a mesh or a
    ``global_shape``."""
    if _ACT_MESH is None or global_shape is None or x.ndim == 0:
        return x
    want = list(global_shape)
    if want[batch_dim] % _ACT_BATCH_SIZE == 0:
        want[batch_dim] //= _ACT_BATCH_SIZE
    if heads_dim is not None and _ACT_MODEL_AXIS is not None and want[heads_dim] % _ACT_MODEL_SIZE == 0:
        want[heads_dim] //= _ACT_MODEL_SIZE
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"activation {tuple(x.shape)} is not this rank's shard {tuple(want)} of"
                         f" {tuple(global_shape)} (batch dim {batch_dim}, heads dim {heads_dim})")
    return x


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig, d: int | None = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm_type == "rms":
        return {"scale": ParamSpec((d,), ("embed",), init="ones")}
    return {
        "scale": ParamSpec((d,), ("embed",), init="ones"),
        "bias": ParamSpec((d,), ("embed",), init="zeros"),
    }


def norm_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """RMS/LayerNorm with f32 statistics; the normalised tensor is produced
    in x.dtype, as in the reference."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    if cfg.norm_type == "rms":
        inv = torch.rsqrt(var + cfg.norm_eps)
        return (x * inv.to(x.dtype)) * p["scale"].to(x.dtype)
    mu = x.float().mean(dim=-1, keepdim=True)
    var = var - mu.square()
    inv = torch.rsqrt(var + cfg.norm_eps)
    out = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return out * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def rms_norm_simple(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D] (D even), positions: [..., S] int."""
    d = x.shape[-1]
    # built on x's device: a host array copied in would synchronise the
    # stream twice per layer
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., :, None].float() * freqs  # [..., S, D/2]
    sin, cos = torch.sin(angles)[..., None, :], torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    """Q/K/V/O projections.  ``cross`` is the reference's flag: a
    cross-attention layer has the same shapes (its K/V project the encoder's
    memory), so the flag changes no spec, there or here."""
    d, h, hd, kv = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    p = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.attn_bias:
        p["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        p["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, D] × [D, H, K] -> [B, S, H, K] in x.dtype."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _project_q(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    q = _proj(x, p["wq"])
    if cfg.attn_bias:
        q = q + p["bq"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm_simple(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(p: dict, cfg: ModelConfig, kv_x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    k, v = _proj(kv_x, p["wk"]), _proj(kv_x, p["wv"])
    if cfg.attn_bias:
        k = k + p["bk"].to(kv_x.dtype)
        v = v + p["bv"].to(kv_x.dtype)
    if cfg.qk_norm:
        k = rms_norm_simple(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor | None = None):
    """Q from ``x``; K and V from ``kv_x`` (cross-attention memory) or ``x``."""
    k, v = _project_kv(p, cfg, x if kv_x is None else kv_x)
    return _project_q(p, cfg, x), k, v


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, Kv, D] -> [B, T, H, D]."""
    kv = k.shape[-2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=-2)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """[B, S, H, K] × [H, K, D] -> [B, S, D] in out.dtype."""
    return out.flatten(-2) @ wo.to(out.dtype).reshape(-1, wo.shape[-1])


def attention_fwd(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    kv_x: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full-sequence attention (prefill / scoring).

    x: [B, S, D]; positions: [S] int; kv_x: cross-attention memory [B, T,
    D] (no RoPE on either side, as in the reference).  The flash kernel
    masks by query and key INDEX (the reference's ``_mask_bias`` rule, kept
    in ``kernels.flash_kernel``), which equals the position here: every
    caller passes ``positions = arange(S)`` and memory positions
    ``arange(T)``, as the reference's do.  ``kv_positions`` (the
    reference's signature) matters only to a causal or windowed mask, which
    this port builds by index, so such a call with ``kv_positions`` raises;
    a non-causal call without a window reads no positions, there or here.
    """
    if kv_positions is not None and (causal or window > 0):
        raise ValueError("attention_fwd masks by key index: kv_positions is supported only "
                         "for non-causal calls without a window")
    mesh = model_parallel()
    tp = mesh is not None and p["wq"].shape[-2] < cfg.n_heads  # heads split over 'model'
    kv_whole = p["wk"].shape[-2] == cfg.n_kv_heads
    x = region_in(x, tp)  # column-parallel Q/K/V: the region's entry
    if kv_x is not None and (tp or _SEQ):  # the memory, whole on every rank: its gradient a part on each
        kv_x = sharding.copy_to(kv_x, mesh)
    if tp:  # the replicated weights of the region
        whole = ("q_norm", "k_norm") + (("wk", "wv", "bk", "bv") if kv_whole else ())
        p = {n: region_weight(w) if n in whole else w for n, w in p.items()}
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    if kv_x is None:  # self-attention → RoPE
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    hl = q.shape[-2]
    if tp and kv_whole:  # every KV head here: keep those this rank's query heads read
        lo = mesh.axis_index(_ACT_MODEL_AXIS) * hl
        k = repeat_kv(k, cfg.n_heads)[..., lo : lo + hl, :]
        v = repeat_kv(v, cfg.n_heads)[..., lo : lo + hl, :]
    else:
        k = repeat_kv(k, hl)
        v = repeat_kv(v, hl)
    out = flash_kernel.flash_attention(q, k, v, causal=causal, window=window)
    constrain_batch(out, 0, 2, global_shape=(out.shape[0] * batch_ranks(), out.shape[1], cfg.n_heads,
                                             out.shape[3]))
    return region_out(_out_proj(out, p["wo"]), tp)  # row-parallel wo


def _cache_write(buf: torch.Tensor, slot: torch.Tensor, val: torch.Tensor) -> None:
    """buf: [B, slots, ...]; slot: [B]; val: [B, ...] — row written in place."""
    buf[torch.arange(buf.shape[0], device=buf.device), slot] = val


def _owned_write(buf: torch.Tensor, slot: torch.Tensor, val: torch.Tensor, axes: tuple) -> None:
    """Write ``val`` [B, ...] at global slot ``slot`` [B] of ``buf`` [B,
    local slots, ...], this rank's shard of slots split over ``axes``: the
    rows whose slot this rank holds change, the others keep their value.
    With no ``axes`` every slot is here: a plain ``_cache_write``."""
    if not axes:
        _cache_write(buf, slot, val)
        return
    local = buf.shape[1]
    rel = slot - _ACT_MESH.axis_index(axes) * local
    mine = (rel >= 0) & (rel < local)
    at = rel.clamp(0, local - 1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    keep = buf[rows, at]
    buf[rows, at] = torch.where(mine.view((-1,) + (1,) * (keep.dim() - 1)), val.to(buf.dtype), keep)


def attention_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache: dict,
    *,
    window: int = 0,
    slot_axes: tuple = (),
    pos_axes: tuple | None = None,
) -> tuple[torch.Tensor, dict]:
    """Single-token decode with KV cache (updated in place and returned).

    x: [B, 1, D].  cache: {'k','v': [B, S_slots, Kv, D], 'pos': [B] (next
    position), 'slot_pos': [B, S_slots]}.  Full-attention layers use
    S_slots = max_seq; SWA layers use a ring buffer with S_slots = window.
    Scores and P·V in float32, the mask the reference's.

    Over the activation mesh (module docstring) the layer runs this rank's
    query heads (all when ``wq`` is whole) against its shard of the cache:
    its KV heads, or (with ``slot_axes``, the mesh axes the slots of 'k' /
    'v' are split over) its slot range of every KV head, the partial
    softmaxes then merged over ``slot_axes``.  ``pos_axes`` are those of
    'slot_pos' (default: ``slot_axes``), which the reference's placement
    may split where it keeps 'k' / 'v' whole.  With no mesh both are empty
    and the whole cache is here.
    """
    mesh = _ACT_MESH
    pos_axes = slot_axes if pos_axes is None else pos_axes
    tp = model_parallel() is not None and p["wq"].shape[-2] < cfg.n_heads
    pos = cache["pos"]  # [B]
    q, k, v = _project_qkv(p, cfg, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    ck, cv, cpos = cache["k"], cache["v"], cache["slot_pos"]
    if k.shape[-2] != ck.shape[2]:
        raise ValueError(f"the cache holds {ck.shape[2]} KV heads, this rank projects {k.shape[-2]}")
    n_slot = mesh.axis_size(slot_axes) if slot_axes else 1
    local = ck.shape[1]
    slots = local * n_slot  # the layer's global slot count
    slot = pos % slots if window > 0 else pos.clamp(max=slots - 1)
    _owned_write(ck, slot, k[:, 0], slot_axes)
    _owned_write(cv, slot, v[:, 0], slot_axes)
    _owned_write(cpos, slot, pos, pos_axes)
    if pos_axes != slot_axes:  # the positions of this rank's K/V slots
        off = mesh.axis_index(slot_axes) * local if slot_axes else 0
        cpos = sharding.all_gather(cpos, mesh, pos_axes, 1) if pos_axes else cpos
        cpos = cpos[:, off : off + local]

    diff = pos[:, None] - cpos  # [B, slots]
    ok = (diff >= 0) & (cpos >= 0)  # cpos < 0 marks never-written slots
    if window > 0:
        ok &= diff < window
    out = _attend_cached(cfg, q, ck, cv, ok, slot_axes, tp)
    pos.add_(1)  # in place: the cache tensors may be views of a layer stack
    y = _out_proj(out.to(x.dtype), p["wo"])
    return (sharding.reduce_from(y, mesh) if tp else y), cache


def _attend_cached(cfg: ModelConfig, q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, ok: torch.Tensor,
                   slot_axes: tuple, tp: bool) -> torch.Tensor:
    """One query token against a cache shard, float32: q [B, 1, H', D]
    (this rank's query heads, all of them when ``wq`` is whole), ck / cv
    [B, T', Kv', D] (this rank's KV heads, or every KV head over its slots
    of ``slot_axes``), ok [B, T'] the slots to attend.  Returns the output
    of this rank's query heads [B, 1, H', D].

    With the KV heads split, each rank's query heads read its own; with
    every KV head but split slots, every query head is scored here (all
    gathered over 'model' when split), the partial softmaxes are merged over
    ``slot_axes`` (flash-decoding: a max all-reduce, then one sum all-reduce
    of the (P·V, sum of exp) pairs) and cut to this rank's heads."""
    mesh = _ACT_MESH
    hl = q.shape[-2]
    lo = mesh.axis_index(_ACT_MODEL_AXIS) * hl if tp else 0
    n_slot = mesh.axis_size(slot_axes) if slot_axes else 1
    if ck.shape[2] < cfg.n_kv_heads:  # KV heads split: this rank's query heads read its own
        qs, kk, vv = q, repeat_kv(ck, hl), repeat_kv(cv, hl)
    elif n_slot > 1:  # every KV head, some slots: score every query head here
        qs = sharding.all_gather(q, mesh, _ACT_MODEL_AXIS, 2) if tp else q
        kk, vv = repeat_kv(ck, cfg.n_heads), repeat_kv(cv, cfg.n_heads)
    else:  # the whole cache here: the query heads of this rank
        qs, kk, vv = q, repeat_kv(ck, cfg.n_heads), repeat_kv(cv, cfg.n_heads)
        if tp:
            kk, vv = kk[:, :, lo : lo + hl], vv[:, :, lo : lo + hl]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", qs.float(), kk.float()) * scale
    out = merge_softmax(scores, ok, slot_axes, lambda w: torch.einsum("bhst,bthd->bshd", w, vv.float()))
    return out[:, :, lo : lo + hl] if qs.shape[-2] > hl else out


def merge_softmax(scores: torch.Tensor, ok: torch.Tensor, slot_axes: tuple, pv) -> torch.Tensor:
    """softmax(scores) · V over every slot of ``slot_axes``, float32:
    scores [B, H, 1, T'] over this rank's slots, ok [B, T'] the slots to
    attend, ``pv(w)`` the product of weights w [B, H, 1, T'] with this
    rank's values ([B, 1, H, D]).  With ``slot_axes`` the partial
    softmaxes of the ranks are merged (flash-decoding): a max all-reduce,
    then one sum all-reduce of the (P·V, sum of exp) pairs."""
    scores = scores + torch.where(ok, 0.0, NEG_INF)[:, None, None, :]
    if not slot_axes or _ACT_MESH.axis_size(slot_axes) == 1:
        return pv(torch.softmax(scores, dim=-1))
    mesh = _ACT_MESH
    m = sharding.all_reduce(scores.amax(dim=-1, keepdim=True), mesh, slot_axes, op=dist.ReduceOp.MAX)
    e = torch.exp(scores - m)
    num = pv(e)  # [B, 1, H, D]
    den = e.sum(dim=-1).permute(0, 2, 1)  # [B, 1, H]
    both = sharding.all_reduce(torch.cat([num.flatten(), den.flatten()]), mesh, slot_axes)
    num, den = both[: num.numel()].view(num.shape), both[num.numel() :].view(den.shape)
    return num / den[..., None]


def cross_attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                           slot_axes: tuple = ()) -> torch.Tensor:
    """One token against the memory K/V cached at prefill ({'k', 'v': [B,
    T, Kv, D]}), no mask.  Scores and P·V in float32 like
    ``attention_decode``; the reference rounds both to bf16 here.

    Over the activation mesh the query heads are this rank's (all when
    ``wq`` is whole) and the cache is its shard: its KV heads, or every KV
    head over its slice of the memory (``slot_axes``, the axes its T dim is
    split over), merged over those ranks (``_attend_cached``).  The
    row-parallel ``wo`` sums over 'model' only when the heads are split: a
    replicated sublayer needs no all-reduce."""
    mesh = model_parallel()
    tp = mesh is not None and p["wq"].shape[-2] < cfg.n_heads
    q = _project_q(p, cfg, x)
    ok = torch.ones(cache["k"].shape[:2], dtype=torch.bool, device=x.device)
    out = _attend_cached(cfg, q, cache["k"], cache["v"], ok, slot_axes, tp)
    y = _out_proj(out.to(x.dtype), p["wo"])
    return sharding.reduce_from(y, mesh) if tp else y


def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, window: int = 0,
                    dtype=torch.bfloat16, device=None) -> dict:
    slots = min(window, max_seq) if window > 0 else max_seq
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros(batch, slots, kv, hd, dtype=dtype, device=device),
        "v": torch.zeros(batch, slots, kv, hd, dtype=dtype, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
        "slot_pos": torch.full((batch, slots), -(10**9), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.glu:
        return {
            "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
            "wi_up": ParamSpec((d, f), ("embed", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def mlp_split(p: dict, d_ff: int) -> bool:
    """True when this rank holds a slice of the MLP's hidden width ``d_ff``
    (its ``wo`` rows fewer) under a model axis > 1."""
    return model_parallel() is not None and p["wo"].shape[0] < d_ff


def mlp_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, *, d_ff: int | None = None,
            reduce: bool = True) -> torch.Tensor:
    """Under a model axis whose ranks split the hidden width (``wo``'s
    rows fewer than ``d_ff``, default ``cfg.d_ff``): column-parallel in,
    row-parallel out (``region_in`` / ``region_out``).  ``reduce=False``
    hands back the row-parallel partial sum of a split MLP, its input taken
    as the region's already (the MoE layer sums it with its experts' in one
    all-reduce).  A whole MLP runs on the positions it is given: this
    rank's under sequence parallelism."""
    tp = mlp_split(p, d_ff or cfg.d_ff)
    if tp and reduce:
        x = region_in(x, True)
    if cfg.glu:
        h = _act(cfg, x @ p["wi_gate"].to(x.dtype)) * (x @ p["wi_up"].to(x.dtype))
    else:
        h = _act(cfg, x @ p["wi"].to(x.dtype))
    y = h @ p["wo"].to(x.dtype)
    return region_out(y, True) if tp and reduce else y
