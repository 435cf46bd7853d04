"""Training step: chunked cross-entropy, the MTP loss, remat (port of
``repro.train.step``).

The loss head is CHUNKED over the sequence: hidden states are projected to
vocab logits one chunk at a time, each chunk under
``torch.utils.checkpoint``, so a ``[B, chunk, V]`` logits tensor never
outlives its chunk, in the forward or the backward (at a 151,936-token
vocab the float32 ``[B, S, V]`` logits are the largest activation of LM
training).

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: zero-grad, the loss, its backward through
the model (remat blocks, B.6's autograd path) and ``adamw_update``, which
writes the new parameters and moments into the tensors it was given, as
``decode_step`` updates its caches.  ``make_grad_step`` is its first half:
the gradients and their global norm, no update.  After a step each parameter leaf
keeps its gradient in ``.grad`` until the next step clears it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt, sharding


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    remat: bool = True
    ce_chunk: int = 1024  # seq chunk for the loss head (0 → unchunked)
    mtp_weight: float = 0.3
    z_loss: float = 1e-4


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """(sum of CE + z-loss over valid (label >= 0) positions, their count),
    float32."""
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    ce = (lse - gold) + z_loss * lse**2
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    return ce.sum(), valid.sum().float()


def _chunk_ce(h, head, labels, z_loss: float):
    logits = (h @ head).float()
    mesh = layers.vocab_parallel()
    if mesh is None:
        return _ce_from_logits(logits, labels, z_loss)
    layers.constrain_batch(logits, 0, 2, global_shape=(
        logits.shape[0] * layers._ACT_BATCH_SIZE, logits.shape[1], logits.shape[2] * layers._ACT_MODEL_SIZE))
    valid = labels >= 0
    ce = sharding.vocab_parallel_ce(logits, labels, z_loss, mesh)
    return torch.where(valid, ce, torch.zeros_like(ce)).sum(), valid.sum().float()


def chunked_ce(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               chunk: int, z_loss: float, seq: bool = False) -> torch.Tensor:
    """Mean CE of hidden [B, S, D] @ head [D, V] against labels [B, S],
    without a whole [B, S, V] logits tensor.

    Over a mesh: the mean is over the GLOBAL batch's valid positions (the
    count summed over the batch axes), so that the ranks' losses sum to the
    1×1 loss; with the vocabulary split over the model axis, ``head`` is
    this rank's [D, V/M] columns and each chunk's CE is vocab-parallel.
    ``seq``: ``hidden`` is this rank's [B, S/M, D] positions (sequence
    parallelism); a split vocabulary gathers them first, a whole one takes
    the CE of this rank's positions and sums it over the model axis (the
    gradient passed through), so every model rank holds the same loss."""
    mesh = layers.vocab_parallel()
    whole = None  # the model axis a whole vocabulary's per-position sums are summed over
    if seq and mesh is not None:
        hidden = sharding.seq_gather(hidden, mesh)
    elif seq:
        whole, labels = layers.model_parallel(), layers.own_positions(labels)
    elif mesh is not None:
        hidden = sharding.copy_to(hidden, mesh)
    tot, cnt = _ce_sums(hidden, head, labels, chunk, z_loss)
    if whole is not None:
        tot, cnt = sharding.reduce_from(tot, whole), sharding.all_reduce(cnt, whole, "model")
    return tot / torch.clamp(layers.batch_sum(cnt), min=1)


def _ce_sums(hidden, head, labels, chunk: int, z_loss: float):
    """(the CE + z-loss summed over the valid positions, their count) of
    ``hidden`` [B, S, D], chunk by chunk over S."""
    b, s, d = hidden.shape
    if chunk <= 0 or s <= chunk:
        return _chunk_ce(hidden, head, labels, z_loss)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    remat = torch.is_grad_enabled()
    tot = cnt = torch.zeros((), device=hidden.device)
    for c0 in range(0, s + pad, chunk):
        args = (hidden[:, c0 : c0 + chunk], head, labels[:, c0 : c0 + chunk], z_loss)
        t, n = checkpoint(_chunk_ce, *args, use_reentrant=False) if remat else _chunk_ce(*args)
        tot, cnt = tot + t, cnt + n
    return tot, cnt


def loss_fn(params, cfg: ModelConfig, tcfg: TrainConfig, batch: dict):
    """batch: tokens int[B, S], labels int[B, S] (-1: no target), and
    frames / patches for whisper / the VLM.  Returns (loss, metrics).
    Over a mesh ``params`` are this rank's shards: the top-level leaves
    are gathered once here (``transformer.gather_top``), each block's
    inside the block."""
    tokens, labels = batch["tokens"], batch["labels"]
    params = transformer.gather_top(params, cfg)
    kw = {k: batch[k] for k in ("frames", "patches") if k in batch}
    hidden, aux = transformer.forward_hidden(params, cfg, tokens, remat=tcfg.remat, **kw)
    head = transformer._head(params, cfg).to(hidden.dtype)
    seq = layers.seq_parallel(tokens.shape[1])
    loss = chunked_ce(hidden, head, labels, tcfg.ce_chunk, tcfg.z_loss, seq)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp_depth:
        mtp_h = transformer.mtp_hidden(params, cfg, tokens, hidden)
        # MTP predicts token t+2: labels shifted one extra step
        mtp_labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)], dim=1)
        mtp_loss = chunked_ce(mtp_h, head, mtp_labels, tcfg.ce_chunk, tcfg.z_loss, seq)
        loss = loss + tcfg.mtp_weight * mtp_loss
        metrics["mtp"] = mtp_loss
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


def make_grad_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None, placement=None):
    """Returns grad_step(params, batch) -> (grads, grad_norm, metrics): the
    first half of ``make_train_step``'s step — zero-grad, the loss and its
    backward, each leaf's gradient left in ``.grad`` — with the gradients'
    global norm (the clip's), and no update.  Over a mesh as there."""

    def grad_step(params, batch):
        leaves = opt.leaves(params)
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, cfg, tcfg, batch)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is None:
            # a leaf the loss never reached gets a zero gradient, as under jax.grad
            grads = opt.tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params)
            return grads, opt.global_norm(grads), metrics
        sharding.sync_grads(params, placement, mesh, transformer.seq_keys(params, batch["tokens"].shape[1]))
        grads = opt.tree_map(lambda p: p.grad, params)
        norm = sharding.global_norm(grads, placement, mesh)
        # each rank's CE / MTP is its rows' share of the global mean; aux is global already
        for k in ("ce", "mtp"):
            if k in metrics:
                metrics[k] = layers.batch_sum(metrics[k])
        metrics["loss"] = metrics["ce"] + tcfg.mtp_weight * metrics.get("mtp", 0.0) + metrics["aux"]
        return grads, norm, metrics

    return grad_step


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None, placement=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating ``params`` and ``opt_state`` in place.

    Over a mesh (a ``GridMesh`` with ``layers.enable_activation_sharding``
    on it) ``params`` are this rank's shards under ``placement`` (the
    rules of ``launch.mesh.rules_for``) and ``batch`` its rows.  The model
    gathers the shards over the batch axes where it uses them (FSDP,
    ``models.transformer``): the top-level leaves once a step, each
    stacked block's inside the block, again for the backward's recompute
    under remat, and the backward reduce-scatters each block's gradient.
    The layers run tensor parallel on the model axis, the gradients of
    leaves replicated over a batch axis are summed over it
    (``sharding.sync_grads``), and the clip's norm counts each shard once
    (``sharding.global_norm``).  AdamW (``optimizer.adamw_update``) runs
    elementwise on the shards; with int8 moments, which are replicated,
    it updates each moment whole from the gathered gradient and writes
    this rank's shard of the parameter.  The metrics are the global
    batch's."""
    grad_step = make_grad_step(cfg, tcfg, mesh, placement)

    def train_step(params, opt_state, batch):
        grads, norm, metrics = grad_step(params, batch)
        params, opt_state, om = opt.adamw_update(params, grads, opt_state, tcfg.adamw, grad_norm=norm,
                                                 mesh=mesh, placement=placement)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
