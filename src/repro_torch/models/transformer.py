"""Model assembly: spec trees, layer loops, caches (port of
``repro.models.transformer``).

Every family of the reference: dense decoders, MoE, MLA with multi-token
prediction, pure SSM, the jamba hybrid, vision cross-attention and
whisper's encoder-decoder.  Layers are grouped into the reference's stacks
of structurally identical blocks (``group_plans``), their weights stacked
on a leading 'layers' axis under the reference's key paths; ``lax.scan``
over a stack becomes a Python loop over that axis.  The functions take the
parameter tree (nested dicts of tensors) as the reference's do, and
``forward`` / ``forward_hidden`` return ``(…, aux)`` with the MoE
load-balancing loss; ``TransformerLM`` is the ``nn.Module`` that owns a
tree and runs them under ``torch.inference_mode()``.  Caches are updated in
place by ``decode_step`` (the reference returns new ones).

Training (``train/step.py``) calls ``forward_hidden`` / ``mtp_hidden``
with grad enabled on the stacked leaves.  With ``remat`` (the reference's
default) each block runs under the reference's ``REMAT_POLICY``: 'full'
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
scan body) keeps only the blocks' inputs for the backward and runs each
block's forward again there, its B.6 launches included; 'dots' (a
selective checkpoint, jax's ``dots_with_no_batch_dims_saveable``) keeps
the outputs of its 2-D matrix products too and recomputes the rest (B.6,
``bmm``, norms, elementwise ops, collectives); 'none' keeps whatever
autograd saves.  The blocks' weights are ``unbind``
views of the stacked leaves, so the backward stacks each leaf's gradient
once.  Over a mesh the parameters are this rank's shards, and FSDP
gathers them over the batch axes where they are used (``_Fsdp``): the
top-level leaves once per step or call, each stacked block's leaves
inside the function the block's remat policy runs, so the gathered copy
dies with the block ('full' and 'dots' gather it again for the backward's
recompute, as the reference's backward scan does; 'none' keeps it for the
backward) and its gradient is reduce-scattered per block.  Over a mesh
(``layers.enable_activation_sharding``) the embedding and the head run
vocab-parallel when the model axis splits the vocabulary
(``_embed``, ``_logits``; the training loss uses ``train.sharding``'s
vocab-parallel CE on ``_head``); the layers do the rest.  Under
``layers.SEQ_SHARD`` (where the model axis divides S) the embedding ends
in a reduce-scatter to this rank's positions (or looks up only those),
the blocks and the final norm run on them, and the head gathers them
back (the training loss: ``step.chunked_ce``); ``prefill`` gathers the
K/V and latents it caches and takes the last position's hidden state
from the last model rank.

Serving over a mesh (the same switch): ``prefill`` and ``decode_step`` run
one rank's part of the reference's GSPMD serving program.  ``params`` are
this rank's shards (``train.sharding.local_tree`` under the training
placement), gathered over the batch axes on each call as in training,
one block at a time (a caller may hand over leaves gathered once, which
are used as they are); ``prefill`` takes this rank's rows of a global
batch split over the batch axes.  ``init_cache`` gives each leaf this rank's shard under
``launch.mesh.cache_pspec_for`` (a ``MeshCache``, which keeps the
placements), ``prefill`` writes what this rank holds (``_prefill_attn``),
``decode_step`` hands each attention, cross-attention and MLA layer the
axes its slots (or memory positions) are split over, and both return
logits over the whole vocabulary for this rank's rows.  The model axis
takes every family: the MoE layers run expert parallel (``models.moe``),
MLA its heads (``models.mla``), cross-attention and whisper's encoder
the attention's column- and row-parallel path, the SSM blocks their heads
(``models.ssm``: 'h' split with them, the 'conv' shard exchanged over
'model'), and jamba mixes the SSM, attention, MLP and MoE paths; the MTP
module's embedding is vocab-parallel like the model's.  Every family
takes a global batch the batch axes do not divide, by the reference's
rule (``layers.rows_split``): then every batch rank holds all its rows
(whisper's frames and the VLM's patches too), the cache's batch dim is
whole (at batch 1 the slots split over every axis), and the layers run
under ``layers.rows_context(False)``: the MoE groups and capacities are
those rows', and nothing over the batch axes combines rows; FSDP's
gathers over them stay.  ``prefill`` is told the global batch
(``batch``), and ``decode_step`` reads it off its ``MeshCache``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, materialize
from repro_torch.train import sharding


# ---------------------------------------------------------------------------
# spec utilities
# ---------------------------------------------------------------------------

def stack_specs(tree, n: int):
    if isinstance(tree, dict):
        return {k: stack_specs(v, n) for k, v in tree.items()}
    return ParamSpec((n,) + tree.shape, ("layers",) + tree.axes, tree.init, tree.scale)


def _layer_specs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    if mixer == "attn":
        mix = layers.attention_specs(cfg)
    elif mixer == "cross":
        mix = layers.attention_specs(cfg, cross=True)
    elif mixer == "mla":
        mix = mla.mla_specs(cfg)
    elif mixer == "ssm":
        mix = ssm.ssm_specs(cfg)
    else:
        raise ValueError(mixer)
    out = {"mixer_norm": layers.norm_specs(cfg), "mixer": mix}
    if ffn == "mlp":
        out["ffn_norm"] = layers.norm_specs(cfg)
        out["ffn"] = layers.mlp_specs(cfg)
    elif ffn == "moe":
        out["ffn_norm"] = layers.norm_specs(cfg)
        out["ffn"] = moe.moe_specs(cfg)
    elif ffn != "none":
        raise ValueError(ffn)
    return out


def _ffn(p, cfg, x, ffn):
    """The residual feed-forward half of a layer: (x, the MoE aux loss, or
    None for a layer without MoE — no zero tensor is made per layer)."""
    aux = None
    if ffn != "none":
        h = layers.norm_fwd(p["ffn_norm"], cfg, x)
        if ffn == "moe":
            h, aux = moe.moe_fwd(p["ffn"], cfg, h)
        else:
            h = layers.mlp_fwd(p["ffn"], cfg, h)
        x = x + h
    return x, aux


def _layer_fwd(p, cfg, x, positions, mixer, ffn, *, window=0, enc_out=None,
               enc_positions=None):
    """Residual decoder layer, full-sequence. Returns (x, aux or None)."""
    h = layers.norm_fwd(p["mixer_norm"], cfg, x)
    if mixer == "attn":
        h = layers.attention_fwd(p["mixer"], cfg, h, positions, causal=True, window=window)
    elif mixer == "cross":
        h = layers.attention_fwd(p["mixer"], cfg, h, positions, causal=False,
                                 kv_x=enc_out, kv_positions=enc_positions)
    elif mixer == "enc_attn":
        h = layers.attention_fwd(p["mixer"], cfg, h, positions, causal=False)
    elif mixer == "mla":
        h = mla.mla_fwd(p["mixer"], cfg, h, positions)
    elif mixer == "ssm":
        h, _ = ssm.ssm_fwd(p["mixer"], cfg, h, state=False)
    else:
        raise ValueError(mixer)
    return _ffn(p, cfg, x + h, ffn)


def _layer_decode(p, cfg, x, cache, mixer, ffn, *, window=0, slot_axes=((), ())):
    """Residual decoder layer, one token, with cache (updated in place).
    ``slot_axes``: the mesh axes the slots of an attention cache's K/V and
    of its 'slot_pos' are split over (``_slot_axes``; a cross-attention
    cache's memory positions and MLA's latent slots in the first entry).
    Returns (x, cache)."""
    h = layers.norm_fwd(p["mixer_norm"], cfg, x)
    if mixer == "attn":
        h, cache = layers.attention_decode(p["mixer"], cfg, h, cache, window=window, slot_axes=slot_axes[0],
                                           pos_axes=slot_axes[1])
    elif mixer == "cross":  # memory K/V cached at prefill, no mask
        h = layers.cross_attention_decode(p["mixer"], cfg, h, cache, slot_axes=slot_axes[0])
    elif mixer == "mla":
        h, cache = mla.mla_decode(p["mixer"], cfg, h, cache, absorb=cfg.mla_absorb, slot_axes=slot_axes[0])
    elif mixer == "ssm":
        h, cache = ssm.ssm_decode(p["mixer"], cfg, h, cache)
    else:
        raise ValueError(mixer)
    x, _ = _ffn(p, cfg, x + h, ffn)
    return x, cache


def _layer_cache(cfg, mixer, batch, max_seq, window=0, enc_len=0, dtype=torch.bfloat16,
                 device=None) -> dict:
    if mixer == "attn":
        return layers.init_attn_cache(cfg, batch, max_seq, window, dtype, device)
    if mixer == "cross":
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if mixer == "mla":
        return mla.init_mla_cache(cfg, batch, max_seq, dtype, device)
    if mixer == "ssm":
        return ssm.init_ssm_state(cfg, batch, dtype, device)
    raise ValueError(mixer)


# ---------------------------------------------------------------------------
# group plans: which layer stacks a config lowers to
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupPlan:
    name: str
    n: int  # stack length (number of stacked blocks)
    sublayers: tuple[tuple[str, str], ...]  # (mixer, ffn) per sublayer in a block


def group_plans(cfg: ModelConfig) -> list[GroupPlan]:
    if cfg.encoder is not None:  # whisper: decoder here; encoder handled apart
        return [GroupPlan("dec", cfg.n_layers, (("attn", "none"), ("cross", "mlp")))]
    if cfg.vision is not None:
        k = cfg.vision.cross_attn_every
        if cfg.n_layers % k:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of {k}")
        subs = tuple([("attn", "mlp")] * (k - 1) + [("cross", "mlp")])
        return [GroupPlan("blocks", cfg.n_layers // k, subs)]
    if cfg.layer_pattern == "jamba":
        per = cfg.attn_every
        if cfg.n_layers % per:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of {per}")
        subs = []
        for i in range(per):
            mixer = "attn" if i == per // 2 else "ssm"
            ffn = "moe" if (cfg.moe is not None and i % cfg.moe.every == cfg.moe.every - 1) else "mlp"
            subs.append((mixer, ffn))
        return [GroupPlan("blocks", cfg.n_layers // per, tuple(subs))]
    if cfg.ssm is not None:  # pure SSM
        return [GroupPlan("layers", cfg.n_layers, (("ssm", "none"),))]
    mixer = "mla" if cfg.mla is not None else "attn"
    if cfg.moe is not None:
        fd = cfg.moe.first_dense
        plans = []
        if fd:
            plans.append(GroupPlan("dense", fd, ((mixer, "mlp"),)))
        if cfg.moe.every > 1:
            subs = tuple(
                (mixer, "moe" if i % cfg.moe.every == cfg.moe.every - 1 else "mlp")
                for i in range(cfg.moe.every)
            )
            plans.append(GroupPlan("moe", (cfg.n_layers - fd) // cfg.moe.every, subs))
        else:
            plans.append(GroupPlan("moe", cfg.n_layers - fd, ((mixer, "moe"),)))
        return plans
    return [GroupPlan("layers", cfg.n_layers, ((mixer, "mlp"),))]


# ---------------------------------------------------------------------------
# model specs
# ---------------------------------------------------------------------------

def model_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    out: dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="embed"),
        "final_norm": layers.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    for plan in group_plans(cfg):
        block = {f"s{i}": _layer_specs(cfg, m, f) for i, (m, f) in enumerate(plan.sublayers)}
        out[plan.name] = stack_specs(block, plan.n)
    if cfg.encoder is not None:
        # encoder self-attention is bidirectional; same spec shapes
        out["encoder"] = stack_specs({"s0": _layer_specs(cfg, "attn", "mlp")}, cfg.encoder.n_layers)
        out["enc_final_norm"] = layers.norm_specs(cfg)
        out["enc_pos"] = ParamSpec((cfg.encoder.n_frames, d), ("frames", "embed"), init="embed")
    if cfg.vision is not None:
        out["vision_norm"] = layers.norm_specs(cfg)
    if cfg.mtp_depth:
        out["mtp"] = {
            "proj": ParamSpec((2 * d, d), ("embed", None)),
            "norm": layers.norm_specs(cfg),
            "layer": _layer_specs(cfg, "mla" if cfg.mla else "attn", "mlp"),
        }
    return out


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, not copies): the caches, which
    decode updates in place."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The ``n`` blocks of a stacked tree, as per-block trees of ``unbind``
    views (one backward node per leaf, which stacks the blocks' gradients)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: part[i] for k, part in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _embed(params, tokens: torch.Tensor, dtype=torch.bfloat16, *, seq: bool = False) -> torch.Tensor:
    """Embedding rows of ``tokens`` in ``dtype``; vocab-parallel when the
    table's rows are split over the model axis (``layers.vocab_parallel``).
    ``seq``: this rank's positions of ``tokens`` [B, S] only (sequence
    parallelism: the vocab-parallel sum becomes a reduce-scatter)."""
    table = params["embed"].to(dtype)
    mesh = layers.vocab_parallel()
    if mesh is None:
        return table[layers.own_positions(tokens) if seq else tokens]
    return sharding.vocab_parallel_embed(table, tokens, mesh, seq=seq)


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    """The LM head [D, V] (this rank's V/M columns when the vocabulary is
    split over the model axis)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, cfg: ModelConfig, x: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """f32 logits over the whole vocabulary; vocab-parallel, each rank's
    columns are gathered over the model axis.  ``seq``: ``x`` [B, S/M, D]
    is this rank's positions (sequence parallelism), gathered first."""
    head = _head(params, cfg)
    mesh = layers.vocab_parallel()
    if seq:  # split vocabulary: each rank's gradient of the positions is a part; whole: the same on each
        gather = sharding.gather_from if mesh is None else sharding.seq_gather
        x = gather(x, layers.model_parallel(), "model", 1)
    elif mesh is not None:
        x = sharding.copy_to(x, mesh)
    if mesh is None:
        return (x @ head.to(x.dtype)).float()
    return sharding.gather_from((x @ head.to(x.dtype)).float(), mesh, "model", -1)


def _encode(params, cfg: ModelConfig, frames, patches, dtype=torch.bfloat16, *, fsdp=None):
    """The stub-fronted encoder side: whisper's frames through its encoder
    stack (each block's leaves gathered by ``fsdp`` over a mesh), or the
    VLM's patches through ``vision_norm``.  Returns (enc_out,
    enc_positions), or (None, None) for a decoder-only model."""
    if cfg.encoder is not None:
        if frames is None:
            raise ValueError("whisper needs frame embeddings (stub frontend): frames=[B, n_frames, D]")
        e = frames.to(dtype) + params["enc_pos"].to(dtype)[None]
        e_pos = torch.arange(frames.shape[1], device=e.device)
        for lp in _unstack(params["encoder"], cfg.encoder.n_layers):
            lp = fsdp.block("encoder", lp) if fsdp else lp
            e, _ = _layer_fwd(lp["s0"], cfg, e, e_pos, "enc_attn", "mlp")
        return layers.norm_fwd(params["enc_final_norm"], cfg, e), e_pos
    if cfg.vision is not None:
        if patches is None:
            raise ValueError("the VLM needs patch embeddings (stub frontend): patches=[B, n_tokens, D]")
        enc_out = layers.norm_fwd(params["vision_norm"], cfg, patches.to(dtype))
        return enc_out, torch.arange(patches.shape[1], device=enc_out.device)
    return None, None


def _blocks(params, cfg: ModelConfig):
    """(plan, block index, block parameters) over every stacked block."""
    for plan in group_plans(cfg):
        for li, lp in enumerate(_unstack(params[plan.name], plan.n)):
            yield plan, li, lp


# ---------------------------------------------------------------------------
# FSDP: the shards gathered over the batch axes where they are used
# ---------------------------------------------------------------------------

class _Fsdp:
    """Gathers this rank's parameter shards over the batch axes (FSDP,
    ``sharding.gather_weights``: one all-gather for a call's leaves, one
    reduce-scatter back) under the placement of ``cfg`` on ``mesh``
    (``launch.mesh.rules_for``): ``top`` the top-level leaves — embedding,
    final norm, head, the MTP module, the encoder side's norm and
    positions — and ``block`` one stacked block's leaves (a plan's, or
    whisper's encoder's).  A leaf handed over already gathered (its shape
    is its gathered shape: a caller that gathered once to serve many
    calls, or a placement without FSDP) is used as it is."""

    def __init__(self, cfg: ModelConfig, mesh):
        from repro_torch.launch import mesh as meshlib
        from repro_torch.models import params as params_lib

        self.mesh, self.specs = mesh, model_specs(cfg)
        self.place = params_lib.validate_divisibility(self.specs, mesh, meshlib.rules_for(mesh))
        self.batch = meshlib.batch_axes(mesh)
        self.stacked = {plan.name for plan in group_plans(cfg)} | ({"encoder"} if cfg.encoder else set())

    def _gather(self, tree: dict, specs: dict, place: dict, lead: int) -> dict:
        """``tree`` with its leaves gathered, in one call: ``specs`` /
        ``place`` its specs and placements (stacked ones, ``lead`` 1)."""
        todo = []  # (key path, shard, placement) of each leaf not gathered yet
        for path, t in _leaves(tree):
            spec, pl = _at(specs, path), _at(place, path)[lead:]
            model = [tuple(a for a in sharding._entry_axes(e) if a not in self.batch) for e in pl]
            gathered = tuple(n // self.mesh.axis_size(axes) for n, axes in zip(spec.shape[lead:], model))
            if tuple(t.shape) != gathered:
                todo.append((path, t, pl))
        got = dict(zip((path for path, _, _ in todo),
                       sharding.gather_weights([t for _, t, _ in todo], [pl for *_, pl in todo], self.mesh)))
        return _replaced(tree, got)

    def top(self, params: dict) -> dict:
        """``params`` with every leaf outside the stacked blocks gathered."""
        top = self._gather({k: v for k, v in params.items() if k not in self.stacked}, self.specs, self.place, 0)
        return {k: params[k] if k in self.stacked else top[k] for k in params}

    def block(self, name: str, lp: dict) -> dict:
        """One block of stack ``name`` (``_unstack``'s views) gathered."""
        return self._gather(lp, self.specs[name], self.place[name], 1)


def _leaves(tree: dict, path: tuple = ()) -> list:
    """(key path, leaf) of every leaf of a nested dict."""
    return [x for k, v in tree.items() for x in (_leaves(v, path + (k,)) if isinstance(v, dict)
                                                   else [(path + (k,), v)])]


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _replaced(tree: dict, new: dict, path: tuple = ()) -> dict:
    """``tree`` with the leaf at each key path of ``new`` replaced (no
    closure: a reference cycle would keep gathered weights alive until the
    collector runs)."""
    return {k: _replaced(v, new, path + (k,)) if isinstance(v, dict) else new.get(path + (k,), v)
            for k, v in tree.items()}


def _fsdp(cfg: ModelConfig) -> _Fsdp | None:
    """The gatherer over the activation mesh, None without one."""
    return None if layers._ACT_MESH is None else _Fsdp(cfg, layers._ACT_MESH)


def gather_top(params: dict, cfg: ModelConfig) -> dict:
    """``params`` with its top-level leaves gathered over the batch axes
    when the layers run over a mesh (``_Fsdp.top``); the stacked blocks
    stay shards, gathered one block at a time where they run."""
    fsdp = _fsdp(cfg)
    return params if fsdp is None else fsdp.top(params)


# ---------------------------------------------------------------------------
# forward (scoring)
# ---------------------------------------------------------------------------

def _block_fwd(lp, cfg: ModelConfig, plan: GroupPlan, x, positions, enc_out, enc_positions, seq=False,
               fsdp=None):
    """One stacked block's sublayers, on this rank's sequence shard under
    ``seq`` (sequence parallelism), its leaves gathered first by ``fsdp``
    over a mesh. Returns (x, the MoE aux loss summed over them, or
    None)."""
    lp = fsdp.block(plan.name, lp) if fsdp else lp
    aux = None
    shape = (x.shape[0] * layers.batch_ranks(), positions.shape[0], x.shape[-1])
    with layers.seq_context(seq):
        layers.constrain_seq(x, shape)
        for i, (mixer, ffn) in enumerate(plan.sublayers):
            window = cfg.sliding_window if mixer == "attn" else 0
            x, a = _layer_fwd(lp[f"s{i}"], cfg, x, positions, mixer, ffn, window=window,
                              enc_out=enc_out, enc_positions=enc_positions)
            layers.constrain_seq(x, shape)
            if a is not None:
                aux = a if aux is None else aux + a
    return x, aux


REMAT_POLICY = "full"  # the reference's switch: 'full' (checkpoint the block) | 'dots' (save the
# outputs of its matrix products with no batch dims, recompute the rest) | 'none' (no remat)

# the products 'dots' saves: ``x @ W`` of a [B, S, D] activation lowers to these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(_ctx, op, *_args, **_kwargs):
    """jax's ``dots_with_no_batch_dims_saveable`` in torch's selective
    checkpoint: must-save the 2-D products, recompute everything else —
    ``bmm`` and batched einsums (attention scores, the MoE experts), B.6's
    op, norms, elementwise ops and the collectives."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, *args):
    """``fn(*args)`` under the block's remat policy (``REMAT_POLICY``)."""
    if REMAT_POLICY == "none":
        return fn(*args)
    if REMAT_POLICY == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    if REMAT_POLICY != "full":
        raise ValueError(f"REMAT_POLICY {REMAT_POLICY!r}: 'full', 'dots' or 'none'")
    return checkpoint(fn, *args, use_reentrant=False)


# the top-level leaves that never meet the decoder's sequence shards: the
# encoder side, whole on every model rank
SEQ_FREE = ("encoder", "enc_final_norm", "enc_pos", "vision_norm")


def seq_keys(params: dict, seq_len: int) -> tuple:
    """The top-level keys of ``params`` whose leaves act on the sequence
    shards of a ``seq_len`` stream (``sharding.sync_grads``'s
    ``seq_keys``): every one but ``SEQ_FREE`` under sequence parallelism,
    none without it."""
    return tuple(k for k in params if k not in SEQ_FREE) if layers.seq_parallel(seq_len) else ()


def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                   frames: torch.Tensor | None = None,
                   patches: torch.Tensor | None = None,
                   remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward WITHOUT the LM head.

    tokens: int[B, S] -> (hidden bf16[B, S, D] after the final norm, aux
    f32 — the MoE load-balancing loss summed over layers).  ``remat``:
    with grad enabled, each block under ``REMAT_POLICY`` (module
    docstring); without grad it changes nothing.  Under sequence
    parallelism (``layers.seq_parallel(S)``) the hidden states are this
    rank's [B, S/M, D] positions.  Over a mesh ``params`` are this rank's
    shards (or its top-level leaves gathered already, ``gather_top``).
    """
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    seq = layers.seq_parallel(tokens.shape[1])
    fsdp = _fsdp(cfg)
    params = params if fsdp is None else fsdp.top(params)
    x = _embed(params, tokens, seq=True) if seq else _embed(params, tokens)
    aux = torch.zeros((), device=x.device)
    enc_out, enc_positions = _encode(params, cfg, frames, patches, fsdp=fsdp)
    remat = remat and torch.is_grad_enabled()
    for plan, _li, lp in _blocks(params, cfg):
        args = (lp, cfg, plan, x, positions, enc_out, enc_positions, seq, fsdp)
        x, a = _remat(_block_fwd, *args) if remat else _block_fwd(*args)
        if a is not None:
            aux = aux + a
    return layers.norm_fwd(params["final_norm"], cfg, x), aux


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            frames: torch.Tensor | None = None,
            patches: torch.Tensor | None = None,
            remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. tokens: int[B, S] -> (logits f32[B, S, V], aux)."""
    params = gather_top(params, cfg)
    x, aux = forward_hidden(params, cfg, tokens, frames=frames, patches=patches, remat=remat)
    return _logits(params, cfg, x, seq=layers.seq_parallel(tokens.shape[1])), aux


def mtp_hidden(params, cfg: ModelConfig, tokens: torch.Tensor, hidden: torch.Tensor):
    """DeepSeek MTP module hidden states: predict token t+2 from
    [h_t ; emb(token_{t+1})].  None without an MTP module.  Under sequence
    parallelism ``hidden`` and the result are this rank's positions."""
    if not cfg.mtp_depth:
        return None
    params = gather_top(params, cfg)
    p = params["mtp"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    seq = layers.seq_parallel(tokens.shape[1])
    nxt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    nxt = (_embed(params, nxt, seq=True) if seq else _embed(params, nxt)).to(hidden.dtype)
    h = torch.cat([hidden, nxt], dim=-1) @ p["proj"].to(hidden.dtype)
    with layers.seq_context(seq):
        h, _ = _layer_fwd(p["layer"], cfg, h, positions, "mla" if cfg.mla else "attn", "mlp")
    return layers.norm_fwd(p["norm"], cfg, h)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _enc_len(cfg: ModelConfig) -> int:
    if cfg.encoder is not None:
        return cfg.encoder.n_frames
    return cfg.vision.n_tokens if cfg.vision is not None else 0


class MeshCache(dict):
    """A cache tree over a mesh (``init_cache`` under activation
    sharding): the dict of this rank's shards, ``specs``, every leaf's
    placement on the mesh (``launch.mesh.cache_pspec_for``) by the same key
    paths, and ``batch``, the global batch it holds (its rows split over
    the batch axes where they divide it, ``layers.rows_split``)."""

    def __init__(self, tree: dict, specs: dict, batch: int):
        super().__init__(tree)
        self.specs, self.batch = specs, batch


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               enc_len: int = 0, device=None) -> dict:
    """{plan name: {'s<i>': per-mixer cache, each leaf with a leading block
    axis}} — the reference's cache tree: attention {'k', 'v', 'pos',
    'slot_pos'}, cross-attention {'k', 'v'} over ``enc_len`` memory
    positions, MLA {'ckv', 'kr', 'pos'}, SSM {'h', 'conv', 'pos'}.

    Over a mesh (activation sharding on) ``batch`` is the global batch and
    each leaf is this rank's shard (a ``MeshCache``): its batch dim whole
    where the batch axes do not divide ``batch``."""
    mesh = layers._ACT_MESH
    if mesh is not None:
        from repro_torch.launch import mesh as meshlib
    cache: dict[str, Any] = {}
    specs: dict[str, Any] = {}
    for plan in group_plans(cfg):
        sub, sub_specs = {}, {}
        for i, (mixer, _f) in enumerate(plan.sublayers):
            window = cfg.sliding_window if mixer == "attn" else 0
            if mesh is None:
                one = _layer_cache(cfg, mixer, batch, max_seq, window, enc_len, dtype, device)
                sub[f"s{i}"] = {k: t.expand(plan.n, *t.shape).clone() for k, t in one.items()}
                continue
            one = _layer_cache(cfg, mixer, batch, max_seq, window, enc_len, dtype, "meta")
            sub_specs[f"s{i}"] = {k: meshlib.cache_pspec_for(k, (plan.n, *t.shape), mesh)
                                  for k, t in one.items()}
            sub[f"s{i}"] = {k: torch.full(_local_shape((plan.n, *t.shape), sub_specs[f"s{i}"][k], mesh),
                                          -(10**9) if k == "slot_pos" else 0, dtype=t.dtype, device=device)
                            for k, t in one.items()}
        cache[plan.name] = sub
        specs[plan.name] = sub_specs
    return cache if mesh is None else MeshCache(cache, specs, batch)


def _local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    return tuple(n // (mesh.axis_size(e) if e is not None else 1) for n, e in zip(shape, spec))


def _slot_axes(cache, plan: str, sub: str, mixer: str) -> tuple[tuple, tuple]:
    """The mesh axes a cache's slots are split over, () when whole: for an
    attention layer (those of 'k' / 'v', those of 'slot_pos'); for a
    cross-attention layer (those of its memory's T dim, ()); for MLA
    (those of the latents' slots, ())."""
    specs = getattr(cache, "specs", None)
    if specs is None:
        if layers._ACT_MESH is not None:
            raise ValueError("decode over a mesh takes the cache init_cache / prefill made there")
        return (), ()
    leaves = specs[plan][sub]
    if mixer == "attn":
        return tuple(sharding._entry_axes(leaves[key][2]) for key in ("k", "slot_pos"))
    if mixer in ("cross", "mla"):
        return sharding._entry_axes(leaves["k" if mixer == "cross" else "ckv"][2]), ()
    return (), ()


def _held(buf: torch.Tensor, axes: tuple) -> slice:
    """The global slots (or memory positions) of ``buf`` [B, local slots,
    ...], this rank's shard of them over ``axes``."""
    local = buf.shape[1]
    off = layers._ACT_MESH.axis_index(axes) * local if axes else 0
    return slice(off, off + local)


def _serve_rows(batch: int | None, b: int):
    """``layers.rows_context`` of a serving call whose global batch is
    ``batch`` and whose rows here are ``b``: split over the batch axes
    where they divide ``batch``, else all of them on every batch rank
    (``layers.local_rows``).  Over the activation mesh ``batch`` must be
    given: ``b`` alone cannot tell a rank's share from every row."""
    if layers._ACT_MESH is None:
        return layers.rows_context(True)
    if batch is None:
        raise ValueError("serving over a mesh needs the global batch: prefill's batch=, and a"
                         " MeshCache (init_cache over the mesh) for decode_step")
    lo, hi = layers.local_rows(batch)
    if b != hi - lo:
        raise ValueError(f"a batch of {batch} over {layers._ACT_BATCH_SIZE} batch ranks gives each"
                         f" {hi - lo} rows, not {b}")
    return layers.rows_context(layers.rows_split(batch))


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """One decode step: next-token logits f32[B, V] + the cache, updated in
    place (over a mesh: this rank's rows — every row where the batch axes
    do not divide the cache's batch — every vocabulary entry; the shards
    gathered as ``prefill`` gathers them)."""
    with _serve_rows(getattr(cache, "batch", None), token.shape[0]):
        return _decode_step(params, cfg, token, cache)


def _decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    fsdp = _fsdp(cfg)
    params = params if fsdp is None else fsdp.top(params)
    x = _embed(params, token)[:, None, :]
    for plan, li, lp in _blocks(params, cfg):
        lp = fsdp.block(plan.name, lp) if fsdp else lp
        lc = _index(cache[plan.name], li)
        for i, (mixer, ffn) in enumerate(plan.sublayers):
            window = cfg.sliding_window if mixer == "attn" else 0
            axes = _slot_axes(cache, plan.name, f"s{i}", mixer)
            x, _ = _layer_decode(lp[f"s{i}"], cfg, x, lc[f"s{i}"], mixer, ffn, window=window, slot_axes=axes)
    x = layers.norm_fwd(params["final_norm"], cfg, x)
    return _logits(params, cfg, x[:, 0]), cache


def _seq_whole(t: torch.Tensor, seq: bool) -> torch.Tensor:
    """``t`` [B, S/M, ...] of this rank's positions gathered whole over the
    model axis under ``seq`` (no gradient: prefill)."""
    return sharding.all_gather(t, layers._ACT_MESH, layers._ACT_MODEL_AXIS, 1) if seq else t


def _prefill_attn(spec, cfg, hh, positions, c, li, slot_axes=((), ()), seq=False) -> None:
    """Write one attention layer's prompt K/V into its cache slice ``li``:
    the slots this rank holds (all of them unless ``slot_axes`` — those of
    'k' / 'v', those of 'slot_pos' — split them).  A sliding-window layer
    whose ring of ``window`` slots is shorter than the prompt keeps the last
    ``window`` positions, each at slot ``pos % window``.  ``seq``: ``hh``
    holds this rank's positions; their K/V, narrower than ``hh`` under
    GQA, are gathered over the model axis where ``wk`` / ``wv`` are whole,
    and ``hh`` itself where they are this rank's KV heads (each rank
    projects its heads at every position)."""
    if seq and spec["mixer"]["wk"].shape[-2] < cfg.n_kv_heads:
        hh, seq = _seq_whole(hh, True), False
    k, v = layers._project_kv(spec["mixer"], cfg, hh)
    k = layers.rope(k, layers.own_positions(positions, 0) if seq else positions, cfg.rope_theta)
    k, v = _seq_whole(k, seq), _seq_whole(v, seq)
    s = k.shape[1]
    mesh = layers._ACT_MESH
    slots = c["k"].shape[2] * (mesh.axis_size(slot_axes[0]) if slot_axes[0] else 1)
    held = torch.arange(s, device=hh.device)  # the position at each global slot
    if cfg.sliding_window > 0 and slots < s:
        kept = torch.arange(s - slots, s, device=hh.device)
        held = kept[torch.argsort(kept % slots)]  # ring layout: slot = pos % slots

    def mine(name: str, axes: tuple) -> torch.Tensor:
        """The positions at this rank's slots of ``name`` (fewer than its
        slots past the prompt's end: those stay empty)."""
        local = c[name].shape[2]
        off = mesh.axis_index(axes) * local if axes else 0
        return held[off : off + local]

    at = mine("k", slot_axes[0])
    c["k"][li, :, : at.shape[0]] = k[:, at]
    c["v"][li, :, : at.shape[0]] = v[:, at]
    at = mine("slot_pos", slot_axes[1])
    c["slot_pos"][li, :, : at.shape[0]] = at.to(torch.int32)[None]
    c["pos"][li] = s


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, max_seq: int, *,
            frames: torch.Tensor | None = None, patches: torch.Tensor | None = None,
            batch: int | None = None):
    """Run the prompt, build the cache. Returns (last-token logits f32[B, V],
    cache).

    Full-sequence forward + cache writeback, as in the reference: attention
    layers recompute their K/V into the cache (over a mesh this rank's KV
    heads, or every KV head when ``wk`` / ``wv`` are whole, and it keeps
    its slots), MLA layers their latents,
    cross-attention layers the memory's K/V; SSM layers keep the final
    state of the chunked scan.  Under sequence parallelism
    (``layers.seq_parallel(S)``) the residual stream is this rank's
    positions: the K/V and latents projected from them are gathered over
    the model axis before the cache takes its slots, and the last
    position's hidden state comes from the last model rank.  Over a mesh
    the top-level leaves are gathered once and each block's inside the
    block (``_Fsdp``), as the reference's serving program gathers them.
    ``batch``: the global batch, required over a mesh (without one it is
    ``tokens``' rows); ``tokens`` (and ``frames`` / ``patches``) are this
    rank's rows of it, ``layers.local_rows(batch)``: every row, on every
    batch rank, where the batch axes do not divide it.
    """
    batch = tokens.shape[0] if batch is None and layers._ACT_MESH is None else batch
    with _serve_rows(batch, tokens.shape[0]):
        return _prefill(params, cfg, tokens, max_seq, frames, patches, batch)


def _prefill(params, cfg, tokens, max_seq, frames, patches, batch):
    s = tokens.shape[1]
    if cfg.sliding_window == 0 and s > max_seq:
        raise ValueError(f"prompt length {s} exceeds max_seq {max_seq}")
    fsdp = _fsdp(cfg)
    params = params if fsdp is None else fsdp.top(params)
    dev = tokens.device
    positions = torch.arange(s, device=dev)
    seq = layers.seq_parallel(s)
    x = _embed(params, tokens, seq=True) if seq else _embed(params, tokens)
    cache = init_cache(cfg, batch, max_seq, enc_len=_enc_len(cfg), device=dev)
    enc_out, enc_positions = _encode(params, cfg, frames, patches, fsdp=fsdp)
    with layers.seq_context(seq):
        x = _prefill_blocks(params, cfg, x, positions, cache, enc_out, enc_positions, seq, fsdp)
    x = layers.norm_fwd(params["final_norm"], cfg, x)
    return _logits(params, cfg, _seq_whole(x[:, -1:], seq)[:, -1]), cache


def _prefill_blocks(params, cfg, x, positions, cache, enc_out, enc_positions, seq, fsdp=None):
    """``prefill``'s layer loop: the residual stream after every block, each
    layer's cache slice written (each block's leaves gathered first by
    ``fsdp`` over a mesh)."""
    for plan, li, lp in _blocks(params, cfg):
        x = _prefill_block(fsdp.block(plan.name, lp) if fsdp else lp, cfg, plan, li, x, positions, cache,
                           enc_out, enc_positions, seq)
    return x


def _prefill_block(lp, cfg, plan, li, x, positions, cache, enc_out, enc_positions, seq):
    """Block ``li`` of ``plan`` in ``prefill``: its sublayers on ``x``, each
    one's cache slice written (a function of its own, so that a gathered
    block dies when it returns)."""
    s = positions.shape[0]
    for i, (mixer, ffn) in enumerate(plan.sublayers):
        spec, c = lp[f"s{i}"], cache[plan.name][f"s{i}"]
        if mixer == "ssm":  # the layer by hand: ssm_fwd also gives the state
            y, st = ssm.ssm_fwd(spec["mixer"], cfg, layers.norm_fwd(spec["mixer_norm"], cfg, x))
            x, _ = _ffn(spec, cfg, x + y, ffn)
            for name, t in st.items():
                c[name][li] = t
            continue
        hh = layers.norm_fwd(spec["mixer_norm"], cfg, x)
        if mixer == "attn":
            _prefill_attn(spec, cfg, hh, positions, c, li, _slot_axes(cache, plan.name, f"s{i}", mixer), seq)
        elif mixer == "mla":  # the prompt's latents at the slots this rank holds
            ckv, kr = mla.kv_latents(spec["mixer"], cfg, hh, layers.own_positions(positions, 0) if seq
                                     else positions)
            ckv, kr = _seq_whole(ckv, seq), _seq_whole(kr, seq)
            held = _held(c["ckv"][li], _slot_axes(cache, plan.name, f"s{i}", mixer)[0])
            ckv, kr = ckv[:, held], kr[:, held]  # fewer than the slots past the prompt's end
            c["ckv"][li, :, : ckv.shape[1]] = ckv
            c["kr"][li, :, : kr.shape[1]] = kr
            c["pos"][li] = s
        elif mixer == "cross":  # this rank's KV heads (every one when wk / wv are whole), its T
            k, v = layers._project_kv(spec["mixer"], cfg, enc_out)
            held = _held(c["k"][li], _slot_axes(cache, plan.name, f"s{i}", mixer)[0])
            c["k"][li], c["v"][li] = k[:, held], v[:, held]
        window = cfg.sliding_window if mixer == "attn" else 0
        x, _ = _layer_fwd(spec, cfg, x, positions, mixer, ffn, window=window,
                          enc_out=enc_out, enc_positions=enc_positions)
        layers.constrain_seq(x, (x.shape[0] * layers.batch_ranks(), s, x.shape[-1]))
    return x


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """A nested parameter dict as modules: key paths are attribute paths."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def as_dict(self) -> dict:
        out: dict[str, Any] = dict(self._parameters)
        out.update((k, m.as_dict()) for k, m in self._modules.items())
        return out


class TransformerLM(nn.Module):
    """An LM of any family that owns its parameter tree (the reference's key
    paths, e.g. ``layers.s0.mixer.wq`` with a leading layer axis).

    Build it from a tree (``params.materialize`` or ``params.from_reference``)
    or with ``TransformerLM.init(cfg, seed, device=...)``.  ``forward``,
    ``prefill`` and ``decode_step`` take token ids (tensors or arrays) and
    run under ``torch.inference_mode()`` on the parameters' device;
    ``frames`` (whisper) and ``patches`` (the VLM) are the stub frontends'
    embeddings [B, n, D].
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device=None):
        return cls(cfg, materialize(model_specs(cfg), seed, dtype, device))

    @property
    def params(self) -> dict:
        return self.tree.as_dict()

    @property
    def device(self) -> torch.device:
        return self.tree.embed.device

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _extra(self, frames, patches) -> dict:
        return {name: None if t is None else torch.as_tensor(t, device=self.device)
                for name, t in (("frames", frames), ("patches", patches))}

    @torch.inference_mode()
    def forward(self, tokens, frames=None, patches=None) -> torch.Tensor:
        """int[B, S] -> logits f32[B, S, V] (``transformer.forward`` gives
        the aux loss too)."""
        logits, _aux = forward(self.params, self.cfg, self._tokens(tokens),
                               **self._extra(frames, patches))
        return logits

    @torch.inference_mode()
    def prefill(self, tokens, max_seq: int, frames=None, patches=None):
        """int[B, S] -> (last-token logits f32[B, V], cache)."""
        return prefill(self.params, self.cfg, self._tokens(tokens), max_seq,
                       **self._extra(frames, patches))

    @torch.inference_mode()
    def decode_step(self, token, cache: dict):
        """int[B] -> (logits f32[B, V], cache updated in place)."""
        return decode_step(self.params, self.cfg, self._tokens(token), cache)
