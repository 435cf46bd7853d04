"""Model assembly for the dense decoder: spec trees, layer loops, KV caches.

Port of the dense "uniform" plan of ``repro.models.transformer``: n
identical decoder layers (attention + MLP), their weights stacked on a
leading 'layers' axis under the reference's key paths.  ``lax.scan`` over
the stack becomes a Python loop over that axis.  The functions take the
parameter tree (nested dicts of tensors) as the reference's do;
``TransformerLM`` is the ``nn.Module`` that owns a tree and runs them under
``torch.inference_mode()``.

The other families raise ``NotImplementedError`` where they branch off,
naming their ROADMAP item: MLA, SSM, MoE, cross-attention, the encoder
(whisper), vision and multi-token prediction (all ROADMAP A.10).  Forward
passes return no MoE auxiliary loss: a dense model has none.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, materialize


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP A.10)")


# ---------------------------------------------------------------------------
# spec utilities
# ---------------------------------------------------------------------------

def stack_specs(tree, n: int):
    if isinstance(tree, dict):
        return {k: stack_specs(v, n) for k, v in tree.items()}
    return ParamSpec((n,) + tree.shape, ("layers",) + tree.axes, tree.init, tree.scale)


def _layer_specs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    if mixer != "attn":
        raise _not_ported(f"the {mixer!r} mixer")
    out = {"mixer_norm": layers.norm_specs(cfg), "mixer": layers.attention_specs(cfg)}
    if ffn == "mlp":
        out["ffn_norm"] = layers.norm_specs(cfg)
        out["ffn"] = layers.mlp_specs(cfg)
    elif ffn != "none":
        raise _not_ported(f"the {ffn!r} feed-forward")
    return out


def _layer_fwd(p, cfg, x, positions, mixer, ffn, *, window=0):
    """Residual decoder layer, full-sequence."""
    if mixer != "attn":
        raise _not_ported(f"the {mixer!r} mixer")
    h = layers.norm_fwd(p["mixer_norm"], cfg, x)
    x = x + layers.attention_fwd(p["mixer"], cfg, h, positions, causal=True, window=window)
    if ffn != "none":
        h = layers.norm_fwd(p["ffn_norm"], cfg, x)
        x = x + layers.mlp_fwd(p["ffn"], cfg, h)
    return x


def _layer_decode(p, cfg, x, cache, mixer, ffn, *, window=0):
    """Residual decoder layer, one token, with cache (updated in place)."""
    if mixer != "attn":
        raise _not_ported(f"the {mixer!r} mixer")
    h = layers.norm_fwd(p["mixer_norm"], cfg, x)
    h, cache = layers.attention_decode(p["mixer"], cfg, h, cache, window=window)
    x = x + h
    if ffn != "none":
        h = layers.norm_fwd(p["ffn_norm"], cfg, x)
        x = x + layers.mlp_fwd(p["ffn"], cfg, h)
    return x, cache


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
    for family, present in (("the encoder (whisper)", cfg.encoder is not None),
                            ("vision cross-attention", cfg.vision is not None),
                            ("multi-token prediction", cfg.mtp_depth > 0)):
        if present:
            raise _not_ported(family)
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
    return out


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"].to(torch.bfloat16)[tokens]


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head.to(x.dtype)).float()


# ---------------------------------------------------------------------------
# forward (scoring)
# ---------------------------------------------------------------------------

def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward WITHOUT the LM head.

    tokens: int[B, S] -> hidden bf16[B, S, D] after the final norm.
    """
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, tokens)
    for plan in group_plans(cfg):
        for li in range(plan.n):
            lp = _index(params[plan.name], li)
            for i, (mixer, ffn) in enumerate(plan.sublayers):
                window = cfg.sliding_window if mixer == "attn" else 0
                x = _layer_fwd(lp[f"s{i}"], cfg, x, positions, mixer, ffn, window=window)
    return layers.norm_fwd(params["final_norm"], cfg, x)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. tokens: int[B, S] -> logits f32[B, S, V]."""
    return _logits(params, cfg, forward_hidden(params, cfg, tokens))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """{plan name: {'s<i>': {'k','v': [n, B, slots, Kv, D], 'pos': [n, B],
    'slot_pos': [n, B, slots]}}} — the reference's cache tree."""
    cache: dict[str, Any] = {}
    for plan in group_plans(cfg):
        sub = {}
        for i, (mixer, _f) in enumerate(plan.sublayers):
            if mixer != "attn":
                raise _not_ported(f"the {mixer!r} cache")
            one = layers.init_attn_cache(cfg, batch, max_seq, cfg.sliding_window, dtype, device)
            sub[f"s{i}"] = {k: t.expand(plan.n, *t.shape).clone() for k, t in one.items()}
        cache[plan.name] = sub
    return cache


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """One decode step: next-token logits f32[B, V] + the cache, updated in
    place."""
    x = _embed(params, token)[:, None, :]
    for plan in group_plans(cfg):
        for li in range(plan.n):
            lp = _index(params[plan.name], li)
            lc = _index(cache[plan.name], li)
            for i, (mixer, ffn) in enumerate(plan.sublayers):
                window = cfg.sliding_window if mixer == "attn" else 0
                x, _ = _layer_decode(lp[f"s{i}"], cfg, x, lc[f"s{i}"], mixer, ffn, window=window)
    x = layers.norm_fwd(params["final_norm"], cfg, x)
    return _logits(params, cfg, x[:, 0]), cache


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, max_seq: int):
    """Run the prompt, build the cache. Returns (last-token logits f32[B, V],
    cache).

    Full-sequence forward + cache writeback, as in the reference: each
    attention layer recomputes its K/V into the cache.  A sliding-window
    layer whose ring of ``window`` slots is shorter than the prompt keeps
    the last ``window`` positions, each at slot ``pos % window``.
    """
    b, s = tokens.shape
    if cfg.sliding_window == 0 and s > max_seq:
        raise ValueError(f"prompt length {s} exceeds max_seq {max_seq}")
    dev = tokens.device
    positions = torch.arange(s, device=dev)
    x = _embed(params, tokens)
    cache = init_cache(cfg, b, max_seq, device=dev)
    for plan in group_plans(cfg):
        for li in range(plan.n):
            lp = _index(params[plan.name], li)
            for i, (mixer, ffn) in enumerate(plan.sublayers):
                if mixer != "attn":
                    raise _not_ported(f"the {mixer!r} mixer")
                window = cfg.sliding_window
                spec = lp[f"s{i}"]
                hh = layers.norm_fwd(spec["mixer_norm"], cfg, x)
                _q, k, v = layers._project_qkv(spec["mixer"], cfg, hh)
                k = layers.rope(k, positions, cfg.rope_theta)
                c = cache[plan.name][f"s{i}"]
                slots = c["k"].shape[2]
                if window > 0 and slots < s:
                    kept = torch.arange(s - slots, s, device=dev)
                    order = torch.argsort(kept % slots)  # ring layout: slot = pos % slots
                    c["k"][li] = k[:, s - slots :][:, order]
                    c["v"][li] = v[:, s - slots :][:, order]
                    c["slot_pos"][li] = kept[order].to(torch.int32)[None]
                else:
                    c["k"][li, :, :s] = k
                    c["v"][li, :, :s] = v
                    c["slot_pos"][li, :, :s] = positions.to(torch.int32)[None]
                c["pos"][li] = s
                x = _layer_fwd(spec, cfg, x, positions, mixer, ffn, window=window)
    x = layers.norm_fwd(params["final_norm"], cfg, x)
    return _logits(params, cfg, x[:, -1]), cache


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
    """A dense decoder LM that owns its parameter tree (the reference's key
    paths, e.g. ``layers.s0.mixer.wq`` with a leading layer axis).

    Build it from a tree (``params.materialize`` or ``params.from_reference``)
    or with ``TransformerLM.init(cfg, seed, device=...)``.  ``forward``,
    ``prefill`` and ``decode_step`` take token ids (tensors or arrays) and
    run under ``torch.inference_mode()`` on the parameters' device.
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

    @torch.inference_mode()
    def forward(self, tokens) -> torch.Tensor:
        """int[B, S] -> logits f32[B, S, V]."""
        return forward(self.params, self.cfg, self._tokens(tokens))

    @torch.inference_mode()
    def prefill(self, tokens, max_seq: int):
        """int[B, S] -> (last-token logits f32[B, V], cache)."""
        return prefill(self.params, self.cfg, self._tokens(tokens), max_seq)

    @torch.inference_mode()
    def decode_step(self, token, cache: dict):
        """int[B] -> (logits f32[B, V], cache updated in place)."""
        return decode_step(self.params, self.cfg, self._tokens(token), cache)
