"""Multi-head Latent Attention (DeepSeek-V2/V3): port of ``repro.models.mla``.

Queries and KV are projected through low-rank latents; the KV cache stores
only the compressed latent ``c_kv`` (kv_lora_rank) plus the shared RoPE key
(qk_rope_head_dim) per token.

Prefill runs kernel B.6 (``kernels.flash_kernel.flash_attention``) at
d = qk_nope + qk_rope and dv = v_head_dim (192 and 128 at deepseek-v3's
widths).  Two decode paths, as in the reference:
  * naive  — decompress the whole cache to per-head K/V each step;
  * absorb — fold the decompression matrices into the query and output
             projections, so attention runs in latent space.
Both keep the scores, the softmax and P·V in float32, as the port's dense
decode does (``models/layers.py``); the reference rounds scores and
probabilities to bf16.  The cache is updated in place.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_kernel
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec
from repro_torch.train import sharding


def mla_specs(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    return {
        "wdq": ParamSpec((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_norm": ParamSpec((m.q_lora_rank,), ("q_lora",), init="ones"),
        "wuq": ParamSpec((m.q_lora_rank, h, dn + dr), ("q_lora", "heads", "head_dim")),
        "wdkv": ParamSpec((d, m.kv_lora_rank + dr), ("embed", "kv_lora")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("kv_lora",), init="ones"),
        "wuk": ParamSpec((m.kv_lora_rank, h, dn), ("kv_lora", "heads", "head_dim")),
        "wuv": ParamSpec((m.kv_lora_rank, h, dv), ("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((h, dv, d), ("heads", "head_dim", "embed")),
    }


def _latents(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Compressed latents of tokens x: (q [B, S, H, dn + dr], c_kv [B, S,
    r], k_rope [B, S, dr])."""
    m = cfg.mla
    dn = m.qk_nope_head_dim
    cq = layers.rms_norm_simple(x @ p["wdq"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = layers._proj(cq, p["wuq"])
    qn, qr = q[..., :dn], q[..., dn:]
    qr = layers.rope(qr, positions, cfg.rope_theta)
    return (torch.cat([qn, qr], dim=-1),) + kv_latents(p, cfg, x, positions)


def kv_latents(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """The cached latents of tokens x: (c_kv [B, S, r], k_rope [B, S,
    dr]) — what prefill writes to the cache, without the queries."""
    m = cfg.mla
    ckv_full = x @ p["wdkv"].to(x.dtype)
    ckv = layers.rms_norm_simple(ckv_full[..., : m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    kr = ckv_full[..., m.kv_lora_rank :][:, :, None, :]  # [B, S, 1, dr]
    kr = layers.rope(kr, positions, cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _keys(p: dict, cfg: ModelConfig, ckv: torch.Tensor, kr: torch.Tensor):
    """Per-head K [B, T, H, dn + dr] and V [B, T, H, dv] from the latents."""
    kn = layers._proj(ckv, p["wuk"])
    v = layers._proj(ckv, p["wuv"])
    k = torch.cat([kn, kr[:, :, None, :].expand(*kn.shape[:3], kr.shape[-1])], dim=-1)
    return k, v


_WHOLE = ("wdq", "q_norm", "wdkv", "kv_norm")  # replicated over 'model' (q_lora / kv_lora: no rule)


def _split(p: dict, cfg: ModelConfig) -> bool:
    """True when this rank holds a slice of the heads (``wuq`` / ``wuk`` /
    ``wuv`` column-parallel, ``wo`` row-parallel) under a model axis > 1."""
    return layers.model_parallel() is not None and p["wuq"].shape[1] < cfg.n_heads


def mla_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal MLA (prefill / scoring), through kernel B.6.

    Over a model axis that splits the heads, the latents are computed whole
    on every model rank (their weights replicated, entered through
    ``copy_to`` so their gradients sum over the ranks), the per-head
    decompression and B.6 run on this rank's heads, and the row-parallel
    ``wo`` ends in the model all-reduce (under sequence parallelism: the
    positions gathered in, reduce-scattered out, ``layers.region_in`` /
    ``region_out``)."""
    tp = _split(p, cfg)
    x = layers.region_in(x, tp)
    if tp:
        p = {n: layers.region_weight(w) if n in _WHOLE else w for n, w in p.items()}
    q, ckv, kr = _latents(p, cfg, x, positions)
    k, v = _keys(p, cfg, ckv, kr)
    out = flash_kernel.flash_attention(q, k, v, causal=True)
    return layers.region_out(layers._out_proj(out, p["wo"]), tp)


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               absorb: bool = True, slot_axes: tuple = ()) -> tuple[torch.Tensor, dict]:
    """Single-token decode. cache: {'ckv': [B, S, r], 'kr': [B, S, dr],
    'pos': [B]}, updated in place and returned.

    Over the activation mesh the query heads are this rank's and the cache
    its shard.  With its slots split (``slot_axes``: the reference places
    the latents' slots over 'model') the rank that owns the new token's
    slot writes it, every query head is scored against this rank's slots
    and the partial softmaxes are merged over ``slot_axes``
    (``layers.merge_softmax``) before the result is cut to this rank's heads
    for the row-parallel ``wo``.  Scoring every head needs, when the heads
    are split, every head's query gathered over 'model' — on the absorbed
    path its latent query [B, 1, H, r] and rope part, on the naive path the
    query and ``wuk`` / ``wuv`` whole (the naive path decompresses every
    head's K/V for its slots)."""
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    mesh = layers._ACT_MESH
    tp = _split(p, cfg)
    pos = cache["pos"]
    q, ckv1, kr1 = _latents(p, cfg, x, pos[:, None])  # q: [B, 1, H', dn + dr]
    layers._owned_write(cache["ckv"], pos, ckv1[:, 0], slot_axes)
    layers._owned_write(cache["kr"], pos, kr1[:, 0], slot_axes)
    ckv, kr = cache["ckv"], cache["kr"]
    slots = ckv.shape[1]
    off = mesh.axis_index(slot_axes) * slots if slot_axes else 0
    valid = torch.arange(off, off + slots, device=x.device)[None, :] <= pos[:, None]  # [B, S']
    every = tp and slot_axes and mesh.axis_size(slot_axes) > 1  # score every head here
    gather = (lambda t, dim: sharding.all_gather(t, mesh, layers._ACT_MODEL_AXIS, dim)) if every else (
        lambda t, dim: t)
    hl = q.shape[-2]
    lo = mesh.axis_index(layers._ACT_MODEL_AXIS) * hl if every else 0
    scale = 1.0 / math.sqrt(dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]

    if absorb:
        # fold W_uk into the query: score = (qn W_uk^T) · ckv + qr · kr
        q_lat = gather(torch.einsum("bshk,rhk->bshr", qn, p["wuk"].to(x.dtype)), 2)
        sc = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
              + torch.einsum("bshk,btk->bhst", gather(qr, 2).float(), kr.float())) * scale
        # attend in latent space, then decompress once per step
        lat = layers.merge_softmax(sc, valid, slot_axes, lambda w: torch.einsum("bhst,btr->bshr", w, ckv.float()))
        lat = lat[:, :, lo : lo + hl].to(x.dtype)  # [B, 1, H', r]
        out = torch.einsum("bshr,rhk->bshk", lat, p["wuv"].to(x.dtype))
    else:
        k, v = _keys({"wuk": gather(p["wuk"], 1), "wuv": gather(p["wuv"], 1)}, cfg, ckv, kr)
        sc = torch.einsum("bshd,bthd->bhst", gather(q, 2).float(), k.float()) * scale
        out = layers.merge_softmax(sc, valid, slot_axes, lambda w: torch.einsum("bhst,bthd->bshd", w, v.float()))
        out = out[:, :, lo : lo + hl].to(x.dtype)
    pos.add_(1)  # in place: the cache tensors may be views of a layer stack
    y = layers._out_proj(out, p["wo"])
    return (sharding.reduce_from(y, layers.model_parallel()) if tp else y), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    m = cfg.mla
    return {
        "ckv": torch.zeros(batch, max_seq, m.kv_lora_rank, dtype=dtype, device=device),
        "kr": torch.zeros(batch, max_seq, m.qk_rope_head_dim, dtype=dtype, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
    }
