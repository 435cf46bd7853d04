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
    ckv_full = x @ p["wdkv"].to(x.dtype)
    ckv = layers.rms_norm_simple(ckv_full[..., : m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    kr = ckv_full[..., m.kv_lora_rank :][:, :, None, :]  # [B, S, 1, dr]
    kr = layers.rope(kr, positions, cfg.rope_theta)[:, :, 0]
    return torch.cat([qn, qr], dim=-1), ckv, kr


def _keys(p: dict, cfg: ModelConfig, ckv: torch.Tensor, kr: torch.Tensor):
    """Per-head K [B, T, H, dn + dr] and V [B, T, H, dv] from the latents."""
    kn = layers._proj(ckv, p["wuk"])
    v = layers._proj(ckv, p["wuv"])
    k = torch.cat([kn, kr[:, :, None, :].expand(*kn.shape[:3], kr.shape[-1])], dim=-1)
    return k, v


def mla_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal MLA (prefill / scoring), through kernel B.6."""
    q, ckv, kr = _latents(p, cfg, x, positions)
    k, v = _keys(p, cfg, ckv, kr)
    out = flash_kernel.flash_attention(q, k, v, causal=True)
    return layers._out_proj(out, p["wo"])


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               absorb: bool = True) -> tuple[torch.Tensor, dict]:
    """Single-token decode. cache: {'ckv': [B, S, r], 'kr': [B, S, dr],
    'pos': [B]}, updated in place and returned."""
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    pos = cache["pos"]
    q, ckv1, kr1 = _latents(p, cfg, x, pos[:, None])  # q: [B, 1, H, dn + dr]
    layers._cache_write(cache["ckv"], pos, ckv1[:, 0])
    layers._cache_write(cache["kr"], pos, kr1[:, 0])
    ckv, kr = cache["ckv"], cache["kr"]
    slots = ckv.shape[1]
    valid = torch.arange(slots, device=x.device)[None, :] <= pos[:, None]  # [B, S]
    scale = 1.0 / math.sqrt(dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]

    if absorb:
        # fold W_uk into the query: score = (qn W_uk^T) · ckv + qr · kr
        q_lat = torch.einsum("bshk,rhk->bshr", qn, p["wuk"].to(x.dtype))
        sc = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
              + torch.einsum("bshk,btk->bhst", qr.float(), kr.float())) * scale
        sc = sc + torch.where(valid, 0.0, layers.NEG_INF)[:, None, None, :]
        probs = torch.softmax(sc, dim=-1)
        # attend in latent space, then decompress once per step
        lat = torch.einsum("bhst,btr->bshr", probs, ckv.float()).to(x.dtype)  # [B, 1, H, r]
        out = torch.einsum("bshr,rhk->bshk", lat, p["wuv"].to(x.dtype))
    else:
        k, v = _keys(p, cfg, ckv, kr)
        sc = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
        sc = sc + torch.where(valid, 0.0, layers.NEG_INF)[:, None, None, :]
        probs = torch.softmax(sc, dim=-1)
        out = torch.einsum("bhst,bthd->bshd", probs, v.float()).to(x.dtype)
    pos.add_(1)  # in place: the cache tensors may be views of a layer stack
    return layers._out_proj(out, p["wo"]), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    m = cfg.mla
    return {
        "ckv": torch.zeros(batch, max_seq, m.kv_lora_rank, dtype=dtype, device=device),
        "kr": torch.zeros(batch, max_seq, m.qk_rope_head_dim, dtype=dtype, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
    }
