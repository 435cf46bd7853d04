"""Core layers of the dense decoder: norms, RoPE, attention, MLP.

Port of the dense half of ``repro.models.layers``.  Conventions are the
reference's:
  * activations bf16, softmax/norm statistics f32;
  * attention is computed with KV heads repeated to full heads; the KV
    *cache* stores only ``n_kv_heads``;
  * decode uses a position-indexed cache update; sliding-window layers use a
    ring buffer of ``window`` slots.

Full-sequence self-attention (training / prefill) goes through
``kernels.ops.flash_attention`` at every length: on CUDA tensors that is the
hand-written kernel B.6, on CPU tensors its plain version.  Single-token
decode attention stays plain PyTorch, as the reference computes it outside
any Pallas kernel, but with the kernel's numerics: scores and P·V in
float32.  The reference's decode rounds scores and probabilities to bf16;
beside the kernel's float32 prefill that alone parts decode from the full
forward by 0.058 of max|logit| at one layer of full-width qwen1.5-0.5b on
an H100, past the 0.05 the reference's consistency test allows.  The
decode cache is updated in place (the reference returns a new cache),
which saves a copy of the whole cache per step.
The reference's activation-sharding constraints are no-ops without a mesh
and are left out; cross-attention waits for the encoder-decoder and vision
families (ROADMAP A.10).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


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

def attention_specs(cfg: ModelConfig) -> dict:
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


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm_simple(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm_simple(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


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
) -> torch.Tensor:
    """Full-sequence causal self-attention (prefill / scoring).

    x: [B, S, D]; positions: [S] int.  The flash kernel masks by query and
    key INDEX (the reference's ``_mask_bias`` rule, kept in
    ``kernels.flash_kernel``), which equals the position here: the dense
    path always uses ``positions = arange(S)``, as the reference does.
    """
    q, k, v = _project_qkv(p, cfg, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    k = repeat_kv(k, cfg.n_heads)
    v = repeat_kv(v, cfg.n_heads)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return _out_proj(out, p["wo"])


def _cache_write(buf: torch.Tensor, slot: torch.Tensor, val: torch.Tensor) -> None:
    """buf: [B, slots, ...]; slot: [B]; val: [B, ...] — row written in place."""
    buf[torch.arange(buf.shape[0], device=buf.device), slot] = val


def attention_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache: dict,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, dict]:
    """Single-token decode with KV cache (updated in place and returned).

    x: [B, 1, D].  cache: {'k','v': [B, S_slots, Kv, D], 'pos': [B] (next
    position), 'slot_pos': [B, S_slots]}.  Full-attention layers use
    S_slots = max_seq; SWA layers use a ring buffer with S_slots = window.
    """
    pos = cache["pos"]  # [B]
    q, k, v = _project_qkv(p, cfg, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)

    slots = cache["k"].shape[1]
    slot = pos % slots if window > 0 else pos.clamp(max=slots - 1)
    _cache_write(cache["k"], slot, k[:, 0])
    _cache_write(cache["v"], slot, v[:, 0])
    cpos = cache["slot_pos"]
    _cache_write(cpos, slot, pos)

    kk = repeat_kv(cache["k"], cfg.n_heads)
    vv = repeat_kv(cache["v"], cfg.n_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kk.float()) * scale
    diff = pos[:, None] - cpos  # [B, slots]
    ok = (diff >= 0) & (cpos >= 0)  # cpos < 0 marks never-written slots
    if window > 0:
        ok &= diff < window
    scores = scores + torch.where(ok, 0.0, NEG_INF)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vv.float()).to(x.dtype)
    pos.add_(1)  # in place: the cache tensors may be views of a layer stack
    return _out_proj(out, p["wo"]), cache


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


def mlp_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.glu:
        h = _act(cfg, x @ p["wi_gate"].to(x.dtype)) * (x @ p["wi_up"].to(x.dtype))
    else:
        h = _act(cfg, x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
