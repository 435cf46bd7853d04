"""Flash attention (forward): the wrapper of the hand-written CUDA kernel.

``flash_attention`` computes causal / sliding-window softmax attention on
the reference's ``[B, S, H, d]`` layout.  On CUDA tensors it launches
``csrc/flash_attention.cu``, the port of the Pallas
``repro.kernels.flash_kernel.flash_attention`` — its tensor-core kernel for
bfloat16, its float32 FMA kernel for float32; on CPU tensors it runs the
plain PyTorch version below, and only there.  It counts its launches in
``flash_attention.launches``.

Semantics (the Pallas kernel's): query ``i`` may attend to key ``j`` iff
``j < T``, ``i - j >= 0`` when causal, and ``i - j < window`` when
``window > 0``; scores are ``q·k / sqrt(d)`` in float32, softmax in float32,
output ``acc / max(l, 1e-30)`` cast to the input dtype.  A query row with
no admissible key gets zeros (the Pallas kernel would average the masked
values there; the serving path never has such a row).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128
# score elements (B·H·rows·T) per plain-version step
_PLAIN_ELEMS = 1 << 26


def _admissible(s: int, t: int, causal: bool, window: int, device, q0: int = 0) -> torch.Tensor:
    """bool[s, t] mask of admissible (query q0 + i, key j) pairs."""
    diff = (torch.arange(q0, q0 + s, device=device)[:, None]
            - torch.arange(t, device=device)[None, :])
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    return ok


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of ``flash_attention``: masked softmax attention in
    float32, blocked over the query axis so long sequences fit."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    out = torch.empty(b, s, h, v.shape[3], dtype=q.dtype, device=q.device)
    kf = k.float().permute(0, 2, 3, 1)  # [B, H, d, T]
    vf = v.float().transpose(1, 2)  # [B, H, T, dv]
    step = max(1, _PLAIN_ELEMS // max(b * h * t, 1))
    for q0 in range(0, s, step):
        qf = q[:, q0 : q0 + step].float().transpose(1, 2)  # [B, H, rows, d]
        sc = torch.matmul(qf, kf) * scale  # [B, H, rows, T]
        ok = _admissible(qf.shape[2], t, causal, window, q.device, q0)
        m = sc.masked_fill(~ok, float("-inf")).amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.where(ok, torch.exp(sc - m), torch.zeros_like(sc))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)
        out[:, q0 : q0 + step] = o.transpose(1, 2).to(q.dtype)
    return out


def _strides(x: torch.Tensor, bf16: bool) -> tuple[int, int, int]:
    """Element strides of dims 0-2 of ``x`` for the kernel.  The bf16
    kernel reads through a tensor map: its base and every stride in bytes
    must be a multiple of 16, and ``d`` (``x.shape[3]``) a multiple of 16.
    A dim of extent 1 is never stepped, so its stride is set to 8 elements."""
    if not bf16:
        return x.stride(0), x.stride(1), x.stride(2)
    if x.shape[3] % 16:
        raise ValueError(f"bf16 flash_attention takes head dims that are multiples of 16, got {x.shape[3]}")
    strides = tuple(x.stride(i) if x.shape[i] > 1 else 8 for i in range(3))
    if x.data_ptr() % 16 or any(st % 8 for st in strides):
        raise ValueError(
            "bf16 flash_attention reads through tensor maps: base pointers and the strides of"
            f" dims longer than 1 must be multiples of 16 bytes, got strides {x.stride()}"
        )
    return strides


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Blocked online-softmax attention forward.

    Args:
      q: [B, S, H, d]; k: [B, T, H, d]; v: [B, T, H, dv] — float32 or
         bfloat16, one dtype, heads already repeated to full count; the last
         dim must be contiguous (other strides are free), d, dv <= 128.
         On CUDA in bfloat16 (the tensor-core kernel, whose tiles are
         copied through tensor maps) d and dv must be multiples of 16, and
         the base pointers and the strides of dims longer than 1 multiples
         of 16 bytes: q, k and v may be strided views of one fused
         projection.
    Returns:
      [B, S, H, dv] in the inputs' dtype, contiguous.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, d] / [B, T, H, d] / [B, T, H, dv]")
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[3]
    if k.shape != (b, t, h, d) or v.shape[:3] != (b, t, h):
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is {q.dtype} on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims d={d}, dv={dv} outside [1, {MAX_HEAD_DIM}]")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the last dim of q, k and v must be contiguous")
    bf16 = q.dtype == torch.bfloat16
    strides = [_strides(x, bf16) for x in (q, k, v)]
    out = torch.empty(b, s, h, dv, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if t == 0:
        return out.zero_()
    lib = _build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, s, t, d, dv, *strides[0], *strides[1], *strides[2],
        int(causal), window, int(bf16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
