"""Flash attention: the wrapper of the hand-written CUDA kernel, and its
backward.

``flash_attention`` computes causal / sliding-window softmax attention on
the reference's ``[B, S, H, d]`` layout.  On CUDA tensors it launches
``csrc/flash_attention.cu``, the port of the Pallas
``repro.kernels.flash_kernel.flash_attention`` — its tensor-core kernel for
bfloat16, its float32 FMA kernel for float32; on CPU tensors it runs the
plain PyTorch version below, and only there.  It counts its launches in
``flash_attention.launches``.

Training differentiates through it: when grad is enabled and an input
requires it, the call goes through ``_FlashAttention``, a
``torch.autograd.Function`` whose forward is that same launch (the plain
version on CPU tensors) and whose backward is ``flash_attention_backward``.
The Pallas kernel has no backward; the reference trains through XLA
attention (``layers._sdpa_flash``, whose backward is autodiff with the
scores recomputed per KV block under ``jax.checkpoint``).  So the backward
here is the counterpart of that autodiff, written as torch ops: the scores
and the softmax recomputed in float32 per block of queries, then dV = PᵀdO,
dS = P∘(dP − rowsum(P∘dP)), dQ = dS·K/√d, dK = dSᵀ·Q/√d.  It is not the
plain version of a kernel.

Semantics (the Pallas kernel's): query ``i`` may attend to key ``j`` iff
``j < T``, ``i - j >= 0`` when causal, and ``i - j < window`` when
``window > 0``; scores are ``q·k / sqrt(d)`` in float32, softmax in float32,
output ``acc / max(l, 1e-30)`` cast to the input dtype.  A query row with
no admissible key gets zeros (the Pallas kernel would average the masked
values there; the serving path never has such a row).

The launch and the backward are ``torch.library`` ops
(``repro_torch::flash_attention_fwd`` / ``_bwd``) with a shape rule each,
so a ``FakeTensorMode`` trace (the dry run) gets their output shapes and
never reaches ``_build.load`` or a pointer: a fake tensor gets a shape,
never the plain version.  Each carries the FLOP formula ``FlopCounterMode``
uses for SDPA (``sdpa_flop_count`` / ``sdpa_backward_flop_count``, a
causal mask not halving it), so a traced program's FLOPs do not depend on
which attention ran.
"""

from __future__ import annotations

import math

import torch
from torch.utils import flop_counter

from repro_torch.device import is_fake
from repro_torch.kernels import _build

MAX_HEAD_DIM = 192  # d: MLA's qk_nope + qk_rope at full width
MAX_VALUE_DIM = 128  # dv
# score elements (B·H·rows·T) per plain-version step
_PLAIN_ELEMS = 1 << 26


def _admissible(s: int, t: int, causal: bool, window: int, device, q0: int = 0,
                k0: int = 0) -> torch.Tensor:
    """bool[s, t] mask of admissible (query q0 + i, key k0 + j) pairs."""
    diff = (torch.arange(q0, q0 + s, device=device)[:, None]
            - torch.arange(k0, k0 + t, device=device)[None, :])
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    return ok


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype: float32, or float64 for float64 inputs (the
    CPU's ``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def _probs(qf, kf, scale, ok):
    """Masked softmax of q·k·scale over the keys: qf [B, H, rows, d], kf [B,
    H, d, T], ok [rows, T] -> (P [B, H, rows, T], its row sums before
    normalising); a row with no admissible key is all zeros.  The masked
    scores are -inf before the exponential, so autograd through this
    (``flash_attention_plain`` as a yardstick) never multiplies a zero
    gradient by a masked score's overflowed exp."""
    sc = (torch.matmul(qf, kf) * scale).masked_fill(~ok, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(sc - m)
    return p, p.sum(dim=-1, keepdim=True)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of ``flash_attention``: masked softmax attention in
    float32, blocked over the query axis so long sequences fit."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    acc = _acc(q.dtype)
    out = torch.empty(b, s, h, v.shape[3], dtype=q.dtype, device=q.device)
    kf = k.to(acc).permute(0, 2, 3, 1)  # [B, H, d, T]
    vf = v.to(acc).transpose(1, 2)  # [B, H, T, dv]
    step = max(1, _PLAIN_ELEMS // max(b * h * t, 1))
    for q0 in range(0, s, step):
        qf = q[:, q0 : q0 + step].to(acc).transpose(1, 2)  # [B, H, rows, d]
        p, l = _probs(qf, kf, scale, _admissible(qf.shape[2], t, causal, window, q.device, q0))
        o = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)
        out[:, q0 : q0 + step] = o.transpose(1, 2).to(q.dtype)
    return out


def _key_span(q0: int, rows: int, t: int, causal: bool, window: int) -> tuple[int, int]:
    """[lo, hi): the keys that queries q0 .. q0 + rows - 1 may admit."""
    lo = max(0, q0 - window + 1) if window > 0 else 0
    hi = min(t, q0 + rows) if causal else t
    return lo, max(lo, hi)


def flash_attention_backward(q, k, v, dout, *, causal: bool = True, window: int = 0):
    """Gradients of ``flash_attention`` (dq, dk, dv) for the output
    gradient ``dout`` [B, S, H, dv], each in its input's dtype (the op
    ``repro_torch::flash_attention_bwd``, whose body is ``_backward``)."""
    return tuple(torch.ops.repro_torch.flash_attention_bwd(q, k, v, dout, causal, window))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, Tensor dout, bool causal, int window)"
                                " -> (Tensor, Tensor, Tensor)")
def _backward(q, k, v, dout, causal, window):
    """The backward's body.

    Blocked over the query axis with the plain version's budget; per block
    the scores and the softmax are recomputed in float32 under the
    forward's mask, over the keys the block may admit only, and
    dV += PᵀdO, dS = P∘(dP − rowsum(P∘dP)) with dP = dO·Vᵀ, dQ = dS·K/√d,
    dK += dSᵀ·Q/√d.  Torch ops: the counterpart of the reference's XLA
    autodiff (module docstring), on CPU and CUDA tensors alike."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    acc = _acc(q.dtype)
    kf = k.to(acc).transpose(1, 2)  # [B, H, T, d]
    vf = v.to(acc).transpose(1, 2)  # [B, H, T, dv]
    dq = torch.zeros(b, s, h, d, dtype=q.dtype, device=q.device)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    step = max(1, _PLAIN_ELEMS // max(b * h * t, 1))
    for q0 in range(0, s, step):
        rows = min(step, s - q0)
        lo, hi = _key_span(q0, rows, t, causal, window)
        if hi == lo:  # no admissible key: the output rows are zeros
            continue
        qf = q[:, q0 : q0 + rows].to(acc).transpose(1, 2)  # [B, H, rows, d]
        do = dout[:, q0 : q0 + rows].to(acc).transpose(1, 2)  # [B, H, rows, dv]
        kb, vb = kf[:, :, lo:hi], vf[:, :, lo:hi]
        ok = _admissible(rows, hi - lo, causal, window, q.device, q0, lo)
        p, l = _probs(qf, kb.transpose(2, 3), scale, ok)
        p = p / torch.clamp(l, min=1e-30)
        dv[:, :, lo:hi] += torch.matmul(p.transpose(2, 3), do)
        dp = torch.matmul(do, vb.transpose(2, 3))  # [B, H, rows, T']
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        dq[:, q0 : q0 + rows] = (torch.matmul(ds, kb) * scale).transpose(1, 2).to(q.dtype)
        dk[:, :, lo:hi] += torch.matmul(ds.transpose(2, 3), qf) * scale
    return dq, dk.transpose(1, 2).to(k.dtype).contiguous(), dv.transpose(1, 2).to(v.dtype).contiguous()


@_backward.register_fake
def _(q, k, v, dout, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _bhsd(shape) -> tuple:
    """[B, S, H, d] -> the [B, H, S, d] order of the SDPA formulas."""
    b, s, h, d = shape
    return (b, h, s, d)


@flop_counter.register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _backward_flops(q_shape, k_shape, v_shape, dout_shape, *args, **kwargs) -> int:
    return flop_counter.sdpa_backward_flop_count(_bhsd(dout_shape), _bhsd(q_shape), _bhsd(k_shape),
                                                 _bhsd(v_shape))


def _pad8(x: torch.Tensor) -> torch.Tensor:
    """``x`` zero-padded along its last dim to a multiple of 8 elements, so
    that a contiguous ``x``'s strides are multiples of 16 bytes (the tensor
    maps' rule); ``x`` itself when it is one.  The bf16 kernel pads the
    rest of the way to its tile widths itself: its tensor maps read the
    elements past d (dv) as zeros."""
    pad = -x.shape[3] % 8
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _strides(x: torch.Tensor, bf16: bool) -> tuple[int, int, int]:
    """Element strides of dims 0-2 of ``x`` for the kernel.  The bf16
    kernel reads through a tensor map: its base and every stride in bytes
    must be a multiple of 16.  A dim of extent 1 is never stepped, so its
    stride is set to 8 elements."""
    if not bf16:
        return x.stride(0), x.stride(1), x.stride(2)
    strides = tuple(x.stride(i) if x.shape[i] > 1 else 8 for i in range(3))
    if x.data_ptr() % 16 or any(st % 8 for st in strides):
        raise ValueError(
            "bf16 flash_attention reads through tensor maps: base pointers and the strides of"
            f" dims longer than 1 must be multiples of 16 bytes, got strides {x.stride()}"
        )
    return strides


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Blocked online-softmax attention forward; differentiable (through
    ``_FlashAttention``) when grad is enabled and an input requires it.

    Args:
      q: [B, S, H, d]; k: [B, T, H, d]; v: [B, T, H, dv] — float32 or
         bfloat16, one dtype, heads already repeated to full count; the last
         dim must be contiguous (other strides are free), d <= 192, dv <=
         128.  On CUDA in bfloat16 (the tensor-core kernel, whose tiles are
         copied through tensor maps) a d or dv that is not a multiple of 8
         is zero-padded to one (q·k is unchanged, the scale stays
         1/sqrt(d) of the unpadded d, and the output is sliced back), and
         the base pointers and the strides of dims longer than 1 must be
         multiples of 16 bytes: q, k and v may be strided views of one
         fused projection.
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
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """The forward: the kernel's launch on CUDA tensors, its shape rule on
    fake tensors, the plain version on (real) CPU tensors."""
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[3]
    fake = is_fake(q)
    if q.device.type == "cpu" and not fake:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is {q.dtype} on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_VALUE_DIM):
        raise ValueError(
            f"head dims d={d}, dv={dv} outside [1, {MAX_HEAD_DIM}] x [1, {MAX_VALUE_DIM}]"
        )
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the last dim of q, k and v must be contiguous")
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, window)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(), device_types="cuda",
                         schema="(Tensor q, Tensor k, Tensor v, bool causal, int window) -> Tensor")
def _launch(q, k, v, causal, window):
    """The kernel's launch (``_forward`` checked the inputs)."""
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[3]
    if b * s * h == 0 or t == 0:
        return torch.zeros(b, s, h, dv, dtype=q.dtype, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = _pad8(q), _pad8(k), _pad8(v)
    strides = [_strides(x, bf16) for x in (q, k, v)]
    out = torch.empty(b, s, h, v.shape[3], dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, s, t, q.shape[3], v.shape[3], d, *strides[0], *strides[1], *strides[2],
        int(causal), window, int(bf16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out if out.shape[3] == dv else out[..., :dv].contiguous()


@_launch.register_fake
def _(q, k, v, causal, window):
    return q.new_empty(q.shape[:3] + v.shape[3:])


@flop_counter.register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _forward_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return flop_counter.sdpa_flop_count(_bhsd(q_shape), _bhsd(k_shape), _bhsd(v_shape))


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward's launch (plain
    version on CPU tensors), q, k and v saved as passed in, and
    ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
