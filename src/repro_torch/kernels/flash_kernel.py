"""Flash attention: the wrappers of the hand-written CUDA kernels, forward
and backward.

``flash_attention`` computes causal / sliding-window softmax attention on
the reference's ``[B, S, H, d]`` layout.  On CUDA tensors it launches
``csrc/flash_attention.cu``, the port of the Pallas
``repro.kernels.flash_kernel.flash_attention`` — its tensor-core kernel for
bfloat16, its float32 FMA kernel for float32; on CPU tensors it runs the
plain PyTorch version below, and only there.  It counts its launches in
``flash_attention.launches``.

Training differentiates through it: when grad is enabled and an input
requires it, the call goes through ``_FlashAttention``, a
``torch.autograd.Function`` whose forward is that same launch with each
row's log-sum-exp written beside the output (``lse``, float32 [B, H, S]),
and whose backward is ``flash_attention_backward`` on the saved q, k, v,
output and ``lse``.  The Pallas kernel has no backward; the reference
trains through XLA attention (``layers._sdpa_flash``, whose backward is
autodiff with the scores recomputed per KV block under ``jax.checkpoint``).
The backward here is that autodiff as hand-written kernels too
(``csrc/flash_attention_bwd.cu``, FA2's split): P = exp(q·kᵀ/√d − lse)
recomputed, Δ = rowsum(dO∘O), dV = PᵀdO, dS = P∘(dP − Δ), dQ = dS·K/√d,
dK = dSᵀ·Q/√d; a dK/dV pass over key tiles and a dQ pass over query tiles,
no atomics.  On CPU tensors it runs its plain version,
``flash_attention_backward_plain``, the same formulas as torch ops blocked
over the queries.  It counts its launches in
``flash_attention_backward.launches``, one a call.

Semantics (the Pallas kernel's): query ``i`` may attend to key ``j`` iff
``j < T``, ``i - j >= 0`` when causal, and ``i - j < window`` when
``window > 0``; scores are ``q·k / sqrt(d)`` in float32, softmax in float32,
output ``acc / max(l, 1e-30)`` cast to the input dtype.  A query row with
no admissible key gets zeros (the Pallas kernel would average the masked
values there; the serving path never has such a row).

The launches are ``torch.library`` ops (``repro_torch::flash_attention_fwd``,
``_fwd_lse`` under autograd, and ``_bwd``) with a shape rule each,
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


def _scores(qf, kf, scale, ok):
    """Masked scores q·k·scale: qf [B, H, rows, d], kf [B, H, d, T], ok
    [rows, T] -> [B, H, rows, T], -inf where not admissible."""
    return (torch.matmul(qf, kf) * scale).masked_fill(~ok, float("-inf"))


def _probs(qf, kf, scale, ok):
    """Masked softmax of q·k·scale over the keys -> (P [B, H, rows, T], its
    row sums before normalising, its row max); a row with no admissible key
    is all zeros, with max 0.  The masked scores are -inf before the
    exponential, so autograd through this (``flash_attention_plain`` as a
    yardstick) never multiplies a zero gradient by a masked score's
    overflowed exp."""
    sc = _scores(qf, kf, scale, ok)
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(sc - m)
    return p, p.sum(dim=-1, keepdim=True), m


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of ``flash_attention``: masked softmax attention in
    float32, blocked over the query axis so long sequences fit."""
    return flash_attention_plain_lse(q, k, v, causal=causal, window=window)[0]


def flash_attention_plain_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """``flash_attention_plain``'s output and each row's log-sum-exp of the
    scaled, masked scores (natural log; -inf for a row with no admissible
    key) as [B, H, S] in the accumulation dtype: the plain version of the
    forward under autograd."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    acc = _acc(q.dtype)
    out = torch.empty(b, s, h, v.shape[3], dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s, dtype=acc, device=q.device)
    kf = k.to(acc).permute(0, 2, 3, 1)  # [B, H, d, T]
    vf = v.to(acc).transpose(1, 2)  # [B, H, T, dv]
    step = max(1, _PLAIN_ELEMS // max(b * h * t, 1))
    for q0 in range(0, s, step):
        qf = q[:, q0 : q0 + step].to(acc).transpose(1, 2)  # [B, H, rows, d]
        p, l, m = _probs(qf, kf, scale, _admissible(qf.shape[2], t, causal, window, q.device, q0))
        o = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)
        out[:, q0 : q0 + step] = o.transpose(1, 2).to(q.dtype)
        lse[:, :, q0 : q0 + step] = (m + torch.log(l)).squeeze(-1).detach()
    return out, lse


def _key_span(q0: int, rows: int, t: int, causal: bool, window: int) -> tuple[int, int]:
    """[lo, hi): the keys that queries q0 .. q0 + rows - 1 may admit."""
    lo = max(0, q0 - window + 1) if window > 0 else 0
    hi = min(t, q0 + rows) if causal else t
    return lo, max(lo, hi)


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0):
    """Gradients of ``flash_attention`` (dq, dk, dv) for the output
    gradient ``dout`` [B, S, H, dv], given the forward's output ``out`` and
    its row log-sum-exp ``lse`` [B, H, S] (float32; what
    ``_FlashAttention`` saves), each gradient in its input's dtype: the op
    ``repro_torch::flash_attention_bwd``, whose body launches
    ``csrc/flash_attention_bwd.cu`` on CUDA tensors and runs
    ``flash_attention_backward_plain`` on CPU tensors."""
    return tuple(torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, dout, causal, window))


def flash_attention_backward_plain(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0):
    """Plain version of ``flash_attention_backward``: blocked over the query
    axis with the plain forward's budget; per block the scores are
    recomputed in float32 under the forward's mask, over the keys the block
    may admit only, P = exp(scores − lse) (0 on a row whose lse is -inf),
    and dV += PᵀdO, dS = P∘(dP − Δ) with dP = dO·Vᵀ and Δ = rowsum(dO∘O),
    dQ = dS·K/√d, dK += dSᵀ·Q/√d.  A block holds every key its rows admit,
    so P is renormalised over the row: that cancels the float32 rounding of
    a large lse (half an ulp of 2048 is 1.2e-4, which exp turns into the
    same relative error of the row's P; the kernels keep it)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    acc = _acc(q.dtype)
    kf = k.to(acc).transpose(1, 2)  # [B, H, T, d]
    vf = v.to(acc).transpose(1, 2)  # [B, H, T, dv]
    delta = (dout.to(acc) * out.to(acc)).sum(dim=-1).transpose(1, 2)  # [B, H, S]
    lse = lse.to(acc)
    lse = torch.where(lse == float("-inf"), torch.full_like(lse, float("inf")), lse)
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
        p = torch.exp(_scores(qf, kb.transpose(2, 3), scale, ok) - lse[:, :, q0 : q0 + rows, None])
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        dv[:, :, lo:hi] += torch.matmul(p.transpose(2, 3), do)
        dp = torch.matmul(do, vb.transpose(2, 3))  # [B, H, rows, T']
        ds = p * (dp - delta[:, :, q0 : q0 + rows, None])
        dq[:, q0 : q0 + rows] = (torch.matmul(ds, kb) * scale).transpose(1, 2).to(q.dtype)
        dk[:, :, lo:hi] += torch.matmul(ds.transpose(2, 3), qf) * scale
    return dq, dk.transpose(1, 2).to(k.dtype).contiguous(), dv.transpose(1, 2).to(v.dtype).contiguous()


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout,"
                                " bool causal, int window) -> (Tensor, Tensor, Tensor)")
def _backward(q, k, v, out, lse, dout, causal, window):
    """The backward's body: the kernels' launch on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout, causal=causal, window=window)
    _check(q, k, v)
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[3]
    if out.shape != (b, s, h, dv) or dout.shape != out.shape or lse.shape != (b, h, s):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, lse {tuple(lse.shape)}"
                         f" do not match q {tuple(q.shape)}, v {tuple(v.shape)}")
    if lse.dtype != torch.float32 or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"lse must be float32 and out, dout {q.dtype}: got {lse.dtype}, {out.dtype},"
                         f" {dout.dtype}")
    if b * s * h == 0 or t == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    bf16 = q.dtype == torch.bfloat16
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    if bf16:
        q, k, v, out, dout = (_pad8(x) for x in (q, k, v, out, dout))
    strides = [_strides(x, bf16) for x in (q, k, v)]
    s_pad = -(-s // 64) * 64
    scratch = torch.empty(2, b * h * s_pad, dtype=torch.float32, device=q.device)  # lse·log2(e), Δ
    dq = torch.empty(b, s, h, q.shape[3], dtype=q.dtype, device=q.device)
    dk = torch.empty(b, t, h, k.shape[3], dtype=q.dtype, device=q.device)
    dvv = torch.empty(b, t, h, v.shape[3], dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention_bwd")
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
        b, h, s, t, q.shape[3], v.shape[3], d, *strides[0], *strides[1], *strides[2],
        int(causal), window, int(bf16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention_backward")
    flash_attention_backward.launches += 1
    if q.shape[3] != d:
        dq, dk = dq[..., :d].contiguous(), dk[..., :d].contiguous()
    if dvv.shape[3] != dv:
        dvv = dvv[..., :dv].contiguous()
    return dq, dk, dvv


@_backward.register_fake
def _(q, k, v, out, lse, dout, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


flash_attention_backward.launches = 0


def _bhsd(shape) -> tuple:
    """[B, S, H, d] -> the [B, H, S, d] order of the SDPA formulas."""
    b, s, h, d = shape
    return (b, h, s, d)


@flop_counter.register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _backward_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, dout_shape, *args, **kwargs) -> int:
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


def _forward(q, k, v, causal: bool, window: int, with_lse: bool = False):
    """The forward: the kernel's launch on CUDA tensors, its shape rule on
    fake tensors, the plain version on (real) CPU tensors.  ``with_lse``:
    (out, lse), the residuals of the backward."""
    if q.device.type == "cpu" and not is_fake(q):
        if with_lse:
            return flash_attention_plain_lse(q, k, v, causal=causal, window=window)
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v)
    if with_lse:
        return tuple(torch.ops.repro_torch.flash_attention_fwd_lse(q, k, v, causal, window))
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, window)


def _check(q, k, v) -> None:
    """Raise on inputs the kernels do not take (CPU tensors never reach
    here)."""
    d, dv = q.shape[3], v.shape[3]
    if q.device.type != "cuda" and not is_fake(q):
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


def _launch_forward(q, k, v, causal: bool, window: int, with_lse: bool):
    """The forward kernel's launch (``_check`` passed): out, and with
    ``with_lse`` each row's log-sum-exp as float32 [B, H, S]."""
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[3]
    if b * s * h == 0 or t == 0:  # no row admits a key
        lse = torch.full((b, h, s), float("-inf"), device=q.device) if with_lse else None
        return torch.zeros(b, s, h, dv, dtype=q.dtype, device=q.device), lse
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device) if with_lse else None
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = _pad8(q), _pad8(k), _pad8(v)
    strides = [_strides(x, bf16) for x in (q, k, v)]
    out = torch.empty(b, s, h, v.shape[3], dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(lse),
        b, h, s, t, q.shape[3], v.shape[3], d, *strides[0], *strides[1], *strides[2],
        int(causal), window, int(bf16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out if out.shape[3] == dv else out[..., :dv].contiguous()), lse


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(), device_types="cuda",
                         schema="(Tensor q, Tensor k, Tensor v, bool causal, int window) -> Tensor")
def _launch(q, k, v, causal, window):
    """The kernel's launch, serving's: no lse."""
    return _launch_forward(q, k, v, causal, window, False)[0]


@_launch.register_fake
def _(q, k, v, causal, window):
    return q.new_empty(q.shape[:3] + v.shape[3:])


@torch.library.custom_op("repro_torch::flash_attention_fwd_lse", mutates_args=(), device_types="cuda",
                         schema="(Tensor q, Tensor k, Tensor v, bool causal, int window) -> (Tensor, Tensor)")
def _launch_lse(q, k, v, causal, window):
    """The kernel's launch under autograd: (out, lse)."""
    return _launch_forward(q, k, v, causal, window, True)


@_launch_lse.register_fake
def _(q, k, v, causal, window):
    b, s, h, _ = q.shape
    return q.new_empty(q.shape[:3] + v.shape[3:]), q.new_empty((b, h, s), dtype=torch.float32)


@flop_counter.register_flop_formula(
    [torch.ops.repro_torch.flash_attention_fwd, torch.ops.repro_torch.flash_attention_fwd_lse])
def _forward_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return flop_counter.sdpa_flop_count(_bhsd(q_shape), _bhsd(k_shape), _bhsd(v_shape))


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward's launch with the
    row log-sum-exp (plain version on CPU tensors); q, k, v as passed in,
    the output and the log-sum-exp saved; ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None
