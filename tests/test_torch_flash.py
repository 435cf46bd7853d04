"""Flash attention parity (B.6): the port's ``ops.flash_attention`` against
the reference's (its Pallas kernel, in interpret mode on the CPU).

On CPU tensors the wrapper runs the kernel's plain version, which is what
the CUDA kernel is held to on the card (``chip_smoke.py``).  The shapes and
tolerances are ``tests/test_kernels.py::test_flash_attention_kernel``'s:
1e-5 for float32, 2e-2 for bfloat16 (the reference casts P to bf16 before
P·V, the plain version keeps it in float32).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import layers as ref_layers
from repro_torch.kernels import flash_kernel, ops

SHAPES = [
    (256, 64, 64, 0, "float32"),
    (256, 64, 64, 64, "float32"),
    (384, 128, 64, 0, "bfloat16"),  # dv != d, S not a multiple of the block
]
B, H = 2, 2


def _inputs(s, t, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s, H, d), dtype=np.float32),
            rng.standard_normal((B, t, H, d), dtype=np.float32),
            rng.standard_normal((B, t, H, dv), dtype=np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("s,d,dv,window,dtype", SHAPES)
def test_flash_attention_matches_reference(s, d, dv, window, dtype):
    q, k, v = _inputs(s, s, d, dv)
    jdt = getattr(jnp, dtype)
    want = ref_ops.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                   causal=True, window=window)
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                              causal=True, window=window)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, s, H, dv)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32)))) < tol


def test_non_causal_unaligned_raises_like_the_reference():
    q, k, v = (torch.from_numpy(a) for a in _inputs(100, 100, 16, 16))
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.flash_attention(q, k, v, causal=False)
    q, k, v = (torch.from_numpy(a) for a in _inputs(128, 256, 16, 16))
    out = ops.flash_attention(q, k, v, causal=False)
    want = torch.softmax(torch.einsum("bshd,bthd->bhst", q, k) / 4.0, dim=-1)
    assert torch.allclose(out, torch.einsum("bhst,bthd->bshd", want, v), atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 7)])
def test_plain_version_masks_by_position(causal, window):
    """Ragged S != T, causal / sliding / non-causal windows, strided inputs:
    the plain version against a dense masked softmax in float64."""
    q, k, v = _inputs(37, 45, 16, 24, seed=1)
    qt = torch.from_numpy(q).transpose(1, 2).contiguous().transpose(1, 2)  # strided view
    got = flash_kernel.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                                       causal=causal, window=window)
    diff = np.arange(37)[:, None] - np.arange(45)[None, :]
    ok = np.ones_like(diff, dtype=bool)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    sc = np.einsum("bshd,bthd->bhst", q.astype(np.float64), k) / 4.0
    sc = np.where(ok, sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    want = np.einsum("bhst,bthd->bshd", p / p.sum(-1, keepdims=True), v)
    assert np.max(np.abs(got.numpy() - want)) < 1e-5
    assert flash_kernel.flash_attention.launches == 0  # CPU tensors launch nothing


def test_row_without_admissible_key_is_zero():
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 4, 16, 16))
    out = flash_kernel.flash_attention(q, k, v, causal=True, window=2)
    # rows 0..4 see keys; rows 5..7 have all their window past T = 4
    assert torch.all(out[:, 5:] == 0) and torch.all(out[:, :5].abs().sum(-1) > 0)


def test_rejects_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 8, 16, 16))
    with pytest.raises(ValueError, match="shapes differ"):
        flash_kernel.flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError, match="window"):
        flash_kernel.flash_attention(q, k, v, window=-1)


def _tile(n: int, widths) -> int:
    return next(w for w in widths if w >= n)


@pytest.mark.parametrize("d,dv", [(24, 16), (192, 128), (20, 12)])  # MLA's reduced and full head dims; dims off the 16-byte rule
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_padding_is_exact(d, dv, window, dtype):
    """The bf16 kernel on CUDA sees q, k and v zero-padded along d and dv:
    by the wrapper to a multiple of 8 where the byte width breaks the
    tensor maps' 16-byte rule, then by the tensor maps' zero fill to its
    tile widths (64, 128, 192), with the scale of the unpadded d.  Attention
    on the padded inputs, with q scaled by sqrt(d_pad / d) to keep
    1/sqrt(d), sliced back to dv, equals attention on the unpadded inputs
    (float32, within rounding); the plain version agrees with the
    reference's chunked attention (``layers._sdpa_flash``, MLA's prefill
    path) within the B.6 tolerances."""
    s = 200
    q, k, v = _inputs(s, s, d, dv, seed=d)
    qt, kt, vt = (_torch(x, dtype) for x in (q, k, v))
    want = flash_kernel.flash_attention_plain(qt, kt, vt, causal=True, window=window)
    wrapped = [flash_kernel._pad8(x) for x in (qt, kt, vt)]
    assert [x.shape[3] for x in wrapped] == [-(-d // 8) * 8] * 2 + [-(-dv // 8) * 8]
    assert all(torch.equal(x[..., :n], y) for x, y, n in zip(wrapped, (qt, kt, vt), (d, d, dv)))
    dp, dvp = _tile(d, (64, 128, 192)), _tile(dv, (64, 128))
    pad = torch.nn.functional.pad
    q32, k32, v32 = (x.float() for x in wrapped)
    qp = pad(q32, (0, dp - q32.shape[3])) * math.sqrt(dp / d)
    kp, vp = pad(k32, (0, dp - k32.shape[3])), pad(v32, (0, dvp - v32.shape[3]))
    got = flash_kernel.flash_attention_plain(qp, kp, vp, causal=True, window=window)
    ref32 = flash_kernel.flash_attention_plain(qt.float(), kt.float(), vt.float(), causal=True,
                                               window=window)
    assert not got[..., dv:].any()
    assert float((got[..., :dv] - ref32).abs().max()) < 1e-6
    pos = jnp.arange(s, dtype=jnp.int32)
    jdt = getattr(jnp, dtype)
    ref = ref_layers._sdpa_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                 pos, pos, True, window)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert float(np.max(np.abs(want.float().numpy() - np.asarray(ref, np.float32)))) < tol
