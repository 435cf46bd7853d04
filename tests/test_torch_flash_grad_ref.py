"""B.6's backward against the reference's autodiff: ``jax.grad`` of its
XLA attention, ``layers._sdpa_full`` and the KV-blocked ``_sdpa_flash``
(the reference trains through them, not through its Pallas kernel), on the
same numpy-seeded float32 inputs, ‖Δ‖/‖ref‖ <= 1e-5; and the plain
forward's row log-sum-exp, the backward's residual, against
``jax.nn.logsumexp`` over the reference's ``_mask_bias``-masked scores.  GQA cases repeat the
KV heads with each package's ``repeat_kv`` and take the gradients of the
unrepeated K and V, so the repeated heads' gradients are summed back on
both sides.  The masks: causal, window, non-causal, S != T, dv != d; the head dims and
lengths: MLA's d 192 / dv 128, d 100, whisper's non-causal T = 1500.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.kernels import flash_kernel
from repro_torch.models import layers
from test_torch_flash_grad import CASES, IDS, LSE_CASES, LSE_IDS, WIDE, WIDE_IDS, _qkv, _rel

def _ref_grads(fn, q, k, v, do, n_heads):
    """jax.grad of <fn(q, repeat_kv(k), repeat_kv(v)), do> w.r.t. q, k, v."""
    def f(q, k, v):
        out = fn(q, ref_layers.repeat_kv(k, n_heads), ref_layers.repeat_kv(v, n_heads))
        return jnp.sum(out * do)
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


def _port_grads(q, k, v, do, n_heads, causal, window):
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_kernel.flash_attention(q, layers.repeat_kv(k, n_heads), layers.repeat_kv(v, n_heads),
                                       causal=causal, window=window)
    return torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))


# GQA (one KV head) on the first two masks of each kind
FULL = [(c, None) for c in CASES] + [(CASES[0], 1), (CASES[4], 1)] + [(c, None) for c in WIDE]


@pytest.mark.parametrize("case,kv_heads", FULL, ids=IDS + ["causal-gqa", "noncausal-gqa"] + WIDE_IDS)
def test_backward_matches_jax_grad_of_sdpa_full(case, kv_heads):
    b, s, t, h, d, dv, causal, window = case
    q, k, v, do = _qkv(b, s, t, h, d, dv, seed=2)
    if kv_heads:
        k, v = k[:, :, :kv_heads].copy(), v[:, :, :kv_heads].copy()
    bias = ref_layers._mask_bias(jnp.arange(s), jnp.arange(t), causal, window)
    want = _ref_grads(lambda q, k, v: ref_layers._sdpa_full(q, k, v, bias), q, k, v, do, h)
    got = _port_grads(q, k, v, do, h, causal, window)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


# _sdpa_flash admits its zero-padded keys when non-causal, so its
# non-causal cases use lengths that are multiples of its blocks
FLASH_CASES = [
    (2, 40, 40, 2, 8, 8, True, 0, 16),
    (1, 40, 40, 2, 8, 8, True, 9, 16),
    (1, 24, 37, 2, 8, 4, True, 0, 8),  # S < T, dv != d, ragged
    (1, 32, 48, 2, 8, 8, False, 0, 16),
]


@pytest.mark.parametrize("case,kv_heads", [(c, None) for c in FLASH_CASES] + [(FLASH_CASES[0], 1)],
                         ids=["causal", "window", "s<t", "noncausal", "causal-gqa"])
def test_backward_matches_jax_grad_of_sdpa_flash(case, kv_heads):
    b, s, t, h, d, dv, causal, window, block = case
    q, k, v, do = _qkv(b, s, t, h, d, dv, seed=3)
    if kv_heads:
        k, v = k[:, :, :kv_heads].copy(), v[:, :, :kv_heads].copy()
    want = _ref_grads(lambda q, k, v: ref_layers._sdpa_flash(
        q, k, v, jnp.arange(s, dtype=jnp.int32), jnp.arange(t, dtype=jnp.int32), causal, window,
        block_q=block, block_kv=block), q, k, v, do, h)
    got = _port_grads(q, k, v, do, h, causal, window)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


@pytest.mark.parametrize("case", LSE_CASES, ids=LSE_IDS)
def test_plain_lse_matches_reference_logsumexp(case):
    """The plain forward's lse against ``jax.nn.logsumexp`` of the
    reference's scores plus ``_mask_bias``; on a row with no admissible
    key the reference's bias is finite (``NEG_INF``), so there its
    logsumexp sits near ``NEG_INF`` and the port's is -inf."""
    b, s, t, h, d, causal, window = case
    q, k, v, _ = _qkv(b, s, t, h, d, d, seed=7)
    _, lse = flash_kernel.flash_attention_plain_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                                    causal=causal, window=window)
    scores = jnp.einsum("bshd,bthd->bhst", q, k) / np.sqrt(d)
    bias = ref_layers._mask_bias(jnp.arange(s), jnp.arange(t), causal, window)
    want = np.asarray(jax.nn.logsumexp(scores + bias[None, None], axis=-1), np.float64)
    none = want <= ref_layers.NEG_INF / 2
    got = lse.double().numpy()
    assert np.array_equal(np.isneginf(got), none)
    assert float(np.abs(got - want)[~none].max()) <= 1e-5
