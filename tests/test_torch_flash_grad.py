"""B.6's backward (``flash_kernel.flash_attention_backward``, reached
through the ``_FlashAttention`` autograd Function) against autodiff.

The reference trains through XLA attention, not through its Pallas kernel:
``layers._sdpa_full`` and the KV-blocked ``_sdpa_flash``, differentiated by
``jax.grad``.  Held here, on the same numpy-seeded inputs:

* float64 ``gradcheck`` of ``flash_attention`` (the plain version computes
  in the inputs' dtype when it is wider than float32), causal, windowed,
  non-causal, S != T and dv != d, also with the query axis blocked small
  (``_PLAIN_ELEMS`` patched) so that blocks admit key spans that start
  past 0;
* float32 and bfloat16 gradients against torch autograd through the plain
  version on float32 copies (the chip smoke's ``flash_grad`` check:
  ‖Δ‖/‖ref‖ <= 1e-5 in float32, 1e-2 in bfloat16);
* float32 gradients against ``jax.grad`` of ``_sdpa_full`` and
  ``_sdpa_flash``: ``test_torch_flash_grad_ref.py``;
* dtypes, the Function's use only when an input requires grad, and a
  row with no admissible key giving zero gradients.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_kernel

# (B, S, T, H, d, dv, causal, window)
CASES = [
    (2, 24, 24, 3, 8, 8, True, 0),
    (2, 24, 24, 2, 8, 8, True, 7),  # sliding window
    (1, 20, 33, 2, 8, 5, True, 0),  # S < T, dv != d
    (2, 33, 20, 2, 6, 6, True, 0),  # S > T
    (1, 30, 17, 2, 6, 6, False, 0),  # non-causal, S != T
    (1, 16, 16, 2, 12, 4, False, 5),  # non-causal window
]
IDS = ["causal", "window", "s<t", "s>t", "noncausal", "noncausal-window"]
# the same masks at gradcheck's size (its numerical Jacobian costs two
# forwards per input element)
SMALL = [(1, 10, 10, 2, 4, 4, True, 0), (1, 10, 10, 1, 4, 4, True, 3), (1, 7, 11, 1, 4, 3, True, 0),
         (1, 11, 7, 1, 3, 3, True, 0), (1, 9, 6, 1, 3, 3, False, 0), (1, 8, 8, 1, 5, 2, False, 3)]


def _qkv(b, s, t, h, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, t, h, d), dtype=np.float32),
            rng.standard_normal((b, t, h, dv), dtype=np.float32),
            rng.standard_normal((b, s, h, dv), dtype=np.float32))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", SMALL, ids=IDS)
@pytest.mark.parametrize("blocked", [False, True], ids=["one-block", "blocked"])
def test_gradcheck_float64(case, blocked, monkeypatch):
    b, s, t, h, d, dv, causal, window = case
    if blocked:  # 3 query rows per block
        monkeypatch.setattr(flash_kernel, "_PLAIN_ELEMS", 3 * b * h * t)
    q, k, v, _ = (torch.from_numpy(a).double().requires_grad_(True) for a in _qkv(*case[:6]))
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_kernel.flash_attention(q, k, v, causal=causal, window=window),
        (q, k, v))


def _plain_grads(q, k, v, do, causal, window):
    """torch autograd through the plain version on float32 copies."""
    q, k, v = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    out = flash_kernel.flash_attention_plain(q, k, v, causal=causal, window=window)
    return torch.autograd.grad(out, (q, k, v), do.float())


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
def test_backward_matches_autograd_of_plain(case, dtype, tol):
    *shape, causal, window = case
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _qkv(*shape, seed=1))
    got = flash_kernel.flash_attention_backward(q, k, v, do, causal=causal, window=window)
    want = _plain_grads(q, k, v, do, causal, window)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel(g, w) <= tol, (name, _rel(g, w))


def test_function_only_when_an_input_requires_grad(monkeypatch):
    calls = []
    apply = flash_kernel._FlashAttention.apply
    monkeypatch.setattr(flash_kernel._FlashAttention, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 4, 4))
    out = flash_kernel.flash_attention(q, k, v)
    assert calls == [] and out.grad_fn is None
    with torch.no_grad():
        flash_kernel.flash_attention(q, k.requires_grad_(True), v)
    assert calls == []
    out = flash_kernel.flash_attention(q, k, v)
    assert calls == [1] and out.grad_fn is not None
    assert torch.equal(out.detach(), flash_kernel.flash_attention_plain(q, k.detach(), v))


def test_row_without_admissible_key_gets_zero_gradients():
    """A causal window over S > T: the rows past T + window - 1 admit no
    key; their output is zero and so are their gradients."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(1, 12, 4, 1, 4, 4, seed=4))
    dq, dk, dv = flash_kernel.flash_attention_backward(q, k, v, do, causal=True, window=3)
    assert torch.all(dq[:, 6:] == 0) and bool(dq[:, :6].abs().sum() > 0)
    want = _plain_grads(q, k, v, do, True, 3)
    for g, w in zip((dq, dk, dv), want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 7)])
def test_large_scores_stay_finite_under_autograd_of_plain(causal, window):
    """Scores in the hundreds (the init rule's attention at full width):
    a masked score's exp overflows, and autograd through the plain version
    — the yardstick the chip smoke holds the backward to — must still give
    finite gradients, equal to the backward's."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(1, 40, 40, 2, 8, 8, seed=5))
    q, k = q * 30, k * 30
    want = _plain_grads(q, k, v, do, causal, window)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    got = flash_kernel.flash_attention_backward(q, k, v, do, causal=causal, window=window)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
