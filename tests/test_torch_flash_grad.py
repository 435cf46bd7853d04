"""B.6's backward (``flash_kernel.flash_attention_backward``, reached
through the ``_FlashAttention`` autograd Function, on the forward's saved
output and row log-sum-exp) against autodiff.

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
* the plain forward's row log-sum-exp (the backward's residual) against
  a float64 logsumexp of the masked scores, here, and against the
  reference's (``jax.nn.logsumexp`` over ``_mask_bias``-masked scores) in
  ``test_torch_flash_grad_ref.py``;
* dtypes, the Function's use only when an input requires grad, and a
  row with no admissible key giving zero gradients.

The head dims and lengths of the port's callers are among the cases:
MLA's d 192 / dv 128, a d that is not a multiple of 8 (100, which the bf16
kernel pads) and whisper's non-causal T = 1500.
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
# the callers' head dims and lengths: MLA, a d the bf16 kernel pads, whisper's
# cross-attention
WIDE = [
    (1, 24, 24, 2, 192, 128, True, 0),
    (1, 20, 20, 2, 100, 100, True, 9),
    (1, 8, 1500, 2, 16, 16, False, 0),
]
WIDE_IDS = ["mla-d192-dv128", "d100-window", "noncausal-t1500"]
# the same masks at gradcheck's size (its numerical Jacobian costs two
# forwards per input element)
SMALL = [(1, 10, 10, 2, 4, 4, True, 0), (1, 10, 10, 1, 4, 4, True, 3), (1, 7, 11, 1, 4, 3, True, 0),
         (1, 11, 7, 1, 3, 3, True, 0), (1, 9, 6, 1, 3, 3, False, 0), (1, 8, 8, 1, 5, 2, False, 3)]
SMALL_WIDE = [(1, 2, 2, 1, 192, 128, True, 0), (1, 3, 3, 1, 100, 100, True, 2), (1, 2, 1500, 1, 2, 2, False, 0)]


def _qkv(b, s, t, h, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, t, h, d), dtype=np.float32),
            rng.standard_normal((b, t, h, dv), dtype=np.float32),
            rng.standard_normal((b, s, h, dv), dtype=np.float32))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", SMALL + SMALL_WIDE, ids=IDS + WIDE_IDS)
@pytest.mark.parametrize("blocked", [False, True], ids=["one-block", "blocked"])
def test_gradcheck_float64(case, blocked, monkeypatch):
    b, s, t, h, d, dv, causal, window = case
    if blocked:  # 3 query rows per block
        monkeypatch.setattr(flash_kernel, "_PLAIN_ELEMS", 3 * b * h * t)
    q, k, v, _ = (torch.from_numpy(a).double().requires_grad_(True) for a in _qkv(*case[:6]))
    # the wide cases' numerical Jacobians (thousands of inputs) in fast
    # mode: against a random projection of the backward
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_kernel.flash_attention(q, k, v, causal=causal, window=window),
        (q, k, v), fast_mode=case in SMALL_WIDE)


def _backward(q, k, v, do, causal, window):
    """``flash_attention_backward`` on the plain forward's residuals."""
    out, lse = flash_kernel.flash_attention_plain_lse(q, k, v, causal=causal, window=window)
    return flash_kernel.flash_attention_backward(q, k, v, out, lse, do, causal=causal, window=window)


def _plain_grads(q, k, v, do, causal, window):
    """torch autograd through the plain version on float32 copies."""
    q, k, v = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    out = flash_kernel.flash_attention_plain(q, k, v, causal=causal, window=window)
    return torch.autograd.grad(out, (q, k, v), do.float())


@pytest.mark.parametrize("case", CASES + WIDE, ids=IDS + WIDE_IDS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
def test_backward_matches_autograd_of_plain(case, dtype, tol):
    *shape, causal, window = case
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _qkv(*shape, seed=1))
    got = _backward(q, k, v, do, causal, window)
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
    dq, dk, dv = _backward(q, k, v, do, True, 3)
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
    got = _backward(q, k, v, do, causal, window)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


def _masked_scores64(q, k, causal, window):
    """float64 scores q·k/sqrt(d) [B, H, S, T], -inf where not admissible."""
    q, k = (torch.from_numpy(x).double() for x in (q, k))
    sc = torch.einsum("bshd,bthd->bhst", q, k) / np.sqrt(q.shape[-1])
    ok = flash_kernel._admissible(q.shape[1], k.shape[1], causal, window, "cpu")
    return sc.masked_fill(~ok, float("-inf"))


# (B, S, T, H, d, causal, window): causal, window, non-causal S != T, and a
# causal window over S > T whose rows past T + window - 1 admit no key
LSE_CASES = [(2, 24, 24, 3, 8, True, 0), (1, 24, 24, 2, 8, True, 7), (1, 9, 1500, 2, 16, False, 0),
             (1, 12, 4, 1, 4, True, 3)]
LSE_IDS = ["causal", "window", "noncausal-t1500", "row-without-key"]


@pytest.mark.parametrize("case", LSE_CASES, ids=LSE_IDS)
@pytest.mark.parametrize("blocked", [False, True], ids=["one-block", "blocked"])
def test_plain_lse_matches_float64_logsumexp(case, blocked, monkeypatch):
    """The residual the backward recomputes P from: each row's log-sum-exp
    of the scaled, masked scores, -inf on a row with no admissible key."""
    b, s, t, h, d, causal, window = case
    if blocked:  # 5 query rows per block
        monkeypatch.setattr(flash_kernel, "_PLAIN_ELEMS", 5 * b * h * t)
    q, k, v, _ = _qkv(b, s, t, h, d, d, seed=6)
    out, lse = flash_kernel.flash_attention_plain_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                                      causal=causal, window=window)
    want = torch.logsumexp(_masked_scores64(q, k, causal, window), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    none = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), none) and bool((lse[none] < 0).all())
    assert float((lse.double() - want)[~none].abs().max()) <= 1e-5
    if case[-1] == 3 and s > t:
        assert bool(none[..., t + window - 1:].all()) and not bool(none[..., : t + window - 1].any())
        assert torch.all(out[:, t + window - 1:] == 0)
