"""Per-query filter counts (B.5): the port's ``ops.filter_count`` against
the reference's (its Pallas kernel, interpret mode), exactly.

The cases are ``tests/test_kernels.py``'s: the shape sweep, the zero-query
edge, all-zero queries at every width, and equality with the match sum.
Counts are integers: bit-identical, no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import xash as ref_xash
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.kernels import filter_kernel, ops

RNG = np.random.default_rng(0)


def rand_rows(n, c, max_len):
    lens = RNG.integers(0, max_len, size=(n, c))
    out = np.zeros((n, c, max_len), dtype=np.uint8)
    for i in range(n):
        for j in range(c):
            out[i, j, : lens[i, j]] = RNG.integers(1, 38, size=lens[i, j])
    return out


def _sk(n, c, cfg):
    return np.array(ref.xash_superkey_ref(jnp.asarray(rand_rows(n, c, 32)), cfg))


def _counts(row_sk, q_sk):
    got = ops.filter_count(row_sk, q_sk, device="cpu")
    want = np.asarray(ref_ops.filter_count(row_sk, q_sk))
    assert got.dtype == np.int32 and got.shape == (q_sk.shape[0],)
    return got, want


@pytest.mark.parametrize("n,q", [(10, 3), (1024, 256), (777, 100)])
def test_filter_count_matches_reference(n, q):
    cfg = ref_xash.DEFAULT_CONFIG
    got, want = _counts(_sk(n, 5, cfg), _sk(q, 2, cfg))
    assert np.array_equal(got, want)


def test_zero_query_edge():
    cfg = ref_xash.DEFAULT_CONFIG
    got, want = _counts(_sk(300, 5, cfg), np.zeros((3, cfg.lanes), dtype=np.uint32))
    assert np.array_equal(got, want) and got.tolist() == [300] * 3


@pytest.mark.parametrize("bits", [128, 256, 512])
def test_all_zero_queries_across_widths(bits):
    cfg = ref_xash.XashConfig(bits=bits, max_len=32)
    row_sk = _sk(333, 4, cfg)
    q_sk = _sk(5, 2, cfg)
    q_sk[2] = 0  # an empty-string key among real ones
    got, want = _counts(row_sk, q_sk)
    assert np.array_equal(got, want)
    assert got[2] == 333  # vacuous truth: it matches every real row


@pytest.mark.parametrize("bits", [128, 256, 512])
@pytest.mark.parametrize("n,q", [(100, 7), (1030, 70)])
def test_agrees_with_match_sum(bits, n, q):
    cfg = ref_xash.XashConfig(bits=bits, max_len=32)
    row_sk, q_sk = _sk(n, 5, cfg), _sk(q, 2, cfg)
    counts = ops.filter_count(row_sk, q_sk, device="cpu")
    match = ops.filter_match_auto(row_sk, q_sk, "pallas", device="cpu")  # kernel B.4's path
    assert match.shape == (n, q) and match.dtype == bool
    assert np.array_equal(match, ref_ops.subsume_np(row_sk, q_sk))
    assert np.array_equal(counts, match.sum(axis=0, dtype=np.int32))


@pytest.mark.parametrize("backend", ["numpy", "xla", "pallas", "fused"])
def test_count_equals_match_sum_under_each_backend(backend):
    """The reference's match under every backend the port dispatches sums
    to the port's per-query counts."""
    cfg = ref_xash.XashConfig(bits=128, max_len=32)
    row_sk, q_sk = _sk(500, 4, cfg), _sk(40, 2, cfg)
    q_sk[3] = 0  # an empty-string key
    counts = ops.filter_count(row_sk, q_sk, device="cpu")
    match = ops.filter_match_auto(row_sk, q_sk, backend, device="cpu")
    assert np.array_equal(counts, match.sum(axis=0, dtype=np.int32))
    assert np.array_equal(counts, np.asarray(ref_ops.filter_match_auto(row_sk, q_sk, "numpy")).sum(0))


def test_empty_inputs_and_block_validation():
    """Empty inputs give empty or zero counts; mismatched lanes raise."""
    lanes = 4
    assert ops.filter_count(np.zeros((0, lanes), np.uint32), np.ones((3, lanes), np.uint32),
                            device="cpu").tolist() == [0, 0, 0]
    assert ops.filter_count(np.ones((5, lanes), np.uint32), np.zeros((0, lanes), np.uint32),
                            device="cpu").shape == (0,)
    row_sk = np.ones((5, lanes), np.uint32)
    assert ops.filter_count(row_sk, row_sk[:2], device="cpu").tolist() == [5, 5]
    with pytest.raises(ValueError, match="lane counts differ"):
        filter_kernel.filter_count(torch.zeros(3, 4, dtype=torch.int32), torch.zeros(2, 8, dtype=torch.int32))
    assert filter_kernel.filter_count.launches == 0  # CPU tensors launch nothing
