"""The ops wrappers the port added for ROADMAP C.5 — ``superkey``,
``xash_values`` and ``filter_match`` — against the reference.

Seeded numpy inputs go through the port's wrapper on CPU tensors (where each
kernel wrapper takes its plain version) and through the reference's
oracles: ``repro.kernels.ref.xash_superkey_ref`` / ``xash_ref`` and
``repro.core.xash.superkey`` for the hashes (the reference's own
``ops.superkey`` runs its Pallas XASH kernel, which cannot run on this jax:
ROADMAP C.1), ``repro.kernels.ops.subsume_np`` for the match matrix.  The
outputs are integers and booleans, held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import xash as ref_xash
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro_torch.core import xash
from repro_torch.kernels import ops

ALL_BITS = (128, 256, 512)
# the shapes of tests/test_kernels.py's superkey cases
ROW_SHAPES = [(4, 1, 16), (128, 3, 48), (200, 7, 48), (257, 2, 32), (64, 12, 24)]


def _enc(shape, seed):
    """Encoded cells: codes 1..37 with zero padding at each cell's end."""
    rng = np.random.default_rng(seed)
    enc = rng.integers(1, 38, size=shape).astype(np.uint8)
    lengths = rng.integers(0, shape[-1] + 1, size=shape[:-1])
    enc[np.arange(shape[-1]) >= lengths[..., None]] = 0
    return enc


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("shape", ROW_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_superkey_matches_reference(shape, bits):
    enc = _enc(shape, seed=sum(shape) + bits)
    got = ops.superkey(enc, xash.XashConfig(bits=bits), device="cpu")
    cfg = ref_xash.XashConfig(bits=bits)
    want = np.asarray(ref_kernels.xash_superkey_ref(jnp.asarray(enc), cfg))
    assert got.dtype == np.uint32 and got.shape == (shape[0], bits // 32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(ref_xash.superkey(jnp.asarray(enc), cfg)))


@pytest.mark.parametrize("bits", ALL_BITS)
def test_xash_values_matches_reference(bits):
    enc = _enc((300, 40), seed=bits)
    got = ops.xash_values(enc, xash.XashConfig(bits=bits), device="cpu")
    want = np.asarray(ref_kernels.xash_ref(jnp.asarray(enc), ref_xash.XashConfig(bits=bits)))
    np.testing.assert_array_equal(got, want)
    # a tensor input runs on its own device and gives the same lanes
    again = ops.xash_values(torch.from_numpy(enc), xash.XashConfig(bits=bits))
    np.testing.assert_array_equal(again, want)


def _superkeys(rng, n, q, lanes):
    """Rows with few bits set, and queries that are subsets of some rows
    (hits), of no row, all-zero and all-ones."""
    rows = rng.integers(0, 2**32, size=(n, lanes), dtype=np.uint32)
    rows &= rng.integers(0, 2**32, size=(n, lanes), dtype=np.uint32)
    qry = rows[rng.integers(0, n, size=q)] & rng.integers(0, 2**32, size=(q, lanes), dtype=np.uint32)
    qry[0] = 0
    qry[-1] = np.uint32(0xFFFFFFFF)
    return rows, qry


@pytest.mark.parametrize("lanes", (4, 8, 16))
@pytest.mark.parametrize("n,q", [(1, 2), (37, 9), (600, 30)])
def test_filter_match_matches_subsume_np(n, q, lanes):
    rng = np.random.default_rng(n * q + lanes)
    rows, qry = _superkeys(rng, n, q, lanes)
    want = ref_ops.subsume_np(rows, qry)
    got = ops.filter_match(rows, qry, device="cpu")
    assert got.dtype == np.bool_ and got.shape == (n, q)
    np.testing.assert_array_equal(got, want)
    assert want[:, 0].all() and want.any()  # the all-zero query hits every row
    as_tensors = ops.filter_match(xash.lanes_to_torch(rows), xash.lanes_to_torch(qry))
    np.testing.assert_array_equal(as_tensors, want)


def test_filter_match_rejects_mismatched_lanes():
    rows = np.zeros((3, 4), np.uint32)
    with pytest.raises(ValueError, match="lane counts differ"):
        ops.filter_match(rows, np.zeros((2, 8), np.uint32), device="cpu")
