"""The match matrix (B.4) and per-query counts (B.5) of the port against the
reference at the edge shapes of their CUDA kernel, exactly.

Shapes are the chip smoke's: q over one query tile, its ragged edge and two
tiles; n from one row up; 128, 256 and 512 bits.  The inputs are the smoke's
own (``chip_smoke.edge_rows`` / ``edge_queries``, from a numpy seed): rows of
realistic popcount with all-ones and zero rows among them, queries that are
bit subsets of rows, with an all-zero and an all-ones query.  The matrix is
held against the reference's numpy oracle (``filter_match_auto(...,
"numpy")``), the counts against the reference's Pallas kernel in interpret
mode.  Integer outputs: bit-identical, no tolerance.  On the CPU the
wrappers run their plain versions; the kernels are held against those on
the card, at these shapes and at n = 2^20 + 3, by ``chip_smoke.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import filter_kernel

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py"
)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

EDGE_N = (1, 31, 257, 1027)  # the card adds 2^20 + 3
BITS = (128, 256, 512)


def _inputs(bits: int, n: int, q: int) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(bits * 100_000 + n * 1000 + q)
    rows = chip_smoke.edge_rows(rng, torch.device("cpu"), n, bits // 32)
    return rows, chip_smoke.edge_queries(rng, rows, q)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_edge_shapes_are_the_smokes():
    assert chip_smoke.EDGE_Q == (1, 7, 9, 30, 240, 256, 257, 300)
    assert chip_smoke.EDGE_N[:3] == EDGE_N[:3]
    assert chip_smoke.EDGE_LANES == tuple(b // 32 for b in BITS)


@pytest.mark.parametrize("q", chip_smoke.EDGE_Q)
@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("bits", BITS)
def test_match_matches_reference_at_edge_shapes(bits, n, q):
    rows, qs = _inputs(bits, n, q)
    got = filter_kernel.filter_match(rows, qs)
    want = ref_ops.filter_match_auto(_u32(rows), _u32(qs), "numpy")
    assert got.dtype == torch.int8 and got.shape == (n, q)
    assert np.array_equal(got.numpy(), want.astype(np.int8))  # every byte 0 or 1
    if q >= 2:
        assert want[:, q // 2].all()  # the all-zero query matches every row


@pytest.mark.parametrize("q", chip_smoke.EDGE_Q)
@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("bits", BITS)
def test_count_matches_reference_at_edge_shapes(bits, n, q):
    rows, qs = _inputs(bits, n, q)
    got = filter_kernel.filter_count(rows, qs)
    want = np.asarray(ref_ops.filter_count(_u32(rows), _u32(qs)))
    assert got.dtype == torch.int32 and got.shape == (q,)
    assert np.array_equal(got.numpy(), want)
    if q >= 3:
        assert got[q // 2] == n  # all-zero query: vacuous truth
        assert got[-1] == int((rows == -1).all(dim=1).sum())  # all-ones query: the all-ones rows
    assert filter_kernel.filter_count.launches == 0  # CPU tensors launch nothing


def test_match_rejects_mismatched_lanes():
    with pytest.raises(ValueError, match="lane counts differ"):
        filter_kernel.filter_match(torch.zeros(3, 4, dtype=torch.int32), torch.zeros(2, 16, dtype=torch.int32))
    assert filter_kernel.filter_match.launches == 0
