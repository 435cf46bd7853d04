"""The yardsticks of ``chip_smoke.py``: the bytes and FLOPs its bounds are
computed from, held against brute-force counts at small shapes.

``flash_work`` (B.6) counts the admissible (query, key) pairs of a causal,
windowed or ragged call and the bytes of q, k, v and out; ``gather_bytes``
(B.2) counts the distinct 32-byte store sectors the candidate rows' probed
lanes touch.  Importing ``chip_smoke`` needs no GPU.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py"
)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("s,t,window,causal", [
    (64, 64, 0, True),
    (100, 37, 0, True),  # ragged, S > T
    (37, 100, 0, True),  # S < T
    (128, 128, 16, True),  # sliding window
    (50, 70, 9, False),  # non-causal window
    (7, 3, 5, True),  # rows past T with no admissible key in the window
    (1000, 1000, 0, True),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_work_matches_brute_force(s, t, window, causal, dtype):
    b, h, d, dv = 2, 3, 32, 16
    diff = np.arange(s)[:, None] - np.arange(t)[None, :]
    ok = np.ones((s, t), dtype=bool)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    tensors = [torch.empty(b, n, h, e, dtype=dtype) for n, e in ((s, d), (t, d), (t, dv), (s, dv))]
    want = (sum(x.numel() * x.element_size() for x in tensors),
            b * h * int(ok.sum()) * 2 * (d + dv))
    got = chip_smoke.flash_work(b, s, t, h, d, dv, window, tensors[0].element_size(), causal)
    assert got == want


@pytest.mark.parametrize("store_stride,lanes,n_store", [
    (4, 4, 64),  # 16-byte rows: neighbours share a sector
    (16, 16, 64),  # 64-byte rows: two sectors each
    (16, 4, 64),  # lane prefix of a 512-bit store
    (8, 8, 33),
    (4, 4, 5),  # every row picked many times
])
@pytest.mark.parametrize("has_elig", [True, False])
def test_gather_bytes_match_brute_force(store_stride, lanes, n_store, has_elig):
    rng = np.random.default_rng(store_stride * 100 + lanes + n_store)
    n, q, n_tables = 200, 30, 17
    rows = rng.integers(0, n_store, size=n)
    sectors = set()
    for r in rows:
        start = int(r) * store_stride * 4
        sectors.update(range(start // 32, (start + lanes * 4 - 1) // 32 + 1))
    want = n * 4 + 32 * len(sectors) + (n * q if has_elig else 0) + n * 4 + q * lanes * 4 + n_tables * 4
    got = chip_smoke.gather_bytes(torch.from_numpy(rows.astype(np.int32)), store_stride, lanes,
                                  q, n_tables, has_elig)
    assert got == want


def test_gather_bytes_of_no_rows():
    assert chip_smoke.gather_bytes(torch.zeros(0, dtype=torch.int32), 4, 4, 3, 5, True) == 3 * 16 + 20


def _seg_and_elig(rng, n, q, kind):
    seg = rng.integers(-1, 5, size=n).astype(np.int32)  # -1: padding rows
    elig = None if kind is None else rng.random((n, q)) < 0.3
    return seg, elig


@pytest.mark.parametrize("n,lanes,n_queries,q", [
    (50, 4, 30, 30),
    (64, 16, 200, 256),  # phantom columns past n_queries
    (33, 8, 300, 300),  # two query tiles
    (1, 4, 1, 7),
])
@pytest.mark.parametrize("kind", ["random", None])
def test_counts_work_matches_brute_force(n, lanes, n_queries, q, kind):
    rng = np.random.default_rng(n * 1000 + q)
    n_tables = 17
    seg, elig = _seg_and_elig(rng, n, q, kind)
    pairs = sum(1 for i in range(n) for j in range(n_queries)
                if seg[i] >= 0 and (elig is None or elig[i, j]))
    tensors = [torch.empty(n, lanes, dtype=torch.int32), torch.empty(n, dtype=torch.int32),
               torch.empty(n_queries, lanes, dtype=torch.int32),  # inputs: rows, seg, real queries
               torch.empty(n_tables, dtype=torch.int32), torch.empty(q, dtype=torch.int32)]  # outputs
    if elig is not None:
        tensors.append(torch.empty(n, n_queries, dtype=torch.int8))  # the real queries' elig
    want = (sum(x.numel() * x.element_size() for x in tensors), pairs)
    got = chip_smoke.counts_work(n, lanes, n_queries, q, n_tables,
                                 None if elig is None else torch.from_numpy(elig),
                                 torch.from_numpy(seg))
    assert got == want


def _xash_work_brute(enc: np.ndarray, lanes: int, n_char_bits: int) -> tuple[int, int]:
    n_chars = picks = 0
    for cell in enc.reshape(-1, enc.shape[-1]):
        chars = [int(x) for x in cell if 1 <= x <= 37]
        n_chars += len(chars)
        present = len(set(chars))
        picks += present * min(present, n_char_bits)
    return enc.size + enc.shape[0] * lanes * 4, enc.size + 2 * n_chars + picks


@pytest.mark.parametrize("bits,max_len", [(128, 48), (256, 20), (512, 80)])
def test_xash_work_matches_brute_force(bits, max_len):
    from repro_torch.core import xash

    rng = np.random.default_rng(bits)
    uniq = rng.integers(0, 38, size=(40, 48)).astype(np.uint8)
    uniq[::3, 20:] = 0
    enc = chip_smoke.xash_edge_inputs(rng, uniq, 90, max_len)
    cfg = xash.XashConfig(bits=bits)
    want = _xash_work_brute(enc, cfg.lanes, cfg.n_char_bits)
    assert chip_smoke.xash_work(torch.from_numpy(enc), cfg) == want


@pytest.mark.parametrize("max_len", [48, 20, 80])
def test_xash_edge_inputs_hold_their_edges(max_len):
    rng = np.random.default_rng(max_len)
    uniq = rng.integers(1, 38, size=(40, 48)).astype(np.uint8)
    enc = chip_smoke.xash_edge_inputs(rng, uniq, 1001, max_len)
    assert enc.shape == (1001, 3, max_len) and enc.dtype == np.uint8
    cells = enc.reshape(-1, max_len)
    repeated = {int(c[0]) for c in cells if c[0] and (c == c[0]).all()}
    assert len(repeated) >= 30  # one character over the full width (a few cells are emptied after)
    full = [c for c in cells if len(set(c[c > 0].tolist())) == min(37, max_len)]
    assert full  # all 37 characters (or as many as the width holds)
    assert (enc > 37).any()  # codes above the alphabet
    cells_empty = (enc == 0).all(axis=2)
    assert (cells_empty[:, 1] & ~cells_empty[:, 0] & ~cells_empty[:, 2]).any()  # empty middle cells
    assert cells_empty.all(axis=1).any()  # empty rows
