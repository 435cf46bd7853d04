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
