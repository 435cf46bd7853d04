"""Plain PyTorch oracles of the kernels' semantics (port of
``repro.kernels.ref``).  Outputs are integral, so kernels must reproduce
them exactly — no tolerance."""

from __future__ import annotations

import torch

from repro_torch.core import xash as xash_core


def xash_superkey_ref(enc: torch.Tensor, cfg=xash_core.DEFAULT_CONFIG) -> torch.Tensor:
    """Super keys of rows: uint8[n_rows, n_cols, max_len] -> int32[n_rows, lanes]."""
    return xash_core.superkey(enc.to(torch.uint8), cfg)


def xash_ref(enc: torch.Tensor, cfg=xash_core.DEFAULT_CONFIG) -> torch.Tensor:
    """Per-value XASH: [n, max_len] -> int32[n, lanes]."""
    return xash_core.xash(enc.to(torch.uint8), cfg)


def filter_match_ref(row_sk: torch.Tensor, query_sk: torch.Tensor) -> torch.Tensor:
    """bool[n, q] — True where the query key may be contained in the row (§6.3)."""
    return xash_core.subsumes(query_sk[None, :, :], row_sk[:, None, :])


def filter_count_ref(row_sk: torch.Tensor, query_sk: torch.Tensor) -> torch.Tensor:
    """Per-query count of candidate rows passing the filter: int32[q]."""
    return filter_match_ref(row_sk, query_sk).sum(dim=0, dtype=torch.int32)
