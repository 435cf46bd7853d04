"""XASH hashing + super-key OR-aggregation (paper §5): the CUDA kernel's wrapper.

``xash_superkey`` hashes encoded rows ``uint8[n, n_cols, max_len]`` into
super-key lanes ``int32[n, lanes]``.  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/xash_superkey.cu`` (the port of the Pallas
``repro.kernels.xash_kernel.xash_superkey``); on a CPU tensor it runs the
plain PyTorch version below, which is ``core.xash.superkey``.  There is no
other path: a CUDA tensor either launches the kernel or raises.

The index build hashes every unique value through it as 1-cell rows
(``xash_values``) and the online phase hashes the query keys through it as
``[n_keys, |Q|, max_len]`` rows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import xash as xash_lib
from repro_torch.core.xash import XashConfig
from repro_torch.kernels import _build

# rows per plain-version step: bounds its [rows, 38] int64 counters
PLAIN_CHUNK = 1 << 18


def xash_superkey_plain(enc: torch.Tensor, cfg: XashConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int32[n, lanes] on enc's device."""
    n = enc.shape[0]
    out = torch.empty(n, cfg.lanes, dtype=torch.int32, device=enc.device)
    for s in range(0, n, PLAIN_CHUNK):
        out[s : s + PLAIN_CHUNK] = xash_lib.superkey(enc[s : s + PLAIN_CHUNK], cfg)
    return out


def xash_superkey(enc: torch.Tensor, cfg: XashConfig) -> torch.Tensor:
    """Super keys of encoded rows.

    Args:
      enc: uint8[n, n_cols, max_len] encoded cells (codes 0..37).
    Returns:
      int32[n, lanes] super-key lanes (uint32 bit patterns), on enc's device.
    """
    if enc.dim() != 3 or enc.dtype != torch.uint8:
        raise ValueError(f"enc must be uint8[n, n_cols, max_len], got {enc.dtype}{list(enc.shape)}")
    if enc.device.type == "cpu":
        return xash_superkey_plain(enc, cfg)
    if enc.device.type != "cuda":
        raise ValueError(f"xash_superkey runs on CUDA or CPU tensors, got {enc.device}")
    if not enc.is_contiguous():
        raise ValueError("enc must be contiguous")
    n, n_cols, max_len = enc.shape
    out = torch.empty(n, cfg.lanes, dtype=torch.int32, device=enc.device)
    if n == 0:
        return out
    lib = _build.load("xash_superkey")
    rank = np.ascontiguousarray(cfg.freq_rank(), dtype=np.int32)
    err = lib.xash_superkey_launch(
        enc.data_ptr(), out.data_ptr(), rank.ctypes.data, n, n_cols, max_len,
        cfg.lanes, cfg.c, cfg.char_region, cfg.len_segment, cfg.n_char_bits,
        int(cfg.use_location), int(cfg.use_rotation), int(cfg.use_length),
        torch.cuda.current_stream(enc.device).cuda_stream,
    )
    _build.check(err, "xash_superkey")
    xash_superkey.launches += 1
    return out


xash_superkey.launches = 0


def xash_values(enc_values: torch.Tensor, cfg: XashConfig) -> torch.Tensor:
    """Per-value XASH: uint8[n, max_len] -> int32[n, lanes] (1-cell rows)."""
    return xash_superkey(enc_values[:, None, :], cfg)
