"""XASH hashing + super-key OR-aggregation (paper §5): the CUDA kernel's wrapper.

``xash_superkey`` hashes encoded rows ``uint8[n, n_cols, max_len]`` into
super-key lanes ``int32[n, lanes]``.  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/xash_superkey.cu`` (the port of the Pallas
``repro.kernels.xash_kernel.xash_superkey``); on a CPU tensor it runs the
plain PyTorch version below, which is ``core.xash.superkey``.  There is no
other path: a CUDA tensor either launches the kernel or raises.  The launch
is the ``torch.library`` op ``repro_torch::xash_superkey`` with a shape
rule: a ``FakeTensorMode`` tensor gets the output's shape, never the plain
version, and never reaches ``_build.load``.

The index build hashes every unique value through it as 1-cell rows
(``xash_values``) and the online phase hashes the query keys through it as
``[n_keys, |Q|, max_len]`` rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import xash as xash_lib
from repro_torch.core.xash import XashConfig
from repro_torch.device import is_fake
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
    fake = is_fake(enc)
    if enc.device.type == "cpu" and not fake:
        return xash_superkey_plain(enc, cfg)
    if enc.device.type != "cuda" and not fake:
        raise ValueError(f"xash_superkey runs on CUDA or CPU tensors, got {enc.device}")
    if not enc.is_contiguous():
        raise ValueError("enc must be contiguous")
    return torch.ops.repro_torch.xash_superkey(enc, *_launch_args(cfg))


@functools.lru_cache(maxsize=64)
def _launch_args(cfg: XashConfig) -> tuple:
    """The launch's arguments after ``enc`` for ``cfg``, worked out once per
    config: a launch's host time is part of the main path's."""
    return (tuple(int(r) for r in cfg.freq_rank()), cfg.lanes, cfg.c, cfg.char_region, cfg.len_segment,
            cfg.n_char_bits, cfg.use_location, cfg.use_rotation, cfg.use_length)


@torch.library.custom_op(
    "repro_torch::xash_superkey", mutates_args=(), device_types="cuda",
    schema="(Tensor enc, int[] rank, int lanes, int c, int char_region, int len_segment, int n_char_bits,"
           " bool use_location, bool use_rotation, bool use_length) -> Tensor")
def _launch(enc, rank, lanes, c, char_region, len_segment, n_char_bits, use_location, use_rotation,
            use_length):
    n, n_cols, max_len = enc.shape
    out = torch.empty(n, lanes, dtype=torch.int32, device=enc.device)
    if n == 0:
        return out
    lib = _build.load("xash_superkey")
    rank = np.ascontiguousarray(rank, dtype=np.int32)
    err = lib.xash_superkey_launch(
        enc.data_ptr(), out.data_ptr(), rank.ctypes.data, n, n_cols, max_len,
        lanes, c, char_region, len_segment, n_char_bits,
        int(use_location), int(use_rotation), int(use_length),
        torch.cuda.current_stream(enc.device).cuda_stream,
    )
    _build.check(err, "xash_superkey")
    xash_superkey.launches += 1
    return out


@_launch.register_fake
def _(enc, rank, lanes, c, char_region, len_segment, n_char_bits, use_location, use_rotation, use_length):
    return enc.new_empty((enc.shape[0], lanes), dtype=torch.int32)


xash_superkey.launches = 0


def xash_values(enc_values: torch.Tensor, cfg: XashConfig) -> torch.Tensor:
    """Per-value XASH: uint8[n, max_len] -> int32[n, lanes] (1-cell rows)."""
    return xash_superkey(enc_values[:, None, :], cfg)
