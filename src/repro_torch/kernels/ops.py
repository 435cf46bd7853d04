"""Public wrappers around the port's kernels (port of ``repro.kernels.ops``).

The filter wrappers take the engines' host arrays (uint32 superkeys, bool
eligibility, int32 table ids), move them to the device, dispatch on the
resolved backend (``kernels.registry``) and return host arrays.
``superkey`` / ``xash_values`` (kernel B.3) and ``filter_match`` (B.4) take
host arrays or tensors and return host arrays, as the engines' callers
use them.  ``flash_attention`` takes and returns tensors, on the
reference's ``[B, S, H, d]`` layout.  The reference's padding to block
multiples and shape buckets is gone: the CUDA kernels mask their own ragged
edges and PyTorch compiles nothing per shape.

The demotion ladder is the reference's, unchanged:

  * ``fused-gather`` → ``fused`` when there is no device store, or the batch
    has more than ``_FUSED_MAX_TABLES`` tables (the engines also demote when
    the store is over ``GATHER_STORE_MAX_BYTES``);
  * ``fused`` → ``pallas`` above ``_FUSED_MAX_TABLES`` tables;
  * ``fused*`` → ``pallas`` in ``filter_match_auto`` (no matrix output).

Demotions land on the hand-written kernels B.1 and B.4, never on a plain
version; plain versions run only for tensors on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.xash import DEFAULT_CONFIG, XashConfig, lanes_to_numpy, lanes_to_torch
from repro_torch.device import resolve_device
from repro_torch.kernels import filter_kernel, flash_kernel, registry, xash_kernel
from repro_torch.kernels.registry import Backend

# below this many (row × key) probes, numpy beats a device dispatch
_MIN_XLA_PROBES = 1 << 17

# per-launch table cap of the fused counts kernels (their shared-memory
# histogram); engines read it here so a test can lower it
_FUSED_MAX_TABLES = filter_kernel.FUSED_MAX_TABLES

# device superkey stores above this size stay host-resident and the
# fused-gather backend demotes to the host-gather fused launch
GATHER_STORE_MAX_BYTES = 2 << 30

# unique values per rank per XASH launch of ``xash_values_mesh`` (the
# single-host build's chunk, ``core.index._XASH_CHUNK``)
_MESH_HASH_CHUNK = 1 << 18

# the reference's flash block (block_q = block_kv): it pads S and T to it,
# which is only sound for causal calls, so it asserts alignment otherwise
FLASH_ALIGN = 128


def _check_fused_block_n(block_n: int) -> None:
    """Validate a user-facing ``fused_block_n`` override (the message
    mirrors ``DiscoveryConfig``).  The CUDA kernels size their own blocks,
    so a valid value changes nothing in the launch."""
    if block_n < 128 or block_n & (block_n - 1):
        raise ValueError(
            f"fused_block_n must be a power of two >= 128, got {block_n}"
        )


def fused_filter_default() -> bool:
    """True when the unpinned dispatch resolves to a fused counts-only
    launch (the backend variable, ``registry.ENV_VAR``, naming a fused
    backend, or a CUDA device, whose default is the gather kernel).
    Selection itself lives in ``kernels.registry``; this is a convenience
    predicate over it."""
    return registry.resolve_backend().fused


def _on_device(a: np.ndarray | torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """``a`` as a contiguous ``dtype`` tensor on ``device`` (None: a
    tensor's own device, else the CUDA device)."""
    if isinstance(a, torch.Tensor):
        dev = a.device if device is None else resolve_device(device)
        return a.to(dev, dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device), dtype)


def _lanes_on(lanes: np.ndarray | torch.Tensor, device) -> torch.Tensor:
    """Superkey lanes as an int32 tensor (uint32 bit patterns) on ``device``."""
    if isinstance(lanes, torch.Tensor):
        return _on_device(lanes, torch.int32, device)
    return lanes_to_torch(lanes, resolve_device(device))


def superkey(
    enc_rows: np.ndarray | torch.Tensor,
    cfg: XashConfig = DEFAULT_CONFIG,
    *,
    device=None,
) -> np.ndarray:
    """Super keys of encoded rows (kernel B.3): uint8[n, n_cols, max_len] ->
    uint32[n, lanes] on the host.  The reference's ``block_n`` /
    ``interpret`` knobs are left out: the kernel sizes its own blocks."""
    enc = _on_device(enc_rows, torch.uint8, device)
    return lanes_to_numpy(xash_kernel.xash_superkey(enc, cfg))


def xash_values(
    enc_values: np.ndarray | torch.Tensor,
    cfg: XashConfig = DEFAULT_CONFIG,
    *,
    device=None,
) -> np.ndarray:
    """Per-value XASH: uint8[n, max_len] -> uint32[n, lanes] (1-cell rows)."""
    enc = _on_device(enc_values, torch.uint8, device)
    return lanes_to_numpy(xash_kernel.xash_values(enc, cfg))


def _bool_t(a: np.ndarray | None, device) -> torch.Tensor | None:
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a, dtype=bool)).to(device)


def _int32_t(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.size and (a.min() < -(2**31) or a.max() >= 2**31):
        raise ValueError("values do not fit the kernels' int32 offsets / table ids")
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flash attention (kernel B.6) on [B, S, H, d] layouts:
    q [B, S, H, d], k [B, T, H, d], v [B, T, H, dv] -> [B, S, H, dv].

    Heads must already be repeated to full count (layers.repeat_kv).  Like
    the reference, a non-causal call needs S and T aligned to its block.
    """
    s, t = q.shape[1], k.shape[1]
    if not causal and (s % FLASH_ALIGN or t % FLASH_ALIGN):
        raise ValueError(f"non-causal flash attention needs S and T multiples of {FLASH_ALIGN}, got {s}, {t}")
    return flash_kernel.flash_attention(q, k, v, causal=causal, window=window)


def xash_values_mesh(
    enc_values: np.ndarray,
    cfg,
    *,
    mesh,
    chunk: int = _MESH_HASH_CHUNK,
    times_out: list | None = None,
) -> np.ndarray:
    """Group-sharded unique-value XASH: uint8[n, max_len] -> uint32[n, lanes].

    The offline build's hash pass across a process group (``launch.mesh``):
    each block of ``chunk × ranks`` values is padded to the group and cut
    into equal rank blocks; every rank hashes its own block with kernel B.3
    (``xash_kernel.xash_values``, the plain version on a CPU rank) and an
    ``all_gather`` assembles the block on every rank.  Per-value hashing has
    no cross-value term, so the arena is BIT-IDENTICAL to the single-host
    pass at any group size.  ``times_out`` receives each collective launch's
    wall seconds (every rank takes part in each).  Every rank must call.
    """
    from repro_torch.core import distributed

    n_shards = mesh.size
    n = enc_values.shape[0]
    out = np.zeros((n, cfg.lanes), dtype=np.uint32)
    step = chunk * n_shards
    for s in range(0, n, step):
        block = distributed.pad_rows_to_shards(enc_values[s : s + step], n_shards)
        per = block.shape[0] // n_shards
        mine = np.ascontiguousarray(block[mesh.rank * per : (mesh.rank + 1) * per])
        t0 = time.perf_counter()
        lanes = distributed.all_gather_rows(
            xash_kernel.xash_values(torch.from_numpy(mine).to(mesh.device), cfg), mesh
        )
        nb = min(step, n - s)
        out[s : s + nb] = lanes_to_numpy(lanes)[:nb]
        if times_out is not None:
            times_out.append(time.perf_counter() - t0)
    return out


def filter_count(row_sk: np.ndarray, query_sk: np.ndarray, *, device=None) -> np.ndarray:
    """Fused per-query candidate count (kernel B.5): (uint32[n, lanes],
    uint32[q, lanes]) -> int32[q] on the host.

    The kernel pads nothing, so unlike the reference there is no padding
    to correct; an all-zero (empty-string) query matches every row under
    any filter (vacuous truth), as in the reference.  The reference's
    ``block_n`` / ``block_q`` are left out: the kernel sizes its own blocks.
    """
    dev = resolve_device(device)
    counts = filter_kernel.filter_count(lanes_to_torch(row_sk, dev), lanes_to_torch(query_sk, dev))
    return counts.cpu().numpy()


def subsume_np(row_sk: np.ndarray, query_sk: np.ndarray) -> np.ndarray:
    """Host-side subsumption oracle (§6.3): bool[n, q]."""
    rows = np.asarray(row_sk, dtype=np.uint32)
    qry = np.asarray(query_sk, dtype=np.uint32)
    return np.all((qry[None, :, :] & ~rows[:, None, :]) == 0, axis=-1)


def filter_match(
    row_sk: np.ndarray | torch.Tensor,
    query_sk: np.ndarray | torch.Tensor,
    *,
    device=None,
) -> np.ndarray:
    """Subsumption match matrix (kernel B.4): (uint32[n, lanes],
    uint32[q, lanes]) -> bool[n, q] on the host, the kernel's int8 matrix
    read as bool.  The kernel pads nothing, so there is nothing to slice
    off; the reference's ``block_n`` / ``block_q`` / ``interpret`` knobs are
    left out."""
    rows = _lanes_on(row_sk, device)
    qry = _lanes_on(query_sk, rows.device)
    return filter_kernel.filter_match(rows, qry).view(torch.bool).cpu().numpy()


def _device_match(backend: str, row_sk, query_sk, device) -> torch.Tensor:
    """bool[n, q] on ``device``: kernel B.4 for 'pallas', plain torch for 'xla'."""
    rows, qry = lanes_to_torch(row_sk, device), lanes_to_torch(query_sk, device)
    if backend == "xla":
        match = filter_kernel.filter_match_plain(rows, qry)
    else:
        match = filter_kernel.filter_match(rows, qry)
    return match.view(torch.bool)


def filter_match_auto(
    row_sk: np.ndarray,
    query_sk: np.ndarray,
    backend: Backend | str | None = None,
    *,
    device=None,
) -> np.ndarray:
    """Backend-dispatched super-key row filter (§6.3): bool[n, q] on the host.

    Fused backends have no matrix output, so they run the match kernel
    ('pallas'); 'auto' splits by size between numpy and plain torch.
    """
    n, q = row_sk.shape[0], query_sk.shape[0]
    if n == 0 or q == 0:
        return np.zeros((n, q), dtype=bool)
    platform = None if device is None else torch.device(device).type
    backend = registry.resolve_backend(backend, platform).name
    if backend in ("fused", "fused-gather"):
        backend = "pallas"  # fused paths have no matrix output; same family
    if backend == "auto":
        backend = "numpy" if n * q < _MIN_XLA_PROBES else "xla"
    if backend == "numpy":
        return subsume_np(row_sk, query_sk)
    return _device_match(backend, row_sk, query_sk, resolve_device(device)).cpu().numpy()


def filter_table_counts(
    row_sk: np.ndarray,
    query_sk: np.ndarray,
    elig: np.ndarray | None,
    seg_ids: np.ndarray,
    n_tables: int,
    *,
    mode: str = "sum",
    block_n: int | None = None,
    device=None,
) -> np.ndarray:
    """Fused filter+segment-count launch (kernel B.1): per-table eligible-hit
    counts with counts-only readback — the match matrix is never produced.

    Args:
      row_sk:   uint32[n, lanes] candidate-row super keys.
      query_sk: uint32[q, lanes] query-key super keys.
      elig:     bool[n, q] eligibility per (item, key), or None.
      seg_ids:  int32[n] table index (0..n_tables) of each candidate item.
      n_tables: number of tables covered by this block (≤ _FUSED_MAX_TABLES).
      mode:     'sum' (eligible hits per table) | 'any' (rows with ≥1 hit).
      block_n:  validated for parity with ``DiscoveryConfig.fused_block_n``.
    Returns:
      int32[n_tables] counts on the host.
    """
    n, q = row_sk.shape[0], query_sk.shape[0]
    if n == 0 or q == 0 or n_tables == 0:
        return np.zeros(n_tables, dtype=np.int32)
    if n_tables > _FUSED_MAX_TABLES:
        raise ValueError(f"fused launch takes at most {_FUSED_MAX_TABLES} tables, got {n_tables}")
    if block_n is not None:
        _check_fused_block_n(block_n)
    dev = resolve_device(device)
    counts, _key_counts = filter_kernel.filter_table_counts(
        lanes_to_torch(row_sk, dev),
        lanes_to_torch(query_sk, dev),
        _bool_t(elig, dev),
        _int32_t(seg_ids, dev),
        n_tables=n_tables,
        mode=mode,
    )
    return counts.cpu().numpy()


def gather_store_fits(superkeys: np.ndarray) -> bool:
    """True when the per-row superkey store fits the device-store budget."""
    return superkeys.nbytes <= GATHER_STORE_MAX_BYTES


def gather_filter_table_counts(
    store: torch.Tensor,
    rows: np.ndarray,
    query_sk: np.ndarray,
    elig: np.ndarray | None,
    seg_ids: np.ndarray,
    n_tables: int,
    *,
    block_n: int | None = None,
) -> np.ndarray:
    """Gather-fused filter+segment-count launch (kernel B.2): posting-list row
    offsets in, per-table counts out; the host never gathers the candidate
    superkeys.

    Args:
      store:    int32[N, lanes_s] device-resident superkey store
                (``MateIndex.device_store()``).
      rows:     int[n] row offsets into ``store`` (the CSR candidate rows).
      query_sk: uint32[q, lanes] query-key super keys; ``lanes <= lanes_s``
                probes a lane-prefix degrade over the full-width store.
      elig:     bool[n, q] eligibility per (item, key), or None.
      seg_ids:  int32[n] table index (0..n_tables) of each candidate item.
      n_tables: number of tables covered by this block.
      block_n:  validated for parity with ``DiscoveryConfig.fused_block_n``.
    Returns:
      int32[n_tables] counts on the host.
    """
    n, q = rows.shape[0], query_sk.shape[0]
    if n == 0 or q == 0 or n_tables == 0:
        return np.zeros(n_tables, dtype=np.int32)
    if n_tables > _FUSED_MAX_TABLES:
        raise ValueError(
            f"gather-fused launch supports at most {_FUSED_MAX_TABLES}"
            f" tables per launch, got {n_tables} — split the batch or use the"
            " composed path"
        )
    if block_n is not None:
        _check_fused_block_n(block_n)
    if store.shape[0] >= 2**31:
        raise ValueError("the gather kernel takes int32 row offsets: the store must hold < 2**31 rows")
    rows = np.asarray(rows)
    if rows.min() < 0 or rows.max() >= store.shape[0]:
        raise ValueError(f"row offsets outside the store's {store.shape[0]} rows")
    dev = store.device
    counts = filter_kernel.gather_filter_table_counts(
        _int32_t(rows, dev),
        store,
        lanes_to_torch(query_sk, dev),
        _bool_t(elig, dev),
        _int32_t(seg_ids, dev),
        n_tables=n_tables,
    )
    return counts.cpu().numpy()


def filter_hits_table_counts(
    row_sk: np.ndarray | None,
    query_sk: np.ndarray,
    elig: np.ndarray,
    seg_ids: np.ndarray,
    n_tables: int,
    *,
    use_device: bool = True,
    backend: Backend | str | None = None,
    fused_block_n: int | None = None,
    store: torch.Tensor | None = None,
    rows: np.ndarray | None = None,
    device=None,
) -> tuple[np.ndarray | torch.Tensor | None, np.ndarray]:
    """Eligible filter hits plus per-table hit counts for the §6.2 bound
    checks, without moving the match matrix to the host.

    Args:
      row_sk:   uint32[n, lanes] candidate-row super keys, or None on the
                gather path (``store`` + ``rows``).
      query_sk: uint32[q, lanes] query-key super keys.
      elig:     bool[n, q] init-value eligibility per (item, key) pair.
      seg_ids:  int32[n] table index (0..n_tables) of each candidate item.
      n_tables: number of tables covered by this block.
      use_device: False forces the host numpy path.
      backend:  resolved ``Backend`` (or name); None follows the registry.
      fused_block_n: validated row-block override of the fused launches.
      store:    device-resident superkey store for ``fused-gather``.
      rows:     int[n] store row offsets for the gather launch.
      device:   device of the composed and fused launches (default: the
                store's, else CUDA).
    Returns:
      (hits, counts) — ``counts`` int32[n_tables] on the host.  ``hits`` is
      a bool tensor on the device for 'pallas'/'xla' (slice it per surviving
      table), a numpy array for 'numpy', and None on the fused paths, where
      the match matrix never existed.
    """
    n = rows.shape[0] if row_sk is None else row_sk.shape[0]
    q = query_sk.shape[0]
    if n == 0 or q == 0 or n_tables == 0:
        return np.zeros((n, q), dtype=bool), np.zeros(n_tables, dtype=np.int32)
    if not use_device:
        backend = "numpy"
    if device is None and store is not None:
        device = store.device
    platform = None if device is None else torch.device(device).type
    backend = registry.resolve_backend(backend, platform).name
    if backend == "fused-gather":
        if store is not None and rows is not None and n_tables <= _FUSED_MAX_TABLES:
            counts = gather_filter_table_counts(
                store, rows, query_sk, elig, seg_ids, n_tables,
                block_n=fused_block_n,
            )
            return None, counts
        # no device store (or too many tables for one launch): demote to the
        # host-gather fused launch, which shares the cap fallback below
        backend = "fused"
    if row_sk is None:
        # demoted off the gather path without host superkeys: gather them
        # on the device from the store
        idx = torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(store.device)
        row_sk = lanes_to_numpy(store[idx, : query_sk.shape[1]])
    if backend == "fused" and n_tables > _FUSED_MAX_TABLES:
        backend = "pallas"  # beyond the histogram's table cap: composed path
    if backend == "fused":
        counts = filter_table_counts(
            row_sk, query_sk, elig, seg_ids, n_tables, block_n=fused_block_n,
            device=device,
        )
        return None, counts
    if backend == "auto":
        backend = "numpy" if n * q < _MIN_XLA_PROBES else "xla"
    if backend == "numpy":
        hits = subsume_np(row_sk, query_sk) & np.asarray(elig, dtype=bool)
        counts = np.bincount(
            np.asarray(seg_ids, dtype=np.int64),
            weights=hits.sum(axis=1),
            minlength=n_tables,
        ).astype(np.int32)
        return hits, counts[:n_tables]
    dev = resolve_device(device)
    hits = _device_match(backend, row_sk, query_sk, dev) & _bool_t(elig, dev)
    counts = torch.zeros(n_tables, dtype=torch.int64, device=dev)
    counts.index_add_(0, _int32_t(seg_ids, dev).long(), hits.sum(dim=1))
    return hits, counts.to(torch.int32).cpu().numpy()
