"""Super-key row filter (paper §6.3): wrappers of the hand-written CUDA kernels.

Four launches, each the port of one Pallas kernel of
``repro.kernels.filter_kernel``:

  * ``filter_match``      (B.4) — the int8 ``[n, q]`` subsumption matrix
    (``csrc/filter_match.cu``);
  * ``filter_count``      (B.5) — per-query counts of rows passing the
    filter, ``int32[q]`` (``csrc/filter_count.cu``);
  * ``filter_table_counts`` (B.1) — fused subsumption ∧ eligibility, row-
    reduced ('sum' or 'any') and scattered into per-table counts, plus
    per-key counts; the n×q matrix never exists;
  * ``gather_filter_table_counts`` (B.2) — the same 'sum' counts with the
    candidate rows read in place from the device-resident superkey store.
    B.1 and B.2 are one templated CUDA body (``csrc/filter_counts.cu``),
    with one entry point each.

Layout: row-major ``int32[n, lanes]`` superkeys (uint32 bit patterns) — one
row's lanes are one 16–64-byte load.  The Pallas kernels' transposed
``[lanes, n]`` layout and one-hot MXU scatter were TPU artefacts and are
gone; so is the padding to block multiples, since each CUDA kernel masks its
own ragged edge.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
(defined beside it) on CPU tensors — and only there.  Each counts its
launches in a plain integer attribute, ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.core.xash import subsumes
from repro_torch.kernels import _build

# Largest per-launch table count of the fused counts kernels: their per-block
# shared-memory histogram is int32[n_tables] (32 KB at the cap).  Kept at the
# reference's value so the engines demote at the same batch sizes.
FUSED_MAX_TABLES = 8192

# elements (rows × queries × lanes) per plain-version step
_PLAIN_ELEMS = 1 << 24


def _plain_rows(q: int, lanes: int) -> int:
    return max(1, _PLAIN_ELEMS // max(q * lanes, 1))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, device: torch.device, **tensors) -> None:
    """Device / dtype / contiguity checks before pointers reach the kernel."""
    for arg, (t, dtypes) in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, expected one of {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _elig_int8(elig: torch.Tensor | None) -> torch.Tensor | None:
    """bool and int8 eligibility share a layout; the kernel reads int8."""
    if elig is None or elig.dtype == torch.int8:
        return elig
    return elig.view(torch.int8)


# ---------------------------------------------------------------------------
# B.4 — the subsumption matrix
# ---------------------------------------------------------------------------

def filter_match_plain(row_sk: torch.Tensor, query_sk: torch.Tensor) -> torch.Tensor:
    """Plain version of ``filter_match``: int8[n, q] on the inputs' device."""
    n, q = row_sk.shape[0], query_sk.shape[0]
    out = torch.empty(n, q, dtype=torch.int8, device=row_sk.device)
    step = _plain_rows(q, query_sk.shape[1])
    for s in range(0, n, step):
        out[s : s + step] = subsumes(query_sk[None], row_sk[s : s + step, None]).to(torch.int8)
    return out


def filter_match(row_sk: torch.Tensor, query_sk: torch.Tensor) -> torch.Tensor:
    """Subsumption match matrix.

    Args:
      row_sk:   int32[n, lanes] candidate-row super keys.
      query_sk: int32[q, lanes] query-key super keys.
    Returns:
      int8[n, q] — 1 where the query key may be contained in the row.
    """
    if row_sk.shape[1:] != query_sk.shape[1:]:
        raise ValueError(f"lane counts differ: rows {tuple(row_sk.shape)}, queries {tuple(query_sk.shape)}")
    if row_sk.device.type == "cpu":
        return filter_match_plain(row_sk, query_sk)
    dev = row_sk.device
    _check_cuda("filter_match", dev, row_sk=(row_sk, (torch.int32,)),
                query_sk=(query_sk, (torch.int32,)))
    n, q = row_sk.shape[0], query_sk.shape[0]
    out = torch.empty(n, q, dtype=torch.int8, device=dev)
    if n == 0 or q == 0:
        return out
    lib = _build.load("filter_match")
    err = lib.filter_match_launch(
        row_sk.data_ptr(), row_sk.shape[1], query_sk.data_ptr(), q, n,
        out.data_ptr(), _stream(row_sk),
    )
    _build.check(err, "filter_match")
    filter_match.launches += 1
    return out


filter_match.launches = 0


# ---------------------------------------------------------------------------
# B.5 — per-query counts
# ---------------------------------------------------------------------------

def filter_count_plain(row_sk: torch.Tensor, query_sk: torch.Tensor) -> torch.Tensor:
    """Plain version of ``filter_count``: int32[q] on the inputs' device."""
    q = query_sk.shape[0]
    counts = torch.zeros(q, dtype=torch.int64, device=row_sk.device)
    step = _plain_rows(q, query_sk.shape[1])
    for s in range(0, row_sk.shape[0], step):
        counts += subsumes(query_sk[None], row_sk[s : s + step, None]).sum(dim=0)
    return counts.to(torch.int32)


def filter_count(row_sk: torch.Tensor, query_sk: torch.Tensor) -> torch.Tensor:
    """Per-query count of rows that pass the filter.

    Args:
      row_sk:   int32[n, lanes] row super keys.
      query_sk: int32[q, lanes] query-key super keys.
    Returns:
      int32[q] — rows whose super key subsumes each query key; an all-zero
      query counts every row.
    """
    if row_sk.shape[1:] != query_sk.shape[1:]:
        raise ValueError(f"lane counts differ: rows {tuple(row_sk.shape)}, queries {tuple(query_sk.shape)}")
    if row_sk.device.type == "cpu":
        return filter_count_plain(row_sk, query_sk)
    dev = row_sk.device
    _check_cuda("filter_count", dev, row_sk=(row_sk, (torch.int32,)),
                query_sk=(query_sk, (torch.int32,)))
    n, q = row_sk.shape[0], query_sk.shape[0]
    counts = torch.zeros(q, dtype=torch.int32, device=dev)
    if n == 0 or q == 0:
        return counts
    lib = _build.load("filter_count")
    err = lib.filter_count_launch(
        row_sk.data_ptr(), row_sk.shape[1], query_sk.data_ptr(), q, n,
        counts.data_ptr(), _stream(row_sk),
    )
    _build.check(err, "filter_count")
    filter_count.launches += 1
    return counts


filter_count.launches = 0


# ---------------------------------------------------------------------------
# B.1 / B.2 — fused filter + per-table counts
# ---------------------------------------------------------------------------

def _accumulate(rows, qs, elig, seg, counts, keys, any_mode: bool) -> None:
    """Add one row chunk's hits into per-table and per-key counts (int64)."""
    hit = subsumes(qs[None], rows[:, None])  # [c, n_queries]
    if elig is not None:
        hit &= elig[:, : qs.shape[0]] != 0
    valid = seg >= 0  # padding rows count nothing
    hit &= valid[:, None]
    keys[: qs.shape[0]] += hit.sum(dim=0)
    per_row = hit.sum(dim=1)
    if any_mode:
        per_row = (per_row > 0).to(torch.int64)
    counts.index_add_(0, seg[valid].long(), per_row[valid])


def filter_table_counts_plain(
    row_sk, query_sk, elig, seg_ids, n_tables: int, n_queries: int, mode: str = "sum"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``filter_table_counts`` (row chunks, int64 sums)."""
    dev = row_sk.device
    counts = torch.zeros(n_tables, dtype=torch.int64, device=dev)
    keys = torch.zeros(query_sk.shape[0], dtype=torch.int64, device=dev)
    qs = query_sk[:n_queries]
    step = _plain_rows(n_queries, row_sk.shape[1])
    for s in range(0, row_sk.shape[0], step):
        e = s + step
        _accumulate(row_sk[s:e], qs, None if elig is None else elig[s:e],
                    seg_ids[s:e], counts, keys, mode == "any")
    return counts.to(torch.int32), keys.to(torch.int32)


def _check_counts_args(name, n, q, n_tables, n_queries, elig, seg_ids, mode="sum"):
    if mode not in ("sum", "any"):
        raise ValueError(f"{name}: mode must be 'sum' or 'any', got {mode!r}")
    if not 0 <= n_queries <= q:
        raise ValueError(f"{name}: n_queries={n_queries} outside [0, {q}]")
    if n_tables > FUSED_MAX_TABLES:
        raise ValueError(
            f"{name}: the shared-memory histogram holds at most {FUSED_MAX_TABLES}"
            f" tables per launch, got {n_tables}"
        )
    if seg_ids.shape != (n,):
        raise ValueError(f"{name}: seg_ids shape {tuple(seg_ids.shape)} != ({n},)")
    if elig is not None and elig.shape != (n, q):
        raise ValueError(f"{name}: elig shape {tuple(elig.shape)} != ({n}, {q})")


def filter_table_counts(
    row_sk: torch.Tensor,
    query_sk: torch.Tensor,
    elig: torch.Tensor | None,
    seg_ids: torch.Tensor,
    *,
    n_tables: int,
    n_queries: int | None = None,
    mode: str = "sum",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused filter + per-table segment count (B.1).

    Args:
      row_sk:   int32[n, lanes] candidate-row super keys.
      query_sk: int32[q, lanes] query-key super keys.
      elig:     bool/int8[n, q] eligibility, or None for all-eligible.
      seg_ids:  int32[n] table index per row (< n_tables); -1 counts nothing.
      n_tables: length of the counts vector (≤ FUSED_MAX_TABLES).
      n_queries: number of REAL queries (≤ q); columns beyond it are phantom
                and count nothing, even against all-ones row super keys.
      mode:     'sum' (eligible hits per table) | 'any' (rows with ≥1 hit).
    Returns:
      (counts int32[n_tables], key_counts int32[q]) on the inputs' device.
    """
    n, q = row_sk.shape[0], query_sk.shape[0]
    n_queries = q if n_queries is None else n_queries
    _check_counts_args("filter_table_counts", n, q, n_tables, n_queries, elig, seg_ids, mode)
    if row_sk.shape[1:] != query_sk.shape[1:]:
        raise ValueError(f"lane counts differ: rows {tuple(row_sk.shape)}, queries {tuple(query_sk.shape)}")
    if row_sk.device.type == "cpu":
        return filter_table_counts_plain(row_sk, query_sk, elig, seg_ids, n_tables, n_queries, mode)
    dev = row_sk.device
    elig = _elig_int8(elig)
    _check_cuda("filter_table_counts", dev, row_sk=(row_sk, (torch.int32,)),
                query_sk=(query_sk, (torch.int32,)), elig=(elig, (torch.int8,)),
                seg_ids=(seg_ids, (torch.int32,)))
    counts = torch.zeros(n_tables, dtype=torch.int32, device=dev)
    keys = torch.zeros(q, dtype=torch.int32, device=dev)
    if n == 0 or n_queries == 0 or n_tables == 0:
        return counts, keys
    lib = _build.load("filter_counts")
    lanes = row_sk.shape[1]
    # 'any' over several query tiles marks each row's hits here first
    row_hit = torch.zeros(n, dtype=torch.uint8, device=dev) if mode == "any" else None
    err = lib.filter_counts_launch(
        row_sk.data_ptr(), lanes, lanes, query_sk.data_ptr(), n_queries,
        _build.ptr(elig), q, seg_ids.data_ptr(), n, n_tables,
        counts.data_ptr(), keys.data_ptr(), int(mode == "any"), _build.ptr(row_hit),
        _stream(row_sk),
    )
    _build.check(err, "filter_table_counts")
    filter_table_counts.launches += 1
    return counts, keys


filter_table_counts.launches = 0


def gather_filter_table_counts_plain(
    rows, store, query_sk, elig, seg_ids, n_tables: int, n_queries: int
) -> torch.Tensor:
    """Plain version of ``gather_filter_table_counts``: gathers row chunks
    ``store[rows, :lanes]`` and counts them ('sum')."""
    lanes = query_sk.shape[1]
    dev = store.device
    counts = torch.zeros(n_tables, dtype=torch.int64, device=dev)
    keys = torch.zeros(query_sk.shape[0], dtype=torch.int64, device=dev)
    qs = query_sk[:n_queries]
    step = _plain_rows(n_queries, lanes)
    for s in range(0, rows.shape[0], step):
        e = s + step
        chunk = store[rows[s:e].long(), :lanes]
        _accumulate(chunk, qs, None if elig is None else elig[s:e],
                    seg_ids[s:e], counts, keys, False)
    return counts.to(torch.int32)


def gather_filter_table_counts(
    rows: torch.Tensor,
    store: torch.Tensor,
    query_sk: torch.Tensor,
    elig: torch.Tensor | None,
    seg_ids: torch.Tensor,
    *,
    n_tables: int,
    n_queries: int | None = None,
) -> torch.Tensor:
    """Gather-fused filter + per-table segment count (B.2).

    Args:
      rows:     int32[n] row offsets into ``store`` (the CSR candidate rows).
      store:    int32[N, lanes_s] device-resident super-key store, row-major.
      query_sk: int32[q, lanes] query super keys, ``lanes <= lanes_s`` — a
                strict prefix probes a lane-degraded filter over the
                full-width store.
      elig:     bool/int8[n, q] eligibility, or None.
      seg_ids:  int32[n] table index per row (< n_tables); -1 counts nothing.
      n_tables: length of the counts vector (≤ FUSED_MAX_TABLES).
      n_queries: number of REAL queries (≤ q).
    Returns:
      counts int32[n_tables] — the only output ('sum' semantics).

    On CUDA the kernel copies each row's lanes in 16-byte groups: the probed
    lanes and the store's width must be multiples of 4 (128, 256 or 512
    bits, every width a session takes) and the store 16-byte aligned; it
    raises ``ValueError`` on anything else.
    """
    n, q = rows.shape[0], query_sk.shape[0]
    n_queries = q if n_queries is None else n_queries
    _check_counts_args("gather_filter_table_counts", n, q, n_tables, n_queries, elig, seg_ids)
    if query_sk.shape[1] > store.shape[1]:
        raise ValueError(
            f"query lanes {query_sk.shape[1]} exceed the store's {store.shape[1]}"
        )
    if store.device.type == "cpu":
        return gather_filter_table_counts_plain(
            rows, store, query_sk, elig, seg_ids, n_tables, n_queries
        )
    dev = store.device
    elig = _elig_int8(elig)
    _check_cuda("gather_filter_table_counts", dev, rows=(rows, (torch.int32,)),
                store=(store, (torch.int32,)), query_sk=(query_sk, (torch.int32,)),
                elig=(elig, (torch.int8,)), seg_ids=(seg_ids, (torch.int32,)))
    lanes = query_sk.shape[1]
    if lanes % 4 or store.shape[1] % 4 or store.data_ptr() % 16:
        raise ValueError(
            "gather_filter_table_counts: the kernel copies 16-byte lane groups; probed lanes"
            f" ({lanes}) and store width ({store.shape[1]}) must be multiples of 4 and the"
            " store 16-byte aligned"
        )
    counts = torch.zeros(n_tables, dtype=torch.int32, device=dev)
    if n == 0 or n_queries == 0 or n_tables == 0:
        return counts
    lib = _build.load("filter_counts")
    err = lib.gather_counts_launch(
        store.data_ptr(), store.shape[1], lanes, rows.data_ptr(), query_sk.data_ptr(),
        n_queries, _build.ptr(elig), q, seg_ids.data_ptr(), n, n_tables,
        counts.data_ptr(), _stream(store),
    )
    _build.check(err, "gather_filter_table_counts")
    gather_filter_table_counts.launches += 1
    return counts


gather_filter_table_counts.launches = 0
