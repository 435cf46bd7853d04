"""Per-column profiles for ranked discovery (ROADMAP item 3).

Copy of ``repro.core.profiles`` (numpy only): the port keeps its own so that it
imports nothing of the reference package.

Offline, every table gets a compact profile computed straight from the
corpus arenas and the already-hashed unique-value lanes:

  * **presence masks** — a Bloom-style bitmask over the table's distinct
    value hashes plus occupied value-length-bucket / char-class bitmasks.
    A bitmask can prove *absence* (no false negatives): if a query value's
    probe bits are not all set, that value appears nowhere in the table.
    That is what makes the pre-index gate sound (pure pruning).
  * **cardinality** — distinct-value count per column and the per-table
    max, the cheap join-quality signal of "Measuring and Predicting the
    Quality of a Join": a candidate column whose cardinality approaches
    its row count joins key-like (low multiplicity).
  * **min-hash sketch** — ``SKETCH_K`` minima of salted value hashes over
    the table's distinct values; matching positions against a query-side
    sketch estimate value-set Jaccard for the scoring head.

Profiles are built per contiguous table range so the sharded offline
build produces byte-identical stores to the single-host pass (same
contract as the postings merge), and ``ShardedMateIndex`` keeps one
store per shard, epoch-pinned like the device superkey store.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.corpus import Corpus

LEN_BUCKETS = 16  # value length, clipped into bucket min(len, 15)
N_CLASSES = 4  # 0=digits-only 1=alpha-only 2=other-alnum 3=mixed/other
SKETCH_K = 16  # min-hash lanes per sketch
MASK_WORDS = 8  # 256-bit per-table value-presence mask
MASK_BITS = MASK_WORDS * 32
N_PROBES = 2  # Bloom probes per value

# Deterministic salt streams for the sketch lanes (odd multipliers so the
# maps are bijections on uint32 — minima stay uniformly distributed).
_SKETCH_MULT = (
    np.uint32(2654435761) * (2 * np.arange(SKETCH_K, dtype=np.uint32) + 1)
)
_SKETCH_ADD = np.uint32(0x9E3779B9) * np.arange(SKETCH_K, dtype=np.uint32)
_EMPTY_SKETCH = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass
class ProfileStore:
    """Column/table profiles for tables ``[table_lo, table_hi)``.

    Per-column arrays are CSR-packed by ``col_ptr`` (one entry per table
    column, tables in id order) so shard stores concatenate into exactly
    the single-host store.
    """

    table_lo: int
    table_hi: int
    epoch: int  # mutation epoch the store was built at
    # per-table
    mask: np.ndarray  # uint32[n_tables, MASK_WORDS] value-presence Bloom
    len_mask: np.ndarray  # uint32[n_tables] occupied length buckets
    class_mask: np.ndarray  # uint32[n_tables] occupied char classes
    n_rows: np.ndarray  # int32[n_tables]
    n_cols: np.ndarray  # int32[n_tables]
    card_max: np.ndarray  # int32[n_tables] max column cardinality
    sketch: np.ndarray  # uint32[n_tables, SKETCH_K] min-hash over values
    # per-column (CSR by col_ptr)
    col_ptr: np.ndarray  # int64[n_tables + 1]
    col_cardinality: np.ndarray  # int32[total_cols]
    col_len_hist: np.ndarray  # int32[total_cols, LEN_BUCKETS]
    col_class_hist: np.ndarray  # int32[total_cols, N_CLASSES]

    @property
    def n_tables(self) -> int:
        return self.table_hi - self.table_lo

    @property
    def nbytes(self) -> int:
        return sum(
            getattr(self, f.name).nbytes
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)
        )


def value_class(value: str) -> int:
    """Char-class bucket of a value (necessary-condition signature: a value
    present in a table must have its class bit set in the table mask)."""
    if value.isdigit():
        return 0
    if value.isalpha():
        return 1
    if value.isalnum():
        return 2
    return 3


def value_signatures(
    values: list[str], lanes: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-value (probe bit positions, length bucket, char class).

    ``lanes`` must come from the SAME hash function that produced the
    store's ``value_lanes`` (``MateIndex.hash_values``) — equal strings
    then probe exactly the bits the build set, which is the no-false-
    negative property the gate's soundness rests on.
    """
    n = len(values)
    len_bucket = np.fromiter(
        (min(len(v), LEN_BUCKETS - 1) for v in values), dtype=np.int64, count=n
    )
    vclass = np.fromiter(
        (value_class(v) for v in values), dtype=np.int64, count=n
    )
    probe = _probe_positions(lanes)
    return probe, len_bucket, vclass


def _probe_positions(lanes: np.ndarray) -> np.ndarray:
    """Double-hashed Bloom probe positions: int64[n_values, N_PROBES]."""
    h1 = lanes[:, 0].astype(np.uint32)
    h2 = lanes[:, 1].astype(np.uint32) | np.uint32(1)
    k = np.arange(N_PROBES, dtype=np.uint32)
    return ((h1[:, None] + k[None, :] * h2[:, None]) % MASK_BITS).astype(
        np.int64
    )


def value_sketch(lane0: np.ndarray) -> np.ndarray:
    """Min-hash sketch of a value set from its lane-0 hashes: uint32[K]."""
    if lane0.shape[0] == 0:
        return np.full(SKETCH_K, _EMPTY_SKETCH, dtype=np.uint32)
    h = lane0.astype(np.uint32)[:, None] * _SKETCH_MULT[None, :]
    h = h + _SKETCH_ADD[None, :]
    return h.min(axis=0)


def build_profiles(
    corpus: Corpus,
    value_lanes: np.ndarray,
    table_lo: int = 0,
    table_hi: int | None = None,
    epoch: int = 0,
) -> ProfileStore:
    """Profile tables ``[table_lo, table_hi)`` from the corpus arenas.

    Everything derives from per-unique-value metadata (length bucket,
    char class, probe bits, sketch salts) gathered through
    ``cell_value_ids`` — no per-table Python loops, and no dependence on
    how the caller shards the table range (concatenating shard stores is
    byte-identical to one full-range build).
    """
    rb = corpus.row_base
    n_total = len(rb) - 1
    if table_hi is None:
        table_hi = n_total
    nt = table_hi - table_lo
    max_cols = corpus.max_cols

    # -- per-unique-value metadata (shared by every table range) ------------
    vals = corpus.unique_values
    nv = len(vals)
    len_bucket = np.fromiter(
        (min(len(v), LEN_BUCKETS - 1) for v in vals), dtype=np.int64, count=nv
    )
    vclass = np.fromiter(
        (value_class(v) for v in vals), dtype=np.int64, count=nv
    )
    probe = _probe_positions(value_lanes) if nv else np.zeros(
        (0, N_PROBES), dtype=np.int64
    )

    n_cols = corpus.n_cols[table_lo:table_hi].astype(np.int32)
    n_rows = (rb[table_lo + 1 : table_hi + 1] - rb[table_lo:table_hi]).astype(
        np.int32
    )
    col_ptr = np.zeros(nt + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_ptr[1:])
    total_cols = int(col_ptr[-1])

    mask = np.zeros((nt, MASK_WORDS), dtype=np.uint32)
    len_mask = np.zeros(nt, dtype=np.uint32)
    class_mask = np.zeros(nt, dtype=np.uint32)
    card_max = np.zeros(nt, dtype=np.int32)
    sketch = np.full((nt, SKETCH_K), _EMPTY_SKETCH, dtype=np.uint32)
    col_cardinality = np.zeros(total_cols, dtype=np.int32)
    col_len_hist = np.zeros((total_cols, LEN_BUCKETS), dtype=np.int32)
    col_class_hist = np.zeros((total_cols, N_CLASSES), dtype=np.int32)

    row_lo, row_hi = int(rb[table_lo]), int(rb[table_hi])
    ids = corpus.cell_value_ids[row_lo:row_hi]
    rel_rows, cols = np.nonzero(ids >= 0)
    if rel_rows.shape[0]:
        vids = ids[rel_rows, cols].astype(np.int64)
        tids = (
            np.searchsorted(rb, rel_rows + row_lo, side="right") - 1 - table_lo
        )

        # distinct (table, column, value) triples -> per-column stats
        colkey = (tids * max_cols + cols).astype(np.int64)
        upair = np.unique((colkey << 32) | vids)
        p_vid = upair & np.int64(0xFFFFFFFF)
        p_col = upair >> 32
        p_tid = p_col // max_cols
        col_idx = col_ptr[p_tid] + (p_col % max_cols)
        np.add.at(col_cardinality, col_idx, 1)
        np.add.at(col_len_hist, (col_idx, len_bucket[p_vid]), 1)
        np.add.at(col_class_hist, (col_idx, vclass[p_vid]), 1)
        np.maximum.at(card_max, p_tid, col_cardinality[col_idx])

        # distinct (table, value) pairs -> presence masks + sketch
        utv = np.unique((tids << 32) | vids)
        t_vid = utv & np.int64(0xFFFFFFFF)
        t_tid = utv >> 32
        one = np.uint32(1)
        for p in range(N_PROBES):
            pos = probe[t_vid, p]
            np.bitwise_or.at(
                mask,
                (t_tid, pos // 32),
                np.left_shift(one, (pos % 32).astype(np.uint32)),
            )
        np.bitwise_or.at(
            len_mask, t_tid, np.left_shift(one, len_bucket[t_vid].astype(np.uint32))
        )
        np.bitwise_or.at(
            class_mask, t_tid, np.left_shift(one, vclass[t_vid].astype(np.uint32))
        )
        h1 = value_lanes[t_vid, 0].astype(np.uint32)
        for k in range(SKETCH_K):
            np.minimum.at(
                sketch[:, k], t_tid, h1 * _SKETCH_MULT[k] + _SKETCH_ADD[k]
            )

    return ProfileStore(
        table_lo=table_lo,
        table_hi=table_hi,
        epoch=epoch,
        mask=mask,
        len_mask=len_mask,
        class_mask=class_mask,
        n_rows=n_rows,
        n_cols=n_cols,
        card_max=card_max,
        sketch=sketch,
        col_ptr=col_ptr,
        col_cardinality=col_cardinality,
        col_len_hist=col_len_hist,
        col_class_hist=col_class_hist,
    )


def merge_profiles(parts: list[ProfileStore], epoch: int = 0) -> ProfileStore:
    """Concatenate contiguous shard stores into one full-range store.

    Deterministic by construction — every array is per-table or CSR over
    tables, so this is pure concatenation (the sharded-build analogue of
    ``merge_shard_postings``).
    """
    assert parts, "merge_profiles needs at least one shard store"
    for a, b in zip(parts, parts[1:]):
        assert a.table_hi == b.table_lo, "shard stores must be contiguous"
    col_ptr = parts[0].col_ptr
    for p in parts[1:]:
        col_ptr = np.concatenate([col_ptr, p.col_ptr[1:] + col_ptr[-1]])
    cat = lambda name: np.concatenate([getattr(p, name) for p in parts])
    return ProfileStore(
        table_lo=parts[0].table_lo,
        table_hi=parts[-1].table_hi,
        epoch=epoch,
        mask=cat("mask"),
        len_mask=cat("len_mask"),
        class_mask=cat("class_mask"),
        n_rows=cat("n_rows"),
        n_cols=cat("n_cols"),
        card_max=cat("card_max"),
        sketch=cat("sketch"),
        col_ptr=col_ptr,
        col_cardinality=cat("col_cardinality"),
        col_len_hist=cat("col_len_hist"),
        col_class_hist=cat("col_class_hist"),
    )


def profiles_equal(a: ProfileStore, b: ProfileStore) -> bool:
    """Byte-level store equality (the determinism contract's definition)."""
    return all(
        np.array_equal(getattr(a, f.name), getattr(b, f.name))
        and getattr(a, f.name).dtype == getattr(b, f.name).dtype
        for f in dataclasses.fields(a)
        if isinstance(getattr(a, f.name), np.ndarray)
    ) and (a.table_lo, a.table_hi) == (b.table_lo, b.table_hi)


def gate_tables(
    store: ProfileStore,
    local_ids: np.ndarray,
    key_value_idx: np.ndarray,
    probe: np.ndarray,
    len_bucket: np.ndarray,
    vclass: np.ndarray,
    width: int,
) -> np.ndarray:
    """bool[n] — False iff the table PROVABLY cannot join any query key.

    A key (v_1..v_w) matching a row of table T requires every v_i to be
    present in T in one of w distinct columns, so three necessary
    conditions gate T: (1) T has >= w columns; (2) every v_i's Bloom
    probe bits are set in T's presence mask; (3) every v_i's length
    bucket and char class are occupied somewhere in T.  Each is exact on
    the negative side (the build set every bit for every present value),
    so a False here means joinability 0 — dropping the table cannot
    change the verified top-k (pure pruning).  ``local_ids`` are
    store-relative (``table_id - store.table_lo``).
    """
    if local_ids.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    m = store.mask[local_ids]  # [T, MASK_WORDS]
    # [T, V, P]: probe bit p of value v present in table t
    present = (m[:, probe // 32] >> (probe % 32).astype(np.uint32)) & 1
    ok_value = present.all(axis=2).astype(bool)
    ok_value &= (
        (store.len_mask[local_ids][:, None] >> len_bucket[None, :]) & 1
    ).astype(bool)
    ok_value &= (
        (store.class_mask[local_ids][:, None] >> vclass[None, :]) & 1
    ).astype(bool)
    keep = ok_value[:, key_value_idx].all(axis=2).any(axis=1)
    keep &= store.n_cols[local_ids] >= width
    return keep


def query_gate_inputs(
    distinct_keys: list[tuple[str, ...]], hash_fn
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Precompute the query side of ``gate_tables`` once per plan.

    Returns ``(key_value_idx[int64, n_keys, width], probe, len_bucket,
    vclass)`` over the deduplicated key-value vocabulary; ``hash_fn`` is
    the owning index's ``hash_values``.
    """
    uniq = list(dict.fromkeys(v for key in distinct_keys for v in key))
    probe, len_bucket, vclass = value_signatures(uniq, hash_fn(uniq))
    vidx = {v: i for i, v in enumerate(uniq)}
    key_value_idx = np.array(
        [[vidx[v] for v in key] for key in distinct_keys], dtype=np.int64
    )
    return key_value_idx, probe, len_bucket, vclass
