"""MATE inverted index with super keys (offline phase, paper §4/§5).

Port of ``repro.core.index`` for one host and one device.  The index keeps
the reference's host artifacts — ``value_lanes`` and ``superkeys`` as uint32
numpy arrays, per-value posting lists ``int64[n, 2]`` of (global_row, col) —
so that they compare byte for byte with the reference's.  What runs on the
device:

  * unique-value XASH hashing goes through the XASH kernel
    (``kernels.xash_kernel``) as 1-cell rows, where the reference runs XLA;
  * ``superkey_of_keys`` hashes the query keys through the same kernel on
    ``[n_keys, |Q|, max_len]``;
  * ``device_store()`` is the int32 ``[total_rows, lanes]`` superkey store
    the gather kernel reads, refreshed on every §5.4 mutation epoch.

Baseline hashes (``bf``, ``murmur``, …) stay host-side Python, as in the
reference.  The sharded build (``mesh=``, ``n_shards > 1``) is ROADMAP A.7.

Index updates (§5.4): ``insert_table`` appends rows/postings/super keys;
``delete_table`` tombstones; ``update_cell`` re-hashes the affected row.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import encoding, hashes, xash
from repro_torch.core import profiles as profiles_lib
from repro_torch.core.corpus import Corpus, Table
from repro_torch.device import resolve_device
from repro_torch.kernels import xash_kernel

# unique values per XASH launch: bounds the encoded block on the device (and
# the plain version's counters on the CPU)
_XASH_CHUNK = 1 << 18


def _resolve_cfg(
    corpus: Corpus, cfg: xash.XashConfig, hash_name: str,
    use_corpus_char_freq: bool,
) -> xash.XashConfig:
    """Apply the corpus-level char-frequency prior (§5.2.1) when asked."""
    if use_corpus_char_freq and hash_name == "xash":
        cfg = dataclasses.replace(
            cfg, char_freq=tuple(corpus.char_frequencies().tolist())
        )
    return cfg


def _hash_unique_values(
    values: list[str],
    enc: np.ndarray,
    cfg: xash.XashConfig,
    hash_name: str,
    avg_row_width: float,
    device: torch.device,
) -> np.ndarray:
    """uint32[n_unique, lanes] hash lanes per unique value."""
    n = len(values)
    out = np.zeros((n, cfg.lanes), dtype=np.uint32)
    if hash_name == "xash":
        for s in range(0, n, _XASH_CHUNK):
            block = torch.from_numpy(np.ascontiguousarray(enc[s : s + _XASH_CHUNK])).to(device)
            out[s : s + _XASH_CHUNK] = xash.lanes_to_numpy(
                xash_kernel.xash_values(block, cfg)
            )
        return out
    if hash_name == "bf":
        n_hash = hashes.optimal_bloom_hashes(cfg.bits, avg_row_width)
        fn = hashes.make_bloom(n_hash)
    else:
        fn = hashes.BASELINE_HASHES[hash_name]
    shift_mask = (1 << 32) - 1
    for i, v in enumerate(values):
        h = fn(v, cfg.bits)
        for lane in range(cfg.lanes):
            out[i, lane] = (h >> (32 * lane)) & shift_mask
    return out


def _aggregate_superkeys(
    cell_value_ids: np.ndarray, value_lanes: np.ndarray, lanes: int
) -> np.ndarray:
    """OR per-cell hash lanes into per-row super keys (vectorised)."""
    n_rows = cell_value_ids.shape[0]
    sk = np.zeros((n_rows, lanes), dtype=np.uint32)
    valid = cell_value_ids >= 0
    safe_ids = np.where(valid, cell_value_ids, 0)
    gathered = value_lanes[safe_ids]  # [rows, cols, lanes]
    gathered[~valid] = 0
    np.bitwise_or.reduce(gathered, axis=1, out=sk)
    return sk


def _shard_postings(
    cell_value_ids: np.ndarray, n_values: int
) -> tuple[np.ndarray, np.ndarray]:
    """Posting-list items of every row: ``(payload, counts)`` with
    ``payload`` int64[m, 2] of (global_row, col) grouped by ascending value
    id, row-major within a value id (the PL order the scalar engine fetches),
    and ``counts`` int64[n_values] items per value id."""
    rows_idx, cols_idx = np.nonzero(cell_value_ids >= 0)
    vids = cell_value_ids[rows_idx, cols_idx]
    order = np.argsort(vids, kind="stable")
    payload = np.stack([rows_idx[order], cols_idx[order]], axis=1).astype(np.int64)
    counts = np.bincount(vids, minlength=n_values).astype(np.int64)
    return payload, counts


def _intern_value(index: "MateIndex", value: str) -> int:
    """Resolve ``value`` in the corpus value arena, interning (and hashing)
    it if new — the shared §5.4 mutation primitive."""
    corpus = index.corpus
    vid = corpus.value_of.get(value)
    if vid is not None:
        return vid
    vid = len(corpus.unique_values)
    corpus.value_of[value] = vid
    corpus.unique_values.append(value)
    new_enc = encoding.encode_values([value], corpus.max_len)
    corpus.unique_enc = np.concatenate([corpus.unique_enc, new_enc])
    index.value_lanes = np.concatenate(
        [
            index.value_lanes,
            _hash_unique_values(
                [value], new_enc, index.cfg, index.hash_name,
                corpus.avg_row_width(), index.device,
            ),
        ]
    )
    return vid


def _csr_ptr(counts: np.ndarray) -> np.ndarray:
    ptr = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr


def _postings_dict(payload: np.ndarray, ptr: np.ndarray) -> dict[int, np.ndarray]:
    """Explode a CSR posting store into the per-value dict the index serves
    (entries are views into ``payload``; §5.4 mutations replace them with
    fresh arrays, never write through)."""
    postings: dict[int, np.ndarray] = {}
    for vid in range(len(ptr) - 1):
        lo, hi = int(ptr[vid]), int(ptr[vid + 1])
        if hi > lo:
            postings[vid] = payload[lo:hi]
    return postings


@dataclasses.dataclass
class BuildStats:
    """Offline-phase accounting for one ``build_index`` run (the reference's
    fields; on one host ``n_shards`` is 1 and the shard lists have one
    entry each)."""

    n_shards: int = 1
    mesh_shape: dict[str, int] | None = None  # None: no device mesh
    values_total: int = 0
    rows_total: int = 0
    bytes_hashed: int = 0  # encoded bytes fed to the unique-value hash pass
    shard_values: list[int] = dataclasses.field(default_factory=list)
    shard_rows: list[int] = dataclasses.field(default_factory=list)
    shard_hash_seconds: list[float] = dataclasses.field(default_factory=list)
    hash_seconds: float = 0.0
    superkey_seconds: float = 0.0
    postings_seconds: float = 0.0
    merge_seconds: float = 0.0
    profile_seconds: float = 0.0  # per-column ProfileStore pass (ranking)
    profile_bytes: int = 0  # ProfileStore footprint (all arrays)
    total_seconds: float = 0.0


@dataclasses.dataclass
class CandidateBlock:
    """All PL items for a set of query values, concatenated per candidate
    table (CSR layout) — the contiguous feed for one batched filter launch.

    Tables are ordered by descending item count (ties by ascending table id),
    the same order Algorithm 1 visits them, so rule-1 cutoffs apply to CSR
    prefixes.  Within a table, items keep fetch order (value-major, PL order).
    """

    rows: np.ndarray  # int64[N] global row ids, grouped by table
    value_idx: np.ndarray  # int32[N] index into the queried ``values`` list
    table_ids: np.ndarray  # int64[T] candidate table ids
    table_ptr: np.ndarray  # int64[T+1] CSR boundaries into rows/value_idx

    @property
    def n_items(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_tables(self) -> int:
        return int(self.table_ids.shape[0])


class MateIndex:
    """Inverted index + per-row super keys for one corpus, on one device."""

    def __init__(
        self,
        corpus: Corpus,
        cfg: xash.XashConfig = xash.DEFAULT_CONFIG,
        hash_name: str = "xash",
        use_corpus_char_freq: bool = False,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        cfg = _resolve_cfg(corpus, cfg, hash_name, use_corpus_char_freq)
        value_lanes = _hash_unique_values(
            corpus.unique_values, corpus.unique_enc, cfg, hash_name,
            corpus.avg_row_width(), self.device,
        )
        superkeys = _aggregate_superkeys(corpus.cell_value_ids, value_lanes, cfg.lanes)
        payload, counts = _shard_postings(corpus.cell_value_ids, len(corpus.unique_values))
        self._init(corpus, cfg, hash_name, value_lanes, superkeys, payload, _csr_ptr(counts))

    def _init(self, corpus, cfg, hash_name, value_lanes, superkeys, payload, ptr) -> None:
        self.corpus = corpus
        self.cfg = cfg
        self.hash_name = hash_name
        self.value_lanes = value_lanes
        self.superkeys = superkeys
        self.postings = _postings_dict(payload, ptr)
        self._deleted_tables: set[int] = set()
        self._mutations = 0
        self._device_store: torch.Tensor | None = None
        self._device_store_epoch = -1
        self._deleted_mask: np.ndarray | None = None
        self._deleted_mask_epoch = -1
        self._profiles: profiles_lib.ProfileStore | None = None

    @classmethod
    def _from_build(
        cls,
        corpus: Corpus,
        cfg: xash.XashConfig,
        hash_name: str,
        value_lanes: np.ndarray,
        superkeys: np.ndarray,
        payload: np.ndarray,
        ptr: np.ndarray,
        device: torch.device,
    ) -> "MateIndex":
        """Assemble an index from prebuilt artifacts (``cfg`` resolved)."""
        self = cls.__new__(cls)
        self.device = device
        self._init(corpus, cfg, hash_name, value_lanes, superkeys, payload, ptr)
        return self

    @property
    def bits(self) -> int:
        """Hash width this index was built at (128/256/512 → 4/8/16 lanes)."""
        return self.cfg.bits

    @property
    def mutation_epoch(self) -> int:
        """Monotonic count of §5.4 mutations applied to this index; anything
        derived from index state at epoch e is valid while it still holds."""
        return self._mutations

    def device_store(self) -> torch.Tensor:
        """Device-resident per-row superkey store: int32[total_rows, lanes]
        (uint32 bit patterns), row-major — the gather kernel reads each
        candidate row in place.  Re-uploaded lazily whenever
        ``mutation_epoch`` moved past the epoch of the resident copy, so a
        stale store is never served."""
        if self._device_store is None or self._device_store_epoch != self._mutations:
            self._device_store = xash.lanes_to_torch(self.superkeys, self.device)
            self._device_store_epoch = self._mutations
        return self._device_store

    # -- column profiles (ranking subsystem) ----------------------------------

    def profiles(self) -> profiles_lib.ProfileStore:
        """Per-column ``ProfileStore``, epoch-pinned like the device store."""
        if self._profiles is None or self._profiles.epoch != self._mutations:
            self._profiles = profiles_lib.build_profiles(
                self.corpus, self.value_lanes, epoch=self._mutations
            )
        return self._profiles

    def gate_candidates(
        self, distinct_keys: list[tuple[str, ...]], table_ids: np.ndarray
    ) -> np.ndarray:
        """Profile gate: bool[n] keep-mask over candidate table ids (False
        only where the profiles PROVE joinability 0)."""
        kvi, probe, len_bucket, vclass = profiles_lib.query_gate_inputs(
            distinct_keys, self.hash_values
        )
        return profiles_lib.gate_tables(
            self.profiles(),
            np.asarray(table_ids, dtype=np.int64),
            kvi, probe, len_bucket, vclass, len(distinct_keys[0]),
        )

    def profile_features(
        self, table_ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Scoring-head feature gather: (card_max, n_rows, sketch) rows."""
        store = self.profiles()
        ids = np.asarray(table_ids, dtype=np.int64)
        return store.card_max[ids], store.n_rows[ids], store.sketch[ids]

    # -- online-side hashing --------------------------------------------------

    def hash_values(self, values: list[str]) -> np.ndarray:
        """Hash arbitrary (query-side) strings with this index's hash fn."""
        enc = encoding.encode_values(values, self.cfg.max_len)
        return _hash_unique_values(
            values, enc, self.cfg, self.hash_name, self.corpus.avg_row_width(),
            self.device,
        )

    def superkey_of_keys(self, keys: list[tuple[str, ...]]) -> np.ndarray:
        """Batched query-side key hashing: uint32[len(keys), lanes].

        For XASH the whole key set is one ``[n_keys, |Q|, max_len]`` block
        through the XASH kernel; baseline hashes OR per-value hashes.  Every
        key must have the same width: ragged widths raise ``ValueError``.
        """
        lanes = self.cfg.lanes
        if not keys:
            return np.zeros((0, lanes), dtype=np.uint32)
        width = len(keys[0])
        for i, key in enumerate(keys):
            if len(key) != width:
                raise ValueError(
                    f"ragged key widths: key 0 has {width} value(s) but key"
                    f" {i} has {len(key)} — superkey_of_keys hashes one"
                    " fixed-width n-ary query key set per call"
                )
        if self.hash_name == "xash":
            flat = [v for key in keys for v in key]
            enc = encoding.encode_values(flat, self.cfg.max_len)
            enc = enc.reshape(len(keys), width, self.cfg.max_len)
            sk = xash_kernel.xash_superkey(torch.from_numpy(enc).to(self.device), self.cfg)
            return xash.lanes_to_numpy(sk)
        flat_values = sorted({v for key in keys for v in key})
        value_lanes = self.hash_values(flat_values)
        lane_of = {v: value_lanes[i] for i, v in enumerate(flat_values)}
        out = np.zeros((len(keys), lanes), dtype=np.uint32)
        for i, key in enumerate(keys):
            for v in key:
                out[i] |= lane_of[v]
        return out

    # -- lookups --------------------------------------------------------------

    def _deleted_row_mask(self) -> np.ndarray:
        """bool[total_rows] — True for rows of tombstoned tables (cached on
        ``mutation_epoch``)."""
        if self._deleted_mask_epoch != self._mutations:
            mask = np.zeros(self.corpus.total_rows, dtype=bool)
            rb = self.corpus.row_base
            for t in self._deleted_tables:
                mask[int(rb[t]) : int(rb[t + 1])] = True
            self._deleted_mask = mask
            self._deleted_mask_epoch = self._mutations
        return self._deleted_mask

    def fetch_postings(self, value: str) -> np.ndarray:
        """PL items for a value: int64[n, 2] of (global_row, col)."""
        vid = self.corpus.value_of.get(value)
        if vid is None or vid not in self.postings:
            return np.zeros((0, 2), dtype=np.int64)
        pl = self.postings[vid]
        if self._deleted_tables:
            pl = pl[~self._deleted_row_mask()[pl[:, 0]]]
        return pl

    def superkey_of_rows(self, global_rows: np.ndarray) -> np.ndarray:
        """Block gather of per-row super keys: uint32[len(global_rows), lanes]."""
        return self.superkeys[np.asarray(global_rows, dtype=np.int64)]

    def gather_candidates(self, values: list[str]) -> CandidateBlock:
        """Concatenate the posting lists of ``values`` into one CSR block."""
        parts_rows: list[np.ndarray] = []
        parts_vidx: list[np.ndarray] = []
        for i, value in enumerate(values):
            pl = self.fetch_postings(value)
            if len(pl):
                parts_rows.append(pl[:, 0])
                parts_vidx.append(np.full(len(pl), i, dtype=np.int32))
        if not parts_rows:
            return CandidateBlock(
                rows=np.zeros(0, dtype=np.int64),
                value_idx=np.zeros(0, dtype=np.int32),
                table_ids=np.zeros(0, dtype=np.int64),
                table_ptr=np.zeros(1, dtype=np.int64),
            )
        rows = np.concatenate(parts_rows)
        vidx = np.concatenate(parts_vidx)
        tids = np.asarray(self.corpus.table_of_row(rows), dtype=np.int64)
        uniq, inv, counts = np.unique(tids, return_inverse=True, return_counts=True)
        # Algorithm 1 visit order: descending item count, ties by table id.
        order = np.lexsort((uniq, -counts))
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[order] = np.arange(len(uniq))
        perm = np.argsort(rank[inv], kind="stable")
        counts_sorted = counts[order]
        ptr = np.zeros(len(uniq) + 1, dtype=np.int64)
        np.cumsum(counts_sorted, out=ptr[1:])
        return CandidateBlock(
            rows=rows[perm],
            value_idx=vidx[perm],
            table_ids=uniq[order],
            table_ptr=ptr,
        )

    # -- index updates (§5.4) ---------------------------------------------------

    def insert_table(self, cells: list[list[str]], name: str = "") -> int:
        """Append a new table; returns its table id."""
        self._mutations += 1
        corpus = self.corpus
        table = Table(table_id=len(corpus.tables), cells=cells, name=name)
        n_rows, n_cols = table.n_rows, table.n_cols
        if n_cols > corpus.max_cols:
            pad = n_cols - corpus.max_cols
            corpus.cell_value_ids = np.pad(
                corpus.cell_value_ids, ((0, 0), (0, pad)), constant_values=-1
            )
            corpus.max_cols = n_cols
        corpus.tables.append(table)
        corpus.row_base = np.append(corpus.row_base, corpus.row_base[-1] + n_rows)
        corpus.n_cols = np.append(corpus.n_cols, n_cols)
        base = corpus.total_rows
        corpus.total_rows += n_rows

        new_ids = np.full((n_rows, corpus.max_cols), -1, dtype=np.int32)
        new_value_strs: list[str] = []
        for r, row in enumerate(cells):
            for c, v in enumerate(row):
                vid = corpus.value_of.get(v)
                if vid is None:
                    vid = len(corpus.unique_values)
                    corpus.value_of[v] = vid
                    corpus.unique_values.append(v)
                    new_value_strs.append(v)
                new_ids[r, c] = vid
        if new_value_strs:
            new_enc = encoding.encode_values(new_value_strs, corpus.max_len)
            corpus.unique_enc = np.concatenate([corpus.unique_enc, new_enc])
            new_lanes = _hash_unique_values(
                new_value_strs, new_enc, self.cfg, self.hash_name,
                corpus.avg_row_width(), self.device,
            )
            self.value_lanes = np.concatenate([self.value_lanes, new_lanes])
        corpus.cell_value_ids = np.concatenate([corpus.cell_value_ids, new_ids])
        new_sk = _aggregate_superkeys(new_ids, self.value_lanes, self.cfg.lanes)
        self.superkeys = np.concatenate([self.superkeys, new_sk])
        for r in range(n_rows):
            for c in range(len(cells[r])):
                vid = new_ids[r, c]
                item = np.array([[base + r, c]], dtype=np.int64)
                self.postings[vid] = (
                    np.concatenate([self.postings[vid], item])
                    if vid in self.postings
                    else item
                )
        return table.table_id

    def delete_table(self, table_id: int) -> None:
        """Tombstone a table (PL items filtered at fetch; §5.4 delete)."""
        self._mutations += 1
        self._deleted_tables.add(table_id)
        lo, hi = self.corpus.row_base[table_id], self.corpus.row_base[table_id + 1]
        self.superkeys[lo:hi] = 0

    def update_cell(self, table_id: int, row: int, col: int, value: str) -> None:
        """Update one cell: re-hash the affected row's super key (§5.4)."""
        self._mutations += 1
        corpus = self.corpus
        grow = int(corpus.row_base[table_id]) + row
        old_vid = int(corpus.cell_value_ids[grow, col])
        vid = _intern_value(self, value)
        corpus.tables[table_id].cells[row][col] = value
        corpus.cell_value_ids[grow, col] = vid
        if old_vid in self.postings:
            pl = self.postings[old_vid]
            keep = ~((pl[:, 0] == grow) & (pl[:, 1] == col))
            self.postings[old_vid] = pl[keep]
        item = np.array([[grow, col]], dtype=np.int64)
        self.postings[vid] = (
            np.concatenate([self.postings[vid], item]) if vid in self.postings else item
        )
        self.superkeys[grow] = _aggregate_superkeys(
            corpus.cell_value_ids[grow : grow + 1], self.value_lanes, self.cfg.lanes
        )[0]


def index_artifacts_equal(a, b) -> bool:
    """True iff every offline artifact is byte-identical: value hash lanes
    (incl. dtype), per-row super keys, and per-value posting lists.  Works
    across the two packages (it reads only the numpy artifacts)."""
    return (
        a.value_lanes.dtype == b.value_lanes.dtype
        and np.array_equal(a.value_lanes, b.value_lanes)
        and np.array_equal(a.superkeys, b.superkeys)
        and set(a.postings) == set(b.postings)
        and all(
            a.postings[v].dtype == b.postings[v].dtype
            and np.array_equal(a.postings[v], b.postings[v])
            for v in b.postings
        )
    )


def index_from_arrays(
    corpus: Corpus,
    cfg: xash.XashConfig,
    hash_name: str,
    value_lanes: np.ndarray,
    superkeys: np.ndarray,
    payload: np.ndarray,
    ptr: np.ndarray,
    *,
    device=None,
) -> MateIndex:
    """An index from prebuilt artifacts — the counterpart of the reference's
    ``MateIndex._from_build``: a reference index's numpy arrays (with its
    corpus's cells) become the port's index, so the online path can be held
    to the reference independently of the build.  ``cfg`` must be resolved."""
    return MateIndex._from_build(
        corpus, cfg, hash_name, value_lanes, superkeys, payload, ptr,
        resolve_device(device),
    )


def build_index(
    corpus: Corpus,
    cfg: xash.XashConfig = xash.DEFAULT_CONFIG,
    hash_name: str = "xash",
    use_corpus_char_freq: bool = False,
    *,
    mesh=None,
    row_axes: tuple[str, ...] | None = None,
    n_shards: int | None = None,
    device=None,
) -> tuple[MateIndex, BuildStats]:
    """Offline phase (§4/§5) on one host, plus build accounting.

    Artifacts are byte-identical to ``MateIndex(corpus, ...)`` and to the
    reference's ``build_index``.  Profiles are built eagerly.  ``mesh`` and
    ``n_shards > 1`` (the sharded build) are ROADMAP A.7 and raise.

    Returns ``(index, BuildStats)``.
    """
    if mesh is not None or row_axes is not None or (n_shards or 1) > 1:
        raise NotImplementedError(
            "sharded build (mesh=, row_axes=, n_shards>1) is not ported yet: ROADMAP A.7"
        )
    t_start = time.perf_counter()
    dev = resolve_device(device)
    cfg = _resolve_cfg(corpus, cfg, hash_name, use_corpus_char_freq)
    n_values = len(corpus.unique_values)
    stats = BuildStats(
        values_total=n_values,
        rows_total=corpus.total_rows,
        bytes_hashed=int(corpus.unique_enc.size),
        shard_values=[n_values],
        shard_rows=[corpus.total_rows],
    )

    t0 = time.perf_counter()
    value_lanes = _hash_unique_values(
        corpus.unique_values, corpus.unique_enc, cfg, hash_name,
        corpus.avg_row_width(), dev,
    )
    stats.hash_seconds = time.perf_counter() - t0
    stats.shard_hash_seconds.append(stats.hash_seconds)

    t0 = time.perf_counter()
    superkeys = _aggregate_superkeys(corpus.cell_value_ids, value_lanes, cfg.lanes)
    stats.superkey_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload, counts = _shard_postings(corpus.cell_value_ids, n_values)
    stats.postings_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    index = MateIndex._from_build(
        corpus, cfg, hash_name, value_lanes, superkeys, payload, _csr_ptr(counts), dev
    )
    stats.merge_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    index._profiles = profiles_lib.build_profiles(corpus, value_lanes)
    stats.profile_seconds = time.perf_counter() - t0
    stats.profile_bytes = index._profiles.nbytes

    stats.total_seconds = time.perf_counter() - t_start
    return index, stats
