"""Routed multi-shard index: per-shard ownership + count-merge query routing.

Port of ``repro.core.routing``.  Each shard's state stays RESIDENT where it
was built and queries are routed to the data:

  * ``MateShard`` — one shard's postings, superkey slice and epoch-pinned
    device store (an int32 tensor on the shard's device, re-uploaded only
    when THAT shard's epoch moves).  Shards own contiguous ascending row
    ranges SNAPPED TO TABLE BOUNDARIES, so every table is wholly owned by
    exactly one shard.
  * ``ShardedMateIndex`` — duck-types ``MateIndex`` for the engines and the
    serving tier, but holds NO global superkey array and NO global device
    store.  The §6.3 filter runs as shard-local counts-only launches — on
    the card kernel B.2 against each shard's own store under the gather
    backends, B.1 under 'fused' or with a store over budget, and kernel B.4
    with a torch ``index_add_`` past the fused kernels' table cap (ROADMAP
    C.11; the reference runs host numpy there) — and only per-table count
    vectors are merged across shards.  Phase-B verification re-gathers
    surviving tables' superkey slices from the owning shard only.  §5.4
    mutations apply shard-locally: per-shard ``mutation_epoch``, so an
    update refreshes one shard's device store, never the lake's.

The routed invariant: NO superkey row ever crosses a shard boundary on the
filter path — the cross-shard traffic is exactly
``DiscoveryStats.route_bytes_merged`` bytes of int32 counts, over
``DiscoveryStats.shard_launches`` launches.  Whole-table ownership makes the
count merge a plain sum, bit-identical to the single-host counts vector.

Mesh mode (``attach_mesh``): one process per shard (``launch.mesh``); every
rank plans the same query, launches over its own shard's items against its
own store, and the counts are all-reduced
(``core.distributed.routed_filter_counts_mesh``).  Without a mesh the shards
launch host-routed, one launch per owning shard.  Both modes give the same
counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch.core import distributed
from repro_torch.core import profiles as profiles_lib
from repro_torch.core import xash
from repro_torch.core.corpus import Corpus, Table
from repro_torch.core.index import (
    BuildStats,
    MateIndex,
    _aggregate_superkeys,
    _csr_ptr,
    _hash_unique_values,
    _intern_value,
    _postings_dict,
    _resolve_cfg,
    _shard_postings,
    _sharded_hash_pass,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, registry
from repro_torch.kernels.registry import Backend

_LOG = logging.getLogger(__name__)


def table_aligned_bounds(row_base: np.ndarray, n_shards: int) -> np.ndarray:
    """int64[n_shards+1] contiguous row bounds over ``row_base`` tables,
    balanced like ``distributed.shard_bounds`` but SNAPPED UP to the next
    table boundary — every table's rows land wholly inside one shard."""
    row_base = np.asarray(row_base, dtype=np.int64)
    total = int(row_base[-1])
    ideal = distributed.shard_bounds(total, n_shards)
    bounds = np.zeros(n_shards + 1, dtype=np.int64)
    for i in range(1, n_shards):
        t = int(np.searchsorted(row_base, ideal[i], side="left"))
        t = min(t, len(row_base) - 1)
        bounds[i] = max(int(row_base[t]), int(bounds[i - 1]))
    bounds[n_shards] = total
    return bounds


def shard_devices(devices=None, device=None) -> list[torch.device]:
    """The devices shards are placed on, round-robin: ``devices`` as given,
    else every visible card when ``device`` resolves to CUDA without an
    index and several are visible, else ``[resolve_device(device)]`` — never
    the CPU unless the caller asks for it."""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _on(device: torch.device):
    """Make ``device`` current for kernel launches (CUDA), or do nothing."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@dataclasses.dataclass
class MateShard:
    """One shard's resident state: rows [row_lo, row_hi) of the corpus —
    whole tables [table_lo, table_hi) — with the shard's own superkey slice,
    posting lists (GLOBAL row ids, shard-local membership) and an
    epoch-pinned device store.  Mutations bump ``_mutations`` (this shard's
    epoch) only; other shards' stores stay untouched."""

    shard_id: int
    row_lo: int
    row_hi: int
    table_lo: int
    table_hi: int
    superkeys: np.ndarray  # uint32[row_hi-row_lo, lanes]
    postings: dict[int, np.ndarray]  # value id -> int64[m, 2] (global row, col)
    device: torch.device  # where this shard's store lives and launches run
    _mutations: int = 0
    _store: torch.Tensor | None = None
    _store_epoch: int = -1
    _deleted_tables: set = dataclasses.field(default_factory=set)
    _deleted_mask: np.ndarray | None = None
    _deleted_mask_epoch: int = -1
    # this shard's column-profile store, epoch-pinned to THIS shard's
    # mutations exactly like the device store
    _profiles: profiles_lib.ProfileStore | None = None

    @property
    def n_rows(self) -> int:
        return self.row_hi - self.row_lo

    @property
    def mutation_epoch(self) -> int:
        """Monotonic count of §5.4 mutations applied TO THIS SHARD."""
        return self._mutations

    def owns_table(self, table_id: int) -> bool:
        return self.table_lo <= table_id < self.table_hi

    def device_store(self) -> torch.Tensor:
        """This shard's device-resident superkey store, int32[n_rows, lanes]
        (uint32 bit patterns), re-uploaded lazily when (and only when) THIS
        shard's mutation epoch moved — the per-shard counterpart of
        ``MateIndex.device_store``."""
        if self._store is None or self._store_epoch != self._mutations:
            self._store = xash.lanes_to_torch(self.superkeys, self.device)
            self._store_epoch = self._mutations
        return self._store


class ShardedMateIndex:
    """Routed multi-shard index, duck-typing ``MateIndex`` for the engines.

    The engines detect the routed path via the ``routed`` class attribute
    and divert their filter launches to ``routed_counts`` BEFORE touching
    any global-array surface (there is none here: superkeys live per shard).
    Everything row-free — query-key hashing, candidate CSR assembly, the
    Algorithm 1 visit order — reuses ``MateIndex``'s own methods unchanged,
    so the two index types cannot drift apart on query semantics.
    ``device`` is where query keys and new values are hashed (kernel B.3)
    and the ranking head runs; each shard carries its own.
    """

    routed = True

    def __init__(
        self,
        corpus: Corpus,
        cfg: xash.XashConfig = xash.DEFAULT_CONFIG,
        hash_name: str = "xash",
        use_corpus_char_freq: bool = False,
        n_shards: int = 2,
        devices: list | None = None,
        *,
        device=None,
    ):
        dev = resolve_device(device)
        cfg = _resolve_cfg(corpus, cfg, hash_name, use_corpus_char_freq)
        value_lanes = _hash_unique_values(
            corpus.unique_values, corpus.unique_enc, cfg, hash_name,
            corpus.avg_row_width(), dev,
        )
        self._init_from_parts(
            corpus, cfg, hash_name, value_lanes, n_shards,
            shard_devices(devices, device), dev,
        )

    def _init_from_parts(
        self, corpus, cfg, hash_name, value_lanes, n_shards, devices, device
    ) -> None:
        """Shared constructor tail: per-shard superkeys + postings from the
        replicated value-hash arena (``build_routed_index`` seam)."""
        self.corpus = corpus
        self.cfg = cfg
        self.hash_name = hash_name
        self.value_lanes = value_lanes
        self.device = device
        n_shards = max(int(n_shards), 1)
        n_values = len(corpus.unique_values)
        bounds = table_aligned_bounds(corpus.row_base, n_shards)
        table_bounds = np.searchsorted(corpus.row_base, bounds)
        self.shards: list[MateShard] = []
        for i in range(n_shards):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            payload, counts = _shard_postings(corpus.cell_value_ids, lo, hi, n_values)
            self.shards.append(
                MateShard(
                    shard_id=i,
                    row_lo=lo,
                    row_hi=hi,
                    table_lo=int(table_bounds[i]),
                    table_hi=int(table_bounds[i + 1]),
                    superkeys=_aggregate_superkeys(
                        corpus.cell_value_ids[lo:hi], value_lanes, cfg.lanes
                    ),
                    postings=_postings_dict(payload, _csr_ptr(counts)),
                    device=devices[i % len(devices)],
                )
            )
        self._mesh = None

    @classmethod
    def _from_build(
        cls, corpus, cfg, hash_name, value_lanes, n_shards, devices, device
    ) -> "ShardedMateIndex":
        """Assemble from a prebuilt (possibly group-hashed) value arena —
        the ``build_routed_index`` seam.  ``cfg`` must be resolved."""
        self = cls.__new__(cls)
        self._init_from_parts(
            corpus, cfg, hash_name, value_lanes, n_shards, devices, device
        )
        return self

    # -- MateIndex duck-type surface (row-free paths reused verbatim) -------

    hash_values = MateIndex.hash_values
    superkey_of_keys = MateIndex.superkey_of_keys
    gather_candidates = MateIndex.gather_candidates

    @property
    def bits(self) -> int:
        return self.cfg.bits

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def shard_row_bounds(self) -> np.ndarray:
        """int64[n_shards+1] — the contiguous ascending ownership bounds."""
        return np.asarray(
            [self.shards[0].row_lo] + [s.row_hi for s in self.shards],
            dtype=np.int64,
        )

    @property
    def mutation_epoch(self) -> int:
        """Aggregate §5.4 epoch: the SUM of per-shard epochs — monotonic, so
        everything keyed on it (serve caches, ``PlanCounts.epoch``)
        invalidates exactly when any shard changed.  Which store actually
        re-uploads is tracked per shard."""
        return sum(s.mutation_epoch for s in self.shards)

    def shard_of_table(self, table_id: int) -> MateShard:
        """The one shard owning ``table_id`` (whole-table ownership)."""
        rb = int(self.corpus.row_base[table_id])
        return self.shards[self._shard_ids_of_rows(np.asarray([rb]))[0]]

    def _shard_ids_of_rows(self, global_rows: np.ndarray) -> np.ndarray:
        bounds = self.shard_row_bounds
        sid = np.searchsorted(bounds, np.asarray(global_rows), side="right") - 1
        return np.clip(sid, 0, len(self.shards) - 1).astype(np.int64)

    # -- lookups ------------------------------------------------------------

    def fetch_postings(self, value: str) -> np.ndarray:
        """PL items for a value, shard-merged: int64[n, 2] (global row, col).

        Shards cover contiguous ascending row ranges, so concatenating their
        per-value slices in shard order IS the global row-major PL order —
        bit-identical to ``MateIndex.fetch_postings``.
        """
        vid = self.corpus.value_of.get(value)
        if vid is None:
            return np.zeros((0, 2), dtype=np.int64)
        parts = []
        for s in self.shards:
            pl = s.postings.get(vid)
            if pl is None:
                continue
            if s._deleted_tables:
                pl = pl[~self._shard_deleted_mask(s)[pl[:, 0] - s.row_lo]]
            if len(pl):
                parts.append(pl)
        if not parts:
            return np.zeros((0, 2), dtype=np.int64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _shard_deleted_mask(self, shard: MateShard) -> np.ndarray:
        """Shard-local tombstone row mask, epoch-cached on the SHARD."""
        if shard._deleted_mask_epoch != shard._mutations:
            mask = np.zeros(shard.n_rows, dtype=bool)
            rb = self.corpus.row_base
            for t in shard._deleted_tables:
                mask[int(rb[t]) - shard.row_lo : int(rb[t + 1]) - shard.row_lo] = True
            shard._deleted_mask = mask
            shard._deleted_mask_epoch = shard._mutations
        return shard._deleted_mask

    def superkey_of_rows(self, global_rows: np.ndarray) -> np.ndarray:
        """Routed block gather: each row's superkey comes from its OWNING
        shard's slice — the phase-B verification re-gather."""
        rows = np.asarray(global_rows, dtype=np.int64)
        out = np.empty((rows.shape[0], self.cfg.lanes), dtype=np.uint32)
        if rows.shape[0] == 0:
            return out
        sid = self._shard_ids_of_rows(rows)
        for s in np.unique(sid):
            shard = self.shards[int(s)]
            m = sid == s
            out[m] = shard.superkeys[rows[m] - shard.row_lo]
        return out

    # -- column profiles (ranking subsystem), shard-local -------------------

    def _shard_ids_of_tables(self, table_ids: np.ndarray) -> np.ndarray:
        """Owning shard id per table (whole-table ownership, vectorised)."""
        his = np.asarray([s.table_hi for s in self.shards], dtype=np.int64)
        sid = np.searchsorted(his, np.asarray(table_ids), side="right")
        return np.clip(sid, 0, len(self.shards) - 1).astype(np.int64)

    def _shard_profiles(self, shard: MateShard) -> profiles_lib.ProfileStore:
        """The shard's own ``ProfileStore`` over its tables, rebuilt lazily
        when THIS shard's §5.4 epoch moved."""
        if shard._profiles is None or shard._profiles.epoch != shard._mutations:
            shard._profiles = profiles_lib.build_profiles(
                self.corpus, self.value_lanes, shard.table_lo, shard.table_hi,
                epoch=shard._mutations,
            )
        return shard._profiles

    def gate_candidates(
        self, distinct_keys: list[tuple[str, ...]], table_ids: np.ndarray
    ) -> np.ndarray:
        """Routed profile gate: each candidate table is gated against its
        OWNING shard's profile store — same keep-mask as the single-host
        gate, and no profile bytes cross shards."""
        ids = np.asarray(table_ids, dtype=np.int64)
        keep = np.ones(ids.shape[0], dtype=bool)
        if ids.shape[0] == 0 or not distinct_keys:
            return keep
        kvi, probe, len_bucket, vclass = profiles_lib.query_gate_inputs(
            distinct_keys, self.hash_values
        )
        width = len(distinct_keys[0])
        sid = self._shard_ids_of_tables(ids)
        for s in np.unique(sid):
            shard = self.shards[int(s)]
            m = sid == s
            keep[m] = profiles_lib.gate_tables(
                self._shard_profiles(shard), ids[m] - shard.table_lo,
                kvi, probe, len_bucket, vclass, width,
            )
        return keep

    def profile_features(
        self, table_ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Scoring-head feature gather, each row from its owning shard's
        store (``MateIndex.profile_features`` routed counterpart)."""
        ids = np.asarray(table_ids, dtype=np.int64)
        n = ids.shape[0]
        card = np.zeros(n, dtype=np.int32)
        rows = np.zeros(n, dtype=np.int32)
        sketch = np.zeros((n, profiles_lib.SKETCH_K), dtype=np.uint32)
        if n == 0:
            return card, rows, sketch
        sid = self._shard_ids_of_tables(ids)
        for s in np.unique(sid):
            shard = self.shards[int(s)]
            m = sid == s
            store = self._shard_profiles(shard)
            local = ids[m] - shard.table_lo
            card[m] = store.card_max[local]
            rows[m] = store.n_rows[local]
            sketch[m] = store.sketch[local]
        return card, rows, sketch

    # -- the routed filter --------------------------------------------------

    def attach_mesh(self, mesh) -> None:
        """Run the routed filter across ``mesh``'s ranks (a
        ``launch.mesh.Mesh``: rank i launches for shard i, the counts are
        all-reduced) instead of host-routed per-shard launches.  The group
        size must equal ``n_shards``; rank i's shard store moves to the
        rank's device."""
        if mesh.size != self.n_shards:
            raise ValueError(
                f"mesh shards ({mesh.size} over axes {distributed.MESH_AXES})"
                f" must match index shards ({self.n_shards})"
            )
        shard = self.shards[mesh.rank]
        if shard.device != mesh.device:
            shard.device, shard._store = mesh.device, None
        self._mesh = mesh

    def detach_mesh(self) -> None:
        self._mesh = None

    def routed_counts(
        self,
        rows: np.ndarray,
        query_sk: np.ndarray,
        elig: np.ndarray,
        seg_ids: np.ndarray,
        n_tables: int,
        *,
        backend: Backend | str | None = None,
        fused_block_n: int | None = None,
        stats=None,
    ) -> np.ndarray:
        """Per-table eligible-hit counts for one batch, computed WHERE THE
        ROWS LIVE: one counts-only launch per owning shard against that
        shard's resident store, merged by summation.  Bit-identical to the
        single-host counts (whole-table ownership: each table's count comes
        from exactly one shard; the others contribute zero).

        ``stats`` (a ``DiscoveryStats``) receives the routed accounting:
        ``shard_launches``, ``route_bytes_merged`` (the ONLY cross-shard
        bytes), ``filter_fused_launches`` / ``gather_bytes_saved`` for the
        launches that ran fused / gather-fused, and
        ``shard_gather_demotions`` (+ a debug log) when a gather-capable
        backend had to demote.
        """
        bk = registry.resolve_backend(backend, self.device.type)
        counts = np.zeros(n_tables, dtype=np.int32)
        rows = np.asarray(rows, dtype=np.int64)
        n, q = rows.shape[0], query_sk.shape[0]
        if n == 0 or q == 0 or n_tables == 0:
            return counts
        if self._mesh is not None and self.n_shards > 1:
            return self._routed_counts_mesh(
                rows, query_sk, elig, seg_ids, n_tables, bk, fused_block_n, stats
            )
        sid = self._shard_ids_of_rows(rows)
        for s in np.unique(sid):
            shard = self.shards[int(s)]
            m = sid == s
            c = self._shard_counts(
                shard, rows[m] - shard.row_lo, query_sk, elig[m],
                np.asarray(seg_ids)[m], n_tables, bk, fused_block_n, stats,
            )
            counts += c
            if stats is not None:
                stats.shard_launches += 1
                # the merge ships this shard's counts vector — nothing else
                stats.route_bytes_merged += int(c.nbytes)
        return counts

    def _shard_counts(
        self, shard, local, query_sk, elig_s, seg_s, n_tables, bk,
        fused_block_n, stats,
    ) -> np.ndarray:
        """One shard-local counts-only launch on the shard's device:
        gather-fused (B.2 on the shard's store) → fused (B.1 on rows
        gathered from the shard's slice) → past the table cap the match
        kernel B.4 and an ``index_add_`` ('numpy' stays numpy)."""
        fl = query_sk.shape[1]
        with _on(shard.device):
            if (
                bk.gather
                and n_tables <= ops._FUSED_MAX_TABLES
                and ops.gather_store_fits(shard.superkeys)
            ):
                c = ops.gather_filter_table_counts(
                    shard.device_store(), local, query_sk, elig_s, seg_s,
                    n_tables, block_n=fused_block_n,
                )
                if stats is not None:
                    stats.filter_fused_launches += 1
                    stats.gather_bytes_saved += int(local.shape[0]) * (fl * 4 - 4)
                return c
            if bk.gather:
                _LOG.debug(
                    "routed shard %d: demoting fused-gather (tables=%d, store"
                    " %d bytes) to the host-gather fused launch",
                    shard.shard_id, n_tables, shard.superkeys.nbytes,
                )
                if stats is not None:
                    stats.shard_gather_demotions += 1
            # the shard's own rows, and only those, gathered from its slice;
            # fused-gather demotes to 'fused' (B.1), and the fused backends
            # to 'pallas' (B.4) past the table cap, inside ops
            _, c = ops.filter_hits_table_counts(
                shard.superkeys[local][:, :fl], query_sk, elig_s, seg_s, n_tables,
                backend=bk, fused_block_n=fused_block_n, device=shard.device,
            )
        if stats is not None and (bk.fused or bk.gather) and n_tables <= ops._FUSED_MAX_TABLES:
            stats.filter_fused_launches += 1
        return c

    def _routed_counts_mesh(
        self, rows, query_sk, elig, seg_ids, n_tables, bk, fused_block_n, stats
    ) -> np.ndarray:
        """Mesh mode: this rank's shard launch + the counts all-reduce."""
        counts, demoted = distributed.routed_filter_counts_mesh(
            self, rows, query_sk, elig, seg_ids, n_tables, bk, fused_block_n
        )
        if stats is not None:
            stats.shard_launches += self.n_shards
            stats.route_bytes_merged += int(counts.nbytes) * self.n_shards
            if demoted:
                stats.shard_gather_demotions += self.n_shards
            else:
                stats.filter_fused_launches += self.n_shards
        return counts

    # -- index updates (§5.4), applied shard-locally ------------------------

    def insert_table(self, cells: list[list[str]], name: str = "") -> int:
        """Append a table to the LAST shard (preserves contiguous ascending
        ownership) — only that shard's epoch bumps, so only its device store
        re-uploads; every other shard's resident state is untouched."""
        corpus = self.corpus
        shard = self.shards[-1]
        shard._mutations += 1
        table = Table(table_id=len(corpus.tables), cells=cells, name=name)
        n_rows, n_cols = table.n_rows, table.n_cols
        if n_cols > corpus.max_cols:
            corpus.cell_value_ids = np.pad(
                corpus.cell_value_ids,
                ((0, 0), (0, n_cols - corpus.max_cols)),
                constant_values=-1,
            )
            corpus.max_cols = n_cols
        corpus.tables.append(table)
        corpus.row_base = np.append(corpus.row_base, corpus.row_base[-1] + n_rows)
        corpus.n_cols = np.append(corpus.n_cols, n_cols)
        base = corpus.total_rows
        corpus.total_rows += n_rows

        new_ids = np.full((n_rows, corpus.max_cols), -1, dtype=np.int32)
        for r, row in enumerate(cells):
            for c, v in enumerate(row):
                new_ids[r, c] = _intern_value(self, v)
        corpus.cell_value_ids = np.concatenate([corpus.cell_value_ids, new_ids])
        new_sk = _aggregate_superkeys(new_ids, self.value_lanes, self.cfg.lanes)
        shard.superkeys = np.concatenate([shard.superkeys, new_sk])
        shard.row_hi += n_rows
        shard.table_hi += 1
        for r in range(n_rows):
            for c in range(len(cells[r])):
                vid = int(new_ids[r, c])
                item = np.array([[base + r, c]], dtype=np.int64)
                shard.postings[vid] = (
                    np.concatenate([shard.postings[vid], item])
                    if vid in shard.postings
                    else item
                )
        return table.table_id

    def delete_table(self, table_id: int) -> None:
        """Tombstone on the OWNING shard only (its epoch, its store)."""
        shard = self.shard_of_table(table_id)
        shard._mutations += 1
        shard._deleted_tables.add(table_id)
        lo = int(self.corpus.row_base[table_id]) - shard.row_lo
        hi = int(self.corpus.row_base[table_id + 1]) - shard.row_lo
        shard.superkeys[lo:hi] = 0

    def update_cell(self, table_id: int, row: int, col: int, value: str) -> None:
        """Update one cell: postings swap + row re-hash, all on the owning
        shard — the other shards' epochs (and device stores) do not move."""
        corpus = self.corpus
        shard = self.shard_of_table(table_id)
        shard._mutations += 1
        grow = int(corpus.row_base[table_id]) + row
        old_vid = int(corpus.cell_value_ids[grow, col])
        vid = _intern_value(self, value)
        corpus.tables[table_id].cells[row][col] = value
        corpus.cell_value_ids[grow, col] = vid
        if old_vid in shard.postings:
            pl = shard.postings[old_vid]
            keep = ~((pl[:, 0] == grow) & (pl[:, 1] == col))
            shard.postings[old_vid] = pl[keep]
        item = np.array([[grow, col]], dtype=np.int64)
        shard.postings[vid] = (
            np.concatenate([shard.postings[vid], item])
            if vid in shard.postings
            else item
        )
        shard.superkeys[grow - shard.row_lo] = _aggregate_superkeys(
            corpus.cell_value_ids[grow : grow + 1], self.value_lanes,
            self.cfg.lanes,
        )[0]

    def __repr__(self) -> str:
        return (
            f"ShardedMateIndex(shards={self.n_shards}, "
            f"rows={self.corpus.total_rows}, bits={self.bits}, "
            f"mesh={'attached' if self._mesh is not None else 'none'})"
        )


def build_routed_index(
    corpus: Corpus,
    cfg: xash.XashConfig = xash.DEFAULT_CONFIG,
    hash_name: str = "xash",
    use_corpus_char_freq: bool = False,
    *,
    n_shards: int | None = None,
    mesh=None,
    devices: list | None = None,
    device=None,
) -> tuple[ShardedMateIndex, BuildStats]:
    """Offline phase for the ROUTED lake: the same sharded passes as
    ``core.index.build_index`` (hashing per value shard through kernel B.3,
    or across ``mesh``'s ranks), but per-shard artifacts are NEVER merged —
    each shard keeps its postings / superkeys / profiles resident and the
    index routes to them.  ``BuildStats.merge_seconds`` is therefore zero.

    With a ``mesh``, ``n_shards`` defaults to the group size (another value
    raises), the index lives on the rank's device and comes back with the
    mesh ATTACHED.
    """
    t_start = time.perf_counter()
    cfg = _resolve_cfg(corpus, cfg, hash_name, use_corpus_char_freq)
    value_lanes, stats, dev = _sharded_hash_pass(
        corpus, cfg, hash_name, mesh, n_shards, device
    )
    t0 = time.perf_counter()
    index = ShardedMateIndex._from_build(
        corpus, cfg, hash_name, value_lanes, stats.n_shards,
        shard_devices(devices, dev), dev,
    )
    stats.shard_rows = [s.n_rows for s in index.shards]
    stats.superkey_seconds = time.perf_counter() - t0  # superkeys + postings
    # per-shard column profiles: built where the tables live, never merged
    t0 = time.perf_counter()
    for s in index.shards:
        s._profiles = profiles_lib.build_profiles(
            corpus, value_lanes, s.table_lo, s.table_hi, epoch=0
        )
    stats.profile_seconds = time.perf_counter() - t0
    stats.profile_bytes = sum(s._profiles.nbytes for s in index.shards)
    if stats.mesh_shape is not None:  # the group hashed the arena
        index.attach_mesh(mesh)
    stats.total_seconds = time.perf_counter() - t_start
    return index, stats
