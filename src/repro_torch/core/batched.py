"""Batched kernel-backed discovery engine — the beyond-paper fast path.

Port of ``repro.core.batched`` for a single-host index; the engine logic is
the reference's.  The faithful Algorithm 1 (discovery.py) is a branchy
per-row scan; this engine restructures the online phase into contiguous
blocks fed straight to the §6.3 filter kernels:

  * query-side key hashing is ONE XASH kernel launch
    (``MateIndex.superkey_of_keys``), not per-value host hashing;
  * candidate posting lists are gathered into a CSR block per query
    (``MateIndex.gather_candidates``): rows, value indices and table
    boundaries as three contiguous arrays;
  * the row filter runs as one launch per table batch through
    ``kernels.ops.filter_hits_table_counts`` on the index's device; each
    launch also yields per-table eligible-hit counts, and only that int32
    vector is read back per batch for the rule-1/rule-2 bounds.  Device-
    resident hits (torch tensors) are read back only for surviving tables;
  * on the FUSED paths the reduction happens inside the CUDA kernel, so the
    match matrix never exists (``DiscoveryStats.filter_matrix_bytes == 0``)
    and surviving tables' slices are recomputed on the host for
    verification.  ``backend='fused-gather'`` — the CUDA platform default —
    also reads the candidate rows in place from the device-resident
    superkey store (``MateIndex.device_store()``, refreshed on §5.4 epochs),
    so the host never gathers them (``gather_bytes_saved``).  It demotes to
    'fused' per launch when the store is over budget or the batch exceeds
    the per-launch table cap, and 'fused' demotes to 'pallas' above the cap;
  * tables are visited in Algorithm 1's descending posting-list order;
    rule 1 applies between batches, and rule 2 uses the exact filtered-
    candidate count per table, a stronger bound than the paper's;
  * only filter-surviving pairs are verified on the host (same exact
    ``calculateJ`` as the faithful engine).

Every array is ``lanes``-wide (128/256/512 bits → 4/8/16 lanes), so the
same engine and kernels serve any width the index was built at.

``discover_many`` concatenates all requests' rows and keys into ONE filter
launch, then demuxes per request (``plan_and_count`` → ``score_from_counts``).

Top-k results are BIT-IDENTICAL to Algorithm 1 (ids, joinability scores and
mappings), and to the reference engine at every backend name.

On the routed lake (``core.routing.ShardedMateIndex``, detected by its
``routed`` attribute) there is no global superkey array or device store: the
filter launches go through ``index.routed_counts`` — shard-local counts-only
launches, with only per-table count vectors crossing shards — and surviving
tables re-gather their superkeys from the owning shard.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core import discovery as seq
from repro_torch.core import ranking
from repro_torch.core.corpus import Table
from repro_torch.core.discovery import DiscoveryStats, TopKEntry
from repro_torch.core.index import CandidateBlock, MateIndex
from repro_torch.kernels import ops, registry
from repro_torch.kernels.registry import Backend

DEFAULT_BATCH_TABLES = 256


def _host(hits) -> np.ndarray:
    """A hits block on the host (numpy passes through; tensors are read back)."""
    return hits.cpu().numpy() if isinstance(hits, torch.Tensor) else np.asarray(hits)


def _resolve(index: MateIndex, backend) -> Backend:
    """The registry's one precedence rule, with the index's device type as
    the platform (the default is 'fused-gather' on CUDA, 'auto' on CPU)."""
    return registry.resolve_backend(backend, index.device.type)


@dataclasses.dataclass
class QueryPlan:
    """Precomputed per-query state feeding the batched filter."""

    query: Table
    q_cols: list[int]
    distinct_keys: list[tuple]
    q_sk: np.ndarray  # uint32[K, lanes] batched query-key super keys
    block: CandidateBlock  # CSR candidate rows grouped per table
    elig: np.ndarray  # bool[N_items, K] init-value eligibility per item
    stats: DiscoveryStats


def _gate_block(block: CandidateBlock, keep: np.ndarray) -> CandidateBlock:
    """Drop gated tables (and their items) from a CSR candidate block.

    ``keep`` is the profile gate's per-table mask; the surviving tables
    stay in PL-descending order (a subsequence of a sorted sequence), so
    the rule-1 prefix-cutoff argument downstream is unchanged."""
    lengths = np.diff(block.table_ptr)
    item_keep = np.repeat(keep, lengths)
    kept_lengths = lengths[keep]
    ptr = np.zeros(kept_lengths.shape[0] + 1, dtype=np.int64)
    np.cumsum(kept_lengths, out=ptr[1:])
    return CandidateBlock(
        rows=block.rows[item_keep],
        value_idx=block.value_idx[item_keep],
        table_ids=block.table_ids[keep],
        table_ptr=ptr,
    )


def plan_query(
    index: MateIndex, query: Table, q_cols: list[int],
    init_mode: str = "cardinality",
    *,
    profile_gate: bool = False,
) -> QueryPlan:
    """Initialization phase (§6.1) in columnar form: one hash launch, one
    posting-list gather, one eligibility matrix.

    ``profile_gate=True`` drops candidate tables whose column profiles
    PROVE joinability 0 (``MateIndex.gate_candidates`` — presence-mask /
    length-bucket / char-class / column-count necessary conditions) before
    any superkey is gathered or filtered: pure pruning, the verified top-k
    set is unchanged; ``stats.tables_gated`` / ``gate_bytes_saved`` count
    the work the filter launches never saw.  ``tables_fetched`` /
    ``pl_items_total`` stay PRE-gate (what the posting lists produced)."""
    stats = DiscoveryStats()
    init_col = seq.init_column_selection(query, q_cols, init_mode, index)
    init_idx = q_cols.index(init_col)
    keys = [tuple(row[c] for c in q_cols) for row in query.cells]
    distinct_keys = list(dict.fromkeys(keys))
    q_sk = index.superkey_of_keys(distinct_keys)

    values = list(dict.fromkeys(query.column(init_col)))
    value_id = {v: i for i, v in enumerate(values)}
    # bool[n_values, K]: key kid is probed against items of value v only if
    # the key's init-column entry IS v (Alg. 1 matches per posting list).
    elig_value = np.zeros((len(values), len(distinct_keys)), dtype=bool)
    for kid, key in enumerate(distinct_keys):
        elig_value[value_id[key[init_idx]], kid] = True

    block = index.gather_candidates(values)
    stats.pl_items_total = block.n_items
    stats.tables_fetched = block.n_tables
    if profile_gate and block.n_tables and distinct_keys:
        keep = index.gate_candidates(distinct_keys, block.table_ids)
        if not keep.all():
            stats.tables_gated = int((~keep).sum())
            n_before = block.n_items
            block = _gate_block(block, keep)
            # superkey lanes the filter launches now never gather/compare
            stats.gate_bytes_saved = (
                (n_before - block.n_items) * q_sk.shape[1] * 4
            )
    elig = (
        elig_value[block.value_idx]
        if block.n_items
        else np.zeros((0, len(distinct_keys)), dtype=bool)
    )
    return QueryPlan(query, q_cols, distinct_keys, q_sk, block, elig, stats)


def _segment_ids(table_ptr: np.ndarray, t_start: int, t_stop: int) -> np.ndarray:
    """int32 per-item table index (relative to t_start) for a CSR range."""
    lengths = np.diff(table_ptr[t_start : t_stop + 1])
    return np.repeat(
        np.arange(t_stop - t_start, dtype=np.int32), lengths
    )


def _hits_counts_host(row_sk, q_sk, elig, seg, n_tables, backend: Backend, device):
    """Host-side hits + per-table counts: one filter launch, full readback.

    The right call when the top-k bound cannot prune yet (heap not full) —
    every hit block is about to be verified anyway, so fusing the count
    reduction into the launch would add device work without saving a byte.
    """
    if not backend.device:
        return ops.filter_hits_table_counts(
            row_sk, q_sk, elig, seg, n_tables, backend="numpy"
        )
    hits = ops.filter_match_auto(row_sk, q_sk, backend=backend, device=device) & elig
    counts = np.bincount(
        seg, weights=hits.sum(axis=1), minlength=max(n_tables, 1)
    ).astype(np.int32)
    return hits, counts[:n_tables]


def _calculate_j(
    index: MateIndex,
    plan: QueryPlan,
    rows: np.ndarray,
    hits: np.ndarray,
) -> tuple[int, tuple[int, ...] | None]:
    """Exact verification (Alg. 1 line 21) over filter-surviving pairs."""
    corpus = index.corpus
    stats = plan.stats
    rows_per_mapping: dict[tuple[int, ...], set] = defaultdict(set)
    rs, ks = np.nonzero(hits)
    for r, kid in zip(rs.tolist(), ks.tolist()):
        key = plan.distinct_keys[kid]
        mappings = seq._verify_pair(key, corpus.row_values(int(rows[r])))
        if mappings:
            stats.verified_tp += 1
            for m in mappings:
                rows_per_mapping[m].add(key)
        else:
            stats.verified_fp += 1
    if not rows_per_mapping:
        return 0, None
    mapping, keyset = max(
        rows_per_mapping.items(), key=lambda kv: (len(kv[1]), kv[0])
    )
    return len(keyset), mapping


class _TopK:
    """Algorithm 1's heap: push while filling, replace only if strictly
    greater — the tie semantics both engines share (bit-identical results)."""

    def __init__(self, k: int):
        self.k = k
        self.heap: list[tuple[int, int]] = []  # (J, -table_id) min-heap
        self.mapping: dict[int, tuple[int, ...] | None] = {}

    def bound(self) -> int:
        return self.heap[0][0] if len(self.heap) >= self.k else 0

    @property
    def full(self) -> bool:
        return len(self.heap) >= self.k

    def offer(self, tid: int, joinability: int, mapping) -> None:
        self.mapping[tid] = mapping
        if joinability <= 0:
            return
        if len(self.heap) < self.k:
            heapq.heappush(self.heap, (joinability, -tid))
        elif joinability > self.heap[0][0]:
            heapq.heapreplace(self.heap, (joinability, -tid))

    def entries(self) -> list[TopKEntry]:
        out = [
            TopKEntry(table_id=-neg, joinability=j, mapping=self.mapping.get(-neg))
            for j, neg in self.heap
        ]
        out.sort(key=lambda e: (-e.joinability, e.table_id))
        return out


def _ranked_entries(
    topk: _TopK, rank: str, scores: dict[int, float]
) -> list[TopKEntry]:
    """Order the heap's entries for the requested rank mode.

    ``rank='count'`` is the historical (-joinability, table_id) order;
    ``rank='quality'`` annotates each entry with its scoring-head value and
    sorts (-quality, -joinability, table_id).  Either way the entries come
    from the SAME heap — rank never changes set membership."""
    entries = topk.entries()
    if rank != "quality":
        return entries
    entries = [
        dataclasses.replace(e, quality=float(scores.get(e.table_id, 0.0)))
        for e in entries
    ]
    entries.sort(key=lambda e: (-e.quality, -e.joinability, e.table_id))
    return entries


# below this fraction of batch items surviving the entry bound, per-table
# hit-slice readbacks beat one whole-batch transfer (dispatch vs bytes)
_PREFETCH_FRAC = 0.25


def _score_tables(
    index: MateIndex,
    plan: QueryPlan,
    topk: _TopK,
    hits,
    counts: np.ndarray,
    rows: np.ndarray,
    t_start: int,
    t_stop: int,
    base: int,
    rule1: bool = False,
    row_sk: np.ndarray | None = None,
    elig: np.ndarray | None = None,
    prefetch_frac: float = _PREFETCH_FRAC,
) -> None:
    """Verify (or rule-2-prune) tables [t_start, t_stop) of the plan's block,
    whose items live at ``block`` offsets ``base:`` covered by hits/rows.

    ``hits`` may be device-resident (a tensor) and is only read back as needed:
    the rule-2 bound is checked against ``counts`` (the device-computed
    per-table eligible-hit counts, indexed relative to ``t_start``), so
    pruned tables never transfer their slice.  When the bound at entry
    leaves most items alive anyway, the whole range is prefetched in ONE
    transfer instead of per-table dispatches; counts are exact, so the
    evolving-bound pruning decisions below are identical either way.

    ``hits`` may also be None — the FUSED counts-only launch, where the
    match matrix was never produced at all.  Surviving tables' hit slices
    are then recomputed on demand from ``row_sk``/``elig`` (same subsumption
    predicate → bit-identical verification inputs); pruned tables cost
    nothing beyond their 4 count bytes.  On the GATHER-fused path even
    ``row_sk`` is None — the host never gathered the candidate superkeys —
    and surviving tables gather just their own slice from the index store
    (the same ``superkeys`` array every other path reads: bit-identical).

    ``rule1=True`` additionally applies the paper's rule 1 inside the range
    (tables are PL-desc sorted → the first at/below the bound prunes the
    whole suffix) — the ``discover_many`` path, where the filter already ran
    for every table and only verification work remains to be skipped.
    """
    block, stats = plan.block, plan.stats
    ptr = block.table_ptr
    lazy = hits is None
    if lazy:
        assert elig is not None
    device_hits = (not lazy) and not isinstance(hits, np.ndarray)
    if device_hits:
        bound0 = topk.bound() if topk.full else -1
        alive = counts[: t_stop - t_start] > bound0
        n_alive = int(
            (alive * np.diff(ptr[t_start : t_stop + 1])).sum()
        )
        total = int(ptr[t_stop] - ptr[t_start])
        if total and n_alive >= prefetch_frac * total:
            hits = _host(hits)
            stats.filter_readback_bytes += hits.size
            device_hits = False
    for t in range(t_start, t_stop):
        if rule1 and topk.full and int(ptr[t + 1] - ptr[t]) <= topk.bound():
            stats.tables_pruned_rule1 += t_stop - t
            break
        stats.tables_evaluated += 1
        tid = int(block.table_ids[t])
        lo, hi = int(ptr[t]) - base, int(ptr[t + 1]) - base
        # strengthened rule 2: exact filtered-candidate count bound, from the
        # device-side counts — no match-matrix transfer for pruned tables.
        if topk.full and int(counts[t - t_start]) <= topk.bound():
            stats.tables_pruned_rule2 += 1
            continue
        if lazy:
            rsk = (
                row_sk[lo:hi]
                if row_sk is not None
                else index.superkey_of_rows(rows[lo:hi])
            )
            sub = ops.subsume_np(rsk, plan.q_sk) & elig[lo:hi]
            stats.filter_readback_bytes += sub.size
        else:
            sub = _host(hits[lo:hi])
            if device_hits:
                stats.filter_readback_bytes += sub.size
        joinability, mapping = _calculate_j(index, plan, rows[lo:hi], sub)
        topk.offer(tid, joinability, mapping)


def discover_batched(
    index: MateIndex,
    query: Table,
    q_cols: list[int],
    k: int = 10,
    batch_tables: int = DEFAULT_BATCH_TABLES,
    init_mode: str = "cardinality",
    backend: Backend | str | None = None,
    *,
    prefetch_frac: float = _PREFETCH_FRAC,
    fused_block_n: int | None = None,
    filter_lanes: int | None = None,
    rank: str = "count",
    profile_gate: bool = False,
) -> tuple[list[TopKEntry], DiscoveryStats]:
    """Batched Algorithm 1: one filter launch per ``batch_tables`` tables.

    ``profile_gate=True`` pre-filters the candidate block against the
    column-profile store (see ``plan_query``) — pure pruning, set-identical.
    ``rank='quality'`` runs the ``core.ranking`` scoring head over each
    batch's counts vector (one extra launch per batch) and reorders the
    returned entries by join quality; the heap — and therefore the verified
    top-k SET — is untouched.  The raw engines default to the historical
    ``rank='count'``/gate-off behaviour; ``DiscoveryConfig`` flips both
    defaults at the session layer.

    Per batch, the device computes the subsumption matrix ∧ eligibility AND
    reduces it to per-table hit counts; only that counts vector (4 bytes per
    table) is read back for the rule-1/rule-2 bound checks.  Hit-matrix
    slices are transferred solely for tables that survive pruning and need
    exact verification.

    ``backend`` selects the §6.3 filter implementation (a resolved
    ``kernels.registry.Backend`` or a registered name); None follows the
    registry precedence: the registry's environment variable, then the platform
    default (fused-gather on CUDA, size-based auto split on CPU).  On 'fused' the
    match matrix is never materialised — not even in HBM — so
    ``stats.filter_matrix_bytes`` stays 0 and surviving tables' slices are
    recomputed on demand.  The pre-registry ``use_kernel=``/``fused=`` shims
    were removed after their one-release deprecation window (PR 4): passing
    them raises TypeError; pin the path with ``backend=`` instead
    (``use_kernel=False`` -> 'numpy', ``fused=True`` -> 'fused',
    ``fused=False`` -> 'pallas').

    ``filter_lanes`` runs the filter launches over only the first N uint32
    lanes of the super keys (the serving tier's pressure-degrade path:
    ``filter_lanes=4`` ≙ 128-bit filtering on a wider index).  A lane-prefix
    subsumption test is a pure relaxation of the full-width test — zero
    false negatives — so after exact verification the top-k is BIT-IDENTICAL
    to the full-width run; only filter precision (and the rule-2 bound
    tightness) degrades.
    """
    bk = _resolve(index, backend)
    plan = plan_query(index, query, q_cols, init_mode, profile_gate=profile_gate)
    stats, block = plan.stats, plan.block
    q_sketch = (
        ranking.query_sketch(index, plan.distinct_keys)
        if rank == "quality"
        else None
    )
    scores: dict[int, float] = {}
    full_lanes = plan.q_sk.shape[1]
    fl = full_lanes if filter_lanes is None else max(1, min(int(filter_lanes), full_lanes))
    stats.filter_lanes = fl
    q_f = plan.q_sk if fl == full_lanes else plan.q_sk[:, :fl]
    # routed index: there IS no global superkey array or single device
    # store — the filter diverts to shard-local counts-only launches and
    # only count vectors cross shards.
    routed = getattr(index, "routed", False)
    # gather-fused: the engine decides per batch whether the device store
    # carries the gather (store fits + the batch is under the scatter-tile
    # cap), because only then may the host skip its own superkey gather.
    store = (
        index.device_store()
        if not routed and bk.gather and ops.gather_store_fits(index.superkeys)
        else None
    )
    topk = _TopK(k)
    n_tables = block.n_tables
    for start in range(0, n_tables, batch_tables):
        stop = min(start + batch_tables, n_tables)
        # rule 1 between batches: tables are PL-desc sorted, so if the FIRST
        # table of the batch is at/below the bound, everything after is too.
        # (PL lengths are CSR metadata the host already owns — no transfer.)
        first_count = int(block.table_ptr[start + 1] - block.table_ptr[start])
        if topk.full and first_count <= topk.bound():
            stats.tables_pruned_rule1 += n_tables - start
            break
        lo, hi = int(block.table_ptr[start]), int(block.table_ptr[stop])
        rows = block.rows[lo:hi]
        use_gather = store is not None and (stop - start) <= ops._FUSED_MAX_TABLES
        # the gather-fused contract: the host NEVER touches the candidate
        # superkeys — the kernel reads them from the device store.  The
        # routed contract is stricter still: the host never gathers a WHOLE
        # batch at all; surviving tables re-gather from their owning shard
        # in _score_tables (index.superkey_of_rows routes per shard).
        row_sk = None if (use_gather or routed) else index.superkey_of_rows(rows)
        row_f = (
            None if row_sk is None
            else row_sk if fl == full_lanes else row_sk[:, :fl]
        )
        elig = plan.elig[lo:hi]
        seg = _segment_ids(block.table_ptr, start, stop)
        stats.pl_items_checked += int(rows.shape[0])
        stats.filter_checks += int(elig.sum())
        if routed:
            # shard-local counts-only launches, count-merge across shards:
            # the only cross-shard bytes are stats.route_bytes_merged.
            hits = None
            counts = index.routed_counts(
                rows, q_f, elig, seg, stop - start,
                backend=bk, fused_block_n=fused_block_n, stats=stats,
            )
        elif use_gather:
            # one launch from posting-list offsets to counts: n×4 offset
            # bytes go to the device instead of n×lanes×4 gathered key bytes
            # (and the gathered block never exists in HBM either).
            hits, counts = ops.filter_hits_table_counts(
                None, q_f, elig, seg, stop - start, backend=bk,
                fused_block_n=fused_block_n, store=store, rows=rows,
            )
            stats.filter_fused_launches += 1
            stats.gather_bytes_saved += int(rows.shape[0]) * (fl * 4 - 4)
        elif bk.fused:
            # fused filter+segment-count launch: the match matrix is never
            # produced (zero filter_matrix_bytes), only the counts vector
            # comes back; surviving tables' slices are recomputed on demand
            # in _score_tables.  (ops falls back to the composed path above
            # its table cap — hits non-None — and stats must follow suit.)
            hits, counts = ops.filter_hits_table_counts(
                row_f, q_f, elig, seg, stop - start, backend=bk,
                fused_block_n=fused_block_n, device=index.device,
            )
            if hits is None:
                stats.filter_fused_launches += 1
            else:
                stats.filter_matrix_bytes += int(elig.size)
        elif bk.device and topk.full and topk.bound() > 0:
            # bound can prune → composed device launch: hits stay on device,
            # only the per-table counts vector is read back; surviving
            # tables' slices transfer lazily in _score_tables.
            stats.filter_matrix_bytes += int(elig.size)
            hits, counts = ops.filter_hits_table_counts(
                row_f, q_f, elig, seg, stop - start, backend=bk,
                device=index.device,
            )
        else:
            # heap not full (bound 0): nothing can be pruned, every hit
            # block is about to be verified — single-transfer path.
            stats.filter_matrix_bytes += int(elig.size)
            hits, counts = _hits_counts_host(
                row_f, q_f, elig, seg, stop - start, bk, index.device
            )
        # readback = match-matrix bytes materialised host-side: the whole
        # matrix when any path produced host hits (size-based numpy
        # dispatch included), else the counts vector now + surviving
        # slices lazily in _score_tables.
        if isinstance(hits, np.ndarray):
            stats.filter_readback_bytes += hits.size
        else:
            stats.filter_readback_bytes += counts.nbytes
        stats.filter_passed += int(counts.sum())
        if rank == "quality":
            batch_ids = block.table_ids[start:stop]
            sc = ranking.quality_scores(
                index, batch_ids, np.asarray(counts),
                len(plan.distinct_keys), q_sketch, stats=stats,
            )
            scores.update(zip(batch_ids.tolist(), sc.tolist()))
        _score_tables(
            index, plan, topk, hits, counts, rows, start, stop, lo,
            row_sk=row_sk, elig=elig, prefetch_frac=prefetch_frac,
        )
    return _ranked_entries(topk, rank, scores), stats


@dataclasses.dataclass
class PlanCounts:
    """Phase-A artifact of the two-phase group engine: one request's plan
    plus everything the shared filter launch produced for it — the seam the
    serving tier's hot-table bound cache stores (``serve.cache.BoundCache``).

    ``counts`` is the per-table eligible-hit count vector driving rule-1/2
    pruning; ``hits`` is this plan's slice of the group match matrix (None
    on the fused counts-only path, and always None once cached — see
    ``cacheable``); ``row_sk`` keeps the FULL-width row super keys so a
    dropped/absent matrix is recomputed lazily during scoring,
    bit-identically.  On the GATHER-fused launch ``row_sk`` is None too —
    the host never gathered the superkeys — and scoring gathers surviving
    tables' slices from the index store instead, which is why ``epoch``
    matters doubly there: the store read at scoring time must be the store
    the launch filtered against.  ``epoch`` pins ``MateIndex.mutation_epoch``
    at launch time: a PlanCounts is replayable only while the index is
    unchanged.
    """

    plan: QueryPlan
    row_sk: np.ndarray | None  # uint32[n_items, lanes] full-width row super
    # keys (None: gather-fused launch — scoring reads the index store)
    counts: np.ndarray  # int32[n_tables] per-table eligible-hit counts
    hits: object = None  # numpy/tensor [n_items, group_keys] slice, or None
    group_keys: int = 0  # key count of the SHARED launch (accounting)
    hits_host: bool = False  # group matrix came back host-side (np)
    fused: bool = False  # counts-only fused launch (no matrix anywhere)
    filter_lanes: int = 0  # lanes the launch probed (< index width: degraded)
    epoch: int = 0  # index.mutation_epoch at launch time
    gather_saved: int = 0  # HBM bytes the gather-fused launch never moved
    route_launches: int = 0  # routed index: shard launches this request's
    # items spanned (distinct owning shards — whole-table ownership means
    # each of its candidate tables was counted on exactly one of them)
    route_bytes: int = 0  # routed index: this request's share of the
    # cross-shard count-merge bytes (its counts vector × shards touched)

    def cacheable(self) -> "PlanCounts":
        """A copy safe to hold in a cache: the (possibly device-resident)
        match-matrix slice is dropped; scoring recomputes surviving tables'
        slices from ``row_sk`` on demand — same subsumption predicate, so
        verification inputs (and the top-k) are bit-identical."""
        return dataclasses.replace(self, hits=None)


def plan_and_count(
    index: MateIndex,
    queries: list[tuple[Table, list[int]]],
    backend: Backend | str | None = None,
    *,
    init_mode: str = "cardinality",
    filter_lanes: int | None = None,
    fused_block_n: int | None = None,
    profile_gate: bool = False,
) -> list[PlanCounts]:
    """Phase A of ``discover_many``: plan every request, then run the ONE
    shared filter launch and demux it into per-request ``PlanCounts``.

    ``profile_gate=True`` applies the column-profile gate per plan (see
    ``plan_query``) before the shared launch is assembled, so gated tables
    never contribute rows to the group matrix at all.

    Everything up to (and including) ``gather_candidates`` + the §6.3
    filter lives here; ``score_from_counts`` is phase B (pruning, exact
    verification, the heap).  The split is the serving tier's bound-cache
    seam: a hot query's ``PlanCounts`` can be stored and re-scored later —
    at a different ``k`` even — without touching the index or the device.

    ``filter_lanes`` restricts the launch to a lane prefix of the super
    keys (the pressure-degrade path, see ``discover_batched``): a pure
    relaxation — zero false negatives — so downstream verification still
    yields bit-identical top-k.
    """
    bk = _resolve(index, backend)
    plans = [
        plan_query(index, q, q_cols, init_mode, profile_gate=profile_gate)
        for q, q_cols in queries
    ]
    if not plans:
        return []
    rows_all = np.concatenate([p.block.rows for p in plans])
    q_all = np.concatenate([p.q_sk for p in plans])
    # block-diagonal eligibility (a request's keys only probe its own
    # candidate rows) + a global per-item table index for the one-pass
    # per-table rule-1/2 count reduction.
    elig_all = np.zeros((rows_all.shape[0], q_all.shape[0]), dtype=bool)
    seg_all = np.zeros(rows_all.shape[0], dtype=np.int32)
    r_off = k_off = 0
    n_tables_all = 0
    for p in plans:
        ni, ki, ti = p.block.n_items, p.q_sk.shape[0], p.block.n_tables
        elig_all[r_off : r_off + ni, k_off : k_off + ki] = p.elig
        if ni:
            seg_all[r_off : r_off + ni] = n_tables_all + _segment_ids(
                p.block.table_ptr, 0, ti
            )
        r_off += ni
        k_off += ki
        n_tables_all += ti
    full_lanes = index.cfg.lanes
    fl = full_lanes if filter_lanes is None else max(1, min(int(filter_lanes), full_lanes))
    q_f = q_all if fl == full_lanes else q_all[:, :fl]
    routed = getattr(index, "routed", False)
    use_gather = (
        not routed
        and bk.gather
        and ops.gather_store_fits(index.superkeys)
        and n_tables_all <= ops._FUSED_MAX_TABLES
    )
    # gather-fused group launch: no host superkey gather at all — the kernel
    # pulls every request's candidate rows from the device store, and phase B
    # re-gathers only surviving tables' slices (bit-identical: same array).
    # The routed group launch shares that contract (row_sk stays None) and
    # scoring re-gathers from the OWNING shard only.
    row_sk_all = (
        None if (use_gather or routed) else index.superkey_of_rows(rows_all)
    )
    row_f = (
        None if row_sk_all is None
        else row_sk_all if fl == full_lanes else row_sk_all[:, :fl]
    )
    if routed:
        # shard-local counts-only launches for the whole group; per-request
        # routing accounting is attributed below from each plan's own items.
        hits_all = None
        counts_all = index.routed_counts(
            rows_all, q_f, elig_all, seg_all, n_tables_all,
            backend=bk, fused_block_n=fused_block_n,
        )
    elif use_gather:
        hits_all, counts_all = ops.filter_hits_table_counts(
            None, q_f, elig_all, seg_all, n_tables_all,
            backend=bk, fused_block_n=fused_block_n,
            store=index.device_store(), rows=rows_all,
        )
    elif bk.fused:
        # ONE fused filter+segment-count launch for the whole group: the
        # (Σ rows × Σ keys) matrix is never materialised; only the group
        # counts vector is read back.  Surviving tables recompute their
        # own-keys hit slices lazily in _score_tables (bit-identical to
        # slicing the block-diagonal of the full matrix, since elig
        # already restricts each row to its own request's keys).
        hits_all, counts_all = ops.filter_hits_table_counts(
            row_f, q_f, elig_all, seg_all, n_tables_all,
            backend=bk, fused_block_n=fused_block_n, device=index.device,
        )
    else:
        # ONE subsumption launch for the whole group.  Unlike
        # ``discover_batched`` (whose later batches are often pruned
        # without any matrix transfer), every request here starts with an
        # empty heap (entry bound 0), so most plans' hit blocks are
        # needed for verification — the matrix comes back to the host in
        # one transfer and the per-table rule-1/2 counts are a cheap
        # host reduction over it.
        hits_all, counts_all = _hits_counts_host(
            row_f, q_f, elig_all, seg_all, n_tables_all, bk, index.device,
        )
    epoch = index.mutation_epoch
    out: list[PlanCounts] = []
    r_off = k_off = t_off = 0
    for p in plans:
        ni, ki, ti = p.block.n_items, p.q_sk.shape[0], p.block.n_tables
        # routed attribution: the shards THIS request's items spanned — its
        # solo cost, and (by whole-table ownership) exactly the shards that
        # produced its slice of the group counts vector.
        n_sh = (
            len(np.unique(index._shard_ids_of_rows(p.block.rows)))
            if routed and ni
            else 0
        )
        out.append(
            PlanCounts(
                plan=p,
                row_sk=(
                    None if row_sk_all is None
                    else row_sk_all[r_off : r_off + ni]
                ),
                counts=counts_all[t_off : t_off + ti],
                hits=None if hits_all is None
                else hits_all[r_off : r_off + ni, k_off : k_off + ki],
                group_keys=0 if hits_all is None else int(hits_all.shape[1]),
                hits_host=isinstance(hits_all, np.ndarray),
                fused=hits_all is None,
                filter_lanes=fl,
                epoch=epoch,
                gather_saved=ni * (fl * 4 - 4) if use_gather else 0,
                route_launches=n_sh,
                route_bytes=n_sh * ti * 4,
            )
        )
        r_off += ni
        k_off += ki
        t_off += ti
    return out


def score_from_counts(
    index: MateIndex,
    pc: PlanCounts,
    k: int = 10,
    *,
    prefetch_frac: float = _PREFETCH_FRAC,
    from_cache: bool = False,
    rank: str = "count",
) -> tuple[list[TopKEntry], DiscoveryStats]:
    """Phase B of ``discover_many``: rule-1/2 pruning + exact verification
    + the top-k heap over one request's ``PlanCounts``.

    ``rank='quality'`` runs ONE scoring launch over the plan's full counts
    vector (phase A already produced it — no extra filter work) and orders
    the returned entries by join quality; the heap itself is untouched, so
    cached replays at either rank verify the same set.

    Re-runnable: stats land on a FRESH copy of the plan's, so the same
    PlanCounts (a bound-cache hit) can be scored any number of times — at
    any ``k``.  ``from_cache=True`` skips the launch-transfer accounting
    (an earlier request already paid for the filter) and forces the
    lazy-recompute path, since cached entries hold no matrix slice.
    """
    plan = dataclasses.replace(pc.plan, stats=dataclasses.replace(pc.plan.stats))
    stats, block = plan.stats, plan.block
    n_items = block.n_items
    stats.pl_items_checked = n_items
    stats.filter_checks = int(plan.elig.sum())
    stats.filter_passed = int(pc.counts.sum())
    stats.filter_lanes = pc.filter_lanes
    hits = pc.hits
    if from_cache:
        hits = None
    elif pc.fused:  # fused counts-only group launch succeeded
        stats.filter_fused_launches += 1
        stats.filter_readback_bytes += pc.counts.nbytes
        stats.gather_bytes_saved += pc.gather_saved
        stats.shard_launches += pc.route_launches
        stats.route_bytes_merged += pc.route_bytes
    else:
        # the shared launch computes (and reads back) this plan's rows
        # against the GROUP's keys — the documented cross-product trade.
        # (device-resident hits — the fused→composed table-cap fallback —
        # transfer lazily in _score_tables, which does its own readback
        # accounting.)
        stats.filter_matrix_bytes += n_items * pc.group_keys
        if pc.hits_host:
            stats.filter_readback_bytes += n_items * pc.group_keys
    scores: dict[int, float] = {}
    if rank == "quality" and block.n_tables:
        q_sketch = ranking.query_sketch(index, plan.distinct_keys)
        sc = ranking.quality_scores(
            index, block.table_ids, np.asarray(pc.counts),
            len(plan.distinct_keys), q_sketch, stats=stats,
        )
        scores = dict(zip(block.table_ids.tolist(), sc.tolist()))
    topk = _TopK(k)
    # rule 1 (PL-desc suffix pruning) applies inside the range: the filter
    # already ran batched for every table, only verification work and
    # hit-slice readbacks (or fused recomputes) remain to be skipped.
    _score_tables(
        index, plan, topk, hits, pc.counts, block.rows, 0, block.n_tables, 0,
        rule1=True, row_sk=pc.row_sk, elig=plan.elig,
        prefetch_frac=prefetch_frac,
    )
    return _ranked_entries(topk, rank, scores), stats


def discover_many(
    index: MateIndex,
    queries: list[tuple[Table, list[int]]],
    k: int | list[int] = 10,
    init_mode: str = "cardinality",
    backend: Backend | str | None = None,
    *,
    prefetch_frac: float = _PREFETCH_FRAC,
    fused_block_n: int | None = None,
    filter_lanes: int | None = None,
    rank: str = "count",
    profile_gate: bool = False,
) -> list[tuple[list[TopKEntry], DiscoveryStats]]:
    """Multi-query discovery sharing ONE filter launch.

    ``rank``/``profile_gate`` thread through both phases (see
    ``plan_and_count`` and ``score_from_counts``): the gate shrinks each
    request's candidate block before the shared launch, quality ranking
    adds one scoring launch per request — neither changes the verified set.

    All requests' candidate rows and query keys concatenate into a single
    subsumption launch; the match matrix is then demuxed per request and
    scored with the same rule-1/rule-2 + heap semantics, so each request's
    top-k is bit-identical to its solo ``discover``/``discover_batched`` run.
    Internally this is ``plan_and_count`` (phase A: the shared launch)
    composed with ``score_from_counts`` (phase B: per-request scoring) —
    the seam the serving tier's caches plug into.

    ``backend`` resolves exactly as in ``discover_batched`` (and the removed
    ``use_kernel=``/``fused=`` kwargs raise TypeError here too).  A 'fused'
    backend swaps the group launch for the fused filter+segment-count kernel: the
    (Σ rows × Σ keys) match matrix — the expensive part of the cross-product
    trade below — is never materialised; only the group counts vector comes
    back, and each request's surviving tables recompute their (own-keys-only)
    hit slices on demand during scoring.  Requests pruned by the evolving
    rule-1/2 bounds never pay for their matrix block at all.

    Cost note: the shared launch computes the full (Σ rows × Σ keys) cross
    product — only the block diagonal is consumed, so filter work grows
    ~linearly with group size beyond the useful probes.  That trade buys one
    kernel dispatch for the whole group, which wins while dispatch latency
    dominates (small/medium groups, accelerator backends); keep serving
    groups bounded (``DiscoveryEngine(batch=...)``, default 8) rather than
    fusing unbounded request sets.
    """
    ks = [k] * len(queries) if isinstance(k, int) else list(k)
    assert len(ks) == len(queries)
    pcs = plan_and_count(
        index, queries, backend,
        init_mode=init_mode, filter_lanes=filter_lanes,
        fused_block_n=fused_block_n, profile_gate=profile_gate,
    )
    return [
        score_from_counts(
            index, pc, k_i, prefetch_frac=prefetch_frac, rank=rank
        )
        for pc, k_i in zip(pcs, ks)
    ]


def filter_outcomes(
    index: MateIndex,
    query: Table,
    q_cols: list[int],
    init_mode: str = "cardinality",
    check_false_negatives: bool = False,
) -> dict[str, int]:
    """Unpruned §6.3 filter quality for one query — the paper's Table 1/2
    false-positive measurement at whatever hash width the index was built at.

    Every eligible (candidate row, query key) pair is probed through the
    super-key filter and every surviving pair is verified exactly; no top-k
    pruning interferes, so counts are a property of the hash alone.

    Returns counts: ``checks`` (eligible probes), ``passed`` (filter
    survivors), ``tp`` / ``fp`` (survivors that pass / fail exact key
    comparison), and — when ``check_false_negatives`` — ``fn``: eligible
    pairs that verify exactly but were REJECTED by the filter (always 0 for
    any OR-aggregated hash; the §6.3 no-false-negative lemma).
    """
    plan = plan_query(index, query, q_cols, init_mode)
    out = {
        "checks": int(plan.elig.sum()),
        "passed": 0,
        "tp": 0,
        "fp": 0,
        "fn": 0,
        "items": plan.block.n_items,
        "keys": len(plan.distinct_keys),
    }
    if plan.block.n_items == 0 or not plan.distinct_keys:
        return out
    row_sk = index.superkey_of_rows(plan.block.rows)
    hits = ops.subsume_np(row_sk, plan.q_sk) & plan.elig
    out["passed"] = int(hits.sum())
    corpus = index.corpus
    row_values_cache: dict[int, list[str]] = {}

    def _matches(r: int, kid: int) -> bool:
        grow = int(plan.block.rows[r])
        vals = row_values_cache.get(grow)
        if vals is None:
            vals = row_values_cache[grow] = corpus.row_values(grow)
        return bool(seq._verify_pair(plan.distinct_keys[kid], vals))

    for r, kid in zip(*np.nonzero(hits)):
        if _matches(int(r), int(kid)):
            out["tp"] += 1
        else:
            out["fp"] += 1
    if check_false_negatives:
        for r, kid in zip(*np.nonzero(plan.elig & ~hits)):
            if _matches(int(r), int(kid)):
                out["fn"] += 1
    return out
