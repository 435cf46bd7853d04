"""MATE online discovery (paper §6, Algorithm 1) — faithful implementation.

Port of ``repro.core.discovery``: host-side numpy, as in the reference.
``DiscoveryStats`` keeps every counter of the reference (the routed-lake and
FD counters stay 0 until those paths are ported: ROADMAP A.6, A.7) so that
stats compare field by field across the two packages.

Four phases: initialization (§6.1), table filtering (§6.2), row filtering
(§6.3), exact joinability calculation (calculateJ).  ``row_filter=False``
yields the SCI baseline (single-column index adapted for n-ary joins: table
filtering allowed, no super-key row filter — §7.2).

Joinability follows Eq. (2): the count of DISTINCT query key combinations
matched under the single column mapping Y' that maximises the overlap.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import defaultdict

import numpy as np

from repro_torch.core.corpus import Corpus, Table
from repro_torch.core.index import MateIndex
from repro_torch.kernels import ops


@dataclasses.dataclass
class DiscoveryStats:
    tables_fetched: int = 0
    tables_evaluated: int = 0
    tables_pruned_rule1: int = 0  # remaining tables skipped when rule 1 fires
    tables_pruned_rule2: int = 0
    pl_items_total: int = 0
    pl_items_checked: int = 0
    filter_checks: int = 0  # (query row, candidate row) super-key probes
    filter_passed: int = 0  # pairs surviving the row filter
    verified_tp: int = 0  # pairs passing exact verification
    verified_fp: int = 0  # pairs surviving filter but failing verification
    # batched-engine transfer accounting (device-side rule 1/2):
    filter_matrix_bytes: int = 0  # full match-matrix bytes the filter produced
    filter_readback_bytes: int = 0  # match bytes materialised host-side
    # (counts vectors + verification slices on the device path; the whole
    # matrix when a host/numpy dispatch produced it directly)
    filter_fused_launches: int = 0  # fused filter+segment-count launches:
    # the match matrix was never produced (not even in HBM), so these
    # contribute ZERO to filter_matrix_bytes — counts-only readback plus
    # on-demand recomputed slices for the tables that survive pruning
    gather_bytes_saved: int = 0  # bytes the gather-fused launches never
    # moved: the composed path ships n×lanes×4 host-gathered superkey bytes
    # per launch, the gather-fused kernel ships n×4 offset bytes and pulls
    # the rows from the device store by DMA (n × (lanes·4 − 4) per launch)
    filter_lanes: int = 0  # uint32 lanes the filter launch probed (0: the
    # scalar engine, which has no lane-sliced filter).  Below the index
    # width this was a DEGRADED launch (serving-tier pressure relief): a
    # lane-prefix subsumption test is a pure relaxation — no false
    # negatives — so exact verification still yields bit-identical top-k,
    # just with more survivors to verify.
    # routed-index accounting (``core.routing.ShardedMateIndex``): the only
    # bytes that cross a shard boundary on the routed path are per-table
    # count vectors — superkey rows never do (owning-shard launches +
    # owning-shard re-gathers for verification).
    shard_launches: int = 0  # shard-local filter launches the routed path ran
    route_bytes_merged: int = 0  # per-table count bytes merged across shards
    # (the ENTIRE cross-shard traffic of a routed filter; compare against
    # n_items × lanes × 4, the superkey bytes a host-gather path would ship)
    shard_gather_demotions: int = 0  # shard launches demoted off the
    # gather-fused path (store over budget / scatter-tile cap / no per-shard
    # store, e.g. the pre-routed mesh row filter) — each is also debug-logged
    # ranking-subsystem accounting (``core.profiles`` / ``core.ranking``):
    tables_gated: int = 0  # candidate tables the profile gate dropped before
    # any filter launch (provably joinability 0 — pure pruning, so the
    # verified top-k set is unchanged; see profiles.gate_tables)
    gate_bytes_saved: int = 0  # superkey bytes the filter launches never
    # touched because the gate dropped those tables' posting items first
    # (items × lanes × 4, same units as gather_bytes_saved)
    ranking_launches: int = 0  # quality-scoring launches (one per batch
    # under rank='quality'; see core.ranking.quality_scores)
    # FD-workload accounting (``core.fd.discover_fds``): counts-as-refutation
    # prunes candidate tables whose filter count upper bound is below
    # min_support (exact on the negative side — the §6.3 filter has no false
    # negatives, so a count below the bar PROVES true support is too), and
    # only survivors pay the validation re-gather.
    fd_candidates: int = 0  # candidate tables entering the FD workload (every
    # table with a posting item for the determinant init column)
    fd_validated: int = 0  # tables surviving the count prune — these re-gather
    # rows for the exact determinant-group → dependent-value check
    fd_bytes_verified: int = 0  # superkey bytes the validation pass re-gathered
    # (n_items × lanes × 4 per surviving table; the prune's whole point is
    # keeping this a small fraction of what validating every candidate costs)

    def merge(self, other: "DiscoveryStats") -> "DiscoveryStats":
        """Accumulate ``other``'s counters into self, field by field.

        Driven by ``dataclasses.fields`` so a newly added counter can never
        be silently dropped — the shard/gather counters of PRs 7–8 each
        hand-patched every aggregation site and this is the one replacement
        for all of them (``SessionStats.absorb``, bench aggregation, ...).
        """
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self

    @property
    def readback_frac(self) -> float:
        """Fraction of the match matrix materialised on the host (batched
        engines; ~1.0 is the transfer-everything behaviour)."""
        if not self.filter_matrix_bytes:
            return 0.0
        return self.filter_readback_bytes / self.filter_matrix_bytes

    @property
    def precision(self) -> float:
        denom = self.verified_tp + self.verified_fp
        return self.verified_tp / denom if denom else 1.0


@dataclasses.dataclass
class TopKEntry:
    table_id: int
    joinability: int
    mapping: tuple[int, ...] | None  # candidate cols per query col
    quality: float | None = None  # join-quality score (rank='quality' only;
    # annotation — never part of heap selection, see core.ranking)


def init_column_selection(
    query: Table, q_cols: list[int], mode: str = "cardinality",
    index: MateIndex | None = None,
) -> int:
    """§6.1 heuristic (+ Fig. 8 baselines: order / tls / best / worst)."""
    if mode == "order":
        return q_cols[0]
    if mode == "tls":  # longest string
        return max(q_cols, key=lambda c: max((len(v) for v in query.column(c)), default=0))
    if mode in ("best", "worst"):
        assert index is not None, "best/worst need index ground truth"
        totals = {
            c: sum(len(index.fetch_postings(v)) for v in set(query.column(c)))
            for c in q_cols
        }
        return (min if mode == "best" else max)(totals, key=totals.get)
    # cardinality (MATE default): fewest unique values
    return min(q_cols, key=lambda c: (len(set(query.column(c))), q_cols.index(c)))


def build_query_superkeys(index: MateIndex, query: Table, q_cols: list[int]):
    """Map init-column value -> [(key tuple, super key lanes)] (Alg. 1 line 6).

    The query super key of a row is the OR of the XASH (or baseline hash) of
    its |Q| key values only.  Hashing is batched: all distinct keys go through
    ``MateIndex.superkey_of_keys`` in one call (one XASH kernel launch
    for XASH indexes) instead of per-value host loops.
    """
    keys = [tuple(row[c] for c in q_cols) for row in query.cells]
    distinct = list(dict.fromkeys(keys))
    sks = index.superkey_of_keys(distinct)
    sk_of_key = {key: sks[i] for i, key in enumerate(distinct)}
    return keys, sk_of_key


def _subsumes_np(q_sk: np.ndarray, row_sk: np.ndarray) -> bool:
    return bool(np.all((q_sk & ~row_sk) == 0))


def _verify_pair(
    key: tuple[str, ...], cand_values: list[str]
) -> list[tuple[int, ...]]:
    """All distinct-column mappings (cand col per query col) matching ``key``."""
    per_col: list[list[int]] = []
    for q_val in key:
        cols = [c for c, v in enumerate(cand_values) if v == q_val]
        if not cols:
            return []
        per_col.append(cols)
    out = []
    for assign in itertools.product(*per_col):
        if len(set(assign)) == len(assign):
            out.append(assign)
    return out


def discover(
    index: MateIndex,
    query: Table,
    q_cols: list[int],
    k: int = 10,
    row_filter: bool = True,
    init_mode: str = "cardinality",
) -> tuple[list[TopKEntry], DiscoveryStats]:
    """Algorithm 1. Returns top-k tables (sorted desc) and statistics."""
    stats = DiscoveryStats()
    corpus = index.corpus

    # ---- initialization (lines 3-6) ----
    init_col = init_column_selection(query, q_cols, init_mode, index)
    keys, sk_of_key = build_query_superkeys(index, query, q_cols)
    init_idx = q_cols.index(init_col)
    # init value -> list of distinct key tuples having that init value
    keys_of_value: dict[str, list[tuple]] = defaultdict(list)
    for key in dict.fromkeys(keys):  # distinct keys, stable order
        keys_of_value[key[init_idx]].append(key)

    # fetch PLs for the init column's values, group by table (lines 4-5)
    by_table: dict[int, list[tuple[int, int, str]]] = defaultdict(list)
    for value in dict.fromkeys(query.column(init_col)):
        pl = index.fetch_postings(value)
        stats.pl_items_total += len(pl)
        if len(pl) == 0:
            continue
        tids = corpus.table_of_row(pl[:, 0])
        for (grow, _col), tid in zip(pl.tolist(), np.atleast_1d(tids).tolist()):
            by_table[int(tid)].append((int(grow), int(_col), value))
    candidate_tables = sorted(
        by_table, key=lambda t: (-len(by_table[t]), t)
    )
    stats.tables_fetched = len(candidate_tables)

    # ---- main loop ----
    heap: list[tuple[int, int]] = []  # (J, -table_id) min-heap
    best_mapping: dict[int, tuple[int, ...] | None] = {}

    def j_k() -> int:
        return heap[0][0] if len(heap) >= k else 0

    for pos, tid in enumerate(candidate_tables):
        table_pls = by_table[tid]
        l_t = len(table_pls)
        # table filter rule 1 (lines 9-10): sorted desc → BREAK
        if len(heap) >= k and l_t <= j_k():
            stats.tables_pruned_rule1 += len(candidate_tables) - pos
            break
        stats.tables_evaluated += 1

        # Vectorised row filter: one bitwise subsumption op per table for all
        # (PL item × key) pairs — the C-speed equivalent of the paper's
        # per-row machine-word AND (per-pair Python calls would swamp the
        # measurement with interpreter overhead).  Rule-2 bookkeeping below
        # consumes the precomputed matches in the paper's original order.
        rows_arr = np.fromiter((g for g, _c, _v in table_pls), np.int64, l_t)
        row_sks = index.superkey_of_rows(rows_arr)  # [L, lanes]
        if row_filter:
            for _g, _c, value in table_pls:
                stats.filter_checks += len(keys_of_value[value])
            # group rows by init value → probe each key against its rows
            by_value: dict[str, list[int]] = defaultdict(list)
            for i, (_g, _c, value) in enumerate(table_pls):
                by_value[value].append(i)
            matched_keys: list[list[tuple]] = [[] for _ in range(l_t)]
            for value, idxs in by_value.items():
                keys_here = keys_of_value[value]
                if not keys_here:
                    continue
                q = np.stack([sk_of_key[key] for key in keys_here])  # [m, lanes]
                sub = row_sks[idxs]  # [n, lanes]
                hit = ops.subsume_np(sub, q)  # [n, m]
                for a, i in enumerate(idxs):
                    matched_keys[i] = [
                        key for b, key in enumerate(keys_here) if hit[a, b]
                    ]
        else:
            matched_keys = [keys_of_value[v] for _g, _c, v in table_pls]
            for km in matched_keys:
                stats.filter_checks += len(km)

        r_checked = 0
        matched_items = 0
        pairs: list[tuple[tuple, int]] = []  # (query key, global row)
        pruned = False
        for i, (grow, _col, value) in enumerate(table_pls):
            # table filter rule 2 (lines 14-15)
            if len(heap) >= k and l_t - r_checked + matched_items <= j_k():
                stats.tables_pruned_rule2 += 1
                pruned = True
                break
            km = matched_keys[i]
            stats.filter_passed += len(km)
            for key in km:
                pairs.append((key, grow))
            matched_items += int(bool(km))
            r_checked += 1
            stats.pl_items_checked += 1
        if pruned:
            continue

        # ---- calculateJ (line 21): exact verification + mapping argmax ----
        rows_per_mapping: dict[tuple[int, ...], set] = defaultdict(set)
        for key, grow in pairs:
            mappings = _verify_pair(key, corpus.row_values(grow))
            if mappings:
                stats.verified_tp += 1
                for m in mappings:
                    rows_per_mapping[m].add(key)
            else:
                stats.verified_fp += 1
        if rows_per_mapping:
            mapping, rows = max(
                rows_per_mapping.items(), key=lambda kv: (len(kv[1]), kv[0])
            )
            joinability = len(rows)
        else:
            mapping, joinability = None, 0

        best_mapping[tid] = mapping
        if joinability > 0:
            if len(heap) < k:
                heapq.heappush(heap, (joinability, -tid))
            elif joinability > heap[0][0]:
                heapq.heapreplace(heap, (joinability, -tid))

    entries = [
        TopKEntry(table_id=-neg, joinability=j, mapping=best_mapping.get(-neg))
        for j, neg in heap
    ]
    entries.sort(key=lambda e: (-e.joinability, e.table_id))
    return entries, stats


# ---------------------------------------------------------------------------
# Brute-force oracle (tests): exact top-k by scanning every table.
# ---------------------------------------------------------------------------

def joinability_bruteforce(
    corpus: Corpus, table_id: int, query: Table, q_cols: list[int]
) -> int:
    keys = {tuple(row[c] for c in q_cols) for row in query.cells}
    rows_per_mapping: dict[tuple[int, ...], set] = defaultdict(set)
    for row in corpus.tables[table_id].cells:
        for key in keys:
            for m in _verify_pair(key, row):
                rows_per_mapping[m].add(key)
    return max((len(s) for s in rows_per_mapping.values()), default=0)


def topk_bruteforce(
    corpus: Corpus, query: Table, q_cols: list[int], k: int
) -> list[tuple[int, int]]:
    scores = [
        (joinability_bruteforce(corpus, t.table_id, query, q_cols), t.table_id)
        for t in corpus.tables
    ]
    scores = [(j, t) for j, t in scores if j > 0]
    scores.sort(key=lambda x: (-x[0], x[1]))
    return [(t, j) for j, t in scores[:k]]
