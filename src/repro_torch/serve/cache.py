"""Serving-tier caches: query-result memoization + hot-table bound cache.

Port of ``repro.serve.cache``: ``query_fingerprint`` gives the reference's
digests byte for byte, so a fingerprint names the same traffic in both
packages.

Skewed traffic is the serving tier's defining workload (FREYJA-style lakes:
a few popular query tables dominate), so two LRU caches sit in front of the
group filter launch, both keyed on ``query_fingerprint`` — a digest of the
HASHED KEY-COLUMN CONTENT of the query, not object identity:

  * ``QueryResultCache`` — (fingerprint, k) → the finished top-k + stats.
    A hit is resolved at ``submit`` time without touching the queue, the
    index or the device, and is BIT-IDENTICAL to a fresh ``discover`` by
    construction: for a fixed index epoch the fingerprint determines every
    downstream artifact (init column, candidate block, filter, top-k).

  * ``BoundCache`` — fingerprint → ``core.batched.PlanCounts`` (the phase-A
    artifact: candidate block + per-table filtered-candidate counts, matrix
    slice dropped).  A hit skips ``gather_candidates`` + the filter launch
    entirely and goes straight to phase-B scoring
    (``score_from_counts(from_cache=True)``), which recomputes surviving
    tables' hit slices from the cached row super keys — the same
    subsumption predicate, so verification inputs and the top-k stay
    bit-identical.  Unlike the result cache it serves ANY ``k``.

Invalidation: every §5.4 index mutation (insert/update/delete) bumps
``MateIndex.mutation_epoch``; entries pin the epoch they were filled at and
``get`` drops any entry whose epoch no longer matches.  One global counter
is deliberately conservative — it invalidates the affected entries (a
mutation can change any table's candidacy for any cached query: a new
table's rows enter posting lists, a tombstone removes them) by invalidating
everything stale, so a stale top-k can never be served.  Per-table
dependency tracking would save refills, not correctness, and is left out.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

from repro_torch.core.batched import PlanCounts
from repro_torch.core.corpus import Table
from repro_torch.core.discovery import DiscoveryStats, TopKEntry


def query_fingerprint(
    query: Table,
    q_cols: list[int],
    init_mode: str = "cardinality",
    rank: str = "count",
    profile_gate: bool = False,
    workload: str = "join",
) -> bytes:
    """Digest of everything about a QUERY that determines its discovery
    result for a fixed index: the init-column heuristic, the key width, and
    the ordered sequence of key tuples (row order matters for the
    deterministic tie-breaks in init-column selection and key dedup order).

    Two query tables with the same key-column content — regardless of
    table name, id, or non-key columns — share a fingerprint, which is the
    whole point: the cache recognises repeated traffic by content.

    ``rank``/``profile_gate`` join the digest because they shape the CACHED
    ARTIFACTS: rank changes entry order/annotation, the gate changes the
    candidate block a cached ``PlanCounts`` holds — a count-mode fill must
    never answer a quality-mode request (the sets match, the payloads
    don't).  Both default to the raw-engine defaults so pre-existing
    fingerprints are unchanged.

    ``workload`` discriminates WHAT is being asked of those key columns:
    'join' (top-k joinability, the default) vs FD workloads
    (``core.fd.discover_fds`` — callers encode the dependent column and
    min_support, e.g. ``f"fd:{dependent_col}:{min_support}"``).  An FD
    request over the same determinant columns must never hit a
    joinability fill: the cached payloads are different types entirely.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(
        f"{init_mode}|{len(q_cols)}|{rank}|{int(profile_gate)}|{workload}".encode()
    )
    for row in query.cells:
        for c in q_cols:
            v = row[c].encode()
            # length-prefix framing: ("ab","c") must not collide with ("a","bc")
            h.update(len(v).to_bytes(4, "little"))
            h.update(v)
        h.update(b"\xff")
    return h.digest()


@dataclasses.dataclass
class CacheStats:
    """Per-cache accounting (the engine also mirrors hits into
    ``SessionStats.cache_hits`` / ``bound_hits``)."""

    hits: int = 0
    misses: int = 0
    stale: int = 0  # entries dropped because the index epoch moved (§5.4)
    evictions: int = 0  # capacity-driven LRU evictions

    @property
    def hit_rate(self) -> float:
        denom = self.hits + self.misses
        return self.hits / denom if denom else 0.0


class _LruCache:
    """Bounded OrderedDict LRU with epoch-checked reads."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.stats = CacheStats()
        self._entries: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def _get(self, key, epoch: int):
        ent = self._entries.get(key)
        if ent is None:
            self.stats.misses += 1
            return None
        if ent[0] != epoch:  # a §5.4 mutation happened since the fill
            del self._entries[key]
            self.stats.stale += 1
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        return ent

    def _put(self, key, ent) -> None:
        self._entries[key] = ent
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def invalidate_all(self) -> None:
        self._entries.clear()


class QueryResultCache(_LruCache):
    """(fingerprint, k) → finished (top-k entries, stats) memoization."""

    def get(
        self, fp: bytes, k: int, epoch: int
    ) -> tuple[list[TopKEntry], DiscoveryStats] | None:
        ent = self._get((fp, k), epoch)
        if ent is None:
            return None
        _, entries, stats = ent
        # fresh copies: callers own their results and must not be able to
        # corrupt the cached ones (TopKEntry is a mutable dataclass).
        return (
            [dataclasses.replace(e) for e in entries],
            dataclasses.replace(stats),
        )

    def put(
        self,
        fp: bytes,
        k: int,
        epoch: int,
        entries: list[TopKEntry],
        stats: DiscoveryStats,
    ) -> None:
        self._put(
            (fp, k),
            (
                epoch,
                tuple(dataclasses.replace(e) for e in entries),
                dataclasses.replace(stats),
            ),
        )


class BoundCache(_LruCache):
    """fingerprint → cached phase-A ``PlanCounts`` (hot-table bounds)."""

    def get(self, fp: bytes, epoch: int) -> PlanCounts | None:
        ent = self._get(fp, epoch)
        return None if ent is None else ent[1]

    def put(self, fp: bytes, pc: PlanCounts) -> None:
        # the matrix slice (possibly device-resident) is dropped up front —
        # cached entries are host-only and replay via lazy recompute.
        self._put(fp, (pc.epoch, pc.cacheable()))
