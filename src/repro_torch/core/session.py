"""Unified MATE discovery surface: one frozen config, one session object.

Port of ``repro.core.session``.  ``DiscoveryConfig`` keeps exactly the
reference's fields and validation messages; the device is a keyword of
``MateSession.build`` (``None`` means CUDA, and raises without it), not a
config field.  Not ported yet, and raising ``NotImplementedError``: the
sharded / routed build (``mesh=``, ``n_shards>1``, ``distributed=True``:
ROADMAP A.7) and ``discover_fds`` (ROADMAP A.6).

MATE's pipeline (paper §4–6: super-key index → XASH filter → verification)
is one system, but three PRs of growth left four entry points
(``discover``, ``discover_batched``, ``discover_many``, ``DiscoveryEngine``)
each re-threading ``bits``/``k``/``batch_tables`` positionally and selecting
the filter backend through disjoint idioms.  This module collapses that to:

  * ``DiscoveryConfig`` — a FROZEN dataclass holding every knob of the
    online phase (hash width, default top-k, filter backend, init-column
    heuristic, batching, readback policy, serving window/deadline).  Being
    immutable and hashable it is exactly the thing a request loop holds and
    the thing launch caches key on.
  * ``MateSession`` — the facade owning the ``MateIndex``, the backend
    resolved ONCE through ``kernels.registry`` (explicit config > env var >
    platform default), and per-session aggregate stats.  ``build`` runs the
    offline phase; ``discover`` / ``discover_many`` run the online phase
    through the batched kernel engines with results bit-identical to the
    pre-session entry points (and to scalar Algorithm 1).

``serve.engine.DiscoveryEngine`` is rebuilt on top of a ``MateSession`` as
the async-capable serving loop (arrival-window batching, deadlines,
futures); this module stays synchronous and loop-free on purpose — a
session is safe to embed anywhere, including inside that loop.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import batched as batched_lib
from repro_torch.core import index as index_lib
from repro_torch.core import xash
from repro_torch.core.corpus import Corpus, Table
from repro_torch.core.discovery import DiscoveryStats, TopKEntry
from repro_torch.core.index import BuildStats, MateIndex
from repro_torch.kernels import registry
from repro_torch.kernels.registry import Backend

# super-key widths the kernels are exercised at (4/8/16 uint32 lanes)
VALID_BITS = (128, 256, 512)

# the FD workload's signal names (``repro.core.fd.SIGNAL_NAMES``), kept here
# so that ``signals`` validates exactly as in the reference until the FD
# workload is ported (ROADMAP A.6)
SIGNAL_NAMES = ("joinability", "uniqueness", "sketch", "name")


@dataclasses.dataclass(frozen=True)
class DiscoveryConfig:
    """Every knob of a MATE deployment, in one immutable object.

    Offline phase:
      bits / hash_name / use_corpus_char_freq — index build parameters
        (``bits`` is the super-key width: 128/256/512 → 4/8/16 uint32 lanes).

    Online phase:
      k            — default top-k per request (per-request override allowed).
      backend      — filter backend name ('fused-gather' | 'fused' |
                     'pallas' | 'xla' | 'numpy' | 'auto') or None for
                     registry resolution (its environment variable, then
                     platform default).  'fused-gather' DMA-gathers the
                     candidate rows from the device superkey store inside
                     the fused launch, demoting to 'fused' when the store
                     doesn't fit the device budget.
      init_mode    — §6.1 initial-column heuristic.
      batch_tables — tables per filter launch in ``discover``.
      fused_block_n — optional row-block override for the fused kernel
                     (power of two ≥ 128; validated only — the CUDA
                     kernels size their own blocks).
      prefetch_frac — readback policy: below this fraction of batch items
                     surviving the entry bound, per-table hit-slice
                     readbacks beat one whole-batch transfer.
      rank         — result ordering: 'quality' (default) runs the
                     ``core.ranking`` scoring head over the filter counts
                     and orders by join quality; 'count' is the historical
                     exact-joinability order.  The verified top-k SET is
                     identical either way — rank only reorders/annotates.
      profile_gate — run the column-profile pre-filter (``core.profiles``)
                     in front of candidate gathering: tables whose profiles
                     PROVE joinability 0 are dropped before any filter
                     launch.  Pure pruning — results are set-identical with
                     the gate off.  (The raw ``core.batched`` functions
                     default BOTH knobs off for bit-stable legacy callers;
                     the session/serving surface defaults them on.)
      signals      — multi-signal ensemble for the FD workload
                     (``MateSession.discover_fds``): a tuple of
                     (name, weight) pairs over ``core.fd.SIGNAL_NAMES``
                     ('joinability' | 'uniqueness' | 'sketch' | 'name'),
                     kept as a tuple-of-tuples so the frozen config stays
                     hashable.  None (default) orders FD candidates by raw
                     support; the reported support/holds/violations facts
                     are identical either way — signals only score/reorder.

    Serving (consumed by ``serve.engine.DiscoveryEngine``):
      window       — max requests per shared filter launch (group size).
      flush_after  — seconds a queued request may wait for its group to
                     fill before the engine serves a partial group
                     (None: only full groups flush; ``flush()`` always
                     drains regardless).
      deadline_margin — seconds before a group's ``flush_after`` deadline
                     the engine launches it PARTIAL, so the group is served
                     by its deadline instead of merely started at it
                     (None: auto — an EWMA of observed group service times).
      max_queue    — bounded submit queue: beyond this many waiting
                     requests admission control kicks in (None: unbounded).
      pressure_policy — what admission control does at ``max_queue``:
                     'shed' rejects the request's future with
                     ``serve.engine.AdmissionError``; 'degrade' admits it
                     flagged for ``degrade_bits`` filtering (sheds anyway
                     at 2×``max_queue`` — degraded filtering relieves
                     filter bandwidth, not an unbounded backlog).
      degrade_bits — filter width for degraded requests (a lane-prefix
                     relaxation of the index width: results stay
                     bit-identical, filter precision drops).
      result_cache — capacity (entries) of the serving tier's query-result
                     cache; 0 disables.  Hits are bit-identical replays of
                     the cached top-k, invalidated on §5.4 mutations.
      bound_cache  — capacity (entries) of the hot-table bound cache
                     (cached ``PlanCounts``: hits skip gather_candidates +
                     the filter launch); 0 disables.
    """

    bits: int = 128
    k: int = 10
    backend: str | None = None
    init_mode: str = "cardinality"
    batch_tables: int = batched_lib.DEFAULT_BATCH_TABLES
    fused_block_n: int | None = None
    prefetch_frac: float = batched_lib._PREFETCH_FRAC
    rank: str = "quality"
    profile_gate: bool = True
    signals: tuple[tuple[str, float], ...] | None = None
    hash_name: str = "xash"
    use_corpus_char_freq: bool = True
    window: int = 8
    flush_after: float | None = None
    deadline_margin: float | None = 0.0
    max_queue: int | None = None
    pressure_policy: str = "shed"
    degrade_bits: int = 128
    result_cache: int = 0
    bound_cache: int = 0

    def __post_init__(self):
        if self.bits not in VALID_BITS:
            raise ValueError(f"bits must be one of {VALID_BITS}, got {self.bits}")
        if self.backend is not None:
            registry.resolve_backend(self.backend)  # raises on unknown names
        if self.fused_block_n is not None and (
            self.fused_block_n < 128
            or self.fused_block_n & (self.fused_block_n - 1)
        ):
            raise ValueError(
                f"fused_block_n must be a power of two >= 128, got {self.fused_block_n}"
            )
        if self.rank not in ("quality", "count"):
            raise ValueError(
                f"rank must be 'quality' or 'count', got {self.rank!r}"
            )
        if self.signals is not None:
            if not isinstance(self.signals, tuple):
                raise ValueError(
                    "signals must be a tuple of (name, weight) pairs or None "
                    f"(got {type(self.signals).__name__} — dicts/lists are "
                    "unhashable, which would break the frozen config)"
                )
            for pair in self.signals:
                if not (isinstance(pair, tuple) and len(pair) == 2):
                    raise ValueError(
                        f"each signal must be a (name, weight) pair, got {pair!r}"
                    )
                name, weight = pair
                if name not in SIGNAL_NAMES:
                    raise ValueError(
                        f"unknown signal {name!r}; valid: {SIGNAL_NAMES}"
                    )
                if not weight > 0:
                    raise ValueError(
                        f"signal weight must be > 0, got {name}={weight!r}"
                    )
        if not 0.0 <= self.prefetch_frac <= 1.0:
            raise ValueError(f"prefetch_frac must be in [0, 1], got {self.prefetch_frac}")
        if self.batch_tables < 1:
            raise ValueError(f"batch_tables must be >= 1, got {self.batch_tables}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.flush_after is not None and self.flush_after < 0:
            raise ValueError(f"flush_after must be >= 0, got {self.flush_after}")
        if self.deadline_margin is not None and self.deadline_margin < 0:
            raise ValueError(
                f"deadline_margin must be >= 0 or None (auto), got {self.deadline_margin}"
            )
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, got {self.max_queue}")
        if self.pressure_policy not in ("shed", "degrade"):
            raise ValueError(
                f"pressure_policy must be 'shed' or 'degrade', got {self.pressure_policy!r}"
            )
        if self.degrade_bits not in VALID_BITS:
            raise ValueError(
                f"degrade_bits must be one of {VALID_BITS}, got {self.degrade_bits}"
            )
        if self.result_cache < 0:
            raise ValueError(f"result_cache must be >= 0, got {self.result_cache}")
        if self.bound_cache < 0:
            raise ValueError(f"bound_cache must be >= 0, got {self.bound_cache}")

    def resolve_backend(self, platform: str | None = None) -> Backend:
        """The backend this config selects, under the registry precedence
        (``platform``: 'cuda' | 'cpu', the device the index lives on)."""
        return registry.resolve_backend(self.backend, platform)


# DiscoveryStats counters ``SessionStats.absorb`` does NOT aggregate:
# per-request plan shape (meaningless summed across requests) and the
# per-launch lane width.  Every OTHER DiscoveryStats field is absorbed by
# name — so adding a counter to DiscoveryStats without either mirroring it
# on SessionStats or listing it here raises AttributeError on the first
# absorb, instead of silently dropping it from session accounting (the
# hand-patched-aggregation failure mode of PRs 7–8).
_NOT_AGGREGATED = frozenset({
    "tables_fetched",
    "tables_evaluated",
    "tables_pruned_rule1",
    "tables_pruned_rule2",
    "pl_items_total",
    "pl_items_checked",
    "filter_lanes",
})
_ABSORBED = tuple(
    f.name
    for f in dataclasses.fields(DiscoveryStats)
    if f.name not in _NOT_AGGREGATED
)


@dataclasses.dataclass
class SessionStats:
    """Aggregate accounting across every request a session served."""

    requests: int = 0
    filter_checks: int = 0
    filter_passed: int = 0
    verified_tp: int = 0
    verified_fp: int = 0
    filter_matrix_bytes: int = 0
    filter_readback_bytes: int = 0
    filter_fused_launches: int = 0
    gather_bytes_saved: int = 0
    # routed-index counters (``core.routing.ShardedMateIndex`` sessions):
    shard_launches: int = 0  # shard-local filter launches routed to the data
    route_bytes_merged: int = 0  # cross-shard count-merge bytes (the ONLY
    # bytes that cross a shard boundary on the routed filter path)
    shard_gather_demotions: int = 0  # shard launches demoted off gather-fused
    # ranking-subsystem counters (``core.profiles`` / ``core.ranking``):
    tables_gated: int = 0  # candidate tables the profile gate dropped
    gate_bytes_saved: int = 0  # superkey bytes the gate kept out of filters
    ranking_launches: int = 0  # quality-scoring launches
    # FD-workload counters (``core.fd.discover_fds``):
    fd_candidates: int = 0  # candidate tables entering FD workloads
    fd_validated: int = 0  # tables surviving the count prune into validation
    fd_bytes_verified: int = 0  # superkey bytes validation re-gathered
    # serving-tier counters (bumped by ``serve.engine.DiscoveryEngine``):
    cache_hits: int = 0  # requests answered from the query-result cache
    bound_hits: int = 0  # requests scored from cached PlanCounts (skipped
    # gather_candidates + the filter launch)
    shed: int = 0  # requests rejected by admission control (queue full)
    degraded: int = 0  # requests admitted at degrade_bits filter width

    def absorb(self, stats: DiscoveryStats) -> None:
        self.requests += 1
        for name in _ABSORBED:
            setattr(self, name, getattr(self, name) + getattr(stats, name))

    @property
    def precision(self) -> float:
        denom = self.verified_tp + self.verified_fp
        return self.verified_tp / denom if denom else 1.0


class MateSession:
    """One indexed lake + one resolved backend + one config = one session.

    ``build`` runs the offline phase from a corpus; the constructor wraps an
    already-built ``MateIndex`` (the config's ``bits``/``hash_name`` are
    adopted from the index, which is the ground truth for what was built).
    The backend is resolved exactly once, at construction — a session never
    re-reads the environment, so a long-lived serving process cannot change
    dispatch mid-flight.
    """

    def __init__(self, index: MateIndex, config: DiscoveryConfig | None = None):
        config = config or DiscoveryConfig()
        # the index is ground truth for offline-phase knobs; keep the frozen
        # config consistent with it so session.config never lies.
        config = dataclasses.replace(
            config, bits=index.bits, hash_name=index.hash_name
        )
        self.index = index
        self.config = config
        self.backend = config.resolve_backend(index.device.type)
        self.stats = SessionStats()
        # set by ``build``; None when wrapping an externally built index
        self.build_stats: BuildStats | None = None

    @classmethod
    def build(
        cls,
        corpus: Corpus,
        config: DiscoveryConfig | None = None,
        *,
        mesh=None,
        row_axes: tuple[str, ...] | None = None,
        n_shards: int | None = None,
        distributed: bool = False,
        device=None,
    ) -> "MateSession":
        """Offline phase (§4/§5): hash + index ``corpus`` per ``config`` on
        ``device`` (None: the CUDA device; raises when there is none — pass
        ``device="cpu"`` for the plain PyTorch path).  Accounting lands in
        ``session.build_stats``.  The sharded and routed builds (``mesh``,
        ``n_shards > 1``, ``distributed=True``) are ROADMAP A.7 and raise."""
        config = config or DiscoveryConfig()
        if distributed:
            raise NotImplementedError(
                "MateSession.build(distributed=True) (routed lake) is not"
                " ported yet: ROADMAP A.7"
            )
        index, build_stats = index_lib.build_index(
            corpus,
            cfg=xash.XashConfig(bits=config.bits),
            hash_name=config.hash_name,
            use_corpus_char_freq=config.use_corpus_char_freq,
            mesh=mesh,
            row_axes=row_axes,
            n_shards=n_shards,
            device=device,
        )
        session = cls(index, config)
        session.build_stats = build_stats
        return session

    @property
    def bits(self) -> int:
        return self.index.bits

    def discover(
        self, query: Table, q_cols: list[int], k: int | None = None
    ) -> tuple[list[TopKEntry], DiscoveryStats]:
        """Top-k n-ary join discovery for one query (batched Algorithm 1)."""
        entries, stats = batched_lib.discover_batched(
            self.index,
            query,
            q_cols,
            k=self.config.k if k is None else k,
            batch_tables=self.config.batch_tables,
            init_mode=self.config.init_mode,
            backend=self.backend,
            prefetch_frac=self.config.prefetch_frac,
            fused_block_n=self.config.fused_block_n,
            rank=self.config.rank,
            profile_gate=self.config.profile_gate,
        )
        self.stats.absorb(stats)
        return entries, stats

    def discover_many(
        self,
        queries: list[tuple[Table, list[int]]],
        k: int | list[int] | None = None,
    ) -> list[tuple[list[TopKEntry], DiscoveryStats]]:
        """Multi-query discovery sharing ONE filter launch (group batching)."""
        out = batched_lib.discover_many(
            self.index,
            queries,
            k=self.config.k if k is None else k,
            init_mode=self.config.init_mode,
            backend=self.backend,
            prefetch_frac=self.config.prefetch_frac,
            fused_block_n=self.config.fused_block_n,
            rank=self.config.rank,
            profile_gate=self.config.profile_gate,
        )
        for _, stats in out:
            self.stats.absorb(stats)
        return out

    def plan_and_count(
        self,
        queries: list[tuple[Table, list[int]]],
        *,
        filter_lanes: int | None = None,
    ) -> list["batched_lib.PlanCounts"]:
        """Phase A of group discovery: the shared filter launch, demuxed per
        request (``core.batched.plan_and_count`` under this session's
        backend/config).  No stats are absorbed here — a request only counts
        when its PlanCounts is scored.  ``filter_lanes`` runs the launch at
        a lane prefix (the serving tier's pressure-degrade path)."""
        return batched_lib.plan_and_count(
            self.index,
            queries,
            self.backend,
            init_mode=self.config.init_mode,
            filter_lanes=filter_lanes,
            fused_block_n=self.config.fused_block_n,
            profile_gate=self.config.profile_gate,
        )

    def score_from_counts(
        self,
        pc: "batched_lib.PlanCounts",
        k: int | None = None,
        *,
        from_cache: bool = False,
    ) -> tuple[list[TopKEntry], DiscoveryStats]:
        """Phase B: score one ``PlanCounts`` (rule-1/2 pruning + exact
        verification + top-k heap) and absorb the request into session
        stats.  Safe to call repeatedly on the same PlanCounts — the
        bound-cache replay path (``from_cache=True`` skips launch-transfer
        accounting; the filter was paid for by an earlier request)."""
        entries, stats = batched_lib.score_from_counts(
            self.index,
            pc,
            self.config.k if k is None else k,
            prefetch_frac=self.config.prefetch_frac,
            from_cache=from_cache,
            rank=self.config.rank,
        )
        self.stats.absorb(stats)
        return entries, stats

    def discover_fds(self, *args, **kwargs):
        """The FD workload (``repro.core.fd``) is ROADMAP A.6."""
        raise NotImplementedError("discover_fds is not ported yet: ROADMAP A.6")

    # index mutation passes through (§5.4): the session stays valid because
    # MateIndex updates are in-place and the backend/config hold no arrays.
    def insert_table(self, cells: list[list[str]], name: str = "") -> int:
        return self.index.insert_table(cells, name)

    def delete_table(self, table_id: int) -> None:
        self.index.delete_table(table_id)

    def update_cell(self, table_id: int, row: int, col: int, value: str) -> None:
        self.index.update_cell(table_id, row, col, value)

    def __repr__(self) -> str:
        return (
            f"MateSession(tables={len(self.index.corpus.tables)}, "
            f"bits={self.bits}, hash={self.index.hash_name}, "
            f"backend={self.backend.name}[{self.backend.source}], "
            f"served={self.stats.requests})"
        )
