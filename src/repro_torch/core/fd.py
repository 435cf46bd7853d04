"""Multi-table FD discovery on the shared super-key index.

Port of ``repro.core.fd``: host logic on top of the ported engines, so
every verdict and counter is bit-identical to the reference's.

The workload: given a query relation Q and a candidate functional dependency
``determinant_cols → dependent_col`` over Q's columns, report — for every
lake table T that joins Q on the determinant key set — whether the FD also
holds on the (never materialized) join Q ⋈ T.  A determinant group breaks
the FD in the join exactly when (a) it maps to more than one dependent value
among Q's rows AND (b) the group's key actually matches a row of T; so the
per-table verdict needs only Q's group→dependent-values map (host-side,
tiny) plus the set of determinant keys matched in T.

Two phases, both reused from ``core.batched``:

  A. ``plan_and_count`` runs the ONE filter launch for the determinant key
     set (on CUDA under the default 'fused-gather' backend: kernel B.2,
     rows gathered from the device superkey store) and returns per-table
     eligible-hit counts.  The filter has no false negatives (§6.3 lemma),
     so the count is an UPPER bound on true matched pairs: ``counts <
     min_support`` proves true support is below the bar.  Refuted tables
     are pruned before any superkey byte moves.
  B. Survivors re-gather their candidate rows' super keys (epoch-pinned;
     on the routed lake ``ShardedMateIndex.superkey_of_rows`` pulls each
     row from its OWNING shard) and every filter-surviving (row, key) pair is verified exactly
     (``discovery._verify_pair``), yielding the matched determinant-key
     set, the support, and the violation count.

Multi-signal mode: XASH joinability becomes one signal in a weighted
ensemble with the profile features — uniqueness (card_max/n_rows), min-hash
sketch similarity, and table-name token overlap.  Signals only SCORE and
reorder candidates; the reported support/holds/violations facts are
identical with signals off.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import batched as batched_lib
from repro_torch.core import discovery as seq
from repro_torch.core import profiles, ranking
from repro_torch.core.corpus import Table
from repro_torch.core.discovery import DiscoveryStats
from repro_torch.kernels import ops
from repro_torch.kernels.registry import Backend

# the multi-signal ensemble's vocabulary (DiscoveryConfig(signals=...)
# validates against this):
#   joinability — matched determinant keys / distinct query keys (the XASH
#                 instance-level signal, from phase B's exact support)
#   uniqueness  — max column cardinality / rows (profile store): high means
#                 the matched column looks like a key on the lake side too
#   sketch      — min-hash sketch positions shared with the query's key
#                 values / SKETCH_K (containment beyond the matched keys)
#   name        — token Jaccard of the lowercased table names (the schema-
#                 level signal)
SIGNAL_NAMES = ("joinability", "uniqueness", "sketch", "name")

# launch-facing default: joinability dominates, profile signals break ties
DEFAULT_SIGNALS = (
    ("joinability", 0.5),
    ("uniqueness", 0.2),
    ("sketch", 0.2),
    ("name", 0.1),
)


@dataclasses.dataclass
class FDCandidate:
    """Per-table verdict for one candidate FD on the virtual join Q ⋈ T."""

    table_id: int
    support: int  # distinct determinant keys exactly matched in the table
    holds: bool  # every matched determinant group maps to ONE dependent value
    violations: int  # matched groups with >1 dependent value among Q's rows
    score: float | None = None  # multi-signal ensemble score (signals mode
    # only; never changes support/holds — ordering/annotation, like
    # TopKEntry.quality)


def dependent_groups(
    query: Table, determinant_cols: list[int], dependent_col: int
) -> dict[tuple, set]:
    """Determinant key → set of dependent values among the query's rows.

    Duplicate rows collapse naturally (sets); a group holding the FD on Q
    itself has a singleton value set, and a table preserves the FD on the
    join iff none of its MATCHED groups has a larger one.
    """
    out: dict[tuple, set] = {}
    for row in query.cells:
        key = tuple(row[c] for c in determinant_cols)
        out.setdefault(key, set()).add(row[dependent_col])
    return out


def discover_fds(
    index,
    query: Table,
    determinant_cols: list[int],
    dependent_col: int,
    *,
    min_support: int = 1,
    backend: Backend | str | None = None,
    init_mode: str = "cardinality",
    profile_gate: bool = False,
    signals: tuple[tuple[str, float], ...] | None = None,
    fused_block_n: int | None = None,
) -> tuple[list[FDCandidate], DiscoveryStats]:
    """Phase A + phase B in one call (the session entry point).

    Returns the per-table FD verdicts for tables with exact support ≥
    ``min_support`` (default order: -support, table_id; ``signals`` reorders
    by ensemble score) plus a ``DiscoveryStats`` whose ``fd_candidates`` /
    ``fd_validated`` / ``fd_bytes_verified`` counters prove the prune.
    ``backend`` resolves on the index's device, as in ``core.batched``.
    """
    if dependent_col in determinant_cols:
        raise ValueError(
            f"dependent_col {dependent_col} is one of the determinant "
            f"columns {determinant_cols} — the FD would be trivial"
        )
    [pc] = batched_lib.plan_and_count(
        index,
        [(query, list(determinant_cols))],
        backend,
        init_mode=init_mode,
        fused_block_n=fused_block_n,
        profile_gate=profile_gate,
    )
    return fds_from_counts(
        index,
        pc,
        dependent_col,
        min_support=min_support,
        signals=signals,
    )


def fds_from_counts(
    index,
    pc: "batched_lib.PlanCounts",
    dependent_col: int,
    *,
    min_support: int = 1,
    signals: tuple[tuple[str, float], ...] | None = None,
) -> tuple[list[FDCandidate], DiscoveryStats]:
    """Phase B: count-prune + exact validation over one ``PlanCounts``.

    Split out (mirroring ``score_from_counts``) so the launch can be shared
    or cached upstream.  Stats land on a FRESH copy of the plan's, with the
    same launch-transfer attribution as joinability scoring.  The re-gather
    is epoch-pinned: an index mutated since the launch raises instead of
    validating against rows the filter never saw.
    """
    plan = dataclasses.replace(pc.plan, stats=dataclasses.replace(pc.plan.stats))
    stats, block = plan.stats, plan.block
    query, det_cols = plan.query, plan.q_cols
    n_items = block.n_items
    stats.pl_items_checked = n_items
    stats.filter_checks = int(plan.elig.sum())
    stats.filter_passed = int(pc.counts.sum())
    stats.filter_lanes = pc.filter_lanes
    if pc.fused:
        stats.filter_fused_launches += 1
        stats.filter_readback_bytes += pc.counts.nbytes
        stats.gather_bytes_saved += pc.gather_saved
        stats.shard_launches += pc.route_launches
        stats.route_bytes_merged += pc.route_bytes
    else:
        stats.filter_matrix_bytes += n_items * pc.group_keys
        if pc.hits_host:
            stats.filter_readback_bytes += n_items * pc.group_keys
    stats.fd_candidates = block.n_tables
    if pc.epoch != index.mutation_epoch:
        raise ValueError(
            f"stale PlanCounts: index mutated since the filter launch "
            f"(epoch {pc.epoch} -> {index.mutation_epoch}) — the validation "
            f"re-gather would read rows the filter never probed"
        )
    dep_of_key = dependent_groups(query, det_cols, dependent_col)
    corpus = index.corpus
    counts = np.asarray(pc.counts)
    ptr = block.table_ptr
    out: list[FDCandidate] = []
    for t in range(block.n_tables):
        # counts-as-refutation: the filter count upper-bounds true matched
        # pairs (≥ distinct matched keys), so a count below min_support
        # PROVES the table's support is too — pruned without any re-gather.
        if int(counts[t]) < min_support:
            continue
        stats.fd_validated += 1
        lo, hi = int(ptr[t]), int(ptr[t + 1])
        rows = block.rows[lo:hi]
        # full-width re-gather (row_sk keeps full width even on degraded
        # launches); gather-fused/routed launches left row_sk None — pull
        # the slices from the index store / owning shard, epoch-pinned above.
        rsk = (
            pc.row_sk[lo:hi]
            if pc.row_sk is not None
            else index.superkey_of_rows(rows)
        )
        stats.fd_bytes_verified += int(rsk.nbytes)
        sub = ops.subsume_np(rsk, plan.q_sk) & plan.elig[lo:hi]
        matched: set = set()
        for r, kid in zip(*np.nonzero(sub)):
            key = plan.distinct_keys[int(kid)]
            if key in matched:
                continue
            if seq._verify_pair(key, corpus.row_values(int(rows[int(r)]))):
                stats.verified_tp += 1
                matched.add(key)
            else:
                stats.verified_fp += 1
        support = len(matched)
        if support < min_support:
            continue
        violations = sum(1 for key in matched if len(dep_of_key[key]) > 1)
        out.append(
            FDCandidate(
                table_id=int(block.table_ids[t]),
                support=support,
                holds=violations == 0,
                violations=violations,
            )
        )
    if signals is not None and out:
        _ensemble_scores(index, plan, out, signals)
        out.sort(key=lambda c: (-c.score, -c.support, c.table_id))
    else:
        out.sort(key=lambda c: (-c.support, c.table_id))
    return out, stats


def _name_tokens(name: str) -> frozenset:
    return frozenset(
        tok for tok in "".join(
            ch if ch.isalnum() else " " for ch in name.lower()
        ).split() if tok
    )


def _token_jaccard(a: frozenset, b: frozenset) -> float:
    if not a or not b:
        return 0.0
    return len(a & b) / len(a | b)


def _ensemble_scores(
    index,
    plan: "batched_lib.QueryPlan",
    fds: list[FDCandidate],
    signals: tuple[tuple[str, float], ...],
) -> None:
    """Annotate each candidate with its weighted multi-signal score.

    Pure host arithmetic (float64, the reference's op order) over the exact
    support (phase B) and the profile store's features — deterministic and
    backend-independent, so scored orderings are bit-identical too.
    """
    w = dict(signals)
    unknown = set(w) - set(SIGNAL_NAMES)
    if unknown:
        raise ValueError(f"unknown signals {sorted(unknown)}; valid: {SIGNAL_NAMES}")
    n_keys = max(len(plan.distinct_keys), 1)
    tids = np.asarray([c.table_id for c in fds], dtype=np.int64)
    card_max, n_rows, sketch = index.profile_features(tids)
    q_sketch = ranking.query_sketch(index, plan.distinct_keys)
    sketch_sim = (
        (sketch == q_sketch[None, :]).sum(axis=1).astype(np.float64)
        / profiles.SKETCH_K
    )
    uniqueness = card_max.astype(np.float64) / np.maximum(n_rows, 1)
    q_tokens = _name_tokens(plan.query.name)
    tables = index.corpus.tables
    for i, cand in enumerate(fds):
        score = (
            w.get("joinability", 0.0) * (cand.support / n_keys)
            + w.get("uniqueness", 0.0) * float(uniqueness[i])
            + w.get("sketch", 0.0) * float(sketch_sim[i])
            + w.get("name", 0.0)
            * _token_jaccard(q_tokens, _name_tokens(tables[cand.table_id].name))
        )
        cand.score = float(score)
