"""Synthetic table corpora (copy of ``repro.data.synthetic``).

Corpora mimicking webtable / open-data statistics (§7.1): many small tables,
zipfian value reuse across tables, controllable injected n-ary-joinable rows
so ground truth is known.  The generator draws from numpy's
``default_rng(seed)`` exactly as the reference does, so the same spec yields
a cell-identical corpus in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.corpus import Corpus, Table

_SYLLABLES = [
    "ka", "ro", "mi", "ta", "shi", "lo", "ber", "lin", "mun", "ich", "to",
    "kyo", "am", "ster", "dam", "bo", "ston", "cam", "bridge", "ox", "ford",
    "han", "over", "sto", "ck", "holm", "war", "saw", "pra", "gue", "vien",
    "na", "del", "hi", "se", "oul", "qui", "to", "li", "ma", "ac", "cra",
]

# heavy-tailed letter sampler (approx. English unigram distribution) so rare
# characters (j, q, x, z …) actually occur — webtable text is heavy-tailed,
# and XASH's least-frequent-character feature needs that tail to exist.
_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))
_LETTER_P = np.array(
    [8.17, 1.49, 2.78, 4.25, 12.7, 2.23, 2.02, 6.09, 6.97, 0.15, 0.77, 4.03,
     2.41, 6.75, 7.51, 1.93, 0.10, 5.99, 6.33, 9.06, 2.76, 0.98, 2.36, 0.15,
     1.97, 0.07]
)
_LETTER_P = _LETTER_P / _LETTER_P.sum()


def _random_word(rng: np.random.Generator, min_syl=1, max_syl=4) -> str:
    """Heterogeneous value: words, codes, numbers — webtable-like mix."""
    kind = rng.random()
    if kind < 0.45:  # syllable word(s)
        n = int(rng.integers(min_syl, max_syl + 1))
        w = "".join(rng.choice(_SYLLABLES) for _ in range(n))
        if rng.random() < 0.2:
            w += " " + rng.choice(_SYLLABLES)
    elif kind < 0.75:  # english-like letter string, varied length
        n = int(rng.integers(3, 20))
        w = "".join(rng.choice(_LETTERS, p=_LETTER_P, size=n))
        if rng.random() < 0.3:
            cut = int(rng.integers(1, n))
            w = w[:cut] + " " + w[cut:]
    elif kind < 0.9:  # numeric / code
        w = str(rng.integers(0, 10 ** int(rng.integers(2, 9))))
        if rng.random() < 0.3:
            w = "".join(rng.choice(_LETTERS, size=2)) + w
    else:  # long composite
        w = (
            "".join(rng.choice(_SYLLABLES) for _ in range(2))
            + " "
            + "".join(rng.choice(_LETTERS, p=_LETTER_P, size=int(rng.integers(4, 12))))
        )
    if rng.random() < 0.1:
        w += str(rng.integers(0, 10_000))
    return w


@dataclasses.dataclass
class SyntheticSpec:
    n_tables: int = 200
    rows_per_table: tuple[int, int] = (5, 60)
    cols_per_table: tuple[int, int] = (2, 24)  # power-law width: most tables
    width_alpha: float = 1.6  # narrow, heavy wide tail (webtable-like);
    # calibrated so hash-function precision ordering and magnitudes match
    # the paper's Table 2 (see EXPERIMENTS.md §Repro/precision)
    avg_pl_length: float = 12.0  # DWTC: ~12 posting-list items per value (§7.6.4)
    zipf_a: float = 1.8  # power-law head on top of the uniform body
    head_frac: float = 0.2  # fraction of cells drawn from the zipfian head
    seed: int = 0


def make_corpus(spec: SyntheticSpec) -> Corpus:
    rng = np.random.default_rng(spec.seed)
    # First pass: table shapes → total cells → pool size for target PL length.
    w_lo, w_hi = spec.cols_per_table
    widths = np.arange(w_lo, w_hi + 1)
    w_p = widths.astype(np.float64) ** -spec.width_alpha
    w_p /= w_p.sum()
    shapes = [
        (int(rng.integers(*spec.rows_per_table)), int(rng.choice(widths, p=w_p)))
        for _ in range(spec.n_tables)
    ]
    total_cells = sum(r * c for r, c in shapes)
    pool_size = max(int(total_cells / spec.avg_pl_length), 50)
    pool = list(dict.fromkeys(_random_word(rng) for _ in range(pool_size * 3)))[:pool_size]
    pool_size = len(pool)
    tables = []
    for tid, (n_rows, n_cols) in enumerate(shapes):
        # power-law head (frequent values everywhere) + uniform body:
        # reproduces the paper's observation that PL length is power-law
        # distributed with a long flat tail (§7.6.4).
        head = (rng.zipf(spec.zipf_a, size=(n_rows, n_cols)) - 1) % pool_size
        body = rng.integers(0, pool_size, size=(n_rows, n_cols))
        use_head = rng.random((n_rows, n_cols)) < spec.head_frac
        idx = np.where(use_head, head, body)
        cells = [[pool[j] for j in row] for row in idx]
        tables.append(Table(table_id=tid, cells=cells))
    return Corpus(tables)


def make_query_with_ground_truth(
    corpus: Corpus,
    n_rows: int = 30,
    key_width: int = 2,
    n_joinable_tables: int = 12,
    seed: int = 1,
    rebuild: bool = True,
) -> tuple[Table, list[int], dict[int, int]]:
    """Build a query table and inject its composite keys into corpus tables.

    Returns (query_table, q_cols, expected ≥joinability per injected table,
    the corpus rebuilt over the changed tables).  Injection REPLACES the
    first ``key_width`` cells of random rows of chosen tables with the
    query's key values (in a random column order, to exercise the mapping
    argmax of Eq. 2).  ``rebuild=False`` returns ``corpus`` itself, its
    arenas stale: a caller planting several queries rebuilds once, after
    the last (the tables chosen depend on their shapes only, so the result
    is the same).
    """
    rng = np.random.default_rng(seed)
    q_cols = list(range(key_width))
    q_cells = [
        [f"qv{r}c{c} " + _random_word(rng) for c in range(key_width + 1)]
        for r in range(n_rows)
    ]
    query = Table(table_id=-1, cells=q_cells)

    eligible = [t for t in corpus.tables if t.n_cols >= key_width and t.n_rows >= 3]
    chosen = rng.choice(len(eligible), size=min(n_joinable_tables, len(eligible)),
                        replace=False)
    expected: dict[int, int] = {}
    for rank, ei in enumerate(chosen):
        table = eligible[int(ei)]
        n_inject = min(2 + rank, table.n_rows, n_rows)
        rows = rng.choice(table.n_rows, size=n_inject, replace=False)
        col_perm = rng.permutation(table.n_cols)[:key_width]
        for i, r in enumerate(rows):
            key = q_cells[i][:key_width]
            for j, c in enumerate(col_perm):
                table.cells[int(r)][int(c)] = key[j]
        expected[table.table_id] = n_inject
    # corpus arenas must be rebuilt after cell surgery
    rebuilt = Corpus(corpus.tables, max_len=corpus.max_len) if rebuild else corpus
    return query, q_cols, expected, rebuilt


def make_mixed_queries(
    corpus: Corpus,
    n_queries: int,
    n_rows: int,
    key_width: int = 2,
    seed: int = 5,
) -> list[tuple[Table, list[int]]]:
    """FP-heavy query workload (the paper's regime): each key column is drawn
    from a DIFFERENT corpus table, so single columns hit many posting lists
    while full composite keys rarely exist — exactly the sensor-data example
    of §1 (location matches many rows, location×timestamp few)."""
    rng = np.random.default_rng(seed)
    tables = [t for t in corpus.tables if t.n_cols >= 1]
    queries = []
    for _ in range(n_queries):
        cols = []
        for _c in range(key_width):
            t = tables[int(rng.integers(len(tables)))]
            col = int(rng.integers(t.n_cols))
            vals = [t.cells[int(rng.integers(t.n_rows))][col] for _ in range(n_rows)]
            cols.append(vals)
        cells = []
        for rowvals in zip(*cols):
            # real-world composite keys don't repeat a value across their own
            # columns; duplicate-value keys create a filter-independent FP
            # floor (multiplicity is invisible to ANY OR-aggregated filter)
            # that would mask the hash-function comparison.
            if len(set(rowvals)) == len(rowvals):
                cells.append(list(rowvals))
        if cells:
            queries.append((Table(table_id=-1, cells=cells), list(range(key_width))))
    return queries


def make_benchmark_queries(
    corpus: Corpus, cardinalities: list[int], per_group: int, seed: int = 7
) -> dict[int, list[tuple[Table, list[int]]]]:
    """Query groups as in §7.1: per cardinality bucket, sample corpus tables
    and use two of their columns as the composite key."""
    rng = np.random.default_rng(seed)
    groups: dict[int, list[tuple[Table, list[int]]]] = {c: [] for c in cardinalities}
    tables = [t for t in corpus.tables if t.n_cols >= 2]
    for card in cardinalities:
        for _ in range(per_group):
            t = tables[int(rng.integers(len(tables)))]
            n = min(t.n_rows, card)
            rows = [t.cells[i] for i in rng.choice(t.n_rows, size=n, replace=False)]
            cols = rng.permutation(t.n_cols)[:2]
            q = Table(table_id=-1, cells=[[r[c] for c in cols] for r in rows])
            groups[card].append((q, [0, 1]))
    return groups
