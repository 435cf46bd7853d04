"""MATE-powered dataset enrichment (port of ``repro.data.enrichment``): the
paper's technique as a data-pipeline operator (the use case §1 motivates:
enrich a base table with joinable tables from a lake before downstream ML).

``enrich``: given a base table with a composite key and a corpus index,
discover the top-k joinable tables, pick the best column mapping (Eq. 2
argmax, already computed by discovery), and append the joined columns to the
base records.  ``tokenize_records`` turns enriched rows into LM token
streams for the training pipeline.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.corpus import Table
from repro_torch.core.index import MateIndex
from repro_torch.core.session import MateSession


def enrich(
    source: MateIndex | MateSession,
    base: Table,
    key_cols: list[int],
    k: int = 5,
    max_new_cols: int = 8,
) -> tuple[Table, list[dict]]:
    """Returns (enriched table, provenance records).

    ``source`` is a ``MateSession`` (preferred — discovery runs through its
    resolved backend and counts toward its stats) or a bare ``MateIndex``
    (wrapped in a default-config session on the fly, on the index's own
    device).
    """
    session = source if isinstance(source, MateSession) else MateSession(source)
    topk, _stats = session.discover(base, key_cols, k=k)
    corpus = session.index.corpus
    enriched = [list(row) for row in base.cells]
    provenance = []
    new_cols = 0
    for entry in topk:
        if entry.mapping is None or new_cols >= max_new_cols:
            continue
        t = corpus.tables[entry.table_id]
        mapped = set(entry.mapping)
        extra_cols = [c for c in range(t.n_cols) if c not in mapped]
        if not extra_cols:
            continue
        extra_cols = extra_cols[: max_new_cols - new_cols]
        # build join map: key tuple -> first matching row's extra values
        joinmap: dict[tuple, list[str]] = {}
        for row in t.cells:
            key = tuple(row[c] for c in entry.mapping)
            joinmap.setdefault(key, [row[c] for c in extra_cols])
        hits = 0
        for i, row in enumerate(base.cells):
            key = tuple(row[c] for c in key_cols)
            vals = joinmap.get(key)
            if vals is not None:
                enriched[i].extend(vals)
                hits += 1
            else:
                enriched[i].extend([""] * len(extra_cols))
        provenance.append(
            {
                "table_id": entry.table_id,
                "joinability": entry.joinability,
                "mapping": entry.mapping,
                "new_cols": len(extra_cols),
                "hit_rows": hits,
            }
        )
        new_cols += len(extra_cols)
    return Table(table_id=base.table_id, cells=enriched, name=base.name), provenance


def tokenize_records(table: Table, vocab_size: int, seq_len: int) -> np.ndarray:
    """Hash-tokenise enriched records into fixed-length sequences.

    Python's ``hash`` of a string is salted per process (``PYTHONHASHSEED``),
    as in the reference: tokens agree between the two packages within one
    process, not across processes.
    """
    out = np.zeros((table.n_rows, seq_len), np.int32)
    for i, row in enumerate(table.cells):
        toks: list[int] = []
        for cell in row:
            for word in str(cell).split():
                toks.append(hash(word) % (vocab_size - 2) + 2)
            toks.append(1)  # field separator
        toks = toks[:seq_len]
        out[i, : len(toks)] = toks
    return out
