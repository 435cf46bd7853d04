"""Corpus model: tables, fixed-width encoded cell arena.

Copy of ``repro.core.corpus`` (numpy only): the port keeps its own so that it
imports nothing of the reference package.

A ``Corpus`` stores every table's cells twice:
  * raw strings (host-side, for posting lists and exact verification), and
  * a fixed-width ``uint8`` arena ``enc[total_rows, max_cols, max_len]``
    (device-side, for vectorised hashing / verification).

Tables are concatenated row-wise; ``row_base[t]`` is the first global row id
of table ``t`` (``row_base[n_tables] == total_rows``).  Missing cells (table
narrower than ``max_cols``) encode as all-PAD and contribute nothing to the
row's super key.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import encoding


@dataclasses.dataclass
class Table:
    table_id: int
    cells: list[list[str]]  # [n_rows][n_cols]
    name: str = ""

    @property
    def n_rows(self) -> int:
        return len(self.cells)

    @property
    def n_cols(self) -> int:
        return len(self.cells[0]) if self.cells else 0

    def column(self, c: int) -> list[str]:
        return [row[c] for row in self.cells]


class Corpus:
    def __init__(self, tables: list[Table], max_len: int = encoding.MAX_LEN):
        self.tables = tables
        self.max_len = max_len
        self.max_cols = max((t.n_cols for t in tables), default=1)
        self.row_base = np.zeros(len(tables) + 1, dtype=np.int64)
        for i, t in enumerate(tables):
            self.row_base[i + 1] = self.row_base[i] + t.n_rows
        self.total_rows = int(self.row_base[-1])
        self.n_cols = np.array([t.n_cols for t in tables], dtype=np.int32)

        # Encode per UNIQUE value once; the arena holds value ids, the encoded
        # unique-value matrix is shared (big memory + hash-time win).
        self.value_of: dict[str, int] = {}
        uniques: list[str] = []
        self.cell_value_ids = np.full(
            (self.total_rows, self.max_cols), -1, dtype=np.int32
        )
        for t in tables:
            base = int(self.row_base[t.table_id])
            for r, row in enumerate(t.cells):
                for c, v in enumerate(row):
                    vid = self.value_of.get(v)
                    if vid is None:
                        vid = len(uniques)
                        self.value_of[v] = vid
                        uniques.append(v)
                    self.cell_value_ids[base + r, c] = vid
        self.unique_values = uniques
        self.unique_enc = encoding.encode_values(uniques, max_len)

    # -- lookups ------------------------------------------------------------

    def table_of_row(self, global_row: np.ndarray | int) -> np.ndarray | int:
        idx = np.searchsorted(self.row_base, global_row, side="right") - 1
        return idx

    def row_values(self, global_row: int) -> list[str]:
        t = int(self.table_of_row(global_row))
        r = global_row - int(self.row_base[t])
        return self.tables[t].cells[r]

    def avg_row_width(self) -> float:
        total_cells = sum(t.n_rows * t.n_cols for t in self.tables)
        return total_cells / max(self.total_rows, 1)

    def char_frequencies(self) -> np.ndarray:
        """Corpus-level character frequencies over unique values (§5.2.1)."""
        counts = np.zeros(encoding.ALPHABET_SIZE + 1, dtype=np.int64)
        np.add.at(counts, self.unique_enc.reshape(-1), 1)
        freq = counts[1:].astype(np.float64)
        total = freq.sum()
        return freq / total if total > 0 else freq + 1.0
