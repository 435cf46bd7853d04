"""Two-package conformance: every backend of the PORT's registry × every
superkey width against the REFERENCE's 'numpy' results on
``tests/test_conformance.py``'s scenario.

The lake is ``conftest.mixed_query_lake`` with that module's parameters,
re-made by the port's own synthetic generator (asserted cell-identical to
the reference's), and the planted-FD lake of ``tests/test_fd.py`` (seed 3).
The reference runs its 'numpy' backend once per width; each port backend
must reproduce it bit-identically on the four engine surfaces:

  * ``discover_batched`` — the entry sequence (count rank);
  * ``discover_many`` — every request's entry sequence;
  * ``plan_and_count`` — the per-table COUNT VECTORS — then
    ``score_from_counts`` at two k;
  * ``core.fd.discover_fds`` — the verdict tuples;

plus the stats invariant of each dispatch class: fused backends never
materialise a match matrix (``filter_matrix_bytes == 0``), the others do
(on non-empty candidate sets).  The port runs on CPU tensors, where each
kernel wrapper takes its plain version; ``chip_smoke.py``'s
``conformance`` line runs the same matrix on the card.
"""

import dataclasses

import numpy as np
import pytest

from conftest import ALL_BITS, mixed_query_lake
from test_fd import _entry_key, planted_fd_lake
from repro.core import batched as ref_batched
from repro.core import fd as ref_fd
from repro.core import xash as ref_xash
from repro.core.index import build_index as ref_build_index
from repro_torch.core import batched, fd, xash
from repro_torch.core import corpus as port_corpus
from repro_torch.core.index import build_index
from repro_torch.data import synthetic
from repro_torch.kernels import registry

BACKENDS = registry.backend_names()
K = 5
LAKE = dict(n_tables=30, corpus_seed=3, n_queries=2, n_rows=8, key_width=2, query_seed=5)


def _key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


def _port_table(t):
    return port_corpus.Table(t.table_id, [list(r) for r in t.cells], t.name)


@pytest.fixture(scope="module")
def reference():
    """The reference's 'numpy' answers per width, and its lakes."""
    corpus, queries = mixed_query_lake(**LAKE)
    fd_corpus, fd_query, det_cols, dep_col = planted_fd_lake(3)
    ref = {}
    for bits in ALL_BITS:
        idx = ref_build_index(corpus, cfg=ref_xash.XashConfig(bits=bits))[0]
        single, _ = ref_batched.discover_batched(
            idx, queries[0][0], queries[0][1], k=K, backend="numpy"
        )
        many = ref_batched.discover_many(idx, queries, k=K, backend="numpy")
        pcs = ref_batched.plan_and_count(idx, queries, "numpy")
        fd_idx = ref_build_index(fd_corpus, cfg=ref_xash.XashConfig(bits=bits))[0]
        fds, _ = ref_fd.discover_fds(fd_idx, fd_query, det_cols, dep_col, backend="numpy")
        ref[bits] = {
            "single": _key(single),
            "many": [_key(entries) for entries, _ in many],
            "counts": [np.asarray(pc.counts).copy() for pc in pcs],
            "scored": {kk: [_key(ref_batched.score_from_counts(idx, pc, kk)[0]) for pc in pcs]
                       for kk in (K, 3)},
            "fds": _entry_key(fds),
        }
    return corpus, queries, (fd_corpus, fd_query, det_cols, dep_col), ref


@pytest.fixture(scope="module")
def port(reference):
    """The port's lakes — the mixed one from its own generator — and one
    index per width."""
    ref_corpus, ref_queries, (fd_corpus, fd_query, det_cols, dep_col), _ = reference
    corpus = synthetic.make_corpus(
        synthetic.SyntheticSpec(n_tables=LAKE["n_tables"], seed=LAKE["corpus_seed"])
    )
    queries = synthetic.make_mixed_queries(
        corpus, LAKE["n_queries"], LAKE["n_rows"], LAKE["key_width"], seed=LAKE["query_seed"]
    )
    assert [t.cells for t in corpus.tables] == [t.cells for t in ref_corpus.tables]
    assert [(q.cells, c) for q, c in queries] == [(q.cells, c) for q, c in ref_queries]
    fd_port = port_corpus.Corpus([_port_table(t) for t in fd_corpus.tables],
                                 max_len=fd_corpus.max_len)
    built = {
        bits: (build_index(corpus, cfg=xash.XashConfig(bits=bits), device="cpu")[0],
               build_index(fd_port, cfg=xash.XashConfig(bits=bits), device="cpu")[0])
        for bits in ALL_BITS
    }
    return queries, (_port_table(fd_query), det_cols, dep_col), built


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_conforms_to_the_reference(reference, port, backend, bits):
    ref = reference[3][bits]
    queries, (fd_query, det_cols, dep_col), built = port
    idx, fd_idx = built[bits]
    bk = registry.resolve_backend(backend)

    # -- discover: bit-identical entry sequence + matrix invariant --------
    single, st = batched.discover_batched(idx, queries[0][0], queries[0][1], k=K, backend=bk)
    assert _key(single) == ref["single"], "discover drifted"
    assert ref["single"], "an empty answer would conform vacuously"
    if bk.fused:
        assert st.filter_matrix_bytes == 0, "fused dispatch materialised a match matrix"
    else:
        assert st.filter_checks and st.filter_matrix_bytes > 0

    # -- discover_many: every request bit-identical -----------------------
    many = batched.discover_many(idx, queries, k=K, backend=bk)
    assert [_key(entries) for entries, _ in many] == ref["many"]

    # -- two-phase: the COUNT VECTORS must match, then scoring at two k ---
    pcs = batched.plan_and_count(idx, queries, bk)
    assert len(pcs) == len(ref["counts"])
    for pc, ref_counts in zip(pcs, ref["counts"]):
        np.testing.assert_array_equal(np.asarray(pc.counts), ref_counts)
    for kk in (K, 3):
        assert [_key(batched.score_from_counts(idx, pc, kk)[0]) for pc in pcs] == ref["scored"][kk]
    if bk.fused:
        for pc in pcs:
            assert batched.score_from_counts(idx, pc, K)[1].filter_matrix_bytes == 0

    # -- FD workload: verdict tuples bit-identical ------------------------
    fds, fd_st = fd.discover_fds(fd_idx, fd_query, det_cols, dep_col, backend=bk)
    assert [dataclasses.astuple(c) for c in fds] == ref["fds"], "FD verdicts drifted"
    assert ref["fds"]
    if bk.fused:
        assert fd_st.filter_matrix_bytes == 0
