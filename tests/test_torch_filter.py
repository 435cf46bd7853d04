"""Filter parity: the port's B.1 / B.2 / B.4 wrappers and ``kernels.ops``
against the reference's ``numpy`` backend and ``ops.subsume_np``.

On CPU tensors every wrapper runs its kernel's plain PyTorch version, so
this holds the semantics the CUDA kernels are held to on the card
(``chip_smoke.py``).  Counts are integers: bit-identical, no tolerance.
The reference's interpret-mode Pallas paths are not the oracle here (too
slow for the suite); its ``numpy`` backend is, as in its conformance suite.
"""

import numpy as np
import pytest
import torch

from conftest import ALL_BITS
from repro.core import batched as ref_batched
from repro.core import session as ref_session
from repro.data import synthetic as ref_synthetic
from repro.kernels import ops as ref_ops
from repro.kernels import registry as ref_registry
from repro_torch.core import batched, corpus as port_corpus, session, xash
from repro_torch.kernels import filter_kernel as fk
from repro_torch.kernels import ops, registry

PORT_BACKENDS = ("fused-gather", "fused", "pallas", "xla", "numpy", "auto")
LANES = {bits: bits // 32 for bits in ALL_BITS}


def test_registry_names_and_precedence_match_reference(monkeypatch):
    assert registry.backend_names() == ref_registry.backend_names()
    assert registry.ENV_VAR == ref_registry.ENV_VAR
    assert sorted(registry.backend_names()) == sorted(PORT_BACKENDS)
    assert registry.platform_default("cuda") == "fused-gather"
    assert registry.platform_default("cpu") == "auto"
    monkeypatch.setenv(registry.ENV_VAR, "pallas")
    assert registry.resolve_backend(None, "cuda") == registry.Backend("pallas", "env")
    assert registry.resolve_backend("fused", "cuda") == registry.Backend("fused", "config")
    monkeypatch.setenv(registry.ENV_VAR, "typo")
    assert registry.resolve_backend(None, "cpu") == registry.Backend("auto", "platform")
    with pytest.raises(ValueError, match="unknown filter backend"):
        registry.resolve_backend("nope")


def _rand_case(lanes, n, q, n_tables, n_store=2048, seed=0):
    """Random store, CSR rows, planted subsuming query keys, elig, sorted seg."""
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 2**32, size=(n_store, lanes), dtype=np.uint32)
    rows = rng.integers(0, n_store, size=n).astype(np.int64)
    q_sk = rng.integers(0, 2**32, size=(q, lanes), dtype=np.uint32)
    for k in range(0, q, 3):
        q_sk[k] = store[rows[k % max(n, 1)]] & rng.integers(0, 2**32, size=lanes, dtype=np.uint32)
    elig = rng.random((n, q)) < 0.7
    seg = np.sort(rng.integers(0, max(n_tables, 1), size=n)).astype(np.int32)
    return store, rows, q_sk, elig, seg


def _t(lanes_np):
    return xash.lanes_to_torch(lanes_np, "cpu")


def _ref_counts(row_sk, q_sk, elig, seg, n_tables):
    _hits, counts = ref_ops.filter_hits_table_counts(
        row_sk, q_sk, elig, seg, n_tables, backend="numpy"
    )
    return counts


SHAPES = [
    (700, 23, 19),  # non-pow2 everything
    (1030, 70, 13),  # crosses the reference's 1024-row block
    (257, 5, 1),  # single-table CSR block
    (64, 3, 5),  # tiny block
    (300, 300, 7),  # more queries than one 256-query tile
]


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("n,q,n_tables", SHAPES)
def test_table_counts_sum_and_keys(bits, n, q, n_tables):
    store, rows, q_sk, elig, seg = _rand_case(LANES[bits], n, q, n_tables, seed=bits + n)
    row_sk = store[rows]
    counts, keys = fk.filter_table_counts(
        _t(row_sk), _t(q_sk), torch.from_numpy(elig), torch.from_numpy(seg), n_tables=n_tables
    )
    assert np.array_equal(counts.numpy(), _ref_counts(row_sk, q_sk, elig, seg, n_tables))
    hits = ref_ops.subsume_np(row_sk, q_sk) & elig
    assert np.array_equal(keys.numpy(), hits.sum(axis=0).astype(np.int32))
    gathered = fk.gather_filter_table_counts(
        torch.from_numpy(rows.astype(np.int32)), _t(store), _t(q_sk),
        torch.from_numpy(elig), torch.from_numpy(seg), n_tables=n_tables,
    )
    assert np.array_equal(gathered.numpy(), counts.numpy())


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("n,q,n_tables", SHAPES)
@pytest.mark.parametrize("elig_kind", ["block-diagonal", None])
def test_gather_counts_block_diagonal_and_without_elig(bits, n, q, n_tables, elig_kind):
    """B.2's plain version with the eligibility of a ``discover_many`` group
    (8 diagonal blocks: each query's rows see only its keys) and with none."""
    store, rows, q_sk, elig, seg = _rand_case(LANES[bits], n, q, n_tables, seed=bits + n + 1)
    if elig_kind is None:
        elig = None
    else:
        elig &= (np.arange(n)[:, None] * 8 // n) == (np.arange(q)[None, :] * 8 // q)
    got = fk.gather_filter_table_counts(
        torch.from_numpy(rows.astype(np.int32)), _t(store), _t(q_sk),
        None if elig is None else torch.from_numpy(elig), torch.from_numpy(seg), n_tables=n_tables,
    )
    want = _ref_counts(store[rows], q_sk, np.ones((n, q), bool) if elig is None else elig, seg, n_tables)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", ALL_BITS)
def test_table_counts_any_mode(bits):
    store, rows, q_sk, elig, seg = _rand_case(LANES[bits], 900, 300, 11, seed=bits)
    row_sk = store[rows]
    counts, _ = fk.filter_table_counts(
        _t(row_sk), _t(q_sk), torch.from_numpy(elig), torch.from_numpy(seg),
        n_tables=11, mode="any",
    )
    any_hit = (ref_ops.subsume_np(row_sk, q_sk) & elig).any(axis=1)
    want = np.bincount(seg, weights=any_hit, minlength=11).astype(np.int32)
    assert np.array_equal(counts.numpy(), want)


def test_lane_prefix_degrade_over_512_bit_store():
    store, rows, q_sk16, elig, seg = _rand_case(16, 900, 31, 11, seed=3)
    for probe in (4, 8, 16):
        q_sk = np.ascontiguousarray(q_sk16[:, :probe])
        got = ops.gather_filter_table_counts(_t(store), rows, q_sk, elig, seg, 11)
        want = _ref_counts(store[rows][:, :probe], q_sk, elig, seg, 11)
        assert np.array_equal(got, want), probe


@pytest.mark.parametrize("bits", ALL_BITS)
def test_filter_match_equals_subsume_np(bits):
    store, rows, q_sk, _elig, _seg = _rand_case(LANES[bits], 513, 67, 3, seed=bits)
    got = fk.filter_match(_t(store[rows]), _t(q_sk))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy().astype(bool), ref_ops.subsume_np(store[rows], q_sk))
    assert np.array_equal(
        ops.filter_match_auto(store[rows], q_sk, "pallas", device="cpu"),
        ref_ops.subsume_np(store[rows], q_sk),
    )


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("bits", ALL_BITS)
def test_hits_table_counts_every_backend(bits, backend):
    store, rows, q_sk, elig, seg = _rand_case(LANES[bits], 640, 40, 9, seed=bits + 1)
    want_hits, want = ref_ops.filter_hits_table_counts(
        store[rows], q_sk, elig, seg, 9, backend="numpy"
    )
    gather = backend == "fused-gather"
    hits, counts = ops.filter_hits_table_counts(
        None if gather else store[rows], q_sk, elig, seg, 9, backend=backend,
        store=_t(store) if gather else None, rows=rows if gather else None,
        device="cpu",
    )
    assert np.array_equal(counts, want)
    if backend in ("fused", "fused-gather"):
        assert hits is None  # counts only: the match matrix never existed
    else:
        got = hits.numpy() if isinstance(hits, torch.Tensor) else hits
        assert np.array_equal(got, want_hits)


def test_phantom_query_columns_and_padding_rows_count_nothing():
    """All-ones row super keys subsume any query, including all-ones phantom
    columns past ``n_queries``; those and seg -1 rows must count nothing."""
    lanes, n, q = 4, 50, 8
    rows = torch.full((n, lanes), -1, dtype=torch.int32)  # all bits set
    query = torch.full((q, lanes), -1, dtype=torch.int32)
    seg = torch.zeros(n, dtype=torch.int32)
    seg[::5] = -1
    counts, keys = fk.filter_table_counts(rows, query, None, seg, n_tables=2, n_queries=3)
    assert counts.tolist() == [40 * 3, 0]
    assert keys.tolist() == [40] * 3 + [0] * 5
    store = torch.full((10, lanes), -1, dtype=torch.int32)
    idx = torch.arange(n, dtype=torch.int32) % 10
    got = fk.gather_filter_table_counts(idx, store, query, None, seg, n_tables=2, n_queries=3)
    assert got.tolist() == [40 * 3, 0]


def test_zero_shapes_return_zeros():
    store = _t(np.ones((16, 4), dtype=np.uint32))
    zq = np.zeros((0, 4), dtype=np.uint32)
    assert ops.gather_filter_table_counts(
        store, np.zeros(0, np.int64), zq, None, np.zeros(0, np.int32), 5
    ).tolist() == [0] * 5
    assert ops.gather_filter_table_counts(
        store, np.arange(10), zq, None, np.zeros(10, np.int32), 5
    ).tolist() == [0] * 5
    assert ops.filter_table_counts(
        np.zeros((0, 4), np.uint32), np.ones((3, 4), np.uint32), None,
        np.zeros(0, np.int32), 4, device="cpu",
    ).tolist() == [0] * 4
    assert ops.filter_table_counts(
        np.ones((3, 4), np.uint32), np.ones((2, 4), np.uint32), None,
        np.zeros(3, np.int32), 0, device="cpu",
    ).shape == (0,)
    hits, counts = ops.filter_hits_table_counts(
        np.ones((3, 4), np.uint32), zq, np.zeros((3, 0), bool), np.zeros(3, np.int32), 2,
        backend="fused", device="cpu",
    )
    assert hits.shape == (3, 0) and counts.tolist() == [0, 0]


def test_table_cap_raises_and_demotes():
    big = ops._FUSED_MAX_TABLES + 1
    store, rows, q_sk, elig, seg = _rand_case(4, 300, 6, big, seed=9)
    with pytest.raises(ValueError, match="at most"):
        ops.gather_filter_table_counts(_t(store), rows, q_sk, elig, seg, big)
    with pytest.raises(ValueError, match="at most"):
        fk.filter_table_counts(
            _t(store[rows]), _t(q_sk), None, torch.from_numpy(seg), n_tables=big
        )
    want_hits, want = ref_ops.filter_hits_table_counts(
        store[rows], q_sk, elig, seg, big, backend="numpy"
    )
    # fused-gather → fused → pallas: above the cap the matrix comes back
    for backend in ("fused-gather", "fused"):
        hits, counts = ops.filter_hits_table_counts(
            None, q_sk, elig, seg, big, backend=backend, store=_t(store), rows=rows,
        )
        assert hits is not None and np.array_equal(hits.numpy(), want_hits)
        assert np.array_equal(counts, want)


def test_gather_rejects_offsets_outside_store():
    store, rows, q_sk, elig, seg = _rand_case(4, 64, 3, 2, n_store=64, seed=2)
    for bad in (64, -1):
        rows_bad = rows.copy()
        rows_bad[5] = bad
        with pytest.raises(ValueError, match="outside the store"):
            ops.gather_filter_table_counts(_t(store), rows_bad, q_sk, elig, seg, 2)


def test_fused_block_n_validated():
    store, rows, q_sk, elig, seg = _rand_case(4, 64, 3, 2, seed=1)
    with pytest.raises(ValueError, match="power of two"):
        ops.filter_table_counts(store[rows], q_sk, elig, seg, 2, block_n=100, device="cpu")
    assert np.array_equal(
        ops.filter_table_counts(store[rows], q_sk, elig, seg, 2, block_n=256, device="cpu"),
        _ref_counts(store[rows], q_sk, elig, seg, 2),
    )


# ---------------------------------------------------------------------------
# Engine-level CSR edge cases (the shapes of test_gather_fused/test_fused_filter)
# ---------------------------------------------------------------------------


def _port_corpus(c):
    return port_corpus.Corpus(
        [port_corpus.Table(t.table_id, [list(r) for r in t.cells], t.name) for t in c.tables],
        max_len=c.max_len,
    )


def _key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


@pytest.fixture(scope="module")
def lake():
    corpus = ref_synthetic.make_corpus(ref_synthetic.SyntheticSpec(n_tables=80, seed=0))
    query, q_cols, _exp, corpus = ref_synthetic.make_query_with_ground_truth(corpus)
    return corpus, query, q_cols


def _pair(corpus, backend="numpy"):
    ref = ref_session.MateSession.build(corpus, ref_session.DiscoveryConfig(backend="numpy"))
    port = session.MateSession.build(
        _port_corpus(corpus), session.DiscoveryConfig(backend=backend), device="cpu"
    )
    return ref, port


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_csr_edge_cases_match_reference(lake, backend):
    corpus, _query, _q_cols = lake
    ref, port = _pair(corpus, backend)
    # empty posting lists: init values that miss the index entirely
    ghost = port_corpus.Table(-1, [["zzznope", "zzznope2"]] * 3)
    assert port.discover(ghost, [0, 1])[0] == []
    # zero requests
    assert batched.plan_and_count(port.index, [], backend) == []
    # a one-table corpus: a single-table CSR block
    cells = [[f"k{r}", f"v{r % 3}", "common"] for r in range(9)]
    one_ref = ref_session.MateSession.build(
        ref_synthetic.Corpus([ref_synthetic.Table(0, cells)]),
        ref_session.DiscoveryConfig(backend="numpy"),
    )
    one = session.MateSession.build(
        port_corpus.Corpus([port_corpus.Table(0, [list(r) for r in cells])]),
        session.DiscoveryConfig(backend=backend), device="cpu",
    )
    q_cells = [[f"k{r}", f"v{r % 3}"] for r in range(5)]
    want, _ = one_ref.discover(ref_synthetic.Table(-1, q_cells), [0, 1])
    got, _ = one.discover(port_corpus.Table(-1, q_cells), [0, 1])
    assert _key(got) == _key(want)


def test_all_tables_deleted(lake):
    corpus, query, q_cols = lake
    ref, port = _pair(corpus, "fused-gather")
    pq = port_corpus.Table(-1, [list(r) for r in query.cells])
    assert port.discover(pq, q_cols)[0]
    for t in range(len(corpus.tables)):
        port.delete_table(t)
        ref.delete_table(t)
    got, st = port.discover(pq, q_cols)
    assert got == [] and ref.discover(query, q_cols)[0] == []
    assert st.gather_bytes_saved == 0


@pytest.mark.parametrize("bits", ALL_BITS)
def test_table_cap_demotes_engines(lake, monkeypatch, bits):
    """A per-launch cap below the batch's table count takes fused-gather off
    the gather path (→ fused → pallas) with identical results and the
    reference's accounting under the same demotion."""
    corpus, query, q_cols = lake
    ref_index = ref_session.MateSession.build(
        corpus, ref_session.DiscoveryConfig(bits=bits, backend="numpy")
    ).index
    port = session.MateSession.build(
        _port_corpus(corpus), session.DiscoveryConfig(bits=bits), device="cpu"
    )
    pq = port_corpus.Table(-1, [list(r) for r in query.cells])
    monkeypatch.setattr(ops, "_FUSED_MAX_TABLES", 4)
    got, st = batched.discover_batched(port.index, pq, q_cols, k=10, backend="fused-gather")
    want, _ = ref_batched.discover_batched(ref_index, query, q_cols, k=10, backend="numpy")
    assert _key(got) == _key(want)
    assert st.gather_bytes_saved == 0 and st.filter_fused_launches == 0
    assert st.filter_matrix_bytes > 0
    many = batched.discover_many(port.index, [(pq, q_cols)] * 2, k=10, backend="fused-gather")
    assert [_key(e) for e, _ in many] == [_key(want)] * 2


# ---------------------------------------------------------------------------
# B.1 on the edge inputs chip_smoke.py holds its CUDA kernel to, through the
# plain version, against the reference numpy backend: the main path's key
# counts (30, a block-diagonal 240, 300 over two query tiles), 'any' over two
# tiles, phantom columns past n_queries, padding rows (seg = -1), the
# 8192-table cap, no eligibility.  Table counts and key counts.
# ---------------------------------------------------------------------------

B1_EDGES = {  # name: (q, n_queries, mode, elig kind, pad rows, n_tables)
    "q30": (30, 30, "sum", "random", False, 13),
    "q240-block-diagonal": (240, 240, "sum", "block-diagonal", False, 13),
    "q300-two-tiles": (300, 300, "sum", "random", False, 13),
    "q300-any": (300, 300, "any", "random", False, 13),
    "phantom-columns": (256, 200, "sum", "random", False, 13),
    "padding-rows": (256, 256, "sum", "random", True, 13),
    "any-phantom-padding": (300, 290, "any", "random", True, 13),
    "table-cap": (64, 64, "sum", "random", False, fk.FUSED_MAX_TABLES),
    "no-elig": (64, 64, "sum", None, False, 13),
}


@pytest.mark.parametrize("edge", list(B1_EDGES))
@pytest.mark.parametrize("bits", ALL_BITS)
def test_table_counts_edge_inputs_match_reference(bits, edge):
    q, nq, mode, kind, pad, n_tables = B1_EDGES[edge]
    n = 700
    store, rows, q_sk, elig, seg = _rand_case(LANES[bits], n, q, n_tables, seed=bits + q + nq)
    if kind == "block-diagonal":
        elig &= (np.arange(n)[:, None] * 8 // n) == (np.arange(q)[None, :] * 8 // q)
    if pad:
        seg[::8] = -1
    row_sk = store[rows]
    counts, keys = fk.filter_table_counts(
        _t(row_sk), _t(q_sk), None if kind is None else torch.from_numpy(elig),
        torch.from_numpy(seg), n_tables=n_tables, n_queries=nq, mode=mode,
    )
    live = seg >= 0
    el = np.ones((n, q), bool) if kind is None else elig
    hits = ref_ops.subsume_np(row_sk, q_sk) & el
    hits[:, nq:] = False
    hits &= live[:, None]
    assert np.array_equal(keys.numpy(), hits.sum(axis=0).astype(np.int32))
    if mode == "sum":  # the reference's fused-count oracle, on the real queries and rows
        want = _ref_counts(row_sk[live], q_sk[:nq], el[live][:, :nq], seg[live], n_tables)
    else:
        want = np.bincount(seg[live], weights=hits[live].any(axis=1), minlength=n_tables).astype(np.int32)
    assert np.array_equal(counts.numpy(), want)
