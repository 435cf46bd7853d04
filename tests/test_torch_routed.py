"""The routed lake: ``repro_torch.core.routing`` against ``repro.core.routing``.

A ``ShardedMateIndex`` at any shard count in {1, 2, 4, 8} and width in
{128, 256, 512} must answer top-k identical to the single-host index and to
the reference's routed index, while the only bytes that cross a shard
boundary are int32 per-table count vectors: ``shard_launches`` and
``route_bytes_merged`` equal the reference's.  Every port backend name runs
(on CPU tensors each kernel wrapper takes its plain version) and is held to
the reference's 'numpy' backend (ROADMAP C.2); integer outputs, top-k and
counters must be equal, errors word for word.  The host-routed cases of
``tests/test_routed.py`` run on both packages here; the mesh mode is held in
``test_torch_routed_mesh.py``.
"""

import asyncio

import numpy as np
import pytest
import torch

from conftest import ALL_BITS
from repro.core import batched as ref_batched
from repro.core import index as ref_index
from repro.core import routing as ref_routing
from repro.core import session as ref_session
from repro.core import xash as ref_xash
from repro.data import synthetic as ref_synthetic
from repro.kernels import ops as ref_ops
from repro.launch import mesh as ref_meshlib
from repro.serve import engine as ref_engine
from repro_torch.core import batched, discovery, index, routing, session, xash
from repro_torch.core import corpus as port_corpus
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.serve import engine

SHARD_COUNTS = (1, 2, 4, 8)
PORT_BACKENDS = ("fused-gather", "fused", "pallas", "xla", "numpy", "auto")
ROUTE_FIELDS = ("shard_launches", "route_bytes_merged", "shard_gather_demotions",
                "pl_items_checked", "filter_checks", "filter_passed", "verified_tp",
                "verified_fp", "tables_evaluated", "tables_pruned_rule1", "tables_pruned_rule2")


def _pt(t):
    return port_corpus.Table(t.table_id, [list(r) for r in t.cells], t.name)


def _port_corpus(c):
    return port_corpus.Corpus([_pt(t) for t in c.tables], max_len=c.max_len)


def _key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


def _fresh_lake():
    corpus = ref_synthetic.make_corpus(ref_synthetic.SyntheticSpec(n_tables=60, seed=1))
    query, q_cols, _expected, corpus = ref_synthetic.make_query_with_ground_truth(corpus)
    return corpus, query, q_cols


@pytest.fixture(scope="module")
def lake():
    corpus, query, q_cols = _fresh_lake()
    return corpus, _port_corpus(corpus), query, q_cols


@pytest.fixture(scope="module")
def single_host(lake):
    corpus = lake[0]
    return {
        bits: ref_index.MateIndex(corpus, cfg=ref_xash.XashConfig(bits=bits), use_corpus_char_freq=True)
        for bits in ALL_BITS
    }


def make_routed(pc, bits, n_shards):
    return routing.ShardedMateIndex(
        pc, cfg=xash.XashConfig(bits=bits), use_corpus_char_freq=True, n_shards=n_shards,
        device="cpu",
    )


def make_ref_routed(corpus, bits, n_shards):
    return ref_routing.ShardedMateIndex(
        corpus, cfg=ref_xash.XashConfig(bits=bits), use_corpus_char_freq=True, n_shards=n_shards
    )


# ---------------------------------------------------------------------------
# Shard ownership geometry
# ---------------------------------------------------------------------------


def test_table_aligned_bounds_cover_and_align(lake):
    corpus = lake[0]
    for n in (1, 2, 3, 4, 8, 17):
        bounds = routing.table_aligned_bounds(corpus.row_base, n)
        assert np.array_equal(bounds, ref_routing.table_aligned_bounds(corpus.row_base, n))
        assert bounds[0] == 0 and bounds[-1] == corpus.total_rows
        assert np.all(np.diff(bounds) >= 0)
        assert np.all(np.isin(bounds[1:-1], corpus.row_base)), (n, bounds)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_shards_match_reference_and_no_table_crosses_a_shard(lake, n_shards):
    corpus, pc, _q, _qc = lake
    idx, ref = make_routed(pc, 128, n_shards), make_ref_routed(corpus, 128, n_shards)
    assert np.array_equal(idx.shard_row_bounds, ref.shard_row_bounds)
    assert np.array_equal(idx.value_lanes, ref.value_lanes)
    owner = np.full(len(corpus.tables), -1)
    for s, r in zip(idx.shards, ref.shards):
        assert (s.row_lo, s.row_hi, s.table_lo, s.table_hi) == (r.row_lo, r.row_hi, r.table_lo, r.table_hi)
        assert np.array_equal(s.superkeys, r.superkeys)
        assert set(s.postings) == set(r.postings)
        assert all(np.array_equal(s.postings[v], r.postings[v]) for v in r.postings)
        tids = np.unique(np.asarray(corpus.table_of_row(np.arange(s.row_lo, s.row_hi))))
        assert (owner[tids] == -1).all()
        owner[tids] = s.shard_id
    for t in range(len(corpus.tables)):
        if corpus.tables[t].n_rows:
            assert idx.shard_of_table(t).shard_id == owner[t]


# ---------------------------------------------------------------------------
# Routed-vs-single-host equivalence matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_routed_matrix_byte_identical(lake, single_host, n_shards, bits):
    corpus, pc, query, q_cols = lake
    pq = _pt(query)
    idx, ref = make_routed(pc, bits, n_shards), make_ref_routed(corpus, bits, n_shards)
    want, _ = ref_batched.discover_batched(single_host[bits], query, q_cols, k=10, backend="numpy")
    ref_got, ref_stats = ref_batched.discover_batched(ref, query, q_cols, k=10, backend="numpy")
    assert _key(ref_got) == _key(want)
    for backend in PORT_BACKENDS:
        got, stats = batched.discover_batched(idx, pq, q_cols, k=10, backend=backend)
        assert _key(got) == _key(want), backend
        for name in ROUTE_FIELDS:
            assert getattr(stats, name) == getattr(ref_stats, name), (backend, name)
    assert stats.shard_launches >= 1 and stats.route_bytes_merged > 0
    if n_shards > 1:
        assert stats.route_bytes_merged < stats.pl_items_checked * idx.cfg.lanes * 4
    seq, _ = discovery.discover(idx, pq, q_cols, k=10)
    assert _key(seq) == _key(want)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_routed_artifact_parity(lake, single_host, n_shards):
    """fetch_postings / gather_candidates / superkey_of_rows reproduce the
    single-host artifacts exactly (shard concat == global order)."""
    corpus, pc, _q, _qc = lake
    idx = make_routed(pc, 128, n_shards)
    ref = single_host[128]
    values = [corpus.unique_values[i] for i in sorted(ref.postings)][:32]
    for v in values:
        assert np.array_equal(idx.fetch_postings(v), ref.fetch_postings(v)), v
    blk, blk_ref = idx.gather_candidates(values), ref.gather_candidates(values)
    for name in ("table_ptr", "table_ids", "rows", "value_idx"):
        assert np.array_equal(getattr(blk, name), getattr(blk_ref, name)), name
    rows = np.arange(0, corpus.total_rows, 3, dtype=np.int64)
    np.random.default_rng(7).shuffle(rows)  # out of order + cross-shard interleaved
    assert np.array_equal(idx.superkey_of_rows(rows), ref.superkey_of_rows(rows))
    assert idx.superkey_of_rows(np.zeros(0, dtype=np.int64)).shape == (0, idx.cfg.lanes)
    assert idx.fetch_postings("no such value").shape == (0, 2)


@pytest.mark.parametrize("bits", ALL_BITS)
def test_routed_session_discover_many_identical(lake, single_host, bits):
    """Group batching through a routed session matches the single-host
    session and the reference's routed session, per-request route
    attribution included."""
    corpus, pc, query, q_cols = lake
    routed = session.MateSession.build(
        pc, session.DiscoveryConfig(bits=bits, backend="fused-gather"), distributed=True,
        n_shards=4, device="cpu",
    )
    assert routed.index.routed and routed.build_stats.sharded
    ref_routed = ref_session.MateSession.build(
        corpus, ref_session.DiscoveryConfig(bits=bits, backend="numpy"), distributed=True, n_shards=4
    )
    ref = ref_session.MateSession(single_host[bits], ref_session.DiscoveryConfig(bits=bits))
    queries = [(query, q_cols)] + ref_synthetic.make_mixed_queries(corpus, 2, 10, 2, seed=11)
    port_queries = [(_pt(q), qc) for q, qc in queries]
    out = routed.discover_many(port_queries, k=[10, 4, 4])
    out_ref = ref.discover_many(queries, k=[10, 4, 4])
    out_rr = ref_routed.discover_many(queries, k=[10, 4, 4])
    assert [_key(e) for e, _ in out] == [_key(e) for e, _ in out_ref] == [_key(e) for e, _ in out_rr]
    for name in ("shard_launches", "route_bytes_merged", "requests", "verified_tp", "verified_fp",
                 "tables_gated", "filter_passed"):
        assert getattr(routed.stats, name) == getattr(ref_routed.stats, name), name
    assert routed.stats.shard_launches > 0 and routed.stats.route_bytes_merged > 0
    for pc_, rpc in zip(routed.plan_and_count(port_queries), ref_routed.plan_and_count(queries)):
        assert (pc_.route_launches, pc_.route_bytes) == (rpc.route_launches, rpc.route_bytes)
        assert np.array_equal(pc_.counts, rpc.counts)
        if pc_.plan.block.n_items:
            assert pc_.route_launches >= 1
            assert pc_.route_bytes == pc_.route_launches * pc_.counts.shape[0] * 4


def test_routed_bound_cache_replay_no_new_launches(lake):
    """score_from_counts(from_cache=True) must not re-count routed launches
    — the filter was paid for by the original request."""
    _c, pc, query, q_cols = lake
    routed = session.MateSession.build(
        pc, session.DiscoveryConfig(bits=128), distributed=True, n_shards=2, device="cpu"
    )
    (plan,) = routed.plan_and_count([(_pt(query), q_cols)])
    routed.score_from_counts(plan, k=10)
    launches, merged = routed.stats.shard_launches, routed.stats.route_bytes_merged
    assert launches > 0
    routed.score_from_counts(plan, k=5, from_cache=True)
    assert (routed.stats.shard_launches, routed.stats.route_bytes_merged) == (launches, merged)


@pytest.mark.parametrize("backend", ("fused-gather", "fused", "pallas", "numpy"))
def test_over_cap_shards_count_like_the_reference(lake, single_host, monkeypatch, backend):
    """Past the fused kernels' table cap a shard's counts come from the
    match kernel B.4 and an ``index_add_`` (ROADMAP C.11; the reference
    runs host numpy): counts, top-k and the demotion accounting equal the
    reference's at the same (lowered) cap."""
    corpus, pc, query, q_cols = lake
    monkeypatch.setattr(ops, "_FUSED_MAX_TABLES", 3)
    monkeypatch.setattr(ref_ops, "_FUSED_MAX_TABLES", 3)
    idx, ref = make_routed(pc, 256, 4), make_ref_routed(corpus, 256, 4)
    ref_backend = backend if backend != "pallas" else "numpy"  # the reference's Pallas is interpret mode
    want, ref_stats = ref_batched.discover_batched(ref, query, q_cols, k=10, backend=ref_backend)
    got, stats = batched.discover_batched(idx, _pt(query), q_cols, k=10, backend=backend)
    assert _key(got) == _key(want)
    for name in ROUTE_FIELDS + ("filter_fused_launches",):
        assert getattr(stats, name) == getattr(ref_stats, name), name
    if backend == "fused-gather":
        assert stats.shard_gather_demotions == stats.shard_launches > 0
    queries = [(query, q_cols)] + ref_synthetic.make_mixed_queries(corpus, 2, 10, 2, seed=11)
    got_pcs = batched.plan_and_count(idx, [(_pt(q), c) for q, c in queries], backend)
    want_pcs = ref_batched.plan_and_count(ref, queries, ref_backend)
    for g, w in zip(got_pcs, want_pcs):
        assert np.array_equal(g.counts, w.counts)


def test_empty_batch_counts_nothing(lake):
    """An empty batch returns zeros without a launch, as the reference's."""
    _c, pc, _q, _qc = lake
    idx = make_routed(pc, 128, 2)
    counts = idx.routed_counts(np.zeros(0, dtype=np.int64), np.zeros((2, 4), np.uint32),
                               np.zeros((0, 2), bool), np.zeros(0, np.int32), 5, backend="fused")
    assert counts.tolist() == [0] * 5


# ---------------------------------------------------------------------------
# Devices and errors
# ---------------------------------------------------------------------------


def test_shard_devices_default_to_the_cards(monkeypatch):
    assert routing.shard_devices(device="cpu") == [torch.device("cpu")]
    assert routing.shard_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        routing.shard_devices()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert routing.shard_devices() == [torch.device("cuda", i) for i in range(3)]
    assert routing.shard_devices(device="cuda:1") == [torch.device("cuda", 1)]


def test_routed_index_exposes_its_device(lake):
    _c, pc, _q, _qc = lake
    idx = make_routed(pc, 128, 3)
    assert idx.device == torch.device("cpu")
    assert all(s.device == torch.device("cpu") for s in idx.shards)
    assert session.MateSession(idx).backend.name == "auto"  # resolved on the CPU
    assert repr(idx) == "ShardedMateIndex(shards=3, rows=%d, bits=128, mesh=none)" % idx.corpus.total_rows


def test_attach_mesh_shard_mismatch_raises_like_the_reference(lake):
    corpus, pc, _q, _qc = lake
    with pytest.raises(ValueError, match="shards") as want:
        make_ref_routed(corpus, 128, 2).attach_mesh(ref_meshlib.make_mesh((1,), ("data",)), ("data",))
    with pytest.raises(ValueError) as got:
        make_routed(pc, 128, 2).attach_mesh(Mesh(rank=0, size=1, backend="gloo", device=None))
    assert str(got.value) == str(want.value)


def test_mesh_n_shards_conflict_raises_like_the_reference(lake):
    corpus, pc, _q, _qc = lake
    with pytest.raises(ValueError, match="n_shards") as want:
        ref_routing.build_routed_index(corpus, mesh=ref_meshlib.make_mesh((1,), ("data",)), n_shards=3)
    with pytest.raises(ValueError) as got:
        routing.build_routed_index(pc, mesh=Mesh(rank=0, size=1, backend="gloo", device=None),
                                   n_shards=3, device="cpu")
    assert str(got.value) == str(want.value)


def test_build_routed_index_stats_match_reference(lake):
    corpus, pc, _q, _qc = lake
    for n in SHARD_COUNTS:
        idx, stats = routing.build_routed_index(pc, cfg=xash.XashConfig(bits=256), n_shards=n, device="cpu")
        ref, ref_stats = ref_routing.build_routed_index(corpus, cfg=ref_xash.XashConfig(bits=256), n_shards=n)
        for name in ("n_shards", "mesh_shape", "values_total", "rows_total", "bytes_hashed",
                     "shard_values", "shard_rows", "profile_bytes", "sharded", "merge_seconds"):
            assert getattr(stats, name) == getattr(ref_stats, name), name
        assert np.array_equal(idx.value_lanes, ref.value_lanes)


# ---------------------------------------------------------------------------
# §5.4 mutations stay shard-local
# ---------------------------------------------------------------------------


def test_mutations_shard_local_epochs_and_stores():
    """insert/update/delete on a routed index bump ONLY the owning shard's
    epoch and refresh ONLY that shard's device store; top-k stays identical
    to a from-scratch single-host rebuild and to the reference's routed
    index under the same mutations."""
    corpus, query, q_cols = _fresh_lake()
    ref_corpus_, _rq, _rc = _fresh_lake()
    idx = make_routed(_port_corpus(corpus), 128, 4)
    ref = make_ref_routed(ref_corpus_, 128, 4)
    for s in idx.shards:
        s.device_store()
    stores_before = [s._store for s in idx.shards]
    epochs_before = [s.mutation_epoch for s in idx.shards]
    agg_before = idx.mutation_epoch

    key_cells = [[query.cells[r][c] for c in q_cols] for r in range(query.n_rows)]
    new_cells = [kc + ["routed-extra"] for kc in key_cells]
    tid = idx.insert_table([list(r) for r in new_cells])  # appends to the LAST shard
    assert tid == ref.insert_table([list(r) for r in new_cells])
    idx.update_cell(tid, 0, len(new_cells[0]) - 1, "mutated")
    ref.update_cell(tid, 0, len(new_cells[0]) - 1, "mutated")

    epochs_after = [s.mutation_epoch for s in idx.shards]
    assert epochs_after == [s.mutation_epoch for s in ref.shards]
    assert epochs_after[:-1] == epochs_before[:-1]
    assert epochs_after[-1] > epochs_before[-1]
    assert idx.mutation_epoch == ref.mutation_epoch > agg_before
    for s, store in zip(idx.shards[:-1], stores_before[:-1]):
        assert s.device_store() is store
    assert idx.shards[-1].device_store() is not stores_before[-1]
    assert np.array_equal(xash.lanes_to_numpy(idx.shards[-1].device_store()), idx.shards[-1].superkeys)

    pq = _pt(query)
    mutated = [list(r) for r in new_cells]
    mutated[0][-1] = "mutated"
    rebuilt = index.MateIndex(
        port_corpus.Corpus([*idx.corpus.tables[:-1], port_corpus.Table(tid, mutated)]),
        cfg=idx.cfg, device="cpu",
    )
    got, _ = batched.discover_batched(idx, pq, q_cols, k=8, backend="fused-gather")
    want, _ = batched.discover_batched(rebuilt, pq, q_cols, k=8, backend="numpy")
    ref_got, _ = ref_batched.discover_batched(ref, query, q_cols, k=8, backend="numpy")
    assert _key(got) == _key(want) == _key(ref_got)
    assert tid in [e.table_id for e in got]

    epochs_mid = [s.mutation_epoch for s in idx.shards]
    idx.delete_table(tid)
    ref.delete_table(tid)
    epochs_del = [s.mutation_epoch for s in idx.shards]
    assert epochs_del[:-1] == epochs_mid[:-1] and epochs_del[-1] > epochs_mid[-1]
    gone = index.MateIndex(
        port_corpus.Corpus([t for t in idx.corpus.tables if t.table_id != tid]), cfg=idx.cfg,
        device="cpu",
    )
    got2, _ = batched.discover_batched(idx, pq, q_cols, k=8, backend="fused")
    want2, _ = batched.discover_batched(gone, pq, q_cols, k=8, backend="numpy")
    ref_got2, _ = ref_batched.discover_batched(ref, query, q_cols, k=8, backend="numpy")
    assert _key(got2) == _key(want2) == _key(ref_got2)
    assert tid not in [e.table_id for e in got2]


def test_update_cell_on_interior_shard_touches_only_that_shard():
    corpus, query, q_cols = _fresh_lake()
    idx = make_routed(_port_corpus(corpus), 128, 4)
    for s in idx.shards:
        s.device_store()
    stores = [s._store for s in idx.shards]
    epochs = [s.mutation_epoch for s in idx.shards]
    tid = int(idx.shards[1].table_lo)  # a table of an interior shard
    assert idx.shard_of_table(tid).shard_id == 1
    old = idx.corpus.tables[tid].cells[0][0]
    idx.update_cell(tid, 0, 0, old + "-touched")
    for i, s in enumerate(idx.shards):
        if i == 1:
            assert s.mutation_epoch > epochs[i]
            assert s.device_store() is not stores[i]
        else:
            assert s.mutation_epoch == epochs[i]
            assert s.device_store() is stores[i]
    pq = _pt(query)
    rebuilt = index.MateIndex(port_corpus.Corpus(idx.corpus.tables), cfg=idx.cfg, device="cpu")
    got, _ = batched.discover_batched(idx, pq, q_cols, k=8, backend="fused-gather")
    want, _ = batched.discover_batched(rebuilt, pq, q_cols, k=8, backend="numpy")
    assert _key(got) == _key(want)


# ---------------------------------------------------------------------------
# The serving tier over a routed session
# ---------------------------------------------------------------------------


def test_serving_engine_over_routed_session(lake, single_host):
    """A ``DiscoveryEngine`` over a routed session serves what the
    reference's engine over its routed session serves, with the same
    ``shard_launches`` / ``route_bytes_merged`` in the served stats; the
    result cache answers repeats and a shard-local mutation invalidates it."""
    corpus, query, q_cols = _fresh_lake()
    queries = [(query, q_cols)] + ref_synthetic.make_mixed_queries(corpus, 2, 10, 2, seed=11)
    routed = session.MateSession.build(
        _port_corpus(corpus), session.DiscoveryConfig(bits=128, result_cache=4, backend="fused-gather"),
        distributed=True, n_shards=4, device="cpu",
    )
    ref_routed = ref_session.MateSession.build(
        corpus, ref_session.DiscoveryConfig(bits=128, result_cache=4, backend="numpy"),
        distributed=True, n_shards=4,
    )
    eng = engine.DiscoveryEngine(session=routed, batch=4)
    ref_eng = ref_engine.DiscoveryEngine(session=ref_routed, batch=4)
    reqs = [eng.submit(_pt(q), qc) for q, qc in queries]
    ref_reqs = [ref_eng.submit(q, qc) for q, qc in queries]
    assert len(eng.flush()) == len(ref_eng.flush()) == len(queries)
    assert all(r.done for r in reqs)
    ref = ref_session.MateSession(single_host[128], ref_session.DiscoveryConfig(bits=128))
    for (q, qc), req, rreq in zip(queries, reqs, ref_reqs):
        want, _ = ref.discover(q, qc, k=routed.config.k)
        assert _key(req.results) == _key(rreq.results) == _key(want)
    for name in ("shard_launches", "route_bytes_merged", "requests", "cache_hits"):
        assert getattr(routed.stats, name) == getattr(ref_routed.stats, name), name
    assert routed.stats.shard_launches > 0
    hit = eng.discover(_pt(query), q_cols)
    assert hit.from_cache and ref_eng.discover(query, q_cols).from_cache
    routed.insert_table([["cache", "buster"]])
    ref_routed.insert_table([["cache", "buster"]])
    miss = eng.discover(_pt(query), q_cols)
    assert not miss.from_cache
    assert _key(miss.results) == _key(ref_eng.discover(query, q_cols).results)
    assert routed.stats.shard_launches == ref_routed.stats.shard_launches


@pytest.mark.parametrize("bits", ALL_BITS)
def test_sessions_mutate_shard_locally(lake, bits):
    """§5.4 through a routed session reaches the owning shard only."""
    corpus, query, q_cols = _fresh_lake()
    s = session.MateSession.build(
        _port_corpus(corpus), session.DiscoveryConfig(bits=bits), distributed=True, n_shards=4,
        device="cpu",
    )
    epochs = [sh.mutation_epoch for sh in s.index.shards]
    tid = int(s.index.shards[2].table_lo)
    s.update_cell(tid, 0, 0, "session-touched")
    assert [sh.mutation_epoch for sh in s.index.shards] == [
        e + (i == 2) for i, e in enumerate(epochs)
    ]
    s.delete_table(int(s.index.shards[0].table_lo))
    assert s.index.shards[0].mutation_epoch == epochs[0] + 1
    assert s.index.mutation_epoch == sum(epochs) + 2


def _serve_async(engine_mod, sess, queries):
    """Every query through an ``AsyncDiscoveryEngine`` whose window is the
    whole batch: the answers and the session's routed counters."""
    async def run():
        async with engine_mod.AsyncDiscoveryEngine(session=sess) as eng:
            reqs = await asyncio.gather(*(eng.discover_async(q, c) for q, c in queries))
        return [_key(r.results) for r in reqs]

    keys = asyncio.run(run())
    return keys, (sess.stats.requests, sess.stats.shard_launches, sess.stats.route_bytes_merged)


def test_async_engine_over_routed_session(lake):
    """``AsyncDiscoveryEngine`` over a routed session: the reference's
    answers and served routed counters."""
    corpus, pc, query, q_cols = lake
    queries = [(query, q_cols)] + ref_synthetic.make_mixed_queries(corpus, 2, 10, 2, seed=11)
    routed = session.MateSession.build(
        pc, session.DiscoveryConfig(window=len(queries), backend="fused-gather"),
        distributed=True, n_shards=4, device="cpu",
    )
    ref_routed = ref_session.MateSession.build(
        corpus, ref_session.DiscoveryConfig(window=len(queries), backend="numpy"),
        distributed=True, n_shards=4,
    )
    got = _serve_async(engine, routed, [(_pt(q), c) for q, c in queries])
    want = _serve_async(ref_engine, ref_routed, queries)
    assert got == want
    assert got[1][0] == len(queries) and got[1][1] > 0
