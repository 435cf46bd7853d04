"""The slice as a whole: ``MateSession.build`` → ``discover`` /
``discover_many`` in the port against the reference ``MateSession``.

Top-k ``(table_id, joinability, mapping)`` must be identical for every port
backend at every width; ``quality`` scores (float32, the reference's op
order) within 1e-6 absolute with an identical order; the counted
``DiscoveryStats`` fields equal to the reference's under the same backend
name; ``DiscoveryConfig`` errors word for word; and the port's synthetic
generator cell-identical to the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import ALL_BITS, ground_truth_lake
from repro.core import batched as ref_batched
from repro.core import discovery as ref_discovery
from repro.core import session as ref_session
from repro.data import synthetic as ref_synthetic
from repro_torch.core import batched, corpus as port_corpus, discovery, ranking, session
from repro_torch.data import synthetic

PORT_BACKENDS = ("fused-gather", "fused", "pallas", "xla", "numpy", "auto")
QUALITY_ATOL = 1e-6  # float32 scores, same op order as score_np


def _port_corpus(c):
    return port_corpus.Corpus(
        [port_corpus.Table(t.table_id, [list(r) for r in t.cells], t.name) for t in c.tables],
        max_len=c.max_len,
    )


def _pt(q):
    return port_corpus.Table(q.table_id, [list(r) for r in q.cells], q.name)


def _key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


def _assert_same(got, want):
    assert _key(got) == _key(want)
    if want and want[0].quality is not None:
        np.testing.assert_allclose(
            [e.quality for e in got], [e.quality for e in want], rtol=0, atol=QUALITY_ATOL
        )


@pytest.fixture(scope="module")
def lake():
    corpus, query, q_cols, _expected = ground_truth_lake(n_tables=80)
    mixed = ref_synthetic.make_mixed_queries(corpus, 3, 15, seed=11)
    return corpus, [(query, q_cols)] + mixed


@pytest.fixture(scope="module")
def sessions(lake):
    corpus, _queries = lake
    pc = _port_corpus(corpus)
    out = {}
    for bits in ALL_BITS:
        ref = ref_session.MateSession.build(
            corpus, ref_session.DiscoveryConfig(bits=bits, backend="numpy")
        )
        port = session.MateSession.build(pc, session.DiscoveryConfig(bits=bits), device="cpu")
        out[bits] = (ref, port)
    return out


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("bits", ALL_BITS)
def test_discover_and_discover_many_match_reference(lake, sessions, bits, backend):
    _corpus, queries = lake
    ref, built = sessions[bits]
    port = session.MateSession(built.index, session.DiscoveryConfig(backend=backend, k=5))
    ref = ref_session.MateSession(ref.index, ref_session.DiscoveryConfig(backend="numpy", k=5))
    for q, cols in queries:
        got, _ = port.discover(_pt(q), cols)
        want, _ = ref.discover(q, cols)
        _assert_same(got, want)
    got_many = port.discover_many([(_pt(q), c) for q, c in queries], k=[5, 3, 4, 2])
    want_many = ref.discover_many(queries, k=[5, 3, 4, 2])
    for (g, _), (w, _) in zip(got_many, want_many):
        _assert_same(g, w)
    assert port.stats.requests == 2 * len(queries)


COUNTED = [f.name for f in dataclasses.fields(ref_discovery.DiscoveryStats)]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_counted_stats_match_reference_backend(backend):
    """Same backend name, same lake: every DiscoveryStats counter equal —
    batch_tables=4 and k=3 exercise rule 1 / rule 2 across batches, the
    lazy per-table readbacks and the counts-only launches."""
    corpus, query, q_cols, _expected = ground_truth_lake()
    cfg = dict(bits=128, backend=backend, k=3, batch_tables=4)
    ref = ref_session.MateSession.build(corpus, ref_session.DiscoveryConfig(**cfg))
    port = session.MateSession.build(
        _port_corpus(corpus), session.DiscoveryConfig(**cfg), device="cpu"
    )
    got, gs = port.discover(_pt(query), q_cols)
    want, ws = ref.discover(query, q_cols)
    _assert_same(got, want)
    assert {f: getattr(gs, f) for f in COUNTED} == {f: getattr(ws, f) for f in COUNTED}
    pair = [(query, q_cols), (query, q_cols)]
    for (g, gst), (w, wst) in zip(
        port.discover_many([(_pt(q), c) for q, c in pair]), ref.discover_many(pair)
    ):
        _assert_same(g, w)
        assert {f: getattr(gst, f) for f in COUNTED} == {f: getattr(wst, f) for f in COUNTED}
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


def test_two_phase_and_degraded_lanes_match(lake, sessions):
    _corpus, queries = lake
    ref, port = sessions[512]
    ref_pcs = ref.plan_and_count(queries, filter_lanes=4)
    pcs = port.plan_and_count([(_pt(q), c) for q, c in queries], filter_lanes=4)
    for pc, rpc in zip(pcs, ref_pcs):
        assert np.array_equal(pc.counts, rpc.counts)
        assert pc.filter_lanes == rpc.filter_lanes == 4
        got, st = port.score_from_counts(pc, k=4)
        want, _ = ref.score_from_counts(rpc, k=4)
        _assert_same(got, want)
        replay, st2 = port.score_from_counts(pc.cacheable(), k=4, from_cache=True)
        _assert_same(replay, got)
        assert st2.gather_bytes_saved == 0


def test_mutation_then_discover_matches(lake):
    corpus, queries = lake
    ref_corpus = ground_truth_lake(n_tables=80)[0]
    ref = ref_session.MateSession.build(ref_corpus, ref_session.DiscoveryConfig(backend="numpy"))
    port = session.MateSession.build(_port_corpus(corpus), session.DiscoveryConfig(), device="cpu")
    q, cols = queries[0]
    top = ref.discover(q, cols)[0][0].table_id
    for s in (ref, port):
        s.update_cell(top, 0, 0, "a mutated cell")
        s.delete_table(top + 1)
        s.insert_table([[q.cells[r][c] for c in cols] + ["x"] for r in range(4)])
    for qq, cc in queries:
        _assert_same(port.discover(_pt(qq), cc)[0], ref.discover(qq, cc)[0])


@pytest.mark.parametrize("bits", ALL_BITS)
def test_scalar_algorithm_and_bruteforce(lake, sessions, bits):
    corpus, queries = lake
    ref, port = sessions[bits]
    q, cols = queries[0]
    got, gs = discovery.discover(port.index, _pt(q), cols, k=10)
    want, ws = ref_discovery.discover(ref.index, q, cols, k=10)
    assert _key(got) == _key(want)
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    pc = port.index.corpus
    assert discovery.topk_bruteforce(pc, _pt(q), cols, 10) == ref_discovery.topk_bruteforce(
        corpus, q, cols, 10
    )
    bat, _ = batched.discover_batched(port.index, _pt(q), cols, k=10, rank="count")
    assert _key(bat) == _key(want)
    assert batched.filter_outcomes(
        port.index, _pt(q), cols, check_false_negatives=True
    ) == ref_batched.filter_outcomes(ref.index, q, cols, check_false_negatives=True)


def test_quality_scores_match_score_np(lake, sessions):
    _corpus, queries = lake
    _ref, port = sessions[128]
    index = port.index
    ids = np.arange(len(index.corpus.tables), dtype=np.int64)
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 30, size=ids.shape[0]).astype(np.int32)
    keys = [tuple(r[c] for c in queries[0][1]) for r in queries[0][0].cells]
    q_sk = ranking.query_sketch(index, keys)
    got = ranking.quality_scores(index, ids, counts, len(keys), q_sk)
    card_max, n_rows, sketch = index.profile_features(ids)
    want = ranking.score_np(counts, len(keys), card_max, n_rows, (sketch == q_sk[None]).sum(axis=1))
    np.testing.assert_allclose(got, want, rtol=0, atol=QUALITY_ATOL)


BAD_CONFIGS = [
    dict(bits=64), dict(backend="nope"), dict(fused_block_n=100), dict(rank="best"),
    dict(signals=[("joinability", 1.0)]), dict(signals=(("joinability",),)),
    dict(signals=(("bogus", 1.0),)), dict(signals=(("sketch", 0.0),)),
    dict(prefetch_frac=1.5), dict(batch_tables=0), dict(k=0), dict(window=0),
    dict(flush_after=-1.0), dict(deadline_margin=-1.0), dict(max_queue=0),
    dict(pressure_policy="drop"), dict(degrade_bits=100), dict(result_cache=-1),
    dict(bound_cache=-1),
]


@pytest.mark.parametrize("kwargs", BAD_CONFIGS, ids=lambda kw: next(iter(kw)))
def test_config_errors_match_reference(kwargs):
    with pytest.raises(ValueError) as want:
        ref_session.DiscoveryConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        session.DiscoveryConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_config_fields_match_reference():
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(ref_session.DiscoveryConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(session.DiscoveryConfig)] == ref_fields
    assert session.SIGNAL_NAMES == __import__("repro.core.fd", fromlist=["x"]).SIGNAL_NAMES


def test_build_defaults_to_cuda_and_raises_without_it(monkeypatch):
    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=10, seed=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        session.MateSession.build(corpus)
    s = session.MateSession.build(corpus, device="cpu")
    assert s.backend.name == "auto" and s.backend.source == "platform"


def test_unported_parts_raise():
    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=10, seed=1))
    with pytest.raises(NotImplementedError, match="A.7"):
        session.MateSession.build(corpus, distributed=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A.7"):
        session.MateSession.build(corpus, n_shards=2, device="cpu")
    s = session.MateSession.build(corpus, device="cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        s.discover_fds(None, [0], 1)


@pytest.mark.parametrize("seed,n_tables", [(0, 30), (7, 60)])
def test_synthetic_corpus_cell_identical(seed, n_tables):
    spec = dict(n_tables=n_tables, seed=seed)
    ref = ref_synthetic.make_corpus(ref_synthetic.SyntheticSpec(**spec))
    port = synthetic.make_corpus(synthetic.SyntheticSpec(**spec))
    assert [t.cells for t in port.tables] == [t.cells for t in ref.tables]
    assert np.array_equal(port.cell_value_ids, ref.cell_value_ids)
    assert np.array_equal(port.unique_enc, ref.unique_enc)
    rq, rc, rexp, rcorp = ref_synthetic.make_query_with_ground_truth(ref, seed=seed + 1)
    pq, pcols, pexp, pcorp = synthetic.make_query_with_ground_truth(port, seed=seed + 1)
    assert (pq.cells, pcols, pexp) == (rq.cells, rc, rexp)
    assert [t.cells for t in pcorp.tables] == [t.cells for t in rcorp.tables]
    assert [q.cells for q, _ in synthetic.make_mixed_queries(pcorp, 3, 10)] == [
        q.cells for q, _ in ref_synthetic.make_mixed_queries(rcorp, 3, 10)
    ]
