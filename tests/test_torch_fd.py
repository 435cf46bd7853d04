"""The FD workload: ``repro_torch.core.fd`` against ``repro.core.fd``.

The same seeded planted-FD lakes (``tests/test_fd.py``'s construction:
clean FD tables, violators, near-misses, duplicate rows, empty strings,
permuted key columns, zero-row tables) go through both packages.  The
reference runs its ``numpy`` backend (its Pallas backends are interpret
mode on the CPU); the port runs 'fused-gather' (the CUDA default, whose
phase A is kernel B.2), 'fused' and 'numpy' on CPU tensors, where every
kernel wrapper takes its plain version.  Pinned: the verdict tuples
``(table_id, support, holds, violations, score)`` in order, the prune
counters (``fd_candidates``, ``fd_validated``, ``fd_bytes_verified``) and
the verified pair counts, equal; the brute-force oracle agrees; errors
word for word.  Ensemble scores are float64 host arithmetic in the
reference's op order, held equal within 1e-12 (they come out identical).
The routed cases of ``test_fd.py`` run here too: ``discover_fds`` on a
routed index (``build_routed_index``) at {1, 2, 4, 8} shards × every width,
against the reference's routed and single-host indexes, routed counters
included.
"""

import dataclasses

import pytest

from conftest import ALL_BITS
from test_fd import fd_oracle_python, planted_fd_lake
from repro.core import batched as ref_batched
from repro.core import fd as ref_fd
from repro.core import index as ref_index
from repro.core import routing as ref_routing
from repro.core import session as ref_session
from repro.core import xash as ref_xash
from repro_torch.core import batched, corpus as port_corpus, fd, index, routing, session, xash

PORT_BACKENDS = ("fused-gather", "fused", "numpy")
SEEDS = (0, 1, 2)
SHARD_COUNTS = (1, 2, 4, 8)
SCORE_ATOL = 1e-12
STAT_FIELDS = ("fd_candidates", "fd_validated", "fd_bytes_verified", "verified_tp",
               "verified_fp", "filter_checks", "filter_passed", "pl_items_checked")


def _pt(t):
    return port_corpus.Table(t.table_id, [list(r) for r in t.cells], t.name)


def _port_corpus(c):
    return port_corpus.Corpus([_pt(t) for t in c.tables], max_len=c.max_len)


_BUILT: dict = {}


def _lake(seed: int, bits: int):
    """(corpus, query, det, dep, ref index, port index, port query), cached:
    tests mutate only indexes they build themselves."""
    if (seed, bits) not in _BUILT:
        corpus, query, det, dep = planted_fd_lake(seed)
        ref = ref_index.build_index(corpus, cfg=ref_xash.XashConfig(bits=bits))[0]
        port = index.build_index(_port_corpus(corpus), cfg=xash.XashConfig(bits=bits), device="cpu")[0]
        _BUILT[seed, bits] = (corpus, query, det, dep, ref, port, _pt(query))
    return _BUILT[seed, bits]


def _verdicts(fds):
    return [dataclasses.astuple(c) for c in fds]


def _facts(fds):
    return {c.table_id: (c.support, c.holds, c.violations) for c in fds}


def _stats(stats):
    return {f: getattr(stats, f) for f in STAT_FIELDS}


def _assert_same(got, want):
    (gfds, gst), (wfds, wst) = got, want
    assert [c.table_id for c in gfds] == [c.table_id for c in wfds]
    assert [dataclasses.astuple(c)[:4] for c in gfds] == [dataclasses.astuple(c)[:4] for c in wfds]
    for g, w in zip(gfds, wfds):
        assert (g.score is None) == (w.score is None)
        if w.score is not None:
            assert g.score == pytest.approx(w.score, abs=SCORE_ATOL, rel=0)
    assert _stats(gst) == _stats(wst)


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("min_support", (1, 2))
def test_verdicts_match_reference_at_every_width(bits, seed, min_support):
    corpus, query, det, dep, ref, port, pq = _lake(seed, bits)
    want = ref_fd.discover_fds(ref, query, det, dep, min_support=min_support, backend="numpy")
    assert _facts(want[0]) == fd_oracle_python(corpus, query, det, dep, min_support)
    for backend in PORT_BACKENDS:
        got = fd.discover_fds(port, pq, det, dep, min_support=min_support, backend=backend)
        _assert_same(got, want)
        assert _verdicts(got[0]) == _verdicts(want[0])
        assert got[1].filter_lanes == want[1].filter_lanes == port.cfg.lanes


def test_count_prune_matches_reference():
    _, query, det, dep, ref, port, pq = _lake(0, 128)
    for min_support in (1, 2):
        want = ref_fd.discover_fds(ref, query, det, dep, min_support=min_support, backend="numpy")
        got = fd.discover_fds(port, pq, det, dep, min_support=min_support, backend="fused-gather")
        _assert_same(got, want)
    one = fd.discover_fds(port, pq, det, dep, min_support=1)[1]
    two = fd.discover_fds(port, pq, det, dep, min_support=2)[1]
    assert two.fd_candidates == one.fd_candidates
    assert two.fd_validated < one.fd_validated
    assert two.fd_bytes_verified < one.fd_bytes_verified


def test_no_matches_yields_empty():
    _, _, det, dep, ref, port, _ = _lake(0, 128)
    stranger = [["no-such-a", "no-such-b", "dep"]]
    want = ref_fd.discover_fds(ref, ref_fd.Table(-1, stranger), det, dep, backend="numpy")
    got = fd.discover_fds(port, port_corpus.Table(-1, stranger), det, dep)
    _assert_same(got, want)
    assert got[0] == [] and got[1].fd_candidates == got[1].fd_validated == 0


def test_trivial_fd_rejected_with_the_reference_message():
    _, query, det, _, ref, port, pq = _lake(0, 128)
    with pytest.raises(ValueError, match="trivial") as want:
        ref_fd.discover_fds(ref, query, det, det[0])
    with pytest.raises(ValueError) as got:
        fd.discover_fds(port, pq, det, det[0])
    assert str(got.value) == str(want.value)


def test_stale_plancounts_raises_with_the_reference_message():
    corpus, query, det, dep = planted_fd_lake(0)
    ref = ref_index.build_index(corpus, cfg=ref_xash.XashConfig(bits=128))[0]
    port = index.build_index(_port_corpus(corpus), cfg=xash.XashConfig(bits=128), device="cpu")[0]
    [rpc] = ref_batched.plan_and_count(ref, [(query, det)], "numpy")
    [ppc] = batched.plan_and_count(port, [(_pt(query), det)], "fused-gather")
    ref.insert_table([["mutant", "row"]])
    port.insert_table([["mutant", "row"]])
    with pytest.raises(ValueError, match="stale") as want:
        ref_fd.fds_from_counts(ref, rpc, dep)
    with pytest.raises(ValueError) as got:
        fd.fds_from_counts(port, ppc, dep)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_session_threads_config_and_absorbs_stats(backend):
    corpus, query, det, dep, ref, port, pq = _lake(2, 128)
    rs = ref_session.MateSession(ref, ref_session.DiscoveryConfig(backend="numpy"))
    ps = session.MateSession(port, session.DiscoveryConfig(backend=backend))
    want = rs.discover_fds(query, det, dep, min_support=1)
    got = ps.discover_fds(pq, det, dep, min_support=1)
    _assert_same(got, want)
    assert _facts(got[0]) == fd_oracle_python(corpus, query, det, dep, 1)
    for name in ("requests", "fd_candidates", "fd_validated", "fd_bytes_verified",
                 "verified_tp", "verified_fp", "tables_gated", "gate_bytes_saved"):
        assert getattr(ps.stats, name) == getattr(rs.stats, name), name
    assert ps.stats.requests == 1 and ps.stats.fd_validated > 0


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("seed", SEEDS)
def test_signals_reorder_never_change_facts(bits, seed):
    _, query, det, dep, ref, port, pq = _lake(seed, bits)
    plain = fd.discover_fds(port, pq, det, dep)[0]
    for signals in (ref_fd.DEFAULT_SIGNALS, (("name", 1.0),), (("sketch", 0.3), ("uniqueness", 2.0))):
        rs = ref_session.MateSession(ref, ref_session.DiscoveryConfig(backend="numpy", signals=signals))
        ps = session.MateSession(port, session.DiscoveryConfig(backend="fused-gather", signals=signals))
        want = rs.discover_fds(query, det, dep)
        got = ps.discover_fds(pq, det, dep)
        _assert_same(got, want)
        assert _facts(got[0]) == _facts(plain)
        assert all(c.score is not None for c in got[0])
        scores = [c.score for c in got[0]]
        assert scores == sorted(scores, reverse=True)
    assert all(c.score is None for c in plain)


@pytest.mark.parametrize("bad", [
    [("joinability", 1.0)],
    (("bogus", 1.0),),
    (("joinability", 0.0),),
    (("joinability",),),
], ids=["list", "unknown", "zero-weight", "malformed"])
def test_config_rejects_malformed_signals_with_the_reference_message(bad):
    with pytest.raises(ValueError) as want:
        ref_session.DiscoveryConfig(signals=bad)
    with pytest.raises(ValueError) as got:
        session.DiscoveryConfig(signals=bad)
    assert str(got.value) == str(want.value)


def test_ensemble_rejects_unknown_signals_like_the_reference():
    _, query, det, dep, ref, port, pq = _lake(0, 128)
    [rpc] = ref_batched.plan_and_count(ref, [(query, det)], "numpy")
    [ppc] = batched.plan_and_count(port, [(pq, det)], "numpy")
    with pytest.raises(ValueError) as want:
        ref_fd.fds_from_counts(ref, rpc, dep, signals=(("bogus", 1.0),))
    with pytest.raises(ValueError) as got:
        fd.fds_from_counts(port, ppc, dep, signals=(("bogus", 1.0),))
    assert str(got.value) == str(want.value)


def test_helpers_match_reference():
    corpus, query, det, dep, *_ = _lake(1, 128)
    assert fd.dependent_groups(_pt(query), det, dep) == ref_fd.dependent_groups(query, det, dep)
    for name in [t.name for t in corpus.tables] + ["Fd Query-0", "a_b  c", "", "!!"]:
        assert fd._name_tokens(name) == ref_fd._name_tokens(name)
        other = ref_fd._name_tokens(query.name)
        assert fd._token_jaccard(fd._name_tokens(name), other) == ref_fd._token_jaccard(
            ref_fd._name_tokens(name), other
        )


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_routed_bit_identical(bits, n_shards):
    """``discover_fds`` on the routed lake: the verdict sequence equals the
    reference's on its routed and single-host indexes, and validation
    re-gathers the survivors' rows from their owning shards."""
    corpus, query, det, dep, ref, _port, pq = _lake(1, bits)
    ref_routed, _ = ref_routing.build_routed_index(
        corpus, cfg=ref_xash.XashConfig(bits=bits), n_shards=n_shards
    )
    routed, _ = routing.build_routed_index(
        _port_corpus(corpus), cfg=xash.XashConfig(bits=bits), n_shards=n_shards, device="cpu"
    )
    want_single = ref_fd.discover_fds(ref, query, det, dep, backend="numpy")
    want = ref_fd.discover_fds(ref_routed, query, det, dep, backend="numpy")
    assert _verdicts(want[0]) == _verdicts(want_single[0])
    for backend in PORT_BACKENDS:
        got = fd.discover_fds(routed, pq, det, dep, backend=backend)
        _assert_same(got, want)
        assert _verdicts(got[0]) == _verdicts(want[0])
        for name in ("shard_launches", "route_bytes_merged"):
            assert getattr(got[1], name) == getattr(want[1], name), name
        if n_shards > 1:
            assert got[1].fd_bytes_verified > 0
