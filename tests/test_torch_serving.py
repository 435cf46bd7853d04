"""The discovery serving tier: ``repro_torch.serve`` against ``repro.serve``.

Every scenario of ``tests/test_serving.py`` that runs on one host is a
function of a package namespace ``P`` (the reference's modules or the
port's) and returns what a caller observes: each request's future (top-k
``(table_id, joinability, mapping)``, or the exception's type and text, or
cancelled), the filter width it ran at, the session's ``shed`` /
``degraded`` / ``cache_hits`` / ``bound_hits`` / ``requests`` counters and
the cache statistics.  Each test runs the same scenario on both packages,
each on its own lake (the port's synthetic generator is cell-identical to
the reference's), and asserts the observations equal — and the scenario's
own expectations, so an equal-but-empty run cannot pass.  Everything runs
under virtual time (``ManualClock`` or a ticking dict clock).

The port's sessions run on CPU tensors, where every kernel wrapper takes
its plain version; each scenario that filters also runs the port under
'fused-gather' (the CUDA default, whose degraded groups probe a lane
prefix of the device store) beside the platform default.  The
reference's hypothesis properties are seeded parametrised cases here.
"""

import asyncio
import dataclasses
import types

import numpy as np
import pytest

from repro.core import batched as ref_batched
from repro.core import corpus as ref_corpus
from repro.core import discovery as ref_discovery
from repro.core import index as ref_index
from repro.core import session as ref_session
from repro.core import xash as ref_xash
from repro.data import synthetic as ref_synthetic
from repro.serve import cache as ref_cache
from repro.serve import clock as ref_clock
from repro.serve import engine as ref_engine
from repro_torch.core import batched, corpus, discovery, index, session, xash
from repro_torch.data import synthetic
from repro_torch.serve import cache, clock, engine

VALID_BITS = (128, 256, 512)


def _ns(batched_m, corpus_m, discovery_m, index_m, session_m, xash_m, synthetic_m,
        cache_m, clock_m, engine_m, **build_kw):
    return types.SimpleNamespace(
        build=lambda c, bits: index_m.build_index(c, cfg=xash_m.XashConfig(bits=bits), **build_kw)[0],
        discover_batched=batched_m.discover_batched, Table=corpus_m.Table,
        DiscoveryStats=discovery_m.DiscoveryStats, DiscoveryConfig=session_m.DiscoveryConfig,
        MateSession=session_m.MateSession, synthetic=synthetic_m,
        QueryResultCache=cache_m.QueryResultCache, BoundCache=cache_m.BoundCache,
        query_fingerprint=cache_m.query_fingerprint, ManualClock=clock_m.ManualClock,
        AdmissionError=engine_m.AdmissionError, DiscoveryEngine=engine_m.DiscoveryEngine,
        AsyncDiscoveryEngine=engine_m.AsyncDiscoveryEngine, backend=None,
    )


REF = _ns(ref_batched, ref_corpus, ref_discovery, ref_index, ref_session, ref_xash,
          ref_synthetic, ref_cache, ref_clock, ref_engine)
PORT = _ns(batched, corpus, discovery, index, session, xash, synthetic, cache, clock, engine,
           device="cpu")
PORT_BACKENDS = (None, "fused-gather")


def _port(backend):
    return types.SimpleNamespace(**{**vars(PORT), "backend": backend}) if backend else PORT


def _lake(P):
    corpus_ = P.synthetic.make_corpus(P.synthetic.SyntheticSpec(n_tables=60, seed=0))
    return corpus_, P.synthetic.make_mixed_queries(corpus_, 6, 10, 2, seed=7)


@pytest.fixture(scope="module")
def lakes():
    """Per package: (queries, {bits: index}) over the 60-table lake."""
    out = {}
    for name, P in (("ref", REF), ("port", PORT)):
        corpus_, queries = _lake(P)
        out[name] = (queries, {bits: P.build(corpus_, bits) for bits in VALID_BITS})
    return out


def _both(lakes, scenario, backend=None, **kw):
    """Run ``scenario(P, queries, indexes, **kw)`` on both packages; equal
    observations, returned once."""
    want = scenario(REF, *lakes["ref"], **kw)
    got = scenario(_port(backend), *lakes["port"], **kw)
    assert got == want
    return want


def _fresh(P, bits=128):
    return P.build(_lake(P)[0], bits)


def _config(P, **cfg):
    cfg.setdefault("k", 5)
    if P.backend:
        cfg.setdefault("backend", P.backend)
    return P.DiscoveryConfig(**cfg)


def _engine(P, index_, clk, **cfg):
    sess = P.MateSession(index_, _config(P, **cfg))
    return P.DiscoveryEngine(session=sess, clock=clk), sess


def _key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


def _cold(P, index_, query, q_cols, k=5):
    return _key(P.discover_batched(index_, query, q_cols, k=k, rank="quality", profile_gate=True)[0])


def _fut(req):
    """What an awaiter of ``req.future`` sees."""
    f = req.future
    if f.cancelled():
        return ("cancelled",)
    if not f.done():
        return ("pending",)
    e = f.exception()
    if e is not None:
        return ("error", type(e).__name__, str(e))
    entries, stats = f.result()
    return ("ok", _key(entries), stats.filter_lanes)


def _counters(sess):
    st = sess.stats
    return (st.requests, st.shed, st.degraded, st.cache_hits, st.bound_hits)


async def _spin(n=12):
    for _ in range(n):
        await asyncio.sleep(0)


# ---------------------------------------------------------------------------
# Backpressure: shed and degrade
# ---------------------------------------------------------------------------

def _shed(P, queries, built):
    clk = P.ManualClock()
    eng, sess = _engine(P, built[128], clk.now, window=8, max_queue=2, pressure_policy="shed")
    admitted = [eng.submit(*queries[i]) for i in range(2)]
    shed = eng.submit(*queries[2])
    before = (_fut(shed), eng.queue == admitted, _counters(sess))
    served = eng.flush()
    return before, served == admitted, [_fut(r) for r in admitted], _counters(sess)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_shed_rejects_future_not_hangs(lakes, backend):
    (shed, in_queue, counters), served_ok, _, _ = _both(lakes, _shed, backend)
    assert shed[:2] == ("error", "AdmissionError") and in_queue and served_ok
    assert counters[1] == 1


def _degrade(P, queries, built):
    clk = P.ManualClock()
    eng, sess = _engine(P, built[512], clk.now, window=8, max_queue=1,
                        pressure_policy="degrade", degrade_bits=128)
    normal = eng.submit(*queries[0])
    degraded = eng.submit(*queries[1])
    flags = (normal.degraded, degraded.degraded, _counters(sess))
    eng.flush()
    return (flags, _fut(normal), _fut(degraded), degraded.stats.filter_passed,
            sorted(_key(degraded.results)) == sorted(_cold(P, built[512], *queries[1])),
            _key(normal.results) == _cold(P, built[512], *queries[0]))


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_degrade_admits_at_narrow_width_bit_identical(lakes, backend):
    (flags, _, deg, _, deg_exact, normal_exact) = _both(lakes, _degrade, backend)
    assert flags[:2] == (False, True) and flags[2][1:3] == (0, 1)
    assert deg[2] == 4 and deg_exact and normal_exact


def _hard_shed(P, queries, built):
    clk = P.ManualClock()
    eng, sess = _engine(P, built[256], clk.now, window=16, max_queue=1, pressure_policy="degrade")
    q, qc = queries[0]
    eng.submit(q, qc)
    deg = eng.submit(q, qc)
    hard = eng.submit(q, qc)
    return deg.degraded, _fut(hard), _counters(sess)


def test_degrade_hard_sheds_at_twice_max_queue(lakes):
    degraded, hard, counters = _both(lakes, _hard_shed)
    assert degraded and hard[:2] == ("error", "AdmissionError") and counters[1:3] == (1, 1)


def _unbounded(P, queries, built):
    clk = P.ManualClock()
    eng, sess = _engine(P, built[128], clk.now, window=4)
    reqs = [eng.submit(*queries[i % len(queries)]) for i in range(20)]
    queued = len(eng.queue)
    eng.flush()
    return queued, [_fut(r) for r in reqs], _counters(sess)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_unbounded_queue_never_sheds(lakes, backend):
    queued, futs, counters = _both(lakes, _unbounded, backend)
    assert queued == 20 and all(f[0] == "ok" for f in futs) and counters[1] == 0


# ---------------------------------------------------------------------------
# Deadline-aware partial-group launch
# ---------------------------------------------------------------------------

def _fixed_margin(P, queries, built):
    clk = P.ManualClock()
    eng, _ = _engine(P, built[128], clk.now, window=8, flush_after=1.0, deadline_margin=0.25)
    r1 = eng.submit(*queries[0])
    deadline = eng.next_deadline()
    clk.advance(0.74)
    early = eng.pump()
    clk.advance(0.01)
    on_time = eng.pump()
    return deadline, early, on_time == [r1], _fut(r1)


def test_fixed_margin_launches_partial_group_early(lakes):
    deadline, early, on_time, fut = _both(lakes, _fixed_margin)
    assert deadline == pytest.approx(0.75) and early == [] and on_time and fut[0] == "ok"


def _arrival_order(P, queries, built):
    clk = P.ManualClock()
    eng, _ = _engine(P, built[128], clk.now, window=2, flush_after=1.0, deadline_margin=0.5)
    r1 = eng.submit(*queries[0])
    clk.advance(0.6)
    r2 = eng.submit(*queries[1])
    first = eng.pump() == [r1, r2]
    r3 = eng.submit(*queries[2])
    none_yet = eng.pump()
    deadline = eng.next_deadline()
    clk.advance(0.5)
    last = eng.pump() == [r3]
    return first, none_yet, deadline, last, [_fut(r) for r in (r1, r2, r3)]


def test_margin_preserves_arrival_order_across_groups(lakes):
    first, none_yet, deadline, last, _ = _both(lakes, _arrival_order)
    assert first and none_yet == [] and deadline == pytest.approx(1.1) and last


def _auto_margin(P, queries, built):
    t = {"now": 0.0}

    def ticking_clock():
        t["now"] += 0.01
        return t["now"]

    eng, _ = _engine(P, built[128], ticking_clock, window=4, flush_after=10.0,
                     deadline_margin=None)
    margins = [eng._margin()]
    eng.submit(*queries[0])
    eng.flush()
    margins.append(eng._margin())
    r = eng.submit(*queries[1])
    deadline_gap = eng.next_deadline() - r.arrival
    eng.flush()
    margins.append(eng._margin())
    return margins, deadline_gap, eng._service_ewma


def test_auto_margin_tracks_observed_service_time(lakes):
    margins, gap, ewma = _both(lakes, _auto_margin)
    assert margins[0] == 0.0 and margins[1:] == pytest.approx([0.01, 0.01])
    assert gap == pytest.approx(10.0 - 0.01) and ewma == margins[-1]


# ---------------------------------------------------------------------------
# Cancellation
# ---------------------------------------------------------------------------

def _cancel_frees_window(P, queries, built):
    clk = P.ManualClock()
    eng, _ = _engine(P, built[128], clk.now, window=2, flush_after=None)
    r1 = eng.submit(*queries[0])
    r2 = eng.submit(*queries[1])
    cancelled = r2.cancel() and r2.cancelled
    first = (eng.pump(), eng.queue == [r1])
    r3 = eng.submit(*queries[2])
    second = eng.pump() == [r1, r3]
    return cancelled, first, second, [_fut(r) for r in (r1, r2, r3)], r2.results


def test_cancelled_request_never_launches_and_frees_window(lakes):
    cancelled, (first, only_r1), second, futs, r2_results = _both(lakes, _cancel_frees_window)
    assert cancelled and first == [] and only_r1 and second
    assert futs[1] == ("cancelled",) and r2_results is None


def _cancel_mid_queue(P, queries, built):
    clk = P.ManualClock()
    eng, sess = _engine(P, built[128], clk.now, window=2, flush_after=None)
    reqs = [eng.submit(*queries[i]) for i in range(4)]
    reqs[1].cancel()
    reqs[3].cancel()
    served = eng.flush()
    return served == [reqs[0], reqs[2]], [_fut(r) for r in reqs], _counters(sess)


def test_cancelled_mid_queue_flush_skips_it(lakes):
    served_ok, futs, counters = _both(lakes, _cancel_mid_queue)
    assert served_ok and counters[0] == 2
    assert futs[1] == futs[3] == ("cancelled",)


# ---------------------------------------------------------------------------
# Async pump task: interleaving, failure resilience, lifecycle
# ---------------------------------------------------------------------------

def _async_window_and_deadline(P, queries, built):
    async def run():
        clk = P.ManualClock()
        sess = P.MateSession(built[128], _config(P, window=2, flush_after=1.0))
        async with P.AsyncDiscoveryEngine(session=sess, clock=clk) as eng:
            a = asyncio.ensure_future(eng.discover_async(*queries[0]))
            b = asyncio.ensure_future(eng.discover_async(*queries[1]))
            await asyncio.gather(a, b)
            c = asyncio.ensure_future(eng.discover_async(*queries[2]))
            await _spin()
            waited = not c.done()
            clk.advance(1.0)
            await c
        return waited, [_fut(t.result()) for t in (a, b, c)], [
            _key(t.result().results) == _cold(P, built[128], *qq)
            for t, qq in zip((a, b, c), queries[:3])
        ]

    return asyncio.run(run())


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_async_pump_serves_window_and_deadline_groups(lakes, backend):
    waited, _, cold_equal = _both(lakes, _async_window_and_deadline, backend)
    assert waited and all(cold_equal)


def _async_failure(P, queries, built):
    async def run():
        clk = P.ManualClock()
        sess = P.MateSession(built[128], _config(P, window=2, flush_after=None))
        async with P.AsyncDiscoveryEngine(session=sess, clock=clk) as eng:
            good_sib = asyncio.ensure_future(eng.discover_async(*queries[0]))
            bad = asyncio.ensure_future(eng.discover_async(queries[0][0], [99]))
            errors = []
            for task in (bad, good_sib):
                try:
                    await task
                    errors.append(None)
                except IndexError as e:
                    errors.append(("IndexError", str(e)))
            alive = (eng.pump_errors, eng._task is not None and not eng._task.done())
            ra, rb = await asyncio.gather(
                eng.discover_async(*queries[1]), eng.discover_async(*queries[2])
            )
            return errors, alive, [_fut(ra), _fut(rb)], eng.pump_errors

    return asyncio.run(run())


def test_async_group_failure_rejects_siblings_and_pump_survives(lakes):
    errors, alive, later, pump_errors = _both(lakes, _async_failure)
    assert all(e and e[0] == "IndexError" for e in errors)
    assert alive == (1, True) and all(f[0] == "ok" for f in later) and pump_errors == 1


def _async_cancelled(P, queries, built):
    async def run():
        clk = P.ManualClock()
        sess = P.MateSession(built[128], _config(P, window=2, flush_after=5.0))
        async with P.AsyncDiscoveryEngine(session=sess, clock=clk) as eng:
            doomed = eng.submit(*queries[0])
            await _spin()
            doomed.cancel()
            before = sess.stats.requests
            a, b = await asyncio.gather(
                eng.discover_async(*queries[1]), eng.discover_async(*queries[2])
            )
            return [_fut(r) for r in (doomed, a, b)], doomed.results, sess.stats.requests - before

    return asyncio.run(run())


def test_async_cancelled_futures_never_launch(lakes):
    futs, doomed_results, served = _both(lakes, _async_cancelled)
    assert futs[0] == ("cancelled",) and doomed_results is None and served == 2


def _async_stop_no_drain(P, queries, built):
    async def run():
        clk = P.ManualClock()
        sess = P.MateSession(built[128], _config(P, window=8, flush_after=None))
        eng = P.AsyncDiscoveryEngine(session=sess, clock=clk)
        await eng.start()
        req = eng.submit(*queries[0])
        await _spin()
        await eng.stop(drain=False)
        return _fut(req), eng.queue

    return asyncio.run(run())


def test_async_stop_drain_false_rejects_backlog(lakes):
    fut, queue = _both(lakes, _async_stop_no_drain)
    assert fut == ("error", "AdmissionError", "engine stopped") and queue == []


def _sync_async_interleave(P, queries, built):
    sess = P.MateSession(built[128], _config(P, window=4, flush_after=0.01, result_cache=8))
    eng = P.DiscoveryEngine(session=sess)

    async def run():
        first = await asyncio.gather(*[eng.discover_async(q, qc) for q, qc in queries[:3]])
        again = await asyncio.gather(*[eng.discover_async(q, qc) for q, qc in queries[:3]])
        return first, again

    first, again = asyncio.run(run())
    return ([_fut(r) for r in first], [(r.from_cache, _fut(r)) for r in again],
            _counters(sess))


def test_sync_discover_async_waiters_interleave_with_caches(lakes):
    first, again, counters = _both(lakes, _sync_async_interleave)
    assert counters[3] == 3
    assert [hit for hit, _ in again] == [True] * 3 and [f for _, f in again] == first


# ---------------------------------------------------------------------------
# Caches: fingerprints and unit behaviour
# ---------------------------------------------------------------------------

def _fingerprints(P, queries, built):
    (q, qc) = queries[0]
    clone = dataclasses.replace(q, table_id=999, name="other")
    t1, t2 = P.Table(0, [["ab", "c"]]), P.Table(0, [["a", "bc"]])
    fp = P.query_fingerprint
    return (fp(q, qc), fp(clone, qc), fp(q, list(reversed(qc))), fp(q, qc, "order"),
            fp(q, qc, "tls"), fp(t1, [0, 1]), fp(t2, [0, 1]))


def test_fingerprint_is_content_keyed(lakes):
    fps = _both(lakes, _fingerprints)
    assert fps[0] == fps[1] and fps[0] != fps[2] and fps[3] != fps[4] and fps[5] != fps[6]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fingerprint_digests_equal_for_join_and_fd_workloads(seed):
    """Seeded query tables (empty cells, unicode, one to three key columns):
    every digest of the port equals the reference's, for the join workload
    and for FD workloads over several dependent columns and supports."""
    rng = np.random.default_rng(seed)
    alphabet = ["", "a", "ab", "Zürich", "1.5", "x y", "42", "ß", "été"]
    n_rows, n_cols = int(rng.integers(1, 12)), int(rng.integers(2, 5))
    cells = [[str(rng.choice(alphabet)) + str(int(rng.integers(0, 3))) * int(rng.integers(0, 2))
              for _ in range(n_cols)] for _ in range(n_rows)]
    ref_q, port_q = ref_corpus.Table(-1, cells, name="q"), corpus.Table(-1, cells, name="q")
    for q_cols in ([0], [0, 1], list(range(n_cols - 1))[::-1]):
        for init_mode in ("cardinality", "order"):
            for rank, gate in (("count", False), ("quality", True)):
                workloads = ["join"] + [f"fd:{dep}:{ms}" for dep in range(n_cols) if dep not in q_cols
                                        for ms in (1, 2)]
                for wl in workloads:
                    kw = dict(rank=rank, profile_gate=gate, workload=wl)
                    want = ref_cache.query_fingerprint(ref_q, q_cols, init_mode, **kw)
                    assert cache.query_fingerprint(port_q, q_cols, init_mode, **kw) == want
                    assert len(want) == 16


def _lru(P):
    c = P.QueryResultCache(2)
    c.put(b"a", 5, 0, [], P.DiscoveryStats())
    c.put(b"b", 5, 0, [], P.DiscoveryStats())
    seen = [c.get(b"a", 5, 0) is not None]
    c.put(b"c", 5, 0, [], P.DiscoveryStats())
    seen += [c.get(b"b", 5, 0) is None, c.get(b"a", 5, 0) is not None, c.get(b"a", 3, 0) is None]
    return seen, dataclasses.astuple(c.stats), c.stats.hit_rate, len(c)


def test_result_cache_lru_eviction_and_stats():
    want = _lru(REF)
    assert _lru(PORT) == want
    assert all(want[0]) and want[1][3] == 1 and want[2] == pytest.approx(0.5)


def _stale(P):
    c = P.QueryResultCache(4)
    c.put(b"x", 5, 7, [], P.DiscoveryStats())
    return (c.get(b"x", 5, 7) is not None, c.get(b"x", 5, 8) is None,
            dataclasses.astuple(c.stats), len(c))


def test_caches_drop_stale_epoch_entries():
    want = _stale(REF)
    assert _stale(PORT) == want
    assert want[:2] == (True, True) and want[2][2] == 1 and want[3] == 0


@pytest.mark.parametrize("cls,cap", [("QueryResultCache", 0), ("BoundCache", -1)])
def test_cache_capacity_validation(cls, cap):
    with pytest.raises(ValueError) as want:
        getattr(REF, cls)(cap)
    with pytest.raises(ValueError) as got:
        getattr(PORT, cls)(cap)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Caches: engine integration + §5.4 invalidation
# ---------------------------------------------------------------------------

def _cache_hit(P, queries, built, bits):
    index_ = _fresh(P, bits)
    clk = P.ManualClock()
    eng, sess = _engine(P, index_, clk.now, window=4, flush_after=None,
                        result_cache=8, bound_cache=8)
    q, qc = queries[0]
    cold_req = eng.discover(q, qc)
    hit_req = eng.discover(q, qc)
    return (hit_req.from_cache, _counters(sess), _fut(cold_req), _fut(hit_req),
            _key(hit_req.results) == _cold(P, index_, q, qc),
            hit_req.stats.filter_checks == cold_req.stats.filter_checks)


@pytest.mark.parametrize("bits", VALID_BITS)
def test_result_cache_hit_bit_identical_all_widths(lakes, bits):
    from_cache, counters, cold, hit, exact, same_checks = _both(lakes, _cache_hit, bits=bits)
    assert from_cache and counters[3] == 1 and cold == hit and exact and same_checks


def _mutation(P, queries, built, mutation):
    index_ = _fresh(P, 128)
    clk = P.ManualClock()
    eng, sess = _engine(P, index_, clk.now, window=4, flush_after=None,
                        result_cache=8, bound_cache=8)
    q, qc = queries[0]
    first = eng.discover(q, qc)
    warm = eng.discover(q, qc).from_cache
    top = first.results[0].table_id if first.results else 0
    if mutation == "insert":
        sess.insert_table([[r[c] for c in qc] for r in q.cells])
    elif mutation == "update":
        sess.update_cell(top, 0, 0, "mutated-value-xyz")
    else:
        sess.delete_table(top)
    after = eng.discover(q, qc)
    return (warm, after.from_cache, _fut(first), _fut(after),
            _key(after.results) == _cold(P, index_, q, qc),
            all(e.table_id != top for e in after.results), _counters(sess))


@pytest.mark.parametrize("mutation", ["insert", "update", "delete"])
def test_mutation_invalidates_cached_results(lakes, mutation):
    warm, after_hit, _, _, exact, top_gone, _ = _both(lakes, _mutation, mutation=mutation)
    assert warm and not after_hit and exact
    if mutation == "delete":
        assert top_gone


def _bound_any_k(P, queries, built):
    index_ = _fresh(P, 128)
    clk = P.ManualClock()
    eng, sess = _engine(P, index_, clk.now, window=4, flush_after=None, bound_cache=8)
    q, qc = queries[0]
    eng.discover(q, qc, k=5)
    st = sess.stats
    cold = (st.filter_checks, st.filter_fused_launches, st.filter_matrix_bytes)
    warm = eng.discover(q, qc, k=3)
    return (_counters(sess), st.filter_fused_launches == cold[1],
            st.filter_matrix_bytes == cold[2],
            st.filter_checks == cold[0] + warm.stats.filter_checks,
            _fut(warm), _key(warm.results) == _cold(P, index_, q, qc, k=3))


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_bound_cache_serves_any_k_and_skips_filter(lakes, backend):
    counters, no_launch, no_matrix, checks, _, exact = _both(lakes, _bound_any_k, backend)
    assert counters[4] == 1 and no_launch and no_matrix and checks and exact


def _degraded_gated(P, queries, built):
    clk = P.ManualClock()
    eng, sess = _engine(P, built[512], clk.now, window=8, max_queue=1,
                        pressure_policy="degrade", degrade_bits=128,
                        result_cache=8, bound_cache=8)
    normal = eng.submit(*queries[0])
    degraded = eng.submit(*queries[1])
    eng.flush()
    epoch = built[512].mutation_epoch
    hygiene = (eng.bound_cache.get(normal.fingerprint, epoch) is not None,
               eng.bound_cache.get(degraded.fingerprint, epoch) is None)
    hit = eng.submit(*queries[1])
    cold = sorted(_cold(P, built[512], *queries[1]))
    return (degraded.degraded, normal.degraded, degraded.stats.filter_lanes,
            sorted(_key(degraded.results)) == cold, hygiene, hit.from_cache,
            sorted(_key(hit.results)) == cold, hit in eng.queue, _counters(sess),
            _fut(normal), _fut(degraded), _fut(hit))


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_degraded_gated_request_exact_and_never_poisons_bound_cache(lakes, backend):
    got = _both(lakes, _degraded_gated, backend)
    assert got[:8] == (True, False, 4, True, (True, True), True, True, False)
    assert got[8][3] == 1


def _fd_fingerprint(P, queries, built):
    q, qc = queries[0]
    cfg = P.DiscoveryConfig()
    kw = dict(rank=cfg.rank, profile_gate=cfg.profile_gate)
    join_fp = P.query_fingerprint(q, qc, cfg.init_mode, **kw)
    fds = [P.query_fingerprint(q, qc, cfg.init_mode, workload=w, **kw)
           for w in ("join", "fd:2:1", "fd:3:1")]
    clk = P.ManualClock()
    eng, _ = _engine(P, built[128], clk.now, window=4, flush_after=None,
                     result_cache=8, bound_cache=8)
    cold = eng.discover(q, qc)
    hot = eng.discover(q, qc).from_cache
    epoch = built[128].mutation_epoch
    return (join_fp, fds, hot, eng.result_cache.get(cold.fingerprint, cold.k, epoch) is not None,
            eng.result_cache.get(fds[1], cold.k, epoch), eng.bound_cache.get(fds[1], epoch))


def test_fd_workload_fingerprint_never_hits_join_caches(lakes):
    join_fp, (explicit_join, fd21, fd31), hot, join_cached, fd_result, fd_bound = _both(
        lakes, _fd_fingerprint
    )
    assert join_fp == explicit_join and fd21 not in (join_fp, fd31)
    assert hot and join_cached and fd_result is None and fd_bound is None


# ---------------------------------------------------------------------------
# Random submit/mutate interleavings: every served answer equals a cold
# discover on the index as it stands, identically in both packages
# ---------------------------------------------------------------------------

def _interleaving(P, bits, ops):
    corpus_ = P.synthetic.make_corpus(
        P.synthetic.SyntheticSpec(n_tables=24, rows_per_table=(4, 10), seed=3)
    )
    queries = P.synthetic.make_mixed_queries(corpus_, 4, 6, 2, seed=11)
    index_ = P.build(corpus_, bits)
    clk = P.ManualClock()
    sess = P.MateSession(index_, _config(P, k=4, window=3, flush_after=None,
                                         result_cache=4, bound_cache=4))
    eng = P.DiscoveryEngine(session=sess, clock=clk.now)
    live = list(range(len(corpus_.tables)))
    pending, trace = [], []
    for op, arg in ops:
        if op == "submit":
            q, qc = queries[arg % len(queries)]
            req = eng.submit(q, qc, k=4)
            if req.done:
                trace.append(("hit", _fut(req), _key(req.results) == _cold(P, index_, q, qc, k=4)))
            else:
                pending.append((req, q, qc))
        elif op == "flush":
            eng.flush()
            trace += [("served", _fut(r), _key(r.results) == _cold(P, index_, q, qc, k=4))
                      for r, q, qc in pending]
            pending.clear()
        elif op == "insert" and arg % 2 == 0:
            q, qc = queries[arg % len(queries)]
            live.append(sess.insert_table([[r[c] for c in qc] for r in q.cells]))
        elif op == "insert":
            live.append(sess.insert_table([["zz", str(arg)], ["yy", "ww"]]))
        elif op == "update" and live:
            sess.update_cell(live[arg % len(live)], 0, 0, f"v{arg}")
        elif op == "delete" and live:
            sess.delete_table(live.pop(arg % len(live)))
    eng.flush()
    trace += [("served", _fut(r), _key(r.results) == _cold(P, index_, q, qc, k=4))
              for r, q, qc in pending]
    return trace, _counters(sess), index_.mutation_epoch


def _schedule(seed: int, n_ops: int = 14) -> list[tuple[str, int]]:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.45:
            ops.append(("submit", int(rng.integers(0, 8))))
        elif roll < 0.65:
            ops.append(("flush", 0))
        elif roll < 0.77:
            ops.append(("insert", int(rng.integers(0, 8))))
        elif roll < 0.89:
            ops.append(("update", int(rng.integers(0, 8))))
        else:
            ops.append(("delete", int(rng.integers(0, 8))))
    ops.append(("flush", 0))
    return ops


def _check_interleaving(bits, ops, backend=None):
    want = _interleaving(REF, bits, ops)
    assert _interleaving(_port(backend), bits, ops) == want
    trace = want[0]
    assert trace and all(exact for _, _, exact in trace), trace


@pytest.mark.parametrize("bits", VALID_BITS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleaving_property_seeded(bits, seed):
    _check_interleaving(bits, _schedule(seed * 31 + bits))


@pytest.mark.parametrize("seed", range(6))
def test_interleaving_property_random_schedules(seed):
    """The reference's hypothesis property (arbitrary schedules of 2–12
    operations at 128 bits) as seeded cases, each opening with a submit so
    that it serves something, the port under 'fused-gather'."""
    rng = np.random.default_rng(1000 + seed)
    kinds = ("submit", "flush", "insert", "update", "delete")
    ops = [("submit", int(rng.integers(0, 8)))]
    ops += [(str(kinds[int(rng.integers(5))]), int(rng.integers(0, 8)))
            for _ in range(int(rng.integers(1, 12)))]
    _check_interleaving(128, [(op, 0 if op == "flush" else arg) for op, arg in ops]
                        + [("flush", 0)], backend="fused-gather")


def _bound_cache_k(P, k1, k2, qi):
    corpus_ = P.synthetic.make_corpus(
        P.synthetic.SyntheticSpec(n_tables=24, rows_per_table=(4, 10), seed=3)
    )
    queries = P.synthetic.make_mixed_queries(corpus_, 4, 6, 2, seed=11)
    index_ = P.build(corpus_, 128)
    clk = P.ManualClock()
    sess = P.MateSession(index_, _config(P, k=4, window=2, flush_after=None, bound_cache=4))
    eng = P.DiscoveryEngine(session=sess, clock=clk.now)
    q, qc = queries[qi]
    eng.discover(q, qc, k=k1)
    warm = eng.discover(q, qc, k=k2)
    return _counters(sess), _fut(warm), _key(warm.results) == _cold(P, index_, q, qc, k=k2)


@pytest.mark.parametrize("k1,k2,qi", [(1, 6, 0), (6, 1, 1), (3, 3, 2), (2, 5, 3), (5, 2, 0), (4, 4, 1)])
def test_bound_cache_any_k(k1, k2, qi):
    """The reference's hypothesis property (a bound-cache replay at any k
    equals the cold discover at that k) as seeded cases."""
    want = _bound_cache_k(REF, k1, k2, qi)
    assert _bound_cache_k(PORT, k1, k2, qi) == want
    assert want[0][4] == 1 and want[2]
