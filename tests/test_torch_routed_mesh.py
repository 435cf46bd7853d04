"""The routed lake's mesh mode over ``torch.distributed`` (gloo, on the CPU).

Each world size (2 and 4 ranks) is spawned ONCE for the module
(``repro_torch.launch.mesh.run_ranks``, with a deadline of its own, so a hung
rank fails its tests instead of running the suite into its limit).  Every
rank runs the whole matrix (``torch_mesh_worker.routed_matrix``) and hands
plain results back; each case below is a test of its own over them.

The reference's mesh matrices need 8 forced XLA host devices and skip in
tier 1, so the port's mesh mode is held against the reference's host-routed
and single-host results, which the reference's own contract makes
bit-identical: top-k and per-table counts at 128/256/512 bits under
'fused-gather', 'fused', 'pallas' and 'numpy'; the group-built routed index,
sharded build and session; ``make_distributed_filter`` under 'broadcast',
'blocked' and 'fused' (kernel B.1 'any', its plain version here; past the
table cap kernel B.4's); ``xash_values_mesh``; and the errors, word for
word.
"""

import types

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from conftest import ALL_BITS
from repro.core import batched as ref_batched
from repro.core import distributed as ref_distributed
from repro.core import index as ref_index
from repro.core import routing as ref_routing
from repro.core import session as ref_session
from repro.core import xash as ref_xash
from repro.data import synthetic as ref_synthetic
from repro_torch.core import batched, routing, xash
from repro_torch.core import corpus as port_corpus
from repro_torch.launch import mesh as meshlib

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 240.0
K_MANY = [10, 4, 4]


def _pt(t):
    return port_corpus.Table(t.table_id, [list(r) for r in t.cells], t.name)


def _key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


def _lists(keys):
    """Top-k keys as the ranks return them (mappings as tuples)."""
    return [[(t, j, tuple(m) if m is not None else None) for t, j, m in ks] for ks in keys]


@pytest.fixture(scope="module")
def lake():
    corpus = ref_synthetic.make_corpus(ref_synthetic.SyntheticSpec(n_tables=60, seed=1))
    query, q_cols, _expected, corpus = ref_synthetic.make_query_with_ground_truth(corpus)
    queries = [(query, q_cols)] + ref_synthetic.make_mixed_queries(corpus, 2, 10, 2, seed=11)
    pc = port_corpus.Corpus([_pt(t) for t in corpus.tables], max_len=corpus.max_len)
    return corpus, pc, queries


@pytest.fixture(scope="module")
def ranks(lake):
    """{world size: [rank results]} — one spawn per world size."""
    _corpus, pc, queries = lake
    port_queries = [(_pt(q), qc) for q, qc in queries]
    return {
        world: meshlib.run_ranks(
            worker.routed_matrix, world, backend="gloo", devices=["cpu"] * world,
            args=(pc, port_queries, ALL_BITS, K_MANY), timeout_s=SPAWN_TIMEOUT_S,
        )
        for world in WORLDS
    }


@pytest.fixture(scope="module")
def want(lake):
    """The reference's single-host and host-routed answers per width."""
    corpus, _pc, queries = lake
    query, q_cols = queries[0]
    out = {}
    for bits in ALL_BITS:
        single = ref_index.MateIndex(corpus, cfg=ref_xash.XashConfig(bits=bits), use_corpus_char_freq=True)
        topk, _ = ref_batched.discover_batched(single, query, q_cols, k=10, backend="numpy")
        many = ref_batched.discover_many(single, queries, k=K_MANY, backend="numpy")
        out[bits] = {"single": single, "topk": _key(topk), "many": [_key(e) for e, _ in many]}
        # the session surface: rank='quality' and the profile gate on
        ses = ref_session.MateSession(single, ref_session.DiscoveryConfig(backend="numpy"))
        out[bits]["session_topk"] = _key(ses.discover(query, q_cols, k=10)[0])
        out[bits]["session_many"] = [_key(e) for e, _ in ses.discover_many(queries, k=K_MANY)]
        for world in WORLDS:
            routed = ref_routing.ShardedMateIndex(
                corpus, cfg=ref_xash.XashConfig(bits=bits), use_corpus_char_freq=True, n_shards=world
            )
            got, st = ref_batched.discover_batched(routed, query, q_cols, k=10, backend="numpy")
            pcs = ref_batched.plan_and_count(routed, queries, "numpy")
            out[bits][world] = {
                "topk": _key(got), "stats": st,
                "counts": [pc.counts.tolist() for pc in pcs],
                "route": [(pc.route_launches, pc.route_bytes) for pc in pcs],
            }
    return out


def test_every_rank_reports_and_agrees(ranks):
    for world, results in ranks.items():
        assert [r["rank"] for r in results] == list(range(world))
        assert all(r["world"] == world and r["backend"] == "gloo" for r in results)
        for r in results[1:]:
            assert r["widths"] == results[0]["widths"]
            assert r["filter"] == results[0]["filter"]


@pytest.mark.parametrize("backend", worker.MESH_BACKENDS)
@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_routed_matrix_equals_host_routed(ranks, want, world, bits, backend):
    """Top-k, group top-k and per-table counts equal the reference's
    host-routed and single-host results; the routed accounting is the
    reference's mesh accounting (one launch per rank, each rank's counts
    vector merged)."""
    got = ranks[world][0]["widths"][bits][backend]
    ref = want[bits]
    assert got["topk"] == _lists([ref["topk"]])[0] == _lists([ref[world]["topk"]])[0]
    assert got["many"] == _lists(ref["many"])
    assert got["counts"] == ref[world]["counts"]
    st = got["stats"]
    plan_tables = st["tables_fetched"] - st["tables_gated"]
    assert st["shard_launches"] == world
    assert st["route_bytes_merged"] == world * plan_tables * 4
    assert st["filter_fused_launches"] == world and st["shard_gather_demotions"] == 0
    ref_st = ref[world]["stats"]
    for name in ("filter_passed", "verified_tp", "verified_fp", "tables_fetched", "tables_gated"):
        assert st[name] == getattr(ref_st, name), name
    assert [rl for rl, _ in got["route"]] == [rl for rl, _ in ref[world]["route"]]


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("world", WORLDS)
def test_detached_mesh_routes_on_the_host_again(ranks, want, lake, world, bits):
    got = ranks[world][0]["widths"][bits]["detached"]
    assert got["topk"] == _lists([want[bits]["topk"]])[0]
    ref_st = want[bits][world]["stats"]
    assert got["stats"]["shard_launches"] == ref_st.shard_launches
    assert got["stats"]["route_bytes_merged"] == ref_st.route_bytes_merged


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_built_routed_index(ranks, want, lake, world, bits):
    """``build_routed_index(mesh=)``: the arena hashed across the ranks is
    the single-host arena, the mesh stays attached, discovery identical."""
    corpus = lake[0]
    got = ranks[world][0]["widths"][bits]["mesh_built"]
    assert got["attached"] and got["sharded"] and got["n_shards"] == world
    assert got["mesh_shape"] == {"data": world}
    assert got["value_lanes"] == worker.digest(want[bits]["single"].value_lanes)
    assert got["shard_rows"] == [int(b) for b in np.diff(
        ref_routing.table_aligned_bounds(corpus.row_base, world))]
    assert got["hash_launches"] >= 1
    assert got["topk"] == _lists([want[bits]["topk"]])[0]
    assert got["stats"]["shard_launches"] == world


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_sharded_build_byte_identical(ranks, want, lake, world, bits):
    """``build_index(mesh=)``: artifacts byte-identical to the reference's
    single-host build, with the reference's shard accounting."""
    corpus = lake[0]
    single = want[bits]["single"]
    got = ranks[world][0]["widths"][bits]["sharded_build"]
    assert got["value_lanes"] == worker.digest(single.value_lanes)
    assert got["superkeys"] == worker.digest(single.superkeys)
    assert got["postings"] == worker.digest(
        np.concatenate([single.postings[v] for v in sorted(single.postings)]))
    assert got["n_shards"] == world and got["mesh_shape"] == {"data": world}
    assert got["shard_rows"] == np.diff(ref_distributed.shard_bounds(corpus.total_rows, world)).tolist()
    assert got["shard_values"] == np.diff(
        ref_distributed.shard_bounds(len(corpus.unique_values), world)).tolist()


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_built_session(ranks, want, world):
    got = ranks[world][0]["session"]
    assert got["routed"] and got["n_shards"] == world
    assert got["topk"] == _lists([want[256]["session_topk"]])[0]
    assert got["many"] == _lists(want[256]["session_many"])
    assert got["shard_launches"] > 0 and got["route_bytes_merged"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_xash_values_mesh_bit_identical(ranks, lake, world):
    corpus = lake[0]
    got = ranks[world][0]
    for bits in ALL_BITS:
        cfg = ref_xash.XashConfig(bits=bits)
        single = ref_index._hash_unique_values(
            corpus.unique_values, corpus.unique_enc, cfg, "xash", corpus.avg_row_width())
        assert got["xash_values_mesh"][bits] == worker.digest(single)
    n = len(corpus.unique_values)
    assert got["xash_values_mesh_launches"] == len(ALL_BITS) * -(-n // (7 * world))
    assert tuple(got["xash_values_mesh_empty"]) == (0, 4)


@pytest.mark.parametrize("impl", worker.FILTER_IMPLS + ("fused_over_cap",))
@pytest.mark.parametrize("world", WORLDS)
def test_make_distributed_filter_matches_reference(ranks, lake, world, impl):
    """The all-reduced per-shard counts equal the reference's
    ``filter_counts_local`` over the whole (unsharded) rows."""
    corpus, _pc, queries = lake
    query, q_cols = queries[0]
    single = ref_index.MateIndex(corpus, cfg=ref_xash.XashConfig(bits=128))
    keys = list(dict.fromkeys(tuple(r[c] for c in q_cols) for r in query.cells))
    row_tables = np.asarray(corpus.table_of_row(np.arange(corpus.total_rows)), dtype=np.int32)
    tc, kc = ref_distributed.filter_counts_local(
        single.superkeys, row_tables, single.superkey_of_keys(keys), len(corpus.tables))
    got = ranks[world][0]["filter"][impl]
    assert got == (np.asarray(tc).tolist(), np.asarray(kc).tolist())
    assert ranks[world][0]["block_rows"] == -(-corpus.total_rows // world)


def test_shard_impl_for_maps_backends_like_the_reference(ranks):
    for world in WORLDS:
        got = ranks[world][0]
        names = ("fused-gather", "fused", "pallas", "numpy", "blocked")
        stats = types.SimpleNamespace(shard_gather_demotions=0)
        assert got["shard_impl"][:5] == [ref_distributed.shard_impl_for(b, stats) for b in names]
        assert got["shard_impl"][5] == "broadcast"  # None on the CPU: 'auto'
        assert got["shard_impl_demotions"] == stats.shard_gather_demotions == 1


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_errors_match_the_reference(ranks, lake, world):
    """A group whose size differs from the index's shards, and an n_shards
    that conflicts with the group, raise the reference's messages."""
    corpus = lake[0]
    mesh = types.SimpleNamespace(shape={"data": world}, axis_names=("data",))
    wrong = ref_routing.ShardedMateIndex(corpus, cfg=ref_xash.XashConfig(bits=128), n_shards=world + 1)
    want = {}
    for name, fn in (
        ("attach", lambda: wrong.attach_mesh(mesh)),
        ("build_routed", lambda: ref_routing.build_routed_index(corpus, mesh=mesh, n_shards=world + 1)),
        ("build_index", lambda: ref_index.build_index(corpus, mesh=mesh, n_shards=world + 1)),
    ):
        with pytest.raises(ValueError) as err:
            fn()
        want[name] = str(err.value)
    assert ranks[world][0]["errors"] == want


def test_host_routed_port_matches_the_ranks(ranks, lake):
    """The port's own host-routed index in this process gives the counts
    every rank all-reduced."""
    _corpus, pc, queries = lake
    port_queries = [(_pt(q), qc) for q, qc in queries]
    for world in WORLDS:
        idx = routing.ShardedMateIndex(pc, cfg=xash.XashConfig(bits=512), use_corpus_char_freq=True,
                                       n_shards=world, device="cpu")
        pcs = batched.plan_and_count(idx, port_queries, "fused-gather")
        assert ranks[world][0]["widths"][512]["fused-gather"]["counts"] == [
            pc_.counts.tolist() for pc_ in pcs]


def test_a_hung_rank_fails_by_its_deadline():
    """A rank that never reports fails the call at its deadline, and every
    rank is stopped."""
    with pytest.raises(TimeoutError, match="did not report"):
        meshlib.run_ranks(worker.hang, 2, devices=["cpu"] * 2, timeout_s=8.0)


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        meshlib.run_ranks(worker.fail_on_rank_one, 2, devices=["cpu"] * 2, timeout_s=60.0)


def test_prestarted_ranks_take_the_call():
    """``prestart``'s processes run the next call of the same world size,
    backend and devices (a call of another world size starts its own); a
    set no call took stops on ``release_prestarted``."""
    try:
        meshlib.prestart(2, devices=["cpu"] * 2)
        meshlib.prestart(3, devices=["cpu"] * 3)
        (two,), (three,) = (meshlib._PRESTARTED[meshlib._call_key(n, "gloo", ["cpu"] * n, None)] for n in (2, 3))
        waiting = [p.pid for p in two[0]]
        got = meshlib.run_ranks(worker.pid, 2, devices=["cpu"] * 2, timeout_s=60.0)
        assert [r for r, _ in got] == [0, 1] and [p for _, p in got] == waiting
        again = meshlib.run_ranks(worker.pid, 2, devices=["cpu"] * 2, timeout_s=60.0)
        assert not set(p for _, p in again) & set(waiting)  # the set ran one call: new processes now
        left = three[0]
    finally:
        meshlib.release_prestarted()
    assert not meshlib._PRESTARTED and all(not p.is_alive() and p.exitcode == 0 for p in left)


def test_ranks_default_to_the_cards_round_robin(monkeypatch):
    """Without ``devices`` every rank runs on a card (rank r on card
    r mod cards), never on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert meshlib.rank_devices(6) == ["cuda:0", "cuda:1", "cuda:2", "cuda:3", "cuda:0", "cuda:1"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert meshlib.rank_devices(2) == ["cuda:0", "cuda:0"]


def test_ranks_without_a_card_raise_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        meshlib.run_ranks(worker.fail_on_rank_one, 2, timeout_s=60.0)
