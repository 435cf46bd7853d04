"""The sharded offline build: ``repro_torch.core.index.build_index(n_shards=k)``
against the reference's single-host and sharded builds.

Every artifact ``index_artifacts_equal`` / ``profiles_equal`` compare must
be byte-identical at every shard count and width, together with the
candidate-CSR offsets the online engine derives from them, the build's
shard accounting, and the downstream top-k.  The host-sharded cases of
``tests/test_sharded_build.py`` run on both packages; its hypothesis
properties are seeded corpora here (duplicate values, empty strings and
columns, ragged widths, zero-row tables).  The group-sharded build
(``mesh=``) is held in ``test_torch_routed_mesh.py``.
"""

import numpy as np
import pytest

from conftest import ALL_BITS
from repro.core import corpus as ref_corpus
from repro.core import discovery as ref_discovery
from repro.core import index as ref_index
from repro.core import profiles as ref_profiles
from repro.core import session as ref_session
from repro.core import xash as ref_xash
from repro.data import synthetic as ref_synthetic
from repro.launch import mesh as ref_meshlib
from repro_torch.core import corpus as port_corpus
from repro_torch.core import discovery, index, session, xash
from repro_torch.launch.mesh import Mesh

SHARD_COUNTS = (1, 2, 4, 8)
HOST_SHARDS = (1, 2, 3, 5, 8)
STAT_FIELDS = ("n_shards", "mesh_shape", "values_total", "rows_total", "bytes_hashed",
               "shard_values", "shard_rows", "profile_bytes", "sharded")
# the reference's hypothesis pool: heavy duplication, the empty string
# (hashes to zero lanes), multi-char values
_POOL = ["", "a", "aa", "b", "zz9", "same", "same", "x y", "0", "long value 42"]


def _pt(t):
    return port_corpus.Table(t.table_id, [list(r) for r in t.cells], t.name)


def _port_corpus(c):
    return port_corpus.Corpus([_pt(t) for t in c.tables], max_len=c.max_len)


def _key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


@pytest.fixture(scope="module")
def lake():
    corpus = ref_synthetic.make_corpus(ref_synthetic.SyntheticSpec(n_tables=60, seed=1))
    query, q_cols, _expected, corpus = ref_synthetic.make_query_with_ground_truth(corpus)
    return corpus, _port_corpus(corpus), query, q_cols


@pytest.fixture(scope="module")
def single_host(lake):
    corpus = lake[0]
    return {
        bits: ref_index.build_index(
            corpus, cfg=ref_xash.XashConfig(bits=bits), use_corpus_char_freq=True
        )[0]
        for bits in ALL_BITS
    }


def assert_indexes_byte_identical(got, ref):
    """Every offline artifact byte-identical (both packages' definition),
    the config, the profile store and the candidate-CSR offsets."""
    assert got.cfg.bits == ref.cfg.bits and got.cfg.char_freq == ref.cfg.char_freq
    assert index.index_artifacts_equal(got, ref)
    assert ref_index.index_artifacts_equal(ref, got)
    assert ref_profiles.profiles_equal(got.profiles(), ref.profiles())
    values = [ref.corpus.unique_values[i] for i in sorted(ref.postings)][:24]
    blk_got, blk_ref = got.gather_candidates(values), ref.gather_candidates(values)
    for name in ("table_ptr", "table_ids", "rows", "value_idx"):
        assert np.array_equal(getattr(blk_got, name), getattr(blk_ref, name)), name


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_build_matrix_byte_identical(lake, single_host, n_shards, bits):
    corpus, pc, _q, _qc = lake
    port, stats = index.build_index(
        pc, cfg=xash.XashConfig(bits=bits), use_corpus_char_freq=True,
        n_shards=n_shards, device="cpu",
    )
    assert_indexes_byte_identical(port, single_host[bits])
    ref, ref_stats = ref_index.build_index(
        corpus, cfg=ref_xash.XashConfig(bits=bits), use_corpus_char_freq=True,
        n_shards=n_shards,
    )
    assert_indexes_byte_identical(port, ref)
    for name in STAT_FIELDS:
        assert getattr(stats, name) == getattr(ref_stats, name), name
    assert len(stats.shard_hash_seconds) == n_shards
    assert stats.sharded == (n_shards > 1) and stats.mesh_shape is None


@pytest.mark.parametrize("n_shards", HOST_SHARDS)
def test_host_sharded_build_byte_identical(lake, single_host, n_shards):
    _c, pc, _q, _qc = lake
    port, stats = index.build_index(
        pc, cfg=xash.XashConfig(bits=128), use_corpus_char_freq=True,
        n_shards=n_shards, device="cpu",
    )
    assert_indexes_byte_identical(port, single_host[128])
    assert stats.n_shards == n_shards and stats.mesh_shape is None
    assert sum(stats.shard_values) == stats.values_total
    assert sum(stats.shard_rows) == stats.rows_total


def test_merge_matches_single_host_csr(lake):
    """``merge_shard_postings`` over uneven contiguous row shards (one of
    them empty) == the reference's one-shard CSR, payload and ptr."""
    corpus, pc, _q, _qc = lake
    n_values = len(corpus.unique_values)
    payload_ref, counts_ref = ref_index._shard_postings(
        corpus.cell_value_ids, 0, corpus.total_rows, n_values
    )
    bounds = [0, 7, 7, 100, corpus.total_rows]
    parts = [
        index._shard_postings(pc.cell_value_ids, lo, hi, n_values)
        for lo, hi in zip(bounds, bounds[1:])
    ]
    for (p, c), lo, hi in zip(parts, bounds, bounds[1:]):
        rp, rc = ref_index._shard_postings(corpus.cell_value_ids, lo, hi, n_values)
        assert np.array_equal(p, rp) and np.array_equal(c, rc)
    payload, ptr = index.merge_shard_postings([p for p, _ in parts], [c for _, c in parts], n_values)
    assert np.array_equal(ptr, ref_index._csr_ptr(counts_ref))
    assert np.array_equal(payload, payload_ref)
    ref_payload, ref_ptr = ref_index.merge_shard_postings(
        [p for p, _ in parts], [c for _, c in parts], n_values
    )
    assert np.array_equal(payload, ref_payload) and np.array_equal(ptr, ref_ptr)
    assert index.merge_shard_postings([], [], 3)[1].tolist() == [0, 0, 0, 0]


def test_mesh_n_shards_conflict_raises_like_the_reference(lake):
    corpus, pc, _q, _qc = lake
    with pytest.raises(ValueError, match="n_shards") as want:
        ref_index.build_index(corpus, mesh=ref_meshlib.make_mesh((1,), ("data",)), n_shards=3)
    one_rank = Mesh(rank=0, size=1, backend="gloo", device=None)
    with pytest.raises(ValueError) as got:
        index.build_index(pc, mesh=one_rank, n_shards=3, device="cpu")
    assert str(got.value) == str(want.value)


def test_one_rank_mesh_is_the_single_host_pass(lake, single_host):
    """A group of one rank hashes on this host (no collective) and records
    no mesh shape, as the reference's one-device mesh does."""
    _c, pc, _q, _qc = lake
    one_rank = Mesh(rank=0, size=1, backend="gloo", device=None)
    port, stats = index.build_index(
        pc, cfg=xash.XashConfig(bits=128), use_corpus_char_freq=True, mesh=one_rank,
        device="cpu",
    )
    assert_indexes_byte_identical(port, single_host[128])
    assert stats.n_shards == 1 and stats.mesh_shape is None and not stats.sharded


def test_sharded_build_baseline_hash(lake):
    """Non-xash hashes (host-side Python) shard over the same bounds and
    merge identically."""
    corpus, pc, _q, _qc = lake
    ref = ref_index.MateIndex(corpus, cfg=ref_xash.XashConfig(bits=128), hash_name="murmur")
    port, stats = index.build_index(
        pc, cfg=xash.XashConfig(bits=128), hash_name="murmur", n_shards=3, device="cpu"
    )
    assert np.array_equal(port.value_lanes, ref.value_lanes)
    assert np.array_equal(port.superkeys, ref.superkeys)
    assert index.index_artifacts_equal(port, ref)
    assert len(stats.shard_hash_seconds) == 3


@pytest.mark.parametrize("bits", ALL_BITS)
def test_sharded_session_discovery_identical(lake, single_host, bits):
    """Downstream top-k: a session built with ``n_shards=4`` answers
    ``discover`` and ``discover_many`` as the reference does."""
    corpus, pc, query, q_cols = lake
    s = session.MateSession.build(
        pc, session.DiscoveryConfig(bits=bits, backend="fused-gather"), n_shards=4, device="cpu"
    )
    assert s.build_stats.sharded and s.build_stats.n_shards == 4
    ref = ref_session.MateSession(single_host[bits], ref_session.DiscoveryConfig(backend="numpy"))
    got, _ = s.discover(_pt(query), q_cols, k=10)
    want, _ = ref.discover(query, q_cols, k=10)
    assert _key(got) == _key(want)
    queries = [(query, q_cols)] + ref_synthetic.make_mixed_queries(corpus, 2, 10, 2, seed=11)
    out = s.discover_many([(_pt(q), qc) for q, qc in queries], k=[10, 4, 4])
    out_ref = ref.discover_many(queries, k=[10, 4, 4])
    assert [_key(e) for e, _ in out] == [_key(e) for e, _ in out_ref]


def _assert_same_index_state(idx, rebuilt):
    assert np.array_equal(idx.superkeys, rebuilt.superkeys)
    for value in rebuilt.corpus.value_of:
        got = sorted(map(tuple, idx.fetch_postings(value).tolist()))
        want = sorted(map(tuple, rebuilt.fetch_postings(value).tolist()))
        assert got == want, value


def test_mutations_on_sharded_built_index():
    """insert_table / update_cell on a sharded-built index behave exactly as
    on a from-scratch rebuild and as on the reference's sharded-built index
    (fresh corpora: §5.4 updates mutate them in place)."""
    def fresh():
        corpus = ref_synthetic.make_corpus(ref_synthetic.SyntheticSpec(n_tables=60, seed=1))
        query, q_cols, _e, corpus = ref_synthetic.make_query_with_ground_truth(corpus)
        return corpus, query, q_cols

    corpus, query, q_cols = fresh()
    ref_corpus = fresh()[0]
    port, _ = index.build_index(
        _port_corpus(corpus), cfg=xash.XashConfig(bits=128), use_corpus_char_freq=True,
        n_shards=4, device="cpu",
    )
    ref, _ = ref_index.build_index(
        ref_corpus, cfg=ref_xash.XashConfig(bits=128), use_corpus_char_freq=True, n_shards=4
    )
    key_cells = [[query.cells[r][c] for c in q_cols] for r in range(query.n_rows)]
    new_cells = [kc + ["sharded-extra"] for kc in key_cells]
    tid = port.insert_table([list(r) for r in new_cells])
    assert tid == ref.insert_table([list(r) for r in new_cells])
    port.update_cell(tid, 0, len(new_cells[0]) - 1, "mutated")
    ref.update_cell(tid, 0, len(new_cells[0]) - 1, "mutated")
    assert index.index_artifacts_equal(port, ref)
    mutated = [list(r) for r in new_cells]
    mutated[0][-1] = "mutated"
    rebuilt = index.MateIndex(
        port_corpus.Corpus([*port.corpus.tables[:-1], port_corpus.Table(tid, mutated)]),
        cfg=port.cfg, device="cpu",
    )
    _assert_same_index_state(port, rebuilt)
    seq, _ = discovery.discover(port, _pt(query), q_cols, k=8)
    got, _ = session.MateSession(port, session.DiscoveryConfig()).discover(_pt(query), q_cols, k=8)
    want, _ = ref_discovery.discover(ref, query, q_cols, k=8)
    assert _key(got) == _key(seq) == _key(want)
    assert tid in [e.table_id for e in got]


def _seeded_cells(seed: int, max_tables: int = 4):
    """A corpus of the reference's hypothesis strategy, drawn from ``seed``:
    1–4 tables of 1–3 columns and 0–6 rows over ``_POOL``."""
    rng = np.random.default_rng(seed)
    tables = []
    for _ in range(int(rng.integers(1, max_tables + 1))):
        n_cols, n_rows = int(rng.integers(1, 4)), int(rng.integers(0, 7))
        tables.append([[_POOL[int(i)] for i in rng.integers(len(_POOL), size=n_cols)]
                       for _ in range(n_rows)])
    return tables


def _both_corpora(tables_cells):
    ref = ref_corpus.Corpus([ref_corpus.Table(i, [list(r) for r in c]) for i, c in enumerate(tables_cells)])
    port = port_corpus.Corpus([port_corpus.Table(i, [list(r) for r in c]) for i, c in enumerate(tables_cells)])
    return ref, port


@pytest.mark.parametrize("seed", range(16))
def test_seeded_shard_merge_matches_single_host(seed):
    """Seeded corpora: shard-merge == the reference's single-host hash and
    postings at a shard count drawn from 1–6."""
    tables_cells = _seeded_cells(seed)
    n_shards = int(np.random.default_rng(seed + 1000).integers(1, 7))
    ref_c, port_c = _both_corpora(tables_cells)
    cfg = ref_xash.XashConfig(bits=128)
    ref = ref_index.MateIndex(ref_c, cfg=cfg)
    port, _ = index.build_index(port_c, cfg=xash.XashConfig(bits=128), n_shards=n_shards, device="cpu")
    want = ref_index._hash_unique_values(
        ref_c.unique_values, ref_c.unique_enc, ref.cfg, "xash", ref_c.avg_row_width()
    )
    assert np.array_equal(port.value_lanes, want)
    assert index.index_artifacts_equal(port, ref)


@pytest.mark.parametrize("seed", range(8))
def test_seeded_add_rows_then_rebuild_consistency(seed):
    """§5.4 on sharded-built indexes: adding a table and comparing with a
    from-scratch rebuild holds for seeded corpora too."""
    rng = np.random.default_rng(seed + 2000)
    tables_cells = _seeded_cells(seed)
    extra = [[_POOL[int(i)] for i in rng.integers(len(_POOL), size=2)]
             for _ in range(int(rng.integers(1, 5)))]
    _, port_c = _both_corpora(tables_cells)
    port, _ = index.build_index(port_c, cfg=xash.XashConfig(bits=128), n_shards=3, device="cpu")
    tid = port.insert_table([list(r) for r in extra])
    rebuilt = index.MateIndex(
        port_corpus.Corpus([*port_c.tables[:-1], port_corpus.Table(tid, extra)]),
        cfg=port.cfg, device="cpu",
    )
    _assert_same_index_state(port, rebuilt)


def test_candidate_block_table_slice_matches_reference(lake, single_host):
    corpus, pc, _q, _qc = lake
    ref = single_host[128]
    port = index.build_index(pc, cfg=xash.XashConfig(bits=128), use_corpus_char_freq=True,
                             device="cpu")[0]
    values = [corpus.unique_values[i] for i in sorted(ref.postings)][:40]
    blk, blk_ref = port.gather_candidates(values), ref.gather_candidates(values)
    assert blk.n_tables == blk_ref.n_tables > 1
    for t in range(blk.n_tables):
        assert blk.table_slice(t) == blk_ref.table_slice(t)
        assert np.array_equal(blk.rows[blk.table_slice(t)], blk_ref.rows[blk_ref.table_slice(t)])
