"""Index parity: the port's offline phase and §5.4 mutations against the
reference ``build_index``.

Every artifact ``index_artifacts_equal`` / ``profiles_equal`` compare — value
hash lanes (dtype included), per-row super keys, per-value posting lists and
the column profile store — must be byte-identical, before and after each
mutation.  The port hashes through its XASH kernel wrapper (the plain
version on CPU tensors), the reference through XLA.
"""

import numpy as np
import pytest
import torch

from conftest import ALL_BITS, ground_truth_lake
from repro.core import index as ref_index
from repro.core import profiles as ref_profiles
from repro.core import xash as ref_xash
from repro_torch.core import corpus as port_corpus
from repro_torch.core import index, xash


def _port_corpus(c):
    return port_corpus.Corpus(
        [port_corpus.Table(t.table_id, [list(r) for r in t.cells], t.name) for t in c.tables],
        max_len=c.max_len,
    )


def _assert_equal(ref, port):
    assert index.index_artifacts_equal(ref, port)
    assert ref_index.index_artifacts_equal(ref, port)
    assert ref_profiles.profiles_equal(ref.profiles(), port.profiles())
    assert port.mutation_epoch == ref.mutation_epoch


@pytest.fixture(scope="module")
def lake():
    corpus, query, q_cols, _expected = ground_truth_lake(n_tables=40)
    return corpus, query, q_cols


@pytest.mark.parametrize("bits", ALL_BITS)
def test_build_artifacts_and_stats_match(lake, bits):
    corpus, _q, _c = lake
    ref, ref_stats = ref_index.build_index(
        corpus, cfg=ref_xash.XashConfig(bits=bits), use_corpus_char_freq=True
    )
    port, stats = index.build_index(
        _port_corpus(corpus), cfg=xash.XashConfig(bits=bits), use_corpus_char_freq=True,
        device="cpu",
    )
    _assert_equal(ref, port)
    assert port.cfg.char_freq == ref.cfg.char_freq
    for name in ("n_shards", "mesh_shape", "values_total", "rows_total", "bytes_hashed",
                 "shard_values", "shard_rows", "profile_bytes"):
        assert getattr(stats, name) == getattr(ref_stats, name), name
    # the constructor path builds the same artifacts (profiles lazily)
    _assert_equal(ref, index.MateIndex(
        _port_corpus(corpus), cfg=xash.XashConfig(bits=bits), use_corpus_char_freq=True,
        device="cpu",
    ))


@pytest.mark.parametrize("bits", ALL_BITS)
def test_mutations_keep_artifacts_identical(lake, bits):
    corpus, query, q_cols = lake
    ref_corpus = ground_truth_lake(n_tables=40)[0]  # fresh: mutations are in place
    ref, _ = ref_index.build_index(ref_corpus, cfg=ref_xash.XashConfig(bits=bits))
    port, _ = index.build_index(
        _port_corpus(corpus), cfg=xash.XashConfig(bits=bits), device="cpu"
    )
    key_cells = [[query.cells[r][c] for c in q_cols] for r in range(query.n_rows)]
    new_cells = [kc + ["extra", f"wide{i}"] * 20 for i, kc in enumerate(key_cells)]
    assert port.insert_table([list(r) for r in new_cells], "t") == ref.insert_table(
        [list(r) for r in new_cells], "t"
    )
    _assert_equal(ref, port)
    for args in ((3, 0, 0, "a value never seen before"), (5, 1, 1, query.cells[0][0])):
        port.update_cell(*args)
        ref.update_cell(*args)
        _assert_equal(ref, port)
    port.delete_table(7)
    ref.delete_table(7)
    _assert_equal(ref, port)
    for v in (query.cells[0][0], "a value never seen before"):
        assert np.array_equal(port.fetch_postings(v), ref.fetch_postings(v))
    values = list(dict.fromkeys(query.column(q_cols[0])))
    a, b = port.gather_candidates(values), ref.gather_candidates(values)
    for f in ("rows", "value_idx", "table_ids", "table_ptr"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("hash_name", ("xash", "murmur", "bf", "ht"))
def test_query_side_hashing_matches(lake, hash_name):
    corpus, query, q_cols = lake
    bits = 256
    ref = ref_index.MateIndex(corpus, cfg=ref_xash.XashConfig(bits=bits), hash_name=hash_name)
    port = index.MateIndex(
        _port_corpus(corpus), cfg=xash.XashConfig(bits=bits), hash_name=hash_name,
        device="cpu",
    )
    keys = list(dict.fromkeys(tuple(r[c] for c in q_cols) for r in query.cells))
    assert np.array_equal(port.superkey_of_keys(keys), ref.superkey_of_keys(keys))
    assert np.array_equal(port.hash_values(["", "abc", "x y"]), ref.hash_values(["", "abc", "x y"]))
    with pytest.raises(ValueError, match="ragged"):
        port.superkey_of_keys([("a", "b"), ("c",)])


def test_index_from_arrays_roundtrips_reference(lake):
    corpus, _q, _c = lake
    ref, _ = ref_index.build_index(corpus, cfg=ref_xash.XashConfig(bits=512))
    payload = np.concatenate([ref.postings[v] for v in sorted(ref.postings)])
    counts = np.zeros(len(corpus.unique_values), dtype=np.int64)
    for v, pl in ref.postings.items():
        counts[v] = len(pl)
    ptr = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    port = index.index_from_arrays(
        _port_corpus(corpus), xash.XashConfig(bits=512), "xash",
        ref.value_lanes.copy(), ref.superkeys.copy(), payload, ptr, device="cpu",
    )
    _assert_equal(ref, port)


def test_device_store_refreshes_on_epoch_bump(lake):
    corpus, _q, _c = lake
    port = index.MateIndex(_port_corpus(corpus), device="cpu")
    s0 = port.device_store()
    assert s0 is port.device_store()  # cached within an epoch
    assert s0.dtype == torch.int32 and s0.device.type == "cpu"
    assert np.array_equal(xash.lanes_to_numpy(s0), port.superkeys)
    port.delete_table(0)
    s1 = port.device_store()
    assert s1 is not s0
    assert np.array_equal(xash.lanes_to_numpy(s1), port.superkeys)
    assert int(s1[: int(port.corpus.row_base[1])].abs().sum()) == 0
    port.update_cell(1, 0, 0, "mutated-value")
    s2 = port.device_store()
    assert s2 is not s1 and np.array_equal(xash.lanes_to_numpy(s2), port.superkeys)
    port.insert_table([["a", "b"], ["c", "d"]])
    s3 = port.device_store()
    assert s3.shape[0] == port.superkeys.shape[0] > s2.shape[0]


def test_cuda_is_the_default_device(lake, monkeypatch):
    """Without ``device=`` the index asks for CUDA, and raises without it."""
    corpus, _q, _c = lake
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index.MateIndex(_port_corpus(corpus))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index.build_index(_port_corpus(corpus))


def test_sharded_build_not_ported(lake):
    """The sharded build is ported (``tests/test_torch_sharded_build.py``
    holds its matrix): ``n_shards=2`` builds what the reference builds."""
    corpus, _q, _c = lake
    port, stats = index.build_index(_port_corpus(corpus), n_shards=2, device="cpu")
    ref, ref_stats = ref_index.build_index(corpus, n_shards=2)
    _assert_equal(ref, port)
    assert stats.sharded and stats.shard_rows == ref_stats.shard_rows
