"""Lane-prefix filtering (``filter_lanes``) at any prefix, against the
reference.

The engines clamp ``filter_lanes`` to [1, lanes] and probe only the first
``filter_lanes`` uint32 lanes of every super key: a relaxation with no
false negatives, so the verified top-k is unchanged.  Under the CUDA
default backend ('fused-gather') that is kernel B.2 reading a lane prefix
of the full-width device store — word by word when the prefix is not a
multiple of 4 lanes.  Here, on CPU tensors, the wrapper runs its plain
version; the kernel itself is held against that plain version on the card
by ``chip_smoke.py``'s ``lanes`` line.

For 1, 2, 3 and 5 lanes (5 on a 256-bit index), and 7 and 13 of 512 bits:
``plan_and_count``'s per-table counts and its launch accounting
(``filter_lanes``, ``gather_saved``, fused) and ``discover_many``'s top-k
and every stats counter equal the reference's under the same backend name
(its 'fused-gather' and 'fused' kernels run in interpret mode here).
"""

import dataclasses

import numpy as np
import pytest

from conftest import ground_truth_lake
from repro.core import batched as ref_batched
from repro.core import session as ref_session
from repro.data import synthetic as ref_synthetic
from repro_torch.core import batched, corpus as port_corpus, session

CASES = [(128, 1), (128, 2), (128, 3), (256, 1), (256, 2), (256, 3), (256, 5), (512, 7), (512, 13)]
# port backend -> the reference backend it is compared with
PAIRS = {"fused-gather": "fused-gather", "fused": "fused", "numpy": "numpy"}
QUALITY_ATOL = 1e-6  # float32 quality scores, same op order as the reference


def _pt(q):
    return port_corpus.Table(q.table_id, [list(r) for r in q.cells], q.name)


@pytest.fixture(scope="module")
def lake():
    corpus, query, q_cols, _ = ground_truth_lake(n_tables=80)
    queries = [(query, q_cols)] + ref_synthetic.make_mixed_queries(corpus, 3, 15, seed=11)
    pc = port_corpus.Corpus(
        [port_corpus.Table(t.table_id, [list(r) for r in t.cells], t.name) for t in corpus.tables],
        max_len=corpus.max_len,
    )
    indexes = {}
    for bits in sorted({b for b, _ in CASES}):
        ref = ref_session.MateSession.build(corpus, ref_session.DiscoveryConfig(bits=bits, backend="numpy"))
        port = session.MateSession.build(pc, session.DiscoveryConfig(bits=bits), device="cpu")
        indexes[bits] = (ref.index, port.index)
    return queries, indexes


def _pc_view(pc):
    return (np.asarray(pc.counts).tolist(), pc.filter_lanes, pc.fused, pc.gather_saved,
            pc.group_keys, pc.epoch)


@pytest.mark.parametrize("bits,lanes", CASES)
@pytest.mark.parametrize("backend", list(PAIRS))
def test_plan_and_count_at_a_lane_prefix_matches_reference(lake, bits, lanes, backend):
    queries, indexes = lake
    ref_idx, port_idx = indexes[bits]
    want = ref_batched.plan_and_count(ref_idx, queries, PAIRS[backend], filter_lanes=lanes,
                                      profile_gate=True)
    got = batched.plan_and_count(port_idx, [(_pt(q), c) for q, c in queries], backend,
                                 filter_lanes=lanes, profile_gate=True)
    assert [_pc_view(p) for p in got] == [_pc_view(p) for p in want]
    assert all(p.filter_lanes == lanes for p in got)
    # a prefix passes at least what the full width passes, per table
    full = batched.plan_and_count(port_idx, [(_pt(q), c) for q, c in queries], backend,
                                  profile_gate=True)
    for p, f in zip(got, full):
        assert (np.asarray(p.counts) >= np.asarray(f.counts)).all()


@pytest.mark.parametrize("bits,lanes", CASES)
@pytest.mark.parametrize("backend", list(PAIRS))
def test_discover_many_at_a_lane_prefix_matches_reference(lake, bits, lanes, backend):
    queries, indexes = lake
    ref_idx, port_idx = indexes[bits]
    kw = dict(k=5, filter_lanes=lanes, rank="quality", profile_gate=True)
    want = ref_batched.discover_many(ref_idx, queries, backend=PAIRS[backend], **kw)
    got = batched.discover_many(port_idx, [(_pt(q), c) for q, c in queries], backend=backend, **kw)
    full = batched.discover_many(port_idx, [(_pt(q), c) for q, c in queries], backend=backend,
                                 k=5, rank="quality", profile_gate=True)
    for (ge, gs), (we, ws), (fe, _) in zip(got, want, full):
        assert [(e.table_id, e.joinability, e.mapping) for e in ge] == [
            (e.table_id, e.joinability, e.mapping) for e in we
        ]
        np.testing.assert_allclose([e.quality for e in ge], [e.quality for e in we],
                                   rtol=0, atol=QUALITY_ATOL)
        # the verified set is the full width's (the order may differ: the
        # quality score reads the looser prefix counts)
        assert sorted((e.table_id, e.joinability) for e in ge) == sorted(
            (e.table_id, e.joinability) for e in fe
        )
        assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
