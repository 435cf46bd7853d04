"""The enrichment operator: ``repro_torch.data.enrichment`` against
``repro.data.enrichment`` (the twin of
``tests/test_system.py::test_enrichment_operator``).

Both packages enrich the same base table from the same lake (the port's
synthetic generator is cell-identical to the reference's), each through a
bare ``MateIndex`` wrapped in a default session and through an explicit
session; the enriched cells, the provenance records and the tokens must be
equal.  ``tokenize_records`` uses Python's ``hash``, salted per process
(``PYTHONHASHSEED``) in both packages, so the tokens are compared within
this one process.
"""

import numpy as np
import pytest

from repro.core import corpus as ref_corpus
from repro.core import index as ref_index
from repro.core import session as ref_session
from repro.data import enrichment as ref_enrichment
from repro.data import synthetic as ref_synthetic
from repro_torch.core import corpus, index, session
from repro_torch.data import enrichment, synthetic
from repro_torch.kernels import registry


def _lake(corpus_m, synthetic_m):
    c = synthetic_m.make_corpus(synthetic_m.SyntheticSpec(n_tables=50, seed=4))
    base = corpus_m.Table(-1, [["k%da" % i, "k%db" % i, "payload"] for i in range(10)])
    # joinable rows with extra feature columns, in a table of their own
    feature_rows = [["k%da" % i, "k%db" % i, "feat%d" % i, "extra"] for i in range(8)]
    tid = len(c.tables)
    c.tables.append(corpus_m.Table(tid, feature_rows))
    return corpus_m.Corpus(c.tables), base, tid


@pytest.fixture(scope="module")
def lakes():
    return _lake(ref_corpus, ref_synthetic), _lake(corpus, synthetic)


@pytest.mark.parametrize("wrap", ["bare_index", "session"])
@pytest.mark.parametrize("k,max_new_cols", [(3, 8), (5, 2)])
def test_enrich_matches_reference(lakes, wrap, k, max_new_cols):
    (ref_c, ref_base, tid), (c, base, port_tid) = lakes
    assert tid == port_tid
    ref_idx = ref_index.MateIndex(ref_c)
    idx = index.MateIndex(c, device="cpu")
    if wrap == "session":
        ref_src, src = ref_session.MateSession(ref_idx), session.MateSession(idx)
    else:
        ref_src, src = ref_idx, idx
    want, want_prov = ref_enrichment.enrich(ref_src, ref_base, [0, 1], k=k,
                                            max_new_cols=max_new_cols)
    got, prov = enrichment.enrich(src, base, [0, 1], k=k, max_new_cols=max_new_cols)
    assert got.cells == want.cells
    assert (got.table_id, got.name) == (want.table_id, want.name)
    assert prov == want_prov
    # the reference test's own expectations, so equal-but-empty cannot pass
    assert got.n_cols > base.n_cols
    assert any(p["table_id"] == tid and p["hit_rows"] == 8 for p in prov)
    assert sum(p["new_cols"] for p in prov) <= max_new_cols

    toks = enrichment.tokenize_records(got, vocab_size=1000, seq_len=32)
    np.testing.assert_array_equal(
        toks, ref_enrichment.tokenize_records(want, vocab_size=1000, seq_len=32)
    )
    assert toks.shape == (10, 32) and toks.dtype == np.int32
    assert toks.max() < 1000 and (toks[:, 0] >= 1).all()


def test_bare_index_session_runs_on_the_index_device(lakes):
    """A bare index is wrapped in a session on its own device (the CPU
    here), with the backend the registry resolves there."""
    _, (c, base, _) = lakes
    idx = index.MateIndex(c, device="cpu")
    s = session.MateSession(idx)
    assert s.backend == registry.resolve_backend(None, "cpu")
    _, prov = enrichment.enrich(idx, base, [0, 1], k=3)
    assert prov
