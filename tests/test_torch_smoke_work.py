"""The yardsticks of ``chip_smoke.py``: the bytes and FLOPs its bounds are
computed from, held against brute-force counts at small shapes.

``flash_work`` (B.6) counts the admissible (query, key) pairs of a causal,
windowed or ragged call and the bytes of q, k, v and out; ``gather_bytes``
(B.2) counts the distinct 32-byte store sectors the candidate rows' probed
lanes touch.  Importing ``chip_smoke`` needs no GPU.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py"
)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("s,t,window,causal", [
    (64, 64, 0, True),
    (100, 37, 0, True),  # ragged, S > T
    (37, 100, 0, True),  # S < T
    (128, 128, 16, True),  # sliding window
    (50, 70, 9, False),  # non-causal window
    (7, 3, 5, True),  # rows past T with no admissible key in the window
    (1000, 1000, 0, True),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_work_matches_brute_force(s, t, window, causal, dtype):
    b, h, d, dv = 2, 3, 32, 16
    diff = np.arange(s)[:, None] - np.arange(t)[None, :]
    ok = np.ones((s, t), dtype=bool)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    tensors = [torch.empty(b, n, h, e, dtype=dtype) for n, e in ((s, d), (t, d), (t, dv), (s, dv))]
    want = (sum(x.numel() * x.element_size() for x in tensors),
            b * h * int(ok.sum()) * 2 * (d + dv))
    got = chip_smoke.flash_work(b, s, t, h, d, dv, window, tensors[0].element_size(), causal)
    assert got == want


@pytest.mark.parametrize("s,t,window,causal", [
    (64, 64, 0, True),
    (100, 37, 0, True),
    (37, 100, 0, True),
    (128, 128, 16, True),
    (50, 70, 9, False),
    (7, 3, 5, True),
    (2048, 2048, 0, True),  # the training shape's mask
    (256, 1500, 0, False),  # whisper's cross-attention
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_work_matches_brute_force(s, t, window, causal, dtype):
    """The backward's yardstick: q, k, v and dout read, dq, dk and dv
    written; 2·(3·d + 2·dv) FLOPs per admissible pair — the five products
    of ``flash_attention_backward`` counted over the pairs it needs."""
    b, h, d, dv = 2, 3, 32, 16
    diff = np.arange(s)[:, None] - np.arange(t)[None, :]
    ok = np.ones((s, t), dtype=bool)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    pairs = b * h * int(ok.sum())
    # the backward's products per admissible (query, key) pair: Q·Kᵀ
    # (d MACs), Pᵀ·dO (dv), dO·Vᵀ (dv), dS·K (d), dSᵀ·Q (d)
    macs = pairs * (d + dv + dv + d + d)
    reads = [torch.empty(b, n, h, e, dtype=dtype) for n, e in ((s, d), (t, d), (t, dv), (s, dv))]
    writes = [torch.empty(b, n, h, e, dtype=dtype) for n, e in ((s, d), (t, d), (t, dv))]
    want = (sum(x.numel() * x.element_size() for x in reads + writes), 2 * macs)
    got = chip_smoke.flash_bwd_work(b, s, t, h, d, dv, window, reads[0].element_size(), causal)
    assert got == want


@pytest.mark.parametrize("store_stride,lanes,n_store", [
    (4, 4, 64),  # 16-byte rows: neighbours share a sector
    (16, 16, 64),  # 64-byte rows: two sectors each
    (16, 4, 64),  # lane prefix of a 512-bit store
    (8, 8, 33),
    (4, 4, 5),  # every row picked many times
])
@pytest.mark.parametrize("has_elig", [True, False])
def test_gather_bytes_match_brute_force(store_stride, lanes, n_store, has_elig):
    rng = np.random.default_rng(store_stride * 100 + lanes + n_store)
    n, q, n_tables = 200, 30, 17
    rows = rng.integers(0, n_store, size=n)
    sectors = set()
    for r in rows:
        start = int(r) * store_stride * 4
        sectors.update(range(start // 32, (start + lanes * 4 - 1) // 32 + 1))
    want = n * 4 + 32 * len(sectors) + (n * q if has_elig else 0) + n * 4 + q * lanes * 4 + n_tables * 4
    got = chip_smoke.gather_bytes(torch.from_numpy(rows.astype(np.int32)), store_stride, lanes,
                                  q, n_tables, has_elig)
    assert got == want


def test_gather_bytes_of_no_rows():
    assert chip_smoke.gather_bytes(torch.zeros(0, dtype=torch.int32), 4, 4, 3, 5, True) == 3 * 16 + 20


def _seg_and_elig(rng, n, q, kind):
    seg = rng.integers(-1, 5, size=n).astype(np.int32)  # -1: padding rows
    elig = None if kind is None else rng.random((n, q)) < 0.3
    return seg, elig


@pytest.mark.parametrize("n,lanes,n_queries,q", [
    (50, 4, 30, 30),
    (64, 16, 200, 256),  # phantom columns past n_queries
    (33, 8, 300, 300),  # two query tiles
    (1, 4, 1, 7),
])
@pytest.mark.parametrize("kind", ["random", None])
def test_counts_work_matches_brute_force(n, lanes, n_queries, q, kind):
    rng = np.random.default_rng(n * 1000 + q)
    n_tables = 17
    seg, elig = _seg_and_elig(rng, n, q, kind)
    pairs = sum(1 for i in range(n) for j in range(n_queries)
                if seg[i] >= 0 and (elig is None or elig[i, j]))
    tensors = [torch.empty(n, lanes, dtype=torch.int32), torch.empty(n, dtype=torch.int32),
               torch.empty(n_queries, lanes, dtype=torch.int32),  # inputs: rows, seg, real queries
               torch.empty(n_tables, dtype=torch.int32), torch.empty(q, dtype=torch.int32)]  # outputs
    if elig is not None:
        tensors.append(torch.empty(n, n_queries, dtype=torch.int8))  # the real queries' elig
    want = (sum(x.numel() * x.element_size() for x in tensors), pairs)
    got = chip_smoke.counts_work(n, lanes, n_queries, q, n_tables,
                                 None if elig is None else torch.from_numpy(elig),
                                 torch.from_numpy(seg))
    assert got == want


def _xash_work_brute(enc: np.ndarray, lanes: int, n_char_bits: int) -> tuple[int, int]:
    n_chars = picks = 0
    for cell in enc.reshape(-1, enc.shape[-1]):
        chars = [int(x) for x in cell if 1 <= x <= 37]
        n_chars += len(chars)
        present = len(set(chars))
        picks += present * min(present, n_char_bits)
    return enc.size + enc.shape[0] * lanes * 4, enc.size + 2 * n_chars + picks


@pytest.mark.parametrize("bits,max_len", [(128, 48), (256, 20), (512, 80)])
def test_xash_work_matches_brute_force(bits, max_len):
    from repro_torch.core import xash

    rng = np.random.default_rng(bits)
    uniq = rng.integers(0, 38, size=(40, 48)).astype(np.uint8)
    uniq[::3, 20:] = 0
    enc = chip_smoke.xash_edge_inputs(rng, uniq, 90, max_len)
    cfg = xash.XashConfig(bits=bits)
    want = _xash_work_brute(enc, cfg.lanes, cfg.n_char_bits)
    assert chip_smoke.xash_work(torch.from_numpy(enc), cfg) == want


@pytest.mark.parametrize("max_len", [48, 20, 80])
def test_xash_edge_inputs_hold_their_edges(max_len):
    rng = np.random.default_rng(max_len)
    uniq = rng.integers(1, 38, size=(40, 48)).astype(np.uint8)
    enc = chip_smoke.xash_edge_inputs(rng, uniq, 1001, max_len)
    assert enc.shape == (1001, 3, max_len) and enc.dtype == np.uint8
    cells = enc.reshape(-1, max_len)
    repeated = {int(c[0]) for c in cells if c[0] and (c == c[0]).all()}
    assert len(repeated) >= 30  # one character over the full width (a few cells are emptied after)
    full = [c for c in cells if len(set(c[c > 0].tolist())) == min(37, max_len)]
    assert full  # all 37 characters (or as many as the width holds)
    assert (enc > 37).any()  # codes above the alphabet
    cells_empty = (enc == 0).all(axis=2)
    assert (cells_empty[:, 1] & ~cells_empty[:, 0] & ~cells_empty[:, 2]).any()  # empty middle cells
    assert cells_empty.all(axis=1).any()  # empty rows


@pytest.mark.parametrize("n,lanes,q", [(1, 4, 1), (31, 8, 7), (257, 16, 300), (1027, 4, 256)])
def test_match_and_count_work_match_brute_force(n, lanes, q):
    """B.4 and B.5 read every row and query once and test every pair; B.4
    writes the int8 matrix, B.5 the int32 counts."""
    rows, queries = torch.empty(n, lanes, dtype=torch.int32), torch.empty(q, lanes, dtype=torch.int32)
    read = sum(x.numel() * x.element_size() for x in (rows, queries))
    pairs = sum(1 for _ in range(n) for _ in range(q))
    matrix, counts = torch.empty(n, q, dtype=torch.int8), torch.empty(q, dtype=torch.int32)
    assert chip_smoke.match_work(n, lanes, q) == (read + matrix.numel() * matrix.element_size(), pairs)
    assert chip_smoke.count_work(n, lanes, q) == (read + counts.numel() * counts.element_size(), pairs)


@pytest.mark.parametrize("n,lanes,q", [(1, 4, 1), (200, 8, 3), (1000, 16, 30)])
def test_edge_rows_and_queries_hold_their_edges(n, lanes, q):
    rng = np.random.default_rng(n + q)
    rows = chip_smoke.edge_rows(rng, torch.device("cpu"), n, lanes)
    qs = chip_smoke.edge_queries(rng, rows, q)
    assert rows.shape == (n, lanes) and qs.shape == (q, lanes)
    assert rows.dtype == qs.dtype == torch.int32 and qs.is_contiguous()
    i = np.arange(n)
    assert bool((rows[torch.from_numpy(i % 97 == 5)] == -1).all())
    assert bool((rows[torch.from_numpy(i % 89 == 3)] == 0).all())
    if q >= 3:
        assert bool((qs[q // 2] == 0).all()) and bool((qs[-1] == -1).all())
    # every other query is a bit subset of some row
    others = [j for j in range(q) if q < 3 or j not in (q // 2, q - 1)]
    sub = ((qs[others, None] & ~rows[None]) == 0).all(dim=-1).any(dim=1)
    assert bool(sub.all())


# ---------------------------------------------------------------------------
# The FD and serving-tier phases' yardsticks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_planted_fd_lake_is_test_fds_construction(seed):
    """The smoke carries its own copy of ``tests/test_fd.py``'s planted lake
    (the smoke may not import the tests): cell for cell the same."""
    from test_fd import planted_fd_lake

    ref_corpus, ref_query, ref_det, ref_dep = planted_fd_lake(seed)
    corpus, query, det, dep = chip_smoke.planted_fd_lake(seed)
    assert (query.cells, query.name, det, dep) == (ref_query.cells, ref_query.name, ref_det, ref_dep)
    assert [(t.table_id, t.cells, t.name) for t in corpus.tables] == [
        (t.table_id, t.cells, t.name) for t in ref_corpus.tables
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_support", [1, 2])
def test_fd_oracle_matches_the_tests_oracle(seed, min_support):
    """The smoke's oracle scans only the rows holding a determinant value;
    its facts equal ``tests/test_fd.py``'s full scan."""
    from test_fd import fd_oracle_python, planted_fd_lake

    corpus, query, det, dep = planted_fd_lake(seed)
    got = chip_smoke.fd_oracle(corpus, query, det, dep, min_support)
    assert {t: v[:3] for t, v in got.items()} == fd_oracle_python(corpus, query, det, dep, min_support)


@pytest.mark.parametrize("key,row,want", [
    (("a", "b"), ["b", "a"], True),
    (("a", "a"), ["a", "x"], False),  # distinct columns
    (("a", "a"), ["a", "a"], True),
    (("a",), [], False),
    (("a", "b", "c"), ["c", "a", "b", "a"], True),
    (("", "x"), ["x", ""], True),
])
def test_row_matches_is_an_injective_mapping(key, row, want):
    assert chip_smoke._row_matches(key, row) is want


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_serving_stream_shape(seed):
    """A spike of ground-truth queries alone at the default k, past twice
    max_queue; then every query, every third request at k = 5."""
    bursts = chip_smoke.serving_stream(seed, 4, 12)
    assert [len(b) for b in bursts] == list(chip_smoke.SERVING_BURSTS)
    assert sum(map(len, bursts)) == chip_smoke.SERVING_REQUESTS == 64
    spike = bursts[0]
    assert len(spike) > 2 * chip_smoke.SERVING_MAX_QUEUE
    assert all(qi < 4 and k is None for qi, k in spike)
    rest = [r for b in bursts[1:] for r in b]
    assert [k for _, k in rest] == [5 if i % 3 == 2 else None for i in range(len(rest))]
    assert all(0 <= qi < 12 for qi, _ in rest)
    assert any(b and len(b) % chip_smoke.SERVING_WINDOW for b in bursts[1:])  # partial groups
    assert chip_smoke.serving_stream(seed, 4, 12) == bursts  # seeded


def test_flash_tc_smem_fits_a_block():
    """B.6's bf16 block: two Q buffers of 128 rows, a ring of 64-key K/V
    stages (4, 3 at d 192 / dv 128) and two mbarriers per Q buffer and per
    stage; every instantiation under the 227 KB a block may use."""
    bars = lambda stages: (4 + 2 * stages) * 8  # noqa: E731
    assert chip_smoke.flash_tc_smem(192, 128) == 1024 + 2 * 48 * 1024 + 3 * (24 + 16) * 1024 + bars(3)
    assert chip_smoke.flash_tc_smem(192, 64) == 1024 + 2 * 48 * 1024 + 4 * (24 + 8) * 1024 + bars(4)
    assert chip_smoke.flash_tc_smem(128, 64) == 1024 + 2 * 32 * 1024 + 4 * (16 + 8) * 1024 + bars(4)
    assert chip_smoke.flash_tc_smem(64, 64) == 1024 + 2 * 16 * 1024 + 4 * (8 + 8) * 1024 + bars(4)
    assert chip_smoke.flash_tc_smem(64, 128) == 1024 + 2 * 16 * 1024 + 4 * (8 + 16) * 1024 + bars(4)
    assert max(chip_smoke.flash_tc_smem(dp, dvp) for dp in (64, 128, 192) for dvp in (64, 128)) <= 232448


def test_kernel_ablations_variants_apply(monkeypatch):
    """``tools/kernel_ablations.py`` makes its variants by text substitution
    at import, and one that no longer applies to the checked-in source
    raises there; each variant must also change its source."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # the tool puts the repo's root and src first
    spec = importlib.util.spec_from_file_location(
        "kernel_ablations", Path(__file__).resolve().parents[1] / "tools" / "kernel_ablations.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for lib, variants in tool.VARIANTS.items():
        for name, text in variants.items():
            assert name == "as built" or text != variants["as built"], (lib, name)


def test_ptxas_entries_picks_the_named_kernels():
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_tc_kernelILi192ELi128EEEvT' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115flash_tc_kernelILi192ELi128EEEvT
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_tc_kernelILi64ELi64EEEvT' for 'sm_90a'
ptxas info    : Used 127 registers, 576 bytes cmem[0]
"""
    got = chip_smoke.ptxas_entries(log, "flash_tc_kernelILi192E")
    assert list(got) == ["_ZN12_GLOBAL__N_115flash_tc_kernelILi192ELi128EEEvT"]
    assert got["_ZN12_GLOBAL__N_115flash_tc_kernelILi192ELi128EEEvT"] == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 576 bytes cmem[0]",
    ]


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_mixed_spike_shape(seed):
    """Mixed queries alone at the default k: max_queue admitted, one window
    past it degraded, none shed; seeded."""
    spike = chip_smoke.mixed_spike(seed, 4, 12)
    assert len(spike) == chip_smoke.MIXED_SPIKE
    assert chip_smoke.SERVING_MAX_QUEUE < len(spike) <= 2 * chip_smoke.SERVING_MAX_QUEUE
    assert (len(spike) - chip_smoke.SERVING_MAX_QUEUE) % chip_smoke.SERVING_WINDOW == 0
    assert all(4 <= qi < 12 and k is None for qi, k in spike)
    assert chip_smoke.mixed_spike(seed, 4, 12) == spike


def test_path_window_counts_only_inside():
    """Launches made between windows are not counted; each window's are
    added; check_counts names a kernel of the path that never launched."""
    wrappers = chip_smoke.counters()
    saved = {name: fn.launches for name, fn in wrappers.items()}
    try:
        total = __import__("collections").Counter()
        wrappers["gather_filter_table_counts"].launches += 5  # before any window
        with chip_smoke.path_window(total):
            wrappers["gather_filter_table_counts"].launches += 2
        wrappers["filter_match"].launches += 7  # a reference between windows
        with chip_smoke.path_window(total):
            wrappers["gather_filter_table_counts"].launches += 3
            wrappers["xash_superkey"].launches += 1
        got = chip_smoke.check_counts(total, ("gather_filter_table_counts", "xash_superkey"), "test")
        assert got["gather_filter_table_counts"] == 5 and got["xash_superkey"] == 1
        assert got["filter_match"] == 0 and set(got) == set(wrappers)
        with pytest.raises(AssertionError, match="filter_match"):
            chip_smoke.check_counts(total, ("filter_match",), "test")
    finally:
        for name, fn in wrappers.items():
            fn.launches = saved[name]


def test_every_kernel_has_a_home_path():
    assert set(chip_smoke.HOME_PATH) == set(chip_smoke.counters())
    assert set(chip_smoke.HOME_PATH.values()) == {"main_path", "ops_path", "serve", "train"}


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("backend", ["fused-gather", "numpy"])
def test_route_accounting_matches_the_routed_stats(n_shards, backend):
    """``route_accounting`` over the calls ``record_routed_calls`` sees is
    what a host-routed ``discover`` counts: one launch per owning shard per
    batch, each shipping its batch's int32 counts vector."""
    from repro_torch.core import batched, routing
    from repro_torch.data import synthetic

    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=60, seed=3))
    query, q_cols, _e, corpus = synthetic.make_query_with_ground_truth(corpus, seed=4)
    idx = routing.ShardedMateIndex(corpus, n_shards=n_shards, device="cpu")
    with chip_smoke.record_routed_calls(idx) as calls:
        _, st = batched.discover_batched(idx, query, q_cols, k=20, batch_tables=8, backend=backend)
    assert len(calls) > 1 and "routed_counts" not in vars(idx)
    assert (st.shard_launches, st.route_bytes_merged) == chip_smoke.route_accounting(calls)
    assert st.route_bytes_merged == sum(sh * n * 4 for sh, n in calls)


@pytest.mark.parametrize("arch,depth,lo_hi,per_prefill", chip_smoke.FAMILIES)
def test_family_table_counts_attention_sublayers(arch, depth, lo_hi, per_prefill):
    """The families table's B.6 launches per prefill are the attention,
    cross-attention and MLA sublayers (and encoder layers) of the cut
    model, and the cut keeps the published widths."""
    import dataclasses

    from repro_torch import configs

    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth)
    assert chip_smoke.flash_per_prefill(cfg) == per_prefill
    assert (cfg.d_model, cfg.n_heads, cfg.vocab_size) == (full.d_model, full.n_heads, full.vocab_size)
    lo, hi = lo_hi
    assert lo < hi and hi % 64 == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lo,hi", [(512, 2048), (256, 1024), (64, 256)])
def test_family_prompts_fit_moe_grouping(seed, lo, hi):
    prompts = chip_smoke.family_prompts(np.random.default_rng(seed), 1000, lo, hi)
    lens = [len(p) for p in prompts]
    assert len(lens) == chip_smoke.FAMILY_REQUESTS and all(lo <= n <= hi for n in lens)
    assert max(lens) % 64 == 0 and (chip_smoke.FAMILY_REQUESTS * max(lens)) % 256 == 0
    assert all(2 <= t < 1000 for p in prompts for t in p)


@pytest.mark.parametrize("arch", [a for a, *_ in chip_smoke.FAMILIES])
def test_family_cut_keeps_the_first_layers(arch):
    """``family_cut`` at depth 1 and 2 on the reduced config: a model of
    that many layers whose stacks are views of the served ones."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.models.params import materialize

    cfg = configs.reduce_config(configs.get_config(arch))
    if cfg.layer_pattern == "jamba":  # the served model holds one block
        cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every)
    params = materialize(transformer.model_specs(cfg), seed=0, device="cpu")
    for depth in (1, 2):
        cut_cfg, cut = chip_smoke.family_cut(cfg, params, depth)
        for plan in transformer.group_plans(cut_cfg):
            for leaf in _leaves(cut[plan.name]):
                assert leaf.shape[0] == plan.n
        assert cut["embed"] is params["embed"]
        if cfg.encoder is not None:
            assert cut_cfg.encoder.n_layers == depth
        if cfg.moe is not None and cfg.moe.first_dense:
            assert [p.n for p in transformer.group_plans(cut_cfg)] == ([1] if depth == 1 else [1, 1])
        tokens = torch.zeros(2, 3, dtype=torch.long)
        out = transformer.TransformerLM(cut_cfg, cut)(tokens, **_stub(cut_cfg))
        assert out.shape == (2, 3, cfg.vocab_size) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("arch,n_layers", [("llama-3.2-vision-11b", 10), ("jamba-v0.1-52b", 8),
                                           ("deepseek-v3-671b", 3)])
def test_family_consistency_rows(arch, n_layers):
    """``family_consistency`` on the CPU at reduced widths: the 1- and
    2-layer cuts held; where the cut rebuilt the block, the first whole
    block printed beside its one-ulp witness and held in float32 (the VLM
    at two blocks: a block row, then the served depth; jamba's block is
    its served depth, whose float32 copy replaces the bf16 leaves in
    place); the uniform stacks without a block row or a float32 one."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.models.params import materialize

    cfg = dataclasses.replace(configs.reduce_config(configs.get_config(arch)), n_layers=n_layers)
    params = materialize(transformer.model_specs(cfg), seed=0, device="cpu")
    rows = chip_smoke.family_consistency(cfg, params, np.random.default_rng(0), torch.device("cpu"))
    kinds = {"llama-3.2-vision-11b": ["cut", "cut", "block", "served"],
             "jamba-v0.1-52b": ["cut", "cut", "served block"],
             "deepseek-v3-671b": ["cut", "cut", "served"]}[arch]
    assert [r["kind"] for r in rows] == kinds
    assert [r["layers"] for r in rows][:2] == [1, 2] and rows[-1]["layers"] == n_layers
    for r in rows:
        assert r["held"] == (r["kind"] == "cut")
        assert ("one_ulp" in r) != r["held"]
        assert ("float32" in r) == (r["kind"] in ("block", "served block"))
        if "float32" in r:
            assert r["float32"]["bound"] == chip_smoke.FAMILY_F32_BOUND and "one_ulp" in r["float32"]
            assert r["float32"]["prefill"] < 1e-3 and r["float32"]["decode"] < 1e-3
    assert ("absorbed_vs_naive" in rows[0]) == (cfg.mla is not None)
    dtypes = {leaf.dtype for leaf in _leaves(params)}
    assert dtypes == ({torch.float32} if arch == "jamba-v0.1-52b" else {torch.bfloat16})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _stub(cfg):
    from repro_torch.data.pipeline import stub_inputs

    return stub_inputs(cfg, 2, device="cpu")


def test_flash_mask_mutation_plants_one_change(tmp_path):
    """``tools/flash_mask_mutation.py`` copies the tree and removes only the
    bf16 edge mask's key bound from the copy; the checkout is untouched."""
    spec = importlib.util.spec_from_file_location(
        "flash_mask_mutation", Path(__file__).resolve().parents[1] / "tools" / "flash_mask_mutation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    sound = (tool.ROOT / tool.CU).read_text()
    copy = tool.planted_copy(tmp_path)
    planted = (copy / tool.CU).read_text()
    assert sound.count(tool.SOUND_MASK) == 1 and (tool.ROOT / tool.CU).read_text() == sound
    assert planted == sound.replace(tool.SOUND_MASK, tool.PLANTED_MASK)
    assert (copy / "chip_smoke.py").read_text() == (tool.ROOT / "chip_smoke.py").read_text()
    assert (copy / "tools" / "flash_mask_mutation.py").exists()
    assert not (copy / "build").exists()  # the copy builds its own kernels


@pytest.mark.parametrize("seed", [0, 3])
def test_planting_rebuilds_the_lake_once(seed):
    """The smoke plants its ground-truth queries with ``rebuild=False``
    and rebuilds the arenas after the last: the queries, their expected
    joinabilities, the arenas and the mixed queries drawn after are those
    of a rebuild after every planting."""
    from repro_torch.data import synthetic

    def draw(rebuild_each: bool):
        corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=300, seed=seed))
        planted = []
        for i in range(chip_smoke.N_TRUTH):
            last = i == chip_smoke.N_TRUTH - 1
            query, cols, expected, corpus = synthetic.make_query_with_ground_truth(
                corpus, n_rows=30, seed=seed + 1 + i, rebuild=rebuild_each or last)
            planted.append((query.cells, cols, expected))
        mixed = synthetic.make_mixed_queries(corpus, chip_smoke.GROUP, 20, seed=seed + 100)
        return corpus, planted, [q.cells for q, _ in mixed]

    (each, planted_each, mixed_each), (once, planted_once, mixed_once) = draw(True), draw(False)
    assert planted_once == planted_each and mixed_once == mixed_each
    assert once.unique_values == each.unique_values
    assert np.array_equal(once.cell_value_ids, each.cell_value_ids)
    assert np.array_equal(once.unique_enc, each.unique_enc)
