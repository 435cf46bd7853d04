"""The dry mesh (``launch.mesh.dry_grid_mesh``): rank 0's collectives
counted on fake tensors equal those of the same program run for real.

For one train step, one prefill and one decode step of reduced
qwen1.5-0.5b (KV heads split over 'model'), qwen3-32b (one KV head: the
cache's slots split) and mamba2 (its SSM heads split, the conv exchanged
over 'model'), ``launch.dryrun``'s program at 2×2 (data, model) is traced
on the dry mesh under ``FakeTensorMode`` and run on 4 real gloo CPU ranks
(``torch_serve_worker.program_kinds``): rank 0's per-kind counts and
bytes are equal.  So they are under the module switches: qwen1.5-0.5b's
train step and prefill and mamba2's train step with ``seq_shard=True``
(the sequence's all-gathers and reduce-scatters; a train step's FSDP
backward is a reduce-scatter at every setting), and qwen1.5-0.5b's
train step under ``remat_policy`` 'dots' (each collective of a block run
again in its recompute, none saved) and 'none'.  So they are at batch 1,
which the data axis does not divide (every rank holds the row): a decode
step of h2o-danube and of jamba (their attention slots split over both
axes) and a prefill of qwen2-moe (its dispatch groups the row's own).  A real tensor given to a dry mesh
raises, and a fake tensor reaches no ``_build.load``: each kernel gives it
its shape rule and counts no launch.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_serve_worker as worker
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import distributed
from repro_torch.core.xash import XashConfig
from repro_torch.kernels import _build, filter_kernel, flash_kernel, xash_kernel
from repro_torch.launch import dryrun, hlo_cost, mesh as meshlib
from repro_torch.train import sharding

GRID = {"data": 2, "model": 2}
RUNS = [(arch, kind, 4, 32) for arch in ("qwen1.5-0.5b", "qwen3-32b", "mamba2-1.3b")
        for kind in ("train", "prefill", "decode")]
RUNS += [("qwen1.5-0.5b", "train", 4, 32, {"seq_shard": True}), ("qwen1.5-0.5b", "prefill", 4, 32, {"seq_shard": True}),
         ("mamba2-1.3b", "train", 4, 32, {"seq_shard": True}),
         ("qwen1.5-0.5b", "train", 4, 32, {"remat_policy": "dots"}),
         ("qwen1.5-0.5b", "train", 4, 32, {"remat_policy": "none"}),
         ("h2o-danube-3-4b", "decode", 1, 32), ("jamba-v0.1-52b", "decode", 1, 32),
         ("qwen2-moe-a2.7b", "prefill", 1, 32)]
IDS = [f"{r[0]}-{r[1]}" + "".join(f"-{k}={v}" for k, v in (r[4:] or [{}])[0].items()) for r in RUNS]


@pytest.fixture(scope="module")
def real_rank0():
    """Rank 0's kinds for every run, on 4 gloo CPU ranks (one spawn)."""
    return meshlib.run_ranks(worker.program_kinds, 4, devices=["cpu"] * 4, grid=GRID, args=(RUNS,),
                             timeout_s=240.0)[0]


@pytest.mark.parametrize("run", range(len(RUNS)), ids=IDS)
def test_dry_counts_equal_the_real_ranks(run, real_rank0):
    arch, kind, batch, seq, *sets = RUNS[run]
    cfg = configs.reduce_config(configs.get_config(arch))
    mesh = meshlib.dry_grid_mesh(GRID, device="cpu")
    variant = dryrun.Variant(**sets[0] if sets else {})
    hc = dryrun.trace_program(cfg, ShapeSpec(kind, seq, batch, kind), variant, mesh)["hlo_cost"]
    dry = {k: {"count": int(hc["collective_counts"][k]), "bytes": int(hc["collective_bytes"][k])}
           for k in hlo_cost.COLL_KINDS}
    assert dry == real_rank0[run], (arch, kind, sets, dry, real_rank0[run])
    assert dry["all-gather"]["count"] > 0
    # under sequence parallelism a prefill's region exits are reduce-scatters, its all-reduces none;
    # a train step's FSDP backward is a reduce-scatter too
    assert dry["all-reduce"]["count"] > 0 or (variant.seq_shard and kind == "prefill")
    assert (dry["reduce-scatter"]["count"] > 0) == (variant.seq_shard or kind == "train")


def test_a_real_tensor_on_a_dry_mesh_raises():
    grid = meshlib.dry_grid_mesh(GRID, device="cpu")
    with pytest.raises(ValueError, match="fake tensors only"):
        sharding.all_reduce(torch.ones(4), grid, "data")
    with pytest.raises(ValueError, match="fake tensors only"):
        sharding.all_gather(torch.ones(4), grid, "model", 0)
    with pytest.raises(ValueError, match="fake tensors only"):
        distributed.all_reduce_sum(torch.ones(4), meshlib.dry_mesh(8, device="cpu"))
    with pytest.raises(RuntimeError, match="runs no collective"):
        sharding._wire(torch.ones(4), grid)


def test_a_dry_mesh_joins_no_world():
    grid = meshlib.dry_production_mesh(multi_pod=True, rank=5, device="cpu")
    assert grid.size == 512 and grid.backend == "dry" and not torch.distributed.is_initialized()
    assert all(g is None for g, _ in grid.groups.values())
    assert grid.group_ranks("model") == list(range(0, 16)) and grid.coords == {"pod": 0, "data": 0, "model": 5}
    assert len(grid.group_ranks(("pod", "data"))) == 32


def test_a_fake_tensor_reaches_no_build(monkeypatch):
    def load(name):
        raise AssertionError(f"_build.load({name!r}) reached from a fake tensor")

    monkeypatch.setattr(_build, "load", load)
    wrappers = (flash_kernel.flash_attention, filter_kernel.filter_match, filter_kernel.filter_count,
                filter_kernel.filter_table_counts, filter_kernel.gather_filter_table_counts,
                xash_kernel.xash_superkey)
    before = [w.launches for w in wrappers]
    with FakeTensorMode():
        q = torch.empty(2, 64, 4, 16, requires_grad=True)
        out = flash_kernel.flash_attention(q, q, q, causal=True)
        out.sum().backward()
        assert out.shape == (2, 64, 4, 16) and q.grad.shape == q.shape
        sk, qs = torch.empty(100, 4, dtype=torch.int32), torch.empty(7, 4, dtype=torch.int32)
        seg = torch.empty(100, dtype=torch.int32)
        assert filter_kernel.filter_match(sk, qs).shape == (100, 7)
        assert filter_kernel.filter_count(sk, qs).shape == (7,)
        tc, kc = filter_kernel.filter_table_counts(sk, qs, None, seg, n_tables=10, mode="any")
        assert (tc.shape, kc.shape) == ((10,), (7,))
        assert filter_kernel.gather_filter_table_counts(seg, sk, qs, None, seg, n_tables=10).shape == (10,)
        enc = torch.empty(5, 3, 12, dtype=torch.uint8)
        assert xash_kernel.xash_superkey(enc, XashConfig(bits=128)).shape == (5, 4)
    cfg = configs.reduce_config(configs.get_config("qwen3-32b"))
    dryrun.trace_program(cfg, ShapeSpec("prefill", 16, 4, "prefill"), dryrun.Variant(),
                         meshlib.dry_grid_mesh(GRID, device="cpu"))
    assert [w.launches for w in wrappers] == before


SSM_SERVE_GRIDS = [("mamba2-1.3b", {"data": 2, "model": 2}), ("mamba2-1.3b", {"data": 1, "model": 2}),
                   ("jamba-v0.1-52b", {"data": 2, "model": 1})]


@pytest.mark.parametrize("arch,grid", SSM_SERVE_GRIDS)
def test_ssm_caches_are_their_shards_over_a_mesh(arch, grid):
    """The SSM and hybrid families serve over a model axis and over the
    data axis: each SSM cache leaf is its shard under ``cache_pspec_for``
    ('h' by heads, 'conv' by channels, both by rows)."""
    from repro_torch.models import layers, transformer

    cfg = configs.reduce_config(configs.get_config(arch))
    mesh = meshlib.dry_grid_mesh(grid, device="cpu")
    plan = transformer.group_plans(cfg)[0]
    layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
    try:
        with FakeTensorMode():
            cache = transformer.init_cache(cfg, 4, 16)
            for key in ("h", "conv", "pos"):
                spec = cache.specs[plan.name]["s0"][key]
                whole = transformer._layer_cache(cfg, "ssm", 4, 16, device="meta")[key].shape
                want = transformer._local_shape((plan.n, *whole), spec, mesh)
                assert tuple(cache[plan.name]["s0"][key].shape) == want, (key, spec)
    finally:
        layers.disable_activation_sharding()


@pytest.mark.parametrize("arch,grid", SSM_SERVE_GRIDS)
def test_serving_the_other_families_over_a_mesh_names_its_item(arch, grid):
    """The SSM and hybrid families over a mesh refuse no batch: at a batch
    of 3, which 2 data ranks do not divide, the cache is built with its
    batch dim whole on every rank, the hybrid's (MoE layers) as the pure
    SSM's (the shards themselves:
    ``test_ssm_caches_are_their_shards_over_a_mesh``)."""
    from repro_torch.models import layers, transformer

    cfg = configs.reduce_config(configs.get_config(arch))
    mesh = meshlib.dry_grid_mesh(grid, device="cpu")
    layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
    try:
        with FakeTensorMode():
            cache = transformer.init_cache(cfg, 3, 16)
            assert cache.batch == 3
            for key in ("h", "conv", "pos"):
                assert cache[transformer.group_plans(cfg)[0].name]["s0"][key].shape[1] == 3, key
                assert cache.specs[transformer.group_plans(cfg)[0].name]["s0"][key][1] is None, key
    finally:
        layers.disable_activation_sharding()
