"""The placement half of the mesh port against the reference, and the
port's process-group grid.

The reference's placement functions read only ``mesh.shape`` and
``mesh.axis_names``, so both packages are given the same device-free mesh
(a namespace) at the production grids (data 16, model 16) and (pod 2,
data 16, model 16) and at (2, 2), (1, 4) and (4, 1): every parameter leaf
of the ten archs' full-size ``model_specs`` under ``rules_for(fsdp=True)``
+ ``validate_divisibility`` (``param_shardings``), ``partition_specs``
under the default rules, and every leaf of every arch's cache under
``cache_pspec_for`` / ``cache_shardings`` (shapes from
``jax.eval_shape`` and the port's meta-device cache, at a decode batch of
32 and a long-context batch of 1) equal the reference's ``PartitionSpec``
as a tuple.  Then ``GridMesh`` on 4 gloo ranks (2 × 2): coordinates,
subgroups, slicing and gathering, FSDP's gather and reduce-scatter, and a
forward over the mesh against one process.
"""

import types

import jax
import numpy as np
import pytest
import torch

import torch_train_worker as worker
from repro import configs as ref_configs
from repro.launch import mesh as ref_mesh
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.launch import mesh as meshlib
from repro_torch.models import layers, params, transformer

ARCHS = sorted(ref_configs.ARCHS)
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2": {"data": 2, "model": 2},
    "1x4": {"data": 1, "model": 4},
    "4x1": {"data": 4, "model": 1},
}
CACHE_SHAPES = ((32, 4096), (1, 8192))  # (batch, max_seq): decode and long context


def _mesh(name):
    shape = MESHES[name]
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _specs(tree) -> list:
    """(path, PartitionSpec) pairs of a reference placement tree."""
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]


def _port_leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_archs_are_the_reference_set():
    assert sorted(configs.ARCHS) == ARCHS


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placement_matches_reference(arch, mesh):
    """``param_shardings``: the reference's ``validate_divisibility`` under
    ``rules_for(fsdp=True)`` (what its ``param_shardings`` wraps in
    ``NamedSharding``s), leaf for leaf."""
    m = _mesh(mesh)
    want = ref_params.validate_divisibility(
        ref_tf.model_specs(ref_configs.get_config(arch)), m, ref_mesh.rules_for(m))
    got = meshlib.param_shardings(transformer.model_specs(configs.get_config(arch)), m)
    flat = _specs(want)
    assert len(flat) == len(jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, params.NamedSharding)))
    for path, spec in flat:
        leaf = _port_leaf(got, path)
        assert leaf.mesh is m and leaf.spec == tuple(spec), (jax.tree_util.keystr(path), leaf.spec, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_under_default_rules_match_reference(arch):
    ref = ref_params.partition_specs(ref_tf.model_specs(ref_configs.get_config(arch)))
    got = params.partition_specs(transformer.model_specs(configs.get_config(arch)))
    flat = _specs(ref)
    assert flat
    for path, spec in flat:
        assert _port_leaf(got, path) == tuple(spec), jax.tree_util.keystr(path)
    fsdp_off = ref_mesh.rules_for(_mesh("2x2"), fsdp=False)
    assert meshlib.rules_for(_mesh("2x2"), fsdp=False) == fsdp_off


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_and_data_sharding_match_reference(mesh):
    m = _mesh(mesh)
    assert meshlib.batch_axes(m) == ref_mesh.batch_axes(m)
    assert meshlib.rules_for(m) == ref_mesh.rules_for(m)
    assert params.DEFAULT_RULES == ref_params.DEFAULT_RULES
    assert meshlib.data_sharding(m).spec == tuple(
        jax.sharding.PartitionSpec(ref_mesh.batch_axes(m)))


def _ref_cache(cfg, batch, max_seq):
    enc = cfg.encoder.n_frames if cfg.encoder else (cfg.vision.n_tokens if cfg.vision else 0)
    return jax.eval_shape(lambda: ref_tf.init_cache(cfg, batch, max_seq, enc_len=enc))


@pytest.mark.parametrize("batch,max_seq", CACHE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placement_matches_reference(arch, batch, max_seq):
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    ref_cache = _ref_cache(ref_cfg, batch, max_seq)
    cache = transformer.init_cache(cfg, batch, max_seq, enc_len=transformer._enc_len(cfg), device="meta")
    flat = jax.tree_util.tree_flatten_with_path(ref_cache)[0]
    assert len(flat) == len(jax.tree.leaves(cache))
    for mesh in MESHES:
        m = _mesh(mesh)
        got = meshlib.cache_shardings(cache, m)
        for path, sds in flat:
            # the spec the reference's cache_shardings gives this leaf (its
            # NamedSharding needs a device mesh; the spec does not)
            want = tuple(ref_mesh.cache_pspec_for(str(path[-1].key), sds.shape, m))
            assert tuple(_port_leaf(cache, path).shape) == tuple(sds.shape), jax.tree_util.keystr(path)
            assert _port_leaf(got, path).spec == want, (mesh, jax.tree_util.keystr(path))
            assert meshlib.cache_pspec_for(path[-1].key, tuple(sds.shape), m) == want


def test_abstract_gives_shapes_without_storage():
    specs = transformer.model_specs(configs.get_config("qwen3-32b"))
    abstract = params.abstract(specs)
    ref = ref_params.abstract(ref_tf.model_specs(ref_configs.get_config("qwen3-32b")))
    for path, want in jax.tree_util.tree_flatten_with_path(ref)[0]:
        leaf = _port_leaf(abstract, path)
        assert leaf.is_meta and tuple(leaf.shape) == tuple(want.shape) and leaf.dtype == torch.bfloat16


def test_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="256 ranks"):
        meshlib.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        meshlib.make_production_mesh(multi_pod=True)


def test_seq_shard_is_honoured_at_2x2(monkeypatch):
    """Under ``SEQ_SHARD`` a 2x2 rank's residual stream [B, S, D] = [8,
    16, 64] is its [4, 8, 64] shard (``constrain_seq`` checks it); S = 15
    does not divide the model axis and falls back to the batch shard, as
    does a mesh without a model axis; off, the stream is whole."""
    monkeypatch.setattr(layers, "SEQ_SHARD", True)
    layers.enable_activation_sharding(_mesh("2x2"))
    try:
        assert layers.seq_parallel(16) and not layers.seq_parallel(15)
        assert layers.constrain_seq(torch.zeros(4, 8, 64), (8, 16, 64)) is not None
        with pytest.raises(ValueError, match="sequence shard"):
            layers.constrain_seq(torch.zeros(4, 16, 64), (8, 16, 64))
        layers.constrain_seq(torch.zeros(4, 15, 64), (8, 15, 64))
        with pytest.raises(ValueError, match="not this rank's shard"):
            layers.constrain_seq(torch.zeros(4, 7, 64), (8, 15, 64))
        monkeypatch.setattr(layers, "SEQ_SHARD", False)
        assert not layers.seq_parallel(16)
        layers.constrain_seq(torch.zeros(4, 16, 64), (8, 16, 64))
        monkeypatch.setattr(layers, "SEQ_SHARD", True)
        layers.enable_activation_sharding(_mesh("4x1"))  # no model axis to shard over
        assert not layers.seq_parallel(16)
    finally:
        layers.disable_activation_sharding()


def test_constrain_batch_checks_the_local_shard():
    """On a 2x2 rank, [B, S, H, d] = [8, 16, 4, 64] under the reference's
    constraint is a [4, 16, 2, 64] shard; H = 3 does not divide and stays
    whole; without a mesh the call is a no-op."""
    x = torch.zeros(4, 16, 2, 64)
    layers.enable_activation_sharding(_mesh("2x2"))
    try:
        assert layers.constrain_batch(x, 0, 2, global_shape=(8, 16, 4, 64)) is x
        assert layers.constrain_seq(torch.zeros(4, 16, 64), global_shape=(8, 16, 64)).shape == (4, 16, 64)
        with pytest.raises(ValueError, match="not this rank's shard"):
            layers.constrain_batch(x, 0, 2, global_shape=(8, 16, 3, 64))
    finally:
        layers.disable_activation_sharding()
    assert layers.constrain_batch(x, 0, 2, global_shape=(99, 1, 1, 1)) is x


@pytest.fixture(scope="module")
def grid():
    return meshlib.run_ranks(worker.grid_checks, 4, devices=["cpu"] * 4, grid={"data": 2, "model": 2},
                             timeout_s=240.0)


def test_grid_coordinates_are_row_major(grid):
    assert [r["coords"] for r in grid] == [{"data": d, "model": m} for d in range(2) for m in range(2)]
    for r in grid:
        assert r["data_ranks"] == [r["coords"]["model"], 2 + r["coords"]["model"]]
        assert r["model_ranks"] == [2 * r["coords"]["data"], 2 * r["coords"]["data"] + 1]


def test_grid_collectives_stay_in_their_lines(grid):
    for r in grid:
        d, m = r["coords"]["data"], r["coords"]["model"]
        assert r["sum_data"] == (m) + (2 + m)  # ranks sharing this model coordinate
        assert r["sum_model"] == 2 * d + 2 * d + 1
        assert r["sum_all"] == 0 + 1 + 2 + 3


def test_shards_gather_back_whole_on_rank0(grid):
    full = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for r in grid:
        d, m = r["coords"]["data"], r["coords"]["model"]
        np.testing.assert_array_equal(r["shard"], full[4 * d : 4 * d + 4, 3 * m : 3 * m + 3])
    np.testing.assert_array_equal(grid[0]["full"], full)
    assert all(r["full"] is None for r in grid[1:])


def test_fsdp_gather_reduce_scatters_the_gradient(grid):
    """The gathered leaf is the model-axis shard whole over 'data'; its
    gradient (each rank's upstream gradient = its rank + 1) comes back
    summed over 'data' and sliced to the rank's shard."""
    full = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for r in grid:
        d, m = r["coords"]["data"], r["coords"]["model"]
        np.testing.assert_array_equal(r["gathered"], full[:, 3 * m : 3 * m + 3])
        np.testing.assert_array_equal(r["grad"], np.full((4, 3), (m + 1) + (2 + m + 1), np.float32))


def test_forward_over_the_mesh_matches_one_process(grid):
    """Vocab-parallel embedding and logits (gathered over 'model') and
    tensor-parallel layers give every rank the 1-process logits of its rows
    (float32, within 1e-5 of max |logit|)."""
    for r in grid:
        got, want = r["logits"]["mesh"], r["logits"]["whole"]
        assert got.shape == want.shape == (2, 16, 256)
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
