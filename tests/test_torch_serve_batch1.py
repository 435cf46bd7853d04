"""Prefill and decode over a 2×2 (data, model) mesh at a batch the data
axis does not divide, against the reference's own GSPMD serving program
on a (2, 2) mesh of fake XLA devices.

The reference takes such a batch by replicating its rows: its
``constrain_batch`` falls back to replication on a dim the batch axes do
not divide, and its dry run places the decode tokens ``P(None)``
(``src/repro/launch/dryrun.py``).  Here the reference runs in a subprocess
with 4 forced host devices, as in ``test_torch_serve_mesh``, with the
tokens, frames and patches placed ``P(None)``; the port runs the same
prefill and 4 decode steps on 4 gloo ranks (``torch_serve_worker.serve``),
every rank holding every row.  Rank 0's logits and every leaf of its cache
shard (after prefill and after the last step) are held within 1e-5 of
max|value| of the reference's.

Every arch of ``test_torch_serve_mesh.ARCHS`` runs at batch 1: the
attention caches' slots then split over both axes (h2o-danube's ring,
qwen3's and jamba's one KV head), MLA's latent slots too, the MoE's
dispatch groups are the one row's tokens alone.  qwen2-moe and jamba run
at batch 3 too.  Rows counted as if split (each rank taking the batch as
its share of D times as many rows) fill jamba's dispatch groups and
capacities with D copies of its row and drop tokens the reference keeps:
1.26e-2 of max|logit| off at prefill, so this suite fails on that.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_serve_worker as worker
from repro_torch.launch import mesh as meshlib
from repro_torch.train import sharding
from test_torch_serve_mesh import ARCHS, ROOT, TOL, _close, _tree

S, MAX_SEQ, N_DECODE = 12, 24, 4
CASES = tuple((arch, 1) for arch in ARCHS) + (("qwen2-moe-a2.7b", 3), ("jamba-v0.1-52b", 3))

REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import mesh as meshlib
    from repro.models import layers, params as P_, transformer
    from test_torch_families import _Float32Jnp, _conditioned

    out, s, max_seq, n_decode = sys.argv[1], *map(int, sys.argv[2:5])
    transformer.jnp = _Float32Jnp()
    transformer.init_cache.__defaults__ = (jnp.float32, 0)
    transformer._encode.__defaults__ = (jnp.float32,)
    mesh = meshlib.make_mesh((2, 2), ("data", "model"))
    layers.enable_activation_sharding(mesh)
    flat = lambda t, pre: {pre + jax.tree_util.keystr(k): np.asarray(v)
                           for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for case in sys.argv[5:]:
        name, b = case.rsplit("@", 1)
        b = int(b)
        arch, _, path = name.partition(":")
        cfg = configs.reduce_config(configs.get_config(arch))
        if path == "naive":
            cfg = dataclasses.replace(cfg, mla_absorb=False)
        specs = transformer.model_specs(cfg)
        params = _conditioned(specs, jax.tree.map(lambda a: a.astype(jnp.float32),
                                                  P_.materialize(specs, jax.random.PRNGKey(0))))
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
        placed = jax.tree.map(jax.device_put, params, meshlib.param_shardings(specs, mesh))
        d = int(np.prod([mesh.shape[a] for a in meshlib.batch_axes(mesh)]))
        bsp = P(meshlib.batch_axes(mesh)) if b % d == 0 else P(None)
        rows = NamedSharding(mesh, bsp)
        extra = {}
        if cfg.encoder is not None:
            extra["frames"] = (b, cfg.encoder.n_frames, cfg.d_model)
        if cfg.vision is not None:
            extra["patches"] = (b, cfg.vision.n_tokens, cfg.d_model)
        extra = {k: np.random.default_rng(1).standard_normal(v).astype(np.float32) for k, v in extra.items()}
        put = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(*bsp, None, None)))
               for k, v in extra.items()}
        with mesh:
            logits, cache = jax.jit(lambda p, t, kw: transformer.prefill(p, cfg, t, max_seq, **kw))(
                placed, jax.device_put(jnp.asarray(tokens), rows), put)
            res = {"logits0": np.asarray(logits), **flat(cache, "prefill")}
            cache = jax.device_put(cache, meshlib.cache_shardings(cache, mesh))
            step = jax.jit(lambda p, c, t: transformer.decode_step(p, cfg, t, c))
            for i in range(n_decode):
                nxt = ((np.arange(b) * 7 + i * 13) % cfg.vocab_size).astype(np.int32)
                logits, cache = step(placed, cache, jax.device_put(jnp.asarray(nxt), rows))
                res[f"logits{i + 1}"] = np.asarray(logits)
            res.update(flat(cache, "final"))
        np.savez(f"{out}/{case}.npz", **res, **flat(params, "p"), tokens=tokens,
                 **{"x_" + k: v for k, v in extra.items()})
    print("REF_OK")
    """
)


def _case(case) -> str:
    return f"{case[0]}@{case[1]}"


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """{case: (the reference's npz, the port's rank-0 report)}: one
    reference subprocess and one 4-rank spawn for every case."""
    out = tmp_path_factory.mktemp("serve_batch1")
    names = [_case(c) for c in CASES]
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(out), str(S), str(MAX_SEQ), str(N_DECODE), *names],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert "REF_OK" in res.stdout, res.stderr[-3000:]
    zs = {name: np.load(out / f"{name}.npz") for name in names}
    runs = [(case[0], _tree(z, "p"), z["tokens"], N_DECODE, MAX_SEQ, None,
             {k[2:]: z[k] for k in z.files if k.startswith("x_")}) for case, z in zip(CASES, zs.values())]
    ports = meshlib.run_ranks(worker.serve_many, 4, devices=["cpu"] * 4, grid={"data": 2, "model": 2},
                              args=(runs,), timeout_s=240.0)[0]
    return {name: (zs[name], port) for name, port in zip(names, ports)}


@pytest.fixture(params=CASES, ids=_case)
def pair(request, both):
    return both[_case(request.param)]


def test_logits_match_gspmd(pair):
    """Prefill's last-token logits and every decode step's: every row on
    rank 0, the whole vocabulary."""
    z, port = pair
    b = z["tokens"].shape[0]
    assert port["rows"] == (0, b)  # the batch axes (2) do not divide 1 or 3: every row here
    assert len(port["logits"]) == N_DECODE + 1
    for i, got in enumerate(port["logits"]):
        want = z[f"logits{i}"]
        assert got.shape == want.shape, (i, got.shape, want.shape)
        assert _close(got, want) <= TOL, (i, _close(got, want))


@pytest.mark.parametrize("phase", ["prefill", "final"])
def test_cache_shard_matches_gspmd(pair, phase):
    """Every leaf of rank 0's cache shard equals its slice of the
    reference's cache (placed by ``cache_pspec_for``), its batch dim
    whole."""
    z, port = pair
    mesh = meshlib.dry_grid_mesh({"data": 2, "model": 2}, rank=port["rank"], device="cpu")
    leaves = port["cache_prefill" if phase == "prefill" else "cache"]
    assert set(leaves) == set(port["specs"]) == {k[len(phase):] for k in z.files if k.startswith(phase + "[")}
    for key, got in leaves.items():
        assert port["specs"][key][1] is None, (key, port["specs"][key])
        want = z[phase + key]
        want = want[sharding.shard_index(want.shape, port["specs"][key], mesh)]
        assert got.shape == want.shape, (key, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.integer):
            assert np.array_equal(got, want), key
        else:
            assert _close(got, want) <= TOL, (key, _close(got, want))


def test_batch_one_splits_the_slots_over_every_axis(both):
    """At batch 1 the long-context layout: the attention caches' slots of
    the archs with too few KV heads for 'model' (qwen3, h2o-danube's ring,
    jamba's attention layer), the VLM's memory positions and MLA's latent
    slots split over ('data', 'model'), as they do at batch 3 (the batch
    dim whole); the SSM state's heads over 'model'."""
    every = ("data", "model")
    specs = {name: port["specs"] for name, (_z, port) in both.items()}
    for name, key in (("qwen3-32b@1", "['layers']['s0']['k']"), ("h2o-danube-3-4b@1", "['layers']['s0']['k']"),
                      ("jamba-v0.1-52b@1", "['blocks']['s4']['k']"),
                      ("llama-3.2-vision-11b@1", "['blocks']['s1']['k']")):
        assert specs[name][key] == (None, None, every, None, None), (name, specs[name][key])
    assert specs["deepseek-v3-671b@1"]["['moe']['s0']['ckv']"] == (None, None, every, None)
    assert specs["jamba-v0.1-52b@3"]["['blocks']['s4']['k']"] == (None, None, every, None, None)
    assert specs["jamba-v0.1-52b@1"]["['blocks']['s0']['h']"] == (None, None, "model", None, None)


def test_replicated_rows_exchange_no_choices(both):
    """With every row on every data rank the MoE routes its rows alone:
    no rank all-gathers the experts' choices of a group spanning the data
    ranks, so a decode step of qwen2-moe at batch 3 issues no more
    all-gathers than at batch 1 (the FSDP gathers and the vocab-parallel
    logits alone)."""
    one, three = both["qwen2-moe-a2.7b@1"][1]["kinds"], both["qwen2-moe-a2.7b@3"][1]["kinds"]
    for phase in one:
        assert three[phase]["all-gather"]["count"] == one[phase]["all-gather"]["count"], phase


@pytest.mark.parametrize("batch, rank, rows", [(4, 0, (0, 2)), (4, 3, (2, 4)), (3, 1, (0, 3)), (1, 2, (0, 1))])
def test_local_rows_split_or_replicate(batch, rank, rows):
    """``layers.local_rows`` on a 2×2 (data, model) grid: a data rank's
    share where 'data' divides the batch, else every row; every row
    without a mesh."""
    from repro_torch.models import layers

    layers.enable_activation_sharding(meshlib.dry_grid_mesh({"data": 2, "model": 2}, rank, device="cpu"))
    try:
        assert layers.local_rows(batch) == rows
    finally:
        layers.disable_activation_sharding()
    assert layers.local_rows(batch) == (0, batch)


def test_serving_over_a_mesh_needs_the_global_batch():
    """Over a mesh a rank's rows alone cannot tell its share from every
    row, so prefill without ``batch=`` and a decode step on a cache that
    is no ``MeshCache`` raise, and so do rows that are not
    ``local_rows``'."""
    from repro_torch import configs
    from repro_torch.models import layers, transformer

    cfg = configs.reduce_config(configs.get_config("jamba-v0.1-52b"))
    layers.enable_activation_sharding(meshlib.dry_grid_mesh({"data": 2, "model": 2}, device="cpu"),
                                      vocab_size=cfg.vocab_size)
    try:
        tokens = torch.zeros(1, 4, dtype=torch.long)
        with pytest.raises(ValueError, match="needs the global batch"):
            transformer.prefill({}, cfg, tokens, 8)
        with pytest.raises(ValueError, match="needs the global batch"):
            transformer.decode_step({}, cfg, tokens[:, 0], {})
        with pytest.raises(ValueError, match="gives each 1 rows, not 2"):
            transformer.prefill({}, cfg, torch.zeros(2, 4, dtype=torch.long), 8, batch=2)
    finally:
        layers.disable_activation_sharding()
