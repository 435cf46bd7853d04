"""Sequence parallelism (``models.layers.SEQ_SHARD``) over a (data, model)
mesh against the reference's own GSPMD program with its ``SEQ_SHARD`` set.

The reference runs in one subprocess with 4 forced host devices, its
``layers.SEQ_SHARD = True`` set there (its ``constrain_seq`` shards the
residual stream on S over 'model' at every block boundary), parameters
placed by ``launch.mesh.param_shardings``, activation sharding on, float32
throughout (its bf16 casts patched to float32), on its own seed-0 draw
with the attention projections rescaled
(``test_torch_families._conditioned``), at 2×2 and at 1×4.  The port runs
the same programs on 4 gloo ranks (one spawn per mesh shape) from those
weights, each rank on its shards and its rows.

* One float32 gradient step of reduced qwen1.5-0.5b, qwen2-moe,
  deepseek-v3 (MLA, MoE, MTP), mamba2, jamba and whisper (its encoder
  whole, its decoder's stream split): the loss, the gradient norm and
  every gradient leaf (the reference's from ``jax.grad`` of its
  ``loss_fn``) within 1e-5 relative.  The norms' and the other leaves the
  model axis does not split hold each rank's positions' part until
  ``sharding.sync_grads`` sums them over 'model'; the planted fault (that
  sum left out) fails the comparison.  The MoE archs run at S = 128, so
  each data rank's tokens form whole dispatch groups.  jamba's loss and
  gradient norm are held at 1e-5 too, but its leaves cannot be: the
  reference's own program without ``SEQ_SHARD`` (the witness, lowered
  beside it) already moves them by 2–3e-5 (ROADMAP C.17: its float32
  gradients are that sensitive to the order of the sums), and a third
  order of the sums, the port's, lands as far from either: its leaves
  are held within twice that witness's largest gap, and that gap must
  itself stay within ``WITNESS_CAP`` (1e-4), so a larger spread fails
  the test rather than widening its bound (a missing sum or a wrong slice
  moves a leaf by 1e-1 or more).  The planted fault runs on qwen1.5-0.5b
  and on jamba, each held to its own bound.
* The fallback: S = 30 at 1×4 does not divide the model axis, so the
  stream stays whole (no reduce-scatter), as the reference's
  ``constrain_seq`` falls back to ``constrain_batch``.
* A prefill of 12 tokens and 2 decode steps of qwen1.5-0.5b and jamba:
  every step's logits and every cache leaf within 1e-5 of max|value| (the
  cache's K/V and SSM states are the gathered sequence's).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_train_worker as worker
from repro_torch.launch import mesh as meshlib
from repro_torch.train import sharding
from test_torch_train_mesh_gspmd import _tree

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, TOL = 4, 1e-5
TRAIN = (("qwen1.5-0.5b", 32), ("qwen2-moe-a2.7b", 128), ("deepseek-v3-671b", 128), ("mamba2-1.3b", 32),
         ("jamba-v0.1-52b", 128), ("whisper-base", 32))
CHAOTIC = ("jamba-v0.1-52b", 128)  # its leaves held within the reference's own witness (docstring)
WITNESS_CAP = 1e-4  # the most the witness may move jamba's leaves (2-3e-5 measured)
FAULTS = ("qwen1.5-0.5b", "jamba-v0.1-52b")  # the planted fault's runs, at 2x2
FALLBACK = ("qwen1.5-0.5b", 30)  # at 1x4 only
SERVE = ("qwen1.5-0.5b", "jamba-v0.1-52b")
SERVE_S, MAX_SEQ, N_DECODE = 12, 24, 2

REFERENCE = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import mesh as meshlib
    from repro.models import layers, params as P_, transformer
    from repro.train import step as step_lib
    from test_torch_families import _Float32Jnp, _conditioned

    out, b = sys.argv[1], int(sys.argv[2])
    plan = json.loads(sys.argv[3])  # {mesh name: [[kind, arch, seq], ...]}
    transformer.jnp = _Float32Jnp()
    transformer.init_cache.__defaults__ = (jnp.float32, 0)
    transformer._encode.__defaults__ = (jnp.float32,)
    layers.SEQ_SHARD = True
    flat = lambda t, pre: {pre + jax.tree_util.keystr(k): np.asarray(v)
                           for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for name, runs in plan.items():
        mesh = meshlib.make_mesh(tuple(int(x) for x in name.split("x")), ("data", "model"))
        layers.enable_activation_sharding(mesh)
        rows = NamedSharding(mesh, P(meshlib.batch_axes(mesh)))
        for kind, arch, s in runs:
            layers.SEQ_SHARD = kind != "witness"
            cfg = configs.reduce_config(configs.get_config(arch))
            specs = transformer.model_specs(cfg)
            params = _conditioned(specs, jax.tree.map(lambda a: a.astype(jnp.float32),
                                                      P_.materialize(specs, jax.random.PRNGKey(0))))
            rng = np.random.default_rng(0)
            tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
            extra = {}
            if cfg.encoder is not None:
                extra["frames"] = np.random.default_rng(1).standard_normal(
                    (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
            put = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(meshlib.batch_axes(mesh), None, None)))
                   for k, v in extra.items()}
            placed = jax.tree.map(jax.device_put, params, meshlib.param_shardings(specs, mesh))
            res = {"tokens": tokens, **{"x_" + k: v for k, v in extra.items()}}
            with mesh:
                if kind in ("train", "witness"):
                    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)], 1)
                    labels[1, 5] = -1
                    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels), **put}
                    tcfg = step_lib.TrainConfig()
                    loss, grads = jax.jit(jax.value_and_grad(
                        lambda p: step_lib.loss_fn(p, cfg, tcfg, batch)[0]))(placed)
                    g = flat(grads, "g")
                    res.update(labels=labels, loss=float(loss), **g,
                               grad_norm=float(np.sqrt(sum(np.sum(np.square(v.astype(np.float64))) for v in g.values()))))
                else:
                    logits, cache = jax.jit(lambda p, t, kw: transformer.prefill(p, cfg, t, %d, **kw))(
                        placed, jax.device_put(jnp.asarray(tokens), rows), put)
                    res.update(logits0=np.asarray(logits), **flat(cache, "prefill"))
                    cache = jax.device_put(cache, meshlib.cache_shardings(cache, mesh))
                    step = jax.jit(lambda p, c, t: transformer.decode_step(p, cfg, t, c))
                    for i in range(%d):
                        nxt = ((np.arange(b) * 7 + i * 13) %% cfg.vocab_size).astype(np.int32)
                        logits, cache = step(placed, cache, jax.device_put(jnp.asarray(nxt), rows))
                        res[f"logits{i + 1}"] = np.asarray(logits)
                    res.update(flat(cache, "final"))
            np.savez(f"{out}/{name}-{kind}-{arch}-{s}.npz", **res, **flat(params, "p"))
    print("REF_OK")
    """ % (MAX_SEQ, N_DECODE)
)


def _plan() -> dict:
    plan = {}
    for name in MESHES:
        runs = [["train", arch, s] for arch, s in TRAIN] + [["serve", arch, SERVE_S] for arch in SERVE]
        runs.append(["witness", *CHAOTIC])
        if name == "1x4":
            runs.append(["train", *FALLBACK])
        plan[name] = runs
    return plan


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """{(mesh, kind, arch, seq): (the reference's npz, the port's rank-0
    result)} and the planted fault's results {arch: (the reference's npz,
    the port's rank-0 result)}: one reference subprocess, one 4-rank spawn
    per mesh shape."""
    import json

    out = tmp_path_factory.mktemp("seq_shard")
    plan = _plan()
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(out), str(B), json.dumps(plan)],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert "REF_OK" in res.stdout, res.stderr[-3000:]
    pairs, fault = {}, {}
    for name, runs in plan.items():
        zs = [np.load(out / f"{name}-{kind}-{arch}-{s}.npz") for kind, arch, s in runs]
        todo = []
        witness = runs.index(["witness", *CHAOTIC])
        pairs[(name, "witness", *CHAOTIC)] = (zs.pop(witness), None)
        runs = runs[:witness] + runs[witness + 1 :]
        for (kind, arch, _s), z in zip(runs, zs):
            extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
            if kind == "train":
                todo.append(("train", arch, _tree(z, "p"), z["tokens"], z["labels"], extra))
            else:
                todo.append(("serve", arch, _tree(z, "p"), z["tokens"], N_DECODE, MAX_SEQ, None, extra))
        faulty = [i for i, (kind, arch, _s) in enumerate(runs) if kind == "train" and arch in FAULTS]
        if name == "2x2":  # the planted fault, on qwen1.5-0.5b's and jamba's runs
            todo += [todo[i] + (True,) for i in faulty]
        grid = dict(zip(("data", "model"), MESHES[name]))
        ports = meshlib.run_ranks(worker.seq_runs, 4, devices=["cpu"] * 4, grid=grid, args=(todo,),
                                  timeout_s=480.0)[0]
        for (kind, arch, s), z, port in zip(runs, zs, ports):
            pairs[(name, kind, arch, s)] = (z, port)
        if name == "2x2":
            fault = {runs[i][1]: (zs[i], port) for i, port in zip(faulty, ports[len(runs):])}
    return pairs, fault


def _gaps(z, grads: dict) -> dict:
    """Every leaf's largest gap to ``z``'s over its max |g|."""
    return {key: float(np.max(np.abs(grads[key[1:]] - z[key])) / np.max(np.abs(z[key])))
            for key in z.files if key.startswith("g[")}


def _leaf_tol(pairs: dict, name: str, arch: str, s: int) -> float:
    """The bound on every gradient leaf: ``TOL``, or for ``CHAOTIC`` twice
    the witness's largest gap, which must itself be within
    ``WITNESS_CAP``."""
    if (arch, s) != CHAOTIC:
        return TOL
    z, witness = pairs[(name, "train", arch, s)][0], pairs[(name, "witness", arch, s)][0]
    gap = max(_gaps(z, {k[1:]: witness[k] for k in witness.files if k.startswith("g[")}).values())
    assert gap <= WITNESS_CAP, f"the reference's own SP-vs-unsplit gap {gap} is over {WITNESS_CAP}"
    return max(TOL, 2 * gap)


def _held_train(z, port, leaf_tol: float = TOL) -> None:
    """Loss and gradient norm within 1e-5 relative, every leaf within
    ``leaf_tol`` of its max |g|."""
    assert abs(port["loss"] - float(z["loss"])) <= TOL * abs(float(z["loss"])), (port["loss"], float(z["loss"]))
    assert abs(port["grad_norm"] - float(z["grad_norm"])) <= TOL * float(z["grad_norm"]), (
        port["grad_norm"], float(z["grad_norm"]))
    assert len(port["grads"]) == len([k for k in z.files if k.startswith("g[")])
    gaps = _gaps(z, port["grads"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= leaf_tol, (worst, gaps[worst], leaf_tol)


TRAIN_CASES = [(name, arch, s) for name in MESHES for arch, s in TRAIN] + [("1x4", *FALLBACK)]


@pytest.mark.parametrize("name,arch,s", TRAIN_CASES, ids=[f"{n}-{a}-{s}" for n, a, s in TRAIN_CASES])
def test_training_step_matches_gspmd(both, name, arch, s):
    z, port = both[0][(name, "train", arch, s)]
    _held_train(z, port, _leaf_tol(both[0], name, arch, s))
    split = s % MESHES[name][1] == 0
    assert (port["kinds"]["reduce-scatter"]["count"] > 0) == split, port["kinds"]


@pytest.mark.parametrize("arch", FAULTS)
def test_the_planted_sync_grads_fault_fails(both, arch):
    """Without the model-axis sum of the sequence-sharded leaves' gradients
    the norms' gradients are each rank's positions' part: the comparison
    fails, jamba's at its widened (capped) bound too."""
    s = dict(TRAIN)[arch]
    z, port = both[1][arch]
    tol = _leaf_tol(both[0], "2x2", arch, s)
    with pytest.raises(AssertionError):
        _held_train(z, port, tol)


SERVE_CASES = [(name, arch) for name in MESHES for arch in SERVE]


@pytest.mark.parametrize("name,arch", SERVE_CASES, ids=[f"{n}-{a}" for n, a in SERVE_CASES])
def test_prefill_and_decode_match_gspmd(both, name, arch):
    z, port = both[0][(name, "serve", arch, SERVE_S)]
    assert port["kinds"]["prefill"]["reduce-scatter"]["count"] > 0
    lo, hi = port["rows"]
    assert len(port["logits"]) == N_DECODE + 1
    for i, got in enumerate(port["logits"]):
        want = z[f"logits{i}"]
        assert np.max(np.abs(got - want[lo:hi])) <= TOL * np.max(np.abs(want)), (arch, i)
    mesh = meshlib.dry_grid_mesh(dict(zip(("data", "model"), MESHES[name])), rank=port["rank"], device="cpu")
    for phase, leaves in (("prefill", port["cache_prefill"]), ("final", port["cache"])):
        assert set(leaves) == {k[len(phase):] for k in z.files if k.startswith(phase + "[")}
        for key, got in leaves.items():
            want = z[phase + key]
            want = want[sharding.shard_index(want.shape, port["specs"][key], mesh)]
            assert got.shape == want.shape, (phase, key, got.shape, want.shape)
            if np.issubdtype(want.dtype, np.integer):
                assert np.array_equal(got, want), (phase, key)
            else:
                assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want)), (phase, key)
