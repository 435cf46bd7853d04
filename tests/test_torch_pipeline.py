"""GPipe over process groups (``repro_torch.train.pipeline``) against the
reference's ``pipeline_loss_fn``, at the reference test's setup
(``tests/test_system.py::test_pipeline_parallel_subprocess``): reduced
qwen1.5-0.5b cut to 4 layers, its seed-0 draw, B = S = 16, 2 stages × 4
data shards, 2 microbatches.

The reference runs in a subprocess on 8 forced host devices: its
``pipeline_loss_fn`` under ``jax.value_and_grad`` and its un-pipelined
``chunked_ce``, twice — as it runs (bf16 weights and activations) and in
float32 (its bf16 casts patched to float32, as ``test_torch_train_grads``
does).  The port runs 8 gloo ranks (``torch_train_worker.pipeline_rank``),
each holding its stage's block of the staged layers and its 4 rows, and
calls ``loss.backward()`` on every rank.

Held:
* bf16: the GPipe loss within 1e-3 of the un-pipelined loss (the
  reference's bound; measured 2.9e-4), every rank's loss the same, every
  gradient finite and every stage's layers' gradients nonzero.  Its
  gradients are not compared with the reference's in bf16: the reduced
  draw is chaotic (ROADMAP C.17) and the port's attention keeps float32
  scores where the reference's rounds them to bf16 (C.6), so the two
  bf16 runs part by 0.3–0.6 of ‖g‖ while agreeing in float32;
* float32: the loss within 1e-5 of the reference's ``pipeline_loss_fn``
  (measured 5e-7), and each rank's gradient of every leaf — its stage's
  block of the layers, the embedding and final norm whole — within
  ‖Δ‖/‖ref‖ <= 1e-3 of ``jax.grad`` of the reference's pipeline loss
  (measured <= 1.6e-4), tighter than the 2.4e-3 (matrices) and 2.2e-2
  (norm scales) by which the reference's own bf16 pipeline and
  un-pipelined gradients differ.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_train_worker as worker
from repro_torch import configs
from repro_torch.launch import mesh as meshlib
from repro_torch.train import pipeline

ROOT = Path(__file__).resolve().parents[1]
STAGES, DATA, N_MICRO, LAYERS = 2, 4, 2, 4

REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import dataclasses, jax, jax.numpy as jnp, numpy as np
    from repro import configs
    from repro.launch import mesh as meshlib
    from repro.models import transformer, params as P_
    from repro.train import pipeline as PP
    from repro.train.step import chunked_ce
    from test_torch_families import _Float32Jnp

    out = sys.argv[1]
    cfg = dataclasses.replace(configs.reduce_config(configs.get_config("qwen1.5-0.5b")), n_layers=4)
    specs = transformer.model_specs(cfg)
    params = P_.materialize(specs, jax.random.PRNGKey(0))
    B, S = 16, 16
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size)
    labels = jnp.concatenate([tokens[:, 1:], -jnp.ones((B, 1), jnp.int32)], 1)
    mesh = meshlib.make_mesh((2, 4), ("pod", "data"))
    flat = lambda t, pre: {pre + jax.tree_util.keystr(k): np.asarray(v, np.float32)
                           for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    res = {"tokens": np.asarray(tokens), "labels": np.asarray(labels), **flat(params, "p")}
    for mode in ("bf16", "f32"):
        if mode == "f32":
            PP.jnp = transformer.jnp = _Float32Jnp()
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        hidden, _ = transformer.forward_hidden(params, cfg, tokens, remat=False)
        res[mode + "_unpiped"] = float(chunked_ce(hidden, params["embed"].T.astype(hidden.dtype), labels, 0, 0.0))
        staged = PP.stage_view(params, 2)
        fn = PP.pipeline_loss_fn(cfg, mesh, 2, staged, batch_axes=("data",))
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(fn))(staged, tokens, labels)
        res[mode + "_loss"] = float(loss)
        res.update(flat(grads, mode + "_g"))
    np.savez(out, **res)
    print("REF_OK")
    """
)


def _tree(z, prefix: str) -> dict:
    out: dict = {}
    for key in z.files:
        if key.startswith(prefix + "["):
            path = [p.strip("'") for p in key[len(prefix) + 1 : -1].split("][")]
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = z[key]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline") / "ref.npz"
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(out)], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert "REF_OK" in res.stdout, res.stderr[-3000:]
    z = np.load(out)
    argd = {"arch": "qwen1.5-0.5b", "smoke": True, "layers": LAYERS}
    todo = [(argd, _tree(z, "p"), z["tokens"], z["labels"], N_MICRO, f32) for f32 in (False, True)]
    ranks = meshlib.run_ranks(worker.pipeline_runs, STAGES * DATA, devices=["cpu"] * (STAGES * DATA),
                              grid={"pod": STAGES, "data": DATA}, args=(todo,), timeout_s=240.0)
    return z, {"bf16": [r[0] for r in ranks], "f32": [r[1] for r in ranks]}


def _want(z, mode: str, path: str, stage: int) -> np.ndarray:
    g = z[mode + "_g" + "".join(f"['{p}']" for p in path.split("/"))]
    return g[stage : stage + 1] if path.startswith("layers/") else g


def test_ranks_are_stage_by_data(runs):
    _, port = runs
    assert [r["coords"] for r in port["bf16"]] == [{"pod": s, "data": d} for s in range(STAGES)
                                                  for d in range(DATA)]


def test_bf16_loss_matches_unpipelined(runs):
    z, port = runs
    losses = {r["loss"] for r in port["bf16"]}
    assert len(losses) == 1
    assert abs(losses.pop() - float(z["bf16_unpiped"])) < 1e-3


def test_bf16_gradients_finite_and_every_stage_reached(runs):
    _, port = runs
    for r in port["bf16"]:
        for path, g in r["grads"].items():
            assert np.isfinite(g).all(), path
            if path.startswith("layers/"):
                assert np.abs(g).max() > 0, (r["coords"], path)


def test_f32_loss_matches_reference_pipeline(runs):
    z, port = runs
    for r in port["f32"]:
        assert abs(r["loss"] - float(z["f32_loss"])) <= 1e-5, (r["loss"], float(z["f32_loss"]))


def test_f32_gradients_match_reference_pipeline(runs):
    z, port = runs
    for r in port["f32"]:
        assert len(r["grads"]) == len([k for k in z.files if k.startswith("f32_g[")])
        for path, g in r["grads"].items():
            want = _want(z, "f32", path, r["coords"]["pod"])
            assert g.shape == want.shape, path
            gap = np.linalg.norm(g - want) / np.linalg.norm(want)
            assert gap <= 1e-3, (r["coords"], path, gap)


def test_pipeline_takes_uniform_stacks_only():
    cfg = configs.reduce_config(configs.get_config("qwen2-moe-a2.7b"))
    with pytest.raises(ValueError, match="uniform decoder stacks"):
        pipeline.pipeline_loss_fn(cfg, None, 2, {})


def test_stage_view_and_placement():
    import torch

    tree = {"embed": torch.zeros(8, 2), "layers": {"w": torch.arange(4 * 3).reshape(4, 3)}}
    staged = pipeline.stage_view(tree, 2)
    assert staged["layers"]["w"].shape == (2, 2, 3) and staged["embed"] is tree["embed"]
    assert pipeline.stage_placement(staged) == {"embed": (None, None), "layers": {"w": ("pod", None, None)}}
