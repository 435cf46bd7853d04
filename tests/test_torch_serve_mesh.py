"""Prefill and decode over a 2×2 (data, model) mesh against the reference's
own GSPMD serving program on a (2, 2) mesh of fake XLA devices.

The reference runs in a subprocess with 4 forced host devices: its
``transformer.prefill`` and ``decode_step`` under ``jax.jit``, parameters
placed by ``launch.mesh.param_shardings``, the prompt's rows over 'data',
the cache placed by ``cache_shardings``, activation sharding on, float32
throughout (its bf16 casts patched to float32, as
``test_torch_train_mesh_gspmd`` does), on its own seed-0 draw with the
attention projections rescaled (``test_torch_families._conditioned``).
The port runs the same prefill and 4 decode steps on 4 gloo ranks
(``torch_serve_worker.serve``) from those weights, each rank on its
shards and its rows; every rank feeds the same decode tokens.  Rank 0's
logits and every leaf of its cache shard (after prefill and after the
last step) are held within 1e-5 of max|value| of the reference's.

* reduced qwen1.5-0.5b: 4 KV heads, split over 'model';
* reduced qwen3-32b: one KV head, so the cache's slots are split over
  'model' and decode merges the partial softmaxes across the ranks;
* reduced h2o-danube-3-4b: one KV head and an 8-slot sliding-window ring,
  shorter than the 12-token prompt, its slots split over 'model';
* reduced qwen2-moe: 2 of its 4 experts a rank (expert parallelism) and the
  shared expert split; the prompt's 48 tokens and each decode step's 4 are
  one dispatch group that spans both data ranks; again (``:gathered``)
  from shards gathered over 'data' once, before the prefill, which no call
  then gathers again (``test_gathered_shards_gather_no_weights``);
* reduced deepseek-v3 (MLA, a dense layer, MoE), on the absorbed decode
  path and on the naive one (``:naive``): the latents' slots split over
  'model', each decode step's partial softmaxes merged;
* reduced whisper: the encoder's frames split with the rows, the
  cross-attention cache's 4 KV heads over 'model';
* reduced llama-3.2-vision: one KV head, so the cross-attention memory's
  8 positions are split over 'model' and merged at decode;
* reduced mamba2: each rank's 4 of the 8 SSM heads, its 'h' heads and
  its even slice of 'conv' (80 of conv_dim 160, against 64 x channels),
  the prompt's 12 tokens one chunk of 16;
* reduced jamba: one 8-sublayer block of SSM, attention (one KV head: its
  slots split over 'model') and MoE (2 of 4 experts a rank) sublayers.

Whisper's frames and the VLM's patches are one float32 draw (numpy, seed
1) handed to both.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_serve_worker as worker
from repro_torch.launch import mesh as meshlib
from repro_torch.train import sharding

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-0.5b", "qwen3-32b", "h2o-danube-3-4b", "qwen2-moe-a2.7b", "qwen2-moe-a2.7b:gathered",
         "deepseek-v3-671b", "deepseek-v3-671b:naive", "whisper-base", "llama-3.2-vision-11b", "mamba2-1.3b",
         "jamba-v0.1-52b")
B, S, MAX_SEQ, N_DECODE = 4, 12, 24, 4
TOL = 1e-5

REFERENCE = textwrap.dedent(
    """
    import os, sys, json
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

    out, b, s, max_seq, n_decode = sys.argv[1], *map(int, sys.argv[2:6])
    transformer.jnp = _Float32Jnp()
    transformer.init_cache.__defaults__ = (jnp.float32, 0)
    transformer._encode.__defaults__ = (jnp.float32,)
    mesh = meshlib.make_mesh((2, 2), ("data", "model"))
    layers.enable_activation_sharding(mesh)
    flat = lambda t, pre: {pre + jax.tree_util.keystr(k): np.asarray(v)
                           for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for name in sys.argv[6:]:
        arch, _, path = name.partition(":")
        cfg = configs.reduce_config(configs.get_config(arch))
        if path == "naive":
            cfg = dataclasses.replace(cfg, mla_absorb=False)
        specs = transformer.model_specs(cfg)
        params = _conditioned(specs, jax.tree.map(lambda a: a.astype(jnp.float32),
                                                  P_.materialize(specs, jax.random.PRNGKey(0))))
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
        placed = jax.tree.map(jax.device_put, params, meshlib.param_shardings(specs, mesh))
        rows = NamedSharding(mesh, P(meshlib.batch_axes(mesh)))
        extra = {}
        if cfg.encoder is not None:
            extra["frames"] = (b, cfg.encoder.n_frames, cfg.d_model)
        if cfg.vision is not None:
            extra["patches"] = (b, cfg.vision.n_tokens, cfg.d_model)
        extra = {k: np.random.default_rng(1).standard_normal(v).astype(np.float32) for k, v in extra.items()}
        put = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(meshlib.batch_axes(mesh), None, None)))
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
        np.savez(f"{out}/{name}.npz", **res, **flat(params, "p"), **{"x_" + k: v for k, v in extra.items()})
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
def both(tmp_path_factory):
    """{arch: (the reference's npz, the port's rank-0 report)}: one
    reference subprocess and one 4-rank spawn for every arch."""
    out = tmp_path_factory.mktemp("serve_gspmd")
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(out), str(B), str(S), str(MAX_SEQ),
                          str(N_DECODE), *ARCHS], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert "REF_OK" in res.stdout, res.stderr[-3000:]
    zs = {arch: np.load(out / f"{arch}.npz") for arch in ARCHS}
    tokens = np.random.default_rng(0).integers(0, 256, size=(B, S))
    runs = [(arch, _tree(z, "p"), tokens, N_DECODE, MAX_SEQ, None,
             {k[2:]: z[k] for k in z.files if k.startswith("x_")}) for arch, z in zs.items()]
    ports = meshlib.run_ranks(worker.serve_many, 4, devices=["cpu"] * 4, grid={"data": 2, "model": 2},
                              args=(runs,), timeout_s=240.0)[0]
    return {arch: (zs[arch], port) for arch, port in zip(ARCHS, ports)}


@pytest.fixture(params=ARCHS)
def pair(request, both):
    return both[request.param]


def _close(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)


def test_logits_match_gspmd(pair):
    """Prefill's last-token logits and every decode step's: rank 0's rows,
    the whole vocabulary."""
    z, port = pair
    lo, hi = port["rows"]
    assert len(port["logits"]) == N_DECODE + 1
    for i, got in enumerate(port["logits"]):
        want = z[f"logits{i}"][lo:hi]
        assert got.shape == want.shape, (i, got.shape, want.shape)
        assert _close(got, want) <= TOL, (i, _close(got, want))


@pytest.mark.parametrize("phase", ["prefill", "final"])
def test_cache_shard_matches_gspmd(pair, phase):
    """Every leaf of rank 0's cache shard equals its slice of the
    reference's cache (placed by ``cache_pspec_for``)."""
    z, port = pair
    mesh = meshlib.dry_grid_mesh({"data": 2, "model": 2}, rank=port["rank"], device="cpu")
    leaves = port["cache_prefill" if phase == "prefill" else "cache"]
    assert set(leaves) == set(port["specs"]) == {k[len(phase):] for k in z.files if k.startswith(phase + "[")}
    for key, got in leaves.items():
        want = z[phase + key]
        want = want[sharding.shard_index(want.shape, port["specs"][key], mesh)]
        assert got.shape == want.shape, (key, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.integer):
            assert np.array_equal(got, want), key
        else:
            assert _close(got, want) <= TOL, (key, _close(got, want))


def test_placements_split_heads_or_slots(both):
    """qwen1.5's KV heads over 'model'; qwen3's and h2o-danube's slots;
    MLA's latent slots; the cross-attention memory's KV heads (whisper) or
    its positions (the VLM's one KV head); the SSM state's heads and the
    conv state's channels (mamba2, jamba), jamba's attention slots."""
    k = "['layers']['s0']['k']"
    assert both["qwen1.5-0.5b"][1]["specs"][k] == (None, "data", None, "model", None)
    for arch in ("qwen3-32b", "h2o-danube-3-4b"):
        assert both[arch][1]["specs"][k] == (None, "data", "model", None, None), arch
    for name in ("deepseek-v3-671b", "deepseek-v3-671b:naive"):
        assert both[name][1]["specs"]["['moe']['s0']['ckv']"] == (None, "data", "model", None), name
    assert both["whisper-base"][1]["specs"]["['dec']['s1']['k']"] == (None, "data", None, "model", None)
    assert both["llama-3.2-vision-11b"][1]["specs"]["['blocks']['s1']['k']"] == (None, "data", "model", None, None)
    for name, sub in (("mamba2-1.3b", "['layers']['s0']"), ("jamba-v0.1-52b", "['blocks']['s0']")):
        specs = both[name][1]["specs"]
        assert specs[sub + "['h']"] == (None, "data", "model", None, None), name
        assert specs[sub + "['conv']"] == (None, "data", None, "model"), name
    assert both["jamba-v0.1-52b"][1]["specs"]["['blocks']['s4']['k']"] == (None, "data", "model", None, None)


def test_gathered_shards_gather_no_weights(both):
    """Served from shards gathered once, prefill and decode all-gather no
    weights: their all-gathers are the per-call path's less the FSDP
    gathers (the same logits, held above)."""
    per_call, once = both["qwen2-moe-a2.7b"][1]["kinds"], both["qwen2-moe-a2.7b:gathered"][1]["kinds"]
    for phase in per_call:
        assert once[phase]["all-gather"]["bytes"] < per_call[phase]["all-gather"]["bytes"], phase
        assert once[phase]["all-reduce"] == per_call[phase]["all-reduce"], phase
