"""The training substrate's pieces against the reference: the chunked loss
head, AdamW and its schedule, int8 quantisation, gradient compression, the
token pipeline and checkpoints (``repro_torch.train``, ``data.pipeline``,
``ckpt``).

Every case feeds both packages the same numpy-seeded inputs.  Bounds:
``chunked_ce`` values and gradients 1e-5 relative (float32); AdamW's
parameters within one bf16 ulp and its moments within 1e-6 relative over
several steps, for float32, bf16 and int8 moments (the gradients' global
norm is kept under the clip, so both packages scale by exactly 1); the
quantisers bit-identical; the pipeline's batches identical; checkpoints
restored bit-identical across the two packages, in both directions.
``compressed_all_reduce`` runs on 2 gloo ranks (``launch.mesh.run_ranks``;
the ranks' side is ``torch_mesh_worker.compressed_reduce``) against the
reference's formula.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from repro.ckpt import manager as ref_manager
from repro.data import pipeline as ref_pipeline
from repro.train import compression as ref_compression
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.ckpt import manager
from repro_torch.data import pipeline
from repro_torch.launch import mesh as meshlib
from repro_torch.train import compression, optimizer as opt, step as step_lib


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(32, 0), (32, 16), (30, 8), (32, 64)],
                         ids=["unchunked", "chunk16", "padded", "chunk-past-s"])
def test_chunked_ce_values_and_grads_match_reference(s, chunk):
    rng = np.random.default_rng(s + chunk)
    b, d, v = 2, 16, 50
    h = rng.standard_normal((b, s, d), dtype=np.float32)
    head = rng.standard_normal((d, v), dtype=np.float32) * 0.5
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    labels[:, -3:] = -1
    labels[1, 4] = -1
    want, (wh, whead) = jax.value_and_grad(
        lambda hh, hd: ref_step.chunked_ce(hh, hd, jnp.asarray(labels), chunk, 1e-4), argnums=(0, 1)
    )(jnp.asarray(h), jnp.asarray(head))
    th, thead = (torch.from_numpy(x).requires_grad_(True) for x in (h, head))
    got = step_lib.chunked_ce(th, thead, torch.from_numpy(labels).long(), chunk, 1e-4)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    for g, w in ((th.grad, wh), (thead.grad, whead)):
        assert np.max(np.abs(_np(g) - _np(w))) <= 1e-5 * np.max(np.abs(_np(w)))


def test_chunked_ce_frees_each_chunk(monkeypatch):
    """Each chunk's logits come from one ``_chunk_ce`` call under
    checkpoint: the forward calls it once per chunk and the backward once
    more per chunk (the recompute)."""
    calls = []
    inner = step_lib._chunk_ce
    monkeypatch.setattr(step_lib, "_chunk_ce", lambda *a: calls.append(a[0].shape[1]) or inner(*a))
    h = torch.randn(2, 30, 8, requires_grad=True)
    head = torch.randn(8, 20, requires_grad=True)
    labels = torch.randint(0, 20, (2, 30))
    loss = step_lib.chunked_ce(h, head, labels, 8, 1e-4)
    assert calls == [8] * 4
    loss.backward()
    assert calls == [8] * 8 and h.grad.shape == h.shape


# ---------------------------------------------------------------------------
# AdamW, the schedule, int8 quantisation
# ---------------------------------------------------------------------------

def test_schedule_matches_reference():
    cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    ref_cfg = ref_opt.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    steps = np.arange(0, 60, dtype=np.float32)
    want = np.asarray(ref_opt.schedule(ref_cfg, jnp.asarray(steps)))
    got = opt.schedule(cfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(opt.schedule(cfg, torch.tensor(0.0))) == 0.0


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("state_dtype", ["f32", "bf16", "int8"])
def test_adamw_update_matches_reference(state_dtype):
    rng = np.random.default_rng(1)
    # bf16 parameters, as training keeps them; one leaf not a multiple of
    # the int8 block, one nested
    shapes = {"w": (8, 40), "b": {"u": (300,), "z": (3, 5, 7)}}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s, dtype=np.float32), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype)
    ref_cfg, cfg = ref_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p0)
    p = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p0)
    ref_state, state = ref_opt.init_state(ref_p, ref_cfg), opt.init_state(p, cfg)
    for _ in range(5):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.02, p0)
        ref_p, ref_state, ref_m = ref_opt.adamw_update(
            ref_p, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g), ref_state, ref_cfg)
        p, state, m = opt.adamw_update(
            p, jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), g), state, cfg)
        assert float(m["grad_norm"]) < 1.0  # the clip factor is exactly 1 in both
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-5)
    assert int(state["step"]) == int(ref_state["step"]) == 5 and state["step"].dtype == torch.int32
    for got, want in zip(opt.leaves(p), jax.tree.leaves(ref_p)):
        assert got.dtype == torch.bfloat16
        want = _np(want)
        assert np.all(np.abs(_np(got) - want) <= _bf16_ulp(want)), state_dtype
    for got, want in zip(opt.leaves(state), jax.tree.leaves(ref_state)):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        assert tuple(got.shape) == want.shape
        want = _np(want)
        assert np.max(np.abs(_np(got) - want)) <= 1e-6 * np.max(np.abs(want)), state_dtype


def test_adamw_with_clipping_matches_reference():
    """Float32 moments and parameters with the global norm above the clip."""
    rng = np.random.default_rng(2)
    p0 = {"a": rng.standard_normal((64, 33), dtype=np.float32), "b": rng.standard_normal(17, dtype=np.float32)}
    kw = dict(lr=5e-3, warmup_steps=1, total_steps=4, grad_clip=0.5)
    ref_cfg, cfg = ref_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    ref_p = jax.tree.map(jnp.asarray, p0)
    p = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)
    ref_state, state = ref_opt.init_state(ref_p, ref_cfg), opt.init_state(p, cfg)
    for _ in range(4):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32), p0)
        ref_p, ref_state, ref_m = ref_opt.adamw_update(ref_p, jax.tree.map(jnp.asarray, g), ref_state, ref_cfg)
        p, state, m = opt.adamw_update(p, jax.tree.map(torch.from_numpy, g), state, cfg)
        assert float(m["grad_norm"]) > 0.5
    for got, want in zip(opt.leaves(p) + opt.leaves(state), jax.tree.leaves(ref_p) + jax.tree.leaves(ref_state)):
        want = _np(want)
        assert np.max(np.abs(_np(got) - want)) <= 1e-6 * np.max(np.abs(want))


def test_adamw_updates_in_place():
    p = {"w": torch.ones(10)}
    state = opt.init_state(p, opt.AdamWConfig(warmup_steps=1))
    w, m = p["w"], state["m"]["w"]
    p2, s2, _ = opt.adamw_update(p, {"w": torch.full((10,), 0.5)}, state, opt.AdamWConfig(warmup_steps=1))
    assert p2 is p and s2 is state and p2["w"] is w and s2["m"]["w"] is m
    assert bool((w < 1).all()) and bool((m > 0).all())


@pytest.mark.parametrize("n", [1000, 256, 7])
def test_quant_dequant_bit_identical(n):
    x = np.random.default_rng(n).standard_normal(n, dtype=np.float32) * 3
    x[0] = 0.0
    want = ref_opt._quant(jnp.asarray(x))
    got = opt._quant(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    assert np.array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert np.array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert np.array_equal(opt._dequant(got, (n,)).numpy(), np.asarray(ref_opt._dequant(want, (n,))))


@pytest.mark.parametrize("scale", [3.0, 1e-20, 0.0])
def test_compression_quantize_bit_identical(scale):
    g = np.random.default_rng(0).standard_normal((37, 5), dtype=np.float32) * scale
    wq, ws = ref_compression.quantize(jnp.asarray(g))
    q, s = compression.quantize(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(wq)) and float(s) == float(ws)
    assert np.array_equal(compression.dequantize(q, s).numpy(),
                          np.asarray(ref_compression.dequantize(wq, ws)))


def test_compressed_all_reduce_on_two_gloo_ranks_matches_reference():
    """Three steps of error feedback on 2 ranks: each rank's reduced
    gradients are the mean of both ranks' dequantised (g + e), and its
    new error is its own residual, as the reference's ``compressed_psum``."""
    world, steps = 2, 3
    rng = np.random.default_rng(5)
    grads = [[{"a": rng.standard_normal((4, 6), dtype=np.float32),
               "b": {"c": rng.standard_normal(9, dtype=np.float32)}} for _ in range(world)]
             for _ in range(steps)]
    got = meshlib.run_ranks(worker.compressed_reduce, world, devices=["cpu"] * world,
                            args=(grads,), timeout_s=120.0)
    errors = [jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), grads[0][0]) for _ in range(world)]
    for t in range(steps):
        deq, new_err = [], []
        for r in range(world):
            def one(g, e):
                gf = jnp.asarray(g) + e
                q, s = ref_compression.quantize(gf)
                d = ref_compression.dequantize(q, s)
                return d, gf - d
            pairs = jax.tree.map(one, grads[t][r], errors[r])
            deq.append(jax.tree.map(lambda x: x[0], pairs, is_leaf=lambda x: isinstance(x, tuple)))
            new_err.append(jax.tree.map(lambda x: x[1], pairs, is_leaf=lambda x: isinstance(x, tuple)))
        mean = jax.tree.map(lambda *xs: sum(xs) / world, *deq)
        errors = new_err
        for r in range(world):
            red, err = got[r][t]
            for g, w in zip(jax.tree.leaves(red), jax.tree.leaves(mean)):
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)
            for g, w in zip(jax.tree.leaves(err), jax.tree.leaves(errors[r])):
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,batch,vocab,seed", [(32, 4, 100, 9), (17, 3, 151936, 0)])
def test_token_pipeline_batches_identical(seq, batch, vocab, seed):
    ref = ref_pipeline.TokenPipeline(ref_pipeline.DataConfig(seq, batch, vocab, seed))
    port = pipeline.TokenPipeline(pipeline.DataConfig(seq, batch, vocab, seed))
    assert np.array_equal(port.next_tok, ref.next_tok)
    for step in (0, 1, 17):
        want, got = ref.batch(step), port.batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (step, k)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(rng):
    """A training-state-like tree: bf16 and f32 leaves, int8 moments with
    their scales, an int32 step."""
    return {
        "params": {"embed": rng.standard_normal((6, 4), dtype=np.float32).astype("bfloat16"),
                   "layers": {"s0": {"w": rng.standard_normal((2, 4, 3), dtype=np.float32)}}},
        "opt": {"step": np.int32(7),
                "m": {"embed": {"q": rng.integers(-127, 128, (1, 256)).astype(np.int8),
                                "scale": rng.random((1, 1), dtype=np.float32)}}},
    }


def _ref_tree(tree):
    import ml_dtypes

    def conv(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(ml_dtypes.bfloat16) if a.dtype.name == "bfloat16" else a)
    return jax.tree.map(conv, tree)


def _port_tree(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(conv, tree)


@pytest.fixture()
def state_tree():
    import ml_dtypes  # noqa: F401  (the 'bfloat16' numpy dtype name)

    return _tree(np.random.default_rng(0))


def _same(port_tree, ref_tree):
    got = dict(manager.leaves_with_paths(port_tree))
    want = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype) and tuple(g.shape) == w.shape, path
        assert np.array_equal(_np(g), np.asarray(w, np.float32)), path


def test_reference_checkpoint_restores_bit_identical_in_port(tmp_path, state_tree):
    ref_manager.CheckpointManager(str(tmp_path)).save(3, _ref_tree(state_tree))
    like = _port_tree(jax.tree.map(np.zeros_like, state_tree))
    step, got = manager.CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 3
    _same(got, _ref_tree(state_tree))


def test_port_checkpoint_restores_bit_identical_in_reference(tmp_path, state_tree):
    manager.CheckpointManager(str(tmp_path)).save(5, _port_tree(state_tree))
    like = _ref_tree(jax.tree.map(np.zeros_like, state_tree))
    step, got = ref_manager.CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 5
    _same(_port_tree(jax.tree.map(np.asarray, got)), _ref_tree(state_tree))
    # the manifests of both packages list the same leaves
    ref_dir = tmp_path / "ref"
    ref_manager.CheckpointManager(str(ref_dir)).save(5, _ref_tree(state_tree))
    load = lambda d: json.loads((d / "step_000005" / "manifest.json").read_text())
    assert load(tmp_path) == load(ref_dir)


def test_checkpoint_keep_and_atomicity(tmp_path):
    mgr = manager.CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    for step in (1, 2, 3):
        path = mgr.save(step, {"a": tree["a"] * step, "b": tree["b"]})
        assert not os.path.exists(path + ".tmp")
        assert os.path.exists(os.path.join(path, "manifest.json"))
    assert mgr.all_steps() == [2, 3]  # keep=2 collected step 1
    os.makedirs(tmp_path / "step_000009.tmp")  # an interrupted save is not a step
    step, restored = mgr.restore_latest(tree)
    assert step == 3 and torch.equal(restored["a"], tree["a"] * 3)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert manager.CheckpointManager(str(tmp_path / "empty")).restore_latest(tree) == (None, None)


def test_preemption_handler_sets_the_flag(tmp_path):
    import signal

    mgr = manager.CheckpointManager(str(tmp_path))
    old = signal.getsignal(signal.SIGTERM)
    try:
        mgr.install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert mgr.preempted
    finally:
        signal.signal(signal.SIGTERM, old)
