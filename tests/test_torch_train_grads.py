"""The training loss and every parameter's gradient against the
reference's ``jax.value_and_grad``, family by family (this file: dense
qwen1.5-0.5b, qwen3-32b (qk_norm), h2o-danube-3-4b (a window of 8 at S =
24) and starcoder2-3b, qwen2-moe, mamba2; ``test_torch_train_grads_mla.py``,
``_hybrid.py`` and ``_encdec.py`` the other four, so that the reference's
slow CPU draws and eager backwards spread over workers).

Both packages get the reference's weights (``params.from_reference`` of
``test_torch_families._ref_params``: seed 0, attention projections
rescaled) at ``reduce_config`` sizes, the same numpy-seeded tokens and
labels (some -1) and each package's stub frontend inputs.  Semantics are
held in float32: each package's bf16 activation casts patched to float32,
as ``test_torch_families``' float32 test does; the loss (CE, the MoE aux
loss, MTP's) within 1e-5 relative and every gradient leaf within max|Δ| <=
1e-3 × max|ref| (measured: at most 1.3e-5, jamba).  The reference's attention is
its XLA ``_sdpa_full`` (it trains through it); the port's is B.6's
autograd path (its plain forward here) with ``flash_attention_backward``,
every block under checkpoint (``remat``, both sides), the loss head
chunked (chunk 16 over 24 positions: two chunks, the second padded).

Dense also in bf16, unpatched: the loss within 2e-2 of the reference's.
And the port's own structure: a train step makes two B.6 forwards per
attention sublayer under remat (the forward and its recompute) and one
without, with equal gradients.  (``make_train_step`` against the
reference's: ``test_torch_train_driver.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro.models import transformer as ref_tf
from repro.train import step as ref_step
from repro_torch.data import pipeline
from repro_torch.kernels import flash_kernel
from repro_torch.models import params, transformer
from repro_torch.train import optimizer as opt, step as step_lib
from test_torch_families import _cfgs, _Float32Jnp, _ref_params

B, S, CHUNK = 2, 24, 16
F32_TOL = 1e-3


def _batch(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    labels[0, 3] = -1
    return tokens, labels


def _float32(monkeypatch):
    """Each package's bf16 activation casts as float32."""
    monkeypatch.setattr(ref_tf, "jnp", _Float32Jnp())
    monkeypatch.setattr(ref_tf._encode, "__defaults__", (jnp.float32,))
    monkeypatch.setattr(transformer, "_embed", lambda p, t: p["embed"].float()[t])
    monkeypatch.setattr(transformer._encode, "__defaults__", (torch.float32,))


def _both(name: str, dtype):
    """(ref cfg, ref params, port cfg, port params, ref batch, port batch)
    in ``dtype`` ('float32' or 'bfloat16')."""
    ref_cfg, cfg = _cfgs(name)
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), _ref_params(name))
    p = params.from_reference(jax.tree.map(np.array, ref_p), "cpu")
    tokens, labels = _batch(cfg)
    ref_b = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
             **{k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in ref_pipeline.stub_inputs(ref_cfg, B).items()}}
    b = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
         **{k: v.to(getattr(torch, dtype)) for k, v in pipeline.stub_inputs(cfg, B, device="cpu").items()}}
    return ref_cfg, ref_p, cfg, p, ref_b, b


def _port_value_and_grad(cfg, p, batch, tcfg):
    for leaf in opt.leaves(p):
        leaf.requires_grad_(True)
    loss, metrics = step_lib.loss_fn(p, cfg, tcfg, batch)
    loss.backward()
    return metrics, p


def check_family_grads(name: str, monkeypatch) -> None:
    """The float32 loss and every gradient leaf of ``name`` against the
    reference's."""
    _float32(monkeypatch)
    ref_cfg, ref_p, cfg, p, ref_b, b = _both(name, "float32")
    (_, want), ref_g = jax.value_and_grad(
        lambda pp: ref_step.loss_fn(pp, ref_cfg, ref_step.TrainConfig(ce_chunk=CHUNK), ref_b),
        has_aux=True)(ref_p)
    got, p = _port_value_and_grad(cfg, p, b, step_lib.TrainConfig(ce_chunk=CHUNK))
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(float(got[k].detach()) - float(want[k])) <= 1e-5 * abs(float(want[k])) + 1e-7, k
    flat = jax.tree_util.tree_flatten_with_path(ref_g)[0]
    assert len(flat) == len(opt.leaves(p))
    for path, w in flat:
        leaf = p
        for key in path:
            leaf = leaf[key.key]
        assert leaf.grad is not None and leaf.grad.dtype == torch.float32, path
        g, w = leaf.grad.numpy(), np.asarray(w)
        assert bool(np.isfinite(g).all()), path
        assert np.max(np.abs(g - w)) <= F32_TOL * np.max(np.abs(w)), (jax.tree_util.keystr(path),
                                                                      np.max(np.abs(g - w)))


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "qwen2-moe-a2.7b", "mamba2-1.3b", "qwen3-32b",
                                  "h2o-danube-3-4b", "starcoder2-3b"])
def test_float32_loss_and_grads_match_reference(name, monkeypatch):
    check_family_grads(name, monkeypatch)


def test_bf16_dense_loss_matches_reference():
    ref_cfg, ref_p, cfg, p, ref_b, b = _both("qwen1.5-0.5b", "bfloat16")
    want, _ = ref_step.loss_fn(ref_p, ref_cfg, ref_step.TrainConfig(ce_chunk=CHUNK), ref_b)
    got, p = _port_value_and_grad(cfg, p, b, step_lib.TrainConfig(ce_chunk=CHUNK))
    assert abs(float(got["loss"].detach()) - float(want)) <= 2e-2
    for leaf in opt.leaves(p):
        assert leaf.grad.dtype == torch.bfloat16 and bool(torch.isfinite(leaf.grad).all())


def test_remat_launches_b6_twice_per_attention_sublayer(monkeypatch):
    """B.6's forward runs once per attention sublayer in the forward and
    once more in the remat recompute; without remat once, and the
    gradients are the same."""
    _float32(monkeypatch)
    _ref_cfg, _ref_p, cfg, p, _ref_b, b = _both("qwen1.5-0.5b", "float32")
    calls = []
    forward = flash_kernel._forward
    monkeypatch.setattr(flash_kernel, "_forward", lambda *a: calls.append(1) or forward(*a))
    grads = {}
    for remat in (True, False):
        calls.clear()
        q = jax.tree.map(lambda t: t.detach().clone(), p)
        _, q = _port_value_and_grad(cfg, q, b, step_lib.TrainConfig(ce_chunk=CHUNK, remat=remat))
        assert len(calls) == (2 if remat else 1) * cfg.n_layers
        grads[remat] = [leaf.grad for leaf in opt.leaves(q)]
    for g1, g0 in zip(grads[True], grads[False]):
        assert torch.equal(g1, g0)
