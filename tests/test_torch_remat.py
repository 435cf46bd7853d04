"""The block's remat policy (``models.transformer.REMAT_POLICY``): the
reference's 'full' | 'dots' | 'none'.

* The float32 loss and every gradient leaf of reduced qwen1.5-0.5b and
  qwen2-moe under each policy against the reference's
  ``jax.value_and_grad`` with its ``REMAT_POLICY`` set the same way (the
  weights, batch and float32 patches of ``test_torch_train_grads``):
  within 1e-5 relative, leaves of their max |g|.
* What a block keeps for the backward, seen through
  ``torch.autograd.graph.saved_tensors_hooks`` on one qwen2-moe block
  (its projections ``mm``, its experts ``bmm``): under 'full' only the
  block's inputs; under 'dots' the same through the hooks, its ``mm``
  outputs held by the selective checkpoint instead — its backward runs no
  ``mm`` beyond the 'none' backward's and every ``bmm`` of the forward
  again; under 'none' the most, ``mm`` and ``bmm`` outputs among them.
* B.6's forward calls in a train step: 2 per attention layer under 'full'
  and 'dots' (the forward and its recompute), 1 under 'none'.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import transformer as ref_tf
from repro.train import step as ref_step
from repro_torch.kernels import flash_kernel
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt, step as step_lib
from test_torch_train_grads import CHUNK, _both, _float32, _port_value_and_grad

POLICIES = ("full", "dots", "none")
TOL = 1e-5


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "qwen2-moe-a2.7b"])
def test_gradients_match_the_reference_under_each_policy(name, policy, monkeypatch):
    _float32(monkeypatch)
    monkeypatch.setattr(ref_tf, "REMAT_POLICY", policy)
    monkeypatch.setattr(transformer, "REMAT_POLICY", policy)
    ref_cfg, ref_p, cfg, p, ref_b, b = _both(name, "float32")
    (_, want), ref_g = jax.value_and_grad(
        lambda pp: ref_step.loss_fn(pp, ref_cfg, ref_step.TrainConfig(ce_chunk=CHUNK), ref_b), has_aux=True)(ref_p)
    got, p = _port_value_and_grad(cfg, p, b, step_lib.TrainConfig(ce_chunk=CHUNK))
    assert abs(float(got["loss"].detach()) - float(want["loss"])) <= TOL * abs(float(want["loss"]))
    flat = jax.tree_util.tree_flatten_with_path(ref_g)[0]
    assert len(flat) == len(opt.leaves(p))
    for path, w in flat:
        leaf = p
        for key in path:
            leaf = leaf[key.key]
        g, w = leaf.grad.numpy(), np.asarray(w)
        assert np.max(np.abs(g - w)) <= TOL * np.max(np.abs(w)), (jax.tree_util.keystr(path), policy)


class _Ops(TorchDispatchMode):
    """Counts each op's calls, and maps each output's storage to the op
    that made it."""

    def __init__(self):
        super().__init__()
        self.calls, self.made = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.calls[func] = self.calls.get(func, 0) + 1
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.made.setdefault(t.untyped_storage().data_ptr(), func)
        return out


MM, BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default


def _one_block(policy: str, monkeypatch) -> dict:
    """qwen2-moe's MoE block under ``policy``: the tensors the hooks saw
    (with the op that made each, None for an input), and the ``mm`` /
    ``bmm`` calls of the backward."""
    _float32(monkeypatch)
    monkeypatch.setattr(transformer, "REMAT_POLICY", policy)
    _ref_cfg, _ref_p, cfg, p, _ref_b, _b = _both("qwen2-moe-a2.7b", "float32")
    plan = transformer.group_plans(cfg)[-1]
    lp = transformer._index(p[plan.name], 0)
    lp = jax.tree.map(lambda t: t.detach().clone().requires_grad_(True), lp)
    x, positions = torch.randn(2, 24, cfg.d_model, requires_grad=True), torch.arange(24)
    inputs = {t.untyped_storage().data_ptr() for t in [x, positions, *jax.tree.leaves(lp)]}
    saved = []
    ops = _Ops()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t), ops:
        y, aux = transformer._remat(transformer._block_fwd, lp, cfg, plan, x, positions, None, None)
    made = {ptr: (None if ptr in inputs else op) for ptr, op in ops.made.items()}
    back = _Ops()
    with back:
        (y.square().sum() + aux).backward()
    return {"saved": [made.get(t.untyped_storage().data_ptr()) for t in saved],
            "mm": back.calls.get(MM, 0), "bmm": back.calls.get(BMM, 0), "fwd_bmm": ops.calls.get(BMM, 0)}


def test_each_policy_saves_what_the_reference_saves(monkeypatch):
    runs = {policy: _one_block(policy, monkeypatch) for policy in POLICIES}
    full, dots, none = runs["full"], runs["dots"], runs["none"]
    assert full["saved"] and set(full["saved"]) == {None}  # the block's inputs only
    assert set(dots["saved"]) == {None}  # mm outputs go to the selective checkpoint's store
    assert len(none["saved"]) > len(full["saved"]) and {MM, BMM} <= set(none["saved"])
    assert full["mm"] > none["mm"]  # 'full' runs the forward's products again
    assert dots["mm"] == none["mm"]  # 'dots' does not: they were saved
    assert dots["bmm"] == none["bmm"] + dots["fwd_bmm"] == full["bmm"]  # every bmm recomputed


@pytest.mark.parametrize("policy,per_layer", [("full", 2), ("dots", 2), ("none", 1)])
def test_b6_forward_calls_per_attention_layer(policy, per_layer, monkeypatch):
    _float32(monkeypatch)
    monkeypatch.setattr(transformer, "REMAT_POLICY", policy)
    _ref_cfg, _ref_p, cfg, p, _ref_b, b = _both("qwen1.5-0.5b", "float32")
    calls = []
    forward = flash_kernel._forward
    monkeypatch.setattr(flash_kernel, "_forward", lambda *a: calls.append(1) or forward(*a))
    _port_value_and_grad(cfg, p, b, step_lib.TrainConfig(ce_chunk=CHUNK))
    assert len(calls) == per_layer * cfg.n_layers
