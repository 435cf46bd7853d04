"""Dense decoder parity: the port's ``models`` against the reference's on
the reference's own weights, carried across by ``params.from_reference``.

Each dense arch, reduced by ``reduce_config`` (the port's copy must equal
the reference's field for field), runs ``forward``, ``prefill`` (logits and
every cache entry) and ``decode_step`` through both packages.  Tolerance:
0.05 of max|logit|, the reference's own decode-consistency bound
(``tests/test_models.py``).  h2o-danube's reduced window is 8, so the
20-token prompt goes through the sliding-window ring buffer.

The reference's full-sequence attention runs through its own Pallas flash
kernel, ``repro.kernels.ops.flash_attention`` (interpret mode on the CPU),
which the port's B.6 ports: fixture ``reference_flash`` routes the
reference's ``layers._sdpa_full`` to it, with the causal flag and window
that ``attention_fwd`` asked ``_mask_bias`` for (the dense path's positions
are ``arange(S)``, so the kernel's index mask is the position mask).  The
reference's XLA ``_sdpa_full`` rounds the scores to bf16 first, which the
Pallas kernel and B.6 do not.  Decode runs the reference's own
``attention_decode``, unchanged, which rounds scores and probabilities to
bf16; the port's decode keeps them in float32 (``models/layers.py`` says
why).  Largest measured gaps, in % of max|logit|: forward 4.8
(starcoder2-3b; qwen1.5-0.5b 2.4, h2o-danube 1.4, qwen3-32b 0.7), prefill
1.0 (h2o-danube), decode 1.8 (starcoder2-3b; bf16 decode would give 0.5
there) — bf16 rounded at other places in the two frameworks (rounding the
flash kernel's probabilities to bf16 before P·V, as the Pallas kernel
does, leaves them unchanged).  The port's own prefill and decode against
its forward: 0.0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels import ops as ref_ops
from repro.models import layers as ref_layers
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.models import params, transformer
from repro_torch.models.transformer import TransformerLM

DENSE = ["qwen1.5-0.5b", "qwen3-32b", "h2o-danube-3-4b", "starcoder2-3b"]
OTHER = sorted(set(configs.ARCHS) - set(DENSE))
TOL = 0.05
B, S = 2, 20


def _cfgs(name):
    ref_cfg = ref_configs.reduce_config(ref_configs.get_config(name))
    cfg = configs.reduce_config(configs.get_config(name))
    return ref_cfg, cfg


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(ref cfg, ref params, port model, tokens [B, S + 1]) per dense arch."""
    ref_cfg, cfg = _cfgs(request.param)
    ref_p = ref_params.materialize(ref_tf.model_specs(ref_cfg), jax.random.PRNGKey(0))
    model = TransformerLM(cfg, params.from_reference(jax.tree.map(np.asarray, ref_p), "cpu"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return ref_cfg, ref_p, model, tokens


@pytest.fixture
def reference_flash(monkeypatch):
    """The reference's ``_sdpa_full`` routed to its Pallas flash kernel, for
    this test only.  ``attention_fwd`` builds the mask with ``_mask_bias``
    just before it calls ``_sdpa_full``; the causal flag and window it asked
    for are static, so they are read there and handed to the kernel."""
    mask_bias = ref_layers._mask_bias
    asked = {}

    def record(q_pos, k_pos, causal, window):
        asked.update(causal=causal, window=window)
        return mask_bias(q_pos, k_pos, causal, window)

    def sdpa(q, k, v, bias):
        return ref_ops.flash_attention(q, k, v, causal=asked["causal"], window=asked["window"])

    monkeypatch.setattr(ref_layers, "_mask_bias", record)
    monkeypatch.setattr(ref_layers, "_sdpa_full", sdpa)


def _rel(got: torch.Tensor, want, scale: float) -> float:
    return float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32)))) / scale


@pytest.mark.parametrize("name", list(configs.ARCHS))
def test_reduced_configs_equal_reference(name):
    ref_cfg, cfg = _cfgs(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.params_count() == ref_cfg.params_count()
    assert cfg.head_dim == ref_cfg.head_dim


@pytest.mark.parametrize("name", DENSE)
def test_specs_match_reference_and_init_rule(name):
    ref_cfg, cfg = _cfgs(name)
    ref_flat = jax.tree_util.tree_flatten_with_path(
        ref_tf.model_specs(ref_cfg), is_leaf=lambda x: isinstance(x, ref_params.ParamSpec)
    )[0]
    want = {jax.tree_util.keystr(path): (s.shape, s.axes, s.init) for path, s in ref_flat}
    got = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}['{k}']")
            else:
                got[f"{prefix}['{k}']"] = (v.shape, v.axes, v.init)

    walk(transformer.model_specs(cfg), "")
    assert got == want
    # the reference's init rule, fan_in = shape[-2] for stacked specs
    p = params.materialize({"w": params.ParamSpec((4, 256, 8, 16), ("layers", "embed", None, None))},
                           seed=1, dtype=torch.float32, device="cpu")
    assert abs(float(p["w"].std()) - 1 / np.sqrt(8)) < 0.01


def test_from_reference_is_bit_exact():
    ref_cfg, _ = _cfgs("qwen1.5-0.5b")
    ref_p = ref_params.materialize(ref_tf.model_specs(ref_cfg), jax.random.PRNGKey(3))
    got = params.from_reference(jax.tree.map(np.asarray, ref_p), "cpu")
    wq_ref = np.asarray(ref_p["layers"]["s0"]["mixer"]["wq"]).astype(np.float32)
    wq = got["layers"]["s0"]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == wq_ref.shape
    assert np.array_equal(wq.float().numpy(), wq_ref)


def test_forward_matches_reference(pair, reference_flash):
    ref_cfg, ref_p, model, tokens = pair
    want, _ = ref_tf.forward(ref_p, ref_cfg, jnp.asarray(tokens), remat=False)
    got = model(tokens)
    assert got.shape == (B, S + 1, ref_cfg.vocab_size) and got.dtype == torch.float32
    scale = float(jnp.max(jnp.abs(want))) + 1e-6
    assert _rel(got, want, scale) < TOL


def test_prefill_and_decode_match_reference(pair, reference_flash):
    ref_cfg, ref_p, model, tokens = pair
    max_seq = 48
    want_pre, want_cache = ref_tf.prefill(ref_p, ref_cfg, jnp.asarray(tokens[:, :S]), max_seq)
    got_pre, cache = model.prefill(tokens[:, :S], max_seq)
    scale = float(jnp.max(jnp.abs(want_pre))) + 1e-6
    assert _rel(got_pre, want_pre, scale) < TOL

    want_leaves = jax.tree_util.tree_flatten_with_path(want_cache)[0]
    assert len(want_leaves) == 4 * len(cache)  # k, v, pos, slot_pos per group
    for path, want in want_leaves:
        got = cache
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape, path
        if want.dtype == jnp.int32:
            assert np.array_equal(got.numpy(), np.asarray(want)), path
        else:  # K, V: bf16 projections of slightly different bf16 activations
            err = np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32)))
            assert err <= 0.05 * float(jnp.max(jnp.abs(want))) + 1e-6, path

    want_dec, _ = ref_tf.decode_step(ref_p, ref_cfg, jnp.asarray(tokens[:, S]), want_cache)
    got_dec, cache = model.decode_step(tokens[:, S], cache)
    scale = float(jnp.max(jnp.abs(want_dec))) + 1e-6
    assert _rel(got_dec, want_dec, scale) < TOL
    assert cache["layers"]["s0"]["pos"].tolist() == [[S + 1] * B] * ref_cfg.n_layers


def test_decode_consistency_within_port(pair):
    """The port's prefill + decode reproduce its own full forward (the
    reference's test_decode_consistency, on the port)."""
    _ref_cfg, _ref_p, model, tokens = pair
    full = model(tokens)
    pre, cache = model.prefill(tokens[:, :S], 48)
    dec, _ = model.decode_step(tokens[:, S], cache)
    scale = float(full.abs().max()) + 1e-6
    assert float((pre - full[:, S - 1]).abs().max()) / scale < TOL
    assert float((dec - full[:, S]).abs().max()) / scale < TOL


@pytest.mark.parametrize("name", OTHER)
def test_non_dense_archs_raise(name):
    _, cfg = _cfgs(name)
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        transformer.model_specs(cfg)
