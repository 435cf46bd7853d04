"""The model tests of ``test_torch_families.py`` for jamba (SSM +
attention + MoE) and deepseek-v3 (MLA + MoE + MTP), plus deepseek's naive
MLA decode and its MTP module against the reference.  That file's
docstring gives the tolerances and why.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tf
from repro_torch.models import params, transformer
from repro_torch.models.transformer import TransformerLM
from test_torch_families import (  # noqa: F401  (the shared tests and the fixture)
    B,
    S,
    _cfgs,
    _ref_params,
    _rel,
    _scale,
    check_sublayers,
    make_pair,
    shared_routing,
    test_bf16_bound_above_reference_sensitivity,
    test_decode_consistency_within_port,
    test_float32_forward_prefill_decode_match_reference,
    test_forward_matches_reference,
    test_from_reference_is_bit_exact,
    test_prefill_and_decode_match_reference,
)
from test_torch_models import reference_flash  # noqa: F401  (fixture)

HERE = ["jamba-v0.1-52b", "deepseek-v3-671b"]


@pytest.fixture(scope="module", params=HERE)
def pair(request):
    return make_pair(request.param)


@pytest.mark.parametrize("name", HERE)
def test_sublayers_match_reference(name, reference_flash):  # noqa: F811
    check_sublayers(name)


def test_mla_naive_decode_matches_reference(reference_flash):  # noqa: F811
    """deepseek's MLA decode, naive and absorbed, against the reference's on
    identical inputs: layer 0's weights, the reference's own prefill cache
    of 12 tokens and a bf16 input row, within 0.05 of max|y|; the latent
    and rope rows written at position 12 and the position counters equal.
    (Whole models are compared in test_prefill_and_decode_match_reference,
    on the absorbed path: at one more token a top-2 MoE router near-tie
    flips between the two packages' bf16 roundings — the reference's own
    absorbed decode leaves its own forward there by 0.19 of max|logit| —
    which is routing, not MLA.)  Then the port's two whole-model paths
    against each other (the reference's test_mla_absorb_matches_naive
    bound, 0.15)."""
    from repro.models import mla as ref_mla
    from repro_torch.models import mla

    ref_cfg, cfg = _cfgs("deepseek-v3-671b", mla_absorb=False)
    ref_p = _ref_params("deepseek-v3-671b")
    model = TransformerLM(cfg, params.from_reference(jax.tree.map(np.asarray, ref_p), "cpu"))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, 13)).astype(np.int32)
    _, want_cache = ref_tf.prefill(ref_p, ref_cfg, jnp.asarray(tokens[:, :12]), 32)
    ref_lp = jax.tree.map(lambda a: a[0], ref_p["dense"]["s0"]["mixer"])
    ref_cache = jax.tree.map(lambda a: a[0], want_cache["dense"]["s0"])
    lp = params.from_reference(jax.tree.map(np.asarray, ref_lp), "cpu")
    x = jnp.asarray(np.random.default_rng(4).standard_normal((B, 1, cfg.d_model), np.float32),
                    jnp.bfloat16)
    for absorb in (False, True):
        want, want_next = ref_mla.mla_decode(ref_lp, ref_cfg, x, ref_cache, absorb=absorb)
        # a copy: mla_decode writes its cache in place
        cache = params.from_reference(jax.tree.map(np.array, ref_cache), "cpu")
        got, nxt = mla.mla_decode(lp, cfg, params.from_reference(np.asarray(x), "cpu"), cache,
                                  absorb=absorb)
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert _rel(got, want, _scale(want)) < 0.05, absorb
        assert nxt["pos"].tolist() == np.asarray(want_next["pos"]).tolist() == [13] * B
        for k in ("ckv", "kr"):
            w = np.asarray(want_next[k], np.float32)[:, 12]
            assert np.max(np.abs(nxt[k].float().numpy()[:, 12] - w)) <= 0.05 * np.max(np.abs(w)), k
    _, cache = model.prefill(tokens[:, :12], 32)
    got, _ = model.decode_step(tokens[:, 12], cache)
    other = TransformerLM(dataclasses.replace(cfg, mla_absorb=True), model.params)
    _, cache = other.prefill(tokens[:, :12], 32)
    got_other, _ = other.decode_step(tokens[:, 12], cache)
    assert float((got - got_other).abs().max()) / (float(got.abs().max()) + 1e-6) < 0.15


def test_mtp_hidden_matches_reference(reference_flash):  # noqa: F811
    ref_cfg, cfg = _cfgs("deepseek-v3-671b")
    ref_p = _ref_params("deepseek-v3-671b")
    p = params.from_reference(jax.tree.map(np.asarray, ref_p), "cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    hidden = jnp.asarray(np.random.default_rng(3).standard_normal((B, S, cfg.d_model), np.float32),
                         jnp.bfloat16)
    want = ref_tf.mtp_hidden(ref_p, ref_cfg, jnp.asarray(tokens), hidden)
    got = transformer.mtp_hidden(p, cfg, torch.from_numpy(tokens).long(),
                                 params.from_reference(np.asarray(hidden), "cpu"))
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel(got, want, _scale(want)) < 0.05
    assert transformer.mtp_hidden(p, dataclasses.replace(cfg, mtp_depth=0), None, None) is None
