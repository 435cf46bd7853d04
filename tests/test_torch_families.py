"""Parity of the non-dense LM families: the port's ``models`` against the
reference's on the reference's own weights (``params.from_reference``), at
``reduce_config`` sizes.

Six archs, one per family: qwen2-moe (MoE), mamba2 (SSM), the jamba hybrid
(SSM + attention + MoE), llama-3.2-vision (cross-attention to patches),
whisper (encoder-decoder) and deepseek-v3 (MLA + MoE + multi-token
prediction).  Per arch: the spec tree and the init rule, ``from_reference``
bit for bit, ``forward`` (and its aux loss), ``prefill`` with every cache
leaf (int32 leaves exact), one ``decode_step`` (deepseek's MLA decode both
absorbed and naive), and the port's own prefill/decode consistency.
Semantics are held in float32: both packages run every family with
float32 weights and activations (each package's bf16 activation casts
patched to float32 for that test), and forward, prefill and decode agree
within 1e-3 of max|logit| (measured at most 6e-5).

In bf16 the tolerance is 0.05 of max|logit|, the reference's own
consistency bound (``tests/test_models.py``), and for jamba the
reference's 0.35 hybrid bound.  The weights are the reference's draws
(``materialize``, seed 0) with the attention projections rescaled
(``_conditioned``): at reduced widths the reference's init rule (fan-in =
shape[-2]) draws a projection onto four heads with a standard deviation of
0.5, not 1/sqrt(d_model) = 0.125, so attention is near-argmax and the
model chaotic — one bf16 ulp on one weight moved its logits by 0.79 of
max|logit| for jamba, 0.41 for llama-3.2-vision, 0.29 for whisper, a
bound no comparison can meet.  Each projection is rescaled to 1/sqrt(its
input width); both packages get the same weights, and the init rule
itself is held on the untouched draw
(``test_specs_match_reference_and_init_rule``).  The premise is tested:
the reference's own move under that one-ulp nudge (``_one_ulp``, the
witness ``chip_smoke.py`` also prints) is below the bound
(``test_bf16_bound_above_reference_sensitivity``).  jamba stays chaotic
on the rescaled weights — its MoE routing (top-2 of 4, router logits of
standard deviation ~0.16) flips on near-ties, and its one-ulp move with
the router free is 0.35, the bound itself (ROADMAP C.17) — so its bf16
run is held with the router's choices shared between the packages
(``SHARED_ROUTING``, fixture ``shared_routing``): the reference's top-k
records each call's experts, in call order, and the port's router takes
them in the same order, its own probabilities gathered there; the
reference's one-ulp witness replays its first run's choices into the
nudged one.  Everything else of the MoE layer (the router's
probabilities, the capacity fill, the experts, the combine) runs as
without the tape.  Every sublayer of every family is held on its own,
fed the reference's input, within 0.05 of its output
(``test_sublayers_match_reference``).
The encoder's and the cross-attention's frontend inputs come from
each package's ``stub_inputs`` (equal bit for bit).

MoE layers in the model tests run at ``capacity_factor`` 8, the reference
test's setting: at the default 1.25 a bf16 difference in a router input
can move a token across an expert's capacity and drop a different token,
which is the semantics, not a fault.  The drops themselves, SSD and the
SSM decode state are held on identical inputs in ``test_torch_moe_ssm.py``.

Attention on the reference side: causal calls on its Pallas flash kernel,
non-causal ones on its XLA ``_sdpa_full`` (fixture ``reference_flash`` of
``test_torch_models``, which says why).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as ref_pipeline
from repro.models import moe as ref_moe
from repro.models import params as ref_params
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import moe, params, ssm, transformer
from repro_torch.models.transformer import TransformerLM
from test_torch_models import reference_flash  # noqa: F401  (fixture)

FAMILIES = ["qwen2-moe-a2.7b", "mamba2-1.3b", "jamba-v0.1-52b", "llama-3.2-vision-11b",
            "whisper-base", "deepseek-v3-671b"]
# the archs whose model tests run in this file; the other four run the same
# tests in test_torch_families_attn.py and test_torch_families_jamba_mla.py
# (three files, so that three workers share the reference's slow CPU draws
# and forwards)
HERE = ["qwen2-moe-a2.7b", "mamba2-1.3b"]
B, S, MAX_SEQ = 2, 20, 48


# the arch whose bf16 whole-model runs share the router's choices (module docstring)
SHARED_ROUTING = {"jamba-v0.1-52b"}


def _tol(cfg) -> float:
    return 0.35 if (cfg.ssm is not None and cfg.moe is not None) else 0.05


def _one_ulp(ref_cfg, ref_p, tokens, ref_ex, routing=None) -> float:
    """How far the reference's forward moves, in max|logit|, when block 0's
    first norm scale (1.0) moves one bf16 ulp (its XLA attention, compiled
    once for both calls; with ``routing``, a ``_SharedRouting``, the nudged
    run is compiled apart and takes the first run's router choices)."""
    def fwd(p):
        return ref_tf.forward(p, ref_cfg, jnp.asarray(tokens), remat=False, **ref_ex)[0]

    run = jax.jit(fwd)
    want = run(ref_p)
    group = ref_tf.group_plans(ref_cfg)[0].name
    nudged = jax.tree.map(lambda a: a, ref_p)
    norm = nudged[group]["s0"]["mixer_norm"]
    norm["scale"] = norm["scale"].at[0, 0].add(2.0 ** -7)
    if routing is not None:
        routing.replay_reference()
        run = jax.jit(lambda p: fwd(p))
    moved = run(nudged)
    if routing is not None:
        routing.consumed()
    return float(jnp.max(jnp.abs(moved - want))) / _scale(want)


class _SharedRouting:
    """The router's choices shared between the packages: the reference's
    ``jax.lax.top_k`` in ``repro.models.moe`` appends each call's experts
    to a tape (an ordered ``jax.debug.callback``, so it works under jit and
    scan); the port's ``torch.topk`` in ``repro_torch.models.moe`` takes
    them off it in call order and gathers its own probabilities there.
    After ``replay_reference`` the reference's top-k takes them off the
    tape too (an ordered ``io_callback``)."""

    def __init__(self, monkeypatch):
        from jax.experimental import io_callback

        self.tape, self.replaying = [], False
        top_k = jax.lax.top_k

        def ref_top_k(probs, k):
            if self.replaying:
                idx = io_callback(lambda: self.tape.pop(0), jax.ShapeDtypeStruct(probs.shape[:-1] + (k,), jnp.int32),
                                  ordered=True)
                return jnp.take_along_axis(probs, idx, axis=-1), idx
            vals, idx = top_k(probs, k)
            jax.debug.callback(lambda a: self.tape.append(np.asarray(a, np.int32)), idx, ordered=True)
            return vals, idx

        def port_topk(probs, k, dim=-1):
            jax.effects_barrier()
            idx = torch.tensor(self.tape.pop(0), dtype=torch.long).reshape(*probs.shape[:-1], k)
            return probs.gather(-1, idx), idx

        monkeypatch.setattr(ref_moe, "jax", _With(jax, lax=_With(jax.lax, top_k=ref_top_k)))
        monkeypatch.setattr(moe, "torch", _With(torch, topk=port_topk))

    def replay_reference(self) -> None:
        jax.effects_barrier()
        self.replaying = True

    def consumed(self) -> None:
        """Check that every recorded choice was taken (one router call on
        each side for each)."""
        jax.effects_barrier()
        assert not self.tape, f"{len(self.tape)} router calls of the reference were not replayed"


class _With:
    """``module`` with some attributes replaced."""

    def __init__(self, module, **attrs):
        self._module = module
        self.__dict__.update(attrs)

    def __getattr__(self, name):
        return getattr(self._module, name)


@pytest.fixture
def shared_routing(pair, monkeypatch):
    """A ``_SharedRouting`` for an arch of ``SHARED_ROUTING``, else None."""
    return _SharedRouting(monkeypatch) if pair[2].cfg.name.removesuffix("-smoke") in SHARED_ROUTING else None


def _generous(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _cfgs(name, **kw):
    ref_cfg = _generous(ref_configs.reduce_config(ref_configs.get_config(name)))
    cfg = _generous(configs.reduce_config(configs.get_config(name)))
    return dataclasses.replace(ref_cfg, **kw), dataclasses.replace(cfg, **kw)


def _conditioned(specs: dict, tree: dict) -> dict:
    """``tree`` with every attention projection (a leaf with a heads axis)
    rescaled from the init rule's 1/sqrt(shape[-2]) to 1/sqrt(its input
    width): the model axis for Q/K/V and MLA's up-projections' latent axis,
    heads × head_dim for the output projection."""
    def go(spec, a):
        if spec.init != "normal" or not {"heads", "kv_heads"} & set(spec.axes):
            return a
        dims = [(ax, n) for ax, n in zip(spec.axes, spec.shape) if ax not in ("layers", "experts")]
        fan_in = dims[0][1] * dims[1][1] if dims[0][0] in ("heads", "kv_heads") else dims[0][1]
        return (a.astype(jnp.float32) * np.sqrt(spec.shape[-2] / fan_in)).astype(a.dtype)

    return jax.tree.map(go, specs, tree, is_leaf=lambda x: isinstance(x, ref_params.ParamSpec))


@functools.lru_cache(maxsize=None)
def _ref_params(name: str) -> dict:
    """The reference's weights for ``name`` (seed 0), attention projections
    rescaled (``_conditioned``), drawn once per module."""
    ref_cfg, _ = _cfgs(name)
    specs = ref_tf.model_specs(ref_cfg)
    return _conditioned(specs, ref_params.materialize(specs, jax.random.PRNGKey(0)))


def _rel(got: torch.Tensor, want, scale: float) -> float:
    return float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32)))) / scale


def _scale(want) -> float:
    return float(jnp.max(jnp.abs(want))) + 1e-6


def make_pair(name: str):
    """(ref cfg, ref params, port model, tokens [B, S + 1], ref extra
    inputs, port extra inputs, the bf16 bound) for one family."""
    ref_cfg, cfg = _cfgs(name)
    ref_p = _ref_params(name)
    model = TransformerLM(cfg, params.from_reference(jax.tree.map(np.asarray, ref_p), "cpu"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    ref_ex = ref_pipeline.stub_inputs(ref_cfg, B)
    return (ref_cfg, ref_p, model, tokens, ref_ex, pipeline.stub_inputs(cfg, B, device="cpu"), _tol(cfg))


@pytest.fixture(scope="module", params=HERE)
def pair(request):
    return make_pair(request.param)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}['{k}']")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", FAMILIES)
def test_specs_match_reference_and_init_rule(name):
    ref_cfg, cfg = _cfgs(name)
    ref_flat = jax.tree_util.tree_flatten_with_path(
        ref_tf.model_specs(ref_cfg), is_leaf=lambda x: isinstance(x, ref_params.ParamSpec)
    )[0]
    want = {jax.tree_util.keystr(path): (s.shape, s.axes, s.init, s.scale) for path, s in ref_flat}
    got = {path: (s.shape, s.axes, s.init, s.scale) for path, s in _leaves(transformer.model_specs(cfg))}
    assert got == want
    # the reference's init rule on this tree: fan_in = shape[-2] for every
    # leaf of rank >= 3 (stacked layers, stacked experts), spec.scale where
    # it is set
    tree = dict(_leaves(params.materialize(transformer.model_specs(cfg), seed=1,
                                           dtype=torch.float32, device="cpu")))
    for path, spec in _leaves(transformer.model_specs(cfg)):
        t = tree[path]
        if spec.init != "normal" or t.numel() < 4096:
            continue
        fan_in = spec.shape[-2] if len(spec.shape) >= 3 else spec.shape[0]
        want_std = spec.scale if spec.scale is not None else 1 / np.sqrt(fan_in)
        assert abs(float(t.std()) / want_std - 1) < 0.1, path


def test_from_reference_is_bit_exact(pair):
    ref_p = jax.tree.map(np.asarray, pair[1])
    got = dict(_leaves(params.from_reference(ref_p, "cpu")))
    want = dict(_leaves(ref_p))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).endswith(str(w.dtype)), path
        assert np.array_equal(g.float().numpy(), w.astype(np.float32)), path


@pytest.mark.parametrize("name", ["whisper-base", "llama-3.2-vision-11b"])
def test_stub_inputs_equal_reference(name):
    ref_cfg, cfg = _cfgs(name)
    want = ref_pipeline.stub_inputs(ref_cfg, 3)
    got = pipeline.stub_inputs(cfg, 3, device="cpu")
    assert got.keys() == want.keys() and len(got) == 1
    for k in want:
        assert got[k].dtype == torch.bfloat16
        assert np.array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))


def test_bf16_bound_above_reference_sensitivity(pair, reference_flash, shared_routing):  # noqa: F811
    """The premise of the bf16 comparisons: the reference's own logits
    (its attention as in the comparisons) move by less than the bound when
    one weight moves one bf16 ulp — with the router's choices of the
    first run kept for the arch that shares them."""
    ref_cfg, ref_p, _model, tokens, ref_ex, _ex, bound = pair
    one_ulp = _one_ulp(ref_cfg, ref_p, tokens, ref_ex, shared_routing)
    assert one_ulp < bound, (one_ulp, bound)


def _taken(routing) -> None:
    if routing is not None:
        routing.consumed()


def test_forward_matches_reference(pair, reference_flash, shared_routing):  # noqa: F811
    ref_cfg, ref_p, model, tokens, ref_ex, ex, bound = pair
    want, want_aux = ref_tf.forward(ref_p, ref_cfg, jnp.asarray(tokens), remat=False, **ref_ex)
    got, aux = transformer.forward(model.params, model.cfg, torch.from_numpy(tokens).long(), **ex)
    _taken(shared_routing)
    assert got.shape == (B, S + 1, ref_cfg.vocab_size) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want, _scale(want)) < bound
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(want_aux)) <= 0.05 * abs(float(want_aux)) + 1e-9


def _prefill_both(pair):
    ref_cfg, ref_p, model, tokens, ref_ex, ex, _bound = pair
    want_pre, want_cache = ref_tf.prefill(ref_p, ref_cfg, jnp.asarray(tokens[:, :S]), MAX_SEQ, **ref_ex)
    got_pre, cache = model.prefill(tokens[:, :S], MAX_SEQ, **ex)
    return ref_cfg, model, want_pre, want_cache, got_pre, cache


def _check_cache(cache, want_cache, tol):
    want_leaves = jax.tree_util.tree_flatten_with_path(want_cache)[0]
    assert sum(1 for _ in _leaves(cache)) == len(want_leaves)
    for path, want in want_leaves:
        got = cache
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape, path
        if want.dtype == jnp.int32:
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want)), path
        else:  # K/V, latents, SSM states: projections of bf16 activations
            assert str(got.dtype).endswith(str(want.dtype)), path
            assert bool(torch.isfinite(got).all()), path
            err = np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32)))
            assert err <= tol * float(jnp.max(jnp.abs(want))) + 1e-6, path


def test_prefill_and_decode_match_reference(pair, reference_flash, shared_routing):  # noqa: F811
    ref_cfg, model, want_pre, want_cache, got_pre, cache = _prefill_both(pair)
    _taken(shared_routing)
    tol = pair[-1]
    assert bool(torch.isfinite(got_pre).all())
    assert _rel(got_pre, want_pre, _scale(want_pre)) < tol
    _check_cache(cache, want_cache, tol)
    tokens = pair[3]
    want_dec, _ = ref_tf.decode_step(pair[1], ref_cfg, jnp.asarray(tokens[:, S]), want_cache)
    got_dec, cache = model.decode_step(tokens[:, S], cache)
    _taken(shared_routing)
    assert got_dec.shape == tuple(want_dec.shape) and bool(torch.isfinite(got_dec).all())
    assert _rel(got_dec, want_dec, _scale(want_dec)) < tol
    for _path, leaf in _leaves(cache):  # every position counter moved on
        if leaf.dtype == torch.int32 and leaf.dim() == 2 and _path.endswith("['pos']"):
            assert leaf.tolist() == [[S + 1] * B] * leaf.shape[0]


def test_float32_forward_prefill_decode_match_reference(pair, monkeypatch):
    """The same weights and inputs in float32 through both packages, each
    package's bf16 activation casts (embedding, encoder input, caches)
    patched to float32: forward, prefill and one decode step agree within
    1e-3 of max|logit|.  Attention is the reference's XLA ``_sdpa_full``
    and the port's plain flash version, both in float32."""
    ref_cfg, ref_p, model, tokens, ref_ex, ex, _bound = pair
    f32 = jnp.float32
    monkeypatch.setattr(ref_tf, "jnp", _Float32Jnp())
    monkeypatch.setattr(ref_tf._encode, "__defaults__", (f32,))
    monkeypatch.setattr(ref_tf.init_cache, "__defaults__", (f32, 0))
    monkeypatch.setattr(transformer, "_embed", lambda p, t: p["embed"].float()[t])
    monkeypatch.setattr(transformer._encode, "__defaults__", (torch.float32,))
    monkeypatch.setattr(transformer.init_cache, "__defaults__", (torch.float32, 0, None))
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, f32), ref_p)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_p)
    ref_ex = {k: jnp.asarray(v, f32) for k, v in ref_ex.items()}
    ex = {k: v.float() for k, v in ex.items()}
    cfg, tok = model.cfg, torch.from_numpy(tokens).long()
    want, _ = ref_tf.forward(ref_p, ref_cfg, jnp.asarray(tokens), remat=False, **ref_ex)
    got, _ = transformer.forward(p, cfg, tok, **ex)
    assert _rel(got, want, _scale(want)) < 1e-3
    want, want_cache = ref_tf.prefill(ref_p, ref_cfg, jnp.asarray(tokens[:, :S]), MAX_SEQ, **ref_ex)
    got, cache = transformer.prefill(p, cfg, tok[:, :S], MAX_SEQ, **ex)
    assert _rel(got, want, _scale(want)) < 1e-3
    _check_cache(cache, want_cache, 1e-3)
    want, _ = ref_tf.decode_step(ref_p, ref_cfg, jnp.asarray(tokens[:, S]), want_cache)
    got, _ = transformer.decode_step(p, cfg, tok[:, S], cache)
    assert _rel(got, want, _scale(want)) < 1e-3


class _Float32Jnp:
    """``jax.numpy`` with ``bfloat16`` standing for ``float32``: the
    reference's model assembly casts activations to ``jnp.bfloat16``."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_decode_consistency_within_port(pair):
    """The port's prefill + decode reproduce its own full forward (the
    reference's test_decode_consistency, on the port; MLA on its naive
    path, as there)."""
    model, tokens, ex = pair[2], pair[3], pair[5]
    if model.cfg.mla is not None:
        model = TransformerLM(dataclasses.replace(model.cfg, mla_absorb=False), model.params)
    full = model(tokens, **ex)
    pre, cache = model.prefill(tokens[:, :S], MAX_SEQ, **ex)
    dec, _ = model.decode_step(tokens[:, S], cache)
    scale = float(full.abs().max()) + 1e-6
    tol = _tol(model.cfg)
    assert float((pre - full[:, S - 1]).abs().max()) / scale < tol
    assert float((dec - full[:, S]).abs().max()) / scale < tol


def check_sublayers(name: str) -> None:
    """Every sublayer of ``name``'s reduced model — each mixer (attention,
    cross-attention, MLA, SSM; whisper's encoder layers too) and each
    feed-forward (MLP, MoE) — fed the reference's own input (teacher
    forcing through the reference's forward), within 0.05 of the largest
    value of the reference's output; each MoE aux loss within 1e-6
    relative; the encoder side (the VLM's ``_encode``, whisper's final
    encoder norm) within 0.05.  Held layer by
    layer, the chaos of the bf16 end-to-end comparison (ROADMAP C.17)
    cannot hide a wrong layer."""
    from repro.models import layers as ref_layers
    from repro.models import mla as ref_mla
    from repro_torch.models import layers, mla

    ref_cfg, cfg = _cfgs(name)
    ref_p = _ref_params(name)
    p = params.from_reference(jax.tree.map(np.asarray, ref_p), "cpu")
    t = lambda a: params.from_reference(np.asarray(a), "cpu")  # noqa: E731
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    ref_ex = ref_pipeline.stub_inputs(ref_cfg, B)
    enc_out, _ = ref_tf._encode(ref_p, ref_cfg, ref_ex.get("frames"), ref_ex.get("patches"))
    if cfg.vision is not None:
        got, _ = transformer._encode(p, cfg, None, t(ref_ex["patches"]))
        assert _rel(got, enc_out, _scale(enc_out)) < 0.05

    def mixer_fwd(pkg_layers, pkg_mla, pkg_ssm, lp, c, h, positions, mixer, memory):
        if mixer == "ssm":
            return pkg_ssm.ssm_fwd(lp, c, h)[0]
        if mixer == "mla":
            return pkg_mla.mla_fwd(lp, c, h, positions)
        if mixer == "cross":
            return pkg_layers.attention_fwd(lp, c, h, positions, causal=False, kv_x=memory)
        return pkg_layers.attention_fwd(lp, c, h, positions, causal=mixer == "attn",
                                        window=c.sliding_window if mixer == "attn" else 0)

    def run(stack, tstack, n, subs, x, positions):
        for li in range(n):
            for i, (mixer, ffn) in enumerate(subs):
                lp = jax.tree.map(lambda a: a[li], stack[f"s{i}"])
                tp = transformer._index(tstack, li)[f"s{i}"]
                h = ref_layers.norm_fwd(lp["mixer_norm"], ref_cfg, x)
                want = mixer_fwd(ref_layers, ref_mla, ref_ssm, lp["mixer"], ref_cfg, h, positions,
                                 mixer, enc_out)
                got = mixer_fwd(layers, mla, ssm, tp["mixer"], cfg, t(h), torch.from_numpy(
                    np.asarray(positions)), mixer, None if enc_out is None else t(enc_out))
                assert _rel(got, want, _scale(want)) < 0.05, (li, i, mixer)
                x = x + want
                if ffn == "none":
                    continue
                h = ref_layers.norm_fwd(lp["ffn_norm"], ref_cfg, x)
                if ffn == "moe":
                    want, want_aux = ref_moe.moe_fwd(lp["ffn"], ref_cfg, h)
                    got, aux = moe.moe_fwd(tp["ffn"], cfg, t(h))
                    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux)), (li, i)
                else:
                    want = ref_layers.mlp_fwd(lp["ffn"], ref_cfg, h)
                    got = layers.mlp_fwd(tp["ffn"], cfg, t(h))
                assert _rel(got, want, _scale(want)) < 0.05, (li, i, ffn)
                x = x + want
        return x

    if cfg.encoder is not None:  # the encoder's layers, then its final norm
        e = ref_ex["frames"].astype(jnp.bfloat16) + ref_p["enc_pos"].astype(jnp.bfloat16)[None]
        e = run(ref_p["encoder"], p["encoder"], cfg.encoder.n_layers, (("enc_attn", "mlp"),), e,
                jnp.arange(e.shape[1]))
        got = layers.norm_fwd(p["enc_final_norm"], cfg, t(e))
        assert _rel(got, enc_out, _scale(enc_out)) < 0.05
    x = ref_p["embed"].astype(jnp.bfloat16)[jnp.asarray(tokens)]
    for plan in ref_tf.group_plans(ref_cfg):
        x = run(ref_p[plan.name], p[plan.name], plan.n, plan.sublayers, x, jnp.arange(S))


@pytest.mark.parametrize("name", HERE)
def test_sublayers_match_reference(name, reference_flash):  # noqa: F811
    check_sublayers(name)
