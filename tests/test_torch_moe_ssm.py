"""MoE dispatch and the SSM on identical inputs: the port's ``models.moe``
and ``models.ssm`` against the reference's.

* ``moe_fwd_einsum`` and ``moe_fwd_scatter`` on identical bf16 inputs at
  the default ``capacity_factor`` 1.25, where tokens are dropped: the same
  selected experts and kept slots (exactly), the same aux loss (within
  1e-6 relative), y within 1e-2 of max|y|; the port's ``ValueError``
  where the reference asserts on the group size.
* ``ssd_chunked`` at lengths that are and are not multiples of the chunk,
  from a zero and from a given state, and ``ssm_fwd`` / ``ssm_decode``'s
  output and state: within 2e-2 of max|·| (bf16 contractions summed in
  other orders; both agree to 1e-6 in float32), the conv ring exactly.
* the block's gradient at a 256-token chunk, where the reference's
  exp-then-mask decay overflows and its gradient is NaN (ROADMAP C.20):
  the port's is finite and equals its own at a 16-token chunk (the chunked
  algorithm is exact at any chunk; float64 weights and input, the decay
  and state in float32 as the port computes them), within 1e-4 of max|·|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro.models import params as ref_params
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.models import moe, params, ssm

B = 2


def _rel(got: torch.Tensor, want, scale: float) -> float:
    return float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32)))) / scale


def _scale(want) -> float:
    return float(jnp.max(jnp.abs(want))) + 1e-6


# ---------------------------------------------------------------------------
# MoE dispatch on identical inputs, drops included
# ---------------------------------------------------------------------------

def _ref_routing(p, cfg, x, impl: str):
    """The reference's routing integers, transcribed from
    ``repro.models.moe`` (which computes them inline): top-k experts and
    each (token, slot)'s kept flag, [groups, tokens, k]."""
    mo = cfg.moe
    b, s, d = x.shape
    n, e, k = b * s, mo.n_routed, mo.top_k
    gsz = min(ref_moe.MOE_GROUP_SIZE, n) if impl == "einsum" else n
    xg = x.reshape(n // gsz, gsz, d)
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", xg.astype(jnp.float32),
                                      p["router"].astype(jnp.float32)), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    capacity = int(np.ceil(gsz * k / e * mo.capacity_factor))
    if impl == "scatter":
        onehot = jax.nn.one_hot(top_e.reshape(-1), e, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
        return np.asarray(top_e), np.asarray(pos < capacity).reshape(top_e.shape)
    fill = jnp.zeros((xg.shape[0], e), jnp.int32)
    keep = []
    for j in range(k):
        eo = jax.nn.one_hot(top_e[..., j], e, dtype=jnp.int32)
        pos = fill[:, None, :] + jnp.cumsum(eo, axis=1) - eo
        keep.append(jnp.sum(pos * eo, axis=-1) < capacity)
        fill = fill + jnp.sum(eo, axis=1)
    return np.asarray(top_e), np.asarray(jnp.stack(keep, axis=-1))


@pytest.fixture(scope="module")
def moe_inputs():
    """Reduced qwen2-moe's MoE layer at the default capacity_factor 1.25
    (4 experts, top-2, shared expert), 2 × 256 tokens leaning to one
    expert so that its capacity overflows."""
    ref_cfg = ref_configs.reduce_config(ref_configs.get_config("qwen2-moe-a2.7b"))
    cfg = configs.reduce_config(configs.get_config("qwen2-moe-a2.7b"))
    assert cfg.moe.capacity_factor == 1.25
    ref_p = jax.tree.map(np.asarray, ref_params.materialize(ref_moe.moe_specs(ref_cfg),
                                                             jax.random.PRNGKey(5)))
    ref_p["router"] = (ref_p["router"].astype(np.float32) * 10).astype(ref_p["router"].dtype)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 256, cfg.d_model), dtype=np.float32)
    x += 0.5 * np.asarray(ref_p["router"], np.float32)[:, 0]  # lean to expert 0
    x_ref = jnp.asarray(x, jnp.bfloat16)
    x_t = torch.from_numpy(np.asarray(x_ref, np.float32)).to(torch.bfloat16)
    return ref_cfg, cfg, ref_p, params.from_reference(ref_p, "cpu"), x_ref, x_t


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_dispatch_matches_reference(moe_inputs, impl):
    ref_cfg, cfg, ref_p, p, x_ref, x_t = moe_inputs
    ref_fn = {"einsum": ref_moe.moe_fwd_einsum, "scatter": ref_moe.moe_fwd_scatter}[impl]
    route = {"einsum": moe.route_einsum, "scatter": moe.route_scatter}[impl]
    fn = {"einsum": moe.moe_fwd_einsum, "scatter": moe.moe_fwd_scatter}[impl]
    want_e, want_keep = _ref_routing(ref_p, ref_cfg, x_ref, impl)
    r = route(p, cfg, x_t)
    assert np.array_equal(r["top_e"].numpy(), want_e)
    assert np.array_equal(r["keep"].numpy(), want_keep)
    assert not want_keep.all() and want_keep.any()  # drops happen
    want_y, want_aux = ref_fn(ref_p, ref_cfg, x_ref)
    y, aux = fn(p, cfg, x_t)
    assert y.dtype == torch.bfloat16 and y.shape == x_t.shape
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    assert _rel(y, want_y, _scale(want_y)) < 1e-2


def test_moe_group_size_raises_where_reference_asserts(moe_inputs):
    ref_cfg, cfg, ref_p, p, x_ref, x_t = moe_inputs
    with pytest.raises(AssertionError):
        ref_moe.moe_fwd_einsum(ref_p, ref_cfg, x_ref[:, :150])  # 300 tokens
    with pytest.raises(ValueError, match="multiple"):
        moe.moe_fwd_einsum(p, cfg, x_t[:, :150])
    moe.moe_fwd_einsum(p, cfg, x_t[:, :100])  # 200 <= 256: one group


def test_moe_switch_selects_the_rule(moe_inputs, monkeypatch):
    _ref_cfg, cfg, _ref_p, p, _x_ref, x_t = moe_inputs
    for impl, fn in (("einsum", moe.moe_fwd_einsum), ("scatter", moe.moe_fwd_scatter)):
        monkeypatch.setattr(moe, "MOE_IMPL", impl)
        assert torch.equal(moe.moe_fwd(p, cfg, x_t)[0], fn(p, cfg, x_t)[0])


# ---------------------------------------------------------------------------
# SSD: chunked scan and the decode recurrence
# ---------------------------------------------------------------------------

def _close(got: torch.Tensor, want, tol: float = 2e-2) -> None:
    assert tuple(got.shape) == np.shape(want)
    assert _rel(got, want, _scale(want)) < tol


@pytest.mark.parametrize("s", [37, 16, 5])
def test_ssd_chunked_matches_reference(s):
    rng = np.random.default_rng(s)
    b, nh, hd, g, ds, chunk = 2, 4, 8, 1, 16, 16
    x = jnp.asarray(rng.standard_normal((b, s, nh, hd), dtype=np.float32), jnp.bfloat16)
    dt = jnp.asarray(rng.uniform(0.01, 0.5, (b, s, nh)).astype(np.float32))
    A = -jnp.asarray(rng.uniform(0.5, 2.0, nh).astype(np.float32))
    Bm = jnp.asarray(rng.standard_normal((b, s, g, ds), dtype=np.float32), jnp.bfloat16)
    Cm = jnp.asarray(rng.standard_normal((b, s, g, ds), dtype=np.float32), jnp.bfloat16)
    h0 = jnp.asarray(rng.standard_normal((b, nh, ds, hd), dtype=np.float32))
    t = lambda a: params.from_reference(np.asarray(a), "cpu")  # noqa: E731
    for init in (None, h0):
        want_y, want_h = ref_ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk, init)
        y, h = ssm.ssd_chunked(t(x), t(dt), t(A), t(Bm), t(Cm), chunk, None if init is None else t(init))
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
        _close(y, want_y)
        _close(h, want_h)


def test_ssm_decode_state_matches_reference():
    ref_cfg = ref_configs.reduce_config(ref_configs.get_config("mamba2-1.3b"))
    cfg = configs.reduce_config(configs.get_config("mamba2-1.3b"))
    ref_p = jax.tree.map(np.asarray, ref_params.materialize(ref_ssm.ssm_specs(ref_cfg),
                                                             jax.random.PRNGKey(7)))
    p = params.from_reference(ref_p, "cpu")
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal((B, 9, cfg.d_model), dtype=np.float32), jnp.bfloat16)
    want_y, want_st = ref_ssm.ssm_fwd(ref_p, ref_cfg, u)
    t = lambda a: params.from_reference(np.asarray(a), "cpu")  # noqa: E731
    y, st = ssm.ssm_fwd(p, cfg, t(u))
    _close(y, want_y)
    for k in ("h", "conv"):
        _close(st[k], want_st[k])
    assert st["pos"].tolist() == [9] * B
    u1 = jnp.asarray(rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32), jnp.bfloat16)
    want_y1, want_st1 = ref_ssm.ssm_decode(ref_p, ref_cfg, u1, want_st)
    state = {k: t(v) for k, v in want_st.items()}
    y1, st1 = ssm.ssm_decode(p, cfg, t(u1), state)
    assert st1 is state  # updated in place
    _close(y1, want_y1)
    _close(st1["h"], want_st1["h"])
    assert np.array_equal(st1["conv"].float().numpy(), np.asarray(want_st1["conv"], np.float32))
    assert st1["pos"].tolist() == [10] * B
    fresh = ssm.init_ssm_state(cfg, B, device="cpu")
    want_fresh = ref_ssm.init_ssm_state(ref_cfg, B)
    for k, v in want_fresh.items():
        assert tuple(fresh[k].shape) == v.shape and str(fresh[k].dtype).endswith(str(v.dtype))


def test_ssm_gradient_is_finite_past_the_decay_overflow():
    """S = 512 tokens in one 256-token chunk pair: the reference's gradient
    of the decay parameters is NaN there, the port's is finite and equal to
    its gradient at chunk 16."""
    import dataclasses

    ref_cfg = ref_configs.reduce_config(ref_configs.get_config("mamba2-1.3b"))
    ref_cfg = dataclasses.replace(ref_cfg, ssm=dataclasses.replace(ref_cfg.ssm, chunk=256))
    ref_p = ref_params.materialize(ref_ssm.ssm_specs(ref_cfg), jax.random.PRNGKey(0))
    u = np.random.default_rng(1).standard_normal((B, 512, ref_cfg.d_model)).astype(np.float32)
    g = jax.grad(lambda p: ref_ssm.ssm_fwd(p, ref_cfg, jnp.asarray(u))[0].astype(jnp.float32).sum())(ref_p)
    assert not bool(jnp.isfinite(g["A_log"]).all())

    def grads(chunk: int) -> dict:
        cfg = configs.reduce_config(configs.get_config("mamba2-1.3b"))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
        p = {k: torch.from_numpy(np.asarray(v, np.float64)).requires_grad_(True) for k, v in ref_p.items()}
        ssm.ssm_fwd(p, cfg, torch.from_numpy(u).double(), state=False)[0].sum().backward()
        return {k: t.grad for k, t in p.items()}

    long, short = grads(256), grads(16)
    for k in long:
        assert bool(torch.isfinite(long[k]).all()), k
        scale = float(short[k].abs().max()) + 1e-30
        assert float((long[k] - short[k]).abs().max()) / scale < 1e-4, k
