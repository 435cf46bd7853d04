"""MoE dispatch over a (data, model) mesh against the unsplit layer.

Reduced qwen2-moe's MoE layer (4 experts, top-2, a shared expert) on 4
gloo ranks at 2×2 (``torch_train_worker.moe_layer``): each rank holds 2
experts (expert parallelism) and half the shared expert's width, and its
data rank's rows of the batch.  The router leans to one expert and the
capacity factor is 0.5, so tokens drop.  Each case makes a dispatch group
span both data ranks:

* 'einsum' at 4 × 12 and 4 × 11 tokens (one group of 48 or 44, as every
  decode step's is) and at 4 × 192 (groups of 256 that straddle the
  ranks' 384 tokens);
* 'scatter' at 4 × 12 and 4 × 11 (one group of 48 or 44).

At capacity 12 (and 3 groups of 64) the buffer's rows split over the data
ranks; at capacity 11 they do not, and the experts' input width is split
instead (``moe._experts_over``).

Held, on every rank against the unsplit layer in one process (float32):
each of its tokens' experts and kept flags exactly; y, the aux loss, x's
gradient and every weight's gradient (summed over 'data', this rank's
shard of it) within 1e-5 of their largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_train_worker as worker
from repro_torch import configs
from repro_torch.launch import mesh as meshlib
from repro_torch.models import moe, params as params_lib
from repro_torch.train import sharding

CASES = [("einsum", 4, 12), ("einsum", 4, 11), ("einsum", 4, 192), ("scatter", 4, 12), ("scatter", 4, 11)]
CF = 0.5
TOL = 1e-5
GRID = {"data": 2, "model": 2}


def _inputs(b: int, s: int):
    cfg = configs.reduce_config(configs.get_config("qwen2-moe-a2.7b"))
    weights = params_lib.materialize(moe.moe_specs(cfg), 5, torch.float32, "cpu")
    weights["router"] = weights["router"] * 10
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    x += 0.5 * weights["router"][:, 0].numpy()  # lean to expert 0
    wy = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    return params_lib._map_tree(lambda t: t.numpy(), weights), x, wy


def _unsplit(impl, weights, x, wy) -> dict:
    base = configs.reduce_config(configs.get_config("qwen2-moe-a2.7b"))
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=CF))
    p = params_lib._map_tree(lambda a: torch.from_numpy(a).requires_grad_(True), weights)
    xt = torch.from_numpy(x).requires_grad_(True)
    saved, moe.MOE_IMPL = moe.MOE_IMPL, impl
    try:
        with torch.no_grad():
            r = (moe.route_einsum if impl == "einsum" else moe.route_scatter)(p, cfg, xt)
        y, aux = moe.moe_fwd(p, cfg, xt)
    finally:
        moe.MOE_IMPL = saved
    ((y * torch.from_numpy(wy)).sum() + aux).backward()
    k = cfg.moe.top_k
    return {"top_e": r["top_e"].reshape(-1, k).numpy(), "keep": r["keep"].reshape(-1, k).numpy(),
            "y": y.detach().numpy(), "aux": float(aux.detach()), "x_grad": xt.grad.numpy(),
            "grads": params_lib._map_tree(lambda t: t.grad.numpy(), p)}


@pytest.fixture(scope="module")
def both():
    """[(the unsplit run, every rank's run)] per case: one 4-rank spawn."""
    runs, whole = [], []
    for impl, b, s in CASES:
        weights, x, wy = _inputs(b, s)
        runs.append((impl, CF, weights, x, wy))
        whole.append(_unsplit(impl, weights, x, wy))
    ranks = meshlib.run_ranks(worker.moe_layer, 4, devices=["cpu"] * 4, grid=GRID, args=(runs,),
                              timeout_s=240.0)
    return [(whole[i], [r[i] for r in ranks]) for i in range(len(CASES))]


def _close(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{i}-{b}x{s}" for i, b, s in CASES])
def test_spanning_group_routes_as_unsplit(both, case):
    want, ranks = both[case]
    assert not want["keep"].all() and want["keep"].any()  # drops happen
    _impl, b, s = CASES[case]
    for r in ranks:
        lo, hi = r["rows"]
        tok = slice(lo * s, hi * s)
        assert np.array_equal(r["top_e"], want["top_e"][tok]), r["coords"]
        assert np.array_equal(r["keep"], want["keep"][tok]), r["coords"]
    assert all(r["spans"] for r in ranks)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{i}-{b}x{s}" for i, b, s in CASES])
def test_spanning_group_output_and_gradients_as_unsplit(both, case):
    want, ranks = both[case]
    mesh_of = {r["coords"]["data"] * 2 + r["coords"]["model"]: r for r in ranks}
    for rank, r in mesh_of.items():
        lo, hi = r["rows"]
        assert _close(r["y"], want["y"][lo:hi]) <= TOL, r["coords"]
        assert abs(r["aux"] - want["aux"]) <= TOL * abs(want["aux"])
        assert _close(r["x_grad"], want["x_grad"][lo:hi]) <= TOL, r["coords"]
        mesh = meshlib.dry_grid_mesh(GRID, rank=rank, device="cpu")

        def check(got, spec, full):
            assert _close(got, full[sharding.shard_index(full.shape, spec, mesh)]) <= TOL, (r["coords"], spec)

        _walk(r["grads"], r["specs"], want["grads"], check)


def _walk(got, specs, want, check):
    if isinstance(got, dict):
        for k in got:
            _walk(got[k], specs[k], want[k], check)
        return
    check(got, specs, want)
