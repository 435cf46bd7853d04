"""Int8 moments over a (data, model) mesh: replicated, as the reference
places them, each updated whole (``train.optimizer``).

Exact with the same gradient: on 2×2 and 2×1 gloo CPU ranks (float32
parameters and gradients; at 2×2 bf16 too), three AdamW steps on the
shards of four leaves — [6, 50] split over both axes (300
values: not a multiple of ``Q_BLOCK``, its shards' boundaries inside
blocks), [10, 37] over 'data' (the boundary at value 185 of the first
block), [512] replicated and [4, 200] over 'model' — each given a whole
gradient cut to the rank's shards and the clip's norm, give every rank
'q' and 'scale' equal bit for bit to those of the same steps at 1×1, and
parameter shards equal bit for bit to the 1×1 parameters' shards.

Checkpoints (``launch.train`` on reduced qwen1.5-0.5b, float32 on every
rank, ``--state-dtype int8``): a 2×2 run resumes the 1×1 step-0
checkpoint of the conditioned draw and writes its moments once (rank 0)
every 2 steps.  Its step-2 checkpoint resumed at 2×2 gives its steps 2
and 3 bit for bit (parameters and moments restored exactly).  Resumed at
1×1 and at 2×1 it gives step 2, which reads the restored parameters only,
within 1e-5 relative, and step 3 within ``INT8_TOL``: there the gradient's
float32 rounding, which differs between meshes, can move a moment across
a rounding boundary of its int8 level, one level being 1/127 of its
block's largest |value| (measured 1.5e-5 at 2×1).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import torch_train_worker as worker
from repro_torch.launch import mesh as meshlib, train
from repro_torch.train import optimizer as opt, sharding
from test_torch_train_mesh import ARGV, TOL, rel, spawn

SHAPES = {"a": (6, 50), "b": (10, 37), "c": (512,), "d": (4, 200)}
SPECS = {"a": ("data", "model"), "b": ("data", None), "c": (None,), "d": (None, "model")}
GRIDS = {"2x2": {"data": 2, "model": 2}, "2x1": {"data": 2, "model": 1}}
STEPS = 3


def _draws():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    norms = [float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in tree.values()))) for tree in grads]
    return params, grads, norms


def _single(dtype: str) -> dict:
    """The same steps at 1×1: parameters (as float32) and moments (numpy)."""
    params, grads, norms = _draws()
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, state_dtype="int8")
    cast = getattr(torch, dtype)
    p = {k: torch.from_numpy(v.copy()).to(cast) for k, v in params.items()}
    state = opt.init_state(p, cfg)
    for g, norm in zip(grads, norms):
        opt.adamw_update(p, {k: torch.from_numpy(v).to(cast) for k, v in g.items()}, state, cfg,
                         grad_norm=torch.tensor(norm))
    return {"params": {k: v.float().numpy() for k, v in p.items()},
            **{name: {k: {part: t.numpy() for part, t in d.items()} for k, d in state[name].items()}
               for name in ("m", "v")}}


@pytest.mark.parametrize("grid,dtype", [("2x2", "float32"), ("2x1", "float32"), ("2x2", "bfloat16")])
def test_sharded_int8_update_is_bit_identical_to_1x1(grid, dtype):
    params, grads, norms = _draws()
    single = _single(dtype)
    shape = GRIDS[grid]
    world = shape["data"] * shape["model"]
    ranks = meshlib.run_ranks(worker.int8_updates, world, devices=["cpu"] * world, grid=shape,
                              args=(params, SPECS, grads, norms, dtype), timeout_s=120.0)
    for r, got in enumerate(ranks):
        mesh = meshlib.dry_grid_mesh(shape, rank=r, device="cpu")
        for name in ("m", "v"):
            for k in SHAPES:
                for part in ("q", "scale"):
                    assert np.array_equal(got[name][k][part], single[name][k][part]), (grid, r, name, k, part)
        for k, want in single["params"].items():
            want = want[sharding.shard_index(want.shape, SPECS[k], mesh)]
            assert got["params"][k].shape == want.shape and np.array_equal(got["params"][k], want), (grid, r, k)
        start = torch.from_numpy(params["a"]).to(getattr(torch, dtype)).float().numpy()
        assert not np.array_equal(got["params"]["a"], start[sharding.shard_index((6, 50), SPECS["a"], mesh)])


ARCH, RESUME_AT = "qwen1.5-0.5b", 2
INT8_TOL = 1e-4


def _args(mesh, ckpt_dir) -> dict:
    return vars(train.parse_args(ARGV + ["--arch", ARCH, "--mesh", mesh, "--ckpt-dir", ckpt_dir,
                                         "--ckpt-every", str(RESUME_AT), "--state-dtype", "int8"]))


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8_mesh")
    worker.write_start(str(tmp / "full"), _args("1x1", ""))
    full = spawn("2x2", [_args("2x2", str(tmp / "full"))])
    out = {}
    for mesh in ("2x2", "1x1", "2x1"):
        ckpt = tmp / f"resume_{mesh}"
        os.makedirs(ckpt)
        shutil.copytree(tmp / "full" / f"step_{RESUME_AT:06d}", ckpt / f"step_{RESUME_AT:06d}")
        out[mesh] = spawn(mesh, [_args(mesh, str(ckpt))])[0][0]
    return full, out


def test_2x2_int8_checkpoint_resumes_exactly_on_2x2(resumed):
    full, out = resumed
    assert out["2x2"]["lines"][0] == f"[train] resumed from step {RESUME_AT}"
    assert out["2x2"]["losses"] == full[0][0]["losses"][RESUME_AT:]


def test_int8_mesh_run_resumes_a_1x1_checkpoint(resumed):
    full, _ = resumed
    assert full[0][0]["lines"][0] == "[train] resumed from step 0"
    assert all(r[0]["losses"] == full[0][0]["losses"] for r in full)
    assert len(full[0][0]["losses"]) == 4 and np.all(np.isfinite(full[0][0]["losses"]))


@pytest.mark.parametrize("mesh", ["1x1", "2x1"])
def test_2x2_int8_checkpoint_resumes_on_another_mesh(resumed, mesh):
    full, out = resumed
    got = out[mesh]
    want = full[0][0]["losses"][RESUME_AT:]
    assert got["lines"][0] == f"[train] resumed from step {RESUME_AT}"
    assert rel(got["losses"][:1], want[:1]) <= TOL, (got["losses"], want)
    assert rel(got["losses"], want) <= INT8_TOL, (got["losses"], want)
