"""The Mamba2 block over a (data, model) mesh against the unsplit block.

Reduced mamba2's SSM block (d_in 128 in 8 heads, conv_dim 160, chunk 16),
float32, every leaf drawn from one numpy seed (the norm, A_log, dt_bias,
D and conv_b too, so that each gradient is exercised), runs on 4 gloo CPU
ranks at 2×2 and at 1×4 (``models.ssm`` under
``layers.enable_activation_sharding``; each rank its model-axis shards of
the reference's placement and its rows of the batch) and, in this process,
unsplit.  S = 40 tokens: three chunks, the last padded.  Held within 1e-5
of max|value|:

* the block's output rows and the final state: 'h' (the rank's heads)
  and 'conv' (its even slice of conv_dim, which is not its x channels:
  40 a rank against 32 of x at M = 4);
* every weight's gradient (the rank's shard; ``wbc``'s and ``conv_w``'s
  B/C columns included, summed over the data ranks by ``sync_grads``) and
  the input's, for the loss Σ y·g with a seeded g;
* 4 decode steps from the prefill state: each step's output rows and the
  final 'h' / 'conv' shards;
* each cache shard equals its slice of the unsplit state under
  ``launch.mesh.cache_pspec_for``.

Two planted faults must fail it (2×2): the gated norm's sum of squares
left unreduced over 'model' (``sharding.sum_over`` made the identity),
and ``wbc`` used without ``copy_to`` (its gradient then a rank's part).
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as meshlib
from repro_torch.models import params as params_lib, ssm
from repro_torch.train import sharding

B, S, N_DECODE = 4, 40, 4
TOL = 1e-5
GRIDS = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}}
FAULTS = ("norm", "wbc")


def _cfg():
    return configs.reduce_config(configs.get_config("mamba2-1.3b"))


def _draw() -> dict:
    """The block's weights, the input, the output's cotangent and the
    decode inputs (numpy, seed 0)."""
    cfg = _cfg()
    rng = np.random.default_rng(0)
    weights = {}
    for name, spec in sorted(ssm.ssm_specs(cfg).items()):
        scale = 1.0 / np.sqrt(spec.shape[0]) if len(spec.shape) > 1 else 0.5
        weights[name] = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
    weights["norm"] += 1.0
    d = cfg.d_model
    return {"weights": weights,
            "u": rng.standard_normal((B, S, d)).astype(np.float32),
            "g": rng.standard_normal((B, S, d)).astype(np.float32),
            "steps": rng.standard_normal((N_DECODE, B, 1, d)).astype(np.float32)}


def _run(cfg, weights: dict, u, g, steps, mesh=None, place=None) -> dict:
    """The block's forward, backward and decode on ``weights`` (this rank's
    shards over ``mesh``) and rows ``u`` / ``g`` / ``steps``."""
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in weights.items()}
    x = torch.from_numpy(u).requires_grad_(True)
    y, state = ssm.ssm_fwd(p, cfg, x)
    (y * torch.from_numpy(g)).sum().backward()
    if mesh is not None:
        sharding.sync_grads(p, place, mesh)
    out = {"y": y.detach().numpy(), "prefill": {k: v.detach().numpy().copy() for k, v in state.items()},
           "grads": {k: t.grad.numpy() for k, t in p.items()}, "du": x.grad.numpy(), "decode": []}
    state = {k: v.detach() for k, v in state.items()}
    with torch.no_grad():
        for step in steps:
            y, state = ssm.ssm_decode({k: t.detach() for k, t in p.items()}, cfg, torch.from_numpy(step), state)
            out["decode"].append(y.numpy())
    out["final"] = {k: v.numpy() for k, v in state.items()}
    return out


def _placement(mesh) -> dict:
    """The reference's placement of the block's leaves on ``mesh``,
    'embed' whole: the block sees weights gathered over the batch axes."""
    return params_lib.validate_divisibility(ssm.ssm_specs(_cfg()), mesh, meshlib.rules_for(mesh, fsdp=False))


def rank(mesh, draw: dict, fault: str | None) -> dict:
    """One rank: its shards and rows through ``_run`` (with ``fault``
    planted), reported with its coordinates and the leaves' placements."""
    from repro_torch.models import layers

    torch.set_num_threads(1)
    cfg = _cfg()
    saved = sharding.sum_over, sharding.copy_to
    if fault == "norm":
        sharding.sum_over = lambda x, mesh, axes="model": x
    elif fault == "wbc":
        wbc_shape = draw["weights"]["wbc"].shape
        sharding.copy_to = lambda x, mesh, axes="model": x if tuple(x.shape) == wbc_shape else saved[1](x, mesh, axes)
    layers.enable_activation_sharding(mesh)
    try:
        place = _placement(mesh)
        local = {k: sharding.shard_of(torch.from_numpy(v), place[k], mesh).numpy() for k, v in draw["weights"].items()}
        ba = meshlib.batch_axes(mesh)
        share = B // mesh.axis_size(ba)
        rows = slice(mesh.axis_index(ba) * share, (mesh.axis_index(ba) + 1) * share)
        out = _run(cfg, local, draw["u"][rows], draw["g"][rows], draw["steps"][:, rows], mesh, place)
    finally:
        layers.disable_activation_sharding()
        sharding.sum_over, sharding.copy_to = saved
    out.update(rank=mesh.rank, rows=(rows.start, rows.stop), place=place)
    return out


def ranks(mesh, draw: dict, faults: tuple) -> list:
    """``rank`` for each planted fault (None: none) in one spawn."""
    return [rank(mesh, draw, f) for f in faults]


@pytest.fixture(scope="module")
def results():
    """{grid: (the unsplit run, {fault: every rank's report})}."""
    draw = _draw()
    whole = _run(_cfg(), draw["weights"], draw["u"], draw["g"], draw["steps"])
    out = {}
    for name, grid in GRIDS.items():
        faults = (None, *FAULTS) if name == "2x2" else (None,)
        reps = meshlib.run_ranks(ranks, 4, devices=["cpu"] * 4, grid=grid, args=(draw, faults), timeout_s=240.0)
        out[name] = (whole, {f: [r[i] for r in reps] for i, f in enumerate(faults)})
    return out


def _gap(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)


def _state_slice(key: str, want: np.ndarray, mesh) -> np.ndarray:
    """This rank's shard of a whole state leaf [B, ...] under
    ``cache_pspec_for`` (which places it with a leading layer axis)."""
    shape = (1, *want.shape)
    return want[None][sharding.shard_index(shape, meshlib.cache_pspec_for(key, shape, mesh), mesh)][0]


def _gaps(whole: dict, reps: list, grid: dict) -> dict:
    """The largest gap of each held quantity over the ranks."""
    gaps: dict = {}

    def note(key, got, want):
        assert got.shape == want.shape, (key, got.shape, want.shape)
        gaps[key] = max(gaps.get(key, 0.0), _gap(got, want))

    for r in reps:
        mesh = meshlib.dry_grid_mesh(grid, rank=r["rank"], device="cpu")
        rows = slice(*r["rows"])
        note("y", r["y"], whole["y"][rows])
        note("du", r["du"], whole["du"][rows])
        for k, g in r["grads"].items():
            note(f"grad {k}", g, whole["grads"][k][sharding.shard_index(whole["grads"][k].shape, r["place"][k], mesh)])
        for phase in ("prefill", "final"):
            for k in ("h", "conv"):
                note(f"{phase} {k}", r[phase][k], _state_slice(k, whole[phase][k], mesh))
            assert np.array_equal(r[phase]["pos"], whole[phase]["pos"][rows]), phase
        for i, got in enumerate(r["decode"]):
            note(f"decode {i}", got, whole["decode"][i][rows])
    return gaps


@pytest.mark.parametrize("grid", list(GRIDS))
def test_output_and_state_match_unsplit(results, grid):
    whole, by_fault = results[grid]
    gaps = _gaps(whole, by_fault[None], GRIDS[grid])
    for key in ("y", "prefill h", "prefill conv"):
        assert gaps[key] <= TOL, (key, gaps[key])


@pytest.mark.parametrize("grid", list(GRIDS))
def test_every_gradient_matches_unsplit(results, grid):
    whole, by_fault = results[grid]
    gaps = _gaps(whole, by_fault[None], GRIDS[grid])
    held = [k for k in gaps if k.startswith("grad ")] + ["du"]
    assert len(held) == len(whole["grads"]) + 1
    for key in held:
        assert gaps[key] <= TOL, (key, gaps[key])


@pytest.mark.parametrize("grid", list(GRIDS))
def test_decode_steps_match_unsplit(results, grid):
    whole, by_fault = results[grid]
    gaps = _gaps(whole, by_fault[None], GRIDS[grid])
    for key in [f"decode {i}" for i in range(N_DECODE)] + ["final h", "final conv"]:
        assert gaps[key] <= TOL, (key, gaps[key])


@pytest.mark.parametrize("grid", list(GRIDS))
def test_cache_shards_are_their_placement_slices(results, grid):
    """Each rank's 'h' holds its heads and its 'conv' its even slice of
    conv_dim, at the shapes ``cache_pspec_for`` gives (the values are held
    above)."""
    whole, by_fault = results[grid]
    m = GRIDS[grid]["model"]
    cfg = _cfg()
    d_in = cfg.ssm.expand * cfg.d_model
    conv_dim = d_in + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    for r in by_fault[None]:
        share = B // GRIDS[grid]["data"]
        assert r["prefill"]["h"].shape == (share, d_in // cfg.ssm.head_dim // m, cfg.ssm.d_state, cfg.ssm.head_dim)
        assert r["prefill"]["conv"].shape == (share, cfg.ssm.d_conv - 1, conv_dim // m)
        assert r["grads"]["conv_w"].shape[-1] == conv_dim // m != r["grads"]["wx"].shape[-1]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails(results, fault):
    """The checks above catch each planted fault: its run leaves the
    unsplit block by more than the tolerance somewhere."""
    whole, by_fault = results["2x2"]
    gaps = _gaps(whole, by_fault[fault], GRIDS["2x2"])
    assert max(gaps.values()) > 100 * TOL, gaps
    if fault == "wbc":
        assert gaps["grad wbc"] > 100 * TOL, gaps["grad wbc"]


def test_reduced_config_is_misaligned():
    """The premise: at both grids a rank's conv channels are not its x
    channels, and S spans three chunks, the last padded."""
    cfg = _cfg()
    d_in = cfg.ssm.expand * cfg.d_model
    conv_dim = d_in + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    assert (d_in, conv_dim, cfg.ssm.chunk) == (128, 160, 16)
    for grid in GRIDS.values():
        assert conv_dim // grid["model"] != d_in // grid["model"]
    assert S % cfg.ssm.chunk and -(-S // cfg.ssm.chunk) == 3
