"""One training step over a 2×2 (data, model) mesh against the reference's
own GSPMD step on a (2, 2) mesh of fake XLA devices.

The reference runs in a subprocess with 4 forced host devices (as
``tests/test_system.py``'s pipeline test does): its ``make_train_step``
under ``jax.jit``, parameters placed by ``launch.mesh.param_shardings``
(FSDP over 'data', tensor parallel over 'model'), activation sharding on,
float32 throughout (its bf16 activation casts patched to float32, as
``test_torch_train_grads`` does), on its own seed-0 draw with the
attention projections rescaled (``test_torch_families._conditioned``'s
rule), AdamW at the port driver's settings for a 4-step run (lr 3e-3,
warmup 1).  The port runs the same step on 4 gloo ranks
(``torch_train_worker.one_step``) on those weights
(``params.from_reference``) and rows.  Held within 1e-5 relative, for
qwen1.5-0.5b (K/V split over 'model') and qwen3-32b (one KV head,
replicated): the loss, the gradient norm, every gradient leaf (the
reference's from ``jax.grad`` of its ``loss_fn`` under the same
placement) and every updated parameter leaf (``test_updated_...`` says
where AdamW's own eps makes an update depend on rounding).  And one step
of qwen1.5-0.5b with int8 moments (``state_dtype='int8'``; the port's
replicated on every rank, updated whole from the gathered gradient): its
loss, gradient norm, updated parameters and dequantised moments, the
moments within 1e-5 of their leaf's max |value| or within one
quantisation step (their block's scale) where the rounding to an int8
level decides.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_train_worker as worker
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-0.5b", "qwen3-32b")
INT8 = "qwen1.5-0.5b:int8"
B, S, LR, STEPS = 4, 32, 3e-3, 4
TOL = 1e-5

REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs
    from repro.launch import mesh as meshlib
    from repro.models import layers, params as P_, transformer
    from repro.train import optimizer as opt, step as step_lib
    from test_torch_families import _Float32Jnp, _conditioned

    out, b, s = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    lr, steps = float(sys.argv[4]), int(sys.argv[5])
    transformer.jnp = _Float32Jnp()
    mesh = meshlib.make_mesh((2, 2), ("data", "model"))
    layers.enable_activation_sharding(mesh)
    for name in sys.argv[6:]:
        arch, _, state_dtype = name.partition(":")
        cfg = configs.reduce_config(configs.get_config(arch))
        specs = transformer.model_specs(cfg)
        params = _conditioned(specs, jax.tree.map(lambda a: a.astype(jnp.float32),
                                                  P_.materialize(specs, jax.random.PRNGKey(0))))
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)], 1)
        labels[1, 5] = -1
        tcfg = step_lib.TrainConfig(adamw=opt.AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps,
                                                          state_dtype=state_dtype or "f32"),
                                    ce_chunk=min(1024, s))
        placed = jax.tree.map(jax.device_put, params, meshlib.param_shardings(specs, mesh))
        batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        with mesh:
            grads = jax.jit(jax.grad(lambda p: step_lib.loss_fn(p, cfg, tcfg, batch)[0]))(placed)
            step = jax.jit(step_lib.make_train_step(cfg, tcfg))
            new, state, metrics = step(placed, opt.init_state(placed, tcfg.adamw), batch)
        flat = lambda t, pre: {pre + jax.tree_util.keystr(k): np.asarray(v)
                               for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
        moments = {**flat(state["m"], "m"), **flat(state["v"], "v")} if state_dtype else {}
        np.savez(f"{out}/{name}.npz", tokens=tokens, labels=labels, loss=float(metrics["loss"]),
                 grad_norm=float(metrics["grad_norm"]), **flat(params, "p"), **flat(new, "n"), **flat(grads, "g"),
                 **moments)
    print("REF_OK")
    """
)


def _tree(z, prefix: str) -> dict:
    out: dict = {}
    for key in z.files:
        if key.startswith(prefix + "["):
            path = [p.strip("'") for p in key[len(prefix) + 1 : -1].split("][")]
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = z[key]
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """{arch: (the reference's npz, the port's rank-0 report)}: one
    reference subprocess and one 4-rank spawn for every arch."""
    out = tmp_path_factory.mktemp("gspmd")
    names = (*ARCHS, INT8)
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(out), str(B), str(S), str(LR), str(STEPS),
                          *names], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert "REF_OK" in res.stdout, res.stderr[-3000:]
    zs = {name: np.load(out / f"{name}.npz") for name in names}
    runs = [(vars(train.parse_args(["--smoke", "--arch", name.partition(":")[0], "--device", "cpu",
                                    "--seq-len", str(S), "--global-batch", str(B), "--lr", str(LR),
                                    "--steps", str(STEPS), "--mesh", "2x2",
                                    "--state-dtype", name.partition(":")[2] or "f32"])),
             _tree(z, "p"), z["tokens"], z["labels"]) for name, z in zs.items()]
    ports = meshlib.run_ranks(worker.one_steps, 4, devices=["cpu"] * 4, grid={"data": 2, "model": 2},
                              args=(runs,), timeout_s=240.0)[0]
    return {name: (zs[name], port) for name, port in zip(names, ports)}


@pytest.fixture(params=ARCHS)
def steps(request, both):
    return both[request.param]


def test_loss_and_grad_norm_match_gspmd(steps):
    z, port = steps
    assert abs(port["loss"] - float(z["loss"])) <= TOL * abs(float(z["loss"])), (port["loss"], float(z["loss"]))
    assert abs(port["grad_norm"] - float(z["grad_norm"])) <= TOL * abs(float(z["grad_norm"])), (
        port["grad_norm"], float(z["grad_norm"]))


def test_gradients_match_gspmd(steps):
    """Every leaf's gradient within 1e-5 of its max |g| (measured <= 2.3e-6)."""
    z, port = steps
    keys = [k for k in z.files if k.startswith("g[")]
    assert len(keys) == len(port["grads"])
    for key in keys:
        want, got = z[key], port["grads"][key[1:]]
        assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want)), key


def test_updated_parameters_match_gspmd(steps):
    """Every updated leaf within 1e-5 (‖Δ‖ / ‖p‖) where AdamW's first update
    is sign-like (|g| >= 1000 × its eps of 1e-8); where |g| is near eps
    (a few elements of the zero-initialised biases), float32 rounding of g
    alone moves the update, and those elements are held to the update's
    own bound, 2 × lr."""
    _held_updates(*steps)


def _held_updates(z, port) -> None:
    keys = [k for k in z.files if k.startswith("n[")]
    assert len(keys) == len(port["params"])
    for key in keys:
        want, got, g = z[key], port["params"][key[1:]], z["g" + key[1:]]
        assert got.shape == want.shape, key
        well = np.abs(g) >= 1e3 * 1e-8
        gap = np.linalg.norm((got - want)[well]) / np.linalg.norm(want[well])
        assert gap <= TOL, (key, gap)
        assert np.max(np.abs(got - want)[~well], initial=0.0) <= 2 * LR, key


def _dequant(z_or_port, name: str, path: str) -> tuple[np.ndarray, np.ndarray]:
    """(a moment's dequantised values, each value's block scale), flat."""
    q, scale = z_or_port(f"{name}{path}['q']"), z_or_port(f"{name}{path}['scale']")
    return (q.astype(np.float32) * scale).reshape(-1), np.broadcast_to(scale, q.shape).reshape(-1)


def test_int8_step_matches_gspmd(both):
    """One step with int8 moments: the loss and the gradient norm within
    1e-5 relative, the updated parameters as ``test_updated_...`` holds
    them, and every value of m and v within 1e-5 of its leaf's max |value|
    or within one quantisation step of its block."""
    z, port = both[INT8]
    assert abs(port["loss"] - float(z["loss"])) <= TOL * abs(float(z["loss"])), (port["loss"], float(z["loss"]))
    assert abs(port["grad_norm"] - float(z["grad_norm"])) <= TOL * abs(float(z["grad_norm"]))
    _held_updates(z, port)
    paths = {k[1:-len("['q']")] for k in z.files if k.startswith("m[") and k.endswith("['q']")}
    assert len(paths) == len(port["params"])
    moments = {**{"m" + k: v for k, v in port["m"].items()}, **{"v" + k: v for k, v in port["v"].items()}}
    for name in ("m", "v"):
        for path in paths:
            want, scale = _dequant(lambda k: z[k], name, path)
            got, _ = _dequant(lambda k: moments[k], name, path)
            gap = np.abs(got - want)
            assert np.all((gap <= TOL * np.max(np.abs(want))) | (gap <= scale * (1 + 1e-6))), (name, path)
