"""Training over a (data, model) mesh against the port's own 1×1: the dense
decoder family.

``launch.train``'s ``--mesh DxM`` branch runs D·M gloo ranks on the CPU
(``launch.mesh.run_ranks``; rank side ``torch_train_worker``, one thread
each).  Every run starts from the same step-0 checkpoint: the driver's own
draw for its arguments in float32, attention projections rescaled
(``torch_train_worker.conditioned``, the families tests' rule: on the init
rule's own draw the reduced configs are chaotic, ROADMAP C.17, and float32
rounding moves a gradient by 1e-5 — measured 2.6e-4 on the 4th step's
gradient norm at 2×2), so the run resumes it through the driver's own
path.  Activations are float32 on every rank (each package's bf16 casts
patched, as the parity tests do), the driver's defaults otherwise (AdamW
at lr 3e-3, remat, CE chunk = S).

Held, for qwen1.5-0.5b (4 query and 4 KV heads: K/V split over 'model'),
qwen3-32b (qk_norm; 1 KV head, replicated over 'model'), h2o-danube-3-4b
(a window of 8 at S = 32; 1 KV head) and starcoder2-3b (LayerNorm, bias,
a non-GLU MLP; 1 KV head): 4 steps at 2×2, 1×2 and 2×1 give the 1×1
losses and gradient norms within 1e-5 relative (measured at most 4.4e-6,
danube), every rank reports the same, and every parameter and moment stays
on the rank's device.  The driver's refusals, and int8 moments at 2×1.  (Resume across meshes and
``main``'s lines: ``test_torch_train_mesh_resume.py``; the other families
at D×1: ``test_torch_train_mesh_families.py``; the reference's GSPMD step:
``test_torch_train_mesh_gspmd.py``.)
"""

import math
import shutil

import pytest

import torch_train_worker as worker
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train

DENSE = ("qwen1.5-0.5b", "qwen3-32b", "h2o-danube-3-4b", "starcoder2-3b")
MESHES = ("2x2", "1x2", "2x1")
STEPS = 4
ARGV = ["--smoke", "--device", "cpu", "--steps", str(STEPS), "--seq-len", "32", "--global-batch", "4",
        "--log-every", "1"]
TOL = 1e-5
SPAWN_TIMEOUT_S = 240.0


def _args(arch, mesh, ckpt_dir, argv=ARGV) -> dict:
    return vars(train.parse_args(argv + ["--arch", arch, "--mesh", mesh, "--ckpt-dir", ckpt_dir]))


def spawn(mesh: str, runs: list) -> list:
    """Every rank's reports of ``runs`` (one spawn of ``mesh``)."""
    d, m = (int(x) for x in mesh.split("x"))
    return meshlib.run_ranks(worker.train_many, d * m, devices=["cpu"] * (d * m), args=(runs,),
                             grid={"data": d, "model": m}, timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: {arch: every rank's report}} for 1×1 and ``MESHES``."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    for arch in DENSE:
        worker.write_start(str(tmp / arch / "start"), _args(arch, "1x1", ""))
    out = {}
    for mesh in ("1x1",) + MESHES:
        todo = []
        for arch in DENSE:
            ckpt = str(tmp / arch / mesh)
            shutil.copytree(tmp / arch / "start", ckpt)
            todo.append(_args(arch, mesh, ckpt))
        ranks = spawn(mesh, todo)
        out[mesh] = {arch: [r[i] for r in ranks] for i, arch in enumerate(DENSE)}
    return out


def rel(got: list, want: list) -> float:
    assert len(got) == len(want)
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", DENSE)
def test_mesh_steps_match_1x1(runs, arch, mesh):
    ref = runs["1x1"][arch][0]
    got = runs[mesh][arch][0]
    assert len(got["losses"]) == STEPS
    assert rel(got["losses"], ref["losses"]) <= TOL, (got["losses"], ref["losses"])
    assert rel(got["grad_norm"], ref["grad_norm"]) <= TOL, (got["grad_norm"], ref["grad_norm"])


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_reports_the_global_run(runs, mesh):
    for arch in DENSE:
        ranks = runs[mesh][arch]
        d, m = (int(x) for x in mesh.split("x"))
        assert [r["coords"] for r in ranks] == [{"data": i, "model": j} for i in range(d) for j in range(m)]
        for r in ranks:
            assert r["losses"] == ranks[0]["losses"] and r["grad_norm"] == ranks[0]["grad_norm"]
            assert r["devices"] == ["cpu"]
        assert ranks[0]["lines"][0] == "[train] resumed from step 0"
        assert all(not r["lines"] for r in ranks[1:])  # rank 0 keeps the lines


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "2x2", "--global-batch", "3"], "does not split over 2 data ranks"),
    (["--mesh", "0x2"], "both axes"),
])
def test_mesh_refusals(argv, match):
    with pytest.raises(ValueError, match=match):
        train.main(["--smoke", "--device", "cpu"] + argv)


def test_int8_moments_run_over_a_mesh():
    """``--state-dtype int8`` at 2×1: the moments replicated on both ranks
    (``test_torch_int8_mesh.py`` holds them to 1×1)."""
    losses = train.main(["--smoke", "--device", "cpu", "--mesh", "2x1", "--state-dtype", "int8", "--steps", "2",
                         "--seq-len", "16", "--global-batch", "2"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
