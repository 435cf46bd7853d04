"""A checkpoint written over a mesh resumes on another mesh (the
reference's elastic restore), and ``main`` over a mesh prints rank 0's
lines.

qwen1.5-0.5b reduced, float32 on every rank, from the conditioned step-0
checkpoint of ``test_torch_train_mesh.py``'s runs: 4 steps at 2×2 with a
checkpoint every 2 steps (full arrays, written by rank 0); its step-2
checkpoint alone, resumed at 1×1 (one process) and at 1×4 (every weight
split four ways over 'model'), gives the 2×2 run's steps 2 and 3 within
1e-5 relative.
"""

import os
import re
import shutil

import pytest

import torch_train_worker as worker
from repro_torch.launch import train
from test_torch_train_mesh import ARGV, TOL, rel, spawn

ARCH, RESUME_AT, MESHES = "qwen1.5-0.5b", 2, ("1x1", "1x4")


def _args(mesh, ckpt_dir) -> dict:
    return vars(train.parse_args(ARGV + ["--arch", ARCH, "--mesh", mesh, "--ckpt-dir", ckpt_dir,
                                         "--ckpt-every", str(RESUME_AT)]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_resume")
    worker.write_start(str(tmp / "full"), _args("1x1", ""))
    full = spawn("2x2", [_args("2x2", str(tmp / "full"))])[0][0]
    resumed = {}
    for mesh in MESHES:
        ckpt = tmp / f"resume_{mesh}"
        os.makedirs(ckpt)
        shutil.copytree(tmp / "full" / f"step_{RESUME_AT:06d}", ckpt / f"step_{RESUME_AT:06d}")
        resumed[mesh] = spawn(mesh, [_args(mesh, str(ckpt))])[0][0]
    return full, resumed


@pytest.mark.parametrize("mesh", MESHES)
def test_2x2_checkpoint_resumes_on_another_mesh(runs, mesh):
    full, resumed = runs
    got = resumed[mesh]
    assert got["lines"][0] == f"[train] resumed from step {RESUME_AT}"
    assert rel(got["losses"], full["losses"][RESUME_AT:]) <= TOL, (got["losses"], full["losses"])


def test_mesh_main_prints_rank0_lines(capsys):
    losses = train.main(["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
                         "--global-batch", "2", "--log-every", "1", "--mesh", "2x1"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["step=0", "step=1", "done:"]
    assert [float(re.search(r"loss=([\d.]+)", ln).group(1)) for ln in lines[:2]] == [
        round(x, 4) for x in losses]
