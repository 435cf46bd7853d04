"""Training over the data axis (``--mesh 2x1``, FSDP only) for the families
other than the dense decoders, and over a (data, model) mesh (``--mesh
2x2``: tensor and expert parallelism) for all of them, against the port's
own 1×1.

As ``test_torch_train_mesh.py``: float32 on every rank, each run resuming
one conditioned step-0 checkpoint of the driver's own draw, 4 steps at the
driver's defaults.  The MoE archs (qwen2-moe, jamba, deepseek-v3) run at
S = 128, so that each data rank's B/D · S = 256 tokens form whole dispatch
groups of 256, the groups of the 1×1 run: capacity and drops are per group
(``models.moe``), and the load-balancing loss is the global batch's
(its sums all-reduced over 'data').

Held: the 1×1 losses and gradient norms within 1e-5 relative over 4 steps
for qwen2-moe, mamba2, deepseek-v3 (MLA, MTP), whisper (the encoder's
frames split with the rows) and llama-3.2-vision (patches likewise).
jamba's first step is held at 1e-5 as well; its later steps are not,
because its top-2-of-4 routing flips on near-ties (ROADMAP C.17): one
float32 ulp on one router weight moves its 1×1 run's 4th-step gradient
norm by ~9e-2 (``nudge``, the witness run here), and the 2×1 run stays
within that run's own spread at every step.

At 2×2 every family — qwen2-moe (2 of its 4 experts a rank, the shared
expert split with them), deepseek-v3 (MLA's heads, 2 experts a rank,
MTP), whisper and llama-3.2-vision (self- and cross-attention, the
encoder's layers), mamba2 (4 of its 8 SSM heads a rank, the conv's even
split of conv_dim out of line with x's) and jamba (its SSM, attention, MLP
and MoE sublayers) — is held at the same 1e-5 over 4 steps, jamba at its
first step and then within the nudged 1×1 run's spread, as at 2×1.
"""

import shutil

import pytest

import torch_train_worker as worker
from repro_torch.launch import train
from test_torch_train_mesh import ARGV, STEPS, TOL, rel, spawn

FAMILIES = ("qwen2-moe-a2.7b", "mamba2-1.3b", "jamba-v0.1-52b", "deepseek-v3-671b", "whisper-base",
            "llama-3.2-vision-11b")
MOE = ("qwen2-moe-a2.7b", "jamba-v0.1-52b", "deepseek-v3-671b")
CHAOTIC = {"jamba-v0.1-52b": "['params']['blocks']['s1']['ffn']['router']"}


def _args(arch, mesh, ckpt_dir) -> dict:
    seq = "128" if arch in MOE else "32"
    return vars(train.parse_args(ARGV + ["--arch", arch, "--mesh", mesh, "--ckpt-dir", ckpt_dir,
                                         "--seq-len", seq]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_families")
    for arch in FAMILIES:
        worker.write_start(str(tmp / arch / "start"), _args(arch, "1x1", ""))
    out = {}
    for mesh in ("1x1", "2x1", "2x2"):
        todo = []
        for arch in FAMILIES:
            shutil.copytree(tmp / arch / "start", tmp / arch / mesh)
            todo.append(_args(arch, mesh, str(tmp / arch / mesh)))
        if mesh == "1x1":
            for arch, leaf in CHAOTIC.items():
                shutil.copytree(tmp / arch / "start", tmp / arch / "nudged")
                worker.nudge(str(tmp / arch / "nudged"), leaf)
                todo.append(_args(arch, mesh, str(tmp / arch / "nudged")))
        reports = spawn(mesh, todo)[0]
        out[mesh] = dict(zip(FAMILIES, reports))
        out["nudged"] = dict(zip(CHAOTIC, reports[len(FAMILIES):])) if mesh == "1x1" else out["nudged"]
    return out


def _steps(a: dict, b: dict) -> list:
    """Per step, the larger relative gap of the loss and the gradient norm."""
    return [max(abs(x - y) / abs(y), abs(g - h) / abs(h)) for x, y, g, h in
            zip(a["losses"], b["losses"], a["grad_norm"], b["grad_norm"])]


def _held(got: dict, ref: dict, witness: dict | None) -> None:
    """``got`` within 1e-5 of the 1×1 run ``ref`` at every step, or, for a
    chaotic arch (``witness``: its nudged 1×1 run), at the first step and
    then within the witness's own spread."""
    assert len(got["losses"]) == STEPS and got["devices"] == ["cpu"]
    if witness is None:
        assert rel(got["losses"], ref["losses"]) <= TOL, (got["losses"], ref["losses"])
        assert rel(got["grad_norm"], ref["grad_norm"]) <= TOL, (got["grad_norm"], ref["grad_norm"])
        return
    gaps, spread = _steps(got, ref), _steps(witness, ref)
    assert gaps[0] <= TOL, gaps
    assert max(gaps) <= max(spread), (gaps, spread)


@pytest.mark.parametrize("arch", FAMILIES)
def test_data_parallel_steps_match_1x1(runs, arch):
    _held(runs["2x1"][arch], runs["1x1"][arch], runs["nudged"].get(arch))


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_parallel_steps_match_1x1(runs, arch):
    _held(runs["2x2"][arch], runs["1x1"][arch], runs["nudged"].get(arch))
