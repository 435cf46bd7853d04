"""The port's training driver (``python -m repro_torch.launch.train``) and
train step on the CPU, beside the reference's.

* ``--smoke --device cpu``: the loss falls, and a second invocation resumes
  from the checkpoint and runs the 2 steps left (the reference's
  ``tests/test_system.py::test_train_driver_end_to_end``);
* both drivers print the same ``[train]`` lines, numbers masked;
* a step is written once, where the reference's loop and its final save
  both write the last one;
* a run that a SIGTERM marks preempted saves and exits after the step;
* the port resumes from a checkpoint the reference's driver wrote, and its
  next step's loss is the reference's own resumed step's (bf16, within
  2e-2); ``--mesh`` with a model axis > 1 takes every family, and raises
  with int8 moments, naming ROADMAP A.10.15 (D×M runs:
  ``test_torch_train_mesh*.py``);
* two ``make_train_step`` steps (AdamW included, float32, weights carried
  across) give the reference's losses and gradient norms.
"""

import contextlib
import io
import re
import shutil

import pytest

from repro.launch import train as ref_train
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.ckpt import manager
from repro_torch.launch import train
from repro_torch.train import optimizer as opt, step as step_lib
from test_torch_train_grads import CHUNK, _both, _float32

SMOKE = ["--arch", "qwen1.5-0.5b", "--smoke", "--seq-len", "32", "--global-batch", "4",
         "--ckpt-every", "4", "--lr", "5e-3"]


def test_train_driver_end_to_end(tmp_path):
    losses = train.main(SMOKE + ["--steps", "8", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert manager.CheckpointManager(str(tmp_path)).all_steps() == [4, 8]
    # resume path: the second invocation starts from the checkpoint
    losses2 = train.main(SMOKE + ["--steps", "10", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(losses2) == 2  # resumed at step 8 of 10


def _lines(fn, argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return [re.sub(r"-?[\d,]+\.?\d*(e[-+]\d+)?", "<n>", ln) for ln in buf.getvalue().splitlines()]


def test_train_lines_equal_the_reference(tmp_path):
    argv = ["--smoke", "--steps", "3", "--seq-len", "16", "--global-batch", "2", "--log-every", "1",
            "--ckpt-every", "2"]
    want = _lines(ref_train.main, argv + ["--ckpt-dir", str(tmp_path / "ref")])
    got = _lines(train.main, argv + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert got == want and len(got) == 4
    want = _lines(ref_train.main, [*argv[:2], "4", *argv[3:], "--ckpt-dir", str(tmp_path / "ref")])
    got = _lines(train.main, [*argv[:2], "4", *argv[3:], "--ckpt-dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    assert got == want and got[0] == "[train] resumed from step <n>"


def test_each_step_is_saved_once(tmp_path, monkeypatch):
    """A run whose last step falls on ``--ckpt-every`` writes that step once
    (the reference writes it again after its loop: the same state)."""
    saved, save = [], manager.CheckpointManager.save

    def counted(self, step, *args, **kwargs):
        saved.append(step)
        return save(self, step, *args, **kwargs)

    monkeypatch.setattr(manager.CheckpointManager, "save", counted)
    train.main(SMOKE + ["--steps", "8", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert saved == [4, 8]
    train.main(SMOKE + ["--steps", "10", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert saved == [4, 8, 10]


def test_preempted_run_saves_and_exits(tmp_path, monkeypatch, capsys):
    def preempted(self):
        self.preempted = True

    monkeypatch.setattr(manager.CheckpointManager, "install_preemption_handler", preempted)
    losses = train.main(SMOKE + ["--steps", "8", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(losses) == 1
    assert manager.CheckpointManager(str(tmp_path)).all_steps() == [1]
    assert "[train] preemption save complete; exiting" in capsys.readouterr().out


def test_port_resumes_a_reference_checkpoint(tmp_path):
    argv = ["--smoke", "--steps", "4", "--seq-len", "16", "--global-batch", "2", "--ckpt-every", "3"]
    ref_train.main(argv[:2] + ["3"] + argv[3:] + ["--ckpt-dir", str(tmp_path / "ref")])
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    want = ref_train.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    got = train.main(argv + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert len(got) == len(want) == 1
    assert abs(got[0] - want[0]) <= 2e-2


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b", "jamba-v0.1-52b", "deepseek-v3-671b",
                                  "whisper-base", "llama-3.2-vision-11b"])
def test_check_mesh_accepts_int8_at_2x2(arch):
    """A model axis > 1 takes every family, the SSM and hybrid ones
    included, and so do int8 moments (replicated over the mesh)."""
    for extra in ([], ["--state-dtype", "int8"]):
        args = train.parse_args(["--smoke", "--arch", arch, "--mesh", "2x2", "--device", "cpu", *extra])
        assert train.check_mesh(train._config(args), 2, 2, args) is None


def test_train_steps_follow_reference(monkeypatch):
    """Two ``make_train_step`` steps (AdamW included), float32: the losses
    and gradient norms of both packages agree."""
    _float32(monkeypatch)
    ref_cfg, ref_p, cfg, p, ref_b, b = _both("qwen1.5-0.5b", "float32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    ref_t = ref_step.TrainConfig(adamw=ref_opt.AdamWConfig(**kw), ce_chunk=CHUNK)
    tcfg = step_lib.TrainConfig(adamw=opt.AdamWConfig(**kw), ce_chunk=CHUNK)
    ref_state, state = ref_opt.init_state(ref_p, ref_t.adamw), opt.init_state(p, tcfg.adamw)
    ref_fn, fn = ref_step.make_train_step(ref_cfg, ref_t), step_lib.make_train_step(cfg, tcfg)
    for _ in range(2):
        ref_p, ref_state, want = ref_fn(ref_p, ref_state, ref_b)
        p, state, got = fn(p, state, b)
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(float(want[k])), k
    assert int(state["step"]) == 2
