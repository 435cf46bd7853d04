"""LM serving parity: the port's ``ServeEngine`` against the reference's,
greedy, on reduced qwen1.5-0.5b with the reference's weights.

Both engines serve the same requests (3 prompts, slot batches of 2, so one
group is short and padded with an empty row).  Then each group is replayed
through the port with the reference's tokens fed in (teacher forcing), so
one bf16 near-tie cannot derail the rest of the comparison, and every
step's logits are held against the reference's full forward over the same
padded prompt and fed tokens (its attention on its own Pallas flash
kernel, fixture ``reference_flash`` of ``test_torch_models``):

* every step's logits agree within 0.05 of max|logit| (measured at most
  1.7%);
* the port's argmax equals the reference's token wherever the forward's
  top-1/top-2 margin exceeds that tolerance;
* the port's own free-running output equals the reference's up to the
  first step of each request whose margin is within the tolerance.

The forward, not the reference's ``decode_step``, is the yardstick per
step: the reference's decode rounds scores and probabilities to bf16 where
the port's keeps float32 (``models/layers.py``), and over six teacher-forced
steps the two part by up to 6.1% of max|logit|.  One decode step against
the reference's unchanged ``decode_step`` is held in ``test_torch_models``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine
from repro_torch import configs
from repro_torch.ckpt.manager import CheckpointManager, leaves_with_paths
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import params
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import engine
from test_torch_models import reference_flash  # noqa: F401  (fixture)

TOL = 0.05
BATCH, MAX_SEQ, MAX_NEW = 2, 48, 6


def _setup():
    ref_cfg = ref_configs.reduce_config(ref_configs.get_config("qwen1.5-0.5b"))
    cfg = configs.reduce_config(configs.get_config("qwen1.5-0.5b"))
    ref_p = ref_params.materialize(ref_tf.model_specs(ref_cfg), jax.random.PRNGKey(0))
    model = TransformerLM(cfg, params.from_reference(jax.tree.map(np.asarray, ref_p), "cpu"))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=int(rng.integers(4, 16)))]
               for _ in range(3)]
    return ref_cfg, ref_p, model, prompts


def test_generate_matches_reference_greedy(reference_flash):  # noqa: F811
    ref_cfg, ref_p, model, prompts = _setup()
    ref_out = ref_engine.ServeEngine(ref_p, ref_cfg, batch=BATCH, max_seq=MAX_SEQ).generate(
        [ref_engine.Request(prompt=p, max_new=MAX_NEW) for p in prompts])
    port_engine = engine.ServeEngine(model, batch=BATCH, max_seq=MAX_SEQ)
    ticks = []
    port_engine.on_tick = ticks.append
    port_out = port_engine.generate([engine.Request(prompt=p, max_new=MAX_NEW) for p in prompts])
    assert all(r.done and len(r.out) == MAX_NEW for r in port_out)
    assert ticks == list(range(MAX_NEW)) * 2  # two groups
    assert len(port_engine.timings["prefill_s"]) == 2
    assert len(port_engine.timings["decode_s"]) == 2 * MAX_NEW

    checked = 0
    for start in range(0, len(prompts), BATCH):
        group = list(range(start, min(start + BATCH, len(prompts))))
        plen = max(len(prompts[i]) for i in group)
        toks = np.zeros((BATCH, plen), np.int32)
        fed = np.zeros((BATCH, MAX_NEW), np.int32)  # the padding row is fed 0s
        for row, i in enumerate(group):
            toks[row, plen - len(prompts[i]):] = prompts[i]
            fed[row] = ref_out[i].out
        full, _ = ref_tf.forward(ref_p, ref_cfg, jnp.asarray(np.concatenate([toks, fed], 1)), remat=False)
        got, cache = model.prefill(toks, MAX_SEQ)
        diverged = [False] * len(group)
        for step in range(MAX_NEW):
            want = np.asarray(full[:, plen - 1 + step])
            scale = float(np.abs(want).max()) + 1e-6
            assert float(np.abs(got.numpy() - want).max()) / scale < TOL, (start, step)
            top2 = np.sort(want, axis=-1)[:, -2:]
            for row, i in enumerate(group):
                if top2[row, 1] - top2[row, 0] > TOL * scale:
                    assert int(got[row].argmax()) == fed[row, step], (i, step)
                    checked += 1
                    if not diverged[row]:
                        assert port_out[i].out[step] == fed[row, step], (i, step)
                else:
                    diverged[row] = True
            got, cache = model.decode_step(fed[:, step], cache)
    assert checked > 0


def test_sampling_is_seeded():
    _, _, model, prompts = _setup()
    runs = []
    for _ in range(2):
        eng = engine.ServeEngine(model, batch=BATCH, max_seq=MAX_SEQ, temperature=1.0)
        runs.append([r.out for r in eng.generate([engine.Request(p, MAX_NEW) for p in prompts])])
    assert runs[0] == runs[1]
    assert all(0 <= t < model.cfg.vocab_size for out in runs[0] for t in out)


def test_serve_main_smoke_on_cpu(capsys, tmp_path, monkeypatch):
    done = port_serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--max-seq", "48",
                            "--max-new", "4", "--n-requests", "3"])
    assert [len(r.out) for r in done] == [4, 4, 4]
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
    # --ckpt-dir: the parameters of the port's trainer's latest checkpoint
    port_train.main(["--smoke", "--steps", "2", "--seq-len", "16", "--global-batch", "2",
                     "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    served = []
    monkeypatch.setattr(port_serve, "TransformerLM",
                        lambda cfg, p: served.append(p) or TransformerLM(cfg, p))
    done = port_serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--max-seq", "48",
                            "--max-new", "4", "--n-requests", "3", "--ckpt-dir", str(tmp_path)])
    assert [len(r.out) for r in done] == [4, 4, 4]
    assert "[serve] restored checkpoint step 2" in capsys.readouterr().out
    like = {"params": served[0]}
    _, want = CheckpointManager(str(tmp_path)).restore_latest(like)
    for (path, got), (_, w) in zip(leaves_with_paths(served[0]), leaves_with_paths(want["params"])):
        assert torch.equal(got, w), path
    if not torch.cuda.is_available():  # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_serve.main(["--smoke"])


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_serve_main_smoke_every_arch_on_cpu(arch, capsys):
    """Every arch serves through the entry point at its reduced config:
    whisper and the VLM with their stub frontends' inputs, the MoE archs
    through the grouped dispatch, the SSM archs through their state."""
    done = port_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                            "--max-seq", "48", "--max-new", "4", "--n-requests", "3"])
    assert [len(r.out) for r in done] == [4, 4, 4]
    vocab = configs.reduce_config(configs.get_config(arch)).vocab_size
    assert all(0 <= t < vocab for r in done for t in r.out)
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
