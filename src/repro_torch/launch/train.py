"""Training driver: ``python -m repro_torch.launch.train --arch <id> [--smoke] ...``

Port of ``repro.launch.train``: the same flags and defaults, plus
``--device`` (default CUDA; ``--device cpu`` runs the plain PyTorch path),
and the same ``[train]`` lines.  Randomly initialises the model from
``--seed``, trains it with AdamW on ``TokenPipeline`` batches (the stub
frontends' frames / patches for whisper and the VLM), checkpoints every
``--ckpt-every`` steps (atomic, keep 3), resumes from the latest
checkpoint in ``--ckpt-dir``, and on SIGTERM saves before it exits.
Returns the list of losses.

``--mesh 1x1`` only: training over a mesh (data parallel with
``train/compression.py``, model and pipeline parallel) is ROADMAP A.10.4
and A.10.10.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenPipeline, stub_inputs
from repro_torch.device import resolve_device
from repro_torch.models import params as params_lib, transformer
from repro_torch.train import optimizer as opt, step as step_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1", help="data×model; only 1x1 so far")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--state-dtype", default="f32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dp, tp = (int(x) for x in args.mesh.split("x"))
    if (dp, tp) != (1, 1):
        raise NotImplementedError(
            f"--mesh {args.mesh}: training over a mesh (data parallel with train/compression.py,"
            " model and pipeline parallel) waits for ROADMAP A.10.4 (train/pipeline.py) and"
            " A.10.10 (launch/train --mesh DxM); run --mesh 1x1"
        )
    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.reduce_config(cfg)

    tcfg = step_lib.TrainConfig(
        adamw=opt.AdamWConfig(
            lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
            total_steps=args.steps, state_dtype=args.state_dtype,
        ),
        ce_chunk=min(1024, args.seq_len),
    )
    params = params_lib.materialize(transformer.model_specs(cfg), args.seed, device=dev)
    opt_state = opt.init_state(params, tcfg.adamw)

    data = TokenPipeline(DataConfig(args.seq_len, args.global_batch, cfg.vocab_size, args.seed))
    extra = stub_inputs(cfg, args.global_batch, device=dev)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        mgr.install_preemption_handler()
        latest = mgr.latest_step()
        if latest is not None:
            restored = mgr.restore(latest, {"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            start_step = latest
            print(f"[train] resumed from step {latest}")

    train_step = step_lib.make_train_step(cfg, tcfg)

    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in data.batch(step).items()}
        batch.update(extra)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = args.global_batch * args.seq_len * (step - start_step + 1) / max(dt, 1e-9)
            print(
                f"[train] step={step} loss={losses[-1]:.4f} "
                f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.2f} "
                f"tok/s={tok_s:,.0f}"
            )
        if mgr and (step % args.ckpt_every == args.ckpt_every - 1 or mgr.preempted):
            mgr.save(step + 1, {"params": params, "opt": opt_state})
            if mgr.preempted:
                print("[train] preemption save complete; exiting")
                return losses
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state})
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
