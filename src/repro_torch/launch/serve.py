"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``

Randomly initialises a model (seed 0), runs the slot-batched serve
engine over a set of demo prompts, and reports decode throughput.  Port of
``repro.launch.serve``: the same flags and defaults, plus ``--device``
(default CUDA; ``--device cpu`` runs the plain PyTorch path).  Every arch
serves; whisper and the VLM get their stub frontends' frames / patches
from ``data.pipeline.stub_inputs``.  Restoring a checkpoint
(``--ckpt-dir``) waits for the ``ckpt/manager.py`` port (the training
slice).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import stub_inputs
from repro_torch.device import resolve_device
from repro_torch.models import params as params_lib, transformer
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.reduce_config(cfg)
    params = params_lib.materialize(transformer.model_specs(cfg), 0, device=dev)
    if args.ckpt_dir:
        step, restored = CheckpointManager(args.ckpt_dir).restore_latest({"params": params})
        if restored is not None:
            params = restored["params"]
            print(f"[serve] restored checkpoint step {step}")
    model = TransformerLM(cfg, params)

    engine = ServeEngine(model, batch=args.batch, max_seq=args.max_seq, temperature=args.temperature,
                         extra_inputs=stub_inputs(cfg, args.batch, device=dev))
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            prompt=list(rng.integers(2, cfg.vocab_size, size=int(rng.integers(4, 16)))),
            max_new=args.max_new,
        )
        for _ in range(args.n_requests)
    ]
    t0 = time.time()
    done = engine.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s) on {dev}")
    for r in done[:3]:
        print(f"  prompt[:6]={r.prompt[:6]} -> out[:8]={r.out[:8]}")
    return done


if __name__ == "__main__":
    main()
