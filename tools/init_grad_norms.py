#!/usr/bin/env python3
"""Gradient norms of a freshly initialised LM, one package at a time.

    PYTHONPATH=src python tools/init_grad_norms.py --package torch [--rescale]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/init_grad_norms.py --package jax

Draws ``--arch`` at its published widths and ``--layers`` of its depth
with the package's own initialiser (seed 0), takes one ``TokenPipeline``
batch of ``[--batch, --seq]`` tokens and prints, as one JSON line, the
training loss and the gradient norm of every parameter leaf and of all of
them.  ``--package torch`` runs the PyTorch port (on ``--device``, default
the CPU), ``--package jax`` the JAX reference (its loss under ``jax.jit``);
neither imports the other.  ``--rescale`` (torch) first rescales the
attention projections from the init rule's 1/sqrt(shape[-2]) to
1/sqrt(their input width), as ``chip_smoke.conditioned`` does.  At
qwen1.5-0.5b's 24 layers the init rule's draw gives norms near 1e11 in
both packages (ROADMAP C.18).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def torch_norms(args) -> dict:
    import torch

    from repro_torch import configs
    from repro_torch.ckpt.manager import leaves_with_paths
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import params as params_lib, transformer
    from repro_torch.train import step as step_lib

    cfg = dataclasses.replace(configs.get_config(args.arch), n_layers=args.layers)
    specs = transformer.model_specs(cfg)
    params = params_lib.materialize(specs, 0, device=args.device)
    if args.rescale:
        spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        chip_smoke.conditioned(specs, params)
    batch = {k: torch.from_numpy(v).to(args.device, torch.long) for k, v in TokenPipeline(
        DataConfig(args.seq, args.batch, cfg.vocab_size, 0)).batch(0).items()}
    leaves = leaves_with_paths(params)
    for _path, leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = step_lib.loss_fn(params, cfg, step_lib.TrainConfig(ce_chunk=args.seq), batch)
    loss.backward()
    norms = {path: float(leaf.grad.float().norm()) for path, leaf in leaves}
    return {"loss": float(loss.detach()), "norms": norms}


def jax_norms(args) -> dict:
    import jax
    import numpy as np

    from repro import configs
    from repro.data.pipeline import DataConfig, TokenPipeline
    from repro.models import params as params_lib, transformer
    from repro.train import step as step_lib

    cfg = dataclasses.replace(configs.get_config(args.arch), n_layers=args.layers)
    params = params_lib.materialize(transformer.model_specs(cfg), jax.random.PRNGKey(0))
    batch = {k: jax.numpy.asarray(v) for k, v in TokenPipeline(
        DataConfig(args.seq, args.batch, cfg.vocab_size, 0)).batch(0).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: step_lib.loss_fn(p, cfg, step_lib.TrainConfig(ce_chunk=args.seq), batch),
        has_aux=True))(params)
    norms = {jax.tree_util.keystr(path): float(np.linalg.norm(np.asarray(g, np.float32)))
             for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return {"loss": float(loss), "norms": norms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--rescale", action="store_true", help="torch: rescale attention projections")
    ap.add_argument("--device", default="cpu", help="torch: 'cpu' or 'cuda'")
    args = ap.parse_args(argv)
    if args.rescale and args.package != "torch":
        ap.error("--rescale applies to --package torch")
    out = torch_norms(args) if args.package == "torch" else jax_norms(args)
    out["global_norm"] = sum(n * n for n in out["norms"].values()) ** 0.5
    print(json.dumps({"package": args.package, "arch": args.arch, "layers": args.layers,
                      "tokens": [args.batch, args.seq], "rescale": args.rescale, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
