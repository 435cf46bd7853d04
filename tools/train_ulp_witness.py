#!/usr/bin/env python3
"""How far bf16 rounding alone moves the first training step of a fresh
full-width LM: the witness beside ``chip_smoke.py``'s ``train_mesh`` bound.

    python3 tools/train_ulp_witness.py [--arch qwen1.5-0.5b] [--mesh 2x2]

On one card, ``repro_torch.launch.train.run`` takes one step (``--seq-len``
512, ``--global-batch`` 8) from three step-0 checkpoints of the init rule's
own draw (seed 0): the draw as it is at ``--mesh 1x1``; the same with one
weight (the first of layer 0's ``wq``) moved by one bf16 ulp at ``--mesh
1x1``; and the draw as it is at ``--mesh`` (gloo ranks on the card).  Prints
one JSON line: each run's first loss and gradient norm, and the relative
gaps of the nudged and the mesh run to the 1x1 run.  On that draw the
backward explodes (ROADMAP C.18), so the gaps are chaos, not a fault: the
smoke holds its 2e-2 bound on the rescaled draw.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--mesh", default="2x2")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import params as params_lib, transformer
    from repro_torch.train import optimizer as opt

    if not torch.cuda.is_available():
        print("train_ulp_witness: no CUDA device", file=sys.stderr)
        return 2
    base = ["--arch", args.arch, "--seq-len", "512", "--global-batch", "8", "--steps", "1"]
    cfg = train._config(train.parse_args(base))
    specs = transformer.model_specs(cfg)
    out = {"gpu": torch.cuda.get_device_name(0), "arch": args.arch, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mesh, nudge in (("1x1", "1x1", False), ("nudged", "1x1", True), ("mesh", args.mesh, False)):
            weights = params_lib.materialize(specs, 0, device=torch.device("cuda"))
            if nudge:
                w = weights["layers"]["s0"]["mixer"]["wq"].view(-1)
                w[0] = (w[0].float() * (1 + 2**-7)).to(w.dtype)  # one bf16 ulp up
            ckpt = os.path.join(tmp, name)
            CheckpointManager(ckpt).save(0, {"params": weights, "opt": opt.init_state(weights, opt.AdamWConfig())})
            del weights
            torch.cuda.empty_cache()
            report = train.run(base + ["--mesh", mesh, "--ckpt-dir", ckpt])[0]
            out["runs"][name] = {"mesh": mesh, "loss": report["losses"][0], "grad_norm": report["grad_norm"][0]}
    ref = out["runs"]["1x1"]
    out["rel_to_1x1"] = {name: {k: abs(r[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
                         for name, r in out["runs"].items() if name != "1x1"}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
