"""End-to-end driver on the PyTorch port: MATE discovery → dataset
enrichment → LM training.

The paper's own motivation (§1): enrich a base dataset with joinable tables
from a lake, then use it for downstream ML.  The twin of
``examples/enrich_and_train.py`` on ``repro_torch``: the same lake, base
table, enrichment and printed lines (the losses and the rate are the port's
own: its weights are drawn from a ``torch.Generator``).

  1. build a synthetic lake + index it (offline phase: kernel B.3);
  2. enrich a base table via top-k n-ary join discovery (online phase:
     kernel B.2 on the card);
  3. tokenise the enriched records and train a decoder LM on them
     (kernel B.6 forward and its backward), with checkpointing.

Reduced config by default (~2M params, 120 steps); ``--full`` trains the
published widths.

    PYTHONPATH=src python examples/torch_enrich_and_train.py [--steps 120] [--device cpu]
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

import numpy as np
import torch

from repro_torch import configs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core.corpus import Corpus, Table
from repro_torch.core.session import DiscoveryConfig, MateSession
from repro_torch.data import synthetic
from repro_torch.data.enrichment import enrich, tokenize_records
from repro_torch.device import resolve_device
from repro_torch.models import params as params_lib, transformer
from repro_torch.train import optimizer as opt, step as step_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--full", action="store_true", help="full-size config")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1. lake + index ----
    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=150, seed=7))
    base_cells = [[f"entity{i}", f"city{i % 23}", "payload"] for i in range(64)]
    feat = [[f"entity{i}", f"city{i % 23}", f"income {i*13%997}", f"region {i%7}"]
            for i in range(64)]
    corpus.tables.append(Table(len(corpus.tables), feat))
    corpus = Corpus(corpus.tables)
    session = MateSession.build(corpus, DiscoveryConfig(k=5), device=dev)
    print(f"[1] lake indexed: {corpus.total_rows} rows "
          f"(backend={session.backend.name})")

    # ---- 2. enrichment via MATE ----
    base = Table(-1, base_cells)
    enriched, prov = enrich(session, base, key_cols=[0, 1], k=5)
    print(f"[2] enriched {base.n_cols} -> {enriched.n_cols} cols; provenance:")
    for p in prov:
        print(f"    table {p['table_id']}: j={p['joinability']} "
              f"+{p['new_cols']} cols, {p['hit_rows']} rows hit")

    # ---- 3. train an LM on the enriched records ----
    cfg = configs.get_config(args.arch)
    if not args.full:
        cfg = configs.reduce_config(cfg)
    tokens_all = tokenize_records(enriched, cfg.vocab_size, args.seq_len)
    print(f"[3] training {cfg.name}: {cfg.params_count()['total']/1e6:.1f}M params "
          f"on {tokens_all.shape[0]} records")

    params = params_lib.materialize(transformer.model_specs(cfg), 0, device=dev)
    tcfg = step_lib.TrainConfig(
        adamw=opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps),
        ce_chunk=args.seq_len,
    )
    state = opt.init_state(params, tcfg.adamw)
    tstep = step_lib.make_train_step(cfg, tcfg)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    rng = np.random.default_rng(0)
    t0, losses = time.time(), []
    for step in range(args.steps):
        idx = rng.integers(0, tokens_all.shape[0], size=args.batch)
        toks = torch.from_numpy(tokens_all[idx]).to(dev, torch.long)
        batch = {
            "tokens": toks,
            "labels": torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -1)], dim=1),
        }
        params, state, m = tstep(params, state, batch)
        losses.append(float(m["loss"]))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"    step {step:4d} loss {losses[-1]:.4f}")
        if mgr and step % 50 == 49:
            mgr.save(step + 1, {"params": params, "opt": state})
    dt = time.time() - t0
    print(f"[3] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({args.steps/dt:.1f} steps/s)")
    assert losses[-1] < losses[0], "training should reduce loss"


if __name__ == "__main__":
    main()
