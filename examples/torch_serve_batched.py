"""Batched serving example on the PyTorch port: LLM decode ticks
interleaved with MATE discovery.

    PYTHONPATH=src python examples/torch_serve_batched.py [--arch qwen1.5-0.5b] [--device cpu]

Two request classes share one host loop:

  * token generation — slot-batched prefill+decode (``ServeEngine``, flash
    attention kernel B.6 on CUDA) for the reduced config of any
    architecture (whisper and the VLM with their stub frontends' inputs);
  * join discovery — a ``DiscoveryEngine`` over a ``MateSession``: requests
    queue with an arrival-window policy (group size ``--disc-batch``,
    deadline ``--flush-after``) and the loop calls ``pump()`` between decode
    ticks, so a discovery group launches the moment its window fills or its
    deadline expires — without stalling decode while the window is open.

The twin of ``examples/serve_batched.py``: the same flags (plus
``--device``), lake, prompts and printed lines.  Sampled tokens differ from
the reference's: the port draws from a ``torch.Generator``, not
``jax.random``.
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.session import DiscoveryConfig, MateSession
from repro_torch.data import synthetic
from repro_torch.data.pipeline import stub_inputs
from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.engine import DiscoveryEngine, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--disc-requests", type=int, default=6)
    ap.add_argument("--disc-batch", type=int, default=4)
    ap.add_argument("--flush-after", type=float, default=0.05)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- discovery side: one session over a synthetic lake ----
    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=120, seed=9))
    session = MateSession.build(
        corpus,
        DiscoveryConfig(k=5, window=args.disc_batch, flush_after=args.flush_after),
        device=dev,
    )
    disc = DiscoveryEngine(session=session)
    disc_queries = synthetic.make_mixed_queries(
        corpus, args.disc_requests, 12, 2, seed=10
    )
    print(f"lake: {corpus.total_rows} rows; {session}")

    # ---- LLM side: slot-batched decode ----
    cfg = configs.reduce_config(configs.get_config(args.arch))
    model = TransformerLM.init(cfg, seed=0, device=dev)
    engine = ServeEngine(model, batch=args.batch, max_seq=64, temperature=args.temperature,
                         extra_inputs=stub_inputs(cfg, args.batch, device=dev))
    rng = np.random.default_rng(1)
    reqs = [
        Request(prompt=list(rng.integers(2, cfg.vocab_size, rng.integers(3, 12))),
                max_new=args.max_new)
        for _ in range(args.requests)
    ]

    # interleave: submit a discovery request every other decode tick and
    # pump the discovery engine after every tick — groups launch when the
    # window fills or the oldest request's deadline expires, decode never
    # waits on an open window.
    disc_iter = iter(disc_queries)
    disc_served = 0

    def tick(step: int) -> None:
        nonlocal disc_served
        if step % 2 == 0:
            nxt = next(disc_iter, None)
            if nxt is not None:
                disc.submit(nxt[0], nxt[1])
        disc_served += len(disc.pump())

    engine.on_tick = tick  # ServeEngine calls this between decode steps
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    disc_served += len(disc.flush())  # drain any open window at shutdown
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    print(f"{cfg.name}: {len(done)} requests, {n_tok} new tokens, "
          f"{n_tok/dt:.1f} tok/s ({dev.type.upper()}, reduced config)")
    for i, r in enumerate(done[:4]):
        print(f"  req{i}: prompt={r.prompt[:5]}... -> {r.out}")
    print(f"discovery: {disc_served}/{len(disc_queries)} requests served "
          f"between decode ticks (window={disc.batch}, "
          f"flush_after={disc.flush_after}s, backend={session.backend.name}); "
          f"precision={session.stats.precision:.3f}")


if __name__ == "__main__":
    main()
