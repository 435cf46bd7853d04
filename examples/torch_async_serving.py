"""Asyncio serving-tier example on the PyTorch port: bounded queue,
admission control, caches.

    PYTHONPATH=src python examples/torch_async_serving.py [--requests 60] [--device cpu]

Zipf-skewed discovery traffic (a few hot query tables dominate) flows
through ``AsyncDiscoveryEngine`` — a background pump task groups requests
into shared filter launches (kernel B.2 on CUDA), while the serving tier in
front of it does the work of a production deployment:

  * a BOUNDED submit queue with admission control: under pressure requests
    are shed (``AdmissionError``) or degraded to 128-bit filtering — a pure
    relaxation, so degraded answers stay bit-identical;
  * a query-result cache answering repeated queries at submit time and a
    hot-table bound cache that skips gather+filter for warm queries at any
    ``k`` — both invalidated the moment a §5.4 index mutation lands.

The twin of ``examples/async_serving.py``: the same flags (plus
``--device``), lake, traffic and printed lines.
"""

import argparse
import asyncio
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

import numpy as np

from repro_torch.core.session import DiscoveryConfig, MateSession
from repro_torch.data import synthetic
from repro_torch.serve.engine import AdmissionError, AsyncDiscoveryEngine


async def run(args) -> None:
    corpus = synthetic.make_corpus(
        synthetic.SyntheticSpec(n_tables=args.n_tables, seed=3)
    )
    session = MateSession.build(
        corpus,
        DiscoveryConfig(
            k=5,
            window=args.window,
            flush_after=args.flush_after,
            max_queue=args.max_queue,
            pressure_policy=args.pressure_policy,
            result_cache=64,
            bound_cache=64,
        ),
        device=args.device,
    )
    print(f"lake: {corpus.total_rows} rows; {session}")

    distinct = synthetic.make_mixed_queries(corpus, 12, 10, 2, seed=10)
    rng = np.random.default_rng(7)
    probs = np.arange(1, len(distinct) + 1, dtype=np.float64) ** -1.1
    probs /= probs.sum()
    traffic = rng.choice(len(distinct), size=args.requests, p=probs)

    lat: list[float] = []
    shed = 0

    async def one(qi: int, eng: AsyncDiscoveryEngine) -> None:
        nonlocal shed
        q, q_cols = distinct[qi]
        t0 = time.perf_counter()
        try:
            await eng.discover_async(q, q_cols)
        except AdmissionError:
            shed += 1  # bounded queue at capacity: rejected, not hung
            return
        lat.append(time.perf_counter() - t0)

    async with AsyncDiscoveryEngine(session=session) as eng:
        # waves, not one burst: the first wave primes the caches (and shows
        # admission control under the burst), later waves repeat the hot
        # queries and resolve straight from the result cache at submit
        wave = max(args.window * 3, 12)
        for i in range(0, len(traffic), wave):
            await asyncio.gather(
                *(one(int(qi), eng) for qi in traffic[i : i + wave])
            )

        st = session.stats
        lat_us = np.asarray(lat) * 1e6
        print(
            f"served {len(lat)}/{args.requests} "
            f"(cache_hits={st.cache_hits}, bound_hits={st.bound_hits}, "
            f"shed={st.shed}, degraded={st.degraded}, "
            f"pump_errors={eng.pump_errors})"
        )
        if len(lat):
            print(
                f"latency: p50={np.percentile(lat_us, 50):.0f}us "
                f"p99={np.percentile(lat_us, 99):.0f}us"
            )

        # §5.4 invalidation: a mutation bumps the index epoch, so the next
        # request for a hot query re-discovers instead of replaying a stale
        # top-k — correctness over hit rate, always.
        hot_q, hot_cols = distinct[0]
        hits_before = st.cache_hits
        session.insert_table([[r[c] for c in hot_cols] for r in hot_q.cells])
        req = await eng.discover_async(hot_q, hot_cols)
        print(
            f"after insert_table: from_cache={req.from_cache} "
            f"(hits {hits_before} -> {st.cache_hits}) — the mutation "
            f"invalidated every cached entry"
        )
        if req.from_cache:
            raise RuntimeError("a cached answer survived insert_table")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--n-tables", type=int, default=120)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--flush-after", type=float, default=0.02)
    ap.add_argument("--max-queue", type=int, default=8)
    ap.add_argument("--pressure-policy", default="degrade",
                    choices=["shed", "degrade"])
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
