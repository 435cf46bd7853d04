"""Quickstart on the PyTorch port: MATE in five minutes.

Builds a small synthetic data lake, opens a ``MateSession`` on it (one
frozen ``DiscoveryConfig``, one resolved filter backend), runs top-k
multi-attribute join discovery, and shows the filtering statistics the
paper is about.  The twin of ``examples/quickstart.py`` on
``repro_torch``: the same lake, queries and printed lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

from repro_torch.core.session import DiscoveryConfig, MateSession
from repro_torch.data import synthetic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    # 1. a synthetic "data lake" with webtable-like statistics
    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=200, seed=0))
    print(f"lake: {len(corpus.tables)} tables, {corpus.total_rows} rows, "
          f"{len(corpus.unique_values)} unique values")

    # 2. a query table with a 2-column composite key, with known joins
    query, q_cols, expected, corpus = synthetic.make_query_with_ground_truth(
        corpus, n_rows=20, key_width=2, n_joinable_tables=6
    )

    # 3. offline phase: ONE config object, ONE session — the session builds
    #    the inverted index + XASH super keys on the device and resolves the
    #    filter backend (config > the backend env var > platform default:
    #    the gather kernel on CUDA)
    config = DiscoveryConfig(bits=128, k=5)
    session = MateSession.build(corpus, config, device=args.device)
    print(f"indexed with {session.bits}-bit XASH "
          f"(c={session.index.cfg.c}, ones={session.index.cfg.ones}); "
          f"filter backend: {session.backend.name} "
          f"[resolved from {session.backend.source}]")

    # 4. online phase: top-k n-ary join discovery (batched Algorithm 1 —
    #    bit-identical to the faithful scalar engine in core/discovery.py)
    topk, stats = session.discover(query, q_cols)
    print("\ntop-5 joinable tables (table_id, joinability, column mapping):")
    for e in topk:
        print(f"  table {e.table_id:4d}  j={e.joinability:3d}  mapping={e.mapping}")
    print(f"\nexpected ≥: {dict(sorted(expected.items(), key=lambda kv: -kv[1])[:5])}")
    print(
        f"stats: {stats.pl_items_total} PL items fetched, "
        f"{stats.filter_checks} super-key probes, "
        f"{stats.filter_passed} passed, precision={stats.precision:.3f}, "
        f"rule1-pruned={stats.tables_pruned_rule1} tables"
    )
    print(f"session: {session}")


if __name__ == "__main__":
    main()
