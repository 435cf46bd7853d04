"""Distributed MATE on the PyTorch port: the paper's filter as a sharded
workload.

Opens a ``MateSession`` on a synthetic lake, shards its super keys over a
process group (``repro_torch.launch.mesh``: one process per rank; here a
group of one, joined in this process), replicates the query keys, and runs
the subsumption filter + per-table candidate counting with an all-reduce —
the layout that scales the online phase to larger corpora.  The per-shard
filter impl resolves from the SAME backend registry the session uses (a
fused backend runs kernel B.1 once per shard).  The twin of
``examples/distributed_discovery.py``: the same lake, queries and printed
lines; its 1x1 mesh is a group of one rank on the 'data' axis with a
'model' axis of 1.

    PYTHONPATH=src python examples/torch_distributed_discovery.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

import numpy as np
import torch

from repro_torch.core import discovery, distributed
from repro_torch.core.session import DiscoveryConfig, MateSession
from repro_torch.core.xash import lanes_to_torch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as meshlib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=600, seed=11))
    session = MateSession.build(corpus, DiscoveryConfig(k=10), device=dev)
    queries = synthetic.make_mixed_queries(corpus, 3, 30, 2, seed=12)
    print(f"lake: {corpus.total_rows} rows / {len(corpus.tables)} tables; {session}")

    # host engine for reference
    q, q_cols = queries[0]
    topk, stats = session.discover(q, q_cols)
    print(f"batched engine top-3: {[(e.table_id, e.joinability) for e in topk[:3]]} "
          f"(precision {stats.precision:.3f})")

    # row-sharded filter over a one-rank group, impl resolved from the
    # session's backend
    index = session.index
    backend, devices = meshlib.rank_layout(1, dev)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = meshlib.make_mesh(os.path.join(tmp, "store"), 1, 0, backend=backend,
                                 device=devices[0])
        try:
            row_tables = np.asarray(
                corpus.table_of_row(np.arange(corpus.total_rows)), dtype=np.int32
            )
            sk, rt = distributed.shard_corpus_rows(index.superkeys, row_tables, mesh)
            _keys, sk_of_key = discovery.build_query_superkeys(index, q, q_cols)
            qsk = lanes_to_torch(np.stack(list(sk_of_key.values())), mesh.device)
            filt = distributed.make_distributed_filter(
                mesh, len(corpus.tables), backend=session.backend
            )
            t0 = time.perf_counter()
            table_counts, key_counts = filt(sk, rt, qsk)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            tc = table_counts.cpu().numpy()
            shape = {distributed.MESH_AXES[0]: mesh.size, "model": 1}
            print(f"distributed filter (impl="
                  f"{distributed.shard_impl_for(session.backend)}): {tc.sum()} candidate "
                  f"rows in {(tc > 0).sum()} tables ({time.perf_counter()-t0:.3f}s on mesh "
                  f"{shape})")
        finally:
            meshlib.close_mesh(mesh)
    top_tables = np.argsort(-tc)[:5]
    print(f"most candidate-dense tables: {[(int(t), int(tc[t])) for t in top_tables]}")


if __name__ == "__main__":
    main()
