#!/usr/bin/env python3
"""The routed lake's mesh mode over NCCL, one rank per card.

    python3 tools/nccl_mesh_check.py [--n-tables 20000] [--seed 0]

Needs two or more CUDA cards and ``nvcc``; every visible card becomes one
rank (``launch.mesh.run_ranks`` with its default devices, rank r on
``cuda:r``).  Each rank builds the routed session across the group (kernel
B.3 on its value block, the arena assembled by an NCCL ``all_gather`` of
CUDA tensors), launches B.2 (B.4 past the table cap) over its own shard
against its own store, and all-reduces the counts over NCCL; it also runs
``make_distributed_filter`` under 'fused', 'blocked' and 'broadcast' over
its block of the single-host rows.  The parent holds every rank's counts
against the host-routed session (its shards placed round robin on the
same cards) and the filter against ``filter_counts_local_blocked`` over
all rows, and checks that every collective's input lay on the rank's card.
It uses ``chip_smoke.py``'s lake (same ``--n-tables`` and ``--seed``) and
rank body.  Prints one JSON line, then the first card's name and power limit;
exits 1 when a check fails and 2 without two cards.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

FILTER_IMPLS = ("fused", "blocked", "broadcast")
TIMEOUT_S = 600.0


def nccl_rank(mesh, corpus, groups, q_keys):
    """One rank: ``chip_smoke.routed_mesh_rank`` (routed session built and
    counted across the group) plus the pre-routed row filter, with the
    device of every collective's input recorded."""
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.core import index as index_lib
    from repro_torch.core.xash import lanes_to_torch

    seen: set[str] = set()
    for name, arg in (("all_reduce", 0), ("all_gather", 1)):
        def recording(*a, _fn=getattr(dist, name), _arg=arg, **kw):
            seen.add(str(a[_arg].device))
            return _fn(*a, **kw)
        setattr(dist, name, recording)

    out = chip_smoke.routed_mesh_rank(mesh, corpus, groups)
    base = index_lib.build_index(corpus, use_corpus_char_freq=True, device=mesh.device)[0]
    row_tables = corpus.table_of_row(np.arange(corpus.total_rows)).astype(np.int32)
    sk, rt = distributed.shard_corpus_rows(base.superkeys, row_tables, mesh)
    q_sk = lanes_to_torch(base.superkey_of_keys(q_keys), mesh.device)
    out["filter"] = {}
    for impl in FILTER_IMPLS:
        tc, kc = distributed.make_distributed_filter(mesh, len(corpus.tables), backend=impl)(
            sk, rt, q_sk)
        out["filter"][impl] = (tc.tolist(), kc.tolist())
    out["collective_devices"] = sorted(seen)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-tables", type=int, default=20000, help="tables in the lake")
    ap.add_argument("--seed", type=int, default=0, help="seed of the lake")
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("nccl_mesh_check: needs two or more CUDA cards", file=sys.stderr)
        return 2
    from repro_torch.core import distributed
    from repro_torch.core import index as index_lib
    from repro_torch.core.session import DiscoveryConfig, MateSession
    from repro_torch.core.xash import lanes_to_torch
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as meshlib

    world = torch.cuda.device_count()
    build_s = _build.build_all()
    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=args.n_tables, seed=args.seed))
    truth = []
    for i in range(chip_smoke.N_TRUTH):
        query, q_cols, _expected, corpus = synthetic.make_query_with_ground_truth(
            corpus, n_rows=30, seed=args.seed + 1 + i)
        truth.append((query, q_cols))
    mixed = synthetic.make_mixed_queries(corpus, chip_smoke.GROUP, 20, seed=args.seed + 100)
    groups = {"truth": truth, "mixed": list(mixed)}

    # host-routed: world shards on the same cards, round robin
    t = time.perf_counter()
    routed = MateSession.build(corpus, DiscoveryConfig(), distributed=True, n_shards=world)
    host_build_s = time.perf_counter() - t
    host_counts = {label: [pc.counts.tolist() for pc in routed.plan_and_count(group)]
                   for label, group in groups.items()}
    arena = hashlib.sha256(routed.index.value_lanes.tobytes()).hexdigest()
    query, q_cols = truth[0]
    q_keys = list(dict.fromkeys(tuple(r[c] for c in q_cols) for r in query.cells))
    single = index_lib.build_index(corpus, use_corpus_char_freq=True)[0]
    row_tables = torch.from_numpy(
        corpus.table_of_row(np.arange(corpus.total_rows)).astype(np.int32)).cuda()
    tc, kc = distributed.filter_counts_local_blocked(
        lanes_to_torch(single.superkeys, "cuda"), row_tables,
        lanes_to_torch(single.superkey_of_keys(q_keys), "cuda"), len(corpus.tables))
    want_filter = (tc.tolist(), kc.tolist())
    del single, row_tables

    t = time.perf_counter()
    ranks = meshlib.run_ranks(nccl_rank, world, backend="nccl", args=(corpus, groups, q_keys),
                              timeout_s=TIMEOUT_S)
    mesh_s = time.perf_counter() - t
    checks = {
        "counts_equal_host_routed": all(r["counts"] == host_counts for r in ranks),
        "arena_equal": all(r["value_lanes"] == arena for r in ranks),
        "filter_equal": {impl: all(tuple(r["filter"][impl]) == want_filter for r in ranks)
                         for impl in FILTER_IMPLS},
        "stores_on_own_card": all(r["store_device"] == f"cuda:{r['rank']}" for r in ranks),
        "collectives_on_own_card": all(r["collective_devices"] == [f"cuda:{r['rank']}"]
                                       for r in ranks),
        "b2_launched": all(r["launches"]["gather_filter_table_counts"] > 0 for r in ranks),
    }
    ok = all(all(v.values()) if isinstance(v, dict) else v for v in checks.values())
    print(json.dumps({
        "tool": "nccl_mesh_check", "ok": ok, "backend": "nccl", "world_size": world,
        "tables": len(corpus.tables), "rows": corpus.total_rows, "kernel_build_s": build_s,
        "checks": checks, "host_routed_build_s": host_build_s, "mesh_wall_s": mesh_s,
        "ranks": [{k: r[k] for k in ("rank", "device", "store_device", "collective_devices",
                                     "build_s", "wall_s", "launches")} for r in ranks],
    }), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
