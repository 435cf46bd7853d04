"""Dry run of the paper's own workload: the distributed super-key filter
AND the sharded offline index build (port of ``repro.launch.dryrun_mate``).

The filter cells trace rank 0's shard of the corpus-sharded subsumption
filter (``core.distributed.make_distributed_filter``: rows over every rank,
queries replicated, the per-table and per-key counts all-reduced) at
DWTC scale, on a dry one-axis mesh of 256 or 512 ranks
(``launch.mesh.dry_mesh``), under ``FakeTensorMode``: nothing is allocated,
nothing launched, and no card is needed.  The record has the LM cells'
schema (``launch.dryrun``), so ``benchmarks/roofline.py`` includes
'mate-filter' rows, plus ``all_reduces``: the bytes of the table-count and
the key-count all-reduce (an ``int32[2^20]`` is 4 MiB).  ``--impl`` takes
the reference's two shard bodies, 'broadcast' and 'blocked'; the fused
body (kernel B.1) takes at most 8192 tables per launch, not 2^20.  Super
keys are the port's ``int32[rows, 4]`` (uint32 bit patterns, the bytes of
the reference's ``uint32``).

``--build-shards N`` (default 8, 0 disables) runs the real sharded OFFLINE
build: a 60-table corpus (seed 7) built through ``MateSession.build(...,
mesh=...)`` on N gloo ranks (``launch.mesh.run_ranks``; on the card by
default, on the CPU with ``--device cpu``), held byte-identical to the
single-host build (``core.index.index_artifacts_equal``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_mate [--impl blocked]
        [--shape filter_1g] [--build-shards N] [--device cpu] [--out-dir D]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.core import distributed
from repro_torch.launch import dryrun, hlo_cost, mesh as meshlib
from repro_torch.launch.dryrun import RESULTS_DIR, LiveStorages, _collectives, _storages, trace_device

# DWTC scale: 1.45B rows; per 2-pod step we filter a 2^30-row shard set
SHAPES = {
    "filter_1g": dict(rows=1 << 30, keys=256, n_tables=1 << 20),
    "filter_dwtc": dict(rows=1_450_000_000, keys=128, n_tables=1 << 20),
}
LANES = 4


def lower(shape_name: str, multi_pod: bool, impl: str) -> dict:
    """Trace rank 0's filter shard (module docstring) and return its
    record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    spec = SHAPES[shape_name]
    n_shards = 512 if multi_pod else 256
    dev = trace_device()
    mesh = meshlib.dry_mesh(n_shards, device=dev)
    rows = -(-spec["rows"] // n_shards) * n_shards
    per = rows // n_shards
    with dryrun.no_launch() as seen, FakeTensorMode():
        args = (torch.empty(per, LANES, dtype=torch.int32, device=dev),  # super keys
                torch.empty(per, dtype=torch.int32, device=dev),  # row -> table (-1 pads)
                torch.empty(spec["keys"], LANES, dtype=torch.int32, device=dev))  # query keys
        fn = distributed.make_distributed_filter(mesh, spec["n_tables"], backend=impl)
        arg_st = _storages(args)
        t0 = time.time()
        with LiveStorages(arg_st) as live:
            (tc, kc), hc = hlo_cost.measure(fn, *args)
        trace_s = time.time() - t0
        out_st = _storages((tc, kc))
    return {
        "arch": "mate-filter",
        "shape": shape_name + ("" if impl == "broadcast" else f"-{impl}"),
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_shards,
        "variant": {"name": impl},
        "compile_seconds": round(trace_s, 1),
        "memory_analysis": {
            "argument_size_in_bytes": int(sum(arg_st.values())),
            "output_size_in_bytes": int(sum(out_st.values())),
            "temp_size_in_bytes": int(live.peak),
        },
        "cost_analysis": {"flops": hc["flops"]},
        "collectives": _collectives(hc),
        "hlo_cost": hc,
        "all_reduces": {"table_counts": tc.numel() * tc.element_size(),
                        "key_counts": kc.numel() * kc.element_size()},
        # filter has no params; 'useful work' = 1 subsumption test per
        # (row × key): 4 AND + 4 CMP ops ≈ 8 int ops
        "params_total": 0.0,
        "params_active": 0.0,
        "kind": "filter",
        "global_batch": spec["keys"],
        "seq_len": spec["rows"],
        "probe_ops": float(spec["rows"]) * spec["keys"] * 8,
        "stream_bytes": float(rows) * (LANES * 4 + 4),
        "trace_device": dev,
        "kernel_launches": seen["launches"],
    }


def build_rank(mesh, corpus) -> dict:
    """One rank of the sharded build: ``MateSession.build`` across the
    group; rank 0 also builds the single-host index and compares.  Returns
    the rank's build stats, seconds and kernel launches (on the card: B.3
    for its shard, and on rank 0 for the single-host index too)."""
    from repro_torch.core import xash
    from repro_torch.core.index import MateIndex, index_artifacts_equal
    from repro_torch.core.session import DiscoveryConfig, MateSession

    t0, before = time.time(), dryrun.kernel_counts()
    session = MateSession.build(corpus, DiscoveryConfig(bits=128), mesh=mesh)
    out = {"stats": session.build_stats, "seconds": time.time() - t0}
    if mesh.rank == 0:
        ref = MateIndex(corpus, cfg=xash.XashConfig(bits=128), use_corpus_char_freq=True, device=mesh.device)
        out["identical"] = index_artifacts_equal(session.index, ref)
    out["launches"] = {k: n - before[k] for k, n in dryrun.kernel_counts().items()}
    return out


def exercise_sharded_build(n_shards: int, device=None) -> dict:
    """The real sharded offline build on ``n_shards`` spawned ranks
    (``device``: None for the card, 'cpu'), verified byte-identical to the
    single-host pass; raises when it is not.  Returns rank 0's report."""
    from repro_torch.data import synthetic

    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=60, seed=7))
    backend, devices = meshlib.rank_layout(n_shards, device)
    if devices[0] != "cpu":  # one build of the kernels for every rank
        from repro_torch.kernels import _build

        _build.build_all()
    t0 = time.time()
    ranks = meshlib.run_ranks(build_rank, n_shards, backend=backend, devices=devices, args=(corpus,),
                              timeout_s=600.0)
    stats, identical = ranks[0]["stats"], ranks[0]["identical"]
    print(
        f"[build] sharded offline build on {n_shards} ranks ({backend}, {devices[0]}): "
        f"{stats.values_total} unique values, {stats.bytes_hashed} bytes "
        f"hashed, hash={stats.hash_seconds:.2f}s merge={stats.merge_seconds:.3f}s "
        f"({time.time()-t0:.1f}s total) identical_to_single_host={identical}",
        flush=True,
    )
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    print(f"[build] kernel launches over the ranks: {json.dumps(launches)}", flush=True)
    assert identical, "sharded build diverged from the single-host pass"
    return {"n_shards": n_shards, "identical": identical, "values_total": stats.values_total,
            "seconds": time.time() - t0, "launches": launches}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default=None, choices=[None, "broadcast", "blocked"])
    ap.add_argument("--shape", default="filter_1g")
    ap.add_argument("--build-shards", type=int, default=8,
                    help="also run the sharded index build on this many ranks (0 disables)")
    ap.add_argument("--device", default=None, help="the build ranks' device: 'cuda' (default) or 'cpu'")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    if args.build_shards:
        exercise_sharded_build(args.build_shards, args.device)
    impls = [args.impl] if args.impl else ["broadcast", "blocked"]
    out_dir = args.out_dir or os.path.abspath(RESULTS_DIR)
    os.makedirs(out_dir, exist_ok=True)
    for impl in impls:
        for mp in (False, True):
            tag = "2x16x16" if mp else "16x16"
            name = f"mate-filter__{args.shape}-{impl}__{tag}.json"
            path = os.path.join(out_dir, name)
            print(f"[lower] {name}", flush=True)
            try:
                rec = lower(args.shape, mp, impl)
            except Exception:
                rec = {"error": traceback.format_exc()}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if "error" in rec:
                print(rec["error"].splitlines()[-1])
            else:
                ma = rec["memory_analysis"]
                hc = rec["hlo_cost"]
                print(
                    f"  ok {rec['compile_seconds']}s args/dev="
                    f"{ma['argument_size_in_bytes']/1e9:.2f}GB "
                    f"temp={ma['temp_size_in_bytes']/1e9:.2f}GB "
                    f"coll={hc['collective_bytes_total']/1e6:.1f}MB",
                    flush=True,
                )


if __name__ == "__main__":
    main()
