"""MATE discovery service driver:
``python -m repro_torch.launch.discovery [--n-tables 400] [--queries 5]
[--hash xash] [--bits 128|256|512] [--backend fused-gather|fused|pallas|xla|numpy|auto]
[--device cuda|cpu]``

Port of ``repro.launch.discovery``: every flag of the reference, with the
same names, defaults and choices, plus ``--device`` (default: the CUDA
device; ``--device cpu`` runs the plain PyTorch path).  It prints the same
``[mate]`` lines in the same order and words.

End-to-end run of the paper's system on a synthetic lake through the unified
``MateSession`` surface: build the session (offline phase), run top-k n-ary
join discovery (online phase) with both the faithful Algorithm 1 engine and
the session's batched engine, and report the paper's metrics (precision, FP
counts, filtering power, runtimes).

``--backend`` pins the §6.3 filter backend through ``DiscoveryConfig`` — the
highest-precedence level of the registry (config > the backend variable,
``registry.ENV_VAR`` > platform default); omitted, the session resolves it
per that rule.

The reference's JAX meshes become process groups (``launch.mesh``): one
process per rank, the ranks sharing one card over gloo or each on a card of
its own over NCCL (``mesh.rank_layout``), every rank on the CPU over gloo
under ``--device cpu``.

``--build-mesh N`` shards the OFFLINE phase: N spawned ranks each build the
session across the group (``MateSession.build(..., mesh=...)``: unique-value
hashing split over the ranks, ``all_gather``, host-side posting merge).  The
driver checks that every rank's artifacts (value lanes, super keys, posting
lists) are byte-identical to the single-host build it serves the queries
from, and prints the ranks' ``BuildStats``.

``--route-shards N`` builds a ROUTED lake on top: a ``ShardedMateIndex``
(``MateSession.build(..., distributed=True, n_shards=N)``) that keeps each
shard's postings, superkeys, and device store resident where the shard was
built and routes every query to the data — only int32 per-table count
vectors cross a shard boundary.  The driver replays the same queries
through the routed session, exits on any top-k that is not bit-identical to
the single-host engines, and prints the cross-shard traffic
(``route_bytes_merged``) next to the superkey bytes a host-gather path
would have shipped.

``--mesh dxm`` additionally runs the distributed row filter
(``core.distributed.make_distributed_filter``) over a d×m grid of ranks
(``launch.mesh.GridMesh`` {'data': d, 'model': m}), the rows split over
'data' and replicated over 'model', the counts all-reduced over 'data'
only, to show the corpus-sharded layout; every rank's counts must agree.
The default 1x1 is a one-rank group in this process.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import discovery
from repro_torch.core import distributed
from repro_torch.core import fd as fd_lib
from repro_torch.core.corpus import Table
from repro_torch.core.session import DiscoveryConfig, MateSession
from repro_torch.core.xash import lanes_to_torch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.kernels import filter_kernel, registry
from repro_torch.launch import mesh as meshlib
from repro_torch.serve.engine import DiscoveryEngine

# a spawned rank's whole life (start, group join, work) must fit in this
RANK_TIMEOUT_S = 600.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_grid(spec: str) -> dict:
    """``'dxm'`` -> the row filter's grid ``{'data': d, 'model': m}``."""
    try:
        dp, mp = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxM (for example 1x1), got {spec!r}") from None
    if dp < 1 or mp < 1:
        raise ValueError(f"--mesh {spec}: both axes must be >= 1")
    return {"data": dp, "model": mp}


def index_digest(index) -> str:
    """sha256 of an index's build artifacts: value lanes, super keys and
    every posting list in value-id order."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(index.value_lanes).tobytes())
    h.update(np.ascontiguousarray(index.superkeys).tobytes())
    for vid in sorted(index.postings):
        h.update(np.int64(vid).tobytes())
        h.update(np.ascontiguousarray(index.postings[vid]).tobytes())
    return h.hexdigest()


def _launches() -> dict[str, int]:
    return {"filter_table_counts": filter_kernel.filter_table_counts.launches,
            "filter_match": filter_kernel.filter_match.launches}


def mesh_build_rank(mesh, corpus, config) -> dict:
    """One rank of ``--build-mesh``: build the session across the group and
    return its ``BuildStats``, its wall seconds and its artifacts' digest."""
    t0 = time.perf_counter()
    session = MateSession.build(corpus, config, mesh=mesh)
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    return {"build_stats": session.build_stats, "seconds": seconds,
            "digest": index_digest(session.index)}


def mesh_build(corpus, config, world: int, device) -> list[dict]:
    """``mesh_build_rank`` on ``world`` spawned ranks (results in rank order)."""
    backend, devices = meshlib.rank_layout(world, device)
    return meshlib.run_ranks(mesh_build_rank, world, backend=backend, devices=devices,
                             args=(corpus, config), timeout_s=RANK_TIMEOUT_S)


def mesh_filter_rank(mesh, superkeys, row_tables, query_sk, n_tables, backend) -> dict:
    """One rank of ``--mesh``: filter this rank's row block (its rows over
    'data') against the replicated query keys and all-reduce the counts
    over 'data'.  Returns the counts, the seconds to the all-reduced counts
    on the device, and this rank's B.1 / B.4 launches."""
    sk, rt = distributed.shard_corpus_rows(superkeys, row_tables, mesh, ("data",))
    qsk = lanes_to_torch(query_sk, mesh.device)
    fn = distributed.make_distributed_filter(mesh, n_tables, ("data",), backend=backend)
    before = _launches()
    t0 = time.perf_counter()
    tc, kc = fn(sk, rt, qsk)
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    after = _launches()
    return {"table_counts": tc.cpu().numpy(), "key_counts": kc.cpu().numpy(),
            "seconds": seconds, "launches": {k: after[k] - before[k] for k in after}}


def mesh_filter(superkeys, row_tables, query_sk, n_tables, backend, grid: dict, device) -> list[dict]:
    """``mesh_filter_rank`` over the ranks of ``grid`` ({'data': d,
    'model': m}): one rank joins a group of one in this process, more are
    spawned, each with its ``GridMesh``.  Results in rank order."""
    world = grid["data"] * grid["model"]
    group, devices = meshlib.rank_layout(world, device)
    args = (superkeys, row_tables, query_sk, n_tables, backend)
    if world > 1:
        return meshlib.run_ranks(mesh_filter_rank, world, backend=group, devices=devices,
                                 args=args, timeout_s=RANK_TIMEOUT_S, grid=grid)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = meshlib.make_mesh(os.path.join(tmp, "store"), 1, 0, backend=group,
                                 device=devices[0])
        try:
            return [mesh_filter_rank(mesh, *args)]
        finally:
            meshlib.close_mesh(mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-tables", type=int, default=400)
    ap.add_argument("--queries", type=int, default=5)
    ap.add_argument("--rows", type=int, default=25)
    ap.add_argument("--key-width", type=int, default=2)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--hash", default="xash",
                    choices=["xash", "bf", "ht", "murmur", "md5", "city", "simhash"])
    ap.add_argument("--bits", type=int, default=128, choices=[128, 256, 512],
                    help="superkey hash width (uint32 lanes = bits/32)")
    ap.add_argument("--backend", default=None, choices=registry.backend_names(),
                    help="filter backend (config-level pin; default: "
                         "the backend variable, then platform default)")
    ap.add_argument("--rank", default="quality", choices=["quality", "count"],
                    help="result ordering: join-quality scoring head "
                         "(default) or exact-joinability count order; the "
                         "verified top-k SET is identical either way")
    ap.add_argument("--no-profile-gate", action="store_true",
                    help="disable the column-profile candidate gate "
                         "(pure pruning; results are set-identical with it "
                         "on or off)")
    ap.add_argument("--flush-after", type=float, default=None,
                    help="serving deadline (s) for partial DiscoveryEngine groups")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded submit queue: admission control kicks in at "
                         "this many waiting requests (default: unbounded)")
    ap.add_argument("--pressure-policy", default="shed",
                    choices=["shed", "degrade"],
                    help="at max_queue: reject with AdmissionError, or admit "
                         "at degraded 128-bit filtering (still bit-identical)")
    ap.add_argument("--fds", action="store_true",
                    help="also run the FD workload (core.fd): test a "
                         "candidate functional dependency det-cols -> "
                         "dependent against every joining lake table, no "
                         "join materialized")
    ap.add_argument("--fd-signals", action="store_true",
                    help="order FD candidates by the multi-signal ensemble "
                         "(joinability + uniqueness + sketch + name) instead "
                         "of raw support")
    ap.add_argument("--result-cache", type=int, default=0,
                    help="query-result cache capacity (0: off) — repeated "
                         "queries answer at submit, invalidated on mutations")
    ap.add_argument("--bound-cache", type=int, default=0,
                    help="hot-table bound cache capacity (0: off) — warm "
                         "queries skip gather+filter at any k")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: run the distributed row filter over a D×M "
                         "grid of ranks, rows over D, replicated over M")
    ap.add_argument("--build-mesh", type=int, default=1, metavar="N",
                    help="shard the offline index build over an N-rank "
                         "process group and check it byte-identical to the "
                         "single-host build")
    ap.add_argument("--route-shards", type=int, default=0, metavar="N",
                    help="also build an N-shard routed lake "
                         "(ShardedMateIndex) and replay the queries through "
                         "it: shard-local filter launches, count-only merge, "
                         "bit-identical top-k asserted against single-host")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    mesh_grid = _mesh_grid(args.mesh)
    dev = resolve_device(args.device)

    print(f"[mate] building corpus ({args.n_tables} tables) ...")
    corpus = synthetic.make_corpus(
        synthetic.SyntheticSpec(n_tables=args.n_tables, seed=args.seed)
    )
    config = DiscoveryConfig(
        bits=args.bits, k=args.k, backend=args.backend, hash_name=args.hash,
        rank=args.rank, profile_gate=not args.no_profile_gate,
        flush_after=args.flush_after, max_queue=args.max_queue,
        pressure_policy=args.pressure_policy, result_cache=args.result_cache,
        bound_cache=args.bound_cache,
        signals=fd_lib.DEFAULT_SIGNALS if args.fd_signals else None,
    )
    t0 = time.perf_counter()
    session = MateSession.build(corpus, config, device=dev)
    _sync(dev)
    t_build = time.perf_counter() - t0
    index = session.index
    if args.build_mesh > 1:
        ranks = mesh_build(corpus, config, args.build_mesh, dev)
        want = index_digest(index)
        bad = [r for r, out in enumerate(ranks) if out["digest"] != want]
        if bad:
            raise SystemExit(
                f"[mate] --build-mesh {args.build_mesh}: ranks {bad} built"
                " artifacts that differ from the single-host build"
            )
        session.build_stats, t_build = ranks[0]["build_stats"], ranks[0]["seconds"]
    print(
        f"[mate] offline phase: indexed {corpus.total_rows} rows, "
        f"{len(corpus.unique_values)} unique values in {t_build:.2f}s "
        f"(hash={args.hash}, bits={session.bits}, lanes={index.cfg.lanes}, "
        f"backend={session.backend.name}[{session.backend.source}])"
    )
    bs = session.build_stats
    print(
        f"[mate] build stats: shards={bs.n_shards}"
        f"{'' if bs.mesh_shape is None else f' mesh={bs.mesh_shape}'} "
        f"hash={bs.hash_seconds:.2f}s superkeys={bs.superkey_seconds:.2f}s "
        f"postings={bs.postings_seconds:.2f}s merge={bs.merge_seconds:.3f}s "
        f"({bs.bytes_hashed} bytes hashed over "
        f"{bs.values_total} unique values)"
    )

    queries = synthetic.make_mixed_queries(
        corpus, args.queries, args.rows, args.key_width, seed=args.seed + 2
    )
    agg = {"tp": 0, "fp": 0, "checks": 0, "t_seq": 0.0, "t_batched": 0.0,
           "mat_bytes": 0, "rb_bytes": 0}
    for qi, (q, q_cols) in enumerate(queries):
        t0 = time.perf_counter()
        topk_seq, st = discovery.discover(index, q, q_cols, k=args.k)
        agg["t_seq"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        topk_bat, stb = session.discover(q, q_cols)
        agg["t_batched"] += time.perf_counter() - t0
        agg["tp"] += st.verified_tp
        agg["fp"] += st.verified_fp
        agg["checks"] += st.filter_checks
        agg["mat_bytes"] += stb.filter_matrix_bytes
        agg["rb_bytes"] += stb.filter_readback_bytes
        # quality rank reorders the session's entries by the scoring head;
        # the scalar engine is count-ordered — the invariant across rank
        # modes is the verified SET, so compare sorted under 'quality'.
        key_seq = [(e.table_id, e.joinability) for e in topk_seq]
        key_bat = [(e.table_id, e.joinability) for e in topk_bat]
        match = (
            sorted(key_seq) == sorted(key_bat)
            if config.rank == "quality"
            else key_seq == key_bat
        )
        label = (
            "engines_set_identical" if config.rank == "quality"
            else "engines_bit_identical"
        )
        print(
            f"[mate] query {qi}: top-{args.k} "
            f"{[(e.table_id, e.joinability) for e in topk_seq[:5]]}... "
            f"precision={st.precision:.3f} {label}={match}"
        )
    prec = agg["tp"] / max(agg["tp"] + agg["fp"], 1)
    if agg["mat_bytes"]:
        readback = (
            f"match_readback={agg['rb_bytes']}/{agg['mat_bytes']}B "
            f"({agg['rb_bytes'] / agg['mat_bytes']:.1%} of full matrix)"
        )
    else:  # fused counts-only path: no match matrix was ever produced
        readback = f"match_readback={agg['rb_bytes']}B (fused, matrix_bytes=0)"
    print(
        f"[mate] total: precision={prec:.3f} filter_checks={agg['checks']} "
        f"seq={agg['t_seq']:.2f}s batched={agg['t_batched']:.2f}s "
        f"speedup={agg['t_seq']/max(agg['t_batched'],1e-9):.1f}x " + readback
    )
    print(
        f"[mate] profile gate ({'on' if config.profile_gate else 'off'}, "
        f"rank={config.rank}): tables_gated={session.stats.tables_gated} "
        f"gate_bytes_saved={session.stats.gate_bytes_saved}B "
        f"ranking_launches={session.stats.ranking_launches}"
    )

    if args.fds and queries:
        # FD workload demo: extend the first query with a synthetic dependent
        # column (one value per determinant key, FD-clean), then duplicate
        # one key with a CONFLICTING dependent value so a violating group
        # exists — tables matching that key must come back holds=False.
        q0, qc0 = queries[0]
        dep_col = q0.n_cols
        cells = [list(row) + [f"dep{i}"] for i, row in enumerate(q0.cells)]
        cells.append(list(q0.cells[0]) + ["dep-conflict"])
        fd_query = Table(-1, cells, name="fd probe")
        t0 = time.perf_counter()
        fds, fstats = session.discover_fds(
            fd_query, list(qc0), dep_col, min_support=1
        )
        print(
            f"[mate] FD workload (det={list(qc0)} -> dep={dep_col}, "
            f"signals={'on' if config.signals else 'off'}): "
            f"candidates={fstats.fd_candidates} "
            f"validated={fstats.fd_validated} "
            f"pruned={fstats.fd_candidates - fstats.fd_validated} "
            f"bytes_verified={fstats.fd_bytes_verified}B "
            f"in {time.perf_counter()-t0:.3f}s"
        )
        for c in fds[:5]:
            score = "" if c.score is None else f" score={c.score:.3f}"
            print(
                f"[mate]   table {c.table_id}: support={c.support} "
                f"holds={c.holds} violations={c.violations}{score}"
            )

    # multi-query serving path: requests share filter launches in slot
    # groups (the shared launch costs O(rows x keys) of the whole group,
    # so it is bounded rather than fused across arbitrarily many queries).
    # The engine wraps the SAME session: one config, one resolved backend.
    engine = DiscoveryEngine(
        session=session, batch=min(max(len(queries), 1), 16),
        flush_after=args.flush_after,
    )
    reqs = [engine.submit(q, q_cols) for q, q_cols in queries]
    t0 = time.perf_counter()
    served = engine.flush()
    t_many = time.perf_counter() - t0
    agree = all(r.done and r.future.done() and r.stats is not None for r in reqs)
    print(
        f"[mate] DiscoveryEngine: {len(served)} requests in shared filter "
        f"launches of ≤{engine.batch} "
        f"({t_many:.2f}s, vs {agg['t_seq']:.2f}s sequential, all_served={agree})"
    )
    if args.result_cache or args.bound_cache:
        # replay the same traffic: repeats answer from the serving caches
        t0 = time.perf_counter()
        replay = [engine.discover(q, q_cols) for q, q_cols in queries]
        t_replay = time.perf_counter() - t0
        hot = all(r.from_cache for r in replay) if args.result_cache else True
        print(
            f"[mate] serving caches: replayed {len(replay)} requests in "
            f"{t_replay:.3f}s (cache_hits={session.stats.cache_hits}, "
            f"bound_hits={session.stats.bound_hits}, all_from_cache={hot}, "
            f"shed={session.stats.shed}, degraded={session.stats.degraded})"
        )
    print(f"[mate] session: {session}")

    if args.route_shards > 1:
        t0 = time.perf_counter()
        routed = MateSession.build(
            corpus, config, distributed=True, n_shards=args.route_shards, device=dev
        )
        _sync(dev)
        t_build = time.perf_counter() - t0
        lanes = routed.index.cfg.lanes
        identical = True
        items = 0
        t0 = time.perf_counter()
        for qi, (q, q_cols) in enumerate(queries):
            topk_ref, _ = session.discover(q, q_cols)
            topk_rt, st_rt = routed.discover(q, q_cols)
            items += st_rt.pl_items_checked
            # both sessions share the rank mode, so even the quality order
            # should agree (identical profiles shard-merged vs global); the
            # asserted invariant stays the exact entry sequence.
            identical &= [(e.table_id, e.joinability) for e in topk_ref] == [
                (e.table_id, e.joinability) for e in topk_rt
            ]
        t_routed = time.perf_counter() - t0
        host_gather_bytes = items * lanes * 4  # superkeys a host-gather ships
        rs = routed.stats
        print(
            f"[mate] routed lake ({routed.index.n_shards} shards, built in "
            f"{t_build:.2f}s): {len(queries)} queries in {t_routed:.2f}s, "
            f"bit_identical={identical}, shard_launches={rs.shard_launches}, "
            f"gather_demotions={rs.shard_gather_demotions}"
        )
        print(
            f"[mate] routed traffic: route_bytes_merged="
            f"{rs.route_bytes_merged}B crossed shard boundaries vs "
            f"{host_gather_bytes}B of superkeys a host-gather path ships "
            f"({rs.route_bytes_merged / max(host_gather_bytes, 1):.1%}); "
            f"superkey rows crossing shards: 0 (by construction)"
        )
        if not identical:
            raise SystemExit("[mate] routed top-k diverged from single-host")

    if not queries:
        return
    row_tables = np.asarray(
        corpus.table_of_row(np.arange(corpus.total_rows)), dtype=np.int32
    )
    q, q_cols = queries[0]
    _keys, sk_of_key = discovery.build_query_superkeys(index, q, q_cols)
    qsk = np.stack(list(sk_of_key.values()))
    # the distributed filter resolves its per-shard impl from the same
    # registry precedence (a fused backend runs the fused shard launch)
    n_tables = len(corpus.tables)
    ranks = mesh_filter(index.superkeys, row_tables, qsk, n_tables, session.backend,
                        mesh_grid, dev)
    tc = ranks[0]["table_counts"]
    if any(not np.array_equal(r["table_counts"], tc) for r in ranks):
        raise SystemExit("[mate] the ranks' all-reduced counts differ")
    impl = distributed.shard_impl_for(session.backend, platform=dev.type)
    print(
        f"[mate] distributed filter on mesh {args.mesh} "
        f"(impl={impl}): "
        f"{int(tc.sum())} candidate rows across "
        f"{int((tc > 0).sum())} tables in {ranks[0]['seconds']:.3f}s"
    )
    if impl == "fused" and n_tables > filter_kernel.FUSED_MAX_TABLES:
        # past the fused kernel's table histogram each shard's counts come
        # from the match matrix (kernel B.4) and a torch segment sum
        print(
            f"[mate] mesh shards past the {filter_kernel.FUSED_MAX_TABLES}-table"
            f" cap of one fused launch: rank launches {[r['launches'] for r in ranks]}"
        )


if __name__ == "__main__":
    main()
