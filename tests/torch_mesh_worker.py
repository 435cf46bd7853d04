"""The rank side of ``test_torch_routed_mesh.py``: run by every spawned rank
of a gloo group (``repro_torch.launch.mesh.run_ranks``), it drives the port's
mesh mode on the CPU and hands plain results back to the test process,
which holds them against the reference.  Imports the port only, so a rank
starts without JAX.
"""

from __future__ import annotations

import hashlib
import types

import numpy as np

MESH_BACKENDS = ("fused-gather", "fused", "pallas", "numpy")
FILTER_IMPLS = ("broadcast", "blocked", "fused", "fused-gather", "numpy")


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


def _stats(st) -> dict:
    return {name: getattr(st, name) for name in (
        "shard_launches", "route_bytes_merged", "filter_fused_launches",
        "shard_gather_demotions", "tables_fetched", "tables_gated", "filter_passed",
        "verified_tp", "verified_fp")}


def _error(fn) -> str | None:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def routed_matrix(mesh, corpus, queries, widths, k_many):
    """Every mesh-mode result one rank produces, as plain data."""
    from repro_torch.core import batched, distributed, index, routing, session, xash
    from repro_torch.kernels import filter_kernel, ops

    world = mesh.size
    out: dict = {"rank": mesh.rank, "world": world, "backend": mesh.backend, "widths": {}}
    query, q_cols = queries[0]
    for bits in widths:
        cfg = xash.XashConfig(bits=bits)
        row: dict = {}
        idx = routing.ShardedMateIndex(corpus, cfg=cfg, use_corpus_char_freq=True,
                                       n_shards=world, device=mesh.device)
        idx.attach_mesh(mesh)
        for backend in MESH_BACKENDS:
            got, st = batched.discover_batched(idx, query, q_cols, k=10, backend=backend)
            many = batched.discover_many(idx, queries, k=k_many, backend=backend)
            pcs = batched.plan_and_count(idx, queries, backend)
            row[backend] = {
                "topk": _key(got), "stats": _stats(st),
                "many": [_key(e) for e, _ in many],
                "counts": [pc.counts.tolist() for pc in pcs],
                "route": [(pc.route_launches, pc.route_bytes) for pc in pcs],
            }
        idx.detach_mesh()
        got, st = batched.discover_batched(idx, query, q_cols, k=10, backend="fused-gather")
        row["detached"] = {"topk": _key(got), "stats": _stats(st)}

        built, bstats = routing.build_routed_index(corpus, cfg=cfg, use_corpus_char_freq=True, mesh=mesh)
        got, st = batched.discover_batched(built, query, q_cols, k=10, backend="fused-gather")
        row["mesh_built"] = {
            "attached": built._mesh is not None, "value_lanes": digest(built.value_lanes),
            "n_shards": bstats.n_shards, "mesh_shape": bstats.mesh_shape,
            "shard_rows": bstats.shard_rows, "sharded": bstats.sharded,
            "hash_launches": len(bstats.shard_hash_seconds),
            "topk": _key(got), "stats": _stats(st),
        }
        sharded, sstats = index.build_index(corpus, cfg=cfg, use_corpus_char_freq=True, mesh=mesh)
        row["sharded_build"] = {
            "value_lanes": digest(sharded.value_lanes), "superkeys": digest(sharded.superkeys),
            "postings": digest(np.concatenate([sharded.postings[v] for v in sorted(sharded.postings)])),
            "n_shards": sstats.n_shards, "mesh_shape": sstats.mesh_shape,
            "shard_rows": sstats.shard_rows, "shard_values": sstats.shard_values,
        }
        out["widths"][bits] = row

    # the mesh-built routed session (distributed=True over the group)
    s = session.MateSession.build(corpus, session.DiscoveryConfig(bits=256, backend="fused-gather"),
                                  distributed=True, mesh=mesh)
    got, _ = s.discover(query, q_cols, k=10)
    many = s.discover_many(queries, k=k_many)
    out["session"] = {"topk": _key(got), "many": [_key(e) for e, _ in many],
                      "shard_launches": s.stats.shard_launches,
                      "route_bytes_merged": s.stats.route_bytes_merged,
                      "n_shards": s.index.n_shards, "routed": s.index.routed}

    # xash_values_mesh: a small chunk forces several collective launches and
    # a padded last block
    times: list = []
    enc = corpus.unique_enc
    out["xash_values_mesh"] = {
        bits: digest(ops.xash_values_mesh(enc, xash.XashConfig(bits=bits), mesh=mesh, chunk=7,
                                          times_out=times))
        for bits in widths
    }
    out["xash_values_mesh_launches"] = len(times)
    out["xash_values_mesh_empty"] = ops.xash_values_mesh(
        enc[:0], xash.XashConfig(bits=128), mesh=mesh).shape

    # the pre-routed row filter (make_distributed_filter) over this rank's
    # block of the single-host rows, against the lake query's keys
    base = index.build_index(corpus, cfg=xash.XashConfig(bits=128), device=mesh.device)[0]
    keys = list(dict.fromkeys(tuple(r[c] for c in q_cols) for r in query.cells))
    q_sk = xash.lanes_to_torch(base.superkey_of_keys(keys), mesh.device)
    row_tables = np.asarray(corpus.table_of_row(np.arange(corpus.total_rows)), dtype=np.int32)
    sk, rt = distributed.shard_corpus_rows(base.superkeys, row_tables, mesh)
    n_tables = len(corpus.tables)
    filt = {}
    for impl in FILTER_IMPLS:
        tc, kc = distributed.make_distributed_filter(mesh, n_tables, backend=impl)(sk, rt, q_sk)
        filt[impl] = (tc.tolist(), kc.tolist())
    cap = filter_kernel.FUSED_MAX_TABLES
    filter_kernel.FUSED_MAX_TABLES = 7  # past the cap: kernel B.4 + index_add_
    try:
        tc, kc = distributed.make_distributed_filter(mesh, n_tables, backend="fused")(sk, rt, q_sk)
    finally:
        filter_kernel.FUSED_MAX_TABLES = cap
    filt["fused_over_cap"] = (tc.tolist(), kc.tolist())
    out["filter"] = filt
    out["block_rows"] = int(sk.shape[0])
    demoted = types.SimpleNamespace(shard_gather_demotions=0)
    out["shard_impl"] = [distributed.shard_impl_for(b, stats=demoted, platform="cpu")
                         for b in ("fused-gather", "fused", "pallas", "numpy", "blocked", None)]
    out["shard_impl_demotions"] = demoted.shard_gather_demotions

    # errors: a group size that differs from the index's shards, and an
    # n_shards that conflicts with the group
    wrong = routing.ShardedMateIndex(corpus, cfg=xash.XashConfig(bits=128), n_shards=world + 1,
                                     device=mesh.device)
    out["errors"] = {
        "attach": _error(lambda: wrong.attach_mesh(mesh)),
        "build_routed": _error(lambda: routing.build_routed_index(corpus, mesh=mesh, n_shards=world + 1)),
        "build_index": _error(lambda: index.build_index(corpus, mesh=mesh, n_shards=world + 1)),
    }
    return out


def hang(mesh):
    """Rank 1 never reports (the deadline test)."""
    import time

    if mesh.rank == 1:
        time.sleep(3600)


def pid(mesh):
    """(this rank, its process id)."""
    import os

    return mesh.rank, os.getpid()


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    return mesh.rank


def compressed_reduce(mesh, grads):
    """``train.compression.compressed_all_reduce`` over the group for each
    step's gradients (``grads[step][rank]``, numpy trees), errors carried
    between steps.  Returns [(reduced, new errors)] per step, numpy trees."""
    import torch

    from repro_torch.train import compression, optimizer as opt

    errors = compression.init_error(opt.tree_map(torch.from_numpy, grads[0][mesh.rank]))
    out = []
    for step in grads:
        g = opt.tree_map(torch.from_numpy, step[mesh.rank])
        red, errors = compression.compressed_all_reduce(g, errors, mesh.group)
        out.append((opt.tree_map(lambda t: t.numpy(), red), opt.tree_map(lambda t: t.numpy(), errors)))
    return out
