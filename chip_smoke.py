#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n-tables 20000] [--seed 0]

Phases, each printing one JSON line:

1. environment — the card, ``torch.version.cuda``, nvcc's release, and the
   seconds the kernel build took (one nvcc per source, all in parallel);
2. kernels — each hand-written kernel (B.1 filter_table_counts, B.2
   gather_filter_table_counts, B.3 xash_superkey, B.4 filter_match) runs on
   the card at the shapes the main path gives it at scale, and is held
   against its plain PyTorch version on the same inputs: integer outputs,
   so the tolerance is exact (max_abs_err must be 0).  CUDA-event times of
   kernel and plain version, and the bound (the least time the card could
   take: the larger of bytes over 3.35 TB/s and operations over 67 T op/s,
   the published 32-bit non-tensor peak, computed from this run's inputs);
3. main path — ``synthetic.make_corpus`` → ``MateSession.build`` (default
   ``DiscoveryConfig``: 128 bits, rank='quality', profile gate on, backend
   resolved on CUDA to 'fused-gather') → ``discover`` on ground-truth
   queries and one ``discover_many`` group, every result held identical
   under 'fused-gather', 'fused', 'pallas' and 'numpy' and against the
   brute-force oracle, then one §5.4 ``update_cell`` and one more
   ``discover``.  Launch counters are zeroed just before and read just
   after: every kernel must have launched on this path.

Then the ``kernels`` summary line (with those launch counts), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.  Any
mismatch raises and the script exits non-zero without the last line.  It
needs a CUDA device and the repository's ``src/`` beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT32_OPS_PER_S = 67e12  # H100 SXM 32-bit peak outside the tensor cores

# kernel phase: the main path's shapes at the device-store budget
LOG_STORE = 25  # 2^25 rows x 16 lanes = a 2 GiB superkey store
LOG_N = 20  # candidate rows per launch
N_KEYS = 256  # query keys per launch
N_TABLES = 8192  # tables per launch (the fused kernels' cap)
REPS = 10  # timed launches per kernel
# main path: planted ground-truth queries, and one discover_many group
N_TRUTH = 4
GROUP = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` calls (warmed)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max().item())


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version at main-path scale
# ---------------------------------------------------------------------------

def make_filter_inputs(rng, dev, n_store, lanes, n, q, n_tables):
    """A superkey store with realistic popcount (each bit set with p = 1/16:
    32 of 512 bits, the order of a 6–8-cell row at 4 ones per value), CSR
    candidate offsets grouped by table, query keys planted as bit subsets of
    candidate rows, and a 1-in-4 eligibility matrix."""
    raw = torch.from_numpy(
        rng.integers(0, 2**32, size=(n_store, lanes), dtype=np.uint32).view(np.int32)
    ).to(dev)
    store = raw & raw.roll(1, 0) & raw.roll(2, 0) & raw.roll(3, 0)
    del raw
    seg = torch.from_numpy(np.sort(rng.integers(0, n_tables, size=n)).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.integers(0, n_store, size=n).astype(np.int32)).to(dev)
    pick = torch.from_numpy(rng.integers(0, n, size=q)).to(dev)
    keep = torch.from_numpy(
        rng.integers(0, 2**32, size=(q, lanes), dtype=np.uint32).view(np.int32)
    ).to(dev)
    query = (store[rows[pick].long()] & keep & keep.roll(1, 0)).contiguous()
    elig = torch.from_numpy(rng.integers(0, 4, size=(n, q), dtype=np.uint8) == 0).to(dev)
    return store, rows, query, elig, seg


def kernel_phase(seed, corpus) -> dict[str, dict]:
    from repro_torch.core import encoding, xash
    from repro_torch.kernels import filter_kernel as fk
    from repro_torch.kernels import xash_kernel as xk

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n, q, tb = 1 << LOG_N, N_KEYS, N_TABLES
    results: dict[str, dict] = {}
    checks: list[dict] = []

    def record(name, route, source, replaces, got, want, ms, plain_ms, nbytes, nops, shape):
        err = max_abs_err(got, want)
        b_ms, b_by = bound(nbytes, nops)
        checks.append({"kernel": name, "shape": shape, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms})
        if err != 0:
            raise AssertionError(f"{name} {shape}: kernel disagrees with its plain version (max_abs_err={err})")
        if name not in results:  # the first shape of each kernel is its headline row
            results[name] = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": err, "max_abs_diff": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "shape": shape,
            }

    store16, rows, query16, elig, seg = make_filter_inputs(
        rng, dev, 1 << LOG_STORE, 16, n, q, tb
    )
    torch.cuda.synchronize()

    # B.2 gather_filter_table_counts: 512-bit store, then 128-bit store, then
    # the lane-prefix degrade (4 lanes probed over the 16-lane store)
    store4 = store16[:, :4].contiguous()
    query4 = query16[:, :4].contiguous()
    for label, st, qs in (("512-bit", store16, query16), ("128-bit", store4, query4),
                          ("4 of 16 lanes", store16, query4)):
        lanes = qs.shape[1]
        got = fk.gather_filter_table_counts(rows, st, qs, elig, seg, n_tables=tb)
        want = fk.gather_filter_table_counts_plain(rows, st, qs, elig, seg, tb, q)
        ms = cuda_ms(lambda: fk.gather_filter_table_counts(rows, st, qs, elig, seg, n_tables=tb), REPS)
        plain_ms = cuda_ms(lambda: fk.gather_filter_table_counts_plain(rows, st, qs, elig, seg, tb, q), 1)
        nbytes = n * 4 + n * max(32, lanes * 4) + n * q + n * 4 + q * lanes * 4 + tb * 4
        record("gather_filter_table_counts", "cuda", "src/repro_torch/kernels/csrc/filter_counts.cu",
               "src/repro/kernels/filter_kernel.py:447", got, want, ms, plain_ms, nbytes, n * q,
               f"{label} store [{st.shape[0]},{st.shape[1]}], n={n}, q={q}, tables={tb}")

    # B.1 filter_table_counts on host-gathered rows, 'sum' and 'any'
    for label, qs, mode in (("512-bit sum", query16, "sum"), ("128-bit sum", query4, "sum"),
                            ("512-bit any", query16, "any")):
        lanes = qs.shape[1]
        row_sk = store16[rows.long(), :lanes].contiguous()
        got = torch.cat(fk.filter_table_counts(row_sk, qs, elig, seg, n_tables=tb, mode=mode))
        want = torch.cat(fk.filter_table_counts_plain(row_sk, qs, elig, seg, tb, q, mode))
        ms = cuda_ms(lambda: fk.filter_table_counts(row_sk, qs, elig, seg, n_tables=tb, mode=mode), REPS)
        plain_ms = cuda_ms(lambda: fk.filter_table_counts_plain(row_sk, qs, elig, seg, tb, q, mode), 1)
        nbytes = n * lanes * 4 + n * q + n * 4 + q * lanes * 4 + tb * 4 + q * 4
        record("filter_table_counts", "cuda", "src/repro_torch/kernels/csrc/filter_counts.cu",
               "src/repro/kernels/filter_kernel.py:248", got, want, ms, plain_ms, nbytes, n * q,
               f"{label}, n={n}, q={q}, tables={tb}")
        del row_sk

    # B.4 filter_match
    for label, qs in (("512-bit", query16), ("128-bit", query4)):
        lanes = qs.shape[1]
        row_sk = store16[rows.long(), :lanes].contiguous()
        got = fk.filter_match(row_sk, qs)
        want = fk.filter_match_plain(row_sk, qs)
        ms = cuda_ms(lambda: fk.filter_match(row_sk, qs), REPS)
        plain_ms = cuda_ms(lambda: fk.filter_match_plain(row_sk, qs), 1)
        nbytes = n * lanes * 4 + q * lanes * 4 + n * q
        record("filter_match", "cuda", "src/repro_torch/kernels/csrc/filter_match.cu",
               "src/repro/kernels/filter_kernel.py:103", got, want, ms, plain_ms, nbytes, n * q,
               f"{label}, n={n}, q={q}")
        del row_sk, got, want
    del store16, store4, rows, elig, seg
    torch.cuda.empty_cache()

    # B.3 xash_superkey on the corpus's own values, with its rank vector
    uniq = torch.from_numpy(corpus.unique_enc).to(dev)
    freq = tuple(corpus.char_frequencies().tolist())
    for label, n_rows, n_cols in (("values", 1 << (LOG_N + 2), 1), ("rows", n, 4)):
        pick = torch.from_numpy(rng.integers(0, uniq.shape[0], size=n_rows * n_cols)).to(dev)
        enc = uniq[pick].reshape(n_rows, n_cols, encoding.MAX_LEN).contiguous()
        # operations this data needs: one test per byte, two counter updates
        # per character, one score per (present char, pick) of each cell
        codes = enc.reshape(-1, encoding.MAX_LEN).long()
        cnt = torch.zeros(codes.shape[0], encoding.ALPHABET_SIZE + 1, dtype=torch.int64, device=dev)
        cnt.scatter_add_(1, codes, torch.ones_like(codes))
        present = (cnt[:, 1:] > 0).sum(dim=1)
        n_chars = int((codes > 0).sum().item())
        del codes, cnt
        for bits in (128, 512):
            cfg = xash.XashConfig(bits=bits, char_freq=freq)
            picks = int((present * present.clamp(max=cfg.n_char_bits)).sum().item())
            got = xk.xash_superkey(enc, cfg)
            want = xk.xash_superkey_plain(enc, cfg)
            ms = cuda_ms(lambda: xk.xash_superkey(enc, cfg), REPS)
            plain_ms = cuda_ms(lambda: xk.xash_superkey_plain(enc, cfg), 1)
            nbytes = enc.numel() + n_rows * cfg.lanes * 4
            nops = enc.numel() + 2 * n_chars + picks
            record("xash_superkey", "cuda", "src/repro_torch/kernels/csrc/xash_superkey.cu",
                   "src/repro/kernels/xash_kernel.py:123", got, want, ms, plain_ms, nbytes, nops,
                   f"{label} [{n_rows},{n_cols},{encoding.MAX_LEN}] at {bits} bits")
        del enc, pick, present
    torch.cuda.synchronize()
    emit({"phase": "kernels", "checks": checks})
    return results


# ---------------------------------------------------------------------------
# Phase 3: the port's main path
# ---------------------------------------------------------------------------

def key(entries):
    return [(e.table_id, e.joinability, e.mapping) for e in entries]


def main_path_phase(corpus, truth, mixed) -> dict[str, int]:
    from repro_torch.core import discovery
    from repro_torch.core.session import DiscoveryConfig, MateSession
    from repro_torch.kernels import filter_kernel as fk
    from repro_torch.kernels import xash_kernel as xk

    counters = {
        "filter_table_counts": fk.filter_table_counts,
        "gather_filter_table_counts": fk.gather_filter_table_counts,
        "xash_superkey": xk.xash_superkey,
        "filter_match": fk.filter_match,
    }
    def snapshot():
        return {name: fn.launches for name, fn in counters.items()}

    for fn in counters.values():
        fn.launches = 0
    wall: dict[str, float] = {}

    t0 = time.perf_counter()
    session = MateSession.build(corpus, DiscoveryConfig())
    torch.cuda.synchronize()
    wall["build"] = time.perf_counter() - t0
    if session.backend.name != "fused-gather":
        raise AssertionError(f"default backend on CUDA resolved to {session.backend.name}")
    bs = session.build_stats
    emit({"phase": "build", "build_stats": {
        k: v for k, v in vars(bs).items() if not isinstance(v, list)
    }, "wall_s": wall["build"]})

    others = {
        name: MateSession(session.index, DiscoveryConfig(backend=name))
        for name in ("fused", "pallas", "numpy")
    }

    def discover_all(label):
        t = time.perf_counter()
        results = []
        for (query, q_cols, _expected) in truth:
            got, _ = session.discover(query, q_cols)
            results.append(got)
            for name, other in others.items():
                alt, _ = other.discover(query, q_cols)
                if key(alt) != key(got):
                    raise AssertionError(f"{label}: top-k under {name} differs from fused-gather")
        torch.cuda.synchronize()
        wall[label] = time.perf_counter() - t
        return results

    results = discover_all("discover")
    # the last ground-truth query (its plants are intact) against the
    # brute-force oracle: the same joinabilities (a tie at the k-th place may
    # keep another table), each entry exact, and a planted table found at no
    # less than its plant
    q0, q0_cols, expected = truth[-1]
    brute = discovery.topk_bruteforce(corpus, q0, q0_cols, session.config.k)
    got = results[-1]
    if sorted(e.joinability for e in got) != sorted(j for _, j in brute):
        raise AssertionError("discover disagrees with topk_bruteforce")
    for e in got:
        if discovery.joinability_bruteforce(corpus, e.table_id, q0, q0_cols) != e.joinability:
            raise AssertionError(f"table {e.table_id}: joinability differs from brute force")
    if not any(expected.get(e.table_id, 10**9) <= e.joinability for e in got):
        raise AssertionError("no planted table in the top-k")
    same_set = sorted((e.table_id, e.joinability) for e in got) == sorted(brute)

    # one discover of that query under each backend: its launches and its
    # host wall time (ends in a device sync)
    per_discover = {}
    for name, sess in [("fused-gather", session), *others.items()]:
        before, t = snapshot(), time.perf_counter()
        sess.discover(q0, q0_cols)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t
        after = snapshot()
        per_discover[name] = {"wall_s": elapsed,
                              "launches": {k: after[k] - before[k] for k in after}}
    emit({"phase": "one_discover", "query_rows": len(q0.cells), "bruteforce_identical": same_set,
          "per_backend": per_discover})

    t = time.perf_counter()
    group = mixed
    many = session.discover_many(group)
    for name, other in others.items():
        alt = other.discover_many(group)
        if [key(a) for a, _ in alt] != [key(m) for m, _ in many]:
            raise AssertionError(f"discover_many under {name} differs from fused-gather")
    for (query, q_cols), (entries, _) in zip(group, many):
        solo, _ = session.discover(query, q_cols)
        if key(solo) != key(entries):
            raise AssertionError("discover_many differs from solo discover")
    torch.cuda.synchronize()
    wall["discover_many"] = time.perf_counter() - t

    # §5.4: rewrite one cell of the best table, then discover again
    store_before = session.index.device_store()
    top = results[0][0]
    session.update_cell(top.table_id, 0, 0, "mutated cell value")
    if session.index.device_store() is store_before:
        raise AssertionError("device store did not refresh after update_cell")
    after = discover_all("discover_after_update")
    if not after:
        raise AssertionError("no queries after update")
    torch.cuda.synchronize()

    launches = {name: fn.launches for name, fn in counters.items()}
    emit({"phase": "main_path", "queries": len(truth), "group": len(group),
          "wall_s": wall, "session_stats": vars(session.stats), "launches": launches,
          "top1": [key(r[:1]) for r in results]})
    missing = [name for name, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-tables", type=int, default=20000, help="tables in the main path's lake")
    ap.add_argument("--seed", type=int, default=0, help="seed of the lake and the kernel inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    release = re.search(r"release ([\d.]+)", nvcc)
    t0 = time.perf_counter()
    build_s = _build.build_all()
    emit({"phase": "environment", "gpu": nvidia_smi(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc_release": release and release.group(1),
          "build_s": build_s, "build_wall_s": time.perf_counter() - t0})
    for name, log in _build.build_log.items():
        emit({"phase": "ptxas", "library": name,
              "report": [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]})

    t0 = time.perf_counter()
    corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=args.n_tables, seed=args.seed))
    truth = []  # ground-truth queries, each planted into the lake
    for i in range(N_TRUTH):
        query, q_cols, expected, corpus = synthetic.make_query_with_ground_truth(
            corpus, n_rows=30, seed=args.seed + 1 + i
        )
        truth.append((query, q_cols, expected))
    mixed = synthetic.make_mixed_queries(corpus, GROUP, 20, seed=args.seed + 100)
    emit({"phase": "corpus", "n_tables": args.n_tables, "rows": corpus.total_rows,
          "unique_values": len(corpus.unique_values),
          "cells": int((corpus.cell_value_ids >= 0).sum()), "wall_s": time.perf_counter() - t0})

    rows = kernel_phase(args.seed, corpus)
    for name, n in main_path_phase(corpus, truth, mixed).items():
        rows[name]["launches"] = n
    emit({"kernels": list(rows.values())})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
