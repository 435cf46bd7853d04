#!/usr/bin/env python3
"""Ablations of the port's redesigned kernels on one GPU: B.6 (bf16 flash
attention, ``csrc/flash_attention.cu``, and its backward,
``csrc/flash_attention_bwd.cu``), B.2, B.1, B.4 and B.5 (the row filter,
``csrc/filter_counts.cu``) and B.3 (XASH superkeys,
``csrc/xash_superkey.cu``).

    python3 tools/kernel_ablations.py [--only flash_attention flash_attention_bwd filter_counts
        match_count xash_superkey] [--baseline DIR]

Builds each source as checked in, variants of it made by text substitution
(every substitution must apply, or the script fails) and the former bodies
of B.4 and B.5 (before their redesign), loads them with ctypes beside each
other, and times each kernel's variants at the kernel phase's headline
shapes of ``chip_smoke.py`` (B.4/B.5 also at the main and ops paths'
shapes, the backward at the ``flash_grad`` phase's bf16 shapes) with CUDA
events, in turns (forward order, then reverse; two numbers per variant).
Each result is held against the kernel's plain version, except the "no
softmax" skeleton, "no key counts" and the backward's one-pass variants,
which compute something else.  ``--baseline DIR`` times that csrc
directory's B.6 sources (another tree's, built against its own headers)
beside the variants.  Prints each B.6 variant's ptxas registers, spills and
"serialized" lines, one JSON line per shape, then the card's name and power
limit.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import xash  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import filter_kernel as fk  # noqa: E402
from repro_torch.kernels import flash_kernel as flk  # noqa: E402
from repro_torch.kernels import xash_kernel as xk  # noqa: E402

OUT = ROOT / "build" / "ablations"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def _cut(text: str, start: str, end: str, repl: str) -> str:
    i, j = text.index(start), text.index(end)
    return text[:i] + repl + text[j:]


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise AssertionError(f"ablation does not apply: {old[:60]!r}")
    return text.replace(old, new)


FLASH = (CSRC / "flash_attention.cu").read_text()
FLASH_BWD = (CSRC / "flash_attention_bwd.cu").read_text()
# B.4 before its redesign: one thread per output byte over a flat index
OLD_MATCH = """#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int MAXL, typename Index>
__global__ void __launch_bounds__(kThreads)
filter_match_kernel(const uint32_t* __restrict__ rows_sk, int lanes,
                    const uint32_t* __restrict__ query, int n_queries, Index total,
                    int8_t* __restrict__ out) {
  const Index q = (Index)n_queries;
  for (Index e = (Index)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (Index)gridDim.x * kThreads) {
    const Index i = e / q;
    const Index j = e - i * q;
    const uint32_t* rp = rows_sk + (size_t)i * lanes;
    const uint32_t* qp = query + (size_t)j * lanes;
    bool ok = true;
#pragma unroll
    for (int l = 0; l < MAXL; ++l)
      if (l < lanes) ok = ok && ((__ldg(qp + l) & ~__ldg(rp + l)) == 0u);
    out[e] = ok ? 1 : 0;
  }
}

template <int MAXL>
void launch(const uint32_t* rows, int lanes, const uint32_t* query, int n_queries,
            long long total, int8_t* out, cudaStream_t s) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)repro::sm_count() * 16;
  const int grid = (int)(blocks < cap ? blocks : cap);
  if (total < (1ll << 31))
    filter_match_kernel<MAXL, unsigned int>
        <<<grid, kThreads, 0, s>>>(rows, lanes, query, n_queries, (unsigned int)total, out);
  else
    filter_match_kernel<MAXL, unsigned long long><<<grid, kThreads, 0, s>>>(
        rows, lanes, query, n_queries, (unsigned long long)total, out);
}

}  // namespace

REPRO_API int filter_match_launch(const void* rows_sk, int lanes, const void* query,
                                  int n_queries, long long n, void* out, void* stream) {
  if (n <= 0 || n_queries <= 0) return 0;
  if (lanes < 1 || lanes > repro::kMaxLanes) return (int)cudaErrorInvalidValue;
  const uint32_t* r = static_cast<const uint32_t*>(rows_sk);
  const uint32_t* q = static_cast<const uint32_t*>(query);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = n * (long long)n_queries;
  if (lanes <= 4)
    launch<4>(r, lanes, q, n_queries, total, o, s);
  else if (lanes <= 8)
    launch<8>(r, lanes, q, n_queries, total, o, s);
  else
    launch<16>(r, lanes, q, n_queries, total, o, s);
  return (int)cudaGetLastError();
}
"""
# B.5 before its redesign: one thread per row, each query of a 256-query
# tile tested in turn, a ballot and one shared atomic per (warp, query)
OLD_COUNT = """#include "common.cuh"
namespace {
constexpr int kThreads = 256, kWarps = kThreads / 32, kQueryTile = 256;
template <int MAXL>
__global__ void __launch_bounds__(kThreads)
filter_count_kernel(const uint32_t* __restrict__ rows_sk, int lanes, const uint32_t* __restrict__ query,
                    int n_queries, long long n, int32_t* __restrict__ counts) {
  __shared__ uint32_t s_q[MAXL * kQueryTile];
  __shared__ int s_cnt[kQueryTile];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.y * kQueryTile, qn = min(kQueryTile, n_queries - q0);
  for (int e = tid; e < qn * lanes; e += kThreads) {
    const int j = e / lanes, l = e - j * lanes;
    s_q[l * kQueryTile + j] = query[(size_t)(q0 + j) * lanes + l];
  }
  for (int j = tid; j < kQueryTile; j += kThreads) s_cnt[j] = 0;
  __syncthreads();
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * 32; base < n;
       base += (long long)gridDim.x * kWarps * 32) {
    const long long i = base + lane;
    const bool real = i < n;
    uint32_t nr[MAXL];
#pragma unroll
    for (int l = 0; l < MAXL; ++l) nr[l] = (real && l < lanes) ? ~__ldg(rows_sk + (size_t)i * lanes + l) : 0u;
    for (int j = 0; j < qn; ++j) {
      bool ok = real;
#pragma unroll
      for (int l = 0; l < MAXL; ++l)
        if (l < lanes) ok = ok && ((s_q[l * kQueryTile + j] & nr[l]) == 0u);
      const unsigned hits = __ballot_sync(0xffffffffu, ok);
      if (lane == 0 && hits) atomicAdd(s_cnt + j, __popc(hits));
    }
  }
  __syncthreads();
  for (int j = tid; j < qn; j += kThreads) {
    const int v = s_cnt[j];
    if (v) atomicAdd(counts + q0 + j, v);
  }
}
template <int MAXL>
cudaError_t launch(const uint32_t* rows, int lanes, const uint32_t* query, int n_queries, long long n,
                   int32_t* counts, cudaStream_t s) {
  auto kernel = filter_count_kernel<MAXL>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int q_tiles = (n_queries + kQueryTile - 1) / kQueryTile;
  const long long chunks = (n + kThreads - 1) / kThreads;
  long long cap = (long long)(per_sm < 1 ? 1 : per_sm) * repro::sm_count() / q_tiles;
  if (cap < 1) cap = 1;
  kernel<<<dim3((unsigned)(chunks < cap ? chunks : cap), q_tiles), kThreads, 0, s>>>(
      rows, lanes, query, n_queries, n, counts);
  return cudaGetLastError();
}
}  // namespace
REPRO_API int filter_count_launch(const void* rows_sk, int lanes, const void* query, int n_queries,
                                  long long n, void* counts, void* stream) {
  if (n <= 0 || n_queries <= 0) return 0;
  const uint32_t* r = static_cast<const uint32_t*>(rows_sk);
  const uint32_t* q = static_cast<const uint32_t*>(query);
  int32_t* c = static_cast<int32_t*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 4) return (int)launch<4>(r, lanes, q, n_queries, n, c, s);
  if (lanes <= 8) return (int)launch<8>(r, lanes, q, n_queries, n, c, s);
  return (int)launch<16>(r, lanes, q, n_queries, n, c, s);
}
"""
COUNTS = (CSRC / "filter_counts.cu").read_text()
XASH = (CSRC / "xash_superkey.cu").read_text()
# B.3's counters as two words per char: count|rank|char, and the position sum
XASH_TWO_COUNTERS = _cut(
    _sub(XASH, "constexpr int kCounterWords = 1;", "constexpr int kCounterWords = 2;"),
    "struct PackedCounters {", "};  // PackedCounters", """struct PackedCounters {
  uint32_t* s;
  int stride;
  __device__ __forceinline__ void init(int a, int rank) {
    s[a * stride] = rank << 18 | a << 12;
    s[(kAlphabet + 1 + a) * stride] = 0;
  }
  __device__ __forceinline__ void add(int a, int pos) {
    s[a * stride] += 1u << 24;
    s[(kAlphabet + 1 + a) * stride] += pos;
  }
  __device__ __forceinline__ uint32_t take(int a) {
    const uint32_t v = s[a * stride] | s[(kAlphabet + 1 + a) * stride];
    s[a * stride] = v & 0x00fff000u;
    s[(kAlphabet + 1 + a) * stride] = 0;
    return v;
  }
""")
# key counts (B.1, B.5): bytes in registers (as built), or an atomic per hit
KEY_BYTES = """        if (KEYS) {  // one byte per owned query
          const uint2 b = mask_bytes(al[u]);
          kb[0] += b.x;
          kb[1] += b.y;
        }
"""
KEY_ATOMIC = """        if (KEYS)
          for (uint32_t h = al[u]; h; h &= h - 1) atomicAdd({} + __ffs(h) - 1, 1);
"""
VARIANTS = {
    "flash_attention": {
        "as built": FLASH,
        "P rounded once (no P_lo product)": _sub(
            FLASH, "        wgmma_rs<DVP>(o, p_lo[kk], dvd);\n", ""),
        "mask code on every tile": _sub(
            FLASH, "      if (edge)\n        body(std::true_type{});\n      else\n"
                   "        body(std::false_type{});\n", "      body(std::true_type{});\n"),
        "no ping-pong (named barriers removed)": _sub(_sub(
            FLASH, "bar_sync(kTurnBar + cwg, kConsumers);", ""), "bar_arrive(kTurnBar + (cwg ^ 1), kConsumers);", ""),
        "a 2-stage ring": _sub(
            FLASH, "kStages = tc_smem(kQBytes, kKBytes + kVBytes, 4) <= kSmemLimit ? 4 : 3;", "kStages = 2;"),
        "a block per work item (not persistent)": _sub(
            FLASH, "const dim3 grid(min(p.n_items, sm_count()));", "const dim3 grid(p.n_items);"),
        "128-key tiles at d <= 128 / dv 64 (Q in shared memory)": _sub(_sub(
            FLASH, "static constexpr int kKT = 64;", "static constexpr int kKT = DP <= 128 && DVP == 64 ? 128 : 64;"),
            "static constexpr bool kQInRegs = DVP == 64 && DP <= 128;", "static constexpr bool kQInRegs = false;"),
        "Q in shared memory (S from two descriptors)": _sub(
            FLASH, "static constexpr bool kQInRegs = DVP == 64 && DP <= 128;", "static constexpr bool kQInRegs = false;"),
        "no softmax (the two products only)": _sub(
            FLASH, "      if (edge)\n        body(std::true_type{});\n      else\n"
                   "        body(std::false_type{});\n", "      corr[0] = corr[1] = 1.f;\n"),
    },
    "flash_attention_bwd": {
        "as built": FLASH_BWD,
        "mask code on every tile": _sub(_sub(
            FLASH_BWD, "    if (edge)\n      probs(std::true_type{});\n    else\n      probs(std::false_type{});\n",
            "    probs(std::true_type{});\n"),
            "    if (edge)\n      grads(std::true_type{});\n    else\n      grads(std::false_type{});\n",
            "    grads(std::true_type{});\n"),
        "a 4-stage ring": _sub(FLASH_BWD, "constexpr int kStages = 2;", "constexpr int kStages = 4;"),
        "dK/dV pass only": _sub(
            FLASH_BWD, "  kernel<<<dim3(B * p.H, (p.S + kRows - 1) / kRows), kWg, smem, s>>>(p);\n", ""),
        "dQ pass only": _sub(_sub(
            FLASH_BWD, "    err = launch_dkdv<DP, DVP, kBoth>(p, B, s);\n", "    err = cudaSuccess;\n"),
            "    err = launch_dkdv<DP, DVP, kOnlyDK>(p, B, s);\n    if (err == cudaSuccess) err = launch_dkdv<DP, DVP, kOnlyDV>(p, B, s);\n",
            "    err = cudaSuccess;\n"),
    },
    "filter_counts": {
        "as built": COUNTS,
        "one row's elig in flight per warp": _sub(
            COUNTS, "constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;"),
        "key counts: a shared atomic per hit": _sub(COUNTS, KEY_BYTES, KEY_ATOMIC.format("s_keys + jb")),
        "B.1 key counts: a global atomic per hit": _sub(
            COUNTS, KEY_BYTES, KEY_ATOMIC.format("a.key_counts + q0 + jb")),
        "B.1 key counts: eight 32-bit counters in registers": _sub(_sub(_sub(
            COUNTS, KEY_BYTES, "        if (KEYS && al)\n#pragma unroll\n"
                               "          for (int k = 0; k < kQpt; ++k) kc[k] += (al[u] >> k) & 1u;\n"),
            "  long long c = blockIdx.x;\n", "  uint32_t kc[kQpt] = {};\n  long long c = blockIdx.x;\n"),
            "  if (KEYS) flush_keys();\n",
            "  if (KEYS)\n    for (int k = 0; k < kQpt; ++k)\n      if (kc[k]) atomicAdd(s_keys + jb + k, (int)kc[k]);\n"),
        "no key counts (B.1's keys wrong)": _sub(COUNTS, KEY_BYTES, ""),
        "B.4: staged through shared memory at q % 8 == 0 too": _sub(
            COUNTS, "n_queries % 8 ? dispatch<kMatchOdd>(a, s) : dispatch<kMatch>(a, s)", "dispatch<kMatchOdd>(a, s)"),
        "no G-packing (32 threads per row at any q)": _sub(
            COUNTS, "while (G * kQpt < qn) G <<= 1, ++lg;", "G = 32, lg = 5;"),
        "512 bits: lanes 0-3 in place of the fold": _sub(_sub(_sub(
            COUNTS, "if (k < nvalid && l < lanes) qf[k][l % kReg] |=",
            "if (k < nvalid && l < lanes && l < kReg) qf[k][l % kReg] |="),
            "if (l < lanes) f[l & 3] |= own[l];", "if (l < lanes && l < 4) f[l & 3] |= own[l];"),
            "if (kFull && !(qf[k][0] | qf[k][1] | qf[k][2] | qf[k][3])) zero_q |= 1u << k;",
            "if (false) zero_q |= 1u << k;"),
        "B.5: the one-row-per-thread body (PR 12)": OLD_COUNT,
        "B.4: the one-thread-per-byte body (PR 11)": OLD_MATCH,
    },
    "xash_superkey": {
        "as built": XASH,
        "cells by byte loads": _sub(
            XASH, "  return __ldg(reinterpret_cast<const uint4*>(src));",
            "  uint32_t w[4];\n#pragma unroll\n  for (int k = 0; k < 4; ++k)\n"
            "    w[k] = __ldg(src + 4 * k) | __ldg(src + 4 * k + 1) << 8 | __ldg(src + 4 * k + 2) << 16 |\n"
            "           (uint32_t)__ldg(src + 4 * k + 3) << 24;\n  return make_uint4(w[0], w[1], w[2], w[3]);"),
        "two counters per char (count, sum)": XASH_TWO_COUNTERS,
        "the general path (wide counters, a scan per pick)": _sub(
            XASH, "  if (vec && p.max_len > 0", "  if (false && vec && p.max_len > 0"),
    },
}


# variants of filter_counts.cu timed for each of its kernels
B12_VARIANTS = ("as built", "one row's elig in flight per warp", "key counts: a shared atomic per hit",
                "B.1 key counts: a global atomic per hit", "B.1 key counts: eight 32-bit counters in registers",
                "no key counts (B.1's keys wrong)", "512 bits: lanes 0-3 in place of the fold")
B4_VARIANTS = ("as built", "B.4: staged through shared memory at q % 8 == 0 too",
               "no G-packing (32 threads per row at any q)", "512 bits: lanes 0-3 in place of the fold",
               "B.4: the one-thread-per-byte body (PR 11)")
B5_VARIANTS = ("as built", "key counts: a shared atomic per hit", "no G-packing (32 threads per row at any q)",
               "512 bits: lanes 0-3 in place of the fold", "B.5: the one-row-per-thread body (PR 12)")
# --only sections and the library whose variants each times
SECTIONS = {"flash_attention": "flash_attention", "flash_attention_bwd": "flash_attention_bwd",
            "filter_counts": "filter_counts", "match_count": "filter_counts", "xash_superkey": "xash_superkey"}
# entry functions whose ptxas lines are printed, by library
PTXAS = {"flash_attention": "flash_tc_kernel", "flash_attention_bwd": "tc_kernel"}
# variants whose results are not held against the plain version
UNCHECKED = ("no softmax", "wrong", "pass only")


def build(only, baseline: Path | None = None) -> dict[str, dict[str, ctypes.CDLL]]:
    """Builds every variant of each library in ``only`` (and, with
    ``baseline``, that csrc directory's B.6 sources against its own
    headers), all ``nvcc``s at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for lib in only:
        variants = {name: (text, CSRC) for name, text in VARIANTS[lib].items()}
        if lib in PTXAS and baseline is not None:
            variants[f"baseline ({baseline})"] = ((baseline / f"{lib}.cu").read_text(), baseline)
        for i, (name, (text, inc)) in enumerate(variants.items()):
            src, so = OUT / f"{lib}_{i}.cu", OUT / f"lib{lib}_{i}.so"
            src.write_text(text)
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(inc), "-o", str(so), str(src)]
            procs.append((lib, name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True)))
    libs: dict[str, dict[str, ctypes.CDLL]] = {lib: {} for lib in only}
    for lib, name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{lib} / {name}: nvcc exit {proc.returncode}\n{log}")
        if lib in PTXAS:  # each bf16 kernel's registers and spills, and wgmma serialised
            print(json.dumps({"ptxas": lib, "variant": name,
                              "tc_kernels": chip_smoke.ptxas_entries(log, PTXAS[lib]),
                              "serialized": [ln.strip() for ln in log.splitlines() if "serialized" in ln]}),
                  flush=True)
        handle = ctypes.CDLL(str(so))
        for fn, argtypes in _build.LIBRARIES[lib][1].items():
            if not hasattr(handle, fn):  # B.5's former body has only its own entry point
                continue
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        libs[lib][name] = handle
    return libs


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def in_turns(variants: dict, run, want) -> dict:
    """Times ``run(handle)`` for every variant, forward then reverse."""
    res: dict[str, dict] = {}
    for name in [*variants, *reversed(variants)]:
        got = run(variants[name])
        entry = res.setdefault(name, {"ms": []})
        if not any(u in name for u in UNCHECKED):
            entry["max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                                       for g, w in zip(_tuple(got), _tuple(want)))
        entry["ms"].append(chip_smoke.cuda_ms(lambda: run(variants[name]), chip_smoke.REPS))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=list(SECTIONS), default=list(SECTIONS),
                    help="sections to time: B.6, B.6's backward, B.2 + B.1, B.4 + B.5, B.3")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a csrc directory of another tree (e.g. the parent commit's, unpacked by git"
                         " archive) whose flash_attention.cu and flash_attention_bwd.cu are timed beside"
                         " the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ablations: no CUDA device", file=sys.stderr)
        return 2
    libs = build(dict.fromkeys(SECTIONS[o] for o in args.only), args.baseline)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    if "flash_attention" in args.only:
        # the serving prefill, its window, the training forward (with the row
        # log-sum-exp), d 128 / dv 64 and MLA's d 192 / dv 128, all causal
        for b, s, h, d, dv, window, with_lse in ((4, 2048, 16, 64, 64, 0, False), (4, 2048, 16, 64, 64, 512, False),
                                                 (8, 2048, 16, 64, 64, 0, True), (4, 2048, 16, 128, 64, 0, False),
                                                 (2, 2048, 16, 192, 128, 0, False)):
            gen = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(b, s, h, e, generator=gen, device=dev).to(torch.bfloat16) for e in (d, d, dv))
            strides = [x for t in (q, k, v) for x in flk._strides(t, True)]
            lse = torch.empty(b, h, s, device=dev) if with_lse else None

            def flash(handle, q=q, k=k, v=v, strides=strides, lse=lse, window=window):
                out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype, device=dev)
                _build.check(handle.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(lse), q.shape[0],
                    q.shape[2], q.shape[1], k.shape[1], q.shape[3], v.shape[3], q.shape[3], *strides, 1, window, 1,
                    stream()), "flash_attention")
                return out
            want = flk.flash_attention_plain(q, k, v, causal=True, window=window)
            shape = f"[{b},{s},{h},d={d},dv={dv}] bf16 causal window={window}{' with lse' if with_lse else ''}"
            print(json.dumps({"kernel": "flash_attention", "shape": shape,
                              "variants": in_turns(libs["flash_attention"], flash, want)}), flush=True)
            del q, k, v, lse, want

    if "flash_attention_bwd" in args.only:
        # the flash_grad phase's bf16 shapes (training's, MLA's, whisper's
        # cross-attention) and its window edge: the prep kernel and both
        # passes, on the forward's output and row log-sum-exp
        shapes = [(b, s, t, h, d, dv, c, 0) for b, s, t, h, d, dv, c in chip_smoke.FLASH_GRAD]
        shapes += [e[1:9] for e in chip_smoke.FLASH_GRAD_EDGE if e[0] == "window"]
        for b, s, t, h, d, dv, causal, window in shapes:
            gen = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(b, n, h, e, generator=gen, device=dev).to(torch.bfloat16)
                       for n, e in ((s, d), (t, d), (t, dv)))
            do = torch.randn(b, s, h, dv, generator=gen, device=dev).to(torch.bfloat16)
            with torch.no_grad():
                out, lse = flk._forward(q, k, v, causal, window, True)
            strides = [x for t_ in (q, k, v) for x in flk._strides(t_, True)]

            def backward(handle, q=q, k=k, v=v, out=out, lse=lse, do=do, strides=strides, causal=causal,
                         window=window):
                b_, s_, h_, d_ = q.shape
                scratch = torch.empty(2, b_ * h_ * (-(-s_ // 64) * 64), dtype=torch.float32, device=dev)
                grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                _build.check(handle.flash_attention_bwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    scratch[0].data_ptr(), scratch[1].data_ptr(), *(g.data_ptr() for g in grads), b_, h_, s_,
                    k.shape[1], d_, v.shape[3], d_, *strides, int(causal), window, 1, stream()),
                    "flash_attention_backward")
                return grads
            want = flk.flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                                      do.float(), causal=causal, window=window)
            shape = (f"[{b},S={s},T={t},{h},d={d},dv={dv}] bf16 {'causal' if causal else 'non-causal'}"
                     f" window={window}")
            nbytes, flops = chip_smoke.flash_bwd_work(b, s, t, h, d, dv, window, 2, causal)
            b_ms, b_by = chip_smoke.bound(nbytes, flops, chip_smoke.BF16_FLOPS_PER_S)
            print(json.dumps({"kernel": "flash_attention_backward", "shape": shape, "bound_ms": b_ms,
                              "bound_by": b_by, "variants": in_turns(libs["flash_attention_bwd"], backward, want)}),
                  flush=True)
            del q, k, v, do, out, lse, want
        torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    if "filter_counts" in args.only or "match_count" in args.only:
        n, keys, tb = 1 << chip_smoke.LOG_N, chip_smoke.N_KEYS, chip_smoke.N_TABLES
        store16, rows, query16, elig, seg = chip_smoke.make_filter_inputs(
            rng, dev, 1 << chip_smoke.LOG_STORE, 16, n, keys, tb)
        store4, query4 = store16[:, :4].contiguous(), query16[:, :4].contiguous()
        q30 = chip_smoke.make_queries(rng, store4, rows, 30)
        elig30 = chip_smoke.make_elig(rng, dev, n, 30, "random")
        q300 = chip_smoke.make_queries(rng, store4, rows, 300)
        elig300 = chip_smoke.make_elig(rng, dev, n, 300, "random")
        variants = lambda names: {k: libs["filter_counts"][k] for k in names}  # noqa: E731
    if "filter_counts" in args.only:
        for label, st, qs, el in (("512-bit, q=256", store16, query16, elig), ("128-bit, q=256", store4, query4, elig),
                                  ("128-bit, q=30", store4, q30, elig30), ("128-bit, q=300", store4, q300, elig300),
                                  ("512-bit, q=256, elig=None", store16, query16, None)):
            def gather(handle, st=st, qs=qs, el=el):
                counts = torch.zeros(tb, dtype=torch.int32, device=dev)
                _build.check(handle.gather_counts_launch(
                    st.data_ptr(), st.shape[1], qs.shape[1], rows.data_ptr(), qs.data_ptr(), qs.shape[0],
                    _build.ptr(None if el is None else el.view(torch.int8)), qs.shape[0], seg.data_ptr(),
                    n, tb, counts.data_ptr(), stream()), "gather_counts")
                return counts
            want = fk.gather_filter_table_counts_plain(rows, st, qs, el, seg, tb, qs.shape[0])
            print(json.dumps({"kernel": "gather_filter_table_counts", "shape": f"{label}, n={n}, tables={tb}",
                              "variants": in_turns(variants(B12_VARIANTS), gather, want)}), flush=True)
        for label, qs, el, mode in (("128-bit sum, q=256", query4, elig, "sum"), ("512-bit sum, q=256", query16, elig, "sum"),
                                    ("128-bit sum, q=30", q30, elig30, "sum"), ("128-bit sum, q=300", q300, elig300, "sum"),
                                    ("512-bit any, q=256", query16, elig, "any")):
            row_sk = store16[rows.long(), :qs.shape[1]].contiguous()
            def counts(handle, row_sk=row_sk, qs=qs, el=el, mode=mode):
                out = torch.zeros(tb, dtype=torch.int32, device=dev)
                key_counts = torch.zeros(qs.shape[0], dtype=torch.int32, device=dev)
                row_hit = torch.zeros(n, dtype=torch.uint8, device=dev) if mode == "any" else None
                _build.check(handle.filter_counts_launch(
                    row_sk.data_ptr(), qs.shape[1], qs.shape[1], qs.data_ptr(), qs.shape[0],
                    _build.ptr(None if el is None else el.view(torch.int8)), qs.shape[0], seg.data_ptr(),
                    n, tb, out.data_ptr(), key_counts.data_ptr(), int(mode == "any"), _build.ptr(row_hit),
                    stream()), "filter_counts")
                return out, key_counts
            want = fk.filter_table_counts_plain(row_sk, qs, el, seg, tb, qs.shape[0], mode)
            print(json.dumps({"kernel": "filter_table_counts", "shape": f"{label}, n={n}, tables={tb}",
                              "variants": in_turns(variants(B12_VARIANTS), counts, want)}), flush=True)
            del row_sk
    if "match_count" in args.only:
        # B.4 and B.5 at the headline shapes and at q = 30; B.4 at the main
        # path's two kinds of launch (smoke lake, PR 15: a discover's 30 keys
        # over <= 128 rows, a discover_many group's 154 keys over up to
        # 2,241,293 rows); B.5 at the ops path's shape (641,424 rows of 4
        # lanes against ~120 query keys)
        n_ops, n_group = 641_424, 2_241_293
        q_ops = chip_smoke.make_queries(rng, store4, rows[:n_ops], 120)
        group_rows = torch.from_numpy(rng.integers(0, store4.shape[0], size=n_group)).to(dev)
        q_group = chip_smoke.make_queries(rng, store4, group_rows, 154)
        for label, qs, rix, kinds in (("128-bit, q=256", query4, rows, "match count"),
                                      ("512-bit, q=256", query16, rows, "match count"),
                                      ("128-bit, q=30", q30, rows, "match count"),
                                      ("128-bit main-path shape, q=30", q30, rows[:128], "match"),
                                      ("128-bit main-path shape, q=154", q_group, group_rows, "match"),
                                      ("128-bit ops-path shape, q=120", q_ops, rows[:n_ops], "count")):
            nr = rix.shape[0]
            row_sk = store16[rix.long(), :qs.shape[1]].contiguous()
            def match(handle, row_sk=row_sk, qs=qs):
                out = torch.empty(row_sk.shape[0], qs.shape[0], dtype=torch.int8, device=dev)
                _build.check(handle.filter_match_launch(
                    row_sk.data_ptr(), qs.shape[1], qs.data_ptr(), qs.shape[0], row_sk.shape[0],
                    out.data_ptr(), stream()), "filter_match")
                return out
            def count(handle, row_sk=row_sk, qs=qs):
                out = torch.zeros(qs.shape[0], dtype=torch.int32, device=dev)
                _build.check(handle.filter_count_launch(
                    row_sk.data_ptr(), qs.shape[1], qs.data_ptr(), qs.shape[0], row_sk.shape[0],
                    out.data_ptr(), stream()), "filter_count")
                return out
            shape = f"{label}, n={nr}"
            if "match" in kinds:
                print(json.dumps({"kernel": "filter_match", "shape": shape, "variants": in_turns(
                    variants(B4_VARIANTS), match, fk.filter_match_plain(row_sk, qs))}), flush=True)
            if "count" in kinds:
                print(json.dumps({"kernel": "filter_count", "shape": shape, "variants": in_turns(
                    variants(B5_VARIANTS), count, fk.filter_count_plain(row_sk, qs))}), flush=True)
            del row_sk
    if "filter_counts" in args.only or "match_count" in args.only:
        del store16, store4, rows, query16, elig, seg

    if "xash_superkey" in args.only:
        corpus = synthetic.make_corpus(synthetic.SyntheticSpec(n_tables=20000, seed=0))
        uniq = torch.from_numpy(corpus.unique_enc).to(dev)
        freq = tuple(corpus.char_frequencies().tolist())
        for label, n_rows, n_cols in (("values", 1 << (chip_smoke.LOG_N + 2), 1), ("rows", 1 << chip_smoke.LOG_N, 4)):
            pick = torch.from_numpy(rng.integers(0, uniq.shape[0], size=n_rows * n_cols)).to(dev)
            enc = uniq[pick].reshape(n_rows, n_cols, uniq.shape[1]).contiguous()
            for bits in (128, 512):
                cfg = xash.XashConfig(bits=bits, char_freq=freq)
                rank = np.ascontiguousarray(cfg.freq_rank(), dtype=np.int32)
                def superkey(handle, enc=enc, cfg=cfg, rank=rank):
                    out = torch.empty(enc.shape[0], cfg.lanes, dtype=torch.int32, device=dev)
                    _build.check(handle.xash_superkey_launch(
                        enc.data_ptr(), out.data_ptr(), rank.ctypes.data, enc.shape[0], enc.shape[1],
                        enc.shape[2], cfg.lanes, cfg.c, cfg.char_region, cfg.len_segment, cfg.n_char_bits,
                        int(cfg.use_location), int(cfg.use_rotation), int(cfg.use_length), stream()),
                        "xash_superkey")
                    return out
                want = xk.xash_superkey_plain(enc, cfg)
                print(json.dumps({"kernel": "xash_superkey",
                                  "shape": f"{label} {list(enc.shape)} at {bits} bits",
                                  "variants": in_turns(libs["xash_superkey"], superkey, want)}), flush=True)
            del enc, pick
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
