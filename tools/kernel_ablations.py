#!/usr/bin/env python3
"""Ablations of the port's redesigned kernels on one GPU: B.6 (bf16 flash
attention, ``csrc/flash_attention.cu``), B.2 and B.1 (filter counts,
``csrc/filter_counts.cu``) and B.3 (XASH superkeys, ``csrc/xash_superkey.cu``).

    python3 tools/kernel_ablations.py [--only flash_attention filter_counts xash_superkey]

Builds each source as checked in and variants of it made by text
substitution (every substitution must apply, or the script fails), loads
them with ctypes beside each other, and times every variant at the kernel
phase's headline shapes of ``chip_smoke.py`` with CUDA events, in turns
(forward order, then reverse; two numbers per variant).  Each result is held
against the kernel's plain version, except the "no softmax" skeleton, which
computes something else.  Prints one JSON line per shape, then the card's
name and power limit.  Needs a CUDA device and ``nvcc``.
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
# B.1's key counts: bytes in registers (as built), or an atomic per hit
KEY_BYTES = """        if (KEYS && al) {  // spread each nibble's 4 bits to 4 bytes and add
          kb[0] += ((al & 0xfu) * 0x00204081u) & 0x01010101u;
          kb[1] += ((al >> 4) * 0x00204081u) & 0x01010101u;
        }
"""
KEY_ATOMIC = """        if (KEYS)
          for (uint32_t h = al; h; h &= h - 1) atomicAdd({} + __ffs(h) - 1, 1);
"""
VARIANTS = {
    "flash_attention": {
        "as built": FLASH,
        "P rounded to bf16 (no P_lo product)": _sub(
            FLASH, "        wgmma_rs<DVP>(o, p_lo[kk], dvd);\n", ""),
        "mask code on every tile": _sub(
            FLASH, "      if (edge)\n        softmax(std::true_type{});\n      else\n"
                   "        softmax(std::false_type{});\n", "      softmax(std::true_type{});\n"),
        "one block per SM (no register bound)": _sub(
            FLASH, "__launch_bounds__(kTcThreads, DVP == 64 ? 2 : 1)", "__launch_bounds__(kTcThreads)"),
        "no softmax (the two products only)": _cut(
            FLASH, "      float corr[2];\n      auto softmax", "#pragma unroll\n      for (int i = 0; i < kNo",
            "      float corr[2] = {1.f, 1.f};\n"),
    },
    "filter_counts": {
        "as built": COUNTS,
        "one row's elig in flight per warp": _sub(
            COUNTS, "constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;"),
        "B.1 key counts: a shared atomic per hit": _sub(COUNTS, KEY_BYTES, KEY_ATOMIC.format("s_keys + jb")),
        "B.1 key counts: a global atomic per hit": _sub(
            COUNTS, KEY_BYTES, KEY_ATOMIC.format("a.key_counts + q0 + jb")),
        "B.1 key counts: eight 32-bit counters in registers": _sub(_sub(_sub(
            COUNTS, KEY_BYTES, "        if (KEYS && al)\n#pragma unroll\n"
                               "          for (int k = 0; k < kQpt; ++k) kc[k] += (al >> k) & 1u;\n"),
            "  long long c = blockIdx.x;\n", "  uint32_t kc[kQpt] = {};\n  long long c = blockIdx.x;\n"),
            "  if (KEYS) flush_keys();\n",
            "  if (KEYS)\n    for (int k = 0; k < kQpt; ++k)\n      if (kc[k]) atomicAdd(s_keys + jb + k, (int)kc[k]);\n"),
        "no key counts (B.1's keys wrong)": _sub(COUNTS, KEY_BYTES, ""),
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


def build(only) -> dict[str, dict[str, ctypes.CDLL]]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for lib in only:
        for i, (name, text) in enumerate(VARIANTS[lib].items()):
            src, so = OUT / f"{lib}_{i}.cu", OUT / f"lib{lib}_{i}.so"
            src.write_text(text)
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(src)]
            procs.append((lib, name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True)))
    libs: dict[str, dict[str, ctypes.CDLL]] = {lib: {} for lib in only}
    for lib, name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{lib} / {name}: nvcc exit {proc.returncode}\n{log}")
        handle = ctypes.CDLL(str(so))
        for fn, argtypes in _build.LIBRARIES[lib][1].items():
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
        if "no softmax" not in name and "wrong" not in name:
            entry["max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                                       for g, w in zip(_tuple(got), _tuple(want)))
        entry["ms"].append(chip_smoke.cuda_ms(lambda: run(variants[name]), chip_smoke.REPS))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS), default=list(VARIANTS),
                    help="libraries whose variants are built and timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ablations: no CUDA device", file=sys.stderr)
        return 2
    libs, dev = build(args.only), torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    if "flash_attention" in libs:
        b, s, h, d = 4, 2048, 16, 64
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        strides = [x for t in (q, k, v) for x in flk._strides(t, True)]
        for window in (0, 512):
            def flash(handle, window=window):
                out = torch.empty_like(q)
                _build.check(handle.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, s, d, d,
                    *strides, 1, window, 1, stream()), "flash_attention")
                return out
            want = flk.flash_attention_plain(q, k, v, causal=True, window=window)
            print(json.dumps({"kernel": "flash_attention", "shape": f"[{b},{s},{h},{d}] bf16 causal window={window}",
                              "variants": in_turns(libs["flash_attention"], flash, want)}), flush=True)
        del q, k, v

    rng = np.random.default_rng(0)
    if "filter_counts" in libs:
        n, keys, tb = 1 << chip_smoke.LOG_N, chip_smoke.N_KEYS, chip_smoke.N_TABLES
        store16, rows, query16, elig, seg = chip_smoke.make_filter_inputs(
            rng, dev, 1 << chip_smoke.LOG_STORE, 16, n, keys, tb)
        store4, query4 = store16[:, :4].contiguous(), query16[:, :4].contiguous()
        q30 = chip_smoke.make_queries(rng, store4, rows, 30)
        elig30 = chip_smoke.make_elig(rng, dev, n, 30, "random")
        for label, st, qs, el in (("512-bit, q=256", store16, query16, elig), ("128-bit, q=256", store4, query4, elig),
                                  ("128-bit, q=30", store4, q30, elig30), ("512-bit, q=256, elig=None", store16, query16, None)):
            def gather(handle, st=st, qs=qs, el=el):
                counts = torch.zeros(tb, dtype=torch.int32, device=dev)
                _build.check(handle.gather_counts_launch(
                    st.data_ptr(), st.shape[1], qs.shape[1], rows.data_ptr(), qs.data_ptr(), qs.shape[0],
                    _build.ptr(None if el is None else el.view(torch.int8)), qs.shape[0], seg.data_ptr(),
                    n, tb, counts.data_ptr(), stream()), "gather_counts")
                return counts
            want = fk.gather_filter_table_counts_plain(rows, st, qs, el, seg, tb, qs.shape[0])
            print(json.dumps({"kernel": "gather_filter_table_counts", "shape": f"{label}, n={n}, tables={tb}",
                              "variants": in_turns(libs["filter_counts"], gather, want)}), flush=True)
        for label, qs, el, mode in (("128-bit sum, q=256", query4, elig, "sum"), ("512-bit sum, q=256", query16, elig, "sum"),
                                    ("128-bit sum, q=30", q30, elig30, "sum"), ("512-bit any, q=256", query16, elig, "any")):
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
                              "variants": in_turns(libs["filter_counts"], counts, want)}), flush=True)
            del row_sk
        del store16, store4, rows, query16, elig, seg

    if "xash_superkey" in libs:
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
