#!/usr/bin/env python3
"""Ablations of the port's redesigned kernels on one GPU: B.6 (bf16 flash
attention, ``csrc/flash_attention.cu``) and B.2 (gather-fused filter counts,
``csrc/gather_counts.cu``).

    python3 tools/kernel_ablations.py

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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import filter_kernel as fk  # noqa: E402
from repro_torch.kernels import flash_kernel as flk  # noqa: E402

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
GATHER = (CSRC / "gather_counts.cu").read_text()
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
    "gather_counts": {
        "as built": GATHER,
        "one row's elig in flight per warp": _sub(
            GATHER, "constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;"),
    },
}


def build() -> dict[str, dict[str, ctypes.CDLL]]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for lib, variants in VARIANTS.items():
        for i, (name, text) in enumerate(variants.items()):
            src, so = OUT / f"{lib}_{i}.cu", OUT / f"lib{lib}_{i}.so"
            src.write_text(text)
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(src)]
            procs.append((lib, name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True)))
    libs: dict[str, dict[str, ctypes.CDLL]] = {lib: {} for lib in VARIANTS}
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


def in_turns(variants: dict, run, want) -> dict:
    """Times ``run(handle)`` for every variant, forward then reverse."""
    res: dict[str, dict] = {}
    for name in [*variants, *reversed(variants)]:
        got = run(variants[name])
        entry = res.setdefault(name, {"ms": []})
        if "no softmax" not in name:
            entry["max_abs_err"] = float((got.float() - want.float()).abs().max())
        entry["ms"].append(chip_smoke.cuda_ms(lambda: run(variants[name]), chip_smoke.REPS))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablations: no CUDA device", file=sys.stderr)
        return 2
    libs, dev = build(), torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

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
                          "variants": in_turns(libs["gather_counts"], gather, want)}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
