"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, and
loaded with ``ctypes``.  Nothing includes PyTorch's headers, so a build takes
seconds, not minutes.  Libraries land in ``build/repro_torch_kernels/`` at the
root of the checkout (git-ignored), named by a hash of the sources, so a
changed kernel is rebuilt once and an unchanged one is reused.

The build runs at first use, never at import.  ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them together.  A build
failure raises: there is no fallback to the plain PyTorch versions, which
serve CPU tensors only.

Calling convention of every entry point: pointers and the stream are
``c_void_p``, sizes are ``c_longlong`` or ``c_int``; the function launches
on the given stream, allocates nothing, does not synchronise, and returns
``cudaGetLastError()`` as an int (``check`` raises when it is not 0).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# library name -> (source file, {entry point: argtypes})
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIBRARIES = {
    "xash_superkey": (
        "xash_superkey.cu",
        {
            # enc, out, rank_host, n, n_cols, max_len, lanes, c, region, lseg,
            # n_char_bits, use_location, use_rotation, use_length, stream
            "xash_superkey_launch": [
                _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
            ],
        },
    ),
    "filter_counts": (
        "filter_counts.cu",
        {
            # rows_sk, row_stride, lanes, query, n_queries, elig, elig_stride,
            # seg, n, n_tables, counts, key_counts, any_mode, row_hit, stream
            "filter_counts_launch": [
                _P, _I, _I, _P, _I, _P, _LL, _P, _LL, _I, _P, _P, _I, _P, _P,
            ],
            # store, row_stride, lanes, rows, query, n_queries, elig,
            # elig_stride, seg, n, n_tables, counts, stream
            "gather_counts_launch": [
                _P, _I, _I, _P, _P, _I, _P, _LL, _P, _LL, _I, _P, _P,
            ],
            # rows_sk, lanes, query, n_queries, n, out, stream
            "filter_match_launch": [_P, _I, _P, _I, _LL, _P, _P],
            # rows_sk, lanes, query, n_queries, n, counts, stream
            "filter_count_launch": [_P, _I, _P, _I, _LL, _P, _P],
        },
    ),
    "flash_attention": (
        "flash_attention.cu",
        {
            # q, k, v, out, lse (or null), B, H, S, T, d, dv, scale_d, q
            # strides (b, s, h), k strides, v strides, causal, window,
            # is_bf16, stream
            "flash_attention_launch": [
                _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _P,
            ],
        },
    ),
    "flash_attention_bwd": (
        "flash_attention_bwd.cu",
        {
            # q, k, v, out, dout, lse, lse2, delta (scratch), dq, dk, dv, B,
            # H, S, T, d, dv, scale_d, q strides (b, s, h), k strides, v
            # strides, causal, window, is_bf16, stream
            "flash_attention_bwd_launch": [
                _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _P,
            ],
        },
    ),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built by
# this process, for chip_smoke.py to print
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are"
        " built from source at first use on a CUDA device"
    )


def _lib_path(name: str) -> Path:
    src, _ = LIBRARIES[name]
    text = (_CSRC / src).read_bytes() + b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> float:
    """Compile every library not built yet, one nvcc per source, in
    parallel.  Returns the wall seconds spent.  Raises on any failure."""
    names = list(LIBRARIES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / LIBRARIES[name][0])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in LIBRARIES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {err}")


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent optional operand)."""
    return None if t is None else t.data_ptr()
