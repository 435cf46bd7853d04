#!/usr/bin/env python3
"""Does ``chip_smoke.py``'s non-causal B.6 check catch a kernel that lets in
the keys past T?

    python3 tools/flash_mask_mutation.py

Needs a CUDA card and ``nvcc``.  Runs kernel B.6 against its plain version
at the smoke's ``FLASH_NONCAUSAL`` shapes, on the same inputs as its
``flash_edge`` phase, twice: on this checkout, then on a copy of it in a
temporary directory whose bf16 edge-tile mask has lost its bound at T
(a non-causal row then admits every key of a tile), so that the TMA's
zero-filled keys past T (score 0, V 0) enter the softmax.  Per shape and dtype it prints max_abs_err, mean |err| / mean
|plain| and whether the smoke's tolerances (``FLASH_NONCAUSAL_DTYPES``,
``FLASH_NONCAUSAL_MEAN_REL``) hold.  One JSON line, then the card's name
and power limit; exits 0 when every check holds on the checkout and every
bf16 check fails on the planted copy (f32 runs the FMA kernel, whose mask
is other code, and must hold on both), 1 otherwise, 2 without a card.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
SOUND_MASK = "hi[e] = (p.causal ? min(p.T, r + 1) : p.T) - k0 - col;"
PLANTED_MASK = "hi[e] = (p.causal ? r + 1 : 1 << 30) - k0 - col;"


def readings(root: Path) -> list[dict]:
    """B.6 against its plain version at every ``FLASH_NONCAUSAL`` shape and
    dtype, with the tree at ``root`` imported (its kernels built there)."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_kernel as flk

    dev, out = torch.device("cuda"), []
    for b, s, t, h, d in cs.FLASH_NONCAUSAL:
        for dtype, tol in cs.FLASH_NONCAUSAL_DTYPES:
            gen = torch.Generator(device=dev).manual_seed(s + t)  # flash_edge_phase at seed 0
            qkv = [torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype) for n in (s, t, t)]
            got = flk.flash_attention(*qkv, causal=False).float()
            want = flk.flash_attention_plain(*qkv, causal=False).float()
            err = float((got - want).abs().max())
            mean_rel = float((got - want).abs().mean() / want.abs().mean())
            out.append({"shape": [b, s, t, h, d], "dtype": str(dtype)[6:], "max_abs_err": err,
                        "tolerance": tol, "mean_rel_err": mean_rel,
                        "mean_rel_tolerance": cs.FLASH_NONCAUSAL_MEAN_REL,
                        "held": err < tol and mean_rel < cs.FLASH_NONCAUSAL_MEAN_REL})
    return out


def planted_copy(dst: Path) -> Path:
    """This checkout's ``chip_smoke.py``, ``tools`` and ``src`` under
    ``dst``, the bf16 edge mask's key bound removed (built afresh there)."""
    for name in ("chip_smoke.py", "tools", "src"):
        src = ROOT / name
        if src.is_dir():
            shutil.copytree(src, dst / name, ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(src, dst / name)
    text = (dst / CU).read_text()
    if text.count(SOUND_MASK) != 1:
        raise RuntimeError(f"{CU}: the edge mask line was not found once")
    (dst / CU).write_text(text.replace(SOUND_MASK, PLANTED_MASK))
    return dst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_mask_mutation: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--here"]:  # the child run inside the planted copy
        print(json.dumps(readings(ROOT)))
        return 0
    sound = readings(ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        copy = planted_copy(Path(tmp))
        run = subprocess.run([sys.executable, str(copy / "tools" / Path(__file__).name), "--here"],
                             capture_output=True, text=True, cwd=copy)
        if run.returncode:
            sys.stderr.write(run.stderr)
            return 1
        planted = json.loads(run.stdout.strip().splitlines()[-1])
    ok = (all(r["held"] for r in sound)
          and all(r["held"] == (r["dtype"] == "float32") for r in planted))
    print(json.dumps({"ok": ok, "sound": sound, "planted": planted}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
