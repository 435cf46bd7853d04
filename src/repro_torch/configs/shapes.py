"""Assigned input shapes and per-(arch × shape) applicability.

Four shapes per architecture (40 cells):
  train_4k     seq=4096   global_batch=256   → train_step
  prefill_32k  seq=32768  global_batch=32    → prefill
  decode_32k   seq=32768  global_batch=128   → serve_step (1 token, 32k cache)
  long_500k    seq=524288 global_batch=1     → serve_step (1 token, 500k ctx)

long_500k requires sub-quadratic context handling and is SKIPPED for pure
full-attention archs (see DESIGN.md §5); it runs for ssm/hybrid/SWA archs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention arch: 512k dense KV decode is the quadratic "
            "regime this shape excludes (DESIGN.md §5)"
        )
    return True, ""
