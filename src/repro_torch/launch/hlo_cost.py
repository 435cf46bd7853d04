"""Per-device FLOPs and collective bytes of one rank's program: the
counterpart of the reference's ``repro.launch.hlo_cost``, kept under its
name so a reader finds it.

The reference re-derives both from post-SPMD HLO text, because XLA's
``cost_analysis`` counts a ``while`` body once.  This module counts a
traced torch program and parses no HLO: ``analyze(fn, *args, **kw)`` runs
``fn`` once under ``torch.utils.flop_counter.FlopCounterMode``, with the
collective counters of ``train.sharding`` (``KINDS``, by the reference's
five kinds) zeroed first, and reads both after.  Eager tracing runs every
trip of a Python loop, so there is no trip count to correct.

FLOPs are the counter's: 2·m·n·k per matrix product (the reference's dot
rule), and for kernel B.6's forward and its backward the SDPA formulas
registered in ``kernels.flash_kernel``.  Collective bytes are the bytes of
each collective's result, counted where the port issues it
(``train.sharding``, ``core.distributed``), real or dry.  Run under
``FakeTensorMode`` on a dry mesh (``launch.dryrun``), nothing is allocated
or launched.
"""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.train import sharding

COLL_KINDS = sharding.COLLECTIVE_KINDS


def measure(fn, *args, **kw) -> tuple[object, dict]:
    """``(fn(*args, **kw), its cost)``: the cost as ``analyze`` gives it."""
    sharding.reset_kinds()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kw)
    kinds = sharding.kinds_snapshot()
    return out, {
        "flops": float(counter.get_total_flops()),
        "collective_bytes": {k: float(kinds[k]["bytes"]) for k in COLL_KINDS},
        "collective_counts": {k: float(kinds[k]["count"]) for k in COLL_KINDS},
        "collective_bytes_total": float(sum(kinds[k]["bytes"] for k in COLL_KINDS)),
    }


def analyze(fn, *args, **kw) -> dict:
    """The reference's keys for one call of ``fn``: ``flops``,
    ``collective_bytes`` and ``collective_counts`` by kind, and
    ``collective_bytes_total``."""
    return measure(fn, *args, **kw)[1]
