"""Parameter specification / materialisation (port of ``repro.models.params``).

Models are described as nested dicts of ``ParamSpec`` (shape + logical axes
+ initialiser).  ``materialize`` turns a spec tree into tensors drawn from a
``torch.Generator`` on the target device, with the reference's init rule;
``from_reference`` carries the reference's own parameter tree across (numpy
arrays in, tensors out), so the port can be held against the reference on
the same weights.  The sharding helpers (``partition_specs``, ``shardings``,
``validate_divisibility``) wait for the mesh port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]  # logical axis per dim (str | None)
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: float | None = None  # None → 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _init_tensor(spec: ParamSpec, gen: torch.Generator, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    noise = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    if spec.init == "embed":
        return (noise * 0.02).to(dtype)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[0], 1)
    if len(spec.shape) >= 3:  # stacked/experts: fan-in is the contract dim
        fan_in = spec.shape[-2]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    return (noise * scale).to(dtype)


def _map_tree(fn, tree):
    """``fn`` over the leaves of a nested dict, keys visited in sorted order
    (the reference's flatten order)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def materialize(specs, seed: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    """Tensors for a spec tree, drawn leaf by leaf (sorted key order) from one
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default: CUDA).

    The draws are not the reference's ``jax.random`` bits; to compare the
    two on the same weights, use ``from_reference``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _map_tree(lambda s: _init_tensor(s, gen, dtype, dev), specs)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy; its
        # values are exact in float32, and float32 → bfloat16 is then exact
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_reference(tree, device=None) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors: same key
    paths, same leading layer axis, same dtype, bit for bit."""
    dev = resolve_device(device)
    return _map_tree(lambda a: _to_tensor(a, dev), tree)


def count(tree) -> int:
    """Number of stored parameters in a tensor tree."""
    if isinstance(tree, dict):
        return sum(count(v) for v in tree.values())
    return tree.numel()
