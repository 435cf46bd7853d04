"""Parameter specification / materialisation (port of ``repro.models.params``).

Models are described as nested dicts of ``ParamSpec`` (shape + logical axes
+ initialiser).  ``materialize`` turns a spec tree into tensors drawn from a
``torch.Generator`` on the target device, with the reference's init rule;
``from_reference`` carries the reference's own parameter tree across (numpy
arrays in, tensors out), so the port can be held against the reference on
the same weights.  ``abstract`` gives meta-device tensors (shapes and
dtypes, no storage).

The placement half: ``DEFAULT_RULES`` maps logical axes to mesh axes;
``partition_specs``, ``validate_divisibility`` and ``shardings`` turn a spec
tree into per-leaf placements.  A placement is the reference's
``PartitionSpec`` as a plain tuple, one entry per dim: a mesh axis name, a
tuple of axis names, or None (replicated), normalised as JAX normalises
its specs (a one-axis tuple is the axis itself, an empty tuple None), so
``tuple(reference spec) == placement``.  A mesh is anything with ``.shape``
(a dict of axis sizes) and ``.axis_names``: the port's process-group
meshes (``launch.mesh``), or a plain namespace for device-free checks.
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
    # scaled in place: the float32 draw of a leaf is the only transient
    noise = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    if spec.init == "embed":
        return noise.mul_(0.02).to(dtype)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[0], 1)
    if len(spec.shape) >= 3:  # stacked/experts: fan-in is the contract dim
        fan_in = spec.shape[-2]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    return noise.mul_(scale).to(dtype)


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


def abstract(specs, dtype=torch.bfloat16) -> dict:
    """Meta-device tensors for a spec tree: shapes and dtypes, no storage."""
    return _map_tree(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


# default logical→mesh rules (single- and multi-pod): TP on 'model',
# FSDP on 'data' (embed/contract dims), experts on 'model' (EP).
DEFAULT_RULES: dict[str, Any] = {
    "vocab": "model",
    "embed": "data",  # FSDP shard of the contracting dim
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "layers": None,
    "q_lora": None,
    "kv_lora": None,
    "frames": None,
}


def _norm_entry(axis):
    """One placement entry as JAX's ``PartitionSpec`` keeps it."""
    if isinstance(axis, tuple):
        if not axis:
            return None
        return axis[0] if len(axis) == 1 else axis
    return axis


def spec_to_pspec(spec: ParamSpec, rules: dict[str, Any]) -> tuple:
    return tuple(_norm_entry(rules.get(a)) if a is not None else None for a in spec.axes)


def partition_specs(specs, rules: dict[str, Any] | None = None):
    rules = rules or DEFAULT_RULES
    return _map_tree(lambda s: spec_to_pspec(s, rules), specs)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: tuple


def shardings(specs, mesh, rules: dict[str, Any] | None = None):
    return _map_tree(lambda p: NamedSharding(mesh, p), partition_specs(specs, rules))


def axis_size(mesh, axes) -> int:
    """The number of ranks over ``axes`` (a mesh axis or a tuple of them)."""
    return math.prod(mesh.shape[a] for a in (axes if isinstance(axes, tuple) else (axes,)))


def validate_divisibility(specs, mesh, rules: dict[str, Any] | None = None):
    """Replace rules that don't divide evenly by replication (e.g. 8 KV heads
    on a 16-way model axis).  Returns adjusted per-leaf placements."""
    rules = rules or DEFAULT_RULES

    def fix(spec: ParamSpec) -> tuple:
        out = []
        for dim, axis in zip(spec.shape, spec.axes):
            mesh_axis = rules.get(axis) if axis is not None else None
            if mesh_axis is None:
                out.append(None)
                continue
            out.append(_norm_entry(mesh_axis) if dim % axis_size(mesh, mesh_axis) == 0 else None)
        return tuple(out)

    return _map_tree(fix, specs)


def count(tree) -> int:
    """Number of stored parameters in a tensor tree."""
    if isinstance(tree, dict):
        return sum(count(v) for v in tree.values())
    return tree.numel()
