"""AdamW with optional 8-bit (block-quantised) moments: port of
``repro.train.optimizer``.

Decoupled weight decay, bias correction, global-norm clipping, and the
linear-warmup + cosine schedule.  The moments are kept in float32
('f32'), bfloat16 ('bf16') or int8 with one absmax scale per block of
``Q_BLOCK`` values ('int8').  The state tree is the reference's —
``{'step', 'm', 'v'}`` with ``m`` and ``v`` mirroring the parameter tree,
an int8 moment a ``{'q', 'scale'}`` pair — so checkpoints written by either
package restore in the other.

The scalars (step, learning rate, bias corrections, clip factor) are
float32 tensors on the parameters' device, computed as the reference
computes them, so a step never waits on the host.  ``adamw_update``
writes the new parameters and moments into the tensors it is given (the
reference returns new trees) and returns the same trees.

Over a mesh (``mesh`` and ``placement``: the parameters are this rank's
shards) f32 and bf16 moments are shards like their parameters and update
elementwise.  Int8 moments are replicated, as the reference places them:
their blocks of ``Q_BLOCK`` run over the whole flattened leaf.  Each leaf
in turn, its gradient shard is all-gathered whole over every axis the
leaf is split on (in the gradient's dtype, then clipped in float32: the
same values as clipping first, in half the bytes for a bf16 gradient), m
and v are updated and requantised whole (the same bytes on every rank),
and this rank's shard of the update is written to its parameter shard,
so at most one whole leaf is held in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.train import sharding

Q_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "f32"  # 'f32' | 'bf16' | 'int8'


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``; ``step`` a float32
    tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


# -- int8 block quantisation --------------------------------------------------

def _quant(x: torch.Tensor) -> dict:
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % Q_BLOCK))
    blocks = flat.reshape(-1, Q_BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dequant(d: dict, shape: tuple[int, ...]) -> torch.Tensor:
    flat = (d["q"].float() * d["scale"]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def _make_state(shape: tuple[int, ...], device, dtype: str):
    if dtype == "int8":
        return _quant(torch.zeros(shape, dtype=torch.float32, device=device))
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    return torch.zeros(shape, dtype=dt, device=device)


def _read_state(s, dtype: str, shape: tuple[int, ...]) -> torch.Tensor:
    if dtype == "int8":
        return _dequant(s, shape)
    return s.float()


def _write_state(s, x: torch.Tensor, dtype: str) -> None:
    """Store ``x`` (float32) into the moment ``s`` in place."""
    if dtype == "int8":
        new = _quant(x)
        s["q"].copy_(new["q"])
        s["scale"].copy_(new["scale"])
    else:
        s.copy_(x)  # rounds to the moment's dtype


# -- tree helpers (nested dicts; leaves in sorted key order, the reference's) --

def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict (keys in sorted order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def leaves(tree) -> list:
    """The leaves of a nested dict, keys in sorted order (``jax.tree.leaves``'s
    order).  A dict under a moment of an int8 state counts as a subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def _moments(tree, like) -> list:
    """``tree``'s subtrees at the positions of ``like``'s leaves (an int8
    moment's ``{'q', 'scale'}`` dict stays whole)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _moments(tree[k], like[k])]
    return [tree]


# -- public API ----------------------------------------------------------------

def _replicated(cfg: AdamWConfig, mesh) -> bool:
    """Whether the moments are whole on every rank of ``mesh`` (int8)."""
    return cfg.state_dtype == "int8" and mesh is not None and mesh.size > 1


def _whole_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    return tuple(n * (mesh.axis_size(e) if e is not None else 1) for n, e in zip(shape, spec))


def init_state(params, cfg: AdamWConfig, mesh=None, placement=None) -> dict:
    """Zero moments of ``params``; over a mesh (``params`` this rank's
    shards under ``placement``) int8 moments are made whole."""
    whole = _replicated(cfg, mesh)

    def moments():
        if whole:
            return sharding.zip_map(lambda p, spec: _make_state(_whole_shape(p.shape, spec, mesh), p.device,
                                                                cfg.state_dtype), params, placement)
        return tree_map(lambda p: _make_state(p.shape, p.device, cfg.state_dtype), params)

    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return {"step": step, "m": moments(), "v": moments()}


def global_norm(tree) -> torch.Tensor:
    # each leaf's norm in float32 without a float32 copy of it (a gradient
    # may be the size of an MoE layer's experts)
    return torch.sqrt(sum(torch.linalg.vector_norm(x, dtype=torch.float32).square() for x in leaves(tree)))


def _gather_whole(g: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from this rank's shard ``g`` under ``spec``: one
    all-gather per dim split over the mesh."""
    for dim, e in enumerate(spec):
        if e is not None:
            g = sharding.all_gather(g, mesh, sharding._entry_axes(e), dim)
    return g


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, grad_norm: torch.Tensor | None = None,
                 mesh=None, placement=None):
    """One AdamW step, in place.  Returns (params, state, metrics), the
    first two the trees passed in.  ``grad_norm``: the clip's global norm
    when ``grads`` are shards (``train.sharding.global_norm``; default:
    ``global_norm(grads)``).  ``mesh`` and ``placement``: the parameters'
    mesh and placements, which int8 moments need (module docstring)."""
    state["step"] += 1
    step = state["step"].float()
    gn = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=step.device) ** step
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=step.device) ** step
    whole = _replicated(cfg, mesh)
    ps = leaves(params)
    specs = leaves(placement) if whole else [None] * len(ps)
    for p, g, m, v, spec in zip(ps, _moments(grads, params), _moments(state["m"], params),
                                _moments(state["v"], params), specs):
        if whole:
            g = _gather_whole(g, spec, mesh)
        g = g.float() * clip
        mf = cfg.b1 * _read_state(m, cfg.state_dtype, g.shape) + (1 - cfg.b1) * g
        vf = cfg.b2 * _read_state(v, cfg.state_dtype, g.shape) + (1 - cfg.b2) * g * g
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if whole:
            u = u[sharding.shard_index(u.shape, spec, mesh)]
        u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        _write_state(m, mf, cfg.state_dtype)
        _write_state(v, vf, cfg.state_dtype)
    return params, state, {"grad_norm": gn, "lr": lr}
