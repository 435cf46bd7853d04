"""GPipe pipeline parallelism over process groups (port of
``repro.train.pipeline``).

Layers are stacked [L, ...] and viewed as [n_stages, L/n_stages, ...]
(``stage_view``); one rank runs per (stage, batch shard) of a
``launch.mesh.GridMesh``, holding its stage's block of the stacked leaves
(``stage_placement``: dim 0 over the stage axis) and every other leaf
whole.  The schedule is the reference's GPipe: T = n_micro + n_stages - 1
ticks; at tick t stage s runs microbatch t - s (stage 0 embeds it), the
last stage adds the masked CE, and activations go to the next stage by
``send``/``recv``.  Bubble ticks compute nothing (the reference computes
and discards them), which changes no loss and no gradient.

The reference gets the backward from ``jax.grad`` through ``ppermute``.
Autograd does not cross a send/recv, so the reverse hand-off is written
here, in the backward of ``_GPipe`` (a ``torch.autograd.Function`` whose
forward runs the schedule without a graph and keeps each microbatch's
stage input): for each microbatch, last first, a stage receives dY from
the next stage, recomputes its layers from the kept input (the reference's
``jax.checkpoint``), back-propagates, and sends dX to the previous stage.
Then the stage's layer gradients are summed over the batch axes and the
other leaves' (embedding, final norm, head) over the stage and batch axes,
so after ``loss.backward()`` on every rank each ``.grad`` holds what
``jax.grad`` of the reference's pipeline loss gives that rank's shard.

The reference's bf16 activation casts are kept (``ACT_DTYPE``): the
embedding and the head cast to bf16, the CE on float32 logits.  Uniform
decoder stacks only, as there.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.train import sharding
from repro_torch.train.optimizer import tree_map

ACT_DTYPE = torch.bfloat16  # the reference's activation dtype on the pipeline


def stage_view(params: dict, n_stages: int) -> dict:
    """Reshape stacked layer weights [L, ...] -> [n_stages, L/S, ...]."""
    out = dict(params)
    out["layers"] = tree_map(lambda a: a.reshape((n_stages, a.shape[0] // n_stages) + a.shape[1:]),
                             params["layers"])
    return out


def stage_placement(staged: dict, stage_axis: str = "pod") -> dict:
    """Placements of a staged tree: dim 0 of every ``layers`` leaf over
    ``stage_axis``, everything else whole (the reference's shard_map specs)."""
    out = tree_map(lambda a: (None,) * a.ndim, staged)
    out["layers"] = tree_map(lambda a: (stage_axis,) + (None,) * (a.ndim - 1), staged["layers"])
    return out


def _flatten(tree, path=()) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


def _unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _masked_ce(h, head, labels):
    logits = (h @ head).float()
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    ce = torch.where(valid, lse - gold, torch.zeros_like(lse))
    return ce.sum(), valid.sum().float()


class _Schedule:
    """One rank's share of the GPipe schedule."""

    def __init__(self, cfg: ModelConfig, plan, mesh, n_micro: int, stage_axis: str, batch_axes: tuple,
                 paths: list):
        self.cfg, self.plan, self.mesh, self.n_micro = cfg, plan, mesh, n_micro
        self.paths, self.batch_axes = paths, tuple(batch_axes)
        self.all_axes = (stage_axis,) + self.batch_axes
        self.n_stages = mesh.shape[stage_axis]
        self.stage = mesh.coords[stage_axis]
        self.ranks = mesh.group_ranks(stage_axis)  # global rank of each stage, this batch shard

    def stack(self, params, x, positions):
        """This stage's layers over x."""
        stacked = tree_map(lambda a: a[0], params["layers"])  # [1, L/S, ...] -> [L/S, ...]
        n = _flatten(stacked)[0][1].shape[0]
        for lp in transformer._unstack(stacked, n):
            for i, (mixer, ffn) in enumerate(self.plan.sublayers):
                window = self.cfg.sliding_window if mixer == "attn" else 0
                x, _ = transformer._layer_fwd(lp[f"s{i}"], self.cfg, x, positions, mixer, ffn, window=window)
        return x

    def embed(self, params, tokens):
        return params["embed"].to(ACT_DTYPE)[tokens]

    def loss_sum(self, params, y, labels):
        head = (params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]).to(ACT_DTYPE)
        return _masked_ce(layers.norm_fwd(params["final_norm"], self.cfg, y), head, labels)

    def micro(self, t: torch.Tensor, j: int) -> torch.Tensor:
        mb = t.shape[0] // self.n_micro
        return t[j * mb : (j + 1) * mb]

    def prev(self) -> int:
        return self.ranks[self.stage - 1]

    def next(self) -> int:
        return self.ranks[self.stage + 1]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, tokens, labels, *leaves):
        params = _unflatten(sched.paths, leaves)
        s, last, mesh = sched.stage, sched.n_stages - 1, sched.mesh
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        mb, d = tokens.shape[0] // sched.n_micro, sched.cfg.d_model
        inputs, lsum, cnt = {}, torch.zeros((), device=tokens.device), torch.zeros((), device=tokens.device)
        for t in range(sched.n_micro + sched.n_stages - 1):
            j = t - s
            if not 0 <= j < sched.n_micro:  # a bubble tick
                continue
            if s == 0:
                x = sched.embed(params, sched.micro(tokens, j))
            else:
                x = inputs[j] = sharding.recv((mb, tokens.shape[1], d), ACT_DTYPE, tokens.device, mesh,
                                              sched.prev())
            y = sched.stack(params, x, positions)
            if s == last:
                ls, lc = sched.loss_sum(params, y, sched.micro(labels, j))
                lsum, cnt = lsum + ls, cnt + lc
            else:
                sharding.send(y, mesh, sched.next())
        # total over stages (only the last contributed) and batch shards
        lsum = sharding.all_reduce(lsum, mesh, sched.all_axes)
        cnt = sharding.all_reduce(cnt, mesh, sched.all_axes)
        ctx.sched, ctx.inputs, ctx.cnt = sched, inputs, cnt
        ctx.save_for_backward(tokens, labels, *leaves)
        return lsum / torch.clamp(cnt, min=1.0)

    @staticmethod
    def backward(ctx, grad):
        sched = ctx.sched
        tokens, labels, *leaves = ctx.saved_tensors
        mine = [leaf.detach().requires_grad_(True) for leaf in leaves]
        params = _unflatten(sched.paths, mine)
        s, last, mesh = sched.stage, sched.n_stages - 1, sched.mesh
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        coef = grad / torch.clamp(ctx.cnt, min=1.0)
        for j in reversed(range(sched.n_micro)):  # the last stage sends microbatch n-1's dX first
            with torch.enable_grad():
                if s == 0:
                    x = sched.embed(params, sched.micro(tokens, j))
                else:
                    x = ctx.inputs[j].detach().requires_grad_(True)
                y = sched.stack(params, x, positions)
                if s == last:
                    ls, _ = sched.loss_sum(params, y, sched.micro(labels, j))
                    torch.autograd.backward(ls * coef)
                else:
                    dy = sharding.recv(tuple(y.shape), ACT_DTYPE, tokens.device, mesh, sched.next())
                    torch.autograd.backward(y, dy)
            if s != 0:
                sharding.send(x.grad, mesh, sched.prev())
        grads = []
        for path, p in zip(sched.paths, mine):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            axes = sched.batch_axes if path[0] == "layers" else sched.all_axes
            grads.append(sharding.all_reduce(g, mesh, axes) if axes else g)
        ctx.inputs = None
        return (None, None, None, *grads)


def pipeline_loss_fn(
    cfg: ModelConfig,
    mesh,
    n_micro: int,
    staged_example,
    stage_axis: str = "pod",
    batch_axes: tuple = ("data",),
):
    """Returns loss(params_staged, tokens, labels) with pipeline execution,
    to be called on every rank of ``mesh`` (a ``GridMesh`` with
    ``stage_axis`` and ``batch_axes``).

    Each rank passes its shards: ``params_staged``'s ``layers`` leaves its
    stage's block [1, L/S, ...] (``sharding.local_tree`` under
    ``stage_placement``), the other leaves whole; ``tokens`` / ``labels``
    its [B/D, S] rows.  ``staged_example``: any tree of the staged
    structure.  The loss is the global masked mean CE, the same on every
    rank; ``loss.backward()`` on every rank runs the reverse schedule."""
    plans = transformer.group_plans(cfg)
    if not (len(plans) == 1 and plans[0].name == "layers"):
        raise ValueError("pipeline parallelism supports uniform decoder stacks")
    paths = [p for p, _ in _flatten(staged_example)]
    sched = _Schedule(cfg, plans[0], mesh, n_micro, stage_axis, batch_axes, paths)

    def run(staged_params, tokens, labels):
        if tokens.shape[0] % n_micro:
            raise ValueError(f"{tokens.shape[0]} rows do not split into {n_micro} microbatches")
        return _GPipe.apply(sched, tokens, labels, *[leaf for _, leaf in _flatten(staged_params)])

    return run
