"""Gradient compression for data-parallel reduction: int8 + error feedback
(port of ``repro.train.compression``).

Gradients are quantised to int8 with a per-tensor scale before the
cross-replica reduction, and error feedback keeps the optimiser unbiased
over steps:

    e_t   accumulated local quantisation residual
    q_t   = quant(g_t + e_t);  e_{t+1} = (g_t + e_t) - dequant(q_t)
    ĝ_t   = Σ_replicas dequant(q_t) / n_replicas

``compressed_all_reduce`` is the reference's ``compressed_psum`` over a
``torch.distributed`` group: NCCL on the cards, gloo on host copies (the
CPU, or ranks that share one card).  Nothing on the training path calls it
yet, as in the reference: data-parallel training (``launch/train.py
--mesh D×M``) is ROADMAP A.10.10.
"""

from __future__ import annotations

import torch

from repro_torch.train import optimizer as opt


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0
    q = torch.clamp(torch.round(g / torch.clamp(scale, min=1e-12)), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error(params):
    return opt.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compressed_all_reduce(grads, errors, group=None):
    """Per-leaf int8 reduction with error feedback over ``group`` (None:
    the default group).  Returns (the replicas' mean gradients, float32,
    new errors), trees like ``grads``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    on_host = dist.get_backend(group) == "gloo"

    def one(g, e):
        gf = g.float() + e
        q, scale = quantize(gf)
        deq = dequantize(q, scale)
        new_e = gf - deq
        buf = deq.cpu() if on_host else deq  # reduced in place
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf.to(g.device) / n, new_e

    out = [one(g, e) for g, e in zip(opt.leaves(grads), opt.leaves(errors))]
    it_red, it_err = iter([o[0] for o in out]), iter([o[1] for o in out])
    return opt.tree_map(lambda _: next(it_red), grads), opt.tree_map(lambda _: next(it_err), grads)
