"""Training driver: ``python -m repro_torch.launch.train --arch <id> [--smoke] ...``

Port of ``repro.launch.train``: the same flags and defaults, plus
``--device`` (default CUDA; ``--device cpu`` runs the plain PyTorch path)
and ``--layers N`` (the config cut to N layers, its widths whole), and the
same ``[train]`` lines.  Randomly initialises the model from
``--seed``, trains it with AdamW on ``TokenPipeline`` batches (the stub
frontends' frames / patches for whisper and the VLM), checkpoints every
``--ckpt-every`` steps (atomic, keep 3), resumes from the latest
checkpoint in ``--ckpt-dir``, and on SIGTERM saves before it exits.
``main`` returns the list of losses.

``--mesh DxM`` (D·M > 1) spawns D·M ranks (``launch.mesh.run_ranks``, a
``GridMesh`` of axes 'data' and 'model'): gloo when ranks share a card or
run on the CPU, NCCL when every rank has a card of its own.  Each rank
draws the same weights, keeps its shards under the reference's placement
(``launch.mesh.param_shardings``: FSDP over 'data', tensor parallel over
'model'), and runs the reference's loop on its rows ``[d·B/D, (d+1)·B/D)``
of every global batch (``train.step.make_train_step`` with the mesh).
Checkpoints hold full arrays (written by rank 0), so a run resumes on any
mesh, 1x1 included.  Rank 0's ``[train]`` lines are printed when the ranks
are done, and ``main`` returns rank 0's losses.  The kernels are built once,
before the ranks are spawned.

``--mesh Dx1`` (FSDP only) and a model axis M > 1 take every arch: the
dense decoders, the MoE ones (expert parallelism: E/M experts a rank
where M divides E, else every expert on each), MLA with MTP
(deepseek-v3), cross-attention (llama-3.2-vision), the encoder-decoder
(whisper), the SSM (mamba2: its heads split, ``models.ssm``) and the
hybrid (jamba: SSM, attention and MoE sublayers).  Each rank gathers
its FSDP shards one block at a time (``models.transformer``).
``--state-dtype int8`` takes any mesh: its moments are block-quantised
over a whole leaf and replicated on every rank, as the reference places
them (``train.optimizer``); rank 0 writes them once to a checkpoint.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenPipeline, stub_inputs
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_kernel
from repro_torch.launch import mesh as meshlib
from repro_torch.models import layers, params as params_lib, transformer
from repro_torch.train import optimizer as opt, sharding, step as step_lib

RANK_TIMEOUT_S = 6 * 3600.0  # the deadline of a --mesh run's ranks


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1", help="data×model, e.g. 16x16")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--state-dtype", default="f32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep N layers of the config, its widths whole (the port's own flag)")
    return ap.parse_args(argv)


def _config(args):
    cfg = configs.get_config(args.arch)
    cfg = configs.reduce_config(cfg) if args.smoke else cfg
    return dataclasses.replace(cfg, n_layers=args.layers) if args.layers else cfg


def check_mesh(cfg, dp: int, tp: int, args) -> None:
    """Raise ``ValueError`` for a mesh this run cannot use."""
    if dp < 1 or tp < 1:
        raise ValueError(f"--mesh {args.mesh}: both axes must be >= 1")
    if args.global_batch % dp:
        raise ValueError(f"--global-batch {args.global_batch} does not split over {dp} data ranks")


def placement(cfg, mesh) -> dict:
    """The parameter placements of ``cfg`` on ``mesh`` (FSDP rules)."""
    return params_lib.validate_divisibility(transformer.model_specs(cfg), mesh, meshlib.rules_for(mesh))


def state_placement(place: dict, state_dtype: str = "f32") -> dict:
    """Placements of ``{'params', 'opt'}``: f32 and bf16 moments as their
    parameters, int8 moments (``{'q', 'scale'}``) replicated, ``()``."""
    if state_dtype == "int8":
        moments = opt.tree_map(lambda _: {"q": (), "scale": ()}, place)
        return {"params": place, "opt": {"step": (), "m": moments, "v": moments}}
    return {"params": place, "opt": {"step": (), "m": place, "v": place}}


def train_config(args) -> step_lib.TrainConfig:
    """The step's settings for these arguments: AdamW at ``--lr`` with the
    reference driver's warmup over ``--steps``, the loss head chunked at
    up to 1024 positions."""
    return step_lib.TrainConfig(
        adamw=opt.AdamWConfig(
            lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
            total_steps=args.steps, state_dtype=args.state_dtype,
        ),
        ce_chunk=min(1024, args.seq_len),
    )


def train(args, mesh=None, log=print) -> dict:
    """The reference's loop, on one process (``mesh`` None) or on this rank
    of a ``GridMesh``.  ``log`` gets each ``[train]`` line.  Returns this
    rank's report: losses and gradient norms per step, ms per step (host
    clock, ending in a sync), B.6 launches per step, the seconds spent in
    collectives, the peak device memory, the most bytes of FSDP-gathered
    weights alive at once in the steps (``sharding.GATHERED``), the last
    step's collectives by kind (``sharding.KINDS``), the devices of every
    parameter and moment."""
    cfg = _config(args)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    tcfg = train_config(args)
    params = params_lib.materialize(transformer.model_specs(cfg), args.seed, device=dev)
    rows = slice(0, args.global_batch)
    place = None
    if mesh is not None:
        layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
        place = placement(cfg, mesh)
        params = sharding.local_tree(params, place, mesh)
        share = args.global_batch // mesh.axis_size(meshlib.batch_axes(mesh))
        d = mesh.axis_index(meshlib.batch_axes(mesh))
        rows = slice(d * share, (d + 1) * share)
    opt_state = opt.init_state(params, tcfg.adamw, mesh, place)
    placed = {} if mesh is None else {"placement": state_placement(place, args.state_dtype), "mesh": mesh}

    data = TokenPipeline(DataConfig(args.seq_len, args.global_batch, cfg.vocab_size, args.seed))
    extra = {k: v[rows] for k, v in stub_inputs(cfg, args.global_batch, device=dev).items()}

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        mgr.install_preemption_handler()
        latest = mgr.latest_step()
        if latest is not None:
            restored = mgr.restore(latest, {"params": params, "opt": opt_state}, **placed)
            params, opt_state = restored["params"], restored["opt"]
            start_step = latest
            log(f"[train] resumed from step {latest}")

    train_step = step_lib.make_train_step(cfg, tcfg, mesh, place)
    report = {"losses": [], "grad_norm": [], "ms": [], "b6_launches": [], "comm_s": [], "kinds": None,
              "gathered_peak_bytes": 0,
              "devices": sorted({str(t.device) for t in opt.leaves({"p": params, "o": opt_state})})}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sharding.reset_gathered()

    t0 = time.time()
    losses = report["losses"]
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v[rows]).to(dev, torch.long) for k, v in data.batch(step).items()}
        batch.update(extra)
        launches, comm, t = flash_kernel.flash_attention.launches, sharding.COMM["seconds"], time.perf_counter()
        sharding.reset_kinds()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))  # ends in a sync
        report["kinds"] = sharding.kinds_snapshot()
        report["ms"].append(1e3 * (time.perf_counter() - t))
        report["b6_launches"].append(flash_kernel.flash_attention.launches - launches)
        report["comm_s"].append(sharding.COMM["seconds"] - comm)
        report["grad_norm"].append(float(metrics["grad_norm"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = args.global_batch * args.seq_len * (step - start_step + 1) / max(dt, 1e-9)
            log(
                f"[train] step={step} loss={losses[-1]:.4f} "
                f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.2f} "
                f"tok/s={tok_s:,.0f}"
            )
        preempted = mgr is not None and mgr.preempted
        if mesh is not None and mgr is not None:  # one rank's SIGTERM stops them all
            flag = torch.tensor([float(preempted)])
            preempted = bool(sharding.all_reduce(flag, mesh, mesh.axis_names, dist.ReduceOp.MAX))
        if mgr and (step % args.ckpt_every == args.ckpt_every - 1 or preempted):
            mgr.save(step + 1, {"params": params, "opt": opt_state}, **placed)
            if preempted:
                log("[train] preemption save complete; exiting")
                return _finish(report, dev, mesh)
    # the reference writes the last step again even where the loop just
    # saved it; the same state, so once here
    if mgr and mgr.latest_step() != args.steps:
        mgr.save(args.steps, {"params": params, "opt": opt_state}, **placed)
    log(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return _finish(report, dev, mesh)


def _finish(report: dict, dev, mesh) -> dict:
    report["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    report["gathered_peak_bytes"] = sharding.GATHERED["peak"]
    if mesh is not None:
        layers.disable_activation_sharding()
    return report


def _rank(mesh, argd: dict) -> dict:
    """One rank of a ``--mesh`` run: ``train`` on its ``GridMesh``, rank 0
    keeping the ``[train]`` lines.  The report adds this rank's B.6 calls
    by query shape (``attention_shapes``) and launches (``b6_total``)."""
    lines: list[str] = []
    shapes: collections.Counter = collections.Counter()
    forward = flash_kernel._forward

    def counted(q, k, v, *args):
        shapes[str(list(q.shape))] += 1
        return forward(q, k, v, *args)

    flash_kernel.flash_attention.launches = 0
    flash_kernel._forward = counted
    try:
        report = train(argparse.Namespace(**argd), mesh, lines.append if mesh.rank == 0 else lambda _: None)
    finally:
        flash_kernel._forward = forward
    report.update(rank=mesh.rank, coords=mesh.coords, lines=lines, attention_shapes=dict(shapes),
                  b6_total=flash_kernel.flash_attention.launches)
    return report


def run(argv=None) -> list[dict]:
    """``main``'s work: every rank's report (one for ``--mesh 1x1``), rank 0's
    ``[train]`` lines printed."""
    args = parse_args(argv)
    dp, tp = (int(x) for x in args.mesh.split("x"))
    cfg = _config(args)
    check_mesh(cfg, dp, tp, args)
    if dp * tp == 1:
        return [train(args)]
    world = dp * tp
    backend, devices = meshlib.rank_layout(world, args.device)
    if devices[0] != "cpu":  # one build for every rank: D·M ranks would each run nvcc
        from repro_torch.kernels import _build

        _build.build_all()
    reports = meshlib.run_ranks(_rank, world, backend=backend, devices=devices, args=(vars(args),),
                                timeout_s=RANK_TIMEOUT_S, grid={"data": dp, "model": tp})
    for line in reports[0]["lines"]:
        print(line)
    return reports


def main(argv=None):
    return run(argv)[0]["losses"]


if __name__ == "__main__":
    main()
