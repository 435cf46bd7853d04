"""Process-group meshes for the routed lake and the sharded build.

Port of ``repro.launch.mesh.make_mesh`` for the discovery system.  In
PyTorch a one-axis mesh is a process group with one rank per shard: rank i
holds shard i's device store and launches its kernels; the count merge is a
``torch.distributed`` all-reduce (``core.distributed``).

The group initialises from a ``FileStore`` path and binds no TCP port, so
parallel test workers never collide on one.  The backend is a statement of
the topology, never a fallback: 'nccl' when every rank has a card of its own
(collectives on CUDA tensors), 'gloo' when the ranks share one card (NCCL
refuses two ranks on one GPU) or run on the CPU (collectives on host
copies).

``run_ranks`` spawns one process per rank, runs a function in each and
hands the results back; every wait has a deadline, so a hung rank fails the
call instead of hanging its caller.

    mesh = make_mesh(store_path, world_size=2, rank=r, backend="gloo")
    index.attach_mesh(mesh)          # then discover as usual, on every rank
    close_mesh(mesh)
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch

from repro_torch.device import resolve_device

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a one-axis process-group mesh."""

    rank: int
    size: int
    backend: str  # 'gloo' | 'nccl'
    device: torch.device  # this rank's device: its shard's store lives here
    group: object = None  # torch.distributed group (None: the default group)


def make_mesh(
    store_path: str,
    world_size: int,
    rank: int,
    *,
    backend: str = "gloo",
    device=None,
    timeout_s: float = 120.0,
) -> Mesh:
    """Join the ``world_size``-rank group whose ``FileStore`` lives at
    ``store_path`` as ``rank`` and return this rank's ``Mesh``.  ``device``
    is the rank's device (None: the CUDA device, raising without one)."""
    if backend not in BACKENDS:
        raise ValueError(f"mesh backend must be one of {BACKENDS}, got {backend!r}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device on every rank")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)  # NCCL's communicator binds the current card
    import torch.distributed as dist

    dist.init_process_group(
        backend,
        store=dist.FileStore(store_path, world_size),
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return Mesh(rank, world_size, backend, dev, group=dist.group.WORLD)


def close_mesh(mesh: Mesh) -> None:
    """Leave the group ``make_mesh`` joined."""
    import torch.distributed as dist

    dist.destroy_process_group(mesh.group)


def rank_devices(world_size: int) -> list[str]:
    """The default rank devices: rank r on ``cuda:(r mod cards)``, round
    robin over the visible cards (one card: every rank shares it).  Raises
    where this process has no card, as every entry point of the port does;
    pass ``devices=['cpu'] * world_size`` for the CPU."""
    resolve_device(None)
    cards = torch.cuda.device_count()
    return [f"cuda:{r % cards}" for r in range(world_size)]


def rank_layout(world_size: int, device=None) -> tuple[str, list[str]]:
    """``(backend, rank devices)`` of a ``world_size``-rank group on this
    host for work on ``device`` (None: the CUDA device): on the CPU every
    rank over gloo; on CUDA the cards round robin (``rank_devices``), over
    NCCL when every rank has a card of its own and gloo when ranks share
    one."""
    if resolve_device(device).type == "cpu":
        return "gloo", ["cpu"] * world_size
    backend = "nccl" if torch.cuda.device_count() >= world_size else "gloo"
    return backend, rank_devices(world_size)


def _rank_main(fn, rank, world_size, backend, device, store_path, args, results, timeout_s):
    """One spawned rank: join the group, run ``fn(mesh, *args)``, report
    ``(rank, ok, result or traceback)``."""
    try:
        mesh = make_mesh(store_path, world_size, rank, backend=backend, device=device,
                         timeout_s=timeout_s)
        try:
            out = fn(mesh, *args)
        finally:
            close_mesh(mesh)
        results.put((rank, True, out))
    except Exception:  # the boundary: the parent raises with this traceback
        results.put((rank, False, traceback.format_exc()))


def run_ranks(
    fn,
    world_size: int,
    *,
    backend: str = "gloo",
    devices=None,
    args: tuple = (),
    timeout_s: float = 120.0,
) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned ranks and return
    their results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by import path), and so is each
    result.  ``devices`` gives each rank's device (default:
    ``rank_devices``, the cards round robin; raises without one).  Raises
    ``RuntimeError`` when a rank fails or dies, and
    ``TimeoutError`` when the ranks have not all reported within
    ``timeout_s``; every rank is stopped before this returns or raises.
    """
    devices = rank_devices(world_size) if devices is None else [str(d) for d in devices]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: dict[int, object] = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, r, world_size, backend, devices[r], store, args, results, timeout_s),
                daemon=True,
            )
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world_size)) - set(got))} of"
                        f" {world_size} did not report within {timeout_s} s"
                    )
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank(s) {dead} died (exit codes"
                            f" {[procs[r].exitcode for r in dead]})"
                        ) from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                if len(got) == world_size:  # reported: let it exit on its own
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
            results.close()
    return [got[r] for r in range(world_size)]
