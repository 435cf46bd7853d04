"""Process-group meshes and the placement rules of every (arch × mesh) cell.

Port of ``repro.launch.mesh``.  In PyTorch a mesh is a process group with
one rank per grid point.

* ``Mesh`` — one axis, one rank per shard: the routed lake and the
  sharded build.  Rank i holds shard i's device store and launches its
  kernels; the count merge is a ``torch.distributed`` all-reduce
  (``core.distributed``).
* ``GridMesh`` — several named axes (``{'data': D, 'model': M}``,
  ``{'pod': P, 'data': D}``, ...): training over a mesh.  Rank = the
  row-major index of its coordinates; every subset of the axes has its own
  subgroups, made by every rank in the same order (``grid_mesh``), so a
  collective over 'data' or ('pod', 'data') runs inside this rank's
  coordinate line or plane.

The placement half (``batch_axes``, ``rules_for``, ``param_shardings``,
``data_sharding``, ``cache_pspec_for``, ``cache_shardings``) reads only
``mesh.shape`` and ``mesh.axis_names``, as the reference's does, so it
takes a ``GridMesh`` or any namespace with those two fields; placements are
plain tuples (``models.params``).  ``make_production_mesh`` builds the
reference's production grids, (data 16, model 16) or (pod 2, data 16,
model 16), on a world of 256 or 512 ranks.

Groups initialise from a ``FileStore`` path and bind no TCP port, so
parallel test workers never collide on one.  The backend is a statement of
the topology, never a fallback: 'nccl' when every rank has a card of its
own (collectives on CUDA tensors), 'gloo' when the ranks share one card
(NCCL refuses two ranks on one GPU) or run on the CPU (collectives on host
copies).

``run_ranks`` spawns one process per rank, runs a function in each and
hands the results back (given ``grid``, each rank gets its ``GridMesh``);
every wait has a deadline, so a hung rank fails the call instead of hanging
its caller.  ``prestart`` starts a call's processes ahead of it (each has
imported torch and made its device's context when the call comes), so a
caller can spend their start-up — seconds a process — on other work;
``release_prestarted`` stops the sets no call took.

A dry mesh (``dry_grid_mesh``, ``dry_production_mesh``, ``dry_mesh``;
backend 'dry') is one rank's view of a grid that joins no world: its
groups hold each subset's rank list and no process group, and the
collectives of ``train.sharding`` and ``core.distributed`` take fake
tensors on it, count their kind and return fake results.  The dry run
(``launch.dryrun``) traces rank 0's program on it at the production grid,
in one process.

    mesh = make_mesh(store_path, world_size=2, rank=r, backend="gloo")
    index.attach_mesh(mesh)          # then discover as usual, on every rank
    close_mesh(mesh)

    run_ranks(fn, 4, grid={"data": 2, "model": 2}, devices=["cpu"] * 4)
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch

from repro_torch.device import resolve_device
from repro_torch.models import params as P_

BACKENDS = ("gloo", "nccl")
DRY = "dry"  # the backend of a mesh that joins no world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a one-axis process-group mesh."""

    rank: int
    size: int
    backend: str  # 'gloo' | 'nccl' | 'dry'
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


def dry_mesh(size: int, rank: int = 0, device="cuda") -> Mesh:
    """Rank ``rank``'s view of a one-axis mesh of ``size`` ranks that joins
    no world (backend 'dry', no group): ``core.distributed``'s collectives
    take fake tensors on it and return fake results."""
    return Mesh(rank, size, DRY, torch.device(device), group=None)


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """One rank's view of a multi-axis process-group mesh.

    ``shape`` maps each axis name to its size, in grid order; ``groups``
    maps every subset of the axes (a tuple in grid order) to
    ``(process group, its ranks)``: the ranks that share this rank's
    coordinates on every other axis."""

    shape: dict
    rank: int
    backend: str  # 'gloo' | 'nccl' | 'dry'
    device: torch.device
    groups: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> dict:
        """This rank's coordinate on each axis (row-major rank order)."""
        return self.coords_of(self.rank)

    def coords_of(self, rank: int) -> dict:
        """Rank ``rank``'s coordinate on each axis."""
        out = {}
        for name in reversed(self.axis_names):
            out[name] = rank % self.shape[name]
            rank //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def _axes(self, axes) -> tuple:
        axes = axes if isinstance(axes, tuple) else (axes,)
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        """Ranks over ``axes`` (an axis name or a tuple of them; () is 1)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes, rank: int | None = None) -> int:
        """This rank's (or ``rank``'s) row-major index over ``axes``: its
        shard of a dim placed on them."""
        coords = self.coords_of(self.rank if rank is None else rank)
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group(self, axes):
        """The process group over ``axes`` that holds this rank."""
        return self.groups[self._axes(axes)][0]

    def group_ranks(self, axes) -> list[int]:
        """The global ranks of ``group(axes)``, in their group-rank order."""
        return self.groups[self._axes(axes)][1]


def grid_mesh(mesh: Mesh, shape: dict) -> GridMesh:
    """The ``GridMesh`` of ``shape`` over the initialised group of ``mesh``
    (whose size must be the product of ``shape``).  Every rank must call
    this, in the same order with the same shape: it makes one subgroup per
    coordinate line of every non-empty subset of the axes."""
    names = tuple(shape)
    sizes = [int(shape[a]) for a in names]
    if math.prod(sizes) != mesh.size:
        raise ValueError(f"mesh shape {dict(shape)} needs {math.prod(sizes)} ranks, the group has {mesh.size}")
    import torch.distributed as dist

    new_group = lambda ranks: dist.new_group(ranks) if len(ranks) < mesh.size else mesh.group  # noqa: E731
    groups = _grid_groups(names, sizes, mesh.rank, new_group)
    return GridMesh(dict(zip(names, sizes)), mesh.rank, mesh.backend, mesh.device, groups)


def _grid_groups(names: tuple, sizes: list, rank: int, new_group) -> dict:
    """{axis subset: (new_group(its ranks), its ranks)} for the coordinate
    lines that hold ``rank``; ``new_group`` is called for every line of
    every subset, in one order on every rank."""
    points = list(itertools.product(*(range(n) for n in sizes)))  # row-major: rank order
    mine = points[rank]
    groups = {}
    for k in range(1, len(names) + 1):
        for subset in itertools.combinations(range(len(names)), k):
            lines: dict = {}
            for r, pt in enumerate(points):
                lines.setdefault(tuple(c for i, c in enumerate(pt) if i not in subset), []).append(r)
            for fixed, ranks in lines.items():
                g = new_group(ranks)
                if fixed == tuple(c for i, c in enumerate(mine) if i not in subset):
                    groups[tuple(names[i] for i in subset)] = (g, ranks)
    return groups


def dry_grid_mesh(shape: dict, rank: int = 0, device="cuda") -> GridMesh:
    """Rank ``rank``'s ``GridMesh`` of ``shape`` that joins no world
    (backend 'dry'): each group is ``(None, its ranks)``, and nothing under
    it calls ``torch.distributed``."""
    names = tuple(shape)
    sizes = [int(shape[a]) for a in names]
    groups = _grid_groups(names, sizes, rank, lambda ranks: None)
    return GridMesh(dict(zip(names, sizes)), rank, DRY, torch.device(device), groups)


def production_shape(multi_pod: bool = False) -> dict:
    """The reference's production grid: (data 16, model 16), or (pod 2,
    data 16, model 16)."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def dry_production_mesh(multi_pod: bool = False, rank: int = 0, device="cuda") -> GridMesh:
    """``make_production_mesh``'s grid as a dry mesh: rank ``rank`` of 256
    (or 512) ranks, in one process."""
    return dry_grid_mesh(production_shape(multi_pod), rank, device)


# ---------------------------------------------------------------------------
# placement rules (the reference's; read only .shape and .axis_names)
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False, device=None) -> GridMesh:
    """The reference's production grid on the initialised default group:
    (data 16, model 16) on 256 ranks, or (pod 2, data 16, model 16) on 512.
    Raises unless the world has exactly that many ranks."""
    import torch.distributed as dist

    shape = production_shape(multi_pod)
    n = math.prod(shape.values())
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} production mesh needs a world"
                         f" of {n} ranks, this one has {world}")
    dev = resolve_device(device)
    base = Mesh(dist.get_rank(), world, dist.get_backend(), dev, group=dist.group.WORLD)
    return grid_mesh(base, shape)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def rules_for(mesh, fsdp: bool = True) -> dict:
    """Logical-axis → mesh-axis rules (params)."""
    rules = dict(P_.DEFAULT_RULES)
    rules["embed"] = batch_axes(mesh) if fsdp else None
    return rules


def param_shardings(specs, mesh, fsdp: bool = True):
    """Placements on ``mesh`` for a spec tree with divisibility fallback."""
    pspecs = P_.validate_divisibility(specs, mesh, rules_for(mesh, fsdp))
    return P_._map_tree(lambda p: P_.NamedSharding(mesh, p), pspecs)


def data_sharding(mesh) -> P_.NamedSharding:
    return P_.NamedSharding(mesh, (P_._norm_entry(batch_axes(mesh)),))


def _greedy_pspec(shape: tuple[int, ...], prefs: list[tuple[int, list]], mesh) -> tuple:
    """Assign mesh axes to dims greedily.

    prefs: [(dim, [axis-or-axistuple candidates in priority order]), ...].
    Each mesh axis is used at most once; a candidate applies only if the dim
    is divisible by the candidate's total size.
    """
    used: set[str] = set()
    out: list = [None] * len(shape)
    for dim, candidates in prefs:
        for cand in candidates:
            axes = cand if isinstance(cand, tuple) else (cand,)
            if not axes or any(a in used or a not in mesh.axis_names for a in axes):
                continue
            size = math.prod(mesh.shape[a] for a in axes)
            if size > 1 and shape[dim] % size == 0:
                out[dim] = P_._norm_entry(cand)
                used.update(axes)
                break
    return tuple(out)


def cache_pspec_for(path_key: str, shape: tuple[int, ...], mesh) -> tuple:
    """KV-cache / SSM-state placement by leaf name (leading dim = scan layers,
    replicated).

    Preferences encode the serving layouts:
      * batch over ('pod','data') when divisible (decode_32k);
      * KV heads over 'model' when divisible, else cache SEQUENCE over
        'model' (GQA with few KV heads: qwen3/danube/jamba);
      * batch=1 long-context (long_500k): sequence shards over ALL axes.
    """
    ba = batch_axes(mesh)
    all_ax = tuple(mesh.axis_names)
    if path_key in ("k", "v"):  # [L, B, slots, kv, hd]
        return _greedy_pspec(
            shape,
            [(1, [ba]), (3, ["model"]), (2, [all_ax, ("data", "model"), "model", ba])],
            mesh,
        )
    if path_key in ("ckv", "kr"):  # [L, B, S, r]
        return _greedy_pspec(
            shape, [(1, [ba]), (2, [all_ax, ("data", "model"), "model", ba])], mesh
        )
    if path_key == "h":  # [L, B, nh, ds, hd]
        return _greedy_pspec(shape, [(1, [ba]), (2, ["model"])], mesh)
    if path_key == "conv":  # [L, B, K-1, conv_dim]
        return _greedy_pspec(shape, [(1, [ba]), (3, ["model"])], mesh)
    if path_key == "pos":  # [L, B]
        return _greedy_pspec(shape, [(1, [ba])], mesh)
    if path_key == "slot_pos":  # [L, B, slots]
        return _greedy_pspec(
            shape, [(1, [ba]), (2, [all_ax, ("data", "model"), "model", ba])], mesh
        )
    return (None,) * len(shape)


def cache_shardings(cache, mesh):
    """Placements for a cache tree (tensors, meta tensors or anything with
    ``.shape``), by each leaf's own key."""
    def go(tree, key: str):
        if isinstance(tree, dict):
            return {k: go(v, k) for k, v in tree.items()}
        return P_.NamedSharding(mesh, cache_pspec_for(key, tuple(tree.shape), mesh))

    return go(cache, "")


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


def _rank_main(fn, rank, world_size, backend, device, store_path, args, results, timeout_s, grid):
    """One spawned rank: join the group, run ``fn(mesh, *args)`` (``mesh``
    this rank's ``GridMesh`` when ``grid`` is given), report ``(rank, ok,
    result or traceback)``."""
    try:
        mesh = make_mesh(store_path, world_size, rank, backend=backend, device=device,
                         timeout_s=timeout_s)
        try:
            out = fn(grid_mesh(mesh, grid) if grid else mesh, *args)
        finally:
            close_mesh(mesh)
        results.put((rank, True, out))
    except Exception:  # the boundary: the parent raises with this traceback
        results.put((rank, False, traceback.format_exc()))


# prestarted rank processes, by the ``run_ranks`` call they wait for:
# (world size, backend, devices, env) -> [(processes, job queues, results queue)]
_PRESTARTED: dict = {}


def _call_key(world_size: int, backend: str, devices: list, env: dict | None) -> tuple:
    return world_size, backend, tuple(devices), tuple(sorted((env or {}).items()))


def prestart(world_size: int, *, backend: str = "gloo", devices=None, env: dict | None = None) -> None:
    """Start the ``world_size`` rank processes of a later ``run_ranks``
    call with the same ``world_size``, ``backend``, ``devices`` and
    ``env`` now (``env`` added to this process's environment, restored
    once they have started): each imports torch and the port, makes its
    device's context and waits for the call's function.
    ``release_prestarted`` stops the sets no call took."""
    devices = rank_devices(world_size) if devices is None else [str(d) for d in devices]
    ctx = multiprocessing.get_context("spawn")
    results, jobs = ctx.Queue(), [ctx.Queue() for _ in range(world_size)]
    procs = [ctx.Process(target=_prestarted_main, args=(jobs[r], results, devices[r]), daemon=True)
             for r in range(world_size)]
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _PRESTARTED.setdefault(_call_key(world_size, backend, devices, env), []).append((procs, jobs, results))


def _prestarted_main(jobs, results, device: str) -> None:
    """A rank process: ready its device, then run the one job it is handed
    (``_rank_main``'s arguments but the device and the results queue), or
    exit on None."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the context, made now
    job = jobs.get()
    if job is not None:
        fn, rank, world_size, backend, store_path, args, timeout_s, grid = job
        _rank_main(fn, rank, world_size, backend, device, store_path, args, results, timeout_s, grid)


def release_prestarted() -> None:
    """Stop every prestarted set that no ``run_ranks`` call took."""
    sets = [s for waiting in _PRESTARTED.values() for s in waiting]
    _PRESTARTED.clear()
    for procs, jobs, results in sets:
        for q in jobs:
            q.put(None)
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()


def run_ranks(
    fn,
    world_size: int,
    *,
    backend: str = "gloo",
    devices=None,
    args: tuple = (),
    timeout_s: float = 120.0,
    grid: dict | None = None,
    env: dict | None = None,
) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned ranks and return
    their results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by import path), and so is each
    result.  ``devices`` gives each rank's device (default:
    ``rank_devices``, the cards round robin; raises without one).  With
    ``grid`` (axis name → size, product ``world_size``) each rank is handed
    its ``GridMesh`` instead of the one-axis ``Mesh``.  ``env``: environment
    variables the ranks' processes start with (this process's environment
    is restored once they have started).  The ranks are the processes
    ``prestart`` started for a call like this one, else a set it starts
    now.  Raises
    ``RuntimeError`` when a rank fails or dies, and
    ``TimeoutError`` when the ranks have not all reported within
    ``timeout_s``; every rank is stopped before this returns or raises.
    """
    devices = rank_devices(world_size) if devices is None else [str(d) for d in devices]
    key = _call_key(world_size, backend, devices, env)
    if not _PRESTARTED.get(key):
        prestart(world_size, backend=backend, devices=devices, env=env)
    procs, jobs, results = _PRESTARTED[key].pop(0)
    got: dict[int, object] = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        for r, q in enumerate(jobs):
            q.put((fn, r, world_size, backend, store, args, timeout_s, grid))
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
