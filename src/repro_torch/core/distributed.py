"""Distributed MATE discovery: the corpus sharded over a process group.

Port of ``repro.core.distributed``.  In PyTorch a one-axis mesh is a process
group with one rank per shard (``launch.mesh.Mesh``): every rank runs the
same host program on the same inputs — the reference's replicated SPMD
inputs — and works on its own block of rows only.  The reference's
in-program ``psum`` becomes a ``torch.distributed`` all-reduce (SUM) between
the ranks, outside the kernels.  Collectives run where the data lies: on the
card under NCCL (every rank has a card of its own), on host copies under
gloo (ranks that share one card, and the CPU tests).

Both halves of the system shard the same way.  The ONLINE row filter is
embarrassingly parallel over candidate rows; the OFFLINE build
(``core.index.build_index``) over unique values (hashing) and corpus rows
(super keys, posting lists).  The shard helpers at the bottom
(``shard_bounds``, ``mesh_shards``, ``pad_rows_to_shards``,
``shard_corpus_rows``) are the shared vocabulary: contiguous balanced
row/value blocks, padded to the group where device work needs equal shards.
A one-axis group's shard count is ``mesh.size``.  The row filter also runs
on a multi-axis ``launch.mesh.GridMesh``: its rows split over the named
``row_axes`` (the reference's ``('data',)``) and replicated over the
others, the counts all-reduced over ``row_axes`` only.

The per-shard filter bodies:

  * ``filter_counts_local`` / ``filter_counts_local_blocked`` — the
    reference's XLA bodies as plain torch ops on the shard's device (the
    broadcast baseline and the lane-unrolled row-blocked stream);
  * ``filter_counts_local_fused`` — kernel B.1 (``filter_table_counts``) in
    ``mode='any'``, one launch per shard; above its 8192-table cap the
    shard's counts come from kernel B.4 (the match matrix) and a torch
    ``index_add_`` (ROADMAP C.11), bit-identical.

The routed lake's mesh mode (``routed_filter_counts_mesh``): each rank
launches against ITS OWN shard's store only, and the counts vectors are
all-reduced — superkey rows never leave their shard.  A kernel failure on a
CUDA tensor raises; nothing here retries on another body.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from repro_torch.core.xash import subsumes
from repro_torch.kernels import filter_kernel, registry
from repro_torch.kernels.registry import Backend

_LOG = logging.getLogger(__name__)

# The name of the group's one axis, as the reference's one-axis meshes name
# theirs: ``BuildStats.mesh_shape`` and the error messages carry it.
MESH_AXES = ("data",)


def filter_counts_local(
    superkeys: torch.Tensor,  # int32[rows_local, lanes] (uint32 bit patterns)
    row_tables: torch.Tensor,  # int32[rows_local] (-1 for padding rows)
    query_sks: torch.Tensor,  # int32[n_keys, lanes]
    n_tables: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-table (rows with ≥ 1 hit) and per-key candidate counts for a
    local row shard: (int32[n_tables], int32[n_keys])."""
    match = subsumes(query_sks[None], superkeys[:, None])  # [rows, keys]
    match &= (row_tables >= 0)[:, None]
    return _any_counts(match, row_tables, n_tables)


def _any_counts(match: torch.Tensor, row_tables: torch.Tensor, n_tables: int):
    """The 'any' reduction of a valid-masked match matrix: per-table rows
    matching ≥ 1 key, per-key matching rows."""
    per_row = match.any(dim=1).to(torch.int32)
    table_counts = torch.zeros(n_tables, dtype=torch.int32, device=match.device)
    table_counts.index_add_(0, row_tables.clamp(min=0).long(), per_row)
    return table_counts, match.sum(dim=0, dtype=torch.int32)


def filter_counts_local_blocked(
    superkeys: torch.Tensor,
    row_tables: torch.Tensor,
    query_sks: torch.Tensor,
    n_tables: int,
    row_block: int = 1 << 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Memory-optimised probe: lane-unrolled (never materialises the
    [rows, keys, lanes] conflict tensor — peak is [block, keys] bool) and
    row-blocked, so the super keys stream through once."""
    dev = superkeys.device
    table_counts = torch.zeros(n_tables, dtype=torch.int32, device=dev)
    key_counts = torch.zeros(query_sks.shape[0], dtype=torch.int32, device=dev)
    for s in range(0, superkeys.shape[0], row_block):
        skb, rtb = superkeys[s : s + row_block], row_tables[s : s + row_block]
        ok = (rtb >= 0)[:, None]
        for lane in range(superkeys.shape[1]):
            ok = ok & ((query_sks[None, :, lane] & ~skb[:, lane : lane + 1]) == 0)
        tc, kc = _any_counts(ok, rtb, n_tables)
        table_counts += tc
        key_counts += kc
    return table_counts, key_counts


def filter_counts_local_fused(
    superkeys: torch.Tensor,
    row_tables: torch.Tensor,
    query_sks: torch.Tensor,
    n_tables: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel probe: the per-shard filter is ONE kernel B.1 launch in
    ``mode='any'`` — subsumption, the per-row any-reduction and the table-id
    scatter happen in the kernel, and only the two counts vectors leave it.
    Padding rows carry ``row_tables == -1`` (the kernel's own padding
    convention).  Above the kernel's table cap (its shared-memory histogram)
    the shard runs kernel B.4 and reduces the matrix with torch ops (ROADMAP
    C.11; the reference runs its lane-unrolled XLA body there)."""
    row_tables = row_tables.to(torch.int32)
    if n_tables > filter_kernel.FUSED_MAX_TABLES:
        match = filter_kernel.filter_match(superkeys, query_sks).view(torch.bool)
        return _any_counts(match & (row_tables >= 0)[:, None], row_tables, n_tables)
    return filter_kernel.filter_table_counts(
        superkeys, query_sks, None, row_tables, n_tables=n_tables, mode="any"
    )


_FILTER_IMPLS = {
    "broadcast": filter_counts_local,
    "blocked": filter_counts_local_blocked,
    "fused": filter_counts_local_fused,
}


def shard_impl_for(
    backend: Backend | str | None, stats=None, platform: str | None = None
) -> str:
    """Map a resolved filter ``Backend`` onto a per-shard impl name.

    A shard-impl name ('broadcast' | 'blocked' | 'fused') passes through
    directly; a registry backend maps 'fused' -> the fused per-shard launch
    and every composed/host backend -> the broadcast baseline.  None follows
    the registry precedence on ``platform`` ('cuda' | 'cpu'; None asks
    whether this process has a card).

    A 'fused-gather' backend DEMOTES to the fused shard impl here — and says
    so: this row-filter API receives pre-gathered, pre-sharded superkey
    blocks, so there is no posting-list gather left to fuse.  The demotion
    is debug-logged and counted on ``stats`` (a ``DiscoveryStats``) when one
    is passed; the path that runs gather-fused WITHOUT demotion is the
    routed index (``core.routing.ShardedMateIndex``).
    """
    if isinstance(backend, str) and backend in _FILTER_IMPLS:
        return backend
    bk = registry.resolve_backend(backend, platform)
    if bk.gather:
        _LOG.debug(
            "shard_impl_for: demoting %r to the 'fused' shard impl — the"
            " mesh row filter takes pre-gathered superkey shards (use a"
            " routed ShardedMateIndex for shard-local gather-fused launches)",
            bk.name,
        )
        if stats is not None:
            stats.shard_gather_demotions += 1
        return "fused"
    return "fused" if bk.fused else "broadcast"


def make_distributed_filter(
    mesh,
    n_tables: int,
    row_axes: tuple[str, ...] = MESH_AXES,
    backend: Backend | str | None = None,
):
    """``(superkeys, row_tables, query_sks) -> (table_counts, key_counts)``
    over ``mesh``: each rank passes its own row block (``shard_corpus_rows``
    over the same ``row_axes``) and the replicated query super keys, runs
    the shard impl on its device, and gets the int32 counts all-reduced
    over ``row_axes`` back on that device: on a ``GridMesh`` every replica
    over the other axes gets the same counts.

    ``backend`` is a resolved registry ``Backend``, a registered backend
    name, or a shard-impl name: 'broadcast' (baseline) | 'blocked'
    (lane-unrolled streaming) | 'fused' (one kernel B.1 launch per shard).
    None resolves through the registry on the rank's device type.
    """
    local = _FILTER_IMPLS[shard_impl_for(backend, platform=mesh.device.type)]

    def run(superkeys, row_tables, query_sks):
        tc, kc = local(superkeys, row_tables, query_sks, n_tables)
        return all_reduce_sum(tc, mesh, row_axes), all_reduce_sum(kc, mesh, row_axes)

    return run


# ---------------------------------------------------------------------------
# Routed-index mesh filter (core.routing.ShardedMateIndex, mesh mode)
# ---------------------------------------------------------------------------


def routed_filter_counts_mesh(
    index,
    rows: np.ndarray,
    query_sk: np.ndarray,
    elig: np.ndarray,
    seg_ids: np.ndarray,
    n_tables: int,
    backend: Backend | str | None = None,
    fused_block_n: int | None = None,
) -> tuple[np.ndarray, bool]:
    """The routed filter over ``index``'s attached group: this rank runs ITS
    shard's launch (``ShardedMateIndex._shard_counts``: kernel B.2 against
    the rank's own device store under the gather backends) over the batch's
    items it owns, and the counts vectors are all-reduced.

    Every rank must call with the same batch (the host planning is
    replicated, as the reference's SPMD inputs are).  Returns
    ``(counts, demoted)``: ``counts`` int32[n_tables] bit-identical to the
    host-routed (and single-host) counts; ``demoted`` True when a
    fused/gather backend's batch was past the fused kernels' table cap, the
    reference's count of a shard body that did not run fused.
    """
    from repro_torch.kernels import ops

    bk = registry.resolve_backend(backend, index.device.type)
    mesh = index._mesh
    rows = np.asarray(rows, dtype=np.int64)
    counts = np.zeros(n_tables, dtype=np.int32)
    mine = index._shard_ids_of_rows(rows) == mesh.rank
    if mine.any():
        shard = index.shards[mesh.rank]
        counts = index._shard_counts(
            shard, rows[mine] - shard.row_lo, query_sk, elig[mine],
            np.asarray(seg_ids)[mine], n_tables, bk, fused_block_n, None,
        )
    counts = all_reduce_sum(torch.from_numpy(counts), mesh).numpy()
    fused_capable = bk.fused or bk.gather
    return counts, fused_capable and n_tables > ops._FUSED_MAX_TABLES


# ---------------------------------------------------------------------------
# Collectives: on the card under NCCL, on host copies under gloo, none on a
# dry mesh (``launch.mesh.dry_mesh``: fake tensors in, fake results out)
# ---------------------------------------------------------------------------


def _dry(t: torch.Tensor, mesh, kind: str, nbytes: int) -> bool:
    """Count the collective by kind (``train.sharding.KINDS``); True when
    ``mesh`` is a dry mesh, which runs none (``t`` must then be fake)."""
    from repro_torch.train import sharding

    sharding.record_kind(kind, nbytes)
    return sharding.dry(mesh, t)


def _collective_input(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` where ``mesh``'s backend reduces it: the rank's card for NCCL,
    the host for gloo."""
    if mesh.backend == "nccl":
        return t.to(mesh.device).contiguous()
    return t.cpu().contiguous()


def all_reduce_sum(t: torch.Tensor, mesh, axes: tuple[str, ...] = MESH_AXES) -> torch.Tensor:
    """Element-wise SUM over the group's ranks (over ``axes`` of a
    ``GridMesh``), returned on ``t``'s device (the reference's ``psum``)."""
    import torch.distributed as dist

    if _dry(t, mesh, "all-reduce", t.numel() * t.element_size()):
        return t.new_empty(t.shape)
    buf = _collective_input(t, mesh)
    if buf is t:
        buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=_row_shards(mesh, axes)[2])
    return buf.to(t.device)


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's equal-shaped block, concatenated along dim 0 in rank
    order, returned on ``t``'s device."""
    import torch.distributed as dist

    if _dry(t, mesh, "all-gather", mesh.size * t.numel() * t.element_size()):
        return t.new_empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
    buf = _collective_input(t, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(t.device)


# ---------------------------------------------------------------------------
# Shard helpers shared by the online filter and the offline index build
# ---------------------------------------------------------------------------


def mesh_shards(mesh, n_shards: int | None) -> int:
    """The shard count of a build's ``mesh`` (0 without one).  An
    ``n_shards`` that differs from the group size raises ``ValueError``,
    word for word the reference's."""
    if mesh is None:
        return 0
    if n_shards is not None and n_shards != mesh.size:
        raise ValueError(
            f"n_shards={n_shards} conflicts with mesh shard count "
            f"{mesh.size} over axes {MESH_AXES}"
        )
    return mesh.size


def shard_bounds(n: int, n_shards: int) -> np.ndarray:
    """int64[n_shards+1] contiguous balanced shard boundaries over ``n``
    items: shard ``i`` covers ``[bounds[i], bounds[i+1])``.

    Prefix shards take ``ceil(n / n_shards)`` items, trailing shards may be
    short or empty — the same contiguous-ascending layout an equal-size
    padded partition induces, which is what makes the offline build's
    shard-merge order-preserving.
    """
    size = -(-n // n_shards) if n else 0
    return np.minimum(
        np.arange(n_shards + 1, dtype=np.int64) * size, np.int64(n)
    )


def pad_rows_to_shards(x: np.ndarray, n_shards: int, value=0) -> np.ndarray:
    """Pad the leading dim up to an equal-shard multiple (≥ 1 row/shard)."""
    n = x.shape[0]
    target = max(-(-n // n_shards) * n_shards, n_shards)
    if target == n:
        return x
    pads = [(0, 0)] * x.ndim
    pads[0] = (0, target - n)
    return np.pad(x, pads, constant_values=value)


def _row_shards(mesh, row_axes: tuple[str, ...]) -> tuple:
    """(shards, this rank's shard, the process group over them) of rows
    split over ``row_axes``: a ``GridMesh``'s axes by name; a one-axis
    group's only axis is ``MESH_AXES``."""
    if hasattr(mesh, "axis_size"):  # a GridMesh
        if not set(row_axes) <= set(mesh.axis_names):
            raise ValueError(f"row axes {row_axes} are not all axes of the mesh {mesh.shape}")
        return mesh.axis_size(row_axes), mesh.axis_index(row_axes), mesh.group(row_axes)
    if tuple(row_axes) != MESH_AXES:
        raise ValueError(f"a one-axis group's axis is {MESH_AXES}, not {row_axes}")
    return mesh.size, mesh.rank, mesh.group


def shard_corpus_rows(
    superkeys: np.ndarray,
    row_tables: np.ndarray,
    mesh,
    row_axes: tuple[str, ...] = MESH_AXES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of the padded corpus rows, on its device: int32
    super keys (uint32 bit patterns) and int32 row→table ids (-1 pads).
    The blocks split over ``row_axes`` (on a ``GridMesh``, replicated over
    its other axes).

    Re-invoking with another group is the elastic-scaling path: the blocks
    are cut again from the host copy.
    """
    from repro_torch.core.xash import lanes_to_torch

    n_shards, shard, _group = _row_shards(mesh, row_axes)
    sk = pad_rows_to_shards(np.asarray(superkeys, dtype=np.uint32), n_shards)
    rt = pad_rows_to_shards(np.asarray(row_tables, dtype=np.int32), n_shards, value=-1)
    per = sk.shape[0] // n_shards
    lo, hi = shard * per, (shard + 1) * per
    return (
        lanes_to_torch(sk[lo:hi], mesh.device),
        torch.from_numpy(np.ascontiguousarray(rt[lo:hi])).to(mesh.device),
    )
