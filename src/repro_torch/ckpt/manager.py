"""Fault-tolerant checkpointing: atomic, keep-K, preemption-safe (port of
``repro.ckpt.manager``).

Layout (one directory per step), the reference's::

    <dir>/step_000123.tmp/   → written, the manifest fsynced, then
    <dir>/step_000123/         atomically renamed
        manifest.json        (step; per leaf: path, file, shape, dtype)
        arr_00000.npy ...    (one file per leaf, the FULL array)

Trees are nested dicts of tensors.  Leaves are written in the reference's
order (dict keys sorted) under the reference's path strings
(``jax.tree_util.keystr``: ``['opt']['m']['embed']``); a bfloat16 leaf,
which numpy cannot hold, is written as its raw bytes (``uint8``, last dim
doubled) with ``bfloat16`` as its manifest dtype, as the reference writes
its ``ml_dtypes`` leaves.  So a checkpoint written by either package
restores in the other.  Restore reads each leaf by path into the structure
of ``like``, on the device of ``like``'s leaf.  A SIGTERM handler sets
``preempted`` so the caller saves before it exits; ``keep`` bounds disk.

Over a mesh (``mesh`` a ``GridMesh``, ``placement`` the tree's placements)
every rank calls ``save`` and ``restore``: save gathers each leaf to the
FULL array on rank 0 (``train.sharding.gather_to_root``), which writes it,
so the format, and restoring across the two packages, do not change;
restore maps each full array and reads only this rank's shard of it
(``train.sharding.shard_index``) — the reference's elastic restore onto
whatever mesh the run has now.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal

import numpy as np
import torch

from repro_torch.train import sharding

_STEP_RE = re.compile(r"^step_(\d+)$")


def leaves_with_paths(tree, path: str = ""):
    """(keystr path, leaf) pairs, dict keys in sorted order (a placement
    tuple is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_paths(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self.preempted = False
        os.makedirs(directory, exist_ok=True)

    def install_preemption_handler(self):
        def _handler(signum, frame):
            self.preempted = True

        signal.signal(signal.SIGTERM, _handler)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, *, placement=None, mesh=None) -> str:
        """Write ``tree`` as step ``step``.  With ``mesh``: every rank calls
        this with its shards and ``placement``; rank 0 writes the full
        arrays, and every rank returns once they are published."""
        final = os.path.join(self.dir, f"step_{step:06d}")
        tmp = final + ".tmp"
        writer = mesh is None or mesh.rank == 0
        if writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        specs = dict(leaves_with_paths(placement)) if mesh is not None else {}
        manifest = {"step": step, "leaves": []}
        for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
            if mesh is not None:
                leaf = sharding.gather_to_root(leaf, specs[path], mesh)
            if not writer:
                continue
            t = torch.as_tensor(leaf).detach().cpu()
            fname = f"arr_{i:05d}.npy"
            if t.dtype == torch.bfloat16:  # raw bytes, as the reference's ml_dtypes leaves
                t = t.contiguous().view(torch.uint8)
            np.save(os.path.join(tmp, fname), t.numpy())
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(leaf.shape), "dtype": _dtype_name(leaf)}
            )
        if writer:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):  # idempotent re-save of the same step
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()
        if mesh is not None:  # no rank reads the directory before rank 0 has published
            sharding.all_reduce(torch.zeros(1), mesh, tuple(mesh.axis_names))
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:06d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, *, placement=None, mesh=None):
        """Restore into the structure of ``like``, each leaf on the device of
        ``like``'s leaf at the same path, in the dtype it was saved in.  With
        ``mesh``: each leaf is this rank's shard under ``placement``."""
        specs = dict(leaves_with_paths(placement)) if mesh is not None else {}
        path = os.path.join(self.dir, f"step_{step:06d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}

        def load(kpath: str, leaf):
            entry = by_path[kpath]
            a = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
            bf16 = entry["dtype"] == "bfloat16"
            shape = entry["shape"]
            if mesh is not None:  # this rank's shard only (a bf16 leaf's last dim is 2 bytes a value)
                idx = sharding.shard_index(shape, specs[kpath], mesh)
                shape = [len(range(n)[i]) for n, i in zip(shape, idx)]
                if bf16 and idx:
                    last = idx[-1]
                    idx = idx[:-1] + (slice(None) if last.start is None else slice(2 * last.start, 2 * last.stop),)
                a = a[idx]
            t = torch.from_numpy(np.array(a))
            if bf16:
                t = t.view(torch.bfloat16).reshape(shape)
            elif _dtype_name(t) != entry["dtype"]:
                raise ValueError(f"{kpath}: saved as {t.dtype}, manifest says {entry['dtype']}")
            return t.to(torch.as_tensor(leaf).device)

        def build(tree, kpath: str = ""):
            if isinstance(tree, dict):
                return {k: build(tree[k], f"{kpath}[{k!r}]") for k in tree}
            return load(kpath, tree)

        return build(like)

    def restore_latest(self, like):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like)
