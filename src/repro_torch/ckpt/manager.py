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
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def leaves_with_paths(tree, path: str = ""):
    """(keystr path, leaf) pairs, dict keys in sorted order."""
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

    def save(self, step: int, tree) -> str:
        final = os.path.join(self.dir, f"step_{step:06d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
            t = torch.as_tensor(leaf).detach().cpu()
            fname = f"arr_{i:05d}.npy"
            if t.dtype == torch.bfloat16:  # raw bytes, as the reference's ml_dtypes leaves
                t = t.contiguous().view(torch.uint8)
            np.save(os.path.join(tmp, fname), t.numpy())
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(leaf.shape), "dtype": _dtype_name(leaf)}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):  # idempotent re-save of the same step
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
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

    def restore(self, step: int, like):
        """Restore into the structure of ``like``, each leaf on the device of
        ``like``'s leaf at the same path, in the dtype it was saved in."""
        path = os.path.join(self.dir, f"step_{step:06d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}

        def load(kpath: str, leaf):
            entry = by_path[kpath]
            t = torch.from_numpy(np.load(os.path.join(path, entry["file"])))
            if entry["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16).reshape(entry["shape"])
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
