"""Production-mesh dry run: trace rank 0's program of every (arch × shape ×
mesh) cell (port of ``repro.launch.dryrun``).

For each cell this writes ``results/dryrun_torch/<arch>__<shape>__<mesh>
[__<variant>].json`` with the reference's keys: memory, FLOPs and the
collectives by kind, per device — the inputs to ``benchmarks/roofline.py``
(``load_cells(out_dir=...)`` reads them unchanged).

The reference lowers and compiles each cell under GSPMD on 256 or 512
fake XLA devices.  The port has no compiler to ask: it runs rank 0's own
program — the one each rank of the production grid would run on its card
— once, under ``FakeTensorMode``, on a dry production mesh
(``launch.mesh.dry_production_mesh``: 16×16, or 2×16×16), in one process.
Every tensor is fake, so nothing is allocated and no kernel is built or
launched (each kernel's launch is an op with a shape rule); the entry point
needs no card.  The fake tensors live on the CUDA device where this
process has a card and on the CPU where it has none: the program, its
FLOPs, collectives and memory are the same (the kernel wrappers give any
fake tensor their kernels' shape rules, never a plain version).

  * ``train``: one ``train.step.make_train_step`` step — forward and
    backward with remat, each block's weights gathered inside the block,
    AdamW at the variant's ``state_dtype`` (int8 moments whole on every
    rank, as the reference places them) — on rank 0's parameter shards and
    its rows of the global batch;
  * ``prefill``: ``transformer.prefill`` of rank 0's rows (``max_seq`` =
    ``seq_len`` + 64, the reference's);
  * ``decode``: one ``transformer.decode_step`` on rank 0's shard of a
    cache of ``seq_len`` slots, the next token its argmax.

Rank 0's rows are its share of the global batch where the batch axes
divide it, else every row (the reference's replication: long_500k's batch
of 1, whose cache slots then split over every axis).

What a cell records:

  * ``memory_analysis``: ``argument_size_in_bytes``, the bytes of the
    distinct storages of rank 0's arguments (parameters, optimizer state,
    batch, cache); ``output_size_in_bytes``, the same for the outputs
    (parameters and moments updated in place, or the cache, count again);
    ``temp_size_in_bytes``, the peak of the bytes of the storages the call
    made and still held — the arguments excluded.  A dispatch mode adds
    each storage an op's output brings in (once per storage) and a
    ``weakref.finalize`` on that storage subtracts it when it dies;
  * ``cost_analysis.flops`` and ``hlo_cost``: ``launch.hlo_cost`` (every
    matrix product and B.6's SDPA formula);
  * ``collectives``: the reference's ``{kind: {count, bytes}}`` with
    ``total_bytes`` / ``total_count``, counted at the port's own collective
    calls (``train.sharding.KINDS``): FSDP's backward counts as
    'reduce-scatter', as in the reference's production HLO;
  * ``param_bytes_per_device``: the reference's formula on the placement
    tables (each leaf's bytes over the product of its axes' sizes), held
    equal to the bytes of the fake shards the cell traced;
  * ``kernel_launches``: the launches the kernel wrappers counted during the
    trace, 0 in every record, since the trace raises on any.

The variant's ``moe_impl``, ``moe_group``, ``seq_shard`` and
``remat_policy`` are set on the modules for the trace
(``models.moe.MOE_IMPL`` / ``MOE_GROUP_SIZE``, ``models.layers.SEQ_SHARD``,
``models.transformer.REMAT_POLICY``), as the reference sets them, and
whisper's frames and the VLM's patches are zero-filled inputs of rank 0's
rows, as the reference's ``_extra_input_sds``.

A cell that cannot run records ``error``: each variant field the port does
not honour (``check_variant``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a[,a2...]]
        [--shape s[,s2...]] [--multi-pod | --both-meshes]
        [--variant name --set k=v ...] [--force] [--out-dir D]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import hlo_cost, mesh as meshlib
from repro_torch.models import layers, moe, params as params_lib, transformer
from repro_torch.train import optimizer as opt, sharding, step as train_step_lib

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")

@dataclasses.dataclass
class Variant:
    name: str = "baseline"
    fsdp: bool = True
    remat: bool = True
    ce_chunk: int = 1024
    state_dtype: str = "bf16"
    mla_absorb: bool = False  # paper-faithful DeepSeek decode is naive
    flash_threshold: int = 8192
    moe_impl: str = "scatter"  # baseline; 'einsum' = grouped-dispatch opt
    moe_group: int = 256
    seq_shard: bool = False  # Megatron-SP residual stream
    remat_policy: str = "full"  # 'full' | 'dots' | 'none'

    @staticmethod
    def parse(name: str, sets: list[str]) -> "Variant":
        v = Variant(name=name)
        for kv in sets:
            k, val = kv.split("=", 1)
            cur = getattr(v, k)
            if isinstance(cur, bool):
                val = val.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                val = int(val)
            setattr(v, k, val)
        return v


def check_variant(variant: Variant) -> None:
    """Raise for a cell the port cannot trace: each variant field it does
    not honour."""
    if variant.remat_policy not in ("full", "dots", "none"):
        raise ValueError(f"remat_policy={variant.remat_policy!r}: 'full', 'dots' or 'none'")
    if variant.flash_threshold != Variant.flash_threshold:
        raise NotImplementedError("flash_threshold: the port runs kernel B.6 at every length")
    if variant.moe_impl not in ("einsum", "scatter"):
        raise ValueError(f"moe_impl={variant.moe_impl!r}: the port has 'einsum' and 'scatter'")


def trace_device() -> str:
    """Where the fake tensors live: the card's device when there is one."""
    return "cuda" if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------
# memory: the live storages of a call
# ---------------------------------------------------------------------------


def _tensors(tree) -> list:
    """The tensors of a tree of dicts (``MeshCache`` included), lists and
    tuples."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _storages(tree) -> dict:
    """{storage key: bytes} of the distinct storages of a tensor tree."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


class LiveStorages(TorchDispatchMode):
    """Counts the storages the ops of a call bring in: each new one's bytes
    are added once (``live``, its peak ``peak``), and subtracted by a
    ``weakref.finalize`` on the storage when it dies.  Storages known
    before the call (the arguments) are not counted."""

    def __init__(self, known=()):
        super().__init__()
        self.known = set(known)
        self.live = self.peak = 0

    def _free(self, key, nbytes: int) -> None:
        self.live -= nbytes
        self.known.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known:
                continue
            self.known.add(key)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, st.nbytes())
        return out


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def param_bytes_formula(specs, place, mesh) -> int:
    """The reference's per-device parameter bytes: each leaf's bf16 bytes
    over the product of the sizes of the axes its placement names."""
    total = 0

    def go(spec, pl):
        nonlocal total
        if isinstance(spec, dict):
            for k in spec:
                go(spec[k], pl[k])
            return
        n = 2
        for d in spec.shape:
            n *= d
        denom = 1
        for entry in pl:
            if entry is not None:
                denom *= mesh.axis_size(entry)
        total += n // denom

    go(specs, place)
    return total


def _collectives(hc: dict) -> dict:
    out = {k: {"count": int(hc["collective_counts"][k]), "bytes": int(hc["collective_bytes"][k])}
           for k in hlo_cost.COLL_KINDS}
    kinds = list(out.values())
    out["total_bytes"] = sum(v["bytes"] for v in kinds)
    out["total_count"] = sum(v["count"] for v in kinds)
    return out


def program(cfg, shape, variant: Variant, mesh, place, dev):
    """(fn, its arguments) of a cell's program on this rank of ``mesh``,
    with activation sharding on over it (this rank's rows are
    ``layers.local_rows``'): zero-filled arguments (fake ones under ``FakeTensorMode``; real ones
    run the same program, as the tests do on gloo ranks).  ``fn`` runs
    under the variant's module switches (``module_flags``)."""
    fn, args = _program(cfg, shape, variant, mesh, place, dev)

    def run(*a):
        with module_flags(variant):
            return fn(*a)

    return run, args


@contextlib.contextmanager
def module_flags(variant: Variant):
    """While active, the models run by the variant's module switches:
    ``models.moe``'s dispatch rule and group size, ``models.layers``'
    sequence parallelism and ``models.transformer``'s remat policy (the
    reference's ``MOE_IMPL`` / ``MOE_GROUP_SIZE``, ``SEQ_SHARD``,
    ``REMAT_POLICY``)."""
    saved = moe.MOE_IMPL, moe.MOE_GROUP_SIZE, layers.SEQ_SHARD, transformer.REMAT_POLICY
    moe.MOE_IMPL, moe.MOE_GROUP_SIZE = variant.moe_impl, variant.moe_group
    layers.SEQ_SHARD, transformer.REMAT_POLICY = variant.seq_shard, variant.remat_policy
    try:
        yield
    finally:
        moe.MOE_IMPL, moe.MOE_GROUP_SIZE, layers.SEQ_SHARD, transformer.REMAT_POLICY = saved


def _program(cfg, shape, variant: Variant, mesh, place, dev):
    specs = transformer.model_specs(cfg)
    full = params_lib._map_tree(lambda s: torch.zeros(s.shape, dtype=torch.bfloat16, device=dev), specs)
    params = sharding.local_tree(full, place, mesh)
    del full
    b, s = shape.global_batch, shape.seq_len
    lo, hi = layers.local_rows(b)
    rows = hi - lo
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = torch.zeros(rows, cfg.encoder.n_frames, cfg.d_model, dtype=torch.bfloat16, device=dev)
    if cfg.vision is not None:
        extra["patches"] = torch.zeros(rows, cfg.vision.n_tokens, cfg.d_model, dtype=torch.bfloat16, device=dev)
    if shape.kind == "train":
        tcfg = train_step_lib.TrainConfig(adamw=opt.AdamWConfig(state_dtype=variant.state_dtype),
                                          remat=variant.remat, ce_chunk=variant.ce_chunk)
        state = opt.init_state(params, tcfg.adamw, mesh, place)
        batch = {"tokens": torch.zeros(rows, s, dtype=torch.long, device=dev),
                 "labels": torch.zeros(rows, s, dtype=torch.long, device=dev), **extra}
        step = train_step_lib.make_train_step(cfg, tcfg, mesh, place)
        return step, (params, state, batch)
    if shape.kind == "prefill":
        tokens = torch.zeros(rows, s, dtype=torch.long, device=dev)

        def prefill(params, tokens, extra):
            with torch.no_grad():
                return transformer.prefill(params, cfg, tokens, s + 64, batch=b, **extra)

        return prefill, (params, tokens, extra)
    cache = transformer.init_cache(cfg, b, s, enc_len=transformer._enc_len(cfg), device=dev)
    token = torch.zeros(rows, dtype=torch.long, device=dev)

    def decode(params, cache, token):
        with torch.no_grad():
            logits, cache = transformer.decode_step(params, cfg, token, cache)
            return logits.argmax(dim=-1), cache

    return decode, (params, cache, token)


def placement(cfg, mesh, fsdp: bool = True) -> dict:
    """The parameters' placements on ``mesh`` (the reference's rules)."""
    return params_lib.validate_divisibility(transformer.model_specs(cfg), mesh, meshlib.rules_for(mesh, fsdp))


def param_bytes(cfg, mesh, fsdp: bool = True) -> tuple[int, int]:
    """(the reference's formula on the placement tables, the bytes of this
    rank's fake bf16 shards) per device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    specs, place = transformer.model_specs(cfg), placement(cfg, mesh, fsdp)
    with FakeTensorMode():
        full = params_lib._map_tree(lambda s: torch.empty(s.shape, dtype=torch.bfloat16, device=mesh.device),
                                    specs)
        traced = sum(_storages(sharding.local_tree(full, place, mesh)).values())
    return param_bytes_formula(specs, place, mesh), traced


def kernel_counts() -> dict[str, int]:
    """The launches each kernel wrapper has counted in this process."""
    from repro_torch.kernels import filter_kernel as fk, flash_kernel as flk, xash_kernel as xk

    return {f.__name__: f.launches for f in (fk.filter_table_counts, fk.gather_filter_table_counts,
                                             fk.filter_match, fk.filter_count, xk.xash_superkey,
                                             flk.flash_attention)}


def kernel_launches() -> int:
    """The launches every kernel wrapper has counted in this process."""
    return sum(kernel_counts().values())


@contextlib.contextmanager
def no_launch():
    """Yield a dict whose 'launches' is set, on leaving, to the launches
    counted inside; raise if there were any: a dry trace launches
    nothing."""
    before, seen = kernel_launches(), {}
    yield seen
    seen["launches"] = kernel_launches() - before
    if seen["launches"]:
        raise AssertionError(f"a dry trace launched {seen['launches']} kernels")


def trace_program(cfg, shape, variant: Variant, mesh) -> dict:
    """Trace ``cfg``'s ``shape`` program on this rank of the dry ``mesh``
    under ``FakeTensorMode``: ``memory_analysis``, ``hlo_cost``, the trace's
    seconds and the bytes of the traced parameter shards.  Raises if a
    kernel launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    place = placement(cfg, mesh, variant.fsdp)
    layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
    try:
        with no_launch() as seen, FakeTensorMode():
            fn, args = program(cfg, shape, variant, mesh, place, mesh.device)
            arg_st = _storages(args)
            traced_param_bytes = sum(_storages(args[0]).values())
            t0 = time.time()
            with LiveStorages(arg_st) as live:
                out, hc = hlo_cost.measure(fn, *args)
            seconds = time.time() - t0
            out_st = _storages(out)
    finally:
        layers.disable_activation_sharding()
    return {
        "memory_analysis": {
            "argument_size_in_bytes": int(sum(arg_st.values())),
            "output_size_in_bytes": int(sum(out_st.values())),
            "temp_size_in_bytes": int(live.peak),
        },
        "hlo_cost": hc,
        "seconds": seconds,
        "param_bytes_traced": int(traced_param_bytes),
        "kernel_launches": seen["launches"],
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool, variant: Variant) -> dict:
    """Trace one cell (module docstring) and return its record."""
    cfg = dataclasses.replace(configs.get_config(arch), mla_absorb=variant.mla_absorb)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"skipped": True, "reason": reason}
    mesh = meshlib.dry_production_mesh(multi_pod=multi_pod, device=trace_device())
    check_variant(variant)
    got = trace_program(cfg, shape, variant, mesh)
    pbytes = param_bytes_formula(transformer.model_specs(cfg), placement(cfg, mesh, variant.fsdp), mesh)
    if pbytes != got["param_bytes_traced"]:
        raise AssertionError(f"param bytes per device: the placement tables give {pbytes}, the traced"
                             f" shards hold {got['param_bytes_traced']}")
    hc = got["hlo_cost"]
    pc = cfg.params_count()
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": mesh.size,
        "variant": dataclasses.asdict(variant),
        "compile_seconds": round(got["seconds"], 1),
        "memory_analysis": got["memory_analysis"],
        "cost_analysis": {"flops": hc["flops"]},
        "collectives": _collectives(hc),
        "hlo_cost": hc,
        "param_bytes_per_device": pbytes,
        "param_bytes_per_device_traced": got["param_bytes_traced"],
        "params_total": pc["total"],
        "params_active": pc["active"],
        "kind": shape.kind,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "trace_device": str(mesh.device),
        "kernel_launches": got["kernel_launches"],
    }


def cell_filename(arch, shape, multi_pod, variant_name):
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    suffix = "" if variant_name == "baseline" else f"__{variant_name}"
    return f"{arch}__{shape}__{mesh_tag}{suffix}.json"


def run_cell(arch: str, shape: str, multi_pod: bool, variant: Variant) -> dict:
    """``lower_cell`` with the reference's ``error`` record for a cell that
    fails, and ``wall_seconds``."""
    t0 = time.time()
    try:
        rec = lower_cell(arch, shape, multi_pod, variant)
    except Exception:
        rec = {"error": traceback.format_exc()}
    rec["wall_seconds"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--set", action="append", default=[], dest="sets")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    out_dir = args.out_dir or os.path.abspath(RESULTS_DIR)
    os.makedirs(out_dir, exist_ok=True)
    variant = Variant.parse(args.variant, args.sets)

    archs = args.arch.split(",") if args.arch else list(configs.ARCHS)
    shapes = args.shape.split(",") if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                fname = cell_filename(arch, shape, mp, variant.name)
                path = os.path.join(out_dir, fname)
                if os.path.exists(path) and not args.force:
                    print(f"[skip cached] {fname}")
                    continue
                print(f"[lower] {fname} ...", flush=True)
                rec = run_cell(arch, shape, mp, variant)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = (
                    "SKIP(" + rec.get("reason", "")[:40] + ")"
                    if rec.get("skipped")
                    else ("ERROR" if "error" in rec else "ok")
                )
                print(f"  -> {status} in {rec['wall_seconds']}s", flush=True)
                if "error" in rec:
                    print(rec["error"].splitlines()[-1], flush=True)
                if rec.get("memory_analysis"):
                    print(f"  mem: {rec['memory_analysis']}", flush=True)
                if rec.get("cost_analysis"):
                    print(f"  flops/device: {rec['cost_analysis'].get('flops')}", flush=True)
                coll = rec.get("collectives")
                if coll:
                    print(f"  collectives: {coll['total_count']} ops, {coll['total_bytes']/1e6:.1f} MB", flush=True)


if __name__ == "__main__":
    main()
