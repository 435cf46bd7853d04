"""The rank side of the port's mesh-training tests (``test_torch_train_mesh.py``,
``test_torch_pipeline.py``): run by every spawned rank of a gloo group
(``repro_torch.launch.mesh.run_ranks``), it drives the port on the CPU and
hands plain results back.  Imports the port only, so a rank starts without
JAX.

``float32()`` makes the port's training float32 end to end in this process:
weights drawn in float32 and the embedding's and the encoder's bf16
activation casts made float32 ones, as the parity tests patch each
package's casts.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def float32() -> None:
    from repro_torch.models import params, transformer

    params.materialize.__defaults__ = (0, torch.float32, None)
    transformer._embed.__defaults__ = (torch.float32,)
    transformer._encode.__defaults__ = (torch.float32,)


def conditioned(specs, tree) -> None:
    """Rescale, in place, every attention projection of ``tree`` (a leaf
    whose spec has a heads axis) from the init rule's 1/sqrt(shape[-2]) to
    1/sqrt(its input width) — ``test_torch_families._conditioned``'s rule:
    the reduced configs are chaotic on the init rule's own draw (ROADMAP
    C.17), and float32 rounding alone then moves a gradient by 1e-5."""
    if isinstance(specs, dict):
        for k in specs:
            conditioned(specs[k], tree[k])
        return
    if specs.init != "normal" or not {"heads", "kv_heads"} & set(specs.axes):
        return
    dims = [(ax, n) for ax, n in zip(specs.axes, specs.shape) if ax not in ("layers", "experts")]
    fan_in = dims[0][1] * dims[1][1] if dims[0][0] in ("heads", "kv_heads") else dims[0][1]
    tree.mul_(float(np.sqrt(specs.shape[-2] / fan_in)))


def write_start(ckpt_dir: str, argd: dict) -> None:
    """A step-0 checkpoint of ``launch.train``'s own float32 draw for these
    arguments, attention projections rescaled (``conditioned``), with a
    fresh optimizer state: the start every run of a comparison resumes
    from."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import params as params_lib, transformer
    from repro_torch.train import optimizer as opt

    args = argparse.Namespace(**argd)
    cfg = train._config(args)
    specs = transformer.model_specs(cfg)
    weights = params_lib.materialize(specs, args.seed, dtype=torch.float32, device="cpu")
    conditioned(specs, weights)
    state = opt.init_state(weights, opt.AdamWConfig(state_dtype=args.state_dtype))
    CheckpointManager(ckpt_dir).save(0, {"params": weights, "opt": state})


def pipeline_rank(mesh, argd: dict, ref_tree: dict, tokens: np.ndarray, labels: np.ndarray,
                  n_micro: int, f32: bool) -> dict:
    """One rank of ``train.pipeline``'s GPipe loss on the reference's weights
    (``ref_tree``: float32 numpy by the reference's key paths; bf16 on the
    rank unless ``f32``, which also makes the pipeline's activations
    float32) and rows, the reduced config cut to ``argd['layers']``: this
    rank's shard of the staged tree, its batch rows.  Returns the loss
    and this rank's gradient of every leaf (numpy float32, by key path)."""
    import dataclasses

    from repro_torch.launch import train
    from repro_torch.models import params as params_lib
    from repro_torch.train import optimizer as opt, pipeline, sharding

    torch.set_num_threads(1)
    pipeline.ACT_DTYPE = torch.float32 if f32 else torch.bfloat16
    cfg = dataclasses.replace(train._config(argparse.Namespace(**argd)), n_layers=argd["layers"])
    full = params_lib.from_reference(ref_tree, "cpu")
    if not f32:
        full = opt.tree_map(lambda t: t.to(torch.bfloat16), full)
    staged = pipeline.stage_view(full, mesh.shape["pod"])
    local = sharding.local_tree(staged, pipeline.stage_placement(staged), mesh)
    share = tokens.shape[0] // mesh.shape["data"]
    rows = slice(mesh.coords["data"] * share, (mesh.coords["data"] + 1) * share)
    for _, leaf in pipeline._flatten(local):
        leaf.requires_grad_(True)
    fn = pipeline.pipeline_loss_fn(cfg, mesh, n_micro, staged, batch_axes=("data",))
    loss = fn(local, torch.from_numpy(tokens[rows]).long(), torch.from_numpy(labels[rows]).long())
    loss.backward()
    return {"loss": float(loss.detach()), "coords": mesh.coords,
            "grads": {"/".join(path): leaf.grad.float().numpy() for path, leaf in pipeline._flatten(local)}}


def pipeline_runs(mesh, runs: list) -> list:
    """``pipeline_rank`` for each argument tuple of ``runs`` (one spawn)."""
    return [pipeline_rank(mesh, *run) for run in runs]


def grid_checks(mesh) -> dict:
    """``GridMesh`` on this rank: its coordinates and subgroups, a sum over
    each axis, a shard of an [8, 6] tensor placed ('data', 'model') and
    its gather to rank 0, and FSDP's gather with an upstream gradient of
    rank + 1."""
    from repro_torch.train import sharding

    out = {"coords": mesh.coords, "data_ranks": mesh.group_ranks("data"),
           "model_ranks": mesh.group_ranks("model")}
    me = torch.tensor([float(mesh.rank)])
    out["sum_data"] = float(sharding.all_reduce(me, mesh, "data"))
    out["sum_model"] = float(sharding.all_reduce(me, mesh, "model"))
    out["sum_all"] = float(sharding.all_reduce(me, mesh, ("data", "model")))
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    shard = sharding.shard_of(full, ("data", "model"), mesh)
    full = sharding.gather_to_root(shard, ("data", "model"), mesh)
    out["shard"], out["full"] = shard.numpy(), None if full is None else full.numpy()
    leaf = shard.clone().requires_grad_(True)
    gathered = sharding.fsdp_gather(leaf, ("data", "model"), mesh)
    gathered.backward(torch.full_like(gathered, float(mesh.rank + 1)))
    out["gathered"], out["grad"] = gathered.detach().numpy(), leaf.grad.numpy()
    out["logits"] = forward_logits(mesh)
    return out


def forward_logits(mesh) -> dict:
    """``transformer.forward`` of reduced qwen1.5-0.5b (float32, seed 0) on
    this rank's rows with the weights gathered over 'data' and split over
    'model' (vocab-parallel embedding and logits, tensor-parallel layers),
    beside the same forward on one process; both [B/D, S, V] (numpy)."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import layers, params as params_lib, transformer
    from repro_torch.train import sharding

    float32()
    cfg = configs.reduce_config(configs.get_config("qwen1.5-0.5b"))
    specs = transformer.model_specs(cfg)
    full = params_lib.materialize(specs, 0, device="cpu")
    conditioned(specs, full)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(4, 16))).long()
    share = tokens.shape[0] // mesh.shape["data"]
    rows = tokens[mesh.coords["data"] * share : (mesh.coords["data"] + 1) * share]
    with torch.no_grad():
        whole, _ = transformer.forward(full, cfg, rows)
        layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
        try:
            place = train.placement(cfg, mesh)
            local = sharding.gather_tree(sharding.local_tree(full, place, mesh), place, mesh)
            split, _ = transformer.forward(local, cfg, rows)
        finally:
            layers.disable_activation_sharding()
    return {"mesh": split.numpy(), "whole": whole.numpy()}


def train_many(mesh, runs: list) -> list:
    """This rank of ``launch.train``'s ``--mesh`` run (its ``_rank``), in
    float32, for each argument dict of ``runs`` in turn (one spawn for many
    runs), on one thread per rank."""
    from repro_torch.launch import train

    torch.set_num_threads(1)
    float32()
    return [train._rank(mesh, argd) for argd in runs]


def nudge(ckpt_dir: str, leaf_path: str) -> None:
    """Move every weight of one leaf of a step-0 checkpoint by one float32
    ulp (upwards), in place: the sensitivity witness of a comparison."""
    from repro_torch.ckpt.manager import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    like = {"params": {}, "opt": {}}
    import json
    import os

    with open(os.path.join(ckpt_dir, "step_000000", "manifest.json")) as f:
        entry = next(e for e in json.load(f)["leaves"] if e["path"] == leaf_path)
    path = os.path.join(ckpt_dir, "step_000000", entry["file"])
    a = np.load(path)
    np.save(path, np.nextafter(a, np.float32(np.inf)).astype(a.dtype))
    del mgr, like


def one_step(mesh, argd: dict, ref_tree: dict, tokens: np.ndarray, labels: np.ndarray) -> dict | None:
    """One float32 ``make_train_step`` step of ``launch.train``'s model and
    AdamW settings on the reference's weights (``ref_tree``, numpy) and
    rows, on this rank of ``mesh``; rank 0 returns the loss, the gradient
    norm, the gradients and the updated parameters, gathered whole (numpy,
    by key path), and with int8 moments the moments' 'q' and 'scale'."""
    from repro_torch.ckpt.manager import leaves_with_paths
    from repro_torch.launch import mesh as meshlib, train
    from repro_torch.models import layers, params as params_lib
    from repro_torch.train import optimizer as opt, sharding, step as step_lib

    torch.set_num_threads(1)
    float32()
    args = argparse.Namespace(**argd)
    cfg = train._config(args)
    params = params_lib.from_reference(ref_tree, "cpu")
    layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
    place = train.placement(cfg, mesh)
    params = sharding.local_tree(params, place, mesh)
    share = tokens.shape[0] // mesh.axis_size(meshlib.batch_axes(mesh))
    d = mesh.axis_index(meshlib.batch_axes(mesh))
    rows = slice(d * share, (d + 1) * share)
    batch = {"tokens": torch.from_numpy(tokens[rows]).long(), "labels": torch.from_numpy(labels[rows]).long()}
    tcfg = step_lib.TrainConfig(adamw=opt.AdamWConfig(lr=args.lr, warmup_steps=1, total_steps=args.steps,
                                                      state_dtype=args.state_dtype),
                                ce_chunk=min(1024, args.seq_len))
    params, state, metrics = step_lib.make_train_step(cfg, tcfg, mesh, place)(
        params, opt.init_state(params, tcfg.adamw, mesh, place), batch)
    pairs = list(zip(leaves_with_paths(params), leaves_with_paths(place)))
    new = {path: sharding.gather_to_root(p.detach(), spec, mesh) for (path, p), (_, spec) in pairs}
    grads = {path: sharding.gather_to_root(p.grad, spec, mesh) for (path, p), (_, spec) in pairs}
    if mesh.rank:
        return None
    new, grads = ({k: v.numpy() for k, v in d.items()} for d in (new, grads))
    out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "params": new,
           "grads": grads}
    if args.state_dtype == "int8":  # replicated: rank 0's moments are whole
        out.update({name: {path: t.numpy() for path, t in leaves_with_paths(state[name])} for name in ("m", "v")})
    return out


def one_steps(mesh, runs: list) -> list:
    """``one_step`` for each argument tuple of ``runs`` (one spawn)."""
    return [one_step(mesh, *run) for run in runs]


def moe_layer(mesh, runs: list) -> list:
    """Reduced qwen2-moe's MoE layer on this rank of a (data, model) mesh,
    float32, its weights split over 'model' only (no FSDP: 2 of the 4
    experts and half the shared expert's width a rank): for each ``(impl,
    capacity_factor, weights, x, wy)`` of ``runs`` (numpy; ``x`` [B, S, D]
    and ``wy`` the global batch), this rank's rows of x through
    ``moe.moe_fwd`` under ``impl`` and the backward of sum(y · wy) + aux.
    Returns the routing of its tokens ('top_e', 'keep' as [tokens, k]), y,
    aux, x's gradient and every leaf's gradient summed over 'data' (this
    rank's shard; numpy)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import layers, moe, params as params_lib
    from repro_torch.train import sharding

    torch.set_num_threads(1)
    base = configs.reduce_config(configs.get_config("qwen2-moe-a2.7b"))
    out = []
    layers.enable_activation_sharding(mesh)
    saved = moe.MOE_IMPL
    try:
        for impl, cf, weights, x, wy in runs:
            cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
            specs = moe.moe_specs(cfg)
            place = params_lib.validate_divisibility(specs, mesh, meshlib.rules_for(mesh, fsdp=False))
            p = sharding.local_tree(params_lib.from_reference(weights, "cpu"), place, mesh)
            leaves = []
            sharding.zip_map(lambda t, _s: leaves.append(t.requires_grad_(True)), p, place)
            share = x.shape[0] // mesh.shape["data"]
            rows = slice(mesh.coords["data"] * share, (mesh.coords["data"] + 1) * share)
            xr = torch.from_numpy(x[rows]).requires_grad_(True)
            moe.MOE_IMPL = impl
            route = moe.route_einsum if impl == "einsum" else moe.route_scatter
            with torch.no_grad():
                r = route(p, cfg, xr)
            y, aux = moe.moe_fwd(p, cfg, xr)
            ((y * torch.from_numpy(wy[rows])).sum() + aux).backward()
            k = cfg.moe.top_k
            grads = sharding.zip_map(lambda t, _s: sharding.all_reduce(t.grad, mesh, "data").numpy(), p, place)
            out.append({"top_e": r["top_e"].reshape(-1, k).numpy(), "keep": r["keep"].reshape(-1, k).numpy(),
                        "spans": r["spans"], "y": y.detach().numpy(), "aux": float(aux.detach()),
                        "x_grad": xr.grad.numpy(), "grads": grads, "specs": place, "rows": (rows.start, rows.stop),
                        "coords": mesh.coords})
    finally:
        moe.MOE_IMPL = saved
        layers.disable_activation_sharding()
    return out


def seq_grads(mesh, arch: str, ref_tree: dict, tokens: np.ndarray, labels: np.ndarray, extra: dict,
              fault: bool = False) -> dict | None:
    """One float32 gradient step (``make_grad_step``, no update) of
    ``arch``'s reduced config under ``layers.SEQ_SHARD`` on this rank of
    ``mesh``, on the reference's weights (``ref_tree``, numpy) and rows
    (``extra``: whisper's frames of the global batch).  ``fault`` plants
    one: ``sharding.sync_grads`` without the model-axis sum of the leaves
    that act on the sequence shards.  Rank 0 returns the loss, the
    gradient norm, every gradient gathered whole (numpy, by key path) and
    the collectives by kind."""
    from repro_torch import configs
    from repro_torch.ckpt.manager import leaves_with_paths
    from repro_torch.launch import mesh as meshlib, train
    from repro_torch.models import layers, params as params_lib
    from repro_torch.train import sharding, step as step_lib

    torch.set_num_threads(1)
    float32()
    cfg = configs.reduce_config(configs.get_config(arch))
    saved = layers.SEQ_SHARD, sharding.sync_grads
    layers.SEQ_SHARD = True
    if fault:
        sharding.sync_grads = lambda params, specs, m, seq_keys=(): saved[1](params, specs, m)
    layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
    try:
        place = train.placement(cfg, mesh)
        params = sharding.local_tree(params_lib.from_reference(ref_tree, "cpu"), place, mesh)
        ba = meshlib.batch_axes(mesh)
        share = tokens.shape[0] // mesh.axis_size(ba)
        rows = slice(mesh.axis_index(ba) * share, (mesh.axis_index(ba) + 1) * share)
        batch = {"tokens": torch.from_numpy(tokens[rows]).long(), "labels": torch.from_numpy(labels[rows]).long(),
                 **{k: torch.from_numpy(v[rows]) for k, v in extra.items()}}
        sharding.reset_kinds()
        _grads, norm, metrics = step_lib.make_grad_step(cfg, step_lib.TrainConfig(), mesh, place)(params, batch)
        kinds = sharding.kinds_snapshot()
        grads = {path: sharding.gather_to_root(p.grad, spec, mesh)
                 for (path, p), (_, spec) in zip(leaves_with_paths(params), leaves_with_paths(place))}
    finally:
        layers.SEQ_SHARD, sharding.sync_grads = saved
        layers.disable_activation_sharding()
    if mesh.rank:
        return None
    return {"loss": float(metrics["loss"]), "grad_norm": float(norm), "kinds": kinds,
            "grads": {k: v.numpy() for k, v in grads.items()}}


def seq_runs(mesh, runs: list) -> list:
    """For each run of ``runs``: ``('train', *args)`` is ``seq_grads(mesh,
    *args)``, ``('serve', *args)`` is ``torch_serve_worker.serve(mesh,
    *args)`` under ``layers.SEQ_SHARD`` (one spawn)."""
    import torch_serve_worker
    from repro_torch.models import layers

    out = []
    for kind, *args in runs:
        if kind == "train":
            out.append(seq_grads(mesh, *args))
            continue
        saved, layers.SEQ_SHARD = layers.SEQ_SHARD, True
        try:
            out.append(torch_serve_worker.serve(mesh, *args))
        finally:
            layers.SEQ_SHARD = saved
    return out


def reduce_scatter_checks(mesh, cases: list) -> list:
    """``sharding.psum_scatter`` over 'data' of this rank's tensor for each
    ``(shape, dim, dtype name)`` of ``cases`` — integer values that differ
    by rank, so every sum is exact in any order — beside an all-reduce and
    a slice of the same tensor, with the kinds and the bytes sent
    (``sharding.COMM``) that the reduce-scatter alone counted."""
    from repro_torch.train import sharding

    torch.set_num_threads(1)
    out = []
    for shape, dim, dtype in cases:
        n, idx = mesh.axis_size("data"), mesh.axis_index("data")
        x = (torch.arange(int(np.prod(shape))).reshape(shape) % 13 + 5 * mesh.rank).to(getattr(torch, dtype))
        whole = sharding.all_reduce(x, mesh, "data")
        want = sharding._chunk(whole, dim, n, idx)
        sharding.reset_kinds()
        sent = sharding.COMM["bytes"]
        got = sharding.psum_scatter(x, mesh, "data", dim)
        out.append({"got": got.float().numpy(), "want": want.float().numpy(), "kinds": sharding.kinds_snapshot(),
                    "sent": sharding.COMM["bytes"] - sent, "in_bytes": x.numel() * x.element_size()})
    return out


def int8_updates(mesh, params: dict, specs: dict, grads: list, norms: list, dtype: str = "float32") -> dict:
    """AdamW with int8 moments (``optimizer.adamw_update`` over ``mesh``) on
    this rank's shards of ``params`` (numpy float32 by name, cast to
    ``dtype``; placements ``specs``), once for each whole gradient tree of
    ``grads`` (cast the same way) cut to this rank's shards, with the
    clip's norm given (``norms``).  Returns this rank's parameter shards
    (as float32) and every moment's 'q' and 'scale' (numpy)."""
    from repro_torch.train import optimizer as opt, sharding

    torch.set_num_threads(1)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, state_dtype="int8")
    cast = getattr(torch, dtype)
    local = lambda tree: sharding.local_tree({k: torch.from_numpy(v).to(cast) for k, v in tree.items()}, specs,
                                             mesh)
    p = local(params)
    state = opt.init_state(p, cfg, mesh, specs)
    for g, norm in zip(grads, norms):
        opt.adamw_update(p, local(g), state, cfg, grad_norm=torch.tensor(norm), mesh=mesh, placement=specs)
    moments = {name: {k: {part: t.numpy() for part, t in d.items()} for k, d in state[name].items()}
               for name in ("m", "v")}
    return {"params": {k: v.float().numpy() for k, v in p.items()}, **moments}
