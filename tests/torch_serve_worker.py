"""The rank side of the port's serving-over-a-mesh tests
(``test_torch_serve_mesh.py``, ``test_torch_dry_mesh.py``): run by every
spawned rank of a gloo group (``repro_torch.launch.mesh.run_ranks``), or on
a dry mesh in the test's own process.  Imports the port only.

``serve`` runs ``transformer.prefill`` and ``decode_step`` on this rank of
a ``GridMesh`` (float32 unless asked otherwise) from full weights given as
numpy (the reference's key paths), and hands back this rank's logits, its
cache leaves and the collectives it issued by kind.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy (the cache is updated in place after it is read)."""
    return (t.detach().float() if t.is_floating_point() else t.detach()).numpy().copy()


def _leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}[{k!r}]"))
        return out
    return {prefix: tree}


def serve(mesh, arch: str, weights: dict | None, tokens: np.ndarray, n_decode: int, max_seq: int,
          window: int | None = None, extra: dict | None = None) -> dict:
    """This rank's prefill of its rows of ``tokens`` and ``n_decode``
    decode steps (the tokens a fixed function of the step, the same on
    every rank) on ``arch``'s reduced config (``window`` overrides its
    sliding window; ``arch`` ending in ':naive' decodes MLA on the naive
    path, in ':gathered' serves from the shards gathered over the batch
    axes once, before the prefill, instead of on every call).  ``extra``: whisper's frames / the VLM's patches of the global
    batch (numpy), split with the rows.  Where the batch axes do not
    divide the batch every rank takes every row (``layers.local_rows``).  ``weights`` None draws the port's
    float32 seed-0 weights.  Returns numpy logits per step, the cache
    leaves after prefill and at the end, and ``sharding.KINDS`` per
    phase."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import layers, params as params_lib, transformer
    from repro_torch.train import sharding

    torch.set_num_threads(1)
    arch, _, path = arch.partition(":")
    cfg = configs.reduce_config(configs.get_config(arch))
    if path == "naive":
        cfg = dataclasses.replace(cfg, mla_absorb=False)
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    specs = transformer.model_specs(cfg)
    full = (params_lib.materialize(specs, 0, torch.float32, "cpu") if weights is None
            else params_lib.from_reference(weights, "cpu"))
    saved = (transformer._embed.__defaults__, transformer.init_cache.__defaults__,
             transformer._encode.__defaults__)
    transformer._embed.__defaults__ = (torch.float32,)
    transformer.init_cache.__defaults__ = (torch.float32, 0, None)
    transformer._encode.__defaults__ = (torch.float32,)
    try:
        layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
        place = params_lib.validate_divisibility(specs, mesh, meshlib.rules_for(mesh))
        local = sharding.local_tree(full, place, mesh)
        if path == "gathered":
            local = sharding.gather_tree(local, place, mesh)
        lo, hi = layers.local_rows(tokens.shape[0])
        rows = torch.from_numpy(tokens[lo:hi]).long()
        kw = {k: torch.from_numpy(v[lo:hi]) for k, v in (extra or {}).items()}
        out = {"kinds": {}, "logits": []}
        with torch.no_grad():
            sharding.reset_kinds()
            logits, cache = transformer.prefill(local, cfg, rows, max_seq, batch=tokens.shape[0], **kw)
            out["kinds"]["prefill"] = sharding.kinds_snapshot()
            out["logits"].append(_np(logits))
            out["cache_prefill"] = {k: _np(v) for k, v in _leaves(cache).items()}
            for step in range(n_decode):
                nxt = (np.arange(tokens.shape[0]) * 7 + step * 13) % cfg.vocab_size
                tok = torch.from_numpy(nxt[lo:hi]).long()
                sharding.reset_kinds()
                logits, cache = transformer.decode_step(local, cfg, tok, cache)
                out["kinds"][f"decode{step}"] = sharding.kinds_snapshot()
                out["logits"].append(_np(logits))
            out["cache"] = {k: _np(v) for k, v in _leaves(cache).items()}
            out["specs"] = {k: v for k, v in _leaves(getattr(cache, "specs", {})).items()}
        out.update(rank=mesh.rank, coords=mesh.coords, rows=(lo, hi))
        return out
    finally:
        layers.disable_activation_sharding()
        (transformer._embed.__defaults__, transformer.init_cache.__defaults__,
         transformer._encode.__defaults__) = saved


def serve_many(mesh, runs: list) -> list:
    """``serve`` for each argument tuple of ``runs`` (one spawn)."""
    return [serve(mesh, *run) for run in runs]


def program_kinds(mesh, runs: list) -> list:
    """For each ``(arch, kind, batch, seq[, variant fields])`` of ``runs``:
    ``launch.dryrun``'s program of the reduced config on this rank under
    that ``Variant``, run on real zero-filled CPU tensors, and the
    collectives it issued by kind (``sharding.KINDS``)."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models import layers
    from repro_torch.train import sharding

    torch.set_num_threads(1)
    out = []
    for arch, kind, batch, seq, *sets in runs:
        cfg = configs.reduce_config(configs.get_config(arch))
        layers.enable_activation_sharding(mesh, vocab_size=cfg.vocab_size)
        try:
            fn, args = dryrun.program(cfg, ShapeSpec(kind, seq, batch, kind), dryrun.Variant(**sets[0] if sets else {}), mesh,
                                      dryrun.placement(cfg, mesh), "cpu")
            sharding.reset_kinds()
            fn(*args)
            out.append(sharding.kinds_snapshot())
        finally:
            layers.disable_activation_sharding()
    return out
