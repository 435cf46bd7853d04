"""``repro_torch.launch.dryrun``: rank 0's program of each (arch × shape ×
mesh) cell traced on a dry production mesh, and its record held to the
reference's.

* ``param_bytes_per_device`` of every arch at 16×16 and 2×16×16 (the
  port's formula on its placement tables, and the bytes of the fake
  shards) equals the reference's formula on the reference's own
  ``param_shardings``, placed on 512 forced host devices in a subprocess
  that compiles nothing;
* a traced cell carries every key of the reference's record, and
  ``benchmarks/roofline.py`` reads it (``load_cells(out_dir=...)``,
  ``terms``);
* mamba2's decode_32k cell is ``ok``: its SSM heads split over 'model',
  its arguments the parameter shards, the cache shards ('h', 'conv',
  'pos' by the reference's ``cache_pspec_for``, each leaf's bytes over
  the product of its axes' sizes) and the token rows;
* the long_500k cells of h2o-danube-3-4b and jamba (batch 1, which the
  16 data ranks do not divide: every rank holds the row) are ``ok``: their
  arguments the parameter shards, the cache shards — the attention
  slots split over every axis, 1.47 MB and 33.6 MB of K/V a device — and
  the token;
* the sequence-parallel cell (``--variant sp --set seq_shard=true``) is
  ``ok``, its region edges reduce-scatters;
* the int8 train cell (``--variant int8 --set state_dtype=int8``) is
  ``ok``: its moments are replicated, as the reference places them, so
  its arguments are the parameter shards, both moments of every leaf
  whole (int8 values and one float32 scale per block of 256) and the
  batch rows, and it carries no note;
* ``python -m repro_torch.launch.dryrun`` writes a train cell here, on a
  CPU-only host without ``nvcc``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch import configs
from repro_torch.launch import dryrun, mesh as meshlib
from repro_torch.models import transformer

ROOT = Path(__file__).resolve().parents[1]

# the keys of the reference's record (repro/launch/dryrun.py, lower_cell and main)
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "n_chips", "variant", "compile_seconds", "memory_analysis", "cost_analysis",
    "collectives", "hlo_cost", "param_bytes_per_device", "params_total", "params_active", "kind",
    "global_batch", "seq_len", "wall_seconds",
}

REFERENCE = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, "src")
    import jax
    import numpy as np
    from repro import configs
    from repro.launch import mesh as meshlib
    from repro.models import params as params_lib, transformer

    out = {}
    for mp in (False, True):
        mesh = meshlib.make_production_mesh(multi_pod=mp)
        for arch in configs.ARCHS:
            specs = transformer.model_specs(configs.get_config(arch))
            sh = meshlib.param_shardings(specs, mesh, True)
            flat = jax.tree_util.tree_flatten_with_path(params_lib.abstract(specs))[0]
            sh_flat = jax.tree_util.tree_flatten_with_path(sh)[0]
            total = 0
            for (_, sds), (_, h) in zip(flat, sh_flat):
                n = int(np.prod(sds.shape)) * sds.dtype.itemsize
                denom = 1
                for entry in h.spec:
                    if entry is None:
                        continue
                    axes = entry if isinstance(entry, tuple) else (entry,)
                    denom *= int(np.prod([mesh.shape[a] for a in axes]))
                total += n // denom
            out[f"{arch}|{mp}"] = total
    print("REF " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def reference_param_bytes():
    res = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    line = next((x for x in res.stdout.splitlines() if x.startswith("REF ")), None)
    assert line is not None, res.stderr[-3000:]
    return json.loads(line[4:])


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_param_bytes_per_device_equal_the_reference(arch, multi_pod, reference_param_bytes):
    mesh = meshlib.dry_production_mesh(multi_pod=multi_pod, device="cpu")
    formula, traced = dryrun.param_bytes(configs.get_config(arch), mesh)
    want = reference_param_bytes[f"{arch}|{multi_pod}"]
    assert formula == traced == want, (arch, multi_pod, formula, traced, want)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """A traced decode cell, an SSM cell, the two long_500k cells, a
    seq_shard cell and an int8 train cell, written by ``main`` into one
    directory."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--out-dir", str(out)])
    dryrun.main(["--arch", ",".join(LONG), "--shape", "long_500k", "--out-dir", str(out)])
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k", "--out-dir", str(out)])
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "prefill_32k", "--variant", "sp", "--set",
                 "seq_shard=true", "--out-dir", str(out)])
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--variant", "int8", "--set",
                 "state_dtype=int8", "--out-dir", str(out)])
    return out


def _read(out, name):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


def test_cell_keys_are_a_superset_of_the_reference(cells):
    rec = _read(cells, "qwen1.5-0.5b__decode_32k__16x16.json")
    assert "error" not in rec, rec.get("error")
    assert REFERENCE_KEYS <= set(rec), REFERENCE_KEYS - set(rec)
    assert rec["n_chips"] == 256 and rec["mesh"] == "16x16" and rec["kind"] == "decode"
    assert rec["param_bytes_per_device"] == rec["param_bytes_per_device_traced"]
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] > rec["param_bytes_per_device"]  # parameters + the cache shard
    assert set(rec["collectives"]) >= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                       "collective-permute", "total_bytes", "total_count"}
    assert rec["collectives"]["total_bytes"] == rec["hlo_cost"]["collective_bytes_total"]
    assert rec["cost_analysis"]["flops"] == rec["hlo_cost"]["flops"] > 0
    assert rec["kernel_launches"] == 0


def test_no_launch_counts_what_launched_and_raises():
    """A cell's ``kernel_launches`` is the count measured around its trace:
    a wrapper that counted a launch inside shows in it, and the trace
    raises."""
    from repro_torch.kernels import xash_kernel as xk

    with dryrun.no_launch() as seen:
        pass
    assert seen == {"launches": 0}
    before = xk.xash_superkey.launches
    try:
        with pytest.raises(AssertionError, match="launched 2 kernels"):
            with dryrun.no_launch() as seen:
                xk.xash_superkey.launches += 2
        assert seen == {"launches": 2}
    finally:
        xk.xash_superkey.launches = before


def test_roofline_reads_a_port_cell(cells):
    from benchmarks import roofline

    recs = [r for r in roofline.load_cells(out_dir=str(cells)) if r["_file"].startswith("qwen1.5-0.5b__decode")]
    assert len(recs) == 1
    row = roofline.terms(recs[0])
    assert row is not None and row["hlo_flops"] == recs[0]["hlo_cost"]["flops"]
    assert row["t_compute_s"] > 0 and row["t_memory_s"] > 0 and row["t_collective_s"] > 0


def test_ssm_decode_cell_holds_its_cache_shards(cells):
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import transformer

    rec = _read(cells, "mamba2-1.3b__decode_32k__16x16.json")
    assert "error" not in rec, rec.get("error")
    assert rec["kernel_launches"] == 0 and rec["collectives"]["all-gather"]["count"] > 0
    cfg, shape = configs.get_config("mamba2-1.3b"), SHAPES["decode_32k"]
    mesh = meshlib.dry_production_mesh(device="cpu")
    plan = transformer.group_plans(cfg)[0]
    cache = 0
    for key, t in transformer._layer_cache(cfg, "ssm", shape.global_batch, shape.seq_len, device="meta").items():
        whole = (plan.n, *t.shape)
        denom = 1
        for entry in meshlib.cache_pspec_for(key, whole, mesh):
            denom *= mesh.axis_size(entry) if entry is not None else 1
        cache += t.numel() * plan.n * t.element_size() // denom
    token = shape.global_batch // 16 * 8  # this rank's int64 rows
    assert rec["memory_analysis"]["argument_size_in_bytes"] == rec["param_bytes_per_device"] + cache + token


# the long_500k cells: arch -> the bytes of rank 0's K/V shards (layers × 524,288 slots — danube's
# ring 4,096 — × KV heads × head dim × K and V × bf16, over the 256 devices of 16×16)
LONG = {"h2o-danube-3-4b": 24 * 4096 * 8 * 120 * 2 * 2 // 256,
        "jamba-v0.1-52b": 4 * 524288 * 8 * 128 * 2 * 2 // 256}


def _cache_shard_bytes(cfg, shape, mesh) -> dict:
    """{leaf name: the bytes of rank 0's shards of it over every layer}
    under ``cache_pspec_for``, from the leaves' whole shapes."""
    out: dict = {}
    for plan in transformer.group_plans(cfg):
        for mixer, _ffn in plan.sublayers:
            window = cfg.sliding_window if mixer == "attn" else 0
            one = transformer._layer_cache(cfg, mixer, shape.global_batch, shape.seq_len, window, device="meta")
            for key, t in one.items():
                denom = 1
                for entry in meshlib.cache_pspec_for(key, (plan.n, *t.shape), mesh):
                    denom *= mesh.axis_size(entry) if entry is not None else 1
                out[key] = out.get(key, 0) + t.numel() * plan.n * t.element_size() // denom
    return out


@pytest.mark.parametrize("arch", list(LONG))
def test_the_long_context_cells_hold_their_cache_shards(cells, arch):
    """Batch 1 over 16 data ranks: every rank holds the row, the
    attention caches' slots split over both axes; the cell's arguments are
    the parameter shards, the cache shards and the token."""
    from repro_torch.configs.shapes import SHAPES

    rec = _read(cells, f"{arch}__long_500k__16x16.json")
    assert "error" not in rec, rec.get("error")
    assert rec["kernel_launches"] == 0 and rec["global_batch"] == 1
    cfg, shape = configs.get_config(arch), SHAPES["long_500k"]
    mesh = meshlib.dry_production_mesh(device="cpu")
    assert meshlib.cache_pspec_for("k", (1, 1, 524288, cfg.n_kv_heads, cfg.head_dim), mesh)[2] == ("data", "model")
    cache = _cache_shard_bytes(cfg, shape, mesh)
    assert cache["k"] + cache["v"] == LONG[arch]
    token = 8  # the one row, int64, on every rank
    assert rec["memory_analysis"]["argument_size_in_bytes"] == rec["param_bytes_per_device"] + sum(cache.values()) + token


def test_the_seq_shard_cell_is_ok(cells):
    rec = _read(cells, "qwen1.5-0.5b__prefill_32k__16x16__sp.json")
    assert "error" not in rec, rec.get("error")
    assert rec["kernel_launches"] == 0 and rec["variant"]["seq_shard"] is True
    coll = rec["collectives"]
    assert coll["reduce-scatter"]["count"] > 0 and coll["all-gather"]["count"] > 0


def _spec_leaves(tree) -> list:
    return [x for k in sorted(tree) for x in _spec_leaves(tree[k])] if isinstance(tree, dict) else [tree]


def test_the_int8_cell_is_ok_and_replicates_its_moments(cells):
    rec = _read(cells, "qwen1.5-0.5b__train_4k__16x16__int8.json")
    assert "error" not in rec, rec.get("error")
    assert rec["kernel_launches"] == 0 and rec["variant"]["state_dtype"] == "int8" and "notes" not in rec
    cfg = configs.get_config("qwen1.5-0.5b")
    blocks = sum(-(-int(np.prod(s.shape)) // 256) for s in _spec_leaves(transformer.model_specs(cfg)))
    moments = 2 * blocks * (256 + 4)  # m and v: int8 values and a float32 scale per block
    rows = 256 // 16  # the global batch over the 16 data ranks
    tokens = 2 * rows * 4096 * 8  # tokens and labels, int64
    assert rec["memory_analysis"]["argument_size_in_bytes"] == rec["param_bytes_per_device"] + moments + tokens + 4
    assert "wall_seconds" in rec


def test_module_writes_a_train_cell_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b",
                          "--shape", "train_4k", "--out-dir", str(tmp_path)], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = _read(tmp_path, "qwen1.5-0.5b__train_4k__16x16.json")
    assert "error" not in rec, rec.get("error")
    assert rec["kind"] == "train" and rec["hlo_cost"]["flops"] > 0
    assert rec["collectives"]["all-gather"]["count"] > 0 and rec["collectives"]["all-reduce"]["count"] > 0
