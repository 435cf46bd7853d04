"""FSDP one block at a time, and the reduce-scatter on the wire.

``train.sharding.psum_scatter`` is one ``torch.distributed`` reduce-scatter
(2 gloo CPU ranks): on integer-valued floats, whose sums are exact in any
order, it equals an all-reduce and a slice bit for bit, counts one
'reduce-scatter' of its input's bytes, and sends (n-1)/n of them.

``models.transformer`` gathers the top-level leaves once and each stacked
block's leaves inside the block, each time in one all-gather of the
leaves' shards laid end to end (``sharding.gather_weights``).  On a dry
2×2 (data, model) mesh, rank 0's program of reduced qwen1.5-0.5b
(``launch.dryrun.trace_program``, ``FakeTensorMode``): a train step
gathers each block's FSDP leaves (one all-gather of their gathered
bytes) twice under the remat policies 'full' and 'dots' (the forward and
the backward's recompute) and once under 'none'; its backward counts one
reduce-scatter per gather of the forward, of the same bytes, and no FSDP
all-reduce; prefill and decode gather each block once.  Under 'full' and
'dots', in prefill and in decode, the gathered weights alive at any time
(``sharding.GATHERED``) are at most one block's plus the top-level
leaves', and none is alive once the call has returned; a planted
whole-tree gather fails that bound.
"""

import numpy as np
import pytest

import torch_train_worker as worker
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, mesh as meshlib
from repro_torch.models import transformer
from repro_torch.train import sharding

GRID = {"data": 2, "model": 2}
ARCH, B, S = "qwen1.5-0.5b", 4, 32
WIRE_CASES = [((4, 6), 0, "float32"), ((3, 8, 2), 1, "float32"), ((2, 3, 6), 2, "float32"),
              ((6, 4), 0, "bfloat16")]


@pytest.fixture(scope="module")
def wire():
    return meshlib.run_ranks(worker.reduce_scatter_checks, 2, devices=["cpu"] * 2, grid={"data": 2},
                             args=(WIRE_CASES,), timeout_s=120.0)


@pytest.mark.parametrize("case", range(len(WIRE_CASES)), ids=[f"{c[2]}-dim{c[1]}" for c in WIRE_CASES])
def test_psum_scatter_is_one_reduce_scatter(wire, case):
    for rank in wire:
        got = rank[case]
        assert np.array_equal(got["got"], got["want"]), (got["got"], got["want"])
        kinds = {k: v for k, v in got["kinds"].items() if v["count"]}
        assert kinds == {"reduce-scatter": {"count": 1, "bytes": got["in_bytes"]}}, kinds
        assert got["sent"] == got["in_bytes"] // 2  # (n-1)/n of the input, n = 2


def _fsdp_leaves(f, key: str, lead: int) -> tuple[int, int]:
    """(the FSDP leaves of ``params[key]``, their gathered bf16 bytes) on
    ``f``'s mesh; ``lead`` 1 for a stacked block (one block's)."""
    n = nbytes = 0
    for spec, pl in zip(_leaves(f.specs[key]), _leaves(f.place[key])):
        if any(a in f.batch and f.mesh.axis_size(a) > 1 for e in pl for a in sharding._entry_axes(e)):
            model = [tuple(a for a in sharding._entry_axes(e) if a not in f.batch) for e in pl[lead:]]
            n += 1
            nbytes += 2 * int(np.prod([d // f.mesh.axis_size(ax) for d, ax in zip(spec.shape[lead:], model)]))
    return n, nbytes


def _leaves(tree) -> list:
    return [x for k in sorted(tree) for x in _leaves(tree[k])] if isinstance(tree, dict) else [tree]


def _trace(monkeypatch, kind: str, policy: str = "full"):
    """Rank 0's ``kind`` program on the dry 2×2 mesh: (the all-gathers of
    each ``_Fsdp.block`` call (count, bytes), the peak bytes of gathered
    weights alive, the trace's collectives by kind (count, bytes), the
    gatherer, the config)."""
    cfg = configs.reduce_config(configs.get_config(ARCH))
    mesh = meshlib.dry_grid_mesh(GRID, device="cpu")
    calls = []
    block = transformer._Fsdp.block

    def counted(self, name, lp):
        before = dict(sharding.KINDS["all-gather"])
        out = block(self, name, lp)
        calls.append(tuple(sharding.KINDS["all-gather"][k] - before[k] for k in ("count", "bytes")))
        return out

    monkeypatch.setattr(transformer._Fsdp, "block", counted)
    sharding.reset_gathered()
    got = dryrun.trace_program(cfg, ShapeSpec(kind, S, B, kind), dryrun.Variant(remat_policy=policy), mesh)
    hc = got["hlo_cost"]
    kinds = {k: (int(hc["collective_counts"][k]), int(hc["collective_bytes"][k]))
             for k in ("all-gather", "all-reduce", "reduce-scatter")}
    assert sharding.GATHERED["alive"] == 0, sharding.GATHERED  # every gathered copy died with its call
    return calls, sharding.GATHERED["peak"], kinds, transformer._Fsdp(cfg, mesh), cfg


def _bound(f, cfg) -> int:
    """One block's gathered bytes plus the top-level leaves'."""
    top = sum(_fsdp_leaves(f, k, 0)[1] for k in f.specs if k not in f.stacked)
    return top + max(_fsdp_leaves(f, plan.name, 1)[1] for plan in transformer.group_plans(cfg))


@pytest.mark.parametrize("policy,times", [("full", 2), ("dots", 2), ("none", 1)])
def test_train_step_gathers_each_block(monkeypatch, policy, times):
    calls, _peak, kinds, f, cfg = _trace(monkeypatch, "train", policy)
    per_block, block_bytes = _fsdp_leaves(f, "layers", 1)
    assert per_block > 1 and calls == [(1, block_bytes)] * (cfg.n_layers * times), calls
    top_bytes = sum(_fsdp_leaves(f, k, 0)[1] for k in f.specs if k not in f.stacked)
    # FSDP's backward: one reduce-scatter of the top-level leaves and one a block, whatever the
    # policy, each of the bytes its gather brought in
    assert kinds["reduce-scatter"] == (1 + cfg.n_layers, top_bytes + cfg.n_layers * block_bytes), kinds


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_gathered_weights_alive_are_one_block_and_the_top(monkeypatch, policy):
    _calls, peak, _kinds, f, cfg = _trace(monkeypatch, "train", policy)
    assert 0 < peak <= _bound(f, cfg), (peak, _bound(f, cfg))


def test_a_whole_tree_gather_fails_the_bound(monkeypatch):
    """The fault the bound is there for: every leaf gathered once a step
    (the former ``gather_tree`` in the step) keeps every block's weights
    alive through the forward and the backward."""
    cfg = configs.reduce_config(configs.get_config(ARCH))
    mesh = meshlib.dry_grid_mesh(GRID, device="cpu")
    place = dryrun.placement(cfg, mesh)
    monkeypatch.setattr(transformer, "gather_top", lambda params, cfg: sharding.gather_tree(params, place, mesh))
    calls, peak, _kinds, f, cfg = _trace(monkeypatch, "train")
    assert calls == [(0, 0)] * (2 * cfg.n_layers)  # each block arrives gathered already
    assert peak > _bound(f, cfg), (peak, _bound(f, cfg))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_gathers_each_block_once(monkeypatch, kind):
    calls, peak, kinds, f, cfg = _trace(monkeypatch, kind)
    _, block_bytes = _fsdp_leaves(f, "layers", 1)
    assert calls == [(1, block_bytes)] * cfg.n_layers, calls
    assert 0 < peak <= _bound(f, cfg), (peak, _bound(f, cfg))
    assert kinds["reduce-scatter"] == (0, 0)
