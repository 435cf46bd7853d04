"""``repro_torch.launch.dryrun_mate``: the paper's own workload, dry.

A filter cell traces rank 0's shard of the corpus-sharded filter on a dry
256- or 512-rank mesh; its argument bytes are rank 0's rows (4 int32
lanes + one int32 table id each) and the replicated query keys, and its
collectives are exactly the two all-reduces of the counts: an
``int32[2^20]`` of table counts (4 MiB) and an ``int32[keys]``.  The
sharded offline build on 2 gloo CPU ranks is byte-identical to the
single-host build.
"""

import pytest

from repro_torch.launch import dryrun_mate


@pytest.mark.parametrize("impl", ["broadcast", "blocked"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_filter_cell_is_the_arithmetic(impl, multi_pod):
    spec = dryrun_mate.SHAPES["filter_1g"]
    n = 512 if multi_pod else 256
    rec = dryrun_mate.lower("filter_1g", multi_pod, impl)
    per = -(-spec["rows"] // n)
    assert rec["n_chips"] == n and rec["kind"] == "filter"
    assert rec["memory_analysis"]["argument_size_in_bytes"] == per * (4 * 4 + 4) + spec["keys"] * 4 * 4
    assert rec["all_reduces"] == {"table_counts": 4 << 20, "key_counts": 4 * spec["keys"]}
    coll = rec["collectives"]
    assert coll["all-reduce"] == {"count": 2, "bytes": (4 << 20) + 4 * spec["keys"]}
    assert coll["total_count"] == 2 and coll["total_bytes"] == coll["all-reduce"]["bytes"]
    assert rec["stream_bytes"] == float(per * n) * (4 * 4 + 4)
    assert rec["probe_ops"] == float(spec["rows"]) * spec["keys"] * 8
    assert rec["memory_analysis"]["output_size_in_bytes"] == (4 << 20) + 4 * spec["keys"]
    assert rec["kernel_launches"] == 0


def test_blocked_streams_where_broadcast_materialises():
    """The broadcast body's temp holds the [rows, keys, lanes] conflict
    tensor; the blocked body's stays at a block."""
    broad = dryrun_mate.lower("filter_1g", False, "broadcast")["memory_analysis"]["temp_size_in_bytes"]
    blocked = dryrun_mate.lower("filter_1g", False, "blocked")["memory_analysis"]["temp_size_in_bytes"]
    assert broad > 20 * blocked


def test_sharded_build_on_two_ranks_is_identical():
    report = dryrun_mate.exercise_sharded_build(2, "cpu")
    assert report["identical"] and report["n_shards"] == 2 and report["values_total"] > 0
    # the ranks' launches of every wrapper, summed: none on CPU tensors
    assert report["launches"] == {name: 0 for name in dryrun_mate.dryrun.kernel_counts()}
