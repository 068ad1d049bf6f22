"""The four-card cell ``ae64r-4card.cycle`` at a small size: whole runs over
four CPU devices (sound; with the tree built shard by shard and then over
the shard roots, the rule that breaks odd promotion at a seam; with the
``digest128`` control), and the same run on four cards where there are."""

import json

import pytest
import torch

from portbench import harness

CPU = torch.device("cpu")
CELL = "ae64r-4card.cycle"
# 1,650 keys a shard: the shards' level 1 holds 825 nodes, so the tree
# crosses the seams between shards there, and the global level 1 (3,300
# nodes) and its parents promote odd nodes.
AE4_SMALL = {"keys": 6600, "replicas": 9, "warmup_cycles": 1}


def run(devices, control=None, trace=False, seed=4_100_000_023):
    return harness.run_cell(CELL, seed, 1.0, trace, list(devices), overrides=AE4_SMALL,
                            control=control)


def test_sound_over_four_shards():
    r = run([CPU] * 4)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {"cycle_ms", "setup_s"}


def test_shard_roots_then_a_top_tree_fails(monkeypatch):
    from merklekv_tpu_torch.ops import dispatch
    from merklekv_tpu_torch.parallel import sharded_merkle

    monkeypatch.setattr(sharded_merkle, "_seam", lambda block: dispatch.build_levels(block)[-1])
    r = run([CPU] * 4)
    assert not r["correct"]
    assert r["checks"]["root_mismatch"]["value"] == 1
    assert r["checks"]["mask_mismatches"]["value"] == 0


def test_digest128_control_fails():
    r = run([CPU] * 4, control="digest128")
    assert not r["correct"] and r["checks"]["mask_mismatches"]["value"] > 0


@pytest.mark.cuda
def test_small_cell_correct_on_four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    r = run([torch.device("cuda", i) for i in range(4)], trace=True)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 4
    # Cards 1-3 send their seams (825 nodes of 32 B), masks (9 x 1,650 B)
    # and counts (9 x 4 B).
    assert round(r["metrics"]["combine_mb.ae4"]["value"] * 1e6) == 3 * (825 * 32 + 9 * 1650 + 36)
    json.dumps(r)
