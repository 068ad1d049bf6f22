"""The ETC cell (``etc10m-r8.cycle``): the ragged cycle's data, whole runs on
the CPU at a small size, sound and with the timed path broken, its
controls, and a small run on a card."""

import json

import pytest
import torch

from portbench import harness
from portbench.traffic import ae_ragged

CPU = torch.device("cpu")
CELL = "etc10m-r8.cycle"
SMALL = {"keys": 20_000, "warmup_cycles": 1}
CONFIG = json.loads((harness.ROOT / "portbench" / "configs" / "etc10m-r8.json").read_text())


def run(overrides=SMALL, seed=3_000_000_019, trace=False, **kw):
    return harness.run_cell(CELL, seed, 1.0, trace, [CPU], overrides=overrides, **kw)


def test_sizes_keep_their_multiset_across_seeds():
    n = 50_000
    a = ae_ragged.sizes(CONFIG["value_sizes"], n, torch.Generator().manual_seed(1), CPU)
    b = ae_ragged.sizes(CONFIG["value_sizes"], n, torch.Generator().manual_seed(2), CPU)
    assert not torch.equal(a, b) and torch.equal(a.sort().values, b.sort().values)
    keys = ae_ragged.sizes(CONFIG["key_sizes"], n, torch.Generator().manual_seed(1), CPU)
    assert int(keys.min()) >= 10 and 30 < float(keys.float().mean()) < 40
    assert int(a.min()) == 0 and 300 < float(a.float().mean()) < 340


def test_key_prefixes_order_as_their_numbers():
    nums = torch.tensor([0, 1, 93, 94, 95, 94**5, 2**62, 2**63 - 2])
    pre = ae_ragged.key_prefixes(nums)
    rows = [bytes(r) for r in pre.tolist()]
    assert rows == sorted(rows) and len(set(rows)) == len(rows)
    assert all(33 <= c <= 126 for r in rows for c in r)


def test_sound():
    r = run()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"cycle_ms", "setup_s"}
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_traced_run_reads_the_lane_fill():
    """On the CPU no device metric is read; the lane fill comes from the
    program's counters over the window."""
    r = run(trace=True)
    assert r["correct"]
    assert set(r["metrics"]) == {"lane_fill.etc"}
    assert 90.0 <= r["metrics"]["lane_fill.etc"]["value"] <= 100.0


def test_a_long_leaf_hashed_short_fails(monkeypatch):
    from merklekv_tpu_torch.merkle import torch_engine
    from merklekv_tpu_torch.ops import sha256

    real = torch_engine.ragged_digests

    def short(leaves):
        out = real(leaves).clone()
        lengths = leaves.offsets[1:] - leaves.offsets[:-1]
        i = int(torch.argmax(lengths))
        lo, hi = int(leaves.offsets[i]), int(leaves.offsets[i + 1])
        out[i] = sha256.sha256_ragged(leaves.blocks[lo:hi - 1], torch.tensor([0, hi - 1 - lo]))[0]
        return out

    monkeypatch.setattr(torch_engine, "ragged_digests", short)
    r = run()
    assert not r["correct"] and r["checks"]["root_mismatch"]["value"] == 1


@pytest.mark.parametrize("control", ae_ragged.Cell.CONTROLS)
def test_controls_fail(control):
    r = run({"keys": 20_000, "warmup_cycles": 0}, control=control)
    assert not r["correct"]


@pytest.mark.cuda
def test_small_cell_correct_on_the_card(cuda):
    r = harness.run_cell(CELL, 4_100_000_003, 2.0, True, [cuda],
                         overrides={"keys": 200_003, "warmup_cycles": 1})
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert {"leaf_ms.ae", "levels_ms.ae", "diff_ms.ae", "diff_wait_ms.ae", "between_ms.ae",
            "idle_share.ae", "leaf_roofline.etc", "longest_leaf_ms.etc",
            "lane_fill.etc"} <= set(r["metrics"])
    assert r["metrics"]["leaf_roofline.etc"]["value"] < 105.0
    json.dumps(r)
