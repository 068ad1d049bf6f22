"""Whole runs of each cell on the CPU at small sizes, past the harness's
look for a card: sound, then with the timed path broken underneath (each
fault a cell can have) and with each control in the program's place;
``correct`` has to come out false for every fault and control."""

import pytest
import torch

from portbench import harness

CPU = torch.device("cpu")
AE_SMALL = {"keys": 2048, "warmup_cycles": 1}
# The four-card configuration's shape (Zipf-skewed divergence, a key mesh)
# at a small size, over four CPU devices.
AE4_SMALL = {"keys": 4096, "replicas": 9, "warmup_cycles": 1,
             "divergence": {"rule": "zipf", "fraction": 0.01, "s": 1.0, "absent_every": 8}}
# The mirror cell is one of pending.json's.
PENDING = harness.load_bench(pending=True)
KV_SMALL = {"keys": 1500, "frame_events": 16, "rate_writes_per_s": 320, "warmup_s": 0.5,
            "value_pool_bytes": 1 << 16, "stamp_samples": 3, "settle_s": 20.0}


def run(cell, overrides, devices=(CPU,), seed=3_000_000_017, seconds=1.0, **kw):
    return harness.run_cell(cell, seed, seconds, False, list(devices), overrides=overrides, **kw)


def test_ae_sound():
    r = run("ae10m-r8.cycle", AE_SMALL)
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"cycle_ms", "setup_s"}
    assert list(r)[-1] == "checks"


def test_ae_sound_across_four_shards():
    r = run("ae10m-r8.cycle", AE4_SMALL, devices=[CPU] * 4)
    assert r["correct"]


def _forward_fault(kind):
    from merklekv_tpu_torch.merkle import torch_engine

    real = torch_engine.anti_entropy_forward
    first = []

    def fwd(blocks, nblocks, digests, present, device=None):
        if kind == "unchanged":
            if not first:
                first.append(real(blocks, nblocks, digests, present, device=device))
            return first[0]
        if kind == "scribble":
            blocks[1, 2, 3] = ~blocks[0, 2, 3]  # answers right, on inputs it changed
            return real(blocks, nblocks, digests, present, device=device)
        if kind == "half":
            h = blocks.shape[0] // 2
            root, masks, counts = real(blocks[:h], nblocks[:h], digests[:, :h], present[:, :h],
                                       device=device)
            masks = torch.cat([masks, torch.zeros_like(masks)], dim=1)
            return root, masks, counts
        root, masks, counts = real(blocks, nblocks, digests, present, device=device)
        root = root.clone()
        root[3] ^= 1 << 9
        return root, masks, counts

    return fwd


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "scribble"])
def test_ae_faults_fail(monkeypatch, kind):
    from merklekv_tpu_torch.merkle import torch_engine

    monkeypatch.setattr(torch_engine, "anti_entropy_forward", _forward_fault(kind))
    r = run("ae10m-r8.cycle", AE_SMALL)
    assert not r["correct"]
    if kind == "scribble":
        assert r["checks"]["inputs_changed"]["value"] == 1


def test_ae_exchange_left_out_fails(monkeypatch):
    from merklekv_tpu_torch.parallel import sharded_merkle

    monkeypatch.setattr(sharded_merkle, "_psum", lambda parts, dev, mesh=None: parts[0].to(dev))
    r = run("ae10m-r8.cycle", AE4_SMALL, devices=[CPU] * 4)
    assert not r["correct"] and r["checks"]["count_mismatches"]["value"] > 0


def test_ae_control_fails():
    r = run("ae10m-r8.cycle", AE_SMALL, control="digest128")
    assert not r["correct"] and r["checks"]["mask_mismatches"]["value"] > 0


def test_kv_sound():
    r = run("kv1m-ycsb.u11k", KV_SMALL, seconds=1.5, bench=PENDING)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"fresh_p95_ms", "setup_s"}


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_kv_faults_fail(monkeypatch, kind):
    from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror

    real_on, real_root = DeviceTreeMirror.on_events, DeviceTreeMirror.published_root_stamped
    if kind == "unchanged":
        monkeypatch.setattr(DeviceTreeMirror, "on_events",
                            lambda self, evs, watermark=None: real_on(self, [], watermark))
    elif kind == "half":
        monkeypatch.setattr(DeviceTreeMirror, "on_events",
                            lambda self, evs, watermark=None:
                            real_on(self, evs[: len(evs) // 2], watermark))
    else:
        def altered(self):
            got = real_root(self)
            if got is None:
                return None
            root, ver = got
            return ("f" if root[0] != "f" else "e") + root[1:], ver

        monkeypatch.setattr(DeviceTreeMirror, "published_root_stamped", altered)
    r = run("kv1m-ycsb.u11k", KV_SMALL, seconds=1.5, bench=PENDING)
    assert not r["correct"]


def test_kv_control_fails():
    r = run("kv1m-ycsb.u11k", KV_SMALL, seconds=1.5, control="padded_root",
            bench=PENDING)
    assert not r["correct"] and r["checks"]["root_mismatches"]["value"] > 0
