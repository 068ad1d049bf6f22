"""Anti-entropy's device sites in the torch port against the JAX package's,
on the CPU.

- Parity, bit for bit: ``_leaf_map_device`` (leaf digests on the device)
  against the JAX ``_leaf_map_device`` and hashlib; ``divergence_masks_engine``
  against the JAX one and ``divergence_masks_np`` for R = 2, 3 and 8 seeded
  replicas with absent keys; ``diff_keys_pair`` against the JAX one and a set
  comparison; and the ``_use_device`` routing rule against the reference's.
- No fallback that hides the device: a failure on each device site is counted
  in ``device.fallbacks`` and re-raised, never answered from the host; a SYNC
  whose device leaf pass fails answers an error and changes nothing, and the
  next SYNC tries the device again and converges.
- On the device route (``engine = "tpu"``: always the device path) two torch
  nodes converge by a pairwise SYNC to the hashlib chain's root, and a
  three-node multi-peer sync reports the injected per-peer divergence and
  keeps the LWW winners.
- A bisect SYNC that runs out of its cycle budget resumes from its
  checkpoint over the next SYNCs and converges, counting each key once.

Tolerance everywhere: exact equality.
"""

import hashlib
import struct

import numpy as np
import pytest

from merklekv_tpu.cluster import sync as jsync
from merklekv_tpu.merkle import diff as jdiff
from merklekv_tpu_torch.__main__ import start
from merklekv_tpu_torch.client import MerkleKVClient
from merklekv_tpu_torch.cluster import sync as tsync
from merklekv_tpu_torch.cluster.retry import Deadline, RetryPolicy
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.merkle import diff as tdiff
from merklekv_tpu_torch.merkle import torch_engine
from merklekv_tpu_torch.merkle.encoding import leaf_hash
from merklekv_tpu_torch.obs.metrics import get_metrics

CPU = "cpu"


def _items(seed: int, n: int) -> list:
    """Seeded sorted (key, value) pairs; values up to 200 bytes, so leaves
    span one to four SHA-256 blocks."""
    rng = np.random.default_rng(seed)
    keys = sorted({b"key:%d:" % seed + rng.bytes(int(rng.integers(1, 24))) for _ in range(n)})
    return [(k, rng.bytes(int(rng.integers(0, 200)))) for k in keys]


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 37), (2, 300)])
def test_leaf_map_device_matches_jax_and_hashlib(seed, n):
    items = _items(seed, n)
    got = tsync._leaf_map_device(items, CPU)
    assert list(got) == [k for k, _ in items]
    assert got == jsync._leaf_map_device(items)
    assert got == {k: leaf_hash(k, v) for k, v in items}


def _replica_maps(seed: int, r: int, n: int = 257) -> list:
    """R leaf-hash maps over one keyspace: replica 0 the reference, each
    other one missing some keys, holding some keys of its own and carrying
    some different digests."""
    rng = np.random.default_rng(seed)
    keys = [b"k%05d" % i for i in range(n)]
    base = {k: rng.bytes(32) for k in keys}
    maps = [dict(base)]
    for _ in range(1, r):
        m = dict(base)
        for k in rng.choice(keys, size=n // 10, replace=False):
            del m[k]
        for k in rng.choice(keys, size=n // 10, replace=False):
            if k in m:
                m[k] = rng.bytes(32)
        for i in range(int(rng.integers(1, 6))):
            m[b"extra-%d-%d" % (seed, i)] = rng.bytes(32)
        maps.append(m)
    return maps


@pytest.mark.parametrize("r", [2, 3, 8])
def test_divergence_masks_engine_matches_jax(r):
    aligned = tdiff.align_replicas(_replica_maps(r, r))
    jaligned = jdiff.align_replicas(_replica_maps(r, r))
    assert aligned.keys == jaligned.keys
    got = tdiff.divergence_masks_engine(aligned.digests, aligned.present, device=CPU).numpy()
    want = np.asarray(jdiff.divergence_masks_engine(jaligned.digests, jaligned.present))
    assert got.dtype == bool and got.shape == (r, aligned.n_keys)
    assert np.array_equal(got, want)
    assert np.array_equal(got, tdiff.divergence_masks_np(aligned.digests, aligned.present))
    assert not got[0].any() and got[1:].any()


@pytest.mark.parametrize("seed", range(3))
def test_diff_keys_pair_matches_jax(seed):
    local, remote = _replica_maps(seed, 2)
    want = sorted(k for k in set(local) | set(remote) if local.get(k) != remote.get(k))
    assert tdiff.diff_keys_pair(local, remote, device=CPU) == jdiff.diff_keys_pair(local, remote) == want


@pytest.mark.parametrize("device", ["auto", "cpu", "tpu"])
def test_use_device_rule_matches_the_reference(device):
    port = tsync.SyncManager(object(), device=device, torch_device=CPU)
    ref = jsync.SyncManager(object(), device=device)
    for n in (0, 1, tsync._DEVICE_THRESHOLD - 1, tsync._DEVICE_THRESHOLD, 10**7):
        assert port._use_device(n) == ref._use_device(n), n
    assert tsync._DEVICE_THRESHOLD == jsync._DEVICE_THRESHOLD


# ------------------------------------------------------- no hidden fallback

def _fallbacks() -> int:
    return get_metrics().snapshot()["counters"].get("device.fallbacks", 0)


def _boom(*args, **kwargs):
    raise RuntimeError("injected device failure")


def test_leaf_pass_failure_is_counted_and_raised(monkeypatch):
    monkeypatch.setattr(torch_engine, "leaf_digests", _boom)
    items = _items(3, 10)
    before = _fallbacks()
    with pytest.raises(RuntimeError, match="injected"):
        tsync._leaf_map(items, True, CPU)
    assert _fallbacks() == before + 1
    # The host route is an explicit choice, and still answers.
    assert tsync._leaf_map(items, False) == {k: leaf_hash(k, v) for k, v in items}


def test_pairwise_diff_failure_is_counted_and_raised(monkeypatch):
    monkeypatch.setattr(tdiff, "diff_keys_pair", _boom)
    mgr = tsync.SyncManager(object(), device="tpu", torch_device=CPU)
    local, remote = _replica_maps(4, 2)
    before = _fallbacks()
    with pytest.raises(RuntimeError, match="injected"):
        mgr._diff(local, remote, True)
    assert _fallbacks() == before + 1
    assert mgr._diff(local, remote, False) == jdiff.diff_keys_pair(local, remote)


def _hashlib_root(items) -> str:
    level = [hashlib.sha256(struct.pack(">I", len(k)) + k + struct.pack(">I", len(v)) + v).digest()
             for k, v in sorted(items)]
    while len(level) > 1:
        nxt = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0].hex() if level else "0" * 64


@pytest.fixture
def nodes(monkeypatch):
    """Three bare torch nodes whose anti-entropy always takes the device
    route (``engine = "tpu"``), on the CPU."""
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", CPU)
    runs = []
    for _ in range(3):
        cfg = Config()
        cfg.port = 0
        cfg.anti_entropy.engine = "tpu"
        runs.append(start(cfg))
    yield runs
    for r in runs:
        r.close()


def _load(run, items) -> None:
    c = MerkleKVClient("127.0.0.1", run.port).connect()
    c.mset({k.decode(): v.decode() for k, v in items})
    c.close()


def test_failed_device_sync_answers_error_then_next_sync_converges(nodes, monkeypatch):
    a, b, _ = nodes
    _load(a, [(b"s%04d" % i, b"v%d" % i) for i in range(200)])
    _load(b, [(b"s%04d" % i, b"w%d" % i) for i in range(0, 200, 3)])
    before_b = b.engine.snapshot()
    cb = MerkleKVClient("127.0.0.1", b.port, timeout=60).connect()
    with monkeypatch.context() as m:
        m.setattr(torch_engine, "leaf_digests", _boom)
        fallbacks = _fallbacks()
        with pytest.raises(Exception, match="injected"):
            cb.sync_with("127.0.0.1", a.port)
        assert _fallbacks() > fallbacks
        assert b.engine.snapshot() == before_b  # nothing answered from the host
    assert cb.sync_with("127.0.0.1", a.port)
    assert b.engine.snapshot() == a.engine.snapshot()
    assert cb.hash() == _hashlib_root(a.engine.snapshot())
    cb.close()


class _Countdown(Deadline):
    """A cycle budget that runs out after ``checks`` looks at it."""

    def __init__(self, checks: int) -> None:
        super().__init__(None)
        self._left = checks

    def expired(self) -> bool:
        self._left -= 1
        return self._left < 0


class _ShortCycles(RetryPolicy):
    def deadline(self) -> Deadline:
        return _Countdown(3)


def test_bisect_sync_past_its_budget_resumes_and_converges(nodes, monkeypatch):
    """A walk whose cycle runs out of budget checkpoints its cursor; the
    next SYNCs resume there until the stale node holds the donor's keyspace,
    each diverged key counted once over the cycles (chip_smoke phase 8b's
    1M-key SYNC takes this path)."""
    a, b, _ = nodes
    items = [(b"r%04d" % i, b"v%d" % i) for i in range(600)]
    _load(a, items)
    pick = np.random.default_rng(5).choice(len(items), size=18, replace=False)
    changed = {items[i][0] for i in pick[:9]}
    deleted = [items[i][0] for i in pick[9:]]
    # b is the stale replica: its writes are older than a's.
    b.engine.apply_batch([(k, b"old" if k in changed else v, 1) for k, v in items])
    b.engine.apply_batch([(k, None, 2) for k in deleted])
    sm, peer = b.node.sync_manager, f"127.0.0.1:{a.port}"
    monkeypatch.setattr(sm, "_mode", "bisect")
    monkeypatch.setattr(sm, "_hash_page", 16)
    monkeypatch.setattr(sm, "_retry", _ShortCycles())
    found = []
    while not found or sm.session_for(peer) is not None:
        assert len(found) < 40, found
        rep = sm.sync_once("127.0.0.1", a.port)
        assert rep.mode == "bisect"
        found.append(rep.divergent)
    assert len(found) > 1 and sum(found) == len(changed) + len(deleted), found
    assert b.engine.snapshot() == a.engine.snapshot()
    assert b.engine.merkle_root().hex() == _hashlib_root(items)


def test_multi_sync_on_the_device_route_reports_and_repairs(nodes, monkeypatch):
    local, p1, p2 = nodes
    base = [(b"m%04d" % i, b"v%d" % i) for i in range(300)]
    _load(local, base)
    _load(p1, [(k, b"p1" if i % 25 == 0 else v) for i, (k, v) in enumerate(base)])
    _load(p2, [(k, v) for i, (k, v) in enumerate(base) if i % 30 != 1])
    calls = []
    real_leaf, real_masks = torch_engine.leaf_digests, tdiff.divergence_masks_engine

    def leaf_spy(keys, values, device=None):
        calls.append("leaf")
        return real_leaf(keys, values, device=device)

    def mask_spy(digests, present, device=None):
        calls.append("masks")
        return real_masks(digests, present, device=device)

    monkeypatch.setattr(torch_engine, "leaf_digests", leaf_spy)
    monkeypatch.setattr(tdiff, "divergence_masks_engine", mask_spy)
    peers = [f"127.0.0.1:{p1.port}", f"127.0.0.1:{p2.port}"]
    rep = local.node.sync_manager.sync_multi(peers)
    assert rep.per_peer_divergent == {peers[0]: 12, peers[1]: 10}
    assert rep.union_keys == 300 and set(calls) == {"leaf", "masks"}
    # LWW: p2 was written last and still holds every key p1 changed, so its
    # values win those; the keys p2 lacks carry no tombstone, and absence
    # never wins. The local node ends where it began.
    assert local.engine.snapshot() == base
