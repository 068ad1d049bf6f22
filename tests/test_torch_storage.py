"""The torch port's durable storage (``merklekv_tpu_torch/storage/``,
``testing/faults.py``) against the JAX package's, on the CPU.

Parity with the reference:

- the same operations and timestamps through both packages'
  ``DurableStore`` give byte-identical WAL segments and snapshot files (the
  port's snapshot root on the node's device and on the host);
- a directory written by either package recovers under the other with the
  same items, tombstones and root, and both ``walcheck --json`` reports are
  equal;
- ``compute_root_hex`` on the device path (``MERKLEKV_TORCH_DEVICE=cpu``:
  the plain versions of the kernels) equals the JAX ``engine="cpu"`` root
  and a hashlib chain for n in {0, 1, 2, 3, 4095, 4096, 4097};
- a device failure in the snapshot root is counted in
  ``device.fallbacks`` and raised, never answered from the host: the WAL
  stays intact, the node keeps accepting writes, and the pending snapshot
  succeeds once the fault heals.

Then the cases of ``tests/test_storage_{wal,snapshot,store,chaos}.py`` and
the storage cases of ``tests/test_overload.py`` (``WalErrnoInjector``,
``truncate_file``, ``corrupt_file``, ``PeerProcessKiller``) against the
port's modules and spawned ``python -m merklekv_tpu_torch`` nodes; cases
that repeat each other are parametrised. Last, the durable node as a user
runs it (``--durable``, SIGTERM, ``walcheck --json --engine tpu``, restart,
SIGKILL, restart): ``chip_smoke.py``'s phase 10 at a small size.

Every node here runs with ``MERKLEKV_TORCH_DEVICE=cpu``. Tolerance: exact
equality of bytes, roots and items.
"""

import errno
import hashlib
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from merklekv_tpu.config import StorageConfig as JaxStorageConfig
from merklekv_tpu.native_bindings import NativeEngine as JaxEngine
from merklekv_tpu.storage import DurableStore as JaxStore
from merklekv_tpu.storage import snapshot as jsnap
from merklekv_tpu.storage import walcheck as jwalcheck
from merklekv_tpu_torch.__main__ import start
from merklekv_tpu_torch.client import MerkleKVClient, ReadOnlyError, ServerBusyError
from merklekv_tpu_torch.config import Config, StorageConfig
from merklekv_tpu_torch.merkle import torch_engine
from merklekv_tpu_torch.merkle.encoding import EMPTY_ROOT_HEX, leaf_hash
from merklekv_tpu_torch.native_bindings import (
    OP_DEL,
    OP_INCR,
    OP_SET,
    OP_TRUNCATE,
    ChangeEventRaw,
    NativeEngine,
    NativeServer,
)
from merklekv_tpu_torch.storage import (
    DurableStore,
    RecoveryError,
    StorageLockedError,
    node_data_dir,
)
from merklekv_tpu_torch.storage import snapshot as snapmod
from merklekv_tpu_torch.storage import wal
from merklekv_tpu_torch.storage import walcheck as twalcheck
from merklekv_tpu_torch.storage.walcheck import check_dir, replay_root_hex
from merklekv_tpu_torch.testing.faults import (
    PeerProcessKiller,
    WalErrnoInjector,
    corrupt_file,
    truncate_file,
)
from merklekv_tpu_torch.utils.tracing import get_metrics

ROOT = Path(__file__).resolve().parents[1]
NODE_TIMEOUT = 120


@pytest.fixture(autouse=True)
def cpu_env(monkeypatch):
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")


def _hashlib_root(items) -> str:
    """sha256(u32be(len k) k u32be(len v) v) leaves over sorted keys,
    sha256(l + r) parents, an odd tail promoted."""
    level = [hashlib.sha256(struct.pack(">I", len(k)) + k + struct.pack(">I", len(v)) + v).digest()
             for k, v in sorted(items)]
    while len(level) > 1:
        nxt = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0].hex() if level else EMPTY_ROOT_HEX


def _counter(name) -> int:
    return get_metrics().snapshot()["counters"].get(name, 0)


def _wait(fn, timeout=30.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


def _cfg(**kw):
    kw.setdefault("enabled", True)
    kw.setdefault("fsync", "always")
    kw.setdefault("merkle_engine", "cpu")
    kw.setdefault("snapshot_on_shutdown", False)
    return StorageConfig(**kw)


@pytest.fixture
def engine():
    eng = NativeEngine("mem")
    yield eng
    eng.close()


def _fill(eng, store, n, base_ts=None):
    ts0 = base_ts if base_ts is not None else time.time_ns()
    for i in range(n):
        k, v = b"k%04d" % i, b"v-%d" % i
        eng.set_with_ts(k, v, ts0 + i)
        store.record_set(k, v, ts0 + i)
    return ts0


# ====================================================== parity with the JAX package

TS0 = 1_700_000_000_000_000_000
PARITY_KEYS = 4200  # past DEVICE_MIN_KEYS, so "auto" takes the device path


def _parity_ops(eng, store) -> None:
    """One fixed history: sets, a snapshot, more sets, deletes, an
    overwrite, and a second snapshot with a WAL tail behind it."""
    for i in range(PARITY_KEYS):
        k, v = b"par:%06d" % i, b"value-%d" % (i * 7)
        eng.set_with_ts(k, v, TS0 + i)
        store.record_set(k, v, TS0 + i)
    store.snapshot_now()
    for i in range(0, PARITY_KEYS, 97):
        eng.delete_with_ts(b"par:%06d" % i, TS0 + 10_000 + i)
        store.record_delete(b"par:%06d" % i, TS0 + 10_000 + i)
    eng.set_with_ts(b"par:000001", b"rewritten", TS0 + 20_000)
    store.record_set(b"par:000001", b"rewritten", TS0 + 20_000)
    store.snapshot_now()
    for i in range(5):
        k = b"tail:%d" % i
        eng.set_with_ts(k, b"t", TS0 + 30_000 + i)
        store.record_set(k, b"t", TS0 + 30_000 + i)


def _write_with(pkg: str, d: str, torch_engine_name: str = "tpu"):
    """Run the fixed history through ``pkg``'s store into ``d``; returns
    (root, items, tombstones) of the engine at the end."""
    if pkg == "jax":
        eng = JaxEngine("mem")
        st = JaxStore(eng, JaxStorageConfig(enabled=True, fsync="never", merkle_engine="cpu",
                                            snapshot_on_shutdown=False, snapshots_retained=2), d)
    else:
        eng = NativeEngine("mem")
        st = DurableStore(eng, _cfg(fsync="never", merkle_engine=torch_engine_name,
                                    snapshots_retained=2), d)
    try:
        st.recover()
        _parity_ops(eng, st)
        st.stop()
        return eng.merkle_root().hex(), eng.snapshot(), sorted(eng.tombstones())
    finally:
        eng.close()


def _files(d: str) -> dict:
    return {name: (Path(d) / name).read_bytes() for name in sorted(os.listdir(d))
            if name.endswith((".log", ".snap"))}


@pytest.mark.parametrize("root_engine", ["tpu", "auto", "cpu"])
def test_same_operations_give_byte_identical_files(tmp_path, root_engine):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = _write_with("jax", jd)
    got = _write_with("torch", td, root_engine)
    assert got == want
    jf, tf = _files(jd), _files(td)
    assert sorted(jf) == sorted(tf)
    assert any(n.endswith(".snap") for n in jf) and any(n.endswith(".log") for n in jf)
    for name in jf:
        assert tf[name] == jf[name], name


def _walcheck_json(main, d, capsys, *extra) -> dict:
    capsys.readouterr()
    assert main([d, "--json", *extra]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_a_dir_of_either_package_recovers_in_the_other(tmp_path, capsys, writer, reader):
    d = str(tmp_path / "node")
    root, items, tombs = _write_with(writer, d)
    assert root == _hashlib_root(items)
    report_j = _walcheck_json(jwalcheck.main, d, capsys)
    report_t = _walcheck_json(twalcheck.main, d, capsys, "--engine", "tpu")
    assert report_t == report_j
    assert report_t["replay_root"] == root and not report_t["errors"]
    eng = (JaxEngine if reader == "jax" else NativeEngine)("mem")
    try:
        if reader == "jax":
            st = JaxStore(eng, JaxStorageConfig(enabled=True, merkle_engine="cpu",
                                                snapshot_on_shutdown=False), d)
        else:
            st = DurableStore(eng, _cfg(merkle_engine="tpu"), d)
        rep = st.recover()
        assert rep.final_root == root and rep.snapshot_path is not None
        assert eng.merkle_root().hex() == root
        assert eng.snapshot() == items
        assert sorted(eng.tombstones()) == tombs
        st.stop()
    finally:
        eng.close()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4095, 4096, 4097])
def test_compute_root_hex_on_the_device_path_matches_jax_and_hashlib(n, monkeypatch):
    items = [(b"r:%06d" % i, b"v%d" % (i * 3)) for i in range(n)]
    want = _hashlib_root(items)
    assert jsnap.compute_root_hex(items, engine="cpu") == want
    calls = []
    real = torch_engine.tree_root
    monkeypatch.setattr(torch_engine, "tree_root",
                        lambda leaves: calls.append(leaves.shape) or real(leaves))
    assert snapmod.compute_root_hex(items, engine="tpu") == want
    assert snapmod.compute_root_hex(items, engine="auto") == want
    assert snapmod.compute_root_hex(items, engine="cpu") == want
    # "tpu" took the device path for every non-empty keyspace, "auto" only
    # from DEVICE_MIN_KEYS on.
    assert len(calls) == (0 if n == 0 else 1 + (n >= snapmod.DEVICE_MIN_KEYS))


def _injected(*_args, **_kw):
    raise RuntimeError("CUDA error: an illegal memory access was encountered (injected)")


def _frames(d) -> list:
    out = []
    for _, path in wal.list_segments(d):
        scan = wal.scan_segment(path)
        assert scan.clean, scan.error
        out.extend(scan.records)
    return out


def test_device_failure_in_the_snapshot_root_raises_and_keeps_the_wal(tmp_path, monkeypatch):
    """The port never computes a snapshot root on the host after a device
    error (the reference went on with hashlib): ``device.fallbacks`` counts
    it, the snapshot fails, the WAL is left intact, the node keeps accepting
    writes, and the pending snapshot lands once the fault heals."""
    cfg = Config()
    cfg.port = 0
    cfg.storage_path = str(tmp_path)
    cfg.storage.enabled = True
    cfg.storage.merkle_engine = "tpu"
    cfg.storage.fsync = "always"
    cfg.storage.fsync_interval_seconds = 0.02
    run = start(cfg)
    try:
        d = run.storage.directory
        items = {b"f:%04d" % i: b"v%d" % i for i in range(200)}
        with MerkleKVClient("127.0.0.1", run.port, timeout=60) as c:
            c.mset({k.decode(): v.decode() for k, v in items.items()})
            assert _wait(lambda: len(_frames(d)) == 200)
            monkeypatch.setattr(torch_engine, "tree_root", _injected)
            fallbacks, errors = _counter("device.fallbacks"), _counter("storage.compaction_errors")
            with pytest.raises(RuntimeError, match="injected"):
                run.storage.snapshot_now()
            assert _counter("device.fallbacks") == fallbacks + 1
            run.storage.request_snapshot()  # the ticker's path
            assert _wait(lambda: _counter("storage.compaction_errors") > errors)
            assert run.storage._snapshot_requested  # still pending
            assert snapmod.list_snapshots(d) == []
            assert {r.key: r.value for r in _frames(d)} == items  # the WAL is intact
            c.set("after", "fault")  # the node keeps accepting writes
            items[b"after"] = b"fault"
            assert _wait(lambda: len(_frames(d)) == 201)
            assert c.hash() == _hashlib_root(items.items())
            monkeypatch.undo()
            monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")
            assert _wait(lambda: snapmod.list_snapshots(d) != [])
            snap = snapmod.read_snapshot(snapmod.list_snapshots(d)[-1][1])
            assert snap.root_hex == _hashlib_root(items.items())
            assert _wait(lambda: not run.storage._snapshot_requested)
    finally:
        run.close()
    eng = NativeEngine("mem")
    try:
        st = DurableStore(eng, _cfg(merkle_engine="tpu"), d)
        st.recover()
        assert eng.merkle_root().hex() == _hashlib_root(items.items())
        st.stop()
    finally:
        eng.close()


def test_device_failure_in_recovery_fails_the_recovery(tmp_path, engine, monkeypatch):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(merkle_engine="tpu"), d)
    st.recover()
    _fill(engine, st, 30)
    st.snapshot_now()
    st.stop()
    monkeypatch.setattr(torch_engine, "tree_root", _injected)
    fallbacks = _counter("device.fallbacks")
    eng2 = NativeEngine("mem")
    try:
        with pytest.raises(RuntimeError, match="injected"):
            DurableStore(eng2, _cfg(merkle_engine="tpu"), d).recover()
        assert eng2.dbsize() == 0  # nothing was loaded from an unverified snapshot
    finally:
        eng2.close()
    assert _counter("device.fallbacks") == fallbacks + 1


# ============================================== snapshot cases (test_storage_snapshot.py)

def _items(n):
    return [(b"key%04d" % i, b"value-%d" % i, 10_000 + i) for i in range(n)]


def _write(tmp_path, items=None, tombs=None, wal_seq=7, root=None, seq=1):
    items = _items(30) if items is None else items
    tombs = [(b"gone", 999), (b"also-gone", 1234)] if tombs is None else tombs
    if root is None:
        root = snapmod.compute_root_hex([(k, v) for k, v, _ in items], engine="cpu")
    return snapmod.write_snapshot(str(tmp_path), seq, items, tombs, wal_seq, root)


def test_snapshot_roundtrip(tmp_path):
    items = _items(30)
    path = _write(tmp_path, items=items)
    snap = snapmod.read_snapshot(path)
    assert snap.items == items
    assert snap.tombstones == [(b"gone", 999), (b"also-gone", 1234)]
    assert snap.wal_seq == 7
    assert snapmod.verify_snapshot(snap, engine="cpu") == snap.root_hex
    assert snapmod.verify_snapshot(snap, engine="tpu") == snap.root_hex


def test_snapshot_root_matches_native_engine():
    """The stamp equals what the serving engine answers for HASH."""
    eng = NativeEngine("mem")
    try:
        for k, v, ts in _items(50):
            eng.set_with_ts(k, v, ts)
        pairs = [(k, v) for k, v, _ in _items(50)]
        assert snapmod.compute_root_hex(pairs, engine="cpu") == eng.merkle_root().hex()
        assert snapmod.compute_root_hex(pairs, engine="tpu") == eng.merkle_root().hex()
    finally:
        eng.close()


def test_empty_root_stamp(tmp_path):
    path = _write(tmp_path, items=[], tombs=[], root=EMPTY_ROOT_HEX)
    snap = snapmod.read_snapshot(path)
    assert snap.root_hex == EMPTY_ROOT_HEX
    assert snapmod.verify_snapshot(snap, engine="tpu") == EMPTY_ROOT_HEX


@pytest.mark.parametrize("damage", ["bit_rot", "short_file"])
def test_damaged_snapshot_is_corrupt(tmp_path, damage):
    path = _write(tmp_path)
    if damage == "bit_rot":
        corrupt_file(path, os.path.getsize(path) // 2)
    else:
        truncate_file(path, os.path.getsize(path) - 9)
    with pytest.raises(snapmod.SnapshotCorruptError):
        snapmod.read_snapshot(path)


@pytest.mark.parametrize("root_engine", ["cpu", "tpu"])
def test_wrong_stamp_is_root_mismatch(tmp_path, root_engine):
    bogus = leaf_hash(b"not", b"the-state").hex()
    path = _write(tmp_path, root=bogus)
    snap = snapmod.read_snapshot(path)  # CRC is fine — content is intact
    with pytest.raises(snapmod.RootMismatchError) as ei:
        snapmod.verify_snapshot(snap, engine=root_engine)
    assert ei.value.stamped == bogus
    assert ei.value.actual == _hashlib_root([(k, v) for k, v, _ in _items(30)])


def test_snapshot_listing_orders_by_seq(tmp_path):
    for seq in (3, 1, 2):
        _write(tmp_path, seq=seq)
    assert [s for s, _ in snapmod.list_snapshots(str(tmp_path))] == [1, 2, 3]


# =================================================== WAL cases (test_storage_wal.py)

def _records(n, op_every_del=5):
    recs = []
    for i in range(n):
        if i % op_every_del == op_every_del - 1:
            recs.append(wal.WalRecord(wal.OP_DEL, b"key%03d" % i, None, 1000 + i))
        else:
            recs.append(wal.WalRecord(wal.OP_SET, b"key%03d" % i, b"value-%d" % i, 1000 + i))
    return recs


def _write_segment(directory, recs, **kw):
    w = wal.WalWriter(directory, 0, fsync_policy="never", **kw)
    for r in recs:
        w.append(r)
    w.close()
    return wal.segment_path(directory, 0)


def _frame_ends(recs):
    ends = [len(wal.SEGMENT_MAGIC)]
    for r in recs:
        ends.append(ends[-1] + len(wal.encode_frame(r)))
    return ends


@pytest.mark.parametrize("case", ["all_ops", "empty_values_and_binary_keys"])
def test_wal_roundtrip(tmp_path, case):
    if case == "all_ops":
        recs = _records(20) + [wal.WalRecord(wal.OP_TRUNCATE, b"", None, 9999)]
    else:
        recs = [
            wal.WalRecord(wal.OP_SET, b"\x00\xffbin", b"", 1),
            wal.WalRecord(wal.OP_SET, b"", b"\x00" * 100, 2),
            wal.WalRecord(wal.OP_DEL, b"\xff" * 40, None, 3),
        ]
    path = _write_segment(str(tmp_path), recs)
    scan = wal.scan_segment(path)
    assert scan.clean and scan.records == recs
    assert scan.good_offset == os.path.getsize(path)


def test_wal_torn_tail_every_byte_offset(tmp_path):
    """Truncate at every byte: the scan yields exactly the whole frames
    that fit, flags the tear, and never raises."""
    recs = _records(8)
    src = _write_segment(str(tmp_path / "src"), recs)
    ends = _frame_ends(recs)
    total = os.path.getsize(src)
    assert ends[-1] == total
    work = tmp_path / "work"
    work.mkdir()
    dst = str(work / os.path.basename(src))
    for cut in range(total + 1):
        shutil.copyfile(src, dst)
        truncate_file(dst, cut)
        scan = wal.scan_segment(dst)
        n_whole = sum(1 for e in ends[1:] if e <= cut)
        assert scan.records == recs[:n_whole], cut
        if cut < len(wal.SEGMENT_MAGIC):
            assert not scan.clean
        elif cut in ends:
            assert scan.clean, (cut, scan.error)
        else:
            assert not scan.clean and scan.torn, (cut, scan.error)
            assert scan.good_offset == ends[n_whole]


@pytest.mark.parametrize("case,n,where,torn,kept", [
    # A payload byte of frame 3, well before EOF: a full frame failed its
    # CRC with more data behind it — interior corruption, not a tear.
    ("interior", 10, lambda ends, size: ends[3] + 12, False, 3),
    # Inside the FINAL frame: indistinguishable from a torn write.
    ("tail_frame", 4, lambda ends, size: size - 2, True, 3),
    ("bad_magic", 3, lambda ends, size: 0, False, 0),
])
def test_wal_damage_is_classified(tmp_path, case, n, where, torn, kept):
    recs = _records(n)
    path = _write_segment(str(tmp_path), recs)
    corrupt_file(path, where(_frame_ends(recs), os.path.getsize(path)))
    scan = wal.scan_segment(path)
    assert not scan.clean and scan.torn == torn
    assert scan.records == recs[:kept]
    if case == "interior":
        assert scan.good_offset == _frame_ends(recs)[3]


@pytest.mark.parametrize("grouped", [False, True], ids=["append", "append_many"])
def test_wal_rotation_keeps_every_record_in_order(tmp_path, grouped):
    recs = _records(50)
    w = wal.WalWriter(str(tmp_path), 0, fsync_policy="never", segment_bytes=256)
    if grouped:
        assert w.append_many(recs) == 50
    else:
        for r in recs:
            w.append(r)
    w.close()
    segs = wal.list_segments(str(tmp_path))
    assert len(segs) > 2
    assert [s for s, _ in segs] == list(range(len(segs)))
    assert w.rotations == len(segs) - 1
    assert _frames(str(tmp_path)) == recs


def test_wal_fsync_policies(tmp_path):
    recs = _records(10)
    w = wal.WalWriter(str(tmp_path / "a"), 0, fsync_policy="always")
    for r in recs:
        w.append(r)
    assert w.fsyncs >= 10
    w.close()
    w = wal.WalWriter(str(tmp_path / "b"), 0, fsync_policy="interval")
    for r in recs:
        w.append(r)
    n0 = w.fsyncs
    assert w.fsync() is True  # dirty -> flushed
    assert w.fsync() is False  # clean -> no-op
    assert w.fsyncs == n0 + 1
    w.close()
    with pytest.raises(ValueError):
        wal.WalWriter(str(tmp_path / "c"), 0, fsync_policy="bogus")


def test_wal_append_many_is_one_fsync(tmp_path):
    w = wal.WalWriter(str(tmp_path), 0, fsync_policy="always")
    assert w.append_many(_records(25)) == 25
    assert w.fsyncs == 1  # one fsync covers the whole drained batch
    w.close()
    scan = wal.scan_segment(wal.segment_path(str(tmp_path), 0))
    assert scan.clean and len(scan.records) == 25


def test_wal_reopen_with_start_offset_cuts_torn_tail(tmp_path):
    recs = _records(5)
    path = _write_segment(str(tmp_path), recs)
    truncate_file(path, os.path.getsize(path) - 3)  # tear the last frame
    scan = wal.scan_segment(path)
    assert scan.torn and len(scan.records) == 4
    w = wal.WalWriter(str(tmp_path), 0, fsync_policy="never", start_offset=scan.good_offset)
    w.append(wal.WalRecord(wal.OP_SET, b"after", b"tear", 5000))
    w.close()
    scan2 = wal.scan_segment(path)
    assert scan2.clean
    assert scan2.records == recs[:4] + [wal.WalRecord(wal.OP_SET, b"after", b"tear", 5000)]


# ===================================================== WAL errno seam (test_overload.py)

def test_wal_errno_injector_write_and_fsync(tmp_path):
    w = wal.WalWriter(str(tmp_path), 0, fsync_policy="always")
    w.append(wal.WalRecord(wal.OP_SET, b"pre", b"1", 1))
    inj = WalErrnoInjector(fail_write_at=2).install()
    try:
        # Injector counts from install: write 1 ok, write 2 on fails.
        w.append(wal.WalRecord(wal.OP_SET, b"ok", b"2", 2))
        with pytest.raises(wal.StorageFullError) as ei:
            w.append(wal.WalRecord(wal.OP_SET, b"boom", b"3", 3))
        assert ei.value.errno == errno.ENOSPC
        with pytest.raises(wal.StorageFullError):
            w.append(wal.WalRecord(wal.OP_SET, b"boom2", b"4", 4))
        inj.heal()
        w.append(wal.WalRecord(wal.OP_SET, b"post", b"5", 5))
    finally:
        inj.uninstall()
        w.close()
    w2 = wal.WalWriter(str(tmp_path / "b"), 0, fsync_policy="interval")
    inj2 = WalErrnoInjector(fail_fsync_at=1, errno_=errno.EIO, fail_count=1).install()
    try:
        w2.append(wal.WalRecord(wal.OP_SET, b"k", b"v", 1))
        with pytest.raises(wal.StorageFullError):
            w2.fsync()
        w2.append(wal.WalRecord(wal.OP_SET, b"k2", b"v", 2))
        assert w2.fsync() is True  # fail_count=1: a transient blip
        w2.close()
    finally:
        inj2.uninstall()


def test_store_survives_disk_full_and_recovers(tmp_path):
    """ENOSPC mid-burst: the drain path swallows the typed error, the store
    reports read-only, and after the disk heals the probe recovers it and a
    re-anchor snapshot restores durability of what the engine kept."""
    eng = NativeEngine("mem")
    st = DurableStore(eng, StorageConfig(), str(tmp_path))
    st.recover()
    drops0 = _counter("storage.records_dropped")
    eng.set_with_ts(b"pre", b"1", 1)
    st.record_set(b"pre", b"1", 1)
    inj = WalErrnoInjector(fail_write_at=2).install()
    try:
        eng.set_with_ts(b"ok", b"2", 2)
        st.record_set(b"ok", b"2", 2)
        eng.set_with_ts(b"lost", b"3", 3)
        st.record_set(b"lost", b"3", 3)  # fails inside; must NOT raise
        assert st.storage_full
        assert st.overload_level() == (2, "disk")
        assert _counter("storage.records_dropped") > drops0
        st._check_disk()  # still full: the probe fails through the same seam
        assert st.storage_full
        inj.heal()
        st._check_disk()
        assert not st.storage_full and st.overload_level() == (0, "")
        assert st._snapshot_requested  # re-anchor pending
        st.snapshot_now()
        st._snapshot_requested = False
    finally:
        inj.uninstall()
    st.stop()
    eng.close()
    eng2 = NativeEngine("mem")
    st2 = DurableStore(eng2, StorageConfig(), str(tmp_path))
    st2.recover()
    assert eng2.get(b"lost") == b"3" and eng2.get(b"pre") == b"1"
    st2.stop()
    eng2.close()


def test_disk_full_degrades_node_then_reconverges(tmp_path):
    """A disk-full write burst degrades the node to read-only; after space
    returns it goes back to live and an anti-entropy pass converges both
    nodes' roots bit-identically."""
    from merklekv_tpu_torch.cluster.node import ClusterNode
    from merklekv_tpu_torch.cluster.overload import LIVE, READ_ONLY

    eng_a, eng_b = NativeEngine("mem"), NativeEngine("mem")
    srv_a = NativeServer(eng_a, "127.0.0.1", 0)
    srv_a.start()
    srv_b = NativeServer(eng_b, "127.0.0.1", 0)
    srv_b.start()
    cfg_a = Config()
    cfg_a.server.watermark_interval_seconds = 0.02
    cfg_a.storage.fsync_interval_seconds = 0.01
    store = DurableStore(eng_a, cfg_a.storage, str(tmp_path / "a"))
    store.recover()
    node_a = ClusterNode(cfg_a, eng_a, srv_a, storage=store)
    node_b = ClusterNode(Config(), eng_b, srv_b)
    node_a.start()
    node_b.start()
    store.start()
    inj = WalErrnoInjector(fail_write_at=5).install()
    try:
        with MerkleKVClient("127.0.0.1", srv_a.port) as ca:
            deadline = time.time() + 10
            flipped = False
            i = 0
            while time.time() < deadline and not flipped:
                try:
                    ca.set(f"burst:{i:05d}", f"v-{i}")
                except (ServerBusyError, ReadOnlyError):
                    flipped = True
                    break
                i += 1
                if srv_a.degradation >= READ_ONLY:
                    flipped = True
            assert flipped or srv_a.degradation >= READ_ONLY
            assert node_a._health_payload()["degradation"] == "read_only"
            assert ca.get("burst:00000") == "v-0"  # reads keep serving
            inj.heal()
            assert _wait(lambda: srv_a.degradation == LIVE, timeout=10)
            assert node_a._health_payload()["degradation"] == "live"
            ca.set("after:0", "v")
        node_b.sync_manager.sync_once("127.0.0.1", srv_a.port)
        with MerkleKVClient("127.0.0.1", srv_a.port) as ca, \
                MerkleKVClient("127.0.0.1", srv_b.port) as cb:
            assert ca.hash() == cb.hash()
            assert cb.get("after:0") == "v"
        assert _counter("storage.full_recoveries") >= 1
    finally:
        inj.uninstall()
        node_a.stop()
        node_b.stop()
        store.stop()
        srv_a.close()
        srv_b.close()
        eng_a.close()
        eng_b.close()


# ================================================= store cases (test_storage_store.py)

def test_recover_roundtrip_with_tombstones(tmp_path, engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(), d)
    st.recover()
    ts0 = _fill(engine, st, 40)
    engine.delete_with_ts(b"k0007", ts0 + 100)
    st.record_delete(b"k0007", ts0 + 100)
    expect_root = engine.merkle_root().hex()
    st.stop()
    eng2 = NativeEngine("mem")
    try:
        st2 = DurableStore(eng2, _cfg(), d)
        rep = st2.recover()
        assert rep.replayed == 41
        assert eng2.merkle_root().hex() == expect_root
        assert eng2.get(b"k0007") is None
        # The tombstone kept its LWW order: an older write cannot resurrect it.
        assert not eng2.set_if_newer(b"k0007", b"stale", ts0 + 50)
        assert eng2.set_if_newer(b"k0007", b"fresh", ts0 + 200)
        st2.stop()
    finally:
        eng2.close()


@pytest.mark.parametrize("root_engine", ["cpu", "tpu"])
def test_snapshot_plus_wal_tail_is_idempotent(tmp_path, engine, root_engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(merkle_engine=root_engine), d)
    st.recover()
    _fill(engine, st, 30)
    st.snapshot_now()
    ts = time.time_ns() + 10_000
    engine.set_with_ts(b"post", b"snap", ts)
    st.record_set(b"post", b"snap", ts)
    expect_root = engine.merkle_root().hex()
    st.stop()
    eng2 = NativeEngine("mem")
    try:
        st2 = DurableStore(eng2, _cfg(merkle_engine=root_engine), d)
        rep = st2.recover()
        assert rep.snapshot_items == 30
        assert eng2.merkle_root().hex() == expect_root
        assert eng2.dbsize() == 31
        st2.stop()
    finally:
        eng2.close()


def test_torn_tail_recovery_stops_at_last_whole_record(tmp_path, engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(), d)
    st.recover()
    _fill(engine, st, 10)
    st.stop()
    seg = wal.list_segments(d)[-1][1]
    truncate_file(seg, os.path.getsize(seg) - 5)  # tear the final frame
    eng2 = NativeEngine("mem")
    try:
        st2 = DurableStore(eng2, _cfg(), d)
        rep = st2.recover()
        assert rep.torn_tail and rep.replayed == 9
        assert eng2.get(b"k0008") == b"v-8" and eng2.get(b"k0009") is None
        st2.record_set(b"new", b"write", time.time_ns())  # appends extend a clean log
        st2.stop()
    finally:
        eng2.close()
    scan = wal.scan_segment(seg)
    assert scan.clean and scan.records[-1].key == b"new"


def _restamp(d, root_hex):
    """Rewrite the newest snapshot with a bogus root: content and CRC stay
    valid, so only root verification can catch it."""
    seq, path = snapmod.list_snapshots(d)[-1]
    snap = snapmod.read_snapshot(path)
    os.unlink(path)
    snapmod.write_snapshot(d, seq, snap.items, snap.tombstones, snap.wal_seq, root_hex)


@pytest.mark.parametrize("root_engine", ["cpu", "tpu"])
def test_strict_mode_refuses_on_root_mismatch(tmp_path, engine, root_engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(), d)
    st.recover()
    _fill(engine, st, 20)
    st.snapshot_now()
    st.stop()
    _restamp(d, "ab" * 32)
    eng2 = NativeEngine("mem")
    try:
        with pytest.raises(RecoveryError, match="merklekv_tpu_torch walcheck"):
            DurableStore(eng2, _cfg(verify="strict", merkle_engine=root_engine), d).recover()
    finally:
        eng2.close()


def test_repair_mode_falls_back_to_older_snapshot(tmp_path, engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(snapshots_retained=2), d)
    st.recover()
    _fill(engine, st, 20)
    st.snapshot_now()  # snapshot 1: 20 items
    ts = time.time_ns() + 5_000
    engine.set_with_ts(b"later", b"write", ts)
    st.record_set(b"later", b"write", ts)
    expect_root = engine.merkle_root().hex()
    st.snapshot_now()  # snapshot 2: 21 items
    st.stop()
    m0 = _counter("storage.recovery_root_mismatch")
    corrupt_file(snapmod.list_snapshots(d)[-1][1], 60)  # kill the newest
    eng2 = NativeEngine("mem")
    try:
        st2 = DurableStore(eng2, _cfg(), d)
        rep = st2.recover()
        assert rep.snapshots_rejected
        assert rep.snapshot_items == 20  # the older snapshot carried the load
        assert eng2.get(b"later") == b"write"  # its WAL tail replays the rest
        assert eng2.merkle_root().hex() == expect_root
        st2.stop()
    finally:
        eng2.close()
    assert _counter("storage.recovery_root_mismatch") > m0


def test_interior_corruption_requests_reanchor_snapshot(tmp_path, engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(segment_bytes=512), d)
    st.recover()
    _fill(engine, st, 40)  # spans several 512-byte segments
    st.stop()
    segs = wal.list_segments(d)
    assert len(segs) >= 3
    corrupt_file(segs[1][1], 40)  # interior corruption in the SECOND segment
    eng2 = NativeEngine("mem")
    try:
        st2 = DurableStore(eng2, _cfg(), d)
        rep = st2.recover()
        assert rep.corruption is not None and rep.replayed > 0
        assert st2._snapshot_requested  # the ticker will re-anchor promptly
        st2.snapshot_now()
        post_root = eng2.merkle_root().hex()
        st2.stop()
    finally:
        eng2.close()
    eng3 = NativeEngine("mem")
    try:
        st3 = DurableStore(eng3, _cfg(), d)
        rep3 = st3.recover()
        assert rep3.corruption is None
        assert eng3.merkle_root().hex() == post_root
        st3.stop()
    finally:
        eng3.close()


def test_lock_rejects_second_owner(tmp_path, engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(), d)
    st.recover()
    eng2 = NativeEngine("mem")
    try:
        with pytest.raises(StorageLockedError):
            DurableStore(eng2, _cfg(), d)
    finally:
        eng2.close()
    st.stop()
    eng3 = NativeEngine("mem")  # released on stop: a successor may take it
    try:
        st3 = DurableStore(eng3, _cfg(), d)
        st3.recover()
        st3.stop()
    finally:
        eng3.close()


def test_record_raw_event_mapping(tmp_path, engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(), d)
    st.recover()
    ts = time.time_ns()
    st.record_raw([
        ChangeEventRaw(OP_SET, True, ts + 1, 1, b"a", b"1"),
        ChangeEventRaw(OP_INCR, True, ts + 2, 2, b"ctr", b"5"),
        ChangeEventRaw(OP_DEL, False, ts + 3, 3, b"a", b""),
        ChangeEventRaw(OP_TRUNCATE, False, ts + 4, 4, b"", b""),
        ChangeEventRaw(OP_SET, True, ts + 5, 5, b"b", b"2"),
    ])
    st.stop()
    scan = wal.scan_segment(wal.list_segments(d)[0][1])
    assert [r.op for r in scan.records] == [
        wal.OP_SET, wal.OP_SET, wal.OP_DEL, wal.OP_TRUNCATE, wal.OP_SET]
    eng2 = NativeEngine("mem")
    try:
        DurableStore(eng2, _cfg(), d).recover()
        assert eng2.scan() == [b"b"]  # everything before the TRUNCATE is gone
    finally:
        eng2.close()


def test_compaction_retention(tmp_path, engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(snapshots_retained=2, segment_bytes=512), d)
    st.recover()
    for _ in range(3):
        _fill(engine, st, 40, base_ts=time.time_ns())
        st.compact()
    snaps = snapmod.list_snapshots(d)
    assert len(snaps) == 2  # retention pruned the oldest
    oldest_needed = min(snapmod.read_snapshot(p).wal_seq for _, p in snaps)
    assert all(s >= oldest_needed for s, _ in wal.list_segments(d))
    expect_root = engine.merkle_root().hex()
    st.stop()
    eng2 = NativeEngine("mem")
    try:
        st2 = DurableStore(eng2, _cfg(), d)
        st2.recover()
        assert eng2.merkle_root().hex() == expect_root
        st2.stop()
    finally:
        eng2.close()


def test_storage_metrics_counters(tmp_path, engine):
    before = get_metrics().snapshot()["counters"]
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(), d)
    st.recover()
    _fill(engine, st, 15)
    st.snapshot_now()
    ts = time.time_ns() + 1_000
    engine.set_with_ts(b"tail", b"record", ts)
    st.record_set(b"tail", b"record", ts)
    st.stop()
    eng2 = NativeEngine("mem")
    try:
        DurableStore(eng2, _cfg(), d).recover()
    finally:
        eng2.close()
    after = get_metrics().snapshot()
    c = after["counters"]
    for name, by in (("storage.wal_appends", 15), ("storage.wal_fsyncs", 1),
                     ("storage.snapshots", 1), ("storage.recovery_replayed", 1),
                     ("storage.recoveries", 2)):
        assert c.get(name, 0) >= before.get(name, 0) + by, name
    assert "storage.snapshot" in after["spans"] and "storage.recovery" in after["spans"]


@pytest.mark.parametrize("root_engine", ["cpu", "tpu"])
def test_walcheck_clean_dir_and_replay_root(tmp_path, engine, root_engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(), d)
    st.recover()
    ts0 = _fill(engine, st, 25)
    engine.delete_with_ts(b"k0003", ts0 + 90)
    st.record_delete(b"k0003", ts0 + 90)
    st.snapshot_now()
    expect_root = engine.merkle_root().hex()
    st.stop()
    report = check_dir(d, engine=root_engine)
    assert not report["errors"] and not report["warnings"]
    assert report["replay_root"] == expect_root and report["live_keys"] == 24
    assert replay_root_hex(d, engine=root_engine) == expect_root


def test_walcheck_flags_torn_tail_as_warning_and_compacts(tmp_path, engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(), d)
    st.recover()
    _fill(engine, st, 12)
    st.stop()
    seg = wal.list_segments(d)[-1][1]
    truncate_file(seg, os.path.getsize(seg) - 4)
    report = check_dir(d)
    assert not report["errors"]  # a torn tail is recoverable, not fatal
    assert any("torn tail" in w for w in report["warnings"])
    assert report["live_keys"] == 11
    assert twalcheck.main([d, "--compact", "--engine", "tpu"]) == 0
    assert len(snapmod.list_snapshots(d)) == 1 and wal.list_segments(d) == []
    eng2 = NativeEngine("mem")
    try:
        st2 = DurableStore(eng2, _cfg(), d)
        rep = st2.recover()
        assert rep.snapshot_items == 11 and eng2.get(b"k0010") == b"v-10"
        st2.stop()
    finally:
        eng2.close()


def test_walcheck_flags_root_mismatch_as_error(tmp_path, engine):
    d = str(tmp_path / "node")
    st = DurableStore(engine, _cfg(), d)
    st.recover()
    _fill(engine, st, 10)
    st.snapshot_now()
    st.stop()
    _restamp(d, "cd" * 32)
    report = check_dir(d)
    assert any("root mismatch" in e for e in report["errors"])
    assert twalcheck.main([d]) == 1


def test_replication_writes_reach_the_wal(tmp_path):
    """With replication on, the Replicator owns the event-queue drain: local
    writes reach the WAL through its batch listener and remote applies
    through the storage hook; both survive recovery."""
    import uuid

    from merklekv_tpu_torch.cluster.node import ClusterNode
    from merklekv_tpu_torch.cluster.transport import TcpBroker

    broker = TcpBroker()
    topic = f"st-{uuid.uuid4().hex[:8]}"
    nodes = []
    try:
        for i in (1, 2):
            eng = NativeEngine("mem")
            srv = NativeServer(eng, "127.0.0.1", 0)
            srv.start()
            cfg = Config()
            cfg.replication.enabled = True
            cfg.replication.mqtt_broker = broker.host
            cfg.replication.mqtt_port = broker.port
            cfg.replication.topic_prefix = topic
            cfg.replication.client_id = f"n{i}"
            cfg.anti_entropy.engine = "cpu"  # no device mirror in this test
            store = DurableStore(eng, _cfg(), str(tmp_path / f"n{i}"))
            store.recover()
            node = ClusterNode(cfg, eng, srv, storage=store)
            node.start()
            nodes.append((eng, srv, store, node, MerkleKVClient("127.0.0.1", srv.port).connect()))
        c1, c2 = nodes[0][4], nodes[1][4]
        c1.set("local-write", "from-n1")
        assert _wait(lambda: c2.get("local-write") == "from-n1", timeout=5)
        roots = [eng.merkle_root().hex() for eng, *_ in nodes]
        assert roots[0] == roots[1]
    finally:
        dirs = []
        for eng, srv, store, node, client in nodes:
            client.close()
            node.stop()
            store.stop()
            dirs.append(store.directory)
            srv.close()
            eng.close()
        broker.close()
    for d in dirs:
        eng = NativeEngine("mem")
        try:
            st = DurableStore(eng, _cfg(), d)
            st.recover()
            assert eng.get(b"local-write") == b"from-n1"
            assert eng.merkle_root().hex() == roots[0]
            st.stop()
        finally:
            eng.close()


# ============================================ crash chaos (test_storage_chaos.py)

def _spawn(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), MERKLEKV_TORCH_DEVICE="cpu")
    return subprocess.Popen([sys.executable, *args], cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        sk = socket.socket()
        sk.bind(("127.0.0.1", 0))
        ports.append(sk.getsockname()[1])
        socks.append(sk)
    for sk in socks:
        sk.close()
    return ports


def _await_ready(proc, port, timeout=NODE_TIMEOUT):
    line = proc.stdout.readline()
    assert "listening on" in line, f"unexpected startup line: {line!r}"
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"port {port} never came up")


def _reap(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def _storage_toml(path, port, data_dir, extra=""):
    path.write_text(f"""
host = "127.0.0.1"
port = {port}
engine = "mem"
storage_path = "{data_dir}"

[storage]
enabled = true
fsync = "always"
merkle_engine = "cpu"
{extra}
""")
    return str(path)


def _wal_payload_bytes(node_dir):
    return sum(max(0, os.path.getsize(p) - len(wal.SEGMENT_MAGIC))
               for _, p in wal.list_segments(node_dir))


def _burst_writer(port, key_fmt):
    """Background writer hammering SET on one connection; ``acked`` grows
    with every acknowledged write until the connection dies at the kill."""
    state = {"acked": 0, "done": threading.Event()}

    def run():
        try:
            with MerkleKVClient("127.0.0.1", port) as c:
                for i in range(200_000):
                    c.set(key_fmt % i, f"val-{i}")
                    state["acked"] += 1
        except Exception:
            pass  # the connection dies at the kill — expected
        finally:
            state["done"].set()

    threading.Thread(target=run, daemon=True).start()
    return state


def _crash_cycle(cfg, port, node_dir, key_fmt, min_acked, min_bytes):
    """Start the node from ``cfg``, SIGKILL it mid-burst once ``min_bytes``
    more of framed records are on disk; returns the acked count."""
    p = _spawn(["-m", "merklekv_tpu_torch", "--config", cfg])
    try:
        _await_ready(p, port)
        state = _burst_writer(port, key_fmt)
        baseline = _wal_payload_bytes(node_dir) if os.path.isdir(node_dir) else 0
        killed = PeerProcessKiller(p).kill_when(
            lambda: state["acked"] >= min_acked
            and _wal_payload_bytes(node_dir) > baseline + min_bytes,
            timeout=30,
        )
        state["done"].wait(timeout=10)
        assert killed, f"only {state['acked']} acks before the deadline"
        return state["acked"]
    finally:
        _reap([p])


@pytest.mark.integration
def test_kill9_midburst_recovered_root_matches_disk(tmp_path):
    """SIGKILL mid-burst, walcheck the surviving bytes offline, restart: the
    served HASH equals the offline root, and the durable keys are a prefix
    of the burst."""
    (port,) = _free_ports(1)
    data = tmp_path / "data"
    cfg = _storage_toml(tmp_path / "node.toml", port, data)
    node_dir = node_data_dir(str(data), port)
    acked = _crash_cycle(cfg, port, node_dir, "cr:%06d", 200, 2048)
    report = check_dir(node_dir)
    assert not report["errors"], report["errors"]
    assert report["live_keys"] > 0
    p2 = _spawn(["-m", "merklekv_tpu_torch", "--config", cfg])
    try:
        _await_ready(p2, port)
        with MerkleKVClient("127.0.0.1", port) as c:
            assert c.hash() == report["replay_root"]
            keys = c.scan("cr:")
            assert len(keys) == report["live_keys"]
            idxs = sorted(int(k.split(":")[1]) for k in keys)
            assert idxs == list(range(len(idxs))) and len(idxs) <= acked + 1
            c.set("post-recovery", "alive")
            assert c.get("post-recovery") == "alive"
    finally:
        _reap([p2])


@pytest.mark.integration
def test_kill9_recovery_then_anti_entropy_reconverges(tmp_path):
    """Kill -9 one node of a 2-node anti-entropy pair mid-burst, restart it
    from disk: the cluster converges to one root without intervention."""
    port_a, port_b = _free_ports(2)
    data = tmp_path / "data"
    ae = """
[anti_entropy]
enabled = true
interval_seconds = 0.3
engine = "cpu"
multi_peer = true
peers = ["127.0.0.1:%d"]
"""
    cfg_a = _storage_toml(tmp_path / "a.toml", port_a, data, extra=ae % port_b)
    cfg_b = _storage_toml(tmp_path / "b.toml", port_b, data, extra=ae % port_a)
    pb = _spawn(["-m", "merklekv_tpu_torch", "--config", cfg_b])
    pa2 = None
    try:
        _await_ready(pb, port_b)
        _crash_cycle(cfg_a, port_a, node_data_dir(str(data), port_a), "burst:%06d", 150, 1024)
        with MerkleKVClient("127.0.0.1", port_b) as cb:
            for i in range(20):
                cb.set(f"bonly:{i:03d}", f"bv-{i}")
        pa2 = _spawn(["-m", "merklekv_tpu_torch", "--config", cfg_a])
        _await_ready(pa2, port_a)
        with MerkleKVClient("127.0.0.1", port_a) as ca, MerkleKVClient("127.0.0.1", port_b) as cb:
            recovered = len(ca.scan("burst:"))
            assert recovered > 0
            assert _wait(lambda: ca.hash() == cb.hash() and ca.get("bonly:000") is not None,
                         timeout=30), "cluster failed to re-converge"
            assert ca.get("bonly:019") == "bv-19"
            assert len(cb.scan("burst:")) >= recovered
    finally:
        _reap([p for p in (pb, pa2) if p is not None])


@pytest.mark.slow
def test_soak_repeated_kill_restart_cycles(tmp_path):
    (port,) = _free_ports(1)
    data = tmp_path / "data"
    cfg = _storage_toml(tmp_path / "node.toml", port, data,
                        extra="segment_bytes = 8192\ncompact_trigger_bytes = 32768\n")
    node_dir = node_data_dir(str(data), port)
    prev_keys = 0
    for cycle in range(4):
        _crash_cycle(cfg, port, node_dir, f"c{cycle}:%06d", 150, 1024)
        report = check_dir(node_dir)
        assert not report["errors"], (cycle, report["errors"])
        assert report["live_keys"] > prev_keys
        prev_keys = report["live_keys"]
        p2 = _spawn(["-m", "merklekv_tpu_torch", "--config", cfg])
        try:
            _await_ready(p2, port)
            with MerkleKVClient("127.0.0.1", port) as c:
                assert c.hash() == report["replay_root"], f"cycle {cycle}"
                assert c.dbsize() == prev_keys
        finally:
            _reap([p2])


# ==================================== the durable node as a user runs it (phase 10)

def _durable_node(data, port: int):
    p = _spawn(["-m", "merklekv_tpu_torch", "--durable", "--storage-path", str(data),
                "--port", str(port)])
    line = p.stdout.readline()
    if not line.startswith("merklekv_tpu_torch listening on "):
        p.kill()
        raise AssertionError(f"no readiness line: {line!r} {p.stdout.read()[-2000:]}")
    storage_line = p.stdout.readline()
    assert storage_line.startswith("storage: recovered "), storage_line
    return p, int(line.split()[3].rsplit(":", 1)[1]), storage_line


@pytest.mark.integration
def test_durable_node_sigterm_walcheck_restart_sigkill_restart(tmp_path):
    data = tmp_path / "data"
    items = {b"inc:%09d" % i: b"v%d" % i for i in range(600)}
    procs = []
    try:
        p, port, _ = _durable_node(data, 0)
        procs.append(p)
        with MerkleKVClient("127.0.0.1", port, timeout=60) as c:
            c.mset({k.decode(): v.decode() for k, v in items.items()})
            assert c.hash() == _hashlib_root(items.items())
        p.send_signal(signal.SIGTERM)
        assert p.wait(NODE_TIMEOUT) == 0
        node_dir = node_data_dir(str(data), port)
        assert len(snapmod.list_snapshots(node_dir)) == 1  # the shutdown snapshot
        out = subprocess.run(
            [sys.executable, "-m", "merklekv_tpu_torch", "walcheck", node_dir, "--json",
             "--engine", "tpu"],
            cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
            capture_output=True, text=True, timeout=NODE_TIMEOUT)
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout)["replay_root"] == _hashlib_root(items.items())

        p, port2, storage_line = _durable_node(data, port)
        procs.append(p)
        assert port2 == port and "(600 items)" in storage_line
        with MerkleKVClient("127.0.0.1", port, timeout=60) as c:
            assert c.hash() == _hashlib_root(items.items())
            batch = {b"inc:%09d" % i: b"w%d" % i for i in range(0, 1200, 3)}
            c.mset({k.decode(): v.decode() for k, v in batch.items()})
            items.update(batch)
        time.sleep(0.3)  # the WAL drain
        p.send_signal(signal.SIGKILL)
        p.wait(NODE_TIMEOUT)

        p, _, storage_line = _durable_node(data, port)
        procs.append(p)
        assert "WAL records" in storage_line
        with MerkleKVClient("127.0.0.1", port, timeout=60) as c:
            assert c.hash() == _hashlib_root(items.items())
        p.send_signal(signal.SIGTERM)
        assert p.wait(NODE_TIMEOUT) == 0
    finally:
        _reap(procs)
