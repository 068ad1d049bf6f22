"""Snapshot bootstrap of a joining node in the torch port, on the CPU.

The cases of ``tests/test_bootstrap.py`` against the port's
``cluster/bootstrap.py``, ``ClusterNode`` and durable store, with the JAX
file's ``slow`` marks kept: a rejoin converging cheaper than the walk, the
read gate closed until VERIFY passes, corrupt donors quarantined, donor
failover, chunk resume, WAL-corruption-triggered bootstrap, SNAPCHUNK
fuzz. Then:

- a torch joiner bootstraps from a JAX donor, and a JAX joiner from a torch
  donor, node to node, ending at equal roots; the torch side verifies the
  snapshot on the node's device;
- a wiped ``python -m merklekv_tpu_torch --durable`` replica restarted with
  ``[bootstrap] enabled`` bootstraps from its sibling, its snapshot verified
  and its mirror built on the node's device (``chip_smoke.py``'s phase 12
  (c) at a small size);
- a device failure in the snapshot verification is counted in
  ``device.fallbacks`` and fails the session; the snapshot is never
  verified on the host and nothing unverified is installed.

Every node here runs with ``MERKLEKV_TORCH_DEVICE=cpu`` (the kernels'
plain versions). Tolerance: exact equality of roots.
"""

import base64
import os
import random
import shutil
import socket
import subprocess
import sys
import threading
import time
import zlib

import pytest

import merklekv_tpu.cluster.node as jnode
import merklekv_tpu.config as jconfig
import merklekv_tpu.native_bindings as jnative
import merklekv_tpu.storage as jstorage
from merklekv_tpu_torch.client import (
    ChunkIntegrityError,
    MerkleKVClient,
    MerkleKVError,
    ProtocolError,
)
from merklekv_tpu_torch.cluster.bootstrap import BootstrapSession
from merklekv_tpu_torch.cluster.node import ClusterNode
from merklekv_tpu_torch.cluster.sync import SyncManager
from merklekv_tpu_torch.config import BootstrapConfig, Config
from merklekv_tpu_torch.native_bindings import NativeEngine, NativeServer
from merklekv_tpu_torch.storage import DurableStore
from merklekv_tpu_torch.storage import snapshot as snapmod
from merklekv_tpu_torch.testing.faults import FaultInjector, corrupt_file
from merklekv_tpu_torch.utils.tracing import get_metrics

pytestmark = pytest.mark.integration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_env(monkeypatch):
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")


def wait_for(fn, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


class Donor:
    """A running storage-backed node that can serve SNAPMETA/SNAPCHUNK."""

    def __init__(self, data_dir: str, n_keys: int = 0, key_fmt: bytes = b"k%06d"):
        self.cfg = Config()
        self.cfg.storage.enabled = True
        self.cfg.storage.merkle_engine = "cpu"
        self.cfg.anti_entropy.engine = "cpu"
        self.engine = NativeEngine("mem")
        self.storage = DurableStore(self.engine, self.cfg.storage, data_dir)
        self.storage.recover()
        self.server = NativeServer(self.engine, "127.0.0.1", 0)
        self.server.start()
        self.node = ClusterNode(self.cfg, self.engine, self.server,
                                storage=self.storage)
        self.node.start()
        for i in range(n_keys):
            self.engine.set(key_fmt % i, b"v%06d" % i)

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.server.port}"

    def close(self):
        self.node.stop()
        self.storage.stop()
        self.server.close()
        self.engine.close()


def _joiner_session(peers, chunk_bytes=65536, chunk_retries=6):
    engine = NativeEngine("mem")
    mgr = SyncManager(engine, device="cpu")
    cfg = BootstrapConfig(chunk_bytes=chunk_bytes, chunk_retries=chunk_retries)
    sess = BootstrapSession(engine, mgr, peers, cfg, merkle_engine="cpu")
    return engine, sess


def test_rejoin_bootstrap_converges_cheaper_than_walk(tmp_path):
    """The headline chaos case: a 2-node cluster member dies, the survivor
    absorbs 100K keys, and the member rejoins from nothing. Bootstrap must
    converge to a bit-identical root with wire bytes < 25% of what the
    walk-only rebuild pays for the same state."""
    donor = Donor(str(tmp_path / "a"))
    try:
        # The 2-node membership, then the death: the peer holds a few keys,
        # dies hard (no shutdown path), and its disk is gone — the
        # long-dead-replica shape.
        member = NativeEngine("mem")
        mgr0 = SyncManager(member, device="cpu")
        donor.engine.set(b"seed", b"1")
        mgr0.sync_once("127.0.0.1", donor.server.port)
        assert member.merkle_root() == donor.engine.merkle_root()
        member.close()  # kill: state discarded

        # 100K keys land on the survivor while the member is dead.
        for i in range(100_000):
            donor.engine.set(b"k%06d" % i, b"v%06d" % i)

        # Rejoin with bootstrap: snapshot shipping + delta walk.
        eng_b, sess = _joiner_session([donor.addr])
        try:
            report = sess.run("empty-keyspace")
            assert report.mode == "snapshot", report.details
            assert sess.state == "live"
            root_a = donor.engine.merkle_root()
            assert root_a is not None
            assert eng_b.merkle_root() == root_a  # bit-identical
            assert report.snapshot_items == 100_001
            boot_bytes = report.wire_bytes
            assert boot_bytes > 0
        finally:
            eng_b.close()

        # Walk-only rebuild of the identical state, for the A/B.
        eng_c = NativeEngine("mem")
        try:
            mgr = SyncManager(eng_c, device="cpu")
            rep = mgr.sync_once("127.0.0.1", donor.server.port)
            assert eng_c.merkle_root() == root_a
            walk_bytes = rep.bytes_sent + rep.bytes_received
        finally:
            eng_c.close()

        assert boot_bytes < 0.25 * walk_bytes, (
            f"bootstrap {boot_bytes}B not < 25% of walk-only {walk_bytes}B"
        )
    finally:
        donor.close()


def test_reads_blocked_until_verify_over_throttled_link(tmp_path):
    """Zero reads serve before VERIFY passes. The donor link is bandwidth-
    throttled (token-bucket fault) so the FETCH window is wide enough to
    probe: a GET against the bootstrapping node must answer ERROR LOADING,
    and the same GET serves the verified value once the session goes
    live — exercising slow-link shipping end to end."""
    donor = Donor(str(tmp_path / "a"), n_keys=8000)
    inj = FaultInjector("127.0.0.1", donor.server.port, seed=11)
    inj.set_faults("s2c", bandwidth_bytes_per_s=32 * 1024)
    eng_b = NativeEngine("mem")
    srv_b = NativeServer(eng_b, "127.0.0.1", 0)
    srv_b.start()
    cfg_b = Config()
    cfg_b.bootstrap.enabled = True
    cfg_b.bootstrap.chunk_bytes = 16384
    cfg_b.anti_entropy.peers = [f"{inj.host}:{inj.port}"]
    cfg_b.anti_entropy.engine = "cpu"
    cfg_b.storage.merkle_engine = "cpu"
    node_b = ClusterNode(cfg_b, eng_b, srv_b)
    try:
        node_b.start()
        sess = node_b.bootstrap
        assert sess is not None
        deadline = time.time() + 30
        while time.time() < deadline and sess.state not in ("fetch", "verify"):
            time.sleep(0.005)
        assert sess.state in ("fetch", "verify"), sess.state

        with MerkleKVClient("127.0.0.1", srv_b.port, timeout=5) as c:
            with pytest.raises(ProtocolError, match="LOADING"):
                c.get("k000123")

        deadline = time.time() + 60
        while time.time() < deadline and sess.state not in ("live", "failed"):
            time.sleep(0.01)
        assert sess.state == "live", (sess.state, sess.report.details)
        assert sess.report.mode == "snapshot"
        assert inj.chunks_throttled > 0

        with MerkleKVClient("127.0.0.1", srv_b.port, timeout=5) as c:
            assert c.get("k000123") == "v000123"
        assert eng_b.merkle_root() == donor.engine.merkle_root()
    finally:
        node_b.stop()
        srv_b.close()
        eng_b.close()
        inj.close()
        donor.close()


def _plant_bogus_snapshot(donor: Donor) -> None:
    """Install a NEWER snapshot whose body is valid (CRC passes, chunks
    ship cleanly) but whose stamped root is a lie — the donor-is-suspect
    case only the joiner's local verify can catch."""
    donor.storage.snapshot_now()
    snaps = snapmod.list_snapshots(donor.storage.directory)
    seq, path = snaps[-1]
    good = snapmod.read_snapshot(path)
    snapmod.write_snapshot(
        donor.storage.directory,
        seq + 1,
        good.items,
        good.tombstones,
        good.wal_seq,
        "11" * 32,  # stamped root does not match the content
    )


def test_corrupt_donor_snapshot_rejected_walk_fallback(tmp_path):
    """A donor whose newest snapshot fails stamp verification is
    quarantined; with no other donor the joiner still converges via the
    plain anti-entropy walk — and never serves the rejected state."""
    donor = Donor(str(tmp_path / "a"), n_keys=3000)
    _plant_bogus_snapshot(donor)
    eng_b, sess = _joiner_session([donor.addr])
    try:
        report = sess.run("empty-keyspace")
        assert donor.addr in report.suspects
        assert report.mode == "walk", report.details
        assert sess.state == "live"
        assert eng_b.merkle_root() == donor.engine.merkle_root()
    finally:
        eng_b.close()
        donor.close()


def test_corrupt_donor_snapshot_second_donor_serves(tmp_path):
    """Donor 1 ships garbage (stamp mismatch), donor 2 is healthy: the
    joiner quarantines the first and completes the verified transfer from
    the second."""
    bad = Donor(str(tmp_path / "a"), n_keys=3000)
    good = Donor(str(tmp_path / "b"), n_keys=3000)
    _plant_bogus_snapshot(bad)
    eng_b, sess = _joiner_session([bad.addr, good.addr])
    try:
        report = sess.run("empty-keyspace")
        assert report.suspects == [bad.addr]
        assert report.mode == "snapshot", report.details
        assert report.donor == good.addr
        assert eng_b.merkle_root() == good.engine.merkle_root()
    finally:
        eng_b.close()
        bad.close()
        good.close()


def test_mid_transfer_donor_death_fails_over(tmp_path):
    """The donor dies mid-FETCH (proxy kill after a byte budget): the
    joiner fails over to the second donor and still completes a verified
    snapshot transfer."""
    dying = Donor(str(tmp_path / "a"), n_keys=6000)
    healthy = Donor(str(tmp_path / "b"), n_keys=6000)
    inj = FaultInjector("127.0.0.1", dying.server.port, seed=3)
    # Enough budget for SNAPMETA + the first chunks, then death mid-stream.
    inj.kill_after_bytes(24 * 1024, "s2c")
    eng_b, sess = _joiner_session(
        [f"{inj.host}:{inj.port}", healthy.addr], chunk_bytes=8192,
        chunk_retries=2,
    )
    try:
        report = sess.run("empty-keyspace")
        assert report.mode == "snapshot", report.details
        assert report.donor == healthy.addr
        assert report.donor_failovers >= 1
        assert eng_b.merkle_root() == healthy.engine.merkle_root()
    finally:
        eng_b.close()
        inj.close()
        dying.close()
        healthy.close()


def test_chunk_resume_after_dropped_links(tmp_path):
    """Random stream kills (drop fault) during FETCH: per-offset retries
    reconnect and resume at the checkpoint — the transfer completes and
    the verified prefix is never refetched wholesale."""
    donor = Donor(str(tmp_path / "a"), n_keys=8000)
    inj = FaultInjector("127.0.0.1", donor.server.port, seed=1234)
    inj.set_faults("s2c", drop_rate=0.08)
    eng_b, sess = _joiner_session(
        [f"{inj.host}:{inj.port}"], chunk_bytes=8192, chunk_retries=8
    )
    try:
        report = sess.run("empty-keyspace")
        assert eng_b.merkle_root() == donor.engine.merkle_root()
        assert inj.chunks_dropped > 0
        assert report.chunk_retries > 0
        if report.mode == "snapshot":
            # Raw bytes assembled exactly once despite the retries: the
            # fetch total equals the artifact size, not a multiple of it.
            import os

            path = snapmod.snapshot_path(
                donor.storage.directory, report.snapshot_seq
            )
            assert report.bytes_fetched == os.path.getsize(path)
    finally:
        eng_b.close()
        inj.close()
        donor.close()


def test_wal_corruption_triggers_peer_bootstrap(tmp_path):
    """The interior-WAL-corruption recovery restores only a verified
    prefix and re-anchors locally; with [bootstrap] enabled the node now
    ALSO closes the data hole from a healthy peer instead of waiting out
    a worst-case walk."""
    keys = [(b"w%05d" % i, b"val%05d" % i) for i in range(400)]
    donor = Donor(str(tmp_path / "a"))
    for k, v in keys:
        donor.engine.set(k, v)

    # Build the corrupted-WAL member: journal every key, crash without a
    # shutdown snapshot, then flip a byte mid-log (interior corruption).
    cfg_b = Config()
    cfg_b.storage.enabled = True
    cfg_b.storage.merkle_engine = "cpu"
    cfg_b.storage.snapshot_on_shutdown = False
    cfg_b.storage.fsync = "never"
    b_dir = str(tmp_path / "b")
    eng_tmp = NativeEngine("mem")
    st = DurableStore(eng_tmp, cfg_b.storage, b_dir)
    st.recover()
    now = time.time_ns()
    for k, v in keys:
        st.record_set(k, v, now)
    st.stop()
    eng_tmp.close()
    from merklekv_tpu_torch.storage import wal as walmod

    seg_path = walmod.list_segments(b_dir)[0][1]
    import os

    corrupt_file(seg_path, os.path.getsize(seg_path) // 2)

    # Restart the member: recovery reports corruption, bootstrap fires.
    eng_b = NativeEngine("mem")
    store_b = DurableStore(eng_b, cfg_b.storage, b_dir)
    report = store_b.recover()
    assert report.corruption is not None
    assert 0 < eng_b.dbsize() < len(keys)  # verified prefix only
    srv_b = NativeServer(eng_b, "127.0.0.1", 0)
    srv_b.start()
    cfg_b.bootstrap.enabled = True
    cfg_b.anti_entropy.peers = [donor.addr]
    cfg_b.anti_entropy.engine = "cpu"
    node_b = ClusterNode(cfg_b, eng_b, srv_b, storage=store_b)
    try:
        node_b.start()
        sess = node_b.bootstrap
        assert sess is not None
        deadline = time.time() + 60
        while time.time() < deadline and sess.state not in ("live", "failed"):
            time.sleep(0.01)
        assert sess.state == "live", (sess.state, sess.report.details)
        assert sess.report.reason == "wal-corruption"
        assert eng_b.merkle_root() == donor.engine.merkle_root()
    finally:
        node_b.stop()
        store_b.stop()
        srv_b.close()
        eng_b.close()
        donor.close()


def test_snapmeta_building_is_polled_not_degraded(tmp_path):
    """A donor with a live compaction ticker and no artifact yet must NOT
    block the SNAPMETA handler on an O(keyspace) snapshot write: it
    answers the transient 'building; retry' error while the background
    ticker writes the artifact, and the joiner polls it out — staying on
    the bulk path instead of degrading to the walk."""
    donor = Donor(str(tmp_path / "a"), n_keys=3000)
    donor.storage.start()  # background ticker owns the snapshot build
    try:
        with MerkleKVClient("127.0.0.1", donor.server.port) as c:
            try:
                c.snap_meta()
                polled = False  # ticker won the race — still fine
            except ProtocolError as e:
                assert "retry" in str(e).lower()
                polled = True
        eng_b, sess = _joiner_session([donor.addr])
        try:
            report = sess.run("empty-keyspace")
            assert report.mode == "snapshot", (polled, report.details)
            assert eng_b.merkle_root() == donor.engine.merkle_root()
        finally:
            eng_b.close()
    finally:
        donor.close()


def test_capability_fallback_donor_without_storage(tmp_path):
    """A peer without durable storage answers SNAPMETA with ERROR (same
    for an old-version peer without the verb): the joiner degrades to the
    plain anti-entropy walk and still converges."""
    engine = NativeEngine("mem")
    server = NativeServer(engine, "127.0.0.1", 0)
    server.start()
    node = ClusterNode(Config(), engine, server)  # no storage plane
    node.start()
    for i in range(500):
        engine.set(b"c%04d" % i, b"x%04d" % i)
    eng_b, sess = _joiner_session([f"127.0.0.1:{server.port}"])
    try:
        report = sess.run("empty-keyspace")
        assert report.mode == "walk", report.details
        assert not report.suspects  # capability miss is NOT a quarantine
        assert eng_b.merkle_root() == engine.merkle_root()
    finally:
        eng_b.close()
        node.stop()
        server.close()
        engine.close()


# ---------------------------------------------------------------- fuzzing


class _CannedServer:
    """One-shot TCP server: per connection, read one line, send the canned
    (possibly mutated) bytes, close — the smallest hostile donor."""

    def __init__(self):
        self._listener = socket.socket()
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self.port = self._listener.getsockname()[1]
        self.payload = b""
        self._stop = False
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                conn.settimeout(2)
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = conn.recv(256)
                    if not chunk:
                        break
                    buf += chunk
                conn.sendall(self.payload)
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self):
        self._stop = True
        try:
            self._listener.close()
        except OSError:
            pass


def test_snapchunk_fuzz_truncations_and_bitflips():
    """Wire-path decode fuzzing (mirrors the envelope fuzz suite):
    EVERY truncation offset of a CHUNK response, plus seeded byte flips,
    must surface as a clean client-side error — retried by the fetch loop,
    never returned as partial/corrupt data."""
    rng = random.Random(99)
    raw = bytes(rng.randrange(256) for _ in range(96))
    comp = zlib.compress(raw, 1)
    good = (
        b"CHUNK 0 %d %d\r\n" % (len(raw), zlib.crc32(raw))
        + base64.b64encode(comp)
        + b"\r\n"
    )
    srv = _CannedServer()
    try:
        def fetch():
            c = MerkleKVClient("127.0.0.1", srv.port, timeout=0.3)
            c.connect()
            try:
                return c.snap_chunk(7, 0, 4096)
            finally:
                c.close()

        srv.payload = good
        assert fetch() == raw  # the canned frame itself is sound

        for cut in range(len(good)):
            srv.payload = good[:cut]
            with pytest.raises(MerkleKVError):
                fetch()

        flips = sorted(rng.sample(range(len(good)), 48))
        for off in flips:
            srv.payload = good[:off] + bytes([good[off] ^ 0xFF]) + good[off + 1:]
            with pytest.raises(MerkleKVError):
                fetch()
    finally:
        srv.close()


def test_chunk_integrity_error_is_retryable_not_capability():
    """The error taxonomy the fetch loop depends on: integrity failures are
    ChunkIntegrityError (retry the offset), NOT ProtocolError (which would
    read as a capability miss and fail the donor)."""
    assert issubclass(ChunkIntegrityError, MerkleKVError)
    assert not issubclass(ChunkIntegrityError, ProtocolError)


# ---------------------------------------------------------------- config


def test_bootstrap_config_parse_and_validate():
    cfg = Config.from_dict(
        {"bootstrap": {"enabled": True, "chunk_bytes": 65536,
                       "chunk_retries": 2}}
    )
    assert cfg.bootstrap.enabled
    assert cfg.bootstrap.chunk_bytes == 65536
    assert cfg.bootstrap.chunk_retries == 2
    with pytest.raises(ValueError):
        Config.from_dict({"bootstrap": {"chunk_bytes": 1024}})
    with pytest.raises(ValueError):
        Config.from_dict({"bootstrap": {"chunk_retries": 0}})


def test_donor_retention_pins_snapshot_during_transfer(tmp_path):
    """Compaction during an active transfer must not delete the artifact a
    joiner is mid-fetch on: the donor pins the advertised seq until the
    pin TTL lapses."""
    donor = Donor(str(tmp_path / "a"), n_keys=2000)
    try:
        with MerkleKVClient("127.0.0.1", donor.server.port) as c:
            seq, _wal, size, _root = c.snap_meta()
            # Age the pinned snapshot behind newer compactions.
            for i in range(3):
                donor.engine.set(b"extra%d" % i, b"y")
                donor.storage.compact()
            snaps = dict(snapmod.list_snapshots(donor.storage.directory))
            assert seq in snaps, "pinned snapshot was retired mid-transfer"
            # The byte range is still fully servable.
            blob, off = b"", 0
            while off < size:
                part = c.snap_chunk(seq, off, 65536)
                blob += part
                off += len(part)
            snap = snapmod.parse_snapshot_bytes(blob)
            snapmod.verify_snapshot(snap, engine="cpu")
    finally:
        donor.close()


# ---------------------------------------------------------------- soak

@pytest.mark.slow
def test_soak_repeated_rejoin_cycles(tmp_path):
    """Rejoin soak: repeatedly kill the member, grow the survivor, rejoin
    from nothing with bootstrap — every cycle must converge bit-identically
    through the snapshot path."""
    donor = Donor(str(tmp_path / "a"))
    try:
        total = 0
        for cycle in range(4):
            for i in range(10_000):
                donor.engine.set(b"s%d:%05d" % (cycle, i), b"v%05d" % i)
            total += 10_000
            eng_b, sess = _joiner_session([donor.addr])
            try:
                report = sess.run("empty-keyspace")
                assert report.mode == "snapshot", report.details
                assert eng_b.merkle_root() == donor.engine.merkle_root()
                assert eng_b.dbsize() == total
            finally:
                eng_b.close()
    finally:
        donor.close()


@pytest.mark.slow
def test_soak_kill9_rejoin_processes(tmp_path):
    """Process-level rejoin soak: repeatedly SIGKILL the member process,
    grow the survivor, wipe the member's disk (long-dead shape), restart
    it with [bootstrap] enabled, and require converged HASH roots through
    the snapshot path every cycle."""
    import os
    import shutil
    import subprocess
    import sys

    from merklekv_tpu_torch.testing.faults import PeerProcessKiller

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def spawn(cfg_path):
        env = dict(os.environ, PYTHONPATH=repo, MERKLEKV_TORCH_DEVICE="cpu")
        return subprocess.Popen(
            [sys.executable, "-m", "merklekv_tpu_torch", "--config", cfg_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )

    def free_port():
        sk = socket.socket()
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
        sk.close()
        return port

    def await_ready(proc, port, timeout=30):
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

    port_a, port_b = free_port(), free_port()

    def write_cfg(path, port, peers, boot):
        peer_list = ", ".join(f'"{p}"' for p in peers)
        path.write_text(f"""
host = "127.0.0.1"
port = {port}
engine = "mem"
storage_path = "{tmp_path}"

[storage]
enabled = true
merkle_engine = "cpu"

[anti_entropy]
peers = [{peer_list}]
engine = "cpu"

[bootstrap]
enabled = {"true" if boot else "false"}
""")
        return str(path)

    cfg_a = write_cfg(tmp_path / "a.toml", port_a, [], False)
    cfg_b = write_cfg(
        tmp_path / "b.toml", port_b, [f"127.0.0.1:{port_a}"], True
    )

    procs = []
    try:
        a = spawn(cfg_a)
        procs.append(a)
        await_ready(a, port_a)
        b = spawn(cfg_b)
        procs.append(b)
        await_ready(b, port_b)

        total = 0
        for cycle in range(3):
            PeerProcessKiller(b).kill_now()  # SIGKILL: no shutdown path
            procs.remove(b)
            with MerkleKVClient("127.0.0.1", port_a, timeout=10) as c:
                batch = 500
                for base in range(0, 10_000, batch):
                    c.pipeline(
                        f"SET s{cycle}:{i:05d} v{i:05d}"
                        for i in range(base, base + batch)
                    )
                total += 10_000
                root_a = c.hash()
            # Long-dead: the member's disk is gone with the machine.
            shutil.rmtree(str(tmp_path / f"node-{port_b}"), ignore_errors=True)
            b = spawn(cfg_b)
            procs.append(b)
            await_ready(b, port_b)
            deadline = time.time() + 90
            root_b = None
            while time.time() < deadline:
                try:
                    with MerkleKVClient(
                        "127.0.0.1", port_b, timeout=5
                    ) as cb:
                        root_b = cb.hash()
                    if root_b == root_a:
                        break
                except MerkleKVError:
                    pass  # LOADING gate / mid-bootstrap: keep polling
                time.sleep(0.1)
            assert root_b == root_a, f"cycle {cycle}: never converged"
            with MerkleKVClient("127.0.0.1", port_b, timeout=5) as cb:
                assert cb.dbsize() == total
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()


# -- across the packages, and the device route -------------------------------
_PKGS = {
    "jax": (jconfig.Config, jnative.NativeEngine, jnative.NativeServer,
            jnode.ClusterNode, jstorage.DurableStore),
    "torch": (Config, NativeEngine, NativeServer, ClusterNode, DurableStore),
}


class PkgNode:
    """A durable in-process node of either package. The torch node hashes
    its snapshot roots, verifies a donor's snapshot and walks deltas on the
    node's device; the JAX node stays on the host."""

    def __init__(self, pkg, data_dir, peers=(), boot=False, n_keys=0):
        cfg_t, eng_t, srv_t, node_t, store_t = _PKGS[pkg]
        route = "tpu" if pkg == "torch" else "cpu"
        self.cfg = cfg_t()
        self.cfg.host = "127.0.0.1"
        self.cfg.storage.enabled = True
        self.cfg.storage.merkle_engine = route
        self.cfg.anti_entropy.engine = route
        self.cfg.anti_entropy.peers = list(peers)
        self.cfg.anti_entropy.interval_seconds = 3600.0
        self.cfg.bootstrap.enabled = boot
        self.engine = eng_t("mem")
        self.storage = store_t(self.engine, self.cfg.storage, data_dir)
        self.storage.recover()
        for i in range(n_keys):
            self.engine.set(b"x%06d" % i, b"val%06d" % i)
        self.server = srv_t(self.engine, "127.0.0.1", 0)
        self.server.start()
        self.node = node_t(self.cfg, self.engine, self.server, storage=self.storage)
        self.node.start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.server.port}"

    def close(self):
        self.node.stop()
        self.storage.stop()
        self.server.close()
        self.engine.close()


@pytest.mark.parametrize("donor_pkg,joiner_pkg", [("jax", "torch"), ("torch", "jax")])
def test_bootstrap_across_the_packages_ends_at_equal_roots(tmp_path, donor_pkg, joiner_pkg):
    donor = PkgNode(donor_pkg, str(tmp_path / "donor"), n_keys=3000)
    joiner = None
    try:
        joiner = PkgNode(joiner_pkg, str(tmp_path / "joiner"), peers=[donor.addr], boot=True)

        def done():
            sess = joiner.node._bootstrap
            return sess is not None and sess.state in ("live", "failed")

        assert wait_for(done, timeout=120)
        report = joiner.node._bootstrap.report
        assert report.mode == "snapshot", report.details
        assert report.snapshot_items == 3000
        assert joiner.engine.merkle_root() == donor.engine.merkle_root()
        assert joiner.server.serving
    finally:
        if joiner is not None:
            joiner.close()
        donor.close()


def test_device_failure_in_the_snapshot_verification_fails_the_session(tmp_path, monkeypatch):
    donor = Donor(str(tmp_path / "a"), n_keys=3000)
    try:
        donor.storage.snapshot_now()  # the donor's own (host) root, first
        engine = NativeEngine("mem")
        mgr = SyncManager(engine, device="cpu")
        sess = BootstrapSession(engine, mgr, [donor.addr], BootstrapConfig(),
                                merkle_engine="tpu")
        calls, host_levels = [], []

        def failing_device_root(items):
            calls.append(len(items))
            raise RuntimeError("injected device failure")

        from merklekv_tpu_torch.merkle import cpu as cpu_merkle

        real_build_levels = cpu_merkle.build_levels

        def spy_build_levels(*a, **kw):
            host_levels.append(1)
            return real_build_levels(*a, **kw)

        fallbacks = get_metrics().snapshot()["counters"].get("device.fallbacks", 0)
        monkeypatch.setattr(snapmod, "_device_root_hex", failing_device_root)
        monkeypatch.setattr(cpu_merkle, "build_levels", spy_build_levels)
        try:
            report = sess.run("empty-keyspace")
            assert calls == [3000]
            assert report.mode == "failed" and sess.state == "failed"
            assert any("injected device failure" in d for d in report.details)
            assert engine.dbsize() == 0  # nothing unverified installed
            assert not host_levels, "the snapshot was verified on the host"
            assert get_metrics().snapshot()["counters"]["device.fallbacks"] == fallbacks + 1
        finally:
            engine.close()
    finally:
        donor.close()


def _spawn_node(cfg_path):
    return subprocess.Popen(
        [sys.executable, "-m", "merklekv_tpu_torch", "--config", str(cfg_path)],
        env=dict(os.environ, PYTHONPATH=REPO, MERKLEKV_TORCH_DEVICE="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _ready_port(proc) -> int:
    line = proc.stdout.readline()
    assert line.startswith("merklekv_tpu_torch listening on "), line
    threading.Thread(target=lambda: [None for _ in proc.stdout], daemon=True).start()
    return int(line.split()[3].rsplit(":", 1)[1])


def test_wiped_replica_restarts_with_bootstrap_and_serves_its_siblings_root(tmp_path):
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])

    def toml(name, port, peers, boot):
        path = tmp_path / f"{name}.toml"
        peer_list = ", ".join(f'"{p}"' for p in peers)
        path.write_text(f"""
host = "127.0.0.1"
port = {port}
storage_path = "{tmp_path}"

[storage]
enabled = true

[anti_entropy]
peers = [{peer_list}]
interval_seconds = 3600

[bootstrap]
enabled = {"true" if boot else "false"}
""")
        return path

    cfg_a = toml("a", ports[0], [], False)
    cfg_b = toml("b", ports[1], [f"127.0.0.1:{ports[0]}"], True)
    procs = []
    try:
        procs.append(_spawn_node(cfg_a))
        _ready_port(procs[-1])
        procs.append(_spawn_node(cfg_b))
        _ready_port(procs[-1])
        n = 5000  # past DEVICE_MIN_KEYS: the joiner verifies on the device
        with MerkleKVClient("127.0.0.1", ports[0], timeout=60) as c:
            for base in range(0, n, 1000):
                c.pipeline(f"SET b:{i:06d} v{i}" for i in range(base, base + 1000))
            root_a = c.hash()
        procs[1].kill()
        procs[1].wait(10)
        shutil.rmtree(tmp_path / f"node-{ports[1]}")
        t0 = time.monotonic()
        procs[1] = _spawn_node(cfg_b)
        _ready_port(procs[1])
        root_b = None
        while time.monotonic() - t0 < 120:
            try:
                with MerkleKVClient("127.0.0.1", ports[1], timeout=10) as c:
                    root_b = c.hash()
                    if root_b == root_a:
                        m = c.metrics()
                        break
            except MerkleKVError:
                pass  # the read gate holds until the snapshot verifies
            time.sleep(0.1)
        assert root_b == root_a
        assert int(m["bootstrap.snapshots_installed"]) == 1
        assert m.get("device.fallbacks", "0") == "0"
        with MerkleKVClient("127.0.0.1", ports[1], timeout=10) as c:
            assert c.dbsize() == n
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
