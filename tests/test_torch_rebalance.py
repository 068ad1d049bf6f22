"""Live partition rebalancing in the torch port, on the CPU.

The cases of ``tests/test_rebalance.py`` and ``tests/test_rebalance_proc.py``
against the port's modules (``cluster/rebalance.py``, ``cluster/partmap.py``,
the partitioned ``ClusterNode``) and spawned ``python -m
merklekv_tpu_torch`` nodes; the live split runs twice, on the host route
and on the node's device (range roots, snapshot roots and the joiner's
verification through ``storage/snapshot.py`` on the device, the mirror
there). Then the device site the port changes:

- the moving range's root on the device path equals the JAX
  ``_range_root_hex`` (pinned to the host) and a hashlib chain for n in
  {0, 1, 2, 3, 4095, 4096, 4097};
- a device failure injected into the range root is counted in
  ``device.fallbacks`` and raised: the split rolls back at epoch E, no
  write is lost, and no root is computed on the host.

Every node here runs with ``MERKLEKV_TORCH_DEVICE=cpu`` (the kernels'
plain versions). Tolerance: exact equality.
"""

import hashlib
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import uuid

import pytest

from merklekv_tpu.cluster import rebalance as jrb_mod
from merklekv_tpu_torch.client import (
    MerkleKVClient,
    MerkleKVError,
    PartitionedClient,
    ProtocolError,
    ServerBusyError,
)
from merklekv_tpu_torch.cluster import rebalance as rb_mod
from merklekv_tpu_torch.cluster.node import ClusterNode
from merklekv_tpu_torch.cluster.partmap import (
    PartitionMap,
    PartitionMapError,
    format_map_spec,
    hash_of_key,
    key_in_range,
    load_map_file,
    parse_map_spec,
    partition_of,
    save_map_file,
)
from merklekv_tpu_torch.cluster.transport import TcpBroker
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.native_bindings import NativeEngine, NativeServer
from merklekv_tpu_torch.obs.flightrec import get_recorder
from merklekv_tpu_torch.storage import DurableStore
from merklekv_tpu_torch.storage import snapshot as snapmod
from merklekv_tpu_torch.merkle import cpu as cpu_merkle
from merklekv_tpu_torch.testing.faults import PeerProcessKiller
from merklekv_tpu_torch.utils.tracing import get_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_env(monkeypatch):
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")



def wait_for(fn, timeout=15.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def free_ports(n: int) -> list[int]:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


# ------------------------------------------------------------ map plane


def test_split_preserves_routing_and_moving_range():
    m = parse_map_spec("0=a:1;1=b:2", 2, epoch=1)
    s = m.split(0, ["c:3"])
    assert s.epoch == 2 and s.count == 3 and s.is_split
    assert s.replicas[2] == ["c:3"]
    # The moving range of the ORIGINAL map is exactly the new pid's cell.
    assert m.moving_range(0) == (s.hash_base, *s.assignment(2))
    # Routing is a partition: every key lands on exactly one owner, and
    # keys that stay route identically before and after.
    for i in range(300):
        k = f"route:{i}"
        owners = [
            p
            for p in range(s.count)
            if key_in_range(k, s.hash_base, *s.assignment(p))
        ]
        assert len(owners) == 1, f"{k} owned by {owners}"
        if owners[0] != 2:
            assert owners[0] == partition_of(k, 2)


def test_map_file_roundtrip_and_malformations(tmp_path):
    m = parse_map_spec("0=a:1;1=b:2", 2, epoch=1).split(0, ["c:3"])
    save_map_file(str(tmp_path), m, 2)
    loaded = load_map_file(str(tmp_path))
    assert loaded is not None
    pmap, pid = loaded
    assert pid == 2 and pmap == m and pmap.epoch == 2
    # Missing file is a clean None (fresh node), never an exception.
    assert load_map_file(str(tmp_path / "nowhere")) is None
    # Any malformation raises: ownership is never guessed from a torn
    # or doctored file.
    path = tmp_path / "partmap.spec"
    good = path.read_text()
    bad = [
        "",  # empty
        "BOGUSMAGIC\n" + good.split("\n", 1)[1],  # wrong magic
        good.replace("epoch 2", "epoch x"),  # non-numeric epoch
        good.replace("pid 2", "pid 9"),  # pid out of range
        "\n".join(good.split("\n")[:3]) + "\n",  # truncated
        good.replace("spec ", "spec !"),  # garbled mapspec
    ]
    for blob in bad:
        path.write_text(blob)
        with pytest.raises(PartitionMapError):
            load_map_file(str(tmp_path))
    # A half-written temp file never shadows the real one.
    path.write_text(good)
    (tmp_path / "partmap.spec.tmp").write_text("garbage")
    assert load_map_file(str(tmp_path))[1] == 2


def test_mapspec_v2_roundtrip_single_token():
    m = parse_map_spec("0=a:1,b:2;1=c:3", 2, epoch=3).split(1, ["d:4"])
    spec = format_map_spec(m)
    assert " " not in spec  # must ride the wire as ONE token
    again = parse_map_spec(spec, m.count, m.epoch)
    assert again == m
    # Wire v2 roundtrip (4-field epoch-bearing header).
    parsed = PartitionMap.from_wire(
        m.wire().split("\r\n")[0], m.wire().split("\r\n")[1:-2]
    )
    assert parsed == m


# ----------------------------------------------------- wire verb surface


@pytest.fixture
def bare_partitioned_node():
    ports = free_ports(2)
    spec = f"0=127.0.0.1:{ports[0]};1=127.0.0.1:{ports[1]}"
    cfg = Config()
    cfg.host = "127.0.0.1"
    cfg.port = ports[0]
    cfg.cluster.partitions = 2
    cfg.cluster.partition_id = 0
    cfg.cluster.partition_map = spec
    cfg.anti_entropy.engine = "cpu"
    eng = NativeEngine("mem")
    srv = NativeServer(eng, "127.0.0.1", ports[0])
    srv.start()
    node = ClusterNode(cfg, eng, srv)
    node.start()
    yield node, srv
    node.stop()
    srv.close()
    eng.close()


def test_rebalance_wire_refusals(bare_partitioned_node):
    node, srv = bare_partitioned_node
    with MerkleKVClient("127.0.0.1", srv.port) as c:
        for sub, why in [
            ("", "subcommand"),
            ("NONSENSE", "unknown"),
            ("SPLIT", "requires"),
            ("SPLIT 1 1 h:1", "not 1"),  # this node serves 0
            ("SPLIT 0 9 h:1", "stale epoch"),
            ("SPLIT 0 1 h:1", "storage"),  # no durable storage
            ("SPLIT x y z", "invalid literal"),
            ("JOIN 2 3 2 h:1 base=2;0@0.1.0=a:1;1@1.0.0=b:2;2@0.1.1=c:3",
             "reserve"),  # partitioned nodes refuse conscription
            ("FENCE 9 2 0 1 1 1000", "does not extend"),
            ("COMMIT 2 3", "requires"),
        ]:
            with pytest.raises(ProtocolError, match=why):
                c.rebalance(sub)
        # STATUS always answers (idle node), never an error.
        assert c.rebalance("STATUS").startswith("REBALSTATUS idle 1 ")
        # COMMIT of an epoch we already have is idempotent-OK.
        spec = format_map_spec(node._partmap)
        assert c.rebalance(f"COMMIT 1 2 {spec}") == "OK committed"


# -------------------------------------------------- wire fuzz (satellite)


class _CannedServer:
    """One-shot server: accept, read one line, answer canned bytes,
    close — the hostile-peer rig for wire fuzzing."""

    def __init__(self, payload: bytes) -> None:
        self._payload = payload
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        try:
            conn, _ = self._sock.accept()
            conn.settimeout(5)
            try:
                conn.recv(4096)
                conn.sendall(self._payload)
            finally:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                conn.close()
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5)


class _FakeNode:
    """Just enough node for RebalanceManager's client-side paths."""

    _partmap = None
    _partition_id = None


def _poll_status_from_canned(payload: bytes):
    srv = _CannedServer(payload)
    mgr = rb_mod.RebalanceManager(_FakeNode())
    try:
        return mgr._poll_status(f"127.0.0.1:{srv.port}")
    finally:
        srv.close()


def test_rebalstatus_fuzz_truncation_every_offset():
    """A REBALSTATUS reply cut at EVERY byte offset either parses whole
    or raises a clean typed error — never a partial status, never a hang,
    never a non-client exception (a garbled status steering a donor's
    flip decision would be a zero-loss violation)."""
    good = b"REBALSTATUS join_live 2 " + b"ab" * 32 + b"\r\n"
    for cut in range(len(good) + 1):
        try:
            state, epoch, root = _poll_status_from_canned(good[:cut])
        except (MerkleKVError, OSError):
            continue
        assert cut >= len(good) - 2, f"partial status accepted at {cut}"
        assert (state, epoch) == ("join_live", 2)


def test_rebalstatus_fuzz_seeded_byte_flips():
    import random

    good = b"REBALSTATUS transfer 3 -\r\n"
    rng = random.Random(1601)
    for _ in range(48):
        pos = rng.randrange(len(good))
        payload = (
            good[:pos]
            + bytes([good[pos] ^ (1 << rng.randrange(8))])
            + good[pos + 1:]
        )
        try:
            state, epoch, _ = _poll_status_from_canned(payload)
        except (MerkleKVError, OSError):
            continue
        # Whatever survived the flip is structurally whole.
        assert isinstance(epoch, int) and state


def _fetch_map_from_canned(payload: bytes):
    srv = _CannedServer(payload)
    try:
        with MerkleKVClient("127.0.0.1", srv.port, timeout=2.0) as c:
            return c.partition_map()
    finally:
        srv.close()


_SPLIT_PARTMAP_WIRE = (
    "PARTMAP 2 3 2\r\n"
    "0 0.1.0 127.0.0.1:7001\r\n"
    "1 1.0.0 127.0.0.1:7003\r\n"
    "2 0.1.1 127.0.0.1:7005\r\n"
    "END\r\n"
).encode()


def test_split_partmap_fuzz_truncation_every_offset():
    """The epoch-bearing SPLIT map reply (wire v2, 4-field header) cut at
    every offset: full parse or clean typed error, never a partial map —
    a client routing on half a split table would wrong-node silently."""
    full_len = len(_SPLIT_PARTMAP_WIRE)
    for cut in range(full_len + 1):
        try:
            m = _fetch_map_from_canned(_SPLIT_PARTMAP_WIRE[:cut])
        except (MerkleKVError, PartitionMapError):
            continue
        assert cut >= full_len - 2, f"partial split map accepted at {cut}"
        assert m.is_split and m.epoch == 2 and m.count == 3
        assert m.hash_base == 2
        assert m.assignment(2) == (0, 1, 1)


def test_split_partmap_fuzz_seeded_byte_flips():
    import random

    rng = random.Random(1602)
    for _ in range(64):
        pos = rng.randrange(len(_SPLIT_PARTMAP_WIRE))
        payload = (
            _SPLIT_PARTMAP_WIRE[:pos]
            + bytes([_SPLIT_PARTMAP_WIRE[pos] ^ (1 << rng.randrange(8))])
            + _SPLIT_PARTMAP_WIRE[pos + 1:]
        )
        try:
            m = _fetch_map_from_canned(payload)
        except (MerkleKVError, PartitionMapError):
            continue
        m.validate()  # whatever came back is a complete, coherent map
        # A flipped map is still a partition of the keyspace: one owner
        # per key (the invariant routing correctness rides on).
        for i in range(40):
            k = f"fz:{i}"
            owners = [
                p
                for p in range(m.count)
                if key_in_range(k, m.hash_base, *m.assignment(p))
            ]
            assert len(owners) == 1


# ------------------------------------------- donor pin heartbeat (the fix)


def test_rebalance_heartbeat_outlives_pin_ttl(tmp_path, monkeypatch):
    """The satellite fix: a throttled transfer pausing longer than the
    donor's pin TTL between chunks must NOT lose its artifact — the
    rebalance session heartbeat (refresh_pin with no seq) re-stamps every
    live pin, so retention keeps the pinned snapshot; silence past the
    TTL (a dead session) still releases it."""
    cfg = Config()
    cfg.storage.enabled = True
    cfg.storage.merkle_engine = "cpu"
    cfg.storage.snapshots_retained = 1
    eng = NativeEngine("mem")
    store = DurableStore(eng, cfg.storage, str(tmp_path))
    store.recover()
    try:
        monkeypatch.setattr(DurableStore, "_PIN_TTL_S", 0.3)
        eng.set(b"a", b"1")
        store.snapshot_now()
        meta = store.donor_meta()  # pins the artifact
        assert isinstance(meta, tuple)
        seq = meta[0]
        # Age the pin past the TTL repeatedly, heartbeating each time —
        # then force retention churn with newer snapshots.
        for i in range(3):
            time.sleep(0.15)
            store.refresh_pin()  # the session heartbeat
        eng.set(b"b", b"2")
        store.snapshot_now()
        eng.set(b"c", b"3")
        store.snapshot_now()  # retention runs; pinned artifact must survive
        assert store.read_snapshot_range(seq, 0, 64), (
            "heartbeated pin lost its artifact"
        )
        # A dead session (no heartbeat past the TTL) releases the pin.
        time.sleep(0.4)
        eng.set(b"d", b"4")
        store.snapshot_now()
        with pytest.raises(OSError):
            store.read_snapshot_range(seq, 0, 64)
    finally:
        store.stop()
        eng.close()


# ------------------------------------------------- in-process split rigs


class RebalCluster:
    """2 partitions x 1 replica + reserves, storage-backed, replicating
    over one shared broker — the in-process live-split rig."""

    def __init__(self, tmp_path, reserves: int = 1, device: bool = False) -> None:
        self.tmp = tmp_path
        # device: range roots, snapshot roots and verification on the
        # node's device, and the mirror there (the kernels' plain versions
        # under MERKLEKV_TORCH_DEVICE=cpu).
        self.route = "tpu" if device else "cpu"
        self.broker = TcpBroker()
        self.topic = f"rb-{uuid.uuid4().hex[:8]}"
        self.ports = free_ports(2 + reserves)
        self.addr = [f"127.0.0.1:{p}" for p in self.ports]
        self.spec = f"0={self.addr[0]};1={self.addr[1]}"
        self.engines: dict[int, NativeEngine] = {}
        self.stores: dict[int, DurableStore] = {}
        self.servers: dict[int, NativeServer] = {}
        self.nodes: dict[int, ClusterNode] = {}
        for i in range(2 + reserves):
            self.start_node(i)

    def cfg_for(self, i: int) -> Config:
        cfg = Config()
        cfg.host = "127.0.0.1"
        cfg.port = self.ports[i]
        cfg.storage.enabled = True
        cfg.storage.merkle_engine = self.route
        cfg.anti_entropy.engine = self.route
        cfg.anti_entropy.interval_seconds = 3600.0
        cfg.replication.mqtt_broker = self.broker.host
        cfg.replication.mqtt_port = self.broker.port
        cfg.replication.topic_prefix = self.topic
        if i < 2:  # partition members; the rest are reserves
            cfg.cluster.partitions = 2
            cfg.cluster.partition_id = i
            cfg.cluster.partition_map = self.spec
            cfg.replication.enabled = True
        return cfg

    def start_node(self, i: int) -> ClusterNode:
        eng = self.engines.get(i)
        if eng is None:
            eng = NativeEngine("mem")
            self.engines[i] = eng
        d = os.path.join(str(self.tmp), f"n{i}")
        os.makedirs(d, exist_ok=True)
        store = DurableStore(eng, self.cfg_for(i).storage, d)
        store.recover()
        self.stores[i] = store
        srv = NativeServer(eng, "127.0.0.1", self.ports[i])
        srv.start()
        self.servers[i] = srv
        node = ClusterNode(self.cfg_for(i), eng, srv, storage=store)
        node.start()
        self.nodes[i] = node
        return node

    def kill(self, i: int) -> None:
        """Abrupt death: stop serving first, then tear down in the
        __main__ order (node, storage, server) — storage's final drain
        reads through live server handles."""
        srv = self.servers.pop(i)
        srv.stop()
        node = self.nodes.pop(i)
        try:
            node.stop()
        except Exception:
            pass
        store = self.stores.pop(i)
        try:
            store.stop()
        except Exception:
            pass
        srv.close()

    def client(self, i: int, timeout=5.0) -> MerkleKVClient:
        host, _, port = self.addr[i].rpartition(":")
        return MerkleKVClient(host, int(port), timeout=timeout)

    def split(self, donor: int = 0, joiner: int = 2) -> str:
        with self.client(donor, timeout=10) as c:
            epoch = c.partition_map().epoch
            return c.rebalance(f"SPLIT 0 {epoch} {self.addr[joiner]}")

    def donor_state(self, i: int = 0) -> str:
        with self.client(i) as c:
            return c.rebalance("STATUS").split(" ")[1]

    def close(self) -> None:
        # __main__'s shutdown order per node: node, storage, server,
        # engine — storage's final drain reads through live handles.
        for i in list(self.nodes):
            try:
                self.nodes[i].stop()
            except Exception:
                pass
        for store in self.stores.values():
            try:
                store.stop()
            except Exception:
                pass
        for srv in self.servers.values():
            srv.close()
        for eng in self.engines.values():
            eng.close()
        self.broker.close()


def _seed(pc, n=200, tag="k"):
    kv = {}
    for i in range(n):
        k = f"{tag}:{i:05d}"
        kv[k] = f"v{i}"
        pc.set(k, kv[k])
    return kv


# ------------------------------------------------------ the clean split


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_live_split_zero_errors_and_verified_handoff(tmp_path, device):
    """The tentpole headline, in process: a live 2->3 split under client
    write load — zero client-visible errors, epoch flip to E+1, donor and
    joiner keyspaces disjoint with their union exactly the pre-split set
    plus the storm's writes, the joiner's engine root bit-identical to a
    CPU-recomputed reference over the moving range, stale clients healing
    through MOVED, and the durable map file present on both sides."""
    rec = get_recorder()
    rec.clear()
    cluster = RebalCluster(tmp_path, device=device)
    storm_errors: list = []
    try:
        pc = PartitionedClient([cluster.addr[0]], timeout=5).connect()
        kv = _seed(pc)
        stop = threading.Event()
        wrote: dict[str, str] = {}

        def storm():
            i = 0
            try:
                while not stop.is_set():
                    k = f"live:{i:05d}"
                    pc2.set(k, f"L{i}")
                    wrote[k] = f"L{i}"
                    i += 1
                    time.sleep(0.002)
            except BaseException as e:
                storm_errors.append(e)

        pc2 = PartitionedClient([cluster.addr[0]], timeout=5).connect()
        t = threading.Thread(target=storm, daemon=True)
        t.start()
        time.sleep(0.05)
        assert cluster.split().startswith("OK rebalance started 2 2")
        assert wait_for(
            lambda: cluster.donor_state() in ("done", "failed"), timeout=60
        )
        assert cluster.donor_state() == "done"
        time.sleep(0.3)
        stop.set()
        t.join(timeout=10)
        assert not storm_errors, f"client-visible error: {storm_errors[0]!r}"
        assert wrote, "storm never wrote"

        allkv = dict(kv)
        allkv.update(wrote)
        # Epoch flipped, split map served.
        with cluster.client(0) as c:
            m = c.partition_map()
        assert m.epoch == 2 and m.count == 3 and m.is_split

        # No key lost, none double-owned: donor + joiner partition the
        # old partition-0 keyspace exactly.
        donor_keys = {k for k, _ in cluster.engines[0].snapshot()}
        joiner_keys = {k for k, _ in cluster.engines[2].snapshot()}
        assert not donor_keys & joiner_keys, "double-owned keys"
        expect_p0 = {
            k.encode() for k in allkv if partition_of(k, 2) == 0
        }
        assert donor_keys | joiner_keys == expect_p0
        assert joiner_keys, "nothing actually moved"

        # Bit-identical root: the joiner's whole engine vs an independent
        # CPU recomputation over exactly the moving-range subset.
        ref = snapmod.compute_root_hex(
            sorted(
                (k.encode(), v.encode())
                for k, v in allkv.items()
                if key_in_range(k, m.hash_base, *m.assignment(2))
            ),
            engine="cpu",
        )
        joiner_root = snapmod.compute_root_hex(
            cluster.engines[2].snapshot(), engine="cpu"
        )
        assert joiner_root == ref, "moved range not bit-identical"

        # Every key readable through the (now-stale) seeded client: MOVED
        # -> refresh -> re-route, no errors.
        for k in list(allkv)[::9]:
            assert pc.get(k) == allkv[k]

        # Durable commit point on both sides.
        assert load_map_file(os.path.join(str(tmp_path), "n0"))[0].epoch == 2
        jm, jpid = load_map_file(os.path.join(str(tmp_path), "n2"))
        assert jm.epoch == 2 and jpid == 2

        # Observability: phases in the flight ring, terminal gauge state.
        kinds = {e.kind for e in rec.last(0)}
        assert "rebalance_start" in kinds
        assert "rebalance_verified" in kinds
        assert "rebalance_commit" in kinds
        assert "rebalance_done" in kinds
        assert cluster.nodes[0]._rebalance_state_code() == 7  # done
        assert cluster.nodes[2]._rebalance_state_code() == 13  # committed
        m0 = dict(
            ln.split(":", 1)
            for ln in cluster.nodes[0]._metrics_wire().splitlines()
            if ":" in ln
        )
        assert m0["partition.epoch"] == "2"
        assert m0["rebalance.state"] == "7"
        pay = cluster.nodes[2]._health_payload()
        assert pay["partition"] == 2 and pay["partition_epoch"] == 2
        pc.close()
        pc2.close()
    finally:
        cluster.close()


def test_joiner_death_mid_transfer_donor_rolls_back(tmp_path, monkeypatch):
    """Kill the joiner while the transfer is provably in flight: the
    donor aborts, stays at epoch E serving every key (reads AND writes,
    fence never armed), and a later split against a fresh reserve
    succeeds — one wasted transfer, zero lost keys."""
    monkeypatch.setattr(rb_mod, "_POLL_FAILURE_BUDGET", 4)
    cluster = RebalCluster(tmp_path, reserves=2)
    try:
        pc = PartitionedClient([cluster.addr[0]], timeout=5).connect()
        kv = _seed(pc)
        # Hold the joiner mid-install so the kill window is deterministic.
        jmgr = cluster.nodes[2]._rebalance_manager()
        held = threading.Event()

        def holding_install(snap, moving):
            held.set()
            jmgr._stop_evt.wait(timeout=30)
            raise RuntimeError("simulated joiner crash")

        monkeypatch.setattr(jmgr, "_install_filtered", holding_install)
        assert cluster.split().startswith("OK")
        assert held.wait(timeout=30), "joiner never reached the transfer"
        cluster.kill(2)  # the abrupt death, mid-transfer
        assert wait_for(
            lambda: cluster.donor_state() == "failed", timeout=30
        )
        # Rollback: epoch unchanged, no map file, every key served.
        with cluster.client(0) as c:
            assert c.partition_map().epoch == 1
        assert load_map_file(os.path.join(str(tmp_path), "n0")) is None
        for k in list(kv)[::9]:
            assert pc.get(k) == kv[k]
        p0 = next(k for k in kv if partition_of(k, 2) == 0)
        assert pc.set(p0, "post-abort")  # writes open: fence never stuck
        # The donor's forward hook is disarmed (no leak into dead topics).
        assert cluster.nodes[0].replicator._fwd_topic is None
        # The SAME donor can split again against the second reserve.
        with cluster.client(0, timeout=10) as c:
            assert c.rebalance(
                f"SPLIT 0 1 {cluster.addr[3]}"
            ).startswith("OK")
        assert wait_for(
            lambda: cluster.donor_state() == "done", timeout=60
        )
        with cluster.client(0) as c:
            assert c.partition_map().epoch == 2
        pc.close()
    finally:
        cluster.close()


def test_donor_session_death_joiner_returns_to_reserve(
    tmp_path, monkeypatch
):
    """The donor's session dies silently mid-transfer (the crash shape:
    no ABORT ever sent) and comes back idle at epoch E: the joiner's
    resolve loop reads that verdict and wipes itself back to an empty,
    serving reserve — no half-joined zombie, no double ownership."""
    cluster = RebalCluster(tmp_path)
    try:
        pc = PartitionedClient([cluster.addr[0]], timeout=5).connect()
        kv = _seed(pc)
        dmgr = cluster.nodes[0]._rebalance_manager()
        orig_wait = dmgr._wait_joiner_live

        def die_after_live(joiner):
            orig_wait(joiner)  # joiner IS conscripted and live
            raise RuntimeError("simulated donor crash")

        def silent_crash(**kw):
            # A kill -9 sends no ABORT and clears nothing remotely; the
            # restarted donor simply reports idle at epoch E.
            cluster.nodes[0].replicator.clear_range_forward()
            dmgr._set_state("idle")
            with dmgr._mu:
                dmgr._pending = None

        monkeypatch.setattr(dmgr, "_wait_joiner_live", die_after_live)
        monkeypatch.setattr(
            dmgr, "_abort_split", lambda **kw: silent_crash()
        )
        assert cluster.split().startswith("OK")
        # Joiner reaches live, then resolves the dead session: rollback.
        assert wait_for(
            lambda: cluster.nodes[2]._rebalance_manager().state
            == "join_aborted",
            timeout=30,
        ), cluster.nodes[2]._rebalance_manager().state
        jnode = cluster.nodes[2]
        assert jnode._partmap is None and jnode._partition_id is None
        assert cluster.engines[2].dbsize() == 0  # wiped back to empty
        with cluster.client(2) as c:
            assert c.set("any:key", "reserve-serves")  # guard cleared
        # The donor still owns everything at epoch E.
        with cluster.client(0) as c:
            assert c.partition_map().epoch == 1
        for k in list(kv)[::19]:
            assert pc.get(k) == kv[k]
        pc.close()
    finally:
        cluster.close()


def test_lost_commit_heals_through_joiner_self_commit(
    tmp_path, monkeypatch
):
    """The donor commits (map persisted, epoch flipped) but its COMMIT
    broadcast to the joiner is lost: the joiner's resolve loop sees the
    donor's terminal state at E+1 and self-commits — serving its new
    partition without ever hearing COMMIT."""
    cluster = RebalCluster(tmp_path)
    try:
        pc = PartitionedClient([cluster.addr[0]], timeout=5).connect()
        kv = _seed(pc)
        dmgr = cluster.nodes[0]._rebalance_manager()
        orig_rpc = dmgr._rpc

        def dropping_rpc(addr, subcommand, ignore_errors=False):
            if subcommand.startswith("COMMIT") and addr == cluster.addr[2]:
                return None  # the lost broadcast
            return orig_rpc(addr, subcommand, ignore_errors=ignore_errors)

        monkeypatch.setattr(dmgr, "_rpc", dropping_rpc)
        assert cluster.split().startswith("OK")
        assert wait_for(
            lambda: cluster.donor_state() == "done", timeout=60
        )
        # The joiner self-commits off the donor's terminal state.
        assert wait_for(
            lambda: cluster.nodes[2]._rebalance_manager().state
            == "join_committed",
            timeout=30,
        ), cluster.nodes[2]._rebalance_manager().state
        jnode = cluster.nodes[2]
        assert jnode._partmap.epoch == 2 and jnode._partition_id == 2
        # And it serves: moved keys are readable THROUGH the new map.
        moved = [
            k
            for k in kv
            if key_in_range(
                k, jnode._partmap.hash_base, *jnode._partmap.assignment(2)
            )
        ]
        assert moved
        for k in moved[::7]:
            assert pc.get(k) == kv[k]
        pc.close()
    finally:
        cluster.close()


def test_restart_both_sides_resurrect_committed_epoch(tmp_path):
    """Kill donor AND joiner after a committed split; restart both from
    their storage directories with their ORIGINAL boot configs (donor:
    old 2-way map at epoch 1; joiner: unpartitioned reserve). Both must
    come back at epoch 2 owning their narrowed/new cells — the durable
    map file IS the epoch, the boot config is just the seed."""
    cluster = RebalCluster(tmp_path)
    try:
        pc = PartitionedClient([cluster.addr[0]], timeout=5).connect()
        kv = _seed(pc)
        assert cluster.split().startswith("OK")
        assert wait_for(
            lambda: cluster.donor_state() == "done", timeout=60
        )
        pc.close()
        donor_keys = {k for k, _ in cluster.engines[0].snapshot()}
        joiner_keys = {k for k, _ in cluster.engines[2].snapshot()}
        cluster.kill(0)
        cluster.kill(2)
        # Restart both (engines survive in-process as the disk image; the
        # boot configs still describe the PRE-split world).
        cluster.start_node(0)
        cluster.start_node(2)
        for i, pid in ((0, 0), (2, 2)):
            node = cluster.nodes[i]
            assert node._partmap.epoch == 2, f"node {i} lost the epoch"
            assert node._partition_id == pid
            with cluster.client(i) as c:
                m = c.partition_map()
            assert m.epoch == 2 and m.count == 3
        assert {k for k, _ in cluster.engines[0].snapshot()} == donor_keys
        assert {k for k, _ in cluster.engines[2].snapshot()} == joiner_keys
        # A fresh smart client routes the split world correctly.
        pc = PartitionedClient([cluster.addr[1]], timeout=5).connect()
        for k in list(kv)[::9]:
            assert pc.get(k) == kv[k]
        pc.close()
    finally:
        cluster.close()


def test_boot_foreign_sweep_drops_moved_residue(tmp_path):
    """A donor killed between the epoch persist and the moved-range drop
    restarts with moved keys still in its engine: the boot sweep must
    quiet-drop exactly the foreign residue, restoring single ownership."""
    cluster = RebalCluster(tmp_path)
    try:
        pc = PartitionedClient([cluster.addr[0]], timeout=5).connect()
        _seed(pc)
        assert cluster.split().startswith("OK")
        assert wait_for(
            lambda: cluster.donor_state() == "done", timeout=60
        )
        pc.close()
        # Recreate the crash window: put the (already-moved) joiner keys
        # back into the donor's engine, as if the drop never ran.
        moved = list(cluster.engines[2].snapshot())
        assert moved
        for k, v in moved:
            cluster.engines[0].set(k, v)
        cluster.kill(0)
        cluster.start_node(0)
        donor_keys = {k for k, _ in cluster.engines[0].snapshot()}
        assert not donor_keys & {k for k, _ in moved}, (
            "boot sweep left double-owned residue"
        )
    finally:
        cluster.close()


# ------------------------------------------------- sibling fence plane


def test_sibling_fence_ttl_expiry_restores_writes():
    """A sibling fenced by a donor that then dies must not refuse moving-
    range writes forever: the TTL expires, the fence clears, the peer
    probe finds its replica group still at epoch E (rollback verdict),
    and the sibling serves writes again at the old epoch."""
    rec = get_recorder()
    rec.clear()
    ports = free_ports(3)
    addrs = [f"127.0.0.1:{p}" for p in ports]
    spec = f"0={addrs[0]};1={addrs[1]},{addrs[2]}"
    nodes, servers, engines = [], [], []
    try:
        for i, pid in ((0, 0), (1, 1), (2, 1)):
            cfg = Config()
            cfg.host = "127.0.0.1"
            cfg.port = ports[i]
            cfg.cluster.partitions = 2
            cfg.cluster.partition_id = pid
            cfg.cluster.partition_map = spec
            cfg.anti_entropy.engine = "cpu"
            cfg.anti_entropy.interval_seconds = 3600.0
            eng = NativeEngine("mem")
            srv = NativeServer(eng, "127.0.0.1", ports[i])
            srv.start()
            node = ClusterNode(cfg, eng, srv)
            node.start()
            engines.append(eng)
            servers.append(srv)
            nodes.append(node)
        sibling = nodes[2]  # second replica of partition 1
        pmap = sibling._partmap
        base, root, depth, path = pmap.moving_range(1)
        # A partition-1 key inside the moving cell.
        k = next(
            f"fence:{i}"
            for i in range(10_000)
            if key_in_range(f"fence:{i}", base, root, depth, path)
        )
        with MerkleKVClient("127.0.0.1", ports[2], timeout=5.0) as c:
            assert c.set(k, "before")
            resp = c.rebalance(
                f"FENCE 2 {base} {root} {depth} {path} 400"
            )
            assert resp == "OK fenced"
            with pytest.raises(ServerBusyError):
                c.set(k, "during-fence")
            assert c.get(k) == "before"  # reads open throughout
            # TTL expiry: writes come back without any COMMIT/ABORT.
            deadline = time.time() + 10
            while time.time() < deadline:
                try:
                    assert c.set(k, "after-expiry")
                    break
                except ServerBusyError:
                    time.sleep(0.1)
            else:
                pytest.fail("fence never expired")
        # The probe reached the group peer (nodes[1], still at epoch 1)
        # and recorded the rollback verdict; nothing was adopted.
        assert wait_for(
            lambda: any(
                e.kind == "rebalance_fence_rollback" for e in rec.last(0)
            ),
            timeout=15,
        )
        assert sibling._partmap.epoch == 1
        assert {e.kind for e in rec.last(0)} >= {
            "rebalance_fenced",
            "rebalance_fence_expired",
        }
    finally:
        for n in nodes:
            n.stop()
        for s in servers:
            s.close()
        for e in engines:
            e.close()


def test_router_serves_dumb_clients_through_live_split(tmp_path):
    """Satellite: the thin router's bounded MOVED/BUSY retry
    (PARTITION_MOVED policy) serves a dumb client straight through a
    live split — zero client-visible errors during the fence + flip,
    and the SAME router connection reads every key (including the moved
    range) after the epoch lands."""
    from merklekv_tpu_torch.cluster.router import PartitionRouter

    cluster = RebalCluster(tmp_path)
    router = None
    errors: list = []
    try:
        router = PartitionRouter(seeds=[cluster.addr[0]]).start()
        kv = {f"rt:{i:04d}": f"v{i}" for i in range(200)}
        with MerkleKVClient("127.0.0.1", router.port, timeout=10) as rc:
            for k, v in kv.items():
                rc.set(k, v)

            stop = threading.Event()

            def storm():
                try:
                    c = MerkleKVClient(
                        "127.0.0.1", router.port, timeout=10
                    ).connect()
                    try:
                        i = 0
                        while not stop.is_set():
                            k = f"rt:{i % 200:04d}"
                            c.set(k, kv[k])  # same value: keyset stable
                            i += 1
                            time.sleep(0.002)
                    finally:
                        c.close()
                except BaseException as e:
                    errors.append(e)

            t = threading.Thread(target=storm, daemon=True)
            t.start()
            time.sleep(0.05)
            assert cluster.split().startswith("OK")
            assert wait_for(
                lambda: cluster.donor_state() in ("done", "failed"),
                timeout=60,
            )
            assert cluster.donor_state() == "done"
            time.sleep(0.3)
            stop.set()
            t.join(timeout=10)
            assert not errors, f"dumb client saw: {errors[0]!r}"

            assert all(rc.get(k) == v for k, v in kv.items())
            m = rc.partition_map()
            assert m.epoch == 2 and m.count == 3
    finally:
        if router is not None:
            router.stop()
        cluster.close()


# ------------------------------------------------- spawned processes

# Hold the snapshot stream open ~2 s (tiny chunks + per-chunk pause) so
# the kill -9 lands mid-stream; shrink the joiner's donor-loss resolve
# budget so the drill doesn't wait out the production default.
CHAOS_ENV = {
    "MERKLEKV_REBALANCE_CHUNK_BYTES": "1024",
    "MERKLEKV_REBALANCE_FETCH_PAUSE_S": "0.05",
    "MERKLEKV_REBALANCE_RESOLVE_S": "8",
}


class ProcCluster:
    """Broker + donor (p0) + sibling (p1) + one reserve, all real
    processes with durable storage, chaos knobs armed."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.topic = f"rbproc-{uuid.uuid4().hex[:8]}"
        self.ports = free_ports(3)
        self.addr = [f"127.0.0.1:{p}" for p in self.ports]
        self.spec = f"0={self.addr[0]};1={self.addr[1]}"
        self.procs = {}
        self.broker = self._spawn(["-m", "merklekv_tpu_torch.broker",
                                   "--port", "0"])
        self.broker_port = self._port_from(self.broker)
        for i in range(3):
            self.spawn_node(i)

    def _spawn(self, args):
        env = dict(os.environ, PYTHONPATH=REPO,
                   MERKLEKV_TORCH_DEVICE="cpu", **CHAOS_ENV)
        return subprocess.Popen(
            [sys.executable, *args],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )

    def _port_from(self, proc):
        line = proc.stdout.readline()
        assert "listening on" in line, f"unexpected startup line: {line!r}"
        port = int(line.rsplit(":", 1)[1].split()[0])
        # Drain the rest so a chatty node never blocks on a full pipe.
        threading.Thread(
            target=lambda: [None for _ in proc.stdout], daemon=True
        ).start()
        return port

    def _wait_port(self, port, timeout=30):
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                socket.create_connection(
                    ("127.0.0.1", port), timeout=1
                ).close()
                return
            except OSError:
                time.sleep(0.05)
        raise TimeoutError(f"port {port} never came up")

    def node_toml(self, i):
        cluster = (
            f'[cluster]\npartitions = 2\npartition_id = {i}\n'
            f'partition_map = "{self.spec}"\n'
            if i < 2
            else ""
        )
        cfg = self.tmp / f"node-{i}.toml"
        cfg.write_text(
            f"""
host = "127.0.0.1"
port = {self.ports[i]}
engine = "mem"
storage_path = "{self.tmp}/n{i}"
{cluster}
[storage]
enabled = true
merkle_engine = "cpu"

[replication]
enabled = {"true" if i < 2 else "false"}
mqtt_broker = "127.0.0.1"
mqtt_port = {self.broker_port}
topic_prefix = "{self.topic}"

[anti_entropy]
engine = "cpu"
interval_seconds = 3600

[observability]
flight_spill_s = 0.5
"""
        )
        return cfg

    def spawn_node(self, i):
        proc = self._spawn(["-m", "merklekv_tpu_torch", "--config",
                            str(self.node_toml(i))])
        self.procs[i] = proc
        self._wait_port(self._port_from(proc))
        return proc

    def kill9(self, i):
        killer = PeerProcessKiller(self.procs.pop(i))
        killer.kill_now()
        assert killer.killed

    def client(self, i, timeout=10):
        return MerkleKVClient("127.0.0.1", self.ports[i], timeout=timeout)

    def rebal_state(self, i):
        with self.client(i) as c:
            return c.rebalance("STATUS").split(" ")[1]

    def split(self, joiner=2):
        with self.client(0) as c:
            epoch = c.partition_map().epoch
            resp = c.rebalance(f"SPLIT 0 {epoch} {self.addr[joiner]}")
        assert resp.startswith("OK"), resp
        return resp

    def wait_state(self, i, want, timeout=60):
        deadline = time.time() + timeout
        state = None
        while time.time() < deadline:
            try:
                state = self.rebal_state(i)
            except OSError:
                state = None
            if state in want:
                return state
            time.sleep(0.02)
        raise TimeoutError(f"node {i} never reached {want} (last {state})")

    def close(self):
        for proc in list(self.procs.values()) + [self.broker]:
            proc.terminate()
        for proc in list(self.procs.values()) + [self.broker]:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()


@pytest.fixture
def cluster(tmp_path):
    cl = ProcCluster(tmp_path)
    try:
        yield cl
    finally:
        cl.close()


def _seed_proc(cl, n=3000):
    pc = PartitionedClient([cl.addr[0]], timeout=10).connect()
    for i in range(n):
        pc.set(f"rb:{i:06d}", f"v-{i}")
    pc.close()
    return {f"rb:{i:06d}": f"v-{i}" for i in range(n)}


def _root_of(cl, i, pid):
    with cl.client(i) as c:
        c.partition_id = pid  # pt=-addressed: MOVED if misrouted
        return c.hash()


def _dbsize_of(cl, i):
    with cl.client(i) as c:
        return c.dbsize()


def _readback_all(cl, kv):
    pc = PartitionedClient([cl.addr[1]], timeout=10).connect()
    try:
        missing = [k for k, v in kv.items() if pc.get(k) != v]
        assert not missing, f"{len(missing)} keys lost, e.g. {missing[:3]}"
    finally:
        pc.close()


@pytest.mark.integration
def test_kill9_joiner_mid_transfer_then_clean_split(cluster):
    kv = _seed_proc(cluster)
    root0 = _root_of(cluster, 0, 0)
    p0_before = _dbsize_of(cluster, 0)

    # Kill the joiner mid-stream: wait until it is actively fetching
    # (join_fetch), let a few chunks land, then SIGKILL.
    cluster.split(joiner=2)
    cluster.wait_state(2, {"join_fetch"}, timeout=30)
    time.sleep(0.3)
    cluster.kill9(2)

    # The donor declares the joiner dead and rolls the whole session
    # back: old epoch, bit-identical root, every key still served.
    cluster.wait_state(0, {"failed"}, timeout=60)
    with cluster.client(0) as c:
        m = c.partition_map()
    assert (m.epoch, m.count) == (1, 2)
    assert _root_of(cluster, 0, 0) == root0
    _readback_all(cluster, kv)

    # The SAME donor completes a clean split against a respawned
    # reserve — a failed rebalance must not poison the next one.
    cluster.spawn_node(2)
    cluster.split(joiner=2)
    cluster.wait_state(0, {"done"}, timeout=120)
    with cluster.client(0) as c:
        m = c.partition_map()
    assert (m.epoch, m.count) == (2, 3)
    moved = _dbsize_of(cluster, 2)
    assert moved > 0
    assert _dbsize_of(cluster, 0) + moved == p0_before
    _readback_all(cluster, kv)


@pytest.mark.integration
def test_kill9_donor_mid_transfer_joiner_aborts_blackbox_parses(cluster):
    kv = _seed_proc(cluster)
    root1 = _root_of(cluster, 1, 1)

    # A storm against partition 1 rides through the whole drill: the
    # donor's death mid-rebalance must not touch the other partition.
    p1_keys = [
        k for k in kv
        if hash_of_key(k.encode()) % 2 == 1
    ][:200]
    assert p1_keys
    errors = []
    stop = threading.Event()

    def storm():
        pc = PartitionedClient([cluster.addr[1]], timeout=10).connect()
        try:
            i = 0
            while not stop.is_set():
                pc.set(p1_keys[i % len(p1_keys)], kv[p1_keys[i % len(p1_keys)]])
                i += 1
                time.sleep(0.002)
        except BaseException as e:
            errors.append(e)
        finally:
            pc.close()

    t = threading.Thread(target=storm, daemon=True)
    t.start()
    try:
        cluster.split(joiner=2)
        cluster.wait_state(2, {"join_fetch"}, timeout=30)
        time.sleep(0.3)
        cluster.kill9(0)

        # The joiner loses its donor mid-stream, aborts on its own, and
        # returns to reserve duty holding nothing.
        cluster.wait_state(2, {"join_aborted"}, timeout=60)
        assert _dbsize_of(cluster, 2) == 0

        # The kill -9'd donor left a parseable black box behind.
        flight = os.path.join(
            str(cluster.tmp), "n0", f"node-{cluster.ports[0]}", "flight"
        )
        rc = subprocess.run(
            [sys.executable, "-m", "merklekv_tpu_torch", "blackbox", flight],
            env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT,
        ).returncode
        assert rc == 0, f"blackbox analyzer failed on {flight}"

        # Respawn the donor: WAL recovery resurrects the FULL keyspace
        # at the old epoch (the commit point was never reached).
        cluster.spawn_node(0)
        with cluster.client(0) as c:
            m = c.partition_map()
        assert (m.epoch, m.count) == (1, 2)
        _readback_all(cluster, kv)

        # And the cluster is not poisoned: a re-issued split commits.
        cluster.wait_state(2, {"join_aborted", "idle"}, timeout=10)
        cluster.split(joiner=2)
        cluster.wait_state(0, {"done"}, timeout=120)
        with cluster.client(0) as c:
            m = c.partition_map()
        assert (m.epoch, m.count) == (2, 3)
        _readback_all(cluster, kv)
    finally:
        stop.set()
        t.join(timeout=10)

    assert not errors, f"storm saw errors: {errors[:3]!r}"
    assert _root_of(cluster, 1, 1) == root1  # p1 untouched by the drill


# ------------------------------------------------ the range root on the device


def _hashlib_root(items) -> str:
    level = [hashlib.sha256(struct.pack(">I", len(k)) + k + struct.pack(">I", len(v)) + v).digest()
             for k, v in sorted(items)]
    while len(level) > 1:
        nxt = [hashlib.sha256(level[i] + level[i + 1]).digest()
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0].hex() if level else "0" * 64


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4095, 4096, 4097])
def test_range_root_on_the_device_path_matches_jax_and_hashlib(n):
    items = sorted((b"mv:%07d" % (i * 7919 % 100_003), b"x" * (i % 23))
                   for i in range(n))
    want = _hashlib_root(items)
    assert jrb_mod._range_root_hex(items) == want
    for engine in ("tpu", "auto"):
        assert rb_mod._range_root_hex(items, engine) == want, engine


def _in_range_root() -> bool:
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "_range_root_hex":
            return True
        f = f.f_back
    return False


def test_device_failure_in_the_range_root_rolls_the_split_back(tmp_path, monkeypatch):
    """The moving range's root fails on the device (snapshot roots and the
    joiner's verification still work there): the failure is counted in
    ``device.fallbacks`` and raised into the state machine, the donor rolls
    back at epoch E with every write readable and the fence open, and no
    root is ever computed on the host."""
    monkeypatch.setattr(rb_mod, "_POLL_FAILURE_BUDGET", 4)
    cluster = RebalCluster(tmp_path, device=True)
    real_device_root = snapmod._device_root_hex
    range_calls = []

    def failing_in_range_root(items):
        if _in_range_root():
            range_calls.append(len(items))
            raise RuntimeError("injected device failure")
        return real_device_root(items)

    host_levels = []
    real_build_levels = cpu_merkle.build_levels

    def spy_build_levels(*a, **kw):
        host_levels.append(len(a[0]) if a else 0)
        return real_build_levels(*a, **kw)

    try:
        pc = PartitionedClient([cluster.addr[0]], timeout=5).connect()
        kv = _seed(pc)
        fallbacks = get_metrics().snapshot()["counters"].get("device.fallbacks", 0)
        monkeypatch.setattr(snapmod, "_device_root_hex", failing_in_range_root)
        monkeypatch.setattr(cpu_merkle, "build_levels", spy_build_levels)
        assert cluster.split().startswith("OK")
        assert wait_for(lambda: cluster.donor_state() == "failed", timeout=60)
        assert range_calls, "the range root never reached the device"
        assert not host_levels, "a root was computed on the host"
        assert get_metrics().snapshot()["counters"]["device.fallbacks"] > fallbacks
        with cluster.client(0) as c:
            assert c.partition_map().epoch == 1
        assert load_map_file(os.path.join(str(tmp_path), "n0")) is None
        for k, v in kv.items():
            assert pc.get(k) == v
        p0 = next(k for k in kv if partition_of(k, 2) == 0)
        assert pc.set(p0, "post-abort")  # the fence is open again
        assert pc.get(p0) == "post-abort"
        pc.close()
    finally:
        cluster.close()
