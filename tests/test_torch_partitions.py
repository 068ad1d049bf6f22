"""Partitioned cluster mode in the torch port, on the CPU.

The cases of ``tests/test_partitions.py`` and
``tests/test_partition_chaos_proc.py`` against the port's modules
(``cluster/partmap.py``, ``cluster/router.py``, the partitioned
``ClusterNode``, ``PartitionedClient``) and spawned
``python -m merklekv_tpu_torch`` nodes; the JAX file's ``top`` and
``blackbox`` cases are in ``tests/test_torch_obs_tools.py``, its
``bench_gate`` case waits for the benchmark. Then parity with the JAX
package:

- ``partition_of`` equals the JAX package's for 10,000 seeded keys at P in
  {1, 2, 3, 4, 7, 16}, and the native guard's ``ERROR MOVED`` answers;
- v1 and v2 map specs, ``PARTMAP`` texts and ``partmap.spec`` files are
  byte-identical, and a map file written by either package loads under the
  other;
- a partitioned node with its mirror on the node's device
  (``MERKLEKV_TORCH_DEVICE=cpu``: the kernels' plain versions) serves its
  partition's root, equal to the golden tree over the partition's items.

Every node here runs with ``MERKLEKV_TORCH_DEVICE=cpu``. Tolerance: exact
equality.
"""

import os
import socket
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

from merklekv_tpu.cluster import partmap as jpartmap
from merklekv_tpu_torch.client import (
    MerkleKVClient,
    MerkleKVError,
    MovedError,
    PartitionedClient,
    ProtocolError,
    ServerBusyError,
)
from merklekv_tpu_torch.cluster.node import ClusterNode
from merklekv_tpu_torch.cluster.partmap import (
    PartitionMap,
    PartitionMapError,
    parse_map_spec,
    partition_of,
)
from merklekv_tpu_torch.cluster.transport import TcpBroker
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.native_bindings import NativeEngine, NativeServer
from merklekv_tpu_torch.obs.flightrec import get_recorder
from merklekv_tpu_torch.cluster import partmap as tpartmap
from merklekv_tpu_torch.merkle.cpu import build_levels
from merklekv_tpu_torch.merkle.encoding import leaf_hash
from merklekv_tpu_torch.testing.faults import PeerProcessKiller


@pytest.fixture(autouse=True)
def cpu_env(monkeypatch):
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")


def wait_for(fn, timeout=10.0, interval=0.02):
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


def keys_for(pid: int, count: int, n: int, tag: str = "k") -> list[str]:
    """Deterministic keys hashing to partition ``pid`` of ``count``."""
    out, i = [], 0
    while len(out) < n:
        k = f"{tag}:{i:06d}"
        if partition_of(k, count) == pid:
            out.append(k)
        i += 1
    return out


# ------------------------------------------------------------- unit layer


def test_partition_of_stable_and_range():
    # Golden stability: the function is a wire contract (native guard,
    # clients, router, bench drivers all route with it) — a change here
    # remaps every deployed keyspace.
    assert partition_of(b"key:000000", 4) == partition_of("key:000000", 4)
    for count in (1, 2, 4, 16):
        seen = {partition_of(f"k{i}", count) for i in range(400)}
        assert seen <= set(range(count))
        if count <= 4:
            assert seen == set(range(count))  # every partition reachable
    with pytest.raises(ValueError):
        partition_of("k", 0)


def test_partition_of_matches_native_guard():
    """Python routing and the native dispatch guard MUST agree key by key
    — disagreement turns every write into a MOVED ping-pong."""
    eng = NativeEngine("mem")
    srv = NativeServer(eng, "127.0.0.1", 0)
    srv.set_partition(3, 4, 1)
    srv.start()
    try:
        with MerkleKVClient("127.0.0.1", srv.port) as c:
            for i in range(64):
                k = f"agree:{i}"
                pid = partition_of(k, 4)
                if pid == 1:
                    assert c.set(k, "v")
                else:
                    with pytest.raises(MovedError) as ei:
                        c.set(k, "v")
                    assert ei.value.partition == pid
                    assert ei.value.epoch == 3
    finally:
        srv.close()
        eng.close()


def test_partmap_wire_roundtrip_and_validation():
    m = PartitionMap(
        epoch=7,
        replicas=[["h:1", "h:2"], ["h:3"], ["h:4", "h:5"]],
    ).validate()
    wire = m.wire()
    lines = wire.split("\r\n")
    assert lines[0] == "PARTMAP 7 3"
    assert lines[-2] == "END"
    parsed = PartitionMap.from_wire(lines[0], lines[1:-2])
    assert parsed == m
    # Every malformation raises, never a partial map.
    bad = [
        ("PARTMAP 7", lines[1:-2]),            # short header
        ("PARTMAP x 3", lines[1:-2]),          # non-numeric epoch
        ("PARTMAP 0 3", lines[1:-2]),          # epoch < 1
        ("PARTMAP 7 3", lines[1:3]),           # missing row
        ("PARTMAP 7 3", lines[1:3] + ["9 h:1"]),   # pid out of range
        ("PARTMAP 7 3", lines[1:3] + [lines[1]]),  # duplicate pid
        ("PARTMAP 7 3", lines[1:3] + ["2"]),       # row without replicas
        ("PARTMAP 7 3", lines[1:3] + ["2 nohostport"]),
        ("PARTMAP 7 3", lines[1:3] + ["2 h:notaport"]),
    ]
    for header, rows in bad:
        with pytest.raises(PartitionMapError):
            PartitionMap.from_wire(header, rows)


def test_parse_map_spec_validation():
    m = parse_map_spec("0=a:1,b:2;1=c:3", 2, epoch=4)
    assert m.epoch == 4 and m.count == 2
    assert m.replicas[0] == ["a:1", "b:2"]
    for spec, count in [
        ("0=a:1", 2),              # missing partition 1
        ("0=a:1;0=b:2", 1),        # duplicate group
        ("2=a:1;0=b:2", 2),        # pid out of range
        ("0=", 1),                 # no replicas
        ("0=a", 1),                # not host:port
        ("nonsense", 1),           # no '='
    ]:
        with pytest.raises(PartitionMapError):
            parse_map_spec(spec, count)


def test_cluster_config_validation():
    base = {
        "cluster": {
            "partitions": 2,
            "partition_id": 0,
            "partition_map": "0=a:1;1=b:2",
        }
    }
    cfg = Config.from_dict(base)
    assert cfg.cluster.partitions == 2
    for mutation in [
        {"partition_id": 5},
        {"partition_id": -1},
        {"partition_map": ""},
        {"partition_map": "0=a:1"},  # incomplete coverage
        {"map_epoch": 0},
        {"partitions": -1},
    ]:
        raw = {"cluster": dict(base["cluster"], **mutation)}
        with pytest.raises(ValueError):
            Config.from_dict(raw)
    # Unpartitioned configs ignore the id/map entirely.
    assert Config.from_dict({}).cluster.partitions == 0


def test_cluster_node_validates_programmatic_partition_config():
    """A programmatically built Config bypasses
    Config.from_dict, and the default partition_id=-1 would make the node
    enforce partition 0 while deriving peers from replicas[-1] — the
    constructor must refuse loudly."""
    eng = NativeEngine("mem")
    srv = NativeServer(eng, "127.0.0.1", 0)
    try:
        cfg = Config()
        cfg.cluster.partitions = 2
        cfg.cluster.partition_map = "0=a:1;1=b:2"
        # partition_id left at the -1 default
        with pytest.raises(ValueError, match="partition_id"):
            ClusterNode(cfg, eng, srv)
    finally:
        srv.close()
        eng.close()


def test_shrunk_map_surfaces_moved_not_indexerror():
    """A map refresh that SHRINKS the partition
    count mid-operation must surface the typed MovedError (healable by
    the retry loop), never a raw IndexError."""
    pc = PartitionedClient(["127.0.0.1:1"])  # never connected
    pc._map = PartitionMap(epoch=3, replicas=[["a:1"], ["b:2"]]).validate()
    with pytest.raises(MovedError) as ei:
        pc._client(5)
    assert ei.value.partition == 5 and ei.value.epoch == 3


def test_moved_error_typed_and_retry_classification():
    from merklekv_tpu_torch.cluster.retry import (
        ROUTED_RETRYABLE_ERRORS,
        RETRYABLE_ERRORS,
    )

    assert MovedError in ROUTED_RETRYABLE_ERRORS
    # A plain caller has no map to refresh: retrying the same node would
    # collect the same refusal, so generic retries exclude it.
    assert MovedError not in RETRYABLE_ERRORS
    assert issubclass(MovedError, ProtocolError)


# ------------------------------------------------------- native guard layer


@pytest.fixture
def guarded_server():
    eng = NativeEngine("mem")
    srv = NativeServer(eng, "127.0.0.1", 0)
    srv.set_partition(5, 4, 2)
    srv.start()
    yield eng, srv
    srv.close()
    eng.close()


def test_native_guard_every_key_verb(guarded_server):
    eng, srv = guarded_server
    own = keys_for(2, 4, 4, "g")
    foreign = keys_for(1, 4, 2, "g")
    with MerkleKVClient("127.0.0.1", srv.port) as c:
        assert c.set(own[0], "v")
        assert c.get(own[0]) == "v"
        for op in (
            lambda: c.set(foreign[0], "v"),
            lambda: c.get(foreign[0]),
            lambda: c.delete(foreign[0]),
            lambda: c.increment(foreign[0]),
            lambda: c.append(foreign[0], "x"),
            lambda: c.mget([own[0], foreign[0]]),
            lambda: c.mset({own[1]: "v", foreign[1]: "v"}),
            lambda: c.exists(own[0], foreign[0]),
        ):
            with pytest.raises(MovedError) as ei:
                op()
            assert ei.value.partition == 1
            assert ei.value.epoch == 5
        # The foreign keys never landed (MSET refused whole).
        assert eng.get(foreign[1].encode()) is None
        # Keyless verbs and the management plane stay open.
        assert c.ping().startswith("PONG")
        assert c.dbsize() >= 1
        stats = c.stats()
        assert int(stats["moved_commands"]) >= 8
        assert stats["partition_id"] == "2"
        assert stats["partition_count"] == "4"
        assert stats["partition_epoch"] == "5"


def test_pt_addressing_hash_and_treelevel(guarded_server):
    eng, srv = guarded_server
    eng.set(keys_for(2, 4, 1, "pt")[0].encode(), b"v")
    with MerkleKVClient("127.0.0.1", srv.port) as c:
        c.partition_id = 2
        root = c.hash()
        assert len(bytes.fromhex(root)) == 32
        rows, n = c.tree_level(0, 0, 0)
        assert n >= 1
        c.partition_id = 3  # stale map: this node no longer serves 3
        with pytest.raises(MovedError) as ei:
            c.hash()
        assert ei.value.partition == 3
        with pytest.raises(MovedError):
            c.tree_level(0, 0, 0)


def test_pt_token_ignored_on_unpartitioned_node():
    # Degenerate single-group deployment: an unpartitioned node serves its
    # whole keyspace regardless of the address (count 0 = guard off).
    eng = NativeEngine("mem")
    srv = NativeServer(eng, "127.0.0.1", 0)
    srv.start()
    try:
        eng.set(b"u", b"v")
        with MerkleKVClient("127.0.0.1", srv.port) as c:
            c.partition_id = 3
            assert len(bytes.fromhex(c.hash())) == 32
            _, n = c.tree_level(0, 0, 0)
            assert n == 1
    finally:
        srv.close()
        eng.close()


# ------------------------------------------------------- PARTMAP wire fuzz


class _CannedServer:
    """One-shot server: accept a connection, read one line, answer the
    canned bytes, close — the hostile-donor rig for wire fuzzing."""

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
                conn.recv(4096)  # the PARTMAP request line
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


def _fetch_map_from_canned(payload: bytes):
    srv = _CannedServer(payload)
    try:
        with MerkleKVClient("127.0.0.1", srv.port, timeout=2.0) as c:
            return c.partition_map()
    finally:
        srv.close()


def test_partmap_fuzz_truncation_every_offset():
    """A PARTMAP reply cut at EVERY byte offset either parses as a fully
    valid map (cut past the END) or raises a clean typed error — never a
    partial map, never a hang, never a non-client exception."""
    good = (
        "PARTMAP 3 2\r\n"
        "0 127.0.0.1:7001 127.0.0.1:7002\r\n"
        "1 127.0.0.1:7003 127.0.0.1:7004\r\n"
        "END\r\n"
    ).encode()
    full_len = len(good)
    for cut in range(full_len + 1):
        try:
            m = _fetch_map_from_canned(good[:cut])
        except (MerkleKVError, PartitionMapError):
            continue  # clean refusal (ProtocolError/ConnectionError/...)
        assert cut >= full_len - 2, f"partial map accepted at cut={cut}"
        assert m.count == 2 and m.epoch == 3
        assert m.replicas[1] == ["127.0.0.1:7003", "127.0.0.1:7004"]


def test_partmap_fuzz_seeded_byte_flips():
    """48 seeded single-byte corruptions: every outcome is either a clean
    typed error or a STILL-VALID map object (a flipped digit inside a
    port number is indistinguishable from a legitimate map — but it must
    parse/validate as one, never crash or half-parse)."""
    import random

    good = (
        "PARTMAP 3 2\r\n"
        "0 127.0.0.1:7001 127.0.0.1:7002\r\n"
        "1 127.0.0.1:7003 127.0.0.1:7004\r\n"
        "END\r\n"
    ).encode()
    rng = random.Random(1504)
    for _ in range(48):
        pos = rng.randrange(len(good))
        flip = bytes([good[pos] ^ (1 << rng.randrange(8))])
        payload = good[:pos] + flip + good[pos + 1:]
        try:
            m = _fetch_map_from_canned(payload)
        except (MerkleKVError, PartitionMapError):
            continue
        m.validate()  # whatever came back is a complete, coherent map
        assert m.count == len(m.replicas)


# --------------------------------------------------- in-process clusters


class PartCluster:
    """P partitions x R replicas of in-process ClusterNodes on fixed
    ports, replicating per partition over one shared broker."""

    def __init__(
        self,
        partitions: int,
        replicas: int,
        anti_entropy: bool = False,
        env_for=None,  # optional {(pid, r): {ENV: val}} during start
    ) -> None:
        self.partitions = partitions
        self.replicas = replicas
        self.broker = TcpBroker()
        self.topic = f"part-{uuid.uuid4().hex[:8]}"
        ports = free_ports(partitions * replicas)
        self.addr = [
            [
                f"127.0.0.1:{ports[p * replicas + r]}"
                for r in range(replicas)
            ]
            for p in range(partitions)
        ]
        self.spec = ";".join(
            f"{p}=" + ",".join(self.addr[p]) for p in range(partitions)
        )
        self.engines: dict[tuple[int, int], NativeEngine] = {}
        self.servers: dict[tuple[int, int], NativeServer] = {}
        self.nodes: dict[tuple[int, int], ClusterNode] = {}
        self._anti_entropy = anti_entropy
        for p in range(partitions):
            for r in range(replicas):
                overrides = (env_for or {}).get((p, r), {})
                saved = {k: os.environ.get(k) for k in overrides}
                os.environ.update(overrides)
                try:
                    self.start_node(p, r)
                finally:
                    for k, v in saved.items():
                        if v is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = v

    def _cfg(self, pid: int, r: int) -> Config:
        cfg = Config()
        cfg.host = "127.0.0.1"
        cfg.port = int(self.addr[pid][r].rsplit(":", 1)[1])
        cfg.cluster.partitions = self.partitions
        cfg.cluster.partition_id = pid
        cfg.cluster.partition_map = self.spec
        cfg.replication.enabled = True
        cfg.replication.mqtt_broker = self.broker.host
        cfg.replication.mqtt_port = self.broker.port
        cfg.replication.topic_prefix = self.topic
        cfg.anti_entropy.enabled = self._anti_entropy
        cfg.anti_entropy.engine = "cpu"  # no device mirror in tests
        cfg.anti_entropy.interval_seconds = 3600.0  # manual sync only
        return cfg

    def start_node(
        self, pid: int, r: int, reuse_engine: bool = True
    ) -> ClusterNode:
        key = (pid, r)
        eng = self.engines.get(key) if reuse_engine else None
        if eng is None:
            eng = NativeEngine("mem")
            self.engines[key] = eng
        port = int(self.addr[pid][r].rsplit(":", 1)[1])
        srv = NativeServer(eng, "127.0.0.1", port)
        srv.start()
        self.servers[key] = srv
        node = ClusterNode(self._cfg(pid, r), eng, srv)
        node.start()
        self.nodes[key] = node
        return node

    def kill(self, pid: int, r: int) -> None:
        """Abrupt replica death, as observable from the wire: the
        listener and every established connection die FIRST (clients see
        resets, like a crashed process), then the in-process control
        plane is reaped and the native object freed — the drain threads
        must not race a destroyed server (a real SIGKILL takes them out
        atomically; the spawned-process test below covers that shape). The
        engine object survives only as the restart seed (warm rejoin)."""
        key = (pid, r)
        srv = self.servers.pop(key)
        srv.stop()  # connections reset NOW — the death the storm sees
        node = self.nodes.pop(key)
        try:
            node.stop()
        except Exception:
            pass  # a dead server mid-teardown is the point
        srv.close()

    def root(self, pid: int, r: int) -> bytes:
        return self.engines[(pid, r)].merkle_root() or b""

    def close(self) -> None:
        for key in list(self.nodes):
            try:
                self.nodes[key].stop()
            except Exception:
                pass
        for srv in self.servers.values():
            srv.close()
        for eng in self.engines.values():
            eng.close()
        self.broker.close()


# ------------------------------------------------------- smart client layer


def test_partitioned_client_routes_and_isolates():
    cluster = PartCluster(2, 1)
    try:
        seeds = [cluster.addr[0][0]]
        with PartitionedClient(seeds) as pc:
            assert pc.map.count == 2
            kv = {f"r:{i:04d}": f"v{i}" for i in range(60)}
            for k, v in kv.items():
                pc.set(k, v)
            assert all(pc.get(k) == v for k, v in kv.items())
            got = pc.mget(list(kv))
            assert got == kv
            assert pc.exists(*list(kv)[:10]) == 10
            pc.mset({"m:1": "a", "m:2": "b"})
            assert pc.get("m:1") == "a"
            # Partition purity: every engine holds ONLY its own keys.
            for k in kv:
                pid = partition_of(k, 2)
                assert cluster.engines[(pid, 0)].get(k.encode()) is not None
                assert cluster.engines[(1 - pid, 0)].get(k.encode()) is None
            # Per-partition roots resolve (pt=-addressed), and differ.
            roots = pc.partition_roots()
            assert set(roots) == {0, 1} and roots[0] != roots[1]
    finally:
        cluster.close()


def test_stale_map_never_a_silent_wrong_node_read():
    """The stale-map safety headline: a client routing partition 1's keys
    at partition 0's node gets MOVED -> refresh -> re-route, and the key
    lands ONLY on the right node. Without the guard this is a silent
    wrong-node write followed by a silent empty read."""
    cluster = PartCluster(2, 1)
    try:
        pc = PartitionedClient([cluster.addr[0][0]]).connect()
        # Doctor the map: both partitions allegedly live on node 0.
        pc._map = PartitionMap(
            epoch=1,
            replicas=[[cluster.addr[0][0]], [cluster.addr[0][0]]],
        ).validate()
        k1 = keys_for(1, 2, 1, "stale")[0]
        pc.set(k1, "routed-right")  # MOVED -> refresh -> correct node
        assert pc.map.replicas == cluster.nodes[(0, 0)]._partmap.replicas
        assert cluster.engines[(1, 0)].get(k1.encode()) == b"routed-right"
        assert cluster.engines[(0, 0)].get(k1.encode()) is None
        assert pc.get(k1) == "routed-right"
        pc.close()
        # A DUMB client with the same stale idea gets the typed refusal —
        # never a silent NOT_FOUND from the wrong node's keyspace.
        host, _, port = cluster.addr[0][0].rpartition(":")
        with MerkleKVClient(host, int(port)) as c:
            with pytest.raises(MovedError):
                c.get(k1)
    finally:
        cluster.close()


def test_async_partitioned_client_parity():
    import asyncio

    from merklekv_tpu_torch.client import AsyncPartitionedClient

    cluster = PartCluster(2, 1)
    try:
        async def drive():
            async with AsyncPartitionedClient(
                [cluster.addr[1][0]]
            ) as pc:
                for i in range(20):
                    await pc.set(f"a:{i}", f"v{i}")
                vals = [await pc.get(f"a:{i}") for i in range(20)]
                assert vals == [f"v{i}" for i in range(20)]
                # Stale map heals in the async client too.
                pc._map = PartitionMap(
                    epoch=1,
                    replicas=[[cluster.addr[0][0]], [cluster.addr[0][0]]],
                ).validate()
                k1 = keys_for(1, 2, 1, "astale")[0]
                await pc.set(k1, "ok")
                assert (await pc.get(k1)) == "ok"
                roots = {
                    p: await pc.partition_root(p) for p in range(2)
                }
                assert len(roots) == 2
            assert cluster.engines[(1, 0)].get(k1.encode()) == b"ok"

        asyncio.run(drive())
    finally:
        cluster.close()


# --------------------------------------------------------------- router


def test_router_routes_dumb_clients():
    from merklekv_tpu_torch.cluster.router import PartitionRouter

    cluster = PartCluster(2, 1)
    router = None
    try:
        router = PartitionRouter(
            seeds=[cluster.addr[0][0]]
        ).start()
        with MerkleKVClient("127.0.0.1", router.port) as c:
            kv = {f"rt:{i:03d}": f"v{i}" for i in range(40)}
            for k, v in kv.items():
                assert c.set(k, v)
            assert all(c.get(k) == v for k, v in kv.items())
            assert c.mget(list(kv)) == kv
            c.mset({"rm:1": "x", "rm:2": "y"})
            assert c.exists("rm:1", "rm:2", "rt:000") == 3
            assert c.delete("rm:1") is True
            assert c.delete("rm:1") is False
            assert c.increment("rc", 5) == 5
            assert c.dbsize() == len(kv) + 2  # rm:2 + rc
            assert sorted(c.scan("rt:")) == sorted(kv)
            assert c.ping().startswith("PONG")
            m = c.partition_map()
            assert m.count == 2
            # Values with spaces survive the relay byte-exactly.
            c.set("sp", "a b  c")
            assert c.get("sp") == "a b  c"
            # Thin by design: node-local verbs are refused loudly.
            with pytest.raises(ProtocolError, match="router"):
                c.stats()
        # Key placement is partition-pure through the router too.
        for k in kv:
            pid = partition_of(k, 2)
            assert cluster.engines[(pid, 0)].get(k.encode()) is not None
            assert cluster.engines[(1 - pid, 0)].get(k.encode()) is None
    finally:
        if router is not None:
            router.stop()
        cluster.close()


def test_router_heals_stale_map():
    from merklekv_tpu_torch.cluster.router import PartitionRouter

    cluster = PartCluster(2, 1)
    router = None
    try:
        router = PartitionRouter(seeds=[cluster.addr[0][0]]).start()
        # Doctor the router's map (both partitions -> node 0): commands
        # for partition 1 hit MOVED, refresh, and land correctly.
        with router._map_mu:
            router._map = PartitionMap(
                epoch=1,
                replicas=[[cluster.addr[0][0]], [cluster.addr[0][0]]],
            ).validate()
        k1 = keys_for(1, 2, 1, "rtstale")[0]
        with MerkleKVClient("127.0.0.1", router.port) as c:
            assert c.set(k1, "healed")
            assert c.get(k1) == "healed"
        assert cluster.engines[(1, 0)].get(k1.encode()) == b"healed"
        assert cluster.engines[(0, 0)].get(k1.encode()) is None
    finally:
        if router is not None:
            router.stop()
        cluster.close()


# ------------------------------------------- partition-scoped anti-entropy


def test_sync_refuses_cross_partition_peer():
    """A partitioned walk against a peer serving a DIFFERENT partition
    must fail loudly (MOVED surfaces through the sync cycle), never
    'converge' by mirroring a disjoint keyspace as divergence."""
    cluster = PartCluster(2, 1)
    try:
        for pid in range(2):
            for k in keys_for(pid, 2, 30, f"sy{pid}"):
                cluster.engines[(pid, 0)].set(k.encode(), b"v")
        n0 = cluster.nodes[(0, 0)]
        before = cluster.engines[(0, 0)].dbsize()
        host, _, port = cluster.addr[1][0].rpartition(":")
        with pytest.raises(MerkleKVError):
            n0.sync_manager.sync_once(host, int(port))
        # Nothing was repaired-in or mirrored-away.
        assert cluster.engines[(0, 0)].dbsize() == before
    finally:
        cluster.close()


class _ScriptedServer:
    """Per-verb canned responder: serves many requests on one connection,
    answering from a verb -> bytes table (the mid-cycle-lying-peer rig)."""

    def __init__(self, answers: dict[bytes, bytes]) -> None:
        self._answers = answers
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                conn.settimeout(5)
                f = conn.makefile("rb")
                while True:
                    raw = f.readline()
                    if not raw:
                        break
                    verb = raw.split()[0].upper() if raw.split() else b""
                    conn.sendall(
                        self._answers.get(verb, b"ERROR Unknown command\r\n")
                    )
            except OSError:
                pass
            finally:
                conn.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5)


def test_walk_probe_moved_never_degrades_to_paged_scan():
    """A peer whose ownership moved BETWEEN the
    HASH probe and the TREELEVEL probe must abort the cycle — the old
    probe-failure path read the MOVED as 'no TREELEVEL capability' and
    degraded to the paged HASHPAGE/LEAFHASHES scan, verbs the partition
    guard does not cover, against the wrong partition's keyspace."""
    from merklekv_tpu_torch.cluster.sync import SyncManager

    eng = NativeEngine("mem")
    try:
        for k in keys_for(0, 2, 50, "wp"):
            eng.set(k.encode(), b"v")
        before = eng.dbsize()
        # HASH answers a DIFFERENT root (forcing a transfer decision);
        # TREELEVEL answers MOVED (ownership changed mid-cycle); the
        # paged verbs answer too — reaching them is the bug.
        lying = _ScriptedServer({
            b"HASH": b"HASH " + b"a" * 64 + b"\r\n",
            b"TREELEVEL": b"ERROR MOVED 1 2\r\n",
            b"HASHPAGE": b"HASHES 0\r\n",
            b"LEAFHASHES": b"HASHES 0\r\n",
        })
        sm = SyncManager(eng, device="cpu", mode="bisect",
                         partition_id=0)
        try:
            with pytest.raises(MovedError):
                sm.sync_once("127.0.0.1", lying.port)
        finally:
            sm.stop()
            lying.close()
        # Nothing was mirrored away: an empty-paged-scan fallback would
        # have quiet-deleted the whole local keyspace.
        assert eng.dbsize() == before
    finally:
        eng.close()


def test_partition_map_desync_closes_connection():
    """A garbled PARTMAP header leaves an
    unknowable body in flight — the client must CLOSE before raising so
    a caller that catches the error cannot read leftover rows as later
    responses."""
    srv = _ScriptedServer({
        b"PARTMAP": b"PARTMAP 1 bogus\r\n0 h:1\r\nEND\r\n",
        b"PING": b"PONG \r\n",
    })
    try:
        c = MerkleKVClient("127.0.0.1", srv.port, timeout=2).connect()
        with pytest.raises(ProtocolError):
            c.partition_map()
        assert not c.is_connected()
    finally:
        srv.close()


def test_async_client_rotates_on_replica_death():
    """Mid-command socket deaths must surface
    as the module's typed ConnectionError in the ASYNC client too, or
    AsyncPartitionedClient's replica rotation never fires."""
    import asyncio

    from merklekv_tpu_torch.client import AsyncPartitionedClient

    cluster = PartCluster(1, 2)
    try:
        async def drive():
            pc = await AsyncPartitionedClient(
                [cluster.addr[0][0]], timeout=5
            ).connect()
            await pc.set("rot:1", "v1")
            # Kill whichever replica the client is talking to.
            used = pc._replica_idx.get(0, 0)
            cluster.kill(0, used)
            # The in-flight connection dies mid-read -> typed
            # ConnectionError -> rotation to the surviving sibling (the
            # value may or may not have replicated before the kill; what
            # must NOT happen is a raw ConnectionResetError escaping).
            assert (await pc.get("rot:1")) in ("v1", None)
            await pc.set("rot:2", "v2")
            assert (await pc.get("rot:2")) == "v2"
            await pc.close()

        asyncio.run(drive())
    finally:
        cluster.close()


# ---------------------------------------------- partition-scoped overload


def test_partition_scoped_overload_busy_isolated():
    """One partition's replica trips MKV_MAX_ENGINE_BYTES: ONLY that
    partition's writes answer BUSY; the sibling partition keeps serving
    with write p99 within 2x its baseline; /healthz reports per-partition
    readiness; the flight ring carries partition_degraded/healed for the
    sick partition only."""
    rec = get_recorder()
    rec.clear()
    cluster = PartCluster(
        2,
        1,
        env_for={(0, 0): {"MKV_MAX_ENGINE_BYTES": "4096"}},
    )
    try:
        p0 = keys_for(0, 2, 200, "ov0")
        # 300 writes per window: over 100, p99 is the second-worst write,
        # which one scheduler stall on a loaded host decides.
        p1 = keys_for(1, 2, 600, "ov1")
        h1, _, pt1 = cluster.addr[1][0].rpartition(":")
        h0, _, pt0 = cluster.addr[0][0].rpartition(":")
        c0 = MerkleKVClient(h0, int(pt0)).connect()
        c1 = MerkleKVClient(h1, int(pt1)).connect()
        try:
            # Baseline p99 on the healthy partition.
            base = []
            for k in p1[:300]:
                t0 = time.perf_counter_ns()
                c1.set(k, "x" * 64)
                base.append(time.perf_counter_ns() - t0)
            base.sort()
            base_p99 = base[296]

            # Flood partition 0 past its tiny hard watermark.
            def flooded() -> bool:
                for k in p0:
                    try:
                        c0.set(k, "x" * 256)
                    except (ServerBusyError, ProtocolError):
                        return True
                cluster.nodes[(0, 0)]._overload.poll_once()
                return False

            assert wait_for(flooded, timeout=20)
            assert wait_for(
                lambda: cluster.nodes[(0, 0)]._overload.poll_once() > 0
            )
            # Only partition 0's writes shed; reads stay open there.
            with pytest.raises((ServerBusyError, ProtocolError)):
                c0.set(p0[0], "y")
            assert c0.get(p0[0]) is not None
            # Sibling partition: writes still land, p99 within 2x.
            during = []
            for k in p1[300:]:
                t0 = time.perf_counter_ns()
                c1.set(k, "x" * 64)
                during.append(time.perf_counter_ns() - t0)
            during.sort()
            during_p99 = during[296]
            # Floor the bound at 2ms: sub-100us baselines flap on
            # scheduler noise, which is not partition interference.
            assert during_p99 <= max(2 * base_p99, 2_000_000), (
                f"sibling write p99 {during_p99}ns vs baseline "
                f"{base_p99}ns"
            )
            # Per-partition readiness on /healthz.
            pay0 = cluster.nodes[(0, 0)]._health_payload()
            pay1 = cluster.nodes[(1, 0)]._health_payload()
            assert pay0["partition"] == 0
            assert pay0["partition_state"] != "live"
            assert pay0["status"] == "degraded"
            assert pay1["partition"] == 1
            assert pay1["partition_state"] == "live"
            # METRICS integer lines carry the same verdict.
            m0 = dict(
                ln.split(":", 1)
                for ln in cluster.nodes[(0, 0)]._metrics_wire().splitlines()
                if ":" in ln and not ln.startswith("METRICS")
            )
            assert int(m0["partition.state"]) > 0
            assert m0["partition.id"] == "0"
            # Heal: free the engine, poll -> live, healed event.
            cluster.engines[(0, 0)].truncate()
            assert wait_for(
                lambda: cluster.nodes[(0, 0)]._overload.poll_once() == 0
            )
            events = rec.last(0)
            degraded = [
                e for e in events if e.kind == "partition_degraded"
            ]
            healed = [e for e in events if e.kind == "partition_healed"]
            assert degraded and all(
                e.fields["partition"] == 0 for e in degraded
            )
            assert healed and all(
                e.fields["partition"] == 0 for e in healed
            )
        finally:
            c0.close()
            c1.close()
    finally:
        cluster.close()


# ----------------------------------------------------- the chaos headline


def test_chaos_kill_one_replica_per_partition_mid_storm():
    """4 partitions x 2 replicas; a write storm runs against the primary
    replicas while replica B of EVERY partition dies abruptly; the storm
    never stalls, the surviving replicas never leave live (flight +
    METRICS), and after the B replicas rejoin, every partition
    reconverges to a bit-identical per-partition root with zero
    cross-partition interference."""
    P, R = 4, 2
    rec = get_recorder()
    rec.clear()
    cluster = PartCluster(P, R)
    storm_errors: list[BaseException] = []
    try:
        pc = PartitionedClient(
            [cluster.addr[0][0]], timeout=5.0
        ).connect()
        # Phase 1: seed every partition and wait for replica convergence,
        # so the killed replicas hold real pre-kill state.
        seed_keys = {
            p: keys_for(p, P, 40, "seed") for p in range(P)
        }
        for p in range(P):
            for i, k in enumerate(seed_keys[p]):
                pc.set(k, f"s{i}")
        for p in range(P):
            assert wait_for(
                lambda p=p: cluster.root(p, 0) == cluster.root(p, 1)
                and cluster.root(p, 0) != b"",
                timeout=15,
            ), f"partition {p} replicas never converged pre-kill"

        # Phase 2: the storm, with one replica per partition dying at
        # fixed points mid-stream (deterministic schedule, fixed keys).
        storm_keys = {
            p: keys_for(p, P, 120, "storm") for p in range(P)
        }
        stop_storm = threading.Event()

        def storm() -> None:
            try:
                i = 0
                while not stop_storm.is_set():
                    for p in range(P):
                        k = storm_keys[p][i % 120]
                        pc.set(k, f"w{i}")
                    i += 1
            except BaseException as e:
                storm_errors.append(e)

        t = threading.Thread(target=storm, daemon=True)
        t.start()
        time.sleep(0.3)
        for p in range(P):  # the kill wave: one replica in EVERY partition
            cluster.kill(p, 1)
            time.sleep(0.1)
        # Storm keeps running against the survivors; sample their state.
        time.sleep(0.5)
        for p in range(P):
            metrics = dict(
                ln.split(":", 1)
                for ln in cluster.nodes[(p, 0)]._metrics_wire().splitlines()
                if ":" in ln and not ln.startswith("METRICS")
            )
            assert metrics["partition.state"] == "0", (
                f"surviving replica of partition {p} left live mid-storm"
            )
        time.sleep(0.4)
        stop_storm.set()
        t.join(timeout=10)
        assert not storm_errors, f"storm failed: {storm_errors[0]!r}"

        # Flight: NO partition ever degraded — replica death sheds
        # nothing on the survivors (partition-local fault containment).
        assert [
            e for e in rec.last(0) if e.kind == "partition_degraded"
        ] == []

        # Phase 3: the killed replicas rejoin (warm engines, stale by the
        # storm delta) and one anti-entropy cycle per partition repairs
        # them from their sibling — partition-local, no cross-talk.
        for p in range(P):
            cluster.start_node(p, 1)
        for p in range(P):
            host, _, port = cluster.addr[p][0].rpartition(":")
            cluster.nodes[(p, 1)].sync_manager.sync_once(host, int(port))
        for p in range(P):
            assert wait_for(
                lambda p=p: cluster.root(p, 0) == cluster.root(p, 1),
                timeout=15,
            ), f"partition {p} did not reconverge after rejoin"
            assert cluster.root(p, 0) != b""
        # Bit-identical per-partition roots, all distinct across
        # partitions (disjoint keyspaces).
        roots = {p: cluster.root(p, 0) for p in range(P)}
        assert len(set(roots.values())) == P

        # Zero cross-partition interference: every engine is partition-
        # pure — no storm key leaked into a foreign replica group.
        for p in range(P):
            for q in range(P):
                for k in storm_keys[q][:10]:
                    present = (
                        cluster.engines[(p, 0)].get(k.encode())
                        is not None
                    )
                    assert present == (p == q), (
                        f"key of partition {q} on partition {p}"
                    )
        # And the storm's data is all there, readable through the map.
        for p in range(P):
            for k in storm_keys[p][:20]:
                assert pc.get(k) is not None
        pc.close()
    finally:
        cluster.close()


# ------------------------------------------------------- obs / top / gate


# ------------------------------------------------- spawned processes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, R = 2, 2


def _spawn(args):
    env = dict(os.environ, PYTHONPATH=REPO, MERKLEKV_TORCH_DEVICE="cpu")
    return subprocess.Popen(
        [sys.executable, *args],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        env=env,
    )


def _port_from(proc) -> int:
    line = proc.stdout.readline()
    assert "listening on" in line, f"unexpected startup line: {line!r}"
    return int(line.rsplit(":", 1)[1].split()[0])


def _wait_port(port, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"port {port} never came up")


@pytest.mark.integration
def test_kill_one_replica_per_partition_real_processes(tmp_path):
    ports = free_ports(P * R)
    addr = [
        [f"127.0.0.1:{ports[p * R + r]}" for r in range(R)]
        for p in range(P)
    ]
    spec = ";".join(f"{p}=" + ",".join(addr[p]) for p in range(P))
    topic = f"pchaos-{uuid.uuid4().hex[:8]}"
    procs = {}
    broker = _spawn(["-m", "merklekv_tpu_torch.broker", "--port", "0"])
    broker_port = _port_from(broker)

    def node_toml(p, r):
        cfg = tmp_path / f"node-{p}-{r}.toml"
        cfg.write_text(
            f"""
host = "127.0.0.1"
port = {ports[p * R + r]}
engine = "mem"

[cluster]
partitions = {P}
partition_id = {p}
partition_map = "{spec}"

[replication]
enabled = true
mqtt_broker = "127.0.0.1"
mqtt_port = {broker_port}
topic_prefix = "{topic}"

[anti_entropy]
engine = "cpu"
"""
        )
        return cfg

    def spawn_node(p, r):
        proc = _spawn(["-m", "merklekv_tpu_torch", "--config",
                       str(node_toml(p, r))])
        procs[(p, r)] = proc
        port = _port_from(proc)
        _wait_port(port)
        return proc

    try:
        for p in range(P):
            for r in range(R):
                spawn_node(p, r)

        def root_of(p, r):
            host, _, port = addr[p][r].rpartition(":")
            with MerkleKVClient(host, int(port), timeout=5) as c:
                c.partition_id = p  # pt=-addressed: MOVED if misrouted
                return c.hash()

        def metrics_of(p, r):
            host, _, port = addr[p][r].rpartition(":")
            with MerkleKVClient(host, int(port), timeout=5) as c:
                return c.metrics()

        pc = PartitionedClient([addr[0][0]], timeout=5).connect()
        assert pc.map.count == P

        # Seed + wait for in-partition replication to converge, so the
        # killed replicas die holding real state.
        for i in range(120):
            pc.set(f"seed:{i:04d}", f"s{i}")
        deadline = time.time() + 30
        for p in range(P):
            while time.time() < deadline:
                if root_of(p, 0) == root_of(p, 1):
                    break
                time.sleep(0.1)
            assert root_of(p, 0) == root_of(p, 1), (
                f"partition {p} never converged pre-kill"
            )

        # The storm + the kill wave: SIGKILL replica 1 of EVERY partition
        # while writes keep flowing through the smart client (it rotates
        # to the surviving sibling on connection failure).
        killed = {
            p: PeerProcessKiller(procs.pop((p, 1))) for p in range(P)
        }
        storm_n = 300
        for i in range(storm_n):
            pc.set(f"storm:{i:04d}", f"w{i}")
            if i == 60:
                for p in range(P):
                    killed[p].kill_now()
        for p in range(P):
            assert killed[p].killed
        # Survivors never left live while their sibling was dead.
        for p in range(P):
            m = metrics_of(p, 0)
            assert m.get("partition.state") == "0", (
                f"survivor of partition {p} degraded: {m.get('partition.state')}"
            )
            assert m.get("partition.id") == str(p)
        # Every storm key is readable through the surviving replicas.
        assert all(
            pc.get(f"storm:{i:04d}") == f"w{i}" for i in range(storm_n)
        )

        # Respawn the killed replicas (fresh empty engines — a crashed
        # host came back wiped) and repair each partition from its
        # surviving sibling with one SYNC; roots must land bit-identical.
        for p in range(P):
            spawn_node(p, 1)
        for p in range(P):
            h0, _, p0 = addr[p][0].rpartition(":")
            h1, _, p1 = addr[p][1].rpartition(":")
            with MerkleKVClient(h1, int(p1), timeout=30) as c:
                assert c.sync_with(h0, int(p0))
        roots = {}
        for p in range(P):
            assert root_of(p, 0) == root_of(p, 1), (
                f"partition {p} did not reconverge after respawn"
            )
            roots[p] = root_of(p, 0)
        assert len(set(roots.values())) == P  # disjoint keyspaces
        pc.close()
    finally:
        for proc in list(procs.values()) + [broker]:
            proc.terminate()
        for proc in list(procs.values()) + [broker]:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()


# ------------------------------------------------ parity with the JAX package


def _seeded_keys(n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 40, size=n)
    raw = rng.integers(33, 127, size=int(lens.sum()), dtype=np.uint8).tobytes()
    out, off = [], 0
    for ln in lens:
        out.append(raw[off:off + ln])
        off += ln
    return out


def _guard_answers(port: int, keys: list[bytes]) -> list[str]:
    """One pipelined ``GET`` per key against a guarded native server: the
    reply lines, in order (``NOT_FOUND`` for an owned key, ``ERROR MOVED
    <pid> <epoch>`` for a foreign one)."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"".join(b"GET " + k + b"\r\n" for k in keys))
        f = s.makefile("rb")
        return [f.readline().rstrip(b"\r\n").decode() for _ in keys]


@pytest.mark.parametrize("count", [1, 2, 3, 4, 7, 16])
def test_partition_of_equals_jax_and_the_native_guard(count):
    keys = _seeded_keys(10_000, seed=count)
    ours = [partition_of(k, count) for k in keys]
    assert ours == [jpartmap.partition_of(k, count) for k in keys]
    assert [tpartmap.hash_of_key(k) for k in keys[:500]] == [
        jpartmap.hash_of_key(k) for k in keys[:500]
    ]
    eng = NativeEngine("mem")
    srv = NativeServer(eng, "127.0.0.1", 0)
    own = count - 1
    srv.set_partition(9, count, own)
    srv.start()
    try:
        answers = _guard_answers(srv.port, keys)
    finally:
        srv.close()
        eng.close()
    want = ["NOT_FOUND" if p == own else f"ERROR MOVED {p} 9" for p in ours]
    assert answers == want


def _maps(pkg):
    v1 = pkg.parse_map_spec("0=h:1,h:2;1=h:3;2=h:4,h:5", 3, epoch=7)
    v2 = v1.split(1, ["h:6", "h:7"]).split(0, ["h:8"])
    return v1, v2


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_map_specs_and_partmap_texts_are_byte_identical(version):
    theirs = _maps(jpartmap)[version == "v2"]
    ours = _maps(tpartmap)[version == "v2"]
    assert ours.is_split == (version == "v2")
    assert tpartmap.format_map_spec(ours) == jpartmap.format_map_spec(theirs)
    assert ours.wire() == theirs.wire()
    spec = tpartmap.format_map_spec(ours)
    again = tpartmap.parse_map_spec(spec, ours.count, ours.epoch)
    assert again.wire() == ours.wire()
    assert jpartmap.parse_map_spec(spec, ours.count, ours.epoch).wire() == ours.wire()
    for pid in range(ours.count):
        assert ours.assignment(pid) == theirs.assignment(pid)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_map_file_of_either_package_loads_under_the_other(tmp_path, writer):
    w, r = (jpartmap, tpartmap) if writer == "jax" else (tpartmap, jpartmap)
    for version, pmap in zip(("v1", "v2"), _maps(w)):
        d = tmp_path / version
        d.mkdir()
        w.save_map_file(str(d), pmap, 2)
        loaded, pid = r.load_map_file(str(d))
        assert pid == 2 and loaded.wire() == pmap.wire()
        assert loaded.epoch == pmap.epoch
        other = tmp_path / f"{version}-other"
        other.mkdir()
        r.save_map_file(str(other), loaded, 2)
        assert (other / "partmap.spec").read_bytes() == (d / "partmap.spec").read_bytes()
    assert r.load_map_file(str(tmp_path)) is None


def _golden_root(items) -> str:
    return build_levels([leaf_hash(k, v) for k, v in sorted(items)])[-1][0].hex()


def test_partition_nodes_serve_their_partition_root_from_the_device_mirror():
    """Two partitions, one replica each, with the mirror on the node's
    device: every node's ``HASH`` (``pt=``-addressed) comes from its mirror
    (``device.backend_level:1``) and equals the golden root over exactly
    its partition's keys."""
    cluster = PartCluster(2, 1)
    try:
        for key in list(cluster.nodes):
            cluster.nodes[key].stop()
            cluster.servers[key].close()
            del cluster.nodes[key], cluster.servers[key]
        orig = cluster._cfg

        def on_device(pid, r):
            cfg = orig(pid, r)
            cfg.anti_entropy.engine = "tpu"
            return cfg

        cluster._cfg = on_device
        for p in range(2):
            cluster.start_node(p, 0)
        kv = {f"dev:{i:04d}": f"v{i}" for i in range(120)}
        with PartitionedClient([cluster.addr[0][0]], timeout=30) as pc:
            pc.mset(kv)
        for p in range(2):
            host, _, port = cluster.addr[p][0].rpartition(":")
            want = _golden_root(
                (k.encode(), v.encode()) for k, v in kv.items() if partition_of(k, 2) == p
            )
            with MerkleKVClient(host, int(port), timeout=60) as c:
                c.partition_id = p

                def served():
                    c.hash()
                    return c.metrics().get("device.backend_level") == "1"

                assert wait_for(served, timeout=60)
                assert c.hash(force=True) == want
                assert c.metrics().get("device.fallbacks", "0") == "0"
    finally:
        cluster.close()
