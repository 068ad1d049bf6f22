"""The request plane in the torch port, on the CPU.

The cases of ``tests/test_requestplane.py`` against the port's
``requestplane/`` (``LeaseCache``, ``InvalidationFeed`` over the port's
``change_event.decode_events_meta``, ``RequestPlaneRouter``) in front of
partitioned torch nodes. Then parity across the packages: a seeded request
stream sent through a JAX router over torch nodes, a torch router over JAX
nodes and a torch router over torch nodes gets the byte-identical response
stream a JAX router over JAX nodes gives, and ``python -m
merklekv_tpu_torch router`` (and its ``--legacy-threads`` thin router)
serves the stream the same way.

Every node here runs with ``MERKLEKV_TORCH_DEVICE=cpu``. Tolerance: exact
equality of bytes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import random
import socket
import threading
import time
import urllib.request
import uuid

import pytest

from merklekv_tpu_torch.client import (
    MerkleKVClient,
    PartitionedClient,
    ReadOnlyError,
    ServerBusyError,
)
from merklekv_tpu_torch.cluster.change_event import (
    ChangeEvent,
    OpKind,
    encode_batch_cbor,
)
from merklekv_tpu_torch.cluster.node import ClusterNode
from merklekv_tpu_torch.cluster.transport import TcpBroker
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.native_bindings import NativeEngine, NativeServer
from merklekv_tpu_torch.requestplane import (
    LEAD,
    WAIT,
    InvalidationFeed,
    LeaseCache,
    RequestPlaneRouter,
)
from merklekv_tpu_torch.testing.faults import FaultInjector
from merklekv_tpu_torch.utils.tracing import get_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_env(monkeypatch):
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")


def _free_ports(n: int) -> list[int]:
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


class MiniCluster:
    """P partitions x R replicas of in-process ClusterNodes, optionally
    replicating per partition over one shared TcpBroker."""

    def __init__(
        self, partitions: int, replicas: int = 1, replicated: bool = False
    ) -> None:
        self.partitions = partitions
        self.replicas = replicas
        self.broker = TcpBroker() if replicated else None
        self.topic = f"rplane-{uuid.uuid4().hex[:8]}"
        ports = _free_ports(partitions * replicas)
        self.addr = [
            [f"127.0.0.1:{ports[p * replicas + r]}" for r in range(replicas)]
            for p in range(partitions)
        ]
        self.spec = ";".join(
            f"{p}=" + ",".join(self.addr[p]) for p in range(partitions)
        )
        self.engines: dict[tuple[int, int], NativeEngine] = {}
        self.servers: dict[tuple[int, int], NativeServer] = {}
        self.nodes: dict[tuple[int, int], ClusterNode] = {}
        for p in range(partitions):
            for r in range(replicas):
                self.start_node(p, r)

    def _cfg(self, pid: int, r: int) -> Config:
        cfg = Config()
        cfg.host = "127.0.0.1"
        cfg.port = int(self.addr[pid][r].rsplit(":", 1)[1])
        cfg.cluster.partitions = self.partitions
        cfg.cluster.partition_id = pid
        cfg.cluster.partition_map = self.spec
        if self.broker is not None:
            cfg.replication.enabled = True
            cfg.replication.mqtt_broker = self.broker.host
            cfg.replication.mqtt_port = self.broker.port
            cfg.replication.topic_prefix = self.topic
        cfg.anti_entropy.enabled = False
        return cfg

    def start_node(self, pid: int, r: int) -> None:
        key = (pid, r)
        eng = self.engines.get(key)
        if eng is None:
            eng = NativeEngine("mem")
            self.engines[key] = eng
        port = int(self.addr[pid][r].rsplit(":", 1)[1])
        srv = NativeServer(eng, "127.0.0.1", port)
        srv.start()
        node = ClusterNode(self._cfg(pid, r), eng, srv)
        node.start()
        self.servers[key] = srv
        self.nodes[key] = node

    def kill(self, pid: int, r: int) -> None:
        key = (pid, r)
        node = self.nodes.pop(key, None)
        if node is not None:
            node.stop()
        srv = self.servers.pop(key, None)
        if srv is not None:
            srv.close()

    @property
    def flat_addrs(self) -> list[str]:
        return [a for group in self.addr for a in group]

    def close(self) -> None:
        for key in list(self.nodes):
            self.kill(*key)
        for eng in self.engines.values():
            try:
                eng.close()
            except Exception:
                pass
        self.engines.clear()
        if self.broker is not None:
            self.broker.close()


@pytest.fixture
def cluster2():
    c = MiniCluster(2, 1)
    yield c
    c.close()


def _start_router(cluster: MiniCluster, **kw) -> RequestPlaneRouter:
    seeds = kw.pop("seeds", cluster.flat_addrs)
    return RequestPlaneRouter("127.0.0.1", 0, seeds, **kw).start()


def _counter(name: str) -> int:
    return int(get_metrics().snapshot()["counters"].get(name, 0))


def _direct(addr: str, **kw) -> MerkleKVClient:
    host, port = addr.rsplit(":", 1)
    return MerkleKVClient(host, int(port), **kw)


# -- LeaseCache units --------------------------------------------------------
def test_lease_cache_fill_hit_invalidate():
    cache = LeaseCache(10_000, max_age_ms=60_000)
    calls = []
    res = cache.begin_get("k", 0, calls.append)
    assert res is LEAD
    assert cache.finish_fill("k", "v1", 0) == []
    value, age_ms = cache.begin_get("k", 0, calls.append)
    assert value == "v1" and age_ms >= 0.0
    assert cache.keys == 1 and cache.bytes_used > 0
    assert cache.invalidate("k") is True
    assert cache.invalidate("k") is False  # already gone
    assert cache.begin_get("k", 0, calls.append) is LEAD
    assert calls == []  # hits and leads never enqueue the waiter


def test_lease_cache_single_fill_under_herd():
    cache = LeaseCache(10_000)
    got: list[tuple] = []

    def waiter(value, age_ms, error):
        got.append((value, error))

    assert cache.begin_get("hot", 3, waiter) is LEAD
    for _ in range(5):
        assert cache.begin_get("hot", 3, waiter) is WAIT
    assert cache.leases_inflight == 1
    waiters = cache.finish_fill("hot", "V", 3)
    assert len(waiters) == 5
    for w in waiters:
        w("V", 0.0, None)
    assert got == [("V", None)] * 5
    # A failed fill releases the lease and caches nothing.
    assert cache.begin_get("bad", 0, waiter) is LEAD
    assert cache.begin_get("bad", 0, waiter) is WAIT
    waiters = cache.finish_fill("bad", None, 0, error="ERROR boom\r\n")
    assert len(waiters) == 1
    assert cache.begin_get("bad", 0, waiter) is LEAD  # lease released


def test_lease_cache_steal_after_timeout():
    cache = LeaseCache(10_000, lease_timeout_ms=30.0)
    herd: list = []
    assert cache.begin_get("k", 0, herd.append) is LEAD
    assert cache.begin_get("k", 0, herd.append) is WAIT
    time.sleep(0.06)
    # The stuck leader's lease is stolen; the queued waiter survives.
    assert cache.begin_get("k", 0, herd.append) is LEAD
    waiters = cache.finish_fill("k", "v", 0)
    assert len(waiters) == 1


def test_lease_cache_budget_eviction_and_partition_flush():
    cache = LeaseCache(1200, max_age_ms=60_000)
    for i in range(20):
        assert cache.begin_get(f"k{i:02d}", i % 2, lambda *a: None) is LEAD
        cache.finish_fill(f"k{i:02d}", "x" * 20, i % 2)
    assert cache.bytes_used <= 1200
    assert cache.keys < 20  # LRU evicted the overflow
    # The newest entry survived; flushing its partition drops it.
    assert cache.begin_get("k19", 1, lambda *a: None) not in (LEAD, WAIT)
    flushed = cache.flush_partition(1)
    assert flushed >= 1
    assert cache.begin_get("k19", 1, lambda *a: None) is LEAD


def test_lease_cache_max_age_expiry():
    cache = LeaseCache(10_000, max_age_ms=30.0)
    assert cache.begin_get("k", 0, lambda *a: None) is LEAD
    cache.finish_fill("k", "v", 0)
    hit = cache.begin_get("k", 0, lambda *a: None)
    assert hit not in (LEAD, WAIT)
    time.sleep(0.05)
    assert cache.begin_get("k", 0, lambda *a: None) is LEAD  # expired


# -- InvalidationFeed units --------------------------------------------------
class _FakeTransport:
    def __init__(self):
        self.subs: list[tuple[str, object]] = []

    def subscribe(self, prefix, cb):
        self.subs.append((prefix, cb))

    def unsubscribe(self, cb):
        self.subs = [(p, c) for p, c in self.subs if c is not cb]


def _frame(keys: list[str], src: str, hseq: int,
           op: OpKind = OpKind.SET) -> bytes:
    events = [
        ChangeEvent(op=op, key=k, val=b"v", ts=time.time_ns(), src=src)
        for k in keys
    ]
    return encode_batch_cbor(events, src, hwm_seq=hseq,
                             hwm_ts=time.time_ns())


def test_invalidation_feed_events_gap_and_truncate():
    cache = LeaseCache(100_000, max_age_ms=60_000)
    tr = _FakeTransport()
    feed = InvalidationFeed(cache, tr, "pref")
    assert tr.subs and tr.subs[0][0] == "pref/"
    cb = tr.subs[0][1]

    def fill(key, pid):
        assert cache.begin_get(key, pid, lambda *a: None) is LEAD
        cache.finish_fill(key, "v", pid)

    for k in ("a0", "b0", "c0"):
        fill(k, 0)
    fill("z1", 1)
    # Contiguous frame: only the named key drops.
    cb("pref/p0/events", _frame(["a0"], "n1", hseq=1))
    assert cache.begin_get("a0", 0, lambda *a: None) is LEAD
    hit = cache.begin_get("b0", 0, lambda *a: None)
    assert hit not in (LEAD, WAIT)
    # hseq jump beyond this frame's batch: missed invalidations — the
    # whole partition flushes, other partitions untouched.
    gap0 = _counter("router.inval_gap_flushes")
    cb("pref/p0/events", _frame(["c0"], "n1", hseq=9))
    assert _counter("router.inval_gap_flushes") == gap0 + 1
    assert cache.begin_get("b0", 0, lambda *a: None) is LEAD
    assert cache.begin_get("z1", 1, lambda *a: None) not in (LEAD, WAIT)
    # TRUNCATE is keyspace-wide: partition flush.
    fill("d1", 1)
    cb("pref/p1/events", _frame(["ignored"], "n2", hseq=1,
                                op=OpKind.TRUNCATE))
    assert cache.begin_get("d1", 1, lambda *a: None) is LEAD
    # Garbage payloads count, never raise.
    bad0 = _counter("router.inval_decode_errors")
    cb("pref/p0/events", b"\xff\x00not-cbor")
    assert _counter("router.inval_decode_errors") == bad0 + 1
    # Non-event topics are ignored.
    cb("pref/p0/forward", _frame(["b0"], "n1", hseq=10))
    feed.close()
    assert tr.subs == []


# -- io plane: pipelining, merges, fuzz --------------------------------------
def _sock_lines(sock: socket.socket, n: int, timeout: float = 15.0) -> bytes:
    """Read exactly n response lines (VALUES/KEYS blocks count their rows
    as part of the SAME logical response via the caller's n)."""
    sock.settimeout(timeout)
    buf = bytearray()
    while buf.count(b"\n") < n:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("router closed mid-read")
        buf += chunk
    return bytes(buf)


def test_router_merges_byte_identical_to_smart_client(cluster2):
    router = _start_router(cluster2)
    try:
        data = {f"mk{i:02d}": f"val{i}" for i in range(12)}
        ask = list(data) + ["ghost"]
        with PartitionedClient(cluster2.flat_addrs) as smart:
            for k, v in data.items():
                smart.set(k, v)
            smart_mget = smart.mget(ask)
        with MerkleKVClient("127.0.0.1", router.port) as via:
            assert via.mget(ask) == smart_mget
            # DBSIZE fans out and sums the per-partition counts.
            assert via.dbsize() == len(data)
            assert via.exists(*data, "ghost") == len(data)
            assert sorted(via.scan("mk")) == sorted(data)
            via.mset({"mm1": "a", "mm2": "b"})
            assert via.get("mm1") == "a" and via.get("mm2") == "b"
        # Raw wire shape: request-order rows, exact found count.
        keys = list(data)[:3] + ["ghost"] + list(data)[3:5]
        expected = f"VALUES {5}\r\n" + "".join(
            f"{k} {data.get(k, 'NOT_FOUND')}\r\n" for k in keys
        )
        with socket.create_connection(("127.0.0.1", router.port)) as s:
            s.sendall(("MGET " + " ".join(keys) + "\r\n").encode())
            got = _sock_lines(s, 1 + len(keys))
        assert got == expected.encode()
        # All-miss MGET collapses to the protocol's bare NOT_FOUND.
        with socket.create_connection(("127.0.0.1", router.port)) as s:
            s.sendall(b"MGET ghost1 ghost2\r\n")
            assert _sock_lines(s, 1) == b"NOT_FOUND\r\n"
    finally:
        router.stop()


def test_router_pipelined_fuzz_byte_boundaries(cluster2):
    """The ordering contract under hostile framing: a seeded stream of
    singles and fan-outs, sent with requests split at arbitrary byte
    boundaries (including mid-line), must produce the byte-exact response
    stream in strict request order."""
    router = _start_router(cluster2)
    try:
        rng = random.Random(7)
        vals = {f"fz{i:03d}": f"w{i * 17 % 101:03d}" for i in range(40)}
        with MerkleKVClient("127.0.0.1", router.port) as c:
            for k, v in vals.items():
                c.set(k, v)
        reqs: list[bytes] = []
        expected = bytearray()
        for _ in range(300):
            kind = rng.random()
            ks = rng.sample(list(vals), rng.randint(1, 5))
            if kind < 0.35:  # GET
                reqs.append(f"GET {ks[0]}\r\n".encode())
                expected += f"VALUE {vals[ks[0]]}\r\n".encode()
            elif kind < 0.55:  # SET to the key's fixed value (idempotent)
                reqs.append(f"SET {ks[0]} {vals[ks[0]]}\r\n".encode())
                expected += b"OK\r\n"
            elif kind < 0.75:  # MGET fan-out between singles
                reqs.append(("MGET " + " ".join(ks) + "\r\n").encode())
                expected += f"VALUES {len(ks)}\r\n".encode()
                expected += "".join(
                    f"{k} {vals[k]}\r\n" for k in ks
                ).encode()
            elif kind < 0.9:  # EXISTS fan-out
                reqs.append(("EXISTS " + " ".join(ks) + "\r\n").encode())
                expected += f"EXISTS {len(ks)}\r\n".encode()
            else:  # local PING rides the same ordered queue
                reqs.append(f"PING t{len(reqs)}\r\n".encode())
                expected += f"PONG t{len(reqs) - 1}\r\n".encode()
        blob = b"".join(reqs)
        with socket.create_connection(("127.0.0.1", router.port)) as s:
            def feeder():
                i = 0
                while i < len(blob):
                    step = rng.choice((1, 2, 3, 7, 50, 400))
                    s.sendall(blob[i:i + step])
                    i += step
                    if rng.random() < 0.05:
                        time.sleep(0.002)

            t = threading.Thread(target=feeder, daemon=True)
            t.start()
            got = _sock_lines(s, expected.count(b"\n"), timeout=60.0)
            t.join()
        assert got == bytes(expected)
    finally:
        router.stop()


def test_router_refuses_oversized_line(cluster2):
    router = _start_router(cluster2)
    try:
        with socket.create_connection(("127.0.0.1", router.port)) as s:
            s.sendall(b"GET " + b"x" * (2 << 20) + b"\r\n")
            got = _sock_lines(s, 1)
            assert got.startswith(b"ERROR line too long")
            # The connection closes after the refusal flushes (EOF, or
            # RST when the kernel still holds unread oversized input).
            s.settimeout(5.0)
            try:
                assert s.recv(1024) == b""
            except ConnectionResetError:
                pass
    finally:
        router.stop()


def test_router_unsupported_verb_and_validation(cluster2):
    router = _start_router(cluster2)
    try:
        with socket.create_connection(("127.0.0.1", router.port)) as s:
            s.sendall(b"FLUSHALL\r\nSET lonely\r\nINC k notanumber\r\n")
            got = _sock_lines(s, 3).decode().splitlines()
        assert "unsupported verb" in got[0]
        assert got[1] == "ERROR SET command requires a key and value"
        assert got[2] == "ERROR INC command amount must be a valid number"
    finally:
        router.stop()


def test_router_upstream_kill_typed_retryable_error(cluster2):
    """Killing a partition's only backend surfaces the TYPED retryable
    BUSY error for that partition — while the OTHER partition keeps
    answering on the SAME client connection (no desync, no close)."""
    router = _start_router(cluster2, timeout=2.0)
    try:
        pmap = router.map
        k0 = next(
            f"p0k{i}" for i in range(100)
            if pmap.partition_for_key(f"p0k{i}") == 0
        )
        k1 = next(
            f"p1k{i}" for i in range(100)
            if pmap.partition_for_key(f"p1k{i}") == 1
        )
        with MerkleKVClient("127.0.0.1", router.port, timeout=30.0) as c:
            c.set(k0, "a")
            c.set(k1, "b")
            resets0 = _counter("router.upstream_resets")
            cluster2.kill(1, 0)
            with pytest.raises(ServerBusyError):
                c.get(k1)
            # Same connection, surviving partition: still perfect.
            assert c.get(k0) == "a"
            with pytest.raises(ServerBusyError):
                c.set(k1, "c")
            assert c.get(k0) == "a"
        assert _counter("router.upstream_resets") > resets0
    finally:
        router.stop()


# -- lease cache through the router ------------------------------------------
def test_router_cache_serves_hits_and_invalidates_on_events():
    cluster = MiniCluster(2, 1, replicated=True)
    router = None
    try:
        router = _start_router(
            cluster, cache_bytes=50_000, cache_max_age_ms=30_000.0,
            broker=cluster.broker.host, broker_port=cluster.broker.port,
            topic_prefix=cluster.topic,
        )
        with MerkleKVClient("127.0.0.1", router.port, timeout=30.0) as c:
            c.set("hotkey", "v1")
            hits0 = _counter("router.cache_hits")
            # The SET's own replicated event reaches the invalidation feed
            # on its own schedule and may drop the first fill; a later
            # fill then stays, so fill and read again until a read hits.
            for _ in range(50):
                assert c.get("hotkey") == "v1"  # fill
                assert c.get("hotkey") == "v1"  # hit
                if _counter("router.cache_hits") > hits0:
                    break
                time.sleep(0.05)
            assert _counter("router.cache_hits") > hits0
            # A write THROUGH the router invalidates synchronously
            # (read-your-writes on this path).
            c.set("hotkey", "v2")
            assert c.get("hotkey") == "v2"
            # A write BEHIND the router (direct to the owning node) must
            # flow back as a replication event and drop the cached entry.
            assert c.get("hotkey") == "v2"  # ensure cached
            pid = router.map.partition_for_key("hotkey")
            with _direct(cluster.addr[pid][0]) as direct:
                direct.set("hotkey", "v3")
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if c.get("hotkey") == "v3":
                    break
                time.sleep(0.05)
            assert c.get("hotkey") == "v3"
            # Stamped read: age:bound stamp parses; force-fresh bypasses.
            value, stamp = c.get_stamped("hotkey")
            assert value == "v3" and stamp is not None
            age_ms, bound_ms = stamp
            assert 0 <= age_ms <= bound_ms == 30_000
            value, _ = c.get_stamped("hotkey", force=True)
            assert value == "v3"
    finally:
        if router is not None:
            router.stop()
        cluster.close()


def test_router_staleness_never_exceeds_stamp_bound_under_dropped_frames():
    """The acceptance drill: kill the router's invalidation link, write
    behind its back, and prove every cached answer stays within its
    ``vs=`` stamp's bound — then heal the link and prove the hseq gap
    flushes the partition."""
    cluster = MiniCluster(2, 1, replicated=True)
    router = None
    inj = FaultInjector(cluster.broker.host, cluster.broker.port, seed=3)
    bound_ms = 700.0
    try:
        router = _start_router(
            cluster, cache_bytes=50_000, cache_max_age_ms=bound_ms,
            broker=inj.host, broker_port=inj.port,
            topic_prefix=cluster.topic,
        )
        with MerkleKVClient("127.0.0.1", router.port, timeout=30.0) as c:
            frames0 = _counter("router.inval_frames")
            c.set("sk", "old")
            # The write's own replication echo must land BEFORE the fill:
            # were it still in flight it would invalidate the freshly
            # cached entry and close the stale window early.
            deadline = time.monotonic() + 5.0
            while (time.monotonic() < deadline
                   and _counter("router.inval_frames") == frames0):
                time.sleep(0.02)
            assert c.get("sk") == "old"  # cached, and stable now
            # Sever the invalidation feed, then write behind the router.
            inj.kill_peer()
            pid = router.map.partition_for_key("sk")
            with _direct(cluster.addr[pid][0]) as direct:
                direct.set("sk", "new")
            wrote_at = time.monotonic()
            # While the stale window is open the stamp must bound it.
            saw_stale = False
            while True:
                value, stamp = c.get_stamped("sk")
                now = time.monotonic()
                if value == "new":
                    break
                saw_stale = True
                assert stamp is not None, "stale answer must carry a stamp"
                age_ms, b = stamp
                assert b == int(bound_ms)
                assert age_ms <= b, (
                    f"cached answer older than its bound: {age_ms} > {b}"
                )
                assert now - wrote_at < (bound_ms / 1000.0) + 5.0, (
                    "staleness window failed to close after max-age"
                )
                time.sleep(0.03)
            # The undetectable-loss window is bounded by max_age (plus
            # one poll): the documented contract.
            assert now - wrote_at <= (bound_ms / 1000.0) + 1.0
            assert saw_stale, "drill never observed the stale window"
            # Heal the link; the next event frame exposes the missed
            # hseq range and flushes the partition immediately.
            inj.revive()
            assert c.get("sk") == "new"  # re-cache
            with _direct(cluster.addr[pid][0]) as direct:
                direct.set("sk", "newer")
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if c.get("sk") == "newer":
                    break
                time.sleep(0.05)
            assert c.get("sk") == "newer"
    finally:
        if router is not None:
            router.stop()
        inj.close()
        cluster.close()


# -- observability -----------------------------------------------------------
def test_router_healthz_and_prometheus_exporter(cluster2):
    router = _start_router(cluster2, metrics_port=0)
    try:
        with MerkleKVClient("127.0.0.1", router.port) as c:
            c.set("obs", "1")
            assert c.get("obs") == "1"
            info = c.info()
            assert info.get("role") == "router"
            metrics = c.metrics()
            assert "router.commands" in metrics
            assert "router.conns" in metrics
        base = f"http://127.0.0.1:{router.metrics_port}"
        health = json.loads(
            urllib.request.urlopen(base + "/healthz", timeout=5).read()
        )
        assert health.get("role") == "router"
        assert int(health.get("workers", 0)) >= 1
        page = urllib.request.urlopen(
            base + "/metrics", timeout=5
        ).read().decode()
        assert "router" in page
    finally:
        router.stop()


# -- chaos drill (CI integration sweep) --------------------------------------
@pytest.mark.integration
def test_router_through_kill_one_replica_chaos():
    """Kill one replica of a replicated partition mid-storm, THROUGH the
    pooled router: the storm rides the typed-BUSY healing onto the
    sibling replica, per-connection ordering never desyncs, and the
    upstream reset shows on the flight metrics
    (docs/FAULT_MODEL.md "Request-plane failures")."""
    cluster = MiniCluster(2, 2, replicated=True)
    router = None
    try:
        router = _start_router(cluster, timeout=2.0)
        stop = threading.Event()
        errors: list[BaseException] = []
        model_locks = [threading.Lock() for _ in range(4)]
        models: list[dict[str, str]] = [{} for _ in range(4)]

        def storm(t: int) -> None:
            rng = random.Random(100 + t)
            try:
                with MerkleKVClient(
                    "127.0.0.1", router.port, timeout=30.0
                ) as c:
                    i = 0
                    while not stop.is_set():
                        key = f"chaos{t}_{rng.randint(0, 49):02d}"
                        try:
                            if i % 3 == 0:
                                val = f"v{t}_{i}"
                                c.set(key, val)
                                with model_locks[t]:
                                    models[t][key] = val
                            else:
                                got = c.get(key)
                                with model_locks[t]:
                                    want = models[t].get(key)
                                # A read must NEVER surface another
                                # key's value or garbage — only the
                                # model value or (transiently, around
                                # the failover) a miss.
                                if got is not None and want is not None:
                                    assert got.startswith(f"v{t}_"), got
                        except (ServerBusyError, ReadOnlyError):
                            time.sleep(0.02)  # typed retryable: back off
                        i += 1
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [
            threading.Thread(target=storm, args=(t,), daemon=True)
            for t in range(4)
        ]
        for th in threads:
            th.start()
        time.sleep(0.6)
        resets0 = _counter("router.upstream_resets")
        cluster.kill(1, 0)  # the replica the router dialed first
        time.sleep(2.0)  # storm rides through the failover
        stop.set()
        for th in threads:
            th.join(timeout=60)
        assert not errors, errors[0]
        assert _counter("router.upstream_resets") > resets0
        # After the dust settles every surviving write reads back
        # correctly through the healed router.
        with MerkleKVClient("127.0.0.1", router.port, timeout=30.0) as c:
            c.set("post_chaos", "alive")
            assert c.get("post_chaos") == "alive"
            for t in range(4):
                sample = sorted(models[t])[-3:]
                for key in sample:
                    got = c.get(key)
                    if got is not None:
                        assert got.startswith(f"v{t}_")
    finally:
        if router is not None:
            router.stop()
        cluster.close()


# -- parity across the packages ----------------------------------------------
def _modules(pkg: str):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return {
        "Config": mod("config").Config,
        "NativeEngine": mod("native_bindings").NativeEngine,
        "NativeServer": mod("native_bindings").NativeServer,
        "ClusterNode": mod("cluster.node").ClusterNode,
        "RequestPlaneRouter": mod("requestplane").RequestPlaneRouter,
        "PartitionRouter": mod("cluster.router").PartitionRouter,
    }


class PkgCluster:
    """Two partitions, one replica each, of one package's in-process
    nodes (no replication)."""

    def __init__(self, pkg: str) -> None:
        m = _modules(pkg)
        ports = _free_ports(2)
        self.addrs = [f"127.0.0.1:{p}" for p in ports]
        spec = ";".join(f"{i}={a}" for i, a in enumerate(self.addrs))
        self.parts = []
        for pid, port in enumerate(ports):
            cfg = m["Config"]()
            cfg.host = "127.0.0.1"
            cfg.port = port
            cfg.cluster.partitions = 2
            cfg.cluster.partition_id = pid
            cfg.cluster.partition_map = spec
            cfg.anti_entropy.enabled = False
            eng = m["NativeEngine"]("mem")
            srv = m["NativeServer"](eng, "127.0.0.1", port)
            srv.start()
            node = m["ClusterNode"](cfg, eng, srv)
            node.start()
            self.parts.append((eng, srv, node))

    def close(self) -> None:
        for eng, srv, node in self.parts:
            node.stop()
            srv.close()
            eng.close()


def _request_stream(seed: int = 11, n: int = 400) -> bytes:
    rng = random.Random(seed)
    keys = [f"rs{i:03d}" for i in range(30)]
    reqs = []
    for i in range(n):
        r = rng.random()
        ks = rng.sample(keys, rng.randint(1, 4))
        k = ks[0]
        if r < 0.25:
            reqs.append(f"SET {k} v{rng.randint(0, 999)}")
        elif r < 0.43:
            reqs.append(f"GET {k}")
        elif r < 0.53:
            reqs.append("MGET " + " ".join(ks))
        elif r < 0.60:
            reqs.append("MSET " + " ".join(f"{x} m{rng.randint(0, 99)}" for x in ks))
        elif r < 0.67:
            reqs.append("EXISTS " + " ".join(ks))
        elif r < 0.73:
            reqs.append(f"DEL {k}")
        elif r < 0.80:
            reqs.append(f"INC cnt{rng.randint(0, 3)} {rng.randint(1, 9)}")
        elif r < 0.85:
            reqs.append(f"APPEND {k} x{rng.randint(0, 9)}")
        elif r < 0.90:
            reqs.append("DBSIZE")
        elif r < 0.95:
            reqs.append(f"SCAN rs0{rng.randint(0, 2)}")
        else:
            reqs.append(f"PING t{i}")
    reqs.append("PING end")
    return "".join(f"{x}\r\n" for x in reqs).encode()


def _answers(port: int) -> bytes:
    """Send the stream in one burst and read until its sentinel's PONG."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(_request_stream())
        buf = bytearray()
        while not buf.endswith(b"PONG end\r\n"):
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("router closed mid-stream")
            buf += chunk
    return bytes(buf)


def _stream_through(router_pkg: str, node_pkg: str, thin: bool = False) -> bytes:
    cluster = PkgCluster(node_pkg)
    m = _modules(router_pkg)
    kind = m["PartitionRouter"] if thin else m["RequestPlaneRouter"]
    router = kind("127.0.0.1", 0, cluster.addrs).start()
    try:
        return _answers(router.port)
    finally:
        router.stop()
        cluster.close()


@pytest.fixture(scope="module")
def jax_answers():
    """The reference: the JAX router over JAX nodes, pooled and thin."""
    return {thin: _stream_through("merklekv_tpu", "merklekv_tpu", thin)
            for thin in (False, True)}


@pytest.mark.parametrize("router_pkg,node_pkg", [
    ("merklekv_tpu", "merklekv_tpu_torch"),
    ("merklekv_tpu_torch", "merklekv_tpu"),
    ("merklekv_tpu_torch", "merklekv_tpu_torch"),
])
def test_routers_over_either_package_answer_byte_for_byte(jax_answers, router_pkg, node_pkg):
    got = _stream_through(router_pkg, node_pkg)
    assert got.count(b"\n") > 400 and b"VALUES" in got and b"KEYS" in got
    assert got == jax_answers[False]


@pytest.mark.parametrize("thin", [False, True], ids=["pooled", "legacy_threads"])
def test_python_m_router_serves_the_stream_like_the_jax_router(jax_answers, thin):
    cluster = PkgCluster("merklekv_tpu_torch")
    args = [sys.executable, "-m", "merklekv_tpu_torch", "router", "--port", "0",
            "--seeds", ",".join(cluster.addrs)] + (["--legacy-threads"] if thin else [])
    proc = subprocess.Popen(args, env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("merklekv_tpu_torch router listening on 127.0.0.1:"), line
        assert "(2 partitions, epoch 1)" in line
        port = int(line.split()[4].rsplit(":", 1)[1])
        assert _answers(port) == jax_answers[thin]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
        cluster.close()
