"""The torch port's node (``python -m merklekv_tpu_torch``) on the CPU.

- A node started by ``__main__.start`` with replication on the in-process
  bus serves ``HASH`` and ``TREELEVEL`` from its mirror (``METRICS``:
  ``device.backend_level:1``), equal to the hashlib chain and the golden
  tree after writes, deletes and a ``TRUNCATE``.
- ``python -m merklekv_tpu_torch --port 0`` prints its readiness line and
  exits 0 on SIGTERM.
- Partitions, rebalancing and bootstrap: a partitioned or bootstrapping
  config starts, a partitioned TOML loads, ``router`` and ``rebalance`` run,
  the names the node imports from those modules are the real ones and agree
  with the JAX package's, and the node's paths into them run.
- ``python -m merklekv_tpu_torch top --once`` against a CPU node exits 0
  (BKND 1 from its mirror); ``blackbox`` on an unreadable input exits 1.
- A node whose engine is not ``"cpu"`` fails at start without a GPU unless
  ``MERKLEKV_TORCH_DEVICE=cpu``.
- ``PROFILE <secs>`` answers ``PROFILE <dir>`` and writes a torch trace.

Every node here runs with ``MERKLEKV_TORCH_DEVICE=cpu`` unless a test says
otherwise. Tolerance: exact equality.
"""

import hashlib
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from merklekv_tpu.cluster import partmap as jpartmap
from merklekv_tpu_torch.__main__ import main, start
from merklekv_tpu_torch.client import MerkleKVClient, MovedError
from merklekv_tpu_torch.cluster import partmap
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.merkle.cpu import ref_level_sizes
from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState

ROOT = Path(__file__).resolve().parents[1]


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
    return level[0].hex() if level else "0" * 64


def _wait(fn, timeout=30.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.02)
    return False


def _cfg(replication: bool = True, **anti_entropy) -> Config:
    cfg = Config()
    cfg.port = 0
    cfg.replication.enabled = replication
    cfg.replication.mqtt_broker = "local"
    for k, v in anti_entropy.items():
        setattr(cfg.anti_entropy, k, v)
    return cfg


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")


@pytest.fixture
def node(cpu_env):
    run = start(_cfg())
    c = MerkleKVClient("127.0.0.1", run.port, timeout=60).connect()
    yield run, c
    c.close()
    run.close()


def _mirror_serves(c) -> bool:
    c.hash()
    m = c.metrics()
    return m.get("device.backend_level") == "1" and "device.tree_version" in m


def _check(c, items) -> None:
    """HASH (forced, then stamped) and TREELEVEL slices against the hashlib
    chain and the golden tree; the stamp's version is the mirror's."""
    assert c.hash(force=True) == _hashlib_root(items)
    m = c.metrics()
    assert m.get("device.backend_level") == "1"
    resp = c._request("HASH vs=01").split()
    assert resp[1] == _hashlib_root(items) and resp[2] == m["device.tree_version"]
    golden = CpuMerkleState.from_items(items)
    n = golden.leaf_count()
    for level, size in enumerate(ref_level_sizes(n) if n else []):
        for lo, hi in ((0, 3), (size // 2, size // 2 + 3), (max(0, size - 2), size)):
            rows, cnt = c.tree_level(level, lo, hi)
            want, wn = golden.level_nodes(level, lo, hi)
            assert cnt == wn and [(i, bytes.fromhex(h)) for i, h in rows] == want, (level, lo, hi)


def test_node_serves_hash_and_treelevel_from_its_mirror(node):
    run, c = node
    # The registry behind METRICS is the process's: count from here.
    base = c.metrics()
    items = {b"k%04d" % i: b"v%d" % i for i in range(301)}
    c.mset({k.decode(): v.decode() for k, v in items.items()})
    assert _wait(lambda: _mirror_serves(c))
    _check(c, items.items())

    for i in range(0, 301, 7):
        c.set(f"k{i:04d}", f"new{i}")
        items[b"k%04d" % i] = b"new%d" % i
    for i in range(3, 301, 11):
        c.delete(f"k{i:04d}")
        del items[b"k%04d" % i]
    c.set("k9999", "tail")
    items[b"k9999"] = b"tail"
    _check(c, items.items())

    assert c.truncate()
    assert c.hash(force=True) == "0" * 64
    refill = {b"r%03d" % i: b"x%d" % i for i in range(5)}
    c.mset({k.decode(): v.decode() for k, v in refill.items()})
    # The background pump drains a write nobody forces. (device.pump_batches
    # counts only its drains, and every forced HASH above publishes the
    # backlog itself, so under load the forced reads could leave it nothing.)
    c.set("r999", "unforced")
    refill[b"r999"] = b"unforced"
    pumped = int(base.get("device.pump_batches", 0))
    assert _wait(lambda: int(c.metrics().get("device.pump_batches", 0)) > pumped), \
        "the pump never drained an unforced write"
    _check(c, refill.items())
    m = c.metrics()
    for k in ("device.fallbacks", "device.pump_errors", "device.warm_errors"):
        assert int(m.get(k, 0)) == int(base.get(k, 0)), k


def test_python_m_prints_readiness_and_exits_0_on_sigterm(tmp_path):
    env = dict(os.environ, MERKLEKV_TORCH_DEVICE="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "merklekv_tpu_torch", "--port", "0"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("merklekv_tpu_torch listening on 127.0.0.1:"), line
        assert line.rstrip().endswith("(engine=mem)")
        port = int(line.split()[3].rsplit(":", 1)[1])
        c = MerkleKVClient("127.0.0.1", port).connect()
        c.set("a", "1")
        assert c.hash() == _hashlib_root([(b"a", b"1")])
        c.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert not list(tmp_path.iterdir())  # nothing written beside the caller


# ------------------------------------------- partitions, rebalance, bootstrap

def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _partitions(cfg):
    ports = _free_ports(2)
    cfg.host = "127.0.0.1"
    cfg.port = ports[0]
    cfg.cluster.partitions = 2
    cfg.cluster.partition_id = 0
    cfg.cluster.partition_map = f"0=127.0.0.1:{ports[0]};1=127.0.0.1:{ports[1]}"


def _bootstrap(cfg):
    cfg.bootstrap.enabled = True
    cfg.anti_entropy.peers = ["127.0.0.1:1"]  # a donor that never answers


@pytest.mark.parametrize("setup", [_partitions, _bootstrap], ids=["partitions", "bootstrap"])
def test_partitioned_or_bootstrapping_config_starts(cpu_env, setup):
    """A config asking for partitions or bootstrap (refused before those
    modules were ported) starts and serves: a partitioned node answers
    PARTMAP and MOVED for the other partition's keys; a bootstrapping node
    whose donor never answers ends its session, opens its read gate and
    serves writes."""
    cfg = _cfg()
    setup(cfg)
    run = start(cfg)
    try:
        with MerkleKVClient("127.0.0.1", run.port, timeout=60) as c:
            if cfg.cluster.partitions:
                pmap = c.partition_map()
                assert (pmap.epoch, pmap.count) == (1, 2)
                own = next(f"k{i}" for i in range(99) if partmap.partition_of(f"k{i}", 2) == 0)
                other = next(f"k{i}" for i in range(99) if partmap.partition_of(f"k{i}", 2) == 1)
                assert c.set(own, "v")
                with pytest.raises(MovedError):
                    c.set(other, "v")
            else:
                assert run.node._bootstrap is not None
                assert _wait(lambda: run.node._bootstrap.state in ("live", "failed"))
                assert run.server.serving
                assert c.set("b", "1") and c.get("b") == "1"
    finally:
        run.close()


@pytest.mark.parametrize("field,value", [("sharding", "auto"), ("sharding", "2"),
                                         ("sharded_mirror", True)])
def test_sharding_on_one_device_serves_from_one_device(cpu_env, field, value):
    """``[device] sharding = auto|N`` (refused before the sharded tree was
    ported) starts; on a one-device host it resolves to the single-device
    tree, and ``device.shards`` reads 1."""
    cfg = _cfg()
    setattr(cfg.device, field, value)
    run = start(cfg)
    try:
        c = MerkleKVClient("127.0.0.1", run.port, timeout=60).connect()
        items = {b"s%03d" % i: b"v%d" % i for i in range(40)}
        c.mset({k.decode(): v.decode() for k, v in items.items()})
        assert _wait(lambda: _mirror_serves(c))
        _check(c, items.items())
        m = c.metrics()
        assert m["device.shards"] == "1" and m["device.backend_level"] == "1"
        c.close()
    finally:
        run.close()


def test_partitioned_toml_loads(cpu_env, tmp_path):
    toml = tmp_path / "p.toml"
    toml.write_text('[cluster]\npartitions = 2\npartition_id = 0\n'
                    'partition_map = "0=127.0.0.1:7001;1=127.0.0.1:7002"\n')
    cfg = Config.load(str(toml))
    assert (cfg.cluster.partitions, cfg.cluster.partition_id) == (2, 0)
    pmap = partmap.parse_map_spec(cfg.cluster.partition_map, 2, cfg.cluster.map_epoch)
    assert pmap.replicas == [["127.0.0.1:7001"], ["127.0.0.1:7002"]]


def test_top_once_against_a_cpu_node_exits_0(node):
    run, c = node
    c.set("a", "1")
    assert _wait(lambda: _mirror_serves(c))
    addr = f"127.0.0.1:{run.port}"
    proc = subprocess.run(
        [sys.executable, "-m", "merklekv_tpu_torch", "top", "--nodes", addr, "--once",
         "--interval", "0.1", "--events"],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    header = lines[0].split()
    row = next(ln for ln in lines if ln.startswith(addr)).split()
    assert row[-1] == "UP" and row[header.index("BKND")] == "1"
    assert "-- flight events" in proc.stdout


def test_blackbox_on_an_unreadable_input_exits_1(tmp_path):
    bad = tmp_path / "garbage.bin"
    bad.write_bytes(b"not a spill")
    proc = subprocess.run(
        [sys.executable, "-m", "merklekv_tpu_torch", "blackbox", str(bad)],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert f"unreadable: {bad}" in proc.stdout


def _durable_cfg(tmp_path, port, broker, partition_map=None) -> Config:
    cfg = Config()
    cfg.host = "127.0.0.1"
    cfg.port = port
    cfg.storage.enabled = True
    cfg.storage_path = str(tmp_path)
    cfg.replication.mqtt_broker = broker.host
    cfg.replication.mqtt_port = broker.port
    cfg.replication.topic_prefix = f"node-{port}"
    cfg.anti_entropy.interval_seconds = 3600.0
    if partition_map:
        cfg.cluster.partitions = 1
        cfg.cluster.partition_id = 0
        cfg.cluster.partition_map = partition_map
        cfg.replication.enabled = True
    return cfg


def _router_runs(tmp_path):
    """``router`` fronts a one-partition node for a plain client."""
    cfg = _cfg(replication=False)
    _partitions(cfg)
    cfg.cluster.partitions = 1
    cfg.cluster.partition_map = f"0=127.0.0.1:{cfg.port}"
    run = start(cfg)
    env = dict(os.environ, MERKLEKV_TORCH_DEVICE="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "merklekv_tpu_torch", "router", "--port", "0",
         "--seeds", f"127.0.0.1:{run.port}"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("merklekv_tpu_torch router listening on 127.0.0.1:"), line
        port = int(line.split()[4].rsplit(":", 1)[1])
        with MerkleKVClient("127.0.0.1", port, timeout=30) as c:
            assert c.set("r", "1") and c.get("r") == "1"
        assert run.engine.get(b"r") == b"1"
    finally:
        proc.terminate()
        proc.wait(30)
        run.close()


def _rebalance_runs(tmp_path):
    """``rebalance`` splits a durable one-partition node's keyspace to a
    reserve node and exits 0 at phase ``done``, the map at epoch 2."""
    from merklekv_tpu_torch.cluster.transport import TcpBroker

    broker = TcpBroker()
    ports = _free_ports(2)
    donor = start(_durable_cfg(tmp_path, ports[0], broker, f"0=127.0.0.1:{ports[0]}"))
    reserve = start(_durable_cfg(tmp_path, ports[1], broker))
    try:
        with MerkleKVClient("127.0.0.1", ports[0], timeout=30) as c:
            c.mset({f"s{i:03d}": f"v{i}" for i in range(200)})
        assert main(["rebalance", "--donor", f"127.0.0.1:{ports[0]}", "--partition", "0",
                     "--joiner", f"127.0.0.1:{ports[1]}", "--timeout", "120"]) == 0
        with MerkleKVClient("127.0.0.1", ports[0], timeout=30) as c:
            pmap = c.partition_map()
        assert (pmap.epoch, pmap.count) == (2, 2)
        assert donor.engine.dbsize() + reserve.engine.dbsize() == 200
        assert reserve.engine.dbsize() > 0
    finally:
        reserve.close()
        donor.close()
        broker.close()


@pytest.mark.parametrize("sub", ["router", "rebalance"])
def test_router_and_rebalance_subcommands_run(cpu_env, tmp_path, sub):
    {"router": _router_runs, "rebalance": _rebalance_runs}[sub](tmp_path)


def _check_parse_map_spec(tmp_path):
    spec = "0=a:1,b:2;1=c:3;2=d:4"
    return partmap.parse_map_spec(spec, 3, 5).wire(), jpartmap.parse_map_spec(spec, 3, 5).wire()


def _check_load_map_file(tmp_path):
    pmap = jpartmap.parse_map_spec("0=a:1;1=b:2", 2, 4).split(0, ["c:3"])
    jpartmap.save_map_file(str(tmp_path), pmap, 2)
    got, pid = partmap.load_map_file(str(tmp_path))
    return (got.wire(), pid), (pmap.wire(), 2)


def _check_save_map_file(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    partmap.save_map_file(str(tmp_path / "t"), partmap.parse_map_spec("0=a:1;1=b:2", 2, 4), 1)
    jpartmap.save_map_file(str(tmp_path / "j"), jpartmap.parse_map_spec("0=a:1;1=b:2", 2, 4), 1)
    return ((tmp_path / "t" / "partmap.spec").read_bytes(),
            (tmp_path / "j" / "partmap.spec").read_bytes())


def _check_key_in_range(tmp_path):
    cells = [(3, 0, 0, 0), (3, 1, 1, 1), (3, 2, 2, 3), (5, 4, 3, 6)]
    keys = [b"kr:%05d" % i for i in range(2000)]
    return ([[partmap.key_in_range(k, *c) for c in cells] for k in keys],
            [[jpartmap.key_in_range(k, *c) for c in cells] for k in keys])


def _check_rebalance_manager(tmp_path):
    from merklekv_tpu.cluster import rebalance as jrebalance
    from merklekv_tpu_torch.cluster import rebalance

    mgr = rebalance.RebalanceManager(object())
    assert mgr.state == "idle" and mgr.state_code() == 0
    return rebalance.STATE_CODES, jrebalance.STATE_CODES


def _check_bootstrap_session(tmp_path):
    from merklekv_tpu.cluster import bootstrap as jbootstrap
    from merklekv_tpu_torch.cluster import bootstrap

    sess = bootstrap.BootstrapSession(None, None, [], None)
    assert sess.state == "idle" and sess.state_code() == 0
    return bootstrap.STATE_CODES, jbootstrap.STATE_CODES


_NODE_IMPORTS = {
    "parse_map_spec": ("cluster.partmap", _check_parse_map_spec),
    "load_map_file": ("cluster.partmap", _check_load_map_file),
    "save_map_file": ("cluster.partmap", _check_save_map_file),
    "key_in_range": ("cluster.partmap", _check_key_in_range),
    "RebalanceManager": ("cluster.rebalance", _check_rebalance_manager),
    "BootstrapSession": ("cluster.bootstrap", _check_bootstrap_session),
}


@pytest.mark.parametrize("name", sorted(_NODE_IMPORTS))
def test_names_the_node_imports_are_the_real_ones_and_agree_with_jax(name, tmp_path):
    import importlib

    module, check = _NODE_IMPORTS[name]
    obj = getattr(importlib.import_module(f"merklekv_tpu_torch.{module}"), name)
    assert obj.__module__ == f"merklekv_tpu_torch.{module}"
    ours, theirs = check(tmp_path)
    assert ours == theirs


def test_load_map_file_reads_a_jax_written_map_and_none_for_an_empty_directory(tmp_path):
    """A durable node reads its data directory's partition map at start: a
    map the JAX package committed loads, and a directory without one gives
    ``None`` (the node starts as a whole keyspace)."""
    assert partmap.load_map_file(str(tmp_path)) is None
    pmap = jpartmap.parse_map_spec("0=a:1;1=b:2", 2, 6)
    jpartmap.save_map_file(str(tmp_path), pmap, 1)
    got, pid = partmap.load_map_file(str(tmp_path))
    assert pid == 1 and got.wire() == pmap.wire() and got.epoch == 6


def test_node_paths_run(node):
    """The node's partition, bootstrap and rebalance paths (refused before
    those modules were ported) run on a live node."""
    run, c = node
    assert c._request("REBALANCE STATUS") == "REBALSTATUS idle 0 -"
    pmap = partmap.parse_map_spec(f"0=127.0.0.1:{run.port};1=127.0.0.1:1", 2, 3)
    run.node.adopt_partition_map(pmap, 0)
    assert c.partition_map().wire() == pmap.wire()
    other = next(f"k{i}" for i in range(99) if partmap.partition_of(f"k{i}", 2) == 1)
    with pytest.raises(MovedError):
        c.set(other, "v")
    run.node._start_bootstrap("empty-keyspace")
    run.node._bootstrap_thread.join(60)
    assert run.node._bootstrap.state == "failed"  # no donor to fetch from
    assert run.server.serving  # the read gate reopened


def test_node_without_gpu_fails_at_start(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-GPU start is not observable")
    monkeypatch.delenv("MERKLEKV_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA.*MERKLEKV_TORCH_DEVICE"):
        start(_cfg())
    # An explicit host-path node needs no device and starts.
    run = start(_cfg(engine="cpu"))
    run.close()


def test_profile_answers_its_dir_and_writes_a_torch_trace(cpu_env, tmp_path):
    cfg = _cfg(replication=False)
    cfg.observability.profile_dir = str(tmp_path)
    run = start(cfg)
    try:
        c = MerkleKVClient("127.0.0.1", run.port, timeout=60).connect()
        captures = int(c.metrics().get("profiler.captures", 0))
        logdir = Path(c.profile(1))
        assert logdir.parent == tmp_path
        c.set("p", "1")
        c.hash()
        trace = logdir / f"merklekv-{os.getpid()}.pt.trace.json"
        assert _wait(trace.exists, timeout=60)
        assert _wait(lambda: c._request("PROFILE 1").startswith("PROFILE "), timeout=60)
        assert "traceEvents" in json.loads(trace.read_text())
        assert int(c.metrics()["profiler.captures"]) >= captures + 2
        c.close()
    finally:
        time.sleep(1.5)  # let the second capture stop before the node goes
        run.close()
