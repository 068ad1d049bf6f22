"""The torch port's node (``python -m merklekv_tpu_torch``) on the CPU.

- A node started by ``__main__.start`` with replication on the in-process
  bus serves ``HASH`` and ``TREELEVEL`` from its mirror (``METRICS``:
  ``device.backend_level:1``), equal to the hashlib chain and the golden
  tree after writes, deletes and a ``TRUNCATE``.
- ``python -m merklekv_tpu_torch --port 0`` prints its readiness line and
  exits 0 on SIGTERM.
- Refusals: every feature the port does not have yet raises
  ``NotImplementedError`` naming its ROADMAP item, from a config, a flag, the
  environment, a subcommand, or a name the JAX node imports from the
  feature's module; a node whose engine is not ``"cpu"`` fails at start
  without a GPU unless ``MERKLEKV_TORCH_DEVICE=cpu``.
- ``PROFILE <secs>`` answers ``PROFILE <dir>`` and writes a torch trace.

Every node here runs with ``MERKLEKV_TORCH_DEVICE=cpu`` unless a test says
otherwise. Tolerance: exact equality.
"""

import hashlib
import json
import os
import signal
import struct
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from merklekv_tpu_torch import unported
from merklekv_tpu_torch.__main__ import main, start
from merklekv_tpu_torch.client import MerkleKVClient
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
    _check(c, refill.items())
    m = c.metrics()
    assert int(m.get("device.pump_batches", 0)) > int(base.get("device.pump_batches", 0))
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


# ----------------------------------------------------------------- refusals

def _storage(cfg):
    cfg.storage.enabled = True


def _partitions(cfg):
    cfg.cluster.partitions = 2
    cfg.cluster.partition_id = 0


def _bootstrap(cfg):
    cfg.bootstrap.enabled = True


def _sharding(cfg):
    cfg.device.sharding = "auto"


@pytest.mark.parametrize("setup,item", [
    (_storage, "item 6"), (_partitions, "item 7"), (_bootstrap, "item 8"), (_sharding, "item 3"),
])
def test_unported_config_is_refused_at_start(cpu_env, setup, item):
    cfg = _cfg()
    setup(cfg)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue A {item}"):
        start(cfg)


def test_multihost_is_refused(cpu_env, monkeypatch):
    monkeypatch.setenv("MKV_COORDINATOR", "127.0.0.1:1234")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 4"):
        start(_cfg(replication=False))


def test_durable_flag_and_partitioned_toml_are_refused(cpu_env, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 6"):
        main(["--durable", "--port", "0"])
    toml = tmp_path / "p.toml"
    toml.write_text('[cluster]\npartitions = 2\npartition_id = 0\n'
                    'partition_map = "0=127.0.0.1:7001;1=127.0.0.1:7002"\n')
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 7"):
        Config.load(str(toml))


@pytest.mark.parametrize("sub", unported.SUBCOMMANDS)
def test_unported_subcommand_is_refused(sub):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 9"):
        main([sub])


@pytest.mark.parametrize("name", [
    "parse_map_spec", "load_map_file", "save_map_file", "key_in_range",
    "RebalanceManager", "BootstrapSession", "DurableStore", "node_data_dir",
])
def test_names_the_node_imports_from_unported_modules_refuse(name):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        getattr(unported, name)(None)


def test_node_paths_into_unported_modules_refuse(node):
    run, c = node
    with pytest.raises(NotImplementedError, match="item 7"):
        run.node.adopt_partition_map(None, 0)
    with pytest.raises(NotImplementedError, match="item 8"):
        run.node._start_bootstrap("empty-keyspace")
    assert run.server.serving  # the bootstrap refusal came before the read gate
    resp = c._request("REBALANCE STATUS")
    assert resp.startswith("ERROR") and "item 7" in resp


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
