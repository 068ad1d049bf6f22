"""The torch port's replication wire against the JAX package's, on the CPU.

- Codec parity: the port's change-event codecs (CBOR, binary, JSON) and the
  batch envelope encode seeded events to exactly the JAX package's bytes,
  and each package decodes the other's frames to the same events.
- Interop: a torch node (``merklekv_tpu_torch.__main__.start``) and a JAX
  node (``merklekv_tpu.cluster.node.ClusterNode``) on one ``TcpBroker``
  replicate writes and deletes both ways; then, replication off, a diverged
  pair converges by ``SYNC`` in each direction to bit-identical roots with
  the device threshold at 0 (``MKV_DEVICE_THRESHOLD=0``), so both nodes take
  their device route (the torch node's on the CPU).

This is the one torch test file that uses the JAX package's native build
(``merklekv_tpu/native``); every other torch test runs on the port's own
build under ``build/native/``. Tolerance: exact equality.
"""

import dataclasses
import hashlib
import struct
import time
import uuid

import numpy as np
import pytest

from merklekv_tpu.cluster import change_event as jce
from merklekv_tpu.cluster import sync as jsync
from merklekv_tpu.cluster.node import ClusterNode as JaxNode
from merklekv_tpu.config import Config as JaxConfig
from merklekv_tpu.native_bindings import NativeEngine as JaxEngine
from merklekv_tpu.native_bindings import NativeServer as JaxServer
from merklekv_tpu_torch.__main__ import start
from merklekv_tpu_torch.client import MerkleKVClient
from merklekv_tpu_torch.cluster import change_event as tce
from merklekv_tpu_torch.cluster import sync as tsync
from merklekv_tpu_torch.cluster.transport import TcpBroker
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.merkle import torch_engine

_OPS = ("SET", "DEL", "INCR", "DECR", "APPEND", "PREPEND")


def _events(mod, seed: int, n: int = 40) -> list:
    """Seeded events of ``mod``'s ChangeEvent: every op, ASCII, unicode and
    non-UTF-8 (surrogate-escaped) keys, binary values, optional prev/ttl."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        op = _OPS[i % len(_OPS)]
        kind = int(rng.integers(0, 3))
        if kind == 0:
            key = f"k{seed}-{i}"
        elif kind == 1:
            key = f"ключ-{i}-é"
        else:
            key = (b"\xff\xfe" + rng.bytes(4)).decode("utf-8", "surrogateescape")
        val = None if op == "DEL" else rng.bytes(int(rng.integers(0, 90)))
        prev = rng.bytes(32) if rng.random() < 0.3 else None
        ttl = int(rng.integers(1, 10**6)) if rng.random() < 0.3 else None
        out.append(mod.ChangeEvent(
            op=mod.OpKind[op], key=key, val=val,
            ts=int(rng.integers(0, 2**62)), src=f"node-{seed}",
            op_id=rng.bytes(16), prev=prev, ttl=ttl,
        ))
    return out


def _fields(ev) -> dict:
    d = dataclasses.asdict(ev)
    d["op"] = ev.op.value
    return d


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("codec", ["cbor", "binary", "json"])
def test_codec_bytes_match_the_jax_package(codec, seed):
    enc, dec = f"encode_{codec}", f"decode_{codec}"
    for tev, jev in zip(_events(tce, seed), _events(jce, seed)):
        frame = getattr(tce, enc)(tev)
        assert frame == getattr(jce, enc)(jev)
        assert _fields(getattr(jce, dec)(frame)) == _fields(tev)
        assert _fields(getattr(tce, dec)(frame)) == _fields(jev)
        assert _fields(tce.decode_any(frame)) == _fields(jce.decode_any(frame))


@pytest.mark.parametrize("seed", range(3))
def test_batch_envelope_matches_the_jax_package(seed):
    tevs, jevs = _events(tce, seed), _events(jce, seed)
    # A repeated key, so coalescing has something to drop.
    tevs.append(dataclasses.replace(tevs[0], ts=tevs[0].ts + 1))
    jevs.append(dataclasses.replace(jevs[0], ts=jevs[0].ts + 1))
    tkept, tdropped = tce.coalesce_events(tevs)
    jkept, jdropped = jce.coalesce_events(jevs)
    assert tdropped == jdropped == 1
    assert [_fields(e) for e in tkept] == [_fields(e) for e in jkept]
    kw = dict(src=f"node-{seed}", hwm_seq=1000 + seed, hwm_ts=17 + seed, trace=None)
    frame = tce.encode_batch_cbor(tkept, **kw)
    assert frame == jce.encode_batch_cbor(jkept, **kw)
    got_t, meta_t = tce.decode_events_meta(frame)
    got_j, meta_j = jce.decode_events_meta(frame)
    assert [_fields(e) for e in got_t] == [_fields(e) for e in got_j] == [_fields(e) for e in tkept]
    assert meta_t == meta_j
    assert [_fields(e) for e in tce.decode_events(frame)] == [_fields(e) for e in jkept]


# ------------------------------------------------------------------ interop

def _hashlib_root(items) -> str:
    """Independent chain: sha256(u32be(len k) k u32be(len v) v) leaves over
    sorted keys, sha256(l + r) parents, an odd tail promoted."""
    if not items:
        return "0" * 64
    level = [hashlib.sha256(struct.pack(">I", len(k)) + k + struct.pack(">I", len(v)) + v).digest()
             for k, v in sorted(items)]
    while len(level) > 1:
        nxt = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0].hex()


class _JaxPeer:
    """A JAX-package node in this process: its native engine and server and
    its ``ClusterNode``."""

    def __init__(self, broker, topic: str) -> None:
        self.engine = JaxEngine("mem")
        self.server = JaxServer(self.engine, "127.0.0.1", 0)
        self.server.start()
        cfg = JaxConfig()
        cfg.replication.enabled = True
        cfg.replication.mqtt_broker = broker.host
        cfg.replication.mqtt_port = broker.port
        cfg.replication.topic_prefix = topic
        cfg.replication.client_id = "jax-node"
        self.node = JaxNode(cfg, self.engine, self.server)
        self.node.start()
        self.port = self.server.port

    def close(self) -> None:
        self.node.stop()
        self.server.close()
        self.engine.close()


def _mirrors_serve(*clients) -> bool:
    """True once every node answers HASH from its mirror (rung 1)."""
    for c in clients:
        c.hash()
    return all(c.metrics().get("device.backend_level") == "1" for c in clients)


def _wait(fn, timeout=15.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture
def cluster(monkeypatch):
    """(torch node, JAX node, their clients) on one broker, with the device
    threshold at 0 in both packages."""
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tsync, "_DEVICE_THRESHOLD", 0)
    monkeypatch.setattr(jsync, "_DEVICE_THRESHOLD", 0)
    broker = TcpBroker()
    topic = f"interop-{uuid.uuid4().hex[:8]}"
    cfg = Config()
    cfg.port = 0
    cfg.replication.enabled = True
    cfg.replication.mqtt_broker = broker.host
    cfg.replication.mqtt_port = broker.port
    cfg.replication.topic_prefix = topic
    cfg.replication.client_id = "torch-node"
    torch_node = start(cfg)
    jax_node = _JaxPeer(broker, topic)
    ct = MerkleKVClient("127.0.0.1", torch_node.port, timeout=120).connect()
    cj = MerkleKVClient("127.0.0.1", jax_node.port, timeout=120).connect()
    yield torch_node, jax_node, ct, cj
    ct.close()
    cj.close()
    torch_node.close()
    jax_node.close()
    broker.close()


def test_torch_and_jax_nodes_replicate_and_sync_to_identical_roots(cluster, monkeypatch):
    torch_node, jax_node, ct, cj = cluster
    fallbacks = int(ct.metrics().get("device.fallbacks", 0))  # the process's registry

    # Both subscriptions are live once a sentinel crosses each way; a
    # sentinel published before the peer subscribed is lost (QoS 0), so
    # each poll sends it again.
    def crossed() -> bool:
        ct.set("hello-from-torch", "1")
        cj.set("hello-from-jax", "1")
        return cj.get("hello-from-torch") == "1" and ct.get("hello-from-jax") == "1"

    assert _wait(crossed, timeout=60)

    for i in range(40):
        (ct if i % 2 else cj).set(f"rep:{i:03d}", f"v{i}")
    # Each node deletes a key the OTHER wrote, so the write must have
    # replicated first: a DEL of a key the node does not hold yet answers
    # NOT_FOUND and publishes nothing, yet leaves a newer tombstone that
    # makes the late SET lose by LWW on that node alone.
    assert _wait(lambda: ct.get("rep:004") == "v4" and cj.get("rep:007") == "v7")
    assert ct.delete("rep:004") and cj.delete("rep:007")
    assert _wait(lambda: torch_node.engine.snapshot() == jax_node.engine.snapshot())
    assert _wait(lambda: _mirrors_serve(ct, cj), timeout=60)
    items = torch_node.engine.snapshot()
    assert ct.hash(force=True) == cj.hash(force=True) == _hashlib_root(items)

    # Diverge with replication off, then SYNC in each direction. The torch
    # node's walk hashes through torch_engine.leaf_digests (the device
    # route at threshold 0).
    calls = []
    real = torch_engine.leaf_digests

    def spy(keys, values, device=None):
        calls.append((len(keys), str(device)))
        return real(keys, values, device=device)

    monkeypatch.setattr(torch_engine, "leaf_digests", spy)
    assert ct.replicate("disable") and cj.replicate("disable")
    for i in range(30):
        ct.set(f"torch-only:{i}", f"t{i}")
        cj.set(f"jax-only:{i}", f"j{i}")
    ct.set("rep:001", "torch-side")
    cj.delete("rep:002")

    assert ct.sync_with("127.0.0.1", jax_node.port)
    assert torch_node.engine.snapshot() == jax_node.engine.snapshot()
    assert calls and all(dev == "cpu" for _, dev in calls)
    want = _hashlib_root(jax_node.engine.snapshot())
    assert ct.hash(force=True) == cj.hash(force=True) == want

    for i in range(25):
        ct.set(f"second:{i}", f"s{i}")
    ct.delete("rep:010")
    assert cj.sync_with("127.0.0.1", torch_node.port)
    assert torch_node.engine.snapshot() == jax_node.engine.snapshot()
    want = _hashlib_root(torch_node.engine.snapshot())
    assert ct.hash(force=True) == cj.hash(force=True) == want

    # Replication back on: both mirrors warm again and serve that root.
    assert ct.replicate("enable") and cj.replicate("enable")
    assert _wait(lambda: _mirrors_serve(ct, cj), timeout=60)
    assert ct.hash(force=True) == cj.hash(force=True) == want
    assert int(ct.metrics().get("device.fallbacks", 0)) == fallbacks
