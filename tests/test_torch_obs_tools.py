"""``top`` and ``blackbox`` in the torch port (``merklekv_tpu_torch/obs/top.py``,
``obs/blackbox.py``) against the JAX package's, on the CPU.

- The JAX package's cases of both tools (``tests/test_obs.py``,
  ``tests/test_flightrec.py``, ``tests/test_partitions.py``,
  ``tests/test_device_faults.py``, ``tests/test_device_ladder.py``,
  ``tests/test_pump.py``, ``tests/test_zero_copy.py``) run against the
  port's modules: sampling a native server and a partitioned torch node,
  the table's columns, the events and router panes, the analyzer's merge,
  trace links, anomaly classes (device-ladder step-downs and fallback
  heartbeats with their ``environment|code`` kinds, staleness, shortfall,
  slow bursts), the partition scope, fatal markers and the CLI's rc.
- Two torch nodes SIGKILLed mid-burst leave complete spills that the port's
  ``blackbox`` merges (rc 0).
- Parity: seeded ``NodeSample``s render to the same text in both packages
  (``render_table``, ``render_events_pane``, ``render_router_pane``), and
  over a JAX node's spill, a torch node's spill and a mix of both (also
  with an unreadable input) both analyzers print the same bytes with
  ``--json`` and as text, and return the same rc.

Every torch node runs with ``MERKLEKV_TORCH_DEVICE=cpu``, every JAX one on
the CPU. Tolerance: exact equality.
"""

import contextlib
import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from merklekv_tpu.obs import blackbox as jblackbox
from merklekv_tpu.obs import top as jtop
from merklekv_tpu_torch.__main__ import start
from merklekv_tpu_torch.client import MerkleKVClient
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.native_bindings import NativeEngine, NativeServer
from merklekv_tpu_torch.obs import blackbox, top
from merklekv_tpu_torch.obs.blackbox import (
    Report,
    TimelineEntry,
    find_anomalies,
    load_docs,
    merge_timeline,
    partition_incident_scope,
)
from merklekv_tpu_torch.obs.flightrec import (
    FlightEvent,
    FlightRecorder,
    Sample,
    SpillDoc,
    read_spill,
    write_spill,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def server():
    eng = NativeEngine("mem")
    srv = NativeServer(eng, "127.0.0.1", 0)
    srv.start()
    yield eng, srv
    srv.close()
    eng.close()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


# ------------------------------------------------------------------- top

def test_top_sample_and_render(server):
    _, srv = server
    node = f"127.0.0.1:{srv.port}"
    with MerkleKVClient("127.0.0.1", srv.port) as c:
        for i in range(10):
            c.set(f"t:{i}", "v")
    s0 = top.sample_node(node)
    assert s0.ok and s0.keys == 10
    assert s0.latency_p50_us is not None and s0.latency_p50_us > 0
    with MerkleKVClient("127.0.0.1", srv.port) as c:
        for i in range(5):
            c.get(f"t:{i}")
    time.sleep(0.05)
    s1 = top.sample_node(node)
    frame = top.render_table({node: s0}, {node: s1})
    assert node in frame and "UP" in frame and "KEYS" in frame
    # A dead node renders a DOWN row instead of raising.
    dead = "127.0.0.1:1"
    frame2 = top.render_table({}, {dead: top.sample_node(dead, timeout=0.2)})
    assert "DOWN" in frame2


def test_top_once_cli(server):
    _, srv = server
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = top.main(["--nodes", f"127.0.0.1:{srv.port}", "--interval", "0.1", "--once"])
    assert rc == 0
    assert f"127.0.0.1:{srv.port}" in out.getvalue()


def test_top_events_pane_renders():
    s = top.NodeSample(node="n1:1", ok=True)
    s.events = [
        {"seq": "3", "wall_ns": str(time.time_ns()),
         "kind": "degradation", "prev": "live", "new": "shedding"},
        {"seq": "2", "wall_ns": str(time.time_ns() - int(5e9)),
         "kind": "slow_command", "verb": "GET", "dur_us": "15000"},
    ]
    pane = top.render_events_pane({"n1:1": s})
    assert "flight events" in pane
    assert "degradation" in pane and "new=shedding" in pane
    assert "slow_command" in pane and "verb=GET" in pane


def _bknd_rows():
    s = top.NodeSample(node="n1", ok=True, unix=1.0)
    s.backend_level = 1
    old = top.NodeSample(node="n2", ok=True, unix=1.0)  # pre-ladder node
    assert old.backend_level == -2
    return {}, {"n1": s, "n2": old}, "BKND", {"n1": "1", "n2": "-"}


def _served_bytes_rows():
    s = top.NodeSample(node="n1:7379", ok=True)
    prev = top.NodeSample(node="n1:7379", ok=True)
    return {"n1:7379": prev}, {"n1:7379": s}, "SRV_MB/S", {"n1:7379": "0.0"}


@pytest.mark.parametrize("rows", [_bknd_rows, _served_bytes_rows],
                         ids=["bknd-column", "served-bytes-column"])
def test_top_table_columns(rows):
    """``device.backend_level`` parses into BKND ('-' for a node without
    the line); the served-bytes rate renders as SRV_MB/S."""
    prev, cur, column, want = rows()
    lines = top.render_table(prev, cur).splitlines()
    idx = lines[0].split().index(column)
    for node, value in want.items():
        assert next(ln for ln in lines if ln.startswith(node)).split()[idx] == value


def test_top_part_column_and_sample_of_a_partitioned_torch_node(monkeypatch):
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")
    ports = _free_ports(2)
    cfg = Config()
    cfg.host, cfg.port = "127.0.0.1", ports[1]
    cfg.cluster.partitions = 2
    cfg.cluster.partition_id = 1
    cfg.cluster.partition_map = f"0=127.0.0.1:{ports[0]};1=127.0.0.1:{ports[1]}"
    run = start(cfg)
    try:
        addr = f"127.0.0.1:{run.port}"
        s = top.sample_node(addr)
        assert s.ok, s.error
        assert s.partition == 1
        table = top.render_table({}, {addr: s})
        assert "PART" in table.splitlines()[0]
        assert table.splitlines()[2].split()[1] == "1"
    finally:
        run.close()


def test_top_reads_a_torch_mirror_on_rung_1_and_its_pump_lag(monkeypatch):
    """A torch node's mirror (the kernels' plain versions on the CPU here)
    reports BKND 1 and a numeric STALE through the port's ``device.*``
    metrics."""
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")
    cfg = Config()
    cfg.host, cfg.port = "127.0.0.1", 0
    cfg.replication.enabled = True
    cfg.replication.mqtt_broker = "local"
    run = start(cfg)
    try:
        addr = f"127.0.0.1:{run.port}"
        with MerkleKVClient("127.0.0.1", run.port, timeout=60) as c:
            c.set("a", "1")
            end = time.monotonic() + 30
            while c.metrics().get("device.backend_level") != "1" and time.monotonic() < end:
                c.hash()
                time.sleep(0.02)
        s = top.sample_node(addr)
        assert s.ok and s.backend_level == 1 and s.pump_lag_ms >= 0 and s.tree_version >= 0
        lines = top.render_table({}, {addr: s}).splitlines()
        header, row = lines[0].split(), lines[2].split()
        assert row[header.index("BKND")] == "1"
        assert row[header.index("STALE")] == str(s.pump_lag_ms)
    finally:
        run.close()


# ------------------------------------------------------------- blackbox

def _spill_pair(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    r1 = FlightRecorder()
    r1.record("node_start", port=1)
    r1.record("degradation", prev="live", new="read_only", reason="disk",
              trace="cafe0000cafe0000")
    write_spill(str(d1 / "flight.bin"), r1.last(0), [], node="A:1")
    time.sleep(0.002)
    r2 = FlightRecorder()
    r2.record("node_start", port=2)
    r2.record("sync_cycle", cycle=3, outcome="error", trace="cafe0000cafe0000")
    write_spill(str(d2 / "flight.bin"), r2.last(0),
                [Sample(wall_ns=time.time_ns(), values={"replication.lag_events.A": 250})],
                node="B:2")
    return str(d1), str(d2)


def test_blackbox_merges_ordered_timeline_with_trace_links(tmp_path):
    d1, d2 = _spill_pair(tmp_path)
    report = load_docs([d1, d2])
    assert not report.errors
    assert not any(doc.truncated for doc in report.docs)
    walls = [e.event.wall_ns for e in report.timeline]
    assert walls == sorted(walls)
    assert {e.node for e in report.timeline} == {"A:1", "B:2"}
    assert report.trace_links == {"cafe0000cafe0000": ["A:1", "B:2"]}
    assert {"degradation", "sync_failure", "lag_spike"} <= {a.kind for a in report.anomalies}


def test_blackbox_cli_json_and_rc(tmp_path, capsys):
    d1, d2 = _spill_pair(tmp_path)
    assert blackbox.main([d1, d2, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert len(doc["spills"]) == 2 and doc["trace_links"]
    assert all(s["error"] == "" for s in doc["spills"])
    assert blackbox.main([d1, d2]) == 0
    text = capsys.readouterr().out
    assert "merged timeline" in text and "anomalies" in text


def test_blackbox_unreadable_input_fails_loudly(tmp_path):
    bad = tmp_path / "garbage.bin"
    bad.write_bytes(b"not a spill")
    assert blackbox.main([str(bad)]) == 1


def test_blackbox_fatal_marker_lands_on_timeline(tmp_path):
    d1, d2 = _spill_pair(tmp_path)
    with open(os.path.join(d1, "fatal.txt"), "w") as f:
        f.write(f"fatal signal 11 pid 77 wall_ns {time.time_ns()}\n")
    report = load_docs([d1, d2])
    fatals = [e for e in report.timeline if e.event.kind == "fatal_signal"]
    # Attributed to the node whose spill shares the marker's directory.
    assert fatals and fatals[0].node == "A:1"
    assert any(a.kind == "fatal_signal" and a.node == "A:1" for a in report.anomalies)


def test_merge_preserves_per_node_seq_order_under_clock_step():
    t = time.time_ns()
    a = SpillDoc(path="a", meta={"node": "A", "pid": 11}, events=[
        FlightEvent(seq=1, wall_ns=t + int(5e9), mono_ns=1, kind="storage_full", fields={}),
        # clock stepped BACK 5 s between the two events
        FlightEvent(seq=2, wall_ns=t, mono_ns=2, kind="storage_recovered", fields={}),
    ])
    b = SpillDoc(path="b", meta={"node": "B", "pid": 22}, events=[
        FlightEvent(seq=1, wall_ns=t + int(2e9), mono_ns=1, kind="node_start", fields={}),
    ])
    merged = merge_timeline([a, b])
    assert [e.event.kind for e in merged if e.node == "A"] == ["storage_full", "storage_recovered"]
    assert len(merged) == 3


def test_merge_dedupes_shared_process_ring():
    t = time.time_ns()
    evs = [FlightEvent(seq=i, wall_ns=t + i, mono_ns=i, kind="degradation",
                       fields={"prev": "live", "new": "shedding"}) for i in range(1, 4)]
    a = SpillDoc(path="a", meta={"node": "A", "pid": 77}, events=list(evs))
    b = SpillDoc(path="b", meta={"node": "B", "pid": 77}, events=list(evs))
    merged = merge_timeline([a, b])
    assert len(merged) == 3 and {e.node for e in merged} == {"A"}
    b2 = SpillDoc(path="b", meta={"node": "B", "pid": 78}, events=list(evs))
    assert len(merge_timeline([a, b2])) == 6


def _evt(evt_kind, seq, **fields):
    # An event's own ``kind`` field (the classifier's verdict) must not
    # collide with the FlightEvent kind.
    return FlightEvent(seq=seq, wall_ns=1_000_000_000 + seq, mono_ns=seq, kind=evt_kind,
                       fields={k: str(v) for k, v in fields.items()})


@pytest.mark.parametrize("events,want", [
    ([_evt("device_degraded", 1, from_rung=8, to_rung=4, kind="environment", where="drain"),
      _evt("device_fallback", 2, rung=4),
      _evt("device_corruption", 3, leaf_index=17, rung=4),
      _evt("device_healed", 4, from_rung=4, to_rung=8)],
     [("device_degraded", "rung 8 -> 4 (environment @ drain)"),
      ("device_fallback", "serving native fallback (ladder rung 4)"),
      ("device_corruption", "scrub mismatch at leaf 17 (rung 4)")]),
    ([_evt("device_degraded", 1, from_rung=1, to_rung=0, kind="code", where="warm")],
     [("device_degraded", "rung 1 -> 0 (code @ warm)")]),
    ([_evt("tree_staleness", 1, lag_ms=500, lag_versions=9000, window_ms=200)],
     [("tree_staleness", "pump lag 500ms / 9000 versions (window 200ms)")]),
    ([_evt("multichip_phase", 1, phase="device-count", want=8, have=1)],
     [("environment", "device shortfall: have 1, want 8")]),
    ([_evt("multichip_phase", 1, phase="device-count", want=8, have=8)], []),
    ([_evt("slow_command", i, verb="GET", dur_us=20000, conn="x") for i in range(1, 5)],
     [("slow_burst", "3 slow commands within 10s (latest GET 20000us)")]),
], ids=["device-ladder-events", "code-kind-step-down", "tree-staleness", "device-shortfall",
        "full-device-complement", "slow-burst-once-per-window"])
def test_blackbox_anomaly_classes(events, want):
    """Device-ladder step-downs (with their environment|code kind), fallback
    heartbeats and scrub corruption; a wedged pump; a device shortfall as
    environment weather (a full complement stays silent); one slow burst
    per window."""
    doc = SpillDoc(path="x/flight", meta={"node": "n1"}, events=events)
    got = [(a.kind, a.detail) for a in find_anomalies([doc], merge_timeline([doc]))]
    assert got == want


def test_blackbox_partition_scope_classification():
    def doc(node, pid, events):
        evs = [FlightEvent(seq=i + 1, wall_ns=1_000 + i, mono_ns=i, kind=k, fields=dict(f))
               for i, (k, f) in enumerate(events)]
        return SpillDoc(path=f"/x/{node}/flight.bin", meta={"node": node}, events=evs, samples=[])

    def mk(nodes):
        docs = [doc(node, pid, [("node_start", {"port": 1, "partition": pid})] + extra)
                for node, pid, extra in nodes]
        r = Report(docs=docs)
        for d in docs:
            for ev in d.events:
                r.timeline.append(TimelineEntry(node=d.node, event=ev))
        r.anomalies = find_anomalies(docs, r.timeline)
        return r

    degraded = ("partition_degraded", {"partition": 0, "level": "read_only", "reason": "disk"})
    scope = partition_incident_scope(mk([("a", 0, [degraded]), ("b", 1, []), ("c", 2, [])]))
    assert "PARTITION-LOCAL" in scope and "partition 0" in scope
    r = mk([("a", 0, [degraded]),
            ("b", 1, [("partition_degraded",
                       {"partition": 1, "level": "shedding", "reason": "memory"})])])
    assert "CLUSTER-WIDE" in partition_incident_scope(r)
    assert partition_incident_scope(
        Report(docs=[doc("a", None, [("node_start", {"port": 1, "partition": None})])])) is None


def test_native_crash_marker_stamps_fatal_signal(tmp_path):
    """A SIGSEGV in a real process appends the port's async-signal-safe
    marker line before dying; the port's blackbox reads it as a
    fatal_signal event."""
    marker = str(tmp_path / "fatal.txt")
    code = (
        "import os\n"
        "from merklekv_tpu_torch.native_bindings import install_crash_marker\n"
        f"install_crash_marker({marker!r})\n"
        "os.kill(os.getpid(), 11)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, timeout=120)
    assert proc.returncode != 0  # died by signal
    with open(marker) as f:
        line = f.read()
    assert line.startswith("fatal signal 11 pid ") and "wall_ns" in line
    evs = blackbox._marker_events(marker)
    assert evs and evs[0].kind == "fatal_signal" and evs[0].fields["signal"] == 11


# ----------------------------------------- nodes killed mid-burst, parity

_TOML = """
host = "127.0.0.1"
port = {port}
engine = "mem"
storage_path = "{data}"

[storage]
enabled = true
fsync = "always"
merkle_engine = "cpu"

[observability]
flight_spill_s = 0.2
flight_sample_s = 0.1
slow_command_us = 1
"""


@pytest.fixture(scope="module")
def killed_nodes(tmp_path_factory):
    """Two torch nodes and one JAX node, each durable with a 0.2 s flight
    spill and every command slow, SIGKILLed after a second of writes:
    ``{"torch": [dir, dir], "jax": [dir]}`` of their flight directories."""
    tmp = tmp_path_factory.mktemp("killed")
    ports = _free_ports(3)
    kinds = ["torch", "torch", "jax"]
    procs, clients = [], []
    try:
        for i, (kind, port) in enumerate(zip(kinds, ports)):
            toml = tmp / f"n{i}.toml"
            toml.write_text(_TOML.format(port=port, data=tmp / f"data{i}"))
            pkg = "merklekv_tpu_torch" if kind == "torch" else "merklekv_tpu"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", pkg, "--config", str(toml)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
                         MERKLEKV_TORCH_DEVICE="cpu")))
        for proc in procs:
            line = proc.stdout.readline()
            assert "listening on" in line, line
        clients = [MerkleKVClient("127.0.0.1", p).connect() for p in ports]
        stop = threading.Event()

        def burst(c, tag):
            i = 0
            try:
                while not stop.is_set():
                    c.set(f"{tag}:{i:06d}", "v" * 32)
                    i += 1
            except Exception:
                pass  # the kill severs the connection

        threads = [threading.Thread(target=burst, args=(c, f"n{i}"), daemon=True)
                   for i, c in enumerate(clients)]
        for t in threads:
            t.start()
        time.sleep(1.0)  # several spill intervals land mid-burst
        for proc in procs:
            os.kill(proc.pid, signal.SIGKILL)
        stop.set()
        for t in threads:
            t.join(timeout=5)
        for proc in procs:
            proc.wait(timeout=10)
    finally:
        for c in clients:
            c.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    dirs = [str(tmp / f"data{i}" / f"node-{p}" / "flight") for i, p in enumerate(ports)]
    return {"torch": dirs[:2], "jax": dirs[2:], "ports": ports[:2]}


@pytest.mark.integration
def test_kill9_midburst_leaves_parseable_spills_and_blackbox_merges(killed_nodes, capsys):
    flight_dirs = killed_nodes["torch"]
    docs = []
    for d in flight_dirs:
        doc = read_spill(os.path.join(d, "flight.bin"))
        # The atomic rewrite leaves a complete spill though the node died
        # mid-burst.
        assert not doc.truncated and doc.error == ""
        kinds = [e.kind for e in doc.events]
        assert "node_start" in kinds or doc.events[0].seq > 1
        assert doc.events[-1].kind in ("slow_command", "admission_reject", "events_dropped",
                                       "writes_shed"), kinds[-5:]
        assert "slow_command" in kinds
        assert "node_stop" not in kinds  # the spill alone tells kill -9 from a stop
        assert len(doc.samples) >= 2
        docs.append(doc)
    assert blackbox.main([*flight_dirs, "--json"]) == 0
    capsys.readouterr()
    report = load_docs(flight_dirs)
    assert not report.errors
    assert {d.node for d in report.docs} == {f"127.0.0.1:{p}" for p in killed_nodes["ports"]}
    walls = [e.event.wall_ns for e in report.timeline]
    assert walls == sorted(walls)
    assert len(report.timeline) >= len(docs[0].events)


def _run_main(main, args, capsys) -> tuple[int, str]:
    rc = main(args)
    return rc, capsys.readouterr().out


@pytest.mark.integration
@pytest.mark.parametrize("inputs", [["jax"], ["torch"], ["jax", "torch"], ["torch", "jax", "bad"]],
                         ids=["jax-spill", "torch-spill", "mixed", "mixed-and-unreadable"])
@pytest.mark.parametrize("mode", [["--json"], ["--limit", "0"]], ids=["json", "text"])
def test_blackbox_output_and_rc_equal_the_jax_package(killed_nodes, tmp_path, capsys, inputs, mode):
    bad = tmp_path / "garbage.bin"
    bad.write_bytes(b"not a spill")
    paths = {"jax": killed_nodes["jax"], "torch": killed_nodes["torch"], "bad": [str(bad)]}
    args = [p for name in inputs for p in paths[name]] + mode
    ours = _run_main(blackbox.main, args, capsys)
    theirs = _run_main(jblackbox.main, args, capsys)
    assert ours == theirs
    assert ours[0] == (1 if "bad" in inputs else 0)
    if mode == ["--json"]:
        report = json.loads(ours[1])
        assert len(report["spills"]) == sum(len(paths[n]) for n in inputs if n != "bad")
        assert report["timeline"]


def _random_sample(cls, rng: np.random.Generator, node: str, now: float, prev=None):
    """A NodeSample of ``cls`` with seeded values for every field; ``prev``
    makes the counters grow from it."""
    s = cls(node=node, unix=now)
    grow = (lambda name: getattr(prev, name) + int(rng.integers(0, 5000))) if prev else \
        (lambda name: int(rng.integers(0, 10**6)))
    for name in ("keys", "total_commands", "set_commands", "get_commands", "sync_bytes",
                 "syncs", "shed_total", "served_bytes", "cache_hits", "cache_misses",
                 "lease_waits"):
        setattr(s, name, grow(name))
    s.ok = bool(rng.random() > 0.15)
    s.error = "" if s.ok else "ConnectionRefusedError: [Errno 111] refused"
    s.active_connections = int(rng.integers(0, 300))
    s.latency_p50_us = None if rng.random() < 0.2 else float(2 ** rng.integers(0, 20))
    s.peers_total = int(rng.integers(0, 5))
    s.peers_up = int(rng.integers(0, s.peers_total + 1))
    s.lag_events = int(rng.integers(0, 500))
    s.lag_ms = float(rng.random() * 1000)
    s.readiness = str(rng.choice(["-", "live", "lagging", "diverged"]))
    s.state = str(rng.choice(["-", "live", "shedding", "read_only", "draining"]))
    s.pump_lag_ms = int(rng.integers(-1, 300))
    s.tree_version = int(rng.integers(-1, 10**6))
    s.engine_version = int(rng.integers(-1, 10**6))
    s.backend_level = int(rng.integers(-2, 9))
    s.partition = int(rng.integers(-1, 4))
    s.io_threads = int(rng.integers(0, 9))
    s.worker_commands = {f"io_worker_{w}_commands": (prev.worker_commands.get(
        f"io_worker_{w}_commands", 0) if prev else 0) + int(rng.integers(0, 10**5))
        for w in range(s.io_threads)}
    s.cache_keys = int(rng.integers(0, 10**4))
    s.inval_lag_ms = float(rng.choice([-1.0, rng.random() * 50]))
    s.is_router = bool(rng.random() < 0.3)
    s.events = [{"seq": str(e), "wall_ns": str(int(now * 1e9) - int(rng.integers(0, 10**10))),
                 "kind": str(rng.choice(["degradation", "slow_command", "device_degraded"])),
                 "verb": "GET", "trace": "cafe"} for e in range(int(rng.integers(0, 4)))]
    return s


@pytest.mark.parametrize("seed", range(4))
def test_top_renders_the_same_text_as_the_jax_package(seed, monkeypatch):
    assert [f.name for f in dataclasses.fields(top.NodeSample)] == \
        [f.name for f in dataclasses.fields(jtop.NodeSample)]
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_000)
    frames = {}
    for pkg in (top, jtop):
        rng = np.random.default_rng(seed)
        nodes = [f"10.0.0.{i}:{7000 + i}" for i in range(6)]
        prev = {n: _random_sample(pkg.NodeSample, rng, n, 1_700_000_000.0) for n in nodes}
        cur = {n: _random_sample(pkg.NodeSample, rng, n, 1_700_000_002.5, prev[n])
               for n in nodes}
        frames[pkg.__name__] = (pkg.render_table(prev, cur), pkg.render_events_pane(cur),
                                pkg.render_router_pane(prev, cur))
    ours, theirs = frames[top.__name__], frames[jtop.__name__]
    assert ours == theirs
    assert "UP" in ours[0] and "flight events" in ours[1] and "request plane" in ours[2]
