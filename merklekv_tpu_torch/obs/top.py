"""``python -m merklekv_tpu_torch top`` — live cluster dashboard in the terminal.

A copy of ``merklekv_tpu/obs/top.py``, its imports pointed at the port's
modules. On a torch node the STALE, VER and BKND columns read the port's own
``device.*`` metrics (its mirror on the card: BKND 1).

Polls STATS / INFO / METRICS / PEERS across a node list over the normal
wire protocol (no exporter needed), computes per-interval rates from
successive counter samples, and renders one table per refresh:

    NODE  KEYS  OPS/S  SET/S  GET/S  P50_US  SYNC_KB/S  CONNS  W  OPS/S/W
    PEERS_UP  LAG_EV  LAG_MS  STALE  VER  BKND  READY  STATE  SHED/S  STATUS

(CONNS = active connections; W = epoll worker-pool width; OPS/S/W = the
busiest io worker's command rate, the pool-imbalance signal; STALE = the
device pump's worst lag in ms; VER = engine-vs-served tree version delta —
how many mutations the served Merkle tree trails live by; BKND = the
device degradation-ladder rung serving the tree: sharded width, 1 =
single-device, 0 = CPU golden, -1 = native fallback.)

``--once`` prints a single frame (two quick samples for rates) and exits —
scriptable and testable; without it the screen refreshes every
``--interval`` seconds until Ctrl-C.

``--events`` appends a flight-recorder pane: the newest black-box events
(degradation flips, slow commands, sync failures, peer flips) across the
polled nodes, fetched via the FLIGHT verb — the live view of what
``python -m merklekv_tpu_torch blackbox`` reads post-mortem.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from merklekv_tpu_torch.client import MerkleKVClient, MerkleKVError

__all__ = [
    "NodeSample",
    "sample_node",
    "render_table",
    "render_router_pane",
    "main",
]

_CLEAR = "\x1b[2J\x1b[H"


@dataclass
class NodeSample:
    node: str
    ok: bool = False
    error: str = ""
    unix: float = field(default_factory=time.time)
    keys: int = 0
    total_commands: int = 0
    set_commands: int = 0
    get_commands: int = 0
    active_connections: int = 0
    sync_bytes: int = 0  # sync.bytes_sent + sync.bytes_received
    syncs: int = 0
    latency_p50_us: Optional[float] = None
    peers_up: int = 0
    peers_total: int = 0
    # Convergence-lag plane (METRICS replication.lag_* lines): the WORST
    # peer's values, plus the node's readiness level (live|lagging|
    # diverged; "-" on nodes predating the lag plane).
    lag_events: int = 0
    lag_ms: float = 0.0
    readiness: str = "-"
    # Overload plane (METRICS node.degradation / node.shed_total lines):
    # the degradation rung and the cumulative shed count (BUSY-answered
    # writes + refused connections + pipeline closes) — rendered as the
    # STATE and SHED/s columns ("-" on nodes predating the ladder).
    state: str = "-"
    shed_total: int = 0
    # Device freshness plane (METRICS device.pump_lag_ms /
    # device.tree_version / node.engine_version lines): worst pump lag in
    # ms and the engine-vs-served tree version delta — rendered as the
    # STALE and VER columns (-1 / "-" on nodes without a device mirror or
    # predating the pump).
    pump_lag_ms: int = -1
    tree_version: int = -1
    engine_version: int = -1
    # Device fault-containment plane (METRICS device.backend_level line):
    # the degradation-ladder rung serving the tree — N>=2 sharded width,
    # 1 single-device, 0 CPU golden, -1 native fallback; -2 = the line is
    # absent (node predates the ladder / no mirror), rendered "-".
    backend_level: int = -2
    # Partition plane (METRICS partition.id line): the partition this
    # replica serves in a partitioned cluster — rendered as the PART
    # column ("-" on unpartitioned nodes).
    partition: int = -1
    # io plane (STATS io_threads / io_worker_<i>_commands lines): pool
    # width and per-worker cumulative command counts — rendered as the W
    # and OPS/S/W (busiest worker's rate) columns ("-" on nodes predating
    # the worker pool).
    io_threads: int = 0
    worker_commands: dict = field(default_factory=dict)
    # Zero-copy serving plane (STATS io_worker_<i>_writev_bytes summed):
    # cumulative bytes the io workers flushed to sockets — rendered as the
    # SRV_MB/S column (served-bytes rate; 0 on nodes predating the pool).
    served_bytes: int = 0
    # Request plane (INFO role:router + METRICS router.* lines): routers
    # polled alongside nodes render in their own pane — conns/worker via
    # the shared CONNS/W fields, plus cache hit rate, lease waits, and
    # invalidation lag (docs/OBSERVABILITY.md).
    is_router: bool = False
    cache_hits: int = 0
    cache_misses: int = 0
    cache_keys: int = 0
    lease_waits: int = 0
    inval_lag_ms: float = -1.0
    # Flight-recorder pane (--events): newest black-box events via the
    # FLIGHT verb, one dict per event ([] on nodes predating the verb or
    # when --events is off).
    events: list = field(default_factory=list)


def _p50_from_stats(stats: dict[str, str]) -> Optional[float]:
    """Native command-latency p50 (µs) from the raw cmd_latency_us_le_*
    bucket counts in STATS; None when the server predates them."""
    buckets = []
    for name, value in stats.items():
        if not name.startswith("cmd_latency_us_le_"):
            continue
        bound = name[len("cmd_latency_us_le_"):]
        try:
            buckets.append(
                (float("inf") if bound == "inf" else int(bound), int(value))
            )
        except ValueError:
            continue
    if not buckets:
        return None
    buckets.sort(key=lambda b: b[0])
    total = sum(c for _, c in buckets)
    if total == 0:
        return None
    rank, running = (total + 1) // 2, 0
    for bound, c in buckets:
        running += c
        if running >= rank:
            return float(bound)
    return None


def sample_node(
    node: str, timeout: float = 2.0, events_n: int = 0
) -> NodeSample:
    host, _, port = node.rpartition(":")
    s = NodeSample(node=node)
    try:
        with MerkleKVClient(host, int(port), timeout=timeout) as c:
            stats = c.stats()
            info = c.info()
            metrics = c.metrics()
            peers = c.peers()
            if events_n > 0:
                try:
                    s.events = c.flight(events_n)
                except MerkleKVError:
                    s.events = []  # node predates the FLIGHT verb
    except (MerkleKVError, OSError, ValueError) as e:
        s.error = f"{type(e).__name__}: {e}"
        return s
    s.ok = True
    s.keys = int(info.get("db_keys", 0) or 0)
    s.total_commands = int(stats.get("total_commands", 0) or 0)
    s.set_commands = int(stats.get("set_commands", 0) or 0)
    s.get_commands = int(stats.get("get_commands", 0) or 0)
    s.active_connections = int(stats.get("active_connections", 0) or 0)
    s.latency_p50_us = _p50_from_stats(stats)
    try:
        s.io_threads = int(stats.get("io_threads", 0) or 0)
    except ValueError:
        pass
    for name, value in stats.items():
        if name.startswith("io_worker_") and name.endswith("_commands"):
            try:
                s.worker_commands[name] = int(value)
            except ValueError:
                continue
        elif name.startswith("io_worker_") and name.endswith("_writev_bytes"):
            try:
                s.served_bytes += int(value)
            except ValueError:
                continue
    s.sync_bytes = int(metrics.get("sync.bytes_sent", 0) or 0) + int(
        metrics.get("sync.bytes_received", 0) or 0
    )
    s.syncs = int(metrics.get("anti_entropy.syncs", 0) or 0) + int(
        metrics.get("anti_entropy.multi_syncs", 0) or 0
    )
    s.peers_total = len(peers)
    s.peers_up = sum(1 for p in peers if p.get("status") == "up")
    from merklekv_tpu_torch.obs.lag import READINESS_CODES

    names = {str(code): name for name, code in READINESS_CODES.items()}
    s.readiness = names.get(metrics.get("readiness_code", ""), "-")
    from merklekv_tpu_torch.cluster.overload import LEVEL_NAMES

    level_names = {str(code): name for code, name in LEVEL_NAMES.items()}
    s.state = level_names.get(metrics.get("node.degradation", ""), "-")
    try:
        s.shed_total = int(metrics.get("node.shed_total", 0) or 0)
    except ValueError:
        pass
    for attr, key in (
        ("pump_lag_ms", "device.pump_lag_ms"),
        ("tree_version", "device.tree_version"),
        ("engine_version", "node.engine_version"),
        ("backend_level", "device.backend_level"),
        ("partition", "partition.id"),
    ):
        try:
            setattr(s, attr, int(metrics[key]))
        except (KeyError, ValueError):
            pass  # node predates the pump (or has no mirror)
    for name, value in metrics.items():
        try:
            if name.startswith("replication.lag_events."):
                s.lag_events = max(s.lag_events, int(value))
            elif name.startswith("replication.lag_ms."):
                s.lag_ms = max(s.lag_ms, float(value))
        except ValueError:
            continue
    s.is_router = info.get("role") == "router"
    if s.is_router:
        for attr, key, cast in (
            ("cache_hits", "router.cache_hits", int),
            ("cache_misses", "router.cache_misses", int),
            ("cache_keys", "router.cache_keys", int),
            ("lease_waits", "router.lease_waits", int),
            ("inval_lag_ms", "router.inval_lag_ms", float),
        ):
            try:
                setattr(s, attr, cast(metrics[key]))
            except (KeyError, ValueError):
                pass  # cache off / no invalidation feed attached
    return s


def _rate(cur: int, prev: int, dt: float) -> float:
    return max(0.0, (cur - prev) / dt) if dt > 0 else 0.0


def render_events_pane(cur: dict[str, NodeSample]) -> str:
    """Bottom pane (--events): the newest flight-recorder events across
    the polled nodes — degradation flips, slow commands, sync failures —
    newest last, so the eye lands on the most recent transition."""
    rows: list[tuple[int, str]] = []
    now_ns = time.time_ns()
    for node, s in cur.items():
        for ev in s.events:
            try:
                wall = int(ev.get("wall_ns", 0))
            except ValueError:
                wall = 0
            age = max(0.0, (now_ns - wall) / 1e9) if wall else -1.0
            detail = " ".join(
                f"{k}={v}"
                for k, v in ev.items()
                if k not in ("seq", "wall_ns", "kind", "trace")
            )
            kind = ev.get("kind", "?")
            age_s = f"{age:8.1f}s" if age >= 0 else "       -"
            rows.append(
                (wall, f"{age_s}  {node:<22} {kind:<18} {detail}")
            )
    rows.sort(key=lambda r: r[0])
    header = f"{'AGE':>9}  {'NODE':<22} {'EVENT':<18} DETAIL"
    return "\n".join(
        ["", "-- flight events " + "-" * 46, header]
        + [line for _, line in rows]
    )


def render_router_pane(
    prev: dict[str, NodeSample], cur: dict[str, NodeSample]
) -> str:
    """Request-plane pane: rendered whenever a polled address turns out
    to be a router (INFO role:router). CONNS/W/OPS-S-W read like the
    node table; HIT% is the interval cache hit rate, LEASE_W/S the herd
    the leases absorbed, INVAL_MS the newest invalidation frame's
    publish-to-apply lag (-1 = no feed attached)."""
    header = (
        f"{'ROUTER':<22} {'CONNS':>5} {'W':>3} {'OPS/S':>8} "
        f"{'OPS/S/W':>8} {'HIT%':>6} {'KEYS':>7} {'LEASE_W/S':>10} "
        f"{'INVAL_MS':>9} STATUS"
    )
    lines = ["", "-- request plane " + "-" * 46, header]
    for node, c in cur.items():
        if not c.ok:
            continue
        p = prev.get(node)
        dt = (c.unix - p.unix) if (p is not None and p.ok) else 0.0
        ops = _rate(c.total_commands, p.total_commands, dt) if dt else 0.0
        per_worker = 0.0
        if dt and c.worker_commands:
            per_worker = max(
                _rate(v, p.worker_commands.get(k, v), dt)
                for k, v in c.worker_commands.items()
            )
        hits = _rate(c.cache_hits, p.cache_hits, dt) if dt else 0.0
        misses = _rate(c.cache_misses, p.cache_misses, dt) if dt else 0.0
        hit_pct = (
            f"{100.0 * hits / (hits + misses):.1f}"
            if hits + misses > 0
            else "-"
        )
        lease_w = _rate(c.lease_waits, p.lease_waits, dt) if dt else 0.0
        inval = f"{c.inval_lag_ms:.1f}" if c.inval_lag_ms >= 0 else "-"
        w = str(c.io_threads) if c.io_threads else "-"
        lines.append(
            f"{node:<22} {c.active_connections:>5} {w:>3} {ops:>8.1f} "
            f"{per_worker:>8.1f} {hit_pct:>6} {c.cache_keys:>7} "
            f"{lease_w:>10.1f} {inval:>9} UP"
        )
    return "\n".join(lines)


def render_table(
    prev: dict[str, NodeSample], cur: dict[str, NodeSample]
) -> str:
    header = (
        f"{'NODE':<22} {'PART':>4} {'KEYS':>9} {'OPS/S':>8} {'SET/S':>8} "
        f"{'GET/S':>8} "
        f"{'P50_US':>7} {'SRV_MB/S':>9} {'SYNC_KB/S':>10} {'CONNS':>5} "
        f"{'W':>3} "
        f"{'OPS/S/W':>8} {'PEERS_UP':>9} "
        f"{'LAG_EV':>7} {'LAG_MS':>8} {'STALE':>6} {'VER':>5} "
        f"{'BKND':>5} {'READY':>8} {'STATE':>9} "
        f"{'SHED/S':>7} STATUS"
    )
    lines = [header, "-" * len(header)]
    for node in cur:
        c = cur[node]
        p = prev.get(node)
        if c.ok and c.is_router:
            continue  # routers render in their own pane
        if not c.ok:
            lines.append(f"{node:<22} {'-':>4} {'-':>9} {'-':>8} {'-':>8} "
                         f"{'-':>8} "
                         f"{'-':>7} {'-':>9} {'-':>10} {'-':>5} {'-':>3} "
                         f"{'-':>8} "
                         f"{'-':>9} "
                         f"{'-':>7} {'-':>8} {'-':>6} {'-':>5} {'-':>5} "
                         f"{'-':>8} {'-':>9} {'-':>7} "
                         f"DOWN ({c.error})")
            continue
        dt = (c.unix - p.unix) if (p is not None and p.ok) else 0.0
        ops = _rate(c.total_commands, p.total_commands, dt) if dt else 0.0
        sets = _rate(c.set_commands, p.set_commands, dt) if dt else 0.0
        gets = _rate(c.get_commands, p.get_commands, dt) if dt else 0.0
        sync_kb = (
            _rate(c.sync_bytes, p.sync_bytes, dt) / 1024.0 if dt else 0.0
        )
        # SRV MB/s = response bytes the io workers flushed (writev) — the
        # large-value serving throughput the zero-copy path exists for.
        srv_mb = (
            _rate(c.served_bytes, p.served_bytes, dt) / (1024.0 * 1024.0)
            if dt
            else 0.0
        )
        shed = _rate(c.shed_total, p.shed_total, dt) if dt else 0.0
        # Busiest io worker's command rate: the imbalance signal — one hot
        # worker with the rest idle reads very differently from an even
        # OPS/S / W split.
        per_worker = 0.0
        if dt and c.worker_commands:
            per_worker = max(
                _rate(v, p.worker_commands.get(k, v), dt)
                for k, v in c.worker_commands.items()
            )
        p50 = f"{c.latency_p50_us:.0f}" if c.latency_p50_us else "-"
        peers = (
            f"{c.peers_up}/{c.peers_total}" if c.peers_total else "-"
        )
        w = str(c.io_threads) if c.io_threads else "-"
        # STALE = worst device pump lag (ms); VER = engine-vs-served tree
        # version delta. "-" on nodes without a device mirror.
        stale = f"{c.pump_lag_ms}" if c.pump_lag_ms >= 0 else "-"
        ver = (
            f"{max(0, c.engine_version - c.tree_version)}"
            if c.tree_version >= 0 and c.engine_version >= 0
            else "-"
        )
        # BKND = degradation-ladder rung (sharded width / 1 / cpu=0 /
        # fallback=-1); "-" on nodes predating the ladder or without a
        # mirror.
        bknd = f"{c.backend_level}" if c.backend_level >= -1 else "-"
        # PART = the partition this replica serves ("-" unpartitioned).
        part = f"{c.partition}" if c.partition >= 0 else "-"
        lines.append(
            f"{node:<22} {part:>4} "
            f"{c.keys:>9} {ops:>8.1f} {sets:>8.1f} {gets:>8.1f} "
            f"{p50:>7} {srv_mb:>9.1f} {sync_kb:>10.1f} "
            f"{c.active_connections:>5} "
            f"{w:>3} {per_worker:>8.1f} "
            f"{peers:>9} {c.lag_events:>7} {c.lag_ms:>8.1f} "
            f"{stale:>6} {ver:>5} {bknd:>5} "
            f"{c.readiness:>8} {c.state:>9} {shed:>7.1f} UP"
        )
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="merklekv_tpu_torch top",
        description="live METRICS/STATS/PEERS dashboard over a node list",
    )
    p.add_argument(
        "--nodes",
        required=True,
        help="comma-separated host:port list to poll",
    )
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument(
        "--once",
        action="store_true",
        help="print one frame (two samples, interval apart) and exit",
    )
    p.add_argument("--timeout", type=float, default=2.0)
    p.add_argument(
        "--events",
        action="store_true",
        help="append a flight-recorder pane (newest black-box events "
        "across the nodes, via the FLIGHT verb)",
    )
    p.add_argument(
        "--events-n",
        type=int,
        default=8,
        help="events fetched per node for the --events pane",
    )
    args = p.parse_args(argv)
    nodes = [n.strip() for n in args.nodes.split(",") if n.strip()]
    if not nodes:
        print("no nodes given", file=sys.stderr)
        return 2

    events_n = max(1, args.events_n) if args.events else 0

    def take() -> dict[str, NodeSample]:
        return {
            n: sample_node(n, timeout=args.timeout, events_n=events_n)
            for n in nodes
        }

    prev = take()
    try:
        while True:
            time.sleep(max(0.05, args.interval))
            cur = take()
            frame = render_table(prev, cur)
            if any(s.ok and s.is_router for s in cur.values()):
                frame += render_router_pane(prev, cur)
            if args.events:
                frame += render_events_pane(cur)
            if args.once:
                print(frame, flush=True)
                return 0
            sys.stdout.write(_CLEAR + time.strftime("%H:%M:%S ")
                             + f"interval={args.interval:g}s\n" + frame + "\n")
            sys.stdout.flush()
            prev = cur
    except KeyboardInterrupt:
        return 0
