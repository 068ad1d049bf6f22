"""``python -m merklekv_tpu_torch blackbox`` — offline post-mortem analyzer.

A copy of ``merklekv_tpu/obs/blackbox.py`` over the port's
``obs/flightrec.py``. The spill format is the JAX package's, so either
package's analyzer reads either package's spills, with the same report.

Reads one or more flight spills (files, or directories containing
``flight.bin`` + crash markers), merges every node's events into ONE
causally-ordered cluster timeline, and flags anomalies — the offline
complement of the live ``top``/``trace`` surfaces:

- **ordering**: events merge by wall clock; events sharing a trace id
  (stamped while an anti-entropy/bootstrap trace context was active, or
  relayed through SLOWCMD during a traced serve) are additionally LINKED
  across nodes — clock skew can shuffle their absolute placement but
  never their attribution to the same causal cycle. Envelope ``hseq``
  high-water marks ride in the samples (``replication.lag_events.*``),
  so per-peer convergence state is readable at every sample tick.

- **anomalies**: degradation-ladder flips, storage full latches,
  peer-health flips, sync-cycle errors, slow-command bursts (>= 3 within
  10 s), skew-clamp bursts, admission-rejection bursts, device-tree
  staleness breaches (wedged update pump), device-backend ladder
  step-downs / fallback-serving heartbeats / scrub-caught corruption
  (with the environment|code classified kind), and lag spikes
  from the sampled ``replication.lag_events.*`` series.

- **fatal context**: ``fatal.txt`` crash markers (native signal stamps)
  and ``crash-<pid>.txt`` faulthandler tracebacks found beside a spill
  surface as synthetic timeline events, so "what killed it" and "what it
  was doing" read side by side.

Exit code 0 when every input parsed (truncated tails are reported, not
fatal — the atomic spill rewrite means a kill -9 leaves a COMPLETE file;
truncation only appears on fatal-path direct dumps or disk corruption);
1 when an input was unreadable or not a spill at all.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from merklekv_tpu_torch.obs.flightrec import (
    FlightEvent,
    FlightSpiller,
    SpillDoc,
    read_spill,
)

__all__ = ["collect_inputs", "load_docs", "merge_timeline", "find_anomalies",
           "main"]

# Anomaly windows/thresholds (documented in OBSERVABILITY.md).
SLOW_BURST_N = 3
SLOW_BURST_WINDOW_NS = 10 * 1_000_000_000
LAG_SPIKE_EVENTS = 100


@dataclass
class TimelineEntry:
    node: str
    event: FlightEvent


@dataclass
class Anomaly:
    wall_ns: int
    node: str
    kind: str
    detail: str


@dataclass
class Report:
    docs: list[SpillDoc] = field(default_factory=list)
    timeline: list[TimelineEntry] = field(default_factory=list)
    anomalies: list[Anomaly] = field(default_factory=list)
    trace_links: dict[str, list[str]] = field(default_factory=dict)
    errors: list[str] = field(default_factory=list)  # unreadable inputs


def collect_inputs(paths: list[str]) -> tuple[list[str], list[str]]:
    """Resolve CLI arguments into (spill files, crash-marker files). A
    directory contributes its ``flight.bin`` plus any ``fatal.txt`` /
    ``crash-*.txt`` markers; a file is taken as a spill directly."""
    spills: list[str] = []
    markers: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            cand = os.path.join(p, FlightSpiller.FILENAME)
            if os.path.exists(cand):
                spills.append(cand)
            for name in sorted(os.listdir(p)):
                if name == "fatal.txt" or (
                    name.startswith("crash-") and name.endswith(".txt")
                ):
                    markers.append(os.path.join(p, name))
        else:
            spills.append(p)
    return spills, markers


_MARKER_RE = re.compile(
    r"fatal signal (\d+) pid (\d+) wall_ns (\d+)"
)


def _marker_events(path: str) -> list[FlightEvent]:
    """Synthetic events from a crash-marker / faulthandler file."""
    out: list[FlightEvent] = []
    try:
        with open(path, errors="replace") as f:
            text = f.read()
    except OSError:
        return out
    for m in _MARKER_RE.finditer(text):
        out.append(
            FlightEvent(
                seq=0,
                wall_ns=int(m.group(3)),
                mono_ns=0,
                kind="fatal_signal",
                fields={"signal": int(m.group(1)), "pid": int(m.group(2)),
                        "file": os.path.basename(path)},
            )
        )
    if not out and "Current thread" in text:
        # A faulthandler traceback without a native marker: stamp it at
        # the file's mtime (best available clock).
        try:
            wall = int(os.path.getmtime(path) * 1e9)
        except OSError:
            wall = 0
        out.append(
            FlightEvent(
                seq=0, wall_ns=wall, mono_ns=0, kind="crash_traceback",
                fields={"file": os.path.basename(path)},
            )
        )
    return out


def load_docs(paths: list[str]) -> Report:
    report = Report()
    spills, markers = collect_inputs(paths)
    if not spills:
        report.errors.append("no spill files found in the given paths")
        return report
    for sp in spills:
        try:
            doc = read_spill(sp)
        except (OSError, ValueError) as e:
            report.errors.append(f"{sp}: {e}")
            continue
        report.docs.append(doc)
    # Attribute crash markers to the node whose spill shares their
    # directory (every node's markers live beside its flight.bin) — the
    # directory basename is just "flight" for everyone and would collapse
    # all nodes' fatal events onto one bogus name.
    node_by_dir = {
        os.path.dirname(os.path.abspath(doc.path)): doc.node
        for doc in report.docs
    }
    marker_entries: list[TimelineEntry] = []
    for mp in markers:
        mdir = os.path.dirname(os.path.abspath(mp))
        node = node_by_dir.get(
            mdir, os.path.basename(os.path.dirname(mp)) or mp
        )
        for ev in _marker_events(mp):
            marker_entries.append(TimelineEntry(node=node, event=ev))
    report.timeline = merge_timeline(report.docs, marker_entries)
    report.anomalies = find_anomalies(report.docs, report.timeline)
    report.trace_links = link_traces(report.timeline)
    return report


def merge_timeline(
    docs: list[SpillDoc],
    extra: Optional[list[TimelineEntry]] = None,
) -> list[TimelineEntry]:
    """All nodes' events merged into one timeline.

    K-way merge of per-node streams: each node's events are first put in
    SEQUENCE order (the ring's own total order), then streams interleave
    by wall clock — so cross-node placement follows the clocks, but a
    node whose wall clock stepped backwards mid-run (NTP correction) can
    never have its own events reordered on the merged view
    (storage_recovered can't print before its storage_full).

    Two spills of the SAME process ring (co-located nodes sharing one
    process share the process-wide recorder) are deduplicated by full
    event identity (pid, seq, wall_ns, mono_ns, kind): the first doc's
    attribution wins and the analyzer reports each event once instead of
    double-counting every anomaly. Distinct rings — even in one process —
    never collide on wall+mono nanosecond stamps."""
    import heapq

    streams: list[tuple[str, list[TimelineEntry]]] = []
    seen_ring: set[tuple] = set()
    for doc in docs:
        pid = int(doc.meta.get("pid", 0) or 0)
        evs = sorted(doc.events, key=lambda ev: ev.seq)
        kept = []
        for ev in evs:
            if pid and ev.seq:
                key = (pid, ev.seq, ev.wall_ns, ev.mono_ns, ev.kind)
                if key in seen_ring:
                    continue  # same process ring spilled twice
                seen_ring.add(key)
            kept.append(TimelineEntry(node=doc.node, event=ev))
        if kept:
            streams.append((doc.node, kept))
    for e in extra or []:
        streams.append((e.node, [e]))
    heap = []
    for si, (node, evs) in enumerate(streams):
        heapq.heappush(heap, (evs[0].event.wall_ns, node, si, 0))
    out: list[TimelineEntry] = []
    while heap:
        _, _, si, i = heapq.heappop(heap)
        evs = streams[si][1]
        out.append(evs[i])
        if i + 1 < len(evs):
            heapq.heappush(
                heap, (evs[i + 1].event.wall_ns, streams[si][0], si, i + 1)
            )
    return out


def link_traces(timeline: list[TimelineEntry]) -> dict[str, list[str]]:
    """trace id -> nodes that recorded events under it. Links spanning
    >= 2 nodes are the cross-node causal joins (one sync cycle's initiator
    and donors, one bootstrap's joiner and donor)."""
    seen: dict[str, list[str]] = {}
    for e in timeline:
        tid = str(e.event.fields.get("trace", "") or "")
        if not tid:
            continue
        nodes = seen.setdefault(tid, [])
        if e.node not in nodes:
            nodes.append(e.node)
    return {t: ns for t, ns in seen.items() if len(ns) >= 2}


def find_anomalies(
    docs: list[SpillDoc], timeline: list[TimelineEntry]
) -> list[Anomaly]:
    out: list[Anomaly] = []

    def add(e: TimelineEntry, kind: str, detail: str) -> None:
        out.append(
            Anomaly(wall_ns=e.event.wall_ns, node=e.node, kind=kind,
                    detail=detail)
        )

    slow_recent: dict[str, list[int]] = {}
    burst_flagged: dict[str, int] = {}
    for e in timeline:
        ev = e.event
        f = ev.fields
        if ev.kind == "degradation" and str(f.get("new")) != "live":
            add(e, "degradation",
                f"{f.get('prev')} -> {f.get('new')} ({f.get('reason')})")
        elif ev.kind == "storage_full":
            add(e, "storage_full", str(f.get("reason", "")))
        elif ev.kind == "peer_health" and str(f.get("new")) in (
            "down", "degraded"
        ):
            add(e, "peer_flip", f"{f.get('peer')} -> {f.get('new')}")
        elif ev.kind == "sync_cycle" and str(f.get("outcome")) in (
            "error", "degraded"
        ):
            add(e, "sync_failure",
                f"cycle {f.get('cycle')} outcome={f.get('outcome')}")
        elif ev.kind == "skew_clamp":
            add(e, "skew_clamp",
                f"{f.get('count')} events from {f.get('srcs')}")
        elif ev.kind == "tree_staleness":
            # The device-update pump breached its [device] max_staleness
            # contract (or stalled outright) — a wedged device queue.
            add(e, "tree_staleness",
                f"pump lag {f.get('lag_ms')}ms / "
                f"{f.get('lag_versions')} versions "
                f"(window {f.get('window_ms')}ms)")
        elif ev.kind == "device_degraded":
            # The device degradation ladder stepped down a rung; the
            # classified kind says whether it was backend weather
            # (environment) or a code failure that should page.
            add(e, "device_degraded",
                f"rung {f.get('from_rung')} -> {f.get('to_rung')} "
                f"({f.get('kind')} @ {f.get('where')})")
        elif ev.kind == "device_fallback":
            # Heartbeat (one per 10s window): a previously ready mirror is
            # serving off the NATIVE fallback — invalidated and not yet
            # re-warmed. Visible here so fallback serving is never silent.
            add(e, "device_fallback",
                f"serving native fallback (ladder rung {f.get('rung')})")
        elif ev.kind == "device_corruption":
            # The integrity scrub caught the served device tree diverging
            # from the engine — silent corruption; invalidate+rebuild was
            # triggered.
            add(e, "device_corruption",
                f"scrub mismatch at leaf {f.get('leaf_index')} "
                f"(rung {f.get('rung')})")
        elif ev.kind == "partition_degraded":
            # One partition's replica left live (partitioned cluster
            # mode): the partition-scope summary below folds these across
            # nodes to tell a partition-local incident (one replica
            # group) from a cluster-wide one (every partition at once).
            add(e, "partition_degraded",
                f"partition {f.get('partition')} -> {f.get('level')} "
                f"({f.get('reason')})")
        elif ev.kind == "partition_healed":
            add(e, "partition_healed",
                f"partition {f.get('partition')} back to live")
        elif ev.kind in ("admission_reject", "pipeline_reject",
                         "events_dropped"):
            add(e, "rejection_burst", f"{ev.kind} +{f.get('count')}")
        elif ev.kind == "fatal_signal":
            add(e, "fatal_signal",
                f"signal {f.get('signal')} pid {f.get('pid')}")
        elif ev.kind == "watchdog-timeout" or (
            ev.kind == "multichip_phase"
            and str(f.get("phase")) == "watchdog-timeout"
        ):
            add(e, "watchdog", str(f.get("stuck_in", "")))
        elif (
            ev.kind == "multichip_phase"
            and str(f.get("phase")) in ("device-count", "device-enumerate")
            and str(f.get("have", "")).isdigit()
            and str(f.get("want", "")).isdigit()
            and int(f["have"]) < int(f["want"])
        ):
            # Device-complement shortfall (MULTICHIP_r01's failure mode):
            # surfaced as ENVIRONMENT weather so triage reads the cause
            # directly instead of treating the round as a code regression
            # (the probe's JSON record carries the matching error_kind).
            add(e, "environment",
                f"device shortfall: have {f['have']}, want {f['want']}")
        elif ev.kind == "slow_command":
            win = slow_recent.setdefault(e.node, [])
            win.append(ev.wall_ns)
            while win and ev.wall_ns - win[0] > SLOW_BURST_WINDOW_NS:
                win.pop(0)
            if (
                len(win) >= SLOW_BURST_N
                and ev.wall_ns - burst_flagged.get(e.node, -(1 << 62))
                > SLOW_BURST_WINDOW_NS
            ):
                burst_flagged[e.node] = ev.wall_ns
                add(e, "slow_burst",
                    f"{len(win)} slow commands within 10s "
                    f"(latest {f.get('verb')} {f.get('dur_us')}us)")
    # Lag spikes from the sampled time series: any replication.lag_events.*
    # value crossing the spike threshold at a sample tick.
    for doc in docs:
        spiked: set[str] = set()
        for s in doc.samples:
            for name, v in s.values.items():
                if not name.startswith("replication.lag_events."):
                    continue
                try:
                    lag = int(v)
                except (TypeError, ValueError):
                    continue
                if lag >= LAG_SPIKE_EVENTS and name not in spiked:
                    spiked.add(name)
                    out.append(
                        Anomaly(
                            wall_ns=s.wall_ns,
                            node=doc.node,
                            kind="lag_spike",
                            detail=f"{name.rsplit('.', 1)[-1]}: "
                                   f"{lag} events behind",
                        )
                    )
    out.sort(key=lambda a: a.wall_ns)
    return out


# Anomaly kinds that count toward partition-incident scoping: the ones a
# sick replica produces about ITSELF (a peer_flip is the observer's view
# of someone else's failure and would smear the blame across partitions).
_PARTITION_SCOPED_KINDS = (
    "degradation",
    "partition_degraded",
    "storage_full",
    "fatal_signal",
    "rejection_burst",
)


def partition_incident_scope(report: Report) -> Optional[str]:
    """One-line verdict: is this incident partition-local or cluster-wide?

    Nodes advertise their partition on node_start/map_change flight
    events; anomalies a replica raised about itself fold by that
    partition. One affected partition = a partition-local incident (the
    containment story working); most/all partitions at once = a
    cluster-wide cause (deploy, fabric, shared disk). None when no spill
    names a partition (unpartitioned deployment)."""
    node_part: dict[str, int] = {}
    for doc in report.docs:
        for ev in doc.events:
            if ev.kind in ("node_start", "map_change"):
                p = ev.fields.get("partition")
                if p is not None and str(p).lstrip("-").isdigit():
                    node_part[doc.node] = int(p)
    if not node_part:
        return None
    known = sorted(set(node_part.values()))
    hit = sorted(
        {
            node_part[a.node]
            for a in report.anomalies
            if a.kind in _PARTITION_SCOPED_KINDS and a.node in node_part
        }
    )
    if not hit:
        return (
            f"partitions {known}: no replica-local anomalies "
            "(healthy or observer-only flips)"
        )
    if len(hit) == 1:
        return (
            f"PARTITION-LOCAL incident: partition {hit[0]} only "
            f"(of {known}) — containment held"
        )
    if len(hit) >= max(2, len(known)):
        return (
            f"CLUSTER-WIDE incident: every observed partition affected "
            f"({hit}) — look for a shared cause"
        )
    return f"multi-partition incident: partitions {hit} of {known}"


def _fmt_wall(wall_ns: int) -> str:
    if wall_ns <= 0:
        return "????-??-?? ??:??:??.???"
    t = wall_ns / 1e9
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t)) + (
        ".%03d" % (int(wall_ns // 1_000_000) % 1000)
    )


def render_text(report: Report, limit: int = 0) -> str:
    lines: list[str] = []
    for doc in report.docs:
        w = doc.meta.get("written_wall_ns", 0)
        lines.append(
            f"spill {doc.path}: node={doc.node} events={len(doc.events)} "
            f"samples={len(doc.samples)} written={_fmt_wall(int(w or 0))}"
            + (f" TRUNCATED ({doc.error})" if doc.truncated else "")
        )
    for err in report.errors:
        lines.append(f"unreadable: {err}")
    lines.append("")
    lines.append(f"== merged timeline ({len(report.timeline)} events) ==")
    shown = report.timeline[-limit:] if limit > 0 else report.timeline
    if limit > 0 and len(report.timeline) > limit:
        lines.append(f"... ({len(report.timeline) - limit} earlier events "
                     f"omitted; --limit 0 for all)")
    for e in shown:
        ev = e.event
        fields = " ".join(
            f"{k}={v}" for k, v in ev.fields.items() if k != "trace"
        )
        trace = ev.fields.get("trace")
        lines.append(
            f"{_fmt_wall(ev.wall_ns)} [{e.node}] {ev.kind}"
            + (f" {fields}" if fields else "")
            + (f" trace={trace}" if trace else "")
        )
    lines.append("")
    if report.trace_links:
        lines.append(f"== cross-node trace links ({len(report.trace_links)}) ==")
        for tid, nodes in sorted(report.trace_links.items()):
            lines.append(f"trace {tid}: {' <-> '.join(nodes)}")
        lines.append("")
    lines.append(f"== anomalies ({len(report.anomalies)}) ==")
    for a in report.anomalies:
        lines.append(
            f"{_fmt_wall(a.wall_ns)} [{a.node}] {a.kind}: {a.detail}"
        )
    if not report.anomalies:
        lines.append("(none)")
    scope = partition_incident_scope(report)
    if scope is not None:
        lines.append("")
        lines.append("== partition scope ==")
        lines.append(scope)
    return "\n".join(lines)


def render_json(report: Report) -> str:
    return json.dumps(
        {
            "spills": [
                {
                    "path": d.path,
                    "node": d.node,
                    "events": len(d.events),
                    "samples": len(d.samples),
                    "truncated": d.truncated,
                    "error": d.error,
                }
                for d in report.docs
            ],
            "errors": report.errors,
            "timeline": [
                {
                    "wall_ns": e.event.wall_ns,
                    "node": e.node,
                    "seq": e.event.seq,
                    "kind": e.event.kind,
                    "fields": e.event.fields,
                }
                for e in report.timeline
            ],
            "trace_links": report.trace_links,
            "partition_scope": partition_incident_scope(report),
            "anomalies": [
                {
                    "wall_ns": a.wall_ns,
                    "node": a.node,
                    "kind": a.kind,
                    "detail": a.detail,
                }
                for a in report.anomalies
            ],
        },
        indent=None,
        separators=(",", ":"),
    )


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="merklekv_tpu_torch blackbox",
        description="merge flight-recorder spills from one or more nodes "
        "into a causally-ordered cluster timeline and flag anomalies",
    )
    p.add_argument(
        "paths", nargs="+",
        help="spill files, or node flight directories (flight.bin + crash "
        "markers)",
    )
    p.add_argument("--json", action="store_true", help="machine-readable")
    p.add_argument(
        "--limit", type=int, default=200,
        help="newest timeline events to print (0 = all; text mode only)",
    )
    args = p.parse_args(argv)
    report = load_docs(args.paths)
    if args.json:
        print(render_json(report))
    else:
        print(render_text(report, limit=args.limit))
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
