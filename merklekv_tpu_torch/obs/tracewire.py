"""Cluster-wide causal tracing: context propagation + span collection.

A copy of ``merklekv_tpu/obs/tracewire.py``, its imports pointed at the port's modules.

The TRACE verb summarizes a sync cycle per peer, but every span stops at
the process boundary: the initiator's walk spans and the donor's serve
spans cannot be stitched together. This module is the Dapper-style answer
(PAPERS.md) adapted to the text protocol:

- a **trace context** ``(trace_id, span_id, flags)`` travels as one compact
  trailing token ``tc=<trace16>-<span16>-<flags2>`` on the cluster verbs
  (TREELEVEL / HASHPAGE / SNAPMETA / SNAPCHUNK) and as a ``tc`` field on
  the replication batch envelope;
- every node keeps a process-wide **SpanCollector** ring: the initiator's
  ``span()`` sites record into it whenever a trace is active (each span
  allocates a fresh span id and parents to the enclosing one), and the
  native server relays traced serves as TRACESPAN notifications so the
  donor's side of a request lands in *its* collector under the *same*
  trace id;
- the ``TRACEDUMP`` verb dumps raw spans; :func:`chrome_trace_events`
  assembles dumps from several nodes into one Chrome trace-event JSON
  (load in Perfetto / chrome://tracing), flagging orphans — a span whose
  parent never arrived (dropped/truncated by a hostile link) is marked
  ``orphan`` and parented to nothing rather than mis-parented.

Clock caveat (the classic Dapper one): donor spans are placed on the
timeline by the donor's wall clock; cross-host skew shifts them visually
but never corrupts parent/child attribution, which rides on ids alone.
"""

from __future__ import annotations

import contextvars
import os
import struct
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Optional

__all__ = [
    "TraceContext",
    "SpanRecord",
    "SpanCollector",
    "get_collector",
    "new_context",
    "parse_token",
    "trace_scope",
    "current",
    "current_token",
    "chrome_trace_events",
    "stitch",
]

FLAG_SAMPLED = 0x01


def _new_id() -> int:
    """Random non-zero 64-bit id (os.urandom: no shared-seed collisions
    across forked test processes)."""
    while True:
        (v,) = struct.unpack("<Q", os.urandom(8))
        if v:
            return v


@dataclass(frozen=True)
class TraceContext:
    """One hop of a causal trace: the trace's id plus the CURRENT span id
    (the parent any child span or outbound request stitches under)."""

    trace_id: int
    span_id: int
    flags: int = FLAG_SAMPLED

    def token(self) -> str:
        return f"tc={self.trace_id:016x}-{self.span_id:016x}-{self.flags:02x}"

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _new_id(), self.flags)


def new_context() -> TraceContext:
    """Fresh trace root. The root's span id IS the trace id — the root is
    a context, not a recorded span, and assembly treats a parent equal to
    the trace id as "child of the root", never as an orphan."""
    tid = _new_id()
    return TraceContext(tid, tid)


# Propagation master switch (config: [observability] trace_propagation).
# Off: cycles allocate no context, clients send no tokens, span() records
# nothing into the collector — the PR-4 surface exactly.
_propagation = True


def set_propagation(on: bool) -> None:
    global _propagation
    _propagation = bool(on)


def propagation_enabled() -> bool:
    return _propagation


def parse_token(tok: str) -> Optional[TraceContext]:
    """Strictly parse a ``tc=`` wire token; None for anything malformed
    (a corrupted token must drop the span, never corrupt stitching)."""
    if (
        len(tok) != 39
        or not tok.startswith("tc=")
        or tok[19] != "-"
        or tok[36] != "-"
    ):
        return None
    try:
        trace_id = int(tok[3:19], 16)
        span_id = int(tok[20:36], 16)
        flags = int(tok[37:39], 16)
    except ValueError:
        return None
    if trace_id == 0 or span_id == 0:
        return None
    return TraceContext(trace_id, span_id, flags)


# ------------------------------------------------------------- propagation

_current: contextvars.ContextVar[Optional[TraceContext]] = (
    contextvars.ContextVar("mkv_trace_ctx", default=None)
)


def current() -> Optional[TraceContext]:
    return _current.get()


def current_token() -> Optional[str]:
    ctx = _current.get()
    return ctx.token() if ctx is not None else None


class trace_scope:
    """Install ``ctx`` as the thread's active trace for the block. span()
    sites inside record into the collector; clients with a trace provider
    stamp outbound cluster verbs with the active token."""

    def __init__(self, ctx: TraceContext) -> None:
        self._ctx = ctx
        self._token = None

    @property
    def ctx(self) -> TraceContext:
        """The scope's context, readable before/after the block — callers
        that summarize AFTER __exit__ (the sync cycle's finally) take the
        trace id from here rather than the already-reset contextvar."""
        return self._ctx

    def __enter__(self) -> TraceContext:
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _current.reset(self._token)


def begin_span() -> Optional[tuple]:
    """span() entry hook: when a trace is active, allocate a child context
    and install it (nested spans and outbound requests parent to it).
    Returns opaque state for :func:`end_span`, or None (untraced)."""
    cur = _current.get()
    if cur is None:
        return None
    child = cur.child()
    reset = _current.set(child)
    return (cur, child, reset, time.time_ns())


def end_span(
    state: tuple,
    name: str,
    dur_ns: int,
    error: Optional[str] = None,
    cycle: int = 0,
) -> None:
    """span() exit hook: restore the parent context and record the span."""
    cur, child, reset, ts_ns = state
    _current.reset(reset)
    get_collector().record(
        trace_id=child.trace_id,
        span_id=child.span_id,
        parent_id=cur.span_id,
        name=name,
        role="initiator",
        ts_ns=ts_ns,
        dur_ns=dur_ns,
        cycle=cycle,
        error=error or "",
    )


# --------------------------------------------------------------- collector

@dataclass
class SpanRecord:
    trace_id: int
    span_id: int
    parent_id: int  # 0 = root (no parent)
    name: str
    role: str  # "initiator" | "donor" | "applier"
    ts_ns: int  # wall-clock start (unix ns, recorder's clock)
    dur_ns: int
    node: str = ""  # "host:port" when known, "" = this process
    cycle: int = 0  # anti-entropy cycle id when one was active
    error: str = ""


class SpanCollector:
    """Bounded FIFO of finished spans (thread-safe). One per process —
    multi-node-per-process tests share it, so spans carry a ``node`` tag
    where the recorder knows it."""

    def __init__(self, capacity: int = 8192) -> None:
        self._mu = threading.Lock()
        self._capacity = capacity
        self._spans: list[SpanRecord] = []

    def set_capacity(self, capacity: int) -> None:
        with self._mu:
            self._capacity = max(16, capacity)
            if len(self._spans) > self._capacity:
                del self._spans[: len(self._spans) - self._capacity]

    def record(
        self,
        trace_id: int,
        span_id: int,
        parent_id: int,
        name: str,
        role: str,
        ts_ns: int,
        dur_ns: int,
        node: str = "",
        cycle: int = 0,
        error: str = "",
    ) -> None:
        rec = SpanRecord(
            trace_id=trace_id,
            span_id=span_id,
            parent_id=parent_id,
            name=name,
            role=role,
            ts_ns=ts_ns,
            dur_ns=dur_ns,
            node=node,
            cycle=cycle,
            error=error,
        )
        with self._mu:
            self._spans.append(rec)
            if len(self._spans) > self._capacity:
                del self._spans[: len(self._spans) - self._capacity]

    def spans(self, n: int = 0) -> list[SpanRecord]:
        """Newest ``n`` spans (0 = all), oldest first."""
        with self._mu:
            if n <= 0:
                return list(self._spans)
            return list(self._spans[-n:])

    def __len__(self) -> int:
        with self._mu:
            return len(self._spans)

    def clear(self) -> None:
        with self._mu:
            self._spans.clear()

    def wire_dump(self, n: int = 0) -> str:
        """The TRACEDUMP response: ``SPANS <count>`` then one
        space-separated ``k=v`` row per span, closed by ``END`` (the
        PEERS/TRACE table shape, so clients reuse their field-table
        parser). Span names never contain spaces; error text is squeezed."""
        rows = []
        for s in self.spans(n):
            row = (
                f"trace={s.trace_id:016x} span={s.span_id:016x} "
                f"parent={s.parent_id:016x} name={s.name} role={s.role} "
                f"ts_ns={s.ts_ns} dur_ns={s.dur_ns} "
                f"node={s.node or '-'} cycle={s.cycle}"
            )
            if s.error:
                row += f" error={s.error.replace(' ', '_')[:80]}"
            rows.append(row)
        body = "".join(r + "\r\n" for r in rows)
        return f"SPANS {len(rows)}\r\n{body}END\r\n"


_collector = SpanCollector()


def get_collector() -> SpanCollector:
    return _collector


# --------------------------------------------------------------- assembly

def _parse_row(row: dict, default_node: str) -> Optional[SpanRecord]:
    """One TRACEDUMP k=v row -> SpanRecord; None for malformed rows (a
    truncation fault mid-dump must drop the row, never abort assembly)."""
    try:
        return SpanRecord(
            trace_id=int(row["trace"], 16),
            span_id=int(row["span"], 16),
            parent_id=int(row["parent"], 16),
            name=row["name"],
            role=row.get("role", "initiator"),
            ts_ns=int(row["ts_ns"]),
            dur_ns=int(row["dur_ns"]),
            node=(
                row.get("node", "-")
                if row.get("node", "-") != "-"
                else default_node
            ),
            cycle=int(row.get("cycle", 0)),
            error=row.get("error", ""),
        )
    except (KeyError, ValueError):
        return None


def stitch(
    dumps: Iterable[tuple[str, list[dict]]],
) -> dict[int, list[SpanRecord]]:
    """Merge TRACEDUMP row tables from several nodes into
    ``{trace_id: [spans]}``. ``dumps`` is ``(node_name, rows)`` pairs; a
    row without its own node tag inherits the dump's node name. Duplicate
    (trace, span) pairs — the same node dumped twice — keep the first."""
    out: dict[int, list[SpanRecord]] = {}
    seen: set[tuple[int, int]] = set()
    for node, rows in dumps:
        for row in rows:
            rec = _parse_row(row, node)
            if rec is None:
                continue
            key = (rec.trace_id, rec.span_id)
            if key in seen:
                continue
            seen.add(key)
            out.setdefault(rec.trace_id, []).append(rec)
    for spans in out.values():
        spans.sort(key=lambda s: s.ts_ns)
    return out


def orphan_spans(spans: list[SpanRecord]) -> set[int]:
    """Span ids within one trace whose parent span never arrived (dropped
    frame, truncated dump, dead peer). They are FLAGGED — rendered at the
    trace root with an ``orphan`` arg — never re-parented under a guess."""
    ids = {s.span_id for s in spans}
    return {
        s.span_id
        for s in spans
        if s.parent_id != 0
        and s.parent_id != s.trace_id  # child of the trace root
        and s.parent_id not in ids
    }


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m merklekv_tpu_torch trace --nodes a:port,b:port [--cycles N]``:
    pull TRACEDUMP from every node, stitch spans by trace id, and write
    one Perfetto-loadable Chrome trace-event JSON (stdout or ``--out``)."""
    import argparse
    import json
    import sys

    from merklekv_tpu_torch.client import MerkleKVClient, MerkleKVError

    p = argparse.ArgumentParser(
        prog="merklekv_tpu_torch trace",
        description="assemble cross-node causal traces into Chrome "
        "trace-event JSON (load in Perfetto / chrome://tracing)",
    )
    p.add_argument(
        "--nodes", required=True,
        help="comma-separated host:port list to pull TRACEDUMP from",
    )
    p.add_argument(
        "--cycles", type=int, default=0,
        help="keep only the newest N traces (anti-entropy cycles); "
        "0 = all",
    )
    p.add_argument("--out", help="write JSON here instead of stdout")
    p.add_argument("--timeout", type=float, default=5.0)
    args = p.parse_args(argv)

    dumps: list[tuple[str, list[dict]]] = []
    for node in [n.strip() for n in args.nodes.split(",") if n.strip()]:
        host, _, port = node.rpartition(":")
        try:
            with MerkleKVClient(host, int(port), timeout=args.timeout) as c:
                dumps.append((node, c.trace_dump(0)))
        except (MerkleKVError, OSError, ValueError) as e:
            print(f"# {node}: dump failed ({e})", file=sys.stderr)
    traces = stitch(dumps)
    if args.cycles > 0 and len(traces) > args.cycles:
        newest = sorted(
            traces, key=lambda t: max(s.ts_ns for s in traces[t])
        )[-args.cycles:]
        traces = {t: traces[t] for t in newest}
    doc = chrome_trace_events(traces)
    payload = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        n_spans = sum(len(s) for s in traces.values())
        print(f"wrote {args.out}: {len(traces)} traces, {n_spans} spans")
    else:
        print(payload)
    return 0


def chrome_trace_events(
    traces: dict[int, list[SpanRecord]],
) -> dict:
    """Chrome trace-event JSON (Perfetto / chrome://tracing loadable).

    Layout: one pid per node (process_name metadata carries the node
    address), complete ("X") events in microseconds; parent/child nesting
    is carried by the ``parent`` arg (ids, not timestamps — skewed donor
    clocks shift placement, not attribution). Orphans get
    ``args.orphan = true``."""
    events: list[dict] = []
    pids: dict[str, int] = {}

    def pid_for(node: str) -> int:
        name = node or "local"
        if name not in pids:
            pids[name] = len(pids) + 1
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pids[name],
                    "tid": 0,
                    "args": {"name": name},
                }
            )
        return pids[name]

    for trace_id, spans in traces.items():
        orphans = orphan_spans(spans)
        for s in spans:
            args = {
                "trace_id": f"{trace_id:016x}",
                "span_id": f"{s.span_id:016x}",
                "parent": f"{s.parent_id:016x}" if s.parent_id else "",
                "role": s.role,
            }
            if s.cycle:
                args["cycle"] = s.cycle
            if s.error:
                args["error"] = s.error
            if s.span_id in orphans:
                args["orphan"] = True
            events.append(
                {
                    "name": s.name,
                    "cat": s.role,
                    "ph": "X",
                    "ts": s.ts_ns / 1e3,
                    "dur": max(s.dur_ns, 1) / 1e3,
                    "pid": pid_for(s.node),
                    "tid": 1,
                    "args": args,
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
