"""Correlated sync traces: cycle ids + a per-cycle ring buffer.

A copy of ``merklekv_tpu/obs/trace.py``, its imports pointed at the port's modules.

Every anti-entropy cycle (pairwise or multi-peer) allocates a process-wide
monotonic **cycle id** and installs it in a contextvar for its duration —
``utils.tracing.span()`` stamps the id into every span record emitted on
that thread, so a cycle's walk / repair / journaling spans correlate in the
log stream without threading an argument through every call.

The cycle's outcome is summarized into a ``CycleTrace`` (one ``PeerTrace``
per peer: wire bytes, walk rounds, repairs, outcome) and appended to a
bounded ring buffer; the ``TRACE <n>`` wire verb dumps the newest ``n``
cycles — the per-peer sync attribution first proved out with ad-hoc byte
counters, now always on and queryable.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "PeerTrace",
    "CycleTrace",
    "SyncTraceBuffer",
    "get_trace_buffer",
    "next_cycle_id",
    "current_cycle_id",
    "cycle_scope",
]

_cycle_counter = itertools.count(1)
_current_cycle: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "mkv_sync_cycle", default=None
)


def next_cycle_id() -> int:
    return next(_cycle_counter)


def current_cycle_id() -> Optional[int]:
    return _current_cycle.get()


class cycle_scope:
    """Context manager installing ``cycle_id`` as the thread's current
    cycle (spans emitted inside stamp it)."""

    def __init__(self, cycle_id: int) -> None:
        self._id = cycle_id
        self._token = None

    def __enter__(self) -> int:
        self._token = _current_cycle.set(self._id)
        return self._id

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _current_cycle.reset(self._token)


@dataclass
class PeerTrace:
    peer: str  # "host:port"
    mode: str = ""  # transfer strategy ("noop"/"bisect"/"hash-paged"/...)
    outcome: str = "ok"  # "ok" | "noop" | "degraded" | "error" | "skipped"
    bytes_sent: int = 0
    bytes_received: int = 0
    rounds: int = 0
    divergent: int = 0
    repairs: int = 0  # keys set + deleted against this peer's state
    error: str = ""


@dataclass
class CycleTrace:
    cycle_id: int
    kind: str  # "pairwise" | "multi"
    started_unix: float = field(default_factory=time.time)
    seconds: float = 0.0
    peers: list[PeerTrace] = field(default_factory=list)
    # Causal trace id of the cycle (0 = untraced). Carried explicitly
    # because the summary is appended AFTER the cycle's trace scope has
    # exited — the flight recorder stamps it so a donor's traced serves
    # and the initiator's sync_cycle event join across nodes' spills.
    trace_id: int = 0


class SyncTraceBuffer:
    """Bounded FIFO of the newest CycleTraces (thread-safe)."""

    def __init__(self, capacity: int = 128) -> None:
        self._mu = threading.Lock()
        self._capacity = capacity
        self._cycles: list[CycleTrace] = []

    def set_capacity(self, capacity: int) -> None:
        with self._mu:
            self._capacity = max(1, capacity)
            if len(self._cycles) > self._capacity:
                del self._cycles[: len(self._cycles) - self._capacity]

    def append(self, cycle: CycleTrace) -> None:
        with self._mu:
            self._cycles.append(cycle)
            if len(self._cycles) > self._capacity:
                del self._cycles[: len(self._cycles) - self._capacity]
        # Flight recorder: every anti-entropy cycle outcome lands on the
        # black-box timeline (the worst peer outcome is the headline; the
        # TRACE ring keeps the full per-peer detail).
        try:
            from merklekv_tpu_torch.obs.flightrec import record

            rank = {"error": 4, "degraded": 3, "skipped": 2, "ok": 1,
                    "noop": 0}
            worst = max(
                (p.outcome for p in cycle.peers),
                key=lambda o: rank.get(o, 0),
                default="noop",
            )
            fields = dict(
                cycle=cycle.cycle_id,
                mode=cycle.kind,
                peers=len(cycle.peers),
                outcome=worst,
                repairs=sum(p.repairs for p in cycle.peers),
                seconds=round(cycle.seconds, 4),
            )
            if cycle.trace_id:
                fields["trace"] = f"{cycle.trace_id:016x}"
            record("sync_cycle", **fields)
        except Exception:
            pass  # the trace ring must never fail on recorder trouble

    def last(self, n: int) -> list[CycleTrace]:
        """Newest ``n`` cycles, newest first."""
        with self._mu:
            return list(reversed(self._cycles[-max(0, n):]))

    def __len__(self) -> int:
        with self._mu:
            return len(self._cycles)

    def clear(self) -> None:
        with self._mu:
            self._cycles.clear()

    def wire_dump(self, n: int) -> str:
        """The TRACE verb's response: ``TRACES <rows>`` then one
        space-separated ``k=v`` line per (cycle, peer), newest cycle first,
        closed by ``END`` (the PEERS/CLIENT LIST table shape, so clients
        reuse their field-table parser)."""
        now = time.time()
        rows: list[str] = []
        for cyc in self.last(n):
            for p in cyc.peers:
                rows.append(
                    f"cycle={cyc.cycle_id} kind={cyc.kind} peer={p.peer} "
                    f"mode={p.mode or '-'} outcome={p.outcome} "
                    f"bytes_sent={p.bytes_sent} "
                    f"bytes_received={p.bytes_received} rounds={p.rounds} "
                    f"divergent={p.divergent} repairs={p.repairs} "
                    f"seconds={cyc.seconds:.6f} "
                    f"age_s={max(0.0, now - cyc.started_unix):.1f}"
                    + (
                        f" error={p.error.replace(' ', '_')[:80]}"
                        if p.error
                        else ""
                    )
                )
        body = "".join(r + "\r\n" for r in rows)
        return f"TRACES {len(rows)}\r\n{body}END\r\n"


_buffer = SyncTraceBuffer()


def get_trace_buffer() -> SyncTraceBuffer:
    return _buffer
