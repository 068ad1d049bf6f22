"""Flight recorder: the always-on ring of structured state transitions
(partial copy of ``merklekv_tpu/obs/flightrec.py:89-243``: ``FlightEvent``,
``FlightRecorder``, ``get_recorder`` and ``record``).

The degradation ladder and the serving mirror record their transitions here
(``device_degraded``, ``device_healed``, ``device_corruption``,
``device_fallback``, ``tree_staleness``), stamped with wall + monotonic
nanoseconds and a sequence number. Recording is one lock acquire + a deque
append — cheap enough to stay on always.

Left out until the node slice: the metric sampler, the CRC-framed spiller
and its reader, the fatal-signal handlers, ``FlightRecorder.dump`` (which
writes a spill), and the causal-trace id stamped into each event.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field

__all__ = ["FlightEvent", "FlightRecorder", "get_recorder", "record"]


@dataclass
class FlightEvent:
    """One recorded state transition."""

    seq: int
    wall_ns: int
    mono_ns: int
    kind: str
    fields: dict = field(default_factory=dict)

    def wire_row(self) -> str:
        """Space-separated ``k=v`` fields (the PEERS/TRACE table shape, so
        clients reuse their field-table parser). Free-text values are
        squeezed to single tokens."""
        parts = [
            f"seq={self.seq}",
            f"wall_ns={self.wall_ns}",
            f"kind={self.kind}",
        ]
        for k, v in self.fields.items():
            if k in ("seq", "wall_ns", "kind"):
                # A field legitimately named like a header key must not
                # shadow it in the client's k=v dict.
                k = f"f.{k}"
            # Squeeze ALL whitespace, not just spaces: an embedded newline
            # (a multi-line OSError message in a reason field) would split
            # the row and desync the client's field-table framing.
            sv = re.sub(r"\s+", "_", str(v))[:120]
            parts.append(f"{k}={sv}")
        return " ".join(parts)

    def to_json(self) -> dict:
        return {
            "t": "event",
            "seq": self.seq,
            "wall_ns": self.wall_ns,
            "mono_ns": self.mono_ns,
            "kind": self.kind,
            "f": self.fields,
        }


class FlightRecorder:
    """Process-wide bounded event ring (thread-safe).

    Always on: recording costs one lock + one deque append, and the ring
    bounds memory at ``capacity`` events regardless of rate.
    """

    def __init__(self, capacity: int = 2048) -> None:
        self._mu = threading.Lock()
        self._ring: deque[FlightEvent] = deque(maxlen=max(16, capacity))
        self._seq = 0
        self._dropped = 0

    def set_capacity(self, capacity: int) -> None:
        with self._mu:
            old = list(self._ring)
            self._ring = deque(old, maxlen=max(16, capacity))

    def record(self, kind: str, /, **fields) -> FlightEvent:
        """Append one event; never raises (a broken field repr drops the
        field, not the event — the recorder must not be able to kill the
        subsystem that called it). ``kind`` is positional-only so a field
        may legitimately be named ``kind`` too."""
        clean = {}
        for k, v in fields.items():
            try:
                if isinstance(v, (int, float, bool)):
                    clean[k] = v
                else:
                    clean[k] = str(v)
            except Exception:
                continue
        with self._mu:
            self._seq += 1
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            ev = FlightEvent(
                seq=self._seq,
                wall_ns=time.time_ns(),
                mono_ns=time.monotonic_ns(),
                kind=kind,
                fields=clean,
            )
            self._ring.append(ev)
        return ev

    def last(self, n: int = 0) -> list[FlightEvent]:
        """Newest ``n`` events (0 = all), oldest first."""
        with self._mu:
            evs = list(self._ring)
        return evs[-n:] if n > 0 else evs

    def dropped(self) -> int:
        with self._mu:
            return self._dropped

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()
            self._dropped = 0

    def wire_dump(self, n: int) -> str:
        """The FLIGHT verb's response: ``EVENTS <rows>`` then one ``k=v``
        row per event, NEWEST first, closed by ``END``."""
        evs = list(reversed(self.last(max(1, n))))
        body = "".join(ev.wire_row() + "\r\n" for ev in evs)
        return f"EVENTS {len(evs)}\r\n{body}END\r\n"


_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, /, **fields) -> None:
    """Module-level shorthand: record into the process-wide ring."""
    _recorder.record(kind, **fields)
