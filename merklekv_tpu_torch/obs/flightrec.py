"""Flight recorder: the always-on black box behind post-mortem forensics.

A copy of ``merklekv_tpu/obs/flightrec.py``, its imports pointed at the port's modules.

The live observability plane (metrics, traces, lag SLO) answers "what is
the node doing NOW"; this module answers "what was the node doing in the
seconds before it died" — the Dapper lesson that always-on, low-overhead
recording is what turns an unreproducible kill -9 / rc=124 / SIGSEGV into
a diagnosable timeline. Three parts:

- :class:`FlightRecorder` — a process-wide bounded ring of **structured
  events**: state transitions (degradation-ladder changes, peer health
  flips, sync-cycle outcomes, bootstrap phases, storage full/recovery
  latches, replication skew clamps, slow commands relayed from the native
  server) stamped with wall + monotonic nanoseconds and a sequence
  number. Recording is one lock acquire + a deque append — cheap enough
  to stay on everywhere, always.

- :class:`MetricSampler` — a background thread snapshotting counter
  values and gauges every ``[observability] flight_sample_s`` (default
  1 s) into a fixed ~15-minute ring, so "what changed in the 60 s before
  death" is always answerable from the spill. Watch-listed native
  counters (admission rejections, event drops) additionally materialize
  as flight events when their deltas are non-zero.

- :class:`FlightSpiller` — a periodically rewritten, CRC-framed spill
  file under ``[observability] flight_dir``, written tmp+fsync+rename so
  a kill -9 at ANY instant leaves the previous complete spill on disk.
  :func:`read_spill` tolerates truncation at every byte offset (it
  returns the parseable prefix), and ``python -m merklekv_tpu_torch blackbox``
  merges several nodes' spills into one cluster timeline
  (obs/blackbox.py).

Fatal paths: :func:`install_fault_handlers` arms ``faulthandler`` so a
SIGSEGV/SIGABRT/SIGBUS leaves Python tracebacks beside the spill (the
native layer's crash marker — ``mkv_install_crash_marker`` — chains ahead
of it and stamps the signal + wall time), and :meth:`FlightRecorder.dump`
is the direct path watchdogs call before ``os._exit``.

Scope: the recorder is PROCESS-wide (like the metrics registry) — one
node per process in production, so the ring IS the node's black box.
Co-located test nodes sharing a process share one ring; their spills are
then copies of the same stream, which the blackbox analyzer detects by
full event identity (pid + seq + timestamps) and reports once instead of
double-counting.
"""

from __future__ import annotations

import json
import os
import re
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "FlightEvent",
    "FlightRecorder",
    "MetricSampler",
    "FlightSpiller",
    "SpillDoc",
    "get_recorder",
    "record",
    "read_spill",
    "write_spill",
    "install_fault_handlers",
    "SPILL_MAGIC",
]

# Spill file magic: identifies the format + version. A file without it is
# "not a spill" (blackbox reports it as unreadable, rc 1) rather than a
# truncated one (rc 0 with a prefix).
SPILL_MAGIC = b"MKVFLT1\n"

# One spill frame: u32 payload length, u32 CRC32(payload), payload (JSON
# bytes). The whole file is rewritten atomically, so framing exists for
# disk-corruption tolerance and for the direct fatal-dump path (which may
# be cut mid-write by the very death it is recording).
_FRAME_HDR = struct.Struct("<II")
# Sanity bound on one frame: a length field beyond this reads as
# corruption, not as an allocation request.
_MAX_FRAME = 8 << 20


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
    bounds memory at ``capacity`` events regardless of rate. The newest
    events are what the FLIGHT verb streams and what the spill persists.
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
        # Trace join point: while a causal trace context is active on this
        # thread (anti-entropy cycle, bootstrap), stamp its trace id so the
        # blackbox analyzer can link this event to the same cycle's events
        # on OTHER nodes' spills.
        if "trace" not in clean:
            try:
                from merklekv_tpu_torch.obs import tracewire

                tok = tracewire.current_token()
                if tok:
                    clean["trace"] = tok[3:19]  # trace id only
            except Exception:
                pass
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

    def dump(self, path: str, samples: Optional[list] = None,
             node: str = "", note: str = "") -> bool:
        """Direct spill write for fatal paths (watchdogs, exit hooks):
        best effort, never raises."""
        try:
            write_spill(
                path,
                self.last(0),
                samples or [],
                node=node,
                note=note,
            )
            return True
        except Exception:
            return False


_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, /, **fields) -> None:
    """Module-level shorthand: record into the process-wide ring."""
    _recorder.record(kind, **fields)


# ------------------------------------------------------------------ sampler


@dataclass
class Sample:
    """One metric snapshot: cumulative integer values at ``wall_ns``."""

    wall_ns: int
    values: dict

    def to_json(self) -> dict:
        return {"t": "sample", "wall_ns": self.wall_ns, "v": self.values}


# Native counters whose per-sample DELTAS materialize as flight events —
# these are request-path rejections the python plane never sees one by one
# (they happen in the native accept loop / read path), but whose bursts
# are exactly what a post-mortem needs on the timeline.
WATCHED_NATIVE = {
    "busy_rejected_connections": "admission_reject",
    "pipeline_rejected": "pipeline_reject",
    "events_dropped": "events_dropped",
    "shed_commands": "writes_shed",
    "readonly_commands": "writes_refused_readonly",
}


class MetricSampler:
    """Continuous time-series sampler feeding the spill.

    Every ``interval_s`` it snapshots the metrics registry's counters, the
    flattened gauge values, and (when ``stats_fn`` is given) the native
    STATS integer lines, keeping ``window_s`` worth of samples in a fixed
    ring. Sampling runs off the request path entirely; its cost is one
    registry snapshot + one STATS render per second.
    """

    def __init__(
        self,
        interval_s: float = 1.0,
        stats_fn: Optional[Callable[[], str]] = None,
        window_s: float = 900.0,
        recorder: Optional[FlightRecorder] = None,
    ) -> None:
        self._interval = max(0.05, float(interval_s))
        self._stats_fn = stats_fn
        self._recorder = recorder if recorder is not None else _recorder
        cap = max(2, int(window_s / self._interval))
        self._mu = threading.Lock()
        self._ring: deque[Sample] = deque(maxlen=cap)
        self._prev_watch: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricSampler":
        if self._thread is None:
            self.sample_once()  # a just-started node already has a sample
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="mkv-flight-sampler"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.sample_once()
            except Exception:
                # A broken gauge or a dying server handle must not kill
                # the sampler — the spill keeps its last good samples.
                from merklekv_tpu_torch.utils.tracing import get_metrics

                get_metrics().inc("flight.sample_errors")

    def sample_once(self) -> Sample:
        """One snapshot + watched-delta event derivation (tests call this
        directly instead of sleeping out the ticker)."""
        from merklekv_tpu_torch.utils.tracing import get_metrics

        values: dict = {}
        m = get_metrics()
        snap = m.snapshot()
        for name, v in snap["counters"].items():
            values[name] = int(v)
        for name, g in m.gauges_snapshot().items():
            v = g.get("value")
            if isinstance(v, dict):
                for label, lv in v.items():
                    if isinstance(lv, (int, float)):
                        values[f"{name}.{label}"] = int(lv)
            elif isinstance(v, (int, float)):
                values[name] = int(v)
        if self._stats_fn is not None:
            try:
                for line in self._stats_fn().splitlines():
                    name, sep, val = line.strip().partition(":")
                    if not sep:
                        continue
                    try:
                        values[f"native.{name}"] = int(val)
                    except ValueError:
                        continue  # uptime_human etc.
            except Exception:
                pass
        sample = Sample(wall_ns=time.time_ns(), values=values)
        with self._mu:
            self._ring.append(sample)
        # Watched native counters: a non-zero delta becomes a flight event
        # (the rejection itself happened in the native accept/read path,
        # invisible to python until now).
        for stat, kind in WATCHED_NATIVE.items():
            cur = values.get(f"native.{stat}")
            if cur is None:
                continue
            prev = self._prev_watch.get(stat)
            self._prev_watch[stat] = cur
            if prev is not None and cur > prev:
                self._recorder.record(kind, count=cur - prev, total=cur)
        return sample

    def samples(self, n: int = 0) -> list[Sample]:
        """Newest ``n`` samples (0 = all), oldest first."""
        with self._mu:
            out = list(self._ring)
        return out[-n:] if n > 0 else out


# -------------------------------------------------------------------- spill


@dataclass
class SpillDoc:
    """A parsed spill: whatever prefix of the file was intact."""

    path: str
    meta: dict = field(default_factory=dict)
    events: list[FlightEvent] = field(default_factory=list)
    samples: list[Sample] = field(default_factory=list)
    truncated: bool = False
    error: str = ""  # why parsing stopped early ("" = clean EOF)

    @property
    def node(self) -> str:
        return str(self.meta.get("node", "") or
                   os.path.basename(self.path))


def _frames(meta: dict, events: list[FlightEvent],
            samples: list[Sample]) -> list[bytes]:
    out = [json.dumps({"t": "meta", **meta},
                      separators=(",", ":")).encode()]
    for ev in events:
        out.append(json.dumps(ev.to_json(), separators=(",", ":")).encode())
    for s in samples:
        out.append(json.dumps(s.to_json(), separators=(",", ":")).encode())
    return out


def write_spill(
    path: str,
    events: list[FlightEvent],
    samples: list[Sample],
    node: str = "",
    note: str = "",
) -> None:
    """Write one complete spill atomically: tmp + fsync + rename, so a
    kill -9 at any instant leaves either the previous complete spill or
    this one — never a torn file under the final name."""
    meta = {
        "node": node,
        "pid": os.getpid(),
        "written_wall_ns": time.time_ns(),
        "written_mono_ns": time.monotonic_ns(),
        "events": len(events),
        "samples": len(samples),
    }
    if note:
        meta["note"] = note
    body = bytearray(SPILL_MAGIC)
    for payload in _frames(meta, events, samples):
        body += _FRAME_HDR.pack(len(payload), zlib.crc32(payload))
        body += payload
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        # Loop the write: a short write (disk nearly full) must raise, not
        # fall through to the rename — renaming a torn tmp over the
        # previous COMPLETE spill would destroy the history exactly when
        # the black box is most needed.
        view = memoryview(bytes(body))
        while view:
            n = os.write(fd, view)
            if n <= 0:
                raise OSError("short write on flight spill")
            view = view[n:]
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


def read_spill(path: str) -> SpillDoc:
    """Parse a spill, tolerating truncation at EVERY byte offset and
    interior corruption: parsing stops at the first bad frame and the doc
    carries the intact prefix (``truncated``/``error`` describe why).
    Raises ``ValueError`` only when the file is not a spill at all
    (missing magic) and ``OSError`` when unreadable."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SPILL_MAGIC):
        if SPILL_MAGIC.startswith(data):
            # So short it is a prefix of the magic itself: a torn fatal
            # dump, not a foreign file.
            return SpillDoc(path=path, truncated=True,
                            error="truncated inside file magic")
        raise ValueError(f"{path}: not a flight spill (bad magic)")
    doc = SpillDoc(path=path)
    off = len(SPILL_MAGIC)
    while off < len(data):
        if off + _FRAME_HDR.size > len(data):
            doc.truncated = True
            doc.error = "truncated frame header"
            break
        length, crc = _FRAME_HDR.unpack_from(data, off)
        if length > _MAX_FRAME:
            doc.truncated = True
            doc.error = f"implausible frame length {length}"
            break
        start = off + _FRAME_HDR.size
        end = start + length
        if end > len(data):
            doc.truncated = True
            doc.error = "truncated frame payload"
            break
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            doc.truncated = True
            doc.error = "frame crc mismatch"
            break
        try:
            obj = json.loads(payload)
        except ValueError:
            doc.truncated = True
            doc.error = "frame payload not json"
            break
        t = obj.get("t")
        if t == "meta":
            doc.meta = {k: v for k, v in obj.items() if k != "t"}
        elif t == "event":
            doc.events.append(
                FlightEvent(
                    seq=int(obj.get("seq", 0)),
                    wall_ns=int(obj.get("wall_ns", 0)),
                    mono_ns=int(obj.get("mono_ns", 0)),
                    kind=str(obj.get("kind", "")),
                    fields=dict(obj.get("f", {})),
                )
            )
        elif t == "sample":
            doc.samples.append(
                Sample(
                    wall_ns=int(obj.get("wall_ns", 0)),
                    values=dict(obj.get("v", {})),
                )
            )
        # Unknown frame types skip silently: forward compatibility.
        off = end
    return doc


class FlightSpiller:
    """Periodic spill writer: every ``interval_s`` the current ring +
    sample window are rewritten to ``<dir>/flight.bin`` atomically. The
    first spill is written inline at :meth:`start` so even a node that
    dies seconds after boot leaves a record."""

    FILENAME = "flight.bin"

    def __init__(
        self,
        directory: str,
        recorder: Optional[FlightRecorder] = None,
        sampler: Optional[MetricSampler] = None,
        interval_s: float = 10.0,
        node: str = "",
    ) -> None:
        self._dir = directory
        self._recorder = recorder if recorder is not None else _recorder
        self._sampler = sampler
        self._interval = max(0.1, float(interval_s))
        self._node = node
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def path(self) -> str:
        return os.path.join(self._dir, self.FILENAME)

    def start(self) -> "FlightSpiller":
        if self._thread is None:
            # The inline first spill is STRICT: an unwritable flight dir
            # raises here so the caller can disable the spiller loudly,
            # instead of a background thread retrying a doomed write
            # forever while the operator never sees a diagnostic.
            self.spill_once(strict=True)
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="mkv-flight-spill"
            )
            self._thread.start()
        return self

    def stop(self, final: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final:
            self.spill_once()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.spill_once()

    def spill_once(self, strict: bool = False) -> bool:
        from merklekv_tpu_torch.utils.tracing import get_metrics

        try:
            write_spill(
                self.path,
                self._recorder.last(0),
                self._sampler.samples(0) if self._sampler else [],
                node=self._node,
            )
            get_metrics().inc("flight.spills")
            return True
        except OSError:
            # A full disk must not kill the PERIODIC spiller (the node is
            # already degrading through the storage plane); the previous
            # complete spill stays valid on disk. strict (the start()
            # probe) re-raises so a misconfigured dir fails loudly.
            get_metrics().inc("flight.spill_errors")
            if strict:
                raise
            return False


# --------------------------------------------------------------- fatal paths

_fault_file = None  # keep the traceback fd alive for faulthandler


def install_fault_handlers(directory: str) -> Optional[str]:
    """Arm ``faulthandler`` so SIGSEGV/SIGABRT/SIGBUS/SIGFPE leave Python
    tracebacks at ``<dir>/crash-<pid>.txt``. Returns the traceback path
    (None when faulthandler could not be armed). The native crash marker
    (``mkv_install_crash_marker``) is installed AFTER this by the caller
    so its handler runs first and chains into faulthandler's."""
    global _fault_file
    import faulthandler

    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"crash-{os.getpid()}.txt")
        _fault_file = open(path, "w")
        faulthandler.enable(file=_fault_file, all_threads=True)
        return path
    except (OSError, ValueError, RuntimeError):
        return None
