"""Structured tracing + metrics for the control plane.

A copy of ``merklekv_tpu/utils/tracing.py``, its imports pointed at the
port's modules, with a ``device_profile`` over ``torch.profiler`` in place
of the ``jax.profiler`` one. The node's ``PROFILE`` verb keeps its own
capture (its reply names the trace file it writes).

The reference has no tracing at all — just env_logger text logs, with
structured tracing/Prometheus listed as an open roadmap issue
(the reference's README.md:1902-1906). Here observability is first-class;
the metrics core lives in ``merklekv_tpu_torch/obs/`` (histograms, gauges, the
Prometheus exporter) and this module keeps the thin tracing API every
subsystem imports:

- ``span("name")`` context manager: wall-time spans emitted as single-line
  JSON records through the ``merklekv`` logger (built only when it emits
  INFO), aggregated into per-span counters/totals AND per-span latency
  histograms (obs.metrics), and
  stamped with the current anti-entropy cycle id when one is active
  (obs.trace) so a cycle's spans correlate in the log stream;
- ``get_metrics()``: the process-wide obs registry (counters + spans +
  histograms + gauges) that subsystems bump; snapshot() for dashboards
  and the test suite;
- ``device_profile(logdir)``: a ``torch.profiler`` trace around a device
  workload, written to ``logdir`` in TensorBoard format (one ``with``
  block; inspect with TensorBoard's PyTorch profiler plugin or
  ``chrome://tracing``);
- ``device_span("name", device)``: a span of the data plane, timed on the
  device. It is on exactly while a ``torch.profiler`` session records on
  the calling thread (``device_profile`` around the work, for one); off,
  it costs one read of the profiler's per-thread flag. On, it is a
  ``record_function`` range in the session's trace (a ``user_annotation``
  on the host; on the device a ``gpu_user_annotation`` over the kernels
  it launched outside any inner span, so a span whose kernels all lie in
  inner spans has none) and one record in a bounded in-memory ring, with
  a CUDA event on
  the device's current stream at entry and at exit. ``device_spans()``
  reads the ring, the device times filled in once both events completed.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import logging
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from merklekv_tpu_torch.obs import tracewire
from merklekv_tpu_torch.obs.metrics import Metrics, get_metrics
from merklekv_tpu_torch.obs.trace import current_cycle_id

logger = logging.getLogger("merklekv")

__all__ = [
    "span",
    "Metrics",
    "get_metrics",
    "device_profile",
    "device_span",
    "device_spans",
    "device_spans_dropped",
    "clear_device_spans",
]


@contextmanager
def span(name: str, **fields) -> Iterator[dict]:
    """Timed span; yields a dict callers may stuff result fields into.

    When a causal trace is active (obs/tracewire.py), the span also lands
    in the process-wide SpanCollector: it allocates a child span id and
    installs it for its duration, so nested spans — and traced wire
    requests issued inside — parent to it and the donor's serve spans
    stitch under this node's walk."""
    extra: dict = {}
    tstate = tracewire.begin_span()
    t0 = time.perf_counter()
    error: Optional[str] = None
    try:
        yield extra
    except BaseException as e:
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        dt = time.perf_counter() - t0
        _metrics = get_metrics()
        _metrics.observe_span(name, dt)
        cycle = current_cycle_id()
        if tstate is not None:
            tracewire.end_span(
                tstate, name, int(dt * 1e9), error=error, cycle=cycle or 0
            )
        if logger.isEnabledFor(logging.INFO):
            record = {"span": name, "seconds": round(dt, 6), **fields, **extra}
            if cycle is not None and "cycle" not in record:
                record["cycle"] = cycle
            if error is not None:
                record["error"] = error
            logger.info(json.dumps(record, default=str))


@contextmanager
def device_profile(logdir: str) -> Iterator[None]:
    """torch.profiler trace around a device workload (TensorBoard format).

    Records CPU activity always and CUDA activity whenever a CUDA device is
    present; the workload runs where its own tensors are."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _thread.session = None  # the device spans inside start a new session
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


# ------------------------------------------------------------ device spans

DEVICE_SPAN_RING = 16384
_RING: collections.deque = collections.deque(maxlen=DEVICE_SPAN_RING)
_ring_lock = threading.Lock()
_dropped = 0
_span_ids = itertools.count(1)
_session_ids = itertools.count(1)
_open_span: contextvars.ContextVar[Optional["_DeviceSpan"]] = contextvars.ContextVar(
    "mkv_device_span", default=None
)
# torch's per-thread "a profiler session records here" flag, bound at the
# first call (this module does not import torch).
_profiler_enabled = None
_OFF = contextlib.nullcontext()


class _ThreadSession(threading.local):
    """The number of the recording session the calling thread's device spans
    belong to; None once a span ran off, or ``device_profile`` started, so
    that the next span on the thread begins a new one."""

    session: Optional[int] = None


_thread = _ThreadSession()


def _bind_profiler_flag():
    global _profiler_enabled
    import torch

    _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled


def device_span(name: str, device):
    """A span of device work launched inside it, on ``device``'s current
    stream. On only while a ``torch.profiler`` session records on the
    calling thread; otherwise the shared no-op context."""
    flag = _profiler_enabled or _bind_profiler_flag()
    if not flag():
        _thread.session = None
        return _OFF
    return _DeviceSpan(name, device)


class _DeviceSpan:
    """One device span: its ``record_function`` range while open, and its
    record in the ring (entered at entry, so a parent precedes its
    children)."""

    __slots__ = ("name", "device", "id", "parent", "root", "session", "index", "t0_ns",
                 "t1_ns", "start", "end", "cycle", "_range", "_token")

    def __init__(self, name: str, device) -> None:
        self.name = name
        self.device = device

    def __enter__(self) -> None:
        global _dropped
        import torch

        parent = _open_span.get()
        self.id = next(_span_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        if _thread.session is None:
            _thread.session = next(_session_ids)
        self.session = _thread.session
        self.cycle = current_cycle_id()
        self.end = self.t1_ns = None
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        dev = torch.device(self.device)
        if dev.type == "cuda":
            self.index = dev.index if dev.index is not None else torch.cuda.current_device()
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.index))
        else:
            self.index = dev.index
            self.start = None
        self.t0_ns = time.perf_counter_ns()
        self._token = _open_span.set(self)
        with _ring_lock:
            if len(_RING) == _RING.maxlen:
                _dropped += 1
            _RING.append(self)

    def __exit__(self, *exc) -> bool:
        import torch

        self.t1_ns = time.perf_counter_ns()
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.index))
            self.end = end
        _open_span.reset(self._token)
        self._range.__exit__(*exc)
        self._range = self._token = None
        return False


def _elapsed_ms(a, b) -> Optional[float]:
    """Device ms from event ``a`` to event ``b``, once both completed."""
    if a is None or b is None or not (a.query() and b.query()):
        return None
    return a.elapsed_time(b)


def device_spans() -> list[dict]:
    """The ring's records, oldest first: ``name``, ``id``, ``parent``
    (the enclosing device span on its thread, or None), ``root`` (the
    outermost span's id, shared by every span under it), ``session`` (the
    number of the recording it ran in: a thread's spans begin a new one
    after a span of that thread ran with no session recording, or after
    ``device_profile`` started; two sessions with no span between them
    share one), ``device`` (the index, None for an unindexed CPU device),
    ``host_ns`` (perf_counter_ns at entry and exit; exit None while open),
    ``cycle`` (the sync cycle id, or None), ``device_ms`` (entry event to
    exit event, None until both completed, always None off CUDA) and, on
    root spans, ``between_ms``: from the previous root span's exit event
    on the same device to this one's entry event (None on other spans, on
    the first root span of a device in a session, or until both
    completed)."""
    with _ring_lock:
        spans = list(_RING)
    out = []
    last_end: dict = {}
    for s in spans:
        rec = {"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
               "session": s.session, "device": s.index, "host_ns": (s.t0_ns, s.t1_ns),
               "cycle": s.cycle, "device_ms": _elapsed_ms(s.start, s.end), "between_ms": None}
        if s.parent is None:
            prev = last_end.get((s.session, s.index))
            rec["between_ms"] = _elapsed_ms(prev, s.start)
            last_end[(s.session, s.index)] = s.end
        out.append(rec)
    return out


def device_spans_dropped() -> int:
    """Records the ring dropped, oldest first, since it was last cleared."""
    return _dropped


def clear_device_spans() -> None:
    """Empty the ring and zero its dropped count."""
    global _dropped
    with _ring_lock:
        _RING.clear()
        _dropped = 0
