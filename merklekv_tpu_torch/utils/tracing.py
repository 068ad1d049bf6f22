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
  JSON records through the ``merklekv`` logger, aggregated into per-span
  counters/totals AND per-span latency histograms (obs.metrics), and
  stamped with the current anti-entropy cycle id when one is active
  (obs.trace) so a cycle's spans correlate in the log stream;
- ``get_metrics()``: the process-wide obs registry (counters + spans +
  histograms + gauges) that subsystems bump; snapshot() for dashboards
  and the test suite;
- ``device_profile(logdir)``: a ``torch.profiler`` trace around a device
  workload, written to ``logdir`` in TensorBoard format (one ``with``
  block; inspect with TensorBoard's PyTorch profiler plugin or
  ``chrome://tracing``).
"""

from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from merklekv_tpu_torch.obs import tracewire
from merklekv_tpu_torch.obs.metrics import Metrics, get_metrics
from merklekv_tpu_torch.obs.trace import current_cycle_id

logger = logging.getLogger("merklekv")

__all__ = ["span", "Metrics", "get_metrics", "device_profile"]


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
        record = {"span": name, "seconds": round(dt, 6), **fields, **extra}
        cycle = current_cycle_id()
        if cycle is not None and "cycle" not in record:
            record["cycle"] = cycle
        if error is not None:
            record["error"] = error
        if tstate is not None:
            tracewire.end_span(
                tstate, name, int(dt * 1e9), error=error, cycle=cycle or 0
            )
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
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
