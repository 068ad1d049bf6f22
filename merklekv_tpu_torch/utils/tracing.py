"""Spans and the metrics registry (partial copy of
``merklekv_tpu/utils/tracing.py``: ``span`` and ``get_metrics``).

- ``span("name")`` context manager: a wall-time span emitted as one JSON
  record through the ``merklekv`` logger and aggregated into per-span
  counters, totals and a latency histogram (``obs/metrics.py``);
- ``get_metrics()``: the port's process-wide registry.

Left out: the causal-trace and anti-entropy-cycle stamping of each span
(``obs/tracewire.py``, ``obs/trace.py``), which come with the node, and
``device_profile`` (``jax.profiler``), which comes with the ``PROFILE`` verb
as a ``torch.profiler`` trace.
"""

from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from merklekv_tpu_torch.obs.metrics import Metrics, get_metrics

logger = logging.getLogger("merklekv")

__all__ = ["span", "Metrics", "get_metrics"]


@contextmanager
def span(name: str, **fields) -> Iterator[dict]:
    """Timed span; yields a dict callers may stuff result fields into."""
    extra: dict = {}
    t0 = time.perf_counter()
    error: Optional[str] = None
    try:
        yield extra
    except BaseException as e:
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        dt = time.perf_counter() - t0
        get_metrics().observe_span(name, dt)
        record = {"span": name, "seconds": round(dt, 6), **fields, **extra}
        if error is not None:
            record["error"] = error
        logger.info(json.dumps(record, default=str))
