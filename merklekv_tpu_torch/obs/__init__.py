"""Observability of the torch port: the metrics registry (``metrics``), the
flight recorder (``flightrec``), anti-entropy cycle traces (``trace``), the
causal-trace wire (``tracewire``), the convergence-lag plane (``lag``), the
Prometheus exporter (``exporter``, ``catalog``) and the operator tools
(``top``, ``blackbox``): copies of the JAX package's ``obs/`` modules.

A copy of ``merklekv_tpu/obs/__init__.py``: ``utils/tracing.py`` keeps its
``span`` / ``get_metrics`` API backed by this package's registry, and the
package exports the registry, the exporter and the cycle-trace names.
"""

from merklekv_tpu_torch.obs.exporter import MetricsExporter, render_prometheus
from merklekv_tpu_torch.obs.metrics import (
    BUCKET_BOUNDS,
    Histogram,
    Metrics,
    bucket_index,
    get_metrics,
)
from merklekv_tpu_torch.obs.trace import (
    CycleTrace,
    PeerTrace,
    SyncTraceBuffer,
    current_cycle_id,
    cycle_scope,
    get_trace_buffer,
    next_cycle_id,
)

__all__ = [
    "BUCKET_BOUNDS",
    "bucket_index",
    "Histogram",
    "Metrics",
    "get_metrics",
    "MetricsExporter",
    "render_prometheus",
    "CycleTrace",
    "PeerTrace",
    "SyncTraceBuffer",
    "current_cycle_id",
    "cycle_scope",
    "get_trace_buffer",
    "next_cycle_id",
]
