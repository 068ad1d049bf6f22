"""Host-side helpers of the torch port (device selection for tensors and for
a node, the numpy word boundary, spans and metrics, device profiling, error
classes).

A copy of ``merklekv_tpu/utils/__init__.py``: the package exports the
tracing API of ``utils/tracing.py``.
"""

from merklekv_tpu_torch.utils.tracing import (
    Metrics,
    device_profile,
    get_metrics,
    span,
)

__all__ = ["span", "Metrics", "get_metrics", "device_profile"]
