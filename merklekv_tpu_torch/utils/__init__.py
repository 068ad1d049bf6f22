"""Host-side helpers of the torch port (device selection for tensors and for
a node, the numpy word boundary, spans and metrics, error classes)."""
