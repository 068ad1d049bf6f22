"""Device selection for server processes (port of
``merklekv_tpu/utils/jaxenv.py``).

``MERKLEKV_TORCH_DEVICE`` names the device a node's Merkle mirror and
anti-entropy run on: unset means ``cuda``, and ``cpu`` is an explicit request
for the plain PyTorch versions on the host (the tests ask for it). The name
resolves through ``torchenv.resolve_device``, so a node asked for ``cuda`` on
a machine without a GPU raises instead of running on the CPU.

What the JAX module did and this one does not:

- ``ensure_platform`` (pinning ``jax_platforms`` before the first
  computation) has no counterpart: the device is passed to every call;
- ``probe_default_backend`` (a JAX backend-init probe) is not needed;
- the reference's sticky process-wide CPU fallback is gone. A failure on the
  device path is counted in ``device.fallbacks`` (the reference's name) and
  re-raised by its caller; the next call tries the device again.
"""

from __future__ import annotations

import os

__all__ = ["ENV", "device_name", "resolve", "note_device_failure"]

ENV = "MERKLEKV_TORCH_DEVICE"


def device_name() -> str:
    """The configured device name, without importing torch."""
    return os.environ.get(ENV, "").strip() or "cuda"


def resolve():
    """The configured device as a ``torch.device``; raises without a GPU
    unless ``MERKLEKV_TORCH_DEVICE=cpu``."""
    from merklekv_tpu_torch.utils.torchenv import resolve_device

    try:
        return resolve_device(device_name())
    except RuntimeError as e:
        raise RuntimeError(
            f"{e}; a node takes its device from {ENV} (unset means cuda): "
            f"set {ENV}=cpu, or [anti_entropy] engine = \"cpu\" for a node "
            "without a device path"
        ) from e


def note_device_failure(err: BaseException, what: str = "device path") -> None:
    """Count a device-path failure; the caller re-raises it."""
    from merklekv_tpu_torch.obs.flightrec import record
    from merklekv_tpu_torch.utils.tracing import get_metrics

    get_metrics().inc("device.fallbacks")
    record("device_failure", what=what, error=f"{type(err).__name__}: {err}"[:200])
