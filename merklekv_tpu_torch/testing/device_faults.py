"""Device-plane fault injection at the dispatch-guard seam (copy of
``merklekv_tpu/testing/device_faults.py``).

The dispatch guard (``merklekv_tpu_torch.device.guard``) runs every device
call through an injectable ``around(label, fn)`` hook; installing a
:class:`DeviceFaultInjector` makes chosen dispatches

- **fail** (raise — message shaped so the shared classifier reads it as
  ``environment`` by default, or anything the test wants),
- **hang** (sleep past the dispatch deadline INSIDE the guard worker, so
  the guard's abandonment path runs exactly as a wedged backend call would
  drive it),
- **corrupt** (post-hook transform of the dispatch result — the silent
  device-corruption shape the integrity scrub exists to catch),

selected by a label glob (``scatter``, ``build``, ``*`` everything
device-side — the CPU golden rung never touches the guard), starting at the
Nth matched call (``at``, 1-based), persisting until :meth:`heal` or for
exactly ``count`` calls. Deterministic by construction: no RNG, faults fire
on call ordinals.

A process picks an injector up from ``MKV_DEVICE_FAULTS`` (``mode:glob[:at]``,
e.g. ``fail:scatter`` or ``hang:scatter:3``). The port's guard and injector
are separate from the JAX package's, so in a process that runs both, the
variable arms both.

One change from the JAX copy: the default corruption. The JAX build returns
a tuple of immutable level arrays and flips leaf 0 with ``.at[...].set``;
the port's ``_dispatch_build`` and ``_dispatch_restructure`` return a list
of level tensors, so the default here flips bit 0 of leaf 0 in a clone of
the leaf level and leaves every other result alone.

Nothing here is imported by serving code; it costs nothing in production.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Callable, Optional

import torch

__all__ = ["DeviceFaultInjector"]

# Matches the shared classifier's backend-init pattern: injected faults
# should read as environment weather unless a test says otherwise.
_DEFAULT_MESSAGE = "unable to initialize backend (injected device fault)"


def _default_corrupt(out):
    """Flip bit 0 of the first leaf digest when the result is a list of
    level tensors — the minimal silent corruption: the tree keeps serving,
    the root stays plausible (the levels above are not recomputed), only a
    leaf-level cross-check can see it."""
    if isinstance(out, (list, tuple)) and len(out) and isinstance(out[0], torch.Tensor):
        leaves = out[0].clone()
        if leaves.numel():
            leaves[0, 0] ^= 1
        return type(out)([leaves, *out[1:]])
    return out


class DeviceFaultInjector:
    """Deterministic fault injector for guarded device dispatches.

    Usage::

        inj = DeviceFaultInjector(match="scatter", mode="fail").install()
        try:
            ...      # every value-batch dispatch now fails (environment kind)
            inj.heal()   # the "device" recovers; re-warm probes succeed
        finally:
            inj.uninstall()
    """

    def __init__(
        self,
        match: str = "*",
        mode: str = "fail",
        at: int = 1,
        count: Optional[int] = None,
        hang_s: Optional[float] = None,
        message: str = _DEFAULT_MESSAGE,
        corrupt: Optional[Callable] = None,
    ) -> None:
        if mode not in ("fail", "hang", "corrupt"):
            raise ValueError(f"mode must be fail|hang|corrupt, got {mode!r}")
        self._match = match
        self._mode = mode
        self._at = max(1, int(at))
        self._count = count  # None = until heal()
        # None = size the sleep off the LIVE guard deadline at fire time:
        # a fixed default shorter than the configured deadline would
        # complete normally and never exercise the abandonment path.
        self._hang_s = None if hang_s is None else float(hang_s)
        self._message = message
        self._corrupt = corrupt or _default_corrupt
        self._mu = threading.Lock()
        self._healed = False
        self._installed = False
        # Observability for assertions.
        self.calls = 0
        self.matched = 0
        self.failures = 0
        self.hangs = 0
        self.corruptions = 0

    @classmethod
    def from_spec(cls, spec: str) -> "DeviceFaultInjector":
        """``mode:glob[:at]`` (the MKV_DEVICE_FAULTS env format)."""
        parts = spec.strip().split(":")
        if len(parts) < 2:
            raise ValueError(
                f"device fault spec must be mode:glob[:at], got {spec!r}"
            )
        at = int(parts[2]) if len(parts) > 2 else 1
        return cls(match=parts[1], mode=parts[0], at=at)

    # -- the guard hook ------------------------------------------------------
    def _fire(self, label: str) -> bool:
        with self._mu:
            self.calls += 1
            if self._healed or not fnmatch.fnmatch(label, self._match):
                return False
            self.matched += 1
            if self.matched < self._at:
                return False
            if (
                self._count is not None
                and self.failures + self.hangs + self.corruptions
                >= self._count
            ):
                return False
            return True

    def around(self, label: str, fn: Callable):
        """Runs INSIDE the guard (on its worker thread for fail/hang —
        which is what makes an injected hang exercise the real
        abandonment path)."""
        if not self._fire(label):
            return fn()
        if self._mode == "fail":
            with self._mu:
                self.failures += 1
            raise RuntimeError(f"{self._message} [{label}]")
        if self._mode == "hang":
            with self._mu:
                self.hangs += 1
            time.sleep(self._hang_duration_s())
            return fn()
        out = fn()
        with self._mu:
            self.corruptions += 1
        return self._corrupt(out)

    def _hang_duration_s(self) -> float:
        """Explicit ``hang_s`` verbatim; otherwise past the CURRENT guard
        deadline (+25%), or 30 s when the deadline is unbounded (0) — a
        hang must outlive the deadline to drive the abandonment path."""
        if self._hang_s is not None:
            return self._hang_s
        try:
            from merklekv_tpu_torch.device.guard import get_guard

            deadline_ms = float(get_guard().deadline_ms)
        except Exception:
            deadline_ms = 0.0
        if deadline_ms <= 0:
            return 30.0
        return deadline_ms / 1000.0 * 1.25

    # -- lifecycle -----------------------------------------------------------
    def install(self) -> "DeviceFaultInjector":
        from merklekv_tpu_torch.device import guard

        guard.set_inject(self)
        self._installed = True
        return self

    def heal(self) -> None:
        """Stop injecting (the device plane 'recovers'); counters keep
        running so tests can assert post-heal traffic."""
        with self._mu:
            self._healed = True

    def unheal(self) -> None:
        """Re-arm after :meth:`heal` (inject/heal soak cycles)."""
        with self._mu:
            self._healed = False

    def uninstall(self) -> None:
        if self._installed:
            from merklekv_tpu_torch.device import guard

            guard.set_inject(None)
            self._installed = False

    def __enter__(self) -> "DeviceFaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
