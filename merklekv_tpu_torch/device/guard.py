"""Deadline-guarded device dispatch: the pump thread can never hang (copy
of ``merklekv_tpu/device/guard.py``).

Every device call of the torch serving tree (build, value scatter,
restructure, root walk, level reads) routes through
:func:`DispatchGuard.run`:

- the call executes on its **own daemon guard thread** with a
  ``dispatch_deadline_ms`` bound — a dispatch wedged inside the driver is
  ABANDONED at the deadline (the thread is orphaned), so the caller gets a
  typed :class:`DispatchHungError` instead of blocking forever, and
  concurrent dispatches never queue behind each other's deadlines;
- failures are classified by the shared environment|code table
  (``merklekv_tpu_torch.utils.errorkind``): environment-classified errors
  retry ONCE under ``retry.DEVICE_DISPATCH`` backoff; code errors raise
  immediately;
- everything that escapes wraps as :class:`DeviceDispatchError` carrying
  the classified ``kind`` — the degradation ladder's input signal.

Chaos seam: :func:`set_inject` installs a fault injector
(``testing/device_faults.DeviceFaultInjector``) whose hooks run INSIDE the
guarded call. A process picks injection up from the ``MKV_DEVICE_FAULTS``
env var. This guard, its injection slot and its metrics are the port's own,
separate from the JAX package's, so in a process that runs both packages
the variable arms both guards.

The guarded function runs on a fresh thread, so a CUDA launch inside it
must not rely on the caller's current device: the kernel wrappers launch
under ``torch.cuda.device`` of their tensors. Nothing here imports torch;
the guard is pure threading and costs one thread spawn per dispatch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, TypeVar

from merklekv_tpu_torch.cluster.retry import DEVICE_DISPATCH, RetryPolicy
from merklekv_tpu_torch.obs.metrics import get_metrics
from merklekv_tpu_torch.utils.errorkind import ENVIRONMENT, classify_exception

__all__ = [
    "DeviceDispatchError",
    "DispatchHungError",
    "DispatchGuard",
    "get_guard",
    "configure",
    "set_inject",
    "get_inject",
]

T = TypeVar("T")

# Guard worker threads carry this name; a guarded call issued from one runs
# inline (see DispatchGuard._bounded).
GUARD_THREAD_NAME = "mkv-dispatch-guard"


class DeviceDispatchError(RuntimeError):
    """A guarded device call failed past its retry budget.

    ``kind`` is the shared classifier's verdict (``environment`` | ``code``)
    and ``label`` names the dispatch seam (``build`` / ``scatter`` /
    ``restructure`` / ``root`` / ``levels``), so the degradation ladder and
    the flight timeline both know WHAT failed and WHY without re-parsing
    tracebacks."""

    def __init__(self, label: str, kind: str, cause: str) -> None:
        super().__init__(f"device dispatch {label!r} failed ({kind}): {cause}")
        self.label = label
        self.kind = kind
        self.cause = cause


class DispatchHungError(DeviceDispatchError):
    """A guarded dispatch blew through the deadline and was abandoned.
    Always ``environment``: the wedged worker thread may still be inside
    the driver — the guard replaced it rather than wait."""

    def __init__(self, label: str, deadline_ms: float) -> None:
        DeviceDispatchError.__init__(
            self, label, ENVIRONMENT,
            f"dispatch deadline {deadline_ms:g}ms expired; dispatch "
            "abandoned",
        )
        self.deadline_ms = deadline_ms


class DispatchGuard:
    """Deadline + classify + retry-once wrapper for device calls.

    ``deadline_ms <= 0`` disables the thread round-trip (calls run inline,
    unbounded); classification, retry, and the chaos seam still apply.
    """

    def __init__(
        self,
        deadline_ms: float = 60_000.0,
        policy: RetryPolicy = DEVICE_DISPATCH,
    ) -> None:
        self._deadline_ms = float(deadline_ms)
        self._policy = policy

    @property
    def deadline_ms(self) -> float:
        return self._deadline_ms

    def set_deadline_ms(self, deadline_ms: float) -> None:
        self._deadline_ms = float(deadline_ms)

    # -- execution -----------------------------------------------------------
    def _bounded(self, label: str, fn: Callable[[], T]) -> T:
        """One guarded attempt: run ``fn`` on a fresh daemon thread under
        the deadline; abandon the thread on a blow-through.

        One thread PER CALL, deliberately: a shared worker would make the
        deadline measure queue-wait + execution, so a dispatch queued
        behind a legitimate slow build would be falsely classified as hung
        without ever running — and it would serialize every device
        dispatch in the process. Plain daemon threads instead of
        concurrent.futures: an abandoned wedged thread must not block
        interpreter exit."""
        deadline_ms = self._deadline_ms
        if (
            deadline_ms <= 0
            or threading.current_thread().name == GUARD_THREAD_NAME
        ):
            # Disabled, or already ON a guard thread (a nested guarded
            # call): run inline rather than stacking guard threads.
            return fn()
        box: list = []
        done = threading.Event()

        def run() -> None:
            try:
                box.append((True, fn()))
            except BaseException as e:  # delivered to the caller
                box.append((False, e))
            done.set()

        threading.Thread(
            target=run, daemon=True, name=GUARD_THREAD_NAME
        ).start()
        if not done.wait(timeout=deadline_ms / 1000.0):
            # Wedged: orphan the thread (daemon — it may never return).
            # Its result, if it ever arrives, is discarded.
            get_metrics().inc("device.guard_timeouts")
            raise DispatchHungError(label, deadline_ms)
        ok, out = box[0]
        if ok:
            return out
        raise out

    def run(self, label: str, fn: Callable[[], T]) -> T:
        """Run one device call under the guard. Returns ``fn()``'s value, or
        raises :class:`DeviceDispatchError` (classified) /
        :class:`DispatchHungError` (abandoned)."""
        inject = get_inject()
        if inject is not None:
            call = lambda: inject.around(label, fn)  # noqa: E731
        else:
            call = fn
        retried = False
        while True:
            try:
                return self._bounded(label, call)
            except DispatchHungError:
                raise  # never retried: the stall budget IS the deadline
            except DeviceDispatchError:
                raise  # already classified by a nested guarded call
            except BaseException as e:
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                kind = classify_exception(e)
                if kind == ENVIRONMENT and not retried:
                    retried = True
                    get_metrics().inc("device.guard_retries")
                    time.sleep(self._policy.backoff(0))
                    continue
                get_metrics().inc("device.guard_errors")
                raise DeviceDispatchError(
                    label, kind, f"{type(e).__name__}: {e}"
                ) from e


# -- module seam (one guard per process, one injection slot) ----------------

_guard = DispatchGuard()
_inject = None
_env_checked = False


def get_guard() -> DispatchGuard:
    return _guard


def configure(deadline_ms: Optional[float] = None) -> DispatchGuard:
    """Process-wide guard configuration. Several mirrors in one process
    share the guard; last configuration wins."""
    if deadline_ms is not None:
        _guard.set_deadline_ms(deadline_ms)
    return _guard


def set_inject(inj) -> None:
    """Install (or, with None, remove) the chaos injector. The injector
    must expose ``around(label, fn) -> result``."""
    global _inject, _env_checked
    _inject = inj
    _env_checked = True  # explicit installation overrides the env hook


def get_inject():
    """The active injector, installing the ``MKV_DEVICE_FAULTS`` env-var
    injector on first use."""
    global _inject, _env_checked
    if not _env_checked:
        _env_checked = True
        spec = os.environ.get("MKV_DEVICE_FAULTS", "")
        if spec:
            from merklekv_tpu_torch.testing.device_faults import (
                DeviceFaultInjector,
            )

            _inject = DeviceFaultInjector.from_spec(spec).install()
    return _inject
