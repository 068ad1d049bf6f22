"""Retry/timeout/backoff policy (partial copy of
``merklekv_tpu/cluster/retry.py:53-230``: ``Deadline``, ``RetryPolicy``,
``DEVICE_DISPATCH`` and ``DEVICE_HEAL``).

Semantics:

- **Jittered capped exponential backoff** — delay_i = min(first * mult^i,
  max), +/- jitter fraction, drawn from a caller-supplied ``random.Random``
  so chaos tests stay deterministic under a fixed seed.
- **Per-operation deadline** — ``Deadline`` is a monotonic budget handed
  down a call chain.
- **Bounded attempts** — ``run()`` retries a callable under the policy;
  ``attempts`` caps the tries, ``deadline`` caps the wall clock, whichever
  binds first.

The cluster policies (transport heal, sync, health probes, replication,
bootstrap) and the client-error policies wait for the node slice.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, replace
from typing import Callable, Iterator, Optional, TypeVar

__all__ = ["RetryPolicy", "Deadline", "DEVICE_DISPATCH", "DEVICE_HEAL"]

T = TypeVar("T")


class Deadline:
    """Monotonic time budget shared down a call chain. ``None`` seconds
    means unbounded (never expires)."""

    def __init__(self, seconds: Optional[float]) -> None:
        self._expires = (
            None if seconds is None else time.monotonic() + seconds
        )

    @classmethod
    def unbounded(cls) -> "Deadline":
        return cls(None)

    def remaining(self) -> Optional[float]:
        """Seconds left, or None when unbounded. Floors at 0.0."""
        if self._expires is None:
            return None
        return max(0.0, self._expires - time.monotonic())

    def expired(self) -> bool:
        return self._expires is not None and time.monotonic() >= self._expires

    def clamp(self, timeout: float) -> float:
        """A socket/op timeout no longer than the remaining budget."""
        rem = self.remaining()
        return timeout if rem is None else max(0.001, min(timeout, rem))


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered capped exponential backoff + attempt/deadline bounds.

    ``op_timeout`` is the per-operation timeout the component should run
    with; ``op_deadline`` bounds one whole logical operation, after which
    the operation must checkpoint/resume rather than keep running.
    """

    first_delay: float = 0.2
    max_delay: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.1  # +/- fraction of each delay
    attempts: Optional[int] = None  # None = unbounded retries
    op_timeout: float = 5.0
    op_deadline: Optional[float] = None  # None = unbounded

    def with_overrides(self, **kw) -> "RetryPolicy":
        return replace(self, **kw)

    def deadline(self) -> Deadline:
        return Deadline(self.op_deadline)

    def backoff(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Delay before retry ``attempt`` (0-based), jittered."""
        # Grow iteratively, stopping at the cap: ``multiplier ** attempt``
        # overflows to OverflowError near attempt=1024, and an unbounded
        # heal loop does reach such counts.
        base = self.first_delay
        for _ in range(attempt):
            if base >= self.max_delay:
                break
            base *= self.multiplier
        base = min(base, self.max_delay)
        if self.jitter <= 0:
            return base
        r = rng.random() if rng is not None else random.random()
        return max(0.0, base * (1.0 + self.jitter * (2.0 * r - 1.0)))

    def delays(self, rng: Optional[random.Random] = None) -> Iterator[float]:
        """Backoff sequence; finite iff ``attempts`` is set (yields
        attempts-1 delays — the first try is free)."""
        i = 0
        while self.attempts is None or i < self.attempts - 1:
            yield self.backoff(i, rng)
            i += 1

    def run(
        self,
        fn: Callable[[], T],
        retry_on: tuple[type[BaseException], ...] = (OSError,),
        should_stop: Optional[Callable[[], bool]] = None,
        rng: Optional[random.Random] = None,
        deadline: Optional[Deadline] = None,
    ) -> T:
        """Call ``fn`` under the policy; re-raise the last error once
        attempts/deadline are exhausted or ``should_stop()`` turns true."""
        if deadline is None:
            deadline = self.deadline()
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on:
                out_of_attempts = (
                    self.attempts is not None and attempt >= self.attempts - 1
                )
                if out_of_attempts or deadline.expired() or (
                    should_stop is not None and should_stop()
                ):
                    raise
                time.sleep(deadline.clamp(self.backoff(attempt, rng)))
                attempt += 1


# Device dispatch guard (merklekv_tpu_torch.device.guard): ONE near-immediate
# retry when a device program call fails with an environment-classified
# error — a second failure escalates to the degradation ladder instead of
# retrying into a sick backend. Hangs are never retried: the abandoned
# dispatch already spent the deadline, and the pump's stall budget is the
# deadline, not a multiple of it.
DEVICE_DISPATCH = RetryPolicy(
    first_delay=0.05, max_delay=0.5, jitter=0.2, attempts=2, op_timeout=5.0
)

# Device-plane re-warm probe (degradation-ladder heal): escalating backoff
# between probes of a higher rung while the node serves from a degraded
# backend. First probe comes quickly (most faults are transient); a
# persistently sick device plane backs the probing off to once a minute so
# the probe dispatches themselves never become load.
DEVICE_HEAL = RetryPolicy(
    first_delay=2.0, max_delay=60.0, multiplier=2.0, jitter=0.2
)
