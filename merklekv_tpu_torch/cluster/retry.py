"""Unified retry/timeout/backoff policy for the cluster plane.

A copy of ``merklekv_tpu/cluster/retry.py``, its imports pointed at the port's modules.

Before this module every component carried its own scattered constants:
transport heal loops hard-coded first/max backoff, the sync manager a bare
socket timeout, the health monitor its own probe timeout and failure
threshold, the replicator a fixed drain sleep. A partial failure then
behaved differently at every layer, and none of it was tunable or testable
as one model. "Asynchronous Merkle Trees" (PAPERS.md) argues correctness
under an adversarial scheduler; the chaos suite (tests/test_faults.py)
creates that adversary, and this policy object is the single knob the
stack answers it with.

Semantics:

- **Jittered capped exponential backoff** — delay_i = min(first * mult^i,
  max), +/- jitter fraction, drawn from a caller-supplied ``random.Random``
  so chaos tests stay deterministic under a fixed seed.
- **Per-operation deadline** — ``Deadline`` is a monotonic budget handed
  down a call chain; long multi-batch operations (anti-entropy repair)
  check it between batches and persist a resumable session instead of
  running unbounded.
- **Bounded attempts** — ``run()`` retries a callable under the policy;
  ``attempts`` caps the tries, ``deadline`` caps the wall clock, whichever
  binds first.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, replace
from typing import Callable, Iterator, Optional, TypeVar

__all__ = [
    "RetryPolicy",
    "Deadline",
    "TRANSPORT_HEAL",
    "SYNC_PEER",
    "HEALTH_PROBE",
    "REPLICATOR_PUBLISH",
    "BOOTSTRAP_FETCH",
    "SERVER_BUSY",
    "DEVICE_DISPATCH",
    "DEVICE_HEAL",
    "PARTITION_MOVED",
    "RETRYABLE_ERRORS",
    "ROUTED_RETRYABLE_ERRORS",
]

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

    ``op_timeout`` is the per-network-operation (connect/recv) timeout the
    component should run with; ``op_deadline`` bounds one whole logical
    operation (e.g. one anti-entropy cycle against one peer), after which
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
        # heal loop (broker down for hours) does reach such counts.
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


# Shared defaults — every cluster component derives its constants from one
# of these instead of hard-coding its own (one policy object per concern).

# Broker-link healing: first retry almost immediately (broker restarts are
# usually fast), cap well below the anti-entropy interval so the fabric
# heals before the repair loop has to.
TRANSPORT_HEAL = RetryPolicy(
    first_delay=0.2, max_delay=5.0, jitter=0.1, op_timeout=5.0
)

# Anti-entropy per-peer work: a couple of quick connect retries, a bounded
# per-peer cycle budget; past the budget the cycle checkpoints a resumable
# session instead of blocking the loop.
SYNC_PEER = RetryPolicy(
    first_delay=0.1,
    max_delay=1.0,
    jitter=0.2,
    attempts=2,
    op_timeout=30.0,
    op_deadline=120.0,
)

# Failure-detector probes: short timeout, declared down after ``attempts``
# consecutive misses, probing at ``first_delay`` cadence.
HEALTH_PROBE = RetryPolicy(
    first_delay=2.0, max_delay=2.0, jitter=0.0, attempts=2, op_timeout=1.0
)

# Replication publish: QoS-0 by design — one near-immediate retry for a
# transient transport hiccup, then drop and count (anti-entropy repairs).
REPLICATOR_PUBLISH = RetryPolicy(
    first_delay=0.05, max_delay=0.1, jitter=0.5, attempts=2, op_timeout=5.0
)

# Bootstrap snapshot fetch: per-chunk retries ride this backoff (the chunk
# offset is the checkpoint — a retried chunk refetches only itself, never
# the verified prefix); op_deadline bounds one donor's whole transfer, past
# which the session fails over to the next donor.
BOOTSTRAP_FETCH = RetryPolicy(
    first_delay=0.1,
    max_delay=2.0,
    jitter=0.2,
    attempts=4,
    op_timeout=30.0,
    op_deadline=600.0,
)

# Device dispatch guard (merklekv_tpu_torch.device.guard): ONE near-immediate
# retry when a device program call fails with an environment-classified
# error (backend RPC blip, transient tunnel reset) — a second failure
# escalates to the degradation ladder instead of retrying into a sick
# backend. Hangs are never retried: the abandoned executor already spent
# the dispatch deadline, and the pump's stall budget is the deadline, not
# a multiple of it.
DEVICE_DISPATCH = RetryPolicy(
    first_delay=0.05, max_delay=0.5, jitter=0.2, attempts=2, op_timeout=5.0
)

# Device-plane re-warm probe (degradation-ladder heal): escalating backoff
# between probes of a higher rung while the node serves from a degraded
# backend. First probe comes quickly (most faults are transient backend
# hiccups); a persistently sick device plane backs the probing off to once
# a minute so the probe dispatches themselves never become load.
DEVICE_HEAL = RetryPolicy(
    first_delay=2.0, max_delay=60.0, multiplier=2.0, jitter=0.2
)

# Overload shed (ERROR BUSY -> client.ServerBusyError): the server asked
# for backoff, so the first retry waits a real beat (not the near-
# immediate transport-hiccup retry) and the window stays bounded — a node
# still shedding after ~6 tries across a few seconds is genuinely
# overloaded, and the caller should surface that, not hammer it. NOT for
# ReadOnlyError: read-only means wait-for-recovery, and retrying it would
# just re-ask a node that already said it cannot.
SERVER_BUSY = RetryPolicy(
    first_delay=0.1, max_delay=1.0, jitter=0.3, attempts=6, op_timeout=5.0
)

# Stale partition map (ERROR MOVED -> client.MovedError): retry AFTER a
# map refresh + re-route, near-immediately — the condition heals the
# moment the fresh map arrives, and a handful of attempts bounds a
# cluster mid-rebalance. A caller that keeps getting MOVED past these
# attempts holds a map no reachable node agrees with — surface it.
# PartitionedClient implements this loop internally; use the policy for
# hand-rolled partition-aware callers.
PARTITION_MOVED = RetryPolicy(
    first_delay=0.05, max_delay=0.5, jitter=0.2, attempts=4, op_timeout=5.0
)


# The classification retry-driven callers pass as ``retry_on``: transient
# transport failures AND the server's explicit shed answer. ReadOnlyError
# is deliberately absent (see SERVER_BUSY above) — a read-only node asked
# callers to WAIT, not to hammer it.
from merklekv_tpu_torch.client import MovedError, ServerBusyError  # noqa: E402
# (no cycle: client.py only lazy-imports cluster.partmap inside methods)

RETRYABLE_ERRORS: tuple[type[BaseException], ...] = (OSError, ServerBusyError)

# For PARTITION-AWARE callers only: MovedError is retryable *after a map
# refresh + re-route* — plain callers without a routing table would just
# re-ask the same node and collect the same refusal, so it is deliberately
# NOT in RETRYABLE_ERRORS.
ROUTED_RETRYABLE_ERRORS: tuple[type[BaseException], ...] = (
    RETRYABLE_ERRORS + (MovedError,)
)
