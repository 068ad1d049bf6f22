"""Router-side read cache with memcached-style fill leases.

A copy of ``merklekv_tpu/requestplane/cache.py``, its imports pointed at the port's modules.

The request plane's hot-key shield: a GET miss hands out ONE lease per
key, so under a thundering herd exactly one fill crosses to the owning
partition and every concurrent reader waits on the in-flight answer
instead of stampeding the backend (the memcached "lease"
design). Entries are dropped three ways, in strictness order:

- **event-driven** — the invalidation feed (invalidation.py) applies the
  replication envelope's key events the moment the owning partition
  publishes a write;
- **gap flush** — a detected ``hseq`` gap (missed frames) flushes the
  whole partition's entries, because we no longer know WHICH keys went
  stale;
- **hard max-age** — every entry expires ``max_age_ms`` after its fill
  regardless, which is the documented worst-case staleness bound for the
  undetectable window (frames lost with no successor frame to expose the
  gap; QoS-0 anti-entropy residue).

Thread-safety: one lock around the table; waiter callbacks returned by
``finish_fill``/stolen leases are invoked by the CALLER outside the lock
(the router wraps each waiter in a cross-worker ``post``), so a slow
client can never hold the cache hostage.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from merklekv_tpu_torch.utils.tracing import get_metrics

__all__ = ["LeaseCache", "MISS", "WAIT", "LEAD"]

# begin_get outcomes (identity sentinels, never equal to a cached value).
MISS = object()  # caller must fill (no cache / uncacheable)
WAIT = object()  # another fill is in flight; the waiter was enqueued
LEAD = object()  # caller holds the fill lease


class _Entry:
    __slots__ = ("value", "pid", "filled_mono", "nbytes")

    def __init__(self, value: str, pid: int, nbytes: int) -> None:
        self.value = value
        self.pid = pid
        self.filled_mono = time.monotonic()
        self.nbytes = nbytes


class _Lease:
    __slots__ = ("pid", "started_mono", "waiters")

    def __init__(self, pid: int) -> None:
        self.pid = pid
        self.started_mono = time.monotonic()
        self.waiters: list[Callable] = []


class LeaseCache:
    """LRU byte-budgeted read cache + per-key fill leases.

    A waiter is any callable ``waiter(value, age_ms, error)`` — the router
    passes closures that post the completion back to the waiting
    connection's owning worker. ``value is None`` with ``error is None``
    means a clean NOT_FOUND (valid answer, not cached).
    """

    def __init__(
        self,
        max_bytes: int,
        max_age_ms: float = 2000.0,
        lease_timeout_ms: float = 5000.0,
    ) -> None:
        if max_bytes <= 0:
            raise ValueError("LeaseCache needs a positive byte budget")
        self.max_bytes = max_bytes
        self.max_age_ms = max_age_ms
        self.lease_timeout_ms = lease_timeout_ms
        self._mu = threading.Lock()
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._leases: dict[str, _Lease] = {}
        self._bytes = 0

    # -- stats (gauge callbacks) --------------------------------------------
    @property
    def bytes_used(self) -> int:
        with self._mu:
            return self._bytes

    @property
    def keys(self) -> int:
        with self._mu:
            return len(self._entries)

    @property
    def leases_inflight(self) -> int:
        with self._mu:
            return len(self._leases)

    # -- read path -----------------------------------------------------------
    def begin_get(self, key: str, pid: int, waiter: Callable):
        """One atomic step of the lease protocol. Returns either
        ``(value, age_ms)`` on a hit, or one of the sentinels:

        - ``LEAD``: the caller now owns the fill lease — it MUST later
          call :meth:`finish_fill` (success, NOT_FOUND, or error), or the
          lease is only reclaimed by timeout steal.
        - ``WAIT``: a fill is already in flight; ``waiter`` was enqueued
          and will be invoked by the filler.
        """
        m = get_metrics()
        now = time.monotonic()
        with self._mu:
            e = self._entries.get(key)
            if e is not None:
                age_ms = (now - e.filled_mono) * 1000.0
                if age_ms <= self.max_age_ms:
                    self._entries.move_to_end(key)
                    m.inc("router.cache_hits")
                    return (e.value, age_ms)
                # Hard bound lapsed: the entry may be arbitrarily stale
                # (lost invalidation window) — treat as a miss.
                self._drop_locked(key, e)
                m.inc("router.cache_expired")
            lease = self._leases.get(key)
            if lease is not None:
                if (now - lease.started_mono) * 1000.0 > self.lease_timeout_ms:
                    # The old filler is presumed dead (hung upstream, lost
                    # continuation): steal the lease, keep its waiters —
                    # OUR fill will answer them.
                    lease.started_mono = now
                    lease.pid = pid
                    m.inc("router.lease_timeouts")
                    return LEAD
                lease.waiters.append(waiter)
                m.inc("router.lease_waits")
                return WAIT
            self._leases[key] = _Lease(pid)
            m.inc("router.cache_misses")
            m.inc("router.lease_grants")
            return LEAD

    def finish_fill(
        self,
        key: str,
        value: Optional[str],
        pid: int,
        error: Optional[str] = None,
    ) -> list[Callable]:
        """Complete a fill: cache the value (when clean and found), release
        the lease, and return the waiter callbacks for the CALLER to
        invoke (outside the lock) as ``waiter(value, 0.0, error)``."""
        m = get_metrics()
        with self._mu:
            lease = self._leases.pop(key, None)
            waiters = lease.waiters if lease is not None else []
            if error is None and value is not None:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._bytes -= old.nbytes
                nbytes = len(key) + len(value) + 96  # entry overhead guess
                self._entries[key] = _Entry(value, pid, nbytes)
                self._bytes += nbytes
                m.inc("router.cache_fills")
                while self._bytes > self.max_bytes and self._entries:
                    k, e = self._entries.popitem(last=False)
                    self._bytes -= e.nbytes
                    m.inc("router.cache_evictions")
        if error is not None:
            get_metrics().inc("router.lease_failures")
        return waiters

    # -- invalidation --------------------------------------------------------
    def invalidate(self, key: str) -> bool:
        with self._mu:
            e = self._entries.pop(key, None)
            if e is None:
                return False
            self._bytes -= e.nbytes
        get_metrics().inc("router.cache_invalidations")
        return True

    def flush_partition(self, pid: int) -> int:
        with self._mu:
            doomed = [k for k, e in self._entries.items() if e.pid == pid]
            for k in doomed:
                self._bytes -= self._entries.pop(k).nbytes
        if doomed:
            get_metrics().inc("router.cache_invalidations", len(doomed))
        return len(doomed)

    def clear(self) -> int:
        """Drop every entry (map epoch flip: partition ids renumber, so
        per-entry pids are meaningless). Leases survive — their fills
        complete against the new map."""
        with self._mu:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
        if n:
            get_metrics().inc("router.cache_invalidations", n)
        return n

    def _drop_locked(self, key: str, e: _Entry) -> None:
        del self._entries[key]
        self._bytes -= e.nbytes
