"""Metrics core: counters, fixed-log-bucket histograms, callback gauges
(copy of ``merklekv_tpu/obs/metrics.py``).

The port's process-wide registry, separate from the JAX package's: the
guard, the ladder, the serving tree and the mirror of
``merklekv_tpu_torch`` bump it (``device.*`` names, as in the JAX package).
Design constraints, in order:

- **hot-path cheap**: a counter bump or histogram observation is one lock
  acquire + O(1) integer work — no allocation, no string formatting.
- **percentiles without reservoirs**: histograms use fixed log2 buckets
  (1 µs .. ~33 s), so p50/p90/p99/max are derivable from bucket counts at
  read time and two scrapes can be subtracted to get windowed quantiles.
- **gauges are callbacks**: the registry never caches a live value — each
  scrape reads it, and a failing callback drops that gauge from the
  scrape, never the scrape itself.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional, Union

__all__ = [
    "BUCKET_BOUNDS",
    "bucket_index",
    "Histogram",
    "Metrics",
    "get_metrics",
]

# Histogram bucket upper bounds in SECONDS: 1 µs * 2^i. 26 bounds cover
# 1 µs .. ~33.5 s; anything slower lands in the +Inf overflow bucket.
# Powers of two keep bucket_index a cheap log2 and make the native
# command-latency histogram (stats.h, µs buckets) line up bound-for-bound.
BUCKET_BOUNDS: tuple[float, ...] = tuple(1e-6 * (1 << i) for i in range(26))

# Size/count histograms (batch sizes, row counts) reuse the same log2
# machinery by storing observations scaled by SIZE_SCALE: bound i then
# reads as 2^i UNITS (1, 2, 4, ... ~33.5M). Consumers (the exporter, the
# bench JSON) multiply bounds/sums back by 1/SIZE_SCALE.
SIZE_SCALE = 1e-6


def bucket_index(seconds: float) -> int:
    """Index of the first bound >= ``seconds`` (len(BUCKET_BOUNDS) for the
    +Inf overflow bucket). Negative/zero observations land in bucket 0."""
    if seconds <= BUCKET_BOUNDS[0]:
        return 0
    if seconds > BUCKET_BOUNDS[-1]:
        return len(BUCKET_BOUNDS)
    # ceil(log2(v / 1µs)); float error at exact bounds is corrected below.
    i = max(0, math.ceil(math.log2(seconds * 1e6)))
    while i > 0 and seconds <= BUCKET_BOUNDS[i - 1]:
        i -= 1
    while i < len(BUCKET_BOUNDS) and seconds > BUCKET_BOUNDS[i]:
        i += 1
    return i


class Histogram:
    """Fixed-log-bucket latency histogram (thread-safe).

    Buckets are non-cumulative internally; ``snapshot()`` returns raw
    counts, ``cumulative()`` the Prometheus ``le`` view, ``quantile(q)``
    the upper bound of the bucket holding the q-th observation — an upper
    estimate, within one power of two of the true value by construction.
    """

    __slots__ = ("_mu", "_counts", "_sum", "_count", "_max")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    def observe(self, seconds: float) -> None:
        i = bucket_index(seconds)
        with self._mu:
            self._counts[i] += 1
            self._sum += seconds
            self._count += 1
            if seconds > self._max:
                self._max = seconds

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
                "max": self._max,
            }

    def cumulative(self) -> list[tuple[float, int]]:
        """(le_bound_seconds, cumulative_count) pairs; the final pair is
        (inf, total)."""
        snap = self.snapshot()
        out, running = [], 0
        for bound, c in zip(BUCKET_BOUNDS, snap["counts"]):
            running += c
            out.append((bound, running))
        out.append((math.inf, running + snap["counts"][-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket containing the q-th observation, or
        None when empty. q in [0, 1]."""
        snap = self.snapshot()
        if snap["count"] == 0:
            return None
        rank = max(1, math.ceil(q * snap["count"]))
        running = 0
        for bound, c in zip(BUCKET_BOUNDS, snap["counts"]):
            running += c
            if running >= rank:
                return bound
        return snap["max"]  # overflow bucket: report the observed max


# A gauge callback returns a number, or a {label_value: number} dict for a
# labeled gauge family (e.g. per-peer health).
GaugeFn = Callable[[], Union[int, float, dict]]


class Metrics:
    """Process-wide registry: counters + span aggregates + histograms +
    gauges. The counter/span surface is unchanged from the pre-obs
    ``utils.tracing.Metrics`` (tests and the METRICS wire verb depend on
    ``snapshot()['counters']`` / ``['spans']``); histograms and gauges are
    additive."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._counters: dict[str, int] = {}
        self._span_count: dict[str, int] = {}
        self._span_total_s: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}
        self._size_names: set[str] = set()
        self._gauges: dict[str, tuple[GaugeFn, str, str]] = {}

    # -- counters -----------------------------------------------------------
    def inc(self, name: str, delta: int = 1) -> None:
        with self._mu:
            self._counters[name] = self._counters.get(name, 0) + delta

    # -- histograms ---------------------------------------------------------
    def histogram(self, name: str) -> Histogram:
        """Get-or-create; the Histogram has its own lock, so observation
        after the first lookup never touches the registry lock."""
        with self._mu:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    def observe(self, name: str, seconds: float) -> None:
        self.histogram(name).observe(seconds)

    def observe_size(self, name: str, units: float) -> None:
        """Size/count observation (e.g. replication batch size): same log2
        buckets, bound i = 2^i units. The name is tagged so the exporter
        renders the family unitless (``mkv_<name>``) with unit-valued
        bounds instead of a ``_seconds`` family."""
        with self._mu:
            self._size_names.add(name)
        self.histogram(name).observe(units * SIZE_SCALE)

    def is_size_histogram(self, name: str) -> bool:
        with self._mu:
            return name in self._size_names

    def observe_span(self, name: str, seconds: float) -> None:
        """Span aggregate (count + total) AND the span's latency histogram —
        every span() site gets percentile-capable buckets for free."""
        with self._mu:
            self._span_count[name] = self._span_count.get(name, 0) + 1
            self._span_total_s[name] = (
                self._span_total_s.get(name, 0.0) + seconds
            )
        self.histogram(f"span.{name}").observe(seconds)

    # -- gauges -------------------------------------------------------------
    def register_gauge(
        self, name: str, fn: GaugeFn, help: str = "", label: str = ""
    ) -> None:
        """Register (or replace) a callback gauge. ``label`` names the
        label key when ``fn`` returns a dict (one sample per entry)."""
        with self._mu:
            self._gauges[name] = (fn, help, label)

    def unregister_gauge(self, name: str, fn: Optional[GaugeFn] = None) -> None:
        """Remove a gauge. With ``fn`` given, remove only if the current
        registration IS that callback — so a stopped node cannot strip a
        successor node's same-named gauge (registration is last-wins)."""
        with self._mu:
            cur = self._gauges.get(name)
            if cur is None:
                return
            if fn is None or cur[0] is fn:
                self._gauges.pop(name, None)

    def gauges_snapshot(self) -> dict:
        """{name: {"value": num | {label: num}, "help": str, "label": str}}
        — each callback invoked now; a failing callback drops ITS gauge
        from this snapshot, never the snapshot itself."""
        with self._mu:
            gauges = dict(self._gauges)
        out = {}
        for name, (fn, help_, label) in gauges.items():
            try:
                out[name] = {"value": fn(), "help": help_, "label": label}
            except Exception:
                continue
        return out

    # -- snapshots ----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._mu:
            snap = {
                "counters": dict(self._counters),
                "spans": {
                    name: {
                        "count": self._span_count[name],
                        "total_s": round(self._span_total_s[name], 6),
                        "avg_s": round(
                            self._span_total_s[name] / self._span_count[name],
                            6,
                        ),
                    }
                    for name in self._span_count
                },
            }
            hists = dict(self._histograms)
            snap["size_histograms"] = sorted(self._size_names)
        snap["histograms"] = {
            name: h.snapshot() for name, h in hists.items()
        }
        return snap

    def reset(self) -> None:
        """Clear counters/spans/histograms. Gauges survive: they are live
        callbacks owned by running subsystems, not accumulated state."""
        with self._mu:
            self._counters.clear()
            self._span_count.clear()
            self._span_total_s.clear()
            self._histograms.clear()
            self._size_names.clear()


_metrics = Metrics()


def get_metrics() -> Metrics:
    return _metrics
