"""Prometheus text-exposition exporter: ``/metrics`` + ``/healthz``.

A copy of ``merklekv_tpu/obs/exporter.py``, its imports pointed at the port's modules.

A lightweight per-node HTTP endpoint (stdlib ``http.server``, threading,
no dependencies) serving the whole observability surface in one scrape:

- registry **counters** -> ``mkv_<name>_total``;
- registry **histograms** -> ``_bucket``/``_sum``/``_count`` series; span
  histograms fold into one ``mkv_span_duration_seconds`` family labeled by
  span name;
- registry **gauges** -> ``mkv_<name>`` (dict-valued callbacks become
  labeled sample sets, e.g. per-peer health);
- **native STATS** (the C++ server's counter block) bridged into the same
  namespace as ``mkv_native_<name>``, including the command-latency
  histogram the native hot path records in lock-free atomic buckets.

Enabled with ``[observability] http_port`` or ``--metrics-port``; port 0
binds an ephemeral port (tests read ``exporter.port``).
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from merklekv_tpu_torch.obs.catalog import help_for
from merklekv_tpu_torch.obs.metrics import (
    BUCKET_BOUNDS,
    SIZE_SCALE,
    Metrics,
    get_metrics,
)

__all__ = ["MetricsExporter", "render_prometheus"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
# Native STATS histogram lines: cmd_latency_us_le_<bound|inf>:count
_NATIVE_BUCKET_RE = re.compile(r"^cmd_latency_us_le_(\d+|inf)$")
# Per-io-worker STATS lines (io_worker_<i>_<field>): folded into ONE
# labeled family per field instead of one family per worker index.
_IO_WORKER_RE = re.compile(r"^io_worker_(\d+)_([a-z_]+)$")
# field -> Prometheus kind for the labeled io-worker families.
_IO_WORKER_KINDS = {
    "connections": "gauge",
    "commands": "counter",
    "wakeups": "counter",
    "writev_calls": "counter",
    "writev_bytes": "counter",
    "accepts": "counter",
}


def _san(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _fmt(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf"
        return format(v, ".9g")
    return str(v)


def _render_histogram(
    out: list[str],
    family: str,
    labels: str,
    cumulative: list[tuple[float, int]],
    total_sum: float,
    total_count: int,
) -> None:
    """Append one histogram series (bucket/sum/count) under ``family``;
    ``labels`` is a pre-rendered 'k="v",' prefix (may be empty)."""
    for bound, cum in cumulative:
        le = "+Inf" if math.isinf(bound) else _fmt(float(bound))
        out.append(f'{family}_bucket{{{labels}le="{le}"}} {cum}')
    if labels:
        out.append(f"{family}_sum{{{labels[:-1]}}} {_fmt(total_sum)}")
        out.append(f"{family}_count{{{labels[:-1]}}} {total_count}")
    else:
        out.append(f"{family}_sum {_fmt(total_sum)}")
        out.append(f"{family}_count {total_count}")


def _native_histogram(stats: dict[str, str]) -> Optional[list[str]]:
    """Fold the native cmd_latency_us_le_* STATS lines into one Prometheus
    histogram (seconds). Returns None when the server predates them."""
    buckets: list[tuple[float, int]] = []
    for name, value in stats.items():
        m = _NATIVE_BUCKET_RE.match(name)
        if not m:
            continue
        bound = math.inf if m.group(1) == "inf" else int(m.group(1)) / 1e6
        try:
            buckets.append((bound, int(value)))
        except ValueError:
            continue
    if not buckets:
        return None
    buckets.sort(key=lambda b: b[0])
    out = [
        "# HELP mkv_native_cmd_latency_seconds "
        + help_for("native_cmd_latency", "histogram"),
        "# TYPE mkv_native_cmd_latency_seconds histogram",
    ]
    cum, cumulative = 0, []
    for bound, c in buckets:
        cum += c
        cumulative.append((bound, cum))
    try:
        total_sum = int(stats.get("cmd_latency_us_sum", "0")) / 1e6
        total_count = int(stats.get("cmd_latency_us_count", str(cum)))
    except ValueError:
        total_sum, total_count = 0.0, cum
    _render_histogram(
        out, "mkv_native_cmd_latency_seconds", "", cumulative,
        total_sum, total_count,
    )
    return out


def render_prometheus(
    registry: Optional[Metrics] = None,
    stats_text: Optional[str] = None,
) -> str:
    """The full ``/metrics`` payload. ``stats_text`` is the native STATS
    body (``name:value`` lines) to bridge; None skips the native section."""
    reg = registry if registry is not None else get_metrics()
    out: list[str] = []

    snap = reg.snapshot()
    for name in sorted(snap["counters"]):
        san = _san(name)
        # HELP + TYPE for EVERY family, text from the single catalog
        # (obs/catalog.py) — uncataloged names get a generated fallback so
        # no family ever scrapes bare.
        out.append(
            f"# HELP mkv_{san}_total {help_for(name, 'counter')}"
        )
        out.append(f"# TYPE mkv_{san}_total counter")
        out.append(f"mkv_{san}_total {snap['counters'][name]}")

    # Span histograms fold into ONE family labeled by span name; any other
    # histogram renders as its own family.
    span_hists = {
        n[len("span."):]: h
        for n, h in snap["histograms"].items()
        if n.startswith("span.")
    }
    if span_hists:
        out.append(
            "# HELP mkv_span_duration_seconds "
            + help_for("span_duration", "histogram")
        )
        out.append("# TYPE mkv_span_duration_seconds histogram")
        for sname in sorted(span_hists):
            h = span_hists[sname]
            cum, cumulative = 0, []
            for bound, c in zip(BUCKET_BOUNDS, h["counts"]):
                cum += c
                cumulative.append((bound, cum))
            cumulative.append((math.inf, cum + h["counts"][-1]))
            _render_histogram(
                out, "mkv_span_duration_seconds",
                f'span="{sname}",', cumulative, h["sum"], h["count"],
            )
    size_names = set(snap.get("size_histograms", ()))
    for name in sorted(snap["histograms"]):
        if name.startswith("span."):
            continue
        h = snap["histograms"][name]
        # Size/count histograms (observe_size) store values scaled by
        # SIZE_SCALE so the shared log2 buckets read as 2^i UNITS; render
        # them unitless with unit-valued bounds instead of `_seconds`.
        is_size = name in size_names
        scale = 1.0 / SIZE_SCALE if is_size else 1.0
        suffix = "" if is_size else "_seconds"
        family = f"mkv_{_san(name)}{suffix}"
        out.append(f"# HELP {family} {help_for(name, 'histogram')}")
        out.append(f"# TYPE {family} histogram")
        cum, cumulative = 0, []
        for bound, c in zip(BUCKET_BOUNDS, h["counts"]):
            cum += c
            cumulative.append((bound * scale, cum))
        cumulative.append((math.inf, cum + h["counts"][-1]))
        _render_histogram(
            out, family, "", cumulative, h["sum"] * scale, h["count"]
        )

    for name, g in sorted(reg.gauges_snapshot().items()):
        san = _san(name)
        # Gauge help comes from its registration (the owning subsystem);
        # the catalog fallback covers help-less registrations.
        out.append(
            f"# HELP mkv_{san} {g['help'] or help_for(name, 'gauge')}"
        )
        out.append(f"# TYPE mkv_{san} gauge")
        value = g["value"]
        if isinstance(value, dict):
            label = _san(g["label"] or "key")
            for lv in sorted(value):
                try:
                    num = float(value[lv])
                except (TypeError, ValueError):
                    continue
                escaped = str(lv).replace("\\", "\\\\").replace('"', '\\"')
                out.append(f'mkv_{san}{{{label}="{escaped}"}} {_fmt(num)}')
        else:
            try:
                out.append(f"mkv_{san} {_fmt(float(value))}")
            except (TypeError, ValueError):
                continue

    if stats_text:
        stats: dict[str, str] = {}
        for line in stats_text.splitlines():
            line = line.strip()
            if not line or line in ("STATS", "END"):
                continue
            name, _, value = line.partition(":")
            stats[name] = value
        hist_lines = _native_histogram(stats)
        if hist_lines:
            out.extend(hist_lines)
        # io plane: one labeled family per per-worker field
        # (mkv_native_io_worker_<field>{worker="i"}) instead of a family
        # per worker index — PromQL can sum/max across workers.
        io_fields: dict[str, dict[int, float]] = {}
        for name, value in stats.items():
            m = _IO_WORKER_RE.match(name)
            if m is None or m.group(2) not in _IO_WORKER_KINDS:
                continue
            try:
                io_fields.setdefault(m.group(2), {})[int(m.group(1))] = (
                    float(value)
                )
            except ValueError:
                continue
        for field in sorted(io_fields):
            kind = _IO_WORKER_KINDS[field]
            fam = f"mkv_native_io_worker_{field}"
            out.append(
                f"# HELP {fam} " + help_for(f"native.io_worker_{field}", kind)
            )
            out.append(f"# TYPE {fam} {kind}")
            for worker in sorted(io_fields[field]):
                out.append(
                    f'{fam}{{worker="{worker}"}} '
                    f"{_fmt(io_fields[field][worker])}"
                )
        for name in sorted(stats):
            if _NATIVE_BUCKET_RE.match(name) or name.startswith(
                "cmd_latency_us_"
            ):
                continue  # folded into the histogram above
            m = _IO_WORKER_RE.match(name)
            if m is not None and m.group(2) in _IO_WORKER_KINDS:
                continue  # folded into the labeled families above
            try:
                num = float(stats[name])
            except ValueError:
                continue  # human-readable lines (uptime "0d 0h ...") skip
            san = _san(name)
            if name.endswith(("_commands", "_connections")) or name in (
                "tombstone_evictions",
                "events_dropped",
                "pipeline_rejected",
                "serve_zero_copy",
                "serve_value_copies",
                "slab_allocs",
                "slab_alloc_failures",
            ):
                out.append(
                    f"# HELP mkv_native_{san} "
                    + help_for(f"native.{name}", "counter")
                )
                out.append(f"# TYPE mkv_native_{san} counter")
                out.append(f"mkv_native_{san} {_fmt(num)}")
            else:
                out.append(
                    f"# HELP mkv_native_{san} "
                    + help_for(f"native.{name}", "gauge")
                )
                out.append(f"# TYPE mkv_native_{san} gauge")
                out.append(f"mkv_native_{san} {_fmt(num)}")

    return "\n".join(out) + "\n"


class MetricsExporter:
    """Per-node HTTP exporter. ``stats_fn`` supplies the native STATS text
    at scrape time (None for registry-only export); ``health_fn`` supplies
    extra ``/healthz`` fields."""

    def __init__(
        self,
        port: int,
        host: str = "127.0.0.1",
        registry: Optional[Metrics] = None,
        stats_fn: Optional[Callable[[], str]] = None,
        health_fn: Optional[Callable[[], dict]] = None,
    ) -> None:
        self._registry = registry if registry is not None else get_metrics()
        self._stats_fn = stats_fn
        self._health_fn = health_fn
        self._started_unix = time.time()
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:  # quiet: no per-scrape spam
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                try:
                    if self.path.split("?", 1)[0] == "/metrics":
                        stats = None
                        if exporter._stats_fn is not None:
                            try:
                                stats = exporter._stats_fn()
                            except Exception:
                                stats = None  # scrape survives a dead engine
                        body = render_prometheus(
                            exporter._registry, stats
                        ).encode()
                        self._reply(
                            200, body,
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                        return
                    if self.path.split("?", 1)[0] == "/healthz":
                        payload = {
                            "status": "ok",
                            "uptime_s": round(
                                time.time() - exporter._started_unix, 1
                            ),
                        }
                        if exporter._health_fn is not None:
                            try:
                                payload.update(exporter._health_fn())
                            except Exception:
                                pass
                        self._reply(
                            200, (json.dumps(payload) + "\n").encode(),
                            "application/json",
                        )
                        return
                    self._reply(404, b"not found\n", "text/plain")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # scraper hung up mid-reply

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "MetricsExporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.2},
                daemon=True,
                name="mkv-metrics-exporter",
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
