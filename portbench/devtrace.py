"""The traced run's profiler session over a steady sub-window of the window.

``Tracer.tick`` is called from the thread that drives the window, often:
it starts ``torch.profiler`` once the sub-window opens and stops it once it
closes, on that same thread (a stop from another thread crashes). The trace
is written under ``TMPDIR`` after the window, read and deleted. What it
yields, per card:
busy seconds (the union of kernel, copy and set intervals inside the
sub-window), kernel seconds and launches by name, and the idle gaps with
what the driving thread was doing meanwhile. A session in which no kernel
was recorded (torch.profiler keeps no record of about one short session in
200 on the card) is measured again later in the window.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MARK = "portbench.traced_window"
# The session opens a quarter into the window and lasts 3 s (at most 30%
# of the window): steady, and a trace of some tens of MB.
START_FRAC = 0.25
LENGTH_S = 3.0


class Tracer:
    def __init__(self, enabled: bool, window_s: float) -> None:
        self.enabled = enabled
        self.window_s = window_s
        self.length_s = min(LENGTH_S, window_s * 0.3)
        self.sessions = 0
        self.result: Optional[dict] = None
        self._t0: Optional[float] = None
        self._prof = None
        self._kept = None
        self._mark = None
        self._open_at = 0.0
        self._stop_at = 0.0

    def prime(self) -> None:
        """One empty session, in set-up, so that the profiler's first start
        (seconds) does not fall inside the window."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.cuda.synchronize()

    def begin(self, t0: float) -> None:
        """The window opened at ``t0`` (perf_counter seconds)."""
        self._t0 = t0
        self._open_at = t0 + START_FRAC * self.window_s

    def tick(self, now: float) -> None:
        if not self.enabled or self._kept is not None or self._t0 is None or self.sessions >= 2:
            return
        if self._prof is None and now >= self._open_at:
            self._start()
            # The session runs length_s from when it is running: starting
            # the profiler takes seconds the first time in a process.
            self._stop_at = time.perf_counter() + self.length_s
        elif self._prof is not None and now >= self._stop_at:
            self._stop()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()

    def _stop(self) -> None:
        """End the session. Only whether it recorded a kernel is read now;
        the trace is written and read after the window (``close``)."""
        from torch.autograd import DeviceType

        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        self.sessions += 1
        if any(ev.device_type == DeviceType.CUDA for ev in prof.events()):
            self._kept = prof
        elif self.sessions < 2:
            # No kernel recorded: measure again, later in the window.
            self._open_at = max(self._stop_at, self._t0 + 0.6 * self.window_s)

    def close(self) -> None:
        """The window closed: end a session still open, then read the kept
        one."""
        if self._prof is not None:
            self._stop()
        if self._kept is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            self._kept.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._kept = None
        self.result = summarize(events)


def _union(intervals: list, lo: float, hi: float) -> tuple[float, list]:
    """Total length of the union of (start, end) clipped to [lo, hi], and
    the merged intervals."""
    merged: list = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def summarize(events: list) -> Optional[dict]:
    """Per-card busy and idle of a chrome trace from torch.profiler, inside
    the span of the ``MARK`` annotation."""
    # The host's annotation (the device side repeats it as a
    # gpu_user_annotation over the kernels it covers).
    marks = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    mark = max(marks, key=lambda e: float(e["dur"]))
    lo = float(mark["ts"])
    hi = lo + float(mark["dur"])
    mark_tid = mark.get("tid")
    dev_iv: dict = collections.defaultdict(list)
    kernels: dict = collections.defaultdict(lambda: [0.0, 0])
    host: list = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            if s + d <= lo or s >= hi:
                continue
            dev = int(e.get("args", {}).get("device", 0))
            dev_iv[dev].append((s, s + d))
            if cat == "kernel":
                k = kernels[(dev, e["name"])]
                k[0] += (min(s + d, hi) - max(s, lo)) / 1e6
                k[1] += 1
        elif cat in HOST_CATS and e.get("tid") == mark_tid and e.get("name") != MARK:
            host.append((s, s + d, e["name"]))
    window = (hi - lo) / 1e6
    cards = {}
    host.sort()
    starts = [h[0] for h in host]
    for dev, iv in sorted(dev_iv.items()):
        busy, merged = _union(iv, lo, hi)
        gaps = []
        edges = [lo] + [x for m in merged for x in m] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b, _host_at(host, starts, (a + b) / 2)))
        cards[dev] = {"busy_s": busy / 1e6, "gaps": gaps}
    return {"window_s": window, "cards": cards,
            "kernels": {key: tuple(v) for key, v in kernels.items()}}


def _host_at(host: list, starts: list, t: float) -> str:
    """The innermost host op of the driving thread that covers time ``t``."""
    best = None
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - 256):i]):
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "no traced op of the driving thread"


def kernel_stats(summary: dict, needle: str) -> tuple[float, int]:
    """(device seconds, launches) of kernels whose name contains
    ``needle``, over every card."""
    secs, count = 0.0, 0
    for (_dev, name), (s, c) in summary["kernels"].items():
        if needle in name:
            secs += s
            count += c
    return secs, count


def breakdown(summary: dict) -> dict:
    """The ten kernels that took most device time and the ten largest
    totals of idle time by what the driving thread was doing."""
    ops: dict = collections.defaultdict(float)
    for (_dev, name), (s, _c) in summary["kernels"].items():
        ops[name[:160]] += s
    idle: dict = collections.defaultdict(lambda: [0.0, 0, 0.0])
    for card in summary["cards"].values():
        for a, b, what in card["gaps"]:
            g = idle[what[:120]]
            g[0] += (b - a) / 1e6
            g[1] += 1
            g[2] = max(g[2], (b - a) / 1e6)
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "device_ops": [[name, s] for name, s in top_ops],
        "idle_gaps": [[f"{what} ({n} gaps, longest {1e3 * m:.4f} ms)", s]
                      for what, (s, n, m) in top_idle],
    }
