"""The benchmark's run of one cell: set-up, the measured window, the traced
sub-window and the layer readers, the check against the plain reference,
and the one result line.

Everything that belongs to one cell lives in files of its own, found by
the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the ``file`` of the configuration): its sizes;
- ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names the
  general generator ``traffic/<driver>.py`` that runs it;
- ``layers/<metric>.py``: the reader of one per-layer metric.

A driver module defines ``Cell(ctx)`` with ``setup()``, ``window(tracer)``
(returns the window's end-to-end numbers), ``facts`` and ``probes`` (what
the readers read), ``release()`` (frees the program's state, keeps what it
answered) and ``check()`` (the comparison with the reference: a list of
``(name, value, limit)``, correct when every value is within its limit).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from portbench import devtrace, roofline

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "merklekv_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_start_s() -> float:
    """perf_counter reading of this process's start (Linux /proc)."""
    import os

    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - max(0.0, age)


def load_bench(root: Path = ROOT, pending: bool = False) -> dict:
    """BENCHMARK.json; with ``pending``, also the entries of
    ``portbench/pending.json``: cells proven correct but held to no bound
    yet, which only the tools and the tests run."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    if pending:
        with open(HERE / "pending.json") as f:
            extra = json.load(f)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + extra[key]
    return bench


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


class Ctx:
    """What a driver is given: the cell, its configuration and traffic, the
    seed, the window's length, and the devices it runs on."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float, trace: bool,
                 devices: list, overrides: Optional[dict] = None) -> None:
        self.cell = find(bench["workloads"], workload, "workload")
        cfg_entry = find(bench["configs"], self.cell["config"], "configuration")
        with open(ROOT / cfg_entry["file"]) as f:
            self.config = json.load(f)
        with open(HERE / "traffic" / f"{self.cell['traffic']}.json") as f:
            self.mix = json.load(f)
        for key, value in (overrides or {}).items():
            if key in self.mix:
                self.mix[key] = value
            elif key in self.config:
                self.config[key] = value
            else:
                raise KeyError(f"override {key!r} is in neither the traffic mix nor the configuration")
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.devices = devices
        self.log = log


def load_driver(ctx: Ctx):
    mod = importlib.import_module(f"portbench.traffic.{ctx.mix['driver']}")
    return mod.Cell(ctx)


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_layer_{name}",
                                                  HERE / "layers" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, kind: str, workload: str) -> list:
    """The metrics of ``kind`` this cell reports: those whose ``workloads``
    names it, or every cell that reports what they move."""
    out = []
    e2e_here = {m["name"] for m in metrics_of_e2e(bench, workload)}
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e_here:
            out.append(m)
    return out


def metrics_of_e2e(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]


class Readings:
    """What a per-layer reader reads: the trace summary (None when no
    session recorded a kernel), the driver's facts and probes, the config."""

    def __init__(self, ctx: Ctx, summary: Optional[dict], facts: dict, probes: dict) -> None:
        self.ctx = ctx
        self.summary = summary
        self.facts = facts
        self.probes = probes
        self.roofline = roofline

    def event_s(self, fn, device, reps: int = 5) -> float:
        """Device seconds per call of ``fn`` on ``device``: CUDA events around
        ``reps`` back-to-back calls, after one call that warms up."""
        fn()
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps


def device_info(devices: list, summary: Optional[dict]) -> dict:
    cuda = [d for d in devices if d.type == "cuda"]
    if cuda:
        kind = torch.cuda.get_device_name(cuda[0])
        peak = max(torch.cuda.max_memory_allocated(d) for d in cuda)
        info = {"platform": "gpu", "kind": kind, "count": len(cuda), "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": len(devices), "memory_peak_bytes": 0}
    if summary is not None:
        cards = [summary["cards"].get(i, {"busy_s": 0.0}) for i in range(len(devices))]
        info["busy_s"] = sum(c["busy_s"] for c in cards) / len(cards)
        info["window_s"] = summary["window_s"]
    return info


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, devices: list,
             overrides: Optional[dict] = None, bench: Optional[dict] = None,
             t_start: Optional[float] = None, control: Optional[str] = None,
             facts: bool = False) -> dict:
    """One run of one cell; returns the result line as a dict. ``control``
    names a control (``traffic/<driver>.py``'s ``CONTROLS``) to put in the
    program's place: the benchmark's own runs never pass it."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_bench() if bench is None else bench
    ctx = Ctx(bench, workload, seed, seconds, trace, devices, overrides)
    cell = load_driver(ctx)
    if control is not None:
        cell.use_control(control)
    for d in devices:
        if d.type == "cuda":
            torch.empty(0, device=d)  # the context, before its statistics
            torch.cuda.reset_peak_memory_stats(d)
    tracer = devtrace.Tracer(trace and devices[0].type == "cuda", ctx.seconds)
    cell.setup()
    tracer.prime()
    out = cell.window(tracer)
    tracer.close()
    setup_s = out["t0"] - t_start
    wanted_e2e = metrics_of_e2e(bench, workload)
    metrics = {}
    breakdown = None
    summary = tracer.result
    device = device_info(devices, summary)
    if trace:
        # A CPU run times nothing: no device metric comes from it.
        probes = cell.probes if devices[0].type == "cuda" else {}
        readings = Readings(ctx, summary, cell.facts, probes)
        for m in metrics_of(bench, "per_layer", workload):
            value = load_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            breakdown = devtrace.breakdown(summary)
        # The probes hold the program's tensors: let them go before the check.
        del readings, probes
    else:
        for m in wanted_e2e:
            value = setup_s if m["name"] == "setup_s" else out["metrics"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.release()
    checks = cell.check()
    correct = all(math.isfinite(v) and v <= lim for _n, v, lim in checks)
    for line in roofline.gpu_lines() if devices[0].type == "cuda" else ["cpu"]:
        log(f"[card] {line}")
    for name, value, limit in checks:
        log(f"check {name} = {value} (limit {limit})")
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if facts:
        result["facts"] = cell.facts.get("summary", {})
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result


def main(argv: Optional[list] = None, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_bench()
    cell = find(bench["workloads"], args.workload, "workload")
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"cell {args.workload} needs {chips} CUDA card(s); this machine has {have}")
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), devices,
                      bench=bench, t_start=t_start)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
