"""The readers of the program's device spans (``portbench/spans.py`` and
``layers/{leaf,levels,diff,between}_ms.ae.py``): their arithmetic on
synthetic records, None where nothing is there, and a whole CPU run of the
cycle cell, to show that only the traced sub-window's session records
spans (none in set-up, none from the readers or the check)."""

import time

import pytest
import torch

from portbench import devtrace, harness, spans

CPU = torch.device("cpu")
AE_SMALL = {"keys": 2048, "warmup_cycles": 1}
# Under a profiler session every op of the plain versions is recorded: one
# block a leaf and few keys keep the traced run short.
AE_TINY = {"keys": 64, "value_bytes": 8, "warmup_cycles": 1}
READERS = {"leaf_ms.ae": "ae.leaf", "levels_ms.ae": "ae.levels", "diff_ms.ae": "ae.diff"}


class _Ctx:
    def __init__(self):
        self.lines = []
        self.devices = [CPU]

    def log(self, msg):
        self.lines.append(msg)


class _R:
    def __init__(self):
        self.ctx = _Ctx()


def _records(cycles, session=1, ident=0):
    """Records as the program gives them: ``cycles`` is a list of
    (between_ms, {card: {phase: ms}}); a phase ms of None is unresolved."""
    out = []
    for between, cards in cycles:
        ident += 1
        root = ident
        out.append({"name": "ae.cycle", "id": root, "parent": None, "root": root,
                    "session": session, "device": 0,
                    "host_ns": (root * 10**6, root * 10**6 + 5), "cycle": None,
                    "device_ms": 30.0, "between_ms": between})
        for card, phases in cards.items():
            for name, ms in phases.items():
                for part in (ms if isinstance(ms, list) else [ms]):
                    ident += 1
                    out.append({"name": name, "id": ident, "parent": root, "root": root,
                                "session": session, "device": card, "host_ns": (1, 2),
                                "cycle": None, "device_ms": part, "between_ms": None})
    return out


def _read(name):
    r = _R()
    return harness.load_reader(name)(r), r.ctx.lines


def test_readers_take_the_median_of_the_slowest_card(monkeypatch):
    recs = _records([
        (0.5, {0: {"ae.leaf": 10.0, "ae.levels": 1.0, "ae.diff": 7.0},
               1: {"ae.leaf": 12.0, "ae.levels": 2.0, "ae.diff": 6.0}}),
        (0.3, {0: {"ae.leaf": 11.0, "ae.levels": 1.5, "ae.diff": 8.0},
               1: {"ae.leaf": 9.0, "ae.levels": [1.0, 0.75], "ae.diff": 5.0}}),
        (None, {0: {"ae.leaf": 14.0, "ae.levels": 1.2, "ae.diff": 7.5},
                1: {"ae.leaf": 10.0, "ae.levels": 1.1, "ae.diff": 7.9}}),
        # Not complete: one phase unresolved. Left out of every reader.
        (0.1, {0: {"ae.leaf": 99.0, "ae.levels": 99.0, "ae.diff": None}}),
    ])
    # A cycle whose root the ring dropped: its phases alone are left out too.
    recs += [
        {"name": "ae.leaf", "id": 900, "parent": 899, "root": 899, "session": 1, "device": 0,
         "host_ns": (1, 2), "cycle": None, "device_ms": 50.0, "between_ms": None}]
    monkeypatch.setattr(spans, "records", lambda: recs)
    want = {"leaf_ms.ae": 12.0, "levels_ms.ae": 1.75, "diff_ms.ae": 7.9}
    for name, phase in READERS.items():
        value, lines = _read(name)
        assert value == pytest.approx(want[name]), name
        assert len(lines) == 2 and all(phase in line and "3 cycles" in line for line in lines)
    value, lines = _read("between_ms.ae")
    assert value == pytest.approx(0.4)
    assert "2 cycles" in lines[0] and "ae.cycle 3 cycles" in lines[1]
    assert "host period of the 3 traced cycles" in lines[2]


def test_readers_take_the_newest_session_alone(monkeypatch):
    """A tracer that records twice keeps the second session's trace: the
    first session's cycles are left out."""
    old = _records([(0.9, {0: {"ae.leaf": 20.0, "ae.levels": 3.0, "ae.diff": 9.0}})] * 5)
    new = _records([(0.5, {0: {"ae.leaf": 13.0, "ae.levels": 1.5, "ae.diff": 8.0}}),
                    (None, {0: {"ae.leaf": 14.0, "ae.levels": 1.4, "ae.diff": 8.2}})],
                   session=2, ident=100)
    monkeypatch.setattr(spans, "records", lambda: old + new)
    want = {"leaf_ms.ae": 13.5, "levels_ms.ae": 1.45, "diff_ms.ae": 8.1, "between_ms.ae": 0.5}
    for name, value in want.items():
        got, lines = _read(name)
        assert got == pytest.approx(value), name
        assert "2 cycles" in lines[-1] if name != "between_ms.ae" else "1 cycles" in lines[0]


def test_readers_return_none_on_an_empty_ring(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: [])
    for name in [*READERS, "between_ms.ae"]:
        assert _read(name) == (None, [])
    # CPU records: no device times, so no complete cycle.
    recs = _records([(None, {0: {"ae.leaf": None, "ae.levels": None, "ae.diff": None}})])
    recs[0]["device_ms"] = None
    monkeypatch.setattr(spans, "records", lambda: recs)
    for name in [*READERS, "between_ms.ae"]:
        assert _read(name) == (None, [])


def test_readers_find_nothing_in_a_program_without_device_spans(monkeypatch):
    from merklekv_tpu_torch.utils import tracing

    monkeypatch.delattr(tracing, "device_spans")
    assert spans.records() == []
    assert _read("leaf_ms.ae") == (None, [])


def test_an_untraced_cpu_run_records_no_span():
    from merklekv_tpu_torch.utils import tracing

    tracing.clear_device_spans()
    r = harness.run_cell("ae10m-r8.cycle", 3_000_000_019, 1.0, False, [CPU], overrides=AE_SMALL)
    assert r["correct"]
    assert tracing.device_spans() == []


def test_only_the_traced_sub_window_records_spans(monkeypatch):
    """The cell's whole traced run on the CPU, with the tracer's sessions
    forced on (torch.profiler on the driving thread, as on the card): every
    recorded span lies inside a session, none in set-up (warm-up cycles,
    the priming session) or after it (readers, check)."""
    from merklekv_tpu_torch.utils import tracing

    sessions = []

    class Forced(devtrace.Tracer):
        def __init__(self, enabled, window_s):
            super().__init__(True, window_s)

        def prime(self):
            super().prime()
            sessions.append(("prime", len(tracing.device_spans())))

        def _start(self):
            sessions.append([time.perf_counter_ns(), None])
            super()._start()

        def _stop(self):
            super()._stop()
            sessions[-1][1] = time.perf_counter_ns()

    monkeypatch.setattr(devtrace, "Tracer", Forced)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    # The tracer lists a session's events only to look for a kernel, which
    # a CPU session never has; listing the plain versions' ops takes long.
    monkeypatch.setattr(torch.profiler.profile, "events", lambda self: [])
    tracing.clear_device_spans()
    r = harness.run_cell("ae10m-r8.cycle", 3_000_000_023, 2.0, True, [CPU], overrides=AE_TINY)
    assert r["correct"]
    assert sessions[0] == ("prime", 0)
    windows = [tuple(s) for s in sessions[1:]]
    assert windows and all(a < b for a, b in windows)
    recs = tracing.device_spans()
    tracing.clear_device_spans()
    cycles = [rec for rec in recs if rec["name"] == "ae.cycle"]
    assert cycles and len(recs) == 4 * len(cycles)
    for rec in recs:
        assert any(a <= rec["host_ns"][0] and rec["host_ns"][1] <= b for a, b in windows), rec
    # A CPU session lists no kernel, so the tracer records a second time;
    # each recording that held a cycle is a session of its own.
    assert len(windows) == 2
    numbers = [{rec["session"] for rec in recs if a <= rec["host_ns"][0] <= b} for a, b in windows]
    assert all(len(n) <= 1 for n in numbers) and len(numbers[0]) == 1
    assert not numbers[0] & numbers[1]
    # No device times on the CPU: the readers report nothing.
    assert not set(r["metrics"]) & {"leaf_ms.ae", "levels_ms.ae", "diff_ms.ae", "between_ms.ae"}
