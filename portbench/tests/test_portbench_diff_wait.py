"""The ``diff_wait_ms.ae`` and ``diff_wait_ms.ae4`` readers over span
records with and without the ``ae.diff_wait`` span: a program whose cycle
has no such span reads None, and the line leaves the metric out; with it,
the median over cycles of the slowest card's wait."""

from types import SimpleNamespace

import pytest

from portbench import harness, spans


def _cycle(ident, cards):
    """One complete cycle's records: ``ae.cycle`` on card 0, then for each
    card its phases ({card: {name: device ms}})."""
    rec = dict(session=1, host_ns=(1, 2), cycle=None, between_ms=None)
    out = [dict(rec, name="ae.cycle", id=ident, parent=None, root=ident, device=0,
                device_ms=40.0)]
    k = ident
    for card, phases in cards.items():
        for name, ms in phases.items():
            k += 1
            out.append(dict(rec, name=name, id=k, parent=ident, root=ident, device=card,
                            device_ms=ms))
    return out


@pytest.mark.parametrize("name", ["diff_wait_ms.ae", "diff_wait_ms.ae4"])
def test_diff_wait_reader_needs_its_span(monkeypatch, name):
    read = harness.load_reader(name)
    logged = []
    r = SimpleNamespace(ctx=SimpleNamespace(log=logged.append))
    without = (_cycle(1, {0: {"ae.diff": 1.0, "ae.leaf": 13.0, "ae.levels": 1.4}})
               + _cycle(10, {0: {"ae.leaf": 13.1, "ae.levels": 1.4, "ae.diff": 0.9}}))
    monkeypatch.setattr(spans, "records", lambda: without)
    assert read(r) is None and logged == []
    with_span = (_cycle(1, {0: {"ae.diff": 9.0, "ae.diff_wait": 0.02},
                            1: {"ae.diff": 9.5, "ae.diff_wait": 0.3}})
                 + _cycle(10, {0: {"ae.diff": 9.0, "ae.diff_wait": 0.01},
                               1: {"ae.diff": 9.1, "ae.diff_wait": 0.05}})
                 + _cycle(20, {0: {"ae.diff": 9.0, "ae.diff_wait": 0.2},
                               1: {"ae.diff": 9.1, "ae.diff_wait": 0.0}}))
    monkeypatch.setattr(spans, "records", lambda: with_span)
    assert read(r) == pytest.approx(0.2)
    assert any("device.ae_diff_overlapped" in line for line in logged)
