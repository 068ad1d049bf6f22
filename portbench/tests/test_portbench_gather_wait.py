"""The ``gather_wait_ms.ae4`` reader over span records with and without its
``ae.gather_wait`` span: a program whose combine has no such span reads
None, and the line leaves the metric out."""

from types import SimpleNamespace

import pytest

from portbench import harness, spans


def _cycle(ident, combine_children):
    """One complete mesh cycle's records on card 0: ``ae.cycle``, then
    ``ae.combine`` holding ``combine_children`` ({name: device ms})."""
    rec = dict(session=1, device=0, host_ns=(1, 2), cycle=None, between_ms=None)
    out = [dict(rec, name="ae.cycle", id=ident, parent=None, root=ident, device_ms=40.0),
           dict(rec, name="ae.combine", id=ident + 1, parent=ident, root=ident, device_ms=2.0)]
    for k, (name, ms) in enumerate(combine_children.items()):
        out.append(dict(rec, name=name, id=ident + 2 + k, parent=ident + 1, root=ident,
                        device_ms=ms))
    return out


def test_gather_wait_reader_needs_its_span(monkeypatch):
    """``gather_wait_ms.ae4`` reads the median ``ae.gather_wait``; over a
    program whose combine has no such span it reads None."""
    read = harness.load_reader("gather_wait_ms.ae4")
    r = SimpleNamespace(ctx=SimpleNamespace(log=lambda msg: None))
    without = _cycle(1, {"ae.seam": 0.9}) + _cycle(10, {"ae.seam": 0.8})
    monkeypatch.setattr(spans, "records", lambda: without)
    assert read(r) is None
    with_span = (_cycle(1, {"ae.seam": 0.9, "ae.gather_wait": 0.25})
                 + _cycle(10, {"ae.seam": 0.8, "ae.gather_wait": 0.05})
                 + _cycle(20, {"ae.seam": 0.8, "ae.gather_wait": 0.1}))
    monkeypatch.setattr(spans, "records", lambda: with_span)
    assert read(r) == pytest.approx(0.1)
