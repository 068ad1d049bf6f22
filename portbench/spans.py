"""The program's device spans of the anti-entropy cycle, as the per-layer
readers read them after the window.

The program records a span only while a profiler session records on the
thread that runs the cycle: here, the traced sub-window's session on the
driving thread (``devtrace.Tracer``). Set-up's empty session runs no
cycle, and the readers run with no session open, so the ring holds the
sub-window's cycles alone. When the tracer records a second time, because
its first session kept no kernel, the readers take the newest session's
cycles, those of the trace it keeps. A cycle counts when it is complete:
its ``ae.cycle`` span and every span under it have their device times.
The benchmark's files also run over checkouts whose program predates
device spans; there every reader returns None.
"""

from __future__ import annotations

import collections
import statistics

CYCLE = "ae.cycle"


def records() -> list:
    """The program's device span records, or [] where the program has no
    device spans."""
    try:
        from merklekv_tpu_torch.utils.tracing import device_spans
    except ImportError:
        return []
    return device_spans()


def complete_cycles(recs: list) -> list:
    """(``ae.cycle`` record, the records under it) of each complete cycle
    of the newest session, oldest first."""
    newest = max((rec["session"] for rec in recs), default=None)
    groups: dict = collections.defaultdict(list)
    for rec in recs:
        if rec["session"] == newest:
            groups[rec["root"]].append(rec)
    out = []
    for root, group in groups.items():
        top = [rec for rec in group if rec["id"] == root]
        if not top or top[0]["name"] != CYCLE:
            continue
        if any(rec["device_ms"] is None for rec in group):
            continue
        out.append((top[0], [rec for rec in group if rec["id"] != root]))
    return out


def describe(values: list) -> str:
    """Count, p10, median, p90 and mean of ``values`` (ms)."""
    if len(values) > 1:
        q = statistics.quantiles(values, n=10, method="inclusive")
        p10, p90 = q[0], q[-1]
    else:
        p10 = p90 = values[0]
    return (f"{len(values)} cycles, p10 {p10:.6f} ms, median {statistics.median(values):.6f} ms, "
            f"p90 {p90:.6f} ms, mean {statistics.fmean(values):.6f} ms")


def phase_ms(r, name: str, tag: str):
    """The median over complete cycles of phase ``name``'s device ms on the
    slowest card (a card's spans of the phase in one cycle summed: shards
    that share a card run one after another). Logs each card's spread."""
    per_cycle = []
    per_card: dict = collections.defaultdict(list)
    for _top, spans in complete_cycles(records()):
        cards: dict = collections.defaultdict(float)
        for rec in spans:
            if rec["name"] == name:
                cards[rec["device"]] += rec["device_ms"]
        if not cards:
            continue
        for card, ms in cards.items():
            per_card[card].append(ms)
        per_cycle.append(max(cards.values()))
    if not per_cycle:
        return None
    for card in sorted(per_card, key=str):
        r.ctx.log(f"[{tag}] card {card}: {name} {describe(per_card[card])}")
    return statistics.median(per_cycle)


def between_ms(r, tag: str):
    """The median over complete cycles of the device ms from the previous
    cycle's ``ae.cycle`` exit event to this one's entry event, on the first
    device. Logs its spread, the spread of ``ae.cycle`` itself and the host
    period of those cycles."""
    cycles = complete_cycles(records())
    gaps = [top["between_ms"] for top, _spans in cycles if top["between_ms"] is not None]
    if not gaps:
        return None
    card = cycles[0][0]["device"]
    r.ctx.log(f"[{tag}] card {card}: {describe(gaps)}")
    r.ctx.log(f"[{tag}] card {card}: {CYCLE} {describe([top['device_ms'] for top, _ in cycles])}")
    starts = [top["host_ns"][0] for top, _spans in cycles]
    if len(starts) > 1:
        period = (starts[-1] - starts[0]) / 1e6 / (len(starts) - 1)
        r.ctx.log(f"[{tag}] host period of the {len(starts)} traced cycles: {period:.6f} ms")
    return statistics.median(gaps)
