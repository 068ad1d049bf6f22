"""writes_per_drain.kv: writes offered in the window over the number of
pump drains in it (the ``device.pump_batches`` counter's difference): how
the pump batches. Moves ``fresh_p95_ms``."""


def read(r):
    f = r.facts
    if "counters0" not in f:
        return None
    name = "device.pump_batches"
    drains = f["counters1"]["counters"].get(name, 0) - f["counters0"]["counters"].get(name, 0)
    if drains <= 0:
        return None
    return f["writes"] / drains
