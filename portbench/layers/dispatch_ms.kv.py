"""dispatch_ms.kv: the mean of the ``device.scatter_dispatch`` histogram over
the window, in ms: host packing plus the guarded dispatch of one drain's
value scatter (``merkle.incremental.DeviceMerkleState``). Moves
``fresh_p95_ms``."""


def read(r):
    f = r.facts
    if "counters0" not in f:
        return None
    name = "device.scatter_dispatch"
    h0 = f["counters0"]["histograms"].get(name, {"sum": 0.0, "count": 0})
    h1 = f["counters1"]["histograms"].get(name, {"sum": 0.0, "count": 0})
    count = h1["count"] - h0["count"]
    if count <= 0:
        return None
    return 1e3 * (h1["sum"] - h0["sum"]) / count
