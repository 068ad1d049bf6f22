"""leaf_roofline.ae: the leaf hash's share of its roofline, in %: the least
time of the cell's compressions (INT32 and issue rates, derived) or of its
bytes (3.35 TB/s), whichever is larger, over the time of the benchmark's
own calls of ``ops.dispatch.hash_blocks`` on each card's own blocks after
the window, taken by CUDA events (device timestamps, not the profiler's
trace); the lowest card's. Moves ``cycle_ms``."""


def read(r):
    probes = r.probes.get("leaf")
    if not probes:
        return None
    limits = r.roofline.gpu_lines()
    shares = []
    for i, (dev, fn, work) in enumerate(probes):
        t = r.event_s(fn, dev)
        pct, by = r.roofline.roofline_pct(work, t)
        shares.append(pct)
        r.ctx.log(f"[leaf] card {i}: {1e3 * t:.6f} ms, {pct:.4f}% of the bound ({by}); "
                  f"{limits[min(i, len(limits) - 1)]}")
    return min(shares)
