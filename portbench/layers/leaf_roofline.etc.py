"""leaf_roofline.etc: the ragged leaf hash's share of its roofline, in %: the
least time of the cell's compressions (one a block, at the INT32 and issue
rates, derived) or of its bytes (each block, offset and digest once, at
3.35 TB/s), whichever is larger (``reference.ragged.work``), over the time
of the benchmark's own calls of ``ops.dispatch.hash_ragged`` on the cell's
set after the window, taken by CUDA events. Moves ``cycle_ms``."""


def read(r):
    probes = r.probes.get("leaf")
    if not probes:
        return None
    limits = r.roofline.gpu_lines()
    dev, fn, work = probes[0]
    t = r.event_s(fn, dev)
    pct, by = r.roofline.roofline_pct(work, t)
    least, _ = r.roofline.bound_s(work["bytes"], work["logic"], work["adds"])
    r.ctx.log(f"[leaf_ragged] {1e3 * t:.6f} ms, bound {1e3 * least:.6f} ms, {pct:.4f}% of the "
              f"bound ({by}); {limits[0]}")
    return pct
