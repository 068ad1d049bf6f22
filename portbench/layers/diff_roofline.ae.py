"""diff_roofline.ae: the N-replica diff's share of its roofline, in %: the
bytes it needs (digests R x N x 32 and presence R x N read once, masks
R x N and counts written once) over 3.35 TB/s, over the time of the
benchmark's own calls of ``merkle.diff.divergence_masks`` and the
per-replica count on each card's own tensors after the window, taken by
CUDA events (device timestamps, not the profiler's trace); the lowest
card's. The same work whatever implements it. Moves ``cycle_ms``."""


def read(r):
    probes = r.probes.get("diff")
    if not probes:
        return None
    limits = r.roofline.gpu_lines()
    shares = []
    for i, (dev, fn, work) in enumerate(probes):
        t = r.event_s(fn, dev)
        pct, by = r.roofline.roofline_pct(work, t)
        shares.append(pct)
        r.ctx.log(f"[diff] card {i}: {1e3 * t:.6f} ms, {pct:.4f}% of the bound ({by}); "
                  f"{limits[min(i, len(limits) - 1)]}")
    return min(shares)
