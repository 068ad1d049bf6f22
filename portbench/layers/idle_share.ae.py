"""idle_share.ae: the share of the traced sub-window in which no kernel,
copy or set ran on the card, in %; on several cards the mean of their
shares (each card's on an earlier line). Moves ``cycle_ms``."""


def read(r):
    s = r.summary
    if s is None:
        return None
    shares = []
    for i, _dev in enumerate(r.ctx.devices):
        busy = s["cards"].get(i, {"busy_s": 0.0})["busy_s"]
        shares.append(100.0 * (1.0 - busy / s["window_s"]))
        r.ctx.log(f"[idle] card {i}: {shares[-1]:.4f}% idle of {s['window_s']:.6f} s")
    return sum(shares) / len(shares)
