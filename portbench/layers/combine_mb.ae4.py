"""combine_mb.ae4: the MB (10^6 bytes) a key-mesh step moves from the
other cards to the first (seam nodes, masks, counts): the program's
counters ``device.ae_combine_bytes`` over ``device.ae_mesh_steps``, read
after the window. None where the program has no such counters. Moves
``cycle_ms``."""


def read(r):
    try:
        from merklekv_tpu_torch.obs.metrics import get_metrics
    except ImportError:
        return None
    counters = get_metrics().snapshot()["counters"]
    steps = counters.get("device.ae_mesh_steps", 0)
    if not steps:
        return None
    return counters.get("device.ae_combine_bytes", 0) / steps / 1e6
