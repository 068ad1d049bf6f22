"""longest_leaf_ms.etc: the device ms of the benchmark's own calls of
``ops.dispatch.hash_ragged`` on a ragged set of the cell's longest leaf
alone, by CUDA events after the window: the one serial chain of
compressions that no schedule of the whole set beats. Moves
``cycle_ms``."""


def read(r):
    probes = r.probes.get("longest")
    if not probes:
        return None
    dev, fn, blocks = probes[0]
    ms = 1e3 * r.event_s(fn, dev)
    r.ctx.log(f"[longest_leaf] {blocks} blocks: {ms:.6f} ms, {1e3 * ms / blocks:.6f} us a block")
    return ms
