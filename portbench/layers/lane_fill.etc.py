"""lane_fill.etc: the share of the ragged leaf hash's lane slots that
compress a block, in %: the program's counters ``device.ae_leaf_blocks``
(compressions queued) over ``device.ae_leaf_lane_slots`` (32 times the sum,
over the launch's warps, of its longest lane's compressions), over the
measured window. None where the program has no such counters. Moves
``cycle_ms``."""


def read(r):
    blocks, slots = r.facts.get("leaf_blocks", 0), r.facts.get("lane_slots", 0)
    if not slots:
        return None
    r.ctx.log(f"[lane_fill] {blocks} blocks in {slots} lane slots over the window")
    return 100.0 * blocks / slots
