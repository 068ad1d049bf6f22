"""diff_roofline.ae4: ``diff_roofline.ae``'s reading in the four-card cell,
the diff at R = 64 on each card's key range; the lowest card's. Moves
``cycle_ms``."""

from portbench import harness


def read(r):
    return harness.load_reader("diff_roofline.ae")(r)
