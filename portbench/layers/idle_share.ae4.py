"""idle_share.ae4: ``idle_share.ae``'s reading in the four-card cell, the
mean of the four cards' idle shares of the traced sub-window. Moves
``cycle_ms``."""

from portbench import harness


def read(r):
    return harness.load_reader("idle_share.ae")(r)
