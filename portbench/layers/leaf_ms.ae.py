"""leaf_ms.ae: the device time of the program's ``ae.leaf`` span (every
leaf hashed, with the upload of host arrays where one is given), median
over the traced sub-window's complete cycles; on several cards, each
cycle's slowest card. Moves ``cycle_ms``."""

from portbench import spans


def read(r):
    return spans.phase_ms(r, "ae.leaf", "leaf_ms")
