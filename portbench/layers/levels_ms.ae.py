"""levels_ms.ae: the device time of the program's ``ae.levels`` span (the
tree's level launches, the odd levels' promotion copies and the gaps
between them), median over the traced sub-window's complete cycles; on
several cards, each cycle's slowest card. Moves ``cycle_ms``."""

from portbench import spans


def read(r):
    return spans.phase_ms(r, "ae.levels", "levels_ms")
