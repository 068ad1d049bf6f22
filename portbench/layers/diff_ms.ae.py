"""diff_ms.ae: the device time of the program's ``ae.diff`` span (the
N-replica masks and the per-replica counts), median over the traced
sub-window's complete cycles; on several cards, each cycle's slowest card.
Moves ``cycle_ms``."""

from portbench import spans


def read(r):
    return spans.phase_ms(r, "ae.diff", "diff_ms")
