"""combine_ms.ae4: the device time of the program's ``ae.combine`` span on
the first card (the per-replica counts' sum, the tree finished over the
cards' seams, the masks gathered from every card), median over the traced
sub-window's complete cycles. Moves ``cycle_ms``."""

from portbench import spans


def read(r):
    return spans.phase_ms(r, "ae.combine", "combine_ms")
