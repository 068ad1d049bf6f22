"""seam_ms.ae4: the device time of the program's ``ae.seam`` span inside
``ae.combine`` on the first card (each card's nodes of the lowest level
that crosses a card's edge, copied to the first card, and the tree
finished there), median over the traced sub-window's complete cycles.
Moves ``cycle_ms``."""

from portbench import spans


def read(r):
    return spans.phase_ms(r, "ae.seam", "seam_ms")
