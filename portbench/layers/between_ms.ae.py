"""between_ms.ae: device time from one ``ae.cycle`` span's exit event to
the next one's entry event on the first card, median over the traced
sub-window's complete cycles: what the cycle's caller holds the card for
between cycles (reading root and counts back, launching the next cycle).
Moves ``cycle_ms``."""

from portbench import spans


def read(r):
    return spans.between_ms(r, "between_ms")
