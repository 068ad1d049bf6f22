"""gather_wait_ms.ae4: the device time of the program's ``ae.gather_wait``
span inside ``ae.combine`` on the first card (the first card's wait for the
copies of every card's masks into the [R, N] result: the part of the masks
gather that the leaf hash did not hide), median over the traced
sub-window's complete cycles. None where the program has no such span.
Moves ``cycle_ms``."""

from portbench import spans


def read(r):
    return spans.phase_ms(r, "ae.gather_wait", "gather_wait_ms")
