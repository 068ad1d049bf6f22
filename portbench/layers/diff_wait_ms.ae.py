"""diff_wait_ms.ae: the device time of the program's ``ae.diff_wait`` span
(the current stream's wait for the N-replica diff, which runs on a side
stream beside the leaf hash and the levels: the part of the diff they did
not hide), median over the traced sub-window's complete cycles. None where
the program has no such span. Logs the program's counter
``device.ae_diff_overlapped`` (diffs that ran beside the leaf hash). Moves
``cycle_ms``."""

from portbench import spans


def read(r):
    value = spans.phase_ms(r, "ae.diff_wait", "diff_wait_ms")
    if value is not None:
        from merklekv_tpu_torch.obs.metrics import get_metrics

        count = get_metrics().snapshot()["counters"].get("device.ae_diff_overlapped", 0)
        r.ctx.log(f"[diff_wait_ms] device.ae_diff_overlapped {count}")
    return value
