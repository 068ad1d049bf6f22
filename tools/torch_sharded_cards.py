#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sharded phase (phase 9) over the host's distinct
cards and, in the same process, over ``[cuda:0] * 4``, to compare them;
then its multi-process phase (phase 11) with one NCCL rank per card.

    python tools/torch_sharded_cards.py      # from the repository root, on a 2+-card host

It builds the kernels (phase 1) and makes phase 3's 10M-key data, then runs
phase 9 three times: on the first 4 (or 2) distinct cards, on four shards
of card 0, and on the distinct cards again; every check of the phase runs
each time. Phase 9's step is timed in both input forms: one tensor on card
0, split and copied to the cards inside the step, and the per-device form
(``multihost.lift_local_shards``), whose shards already sit on their cards.
Then phase 11 runs the step across processes, each rank on its own card,
and checks every rank's root and counts against phase 9a's. The last lines
give each run's step times (both forms) and single-device time, sharded
serving writes/s, seconds and launches, and phase 11's step. Exits nonzero
on a host with fewer than two cards.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if torch.cuda.device_count() < 2:
        print("torch_sharded_cards: needs two or more CUDA cards", file=sys.stderr)
        return 2
    t = time.time()
    dev = torch.device("cuda", 0)
    cs.log(f"[device] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
           f"{cs.gpu_line()}")
    cs.phase_build()
    errs = {"path_rehash": 0, "promotion_chain": 0}
    reb = cs.phase_rebuild(dev, 0)
    distinct = cs.phase_sharded(dev, 0, reb, errs)
    real = cs.shard_devices
    cs.shard_devices = lambda d: ([d] * cs.SHARDS, False)
    one = cs.phase_sharded(dev, 0, reb, errs)
    cs.shard_devices = real
    distinct2 = cs.phase_sharded(dev, 1, reb, errs)
    for key in ("digests", "present", "expected"):
        del reb[key]
    torch.cuda.empty_cache()
    mh = cs.phase_multihost(0, distinct2)
    for name, r in (("distinct", distinct), ("one card", one), ("distinct again", distinct2)):
        print("RESULT", name, r["where"], "step_ms", r["step_ms"], "step_per_device_ms",
              r["step_pd_ms"], "single_ms", r["single_ms"], "writes_per_s", r["writes_per_s"],
              "seconds", r["seconds"], r["launches"], flush=True)
    print("RESULT multihost", mh["where"], "step_ms", mh["step_ms"], "seconds", mh["seconds"],
          mh["launches"], flush=True)
    print("SHARDED_CARDS_OK", time.time() - t, errs, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
