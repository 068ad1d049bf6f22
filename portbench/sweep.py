#!/usr/bin/env python3
"""Offer a mirror cell's traffic at several fixed rates, to find the knee.

    python3 portbench/sweep.py --workload <cell> --rates 8000,14000 --seeds 1,2 --seconds 20

Loads the cell's engine and warms its mirror once, then runs one window
for each seed and each rate in turn (its traffic with
``rate_writes_per_s`` replaced and the seed's schedule), one JSON line each:
the offered and covered writes/s, the freshness percentiles, the frames
over the staleness limit and the mean freshness of each quarter of the
window (a backlog that grows shows as a rising mean). The knee is the
highest rate whose frames stay within the limit on every seed, with no
growing backlog. No check runs: the records change from window to window.
The cell may be one of ``pending.json``'s.
The benchmark's own runs never run this.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import torch  # noqa: E402

from portbench import devtrace, harness  # noqa: E402


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seeds", default="1")
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    ctx = harness.Ctx(harness.load_bench(pending=True), args.workload, 0, args.seconds, False,
                      [torch.device("cuda", 0)])
    cell = harness.load_driver(ctx)
    cell.load()
    for seed in (int(s) for s in args.seeds.split(",")):
        for rate in (float(r) for r in args.rates.split(",")):
            ctx.seed = seed
            ctx.mix["rate_writes_per_s"] = rate
            cell.prime()
            out = cell.window(devtrace.Tracer(False, args.seconds))
            print(json.dumps({"rate": rate, "seed": seed, "failed": out["failed"],
                              "attempted": out["attempted"], "metrics": out["metrics"],
                              "facts": cell.facts["summary"]}), flush=True)
    cell.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
