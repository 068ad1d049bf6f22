#!/usr/bin/env python3
"""Run a cell's controls, and the program beside them, on several seeds.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3 [--program]

Each control (the driver's ``CONTROLS``: the plain reference put in the
program's place with one guarantee broken) runs a short window at the
cell's own size and load and is judged by the cell's own check; it has to
come out not correct. With ``--program`` the program runs on the same seeds
first, which gives the lower reading of each compared number. One JSON line
per run. The cell may be one of ``pending.json``'s. The benchmark's own
runs never run this.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", action="store_true")
    args = p.parse_args()
    bench = harness.load_bench(pending=True)
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("needs the cell's CUDA cards", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    ctx = harness.Ctx(bench, args.workload, 0, args.seconds, False, devices)
    controls = harness.load_driver(ctx).CONTROLS
    runs = ([None] if args.program else []) + list(controls)
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in runs:
            over = {"warmup_cycles": 0} if control and "warmup_cycles" in ctx.mix else None
            r = harness.run_cell(args.workload, seed, args.seconds, False, devices, overrides=over,
                                 bench=bench, control=control)
            print(json.dumps({"seed": seed, "control": control, "correct": r["correct"],
                              "checks": r["checks"], "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
