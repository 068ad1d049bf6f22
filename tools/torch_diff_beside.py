#!/usr/bin/env python3
"""The N-replica diff beside the leaf hash on one NVIDIA GPU: how much of
``diff_kernel``'s co-resident launch the leaf hash hides.

    python3 tools/torch_diff_beside.py [--cells ae10m-r8,ae64r-4card]
        [--reps 5] [--seed 1] [--out build/diff_beside.json]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
At each cell's shapes ([8, 10M] digests against 10M leaves of 17 blocks;
[64, 16.5M] against 16.5M leaves, one card's shard of the four-card cell),
with inputs made on the card from ``--seed`` (replica 0's digests in every
replica, 1% of each other replica's keys flipped in one word):

- alone: ``leaf_kernel`` (``ops.dispatch.hash_blocks``), the standalone
  diff (``ops.dispatch.divergence``: the occupancy calculator's grid) and
  the co-resident diff (``ops.diff_cuda.divergence_beside_cuda``: one block
  of 128 threads an SM) alone on the current stream;
- beside: as the anti-entropy step queues them: a short spin on the
  current stream (so that both grids wait on the same work), the leaf hash
  on the current stream, then the co-resident diff on the card's
  high-priority side stream (``merkle.torch_engine.diff_stream``), which
  waits for the spin only, and the current stream waits for the diff. CUDA
  events time the pair from the spin's end; a ``torch.profiler`` trace of
  the same gives each kernel's device interval, whence each kernel's
  duration and the share of the diff's interval that lies under the leaf
  hash's. The beside run's masks and counts are compared with the
  standalone diff's (exact).

Prints each kernel's registers a thread from the build's ``-Xptxas -v``
report and the leaf blocks an SM keeps beside the co-resident diff by that
count (65,536 registers an SM, 2048 threads, a warp's registers allocated
in units of 256), one line a cell, and one JSON object as its last line
(also written to ``--out``). Every time is device time on the card named in
the JSON's ``device``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CELLS = {"ae10m-r8": (8, 10_000_000), "ae64r-4card": (64, 16_500_000)}
BLOCKS_PER_LEAF = 17
SPIN_CYCLES = 200_000  # about 0.1 ms at the card's clock
LEAF_THREADS = 256
BESIDE = (1, 128)  # the co-resident grid: blocks an SM, threads a block


def registers(log: str) -> dict:
    """Registers a thread of each kernel, from nvcc's ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in ("diff_kernel", "leaf_kernel", "node_level_kernel")
                         if k in m.group(1)), None)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = int(m.group(1))
            name = None
    return out


def block_regs(regs: int, threads: int) -> int:
    """Registers a block holds: a warp's allocated in units of 256."""
    per_warp = -(-regs * 32 // 256) * 256
    return per_warp * -(-threads // 32)


def leaf_blocks_beside(regs: dict, shape: tuple) -> int:
    """Leaf blocks an SM holds beside ``shape`` (K diff blocks an SM of T
    threads), by registers and threads."""
    k, t = shape
    left = 65536 - k * block_regs(regs["diff_kernel"], t)
    by_regs = left // block_regs(regs["leaf_kernel"], LEAF_THREADS)
    by_threads = (2048 - k * t) // LEAF_THREADS
    return max(0, min(by_regs, by_threads))


def make_inputs(torch, dev, seed: int, r: int, n: int):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    blocks = torch.randint(-(2**31), 2**31 - 1, (n, BLOCKS_PER_LEAF, 16), dtype=torch.int32,
                           device=dev, generator=g)
    nblocks = torch.full((n,), BLOCKS_PER_LEAF, dtype=torch.int32, device=dev)
    base = torch.randint(-(2**31), 2**31 - 1, (n, 8), dtype=torch.int32, device=dev, generator=g)
    digests = base.unsqueeze(0).repeat(r, 1, 1)
    del base
    for ri in range(1, r):
        idx = torch.randint(0, n, (n // 100,), device=dev, generator=g)
        digests[ri, idx, ri % 8] ^= 0x5A5A5A5A
    present = torch.ones((r, n), dtype=torch.bool, device=dev)
    return blocks, nblocks, digests, present


def events_ms(torch, fn, reps: int) -> list:
    """Device ms of ``fn`` (queued on the current stream), ``reps`` times."""
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def kernel_intervals(trace: Path) -> dict:
    """(start, end) in us of every diff and leaf kernel, by name, in order."""
    events = json.loads(trace.read_text())["traceEvents"]
    out = {"diff_kernel": [], "leaf_kernel": []}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for k in out:
            if k in e.get("name", ""):
                out[k].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for v in out.values():
        v.sort()
    return out


def run_cell(torch, dev, cell: str, reps: int, seed: int, regs: dict) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from merklekv_tpu_torch.merkle.torch_engine import diff_stream
    from merklekv_tpu_torch.ops import diff_cuda, dispatch

    r, n = CELLS[cell]
    blocks, nblocks, digests, present = make_inputs(torch, dev, seed, r, n)
    want_m, want_c = dispatch.divergence(digests, present)
    masks = torch.empty((r, n), dtype=torch.bool, device=dev)
    counts = torch.zeros(r, dtype=torch.int32, device=dev)
    side = diff_stream(dev)
    res = {"replicas": r, "keys": n, "blocks_per_leaf": BLOCKS_PER_LEAF,
           "diff_bytes": r * n * 34, "leaf_bytes": n * BLOCKS_PER_LEAF * 64,
           "leaf_blocks_an_sm": leaf_blocks_beside(regs, BESIDE)}

    def leaf():
        dispatch.hash_blocks(blocks, nblocks)

    def diff_alone():
        counts.zero_()
        diff_cuda.divergence_beside_cuda(digests, present, masks, counts)

    def pair():
        cur = torch.cuda.current_stream(dev)
        counts.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        ready = cur.record_event()
        start = torch.cuda.Event(enable_timing=True)
        start.record(cur)
        leaf()
        side.wait_event(ready)
        with torch.cuda.stream(side):
            diff_cuda.divergence_beside_cuda(digests, present, masks, counts)
        cur.wait_event(side.record_event())
        return start

    for fn in (leaf, lambda: dispatch.divergence(digests, present), diff_alone):  # warm
        fn()
    res["leaf_alone_ms"] = statistics.median(events_ms(torch, leaf, reps))
    res["diff_standalone_ms"] = statistics.median(
        events_ms(torch, lambda: dispatch.divergence(digests, present), reps))
    res["serial_ms"] = res["leaf_alone_ms"] + res["diff_standalone_ms"]
    res["diff_alone_ms"] = statistics.median(events_ms(torch, diff_alone, reps))
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = pair()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end))
    res["pair_ms"] = statistics.median(walls)
    res["exact"] = torch.equal(masks, want_m) and torch.equal(counts, want_c)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                pair()
                torch.cuda.synchronize()
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        iv = kernel_intervals(path)
    d_ms, l_ms, under = [], [], []
    for (ds, de), (ls, le) in zip(iv["diff_kernel"], iv["leaf_kernel"]):
        d_ms.append((de - ds) / 1e3)
        l_ms.append((le - ls) / 1e3)
        under.append(max(0.0, min(de, le) - max(ds, ls)) / max(de - ds, 1e-9))
    if d_ms:
        res.update(diff_beside_ms=statistics.median(d_ms), leaf_beside_ms=statistics.median(l_ms),
                   diff_under_leaf=statistics.median(under), traced_pairs=len(d_ms))
    res["saved_ms"] = res["serial_ms"] - res["pair_ms"]
    print(f"[{cell}] leaf alone {res['leaf_alone_ms']:.4f} ms, diff standalone "
          f"{res['diff_standalone_ms']:.4f} ms, serial {res['serial_ms']:.4f} ms; co-resident "
          f"diff alone {res['diff_alone_ms']:.4f} ms; leaf blocks an SM beside it "
          f"{res['leaf_blocks_an_sm']}; beside: pair {res['pair_ms']:.4f} ms (saves "
          f"{res['saved_ms']:.4f} of serial), leaf {res.get('leaf_beside_ms', 0):.4f} "
          f"(+{res.get('leaf_beside_ms', 0) - res['leaf_alone_ms']:.4f}), diff "
          f"{res.get('diff_beside_ms', 0):.4f}, {100 * res.get('diff_under_leaf', 0):.1f}% of the "
          f"diff under the leaf; exact {res['exact']}", flush=True)
    del blocks, nblocks, digests, present, masks, counts, want_m, want_c
    torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="build/diff_beside.json")
    args = ap.parse_args()
    import torch

    from merklekv_tpu_torch.ops.cuda_lib import build_kernels

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    regs = registers(build_kernels().build_log)
    print(f"[card] {torch.cuda.get_device_name(dev)}; nvidia-smi {smi[:1]}; "
          f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs", flush=True)
    print(f"[regs] registers a thread (ptxas -v): {regs}; leaf blocks an SM alone "
          f"{leaf_blocks_beside(regs, (0, 0))}", flush=True)
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi[:1], "registers": regs,
           "cells": {}}
    for cell in args.cells.split(","):
        out["cells"][cell] = run_cell(torch, dev, cell, args.reps, args.seed, regs)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
