#!/usr/bin/env python3
"""The ragged leaf hash on one NVIDIA GPU: what its schedule buys.

    python3 tools/ragged_schedule.py [--keys 10000000] [--seed 1] [--reps 5]
        [--out build/ragged_schedule.json]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Makes the ``etc10m-r8`` configuration's records on the card from ``--seed``
(``portbench/traffic/ae_ragged.py``: ETC key and value sizes, packed by the
benchmark's packer), makes the program's set (``merkle.ragged.RaggedLeaves``)
and checks ``ops.dispatch.hash_ragged`` against the benchmark's plain
reference, bit for bit. Then times, by CUDA events over ``--reps`` calls
after one that warms up, the ragged kernels on:

- ``longest``: a set of the longest leaf alone: one chain, one lane
  (``longest_bulk``: the same leaf in ``bulk_kernel``, which loads each
  block just before it compresses it);
- ``scheduled``: the whole set as the program runs it, its longest groups
  in ``chain_kernel`` (each on an SM sub-partition of its own) beside the
  bulk;
- ``shared``: the whole set in ``bulk_kernel`` alone, longest first (the
  same order, no chains): the long groups share their sub-partitions with
  bulk warps;
- ``bulk_only`` / ``chains_only``: the scheduled launch's two halves alone
  (the library's entry on a part of the order, which hashes only the leaves
  it names: the wrapper takes the whole order only);
- ``key_order``: one thread a leaf in key order, in ``bulk_kernel``;

then ``split``: the two halves queued at once on two streams (the chains on
a high-priority one, first), each timed to its own end from one start, so
that the chains' time beside the bulk shows against their time alone; and
traces the ``scheduled`` launch with ``torch.profiler``, whose kernel
intervals say when each half ran. Prints the lane fill of each order (the
share of lane slots, 32 a warp times its longest lane, that compress), the
kernels' registers from the build's ``-Xptxas -v`` report, and one JSON
object as its last line (also written to ``--out``). Every time is device
time on the card named in the JSON's ``device``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def event_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fill(lengths: torch.Tensor, order: torch.Tensor) -> float:
    """Compressions over lane slots when lane l of warp w takes position
    32 w + l of ``order``."""
    sl = lengths[order.long()]
    pad = (-sl.shape[0]) % 32
    sl = torch.cat([sl, sl.new_zeros(pad)]).view(-1, 32)
    return float(sl.sum()) / float(32 * sl.max(dim=1).values.sum())


def split_ms(chains, bulk) -> tuple:
    """(ms to the chains' end, ms to the bulk's end) from one start event,
    with the chains on a high-priority stream queued first and the bulk on
    another; the mean of three runs after one that warms up."""
    hi, lo = torch.cuda.Stream(priority=-1), torch.cuda.Stream()
    ends = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        done = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        start.record()
        for stream, work, event in ((hi, chains, done[0]), (lo, bulk, done[1])):
            stream.wait_event(start)
            with torch.cuda.stream(stream):
                work()
                event.record(stream)
        torch.cuda.synchronize()
        ends.append([start.elapsed_time(e) for e in done])
    return tuple(sum(e[j] for e in ends[1:]) / 3 for j in range(2))


def kernel_intervals(fn) -> list:
    """(name, start us, end us) of each kernel of one call, from a trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    t0 = min(e["ts"] for e in kernels)
    return [(e["name"], e["ts"] - t0, e["ts"] - t0 + e["dur"]) for e in kernels]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--keys", type=int, default=10_000_000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=str(ROOT / "build" / "ragged_schedule.json"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from merklekv_tpu_torch.merkle import ragged
    from merklekv_tpu_torch.ops import cuda_lib, dispatch, sha256_cuda
    from portbench.reference import ragged as ref_ragged
    from portbench.traffic import ae_ragged

    dev = torch.device("cuda", 0)
    entry = None
    for line in cuda_lib.build_kernels().build_log.splitlines():
        found = re.search(r"entry function '(\w+)'", line)
        if found:
            entry = found.group(1)
        elif entry and "registers" in line and re.search(r"chain_kernel|bulk_kernel|leaf_kernel",
                                                         entry):
            print(f"ptxas {entry}: {line.split(':', 1)[1].strip()}")
    cfg = json.loads((ROOT / "portbench" / "configs" / "etc10m-r8.json").read_text())
    cfg["keys"] = args.keys
    keys, key_lens, values, value_lens = ae_ragged.records(cfg, args.seed, dev)
    blocks, offsets = ref_ragged.pack(keys, key_lens, values, value_lens)
    del keys, values
    torch.cuda.synchronize()
    leaves = ragged.RaggedLeaves(blocks, offsets)
    sms, warps = sha256_cuda.ragged_shape(dev)
    lengths = offsets[1:] - offsets[:-1]
    n, c = leaves.n, leaves.chained
    print(f"set: {n} leaves, {leaves.total_blocks} blocks, longest {leaves.longest}, "
          f"chained {c} ({c // 32} warps); card {sms} SMs, {warps} bulk warps an SMSP")
    got = dispatch.hash_ragged(leaves)
    want = ref_ragged.hash_ragged(blocks, offsets)
    exact = bool(torch.equal(got, want))
    print(f"hash_ragged equals the reference: {exact}")
    i = int(torch.argmax(lengths))
    lo, hi = int(offsets[i]), int(offsets[i + 1])
    longest = ragged.RaggedLeaves(blocks[lo:hi], torch.tensor([0, hi - lo], device=dev))
    key_order = torch.arange(n, dtype=torch.int32, device=dev)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)

    def part(order, chained):
        """The library's entry on the leaves ``order`` names, its first
        ``chained`` in chain_kernel, into ``out``."""
        return lambda: cuda_lib.launch("mkv_leaf_ragged", dev, blocks.data_ptr(),
                                       offsets.data_ptr(), order.data_ptr(), out.data_ptr(),
                                       order.shape[0], chained)

    runs = {
        "longest": lambda: dispatch.hash_ragged(longest),
        "longest_bulk": part(torch.tensor([i], dtype=torch.int32, device=dev), 0),
        "scheduled": lambda: dispatch.hash_ragged(leaves),
        "shared": part(leaves.order, 0),
        "bulk_only": part(leaves.order[c:].contiguous(), 0),
        "chains_only": part(leaves.order[:c].contiguous(), c),
        "key_order": part(key_order, 0),
    }
    ms = {}
    for name, fn in runs.items():
        if name in ("bulk_only", "chains_only") and not 0 < c < n:
            continue
        ms[name] = event_ms(fn, args.reps)
        print(f"{name}: {ms[name]:.4f} ms")
    if 0 < c < n:
        ms["split_chains"], ms["split_bulk"] = split_ms(runs["chains_only"], runs["bulk_only"])
        print(f"split: chains end {ms['split_chains']:.4f} ms, bulk ends {ms['split_bulk']:.4f} ms")
    work = ref_ragged.work(n, leaves.total_blocks)
    from portbench import roofline

    least, by = roofline.bound_s(work["bytes"], work["logic"], work["adds"])
    intervals = kernel_intervals(lambda: dispatch.hash_ragged(leaves))
    for name, a, b in intervals:
        print(f"  trace {name}: {a:.1f} to {b:.1f} us")
    fills = {"scheduled": fill(lengths, leaves.order), "key_order": fill(lengths, key_order)}
    print(f"lane fill: scheduled {100 * fills['scheduled']:.4f}%, key order "
          f"{100 * fills['key_order']:.4f}%; counters' ratio "
          f"{100 * leaves.total_blocks / leaves.lane_slots:.4f}%")
    print(f"bound {1e3 * least:.4f} ms ({by}); chain pace "
          f"{1e3 * ms['longest'] / leaves.longest:.4f} us a block")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"device": smi, "keys": n, "blocks": leaves.total_blocks, "longest": leaves.longest,
              "chained": c, "sms": sms, "warps_per_smsp": warps, "exact": exact, "ms": ms,
              "bound_ms": 1e3 * least, "bound_by": by, "lane_fill": fills,
              "trace": intervals, "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result))
    print(json.dumps(result))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
