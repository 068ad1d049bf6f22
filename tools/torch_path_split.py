#!/usr/bin/env python3
"""Where the serving tree's path rehash spends its time, on one NVIDIA GPU.

    python3 tools/torch_path_split.py [--seed 0] [--reps 200]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
At the serving shape (k = 4096 changed one-block leaves of a 2^20-leaf tree)
it times, as torch.profiler kernel time per launch:

- the serial floor (``chip_smoke.serial_floor``): ``hash_chain_kernel``
  (``csrc/merkle_paths.cu``), one warp hashing in registers a one-block leaf
  and 20 dependent node hashes (the serving path's root), and 21 and 12
  node hashes alone, with the fastest node hash: its SM clock cycles and
  nanoseconds, and the SM clock that ``nvidia-smi --query-gpu=clocks.sm``
  reads meanwhile;
- the earlier walk (commit d422390; ``tools/path_split.cu``, built here):
  mode 0 as it was,
  mode 1 with its arrival sequence (fence, atomicExch, fence, L2 load)
  replaced by plain loads, mode 2 with no untouched-sibling read either;
  each on random positions and on one position per 2^8-leaf subtree (no
  meetings on levels 1-8, a meeting at every node from level 9 up);
- the kernel that ``ops/merkle_paths.py::path_rehash_cuda`` launches now,
  on the same inputs, checked against the plain version, and the same
  kernel built with its phase marks on (``split_trace``): the last block's
  phase times;
- big batches: the earlier walk (mode 0) and the kernel the wrapper launches
  on 65,536 random positions and on every leaf;
- the spread over SMs: one block per SM, each warp hashing a chain of 21
  node hashes, with the unrolled node hash and with the path rehash's
  (padding rounds as a loop): cycles and ns per hash, min / median / max
  over the SMs, and the slowest SMs.

Modes 1 and 2 give wrong digests by design and are used for timing only.
Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DEPTH = 20
K = 4096


def build_split() -> ctypes.CDLL:
    from merklekv_tpu_torch.ops.cuda_lib import nvcc

    out_dir = ROOT / "build" / "path_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libpath_split.so"
    out = subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                          "-O3", "-Xcompiler", "-fPIC", "-shared",
                          "-I", str(ROOT / "merklekv_tpu_torch" / "csrc"),
                          "-o", str(lib_path), str(ROOT / "tools" / "path_split.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on tools/path_split.cu:\n{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    p, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.split_walk.argtypes = [ctypes.c_int, p, p, p, p, i32, i32, p, p, p]
    lib.split_chain_sm.argtypes = [ctypes.c_int, p, i32, p, p, i32, p]
    lib.split_trace.argtypes = [p, p, p, p, i32, i32, i32, i32, p, p, p]
    for fn in (lib.split_walk, lib.split_chain_sm, lib.split_trace):
        fn.restype = ctypes.c_int
    return lib


def run_ends(pos: np.ndarray, depth: int) -> np.ndarray:
    """[depth + 1, k] int32: the end of the run of positions under node
    pos[i] >> l, for every level l."""
    k = len(pos)
    out = np.empty((depth + 1, k), np.int32)
    for lvl in range(depth + 1):
        node = pos >> lvl
        starts = np.flatnonzero(np.diff(node)) + 1
        ends = np.append(starts, k)
        out[lvl] = ends[np.searchsorted(starts, np.arange(k), side="right")]
    return out


def chain_floor(dev, rng) -> dict:
    from chip_smoke import serial_floor

    return {f"leaf of {nblk} block(s) + {d} node hashes": serial_floor(dev, rng, d, nblk)
            for d, nblk in ((DEPTH, 1), (21, 0), (12, 0))}


def chain_spread(split, dev, rng) -> dict:
    """Per-SM pace of the two node hashes (one block per SM)."""
    import torch

    from chip_smoke import rand_words
    from merklekv_tpu_torch.ops import merkle_paths as mp
    from merklekv_tpu_torch.ops.cuda_lib import current_stream

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    inp = rand_words(rng, (32, 16), dev)
    want = mp.hash_chain(inp, 21)
    out = {}
    for name, rolled in (("unrolled", 0), ("rolled padding rounds (path_rehash)", 1)):
        o = torch.empty((sms * 128, 8), dtype=torch.int32, device=dev)
        res = torch.zeros((sms, 3), dtype=torch.int64, device=dev)
        runs = []
        for _ in range(10):
            if split.split_chain_sm(rolled, inp.data_ptr(), 21, o.data_ptr(), res.data_ptr(), sms,
                                    current_stream(dev)):
                raise RuntimeError("split_chain_sm failed to launch")
            torch.cuda.synchronize()
            runs.append(res.cpu().numpy().copy())
        if not torch.equal(o[:32], want):
            raise AssertionError(f"{name} chain differs from the plain version")
        a = np.median(np.stack(runs), axis=0)
        cyc, ns = a[:, 1] / 21, a[:, 2] / 21
        slow = np.argsort(cyc)[-6:]
        out[name] = {"cycles_min": float(cyc.min()), "cycles_median": float(np.median(cyc)),
                     "cycles_max": float(cyc.max()), "ns_min": float(ns.min()),
                     "ns_median": float(np.median(ns)), "ns_max": float(ns.max()),
                     "slowest_sms": sorted(int(a[b, 0]) for b in slow), "sms": sms}
        print(f"[split] spread {name}: {out[name]}", flush=True)
    return out


def trace(split, dev, st, blocks, nblocks, pos_t, k, depth) -> dict:
    """The last block's phase times (ns) in the last of five launches of the
    kernel with its phase marks on."""
    import torch

    from merklekv_tpu_torch.ops import merkle_paths as mp
    from merklekv_tpu_torch.ops.cuda_lib import current_stream

    c = 1 << depth
    top = mp._path_top(c)
    g = -(-k // mp.PATH_WIDTH)
    scratch = mp.path_scratch(c, dev)
    tr = torch.zeros((g, 64), dtype=torch.int64, device=dev)
    for _ in range(5):  # the last of five launches: code and data warm, as in a run of batches
        tr.zero_()
        if split.split_trace(ctypes.byref(st), blocks.data_ptr(), nblocks.data_ptr(),
                             pos_t.data_ptr(), k, blocks.shape[1], mp.PATH_WIDTH, top,
                             scratch.data_ptr(), tr.data_ptr(), current_stream(dev)):
            raise RuntimeError("split_trace failed to launch")
    torch.cuda.synchronize()
    a = tr.cpu().numpy()
    last = int(np.flatnonzero(a[:, 62])[0])
    t0, row = a[:, 1].min(), a[last]
    bottom = [int(row[3 + lv] - row[2 + lv]) for lv in range(1, top - 1) if row[3 + lv]]
    tops = [int(row[47 + j] - (row[45] if j == 0 else row[47 + j - 1]))
            for j in range(depth - top + 1)]
    return {"blocks": g, "last_block_sm": int(row[0]), "load_score_ns": int(row[2] - row[1]),
            "leaf_and_level_1_ns": int(row[4] - row[2]), "bottom_levels_ns": bottom,
            "arrival_ns": int(row[44] - t0), "first_arrival_ns": int(a[:, 44].min() - t0),
            "cuts_and_top_copy_ns": int(row[45] - row[44]), "top_levels_ns": tops,
            "end_ns": int(row[47 + depth - top] - t0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_path_split: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import gpu_line, profiled_kernel_ms, rand_words
    from merklekv_tpu_torch.ops import merkle_paths as mp
    from merklekv_tpu_torch.ops.cuda_lib import build_kernels, current_stream
    from merklekv_tpu_torch.ops.dispatch import build_levels

    dev = torch.device("cuda", 0)
    card = gpu_line()
    rng = np.random.default_rng(args.seed)
    build_kernels()
    split = build_split()
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "chain": chain_floor(dev, rng), "spread": chain_spread(split, dev, rng)}
    for d, r in result["chain"].items():
        print(f"[split] chain {d}: {r}", flush=True)

    c = 1 << DEPTH
    base = build_levels(rand_words(rng, (c, 8), dev))
    sets = {
        "random": np.sort(rng.choice(c, size=K, replace=False)),
        "one per 2^8 subtree": np.arange(K) * 256 + rng.integers(0, 256, size=K),
    }
    blocks = rand_words(rng, (K, 1, 16), dev)
    nblocks = torch.ones(K, dtype=torch.int32, device=dev)
    ctr = torch.zeros(c - 1, dtype=torch.int32, device=dev)  # also the new kernel's scratch
    walks = {}
    for name, pos in sets.items():
        pos_t = torch.from_numpy(pos.astype(np.int32)).to(dev)
        ends = torch.from_numpy(run_ends(pos, DEPTH)).to(dev)
        tree = [lv.clone() for lv in base]
        st = mp._levels_struct(tree, dev)
        row = {}
        for mode in (0, 1, 2):
            def launch(mode=mode):
                rc = split.split_walk(mode, ctypes.byref(st), blocks.data_ptr(), nblocks.data_ptr(),
                                      pos_t.data_ptr(), K, 1, ctr.data_ptr(), ends.data_ptr(),
                                      current_stream(dev))
                if rc:
                    raise RuntimeError(f"split_walk mode {mode} failed to launch: {rc}")
            ms, seen = profiled_kernel_ms(launch, "walk_kernel", args.reps)
            row[f"mode{mode}_ms"] = ms
        # Mode 0 is the earlier kernel: it must still be right.
        got = [lv.clone() for lv in base]
        want = [lv.clone() for lv in base]
        st0 = mp._levels_struct(got, dev)
        split.split_walk(0, ctypes.byref(st0), blocks.data_ptr(), nblocks.data_ptr(),
                         pos_t.data_ptr(), K, 1,
                         ctr.data_ptr(), ends.data_ptr(), current_stream(dev))
        mp.path_rehash(want, blocks, nblocks, pos)
        row["mode0_exact"] = all(torch.equal(g, w) for g, w in zip(got, want))
        # The kernel the wrapper launches now, on the same inputs.
        got = [lv.clone() for lv in base]
        mp.path_rehash_cuda(got, ctr, blocks, nblocks, pos)
        row["current_exact"] = all(torch.equal(g, w) for g, w in zip(got, want))
        row["current_ms"], _ = profiled_kernel_ms(
            lambda: mp.path_rehash_cuda(tree, ctr, blocks, nblocks, pos), "path_rehash",
            args.reps)
        row["ctr_zero"] = not bool(ctr.any())
        traced = [lv.clone() for lv in base]
        row["trace"] = trace(split, dev, mp._levels_struct(traced, dev), blocks, nblocks, pos_t,
                             K, DEPTH)
        del traced
        walks[name] = row
        print(f"[split] {name}: {row}", flush=True)
    result["walks"] = walks
    big = {}
    for name, pos in (("65536 random", np.sort(rng.choice(c, size=1 << 16, replace=False))),
                      ("every leaf", np.arange(c))):
        k = len(pos)
        bblocks = rand_words(rng, (k, 1, 16), dev)
        bnb = torch.ones(k, dtype=torch.int32, device=dev)
        pos_t = torch.from_numpy(pos.astype(np.int32)).to(dev)
        tree = [lv.clone() for lv in base]
        st = mp._levels_struct(tree, dev)

        def old_walk():
            if split.split_walk(0, ctypes.byref(st), bblocks.data_ptr(), bnb.data_ptr(),
                                pos_t.data_ptr(), k, 1, ctr.data_ptr(), 0, current_stream(dev)):
                raise RuntimeError("split_walk failed to launch")
        row = {"k": k, "mode0_ms": profiled_kernel_ms(old_walk, "walk_kernel", 10)[0],
               "current_ms": profiled_kernel_ms(
                   lambda: mp.path_rehash_cuda(tree, ctr, bblocks, bnb, pos), "path_rehash",
                   10)[0]}
        big[name] = row
        print(f"[split] big batch {name}: {row}", flush=True)
        del tree
    result["big"] = big
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
