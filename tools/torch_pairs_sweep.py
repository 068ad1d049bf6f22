#!/usr/bin/env python3
"""The pairs kernel's launch on one NVIDIA GPU: two trees' sweeps in one
call, launch shapes against each other, and the level kernel on narrow
levels.

    python3 tools/torch_pairs_sweep.py [--tree NAME=DIR ... --order A,B,B,A]
        [--seed 0] [--no-shapes]

Run from the repository root on a machine with a CUDA card and ``nvcc``;
each ``DIR`` is an unpacked tree (``git archive``) with its package.

- Sweep, per run of ``--order``: a fresh process puts ``DIR`` first on
  ``sys.path`` (so ``merklekv_tpu_torch`` and its kernels are that tree's,
  built into ``DIR/build/``) and runs this repository's
  ``chip_smoke.node_pairs_sweep`` through the tree's own
  ``node_pairs_cuda``: device ms per launch (torch.profiler) at P = 64, 512,
  4096, 4 x 32 x SMs, 65,536 and 5,242,880, each beside the one-node-hash
  serial floor measured in that process (``chip_smoke.serial_floor``) and
  its share, with the SM clock nvidia-smi reads meanwhile and each pairs
  kernel's SASS instruction count, global-load positions and digest; P =
  4096 and 4 x 32 x SMs are also checked against the plain version.
- Shapes, in this repository's tree (unless ``--no-shapes``):
  ``tools/pairs_shape.cu``, built here, holds ``csrc/sha256_kernels.cu``.
  At P = 64, 512, 4096, 4 x 32 x SMs and 5,242,880, in turns: the wrapper,
  the kernel at the grid ``mkv_pairs_shape`` picks, and in 32-thread
  blocks (one warp an SM while P <= 32 x SMs), each checked against the
  plain version; then one launch at each grid records per warp its SM, its
  warp slot and its time. The parent's 256-thread launch is in its
  sweep.
- Levels: ``node_level_kernel`` at M = 2, 128, 1024, 8192 and 2 x 4 x 32 x
  SMs rows, the narrow levels a tree build ends with.

Every number is device time on the card named on the second-to-last line.
Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MARK = "SWEEP_RESULT "
ROUNDS = 3


def load_smoke():
    """This repository's ``chip_smoke.py`` as a module; the package it
    imports inside its functions is whichever ``sys.path`` finds first."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def run_tree(tree: Path, seed: int) -> int:
    """One sweep with ``tree``'s package and kernels."""
    sys.path.insert(0, str(tree))
    import torch

    import merklekv_tpu_torch
    from merklekv_tpu_torch.ops import sha256 as plain
    from merklekv_tpu_torch.ops.cuda_lib import build_kernels
    from merklekv_tpu_torch.ops.sha256_cuda import node_pairs_cuda

    if not Path(merklekv_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"merklekv_tpu_torch came from {merklekv_tpu_torch.__file__}")
    cs = load_smoke()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    k = build_kernels()
    full = 4 * 32 * torch.cuda.get_device_properties(dev).multi_processor_count
    for p in (4096, full):
        left, right = cs.rand_words(rng, (p, 8), dev), cs.rand_words(rng, (p, 8), dev)
        if not torch.equal(node_pairs_cuda(left, right), plain.sha256_node_pairs(left, right)):
            raise AssertionError(f"node_pairs_cuda differs from its plain version at P={p}")
    floor = cs.serial_floor(dev, rng, 1, 0)
    with cs.ClockSampler() as clk:
        sweep = cs.node_pairs_sweep(dev, rng, floor["ms"])
    code = {name[name.index("node_pairs_kernel"):][:24]: st
            for name, st in sass(k.path, ("node_pairs_kernel",),
                                 ROOT / "build" / "pairs_sass").items()}
    print(MARK + json.dumps({"library": k.path.name, "floor_ms": floor["ms"],
                             "floor_clocks_sm_mhz": floor["clocks_sm_mhz"],
                             "sweep_clocks_sm_mhz": sorted(set(clk.samples)), "sass": code,
                             "sweep": sweep}), flush=True)
    return 0


def build_shape_lib() -> ctypes.CDLL:
    from merklekv_tpu_torch.ops.cuda_lib import nvcc

    out_dir = ROOT / "build" / "pairs_shape"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libpairs_shape.so"
    out = subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                          "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
                          "-I", str(ROOT / "merklekv_tpu_torch" / "csrc"),
                          "-o", str(lib_path), str(ROOT / "tools" / "pairs_shape.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on tools/pairs_shape.cu:\n{out.stderr}")
    for ln in (out.stdout + out.stderr).splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            print(f"[shapes] ptxas {ln.strip()}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.pairs_shape.argtypes = [i64, p, p]
    lib.pairs_launch.argtypes = [p, p, p, i64, i64, i32, p]
    lib.pairs_where.argtypes = [p, p, p, i64, i64, i32, p, p]
    for fn in (lib.pairs_shape, lib.pairs_launch, lib.pairs_where):
        fn.restype = ctypes.c_int
    return lib


def picked_shape(lib, p: int) -> tuple[int, int]:
    """(blocks, threads) as ``mkv_pairs_shape`` gives them."""
    blocks, threads = ctypes.c_int64(), ctypes.c_int32()
    if lib.pairs_shape(p, ctypes.byref(blocks), ctypes.byref(threads)):
        raise ValueError(f"no shape for P={p}")
    return blocks.value, threads.value


def where(lib, left, right, p: int, blocks: int, threads: int) -> dict:
    """Where the warps of one launch ran and how long each took."""
    import torch

    out = torch.empty_like(left)
    rec = torch.zeros((blocks * threads // 32, 4), dtype=torch.int64, device=left.device)
    rc = lib.pairs_where(left.data_ptr(), right.data_ptr(), out.data_ptr(), p, blocks, threads,
                         rec.data_ptr(), torch.cuda.current_stream(left.device).cuda_stream)
    if rc:
        raise RuntimeError(f"pairs_where failed to launch: {rc}")
    r = rec.cpu().numpy()
    sm, smsp = r[:, 0], r[:, 1] % 4
    ns = r[:, 3] - r[:, 2]
    per_smsp = np.unique(sm * 4 + smsp, return_counts=True)[1]
    per_sm = np.unique(sm, return_counts=True)[1]
    slow = np.argsort(-ns)[:4]
    return {"sms": int(len(per_sm)), "max_warps_per_sm": int(per_sm.max()),
            "max_warps_per_smsp": int(per_smsp.max()),
            "warp_ns": [int(ns.min()), int(np.median(ns)), int(ns.max())],
            "span_ns": int(r[:, 3].max() - r[:, 2].min()),
            "slowest": [[int(sm[j]), int(ns[j])] for j in slow]}


def sass(lib_path: Path, keep: tuple[str, ...], dump_dir: Path) -> dict:
    """Per kernel whose name holds one of ``keep``: its SASS instruction
    count, the positions of its global loads, a digest of its instructions
    without their addresses (``cuobjdump -sass``) and the count of each
    mnemonic (``ops``: ``IMAD.IADD``, ``SHF.R.W.U32``, ...); the whole
    listing goes to ``dump_dir``."""
    import collections
    import hashlib
    import re
    import shutil

    from merklekv_tpu_torch.ops.cuda_lib import nvcc

    tool = Path(nvcc()).with_name("cuobjdump")
    if not tool.exists():
        tool = Path(shutil.which("cuobjdump") or "cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True)
    if out.returncode:
        return {"error": out.stderr[-500:]}
    dump_dir.mkdir(parents=True, exist_ok=True)
    (dump_dir / f"{lib_path.stem}.sass").write_text(out.stdout)
    stats, name = {}, None
    for ln in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in keep) else None
            if name:
                stats[name] = {"instructions": 0, "ldg_at": [], "digest": hashlib.sha256(),
                               "ops": collections.Counter()}
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", ln)
        if name and m:
            st = stats[name]
            st["digest"].update(ln.split("*/", 1)[1].split(";", 1)[0].strip().encode())
            st["instructions"] += 1
            if m.group(2).split(".")[0] == "LDG":
                st["ldg_at"].append(st["instructions"] - 1)
            st["ops"][m.group(2)] += 1
    for st in stats.values():
        st["digest"] = st["digest"].hexdigest()[:16]
    return stats


def shapes(seed: int) -> dict:
    """The wrapper and the kernel at two grids, timed in turns, and where
    the warps of each grid land."""
    import torch

    from merklekv_tpu_torch.ops import sha256 as plain
    from merklekv_tpu_torch.ops.sha256_cuda import node_pairs_cuda

    cs = load_smoke()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 1)
    lib = build_shape_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor = cs.serial_floor(dev, rng, 1, 0)
    cs.log(f"[shapes] serial floor, one node hash by one warp: {floor['ms']:.4f} ms "
           f"({floor['cycles']:.0f} cycles; nvidia-smi clocks.sm {floor['clocks_sm_mhz']} MHz)")
    results = []
    for p in (64, 512, 4096, 4 * 32 * sms, 5 * (1 << 20)):
        left, right = cs.rand_words(rng, (p, 8), dev), cs.rand_words(rng, (p, 8), dev)
        want = plain.sha256_node_pairs(left, right)
        out = torch.empty_like(left)
        grids = {"picked": picked_shape(lib, p), "threads_32": (-(-p // 32), 32)}

        def launch(grid):
            rc = lib.pairs_launch(left.data_ptr(), right.data_ptr(), out.data_ptr(), p, *grid,
                                  stream)
            if rc:
                raise RuntimeError(f"pairs_launch {grid} failed to launch: {rc}")

        cases = {"wrapper": lambda: node_pairs_cuda(left, right)}
        cases.update({name: (lambda g=g: launch(g)) for name, g in grids.items()})
        for name, fn in cases.items():
            got = fn() if name == "wrapper" else (out.zero_(), fn(), out)[2]
            if not torch.equal(got, want):
                raise AssertionError(f"{name} is wrong at P={p}")
        runs = {name: [] for name in cases}
        order = list(cases)
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                runs[name].append(cs.profiled_again(cases[name], "node_pairs_kernel", 200)[0])
        placed = {f"{name} {list(g)}": where(lib, left, right, p, *g)
                  for name, g in grids.items()}
        results.append({"p": p, "picked": list(grids["picked"]), "where": placed,
                        "ms": {name: sorted(v) for name, v in runs.items()}})
        cs.log(f"[shapes] P={p}, picked {grids['picked']}: " + "; ".join(
            f"{name} {float(np.median(v)):.4f} ms ({', '.join(f'{x:.4f}' for x in sorted(v))})"
            for name, v in runs.items()))
        for name, w in placed.items():
            cs.log(f"[shapes] P={p} {name}: {w['sms']} SMs, at most {w['max_warps_per_sm']} "
                   f"warps an SM and {w['max_warps_per_smsp']} a sub-partition; warp ns "
                   f"min/median/max {w['warp_ns']}, span {w['span_ns']} ns; slowest [SM, ns] "
                   f"{w['slowest']}")
    return {"floor_ms": floor["ms"], "sms": sms, "results": results}


def upper_levels(seed: int) -> list:
    """``node_level_kernel`` (fixed 256-thread blocks, unrolled hash) on the
    narrow levels a tree build ends with: device ms per launch at M rows."""
    import torch

    from merklekv_tpu_torch.ops.sha256_cuda import node_level_cuda

    cs = load_smoke()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 2)
    out = []
    for m in (2, 128, 1024, 8192, 2 * 4 * 32 * torch.cuda.get_device_properties(dev)
              .multi_processor_count):
        cur = cs.rand_words(rng, (m, 8), dev)
        ms, seen = cs.profiled_again(lambda: node_level_cuda(cur), "node_level_kernel", 200)
        out.append({"m": m, "ms": ms, "profiled": seen})
    cs.log("[levels] node_level_kernel on narrow levels, device ms per launch: " + "; ".join(
        f"M={r['m']} {r['ms']:.4f} ms" for r in out))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR")
    ap.add_argument("--order", default="", help="comma-separated tree names, run in this order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-shapes", action="store_true", help="run the sweeps only")
    ap.add_argument("--run", help=argparse.SUPPRESS)  # one sweep, with this tree
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_pairs_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.run:
        return run_tree(Path(args.run).resolve(), args.seed)
    trees = dict(t.split("=", 1) for t in args.tree)
    order = [name for name in args.order.split(",") if name]
    if set(order) - set(trees):
        ap.error("every name of --order needs a --tree NAME=DIR")
    runs = []
    for name in order:
        tree = Path(trees[name]).resolve()
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--run", str(tree),
                               "--seed", str(args.seed)], cwd=tree, capture_output=True,
                              text=True, env=dict(os.environ, PYTHONPATH=str(tree)))
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            raise RuntimeError(f"run {len(runs) + 1} ({name}) failed: rc {proc.returncode}")
        res = json.loads(lines[-1][len(MARK):])
        res.update(tree=name, wall_s=time.perf_counter() - t)
        runs.append(res)
        print(f"[sweep] {name} (floor {res['floor_ms']:.4f} ms): " + "; ".join(
            f"P={r['p']} {r['ms']:.4f} ms, {100 * r['share']:.1f}%" for r in res["sweep"])
            + f"; nvidia-smi clocks.sm {res['sweep_clocks_sm_mhz']} MHz; SASS {res['sass']}",
            flush=True)
    sys.path.insert(0, str(ROOT))
    shp = None if args.no_shapes else shapes(args.seed)
    levels = None if args.no_shapes else upper_levels(args.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"card": card, "runs": runs, "shapes": shp, "levels": levels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
