#!/usr/bin/env python3
"""Which pipe the SHA-256 kernels' instructions issue to, and what the wide
kernels take, on one NVIDIA GPU: two trees side by side in one call.

    python3 tools/sha256_pipes.py [--tree NAME=DIR ... --order A,B,B,A]
        [--seed 0] [--keys 10000000] [--reps 10] [--no-ragged]

Run from the repository root on a machine with a CUDA card and ``nvcc``;
each ``DIR`` is an unpacked tree (``git archive``) with its package. Without
``--tree`` this repository's tree runs once.

Per run of ``--order``, a fresh process puts ``DIR`` first on ``sys.path``
(so ``merklekv_tpu_torch`` and its kernels are that tree's, built into
``DIR/build/``) and reports:

- per SHA-256 kernel of the library, from ``cuobjdump -sass``
  (``tools/torch_pairs_sweep.py::sass``): the count of SHF, LOP3, IADD3,
  IMAD (every form, and each form apart), LDG, and local-memory STL/LDL
  (spills), its instruction count and the digest of its instructions;
  from the build's ``-Xptxas -v`` report its registers a thread and spill
  bytes, and the 256-thread blocks an SM its registers leave room for;
- device time by CUDA events (mean over ``--reps`` back-to-back calls after
  two that warm up) beside the least time by the kernel table's bound
  (``chip_smoke.py``: bytes at 3.35 TB/s, shifts and logic at the INT32
  rate, all ops at the issue rate) of: ``ops.dispatch.hash_blocks`` at
  [keys, 17, 16] (config 3's 1 KB YCSB leaf), one node level
  (``node_level_cuda``) at [keys, 8] -> [keys / 2, 8], and, unless
  ``--no-ragged``, ``dispatch.hash_ragged`` on ``chip_smoke.py``'s ETC set
  of ``keys`` leaves, with its bulk (``bulk_kernel`` on the order past the
  chained groups) and its chains (``chain_kernel``) each alone;
- a digest of each output, so that the trees are held to each other bit for
  bit at full size, and the first rows of each held to the plain version.

Inputs are random words from ``--seed``, the same in every run. Prints a
table per kernel and tree, the card's name and power limit, and one JSON
object as its last line.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MARK = "PIPES_RESULT "
BLOCKS_PER_LEAF = 17
CHECK_ROWS = 4096
THREADS = 256
# The library's SHA-256 kernels. The first three add in the FMA form, the
# others with plain `+` (csrc/sha256_core.cuh).
KERNELS = ("leaf_kernel", "node_level_kernel", "bulk_kernel", "chain_kernel",
           "node_pairs_kernel", "path_rehash_kernel", "promotion_chain_kernel",
           "hash_chain_kernel")
CLASSES = ("SHF", "LOP3", "IADD3", "IMAD", "LDG", "STL", "LDL")


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_of(mangled: str) -> str | None:
    """The kernel of KERNELS a mangled name is, by its length-prefixed
    identifier (``12chain_kernel`` is not ``17hash_chain_kernel``)."""
    return next((k for k in KERNELS if f"{len(k)}{k}" in mangled), None)


def registers(log: str) -> dict:
    """Registers a thread and spill bytes of each kernel of KERNELS, from
    nvcc's ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_of(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs = int(m.group(1))
            warp = -(-regs * 32 // 256) * 256  # a warp's registers, in units of 256
            out.setdefault(name, {}).update(
                registers=regs, blocks_per_sm=min(65536 // (warp * THREADS // 32), 2048 // THREADS))
            name = None
    return out


def pipe_counts(stats: dict) -> dict:
    """SASS counts per kernel: each class of CLASSES, the IMAD forms, and
    the instruction count and digest."""
    out = {}
    for mangled, st in stats.items():
        name = kernel_of(mangled)
        if name is None:
            continue
        base = collections.Counter()
        for mnem, c in st["ops"].items():
            base[mnem.split(".")[0]] += c
        out[name] = {**{k: base[k] for k in CLASSES},
                     "imad_forms": {m: c for m, c in sorted(st["ops"].items())
                                    if m.split(".")[0] == "IMAD"},
                     "instructions": st["instructions"], "digest": st["digest"]}
    return out


def kernel_code(lib_path: Path, build_log: str, dump_dir: Path) -> dict:
    """SASS counts (``pipe_counts``) and registers (``registers``) of each
    kernel of KERNELS in the library at ``lib_path``; the listing goes to
    ``dump_dir``."""
    sweep = load_module("torch_pairs_sweep", ROOT / "tools" / "torch_pairs_sweep.py")
    keep = tuple(f"{len(n)}{n}" for n in KERNELS)
    code = pipe_counts(sweep.sass(lib_path, keep, dump_dir))
    for name, r in registers(build_log).items():
        code.setdefault(name, {}).update(r)
    return code


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def run_tree(tree: Path, seed: int, keys: int, reps: int, ragged: bool) -> int:
    """One run with ``tree``'s package and kernels."""
    sys.path.insert(0, str(tree))
    import torch

    import merklekv_tpu_torch
    from merklekv_tpu_torch.ops import cuda_lib, dispatch
    from merklekv_tpu_torch.ops import sha256 as plain
    from merklekv_tpu_torch.ops.sha256_cuda import node_level_cuda

    if not Path(merklekv_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"merklekv_tpu_torch came from {merklekv_tpu_torch.__file__}")
    cs = load_module("chip_smoke", ROOT / "chip_smoke.py")
    dev = torch.device("cuda", 0)
    k = cuda_lib.build_kernels()
    code = kernel_code(k.path, k.build_log, tree / "build" / "pipes_sass")

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = {}

    def timed(name: str, fn, nbytes: float, logic: float, adds: float) -> None:
        with cs.ClockSampler() as clk:
            ms = cs.event_ms(fn, reps)
        b_ms = cs.bound_ms(nbytes, logic, adds)
        rows[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": cs.bound_by(nbytes, logic, adds),
                      "share": b_ms / ms, "clocks_sm_mhz": sorted(set(clk.samples))}

    blocks = torch.randint(-(2**31), 2**31 - 1, (keys, BLOCKS_PER_LEAF, 16), dtype=torch.int32,
                           device=dev, generator=gen)
    nblocks = torch.full((keys,), BLOCKS_PER_LEAF, dtype=torch.int32, device=dev)
    leaves = dispatch.hash_blocks(blocks, nblocks)
    if not torch.equal(leaves[:CHECK_ROWS],
                       plain.sha256_blocks(blocks[:CHECK_ROWS], nblocks[:CHECK_ROWS])):
        raise AssertionError("hash_blocks differs from its plain version")
    comp = keys * BLOCKS_PER_LEAF
    timed("hash_blocks", lambda: dispatch.hash_blocks(blocks, nblocks),
          keys * (BLOCKS_PER_LEAF * 64 + 4 + 32), comp * cs.LOGIC_MSG_BLOCK,
          comp * cs.ADDS_MSG_BLOCK)
    rows["hash_blocks"]["digest"] = digest(leaves)
    del blocks, nblocks
    level = node_level_cuda(leaves)
    if not torch.equal(level[:CHECK_ROWS], plain.sha256_node_level(leaves[:2 * CHECK_ROWS])):
        raise AssertionError("node_level_cuda differs from its plain version")
    p = keys // 2
    timed("node_level", lambda: node_level_cuda(leaves), 3 * p * 32, p * cs.LOGIC_NODE,
          p * cs.ADDS_NODE)
    rows["node_level"]["digest"] = digest(level)
    del leaves, level
    if ragged:
        ragged_rows(cs, dev, np.random.default_rng(seed), keys, timed, rows)
    torch.cuda.empty_cache()
    print(MARK + json.dumps({"library": k.path.name, "kernels": code, "times": rows}), flush=True)
    return 0


def ragged_rows(cs, dev, rng, keys: int, timed, rows: dict) -> None:
    """``hash_ragged`` on the ETC set, and its two halves alone through the
    library's entry (which hashes the leaves of the order it is given)."""
    import torch

    from merklekv_tpu_torch.ops import cuda_lib, dispatch
    from merklekv_tpu_torch.ops import sha256 as plain

    etc = cs.etc_ragged_set(dev, rng, keys)
    got = dispatch.hash_ragged(etc)
    lengths = etc.offsets[1:] - etc.offsets[:-1]
    few = etc.order[-CHECK_ROWS:].long()  # the shortest leaves, in bulk_kernel
    sub = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), lengths[few].cumsum(0)])
    idx = torch.cat([torch.arange(int(etc.offsets[i]), int(etc.offsets[i + 1]), device=dev)
                     for i in few.tolist()])
    if not torch.equal(got[few], plain.sha256_ragged(etc.blocks[idx], sub)):
        raise AssertionError("hash_ragged differs from its plain version")
    c, n = etc.chained, etc.n
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)

    def part(order, chained):
        return lambda: cuda_lib.launch("mkv_leaf_ragged", dev, etc.blocks.data_ptr(),
                                       etc.offsets.data_ptr(), order.data_ptr(), out.data_ptr(),
                                       order.shape[0], chained)

    def work(order) -> tuple:
        t = int(lengths[order.long()].sum())
        m = order.shape[0]
        return t * 64 + (m + 1) * 8 + m * 32, t * cs.LOGIC_MSG_BLOCK, t * cs.ADDS_MSG_BLOCK

    timed("hash_ragged", lambda: dispatch.hash_ragged(etc), *work(etc.order))
    rows["hash_ragged"].update(digest=digest(got), leaves=n, blocks=etc.total_blocks,
                               longest=etc.longest, chained=c)
    bulk, chains = etc.order[c:].contiguous(), etc.order[:c].contiguous()
    timed("ragged_bulk", part(bulk, 0), *work(bulk))
    if c:
        timed("ragged_chains", part(chains, c), *work(chains))


def table(runs: list) -> list[str]:
    """One line per kernel and tree (the first run of each tree) and one per
    timed call and run."""
    lines, seen = [], set()
    for r in runs:
        if r["tree"] in seen:
            continue
        seen.add(r["tree"])
        for name in KERNELS:
            st = r["kernels"].get(name)
            if not st:
                continue
            counts = " ".join(f"{c} {st.get(c, '?')}" for c in CLASSES)
            lines.append(f"[sass] {r['tree']:>8} {name:<24} {counts}; regs "
                         f"{st.get('registers', '?')}, spill {st.get('spill_bytes', '?')} B, "
                         f"{st.get('blocks_per_sm', '?')} blocks/SM by regs; "
                         f"{st.get('instructions', '?')} instr, digest {st.get('digest', '?')}; "
                         f"IMAD forms {st.get('imad_forms', {})}")
    for i, r in enumerate(runs):
        for name, t in r["times"].items():
            lines.append(f"[time] run {i + 1} {r['tree']:>8} {name:<14} {t['ms']:.4f} ms, bound "
                         f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {100 * t['share']:.2f}%; "
                         f"clocks.sm {t['clocks_sm_mhz']} MHz; out {t.get('digest')}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR")
    ap.add_argument("--order", default="", help="comma-separated tree names, run in this order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-ragged", action="store_true", help="skip the ETC set")
    ap.add_argument("--run", help=argparse.SUPPRESS)  # one run, with this tree
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sha256_pipes: no CUDA device", file=sys.stderr)
        return 2
    if args.run:
        return run_tree(Path(args.run).resolve(), args.seed, args.keys, args.reps,
                        not args.no_ragged)
    trees = dict(t.split("=", 1) for t in args.tree) or {"this": str(ROOT)}
    order = [name for name in args.order.split(",") if name] or list(trees)
    if set(order) - set(trees):
        ap.error("every name of --order needs a --tree NAME=DIR")
    runs = []
    for name in order:
        tree = Path(trees[name]).resolve()
        t = time.perf_counter()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--run", str(tree), "--seed",
               str(args.seed), "--keys", str(args.keys), "--reps", str(args.reps)]
        proc = subprocess.run(cmd + (["--no-ragged"] if args.no_ragged else []), cwd=tree,
                              capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=str(tree)))
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            raise RuntimeError(f"run {len(runs) + 1} ({name}) failed: rc {proc.returncode}")
        res = json.loads(lines[-1][len(MARK):])
        res.update(tree=name, wall_s=time.perf_counter() - t)
        runs.append(res)
        print(f"[run] {len(runs)} {name}: {res['library']}, {res['wall_s']:.1f} s", flush=True)
    for ln in table(runs):
        print(ln, flush=True)
    outs = {name: {r["times"][name].get("digest") for r in runs} for name in runs[0]["times"]}
    same = all(len(v) == 1 for v in outs.values())
    print(f"[check] every run's outputs equal bit for bit: {same}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"card": card, "same_outputs": same, "runs": runs}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
