#!/usr/bin/env python3
"""Two trees of the repository, one after the other on one card: the serving
mirror (phase 6), the node's serving writes (phase 8's) and the partitioned
cluster (phase 12) of each tree's own ``chip_smoke.py``.

    python3 tools/torch_phase_ab.py --tree parent=DIR --tree change=DIR \\
        --order parent,change,change,parent [--seed 0] [--log-dir DIR]

Run from the repository root on a machine with a CUDA card and ``nvcc``;
each ``DIR`` is an unpacked tree (``git archive``) with its ``chip_smoke.py``.
Each run of the order is a fresh process in that tree: it builds the tree's
kernels, then

- the tree's ``phase_mirror`` as it stands (writes/s, largest
  ``pump_lag_ms``, all its checks);
- the node's serving writes, as phase 8 of ``chip_smoke.py`` drives them: a
  node started in the process with 1M keys loaded into its engine, its
  mirror warmed on the card, 50 batches of 4096 SETs over TCP each closed by
  a forced ``HASH`` (writes/s, largest ``device.pump_lag_ms``; every tenth
  root == ``CpuMerkleState``'s). Phase 8's bisect SYNC is left out: it
  launches no path rehash, and its time is the donor's page selections;
- the tree's ``phase_partitions`` as it stands (split seconds, batch p99 in
  the split window and steady, all its checks).

Host times move between runs with no code change, so compare trees only
within one call, in an order such as A, B, B, A. Prints one line per run
and one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

MARK = "AB_RESULT "


def node_writes(cs, seed: int) -> dict:
    """Phase 8's serving writes with ``cs``, a tree's ``chip_smoke`` module."""
    import tempfile

    import numpy as np

    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.ops import merkle_paths as mp

    rng = np.random.default_rng(seed + 9)
    items = cs._node_items(cs.NODE_KEYS)
    ks = dict(getattr(mp, "PATH_KS", {}))
    with tempfile.TemporaryDirectory(prefix="mkv-ab-") as tmp:
        a = cs._start_node(tmp, "a")
        try:
            cs._engine_load(a.engine, items)
            ca = cs._client(a.port)
            t = time.perf_counter()
            cs._wait_node_mirror(ca, 900)
            warm_s = time.perf_counter() - t
            golden = CpuMerkleState.from_items(items)
            served_s, max_lag = 0.0, 0.0
            for b in range(cs.NODE_BATCHES):
                idx = rng.integers(0, cs.NODE_KEYS, size=cs.BATCH)
                changes = [(b"inc:%09d" % i, b"w%d-%d" % (b, i)) for i in idx]
                cmds = [f"SET {k.decode()} {v.decode()}" for k, v in changes]
                t = time.perf_counter()
                got = ca.pipeline(cmds)
                root = ca.hash(force=True)
                served_s += time.perf_counter() - t
                if got.count("OK") != len(cmds):
                    raise AssertionError(f"batch {b}: SET over TCP failed")
                max_lag = max(max_lag, float(ca.metrics().get("device.pump_lag_ms", 0)))
                golden.apply(changes)
                if (b + 1) % cs.NODE_CHECK_EVERY == 0 and root != golden.root_hex():
                    raise AssertionError(f"forced HASH after batch {b} != CpuMerkleState")
            ca.close()
        finally:
            a.close()
    now = getattr(mp, "PATH_KS", {})
    path_ks = {k: n - ks.get(k, 0) for k, n in now.items() if n > ks.get(k, 0)}
    return {"writes_per_s": cs.NODE_BATCHES * cs.BATCH / served_s, "warm_s": warm_s,
            "max_lag_ms": max_lag, "path_ks": path_ks}


def run_tree(tree: Path, seed: int) -> int:
    """One run in ``tree``: its kernels, its node writes, its phase 12."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs

    if Path(cs.__file__).resolve().parent != tree:
        raise AssertionError(f"chip_smoke came from {cs.__file__}, not {tree}")
    import torch

    cs.phase_build()
    mirror = cs.phase_mirror(torch.device("cuda", 0), seed)
    node = node_writes(cs, seed)
    cs.log(f"[ab] node writes: {node}")
    part = cs.phase_partitions(seed)
    keep = ("split_s", "split_p99_ms", "steady_p99_ms", "replicate_s", "converge_s",
            "load_s", "seconds", "launches")
    out = {"mirror": {k: mirror[k] for k in ("writes_per_s", "warm_s", "max_lag_ms",
                                             "pump_batches")},
           "node": node, "partitions": {k: part[k] for k in keep}}
    if "path_ks" in part:
        out["partitions"]["path_ks"] = {int(k): n for k, n in part["path_ks"].items()}
    print(MARK + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR")
    ap.add_argument("--order", help="comma-separated tree names, run in this order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", help="write each run's whole output here")
    ap.add_argument("--run", help=argparse.SUPPRESS)  # one run, in this tree
    args = ap.parse_args()
    if args.run:
        return run_tree(Path(args.run).resolve(), args.seed)

    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    if not trees or set(order) - set(trees):
        ap.error("every name of --order needs a --tree NAME=DIR")
    runs = []
    for name in order:
        tree = Path(trees[name]).resolve()
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--run", str(tree),
                               "--seed", str(args.seed)], cwd=tree, capture_output=True,
                              text=True, env=dict(os.environ, PYTHONPATH=str(tree)))
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            Path(args.log_dir, f"ab_{len(runs) + 1}_{name}.log").write_text(
                proc.stdout + proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            raise RuntimeError(f"run {len(runs) + 1} ({name}) failed: rc {proc.returncode}")
        res = json.loads(lines[-1][len(MARK):])
        res.update(tree=name, wall_s=time.perf_counter() - t)
        runs.append(res)
        print(f"[ab] {name}: mirror {res['mirror']['writes_per_s']:.0f} writes/s, largest pump "
              f"lag {res['mirror']['max_lag_ms']:.3f} ms; "
              f"node {res['node']['writes_per_s']:.0f} writes/s (warm "
              f"{res['node']['warm_s']:.3f} s, largest pump lag {res['node']['max_lag_ms']:g} "
              f"ms); split {res['partitions']['split_s']:.3f} s, batch p99 "
              f"{res['partitions']['split_p99_ms']:.3f} ms in the split window vs "
              f"{res['partitions']['steady_p99_ms']:.3f} ms steady; run {res['wall_s']:.1f} s",
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
