#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (an uncaught failure exits nonzero):

1. build    — nvcc builds the kernels from ``merklekv_tpu_torch/csrc`` (one nvcc
              per source, started together, then one link) into one library
              under ``build/torch_kernels/``, while g++ builds the node's
              native library (``merklekv_tpu_torch/native``) into
              ``build/native/``;
              prints the build time, nvcc's register report, and the card's
              name and power limit.
2. kernels  — each kernel against its plain PyTorch version on the card, bit
              for bit, over several shapes (N = 1..1M, multi-block messages
              with nblocks 0..3, odd level sizes, P = 16 and 65536), plus a
              few hundred leaves and nodes against ``hashlib``; the fused
              path-rehash kernel on cloned 2^20-leaf levels for k = 1, a
              sibling pair, the first and last leaf, one whole subtree,
              every leaf, 257, 4096 and 65,536 random leaves, and the
              serving path's own input (4096 random one-block leaves,
              [4096, 1, 16]); the promotion-chain kernel for n = 1, 2, 3,
              2^19+1, 1,000,000, 2^20.
3. rebuild  — ``anti_entropy_forward`` at 10M keys (``bench.py::_make_kv``
              shapes) and 8 replicas with 1% of keys diverged per non-reference
              replica: root against the plain version on the card, a
              131,075-key prefix root against the golden CPU tree, counts and
              masks against the injected divergence; median of timed runs.
4. serving  — ``DeviceMerkleState`` over 1M keys: 20 value batches of 4096
              keys (each exactly one fused path-rehash launch and no other
              kernel of ours) and one structural batch, every root and
              TREELEVEL slice (each level's last node included) against the
              golden ``CpuMerkleState``; then sustained writes/s, timed with
              the dispatch guard on (every device call on its own thread).
5. mirror   — the serving mirror (``cluster/mirror.py::DeviceTreeMirror``)
              over a 1M-key engine defined here (a dict and a mutation
              counter): warm on the card (must land on rung 1), 50 batches
              of 4096 value updates staged with ``on_events``, a structural
              batch, a TRUNCATE and a refill; the stamped root, stamped
              TREELEVEL slices (a leaf slice, a mid level, every level's
              promotion-chain edge) and staleness against a
              ``CpuMerkleState`` kept in step, after every 10th batch and
              after each other step. Asserts zero degradations, guard
              errors, guard timeouts, pump errors, warm errors and
              re-warms, at least one pump drain, and launches of
              ``path_rehash`` and
              ``promotion_chain``; prints the warm time, writes/s, pump
              batches and the largest pump lag.
6. drill    — fault containment at 65,536 keys on the card, whose ladder
              ends at rung 1: under a persistent injected ``scatter``
              failure each failed drain invalidates the mirror and re-warms
              it on the card, which then serves the golden root (three
              times; rung 0 is never seen, no degradation is counted);
              after heal fresh writes drain on the card again; then a
              ``scatter`` hang under a 200 ms dispatch deadline: the pump
              survives and no root query blocks past 300 ms. Prints the
              re-warm times and the longest gap between served roots.
7. kernels line — printed after phase 8; per kernel: launches on the main
              path (phases 3 to 6 and 8, each counted from 0) and, as
              ``launches_node``, those of phase 8 alone; its device time (torch.profiler kernel
              time), the plain version's time, and its bound; for the two
              serving kernels the ``[times]`` line also gives a modelled
              latency floor (not in the kernels line: it assumes a clock and
              an issue rate, and measures nothing).
8. node     — the node entry, at 1M keys (config 4) and only through what a
              user runs. 8a: ``python -m merklekv_tpu_torch`` spawned with
              replication on the in-process bus and anti-entropy engine
              ``auto``; the readiness line; 1M keys loaded over TCP (pipelined
              MSET); HASH polled until METRICS shows the mirror on rung 1;
              the stamped HASH's version == ``device.tree_version``, HASH ==
              the golden root, TREELEVEL slices (each level's promotion edge
              included) == the golden tree, again after a value batch; the
              mirror's counters nonzero and its fault counters 0; SIGTERM,
              exit 0. 8b: nodes built in this process by
              ``__main__.start`` (so the launch counters are readable): node
              A, 50 batches of 4096 SETs over TCP each closed by a forced
              HASH (every 10th checked against a ``CpuMerkleState`` kept in
              step); node B = A's keys with 1% diverged (half new values,
              half deleted, all older than A's writes), a bisect SYNC from
              A with B's replication off, repeated while a cycle past its
              120 s budget left a checkpoint to resume (at most 8 cycles):
              the keys repaired over the cycles == injected, the leaf kernel
              ran in each cycle's leaf pass; then B's replication on, its
              mirror on rung 1, roots of A, B and the golden tree equal and
              B's TREELEVEL slices == golden; then a 3-node
              ``sync_multi`` over 100,000 keys (past the 65,536-key device
              threshold) on nodes without mirrors: per-peer divergence ==
              injected, and the leaf kernel ran for its leaf pass. Asserts
              launches of ``path_rehash`` and ``promotion_chain`` from A's
              mirror and zero fallbacks, degradations, guard, pump and warm
              errors and re-warms. Prints load, warm, writes/s, largest
              ``pump_lag_ms``, SYNC and multi-sync wall times.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout of the repository, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# North-star sizes (BASELINE configs 3 and 4).
REBUILD_KEYS = 10_000_000
REPLICAS = 8
DIVERGED_FRACTION = 0.01
PREFIX_KEYS = 131_075
TREE_KEYS = 1_000_000
BATCH = 4096
CHECKED_BATCHES = 20
TIMED_BATCHES = 50
MIRROR_BATCHES = 50
MIRROR_CHECK_EVERY = 10
DRILL_KEYS = 65_536
DRILL_BATCH = 256
DRILL_DEADLINE_MS = 200.0
DRILL_REWARMS = 3
NODE_KEYS = TREE_KEYS
NODE_BATCHES = 50
NODE_CHECK_EVERY = 10
NODE_DIVERGED = 0.01
NODE_MSET = 500
NODE_PIPELINE = 64
NODE_SYNC_CYCLES = 8
MULTI_KEYS = 100_000

# Bound arithmetic (H100 SXM, NVIDIA data sheet): 3.35 TB/s HBM. Shifts and
# logic run only on the 64 INT32 lanes of an SM: 132 SMs x 64 x 1.98 GHz
# boost = 16.7 Tops/s (half the FP32 lanes behind the 67 TFLOP/s float32
# figure). Adds can issue to the FMA pipe as IMAD, so they count only
# against the issue rate (4 warp instructions per SM per clock = 33.5 T
# thread-ops/s). Least instruction counts per compression with 3-input
# LOP3/IADD3 fusion (see csrc/sha256_kernels.cu): a message block is
# 64 x (6 SHF + 4 LOP3) + 48 x (6 SHF + 2 LOP3) shift/logic ops plus
# 64 x 4 + 48 x 2 + 8 adds; the node padding block, with its schedule folded
# away, 64 x 10 plus 64 x 4 + 8.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
LOGIC_MSG_BLOCK, ADDS_MSG_BLOCK = 64 * 10 + 48 * 8, 64 * 4 + 48 * 2 + 8
LOGIC_PAD_BLOCK, ADDS_PAD_BLOCK = 64 * 10, 64 * 4 + 8
LOGIC_NODE = LOGIC_MSG_BLOCK + LOGIC_PAD_BLOCK
ADDS_NODE = ADDS_MSG_BLOCK + ADDS_PAD_BLOCK
# Modelled latency floor of a serial chain of hashes, one thread (so one warp)
# per hash, printed in the [times] line only: a warp issues its shift/logic instructions through its SM
# sub-partition's 16 INT32 lanes, 2 cycles per warp instruction whatever the
# number of active lanes, at the 1.98 GHz boost clock: 3,328 cycles for a
# node hash. (A round's dependent chain, about three ALU instructions, is
# shorter than that issue time.) Memory latency comes on top.
WARP_CYCLES_PER_OP = 2
CLOCK_HZ = 1.98e9
# Kernels the main path (phases 3 to 6 and 8) must launch; node_pairs is held
# against its plain version in phase 2 but no longer runs on the main path.
MAIN_PATH_KERNELS = ("leaf", "node_level", "path_rehash", "promotion_chain")


def log(msg: str) -> None:
    print(msg, flush=True)


def _bound_s(nbytes: float, logic: float, adds: float) -> tuple[float, float]:
    ops_s = max(logic / INT32_OPS_PER_S, (logic + adds) / ISSUE_OPS_PER_S)
    return nbytes / HBM_BYTES_PER_S, ops_s


def bound_ms(nbytes: float, logic: float, adds: float) -> float:
    return max(_bound_s(nbytes, logic, adds)) * 1e3


def bound_by(nbytes: float, logic: float, adds: float) -> str:
    by_bytes, by_ops = _bound_s(nbytes, logic, adds)
    return "bytes" if by_bytes >= by_ops else "operations"


def latency_floor_ms(logic: int) -> float:
    """Modelled least time of hashes that depend on each other, ``logic``
    shift/logic ops in all, issued by one warp (assumed clock and issue rate,
    not a measurement)."""
    return logic * WARP_CYCLES_PER_OP / CLOCK_HZ * 1e3


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time per call of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernel_ms(fn, kernel: str, reps: int, warmup: int = 2) -> tuple[float, int]:
    """Mean device time of the CUDA kernel whose name contains ``kernel``,
    per launch, over ``reps`` calls of ``fn`` (torch.profiler kernel time:
    the kernel's own time on the card, without the host's call overhead),
    and the number of launches the profiler recorded. The profiler can drop
    some records of a short kernel (one H100 run kept 158 of 200), so the
    mean is over those it kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    times = [ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and kernel in ev.name]
    if not 0 < len(times) <= reps:
        raise AssertionError(f"profiler saw {len(times)} launches of {kernel}, expected {reps}")
    return sum(times) / len(times) / 1e3, len(times)


def u32_max_abs_err(a, b) -> int:
    """Largest |a - b| over uint32 words held as int32 (0 when bit-exact)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max().item())


def rand_words(rng: np.random.Generator, shape, dev):
    import torch

    arr = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(dev)


def plain_root(leaves):
    """Odd-promotion root with the plain PyTorch versions only."""
    import torch

    from merklekv_tpu_torch.ops.sha256 import sha256_node_level

    cur = leaves
    while cur.shape[0] > 1:
        nxt = sha256_node_level(cur)
        if cur.shape[0] % 2:
            nxt = torch.cat([nxt, cur[-1:]])
        cur = nxt
    return cur[0]


# ------------------------------------------------------------------ phases

def phase_build() -> dict:
    """The CUDA kernels (nvcc) and, at the same time, the node's native
    library (g++, phase 8), both from the sources in the checkout."""
    from concurrent.futures import ThreadPoolExecutor

    from merklekv_tpu_torch import native_bindings
    from merklekv_tpu_torch.ops.sha256_cuda import build_kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(native_bindings.ensure_built)
        k = build_kernels()
        total = time.perf_counter() - t0
        lib = native.result()
    native_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in k.build_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    log(f"[build] nvcc {k.build_seconds:.2f} s (one compile per source, in parallel, "
        f"then one link), load {total:.2f} s: {k.path.name}; native library (g++, one "
        f"compile per source, in parallel) ready after {native_s:.2f} s: "
        f"{lib.rsplit('/', 1)[-1]}")
    for ln in regs:
        log(f"[build] ptxas {ln}")
    return {"seconds": total}


def phase_kernels(dev, rng: np.random.Generator, sizes=(1, 2, 3, 4097, 1 << 20)) -> dict:
    """Every kernel against its plain version on ``dev``, bit for bit."""
    import torch

    from merklekv_tpu_torch.merkle.encoding import leaf_hash, node_hash
    from merklekv_tpu_torch.merkle.packing import pack_leaves
    from merklekv_tpu_torch.ops import sha256 as plain
    from merklekv_tpu_torch.ops.sha256_cuda import (
        leaf_digests_cuda,
        node_level_cuda,
        node_pairs_cuda,
    )

    errs = {"leaf": 0, "node_level": 0, "node_pairs": 0}
    checks = 0

    def hold(name, got, want, what):
        nonlocal checks
        err = u32_max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        checks += 1
        if err:
            raise AssertionError(f"{name} differs from its plain version on {what}: {err}")

    for n in sizes:
        blocks = rand_words(rng, (n, 1, 16), dev)
        nblocks = torch.ones(n, dtype=torch.int32, device=dev)
        hold("leaf", leaf_digests_cuda(blocks, nblocks), plain.sha256_blocks(blocks, nblocks),
             f"N={n} B=1")
    for n in (5, 4097, 1 << 20):
        blocks = rand_words(rng, (n, 3, 16), dev)
        nb = torch.from_numpy(rng.integers(0, 4, size=n, dtype=np.int32)).to(dev)
        nb[:4] = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
        hold("leaf", leaf_digests_cuda(blocks, nb), plain.sha256_blocks(blocks, nb),
             f"N={n} B=3 mixed nblocks")
    for m in (2, 3, 8, 8193, 1 << 20, (1 << 20) + 1):
        cur = rand_words(rng, (m, 8), dev)
        hold("node_level", node_level_cuda(cur), plain.sha256_node_level(cur), f"M={m}")
    for p in (1, 3, 16, 4097, 65536, 1 << 20):
        left, right = rand_words(rng, (p, 8), dev), rand_words(rng, (p, 8), dev)
        hold("node_pairs", node_pairs_cuda(left, right), plain.sha256_node_pairs(left, right),
             f"P={p}")

    # hashlib: random-byte leaves of 0..200 bytes (1-4 blocks), and nodes.
    keys = [rng.bytes(int(rng.integers(0, 40))) for _ in range(300)]
    vals = [rng.bytes(int(rng.integers(0, 200))) for _ in range(300)]
    packed = pack_leaves(keys, vals)
    got = leaf_digests_cuda(torch.from_numpy(packed.blocks.view(np.int32)).to(dev),
                            torch.from_numpy(packed.nblocks).to(dev))
    want = [leaf_hash(k, v) for k, v in zip(keys, vals)]
    if plain.digests_to_bytes(got.cpu().numpy().view(np.uint32)) != want:
        raise AssertionError("leaf kernel differs from hashlib")
    cur = got[:256].contiguous()
    lv = plain.digests_to_bytes(node_level_cuda(cur).cpu().numpy().view(np.uint32))
    if lv != [node_hash(want[2 * i], want[2 * i + 1]) for i in range(128)]:
        raise AssertionError("node_level kernel differs from hashlib")
    pr = plain.digests_to_bytes(
        node_pairs_cuda(got[:150].contiguous(), got[150:].contiguous()).cpu().numpy().view(np.uint32))
    if pr != [node_hash(want[i], want[150 + i]) for i in range(150)]:
        raise AssertionError("node_pairs kernel differs from hashlib")
    sync()
    log(f"[kernels] {checks} shape checks bit-exact vs plain on the card, "
        f"300 leaves + 278 nodes exact vs hashlib (tolerance: exact equality)")
    return {"max_abs_err": errs}


def path_sets(rng: np.random.Generator, c: int) -> dict:
    """The position sets the fused kernel is held to (sorted, unique)."""
    def rand(k):
        return np.sort(rng.choice(c, size=k, replace=False))

    return {
        "k=1": np.array([c // 3]),
        "sibling pair": np.array([24690, 24691]),
        "first and last leaf": np.array([0, c - 1]),
        "one subtree (4096 leaves)": np.arange(7 * 4096, 8 * 4096),
        "every leaf": np.arange(c),
        "257 random": rand(257),
        "4096 random": rand(4096),
        "65536 random": rand(65536),
    }


def phase_paths(dev, rng: np.random.Generator, depth: int = 20) -> dict:
    """The fused path-rehash and promotion-chain kernels against their plain
    versions on the card, bit for bit, on cloned 2^depth-leaf levels."""
    import torch

    from merklekv_tpu_torch.merkle.incremental import _reduce_levels
    from merklekv_tpu_torch.ops import merkle_paths as mp

    c = 1 << depth
    base = _reduce_levels(rand_words(rng, (c, 8), dev))
    errs = {"path_rehash": 0, "promotion_chain": 0}
    # (what, sorted positions, blocks per leaf, least valid block count)
    cases = [(what, pos, 2, 0) for what, pos in path_sets(rng, c).items()]
    cases.append((f"the serving shape [{BATCH}, 1, 16] at {BATCH} random positions",
                  np.sort(rng.choice(c, size=BATCH, replace=False)), 1, 1))
    for what, pos, nblk, nb_lo in cases:
        k = len(pos)
        blocks = rand_words(rng, (k, nblk, 16), dev)
        nblocks = torch.from_numpy(
            rng.integers(nb_lo, nblk + 1, size=k, dtype=np.int32)).to(dev)
        counters = torch.zeros(c - 1, dtype=torch.int32, device=dev)
        got = [lv.clone() for lv in base]
        want = [lv.clone() for lv in base]
        mp.path_rehash_cuda(got, counters, blocks, nblocks, pos)
        mp.path_rehash(want, blocks, nblocks, pos)
        err = max(u32_max_abs_err(g, w) for g, w in zip(got, want))
        errs["path_rehash"] = max(errs["path_rehash"], err)
        if err:
            raise AssertionError(f"path_rehash differs from its plain version on {what}: {err}")
        if counters.any():
            raise AssertionError(f"path_rehash left arrival counters set on {what}")
        del got, want
    for n in (1, 2, 3, c // 2 + 1, min(1_000_000, c - 1), c):
        err = u32_max_abs_err(mp.promotion_chain_cuda(base, n), mp.promotion_chain(base, n))
        errs["promotion_chain"] = max(errs["promotion_chain"], err)
        if err:
            raise AssertionError(f"promotion_chain differs from its plain version at n={n}: {err}")
    sync()
    log(f"[kernels] path_rehash bit-exact vs plain on cloned 2^{depth}-leaf levels for "
        f"{'; '.join(case[0] for case in cases)}; every level compared whole, padding "
        f"included; counters zero after each; promotion_chain "
        f"bit-exact for n = 1, 2, 3, 2^{depth - 1}+1, {min(1_000_000, c - 1)}, 2^{depth} "
        f"(tolerance: exact equality)")
    return {"max_abs_err": errs}


def make_kv(n: int):
    keys = [b"user:%012d" % i for i in range(n)]
    values = [b"value-%d-payload" % (i % 9973) for i in range(n)]
    return keys, values


def phase_rebuild(dev, seed: int, n_keys: int = REBUILD_KEYS, n_rep: int = REPLICAS,
                  prefix: int = PREFIX_KEYS, reps: int = 5) -> dict:
    import torch

    from merklekv_tpu_torch.merkle.cpu import build_levels as golden_levels
    from merklekv_tpu_torch.merkle.encoding import leaf_hash
    from merklekv_tpu_torch.merkle.packing import pack_leaves
    from merklekv_tpu_torch.merkle.torch_engine import anti_entropy_forward, tree_root
    from merklekv_tpu_torch.ops import sha256 as plain
    from merklekv_tpu_torch.ops.dispatch import hash_blocks
    from merklekv_tpu_torch.ops.sha256_cuda import LAUNCHES, reset_launch_counts

    t0 = time.perf_counter()
    keys, values = make_kv(n_keys)
    t1 = time.perf_counter()
    packed = pack_leaves(keys, values)
    t2 = time.perf_counter()
    blocks = torch.from_numpy(packed.blocks.view(np.int32)).to(dev)
    nblocks = torch.from_numpy(packed.nblocks).to(dev)
    # Replica digests on the device from the seed: replica 0 is the
    # reference; each other replica diverges at 1% of keys, chosen at random
    # without repeats — half with one flipped digest bit, half absent.
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randint(-(2**31), 2**31 - 1, (n_keys, 8), dtype=torch.int32,
                         device=dev, generator=gen)
    digests = base.unsqueeze(0).repeat(n_rep, 1, 1)
    present = torch.ones((n_rep, n_keys), dtype=torch.bool, device=dev)
    expected = torch.zeros((n_rep, n_keys), dtype=torch.bool, device=dev)
    k_div = int(n_keys * DIVERGED_FRACTION)
    for r in range(1, n_rep):
        pos = torch.randperm(n_keys, device=dev, generator=gen)[:k_div]
        flip, gone = pos[: k_div // 2], pos[k_div // 2:]
        digests[r, flip, r % 8] ^= 1
        present[r, gone] = False
        expected[r, pos] = True
    sync()
    t3 = time.perf_counter()
    log(f"[rebuild] host set-up: keys {t1 - t0:.2f} s, pack_leaves {t2 - t1:.2f} s, "
        f"to device + replicas {t3 - t2:.2f} s ({n_keys} keys, B={packed.max_blocks})")

    reset_launch_counts()
    root, masks, counts = anti_entropy_forward(blocks, nblocks, digests, present, device=dev)
    sync()
    launches = dict(LAUNCHES)
    if launches["leaf"] < 1 or launches["node_level"] < 1:
        raise AssertionError(f"rebuild did not run through the kernels: {launches}")

    plain_leaves = plain.sha256_blocks(blocks, nblocks)
    want_root = plain_root(plain_leaves)
    if not torch.equal(root, want_root):
        raise AssertionError("rebuild root differs from the plain version's root")
    want_counts = expected.sum(dim=1, dtype=torch.int32)
    if not torch.equal(counts, want_counts) or not torch.equal(masks, expected):
        raise AssertionError(f"divergence counts {counts.tolist()} != injected {want_counts.tolist()}")
    del plain_leaves

    leaves = hash_blocks(blocks[:prefix], nblocks[:prefix])
    got_prefix = plain.digest_to_bytes(tree_root(leaves).cpu().numpy().view(np.uint32))
    golden = golden_levels([leaf_hash(k, v) for k, v in zip(keys[:prefix], values[:prefix])])
    if got_prefix != golden[-1][0]:
        raise AssertionError(f"{prefix}-key prefix root differs from the golden CPU tree")
    log(f"[rebuild] root == plain root on the card; {prefix}-key prefix root == golden "
        f"CPU tree; counts {counts.tolist()} == injected; launches {launches}")

    times = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        anti_entropy_forward(blocks, nblocks, digests, present, device=dev)
        sync()
        times.append(time.perf_counter() - t)
    med = statistics.median(times)
    log(f"[rebuild] anti_entropy_forward {n_keys} keys x {n_rep} replicas: median "
        f"{med * 1e3:.3f} ms of {reps} (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
        f"{n_keys / med:.0f} keys/s")
    return {"launches": launches, "median_s": med, "keys_per_s": n_keys / med,
            "blocks": blocks, "nblocks": nblocks,
            "forward": lambda: anti_entropy_forward(blocks, nblocks, digests, present, device=dev)}


def _check_serving(dev_state, cpu_state, rng: np.random.Generator, what: str) -> None:
    from merklekv_tpu_torch.merkle.cpu import ref_level_sizes

    if dev_state.root_hex() != cpu_state.root_hex():
        raise AssertionError(f"serving root differs from CpuMerkleState after {what}")
    for level, m in enumerate(ref_level_sizes(cpu_state.leaf_count())):
        mid = int(rng.integers(0, m))
        for lo, hi in ((0, 4), (mid, mid + 4), (m - 3, m)):
            if dev_state.level_nodes(level, lo, hi) != cpu_state.level_nodes(level, lo, hi):
                raise AssertionError(f"level {level} [{lo}, {hi}) differs after {what}")


def phase_serving(dev, seed: int, n_tree: int = TREE_KEYS, batch: int = BATCH,
                  checked: int = CHECKED_BATCHES, timed: int = TIMED_BATCHES) -> dict:
    from merklekv_tpu_torch.device.guard import get_guard
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState
    from merklekv_tpu_torch.ops.sha256_cuda import LAUNCHES, reset_launch_counts

    rng = np.random.default_rng(seed + 1)
    items = [(b"inc:%09d" % i, b"v%d" % i) for i in range(n_tree)]
    cpu = CpuMerkleState.from_items(items)

    reset_launch_counts()
    t0 = time.perf_counter()
    st = DeviceMerkleState.from_items(items, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    _check_serving(st, cpu, rng, "build")
    for b in range(checked):
        idx = rng.integers(0, n_tree, size=batch)
        changes = [(b"inc:%09d" % i, b"u%d-%d" % (b, i)) for i in idx]
        before = dict(LAUNCHES)
        st.apply(changes)
        st.flush_pending()
        delta = {name: LAUNCHES[name] - before[name] for name in LAUNCHES}
        if delta != {**dict.fromkeys(LAUNCHES, 0), "path_rehash": 1}:
            raise AssertionError(f"value batch {b} was not one fused launch: {delta}")
        cpu.apply(changes)
        _check_serving(st, cpu, rng, f"value batch {b}")
    # One structural batch: inserts between and after existing keys,
    # deletes, and value updates of survivors.
    ins = [(b"inc:%09d-x" % i, b"new%d" % i) for i in rng.integers(0, n_tree, size=batch // 2)]
    ins += [(b"inc:%09d" % (n_tree + i), b"tail%d" % i) for i in range(batch // 4)]
    del_idx = rng.integers(0, n_tree, size=batch // 2)
    up_idx = rng.integers(0, n_tree, size=batch // 4)
    dels = [(b"inc:%09d" % i, None) for i in del_idx]
    ups = [(b"inc:%09d" % i, b"s%d" % i) for i in up_idx]
    structural = ins + dels + ups
    st.apply(structural)
    cpu.apply(structural)
    _check_serving(st, cpu, rng, "structural batch")
    sync()
    launches = dict(LAUNCHES)
    if min(launches[name] for name in ("leaf", "node_level", "path_rehash",
                                       "promotion_chain")) < 1 or launches["node_pairs"]:
        raise AssertionError(f"serving path missed a kernel or ran node_pairs: {launches}")
    if st.structural_batches != 1 or st.incremental_batches != checked:
        raise AssertionError("serving batches took the wrong update path")
    log(f"[serving] {n_tree} keys: build {build_s:.3f} s; {checked} value batches of {batch} "
        f"(each exactly 1 path_rehash launch, 0 node_pairs, 0 leaf) + 1 structural batch: "
        f"every root and TREELEVEL slice == CpuMerkleState; launches {launches}")

    # Timed value batches draw from live keys only: a write to a deleted key
    # is an insert, and would time the structural path instead. The dispatch
    # guard is on at its default deadline: every device call runs on a
    # thread of its own.
    live = np.setdiff1d(np.arange(n_tree), np.setdiff1d(del_idx, up_idx))
    if get_guard().deadline_ms <= 0:
        raise AssertionError("the dispatch guard is off")
    all_changes = []
    t = time.perf_counter()
    for b in range(timed):
        idx = live[rng.integers(0, len(live), size=batch)]
        changes = [(b"inc:%09d" % i, b"t%d-%d" % (b, i)) for i in idx]
        st.apply(changes)
        st.flush_pending()
        all_changes.append(changes)
    root = st.root_hash()
    rate = timed * batch / (time.perf_counter() - t)
    for changes in all_changes:
        cpu.apply(changes)
    if root.hex() != cpu.root_hex():
        raise AssertionError("serving root after the timed batches differs from CpuMerkleState")
    if st.structural_batches != 1:
        raise AssertionError("a timed value batch took the structural path")
    log(f"[serving] sustained {rate:.0f} writes/s with the dispatch guard on ({timed} batches "
        f"of {batch}, host staging + packing + device scatter, closed by a root read); "
        f"root == CpuMerkleState")

    def one_batch() -> None:
        idx = live[rng.integers(0, len(live), size=batch)]
        st.apply([(b"inc:%09d" % i, b"p%d" % i) for i in idx])
        st.flush_pending()
        st.root_hash()

    return {"launches": launches, "writes_per_s": rate, "batch": one_batch}


class DictEngine:
    """The key-value engine the mirror reads: a dict and a mutation counter
    (``version()`` counts every write, ``snapshot()`` is sorted)."""

    def __init__(self, items) -> None:
        self._mu = threading.Lock()
        self._d = dict(items)
        self._v = 0

    def version(self) -> int:
        return self._v

    def get(self, key: bytes):
        return self._d.get(key)

    def snapshot(self) -> list:
        with self._mu:
            return sorted(self._d.items())

    def write(self, changes) -> None:
        """(key, value) pairs; a None value deletes."""
        with self._mu:
            for k, v in changes:
                if v is None:
                    self._d.pop(k, None)
                else:
                    self._d[k] = v
                self._v += 1

    def truncate(self) -> None:
        with self._mu:
            self._d.clear()
            self._v += 1


def _events(changes) -> list:
    from merklekv_tpu_torch.cluster.change_event import ChangeEvent, OpKind

    return [ChangeEvent(OpKind.SET if v is not None else OpKind.DEL, k.decode(), v, 0, "smoke")
            for k, v in changes]


def _counters() -> dict:
    from merklekv_tpu_torch.obs.metrics import get_metrics

    return get_metrics().snapshot()["counters"]


def _wait(cond, timeout: float, poll: float = 0.0005) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(poll)
    return False


def _wait_warm(m, base: dict, timeout: float) -> None:
    """Wait for the mirror's warm build. A failed build is counted and the
    mirror stays unready; build again in this thread to raise its error."""
    def done() -> bool:
        return m.ready() or _counters().get("device.warm_errors", 0) > base.get(
            "device.warm_errors", 0)

    if not _wait(done, timeout, 0.01):
        raise AssertionError("the mirror never warmed")
    if not m.ready():
        m.root_hex()  # raises the build's error
        raise AssertionError("the mirror's warm build failed")


def _check_mirror(m, eng, golden, rng: np.random.Generator, what: str) -> None:
    """publish_now, then the stamped root and TREELEVEL slices against the
    golden tree and the engine's version, and staleness 0."""
    from merklekv_tpu_torch.merkle.cpu import ref_level_sizes

    m.publish_now()
    ver = eng.version()
    if m.published_root_stamped() != (golden.root_hex(), ver):
        raise AssertionError(f"mirror root/stamp {m.published_root_stamped()} != golden after {what}")
    if m.staleness() != 0:
        raise AssertionError(f"mirror staleness {m.staleness()} after publish_now ({what})")
    n = golden.leaf_count()
    sizes = ref_level_sizes(n) if n else []
    lo = int(rng.integers(0, max(1, n - 16)))
    mid = len(sizes) // 2
    slices = [(0, lo, lo + 16)] if n else []
    if sizes:
        m_mid = sizes[mid]
        slices.append((mid, max(0, m_mid - 40), m_mid))
        # Every level's last two nodes: the promotion-chain edge.
        slices += [(level, size - 2, size) for level, size in enumerate(sizes)]
    for level, a, b in slices:
        rows, cnt = golden.level_nodes(level, a, b)
        if m.level_nodes_stamped(level, a, b) != (rows, cnt, ver):
            raise AssertionError(f"mirror level {level} [{a}, {b}) differs after {what}")


def phase_mirror(dev, seed: int, n_tree: int = TREE_KEYS, batch: int = BATCH,
                 batches: int = MIRROR_BATCHES) -> dict:
    """The serving mirror on the card: warm, staged value batches drained by
    the pump, a structural batch, a truncate and a refill, each checked
    against the golden tree kept in step."""
    from merklekv_tpu_torch.cluster.change_event import ChangeEvent, OpKind
    from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.ops.sha256_cuda import LAUNCHES, reset_launch_counts

    rng = np.random.default_rng(seed + 2)
    items = [(b"inc:%09d" % i, b"v%d" % i) for i in range(n_tree)]
    eng = DictEngine(items)
    golden = CpuMerkleState.from_items(items)
    base = _counters()

    reset_launch_counts()
    m = DeviceTreeMirror(eng, device=dev)
    try:
        t0 = time.perf_counter()
        m.start_warming()
        _wait_warm(m, base, 600)
        warm_s = time.perf_counter() - t0
        if m.backend_level() != 1:
            raise AssertionError(f"the mirror warmed on rung {m.backend_level()}, not on the card")
        _check_mirror(m, eng, golden, rng, "warm")

        fed_s = 0.0
        max_lag = 0.0
        checks = 1
        for seg in range(0, batches, MIRROR_CHECK_EVERY):
            plan = []
            for b in range(seg, min(seg + MIRROR_CHECK_EVERY, batches)):
                idx = rng.integers(0, n_tree, size=batch)
                changes = [(b"inc:%09d" % i, b"m%d-%d" % (b, i)) for i in idx]
                plan.append((changes, _events(changes)))
            # Timed: from the first staging to the published root that covers
            # the segment's last batch (the pump drains on its own).
            t = time.perf_counter()
            for changes, events in plan:
                eng.write(changes)
                wm = eng.version()
                m.on_events(events, wm)
                max_lag = max(max_lag, m.pump_lag_ms())
            if not _wait(lambda: (m.published_root_stamped() or (None, -1))[1] >= wm, 120):
                raise AssertionError("the pump never published the last batch")
            fed_s += time.perf_counter() - t
            for changes, _ in plan:
                golden.apply(changes)
            _check_mirror(m, eng, golden, rng, f"value batch {seg + len(plan) - 1}")
            checks += 1
        rate = batches * batch / fed_s

        # One structural batch: inserts between and after existing keys,
        # deletes, and value updates.
        structural = [(b"inc:%09d-x" % i, b"new%d" % i) for i in rng.integers(0, n_tree, size=batch // 2)]
        structural += [(b"inc:%09d" % (n_tree + i), b"tail%d" % i) for i in range(batch // 4)]
        structural += [(b"inc:%09d" % i, None) for i in rng.integers(0, n_tree, size=batch // 2)]
        structural += [(b"inc:%09d" % i, b"s%d" % i) for i in rng.integers(0, n_tree, size=batch // 4)]
        eng.write(structural)
        m.on_events(_events(structural), eng.version())
        golden.apply(structural)
        _check_mirror(m, eng, golden, rng, "structural batch")

        # TRUNCATE, then a refill of 4096 keys.
        eng.truncate()
        m.on_events([ChangeEvent(OpKind.TRUNCATE, "", None, 0, "smoke")], eng.version())
        refill = [(b"re:%06d" % i, b"r%d" % i) for i in range(batch)]
        eng.write(refill)
        m.on_events(_events(refill), eng.version())
        golden = CpuMerkleState.from_items(refill)
        _check_mirror(m, eng, golden, rng, "truncate and refill")
        checks += 2
        if m.backend_level() != 1:
            raise AssertionError(f"the mirror left the card: rung {m.backend_level()}")
    finally:
        m.close()
    launches = dict(LAUNCHES)
    delta = {k: v - base.get(k, 0) for k, v in _counters().items()}
    bad = {k: delta.get(k, 0) for k in ("device.degraded_total", "device.guard_errors",
                                         "device.guard_timeouts", "device.pump_errors",
                                         "device.warm_errors", "device.rewarms")}
    if any(bad.values()):
        raise AssertionError(f"the mirror phase met device faults: {bad}")
    if delta.get("device.pump_batches", 0) < 1:
        raise AssertionError("the pump drained no batch")
    if launches["path_rehash"] < 1 or launches["promotion_chain"] < 1:
        raise AssertionError(f"the mirror did not run the serving kernels: {launches}")
    log(f"[mirror] {n_tree} keys on rung 1: warm {warm_s:.3f} s; {batches} batches of {batch} "
        f"value updates staged with on_events: {rate:.0f} writes/s (first staging to the "
        f"published root covering the last batch, {fed_s:.3f} s over "
        f"{batches // MIRROR_CHECK_EVERY} segments); pump batches "
        f"{delta.get('device.pump_batches', 0)}; largest pump_lag_ms {max_lag:.3f}; "
        f"{checks} checks (stamped root, TREELEVEL leaf/mid/edge slices, staleness 0) == "
        f"CpuMerkleState incl. a structural batch, TRUNCATE and refill; fault counters "
        f"{bad}; scatter keys {delta.get('device.scatter_keys', 0)}, "
        f"restructure keys {delta.get('device.restructure_keys', 0)}; launches {launches}")
    return {"launches": launches, "writes_per_s": rate, "warm_s": warm_s,
            "pump_batches": delta.get("device.pump_batches", 0), "max_lag_ms": max_lag}


class _QueryWatch:
    """A thread that reads ``published_root_stamped()`` in a loop and keeps
    the longest gap between served roots and the longest single call."""

    def __init__(self, m) -> None:
        self.m = m
        self.served = 0
        self.max_gap = 0.0
        self.max_call = 0.0
        self.levels: set = set()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True, name="smoke-queries")
        self._t.start()

    def _loop(self) -> None:
        last_ok = time.perf_counter()
        while not self._stop.is_set():
            t = time.perf_counter()
            snap = self.m.published_root_stamped()
            now = time.perf_counter()
            self.levels.add(self.m.backend_level())
            self.max_call = max(self.max_call, now - t)
            if snap is not None:
                self.served += 1
                self.max_gap = max(self.max_gap, now - last_ok)
                last_ok = now
            time.sleep(0.001)

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=10)


def phase_fault_drill(dev, seed: int, n_keys: int = DRILL_KEYS) -> dict:
    """Injected faults at the guard seam on the card: a persistent scatter
    failure invalidates the mirror and re-warms it on the card (its ladder
    ends at rung 1), the re-warmed tree serves golden roots while the fault
    persists, and a hang past the deadline never blocks the pump or a
    query."""
    from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror
    from merklekv_tpu_torch.device.guard import configure
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.ops.sha256_cuda import LAUNCHES, reset_launch_counts
    from merklekv_tpu_torch.testing.device_faults import DeviceFaultInjector

    rng = np.random.default_rng(seed + 3)
    eng = DictEngine((b"drill:%06d" % i, b"v%d" % i) for i in range(n_keys))

    def golden() -> str:
        return CpuMerkleState.from_items(eng.snapshot()).root_hex()

    def write(tag: str) -> None:
        changes = [(b"drill:%06d" % i, b"%s-%d" % (tag.encode(), i))
                   for i in rng.integers(0, n_keys, size=DRILL_BATCH)]
        eng.write(changes)
        m.on_events(_events(changes), eng.version())

    def serves_golden() -> bool:
        m.publish_now()
        return (m.backend_level() == 1
                and m.published_root_stamped() == (golden(), eng.version())
                and m.backend_level() == 1)

    base = _counters()
    reset_launch_counts()
    m = DeviceTreeMirror(eng, device=dev, degrade_after=2, scrub_interval_s=0.0,
                         max_staleness_ms=50.0)
    watch = inj = None
    old_deadline = None
    try:
        m.start_warming()
        _wait_warm(m, base, 300)
        if m.backend_level() != 1 or m.ladder.bottom() != 1:
            raise AssertionError(f"the drill mirror warmed on rung {m.backend_level()} "
                                 f"with a ladder down to {m.ladder.bottom()}")
        watch = _QueryWatch(m)

        # 1. A persistent scatter failure: each failed drain invalidates the
        # mirror and re-warms it on the card, which serves the golden root.
        inj = DeviceFaultInjector(match="scatter", mode="fail").install()
        rewarm_ms = []
        for _ in range(DRILL_REWARMS):
            r0 = _counters().get("device.rewarms", 0)
            t = time.perf_counter()
            write("fault")
            if not _wait(lambda: _counters().get("device.rewarms", 0) > r0, 30):
                raise AssertionError("a drain under the scatter fault did not fail")
            if not _wait(m.ready, 60):
                raise AssertionError("the mirror did not re-warm under the fault")
            rewarm_ms.append((time.perf_counter() - t) * 1e3)
            if not serves_golden():
                raise AssertionError("the re-warmed card did not serve the golden root")
        failures = inj.failures

        # 2. Heal: fresh writes drain on the card again.
        inj.heal()
        inj.uninstall()
        inj = None
        write("healed")
        if not serves_golden():
            raise AssertionError("after heal the card did not serve the golden root")
        fail_gap, watch.max_gap, watch.max_call = watch.max_gap, 0.0, 0.0

        # 3. A scatter hang past a 200 ms deadline: the pump survives, no
        # query blocks past the deadline + 100 ms.
        old_deadline = configure().deadline_ms
        configure(deadline_ms=DRILL_DEADLINE_MS)
        timeouts0 = _counters().get("device.guard_timeouts", 0)
        inj = DeviceFaultInjector(match="scatter", mode="hang").install()
        t_hang = time.perf_counter()
        while time.perf_counter() - t_hang < 3.0:
            write("hang")
            time.sleep(0.02)
        hangs = inj.hangs
        if not (m._pump_thread is not None and m._pump_thread.is_alive()):
            raise AssertionError("the pump died under the hang")
        hung = _counters().get("device.guard_timeouts", 0) - timeouts0
        if hangs < 1 or hung < 1:
            raise AssertionError(f"the hang never reached the guard ({hangs} hangs, {hung} timeouts)")
        hang_call, hang_gap = watch.max_call, watch.max_gap
        if hang_call > (DRILL_DEADLINE_MS + 100.0) / 1e3:
            raise AssertionError(f"a root query blocked {hang_call * 1e3:.1f} ms under the hang")
        inj.heal()
        inj.uninstall()
        inj = None
        configure(deadline_ms=old_deadline)
        old_deadline = None
        if not _wait(lambda: m.ready() and m.backend_level() == 1, 120, 0.002):
            raise AssertionError("the mirror did not re-warm on the card after the hang")
        write("end")
        if not _wait(serves_golden, 30, 0.01):
            raise AssertionError("after the hang the card did not serve the golden root")
        if not m._pump_thread.is_alive():
            raise AssertionError("the pump died")
    finally:
        if watch is not None:
            watch.stop()
        if inj is not None:
            inj.uninstall()
        if old_deadline is not None:
            configure(deadline_ms=old_deadline)
        m.close()
    launches = dict(LAUNCHES)
    delta = {k: v - base.get(k, 0) for k, v in _counters().items()}
    if 0 in watch.levels or delta.get("device.degraded_total", 0):
        raise AssertionError(f"the drill mirror left the card: rungs seen {watch.levels}, "
                             f"degraded {delta.get('device.degraded_total', 0)}")
    log(f"[drill] {n_keys} keys on the card: under a persistent scatter fault "
        f"({failures} injected failures) {DRILL_REWARMS} failed drains each invalidated and "
        f"re-warmed on rung 1 in {', '.join(f'{ms:.1f}' for ms in rewarm_ms)} ms (write to "
        f"ready) and served the golden root; after heal fresh writes served golden; longest "
        f"gap between served roots {fail_gap * 1e3:.1f} ms. Hang at a {DRILL_DEADLINE_MS:g} ms "
        f"deadline: {hangs} hung dispatches, {hung} guard timeouts, pump alive, longest query "
        f"call {hang_call * 1e3:.1f} ms, longest gap {hang_gap * 1e3:.1f} ms, then golden on "
        f"rung 1. Rungs seen {sorted(watch.levels)}, degraded "
        f"{delta.get('device.degraded_total', 0)}, re-warms {delta.get('device.rewarms', 0)}, "
        f"warm errors {delta.get('device.warm_errors', 0)}, served roots {watch.served}; "
        f"launches {launches}")
    return {"launches": launches, "rewarm_ms": rewarm_ms, "max_gap_ms": fail_gap * 1e3,
            "hang_call_ms": hang_call * 1e3}


# ------------------------------------------------------------ phase 8: node

def _node_items(n: int) -> list:
    return [(b"inc:%09d" % i, b"v%d" % i) for i in range(n)]


def _node_config(path, topic: str, replication: bool = True) -> None:
    """A node's TOML: replication on the in-process bus (which gives the
    node its serving mirror), anti-entropy engine ``auto`` and bisect walks."""
    with open(path, "w") as f:
        f.write(f'[replication]\nenabled = {"true" if replication else "false"}\n'
                f'mqtt_broker = "local"\ntopic_prefix = "{topic}"\n'
                '[anti_entropy]\nengine = "auto"\nmode = "bisect"\n')


def _client(port: int):
    from merklekv_tpu_torch.client import MerkleKVClient

    c = MerkleKVClient("127.0.0.1", port, timeout=600)
    c.connect()
    return c


def _tcp_load(c, items, per_cmd: int = NODE_MSET, depth: int = NODE_PIPELINE) -> None:
    """Load ``items`` over TCP: MSET commands of ``per_cmd`` pairs, ``depth``
    commands pipelined per round trip."""
    cmds = ["MSET " + " ".join(f"{k.decode()} {v.decode()}" for k, v in items[i:i + per_cmd])
            for i in range(0, len(items), per_cmd)]
    for i in range(0, len(cmds), depth):
        got = c.pipeline(cmds[i:i + depth])
        if any(r != "OK" for r in got):
            raise AssertionError(f"MSET over TCP failed: {[r for r in got if r != 'OK'][:3]}")


def _stamped_hash(c, force: bool = False) -> tuple:
    """``HASH vs=01`` (``vs=03`` forces a refresh): (root hex, tree version,
    lag) as the node serves it."""
    resp = c._request("HASH vs=03" if force else "HASH vs=01").strip()
    fields = resp.split(" ")
    if fields[0] != "HASH" or len(fields) != 4:
        raise AssertionError(f"no stamped HASH answer: {resp!r}")
    return fields[1], int(fields[2]), int(fields[3])


def _wait_node_mirror(c, timeout: float) -> dict:
    """Poll HASH (which starts the mirror's warm) until METRICS shows the
    mirror on rung 1 with a published tree version."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        c.hash()
        m = c.metrics()
        if m.get("device.backend_level") == "1" and "device.tree_version" in m:
            return m
        time.sleep(0.05)
    raise AssertionError(f"the node's mirror never reached rung 1: {c.metrics()}")


def _check_node_tree(c, golden, rng: np.random.Generator, what: str) -> int:
    """The node's HASH and TREELEVEL slices (a few per level, each level's
    promotion edge included) against the golden tree; returns the slices
    checked."""
    from merklekv_tpu_torch.merkle.cpu import ref_level_sizes

    root = c.hash(force=True)
    if root != golden.root_hex():
        raise AssertionError(f"HASH {root} != golden {golden.root_hex()} after {what}")
    checked = 0
    n = golden.leaf_count()
    for level, m in enumerate(ref_level_sizes(n)):
        mid = int(rng.integers(0, m))
        for lo, hi in ((0, 4), (mid, mid + 4), (max(0, m - 3), m)):
            rows, cnt = c.tree_level(level, lo, hi)
            want, wn = golden.level_nodes(level, lo, hi)
            if cnt != wn or [(i, bytes.fromhex(h)) for i, h in rows] != want:
                raise AssertionError(f"TREELEVEL {level} [{lo}, {hi}) differs after {what}")
            checked += 1
    return checked


_NODE_FAULTS = ("device.fallbacks", "device.degraded_total", "device.guard_errors",
                "device.pump_errors", "device.warm_errors", "device.rewarms")


def phase_node_entry(seed: int, n_keys: int = NODE_KEYS, batch: int = BATCH) -> dict:
    """8a: ``python -m merklekv_tpu_torch`` as a user starts it, driven over
    TCP only."""
    import os
    import signal
    import tempfile
    from pathlib import Path

    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState

    rng = np.random.default_rng(seed + 8)
    root_dir = Path(__file__).resolve().parent
    items = _node_items(n_keys)
    with tempfile.TemporaryDirectory(prefix="mkv-smoke-") as tmp:
        cfg = os.path.join(tmp, "node.toml")
        _node_config(cfg, "smoke-entry")
        env = dict(os.environ, PYTHONPATH=str(root_dir))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "merklekv_tpu_torch", "--config", cfg, "--port", "0"],
            cwd=str(root_dir), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            if not line.startswith("merklekv_tpu_torch listening on "):
                proc.kill()
                raise AssertionError(f"no readiness line: {line!r} {proc.stderr.read()[-2000:]}")
            start_s = time.perf_counter() - t0
            port = int(line.split()[3].rsplit(":", 1)[1])
            c = _client(port)
            t = time.perf_counter()
            _tcp_load(c, items)
            load_s = time.perf_counter() - t
            golden = CpuMerkleState.from_items(items)
            t = time.perf_counter()
            m = _wait_node_mirror(c, 900)
            warm_s = time.perf_counter() - t
            root, ver, lag = _stamped_hash(c)
            if str(ver) != m["device.tree_version"]:
                raise AssertionError(f"stamped HASH version {ver} != device.tree_version "
                                     f"{m['device.tree_version']}")
            if root != golden.root_hex():
                raise AssertionError("the node's stamped HASH differs from the golden root")
            slices = _check_node_tree(c, golden, rng, "the TCP load")
            # One value batch after the warm, so the pump drains on the card.
            idx = rng.integers(0, n_keys, size=batch)
            changes = [(b"inc:%09d" % i, b"e%d" % i) for i in idx]
            _tcp_load(c, changes)
            golden.apply(changes)
            slices += _check_node_tree(c, golden, rng, "a value batch")
            m = c.metrics()
            if m.get("device.backend_level") != "1":
                raise AssertionError(f"the node left rung 1: {m.get('device.backend_level')}")
            bad = {k: int(m.get(k, 0)) for k in _NODE_FAULTS}
            counters = {k: int(m.get(k, 0)) for k in ("device.pump_batches", "device.scatter_keys")}
            if any(bad.values()) or not all(counters.values()):
                raise AssertionError(f"node METRICS: faults {bad}, mirror counters {counters}")
            c.close()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(120)
            if rc != 0:
                raise AssertionError(f"the node exited {rc} on SIGTERM: {proc.stderr.read()[-2000:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    log(f"[node] entry: python -m merklekv_tpu_torch ready in {start_s:.3f} s; {n_keys} keys loaded "
        f"over TCP (MSET x {NODE_MSET}, {NODE_PIPELINE} pipelined) in {load_s:.3f} s; mirror on "
        f"rung 1 in {warm_s:.3f} s (device.tree_version {ver} == stamped HASH version, lag "
        f"{lag}); HASH == golden root and {slices} TREELEVEL slices == golden tree (promotion "
        f"edges included), before and after a batch of {batch}; mirror counters {counters}; "
        f"faults {bad}; SIGTERM exit 0")
    return {"load_s": load_s, "warm_s": warm_s, "start_s": start_s}


def _start_node(tmp: str, name: str, replication: bool = True):
    import os

    from merklekv_tpu_torch.__main__ import parse_config, start

    cfg = os.path.join(tmp, f"{name}.toml")
    _node_config(cfg, f"smoke-{name}", replication)
    return start(parse_config(["--config", cfg, "--port", "0"]))


def _engine_load(engine, items, deletes=(), ts=None) -> None:
    """Load straight into a node's engine (before its mirror warms, so the
    warm reads it): the writes, then the deletes, at time ``ts`` (ns;
    ``None`` = now) and ``ts + 1``."""
    for i in range(0, len(items), 65536):
        t = time.time_ns() if ts is None else ts
        engine.apply_batch([(k, v, t) for k, v in items[i:i + 65536]])
    if deletes:
        t = time.time_ns() if ts is None else ts + 1
        engine.apply_batch([(k, None, t) for k in deletes])


def _diverge(rng: np.random.Generator, keys: list, fraction: float, tag: bytes):
    """Pick ``fraction`` of ``keys``: half get a new value, half are deleted."""
    pick = rng.choice(len(keys), size=int(len(keys) * fraction), replace=False)
    half = len(pick) // 2
    changed = {keys[i]: tag + b"%d" % i for i in pick[:half]}
    deleted = [keys[i] for i in pick[half:]]
    return changed, deleted


def phase_node_sync(seed: int, n_keys: int = NODE_KEYS, batch: int = BATCH,
                    batches: int = NODE_BATCHES, multi_keys: int = MULTI_KEYS) -> dict:
    """8b: nodes built in-process by ``__main__.start``: serving writes over
    TCP with a forced HASH after each batch, a bisect SYNC of a 1%-diverged
    node, and a 3-node multi-sync past the device threshold."""
    import tempfile

    from merklekv_tpu_torch.cluster.sync import _DEVICE_THRESHOLD
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.ops.sha256_cuda import LAUNCHES, reset_launch_counts

    rng = np.random.default_rng(seed + 9)
    items = _node_items(n_keys)
    base = _counters()
    runs = []
    with tempfile.TemporaryDirectory(prefix="mkv-smoke-") as tmp:
        try:
            reset_launch_counts()
            a = _start_node(tmp, "a")
            runs.append(a)
            _engine_load(a.engine, items)
            ca = _client(a.port)
            t = time.perf_counter()
            _wait_node_mirror(ca, 900)
            warm_s = time.perf_counter() - t
            golden = CpuMerkleState.from_items(items)
            checks = _check_node_tree(ca, golden, rng, "the warm")

            # Value batches over TCP, each closed by a forced HASH.
            before = dict(LAUNCHES)
            max_lag = 0.0
            served_s = 0.0
            for b in range(batches):
                idx = rng.integers(0, n_keys, size=batch)
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
                if (b + 1) % NODE_CHECK_EVERY == 0:
                    if root != golden.root_hex():
                        raise AssertionError(f"forced HASH after batch {b} != CpuMerkleState")
                    checks += _check_node_tree(ca, golden, rng, f"batch {b}")
            rate = batches * batch / served_s
            serve_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            if serve_launches["path_rehash"] < 1 or serve_launches["promotion_chain"] < 1:
                raise AssertionError(f"the node's mirror did not run the serving kernels: "
                                     f"{serve_launches}")

            # B: A's content with 1% diverged (half other values, half
            # deleted), then a bisect SYNC from A. B is the stale replica:
            # its writes are older than A's, so the walk's one-way repair
            # and the last-writer-wins install of a resumed cycle's pending
            # repairs (the reference's rule) both take A's side.
            # B repairs with replication off (the procedure for a diverged
            # node), so its mirror does not restructure a 1M-key tree for
            # every repaired insert; it warms on the card afterwards.
            final = a.engine.snapshot()
            keys = [k for k, _ in final]
            changed, deleted = _diverge(rng, keys, NODE_DIVERGED, b"div")
            bnode = _start_node(tmp, "b", replication=False)
            runs.append(bnode)
            _engine_load(bnode.engine, [(k, changed.get(k, v)) for k, v in final], deleted,
                         ts=1)
            cb = _client(bnode.port)
            # The deletions shift every leaf position after the first one,
            # so the walk repairs nearly the whole key range; a cycle past
            # its budget (SYNC_PEER's op_deadline) checkpoints its cursor
            # and the next SYNC resumes there, as a node's periodic loop
            # would. Each cycle counts the keys it repaired.
            sm, peer = bnode.node.sync_manager, f"127.0.0.1:{a.port}"
            # What one request of the walk's range repair costs A here.
            t = time.perf_counter()
            for i in range(5):
                ca.leaf_hashes_page(512, (b"inc:%09d" % (i * n_keys // 5)).decode())
            page_ms = (time.perf_counter() - t) * 200
            t = time.perf_counter()
            for i in range(5):
                ca.mget([(b"inc:%09d" % (i * n_keys // 5)).decode()])
            mget_ms = (time.perf_counter() - t) * 200
            before = dict(LAUNCHES)
            t = time.perf_counter()
            found, cycles = 0, []
            while not cycles or sm.session_for(peer) is not None:
                if len(cycles) == NODE_SYNC_CYCLES:
                    raise AssertionError(f"SYNC B <- A still resuming after {cycles}")
                c0 = time.perf_counter()
                if not cb.sync_with("127.0.0.1", a.port):
                    raise AssertionError(f"SYNC B <- A failed in cycle {len(cycles) + 1}")
                rep = sm.last_report
                if rep.mode != "bisect":
                    raise AssertionError(f"SYNC cycle {len(cycles) + 1} walked {rep.mode!r}")
                found += rep.divergent
                cycles.append((round(time.perf_counter() - c0, 3), rep.divergent))
            sync_s = time.perf_counter() - t
            sync_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            injected = len(changed) + len(deleted)
            if found != injected:
                raise AssertionError(f"SYNC found {found} divergent keys in {cycles}, "
                                     f"injected {injected}")
            if sync_launches["leaf"] < len(cycles):
                raise AssertionError(f"the SYNC leaf passes did not run the leaf kernel: "
                                     f"{sync_launches}")
            if not cb.replicate("enable"):
                raise AssertionError("REPLICATE enable on B failed")
            t = time.perf_counter()
            _wait_node_mirror(cb, 900)
            warm_b_s = time.perf_counter() - t
            root_a, root_b = ca.hash(force=True), cb.hash(force=True)
            if not root_a == root_b == golden.root_hex():
                raise AssertionError(f"roots after SYNC: A {root_a}, B {root_b}, golden "
                                     f"{golden.root_hex()}")
            checks += _check_node_tree(cb, golden, rng, "the SYNC")
            for c in (ca, cb):
                if c.metrics().get("device.backend_level") != "1":
                    raise AssertionError("a node's mirror left rung 1")
                c.close()
            for r in runs:
                r.close()
            runs.clear()

            # Three nodes without mirrors: the multi-sync's leaf pass and
            # masks are the only device work.
            if multi_keys < _DEVICE_THRESHOLD:
                raise AssertionError(f"{multi_keys} union keys do not cross the device "
                                     f"threshold {_DEVICE_THRESHOLD}")
            m_items = [(b"ms:%09d" % i, b"m%d" % i) for i in range(multi_keys)]
            m_keys = [k for k, _ in m_items]
            local = _start_node(tmp, "l", replication=False)
            runs.append(local)
            _engine_load(local.engine, m_items)
            want = {}
            for name, tag in (("p1", b"one"), ("p2", b"two")):
                ch, dl = _diverge(rng, m_keys, NODE_DIVERGED, tag)
                peer = _start_node(tmp, name, replication=False)
                runs.append(peer)
                _engine_load(peer.engine, [(k, ch.get(k, v)) for k, v in m_items], dl)
                want[f"127.0.0.1:{peer.port}"] = len(ch) + len(dl)
            before = dict(LAUNCHES)
            t = time.perf_counter()
            mrep = local.node.sync_manager.sync_multi(list(want))
            multi_s = time.perf_counter() - t
            multi_launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            if mrep.per_peer_divergent != want or mrep.union_keys < _DEVICE_THRESHOLD:
                raise AssertionError(f"multi-sync divergence {mrep.per_peer_divergent} over "
                                     f"{mrep.union_keys} keys, injected {want}")
            if multi_launches["leaf"] < 1:
                raise AssertionError(f"the multi-sync leaf pass did not run the leaf kernel: "
                                     f"{multi_launches}")
        finally:
            for r in runs:
                r.close()
    launches = dict(LAUNCHES)
    delta = {k: v - base.get(k, 0) for k, v in _counters().items()}
    bad = {k: delta.get(k, 0) for k in _NODE_FAULTS + ("device.guard_timeouts",)}
    if any(bad.values()):
        raise AssertionError(f"the node phase met device faults: {bad}")
    log(f"[node] in-process nodes: A warm {warm_s:.3f} s on rung 1; {batches} batches of {batch} "
        f"SETs over TCP, each closed by a forced HASH: {rate:.0f} writes/s; largest "
        f"device.pump_lag_ms {max_lag:g}; {checks} HASH/TREELEVEL checks == CpuMerkleState; "
        f"serving launches {serve_launches}")
    log(f"[node] bisect SYNC of B ({n_keys} keys, {injected} diverged: {len(changed)} values, "
        f"{len(deleted)} deletes) from A: {sync_s:.3f} s in {len(cycles)} cycles (s, keys "
        f"repaired: {cycles}), last cycle {rep.nodes_compared} nodes compared in {rep.rounds} "
        f"rounds, {rep.bytes_received} B received; A answers a HASHPAGE of 512 rows in "
        f"{page_ms:.2f} ms, an MGET of one key in {mget_ms:.3f} ms; then B's mirror on rung 1 "
        f"in {warm_b_s:.3f} s; roots of A, B and golden equal; launches {sync_launches}")
    log(f"[node] 3-node sync_multi over {mrep.union_keys} union keys (device threshold "
        f"{_DEVICE_THRESHOLD}): {multi_s:.3f} s, per-peer divergence "
        f"{sorted(mrep.per_peer_divergent.values())} == injected; launches {multi_launches}; "
        f"faults {bad}; phase launches {launches}")
    return {"launches": launches, "writes_per_s": rate, "warm_s": warm_s, "max_lag_ms": max_lag,
            "sync_s": sync_s, "multi_s": multi_s}


def path_work(pos: np.ndarray, depth: int) -> dict:
    """What the fused kernel must do for these sorted positions on a
    2^depth-leaf tree: distinct touched internal nodes (each hashed once)
    and untouched siblings (each read once)."""
    distinct = untouched = 0
    cur = np.unique(pos)
    for _ in range(depth):
        untouched += int(np.count_nonzero(~np.isin(cur ^ 1, cur)))
        cur = np.unique(cur >> 1)
        distinct += len(cur)
    return {"distinct": distinct, "untouched": untouched}


def phase_kernel_times(dev, rng, blocks, nblocks, errs, launches) -> list:
    """Time each kernel at the main path's shapes (device time from
    torch.profiler) against its plain version and its bound; build the
    kernels line."""
    import torch

    from merklekv_tpu_torch.merkle.cpu import ref_level_sizes
    from merklekv_tpu_torch.merkle.incremental import _reduce_levels
    from merklekv_tpu_torch.ops import merkle_paths as mp
    from merklekv_tpu_torch.ops import sha256 as plain
    from merklekv_tpu_torch.ops.sha256_cuda import (
        leaf_digests_cuda,
        node_level_cuda,
        node_pairs_cuda,
    )

    n, nblk = blocks.shape[0], blocks.shape[1]
    leaves = leaf_digests_cuda(blocks, nblocks)
    pairs_l, pairs_r = rand_words(rng, (BATCH, 8), dev), rand_words(rng, (BATCH, 8), dev)
    n_blocks_hashed = int(nblocks.clamp(0, nblk).sum().item())
    p_level = n // 2

    # The serving path's shapes: a batch of 4096 one-block leaves at random
    # positions of the 2^20-leaf tree, and the chain over 1M live keys.
    depth = (TREE_KEYS - 1).bit_length()
    tree = _reduce_levels(rand_words(rng, (1 << depth, 8), dev))
    tree_plain = [lv.clone() for lv in tree]
    counters = torch.zeros((1 << depth) - 1, dtype=torch.int32, device=dev)
    pos = np.sort(rng.choice(1 << depth, size=BATCH, replace=False))
    pblocks = rand_words(rng, (BATCH, 1, 16), dev)
    pnblocks = torch.ones(BATCH, dtype=torch.int32, device=dev)
    work = path_work(pos, depth)
    # The chain hashes once per reference level whose size below is even.
    sizes = ref_level_sizes(TREE_KEYS)
    even = sum(m % 2 == 0 for m in sizes[:-1])
    nlev = len(sizes)

    rows = [
        ("leaf", "sha256_kernels.cu", "merklekv_tpu/ops/sha256_pallas.py:170", "leaf_kernel",
         lambda: leaf_digests_cuda(blocks, nblocks), lambda: plain.sha256_blocks(blocks, nblocks),
         blocks.numel() * 4 + nblocks.numel() * 4 + n * 32,
         n_blocks_hashed * LOGIC_MSG_BLOCK, n_blocks_hashed * ADDS_MSG_BLOCK, None,
         f"[{n}, {nblk}, 16]", 10),
        ("node_level", "sha256_kernels.cu", "merklekv_tpu/ops/sha256_pallas.py:293",
         "node_level_kernel",
         lambda: node_level_cuda(leaves), lambda: plain.sha256_node_level(leaves),
         2 * p_level * 32 + p_level * 32, p_level * LOGIC_NODE, p_level * ADDS_NODE, None,
         f"[{n}, 8]", 10),
        ("node_pairs", "sha256_kernels.cu", "merklekv_tpu/ops/sha256_pallas.py:250",
         "node_pairs_kernel",
         lambda: node_pairs_cuda(pairs_l, pairs_r), lambda: plain.sha256_node_pairs(pairs_l, pairs_r),
         3 * BATCH * 32, BATCH * LOGIC_NODE, BATCH * ADDS_NODE, None,
         f"[{BATCH}, 8] x 2", 200),
        ("path_rehash", "merkle_paths.cu", "merklekv_tpu/ops/sha256_pallas.py:250",
         "path_rehash_kernel",
         lambda: mp.path_rehash_cuda(tree, counters, pblocks, pnblocks, pos),
         lambda: mp.path_rehash(tree_plain, pblocks, pnblocks, pos),
         BATCH * (64 + 4 + 4 + 32) + 32 * (work["distinct"] + work["untouched"]),
         work["distinct"] * LOGIC_NODE + BATCH * LOGIC_MSG_BLOCK,
         work["distinct"] * ADDS_NODE + BATCH * ADDS_MSG_BLOCK,
         latency_floor_ms(LOGIC_MSG_BLOCK + depth * LOGIC_NODE),
         f"k={BATCH} of 2^{depth}, {work['distinct']} distinct nodes", 200),
        ("promotion_chain", "merkle_paths.cu", "merklekv_tpu/ops/sha256_pallas.py:250",
         "promotion_chain_kernel",
         lambda: mp.promotion_chain_cuda(tree, TREE_KEYS),
         lambda: mp.promotion_chain(tree, TREE_KEYS),
         (1 + even) * 32 + nlev * 32, even * LOGIC_NODE, even * ADDS_NODE,
         latency_floor_ms(even * LOGIC_NODE),
         f"n={TREE_KEYS} on 2^{depth}, {even} node hashes", 200),
    ]
    out = []
    for name, src, repl, kname, kern, ref, nbytes, logic, adds, floor, shape, reps in rows:
        ms, seen = profiled_kernel_ms(kern, kname, reps)
        call_ms = event_ms(kern, reps)
        plain_ms = event_ms(ref, 2, warmup=1)
        b_ms, by = bound_ms(nbytes, logic, adds), bound_by(nbytes, logic, adds)
        floor_txt = "" if floor is None else (
            f", modelled latency floor {floor:.4f} ms at an assumed {CLOCK_HZ / 1e9} GHz, "
            f"{WARP_CYCLES_PER_OP} cycles per warp op")
        log(f"[times] {name} at {shape}: device {ms:.4f} ms per launch ({seen} of {reps} "
            f"launches profiled; back-to-back calls "
            f"{call_ms:.4f} ms; plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {by}: {nbytes} B, "
            f"{logic} shift/logic + {adds} add ops{floor_txt})")
        out.append({
            "name": name, "route": "cuda", "source": f"merklekv_tpu_torch/csrc/{src}",
            "replaces": repl, "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None,
        })
    # The level kernel reads rows (2i, 2i+1) as one contiguous message; the
    # alternative is an even/odd split of the level plus the pairs kernel.
    split_ms = event_ms(
        lambda: node_pairs_cuda(leaves[0 : 2 * p_level : 2].contiguous(),
                                leaves[1 : 2 * p_level : 2].contiguous()), 10)
    log(f"[times] even/odd split + node_pairs at [{n}, 8]: {split_ms:.4f} ms "
        f"(node_level {out[1]['ms']:.4f} ms)")
    return out


def device_profile(label: str, fn, reps: int) -> dict:
    """One line: device time per call of ``fn``, the profiled wall time, the
    busy share, the device operations per call (kernels and copies), and
    the largest of them (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall = time.perf_counter() - t
    by_name: dict[str, float] = {}
    kernels = copies = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
            if ev.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    tops = "; ".join(f"{name[:48]} {ms / reps:.4f}" for name, ms in top)
    log(f"[profile] {label}: device {busy / reps:.4f} ms per call, wall {wall * 1e3 / reps:.3f} "
        f"ms per call under the profiler, busy {busy / (wall * 1e3):.4f}; per call "
        f"{kernels / reps:.1f} kernel launches + {copies / reps:.1f} copies/memsets; "
        f"top (ms/call): {tops}")
    return {"device_ms": busy / reps, "kernels": kernels / reps, "copies": copies / reps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 2
    import merklekv_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    log(f"[device] {kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} visible; nvidia-smi: {card}")
    rng = np.random.default_rng(args.seed)

    phase_build()
    errs = phase_kernels(dev, rng)["max_abs_err"]
    errs.update(phase_paths(dev, rng)["max_abs_err"])
    reb = phase_rebuild(dev, args.seed)
    srv = phase_serving(dev, args.seed)
    mir = phase_mirror(dev, args.seed)
    drill = phase_fault_drill(dev, args.seed)
    entry = phase_node_entry(args.seed)
    node = phase_node_sync(args.seed)
    phases = {"rebuild": reb, "serving": srv, "mirror": mir, "drill": drill, "node": node}
    launches = {k: sum(ph["launches"][k] for ph in phases.values()) for k in srv["launches"]}
    if min(launches[name] for name in MAIN_PATH_KERNELS) < 1:
        raise AssertionError(f"a kernel was never launched on the main path: {launches}")
    log("[launches] " + "; ".join(f"{name} {ph['launches']}" for name, ph in phases.items()))
    kernels = phase_kernel_times(dev, rng, reb["blocks"], reb["nblocks"], errs, launches)
    for k in kernels:
        k["launches_node"] = node["launches"][k["name"]]
    device_profile("rebuild+diff 10M x 8", reb.pop("forward"), 3)
    batch = srv.pop("batch")
    prof = device_profile("serving batch of 4096 + root read", batch, 5)
    log(f"[summary] rebuild+diff 10M x 8: {reb['median_s'] * 1e3:.3f} ms, "
        f"{reb['keys_per_s']:.0f} keys/s; serving 1M: {srv['writes_per_s']:.0f} writes/s "
        f"(guarded), {prof['device_ms']:.4f} ms device and {prof['kernels']:.1f} kernel "
        f"launches + {prof['copies']:.1f} copies per batch of {BATCH} + root read; mirror 1M: "
        f"warm {mir['warm_s']:.3f} s, {mir['writes_per_s']:.0f} writes/s, "
        f"{mir['pump_batches']} pump batches, largest pump lag {mir['max_lag_ms']:.3f} ms; "
        f"drill: re-warms {', '.join(f'{ms:.1f}' for ms in drill['rewarm_ms'])} ms, longest query gap "
        f"{drill['max_gap_ms']:.1f} ms, longest query under hang {drill['hang_call_ms']:.1f} ms; "
        f"node 1M: load over TCP {entry['load_s']:.3f} s, warm {entry['warm_s']:.3f} s (in-process "
        f"{node['warm_s']:.3f} s), {node['writes_per_s']:.0f} writes/s with a forced HASH per "
        f"batch, largest pump lag {node['max_lag_ms']:g} ms, bisect SYNC {node['sync_s']:.3f} s, "
        f"3-node sync_multi {node['multi_s']:.3f} s; card {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
