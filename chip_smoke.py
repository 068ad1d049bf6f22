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
              with nblocks 0..3, odd level sizes; the pairs kernel at P = 1,
              3, 16, 31-33, 127-129, 4095-4097, 4 x 32 x SMs +- 1, 65,536,
              65,537 and 2^20, three rows of each also against
              ``hashlib``), plus a
              few hundred leaves and nodes against ``hashlib``; the
              path-rehash kernel on cloned 2^20-leaf levels for k = 1, a
              sibling pair, the first and last leaf, one whole subtree,
              every leaf, 257, 4096 and 65,536 random leaves, a Zipf-skewed
              set, one position per 2^8-leaf subtree, and the serving
              path's own input (4096 random one-block leaves, [4096, 1,
              16]), its scratch zero again after each, and its device time
              on each set; the promotion-chain kernel for n = 1, 2, 3,
              2^19+1, 1,000,000, 2^20.
3. rebuild  — ``anti_entropy_forward`` at 10M keys (``bench.py::_make_kv``
              shapes) and 8 replicas with 1% of keys diverged per non-reference
              replica: root against the plain version on the card, a
              131,075-key prefix root against the golden CPU tree, counts and
              masks against the injected divergence; median of timed runs.
4. serving  — ``DeviceMerkleState`` over 1M keys: 20 value batches of 4096
              keys (each exactly one path-rehash launch and no other
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
              re-warm times and the longest gap between served roots. Then
              the process's flight ring is spilled to a temporary file and
              ``python -m merklekv_tpu_torch blackbox --json`` reads it: rc
              0, the drill's failed drains as ``device_rewarm`` events with
              their classified kinds, and the step-downs in the ring (phase
              9d's: a mirror on the card ends at rung 1) as
              ``device_degraded`` anomalies with their ``environment|code``
              kinds.
7. kernels line — printed after phase 10; per kernel: launches on the main
              path (phases 3 to 6 and 8 to 13, each counted from 0; phase
              11's as its ranks report them, phase 12's as its node
              processes do) and, as ``launches_node``, ``launches_sharded``,
              ``launches_durable``, ``launches_multihost`` and
              ``launches_partitions``, those of phases 8 to 12 alone;
              its device time (torch.profiler kernel
              time), the plain version's time, and its bound; for the two
              serving kernels and the pairs kernel also
              ``serial_floor_ms``, their measured serial
              floor: ``hash_chain_kernel`` (one warp, the fastest node hash,
              dependent hashes in registers) at the serving path's one-block
              leaf and 20 node hashes and the chain's even levels, with the
              SM clock that nvidia-smi reads meanwhile (the ``[times]``
              lines; the ``[times] node_pairs sweep`` line gives the pairs
              kernel's device time, bound and share at P = 64, 512, 4096,
              4 x 32 x SMs, 65,536 and 5,242,880). A ``[path k]`` line
              gives, per phase, the batch sizes k of the path-rehash
              launches (largest, and launches by power of two). The diff
              kernel has two rows: ``diff``, its standalone grid, and
              ``diff_beside``, the co-resident grid the anti-entropy step
              runs beside the leaf hash, timed alone; both are checked
              bit for bit in phase 2 and count the one entry's launches.
              The ragged leaf hash (``leaf_ragged``: ``chain_kernel`` and
              ``bulk_kernel``, one entry) is checked in phase 2 against
              ``hashlib`` and its plain version on a few hundred leaves of
              0 to 260 KB, and here on a set of ``ETC_KEYS`` leaves at
              Facebook's ETC record sizes (``etc_ragged_set``) against its
              plain version, bit for bit, after phase 13 (a); its device
              time runs from the first kernel's start to the last one's
              end, and its bound counts a compression a block and 64 B a
              block, 8 B an offset and 32 B a digest. The SHA-256 rows
              (``leaf``, ``node_level``, ``node_pairs``, ``path_rehash``,
              ``promotion_chain``, ``leaf_ragged``) carry their kernels'
              SASS counts of SHF, LOP3, IADD3, IMAD and LDG, spills and
              registers (``sass``, ``tools/sha256_pipes.py``): which pipe
              their adds issue to.
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
              step); node B = A's keys with 0.25% diverged (cut from 1%,
              keeping 1M keys, for the script's time; half new values,
              half deleted, all older than A's writes), a bisect SYNC from
              A with B's replication off, repeated while a cycle past its
              120 s budget left a checkpoint to resume (at least 2 and at
              most 8 cycles, so a resumed cycle installs its pending repairs
              by last writer wins): the keys repaired over the cycles ==
              injected, the leaf kernel
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
9. sharded  — run right after phase 3, on its data: ``merklekv_tpu_torch/
              parallel/`` over D = 4 shards on ``[cuda:0] * 4`` (one card),
              or over the first 4 (or 2) distinct cards when there are two
              or more; prints which. First ``path_rehash`` and
              ``promotion_chain`` at the shards' shapes against their plain
              versions. (a) ``sharded_anti_entropy_step`` on the largest
              prefix of phase 3's keys that splits into D power-of-two
              shards (8,388,608 of 10M): root, masks and counts == the
              single-device step on the same prefix and == the per-device
              form (``multihost.lift_local_shards``: each shard already on
              its card, so the step copies no input), masks == injected;
              ``sharded_divergence_2d`` over a 2 x 2 mesh on all 10M keys
              == injected; median of 5 synchronised wall times of both forms
              beside the single-device step's. (b) ``ShardedDeviceMerkleState`` over
              1M keys: 50 value batches of 4096 (each exactly one
              ``path_rehash`` per shard that received keys plus the top
              reduce's ``node_level`` launches; a root read two
              ``promotion_chain``), every root == a single-device state fed
              the same batches; a structural batch of 4096 inserts and 4096
              deletes; then ``to_numpy_levels``, TREELEVEL slices (each
              level's last node) == the single-device state, root == the
              CPU golden tree; writes/s. (c) ``divergence_masks_engine`` at
              100,000 keys x 3 replicas through its sharded branch == the
              single-device masks. (d) the mirror with ``sharding="4"`` on
              the same devices: warms on rung D, 50 staged batches, then
              ``fail:shard{D}_scatter`` steps it down to rung D/2 on the card
              and ``heal()`` climbs back to D, roots golden throughout; the
              guard, pump, warm, re-warm, degrade and heal counters are
              exactly those of the one injected failure. Prints its seconds.
10. durable — the durable node at 1M keys (config 4), ``[storage]
              merkle_engine = "auto"``, so every snapshot root of 1M keys
              is hashed on the card. (a) as a user runs it:
              ``python -m merklekv_tpu_torch --durable --storage-path <tmp>
              --port 0``, 1M keys over TCP, SIGTERM (exit 0; the newest
              snapshot, the shutdown one, stamped with the golden root;
              a compaction may have written one more during the load),
              ``python -m
              merklekv_tpu_torch walcheck <dir> --json --engine tpu``
              (``replay_root`` == golden), restart on the same port
              (recovery verifies the snapshot root on the card; HASH ==
              golden), 4096 SETs, SIGKILL 0.3 s later, restart (WAL replay;
              HASH == the new golden root). (b) in this process through
              ``__main__.start`` with storage: the recovery check and a
              forced snapshot each launch ``leaf_kernel`` and
              ``node_level_kernel``; ``device.fallbacks`` stays 0. Prints
              ready, load, SIGTERM-to-exit, walcheck, restart and snapshot
              times (the root's share apart) and the snapshot's size.
11. multihost — run right after phase 9: the anti-entropy step across
              processes (``parallel/multihost.py``) on phase 9a's prefix:
              2 ranks sharing ``cuda:0`` over gloo on a one-card machine,
              else one NCCL rank per card (2 or 4); prints which. Each rank
              (this script with ``--rank-of``) packs only its contiguous
              rows of phase 3's keys, regenerates phase 3's replica stacks
              from the seed and keeps its rows, lifts them onto its card
              and runs the step: every rank's root and counts == phase 9a's,
              its mask rows == injected; median of 5 barrier-synchronised
              steps. Then, in the same ranks, the 2-D ``(replica, key)``
              diff at BASELINE config 5's 64 replicas over 2^24 keys
              (cuts: keys 100M -> 2^24, the v5e-8 pod -> one H100): each
              non-reference replica diverges on 1% of the keys, drawn
              Zipf-skewed over the key index from the seed (every 8th drawn
              key absent, the others with one digest word changed); each
              rank makes only its block on its card; meshes with the
              replica axis across the ranks (reference row broadcast) and
              with the key axis across them; every rank's counts and mask
              block == injected; prints each rank's block, make and diff
              times, the broadcast's bytes and time, and its peak memory.
              The ranks run under a timeout and are killed on any failure
              path.
12. partitions — partitioned cluster mode at config 4's keyspace (1M keys
              ``b"inc:%09d"`` / ``b"v%d"``): the port's broker, two
              partitions of two replicas and one reserve node, each a
              ``python -m merklekv_tpu_torch --durable`` process (run through
              runpy, with a SIGUSR1 handler that reports its kernel launch
              counts) with ``merkle_engine = "auto"`` and its mirror on the
              card, and ``python -m merklekv_tpu_torch router`` in front.
              (a) pipelined MSETs per partition by the smart client's map;
              every replica's HASH == the golden root (``merkle/cpu.py``) of
              its partition's items; 2000 seeded GETs through the router ==
              written. (b) ``REBALANCE SPLIT 0 <epoch> <reserve>`` under a
              steady ``PartitionedClient`` load of 4096-key MSET batches:
              zero client errors, the map at epoch E+1 with 3 partitions,
              every replica's root == the golden root under the new map,
              donor and joiner each launch ``leaf_kernel`` and
              ``node_level_kernel`` at least twice during the split (the
              moving range's root and the snapshot root or its
              verification); prints the split's seconds and the batch p99 in
              the split window against the steady p99 before it. (c), run
              right after (a), while its sibling holds no snapshot yet:
              SIGKILL a replica of partition 1, delete its data directory,
              restart it with ``[bootstrap] enabled``: it serves its
              partition's keys after verifying its sibling's snapshot on
              the card (leaf and level launches before any HASH), then
              HASH == sibling == golden; prints the times to its readiness
              line and to serving. During the split, ``python -m
              merklekv_tpu_torch top --nodes <the five> --once --events``
              exits 0: every node UP, the four serving replicas on BKND 1
              with their partition in PART, no device event in the pane.
              (d) ``device.fallbacks`` 0 on every node; after SIGTERM to
              every node, ``blackbox --json`` over the five flight
              directories exits 0 with no device anomaly. Every process is
              killed at the end, whatever happened.

13. surface — the rest of the port's public surface on the card at 1M
              keys (config 4), in two parts. (b), run right after phase 6:
              ``merklekv_tpu_torch.device.ladder.build_state_with_ladder``
              with ``top_shards`` 4 over phase 9's devices, once clean
              (rung 4, no step) and once with ``fail:shard4_*`` installed
              (``on_step`` sees rung 4, the state lands on rung 2, on the
              card): roots == golden after the build, a value batch and an
              insert/delete batch, TREELEVEL slices == golden. (a), run
              last, after the kernels line's profiler sessions (a session
              before them left one of them with no kernel record):
              ``merklekv_tpu_torch.utils.device_profile`` (a
              ``torch.profiler`` trace in TensorBoard format) around a
              ``DeviceMerkleState`` build and one value batch of 4096 with
              a root read: the root == golden, and the trace, parsed, names
              at least one launch each of ``leaf_kernel``,
              ``node_level_kernel``, ``path_rehash_kernel`` and
              ``promotion_chain_kernel`` (the counts are printed). Phase
              5's line prints its ``tree_staleness`` flight events (count
              and ``lag_ms``) beside its largest ``pump_lag_ms``; not
              asserted.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout of the repository, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
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
# Phase 8b's bisect SYNC diverges 0.25% of its 1M keys. Cut from 1%, keeping
# 1M keys: at 1% the SYNC took 228-305 s (the donor's page cost, ROADMAP
# Queue C), which with the 2-D step, top and blackbox took the script past
# 900 s of its 1200 s.
NODE_SYNC_DIVERGED = 0.0025
NODE_MSET = 500
NODE_PIPELINE = 64
NODE_SYNC_CYCLES = 8
MULTI_KEYS = 100_000
SHARDS = 4
SHARDED_BATCHES = 50
# The sharded drill's heal probe waits this long after the step-down, so it
# never runs while the fault is still installed.
SHARDED_HEAL_S = 15.0
DURABLE_KEYS = NODE_KEYS
# The WAL append runs behind the acknowledgement (about 5 ms of drain): the
# durable phase waits this long after its last SET before the SIGKILL.
DURABLE_WAL_DRAIN_S = 0.3
MULTIHOST_TIMEOUT_S = 600.0
# Phase 11's 2-D step: BASELINE config 5 ("64-replica all-pairs diff, 100M
# keys, Zipf-skewed divergence, v5e-8 pod") at its published replica count.
# Cuts: keys 100M -> 2^24 (64 x 2^24 digests are 34.4 GB, 35.5 GB with
# presence, and two ranks' temporaries sit beside them on one 80 GB card);
# the v5e-8 pod -> one H100.
DIFF2D_REPLICAS = 64
DIFF2D_KEYS = 1 << 24
DIFF2D_DIVERGED = 0.01
DIFF2D_ZIPF_S = 1.0
DIFF2D_CUTS = ("keys 100M -> 2^24 (64 x 2^24 digests 34.4 GB, 35.5 GB with presence, beside "
               "two ranks' temporaries on one 80 GB card); the v5e-8 pod -> one H100")
PART_KEYS = TREE_KEYS
PART_STEADY_S = 5.0
PART_SAMPLE = 2000
PART_BUSY_RETRIES = 240
PART_PAUSE_S = 0.05

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
# The serial floor of the two serving kernels is measured, not modelled:
# hash_chain_kernel (csrc/merkle_paths.cu) times one warp hashing a chain of
# dependent node hashes in registers (phase_kernel_times), while
# nvidia-smi samples the SM clock.
CHAIN_RUNS = 200
# The pairs kernel's sizes in the [times] sweep; None is 4 x 32 x SMs.
PAIRS_SWEEP = (64, 512, 4096, None, 65536, 5 * (1 << 20))
# Kernels the main path (phases 3 to 6 and 8 to 12) must launch; node_pairs
# is held against its plain version in phase 2 but no longer runs on the main
# path. The node's leaf maps and snapshot roots hash ragged (leaf_ragged); the
# serving tree and the ladder's builds (phase 13 b) pack padded.
MAIN_PATH_KERNELS = ("leaf", "node_level", "path_rehash", "promotion_chain", "leaf_ragged")
LADDER_KERNELS = ("leaf", "node_level", "path_rehash", "promotion_chain")
# The kernels line's ragged set: config 3's key count at the record sizes of
# Facebook's memcached ETC pool (Atikoglu et al., SIGMETRICS 2012): keys a
# generalized extreme value fit (mu, sigma, k), at least 10 bytes; values a
# generalized Pareto fit (theta, sigma, k), at most 1 MiB.
ETC_KEYS = REBUILD_KEYS
ETC_KEY_GEV = (30.7984, 8.20449, 0.078688)
ETC_VALUE_GPD = (0.0, 214.476, 0.348238)
# A kernels-line row whose launches are counted under another entry's key
# (ops/cuda_lib.py's LAUNCHES counts an entry's launches in any grid).
LAUNCH_KEY = {"diff_beside": "diff"}


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


class ClockSampler:
    """Samples ``nvidia-smi --query-gpu=clocks.sm`` (MHz) on a thread while
    the ``with`` block runs."""

    def __init__(self) -> None:
        self.samples: list[int] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        while not self._stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True)
            if out.returncode == 0 and out.stdout.strip():
                self.samples.append(int(out.stdout.split()[0]))
            self._stop.wait(0.05)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(10)


def serial_floor(dev, rng: np.random.Generator, d: int, nblk: int = 0) -> dict:
    """The measured least time of a leaf of nblk blocks and d node hashes
    that each wait on the one before, with the fastest node hash:
    ``hash_chain_kernel`` over CHAIN_RUNS launches (its own SM clock and
    global-timer readings, median), checked against its plain version,
    with the SM clock nvidia-smi reads meanwhile. ``*_per_hash`` divide the
    whole chain by d."""
    import torch

    from merklekv_tpu_torch.ops import merkle_paths as mp

    inp = rand_words(rng, (32, 16), dev)
    got, _, _ = mp.hash_chain_cuda(inp, d, nblk)
    if not torch.equal(got, mp.hash_chain(inp, d, nblk)):
        raise AssertionError(f"hash_chain_kernel differs from its plain version at d={d}, "
                             f"nblk={nblk}")
    cycles, ns = [], []
    with ClockSampler() as clk:
        for _ in range(CHAIN_RUNS):
            _, c, t = mp.hash_chain_cuda(inp, d, nblk)
            cycles.append(c)
            ns.append(t)
    cyc, t = float(np.median(cycles)), float(np.median(ns))
    return {"d": d, "nblk": nblk, "ms": t / 1e6, "cycles": cyc, "ns_per_hash": t / d,
            "cycles_per_hash": cyc / d, "ghz": cyc / t, "clocks_sm_mhz": sorted(set(clk.samples))}


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
    mean is over those it kept; it must keep one at least."""
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


def profiled_again(fn, kernel: str, reps: int) -> tuple[float, int]:
    """``profiled_kernel_ms``, measured once more when the profiler kept no
    record of the kernel (torch 2.11 on the card: about one session in 200
    of many short ones in a process); a second empty session raises."""
    try:
        return profiled_kernel_ms(fn, kernel, reps)
    except AssertionError as exc:
        log(f"[times] {exc}; measured again")
        return profiled_kernel_ms(fn, kernel, reps)


def profiled_launch_ms(fn, kernels: tuple, reps: int, warmup: int = 2) -> tuple[float, int]:
    """Mean device time per call of ``fn`` from its first kernel's start to
    its last one's end (torch.profiler), for a launch of the kernels named
    in ``kernels`` that overlap on the card, as the ragged leaf hash's two
    halves do; and the number of calls timed. A call's kernels run from one
    named ``kernels[0]`` to the next; a call the profiler kept fewer
    records of is left out, and one call at least must be whole."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pats = [re.compile(rf"(^|[^\w]){k}\b") for k in kernels]
    for _ in range(warmup):
        fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    events = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA and any(p.search(ev.name) for p in pats))
    calls: list = []
    for start, end, name in events:
        if pats[0].search(name) or not calls:
            calls.append([])
        calls[-1].append((start, end))
    spans = [max(e for _, e in c) - min(b for b, _ in c) for c in calls if len(c) == len(kernels)]
    if not 0 < len(spans) <= reps:
        raise AssertionError(f"profiler kept {len(spans)} whole calls of {kernels}, expected {reps}")
    return sum(spans) / len(spans) / 1e3, len(spans)


def etc_ragged_set(dev, rng: np.random.Generator, n: int = ETC_KEYS):
    """A ragged leaf set (``merkle.ragged.RaggedLeaves``) of ``n`` leaves at
    ETC record sizes: each key's and value's size the fit's quantile at
    (i + 0.5) / n, floored and clipped, in an order drawn from ``rng``; each
    leaf's blocks the padded message of that size would take. The words are
    random (the kernel hashes the blocks it is given; its plain version is
    held to ``hashlib`` in phase 2 and the tests)."""
    import torch

    from merklekv_tpu_torch.merkle.ragged import RaggedLeaves

    p = (np.arange(n, dtype=np.float64) + 0.5) / n
    mu, sigma, k = ETC_KEY_GEV
    keys = np.maximum(np.floor(mu + sigma / k * ((-np.log(p)) ** -k - 1)), 10)
    theta, sigma, k = ETC_VALUE_GPD
    values = np.clip(np.floor(theta + sigma / k * ((1 - p) ** -k - 1)), 0, 1 << 20)
    counts = (8 + rng.permutation(keys).astype(np.int64)
              + rng.permutation(values).astype(np.int64) + 9 + 63) // 64
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))
    blocks = torch.randint(-(2**31), 2**31 - 1, (int(offsets[-1]), 16), dtype=torch.int32,
                           device=dev, generator=gen)
    return RaggedLeaves(blocks, torch.from_numpy(offsets).to(dev))


def path_kernel_ms(levels, scratch, blocks, nblocks, pos, reps: int) -> float:
    """Device ms per launch of the path-rehash kernel alone: CUDA events
    around ``reps`` back-to-back launches through the library's entry point
    (without the wrapper's checks and its copy of the positions)."""
    import torch

    from merklekv_tpu_torch.ops import cuda_lib
    from merklekv_tpu_torch.ops import merkle_paths as mp

    dev = levels[0].device
    c = int(levels[0].shape[0])
    st = mp._levels_struct(levels, dev)
    pos_t = torch.from_numpy(np.asarray(pos, np.int32)).to(dev)

    def launch() -> None:
        cuda_lib.launch("mkv_path_rehash", dev, st, blocks.data_ptr(), nblocks.data_ptr(),
                        pos_t.data_ptr(), len(pos), blocks.shape[1], mp.PATH_WIDTH,
                        mp._path_top(c), scratch.data_ptr())

    return event_ms(launch, reps)


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
    from merklekv_tpu_torch.ops.cuda_lib import build_kernels

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
        leaf_ragged_cuda,
        node_level_cuda,
        node_pairs_cuda,
    )

    errs = {"leaf": 0, "leaf_ragged": 0, "node_level": 0, "node_pairs": 0, "diff": 0,
            "diff_beside": 0}
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
    # The pairs kernel's launch (csrc/node_pairs.cuh) at P on each side of
    # one warp, of one 4-warp block, of the serving batch and of one 4-warp
    # block per SM; three rows of each against hashlib.
    full = 4 * 32 * torch.cuda.get_device_properties(dev).multi_processor_count
    for p in sorted({1, 3, 16, 31, 32, 33, 127, 128, 129, 4095, 4096, 4097, full - 1, full,
                     full + 1, 65536, 65537, 1 << 20}):
        left, right = rand_words(rng, (p, 8), dev), rand_words(rng, (p, 8), dev)
        got = node_pairs_cuda(left, right)
        hold("node_pairs", got, plain.sha256_node_pairs(left, right), f"P={p}")
        rows = sorted({0, p // 2, p - 1})
        msgs = torch.cat([left[rows], right[rows]], 1).cpu().numpy().view(np.uint32)
        if plain.digests_to_bytes(got[rows].cpu().numpy().view(np.uint32)) != [
                hashlib.sha256(m.astype(">u4").tobytes()).digest() for m in msgs]:
            raise AssertionError(f"node_pairs kernel differs from hashlib at P={p}")
    # The diff kernel, in its standalone grid and in the co-resident one the
    # anti-entropy step launches beside the leaf hash: masks and counts as
    # one int32 row each, on whole stacks and on a key slice (replica
    # stride other than N).
    from merklekv_tpu_torch.ops.diff_cuda import divergence_cuda, divergence_plain

    def as_row(mc):
        return torch.cat([mc[0].to(torch.int32).flatten(), mc[1]])

    for r, n, lo in ((1, 1, 0), (3, 4097, 0), (8, 1 << 20, 0), (8, (1 << 20) - 3, 3),
                     (64, 70001, 0)):
        digests, present, _ = replica_stacks(dev, int(rng.integers(1 << 30)), lo + n, r)
        digests, present = digests[:, lo:], present[:, lo:]
        want = as_row(divergence_plain(digests, present))
        hold("diff", as_row(divergence_cuda(digests, present)), want, f"R={r} N={n} from {lo}")
        hold("diff_beside", as_row(divergence_beside(digests, present)), want,
             f"R={r} N={n} from {lo}")
        del digests, present, want

    # hashlib: random-byte leaves of 0..200 bytes (1-4 blocks), and nodes.
    keys = [rng.bytes(int(rng.integers(0, 40))) for _ in range(300)]
    vals = [rng.bytes(int(rng.integers(0, 200))) for _ in range(300)]
    packed = pack_leaves(keys, vals)
    got = leaf_digests_cuda(torch.from_numpy(packed.blocks.view(np.int32)).to(dev),
                            torch.from_numpy(packed.nblocks).to(dev))
    want = [leaf_hash(k, v) for k, v in zip(keys, vals)]
    if plain.digests_to_bytes(got.cpu().numpy().view(np.uint32)) != want:
        raise AssertionError("leaf kernel differs from hashlib")
    # The ragged leaf hash: leaves of 0..2000 bytes and a few of 50 to 260
    # KB, so that the longest run in chain_kernel beside the bulk.
    from merklekv_tpu_torch.merkle.ragged import RaggedLeaves

    sizes_v = [int(x) for x in rng.integers(0, 2000, 400)] + [50_000, 120_000, 260_000]
    keys_r = [rng.bytes(int(rng.integers(0, 60))) for _ in sizes_v]
    vals_r = [rng.bytes(m) for m in sizes_v]
    rs = RaggedLeaves.pack(keys_r, vals_r, dev)
    if rs.chained < 1:
        raise AssertionError(f"the ragged check set runs no chain: {rs.longest} blocks longest")
    got_r = leaf_ragged_cuda(rs.blocks, rs.offsets, rs.order, rs.chained)
    hold("leaf_ragged", got_r, plain.sha256_ragged(rs.blocks, rs.offsets),
         f"{rs.n} leaves, {rs.total_blocks} blocks, {rs.chained} chained")
    if plain.digests_to_bytes(got_r.cpu().numpy().view(np.uint32)) != [
            leaf_hash(k, v) for k, v in zip(keys_r, vals_r)]:
        raise AssertionError("ragged leaf hash differs from hashlib")
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
        f"300 leaves + {len(sizes_v)} ragged leaves ({rs.chained} chained) + 278 nodes and 3 "
        f"pairs of each pairs size exact vs hashlib (tolerance: exact equality)")
    return {"max_abs_err": errs}


def path_sets(rng: np.random.Generator, c: int) -> dict:
    """The position sets the path-rehash kernel is held to (sorted, unique)."""
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
        # Dense at the left end, sparse to the right (Zipf over the index).
        "Zipf-skewed": np.unique(np.minimum(rng.zipf(1.1, size=20_000), c) - 1),
        # No two in one 2^8-leaf subtree: no meeting below level 9.
        "one per 2^8-leaf subtree": np.arange(c >> 8) * 256 + rng.integers(0, 256, size=c >> 8),
    }


def phase_paths(dev, rng: np.random.Generator, depth: int = 20) -> dict:
    """The path-rehash and promotion-chain kernels against their plain
    versions on the card, bit for bit, on cloned 2^depth-leaf levels; the
    path-rehash kernel's device time on each position set."""
    import torch

    from merklekv_tpu_torch.ops import merkle_paths as mp
    from merklekv_tpu_torch.ops.dispatch import build_levels

    c = 1 << depth
    base = build_levels(rand_words(rng, (c, 8), dev))
    errs = {"path_rehash": 0, "promotion_chain": 0}
    # (what, sorted positions, blocks per leaf, least valid block count)
    cases = [(what, pos, 2, 0) for what, pos in path_sets(rng, c).items()]
    cases.append((f"the serving shape [{BATCH}, 1, 16] at {BATCH} random positions",
                  np.sort(rng.choice(c, size=BATCH, replace=False)), 1, 1))
    times = []
    for what, pos, nblk, nb_lo in cases:
        k = len(pos)
        blocks = rand_words(rng, (k, nblk, 16), dev)
        nblocks = torch.from_numpy(
            rng.integers(nb_lo, nblk + 1, size=k, dtype=np.int32)).to(dev)
        scratch = mp.path_scratch(c, dev)
        got = [lv.clone() for lv in base]
        want = [lv.clone() for lv in base]
        mp.path_rehash_cuda(got, scratch, blocks, nblocks, pos)
        mp.path_rehash(want, blocks, nblocks, pos)
        err = max(u32_max_abs_err(g, w) for g, w in zip(got, want))
        errs["path_rehash"] = max(errs["path_rehash"], err)
        if err:
            raise AssertionError(f"path_rehash differs from its plain version on {what}: {err}")
        if scratch.any():
            raise AssertionError(f"path_rehash left its scratch set on {what}")
        ms = path_kernel_ms(got, scratch, blocks, nblocks, pos, 20 if k > BATCH else 100)
        if scratch.any():
            raise AssertionError(f"path_rehash left its scratch set on {what} (timed)")
        times.append(f"{what} (k={k}) {ms:.4f}")
        del got, want
    for n in (1, 2, 3, c // 2 + 1, min(1_000_000, c - 1), c):
        err = u32_max_abs_err(mp.promotion_chain_cuda(base, n), mp.promotion_chain(base, n))
        errs["promotion_chain"] = max(errs["promotion_chain"], err)
        if err:
            raise AssertionError(f"promotion_chain differs from its plain version at n={n}: {err}")
    sync()
    log(f"[kernels] path_rehash bit-exact vs plain on cloned 2^{depth}-leaf levels for "
        f"{'; '.join(case[0] for case in cases)}; every level compared whole, padding "
        f"included; scratch zero after each; promotion_chain "
        f"bit-exact for n = 1, 2, 3, 2^{depth - 1}+1, {min(1_000_000, c - 1)}, 2^{depth} "
        f"(tolerance: exact equality)")
    log(f"[kernels] path_rehash device ms per launch (CUDA events over back-to-back launches "
        f"of the kernel alone) by set: {'; '.join(times)}")
    return {"max_abs_err": errs}


def make_kv(n: int, lo: int = 0):
    """Rows ``lo`` .. ``n - 1`` of the rebuild keyspace."""
    keys = [b"user:%012d" % i for i in range(lo, n)]
    values = [b"value-%d-payload" % (i % 9973) for i in range(lo, n)]
    return keys, values


def divergence_beside(digests, present):
    """The diff kernel in the co-resident grid the anti-entropy step runs
    beside the leaf hash (``ops.diff_cuda.divergence_beside_cuda``), here on
    the current stream into new outputs: (masks, counts)."""
    import torch

    from merklekv_tpu_torch.ops.diff_cuda import divergence_beside_cuda

    masks = torch.empty(tuple(present.shape), dtype=torch.bool, device=present.device)
    counts = torch.zeros(present.shape[0], dtype=torch.int32, device=present.device)
    divergence_beside_cuda(digests, present, masks, counts)
    return masks, counts


def replica_stacks(dev, seed: int, n_keys: int, n_rep: int):
    """Replica digests on the device from the seed: replica 0 is the
    reference; each other replica diverges at 1% of keys, chosen at random
    without repeats — half with one flipped digest bit, half absent.
    Returns (digests [R, N, 8], present [R, N], expected masks [R, N]); the
    same seed gives the same stacks in any process on the same card type."""
    import torch

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
    return digests, present, expected


def phase_rebuild(dev, seed: int, n_keys: int = REBUILD_KEYS, n_rep: int = REPLICAS,
                  prefix: int = PREFIX_KEYS, reps: int = 5) -> dict:
    import torch

    from merklekv_tpu_torch.merkle.cpu import build_levels as golden_levels
    from merklekv_tpu_torch.merkle.encoding import leaf_hash
    from merklekv_tpu_torch.merkle.packing import pack_leaves
    from merklekv_tpu_torch.merkle.torch_engine import anti_entropy_forward, tree_root
    from merklekv_tpu_torch.ops import sha256 as plain
    from merklekv_tpu_torch.ops.dispatch import hash_blocks
    from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES, reset_launch_counts

    t0 = time.perf_counter()
    keys, values = make_kv(n_keys)
    t1 = time.perf_counter()
    packed = pack_leaves(keys, values)
    t2 = time.perf_counter()
    blocks = torch.from_numpy(packed.blocks.view(np.int32)).to(dev)
    nblocks = torch.from_numpy(packed.nblocks).to(dev)
    digests, present, expected = replica_stacks(dev, seed, n_keys, n_rep)
    sync()
    t3 = time.perf_counter()
    log(f"[rebuild] host set-up: keys {t1 - t0:.2f} s, pack_leaves {t2 - t1:.2f} s, "
        f"to device + replicas {t3 - t2:.2f} s ({n_keys} keys, B={packed.max_blocks})")

    reset_launch_counts()
    root, masks, counts = anti_entropy_forward(blocks, nblocks, digests, present, device=dev)
    sync()
    launches = dict(LAUNCHES)
    if launches["leaf"] < 1 or launches["node_level"] < 1 or launches["diff"] != 1:
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
            "blocks": blocks, "nblocks": nblocks, "digests": digests, "present": present,
            "expected": expected,
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
    from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES, reset_launch_counts

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
    from merklekv_tpu_torch.obs.flightrec import get_recorder
    from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES, reset_launch_counts

    rng = np.random.default_rng(seed + 2)
    items = [(b"inc:%09d" % i, b"v%d" % i) for i in range(n_tree)]
    eng = DictEngine(items)
    golden = CpuMerkleState.from_items(items)
    base = _counters()
    seq0 = max((ev.seq for ev in get_recorder().last(1)), default=-1)

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
    # The mirror flags a stale published tree at most once per flag window.
    stale = [ev.fields.get("lag_ms") for ev in get_recorder().last()
             if ev.seq > seq0 and ev.kind == "tree_staleness"]
    log(f"[mirror] {n_tree} keys on rung 1: warm {warm_s:.3f} s; {batches} batches of {batch} "
        f"value updates staged with on_events: {rate:.0f} writes/s (first staging to the "
        f"published root covering the last batch, {fed_s:.3f} s over "
        f"{batches // MIRROR_CHECK_EVERY} segments); pump batches "
        f"{delta.get('device.pump_batches', 0)}; largest pump_lag_ms {max_lag:.3f}, "
        f"{len(stale)} tree_staleness flight events (lag_ms {stale}); "
        f"{checks} checks (stamped root, TREELEVEL leaf/mid/edge slices, staleness 0) == "
        f"CpuMerkleState incl. a structural batch, TRUNCATE and refill; fault counters "
        f"{bad}; scatter keys {delta.get('device.scatter_keys', 0)}, "
        f"restructure keys {delta.get('device.restructure_keys', 0)}; launches {launches}")
    return {"launches": launches, "writes_per_s": rate, "warm_s": warm_s,
            "pump_batches": delta.get("device.pump_batches", 0), "max_lag_ms": max_lag,
            "staleness_lag_ms": stale}


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


def run_tool(args: list, timeout: float = 120.0) -> tuple[int, str, float]:
    """``python -m merklekv_tpu_torch <args>`` from the checkout, as a user
    runs it: (rc, stdout, seconds)."""
    import os
    from pathlib import Path

    root_dir = Path(__file__).resolve().parent
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "merklekv_tpu_torch", *args], cwd=str(root_dir),
                          env=dict(os.environ, PYTHONPATH=str(root_dir)), capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode not in (0, 1):
        raise AssertionError(f"{args[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.returncode, proc.stdout, time.perf_counter() - t


DEVICE_ANOMALIES = ("device_degraded", "device_fallback", "device_corruption")


def drill_blackbox(n_rewarms: int) -> dict:
    """Spill this process's flight ring (the drill's events, and the
    sharded mirror's step-down and climb of phase 9d before them: a mirror
    on the card ends at rung 1, so the drill's own failures re-warm it
    without stepping down) to a temporary file and read it with
    ``blackbox --json``: it must parse (rc 0), hold the drill's failed
    drains as ``device_rewarm`` events, each with its classified kind, and
    show the step-downs (``device_degraded``), each classified with its
    ``environment|code`` kind."""
    import os
    import tempfile

    from merklekv_tpu_torch.obs.flightrec import get_recorder

    with tempfile.TemporaryDirectory(prefix="mkv-drill-") as tmp:
        path = os.path.join(tmp, "flight.bin")
        if not get_recorder().dump(path, node="chip_smoke"):
            raise AssertionError("the flight ring did not spill")
        rc, out, secs = run_tool(["blackbox", "--json", path])
    if rc != 0:
        raise AssertionError(f"blackbox rejected the drill's spill: {out[-2000:]}")
    report = json.loads(out)
    rewarms = [e["fields"] for e in report["timeline"] if e["kind"] == "device_rewarm"]
    kinds = sorted({f.get("kind") for f in rewarms})
    if len(rewarms) < n_rewarms or not set(kinds) <= {"environment", "code"}:
        raise AssertionError(f"the spill holds {len(rewarms)} re-warms of kinds {kinds}")
    steps = [a for a in report["anomalies"] if a["kind"] == "device_degraded"]
    if not steps or any(not ("(environment @" in a["detail"] or "(code @" in a["detail"])
                        for a in steps):
        raise AssertionError(f"no step-down, or one unclassified, in the spill: {steps}")
    by_kind: dict = {}
    for a in report["anomalies"]:
        by_kind[a["kind"]] = by_kind.get(a["kind"], 0) + 1
    return {"seconds": secs, "events": len(report["timeline"]), "rewarms": len(rewarms),
            "rewarm_kinds": kinds, "step_downs": [a["detail"] for a in steps],
            "anomalies": by_kind}


def phase_fault_drill(dev, seed: int, n_keys: int = DRILL_KEYS) -> dict:
    """Injected faults at the guard seam on the card: a persistent scatter
    failure invalidates the mirror and re-warms it on the card (its ladder
    ends at rung 1), the re-warmed tree serves golden roots while the fault
    persists, and a hang past the deadline never blocks the pump or a
    query."""
    from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror
    from merklekv_tpu_torch.device.guard import configure
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES, reset_launch_counts
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
    box = drill_blackbox(DRILL_REWARMS)
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
        f"launches {launches}. blackbox --json over the process's spilled flight ring "
        f"({box['events']} events, {box['seconds']:.3f} s): rc 0, {box['rewarms']} "
        f"device_rewarm events of kinds {box['rewarm_kinds']}, step-downs {box['step_downs']} "
        f"(a mirror on the card ends at rung 1: these are phase 9d's), anomalies "
        f"{box['anomalies']}")
    return {"launches": launches, "rewarm_ms": rewarm_ms, "max_gap_ms": fail_gap * 1e3,
            "hang_call_ms": hang_call * 1e3}


# ------------------------------------------------------- phase 13: surface

TRACED_KERNELS = ("leaf_kernel", "node_level_kernel", "path_rehash_kernel",
                  "promotion_chain_kernel")


def surface_data(seed: int, n_tree: int, batch: int) -> tuple[list, list, list]:
    """Phase 13's keys (config 4's), a value batch, and an insert/delete
    batch, from the seed."""
    rng = np.random.default_rng(seed + 13)
    items = [(b"inc:%09d" % i, b"v%d" % i) for i in range(n_tree)]
    update = [(b"inc:%09d" % i, b"s%d" % i) for i in rng.integers(0, n_tree, size=batch)]
    structural = [(b"inc:%09d-x" % i, b"n%d" % i) for i in rng.integers(0, n_tree, size=batch // 2)]
    structural += [(b"inc:%09d" % i, None) for i in rng.integers(0, n_tree, size=batch // 2)]
    return items, update, structural


def phase_surface(dev, seed: int, n_tree: int = TREE_KEYS, batch: int = BATCH) -> dict:
    """13 (b): ``device.ladder.build_state_with_ladder`` over config 4's
    keys on the card, clean and with a fault at its top rung: the rung, the
    rungs ``on_step`` saw, and roots and slices against the golden tree."""
    from merklekv_tpu_torch.device.ladder import build_state_with_ladder
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES, reset_launch_counts
    from merklekv_tpu_torch.testing.device_faults import DeviceFaultInjector

    t_phase = time.perf_counter()
    items, update, structural = surface_data(seed, n_tree, batch)
    golden = CpuMerkleState.from_items(items)
    roots = [golden.root_hex()]
    golden.apply(update)
    roots.append(golden.root_hex())
    golden.apply(structural)
    roots.append(golden.root_hex())
    rng = np.random.default_rng(seed + 14)
    devs, distinct = shard_devices(dev)
    top = len(devs)
    ladder = []
    reset_launch_counts()
    for fault in (None, f"shard{top}_*"):
        steps: list = []
        inj = DeviceFaultInjector(match=fault, mode="fail").install() if fault else None
        t = time.perf_counter()
        try:
            state, rung = build_state_with_ladder(
                items, top, devices=devs, on_step=lambda r, e: steps.append(r))
            sync_all(devs)
        finally:
            if inj is not None:
                inj.uninstall()
        build_s = time.perf_counter() - t
        want = (top, []) if fault is None else (top // 2, [top])
        if (rung, steps) != want:
            raise AssertionError(f"ladder with fault {fault}: rung {rung}, steps {steps}, "
                                 f"expected {want}")
        got = [state.root_hex()]
        state.apply(update)
        got.append(state.root_hex())
        state.apply(structural)
        got.append(state.root_hex())
        if got != roots:
            raise AssertionError(f"ladder state on rung {rung} (fault {fault}) left the golden "
                                 f"tree: {[g == r for g, r in zip(got, roots)]}")
        _check_serving(state, golden, rng, f"the ladder build on rung {rung}")
        ladder.append({"fault": fault, "rung": rung, "steps": steps, "build_s": build_s})
        del state
    launches = dict(LAUNCHES)
    if min(launches[k] for k in LADDER_KERNELS) < 1:
        raise AssertionError(f"the ladder builds missed a main-path kernel: {launches}")
    wall_s = time.perf_counter() - t_phase
    log(f"[surface] (b) build_state_with_ladder, top_shards {top} over "
        f"{'distinct cards' if distinct else f'{top} x {dev}'}: "
        + "; ".join(f"fault {d['fault']}: rung {d['rung']}, on_step rungs {d['steps']}, "
                    f"{d['build_s']:.3f} s" for d in ladder)
        + f"; roots == golden after the build, a value batch and an insert/delete batch, "
          f"TREELEVEL slices == golden; launches {launches}; phase {wall_s:.1f} s")
    return {"launches": launches, "ladder": ladder, "root": roots[1], "seconds": wall_s}


def phase_profile(dev, seed: int, want_root: str, n_tree: int = TREE_KEYS,
                  batch: int = BATCH) -> dict:
    """13 (a), after the script's other profiler sessions:
    ``utils.device_profile`` around a 1M-key build and one value batch with
    a root read; the kernels its trace names. Run before the kernels line's
    sessions, it left one of them with no kernel record (torch 2.11)."""
    import glob
    import os
    import tempfile

    from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState
    from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES, reset_launch_counts
    from merklekv_tpu_torch.utils import device_profile as profile_trace

    items, update, _ = surface_data(seed, n_tree, batch)
    sync()
    reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="mkv-profile-") as logdir:
        t = time.perf_counter()
        with profile_trace(logdir):
            st = DeviceMerkleState.from_items(items, device=dev)
            st.apply(update)
            root = st.root_hex()
            sync()
        prof_s = time.perf_counter() - t
        traces = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"device_profile wrote {os.listdir(logdir)}, not one trace")
        trace_kb = os.path.getsize(traces[0]) / 1e3
        with open(traces[0]) as f:
            names = [ev.get("name", "") for ev in json.load(f)["traceEvents"]
                     if ev.get("cat") == "kernel"]
    traced = {k: sum(k in name for name in names) for k in TRACED_KERNELS}
    launches = dict(LAUNCHES)
    if root != want_root:
        raise AssertionError("the profiled build and batch root differs from the golden tree")
    if min(traced.values()) < 1:
        raise AssertionError(f"the device_profile trace lacks a main-path kernel: {traced}")
    log(f"[surface] (a) device_profile around a {n_tree}-key build and a batch of {batch}: "
        f"{prof_s:.3f} s, trace {trace_kb:.1f} kB; kernel launches in the trace {traced} "
        f"(counted {launches}); root == golden")
    return {"traced": traced, "seconds": prof_s}


# ------------------------------------------------------- phase 9: sharded

def shard_devices(dev) -> tuple[list, bool]:
    """The sharded phase's devices: the first 4 (or 2) distinct cards when
    the machine has two or more, else ``[dev] * 4`` — every shard runs for
    real, only the copies between distinct cards are missing."""
    import torch

    count = torch.cuda.device_count()
    if count >= 2:
        d = 4 if count >= 4 else 2
        return [torch.device("cuda", i) for i in range(d)], True
    return [dev] * SHARDS, False


def sync_all(devs) -> None:
    import torch

    for d in set(devs):
        torch.cuda.synchronize(d)


class Launches:
    """Launch counts of the sharded path only: ``with acc:`` zeroes the
    counters before its block and adds what the block launched; the
    single-device references in between are left out."""

    def __init__(self) -> None:
        from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES

        self.total = dict.fromkeys(LAUNCHES, 0)
        self.last: dict = {}

    def __enter__(self):
        from merklekv_tpu_torch.ops.cuda_lib import reset_launch_counts

        reset_launch_counts()
        return self

    def __exit__(self, *exc) -> None:
        from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES

        self.last = dict(LAUNCHES)
        for k, v in self.last.items():
            self.total[k] += v


def phase_sharded(dev, seed: int, reb: dict, errs: dict, n_tree: int = TREE_KEYS,
                  batch: int = BATCH, batches: int = SHARDED_BATCHES,
                  multi_keys: int = MULTI_KEYS) -> dict:
    """The sharded tree and diff (``merklekv_tpu_torch/parallel/``) over
    ``shard_devices``: (a) rebuild + diff on phase 3's data, (b) the sharded
    serving tree at 1M keys against the single-device state, (c) the diff
    engine's sharded branch at the sync_multi shape, (d) the mirror on the
    sharded rung, stepped down by a ``shard{D}_scatter`` fault and healed."""
    import torch

    from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror
    from merklekv_tpu_torch.cluster.retry import RetryPolicy
    from merklekv_tpu_torch.device.ladder import DeviceBackendLadder
    from merklekv_tpu_torch.merkle import diff as tdiff
    from merklekv_tpu_torch.merkle.cpu import ref_level_sizes
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState
    from merklekv_tpu_torch.merkle.torch_engine import anti_entropy_forward
    from merklekv_tpu_torch.ops import merkle_paths as mp
    from merklekv_tpu_torch.ops.dispatch import build_levels
    from merklekv_tpu_torch.parallel import (
        ShardedDeviceMerkleState,
        make_mesh,
        sharded_anti_entropy_step,
        sharded_divergence_2d,
    )
    from merklekv_tpu_torch.parallel import multihost, sharded_merkle
    from merklekv_tpu_torch.testing.device_faults import DeviceFaultInjector

    t_phase = time.perf_counter()
    devs, distinct = shard_devices(dev)
    d = len(devs)
    where = (f"{d} shards on {d} distinct cards" if distinct
             else f"{d} shards on one card")
    log(f"[sharded] {where}: {[str(x) for x in devs]}")
    rng = np.random.default_rng(seed + 9)
    acc = Launches()

    # Kernels at the sharded path's own shapes: one shard's subtree of a
    # 1M-key tree (2^20 / D leaves, a batch's share of positions) and the
    # top tree's chain over D shard roots.
    lsh = (1 << (n_tree - 1).bit_length()) // d
    base = build_levels(rand_words(rng, (lsh, 8), dev))
    pos = np.sort(rng.choice(lsh, size=batch // d, replace=False))
    blocks = rand_words(rng, (len(pos), 1, 16), dev)
    nblocks = torch.ones(len(pos), dtype=torch.int32, device=dev)
    got, want = [lv.clone() for lv in base], [lv.clone() for lv in base]
    mp.path_rehash_cuda(got, mp.path_scratch(lsh, dev), blocks, nblocks, pos)
    mp.path_rehash(want, blocks, nblocks, pos)
    err = max(u32_max_abs_err(g, w) for g, w in zip(got, want))
    top = build_levels(rand_words(rng, (d, 8), dev))
    for n in range(1, d + 1):
        err_c = u32_max_abs_err(mp.promotion_chain_cuda(top, n), mp.promotion_chain(top, n))
        errs["promotion_chain"] = max(errs["promotion_chain"], err_c)
        if err_c:
            raise AssertionError(f"promotion_chain differs from plain on the top tree at n={n}")
    errs["path_rehash"] = max(errs["path_rehash"], err)
    if err:
        raise AssertionError(f"path_rehash differs from plain on a shard's subtree: {err}")
    del base, got, want
    log(f"[sharded] kernels at the shards' shapes: path_rehash on a 2^{lsh.bit_length() - 1}"
        f"-leaf shard at {len(pos)} positions and promotion_chain on a {d}-root top tree "
        f"(n = 1..{d}) bit-exact vs plain")

    # (a) rebuild + diff on phase 3's data. The step needs N = D * 2^k: it
    # runs on the largest such prefix, against the single-device step on
    # the same prefix; the 2-D diff runs on all keys.
    n_keys = reb["blocks"].shape[0]
    n_sh = d << ((n_keys // d).bit_length() - 1)
    args = (reb["blocks"][:n_sh], reb["nblocks"][:n_sh], reb["digests"][:, :n_sh],
            reb["present"][:, :n_sh])
    mesh = make_mesh({"key": d}, devices=devs)
    with acc:
        root_s, masks_s, counts_s = sharded_anti_entropy_step(mesh, *args)
        sync_all(devs)
    if acc.last["leaf"] != d or acc.last["node_pairs"]:
        raise AssertionError(f"the sharded step did not hash per shard: {acc.last}")
    root_1, masks_1, counts_1 = anti_entropy_forward(*args, device=dev)
    if not (torch.equal(root_s.to(dev), root_1) and torch.equal(masks_s.to(dev), masks_1)
            and torch.equal(counts_s.to(dev), counts_1)):
        raise AssertionError("sharded anti-entropy step differs from the single-device step")
    if not torch.equal(masks_1, reb["expected"][:, :n_sh]):
        raise AssertionError("sharded masks differ from the injected divergence")
    mesh2 = make_mesh({"replica": 2, "key": 2}, devices=(devs * 4)[:4])
    with acc:
        masks_2d, counts_2d = sharded_divergence_2d(mesh2, reb["digests"], reb["present"])
        sync_all(devs)
    want_counts = reb["expected"].sum(dim=1, dtype=torch.int32)
    if not (torch.equal(masks_2d.to(dev), reb["expected"])
            and torch.equal(counts_2d.to(dev), want_counts)):
        raise AssertionError("sharded_divergence_2d differs from the injected divergence")

    def timed(fn, sync_devs, reps=5):
        out = []
        for _ in range(reps):
            sync_all(sync_devs)
            t = time.perf_counter()
            fn()
            sync_all(sync_devs)
            out.append(time.perf_counter() - t)
        return statistics.median(out)

    # The per-device form (``multihost.lift_local_shards``): each shard
    # already on its device, lifted once outside the timed runs, so the
    # step copies no input between cards.
    lifted = multihost.lift_local_shards(mesh, *args)
    sync_all(devs)
    with acc:
        root_p, masks_p, counts_p = sharded_anti_entropy_step(mesh, *lifted)
        sync_all(devs)
    if not (torch.equal(root_p, root_s) and torch.equal(masks_p, masks_s)
            and torch.equal(counts_p, counts_s)):
        raise AssertionError("the per-device step differs from the single-tensor step")
    step_s = timed(lambda: sharded_anti_entropy_step(mesh, *args), devs)
    single_s = timed(lambda: anti_entropy_forward(*args, device=dev), [dev])
    step_pd_s = timed(lambda: sharded_anti_entropy_step(mesh, *lifted), devs)
    step2_s = timed(lambda: sharded_anti_entropy_step(mesh, *args), devs)
    log(f"[sharded] (a) anti-entropy step {n_sh} keys x {args[2].shape[0]} replicas ({where}): "
        f"root, masks and counts == the single-device step == the per-device form, masks == "
        f"injected; sharded_divergence_2d over a 2 x 2 mesh on all {n_keys} keys == injected, "
        f"counts {counts_2d.tolist()}; median of 5 wall times, every device synchronised: "
        f"sharded {step_s * 1e3:.3f} ms then {step2_s * 1e3:.3f} ms, per-device form (inputs "
        f"already on their cards) {step_pd_s * 1e3:.3f} ms, single device "
        f"{single_s * 1e3:.3f} ms")
    del masks_s, masks_1, masks_2d, masks_p, lifted

    # (b) the sharded serving tree at 1M keys, against the single-device
    # state fed the same batches, and the CPU golden tree at the end.
    items = [(b"inc:%09d" % i, b"v%d" % i) for i in range(n_tree)]
    with acc:
        t = time.perf_counter()
        st = ShardedDeviceMerkleState.from_items(items, shards=d, devices=devs)
        sync_all(devs)
        build_s = time.perf_counter() - t
    one = DeviceMerkleState.from_items(items, device=dev)
    if st.root_hex() != one.root_hex():
        raise AssertionError("sharded build root differs from the single-device root")
    final = dict(items)
    l = st._capacity // d
    top_reduce = (d - 1).bit_length()
    spent = 0.0
    for b in range(batches):
        idx = rng.integers(0, n_tree, size=batch)
        changes = [(b"inc:%09d" % i, b"s%d-%d" % (b, i)) for i in idx]
        owners = len(set((idx // l).tolist()))
        with acc:
            t = time.perf_counter()
            st.apply(changes)
            st.flush_pending()
            spent += time.perf_counter() - t
        want = {**dict.fromkeys(acc.last, 0), "path_rehash": owners, "node_level": top_reduce}
        if acc.last != want:
            raise AssertionError(f"value batch {b} launched {acc.last}, expected {want}")
        with acc:
            t = time.perf_counter()
            root = st.root_hex()
            spent += time.perf_counter() - t
        if acc.last["promotion_chain"] != (2 if d > 1 else 1):
            raise AssertionError(f"a root read launched {acc.last}")
        one.apply(changes)
        final.update(changes)
        if root != one.root_hex():
            raise AssertionError(f"sharded root differs from the single-device root after batch {b}")
    rate = batches * batch / spent
    # One structural batch: inserts and deletes spread over every shard.
    ins = [(b"inc:%09d-x" % i, b"new%d" % i) for i in rng.integers(0, n_tree, size=batch)]
    dels = [(items[i][0], None) for i in rng.choice(n_tree, size=batch, replace=False)]
    with acc:
        st.apply(ins + dels)
        st.flush_pending()
    one.apply(ins + dels)
    final.update(ins)
    for k, _ in dels:
        final.pop(k)
    if st.root_hex() != one.root_hex():
        raise AssertionError("sharded root differs from the single-device root after the "
                             "structural batch")
    for a, w in zip(st.to_numpy_levels(), one.to_numpy_levels(), strict=True):
        if not np.array_equal(a, w):
            raise AssertionError("sharded to_numpy_levels differs from the single-device levels")
    slices = 0
    for level, m in enumerate(ref_level_sizes(len(final))):
        mid = int(rng.integers(0, m))
        for lo, hi in ((0, 4), (mid, mid + 4), (m - 3, m)):
            if st.level_nodes(level, lo, hi) != one.level_nodes(level, lo, hi):
                raise AssertionError(f"sharded level {level} [{lo}, {hi}) differs")
            slices += 1
    if st.root_hex() != CpuMerkleState.from_items(final.items()).root_hex():
        raise AssertionError("sharded root differs from the CPU golden tree")
    log(f"[sharded] (b) serving tree {n_tree} keys ({where}): build {build_s:.3f} s; "
        f"{batches} value batches of {batch}: each one path_rehash per shard that received "
        f"keys + {top_reduce} node_level (the top reduce), no other launch; each root read "
        f"{2 if d > 1 else 1} promotion_chain; {rate:.0f} writes/s (sharded apply + flush + "
        f"root read only); every root == the single-device state; after a structural batch "
        f"of {batch} inserts + {batch} deletes: to_numpy_levels and {slices} TREELEVEL slices "
        f"(each level's last node included) == the single-device state, root == the CPU "
        f"golden tree")
    del st, one

    # (c) the diff engine's sharded branch at the sync_multi shape.
    base_d = rng.integers(0, 2**32, size=(1, multi_keys, 8), dtype=np.uint64).astype(np.uint32)
    dig = np.repeat(base_d, 3, axis=0)
    pres = np.ones((3, multi_keys), bool)
    dig[1, rng.choice(multi_keys, 100, replace=False), 3] ^= 1
    pres[2, rng.choice(multi_keys, 100, replace=False)] = False
    routed = []
    real = sharded_merkle.sharded_divergence
    sharded_merkle.sharded_divergence = lambda *a, **kw: routed.append(1) or real(*a, **kw)
    try:
        with acc:
            got = tdiff.divergence_masks_engine(dig, pres, device=dev, devices=devs)
    finally:
        sharded_merkle.sharded_divergence = real
    single = tdiff.divergence_masks_engine(dig, pres, device=dev, devices=[dev])
    if routed != [1] or not torch.equal(got, single):
        raise AssertionError(f"the diff engine's sharded branch ({len(routed)} calls) differs "
                             "from the single-device masks")
    if not np.array_equal(got.cpu().numpy(), tdiff.divergence_masks_np(dig, pres)):
        raise AssertionError("the diff engine's masks differ from the host twin")
    log(f"[sharded] (c) divergence_masks_engine {multi_keys} keys x 3 replicas went through "
        f"the sharded branch ({where}); masks == single device == host twin, per replica "
        f"{got.sum(dim=1).tolist()}")

    # (d) the mirror on rung D, a shard{D}_scatter fault, heal.
    eng = DictEngine(items)
    golden = CpuMerkleState.from_items(items)
    base_c = _counters()
    heal = RetryPolicy(first_delay=SHARDED_HEAL_S, max_delay=SHARDED_HEAL_S, jitter=0.0)
    m = DeviceTreeMirror(eng, device=dev, devices=devs, sharding=str(d), scrub_interval_s=0.0,
                         ladder=DeviceBackendLadder(d, degrade_after=1, heal_policy=heal,
                                                    cpu_rung=False))
    inj = None
    checks = 0

    def stage(tag: str) -> list:
        idx = rng.integers(0, n_tree, size=batch)
        changes = [(b"inc:%09d" % i, b"%s-%d" % (tag.encode(), i)) for i in idx]
        eng.write(changes)
        m.on_events(_events(changes), eng.version())
        return changes

    def check(what: str, rung: int) -> None:
        nonlocal checks
        if m.backend_level() != rung:
            raise AssertionError(f"the mirror is on rung {m.backend_level()}, not {rung} ({what})")
        _check_mirror(m, eng, golden, rng, what)
        checks += 1

    try:
        with acc:
            t = time.perf_counter()
            if m._resolve_shards() != d:
                raise AssertionError(f"sharding={d} resolved to {m._resolve_shards()}")
            m.start_warming()
            _wait_warm(m, base_c, 300)
            warm_s = time.perf_counter() - t
            check("warm", d)
            t = time.perf_counter()
            staged = [stage(f"m{b}") for b in range(batches)]
            wm = eng.version()
            if not _wait(lambda: (m.published_root_stamped() or (None, -1))[1] >= wm, 120):
                raise AssertionError("the pump never published the last batch")
            fed_s = time.perf_counter() - t
            for changes in staged:
                golden.apply(changes)
            check(f"{batches} staged batches", d)

            inj = DeviceFaultInjector(match=f"shard{d}_scatter", mode="fail").install()
            t = time.perf_counter()
            golden.apply(stage("fault"))
            if not _wait(lambda: m.ready() and m.backend_level() == d // 2, 120, 0.002):
                raise AssertionError(f"the mirror did not step down to rung {d // 2}")
            down_s = time.perf_counter() - t
            check("step-down", d // 2)
            golden.apply(stage("down"))
            check("a batch on the lower rung", d // 2)
            failures = inj.failures
            inj.heal()
            t = time.perf_counter()
            if not _wait(lambda: m.ready() and m.backend_level() == d, 120, 0.005):
                raise AssertionError(f"the mirror did not climb back to rung {d}")
            climb_s = time.perf_counter() - t
            inj.uninstall()
            inj = None
            golden.apply(stage("healed"))
            check("after the climb", d)
    finally:
        if inj is not None:
            inj.uninstall()
        m.close()
    delta = {k: v - base_c.get(k, 0) for k, v in _counters().items()}
    got_c = {k: delta.get(k, 0) for k in (
        "device.guard_errors", "device.guard_retries", "device.pump_errors",
        "device.warm_errors", "device.rewarms", "device.degraded_total",
        "device.healed_total", "device.guard_timeouts")}
    want_c = {"device.guard_errors": 1, "device.guard_retries": 1, "device.pump_errors": 1,
              "device.warm_errors": 0, "device.rewarms": 1, "device.degraded_total": 1,
              "device.healed_total": 1, "device.guard_timeouts": 0}
    if got_c != want_c or failures != 2:
        raise AssertionError(f"drill counters {got_c} (injected failures {failures}) != {want_c}")
    seconds = time.perf_counter() - t_phase
    log(f"[sharded] (d) mirror {n_tree} keys, sharding={d} ({where}): warm on rung {d} "
        f"{warm_s:.3f} s; {batches} staged batches of {batch} published in {fed_s:.3f} s "
        f"({batches * batch / fed_s:.0f} writes/s); fail:shard{d}_scatter: one failed drain "
        f"({failures} injected failures, the guard's retry included) stepped down to rung "
        f"{d // 2} on the card in {down_s:.3f} s; heal: back on rung {d} in {climb_s:.3f} s "
        f"(heal probe after {SHARDED_HEAL_S:g} s); {checks} checks (stamped root, TREELEVEL "
        f"slices, staleness 0) == CpuMerkleState; counters {got_c}")
    log(f"[sharded] phase {seconds:.1f} s; launches {acc.total}")
    return {"launches": acc.total, "seconds": seconds, "step_ms": step_s * 1e3,
            "step_pd_ms": step_pd_s * 1e3, "single_ms": single_s * 1e3, "writes_per_s": rate,
            "where": where, "root": root_1, "counts": counts_1, "n_keys": n_sh}


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
    TCP with a forced HASH after each batch, a bisect SYNC of a 0.25%-diverged
    node, and a 3-node multi-sync past the device threshold."""
    import tempfile

    from merklekv_tpu_torch.cluster.sync import _DEVICE_THRESHOLD
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES, reset_launch_counts

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

            # B: A's content with 0.25% diverged (half other values, half
            # deleted), then a bisect SYNC from A. B is the stale replica:
            # its writes are older than A's, so the walk's one-way repair
            # and the last-writer-wins install of a resumed cycle's pending
            # repairs (the reference's rule) both take A's side.
            # B repairs with replication off (the procedure for a diverged
            # node), so its mirror does not restructure a 1M-key tree for
            # every repaired insert; it warms on the card afterwards.
            final = a.engine.snapshot()
            keys = [k for k, _ in final]
            changed, deleted = _diverge(rng, keys, NODE_SYNC_DIVERGED, b"div")
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
            if len(cycles) < 2:
                raise AssertionError(f"the SYNC never resumed a checkpointed cycle: {cycles}")
            injected = len(changed) + len(deleted)
            if found != injected:
                raise AssertionError(f"SYNC found {found} divergent keys in {cycles}, "
                                     f"injected {injected}")
            if sync_launches["leaf_ragged"] < len(cycles):
                raise AssertionError(f"the SYNC leaf passes did not run the ragged leaf kernel: "
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
            if multi_launches["leaf_ragged"] < 1:
                raise AssertionError(f"the multi-sync leaf pass did not run the ragged leaf "
                                     f"kernel: {multi_launches}")
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
        f"in {warm_b_s:.3f} s; roots of A, B and golden equal; launches {sync_launches}; cut: "
        f"divergence 1% -> {NODE_SYNC_DIVERGED:.2%}, keeping {n_keys} keys")
    log(f"[node] 3-node sync_multi over {mrep.union_keys} union keys (device threshold "
        f"{_DEVICE_THRESHOLD}): {multi_s:.3f} s, per-peer divergence "
        f"{sorted(mrep.per_peer_divergent.values())} == injected; launches {multi_launches}; "
        f"faults {bad}; phase launches {launches}")
    return {"launches": launches, "writes_per_s": rate, "warm_s": warm_s, "max_lag_ms": max_lag,
            "sync_s": sync_s, "multi_s": multi_s}


# ------------------------------------------------------ phase 10: durable

def _spawn_durable(root_dir, data: str, port: int, env: dict, log_path: str):
    """``python -m merklekv_tpu_torch --durable`` as a user starts it: (the
    process, its port, its ``storage: recovered ...`` line)."""
    with open(log_path, "a") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "merklekv_tpu_torch", "--durable", "--storage-path", data,
             "--port", str(port)],
            cwd=str(root_dir), env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    line = proc.stdout.readline()
    storage = proc.stdout.readline()
    if not (line.startswith("merklekv_tpu_torch listening on ")
            and storage.startswith("storage: recovered ")):
        proc.kill()
        proc.wait(30)
        with open(log_path) as f:
            raise AssertionError(f"no readiness/storage lines: {line!r} {storage!r} "
                                 f"{f.read()[-2000:]}")
    return proc, int(line.split()[3].rsplit(":", 1)[1]), storage.strip()


def phase_durable(seed: int, n_keys: int = DURABLE_KEYS, batch: int = BATCH) -> dict:
    """10: the durable node at 1M keys (config 4), its snapshot roots on the
    card. (a) spawned as a user runs it: load over TCP, SIGTERM (shutdown
    snapshot), ``walcheck --json --engine tpu``, restart (recovery verifies
    the snapshot root on the card), a batch of SETs, SIGKILL after the WAL
    drain, restart (WAL replay); every root == golden. (b) in this process
    through ``__main__.start``: the recovery check and a forced snapshot each
    launch the leaf and level kernels, ``device.fallbacks`` stays 0."""
    import os
    import signal
    import tempfile
    from pathlib import Path

    from merklekv_tpu_torch.__main__ import parse_config, start
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
    from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES, reset_launch_counts
    from merklekv_tpu_torch.storage import snapshot as snapmod

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 10)
    root_dir = Path(__file__).resolve().parent
    items = _node_items(n_keys)
    golden = CpuMerkleState.from_items(items)
    with tempfile.TemporaryDirectory(prefix="mkv-durable-") as tmp:
        data = os.path.join(tmp, "data")
        log_path = os.path.join(tmp, "node.err")
        env = dict(os.environ, PYTHONPATH=str(root_dir))
        procs = []
        try:
            t = time.perf_counter()
            proc, port, _ = _spawn_durable(root_dir, data, 0, env, log_path)
            procs.append(proc)
            ready_s = time.perf_counter() - t
            c = _client(port)
            t = time.perf_counter()
            _tcp_load(c, items)
            load_s = time.perf_counter() - t
            if c.hash() != golden.root_hex():
                raise AssertionError("the durable node's HASH differs from the golden root")
            c.close()
            t = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            if proc.wait(600) != 0:
                raise AssertionError(f"the durable node exited {proc.returncode} on SIGTERM")
            sigterm_s = time.perf_counter() - t
            node_dir = os.path.join(data, f"node-{port}")
            # The newest snapshot is the shutdown one (a compaction may have
            # written another during the load, past compact_trigger_bytes).
            snaps = snapmod.list_snapshots(node_dir)
            if not snaps:
                raise AssertionError("SIGTERM left no snapshot")
            snap_bytes = os.path.getsize(snaps[-1][1])
            if snapmod.read_snapshot_header(snaps[-1][1])[1:3] != (golden.root_hex(), n_keys):
                raise AssertionError("the shutdown snapshot's stamp is not the golden root")

            t = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "merklekv_tpu_torch", "walcheck", node_dir, "--json",
                 "--engine", "tpu"],
                cwd=str(root_dir), env=env, capture_output=True, text=True, timeout=600)
            walcheck_s = time.perf_counter() - t
            report = json.loads(out.stdout) if out.returncode == 0 else {}
            if report.get("replay_root") != golden.root_hex() or report.get("errors"):
                raise AssertionError(f"walcheck rc {out.returncode}: {out.stdout[-500:]} "
                                     f"{out.stderr[-1500:]}")

            t = time.perf_counter()
            proc, _, recovered = _spawn_durable(root_dir, data, port, env, log_path)
            procs.append(proc)
            restart_s = time.perf_counter() - t
            if f"({n_keys} items)" not in recovered:
                raise AssertionError(f"restart did not load the snapshot: {recovered}")
            c = _client(port)
            if c.hash() != golden.root_hex():
                raise AssertionError("HASH after the snapshot recovery differs from golden")
            idx = rng.integers(0, n_keys, size=batch)
            changes = [(b"inc:%09d" % i, b"d%d" % i) for i in idx]
            _tcp_load(c, changes)
            golden.apply(changes)
            c.close()
            time.sleep(DURABLE_WAL_DRAIN_S)
            proc.send_signal(signal.SIGKILL)
            proc.wait(60)

            t = time.perf_counter()
            proc, _, replayed = _spawn_durable(root_dir, data, port, env, log_path)
            procs.append(proc)
            replay_s = time.perf_counter() - t
            c = _client(port)
            if c.hash() != golden.root_hex():
                raise AssertionError(f"HASH after SIGKILL + WAL replay differs from golden "
                                     f"({replayed})")
            c.close()
            proc.send_signal(signal.SIGTERM)
            if proc.wait(600) != 0:
                raise AssertionError(f"the durable node exited {proc.returncode} on SIGTERM")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(30)

        # (b) in this process, so the launch counters are readable.
        base = _counters()
        root_s = []
        real = snapmod.compute_root_hex

        def timed_root(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                root_s.append(time.perf_counter() - t0)

        snapmod.compute_root_hex = timed_root
        try:
            reset_launch_counts()
            t = time.perf_counter()
            run = start(parse_config(["--durable", "--storage-path", data, "--port", str(port)]))
            recover_s = time.perf_counter() - t
            at_recovery = dict(LAUNCHES)
            try:
                if run.recovery.final_root != golden.root_hex():
                    raise AssertionError("in-process recovery root differs from golden")
                t = time.perf_counter()
                path = run.storage.snapshot_now()
                snap_s = time.perf_counter() - t
                at_snapshot = {k: v - at_recovery[k] for k, v in LAUNCHES.items()}
                if snapmod.read_snapshot_header(path)[1] != golden.root_hex():
                    raise AssertionError("the forced snapshot's stamp is not the golden root")
            finally:
                run.close()
        finally:
            snapmod.compute_root_hex = real
        launches = dict(LAUNCHES)
    for what, got in (("the recovery check", at_recovery), ("the forced snapshot", at_snapshot)):
        if got["leaf_ragged"] != 1 or got["node_level"] < 1:
            raise AssertionError(f"{what} did not hash on the card: {got}")
    fallbacks = _counters().get("device.fallbacks", 0) - base.get("device.fallbacks", 0)
    if fallbacks:
        raise AssertionError(f"device.fallbacks rose by {fallbacks}")
    log(f"[durable] (a) python -m merklekv_tpu_torch --durable, {n_keys} keys: ready in "
        f"{ready_s:.3f} s; loaded over TCP in {load_s:.3f} s; SIGTERM to exit 0 (final drain + "
        f"shutdown snapshot) {sigterm_s:.3f} s, {len(snaps)} snapshot(s), the newest "
        f"{snap_bytes} bytes stamped with the "
        f"golden root; walcheck --json --engine tpu {walcheck_s:.3f} s, replay_root == golden; "
        f"restart to the storage line (recovery, root verified on the card) {restart_s:.3f} s, "
        f"HASH == golden; {batch} SETs, SIGKILL {DURABLE_WAL_DRAIN_S:g} s later, restart "
        f"(snapshot + WAL replay) {replay_s:.3f} s, HASH == the new golden root ({replayed})")
    log(f"[durable] (b) in-process start with recovery {recover_s:.3f} s (its root "
        f"{root_s[0]:.3f} s), launches {at_recovery}; forced snapshot {snap_s:.3f} s (its root "
        f"{root_s[1]:.3f} s), launches {at_snapshot}; shutdown snapshot root {root_s[2]:.3f} s; "
        f"device.fallbacks +0; launches in all {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "ready_s": ready_s, "load_s": load_s, "sigterm_s": sigterm_s,
            "walcheck_s": walcheck_s, "restart_s": restart_s, "replay_s": replay_s,
            "snap_s": snap_s, "root_s": root_s[1], "snap_bytes": snap_bytes}


# ------------------------------------------------------ phase 12: partitions

# Each node process runs ``python -m merklekv_tpu_torch`` through runpy (what
# ``-m`` does), with a SIGUSR1 handler that writes the process's kernel
# launch counts to ``$MKV_SMOKE_LAUNCH_DIR/<pid>.json``: the counters live in
# the node process, and this is how the phase reads them.
_NODE_BOOT = r"""
import json, os, runpy, signal, sys

def _dump(signum, frame):
    mod = sys.modules.get("merklekv_tpu_torch.ops.cuda_lib")
    counts = dict(mod.LAUNCHES) if mod is not None else {}
    paths = sys.modules.get("merklekv_tpu_torch.ops.merkle_paths")
    counts["path_ks"] = dict(paths.PATH_KS) if paths is not None else {}
    path = os.path.join(os.environ["MKV_SMOKE_LAUNCH_DIR"], f"{os.getpid()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(counts, f)
    os.replace(path + ".tmp", path)

signal.signal(signal.SIGUSR1, _dump)
sys.argv = ["merklekv_tpu_torch", *sys.argv[1:]]
runpy.run_module("merklekv_tpu_torch", run_name="__main__", alter_sys=True)
"""


class _PartCluster:
    """Phase 12's processes: the port's broker, two partitions of two durable
    replicas each, one durable reserve node, and a router. Every process is
    killed by :meth:`close`, whatever happened before."""

    def __init__(self, tmp: str, root_dir) -> None:
        import os
        import uuid

        self.tmp = tmp
        self.root_dir = root_dir
        self.launch_dir = os.path.join(tmp, "launches")
        os.makedirs(self.launch_dir)
        self.env = dict(os.environ, PYTHONPATH=str(root_dir),
                        MKV_SMOKE_LAUNCH_DIR=self.launch_dir)
        self.topic = f"smoke-part-{uuid.uuid4().hex[:8]}"
        self.procs: dict = {}
        self.dead_launches: list = []
        self.path_ks: dict = {}  # pid -> its path-rehash launches by k, at its last report
        self.broker_port = None
        self.ports = {}

    def _spawn(self, name: str, args: list, boot: bool):
        import os

        log_f = open(os.path.join(self.tmp, f"{name}.log"), "a")
        cmd = [sys.executable, "-c", _NODE_BOOT, *args] if boot else [sys.executable, *args]
        proc = subprocess.Popen(cmd, cwd=str(self.root_dir), env=self.env,
                                stdout=subprocess.PIPE, stderr=log_f, text=True)
        log_f.close()
        self.procs[name] = proc
        return proc

    def _ready(self, name: str, prefix: str) -> tuple[int, float]:
        """Wait for ``name``'s readiness line; (port, seconds)."""
        t = time.perf_counter()
        proc = self.procs[name]
        line = proc.stdout.readline()
        if not line.startswith(prefix):
            proc.kill()
            with open(f"{self.tmp}/{name}.log") as f:
                raise AssertionError(f"{name}: no readiness line: {line!r} {f.read()[-2000:]}")
        threading.Thread(target=lambda: [None for _ in proc.stdout], daemon=True).start()
        port = int(line.split(" listening on ")[1].split()[0].rsplit(":", 1)[1])
        return port, time.perf_counter() - t

    def start_broker(self) -> None:
        self._spawn("broker", ["-m", "merklekv_tpu_torch.broker", "--port", "0"], boot=False)
        self.broker_port, _ = self._ready("broker", "merklekv broker")

    def toml(self, name: str, port: int, spec: str = "", pid: int = -1,
             boot: bool = False) -> str:
        import os

        cluster = (f'[cluster]\npartitions = 2\npartition_id = {pid}\n'
                   f'partition_map = "{spec}"\n' if spec else "")
        path = os.path.join(self.tmp, f"{name}.toml")
        with open(path, "w") as f:
            f.write(f'host = "127.0.0.1"\nport = {port}\n'
                    f'storage_path = "{self.tmp}/data"\n{cluster}'
                    '[storage]\nenabled = true\nmerkle_engine = "auto"\n'
                    f'[replication]\nenabled = {"true" if spec else "false"}\n'
                    f'mqtt_broker = "127.0.0.1"\nmqtt_port = {self.broker_port}\n'
                    f'topic_prefix = "{self.topic}"\n'
                    '[anti_entropy]\nengine = "auto"\ninterval_seconds = 3600\n'
                    f'[bootstrap]\nenabled = {"true" if boot else "false"}\n')
        return path

    def start_node(self, name: str, cfg: str) -> None:
        self._spawn(name, ["--config", cfg, "--durable"], boot=True)

    def launches(self, name: str, timeout: float = 60.0) -> dict:
        """The node process's kernel launch counts, now."""
        import os
        import signal

        from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES

        proc = self.procs[name]
        path = os.path.join(self.launch_dir, f"{proc.pid}.json")
        if os.path.exists(path):
            os.remove(path)
        os.kill(proc.pid, signal.SIGUSR1)
        end = time.monotonic() + timeout
        while not os.path.exists(path):
            if time.monotonic() > end or proc.poll() is not None:
                raise AssertionError(f"{name} did not report its launch counts")
            time.sleep(0.02)
        with open(path) as f:
            got = json.load(f)
        self.path_ks[proc.pid] = collections.Counter(
            {int(k): n for k, n in got.get("path_ks", {}).items()})
        return {k: int(got.get(k, 0)) for k in LAUNCHES}

    def kill9(self, name: str) -> None:
        """SIGKILL ``name`` after reading its launch counts."""
        import signal

        self.dead_launches.append(self.launches(name))
        proc = self.procs.pop(name)
        proc.send_signal(signal.SIGKILL)
        proc.wait(60)

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)


def _golden_root(items) -> str:
    """merkle/cpu.py's root over ``items`` (sorted here)."""
    from merklekv_tpu_torch.merkle.cpu import build_levels
    from merklekv_tpu_torch.merkle.encoding import EMPTY_ROOT_HEX, leaf_hash

    items = sorted(items)
    if not items:
        return EMPTY_ROOT_HEX
    return build_levels([leaf_hash(k, v) for k, v in items])[-1][0].hex()


def _part_root(port: int, pid: int) -> str:
    """The node's ``pt=``-addressed, forced HASH (its mirror's root)."""
    c = _client(port)
    try:
        c.partition_id = pid
        return c.hash(force=True)
    finally:
        c.close()


def _await_roots(members: dict, want: dict, timeout: float, what: str) -> None:
    """Wait until every member (name -> (port, pid)) serves ``want[pid]``."""
    end = time.monotonic() + timeout
    got = {}
    while time.monotonic() < end:
        got = {name: _part_root(port, pid) for name, (port, pid) in members.items()}
        if all(got[name] == want[pid] for name, (_, pid) in members.items()):
            return
        time.sleep(0.25)
    raise AssertionError(f"{what}: roots {got} != golden {want}")


def check_top(out: str, serving: list, reserve: str) -> dict:
    """``top --once --events`` output over the cluster: every node UP, the
    serving replicas on BKND 1 with their partition in PART, no
    ``device_degraded`` event in the events pane. Returns each node's row
    (column -> value)."""
    lines = out.splitlines()
    header = lines[0].split()
    rows = {}
    for ln in lines[2:]:
        if not ln.strip() or ln.startswith("-- "):
            break
        rows[ln.split()[0]] = dict(zip(header, ln.split()))
    for addr in serving + [reserve]:
        if rows.get(addr, {}).get("STATUS") != "UP":
            raise AssertionError(f"top: {addr} is not UP: {out[-3000:]}")
    for addr in serving:
        if rows[addr]["BKND"] != "1" or rows[addr]["PART"] not in ("0", "1"):
            raise AssertionError(f"top: {addr} BKND {rows[addr]['BKND']}, PART "
                                 f"{rows[addr]['PART']}: {out[-3000:]}")
    pane = out[out.index("-- flight events"):].splitlines()[2:]
    if any(len(ln.split()) > 2 and ln.split()[2] in DEVICE_ANOMALIES for ln in pane):
        raise AssertionError(f"top shows a device event: {pane}")
    return rows


def _p99_ms(lat: list) -> float:
    s = sorted(lat)
    return s[min(int(0.99 * (len(s) - 1)), len(s) - 1)] * 1e3 if s else float("nan")


def phase_partitions(seed: int, n_keys: int = PART_KEYS, batch: int = BATCH,
                     steady_s: float = PART_STEADY_S, sample: int = PART_SAMPLE,
                     pause_s: float = PART_PAUSE_S) -> dict:
    """12: partitioned cluster mode at config 4's keyspace, every node a
    ``python -m merklekv_tpu_torch --durable`` process whose mirror, range
    roots and snapshot roots are on the card. (a) load over pipelined MSETs
    per partition; every replica's HASH == the golden root of its
    partition's items; a seeded sample of GETs through the router. (b) a
    live split of partition 0 to the reserve node under a steady load of
    4096-key MSET batches: zero client errors, epoch E+1, three partitions'
    roots golden under the new map, leaf and level launches on the donor and
    the joiner. (c), run right after (a): SIGKILL a replica of partition 1,
    delete its data directory, restart it with [bootstrap] enabled: it
    verifies its sibling's snapshot on the card and serves the sibling's
    root. (d)
    ``device.fallbacks`` 0 on every node."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from merklekv_tpu_torch.client import MerkleKVClient, PartitionedClient
    from merklekv_tpu_torch.cluster.partmap import partition_of

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 12)
    root_dir = Path(__file__).resolve().parent
    final = dict(_node_items(n_keys))
    with tempfile.TemporaryDirectory(prefix="mkv-part-") as tmp:
        pc_ = _PartCluster(tmp, root_dir)
        try:
            pc_.start_broker()
            socks = []
            import socket

            for _ in range(5):
                s = socket.socket()
                s.bind(("127.0.0.1", 0))
                socks.append(s)
            ports = dict(zip(("a0", "b0", "a1", "b1", "r"), (s.getsockname()[1] for s in socks)))
            for s in socks:
                s.close()
            addr = {n: f"127.0.0.1:{p}" for n, p in ports.items()}
            spec = f"0={addr['a0']},{addr['b0']};1={addr['a1']},{addr['b1']}"
            pid_of = {"a0": 0, "b0": 0, "a1": 1, "b1": 1}
            t = time.perf_counter()
            for name in ("a0", "b0", "a1", "b1", "r"):
                pc_.start_node(name, pc_.toml(name, ports[name], spec if name != "r" else "",
                                              pid_of.get(name, -1)))
            for name in ("a0", "b0", "a1", "b1", "r"):
                pc_._ready(name, "merklekv_tpu_torch listening on ")
            ready_s = time.perf_counter() - t
            pc_._spawn("router", ["-m", "merklekv_tpu_torch", "router", "--port", "0",
                                  "--seeds", f"{addr['a0']},{addr['a1']}"], boot=False)
            router_port, _ = pc_._ready("router", "merklekv_tpu_torch router")

            # (a) load: pipelined MSETs per partition, routed by the smart
            # client's map.
            # The fence over the moving range answers a retryable BUSY
            # until the flip; this client's BUSY budget (about 2 minutes at
            # its 0.5 s backoff cap) waits it out instead of surfacing it.
            pc = PartitionedClient([addr["a0"]], timeout=120,
                                   busy_retries=PART_BUSY_RETRIES).connect()
            if (pc.map.epoch, pc.map.count) != (1, 2):
                raise AssertionError(f"PARTMAP: epoch {pc.map.epoch}, {pc.map.count} partitions")
            items = list(final.items())
            t = time.perf_counter()
            for pid in (0, 1):
                mine = [kv for kv in items if pc.map.partition_for_key(kv[0]) == pid]
                host, port = pc.map.replicas[pid][0].rsplit(":", 1)
                c = _client(int(port))
                _tcp_load(c, mine)
                c.close()
            load_s = time.perf_counter() - t
            want = {pid: _golden_root((k, v) for k, v in final.items()
                                      if partition_of(k, 2) == pid) for pid in (0, 1)}
            counts = {pid: sum(1 for k in final if partition_of(k, 2) == pid) for pid in (0, 1)}
            members = {n: (ports[n], pid_of[n]) for n in pid_of}
            # Replication first (a DBSIZE per replica, no tree work), then
            # the mirrors: a HASH starts a replica's warm, and a forced one
            # drains its pump, so polling roots while the siblings still
            # apply the load would restructure their trees over and over.
            t = time.perf_counter()
            end = time.monotonic() + 600
            while True:
                sizes = {}
                for n, (port, pid) in members.items():
                    c = _client(port)
                    sizes[n] = c.dbsize()
                    c.close()
                if all(sizes[n] == counts[pid] for n, (_, pid) in members.items()):
                    break
                if time.monotonic() > end:
                    raise AssertionError(f"(a) replication never completed: {sizes} != {counts}")
                time.sleep(0.25)
            replicate_s = time.perf_counter() - t
            t = time.perf_counter()
            _await_roots(members, want, 600, "(a) after the load")
            converge_s = time.perf_counter() - t
            keys = list(final)
            picks = rng.choice(len(keys), size=sample, replace=False)
            via = MerkleKVClient("127.0.0.1", router_port, timeout=60).connect()
            for i in picks:
                k = keys[i]
                if via.get(k.decode()) != final[k].decode():
                    raise AssertionError(f"GET {k!r} through the router is not what was written")
            via.close()

            log(f"[partitions] (a) 5 durable nodes (2 partitions x 2 replicas + 1 reserve) ready "
                f"in {ready_s:.3f} s; {n_keys} keys over pipelined MSETs per partition in "
                f"{load_s:.3f} s; siblings replicated them {replicate_s:.3f} s later; every "
                f"replica's HASH (its mirror warmed by it) == its partition's golden root "
                f"{converge_s:.3f} s after that; {sample} GETs through the router == written")

            # (c), run before (b): a wiped replica of partition 1 bootstraps
            # from its sibling. Its sibling holds no snapshot yet (the load
            # stayed under compact_trigger_bytes), so it writes one of its
            # current state when asked, and the delta walk after the
            # install has nothing to repair; a stale snapshot would leave a
            # delta the bisect walk repairs slowly (ROADMAP Queue C).
            n1 = counts[1]
            pc_.kill9("b1")
            shutil.rmtree(os.path.join(tmp, "data", f"node-{ports['b1']}"))
            t = time.perf_counter()
            pc_.start_node("b1", pc_.toml("b1", ports["b1"], spec, 1, boot=True))
            pc_._ready("b1", "merklekv_tpu_torch listening on ")
            boot_ready_s = time.perf_counter() - t
            end = time.monotonic() + 900
            while True:
                try:
                    c = _client(ports["b1"])
                    size = c.dbsize()
                    c.close()
                    if size == n1:
                        break
                except Exception:
                    pass  # the read gate holds until the snapshot verifies
                if time.monotonic() > end:
                    raise AssertionError("the bootstrapped replica never served its keyspace")
                time.sleep(0.05)
            boot_serve_s = time.perf_counter() - t
            at_serve = pc_.launches("b1")  # before any HASH warms its mirror
            if at_serve["leaf_ragged"] < 1 or at_serve["node_level"] < 1:
                raise AssertionError(f"the snapshot was not verified on the card: {at_serve}")
            _await_roots({"b1": (ports["b1"], 1), "a1": (ports["a1"], 1)}, want, 600,
                         "(c) after the bootstrap")
            boot_root_s = time.perf_counter() - t
            c = _client(ports["b1"])
            m = c.metrics()
            c.close()
            if int(m.get("bootstrap.snapshots_installed", 0)) != 1:
                raise AssertionError(f"b1 did not install a snapshot: "
                                     f"{ {k: v for k, v in m.items() if k.startswith('bootstrap')} }")
            log(f"[partitions] (c) SIGKILL + wiped b1 restarted with [bootstrap]: ready in "
                f"{boot_ready_s:.3f} s, serving its {n1} keys {boot_serve_s:.3f} s after the "
                f"restart (launches before any HASH {at_serve}), HASH == sibling == golden "
                f"{boot_root_s:.3f} s after the restart")

            # (b) the live split under a steady load of 4096-key batches.
            before = {n: pc_.launches(n) for n in ("a0", "r")}
            errors: list = []
            lat: list = []
            stop = threading.Event()
            marks = {}
            load_rng = np.random.default_rng(seed + 1200)

            def storm() -> None:
                j = 0
                try:
                    while not stop.is_set():
                        idx = load_rng.integers(0, n_keys, size=batch)
                        pairs = {b"inc:%09d" % i: b"s%d-%d" % (j, i) for i in idx}
                        t0 = time.perf_counter()
                        if not pc.mset({k.decode(): v.decode() for k, v in pairs.items()}):
                            raise AssertionError("MSET answered not OK")
                        lat.append((time.perf_counter(), time.perf_counter() - t0))
                        final.update(pairs)
                        j += 1
                        time.sleep(pause_s)
                except BaseException as e:
                    errors.append(e)

            th = threading.Thread(target=storm, daemon=True)
            th.start()
            time.sleep(steady_s)
            donor = _client(ports["a0"])
            epoch = donor.partition_map().epoch
            marks["split"] = time.perf_counter()
            resp = donor.rebalance(f"SPLIT 0 {epoch} {addr['r']}")
            if not resp.startswith("OK"):
                raise AssertionError(f"SPLIT refused: {resp}")
            # top over the five nodes while the split runs, as a user runs it.
            top_box: dict = {}
            top_th = threading.Thread(target=lambda: top_box.update(zip(
                ("rc", "out", "s"), run_tool(["top", "--nodes", ",".join(addr.values()),
                                              "--once", "--events", "--interval", "0.5",
                                              "--timeout", "10"]))), daemon=True)
            top_th.start()
            state, timeline = "", []
            end = time.monotonic() + 900
            while time.monotonic() < end:
                state = donor.rebalance("STATUS").split(" ")[1]
                if not timeline or timeline[-1][0] != state:
                    timeline.append((state, time.perf_counter() - marks["split"]))
                if state in ("done", "failed", "aborted"):
                    break
                time.sleep(0.05)
            marks["done"] = time.perf_counter()
            time.sleep(1.0)
            stop.set()
            th.join(120)
            top_th.join(120)
            if top_box.get("rc") != 0:
                raise AssertionError(f"top exited {top_box.get('rc')}: {top_box.get('out')}")
            top_rows = check_top(top_box["out"], [addr[n] for n in pid_of], addr["r"])
            if state != "done":
                raise AssertionError(f"the split ended in {state!r}")
            if errors:
                raise AssertionError(f"client-visible error during the split: {errors[0]!r}")
            split_s = marks["done"] - marks["split"]
            steady = [d for t0, d in lat if t0 < marks["split"]]
            during = [d for t0, d in lat if marks["split"] <= t0 <= marks["done"]]
            pmap = donor.partition_map()
            donor.close()
            if (pmap.epoch, pmap.count) != (epoch + 1, 3):
                raise AssertionError(f"after the commit: epoch {pmap.epoch}, {pmap.count} partitions")
            after = {n: pc_.launches(n) for n in ("a0", "r")}
            split_launches = {n: {k: after[n][k] - before[n][k] for k in after[n]} for n in after}
            for n, got in split_launches.items():
                if got["leaf_ragged"] < 2 or got["node_level"] < 2:
                    raise AssertionError(f"{n}'s range and snapshot roots were not hashed on the "
                                         f"card: {got}")
            pid_of["r"] = 2
            members = {n: (ports[n], pid_of[n]) for n in pid_of}
            want = {pid: _golden_root((k, v) for k, v in final.items()
                                      if pmap.partition_for_key(k) == pid) for pid in (0, 1, 2)}
            t = time.perf_counter()
            _await_roots(members, want, 600, "(b) after the split")
            settle_s = time.perf_counter() - t
            moved = sum(1 for k in final if pmap.partition_for_key(k) == 2)
            phases_s = ", ".join(f"{st} at {at:.3f}" for st, at in timeline)
            log(f"[partitions] (b) SPLIT 0 -> reserve under {batch}-key MSET batches "
                f"({pause_s:g} s apart): phase done in {split_s:.3f} s ({phases_s} s), 0 client "
                f"errors, epoch {pmap.epoch}, {moved} keys moved; batch p99 "
                f"{_p99_ms(during):.3f} ms in the split window ({len(during)} batches) vs "
                f"{_p99_ms(steady):.3f} ms steady ({len(steady)} batches); 3 partitions' roots "
                f"== golden {settle_s:.3f} s after done; launches during the split "
                f"{split_launches}")

            # (d) no device failure anywhere; then every node's launches.
            faults = {}
            for n in ("a0", "b0", "a1", "b1", "r"):
                c = _client(ports[n])
                faults[n] = int(c.metrics().get("device.fallbacks", 0))
                c.close()
            if any(faults.values()):
                raise AssertionError(f"device.fallbacks: {faults}")
            per_node = {n: pc_.launches(n) for n in ("a0", "b0", "a1", "b1", "r")}
            pc.close()
            # Every node stops (SIGTERM: its final flight spill), then
            # blackbox reads the five flight directories.
            pc_.close()
            rc, out, box_s = run_tool(["blackbox", "--json"] + [
                os.path.join(tmp, "data", f"node-{ports[n]}", "flight")
                for n in ("a0", "b0", "a1", "b1", "r")])
            box = json.loads(out)
            box_kinds: dict = {}
            for a in box["anomalies"]:
                box_kinds[a["kind"]] = box_kinds.get(a["kind"], 0) + 1
            if rc != 0 or len(box["spills"]) != 5 or set(box_kinds) & set(DEVICE_ANOMALIES):
                raise AssertionError(f"blackbox over the cluster: rc {rc}, "
                                     f"{len(box['spills'])} spills, anomalies {box_kinds}")
        finally:
            pc_.close()
    launches = {k: sum(d[k] for d in list(per_node.values()) + pc_.dead_launches)
                for k in per_node["a0"]}
    seconds = time.perf_counter() - t_phase
    log(f"[partitions] (d) device.fallbacks {faults}; launches {launches}. During the split "
        f"top --once --events exited 0 in {top_box['s']:.3f} s: every node UP, (BKND, PART, "
        f"STALE) {[(r['BKND'], r['PART'], r['STALE']) for r in top_rows.values()]}, no device "
        f"event. After SIGTERM blackbox --json over the five flight directories exited 0 in "
        f"{box_s:.3f} s: {len(box['timeline'])} events, anomalies {box_kinds} (none of "
        f"{list(DEVICE_ANOMALIES)}), partition scope {box['partition_scope']!r}; phase "
        f"{seconds:.1f} s")
    return {"launches": launches, "path_ks": sum(pc_.path_ks.values(), collections.Counter()),
            "seconds": seconds, "split_s": split_s, "split_p99_ms": _p99_ms(during),
            "steady_p99_ms": _p99_ms(steady),
            "replicate_s": replicate_s, "converge_s": converge_s,
            "boot_ready_s": boot_ready_s, "boot_serve_s": boot_serve_s, "load_s": load_s,
            "top_s": top_box["s"], "blackbox_s": box_s}


# --------------------------------------------------- phase 11: multi-process

def multihost_topology() -> tuple[int, str, list, str]:
    """(ranks, backend, each rank's CUDA_VISIBLE_DEVICES, description): one
    NCCL rank per card on a 2-4 card host, else two ranks sharing card 0
    over gloo (NCCL refuses two ranks on one card)."""
    import torch

    count = torch.cuda.device_count()
    if count >= 2:
        world = 4 if count >= 4 else 2
        return world, "nccl", [str(i) for i in range(world)], \
            f"{world} ranks, one per card, over NCCL"
    return 2, "gloo", ["0", "0"], "2 ranks sharing cuda:0 over gloo"


def diff2d_block(dev, seed: int, rows: tuple, cols: tuple, n_keys: int = DIFF2D_KEYS):
    """One rank's block of phase 11's 2-D inputs, made on the card: the
    reference row (a seeded ``torch.Generator``, the same on every rank) of
    keys ``cols[0]:cols[1]``, repeated for replicas ``rows[0]:rows[1]``; in
    each non-reference replica 1% of the keys diverge. Which keys: a draw
    without repeats, Zipf-skewed over the key index (weights 1/(i+1),
    Gumbel top-k), seeded by (seed, replica), so every rank draws the same
    set for a replica; every 8th drawn key loses its presence, the others
    get one digest word changed. Returns (digests, present, expected masks)
    of the block; nothing of the other ranks' rows is made."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    ref = torch.randint(-(2**31), 2**31 - 1, (n_keys, 8), dtype=torch.int32,
                        device=dev, generator=gen)
    (r0, r1), (c0, c1) = rows, cols
    digests = ref[c0:c1].unsqueeze(0).repeat(r1 - r0, 1, 1)
    del ref
    present = torch.ones((r1 - r0, c1 - c0), dtype=torch.bool, device=dev)
    expected = torch.zeros_like(present)
    k = int(n_keys * DIFF2D_DIVERGED)
    log_w = -DIFF2D_ZIPF_S * torch.log1p(torch.arange(n_keys, device=dev, dtype=torch.float64))
    for rep in range(max(r0, 1), r1):
        g = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + rep)
        u = torch.rand(n_keys, device=dev, dtype=torch.float64, generator=g)
        pos = torch.topk(log_w - torch.log(-torch.log(u)), k).indices
        gone = pos[::8]
        pos, gone = (x[(x >= c0) & (x < c1)] - c0 for x in (pos, gone))
        digests[rep - r0, pos, rep % 8] ^= 0x5A5A5A5A
        present[rep - r0, gone] = False
        expected[rep - r0, pos] = True
    return digests, present, expected


def rank_diff2d(seed: int, replicas: int) -> dict:
    """Phase 11's 2-D step in one rank: the ``(replica, key)`` mesh of
    ``replicas`` replica shards over every rank's card, this rank's block
    made on its card and lifted, ``sharded_divergence_2d`` timed between
    barriers, the reference row's ``broadcast`` counted (bytes, time);
    the counts against the injected ones and the mask block against the
    injected block."""
    import torch
    import torch.distributed as dist

    from merklekv_tpu_torch.parallel import multihost
    from merklekv_tpu_torch.parallel.sharded_merkle import sharded_divergence_2d

    mesh = multihost.global_key_mesh(replicas)
    dev = mesh.devices.flat[0]
    rb = DIFF2D_REPLICAS // mesh.global_shape["replica"]
    nb = DIFF2D_KEYS // mesh.global_shape["key"]
    r0, c0 = mesh.origin[0] * rb, mesh.origin[1] * nb
    rows, cols = (r0, r0 + mesh.shape["replica"] * rb), (c0, c0 + mesh.shape["key"] * nb)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    dig, pres, exp = diff2d_block(dev, seed, rows, cols, DIFF2D_KEYS)
    blocks = multihost.lift_local_blocks(mesh, dig, pres)
    del dig, pres
    sync()
    gen_s = time.perf_counter() - t
    moved = []
    real = dist.broadcast

    def counted(tensor, src, group=None, **kw):
        sync()
        t0 = time.perf_counter()
        out = real(tensor, src, group=group, **kw)
        sync()
        moved.append((tensor.numel() * tensor.element_size(), time.perf_counter() - t0))
        return out

    dist.broadcast = counted
    try:
        sync()
        dist.barrier()
        t = time.perf_counter()
        masks, counts = sharded_divergence_2d(mesh, *blocks)
        sync()
        dist.barrier()
        diff_s = time.perf_counter() - t
    finally:
        dist.broadcast = real
    k = int(DIFF2D_KEYS * DIFF2D_DIVERGED)
    out = {"replicas": replicas, "mesh": [mesh.global_shape["replica"], mesh.global_shape["key"]],
           "rows": list(rows), "cols": list(cols),
           "counts_ok": counts.tolist() == [0] + [k] * (DIFF2D_REPLICAS - 1),
           "masks_ok": bool(torch.equal(masks, exp)), "gen_s": gen_s, "diff_ms": diff_s * 1e3,
           "bcast_bytes": sum(b for b, _ in moved), "bcast_ms": sum(x for _, x in moved) * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del blocks, masks, exp, counts
    torch.cuda.empty_cache()
    return out


def rank_main(backend: str, seed: int, n_keys: int) -> int:
    """One rank of phase 11, spawned by :func:`phase_multihost` with the
    ``MKV_*`` topology in its environment: pack this rank's contiguous rows
    of phase 3's keys, regenerate phase 3's replica stacks from the seed and
    keep its rows, lift them onto its card, run the step (launches counted)
    and 5 timed steps, every rank synchronised by a barrier. Prints one JSON
    line."""
    import torch
    import torch.distributed as dist

    from merklekv_tpu_torch.merkle.packing import pack_leaves
    from merklekv_tpu_torch.ops.sha256 import digest_to_bytes
    from merklekv_tpu_torch.ops.cuda_lib import LAUNCHES, reset_launch_counts
    from merklekv_tpu_torch.parallel import multihost, sharded_anti_entropy_step
    from merklekv_tpu_torch.utils.torchenv import words_np

    multihost.initialize(backend=backend)
    rank, world = multihost.process_index(), multihost.process_count()
    mesh = multihost.global_key_mesh()  # this rank's card
    dev = mesh.axis_devices("key")[0]
    t = time.perf_counter()
    lo, hi = rank * n_keys // world, (rank + 1) * n_keys // world
    keys, values = make_kv(hi, lo)
    packed = pack_leaves(keys, values)
    del keys, values
    digests, present, expected = replica_stacks(dev, seed, REBUILD_KEYS, REPLICAS)
    dig, pres, exp = (x[:, lo:hi].contiguous() for x in (digests, present, expected))
    del digests, present, expected
    lifted = multihost.lift_local_shards(mesh, packed.blocks, packed.nblocks, dig, pres)
    del dig, pres
    sync()
    setup_s = time.perf_counter() - t
    reset_launch_counts()
    root, masks, counts = sharded_anti_entropy_step(mesh, *lifted)
    sync()
    launches = dict(LAUNCHES)
    masks_ok = bool(torch.equal(masks, exp))
    del masks
    times = []
    for _ in range(5):
        sync()
        dist.barrier()
        t = time.perf_counter()
        sharded_anti_entropy_step(mesh, *lifted)
        sync()
        dist.barrier()
        times.append(time.perf_counter() - t)
    del lifted
    torch.cuda.empty_cache()
    # The 2-D step in the same ranks: the replica axis across the ranks,
    # then the key axis.
    diff2d = [rank_diff2d(seed, replicas) for replicas in (world, 1)]
    print(json.dumps({
        "rank": rank, "world": world, "rows": [lo, hi], "card": torch.cuda.get_device_name(0),
        "root": digest_to_bytes(words_np(root)).hex(), "counts": counts.tolist(),
        "masks_ok": masks_ok, "launches": launches, "setup_s": setup_s,
        "median_ms": statistics.median(times) * 1e3, "times_ms": [x * 1e3 for x in times],
        "diff2d": diff2d,
    }), flush=True)
    dist.destroy_process_group()
    return 0


def phase_multihost(seed: int, shd: dict, timeout: float = MULTIHOST_TIMEOUT_S) -> dict:
    """11: the anti-entropy step across processes
    (``parallel/multihost.py``) on phase 9a's prefix: each rank packs and
    lifts only its rows; every rank's root and counts == phase 9a's (so ==
    the injected divergence), its mask rows == injected."""
    import os
    import socket
    import tempfile
    from pathlib import Path

    from merklekv_tpu_torch.ops.sha256 import digest_to_bytes
    from merklekv_tpu_torch.utils.torchenv import words_np

    world, backend, visible, where = multihost_topology()
    n_keys = shd["n_keys"]
    want_root = digest_to_bytes(words_np(shd["root"])).hex()
    want_counts = shd["counts"].tolist()
    log(f"[multihost] {where}: {n_keys} keys x {REPLICAS} replicas")
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
    sk.close()
    root_dir = Path(__file__).resolve().parent
    procs, logs = [], []
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mkv-ranks-") as tmp:
        try:
            for rank in range(world):
                env = dict(os.environ, PYTHONPATH=str(root_dir),
                           MKV_COORDINATOR=f"127.0.0.1:{port}", MKV_NUM_PROCESSES=str(world),
                           MKV_PROCESS_ID=str(rank), CUDA_VISIBLE_DEVICES=visible[rank])
                logs.append(os.path.join(tmp, f"rank{rank}.log"))
                with open(logs[-1], "w") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(root_dir / "chip_smoke.py"), "--rank-of", backend,
                         "--seed", str(seed), "--keys", str(n_keys)],
                        cwd=str(root_dir), env=env, stdout=out, stderr=subprocess.STDOUT))
            end = time.monotonic() + timeout
            for rank, p in enumerate(procs):
                try:
                    rc = p.wait(max(1.0, end - time.monotonic()))
                except subprocess.TimeoutExpired:
                    rc = None
                if rc != 0:
                    how = "timed out" if rc is None else f"exited {rc}"
                    with open(logs[rank]) as f:
                        raise AssertionError(f"rank {rank} {how}: {f.read()[-3000:]}")
            outs = []
            for path in logs:
                with open(path) as f:
                    outs.append(json.loads(f.read().strip().splitlines()[-1]))
        finally:
            # A rank that fails leaves the others blocked in the rendezvous
            # or a collective: none outlives the phase.
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(30)
    wall_s = time.perf_counter() - t
    for out in outs:
        if out["root"] != want_root or out["counts"] != want_counts or not out["masks_ok"]:
            raise AssertionError(f"rank {out['rank']}: root {out['root'][:16]}, counts "
                                 f"{out['counts']}, masks_ok {out['masks_ok']} != phase 9a's "
                                 f"{want_root[:16]}, {want_counts}")
        if out["launches"]["leaf"] != 1 or out["launches"]["node_level"] < 1:
            raise AssertionError(f"rank {out['rank']} did not hash on its card: {out['launches']}")
    for i, step in enumerate(outs[0]["diff2d"]):
        runs = [o["diff2d"][i] for o in outs]
        bad = [o["rank"] for o, d in zip(outs, runs) if not (d["counts_ok"] and d["masks_ok"])]
        if bad:
            raise AssertionError(f"2-D diff over a {step['mesh']} mesh: ranks {bad} differ from "
                                 f"the injected counts or masks: {runs}")
        log(f"[multihost] 2-D diff, config 5 at {DIFF2D_REPLICAS} replicas x {DIFF2D_KEYS} keys "
            f"({DIFF2D_DIVERGED:.0%} Zipf-skewed divergence per replica), {where}, (replica, key) "
            f"mesh {step['mesh'][0]} x {step['mesh'][1]}: every rank's counts == injected and its "
            f"mask block == injected; per rank (rows, keys, make s, diff ms, reference-row "
            f"broadcast bytes / ms, peak GB): "
            + "; ".join(f"{d['rows']} {d['cols']} {d['gen_s']:.3f} {d['diff_ms']:.3f} "
                        f"{d['bcast_bytes']} / {d['bcast_ms']:.3f} {d['peak_gb']:.2f}"
                        for d in runs)
            + f"; cuts: {DIFF2D_CUTS}")
    launches = {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}
    med = outs[0]["median_ms"]
    setups = ", ".join(f"{o['setup_s']:.2f}" for o in outs)
    log(f"[multihost] every rank's root and counts {want_counts} == phase 9a's, mask rows == "
        f"injected; setup per rank {setups} s; step "
        f"median of 5 (barrier-synchronised) {med:.3f} ms vs the single-process sharded step "
        f"{shd['step_pd_ms']:.3f} ms (per-device form) and single device "
        f"{shd['single_ms']:.3f} ms; phase {wall_s:.1f} s; launches {launches}")
    return {"launches": launches, "step_ms": med, "where": where, "seconds": wall_s,
            "diff2d_ms": [max(o["diff2d"][i]["diff_ms"] for o in outs)
                          for i in range(len(outs[0]["diff2d"]))]}


def sha256_sass() -> dict:
    """The SASS of the library's SHA-256 kernels (``tools/sha256_pipes.py``):
    per kernel the counts of SHF, LOP3, IADD3, IMAD (every form) and LDG,
    its spills and its registers, which say what pipe its adds issue to."""
    import importlib.util
    from pathlib import Path

    from merklekv_tpu_torch.ops.cuda_lib import BUILD_DIR, build_kernels

    path = Path(__file__).resolve().parent / "tools" / "sha256_pipes.py"
    spec = importlib.util.spec_from_file_location("sha256_pipes", path)
    pipes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pipes)
    k = build_kernels()
    return pipes.kernel_code(k.path, k.build_log, BUILD_DIR / "sass")


def sass_text(st: dict) -> str:
    return (", ".join(f"{c} {st.get(c)}" for c in ("SHF", "LOP3", "IADD3", "IMAD", "LDG", "STL"))
            + f", {st.get('registers')} registers")


def path_work(pos: np.ndarray, depth: int) -> dict:
    """What the path-rehash kernel must do for these sorted positions on a
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
    from merklekv_tpu_torch.ops import merkle_paths as mp
    from merklekv_tpu_torch.ops import sha256 as plain
    from merklekv_tpu_torch.ops.diff_cuda import divergence_cuda, divergence_plain
    from merklekv_tpu_torch.ops.dispatch import build_levels
    from merklekv_tpu_torch.ops.sha256_cuda import (
        leaf_digests_cuda,
        node_level_cuda,
        node_pairs_cuda,
    )

    n, nblk = blocks.shape[0], blocks.shape[1]
    digests, present, _ = replica_stacks(dev, int(rng.integers(1 << 30)), n, REPLICAS)
    leaves = leaf_digests_cuda(blocks, nblocks)
    pairs_l, pairs_r = rand_words(rng, (BATCH, 8), dev), rand_words(rng, (BATCH, 8), dev)
    n_blocks_hashed = int(nblocks.clamp(0, nblk).sum().item())
    p_level = n // 2

    # The serving path's shapes: a batch of 4096 one-block leaves at random
    # positions of the 2^20-leaf tree, and the chain over 1M live keys.
    depth = (TREE_KEYS - 1).bit_length()
    tree = build_levels(rand_words(rng, (1 << depth, 8), dev))
    tree_plain = [lv.clone() for lv in tree]
    scratch = mp.path_scratch(1 << depth, dev)
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
         3 * BATCH * 32, BATCH * LOGIC_NODE, BATCH * ADDS_NODE, (1, 0),
         f"[{BATCH}, 8] x 2", 200),
        ("path_rehash", "merkle_paths.cu", "merklekv_tpu/ops/sha256_pallas.py:250",
         "path_rehash_kernel",
         lambda: mp.path_rehash_cuda(tree, scratch, pblocks, pnblocks, pos),
         lambda: mp.path_rehash(tree_plain, pblocks, pnblocks, pos),
         BATCH * (64 + 4 + 4 + 32) + 32 * (work["distinct"] + work["untouched"]),
         work["distinct"] * LOGIC_NODE + BATCH * LOGIC_MSG_BLOCK,
         work["distinct"] * ADDS_NODE + BATCH * ADDS_MSG_BLOCK,
         (depth, 1),
         f"k={BATCH} of 2^{depth}, {work['distinct']} distinct nodes", 200),
        ("promotion_chain", "merkle_paths.cu", "merklekv_tpu/ops/sha256_pallas.py:250",
         "promotion_chain_kernel",
         lambda: mp.promotion_chain_cuda(tree, TREE_KEYS),
         lambda: mp.promotion_chain(tree, TREE_KEYS),
         (1 + even) * 32 + nlev * 32, even * LOGIC_NODE, even * ADDS_NODE,
         (even, 0),
         f"n={TREE_KEYS} on 2^{depth}, {even} node hashes", 200),
        ("diff", "diff_kernels.cu", "merklekv_tpu/merkle/diff.py:98 (XLA's fusion)",
         "diff_kernel",
         lambda: divergence_cuda(digests, present), lambda: divergence_plain(digests, present),
         REPLICAS * n * (32 + 1 + 1) + 4 * REPLICAS, 0, 0, None,
         f"[{REPLICAS}, {n}, 8]", 10),
        # The same kernel in the co-resident grid the anti-entropy step runs
        # beside the leaf hash, here alone on the card.
        ("diff_beside", "diff_kernels.cu", "merklekv_tpu/merkle/diff.py:98 (XLA's fusion)",
         "diff_kernel",
         lambda: divergence_beside(digests, present), lambda: divergence_plain(digests, present),
         REPLICAS * n * (32 + 1 + 1) + 4 * REPLICAS, 0, 0, None,
         f"[{REPLICAS}, {n}, 8], one 128-thread block an SM", 10),
    ]
    # Device times first, each in its own profiler session; then the serial
    # floors: the root's path is a leaf of the batch's one block and `depth`
    # node hashes, the chain `even` node hashes, and each pair of the pairs
    # kernel one node hash, each at the fastest node hash's pace.
    measured = [profiled_kernel_ms(row[4], row[3], row[-1]) for row in rows]
    floors = {}
    for row in rows:
        if row[9] is not None:
            d, leaf_blocks = row[9]
            f = floors[row[0]] = serial_floor(dev, rng, d, leaf_blocks)
            log(f"[times] serial floor of {row[0]}: a leaf of {leaf_blocks} block(s) and {d} "
                f"dependent node hashes by one warp in registers (hash_chain_kernel, median of "
                f"{CHAIN_RUNS}): {f['ms']:.4f} ms, {f['ns_per_hash']:.1f} ns and "
                f"{f['cycles_per_hash']:.0f} SM cycles per node hash (the leaf included), "
                f"{f['ghz']:.3f} GHz from its own timers; nvidia-smi clocks.sm "
                f"{f['clocks_sm_mhz']} MHz")
    sweep = node_pairs_sweep(dev, rng, floors["node_pairs"]["ms"])
    code = sha256_sass()
    out = []
    for row, (ms, seen) in zip(rows, measured):
        name, src, repl, kname, kern, ref, nbytes, logic, adds, floor, shape, reps = row
        floor = None if floor is None else floors[name]["ms"]
        call_ms = event_ms(kern, reps)
        plain_ms = event_ms(ref, 2, warmup=1)
        b_ms, by = bound_ms(nbytes, logic, adds), bound_by(nbytes, logic, adds)
        floor_txt = "" if floor is None else (
            f", measured serial floor {floor:.4f} ms ({ms / floor:.2f}x)")
        st = code.get(kname)
        sass_txt = f"; SASS {sass_text(st)}" if st else ""
        log(f"[times] {name} at {shape}: device {ms:.4f} ms per launch ({seen} of {reps} "
            f"launches profiled; back-to-back calls "
            f"{call_ms:.4f} ms; plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {by}: {nbytes} B, "
            f"{logic} shift/logic + {adds} add ops{floor_txt}{sass_txt})")
        out.append({
            "name": name, "route": "cuda", "source": f"merklekv_tpu_torch/csrc/{src}",
            "replaces": repl, "launches": launches[LAUNCH_KEY.get(name, name)],
            "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "serial_floor_ms": floor, "sass": st,
        })
        if name == "node_pairs":
            out[-1]["sweep"] = [{k: r[k] for k in ("p", "ms", "bound_ms")} for r in sweep]
    # The level kernel reads rows (2i, 2i+1) as one contiguous message; the
    # alternative is an even/odd split of the level plus the pairs kernel.
    split_ms = event_ms(
        lambda: node_pairs_cuda(leaves[0 : 2 * p_level : 2].contiguous(),
                                leaves[1 : 2 * p_level : 2].contiguous()), 10)
    log(f"[times] even/odd split + node_pairs at [{n}, 8]: {split_ms:.4f} ms "
        f"(node_level {out[1]['ms']:.4f} ms)")
    return out


def ragged_kernel_row(dev, rng: np.random.Generator, errs: dict, launches: dict) -> dict:
    """The kernels line's ``leaf_ragged`` row, measured after every other
    profiler session of the script: its plain version makes millions of
    small launches (about 50 s a call), and after three of them the later
    sessions (``device_profile``, phase 13 a) kept too few kernel records
    (torch 2.11, one H100 run). So the plain version runs once, as the
    check, and its wall time is the row's plain ms."""
    from merklekv_tpu_torch.ops import sha256 as plain
    from merklekv_tpu_torch.ops.sha256_cuda import leaf_ragged_cuda

    etc = etc_ragged_set(dev, rng)
    got = leaf_ragged_cuda(etc.blocks, etc.offsets, etc.order, etc.chained)
    sync()
    t = time.perf_counter()
    want = plain.sha256_ragged(etc.blocks, etc.offsets)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t)
    err = u32_max_abs_err(got, want)
    errs["leaf_ragged"] = max(errs["leaf_ragged"], err)
    if err:
        raise AssertionError(f"ragged leaf hash differs from its plain version on the ETC set: {err}")
    del got, want

    def kern():
        return leaf_ragged_cuda(etc.blocks, etc.offsets, etc.order, etc.chained)

    ms, seen = profiled_launch_ms(kern, ("chain_kernel", "bulk_kernel"), 10)
    call_ms = event_ms(kern, 10)
    t_blocks = etc.total_blocks
    nbytes = t_blocks * 64 + (etc.n + 1) * 8 + etc.n * 32
    logic, adds = t_blocks * LOGIC_MSG_BLOCK, t_blocks * ADDS_MSG_BLOCK
    b_ms, by = bound_ms(nbytes, logic, adds), bound_by(nbytes, logic, adds)
    code = sha256_sass()
    sass = {k: code.get(k) for k in ("chain_kernel", "bulk_kernel")}
    log(f"[times] leaf_ragged at {etc.n} ETC leaves, {t_blocks} blocks, longest {etc.longest}, "
        f"{etc.chained} chained, lane fill {100 * t_blocks / etc.lane_slots:.4f}%: == plain bit "
        f"for bit; device {ms:.4f} ms per launch, first kernel's start to last one's end ({seen} "
        f"of 10 launches profiled; back-to-back calls {call_ms:.4f} ms; plain {plain_ms:.3f} ms; "
        f"bound {b_ms:.4f} ms by {by}: {nbytes} B, {logic} shift/logic + {adds} add ops; SASS "
        + "; ".join(f"{k} {sass_text(st)}" for k, st in sass.items() if st) + ")")
    return {
        "name": "leaf_ragged", "route": "cuda", "source": "merklekv_tpu_torch/csrc/ragged_leaves.cu",
        "replaces": "none: the JAX package pads every leaf to the longest",
        "launches": launches["leaf_ragged"], "max_abs_err": errs["leaf_ragged"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None, "serial_floor_ms": None, "sass": sass,
    }


def node_pairs_sweep(dev, rng: np.random.Generator, floor_ms: float) -> list:
    """The pairs kernel's device time per launch (torch.profiler) at each P
    of PAIRS_SWEEP (None: 4 x 32 x SMs, the widest launch that keeps one warp
    per SM sub-partition), beside its bound: the larger of the throughput
    bound and ``floor_ms``, one node hash by one warp (``serial_floor``)."""
    import torch

    from merklekv_tpu_torch.ops.sha256_cuda import node_pairs_cuda

    full = 4 * 32 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for p in PAIRS_SWEEP:
        p = full if p is None else p
        left, right = rand_words(rng, (p, 8), dev), rand_words(rng, (p, 8), dev)
        reps = 200 if p <= 65536 else 20
        ms, seen = profiled_again(lambda: node_pairs_cuda(left, right), "node_pairs_kernel", reps)
        b_ms = max(bound_ms(3 * p * 32, p * LOGIC_NODE, p * ADDS_NODE), floor_ms)
        out.append({"p": p, "ms": ms, "bound_ms": b_ms, "share": b_ms / ms, "profiled": seen,
                    "reps": reps})
    log(f"[times] node_pairs sweep, device ms per launch (torch.profiler), bound = max(operations "
        f"or bytes, serial floor {floor_ms:.4f} ms), share = bound / ms: " + "; ".join(
            f"P={r['p']} {r['ms']:.4f} ms ({r['profiled']} of {r['reps']}), bound "
            f"{r['bound_ms']:.4f}, {100 * r['share']:.1f}%" for r in out))
    return out


def device_profile(label: str, fn, reps: int) -> dict:
    """One line: device time per call of ``fn``, the profiled wall time, the
    busy share, the device operations per call (kernels and copies), and
    the largest of them (torch.profiler). The program's device spans
    (``ae.*`` ranges over the kernels they cover) are not operations and
    are left out."""
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
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
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


def run_phase(path_ks: dict, name: str, fn, *args):
    """``fn(*args)``, and the batch sizes of the path-rehash launches it made
    in this process into ``path_ks[name]`` (a Counter of k)."""
    from merklekv_tpu_torch.ops.merkle_paths import PATH_KS

    before = collections.Counter(PATH_KS)
    out = fn(*args)
    path_ks[name] = collections.Counter(PATH_KS) - before
    return out


def log_path_ks(path_ks: dict) -> None:
    """Per phase: the path-rehash launches, the largest k, and the launches
    by the least power of two >= k."""
    parts = []
    for name, ks in path_ks.items():
        if ks:
            hist = collections.Counter()
            for k, n in ks.items():
                hist[1 << (k - 1).bit_length()] += n
            parts.append(f"{name} {sum(ks.values())} launches, largest k {max(ks)}, "
                         f"by k <= {dict(sorted(hist.items()))}")
    log("[path k] batch sizes of the path-rehash launches per phase: " + "; ".join(parts))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank-of", choices=["gloo", "nccl"],
                    help="run as one rank of phase 11 (spawned by the script itself)")
    ap.add_argument("--keys", type=int, help="phase 11's key count (with --rank-of)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 2
    import merklekv_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.rank_of:
        return rank_main(args.rank_of, args.seed, args.keys)
    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    log(f"[device] {kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} visible; nvidia-smi: {card}")
    rng = np.random.default_rng(args.seed)

    phase_build()
    errs = phase_kernels(dev, rng)["max_abs_err"]
    errs.update(phase_paths(dev, rng)["max_abs_err"])
    ks: dict = {}
    reb = run_phase(ks, "rebuild", phase_rebuild, dev, args.seed)
    shd = run_phase(ks, "sharded", phase_sharded, dev, args.seed, reb, errs)
    for key in ("digests", "present", "expected"):
        del reb[key]
    torch.cuda.empty_cache()
    mh = phase_multihost(args.seed, shd)
    srv = run_phase(ks, "serving", phase_serving, dev, args.seed)
    mir = run_phase(ks, "mirror", phase_mirror, dev, args.seed)
    drill = run_phase(ks, "drill", phase_fault_drill, dev, args.seed)
    sfc = run_phase(ks, "surface", phase_surface, dev, args.seed)
    entry = phase_node_entry(args.seed)
    node = run_phase(ks, "node", phase_node_sync, args.seed)
    dur = run_phase(ks, "durable", phase_durable, args.seed)
    part = phase_partitions(args.seed)
    ks["partitions"] = part["path_ks"]
    phases = {"rebuild": reb, "serving": srv, "mirror": mir, "drill": drill, "surface": sfc,
              "node": node, "sharded": shd, "durable": dur, "multihost": mh,
              "partitions": part}
    launches = {k: sum(ph["launches"][k] for ph in phases.values()) for k in srv["launches"]}
    if min(launches[name] for name in MAIN_PATH_KERNELS) < 1:
        raise AssertionError(f"a kernel was never launched on the main path: {launches}")
    log("[launches] " + "; ".join(f"{name} {ph['launches']}" for name, ph in phases.items()))
    log_path_ks(ks)
    kernels = phase_kernel_times(dev, rng, reb["blocks"], reb["nblocks"], errs, launches)
    device_profile("rebuild+diff 10M x 8", reb.pop("forward"), 3)
    batch = srv.pop("batch")
    prof = device_profile("serving batch of 4096 + root read", batch, 5)
    sfc_prof = phase_profile(dev, args.seed, sfc["root"])
    del reb["blocks"], reb["nblocks"], batch
    torch.cuda.empty_cache()
    kernels.append(ragged_kernel_row(dev, rng, errs, launches))
    for k in kernels:
        key = LAUNCH_KEY.get(k["name"], k["name"])
        k["launches_node"] = node["launches"][key]
        k["launches_sharded"] = shd["launches"][key]
        k["launches_durable"] = dur["launches"][key]
        k["launches_multihost"] = mh["launches"][key]
        k["launches_partitions"] = part["launches"][key]
    log(f"[summary] rebuild+diff 10M x 8: {reb['median_s'] * 1e3:.3f} ms, "
        f"{reb['keys_per_s']:.0f} keys/s; serving 1M: {srv['writes_per_s']:.0f} writes/s "
        f"(guarded), {prof['device_ms']:.4f} ms device and {prof['kernels']:.1f} kernel "
        f"launches + {prof['copies']:.1f} copies per batch of {BATCH} + root read; mirror 1M: "
        f"warm {mir['warm_s']:.3f} s, {mir['writes_per_s']:.0f} writes/s, "
        f"{mir['pump_batches']} pump batches, largest pump lag {mir['max_lag_ms']:.3f} ms, "
        f"{len(mir['staleness_lag_ms'])} tree_staleness events; surface: trace "
        f"{sfc_prof['traced']}, profiled {sfc_prof['seconds']:.3f} s, ladder rungs "
        f"{[d['rung'] for d in sfc['ladder']]}, ladder phase {sfc['seconds']:.1f} s; "
        f"drill: re-warms {', '.join(f'{ms:.1f}' for ms in drill['rewarm_ms'])} ms, longest query gap "
        f"{drill['max_gap_ms']:.1f} ms, longest query under hang {drill['hang_call_ms']:.1f} ms; "
        f"node 1M: load over TCP {entry['load_s']:.3f} s, warm {entry['warm_s']:.3f} s (in-process "
        f"{node['warm_s']:.3f} s), {node['writes_per_s']:.0f} writes/s with a forced HASH per "
        f"batch, largest pump lag {node['max_lag_ms']:g} ms, bisect SYNC {node['sync_s']:.3f} s, "
        f"3-node sync_multi {node['multi_s']:.3f} s; sharded ({shd['where']}): step "
        f"{shd['step_ms']:.3f} ms, per-device form {shd['step_pd_ms']:.3f} ms, vs single device "
        f"{shd['single_ms']:.3f} ms, serving {shd['writes_per_s']:.0f} writes/s, phase "
        f"{shd['seconds']:.1f} s; multihost ({mh['where']}): step {mh['step_ms']:.3f} ms, 2-D "
        f"diff {DIFF2D_REPLICAS} x {DIFF2D_KEYS} (replica axis across ranks, key axis across "
        f"ranks) {', '.join(f'{x:.3f}' for x in mh['diff2d_ms'])} ms, phase "
        f"{mh['seconds']:.1f} s; durable 1M: ready {dur['ready_s']:.3f} s, load "
        f"{dur['load_s']:.3f} s, SIGTERM + shutdown snapshot {dur['sigterm_s']:.3f} s, forced "
        f"snapshot {dur['snap_s']:.3f} s (root {dur['root_s']:.3f} s), snapshot "
        f"{dur['snap_bytes']} bytes, walcheck {dur['walcheck_s']:.3f} s, recovery restart "
        f"{dur['restart_s']:.3f} s, WAL-replay restart {dur['replay_s']:.3f} s; partitions 1M: "
        f"load {part['load_s']:.3f} s, live split {part['split_s']:.3f} s (batch p99 "
        f"{part['split_p99_ms']:.3f} ms vs {part['steady_p99_ms']:.3f} ms steady), bootstrap "
        f"ready {part['boot_ready_s']:.3f} s, serving {part['boot_serve_s']:.3f} s, top "
        f"{part['top_s']:.3f} s, blackbox {part['blackbox_s']:.3f} s, phase "
        f"{part['seconds']:.1f} s; script {time.perf_counter() - t_script:.1f} s; card {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
