"""Open loop of replicated write frames into the serving mirror.

The deployment: a ``native_bindings.NativeEngine`` holding the records and
a ``cluster.mirror.DeviceTreeMirror`` over it on one device, the tree
behind ``HASH`` and ``TREELEVEL``. A frame of ``frame_events`` value updates
(YCSB workload A's write half: keys zipfian over the live keys, scrambled
over the keyspace by a seeded permutation) is applied to the engine in one
batch, then handed to ``DeviceTreeMirror.on_events(events, watermark)`` as
the node's drain thread does, with the engine version after the frame as
its watermark. Frames are due on a fixed schedule (``rate_writes_per_s``,
exponential gaps: the same gaps for every seed, in the seed's order); a
frame is timed from its due time to the first poll at which
``published_version()`` covers its watermark, and the window's number is
the 95th percentile of those times over all its frames (``fresh_p95_ms``).
A poller thread reads it
every ``poll_s`` seconds and, at ``stamp_samples`` times drawn from the
seed, reads a stamped root and two stamped ``TREELEVEL`` slices; after the
window has closed and every frame is covered, once more at every level.
The check holds each stamped answer to the plain reference tree over the
records as they stood at its stamp.
"""

from __future__ import annotations

import bisect
import gc
import threading
import time

import numpy as np
import torch

from portbench import data
from portbench.reference import sha256 as ref_sha
from portbench.reference import tree as ref_tree
from portbench.reference.encode import pack_records

ZERO_OP_ID = bytes(16)
SRC = "portbench"
# Rows of leaves packed and hashed per reference call.
REF_ROWS = 1 << 20


class Cell:
    CONTROLS = ("padded_root",)

    def __init__(self, ctx) -> None:
        cfg, mix = ctx.config, ctx.mix
        self.ctx = ctx
        self.dev = ctx.devices[0]
        self.n = int(cfg["keys"])
        self.key_len = int(cfg["key_bytes"])
        self.value_len = int(cfg["value_bytes"])
        self.events = int(mix["frame_events"])
        self.poll_s = float(mix["poll_s"])
        self.limit_ms = float(cfg["max_staleness_ms"])
        self.control = None
        self.facts: dict = {}
        self.probes: dict = {}

    def use_control(self, name: str) -> None:
        if name not in self.CONTROLS:
            raise ValueError(f"no control {name!r}; have {self.CONTROLS}")
        self.control = name

    # ---------------------------------------------------------------- data
    def records(self) -> tuple:
        """([N, KL], [N, VL] uint8 on the device, [P] uint8 value pool):
        the records and the bytes new values are cut from."""
        gen = data.generator(self.dev, self.ctx.seed, 11)
        keys = data.key_bytes(data.key_numbers(gen, self.n, self.dev))
        vals = data.values(gen, self.n, self.value_len, self.dev)
        pool = data.values(gen, 1, int(self.ctx.mix["value_pool_bytes"]), self.dev)[0]
        return keys, vals, pool

    def schedule(self) -> None:
        """Due times (seconds from the window's open; warm-up frames before
        0), the key row and value offset of every write."""
        mix = self.ctx.mix
        self.rate = float(mix["rate_writes_per_s"])
        rng = np.random.default_rng([self.ctx.seed, 12])
        per_s = self.rate / self.events
        self.warm_frames = max(1, int(round(float(mix["warmup_s"]) * per_s)))
        self.win_frames = max(1, int(round(self.ctx.seconds * per_s)))
        warm = np.cumsum(data.exponential_gaps(rng, self.warm_frames, float(mix["warmup_s"])))
        warm = warm - warm[-1] - 1.0 / per_s
        gaps = data.exponential_gaps(rng, self.win_frames, self.ctx.seconds)
        win = np.concatenate(([0.0], np.cumsum(gaps)[:-1]))
        self.due = np.concatenate((warm, win))
        frames = self.warm_frames + self.win_frames
        scramble = rng.permutation(self.n)
        ranks = data.zipf_ranks(rng, self.n, float(mix["zipf_theta"]), frames * self.events)
        self.op_rows = scramble[ranks].reshape(frames, self.events)
        pool = int(mix["value_pool_bytes"])
        self.op_offs = rng.integers(0, pool - self.value_len, size=(frames, self.events))
        self.samples = np.sort(rng.uniform(0.05, 0.95, int(mix["stamp_samples"]))) * self.ctx.seconds
        self.slice_rng = np.random.default_rng([self.ctx.seed, 13])

    # ------------------------------------------------------------- program
    def setup(self) -> None:
        self.load()
        self.prime()

    def load(self) -> None:
        """The engine filled with the records, and the mirror warm over it."""
        from merklekv_tpu_torch.cluster.change_event import ChangeEvent, OpKind
        from merklekv_tpu_torch.native_bindings import NativeEngine

        self._event = lambda key, val, ts: ChangeEvent(OpKind.SET, key, val, ts, SRC, ZERO_OP_ID)
        keys, vals, pool = self.records()
        keys_np, vals_np = keys.cpu().numpy(), vals.cpu().numpy()
        self.pool = pool.cpu().numpy().tobytes()
        self.pool_view = memoryview(self.pool)
        del keys, vals, pool
        kl, vl = self.key_len, self.value_len
        # Keys as one fixed-width array, not a million Python objects that
        # the collector would walk during the window.
        self.key_b = keys_np.view(f"S{kl}").reshape(-1)
        self.engine = NativeEngine(str(self.ctx.config["engine"]))
        vb = vals_np.tobytes()
        del vals_np
        step = 1 << 16
        for lo in range(0, self.n, step):
            hi = min(self.n, lo + step)
            self.engine.apply_batch([(bytes(self.key_b[i]), vb[i * vl:(i + 1) * vl], 1)
                                     for i in range(lo, hi)])
        del vb
        self.versions = [self.engine.version()]  # the watermark of each state, in order
        self.mirror = self._mirror()
        self.mirror.start_warming()
        t = time.perf_counter()
        while not self.mirror.ready():
            if time.perf_counter() - t > 600:
                raise RuntimeError("the mirror did not warm within 600 s")
            time.sleep(0.01)
        self.ctx.log(f"[setup] mirror warm in {time.perf_counter() - t:.3f} s")
        self.ts = 2

    def prime(self) -> None:
        """The schedule of the seed and rate, and its warm-up frames."""
        self.schedule()
        self.versions = [self.engine.version()]
        frames = self.warm_frames + self.win_frames
        self.start = np.full(frames, np.nan)
        self.covered = np.full(frames, np.nan)
        self.stamps: list = []
        # Warm-up frames: the same loop, before the window, not measured.
        t0 = time.perf_counter() - self.due[0] + 0.01
        self._drive(t0, range(self.warm_frames), None)
        self._wait_covered(self.warm_frames, 60.0)

    def _mirror(self):
        cfg = self.ctx.config
        if self.control == "padded_root":
            from portbench.reference.plain_mirror import PlainMirror

            return PlainMirror(self)
        from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror

        return DeviceTreeMirror(self.engine, max_staleness_ms=self.limit_ms,
                                sharding=str(cfg["sharding"]),
                                dispatch_deadline_ms=cfg.get("dispatch_deadline_ms"),
                                device=self.dev)

    def _apply(self, f: int) -> None:
        """Frame ``f``: one engine batch, then one mirror staging call."""
        rows, offs = self.op_rows[f], self.op_offs[f]
        vl, pool, ts = self.value_len, self.pool_view, self.ts
        vals = [pool[o:o + vl] for o in offs.tolist()]  # views: no copies
        keys = self.key_b[rows].tolist()
        self.engine.apply_batch([(k, v, ts + j) for j, (k, v) in enumerate(zip(keys, vals))])
        wm = self.engine.version()
        evs = [self._event(k.decode(), v, ts + j) for j, (k, v) in enumerate(zip(keys, vals))]
        self.ts += len(evs)
        self.versions.append(wm)
        self.mirror.on_events(evs, watermark=wm)

    def _drive(self, t0: float, frames, tracer) -> None:
        for f in frames:
            due = t0 + self.due[f]
            with torch.profiler.record_function("portbench.wait"):
                while True:
                    now = time.perf_counter()
                    if tracer is not None:
                        tracer.tick(now)
                    if now >= due:
                        break
                    time.sleep(min(0.001, due - now))
            self.start[f] = now
            with torch.profiler.record_function("portbench.frame"):
                self._apply(f)

    # -------------------------------------------------------------- window
    def _poll(self, t0: float, stop: threading.Event) -> None:
        """Coverage times of every frame, and the stamped samples."""
        versions, covered = self.versions, self.covered
        nxt = 0
        samples = list(t0 + self.samples)
        while not stop.is_set():
            v = self.mirror.published_version()
            now = time.perf_counter()
            while nxt < len(versions) - 1 and versions[nxt + 1] <= v:
                nxt += 1
                if np.isnan(covered[nxt - 1]):
                    covered[nxt - 1] = now
            if samples and now >= samples[0]:
                samples.pop(0)
                self._sample()
            time.sleep(self.poll_s)

    def _sample(self, every_level: bool = False) -> None:
        """A stamped root and stamped TREELEVEL slices, kept for the check.
        Read again (a few times) until every slice carries the root's
        stamp, so that a sample costs the check one version."""
        from portbench.reference.tree import level_sizes

        sizes = level_sizes(self.n)
        levels = range(len(sizes)) if every_level else \
            self.slice_rng.integers(0, len(sizes), size=2).tolist()
        spans = []
        for level in levels:
            m = sizes[level]
            lo = int(self.slice_rng.integers(0, max(1, m - 8)))
            spans += [(level, lo, lo + 8), (level, max(0, m - 3), m)]
        for _ in range(5):
            got = self.mirror.published_root_stamped()
            if got is None:
                return
            outs = [(level, self.mirror.level_nodes_stamped(level, a, b)) for level, a, b in spans]
            if all(out is None or out[2] == got[1] for _l, out in outs):
                break
        self.stamps.append(("root", got[1], got[0]))
        for level, out in outs:
            if out is not None:
                rows, _n, ver = out
                self.stamps.append(("slice", ver, (level, [(i, d) for i, d in rows])))

    def _wait_covered(self, upto: int, limit_s: float) -> bool:
        want = self.versions[upto]
        t = time.perf_counter()
        while self.mirror.published_version() < want:
            if time.perf_counter() - t > limit_s:
                return False
            time.sleep(self.poll_s)
        return True

    def window(self, tracer) -> dict:
        frames = self.warm_frames + self.win_frames
        from merklekv_tpu_torch.obs.metrics import get_metrics

        snap0 = get_metrics().snapshot()
        gc_log: list = []
        gc_t: dict = {}

        def on_gc(phase, info):
            if phase == "start":
                gc_t[info["generation"]] = time.perf_counter()
            elif info["generation"] in gc_t:
                gc_log.append((info["generation"], time.perf_counter() - gc_t[info["generation"]]))

        gc.callbacks.append(on_gc)
        stop = threading.Event()
        t0 = time.perf_counter() + 0.005
        self.covered[:self.warm_frames] = t0 - 1.0  # covered before the window
        poller = threading.Thread(target=self._poll, args=(t0, stop), name="portbench-poll")
        poller.start()
        try:
            tracer.begin(t0)
            self._drive(t0, range(self.warm_frames, frames), tracer)
            t_close = t0 + self.ctx.seconds
            while time.perf_counter() < t_close:
                tracer.tick(time.perf_counter())
                time.sleep(0.001)
            tracer.close()
            snap1 = get_metrics().snapshot()
            settled = self._wait_covered(frames, float(self.ctx.mix["settle_s"]))
            time.sleep(10 * self.poll_s)
        finally:
            stop.set()
            poller.join(30)
            gc.callbacks.remove(on_gc)
        if settled:
            self._sample(every_level=True)
        w = slice(self.warm_frames, frames)
        due = t0 + self.due[w]
        fresh_ms = (self.covered[w] - due) * 1e3
        late_ms = (self.start[w] - due) * 1e3
        done = ~np.isnan(fresh_ms)
        # A frame never covered counts from its due time to now.
        fresh_ms = np.where(done, fresh_ms, (time.perf_counter() - due) * 1e3)
        over = int(np.sum(~done) + np.sum(fresh_ms[done] > self.limit_ms))
        in_window = int(np.sum(self.covered[w][done] <= t_close))
        ok = np.sort(fresh_ms)
        p95 = float(ok[int(np.ceil(0.95 * len(ok))) - 1])
        self.uncovered = int(np.sum(~done))
        covered_per_s = in_window * self.events / self.ctx.seconds
        quarters = [float(np.mean(q)) for q in np.array_split(fresh_ms, 4)]
        self.facts = {"summary": {
            "offered_writes_per_s": self.win_frames * self.events / self.ctx.seconds,
            "covered_writes_per_s": covered_per_s,
            "fresh_ms": {"p50": float(np.median(ok)), "p95": p95,
                         "p99": float(ok[int(np.ceil(0.99 * len(ok))) - 1]), "max": float(ok[-1])},
            "fresh_ms_by_quarter": quarters, "over_limit": over,
            "gc_ms_by_generation": {g: 1e3 * sum(d for gg, d in gc_log if gg == g) for g in (0, 1, 2)},
            "gc_max_ms": 1e3 * max((d for _g, d in gc_log), default=0.0),
            "late_ms": {"p50": float(np.median(late_ms)), "p99": float(np.percentile(late_ms, 99)),
                        "max": float(np.max(late_ms))}},
            "frames": self.win_frames, "writes": self.win_frames * self.events,
                      "window_s": self.ctx.seconds, "counters0": snap0, "counters1": snap1}
        self.ctx.log(
            f"[window] {self.win_frames} frames of {self.events}; fresh p50 "
            f"{float(np.median(ok)):.4f} p95 {p95:.4f} p99 {float(ok[int(np.ceil(0.99 * len(ok))) - 1]):.4f} "
            f"max {float(ok[-1]):.4f} ms; over {self.limit_ms:g} ms or never: {over}; generator "
            f"late p50 {float(np.median(late_ms)):.4f} p99 {float(np.percentile(late_ms, 99)):.4f} "
            f"max {float(np.max(late_ms)):.4f} ms; {len(self.stamps)} stamped answers; "
            f"{len(gc_log)} collections, longest {self.facts['summary']['gc_max_ms']:.3f} ms")
        return {"t0": t0, "attempted": self.win_frames, "failed": over,
                "metrics": {"fresh_p95_ms": p95}}

    def release(self) -> None:
        self.mirror.close()
        self.mirror = None
        self.engine.close()
        self.engine = None
        self.key_b = self.pool = self.pool_view = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def check(self) -> list:
        """Every stamped answer against the plain reference tree over the
        records as they stood at its stamp."""
        t = time.perf_counter()
        keys, vals, pool = self.records()
        leaves = torch.empty((self.n, 8), dtype=torch.int32, device=self.dev)
        for lo in range(0, self.n, REF_ROWS):
            hi = min(self.n, lo + REF_ROWS)
            blk = pack_records(keys[lo:hi], vals[lo:hi])
            leaves[lo:hi] = ref_sha.hash_blocks(blk, torch.full((hi - lo,), blk.shape[1],
                                                dtype=torch.int32, device=self.dev))
        del vals
        rows = torch.from_numpy(self.op_rows.reshape(-1)).to(self.dev)
        offs = torch.from_numpy(self.op_offs.reshape(-1)).to(self.dev)
        width = torch.arange(self.value_len, device=self.dev)
        op_leaves = torch.empty((rows.shape[0], 8), dtype=torch.int32, device=self.dev)
        for lo in range(0, rows.shape[0], REF_ROWS):
            hi = min(rows.shape[0], lo + REF_ROWS)
            blk = pack_records(keys[rows[lo:hi]], pool[offs[lo:hi, None] + width])
            op_leaves[lo:hi] = ref_sha.hash_blocks(blk, torch.full((hi - lo,), blk.shape[1],
                                                   dtype=torch.int32, device=self.dev))
        del keys, pool
        # A stamp v covers the frames whose watermark is <= v: the state
        # after frame index versions.index(v) - 1 (v must be a watermark).
        bad_stamps = root_bad = slice_bad = 0
        by_state: dict = {}
        for kind, ver, what in self.stamps:
            i = bisect.bisect_left(self.versions, ver)
            if i == len(self.versions) or self.versions[i] != ver:
                bad_stamps += 1
                continue
            by_state.setdefault(i, []).append((kind, what))
        applied = 0
        flat_rows = self.op_rows.reshape(-1)
        for state in sorted(by_state):
            upto = state * self.events  # writes applied in this state
            if upto > applied:
                seg = flat_rows[applied:upto]
                # The last write of each row in the segment wins.
                last = len(seg) - 1 - np.unique(seg[::-1], return_index=True)[1]
                idx = torch.from_numpy(applied + last).to(self.dev)
                leaves[torch.from_numpy(seg[last]).to(self.dev)] = op_leaves[idx]
                applied = upto
            levels = ref_tree.tree_levels(leaves)
            for kind, what in by_state[state]:
                if kind == "root":
                    root_bad += int(what != ref_sha.digest_hex(levels[-1][0]))
                else:
                    level, got = what
                    for i, dig in got:
                        if not (level < len(levels) and 0 <= i < levels[level].shape[0]):
                            slice_bad += 1  # a node the tree does not have
                            continue
                        want = levels[level][i].cpu().numpy().astype(">i4").tobytes()
                        slice_bad += int(dig != want)
        self.ctx.log(f"[check] reference {time.perf_counter() - t:.3f} s over "
                     f"{len(self.stamps)} stamped answers at {len(by_state)} versions")
        return [("root_mismatches", root_bad, 0), ("slice_mismatches", slice_bad, 0),
                ("bad_stamps", bad_stamps, 0), ("uncovered_frames", self.uncovered, 0)]
