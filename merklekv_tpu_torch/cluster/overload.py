"""Overload protection: the node-wide degradation ladder and its monitor.

A copy of ``merklekv_tpu/cluster/overload.py``, its imports pointed at the port's modules.

The north star is heavy traffic; this module is what keeps a node ALIVE
under it. Instead of crashing on resource exhaustion — a connection flood
exhausting threads, a hot keyspace exhausting RAM, a full disk killing the
WAL drain — the node walks a degradation ladder and sheds the cheapest
load first:

    live       everything serves.
    shedding   write verbs answer ``ERROR BUSY <why> retry`` (retryable;
               reads, the management plane, and anti-entropy serving stay
               open), and background work (anti-entropy cycles, snapshot
               compaction) defers.
    read_only  write verbs answer ``ERROR READONLY <why>`` — the node
               preserves what it has instead of accepting writes it
               cannot hold or journal.
    draining   read_only + new connections refused BUSY (shutdown).

The ladder's inputs are **watermark signals**, one per resource:

- *memory*: the engine's O(1) approximate resident bytes against
  ``[server] memory_soft_bytes`` / ``memory_hard_bytes`` (soft -> shed
  writes, hard -> read-only), with hysteresis (``recovery_ratio``) so the
  node doesn't flap at the boundary;
- *disk*: :class:`~merklekv_tpu_torch.storage.store.DurableStore` folds its
  free-bytes watermarks and any live ENOSPC/EIO condition into a level
  (see ``DurableStore.overload_level``);
- *admission*: enforced natively (``max_connections``/``max_pipeline`` in
  the server's accept/read path) — it never enters the ladder because a
  refused connection must cost nothing.

The native server enforces the pushed level on the request path; this
module only decides it. Everything is visible where state already flows:
``/healthz`` (``degradation`` field), METRICS (``node.degradation`` line),
the ``node.degradation`` gauge, STATS (``degradation`` + shed counters),
and ``top`` (STATE / SHED/s columns).

Philosophy (after "Asynchronous Merkle Trees", PAPERS.md): the hot path
may deliberately drop work under pressure because the anti-entropy plane
repairs whatever was shed once the node recovers — shedding is safe
exactly because repair is cheap.
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

from merklekv_tpu_torch.utils.tracing import get_metrics

__all__ = [
    "LIVE",
    "SHEDDING",
    "READ_ONLY",
    "DRAINING",
    "LEVEL_NAMES",
    "REASON_CODES",
    "DegradationLadder",
    "OverloadMonitor",
]

# The ladder's rungs — numeric order IS severity order (the ladder takes
# the max across sources), and the codes match the native enum
# (server.h Degradation) and the METRICS ``node.degradation`` line.
LIVE, SHEDDING, READ_ONLY, DRAINING = 0, 1, 2, 3

LEVEL_NAMES = {
    LIVE: "live",
    SHEDDING: "shedding",
    READ_ONLY: "read_only",
    DRAINING: "draining",
}

# Reason string -> native DegradeReason code (rides in the BUSY/READONLY
# error text so clients can tell transient shed from shutdown).
REASON_CODES = {"": 0, "memory": 1, "disk": 2, "draining": 3, "admin": 4}


class DegradationLadder:
    """Thread-safe fold of per-resource degradation signals.

    Each source (``memory``, ``disk``, ``admin``) contributes a level;
    the node's level is the max. The reason reported is the worst
    contributor's, ties broken by source name for determinism.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._sources: dict[str, tuple[int, str]] = {}

    def set_source(self, name: str, level: int, reason: str = "") -> None:
        with self._mu:
            if level <= LIVE:
                self._sources.pop(name, None)
            else:
                self._sources[name] = (int(level), reason or name)

    def state(self) -> tuple[int, str]:
        """(level, reason) of the worst contributor; (LIVE, "") if none."""
        with self._mu:
            if not self._sources:
                return LIVE, ""
            worst = max(
                self._sources.items(), key=lambda kv: (kv[1][0], kv[0])
            )
            return worst[1][0], worst[1][1]

    def level(self) -> int:
        return self.state()[0]

    def name(self) -> str:
        return LEVEL_NAMES.get(self.level(), "live")


class OverloadMonitor:
    """Polls the watermark signals and pushes the folded level natively.

    One daemon thread, cadence ``[server] watermark_interval_seconds``.
    Each tick: read the engine's approximate resident bytes (O(1)), ask
    the durable store for its disk verdict, fold through the ladder with
    per-source hysteresis, and — only on a transition — push the level to
    the native server (one atomic store) and log it loudly. Between
    transitions a tick costs two atomic reads and a statvfs.
    """

    def __init__(
        self,
        ladder: DegradationLadder,
        engine,  # NativeEngine
        server,  # NativeServer
        server_cfg,  # config.ServerConfig
        storage=None,  # Optional[DurableStore]
        interval: Optional[float] = None,
        partition_id: Optional[int] = None,
    ) -> None:
        self._ladder = ladder
        self._engine = engine
        self._server = server
        self._cfg = server_cfg
        self._storage = storage
        # Partitioned cluster mode: ladder flips additionally record
        # partition_degraded / partition_healed flight events naming THIS
        # node's partition — the blackbox signal that an incident is
        # partition-local (one partition's replicas flip) rather than
        # cluster-wide (every partition flips at once).
        self._partition_id = partition_id
        self._interval = (
            interval
            if interval is not None
            else server_cfg.watermark_interval_seconds
        )
        self._mem_level = LIVE  # hysteresis state for the memory signal
        # Test hook (parallel to the engine's MKV_MAX_TOMBS_PER_SHARD):
        # MKV_MAX_ENGINE_BYTES forces the memory HARD watermark — and,
        # when no soft watermark is configured, a soft one at half — so
        # the chaos suite triggers the memory ladder deterministically
        # with a handful of writes instead of gigabytes.
        import os as _os

        env = _os.environ.get("MKV_MAX_ENGINE_BYTES", "")
        self._hard_override: Optional[int] = None
        if env:
            try:
                self._hard_override = max(1, int(env))
            except ValueError:
                self._hard_override = None
        self._pushed: Optional[tuple[int, str]] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "OverloadMonitor":
        if self._thread is None:
            self.poll_once()  # push the initial level before serving
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="mkv-overload-monitor"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop_evt.wait(max(0.02, self._interval)):
            try:
                self.poll_once()
            except Exception:
                # The monitor must never die silently — a dead monitor
                # would freeze the node at its current rung.
                get_metrics().inc("node.overload_monitor_errors")

    # -- evaluation ---------------------------------------------------------
    def poll_once(self) -> int:
        """One evaluation + push; returns the folded level (tests call
        this directly instead of sleeping out the ticker)."""
        self._ladder.set_source(
            "memory", self._memory_level(), "memory"
        )
        if self._storage is not None:
            lvl, why = self._storage.overload_level()
            self._ladder.set_source("disk", lvl, why or "disk")
        level, reason = self._ladder.state()
        if self._pushed != (level, reason):
            prev = self._pushed[0] if self._pushed else LIVE
            self._server.set_degradation(
                level, REASON_CODES.get(reason, REASON_CODES["admin"])
            )
            self._pushed = (level, reason)
            if level != prev:
                get_metrics().inc("node.degradation_changes")
                # Flight recorder: ladder flips are exactly the "what was
                # the node doing before it died" signal a post-mortem
                # timeline starts from.
                from merklekv_tpu_torch.obs.flightrec import record

                record(
                    "degradation",
                    prev=LEVEL_NAMES.get(prev, prev),
                    new=LEVEL_NAMES.get(level, level),
                    reason=reason,
                )
                if self._partition_id is not None:
                    # Partition-scoped view of the same flip: leaving live
                    # degrades ONE partition's capacity, returning heals
                    # it. Boundary crossings only — rung-to-rung moves
                    # while already degraded stay "degradation" events.
                    if prev == LIVE and level > LIVE:
                        get_metrics().inc("partition.degraded_total")
                        record(
                            "partition_degraded",
                            partition=self._partition_id,
                            level=LEVEL_NAMES.get(level, level),
                            reason=reason,
                        )
                    elif prev > LIVE and level == LIVE:
                        get_metrics().inc("partition.healed_total")
                        record(
                            "partition_healed",
                            partition=self._partition_id,
                        )
                print(
                    f"overload: {LEVEL_NAMES.get(prev, prev)} -> "
                    f"{LEVEL_NAMES.get(level, level)}"
                    + (f" ({reason})" if reason else ""),
                    file=sys.stderr,
                    flush=True,
                )
        return level

    def _memory_level(self) -> int:
        """Memory watermark with hysteresis: enter shedding at soft, enter
        read-only at hard, and only recover once usage falls below
        ``watermark * recovery_ratio`` — a node hovering at the boundary
        must not flap BUSY/OK per request."""
        soft = self._cfg.memory_soft_bytes
        hard = self._cfg.memory_hard_bytes
        if self._hard_override is not None:
            hard = self._hard_override
            if not soft:
                soft = max(1, hard // 2)
        if not soft and not hard:
            self._mem_level = LIVE
            return LIVE
        # getattr: NativeEngine exposes _h (None after close — calling
        # through it would FFI a dead pointer); engine doubles without the
        # attribute are simply read. Any failure holds the current rung
        # (never silently freezes it forever: the next tick retries, and
        # repeated failures surface via node.overload_monitor_errors when
        # they escape to the poll loop).
        if getattr(self._engine, "_h", True) is None:
            usage = 0  # closed engine: nothing resident
        else:
            try:
                usage = self._engine.memory_usage()
            except Exception:
                return self._mem_level  # transient: hold the rung
        r = self._cfg.recovery_ratio
        lvl = self._mem_level
        if hard and usage >= hard:
            lvl = READ_ONLY
        elif lvl == READ_ONLY and (not hard or usage < hard * r):
            lvl = SHEDDING  # step down one rung; re-evaluated below
        if lvl == SHEDDING and (not soft or usage < soft * r):
            lvl = LIVE
        if lvl == LIVE and soft and usage >= soft:
            lvl = SHEDDING
        self._mem_level = lvl
        return lvl

    # -- verdicts for background work ---------------------------------------
    def should_pause_background(self) -> bool:
        """Anti-entropy cycles defer while the node is above ANY watermark:
        a cycle allocates leaf maps a memory-pressured node must not, and
        journals repairs a disk-full node cannot."""
        return self._ladder.level() >= SHEDDING

    def memory_pressure(self) -> bool:
        """Snapshot compaction defers only under MEMORY pressure (a
        snapshot materializes the whole keyspace host-side); under DISK
        pressure compaction is exactly what frees WAL segments, so it must
        keep running."""
        return self._mem_level >= SHEDDING
