"""DurableStore: WAL + snapshots + verified crash recovery for one node.

A copy of ``merklekv_tpu/storage/store.py``, its imports pointed at the
port's modules (``native_bindings``, ``obs.flightrec``, ``utils.tracing``,
``cluster.change_event``). The snapshot root runs on the node's device
(``storage/snapshot.py``): a device failure while a snapshot is written
fails that snapshot (``storage.compaction_errors``; the WAL is left as it
was and the request stays pending), and one while recovery verifies a
snapshot fails the recovery, so the node does not start.

Sits beside the native engine (which stays the in-memory serving hot path)
and records every change the Python control plane can observe:

- local client writes, drained from the native server's change-event queue
  (either by this store's own drain thread, or — while replication is
  enabled — piggybacked on the Replicator's drain via its batch listener,
  so the single native queue has exactly one consumer at a time);
- remote replication applies (the Replicator reports applied events here);
- anti-entropy repairs (ClusterNode's repair hook reports them here).

Durability contract (docs/PERSISTENCE.md): WAL append is asynchronous with
respect to command acknowledgement — the native server acks before the
event is drained — so a SIGKILL loses at most the drain window (~ms) plus
whatever the fsync policy left unflushed. Recovery restores a write-order
contiguous prefix, verified against the snapshot's stamped Merkle root;
anti-entropy repairs the lost tail from peers.

Recovery replays through the engine's LWW verbs (``set_if_newer`` /
``delete_if_newer``): replay is idempotent, records shared between a
snapshot and the WAL tail apply as no-ops, and tombstone ordering
survives a restart.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from merklekv_tpu_torch.storage import snapshot as snapmod
from merklekv_tpu_torch.storage import wal as walmod
from merklekv_tpu_torch.storage.snapshot import (
    RootMismatchError,
    SnapshotCorruptError,
)
from merklekv_tpu_torch.storage.wal import (
    StorageFullError,
    WalRecord,
    WalWriter,
)
from merklekv_tpu_torch.utils.tracing import get_metrics, span

__all__ = [
    "DurableStore",
    "RecoveryError",
    "RecoveryReport",
    "StorageFullError",
    "StorageLockedError",
    "node_data_dir",
]

# Native change-event op codes (native_bindings) observed on the drain path.
from merklekv_tpu_torch.native_bindings import (  # noqa: E402  (grouped for clarity)
    OP_DEL,
    OP_TRUNCATE,
    ChangeEventRaw,
    NativeEngine,
)


class StorageLockedError(RuntimeError):
    """Another live process holds this data directory."""


class RecoveryError(RuntimeError):
    """Recovery refused to proceed (strict verify mode) — the on-disk state
    failed integrity checks and repair was not allowed."""


def node_data_dir(storage_path: str, port: int) -> str:
    """Per-node data directory: ``<storage_path>/node-<port>``.

    Two nodes sharing a cwd (the integration-test shape) get disjoint
    directories as long as they bind different ports; the flock in
    :class:`DurableStore` rejects the remaining collision cases.
    """
    return os.path.join(storage_path, f"node-{port}")


@dataclass
class RecoveryReport:
    directory: str
    snapshot_path: Optional[str] = None
    snapshot_items: int = 0
    snapshot_tombstones: int = 0
    snapshot_root: Optional[str] = None
    snapshots_rejected: list[str] = field(default_factory=list)
    wal_segments: int = 0
    replayed: int = 0  # frames replayed through the LWW verbs
    applied: int = 0  # frames that actually changed engine state
    torn_tail: bool = False
    corruption: Optional[str] = None  # mid-log corruption note (repair mode)
    final_root: Optional[str] = None  # engine root after recovery

    def summary(self) -> str:
        src = (
            os.path.basename(self.snapshot_path)
            if self.snapshot_path
            else "no snapshot"
        )
        extra = ""
        if self.torn_tail:
            extra += " torn-tail-cut"
        if self.snapshots_rejected:
            extra += f" rejected={len(self.snapshots_rejected)}"
        if self.corruption:
            extra += " corruption-stopped-replay"
        return (
            f"{src} ({self.snapshot_items} items) + {self.replayed} WAL "
            f"records from {self.wal_segments} segment(s)"
            f"{extra}; root={(self.final_root or '')[:16]}"
        )


class DurableStore:
    """One node's durable storage subsystem. Lifecycle::

        store = DurableStore(engine, cfg, directory)
        report = store.recover()       # before serving writes
        store.attach_server(server)    # own drain thread over the event queue
        store.start()                  # fsync ticker + compaction trigger
        ...
        store.stop()                   # final drain + fsync (+ snapshot)

    ``cfg`` is a :class:`merklekv_tpu_torch.config.StorageConfig`.
    """

    def __init__(self, engine: NativeEngine, cfg, directory: str) -> None:
        self._engine = engine
        self._cfg = cfg
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock_fd = self._acquire_lock(directory)
        self._writer: Optional[WalWriter] = None
        self._server = None
        self._paused = False
        self._drain_iter_mu = threading.Lock()  # one drain iteration at a time
        self._stop_evt = threading.Event()
        self._drain_thread: Optional[threading.Thread] = None
        self._ticker_thread: Optional[threading.Thread] = None
        self._bytes_since_snapshot = 0
        self._snap_mu = threading.Lock()
        # Snapshot-shipping pins: seq -> last donor access (monotonic).
        # Retention keeps a pinned snapshot alive while a joiner is still
        # fetching chunks from it, so a compaction mid-transfer can't
        # delete the artifact out from under the reader; pins expire after
        # _PIN_TTL_S of silence (a joiner that died mid-fetch must not pin
        # disk forever).
        self._pin_mu = threading.Lock()
        self._pins: dict[int, float] = {}
        # Set when a TRUNCATE was journaled: the WAL interleaves several
        # append paths (event drain, repair hooks, replication applies), so
        # a frame journaled just before the TRUNCATE frame may have been
        # applied to the engine just AFTER the wipe — replay would then
        # wipe a key the live engine kept. A prompt snapshot (engine state
        # is authoritative ordering) collapses that window to the next
        # ticker tick.
        self._snapshot_requested = False
        self.last_recovery: Optional[RecoveryReport] = None
        # Resource-fault state (overload protection). ``_full`` latches
        # when a WAL append/fsync (or a snapshot write) dies with
        # ENOSPC/EIO: the error is swallowed (the drain thread must
        # SURVIVE a full disk), the dropped records are counted, and the
        # overload monitor reads the verdict through overload_level() to
        # flip the node read-only. The ticker probes for recovery — a
        # small write+fsync through the same io seam — and on success
        # requests a re-anchor snapshot: engine state is authoritative,
        # and the fresh snapshot closes the journal gap the full-disk
        # window opened.
        self._full = False
        self._full_reason = ""
        self._disk_level = 0  # watermark hysteresis state (overload.LIVE)
        self.disk_free_bytes: Optional[int] = None
        self._defer_compaction = None  # Callable[[], bool] (memory gate)
        # Probe-recovery backoff: a 4 KiB probe can succeed on a disk that
        # still cannot fit the multi-MB re-anchor snapshot — without
        # backoff the store would flap latch->probe->snapshot-ENOSPC->
        # re-latch every tick, burning megabytes of doomed snapshot I/O
        # per second on an already-sick disk. Re-latching shortly after a
        # recovery doubles the wait before the next probe (2s..60s); a
        # snapshot that actually completes resets it.
        self._probe_backoff_s = 0.0
        self._next_probe_m = 0.0
        self._recovered_at_m = 0.0

    # -- locking --------------------------------------------------------------
    @staticmethod
    def _acquire_lock(directory: str) -> int:
        import fcntl

        path = os.path.join(directory, "LOCK")
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            raise StorageLockedError(
                f"storage directory {directory!r} is locked by a live "
                "process — two nodes must not share one data dir (give "
                "each its own storage_path, or distinct ports so the "
                "per-port subdirectory separates them)"
            ) from None
        os.ftruncate(fd, 0)
        os.write(fd, f"{os.getpid()}\n".encode())
        return fd

    # -- recovery -------------------------------------------------------------
    def recover(self) -> RecoveryReport:
        """Load the newest verifiable snapshot, replay the WAL tail, open
        the WAL for appending. Must run before the node serves writes."""
        cfg = self._cfg
        report = RecoveryReport(directory=self._dir)
        strict = cfg.verify == "strict"
        with span("storage.recovery"):
            snap = self._load_best_snapshot(report, strict)
            start_seq = snap.wal_seq if snap is not None else 0
            segments = [
                (seq, path)
                for seq, path in walmod.list_segments(self._dir)
                if seq >= start_seq
            ]
            report.wal_segments = len(segments)
            last_good_offset: Optional[int] = None
            for i, (seq, path) in enumerate(segments):
                scan = walmod.scan_segment(path)
                self._replay_records(scan.records, report)
                if scan.clean:
                    continue
                is_last = i == len(segments) - 1
                if scan.torn and is_last:
                    # The normal crash signature: a partial final append.
                    # Cut it on reopen so future appends extend a clean log.
                    report.torn_tail = True
                    last_good_offset = scan.good_offset
                    get_metrics().inc("storage.recovery_torn_tail")
                    continue
                # Interior corruption (or a non-final torn segment — same
                # thing for replay): everything past it is unverifiable.
                get_metrics().inc("storage.recovery_wal_corruption")
                msg = f"{os.path.basename(path)}: {scan.error}"
                if strict:
                    raise RecoveryError(
                        f"WAL corruption, refusing to recover ({msg}); run "
                        f"`python -m merklekv_tpu_torch walcheck {self._dir}`"
                    )
                report.corruption = msg
                # Re-anchor durability promptly: without a fresh snapshot,
                # every FUTURE recovery would replay up to this same bad
                # segment and skip everything after it — including all
                # post-recovery writes — until the byte-trigger compaction
                # finally fires.
                self._snapshot_requested = True
                break
            # Open the writer on the newest segment (clean tail cut if torn).
            if segments and report.corruption is None:
                open_seq = segments[-1][0]
            elif segments:
                # Replay stopped early; never append after bad bytes —
                # start a fresh segment beyond everything on disk.
                open_seq = walmod.list_segments(self._dir)[-1][0] + 1
                last_good_offset = None
            else:
                open_seq = start_seq
            self._writer = WalWriter(
                self._dir,
                open_seq,
                fsync_policy=cfg.fsync,
                segment_bytes=cfg.segment_bytes,
                start_offset=last_good_offset,
            )
            root = self._engine.merkle_root()
            report.final_root = (
                root.hex() if root is not None else snapmod.EMPTY_ROOT_HEX
            )
        get_metrics().inc("storage.recoveries")
        self.last_recovery = report
        return report

    def _load_best_snapshot(self, report, strict):
        cfg = self._cfg
        for seq, path in reversed(snapmod.list_snapshots(self._dir)):
            try:
                snap = snapmod.read_snapshot(path)
                snapmod.verify_snapshot(
                    snap,
                    engine=cfg.merkle_engine,
                    device_min_keys=cfg.device_min_keys,
                )
            except (SnapshotCorruptError, RootMismatchError) as e:
                get_metrics().inc("storage.recovery_root_mismatch")
                if strict:
                    raise RecoveryError(
                        f"snapshot failed verification, refusing to recover "
                        f"({e}); run `python -m merklekv_tpu_torch walcheck "
                        f"{self._dir}` or set [storage] verify = \"repair\""
                    ) from e
                report.snapshots_rejected.append(
                    f"{os.path.basename(path)}: {e}"
                )
                continue
            for k, v, ts in snap.items:
                self._engine.set_if_newer(k, v, ts)
            for k, ts in snap.tombstones:
                self._engine.delete_if_newer(k, ts)
            report.snapshot_path = path
            report.snapshot_items = len(snap.items)
            report.snapshot_tombstones = len(snap.tombstones)
            report.snapshot_root = snap.root_hex
            return snap
        return None

    def _replay_records(self, records, report) -> None:
        eng = self._engine
        for rec in records:
            if rec.op == walmod.OP_SET:
                applied = eng.set_if_newer(rec.key, rec.value or b"", rec.ts)
            elif rec.op == walmod.OP_DEL:
                applied = eng.delete_if_newer(rec.key, rec.ts)
            else:  # OP_TRUNCATE
                eng.truncate()
                applied = True
            report.replayed += 1
            if applied:
                report.applied += 1
        get_metrics().inc("storage.recovery_replayed", len(records))

    # -- runtime --------------------------------------------------------------
    def attach_server(self, server) -> None:
        """Start draining the native server's change-event queue into the
        WAL. While a Replicator runs, call :meth:`pause_drain` and route its
        batch listener here instead — the queue has ONE consumer at a time."""
        self._server = server
        server.enable_events(True)
        if self._drain_thread is None:
            self._drain_thread = threading.Thread(
                target=self._drain_loop, daemon=True, name="mkv-storage-drain"
            )
            self._drain_thread.start()

    def start(self) -> None:
        """Start the fsync-interval / compaction ticker."""
        if self._ticker_thread is None:
            self._ticker_thread = threading.Thread(
                target=self._ticker_loop, daemon=True, name="mkv-storage-tick"
            )
            self._ticker_thread.start()

    def pause_drain(self) -> None:
        """Stop consuming the event queue AND wait out any in-flight drain
        iteration, so a successor consumer (the Replicator) never races a
        batch this thread already popped — such a batch would reach the WAL
        but skip the publish/mirror path."""
        self._paused = True
        with self._drain_iter_mu:
            pass

    def resume_drain(self) -> None:
        self._paused = False

    def _drain_loop(self) -> None:
        while not self._stop_evt.is_set():
            with self._drain_iter_mu:
                if self._paused or self._server is None:
                    raws = None
                else:
                    try:
                        raws = self._server.drain_events()
                    except Exception:
                        raws = []
                    if raws:
                        self.record_raw(raws)
            if raws is None:
                time.sleep(0.02)
            elif not raws:
                # Park on the native queue's notify (the same event-driven
                # wait the replicator drain uses): the first staged write
                # wakes the WAL drain immediately, and an idle node stops
                # paying 5 ms poll wakeups.
                try:
                    self._server.wait_events(50)
                except Exception:
                    time.sleep(0.005)

    def _ticker_loop(self) -> None:
        cfg = self._cfg
        tick = min(max(cfg.fsync_interval_seconds, 0.01), 0.5)
        last_fsync = time.monotonic()
        last_disk = 0.0
        while not self._stop_evt.wait(tick):
            now = time.monotonic()
            if (
                cfg.fsync == "interval"
                and now - last_fsync >= cfg.fsync_interval_seconds
            ):
                self.fsync()
                last_fsync = now
            if now - last_disk >= min(1.0, max(tick, 0.05)):
                # Disk watermark check + full-disk recovery probe, at most
                # ~1/s: one statvfs, plus (only while latched full) a tiny
                # probe write through the WAL io seam.
                last_disk = now
                self._check_disk()
            if self._snapshot_requested or (
                cfg.compact_trigger_bytes > 0
                and self._bytes_since_snapshot >= cfg.compact_trigger_bytes
            ):
                defer = self._defer_compaction
                if defer is not None:
                    try:
                        if defer():
                            # Memory pressure: a snapshot materializes the
                            # whole keyspace host-side — exactly the
                            # allocation a pressured node must not make.
                            # The trigger stays pending; disk pressure
                            # never defers (compaction FREES segments).
                            get_metrics().inc("storage.compactions_deferred")
                            continue
                    except Exception:
                        pass  # a broken gate must not stop compaction
                try:
                    self.compact()
                    # Only a SUCCESSFUL snapshot satisfies the request — a
                    # transient failure (ENOSPC, device hiccup) must keep
                    # the re-anchor pending or corruption recovery's
                    # replay barrier never moves.
                    self._snapshot_requested = False
                except StorageFullError as e:
                    self._note_full(e)
                    get_metrics().inc("storage.compaction_errors")
                except OSError as e:
                    import errno as _errno

                    if e.errno in (
                        _errno.ENOSPC, _errno.EIO,
                        getattr(_errno, "EDQUOT", -1),
                    ):
                        self._note_full(e)
                    get_metrics().inc("storage.compaction_errors")
                except Exception:
                    get_metrics().inc("storage.compaction_errors")

    # -- resource faults (overload protection) ---------------------------------
    # Level codes match cluster/overload.py (LIVE/SHEDDING/READ_ONLY);
    # kept as literals here so the storage layer stays import-free of the
    # cluster plane.
    _LIVE, _SHEDDING, _READ_ONLY = 0, 1, 2
    # Watermark release factor: free bytes must exceed watermark * this to
    # step back down (hysteresis — a disk hovering at the boundary must
    # not flap the node between rungs).
    _DISK_RELEASE = 1.25

    def _note_full(self, cause: Exception) -> None:
        """A WAL/snapshot write hit ENOSPC/EIO: latch the full condition
        (the overload monitor flips the node read-only from it), loudly,
        exactly once per episode."""
        get_metrics().inc("storage.full_errors")
        if not self._full:
            self._full = True
            self._full_reason = str(cause)
            from merklekv_tpu_torch.obs.flightrec import record

            record("storage_full", reason=str(cause)[:120])
            now = time.monotonic()
            if now - self._recovered_at_m < 10.0:
                # Re-latched right after a probe recovery: the probe lied
                # (room for 4 KiB, not for the re-anchor). Back off before
                # probing again instead of flapping every tick.
                self._probe_backoff_s = min(
                    60.0, max(2.0, self._probe_backoff_s * 2)
                )
                self._next_probe_m = now + self._probe_backoff_s
            import sys

            print(
                f"storage: disk full/failing, node degrading to read-only "
                f"({cause})",
                file=sys.stderr,
                flush=True,
            )

    def _check_disk(self) -> None:
        """Ticker-side disk evaluation: refresh the free-bytes watermark
        signal and, while latched full, probe for recovery."""
        try:
            st = os.statvfs(self._dir)
            self.disk_free_bytes = st.f_bavail * st.f_frsize
        except OSError:
            self.disk_free_bytes = None
        soft = getattr(self._cfg, "disk_free_soft_bytes", 0)
        hard = getattr(self._cfg, "disk_free_hard_bytes", 0)
        free = self.disk_free_bytes
        lvl = self._disk_level
        if free is not None and (soft or hard):
            if hard and free < hard:
                lvl = self._READ_ONLY
            elif lvl == self._READ_ONLY and (
                not hard or free > hard * self._DISK_RELEASE
            ):
                lvl = self._SHEDDING
            if lvl == self._SHEDDING and (
                not soft or free > soft * self._DISK_RELEASE
            ):
                lvl = self._LIVE
            if lvl == self._LIVE and soft and free < soft:
                lvl = self._SHEDDING
        else:
            lvl = self._LIVE
        self._disk_level = lvl
        if self._full:
            self._try_recover_full()

    def _try_recover_full(self) -> None:
        """Probe the latched full condition: a small write+fsync+unlink
        through the SAME io seam the WAL uses (so both a real ENOSPC and
        the chaos suite's injected one gate recovery identically). On
        success the node returns to live and a re-anchor snapshot is
        requested — the records dropped during the full window exist only
        in the engine, and the fresh snapshot is what restores their
        durability."""
        now = time.monotonic()
        if now < self._next_probe_m:
            return  # backing off after a flapped recovery
        hard = getattr(self._cfg, "disk_free_hard_bytes", 0)
        if (
            hard
            and self.disk_free_bytes is not None
            and self.disk_free_bytes < hard * self._DISK_RELEASE
        ):
            return  # space still below the release watermark: keep waiting
        from merklekv_tpu_torch.storage import wal as walmod_seam

        probe = os.path.join(self._dir, ".diskprobe")
        try:
            fd = os.open(probe, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                walmod_seam.io_write(fd, b"\0" * 4096)
                walmod_seam.io_fsync(fd)
            finally:
                os.close(fd)
                try:
                    os.unlink(probe)
                except OSError:
                    pass
        except OSError:
            return  # still full; probe again next tick
        self._full = False
        self._full_reason = ""
        self._recovered_at_m = time.monotonic()
        self._snapshot_requested = True  # re-anchor: close the journal gap
        get_metrics().inc("storage.full_recoveries")
        from merklekv_tpu_torch.obs.flightrec import record

        record("storage_recovered")
        import sys

        print(
            "storage: disk writable again, re-anchoring snapshot and "
            "returning to live",
            file=sys.stderr,
            flush=True,
        )

    def overload_level(self) -> tuple[int, str]:
        """The storage plane's degradation verdict for the overload
        monitor: (level, reason). A live ENOSPC/EIO condition is
        read-only regardless of watermarks; otherwise the free-bytes
        watermark state machine answers."""
        if self._full:
            return self._READ_ONLY, "disk"
        if self._disk_level > self._LIVE:
            return self._disk_level, "disk"
        return self._LIVE, ""

    def set_defer_compaction(self, fn) -> None:
        """Install the overload monitor's memory-pressure gate: while it
        returns True the ticker defers snapshot compaction (the trigger
        stays pending)."""
        self._defer_compaction = fn

    @property
    def storage_full(self) -> bool:
        return self._full

    # -- record ingestion ------------------------------------------------------
    def record_raw(self, raws: list[ChangeEventRaw]) -> None:
        """Record a drained batch of native change events."""
        recs = []
        for r in raws:
            if r.op == OP_DEL:
                recs.append(WalRecord(walmod.OP_DEL, r.key, None, r.ts_ns))
            elif r.op == OP_TRUNCATE:
                recs.append(
                    WalRecord(walmod.OP_TRUNCATE, b"", None, r.ts_ns)
                )
                self._snapshot_requested = True
            elif r.has_value:
                # SET / INCR / DECR / APPEND / PREPEND all carry the post-op
                # value, so each replays as an idempotent timestamped SET.
                recs.append(WalRecord(walmod.OP_SET, r.key, r.value, r.ts_ns))
        self._append_many(recs)

    def record_events(self, events) -> None:
        """Replicator batch-listener entry: decoded local ChangeEvents."""
        from merklekv_tpu_torch.cluster.change_event import OpKind

        recs = []
        for ev in events:
            key = ev.key.encode("utf-8", "surrogateescape")
            if ev.op is OpKind.DEL:
                recs.append(WalRecord(walmod.OP_DEL, key, None, ev.ts))
            elif ev.op is OpKind.TRUNCATE:
                recs.append(WalRecord(walmod.OP_TRUNCATE, b"", None, ev.ts))
                self._snapshot_requested = True
            elif ev.val is not None:
                recs.append(WalRecord(walmod.OP_SET, key, ev.val, ev.ts))
        self._append_many(recs)

    def record_set(self, key: bytes, value: bytes, ts: int) -> None:
        """Record one applied write (replication apply, sync repair)."""
        self._append_many([WalRecord(walmod.OP_SET, key, value, ts)])

    def record_delete(self, key: bytes, ts: int) -> None:
        self._append_many([WalRecord(walmod.OP_DEL, key, None, ts)])

    def record_applied(
        self, items: list[tuple[bytes, Optional[bytes], int]]
    ) -> None:
        """Journal one applied replication frame as a grouped WAL append:
        ``(key, value|None-for-delete, exact LWW ts)`` per op, one
        ``write()``/fsync decision for the whole frame (append_many
        batches the encoded frames into a single kernel write)."""
        self._append_many(
            [
                WalRecord(
                    walmod.OP_DEL if value is None else walmod.OP_SET,
                    key,
                    value,
                    ts,
                )
                for key, value, ts in items
            ]
        )

    def _append_many(self, recs: list[WalRecord]) -> None:
        if not recs or self._writer is None:
            return
        try:
            n = self._writer.append_many(recs)
        except StorageFullError as e:
            # The disk, not the records, failed: the drain thread must
            # SURVIVE (killing it would silently stop ALL journaling
            # forever). The records stay live in the engine; the node
            # degrades read-only via overload_level(), and the re-anchor
            # snapshot on recovery restores their durability. Until then
            # each dropped record is counted — a silent gap would read as
            # "journaled" in every dashboard.
            self._note_full(e)
            get_metrics().inc("storage.records_dropped", len(recs))
            return
        size = sum(len(r.key) + len(r.value or b"") + 25 for r in recs)
        self._bytes_since_snapshot += size
        m = get_metrics()
        m.inc("storage.wal_appends", n)
        if self._cfg.fsync == "always":
            m.inc("storage.wal_fsyncs")

    def fsync(self) -> None:
        w = self._writer
        if w is None:
            return
        t0 = time.perf_counter()
        try:
            synced = w.fsync()
        except StorageFullError as e:
            self._note_full(e)  # ticker survives; node degrades read-only
            return
        if synced:
            m = get_metrics()
            m.inc("storage.wal_fsyncs")
            # Fsync latency histogram (no log line — the ticker calls this
            # many times per second): p50/p99 derivable from buckets, the
            # number that decides the fsync=always vs interval trade-off.
            m.observe("storage.wal_fsync", time.perf_counter() - t0)

    # -- snapshots / compaction ------------------------------------------------
    def compact(self) -> str:
        """Snapshot current engine state, then drop WAL segments and old
        snapshots the retention policy no longer needs. Returns the new
        snapshot's path."""
        path = self.snapshot_now()
        get_metrics().inc("storage.compactions")
        return path

    def snapshot_now(self) -> str:
        """Write a Merkle-stamped snapshot of the engine's current state.

        Rotation first: the snapshot's ``wal_seq`` is the fresh segment's
        seq, so state captured *after* rotation strictly covers everything
        in older segments, and records racing into the fresh segment replay
        as no-ops (LWW idempotence)."""
        with self._snap_mu, span("storage.snapshot") as out:
            assert self._writer is not None, "recover() before snapshot_now()"
            cutoff_seq = self._writer.rotate()
            t0 = time.perf_counter()
            # Timestamps BEFORE values: the three reads are separate native
            # calls, so a racing write lands in at most the later ones. A
            # newer value paired with an older/absent ts is safe — the
            # write's own WAL frame (in the fresh post-rotation segment,
            # always replayed) carries the true ts and wins set_if_newer on
            # recovery. The reverse pairing (old value, new ts) would make
            # recovery's equal-ts digest tiebreak stick the stale value.
            ts_map = dict(self._engine.key_timestamps())
            items = self._engine.snapshot()
            tombs = self._engine.tombstones()
            root = snapmod.compute_root_hex(
                items,
                engine=self._cfg.merkle_engine,
                device_min_keys=self._cfg.device_min_keys,
            )
            snaps = snapmod.list_snapshots(self._dir)
            seq = (snaps[-1][0] + 1) if snaps else 1
            path = snapmod.write_snapshot(
                self._dir,
                seq,
                [(k, v, ts_map.get(k, 0)) for k, v in items],
                tombs,
                cutoff_seq,
                root,
            )
            self._bytes_since_snapshot = 0
            # A whole snapshot fit on disk: genuine room, stop backing off —
            # including the flap DETECTOR. _note_full arms the probe backoff
            # whenever a latch lands within 10 s of a recovery; without
            # clearing the recovery stamp here, a completed re-anchor
            # snapshot (the documented backoff reset) still left the next
            # genuine full episode tarred as a flap, deferring its recovery
            # probe by the minimum 2 s — which is exactly what made
            # test_soak_repeated_disk_full_cycles fail its post-heal
            # storage_full assertion on every cycle after the first.
            self._probe_backoff_s = 0.0
            self._next_probe_m = 0.0
            self._recovered_at_m = 0.0
            seconds = time.perf_counter() - t0
            out["items"] = len(items)
            out["root"] = root[:16]
            m = get_metrics()
            m.inc("storage.snapshots")
            m.inc("storage.snapshot_seconds_ms", int(seconds * 1e3))
            self._apply_retention()
        return path

    def _apply_retention(self) -> None:
        """Keep the newest ``snapshots_retained`` snapshots (plus any the
        snapshot-shipping donor path has pinned for an in-flight transfer);
        drop WAL segments older than the oldest retained snapshot's cutoff
        (the oldest snapshot must still be able to replay forward — that is
        the repair path's fallback when the newest snapshot fails
        verify)."""
        keep = max(1, self._cfg.snapshots_retained)
        pinned = self._live_pins()
        snaps = snapmod.list_snapshots(self._dir)
        for seq, path in snaps[:-keep]:
            if seq in pinned:
                continue  # a joiner is mid-transfer on this artifact
            try:
                os.unlink(path)
            except OSError:
                pass
        retained = snaps[-keep:] + [
            (seq, path) for seq, path in snaps[:-keep] if seq in pinned
        ]
        if not retained:
            return
        min_seq = None
        for _, path in retained:
            try:
                min_seq_c = snapmod.read_snapshot_wal_seq(path)
            except (SnapshotCorruptError, OSError):
                return  # unreadable retained snapshot: keep every segment
            min_seq = min_seq_c if min_seq is None else min(min_seq, min_seq_c)
        active = self._writer.seq if self._writer is not None else None
        for seq, path in walmod.list_segments(self._dir):
            if seq < min_seq and seq != active:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    # -- snapshot shipping (donor side) ----------------------------------------
    # A pin goes stale after this much donor-side silence; every SNAPMETA/
    # SNAPCHUNK refreshes it, so any live transfer (even over a throttled
    # link) keeps its artifact alive while a dead joiner releases it.
    _PIN_TTL_S = 120.0
    # Donor-side clamp on one SNAPCHUNK's raw range: the compressed+base64
    # response must fit the native cluster-callback buffer (512 KiB) with
    # worst-case-incompressible payloads.
    MAX_CHUNK_BYTES = 256 * 1024

    def _live_pins(self) -> set[int]:
        now = time.monotonic()
        with self._pin_mu:
            for seq in [
                s
                for s, t in self._pins.items()
                if now - t > self._PIN_TTL_S
            ]:
                del self._pins[seq]
            return set(self._pins)

    def _pin(self, seq: int) -> None:
        with self._pin_mu:
            self._pins[seq] = time.monotonic()

    def refresh_pin(self, seq: Optional[int] = None) -> None:
        """Re-stamp snapshot ``seq``'s retention pin — or EVERY live pin
        when ``seq`` is None — from a long-lived transfer session's
        heartbeat. SNAPMETA/SNAPCHUNK reads refresh pins as a side effect,
        but a THROTTLED rebalance transfer can legitimately go quiet for
        longer than ``_PIN_TTL_S`` between chunks (the joiner paces itself
        against live write load) — the donor-side rebalance session
        heartbeats this instead, so the artifact outlives any pause
        shorter than the session itself while a dead session still
        releases it after the TTL."""
        if seq is not None:
            self._pin(seq)
            return
        now = time.monotonic()
        with self._pin_mu:
            for s in self._pins:
                self._pins[s] = now

    def request_snapshot(self) -> None:
        """Ask the background ticker for a re-anchor snapshot on its next
        tick (no-op without a ticker — embedded shapes call
        :meth:`snapshot_now` directly). Used after a rebalance drops the
        moved range with quiet deletes: the drop is unjournaled by design
        (the new map's guard plus the boot-time foreign-key sweep make the
        range unreachable), so the next snapshot must capture the
        post-drop keyspace to keep recovery O(owned keys)."""
        self._snapshot_requested = True

    # donor_meta sentinel: no artifact yet, but one is being built in the
    # background — the joiner should retry shortly instead of degrading.
    BUILDING = "building"

    def donor_meta(self):
        """Advertise the newest shippable snapshot: ``(seq, wal_seq,
        size_bytes, root_hex)``, pinning it against retention. Returns
        :data:`BUILDING` when no artifact exists yet but the background
        ticker has been asked to write one (the SNAPMETA handler must not
        block a request thread on an O(keyspace) snapshot write — at the
        10M-key target that outlives the joiner's op timeout and cascades
        a useless full snapshot onto every donor it fails over to), or
        None when no snapshot can be produced at all (recovery not run,
        write failure)."""
        snaps = snapmod.list_snapshots(self._dir)
        stale = False
        if snaps and self._writer is not None:
            # Freshness: when the WAL delta since the last snapshot rivals
            # the snapshot itself, shipping the old artifact would push the
            # bulk of the keyspace through the joiner's delta walk anyway —
            # ask for a re-snapshot so the NEXT transfer carries the
            # savings, and serve the current artifact meanwhile.
            try:
                size_now = os.path.getsize(snaps[-1][1])
            except OSError:
                size_now = 0
            stale = self._bytes_since_snapshot >= max(size_now, 1 << 20)
        if not snaps or stale:
            if self._writer is None:
                return None
            if self._ticker_thread is not None:
                # Background build; a missing artifact answers BUILDING
                # (joiner polls), a merely-stale one ships as-is below.
                self._snapshot_requested = True
                if not snaps:
                    return self.BUILDING
            else:
                # No ticker (embedded/test shape): inline is the only way
                # an artifact ever materializes.
                try:
                    self.snapshot_now()
                except Exception:
                    get_metrics().inc("storage.donor_meta_errors")
                    if not snaps:
                        return None
                snaps = snapmod.list_snapshots(self._dir)
                if not snaps:
                    return None
        seq, path = snaps[-1]
        try:
            wal_seq, root_hex, _ni, _nt = snapmod.read_snapshot_header(path)
            size = os.path.getsize(path)
        except (OSError, SnapshotCorruptError):
            get_metrics().inc("storage.donor_meta_errors")
            return None
        self._pin(seq)
        return seq, wal_seq, size, root_hex

    def read_snapshot_range(self, seq: int, offset: int, count: int) -> bytes:
        """One raw byte range of snapshot ``seq`` for SNAPCHUNK, refreshing
        its retention pin. Raises FileNotFoundError when the artifact is
        gone (donor restarted past the pin TTL) — the joiner re-discovers.
        Short reads at EOF return the remaining bytes; ``offset`` past EOF
        returns b"" (the joiner treats that as transfer-size disagreement
        and re-discovers rather than assembling a short file)."""
        count = max(0, min(count, self.MAX_CHUNK_BYTES))
        path = snapmod.snapshot_path(self._dir, seq)
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(count)
        self._pin(seq)
        return raw

    # -- shutdown --------------------------------------------------------------
    def stop(self) -> None:
        """Final drain + fsync (+ shutdown snapshot), release the lock."""
        self._stop_evt.set()
        for t in (self._drain_thread, self._ticker_thread):
            if t is not None:
                t.join(timeout=5)
        self._drain_thread = self._ticker_thread = None
        if self._server is not None and not self._paused:
            try:
                self.record_raw(self._server.drain_events())
            except Exception:
                pass
        if self._writer is not None:
            if self._cfg.snapshot_on_shutdown:
                try:
                    self.snapshot_now()
                except Exception:
                    get_metrics().inc("storage.compaction_errors")
            self.fsync()
            self._writer.close()
            self._writer = None
        if self._lock_fd >= 0:
            os.close(self._lock_fd)
            self._lock_fd = -1

    # -- introspection ---------------------------------------------------------
    # -- gauges ---------------------------------------------------------------
    def wal_size_bytes(self) -> int:
        """Total bytes across live WAL segment files (gauge path: one
        directory listing + stat calls, no locks)."""
        total = 0
        for _seq, path in walmod.list_segments(self._dir):
            try:
                total += os.path.getsize(path)
            except OSError:
                continue  # segment compacted away mid-listing
        return total

    def wal_segment_count(self) -> int:
        return len(walmod.list_segments(self._dir))

    @property
    def directory(self) -> str:
        return self._dir

    @property
    def wal_seq(self) -> Optional[int]:
        return self._writer.seq if self._writer is not None else None
