"""Node bootstrap: verified snapshot shipping + delta sync.

A copy of ``merklekv_tpu/cluster/bootstrap.py``, its imports pointed at the port's
modules. The snapshot's root is verified through the port's
``storage/snapshot.py`` with the node's ``[storage] merkle_engine``, so on a
node on the card it is hashed on the card; a device failure there is counted
in ``device.fallbacks`` and fails this donor's attempt, never answered from
the host.

A new (or long-dead, or interior-WAL-corrupted) replica rebuilding purely
via anti-entropy hits the bisect walk's pathological worst case — every
subtree diverges, so the walk degenerates toward O(n) wire bytes and the
joiner serves stale/empty reads for the whole window. This module applies
the "decouple and batch tree maintenance" idea from Asynchronous Merkle
Trees (arXiv:2311.17441, PAPERS.md) to node lifecycle instead: reuse the
storage plane's Merkle-stamped snapshots as a bulk-transfer format, verify
the stamped root on the JOINER before a single read serves, and close the
post-stamp gap with the ordinary bisect walk — which now only descends
into the delta.

State machine (one run per (re)boot):

    DISCOVER  pick a donor: SNAPMETA every candidate (health-up peers
              first); ERROR answers are the capability-fallback signal
              (old peer / no durable storage / no snapshot) — a candidate
              pool with zero capable donors degrades to the plain
              anti-entropy walk, same discipline as TREELEVEL.
    FETCH     SNAPCHUNK range reads, CRC-framed; the byte offset is the
              checkpoint, so a dropped/throttled link resumes at the
              verified prefix (retry.py BOOTSTRAP_FETCH policy). Donor
              death past the retry budget fails over to the next donor.
    VERIFY    decode the assembled bytes + recompute the Merkle root via
              the bulk rebuild path; a stamp mismatch QUARANTINES the
              donor as suspect (never retried this run, reported to the
              health table) and the next donor is tried. The node serves
              ZERO reads before this passes.
    DELTA     apply the verified state through the LWW verbs (one native
              batch crossing per slab), open the read gate, replay the
              replication frames buffered during the transfer, then run a
              bisect walk against the donor clipped — by tree equality —
              to the post-stamp delta.
    LIVE      converged; the periodic anti-entropy loop takes over.

Failure is never worse than the status quo ante: any path that cannot
ship-and-verify a snapshot ends in the plain walk the node would have run
anyway, and the read gate always reopens.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from merklekv_tpu_torch.client import (
    ChunkIntegrityError,
    MerkleKVClient,
    MerkleKVError,
    ProtocolError,
)
from merklekv_tpu_torch.cluster.retry import BOOTSTRAP_FETCH, Deadline, RetryPolicy
from merklekv_tpu_torch.utils.tracing import get_metrics, span

__all__ = ["BootstrapSession", "BootstrapReport", "STATE_CODES"]

# Gauge encoding of the state machine (bootstrap.state).
STATE_CODES = {
    "idle": 0,
    "discover": 1,
    "fetch": 2,
    "verify": 3,
    "delta": 4,
    "live": 5,
    "failed": -1,
}

# Ops per native apply_batch crossing when installing a verified snapshot.
_APPLY_SLAB = 8192


@dataclass
class BootstrapReport:
    reason: str = ""
    # "snapshot": verified bulk transfer + delta walk; "walk": no donor
    # could serve a snapshot, plain anti-entropy fallback; "failed": no
    # donor reachable at all (the periodic loop keeps trying).
    mode: str = ""
    donor: str = ""
    donors_tried: list[str] = field(default_factory=list)
    # Donors whose snapshot failed stamp/CRC verification — quarantined
    # for this run and reported degraded to the health table.
    suspects: list[str] = field(default_factory=list)
    snapshot_seq: int = 0
    snapshot_items: int = 0
    snapshot_tombstones: int = 0
    root: str = ""
    bytes_fetched: int = 0  # raw snapshot bytes assembled
    chunks: int = 0
    chunk_retries: int = 0
    donor_failovers: int = 0
    # Total client-measured request+response bytes across every donor
    # connection AND the delta walk — the number the chaos test compares
    # against a walk-only rebuild.
    wire_bytes: int = 0
    delta_divergent: int = -1  # -1: no delta walk ran
    seconds: float = 0.0
    details: list[str] = field(default_factory=list)


class BootstrapSession:
    """One bootstrap run for one node. Thread-safe introspection via
    ``state`` / ``report``; drive with :meth:`run` (blocking — the cluster
    node wraps it in a daemon thread)."""

    def __init__(
        self,
        engine,
        sync_manager,
        peers: list[str],
        cfg,  # BootstrapConfig
        merkle_engine: str = "auto",
        health=None,  # Optional[PeerHealthMonitor]
        # Applied-state fan-out: list[(key, value|None, ts)] per slab —
        # the cluster node journals these to the WAL and stages them into
        # the device mirror (bootstrap applies bypass the server's event
        # queue, exactly like anti-entropy repairs).
        batch_listener: Optional[Callable[[list], None]] = None,
        # Fires ONCE, the moment verified state is fully applied (or the
        # session commits to the walk fallback): the cluster node reopens
        # the read gate and replays buffered replication frames here.
        on_serving: Optional[Callable[[], None]] = None,
        retry: Optional[RetryPolicy] = None,
    ) -> None:
        self._engine = engine
        self._sync = sync_manager
        self._peers = list(peers)
        self._cfg = cfg
        self._merkle_engine = merkle_engine
        self._health = health
        self._batch_listener = batch_listener
        self._on_serving = on_serving
        self._served = False
        self._retry = retry if retry is not None else BOOTSTRAP_FETCH
        self._stop = threading.Event()
        self._state = "idle"
        self._state_mu = threading.Lock()
        self.report: Optional[BootstrapReport] = None

    # -- introspection --------------------------------------------------------
    @property
    def state(self) -> str:
        with self._state_mu:
            return self._state

    def state_code(self) -> int:
        return STATE_CODES.get(self.state, 0)

    def stop(self) -> None:
        self._stop.set()

    def _enter(self, state: str) -> None:
        with self._state_mu:
            self._state = state
        # Flight recorder: bootstrap phases are the classic "died mid-join"
        # forensic question — the spill's tail names how far the session
        # got (discover/fetch/verify/delta/live/failed).
        from merklekv_tpu_torch.obs.flightrec import record

        record("bootstrap", state=state)

    def _serving(self) -> None:
        """Open the gate exactly once per run (idempotent safety net: the
        runner's finally block calls this too, so a crashed session can
        never leave the node unreadable)."""
        if self._served:
            return
        self._served = True
        if self._on_serving is not None:
            try:
                self._on_serving()
            except Exception:
                pass  # the gate hook must never kill the session

    # -- main -----------------------------------------------------------------
    def run(self, reason: str) -> BootstrapReport:
        report = BootstrapReport(reason=reason)
        self.report = report
        t0 = time.perf_counter()
        metrics = get_metrics()
        try:
            with span("bootstrap", reason=reason) as rec:
                self._run(report)
                rec["mode"] = report.mode
                rec["donor"] = report.donor
                rec["bytes_fetched"] = report.bytes_fetched
                rec["wire_bytes"] = report.wire_bytes
            metrics.inc("bootstrap.completed")
        except Exception as e:
            self._enter("failed")
            report.mode = report.mode or "failed"
            report.details.append(f"bootstrap error: {e!r}")
            metrics.inc("bootstrap.errors")
        finally:
            self._serving()
            report.seconds = time.perf_counter() - t0
        return report

    def _candidates(self) -> list[str]:
        """Donor order: health-up peers first, then unknown/degraded, then
        confirmed-down (a down peer may have just restarted — still worth
        one SNAPMETA before surrendering to the walk)."""
        if self._health is None:
            return list(self._peers)
        order = {"up": 0, "unknown": 1, "degraded": 1, "down": 2}
        status = {h.peer: h.status for h in self._health.snapshot()}
        return sorted(
            self._peers, key=lambda p: order.get(status.get(p, "unknown"), 1)
        )

    def _run(self, report: BootstrapReport) -> None:
        metrics = get_metrics()
        self._enter("discover")
        reachable: list[str] = []
        building: list[str] = []

        def attempt(peer: str, wait_build: bool) -> bool:
            host, _, port_s = peer.rpartition(":")
            client = MerkleKVClient(
                host, int(port_s), timeout=self._retry.op_timeout
            )
            try:
                client.connect()
            except Exception as e:
                report.details.append(f"{peer}: unreachable ({e!r})")
                client.close()
                return False
            if peer not in report.donors_tried:
                report.donors_tried.append(peer)
            if peer not in reachable:
                reachable.append(peer)
            try:
                return self._try_donor(
                    client, peer, report, building, wait_build
                )
            finally:
                report.wire_bytes += client.bytes_sent + client.bytes_received
                client.close()

        def finish_snapshot(peer: str) -> None:
            # Close the post-stamp gap; the donor first, then any other
            # reachable peer — a donor dying right after the last chunk
            # must not leave the delta silently unclosed under a
            # "snapshot" success banner.
            others = [p for p in reachable if p != peer]
            if not any(self._delta(p, report) for p in [peer] + others):
                report.details.append(
                    "delta sync failed against every reachable peer; "
                    "periodic anti-entropy closes the gap"
                )
            self._enter("live")
            report.mode = "snapshot"

        # Pass 1: one SNAPMETA per candidate — a donor mid-build of its
        # first artifact answers "building" and is SET ASIDE, never
        # head-of-line-blocking a donor whose artifact is ready to ship.
        for peer in self._candidates():
            if self._stop.is_set():
                return
            if attempt(peer, wait_build=False):
                finish_snapshot(report.donor)
                return
        # Pass 2: nothing ready anywhere — now it is worth waiting out a
        # background build (bounded) before surrendering to the walk.
        for peer in building:
            if self._stop.is_set():
                return
            if attempt(peer, wait_build=True):
                finish_snapshot(report.donor)
                return
        # No donor could ship a verifiable snapshot: degrade to the plain
        # anti-entropy walk against the first reachable non-suspect peer —
        # the exact rebuild the node would have run without this subsystem.
        metrics.inc("bootstrap.fallbacks")
        self._serving()
        targets = [p for p in reachable if p not in report.suspects]
        # A quarantined donor's DATA plane is still trustworthy for a
        # key-level walk (values are re-hashed locally); prefer clean peers
        # but fall back to suspects rather than not converging at all.
        targets += [p for p in reachable if p in report.suspects]
        targets += [p for p in self._peers if p not in reachable]
        for peer in targets:
            if self._stop.is_set():
                return
            if self._delta(peer, report):
                self._enter("live")
                report.mode = "walk"
                return
        self._enter("failed")
        report.mode = "failed"
        report.details.append("no peer reachable; periodic loop will retry")

    # -- donor transfer -------------------------------------------------------
    def _try_donor(
        self,
        client: MerkleKVClient,
        peer: str,
        report: BootstrapReport,
        building: list[str],
        wait_build: bool,
    ) -> bool:
        """Full FETCH + VERIFY + apply against one donor. True when the
        verified snapshot is installed; False to try the next donor. A
        donor answering "building" is appended to ``building`` (unless
        ``wait_build``, which polls the build out)."""
        from merklekv_tpu_torch.storage import snapshot as snapmod

        metrics = get_metrics()
        try:
            if wait_build:
                seq, _wal_seq, size, stamped_root = (
                    self._snap_meta_poll(client)
                )
            else:
                seq, _wal_seq, size, stamped_root = client.snap_meta()
        except ProtocolError as e:
            if "retry" in str(e).lower():
                if wait_build:
                    # Pass 2 already waited the build bound out; a donor
                    # still answering "building" (persistently failing
                    # ticker — ENOSPC and the like) must NOT re-enter the
                    # building list or the poll never ends and the read
                    # gate never reopens.
                    report.details.append(
                        f"{peer}: snapshot still building past the wait "
                        "bound; giving up on this donor"
                    )
                    return False
                # First artifact building in the donor's background: defer
                # — another candidate may have one ready right now.
                building.append(peer)
                report.details.append(f"{peer}: snapshot building; deferred")
                return False
            # Capability fallback: old peer, no durable storage, or no
            # snapshot on disk — never an integrity signal.
            report.details.append(f"{peer}: cannot serve snapshot ({e})")
            metrics.inc("bootstrap.capability_misses")
            return False
        except (MerkleKVError, OSError) as e:
            report.details.append(f"{peer}: SNAPMETA died ({e!r})")
            return False

        self._enter("fetch")
        blob = self._fetch(client, peer, seq, size, report)
        if blob is None:
            report.donor_failovers += 1
            metrics.inc("bootstrap.donor_failovers")
            return False

        self._enter("verify")
        with span("bootstrap.verify", peer=peer) as rec:
            try:
                snap = snapmod.parse_snapshot_bytes(blob, f"{peer}#snap-{seq}")
                if snap.root_hex != stamped_root:
                    # The file's own stamp disagrees with the advertised
                    # meta — same trust failure as a recompute mismatch.
                    raise snapmod.RootMismatchError(
                        f"{peer}#snap-{seq}", stamped_root, snap.root_hex
                    )
                verified = snapmod.verify_snapshot(
                    snap, engine=self._merkle_engine
                )
            except (
                snapmod.SnapshotCorruptError,
                snapmod.RootMismatchError,
            ) as e:
                # QUARANTINE: a donor whose stamped artifact does not hash
                # to its own stamp is suspect — try the next donor, tell
                # the health table, and refuse to go LIVE on its state.
                report.suspects.append(peer)
                report.details.append(f"{peer}: snapshot rejected ({e})")
                metrics.inc("bootstrap.verify_failures")
                if self._health is not None:
                    self._health.mark_degraded(
                        peer, f"bootstrap snapshot rejected: {e}"
                    )
                return False
            rec["items"] = len(snap.items)
            rec["root"] = verified[:16]

        self._apply(snap)
        report.donor = peer
        report.snapshot_seq = seq
        report.snapshot_items = len(snap.items)
        report.snapshot_tombstones = len(snap.tombstones)
        report.root = verified
        metrics.inc("bootstrap.snapshots_installed")
        # Reads may serve now: everything installed is verified, and the
        # buffered replication frames replay through the same LWW verbs.
        self._serving()
        return True

    # How long DISCOVER waits out a donor answering "snapshot not ready
    # (building); retry": the donor kicked its first artifact to the
    # background ticker rather than blocking the request handler with an
    # O(keyspace) write — a bounded poll here is what keeps a fresh
    # cluster's first rejoin on the bulk path instead of cascading a
    # useless snapshot build onto every donor.
    _BUILD_WAIT_S = 120.0

    def _snap_meta_poll(
        self, client: MerkleKVClient
    ) -> tuple[int, int, int, str]:
        deadline = Deadline(self._BUILD_WAIT_S)
        attempt = 0
        while True:
            try:
                return client.snap_meta()
            except ProtocolError as e:
                if (
                    "retry" not in str(e).lower()
                    or deadline.expired()
                    or self._stop.is_set()
                ):
                    raise
                time.sleep(deadline.clamp(self._retry.backoff(attempt)))
                attempt += 1

    def _fetch(
        self,
        client: MerkleKVClient,
        peer: str,
        seq: int,
        size: int,
        report: BootstrapReport,
    ) -> Optional[bytes]:
        """SNAPCHUNK loop with per-offset retries. The offset is the
        checkpoint: an integrity failure or dead stream refetches only the
        current chunk (reconnecting on transport death), never the
        assembled prefix. Returns None once the donor budget is spent."""
        metrics = get_metrics()
        deadline = self._retry.deadline()
        parts: list[bytes] = []
        offset = 0
        attempts = 0
        while offset < size:
            if self._stop.is_set() or deadline.expired():
                report.details.append(
                    f"{peer}: fetch abandoned at {offset}/{size}"
                )
                return None
            try:
                raw = client.snap_chunk(seq, offset, self._cfg.chunk_bytes)
            except ProtocolError as e:
                # ERROR mid-transfer: the artifact vanished donor-side
                # (restart past the pin TTL) — re-discover elsewhere.
                report.details.append(f"{peer}: chunk refused ({e})")
                return None
            except (ChunkIntegrityError, MerkleKVError, OSError) as e:
                attempts += 1
                report.chunk_retries += 1
                metrics.inc("bootstrap.chunk_retries")
                if attempts >= self._cfg.chunk_retries:
                    report.details.append(
                        f"{peer}: chunk {offset} failed {attempts}x ({e!r})"
                    )
                    return None
                time.sleep(deadline.clamp(self._retry.backoff(attempts - 1)))
                if not isinstance(e, ChunkIntegrityError):
                    # Dead/desynced stream: reconnect before the retry
                    # (the byte counters survive — same client object).
                    try:
                        client.close()
                        client.connect()
                    except Exception:
                        pass  # next snap_chunk raises; retries burn down
                continue
            if not raw:
                # Offset inside the advertised size but EOF on disk: the
                # donor's file is not what SNAPMETA promised.
                report.details.append(
                    f"{peer}: short snapshot ({offset}/{size})"
                )
                return None
            attempts = 0
            parts.append(raw)
            offset += len(raw)
            report.chunks += 1
            report.bytes_fetched += len(raw)
            metrics.inc("bootstrap.chunks")
            metrics.inc("bootstrap.bytes_fetched", len(raw))
        return b"".join(parts)

    # -- install + delta ------------------------------------------------------
    def _apply(self, snap) -> None:
        """Install the verified snapshot through the engine's LWW verbs in
        native batch crossings — conditional installs, so local writes that
        raced ahead of the transfer (and buffered replication frames
        journaled during it) keep winning per-key LWW."""
        ops: list[tuple[bytes, Optional[bytes], int]] = [
            (k, v, ts) for k, v, ts in snap.items
        ] + [(k, None, ts) for k, ts in snap.tombstones]
        for i in range(0, len(ops), _APPLY_SLAB):
            slab = ops[i : i + _APPLY_SLAB]
            flags = self._engine.apply_batch(slab)
            if self._batch_listener is not None:
                applied = [op for op, ok in zip(slab, flags) if ok]
                if applied:
                    try:
                        self._batch_listener(applied)
                    except Exception:
                        pass  # fan-out must not kill the install

    def _delta(self, peer: str, report: BootstrapReport) -> bool:
        """Close the post-stamp gap with one anti-entropy cycle against
        ``peer``. After a verified install the trees agree everywhere but
        the delta, so the bisect walk descends only into it."""
        self._enter("delta")
        host, _, port_s = peer.rpartition(":")
        before_s, before_r = self._sync_bytes()
        try:
            rep = self._sync.sync_once(host, int(port_s))
        except Exception as e:
            report.details.append(f"{peer}: delta sync failed ({e!r})")
            get_metrics().inc("bootstrap.delta_errors")
            return False
        finally:
            after_s, after_r = self._sync_bytes()
            report.wire_bytes += (after_s - before_s) + (after_r - before_r)
        report.delta_divergent = rep.divergent
        report.details.append(
            f"{peer}: delta mode={rep.mode} divergent={rep.divergent}"
        )
        return True

    @staticmethod
    def _sync_bytes() -> tuple[int, int]:
        snap = get_metrics().snapshot()["counters"]
        return snap.get("sync.bytes_sent", 0), snap.get(
            "sync.bytes_received", 0
        )
