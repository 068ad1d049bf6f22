"""Live partition rebalancing: epoch-bumped online resharding.

A copy of ``merklekv_tpu/cluster/rebalance.py``, its imports pointed at the
port's modules, except at the device sites. The reference pins the moving
range's root (the flip gate) and the joiner's snapshot verification to the
host. Here both go through ``storage/snapshot.compute_root_hex``
with the node's ``[storage] merkle_engine``, the rule of the snapshot root:
from ``DEVICE_MIN_KEYS`` keys up (``"auto"``) they are hashed on the node's
device (``leaf_kernel`` + ``node_level_kernel`` on the card). Every route
gives the same root bit for bit, so donor and joiner agree whichever route
each takes. A device failure there is counted in ``device.fallbacks`` and
raised into the state machine: the donor's verification fails and it rolls
back at epoch E, or the joiner aborts back to reserve. The root is never
recomputed on the host after a device error.

One RebalanceManager rides every ClusterNode and plays whichever role the
wire hands it:

- **donor** — the node serving partition p receives ``REBALANCE SPLIT``
  and drives the whole session: conscript the joiner, double-apply live
  moving-range writes onto the joiner's replication topic, stream a
  Merkle-stamped snapshot over the existing SNAPMETA/SNAPCHUNK path,
  fence the moving range, verify the joiner's root bit-for-bit against
  its own range root, persist map epoch E+1 (THE commit point), flip,
  and drop the moved range behind the new guard.
- **joiner** — a reserve node receives ``REBALANCE JOIN``: it subscribes
  to its future partition topic with applies held (journal-but-buffer),
  fetches + verifies the donor snapshot, installs the moving-range subset,
  releases the held forward stream, and serves its root for verification
  until COMMIT opens the serving gate.
- **sibling** — the donor's replica-group peers take ``REBALANCE FENCE``
  (TTL-guarded write fence over the moving cell) and ``REBALANCE
  COMMIT``/``ABORT``. On commit a sibling sweep-forwards its moved-range
  residue to the joiner (closing the QoS-0 window where a replication
  frame from sibling to donor was dropped mid-transfer) before dropping
  the range.

Crash containment (docs/FAULT_MODEL.md "Mid-rebalance kill windows"):
the epoch flip is exactly as atomic as ``partmap.save_map_file``'s
rename. A donor killed before it restarts at epoch E and the session
evaporates — sibling fences expire on their TTL, and the joiner's
resolve loop polls the donor's PARTMAP, sees epoch E, and wipes itself
back to reserve (full rollback). A donor killed after it restarts at
E+1 from the persisted map (boot foreign-key sweep drops the moved
range), the joiner's resolve loop sees epoch >= pending and
self-commits, and sibling fence-expiry probes adopt the newer map (full
roll-forward). A joiner killed mid-transfer fails the donor's poll
budget; the donor — which served reads AND non-moving writes throughout
— aborts, disarms everything, and stays at epoch E.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from merklekv_tpu_torch.client import (
    ChunkIntegrityError,
    ConnectionError as ClientConnectionError,
    MerkleKVClient,
    MerkleKVError,
    ProtocolError,
)
from merklekv_tpu_torch.cluster.change_event import ChangeEvent, OpKind
from merklekv_tpu_torch.cluster.partmap import (
    PartitionMap,
    PartitionMapError,
    format_map_spec,
    key_in_range,
    parse_map_spec,
)
from merklekv_tpu_torch.cluster.retry import BOOTSTRAP_FETCH
from merklekv_tpu_torch.obs.flightrec import record as flight_record
from merklekv_tpu_torch.storage import snapshot as snapmod
from merklekv_tpu_torch.utils.tracing import get_metrics

__all__ = ["RebalanceManager", "STATE_CODES", "main"]

# rebalance.state gauge codes: donor phases count up 1..7, joiner phases
# live in the 10s, and every terminal failure mode is negative — a fleet
# scrape can tell "mid-flip" (3-5) from "transfer grinding" (2) from
# "rolled back" (<0) without reading logs.
STATE_CODES = {
    "idle": 0,
    "conscribe": 1,
    "transfer": 2,
    "fence": 3,
    "verify": 4,
    "commit": 5,
    "drop": 6,
    "done": 7,
    "joining": 10,
    "join_fetch": 11,
    "join_live": 12,
    "join_committed": 13,
    "failed": -1,
    "aborted": -2,
    "join_aborted": -3,
}

# Donor-side poll cadence against the joiner, and the session heartbeat
# interval (snapshot pin refresh + progress flight marks) derived from it.
_POLL_S = 0.25
_HEARTBEAT_EVERY = 4  # polls per heartbeat (~1 s)
# Whole-transfer budget: past this the donor aborts (the joiner is dead,
# wedged, or the link is unusable) — the donor served throughout, so the
# cost of an abort is one wasted transfer, never availability.
TRANSFER_DEADLINE_S = 600.0
# Consecutive failed joiner polls before the donor declares it dead.
_POLL_FAILURE_BUDGET = 20
# Post-fence verification: bounded retries while in-flight frames settle.
_VERIFY_ATTEMPTS = 60
# Sibling write-fence TTL: a donor death leaves fences armed, so they
# self-expire (restoring write availability) and probe the donor's epoch
# to decide rollback vs roll-forward.
FENCE_TTL_MS = 30_000
# Joiner resolve budget after losing the donor: poll the donor's PARTMAP
# this long for a commit/rollback verdict before assuming rollback.
_JOIN_RESOLVE_S = float(os.environ.get("MERKLEKV_REBALANCE_RESOLVE_S", 120.0))
# Chunk size + per-chunk pause for the joiner's snapshot fetch. The env
# overrides exist for spawned-process chaos drills (which cannot
# monkeypatch module globals): shrinking the chunk and adding a pause
# holds the transfer window open long enough to kill -9 a side
# mid-stream deterministically.
_SNAP_CHUNK = int(os.environ.get("MERKLEKV_REBALANCE_CHUNK_BYTES", 256 * 1024))
_FETCH_PAUSE_S = float(os.environ.get("MERKLEKV_REBALANCE_FETCH_PAUSE_S", 0.0))
_APPLY_SLAB = 8192


def _range_root_hex(items: list[tuple[bytes, bytes]], engine: str) -> str:
    """Merkle root over sorted (key, value) pairs on the route ``engine``
    (the node's ``[storage] merkle_engine``) picks: donor and joiner must
    compute bit-identical roots for the flip gate, and every route does. A
    device failure is counted and raised (``compute_root_hex``)."""
    return snapmod.compute_root_hex(items, engine=engine)


class RebalanceManager:
    """Per-node rebalance state machine; see module docstring for roles."""

    def __init__(self, node) -> None:
        self._node = node
        self._mu = threading.Lock()
        self._state = "idle"
        self._detail = ""
        self._pending: Optional[PartitionMap] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # sibling fence watchdog
        self._fence_epoch = 0
        self._fence_deadline = 0.0
        self._fence_thread: Optional[threading.Thread] = None
        # joiner session
        self._donor_addr = ""
        self._newpid: Optional[int] = None

    # -- introspection -----------------------------------------------------
    @property
    def _merkle_engine(self) -> str:
        """The route of this node's range roots and snapshot verification:
        its ``[storage] merkle_engine``, as for its own snapshot roots."""
        return self._node._cfg.storage.merkle_engine

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def state_code(self) -> int:
        return STATE_CODES.get(self.state, 0)

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        f = self._fence_thread
        if f is not None:
            f.join(timeout=2)

    def _set_state(self, state: str, detail: str = "") -> None:
        with self._mu:
            self._state = state
            self._detail = detail
        get_metrics().inc(f"rebalance.phase.{state}")
        flight_record("rebalance_phase", phase=state, detail=detail[:120])

    # -- wire dispatch -----------------------------------------------------
    def handle(self, parts: list[str]) -> str:
        """One REBALANCE wire exchange; parts is the tokenized tail after
        the verb. Every malformed request answers ERROR (single line) —
        never an exception into the native dispatch path."""
        if not parts:
            return "ERROR rebalance: missing subcommand\r\n"
        sub = parts[0].upper()
        try:
            if sub == "SPLIT":
                return self._wire_split(parts[1:])
            if sub == "JOIN":
                return self._wire_join(parts[1:])
            if sub == "STATUS":
                return self._wire_status()
            if sub == "FENCE":
                return self._wire_fence(parts[1:])
            if sub == "COMMIT":
                return self._wire_commit(parts[1:])
            if sub == "ABORT":
                return self._wire_abort(parts[1:])
        except (ValueError, PartitionMapError, IndexError) as e:
            return f"ERROR rebalance: {e}\r\n"
        return f"ERROR rebalance: unknown subcommand {parts[0]}\r\n"

    # -- SPLIT (donor) -----------------------------------------------------
    def _wire_split(self, args: list[str]) -> str:
        if len(args) != 3:
            return (
                "ERROR rebalance: SPLIT requires <partition> <epoch> "
                "<replicas>\r\n"
            )
        pid, epoch = int(args[0]), int(args[1])
        replicas = [a.strip() for a in args[2].split(",") if a.strip()]
        node = self._node
        if node._partmap is None:
            return "ERROR rebalance: node is not partitioned\r\n"
        if pid != node._partition_id:
            return (
                f"ERROR rebalance: this node serves partition "
                f"{node._partition_id}, not {pid} (send SPLIT to the "
                "donor)\r\n"
            )
        if epoch != node._partmap.epoch:
            return (
                f"ERROR rebalance: stale epoch {epoch} "
                f"(current {node._partmap.epoch})\r\n"
            )
        if node._storage is None:
            return "ERROR rebalance: donor requires durable storage\r\n"
        if node.replicator is None:
            return "ERROR rebalance: donor requires live replication\r\n"
        if not replicas:
            return "ERROR rebalance: no replicas for the new partition\r\n"
        with self._mu:
            if self._thread is not None and self._thread.is_alive():
                return (
                    f"ERROR rebalance: session already active "
                    f"({self._state})\r\n"
                )
            pending = node._partmap.split(pid, replicas)  # validates
            self._pending = pending
            self._state = "conscribe"
            self._detail = ""
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._run_split,
                args=(node._partmap, pending, pid),
                daemon=True,
                name="mkv-rebalance-donor",
            )
            self._thread.start()
        newpid = pending.count - 1
        return f"OK rebalance started {newpid} {pending.epoch}\r\n"

    def _self_addr(self) -> str:
        host = self._node._cfg.host
        if host in ("", "0.0.0.0", "::"):
            host = "127.0.0.1"
        return f"{host}:{self._node._server.port}"

    def _is_self_addr(self, addr: str) -> bool:
        host, _, port = addr.rpartition(":")
        if port != str(self._node._server.port):
            return False
        cfg_host = self._node._cfg.host
        return host == cfg_host or cfg_host in ("0.0.0.0", "::", "")

    def _joiner_topic(self, newpid: int) -> str:
        prefix = self._node._cfg.replication.topic_prefix
        return f"{prefix}/p{newpid}/events"

    def _run_split(
        self, current: PartitionMap, pending: PartitionMap, pid: int
    ) -> None:
        node = self._node
        newpid = pending.count - 1
        moving = current.moving_range(pid)  # == pending's cell for newpid
        joiner = pending.replicas[newpid][0]
        siblings = [
            a for a in current.replicas[pid] if not self._is_self_addr(a)
        ]
        flight_record(
            "rebalance_start",
            partition=pid,
            new_partition=newpid,
            epoch=pending.epoch,
            joiner=joiner,
        )
        fenced = False
        try:
            # 1. Conscribe FIRST: the joiner must be subscribed (applies
            # held, frames journaled) before the forward arms, and the
            # forward must arm before the snapshot is cut — every write
            # lands in the snapshot, the held stream, or both (LWW makes
            # the overlap idempotent); none can fall between.
            self._set_state("conscribe", joiner)
            self._rpc(
                joiner,
                "JOIN "
                f"{pending.epoch} {pending.count} {newpid} "
                f"{self._self_addr()} {format_map_spec(pending)}",
            )
            rep = node.replicator
            if rep is None:
                raise RuntimeError("replication disabled mid-session")
            topic = self._joiner_topic(newpid)
            base, root, depth, path = moving
            rep.set_range_forward(
                topic, lambda k: key_in_range(k, base, root, depth, path)
            )
            # 2. Fresh snapshot AFTER the forward armed: its state plus
            # the forward stream covers the full write history.
            node._storage.snapshot_now()
            meta = node._storage.donor_meta()
            pinned = meta[0] if isinstance(meta, tuple) else None
            # 3. Transfer: the joiner fetches at its own pace; heartbeat
            # the snapshot pins so a throttled transfer can outlive the
            # 120 s pin TTL.
            self._set_state("transfer", f"snapshot {pinned}")
            self._wait_joiner_live(joiner)
            # 4. Fence the moving cell on every replica of p — writes to
            # moving keys answer the retryable BUSY while reads keep
            # serving; non-moving writes are untouched.
            self._set_state("fence")
            flight_record("rebalance_fence", partition=pid)
            node._server.set_partition_fence(base, root, depth, path)
            fenced = True
            for addr in siblings:
                self._rpc(
                    addr,
                    f"FENCE {pending.epoch} {base} {root} {depth} {path} "
                    f"{FENCE_TTL_MS}",
                    ignore_errors=True,
                )
            # 5. Verify: donor's reference root over the moving range must
            # match the joiner's whole-engine root bit-for-bit.
            self._set_state("verify")
            self._verify_roots(joiner, moving)
            # 6. COMMIT POINT: persist E+1. Everything before this rolls
            # back on a donor kill; everything after rolls forward.
            self._set_state("commit")
            node.adopt_partition_map(pending)
            node._server.clear_partition_fence()
            fenced = False
            flight_record(
                "rebalance_commit", partition=pid, epoch=pending.epoch
            )
            commit_cmd = (
                f"COMMIT {pending.epoch} {pending.count} "
                f"{format_map_spec(pending)}"
            )
            self._rpc(joiner, commit_cmd, ignore_errors=True)
            for addr in siblings:
                self._rpc(addr, commit_cmd, ignore_errors=True)
            # 7. Drop the moved range behind the new guard (which already
            # answers MOVED for it — the quiet delete can never race a
            # resurrecting write).
            self._set_state("drop")
            rep.clear_range_forward()
            self._drop_moved_range(moving, sweep_to=None)
            self._set_state("done")
            flight_record(
                "rebalance_done", partition=pid, epoch=pending.epoch
            )
            get_metrics().inc("rebalance.splits_completed")
        except Exception as e:
            self._abort_split(
                reason=str(e),
                fenced=fenced,
                siblings=siblings,
                joiner=joiner,
                epoch=pending.epoch,
            )
        finally:
            with self._mu:
                self._pending = None

    def _rpc(
        self, addr: str, subcommand: str, ignore_errors: bool = False
    ) -> Optional[str]:
        host, _, port = addr.rpartition(":")
        try:
            with MerkleKVClient(host, int(port), timeout=5.0) as c:
                return c.rebalance(subcommand)
        except (MerkleKVError, OSError, ValueError):
            if ignore_errors:
                # COMMIT/ABORT fan-out is best-effort by design: a dead
                # sibling heals through its fence TTL probe (or the boot
                # sweep), a dead joiner through its resolve loop.
                get_metrics().inc("rebalance.rpc_errors")
                return None
            raise

    def _poll_status(self, addr: str) -> tuple[str, int, str]:
        """One REBALANCE STATUS exchange -> (state, epoch, root_hex)."""
        resp = self._rpc(addr, "STATUS")
        fields = (resp or "").split(" ")
        if len(fields) != 4 or fields[0] != "REBALSTATUS":
            raise ProtocolError(f"malformed REBALSTATUS: {resp!r}")
        try:
            epoch = int(fields[2])
        except ValueError:
            raise ProtocolError(f"malformed REBALSTATUS: {resp!r}") from None
        return fields[1], epoch, fields[3]

    def _wait_joiner_live(self, joiner: str) -> None:
        deadline = time.monotonic() + TRANSFER_DEADLINE_S
        failures = 0
        polls = 0
        while True:
            if self._stop_evt.is_set():
                raise RuntimeError("node stopping")
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"transfer deadline ({TRANSFER_DEADLINE_S:.0f}s) "
                    "exceeded"
                )
            try:
                state, _, _ = self._poll_status(joiner)
                failures = 0
            except (MerkleKVError, OSError) as e:
                failures += 1
                if failures >= _POLL_FAILURE_BUDGET:
                    raise RuntimeError(f"joiner unreachable: {e}")
                time.sleep(_POLL_S)
                continue
            if state == "join_live":
                return
            if state in ("join_aborted", "idle", "failed"):
                raise RuntimeError(f"joiner gave up (state {state})")
            polls += 1
            if polls % _HEARTBEAT_EVERY == 0:
                # Session heartbeat: keep every donor snapshot artifact
                # pinned while the transfer is alive, however slowly the
                # joiner pulls chunks.
                node = self._node
                if node._storage is not None:
                    node._storage.refresh_pin()
            time.sleep(_POLL_S)

    def _moving_items(
        self, moving: tuple[int, int, int, int]
    ) -> list[tuple[bytes, bytes]]:
        base, root, depth, path = moving
        return [
            (k, v)
            for k, v in self._node._engine.snapshot()
            if key_in_range(k, base, root, depth, path)
        ]

    def _verify_roots(
        self, joiner: str, moving: tuple[int, int, int, int]
    ) -> None:
        """Post-fence flip gate: flush the forward stream, then compare
        the donor's moving-range reference root with the joiner's engine
        root until they are bit-identical (bounded retries let in-flight
        frames settle). Equality is the zero-loss proof: the joiner holds
        exactly the donor's moving keys, bit for bit."""
        rep = self._node.replicator
        last = ("", "")
        for attempt in range(_VERIFY_ATTEMPTS):
            if self._stop_evt.is_set():
                raise RuntimeError("node stopping")
            if rep is not None:
                rep.flush()
            mine = _range_root_hex(
                self._moving_items(moving), self._merkle_engine
            )
            _, _, theirs = self._poll_status(joiner)
            if mine == theirs:
                flight_record(
                    "rebalance_verified", root=mine[:16], attempts=attempt + 1
                )
                return
            last = (mine, theirs)
            time.sleep(_POLL_S)
        raise RuntimeError(
            f"range roots diverged after {_VERIFY_ATTEMPTS} attempts "
            f"(donor {last[0][:16]} joiner {last[1][:16]})"
        )

    def _drop_moved_range(
        self,
        moving: tuple[int, int, int, int],
        sweep_to: Optional[str],
    ) -> int:
        """Drop every moved-range key (quiet deletes: no replication echo,
        no WAL churn — the new guard plus the boot-time sweep make the
        range unreachable). When ``sweep_to`` names the joiner's topic,
        first forward the residue at its stored timestamps: that closes
        the window where a sibling held a moving-range write the donor's
        double-apply never saw (a QoS-0 frame drop mid-transfer)."""
        node = self._node
        engine = node._engine
        base, root, depth, path = moving
        items = self._moving_items(moving)
        rep = node.replicator
        if sweep_to is not None and rep is not None and items:
            ts_map = dict(engine.key_timestamps())
            events = [
                ChangeEvent(
                    op=OpKind.SET,
                    key=k.decode("utf-8", "surrogateescape"),
                    val=v,
                    ts=ts_map.get(k, 0),
                    src=rep.node_id,
                )
                for k, v in items
            ]
            events += [
                ChangeEvent(
                    op=OpKind.DEL,
                    key=k.decode("utf-8", "surrogateescape"),
                    val=None,
                    ts=ts,
                    src=rep.node_id,
                )
                for k, ts in engine.tombstones()
                if key_in_range(k, base, root, depth, path)
            ]
            rep.forward_events(sweep_to, events)
            get_metrics().inc("rebalance.swept_events", len(events))
        dropped = 0
        pairs = []
        for k, _ in items:
            if engine.delete_quiet(k):
                dropped += 1
                pairs.append((k, None))
        with node._rep_mu:
            mirror = node._mirror
        if mirror is not None and pairs:
            # Quiet deletes bypass the event queue — tell the device
            # mirror directly so HASH stays truthful post-flip.
            mirror.apply_batch(pairs)
        if node._storage is not None:
            node._storage.request_snapshot()
        get_metrics().inc("rebalance.keys_dropped", dropped)
        flight_record("rebalance_dropped", keys=dropped)
        return dropped

    def _abort_split(
        self,
        reason: str,
        fenced: bool,
        siblings: list[str],
        joiner: str,
        epoch: int,
    ) -> None:
        node = self._node
        rep = node.replicator
        if rep is not None:
            rep.clear_range_forward()
        if fenced:
            node._server.clear_partition_fence()
        for addr in siblings:
            self._rpc(addr, f"ABORT {epoch}", ignore_errors=True)
        self._rpc(joiner, f"ABORT {epoch}", ignore_errors=True)
        self._set_state("failed", reason)
        flight_record("rebalance_abort", reason=reason[:160], epoch=epoch)
        get_metrics().inc("rebalance.splits_aborted")

    # -- JOIN (joiner) -----------------------------------------------------
    def _wire_join(self, args: list[str]) -> str:
        if len(args) != 5:
            return (
                "ERROR rebalance: JOIN requires <epoch> <count> <pid> "
                "<donor> <mapspec>\r\n"
            )
        epoch, count, newpid = int(args[0]), int(args[1]), int(args[2])
        donor, mapspec = args[3], args[4]
        node = self._node
        if node._partmap is not None:
            return (
                "ERROR rebalance: node already serves partition "
                f"{node._partition_id} (joiners must be reserve nodes)\r\n"
            )
        with self._mu:
            if self._thread is not None and self._thread.is_alive():
                return (
                    f"ERROR rebalance: session already active "
                    f"({self._state})\r\n"
                )
        pending = parse_map_spec(mapspec, count, epoch)
        if not 0 <= newpid < pending.count:
            return f"ERROR rebalance: pid {newpid} out of range\r\n"
        if not any(
            self._is_self_addr(a) for a in pending.replicas[newpid]
        ):
            return (
                "ERROR rebalance: this node is not a replica of "
                f"partition {newpid} in the offered map\r\n"
            )
        # Idempotent conscription: a reserve re-joining after a crashed
        # attempt wipes its leftovers. TRUNCATE journals, so a joiner
        # restart mid-join recovers empty too.
        node._engine.truncate()
        node._server.set_serving(False)
        node._partmap = pending
        node._partition_id = newpid
        node._install_partition_guard()
        err = node._enable_replication()
        if err is not None:
            # Undo conscription: without the forward stream the transfer
            # cannot be gap-free.
            self._reset_to_reserve()
            return f"ERROR rebalance: {err}\r\n"
        rep = node.replicator
        rep.hold_applies()
        with self._mu:
            self._donor_addr = donor
            self._newpid = newpid
            self._pending = pending
            self._state = "joining"
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._run_join,
                args=(pending, newpid, donor),
                daemon=True,
                name="mkv-rebalance-joiner",
            )
            self._thread.start()
        flight_record(
            "rebalance_join", partition=newpid, epoch=epoch, donor=donor
        )
        return "OK joining\r\n"

    def _reset_to_reserve(self) -> None:
        """Wipe conscripted state back to an idle reserve node."""
        node = self._node
        node._disable_replication()
        node._engine.truncate()
        node._partmap = None
        node._partition_id = None
        node._server.set_partition(0, 0, 0)
        node._server.set_serving(True)

    def _run_join(
        self, pending: PartitionMap, newpid: int, donor: str
    ) -> None:
        node = self._node
        moving = (pending.hash_base, *pending.assignment(newpid))
        try:
            self._set_state("join_fetch", donor)
            blob, root_hex = self._fetch_snapshot(donor)
            snap = snapmod.parse_snapshot_bytes(blob)
            if snap.root_hex != root_hex:
                raise snapmod.SnapshotCorruptError(
                    "stamped root changed mid-transfer"
                )
            snapmod.verify_snapshot(snap, engine=self._merkle_engine)
            self._install_filtered(snap, moving)
            rep = node.replicator
            if rep is not None:
                rep.release_applies()
            self._set_state("join_live")
            flight_record("rebalance_join_live", partition=newpid)
            # Stay resident watching the donor: COMMIT/ABORT normally
            # arrives over the wire; if the donor dies instead, its
            # restarted PARTMAP epoch is the verdict.
            self._watch_donor(pending, newpid, donor)
        except Exception as e:
            if self.state not in ("join_committed", "done"):
                self._abort_join(str(e))

    def _fetch_snapshot(self, donor: str) -> tuple[bytes, str]:
        """SNAPMETA/SNAPCHUNK fetch loop against the donor (the
        bootstrap path's wire, reused verbatim): per-offset retries under
        BOOTSTRAP_FETCH, reconnect on transport death, integrity enforced
        per chunk by the client and end-to-end by the stamped root."""
        host, _, port = donor.rpartition(":")
        policy = BOOTSTRAP_FETCH
        deadline = time.monotonic() + TRANSFER_DEADLINE_S
        client: Optional[MerkleKVClient] = None

        def connect() -> MerkleKVClient:
            return MerkleKVClient(
                host, int(port), timeout=policy.op_timeout
            ).connect()

        try:
            client = connect()
            # Donor freshness gate: wait out the donor's conscribe phase
            # (its post-forward-arm snapshot) so we never ship an
            # artifact cut before the double-apply armed.
            while True:
                if time.monotonic() >= deadline:
                    raise RuntimeError("donor never reached transfer phase")
                state, _, _ = self._poll_status(donor)
                if state in ("transfer", "fence", "verify"):
                    break
                if state in ("failed", "aborted", "idle", "done"):
                    raise RuntimeError(f"donor session gone (state {state})")
                time.sleep(_POLL_S)
            while True:
                try:
                    seq, _, size, root_hex = client.snap_meta()
                    break
                except ProtocolError as e:
                    if "retry" not in str(e):
                        raise
                    if time.monotonic() >= deadline:
                        raise RuntimeError("donor snapshot never built")
                    time.sleep(_POLL_S)
            chunks: list[bytes] = []
            offset = 0
            while offset < size:
                if self._stop_evt.is_set():
                    raise RuntimeError("node stopping")
                if time.monotonic() >= deadline:
                    raise RuntimeError("transfer deadline exceeded")
                for attempt in range(policy.attempts or 1):
                    try:
                        raw = client.snap_chunk(seq, offset, _SNAP_CHUNK)
                        break
                    except (
                        ClientConnectionError,
                        ChunkIntegrityError,
                        OSError,
                    ):
                        if attempt + 1 >= (policy.attempts or 1):
                            raise
                        try:
                            client.close()
                        except Exception:
                            pass
                        time.sleep(policy.backoff(attempt))
                        client = connect()
                if not raw:
                    raise RuntimeError(
                        f"snapshot {seq} truncated at {offset}/{size}"
                    )
                chunks.append(raw)
                offset += len(raw)
                get_metrics().inc("rebalance.fetch_bytes", len(raw))
                if _FETCH_PAUSE_S:
                    time.sleep(_FETCH_PAUSE_S)
            return b"".join(chunks), root_hex
        finally:
            if client is not None:
                client.close()

    def _install_filtered(
        self, snap, moving: tuple[int, int, int, int]
    ) -> None:
        """Apply the moving-range subset of a VERIFIED donor snapshot:
        sets and tombstones at their exact stamped timestamps, in slabs,
        feeding the mirror + WAL through the same hook bootstrap uses."""
        node = self._node
        base, root, depth, path = moving
        triples = [
            (k, v, ts)
            for k, v, ts in snap.items
            if key_in_range(k, base, root, depth, path)
        ] + [
            (k, None, ts)
            for k, ts in snap.tombstones
            if key_in_range(k, base, root, depth, path)
        ]
        installed = 0
        for i in range(0, len(triples), _APPLY_SLAB):
            slab = triples[i : i + _APPLY_SLAB]
            node._engine.apply_batch(slab)
            node._on_bootstrap_applied(slab)
            installed += len(slab)
        get_metrics().inc("rebalance.keys_installed", installed)
        flight_record("rebalance_installed", keys=installed)

    def _wire_status(self) -> str:
        with self._mu:
            state = self._state
            pending = self._pending
        epoch = (
            pending.epoch
            if pending is not None
            else (
                self._node._partmap.epoch
                if self._node._partmap is not None
                else 0
            )
        )
        root = "-"
        if state == "join_live":
            # The joiner's whole engine IS the moving range: its root is
            # the donor's flip gate, bit-identical on every route.
            root = _range_root_hex(
                self._node._engine.snapshot(), self._merkle_engine
            )
        return f"REBALSTATUS {state} {epoch} {root}\r\n"

    # Donor-role phases that mean "session still running — keep waiting".
    _ACTIVE_DONOR_STATES = frozenset(
        ("conscribe", "transfer", "fence", "verify", "commit", "drop")
    )

    def _watch_donor(
        self, pending: PartitionMap, newpid: int, donor: str
    ) -> None:
        """join_live residency: normally COMMIT/ABORT arrives over the
        wire. If the donor dies instead, its restarted state is the
        verdict — REBALSTATUS epoch >= pending (or phase ``done``) means
        the flip persisted before the death: roll forward (self-commit).
        An idle/failed donor still at the old epoch means the session
        evaporated: roll back to reserve (self-abort). Silence past the
        resolve budget is treated as rollback — the conservative verdict,
        since a commit the joiner misses only costs a re-run while a
        phantom commit would double-own the range."""
        host, _, port = donor.rpartition(":")
        unreachable_since: Optional[float] = None
        while not self._stop_evt.is_set():
            if self.state != "join_live":
                return  # COMMIT/ABORT arrived over the wire
            try:
                dstate, depoch, _ = self._poll_status(donor)
                unreachable_since = None
                if dstate in self._ACTIVE_DONOR_STATES:
                    # Mid-session the donor's STATUS carries the PENDING
                    # epoch — not a commit signal. Checked first, or the
                    # joiner would self-commit before verification.
                    pass
                elif dstate == "done" or depoch >= pending.epoch:
                    # The donor persisted the flip but its COMMIT
                    # broadcast never reached us: roll forward.
                    self._commit_join(pending, depoch)
                    return
                else:
                    # Reachable, not mid-session, old epoch: the session
                    # is gone (abort, or a crash-restart at E).
                    self._abort_join(
                        f"donor session gone (state {dstate}, "
                        f"epoch {depoch})"
                    )
                    return
            except (MerkleKVError, OSError, ValueError):
                now = time.monotonic()
                if unreachable_since is None:
                    unreachable_since = now
                elif now - unreachable_since > _JOIN_RESOLVE_S:
                    self._abort_join("donor unreachable past resolve budget")
                    return
            time.sleep(_POLL_S * 4)

    def _commit_join(self, pending: PartitionMap, epoch: int) -> None:
        node = self._node
        with self._mu:
            if self._state == "join_committed":
                return
        node.adopt_partition_map(pending)
        node._server.set_serving(True)
        self._set_state("join_committed")
        flight_record(
            "rebalance_join_commit",
            partition=node._partition_id,
            epoch=epoch,
        )
        get_metrics().inc("rebalance.joins_committed")

    def _abort_join(self, reason: str) -> None:
        self._reset_to_reserve()
        self._set_state("join_aborted", reason)
        flight_record("rebalance_join_abort", reason=reason[:160])
        get_metrics().inc("rebalance.joins_aborted")

    # -- FENCE / COMMIT / ABORT (sibling + joiner wire side) ---------------
    def _wire_fence(self, args: list[str]) -> str:
        if len(args) != 6:
            return (
                "ERROR rebalance: FENCE requires <epoch> <base> <root> "
                "<depth> <path> <ttl_ms>\r\n"
            )
        epoch = int(args[0])
        base, root, depth = int(args[1]), int(args[2]), int(args[3])
        path, ttl_ms = int(args[4]), int(args[5])
        node = self._node
        if node._partmap is None:
            return "ERROR rebalance: node is not partitioned\r\n"
        if epoch != node._partmap.epoch + 1:
            return (
                f"ERROR rebalance: fence epoch {epoch} does not extend "
                f"current {node._partmap.epoch}\r\n"
            )
        node._server.set_partition_fence(base, root, depth, path)
        with self._mu:
            self._fence_epoch = epoch
            self._fence_deadline = time.monotonic() + ttl_ms / 1000.0
            if self._fence_thread is None or not self._fence_thread.is_alive():
                self._fence_thread = threading.Thread(
                    target=self._fence_watchdog,
                    daemon=True,
                    name="mkv-rebalance-fence",
                )
                self._fence_thread.start()
        flight_record("rebalance_fenced", epoch=epoch, ttl_ms=ttl_ms)
        return "OK fenced\r\n"

    def _fence_watchdog(self) -> None:
        """Sibling-side fence TTL: a donor death must not leave moving-
        range writes refused forever. On expiry, clear the fence and probe
        the donor group's epoch — adopt a newer committed map (roll
        forward: sweep + drop) or stand down at the current one (the
        rollback)."""
        while not self._stop_evt.is_set():
            with self._mu:
                deadline = self._fence_deadline
                epoch = self._fence_epoch
            if deadline == 0.0:
                return  # disarmed by COMMIT/ABORT
            wait = deadline - time.monotonic()
            if wait > 0:
                time.sleep(min(wait, 0.5))
                continue
            node = self._node
            node._server.clear_partition_fence()
            with self._mu:
                self._fence_deadline = 0.0
            flight_record("rebalance_fence_expired", epoch=epoch)
            get_metrics().inc("rebalance.fence_expiries")
            self._probe_epoch_after_expiry(epoch)
            return

    def _probe_epoch_after_expiry(self, pending_epoch: int) -> None:
        """Ask the replica group whether the flip committed while this
        sibling was out of the loop (donor died between persisting E+1
        and broadcasting COMMIT). Bounded probe; adoption reuses the
        COMMIT path so the sweep + drop still run."""
        node = self._node
        if node._partmap is None:
            return
        peers = [
            a
            for a in node._partmap.replicas[node._partition_id]
            if not self._is_self_addr(a)
        ]
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not self._stop_evt.is_set():
            for addr in peers:
                host, _, port = addr.rpartition(":")
                try:
                    with MerkleKVClient(host, int(port), timeout=2.0) as c:
                        m = c.partition_map()
                except (MerkleKVError, OSError, ValueError):
                    continue
                if m.epoch >= pending_epoch:
                    self._adopt_committed(m)
                    return
                # A reachable peer still at the old epoch IS the verdict:
                # the flip rolled back.
                flight_record(
                    "rebalance_fence_rollback", epoch=pending_epoch
                )
                return
            time.sleep(1.0)

    def _adopt_committed(self, pmap: PartitionMap) -> None:
        """Sibling-side adoption of a committed split: install the map,
        sweep-forward the moved residue to the joiner, drop the range."""
        node = self._node
        if node._partmap is not None and pmap.epoch <= node._partmap.epoch:
            return
        newpid = pmap.count - 1
        node.adopt_partition_map(pmap)
        moving = (pmap.hash_base, *pmap.assignment(newpid))
        self._drop_moved_range(moving, sweep_to=self._joiner_topic(newpid))

    def _wire_commit(self, args: list[str]) -> str:
        if len(args) != 3:
            return (
                "ERROR rebalance: COMMIT requires <epoch> <count> "
                "<mapspec>\r\n"
            )
        epoch, count, mapspec = int(args[0]), int(args[1]), args[2]
        node = self._node
        pmap = parse_map_spec(mapspec, count, epoch)
        with self._mu:
            joining = self._state in ("joining", "join_fetch", "join_live")
            self._fence_deadline = 0.0  # disarm the watchdog
        if joining:
            self._commit_join(pmap, epoch)
            return "OK committed\r\n"
        if node._partmap is None:
            return "ERROR rebalance: node is not partitioned\r\n"
        if epoch <= node._partmap.epoch:
            return "OK committed\r\n"  # idempotent re-delivery
        node._server.clear_partition_fence()
        self._adopt_committed(pmap)
        return "OK committed\r\n"

    def _wire_abort(self, args: list[str]) -> str:
        epoch = int(args[0]) if args else 0
        node = self._node
        with self._mu:
            joining = self._state in ("joining", "join_fetch", "join_live")
            self._fence_deadline = 0.0  # disarm the watchdog
        if joining:
            self._stop_evt.set()  # stop the fetch/watch thread
            t = self._thread
            if t is not None and t is not threading.current_thread():
                t.join(timeout=10)
            self._stop_evt.clear()
            self._abort_join(f"donor aborted (epoch {epoch})")
        else:
            node._server.clear_partition_fence()
            flight_record("rebalance_abort_received", epoch=epoch)
        return "OK aborted\r\n"


# -- operator CLI ----------------------------------------------------------


def main(argv=None) -> int:
    """``python -m merklekv_tpu_torch rebalance``: drive one online split.

    Sends ``REBALANCE SPLIT`` to the donor (the node currently serving
    ``--partition``) and tails the session's phases until it lands in
    done / failed — the operator-facing shape of docs/DEPLOYMENT.md
    "Online rebalancing".
    """
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="merklekv_tpu_torch rebalance")
    p.add_argument(
        "--donor",
        required=True,
        help="host:port of the node serving the partition to split",
    )
    p.add_argument(
        "--partition",
        type=int,
        required=True,
        help="partition id to split (the donor must serve it)",
    )
    p.add_argument(
        "--joiner",
        required=True,
        help="comma-separated host:port replica set for the NEW "
        "partition; each must be a running reserve node",
    )
    p.add_argument(
        "--timeout",
        type=float,
        default=TRANSFER_DEADLINE_S + 60,
        help="give up tailing after this many seconds (the session "
        "itself keeps its own deadline)",
    )
    args = p.parse_args(argv)
    host, _, port = args.donor.rpartition(":")
    try:
        with MerkleKVClient(host, int(port), timeout=10.0) as c:
            epoch = c.partition_map().epoch
            resp = c.rebalance(
                f"SPLIT {args.partition} {epoch} {args.joiner}"
            )
    except (MerkleKVError, OSError, ValueError) as e:
        print(f"rebalance: {e}", file=sys.stderr)
        return 1
    print(resp)
    last = ""
    deadline = time.monotonic() + args.timeout
    while time.monotonic() < deadline:
        try:
            with MerkleKVClient(host, int(port), timeout=5.0) as c:
                fields = c.rebalance("STATUS").split(" ")
        except (MerkleKVError, OSError):
            time.sleep(1.0)
            continue
        state = fields[1] if len(fields) >= 2 else "?"
        if state != last:
            print(f"phase: {state}")
            last = state
        if state == "done":
            return 0
        if state in ("failed", "aborted", "idle"):
            print("rebalance did not commit (session rolled back); "
                  "the cluster is unchanged", file=sys.stderr)
            return 1
        time.sleep(0.5)
    print("rebalance: tail timeout (session may still be running)",
          file=sys.stderr)
    return 1
