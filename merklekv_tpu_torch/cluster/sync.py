"""Anti-entropy: make the local store converge to a remote peer.

A copy of ``merklekv_tpu/cluster/sync.py``, its imports pointed at the
port's modules, with its three device sites on torch:

  - the local leaf pass (``_leaf_map_device``) hashes with
    ``merkle/torch_engine.leaf_digests`` on the node's device (the leaf
    kernel on the card);
  - the N-replica masks go through the port's ``divergence_masks_engine``;
  - the pairwise diff (``_diff``) is the port's ``diff_keys_pair`` on the
    node's device.

Which route a cycle takes keeps the reference's rule (``_use_device``:
``"tpu"`` always, ``"auto"`` from ``MKV_DEVICE_THRESHOLD`` union keys on,
``"cpu"`` never); both routes compute the same answer. What changed is a
failure on the device route: the reference set a sticky process-wide flag
and went on on the host, the port counts it in ``device.fallbacks`` and
re-raises it, so the cycle fails and the next one tries the device again.
The node's device is ``utils/deviceenv.py``'s (``MERKLEKV_TORCH_DEVICE``,
unset meaning CUDA) unless the manager is given one.

Reference analog: the reference's src/sync.rs. Its hot loops are pathological:
snapshotting rebuilds the Merkle tree per insert (O(n^2 log n) hashing,
sync.rs:104-119) and every remote key is GET over a FRESH TCP connection
(sync.rs:192-214). Here:

  - the local snapshot is one native-engine export (sorted, no hashing on
    insert);
  - the remote snapshot is one connection: SCAN + batched MGET;
  - leaf hashing is batched — hashlib for small keyspaces, the device
    engine (one leaf-kernel launch) beyond a threshold;
  - the diff is the device multi-replica comparison (merkle/diff.py);
  - the periodic loop is actually wired (the reference's start_sync_loop is
    dead code, sync.rs:90-99).

Semantics match sync_once: one-way local := remote for every divergent key
(sync.rs:74-83), including deletion of local-only keys.

Transfer strategy (the fix for the reference's core flaw — its README
documents an O(log n) hash-walk, README.md:310-372, but the code ships the
entire keyspace as values on every divergence, sync.rs:150-214):

  1. root compare — equal roots, zero transfer;
  2. LEAFHASHES — fetch per-key digests (32 bytes/key, not values), diff,
     then MGET only the divergent keys; bandwidth is proportional to
     divergence, not keyspace size;
  3. ``--full`` (or a peer without LEAFHASHES) — full snapshot transfer,
     the reference behavior, kept as an explicit escape hatch;
  4. ``--verify`` — re-compare Merkle roots after repair; mismatch raises.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from merklekv_tpu_torch.client import (
    MerkleKVClient,
    MerkleKVError,
    MovedError,
    ProtocolError,
)
from merklekv_tpu_torch.cluster.retry import SYNC_PEER, Deadline, RetryPolicy
from merklekv_tpu_torch.merkle.encoding import leaf_hash
from merklekv_tpu_torch.native_bindings import NativeEngine
from merklekv_tpu_torch.obs import tracewire
from merklekv_tpu_torch.obs.trace import (
    CycleTrace,
    PeerTrace,
    cycle_scope,
    get_trace_buffer,
    next_cycle_id,
)
from merklekv_tpu_torch.utils import deviceenv
from merklekv_tpu_torch.utils.tracing import get_metrics, span

__all__ = ["SyncManager", "SyncReport", "MultiSyncReport", "SyncSession"]

# Below this many union keys the device round-trip costs more than hashlib
# (measured: a 10K-key cycle is ~2.7x faster on the host path even with a
# local chip's dispatch latency amortized — batched SHA-256 only wins once
# the keyspace is large enough to fill the device). Deployments with
# different host/device latency can tune MKV_DEVICE_THRESHOLD.
_DEVICE_THRESHOLD = int(os.environ.get("MKV_DEVICE_THRESHOLD", 1 << 16))


@dataclass
class MultiSyncReport:
    peers: list[str] = field(default_factory=list)
    union_keys: int = 0
    divergent_union: int = 0  # keys where ANY replica disagrees
    # peer -> divergence count vs local; unreachable peers are absent.
    per_peer_divergent: dict[str, int] = field(default_factory=dict)
    set_keys: int = 0
    deleted_keys: int = 0  # keys removed because a peer's tombstone won LWW
    values_fetched: int = 0
    seconds: float = 0.0
    details: list[str] = field(default_factory=list)
    # Peers whose repair stream died mid-cycle: their remaining work is
    # checkpointed as a SyncSession and they are reported to the health
    # monitor; the rest of the cycle proceeds.
    degraded: list[str] = field(default_factory=list)
    resumed_peers: list[str] = field(default_factory=list)


@dataclass
class SyncReport:
    peer: str = ""
    remote_keys: int = 0
    local_keys: int = 0
    divergent: int = 0
    set_keys: int = 0
    deleted_keys: int = 0
    values_fetched: int = 0  # values transferred (== divergent when hash-first)
    # "noop" | "bisect" | "hash-paged" | "hash-first" | "full" |
    # "full-fallback"
    mode: str = ""
    verified: Optional[bool] = None  # post-sync root recheck (--verify)
    resumed: bool = False  # this cycle continued an interrupted session
    # Version-stamp plane (bounded-staleness donors): the engine version
    # the donor's served tree reflected at the last stamped fetch, how far
    # its live engine trailed it, whether this cycle escalated a stale
    # donor tree to a forced refresh, and whether mid-walk churn was
    # absorbed by clipping to the verified frontier instead of abandoning
    # the walk.
    donor_tree_version: int = 0
    donor_tree_lag: int = 0
    forced_refreshes: int = 0
    walk_clipped: bool = False
    seconds: float = 0.0
    # Wire cost of the whole cycle (client-measured request/response bytes,
    # reconnects included) — the number the bisection walk shrinks from
    # O(n) to O(divergence·log n).
    bytes_sent: int = 0
    bytes_received: int = 0
    # Bisection-walk observability: tree nodes compared and walk rounds
    # (one round per level batch of TREELEVEL fetches).
    nodes_compared: int = 0
    rounds: int = 0
    details: list[str] = field(default_factory=list)


@dataclass
class SyncSession:
    """Checkpoint of an interrupted per-peer repair.

    When a peer dies (or an injected fault kills the stream) mid-repair,
    the work already applied stays applied and the REMAINING divergent
    keys are kept here; the next cycle against the peer repairs these
    first — resuming from the last verified leaf instead of restarting
    the whole diff. Conceptually the pending list is the frontier of
    not-yet-verified subtrees: divergent leaves are repaired in sorted
    order, so everything before the checkpoint is an already-converged
    prefix of the tree.
    """

    peer: str
    pending_sets: list[tuple[bytes, int]]  # (key, last-write ts) to fetch
    repaired: int = 0  # keys applied before the interruption
    attempts: int = 0
    # Paged hash-scan resume position (exclusive): every key <= cursor was
    # verified/repaired before the interruption, so the next cycle's walk
    # starts here instead of refetching the whole hash list. b"" = the walk
    # had not begun (or the peer doesn't serve HASHPAGE).
    cursor: bytes = b""
    # Adaptive page size carried across cycles: a walk that died shrinks
    # the next attempt's pages (less exposure per round trip on a hostile
    # link); clean pages grow it back toward the configured maximum.
    # 0 = start from the SyncManager default.
    page_size: int = 0
    # The interrupted cycle was a bisection walk: resume re-enters the walk
    # (clipping already-verified intervals at the cursor) instead of the
    # paged scan — mode is sticky across a resume so a hostile link can't
    # silently downgrade the transfer strategy.
    walk: bool = False
    created_unix: float = field(default_factory=time.time)


# A session that keeps failing (or outlives remote churn) is abandoned and
# the next cycle runs a fresh full diff — resume is an optimization, never
# a correctness dependency (the root compare after resume re-verifies).
_SESSION_MAX_ATTEMPTS = 8
_SESSION_MAX_AGE_S = 600.0


def _leaf_map_device(
    items: list[tuple[bytes, bytes]], device=None
) -> dict[bytes, bytes]:
    """Leaf digests of ``items`` hashed on ``device`` (``None``: the node's
    device from ``utils/deviceenv.py``)."""
    from merklekv_tpu_torch.merkle.torch_engine import leaf_digests
    from merklekv_tpu_torch.ops.sha256 import digests_to_bytes
    from merklekv_tpu_torch.utils.torchenv import words_np

    dev = deviceenv.resolve() if device is None else device
    digests = leaf_digests([k for k, _ in items], [v for _, v in items], device=dev)
    return dict(zip((k for k, _ in items), digests_to_bytes(words_np(digests))))


def _leaf_map(
    items: list[tuple[bytes, bytes]], use_device: bool, device=None
) -> dict[bytes, bytes]:
    if use_device:
        try:
            return _leaf_map_device(items, device)
        except Exception as e:
            # Counted and re-raised: the cycle fails, the next one tries
            # the device again (never a silent host answer).
            deviceenv.note_device_failure(e, "leaf hashing")
            raise
    return {k: leaf_hash(k, v) for k, v in items}


def _decode_leaf_map(
    raw: dict[str, tuple[Optional[str], int]]
) -> dict[bytes, tuple[Optional[bytes], int]]:
    """LEAFHASHES wire payload -> {key bytes: (digest bytes | None, ts)}.

    A None digest is a TOMBSTONE: the peer deleted the key at ts, and that
    deletion competes in LWW arbitration like any write."""
    return {
        k.encode("utf-8", "surrogateescape"): (
            bytes.fromhex(h) if h is not None else None,
            ts,
        )
        for k, (h, ts) in raw.items()
    }


class SyncManager:
    def __init__(
        self,
        engine: NativeEngine,
        device: str = "auto",  # "auto" | "cpu" | "tpu"
        mget_batch: int = 512,
        timeout: Optional[float] = None,
        # Callable[[bytes, Optional[bytes], Optional[int]], None]:
        # (key, value|None, LWW ts|None). The ts is the EXACT timestamp
        # the repair installed (peer write ts / tombstone ts), so a WAL
        # can journal it without a racy engine read-back; None means the
        # repair carried no ordering metadata (legacy full transfer,
        # delete_quiet absence copy).
        repair_listener=None,
        retry: Optional[RetryPolicy] = None,
        on_peer_degraded: Optional[Callable[[str, str], None]] = None,
        hash_page: int = 512,
        mode: str = "auto",
        bisect_threshold: int = 8192,
        on_cycle_converged: Optional[Callable[[], None]] = None,
        # LWW clock-skew guard at the repair-install boundary, same bound
        # as the replicator's ([replication] max_skew_ms). Without it a
        # future-poisoned timestamp clamped on the replication path would
        # simply RE-ENTER through anti-entropy: the poisoning peer still
        # holds the raw ts in its engine, and a walk/arbitration against
        # it would install that ts here, re-fencing the key. 0 disables.
        max_skew_ms: int = 0,
        # Bounded-trailing tolerance for stamped donors ([device]
        # max_staleness_versions): a donor whose served tree reports a lag
        # past this many engine mutations gets ONE forced-refresh re-probe
        # before the walk descends (its pump is presumed wedged or swamped;
        # walking a deeply stale tree would repair against ancient state).
        # 0 selects the default.
        tree_lag_limit: int = 0,
        # Partitioned cluster mode: the partition this node owns. When
        # set, every HASH/TREELEVEL the walk sends carries the pt=<pid>
        # address, so a peer that no longer owns this partition (stale
        # routing, mid-rebalance) answers ERROR MOVED instead of serving
        # a DIFFERENT partition's tree — a walk comparing against the
        # wrong partition would quietly mirror its whole keyspace as
        # divergence. None = unpartitioned (no token).
        partition_id: "Optional[int]" = None,
        # The torch device of the device route; None resolves the node's
        # (utils/deviceenv.py) at the first device call, so a manager that
        # never takes that route never imports torch.
        torch_device=None,
    ) -> None:
        self._engine = engine
        self._device = device
        self._torch_device = torch_device
        self._partition_id = partition_id
        self._mget_batch = mget_batch
        # Pairwise transfer strategy when roots differ: "auto" bisects the
        # tree (TREELEVEL walk) once the local keyspace reaches
        # bisect_threshold keys and pages below it; "bisect"/"page" force a
        # strategy. A peer without TREELEVEL always degrades to paging.
        self._mode = mode
        self._bisect_threshold = bisect_threshold
        # Keys per HASHPAGE fetch in the paged pairwise walk. Smaller pages
        # bound how much verified progress one dead stream can destroy (a
        # page is the resume granularity); larger pages amortize round
        # trips on clean links.
        self._hash_page = hash_page
        # Per-op timeout / connect retries / per-peer cycle deadline come
        # from ONE policy object (cluster/retry.py) instead of scattered
        # constants; an explicit timeout still wins for callers that need
        # a different socket budget.
        self._retry = retry if retry is not None else SYNC_PEER
        self._timeout = timeout if timeout is not None else self._retry.op_timeout
        # Repairs write through the engine bindings, bypassing the server's
        # event queue — anything mirroring the keyspace (the device Merkle
        # tree) must be told explicitly or it serves stale roots forever.
        self._repair_listener = repair_listener
        # Mid-sync failure hook: the peer is reported degraded (health.py
        # flips its table entry) while its checkpointed session waits.
        self._on_peer_degraded = on_peer_degraded
        # Convergence hook for the lag plane (obs/lag.py): fired by the
        # periodic loop after a FULL CLEAN PASS — every configured peer
        # synced this round with no exception, checkpoint, degradation,
        # or down-peer skip. Only full coverage may clear dropped-frame
        # lag residue: a single pairwise cycle against peer A proves
        # nothing about events a partitioned peer B published (A may be
        # missing them too), so firing per cycle would mask exactly the
        # divergence the SLO exists to surface.
        self._on_cycle_converged = on_cycle_converged
        self._max_skew_ns = max(0, int(max_skew_ms)) * 1_000_000
        self._tree_lag_limit = (
            int(tree_lag_limit) if tree_lag_limit > 0
            else self._DEFAULT_TREE_LAG_LIMIT
        )
        self._sessions: dict[str, SyncSession] = {}
        # First-checkpoint time per peer, surviving resume/re-checkpoint
        # churn: a re-checkpoint builds a fresh SyncSession, and without
        # this the 10-minute abandonment clock would restart every cycle.
        self._session_born: dict[str, float] = {}
        # Peers degraded during the current cycle — lets the loop's
        # catch-all skip a second, reason-losing _degrade for failures the
        # cycle already reported.
        self._degraded_this_cycle: set[str] = set()
        self._loop_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_report: Optional[SyncReport] = None
        self.last_multi_report: Optional[MultiSyncReport] = None

    # -- causal tracing -------------------------------------------------------
    @staticmethod
    def _cycle_trace_scope():
        """(scope, ctx) — a fresh trace root for one anti-entropy cycle,
        or a no-op scope with ctx None when propagation is disabled
        ([observability] trace_propagation). The ctx rides separately
        because the cycle summary is appended AFTER the scope exits (the
        flight recorder stamps its trace id for cross-node spill joins)."""
        import contextlib

        if not tracewire.propagation_enabled():
            return contextlib.nullcontext(), None
        scope = tracewire.trace_scope(tracewire.new_context())
        return scope, scope.ctx

    def _attach_trace(self, client: MerkleKVClient) -> MerkleKVClient:
        """Give the client the live token provider — every cluster verb it
        sends carries the active trace context — and turn on version
        stamps, so tree fetches report the engine version the donor's
        served tree reflects (both ride the same capability fallback
        against old peers). On a partitioned node the client also carries
        the pt=<pid> partition address (no fallback — see MerkleKVClient.
        partition_id)."""
        client.trace_provider = tracewire.current_token
        client.version_stamps = True
        client.partition_id = self._partition_id
        return client

    @staticmethod
    def _settle_trace_capability(client: MerkleKVClient) -> None:
        """Prove (or disprove) the peer's trace capability with a
        fail-closed zero-width TREELEVEL probe before any verb whose
        trailing token an old peer would misread as a real argument
        (LEAFHASHES prefix, HASHPAGE cursor) — see client._traced_request
        require_settled. No-op when untraced or already settled."""
        if (
            not tracewire.propagation_enabled()
            or tracewire.current() is None
            or client._peer_traced is not None
        ):
            return
        try:
            client.tree_level(0, 0, 0)
        except MovedError:
            # The probe carries the pt= partition address: a MOVED answer
            # means this peer serves a DIFFERENT partition, and every verb
            # the caller would send next (LEAFHASHES/HASHPAGE) is
            # unguarded — surface it, never settle-and-continue.
            raise
        except Exception:
            pass  # capability state is settled either way

    # -- failure bookkeeping --------------------------------------------------
    def _degrade(self, peer: str, reason: str) -> None:
        get_metrics().inc("anti_entropy.peer_degraded")
        self._degraded_this_cycle.add(peer)
        if self._on_peer_degraded is not None:
            try:
                self._on_peer_degraded(peer, reason)
            except Exception:
                pass  # a broken health hook must never stall repairs

    def session_for(self, peer: str) -> Optional[SyncSession]:
        """The checkpointed session for ``peer`` (introspection/tests)."""
        return self._sessions.get(peer)

    def _checkpoint(
        self,
        peer: str,
        pending: list[tuple[bytes, int]],
        repaired: int,
        attempts: int = 0,
        cursor: bytes = b"",
        page_size: int = 0,
        walk: bool = False,
    ) -> None:
        self._sessions[peer] = SyncSession(
            peer=peer,
            pending_sets=pending,
            repaired=repaired,
            attempts=attempts,
            cursor=cursor,
            page_size=page_size,
            walk=walk,
            created_unix=self._session_born.setdefault(peer, time.time()),
        )
        get_metrics().inc("anti_entropy.sessions_checkpointed")

    def _take_session(self, peer: str) -> Optional[SyncSession]:
        """Pop a resumable session, discarding it when stale/exhausted."""
        sess = self._sessions.pop(peer, None)
        if sess is None:
            return None
        if (
            sess.attempts >= _SESSION_MAX_ATTEMPTS
            or time.time() - sess.created_unix > _SESSION_MAX_AGE_S
        ):
            get_metrics().inc("anti_entropy.sessions_abandoned")
            self._session_born.pop(peer, None)
            return None
        sess.attempts += 1
        return sess

    def _session_done(self, peer: str) -> None:
        """Clear the abandonment clock once no session remains for the
        peer (fully drained or abandoned) — a stale birth time would make
        some future, unrelated session look instantly over-age."""
        if peer not in self._sessions:
            self._session_born.pop(peer, None)

    # -- one-shot ------------------------------------------------------------
    def sync_once(
        self, host: str, port: int, full: bool = False, verify: bool = False
    ) -> SyncReport:
        # Correlated trace: one cycle id for the whole pairwise cycle —
        # every span emitted inside (walk, repairs, journaling) is stamped
        # with it, and the cycle's per-peer outcome lands in the TRACE ring
        # buffer whether the cycle succeeds, degrades, or raises.
        peer = f"{host}:{port}"
        trace = PeerTrace(peer=peer)
        started, t0 = time.time(), time.perf_counter()
        cid = next_cycle_id()
        # Bind the scope so its trace id survives into the finally — the
        # summary is appended after the scope exits, and the flight
        # recorder needs the id for cross-node spill joins.
        tscope, tctx = self._cycle_trace_scope()
        try:
            # Causal trace root for the whole cycle: spans inside stitch
            # under it, and the clients' trace tokens carry it to the peer
            # so the donor's serve spans land under the SAME trace id.
            with tscope, cycle_scope(cid), \
                    span("anti_entropy.sync_once", peer=peer) as rec:
                report = self._sync_once(host, port, full, verify,
                                         trace=trace)
                rec["divergent"] = report.divergent
                get_metrics().inc("anti_entropy.syncs")
                get_metrics().inc("anti_entropy.keys_repaired",
                                  report.set_keys + report.deleted_keys)
                return report
        except Exception as e:
            # A cycle that left a checkpoint is resuming by design —
            # "degraded", not "error" (which means the cycle lost its work).
            trace.outcome = "degraded" if peer in self._sessions else "error"
            if not trace.error:
                trace.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            get_trace_buffer().append(CycleTrace(
                cycle_id=cid, kind="pairwise", started_unix=started,
                seconds=time.perf_counter() - t0, peers=[trace],
                trace_id=tctx.trace_id if tctx is not None else 0,
            ))

    def _sync_once(
        self,
        host: str,
        port: int,
        full: bool,
        verify: bool,
        trace: Optional[PeerTrace] = None,
    ) -> SyncReport:
        t0 = time.perf_counter()
        peer = f"{host}:{port}"
        report = SyncReport(peer=peer)
        deadline = self._retry.deadline()
        self._degraded_this_cycle.discard(peer)

        client = self._attach_trace(
            MerkleKVClient(host, port, timeout=self._timeout)
        )
        try:
            self._retry.run(
                client.connect,
                retry_on=(OSError, MerkleKVError),
                deadline=deadline,
            )
        except Exception as e:
            self._degrade(peer, f"connect failed: {e!r}")
            raise
        try:
            # A previous cycle's interrupted repair resumes FIRST: the
            # checkpointed frontier is repaired from the last verified
            # leaf, then the root compare below re-verifies convergence
            # (resume is a fast-path, never a correctness dependency).
            sess = self._take_session(peer)
            if sess is not None:
                report.resumed = True
                report.details.append(
                    f"resuming session: {len(sess.pending_sets)} pending, "
                    f"{sess.repaired} already repaired, "
                    f"cursor {sess.cursor!r}, attempt {sess.attempts}"
                )
                get_metrics().inc("anti_entropy.sessions_resumed")

            # One cycle survives stream deaths: every failure below leaves
            # a checkpoint (cursor + unapplied page remainder), so instead
            # of surrendering the cycle the loop reconnects — the old
            # socket's desync dies with it — and continues from the
            # checkpoint, until the cycle deadline or reconnect budget is
            # spent. Only then does the error propagate, with the session
            # retained for the NEXT cycle to resume.
            reconnects = 0
            while True:
                try:
                    if sess is not None and sess.pending_sets:
                        # Conditional installs: the checkpoint may be older
                        # than fresh local writes — LWW must still win. A
                        # re-checkpoint on failure carries the scan cursor
                        # forward so the unfinished walk is not lost.
                        self._repair_sets_resumable(
                            client, peer, sess.pending_sets, report,
                            deadline, lww=True,
                            already_repaired=sess.repaired,
                            prior_attempts=sess.attempts, cursor=sess.cursor,
                            walk=sess.walk,
                        )
                        sess.pending_sets = []
                        if peer in self._sessions:
                            # Deadline expired mid-resume: the remainder is
                            # already checkpointed (and the peer degraded);
                            # entering the walk below would see the same
                            # expired deadline and clobber that checkpoint
                            # with an empty pending list.
                            report.seconds = time.perf_counter() - t0
                            self.last_report = report
                            return report

                    # Root comparison on the same connection the snapshot
                    # would use: equal Merkle roots mean equal keyspaces,
                    # so no snapshot travels at all. Skipped when resuming
                    # mid-walk — the unwalked tail makes inequality near
                    # certain, and the probe is one more round trip a
                    # hostile link can kill. (The reference documents a
                    # hash-compare walk but ships full-state transfer
                    # unconditionally — SURVEY §3.4.)
                    mid_walk = sess is not None and sess.cursor != b""
                    if not mid_walk:
                        local_root = self._engine.merkle_root()
                        local_hex = (
                            local_root.hex()
                            if local_root is not None
                            else "0" * 64
                        )
                        try:
                            roots_equal = client.hash() == local_hex
                        except MovedError:
                            # Partition mismatch is a ROUTING refusal, not
                            # a degraded probe: the peer serves a DIFFERENT
                            # partition, and falling through to a transfer
                            # would mirror its disjoint keyspace as
                            # divergence (mass quiet-deletes + foreign
                            # imports). Abort the cycle loudly instead.
                            get_metrics().inc("anti_entropy.moved_peers")
                            raise
                        except Exception as e:
                            # A peer that serves data but not HASH still
                            # syncs — record the degradation, don't hide it.
                            get_metrics().inc("anti_entropy.probe_failures")
                            report.details.append(f"hash probe failed: {e!r}")
                            roots_equal = False
                        if roots_equal:
                            report.mode = "noop"
                            report.verified = True if verify else None
                            report.seconds = time.perf_counter() - t0
                            report.details.append("roots equal; no transfer")
                            self.last_report = report
                            return report

                    if full:
                        report.mode = "full"
                        self._sync_full(client, report)
                    else:
                        start = sess.cursor if sess is not None else b""
                        prior = sess.attempts if sess is not None else 0
                        # Subtree bisection first (mode permitting): walk
                        # the peer's tree top-down, descend only into
                        # divergent subtrees, and fetch leaf hashes +
                        # values for divergent key ranges only — wire
                        # bytes ∝ divergence·log n, not keyspace size.
                        walked, precomputed = False, None
                        if self._want_walk(sess):
                            walked, precomputed = self._sync_bisect(
                                client, report, deadline,
                                start=start, prior_attempts=prior,
                                start_page=(
                                    sess.page_size if sess is not None else 0
                                ),
                            )
                        paged = walked or self._sync_hash_paged(
                            client, report, deadline,
                            start=start,
                            prior_attempts=prior,
                            start_page=(
                                sess.page_size if sess is not None else 0
                            ),
                            precomputed=precomputed,
                        )
                        if not paged:
                            # Peer predates HASHPAGE: monolithic
                            # LEAFHASHES, then full transfer as the last
                            # resort — all-or-nothing paths, kept only for
                            # old peers.
                            remote_hashes = self._fetch_remote_hashes(
                                client, report
                            )
                            if remote_hashes is None:
                                report.mode = "full-fallback"
                                self._sync_full(client, report)
                            else:
                                report.mode = "hash-first"
                                self._sync_hash_first(
                                    client, remote_hashes, report, deadline
                                )
                    break
                except (MerkleKVError, OSError):
                    nsess = self._sessions.pop(peer, None)
                    out_of_budget = (
                        reconnects >= self._MAX_CYCLE_RECONNECTS
                        or deadline.expired()
                        or self._stop.is_set()
                    )
                    if nsess is None or out_of_budget:
                        if nsess is not None:
                            self._sessions[peer] = nsess  # keep for next cycle
                        raise
                    time.sleep(deadline.clamp(
                        self._retry.backoff(reconnects)
                    ))
                    reconnects += 1
                    client.close()
                    try:
                        self._retry.run(
                            client.connect,
                            retry_on=(OSError, MerkleKVError),
                            deadline=deadline,
                        )
                    except Exception:
                        self._sessions[peer] = nsess  # keep for next cycle
                        raise
                    sess = nsess
                    get_metrics().inc("anti_entropy.cycle_reconnects")
                    report.details.append(
                        f"stream died; reconnected (#{reconnects}), "
                        f"resuming at cursor {nsess.cursor!r} with "
                        f"{len(nsess.pending_sets)} pending"
                    )

            if verify and peer in self._sessions:
                # The cycle deliberately checkpointed mid-walk (deadline
                # expiry): roots are necessarily unequal, and raising here
                # would misreport the designed resume path as corruption.
                report.verified = False
                report.details.append(
                    "verify skipped: cycle checkpointed mid-walk; "
                    "resuming next cycle"
                )
            elif verify:
                local_root = self._engine.merkle_root()
                local_hex = (
                    local_root.hex() if local_root is not None else "0" * 64
                )
                report.verified = client.hash() == local_hex
                if not report.verified:
                    get_metrics().inc("anti_entropy.verify_failures")
                    report.seconds = time.perf_counter() - t0
                    self.last_report = report
                    raise RuntimeError(
                        f"sync verify failed: roots differ after repair "
                        f"(peer {report.peer})"
                    )
        finally:
            # Wire-byte accounting for the WHOLE cycle (probe, hash/tree
            # fetches, repairs, reconnects — the client counters survive
            # reconnects because the same client object re-dials).
            report.bytes_sent = client.bytes_sent
            report.bytes_received = client.bytes_received
            get_metrics().inc("sync.bytes_sent", report.bytes_sent)
            get_metrics().inc("sync.bytes_received", report.bytes_received)
            if trace is not None:
                trace.mode = report.mode
                trace.bytes_sent = report.bytes_sent
                trace.bytes_received = report.bytes_received
                trace.rounds = report.rounds
                trace.divergent = report.divergent
                trace.repairs = report.set_keys + report.deleted_keys
                if (peer in self._sessions
                        or peer in self._degraded_this_cycle):
                    trace.outcome = "degraded"
                elif report.mode == "noop":
                    trace.outcome = "noop"
            client.close()
            self._session_done(peer)

        report.seconds = time.perf_counter() - t0
        self.last_report = report
        return report

    # -- subtree-bisection walk (large-keyspace pairwise path) ----------------
    # Frontier cap: past this many divergent nodes per level the descent
    # stops early and repairs coarser intervals — massive divergence makes
    # deeper bisection pure overhead (the leaf fetches dominate anyway).
    _MAX_WALK_FRONTIER = 2048
    # Finest subtree the descent isolates before switching to leaf pages.
    # One more level costs ~134 wire bytes per divergent range (two more
    # interior digests) and saves half the range's leaf rows (~95 bytes
    # each), so descending pays until the span is a handful of keys; 16
    # keeps the last hop cheap without a round trip per single leaf.
    _WALK_LEAF_SPAN = 16
    # Default forced-refresh threshold when [device] max_staleness_versions
    # is unset: a donor tree trailing its engine by this many mutations is
    # past any sane pump window — deep enough that diffing against it
    # mostly finds already-healed divergence.
    _DEFAULT_TREE_LAG_LIMIT = 4096

    def _want_walk(self, sess: Optional[SyncSession]) -> bool:
        """Transfer-strategy selection for this cycle. A mid-walk resume
        stays in its recorded mode (the checkpointed cursor's semantics
        depend on it); otherwise config decides, with "auto" bisecting only
        once the keyspace is large enough that a tree walk's extra round
        trips beat shipping the whole hash list."""
        if sess is not None and sess.cursor:
            return sess.walk
        if self._mode == "page":
            return False
        if self._mode == "bisect":
            return True
        try:
            return self._engine.dbsize() >= self._bisect_threshold
        except Exception:
            return False

    def _sync_bisect(
        self,
        client: MerkleKVClient,
        report: SyncReport,
        deadline: Optional[Deadline],
        start: bytes,
        prior_attempts: int = 0,
        start_page: int = 0,
    ) -> tuple[bool, Optional[tuple[list[bytes], dict[bytes, bytes]]]]:
        """Top-down Merkle walk: start at the peer's tree root, descend
        only into divergent subtrees (TREELEVEL fetches, one batch per
        level), then repair each divergent LEAF RANGE with range-bounded
        HASHPAGE pages + targeted MGET — so wire bytes scale with
        divergence·log n instead of keyspace size. Positional node
        comparison is exact for value divergence; a structural change
        (insert/delete) shifts every position to its right, so those
        subtrees all read divergent and collapse into one contiguous
        repair range — never worse than the hash-list transfer, and the
        repair itself stays key-based (bounded pages), so it is correct
        either way.

        Boundary-key invariant the leaf fetch relies on: a node that
        COMPARES EQUAL pins keys and positions — local position i then
        holds exactly the remote's key i for every position the node
        covers — so divergent ranges are bounded by locally-known keys.

        Returns ``(walked, local_precomputed)``: ``walked`` False when the
        peer can't serve TREELEVEL (or is empty, or its keyspace churned
        mid-walk) — the caller degrades to the paged hash scan, handing it
        the already-computed (keys, leaf hashes) so the fallback doesn't
        re-hash the keyspace this cycle. Transport errors checkpoint
        (cursor, walk=True) and propagate, exactly like the paged walk, so
        the reconnect loop and cross-cycle resume machinery apply
        unchanged."""
        peer = report.peer
        with span("anti_entropy.walk", peer=peer) as rec:
            out, precomputed = self._sync_bisect_inner(
                client, report, deadline, start, prior_attempts, start_page
            )
            rec["walked"] = out
            rec["rounds"] = report.rounds
            rec["nodes_compared"] = report.nodes_compared
            rec["divergent"] = report.divergent
            return out, precomputed

    def _sync_bisect_inner(
        self,
        client: MerkleKVClient,
        report: SyncReport,
        deadline: Optional[Deadline],
        start: bytes,
        prior_attempts: int,
        start_page: int,
    ) -> tuple[bool, Optional[tuple[list[bytes], dict[bytes, bytes]]]]:
        from merklekv_tpu_torch.merkle.cpu import build_levels, ref_level_sizes

        peer = report.peer
        metrics = get_metrics()
        # Progress baseline: repairs applied BEFORE the walk (resumed
        # pending sets) don't count as this walk's progress — only a cursor
        # that advanced past the checkpoint or fresh repairs re-earn
        # retries (the paged walk's rule); a walk that keeps dying at the
        # same frontier must accumulate attempts toward abandonment.
        base_repairs = report.set_keys + report.deleted_keys

        def attempts_now(cursor: bytes) -> int:
            progressed = (
                cursor != start
                or report.set_keys + report.deleted_keys > base_repairs
            )
            return 0 if progressed else prior_attempts

        def fail_checkpoint(cursor: bytes, why: str) -> None:
            # Descent failures are not page-stream faults, so the carried
            # page size passes through unshrunk.
            self._checkpoint(peer, [], 0, attempts_now(cursor),
                             cursor=cursor, page_size=start_page, walk=True)
            self._degrade(peer, why)
            metrics.inc("anti_entropy.interrupted_repairs")

        # Capability probe + remote leaf count: a zero-width TREELEVEL. An
        # old peer answers ERROR (degrade to paging); an empty peer is
        # cheaper to mirror with the paged scan. The probe also settles the
        # version-stamp capability and reports how far the donor's served
        # tree trails its live engine.
        try:
            _, remote_n = client.tree_level(0, 0, 0)
        except MovedError:
            # Partition mismatch mid-cycle (ownership moved between the
            # HASH probe and this one): NEVER degrade to the paged scan —
            # HASHPAGE/LEAFHASHES carry no partition address, so the
            # fallback would mirror the wrong partition's keyspace. Abort
            # the cycle like the root probe does.
            get_metrics().inc("anti_entropy.moved_peers")
            raise
        except ProtocolError:
            return False, None  # no TREELEVEL on this peer
        except (MerkleKVError, OSError) as e:
            fail_checkpoint(start, f"tree walk probe died: {e!r}")
            raise
        stamp = client.last_stamp
        if stamp is not None and stamp[1] > self._tree_lag_limit:
            # Bounded trailing exceeded: the donor's pump is wedged or
            # swamped, and a walk against its ancient tree would mostly
            # rediscover divergence the live engine already healed.
            # Escalate ONCE to a forced refresh (vs=03 drains the donor's
            # pump synchronously) and walk the fresh tree.
            try:
                _, remote_n = client.tree_level(0, 0, 0, force=True)
            except MovedError:
                get_metrics().inc("anti_entropy.moved_peers")
                raise  # same rule as the plain probe above
            except ProtocolError:
                return False, None
            except (MerkleKVError, OSError) as e:
                fail_checkpoint(start, f"tree walk force-probe died: {e!r}")
                raise
            report.forced_refreshes += 1
            metrics.inc("sync.forced_refreshes")
            report.details.append(
                f"{peer}: donor tree lag {stamp[1]} > "
                f"{self._tree_lag_limit}; forced refresh"
            )
            stamp = client.last_stamp
        if stamp is not None:
            report.donor_tree_version, report.donor_tree_lag = stamp
        if remote_n <= 0:
            return False, None

        report.mode = "bisect"

        # Local reference tree: one leaf-digest pass over the snapshot
        # (device-batched when the keyspace is large enough) and one
        # host-side node reduction. The paged scan pays the same leaf
        # pass; the node levels are what let this cycle SKIP shipping the
        # leaf digests of converged subtrees.
        local_items = self._engine.snapshot()
        local_keys = [k for k, _ in local_items]
        local_hashes = self._hash_leaves(
            local_items, self._use_device(len(local_items))
        )
        local_levels = build_levels([local_hashes[k] for k in local_keys])
        report.local_keys = len(local_items)
        precomputed = (local_keys, local_hashes)

        sizes = ref_level_sizes(remote_n)
        height = len(sizes)

        def local_node(level: int, idx: int) -> Optional[bytes]:
            if level < len(local_levels) and idx < len(local_levels[level]):
                return local_levels[level][idx]
            return None

        # Descend until a subtree spans only _WALK_LEAF_SPAN leaves; the
        # remaining tail is one small bounded leaf fetch per range.
        stop_level = 0
        while (1 << (stop_level + 1)) <= self._WALK_LEAF_SPAN:
            stop_level += 1
        stop_level = min(stop_level, height - 1)

        level = height - 1
        divergent = [0]  # the root differs (HASH compare, or mid-walk resume)
        clipped = False
        while level > stop_level and divergent:
            child_level = level - 1
            m_child = sizes[child_level]
            cand: list[int] = []
            for idx in divergent:
                lo = 2 * idx
                if lo < m_child:
                    cand.append(lo)
                if lo + 1 < m_child:
                    cand.append(lo + 1)
                # lo + 1 >= m_child: odd-promotion — the parent IS cand[lo].
            # One TREELEVEL fetch per contiguous index run (a sparse
            # frontier stays sparse on the wire).
            runs: list[tuple[int, int]] = []
            for idx in cand:
                if runs and runs[-1][1] == idx:
                    runs[-1] = (runs[-1][0], idx + 1)
                else:
                    runs.append((idx, idx + 1))
            remote_dig: dict[int, bytes] = {}
            for rlo, rhi in runs:
                try:
                    rows, n_now = client.tree_level(child_level, rlo, rhi)
                except ProtocolError as e:
                    # Mid-walk protocol garbage = corrupted stream (the
                    # probe already proved the verb): keep the verified
                    # cursor and abort the cycle.
                    fail_checkpoint(start, f"tree walk corrupted: {e!r}")
                    raise
                except (MerkleKVError, OSError) as e:
                    fail_checkpoint(start, f"tree walk died: {e!r}")
                    raise
                if n_now != remote_n:
                    if client.last_stamp is not None:
                        # Bounded trailing from a stamped donor: its pump
                        # republished mid-walk (versions moved within the
                        # staleness window), shifting leaf positions. The
                        # frontier verified SO FAR is still sound — CLIP:
                        # stop descending and repair the parent-level
                        # divergent intervals with key-bounded pages
                        # (churn-tolerant by construction) instead of
                        # abandoning the walk to a full paged scan.
                        report.details.append(
                            f"{peer}: keyspace churned mid-walk "
                            f"({remote_n} -> {n_now}); clipping to the "
                            f"verified frontier at level {level}"
                        )
                        report.walk_clipped = True
                        metrics.inc("sync.walk_clips")
                        clipped = True
                        break
                    # Unstamped (old) donor: no way to tell bounded
                    # trailing from unbounded churn — degrade to the paged
                    # scan, which tolerates churn natively (reusing this
                    # cycle's local hashes).
                    report.details.append(
                        f"{peer}: keyspace churned mid-walk "
                        f"({remote_n} -> {n_now}); paging instead"
                    )
                    report.mode = ""
                    return False, precomputed
                if client.last_stamp is not None:
                    report.donor_tree_version, report.donor_tree_lag = (
                        client.last_stamp
                    )
                for i, hx in rows:
                    remote_dig[i] = bytes.fromhex(hx)
            if clipped:
                # Keep `divergent`/`level` at the last FULLY-compared
                # parent frontier (the partial child fetches are from the
                # republished tree and must not mix in).
                break
            report.rounds += 1
            metrics.inc("sync.rounds")
            nxt = []
            for idx in cand:
                report.nodes_compared += 1
                if local_node(child_level, idx) != remote_dig.get(idx):
                    nxt.append(idx)
            metrics.inc("sync.nodes_compared", len(cand))
            divergent = nxt
            level = child_level
            if len(divergent) > self._MAX_WALK_FRONTIER:
                break  # massive divergence: coarse intervals win from here

        if not divergent:
            # Tree levels agree below the root but HASH differed: racing
            # writes between the probe and the walk. Nothing provably
            # divergent — the next cycle re-compares.
            report.details.append(f"{peer}: walk found no divergent subtree")
            return True, precomputed

        # Divergent nodes -> merged contiguous leaf intervals [a, b).
        span_len = 1 << level
        intervals: list[tuple[int, int]] = []
        for idx in sorted(divergent):
            a = idx * span_len
            b = min((idx + 1) * span_len, remote_n)
            if intervals and intervals[-1][1] >= a:
                intervals[-1] = (intervals[-1][0], b)
            else:
                intervals.append((a, b))

        # Repair each interval with range-bounded pages. Interval
        # boundaries come from VERIFIED positions (the invariant above), so
        # everything outside the fetched ranges is already converged.
        page_size = start_page
        for a, b in intervals:
            after = b"" if a == 0 else local_keys[a - 1]
            upto: Optional[bytes] = None
            if b < remote_n and b < len(local_keys):
                upto = local_keys[b]
            if start and after < start:
                after = start  # resume clip: prefix <= cursor is verified
            if upto is not None and upto <= after:
                continue  # fully repaired before the interruption
            # The adaptive page size carries across intervals (and, via the
            # checkpoint, across cycles): a hostile link shrinks it, clean
            # pages grow it back — same resilience rule as the paged scan.
            page_size = self._repair_range(
                client, report, deadline, after, upto, local_keys,
                local_hashes, attempts_now, start_page=page_size,
            )
            if peer in self._sessions:
                # Deadline checkpoint inside the range repair.
                return True, precomputed
        return True, precomputed

    def _repair_range(
        self,
        client: MerkleKVClient,
        report: SyncReport,
        deadline: Optional[Deadline],
        after: bytes,
        upto: Optional[bytes],
        local_keys: list[bytes],
        local_hashes: dict[bytes, bytes],
        attempts_now: Callable[[bytes], int],
        start_page: int = 0,
    ) -> int:
        """Converge one key range (after, upto) against the peer: bounded
        HASHPAGE pages, deletions applied engine-side, divergent values
        fetched in mget batches — the same page discipline (checkpoint
        shape AND adaptive sizing: halve after a dead stream, double after
        a clean page) as the full paged walk, scoped to a divergent
        subtree. Returns the final page size so the caller threads it
        through the remaining intervals (and checkpoints carry it across
        cycles)."""
        import bisect

        peer = report.peer
        size = min(start_page or self._hash_page, self._hash_page)
        size = max(size, self._MIN_HASH_PAGE)

        def shrunk() -> int:
            return max(self._MIN_HASH_PAGE, size // 2)

        cursor = after
        while True:
            if deadline is not None and deadline.expired():
                self._checkpoint(peer, [], 0, attempts_now(cursor),
                                 cursor=cursor, page_size=size, walk=True)
                self._degrade(peer, "per-peer cycle deadline expired")
                report.details.append(
                    f"{peer}: deadline expired mid-walk; cursor "
                    f"{cursor!r} checkpointed"
                )
                return size
            bounded = upto is not None and cursor != b""
            try:
                rows, done = client.leaf_hashes_page(
                    size,
                    cursor.decode("utf-8", "surrogateescape"),
                    upto=(
                        upto.decode("utf-8", "surrogateescape")
                        if bounded
                        else None
                    ),
                )
            except ProtocolError as e:
                self._checkpoint(peer, [], 0, attempts_now(cursor),
                                 cursor=cursor, page_size=shrunk(),
                                 walk=True)
                self._degrade(peer, f"walk leaf stream corrupted: {e!r}")
                get_metrics().inc("anti_entropy.interrupted_repairs")
                raise
            except (MerkleKVError, OSError) as e:
                self._checkpoint(peer, [], 0, attempts_now(cursor),
                                 cursor=cursor, page_size=shrunk(),
                                 walk=True)
                self._degrade(peer, f"walk leaf stream died: {e!r}")
                get_metrics().inc("anti_entropy.interrupted_repairs")
                raise
            if upto is not None and not bounded:
                # The wire can't carry a bound with an empty cursor: trim
                # client-side; anything trimmed proves the range ended.
                kept = []
                for k, h, ts in rows:
                    if k.encode("utf-8", "surrogateescape") >= upto:
                        done = True
                        break
                    kept.append((k, h, ts))
                rows = kept

            page: list[tuple[bytes, Optional[bytes], int]] = [
                (
                    k.encode("utf-8", "surrogateescape"),
                    bytes.fromhex(h) if h is not None else None,
                    ts,
                )
                for k, h, ts in rows
            ]
            page_keys = {k for k, _, _ in page}
            # Covered local range: (cursor, last page key], extended to the
            # range end once the peer reports the range exhausted.
            lo = bisect.bisect_right(local_keys, cursor)
            if done:
                hi = (
                    bisect.bisect_left(local_keys, upto)
                    if upto is not None
                    else len(local_keys)
                )
            else:
                hi = (
                    bisect.bisect_right(local_keys, page[-1][0])
                    if page
                    else lo
                )

            to_set: list[tuple[bytes, int]] = []
            for k, digest, ts in page:
                if digest is None:
                    # ts-0 sentinel: state unknown server-side; skip (the
                    # next cycle repairs it) — same rule as the paged walk.
                    if ts != 0 and k in local_hashes:
                        self._repair_delete(k, tomb_ts=ts)
                        report.deleted_keys += 1
                        report.divergent += 1
                    continue
                report.remote_keys += 1
                if local_hashes.get(k) != digest:
                    to_set.append((k, ts))
            for k in local_keys[lo:hi]:
                if k not in page_keys:
                    self._repair_delete(k)
                    report.deleted_keys += 1
                    report.divergent += 1
            report.divergent += len(to_set)

            next_cursor = page[-1][0] if page else cursor
            try:
                self._repair_sets_resumable(
                    client, peer, to_set, report, deadline, lww=False,
                    cursor=next_cursor, walk=True,
                )
            except Exception:
                # The value-fetch checkpoint can't know the page size;
                # stamp the shrunk one onto the session it just stored.
                sess = self._sessions.get(peer)
                if sess is not None:
                    sess.page_size = shrunk()
                raise
            if peer in self._sessions:
                # Deadline checkpoint inside the repair loop — not a link
                # fault, so the page size carries over unshrunk.
                self._sessions[peer].page_size = size
                return size
            cursor = next_cursor
            size = min(self._hash_page, size * 2)
            if done:
                return size

    # -- paged hash walk (small-keyspace pairwise path) -----------------------
    _MIN_HASH_PAGE = 16
    # In-cycle reconnect budget: a hostile link can kill every page stream;
    # the cycle keeps reconnecting and resuming from its checkpoint until
    # this cap (or the cycle deadline) is hit, then leaves the session for
    # the next cycle. Backoff between reconnects comes from the retry
    # policy, so the cap mostly guards against pathological fast-fail loops.
    _MAX_CYCLE_RECONNECTS = 32

    def _sync_hash_paged(
        self,
        client: MerkleKVClient,
        report: SyncReport,
        deadline: Optional[Deadline],
        start: bytes,
        prior_attempts: int = 0,
        start_page: int = 0,
        precomputed: Optional[tuple[list[bytes], dict[bytes, bytes]]] = None,
    ) -> bool:
        """Cursor-paged pairwise repair: fetch the peer's hash list one
        sorted key-range page at a time (HASHPAGE), repairing each page
        before fetching the next. The cursor only advances past a page once
        its repairs are applied, so the prefix <= cursor is a VERIFIED
        subtree: an injected fault or peer death mid-walk checkpoints
        (cursor, unapplied page remainder) and the next cycle resumes there
        instead of restarting. The page size adapts — halved after a dead
        stream (smaller exposure per round trip on a hostile link), doubled
        after a clean page, bounded by [``_MIN_HASH_PAGE``, ``hash_page``] —
        so progress stays monotonic under fault rates that would kill any
        all-or-nothing transfer. Returns False when the peer does not serve
        HASHPAGE (caller degrades to the monolithic paths)."""
        peer = report.peer
        # Pure-page cycles never send a fixed-arity traced verb, so the
        # donor's HASHPAGE spans would stay untraced (require_settled)
        # without this one probe per cycle.
        self._settle_trace_capability(client)
        # The local snapshot + hash pass is deferred until the first page
        # proves the peer serves HASHPAGE: against an old peer this path
        # bails to the monolithic fallback, which computes its own
        # snapshot/hashes — hashing up front would double that cost every
        # cycle for the whole upgrade window. A degraded bisection walk
        # hands over the (keys, hashes) it already computed this cycle, so
        # the fallback never re-hashes the keyspace.
        local_keys: list[bytes] = []
        local_hashes: Optional[dict[bytes, bytes]] = None
        if precomputed is not None:
            local_keys, local_hashes = precomputed
            report.local_keys = len(local_keys)
        report.mode = "hash-paged"

        import bisect

        cursor = start
        size = min(start_page or self._hash_page, self._hash_page)
        size = max(size, self._MIN_HASH_PAGE)
        pages = 0

        def progressed() -> bool:
            return cursor != start or report.set_keys + report.deleted_keys > 0

        def shrunk() -> int:
            return max(self._MIN_HASH_PAGE, size // 2)

        def attempts_now() -> int:
            return 0 if progressed() else prior_attempts

        while True:
            if deadline is not None and deadline.expired():
                self._checkpoint(peer, [], 0, attempts_now(),
                                 cursor=cursor, page_size=size)
                self._degrade(peer, "per-peer cycle deadline expired")
                report.details.append(
                    f"{peer}: deadline expired mid-walk; cursor "
                    f"{cursor!r} checkpointed after {pages} pages"
                )
                return True
            try:
                rows, done = client.leaf_hashes_page(
                    size, cursor.decode("utf-8", "surrogateescape")
                )
            except ProtocolError as e:
                if pages == 0 and "unknown command" in str(e).lower():
                    return False  # old peer: no HASHPAGE verb
                # Mid-walk protocol garbage is a corrupted stream, not a
                # capability miss: keep the verified prefix and abort the
                # cycle (the next one resumes from the cursor).
                self._checkpoint(peer, [], 0, attempts_now(),
                                 cursor=cursor, page_size=shrunk())
                self._degrade(peer, f"hash walk stream corrupted: {e!r}")
                get_metrics().inc("anti_entropy.interrupted_repairs")
                raise
            except (MerkleKVError, OSError) as e:
                self._checkpoint(peer, [], 0, attempts_now(),
                                 cursor=cursor, page_size=shrunk())
                self._degrade(peer, f"hash walk died: {e!r}")
                get_metrics().inc("anti_entropy.interrupted_repairs")
                raise
            if local_hashes is None:
                # One local hash pass per cycle (device-batched when the
                # keyspace is big enough) — per-page hashing would forfeit
                # the batching win.
                local_items = self._engine.snapshot()  # sorted (key, value)
                local_keys = [k for k, _ in local_items]
                local_hashes = self._hash_leaves(
                    local_items, self._use_device(len(local_items))
                )
                report.local_keys = len(local_items)
            pages += 1

            page: list[tuple[bytes, Optional[bytes], int]] = [
                (
                    k.encode("utf-8", "surrogateescape"),
                    bytes.fromhex(h) if h is not None else None,
                    ts,
                )
                for k, h, ts in rows
            ]
            page_keys = {k for k, _, _ in page}
            # Covered local range: (cursor, last page key], or everything
            # past the cursor once the peer reports the scan exhausted.
            lo = bisect.bisect_right(local_keys, cursor)
            hi = (
                len(local_keys)
                if done
                else bisect.bisect_right(local_keys, page[-1][0])
            )

            # Deletions first — engine-local, nothing to interrupt. A key
            # the page skips is absent on the peer (mirror its absence); a
            # tombstone row carries the peer's deletion ts to adopt.
            to_set: list[tuple[bytes, int]] = []
            for k, digest, ts in page:
                if digest is None:
                    # ts 0 is the server's "state unknown" sentinel (key
                    # vanished between page selection and read, tombstone
                    # evicted): adopting it would delete newer local data.
                    # The key stays in page_keys so the mirror-absence
                    # sweep below skips it too; the next cycle repairs it.
                    if ts != 0 and k in local_hashes:
                        self._repair_delete(k, tomb_ts=ts)
                        report.deleted_keys += 1
                        report.divergent += 1
                    continue
                report.remote_keys += 1
                if local_hashes.get(k) != digest:
                    to_set.append((k, ts))
            for k in local_keys[lo:hi]:
                if k not in page_keys:
                    self._repair_delete(k)
                    report.deleted_keys += 1
                    report.divergent += 1
            report.divergent += len(to_set)

            next_cursor = page[-1][0] if page else cursor
            # Value repairs for this page; a death here checkpoints the
            # page remainder WITH the advanced cursor (deletes are already
            # applied and the pending list captures the unapplied sets).
            try:
                self._repair_sets_resumable(
                    client, peer, to_set, report, deadline, lww=False,
                    cursor=next_cursor,
                )
            except Exception:
                sess = self._sessions.get(peer)
                if sess is not None:
                    sess.page_size = shrunk()
                raise
            if peer in self._sessions:
                # Deadline checkpoint inside the repair loop — not a link
                # fault, so the page size carries over unshrunk.
                self._sessions[peer].page_size = size
                return True
            cursor = next_cursor
            size = min(self._hash_page, size * 2)
            if done:
                return True

    # -- hash-first path ------------------------------------------------------
    def _fetch_remote_hashes(
        self, client: MerkleKVClient, report: SyncReport
    ) -> Optional[dict[bytes, tuple[bytes, int]]]:
        """Peer (leaf digest, last-write ts) map, or None if the peer can't
        serve LEAFHASHES."""
        try:
            # Decode INSIDE the try: a malformed digest line (corrupt peer,
            # or a future wire extension this reader doesn't know) must
            # degrade to the full-transfer fallback, not kill the cycle.
            return _decode_leaf_map(client.leaf_hashes_ts())
        except ProtocolError as e:
            # The peer answered but can't serve the verb (ERROR response):
            # the one case where full transfer is the right degradation.
            report.details.append(f"LEAFHASHES unsupported: {e!r}")
            get_metrics().inc("anti_entropy.leafhash_fallbacks")
            return None
        except (MerkleKVError, OSError):
            # Transport death mid-fetch. Falling back to full transfer
            # would push the ENTIRE keyspace over the same dying link —
            # strictly worse. Abort the cycle; the loop retries next round
            # (and any checkpointed session resumes).
            get_metrics().inc("anti_entropy.leafhash_aborts")
            raise
        except Exception as e:
            # Malformed payload from a live peer: full transfer re-derives
            # the hashes locally and still converges.
            report.details.append(f"LEAFHASHES undecodable: {e!r}")
            get_metrics().inc("anti_entropy.leafhash_fallbacks")
            return None

    def _sync_hash_first(
        self,
        client: MerkleKVClient,
        remote_hashes: dict[bytes, tuple[Optional[bytes], int]],
        report: SyncReport,
        deadline: Optional[Deadline] = None,
    ) -> None:
        local = {k: v for k, v in self._engine.snapshot()}
        # Live digests and tombstones arrive in one LEAFHASHES payload;
        # pairwise semantics stay strict local := remote over the LIVE
        # keyspace, with remote tombstone timestamps adopted so the copied
        # deletion keeps its original LWW position.
        remote_digests = {
            k: d for k, (d, _) in remote_hashes.items() if d is not None
        }
        remote_tombs = {
            k: ts for k, (d, ts) in remote_hashes.items() if d is None
        }
        report.remote_keys = len(remote_digests)
        report.local_keys = len(local)

        use_device = self._use_device(len(set(local) | set(remote_digests)))
        local_hashes = self._hash_leaves(sorted(local.items()), use_device)
        divergent = self._diff(local_hashes, remote_digests, use_device)
        report.divergent = len(divergent)

        # Local deletions first — no network involved, cannot be
        # interrupted by a peer death.
        to_set: list[tuple[bytes, int]] = []
        for k in divergent:
            if k in remote_digests:
                # Propagate the peer's last-write ts with the value so
                # LWW ordering metadata survives the repair.
                to_set.append((k, remote_hashes[k][1]))
            else:
                self._repair_delete(k, tomb_ts=remote_tombs.get(k))
                report.deleted_keys += 1
        # Value repairs apply BATCH BY BATCH in sorted key order so a peer
        # death mid-stream leaves a converged prefix applied and a
        # checkpointed remainder to resume, instead of losing the cycle.
        self._repair_sets_resumable(
            client, report.peer, to_set, report, deadline, lww=False
        )

    def _repair_sets_resumable(
        self,
        client: MerkleKVClient,
        peer: str,
        pairs: list[tuple[bytes, int]],
        report,  # SyncReport | MultiSyncReport (shared counter fields)
        deadline: Optional[Deadline],
        lww: bool,
        already_repaired: int = 0,
        prior_attempts: int = 0,
        cursor: bytes = b"",
        walk: bool = False,
    ) -> None:
        """Fetch+apply ``pairs`` in mget batches; checkpoint on failure.

        On a transport error (or an expired per-peer deadline) the
        remaining pairs become a SyncSession, the peer is marked degraded,
        and the error propagates (deadline expiry returns silently — the
        loop simply continues next interval). Keys repaired before the
        interruption STAY repaired. An attempt that made ANY progress
        re-earns its retries (attempts reset); only a stalled session is
        eventually abandoned by ``_take_session``.
        """
        repaired = already_repaired

        def attempts_now() -> int:
            return prior_attempts if repaired == already_repaired else 0

        for i in range(0, len(pairs), self._mget_batch):
            if deadline is not None and deadline.expired():
                self._checkpoint(peer, pairs[i:], repaired, attempts_now(),
                                 cursor=cursor, walk=walk)
                self._degrade(peer, "per-peer cycle deadline expired")
                report.details.append(
                    f"{peer}: deadline expired; {len(pairs) - i} repairs "
                    "checkpointed"
                )
                return
            batch = pairs[i : i + self._mget_batch]
            try:
                values = self._fetch_values(client, [k for k, _ in batch])
            except Exception as e:
                self._checkpoint(peer, pairs[i:], repaired, attempts_now(),
                                 cursor=cursor, walk=walk)
                self._degrade(peer, f"repair stream died: {e!r}")
                report.details.append(
                    f"{peer}: interrupted mid-repair ({e!r}); "
                    f"{len(pairs) - i} repairs checkpointed"
                )
                get_metrics().inc("anti_entropy.interrupted_repairs")
                raise
            report.values_fetched += len(values)
            for k, ts in batch:
                if k not in values:
                    # Deleted on the peer between LEAFHASHES and MGET;
                    # the next cycle repairs it.
                    continue
                if lww:
                    if self._repair_set_lww(k, values[k], ts):
                        report.set_keys += 1
                else:
                    self._repair_set(k, values[k], ts)
                    report.set_keys += 1
                repaired += 1

    # -- full path (reference behavior; --full or LEAFHASHES-less peer) -------
    def _sync_full(self, client: MerkleKVClient, report: SyncReport) -> None:
        remote = self._fetch_remote(client)
        local = {k: v for k, v in self._engine.snapshot()}
        report.remote_keys = len(remote)
        report.local_keys = len(local)
        report.values_fetched = len(remote)

        use_device = self._use_device(len(set(local) | set(remote)))
        local_hashes = self._hash_leaves(sorted(local.items()), use_device)
        remote_hashes = self._hash_leaves(sorted(remote.items()), use_device)
        divergent = self._diff(local_hashes, remote_hashes, use_device)
        report.divergent = len(divergent)

        for k in divergent:
            if k in remote:
                self._repair_set(k, remote[k])
                report.set_keys += 1
            else:
                self._repair_delete(k)
                report.deleted_keys += 1

    def _clamp_ts(self, ts: Optional[int]) -> Optional[int]:
        """Clock-skew guard for adopted peer timestamps: clamp anything
        beyond now + max_skew_ms BEFORE install/journal, mirroring the
        replicator's inbound clamp — anti-entropy must not re-import the
        poison the replication path already refused. Counted
        (``anti_entropy.skew_clamped``); clamping never changes WHO wins
        an arbitration (comparisons already happened), only how far into
        the future the installed fence reaches."""
        if ts is None or not self._max_skew_ns:
            return ts
        limit = time.time_ns() + self._max_skew_ns
        if ts <= limit:
            return ts
        get_metrics().inc("anti_entropy.skew_clamped")
        return limit

    def _repair_set(self, k: bytes, v: bytes, ts: Optional[int] = None) -> None:
        ts = self._clamp_ts(ts)
        if ts is None:
            self._engine.set(k, v)
        else:
            self._engine.set_with_ts(k, v, ts)
        if self._repair_listener is not None:
            self._repair_listener(k, v, ts)

    def _repair_set_lww(self, k: bytes, v: bytes, ts: int) -> bool:
        """Conditional install for multi-peer repair: a local write or
        deletion racing ahead of the fetched winner must not be clobbered."""
        ts = self._clamp_ts(ts)
        applied = self._engine.set_if_newer(k, v, ts)
        if applied and self._repair_listener is not None:
            self._repair_listener(k, v, ts)
        return applied

    def _repair_delete(self, k: bytes, tomb_ts: Optional[int] = None) -> None:
        """Pairwise repair deletion. With the peer's tombstone ts, adopt it
        (the deletion keeps its LWW position); without one this is a MIRROR
        copy of absence — delete_quiet, because fabricating a tombstone at
        "now" would later kill disjoint writes cluster-wide."""
        tomb_ts = self._clamp_ts(tomb_ts)
        if tomb_ts is None:
            if not hasattr(self._engine, "delete_quiet"):
                self._engine.delete(k)  # engine doubles without quiet mode
            else:
                self._engine.delete_quiet(k)
        elif not hasattr(self._engine, "delete_with_ts"):
            self._engine.delete(k)  # engine doubles without ts-carrying ops
        else:
            self._engine.delete_with_ts(k, tomb_ts)
        if self._repair_listener is not None:
            self._repair_listener(k, None, tomb_ts)

    def _repair_delete_lww(self, k: bytes, ts: int, was_present: bool) -> bool:
        """Conditional deletion for multi-peer repair (peer tombstone won).

        The listener fires on EVERY applied delete, not just when the
        start-of-cycle snapshot saw the key: a replication event may have
        installed it mid-cycle, and the device mirror must drop what the
        engine just dropped (apply_one(k, None) is a no-op for absent
        keys). ``was_present`` only scopes the report count."""
        ts = self._clamp_ts(ts)
        applied = self._engine.delete_if_newer(k, ts)
        if applied and self._repair_listener is not None:
            self._repair_listener(k, None, ts)
        return applied and was_present

    # -- multi-peer cycle -----------------------------------------------------
    def sync_multi(self, peers: list[str]) -> MultiSyncReport:
        """One anti-entropy cycle against ALL peers at once.

        Gathers every peer's (leaf hash, last-write ts) pairs AND tombstones
        (deletion records with timestamps), stacks the live digests with the
        local map into one ``[R, N]`` divergence program (merkle/diff.py),
        then arbitrates each divergent key by **per-key LWW** over the
        deterministic order ``(ts, liveness, digest)``: newest timestamp
        wins; at equal timestamps a live value beats a tombstone; live ties
        break toward the lexicographically larger digest. Only the winning
        values are fetched — grouped per peer so each value travels once —
        and installed conditionally (set_if_newer) WITH the winner's
        timestamp so ordering metadata propagates and racing local writes
        survive. A winning tombstone deletes locally (delete_if_newer), so
        a deletion whose replication event was dropped still converges
        cluster-wide instead of being resurrected by peers holding the old
        value. BARE absence (no value, no tombstone) still never wins: a
        fresh write seen by one node is never destroyed by peers that
        merely haven't received it yet. Every node running this same
        deterministic rule converges the cluster to the LWW-merged union
        keyspace. Timestamps are wall clocks — cross-node skew trades
        accuracy for availability exactly like the reference's replication
        LWW (replication.rs:289-290).

        The reference has no analog: its sync is strictly pairwise and
        full-transfer, and a deletion it hasn't replicated is undone
        forever (the reference's src/sync.rs:56-87,74-83).
        """
        traces = {p: PeerTrace(peer=p, mode="multi") for p in peers}
        started, t0 = time.time(), time.perf_counter()
        cid = next_cycle_id()
        tscope, tctx = self._cycle_trace_scope()
        try:
            with tscope, cycle_scope(cid), \
                    span("anti_entropy.sync_multi",
                         peers=",".join(peers)) as rec:
                report = self._sync_multi(peers, traces=traces)
                rec["divergent"] = report.divergent_union
                get_metrics().inc("anti_entropy.multi_syncs")
                get_metrics().inc(
                    "anti_entropy.keys_repaired",
                    report.set_keys + report.deleted_keys,
                )
                return report
        except Exception as e:
            for t in traces.values():
                if t.outcome == "ok" and not t.error:
                    t.outcome = "error"
                    t.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            get_trace_buffer().append(CycleTrace(
                cycle_id=cid, kind="multi", started_unix=started,
                seconds=time.perf_counter() - t0,
                peers=list(traces.values()),
                trace_id=tctx.trace_id if tctx is not None else 0,
            ))

    def _sync_multi(
        self,
        peers: list[str],
        traces: Optional[dict[str, PeerTrace]] = None,
    ) -> MultiSyncReport:
        import numpy as np

        from merklekv_tpu_torch.merkle.diff import (
            align_replicas,
            divergence_masks_engine,
            divergence_masks_np,
        )

        t0 = time.perf_counter()
        report = MultiSyncReport(peers=list(peers))
        deadline = self._retry.deadline()

        # Gather peer leaf-hash+ts maps; a down peer is skipped this cycle.
        clients: list[Optional[MerkleKVClient]] = []
        peer_hashes: list[dict[bytes, tuple[Optional[bytes], int]]] = []

        def drop_peer(
            c: Optional[MerkleKVClient],
            peer: str,
            why: str,
            outcome: str = "skipped",
        ) -> None:
            # Every early-exit path must release the socket: this loop runs
            # every anti-entropy cycle, and an unclosed client per cycle is
            # a steady fd leak.
            if c is not None:
                c.close()
            report.details.append(why)
            clients.append(None)
            peer_hashes.append({})
            if traces is not None:
                traces[peer].outcome = outcome
                traces[peer].error = why
                if c is not None:
                    traces[peer].bytes_sent = c.bytes_sent
                    traces[peer].bytes_received = c.bytes_received

        for peer in peers:
            host, _, port = peer.rpartition(":")
            c: Optional[MerkleKVClient] = None
            try:
                c = self._attach_trace(
                    MerkleKVClient(host, int(port), timeout=self._timeout)
                )
                c.connect()
            except Exception as e:
                drop_peer(c, peer, f"{peer}: unreachable ({e!r})")
                continue
            # An interrupted repair from a previous cycle resumes before
            # this cycle's arbitration, so the local snapshot below already
            # reflects the repaired prefix.
            sess = self._take_session(peer)
            if sess is not None:
                report.resumed_peers.append(peer)
                get_metrics().inc("anti_entropy.sessions_resumed")
                repairs_before = report.set_keys
                try:
                    # cursor threads through so a re-checkpoint on failure
                    # keeps the paged walk's verified prefix — without it a
                    # failed resume would store cursor=b"" and the next
                    # sync_once would restart the walk from scratch.
                    self._repair_sets_resumable(
                        c, peer, sess.pending_sets, report, deadline,
                        lww=True, already_repaired=sess.repaired,
                        prior_attempts=sess.attempts, cursor=sess.cursor,
                        walk=sess.walk,
                    )
                except Exception as e:
                    if traces is not None:
                        traces[peer].repairs += (
                            report.set_keys - repairs_before
                        )
                    drop_peer(c, peer, f"{peer}: resume interrupted ({e!r})",
                              outcome="degraded")
                    report.degraded.append(peer)
                    continue
                if traces is not None:
                    traces[peer].repairs += report.set_keys - repairs_before
                if peer in self._sessions:
                    # Deadline expired mid-resume (silent checkpoint):
                    # arbitration for this peer would run on a spent budget
                    # and its wants-loop re-checkpoint would overwrite the
                    # saved paged-walk cursor with b"".
                    drop_peer(
                        c, peer,
                        f"{peer}: deadline expired mid-resume; checkpointed",
                        outcome="degraded",
                    )
                    report.degraded.append(peer)
                    continue
            if self._partition_id is not None:
                # Partition guard probe BEFORE the gather: the multi-peer
                # path fetches via LEAFHASHES (no pt= address on the
                # wire), so a stale-map peer serving a different
                # partition would contribute its disjoint keyspace to the
                # union and LWW would import it. One zero-width TREELEVEL
                # (pt=-addressed) turns that into a loud per-peer skip.
                try:
                    c.tree_level(0, 0, 0)
                except MovedError as e:
                    get_metrics().inc("anti_entropy.moved_peers")
                    drop_peer(
                        c, peer, f"{peer}: wrong partition ({e})",
                        outcome="error",
                    )
                    continue
                except Exception:
                    pass  # liveness/capability failures handled below
            self._settle_trace_capability(c)
            try:
                decoded = _decode_leaf_map(c.leaf_hashes_ts())
            except Exception:
                # Peer serves data but not LEAFHASHES (the pairwise path's
                # full-transfer fallback, here too): fetch its snapshot and
                # hash locally. Entries carry ts 0 ("unknown age"), so the
                # peer contributes missing keys to the union but loses
                # every LWW race — it can never overwrite fresher state.
                get_metrics().inc("anti_entropy.leafhash_fallbacks")
                try:
                    remote = self._fetch_remote(c)
                    decoded = {
                        k: (d, 0)
                        for k, d in self._hash_leaves(
                            sorted(remote.items()), False
                        ).items()
                    }
                    report.details.append(
                        f"{peer}: LEAFHASHES unsupported; full snapshot"
                    )
                except Exception as e:
                    drop_peer(c, peer, f"{peer}: unreachable ({e!r})")
                    continue
            clients.append(c)
            peer_hashes.append(decoded)
        live = [i for i, c in enumerate(clients) if c is not None]
        try:
            if not live:
                report.seconds = time.perf_counter() - t0
                return report

            local = {k: v for k, v in self._engine.snapshot()}
            use_device = self._use_device(
                len(set(local).union(*[set(p) for p in peer_hashes]))
            )
            local_hashes = self._hash_leaves(sorted(local.items()), use_device)

            # Replica 0 = local; only live peers join the arbitration.
            # Each peer's payload splits into live digests (alignment input)
            # and tombstones (deletion candidates for the LWW round).
            peer_maps = [peer_hashes[i] for i in live]
            peer_live = [
                {k: (d, ts) for k, (d, ts) in pm.items() if d is not None}
                for pm in peer_maps
            ]
            peer_tombs = [
                {k: ts for k, (d, ts) in pm.items() if d is None}
                for pm in peer_maps
            ]
            local_tombs = dict(self._engine.tombstones())
            replicas = [local_hashes] + [
                {k: d for k, (d, _) in pl.items()} for pl in peer_live
            ]
            aligned = align_replicas(replicas)
            report.union_keys = aligned.n_keys
            if aligned.n_keys == 0:
                report.seconds = time.perf_counter() - t0
                return report
            if use_device:
                try:
                    # Engine boundary: the N-replica comparison on the
                    # node's device (bit-identical to the host masks).
                    masks = divergence_masks_engine(
                        aligned.digests, aligned.present,
                        device=self._resolved_device(),
                    ).cpu().numpy()
                except Exception as e:
                    deviceenv.note_device_failure(e, "divergence masks")
                    raise
            else:
                masks = divergence_masks_np(aligned.digests, aligned.present)
            report.per_peer_divergent = {
                peers[i]: int(masks[slot].sum())
                for slot, i in enumerate(live, start=1)
            }
            if traces is not None:
                for p, d in report.per_peer_divergent.items():
                    traces[p].divergent = d
            divergent = np.nonzero(masks.any(axis=0))[0]
            report.divergent_union = int(len(divergent))

            # Vectorized per-key LWW among replicas holding the key OR a
            # tombstone for it (bare absence never wins — see docstring).
            # Candidate order is (ts, liveness, digest words): liveness 1
            # for a value, 0 for a tombstone, so a value wins timestamp
            # ties — matching the engine's set_if_newer/del_if_newer rule.
            # The former per-key Python loop was O(divergent x replicas)
            # tuple comparisons + one FFI get_ts per key — at the
            # 10M/1%-divergence scale that is ~100K iterations per cycle;
            # here winner selection is 10 elementwise passes over [R, D].
            n_div = len(divergent)
            n_rep = len(replicas)
            keys_div = [aligned.keys[i] for i in divergent]
            sub = np.ascontiguousarray(
                aligned.digests[:, divergent, :]
            ).astype(">u4")
            raw_digests = sub.tobytes()

            def dig(r: int, j: int) -> bytes:
                off = (r * n_div + j) * 32
                return raw_digests[off : off + 32]

            pres = aligned.present[:, divergent]  # [R, D] bool
            # Local last-write timestamps: one bulk export when much of the
            # keyspace diverged, per-key FFI reads when divergence is small
            # relative to the keyspace (a 10M-entry dict per cycle would
            # dwarf a few thousand C calls).
            if n_div * 8 >= len(local):
                local_ts_map = dict(self._engine.key_timestamps())

                def local_ts(k: bytes) -> int:
                    return local_ts_map.get(k, 0)
            else:
                def local_ts(k: bytes) -> int:
                    return self._engine.get_ts(k) or 0

            # Timestamps clamp to int64 max: the matrix is int64 (-1 = no
            # candidate) and a peer with a corrupt clock reporting a uint64
            # ts >= 2^63 must lose gracefully in arbitration, not abort the
            # whole cycle with an OverflowError.
            _I64MAX = (1 << 63) - 1
            ts_m = np.zeros((n_rep, n_div), np.int64)
            ts_m[0] = [
                min(local_ts(k), _I64MAX)
                if p
                else min(local_tombs.get(k, -1), _I64MAX)
                for k, p in zip(keys_div, pres[0])
            ]
            for slot in range(1, n_rep):
                pl, pt = peer_live[slot - 1], peer_tombs[slot - 1]
                ts_m[slot] = [
                    min(pl[k][1], _I64MAX) if p else min(pt.get(k, -1), _I64MAX)
                    for k, p in zip(keys_div, pres[slot])
                ]
            live_m = pres.astype(np.int64)
            valid = ts_m >= 0  # a value or a recorded tombstone

            # Successive narrowing to the (ts, liveness, w0..w7) maximum.
            cand = valid.copy()
            words = sub.astype(np.int64)  # [R, D, 8], big-endian word order
            for crit in (ts_m, live_m, *(words[:, :, w] for w in range(8))):
                masked = np.where(cand, crit, np.int64(-1))
                cand &= masked == masked.max(axis=0)[None, :]
            winner_slot = np.argmax(cand, axis=0)  # first max row; digest
            # ties beyond word 7 mean identical winning state on both rows.
            any_valid = valid.any(axis=0)
            winner_ts_arr = ts_m[winner_slot, np.arange(n_div)]
            winner_live_arr = live_m[winner_slot, np.arange(n_div)] == 1

            # wants[peer_slot] = (key, winner_ts) pairs that peer serves.
            wants: dict[int, list[tuple[bytes, int]]] = {}
            for j in np.nonzero(any_valid)[0]:
                key = keys_div[j]
                ws = int(winner_slot[j])
                winner_ts = int(winner_ts_arr[j])
                local_present = bool(pres[0, j])
                if not winner_live_arr[j]:
                    # A deletion won: apply it locally unless local state is
                    # newer (delete_if_newer re-checks under the shard lock).
                    if self._repair_delete_lww(key, winner_ts, local_present):
                        report.deleted_keys += 1
                    continue
                if ws == 0:
                    continue  # local already holds the winning state
                winner = dig(ws, j)
                if local_present and dig(0, j) == winner:
                    continue  # same digest locally; nothing to fetch
                wants.setdefault(live[ws - 1], []).append((key, winner_ts))

            for r, pairs in wants.items():
                # A peer dying mid-fetch no longer aborts the whole cycle:
                # its remaining repairs are checkpointed (resumed next
                # cycle), it is marked degraded, and the other peers'
                # repairs proceed.
                peer = peers[r]
                repairs_before = report.set_keys
                try:
                    self._repair_sets_resumable(
                        clients[r], peer, pairs, report, deadline, lww=True
                    )
                except Exception:
                    report.degraded.append(peer)
                    continue
                finally:
                    if traces is not None:
                        traces[peer].repairs += (
                            report.set_keys - repairs_before
                        )
                if peer in self._sessions:  # deadline checkpoint, no raise
                    report.degraded.append(peer)
        finally:
            for i, c in enumerate(clients):
                if c is not None:
                    if traces is not None:
                        traces[peers[i]].bytes_sent = c.bytes_sent
                        traces[peers[i]].bytes_received = c.bytes_received
                    c.close()
            if traces is not None:
                for p in report.degraded:
                    traces[p].outcome = "degraded"
            for peer in peers:
                self._session_done(peer)

        report.seconds = time.perf_counter() - t0
        self.last_multi_report = report
        return report

    def _hash_leaves(
        self, items: list[tuple[bytes, bytes]], use_device: bool
    ) -> dict[bytes, bytes]:
        return _leaf_map(items, use_device, self._torch_device)

    def _resolved_device(self):
        if self._torch_device is None:
            return deviceenv.resolve()
        return self._torch_device

    def _use_device(self, n_union: int) -> bool:
        return self._device == "tpu" or (
            self._device == "auto" and n_union >= _DEVICE_THRESHOLD
        )

    def _diff(
        self,
        local_hashes: dict[bytes, bytes],
        remote_hashes: dict[bytes, bytes],
        use_device: bool,
    ) -> list[bytes]:
        if use_device:
            from merklekv_tpu_torch.merkle.diff import diff_keys_pair

            try:
                return diff_keys_pair(
                    local_hashes, remote_hashes, device=self._resolved_device()
                )
            except Exception as e:
                deviceenv.note_device_failure(e, "pairwise diff")
                raise
        keys = set(local_hashes) | set(remote_hashes)
        return sorted(
            k for k in keys if local_hashes.get(k) != remote_hashes.get(k)
        )

    def _fetch_remote(self, c: MerkleKVClient) -> dict[bytes, bytes]:
        """Snapshot over an already-open connection: SCAN, then batched MGET."""
        return self._mget_all(c, c.scan())

    def _fetch_values(
        self, c: MerkleKVClient, keys: list[bytes]
    ) -> dict[bytes, bytes]:
        """Targeted value fetch for the divergent set only."""
        return self._mget_all(
            c, [k.decode("utf-8", "surrogateescape") for k in keys]
        )

    def _mget_all(
        self, c: MerkleKVClient, keys: list[str]
    ) -> dict[bytes, bytes]:
        out: dict[bytes, bytes] = {}
        for i in range(0, len(keys), self._mget_batch):
            batch = keys[i : i + self._mget_batch]
            for k, v in c.mget(batch).items():
                if v is None:
                    # MGET's wire format can't distinguish a missing key
                    # from a literal "NOT_FOUND" value; GET can (the
                    # "VALUE " prefix). The key came from SCAN/LEAFHASHES,
                    # so only a concurrent delete or that literal value
                    # lands here.
                    v = c.get(k)
                    if v is None:
                        continue
                out[k.encode("utf-8", "surrogateescape")] = v.encode(
                    "utf-8", "surrogateescape"
                )
        return out

    # -- periodic loop ---------------------------------------------------------
    def start_loop(
        self,
        peers: list[str],
        interval_seconds: float,
        multi_peer: bool = False,
        peer_up=None,  # Callable[[str], bool] from the health monitor
        pause_when=None,  # Callable[[], bool] from the overload monitor
    ) -> None:
        """Periodic anti-entropy: pairwise per peer, or one fused
        multi-peer arbitration cycle when ``multi_peer`` is set.

        ``peer_up`` (the failure detector's verdict) lets a cycle skip
        confirmed-down peers instead of paying a connect timeout each; the
        monitor keeps probing, so a recovered peer rejoins the next cycle.

        ``pause_when`` (the overload monitor's verdict) defers whole
        cycles while the node is above a resource watermark: a sync cycle
        materializes leaf maps and repair batches, exactly the allocation
        a memory-pressured node must not make, and journals repairs a
        disk-full node cannot. Deferred cycles are counted
        (``anti_entropy.overload_skips``) and never fire the converged
        hook — lag residue stays visible until a real full pass runs
        after recovery.
        """

        def up(peer: str) -> bool:
            if peer_up is None:
                return True
            try:
                return bool(peer_up(peer))
            except Exception:
                return True  # a broken detector must not stall repairs

        def run() -> None:
            while not self._stop.wait(interval_seconds):
                if pause_when is not None:
                    try:
                        paused = bool(pause_when())
                    except Exception:
                        paused = False  # a broken monitor must not stall
                    if paused:
                        get_metrics().inc("anti_entropy.overload_skips")
                        continue
                live_peers = [p for p in peers if up(p)]
                skipped = len(peers) - len(live_peers)
                if skipped:
                    get_metrics().inc("anti_entropy.down_peer_skips", skipped)
                # Full clean pass: EVERY configured peer synced this round
                # with nothing checkpointed/degraded/skipped. Only that
                # proves enough coverage to clear dropped-frame lag
                # residue (see __init__ on the hook).
                full_pass = skipped == 0 and bool(live_peers)
                if multi_peer:
                    if not live_peers:
                        continue
                    try:
                        rep = self.sync_multi(live_peers)
                        full_pass = full_pass and not rep.degraded
                    except Exception:
                        # Retried next round — but never silently: a loop
                        # that throws every cycle looks like a healthy
                        # no-op without this counter.
                        get_metrics().inc("anti_entropy.loop_errors")
                        full_pass = False
                    self._fire_converged(full_pass)
                    continue
                for peer in live_peers:
                    if self._stop.is_set():
                        return
                    host, _, port = peer.rpartition(":")
                    try:
                        self.sync_once(host, int(port))
                    except Exception as e:
                        # Peer down or stream interrupted: any checkpointed
                        # session resumes next round, the health table
                        # carries the degradation, and the loop moves on.
                        # Only degrade here if the cycle didn't already —
                        # a second mark would double-count the metric and
                        # bury the specific reason under this generic one.
                        get_metrics().inc("anti_entropy.loop_errors")
                        if peer not in self._degraded_this_cycle:
                            self._degrade(peer, f"sync cycle failed: {e!r}")
                        full_pass = False
                        continue
                    if (
                        peer in self._sessions
                        or peer in self._degraded_this_cycle
                    ):
                        full_pass = False
                self._fire_converged(full_pass)

        self._stop.clear()
        self._loop_thread = threading.Thread(
            target=run, daemon=True, name="mkv-anti-entropy"
        )
        self._loop_thread.start()

    def _fire_converged(self, full_pass: bool) -> None:
        if full_pass and self._on_cycle_converged is not None:
            try:
                self._on_cycle_converged()
            except Exception:
                pass  # a broken lag hook must never stall the loop

    def stop(self) -> None:
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
            self._loop_thread = None
