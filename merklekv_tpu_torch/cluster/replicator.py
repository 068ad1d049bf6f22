"""Replicator: native write events out, remote events applied in.

A copy of ``merklekv_tpu/cluster/replicator.py``, its imports pointed at the port's modules.

Reference analog: the reference's src/replication.rs — publish every
successful local write as a ChangeEvent on "{prefix}/events" (QoS-1 there;
QoS-0 here, upgraded by the transports' bounded outbox: events published
during a detected broker outage are buffered and flushed after the link
heals, so only the narrow undetected-death window is lossy — and
anti-entropy repairs that residue), subscribe and apply remote events with
loop prevention (src), idempotency (op_id), and per-key LWW.

Differences by design:
  - local writes are staged by the NATIVE server into an EventQueue
    (merklekv_tpu_torch/native/events.h); a drain thread batches them out instead
    of awaiting an MQTT publish inside the request path (reference
    server.rs:925-938 holds the replicator lock per command);
  - applied remote writes go straight to the shared native engine, so they
    do NOT re-enter the server's event queue — no echo loop;
  - the drained batches also feed the TPU incremental Merkle path.

The pipeline is batch-native end to end: a drained batch is coalesced per
key and published as ONE versioned envelope frame (change_event.py,
``[replication] batch_max_events`` / ``batch_max_bytes``), the drain thread
parks on the native queue's notify instead of interval polling, and an
inbound frame runs its surviving ops through ONE native
``mkv_engine_apply_batch`` crossing, ONE device-mirror staging call, and
ONE grouped WAL append. ``batch_max_events <= 1`` publishes legacy
single-event payloads (mixed-version compat mode; also the per-event
baseline ``bench.py replicated_write_throughput`` A/Bs against).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import replace as dc_replace
from typing import Callable, Optional

from merklekv_tpu_torch.cluster.applier import LWWApplier
from merklekv_tpu_torch.cluster.change_event import (
    ChangeEvent,
    OpKind,
    coalesce_events,
    decode_events_meta,
    encode_batch_cbor,
    encode_cbor,
)
from merklekv_tpu_torch.obs import tracewire
from merklekv_tpu_torch.cluster.retry import REPLICATOR_PUBLISH, RetryPolicy
from merklekv_tpu_torch.cluster.transport import Transport
from merklekv_tpu_torch.utils.tracing import get_metrics
from merklekv_tpu_torch.native_bindings import (
    OP_APPEND,
    OP_DECR,
    OP_DEL,
    OP_INCR,
    OP_PREPEND,
    OP_SET,
    OP_TRUNCATE,
    ChangeEventRaw,
    NativeEngine,
    NativeServer,
)

__all__ = ["Replicator"]

_OP_MAP = {
    OP_SET: OpKind.SET,
    OP_DEL: OpKind.DEL,
    OP_INCR: OpKind.INCR,
    OP_DECR: OpKind.DECR,
    OP_APPEND: OpKind.APPEND,
    OP_PREPEND: OpKind.PREPEND,
    OP_TRUNCATE: OpKind.TRUNCATE,
}


class Replicator:
    # Drain-thread park bound: the notify wakes it on the first staged
    # write, so this only caps how long a stop request can go unnoticed.
    IDLE_WAIT_MS = 200
    # Conservative per-event envelope overhead (op_id + field heads + ts)
    # used by the batch_max_bytes frame splitter.
    _EVENT_WIRE_OVERHEAD = 64
    # Bound on frames buffered while a bootstrap holds applies; past it,
    # frames are journaled + dropped from the buffer (anti-entropy repairs
    # the residue — same QoS-0 discipline as a publish drop).
    _MAX_HELD_FRAMES = 8192

    def __init__(
        self,
        engine: NativeEngine,
        server: NativeServer,
        transport: Transport,
        topic_prefix: str = "merkle_kv",
        node_id: str = "",
        batch_listener: Optional[Callable[[list[ChangeEvent]], None]] = None,
        mirror=None,  # Optional[DeviceTreeMirror]
        storage=None,  # Optional[DurableStore]: journals applied remote writes
        retry: Optional[RetryPolicy] = None,
        batch_max_events: int = 512,
        batch_max_bytes: int = 1 << 20,
        lag_tracker=None,  # Optional[obs.lag.ConvergenceTracker]
        max_skew_ms: int = 0,
    ) -> None:
        self._engine = engine
        self._server = server
        self._storage = storage
        self._transport = transport
        self._topic = f"{topic_prefix}/events"
        self.node_id = node_id or f"node-{uuid.uuid4().hex[:12]}"
        self._batch_listener = batch_listener
        self._mirror = mirror
        # <= 1 selects legacy per-event publishing: the wire format an
        # un-batched (older) peer understands, and the per-event baseline
        # the throughput bench A/Bs against.
        self._batch_max_events = max(0, batch_max_events)
        self._batch_max_bytes = max(1024, batch_max_bytes)
        # Publish retry under the shared cluster policy: one near-immediate
        # retry for a transient transport hiccup, then drop and count
        # (QoS-0 by design; anti-entropy repairs the residue).
        self._retry = retry if retry is not None else REPLICATOR_PUBLISH

        # Remote applies install the EVENT's timestamp through the engine's
        # LWW-conditional ops, so replication LWW, anti-entropy LWW, and the
        # store's persisted ordering are ONE ordering — a replayed event
        # older than a sync-repaired value is rejected at the shard lock,
        # not re-installed. A whole inbound frame crosses the FFI once
        # (apply_batch_fn); the applied residue feeds the device mirror and
        # the WAL as single batch calls in _on_message (applies bypass the
        # server's event queue — no echo loop — so this is the mirror's
        # only view of remote writes).
        def _store_ts(k: bytes) -> int:
            # LWW floor for the per-event fallback path: live entry ts or
            # tombstone ts, so a restarted applier (empty in-memory maps)
            # still rejects stale events against persisted state.
            return max(engine.get_ts(k) or 0, engine.tombstone_ts(k) or 0)

        self._applier = LWWApplier(
            engine.set,
            lambda k: engine.delete(k),
            set_ts_fn=lambda k, v, ts: engine.set_if_newer(k, v, ts),
            del_ts_fn=lambda k, ts: engine.delete_if_newer(k, ts),
            store_ts_fn=_store_ts,
            apply_batch_fn=engine.apply_batch,
        )
        self._applier_mu = threading.Lock()
        # Spans drain..mirror-staging: a flush() must not return while
        # another thread holds drained-but-unstaged events — once flush()
        # returns, every event acked before it is at least STAGED in the
        # mirror (the pump's publish_now() then makes it served, which is
        # what the force=true query path composes).
        self._flush_mu = threading.Lock()
        self._stop = threading.Event()
        self._drain_thread: Optional[threading.Thread] = None
        self.published = 0
        self.received = 0
        self.decode_errors = 0
        self.publish_errors = 0
        self.coalesced = 0
        self.buffered = 0
        # Convergence-lag plane (obs/lag.py): outbound frames carry a
        # publish HWM (cumulative events put on the wire — counted even for
        # frames the transport then drops, so a lost frame shows as peer
        # lag until anti-entropy converges); inbound frames feed the
        # per-peer lag gauges through this tracker.
        self._lag = lag_tracker
        self._pub_seq = 0
        # LWW clock-skew guard ([replication] max_skew_ms): an inbound
        # event stamped further than this beyond the local clock is
        # CLAMPED to now + skew BEFORE it is journaled or applied. Under
        # raw LWW a single poisoned future timestamp (one peer with a
        # misconfigured clock) fences its key against every honest writer
        # FOREVER; with the clamp the damage is bounded by the skew
        # window, after which normal writes win again. 0 disables.
        self._max_skew_ns = max(0, int(max_skew_ms)) * 1_000_000
        self.skew_clamped = 0
        # Bootstrap hold: while set, inbound frames JOURNAL (the WAL must
        # never gap) but defer their engine/mirror apply until the verified
        # snapshot is installed — then they replay in arrival order through
        # the same LWW path, so the write stream has no gap and no
        # unverified state ever serves.
        self._holding = False
        self._held: list[tuple[list[ChangeEvent], dict]] = []
        # Rebalance range-forward (double-apply): while armed, every event
        # whose key satisfies the predicate is ALSO published on the
        # forward topic — from both the local-drain side (flush) and the
        # remote-apply side (_on_message), so a write landing on any
        # replica of the donor group reaches the joiner no matter which
        # node this replicator runs on. Duplicates are harmless: the
        # joiner applies under the same LWW ts + op_id discipline as any
        # inbound frame.
        self._fwd_mu = threading.Lock()
        self._fwd_topic: Optional[str] = None
        self._fwd_pred: Optional[Callable[[bytes], bool]] = None
        self._fwd_seq = 0
        self.forwarded = 0
        # ONE pinned bound-method object for subscribe/unsubscribe:
        # transports remove subscriptions by callback IDENTITY, and
        # ``self._on_message`` evaluates to a FRESH bound method on every
        # attribute access — passing it twice hands the transport two
        # different objects, so the unsubscribe in stop() silently never
        # matched and a "disabled" replicator kept applying inbound frames.
        self._on_message_cb = self._on_message

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._server.enable_events(True)
        self._transport.subscribe(self._topic, self._on_message_cb)
        self._drain_thread = threading.Thread(
            target=self._drain_loop, daemon=True, name="mkv-replicator-drain"
        )
        self._drain_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._drain_thread is not None:
            self._drain_thread.join(timeout=5)
            self._drain_thread = None
        if self._storage is None:
            self._server.enable_events(False)
        # else: the WAL still needs every write staged — leave events on so
        # no write acked during this teardown bypasses the journal (the
        # store's own drain resumes the queue right after).
        self.flush()
        self._transport.unsubscribe(self._on_message_cb)

    # -- outbound -----------------------------------------------------------
    def flush(self) -> int:
        """Drain and publish pending native write events once."""
        with self._flush_mu:
            # Watermark BEFORE the drain: every engine mutation at or below
            # it either staged an event this drain collects, or will stage
            # one later with a higher watermark — so the mirror's staleness
            # accounting can only err conservative (see mirror.py).
            watermark = self._engine.version()
            raws = self._server.drain_events()
            if not raws:
                return 0
            events = [self._to_event(r) for r in raws]
            # Mirror first: once events leave the native queue they are the
            # mirror's only chance to see these keys — a publish failure
            # must not cost the mirror the batch. Staging is host-side and
            # cheap; the mirror's pump owns the device dispatch, so this
            # drain thread (and the write path behind it) never waits on
            # the device plane.
            if self._mirror is not None:
                try:
                    self._mirror.on_events(events, watermark=watermark)
                except Exception:
                    # Device trouble: a silently-dropped batch would serve a
                    # divergent root forever; invalidate so HASH falls back
                    # to the native path until a re-warm succeeds.
                    self._mirror.invalidate()
            # TRUNCATE stays local: it only invalidates device mirrors.
            publishable = [ev for ev in events if ev.op is not OpKind.TRUNCATE]
            if self._batch_max_events <= 1:
                published = self._publish_per_event(publishable)
            else:
                published = self._publish_frames(publishable)
            self.published += published
            if published:
                # Registry mirror of the instance counters so METRICS (and
                # the /metrics endpoint) can see replication flow without a
                # handle on this object.
                get_metrics().inc("replicator.published", published)
            self._range_forward(publishable)
            if self._batch_listener is not None:
                try:
                    self._batch_listener(events)
                except Exception:
                    pass
            return len(events)

    # -- rebalance range-forward --------------------------------------------
    def set_range_forward(
        self, topic: str, predicate: Callable[[bytes], bool]
    ) -> None:
        """Arm the double-apply: events whose encoded key satisfies
        ``predicate`` are additionally published on ``topic`` (the joiner's
        replication topic) until :meth:`clear_range_forward`."""
        with self._fwd_mu:
            self._fwd_topic = topic
            self._fwd_pred = predicate

    def clear_range_forward(self) -> None:
        with self._fwd_mu:
            self._fwd_topic = None
            self._fwd_pred = None

    def forward_events(self, topic: str, events: list[ChangeEvent]) -> int:
        """Publish ``events`` as envelope frames on an arbitrary ``topic``
        (rebalance transfer stream + commit-time sweep). The envelope src
        is this node — the joiner's echo filter keys on ITS OWN id, so
        forwarded frames always pass, while the per-event src fields keep
        their original writers for skew attribution."""
        published = 0
        for frame in self._split_frames(events):
            self._fwd_seq += len(frame)
            payload = encode_batch_cbor(
                frame,
                self.node_id,
                hwm_seq=self._fwd_seq,
                hwm_ts=time.time_ns(),
            )
            try:
                self._retry.run(
                    lambda: self._transport.publish(topic, payload),
                    retry_on=(Exception,),
                    should_stop=self._stop.is_set,
                )
                published += len(frame)
            except Exception:
                # Same QoS-0 discipline as the main topic: drop and count.
                # The rebalance flip only proceeds once donor and joiner
                # range roots MATCH, so a dropped forward frame can delay
                # the flip (re-verify retries) but never lose a key.
                self.publish_errors += 1
                get_metrics().inc("replicator.forward_errors")
        if published:
            self.forwarded += published
            get_metrics().inc("replicator.forwarded", published)
        return published

    def _range_forward(self, events: list[ChangeEvent]) -> None:
        """Forward the moving-range subset of one event batch, if armed."""
        with self._fwd_mu:
            topic, pred = self._fwd_topic, self._fwd_pred
        if topic is None or pred is None or not events:
            return
        moving = [
            ev
            for ev in events
            if ev.op is not OpKind.TRUNCATE
            and pred(ev.key.encode("utf-8", "surrogateescape"))
        ]
        if moving:
            self.forward_events(topic, moving)

    def _publish(self, payload: bytes) -> bool:
        try:
            self._retry.run(
                lambda: self._transport.publish(self._topic, payload),
                retry_on=(Exception,),
                should_stop=self._stop.is_set,
            )
            return True
        except Exception:
            # QoS-0 fabric: drop and count; anti-entropy repairs.
            self.publish_errors += 1
            get_metrics().inc("replicator.publish_errors")
            return False

    def _publish_per_event(self, events: list[ChangeEvent]) -> int:
        """Legacy mode (batch_max_events <= 1): one single-event payload per
        write — the format un-batched peers decode, and the per-event
        baseline the throughput bench measures against."""
        published = 0
        for ev in events:
            if self._publish(encode_cbor(ev)):
                published += 1
        return published

    def _publish_frames(self, events: list[ChangeEvent]) -> int:
        """Coalesce per key, split under the [replication] frame caps, and
        publish each frame as ONE envelope. A failed frame drops its whole
        event group (QoS-0 granularity is now the frame — documented in
        docs/FAULT_MODEL.md; anti-entropy repairs the residue)."""
        kept, dropped = coalesce_events(events)
        if dropped:
            self.coalesced += dropped
            get_metrics().inc("replicator.coalesced", dropped)
        published = 0
        metrics = get_metrics()
        # A traced flush (rare: read-your-writes flush inside a traced
        # cycle, tests) stamps the envelope so the apply side stitches.
        trace = tracewire.current_token()
        for frame in self._split_frames(kept):
            metrics.observe_size("replicator.batch_size", len(frame))
            # HWM counts events handed to the transport INCLUDING this
            # frame, publish-success or not: a dropped frame must read as
            # peer lag until anti-entropy repairs it (obs/lag.py).
            self._pub_seq += len(frame)
            payload = encode_batch_cbor(
                frame,
                self.node_id,
                hwm_seq=self._pub_seq,
                hwm_ts=time.time_ns(),
                trace=trace,
            )
            if self._publish(payload):
                published += len(frame)
        return published

    def _split_frames(
        self, events: list[ChangeEvent]
    ) -> list[list[ChangeEvent]]:
        frames: list[list[ChangeEvent]] = []
        cur: list[ChangeEvent] = []
        cur_bytes = 0
        for ev in events:
            # Key sized in encoded BYTES (a CJK or surrogateescape raw key
            # is up to ~4x its character count on the wire).
            size = (
                len(ev.key.encode("utf-8", "surrogateescape"))
                + len(ev.val or b"")
                + self._EVENT_WIRE_OVERHEAD
            )
            if cur and (
                len(cur) >= self._batch_max_events
                or cur_bytes + size > self._batch_max_bytes
            ):
                frames.append(cur)
                cur, cur_bytes = [], 0
            cur.append(ev)
            cur_bytes += size
        if cur:
            frames.append(cur)
        return frames

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            if self.flush() == 0:
                # Park on the native queue's notify: the first staged write
                # wakes the drain immediately (no 5 ms poll floor on idle
                # latency, no idle wakeup CPU); the timeout only bounds how
                # long a stop request waits.
                self._server.wait_events(self.IDLE_WAIT_MS)

    def _to_event(self, raw: ChangeEventRaw) -> ChangeEvent:
        return ChangeEvent(
            op=_OP_MAP[raw.op],
            key=raw.key.decode("utf-8", "surrogateescape"),
            val=raw.value if raw.has_value else None,
            ts=raw.ts_ns,
            src=self.node_id,
        )

    # -- bootstrap hold ------------------------------------------------------
    def hold_applies(self) -> None:
        """Enter bootstrap mode: inbound frames journal but defer apply."""
        with self._applier_mu:
            self._holding = True

    def release_applies(self) -> int:
        """Replay every held frame (arrival order) and resume live applies.
        Returns the number of frames replayed."""
        with self._applier_mu:
            frames, self._held = self._held, []
            self._holding = False
            replayed = 0
            for events, meta in frames:
                # Journaled at buffer time — replay must not re-journal.
                self._apply_frame(events, journal=False, meta=meta)
                replayed += len(events)
            if replayed:
                # Events, like replicator.buffered: after every release
                # buffered == buffer_replayed, and buffer_dropped counts
                # the journaled-but-never-held overflow separately.
                get_metrics().inc("replicator.buffer_replayed", replayed)
            return len(frames)

    # -- inbound ------------------------------------------------------------
    def _on_message(self, topic: str, payload: bytes) -> None:
        try:
            events, meta = decode_events_meta(payload)
        except ValueError:
            # Malformed messages (and unknown envelope versions) are
            # tolerated, like the reference's decoder fallthrough
            # (replication.rs:150-157) — counted, never applied partially.
            self.decode_errors += 1
            get_metrics().inc("replicator.decode_errors")
            return
        events = [ev for ev in events if ev.src != self.node_id]  # no echo
        if not events:
            return
        events = self._clamp_skew(events)
        self.received += len(events)
        get_metrics().inc("replicator.received", len(events))
        # Remote-apply side of the rebalance double-apply: a moving-range
        # write that landed on a SIBLING replica arrives here on the group
        # topic — relay it to the joiner too (the sibling doesn't forward;
        # only the donor node arms this). Runs before the hold check so a
        # frame buffered by a concurrent bootstrap still reaches the
        # joiner.
        self._range_forward(events)
        if self._lag is not None:
            # Record the publish HWM at DECODE time: a frame held by a
            # bootstrap (or stuck behind a slow apply) reads as lag until
            # its apply accounts for it.
            self._lag.on_frame(
                meta.get("src", ""),
                len(events),
                hseq=meta.get("hseq", 0),
                hts_ns=meta.get("hts", 0),
            )
        with self._applier_mu:
            if self._holding:
                # Journal NOW (recovery replay is LWW-conditional, so
                # journaling an event the replay later rejects is safe),
                # apply after the verified snapshot lands.
                if self._storage is not None:
                    self._storage.record_applied(
                        [
                            (
                                ev.key.encode("utf-8", "surrogateescape"),
                                None if ev.op is OpKind.DEL else ev.val,
                                ev.ts,
                            )
                            for ev in events
                            if ev.op is not OpKind.TRUNCATE
                        ]
                    )
                if len(self._held) < self._MAX_HELD_FRAMES:
                    self._held.append((events, meta))
                    self.buffered += len(events)
                    get_metrics().inc("replicator.buffered", len(events))
                else:
                    # Journaled but not replayable in RAM: anti-entropy
                    # repairs the residue (frame-loss semantics, counted;
                    # the lag plane keeps showing it until a converged
                    # anti-entropy cycle clears the residue).
                    get_metrics().inc("replicator.buffer_dropped",
                                      len(events))
                return
            self._apply_frame(events, journal=True, meta=meta)

    def _clamp_skew(self, events: list[ChangeEvent]) -> list[ChangeEvent]:
        """Clamp future-poisoned timestamps to now + max_skew_ms, counted
        with per-peer attribution (``replicator.skew_clamped.<src>``) so a
        misconfigured clock is findable, not just survived. Runs BEFORE
        journal/hold/apply — the WAL must never persist the poison."""
        if not self._max_skew_ns:
            return events
        limit = time.time_ns() + self._max_skew_ns
        clamped_by_src: dict[str, int] = {}
        out = events
        for i, ev in enumerate(events):
            if ev.ts > limit:
                if out is events:
                    out = list(events)
                out[i] = dc_replace(ev, ts=limit)
                clamped_by_src[ev.src] = clamped_by_src.get(ev.src, 0) + 1
        if clamped_by_src:
            total = sum(clamped_by_src.values())
            self.skew_clamped += total
            m = get_metrics()
            m.inc("replicator.skew_clamped", total)
            for src, n in clamped_by_src.items():
                m.inc(f"replicator.skew_clamped.{src or 'unknown'}", n)
            # Flight recorder: a poisoned clock upstream is a classic
            # slow-burn failure — the clamp burst belongs on the timeline.
            from merklekv_tpu_torch.obs.flightrec import record

            record(
                "skew_clamp",
                count=total,
                srcs=",".join(sorted(s or "unknown" for s in clamped_by_src)),
            )
        return out

    def _apply_frame(
        self,
        events: list[ChangeEvent],
        journal: bool,
        meta: Optional[dict] = None,
    ) -> None:
        """Apply one inbound frame (callers hold ``_applier_mu``): ONE
        native batch crossing, then batch fan-out of the applied residue —
        ONE mirror staging call and (when ``journal``) ONE grouped WAL
        append per frame, the exact LWW ts riding with each op."""
        t0_ns = time.time_ns()
        applied = self._applier.apply_batch(events)
        if applied:
            pairs = [
                (
                    ev.key.encode("utf-8", "surrogateescape"),
                    None if ev.op is OpKind.DEL else ev.val,
                )
                for ev in applied
            ]
            if self._mirror is not None:
                self._mirror.apply_batch(pairs)
            if journal and self._storage is not None:
                self._storage.record_applied(
                    [
                        (key, val, ev.ts)
                        for (key, val), ev in zip(pairs, applied)
                    ]
                )
        meta = meta or {}
        if self._lag is not None:
            # Account the frame's FULL decoded event count (the publisher
            # counted them all in the HWM), applied or LWW-rejected alike.
            self._lag.on_applied(
                meta.get("src", ""),
                len(events),
                hts_ns=meta.get("hts", 0),
                oldest_event_ts_ns=min((ev.ts for ev in events), default=0),
            )
        tc = meta.get("tc")
        if tc:
            # Traced envelope: this apply stitches into the originating
            # write's trace as an applier-role span.
            ctx = tracewire.parse_token(tc)
            if ctx is not None:
                tracewire.get_collector().record(
                    trace_id=ctx.trace_id,
                    span_id=tracewire._new_id(),
                    parent_id=ctx.span_id,
                    name="replicate.apply",
                    role="applier",
                    ts_ns=t0_ns,
                    dur_ns=time.time_ns() - t0_ns,
                    node=self.node_id,
                )

    # -- introspection -------------------------------------------------------
    @property
    def applier(self) -> LWWApplier:
        return self._applier
