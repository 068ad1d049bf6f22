"""Event-driven cache invalidation: the router rides the replication bus.

A copy of ``merklekv_tpu/requestplane/invalidation.py``, its imports pointed at
the port's modules (``change_event.decode_events_meta`` is the port's).

The router subscribes (read-only) to the same per-partition replication
topics the replica groups already publish on —
``<prefix>/p<pid>/events`` — and applies each envelope's key events to
the read cache the moment they arrive. No new wire surface: the envelope
(change_event.encode_batch_cbor) already carries everything needed:

- ``events[].key`` — the exact entries to drop;
- ``hseq`` — the publisher's cumulative event HWM INCLUDING frames it
  dropped, so a jump bigger than this frame's batch proves we MISSED
  invalidations → flush the whole partition's entries (we cannot know
  which keys went stale);
- ``hts`` — publish wall-clock ns, giving the router a live
  invalidation-lag measurement (clamped at 0 for clock skew).

The undetectable residue — frames lost with no later frame from that
publisher to expose the gap (QoS-0, broker death, router link down) — is
bounded by the cache's hard ``max_age_ms``; docs/PROTOCOL.md "Router
semantics" states the resulting client-visible staleness bound.
"""

from __future__ import annotations

import re
import threading
import time

from merklekv_tpu_torch.cluster.change_event import OpKind, decode_events_meta
from merklekv_tpu_torch.obs.flightrec import get_recorder
from merklekv_tpu_torch.utils.tracing import get_metrics

__all__ = ["InvalidationFeed"]

_TOPIC_RE = re.compile(r"/p(\d+)/events$")


class InvalidationFeed:
    """Subscribes a Transport to the cluster's replication topics and
    drives a LeaseCache's event-driven invalidation."""

    def __init__(self, cache, transport, topic_prefix: str) -> None:
        self._cache = cache
        self._transport = transport
        self._prefix = topic_prefix.rstrip("/")
        self._mu = threading.Lock()
        # (topic, src) -> last seen cumulative hseq; reset on epoch flips.
        self._hwm: dict[tuple[str, str], int] = {}
        self.last_lag_ms = 0.0
        self.frames = 0
        # Pin the bound method: Transport.unsubscribe matches by identity.
        self._cb = self._on_message
        transport.subscribe(self._prefix + "/", self._cb)

    def close(self) -> None:
        try:
            self._transport.unsubscribe(self._cb)
        except Exception:
            pass

    def reset(self) -> None:
        """Forget per-publisher HWMs (map epoch flip: partition ids and
        topics renumber; stale HWMs would read as giant gaps)."""
        with self._mu:
            self._hwm.clear()

    # -- feed ---------------------------------------------------------------
    def _on_message(self, topic: str, payload: bytes) -> None:
        mt = _TOPIC_RE.search(topic)
        if mt is None:
            return  # rebalance forward topics etc. — not an event stream
        pid = int(mt.group(1))
        m = get_metrics()
        try:
            events, meta = decode_events_meta(payload)
        except Exception:
            m.inc("router.inval_decode_errors")
            return
        self.frames += 1
        m.inc("router.inval_frames")
        src = str(meta.get("src", ""))
        hseq = meta.get("hseq")
        hts = meta.get("hts")
        if isinstance(hts, int) and hts > 0:
            self.last_lag_ms = max(0.0, (time.time_ns() - hts) / 1e6)
            m.observe("router.inval_lag", self.last_lag_ms / 1e3)
        gap = False
        if isinstance(hseq, int):
            hw_key = (topic, src)
            with self._mu:
                last = self._hwm.get(hw_key)
                self._hwm[hw_key] = max(hseq, last or 0)
            # First frame from a publisher sets the baseline — the cache
            # was filled only after we subscribed, so nothing before it
            # can be stale. After that, hseq - len(events) > last means
            # frames vanished between this one and the last we saw.
            gap = last is not None and (hseq - len(events)) > last
        if gap:
            flushed = self._cache.flush_partition(pid)
            m.inc("router.inval_gap_flushes")
            get_recorder().record(
                "router_inval_gap", partition=pid, flushed=flushed,
                src=src, hseq=hseq or 0,
            )
            return
        for ev in events:
            if ev.op == OpKind.TRUNCATE or not ev.key:
                # Keyspace-wide mutation (or a malformed event): drop the
                # partition's entries — precision is not recoverable.
                self._cache.flush_partition(pid)
                return
            self._cache.invalidate(ev.key)
