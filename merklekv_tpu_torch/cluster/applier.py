"""Pure LWW + idempotency application logic.

A copy of ``merklekv_tpu/cluster/applier.py``, its imports pointed at the port's modules.

Mirrors the reference subscriber's rules (replication.rs:272-318) with the
deterministic tie-break from its LocalApplier double (change_event.rs:222-246):
  - drop events whose op_id was already applied (idempotency under QoS-1
    at-least-once delivery);
  - drop events older than the key's last applied ts (LWW);
  - on a ts tie, keep the lexicographically larger op_id (total order);
  - Del removes, everything else writes the post-op value.

Improvements over the reference: the reference's `seen`/`last_ts` maps grow
without bound and die with the process (replication.rs:277-278 TODO); here
the dedupe set is LRU-bounded, and when the store tracks per-key last-write
timestamps (``store_ts_fn``), the LWW floor is read from the STORE — so the
ordering survives an applier restart and agrees with anti-entropy repairs
instead of maintaining a second, divergent in-memory ordering.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

from merklekv_tpu_torch.cluster.change_event import ChangeEvent, OpKind

__all__ = ["LWWApplier"]


class LWWApplier:
    """Applies ChangeEvents onto set/delete callables (engine-agnostic).

    Callables:
      set_fn(key, value)          — plain install (no ts tracking).
      del_fn(key)                 — plain delete.
      set_ts_fn(key, value, ts)   — install carrying the EVENT's ts; should
                                    be LWW-conditional (engine set_if_newer)
                                    when the store tracks timestamps, and
                                    return truthy iff state advanced.
      del_ts_fn(key, ts)          — delete carrying the event's ts (engine
                                    del_if_newer records the tombstone);
                                    returns truthy iff state advanced.
      store_ts_fn(key) -> int     — the store's authoritative last-write
                                    floor for a key: max(entry ts, tombstone
                                    ts), 0 if unknown. Consulted IN ADDITION
                                    to the in-memory map, so a restarted
                                    applier (empty maps) still rejects stale
                                    events against repaired/persisted state.
      apply_batch_fn(ops) -> flags — run a whole frame of LWW-conditional
                                    ops (``(key, value|None-for-del, ts)``)
                                    in ONE engine call, returning one
                                    applied flag per op. When wired,
                                    :meth:`apply_batch` crosses the FFI
                                    once per frame instead of once per
                                    event, and the engine (not a host-side
                                    ts floor) is the LWW authority.
    """

    def __init__(
        self,
        set_fn: Callable[[bytes, bytes], None],
        del_fn: Callable[[bytes], None],
        max_seen: int = 1 << 20,
        set_ts_fn: Optional[Callable[[bytes, bytes, int], None]] = None,
        del_ts_fn: Optional[Callable[[bytes, int], None]] = None,
        store_ts_fn: Optional[Callable[[bytes], int]] = None,
        apply_batch_fn: Optional[
            Callable[[list[tuple[bytes, Optional[bytes], int]]], list[bool]]
        ] = None,
    ) -> None:
        self._set = set_fn
        self._set_ts = set_ts_fn
        self._del = del_fn
        self._del_ts = del_ts_fn
        self._store_ts = store_ts_fn
        self._apply_batch_fn = apply_batch_fn
        self._seen: OrderedDict[bytes, None] = OrderedDict()
        self._max_seen = max_seen
        self._last_ts: dict[str, int] = {}
        self._last_op_id: dict[str, bytes] = {}
        self.applied = 0
        self.skipped_dup = 0
        self.skipped_lww = 0

    def apply(self, ev: ChangeEvent) -> bool:
        """Apply one event; returns True if state changed."""
        if ev.op_id in self._seen:
            self.skipped_dup += 1
            return False
        # surrogateescape round-trips keys that were decoded from non-UTF-8
        # wire bytes (replicator._to_event) — strict encoding would raise
        # and the transport callback guard would silently drop the event.
        key = ev.key.encode("utf-8", "surrogateescape")
        mem_ts = self._last_ts.get(ev.key, 0)
        last_ts = mem_ts
        if self._store_ts is not None:
            last_ts = max(last_ts, self._store_ts(key))
        if ev.ts < last_ts:
            self._remember(ev.op_id)
            self.skipped_lww += 1
            return False
        # Equal-ts arbitration: with engine-conditional ops wired
        # (set_ts_fn -> set_if_newer), the ENGINE breaks exact-ts ties by
        # value digest — a deterministic order that survives applier
        # restarts and matches anti-entropy's (ts, liveness, digest) rule,
        # so replication alone converges cross-writer equal-ts conflicts.
        # An in-memory op_id tie-break here would fight it: after a restart
        # (maps empty) replicas that applied in different orders would
        # disagree about which event "came first". Only the plain-callable
        # path (test doubles without ts tracking) keeps the op_id rule,
        # since a dict store has no digest arbitration of its own.
        if (
            self._set_ts is None
            and ev.ts == mem_ts
            and ev.op_id < self._last_op_id.get(ev.key, b"\0" * 16)
        ):
            self._remember(ev.op_id)
            self.skipped_lww += 1
            return False

        # The ts-carrying fns are LWW-conditional in the engine (set_if_newer
        # / del_if_newer) and report whether state actually advanced — an
        # equal-ts digest-losing SET or an already-covered DEL is a rejection
        # and must count as an LWW skip, not an apply. The plain callables
        # (dict-store doubles) apply unconditionally.
        changed = True
        if ev.op is OpKind.DEL:
            if self._del_ts is not None:
                changed = bool(self._del_ts(key, ev.ts))
            else:
                self._del(key)
        elif ev.val is not None:
            # Post-op value semantics: INCR/DECR/APPEND/PREPEND all apply as
            # an absolute SET of the result (change_event.rs:17-19).
            if self._set_ts is not None:
                changed = bool(self._set_ts(key, ev.val, ev.ts))
            else:
                self._set(key, ev.val)
        else:
            changed = False  # SET-like op with no value: nothing to install
        self._remember(ev.op_id)
        if not changed:
            self.skipped_lww += 1
            return False
        self._last_ts[ev.key] = ev.ts
        self._last_op_id[ev.key] = ev.op_id
        self.applied += 1
        return True

    def apply_batch(self, events: list[ChangeEvent]) -> list[ChangeEvent]:
        """Apply one decoded wire frame; returns the events that changed
        state (in frame order).

        With ``apply_batch_fn`` wired (the native engine's batched
        LWW-conditional call), all surviving ops cross the FFI ONCE —
        dedupe and the cheap in-memory ts floor still prefilter here, but
        the engine's conditional verbs are the LWW authority (a per-event
        ``store_ts_fn`` consult would reintroduce two FFI calls per event,
        and the engine rejects stale timestamps anyway). Without it, falls
        back to per-event :meth:`apply` (plain-callable test doubles).
        """
        if self._apply_batch_fn is None:
            return [ev for ev in events if self.apply(ev)]
        pending: list[ChangeEvent] = []
        ops: list[tuple[bytes, Optional[bytes], int]] = []
        batch_seen: set[bytes] = set()
        for ev in events:
            if ev.op_id in self._seen or ev.op_id in batch_seen:
                # _seen is only updated after the engine call, so a
                # duplicated op INSIDE one frame needs the batch-local set.
                self.skipped_dup += 1
                continue
            batch_seen.add(ev.op_id)
            if ev.ts < self._last_ts.get(ev.key, 0):
                self._remember(ev.op_id)
                self.skipped_lww += 1
                continue
            key = ev.key.encode("utf-8", "surrogateescape")
            if ev.op is OpKind.DEL:
                pending.append(ev)
                ops.append((key, None, ev.ts))
            elif ev.val is not None:
                pending.append(ev)
                ops.append((key, ev.val, ev.ts))
            else:  # SET-like op with no value: nothing to install
                self._remember(ev.op_id)
                self.skipped_lww += 1
        if not ops:
            return []
        flags = self._apply_batch_fn(ops)
        applied: list[ChangeEvent] = []
        for ev, flag in zip(pending, flags):
            self._remember(ev.op_id)
            if flag:
                self._last_ts[ev.key] = ev.ts
                self._last_op_id[ev.key] = ev.op_id
                self.applied += 1
                applied.append(ev)
            else:
                self.skipped_lww += 1
        return applied

    def _remember(self, op_id: bytes) -> None:
        self._seen[op_id] = None
        if len(self._seen) > self._max_seen:
            self._seen.popitem(last=False)

    def last_ts(self, key: str) -> Optional[int]:
        return self._last_ts.get(key)
