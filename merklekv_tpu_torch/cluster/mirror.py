"""DeviceTreeMirror: a live device-resident Merkle tree behind serving HASH
(copy of ``merklekv_tpu/cluster/mirror.py``, with the same public API, the
same staleness and watermark contract, and the same pump, coalescing,
publish, scrub, heal probe and fallback heartbeat).

What differs from the JAX mirror, and only this:

- **engine**: any object with ``version()``, ``snapshot()`` and ``get()``
  (:class:`MirrorEngine`); the mirror never needs the native engine's type.
- **device**: ``device=None`` (CUDA) or ``"cpu"``, resolved at construction
  by ``utils/torchenv.resolve_device`` — without a GPU, ``device=None``
  raises there, before any ladder exists, so a missing card can never turn
  into a quiet CPU-rung mirror.
- **devices**: ``sharding`` (``auto|off|N``) resolves against the mirror's
  ``devices`` list — every card of the host by default, ``[cpu]`` for
  ``device="cpu"``; tests and the smoke script pass an explicit list, which
  may repeat a device (``["cpu"] * 8``, ``[cuda:0] * 4``).
- **rungs**: ``_build_state`` and ``_probe_rung`` build through the port's
  ``device/ladder.py::build_state_for_rung``: rungs >= 2 the port's
  ``ShardedDeviceMerkleState`` over the first N of ``devices``, rung 1 the
  torch ``DeviceMerkleState`` on ``device``, rung 0 the port's
  ``CpuMerkleState``, which is also the heal probe's golden root. Only a
  mirror built with ``device="cpu"`` has rung 0. The ladder of a mirror on the card ends at
  rung 1, so its work never moves to the host: a build that fails there
  raises, and the failure is counted (``device.warm_errors``) and recorded
  (a ``device_warm_failed`` flight event).
- **drain failures**: the torch state's value scatter writes the tree's
  levels in place, so a drain that failed part-way (or a dispatch still
  running when the guard gave up on it) can leave levels that hash to
  neither the published root nor the next one. The JAX mirror keeps serving
  the last publish below the degrade threshold; this one invalidates on
  EVERY drain failure (queries read None, the native fallback's answer) and
  re-warms from an engine snapshot, retried by the pump under
  ``retry.DEVICE_HEAL`` backoff until it lands (``device.rewarms`` and a
  ``device_rewarm`` flight event per failure). The failure still counts
  against the ladder by its classified kind.

The reference recomputes its tree from scratch on demand (HASH scans and
rehashes every leaf, server.rs:647-684) and never feeds writes into the tree
(TODO at replication.rs:312-316). Here the native server stages every write
into the event queue; the replicator drains them and this mirror applies the
batches to a ``DeviceMerkleState`` — value updates are O(k log C) scatters on
device, so a warm HASH answer costs one promotion-chain walk instead of an
O(n) rehash.

Freshness contract (the async-Merkle design, PAPERS.md arxiv 2311.17441):
writes never wait on the device plane. Staging an event batch is one lock +
one host-dict update; the **device-update pump** — a background thread owned
by this mirror — drains staged changes into incremental scatter dispatches
on its own cadence and PUBLISHES the result as the served snapshot
(version + generation + lazily cached root). Root-serving queries read the
last-published snapshot and therefore trail the live engine by a BOUNDED
window, governed by ``[device] max_staleness_ms`` / ``max_staleness_versions``:

  - idle -> the first staged batch wakes the pump and publishes immediately;
  - sustained load -> publishes are rate-limited to a small coalesce
    interval (a fraction of the window), so backlog accumulates into larger
    scatter dispatches instead of one device program per event batch — the
    adaptive sizing is emergent: arrival rate x publish latency = batch size;
  - the window is a hard serving bound: a breach (or a wedged pump) raises
    a ``tree_staleness`` flight event, and the staleness gauge reads the
    exact version lag.

Exactness escape hatch: ``publish_now()`` drains synchronously — the
``force=true`` query path (snapshot stamping, tests) and the wire-level
forced refresh use it. Every published answer can be stamped with
``published_version()`` so readers (anti-entropy) know which engine version
the tree reflects.

Watermark semantics (what makes ``staleness()`` exact): every staging call
carries the engine mutation version its events are covered through — the
replicator reads ``engine.version()`` BEFORE draining the native queue, so
the watermark can only UNDERSTATE coverage (a racing write either made the
drain or stages its own later event with a higher watermark). The pump's
published version is the watermark of the last drained staging, hence
``engine.version() - published_version`` never under-reports how far the
served tree trails. Remote-apply staging reads the version after its own
engine apply; a concurrent local write inside that instant can be counted
one drain cycle early — transient, corrected by the next local drain's
conservative watermark.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional, Protocol

from merklekv_tpu_torch.cluster.change_event import ChangeEvent, OpKind
from merklekv_tpu_torch.cluster.retry import DEVICE_HEAL
from merklekv_tpu_torch.device.guard import DeviceDispatchError, configure as _configure_guard
from merklekv_tpu_torch.device.ladder import (
    DeviceBackendLadder,
    build_state_for_rung,
)
from merklekv_tpu_torch.obs.metrics import get_metrics
from merklekv_tpu_torch.utils.errorkind import classify_exception
from merklekv_tpu_torch.utils.torchenv import resolve_device

__all__ = ["DeviceTreeMirror", "MirrorEngine"]


class MirrorEngine(Protocol):
    """What the mirror reads of the key-value engine."""

    def version(self) -> int:
        """Mutation version, bumped by every write."""

    def snapshot(self) -> list[tuple[bytes, bytes]]:
        """The whole keyspace as (key, value) pairs, sorted by key."""

    def get(self, key: bytes) -> Optional[bytes]:
        """The key's current value, or None when it is absent."""


# One tree_staleness flight flag per this many seconds (same one-flag-per-
# window discipline as the blackbox slow-command bursts).
_STALENESS_FLAG_WINDOW_S = 10.0

# One device_fallback heartbeat per this many seconds while a previously
# ready mirror serves off the native fallback (post-invalidate) — a node on
# the fallback rung must be visible in the flight timeline, not silent.
_FALLBACK_FLAG_WINDOW_S = 10.0


class DeviceTreeMirror:
    def __init__(
        self,
        engine: MirrorEngine,
        sharded: bool = False,
        max_staleness_ms: float = 200.0,
        max_staleness_versions: int = 0,
        sharding: str = "off",
        dispatch_deadline_ms: Optional[float] = None,
        scrub_interval_s: float = 30.0,
        scrub_keys: int = 256,
        degrade_after: int = 2,
        ladder: Optional[DeviceBackendLadder] = None,
        device=None,
        devices=None,
    ) -> None:
        self._engine = engine
        # Serving-tree backend selection ([device] sharding = auto|off|N):
        # "off" keeps the single-device DeviceMerkleState; anything else
        # resolves at the first build (``_resolve_shards``) against the
        # device list. ``sharded`` is the deprecated boolean alias (== "auto").
        mode = str(sharding).strip().lower()
        self._sharding_mode = "auto" if (sharded and mode == "off") else mode
        # The device rung 1 lives on; None means CUDA and raises without a
        # GPU, here, never later inside a warm build that would step down.
        self._device = resolve_device(device)
        self._devices = devices
        if ladder is not None and self._device.type != "cpu" and ladder.bottom() == 0:
            raise ValueError(
                "a mirror on the card never steps down to the CPU rung: "
                "give it a ladder built with cpu_rung=False"
            )
        self._mu = threading.RLock()
        self._state = None  # lazy: built from an engine snapshot on first use
        self._warming = threading.Event()
        self._warm_thread: Optional[threading.Thread] = None
        self._closed = False
        # While a warm build runs outside the lock, writes landing meanwhile
        # are recorded here (keys only) and replayed against the engine's
        # current values when the built state is swapped in.
        self._pending: Optional[set] = None
        self._pending_truncate = False
        # Freshness contract ([device]): the serving window the pump keeps
        # the published tree inside. ms is the wall bound; versions (0=off)
        # additionally forces an immediate publish once the backlog deepens
        # past it (skipping the coalesce delay).
        self._window_s = max(0.001, float(max_staleness_ms) / 1000.0)
        self._max_lag_versions = max(0, int(max_staleness_versions))
        # Publish rate limit under sustained load — the emergent-batching
        # knob. A fraction of the window so several pump cycles always fit
        # inside the contract.
        self._coalesce_s = min(0.005, self._window_s / 8.0)
        # Engine-version watermark the staging covers (see module
        # docstring) and the watermark of the last PUBLISHED snapshot.
        self._staged_version = 0
        self._published_version = 0
        self._published_gen = 0  # bumps on every publish; keys the root cache
        # The published (root, version) pair — the ONLY root cache: one
        # immutable tuple assigned under _mu, read WITHOUT it by the
        # root-serving fast path — a HASH never waits behind a pump drain
        # holding the mirror lock across a device dispatch. Root is None
        # while warming / after invalidate / when a publish had no eager
        # root (the locked lazy path refills it).
        self._pub_snapshot: tuple[Optional[str], int] = (None, 0)
        self._staged_since_m: Optional[float] = None  # oldest unpublished stage
        self._last_publish_m = 0.0
        self._staleness_flagged_m = -1e18
        # The device-update pump.
        self._pump_wake = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None
        # Test hook: callable raised/invoked inside the pump's drain (chaos
        # tests kill the pump mid-drain through it). None in production.
        self._pump_inject = None
        # Fault containment ([device]): every dispatch under the warm
        # build, the pump, and the query paths runs deadline-guarded —
        # process-wide guard, last EXPLICIT configuration wins
        # (documented). A mirror built without a deadline must not clobber
        # a node's configured value with the guard default.
        if dispatch_deadline_ms is not None:
            _configure_guard(deadline_ms=dispatch_deadline_ms)
        # The degradation ladder. Resolved lazily at the first build unless
        # a test injected one.
        self._ladder = ladder
        self._degrade_after = max(1, int(degrade_after))
        # Integrity scrub: low-rate background cross-check of served
        # device leaf digests against the CPU golden hash over a sampled
        # range (0 = off).
        self._scrub_interval_s = float(scrub_interval_s)
        self._scrub_keys = max(1, int(scrub_keys))
        self._scrub_rng = random.Random()
        self._last_scrub_m = time.monotonic()
        # Fallback-serving heartbeat state (see _check_fallback_heartbeat).
        self._was_ready = False
        self._fallback_flagged_m = -1e18
        self._replacing = False  # a replace-warm (heal re-warm) in flight
        self._probing = False  # a heal-probe pass in flight (own thread)
        self._scrubbing = False  # a scrub pass in flight (own thread)
        self._scrub_thread: Optional[threading.Thread] = None
        # Re-warm after a drain failure: when the pump next starts one
        # (monotonic time; None = none owed) and how many failed in a row.
        self._rewarm_at_m: Optional[float] = None
        self._rewarm_fails = 0

    # -- warm-up -------------------------------------------------------------
    def ready(self) -> bool:
        return self._state is not None

    def invalidate(self) -> None:
        """Throw the device state away (e.g. after a failed batch apply);
        the next HASH request answers natively and triggers a re-warm.
        While the state is gone, a previously ready mirror emits one
        ``device_fallback`` heartbeat per 10 s window (the flight
        sampler's gauge poll drives it) so fallback serving is visible in
        the timeline, not silent."""
        with self._mu:
            self._state = None
            self._pending = None
            self._pub_snapshot = (None, 0)
            self._staged_since_m = None
        self._warming.clear()

    def close(self) -> None:
        """Stop using the engine. MUST be called before the native engine is
        destroyed — the warm thread and the pump read through its raw
        pointer."""
        with self._mu:
            self._closed = True
        self._pump_wake.set()
        p = self._pump_thread
        if p is not None and p.is_alive():
            p.join(timeout=30)
        t = self._warm_thread
        if t is not None and t.is_alive():
            t.join(timeout=30)
        s = self._scrub_thread
        if s is not None and s.is_alive():
            s.join(timeout=30)

    def start_warming(self) -> None:
        """Build the device state off the serving path.

        The first device use pays the kernel build (seconds); HASH must not
        stall behind it, so the server keeps answering from
        the native path until ``ready()``. The build runs OUTSIDE the
        mirror lock — holding it would stall the replicator drain loop and
        inbound LWW applies for the whole compile. Writes landing during
        the build are recorded (keys only) and replayed from the engine's
        current values at swap-in; a truncate mid-build restarts it. The
        build itself rides the degradation ladder: on a CPU mirror a rung
        whose dispatch fails steps down, so warming completes at SOME rung
        (the CPU golden tree is infallible); on the card the ladder ends at
        rung 1, and a failed build is reported, never served around."""
        self._ensure_pump()
        if self._warming.is_set():
            return
        self._warming.set()
        self._spawn_warm(replace=False)

    def _start_replace_warm(self) -> None:
        """Re-warm at the ladder's (newly climbed) rung while the CURRENT
        state keeps serving — the heal path's zero-downtime rebuild. The
        old snapshot answers queries until the new state swaps in under
        one lock hold; version stamps stay monotone (publish always
        max()es)."""
        with self._mu:
            if self._closed or self._replacing:
                return
            self._replacing = True
        self._spawn_warm(replace=True)

    def _spawn_warm(self, replace: bool) -> None:
        def warm() -> None:
            try:
                self._warm_body(replace)
            finally:
                if replace:
                    with self._mu:
                        self._replacing = False
            # The ladder may have climbed again while this build ran —
            # the pump's _maybe_heal invariant check re-warms at the
            # final rung next wake; poke it so that happens promptly.
            if replace and not self._closed:
                self._pump_wake.set()

        self._warm_thread = threading.Thread(
            target=warm, daemon=True, name="mkv-mirror-warm"
        )
        self._warm_thread.start()

    def _warm_body(self, replace: bool) -> None:
        mine: Optional[set] = None
        try:
            for _attempt in range(3):
                with self._mu:
                    if self._closed:
                        return
                    if self._state is not None and not replace:
                        return
                    # Ownership-tagged pending set: invalidate() (sets it
                    # None) or a concurrently spawned warm (replaces it)
                    # both ORPHAN this attempt's recording — the swap-in
                    # below checks identity and restarts from a fresh
                    # snapshot rather than install a state whose
                    # mid-build writes were recorded into someone else's
                    # set (that stamped-fresh-but-missing-writes state
                    # would serve a silently wrong root).
                    mine = set()
                    self._pending = mine
                    self._pending_truncate = False
                    # Watermark BEFORE the snapshot: every mutation at
                    # or below it is in the snapshot by construction;
                    # later ones either land in _pending or stage their
                    # own event with a higher watermark.
                    v0 = self._engine.version()
                    items = self._engine.snapshot()
                st = self._build_state(items)
                # Pay the build + kernel-compile cost HERE so the first
                # post-warm HASH answers immediately.
                st.root_hex()
                with self._mu:
                    if self._closed:
                        return
                    if self._pending is not mine:
                        continue  # orphaned (invalidate/new warm); redo
                    if self._pending_truncate:
                        self._pending = None
                        continue  # keyspace vanished mid-build; redo
                    pend, self._pending = self._pending, None
                    # The replay below fixes VALUES for keys whose events
                    # already drained into pend, but it cannot raise the
                    # coverage watermark past v0: local writes reach
                    # _pending only through the async drain, so a write
                    # between v0 and the current engine version may be in
                    # neither the snapshot nor pend. Fencing to the
                    # current version would OVERCLAIM — staleness() reads
                    # 0 for a tree missing that write, and the scrub's
                    # quiescence check would then call the miss silent
                    # corruption. v0 understates at worst (allowed); the
                    # write's own event bumps the watermark when it
                    # drains.
                    if pend:
                        st.apply(
                            [(k, self._engine.get(k)) for k in pend]
                        )
                        st.flush_pending()
                    # Eager root BEFORE the install (same contract as
                    # publish_now): a failing walk unwinds into the warm
                    # retry path with nothing half-published.
                    root = st.root_hex(flush=False)
                    self._state = st
                    self._was_ready = True
                    self._staged_version = max(
                        self._staged_version, v0
                    )
                    self._publish_locked()
                    self._pub_snapshot = (root, self._published_version)
                    self._warming.set()
                    self._rewarm_at_m = None
                    self._rewarm_fails = 0
                    return
        except Exception as e:
            self._note_warm_failure(e)
        finally:
            # Never leak a live recording set from a dead attempt: fresh
            # staging would keep feeding keys no warm will ever consume.
            with self._mu:
                if mine is not None and self._pending is mine:
                    self._pending = None
        if not replace:
            self._warming.clear()  # allow a retry
        # A failed REPLACE warm leaves the old state serving; _warming
        # stays set (its meaning — "a built state is in place") and the
        # pump's heal/invariant pass schedules another attempt.

    # -- event feeds (staging: never device work beyond PENDING_LIMIT) -------
    def on_events(
        self, events: list[ChangeEvent], watermark: Optional[int] = None
    ) -> None:
        """Local writes, drained from the native event queue in batches.

        The event's payload value is deliberately ignored: local events
        arrive asynchronously (drain thread) while remote LWW applies land
        inline, so replaying stale payloads could leave the mirror on an
        older value than the engine. Re-reading the engine's CURRENT value
        for each touched key makes every batch a convergence step — any
        write racing the read stages its own later event.

        ``watermark`` is the engine version read BEFORE the queue drain
        (conservative coverage — see the module docstring); None falls back
        to a read at staging time."""
        with self._mu:
            if self._closed:
                return
            if self._state is None:
                self._note_pending(
                    (ev.key.encode("utf-8", "surrogateescape")
                     if ev.op is not OpKind.TRUNCATE else None)
                    for ev in events
                )
                return
            touched: dict[bytes, None] = {}
            truncated = False
            for ev in events:
                if ev.op is OpKind.TRUNCATE:
                    # Everything before the truncate is dead.
                    touched.clear()
                    self._state = self._empty_state()
                    truncated = True
                    continue
                touched[ev.key.encode("utf-8", "surrogateescape")] = None
            if touched:
                self._stage_locked(
                    [(k, self._engine.get(k)) for k in touched]
                )
            if self._pending is not None:
                # A replace re-warm (ladder heal) is building a successor
                # state off the engine snapshot: record these keys for
                # replay at its swap-in, like the initial warm does.
                if truncated:
                    self._note_pending([None])
                self._note_pending(iter(touched))
            self._note_staged(watermark)
            if truncated:
                # The served tree content changed in place (reset): flush
                # whatever was staged after the truncate and publish, so the
                # generation moves with the content and stamps stay
                # truthful.
                try:
                    self._state.flush_pending()
                except BaseException as e:
                    self._on_drain_failure(e)
                    raise
                self._publish_locked()
        self._ensure_pump()  # a dead pump is respawned by fresh staging
        self._pump_wake.set()

    def apply_one(self, key: bytes, value: Optional[bytes]) -> None:
        """One remote write (anti-entropy repair hook)."""
        self.apply_batch([(key, value)])

    def apply_batch(self, pairs: list[tuple[bytes, Optional[bytes]]]) -> None:
        """Remote writes from one decoded replication frame: ONE lock
        acquisition and ONE device-state staging call for the whole frame
        (per-key applies paid both per event — at sustained remote write
        rates the lock/stage overhead, not the device math, dominated)."""
        if not pairs:
            return
        with self._mu:
            if self._closed:
                return
            if self._state is None:
                self._note_pending(k for k, _ in pairs)
                return
            self._stage_locked(pairs)
            if self._pending is not None:
                # Replace re-warm in flight: replay these at swap-in too.
                self._note_pending(k for k, _ in pairs)
            self._note_staged(None)
        self._ensure_pump()  # a dead pump is respawned by fresh staging
        self._pump_wake.set()

    def _stage_locked(self, pairs) -> None:
        """Stage on the state (lock held). Staging flushes inline at the
        state's PENDING_LIMIT; a flush that fails there is a drain failure
        like the pump's."""
        try:
            self._state.apply(pairs)
        except BaseException as e:
            self._on_drain_failure(e)
            raise

    def _note_staged(self, watermark: Optional[int]) -> None:
        """Bookkeeping after a staging call (lock held): advance the staged
        watermark, start the lag clock, and — when the state auto-flushed at
        PENDING_LIMIT — publish inline so the served tree content can never
        move without a generation/version bump."""
        wm = watermark if watermark is not None else self._engine.version()
        self._staged_version = max(self._staged_version, wm)
        if self._staged_since_m is None:
            self._staged_since_m = time.monotonic()
        if self._state is not None and self._state.pending_count() == 0:
            # DeviceMerkleState.apply flushed at its PENDING_LIMIT ceiling:
            # the built tree just advanced past the published generation.
            self._publish_locked()

    def _note_pending(self, keys) -> None:
        """Record writes landing during a warm build (lock held by caller).
        A None entry marks a truncate, which invalidates the whole build."""
        if self._pending is None:
            return  # no build in flight; the eventual snapshot covers these
        for k in keys:
            if k is None:
                self._pending_truncate = True
                self._pending.clear()
            else:
                self._pending.add(k)

    # -- the device-update pump ----------------------------------------------
    def _ensure_pump(self) -> None:
        """Start (or restart after a death) the pump thread. Cheap when the
        thread is alive; a pump killed by device trouble mid-drain is
        respawned by the next warm-up, so one wedged drain never leaves the
        mirror permanently unpumped."""
        with self._mu:
            if self._closed:
                return
            p = self._pump_thread
            if p is not None and p.is_alive():
                return
            self._pump_thread = threading.Thread(
                target=self._pump_loop, daemon=True, name="mkv-mirror-pump"
            )
            self._pump_thread.start()

    def _pump_loop(self) -> None:
        while True:
            self._pump_wake.wait(timeout=self._window_s)
            self._pump_wake.clear()
            with self._mu:
                if self._closed:
                    return
                st = self._state
                ver_lag = self._staged_version - self._published_version
                behind = (
                    st is not None
                    and (st.pending_count() > 0 or ver_lag > 0)
                )
            if behind:
                # Coalesce under sustained load: a publish that would land
                # hot on the heels of the previous one waits a beat so the
                # backlog accumulates into one larger scatter dispatch.
                # Idle arrivals (last publish long ago) and deep backlogs
                # (past the versions knob, measured in ENGINE MUTATIONS
                # like the config documents — a hot single key rewritten N
                # times is N versions behind, not 1 staged key) drain
                # immediately.
                since = time.monotonic() - self._last_publish_m
                wait = self._coalesce_s - since
                deep = (
                    self._max_lag_versions
                    and ver_lag >= self._max_lag_versions
                )
                if wait > 0 and not deep:
                    time.sleep(min(wait, self._window_s / 2))
                staged_since = self._staged_since_m  # a failed drain clears it
                try:
                    self.publish_now()
                    get_metrics().inc("device.pump_batches")
                    if self._ladder is not None:
                        self._ladder.note_success()
                except Exception:
                    # publish_now already invalidated the state and owed a
                    # re-warm (_on_drain_failure); flag the timeline here.
                    get_metrics().inc("device.pump_errors")
                    try:
                        lag_ms = (
                            0.0 if staged_since is None
                            else (time.monotonic() - staged_since) * 1000.0
                        )
                        # Quiet the generic breach flag for a window: this
                        # explicit event IS the flag for this failure.
                        self._staleness_flagged_m = time.monotonic()
                        from merklekv_tpu_torch.obs.flightrec import record

                        record(
                            "tree_staleness",
                            lag_ms=int(lag_ms),
                            lag_versions=int(max(0, ver_lag)),
                            window_ms=int(self._window_s * 1000),
                            drain_failed=1,
                        )
                    except Exception:
                        pass
            self._maybe_rewarm()
            self._maybe_heal()
            self._maybe_scrub()
            self._check_staleness_breach()
            self._check_fallback_heartbeat()

    def publish_now(self) -> None:
        """Synchronous drain + publish — the ``force=true`` escape hatch
        (snapshot stamping, wire-level forced refresh) and the pump's own
        drain step. Dispatches every staged change to the device and stamps
        the published snapshot with the staged watermark."""
        with self._mu:
            if self._closed or self._state is None:
                return
            had_work = (
                self._state.pending_count() > 0
                or self._staged_version > self._published_version
            )
            try:
                if self._pump_inject is not None:
                    self._pump_inject()  # chaos hook: die mid-drain
                self._state.flush_pending()
                if had_work or self._published_gen == 0:
                    # Eager root BEFORE the generation bump: pay the
                    # promotion-chain walk HERE (the pump already owns
                    # this cycle's device budget) so query threads serve
                    # the cached snapshot with ZERO device work.
                    root = self._state.root_hex(flush=False)
                    self._publish_locked()
                    self._pub_snapshot = (root, self._published_version)
            except BaseException as e:
                # A flush that failed part-way may have torn the in-place
                # levels, and a root walk that failed after a good flush
                # leaves content past the published stamp: either way the
                # state can no longer back the published snapshot.
                self._on_drain_failure(e)
                raise

    def _publish_locked(self) -> None:
        """Stamp the built tree as the served snapshot (lock held; the
        state's pending set MUST be empty — flush before publishing, or the
        stamp would claim coverage of undispatched changes)."""
        self._published_version = max(
            self._published_version, self._staged_version
        )
        self._published_gen += 1
        # Root recomputed lazily, cached per generation in _pub_snapshot.
        self._pub_snapshot = (None, self._published_version)
        self._staged_since_m = None
        self._last_publish_m = time.monotonic()

    def _check_staleness_breach(self) -> None:
        """Flight-recorder hook: one ``tree_staleness`` event per flag
        window when the published tree trails past the contract (deep
        version lag or a stale wall clock) — a wedged device queue then
        shows up on the blackbox timeline instead of only as a gauge.

        Deliberately LOCK-FREE: the exact failure this event exists for is
        a pump wedged inside a device dispatch while HOLDING ``_mu`` — a
        lock-taking check could never run then. It reads plain attributes
        (atomic in CPython; a torn read costs at most one spurious or
        missed flag, never a wrong serve), and it is invoked both by the
        pump loop and by the monitoring reads (``pump_lag_ms`` — polled
        every second by the flight sampler via the gauge), so a dead or
        stuck pump is still flagged."""
        if self._closed or self._state is None:
            return
        since = self._staged_since_m
        lag_ms = (
            0.0 if since is None
            else max(0.0, (time.monotonic() - since) * 1000.0)
        )
        try:
            lag_v = max(0, self._engine.version() - self._published_version)
        except Exception:
            return
        breached = lag_ms > self._window_s * 1000.0 or (
            self._max_lag_versions
            and lag_v > self._max_lag_versions
            and since is not None
        )
        now = time.monotonic()
        if (
            not breached
            or now - self._staleness_flagged_m < _STALENESS_FLAG_WINDOW_S
        ):
            return
        self._staleness_flagged_m = now
        from merklekv_tpu_torch.obs.flightrec import record

        record(
            "tree_staleness",
            lag_ms=int(lag_ms),
            lag_versions=int(lag_v),
            window_ms=int(self._window_s * 1000),
        )

    # -- fault containment (ladder / heal / scrub / heartbeat) ---------------
    def _on_drain_failure(self, e: BaseException) -> None:
        """A drain (flush + eager root) failed: invalidate the state NOW —
        its in-place levels may be torn (module docstring) — owe a re-warm
        from an engine snapshot, and count the failure by classified kind:

        - ``code`` (a bug in our own dispatch path, or an injected pump
          death): the rung isn't sick, the code is; the ladder does not
          count it.
        - ``environment`` (backend blip, hang): counts against the current
          rung; at ``degrade_after`` consecutive failures the ladder steps
          down and the re-warm builds at the lower rung. On the card the
          ladder ends at rung 1, so the re-warm builds on the card."""
        kind = (
            e.kind
            if isinstance(e, DeviceDispatchError)
            else classify_exception(e)
        )
        with self._mu:
            self.invalidate()
            if self._rewarm_at_m is None:
                self._rewarm_at_m = time.monotonic()
        ladder = self._ladder
        if kind != "code" and ladder is not None:
            ladder.note_failure(kind, "drain")
        get_metrics().inc("device.rewarms")
        try:
            from merklekv_tpu_torch.obs.flightrec import record

            record(
                "device_rewarm",
                kind=kind,
                rung=ladder.current() if ladder is not None else -1,
            )
        except Exception:
            pass
        self.start_warming()

    def _note_warm_failure(self, e: BaseException) -> None:
        """A warm build failed: count and record it, and when a re-warm is
        owed, schedule the pump's next attempt under ``DEVICE_HEAL``
        backoff."""
        kind = (
            e.kind
            if isinstance(e, DeviceDispatchError)
            else classify_exception(e)
        )
        get_metrics().inc("device.warm_errors")
        ladder = self._ladder
        try:
            from merklekv_tpu_torch.obs.flightrec import record

            record(
                "device_warm_failed",
                kind=kind,
                rung=ladder.current() if ladder is not None else -1,
            )
        except Exception:
            pass
        with self._mu:
            if self._rewarm_at_m is not None:
                self._rewarm_at_m = time.monotonic() + DEVICE_HEAL.backoff(
                    self._rewarm_fails
                )
                self._rewarm_fails += 1

    def _maybe_rewarm(self) -> None:
        """Start the owed re-warm once it is due (pump thread)."""
        due = self._rewarm_at_m
        if (
            due is None
            or self._closed
            or self._state is not None
            or self._warming.is_set()
            or time.monotonic() < due
        ):
            return
        self.start_warming()

    def _probe_rung(self, target: int) -> bool:
        """One heal probe: build a tiny tree at ``target`` on the mirror's
        device and check its root against the port's CPU golden tree — a
        rung that dispatches but answers WRONG is as sick as one that
        throws."""
        probe_items = [(b"mkv:heal-probe", b"ok")]
        try:
            from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState

            golden = CpuMerkleState.from_items(probe_items).root_hex()
            st = build_state_for_rung(target, probe_items, device=self._device,
                                      devices=self._shard_devices())
            return st.root_hex() == golden
        except Exception:
            return False

    def _maybe_heal(self) -> None:
        """Schedule the background re-warm probe: while degraded,
        periodically (under ``retry.DEVICE_HEAL`` escalating backoff)
        probe a higher rung — on the probe's OWN thread, never the
        pump's: a hang-shaped fault at the probed rung costs the probe
        thread a dispatch deadline, while the pump keeps draining the
        healthy serving rung inside the staleness contract."""
        ladder = self._ladder
        if ladder is None or self._closed:
            return
        # Invariant repair: a probe climb can land while a replace build
        # for a LOWER rung is still in flight — the swapped-in state then
        # trails the ladder. Rebuild at the ladder's rung.
        st = self._state
        if (
            st is not None
            and not self._replacing
            and int(getattr(st, "_n_shards", 1)) != ladder.current()
        ):
            self._start_replace_warm()
            return
        if not ladder.degraded() or not ladder.heal_due():
            return
        with self._mu:
            if self._probing or self._closed:
                return
            self._probing = True
        threading.Thread(
            target=self._heal_probe_pass, daemon=True,
            name="mkv-mirror-probe",
        ).start()

    def _heal_probe_pass(self) -> None:
        """One probe pass (probe thread): consecutive successful probes
        climb AS FAR AS THE PLANE ALLOWS (probes are tiny; full-size
        rebuilds are not), then ONE replace re-warm rebuilds the serving
        state at the final rung while the current state keeps serving."""
        ladder = self._ladder
        climbed = None
        try:
            while ladder.degraded() and not self._closed:
                if climbed is None and not ladder.heal_due():
                    return
                ok = self._probe_rung(ladder.probe_target())
                if ladder.note_probe(ok) is None:
                    break  # failed probe: next attempt after its backoff
                climbed = ladder.current()
        finally:
            with self._mu:
                self._probing = False
            if climbed is not None and not self._closed:
                if self._state is None:
                    self.start_warming()
                else:
                    self._start_replace_warm()

    def _maybe_scrub(self) -> None:
        """Schedule one scrub pass on its OWN thread, never the pump's —
        the same invariant as the heal probe: the scrub's level gather is
        a guarded dispatch, and a hang-shaped fault there would otherwise
        park the pump for the full dispatch deadline while staged writes
        blow through the staleness contract."""
        if self._scrub_interval_s <= 0 or self._closed:
            return
        now = time.monotonic()
        if now - self._last_scrub_m < self._scrub_interval_s:
            return
        with self._mu:
            if self._scrubbing or self._closed:
                return
            self._scrubbing = True
        self._last_scrub_m = now
        self._scrub_thread = threading.Thread(
            target=self._scrub_pass, daemon=True, name="mkv-mirror-scrub"
        )
        self._scrub_thread.start()

    def _scrub_pass(self) -> None:
        try:
            self.scrub_once()
        except Exception:
            pass  # a failed scrub read is a dispatch problem, not a leak
        finally:
            with self._mu:
                self._scrubbing = False

    def scrub_once(self) -> Optional[bool]:
        """Integrity scrub: cross-check a sampled leaf range of the SERVED
        device tree against CPU golden leaf hashes recomputed from the
        engine's current values. Runs only at a quiescent instant (nothing
        staged, engine version == published version, re-checked after the
        reads) so any mismatch proves SILENT DEVICE CORRUPTION — the tree
        content cannot have legitimately moved — and triggers
        invalidate + rebuild instead of serving a wrong root into
        anti-entropy. Returns True (clean), False (mismatch, repair
        kicked), or None (skipped: not quiescent / CPU rung / warming)."""
        from merklekv_tpu_torch.merkle.encoding import leaf_hash

        with self._mu:
            if self._closed or self._state is None:
                return None
            st = self._state
            if getattr(st, "_n_shards", 1) == 0:
                return None  # the CPU rung IS the golden tree
            if st.pending_count() > 0:
                return None
            try:
                v0 = self._engine.version()
            except Exception:
                return None
            if v0 != self._published_version:
                return None  # writes in flight; sample next time
            n = st.leaf_count()
            if n <= 0:
                return None
            k = min(self._scrub_keys, n)
            lo = self._scrub_rng.randrange(0, n - k + 1)
            gen0 = self._published_gen
        # Device gather + engine reads OUTSIDE the mirror lock: the
        # gather is a guarded dispatch — on a wedged backend it parks for
        # the full dispatch deadline, and holding ``_mu`` across that
        # would stall staging, applies, and every locked query path for
        # the duration. The fences below (not ``_mu``) make a mismatch
        # conclusive: keyspace movement bumps the engine version, tree
        # movement (a pump flush or a replace swap-in mid-gather) bumps
        # the publish generation or replaces the state object.
        try:
            out = st.level_nodes(0, lo, lo + k, flush=False)
            if out is None:
                return None
            rows, _ = out
            keys = list(st._keys[lo:lo + k])
        except Exception:
            return None  # raced a tree mutation; not conclusive
        # The gather may have parked for the full dispatch deadline —
        # close() could have run (and its join timed out) meanwhile, and
        # the engine pointer is only valid until then.
        with self._mu:
            if self._closed:
                return None
        vals = [self._engine.get(key) for key in keys]
        try:
            if self._engine.version() != v0:
                return None  # raced a write after all; not conclusive
        except Exception:
            return None
        with self._mu:
            if (
                self._closed
                or self._state is not st
                or self._published_gen != gen0
            ):
                return None  # tree moved under the gather; not conclusive
        get_metrics().inc("device.scrub_checks")
        bad = None
        for (idx, dig), key, val in zip(rows, keys, vals):
            if val is None or leaf_hash(key, val) != dig:
                bad = (idx, key)
                break
        if bad is None:
            return True
        # Mismatch: corruption. Count it against the rung (repeated
        # corruption is a sick device, not cosmic rays) and rebuild from
        # the engine — the engine is authoritative; the device tree is a
        # cache.
        get_metrics().inc("device.scrub_mismatches")
        try:
            from merklekv_tpu_torch.obs.flightrec import record

            record(
                "device_corruption",
                leaf_index=int(bad[0]),
                rung=self.backend_level(),
            )
        except Exception:
            pass
        if self._ladder is not None:
            self._ladder.note_failure("corruption", "scrub")
        self.invalidate()
        self.start_warming()
        return False

    def _check_fallback_heartbeat(self) -> None:
        """One ``device_fallback`` flight event per flag window while a
        previously ready mirror serves off the native fallback
        (post-invalidate, pre-re-warm) — without it, invalidate() silenced
        the staleness breach check (state None) and a node could sit on
        the fallback rung indefinitely with nothing in the timeline.
        Lock-free like the breach check, and invoked from both the pump
        loop and the monitoring reads (``pump_lag_ms``), so it fires even
        with the pump dead."""
        if self._closed or self._state is not None or not self._was_ready:
            return
        now = time.monotonic()
        if now - self._fallback_flagged_m < _FALLBACK_FLAG_WINDOW_S:
            return
        self._fallback_flagged_m = now
        ladder = self._ladder
        try:
            from merklekv_tpu_torch.obs.flightrec import record

            record(
                "device_fallback",
                rung=ladder.current() if ladder is not None else -1,
            )
        except Exception:
            pass

    def backend_level(self) -> int:
        """Serving-backend rung code — the ``device.backend_level`` gauge:
        N>=2 sharded width, 1 single-device, 0 CPU golden tree, -1 native
        fallback (warming / invalidated / closed). Lock-free: a monitoring
        read must never park behind a device dispatch."""
        st = self._state
        if self._closed or st is None:
            return -1
        return int(getattr(st, "_n_shards", 1))

    @property
    def ladder(self) -> Optional[DeviceBackendLadder]:
        return self._ladder

    # -- queries (published-snapshot serving) ---------------------------------
    def root_hex(self) -> str:
        """EXACT root: drains staged changes first (one publish), then
        serves. Direct-API callers (tests, snapshot verification) get
        read-your-writes; the wire query path uses ``published_root_hex``
        so it never waits on the device plane."""
        with self._mu:
            if self._closed:
                raise RuntimeError("mirror closed")
            if self._state is None:
                self._state = self._load_state()
                self._staged_version = max(
                    self._staged_version, self._engine.version()
                )
            self.publish_now()
            return self.published_root_hex()

    def published_root_hex(self) -> Optional[str]:
        """Root of the last-published snapshot (None while warming): the
        bounded-staleness serving path. Cached per publish generation —
        and served LOCK-FREE off the ``_pub_snapshot`` tuple when the
        eager publish filled it (the common case), so a HASH never waits
        behind a pump drain holding ``_mu`` across a device dispatch.
        The locked lazy path below only runs for publishes that skipped
        the eager walk (PENDING_LIMIT / truncate inline publishes)."""
        root, _ = self._pub_snapshot
        if root is not None and self._state is not None and not self._closed:
            return root
        with self._mu:
            if self._closed or self._state is None:
                return None
            root, _ = self._pub_snapshot
            if root is None:
                root = self._state.root_hex(flush=False)
                self._pub_snapshot = (root, self._published_version)
            return root

    def level_nodes(self, level: int, lo: int, hi: int):
        """TREELEVEL slice from the last-published device tree: reference-
        level ``(idx, digest)`` rows plus the leaf count, or None while the
        state is not built (the native host fallback answers instead).
        Serves the tree AS PUBLISHED — staged changes stay staged, so a
        walker's fetches within one generation are mutually consistent."""
        with self._mu:
            if self._closed or self._state is None:
                return None
            return self._state.level_nodes(level, lo, hi, flush=False)

    def leaf_count(self) -> int:
        """Leaf count of the built device tree, or -1 while warming. Reads
        the sorted key array only — no device work, safe on a gauge path
        (staged pending changes are not counted until their flush)."""
        with self._mu:
            if self._closed or self._state is None:
                return -1
            return self._state.leaf_count()

    def published_version(self) -> int:
        """Engine mutation version the served tree reflects (the version
        stamp on TREELEVEL/HASH answers). 0 while warming."""
        with self._mu:
            return self._published_version if self._state is not None else 0

    def published_root_stamped(self) -> Optional[tuple[str, int]]:
        """(root_hex, published_version) read atomically — the stamp can
        never claim a different generation than the root it rides with.
        Lock-free off ``_pub_snapshot`` (one immutable tuple) when the
        eager root is in place; the locked path covers lazy fills. None
        while warming."""
        snap = self._pub_snapshot
        if snap[0] is not None and self._state is not None and not self._closed:
            return snap
        with self._mu:
            root = self.published_root_hex()
            if root is None:
                return None
            return root, self._published_version

    def level_nodes_stamped(self, level: int, lo: int, hi: int):
        """``level_nodes`` plus the published version, atomically (one lock
        hold) — the stamped TREELEVEL serve. None while warming."""
        with self._mu:
            out = self.level_nodes(level, lo, hi)
            if out is None:
                return None
            rows, n = out
            return rows, n, self._published_version

    def staleness(self) -> int:
        """Engine mutation versions the PUBLISHED tree trails the live
        keyspace by (0 = fully caught up; -1 while warming). Exact against
        ``mkv_engine_version`` up to the conservative-watermark semantics
        in the module docstring. Only meaningful on version-tracking
        engines (the sharded/log natives)."""
        with self._mu:
            if self._closed or self._state is None:
                return -1  # also guards the engine FFI after close()
            return max(0, self._engine.version() - self._published_version)

    def pump_lag_ms(self) -> float:
        """Milliseconds the oldest staged-but-unpublished change has waited
        (0.0 when the pump is caught up) — the wall half of the staleness
        contract, and the ``device.pump_lag_ms`` gauge. Lock-free (plain
        attribute reads) so a pump wedged under ``_mu`` cannot block the
        monitoring plane; each read also runs the breach check, which is
        how a wedged/dead pump still lands a ``tree_staleness`` event via
        the flight sampler's 1 s gauge poll."""
        since = self._staged_since_m
        self._check_staleness_breach()
        self._check_fallback_heartbeat()
        if since is None or self._state is None:
            return 0.0
        return max(0.0, (time.monotonic() - since) * 1000.0)

    @property
    def state(self):
        return self._state

    # -- internals -----------------------------------------------------------
    def _shard_devices(self) -> list:
        from merklekv_tpu_torch.parallel.mesh import shard_devices

        return shard_devices(self._device, self._devices)

    def _resolve_shards(self) -> int:
        """[device] sharding -> top rung width (0 = single-device backend),
        resolved at the first build against the mirror's device list: on a
        one-device list ``auto`` is the single-device tree."""
        from merklekv_tpu_torch.parallel.sharded_state import resolve_shard_count

        return resolve_shard_count(self._sharding_mode, len(self._shard_devices()))

    def _ensure_ladder(self) -> DeviceBackendLadder:
        """The degradation ladder, built on first use (tests may inject a
        pre-built one). On the card it ends at rung 1."""
        if self._ladder is None:
            self._ladder = DeviceBackendLadder(
                self._resolve_shards(),
                degrade_after=self._degrade_after,
                cpu_rung=self._device.type == "cpu",
            )
        return self._ladder

    def _build_state(self, items):
        """State factory — the pluggable backend seam, riding the
        degradation ladder: build at the current rung; a rung whose
        guarded dispatch fails steps the ladder down IMMEDIATELY (a build
        failure means the rung cannot serve at all — counting to the
        drain threshold would just repeat the cliff) and the build retries
        one rung lower. A failure on the bottom rung raises: on a CPU
        mirror that is the infallible CPU golden rung (a failure there is
        a bug), on the card rung 1. A good build does not clear the
        ladder's count of drain failures: a re-warm exercises the build,
        not the scatter that failed."""
        items = list(items)
        ladder = self._ensure_ladder()
        while True:
            rung = ladder.current()
            try:
                return build_state_for_rung(rung, items, device=self._device,
                                            devices=self._shard_devices())
            except BaseException as e:
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                if ladder.at_bottom():
                    raise
                kind = (
                    e.kind
                    if isinstance(e, DeviceDispatchError)
                    else classify_exception(e)
                )
                ladder.note_failure(kind, "build", immediate=True)

    def _load_state(self):
        return self._build_state(self._engine.snapshot())

    def _empty_state(self):
        return self._build_state(())

    def shard_count(self) -> int:
        """Device shards serving the built tree (1 = single-device state;
        -1 while warming/closed) — the ``device.shards`` gauge."""
        with self._mu:
            st = self._state
            if self._closed or st is None:
                return -1
            return int(getattr(st, "_n_shards", 1))

    def shard_rebuild_us(self) -> int:
        """Dispatch cost of the last sharded subtree rebuild in
        microseconds (-1: single-device backend or none yet) — the
        ``device.shard_rebuild_us`` gauge. Lock-free like pump_lag_ms: a
        monitoring read must never park behind a device dispatch."""
        st = self._state
        if st is None:
            return -1
        return int(getattr(st, "last_shard_rebuild_us", -1))
