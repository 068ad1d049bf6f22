"""Metric-family catalog: the single source of ``# HELP`` / ``# TYPE``.

A copy of ``merklekv_tpu/obs/catalog.py``, its imports pointed at the port's modules.

The Prometheus exporter renders every family's metadata from here, so the
scrape page, this module, and the docs/OBSERVABILITY.md catalog cannot
drift apart silently — ``tests/test_obs.py`` asserts (a) every cataloged
name appears in OBSERVABILITY.md and (b) a live scrape carries HELP+TYPE
for every family it exposes.

Keys are REGISTRY names (dots, no ``mkv_`` prefix, no ``_total``/
``_seconds`` suffix — the exporter sanitizes). Families not listed fall
back to a generated one-liner pointing at the docs, so an uncataloged
counter still scrapes with metadata; curating it here is the follow-up,
not a prerequisite for adding a counter.

Gauges are intentionally absent: their help text lives at
``register_gauge`` time (the owning subsystem knows its own semantics),
and the exporter already emits it.
"""

from __future__ import annotations

__all__ = ["CATALOG", "help_for"]

# name -> (kind, help). kind is informational; the exporter's TYPE line
# derives from how the family is rendered (counter/histogram/gauge).
CATALOG: dict[str, tuple[str, str]] = {
    # -- anti-entropy ------------------------------------------------------
    "anti_entropy.syncs": (
        "counter", "Completed pairwise anti-entropy cycles."),
    "anti_entropy.multi_syncs": (
        "counter", "Completed multi-peer arbitration cycles."),
    "anti_entropy.keys_repaired": (
        "counter", "Keys set or deleted by anti-entropy repair."),
    "anti_entropy.peer_degraded": (
        "counter", "Sync streams that died mid-cycle (peer degraded)."),
    "anti_entropy.moved_peers": (
        "counter", "Sync cycles aborted because the peer answered MOVED "
        "(it serves a different partition — stale routing; the walk "
        "never mirrors a disjoint keyspace)."),
    "anti_entropy.sessions_checkpointed": (
        "counter", "Interrupted repairs checkpointed for resume."),
    "anti_entropy.sessions_resumed": (
        "counter", "Checkpointed repair sessions resumed."),
    "anti_entropy.sessions_abandoned": (
        "counter", "Stalled repair sessions abandoned (fresh diff next)."),
    "anti_entropy.interrupted_repairs": (
        "counter", "Repair streams interrupted by faults or deadlines."),
    "anti_entropy.loop_errors": (
        "counter", "Periodic-loop cycles that raised (retried next round)."),
    "anti_entropy.down_peer_skips": (
        "counter", "Cycles that skipped a confirmed-down peer."),
    "anti_entropy.cycle_reconnects": (
        "counter", "In-cycle reconnects after a dead stream."),
    "anti_entropy.probe_failures": (
        "counter", "HASH root probes that failed against a live peer."),
    "anti_entropy.verify_failures": (
        "counter", "Post-repair root verifications that mismatched."),
    "anti_entropy.leafhash_fallbacks": (
        "counter", "Cycles degraded to full transfer (no LEAFHASHES)."),
    "anti_entropy.leafhash_aborts": (
        "counter", "LEAFHASHES fetches aborted by transport death."),
    "anti_entropy.overload_skips": (
        "counter", "Anti-entropy cycles deferred while the node was above "
        "a resource watermark."),
    "anti_entropy.skew_clamped": (
        "counter", "Adopted peer timestamps clamped by the LWW clock-skew "
        "guard at the repair-install boundary."),
    "sync.bytes_sent": (
        "counter", "Anti-entropy wire bytes sent (client-measured)."),
    "sync.bytes_received": (
        "counter", "Anti-entropy wire bytes received (client-measured)."),
    "sync.nodes_compared": (
        "counter", "Merkle tree nodes compared during bisection walks."),
    "sync.rounds": (
        "counter", "Bisection-walk level rounds (TREELEVEL batches)."),
    "sync.walk_clips": (
        "counter", "Bisection walks clipped to their verified frontier "
        "after a stamped donor republished mid-walk (bounded trailing "
        "absorbed instead of abandoning the walk)."),
    "sync.forced_refreshes": (
        "counter", "Walk probes escalated to a forced donor tree refresh "
        "(donor-reported lag exceeded the staleness limit)."),
    # -- replication -------------------------------------------------------
    "replicator.published": (
        "counter", "Replication events published to the fabric."),
    "replicator.received": (
        "counter", "Replication events received from the fabric."),
    "replicator.coalesced": (
        "counter", "Events folded away by per-key frame coalescing."),
    "replicator.publish_errors": (
        "counter", "Frames dropped after publish retries (QoS-0)."),
    "replicator.decode_errors": (
        "counter", "Undecodable or unknown-version inbound frames."),
    "replicator.buffered": (
        "counter", "Events journaled-and-held while a bootstrap runs."),
    "replicator.buffer_replayed": (
        "counter", "Held events replayed at bootstrap gate-open."),
    "replicator.buffer_dropped": (
        "counter", "Held events dropped past the RAM cap (repaired later)."),
    "replicator.skew_clamped": (
        "counter", "Applied-event timestamps clamped by the LWW clock-skew "
        "guard (per-peer attribution rides as "
        "replicator.skew_clamped.<src>)."),
    "replicator.batch_size": (
        "histogram", "Events per published replication frame (size "
        "histogram: le bounds are event counts)."),
    "replication.convergence": (
        "histogram", "Write origin to applied-on-this-replica delay "
        "(seconds); max() across instances = write-to-all-replicas."),
    # -- health / transport ------------------------------------------------
    "health.peer_failures": (
        "counter", "Peers confirmed down by consecutive probe failures."),
    "health.peer_recoveries": (
        "counter", "Down peers that answered a probe again."),
    "health.peer_degradations": (
        "counter", "Mid-operation failures reported against peers."),
    "health.probe_errors": (
        "counter", "Probe rounds that raised internally."),
    # -- storage -----------------------------------------------------------
    "storage.wal_appends": ("counter", "WAL frames appended."),
    "storage.wal_fsyncs": ("counter", "WAL fsync calls."),
    "storage.snapshots": ("counter", "Snapshots written."),
    "storage.recovery_replayed": (
        "counter", "WAL records replayed during recovery."),
    "storage.recovery_root_mismatch": (
        "counter", "Snapshots rejected by root verification."),
    "storage.wal_fsync": ("histogram", "WAL fsync latency."),
    "storage.full_errors": (
        "counter", "WAL/snapshot writes failed with ENOSPC/EIO (node "
        "degrades read-only; drain threads survive)."),
    "storage.full_recoveries": (
        "counter", "Full-disk conditions cleared by the recovery probe "
        "(a re-anchor snapshot closes the journal gap)."),
    "storage.records_dropped": (
        "counter", "Records not journaled during a full-disk window "
        "(live in the engine; re-anchored on recovery)."),
    "storage.compactions_deferred": (
        "counter", "Snapshot compactions deferred under memory pressure "
        "(trigger stays pending)."),
    # -- device plane ------------------------------------------------------
    "device.scatter_keys": (
        "counter", "Keys updated via incremental device scatter."),
    "device.scatter_bytes": (
        "counter", "Bytes transferred by device scatter batches."),
    "device.restructure_keys": (
        "counter", "Keys in structural (insert/delete) device batches."),
    "device.restructure_bytes": (
        "counter", "Bytes transferred by structural device batches."),
    "device.scatter_dispatch": (
        "histogram", "Scatter-batch dispatch (async enqueue) latency."),
    "device.restructure_dispatch": (
        "histogram", "Structural-batch dispatch (async enqueue) latency."),
    "device.pump_batches": (
        "counter", "Device-update pump drain cycles published (staged "
        "events -> scatter dispatch -> served snapshot)."),
    "device.pump_errors": (
        "counter", "Pump drains that failed (state invalidated; queries "
        "fall back native and a re-warm respawns the pump)."),
    "device.pump_lag_versions": (
        "gauge", "Engine mutations staged but not yet published by the "
        "pump (the versions half of the [device] max_staleness contract; "
        "-1: no mirror)."),
    "device.pump_lag_ms": (
        "gauge", "Milliseconds the oldest staged-but-unpublished change "
        "has waited on the pump (0: caught up; -1: no mirror)."),
    "device.shards": (
        "gauge", "Device shards serving the Merkle tree's leaf level "
        "([device] sharding; 1: single-device tree; -1: no mirror or "
        "warming)."),
    "device.shard_rebuild_us": (
        "gauge", "Dispatch cost of the last sharded subtree rebuild in "
        "microseconds (async enqueue; -1: single-device backend or no "
        "rebuild yet)."),
    "device.shard_batches": (
        "counter", "Sharded-tree rebuild/restructure batches dispatched "
        "over the key mesh (per-shard subtree reduce + all_gather top "
        "tree)."),
    "device.shard_rebuild_dispatch": (
        "histogram", "Sharded subtree rebuild dispatch (async enqueue) "
        "latency over the key mesh."),
    "device.backend_level": (
        "gauge", "Degradation-ladder rung serving the Merkle tree (N>=2: "
        "sharded width; 1: single-device; 0: CPU golden tree; -1: native "
        "fallback / warming / no mirror)."),
    "device.guard_timeouts": (
        "counter", "Guarded device dispatches abandoned at the [device] "
        "dispatch_deadline_ms bound (the wedged worker is orphaned; the "
        "caller gets a typed hang error)."),
    "device.guard_retries": (
        "counter", "Guarded device dispatches retried once after an "
        "environment-classified failure (transient backend blip)."),
    "device.guard_errors": (
        "counter", "Guarded device dispatches that failed past the retry "
        "budget (typed DeviceDispatchError raised to the caller)."),
    "device.degraded_total": (
        "counter", "Degradation-ladder step-downs (device_degraded flight "
        "events carry the rung transition and classified kind)."),
    "device.healed_total": (
        "counter", "Degradation-ladder climbs after a successful re-warm "
        "probe (device_healed flight events)."),
    "device.heal_probes": (
        "counter", "Re-warm probe attempts against a higher ladder rung "
        "(escalating backoff while degraded)."),
    "device.scrub_checks": (
        "counter", "Integrity-scrub passes that reached a verdict (served "
        "device leaf range cross-checked against CPU golden hashes)."),
    "device.scrub_mismatches": (
        "counter", "Integrity-scrub corruption detections (served device "
        "tree diverged from the engine; invalidate+rebuild triggered)."),
    "profiler.captures": (
        "counter", "PROFILE verb device-profiler captures started."),
    # -- flight recorder ---------------------------------------------------
    "flight.spills": (
        "counter", "Flight-recorder spill files rewritten (atomic "
        "tmp+rename under [observability] flight_dir)."),
    "flight.spill_errors": (
        "counter", "Spill rewrites that failed (full/unwritable disk; the "
        "previous complete spill stays valid)."),
    "flight.sample_errors": (
        "counter", "Flight metric-sampler ticks that raised internally."),
    # -- bootstrap ---------------------------------------------------------
    "bootstrap.bytes_fetched": (
        "counter", "Raw snapshot bytes fetched by the joiner."),
    "bootstrap.chunks": ("counter", "SNAPCHUNK frames fetched."),
    "bootstrap.chunk_retries": (
        "counter", "Chunk offsets retried after integrity/transport "
        "failures."),
    "bootstrap.donor_failovers": (
        "counter", "Donors abandoned mid-transfer for the next candidate."),
    "bootstrap.verify_failures": (
        "counter", "Assembled snapshots that failed stamp verification."),
    "bootstrap.capability_misses": (
        "counter", "Donors that cannot serve snapshots (old/storage-less)."),
    "bootstrap.fallbacks": (
        "counter", "Bootstraps degraded to the plain anti-entropy walk."),
    "bootstrap.completed": ("counter", "Bootstrap runs that reached LIVE."),
    "bootstrap.donor_chunks": (
        "counter", "SNAPCHUNK frames served as a donor."),
    "bootstrap.donor_bytes": (
        "counter", "Raw snapshot bytes served as a donor."),
    # -- partitioned cluster mode ------------------------------------------
    "partition.degraded_total": (
        "counter", "Times this replica's partition left live (ladder rose "
        "above live while partitioned)."),
    "partition.healed_total": (
        "counter", "Times this replica's partition returned to live."),
    "router.commands": (
        "counter", "Commands dispatched by the thin partition router."),
    "router.map_refreshes": (
        "counter", "Partition-map refreshes performed by the router."),
    "router.moved_refreshes": (
        "counter", "Router commands that hit ERROR MOVED (stale map) and "
        "re-routed after a refresh."),
    "router.backend_errors": (
        "counter", "Router commands failed by an unreachable/failing "
        "backend replica."),
    # -- request plane (pipelined epoll router + read leases) ---------------
    "router.busy_retries": (
        "counter", "Router commands that hit ERROR BUSY upstream and "
        "retried after backoff (bounded by the PARTITION_MOVED budget)."),
    "router.upstream_dials": (
        "counter", "Pooled upstream connections dialed (first use or "
        "redial after a reset; replica failover rotates the order)."),
    "router.upstream_resets": (
        "counter", "Pooled upstream connections torn down (peer death, "
        "response timeout, desync) — every in-flight sub-request on the "
        "connection fails retryable."),
    "router.fanout_subrequests": (
        "counter", "Per-partition sub-requests dispatched by multi-key "
        "fan-out (MGET/MSET/EXISTS/SCAN/DBSIZE)."),
    "router.cache_hits": (
        "counter", "GETs answered from the router read cache."),
    "router.cache_misses": (
        "counter", "GETs that missed the read cache and took a fill "
        "lease upstream."),
    "router.cache_fills": (
        "counter", "Lease fills that stored a value in the read cache."),
    "router.cache_expired": (
        "counter", "Cache entries dropped at read time for lapsing the "
        "hard max-age staleness bound."),
    "router.cache_evictions": (
        "counter", "LRU evictions forced by the cache byte budget."),
    "router.cache_invalidations": (
        "counter", "Cache entries dropped by write-through, replication "
        "events, gap flushes, or epoch clears."),
    "router.lease_grants": ("counter", "Fill leases handed out (one per "
                            "missed key; herd followers wait instead)."),
    "router.lease_waits": (
        "counter", "GETs that queued behind an in-flight fill lease "
        "(the thundering herd the lease absorbed)."),
    "router.lease_timeouts": (
        "counter", "Leases stolen after the holder exceeded the fill "
        "timeout (presumed-dead filler)."),
    "router.lease_failures": (
        "counter", "Lease fills that completed with an upstream error "
        "(waiters got the error, nothing cached)."),
    "router.inval_frames": (
        "counter", "Replication envelopes consumed by the router's "
        "invalidation feed."),
    "router.inval_decode_errors": (
        "counter", "Replication envelopes the invalidation feed could "
        "not decode (dropped; max-age bound still holds)."),
    "router.inval_gap_flushes": (
        "counter", "Partition-wide cache flushes forced by a detected "
        "hseq gap (missed invalidation frames)."),
    "router.inval_lag": (
        "histogram", "Publish-to-apply latency of invalidation frames "
        "(publisher hts to router apply)."),
    "router.conns": (
        "gauge", "Client connections currently owned by the router's io "
        "workers."),
    "router.workers": ("gauge", "Router io worker pool width."),
    "router.inval_lag_ms": (
        "gauge", "Invalidation lag of the most recent frame, ms (-1 = "
        "no feed attached)."),
    "router.cache_bytes": (
        "gauge", "Router read-cache bytes used (entry-accounted)."),
    "router.cache_keys": ("gauge", "Router read-cache entries resident."),
    "router.leases_inflight": (
        "gauge", "Fill leases currently outstanding."),
    # -- overload protection ------------------------------------------------
    "node.degradation_changes": (
        "counter", "Degradation-ladder transitions (live/shedding/"
        "read_only/draining) pushed by the overload monitor."),
    "node.overload_monitor_errors": (
        "counter", "Overload-monitor poll ticks that raised internally."),
    # -- exporter-built families ------------------------------------------
    "span_duration": (
        "histogram", "Control-plane span latency (per span name)."),
    "native_cmd_latency": (
        "histogram", "Native server per-command dispatch latency."),
    # -- native STATS bridge (server scope, prefixed mkv_native_*) ---------
    "native.events_queue_depth": (
        "gauge", "Staged-but-undrained change events in the native event "
        "queue (the replication/WAL feed's backlog)."),
    "native.events_dropped": (
        "counter", "Change events dropped by the bounded native event "
        "queue at capacity (anti-entropy repairs the residue)."),
    "native.degradation": (
        "gauge", "Degradation ladder as enforced natively (0=live "
        "1=shedding 2=read_only 3=draining)."),
    "native.busy_rejected_connections": (
        "counter", "Accepts refused past [server] max_connections "
        "(answered ERROR BUSY and closed)."),
    "native.moved_commands": (
        "counter", "Key-bearing commands refused with ERROR MOVED because "
        "the key (or pt=-addressed tree) belongs to a partition this node "
        "does not own — stale client/router routing."),
    "native.partition_count": (
        "gauge", "Partitions in the cluster keyspace (absent/0 = "
        "unpartitioned node)."),
    "native.partition_id": (
        "gauge", "The ONE partition this node owns (partitioned mode)."),
    "native.partition_epoch": (
        "gauge", "Partition-map generation this node enforces; rides in "
        "every MOVED answer."),
    "native.pipeline_rejected": (
        "counter", "Connections closed for exceeding their in-flight "
        "pipeline budget."),
    "native.shed_commands": (
        "counter", "Write commands answered ERROR BUSY while shedding."),
    "native.readonly_commands": (
        "counter", "Write commands answered ERROR READONLY while "
        "read-only/draining."),
    # -- zero-copy serving plane (value slabs; [server] zero_copy) ---------
    "native.slab_bytes": (
        "gauge", "Live value-slab payload bytes, INCLUDING blocks pinned "
        "only by in-flight responses (the memory-watermark signal)."),
    "native.slab_blocks": (
        "gauge", "Live refcounted value blocks."),
    "native.slab_pinned_bytes": (
        "gauge", "Slab bytes not held by the live keyspace: in-flight "
        "responses (a slow reader's parked writev pins value memory here "
        "until it drains) plus values transiently mid-ingest — a "
        "SUSTAINED rise means slow readers, brief spikes are writes."),
    "native.slab_allocs": (
        "counter", "Lifetime value-block allocations (one per ingested "
        "value; zero-copy GETs allocate nothing)."),
    "native.slab_alloc_failures": (
        "counter", "Writes refused by the slab-arena byte limit "
        "(MKV_MAX_SLAB_BYTES) and shed with ERROR BUSY memory."),
    "native.serve_zero_copy": (
        "counter", "Values served as refcounted block iovec segments — "
        "zero copies after ingest."),
    "native.serve_value_copies": (
        "counter", "Values that size copied out of the engine instead "
        "(the zero_copy=false compat path; the bench A/B numerator)."),
    # -- native io plane (epoll worker pool; per-worker families are
    #    labeled {worker="i"}) ---------------------------------------------
    "native.io_threads": (
        "gauge", "Resolved epoll worker-pool width ([server] io_threads; "
        "0 config = hardware concurrency)."),
    "native.io_pipelined": (
        "gauge", "1 when responses coalesce into one writev per burst; 0 "
        "in the per-response-write compat mode (bench A/B baseline)."),
    "native.io_worker_connections": (
        "gauge", "Connections currently owned by each io worker."),
    "native.io_worker_commands": (
        "counter", "Commands dispatched by each io worker (with "
        "io_worker_wakeups: loop depth = commands/wakeups)."),
    "native.io_worker_wakeups": (
        "counter", "epoll wakeups (event-loop turns with events) per io "
        "worker."),
    "native.io_worker_writev_calls": (
        "counter", "Coalesced response flushes (writev syscalls) per io "
        "worker."),
    "native.io_worker_writev_bytes": (
        "counter", "Bytes flushed by each io worker's writev calls (with "
        "writev_calls: mean bytes per flush)."),
    "native.io_reuseport": (
        "gauge", "1 when SO_REUSEPORT accept sharding is live (every io "
        "worker owns its own listener); 0 on the single accept loop."),
    "native.io_worker_accepts": (
        "counter", "Connections each io worker accepted on its OWN "
        "reuseport listener (all zero when accept sharding is off)."),
}


def help_for(name: str, kind: str) -> str:
    """Catalog help for a registry family, or a generated fallback so no
    family ever scrapes without metadata."""
    entry = CATALOG.get(name)
    if entry is not None:
        return entry[1]
    return f"Uncataloged {kind} {name} (see docs/OBSERVABILITY.md)."
