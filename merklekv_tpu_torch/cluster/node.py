"""ClusterNode: wires replication + anti-entropy to a running native server.

A copy of ``merklekv_tpu/cluster/node.py``, its imports pointed at the
port's modules, except:

- the serving mirror is the port's ``DeviceTreeMirror`` on the node's device
  (``utils/deviceenv.py``: ``MERKLEKV_TORCH_DEVICE``, unset meaning CUDA).
  A node whose ``[anti_entropy] engine`` is not ``"cpu"`` resolves that
  device when it is built, so without a GPU (and without
  ``MERKLEKV_TORCH_DEVICE=cpu``) it fails at start;
- a failure of the mirror while it serves ``HASH``/``TREELEVEL`` is counted
  in ``device.fallbacks`` and answered as an error, never from the native
  host tree. The host tree still answers while the mirror warms (the
  reference's contract);
- ``PROFILE <secs>`` captures a ``torch.profiler`` trace (CUDA activity on
  the card) into the same directory scheme;
- ``[device] sharding = auto|N`` (and the ``sharded_mirror`` alias) shards
  the mirror's tree over the host's cards (``parallel/sharded_state.py``);
  on a one-card host ``auto`` serves from one device;
- a durable node's store (``storage/``) hashes its snapshot roots on the
  node's device; the mirror stays on this process's own devices when the
  process has joined a multi-process group (``parallel/multihost.py``), as
  in the JAX node;
- partitioned mode's live rebalancing (``cluster/rebalance.py``) hashes the
  moving range's root and verifies the joiner's snapshot on the node's
  device, and a bootstrapping node (``cluster/bootstrap.py``) verifies its
  donor's snapshot there, both by the node's ``[storage] merkle_engine``
  (the reference pins the range root to the host).

Owns the SYNC / REPLICATE cluster-command callback (the native server
delegates those verbs here), the Replicator lifecycle (REPLICATE
enable/disable/status, reference server.rs:686-720), and the periodic
anti-entropy loop.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

from merklekv_tpu_torch.cluster.overload import (
    DRAINING,
    LEVEL_NAMES,
    REASON_CODES,
    SHEDDING,
    DegradationLadder,
    OverloadMonitor,
)
from merklekv_tpu_torch.cluster.replicator import Replicator
from merklekv_tpu_torch.cluster.sync import SyncManager
from merklekv_tpu_torch.cluster.transport import Transport, make_transport
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.native_bindings import NativeEngine, NativeServer
from merklekv_tpu_torch.obs import tracewire
from merklekv_tpu_torch.obs.lag import ConvergenceTracker
from merklekv_tpu_torch.utils import deviceenv

__all__ = ["ClusterNode"]


class ClusterNode:
    def __init__(
        self,
        cfg: Config,
        engine: NativeEngine,
        server: NativeServer,
        transport: Optional[Transport] = None,
        storage=None,  # Optional[DurableStore], already recovered
    ) -> None:
        # The device of the mirror and of anti-entropy's device route, by
        # name (a CPU node never imports torch here). A CUDA device is
        # resolved now, so a node without a GPU fails at start instead of
        # at its first HASH or sync cycle.
        self._device: Optional[str] = None
        if cfg.anti_entropy.engine != "cpu":
            self._device = deviceenv.device_name()
            if self._device != "cpu":
                deviceenv.resolve()
        self._cfg = cfg
        self._engine = engine
        self._server = server
        self._storage = storage
        self._transport = transport
        self._owns_transport = transport is None
        self._replicator: Optional[Replicator] = None
        self._mirror = None  # DeviceTreeMirror, alive while replication is on
        self._health = None  # PeerHealthMonitor, alive with the sync loop
        self._rep_mu = threading.Lock()
        self._exporter = None  # MetricsExporter, alive while the node runs
        self._gauge_names: list = []  # (name, fn) pairs we registered
        self._bootstrap = None  # BootstrapSession while a (re)join runs
        self._bootstrap_thread: Optional[threading.Thread] = None
        self._stopped = False  # guards late starts from the bootstrap thread
        # Convergence-lag SLO plane: per-peer lag from envelope publish
        # HWMs, residue cleared when an anti-entropy cycle converges, and
        # the /healthz readiness level (live|lagging|diverged).
        self.lag_tracker = ConvergenceTracker(
            lag_ms_threshold=cfg.observability.lag_ms_threshold,
            diverged_after_s=cfg.observability.diverged_after_s,
        )
        # One PROFILE capture at a time; directory returned on start.
        self._profile_mu = threading.Lock()
        self._profiling = False
        # Flight recorder (post-mortem black box): sampler + durable spill
        # started in start() per [observability] flight settings.
        self._flight_sampler = None
        self._flight_spiller = None
        # Overload-protection plane: the node-wide degradation ladder
        # (live -> shedding -> read_only -> draining), fed by the memory /
        # disk watermark monitor and enforced by the native server.
        self.ladder = DegradationLadder()
        self._overload: Optional[OverloadMonitor] = None
        # Partitioned cluster mode: this node owns ONE partition of a
        # P-way keyspace. The map (validated here, served via PARTMAP) is
        # the routing table; the native guard refuses foreign keys with
        # ERROR MOVED; replication rides a partition-local topic; and the
        # anti-entropy peer set defaults to the partition's sibling
        # replicas — so failures, overload, repair, and bootstrap all stay
        # partition-local by construction (the node's whole-keyspace root
        # IS the per-partition Merkle root).
        self._partmap = None
        self._partition_id: Optional[int] = None
        # Live-rebalance plane: the per-node session state machine (donor /
        # joiner / sibling roles), built lazily on the first REBALANCE verb.
        self._rebalance = None
        self._rebalance_mu = threading.Lock()
        if cfg.cluster.partitions > 0:
            from merklekv_tpu_torch.cluster.partmap import parse_map_spec

            if not 0 <= cfg.cluster.partition_id < cfg.cluster.partitions:
                # Config.from_dict validates TOML-loaded configs; a
                # programmatically built Config bypasses it, and the
                # default partition_id of -1 would silently derive peers
                # from replicas[-1] (the LAST partition) while the native
                # guard clamps to 0 — a loud startup error beats a node
                # enforcing one partition while syncing against another.
                raise ValueError(
                    "[cluster] partition_id must be in "
                    f"[0, {cfg.cluster.partitions}), got "
                    f"{cfg.cluster.partition_id}"
                )
            self._partmap = parse_map_spec(
                cfg.cluster.partition_map,
                cfg.cluster.partitions,
                cfg.cluster.map_epoch,
            )
            self._partition_id = cfg.cluster.partition_id
        if storage is not None:
            # Durable map-file overlay: a node that committed a split
            # persists epoch E+1 (and its possibly-new partition id) under
            # its storage directory at the rebalance commit point. Boot
            # config is typically still at E, so the file — strictly newer
            # — wins; this is what makes the epoch flip survive kill -9.
            # It also resurrects a committed JOINER (whose boot config has
            # partitions == 0) straight into its adopted partition.
            from merklekv_tpu_torch.cluster.partmap import load_map_file

            loaded = load_map_file(storage.directory)
            if loaded is not None:
                pmap, pid = loaded
                if self._partmap is None or pmap.epoch > self._partmap.epoch:
                    self._partmap = pmap
                    self._partition_id = pid
                    cfg.anti_entropy.peers = []  # re-derive from the map
        if self._partmap is not None:
            if not cfg.anti_entropy.peers and cfg.port:
                # Sibling derivation: the partition's other replicas are
                # exactly the peers anti-entropy (and bootstrap donors)
                # should talk to — cross-partition walks would compare
                # DISJOINT keyspaces and mirror everything as divergence.
                # An explicit [anti_entropy] peers list still wins; nodes
                # on an ephemeral port (tests) cannot self-identify and
                # keep their explicit list.
                def is_self(a: str) -> bool:
                    # Exact-match plus the wildcard-bind case: a node
                    # bound 0.0.0.0/:: cannot know which map spelling is
                    # its own, so same-port entries are treated as self —
                    # a node must never dial itself as a peer. Exotic
                    # host spellings (localhost vs 127.0.0.1) should set
                    # [anti_entropy] peers explicitly.
                    host, _, port = a.rpartition(":")
                    if port != str(cfg.port):
                        return False
                    return host == cfg.host or cfg.host in (
                        "0.0.0.0", "::", ""
                    )

                cfg.anti_entropy.peers = [
                    a
                    for a in self._partmap.replicas[self._partition_id]
                    if not is_self(a)
                ]
        self.sync_manager = SyncManager(
            engine,
            device=cfg.anti_entropy.engine,
            repair_listener=self._on_sync_repair,
            on_peer_degraded=self._on_peer_degraded,
            mode=cfg.anti_entropy.mode,
            bisect_threshold=cfg.anti_entropy.bisect_threshold,
            on_cycle_converged=self.lag_tracker.on_converged,
            max_skew_ms=cfg.replication.max_skew_ms,
            tree_lag_limit=cfg.device.max_staleness_versions,
            partition_id=self._partition_id,
            torch_device=self._device,
        )

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._server.set_cluster_handler(self._on_cluster_command)
        # Partition guard BEFORE anything serves: from the first accepted
        # command, a foreign key answers ERROR MOVED instead of landing in
        # (and polluting) this partition's keyspace.
        if self._partmap is not None:
            self._install_partition_guard()
            # Boot foreign-key sweep: a donor (or sibling) killed after
            # the epoch persisted but before its moved-range drop ran
            # restarts owning the NARROWED cell while the engine still
            # holds the moved keys. Quiet-drop them behind the guard —
            # the joiner owns them now, and serving them here would be
            # double-ownership.
            self._boot_foreign_sweep()
        # Overload protection BEFORE anything serves: admission limits go
        # to the native accept path, and the watermark monitor starts
        # pushing the degradation ladder (its first poll runs inline, so
        # a node restarted over a full disk comes up read-only, not live).
        self._server.set_limits(
            self._cfg.server.max_connections, self._cfg.server.max_pipeline
        )
        self._overload = OverloadMonitor(
            self.ladder,
            self._engine,
            self._server,
            self._cfg.server,
            storage=self._storage,
            partition_id=self._partition_id,
        ).start()
        if self._storage is not None:
            self._storage.set_defer_compaction(self._overload.memory_pressure)
        self._register_gauges()
        from merklekv_tpu_torch.obs.trace import get_trace_buffer

        get_trace_buffer().set_capacity(self._cfg.observability.trace_cycles)
        tracewire.set_propagation(self._cfg.observability.trace_propagation)
        tracewire.get_collector().set_capacity(
            self._cfg.observability.trace_spans
        )
        self._start_flight_recorder()
        if self._cfg.observability.http_port != 0:
            # Per-node Prometheus endpoint (/metrics + /healthz): registry
            # counters/histograms/gauges and the native STATS block in one
            # namespace. -1 binds an ephemeral port (tests read
            # metrics_port); failure to bind is reported, never fatal —
            # the data plane must not die for observability.
            from merklekv_tpu_torch.obs.exporter import MetricsExporter

            port = self._cfg.observability.http_port
            try:
                self._exporter = MetricsExporter(
                    max(0, port),
                    host=self._cfg.observability.http_host,
                    stats_fn=self._server.stats_text,
                    health_fn=self._health_payload,
                ).start()
            except OSError as e:
                print(f"metrics exporter not started: {e}", file=sys.stderr,
                      flush=True)
        if self._storage is not None:
            # WAL recording: the store drains the native change-event queue
            # itself until a Replicator takes over the drain (then the
            # store rides its batch listener — one queue, one consumer).
            self._storage.attach_server(self._server)
        if self._cfg.replication.enabled:
            err = self._enable_replication()
            if err is not None:
                print(f"replication not started: {err}", file=sys.stderr,
                      flush=True)
        if self._cfg.anti_entropy.enabled and self._cfg.anti_entropy.peers:
            # Failure detection: probe peers off the sync path so the loop
            # can skip confirmed-down peers instead of burning a connect
            # timeout per cycle (reference has no peer health, SURVEY §5.3).
            from merklekv_tpu_torch.cluster.health import PeerHealthMonitor

            self._health = PeerHealthMonitor(
                self._cfg.anti_entropy.peers,
                interval_seconds=min(
                    self._cfg.anti_entropy.interval_seconds, 2.0
                ),
            )
            self._health.start()
        # Bootstrap BEFORE the periodic sync loop: a node joining empty
        # (or recovering through interior WAL corruption) ships a peer's
        # verified snapshot instead of walking the whole keyspace, serving
        # zero reads until the stamped root verifies. The loop is deferred
        # until the session FINISHES — a transfer outliving the sync
        # interval must not race full walk-from-empty cycles (the exact
        # O(n) wire cost this subsystem exists to avoid); the bootstrap
        # thread starts the loop on its way out.
        bootstrapping = False
        if self._cfg.bootstrap.enabled and self._cfg.anti_entropy.peers:
            reason = self._bootstrap_reason()
            if reason is not None:
                bootstrapping = True
                self._start_bootstrap(reason)
        if not bootstrapping:
            self._start_sync_loop()

    def _flight_dir(self) -> Optional[str]:
        """Where the durable spill lives: explicit [observability]
        flight_dir wins; "" resolves to <node data dir>/flight on durable
        nodes and to None (spill off; ring + FLIGHT verb still live) on
        storage-less ones — an embedded test node must not litter."""
        d = self._cfg.observability.flight_dir
        if d:
            return d
        if self._storage is not None:
            return os.path.join(self._storage.directory, "flight")
        return None

    def _start_flight_recorder(self) -> None:
        """Arm the black box: size the ring, push the native slow-command
        threshold, start the metric sampler, and — when a spill directory
        resolves — the periodic spill writer plus the fatal-dump handlers
        (faulthandler first, then the native crash marker so the marker
        chains INTO faulthandler's traceback dump)."""
        obs = self._cfg.observability
        if not obs.flight_enabled:
            # Disarm explicitly: an embedded server reused from a previous
            # node (or configured by one) may still hold its threshold.
            self._server.set_slow_threshold(0)
            return
        from merklekv_tpu_torch.obs import flightrec

        rec = flightrec.get_recorder()
        rec.set_capacity(obs.flight_events)
        self._server.set_slow_threshold(obs.slow_command_us)
        if self._partition_id is not None:
            # The partition id on node_start is what lets blackbox group
            # several nodes' spills by partition and tell a partition-
            # local incident (one group flips) from a cluster-wide one.
            rec.record(
                "node_start",
                port=self._server.port,
                partition=self._partition_id,
            )
            rec.record(
                "map_change",
                epoch=self._partmap.epoch,
                partitions=self._partmap.count,
                partition=self._partition_id,
            )
        else:
            rec.record("node_start", port=self._server.port)
        self._flight_sampler = flightrec.MetricSampler(
            interval_s=obs.flight_sample_s,
            stats_fn=self._server.stats_text,
        ).start()
        flight_dir = self._flight_dir()
        if flight_dir is not None:
            self._flight_spiller = flightrec.FlightSpiller(
                flight_dir,
                sampler=self._flight_sampler,
                interval_s=obs.flight_spill_s,
                node=f"{self._cfg.host}:{self._server.port}",
            )
            try:
                self._flight_spiller.start()
            except OSError as e:
                # An unwritable flight dir must not kill the data plane;
                # the in-memory ring and FLIGHT verb still serve.
                self._flight_spiller = None
                print(f"flight spill not started: {e}", file=sys.stderr,
                      flush=True)
            if self._flight_spiller is not None:
                flightrec.install_fault_handlers(flight_dir)
                from merklekv_tpu_torch.native_bindings import install_crash_marker

                install_crash_marker(
                    os.path.join(flight_dir, "fatal.txt")
                )

    def _start_sync_loop(self) -> None:
        if (
            self._cfg.anti_entropy.enabled
            and self._cfg.anti_entropy.peers
            and not self._stopped
        ):
            self.sync_manager.start_loop(
                self._cfg.anti_entropy.peers,
                self._cfg.anti_entropy.interval_seconds,
                multi_peer=self._cfg.anti_entropy.multi_peer,
                peer_up=self._health.is_up if self._health else None,
                pause_when=(
                    self._overload.should_pause_background
                    if self._overload is not None
                    else None
                ),
            )

    def stop(self) -> None:
        self._stopped = True
        # Draining is the ladder's top rung: new connections are refused
        # BUSY and writes answer READONLY while the teardown (final WAL
        # drain, shutdown snapshot) runs. The monitor stops first so it
        # cannot race the rung back down.
        if self._overload is not None:
            self._overload.stop()
        self._server.set_degradation(DRAINING, REASON_CODES["draining"])
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None
        self._unregister_gauges()
        if self._bootstrap is not None:
            self._bootstrap.stop()
        if self._bootstrap_thread is not None:
            self._bootstrap_thread.join(timeout=10)
            self._bootstrap_thread = None
        self.sync_manager.stop()
        if self._health is not None:
            self._health.stop()
            self._health = None
        with self._rebalance_mu:
            rebalance = self._rebalance
        if rebalance is not None:
            rebalance.stop()
        self._disable_replication()
        if self._owns_transport and self._transport is not None:
            self._transport.close()
            self._transport = None
        self._server.set_cluster_handler(None)
        # Back to live: embedded/test shapes reuse the native server after
        # a node stops (the process-level path closes it right after, so
        # the draining window there lasts until server.close()).
        self._server.set_degradation(0, 0)
        if self._partmap is not None:
            # Same successor-node rule as the slow threshold below: an
            # embedded server reused by an unpartitioned node must not
            # keep refusing foreign keys with a dead node's map.
            self._server.set_partition(0, 0, 0)
        # Disarm the slow-command log with the rest of the per-node server
        # state: a successor node attached to the same embedded server
        # must not inherit this node's threshold.
        self._server.set_slow_threshold(0)
        # Flight recorder LAST: node_stop is the clean-shutdown marker —
        # FAULT_MODEL.md's contract is that its PRESENCE in the spill's
        # tail proves the stop completed, so it must be recorded (and the
        # final spill written) after the whole teardown above, not before
        # it. A death mid-teardown then still reads as unclean.
        if self._flight_sampler is not None or self._flight_spiller is not None:
            from merklekv_tpu_torch.obs import flightrec

            flightrec.record("node_stop")
        if self._flight_sampler is not None:
            self._flight_sampler.stop()
        if self._flight_spiller is not None:
            self._flight_spiller.stop(final=True)
            self._flight_spiller = None
        self._flight_sampler = None

    @property
    def replicator(self) -> Optional[Replicator]:
        return self._replicator

    # -- live rebalancing -----------------------------------------------------
    def _rebalance_manager(self):
        with self._rebalance_mu:
            if self._rebalance is None:
                from merklekv_tpu_torch.cluster.rebalance import RebalanceManager

                self._rebalance = RebalanceManager(self)
            return self._rebalance

    def _rebalance_state_code(self) -> int:
        with self._rebalance_mu:
            rebalance = self._rebalance
        return rebalance.state_code() if rebalance is not None else 0

    def _install_partition_guard(self) -> None:
        """Push the current map into the native guard. Unsplit maps take
        the legacy modulo path (byte-identical to pre-rebalance behavior);
        split maps install the full cell table so foreign keys answer
        ``ERROR MOVED <owner> <epoch>`` with split-tree routing."""
        pmap, pid = self._partmap, self._partition_id
        if pmap is None or pid is None:
            return
        if pmap.is_split:
            self._server.set_partition_map(
                pmap.epoch,
                pmap.hash_base,
                pid,
                [pmap.assignment(p) for p in range(pmap.count)],
            )
        else:
            self._server.set_partition(pmap.epoch, pmap.count, pid)

    def adopt_partition_map(self, pmap, pid: Optional[int] = None) -> None:
        """Commit a new partition-map epoch on this node: persist it
        (THE durability point — a kill one instruction later restarts at
        the new epoch), then swap the in-memory map and the native guard.
        ``pid`` defaults to the current identity (donor/sibling); the
        joiner passes its newly-owned partition."""
        from merklekv_tpu_torch.cluster.partmap import save_map_file

        if pid is None:
            pid = self._partition_id
        if self._storage is not None:
            save_map_file(self._storage.directory, pmap, pid)
        self._partmap = pmap
        self._partition_id = pid
        self._install_partition_guard()
        from merklekv_tpu_torch.obs.flightrec import record

        record(
            "map_change",
            epoch=pmap.epoch,
            partitions=pmap.count,
            partition=pid,
        )

    def _boot_foreign_sweep(self) -> None:
        """Quiet-drop every key outside this node's owned cell. Only a
        split map can leave residue (a crash between the epoch persist and
        the moved-range drop); boot-shaped maps skip the scan entirely."""
        pmap, pid = self._partmap, self._partition_id
        if pmap is None or pid is None or not pmap.is_split:
            return
        from merklekv_tpu_torch.cluster.partmap import key_in_range

        base = pmap.hash_base
        root, depth, path = pmap.assignment(pid)
        dropped = 0
        for k, _ in self._engine.snapshot():
            if not key_in_range(k, base, root, depth, path):
                if self._engine.delete_quiet(k):
                    dropped += 1
        if dropped:
            if self._storage is not None:
                self._storage.request_snapshot()
            from merklekv_tpu_torch.obs.flightrec import record
            from merklekv_tpu_torch.utils.tracing import get_metrics

            get_metrics().inc("rebalance.boot_swept_keys", dropped)
            record("rebalance_boot_sweep", keys=dropped, partition=pid)

    # -- replication management ---------------------------------------------
    def _get_transport(self) -> Transport:
        if self._transport is None:
            rep = self._cfg.replication
            self._transport = make_transport(
                rep.mqtt_broker,
                rep.mqtt_port,
                kind=rep.transport,
                client_id=rep.client_id,
                username=rep.username,
                password=rep.password,
            )
        return self._transport

    def _enable_replication(self) -> Optional[str]:
        with self._rep_mu:
            if self._replicator is not None:
                return None  # already enabled
            try:
                transport = self._get_transport()
            except OSError as e:
                return f"broker unreachable: {e}"
            # The mirror is only trustworthy while the event queue feeds it,
            # i.e. while replication is enabled — so its lifecycle is tied
            # to the replicator's. "cpu" pins anti-entropy (and HASH) to the
            # host path; anything else serves HASH from the device tree.
            if self._cfg.anti_entropy.engine != "cpu":
                from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror

                self._mirror = DeviceTreeMirror(
                    self._engine,
                    sharded=self._cfg.device.sharded_mirror,
                    sharding=self._cfg.device.sharding,
                    max_staleness_ms=self._cfg.device.max_staleness_ms,
                    max_staleness_versions=(
                        self._cfg.device.max_staleness_versions
                    ),
                    dispatch_deadline_ms=(
                        self._cfg.device.dispatch_deadline_ms
                    ),
                    scrub_interval_s=self._cfg.device.scrub_interval_s,
                    scrub_keys=self._cfg.device.scrub_keys,
                    degrade_after=self._cfg.device.degrade_after_failures,
                    device=self._device,
                )
            storage = self._storage
            if storage is not None:
                # Hand the event-queue drain to the replicator; local
                # writes reach the WAL through its batch listener, remote
                # applies through the storage hook inside the replicator.
                storage.pause_drain()
            # Partition-local replication fabric: each partition's replica
            # group publishes/subscribes on its OWN topic, so one
            # partition's write storm (or poisoned stream) can never fan
            # out into a sibling partition's appliers — the frame-level
            # blast radius is one partition. The node id carries a p<pid>
            # prefix so per-peer attribution (replication.lag_events.<src>,
            # skew clamps, blackbox joins) names the partition too.
            topic_prefix = self._cfg.replication.topic_prefix
            node_id = self._cfg.replication.client_id
            if self._partition_id is not None:
                topic_prefix = f"{topic_prefix}/p{self._partition_id}"
                node_id = node_id or (
                    f"p{self._partition_id}-"
                    f"{self._cfg.host}:{self._server.port}"
                )
            try:
                self._replicator = Replicator(
                    self._engine,
                    self._server,
                    transport,
                    topic_prefix=topic_prefix,
                    node_id=node_id,
                    mirror=self._mirror,
                    batch_listener=(
                        storage.record_events if storage is not None else None
                    ),
                    storage=storage,
                    batch_max_events=self._cfg.replication.batch_max_events,
                    batch_max_bytes=self._cfg.replication.batch_max_bytes,
                    lag_tracker=self.lag_tracker,
                    max_skew_ms=self._cfg.replication.max_skew_ms,
                )
                self._replicator.start()
            except Exception as e:
                # Take the drain back: a half-failed enable must not leave
                # WAL recording paused with no batch listener feeding it.
                self._replicator = None
                if storage is not None:
                    self._server.enable_events(True)
                    storage.resume_drain()
                return f"replicator start failed: {e}"
            return None

    def _disable_replication(self) -> None:
        with self._rep_mu:
            if self._replicator is not None:
                self._replicator.stop()
                self._replicator = None
                if self._storage is not None:
                    # Replicator.stop() turned event staging off; the WAL
                    # still needs it — take the drain back.
                    self._server.enable_events(True)
                    self._storage.resume_drain()
            if self._mirror is not None:
                # Before any teardown of the native engine: the mirror's
                # warm thread reads through the engine's raw pointer.
                self._mirror.close()
                self._mirror = None

    # -- bootstrap (joiner side) ----------------------------------------------
    @property
    def bootstrap(self):
        """The BootstrapSession of the current/most recent (re)join, or
        None when this node never bootstrapped (tests, top, healthz)."""
        return self._bootstrap

    def _bootstrap_reason(self) -> Optional[str]:
        """Why this node should bootstrap, or None to start normally.

        An empty keyspace is the classic new/long-dead joiner. A recovery
        that hit interior WAL corruption (or rejected every snapshot)
        restored only a verified PREFIX — the re-anchor snapshot closes
        the durability hole, and bootstrapping from a healthy peer closes
        the data hole without waiting out a worst-case walk."""
        try:
            if self._engine.dbsize() == 0:
                return "empty-keyspace"
        except Exception:
            return None
        st = self._storage
        if st is not None and st.last_recovery is not None:
            rec = st.last_recovery
            if rec.corruption:
                return "wal-corruption"
            if rec.snapshots_rejected and rec.snapshot_path is None:
                return "snapshots-rejected"
        return None

    def _start_bootstrap(self, reason: str) -> None:
        from merklekv_tpu_torch.cluster.bootstrap import BootstrapSession

        # Close the read gate first: no client read — and no peer's
        # anti-entropy walk — sees unverified state from here on.
        self._server.set_serving(False)
        with self._rep_mu:
            rep = self._replicator
        if rep is not None:
            # Live replication frames journal but defer apply until the
            # verified snapshot is installed (no gap in the write stream).
            rep.hold_applies()

        def on_serving() -> None:
            self._server.set_serving(True)
            with self._rep_mu:
                r = self._replicator
            if r is not None:
                r.release_applies()

        self._bootstrap = BootstrapSession(
            self._engine,
            self.sync_manager,
            self._cfg.anti_entropy.peers,
            self._cfg.bootstrap,
            merkle_engine=self._cfg.storage.merkle_engine,
            health=self._health,
            batch_listener=self._on_bootstrap_applied,
            on_serving=on_serving,
        )
        sess = self._bootstrap

        def run() -> None:
            try:
                sess.run(reason)
            finally:
                # The periodic loop was deferred for the transfer's
                # duration; hand over to it now (no-op if disabled or the
                # node stopped meanwhile).
                self._start_sync_loop()

        self._bootstrap_thread = threading.Thread(
            target=run, daemon=True, name="mkv-bootstrap"
        )
        self._bootstrap_thread.start()

    def _on_bootstrap_applied(self, applied) -> None:
        """Verified snapshot slab installed into the engine: feed the
        device mirror and the WAL, exactly like anti-entropy repairs —
        bootstrap applies bypass the server's event queue."""
        with self._rep_mu:
            mirror = self._mirror
        if mirror is not None:
            mirror.apply_batch([(k, v) for k, v, _ in applied])
        if self._storage is not None:
            self._storage.record_applied(applied)

    def _snap_meta_wire(self) -> str:
        storage = self._storage
        if storage is None:
            return "ERROR snapshot shipping requires durable storage\r\n"
        meta = storage.donor_meta()
        if meta == storage.BUILDING:
            # Transient, not a capability miss: the artifact is being
            # written in the background — the joiner polls ("retry" is the
            # signal its discover phase waits on).
            return "ERROR snapshot not ready (building); retry\r\n"
        if meta is None:
            return "ERROR no snapshot available\r\n"
        seq, wal_seq, size, root_hex = meta
        return f"SNAPMETA {seq} {wal_seq} {size} {root_hex}\r\n"

    def _snap_chunk_wire(self, seq: int, offset: int, count: int) -> str:
        import base64
        import zlib

        storage = self._storage
        if storage is None:
            return "ERROR snapshot shipping requires durable storage\r\n"
        try:
            raw = storage.read_snapshot_range(seq, offset, count)
        except OSError:
            # Artifact gone (donor restarted past the pin TTL): the joiner
            # re-discovers rather than assembling a short file.
            return f"ERROR snapshot {seq} gone\r\n"
        if not raw:
            # Past EOF: a bare zero-length frame (the client rejects a
            # zero-length header that still carries payload bytes).
            return f"CHUNK {offset} 0 0\r\n\r\n"
        # CRC over the RAW bytes; payload zlib+base64 so the CRLF text
        # protocol carries arbitrary binary, and key/value-shaped snapshot
        # bodies compress well (measured: ~5-10x on text keyspaces).
        payload = base64.b64encode(zlib.compress(raw, 1)).decode("ascii")
        from merklekv_tpu_torch.utils.tracing import get_metrics

        m = get_metrics()
        m.inc("bootstrap.donor_chunks")
        m.inc("bootstrap.donor_bytes", len(raw))
        return f"CHUNK {offset} {len(raw)} {zlib.crc32(raw)}\r\n{payload}\r\n"

    # -- causal tracing / profiler --------------------------------------------
    def _record_trace_span(self, args: list[str]) -> str:
        """Record one donor-side serve span from a TRACESPAN notification.
        Malformed notifications are dropped (never an error back into the
        native dispatch path)."""
        try:
            verb, token, start_ns, dur_ns = (
                args[0], args[1], int(args[2]), int(args[3])
            )
        except (IndexError, ValueError):
            return "OK\r\n"
        ctx = tracewire.parse_token(token)
        if ctx is None:
            return "OK\r\n"
        tracewire.get_collector().record(
            trace_id=ctx.trace_id,
            span_id=tracewire._new_id(),
            parent_id=ctx.span_id,
            name=f"serve.{verb.lower()}",
            role="donor",
            ts_ns=start_ns,
            dur_ns=dur_ns,
            node=f"{self._cfg.host}:{self._server.port}",
        )
        return "OK\r\n"

    def _profile_wire(self, secs: int) -> str:
        """Start a bounded ``torch.profiler`` capture ("PROFILE <secs>"): the
        device data plane's kernels and copies land in the capture (CUDA
        activity on a GPU node; inspect with Perfetto or
        ``chrome://tracing``). The response carries the capture directory
        once the capture runs; its thread stops it after ``secs`` and writes
        ``<dir>/merklekv-<pid>.pt.trace.json``. One capture at a time."""
        secs = max(1, min(secs, 600))
        with self._profile_mu:
            if self._profiling:
                return "ERROR profile capture already running\r\n"
            logdir = self._cfg.observability.profile_dir
            if not logdir:
                # Config contract: "" = <storage_path>/profiles on a
                # durable node (captures survive with the data), system
                # temp on a storage-less one.
                if self._cfg.storage.enabled:
                    logdir = os.path.join(
                        self._cfg.storage_path, "profiles"
                    )
                else:
                    import tempfile

                    logdir = os.path.join(
                        tempfile.gettempdir(), "mkv-profiles"
                    )
            logdir = os.path.join(logdir, time.strftime("%Y%m%d-%H%M%S"))
            trace = os.path.join(logdir, f"merklekv-{os.getpid()}.pt.trace.json")
            activities = ["CPU"]
            if self._device is not None and self._device != "cpu":
                activities.append("CUDA")
            started = threading.Event()
            failed: list = []

            def capture() -> None:
                # torch.profiler must start and stop on one thread.
                try:
                    os.makedirs(logdir, exist_ok=True)
                    from torch.profiler import ProfilerActivity, profile

                    prof = profile(activities=[
                        getattr(ProfilerActivity, a) for a in activities
                    ])
                    prof.start()
                except Exception as e:
                    failed.append(e)
                    started.set()
                    return
                started.set()
                time.sleep(secs)
                try:
                    prof.stop()
                    prof.export_chrome_trace(trace)
                except Exception as e:
                    print(f"profile capture not written: {e}",
                          file=sys.stderr, flush=True)
                finally:
                    with self._profile_mu:
                        self._profiling = False

            self._profiling = True
            threading.Thread(
                target=capture, daemon=True, name="mkv-profile"
            ).start()
            started.wait()
            if failed:
                self._profiling = False
                return f"ERROR profiler unavailable: {failed[0]}\r\n"
        from merklekv_tpu_torch.utils.tracing import get_metrics

        get_metrics().inc("profiler.captures")
        return f"PROFILE {logdir}\r\n"

    def _on_peer_degraded(self, peer: str, reason: str) -> None:
        """A sync stream against ``peer`` died mid-cycle (its remaining
        repairs are checkpointed for resume); reflect it in the health
        table so PEERS shows the degradation while probes keep running."""
        h = self._health
        if h is not None:
            h.mark_degraded(peer, reason)

    def _on_sync_repair(self, key: bytes, value, ts=None) -> None:
        """Anti-entropy repairs bypass the server event queue; feed the
        device mirror directly so HASH stays truthful after a SYNC, and the
        WAL so a repaired key survives a crash without needing re-repair."""
        with self._rep_mu:
            mirror = self._mirror
        if mirror is not None:
            mirror.apply_one(key, value)
        storage = self._storage
        if storage is not None:
            # Journal at the EXACT ts the repair installed (threaded through
            # the listener — an engine read-back here could race a newer
            # concurrent writer and journal the repair value under the
            # winner's timestamp). ts None means the repair carried no
            # ordering metadata (delete_quiet absence copy, legacy full
            # transfer): skip the journal rather than fabricate a ts —
            # anti-entropy re-repairs after a crash.
            if ts is None:
                return
            if value is None:
                storage.record_delete(key, ts)
            else:
                storage.record_set(key, value, ts)

    def _query_ready_mirror(self, fn, force: bool = False):
        """Shared gate for device-tree reads (HASH root, TREELEVEL slices):
        returns ``fn(mirror)``, or None whenever the device path can't
        answer — replication off, device disabled, mirror still warming (a
        warm-up is kicked off), or any device failure — so the native
        fallback serves instead and nothing stalls on the device. A failure
        of the mirror itself is counted and raised (the caller answers an
        error), never answered from the host.

        The freshness contract: the DEFAULT path serves the pump's
        last-published snapshot and performs NO synchronous replicator
        flush — a root-serving query never serializes behind the write
        stream; the tree trails live by at most the [device] max_staleness
        window. ``force=True`` is the explicit exactness escape hatch
        (snapshot stamping, the wire's vs=03 forced refresh): drain staged
        events through the replicator, pump them to the device, THEN
        serve."""
        with self._rep_mu:
            rep, mirror = self._replicator, self._mirror
        if rep is None or mirror is None:
            return None
        if not mirror.ready():
            mirror.start_warming()  # no-op if already in flight
            return None
        try:
            if force:
                rep.flush()  # native queue -> mirror staging
                mirror.publish_now()  # staging -> served snapshot
            return fn(mirror)
        except Exception as e:
            deviceenv.note_device_failure(e, "tree query")
            raise

    def device_tree_level(
        self, level: int, lo: int, hi: int, force: bool = False
    ):
        """TREELEVEL answer from the last-published device tree:
        ``(rows, n)`` with reference-level ``(idx, digest)`` rows, or None
        when the mirror isn't ready (the native server's host-side cached
        tree answers meanwhile, so peers' walks never stall on a warming
        mirror)."""
        return self._query_ready_mirror(
            lambda m: m.level_nodes(level, lo, hi), force=force
        )

    def device_root_hex(self, force: bool = False) -> Optional[str]:
        """Whole-keyspace Merkle root from the last-published device tree,
        or None when the mirror isn't ready (replication off / device
        disabled / still warming — the native path answers meanwhile).
        ``force=True`` drains the write stream to the device first and
        serves an exact root (read-your-writes for snapshot verification
        and tests; the default bounded-staleness path never waits)."""
        return self._query_ready_mirror(
            lambda m: m.published_root_hex(), force=force
        )

    @property
    def health(self):
        return self._health

    @property
    def metrics_port(self) -> Optional[int]:
        """Bound port of the /metrics exporter, or None when disabled."""
        return self._exporter.port if self._exporter is not None else None

    def _health_payload(self) -> dict:
        """/healthz extra fields: engine reachability, peer summary, and
        the convergence-lag readiness level (live|lagging|diverged)."""
        if not self._engine._h:
            return {"keys": -1, "readiness": "diverged"}
        payload = {"keys": self._engine.dbsize(), "port": self._server.port}
        payload["readiness"] = self.lag_tracker.readiness()
        # Overload plane: the degradation rung, and a degraded status the
        # moment the node sheds anything — a load balancer must see a
        # shedding/read-only node as unhealthy-for-writes immediately.
        level = self.ladder.level()
        payload["degradation"] = LEVEL_NAMES.get(level, "live")
        if level >= SHEDDING:
            payload["status"] = "degraded"
        if self._partition_id is not None:
            # Per-partition readiness: this node IS one replica of one
            # partition, so its rung is that partition's health here —
            # an LB/router reading every replica's /healthz gets the
            # per-partition availability matrix.
            payload["partition"] = self._partition_id
            payload["partition_epoch"] = self._partmap.epoch
            payload["partition_state"] = LEVEL_NAMES.get(level, "live")
        with self._rebalance_mu:
            rebalance = self._rebalance
        if rebalance is not None and rebalance.state != "idle":
            # Surfaced only while a session is (or recently was) live —
            # the steady-state payload stays byte-compatible.
            payload["rebalance"] = rebalance.state
        lag = self.lag_tracker.lag_events()
        if lag:
            payload["lag_events"] = sum(lag.values())
        h = self._health
        if h is not None:
            rows = h.snapshot()
            payload["peers_up"] = sum(1 for r in rows if r.status == "up")
            payload["peers_total"] = len(rows)
        return payload

    # -- gauges ---------------------------------------------------------------
    def _register_gauges(self) -> None:
        """Callback gauges over this node's live state. Registration
        replaces same-named gauges (last node wins in multi-node-per-
        process tests); each is read at scrape time, and a callback that
        throws drops only its own sample."""
        from merklekv_tpu_torch.utils.tracing import get_metrics

        m = get_metrics()
        engine = self._engine

        def live_keys() -> int:
            # Guard the raw handle: a gauge outliving the engine (node not
            # stopped before engine.close()) must drop its sample, not
            # drive the FFI through a dead pointer.
            return engine.dbsize() if engine._h else -1

        def tombstones() -> int:
            return len(engine.tombstones()) if engine._h else -1

        def mirror_leaves() -> int:
            with self._rep_mu:
                mirror = self._mirror
            return mirror.leaf_count() if mirror is not None else -1

        def mirror_staleness() -> int:
            with self._rep_mu:
                mirror = self._mirror
            return mirror.staleness() if mirror is not None else -1

        def pump_lag_ms() -> int:
            with self._rep_mu:
                mirror = self._mirror
            return (
                int(round(mirror.pump_lag_ms())) if mirror is not None else -1
            )

        def mirror_shards() -> int:
            with self._rep_mu:
                mirror = self._mirror
            return mirror.shard_count() if mirror is not None else -1

        def backend_level() -> int:
            with self._rep_mu:
                mirror = self._mirror
            return mirror.backend_level() if mirror is not None else -1

        def shard_rebuild_us() -> int:
            with self._rep_mu:
                mirror = self._mirror
            return mirror.shard_rebuild_us() if mirror is not None else -1

        def outbox_depth() -> int:
            t = self._transport
            return getattr(t, "outbox_depth", 0) if t is not None else 0

        def peer_states() -> dict:
            h = self._health
            if h is None:
                return {}
            code = {"up": 2, "degraded": 1, "down": 0, "unknown": -1}
            return {
                r.peer: code.get(r.status, -1) for r in h.snapshot()
            }

        def bootstrap_state() -> int:
            b = self._bootstrap
            return b.state_code() if b is not None else 0

        tracker = self.lag_tracker

        gauges = [
            ("keyspace.keys", live_keys,
             "Live keys in the native engine.", ""),
            ("keyspace.tombstones", tombstones,
             "Deletion records retained for cluster LWW.", ""),
            ("device.tree_leaves", mirror_leaves,
             "Leaf count of the device-resident Merkle tree "
             "(-1: no mirror).", ""),
            ("device.mirror_staleness", mirror_staleness,
             "Engine mutation versions the PUBLISHED device tree trails "
             "the live keyspace by — exact against mkv_engine_version via "
             "the pump's applied-version watermark (-1: no mirror).", ""),
            ("device.pump_lag_versions", mirror_staleness,
             "Pump-plane alias of device.mirror_staleness: versions the "
             "device-update pump has staged but not yet published (-1: no "
             "mirror).", ""),
            ("device.pump_lag_ms", pump_lag_ms,
             "Milliseconds the oldest staged-but-unpublished device-tree "
             "change has waited on the pump (0: caught up; -1: no "
             "mirror).", ""),
            ("device.shards", mirror_shards,
             "Device shards serving the Merkle tree's leaf level "
             "([device] sharding; 1: single-device tree; -1: no mirror or "
             "warming).", ""),
            ("device.shard_rebuild_us", shard_rebuild_us,
             "Dispatch cost of the last sharded subtree rebuild in "
             "microseconds (async enqueue; -1: single-device backend or "
             "no rebuild yet).", ""),
            ("device.backend_level", backend_level,
             "Degradation-ladder rung serving the Merkle tree (N>=2: "
             "sharded width; 1: single-device; 0: CPU golden tree; -1: "
             "native fallback / warming / no mirror).", ""),
            ("replication.outbox_depth", outbox_depth,
             "Events queued in the transport outbox awaiting a broker "
             "heal.", ""),
            ("peer.state", peer_states,
             "Peer health (2=up 1=degraded 0=down -1=unknown).", "peer"),
            ("bootstrap.state", bootstrap_state,
             "Bootstrap state machine (0=idle 1=discover 2=fetch 3=verify "
             "4=delta 5=live -1=failed).", ""),
            ("replication.lag_events", tracker.lag_events,
             "Events a peer has published (envelope HWM) that this node "
             "has not yet applied; anti-entropy convergence clears drop "
             "residue.", "src"),
            ("replication.lag_ms", tracker.lag_ms,
             "Publish-to-apply wall delay of the newest applied frame per "
             "peer (ms; cross-host clock skew applies).", "src"),
            ("node.readiness", tracker.readiness_code,
             "Convergence readiness (2=live 1=lagging 0=diverged).", ""),
            ("node.degradation", self.ladder.level,
             "Overload degradation ladder (0=live 1=shedding 2=read_only "
             "3=draining).", ""),
            ("rebalance.state", self._rebalance_state_code,
             "Live-rebalance session phase (0=idle, donor 1-7 "
             "conscribe..done, joiner 10-13, negative=failed/aborted).",
             ""),
        ]
        if self._partition_id is not None:
            pid = str(self._partition_id)
            ladder = self.ladder

            def partition_state() -> dict:
                # Labeled by partition so a fleet-wide scrape aggregates
                # into the per-partition availability matrix directly
                # (max by partition = worst replica's rung).
                return {pid: ladder.level()}

            gauges.append(
                ("partition.state", partition_state,
                 "Degradation rung of this replica's partition (0=live "
                 "1=shedding 2=read_only 3=draining), labeled with the "
                 "partition id it serves.", "partition")
            )
        if self._storage is not None:
            storage = self._storage
            gauges += [
                ("storage.wal_bytes", storage.wal_size_bytes,
                 "Total bytes across live WAL segments.", ""),
                ("storage.wal_segments", storage.wal_segment_count,
                 "Live WAL segment files.", ""),
            ]
        for name, fn, help_, label in gauges:
            m.register_gauge(name, fn, help=help_, label=label)
        self._gauge_names = [(g[0], g[1]) for g in gauges]

    def _unregister_gauges(self) -> None:
        from merklekv_tpu_torch.utils.tracing import get_metrics

        m = get_metrics()
        for name, fn in self._gauge_names:
            # Identity-checked: if a later node replaced this name (the
            # documented last-wins rule), its registration survives our
            # stop instead of being stripped with ours.
            m.unregister_gauge(name, fn)
        self._gauge_names = []

    def _metrics_wire(self) -> str:
        """METRICS wire payload: the control plane's counter snapshot —
        transport reconnects/outbox drops, anti-entropy loop counters, span
        counts — as ``name:value`` lines. The complement of STATS, which
        covers the native engine/server scope only."""
        from merklekv_tpu_torch.utils.tracing import get_metrics

        metrics = get_metrics()
        lines = []
        snap = metrics.snapshot()
        for name in sorted(snap["counters"]):
            lines.append(f"{name}:{snap['counters'][name]}")
        # Span aggregates (integers only — the parsers treat values as
        # numeric text): count, total, and bucket-derived percentiles per
        # span name. total_us is the canonical total; the deprecated
        # total_ms field (sub-millisecond spans truncated to 0) finished
        # its one-release window and is gone — docs/PROTOCOL.md "METRICS".
        for name in sorted(snap["spans"]):
            sp = snap["spans"][name]
            lines.append(f"span.{name}.count:{sp['count']}")
            lines.append(f"span.{name}.total_us:{int(sp['total_s'] * 1e6)}")
            hist = snap["histograms"].get(f"span.{name}")
            if hist and hist["count"]:
                h = metrics.histogram(f"span.{name}")
                for q, tag in ((0.5, "p50_us"), (0.99, "p99_us")):
                    v = h.quantile(q)
                    if v is not None:
                        lines.append(f"span.{name}.{tag}:{int(v * 1e6)}")
        t = self._transport
        if t is not None:
            for attr in ("reconnects", "outbox_dropped", "callback_errors"):
                v = getattr(t, attr, None)
                if v is not None:
                    lines.append(f"transport.{attr}_live:{v}")
        # Convergence-lag plane: per-peer lag gauges + the readiness level,
        # so wire-only consumers (top) see them without scraping /metrics.
        # The METRICS contract is integer-text values across the board
        # (parsers depend on it), so lag_ms rounds and readiness rides as
        # its numeric code (2=live 1=lagging 0=diverged).
        for src, v in sorted(self.lag_tracker.lag_events().items()):
            lines.append(f"replication.lag_events.{src}:{v}")
        for src, v in sorted(self.lag_tracker.lag_ms().items()):
            lines.append(f"replication.lag_ms.{src}:{int(round(v))}")
        lines.append(f"readiness_code:{self.lag_tracker.readiness_code()}")
        # Device freshness plane: pump lag (versions + ms) and the
        # engine-vs-served tree versions, so wire-only consumers (top's
        # STALE and VER columns) see the staleness contract without
        # scraping /metrics. Integer-text contract like every METRICS line.
        with self._rep_mu:
            mirror = self._mirror
        if mirror is not None:
            # Deliberately OUTSIDE the ready() gate below: the backend
            # level is most interesting exactly when the mirror is NOT
            # ready (-1 = serving off the native fallback — top's BKND
            # column must show the degradation, not hide it).
            lines.append(f"device.backend_level:{mirror.backend_level()}")
        if mirror is not None and mirror.ready():
            # Gated on ready(): a warming mirror has no published tree, and
            # tree_version 0 would read as "202 versions stale" in top's
            # VER column instead of "no device serving yet" ("-").
            try:
                lines.append(
                    f"device.pump_lag_versions:{mirror.staleness()}"
                )
                lines.append(
                    "device.pump_lag_ms:"
                    f"{int(round(mirror.pump_lag_ms()))}"
                )
                lines.append(
                    f"device.tree_version:{mirror.published_version()}"
                )
                lines.append(f"device.shards:{mirror.shard_count()}")
                if self._engine._h:
                    lines.append(
                        f"node.engine_version:{self._engine.version()}"
                    )
            except Exception:
                pass  # a dying mirror drops its lines, not METRICS
        # Partition plane: identity + state lines so wire-only consumers
        # (top's PART column, the chaos suite) see which partition this
        # node serves and how it is doing, without scraping /metrics.
        # Integer-text contract like every METRICS line.
        if self._partition_id is not None:
            lines.append(f"partition.id:{self._partition_id}")
            lines.append(f"partition.epoch:{self._partmap.epoch}")
            lines.append(f"partition.count:{self._partmap.count}")
            lines.append(f"partition.state:{self.ladder.level()}")
        lines.append(f"rebalance.state:{self._rebalance_state_code()}")
        # Overload plane: the ladder rung plus the native shed counters
        # (one stats_text read), so wire-only consumers (top's STATE and
        # SHED/s columns) see overload state without scraping /metrics.
        lines.append(f"node.degradation:{self.ladder.level()}")
        try:
            stats: dict[str, str] = {}
            for ln in self._server.stats_text().splitlines():
                name, _, value = ln.strip().partition(":")
                stats[name] = value
            shed = sum(
                int(stats.get(k, 0) or 0)
                for k in (
                    "shed_commands",
                    "busy_rejected_connections",
                    "pipeline_rejected",
                )
            )
            lines.append(f"node.shed_total:{shed}")
            lines.append(
                "node.readonly_rejected:"
                f"{int(stats.get('readonly_commands', 0) or 0)}"
            )
        except Exception:
            pass  # a dead server handle drops the shed lines, not METRICS
        body = "".join(f"{ln}\r\n" for ln in lines)
        return f"METRICS\r\n{body}END\r\n"

    @staticmethod
    def _take_version_flags(args: list[str]) -> tuple[bool, bool]:
        """(want_version, force_refresh) from a trailing vs=XX token the
        native parser relayed on HASH/TREELEVEL callback lines."""
        for p in args:
            if len(p) == 5 and p.startswith("vs="):
                try:
                    flags = int(p[3:], 16)
                except ValueError:
                    continue
                return bool(flags & 1), bool(flags & 2)
        return False, False

    def _version_lag(self, served_version: int) -> int:
        """Mutations the live engine has moved past the served tree — the
        lag half of a stamped answer. A dead engine handle reads as 0
        rather than driving the FFI through a closed pointer."""
        try:
            if not self._engine._h:
                return 0
            return max(0, self._engine.version() - served_version)
        except Exception:
            return 0

    # -- cluster command callback ---------------------------------------------
    def _on_cluster_command(self, line: str) -> Optional[str]:
        parts = line.split()
        if parts[0] == "PEERS":
            if self._health is None:
                return None  # native default: empty table
            return self._health.wire_table()
        if parts[0] == "REBALANCE":
            # Live-rebalance control plane. Relayed by the native server
            # OUTSIDE the degradation/serving gates: a fenced sibling or a
            # non-serving joiner must still take COMMIT/ABORT, or a
            # wobbling node could wedge the whole session.
            return self._rebalance_manager().handle(parts[1:])
        if parts[0] == "PARTMAP":
            # Versioned partition map: any member serves the full routing
            # table (smart clients/routers bootstrap from whichever node
            # they can reach). None on an unpartitioned node -> the native
            # fallback answers ERROR (capability signal).
            if self._partmap is None:
                return None
            return self._partmap.wire()
        if parts[0] == "METRICS":
            return self._metrics_wire()
        if parts[0] == "TRACE":
            # Correlated anti-entropy traces: newest n cycles, one k=v row
            # per (cycle, peer) from the process-wide ring buffer.
            from merklekv_tpu_torch.obs.trace import get_trace_buffer

            n = int(parts[1]) if len(parts) > 1 else 8
            return get_trace_buffer().wire_dump(n)
        if parts[0] == "TRACEDUMP":
            # Raw causal-trace spans (cross-node stitching input).
            n = int(parts[1]) if len(parts) > 1 else 0
            return tracewire.get_collector().wire_dump(n)
        if parts[0] == "TRACESPAN":
            # Native server notification: a traced cluster verb was served
            # on this node. Record the donor-side span under the
            # initiator's trace id, parented to the span id the token
            # carried. "TRACESPAN <VERB> <tc=token> <start_ns> <dur_ns>".
            return self._record_trace_span(parts[1:])
        if parts[0] == "FLIGHT":
            # Flight-recorder stream: the full python event ring (which
            # includes native slow commands relayed via SLOWCMD below).
            from merklekv_tpu_torch.obs.flightrec import get_recorder

            n = int(parts[1]) if len(parts) > 1 else 64
            return get_recorder().wire_dump(n)
        if parts[0] == "SLOWCMD":
            # Native notification: a dispatch crossed the slow-command
            # threshold. "SLOWCMD <VERB> <dur_us> <addr> [tc=token]" —
            # a traced serve carries the initiator's token, and stamping
            # its trace id here is what lets blackbox link this node's
            # slow serve to the initiator's cycle across spills.
            # Malformed notifications drop (never an error into native
            # dispatch).
            from merklekv_tpu_torch.obs.flightrec import record

            try:
                fields = {
                    "verb": parts[1],
                    "dur_us": int(parts[2]),
                    "conn": parts[3],
                }
                if len(parts) > 4:
                    ctx = tracewire.parse_token(parts[4])
                    if ctx is not None:
                        fields["trace"] = f"{ctx.trace_id:016x}"
                record("slow_command", **fields)
            except (IndexError, ValueError):
                pass
            return "OK\r\n"
        if parts[0] == "PROFILE":
            return self._profile_wire(int(parts[1]))
        if parts[0] == "HASH":
            # Whole-keyspace root served from the device pump's
            # last-published snapshot; empty answer falls back to the
            # native path. A trailing vs= token (relayed verbatim by the
            # native parser) asks for the version stamp / forced refresh.
            want, force = self._take_version_flags(parts[1:])
            if not want:
                root = self.device_root_hex(force=force)
                return f"HASH {root}\r\n" if root is not None else None
            out = self._query_ready_mirror(
                lambda m: m.published_root_stamped(), force=force
            )
            if out is None:
                return None
            root, ver = out
            return f"HASH {root} {ver} {self._version_lag(ver)}\r\n"
        if parts[0] == "TREELEVEL":
            # Bisection-walk node fetch served from the pump's
            # last-published tree (one batched device gather per request);
            # empty answer falls back to the native server's cached host
            # tree. Stamped when the request carried a vs= token.
            args = [p for p in parts[1:] if not p.startswith("vs=")]
            want, force = self._take_version_flags(parts[1:])
            if not want:
                out = self.device_tree_level(
                    int(args[0]), int(args[1]), int(args[2]), force=force
                )
                if out is None:
                    return None
                rows, n = out
                body = "".join(f"{i} {d.hex()}\r\n" for i, d in rows)
                return f"NODES {len(rows)} {n}\r\n{body}"
            out = self._query_ready_mirror(
                lambda m: m.level_nodes_stamped(
                    int(args[0]), int(args[1]), int(args[2])
                ),
                force=force,
            )
            if out is None:
                return None
            rows, n, ver = out
            body = "".join(f"{i} {d.hex()}\r\n" for i, d in rows)
            return (
                f"NODES {len(rows)} {n} {ver} {self._version_lag(ver)}\r\n"
                f"{body}"
            )
        if parts[0] == "SNAPMETA":
            return self._snap_meta_wire()
        if parts[0] == "SNAPCHUNK":
            return self._snap_chunk_wire(
                int(parts[1]), int(parts[2]), int(parts[3])
            )
        if parts[0] == "SYNC":
            host, port = parts[1], int(parts[2])
            try:
                self.sync_manager.sync_once(
                    host,
                    port,
                    full="--full" in parts,
                    verify="--verify" in parts,
                )
                return "OK\r\n"
            except Exception as e:
                return f"ERROR {e}\r\n"
        if parts[0] == "REPLICATE":
            action = parts[1]
            if action == "enable":
                err = self._enable_replication()
                return "OK\r\n" if err is None else f"ERROR {err}\r\n"
            if action == "disable":
                self._disable_replication()
                return "OK\r\n"
            if action == "status":
                with self._rep_mu:
                    enabled = self._replicator is not None
                if enabled:
                    n = len(self._cfg.replication.peer_list)
                    return f"REPLICATION enabled {n} nodes\r\n"
                return "REPLICATION disabled\r\n"
        return None
