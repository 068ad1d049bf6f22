"""Configuration: TOML file + CLI/env overrides.

A copy of ``merklekv_tpu/config.py``, its imports pointed at the port's modules.

Schema mirrors the reference's Config (the reference's src/config.rs:48-109):
top-level host/port/storage_path/engine/sync_interval_seconds, a
[replication] table, and an [anti_entropy] table. Secrets come env-first
(CLIENT_ID / CLIENT_PASSWORD, reference replication.rs:101-112). Parsing
uses stdlib tomllib — no third-party config crate needed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

try:
    import tomllib  # Python >= 3.11
except ModuleNotFoundError:  # pragma: no cover - depends on interpreter
    tomllib = None


def _parse_toml_value(text: str):
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        if not inner:
            return []
        # Split on top-level commas (strings in our configs never contain
        # commas, but guard quoted segments anyway).
        items, depth, quote, cur = [], 0, "", ""
        for ch in inner:
            if quote:
                cur += ch
                if ch == quote:
                    quote = ""
                continue
            if ch in "\"'":
                quote = ch
                cur += ch
            elif ch == "[":
                depth += 1
                cur += ch
            elif ch == "]":
                depth -= 1
                cur += ch
            elif ch == "," and depth == 0:
                items.append(cur)
                cur = ""
            else:
                cur += ch
        if cur.strip():
            items.append(cur)
        return [_parse_toml_value(i) for i in items]
    if (text.startswith('"') and text.endswith('"')) or (
        text.startswith("'") and text.endswith("'")
    ):
        return text[1:-1]
    if text == "true":
        return True
    if text == "false":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text  # bare string (lenient; our schema coerces with str())


def _minitoml_loads(text: str) -> dict:
    """Fallback parser for the TOML subset this schema uses (scalar keys,
    [section] tables, single-line arrays, # comments) — Python 3.10 has no
    stdlib tomllib and this environment must not grow dependencies."""
    root: dict = {}
    table = root
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            # "[section]  # comment" is valid TOML; section names in this
            # schema never contain '#', so a plain split is safe here.
            head = line.split("#", 1)[0].strip()
            if not head.endswith("]"):
                raise ValueError(f"malformed TOML line: {raw_line!r}")
            table = root
            for part in head[1:-1].strip().split("."):
                table = table.setdefault(part.strip(), {})
            continue
        key, sep, value = line.partition("=")
        if not sep:
            raise ValueError(f"malformed TOML line: {raw_line!r}")
        # Strip trailing comments outside quotes.
        out, quote = "", ""
        for ch in value:
            if quote:
                out += ch
                if ch == quote:
                    quote = ""
            elif ch in "\"'":
                quote = ch
                out += ch
            elif ch == "#":
                break
            else:
                out += ch
        table[key.strip().strip('"').strip("'")] = _parse_toml_value(out)
    return root


def _toml_load(f) -> dict:
    if tomllib is not None:
        return tomllib.load(f)
    return _minitoml_loads(f.read().decode("utf-8"))


@dataclass
class ServerConfig:
    """[server]: overload protection / admission control (cluster/
    overload.py + the native server's accept/dispatch path).

    All watermarks default OFF (0) — a bare node behaves exactly like the
    seed. When set, the node walks the degradation ladder (live ->
    shedding -> read_only -> draining) instead of exhausting threads, RAM,
    or disk. See docs/FAULT_MODEL.md "Resource exhaustion" and
    docs/DEPLOYMENT.md for capacity planning.
    """

    # Epoll worker-pool width (the I/O plane): every accepted connection
    # is owned by exactly one of io_threads event-loop workers. 0 (the
    # default) sizes the pool to hardware concurrency; 1 keeps a single
    # loop. See docs/DEPLOYMENT.md "I/O plane sizing".
    io_threads: int = 0
    # SO_REUSEPORT accept sharding: "auto" (default) gives every io worker
    # its own listening socket where the kernel supports it — the kernel
    # deals connections across workers and the single accept thread stops
    # being the connection-storm bottleneck; "on" insists (falls back with
    # a note where unsupported); "off" keeps the single accept loop.
    # Admission control is enforced identically on both paths.
    reuseport: str = "auto"
    # Zero-copy serving (default on): GET/MGET hand the engine's
    # refcounted value block straight to writev — zero copies after
    # ingest. false restores the copy-out-of-the-engine compat path
    # (wire-identical; the bench A/B baseline).
    zero_copy: bool = True
    # Request-line byte cap (0 = the 1 MiB default). Size it ABOVE the
    # largest value a SET may carry plus ~key/verb headroom; see
    # docs/DEPLOYMENT.md "Large-value serving".
    max_line_bytes: int = 0
    # Accepted-connection cap: past it, excess accepts are answered
    # "ERROR BUSY connections retry" and closed without ever entering the
    # worker pool. 0 = unlimited.
    max_connections: int = 0
    # One connection's in-flight pipelined-command budget: a client that
    # buffers more unanswered complete lines than this is answered BUSY
    # and closed. 0 = unlimited (default — deep pipelining is a
    # legitimate throughput pattern; cap it per deployment).
    max_pipeline: int = 0
    # Engine resident-bytes watermarks (approximate keys+values bytes,
    # O(1) to read). soft: shed writes with a retryable BUSY (reads stay
    # open); hard: flip read-only. 0 disables each.
    memory_soft_bytes: int = 0
    memory_hard_bytes: int = 0
    # Hysteresis: a watermark only releases once the signal falls below
    # watermark * recovery_ratio — no BUSY/OK flapping at the boundary.
    recovery_ratio: float = 0.85
    # Overload-monitor poll cadence.
    watermark_interval_seconds: float = 0.25


@dataclass
class ReplicationConfig:
    enabled: bool = False
    # Broker endpoint for WAN replication; "local" selects the in-process
    # event bus (tests / single-host clusters).
    mqtt_broker: str = "localhost"
    mqtt_port: int = 1883
    # "framed": the self-hosted length-framed TcpBroker (default fabric).
    # "mqtt": real MQTT 3.1.1 frames — joins an existing mosquitto-style
    # deployment, like the reference (replication.rs:115-143).
    transport: str = "framed"
    topic_prefix: str = "merkle_kv"
    client_id: str = ""
    username: str = ""
    password: str = ""
    peer_list: list[str] = field(default_factory=list)
    # Outbound frame caps: a drained batch is coalesced per key and
    # published as envelope frames of at most batch_max_events events /
    # ~batch_max_bytes payload each. <= 1 disables batching — every event
    # goes out as a legacy single-event payload (the format peers that
    # predate the batch envelope decode; also the per-event baseline the
    # replicated_write_throughput bench A/Bs against).
    batch_max_events: int = 512
    batch_max_bytes: int = 1 << 20
    # LWW clock-skew guard: an applied replication event whose timestamp
    # is further than this beyond the local clock is CLAMPED to
    # now + max_skew_ms (counted, per-peer attributed) — a peer with a
    # misconfigured clock can delay convergence on a key by at most the
    # skew bound instead of fencing it forever. 0 disables clamping.
    max_skew_ms: int = 300_000

    def resolve_env(self) -> None:
        self.client_id = os.environ.get("CLIENT_ID", self.client_id)
        self.password = os.environ.get("CLIENT_PASSWORD", self.password)


@dataclass
class AntiEntropyConfig:
    enabled: bool = False
    interval_seconds: float = 60.0
    peers: list[str] = field(default_factory=list)  # "host:port"
    # "cpu" forces the host diff path; "auto" uses the TPU engine when the
    # keyspace is large enough to amortize a device round-trip.
    engine: str = "auto"
    # true: each cycle gathers ALL peers' leaf hashes and arbitrates per key
    # in one fused [R, N] diff program; false: pairwise local := peer syncs.
    multi_peer: bool = False
    # Pairwise transfer strategy when roots differ: "auto" runs the
    # subtree-bisection walk (TREELEVEL descent, wire bytes ∝
    # divergence·log n) once the local keyspace reaches bisect_threshold
    # keys and keeps the paged hash scan below it (fewer round trips on a
    # small keyspace, and the multi-peer fan-out path always gathers
    # hashes); "bisect" always walks; "page" always scans.
    mode: str = "auto"
    bisect_threshold: int = 8192


@dataclass
class StorageConfig:
    """[storage]: the durable subsystem (merklekv_tpu_torch/storage/).

    Off by default — a bare node stays the in-memory engine the seed
    shipped. When enabled, the node journals every observed write to a
    CRC-framed WAL under ``<storage_path>/node-<port>/``, compacts into
    Merkle-root-stamped snapshots, and recovers (verified) on restart.
    See docs/PERSISTENCE.md.
    """

    enabled: bool = False
    # "always": fsync inside every append (max durability, ~1 fsync per
    # drained batch); "interval": fsync every fsync_interval_seconds;
    # "never": OS writeback only.
    fsync: str = "interval"
    fsync_interval_seconds: float = 0.05
    # Rotate WAL segments at this size.
    segment_bytes: int = 4 << 20
    # Background compaction (snapshot + truncate old segments) triggers
    # when this many WAL bytes accumulate since the last snapshot; 0
    # disables the trigger (explicit/shutdown snapshots only).
    compact_trigger_bytes: int = 32 << 20
    # Keep this many snapshots; older WAL segments only survive while a
    # retained snapshot still needs them for replay.
    snapshots_retained: int = 2
    # "repair": a snapshot failing root verification is rejected and
    # recovery falls back (older snapshot, else full WAL replay);
    # "strict": refuse to start instead.
    verify: str = "repair"
    # Root stamping/verification path: "auto" uses the device bulk rebuild
    # for keyspaces >= device_min_keys, "cpu" pins host hashing (no jax
    # import), "tpu" always tries the device.
    merkle_engine: str = "auto"
    device_min_keys: int = 4096
    # Write a final snapshot on clean shutdown (fast, verified restarts).
    snapshot_on_shutdown: bool = True
    # Disk-free watermarks, checked on the store's ticker (statvfs on the
    # data dir). Free bytes below soft: shed writes (retryable BUSY);
    # below hard: read-only. 0 disables each; a live ENOSPC/EIO from the
    # WAL always flips read-only regardless (reactive handling is not
    # configurable). soft must be >= hard — it is the EARLIER warning.
    disk_free_soft_bytes: int = 0
    disk_free_hard_bytes: int = 0


@dataclass
class BootstrapConfig:
    """[bootstrap]: elastic-membership node bootstrap (cluster/bootstrap.py).

    When enabled, a node that starts with an empty keyspace — or recovers
    through interior WAL corruption — fetches a peer's newest Merkle-stamped
    snapshot over SNAPMETA/SNAPCHUNK, verifies the stamped root locally
    BEFORE serving a single read, then closes the post-stamp gap with a
    bisect delta walk. Donors come from [anti_entropy].peers. Peers that
    cannot serve a snapshot degrade the joiner to the plain anti-entropy
    walk. See docs/PERSISTENCE.md "Snapshot shipping".
    """

    enabled: bool = False
    # Raw snapshot bytes requested per SNAPCHUNK (the resume granularity on
    # a hostile link). Clamped to [4096, 262144]; the donor additionally
    # clamps to its own response-buffer budget.
    chunk_bytes: int = 131072
    # Integrity/transport retries per chunk offset before failing over to
    # the next donor.
    chunk_retries: int = 4


@dataclass
class ObservabilityConfig:
    """[observability]: the metrics plane (merklekv_tpu_torch/obs/).

    ``http_port`` > 0 starts a per-node HTTP exporter serving Prometheus
    text exposition at ``/metrics`` (+ ``/healthz``) — registry counters,
    histograms, gauges, and the native STATS block bridged into one
    namespace. 0 (default) disables the endpoint; the METRICS wire verb
    and the TRACE ring buffer work either way. See docs/OBSERVABILITY.md.
    """

    http_port: int = 0  # 0 = disabled; -1 = ephemeral (tests)
    http_host: str = "127.0.0.1"
    # Ring-buffer capacity of the TRACE verb's cycle store.
    trace_cycles: int = 128
    # Causal trace propagation (obs/tracewire.py): anti-entropy cycles
    # allocate a trace context and cluster verbs carry the tc= token so
    # donor spans stitch into the initiator's trace. Off reverts to the
    # process-local TRACE surface only.
    trace_propagation: bool = True
    # Span-collector ring capacity (spans, not cycles) behind TRACEDUMP.
    trace_spans: int = 8192
    # Convergence-lag SLO plane (obs/lag.py): /healthz readiness flips to
    # "lagging" when a frame applies more than lag_ms_threshold behind its
    # publish clock (or any lag residue exists), and to "diverged" when
    # residue persists past diverged_after_s without an anti-entropy
    # convergence clearing it.
    lag_ms_threshold: float = 1000.0
    diverged_after_s: float = 120.0
    # PROFILE verb capture directory ("" = <storage_path>/profiles or a
    # temp dir on storage-less nodes).
    profile_dir: str = ""
    # Flight recorder (post-mortem black box, obs/flightrec.py). Always on
    # in-memory (event ring + FLIGHT verb); the durable spill only writes
    # when a directory resolves — flight_dir "" means <node data dir>/flight
    # on durable nodes and NO spill on storage-less ones (an embedded test
    # node must not litter the filesystem).
    flight_enabled: bool = True
    flight_dir: str = ""
    # Event-ring capacity (state transitions + slow commands).
    flight_events: int = 2048
    # Metric-sampler cadence: counters + gauges + native STATS snapshot
    # every flight_sample_s into a ~15 min ring, so "what changed in the
    # 60 s before death" is always answerable from the spill.
    flight_sample_s: float = 1.0
    # Spill rewrite cadence (atomic tmp+rename; kill -9 always leaves the
    # previous complete spill).
    flight_spill_s: float = 10.0
    # Slow-command log threshold in MICROSECONDS: native dispatch records
    # verb/latency/connection for commands at or over it. 0 disables.
    slow_command_us: int = 10_000


@dataclass
class DeviceConfig:
    # Serving-tree shard plane (parallel/sharded_state.py): "off" keeps the
    # single-device tree; "auto" shards the keyspace-ordered leaf array
    # across the largest power-of-two subset of the LOCAL devices (per-shard
    # subtree rebuilds in parallel, shard roots combined via all_gather); an
    # explicit power-of-two N pins the mesh width (clamped, with a warning,
    # to the device complement). TREELEVEL/HASH answers are bit-identical
    # at every setting — see docs/DEPLOYMENT.md "Mesh sizing".
    sharding: str = "off"
    # Deprecated alias ([device] sharded_mirror = true == sharding = "auto"):
    # the pre-sharding-knob GSPMD toggle, honored one release for configs
    # that predate the explicit SPMD backend.
    sharded_mirror: bool = False
    # Freshness contract of the device-update pump (cluster/mirror.py):
    # the served tree trails the live engine by at most this wall window.
    # Writes never wait on the device plane; the pump drains staged events
    # into scatter batches on its own cadence, publishing immediately when
    # idle and coalescing into bigger dispatches under load. See
    # docs/DEPLOYMENT.md "Tree freshness sizing".
    max_staleness_ms: float = 200.0
    # Optional version-count bound: a staged backlog deeper than this many
    # engine mutations skips the pump's coalesce delay and drains at once
    # (0 = wall-window-only). Also the lag past which anti-entropy walkers
    # escalate a stale donor tree to a forced refresh.
    max_staleness_versions: int = 0
    # Fault containment (merklekv_tpu_torch/device/): every device program call
    # runs deadline-guarded on a dedicated executor; a dispatch wedged past
    # this bound is ABANDONED (typed error, never a hung pump/query
    # thread). Must comfortably exceed the backend's worst first-use
    # COMPILE time — an undersized deadline reads a legitimate compile as
    # a hang and degrades the mesh for nothing (docs/DEPLOYMENT.md
    # "Device fault containment"). 0 disables the executor bound.
    dispatch_deadline_ms: float = 60_000.0
    # Consecutive environment-classified drain failures at one ladder rung
    # before stepping down (sharded(N) -> ... -> single-device -> CPU).
    degrade_after_failures: int = 2
    # Integrity scrub: every interval, cross-check a sampled leaf range of
    # the SERVED device tree against CPU golden hashes recomputed from the
    # engine — silent device corruption triggers invalidate+rebuild
    # instead of serving a wrong root into anti-entropy. 0 disables.
    scrub_interval_s: float = 30.0
    scrub_keys: int = 256


@dataclass
class ClusterConfig:
    """[cluster]: partitioned cluster mode (cluster/partmap.py, router).

    Off by default (``partitions = 0``) — a bare node serves the whole
    keyspace exactly like the seed. When set, this node owns exactly ONE
    partition of a ``partitions``-way hashed keyspace: the native dispatch
    answers data verbs for foreign keys with the retryable ``ERROR MOVED
    <pid> <epoch>``, the replication topic becomes partition-local
    (``<topic_prefix>/p<pid>``), anti-entropy peers default to the
    partition's sibling replicas from the map, and the node serves the
    full map over the ``PARTMAP`` verb. See docs/DEPLOYMENT.md
    "Partition sizing" and docs/PROTOCOL.md "Partitioned cluster mode".
    """

    # Total partitions in the cluster (0 = unpartitioned).
    partitions: int = 0
    # The ONE partition this node owns (required when partitions > 0).
    partition_id: int = -1
    # Full replica table, "0=host:port,host:port;1=host:port;...":
    # every partition exactly once. Required when partitions > 0 — the
    # node serves it via PARTMAP (smart clients/routers bootstrap from
    # it) and derives sibling anti-entropy peers from its own group.
    partition_map: str = ""
    # Map generation: bump when installing a rebalanced map. Rides in
    # every MOVED answer so stale clients know to refresh.
    map_epoch: int = 1


@dataclass
class Config:
    host: str = "127.0.0.1"
    port: int = 7379
    storage_path: str = "merklekv_data"
    engine: str = "mem"
    sync_interval_seconds: float = 60.0
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    replication: ReplicationConfig = field(default_factory=ReplicationConfig)
    anti_entropy: AntiEntropyConfig = field(default_factory=AntiEntropyConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    bootstrap: BootstrapConfig = field(default_factory=BootstrapConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig
    )

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path, "rb") as f:
            raw = _toml_load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        cfg = cls()
        for k in ("host", "storage_path", "engine"):
            if k in raw:
                setattr(cfg, k, str(raw[k]))
        if "port" in raw:
            cfg.port = int(raw["port"])
        ae = raw.get("anti_entropy", {})
        if "sync_interval_seconds" in raw:
            # Reference semantics (config.rs:48-74): the top-level interval
            # is the sync cadence. Here it seeds the anti-entropy loop's
            # interval; an explicit [anti_entropy].interval_seconds wins.
            cfg.sync_interval_seconds = float(raw["sync_interval_seconds"])
            if "interval_seconds" not in ae:
                cfg.anti_entropy.interval_seconds = cfg.sync_interval_seconds
        srv = raw.get("server", {})
        for k in (
            "io_threads",
            "max_connections",
            "max_pipeline",
            "memory_soft_bytes",
            "memory_hard_bytes",
            "max_line_bytes",
        ):
            if k in srv:
                setattr(cfg.server, k, int(srv[k]))
        if cfg.server.io_threads < 0:
            raise ValueError(
                "[server] io_threads must be >= 0 (0 = hardware "
                f"concurrency), got {cfg.server.io_threads}"
            )
        if "reuseport" in srv:
            cfg.server.reuseport = str(srv["reuseport"])
        if cfg.server.reuseport not in ("auto", "on", "off"):
            raise ValueError(
                "[server] reuseport must be auto|on|off, got "
                f"{cfg.server.reuseport!r}"
            )
        if "zero_copy" in srv:
            cfg.server.zero_copy = bool(srv["zero_copy"])
        if cfg.server.max_line_bytes < 0:
            raise ValueError(
                "[server] max_line_bytes must be >= 0 (0 = the 1 MiB "
                f"default), got {cfg.server.max_line_bytes}"
            )
        if "recovery_ratio" in srv:
            cfg.server.recovery_ratio = float(srv["recovery_ratio"])
        if "watermark_interval_seconds" in srv:
            cfg.server.watermark_interval_seconds = float(
                srv["watermark_interval_seconds"]
            )
        if cfg.server.max_connections < 0:
            raise ValueError(
                "[server] max_connections must be >= 0 (0 = unlimited), "
                f"got {cfg.server.max_connections}"
            )
        if cfg.server.max_pipeline < 0:
            raise ValueError(
                "[server] max_pipeline must be >= 0 (0 = unlimited), "
                f"got {cfg.server.max_pipeline}"
            )
        if cfg.server.memory_soft_bytes < 0 or cfg.server.memory_hard_bytes < 0:
            raise ValueError("[server] memory watermarks must be >= 0")
        if (
            cfg.server.memory_soft_bytes
            and cfg.server.memory_hard_bytes
            and cfg.server.memory_soft_bytes > cfg.server.memory_hard_bytes
        ):
            raise ValueError(
                "[server] memory_soft_bytes must be <= memory_hard_bytes "
                f"(soft sheds first), got {cfg.server.memory_soft_bytes} > "
                f"{cfg.server.memory_hard_bytes}"
            )
        if not 0.0 < cfg.server.recovery_ratio < 1.0:
            raise ValueError(
                "[server] recovery_ratio must be in (0, 1), got "
                f"{cfg.server.recovery_ratio}"
            )
        if cfg.server.watermark_interval_seconds <= 0:
            raise ValueError(
                "[server] watermark_interval_seconds must be > 0, got "
                f"{cfg.server.watermark_interval_seconds}"
            )
        rep = raw.get("replication", {})
        for k in ("mqtt_broker", "transport", "topic_prefix", "client_id",
                  "username", "password"):
            if k in rep:
                setattr(cfg.replication, k, str(rep[k]))
        if "enabled" in rep:
            cfg.replication.enabled = bool(rep["enabled"])
        if "mqtt_port" in rep:
            cfg.replication.mqtt_port = int(rep["mqtt_port"])
        if "peer_list" in rep:
            cfg.replication.peer_list = [str(p) for p in rep["peer_list"]]
        if "batch_max_events" in rep:
            cfg.replication.batch_max_events = int(rep["batch_max_events"])
        if "batch_max_bytes" in rep:
            cfg.replication.batch_max_bytes = int(rep["batch_max_bytes"])
        if "max_skew_ms" in rep:
            cfg.replication.max_skew_ms = int(rep["max_skew_ms"])
        if cfg.replication.max_skew_ms < 0:
            raise ValueError(
                "[replication] max_skew_ms must be >= 0 (0 = no clamping), "
                f"got {cfg.replication.max_skew_ms}"
            )
        if cfg.replication.batch_max_bytes < 1024:
            raise ValueError(
                "[replication] batch_max_bytes must be >= 1024, got "
                f"{cfg.replication.batch_max_bytes}"
            )
        if "enabled" in ae:
            cfg.anti_entropy.enabled = bool(ae["enabled"])
        if "interval_seconds" in ae:
            cfg.anti_entropy.interval_seconds = float(ae["interval_seconds"])
        if "peers" in ae:
            cfg.anti_entropy.peers = [str(p) for p in ae["peers"]]
        if "engine" in ae:
            cfg.anti_entropy.engine = str(ae["engine"])
        if "multi_peer" in ae:
            cfg.anti_entropy.multi_peer = bool(ae["multi_peer"])
        if "mode" in ae:
            cfg.anti_entropy.mode = str(ae["mode"])
        if "bisect_threshold" in ae:
            cfg.anti_entropy.bisect_threshold = int(ae["bisect_threshold"])
        if cfg.anti_entropy.mode not in ("auto", "bisect", "page"):
            raise ValueError(
                f"[anti_entropy] mode must be auto|bisect|page, "
                f"got {cfg.anti_entropy.mode!r}"
            )
        dev = raw.get("device", {})
        if "sharded_mirror" in dev:
            cfg.device.sharded_mirror = bool(dev["sharded_mirror"])
        if "sharding" in dev:
            # auto|off|N (TOML may carry the N as an integer or a string).
            cfg.device.sharding = str(dev["sharding"]).strip().lower()
        elif cfg.device.sharded_mirror:
            cfg.device.sharding = "auto"  # deprecated-alias promotion
        if cfg.device.sharding not in ("auto", "off"):
            try:
                n_shards = int(cfg.device.sharding)
            except ValueError:
                n_shards = -1
            if n_shards < 1 or n_shards & (n_shards - 1):
                raise ValueError(
                    "[device] sharding must be auto|off|power-of-two, got "
                    f"{cfg.device.sharding!r}"
                )
        if "max_staleness_ms" in dev:
            cfg.device.max_staleness_ms = float(dev["max_staleness_ms"])
        if "max_staleness_versions" in dev:
            cfg.device.max_staleness_versions = int(
                dev["max_staleness_versions"]
            )
        if cfg.device.max_staleness_ms <= 0:
            raise ValueError(
                "[device] max_staleness_ms must be > 0, got "
                f"{cfg.device.max_staleness_ms}"
            )
        if cfg.device.max_staleness_versions < 0:
            raise ValueError(
                "[device] max_staleness_versions must be >= 0 (0 = wall "
                f"window only), got {cfg.device.max_staleness_versions}"
            )
        if "dispatch_deadline_ms" in dev:
            cfg.device.dispatch_deadline_ms = float(
                dev["dispatch_deadline_ms"]
            )
        if cfg.device.dispatch_deadline_ms < 0:
            raise ValueError(
                "[device] dispatch_deadline_ms must be >= 0 (0 = "
                f"unbounded), got {cfg.device.dispatch_deadline_ms}"
            )
        if "degrade_after_failures" in dev:
            cfg.device.degrade_after_failures = int(
                dev["degrade_after_failures"]
            )
        if cfg.device.degrade_after_failures < 1:
            raise ValueError(
                "[device] degrade_after_failures must be >= 1, got "
                f"{cfg.device.degrade_after_failures}"
            )
        if "scrub_interval_s" in dev:
            cfg.device.scrub_interval_s = float(dev["scrub_interval_s"])
        if cfg.device.scrub_interval_s < 0:
            raise ValueError(
                "[device] scrub_interval_s must be >= 0 (0 = off), got "
                f"{cfg.device.scrub_interval_s}"
            )
        if "scrub_keys" in dev:
            cfg.device.scrub_keys = int(dev["scrub_keys"])
        if cfg.device.scrub_keys < 1:
            raise ValueError(
                "[device] scrub_keys must be >= 1, got "
                f"{cfg.device.scrub_keys}"
            )
        obs = raw.get("observability", {})
        if "http_port" in obs:
            cfg.observability.http_port = int(obs["http_port"])
        if "http_host" in obs:
            cfg.observability.http_host = str(obs["http_host"])
        if "trace_cycles" in obs:
            cfg.observability.trace_cycles = int(obs["trace_cycles"])
        if "trace_propagation" in obs:
            cfg.observability.trace_propagation = bool(
                obs["trace_propagation"]
            )
        if "trace_spans" in obs:
            cfg.observability.trace_spans = int(obs["trace_spans"])
        if "lag_ms_threshold" in obs:
            cfg.observability.lag_ms_threshold = float(
                obs["lag_ms_threshold"]
            )
        if "diverged_after_s" in obs:
            cfg.observability.diverged_after_s = float(
                obs["diverged_after_s"]
            )
        if "profile_dir" in obs:
            cfg.observability.profile_dir = str(obs["profile_dir"])
        if "flight_enabled" in obs:
            cfg.observability.flight_enabled = bool(obs["flight_enabled"])
        if "flight_dir" in obs:
            cfg.observability.flight_dir = str(obs["flight_dir"])
        if "flight_events" in obs:
            cfg.observability.flight_events = int(obs["flight_events"])
        if "flight_sample_s" in obs:
            cfg.observability.flight_sample_s = float(obs["flight_sample_s"])
        if "flight_spill_s" in obs:
            cfg.observability.flight_spill_s = float(obs["flight_spill_s"])
        if "slow_command_us" in obs:
            cfg.observability.slow_command_us = int(obs["slow_command_us"])
        if cfg.observability.flight_events < 16:
            raise ValueError(
                "[observability] flight_events must be >= 16, got "
                f"{cfg.observability.flight_events}"
            )
        if cfg.observability.flight_sample_s <= 0:
            raise ValueError(
                "[observability] flight_sample_s must be > 0, got "
                f"{cfg.observability.flight_sample_s}"
            )
        if cfg.observability.flight_spill_s <= 0:
            raise ValueError(
                "[observability] flight_spill_s must be > 0, got "
                f"{cfg.observability.flight_spill_s}"
            )
        if cfg.observability.slow_command_us < 0:
            raise ValueError(
                "[observability] slow_command_us must be >= 0 (0 = off), "
                f"got {cfg.observability.slow_command_us}"
            )
        if cfg.observability.lag_ms_threshold <= 0:
            raise ValueError(
                "[observability] lag_ms_threshold must be > 0, got "
                f"{cfg.observability.lag_ms_threshold}"
            )
        if cfg.observability.diverged_after_s <= 0:
            raise ValueError(
                "[observability] diverged_after_s must be > 0, got "
                f"{cfg.observability.diverged_after_s}"
            )
        if cfg.observability.http_port < -1:
            raise ValueError(
                "[observability] http_port must be -1 (ephemeral), 0 "
                f"(disabled), or a TCP port, got {cfg.observability.http_port}"
            )
        st = raw.get("storage", {})
        for k in ("enabled", "snapshot_on_shutdown"):
            if k in st:
                setattr(cfg.storage, k, bool(st[k]))
        for k in ("fsync", "verify", "merkle_engine"):
            if k in st:
                setattr(cfg.storage, k, str(st[k]))
        for k in (
            "segment_bytes",
            "compact_trigger_bytes",
            "snapshots_retained",
            "device_min_keys",
            "disk_free_soft_bytes",
            "disk_free_hard_bytes",
        ):
            if k in st:
                setattr(cfg.storage, k, int(st[k]))
        if (
            cfg.storage.disk_free_soft_bytes < 0
            or cfg.storage.disk_free_hard_bytes < 0
        ):
            raise ValueError("[storage] disk-free watermarks must be >= 0")
        if (
            cfg.storage.disk_free_soft_bytes
            and cfg.storage.disk_free_hard_bytes
            and cfg.storage.disk_free_soft_bytes
            < cfg.storage.disk_free_hard_bytes
        ):
            raise ValueError(
                "[storage] disk_free_soft_bytes must be >= "
                "disk_free_hard_bytes (soft is the earlier warning), got "
                f"{cfg.storage.disk_free_soft_bytes} < "
                f"{cfg.storage.disk_free_hard_bytes}"
            )
        if "fsync_interval_seconds" in st:
            cfg.storage.fsync_interval_seconds = float(
                st["fsync_interval_seconds"]
            )
        if cfg.storage.fsync not in ("always", "interval", "never"):
            raise ValueError(
                f"[storage] fsync must be always|interval|never, "
                f"got {cfg.storage.fsync!r}"
            )
        if cfg.storage.verify not in ("repair", "strict"):
            raise ValueError(
                f"[storage] verify must be repair|strict, "
                f"got {cfg.storage.verify!r}"
            )
        if cfg.storage.merkle_engine not in ("auto", "cpu", "tpu"):
            raise ValueError(
                f"[storage] merkle_engine must be auto|cpu|tpu, "
                f"got {cfg.storage.merkle_engine!r}"
            )
        boot = raw.get("bootstrap", {})
        if "enabled" in boot:
            cfg.bootstrap.enabled = bool(boot["enabled"])
        if "chunk_bytes" in boot:
            cfg.bootstrap.chunk_bytes = int(boot["chunk_bytes"])
        if "chunk_retries" in boot:
            cfg.bootstrap.chunk_retries = int(boot["chunk_retries"])
        if not 4096 <= cfg.bootstrap.chunk_bytes <= 262144:
            raise ValueError(
                "[bootstrap] chunk_bytes must be in [4096, 262144], got "
                f"{cfg.bootstrap.chunk_bytes}"
            )
        if cfg.bootstrap.chunk_retries < 1:
            raise ValueError(
                "[bootstrap] chunk_retries must be >= 1, got "
                f"{cfg.bootstrap.chunk_retries}"
            )
        cl = raw.get("cluster", {})
        if "partitions" in cl:
            cfg.cluster.partitions = int(cl["partitions"])
        if "partition_id" in cl:
            cfg.cluster.partition_id = int(cl["partition_id"])
        if "partition_map" in cl:
            cfg.cluster.partition_map = str(cl["partition_map"])
        if "map_epoch" in cl:
            cfg.cluster.map_epoch = int(cl["map_epoch"])
        if cfg.cluster.partitions < 0:
            raise ValueError(
                "[cluster] partitions must be >= 0 (0 = unpartitioned), "
                f"got {cfg.cluster.partitions}"
            )
        if cfg.cluster.partitions > 0:
            if not 0 <= cfg.cluster.partition_id < cfg.cluster.partitions:
                raise ValueError(
                    "[cluster] partition_id must be in "
                    f"[0, {cfg.cluster.partitions}), got "
                    f"{cfg.cluster.partition_id}"
                )
            if cfg.cluster.map_epoch < 1:
                raise ValueError(
                    "[cluster] map_epoch must be >= 1, got "
                    f"{cfg.cluster.map_epoch}"
                )
            if not cfg.cluster.partition_map:
                raise ValueError(
                    "[cluster] partition_map is required when partitions "
                    "> 0 (the node serves it via PARTMAP and derives its "
                    "sibling peers from it)"
                )
            # Full validation (coverage, addresses) via the one parser
            # every routing consumer shares.
            from merklekv_tpu_torch.cluster.partmap import parse_map_spec

            parse_map_spec(
                cfg.cluster.partition_map,
                cfg.cluster.partitions,
                cfg.cluster.map_epoch,
            )
        cfg.replication.resolve_env()
        return cfg


def load_or_default(path: Optional[str]) -> Config:
    if path:
        return Config.load(path)
    cfg = Config()
    cfg.replication.resolve_env()
    return cfg
