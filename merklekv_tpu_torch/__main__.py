"""CLI entry point: `python -m merklekv_tpu_torch [--config X] [--engine E] ...`.

Port of ``merklekv_tpu/__main__.py`` with the same flags and config files.
Starts the native TCP server on a native engine and wires the cluster
control plane (replication, the serving mirror on the node's device,
anti-entropy) in this process, then prints

    merklekv_tpu_torch listening on <host>:<port> (engine=<engine>)

and serves until SIGINT/SIGTERM, when it stops cleanly and exits 0.

The device is ``MERKLEKV_TORCH_DEVICE`` (unset means CUDA; ``cpu`` runs the
plain PyTorch versions on the host). A node whose ``[anti_entropy] engine``
is not ``"cpu"`` fails at start without a GPU unless that variable says
``cpu``.

:func:`start` builds and starts one node in-process and returns a
:class:`RunningNode` (the tests and ``chip_smoke.py`` drive nodes through
it); :func:`main` is ``start`` plus the readiness line (then, on a durable
node, ``storage: recovered ...``) and the signal wait.

``--durable`` or ``[storage] enabled`` adds the durable store
(``storage/``: WAL, snapshots stamped with a root computed on the node's
device, verified recovery) under ``<storage_path>/node-<port>``; recovery
finishes before the listening socket exists on a fixed port, and before the
readiness line on port 0. ``MKV_COORDINATOR`` (with ``MKV_NUM_PROCESSES``
and ``MKV_PROCESS_ID``) joins the ``torch.distributed`` group of
``parallel/multihost.py`` before the first device touch; the node's mirror
stays on this process's own devices.

Partitioned mode (``[cluster] partitions > 0``: ``cluster/partmap.py``, live
rebalancing in ``cluster/rebalance.py``) and snapshot bootstrap
(``[bootstrap] enabled``: ``cluster/bootstrap.py``) run as in the JAX node;
their roots are hashed on the node's device by its ``[storage]
merkle_engine``.

Subcommands, the JAX package's: ``trace`` (``obs/tracewire.py``),
``walcheck`` (``storage/walcheck.py``), ``top`` (``obs/top.py``),
``blackbox`` (``obs/blackbox.py``), ``router`` (``requestplane/router.py``,
whose ``--legacy-threads`` runs ``cluster/router.py``) and ``rebalance``
(``cluster/rebalance.py``).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from dataclasses import dataclass
from typing import Optional

__all__ = ["RunningNode", "parse_config", "start", "main"]


@dataclass
class RunningNode:
    """One node started by :func:`start`: its config, native engine and
    server, the cluster node wired to them, and the durable store with its
    recovery report (both ``None`` without ``[storage] enabled``)."""

    cfg: object  # config.Config
    engine: object  # native_bindings.NativeEngine
    server: object  # native_bindings.NativeServer
    node: object  # cluster.node.ClusterNode
    storage: object = None  # storage.DurableStore
    recovery: object = None  # storage.RecoveryReport

    @property
    def port(self) -> int:
        return self.server.port

    def close(self) -> None:
        """Stop the node, then the store (its final drain and shutdown
        snapshot still read through the live server and engine), then the
        server, then the engine (the mirror reads through the engine's raw
        pointer, so it goes before)."""
        self.node.stop()
        if self.storage is not None:
            self.storage.stop()
        self.server.close()
        self.engine.sync()
        self.engine.close()


def parse_config(argv: list[str]):
    """The node's ``Config`` from the command line (``--config`` file plus
    flag overrides)."""
    p = argparse.ArgumentParser(prog="merklekv_tpu_torch")
    p.add_argument("--config", help="TOML config file")
    p.add_argument("--engine", help="storage engine: mem|rwlock|kv|log|sled")
    p.add_argument("--storage-path", help="data dir for durable storage")
    p.add_argument("--host")
    p.add_argument("--port", type=int)
    p.add_argument(
        "--durable",
        action="store_true",
        help="enable the [storage] WAL+snapshot subsystem",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        help="serve Prometheus /metrics (+/healthz) on this HTTP port "
             "(-1: ephemeral; overrides [observability] http_port)",
    )
    args = p.parse_args(argv)

    from merklekv_tpu_torch.config import load_or_default

    cfg = load_or_default(args.config)
    if args.engine:
        cfg.engine = args.engine
    if args.storage_path:
        cfg.storage_path = args.storage_path
    if args.host:
        cfg.host = args.host
    if args.port is not None:
        cfg.port = args.port
    if args.durable:
        cfg.storage.enabled = True
    if args.metrics_port is not None:
        if args.metrics_port < -1:
            # Same rule the [observability] config-file path enforces.
            p.error(f"--metrics-port must be -1 (ephemeral), 0 (disabled), "
                    f"or a TCP port, got {args.metrics_port}")
        cfg.observability.http_port = args.metrics_port
    return cfg


def start(cfg) -> RunningNode:
    """Build and start one node for ``cfg``: join the process group when
    ``MKV_COORDINATOR`` is set, then the native engine, the durable store's recovery (``[storage] enabled``),
    the server, and the cluster node (whose construction resolves the
    device, and so fails here without a GPU)."""
    from merklekv_tpu_torch.cluster.node import ClusterNode
    from merklekv_tpu_torch.native_bindings import NativeEngine, NativeServer
    from merklekv_tpu_torch.version import __version__

    if os.environ.get("MKV_COORDINATOR"):
        # Before any device touch (docs/DEPLOYMENT.md "Multi-host").
        from merklekv_tpu_torch.parallel import multihost

        multihost.initialize()
    engine = NativeEngine(cfg.engine, cfg.storage_path)
    server: Optional[NativeServer] = None
    storage = recovery = None
    try:
        # Durable subsystem. The data dir is per-port (node_data_dir); on a
        # FIXED port it is known up front, so recovery completes before the
        # listening socket even exists.
        if cfg.storage.enabled:
            from merklekv_tpu_torch.storage import DurableStore, node_data_dir

            if cfg.port != 0:
                storage = DurableStore(
                    engine, cfg.storage, node_data_dir(cfg.storage_path, cfg.port)
                )
                recovery = storage.recover()
        server = NativeServer(
            engine, cfg.host, cfg.port, version=__version__,
            exit_on_shutdown=False, io_threads=cfg.server.io_threads,
            reuseport=cfg.server.reuseport, zero_copy=cfg.server.zero_copy,
            max_line=cfg.server.max_line_bytes,
        )
        if cfg.storage.enabled:
            # BEFORE start(): stage change events from the very first
            # accepted command, so no write bypasses the WAL.
            server.enable_events(True)
        server.start()
        if cfg.storage.enabled:
            if storage is None:
                # port 0: the dir derives from the just-bound port;
                # recovery still finishes before the readiness line.
                storage = DurableStore(
                    engine, cfg.storage, node_data_dir(cfg.storage_path, server.port)
                )
                recovery = storage.recover()
            storage.start()
        # Always wire the cluster control plane: the SYNC command must work
        # on a bare node (reference parity — SyncManager is unconditional,
        # server.rs:388-390); replication/anti-entropy loops only start
        # when enabled in config.
        node = ClusterNode(cfg, engine, server, storage=storage)
        node.start()
    except BaseException:
        if storage is not None:
            storage.stop()
        if server is not None:
            server.close()
        engine.close()
        raise
    return RunningNode(cfg, engine, server, node, storage, recovery)


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "trace":
        # Cross-node causal-trace assembly: TRACEDUMP from every node,
        # stitched into one Perfetto-loadable Chrome trace
        # (docs/OBSERVABILITY.md "Causal tracing").
        from merklekv_tpu_torch.obs.tracewire import main as trace_main

        return trace_main(argv[1:])
    if argv and argv[0] == "walcheck":
        # Offline tool: verify WAL frames + snapshot root stamps without a
        # server (docs/PERSISTENCE.md "Verification").
        from merklekv_tpu_torch.storage.walcheck import main as walcheck_main

        return walcheck_main(argv[1:])
    if argv and argv[0] == "top":
        # Live cluster dashboard: polls STATS/METRICS/PEERS over a node
        # list and renders rates (docs/OBSERVABILITY.md "top").
        from merklekv_tpu_torch.obs.top import main as top_main

        return top_main(argv[1:])
    if argv and argv[0] == "blackbox":
        # Offline post-mortem: merge flight-recorder spills from one or
        # more nodes into an ordered cluster timeline + anomaly report
        # (docs/OBSERVABILITY.md "Post-mortem forensics").
        from merklekv_tpu_torch.obs.blackbox import main as blackbox_main

        return blackbox_main(argv[1:])
    if argv and argv[0] == "router":
        # Request plane: one address dumb clients can point at in a
        # partitioned cluster (docs/PROTOCOL.md "Router semantics");
        # --legacy-threads runs the thread-per-connection thin router.
        from merklekv_tpu_torch.requestplane.router import main as router_main

        return router_main(argv[1:])
    if argv and argv[0] == "rebalance":
        # Live partition rebalancing: drive an online split (epoch E+1)
        # against the serving cluster (docs/DEPLOYMENT.md "Online
        # rebalancing").
        from merklekv_tpu_torch.cluster.rebalance import main as rebalance_main

        return rebalance_main(argv[1:])
    cfg = parse_config(argv)
    run = start(cfg)
    stop = {"flag": False}

    def on_signal(signum, frame):
        stop["flag"] = True

    # Before the readiness line: a harness may signal as soon as it has
    # read it, and a SIGTERM must then reach the handler (exit 0 after the
    # shutdown snapshot), not the default action.
    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    # Readiness line LAST: spawning harnesses treat it as "fully up",
    # including the replication subscription (QoS-0 — a publish before the
    # peer subscribes is lost until anti-entropy repairs it).
    print(
        f"merklekv_tpu_torch listening on {cfg.host}:{run.port} "
        f"(engine={cfg.engine})",
        flush=True,
    )
    if run.storage is not None:
        # After the readiness line — spawning harnesses parse line 1 only.
        print(f"storage: recovered {run.recovery.summary()}", flush=True)
    if run.node.metrics_port is not None:
        # After the readiness line, same rule: harnesses parse this to find
        # an ephemeral metrics port.
        print(f"metrics: http://{cfg.observability.http_host}:"
              f"{run.node.metrics_port}/metrics", flush=True)

    try:
        while not stop["flag"] and not run.server.stopping:
            time.sleep(0.1)
    finally:
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
