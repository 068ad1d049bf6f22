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
it); :func:`main` is ``start`` plus the readiness line and the signal wait.

Subcommands: ``trace`` is the JAX package's (``obs/tracewire.py``).
``walcheck``, ``top``, ``blackbox``, ``router`` and ``rebalance`` raise
``NotImplementedError`` naming their ROADMAP item, as do ``--durable``,
``[storage] enabled``, ``[cluster] partitions > 0``, ``[bootstrap]
enabled``, ``[device] sharding != "off"`` and ``MKV_COORDINATOR``
(``unported.py``).
"""

from __future__ import annotations

import argparse
import signal
import sys
import time
from dataclasses import dataclass
from typing import Optional

__all__ = ["RunningNode", "parse_config", "start", "main"]


@dataclass
class RunningNode:
    """One node started by :func:`start`: its config, native engine and
    server, and the cluster node wired to them."""

    cfg: object  # config.Config
    engine: object  # native_bindings.NativeEngine
    server: object  # native_bindings.NativeServer
    node: object  # cluster.node.ClusterNode

    @property
    def port(self) -> int:
        return self.server.port

    def close(self) -> None:
        """Stop the node, then the server, then the engine (the mirror reads
        through the engine's raw pointer, so it goes first)."""
        self.node.stop()
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
        help="enable the [storage] WAL+snapshot subsystem (not in the torch "
             "port yet: refused)",
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
    """Build and start one node for ``cfg``: refuse what the port does not
    have, then the native engine and server, then the cluster node (whose
    construction resolves the device, and so fails here without a GPU)."""
    from merklekv_tpu_torch.cluster.node import ClusterNode
    from merklekv_tpu_torch.native_bindings import NativeEngine, NativeServer
    from merklekv_tpu_torch.unported import refuse_config
    from merklekv_tpu_torch.version import __version__

    refuse_config(cfg)
    engine = NativeEngine(cfg.engine, cfg.storage_path)
    server: Optional[NativeServer] = None
    try:
        server = NativeServer(
            engine, cfg.host, cfg.port, version=__version__,
            exit_on_shutdown=False, io_threads=cfg.server.io_threads,
            reuseport=cfg.server.reuseport, zero_copy=cfg.server.zero_copy,
            max_line=cfg.server.max_line_bytes,
        )
        server.start()
        # Always wire the cluster control plane: the SYNC command must work
        # on a bare node (reference parity — SyncManager is unconditional,
        # server.rs:388-390); replication/anti-entropy loops only start
        # when enabled in config.
        node = ClusterNode(cfg, engine, server)
        node.start()
    except BaseException:
        if server is not None:
            server.close()
        engine.close()
        raise
    return RunningNode(cfg, engine, server, node)


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "trace":
        # Cross-node causal-trace assembly: TRACEDUMP from every node,
        # stitched into one Perfetto-loadable Chrome trace
        # (docs/OBSERVABILITY.md "Causal tracing").
        from merklekv_tpu_torch.obs.tracewire import main as trace_main

        return trace_main(argv[1:])
    from merklekv_tpu_torch.unported import SUBCOMMANDS, refuse

    if argv and argv[0] in SUBCOMMANDS:
        refuse(argv[0])

    cfg = parse_config(argv)
    run = start(cfg)
    # Readiness line LAST: spawning harnesses treat it as "fully up",
    # including the replication subscription (QoS-0 — a publish before the
    # peer subscribes is lost until anti-entropy repairs it).
    print(
        f"merklekv_tpu_torch listening on {cfg.host}:{run.port} "
        f"(engine={cfg.engine})",
        flush=True,
    )
    if run.node.metrics_port is not None:
        # After the readiness line, same rule: harnesses parse this to find
        # an ephemeral metrics port.
        print(f"metrics: http://{cfg.observability.http_host}:"
              f"{run.node.metrics_port}/metrics", flush=True)

    stop = {"flag": False}

    def on_signal(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)

    try:
        while not stop["flag"] and not run.server.stopping:
            time.sleep(0.1)
    finally:
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
