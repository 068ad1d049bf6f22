"""Peer failure detection: periodic PING probes + per-peer health table.

A copy of ``merklekv_tpu/cluster/health.py``, its imports pointed at the port's modules.

The reference has no peer health at all — a down peer is discovered only
when a sync attempt times out (SURVEY §5.3: "no peer health checks, no
membership"). Here a background monitor probes every configured peer with a
short-timeout PING, tracks (status, consecutive failures, last-ok time,
round-trip), feeds the metrics registry, and lets the anti-entropy loop
skip known-down peers instead of burning a full connect timeout per cycle.
Surfaced over the wire as the extension verb ``PEERS`` (docs/PROTOCOL.md).
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass
from typing import Optional

from merklekv_tpu_torch.cluster.retry import HEALTH_PROBE, RetryPolicy
from merklekv_tpu_torch.utils.tracing import get_metrics

__all__ = ["PeerHealth", "PeerHealthMonitor"]


@dataclass
class PeerHealth:
    peer: str  # "host:port"
    # "unknown" until the first probe lands; "down" only after down_after
    # consecutive failures; "degraded" when the peer answers probes but a
    # sync/replication operation against it died mid-flight (reported via
    # mark_degraded); one probe success flips degraded/down back to "up".
    status: str = "unknown"
    consecutive_failures: int = 0
    last_ok_unix: float = 0.0
    last_probe_unix: float = 0.0
    rtt_ms: float = -1.0
    probes: int = 0
    last_error: str = ""  # most recent degradation reason, "" when healthy


class PeerHealthMonitor:
    """Background PING prober over the cluster's peer list.

    Probe cadence/timeout/threshold derive from the shared HEALTH_PROBE
    policy (cluster/retry.py); explicit constructor arguments still win.
    """

    def __init__(
        self,
        peers: list[str],
        interval_seconds: Optional[float] = None,
        timeout: Optional[float] = None,
        down_after: Optional[int] = None,
        policy: Optional[RetryPolicy] = None,
    ) -> None:
        policy = policy if policy is not None else HEALTH_PROBE
        self._interval = (
            interval_seconds if interval_seconds is not None
            else policy.first_delay
        )
        self._timeout = timeout if timeout is not None else policy.op_timeout
        self._down_after = (
            down_after if down_after is not None else (policy.attempts or 2)
        )
        self._mu = threading.Lock()
        self._health: dict[str, PeerHealth] = {
            p: PeerHealth(peer=p) for p in peers
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="mkv-peer-health"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- probing -------------------------------------------------------------
    def probe_all(self) -> None:
        """One synchronous probe round (the loop body; tests call directly)."""
        with self._mu:
            peers = list(self._health)
        for peer in peers:
            ok, rtt = self._probe(peer)
            self._record(peer, ok, rtt)

    def _probe(self, peer: str) -> tuple[bool, float]:
        host, _, port = peer.rpartition(":")
        t0 = time.perf_counter()
        try:
            with socket.create_connection(
                (host, int(port)), timeout=self._timeout
            ) as sock:
                sock.settimeout(self._timeout)
                sock.sendall(b"PING health\r\n")
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = sock.recv(256)
                    if not chunk:
                        return False, -1.0
                    buf += chunk
                if not buf.startswith(b"PONG"):
                    return False, -1.0
        except (OSError, ValueError):
            return False, -1.0
        return True, (time.perf_counter() - t0) * 1e3

    def _record(self, peer: str, ok: bool, rtt_ms: float) -> None:
        now = time.time()
        flip = None  # (prev, new) outside the lock
        with self._mu:
            h = self._health.get(peer)
            if h is None:
                return
            h.probes += 1
            h.last_probe_unix = now
            if ok:
                if h.status == "down":
                    get_metrics().inc("health.peer_recoveries")
                if h.status not in ("up", "unknown"):
                    flip = (h.status, "up")
                h.status = "up"
                h.consecutive_failures = 0
                h.last_ok_unix = now
                h.rtt_ms = rtt_ms
                h.last_error = ""
            else:
                h.consecutive_failures += 1
                if (
                    h.consecutive_failures >= self._down_after
                    and h.status != "down"
                ):
                    flip = (h.status, "down")
                    h.status = "down"
                    get_metrics().inc("health.peer_failures")
        if flip is not None:
            # Flight recorder: peer state FLIPS only (the steady state is
            # noise; transitions are the timeline).
            from merklekv_tpu_torch.obs.flightrec import record

            record("peer_health", peer=peer, prev=flip[0], new=flip[1])

    def _run(self) -> None:
        # First round immediately so the table is useful right away.
        while True:
            try:
                self.probe_all()
            except Exception:
                get_metrics().inc("health.probe_errors")
            if self._stop.wait(self._interval):
                return

    # -- external failure reports --------------------------------------------
    def mark_degraded(self, peer: str, reason: str = "") -> None:
        """A component saw ``peer`` fail mid-operation (sync stream died,
        injected fault, repair deadline expired) even though probes may
        still succeed. The table shows it, metrics count it, and the next
        successful probe clears it. Peers not in the configured list are
        added so ad-hoc sync targets surface too."""
        flipped_from = None
        with self._mu:
            h = self._health.get(peer)
            if h is None:
                h = self._health[peer] = PeerHealth(peer=peer)
            h.last_error = reason
            if h.status != "down":
                if h.status != "degraded":
                    flipped_from = h.status
                h.status = "degraded"
        get_metrics().inc("health.peer_degradations")
        if flipped_from is not None:
            from merklekv_tpu_torch.obs.flightrec import record

            record("peer_health", peer=peer, prev=flipped_from,
                   new="degraded", reason=reason)

    # -- queries -------------------------------------------------------------
    def is_up(self, peer: str) -> bool:
        """False only for peers confirmed down; unknown/unconfigured peers
        answer True so nothing is skipped on startup."""
        with self._mu:
            h = self._health.get(peer)
            return h is None or h.status != "down"

    def snapshot(self) -> list[PeerHealth]:
        with self._mu:
            return [PeerHealth(**vars(h)) for h in self._health.values()]

    def wire_table(self) -> str:
        """The PEERS response body (extension verb)."""
        rows = self.snapshot()
        out = f"PEERS {len(rows)}\r\n"
        for h in rows:
            out += (
                f"addr={h.peer} status={h.status} "
                f"failures={h.consecutive_failures} "
                f"rtt_ms={h.rtt_ms:.2f} last_ok={int(h.last_ok_unix)}"
            )
            if h.last_error:
                # k=v fields are space-separated on the wire; the free-text
                # reason is squeezed so it stays one field.
                out += f" error={h.last_error.replace(' ', '_')[:80]}"
            out += "\r\n"
        out += "END\r\n"
        return out
