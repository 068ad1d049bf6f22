"""Pub/sub event fabric behind a small Transport interface.

A copy of ``merklekv_tpu/cluster/transport.py``, its imports pointed at the port's modules.

The reference replicates through an external MQTT broker over rumqttc
(replication.rs:115-143, topics "{prefix}/events"). This environment has no
egress and no broker, so the fabric is pluggable:

- ``InProcessBus`` — loopback fan-out inside one process (unit tests, and
  multi-node-in-one-process topologies like the integration suite's).
- ``TcpBroker`` + ``TcpTransport`` — a minimal self-hosted broker speaking
  length-framed (topic, payload) messages over TCP, QoS-0 fan-out to every
  connected client (MQTT-like enough for LWW replication, which tolerates
  loss by design — anti-entropy repairs). One broker serves a whole
  single-host cluster; multi-host works the same over DCN.

Delivery is at-most-once per connection; the replication layer's op_id
dedupe + LWW make redelivery and reordering safe either way.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque

from merklekv_tpu_torch.cluster.retry import TRANSPORT_HEAL, RetryPolicy
from merklekv_tpu_torch.utils.tracing import get_metrics
from typing import Callable, Optional, Protocol

__all__ = ["Transport", "InProcessBus", "TcpBroker", "TcpTransport"]

Callback = Callable[[str, bytes], None]


class Transport(Protocol):
    def publish(self, topic: str, payload: bytes) -> None: ...
    def subscribe(self, topic_prefix: str, callback: Callback) -> None: ...
    def unsubscribe(self, callback: Callback) -> None: ...
    def close(self) -> None: ...


# ------------------------------------------------------------- in-process

class InProcessBus:
    """Fan-out bus inside one process. Delivery happens on a dispatcher
    thread, so publishers never run subscriber callbacks inline."""

    def __init__(self) -> None:
        self._subs: list[tuple[str, Callback]] = []
        self._mu = threading.Lock()
        self._q: list[tuple[str, bytes]] = []
        self._cv = threading.Condition(self._mu)
        self._closed = False
        self.callback_errors = 0
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    def publish(self, topic: str, payload: bytes) -> None:
        with self._cv:
            if self._closed:
                return
            self._q.append((topic, payload))
            self._cv.notify()

    def subscribe(self, topic_prefix: str, callback: Callback) -> None:
        with self._mu:
            self._subs.append((topic_prefix, callback))

    def unsubscribe(self, callback: Callback) -> None:
        with self._mu:
            self._subs = [(p, c) for p, c in self._subs if c is not callback]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=2)

    def _dispatch(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if self._closed and not self._q:
                    return
                topic, payload = self._q.pop(0)
                subs = list(self._subs)
            for prefix, cb in subs:
                if topic.startswith(prefix):
                    try:
                        cb(topic, payload)
                    except Exception:
                        # Subscriber errors must not kill the bus, but a
                        # silently-eaten event is an invisible delivery gap —
                        # count it so tests/operators can see the drop.
                        self.callback_errors += 1


# ------------------------------------------------------------- TCP broker

def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


# Frames above this are rejected before any allocation: the header's 4-byte
# total is peer-controlled and must not size a buffer unchecked.
MAX_FRAME = 16 << 20

# Socket buffer sizing for every fabric socket (broker and clients). The
# kernel default (~208 KiB) holds only ~4K single-event frames; a
# replication burst that outruns the fan-out for a moment fills it, and a
# full receive buffer degrades loopback TCP into a persist-timer
# stop-and-go (~10 frames/s observed on a 4.x kernel) that outlives the
# burst by minutes. 4 MiB absorbs ~10^5 in-flight events, which keeps even
# the per-event compat mode (batch_max_events <= 1) out of that regime;
# the kernel silently caps the request where limits are lower.
SOCK_BUF_BYTES = 1 << 22


def _enlarge_sock_buffers(sock: socket.socket) -> None:
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, SOCK_BUF_BYTES)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, SOCK_BUF_BYTES)
    except OSError:
        pass  # best effort: a capped buffer only lowers the burst ceiling


def _read_frame(sock: socket.socket) -> Optional[tuple[str, bytes]]:
    head = _read_exact(sock, 6)
    if head is None:
        return None
    total, tlen = struct.unpack("<IH", head)
    if tlen > total or total > MAX_FRAME:
        return None
    body = _read_exact(sock, total)
    if body is None:
        return None
    return body[:tlen].decode("utf-8"), body[tlen:]


def _frame(topic: str, payload: bytes) -> bytes:
    t = topic.encode("utf-8")
    return struct.pack("<IH", len(t) + len(payload), len(t)) + t + payload


class TcpBroker:
    """Self-hosted fan-out broker: every frame from any client goes to every
    connected client (including the sender — src-based loop prevention is the
    subscriber's job, as with MQTT)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # Before listen(): accepted sockets inherit the enlarged buffers.
        _enlarge_sock_buffers(self._listener)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()
        # cid -> (socket, per-socket send lock): concurrent publishers must
        # not interleave partial sendall()s on one subscriber's stream.
        self._clients: dict[int, tuple[socket.socket, threading.Lock]] = {}
        self._next_id = 0
        self._mu = threading.Lock()
        self._closed = False
        self._accept_thread = threading.Thread(target=self._accept, daemon=True)
        self._accept_thread.start()

    def _accept(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._mu:
                cid = self._next_id
                self._next_id += 1
                self._clients[cid] = (sock, threading.Lock())
            threading.Thread(
                target=self._serve, args=(cid, sock), daemon=True
            ).start()

    def _serve(self, cid: int, sock: socket.socket) -> None:
        while True:
            frame = _read_frame(sock)
            if frame is None:
                break
            data = _frame(*frame)
            with self._mu:
                targets = list(self._clients.items())
            for tid, (tsock, tlock) in targets:
                try:
                    with tlock:
                        tsock.sendall(data)
                except OSError:
                    self._drop(tid)
        self._drop(cid)

    def _drop(self, cid: int) -> None:
        with self._mu:
            entry = self._clients.pop(cid, None)
        if entry is not None:
            try:
                entry[0].close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            # shutdown BEFORE close: the accept thread is blocked inside
            # accept() and holds the kernel socket alive — a bare close()
            # leaves the port in LISTEN until that syscall returns (i.e.
            # forever), so a restarted broker can never rebind it.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._mu:
            entries = list(self._clients.values())
            self._clients.clear()
        for s, _lk in entries:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


# Events published while the broker link is down wait here (per-transport
# bounded FIFO) and flush after healing — without this every write during
# an outage is silently gone and only anti-entropy ever repairs it. The
# bound keeps a long outage from eating the heap; overflow drops the
# OLDEST event (LWW: newer state supersedes older) and counts the drop.
OUTBOX_LIMIT = 8192


def _enable_tcp_keepalive(sock: socket.socket) -> None:
    """Kernel keepalive probes: a subscriber-only client never writes, so
    without these a silent partition (power loss, NAT drop — no RST) blocks
    recv forever and reconnect never triggers. ~15s idle + 3 x 5s probes
    bounds deafness to ~30s."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPIDLE, 15)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPINTVL, 5)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPCNT, 3)
    except (OSError, AttributeError):
        pass  # non-Linux: base SO_KEEPALIVE still applies


def _enqueue_outbox(t, topic: str, payload: bytes) -> None:
    with t._outbox_mu:
        if len(t._outbox) >= OUTBOX_LIMIT:
            t._outbox.popleft()
            t.outbox_dropped += 1
            get_metrics().inc("transport.outbox_dropped")
        t._outbox.append((topic, payload))


def _publish_or_queue(t, topic: str, payload: bytes) -> None:
    """Transport publish body: enqueue during a KNOWN outage (the reader
    flagged the link down), otherwise attempt the wire and enqueue on
    failure. An in-flight send that the kernel buffered just before an
    undetected death can still be lost — bounding that window needs
    broker acks, which is the one QoS-1 piece deliberately not taken on
    (anti-entropy repairs the residue; see the replicator docstring).

    Deliberate post-heal ordering relaxation: a publish issued while the
    outbox is still draining goes straight to the wire and can OVERTAKE
    queued pre-outage events. Receivers apply per-key LWW (ts + digest
    tiebreak), so the overtaken stale event can never clobber newer state;
    routing live publishes through the outbox until empty would instead
    stall the write path behind the whole backlog. Documented in
    docs/PROTOCOL.md ("Post-heal publish ordering")."""
    if t.link_down:
        _enqueue_outbox(t, topic, payload)
        # Enqueue/heal race: if the heal finished (and drained) between the
        # flag read and the append, nothing would ever flush this event —
        # drain opportunistically now that the link is back.
        if not t.link_down:
            _drain_outbox(t)
        return
    try:
        t._wire_send(topic, payload)
    except OSError:
        _enqueue_outbox(t, topic, payload)
        if not t.link_down:
            _drain_outbox(t)


def _drain_outbox(t) -> None:
    """Flush queued events through the healed link, FIFO. Stops (and
    re-queues the event in flight) if the link dies again mid-drain."""
    while True:
        with t._outbox_mu:
            if not t._outbox:
                return
            topic, payload = t._outbox.popleft()
        try:
            t._wire_send(topic, payload)
        except OSError:
            with t._outbox_mu:
                t._outbox.appendleft((topic, payload))
            return


def _heal_policy(t) -> RetryPolicy:
    """The transport's heal backoff as a RetryPolicy. Tests pin instance
    ``_BACKOFF_FIRST``/``_BACKOFF_MAX`` to stagger heal races — those
    legacy knobs keep winning over the shared policy's endpoints."""
    policy = getattr(t, "_policy", TRANSPORT_HEAL)
    return policy.with_overrides(
        first_delay=t._BACKOFF_FIRST, max_delay=t._BACKOFF_MAX
    )


def _dead_socket() -> socket.socket:
    """Placeholder for a link that is down from birth (broker not up yet):
    already closed, so the reader's first recv fails straight into the
    heal loop instead of blocking."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.close()
    return sock


def _heal_link(t, dial, on_connected=None) -> bool:
    """Shared reconnect engine for broker-client transports.

    ``t`` exposes ``_closed``, ``_send_mu``, ``_sock``, ``reconnects``, and
    a backoff policy (``_heal_policy``); ``dial()`` returns a fresh
    connected socket or raises OSError; ``on_connected`` runs after the
    swap (e.g. MQTT resubscribe). Returns False when ``close()`` ended the
    transport.
    """
    t.link_down = True
    policy = _heal_policy(t)
    attempt = 0
    while not t._closed:
        time.sleep(policy.backoff(attempt, getattr(t, "_heal_rng", None)))
        attempt += 1
        if t._closed:
            return False
        try:
            sock = dial()
        except OSError:
            continue
        # Unblock any publisher stuck in sendall() on the dead socket
        # BEFORE taking _send_mu: without a send timeout that sendall only
        # errors at the kernel's retransmission limit (~15-30 min), and it
        # HOLDS _send_mu — the swap would stall healing for that long.
        try:
            t._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        with t._send_mu:
            if t._closed:
                # close() ran while we were dialing: the old socket is
                # already shut down; do not leak the fresh one.
                sock.close()
                return False
            old = t._sock
            t._sock = sock
        try:
            old.close()
        except OSError:
            pass
        t.link_down = False
        t.reconnects += 1
        get_metrics().inc("transport.reconnects")
        if on_connected is not None:
            on_connected()
        return True
    return False


class TcpTransport:
    """Client for TcpBroker implementing the Transport interface.

    Self-healing: when the broker link drops (broker restart, network
    blip), the reader reconnects with capped exponential backoff and the
    fabric resumes — the reference's rumqttc event loop does the same
    (the reference's src/replication.rs:148-166). Events published during
    a detected outage wait in a bounded outbox and flush after the heal
    (only the narrow undetected-death window is lossy; anti-entropy
    repairs that residue). ``reconnects`` / ``outbox_dropped`` count the
    healed outages and overflow drops for observability.

    A broker that is down at CONSTRUCTION time is the same outage one
    second early: the transport starts with ``link_down=True``, queues
    publishes in the outbox, and the reader's heal loop dials with the
    same backoff — so nodes and broker can start in any order."""

    # Heal backoff (shared cluster policy, cluster/retry.py). The legacy
    # _BACKOFF_FIRST/_BACKOFF_MAX knobs derive from it and remain the
    # per-instance override hook tests use to stagger heal races.
    _policy = TRANSPORT_HEAL
    _BACKOFF_FIRST = TRANSPORT_HEAL.first_delay
    _BACKOFF_MAX = TRANSPORT_HEAL.max_delay

    def __init__(self, host: str, port: int, timeout: float = 5.0) -> None:
        self._host, self._port, self._timeout = host, port, timeout
        self._subs: list[tuple[str, Callback]] = []
        self._mu = threading.Lock()
        self._send_mu = threading.Lock()
        self._closed = False
        self.callback_errors = 0
        self.reconnects = 0
        self._outbox: deque[tuple[str, bytes]] = deque()
        self._outbox_mu = threading.Lock()
        self.outbox_dropped = 0
        self.link_down = False
        try:
            self._sock = self._connect()
        except OSError:
            # Broker not up yet: start degraded and let the reader's heal
            # loop keep dialing — startup ordering is not a requirement.
            get_metrics().inc("transport.start_degraded")
            self._sock = _dead_socket()
            self.link_down = True
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        )
        if sock.getsockname() == sock.getpeername():
            # TCP self-connect: dialing a broker port in the ephemeral range
            # while it is down can simultaneous-connect to ITSELF — the
            # socket then squats the port and blocks the broker's rebind.
            sock.close()
            raise ConnectionRefusedError("self-connect (broker down)")
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _enlarge_sock_buffers(sock)
        _enable_tcp_keepalive(sock)
        return sock

    def _reconnect(self) -> bool:
        """Re-dial until the broker answers or close() is called."""
        return _heal_link(self, self._connect, lambda: _drain_outbox(self))

    def publish(self, topic: str, payload: bytes) -> None:
        _publish_or_queue(self, topic, payload)

    @property
    def outbox_depth(self) -> int:
        """Events queued awaiting a broker heal (the outbox-depth gauge)."""
        with self._outbox_mu:
            return len(self._outbox)

    def _wire_send(self, topic: str, payload: bytes) -> None:
        with self._send_mu:
            self._sock.sendall(_frame(topic, payload))

    def subscribe(self, topic_prefix: str, callback: Callback) -> None:
        with self._mu:
            self._subs.append((topic_prefix, callback))

    def unsubscribe(self, callback: Callback) -> None:
        with self._mu:
            self._subs = [(p, c) for p, c in self._subs if c is not callback]

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def _read_loop(self) -> None:
        while not self._closed:
            frame = _read_frame(self._sock)
            if frame is None:
                if self._closed or not self._reconnect():
                    return
                continue
            topic, payload = frame
            with self._mu:
                subs = list(self._subs)
            for prefix, cb in subs:
                if topic.startswith(prefix):
                    try:
                        cb(topic, payload)
                    except Exception:
                        # Count swallowed subscriber errors: a dropped event
                        # here would otherwise vanish without a trace.
                        self.callback_errors += 1


def make_transport(
    broker: str,
    port: int,
    kind: str = "framed",
    client_id: str = "",
    username: str = "",
    password: str = "",
) -> Transport:
    """Config-driven transport selection.

    broker "local"/"inproc"/"" -> private InProcessBus; otherwise ``kind``
    picks the wire: "framed" (default, the self-hosted TcpBroker fabric) or
    "mqtt" (real MQTT 3.1.1 — join an existing mosquitto-style deployment,
    the reference's fabric, replication.rs:115-143)."""
    if broker in ("local", "inproc", ""):
        return InProcessBus()
    if kind == "mqtt":
        from merklekv_tpu_torch.cluster.transport_mqtt import MqttTransport

        return MqttTransport(
            broker, port, client_id=client_id,
            username=username, password=password,
        )
    if kind != "framed":
        # A typo'd kind silently speaking the wrong wire at a real broker
        # would leave replication dead with no error anywhere (publish is
        # QoS-0 and swallows transport failures by design).
        raise ValueError(f"unknown replication transport {kind!r}")
    return TcpTransport(broker, port)
