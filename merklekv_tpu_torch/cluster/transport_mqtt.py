"""MQTT 3.1.1 transport: join a real MQTT deployment as the event fabric.

A copy of ``merklekv_tpu/cluster/transport_mqtt.py``, its imports pointed at the port's modules.

The reference replicates through any MQTT broker (rumqttc -> mosquitto,
the reference's src/replication.rs:115-143). The default fabric here is the
self-hosted length-framed TcpBroker (transport.py) — but a node configured
with ``[replication] transport = "mqtt"`` speaks actual MQTT 3.1.1 wire
frames, so it can join an existing mosquitto/EMQX/HiveMQ deployment (QoS-0;
the anti-entropy backstop repairs drops, same as the framed fabric).

Implemented subset (all of what replication needs):
  CONNECT/CONNACK (clean session, optional username/password),
  PUBLISH QoS-0 in both directions, SUBSCRIBE/SUBACK with a trailing
  multi-level wildcard, PINGREQ/PINGRESP keepalive, DISCONNECT.

``MqttBroker`` is a frame-accurate MQTT 3.1.1 broker (QoS-0 fan-out,
'#'/'+' filters): CLI-runnable via ``python -m merklekv_tpu_torch.broker
--protocol mqtt`` so an all-MQTT cluster runs self-contained, and used
in-process by the interop tests (no external mosquitto in this image).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Optional

from merklekv_tpu_torch.cluster.retry import TRANSPORT_HEAL
from merklekv_tpu_torch.cluster.transport import (
    _dead_socket,
    _drain_outbox,
    _enable_tcp_keepalive,
    _enlarge_sock_buffers,
    _heal_link,
    _publish_or_queue,
)
from merklekv_tpu_torch.utils.tracing import get_metrics

__all__ = ["MqttTransport", "MqttBroker", "StubMqttBroker"]

Callback = Callable[[str, bytes], None]

# Packet types (high nibble of the fixed header).
_CONNECT = 0x10
_CONNACK = 0x20
_PUBLISH = 0x30
_SUBSCRIBE = 0x82  # QoS-1 control packet per spec (required flags 0b0010)
_SUBACK = 0x90
_PUBACK = 0x40
_PUBREC = 0x50
_PUBREL = 0x60  # client frame arrives with required flags 0b0010 (0x62)
_PUBCOMP = 0x70
_PINGREQ = 0xC0
_PINGRESP = 0xD0
_DISCONNECT = 0xE0


def _encode_varlen(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _utf8(s: str) -> bytes:
    e = s.encode("utf-8")
    return struct.pack(">H", len(e)) + e


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes, or None on EOF/error.

    A recv DEADLINE is not EOF: an idle-but-healthy link (slow broker,
    PINGRESP delayed under load) raises ``socket.timeout`` to the caller
    when nothing has been read yet — the caller decides whether the quiet
    crossed the missed-PINGRESP deadline. A timeout MID-read returns None:
    the stream is torn between frames and only a teardown realigns it."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if buf:
                return None
            raise
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def _read_packet(sock: socket.socket) -> Optional[tuple[int, bytes]]:
    """One MQTT control packet -> (fixed header byte, payload bytes).

    Raises ``socket.timeout`` only while waiting for a packet to START
    (idle link); a stall mid-packet returns None (stream misaligned)."""
    head = _read_exact(sock, 1)  # socket.timeout here = idle, propagate
    if head is None:
        return None
    try:
        # Remaining Length: up to 4 varint bytes.
        mult, length = 1, 0
        for _ in range(4):
            b = _read_exact(sock, 1)
            if b is None:
                return None
            length += (b[0] & 0x7F) * mult
            if not (b[0] & 0x80):
                break
            mult *= 128
        else:
            return None  # malformed varint
        body = _read_exact(sock, length) if length else b""
    except socket.timeout:
        return None  # stalled mid-packet: only a reconnect realigns
    if body is None:
        return None
    return head[0], body


def _topic_matches(filt: str, topic: str) -> bool:
    """MQTT 3.1.1 filter matching ('#' multi-level, '+' single-level;
    '#' also matches the parent level, per spec 4.7.1.2)."""
    if filt == topic:
        return True
    fparts = filt.split("/")
    tparts = topic.split("/")
    for i, fp in enumerate(fparts):
        if fp == "#":
            return True
        if i >= len(tparts):
            return False
        if fp != "+" and fp != tparts[i]:
            return False
    return len(fparts) == len(tparts)


class MqttTransport:
    """Transport (transport.py Protocol) over MQTT 3.1.1, QoS-0."""

    # Same heal policy as TcpTransport (cluster/retry.py): first retry
    # almost immediately, cap below the anti-entropy interval. The legacy
    # knobs stay as the per-instance test override hook.
    _policy = TRANSPORT_HEAL
    _BACKOFF_FIRST = TRANSPORT_HEAL.first_delay
    _BACKOFF_MAX = TRANSPORT_HEAL.max_delay

    def __init__(
        self,
        host: str,
        port: int = 1883,
        client_id: str = "",
        username: str = "",
        password: str = "",
        keepalive: int = 30,
        timeout: float = 10.0,
    ) -> None:
        self._host, self._port, self._timeout = host, port, timeout
        self._client_id = client_id or f"mkv-{id(self):x}"
        self._username, self._password = username, password
        self._subs: list[tuple[str, Callback]] = []
        self._mu = threading.Lock()
        self._send_mu = threading.Lock()
        self._closed = False
        self._keepalive = keepalive
        self.callback_errors = 0
        self.reconnects = 0
        self._outbox = deque()
        self._outbox_mu = threading.Lock()
        self.outbox_dropped = 0
        self.link_down = False
        self._packet_id = 0
        self._last_inbound = time.monotonic()

        try:
            self._sock = self._dial_and_handshake()
        except OSError:
            # Broker down at boot (ConnectionError from a refused CONNACK
            # included): start degraded; the reader's heal loop dials,
            # handshakes, and resubscribes with backoff — node-before-
            # broker startup ordering is supported.
            get_metrics().inc("transport.start_degraded")
            self._sock = _dead_socket()
            self.link_down = True

        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        self._pinger = threading.Thread(target=self._ping_loop, daemon=True)
        self._pinger.start()

    def _dial_and_handshake(self) -> socket.socket:
        """TCP connect + CONNECT/CONNACK. Raises on refusal."""
        sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        )
        if sock.getsockname() == sock.getpeername():
            # TCP self-connect while the broker is down (see
            # transport.TcpTransport._connect) — fail the attempt.
            sock.close()
            raise ConnectionRefusedError("self-connect (broker down)")
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _enlarge_sock_buffers(sock)  # burst headroom (transport.py note)
        # Kernel-level liveness too: with keepalive=0 (app-level keepalive
        # disabled per spec) this is the ONLY silent-partition detection.
        _enable_tcp_keepalive(sock)
        flags = 0x02  # clean session
        payload = _utf8(self._client_id)
        if self._username:
            flags |= 0x80
            payload += _utf8(self._username)
            if self._password:
                flags |= 0x40
                payload += _utf8(self._password)
        var = (
            _utf8("MQTT") + bytes([4, flags])
            + struct.pack(">H", self._keepalive)
        )
        body = var + payload
        sock.sendall(bytes([_CONNECT]) + _encode_varlen(len(body)) + body)
        try:
            pkt = _read_packet(sock)
        except socket.timeout:
            pkt = None  # no CONNACK inside the dial timeout
        if pkt is None or (pkt[0] & 0xF0) != _CONNACK:
            sock.close()
            raise ConnectionError("MQTT: no CONNACK")
        if len(pkt[1]) < 2 or pkt[1][1] != 0:
            rc = pkt[1][1] if len(pkt[1]) >= 2 else -1
            sock.close()
            raise ConnectionError(f"MQTT: connection refused rc={rc}")
        # Recv PROBE interval, not a teardown deadline: the pinger elicits a
        # PINGRESP every keepalive/2, so a healthy link has inbound traffic
        # at that cadence. Each recv timeout only wakes the read loop to
        # CHECK the missed-PINGRESP deadline (2x keepalive since the last
        # inbound byte) — a slow-but-alive broker no longer costs a full
        # teardown/re-handshake/resubscribe per quiet spell, while a silent
        # partition (no RST — power loss, NAT drop) is still detected and
        # reconnected within ~2x keepalive. keepalive=0 means keepalive
        # DISABLED per spec 3.1.2.10 — no deadline then.
        sock.settimeout(
            max(self._keepalive / 2.0, 1.0) if self._keepalive else None
        )
        self._last_inbound = time.monotonic()
        return sock

    def _reconnect(self) -> bool:
        """Re-dial + handshake + re-SUBSCRIBE every live subscription —
        clean-session brokers forget filters across connections, so a
        reconnect without resubscribe would heal the link but stay deaf
        (the reference's rumqttc resubscribes the same way)."""
        return _heal_link(self, self._dial_and_handshake, self._on_healed)

    def _on_healed(self) -> None:
        # Resubscribe FIRST (a clean-session broker forgot the filters),
        # then flush events queued during the outage.
        with self._mu:
            prefixes = [p for p, _ in self._subs]
        for prefix in prefixes:
            self._send_subscribe(prefix)
        _drain_outbox(self)

    def _send_subscribe(self, topic_prefix: str) -> None:
        with self._mu:
            self._packet_id = self._packet_id % 0xFFFF + 1
            pid = self._packet_id
        body = struct.pack(">H", pid) + _utf8(topic_prefix + "/#") + b"\x00"
        with self._send_mu:
            try:
                self._send_packet_locked(_SUBSCRIBE, body)
            except OSError:
                pass  # the read loop notices the dead link and reconnects

    # -- Transport interface --------------------------------------------------
    def publish(self, topic: str, payload: bytes) -> None:
        _publish_or_queue(self, topic, payload)

    @property
    def outbox_depth(self) -> int:
        """Events queued awaiting a broker heal (the outbox-depth gauge)."""
        with self._outbox_mu:
            return len(self._outbox)

    def _wire_send(self, topic: str, payload: bytes) -> None:
        body = _utf8(topic) + payload  # QoS-0: no packet id
        with self._send_mu:
            self._send_packet_locked(_PUBLISH, body)

    def subscribe(self, topic_prefix: str, callback: Callback) -> None:
        with self._mu:
            self._subs.append((topic_prefix, callback))
        # '#' matches the prefix level itself and everything below it —
        # the "{prefix}/events/#" shape the reference subscribes
        # (replication.rs:142-143).
        self._send_subscribe(topic_prefix)

    def unsubscribe(self, callback: Callback) -> None:
        with self._mu:
            self._subs = [(p, c) for p, c in self._subs if c is not callback]

    def close(self) -> None:
        self._closed = True
        with self._send_mu:
            try:
                self._send_packet_locked(_DISCONNECT, b"")
            except OSError:
                pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    # -- internals ------------------------------------------------------------
    def _send_packet(self, header: int, body: bytes) -> None:
        with self._send_mu:
            self._send_packet_locked(header, body)

    def _send_packet_locked(self, header: int, body: bytes) -> None:
        try:
            self._sock.sendall(
                bytes([header]) + _encode_varlen(len(body)) + body
            )
        except OSError:
            # A failed sendall may have written PART of the frame; the
            # stream is misaligned and every later write would feed the
            # broker garbage. Poison the socket so the read loop reconnects.
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raise

    def _ping_loop(self) -> None:
        if not self._keepalive:
            return  # keepalive=0: disabled per spec
        interval = max(self._keepalive // 2, 1)
        while not self._closed:
            time.sleep(interval)
            if self._closed:
                return
            with self._send_mu:
                try:
                    self._send_packet_locked(_PINGREQ, b"")
                except OSError:
                    # Dead link: the read loop owns reconnection; keep the
                    # pinger alive so keepalive resumes on the new socket.
                    continue

    def _read_loop(self) -> None:
        while not self._closed:
            try:
                pkt = _read_packet(self._sock)
            except socket.timeout:
                # Quiet link, not a condemned one: only reconnect once the
                # missed-PINGRESP deadline (2x keepalive without ANY
                # inbound byte) has passed — a healthy-but-slow broker just
                # waits for the next PINGRESP instead of paying a teardown.
                if self._keepalive and (
                    time.monotonic() - self._last_inbound
                    > 2.0 * self._keepalive
                ):
                    get_metrics().inc("transport.pingresp_misses")
                    pkt = None  # condemned: fall through to reconnect
                else:
                    get_metrics().inc("transport.slow_broker_waits")
                    continue
            if pkt is None:
                if self._closed or not self._reconnect():
                    return
                continue
            self._last_inbound = time.monotonic()
            header, body = pkt
            ptype = header & 0xF0
            if ptype != _PUBLISH:
                continue  # CONNACK dups / SUBACK / PINGRESP need no action
            qos = (header >> 1) & 0x03
            if len(body) < 2:
                continue
            (tlen,) = struct.unpack(">H", body[:2])
            if len(body) < 2 + tlen:
                continue
            topic = body[2 : 2 + tlen].decode("utf-8", "surrogateescape")
            off = 2 + tlen
            if qos:
                off += 2  # packet id (broker may deliver QoS>0 publishes)
            payload = body[off:]
            with self._mu:
                subs = list(self._subs)
            for prefix, cb in subs:
                if topic.startswith(prefix):
                    try:
                        cb(topic, payload)
                    except Exception:
                        self.callback_errors += 1


class MqttBroker:
    """Frame-accurate MQTT 3.1.1 broker (QoS-0 fan-out).

    Speaks real wire frames on real sockets: CONNECT->CONNACK,
    SUBSCRIBE->SUBACK, PUBLISH fan-out honoring '#'/'+' filters,
    PINGREQ->PINGRESP. No retained messages, sessions, or QoS>0 flows —
    the event fabric is QoS-0 by design (anti-entropy repairs drops)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()
        self._mu = threading.Lock()
        # cid -> (socket, send lock, [topic filters], {in-flight QoS-2 pids})
        self._clients: dict[
            int, tuple[socket.socket, threading.Lock, list, set]
        ] = {}
        self._next = 0
        self._closed = False
        self.connects = 0
        self.publishes = 0
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _enlarge_sock_buffers(sock)
            with self._mu:
                cid = self._next
                self._next += 1
                self._clients[cid] = (sock, threading.Lock(), [], set())
            threading.Thread(
                target=self._serve, args=(cid, sock), daemon=True
            ).start()

    def _serve(self, cid: int, sock: socket.socket) -> None:
        try:
            while True:
                pkt = _read_packet(sock)
                if pkt is None:
                    break
                if not self._handle_packet(cid, *pkt):
                    break
        except Exception:
            # A malformed frame must cost the SENDER its connection, never
            # the broker: fall through to the cleanup either way.
            pass
        self._drop(cid)

    def _handle_packet(self, cid: int, header: int, body: bytes) -> bool:
        """One control packet; False ends the connection."""
        ptype = header & 0xF0
        if ptype == _CONNECT & 0xF0:
            self.connects += 1
            self._send(cid, bytes([_CONNACK, 2, 0, 0]))
        elif ptype == _SUBSCRIBE & 0xF0:
            pid = body[:2]
            filters, rcs = [], b""
            off = 2
            while off + 2 <= len(body):
                (flen,) = struct.unpack(">H", body[off : off + 2])
                f = body[off + 2 : off + 2 + flen].decode("utf-8")
                off += 2 + flen + 1  # + requested QoS byte
                filters.append(f)
                rcs += b"\x00"  # granted QoS 0
            with self._mu:
                if cid in self._clients:
                    self._clients[cid][2].extend(filters)
            suback = pid + rcs
            self._send(
                cid,
                bytes([_SUBACK]) + _encode_varlen(len(suback)) + suback,
            )
        elif ptype == _PUBLISH:
            self.publishes += 1
            qos = (header >> 1) & 0x03
            (tlen,) = struct.unpack(">H", body[:2])
            topic = body[2 : 2 + tlen].decode("utf-8", "surrogateescape")
            payload_off = 2 + tlen
            if qos:
                # QoS>0 sender (e.g. mosquitto_pub -q 1): acknowledge, and
                # strip the packet id so subscribers get a clean QoS-0
                # body — leaving it would prepend 2 stray bytes to every
                # fanned-out payload.
                pid_bytes = body[payload_off : payload_off + 2]
                payload_off += 2
                if qos == 1:
                    self._send(cid, bytes([_PUBACK, 2]) + pid_bytes)
                else:  # QoS 2: PUBREC now, PUBCOMP on the sender's PUBREL
                    # Exactly-once inbound half: a DUP re-send of a packet
                    # id still in flight (the sender lost our PUBREC) must
                    # be re-acked but NOT fanned out twice. The pid clears
                    # on PUBREL, freeing it for reuse per spec.
                    (pid,) = struct.unpack(">H", pid_bytes)
                    with self._mu:
                        entry = self._clients.get(cid)
                        dup = entry is not None and pid in entry[3]
                        if entry is not None:
                            entry[3].add(pid)
                    self._send(cid, bytes([_PUBREC, 2]) + pid_bytes)
                    if dup:
                        return True  # already fanned out on first receipt
            out_body = (
                body if not qos else body[: 2 + tlen] + body[payload_off:]
            )
            frame = (
                bytes([_PUBLISH]) + _encode_varlen(len(out_body)) + out_body
            )
            with self._mu:
                targets = list(self._clients.items())
            for tid, (_s, _lk, filters, _pids) in targets:
                if any(_topic_matches(f, topic) for f in filters):
                    self._send(tid, frame)
        elif ptype == _PUBREL & 0xF0:
            if len(body) >= 2:
                (pid,) = struct.unpack(">H", body[:2])
                with self._mu:
                    entry = self._clients.get(cid)
                    if entry is not None:
                        entry[3].discard(pid)
            self._send(cid, bytes([_PUBCOMP, 2]) + body[:2])
        elif ptype == _PINGREQ & 0xF0:
            self._send(cid, bytes([_PINGRESP, 0]))
        elif ptype == _DISCONNECT & 0xF0:
            return False
        return True

    def _send(self, cid: int, frame: bytes) -> None:
        with self._mu:
            entry = self._clients.get(cid)
        if entry is None:
            return
        sock, lock = entry[0], entry[1]
        try:
            with lock:
                sock.sendall(frame)
        except OSError:
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
            # shutdown BEFORE close — see TcpBroker.close: the blocked
            # accept() otherwise keeps the port in LISTEN forever.
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
        for s, *_rest in entries:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


# Historical name from when the broker lived test-side only.
StubMqttBroker = MqttBroker
