"""Fault injection: create the adversarial delivery model, deterministically.

A copy of ``merklekv_tpu/testing/faults.py``, its imports pointed at the
port's modules (the WAL's io seam is ``merklekv_tpu_torch/storage/wal.py``).

The anti-entropy engine claims to converge under dropped, delayed,
duplicated, and reordered traffic and under peers dying mid-sync.
"Asynchronous Merkle Trees" (PAPERS.md) makes the methodological point:
such claims are only arguments until the adversary can be CONSTRUCTED in a
test. This module constructs it, at two layers:

- :class:`FaultInjector` — a TCP proxy in front of any server/broker port.
  Faults act per forwarded chunk, per direction, driven by a seeded RNG so
  every chaos run replays bit-identically. Byte streams get the faults TCP
  can actually exhibit to an application: arbitrary delay, reordering
  across socket boundaries, duplicated/truncated delivery from a broken
  middlebox, and death (a lost segment never surfaces as a silent gap —
  the connection dies; ``drop`` therefore kills the stream after
  discarding, which is exactly the failure anti-entropy must resume
  through).
- :class:`FaultyTransport` — a message-level wrapper over any
  ``Transport`` (cluster/transport.py). The event fabric is QoS-0
  datagram-like, so whole-message drop/duplicate/reorder/delay are the
  meaningful faults there; LWW + op-id dedupe + anti-entropy must absorb
  them.
- :class:`PeerProcessKiller` — SIGKILL a spawned server process at a
  controlled moment (the process-level peer killer for the integration
  suite).

Nothing here is imported by serving code; it costs nothing in production.
"""

from __future__ import annotations

import random
import socket
import struct
import subprocess
import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional

__all__ = [
    "FaultSpec",
    "FaultInjector",
    "FaultyTransport",
    "PeerProcessKiller",
    "WalErrnoInjector",
    "truncate_file",
    "corrupt_file",
]


@dataclass(frozen=True)
class FaultSpec:
    """Per-direction fault probabilities/parameters (all default off)."""

    # Discard the chunk AND kill the connection: TCP never delivers a
    # silent gap, so a lost segment surfaces to the app as a dead link.
    drop_rate: float = 0.0
    # Uniform per-chunk forwarding delay (seconds): (min, max).
    delay: tuple[float, float] = (0.0, 0.0)
    # Hold the chunk and release it AFTER the next one (pairwise swap).
    reorder_rate: float = 0.0
    # Forward the chunk twice (broken middlebox / at-least-once fabric).
    dup_rate: float = 0.0
    # Forward only a prefix of the chunk, then kill the connection.
    truncate_rate: float = 0.0
    # Forward the chunk intact, then kill the connection.
    close_rate: float = 0.0
    # Token-bucket bandwidth cap (bytes/second, 0 = unlimited) for this
    # direction: each forwarded chunk spends its size in tokens, the bucket
    # refills at the rate with one rate-second of burst — a slow WAN link /
    # throttled middlebox, the fault snapshot-shipping resume must survive
    # realistically (not just drop/truncate).
    bandwidth_bytes_per_s: float = 0.0


class FaultInjector:
    """Deterministic fault-injecting TCP proxy.

        inj = FaultInjector("127.0.0.1", server_port, seed=7)
        client = MerkleKVClient(inj.host, inj.port)
        inj.set_faults("s2c", drop_rate=0.3)

    Directions: ``"c2s"`` (client->server), ``"s2c"`` (server->client),
    ``"both"``. Each (connection, direction) derives its own RNG from the
    injector seed and the connection ordinal, so a fixed seed replays the
    same fault schedule regardless of thread timing.

    ``kill_after_bytes(n, direction)`` arms a deterministic peer death:
    once ``n`` payload bytes have been forwarded in that direction the
    proxied "peer" dies — every live connection is reset and new dials are
    refused until :meth:`revive`. This is how the chaos suite kills a peer
    mid-sync at a reproducible point in the repair stream.
    """

    def __init__(
        self,
        upstream_host: str,
        upstream_port: int,
        seed: int = 0,
        listen_host: str = "127.0.0.1",
        chunk_size: int = 4096,
    ) -> None:
        self._upstream = (upstream_host, upstream_port)
        self._seed = seed
        self._chunk = chunk_size
        self._specs = {"c2s": FaultSpec(), "s2c": FaultSpec()}
        self._mu = threading.Lock()
        self._conns: dict[int, tuple[socket.socket, socket.socket]] = {}
        self._next_cid = 0
        self._closed = False
        self._dead = False  # peer "dead": refuse dials, reset live conns
        self._kill_budget: dict[str, Optional[int]] = {"c2s": None, "s2c": None}
        self._forwarded: dict[str, int] = {"c2s": 0, "s2c": 0}
        # Observability for assertions.
        self.connections = 0
        self.chunks_forwarded = 0
        self.chunks_dropped = 0
        self.chunks_duplicated = 0
        self.chunks_reordered = 0
        self.chunks_truncated = 0
        self.chunks_throttled = 0
        self.kills = 0

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()
        threading.Thread(target=self._accept, daemon=True).start()

    # -- configuration --------------------------------------------------------
    def set_faults(self, direction: str = "both", **fields) -> None:
        """Replace fault parameters for a direction (unset fields reset to
        the FaultSpec default — a call describes the COMPLETE fault state,
        so scenarios compose explicitly, not accidentally)."""
        for d in self._dirs(direction):
            self._specs[d] = replace(FaultSpec(), **fields)

    def clear_faults(self) -> None:
        self._specs = {"c2s": FaultSpec(), "s2c": FaultSpec()}

    def kill_after_bytes(self, n: int, direction: str = "s2c") -> None:
        """Arm a deterministic peer death after ``n`` forwarded bytes."""
        for d in self._dirs(direction):
            self._kill_budget[d] = n

    def kill_peer(self) -> None:
        """The proxied peer dies NOW: reset every connection, refuse dials."""
        self._dead = True
        self.kills += 1
        self._reset_conns()

    def revive(self) -> None:
        """The peer is back (restart): accept dials again."""
        self._dead = False
        self._kill_budget = {"c2s": None, "s2c": None}

    @property
    def dead(self) -> bool:
        return self._dead

    # -- proxy machinery ------------------------------------------------------
    @staticmethod
    def _dirs(direction: str) -> list[str]:
        if direction == "both":
            return ["c2s", "s2c"]
        if direction not in ("c2s", "s2c"):
            raise ValueError(f"unknown direction {direction!r}")
        return [direction]

    def _accept(self) -> None:
        while not self._closed:
            try:
                downstream, _ = self._listener.accept()
            except OSError:
                return
            if self._dead or self._closed:
                self._hard_close(downstream)
                continue
            try:
                upstream = socket.create_connection(self._upstream, timeout=5)
            except OSError:
                self._hard_close(downstream)
                continue
            for s in (downstream, upstream):
                try:
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            with self._mu:
                cid = self._next_cid
                self._next_cid += 1
                self._conns[cid] = (downstream, upstream)
                self.connections += 1
            for direction, src, dst in (
                ("c2s", downstream, upstream),
                ("s2c", upstream, downstream),
            ):
                rng = random.Random(
                    (self._seed * 1_000_003 + cid * 2)
                    ^ (1 if direction == "s2c" else 0)
                )
                threading.Thread(
                    target=self._pump,
                    args=(cid, src, dst, direction, rng),
                    daemon=True,
                ).start()

    def _pump(
        self,
        cid: int,
        src: socket.socket,
        dst: socket.socket,
        direction: str,
        rng: random.Random,
    ) -> None:
        held: Optional[bytes] = None  # chunk delayed for a pairwise swap
        # Token bucket for the bandwidth cap: thread-local — one pump
        # thread owns one (connection, direction) stream.
        tokens = 0.0
        refill_at = time.monotonic()
        try:
            while not self._closed:
                try:
                    data = src.recv(self._chunk)
                except OSError:
                    break
                if not data:
                    break
                spec = self._specs[direction]
                if spec.bandwidth_bytes_per_s > 0:
                    rate = spec.bandwidth_bytes_per_s
                    now = time.monotonic()
                    # Burst capacity: one rate-second, but never less than
                    # a chunk (a cap below the chunk size must still pass
                    # whole chunks, just slowly).
                    cap = max(rate, float(len(data)))
                    tokens = min(cap, tokens + (now - refill_at) * rate)
                    refill_at = now
                    if tokens < len(data):
                        # Only chunks that actually wait count as throttled.
                        self.chunks_throttled += 1
                    while tokens < len(data) and not self._closed:
                        time.sleep(min((len(data) - tokens) / rate, 0.05))
                        now = time.monotonic()
                        tokens = min(cap, tokens + (now - refill_at) * rate)
                        refill_at = now
                    tokens -= len(data)
                budget = self._kill_budget[direction]
                if budget is not None and self._forwarded[direction] >= budget:
                    self.kill_peer()
                    break
                if spec.drop_rate and rng.random() < spec.drop_rate:
                    # A lost TCP segment is a dead link, never a silent gap.
                    self.chunks_dropped += 1
                    break
                if spec.truncate_rate and rng.random() < spec.truncate_rate:
                    self.chunks_truncated += 1
                    self._send(dst, data[: max(1, len(data) // 2)], direction)
                    break
                d_lo, d_hi = spec.delay
                if d_hi > 0:
                    time.sleep(rng.uniform(d_lo, d_hi))
                if held is not None:
                    # Release order: current chunk first, held chunk second.
                    if not self._send(dst, data, direction):
                        break
                    ok = self._send(dst, held, direction)
                    held = None
                    if not ok:
                        break
                    self.chunks_forwarded += 2
                    continue
                if spec.reorder_rate and rng.random() < spec.reorder_rate:
                    self.chunks_reordered += 1
                    held = data
                    continue
                if not self._send(dst, data, direction):
                    break
                self.chunks_forwarded += 1
                if spec.dup_rate and rng.random() < spec.dup_rate:
                    self.chunks_duplicated += 1
                    if not self._send(dst, data, direction):
                        break
                if spec.close_rate and rng.random() < spec.close_rate:
                    break
        finally:
            if held is not None:
                self._send(dst, held, direction)
            self._drop(cid)

    def _send(self, dst: socket.socket, data: bytes, direction: str) -> bool:
        try:
            dst.sendall(data)
        except OSError:
            return False
        self._forwarded[direction] += len(data)
        return True

    @staticmethod
    def _hard_close(sock: socket.socket) -> None:
        # Abortive teardown, delivered PROMPTLY. SO_LINGER(1,0) arms an
        # RST-on-close, but a bare close() is deferred by the kernel while
        # a pump thread sits parked in recv() on this fd (the blocked recv
        # holds a reference) — the far end then never sees the death and
        # hangs for its full socket timeout instead of failing fast. The
        # shutdown() tears the connection down immediately regardless of
        # who is blocked on it, at the cost of leading with a FIN: the far
        # end observes EOF-or-reset rather than a guaranteed bare RST.
        # Client stacks here surface both identically (ConnectionError),
        # and a death the victim actually notices beats a textbook RST it
        # waits 30 s to discover.
        try:
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
            )
        except OSError:
            pass
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _drop(self, cid: int) -> None:
        with self._mu:
            pair = self._conns.pop(cid, None)
        if pair is not None:
            for s in pair:
                self._hard_close(s)

    def _reset_conns(self) -> None:
        with self._mu:
            pairs = list(self._conns.values())
            self._conns.clear()
        for a, b in pairs:
            self._hard_close(a)
            self._hard_close(b)

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._reset_conns()


class FaultyTransport:
    """Message-level fault wrapper implementing the ``Transport`` protocol.

    Wraps any inner transport and applies whole-message faults on
    ``publish`` — the QoS-0 event fabric's failure model. Deterministic
    under a fixed seed. Delivery-side faults are not needed: publishing
    through a wrapped transport exercises every subscriber identically.
    """

    def __init__(
        self,
        inner,
        seed: int = 0,
        drop_rate: float = 0.0,
        dup_rate: float = 0.0,
        reorder_rate: float = 0.0,
        delay: tuple[float, float] = (0.0, 0.0),
    ) -> None:
        self._inner = inner
        self._rng = random.Random(seed)
        self._drop = drop_rate
        self._dup = dup_rate
        self._reorder = reorder_rate
        self._delay = delay
        self._held: Optional[tuple[str, bytes]] = None
        self._mu = threading.Lock()
        self.published = 0
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0

    def publish(self, topic: str, payload: bytes) -> None:
        with self._mu:
            if self._drop and self._rng.random() < self._drop:
                self.dropped += 1
                return
            d_lo, d_hi = self._delay
            if d_hi > 0:
                time.sleep(self._rng.uniform(d_lo, d_hi))
            held, self._held = self._held, None
            if held is None and self._reorder and (
                self._rng.random() < self._reorder
            ):
                self.reordered += 1
                self._held = (topic, payload)
                return
            self._inner.publish(topic, payload)
            self.published += 1
            if held is not None:
                self._inner.publish(*held)
                self.published += 1
            if self._dup and self._rng.random() < self._dup:
                self.duplicated += 1
                self._inner.publish(topic, payload)

    def flush_held(self) -> None:
        """Release a message held for reordering (end-of-scenario drain)."""
        with self._mu:
            held, self._held = self._held, None
        if held is not None:
            self._inner.publish(*held)
            self.published += 1

    def subscribe(self, topic_prefix: str, callback) -> None:
        self._inner.subscribe(topic_prefix, callback)

    def unsubscribe(self, callback) -> None:
        self._inner.unsubscribe(callback)

    def close(self) -> None:
        self.flush_held()
        self._inner.close()

    def __getattr__(self, name):  # reconnects/outbox counters etc.
        return getattr(self._inner, name)


class WalErrnoInjector:
    """Deterministic resource-fault injection for the WAL io seam
    (storage/wal.py ``set_io_hooks``) — the chaos suite's missing fault
    class: a disk that fills or fails mid-burst.

    Counts every WAL write/fsync; from the Nth call of the chosen kind on
    (1-based), the call raises ``OSError(errno_)`` — ENOSPC by default —
    until :meth:`heal` (the disk "fills" and stays full, the realistic
    shape) or, with ``fail_count``, for exactly that many calls (a
    transient EIO blip). The store's typed-error handling then drives the
    node's read-only degradation and recovery WITHOUT a real full
    filesystem, deterministically.

    Usage::

        inj = WalErrnoInjector(fail_write_at=3).install()
        try:
            ...  # third WAL write on raises StorageFullError upstream
            inj.heal()   # disk "empties"; recovery probe succeeds
        finally:
            inj.uninstall()
    """

    def __init__(
        self,
        fail_write_at: Optional[int] = None,
        fail_fsync_at: Optional[int] = None,
        errno_: Optional[int] = None,
        fail_count: Optional[int] = None,
    ) -> None:
        import errno as _errno
        import os as _os

        self._os = _os
        self.errno = _errno.ENOSPC if errno_ is None else errno_
        self._fail_write_at = fail_write_at
        self._fail_fsync_at = fail_fsync_at
        self._fail_count = fail_count  # None = until heal()
        self._mu = threading.Lock()
        self.writes = 0
        self.fsyncs = 0
        self.failures = 0
        self._healed = False
        self._installed = False

    # -- hook bodies --------------------------------------------------------
    def _should_fail(self, n: int, at: Optional[int]) -> bool:
        if at is None or self._healed or n < at:
            return False
        if self._fail_count is not None and self.failures >= self._fail_count:
            return False
        return True

    def _write(self, fd: int, data: bytes) -> int:
        import os as _os

        with self._mu:
            self.writes += 1
            if self._should_fail(self.writes, self._fail_write_at):
                self.failures += 1
                raise OSError(self.errno, _os.strerror(self.errno))
        return self._os.write(fd, data)

    def _fsync(self, fd: int) -> None:
        import os as _os

        with self._mu:
            self.fsyncs += 1
            if self._should_fail(self.fsyncs, self._fail_fsync_at):
                self.failures += 1
                raise OSError(self.errno, _os.strerror(self.errno))
        self._os.fsync(fd)

    # -- lifecycle ----------------------------------------------------------
    def install(self) -> "WalErrnoInjector":
        from merklekv_tpu_torch.storage import wal as walmod

        walmod.set_io_hooks(write=self._write, fsync=self._fsync)
        self._installed = True
        return self

    def heal(self) -> None:
        """Stop injecting (the disk 'empties'); counters keep running so
        tests can assert how many ops happened post-recovery."""
        with self._mu:
            self._healed = True

    def uninstall(self) -> None:
        if self._installed:
            from merklekv_tpu_torch.storage import wal as walmod

            walmod.set_io_hooks()  # restore the real os calls
            self._installed = False

    def __enter__(self) -> "WalErrnoInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def truncate_file(path: str, size: int) -> int:
    """Hard-truncate ``path`` to ``size`` bytes — the on-disk signature a
    crash leaves when it tears the tail of an append-only log. Returns the
    number of bytes removed. The durable-storage torn-tail suite sweeps
    this over every byte offset of the final WAL frame."""
    import os

    old = os.path.getsize(path)
    if size > old:
        raise ValueError(f"cannot truncate {path} up: {size} > {old}")
    with open(path, "r+b") as f:
        f.truncate(size)
    return old - size


def corrupt_file(path: str, offset: int, xor: int = 0xFF) -> None:
    """Flip bits of one byte in place (bit rot / middlebox damage on a
    stored artifact, as opposed to :func:`truncate_file`'s torn tail)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        if len(b) != 1:
            raise ValueError(f"offset {offset} beyond EOF of {path}")
        f.seek(offset)
        f.write(bytes([b[0] ^ xor]))


class PeerProcessKiller:
    """SIGKILL a spawned peer server at a controlled moment.

    The process-level analog of ``FaultInjector.kill_peer`` for the
    integration suite (tests/test_integration_processes.py): no shutdown
    path, no engine close, no flush — the death a crashed machine gives.
    """

    def __init__(self, proc: subprocess.Popen) -> None:
        self._proc = proc
        self.killed = False

    def kill_now(self) -> None:
        self._proc.kill()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        self.killed = True

    def kill_when(
        self,
        predicate: Callable[[], bool],
        timeout: float = 30.0,
        poll: float = 0.005,
    ) -> bool:
        """Kill as soon as ``predicate()`` is true; False on timeout (the
        peer survives — callers assert on the return)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if predicate():
                self.kill_now()
                return True
            time.sleep(poll)
        return False

    def kill_after(self, seconds: float) -> threading.Timer:
        t = threading.Timer(seconds, self.kill_now)
        t.daemon = True
        t.start()
        return t
