"""Pipelined request plane: epoll worker-pool router with read leases.

A copy of ``merklekv_tpu/requestplane/router.py``, its imports pointed at the port's modules.

This replaces the thread-per-connection thin router (cluster/router.py,
kept as the measured A/B baseline) with the same I/O discipline as
the native server, applied to the routing hop:

- a **fixed pool of io workers**, each owning a private selector
  (epoll on Linux). A client connection is adopted by one worker for
  life — no cross-worker locking on the request path.
- **full client-side pipelining**: each readable pass drains the socket,
  parses EVERY complete frame, dispatches them in order, and answers
  with ONE writev (``sendmsg``) per burst — responses for a burst
  coalesce instead of paying a syscall each. Out-of-order upstream
  completions park in per-connection ordered slots; only the completed
  prefix ever flushes, so responses are byte-ordered exactly like the
  requests.
- **per-partition upstream pools with pipelined fan-out**: each worker
  keeps one pipelined connection per partition it talks to. Multi-key
  verbs (MGET/MSET/EXISTS, SCAN/DBSIZE) split by partition, dispatch to
  every group concurrently in the same pass, and merge when the last
  sub-answer lands — in-flight requests on one upstream are matched
  back strictly FIFO, which TCP ordering guarantees.
- **bounded MOVED/BUSY healing folded into the pooled path**: a MOVED
  answer (stale map mid-rebalance) schedules a map refresh on the
  keeper thread and a re-route on a worker timer; BUSY waits the same
  PARTITION_MOVED budget out. No worker thread ever sleeps.
- **hot-key read leases** (cache.py + invalidation.py): a GET miss
  grants one fill lease; concurrent readers wait on the in-flight
  answer. Entries invalidate event-driven off the replication topics
  and expire at the hard ``max_age`` bound; ``GET <key> vs=01`` answers
  carry a ``vs=<age_ms>:<bound_ms>`` stamp so a client can SEE the
  staleness it may be eating (docs/PROTOCOL.md "Router semantics").

Backpressure mirrors the native plane: an out-backlog past the high
watermark pauses reading that connection until the drain crosses the low
watermark; EAGAIN parks the remainder behind EPOLLOUT.

Run: ``python -m merklekv_tpu_torch router --port 7400 --seeds host:7001 \\
    --workers 4 --cache-mb 64 --broker host --broker-port 7500 \\
    --topic-prefix mkv --metrics-port 9110``
"""

from __future__ import annotations

import heapq
import os
import selectors
import socket
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

from merklekv_tpu_torch.client import (
    ConnectionError as ClientConnectionError,
    MerkleKVClient,
    MerkleKVError,
)
from merklekv_tpu_torch.cluster.partmap import PartitionMap
from merklekv_tpu_torch.cluster.retry import PARTITION_MOVED
from merklekv_tpu_torch.obs.flightrec import get_recorder
from merklekv_tpu_torch.requestplane.cache import LEAD, WAIT, LeaseCache
from merklekv_tpu_torch.requestplane.invalidation import InvalidationFeed
from merklekv_tpu_torch.utils.tracing import get_metrics

__all__ = ["RequestPlaneRouter", "main"]

MAX_LINE = 1 << 20          # request-line byte cap ([server] parity)
MAX_IOV = 64                # iovecs per writev (native plane parity)
OUT_HIGH = 8 << 20          # pause reading past this backlog
OUT_LOW = 1 << 20           # resume below this
_READ_CHUNK = 1 << 18

_R = selectors.EVENT_READ
_W = selectors.EVENT_WRITE

# Single-key verbs forwarded verbatim (verb -> takes "<key> <value>").
_SINGLE_KEY = {
    "GET": False,
    "DELETE": False,
    "DEL": False,
    "SET": True,
    "APPEND": True,
    "PREPEND": True,
}

# Bytes fast lane (the hot path): already-uppercase single-key commands
# are routed and forwarded without ever leaving bytes — no decode, no
# closure per request, raw response passthrough. Anything irregular
# (lowercase verb, vs= token, validation failure, ERROR answer, cached
# GET) drops to the str machinery below, which stays authoritative.
# verb -> shape: 0 = GET (key only), 1 = key + value, 2 = key only write.
_FAST_VERBS = {
    b"GET": 0,
    b"SET": 1,
    b"APPEND": 1,
    b"PREPEND": 1,
    b"DELETE": 2,
    b"DEL": 2,
}

# The typed retryable refusal for an upstream that died (or went
# unreachable) mid-command: BUSY is the protocol's "back off and retry"
# answer (client.ServerBusyError), which is exactly the contract — the
# replica group heals (sibling takeover, restart, new map) on the same
# timescale as an overload shed. Never a silent desync, never a generic
# error the SDKs would treat as fatal.
_BUSY_UPSTREAM_LOST = "ERROR BUSY router: upstream connection lost (retry)"


class _Moved(Exception):
    def __init__(self, pid: int, epoch: int) -> None:
        super().__init__(f"MOVED {pid} {epoch}")
        self.pid, self.epoch = pid, epoch


class _Unreachable(Exception):
    pass


def _send_vec(sock: socket.socket, out: deque) -> int:
    """Flush a deque of memoryviews with writev-coalesced sendmsg calls.
    Returns bytes sent; leaves the unsent tail in ``out``. Raises OSError
    on a dead peer; EAGAIN just stops the flush."""
    total = 0
    while out:
        iov = list(out) if len(out) <= MAX_IOV else [
            out[i] for i in range(MAX_IOV)
        ]
        want = sum(len(mv) for mv in iov)
        try:
            sent = sock.sendmsg(iov)
        except (BlockingIOError, InterruptedError):
            break
        total += sent
        rem = sent
        while rem and out:
            mv = out[0]
            if rem >= len(mv):
                rem -= len(mv)
                out.popleft()
            else:
                out[0] = mv[rem:]
                rem = 0
        if sent < want:
            break  # kernel buffer full — park behind EPOLLOUT
    return total


class _Slot:
    """One request's ordered response slot. ``parts``/``outstanding``
    carry fan-out state; ``attempt`` the MOVED/BUSY healing budget."""

    __slots__ = ("data", "done", "parts", "outstanding", "attempt")

    def __init__(self) -> None:
        self.data = b""
        self.done = False
        self.parts: Optional[dict] = None
        self.outstanding = 0
        self.attempt = 0


class _ClientConn:
    __slots__ = (
        "sock", "fd", "worker", "router", "inbuf", "slots", "out",
        "out_bytes", "want_write", "paused", "closed", "close_after_flush",
    )

    def __init__(self, worker: "_Worker", sock: socket.socket) -> None:
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.sock = sock
        self.fd = sock.fileno()
        self.worker = worker
        self.router = worker.router
        self.inbuf = bytearray()
        self.slots: deque[_Slot] = deque()
        self.out: deque = deque()
        self.out_bytes = 0
        self.want_write = False
        self.paused = False
        self.closed = False
        self.close_after_flush = False

    # -- reading -------------------------------------------------------------
    def on_readable(self) -> None:
        got = 0
        while got < (1 << 20):  # fairness cap per pass
            try:
                chunk = self.sock.recv(_READ_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self.close()
                return
            if not chunk:
                self.close()
                return
            self.inbuf += chunk
            got += len(chunk)
            if len(chunk) < _READ_CHUNK:
                break
        self._parse()

    def _parse(self) -> None:
        buf = self.inbuf
        start = 0
        n_lines = 0
        while not self.closed and not self.close_after_flush:
            i = buf.find(b"\n", start)
            if i < 0:
                break
            line = bytes(buf[start:i])
            start = i + 1
            if line.endswith(b"\r"):
                line = line[:-1]
            if len(line) > MAX_LINE:
                self._refuse_long_line()
                break
            n_lines += 1
            self.router._handle_line(self, line)
        if n_lines:
            get_metrics().inc("router.commands", n_lines)
        if start:
            del buf[:start]
        if len(buf) > MAX_LINE and not self.close_after_flush:
            # A newline-less line past the cap: refuse once, close — the
            # rest of the oversized line is garbage (native parity).
            self._refuse_long_line()
        self.worker.dirty_conns.add(self)

    def _refuse_long_line(self) -> None:
        slot = _Slot()
        self.slots.append(slot)
        self.complete(slot, b"ERROR line too long\r\n")
        self.close_after_flush = True

    # -- writing -------------------------------------------------------------
    def complete(self, slot: _Slot, data: bytes) -> None:
        if slot.done:
            return
        slot.data = data
        slot.done = True
        self.worker.dirty_conns.add(self)

    def flush(self) -> None:
        if self.closed:
            return
        while self.slots and self.slots[0].done:
            data = self.slots.popleft().data
            if data:
                self.out.append(memoryview(data))
                self.out_bytes += len(data)
        if self.out:
            try:
                self.out_bytes -= _send_vec(self.sock, self.out)
            except OSError:
                self.close()
                return
        self._update_interest()
        if not self.out and not self.slots and self.close_after_flush:
            self.close()

    def _update_interest(self) -> None:
        want_write = bool(self.out)
        pause = self.out_bytes > OUT_HIGH or (
            self.paused and self.out_bytes > OUT_LOW
        )
        mask = (0 if pause else _R) | (_W if want_write else 0)
        if want_write != self.want_write or pause != self.paused:
            self.want_write = want_write
            self.paused = pause
            try:
                self.worker.sel.modify(self.fd, mask or _R, ("conn", self))
            except (KeyError, ValueError, OSError):
                pass

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.worker.sel.unregister(self.fd)
        except (KeyError, ValueError, OSError):
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.worker.conns.discard(self)
        self.worker.dirty_conns.discard(self)


class _Upstream:
    """One pipelined backend connection (worker, partition). In-flight
    requests match responses strictly FIFO; multi-line answers (VALUES/
    KEYS blocks) consume their declared row count before the next match.
    """

    __slots__ = (
        "worker", "pid", "addr", "sock", "fd", "inbuf", "pending", "out",
        "cur", "need", "closed", "last_progress",
    )

    def __init__(
        self, worker: "_Worker", pid: int, addr: str, sock: socket.socket
    ) -> None:
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.worker = worker
        self.pid = pid
        self.addr = addr
        self.sock = sock
        self.fd = sock.fileno()
        self.inbuf = bytearray()
        # (kind, n, cont): kind "line" | "mget" (n = row count) | "keys".
        self.pending: deque[tuple[str, int, Callable]] = deque()
        self.out: deque = deque()
        self.cur: Optional[list[str]] = None
        self.need = 0
        self.closed = False
        self.last_progress = time.monotonic()

    def send(self, req: bytes, kind: str, n: int, cont: Callable) -> None:
        if not self.pending:
            self.last_progress = time.monotonic()
        self.pending.append((kind, n, cont))
        self.out.append(memoryview(req))
        self.worker.dirty_up.add(self)

    def flush(self) -> None:
        if self.closed or not self.out:
            return
        try:
            _send_vec(self.sock, self.out)
        except OSError as e:
            self.worker.reset_upstream(self, f"send: {e}")
            return
        if self.out:
            try:
                self.worker.sel.modify(self.fd, _R | _W, ("up", self))
            except (KeyError, ValueError, OSError):
                pass

    def on_readable(self) -> None:
        while True:
            try:
                chunk = self.sock.recv(_READ_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                self.worker.reset_upstream(self, f"recv: {e}")
                return
            if not chunk:
                self.worker.reset_upstream(self, "connection closed")
                return
            self.inbuf += chunk
            if len(chunk) < _READ_CHUNK:
                break
        self.last_progress = time.monotonic()
        buf = self.inbuf
        start = 0
        pending = self.pending
        dirty_conns = self.worker.dirty_conns
        while not self.closed:
            i = buf.find(b"\n", start)
            if i < 0:
                break
            raw = bytes(buf[start:i + 1])
            start = i + 1
            # Fast lane: a pipelined single-key forward whose answer is
            # not an error passes through as the raw byte slice — no
            # decode, no strip, no per-response closure.
            if (
                self.cur is None
                and pending
                and pending[0][0] == "fwd"
            ):
                _, _, (conn, slot, req) = pending.popleft()
                if raw[:5] == b"ERROR":
                    self.worker.router._fwd_error(conn, slot, req, raw)
                elif not slot.done:
                    slot.data = raw
                    slot.done = True
                    dirty_conns.add(conn)
                continue
            line_b = raw[:-2] if raw[-2:] == b"\r\n" else raw[:-1]
            self._feed_line(line_b.decode("utf-8", "surrogateescape"))
        if start:
            del buf[:start]
        if len(buf) > MAX_LINE + (1 << 16):
            self.worker.reset_upstream(self, "oversized response line")

    def _feed_line(self, line: str) -> None:
        if self.cur is not None:
            self.cur.append(line)
            if len(self.cur) - 1 >= self.need:
                res, self.cur = self.cur, None
                self._complete(res)
            return
        if not self.pending:
            # A response with nothing in flight: protocol desync —
            # nothing downstream can be trusted; reset.
            self.worker.reset_upstream(self, "unsolicited response")
            return
        kind, n, _ = self.pending[0]
        need = 0
        if kind == "mget" and line.startswith("VALUES "):
            need = n
        elif kind == "keys" and line.startswith("KEYS "):
            try:
                need = max(0, int(line[5:]))
            except ValueError:
                need = 0
        if need:
            self.cur = [line]
            self.need = need
        else:
            self._complete([line])

    def _complete(self, res: list[str]) -> None:
        _, _, cont = self.pending.popleft()
        self.last_progress = time.monotonic()
        try:
            cont(res)
        except Exception:
            get_metrics().inc("router.backend_errors")

    def fail_all(self) -> None:
        router = self.worker.router
        while self.pending:
            kind, _, cont = self.pending.popleft()
            try:
                if kind == "fwd":
                    conn, slot, req = cont
                    router._fwd_error(conn, slot, req, None)
                else:
                    cont(None)
            except Exception:
                get_metrics().inc("router.backend_errors")

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.worker.sel.unregister(self.fd)
        except (KeyError, ValueError, OSError):
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.worker.dirty_up.discard(self)


class _Worker(threading.Thread):
    """One io worker: private selector, private upstream pool, a wake
    pipe for cross-thread posts, and a timer heap for healing backoffs.
    Everything a worker owns is touched only on its own thread."""

    def __init__(self, router: "RequestPlaneRouter", idx: int) -> None:
        super().__init__(daemon=True, name=f"mkv-rplane-io{idx}")
        self.router = router
        self.idx = idx
        self.sel = selectors.DefaultSelector()
        self._rfd, self._wfd = os.pipe()
        os.set_blocking(self._rfd, False)
        os.set_blocking(self._wfd, False)
        self.sel.register(self._rfd, _R, ("wake", None))
        self._inbox: deque[Callable] = deque()
        self._inbox_mu = threading.Lock()
        self._timers: list = []
        self._timer_seq = 0
        self.conns: set[_ClientConn] = set()
        self.upstreams: dict[int, _Upstream] = {}
        self.up_rr: dict[int, int] = {}
        self.dirty_conns: set[_ClientConn] = set()
        self.dirty_up: set[_Upstream] = set()
        self.commands = 0
        self._stopped = False

    # -- cross-thread --------------------------------------------------------
    def post(self, fn: Callable) -> None:
        with self._inbox_mu:
            self._inbox.append(fn)
        try:
            os.write(self._wfd, b"x")
        except (BlockingIOError, OSError):
            pass  # pipe full: a wake is already pending

    def stop(self) -> None:
        self._stopped = True
        self.post(lambda: None)

    # -- worker-thread only --------------------------------------------------
    def add_timer(self, delay_s: float, fn: Callable) -> None:
        self._timer_seq += 1
        heapq.heappush(
            self._timers, (time.monotonic() + delay_s, self._timer_seq, fn)
        )

    def adopt(self, sock: socket.socket) -> None:
        conn = _ClientConn(self, sock)
        try:
            self.sel.register(conn.fd, _R, ("conn", conn))
        except (ValueError, OSError):
            sock.close()
            return
        self.conns.add(conn)

    def reset_upstream(self, up: _Upstream, why: str) -> None:
        if up.closed:
            return
        get_metrics().inc("router.upstream_resets")
        get_recorder().record(
            "router_upstream_reset", partition=up.pid, addr=up.addr,
            why=why, pending=len(up.pending),
        )
        if self.upstreams.get(up.pid) is up:
            del self.upstreams[up.pid]
            # Rotate the dial order so the redial tries the next replica
            # first instead of hammering the one that just died.
            self.up_rr[up.pid] = self.up_rr.get(up.pid, 0) + 1
        up.close()
        up.fail_all()

    def run(self) -> None:
        while not self._stopped:
            timeout = 0.5
            if self._timers:
                timeout = min(
                    timeout, max(0.0, self._timers[0][0] - time.monotonic())
                )
            try:
                events = self.sel.select(timeout)
            except OSError:
                break
            for key, mask in events:
                kind, obj = key.data
                if kind == "wake":
                    try:
                        while os.read(self._rfd, 4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                elif kind == "conn":
                    if mask & _R and not obj.closed:
                        obj.on_readable()
                elif kind == "up":
                    if mask & _W and not obj.closed:
                        obj.flush()
                    if mask & _R and not obj.closed:
                        obj.on_readable()
            while True:
                with self._inbox_mu:
                    if not self._inbox:
                        break
                    fn = self._inbox.popleft()
                try:
                    fn()
                except Exception:
                    get_metrics().inc("router.backend_errors")
            now = time.monotonic()
            while self._timers and self._timers[0][0] <= now:
                _, _, fn = heapq.heappop(self._timers)
                try:
                    fn()
                except Exception:
                    get_metrics().inc("router.backend_errors")
            # Hung-upstream guard: a backend that stops answering (but
            # keeps the socket open) would otherwise wedge its FIFO — and
            # every slot queued behind it — forever.
            if self.upstreams:
                for up in list(self.upstreams.values()):
                    if up.pending and (
                        now - up.last_progress > self.router.timeout
                    ):
                        self.reset_upstream(up, "response timeout")
            # Burst discipline: ONE flush per upstream, then one writev
            # per client connection, per pass.
            if self.dirty_up:
                for up in list(self.dirty_up):
                    up.flush()
                self.dirty_up.clear()
            if self.dirty_conns:
                dirty, self.dirty_conns = self.dirty_conns, set()
                for conn in dirty:
                    conn.flush()
        # teardown on the worker thread: nobody else touches these
        for conn in list(self.conns):
            conn.close()
        for up in list(self.upstreams.values()):
            up.close()
        try:
            self.sel.close()
        except OSError:
            pass
        os.close(self._rfd)
        os.close(self._wfd)


class RequestPlaneRouter:
    """The production request plane: one address for a partitioned
    cluster, pooled + pipelined + (optionally) lease-cached."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        seeds: Optional[list[str]] = None,
        timeout: float = 5.0,
        workers: int = 0,
        cache_bytes: int = 0,
        cache_max_age_ms: float = 2000.0,
        invalidation_transport=None,
        broker: Optional[str] = None,
        broker_port: int = 0,
        transport_kind: str = "framed",
        topic_prefix: str = "",
        metrics_port: Optional[int] = None,
        metrics_host: str = "127.0.0.1",
    ) -> None:
        if not seeds:
            raise ValueError("router needs at least one seed node")
        self.host = host
        self._port = port
        self.seeds = list(seeds)
        self.timeout = timeout
        n = workers or min(8, max(2, os.cpu_count() or 2))
        self._nworkers = n
        self._pmap: Optional[PartitionMap] = None
        self._map_mu = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self._workers: list[_Worker] = []
        self._rr = 0
        self.cache: Optional[LeaseCache] = None
        if cache_bytes > 0:
            self.cache = LeaseCache(
                cache_bytes,
                max_age_ms=cache_max_age_ms,
                lease_timeout_ms=max(1000.0, timeout * 1000.0),
            )
        self._transport = invalidation_transport
        self._own_transport = False
        if self._transport is None and broker:
            from merklekv_tpu_torch.cluster.transport import make_transport

            self._transport = make_transport(
                broker, broker_port, transport_kind,
                client_id=f"mkv-router-{os.getpid()}",
            )
            self._own_transport = True
        self._topic_prefix = topic_prefix
        self.feed: Optional[InvalidationFeed] = None
        self._metrics_port_arg = metrics_port
        self._metrics_host = metrics_host
        self._exporter = None
        self._keeper: Optional[threading.Thread] = None
        self._keeper_cond = threading.Condition()
        self._keeper_reqs: list[tuple[int, Callable]] = []
        self._last_refresh = 0.0
        self._gauges: list[tuple[str, Callable]] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self, map_wait_s: float = 10.0) -> "RequestPlaneRouter":
        deadline = time.monotonic() + map_wait_s
        while True:
            try:
                self._refresh_map_blocking(0)
                break
            except ClientConnectionError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        if self.cache is not None and self._transport is not None:
            self.feed = InvalidationFeed(
                self.cache, self._transport, self._topic_prefix
            )
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self._port))
        self._sock.listen(512)
        self._port = self._sock.getsockname()[1]
        for i in range(self._nworkers):
            w = _Worker(self, i)
            w.start()
            self._workers.append(w)
        self._keeper = threading.Thread(
            target=self._keeper_loop, daemon=True, name="mkv-rplane-map"
        )
        self._keeper.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="mkv-rplane-accept"
        )
        self._accept_thread.start()
        self._register_gauges()
        if self._metrics_port_arg is not None:
            from merklekv_tpu_torch.obs.exporter import MetricsExporter

            self._exporter = MetricsExporter(
                self._metrics_port_arg,
                host=self._metrics_host,
                health_fn=self._health_fields,
            )
            self._exporter.start()
        return self

    @property
    def port(self) -> int:
        return self._port

    @property
    def metrics_port(self) -> Optional[int]:
        return self._exporter.port if self._exporter is not None else None

    @property
    def map(self) -> Optional[PartitionMap]:
        return self._pmap

    def stop(self) -> None:
        self._stopped.set()
        with self._keeper_cond:
            self._keeper_cond.notify_all()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        for w in self._workers:
            w.stop()
        for w in self._workers:
            w.join(timeout=5)
        self._workers = []
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None
        if self.feed is not None:
            self.feed.close()
            self.feed = None
        if self._own_transport and self._transport is not None:
            try:
                self._transport.close()
            except Exception:
                pass
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None
        m = get_metrics()
        for name, fn in self._gauges:
            m.unregister_gauge(name, fn)
        self._gauges = []

    # -- observability -------------------------------------------------------
    def _register_gauges(self) -> None:
        m = get_metrics()
        pairs: list[tuple[str, Callable]] = [
            ("router.conns",
             lambda: sum(len(w.conns) for w in self._workers)),
            ("router.workers", lambda: len(self._workers)),
            ("router.inval_lag_ms",
             lambda: self.feed.last_lag_ms if self.feed else -1.0),
        ]
        if self.cache is not None:
            pairs += [
                ("router.cache_bytes", lambda: self.cache.bytes_used),
                ("router.cache_keys", lambda: self.cache.keys),
                ("router.leases_inflight",
                 lambda: self.cache.leases_inflight),
            ]
        for name, fn in pairs:
            m.register_gauge(name, fn, help=f"request plane: {name}")
            self._gauges.append((name, fn))

    def _health_fields(self) -> dict:
        pmap = self._pmap
        return {
            "role": "router",
            "partitions": pmap.count if pmap else 0,
            "epoch": pmap.epoch if pmap else 0,
            "workers": len(self._workers),
            "conns": sum(len(w.conns) for w in self._workers),
            "cache_keys": self.cache.keys if self.cache else 0,
            "cache_bytes": self.cache.bytes_used if self.cache else 0,
            "inval_lag_ms": round(
                self.feed.last_lag_ms if self.feed else -1.0, 3
            ),
        }

    def _stats_block(self) -> str:
        lines = [
            "STATS",
            f"total_commands:{sum(w.commands for w in self._workers)}",
            "active_connections:"
            f"{sum(len(w.conns) for w in self._workers)}",
            f"io_threads:{len(self._workers)}",
        ]
        for w in self._workers:
            lines.append(f"io_worker_{w.idx}_commands:{w.commands}")
        lines.append("END")
        return "\r\n".join(lines) + "\r\n"

    def _info_block(self) -> str:
        pmap = self._pmap
        lines = [
            "INFO",
            "role:router",
            f"partitions:{pmap.count if pmap else 0}",
            f"epoch:{pmap.epoch if pmap else 0}",
            f"workers:{len(self._workers)}",
            "END",
        ]
        return "\r\n".join(lines) + "\r\n"

    def _metrics_block(self) -> str:
        snap = get_metrics().snapshot()["counters"]
        lines = ["METRICS"]
        for name in sorted(snap):
            if name.startswith(("router.", "transport.")):
                lines.append(f"{name}:{snap[name]}")
        pmap = self._pmap
        live = {
            "router.partitions": pmap.count if pmap else 0,
            "router.epoch": pmap.epoch if pmap else 0,
            "router.workers": len(self._workers),
            "router.conns": sum(len(w.conns) for w in self._workers),
            "router.cache_keys": self.cache.keys if self.cache else 0,
            "router.cache_bytes": (
                self.cache.bytes_used if self.cache else 0
            ),
            "router.leases_inflight": (
                self.cache.leases_inflight if self.cache else 0
            ),
            "router.inval_lag_ms": round(
                self.feed.last_lag_ms if self.feed else -1.0, 3
            ),
        }
        for name in sorted(live):
            lines.append(f"{name}:{live[name]}")
        lines.append("END")
        return "\r\n".join(lines) + "\r\n"

    # -- partition map -------------------------------------------------------
    def _refresh_map_blocking(self, min_epoch: int) -> None:
        """Newest reachable map (seeds, then known replicas). Runs on the
        keeper thread (or start()); workers never block on this."""
        candidates = list(self.seeds)
        cur = self._pmap
        if cur is not None:
            for reps in cur.replicas:
                for a in reps:
                    if a not in candidates:
                        candidates.append(a)
        fresh = None
        errors: list[str] = []
        for addr in candidates:
            host, _, port = addr.rpartition(":")
            try:
                with MerkleKVClient(
                    host, int(port), timeout=self.timeout
                ) as c:
                    m = c.partition_map()
            except (MerkleKVError, OSError, ValueError) as e:
                errors.append(f"{addr}: {e}")
                continue
            if fresh is None or m.epoch > fresh.epoch:
                fresh = m
            if fresh.epoch >= min_epoch > 0:
                break
        if fresh is None:
            raise ClientConnectionError(
                "router: no reachable node served a partition map: "
                + "; ".join(errors[:4])
            )
        with self._map_mu:
            cur = self._pmap
            if cur is None or fresh.epoch >= cur.epoch:
                epoch_flip = cur is not None and fresh.epoch > cur.epoch
                self._pmap = fresh
                get_metrics().inc("router.map_refreshes")
                if epoch_flip:
                    # Partition ids renumber across an epoch: cached
                    # entries' pids and the feed's per-topic HWMs are
                    # meaningless now. Drop both; refills stamp fresh.
                    if self.cache is not None:
                        self.cache.clear()
                    if self.feed is not None:
                        self.feed.reset()
                    get_recorder().record(
                        "router_map_epoch", epoch=fresh.epoch,
                        partitions=fresh.count,
                    )
        self._last_refresh = time.monotonic()

    def request_refresh(self, min_epoch: int, cb: Callable) -> None:
        """Queue a map refresh on the keeper thread; ``cb(ok)`` fires when
        it settles (posted by the keeper — the caller passes a closure
        that re-posts to its worker)."""
        with self._keeper_cond:
            self._keeper_reqs.append((min_epoch, cb))
            self._keeper_cond.notify()

    def _keeper_loop(self) -> None:
        while not self._stopped.is_set():
            with self._keeper_cond:
                while not self._keeper_reqs and not self._stopped.is_set():
                    self._keeper_cond.wait(timeout=0.5)
                if self._stopped.is_set():
                    return
                batch, self._keeper_reqs = self._keeper_reqs, []
            min_epoch = max(e for e, _ in batch)
            cur = self._pmap
            ok = True
            if cur is not None and cur.epoch >= min_epoch and (
                time.monotonic() - self._last_refresh < 0.05
            ):
                pass  # a refresh just landed past the requested epoch
            else:
                try:
                    self._refresh_map_blocking(min_epoch)
                except ClientConnectionError:
                    ok = False
            for _, cb in batch:
                try:
                    cb(ok)
                except Exception:
                    pass

    # -- serving -------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            w = self._workers[self._rr % len(self._workers)]
            self._rr += 1
            w.post(lambda s=conn, w=w: w.adopt(s))

    def _handle_line(self, conn: _ClientConn, line_b: bytes) -> None:
        worker = conn.worker
        worker.commands += 1
        if self._fast_route(conn, line_b):
            return
        line = line_b.decode("utf-8", "surrogateescape")
        verb, _, rest = line.partition(" ")
        verb = verb.upper()
        slot = _Slot()
        conn.slots.append(slot)
        if verb == "PING":
            conn.complete(
                slot, self._enc(f"PONG {rest}\r\n" if rest else "PONG \r\n")
            )
            return
        if verb == "PARTMAP":
            conn.complete(slot, self._enc(self._pmap.wire()))
            return
        if verb == "METRICS":
            conn.complete(slot, self._enc(self._metrics_block()))
            return
        if verb == "STATS":
            conn.complete(slot, self._enc(self._stats_block()))
            return
        if verb == "INFO":
            conn.complete(slot, self._enc(self._info_block()))
            return
        if verb == "PEERS":
            conn.complete(slot, b"PEERS 0\r\nEND\r\n")
            return
        self._route(conn, slot, verb, rest)

    @staticmethod
    def _enc(s: str) -> bytes:
        return s.encode("utf-8", "surrogateescape")

    # -- bytes fast lane -----------------------------------------------------
    def _fast_route(self, conn: _ClientConn, line_b: bytes) -> bool:
        """The zero-decode forward: an uppercase single-key command whose
        shape validates and whose upstream is already dialable is queued
        as a ("fwd", conn, slot, line) pending entry — the response comes
        back as a raw byte slice. Returns False (having changed NOTHING)
        whenever the str machinery must take over: irregular shape, a
        cached GET, or an upstream that needs the healing ladder."""
        sp = line_b.find(b" ")
        if sp <= 0:
            return False
        shape = _FAST_VERBS.get(line_b[:sp])
        if shape is None:
            return False
        rest = line_b[sp + 1:]
        ksp = rest.find(b" ")
        cache = self.cache
        if shape == 0:  # GET <key>
            if ksp >= 0 or not rest or cache is not None:
                return False  # vs= token / malformed / cache path
            key = rest
        elif shape == 1:  # SET/APPEND/PREPEND <key> <value>
            if ksp <= 0:
                return False
            key = rest[:ksp]
        else:  # DELETE/DEL <key>
            if ksp >= 0 or not rest:
                return False
            key = rest
        try:
            pid = self._pmap.partition_for_key(key)
            up = self._get_upstream(conn.worker, pid)
        except (_Moved, _Unreachable):
            return False
        if cache is not None and shape != 0:
            cache.invalidate(key.decode("utf-8", "surrogateescape"))
        slot = _Slot()
        conn.slots.append(slot)
        up.send(line_b + b"\r\n", "fwd", 0, (conn, slot, line_b))
        return True

    def _fwd_error(
        self, conn: _ClientConn, slot: _Slot, req: bytes,
        raw: Optional[bytes],
    ) -> None:
        """A fast-lane forward hit the slow cases: upstream lost (raw is
        None) or an ERROR answer. Re-enter the healing ladder with the
        original request line — identical outcome to the str path."""
        if slot.done:
            return
        line = req.decode("utf-8", "surrogateescape")
        verb, _, rest = line.partition(" ")
        retry = lambda: self._route(conn, slot, verb, rest)  # noqa: E731
        if raw is None:
            self._heal_or_fail(conn, slot, "lost", retry,
                               _BUSY_UPSTREAM_LOST + "\r\n")
            return
        header = raw.decode("utf-8", "surrogateescape").rstrip("\r\n")
        if header.startswith("ERROR MOVED "):
            fields = header.split(" ")
            epoch = int(fields[3]) if len(fields) >= 4 else 0
            self._heal_or_fail(conn, slot, "moved", retry,
                               header + "\r\n", min_epoch=epoch)
            return
        if header.startswith("ERROR BUSY"):
            self._heal_or_fail(conn, slot, "busy", retry, header + "\r\n")
            return
        conn.complete(slot, raw)

    def _fail(self, conn: _ClientConn, slot: _Slot, msg: str) -> None:
        conn.complete(slot, self._enc(msg if msg.endswith("\r\n") else msg + "\r\n"))

    # -- healing -------------------------------------------------------------
    def _heal_or_fail(
        self,
        conn: _ClientConn,
        slot: _Slot,
        kind: str,
        retry: Callable,
        final: str,
        min_epoch: int = 0,
    ) -> None:
        """The bounded MOVED/BUSY/lost-upstream healing ladder, pooled
        edition: backoff on a worker timer (never a sleeping thread), a
        map refresh on the keeper when the condition implies a stale map,
        then the retry closure — until the PARTITION_MOVED budget is
        spent and ``final`` surfaces to the client."""
        worker = conn.worker
        attempts = PARTITION_MOVED.attempts or 1
        if slot.attempt + 1 >= attempts:
            self._fail(conn, slot, final)
            return
        delay = PARTITION_MOVED.backoff(slot.attempt)
        slot.attempt += 1
        m = get_metrics()
        if kind == "moved":
            m.inc("router.moved_refreshes")
        elif kind == "busy":
            m.inc("router.busy_retries")
        if kind in ("moved", "lost"):
            def after_refresh(ok: bool) -> None:
                worker.post(lambda: worker.add_timer(delay, retry))

            self.request_refresh(min_epoch, after_refresh)
        else:
            worker.add_timer(delay, retry)

    # -- routing -------------------------------------------------------------
    def _route(
        self, conn: _ClientConn, slot: _Slot, verb: str, rest: str
    ) -> None:
        try:
            self._route_inner(conn, slot, verb, rest)
        except _Moved as e:
            retry = lambda: self._route(conn, slot, verb, rest)  # noqa: E731
            self._heal_or_fail(
                conn, slot, "moved", retry,
                f"ERROR MOVED {e.pid} {e.epoch}\r\n", min_epoch=e.epoch,
            )
        except _Unreachable as e:
            get_metrics().inc("router.backend_errors")
            retry = lambda: self._route(conn, slot, verb, rest)  # noqa: E731
            self._heal_or_fail(
                conn, slot, "lost", retry,
                f"ERROR BUSY router: {e} (retry)\r\n",
            )
        except Exception as e:
            get_metrics().inc("router.backend_errors")
            self._fail(conn, slot, f"ERROR router: {e}\r\n")

    def _route_inner(
        self, conn: _ClientConn, slot: _Slot, verb: str, rest: str
    ) -> None:
        pmap = self._pmap
        slot.parts = None
        slot.outstanding = 0
        if verb == "GET":
            self._route_get(conn, slot, rest, pmap)
            return
        if verb in ("INC", "DEC"):
            key, _, amt_s = rest.strip().partition(" ")
            if not key:
                self._fail(conn, slot,
                           f"ERROR {verb} command requires a key\r\n")
                return
            if amt_s:
                try:
                    int(amt_s)
                except ValueError:
                    self._fail(
                        conn, slot,
                        f"ERROR {verb} command amount must be a valid "
                        "number\r\n",
                    )
                    return
            self._invalidate_write(key)
            self._forward_line(
                conn, slot, verb, rest, pmap.partition_for_key(key)
            )
            return
        if verb in _SINGLE_KEY:
            if _SINGLE_KEY[verb]:
                key, sep, _value = rest.partition(" ")
                if not sep or not key:
                    self._fail(
                        conn, slot,
                        f"ERROR {verb} command requires a key and value\r\n",
                    )
                    return
                self._invalidate_write(key)
            else:  # DEL / DELETE
                key = rest.strip()
                if not key or " " in key:
                    self._fail(conn, slot,
                               f"ERROR {verb} command requires a key\r\n")
                    return
                self._invalidate_write(key)
            self._forward_line(
                conn, slot, verb, rest, pmap.partition_for_key(key)
            )
            return
        if verb == "EXISTS":
            keys = rest.split()
            if not keys:
                self._fail(
                    conn, slot,
                    "ERROR EXISTS command requires at least one key\r\n",
                )
                return
            groups = self._group(keys, pmap)
            self._fan_out(
                conn, slot, verb, rest,
                [(pid, f"EXISTS {' '.join(sub)}", "line", 0)
                 for pid, sub in groups],
                lambda parts: self._merge_exists(parts),
            )
            return
        if verb == "MGET":
            keys = rest.split()
            if not keys:
                self._fail(
                    conn, slot,
                    "ERROR MGET command requires at least one key\r\n",
                )
                return
            groups = self._group(keys, pmap)
            self._fan_out(
                conn, slot, verb, rest,
                [(pid, f"MGET {' '.join(sub)}", "mget", len(sub))
                 for pid, sub in groups],
                lambda parts: self._merge_mget(parts, keys),
            )
            return
        if verb == "MSET":
            args = rest.split()
            if not args or len(args) % 2:
                self._fail(
                    conn, slot,
                    "ERROR MSET command requires an even number of "
                    "arguments (key-value pairs)\r\n",
                )
                return
            pairs = dict(zip(args[::2], args[1::2]))
            for k in pairs:
                self._invalidate_write(k)
            groups = self._group(list(pairs), pmap)
            reqs = []
            for pid, sub in groups:
                flat = " ".join(f"{k} {pairs[k]}" for k in sub)
                reqs.append((pid, f"MSET {flat}", "line", 0))
            self._fan_out(
                conn, slot, verb, rest, reqs,
                lambda parts: self._merge_ok(parts),
            )
            return
        if verb == "SCAN":
            prefix = rest.strip()
            cmd = f"SCAN {prefix}" if prefix else "SCAN"
            self._fan_out(
                conn, slot, verb, rest,
                [(pid, cmd, "keys", 0) for pid in range(pmap.count)],
                lambda parts: self._merge_scan(parts),
            )
            return
        if verb == "DBSIZE":
            self._fan_out(
                conn, slot, verb, rest,
                [(pid, "DBSIZE", "line", 0) for pid in range(pmap.count)],
                lambda parts: self._merge_dbsize(parts),
            )
            return
        self._fail(
            conn, slot,
            f"ERROR router: unsupported verb {verb} "
            "(connect to a node directly or use a partition-aware "
            "client)\r\n",
        )

    def _invalidate_write(self, key: str) -> None:
        """Write-through drop: read-your-writes THROUGH this router; the
        replication event is the authoritative invalidation for every
        other path."""
        if self.cache is not None:
            self.cache.invalidate(key)

    # -- GET + lease cache ---------------------------------------------------
    def _route_get(
        self, conn: _ClientConn, slot: _Slot, rest: str, pmap: PartitionMap
    ) -> None:
        toks = rest.split()
        stamp = False
        force = False
        if len(toks) == 2 and toks[1].startswith("vs="):
            key = toks[0]
            stamp = True
            force = toks[1] == "vs=03"
        elif len(toks) == 1:
            key = toks[0]
        else:
            self._fail(conn, slot, "ERROR GET command requires a key\r\n")
            return
        pid = pmap.partition_for_key(key)
        cache = self.cache
        if cache is None or force:
            if force and cache is not None:
                cache.invalidate(key)
            self._forward_get_plain(conn, slot, key, pid, stamp)
            return
        worker = conn.worker

        def waiter(value, age_ms, error) -> None:
            worker.post(
                lambda: self._finish_get(conn, slot, value, age_ms, error,
                                         stamp)
            )

        res = cache.begin_get(key, pid, waiter)
        if res is WAIT:
            return
        if res is not LEAD:
            value, age_ms = res
            self._finish_get(conn, slot, value, age_ms, None, stamp)
            return
        self._lease_fill(conn, slot, key, pid, stamp)

    def _lease_fill(
        self, conn: _ClientConn, slot: _Slot, key: str, pid: int, stamp: bool
    ) -> None:
        """The lease holder's fill: ONE upstream GET answers this slot and
        every waiter. Healing retries keep the lease; only the final
        failure releases it with an error."""
        cache = self.cache

        def settle(value, error) -> None:
            waiters = cache.finish_fill(key, value, pid, error=error)
            self._finish_get(conn, slot, value, 0.0, error, stamp)
            for w in waiters:
                w(value, 0.0, error)

        def retry() -> None:
            # Re-resolve the partition: the map may have flipped.
            self._lease_fill(
                conn, slot, key, self._pmap.partition_for_key(key), stamp
            )

        def cont(res) -> None:
            if res is None:
                self._heal_lease(conn, slot, "lost", retry, settle,
                                 _BUSY_UPSTREAM_LOST)
                return
            header = res[0]
            if header.startswith("ERROR MOVED "):
                fields = header.split(" ")
                epoch = int(fields[3]) if len(fields) >= 4 else 0
                self._heal_lease(conn, slot, "moved", retry, settle,
                                 header + "\r\n", min_epoch=epoch)
                return
            if header.startswith("ERROR BUSY"):
                self._heal_lease(conn, slot, "busy", retry, settle,
                                 header + "\r\n")
                return
            if header.startswith("ERROR"):
                settle(None, header + "\r\n")
                return
            if header.startswith("VALUE "):
                settle(header[6:], None)
            else:  # NOT_FOUND — a clean answer, not cached
                settle(None, None)

        try:
            up = self._get_upstream(conn.worker, pid)
        except _Moved as e:
            retry2 = retry
            self._heal_lease(
                conn, slot, "moved", retry2, settle,
                f"ERROR MOVED {e.pid} {e.epoch}\r\n", min_epoch=e.epoch,
            )
            return
        except _Unreachable as e:
            self._heal_lease(conn, slot, "lost", retry, settle,
                             f"ERROR BUSY router: {e} (retry)\r\n")
            return
        up.send(self._enc(f"GET {key}\r\n"), "line", 0, cont)

    def _heal_lease(
        self, conn, slot, kind, retry, settle, final, min_epoch=0
    ) -> None:
        """Healing for the lease holder: like _heal_or_fail, but the
        terminal failure must RELEASE the lease (settle with error) so
        waiters are never stranded."""
        worker = conn.worker
        attempts = PARTITION_MOVED.attempts or 1
        if slot.attempt + 1 >= attempts:
            settle(None, final)
            return
        delay = PARTITION_MOVED.backoff(slot.attempt)
        slot.attempt += 1
        m = get_metrics()
        if kind == "moved":
            m.inc("router.moved_refreshes")
        elif kind == "busy":
            m.inc("router.busy_retries")
        if kind in ("moved", "lost"):
            self.request_refresh(
                min_epoch,
                lambda ok: worker.post(
                    lambda: worker.add_timer(delay, retry)
                ),
            )
        else:
            worker.add_timer(delay, retry)

    def _finish_get(
        self, conn, slot, value, age_ms, error, stamp: bool
    ) -> None:
        if error is not None:
            self._fail(conn, slot, error)
            return
        if value is None:
            conn.complete(slot, b"NOT_FOUND\r\n")
            return
        if stamp:
            bound = int(self.cache.max_age_ms) if self.cache else 0
            conn.complete(
                slot,
                self._enc(f"VALUE vs={int(age_ms)}:{bound} {value}\r\n"),
            )
        else:
            conn.complete(slot, self._enc(f"VALUE {value}\r\n"))

    def _forward_get_plain(
        self, conn, slot, key: str, pid: int, stamp: bool
    ) -> None:
        def retry() -> None:
            self._forward_get_plain(
                conn, slot, key, self._pmap.partition_for_key(key), stamp
            )

        def cont(res) -> None:
            if res is None:
                self._heal_or_fail(conn, slot, "lost", retry,
                                   _BUSY_UPSTREAM_LOST + "\r\n")
                return
            header = res[0]
            if header.startswith("ERROR MOVED "):
                fields = header.split(" ")
                epoch = int(fields[3]) if len(fields) >= 4 else 0
                self._heal_or_fail(conn, slot, "moved", retry,
                                   header + "\r\n", min_epoch=epoch)
                return
            if header.startswith("ERROR BUSY"):
                self._heal_or_fail(conn, slot, "busy", retry,
                                   header + "\r\n")
                return
            if header.startswith("VALUE ") and stamp:
                bound = int(self.cache.max_age_ms) if self.cache else 0
                self._finish_get(conn, slot, header[6:], 0.0, None, True)
                return
            conn.complete(slot, self._enc(header + "\r\n"))

        try:
            up = self._get_upstream(conn.worker, pid)
        except (_Moved, _Unreachable):
            raise
        up.send(self._enc(f"GET {key}\r\n"), "line", 0, cont)

    # -- single-key forward --------------------------------------------------
    def _forward_line(
        self, conn: _ClientConn, slot: _Slot, verb: str, rest: str, pid: int
    ) -> None:
        def retry() -> None:
            self._route(conn, slot, verb, rest)

        def cont(res) -> None:
            if slot.done:
                return
            if res is None:
                self._heal_or_fail(conn, slot, "lost", retry,
                                   _BUSY_UPSTREAM_LOST + "\r\n")
                return
            header = res[0]
            if header.startswith("ERROR MOVED "):
                fields = header.split(" ")
                epoch = int(fields[3]) if len(fields) >= 4 else 0
                self._heal_or_fail(conn, slot, "moved", retry,
                                   header + "\r\n", min_epoch=epoch)
                return
            if header.startswith("ERROR BUSY"):
                self._heal_or_fail(conn, slot, "busy", retry,
                                   header + "\r\n")
                return
            conn.complete(slot, self._enc(header + "\r\n"))

        up = self._get_upstream(conn.worker, pid)
        up.send(self._enc(f"{verb} {rest}\r\n"), "line", 0, cont)

    # -- fan-out -------------------------------------------------------------
    def _fan_out(
        self,
        conn: _ClientConn,
        slot: _Slot,
        verb: str,
        rest: str,
        reqs: list[tuple[int, str, str, int]],
        merge: Callable[[dict], str],
    ) -> None:
        """Dispatch per-partition sub-requests concurrently (pipelined on
        each upstream), merge when the LAST answer lands. Any MOVED/BUSY/
        lost sub-answer retries the whole command under the healing
        budget — sub-results are cheap to re-ask, ordering is not."""
        slot.parts = {}
        slot.outstanding = len(reqs)
        worker = conn.worker
        get_metrics().inc("router.fanout_subrequests", len(reqs))

        def retry() -> None:
            self._route(conn, slot, verb, rest)

        def arrived(pid: int, res) -> None:
            if slot.done or slot.parts is None:
                return
            slot.parts[pid] = res
            slot.outstanding -= 1
            if slot.outstanding > 0:
                return
            parts, slot.parts = slot.parts, None
            self._settle_fan_out(conn, slot, parts, retry, merge)

        ups = {}
        try:
            for pid, _cmd, _kind, _n in reqs:
                if pid not in ups:
                    ups[pid] = self._get_upstream(worker, pid)
        except _Moved as e:
            self._heal_or_fail(
                conn, slot, "moved", retry,
                f"ERROR MOVED {e.pid} {e.epoch}\r\n", min_epoch=e.epoch,
            )
            return
        except _Unreachable as e:
            self._heal_or_fail(conn, slot, "lost", retry,
                               f"ERROR BUSY router: {e} (retry)\r\n")
            return
        for pid, cmd, kind, n in reqs:
            ups[pid].send(
                self._enc(cmd + "\r\n"), kind, n,
                lambda res, pid=pid: arrived(pid, res),
            )

    def _settle_fan_out(
        self, conn, slot, parts: dict, retry, merge
    ) -> None:
        moved_epoch = None
        busy = False
        lost = False
        other_error = None
        for res in parts.values():
            if res is None:
                lost = True
                continue
            header = res[0]
            if header.startswith("ERROR MOVED "):
                fields = header.split(" ")
                moved_epoch = max(
                    moved_epoch or 0,
                    int(fields[3]) if len(fields) >= 4 else 0,
                )
            elif header.startswith("ERROR BUSY"):
                busy = True
            elif header.startswith("ERROR"):
                other_error = header
        if moved_epoch is not None:
            self._heal_or_fail(
                conn, slot, "moved", retry,
                f"ERROR MOVED 0 {moved_epoch}\r\n", min_epoch=moved_epoch,
            )
            return
        if lost:
            self._heal_or_fail(conn, slot, "lost", retry,
                               _BUSY_UPSTREAM_LOST + "\r\n")
            return
        if busy:
            self._heal_or_fail(conn, slot, "busy", retry,
                               "ERROR BUSY router: partition busy\r\n")
            return
        if other_error is not None:
            self._fail(conn, slot, other_error + "\r\n")
            return
        try:
            conn.complete(slot, self._enc(merge(parts)))
        except Exception as e:
            get_metrics().inc("router.backend_errors")
            self._fail(conn, slot, f"ERROR router: {e}\r\n")

    # -- merges (byte-identical to the thin router's shapes) -----------------
    @staticmethod
    def _merge_exists(parts: dict) -> str:
        total = 0
        for res in parts.values():
            total += int(res[0][7:])  # "EXISTS <n>"
        return f"EXISTS {total}\r\n"

    @staticmethod
    def _merge_mget(parts: dict, keys: list[str]) -> str:
        merged: dict[str, Optional[str]] = {}
        for res in parts.values():
            header = res[0]
            if header == "NOT_FOUND":
                continue  # that group found nothing; rows absent
            for row in res[1:]:
                k, _, v = row.partition(" ")
                merged[k] = None if v == "NOT_FOUND" else v
        found = sum(1 for k in set(keys) if merged.get(k) is not None)
        if found == 0:
            return "NOT_FOUND\r\n"
        body = "".join(
            f"{k} {merged[k] if merged.get(k) is not None else 'NOT_FOUND'}"
            "\r\n"
            for k in keys
        )
        return f"VALUES {found}\r\n{body}"

    @staticmethod
    def _merge_ok(parts: dict) -> str:
        return "OK\r\n"

    @staticmethod
    def _merge_scan(parts: dict) -> str:
        keys: list[str] = []
        for res in parts.values():
            keys += res[1:]
        keys.sort()
        body = "".join(f"{k}\r\n" for k in keys)
        return f"KEYS {len(keys)}\r\n{body}"

    @staticmethod
    def _merge_dbsize(parts: dict) -> str:
        total = 0
        for res in parts.values():
            total += int(res[0][7:])  # "DBSIZE <n>"
        return f"DBSIZE {total}\r\n"

    @staticmethod
    def _group(
        keys: list[str], pmap: PartitionMap
    ) -> list[tuple[int, list[str]]]:
        groups: dict[int, list[str]] = {}
        for k in keys:
            groups.setdefault(pmap.partition_for_key(k), []).append(k)
        return sorted(groups.items())

    # -- upstream pool -------------------------------------------------------
    def _get_upstream(self, worker: _Worker, pid: int) -> _Upstream:
        up = worker.upstreams.get(pid)
        if up is not None and not up.closed:
            return up
        pmap = self._pmap
        if not 0 <= pid < pmap.count:
            # A refresh shrank the map between routing and dialing: heal
            # like a MOVED answer, never an IndexError.
            raise _Moved(pid, pmap.epoch)
        reps = list(pmap.replicas[pid])
        rot = worker.up_rr.get(pid, 0) % len(reps)
        order = reps[rot:] + reps[:rot]
        last: Optional[Exception] = None
        for i, addr in enumerate(order):
            host, _, port = addr.rpartition(":")
            try:
                sock = socket.create_connection(
                    (host, int(port)), timeout=min(1.0, self.timeout)
                )
            except OSError as e:
                last = e
                continue
            up = _Upstream(worker, pid, addr, sock)
            try:
                worker.sel.register(up.fd, _R, ("up", up))
            except (ValueError, OSError) as e:
                sock.close()
                last = e
                continue
            worker.upstreams[pid] = up
            worker.up_rr[pid] = (rot + i) % len(reps)
            get_metrics().inc("router.upstream_dials")
            return up
        raise _Unreachable(f"partition {pid} unreachable: {last}")


def main(argv: list[str]) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="merklekv_tpu_torch router")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7400)
    p.add_argument(
        "--seeds",
        required=True,
        help="comma-separated node addresses to bootstrap the partition "
        "map from (any cluster member)",
    )
    p.add_argument(
        "--workers", type=int, default=0,
        help="io worker pool width (0 = auto)",
    )
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument(
        "--cache-mb", type=float, default=0.0,
        help="hot-key read cache budget in MiB (0 = caching off)",
    )
    p.add_argument(
        "--cache-max-age-ms", type=float, default=2000.0,
        help="hard staleness bound: a cached answer older than this is "
        "never served (the vs= stamp's bound field)",
    )
    p.add_argument(
        "--broker", default="",
        help="replication broker host for event-driven cache "
        "invalidation (the same fabric the replica groups publish on)",
    )
    p.add_argument("--broker-port", type=int, default=0)
    p.add_argument(
        "--transport", default="framed", choices=["framed", "mqtt"],
    )
    p.add_argument(
        "--topic-prefix", default="",
        help="replication topic prefix (must match the cluster's "
        "[replication] topic_prefix)",
    )
    p.add_argument(
        "--metrics-port", type=int,
        help="serve Prometheus /metrics (+/healthz) on this HTTP port "
        "(-1: ephemeral)",
    )
    p.add_argument(
        "--legacy-threads", action="store_true",
        help="run the old thread-per-connection thin router instead "
        "(the measured A/B baseline; no pipelining, no cache)",
    )
    args = p.parse_args(argv)
    seeds = [s.strip() for s in args.seeds.split(",") if s.strip()]
    if args.legacy_threads:
        from merklekv_tpu_torch.cluster.router import PartitionRouter

        router = PartitionRouter(
            args.host, args.port, seeds, timeout=args.timeout
        ).start()
    else:
        router = RequestPlaneRouter(
            args.host,
            args.port,
            seeds,
            timeout=args.timeout,
            workers=args.workers,
            cache_bytes=int(args.cache_mb * (1 << 20)),
            cache_max_age_ms=args.cache_max_age_ms,
            broker=args.broker or None,
            broker_port=args.broker_port,
            transport_kind=args.transport,
            topic_prefix=args.topic_prefix,
            metrics_port=args.metrics_port,
        ).start()
    print(
        f"merklekv_tpu_torch router listening on {args.host}:{router.port} "
        f"({router.map.count} partitions, epoch {router.map.epoch})",
        flush=True,
    )
    if getattr(router, "metrics_port", None) is not None:
        print(f"metrics: http://127.0.0.1:{router.metrics_port}/metrics",
              flush=True)
    try:
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
