"""Thin partition router: the dumb-client fallback of partitioned mode.

A copy of ``merklekv_tpu/cluster/router.py``, its imports pointed at the port's modules.

Smart clients (client.PartitionedClient) route key -> partition
themselves. Everything else — the 13 language SDKs, redis-cli-style
tools — can point at ONE router address instead: the router holds the
cluster's partition map, parses just enough of each request line to find
the key(s), forwards to the owning partition's replica group, and relays
the response. Multi-key verbs (MGET/MSET/EXISTS) fan out per partition
and merge; SCAN/DBSIZE aggregate across all partitions.

Deliberately THIN: thread-per-connection, one backend connection per
(client connection, partition), no caching, no pipelining beyond the
backend client's own. A MOVED answer from a backend (the router's map
went stale mid-rebalance) refreshes the shared map and re-routes under
the bounded PARTITION_MOVED backoff policy; a BUSY answer (the moving
range's write fence during a live split's flip window) waits the same
policy out — the router serves straight through a rebalance, it just
pays refreshes.

Run: ``python -m merklekv_tpu_torch router --port 7400 --seeds host:7001,host:7003``.
"""

from __future__ import annotations

import socket
import sys
import threading
import time
from typing import Optional

from merklekv_tpu_torch.client import (
    ConnectionError as ClientConnectionError,
    MerkleKVClient,
    MerkleKVError,
    MovedError,
    ProtocolError,
    ServerBusyError,
)
from merklekv_tpu_torch.cluster.partmap import PartitionMap
from merklekv_tpu_torch.cluster.retry import PARTITION_MOVED
from merklekv_tpu_torch.utils.tracing import get_metrics

__all__ = ["PartitionRouter"]

# Single-key verbs the router forwards verbatim (verb -> needs_value).
# INC/DEC route separately (their optional amount argument).
_SINGLE_KEY = {
    "GET": False,
    "DELETE": False,
    "DEL": False,
    "SET": True,
    "APPEND": True,
    "PREPEND": True,
}


class PartitionRouter:
    """TCP proxy routing the text protocol across a partitioned cluster."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        seeds: Optional[list[str]] = None,
        timeout: float = 5.0,
    ) -> None:
        if not seeds:
            raise ValueError("router needs at least one seed node")
        self.host = host
        self._port = port
        self.seeds = list(seeds)
        self.timeout = timeout
        self._map: Optional[PartitionMap] = None
        self._map_mu = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self, map_wait_s: float = 10.0) -> "PartitionRouter":
        deadline = time.monotonic() + map_wait_s
        while True:
            try:
                self.refresh_map()
                break
            except ClientConnectionError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self._port))
        self._sock.listen(128)
        self._port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="mkv-router-accept"
        )
        self._accept_thread.start()
        return self

    @property
    def port(self) -> int:
        return self._port

    @property
    def map(self) -> Optional[PartitionMap]:
        with self._map_mu:
            return self._map

    def stop(self) -> None:
        self._stopped.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None

    # -- map ----------------------------------------------------------------
    def refresh_map(self, min_epoch: int = 0) -> None:
        """Newest reachable map (seeds, then known replicas); raises
        ClientConnectionError when nobody serves one. Shared across every
        connection thread under the map lock."""
        with self._map_mu:
            candidates = list(self.seeds)
            if self._map is not None:
                for reps in self._map.replicas:
                    for a in reps:
                        if a not in candidates:
                            candidates.append(a)
            best = self._map
        fresh = None
        errors: list[str] = []
        for addr in candidates:
            host, _, port = addr.rpartition(":")
            try:
                with MerkleKVClient(host, int(port),
                                    timeout=self.timeout) as c:
                    m = c.partition_map()
            except (MerkleKVError, ValueError) as e:
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
            if best is None or fresh.epoch >= best.epoch:
                self._map = fresh
                get_metrics().inc("router.map_refreshes")

    # -- serving -------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._serve_conn,
                args=(conn,),
                daemon=True,
                name="mkv-router-conn",
            ).start()

    # Request-line byte cap, mirroring the native server's default
    # [server] max_line_bytes: without it one dumb client streaming a
    # newline-less line would balloon the router's memory unboundedly.
    MAX_LINE = 1 << 20

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        backends: dict[int, MerkleKVClient] = {}
        f = conn.makefile("rb")
        try:
            while not self._stopped.is_set():
                raw = f.readline(self.MAX_LINE + 1)
                if not raw:
                    return
                if len(raw) > self.MAX_LINE and not raw.endswith(b"\n"):
                    # Same refusal as the native server: answer once,
                    # close — the rest of the oversized line is garbage.
                    conn.sendall(b"ERROR line too long\r\n")
                    return
                line = raw.rstrip(b"\r\n").decode("utf-8", "surrogateescape")
                resp = self._dispatch(line, backends)
                conn.sendall(resp.encode("utf-8", "surrogateescape"))
        except OSError:
            pass
        finally:
            for b in backends.values():
                b.close()
            try:
                conn.close()
            except OSError:
                pass

    def _backend(
        self, pid: int, backends: dict[int, MerkleKVClient]
    ) -> MerkleKVClient:
        c = backends.get(pid)
        if c is not None:
            return c
        with self._map_mu:
            pmap = self._map
        if not 0 <= pid < pmap.count:
            # A concurrent refresh shrank the map between this command's
            # routing snapshot and now: heal exactly like a MOVED answer
            # — the dispatch retry regroups under the fresh map instead
            # of this thread dying on an IndexError mid-command.
            raise MovedError(
                f"MOVED {pid} {pmap.epoch}", pid, pmap.epoch
            )
        reps = list(pmap.replicas[pid])
        last: Optional[Exception] = None
        for addr in reps:
            host, _, port = addr.rpartition(":")
            try:
                c = MerkleKVClient(
                    host, int(port), timeout=self.timeout
                ).connect()
                backends[pid] = c
                return c
            except ClientConnectionError as e:
                last = e
        raise ClientConnectionError(
            f"partition {pid} unreachable: {last}"
        )

    def _dispatch(
        self, line: str, backends: dict[int, MerkleKVClient]
    ) -> str:
        m = get_metrics()
        m.inc("router.commands")
        parts = line.split(" ", 1)
        verb = parts[0].upper()
        rest = parts[1] if len(parts) > 1 else ""
        try:
            if verb == "PING":
                return f"PONG {rest}\r\n" if rest else "PONG \r\n"
            if verb == "PARTMAP":
                with self._map_mu:
                    return self._map.wire()
            # Bounded MOVED/BUSY healing around the real routing work
            # (PARTITION_MOVED retry policy): during a live rebalance a
            # command can land in the fence window (BUSY — wait it out)
            # and then on a flipped epoch (MOVED — refresh + re-route),
            # several times in a row. Each MOVED refreshes the map and
            # redials; the final attempt's refusal surfaces to the
            # client, which can apply its own policy.
            attempt = 0
            while True:
                try:
                    return self._route(verb, rest, backends)
                except MovedError as e:
                    if attempt + 1 >= (PARTITION_MOVED.attempts or 1):
                        raise
                    m.inc("router.moved_refreshes")
                    for b in backends.values():
                        b.close()
                    backends.clear()
                    time.sleep(PARTITION_MOVED.backoff(attempt))
                    attempt += 1
                    self.refresh_map(min_epoch=e.epoch)
                except ServerBusyError:
                    if attempt + 1 >= (PARTITION_MOVED.attempts or 1):
                        raise
                    m.inc("router.busy_retries")
                    time.sleep(PARTITION_MOVED.backoff(attempt))
                    attempt += 1
                    try:
                        self.refresh_map()
                    except ClientConnectionError:
                        pass  # retry against the current map
        except MovedError as e:
            return f"ERROR MOVED {e.partition} {e.epoch}\r\n"
        except ProtocolError as e:
            return f"ERROR {e}\r\n"
        except (MerkleKVError, OSError) as e:
            m.inc("router.backend_errors")
            # The backend connection state is unknown mid-error: drop all
            # of this client's backends so the next command redials.
            for b in backends.values():
                b.close()
            backends.clear()
            return f"ERROR router: {e}\r\n"

    def _route(
        self, verb: str, rest: str, backends: dict[int, MerkleKVClient]
    ) -> str:
        with self._map_mu:
            pmap = self._map
        if verb in ("INC", "DEC"):
            key, _, amt_s = rest.strip().partition(" ")
            if not key:
                return f"ERROR {verb} command requires a key\r\n"
            try:
                amt = int(amt_s) if amt_s else None
            except ValueError:
                return (
                    f"ERROR {verb} command amount must be a valid "
                    "number\r\n"
                )
            c = self._backend(pmap.partition_for_key(key), backends)
            fn = c.increment if verb == "INC" else c.decrement
            return f"VALUE {fn(key, amt)}\r\n"
        if verb in _SINGLE_KEY:
            if _SINGLE_KEY[verb]:  # "<key> <value>", first-space split
                key, sep, value = rest.partition(" ")
                if not sep or not key:
                    return f"ERROR {verb} command requires a key and value\r\n"
            else:
                key = rest.strip()
                if not key or " " in key:
                    return f"ERROR {verb} command requires a key\r\n"
            c = self._backend(pmap.partition_for_key(key), backends)
            if verb == "GET":
                v = c.get(key)
                return f"VALUE {v}\r\n" if v is not None else "NOT_FOUND\r\n"
            if verb in ("DEL", "DELETE"):
                return "DELETED\r\n" if c.delete(key) else "NOT_FOUND\r\n"
            if verb == "SET":
                c.set(key, value)
                return "OK\r\n"
            # APPEND / PREPEND
            fn = c.append if verb == "APPEND" else c.prepend
            return f"VALUE {fn(key, value)}\r\n"
        if verb == "EXISTS":
            keys = rest.split()
            if not keys:
                return "ERROR EXISTS command requires at least one key\r\n"
            total = 0
            for pid, sub in self._group(keys, pmap):
                total += self._backend(pid, backends).exists(*sub)
            return f"EXISTS {total}\r\n"
        if verb == "MGET":
            keys = rest.split()
            if not keys:
                return "ERROR MGET command requires at least one key\r\n"
            merged: dict[str, Optional[str]] = {}
            for pid, sub in self._group(keys, pmap):
                merged.update(self._backend(pid, backends).mget(sub))
            found = sum(1 for v in merged.values() if v is not None)
            if found == 0:
                return "NOT_FOUND\r\n"
            body = "".join(
                f"{k} {merged[k] if merged[k] is not None else 'NOT_FOUND'}"
                "\r\n"
                for k in keys
            )
            return f"VALUES {found}\r\n{body}"
        if verb == "MSET":
            args = rest.split()
            if not args or len(args) % 2:
                return (
                    "ERROR MSET command requires an even number of "
                    "arguments (key-value pairs)\r\n"
                )
            pairs = dict(zip(args[::2], args[1::2]))
            for pid, sub in self._group(list(pairs), pmap):
                self._backend(pid, backends).mset(
                    {k: pairs[k] for k in sub}
                )
            return "OK\r\n"
        if verb == "SCAN":
            prefix = rest.strip()
            keys: list[str] = []
            for pid in range(pmap.count):
                keys += self._backend(pid, backends).scan(prefix)
            keys.sort()
            body = "".join(f"{k}\r\n" for k in keys)
            return f"KEYS {len(keys)}\r\n{body}"
        if verb == "DBSIZE":
            total = sum(
                self._backend(pid, backends).dbsize()
                for pid in range(pmap.count)
            )
            return f"DBSIZE {total}\r\n"
        return (
            f"ERROR router: unsupported verb {verb} "
            "(connect to a node directly or use a partition-aware "
            "client)\r\n"
        )

    @staticmethod
    def _group(
        keys: list[str], pmap: PartitionMap
    ) -> list[tuple[int, list[str]]]:
        groups: dict[int, list[str]] = {}
        for k in keys:
            groups.setdefault(pmap.partition_for_key(k), []).append(k)
        return sorted(groups.items())


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
    args = p.parse_args(argv)
    seeds = [s.strip() for s in args.seeds.split(",") if s.strip()]
    router = PartitionRouter(args.host, args.port, seeds).start()
    print(
        f"merklekv_tpu_torch router listening on {args.host}:{router.port} "
        f"({router.map.count} partitions, epoch {router.map.epoch})",
        flush=True,
    )
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
