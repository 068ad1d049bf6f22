"""Python client SDK for the merklekv_tpu_torch text protocol.

A copy of ``merklekv_tpu/client.py``, its imports pointed at the port's modules.

First-class client covering the full command surface (the reference ships 13
language SDKs over the same wire format, clients/IMPLEMENTATION_SUMMARY.md;
this is the canonical one — see docs/PROTOCOL.md for the wire spec other
languages can implement). Sync (`MerkleKVClient`) and asyncio
(`AsyncMerkleKVClient`) variants share response parsing.

Conventions (matching the reference SDKs): TCP_NODELAY on, default port
7379, `MERKLEKV_PORT` env override, `VALUE ` prefixes stripped, `ERROR ...`
responses raised as ProtocolError.
"""

from __future__ import annotations

import asyncio
import base64
import os
import socket
import time
import zlib
from typing import Iterable, Optional, Sequence

DEFAULT_PORT = int(os.environ.get("MERKLEKV_PORT", "7379"))


class MerkleKVError(Exception):
    """Base error."""


class ConnectionError(MerkleKVError):  # noqa: A001 - parity with reference SDK
    """Connection failed or not connected."""


class ProtocolError(MerkleKVError):
    """Server returned ERROR or an unexpected response."""


class ChunkIntegrityError(MerkleKVError):
    """A SNAPCHUNK frame failed its CRC/length check after decode — the
    bytes on the wire are NOT the bytes the donor read. Distinct from
    ProtocolError (which signals a capability miss / ERROR answer) so the
    bootstrap fetch retries the same offset instead of failing the donor."""


class ServerBusyError(ProtocolError):
    """The node shed this request under overload (``ERROR BUSY ...``):
    admission control refused the connection, or a write was shed above a
    memory/disk watermark. RETRYABLE — the condition is transient by
    design (the degradation ladder steps back down once the resource
    recovers); back off and retry (cluster/retry.py treats it so)."""


class ReadOnlyError(ProtocolError):
    """The node refused a write because it is read-only (``ERROR READONLY
    ...``): hard memory watermark, full/failing disk, or draining for
    shutdown. NOT usefully retryable on the same node until it recovers —
    route writes elsewhere or wait for /healthz to return to live."""


class MovedError(ProtocolError):
    """The node refused a request because the key (or pt=-addressed tree)
    belongs to a partition it does not own (``ERROR MOVED <partition>
    <epoch>``): this client — or the router in front of it — routed with
    a STALE partition map. RETRYABLE after a map refresh: fetch PARTMAP
    again (the answer's ``epoch`` names the refusing node's map
    generation) and re-route to the partition's current replica group;
    :class:`PartitionedClient` does exactly that. Never a silent
    wrong-node read — the native guard answers this instead of serving."""

    def __init__(self, msg: str, partition: int, epoch: int) -> None:
        super().__init__(msg)
        self.partition = partition
        self.epoch = epoch


# --------------------------------------------------------------- parsing

def _parse_simple(resp: str) -> str:
    if resp.startswith("ERROR "):
        msg = resp[6:]
        # Overload-protection answers are TYPED so callers can tell a
        # retryable shed (BUSY) from a wait-for-recovery refusal
        # (READONLY) without string-matching; both subclass ProtocolError
        # so existing handlers keep working.
        if msg.startswith("BUSY"):
            raise ServerBusyError(msg)
        if msg.startswith("READONLY"):
            raise ReadOnlyError(msg)
        if msg.startswith("MOVED"):
            # "MOVED <partition> <epoch>" — typed so partition-aware
            # callers can refresh their map and re-route; a malformed
            # MOVED body stays a plain ProtocolError (never guess a
            # partition id out of garbage).
            fields = msg.split(" ")
            if len(fields) == 3:
                try:
                    raise MovedError(msg, int(fields[1]), int(fields[2]))
                except ValueError:
                    pass
        raise ProtocolError(msg)
    return resp


def _parse_value(resp: str) -> Optional[str]:
    resp = _parse_simple(resp)
    if resp == "NOT_FOUND":
        return None
    if resp.startswith("VALUE "):
        return resp[6:]
    raise ProtocolError(f"unexpected response: {resp}")


def _parse_snapmeta(resp: str) -> tuple[int, int, int, str]:
    """Parse a SNAPMETA response line (shared sync/async)."""
    if not resp.startswith("SNAPMETA "):
        raise ProtocolError(f"unexpected response: {resp}")
    try:
        seq_s, wal_s, size_s, root = resp[9:].split(" ")
        seq, wal_seq, size = int(seq_s), int(wal_s), int(size_s)
        if len(bytes.fromhex(root)) != 32:
            raise ValueError("root must be 32 bytes")
    except ValueError as e:
        raise ProtocolError(f"malformed SNAPMETA response: {resp!r}") from e
    return seq, wal_seq, size, root


def _parse_chunk_header(resp: str) -> tuple[int, int, int]:
    """Parse a CHUNK header line into (offset, rawlen, crc32)."""
    if not resp.startswith("CHUNK "):
        raise ProtocolError(f"unexpected response: {resp}")
    try:
        off_s, rawlen_s, crc_s = resp[6:].split(" ")
        return int(off_s), int(rawlen_s), int(crc_s)
    except ValueError as e:
        raise ProtocolError(f"malformed CHUNK response: {resp!r}") from e


def _decode_chunk(
    off: int, rawlen: int, crc: int, payload: str, requested_offset: int
) -> bytes:
    """Decode + verify one SNAPCHUNK payload line (shared sync/async).

    Every failure mode of a hostile wire — truncated base64, flipped bytes,
    an offset echo that doesn't match the request, a length or CRC that
    disagrees with the decoded bytes — raises ChunkIntegrityError so the
    fetch retries cleanly and partial data can never be returned."""
    if off != requested_offset:
        raise ChunkIntegrityError(
            f"chunk offset mismatch: asked {requested_offset}, got {off}"
        )
    if rawlen == 0:
        if payload:
            raise ChunkIntegrityError("zero-length chunk carried payload")
        return b""
    try:
        # validate=True: b64decode otherwise silently DISCARDS non-alphabet
        # bytes, which would let a flipped byte vanish instead of failing.
        comp = base64.b64decode(payload.encode("ascii"), validate=True)
        raw = zlib.decompress(comp)
    except Exception as e:
        raise ChunkIntegrityError(f"chunk decode failed: {e}") from None
    if len(raw) != rawlen:
        raise ChunkIntegrityError(
            f"chunk length mismatch: header says {rawlen}, decoded {len(raw)}"
        )
    if zlib.crc32(raw) != crc:
        raise ChunkIntegrityError("chunk crc mismatch")
    return raw


def _parse_partmap_header(header: str) -> int:
    """Row count from a ``PARTMAP <epoch> <count>`` header — or the split
    form ``PARTMAP <epoch> <count> <base>`` a mid-rebalance cluster serves
    (shared sync/async). Validated BEFORE any body read so a garbled
    header can never leave the client waiting out rows that will not come;
    the full semantic validation happens in ``PartitionMap.from_wire``."""
    fields = header.split(" ")
    if len(fields) not in (3, 4) or fields[0] != "PARTMAP":
        raise ProtocolError(f"unexpected response: {header}")
    try:
        count = int(fields[2])
        if len(fields) == 4:
            int(fields[3])  # split-map hash base; semantics in from_wire
    except ValueError as e:
        raise ProtocolError(f"malformed PARTMAP header: {header!r}") from e
    if not 0 < count <= 65536:
        raise ProtocolError(f"malformed PARTMAP header: {header!r}")
    return count


def _count_after(resp: str, prefix: str) -> int:
    resp = _parse_simple(resp)
    if not resp.startswith(prefix):
        raise ProtocolError(f"unexpected response: {resp}")
    return int(resp[len(prefix):])


def _parse_hashes_header(resp: str) -> tuple[int, Optional[int]]:
    """``HASHES <count>`` or the stamped ``HASHES <count> <ver>`` form
    (LEAFHASHES/HASHPAGE) -> (count, version stamp | None). Any other
    shape raises — a truncated or garbled header must never be read as a
    shorter page."""
    resp = _parse_simple(resp)
    if not resp.startswith("HASHES "):
        raise ProtocolError(f"unexpected response: {resp}")
    fields = resp[7:].split(" ")
    try:
        if len(fields) == 1:
            return int(fields[0]), None
        if len(fields) == 2:
            return int(fields[0]), int(fields[1])
    except ValueError as e:
        raise ProtocolError(f"malformed HASHES header: {resp!r}") from e
    raise ProtocolError(f"malformed HASHES header: {resp!r}")


# Error-text signatures of a peer that cannot parse a trailing trace-context
# token (pre-tracing version): its parser rejects the extra argument with
# one of these arity complaints. The client then drops the token for the
# connection's lifetime and retries — capability fallback, so traced
# initiators interop with untraced peers. The ERROR answer is a single
# line, so the stream stays in sync across the retry.
_TRACE_CAPABILITY_ERRORS = (
    "requires arguments",
    "does not accept any arguments",
    "accepts only one argument",
    "Unknown command",
)


def _is_trace_capability_error(msg: str) -> bool:
    return any(sig in msg for sig in _TRACE_CAPABILITY_ERRORS)


class _ResponseReader:
    """Incremental CRLF line splitter over a byte stream.

    `limit` bounds the bytes buffered while waiting for a newline — the
    sync-side enforcement of max_value_bytes, mirroring the async
    client's StreamReader limit (None = unbounded)."""

    def __init__(self, limit: Optional[int] = None) -> None:
        self._buf = b""
        self._limit = limit

    def feed(self, data: bytes) -> None:
        self._buf += data

    def next_line(self) -> Optional[str]:
        i = self._buf.find(b"\n")
        if i < 0:
            if self._limit is not None and len(self._buf) > self._limit:
                raise ProtocolError(
                    f"response line exceeds {len(self._buf) - 1} buffered "
                    f"bytes without a newline — raise the client's "
                    f"max_value_bytes to round-trip larger values"
                )
            return None
        line = self._buf[: i + 1]
        self._buf = self._buf[i + 1 :]
        return line.rstrip(b"\r\n").decode("utf-8", "surrogateescape")


class MerkleKVClient:
    """Synchronous client. Context-manager friendly:

        with MerkleKVClient("localhost", 7379) as c:
            c.set("k", "v")
            assert c.get("k") == "v"
    """

    def __init__(
        self,
        host: str = "localhost",
        port: int = DEFAULT_PORT,
        timeout: float = 5.0,
        max_value_bytes: int = 1 << 20,
    ) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        # Largest value this client expects to round-trip: bounds the
        # line buffer exactly like the async client's StreamReader limit
        # (same floor + header-slack formula), so both clients refuse an
        # oversized VALUE line identically — here with a typed
        # ProtocolError naming the knob instead of a bare ValueError.
        self.max_value_bytes = max_value_bytes
        self._line_limit = max(1 << 20, max_value_bytes + (1 << 16))
        self._sock: Optional[socket.socket] = None
        self._reader = _ResponseReader(self._line_limit)
        # Wire-byte accounting (requests sent / response bytes received over
        # the connection's lifetime, reconnects included). The sync manager
        # reads deltas of these to report anti-entropy transfer cost — the
        # number the bisection walk exists to shrink.
        self.bytes_sent = 0
        self.bytes_received = 0
        # Causal-trace propagation: when set (a zero-arg callable returning
        # the active tc= token or None — usually tracewire.current_token),
        # cluster verbs append the token so the peer's serve spans stitch
        # into the caller's trace. None/False tri-state records whether the
        # peer accepted a token; False = capability fallback engaged.
        self.trace_provider = None
        self._peer_traced: Optional[bool] = None
        # Version-stamp negotiation (docs/PROTOCOL.md "Version-stamped tree
        # answers"): when True, tree-serving verbs append a "vs=XX" token
        # asking the server to stamp its reply with the engine version the
        # served tree reflects. Same capability tri-state discipline as the
        # trace token (an old peer's arity ERROR drops stamping for the
        # connection); the parsed stamp of the LAST stamped answer lands in
        # ``last_stamp`` as (version, lag) — lag 0 for live-engine verbs,
        # and None when the answer carried no stamp.
        self.version_stamps = False
        self._peer_stamped: Optional[bool] = None
        self.last_stamp: Optional[tuple[int, int]] = None
        # Partition-scoped tree addressing: when set, HASH and TREELEVEL
        # carry a trailing "pt=<pid>" token so a partitioned peer can
        # refuse a stale-map read with ERROR MOVED instead of silently
        # serving a DIFFERENT partition's tree into this caller's
        # anti-entropy walk. Deliberately no capability fallback: the
        # token is only attached by partition-aware callers talking to a
        # partitioned cluster, and dropping it silently would reopen the
        # exact wrong-tree hazard it closes.
        self.partition_id: Optional[int] = None

    # -- lifecycle ---------------------------------------------------------
    def connect(self) -> "MerkleKVClient":
        # Fresh line buffer: a reconnect must not inherit half-parsed (or
        # desynchronized) bytes from the previous connection.
        self._reader = _ResponseReader(self._line_limit)
        try:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as e:
            raise ConnectionError(
                f"failed to connect to {self.host}:{self.port}: {e}"
            ) from e
        return self

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def is_connected(self) -> bool:
        return self._sock is not None

    def __enter__(self) -> "MerkleKVClient":
        if self._sock is None:
            self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- wire --------------------------------------------------------------
    def _send_line(self, line: str) -> None:
        if self._sock is None:
            raise ConnectionError("not connected; call connect() first")
        payload = line.encode("utf-8") + b"\r\n"
        try:
            self._sock.sendall(payload)
        except OSError as e:
            raise ConnectionError(f"send failed: {e}") from e
        self.bytes_sent += len(payload)

    def _read_line(self) -> str:
        while True:
            try:
                line = self._reader.next_line()
            except ProtocolError:
                # Over-limit line: the rest of the oversized value is
                # still in flight, so the stream is desynchronized —
                # close rather than let a caller who catches the error
                # read value bytes as later responses.
                self.close()
                raise
            if line is not None:
                return line
            try:
                data = self._sock.recv(65536)
            except socket.timeout as e:
                raise MerkleKVError(f"timed out after {self.timeout}s") from e
            except OSError as e:
                raise ConnectionError(f"recv failed: {e}") from e
            if not data:
                raise ConnectionError("server closed connection")
            self.bytes_received += len(data)
            self._reader.feed(data)

    def _request(self, line: str) -> str:
        self._send_line(line)
        return self._read_line()

    def _trace_token(self) -> Optional[str]:
        if self.trace_provider is None or self._peer_traced is False:
            return None
        try:
            return self.trace_provider()
        except Exception:
            return None  # a broken provider must never fail the request

    def _version_token(
        self, require_settled: bool, force: bool
    ) -> Optional[str]:
        """The vs= token to attach, or None. ``force=True`` is an EXPLICIT
        exactness request, so it attaches even when stamping is off or
        unsettled — dropping it silently would return a bounded-stale
        answer where the caller asked for an exact one. (Against an old
        server the fallback still engages: fail-closed verbs get the arity
        ERROR, and bare HASH detects the token echoed back as a pattern —
        either way the plain retry's answer is computed live, i.e. exact,
        because pre-pump servers never serve stale.)"""
        if self._peer_stamped is False:
            return None
        if force:
            return "vs=03"
        if not self.version_stamps:
            return None
        if require_settled and self._peer_stamped is not True:
            return None
        return "vs=01"

    def _traced_request(
        self,
        line: str,
        require_settled: bool = False,
        stamp: bool = False,
        force: bool = False,
        trace: bool = True,
        partition: bool = False,
    ) -> str:
        """Send a cluster verb with the optional trailing tokens appended —
        the version-stamp token (``stamp=True`` verbs only: HASH/TREELEVEL/
        LEAFHASHES/HASHPAGE) first, the trace token last. On an arity ERROR
        the tokens are dropped newest-capability-first for this connection
        and the request retried: a peer one release back parses tc= but not
        vs= (drop the stamp, keep the trace); an older peer rejects both
        (two retries settle both tri-states False). Each ERROR answer is a
        single line, so the stream stays in sync across retries.

        ``require_settled``: only attach tokens once this connection has
        PROVED the peer parses them (an earlier tokened verb succeeded).
        Verbs with OPTIONAL trailing arguments need this — an old peer
        reads a token as that argument (LEAFHASHES: a prefix -> empty
        hash set; HASHPAGE: the after-cursor -> a silently truncated
        page) instead of erroring. Fixed-arity verbs (TREELEVEL,
        SNAPMETA, SNAPCHUNK) fail closed on extra tokens and settle
        capability safely. ``force`` rides the stamp token (vs=03): ask
        the server for a fresh tree before answering.

        ``partition=True`` verbs (HASH, TREELEVEL) additionally carry the
        "pt=<pid>" partition address when ``partition_id`` is set — FIRST
        in the suffix, and exempt from the capability fallback: partition
        addressing has no silent-downgrade mode (docstring on
        ``partition_id``)."""
        if stamp:
            self.last_stamp = None
        if partition and self.partition_id is not None and (
            self.partition_id >= 0
        ):
            line = f"{line} pt={self.partition_id}"
        vtok = self._version_token(require_settled, force) if stamp else None
        ttok = self._trace_token() if trace else None
        if ttok is not None and require_settled and self._peer_traced is not True:
            ttok = None
        if vtok is None and ttok is None:
            return self._request(line)
        suffix = (f" {vtok}" if vtok else "") + (f" {ttok}" if ttok else "")
        resp = self._request(line + suffix)
        if resp.startswith("ERROR ") and _is_trace_capability_error(resp):
            if vtok is not None:
                self._peer_stamped = False
                resp = self._request(line + (f" {ttok}" if ttok else ""))
                if ttok is None:
                    return resp
                if resp.startswith("ERROR ") and _is_trace_capability_error(
                    resp
                ):
                    self._peer_traced = False
                    return self._request(line)
                self._peer_traced = True
                return resp
            self._peer_traced = False
            return self._request(line)
        if vtok is not None:
            self._peer_stamped = True
        if ttok is not None:
            self._peer_traced = True
        return resp

    def _read_body(self, n: int) -> list[str]:
        return [self._read_line() for _ in range(n)]

    # -- basic -------------------------------------------------------------
    def get(self, key: str) -> Optional[str]:
        return _parse_value(self._request(f"GET {key}"))

    def get_stamped(
        self, key: str, force: bool = False
    ) -> tuple[Optional[str], Optional[tuple[int, int]]]:
        """GET through the request plane with the staleness stamp: asks
        the router to answer ``VALUE vs=<age_ms>:<bound_ms> <value>`` so
        the caller can SEE how stale a cached answer may be —
        ``age_ms`` is the cache entry's age at serve time, ``bound_ms``
        the router's hard max-age bound (an answer is never served past
        it; docs/PROTOCOL.md "Router semantics"). Returns
        ``(value, (age_ms, bound_ms))``; the stamp is None when the
        peer has no cache hop (plain node, cache off) or on NOT_FOUND.
        ``force=True`` (vs=03) bypasses and drops the cached entry —
        the answer is read fresh from the owning partition."""
        tok = "vs=03" if force else "vs=01"
        try:
            resp = _parse_simple(self._request(f"GET {key} {tok}"))
        except (ServerBusyError, ReadOnlyError, MovedError):
            raise
        except ProtocolError:
            # Peer rejects the token (plain node / old router): its live
            # answer is exact — nothing to stamp. One retry, settled.
            return _parse_value(self._request(f"GET {key}")), None
        if resp == "NOT_FOUND":
            return None, None
        if resp.startswith("VALUE "):
            body = resp[6:]
            if body.startswith("vs="):
                stamp_s, _, value = body.partition(" ")
                try:
                    age_s, bound_s = stamp_s[3:].split(":")
                    return value, (int(age_s), int(bound_s))
                except ValueError as e:
                    raise ProtocolError(
                        f"malformed GET stamp: {resp!r}"
                    ) from e
            return body, None
        raise ProtocolError(f"unexpected response: {resp}")

    def set(self, key: str, value: str) -> bool:
        resp = _parse_simple(self._request(f"SET {key} {value}"))
        if resp != "OK":
            raise ProtocolError(f"unexpected response: {resp}")
        return True

    def delete(self, key: str) -> bool:
        resp = _parse_simple(self._request(f"DELETE {key}"))
        if resp == "DELETED":
            return True
        if resp == "NOT_FOUND":
            return False
        raise ProtocolError(f"unexpected response: {resp}")

    # -- numeric / string ----------------------------------------------------
    def increment(self, key: str, amount: Optional[int] = None) -> int:
        cmd = f"INC {key}" if amount is None else f"INC {key} {amount}"
        return int(_parse_value(self._request(cmd)))

    def decrement(self, key: str, amount: Optional[int] = None) -> int:
        cmd = f"DEC {key}" if amount is None else f"DEC {key} {amount}"
        return int(_parse_value(self._request(cmd)))

    def append(self, key: str, value: str) -> str:
        return _parse_value(self._request(f"APPEND {key} {value}"))

    def prepend(self, key: str, value: str) -> str:
        return _parse_value(self._request(f"PREPEND {key} {value}"))

    # -- bulk ----------------------------------------------------------------
    def mget(self, keys: Sequence[str]) -> dict[str, Optional[str]]:
        resp = self._request("MGET " + " ".join(keys))
        resp = _parse_simple(resp)
        out: dict[str, Optional[str]] = {k: None for k in keys}
        if resp == "NOT_FOUND":
            # Server still sent one line per key? No: bare NOT_FOUND only.
            return out
        if not resp.startswith("VALUES "):
            raise ProtocolError(f"unexpected response: {resp}")
        for _ in range(len(keys)):
            line = self._read_line()
            k, _, v = line.partition(" ")
            out[k] = None if v == "NOT_FOUND" else v
        return out

    def mset(self, pairs: dict[str, str]) -> bool:
        parts = []
        for k, v in pairs.items():
            parts += [k, v]
        resp = _parse_simple(self._request("MSET " + " ".join(parts)))
        if resp != "OK":
            raise ProtocolError(f"unexpected response: {resp}")
        return True

    def truncate(self) -> bool:
        return _parse_simple(self._request("TRUNCATE")) == "OK"

    # -- query ---------------------------------------------------------------
    def exists(self, *keys: str) -> int:
        return _count_after(self._request("EXISTS " + " ".join(keys)), "EXISTS ")

    def scan(self, prefix: str = "") -> list[str]:
        cmd = f"SCAN {prefix}" if prefix else "SCAN"
        n = _count_after(self._request(cmd), "KEYS ")
        return self._read_body(n)

    def dbsize(self) -> int:
        return _count_after(self._request("DBSIZE"), "DBSIZE ")

    def hash(self, pattern: Optional[str] = None, force: bool = False) -> str:
        """Whole-keyspace (or prefix) Merkle root. With ``version_stamps``
        on and the peer's capability settled, the bare form carries the
        vs= token and the stamped answer's (version, lag) lands in
        ``last_stamp`` — lag > 0 means the served root trails the live
        engine by that many mutations (the bounded-staleness device tree).
        ``force=True`` asks the server to refresh the tree first (exact
        root; the snapshot-stamping escape hatch)."""
        if pattern is not None:
            resp = _parse_simple(self._request(f"HASH {pattern}"))
            if not resp.startswith("HASH "):
                raise ProtocolError(f"unexpected response: {resp}")
            return resp.rsplit(" ", 1)[-1]
        # require_settled: an old server reads the token as a PATTERN and
        # answers the echoed-pattern wire shape — fail-open, so the stamp
        # only attaches once a fail-closed verb proved the capability.
        # trace=False: HASH never carried the tc= token (the server does
        # not parse it there) — only the stamp token attaches.
        resp = _parse_simple(
            self._traced_request(
                "HASH", require_settled=True, stamp=True, force=force,
                trace=False, partition=True,
            )
        )
        fields = resp.split(" ")
        if len(fields) == 3 and fields[1].startswith("vs="):
            # Old server echoed the token back as a PATTERN ("HASH vs=03
            # <hex>"): capability miss, settle and retry plain. The plain
            # answer is computed live — pre-pump servers never serve
            # stale — so a force intent is still honored.
            self._peer_stamped = False
            resp = _parse_simple(self._request("HASH"))
            fields = resp.split(" ")
        if fields[0] != "HASH" or len(fields) not in (2, 4):
            raise ProtocolError(f"unexpected response: {resp}")
        if len(fields) == 4:
            try:
                self.last_stamp = (int(fields[2]), int(fields[3]))
            except ValueError as e:
                raise ProtocolError(
                    f"malformed HASH stamp: {resp!r}"
                ) from e
        return fields[1]

    def leaf_hashes(self, prefix: str = "") -> dict[str, str]:
        """Per-key leaf digests (hex) of LIVE keys — the anti-entropy
        narrowing fetch. Tombstone lines are filtered out."""
        return {
            k: h
            for k, (h, _) in self.leaf_hashes_ts(prefix).items()
            if h is not None
        }

    def leaf_hashes_ts(
        self, prefix: str = ""
    ) -> dict[str, tuple[Optional[str], int]]:
        """Per-key (leaf digest hex, last-write unix-ns ts). A digest of
        None marks a TOMBSTONE: the key was deleted at that ts (wire digest
        field "-"). Servers that predate the ts field yield ts 0
        ("unknown age")."""
        cmd = f"LEAFHASHES {prefix}" if prefix else "LEAFHASHES"
        n, stamp = _parse_hashes_header(
            self._traced_request(cmd, require_settled=True, stamp=True)
        )
        if stamp is not None:
            self.last_stamp = (stamp, 0)
        out: dict[str, tuple[Optional[str], int]] = {}
        for _ in range(n):
            parts = self._read_line().split(" ")
            # Keys cannot contain spaces (protocol rule), so lines are
            # either "key hex" (legacy) or "key hex|- ts".
            if len(parts) >= 3:
                digest = None if parts[1] == "-" else parts[1]
                out[parts[0]] = (digest, int(parts[2]))
            else:
                out[parts[0]] = (parts[1], 0)
        return out

    def leaf_hashes_page(
        self, count: int, after: str = "", upto: Optional[str] = None
    ) -> tuple[list[tuple[str, Optional[str], int]], bool]:
        """One page of the cursor-paged hash scan (HASHPAGE): up to
        ``count`` (key, digest hex | None, ts) rows for keys strictly after
        ``after``, in sorted key order — tombstones (digest None) merged in
        place, unlike LEAFHASHES which groups them at the end. Returns
        ``(rows, done)``; ``done`` means the keyspace is exhausted. Order is
        preserved because the last row's key is the caller's next cursor.

        ``upto`` (exclusive upper bound, requires a non-empty ``after``)
        makes the page range-bounded — the bisection walk's leaf fetch for
        one divergent key range; ``done`` then means the RANGE is
        exhausted. The wire form cannot express an empty cursor with a
        bound, so callers starting at the keyspace head trim client-side."""
        if upto is not None and not after:
            raise ValueError("bounded HASHPAGE requires a non-empty cursor")
        if upto is not None:
            cmd = f"HASHPAGE {count} {after} {upto}"
        elif after:
            cmd = f"HASHPAGE {count} {after}"
        else:
            cmd = f"HASHPAGE {count}"
        # require_settled: an old peer would read the token as the
        # after-cursor (or upto bound) and silently skip every key below
        # it — a fail-OPEN page truncation, never an ERROR.
        n, stamp = _parse_hashes_header(
            self._traced_request(cmd, require_settled=True, stamp=True)
        )
        if stamp is not None:
            self.last_stamp = (stamp, 0)
        rows: list[tuple[str, Optional[str], int]] = []
        for _ in range(n):
            parts = self._read_line().split(" ")
            if len(parts) != 3:
                raise ProtocolError(
                    f"malformed HASHPAGE row: {' '.join(parts)!r}"
                )
            digest = None if parts[1] == "-" else parts[1]
            try:
                if digest is not None:
                    bytes.fromhex(digest)  # validate: sync layer decodes
                ts = int(parts[2])
            except ValueError as e:
                # A garbled row (truncation fault mid-line) must surface as
                # ProtocolError: that is what the paged walker catches to
                # checkpoint its verified prefix — a bare ValueError would
                # skip the checkpoint and lose the cursor.
                raise ProtocolError(
                    f"malformed HASHPAGE row: {' '.join(parts)!r}"
                ) from e
            rows.append((parts[0], digest, ts))
        return rows, n < count

    def tree_level(
        self, level: int, lo: int, hi: int, force: bool = False
    ) -> tuple[list[tuple[int, str]], int]:
        """Interior digests of the server's reference Merkle tree
        (TREELEVEL): ``(idx, digest hex)`` rows for level ``level``
        (0 = leaves), indices ``[lo, hi)`` clamped to the level's size,
        plus the live leaf count ``n`` (which fixes every level's size:
        ``m_0 = n``, ``m_{l+1} = (m_l + 1) // 2``). ``lo == hi`` is the
        zero-cost capability probe + leaf-count fetch the bisection walk
        opens with. With ``version_stamps`` the stamped header's
        (version, lag) lands in ``last_stamp``; ``force=True`` asks for a
        freshly refreshed tree (the walk's staleness escalation)."""
        resp = _parse_simple(
            self._traced_request(
                f"TREELEVEL {level} {lo} {hi}", stamp=True, force=force,
                partition=True,
            )
        )
        if not resp.startswith("NODES "):
            raise ProtocolError(f"unexpected response: {resp}")
        fields = resp[6:].split(" ")
        try:
            if len(fields) == 2:
                count, n = int(fields[0]), int(fields[1])
            elif len(fields) == 4:
                count, n = int(fields[0]), int(fields[1])
                self.last_stamp = (int(fields[2]), int(fields[3]))
            else:
                raise ValueError("NODES header must carry 2 or 4 fields")
        except ValueError as e:
            raise ProtocolError(f"unexpected response: {resp}") from e
        rows: list[tuple[int, str]] = []
        for _ in range(count):
            line = self._read_line()
            idx_s, _, hexd = line.partition(" ")
            try:
                idx = int(idx_s)
                # Exactly 32 digest bytes: bytes.fromhex("") succeeds, so a
                # truncated row would otherwise slip through as an empty
                # digest and make the walk chase a phantom divergence.
                if len(bytes.fromhex(hexd)) != 32:
                    raise ValueError("digest must be 32 bytes")
            except ValueError as e:
                raise ProtocolError(f"malformed TREELEVEL row: {line!r}") from e
            rows.append((idx, hexd))
        return rows, n

    def partition_map(self):
        """The node's versioned partition map (PARTMAP): partitioned
        cluster mode is not in the torch port yet, so this raises."""
        from merklekv_tpu_torch.unported import refuse

        refuse("partitions")

    def snap_meta(self) -> tuple[int, int, int, str]:
        """Newest shippable snapshot on the peer (SNAPMETA): ``(seq,
        wal_seq, size_bytes, root_hex)``. A peer without durable storage —
        or an old-version peer without the verb — answers ERROR, raised
        here as ProtocolError: the joiner's capability-fallback signal to
        degrade to the plain anti-entropy walk."""
        return _parse_snapmeta(_parse_simple(self._traced_request("SNAPMETA")))

    def snap_chunk(self, seq: int, offset: int, count: int) -> bytes:
        """One verified byte range of snapshot ``seq`` (SNAPCHUNK): the
        raw bytes at ``offset`` (possibly short at EOF, empty past it).
        The frame travels zlib-compressed + base64 with the RAW length and
        CRC32 in the header; any mismatch after decode raises
        :class:`ChunkIntegrityError` — the caller retries the offset, and
        a partial/corrupt frame can never be applied."""
        resp = _parse_simple(
            self._traced_request(f"SNAPCHUNK {seq} {offset} {count}")
        )
        off, rawlen, crc = _parse_chunk_header(resp)
        payload = self._read_line()
        return _decode_chunk(off, rawlen, crc, payload, offset)

    # -- admin ---------------------------------------------------------------
    def ping(self, message: str = "") -> str:
        cmd = f"PING {message}" if message else "PING"
        return _parse_simple(self._request(cmd))

    def echo(self, message: str) -> str:
        resp = _parse_simple(self._request(f"ECHO {message}"))
        if not resp.startswith("ECHO "):
            raise ProtocolError(f"unexpected response: {resp}")
        return resp[5:]

    def health_check(self) -> bool:
        try:
            return self.ping().startswith("PONG")
        except MerkleKVError:
            return False

    def stats(self) -> dict[str, str]:
        resp = _parse_simple(self._request("STATS"))
        if resp != "STATS":
            raise ProtocolError(f"unexpected response: {resp}")
        return self._read_kv_block()

    def info(self) -> dict[str, str]:
        resp = _parse_simple(self._request("INFO"))
        if resp != "INFO":
            raise ProtocolError(f"unexpected response: {resp}")
        return self._read_kv_block()

    def metrics(self) -> dict[str, str]:
        """Control-plane counter snapshot (extension verb): transport
        reconnects/outbox drops, anti-entropy loop counters — the
        Python-layer numbers STATS (engine/server scope) cannot see.
        Empty on a bare node without a cluster plane."""
        resp = _parse_simple(self._request("METRICS"))
        if resp != "METRICS":
            raise ProtocolError(f"unexpected response: {resp}")
        return self._read_kv_block()

    def _read_kv_block(self) -> dict[str, str]:
        # Stats/info blocks are `name:value` lines closed by an END
        # terminator (same shape as CLIENT LIST). Servers that predate the
        # terminator (reference parity mode / rolling upgrade) never send
        # END, so a PING sentinel is pipelined as a fallback delimiter; on
        # an END-speaking server the sentinel's PONG is consumed right
        # after the block.
        self._send_line("PING __end__")
        out: dict[str, str] = {}
        while True:
            line = self._read_line()
            if line == "END":
                while self._read_line() != "PONG __end__":
                    pass  # drain to the sentinel reply
                return out
            if line == "PONG __end__":
                return out  # terminator-less server
            name, _, value = line.partition(":")
            out[name] = value

    def version(self) -> str:
        resp = _parse_simple(self._request("VERSION"))
        if not resp.startswith("VERSION "):
            raise ProtocolError(f"unexpected response: {resp}")
        return resp[8:]

    def memory(self) -> int:
        return _count_after(self._request("MEMORY"), "MEMORY ")

    def _read_field_table(self) -> list[dict[str, str]]:
        """Lines of space-separated ``k=v`` fields closed by ``END``
        (CLIENT LIST, PEERS)."""
        rows = []
        while True:
            line = self._read_line()
            if line == "END":
                return rows
            rows.append(dict(f.split("=", 1) for f in line.split(" ") if "=" in f))

    def client_list(self) -> list[dict[str, str]]:
        resp = _parse_simple(self._request("CLIENT LIST"))
        if resp != "CLIENT LIST":
            raise ProtocolError(f"unexpected response: {resp}")
        return self._read_field_table()

    def peers(self) -> list[dict[str, str]]:
        """Per-peer health table (PEERS extension verb): one dict per
        configured peer with addr/status/failures/rtt_ms/last_ok."""
        resp = _parse_simple(self._request("PEERS"))
        if not resp.startswith("PEERS "):
            raise ProtocolError(f"unexpected response: {resp}")
        return self._read_field_table()

    def trace(self, n: int = 8) -> list[dict[str, str]]:
        """Correlated anti-entropy traces (TRACE extension verb): the
        newest ``n`` sync cycles, one dict per (cycle, peer) row with
        cycle/kind/peer/mode/outcome/bytes/rounds/repairs fields. Empty on
        a node without a cluster plane."""
        resp = _parse_simple(self._request(f"TRACE {n}"))
        if not resp.startswith("TRACES "):
            raise ProtocolError(f"unexpected response: {resp}")
        return self._read_field_table()

    def trace_dump(self, n: int = 0) -> list[dict[str, str]]:
        """Raw causal-trace spans (TRACEDUMP extension verb): the newest
        ``n`` spans (0 = all) from the node's span collector, one dict per
        span with trace/span/parent/name/role/ts_ns/dur_ns/node fields —
        the stitching input ``obs/tracewire.py`` assembles into a Chrome
        trace. Empty on a node without a cluster plane."""
        resp = _parse_simple(self._request(f"TRACEDUMP {n}"))
        if not resp.startswith("SPANS "):
            raise ProtocolError(f"unexpected response: {resp}")
        return self._read_field_table()

    def flight(self, n: int = 64) -> list[dict[str, str]]:
        """Flight-recorder stream (FLIGHT extension verb): the newest ``n``
        black-box events — state transitions, slow commands — one dict per
        event (seq/wall_ns/kind + kind-specific fields), newest first. A
        bare native node serves its slow-command log; a node with a control
        plane serves the full event ring."""
        resp = _parse_simple(self._request(f"FLIGHT {n}"))
        if not resp.startswith("EVENTS "):
            raise ProtocolError(f"unexpected response: {resp}")
        return self._read_field_table()

    def profile(self, seconds: int) -> str:
        """Start a bounded device-profiler capture (PROFILE extension
        verb); returns the capture directory on the serving node. Raises
        ProtocolError when the node has no device plane / profiler."""
        resp = _parse_simple(self._request(f"PROFILE {seconds}"))
        if not resp.startswith("PROFILE "):
            raise ProtocolError(f"unexpected response: {resp}")
        return resp[8:]

    def flushdb(self) -> bool:
        return _parse_simple(self._request("FLUSHDB")) == "OK"

    def shutdown(self) -> None:
        try:
            self._request("SHUTDOWN")
        except ConnectionError:
            pass

    # -- cluster -------------------------------------------------------------
    def sync_with(self, host: str, port: int, full: bool = False,
                  verify: bool = False) -> bool:
        cmd = f"SYNC {host} {port}"
        if full:
            cmd += " --full"
        if verify:
            cmd += " --verify"
        return _parse_simple(self._request(cmd)) == "OK"

    def replicate(self, action: str) -> str:
        return _parse_simple(self._request(f"REPLICATE {action}"))

    def rebalance(self, subcommand: str) -> str:
        """One REBALANCE control exchange (``SPLIT``/``JOIN``/``STATUS``/
        ``FENCE``/``COMMIT``/``ABORT`` + arguments); returns the single
        response line. ERROR answers raise ProtocolError like every other
        simple-response verb — the rebalance coordinator's retry loops key off
        that."""
        return _parse_simple(self._request(f"REBALANCE {subcommand}"))

    # -- pipeline ------------------------------------------------------------
    def pipeline(self, commands: Iterable[str]) -> list[str]:
        """Send raw command lines back-to-back, collect one response line per
        command (only valid for single-line-response commands)."""
        cmds = list(commands)
        if self._sock is None:
            raise ConnectionError("not connected")
        payload = "".join(c + "\r\n" for c in cmds).encode("utf-8")
        self._sock.sendall(payload)
        self.bytes_sent += len(payload)
        return [self._read_line() for _ in cmds]


class AsyncMerkleKVClient:
    """asyncio variant with the same core surface."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = DEFAULT_PORT,
        timeout: float = 5.0,
        max_value_bytes: int = 1 << 20,
    ) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        # Sizes the StreamReader line limit (plus header slack) at
        # connect(): readline() raises a bare ValueError on any line past
        # the limit, so a GET of a value larger than the old fixed 1 MiB
        # cap used to fail mid-stream. Raise this to round-trip bigger
        # values; the sync client accepts the same argument for parity.
        self.max_value_bytes = max_value_bytes
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        # Wire-byte accounting, mirroring the sync client.
        self.bytes_sent = 0
        self.bytes_received = 0
        # Causal-trace propagation, mirroring the sync client.
        self.trace_provider = None
        self._peer_traced: Optional[bool] = None
        # Version-stamp negotiation, mirroring the sync client.
        self.version_stamps = False
        self._peer_stamped: Optional[bool] = None
        self.last_stamp: Optional[tuple[int, int]] = None
        # Partition-scoped tree addressing, mirroring the sync client
        # (no capability fallback by design — see the sync docstring).
        self.partition_id: Optional[int] = None

    async def connect(self) -> "AsyncMerkleKVClient":
        try:
            # limit: StreamReader.readline defaults to a 64 KiB cap and
            # raises a bare ValueError past it — a SNAPCHUNK payload line
            # (base64 of up to a 256 KiB raw range), large MGET value
            # lines, and any VALUE line near max_value_bytes all exceed
            # that legitimately. Sized from max_value_bytes plus header
            # slack ("VALUE "/"key " prefixes + CRLF), floored at the old
            # 1 MiB so SNAPCHUNK framing never regresses.
            limit = max(1 << 20, self.max_value_bytes + (1 << 16))
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port, limit=limit),
                self.timeout,
            )
        except (OSError, asyncio.TimeoutError) as e:
            raise ConnectionError(
                f"failed to connect to {self.host}:{self.port}: {e}"
            ) from e
        sock = self._writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except OSError:
                pass
            self._reader = self._writer = None

    async def __aenter__(self) -> "AsyncMerkleKVClient":
        if self._writer is None:
            await self.connect()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def _request(self, line: str) -> str:
        if self._writer is None:
            raise ConnectionError("not connected")
        payload = line.encode("utf-8") + b"\r\n"
        try:
            self._writer.write(payload)
            self.bytes_sent += len(payload)
            await self._writer.drain()
        except OSError as e:
            # Wrap like the sync client's send path: callers that heal
            # connection failures (PartitionedClient replica rotation)
            # match on the module's typed ConnectionError, and a builtin
            # ConnectionResetError from drain() must not slip past them.
            raise ConnectionError(f"send failed: {e}") from e
        return await self._read_line()

    async def _read_line(self) -> str:
        try:
            raw = await asyncio.wait_for(
                self._reader.readline(), self.timeout
            )
        except asyncio.TimeoutError as e:
            # Sync-client parity: a timeout is MerkleKVError, a transport
            # death is the typed ConnectionError (rotation matches it).
            raise MerkleKVError(f"timed out after {self.timeout}s") from e
        except OSError as e:
            raise ConnectionError(f"recv failed: {e}") from e
        if not raw:
            raise ConnectionError("server closed connection")
        self.bytes_received += len(raw)
        return raw.rstrip(b"\r\n").decode("utf-8", "surrogateescape")

    def _trace_token(self) -> Optional[str]:
        if self.trace_provider is None or self._peer_traced is False:
            return None
        try:
            return self.trace_provider()
        except Exception:
            return None

    def _version_token(
        self, require_settled: bool, force: bool
    ) -> Optional[str]:
        # Same rules as the sync client: force is an explicit exactness
        # request and attaches even when stamping is off or unsettled.
        if self._peer_stamped is False:
            return None
        if force:
            return "vs=03"
        if not self.version_stamps:
            return None
        if require_settled and self._peer_stamped is not True:
            return None
        return "vs=01"

    async def _traced_request(
        self,
        line: str,
        require_settled: bool = False,
        stamp: bool = False,
        force: bool = False,
        trace: bool = True,
        partition: bool = False,
    ) -> str:
        """Async twin of the sync client's ``_traced_request``: same token
        append (partition address first, then version stamp, trace last),
        same newest-capability-first fallback on an arity ERROR, same
        settled-capability rule for optional-trailing-argument verbs, and
        the same no-fallback rule for the partition address."""
        if stamp:
            self.last_stamp = None
        if partition and self.partition_id is not None and (
            self.partition_id >= 0
        ):
            line = f"{line} pt={self.partition_id}"
        vtok = self._version_token(require_settled, force) if stamp else None
        ttok = self._trace_token() if trace else None
        if ttok is not None and require_settled and self._peer_traced is not True:
            ttok = None
        if vtok is None and ttok is None:
            return await self._request(line)
        suffix = (f" {vtok}" if vtok else "") + (f" {ttok}" if ttok else "")
        resp = await self._request(line + suffix)
        if resp.startswith("ERROR ") and _is_trace_capability_error(resp):
            if vtok is not None:
                self._peer_stamped = False
                resp = await self._request(
                    line + (f" {ttok}" if ttok else "")
                )
                if ttok is None:
                    return resp
                if resp.startswith("ERROR ") and _is_trace_capability_error(
                    resp
                ):
                    self._peer_traced = False
                    return await self._request(line)
                self._peer_traced = True
                return resp
            self._peer_traced = False
            return await self._request(line)
        if vtok is not None:
            self._peer_stamped = True
        if ttok is not None:
            self._peer_traced = True
        return resp

    async def get(self, key: str) -> Optional[str]:
        return _parse_value(await self._request(f"GET {key}"))

    async def set(self, key: str, value: str) -> bool:
        resp = _parse_simple(await self._request(f"SET {key} {value}"))
        if resp != "OK":
            raise ProtocolError(f"unexpected response: {resp}")
        return True

    async def delete(self, key: str) -> bool:
        resp = _parse_simple(await self._request(f"DELETE {key}"))
        if resp == "DELETED":
            return True
        if resp == "NOT_FOUND":
            return False
        raise ProtocolError(f"unexpected response: {resp}")

    async def increment(self, key: str, amount: Optional[int] = None) -> int:
        cmd = f"INC {key}" if amount is None else f"INC {key} {amount}"
        return int(_parse_value(await self._request(cmd)))

    async def scan(self, prefix: str = "") -> list[str]:
        cmd = f"SCAN {prefix}" if prefix else "SCAN"
        resp = _parse_simple(await self._request(cmd))
        if not resp.startswith("KEYS "):
            raise ProtocolError(f"unexpected response: {resp}")
        return [await self._read_line() for _ in range(int(resp[5:]))]

    async def hash(
        self, pattern: Optional[str] = None, force: bool = False
    ) -> str:
        """Async HASH — same stamped-answer semantics as the sync client's
        ``hash`` (version stamp in ``last_stamp``, ``force`` refreshes)."""
        if pattern is not None:
            resp = _parse_simple(await self._request(f"HASH {pattern}"))
            if not resp.startswith("HASH "):
                raise ProtocolError(f"unexpected response: {resp}")
            return resp.rsplit(" ", 1)[-1]
        resp = _parse_simple(
            await self._traced_request(
                "HASH", require_settled=True, stamp=True, force=force,
                trace=False, partition=True,
            )
        )
        fields = resp.split(" ")
        if len(fields) == 3 and fields[1].startswith("vs="):
            # Old server echoed the token as a pattern: capability miss —
            # settle and retry plain (its live answer is exact anyway).
            self._peer_stamped = False
            resp = _parse_simple(await self._request("HASH"))
            fields = resp.split(" ")
        if fields[0] != "HASH" or len(fields) not in (2, 4):
            raise ProtocolError(f"unexpected response: {resp}")
        if len(fields) == 4:
            try:
                self.last_stamp = (int(fields[2]), int(fields[3]))
            except ValueError as e:
                raise ProtocolError(
                    f"malformed HASH stamp: {resp!r}"
                ) from e
        return fields[1]

    async def leaf_hashes_page(
        self, count: int, after: str = "", upto: Optional[str] = None
    ) -> tuple[list[tuple[str, Optional[str], int]], bool]:
        """Async HASHPAGE — same semantics as the sync client's
        ``leaf_hashes_page``: up to ``count`` (key, digest hex | None, ts)
        rows strictly after ``after`` in sorted order; ``done`` means the
        keyspace (or, with ``upto``, the bounded range) is exhausted."""
        if upto is not None and not after:
            raise ValueError("bounded HASHPAGE requires a non-empty cursor")
        if upto is not None:
            cmd = f"HASHPAGE {count} {after} {upto}"
        elif after:
            cmd = f"HASHPAGE {count} {after}"
        else:
            cmd = f"HASHPAGE {count}"
        n, stamp = _parse_hashes_header(
            await self._traced_request(cmd, require_settled=True, stamp=True)
        )
        if stamp is not None:
            self.last_stamp = (stamp, 0)
        rows: list[tuple[str, Optional[str], int]] = []
        for _ in range(n):
            parts = (await self._read_line()).split(" ")
            if len(parts) != 3:
                raise ProtocolError(
                    f"malformed HASHPAGE row: {' '.join(parts)!r}"
                )
            digest = None if parts[1] == "-" else parts[1]
            try:
                if digest is not None:
                    bytes.fromhex(digest)
                ts = int(parts[2])
            except ValueError as e:
                raise ProtocolError(
                    f"malformed HASHPAGE row: {' '.join(parts)!r}"
                ) from e
            rows.append((parts[0], digest, ts))
        return rows, n < count

    async def tree_level(
        self, level: int, lo: int, hi: int, force: bool = False
    ) -> tuple[list[tuple[int, str]], int]:
        """Async TREELEVEL — same semantics as the sync client's
        ``tree_level`` (stamp in ``last_stamp``, ``force`` refreshes)."""
        resp = _parse_simple(
            await self._traced_request(
                f"TREELEVEL {level} {lo} {hi}", stamp=True, force=force,
                partition=True,
            )
        )
        if not resp.startswith("NODES "):
            raise ProtocolError(f"unexpected response: {resp}")
        fields = resp[6:].split(" ")
        try:
            if len(fields) == 2:
                count, n = int(fields[0]), int(fields[1])
            elif len(fields) == 4:
                count, n = int(fields[0]), int(fields[1])
                self.last_stamp = (int(fields[2]), int(fields[3]))
            else:
                raise ValueError("NODES header must carry 2 or 4 fields")
        except ValueError as e:
            raise ProtocolError(f"unexpected response: {resp}") from e
        rows: list[tuple[int, str]] = []
        for _ in range(count):
            line = await self._read_line()
            idx_s, _, hexd = line.partition(" ")
            try:
                idx = int(idx_s)
                if len(bytes.fromhex(hexd)) != 32:
                    raise ValueError("digest must be 32 bytes")
            except ValueError as e:
                raise ProtocolError(f"malformed TREELEVEL row: {line!r}") from e
            rows.append((idx, hexd))
        return rows, n

    async def partition_map(self):
        """The node's versioned partition map (PARTMAP): partitioned
        cluster mode is not in the torch port yet, so this raises."""
        from merklekv_tpu_torch.unported import refuse

        refuse("partitions")

    async def snap_meta(self) -> tuple[int, int, int, str]:
        """Async SNAPMETA — same semantics as the sync client's
        ``snap_meta``."""
        return _parse_snapmeta(
            _parse_simple(await self._traced_request("SNAPMETA"))
        )

    async def snap_chunk(self, seq: int, offset: int, count: int) -> bytes:
        """Async SNAPCHUNK — same verify-or-raise semantics as the sync
        client's ``snap_chunk``."""
        resp = _parse_simple(
            await self._traced_request(f"SNAPCHUNK {seq} {offset} {count}")
        )
        off, rawlen, crc = _parse_chunk_header(resp)
        payload = await self._read_line()
        return _decode_chunk(off, rawlen, crc, payload, offset)

    async def ping(self, message: str = "") -> str:
        cmd = f"PING {message}" if message else "PING"
        return _parse_simple(await self._request(cmd))

    async def stats(self) -> dict[str, str]:
        resp = _parse_simple(await self._request("STATS"))
        if resp != "STATS":
            raise ProtocolError(f"unexpected response: {resp}")
        return await self._read_kv_block()

    async def metrics(self) -> dict[str, str]:
        """Control-plane counter snapshot — same wire shape and parsing
        rules as the sync client's ``metrics()`` (METRICS/STATS parity is
        covered by the test suite)."""
        resp = _parse_simple(await self._request("METRICS"))
        if resp != "METRICS":
            raise ProtocolError(f"unexpected response: {resp}")
        return await self._read_kv_block()

    async def _read_kv_block(self) -> dict[str, str]:
        # Same END-or-sentinel protocol as the sync client: pipeline a PING
        # sentinel so terminator-less servers (reference parity mode) still
        # delimit the block.
        payload = b"PING __end__\r\n"
        self._writer.write(payload)
        self.bytes_sent += len(payload)
        await self._writer.drain()
        out: dict[str, str] = {}
        while True:
            line = await self._read_line()
            if line == "END":
                while (await self._read_line()) != "PONG __end__":
                    pass  # drain to the sentinel reply
                return out
            if line == "PONG __end__":
                return out  # terminator-less server
            name, _, value = line.partition(":")
            out[name] = value

    async def trace(self, n: int = 8) -> list[dict[str, str]]:
        """Async TRACE — same semantics as the sync client's ``trace``."""
        resp = _parse_simple(await self._request(f"TRACE {n}"))
        if not resp.startswith("TRACES "):
            raise ProtocolError(f"unexpected response: {resp}")
        rows = []
        while True:
            line = await self._read_line()
            if line == "END":
                return rows
            rows.append(
                dict(f.split("=", 1) for f in line.split(" ") if "=" in f)
            )

    async def trace_dump(self, n: int = 0) -> list[dict[str, str]]:
        """Async TRACEDUMP — same semantics as the sync client's
        ``trace_dump``."""
        resp = _parse_simple(await self._request(f"TRACEDUMP {n}"))
        if not resp.startswith("SPANS "):
            raise ProtocolError(f"unexpected response: {resp}")
        rows = []
        while True:
            line = await self._read_line()
            if line == "END":
                return rows
            rows.append(
                dict(f.split("=", 1) for f in line.split(" ") if "=" in f)
            )

    async def flight(self, n: int = 64) -> list[dict[str, str]]:
        """Async FLIGHT — same semantics as the sync client's ``flight``."""
        resp = _parse_simple(await self._request(f"FLIGHT {n}"))
        if not resp.startswith("EVENTS "):
            raise ProtocolError(f"unexpected response: {resp}")
        rows = []
        while True:
            line = await self._read_line()
            if line == "END":
                return rows
            rows.append(
                dict(f.split("=", 1) for f in line.split(" ") if "=" in f)
            )

    async def health_check(self) -> bool:
        try:
            return (await self.ping()).startswith("PONG")
        except (MerkleKVError, asyncio.TimeoutError):
            return False

    async def pipeline(self, commands: Iterable[str]) -> list[str]:
        cmds = list(commands)
        if self._writer is None:
            raise ConnectionError("not connected")
        payload = "".join(c + "\r\n" for c in cmds).encode("utf-8")
        self._writer.write(payload)
        self.bytes_sent += len(payload)
        await self._writer.drain()
        return [await self._read_line() for _ in cmds]


# ------------------------------------------------- partition-aware clients


class PartitionedClient:
    """Smart client for partitioned cluster mode: routes every key to its
    partition's replica group using the cluster's versioned partition map
    (docs/PROTOCOL.md "Partitioned cluster mode").

        with PartitionedClient(["host:7001", "host:7003"]) as c:
            c.set("k", "v")          # lands on partition_of("k")'s group
            c.mget(["a", "b", "c"])  # fans out per partition, merged

    Bootstraps the map from any ``seeds`` node via PARTMAP. A node
    answering ``ERROR MOVED <pid> <epoch>`` (this client's map went
    stale) triggers a map refresh + re-route — bounded by
    ``moved_retries``, backing off between attempts — so a rebalance is a
    transient blip, never a silent wrong-node read. A dead replica
    rotates to its partition siblings.

    One TCP connection per partition, lazily opened, NOT thread-safe
    (same contract as :class:`MerkleKVClient`).
    """

    def __init__(
        self,
        seeds: Sequence[str],
        timeout: float = 5.0,
        max_value_bytes: int = 1 << 20,
        moved_retries: int = 4,
        busy_retries: int = 8,
    ) -> None:
        if not seeds:
            raise ValueError("PartitionedClient needs at least one seed")
        self.seeds = list(seeds)
        self.timeout = timeout
        self.max_value_bytes = max_value_bytes
        self.moved_retries = moved_retries
        # BUSY rides its own budget, separate from MOVED: a live
        # rebalance fences the moving range for the flip window (writes
        # answer the retryable BUSY), then either clears it (rollback) or
        # flips the epoch (the next attempt heals through MOVED). Budgets
        # must not share, or a long fence would starve the MOVED healing
        # that follows it.
        self.busy_retries = busy_retries
        self._map = None  # PartitionMap
        self._conns: dict[int, MerkleKVClient] = {}
        self._replica_idx: dict[int, int] = {}

    # -- lifecycle ---------------------------------------------------------
    def connect(self) -> "PartitionedClient":
        self.refresh_map()
        return self

    def close(self) -> None:
        for c in self._conns.values():
            c.close()
        self._conns.clear()

    def __enter__(self) -> "PartitionedClient":
        if self._map is None:
            self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def map(self):
        """The PartitionMap currently routing (None before connect)."""
        return self._map

    @property
    def epoch(self) -> int:
        return self._map.epoch if self._map is not None else 0

    # -- map management ----------------------------------------------------
    def refresh_map(self, min_epoch: int = 0) -> None:
        """Fetch the newest partition map reachable: seeds first, then
        every replica the current map names. Stops early at a map with
        ``epoch >= min_epoch`` (the epoch a MOVED answer carried);
        otherwise keeps the newest epoch seen. Raises ConnectionError when
        no candidate serves a valid map."""
        candidates: list[str] = list(self.seeds)
        if self._map is not None:
            for reps in self._map.replicas:
                for a in reps:
                    if a not in candidates:
                        candidates.append(a)
        best = None
        errors: list[str] = []
        for addr in candidates:
            host, _, port = addr.rpartition(":")
            try:
                with MerkleKVClient(
                    host, int(port), timeout=self.timeout
                ) as c:
                    m = c.partition_map()
            except (MerkleKVError, ValueError) as e:
                errors.append(f"{addr}: {e}")
                continue
            if best is None or m.epoch > best.epoch:
                best = m
            if best.epoch >= min_epoch > 0:
                break
        if best is None:
            raise ConnectionError(
                "no reachable node served a partition map: "
                + "; ".join(errors[:4])
            )
        if self._map is None or best.epoch >= self._map.epoch:
            if (
                self._map is not None
                and best.count != self._map.count
            ):
                # A partition-count change remaps every key: drop all
                # cached connections, not just the refused one.
                self.close()
            self._map = best

    def _drop(self, pid: int, rotate: bool = False) -> None:
        c = self._conns.pop(pid, None)
        if c is not None:
            c.close()
        if rotate:
            self._replica_idx[pid] = self._replica_idx.get(pid, 0) + 1

    def _client(self, pid: int) -> MerkleKVClient:
        c = self._conns.get(pid)
        if c is not None:
            return c
        if not 0 <= pid < self._map.count:
            # A refresh shrank the map after this operation resolved its
            # partition: surface the typed routing error (the _routed
            # retry refreshes and re-resolves) — never a raw IndexError.
            raise MovedError(
                f"MOVED {pid} {self._map.epoch}", pid, self._map.epoch
            )
        reps = self._map.replicas[pid]
        start = self._replica_idx.get(pid, 0)
        last: Optional[Exception] = None
        for i in range(len(reps)):
            addr = reps[(start + i) % len(reps)]
            host, _, port = addr.rpartition(":")
            try:
                c = MerkleKVClient(
                    host,
                    int(port),
                    timeout=self.timeout,
                    max_value_bytes=self.max_value_bytes,
                ).connect()
            except ConnectionError as e:
                last = e
                continue
            self._replica_idx[pid] = (start + i) % len(reps)
            self._conns[pid] = c
            return c
        raise ConnectionError(
            f"no reachable replica for partition {pid}: {last}"
        )

    def _routed(self, pid_of, fn):
        """THE routing-retry loop (every single-partition operation rides
        it): resolve the partition — re-resolved each attempt, a
        refreshed map may re-home the work — run ``fn(client, pid)``
        against its connection, and heal routing failures: MOVED
        refreshes the map (at least to the refusing node's epoch) and
        re-routes; a dead connection rotates to the next replica. Bounded
        by ``moved_retries`` with backoff."""
        if self._map is None:
            self.refresh_map()
        last: Optional[Exception] = None
        busy_left = max(0, self.busy_retries)
        busy_delay = 0.05
        for attempt in range(max(1, self.moved_retries)):
            if attempt:
                time.sleep(min(0.05 * (2 ** (attempt - 1)), 0.5))
            while True:
                pid = pid_of()
                try:
                    return fn(self._client(pid), pid)
                except ServerBusyError as e:
                    # Rebalance fence window: wait it out on its own
                    # budget, then re-route — the map may have flipped
                    # under the fence.
                    last = e
                    if busy_left <= 0:
                        raise
                    busy_left -= 1
                    time.sleep(busy_delay)
                    busy_delay = min(busy_delay * 2, 0.5)
                    try:
                        self.refresh_map()
                    except ConnectionError:
                        pass
                    continue
                except MovedError as e:
                    last = e
                    self._drop(pid)
                    try:
                        self.refresh_map(min_epoch=e.epoch)
                    except ConnectionError as re:
                        last = re
                except ConnectionError as e:
                    last = e
                    self._drop(pid, rotate=True)
                break
        raise last  # type: ignore[misc]

    def _run(self, key: str, fn):
        """Route one single-key operation through the shared retry loop."""
        return self._routed(
            lambda: self._map.partition_for_key(key),
            lambda c, _pid: fn(c),
        )

    def _run_grouped(self, keys: Sequence[str], fn):
        """Fan a multi-key operation out per partition and merge: ``fn``
        receives (client, keys-subset) per touched partition. The whole
        operation retries on MOVED/connection failure — regrouped under
        the refreshed map."""
        if self._map is None:
            self.refresh_map()
        last: Optional[Exception] = None
        busy_left = max(0, self.busy_retries)
        busy_delay = 0.05
        for attempt in range(max(1, self.moved_retries)):
            if attempt:
                time.sleep(min(0.05 * (2 ** (attempt - 1)), 0.5))
            while True:
                groups: dict[int, list[str]] = {}
                for k in keys:
                    groups.setdefault(
                        self._map.partition_for_key(k), []
                    ).append(k)
                out = []
                try:
                    for pid, sub in sorted(groups.items()):
                        out.append((sub, fn(self._client(pid), sub)))
                    return out
                except ServerBusyError as e:
                    # Rebalance fence window (same shape as _routed):
                    # separate budget, regrouped under a refreshed map.
                    last = e
                    if busy_left <= 0:
                        raise
                    busy_left -= 1
                    time.sleep(busy_delay)
                    busy_delay = min(busy_delay * 2, 0.5)
                    try:
                        self.refresh_map()
                    except ConnectionError:
                        pass
                    continue
                except MovedError as e:
                    last = e
                    self.close()
                    try:
                        self.refresh_map(min_epoch=e.epoch)
                    except ConnectionError as re:
                        last = re
                except ConnectionError as e:
                    last = e
                    self.close()
                break
        raise last  # type: ignore[misc]

    # -- data plane --------------------------------------------------------
    def get(self, key: str) -> Optional[str]:
        return self._run(key, lambda c: c.get(key))

    def set(self, key: str, value: str) -> bool:
        return self._run(key, lambda c: c.set(key, value))

    def delete(self, key: str) -> bool:
        return self._run(key, lambda c: c.delete(key))

    def increment(self, key: str, amount: Optional[int] = None) -> int:
        return self._run(key, lambda c: c.increment(key, amount))

    def decrement(self, key: str, amount: Optional[int] = None) -> int:
        return self._run(key, lambda c: c.decrement(key, amount))

    def append(self, key: str, value: str) -> str:
        return self._run(key, lambda c: c.append(key, value))

    def prepend(self, key: str, value: str) -> str:
        return self._run(key, lambda c: c.prepend(key, value))

    def exists(self, *keys: str) -> int:
        return sum(
            n for _, n in self._run_grouped(keys, lambda c, ks: c.exists(*ks))
        )

    def mget(self, keys: Sequence[str]) -> dict[str, Optional[str]]:
        out: dict[str, Optional[str]] = {}
        for _, part in self._run_grouped(keys, lambda c, ks: c.mget(ks)):
            out.update(part)
        return out

    def mset(self, pairs: dict[str, str]) -> bool:
        keys = list(pairs)
        self._run_grouped(
            keys, lambda c, ks: c.mset({k: pairs[k] for k in ks})
        )
        return True

    # -- partition-scoped tree plane ---------------------------------------
    def partition_root(self, pid: int, force: bool = False) -> str:
        """Merkle root of ONE partition, served pt=-addressed by a member
        of its replica group — a wrong-partition answer comes back MOVED,
        never as a silently different tree."""
        if self._map is None:
            self.refresh_map()
        if not 0 <= pid < self._map.count:
            raise ValueError(f"partition {pid} out of range")

        def op(c: MerkleKVClient, p: int) -> str:
            c.partition_id = p
            return c.hash(force=force)

        return self._routed(lambda: pid, op)

    def partition_roots(self, force: bool = False) -> dict[int, str]:
        """Per-partition Merkle roots across the whole cluster — the
        health surface a partition-local incident shows up in (one
        partition's root diverges, siblings' stay put)."""
        if self._map is None:
            self.refresh_map()
        return {
            pid: self.partition_root(pid, force=force)
            for pid in range(self._map.count)
        }


class AsyncPartitionedClient:
    """asyncio twin of :class:`PartitionedClient` over the async base
    client's surface (get/set/delete/increment): same map bootstrap from
    seeds, same MOVED -> refresh -> re-route healing, same replica
    rotation on a dead connection."""

    def __init__(
        self,
        seeds: Sequence[str],
        timeout: float = 5.0,
        max_value_bytes: int = 1 << 20,
        moved_retries: int = 4,
        busy_retries: int = 8,
    ) -> None:
        if not seeds:
            raise ValueError("AsyncPartitionedClient needs at least one seed")
        self.seeds = list(seeds)
        self.timeout = timeout
        self.max_value_bytes = max_value_bytes
        self.moved_retries = moved_retries
        self.busy_retries = busy_retries
        self._map = None
        self._conns: dict[int, AsyncMerkleKVClient] = {}
        self._replica_idx: dict[int, int] = {}

    async def connect(self) -> "AsyncPartitionedClient":
        await self.refresh_map()
        return self

    async def close(self) -> None:
        for c in self._conns.values():
            await c.close()
        self._conns.clear()

    async def __aenter__(self) -> "AsyncPartitionedClient":
        if self._map is None:
            await self.connect()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    @property
    def map(self):
        return self._map

    @property
    def epoch(self) -> int:
        return self._map.epoch if self._map is not None else 0

    async def refresh_map(self, min_epoch: int = 0) -> None:
        candidates: list[str] = list(self.seeds)
        if self._map is not None:
            for reps in self._map.replicas:
                for a in reps:
                    if a not in candidates:
                        candidates.append(a)
        best = None
        errors: list[str] = []
        for addr in candidates:
            host, _, port = addr.rpartition(":")
            try:
                async with AsyncMerkleKVClient(
                    host, int(port), timeout=self.timeout
                ) as c:
                    m = await c.partition_map()
            except (MerkleKVError, ValueError, asyncio.TimeoutError) as e:
                errors.append(f"{addr}: {e}")
                continue
            if best is None or m.epoch > best.epoch:
                best = m
            if best.epoch >= min_epoch > 0:
                break
        if best is None:
            raise ConnectionError(
                "no reachable node served a partition map: "
                + "; ".join(errors[:4])
            )
        if self._map is None or best.epoch >= self._map.epoch:
            if self._map is not None and best.count != self._map.count:
                await self.close()
            self._map = best

    async def _drop(self, pid: int, rotate: bool = False) -> None:
        c = self._conns.pop(pid, None)
        if c is not None:
            await c.close()
        if rotate:
            self._replica_idx[pid] = self._replica_idx.get(pid, 0) + 1

    async def _client(self, pid: int) -> AsyncMerkleKVClient:
        c = self._conns.get(pid)
        if c is not None:
            return c
        if not 0 <= pid < self._map.count:
            # Same shrunk-map rule as the sync client's _client.
            raise MovedError(
                f"MOVED {pid} {self._map.epoch}", pid, self._map.epoch
            )
        reps = self._map.replicas[pid]
        start = self._replica_idx.get(pid, 0)
        last: Optional[Exception] = None
        for i in range(len(reps)):
            addr = reps[(start + i) % len(reps)]
            host, _, port = addr.rpartition(":")
            try:
                c = await AsyncMerkleKVClient(
                    host,
                    int(port),
                    timeout=self.timeout,
                    max_value_bytes=self.max_value_bytes,
                ).connect()
            except ConnectionError as e:
                last = e
                continue
            self._replica_idx[pid] = (start + i) % len(reps)
            self._conns[pid] = c
            return c
        raise ConnectionError(
            f"no reachable replica for partition {pid}: {last}"
        )

    async def _routed(self, pid_of, fn):
        """Async twin of the sync client's ``_routed`` retry loop."""
        if self._map is None:
            await self.refresh_map()
        last: Optional[Exception] = None
        busy_left = max(0, self.busy_retries)
        busy_delay = 0.05
        for attempt in range(max(1, self.moved_retries)):
            if attempt:
                await asyncio.sleep(min(0.05 * (2 ** (attempt - 1)), 0.5))
            while True:
                pid = pid_of()
                try:
                    return await fn(await self._client(pid), pid)
                except ServerBusyError as e:
                    # Rebalance fence window (same shape as the sync
                    # client): own budget, re-routed after the wait.
                    last = e
                    if busy_left <= 0:
                        raise
                    busy_left -= 1
                    await asyncio.sleep(busy_delay)
                    busy_delay = min(busy_delay * 2, 0.5)
                    try:
                        await self.refresh_map()
                    except ConnectionError:
                        pass
                    continue
                except MovedError as e:
                    last = e
                    await self._drop(pid)
                    try:
                        await self.refresh_map(min_epoch=e.epoch)
                    except ConnectionError as re:
                        last = re
                except ConnectionError as e:
                    last = e
                    await self._drop(pid, rotate=True)
                break
        raise last  # type: ignore[misc]

    async def _run(self, key: str, fn):
        return await self._routed(
            lambda: self._map.partition_for_key(key),
            lambda c, _pid: fn(c),
        )

    async def get(self, key: str) -> Optional[str]:
        return await self._run(key, lambda c: c.get(key))

    async def set(self, key: str, value: str) -> bool:
        return await self._run(key, lambda c: c.set(key, value))

    async def delete(self, key: str) -> bool:
        return await self._run(key, lambda c: c.delete(key))

    async def increment(self, key: str, amount: Optional[int] = None) -> int:
        return await self._run(key, lambda c: c.increment(key, amount))

    async def partition_root(self, pid: int, force: bool = False) -> str:
        if self._map is None:
            await self.refresh_map()
        if not 0 <= pid < self._map.count:
            raise ValueError(f"partition {pid} out of range")

        async def op(c: AsyncMerkleKVClient, p: int) -> str:
            c.partition_id = p
            return await c.hash(force=force)

        return await self._routed(lambda: pid, op)
