"""CRC32-framed append-only write-ahead log.

A copy of ``merklekv_tpu/storage/wal.py``; the segment format is the
reference's, byte for byte.

The durable subsystem's ground truth between snapshots: every write the
node acknowledges eventually lands here as one frame, appended with a
single ``write(2)`` so a crash can only tear the *tail* of the newest
segment, never interleave two records. The reference's TODO'd sled engine
(the reference's src/store/mod.rs) is the unbuilt analog; the on-disk shape
here instead follows the native LogEngine's discipline (engine.cc:432-470):
length-framed records, CRC over the payload, torn tails detected and cut,
never "repaired" by guessing.

Segment layout (``wal-<seq 16 digits>.log``):

    magic   8 bytes  b"MKVWAL01"
    frame*  repeated until EOF

Frame:

    crc32   u32 LE   zlib.crc32(payload)
    length  u32 LE   len(payload)
    payload          see below

Payload:

    op      u8       1=SET  2=DEL  3=TRUNCATE
    ts      u64 LE   unix nanoseconds (LWW order)
    klen    u32 LE
    key     klen bytes
    vlen    u32 LE   (SET only)
    value   vlen bytes (SET only)

Replay goes through the engine's LWW-conditional verbs
(``set_if_newer``/``delete_if_newer``), so frames are idempotent and a
record that also made it into a snapshot applies as a no-op.
"""

from __future__ import annotations

import errno
import os
import re
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Iterable, Optional

__all__ = [
    "OP_SET",
    "OP_DEL",
    "OP_TRUNCATE",
    "SEGMENT_MAGIC",
    "StorageFullError",
    "WalRecord",
    "SegmentScan",
    "encode_frame",
    "scan_segment",
    "list_segments",
    "segment_path",
    "WalWriter",
    "set_io_hooks",
    "io_write",
    "io_fsync",
]

OP_SET = 1
OP_DEL = 2
OP_TRUNCATE = 3

SEGMENT_MAGIC = b"MKVWAL01"

_FRAME_HDR = struct.Struct("<II")  # crc32, payload length
_SET_HDR = struct.Struct("<BQI")  # op, ts, klen
_U32 = struct.Struct("<I")

# A frame longer than this is a corrupt length field, not a real record
# (keys/values are capped far below by the protocol layer).
_MAX_PAYLOAD = 1 << 28

_SEGMENT_RE = re.compile(r"^wal-(\d{16})\.log$")


class StorageFullError(OSError):
    """A WAL write or fsync failed with a resource errno (ENOSPC / EIO /
    EDQUOT). Typed so the durable store can degrade the NODE (read-only,
    loud metric, ``/healthz``) instead of the error killing the drain
    thread — the failure is about the disk, not the record. Carries the
    original errno."""

    def __init__(self, op: str, cause: OSError) -> None:
        super().__init__(
            cause.errno, f"WAL {op} failed: {cause.strerror or cause}"
        )
        self.op = op


# Errnos that mean "the disk, not the caller": translated into
# StorageFullError at the io seam below. Anything else propagates raw.
_RESOURCE_ERRNOS = frozenset(
    getattr(errno, name)
    for name in ("ENOSPC", "EIO", "EDQUOT")
    if hasattr(errno, name)
)

# -- io seam ----------------------------------------------------------------
# Every WAL write/fsync routes through these module-level hooks. The
# default is the real os call; tests install a deterministic errno
# injector (testing/faults.WalErrnoInjector: fail the Nth write/fsync with
# ENOSPC/EIO) through set_io_hooks — the chaos suite's disk-fault seam,
# exercising the exact code path a real full disk takes without filling
# one.
io_write = os.write
io_fsync = os.fsync


def set_io_hooks(write=None, fsync=None) -> None:
    """Install (or, with None, restore) the WAL io functions. Test seam —
    production code never calls this."""
    global io_write, io_fsync
    io_write = write if write is not None else os.write
    io_fsync = fsync if fsync is not None else os.fsync


def _wal_write(fd: int, data: bytes, op: str = "write") -> None:
    try:
        io_write(fd, data)
    except OSError as e:
        if e.errno in _RESOURCE_ERRNOS:
            raise StorageFullError(op, e) from e
        raise


def _wal_fsync(fd: int, op: str = "fsync") -> None:
    try:
        io_fsync(fd)
    except OSError as e:
        if e.errno in _RESOURCE_ERRNOS:
            raise StorageFullError(op, e) from e
        raise


@dataclass(frozen=True)
class WalRecord:
    op: int
    key: bytes
    value: Optional[bytes]  # None for DEL / TRUNCATE
    ts: int

    def encode_payload(self) -> bytes:
        parts = [_SET_HDR.pack(self.op, self.ts, len(self.key)), self.key]
        if self.op == OP_SET:
            v = self.value if self.value is not None else b""
            parts.append(_U32.pack(len(v)))
            parts.append(v)
        return b"".join(parts)


def encode_frame(rec: WalRecord) -> bytes:
    payload = rec.encode_payload()
    return _FRAME_HDR.pack(zlib.crc32(payload), len(payload)) + payload


def _decode_payload(payload: bytes) -> WalRecord:
    op, ts, klen = _SET_HDR.unpack_from(payload, 0)
    off = _SET_HDR.size
    if off + klen > len(payload):
        raise ValueError("key overruns payload")
    key = payload[off : off + klen]
    off += klen
    value = None
    if op == OP_SET:
        (vlen,) = _U32.unpack_from(payload, off)
        off += _U32.size
        if off + vlen > len(payload):
            raise ValueError("value overruns payload")
        value = payload[off : off + vlen]
        off += vlen
    elif op not in (OP_DEL, OP_TRUNCATE):
        raise ValueError(f"unknown op {op}")
    if off != len(payload):
        raise ValueError("trailing bytes in payload")
    return WalRecord(op, key, value, ts)


@dataclass
class SegmentScan:
    """Result of a torn-tail-tolerant scan of one segment file."""

    path: str
    records: list[WalRecord] = field(default_factory=list)
    good_offset: int = 0  # end of the last whole valid frame
    total_bytes: int = 0
    error: Optional[str] = None  # why the scan stopped early (None = clean)
    torn: bool = False  # failure is consistent with a crash mid-append

    @property
    def clean(self) -> bool:
        return self.error is None


def scan_segment(path: str) -> SegmentScan:
    """Decode frames until EOF or the first bad byte.

    Never raises on bad data: a torn or corrupt region stops the scan and is
    reported through ``error``/``torn``/``good_offset``. ``torn`` is True
    when the failure reaches EOF with an incomplete frame (the signature a
    SIGKILL mid-``write`` leaves); a bad frame with further bytes behind it,
    a CRC mismatch on an interior frame, or a bad segment magic is reported
    as corruption (``torn`` False).
    """
    with open(path, "rb") as f:
        data = f.read()
    scan = SegmentScan(path=path, total_bytes=len(data))
    if len(data) < len(SEGMENT_MAGIC):
        scan.error = "short segment magic"
        scan.torn = True
        return scan
    if data[: len(SEGMENT_MAGIC)] != SEGMENT_MAGIC:
        scan.error = "bad segment magic"
        return scan
    off = len(SEGMENT_MAGIC)
    scan.good_offset = off
    while off < len(data):
        if off + _FRAME_HDR.size > len(data):
            scan.error = "short frame header"
            scan.torn = True
            return scan
        crc, length = _FRAME_HDR.unpack_from(data, off)
        if length > _MAX_PAYLOAD:
            # An implausible length field: either a torn header tail or
            # flipped bits. With no resync marker the distinction doesn't
            # change replay (stop here); report it as corruption unless the
            # frame header itself is the last thing in the file.
            scan.error = f"implausible frame length {length}"
            scan.torn = off + _FRAME_HDR.size >= len(data)
            return scan
        start = off + _FRAME_HDR.size
        end = start + length
        if end > len(data):
            scan.error = "short frame payload"
            scan.torn = True
            return scan
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            scan.error = "crc mismatch"
            scan.torn = end >= len(data)
            return scan
        try:
            rec = _decode_payload(payload)
        except (ValueError, struct.error) as e:
            # CRC passed but the payload doesn't parse: written by a newer
            # format or corrupted before CRC was computed — corruption.
            scan.error = f"payload decode failed: {e}"
            return scan
        scan.records.append(rec)
        off = end
        scan.good_offset = off
    return scan


def segment_path(directory: str, seq: int) -> str:
    return os.path.join(directory, f"wal-{seq:016d}.log")


def list_segments(directory: str) -> list[tuple[int, str]]:
    """Sorted (seq, path) for every WAL segment in ``directory``."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        m = _SEGMENT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def _fsync_dir(directory: str) -> None:
    """Persist a directory entry (segment create/rotate, snapshot rename)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class WalWriter:
    """Appender over the newest segment; rotates at ``segment_bytes``.

    Thread-safe: record producers (event drainer, sync-repair hook,
    replication applier) append concurrently. Each frame goes down in one
    ``os.write`` on an unbuffered fd, so concurrent appends never interleave
    within a frame and a crash tears at most the final frame.

    ``fsync`` policy:
      - ``"always"``: fsync inside every :meth:`append` call;
      - ``"interval"``: the owner calls :meth:`fsync` on its timer;
      - ``"never"``: never fsynced by us (OS writeback only).
    """

    def __init__(
        self,
        directory: str,
        seq: int,
        fsync_policy: str = "interval",
        segment_bytes: int = 4 << 20,
        start_offset: Optional[int] = None,
    ) -> None:
        if fsync_policy not in ("always", "interval", "never"):
            raise ValueError(f"unknown fsync policy: {fsync_policy}")
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._policy = fsync_policy
        self._segment_bytes = max(1, segment_bytes)
        self._mu = threading.Lock()
        self._fd = -1
        self._size = 0
        self._dirty = False
        self.seq = seq
        self.appended = 0
        self.fsyncs = 0
        self.rotations = 0
        self._open_segment(seq, start_offset)

    # -- segment management -------------------------------------------------
    def _open_segment(self, seq: int, start_offset: Optional[int]) -> None:
        path = segment_path(self._dir, seq)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        size = os.fstat(fd).st_size
        if start_offset is not None and start_offset < size:
            # Recovery found a torn tail: cut it before appending, or the
            # next reader would stop at the garbage and lose our appends.
            os.ftruncate(fd, start_offset)
            size = start_offset
        if size == 0:
            _wal_write(fd, SEGMENT_MAGIC, "segment-create")
            size = len(SEGMENT_MAGIC)
            _wal_fsync(fd, "segment-create")
            _fsync_dir(self._dir)
        self._fd = fd
        self._size = size
        self.seq = seq

    def rotate(self) -> int:
        """Close the current segment and start the next; returns new seq."""
        with self._mu:
            return self._rotate_locked()

    def _rotate_locked(self) -> int:
        if self._dirty and self._policy != "never":
            _wal_fsync(self._fd)
            self.fsyncs += 1
            self._dirty = False
        os.close(self._fd)
        self._open_segment(self.seq + 1, None)
        self.rotations += 1
        return self.seq

    # -- appends ------------------------------------------------------------
    def append(self, rec: WalRecord) -> None:
        frame = encode_frame(rec)
        with self._mu:
            if self._size + len(frame) > self._segment_bytes and self._size > len(
                SEGMENT_MAGIC
            ):
                self._rotate_locked()
            _wal_write(self._fd, frame)
            self._size += len(frame)
            self.appended += 1
            self._dirty = True
            if self._policy == "always":
                _wal_fsync(self._fd)
                self.fsyncs += 1
                self._dirty = False

    def append_many(self, recs: Iterable[WalRecord]) -> int:
        """Append a drained batch: frames accumulate into one buffer and go
        down in a single ``write(2)`` per segment stretch (a k-record
        replication frame costs one kernel write, not k), with one fsync
        decision for the whole batch. A crash can still only tear the tail
        — frames are contiguous, so a partial write cuts at some frame
        boundary-or-mid-frame suffix exactly like a torn single append."""
        n = 0
        with self._mu:
            buf = bytearray()
            for rec in recs:
                frame = encode_frame(rec)
                if self._size + len(buf) + len(frame) > self._segment_bytes \
                        and self._size + len(buf) > len(SEGMENT_MAGIC):
                    if buf:
                        _wal_write(self._fd, bytes(buf))
                        self._size += len(buf)
                        buf = bytearray()
                        # Mark before rotating so the closing segment gets
                        # its fsync (rotate flushes only when dirty).
                        self._dirty = True
                    self._rotate_locked()
                buf += frame
                self.appended += 1
                n += 1
            if buf:
                _wal_write(self._fd, bytes(buf))
                self._size += len(buf)
            if n:
                self._dirty = True
                if self._policy == "always":
                    _wal_fsync(self._fd)
                    self.fsyncs += 1
                    self._dirty = False
        return n

    def fsync(self) -> bool:
        """Flush if dirty; returns whether an fsync actually happened."""
        with self._mu:
            if not self._dirty:
                return False
            _wal_fsync(self._fd)
            self.fsyncs += 1
            self._dirty = False
            return True

    @property
    def size(self) -> int:
        return self._size

    def close(self) -> None:
        with self._mu:
            if self._fd < 0:
                return
            if self._dirty and self._policy != "never":
                try:
                    _wal_fsync(self._fd)
                    self.fsyncs += 1
                except StorageFullError:
                    pass  # closing a full disk: nothing left to do
            os.close(self._fd)
            self._fd = -1
