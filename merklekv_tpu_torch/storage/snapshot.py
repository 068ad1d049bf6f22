"""Merkle-stamped snapshots of engine state.

A copy of ``merklekv_tpu/storage/snapshot.py``, its imports pointed at the
port's modules, except at the device site: the root of a large keyspace is
hashed by ``merkle/torch_engine.py`` (``leaf_digests`` + ``tree_root``, so
``leaf_kernel`` and ``node_level_kernel``) on the node's device
(``utils/deviceenv.py``: ``MERKLEKV_TORCH_DEVICE``, unset meaning CUDA). A
failure there is counted in ``device.fallbacks`` and re-raised; the root is
never computed on the host after a device error (the reference went on with
hashlib). The file format is the reference's, byte for byte.

A snapshot serializes the engine's whole keyspace (``snapshot()`` +
per-key timestamps) and its tombstones, and stamps the header with the
Merkle root of the live items — computed by the same bulk rebuild path
that serves anti-entropy. Recovery recomputes the root from the bytes it
actually read back and refuses (or falls back) on mismatch, so a restart
is *verified* against the state the snapshot claims to hold, not assumed
— the checkpoint-integrity shape "Asynchronous Merkle Trees" (PAPERS.md)
argues for.

File layout (``snapshot-<seq 16 digits>.snap``), written to a temp name,
fsynced, then atomically renamed:

    magic     8 bytes  b"MKVSNAP1"
    version   u32 LE   1
    wal_seq   u64 LE   replay WAL segments with seq >= wal_seq
    root      32 bytes Merkle root of live items (zeros when empty)
    n_items   u64 LE
    n_tombs   u64 LE
    item*     klen u32 | key | vlen u32 | value | ts u64      (sorted by key)
    tomb*     klen u32 | key | ts u64
    crc32     u32 LE   zlib.crc32 of everything above

The trailing CRC catches a torn snapshot write that survived the rename
(it cannot on POSIX, but a copied/backed-up file can be short) and bit
rot; the root stamp catches anything subtler.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass

from merklekv_tpu_torch.merkle.encoding import EMPTY_ROOT_HEX, leaf_hash
from merklekv_tpu_torch.utils import deviceenv

__all__ = [
    "SNAPSHOT_MAGIC",
    "Snapshot",
    "SnapshotCorruptError",
    "RootMismatchError",
    "compute_root_hex",
    "write_snapshot",
    "read_snapshot",
    "parse_snapshot_bytes",
    "read_snapshot_wal_seq",
    "read_snapshot_header",
    "verify_snapshot",
    "list_snapshots",
    "snapshot_path",
]

SNAPSHOT_MAGIC = b"MKVSNAP1"
_HDR = struct.Struct("<8sIQ32sQQ")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

_SNAP_RE = re.compile(r"^snapshot-(\d{16})\.snap$")

# Below this many live keys the device round-trip costs more than host
# hashing; "auto" stays on the CPU path (and never imports torch) until the
# keyspace is large enough to amortize it.
DEVICE_MIN_KEYS = 4096


class SnapshotCorruptError(RuntimeError):
    """Snapshot file unreadable: bad magic/version, short body, CRC fail."""


class RootMismatchError(RuntimeError):
    """Snapshot decoded cleanly but its content hashes to a different root
    than the header stamp — the state is not what it claims to be."""

    def __init__(self, path: str, stamped: str, actual: str) -> None:
        super().__init__(
            f"snapshot root mismatch in {path}: stamped {stamped[:16]}…, "
            f"recomputed {actual[:16]}…"
        )
        self.path = path
        self.stamped = stamped
        self.actual = actual


@dataclass
class Snapshot:
    path: str
    wal_seq: int
    root_hex: str
    items: list[tuple[bytes, bytes, int]]  # (key, value, ts), sorted by key
    tombstones: list[tuple[bytes, int]]


def compute_root_hex(
    items: list[tuple[bytes, bytes]],
    engine: str = "auto",
    device_min_keys: int = DEVICE_MIN_KEYS,
) -> str:
    """Merkle root (hex) over sorted (key, value) pairs via the bulk path.

    ``engine``: "cpu" pins host hashing; "tpu" (the reference's name for
    the device) always takes the node's device; "auto" takes the device
    only for keyspaces big enough to amortize the round-trip. A device
    failure is counted in ``device.fallbacks`` and raised — exactly how the
    sync manager's leaf hashing fails in the port.
    """
    if not items:
        return EMPTY_ROOT_HEX
    if engine != "cpu" and (engine == "tpu" or len(items) >= device_min_keys):
        try:
            return _device_root_hex(items)
        except Exception as e:
            deviceenv.note_device_failure(e, "snapshot root")
            raise
    from merklekv_tpu_torch.merkle.cpu import build_levels

    hashes = [leaf_hash(k, v) for k, v in items]
    return build_levels(hashes)[-1][0].hex()


def _device_root_hex(items: list[tuple[bytes, bytes]]) -> str:
    from merklekv_tpu_torch.merkle.torch_engine import leaf_digests, tree_root
    from merklekv_tpu_torch.ops.sha256 import digest_to_bytes
    from merklekv_tpu_torch.utils.torchenv import words_np

    digests = leaf_digests([k for k, _ in items], [v for _, v in items],
                           device=deviceenv.resolve())
    return digest_to_bytes(words_np(tree_root(digests))).hex()


def snapshot_path(directory: str, seq: int) -> str:
    return os.path.join(directory, f"snapshot-{seq:016d}.snap")


def list_snapshots(directory: str) -> list[tuple[int, str]]:
    """Sorted (seq, path) for every snapshot file in ``directory``."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        m = _SNAP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def write_snapshot(
    directory: str,
    seq: int,
    items: list[tuple[bytes, bytes, int]],
    tombstones: list[tuple[bytes, int]],
    wal_seq: int,
    root_hex: str,
) -> str:
    """Serialize + stamp + atomically install ``snapshot-<seq>.snap``."""
    parts = [
        _HDR.pack(
            SNAPSHOT_MAGIC,
            1,
            wal_seq,
            bytes.fromhex(root_hex),
            len(items),
            len(tombstones),
        )
    ]
    for k, v, ts in items:
        parts.append(_U32.pack(len(k)))
        parts.append(k)
        parts.append(_U32.pack(len(v)))
        parts.append(v)
        parts.append(_U64.pack(ts))
    for k, ts in tombstones:
        parts.append(_U32.pack(len(k)))
        parts.append(k)
        parts.append(_U64.pack(ts))
    body = b"".join(parts)
    blob = body + _U32.pack(zlib.crc32(body))

    final = snapshot_path(directory, seq)
    tmp = final + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        # Loop the write: a single write(2) caps at ~2 GiB on Linux and a
        # 10M-key snapshot can exceed that — a short write here would be
        # fsynced and renamed into place as a permanently corrupt snapshot.
        view = memoryview(blob)
        while view:
            n = os.write(fd, view)
            view = view[n:]
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, final)
    from merklekv_tpu_torch.storage.wal import _fsync_dir

    _fsync_dir(directory)
    return final


def read_snapshot_wal_seq(path: str) -> int:
    """Header-only read of the replay cutoff. Retention runs on every
    compaction and needs just this u64 — decoding + CRC-checking the whole
    body there would cost O(keyspace) I/O per compaction."""
    return read_snapshot_header(path)[0]


def read_snapshot_header(path: str) -> tuple[int, str, int, int]:
    """Header-only ``(wal_seq, root_hex, n_items, n_tombs)``. The snapshot
    donor answers SNAPMETA from this — advertising a snapshot must not cost
    an O(keyspace) decode; the JOINER verifies the stamp against the bytes
    it actually fetched."""
    with open(path, "rb") as f:
        hdr = f.read(_HDR.size)
    if len(hdr) < _HDR.size:
        raise SnapshotCorruptError(f"{path}: short header")
    magic, version, wal_seq, root, n_items, n_tombs = _HDR.unpack(hdr)
    if magic != SNAPSHOT_MAGIC:
        raise SnapshotCorruptError(f"{path}: bad magic {magic!r}")
    if version != 1:
        raise SnapshotCorruptError(f"{path}: unsupported version {version}")
    return wal_seq, root.hex(), n_items, n_tombs


def read_snapshot(path: str) -> Snapshot:
    """Decode + CRC-check a snapshot file. Root is NOT verified here —
    callers recompute it over ``items`` (bulk path) and compare against
    ``root_hex`` so verification covers the bytes actually loaded."""
    with open(path, "rb") as f:
        blob = f.read()
    return parse_snapshot_bytes(blob, path)


def parse_snapshot_bytes(blob: bytes, path: str = "<bytes>") -> Snapshot:
    """Decode + CRC-check a snapshot from in-memory bytes — the shape a
    bootstrapping joiner holds after assembling SNAPCHUNK ranges (the file
    never touches the joiner's disk before its stamp verifies). ``path``
    only labels error messages."""
    if len(blob) < _HDR.size + _U32.size:
        raise SnapshotCorruptError(f"{path}: short file ({len(blob)} bytes)")
    body, (crc,) = blob[:-4], _U32.unpack(blob[-4:])
    if zlib.crc32(body) != crc:
        raise SnapshotCorruptError(f"{path}: body crc mismatch")
    magic, version, wal_seq, root, n_items, n_tombs = _HDR.unpack_from(body, 0)
    if magic != SNAPSHOT_MAGIC:
        raise SnapshotCorruptError(f"{path}: bad magic {magic!r}")
    if version != 1:
        raise SnapshotCorruptError(f"{path}: unsupported version {version}")
    off = _HDR.size
    try:
        items: list[tuple[bytes, bytes, int]] = []
        for _ in range(n_items):
            (klen,) = _U32.unpack_from(body, off)
            off += 4
            k = body[off : off + klen]
            if len(k) != klen:
                raise SnapshotCorruptError(f"{path}: item key overruns body")
            off += klen
            (vlen,) = _U32.unpack_from(body, off)
            off += 4
            v = body[off : off + vlen]
            if len(v) != vlen:
                raise SnapshotCorruptError(f"{path}: item value overruns body")
            off += vlen
            (ts,) = _U64.unpack_from(body, off)
            off += 8
            items.append((k, v, ts))
        tombs: list[tuple[bytes, int]] = []
        for _ in range(n_tombs):
            (klen,) = _U32.unpack_from(body, off)
            off += 4
            k = body[off : off + klen]
            if len(k) != klen:
                raise SnapshotCorruptError(f"{path}: tombstone overruns body")
            off += klen
            (ts,) = _U64.unpack_from(body, off)
            off += 8
            tombs.append((k, ts))
    except struct.error as e:
        raise SnapshotCorruptError(f"{path}: truncated body: {e}") from None
    if off != len(body):
        raise SnapshotCorruptError(f"{path}: {len(body) - off} trailing bytes")
    return Snapshot(
        path=path,
        wal_seq=wal_seq,
        root_hex=root.hex(),
        items=items,
        tombstones=tombs,
    )


def verify_snapshot(
    snap: Snapshot, engine: str = "auto", device_min_keys: int = DEVICE_MIN_KEYS
) -> str:
    """Recompute the root over ``snap.items`` and compare to the stamp.

    Returns the verified root hex; raises :class:`RootMismatchError`."""
    actual = compute_root_hex(
        [(k, v) for k, v, _ in snap.items],
        engine=engine,
        device_min_keys=device_min_keys,
    )
    if actual != snap.root_hex:
        raise RootMismatchError(snap.path, snap.root_hex, actual)
    return actual
