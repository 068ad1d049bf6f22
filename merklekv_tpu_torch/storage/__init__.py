"""Durable storage subsystem: WAL + Merkle-stamped snapshots + recovery.

A copy of ``merklekv_tpu/storage/__init__.py`` with the same exports, over
the port's copies of its modules.

Layout of a node data directory (``<storage_path>/node-<port>``):

    LOCK                      flock'd while a node owns the directory
    wal-<seq>.log             CRC32-framed append-only segments (wal.py)
    snapshot-<seq>.snap       Merkle-root-stamped state images (snapshot.py)

:class:`DurableStore` (store.py) orchestrates recovery, the event-drain
recording paths, fsync policy, and background compaction;
``python -m merklekv_tpu_torch walcheck`` (walcheck.py) verifies a directory
offline. See docs/PERSISTENCE.md for formats and trade-offs.
"""

from merklekv_tpu_torch.storage.snapshot import (
    RootMismatchError,
    Snapshot,
    SnapshotCorruptError,
    compute_root_hex,
    read_snapshot,
    write_snapshot,
)
from merklekv_tpu_torch.storage.store import (
    DurableStore,
    RecoveryError,
    RecoveryReport,
    StorageLockedError,
    node_data_dir,
)
from merklekv_tpu_torch.storage.wal import (
    SegmentScan,
    WalRecord,
    WalWriter,
    scan_segment,
)

__all__ = [
    "DurableStore",
    "RecoveryError",
    "RecoveryReport",
    "RootMismatchError",
    "Snapshot",
    "SnapshotCorruptError",
    "StorageLockedError",
    "SegmentScan",
    "WalRecord",
    "WalWriter",
    "compute_root_hex",
    "node_data_dir",
    "read_snapshot",
    "scan_segment",
    "write_snapshot",
]
