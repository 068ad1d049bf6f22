"""Offline WAL/snapshot verifier: `python -m merklekv_tpu_torch walcheck <dir>`.

A copy of ``merklekv_tpu/storage/walcheck.py``, its imports pointed at the
port's modules. Roots are recomputed on the node's device
(``storage/snapshot.py``; ``MERKLEKV_TORCH_DEVICE``, unset means cuda) unless
the caller asks for the host with ``--engine cpu`` (``auto``: the device from
``DEVICE_MIN_KEYS`` keys up, as the store decides). A device failure ends the
check with an error. The ``--json`` report is the reference's.

Runs against a node data directory (or a storage base dir containing
``node-<port>`` subdirectories) without touching the server:

- every snapshot: CRC + header decode, root stamp recomputed over the
  decoded items (bulk path: the device for large keyspaces);
- every WAL segment: frame-by-frame CRC scan, truncation point reported;
- a full LWW replay (snapshot + WAL tail, the exact arbitration the
  engine's ``set_if_newer``/``delete_if_newer`` use) yielding the root the
  node WILL serve after recovery — printed so a chaos harness or operator
  can compare it to a live node's ``HASH``.

Exit status: 0 when the directory is recoverable (a torn tail on the
final segment is the normal crash signature, still rc 0); 1 when
something recovery would have to repair around — interior corruption,
a snapshot whose stamp doesn't match its content, an unreadable dir.

``--compact`` rewrites the directory as one fresh verified snapshot plus
an empty WAL (refused while a live node holds the directory's LOCK).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from merklekv_tpu_torch.merkle.encoding import EMPTY_ROOT_HEX, leaf_hash
from merklekv_tpu_torch.storage import snapshot as snapmod
from merklekv_tpu_torch.storage import wal as walmod

__all__ = ["main", "check_dir", "replay_root_hex"]


class _LWWState:
    """Host-side mirror of the engine's LWW arbitration (engine.cc
    set_if_newer / del_if_newer / truncate), so offline replay reaches the
    same live keyspace — and therefore the same Merkle root — a recovering
    node does."""

    def __init__(self) -> None:
        self.live: dict[bytes, tuple[bytes, int]] = {}
        self.tombs: dict[bytes, int] = {}

    def set_if_newer(self, k: bytes, v: bytes, ts: int) -> None:
        cur = self.live.get(k)
        if cur is not None:
            if ts < cur[1]:
                return
            if ts == cur[1] and v != cur[0]:
                # Exact-ts conflict: larger leaf digest wins (engine.cc:176).
                if leaf_hash(k, v) < leaf_hash(k, cur[0]):
                    return
        tomb = self.tombs.get(k)
        if tomb is not None and ts < tomb:
            return
        self.live[k] = (v, ts)
        self.tombs.pop(k, None)

    def del_if_newer(self, k: bytes, ts: int) -> None:
        cur = self.live.get(k)
        if cur is not None:
            if ts <= cur[1]:
                return
            del self.live[k]
        if ts > self.tombs.get(k, 0):
            self.tombs[k] = ts

    def truncate(self) -> None:
        self.live.clear()
        self.tombs.clear()

    def apply(self, rec: walmod.WalRecord) -> None:
        if rec.op == walmod.OP_SET:
            self.set_if_newer(rec.key, rec.value or b"", rec.ts)
        elif rec.op == walmod.OP_DEL:
            self.del_if_newer(rec.key, rec.ts)
        else:
            self.truncate()

    def sorted_items(self) -> list[tuple[bytes, bytes]]:
        return [(k, self.live[k][0]) for k in sorted(self.live)]


def replay_root_hex(directory: str, engine: str = "tpu") -> str:
    """The root a node recovering from ``directory`` will serve. Stops at
    the first bad WAL byte, like recovery in repair mode."""
    state, _ = _replay(directory, engine=engine)
    items = state.sorted_items()
    if not items:
        return EMPTY_ROOT_HEX
    return snapmod.compute_root_hex(items, engine=engine)


def _replay(
    directory: str,
    engine: str = "tpu",
    snap_results: Optional[list] = None,
    seg_scans: Optional[dict] = None,
):
    """(state, notes) after snapshot load + WAL replay, repair-mode rules.

    ``snap_results`` ([(seq, path, Snapshot-or-None-if-rejected)], oldest
    first) and ``seg_scans`` ({path: SegmentScan}) let :func:`check_dir`
    share its verification pass instead of re-reading and re-hashing every
    file; both are recomputed here when absent."""
    notes: list[str] = []
    state = _LWWState()
    start_seq = 0
    if snap_results is None:
        snap_results = []
        for seq, path in snapmod.list_snapshots(directory):
            try:
                snap = snapmod.read_snapshot(path)
                snapmod.verify_snapshot(snap, engine=engine)
            except (
                snapmod.SnapshotCorruptError,
                snapmod.RootMismatchError,
            ) as e:
                notes.append(f"snapshot rejected: {e}")
                snap = None
            snap_results.append((seq, path, snap))
    for seq, path, snap in reversed(snap_results):
        if snap is None:
            continue
        for k, v, ts in snap.items:
            state.set_if_newer(k, v, ts)
        for k, ts in snap.tombstones:
            state.del_if_newer(k, ts)
        start_seq = snap.wal_seq
        break
    segments = [
        (s, p) for s, p in walmod.list_segments(directory) if s >= start_seq
    ]
    for i, (seq, path) in enumerate(segments):
        scan = (seg_scans or {}).get(path) or walmod.scan_segment(path)
        for rec in scan.records:
            state.apply(rec)
        if not scan.clean and not (scan.torn and i == len(segments) - 1):
            notes.append(f"replay stopped at {os.path.basename(path)}")
            break
    return state, notes


def check_dir(directory: str, engine: str = "tpu") -> dict:
    """Verify one node data directory; returns a JSON-able report."""
    report: dict = {
        "dir": directory,
        "snapshots": [],
        "segments": [],
        "errors": [],
        "warnings": [],
    }
    snaps = snapmod.list_snapshots(directory)
    segs = walmod.list_segments(directory)
    if not snaps and not segs:
        report["errors"].append("no snapshots or WAL segments found")
        return report

    snap_results = []
    for seq, path in snaps:
        entry = {"file": os.path.basename(path), "seq": seq}
        verified = None
        try:
            snap = snapmod.read_snapshot(path)
            entry.update(
                items=len(snap.items),
                tombstones=len(snap.tombstones),
                wal_seq=snap.wal_seq,
                root=snap.root_hex,
            )
            snapmod.verify_snapshot(snap, engine=engine)
            entry["root_verified"] = True
            verified = snap
        except snapmod.SnapshotCorruptError as e:
            entry["error"] = str(e)
            report["errors"].append(f"{os.path.basename(path)}: {e}")
        except snapmod.RootMismatchError as e:
            entry["root_verified"] = False
            entry["error"] = str(e)
            report["errors"].append(str(e))
        snap_results.append((seq, path, verified))
        report["snapshots"].append(entry)

    seg_scans = {}
    for i, (seq, path) in enumerate(segs):
        scan = walmod.scan_segment(path)
        seg_scans[path] = scan
        entry = {
            "file": os.path.basename(path),
            "seq": seq,
            "frames": len(scan.records),
            "bytes": scan.total_bytes,
        }
        if not scan.clean:
            entry["truncation_offset"] = scan.good_offset
            entry["reason"] = scan.error
            entry["torn"] = scan.torn
            if scan.torn and i == len(segs) - 1:
                report["warnings"].append(
                    f"{os.path.basename(path)}: torn tail at byte "
                    f"{scan.good_offset} ({scan.error}) — normal after a "
                    "crash; recovery cuts it"
                )
            else:
                report["errors"].append(
                    f"{os.path.basename(path)}: corruption at byte "
                    f"{scan.good_offset} ({scan.error})"
                )
        report["segments"].append(entry)

    state, notes = _replay(
        directory, engine=engine, snap_results=snap_results, seg_scans=seg_scans
    )
    report["warnings"].extend(notes)
    items = state.sorted_items()
    report["live_keys"] = len(items)
    report["tombstones"] = len(state.tombs)
    report["replay_root"] = (
        snapmod.compute_root_hex(items, engine=engine)
        if items
        else EMPTY_ROOT_HEX
    )
    return report


def _compact_dir(directory: str, engine: str = "tpu") -> dict:
    """Offline compaction: replay everything, write one fresh snapshot,
    drop all older snapshots and WAL segments."""
    import fcntl

    lock_path = os.path.join(directory, "LOCK")
    fd = os.open(lock_path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            raise SystemExit(
                f"walcheck: {directory} is locked by a live node; stop it "
                "before --compact"
            )
        state, notes = _replay(directory, engine=engine)
        items = state.sorted_items()
        ts_of = {k: ts for k, (_, ts) in state.live.items()}
        root = (
            snapmod.compute_root_hex(items, engine=engine)
            if items
            else EMPTY_ROOT_HEX
        )
        segs = walmod.list_segments(directory)
        next_wal = (segs[-1][0] + 1) if segs else 0
        snaps = snapmod.list_snapshots(directory)
        next_snap = (snaps[-1][0] + 1) if snaps else 1
        path = snapmod.write_snapshot(
            directory,
            next_snap,
            [(k, v, ts_of[k]) for k, v in items],
            sorted(state.tombs.items()),
            next_wal,
            root,
        )
        for _, p in snaps:
            os.unlink(p)
        for _, p in segs:
            os.unlink(p)
        return {
            "compacted_to": os.path.basename(path),
            "live_keys": len(items),
            "tombstones": len(state.tombs),
            "root": root,
            "notes": notes,
        }
    finally:
        os.close(fd)


def _node_dirs(path: str) -> list[str]:
    """The node dirs under ``path``: itself if it holds WAL/snapshot files,
    else any ``node-*`` children (the per-port layout)."""
    if walmod.list_segments(path) or snapmod.list_snapshots(path):
        return [path]
    subs = [
        os.path.join(path, n)
        for n in sorted(os.listdir(path))
        if n.startswith("node-") and os.path.isdir(os.path.join(path, n))
    ]
    return [
        s
        for s in subs
        if walmod.list_segments(s) or snapmod.list_snapshots(s)
    ] or [path]


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="merklekv_tpu_torch walcheck",
        description="verify WAL frames + snapshot root stamps offline",
    )
    p.add_argument("dir", help="node data dir, or a storage base dir")
    p.add_argument(
        "--engine",
        default="tpu",
        choices=["auto", "cpu", "tpu"],
        help="root recompute path (default tpu: the node's device, "
        "MERKLEKV_TORCH_DEVICE; cpu: hashlib on the host; auto: the device "
        "from 4096 keys up)",
    )
    p.add_argument(
        "--compact",
        action="store_true",
        help="rewrite as one fresh snapshot + empty WAL",
    )
    p.add_argument("--json", action="store_true", help="machine-readable out")
    args = p.parse_args(argv)

    if not os.path.isdir(args.dir):
        print(f"walcheck: not a directory: {args.dir}", file=sys.stderr)
        return 1

    rc = 0
    reports = []
    for d in _node_dirs(args.dir):
        report = check_dir(d, engine=args.engine)
        if args.compact and not report["errors"]:
            report["compact"] = _compact_dir(d, engine=args.engine)
        reports.append(report)
        if report["errors"]:
            rc = 1

    if args.json:
        print(json.dumps(reports if len(reports) > 1 else reports[0]))
        return rc

    for report in reports:
        print(f"== {report['dir']}")
        for s in report["snapshots"]:
            ok = (
                "root OK"
                if s.get("root_verified")
                else s.get("error", "unverified")
            )
            print(
                f"  {s['file']}: {s.get('items', '?')} items, "
                f"{s.get('tombstones', '?')} tombstones, "
                f"wal_seq={s.get('wal_seq', '?')} — {ok}"
            )
        for s in report["segments"]:
            line = f"  {s['file']}: {s['frames']} frames, {s['bytes']} bytes"
            if "truncation_offset" in s:
                kind = "torn tail" if s.get("torn") else "CORRUPTION"
                line += (
                    f" — {kind} at byte {s['truncation_offset']}"
                    f" ({s['reason']})"
                )
            print(line)
        print(
            f"  replay: {report.get('live_keys', 0)} live keys, "
            f"{report.get('tombstones', 0)} tombstones, "
            f"root={report.get('replay_root', '')}"
        )
        for w in report["warnings"]:
            print(f"  warning: {w}")
        for e in report["errors"]:
            print(f"  ERROR: {e}")
        if "compact" in report:
            c = report["compact"]
            print(
                f"  compacted -> {c['compacted_to']} "
                f"({c['live_keys']} keys, root={c['root'][:16]}…)"
            )
    return rc


if __name__ == "__main__":
    sys.exit(main())
