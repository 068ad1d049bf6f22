"""Versioned partition map: the routing table of partitioned cluster mode.

A copy of ``merklekv_tpu/cluster/partmap.py``, its imports pointed at the port's modules.

The keyspace is hashed into ``P`` partitions, each owned by its own
replica group (disjoint nodes, own replication topic, own per-partition
Merkle root — a replica holds ONLY its partition's keys, so its
whole-node root IS the partition root and anti-entropy, bootstrap,
overload and the staleness pump stay partition-local by construction).

The map is (epoch, partition -> replica list). Nodes serve it over the
``PARTMAP`` wire verb; smart clients and the thin router bootstrap from
any node and refresh whenever a node answers ``ERROR MOVED <pid>
<epoch>`` (the native guard's stale-routing refusal). The epoch is a
generation counter: rebalancing installs a new map with a bumped epoch,
and a MOVED answer carrying a newer epoch is the client's refresh signal.

Ownership is a split tree over the hash space. ``h`` is the first 8
bytes of SHA-256(key) as a big-endian u64 (bit-identical to the native
guard, server.cc::partition_of_key). With ``base`` = the partition count
the cluster booted with, a partition owns the assignment ``(root, depth,
path)``::

    root = h % base            # which boot-time shard
    sub  = h // base           # the infinite refinement coordinate
    owns iff root matches and (sub & ((1 << depth) - 1)) == path

A boot map is depth-0 everywhere (partition ``i`` owns ``(i, 0, 0)``),
which makes ``partition_for_key`` exactly the legacy ``h % P`` — every
pre-split deployment routes bit-identically to before. Splitting
partition ``p`` at ``(r, d, q)`` refines ONE bit: ``p`` keeps ``(r, d+1,
q)`` and the new partition takes ``(r, d+1, q | 1 << d)``, so the moving
range is partition-local — no other partition's keys move. That locality
is what makes live rebalancing (cluster/rebalance.py) possible at all:
``h % P -> h % (P+1)`` would remap nearly every key in the cluster.

Wire/spec compatibility: an unsplit map serializes in the v1 format
verbatim (3-field header, plain rows). A split map needs the v2 format —
header gains ``base``, rows gain a ``root.depth.path`` token — which old
parsers reject LOUDLY (arity/address errors), never misroute silently.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "partition_of",
    "hash_of_key",
    "key_in_range",
    "PartitionMap",
    "parse_map_spec",
    "format_map_spec",
    "save_map_file",
    "load_map_file",
    "MAP_FILE_NAME",
    "PartitionMapError",
]


class PartitionMapError(ValueError):
    """A partition map (wire dump or config spec) failed validation —
    wrong shape, missing partitions, out-of-range ids, malformed replica
    addresses, or a split tree that does not tile the hash space. Raised
    instead of ever returning a PARTIAL map: routing on a half-parsed
    table is the silent-wrong-node bug the MOVED guard exists to kill."""


def hash_of_key(key: bytes | str) -> int:
    """key -> u64 routing hash: first 8 bytes of SHA-256(key), big-endian
    — bit-identical to the native dispatch guard (server.cc)."""
    if isinstance(key, str):
        key = key.encode("utf-8", "surrogateescape")
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "big")


def partition_of(key: bytes | str, count: int) -> int:
    """key -> partition id under an UNSPLIT map (stable hash
    partitioning, ``h % count``). Split-aware routing lives on
    :meth:`PartitionMap.partition_for_key`; this stays the boot-map
    special case every pre-split caller (and the native guard's legacy
    path) agrees on."""
    if count <= 0:
        raise ValueError(f"partition count must be positive, got {count}")
    return hash_of_key(key) % count


def key_in_range(
    key: bytes | str, base: int, root: int, depth: int, path: int
) -> bool:
    """True iff ``key`` falls inside the assignment ``(root, depth,
    path)`` under ``base`` — the one predicate the donor's moving-range
    filter, the replicator's double-apply forward, and the native fence
    all agree on."""
    h = hash_of_key(key)
    if h % base != root:
        return False
    return ((h // base) & ((1 << depth) - 1)) == path


def _check_addr(addr: str) -> str:
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise PartitionMapError(f"replica address needs host:port: {addr!r}")
    try:
        p = int(port)
    except ValueError:
        raise PartitionMapError(
            f"replica address needs a numeric port: {addr!r}"
        ) from None
    if not 0 < p <= 65535:
        raise PartitionMapError(f"replica port out of range: {addr!r}")
    return addr


def _check_assignment_cover(
    base: int, assignments: list[tuple[int, int, int]]
) -> None:
    """Every hash must land in exactly one assignment: per root, the
    (depth, path) set must tile the sub-coordinate space — pairwise
    disjoint and summing to the whole. Anything else means a key with no
    owner (lost) or two owners (double-owned), the two failure modes the
    rebalance chaos drill exists to disprove."""
    by_root: dict[int, list[tuple[int, int]]] = {}
    for pid, (root, depth, path) in enumerate(assignments):
        if not 0 <= root < base:
            raise PartitionMapError(
                f"partition {pid} root {root} out of range 0..{base - 1}"
            )
        if depth < 0 or depth > 62:
            raise PartitionMapError(
                f"partition {pid} depth {depth} out of range 0..62"
            )
        if not 0 <= path < (1 << depth):
            raise PartitionMapError(
                f"partition {pid} path {path} out of range for depth {depth}"
            )
        by_root.setdefault(root, []).append((depth, path))
    for root in range(base):
        cells = by_root.get(root)
        if not cells:
            raise PartitionMapError(f"no partition owns hash root {root}")
        for i, (d1, p1) in enumerate(cells):
            for d2, p2 in cells[i + 1 :]:
                lo, hi = ((d1, p1), (d2, p2)) if d1 <= d2 else ((d2, p2), (d1, p1))
                if hi[1] & ((1 << lo[0]) - 1) == lo[1]:
                    raise PartitionMapError(
                        f"hash root {root}: overlapping assignments "
                        f"{lo} and {hi}"
                    )
        maxd = max(d for d, _ in cells)
        total = sum(1 << (maxd - d) for d, _ in cells)
        if total != 1 << maxd:
            raise PartitionMapError(
                f"hash root {root}: assignments do not cover the space "
                f"({total}/{1 << maxd} cells)"
            )


@dataclass
class PartitionMap:
    """Epoch-versioned partition -> replica-set table."""

    epoch: int = 1
    # replicas[pid] = ["host:port", ...] — index IS the partition id.
    replicas: list[list[str]] = field(default_factory=list)
    # Split-tree state. base = boot partition count (0 -> count: legacy
    # unsplit map); assignments[pid] = (root, depth, path) ([] -> the
    # trivial depth-0 map where partition i owns root i).
    base: int = 0
    assignments: list[tuple[int, int, int]] = field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.replicas)

    @property
    def hash_base(self) -> int:
        return self.base if self.base > 0 else self.count

    @property
    def is_split(self) -> bool:
        """True once any partition sits below depth 0 — the signal that
        the v2 wire/spec formats (and assignment-aware routing) are
        required."""
        if self.base and self.base != self.count:
            return True
        return any(d != 0 for _, d, _ in self.assignments)

    def assignment(self, pid: int) -> tuple[int, int, int]:
        if self.assignments:
            return self.assignments[pid]
        return (pid, 0, 0)

    def validate(self) -> "PartitionMap":
        if self.epoch < 1:
            raise PartitionMapError(f"epoch must be >= 1, got {self.epoch}")
        if not self.replicas:
            raise PartitionMapError("partition map has no partitions")
        for pid, reps in enumerate(self.replicas):
            if not reps:
                raise PartitionMapError(f"partition {pid} has no replicas")
            for addr in reps:
                _check_addr(addr)
        if self.base < 0:
            raise PartitionMapError(f"base must be >= 1, got {self.base}")
        if self.assignments and len(self.assignments) != self.count:
            raise PartitionMapError(
                f"assignment count mismatch: {len(self.assignments)} "
                f"assignments for {self.count} partitions"
            )
        if self.base and not self.assignments and self.base != self.count:
            raise PartitionMapError(
                f"base {self.base} != count {self.count} needs explicit "
                "assignments"
            )
        if self.assignments:
            _check_assignment_cover(
                self.hash_base, [self.assignment(p) for p in range(self.count)]
            )
        return self

    def partition_for_key(self, key: bytes | str) -> int:
        h = hash_of_key(key)
        if not self.is_split:
            return h % self.count
        base = self.hash_base
        root, sub = h % base, h // base
        for pid in range(self.count):
            r, d, p = self.assignment(pid)
            if r == root and (sub & ((1 << d) - 1)) == p:
                return pid
        # Unreachable on a validated map (the cover check guarantees an
        # owner); loud beats silent if one sneaks through unvalidated.
        raise PartitionMapError(f"no partition owns hash root {root}")

    def replicas_for_key(self, key: bytes | str) -> list[str]:
        return self.replicas[self.partition_for_key(key)]

    def partition_of_replica(self, addr: str) -> int | None:
        """The partition a replica address serves, or None when the
        address is not in the map."""
        for pid, reps in enumerate(self.replicas):
            if addr in reps:
                return pid
        return None

    # -- rebalance ----------------------------------------------------------
    def split(self, pid: int, new_replicas: list[str]) -> "PartitionMap":
        """The epoch-E+1 map splitting ``pid``: ``pid`` keeps the low
        half of its assignment one bit deeper, the appended partition
        (id = old count) takes the high half and ``new_replicas``. Pure —
        installing the result anywhere is the caller's (rebalance state
        machine's) job."""
        if not 0 <= pid < self.count:
            raise PartitionMapError(
                f"split partition {pid} out of range 0..{self.count - 1}"
            )
        root, depth, path = self.assignment(pid)
        if depth >= 62:
            raise PartitionMapError(f"partition {pid} at max split depth")
        assigns = [self.assignment(p) for p in range(self.count)]
        assigns[pid] = (root, depth + 1, path)
        assigns.append((root, depth + 1, path | (1 << depth)))
        return PartitionMap(
            epoch=self.epoch + 1,
            replicas=[list(r) for r in self.replicas] + [list(new_replicas)],
            base=self.hash_base,
            assignments=assigns,
        ).validate()

    def moving_range(self, pid: int) -> tuple[int, int, int, int]:
        """(base, root, depth, path) of the range that would LEAVE
        ``pid`` on split — i.e. the new child's assignment. The donor's
        snapshot filter, forward filter, and fence all take this tuple."""
        root, depth, path = self.assignment(pid)
        return (self.hash_base, root, depth + 1, path | (1 << depth))

    # -- wire ---------------------------------------------------------------
    # Unsplit: "PARTMAP <epoch> <count>" header + "<pid> <replica> [...]"
    # rows (every pid 0..count-1 exactly once, any order) + "END" — the
    # v1 format, byte-identical. Split: header gains the hash base
    # ("PARTMAP <epoch> <count> <base>") and every row carries the
    # assignment token ("<pid> <root>.<depth>.<path> <replica> [...]").
    # Old parsers fail LOUDLY on the 4-field header (arity error) instead
    # of routing h%P against a split map — a deliberate fail-closed.
    def wire(self) -> str:
        if not self.is_split:
            body = "".join(
                f"{pid} {' '.join(reps)}\r\n"
                for pid, reps in enumerate(self.replicas)
            )
            return f"PARTMAP {self.epoch} {self.count}\r\n{body}END\r\n"
        body = "".join(
            f"{pid} {r}.{d}.{p} {' '.join(reps)}\r\n"
            for pid, reps in enumerate(self.replicas)
            for r, d, p in [self.assignment(pid)]
        )
        return (
            f"PARTMAP {self.epoch} {self.count} {self.hash_base}\r\n"
            f"{body}END\r\n"
        )

    @classmethod
    def from_wire(cls, header: str, rows: list[str]) -> "PartitionMap":
        """Parse a PARTMAP response (header line + body rows, END already
        stripped). Every malformation raises :class:`PartitionMapError` —
        truncated or garbled dumps must never yield a partial map."""
        fields = header.split(" ")
        if len(fields) not in (3, 4) or fields[0] != "PARTMAP":
            raise PartitionMapError(f"malformed PARTMAP header: {header!r}")
        try:
            epoch, count = int(fields[1]), int(fields[2])
            base = int(fields[3]) if len(fields) == 4 else 0
        except ValueError:
            raise PartitionMapError(
                f"malformed PARTMAP header: {header!r}"
            ) from None
        split_wire = len(fields) == 4
        if epoch < 1 or count < 1 or (split_wire and base < 1):
            raise PartitionMapError(f"malformed PARTMAP header: {header!r}")
        if len(rows) != count:
            raise PartitionMapError(
                f"PARTMAP row count mismatch: header says {count}, "
                f"got {len(rows)}"
            )
        replicas: list[list[str] | None] = [None] * count
        assigns: list[tuple[int, int, int] | None] = [None] * count
        for row in rows:
            parts = [p for p in row.split(" ") if p]
            want = 3 if split_wire else 2
            if len(parts) < want:
                raise PartitionMapError(f"malformed PARTMAP row: {row!r}")
            try:
                pid = int(parts[0])
            except ValueError:
                raise PartitionMapError(
                    f"malformed PARTMAP row: {row!r}"
                ) from None
            if not 0 <= pid < count:
                raise PartitionMapError(
                    f"PARTMAP row partition {pid} out of range 0..{count - 1}"
                )
            if replicas[pid] is not None:
                raise PartitionMapError(f"duplicate PARTMAP row for {pid}")
            reps = parts[1:]
            if split_wire:
                assigns[pid] = _parse_assignment_token(parts[1], row)
                reps = parts[2:]
            replicas[pid] = [_check_addr(a) for a in reps]
        # len(rows) == count and no duplicates => every slot filled.
        return cls(
            epoch=epoch,
            replicas=[r for r in replicas if r is not None],
            base=base,
            assignments=(
                [a for a in assigns if a is not None] if split_wire else []
            ),
        ).validate()


def _parse_assignment_token(tok: str, ctx: str) -> tuple[int, int, int]:
    """``root.depth.path`` — three dot-joined decimal fields, nothing
    else. Range/cover checks happen in validate(); this only rejects
    shapes that could be a mangled replica address."""
    bits = tok.split(".")
    if len(bits) != 3 or not all(b.isdigit() for b in bits):
        raise PartitionMapError(f"malformed assignment token in {ctx!r}")
    return (int(bits[0]), int(bits[1]), int(bits[2]))


def parse_map_spec(spec: str, count: int, epoch: int = 1) -> PartitionMap:
    """Parse the ``[cluster] partition_map`` config spec:
    ``"0=host:port,host:port;1=host:port;..."`` — one ``pid=replicas``
    group per partition, ``;``-separated, replicas ``,``-separated. Every
    partition 0..count-1 must appear exactly once.

    Split maps extend the grammar (this is also the REBALANCE wire
    mapspec): an optional leading ``base=<B>`` group, and each pid may
    carry its assignment as ``pid@root.depth.path=replicas``. Groups
    without ``@`` default to the trivial ``(pid, 0, 0)``."""
    replicas: list[list[str] | None] = [None] * count
    assigns: list[tuple[int, int, int] | None] = [None] * count
    base = 0
    saw_assign = False
    for group in spec.split(";"):
        group = group.strip()
        if not group:
            continue
        pid_s, sep, reps_s = group.partition("=")
        if not sep:
            raise PartitionMapError(
                f"partition_map group needs pid=replicas: {group!r}"
            )
        if pid_s == "base":
            try:
                base = int(reps_s)
            except ValueError:
                raise PartitionMapError(
                    f"partition_map base must be numeric: {group!r}"
                ) from None
            if base < 1:
                raise PartitionMapError(
                    f"partition_map base must be >= 1: {group!r}"
                )
            continue
        pid_s, asep, assign_s = pid_s.partition("@")
        try:
            pid = int(pid_s)
        except ValueError:
            raise PartitionMapError(
                f"partition_map group needs a numeric pid: {group!r}"
            ) from None
        if not 0 <= pid < count:
            raise PartitionMapError(
                f"partition_map pid {pid} out of range 0..{count - 1}"
            )
        if replicas[pid] is not None:
            raise PartitionMapError(f"duplicate partition_map group for {pid}")
        if asep:
            assigns[pid] = _parse_assignment_token(assign_s, group)
            saw_assign = True
        reps = [r.strip() for r in reps_s.split(",") if r.strip()]
        if not reps:
            raise PartitionMapError(
                f"partition_map partition {pid} has no replicas"
            )
        replicas[pid] = [_check_addr(a) for a in reps]
    missing = [i for i, r in enumerate(replicas) if r is None]
    if missing:
        raise PartitionMapError(
            f"partition_map missing partitions: {missing}"
        )
    use_assigns = saw_assign or base > 0
    return PartitionMap(
        epoch=epoch,
        replicas=[r for r in replicas if r is not None],
        base=base,
        assignments=(
            [assigns[p] or (p, 0, 0) for p in range(count)]
            if use_assigns
            else []
        ),
    ).validate()


def format_map_spec(pmap: PartitionMap) -> str:
    """The inverse of :func:`parse_map_spec` — the one-line mapspec the
    REBALANCE JOIN/COMMIT verbs carry. Unsplit maps round-trip through
    the legacy grammar; split maps always carry base + every assignment
    so the receiver never guesses."""
    if not pmap.is_split:
        return ";".join(
            f"{pid}={','.join(reps)}" for pid, reps in enumerate(pmap.replicas)
        )
    groups = [f"base={pmap.hash_base}"]
    for pid, reps in enumerate(pmap.replicas):
        r, d, p = pmap.assignment(pid)
        groups.append(f"{pid}@{r}.{d}.{p}={','.join(reps)}")
    return ";".join(groups)


# -- durable map file ---------------------------------------------------------
# A rebalance's epoch flip COMMITS by persisting the new map here (tmp +
# fsync + rename, so the commit point is atomic and crash-safe). On boot a
# node overlays a persisted map NEWER than its config-derived one — a donor
# killed one instruction after the rename restarts already committed, while
# one killed before it restarts at the old epoch (= the rollback).

MAP_FILE_NAME = "partmap.spec"
_MAP_FILE_MAGIC = "MKVPARTMAP1"


def save_map_file(directory: str, pmap: PartitionMap, pid: int) -> str:
    """Atomically persist ``pmap`` (and this node's partition id under it)
    to ``<directory>/partmap.spec``. Returns the file path."""
    path = os.path.join(directory, MAP_FILE_NAME)
    tmp = path + ".tmp"
    body = (
        f"{_MAP_FILE_MAGIC}\n"
        f"epoch {pmap.epoch}\n"
        f"count {pmap.count}\n"
        f"pid {pid}\n"
        f"spec {format_map_spec(pmap)}\n"
    )
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, body.encode("ascii"))
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    # The rename is the commit point; fsync the directory so it survives
    # a power cut, not just a process kill.
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return path


def load_map_file(directory: str) -> Optional[tuple[PartitionMap, int]]:
    """Load a persisted ``(map, partition_id)`` from ``directory``, or
    None when no file exists. A PRESENT but malformed file raises
    :class:`PartitionMapError` — ownership must never be guessed from a
    half-written commit record (the atomic rename makes this unreachable
    short of disk corruption, which deserves a loud stop)."""
    path = os.path.join(directory, MAP_FILE_NAME)
    try:
        with open(path, "r", encoding="ascii") as f:
            lines = f.read().splitlines()
    except FileNotFoundError:
        return None
    except (OSError, UnicodeDecodeError) as e:
        raise PartitionMapError(f"{path}: unreadable map file: {e}")
    fields: dict[str, str] = {}
    if not lines or lines[0] != _MAP_FILE_MAGIC:
        raise PartitionMapError(f"{path}: bad map file magic")
    for ln in lines[1:]:
        if not ln:
            continue
        name, sep, value = ln.partition(" ")
        if not sep:
            raise PartitionMapError(f"{path}: malformed line {ln!r}")
        fields[name] = value
    try:
        epoch = int(fields["epoch"])
        count = int(fields["count"])
        pid = int(fields["pid"])
        spec = fields["spec"]
    except (KeyError, ValueError) as e:
        raise PartitionMapError(f"{path}: incomplete map file: {e}")
    pmap = parse_map_spec(spec, count, epoch)
    if not 0 <= pid < pmap.count:
        raise PartitionMapError(
            f"{path}: pid {pid} out of range for {pmap.count} partitions"
        )
    return pmap, pid
