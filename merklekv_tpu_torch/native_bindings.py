"""ctypes bindings to the native host runtime (libmerklekv.so).

A copy of ``merklekv_tpu/native_bindings.py``, its imports pointed at the
port's modules, except for the build. The port compiles its own copy of the
C++ sources (``merklekv_tpu_torch/native/``) with ``g++`` into
``build/native/`` at the repository root and never writes beside the
sources:

- one ``g++ -c`` per source, all started together, then one link;
- the outputs are named by a hash of the sources and flags, so an edited
  source is rebuilt and an unchanged one is loaded as it is;
- the build holds an ``fcntl`` lock on ``build/native/.lock``, so processes
  that start together (test workers, several nodes) build once;
- each output is linked under a temporary name and ``os.replace``d into
  place, so no process ever loads a half-linked library.

The C++ layer owns the hot path: sharded storage engines, the CRLF protocol
parser, and the TCP server (merklekv_tpu_torch/native/). This module is the
control-plane handle the Python side uses to
  - share one engine between the native server and the replication /
    anti-entropy / device-Merkle subsystems,
  - drain the change-event queue feeding replication and incremental
    device updates,
  - register the cluster callback that routes SYNC / REPLICATE commands
    into Python.

The library is loaded with ``ctypes.CDLL``'s default ``RTLD_LOCAL``, so it
and the JAX package's build of the same sources can live in one process
without their C symbols meeting.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from dataclasses import dataclass
from typing import Callable, Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "native"
)
_SOURCES = ("sha256.cc", "merkle.cc", "engine.cc", "events.cc", "protocol.cc",
            "server.cc")
_CXXFLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")
_LDFLAGS = ("-pthread",)
# Output name -> (its own source, link flags).
_TARGETS = {
    "libmerklekv": ("capi.cc", ("-shared",)),
    "merklekv-server": ("main.cc", ()),
}
_build_mu = threading.Lock()

_CLUSTER_CB = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_void_p,
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_char),
    ctypes.c_int,
)

_lib: Optional[ctypes.CDLL] = None


def _source_tag() -> str:
    h = hashlib.sha256(" ".join(_CXXFLAGS + _LDFLAGS).encode())
    for name in sorted(os.listdir(_NATIVE_DIR)):
        if name.endswith((".cc", ".h")):
            h.update(name.encode())
            with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _output_path(target: str) -> str:
    suffix = ".so" if target.startswith("lib") else ""
    return os.path.join(BUILD_DIR, f"{target}-{_source_tag()}{suffix}")


def _compile(out: str, target: str) -> None:
    """Compile and link ``target`` to ``out`` (the caller holds the lock)."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    own, link_flags = _TARGETS[target]
    srcs = _SOURCES + (own,)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{src[:-3]}.o" for src in srcs]
    try:
        procs = [
            subprocess.Popen(
                [cxx, *_CXXFLAGS, "-c", os.path.join(_NATIVE_DIR, src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(srcs, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        for proc, log in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"native build failed: {proc.args}\n{log}")
        subprocess.run(
            [cxx, *link_flags, *objs, "-o", tmp, *_LDFLAGS],
            check=True, capture_output=True,
        )
        os.replace(tmp, out)
    finally:
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.unlink(path)


def _ensure_target(target: str) -> str:
    out = _output_path(target)
    if os.path.exists(out):
        return out
    with _build_mu:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(out):  # another process may have built it
                _compile(out, target)
    return out


def ensure_built() -> str:
    """Build the native library unless a build of these sources and flags
    exists; return its path."""
    return _ensure_target("libmerklekv")


def server_binary() -> str:
    """Path to the standalone merklekv-server binary (built on demand)."""
    return _ensure_target("merklekv-server")


def install_crash_marker(path: str) -> None:
    """Arm the native fatal-signal crash marker: a SIGSEGV/SIGABRT/SIGBUS/
    SIGFPE appends one ``fatal signal <n> pid <p> wall_ns <t>`` line to
    ``path`` (async-signal-safe), then chains to the previously installed
    handler — call AFTER ``faulthandler.enable`` so Python tracebacks
    still dump. Part of the flight-recorder fatal-dump plane
    (docs/OBSERVABILITY.md "Post-mortem forensics")."""
    _load().mkv_install_crash_marker(path.encode())


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built())

    lib.mkv_free.argtypes = [ctypes.c_void_p]
    lib.mkv_engine_create.restype = ctypes.c_void_p
    lib.mkv_engine_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.mkv_engine_destroy.argtypes = [ctypes.c_void_p]

    P = ctypes.POINTER
    lib.mkv_engine_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        P(ctypes.c_void_p), P(ctypes.c_int),
    ]
    lib.mkv_engine_set.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.mkv_engine_set_with_ts.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_ulonglong,
    ]
    lib.mkv_engine_get_ts.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        P(ctypes.c_ulonglong),
    ]
    lib.mkv_engine_get_with_ts.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        P(ctypes.c_void_p), P(ctypes.c_int), P(ctypes.c_ulonglong),
    ]
    lib.mkv_engine_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.mkv_engine_del_with_ts.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_ulonglong,
    ]
    lib.mkv_engine_del_quiet.argtypes = lib.mkv_engine_del.argtypes
    lib.mkv_engine_set_if_newer.argtypes = lib.mkv_engine_set_with_ts.argtypes
    lib.mkv_engine_del_if_newer.argtypes = lib.mkv_engine_del_with_ts.argtypes
    lib.mkv_engine_apply_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        P(ctypes.c_void_p),
    ]
    lib.mkv_engine_tombstone_ts.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, P(ctypes.c_ulonglong),
    ]
    lib.mkv_engine_tombstones.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        P(ctypes.c_void_p), P(ctypes.c_int),
    ]
    lib.mkv_engine_key_timestamps.argtypes = [
        ctypes.c_void_p, P(ctypes.c_void_p), P(ctypes.c_int),
    ]
    lib.mkv_engine_exists.argtypes = lib.mkv_engine_del.argtypes
    lib.mkv_engine_dbsize.restype = ctypes.c_longlong
    lib.mkv_engine_dbsize.argtypes = [ctypes.c_void_p]
    lib.mkv_engine_memory_usage.restype = ctypes.c_longlong
    lib.mkv_engine_memory_usage.argtypes = [ctypes.c_void_p]
    lib.mkv_engine_tomb_evictions.restype = ctypes.c_longlong
    lib.mkv_engine_tomb_evictions.argtypes = [ctypes.c_void_p]
    lib.mkv_engine_slab_stats.restype = None
    lib.mkv_engine_slab_stats.argtypes = [
        ctypes.c_void_p, P(ctypes.c_ulonglong),
    ]
    lib.mkv_engine_version.restype = ctypes.c_ulonglong
    lib.mkv_engine_version.argtypes = [ctypes.c_void_p]
    lib.mkv_engine_log_version_refused.argtypes = [ctypes.c_void_p]
    lib.mkv_engine_truncate.argtypes = [ctypes.c_void_p]
    lib.mkv_engine_compact.argtypes = [ctypes.c_void_p]
    lib.mkv_engine_sync.argtypes = [ctypes.c_void_p]
    lib.mkv_engine_increment.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong,
        P(ctypes.c_longlong), P(ctypes.c_void_p), P(ctypes.c_int),
    ]
    lib.mkv_engine_decrement.argtypes = lib.mkv_engine_increment.argtypes
    lib.mkv_engine_append.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        P(ctypes.c_void_p), P(ctypes.c_int), P(ctypes.c_void_p), P(ctypes.c_int),
    ]
    lib.mkv_engine_prepend.argtypes = lib.mkv_engine_append.argtypes
    lib.mkv_engine_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        P(ctypes.c_void_p), P(ctypes.c_int),
    ]
    lib.mkv_engine_snapshot.argtypes = [
        ctypes.c_void_p, P(ctypes.c_void_p), P(ctypes.c_longlong),
    ]
    lib.mkv_engine_merkle_root.argtypes = [ctypes.c_void_p, ctypes.c_char_p]

    lib.mkv_server_create.restype = ctypes.c_void_p
    lib.mkv_server_create.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.mkv_server_configure_io.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ]
    lib.mkv_server_io_threads.restype = ctypes.c_longlong
    lib.mkv_server_io_threads.argtypes = [ctypes.c_void_p]
    lib.mkv_server_configure_accept.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mkv_server_reuseport.argtypes = [ctypes.c_void_p]
    lib.mkv_server_set_zero_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mkv_server_set_max_line.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,
    ]
    lib.mkv_server_start.argtypes = [ctypes.c_void_p]
    lib.mkv_server_port.argtypes = [ctypes.c_void_p]
    lib.mkv_server_stopping.argtypes = [ctypes.c_void_p]
    lib.mkv_server_stop.argtypes = [ctypes.c_void_p]
    lib.mkv_server_wait.argtypes = [ctypes.c_void_p]
    lib.mkv_server_destroy.argtypes = [ctypes.c_void_p]
    lib.mkv_server_set_cluster_cb.argtypes = [
        ctypes.c_void_p, _CLUSTER_CB, ctypes.c_void_p,
    ]
    lib.mkv_server_enable_events.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mkv_server_enable_latency.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mkv_server_set_serving.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mkv_server_serving.argtypes = [ctypes.c_void_p]
    lib.mkv_server_set_limits.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.mkv_server_set_degradation.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.mkv_server_degradation.argtypes = [ctypes.c_void_p]
    lib.mkv_server_events_depth.restype = ctypes.c_longlong
    lib.mkv_server_events_depth.argtypes = [ctypes.c_void_p]
    lib.mkv_server_set_slow_threshold.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,
    ]
    lib.mkv_server_set_partition.argtypes = [
        ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_longlong,
        ctypes.c_longlong,
    ]
    lib.mkv_server_set_partition_map.argtypes = [
        ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, P(ctypes.c_uint),
        P(ctypes.c_uint), P(ctypes.c_ulonglong),
    ]
    lib.mkv_server_set_partition_fence.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_ulonglong,
    ]
    lib.mkv_server_clear_partition_fence.argtypes = [ctypes.c_void_p]
    lib.mkv_install_crash_marker.argtypes = [ctypes.c_char_p]
    lib.mkv_server_drain_events.argtypes = [
        ctypes.c_void_p, ctypes.c_int, P(ctypes.c_void_p), P(ctypes.c_longlong),
    ]
    lib.mkv_server_events_dropped.restype = ctypes.c_longlong
    lib.mkv_server_events_dropped.argtypes = [ctypes.c_void_p]
    lib.mkv_server_wait_events.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mkv_server_stats.argtypes = [
        ctypes.c_void_p, P(ctypes.c_void_p), P(ctypes.c_int),
    ]
    _lib = lib
    return lib


def _take_buffer(lib: ctypes.CDLL, ptr: ctypes.c_void_p, length: int) -> bytes:
    try:
        return ctypes.string_at(ptr, length)
    finally:
        lib.mkv_free(ptr)


class NativeError(RuntimeError):
    pass


class NativeEngine:
    """Handle to a native storage engine (sharded in-memory or durable log)."""

    def __init__(self, kind: str = "mem", path: str = "") -> None:
        self._lib = _load()
        self._h = self._lib.mkv_engine_create(kind.encode(), path.encode())
        if not self._h:
            raise NativeError(f"engine create failed: {kind}")

    def close(self) -> None:
        if self._h:
            self._lib.mkv_engine_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- kv ops -------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        out = ctypes.c_void_p()
        out_len = ctypes.c_int()
        if not self._lib.mkv_engine_get(
            self._h, key, len(key), ctypes.byref(out), ctypes.byref(out_len)
        ):
            return None
        return _take_buffer(self._lib, out, out_len.value)

    def set(self, key: bytes, value: bytes) -> None:
        if not self._lib.mkv_engine_set(self._h, key, len(key), value, len(value)):
            raise NativeError("set failed")

    def set_with_ts(self, key: bytes, value: bytes, ts: int) -> None:
        """Install a value with an explicit last-write timestamp (unix ns) —
        LWW repair paths propagate ordering metadata with the value."""
        if not self._lib.mkv_engine_set_with_ts(
            self._h, key, len(key), value, len(value), ts
        ):
            raise NativeError("set_with_ts failed")

    def get_ts(self, key: bytes) -> Optional[int]:
        """Last-write unix-ns timestamp of a present key, else None."""
        ts = ctypes.c_ulonglong()
        if not self._lib.mkv_engine_get_ts(
            self._h, key, len(key), ctypes.byref(ts)
        ):
            return None
        return int(ts.value)

    def get_with_ts(self, key: bytes) -> Optional[tuple[bytes, int]]:
        """(value, last-write ts) read under ONE shard lock — the pairing a
        LWW consumer needs (a separate get + get_ts can interleave with a
        racing write)."""
        out = ctypes.c_void_p()
        out_len = ctypes.c_int()
        ts = ctypes.c_ulonglong()
        if not self._lib.mkv_engine_get_with_ts(
            self._h, key, len(key),
            ctypes.byref(out), ctypes.byref(out_len), ctypes.byref(ts),
        ):
            return None
        return _take_buffer(self._lib, out, out_len.value), int(ts.value)

    def delete(self, key: bytes) -> bool:
        """User-intent delete: records a tombstone stamped now, so the
        deletion participates in cluster LWW."""
        return bool(self._lib.mkv_engine_del(self._h, key, len(key)))

    def delete_with_ts(self, key: bytes, ts: int) -> bool:
        """Delete with an explicit tombstone timestamp (replication apply,
        tombstone adoption from a peer)."""
        return bool(self._lib.mkv_engine_del_with_ts(self._h, key, len(key), ts))

    def delete_quiet(self, key: bytes) -> bool:
        """Mirror delete — NO tombstone. Pairwise anti-entropy copies a
        peer's absence; recording that as a deletion-at-now would later kill
        disjoint writes cluster-wide through multi-peer LWW."""
        return bool(self._lib.mkv_engine_del_quiet(self._h, key, len(key)))

    def set_if_newer(self, key: bytes, value: bytes, ts: int) -> bool:
        """Install iff ts is not older than the entry AND any tombstone
        (value wins timestamp ties). Returns whether it applied."""
        return bool(
            self._lib.mkv_engine_set_if_newer(
                self._h, key, len(key), value, len(value), ts
            )
        )

    def delete_if_newer(self, key: bytes, ts: int) -> bool:
        """Delete iff ts is strictly newer than the live entry; records the
        tombstone. Returns whether it applied."""
        return bool(self._lib.mkv_engine_del_if_newer(self._h, key, len(key), ts))

    def apply_batch(
        self, ops: list[tuple[bytes, Optional[bytes], int]]
    ) -> list[bool]:
        """Run a whole replication frame of LWW-conditional ops in ONE FFI
        crossing: each op is ``(key, value, ts)`` with ``value=None``
        meaning delete_if_newer and anything else set_if_newer. Returns one
        applied flag per op (same order). The native side groups ops per
        shard so a k-op frame pays one lock per touched shard, not k."""
        if not ops:
            return []
        parts = [struct.pack("<I", len(ops))]
        for key, value, ts in ops:
            is_del = value is None
            v = b"" if is_del else value
            parts.append(struct.pack("<BQI", 1 if is_del else 0, ts, len(key)))
            parts.append(key)
            parts.append(struct.pack("<I", len(v)))
            parts.append(v)
        buf = b"".join(parts)
        out = ctypes.c_void_p()
        n = self._lib.mkv_engine_apply_batch(
            self._h, buf, len(buf), ctypes.byref(out)
        )
        if n < 0:
            raise NativeError("apply_batch: malformed op buffer")
        flags = _take_buffer(self._lib, out, n)
        return [bool(b) for b in flags]

    def tombstone_ts(self, key: bytes) -> Optional[int]:
        ts = ctypes.c_ulonglong()
        if not self._lib.mkv_engine_tombstone_ts(
            self._h, key, len(key), ctypes.byref(ts)
        ):
            return None
        return int(ts.value)

    def _read_kv_ts(self, fn, *args) -> list[tuple[bytes, int]]:
        """Call a C export returning the shared (u32 count, then u32 klen +
        key + u64 ts per item) wire shape and decode it."""
        out = ctypes.c_void_p()
        out_len = ctypes.c_int()
        fn(*args, ctypes.byref(out), ctypes.byref(out_len))
        buf = _take_buffer(self._lib, out, out_len.value)
        (n,) = struct.unpack_from("<I", buf, 0)
        items, off = [], 4
        for _ in range(n):
            (klen,) = struct.unpack_from("<I", buf, off)
            off += 4
            k = buf[off : off + klen]
            off += klen
            (ts,) = struct.unpack_from("<Q", buf, off)
            off += 8
            items.append((k, ts))
        return items

    def tombstones(self, prefix: bytes = b"") -> list[tuple[bytes, int]]:
        """Sorted (key, delete-ts) tombstones — the deletion half of the
        anti-entropy exchange."""
        return self._read_kv_ts(
            self._lib.mkv_engine_tombstones, self._h, prefix, len(prefix)
        )

    def key_timestamps(self) -> list[tuple[bytes, int]]:
        """(key, last-write-ts) for every live key in one native call,
        shard order — the bulk export multi-peer LWW arbitration consumes
        (it builds a map; sorting would be wasted work)."""
        return self._read_kv_ts(self._lib.mkv_engine_key_timestamps, self._h)

    def exists(self, key: bytes) -> bool:
        return bool(self._lib.mkv_engine_exists(self._h, key, len(key)))

    def dbsize(self) -> int:
        return self._lib.mkv_engine_dbsize(self._h)

    def memory_usage(self) -> int:
        return self._lib.mkv_engine_memory_usage(self._h)

    def slab_stats(self) -> dict[str, int]:
        """Value-slab accounting snapshot: ``bytes`` (live payload bytes,
        INCLUDING blocks pinned only by in-flight responses), ``blocks``,
        ``pinned_bytes`` (the in-flight-only subset), ``allocs`` (lifetime)
        and ``alloc_failures`` (writes refused by the MKV_MAX_SLAB_BYTES
        arena limit). Zeros for engines without block storage."""
        out = (ctypes.c_ulonglong * 5)()
        self._lib.mkv_engine_slab_stats(self._h, out)
        return {
            "bytes": int(out[0]),
            "blocks": int(out[1]),
            "pinned_bytes": int(out[2]),
            "allocs": int(out[3]),
            "alloc_failures": int(out[4]),
        }

    def version(self) -> int:
        """Engine mutation version (bumped per write). Only the sharded
        ("mem") and log engines track real versions; other kinds fall back
        to a bump-per-CALL counter, so cross-read comparisons (the mirror
        staleness gauge) are only meaningful on version-tracking engines."""
        return int(self._lib.mkv_engine_version(self._h))

    def tomb_evictions(self) -> int:
        """Deletion records dropped by the bounded tombstone map — each one
        is a delete the cluster can no longer defend against resurrection
        by a stale replica (surfaced via STATS as tombstone_evictions)."""
        return self._lib.mkv_engine_tomb_evictions(self._h)

    def log_version_refused(self) -> bool:
        """True when a durable log refused to open because its on-disk
        format version is newer than this binary supports (the file is left
        untouched; the engine runs empty with logging disabled)."""
        return bool(self._lib.mkv_engine_log_version_refused(self._h))

    def truncate(self) -> None:
        self._lib.mkv_engine_truncate(self._h)

    def sync(self) -> None:
        self._lib.mkv_engine_sync(self._h)

    def compact(self) -> bool:
        """Rewrite the durable log as a snapshot of live state plus
        tombstones (deletion LWW knowledge survives compaction). False for
        engines without a log."""
        return bool(self._lib.mkv_engine_compact(self._h))

    def increment(self, key: bytes, amount: int = 1) -> int:
        return self._numeric(self._lib.mkv_engine_increment, key, amount)

    def decrement(self, key: bytes, amount: int = 1) -> int:
        return self._numeric(self._lib.mkv_engine_decrement, key, amount)

    def _numeric(self, fn, key: bytes, amount: int) -> int:
        val = ctypes.c_longlong()
        err = ctypes.c_void_p()
        err_len = ctypes.c_int()
        if fn(
            self._h, key, len(key), amount,
            ctypes.byref(val), ctypes.byref(err), ctypes.byref(err_len),
        ):
            return val.value
        raise NativeError(_take_buffer(self._lib, err, err_len.value).decode())

    def append(self, key: bytes, value: bytes) -> bytes:
        return self._splice(self._lib.mkv_engine_append, key, value)

    def prepend(self, key: bytes, value: bytes) -> bytes:
        return self._splice(self._lib.mkv_engine_prepend, key, value)

    def _splice(self, fn, key: bytes, value: bytes) -> bytes:
        out = ctypes.c_void_p()
        out_len = ctypes.c_int()
        err = ctypes.c_void_p()
        err_len = ctypes.c_int()
        if fn(
            self._h, key, len(key), value, len(value),
            ctypes.byref(out), ctypes.byref(out_len),
            ctypes.byref(err), ctypes.byref(err_len),
        ):
            return _take_buffer(self._lib, out, out_len.value)
        raise NativeError(_take_buffer(self._lib, err, err_len.value).decode())

    def scan(self, prefix: bytes = b"") -> list[bytes]:
        out = ctypes.c_void_p()
        out_len = ctypes.c_int()
        self._lib.mkv_engine_scan(
            self._h, prefix, len(prefix), ctypes.byref(out), ctypes.byref(out_len)
        )
        buf = _take_buffer(self._lib, out, out_len.value)
        (n,) = struct.unpack_from("<I", buf, 0)
        keys, off = [], 4
        for _ in range(n):
            (klen,) = struct.unpack_from("<I", buf, off)
            off += 4
            keys.append(buf[off : off + klen])
            off += klen
        return keys

    def snapshot(self) -> list[tuple[bytes, bytes]]:
        """Whole keyspace sorted by key — the TPU Merkle rebuild input."""
        out = ctypes.c_void_p()
        out_len = ctypes.c_longlong()
        self._lib.mkv_engine_snapshot(
            self._h, ctypes.byref(out), ctypes.byref(out_len)
        )
        buf = _take_buffer(self._lib, out, out_len.value)
        (n,) = struct.unpack_from("<I", buf, 0)
        items, off = [], 4
        for _ in range(n):
            (klen,) = struct.unpack_from("<I", buf, off)
            off += 4
            k = buf[off : off + klen]
            off += klen
            (vlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            v = buf[off : off + vlen]
            off += vlen
            items.append((k, v))
        return items

    def merkle_root(self) -> Optional[bytes]:
        out = ctypes.create_string_buffer(32)
        if self._lib.mkv_engine_merkle_root(self._h, out):
            return out.raw
        return None


@dataclass
class ChangeEventRaw:
    """One drained native change record (op kinds match events.h)."""

    op: int
    has_value: bool
    ts_ns: int
    seq: int
    key: bytes
    value: bytes


OP_SET, OP_DEL, OP_INCR, OP_DECR, OP_APPEND, OP_PREPEND = 1, 2, 3, 4, 5, 6
OP_TRUNCATE = 7  # staged for device-mirror invalidation, never replicated


class NativeServer:
    """Embedded native TCP server bound to a NativeEngine."""

    def __init__(
        self,
        engine: NativeEngine,
        host: str = "127.0.0.1",
        port: int = 7379,
        version: str = "0.1.0",
        exit_on_shutdown: bool = False,
        io_threads: int = 0,
        pipelined: bool = True,
        reuseport: str = "auto",
        zero_copy: bool = True,
        max_line: int = 0,
    ) -> None:
        # Validate BEFORE mkv_server_create: a raise past that point would
        # leak the native handle (there is no __del__ to reclaim it).
        if reuseport not in ("auto", "on", "off"):
            raise ValueError(
                f"reuseport must be auto|on|off, got {reuseport!r}"
            )
        self._lib = _load()
        self._engine = engine  # keep alive
        self._h = self._lib.mkv_server_create(
            engine._h, host.encode(), port, version.encode(),
            1 if exit_on_shutdown else 0,
        )
        self._cb_ref = None
        if not self._h:
            raise NativeError("server create failed")
        # I/O-plane shape, fixed before start: io_threads 0 = hardware
        # concurrency, 1 = a single epoll loop; pipelined=False restores
        # the one-write-per-response compat discipline (the bench A/B
        # baseline approximating the old thread-per-connection server).
        self._lib.mkv_server_configure_io(
            self._h, io_threads, 1 if pipelined else 0
        )
        # Accept sharding: "auto" uses SO_REUSEPORT where the kernel
        # supports it (each io worker owns its own listener), "on" insists
        # (falls back with a note where unsupported), "off" keeps the
        # single accept loop. Admission control is identical either way.
        self._lib.mkv_server_configure_accept(
            self._h, {"off": -1, "auto": 0, "on": 1}[reuseport]
        )
        # Zero-copy serving A/B (default on): off restores the copy-out-
        # of-the-engine GET/MGET path — wire-identical, bench baseline.
        if not zero_copy:
            self._lib.mkv_server_set_zero_copy(self._h, 0)
        # Request-line cap (0 keeps the 1 MiB default); a SET of a ~1 MiB
        # value needs line headroom beyond the value itself.
        if max_line > 0:
            self._lib.mkv_server_set_max_line(self._h, max_line)

    def start(self) -> None:
        if not self._lib.mkv_server_start(self._h):
            raise NativeError("bind/listen failed")

    @property
    def io_threads(self) -> int:
        """Resolved epoll worker-pool width (0 before start)."""
        if not self._h:
            return 0
        return int(self._lib.mkv_server_io_threads(self._h))

    @property
    def reuseport(self) -> bool:
        """True once start() actually sharded the accept path (every io
        worker owns its own SO_REUSEPORT listener)."""
        if not self._h:
            return False
        return bool(self._lib.mkv_server_reuseport(self._h))

    def set_zero_copy(self, on: bool = True) -> None:
        """Flip the zero-copy serving path (the bench flips it off for
        the compat A/B baseline; wire behavior is identical)."""
        if self._h:
            self._lib.mkv_server_set_zero_copy(self._h, 1 if on else 0)

    @property
    def port(self) -> int:
        return self._lib.mkv_server_port(self._h)

    @property
    def stopping(self) -> bool:
        return bool(self._lib.mkv_server_stopping(self._h))

    def stop(self) -> None:
        self._lib.mkv_server_stop(self._h)

    def wait(self) -> None:
        self._lib.mkv_server_wait(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.mkv_server_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def set_cluster_handler(
        self, handler: Optional[Callable[[str], Optional[str]]]
    ) -> None:
        """Route SYNC/REPLICATE lines to `handler`; return the full response
        text (CRLF included) or None to fall back to native defaults."""
        if handler is None:
            self._cb_ref = None
            self._lib.mkv_server_set_cluster_cb(
                self._h, ctypes.cast(None, _CLUSTER_CB), None
            )
            return

        def trampoline(_ctx, line, out_buf, out_cap):
            try:
                resp = handler(line.decode())
            except Exception as e:  # never let exceptions cross the FFI
                resp = f"ERROR {e}\r\n"
            if resp is None:
                return 0
            data = resp.encode()[: out_cap - 1]
            ctypes.memmove(out_buf, data, len(data))
            return len(data)

        self._cb_ref = _CLUSTER_CB(trampoline)  # keep trampoline alive
        self._lib.mkv_server_set_cluster_cb(self._h, self._cb_ref, None)

    def enable_events(self, on: bool = True) -> None:
        """Turn change-event staging on/off. Off by default — without a
        drainer the queue would pin keys+values for up to 2^20 writes."""
        self._lib.mkv_server_enable_events(self._h, 1 if on else 0)

    def enable_latency(self, on: bool = True) -> None:
        """Toggle the native command-latency histogram (on by default);
        bench.py flips it off to A/B the metrics plane's hot-path cost."""
        self._lib.mkv_server_enable_latency(self._h, 1 if on else 0)

    def set_serving(self, on: bool = True) -> None:
        """Bootstrap read gate: while off, data-plane reads and the
        anti-entropy serving verbs answer ``ERROR LOADING ...`` — a
        bootstrapping node serves zero reads before its shipped snapshot
        verifies (cluster/bootstrap.py flips this). Writes, PING and the
        management verbs stay available."""
        if self._h:
            self._lib.mkv_server_set_serving(self._h, 1 if on else 0)

    @property
    def serving(self) -> bool:
        if not self._h:
            return False
        return bool(self._lib.mkv_server_serving(self._h))

    def set_limits(
        self, max_connections: int = 0, max_pipeline: int = 0
    ) -> None:
        """Admission-control limits: past ``max_connections`` (0 =
        unlimited) excess accepts are answered ``ERROR BUSY connections``
        and closed before ever entering the io worker pool;
        ``max_pipeline`` bounds one connection's unanswered pipelined
        commands (0 = unlimited)."""
        if self._h:
            self._lib.mkv_server_set_limits(
                self._h, max_connections, max_pipeline
            )

    def set_degradation(self, level: int, reason: int = 0) -> None:
        """Push the node's degradation-ladder level (0=live 1=shedding
        2=read_only 3=draining; reason 0=none 1=memory 2=disk 3=draining
        4=admin). The native server enforces it: shedding answers write
        verbs ``ERROR BUSY <why> retry``, read_only/draining answer
        ``ERROR READONLY <why>``, draining also refuses new connections.
        Reads and the management/anti-entropy plane stay open."""
        if self._h:
            self._lib.mkv_server_set_degradation(self._h, level, reason)

    @property
    def degradation(self) -> int:
        """Current degradation-ladder level (0=live .. 3=draining)."""
        if not self._h:
            return 0
        return int(self._lib.mkv_server_degradation(self._h))

    def events_depth(self) -> int:
        """Staged-but-undrained change events (the replication/WAL feed's
        backlog; also on STATS as ``events_queue_depth``)."""
        if not self._h:
            return 0
        return int(self._lib.mkv_server_events_depth(self._h))

    def set_partition(self, epoch: int, count: int, owned: int) -> None:
        """Partitioned cluster mode: this node owns partition ``owned`` of
        a ``count``-way keyspace at map generation ``epoch``. While
        ``count`` > 0 the native dispatch refuses data verbs whose keys
        hash to a FOREIGN partition (and HASH/TREELEVEL requests pt=-
        addressed to one) with the retryable ``ERROR MOVED <pid>
        <epoch>`` — a stale map can never silently read or write the
        wrong node. ``count`` 0 disables the guard (the default)."""
        if self._h:
            self._lib.mkv_server_set_partition(self._h, epoch, count, owned)

    def set_partition_map(
        self,
        epoch: int,
        base: int,
        owned: int,
        assignments: list[tuple[int, int, int]],
    ) -> None:
        """Install a SPLIT-TREE partition map in the native guard (the
        live-rebalancing generalization of :meth:`set_partition`):
        partition ``p`` owns the hash-space cell ``assignments[p] =
        (root, depth, path)`` under ``base`` (see
        cluster/partmap.py — routing stays bit-identical across guard,
        clients, and router). A boot-shaped map degenerates to the
        legacy modulo guard natively."""
        if not self._h:
            return
        n = len(assignments)
        roots = (ctypes.c_uint * n)(*[a[0] for a in assignments])
        depths = (ctypes.c_uint * n)(*[a[1] for a in assignments])
        paths = (ctypes.c_ulonglong * n)(*[a[2] for a in assignments])
        self._lib.mkv_server_set_partition_map(
            self._h, epoch, base, n, owned, roots, depths, paths
        )

    def set_partition_fence(
        self, base: int, root: int, depth: int, path: int
    ) -> None:
        """Arm the rebalance write fence: writes whose key falls in the
        split-tree cell ``(root, depth, path)`` under ``base`` answer the
        retryable ``ERROR BUSY rebalance retry`` until
        :meth:`clear_partition_fence` — the (brief) flip window of a live
        split. Reads keep serving throughout."""
        if self._h:
            self._lib.mkv_server_set_partition_fence(
                self._h, base, root, depth, path
            )

    def clear_partition_fence(self) -> None:
        if self._h:
            self._lib.mkv_server_clear_partition_fence(self._h)

    def set_slow_threshold(self, us: int) -> None:
        """Slow-command log threshold in microseconds (0 = off): a
        dispatch taking at least this long is recorded in the native
        flight log (served by the FLIGHT verb on bare nodes) and relayed
        to the control plane as a SLOWCMD notification so the Python
        flight ring carries it too."""
        if self._h:
            self._lib.mkv_server_set_slow_threshold(self._h, us)

    def drain_events(self, max_events: int = 0) -> list[ChangeEventRaw]:
        out = ctypes.c_void_p()
        out_len = ctypes.c_longlong()
        self._lib.mkv_server_drain_events(
            self._h, max_events, ctypes.byref(out), ctypes.byref(out_len)
        )
        buf = _take_buffer(self._lib, out, out_len.value)
        (n,) = struct.unpack_from("<I", buf, 0)
        events, off = [], 4
        for _ in range(n):
            op, has_value = buf[off], bool(buf[off + 1])
            ts_ns, seq = struct.unpack_from("<QQ", buf, off + 2)
            off += 18
            (klen,) = struct.unpack_from("<I", buf, off)
            off += 4
            key = buf[off : off + klen]
            off += klen
            (vlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            value = buf[off : off + vlen]
            off += vlen
            events.append(ChangeEventRaw(op, has_value, ts_ns, seq, key, value))
        return events

    def events_dropped(self) -> int:
        return self._lib.mkv_server_events_dropped(self._h)

    def wait_events(self, timeout_ms: int) -> bool:
        """Park until the change-event queue is non-empty (or the timeout
        elapses); returns whether events are pending. The drain threads use
        this instead of interval polling — the first staged write wakes
        them, so a single SET replicates in the notify latency, not half a
        poll interval, and an idle node stops burning poll wakeups."""
        if not self._h:
            return False
        return bool(self._lib.mkv_server_wait_events(self._h, timeout_ms))

    def stats_text(self) -> str:
        if not self._h:
            # A /metrics scrape can race server teardown (exporter handler
            # threads outlive node.stop() ordering mistakes); an empty
            # block beats driving the FFI through a dead handle.
            return ""
        out = ctypes.c_void_p()
        out_len = ctypes.c_int()
        self._lib.mkv_server_stats(self._h, ctypes.byref(out), ctypes.byref(out_len))
        return _take_buffer(self._lib, out, out_len.value).decode()
