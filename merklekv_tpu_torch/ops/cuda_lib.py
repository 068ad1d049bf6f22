"""The CUDA kernel library: build, bind and launch every ``mkv_*`` entry.

Build: at first use, one ``nvcc`` per ``csrc/*.cu``, all started together,
compiles it for ``sm_90a``; one more links the objects into a shared library
with a plain C interface under ``build/torch_kernels/`` at the repository
root, named by a hash of every ``csrc/*.cu`` and ``csrc/*.cuh`` and the
flags (so an edited source is rebuilt and an unchanged one is loaded as it
is). Sources are found, not listed: a new kernel is a new ``.cu`` and its
rows in ``ENTRIES``. Nothing is built or imported when this module is
imported.

Binding: ``ENTRIES`` holds every entry Python calls, with its ``argtypes``;
each is bound once, when the library loads, and the path-rehash kernel's
arrival group is checked against ``PATH_GROUP`` then too.

The wrappers (``ops/sha256_cuda.py``, ``ops/diff_cuda.py``,
``ops/merkle_paths.py``, ``ops/mesh_copy.py``) follow one contract:
- tensors on the CPU run the kernel's plain PyTorch version; that is the
  only case that does (the mesh copies have none and take CUDA tensors
  only);
- CUDA tensors are checked (dtypes, shapes, one device) and the entry runs
  through :func:`launch`, under ``torch.cuda.device`` of the tensors, on
  that device's current stream or the stream given, or the wrapper raises:
  a failed build or a refused launch is an error, never a fallback. The
  device is set at every launch because the serving mirror's dispatch
  guard runs each device call on a new thread;
- an empty input returns an empty output without a launch (a zero-block
  grid is a launch error);
- ``LAUNCHES[name]`` counts the entry's launches, bumped in :func:`launch`
  and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

__all__ = [
    "BUILD_DIR",
    "ENTRIES",
    "LAUNCHES",
    "PATH_GROUP",
    "MkvLevels",
    "build_kernels",
    "check_cuda",
    "current_stream",
    "is_cpu",
    "launch",
    "nvcc",
    "reset_launch_counts",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)

# Blocks per arrival group of the path-rehash kernel (csrc/merkle_paths.cuh,
# kMkvGroup): ops/merkle_paths.py sizes the kernel's scratch with it; the
# library's is checked at load, tests/test_torch_csrc_core.py the header's.
PATH_GROUP = 128


class MkvLevels(ctypes.Structure):
    """``struct MkvLevels`` of ``csrc/merkle_paths.cuh``: every level's row
    pointer plus the depth, handed to a kernel by value."""

    MAX_LEVELS = 64
    _fields_ = [("rows", ctypes.c_void_p * MAX_LEVELS), ("depth", ctypes.c_int32)]


class Entry(NamedTuple):
    """One C entry: its key in ``LAUNCHES`` (None for a call that queues no
    device work: it takes no stream and is not counted), its ``argtypes``
    without the trailing stream, and its ``restype``."""

    launches: Optional[str]
    argtypes: list
    restype: type = ctypes.c_int


_p, _i64, _i32, _lv = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(MkvLevels)
_pi32 = ctypes.POINTER(ctypes.c_int32)
ENTRIES = {
    "mkv_leaf_digests": Entry("leaf", [_p, _p, _p, _i64, _i32]),
    "mkv_leaf_ragged": Entry("leaf_ragged", [_p, _p, _p, _p, _i64, _i64]),
    "mkv_ragged_shape": Entry(None, [_pi32, _pi32]),
    "mkv_node_level": Entry("node_level", [_p, _p, _i64]),
    "mkv_node_pairs": Entry("node_pairs", [_p, _p, _p, _i64]),
    "mkv_path_rehash": Entry("path_rehash", [_lv, _p, _p, _p, _i32, _i32, _i32, _i32, _p]),
    "mkv_promotion_chain": Entry("promotion_chain", [_lv, _i64, _i32, _p]),
    "mkv_divergence": Entry("diff", [_p, _i64, _p, _i64, _p, _p, _i64, _i32, _i32]),
    "mkv_hash_chain": Entry("hash_chain", [_p, _i32, _i32, _p, _p]),
    "mkv_copy_2d": Entry("copy_2d", [_p, _i64, _p, _i64, _i64, _i64]),
    "mkv_enable_peer_access": Entry(None, [_i32, _i32]),
    "mkv_path_group": Entry(None, []),
    "mkv_error_string": Entry(None, [ctypes.c_int], ctypes.c_char_p),
}

# Launch counts per entry that queues device work: plain integers.
LAUNCHES = {e.launches: 0 for e in ENTRIES.values() if e.launches}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _Kernels:
    """The loaded library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds
        self.build_log = log


_kernels: Optional[_Kernels] = None
_build_lock = threading.Lock()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_tag() -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    for name, entry in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = entry.argtypes + ([ctypes.c_void_p] if entry.launches else [])
        fn.restype = entry.restype
    if lib.mkv_path_group() != PATH_GROUP:
        raise RuntimeError(f"the kernel's arrival groups have {lib.mkv_path_group()} blocks, "
                           f"the scratch is sized for {PATH_GROUP}")


def _run_nvcc(cmds: list[list[str]]) -> str:
    """Run the nvcc commands all at once; return their output or raise."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    return "".join(logs)


def build_kernels() -> _Kernels:
    """Build (if needed), load and bind the kernel library; idempotent.

    Returns the loaded kernels with the build's wall seconds (0.0 when an
    identical build was already on disk) and nvcc's ``-Xptxas -v`` report.
    """
    global _kernels
    with _build_lock:
        if _kernels is not None:
            return _kernels
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"libmkv_kernels_{_source_tag()}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            compiler = nvcc()
            srcs = sorted(_CSRC.glob("*.cu"))
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
            t0 = time.perf_counter()
            try:
                log = _run_nvcc([[compiler, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                                 for src, obj in zip(srcs, objs)])
                log += _run_nvcc([[compiler, "-shared", "-o", str(tmp), *map(str, objs)]])
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
            finally:
                for obj in objs:
                    obj.unlink(missing_ok=True)
            seconds = time.perf_counter() - t0
            log_path.write_text(log)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _bind(lib)
        log = log_path.read_text() if log_path.exists() else ""
        _kernels = _Kernels(lib, out, seconds, log)
        return _kernels


def launch(entry: str, device: torch.device, *args,
           stream: Optional[torch.cuda.Stream] = None) -> None:
    """Run ``entry`` of ``ENTRIES`` with ``args`` under ``torch.cuda.device``
    of ``device``. An entry that queues device work gets ``stream`` (default:
    the device's current stream) as its last argument and is counted in
    ``LAUNCHES``. A nonzero return code raises with the library's message."""
    lib = build_kernels().lib
    name = ENTRIES[entry].launches
    with torch.cuda.device(device):
        if name:
            args += ((stream if stream is not None else
                      torch.cuda.current_stream(device)).cuda_stream,)
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            msg = lib.mkv_error_string(rc).decode()
            raise RuntimeError(f"CUDA entry {entry} failed on {device}: {msg} ({rc})")
        if name:
            LAUNCHES[name] += 1


def check_cuda(t: torch.Tensor, name: str, dim: int, last: Optional[int],
               device: torch.device) -> None:
    """Refuse ``t`` unless it is a contiguous int32 tensor of ``dim``
    dimensions on ``device`` (with a last axis of ``last`` words, 16-byte
    aligned, when ``last`` is given)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != dim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if last is not None and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for vector loads")


def is_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor is on the CPU, False when every one is on
    CUDA; raises on a mix or another device."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"tensors must all be on CUDA or all on the CPU: {kinds}")
    return False


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream."""
    return torch.cuda.current_stream(device).cuda_stream
