"""CUDA SHA-256 kernels for Hopper: build, bind, and the three wrappers.

Counterpart of ``merklekv_tpu/ops/sha256_pallas.py``. The kernels live in
``merklekv_tpu_torch/csrc/sha256_kernels.cu`` (round math in
``sha256_core.cuh``); the note at the top of that file says which Pallas
kernel each one replaces, what bounds it on an H100 and what its design
does about that. The serving tree's path-rehash and promotion-chain
kernels (``csrc/merkle_paths.cu``) and the N-replica diff kernel
(``csrc/diff_kernels.cu``) are built into the same library; their bindings
and wrappers are in ``ops/merkle_paths.py`` and ``ops/diff_cuda.py``.

Build: at first use, one ``nvcc`` per source, all started together, compiles
it for ``sm_90a``; one more links the objects into a shared library with a
plain C interface under ``build/torch_kernels/`` at the repository root,
named by a hash of the sources and flags (so an edited source is rebuilt and
an unchanged one is loaded as it is); ``ctypes`` binds it. Nothing is built
or imported when this module is imported.

Wrappers (``leaf_digests_cuda``, ``node_level_cuda``, ``node_pairs_cuda``):
- a tensor on the CPU runs the kernel's plain PyTorch version
  (``ops/sha256.py``); that is the only case that does;
- a CUDA tensor is checked (dtype ``int32``, shape, contiguity, alignment,
  one device) and the kernel is launched under ``torch.cuda.device`` of the
  tensor, on that device's current stream, or the wrapper raises — a failed
  build or a refused launch is an error, never a fallback. The device is set
  at every launch because the serving mirror's dispatch guard runs each
  device call on a new thread;
- an empty input returns an empty output without a launch (a zero-block grid
  is a launch error);
- ``LAUNCHES[name]`` counts the kernel's launches, and is incremented at the
  launch and nowhere else.
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
from typing import Optional

import torch

from merklekv_tpu_torch.ops.sha256 import (
    sha256_blocks,
    sha256_node_level,
    sha256_node_pairs,
)

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "build_kernels",
    "leaf_digests_cuda",
    "node_level_cuda",
    "node_pairs_cuda",
    "build_levels_cuda",
    "tree_root_cuda",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("sha256_kernels.cu", "merkle_paths.cu", "diff_kernels.cu")
_HEADERS = ("sha256_core.cuh", "merkle_paths.cuh", "node_pairs.cuh", "diff_kernels.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)

# Launch counts per kernel: plain integers, bumped where a kernel launches.
LAUNCHES = {"leaf": 0, "node_level": 0, "node_pairs": 0,
            "path_rehash": 0, "promotion_chain": 0, "diff": 0}


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


def _nvcc() -> str:
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
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    """Bind this module's entry points (``ops/merkle_paths.py`` binds its own)."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.mkv_leaf_digests.argtypes = [p, p, p, i64, i32, p]
    lib.mkv_node_level.argtypes = [p, p, i64, p]
    lib.mkv_node_pairs.argtypes = [p, p, p, i64, p]
    for fn in (lib.mkv_leaf_digests, lib.mkv_node_level, lib.mkv_node_pairs):
        fn.restype = ctypes.c_int
    lib.mkv_error_string.argtypes = [ctypes.c_int]
    lib.mkv_error_string.restype = ctypes.c_char_p


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
    """Build (if needed) and load the kernel library; idempotent.

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
            nvcc = _nvcc()
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            objs = [tmp.with_name(f"{tmp.name}.{Path(src).stem}.o") for src in _SOURCES]
            t0 = time.perf_counter()
            try:
                log = _run_nvcc([[nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(_CSRC / src)]
                                 for src, obj in zip(_SOURCES, objs)])
                log += _run_nvcc([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
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


def _check_rc(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.mkv_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def _check_cuda(t: torch.Tensor, name: str, dim: int, last: Optional[int],
                device: torch.device) -> None:
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


def _is_cpu(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"tensors must all be on CUDA or all on the CPU: {kinds}")
    return False


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def leaf_digests_cuda(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """[N, B, 16] int32 padded blocks + [N] int32 valid counts -> [N, 8]
    int32 digests (counterpart of ``leaf_digests_pallas``)."""
    if _is_cpu(blocks, nblocks):
        return sha256_blocks(blocks, nblocks)
    dev = blocks.device
    _check_cuda(blocks, "blocks", 3, 16, dev)
    _check_cuda(nblocks, "nblocks", 1, None, dev)
    n, nblk = blocks.shape[0], blocks.shape[1]
    if nblocks.shape[0] != n:
        raise ValueError(f"nblocks has {nblocks.shape[0]} rows, blocks {n}")
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = build_kernels().lib
    with torch.cuda.device(dev):
        rc = lib.mkv_leaf_digests(blocks.data_ptr(), nblocks.data_ptr(),
                                  out.data_ptr(), n, nblk, _stream(dev))
        _check_rc(lib, rc, "leaf")
        LAUNCHES["leaf"] += 1
    return out


def node_level_cuda(cur: torch.Tensor) -> torch.Tensor:
    """[M, 8] int32 tree level -> [M//2, 8] parents of ADJACENT rows
    (counterpart of ``node_level_pallas``; the odd tail is the caller's)."""
    if _is_cpu(cur):
        return sha256_node_level(cur)
    dev = cur.device
    _check_cuda(cur, "cur", 2, 8, dev)
    p = cur.shape[0] // 2
    out = torch.empty((p, 8), dtype=torch.int32, device=dev)
    if p == 0:
        return out
    lib = build_kernels().lib
    with torch.cuda.device(dev):
        rc = lib.mkv_node_level(cur.data_ptr(), out.data_ptr(), p, _stream(dev))
        _check_rc(lib, rc, "node_level")
        LAUNCHES["node_level"] += 1
    return out


def node_pairs_cuda(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[P, 8] x [P, 8] int32 digests -> [P, 8] SHA256(left || right)
    (counterpart of ``node_pairs_pallas``), in blocks of up to 4 warps
    (``csrc/node_pairs.cuh``)."""
    if _is_cpu(left, right):
        return sha256_node_pairs(left, right)
    dev = left.device
    _check_cuda(left, "left", 2, 8, dev)
    _check_cuda(right, "right", 2, 8, dev)
    if left.shape != right.shape:
        raise ValueError(f"left {tuple(left.shape)} != right {tuple(right.shape)}")
    p = left.shape[0]
    out = torch.empty((p, 8), dtype=torch.int32, device=dev)
    if p == 0:
        return out
    lib = build_kernels().lib
    with torch.cuda.device(dev):
        rc = lib.mkv_node_pairs(left.data_ptr(), right.data_ptr(),
                                out.data_ptr(), p, _stream(dev))
        _check_rc(lib, rc, "node_pairs")
        LAUNCHES["node_pairs"] += 1
    return out


# ------------------------------------------------------------ tree build

def build_levels_cuda(leaves: torch.Tensor) -> list[torch.Tensor]:
    """All tree levels from [N, 8] leaf digests, odd-promotion rule intact
    (counterpart of ``build_levels_pallas``). Every level runs the level
    kernel on a CUDA tensor — one launch per level, however narrow — and the
    plain version on a CPU tensor."""
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        nxt = node_level_cuda(cur)
        if cur.shape[0] % 2:
            nxt = torch.cat([nxt, cur[-1:]], dim=0)
        levels.append(nxt)
        cur = nxt
    return levels


def tree_root_cuda(leaves: torch.Tensor) -> torch.Tensor:
    """[N, 8] leaf digests -> [8] root digest (N >= 1)."""
    return build_levels_cuda(leaves)[-1][0]
