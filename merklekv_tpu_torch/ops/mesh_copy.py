"""The key mesh's copy-engine copies: the binding and wrapper of
``csrc/mesh_copy.cu`` (built into the kernel library by
``ops/sha256_cuda.py``).

- ``copy_columns(dst, col, src, stream)`` writes a CUDA ``[R, L]`` tensor
  into columns ``col .. col + L`` of a CUDA ``[R, N]`` tensor of the same
  dtype as one ``cudaMemcpy2DAsync`` on ``stream``: across cards the copy
  engines move it, peer to peer; within one card it waits for free SMs.
  The wrapper only queues the copy: ordering it after the writes of
  ``src`` and before the reads of ``dst`` is the caller's;
- ``enable_peer_access(device, peer)`` lets card ``device`` reach card
  ``peer``'s memory directly (without it CUDA stages a copy between
  them through the host); once for each pair in a process.

There is no plain version: the wrappers take CUDA tensors only, and
``parallel/sharded_merkle.py`` copies with ``Tensor.copy_`` wherever the
copy engines do not serve. A failed build or a refused copy raises.
``COPIES["2d"]`` counts the copies, bumped at the call and nowhere else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from merklekv_tpu_torch.ops.sha256_cuda import build_kernels

__all__ = ["COPIES", "enable_peer_access", "copy_columns"]

COPIES = {"2d": 0}
_peers: set = set()
_peers_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The kernel library with ``mkv_enable_peer_access`` and
    ``mkv_copy_2d`` bound."""
    lib = build_kernels().lib
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.mkv_enable_peer_access.argtypes = [i32, i32]
    lib.mkv_copy_2d.argtypes = [p, i64, p, i64, i64, i64, p]
    for fn in (lib.mkv_enable_peer_access, lib.mkv_copy_2d):
        fn.restype = ctypes.c_int
    return lib


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: {lib.mkv_error_string(rc).decode()} ({rc})")


def enable_peer_access(device: int, peer: int) -> None:
    """Let card ``device`` reach card ``peer``'s memory (access already on
    is no error)."""
    with _peers_lock:
        if (device, peer) in _peers:
            return
        lib = _lib()
        _check(lib, lib.mkv_enable_peer_access(device, peer),
               f"cudaDeviceEnablePeerAccess from card {device} to card {peer}")
        _peers.add((device, peer))


def copy_columns(dst: torch.Tensor, col: int, src: torch.Tensor,
                 stream: torch.cuda.Stream) -> None:
    """Queue ``dst[:, col:col + L] = src`` on ``stream`` as one copy-engine
    2-D copy: ``src`` [R, L] and ``dst`` [R, N], CUDA, one dtype, each
    row contiguous."""
    if dst.device.type != "cuda" or src.device.type != "cuda":
        raise ValueError(f"copy_columns takes CUDA tensors, got {dst.device} and {src.device}")
    if dst.dtype != src.dtype:
        raise TypeError(f"dtypes differ: {dst.dtype} and {src.dtype}")
    if dst.dim() != 2 or src.dim() != 2 or src.shape[0] != dst.shape[0]:
        raise ValueError(f"src {tuple(src.shape)} is not rows of dst {tuple(dst.shape)}")
    if not 0 <= col <= dst.shape[1] - src.shape[1]:
        raise ValueError(f"columns {col} .. {col + src.shape[1]} outside dst's {dst.shape[1]}")
    if dst.stride(1) != 1 or src.stride(1) != 1:
        raise ValueError("copy_columns needs contiguous rows")
    rows, size = src.shape[0], src.element_size()
    width = src.shape[1] * size
    if rows == 0 or width == 0:
        return
    lib = _lib()
    with torch.cuda.device(stream.device):
        rc = lib.mkv_copy_2d(dst.data_ptr() + col * size, max(dst.stride(0) * size, width),
                             src.data_ptr(), max(src.stride(0) * size, width), width, rows,
                             stream.cuda_stream)
        _check(lib, rc, "cudaMemcpy2DAsync")
        COPIES["2d"] += 1
