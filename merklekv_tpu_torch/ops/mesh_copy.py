"""The key mesh's copy-engine copies: the wrappers of ``csrc/mesh_copy.cu``.

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
copy engines do not serve. Otherwise they keep the contract of
``ops/cuda_lib.py``: ``LAUNCHES["copy_2d"]`` counts the copies.
"""

from __future__ import annotations

import threading

import torch

from merklekv_tpu_torch.ops.cuda_lib import launch

__all__ = ["enable_peer_access", "copy_columns"]

_peers: set = set()
_peers_lock = threading.Lock()


def enable_peer_access(device: int, peer: int) -> None:
    """Let card ``device`` reach card ``peer``'s memory (access already on
    is no error)."""
    with _peers_lock:
        if (device, peer) in _peers:
            return
        launch("mkv_enable_peer_access", torch.device("cuda", device), device, peer)
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
    launch("mkv_copy_2d", stream.device, dst.data_ptr() + col * size,
           max(dst.stride(0) * size, width), src.data_ptr(), max(src.stride(0) * size, width),
           width, rows, stream=stream)
