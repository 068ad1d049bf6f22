"""CUDA SHA-256 kernels for Hopper: the wrappers.

Counterpart of ``merklekv_tpu/ops/sha256_pallas.py``. The kernels live in
``merklekv_tpu_torch/csrc/sha256_kernels.cu`` (round math in
``sha256_core.cuh``); the note at the top of that file says which Pallas
kernel each one replaces, what bounds it on an H100 and what its design
does about that. The ragged leaf hash, which no Pallas kernel has, lives in
``csrc/ragged_leaves.cu`` with a note of its own. ``ops/cuda_lib.py`` builds
and binds the library and states the contract every wrapper here keeps.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from merklekv_tpu_torch.ops.cuda_lib import check_cuda, is_cpu, launch
from merklekv_tpu_torch.ops.sha256 import (
    sha256_blocks,
    sha256_node_level,
    sha256_node_pairs,
    sha256_ragged,
)

__all__ = [
    "leaf_digests_cuda",
    "leaf_ragged_cuda",
    "node_level_cuda",
    "node_pairs_cuda",
    "ragged_shape",
]


def leaf_digests_cuda(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """[N, B, 16] int32 padded blocks + [N] int32 valid counts -> [N, 8]
    int32 digests (counterpart of ``leaf_digests_pallas``)."""
    if is_cpu(blocks, nblocks):
        return sha256_blocks(blocks, nblocks)
    dev = blocks.device
    check_cuda(blocks, "blocks", 3, 16, dev)
    check_cuda(nblocks, "nblocks", 1, None, dev)
    n, nblk = blocks.shape[0], blocks.shape[1]
    if nblocks.shape[0] != n:
        raise ValueError(f"nblocks has {nblocks.shape[0]} rows, blocks {n}")
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n:
        launch("mkv_leaf_digests", dev, blocks.data_ptr(), nblocks.data_ptr(), out.data_ptr(),
               n, nblk)
    return out


def leaf_ragged_cuda(blocks: torch.Tensor, offsets: torch.Tensor, order: torch.Tensor,
                     chained: int) -> torch.Tensor:
    """[T, 16] int32 blocks, leaf i's at ``offsets[i]:offsets[i + 1]`` ([N + 1]
    int64) -> [N, 8] int32 digests in key order. ``order`` [N] int32 is the
    leaves by block count, longest first; on a card its first ``chained``
    positions run each on an SM sub-partition of its own
    (``csrc/ragged_leaves.cu``). The plain version reads neither."""
    if is_cpu(blocks, offsets, order):
        return sha256_ragged(blocks, offsets)
    dev = blocks.device
    check_cuda(blocks, "blocks", 2, 16, dev)
    if offsets.device != dev or offsets.dtype != torch.int64 or offsets.dim() != 1 \
            or not offsets.is_contiguous() or offsets.shape[0] < 1:
        raise ValueError(f"offsets must be a contiguous [N + 1] int64 vector on {dev}")
    check_cuda(order, "order", 1, None, dev)
    n = offsets.shape[0] - 1
    if order.shape[0] != n:
        raise ValueError(f"order has {order.shape[0]} positions for {n} leaves")
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n:
        launch("mkv_leaf_ragged", dev, blocks.data_ptr(), offsets.data_ptr(), order.data_ptr(),
               out.data_ptr(), n, int(chained))
    return out


_shapes: dict = {}
_shapes_lock = threading.Lock()


def ragged_shape(dev: torch.device) -> tuple[int, int]:
    """(SMs, warps the ragged bulk kernel keeps resident on each SM
    sub-partition) of card ``dev``, asked once and kept."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _shapes_lock:
        if index not in _shapes:
            sms, warps = ctypes.c_int32(), ctypes.c_int32()
            launch("mkv_ragged_shape", torch.device("cuda", index), ctypes.byref(sms),
                   ctypes.byref(warps))
            _shapes[index] = (sms.value, warps.value)
        return _shapes[index]


def node_level_cuda(cur: torch.Tensor) -> torch.Tensor:
    """[M, 8] int32 tree level -> [M//2, 8] parents of ADJACENT rows
    (counterpart of ``node_level_pallas``; the odd tail is the caller's)."""
    if is_cpu(cur):
        return sha256_node_level(cur)
    dev = cur.device
    check_cuda(cur, "cur", 2, 8, dev)
    p = cur.shape[0] // 2
    out = torch.empty((p, 8), dtype=torch.int32, device=dev)
    if p:
        launch("mkv_node_level", dev, cur.data_ptr(), out.data_ptr(), p)
    return out


def node_pairs_cuda(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[P, 8] x [P, 8] int32 digests -> [P, 8] SHA256(left || right)
    (counterpart of ``node_pairs_pallas``), in blocks of up to 4 warps
    (``csrc/node_pairs.cuh``)."""
    if is_cpu(left, right):
        return sha256_node_pairs(left, right)
    dev = left.device
    check_cuda(left, "left", 2, 8, dev)
    check_cuda(right, "right", 2, 8, dev)
    if left.shape != right.shape:
        raise ValueError(f"left {tuple(left.shape)} != right {tuple(right.shape)}")
    p = left.shape[0]
    out = torch.empty((p, 8), dtype=torch.int32, device=dev)
    if p:
        launch("mkv_node_pairs", dev, left.data_ptr(), right.data_ptr(), out.data_ptr(), p)
    return out
