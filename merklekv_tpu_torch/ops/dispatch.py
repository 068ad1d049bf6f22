"""SHA-256 backend dispatch: the CUDA kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors.

Counterpart of ``merklekv_tpu/ops/dispatch.py``. Every hashing site of the
torch package (leaf digests, padded or ragged, the static tree build, the
serving tree's path rehash, promotion chain and restructure) routes through
these functions, and so does the N-replica diff (``divergence``), which the
JAX package left to XLA's fusion.

Policy: the tensor's device decides, and nothing else. The functions here
only forward: each wrapper (``ops/sha256_cuda.py``, ``ops/merkle_paths.py``,
``ops/diff_cuda.py``) looks at its tensors' device and sends a CUDA tensor
to the kernel through ``ops/cuda_lib.py`` (or raises) and a CPU tensor to
the plain version. ``build_levels`` is the one function that builds a whole
tree, a level-kernel launch per level. There is no environment switch that
picks the plain version on the card and no size cutoff: the JAX package's
interpreter cutoffs existed because interpreted Pallas is slow on the CPU,
and the CPU here runs plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from merklekv_tpu_torch.ops.diff_cuda import divergence_beside_cuda, divergence_cuda
from merklekv_tpu_torch.ops.merkle_paths import (
    path_rehash_cuda,
    path_scratch,
    promotion_chain_cuda,
)
from merklekv_tpu_torch.ops.sha256_cuda import (
    leaf_digests_cuda,
    leaf_ragged_cuda,
    node_level_cuda,
    node_pairs_cuda,
)

__all__ = [
    "hash_blocks",
    "hash_ragged",
    "hash_node_pairs",
    "hash_node_level",
    "build_levels",
    "rehash_paths",
    "path_scratch",
    "promotion_chain",
    "divergence",
    "divergence_beside",
]


def hash_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """[N, B, 16] int32 padded blocks + [N] int32 valid counts -> [N, 8]."""
    return leaf_digests_cuda(blocks, nblocks)


def hash_ragged(leaves) -> torch.Tensor:
    """A ragged leaf set (``merkle.ragged.RaggedLeaves``: ``blocks`` [T, 16]
    int32, ``offsets`` [N + 1] int64, the schedule ``order`` and
    ``chained``) -> [N, 8] digests in key order."""
    return leaf_ragged_cuda(leaves.blocks, leaves.offsets, leaves.order, leaves.chained)


def hash_node_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[P, 8] x [P, 8] digests -> [P, 8] parent digests."""
    return node_pairs_cuda(left, right)


def hash_node_level(cur: torch.Tensor) -> torch.Tensor:
    """[M, 8] tree level -> [M//2, 8] parents of ADJACENT pairs (2i, 2i+1),
    read as one contiguous 16-word message — no even/odd split."""
    return node_level_cuda(cur)


def build_levels(leaves: torch.Tensor) -> list[torch.Tensor]:
    """All tree levels bottom-up from [N, 8] leaf digests, odd promotion
    intact (counterpart of ``build_levels_pallas``): one level-kernel launch
    per level on a CUDA tensor, however narrow, the plain version on a CPU
    tensor. On a padded power-of-two capacity no level is odd."""
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        nxt = node_level_cuda(cur)
        if cur.shape[0] % 2:
            nxt = torch.cat([nxt, cur[-1:]], dim=0)
        levels.append(nxt)
        cur = nxt
    return levels


def rehash_paths(levels: list[torch.Tensor], scratch: torch.Tensor,
                 blocks: torch.Tensor, nblocks: torch.Tensor, pos: np.ndarray) -> None:
    """Hash k changed leaves into the padded ``levels`` at the sorted unique
    host positions ``pos`` and re-hash their parent paths, in place
    (``scratch`` from ``path_scratch``)."""
    path_rehash_cuda(levels, scratch, blocks, nblocks, pos)


def promotion_chain(levels: list[torch.Tensor], n: int) -> torch.Tensor:
    """[L, 8]: the odd-promotion reference tree's last node per level over
    the first n leaves of the padded ``levels``; the last row is the root."""
    return promotion_chain_cuda(levels, n)


def divergence(digests: torch.Tensor, present: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, N, 8] int32 digests + [R, N] bool presence -> ([R, N] bool masks
    of the keys that diverge from replica 0, [R] int32 counts of each row)."""
    return divergence_cuda(digests, present)


def divergence_beside(digests: torch.Tensor, present: torch.Tensor, masks: torch.Tensor,
                      counts: torch.Tensor) -> None:
    """The same diff of CUDA tensors into ``masks`` and zeroed ``counts``, on
    the current stream in the kernel's co-resident shape: for the
    anti-entropy step, which runs it on a side stream beside the leaf hash
    (``merkle.torch_engine.DiffBeside``)."""
    divergence_beside_cuda(digests, present, masks, counts)
