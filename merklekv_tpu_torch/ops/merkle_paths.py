"""The serving tree's path rehash and promotion chain: the plain versions and
the CUDA wrappers.

Counterpart of two device programs of ``merklekv_tpu/merkle/incremental.py``:
``_scatter_hash_fn`` (leaf hashing + scatter + re-hash of the touched parent
paths, one program per value batch) and ``_ref_root_fn`` (the promotion-chain
walk to the odd-promotion reference root). Both ran ``_node_kernel``
(``merklekv_tpu/ops/sha256_pallas.py:250``) level by level; on the card each
is one hand-written kernel in ``csrc/merkle_paths.cu``, whose note says what
bounds it and what its design does about that.

The wrappers (``path_rehash_cuda``, ``promotion_chain_cuda``) keep the
contract of ``ops/cuda_lib.py``; ``PATH_KS[k]`` counts the path-rehash
launches of k positions beside ``LAUNCHES["path_rehash"]`` (never reset: a
reader takes the difference of two copies).

The path-rehash kernel cuts a batch into chunks of about ``PATH_WIDTH``
sorted positions, one thread block each, and finishes the tree from the
level that is at most ``PATH_TOP_NODES`` nodes wide in the last block to
arrive (``csrc/merkle_paths.cuh``); its scratch (``path_scratch``) holds the
arrival counter, a bitmap and the cuts, zero between launches.

Tree layout: ``levels[l]`` is the capacity-padded level l, ``[C >> l, 8]``
int32 words, ``C`` a power of two; ``levels[-1]`` is the ``[1, 8]`` root.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from merklekv_tpu_torch.merkle.cpu import ref_level_sizes
from merklekv_tpu_torch.ops.cuda_lib import PATH_GROUP, MkvLevels, check_cuda, is_cpu, launch
from merklekv_tpu_torch.ops.sha256 import sha256_blocks, sha256_node_pairs

__all__ = [
    "PATH_WIDTH",
    "PATH_TOP_NODES",
    "PATH_KS",
    "path_scratch",
    "path_rehash",
    "promotion_chain",
    "path_rehash_cuda",
    "promotion_chain_cuda",
    "hash_chain",
    "hash_chain_cuda",
]


# The path-rehash kernel's chunk width (even, 2..64: a chunk spans up to 2W
# entries of a 128-thread block) and the width of its top level (<= 128).
# Smaller values only make the kernel cut small trees into many chunks.
PATH_WIDTH = 64
PATH_TOP_NODES = 128

# Launches of the path-rehash kernel by batch size k.
PATH_KS: collections.Counter = collections.Counter()

# ------------------------------------------------------------ plain versions

def path_rehash(levels: list[torch.Tensor], blocks: torch.Tensor,
                nblocks: torch.Tensor, pos: np.ndarray) -> None:
    """The plain version of the fused kernel: hash the k leaves, scatter
    them into ``levels[0]`` at ``pos`` and re-hash the touched parents IN
    PLACE, one level at a time (the JAX package's ``_scatter_levels``).
    Parents shared by several entries are hashed once per entry, from
    identical children."""
    idx = torch.from_numpy(np.asarray(pos, np.int64)).to(levels[0].device)
    levels[0].index_put_((idx,), sha256_blocks(blocks, nblocks))
    for lvl in range(1, len(levels)):
        idx = idx // 2
        below = levels[lvl - 1]
        levels[lvl].index_put_((idx,), sha256_node_pairs(below[2 * idx], below[2 * idx + 1]))


def hash_chain(inp: torch.Tensor, d: int, nblk: int = 0) -> torch.Tensor:
    """The plain version of the measurement microkernel: [32, 16] int32
    rows (x, y) -> [32, 8]; x starts as the digest of a leaf of nblk blocks,
    each the whole row (the row's x when nblk is 0), then x <- H(x || y)
    d times per row."""
    x, y = inp[:, :8], inp[:, 8:]
    if nblk:
        x = sha256_blocks(inp[:, None, :].repeat(1, nblk, 1),
                          torch.full((inp.shape[0],), nblk, dtype=torch.int32,
                                     device=inp.device))
    for _ in range(d):
        x = sha256_node_pairs(x, y)
    return x


def promotion_chain(levels: list[torch.Tensor], n: int) -> torch.Tensor:
    """[len(ref_level_sizes(n)), 8]: the odd-promotion reference tree's LAST
    node at every level over the first n leaves, from the padded levels. The
    padded tree hashes zero sentinels into its right spine, so only this one
    position per level can differ between the two trees: an even reference
    size m combines position m-2 (identical in both) with the carried last
    node; an odd size promotes it unchanged. The last row is the root."""
    last = levels[0][n - 1 : n]
    rows = [last]
    m = n
    for lvl in range(1, len(ref_level_sizes(n))):
        if m % 2 == 0:
            last = sha256_node_pairs(levels[lvl - 1][m - 2 : m - 1], last)
        rows.append(last)
        m = (m + 1) // 2
    return torch.cat(rows)


# ------------------------------------------------------------ CUDA wrappers

def _capacity(levels: list[torch.Tensor]) -> int:
    c = int(levels[0].shape[0]) if levels else 0
    if c < 2 or c & (c - 1) or len(levels) != c.bit_length():
        raise ValueError(f"{len(levels)} levels over {c} leaves is not a padded tree")
    if len(levels) > MkvLevels.MAX_LEVELS or c > 1 << 31:
        raise ValueError(f"capacity {c} is beyond the kernels' int32 positions")
    return c


def _levels_struct(levels: list[torch.Tensor], dev: torch.device) -> MkvLevels:
    c = int(levels[0].shape[0])
    st = MkvLevels()
    for lvl, t in enumerate(levels):
        check_cuda(t, f"levels[{lvl}]", 2, 8, dev)
        if t.shape[0] != c >> lvl:
            raise ValueError(f"levels[{lvl}] has {t.shape[0]} rows, expected {c >> lvl}")
        st.rows[lvl] = t.data_ptr()
    st.depth = len(levels)
    return st


def _scratch_words(k: int) -> int:
    """The kernel's scratch for k positions: its counters, bitmap and cuts."""
    g = -(-k // PATH_WIDTH)
    return 2 * g + 3 + -(-g // PATH_GROUP)


def path_scratch(capacity: int, device) -> torch.Tensor:
    """Zeroed scratch for ``path_rehash_cuda`` on any batch of a tree of
    ``capacity`` leaves."""
    return torch.zeros(_scratch_words(capacity), dtype=torch.int32, device=device)


def _path_top(capacity: int) -> int:
    """The kernel's top level: the lowest level at most PATH_TOP_NODES wide,
    and at least level 1."""
    return max(1, capacity.bit_length() - PATH_TOP_NODES.bit_length())


def path_rehash_cuda(levels: list[torch.Tensor], scratch: torch.Tensor,
                     blocks: torch.Tensor, nblocks: torch.Tensor,
                     pos: np.ndarray) -> None:
    """Hash k changed leaves ([k, B, 16] int32 blocks, [k] int32 block
    counts) into ``levels`` at the host positions ``pos`` [k] (sorted,
    unique), and re-hash every touched parent, in place: one launch of the
    path-rehash kernel. ``scratch`` (``path_scratch``) is the kernel's
    int32 scratch, zero on entry and left zero (unused on the CPU)."""
    pos = np.asarray(pos)
    k = len(pos)
    c = _capacity(levels)
    if pos.ndim != 1 or not np.issubdtype(pos.dtype, np.integer):
        raise TypeError(f"positions must be a 1-D integer array, got {pos.dtype} {pos.shape}")
    if k and not np.all(np.diff(pos) > 0):
        raise ValueError("positions must be sorted and unique")
    if k and (pos[0] < 0 or pos[-1] >= c):
        raise ValueError(f"positions [{pos[0]}, {pos[-1]}] outside capacity {c}")
    if blocks.shape[0] != k or nblocks.shape[0] != k:
        raise ValueError(f"{blocks.shape[0]} blocks, {nblocks.shape[0]} counts, {k} positions")
    if is_cpu(levels[0], blocks, nblocks):
        if k:
            path_rehash(levels, blocks, nblocks, pos)
        return
    dev = levels[0].device
    st = _levels_struct(levels, dev)
    check_cuda(blocks, "blocks", 3, 16, dev)
    check_cuda(nblocks, "nblocks", 1, None, dev)
    check_cuda(scratch, "scratch", 1, None, dev)
    if scratch.shape[0] < _scratch_words(k):
        raise ValueError(f"scratch has {scratch.shape[0]} words, too few for {k} positions")
    if k == 0:
        return
    pos_t = torch.from_numpy(pos.astype(np.int32)).to(dev)
    launch("mkv_path_rehash", dev, st, blocks.data_ptr(), nblocks.data_ptr(), pos_t.data_ptr(),
           k, blocks.shape[1], PATH_WIDTH, _path_top(c), scratch.data_ptr())
    PATH_KS[k] += 1


def promotion_chain_cuda(levels: list[torch.Tensor], n: int) -> torch.Tensor:
    """[len(ref_level_sizes(n)), 8] int32: the reference tree's last node per
    level over the first n (1 <= n <= C) leaves, in one launch."""
    c = _capacity(levels)
    if not 1 <= n <= c:
        raise ValueError(f"live count {n} outside [1, {c}]")
    if is_cpu(levels[0]):
        return promotion_chain(levels, n)
    dev = levels[0].device
    st = _levels_struct(levels, dev)
    nlev = len(ref_level_sizes(n))
    out = torch.empty((nlev, 8), dtype=torch.int32, device=dev)
    launch("mkv_promotion_chain", dev, st, n, nlev, out.data_ptr())
    return out


def hash_chain_cuda(inp: torch.Tensor, d: int, nblk: int = 0) -> tuple[torch.Tensor, int, int]:
    """Measurement only, never on a serving path: one warp hashes a leaf of
    nblk blocks and then a dependent chain of d node hashes in registers
    (``hash_chain_kernel``, the unrolled node hash). Takes [32, 16] int32
    rows (x, y) on a CUDA device; returns the [32, 8] results
    (== ``hash_chain``), the SM clock cycles and the nanoseconds of the
    chain. Synchronises."""
    dev = inp.device
    check_cuda(inp, "inp", 2, 16, dev)
    if inp.shape[0] != 32 or d < 0 or nblk < 0:
        raise ValueError(f"expected [32, 16] rows, d >= 0 and nblk >= 0, got "
                         f"{tuple(inp.shape)}, d={d}, nblk={nblk}")
    out = torch.empty((32, 8), dtype=torch.int32, device=dev)
    timing = torch.zeros(2, dtype=torch.int64, device=dev)
    launch("mkv_hash_chain", dev, inp.data_ptr(), nblk, d, out.data_ptr(), timing.data_ptr())
    cycles, ns = timing.tolist()
    return out, int(cycles), int(ns)
