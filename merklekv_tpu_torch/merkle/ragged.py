"""Ragged leaf sets: every leaf's padded SHA-256 blocks back to back.

``merkle/packing.py`` (a copy held to its JAX source) pads every leaf of a
batch to the batch's longest, as ``[N, B, 16]``. Where record sizes vary
widely, as in Facebook's memcached ETC pool (Atikoglu et al., SIGMETRICS
2012: values from empty to hundreds of KB), that padding multiplies the
bytes by orders of magnitude. A ragged set keeps each leaf at its own block
count:

- ``blocks`` [T, 16] int32 big-endian words: leaf i's padded message at
  ``blocks[offsets[i]:offsets[i + 1]]``, the leaves in key order;
- ``offsets`` [N + 1] int64;
- the schedule the ragged leaf kernel reads (``csrc/ragged_leaves.cu``):
  ``order`` [N] int32, the leaves by block count, longest first (ties in
  key order), so that the 32 lanes of a warp take 32 neighbours of that
  order, and ``chained``, how many leading positions of it run each on an
  SM sub-partition of its own;
- what one hash of the set costs, for the engine's counters:
  ``total_blocks`` (T, the compressions queued) and ``lane_slots`` (32 times
  the sum, over the warps of 32 neighbours of ``order``, of the block count
  of the warp's longest leaf); their ratio is the lane fill.

The message is ``packing.py``'s: u32_be(len k) || k || u32_be(len v) || v,
padded as FIPS 180-4 says. A set derives its schedule once, when it is
made, on the device its tensors lie on, from the block counts alone. So a
change of words that changes no length (a salt, a value rewritten at the
same size) leaves the set valid; a record whose length changes needs a new
set: the node packs its records again.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from merklekv_tpu_torch.ops.sha256_cuda import ragged_shape

__all__ = ["RaggedLeaves", "pack_ragged", "chained_groups"]


def pack_ragged(keys: Sequence[bytes], values: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pack N (key, value) leaves on the host, each to its own block count:
    ([T, 16] uint32 big-endian words, [N + 1] int64 offsets). Vectorized as
    ``packing.pack_leaves`` is, with no padding to the longest leaf."""
    n = len(keys)
    if n != len(values):
        raise ValueError("keys and values must have equal length")
    klens = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    vlens = np.fromiter((len(v) for v in values), dtype=np.int64, count=n)
    mlens = 8 + klens + vlens
    nblocks = (mlens + 9 + 63) // 64  # 0x80 marker + 8-byte bit length
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nblocks, out=offsets[1:])
    out = np.zeros(int(offsets[-1]) * 64, dtype=np.uint8)
    starts = offsets[:-1] * 64
    _put_be(out, starts, klens, 4)
    _put_bytes(out, starts + 4, keys, klens)
    _put_be(out, starts + 4 + klens, vlens, 4)
    _put_bytes(out, starts + 8 + klens, values, vlens)
    out[starts + mlens] = 0x80
    _put_be(out, starts + nblocks * 64 - 8, mlens * 8, 8)
    return out.view(">u4").astype(np.uint32).reshape(-1, 16), offsets


def _put_be(out: np.ndarray, at: np.ndarray, values: np.ndarray, width: int) -> None:
    """Write each of ``values`` as a ``width``-byte big-endian number at ``at``."""
    be = values.astype(">u4" if width == 4 else ">u8").view(np.uint8).reshape(-1, width)
    for c in range(width):
        out[at + c] = be[:, c]


def _put_bytes(out: np.ndarray, at: np.ndarray, items: Sequence[bytes], lens: np.ndarray) -> None:
    """Write item i's bytes at ``at[i]``, all in one scatter."""
    total = int(lens.sum())
    if not total:
        return
    flat = np.frombuffer(b"".join(items), dtype=np.uint8)
    first = np.concatenate(([0], np.cumsum(lens)[:-1]))
    out[np.repeat(at - first, lens) + np.arange(total, dtype=np.int64)] = flat


def chained_groups(group_max: torch.Tensor, sms: int, warps: int) -> int:
    """How many leading groups of 32 leaves (``group_max``: each group's
    longest block count, longest first) run each on an SM sub-partition
    (SMSP) of its own. In the bulk kernel a warp shares its SMSP with as many
    others as the card holds (``warps`` an SMSP) or the launch has, whichever
    is fewer, and runs about that many times slower than alone, so a group
    of length L ends at about L times that share; the bulk ends at about the
    sum of all groups' lengths over the card's 4 x ``sms`` SMSPs. A group
    that would end no earlier than the bulk is a chain: alone on its SMSP, it
    also keeps its next blocks' loads in flight. Chains hold at most one SM
    in eight (4 warps an SM); the rest, longest first, lead the bulk."""
    groups = group_max.shape[0]
    share = min(4 * sms * warps, groups)
    count = int((group_max * share >= group_max.sum()).sum()) if groups else 0
    return min(count, 4 * max(1, sms // 8))


class RaggedLeaves:
    """A ragged leaf set on one device (see the module's note).

    Made from ``blocks`` [T, 16] int32 and ``offsets`` [N + 1] int64 that lie
    on one device, which it keeps (no copy) and never writes; it derives
    its schedule there, with a few small reads back to the host. On
    a card ``chained`` follows :func:`chained_groups` with the card's SMs
    and the ragged kernel's resident warps; elsewhere it is 0.
    """

    __slots__ = ("blocks", "offsets", "order", "chained", "total_blocks", "lane_slots",
                 "longest")

    def __init__(self, blocks: torch.Tensor, offsets: torch.Tensor) -> None:
        if blocks.device != offsets.device:
            raise ValueError(f"blocks on {blocks.device}, offsets on {offsets.device}")
        if blocks.dim() != 2 or blocks.shape[1] != 16 or blocks.dtype != torch.int32:
            raise ValueError(f"blocks must be [T, 16] int32: {tuple(blocks.shape)} {blocks.dtype}")
        if offsets.dim() != 1 or offsets.shape[0] < 1 or offsets.dtype != torch.int64:
            raise ValueError(f"offsets must be [N + 1] int64: {tuple(offsets.shape)} "
                             f"{offsets.dtype}")
        self.blocks, self.offsets = blocks, offsets
        lengths = offsets[1:] - offsets[:-1]
        self.order = torch.argsort(lengths, descending=True, stable=True).to(torch.int32)
        group_max = lengths[self.order[::32].long()]
        self.total_blocks, self.lane_slots, self.longest = torch.stack(
            [offsets[-1] - offsets[0], 32 * group_max.sum(), group_max[:1].sum()]).tolist()
        self.chained = 0
        if blocks.device.type == "cuda" and self.n:
            sms, warps = ragged_shape(blocks.device)
            self.chained = min(32 * chained_groups(group_max, sms, warps), self.n)

    @classmethod
    def pack(cls, keys: Sequence[bytes], values: Sequence[bytes], device) -> "RaggedLeaves":
        """Pack (key, value) leaves on the host (:func:`pack_ragged`) and
        make the set on ``device``."""
        words, offsets = pack_ragged(keys, values)
        return cls(torch.from_numpy(words.view(np.int32)).to(device),
                   torch.from_numpy(offsets).to(device))

    @property
    def n(self) -> int:
        return self.order.shape[0]
