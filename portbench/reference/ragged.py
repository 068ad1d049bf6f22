"""Ragged MerkleKV leaves, packed and hashed plainly: the benchmark's own.

A leaf's message is u32_be(len k) || k || u32_be(len v) || v, padded as
FIPS 180-4 says (``encode.py``). A ragged set lays every leaf's padded
blocks back to back in key order: leaf i's at ``offsets[i]:offsets[i + 1]``
of a [T, 16] int32 tensor of big-endian words, with no padding to the
longest leaf. Nothing here comes from the program under test; the tests
hold it to ``hashlib``.

- :func:`pack` writes the set from flat key and value bytes, a run of
  leaves at a time, on their device;
- :func:`hash_ragged` hashes it: leaves of up to ``LOCKSTEP`` blocks in
  lockstep, longest first (step b compresses block b of every leaf longer
  than b, with ``sha256.compress``), longer ones on the host with
  ``hashlib`` from the message their blocks hold;
- :func:`work` counts what one hash of a set needs, for a roofline.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from portbench import roofline
from portbench.reference import sha256 as ref_sha

# Bytes of blocks written per step of ``pack``: bounds its temporaries
# (about 10 bytes of index a byte).
PACK_BYTES = 1 << 27
# Leaves of more blocks than this are hashed with hashlib on the host.
LOCKSTEP = 64


def block_counts(key_lens: torch.Tensor, value_lens: torch.Tensor) -> torch.Tensor:
    """int64 blocks of each leaf's padded message."""
    return (8 + key_lens + value_lens + 9 + 63) // 64


def offsets_of(key_lens: torch.Tensor, value_lens: torch.Tensor) -> torch.Tensor:
    """[N + 1] int64 offsets of each leaf's first block."""
    counts = block_counts(key_lens.long(), value_lens.long())
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def _be(values: torch.Tensor, width: int) -> list[torch.Tensor]:
    """The ``width`` big-endian bytes of int64 ``values``, most significant
    first."""
    return [((values >> (8 * (width - 1 - c))) & 0xFF).to(torch.uint8) for c in range(width)]


def _spread(at: torch.Tensor, lens: torch.Tensor, total: int) -> torch.Tensor:
    """Destinations of ``total`` bytes laid out as runs of ``lens`` from
    each ``at``."""
    first = torch.cumsum(lens, 0) - lens
    return torch.repeat_interleave(at - first, lens, output_size=total) + torch.arange(
        total, device=at.device)


def pack(keys: torch.Tensor, key_lens: torch.Tensor, values: torch.Tensor,
         value_lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat uint8 ``keys`` and ``values`` (record i's at the prefix sums of
    ``key_lens`` and ``value_lens``, int64 [N]) -> (blocks [T, 16] int32,
    offsets [N + 1] int64), on their device."""
    dev = keys.device
    key_lens, value_lens = key_lens.long(), value_lens.long()
    offsets = offsets_of(key_lens, value_lens)
    n = key_lens.shape[0]
    blocks = torch.empty((int(offsets[-1]), 16), dtype=torch.int32, device=dev)
    key_at = torch.cumsum(key_lens, 0) - key_lens
    value_at = torch.cumsum(value_lens, 0) - value_lens
    host = offsets.cpu().numpy()
    r0 = 0
    while r0 < n:
        r1 = max(r0 + 1, int(np.searchsorted(host, host[r0] + PACK_BYTES // 64, side="right")) - 1)
        r1 = min(r1, n)
        lo, hi = int(host[r0]), int(host[r1])
        buf = torch.zeros((hi - lo) * 64, dtype=torch.uint8, device=dev)
        start = (offsets[r0:r1] - lo) * 64
        kl, vl = key_lens[r0:r1], value_lens[r0:r1]
        mlen = 8 + kl + vl
        for c, byte in enumerate(_be(kl, 4)):
            buf[start + c] = byte
        nk, nv = int(kl.sum()), int(vl.sum())
        if nk:
            k0 = int(key_at[r0])
            buf[_spread(start + 4, kl, nk)] = keys[k0:k0 + nk]
        for c, byte in enumerate(_be(vl, 4)):
            buf[start + 4 + kl + c] = byte
        if nv:
            v0 = int(value_at[r0])
            buf[_spread(start + 8 + kl, vl, nv)] = values[v0:v0 + nv]
        buf[start + mlen] = 0x80
        end = start + block_counts(kl, vl) * 64
        for c, byte in enumerate(_be(mlen * 8, 8)):
            buf[end - 8 + c] = byte
        b = buf.view(-1, 4).to(torch.int32)
        blocks[lo:hi] = ((b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]).view(-1, 16)
        del buf, b
        r0 = r1
    return blocks, offsets


def hash_ragged(blocks: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 leaf digests, in key order, of a ragged set."""
    n = offsets.shape[0] - 1
    lengths = offsets[1:] - offsets[:-1]
    out = torch.empty((n, 8), dtype=torch.int32, device=blocks.device)
    short = torch.nonzero(lengths <= LOCKSTEP).flatten()
    order = short[torch.argsort(lengths[short], descending=True, stable=True)]
    starts, lens = offsets[:-1][order], lengths[order]
    # The leaves with more than b blocks, for each step b: a prefix of the order.
    active = torch.searchsorted(-lens, -torch.arange(LOCKSTEP, device=lens.device),
                                side="left").tolist()
    state = torch.stack(ref_sha._iv(order.shape[0], blocks.device), dim=1)
    for b, a in enumerate(active):
        if a == 0:
            break
        rows = blocks[starts[:a] + b]
        new = ref_sha.compress([state[:a, i] for i in range(8)], [rows[:, i] for i in range(16)])
        state[:a] = torch.stack(new, dim=1)
        del rows, new
    out[order] = state
    long_ = torch.nonzero(lengths > LOCKSTEP).flatten()
    if long_.numel():
        out[long_] = _hash_on_host(blocks, offsets[long_], lengths[long_]).to(blocks.device)
    return out


def _hash_on_host(blocks: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """hashlib's SHA-256 of each leaf's message, read back from its blocks:
    the bit length in its last 8 bytes says where the message ends."""
    idx = torch.repeat_interleave(starts - (torch.cumsum(lens, 0) - lens), lens) + torch.arange(
        int(lens.sum()), device=starts.device)
    raw = blocks[idx].cpu().numpy().astype(">i4").tobytes()
    digests = []
    pos = 0
    for count in lens.tolist():
        leaf = raw[pos:pos + 64 * count]
        pos += 64 * count
        digests.append(hashlib.sha256(leaf[:int.from_bytes(leaf[-8:], "big") // 8]).digest())
    words = np.frombuffer(b"".join(digests), dtype=">i4").astype(np.int32).reshape(-1, 8)
    return torch.from_numpy(words)


def work(n_leaves: int, total_blocks: int) -> dict:
    """One hash of a ragged set of ``n_leaves`` leaves and ``total_blocks``
    blocks: every block read once (64 B), the offsets read once (8 B each of
    N + 1), one 32-byte digest written a leaf; one compression a block. In
    the units of ``roofline.bound_s``."""
    return {"bytes": 64 * total_blocks + 8 * (n_leaves + 1) + 32 * n_leaves,
            "logic": total_blocks * roofline.LOGIC_MSG_BLOCK,
            "adds": total_blocks * roofline.ADDS_MSG_BLOCK}
