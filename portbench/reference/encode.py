"""The MerkleKV leaf message, packed into SHA-256 blocks on the device.

leaf(k, v) = SHA256(u32_be(len k) || k || u32_be(len v) || v), the message
padded as FIPS 180-4 says: a 0x80 byte, zeros, and the bit length as a
64-bit big-endian number in the last 8 bytes of the last block.
"""

from __future__ import annotations

import torch


def blocks_per_leaf(key_bytes: int, value_bytes: int) -> int:
    return (8 + key_bytes + value_bytes + 9 + 63) // 64


def _be(value: int, width: int) -> list[int]:
    return [(value >> (8 * (width - 1 - i))) & 0xFF for i in range(width)]


def pack_records(keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[N, KL] and [N, VL] uint8 -> [N, B, 16] int32 padded blocks (big-endian
    words), every row of the same lengths."""
    n, kl = keys.shape
    vl = values.shape[1]
    mlen = 8 + kl + vl
    nblk = blocks_per_leaf(kl, vl)
    buf = torch.zeros((n, nblk * 64), dtype=torch.uint8, device=keys.device)
    buf[:, 0:4] = torch.tensor(_be(kl, 4), dtype=torch.uint8, device=keys.device)
    buf[:, 4:4 + kl] = keys
    buf[:, 4 + kl:8 + kl] = torch.tensor(_be(vl, 4), dtype=torch.uint8, device=keys.device)
    buf[:, 8 + kl:mlen] = values
    buf[:, mlen] = 0x80
    buf[:, -8:] = torch.tensor(_be(mlen * 8, 8), dtype=torch.uint8, device=keys.device)
    b = buf.view(n, nblk * 16, 4).to(torch.int32)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return words.view(n, nblk, 16)
