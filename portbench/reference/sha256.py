"""SHA-256 in plain PyTorch, the benchmark's own (FIPS 180-4).

Words travel as int32 tensors holding the uint32 bit patterns: ``+`` wraps
mod 2^32, and every logical right shift masks off the sign extension. Rows
are hashed in chunks of ``CHUNK`` so that the temporaries of one
compression stay small beside the cell's state on the card. Nothing here
comes from the program under test; the tests hold it to ``hashlib``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# fmt: off
K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)
IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
# fmt: on

# Rows per chunk: one compression's temporaries are about 40 words a row
# (2.7 GB at 2^24 rows); fewer, larger launches keep the card busy.
CHUNK = 1 << 24
# Below this many nodes a tree level is hashed on the host with hashlib:
# there, launches would cost more than the hashing.
HOST_LEVEL = 1 << 12


def signed(x: int) -> int:
    """uint32 -> the int32 with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


_K = [signed(k) for k in K]
_IV = [signed(v) for v in IV]
# The second block of a 64-byte message: the 0x80 marker, then the bit
# length 512 in the last word.
_PAD64 = [signed(0x80000000)] + [0] * 14 + [512]


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) & ((1 << (32 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (32 - n))


def compress(state: list, w: list) -> list:
    """One compression: ``state`` 8 and ``w`` 16 [R] int32 tensors (an int
    stands for a word that is the same in every row)."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t >= 16:
            x15, x2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ _shr(x15, 3) if torch.is_tensor(x15) \
                else signed(_rotr_int(x15, 7) ^ _rotr_int(x15, 18) ^ ((x15 & 0xFFFFFFFF) >> 3))
            s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ _shr(x2, 10) if torch.is_tensor(x2) \
                else signed(_rotr_int(x2, 17) ^ _rotr_int(x2, 19) ^ ((x2 & 0xFFFFFFFF) >> 10))
            w[t % 16] = _add(w[t % 16], s0, w[(t - 7) % 16], s1)
        t1 = h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ (~e & g)) \
            + _add(_K[t], w[t % 16])
        t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))
        a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
    return [x + y for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _rotr_int(x: int, n: int) -> int:
    x &= 0xFFFFFFFF
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def _add(*xs):
    """Sum of words; ints fold into one int32 constant."""
    consts = [x for x in xs if not torch.is_tensor(x)]
    tensors = [x for x in xs if torch.is_tensor(x)]
    c = signed(sum(x & 0xFFFFFFFF for x in consts)) if consts else 0
    if not tensors:
        return c
    out = tensors[0]
    for t in tensors[1:]:
        out = out + t
    return out + c if c else out


def _iv(rows: int, device) -> list:
    return [torch.full((rows,), v, dtype=torch.int32, device=device) for v in _IV]


def hash_blocks(blocks: torch.Tensor, nblocks: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """[N, B, 16] int32 padded blocks, [N] valid counts -> [N, 8] digests."""
    n = blocks.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=blocks.device)
    for lo in range(0, n, chunk):
        blk, nb = blocks[lo:lo + chunk], nblocks[lo:lo + chunk]
        state = _iv(blk.shape[0], blk.device)
        for b in range(blk.shape[1]):
            new = compress(state, [blk[:, b, i] for i in range(16)])
            keep = nb > b
            state = [torch.where(keep, x, y) for x, y in zip(new, state)]
        out[lo:lo + chunk] = torch.stack(state, dim=1)
    return out


def node_hash(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """SHA256(left || right) of [P, 8] digest rows -> [P, 8]."""
    p = left.shape[0]
    if p < HOST_LEVEL:
        return _node_hash_host(left, right)
    out = torch.empty((p, 8), dtype=torch.int32, device=left.device)
    for lo in range(0, p, CHUNK):
        l, r = left[lo:lo + CHUNK], right[lo:lo + CHUNK]
        words = [l[:, i] for i in range(8)] + [r[:, i] for i in range(8)]
        state = compress(_iv(l.shape[0], l.device), words)
        out[lo:lo + CHUNK] = torch.stack(compress(state, _PAD64), dim=1)
    return out


def _node_hash_host(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    lb = left.cpu().numpy().astype(">i4").tobytes()
    rb = right.cpu().numpy().astype(">i4").tobytes()
    digs = b"".join(hashlib.sha256(lb[i:i + 32] + rb[i:i + 32]).digest()
                    for i in range(0, len(lb), 32))
    arr = np.frombuffer(digs, dtype=">i4").astype(np.int32).reshape(-1, 8)
    return torch.from_numpy(arr).to(left.device)


def digest_hex(words: torch.Tensor) -> str:
    """[8] int32 digest -> 64 hex digits."""
    return words.cpu().numpy().astype(">i4").tobytes().hex()
