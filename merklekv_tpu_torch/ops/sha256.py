"""Batched SHA-256 in plain PyTorch: the CPU path and the kernels' oracle.

Counterpart of ``merklekv_tpu/ops/sha256.py``. These functions are the
plain versions of the three CUDA kernels in ``ops/sha256_cuda.py``: the
wrappers there run them for tensors that lie on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card, bit for bit.

Formulation notes:
- Words are ``int32`` tensors carrying the uint32 bit patterns. ``+`` wraps
  mod 2^32 as SHA-256 needs; ``>>`` on ``int32`` sign-extends, so every
  logical shift is written ``(x >> n) & ((1 << (32 - n)) - 1)``. A shift
  written without the mask is wrong only on words with the top bit set,
  which is why the tests hash random bytes, not only ASCII.
- Batches are the leading axis; the 64 rounds and the block axis are Python
  loops over whole-batch elementwise ops (there is no ``lax.scan`` here).
  The message schedule is a rolling 16-word window, as in the kernels.
- The second compression of a 64-byte node message runs over the constant
  padding block, whose per-round ``K[t] + W[t]`` sums are folded once on the
  host (``_const_kw``) — the same fold the CUDA kernels keep in constant
  memory.

The bit-level spec matches FIPS 180-4; tests compare against ``hashlib`` and
against the JAX package on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "sha256_blocks",
    "sha256_ragged",
    "sha256_node_pairs",
    "sha256_node_level",
    "sha256_single_block",
    "digest_to_bytes",
    "digests_to_bytes",
    "bytes_to_digest",
]

# fmt: off
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_IV = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)
# fmt: on

# Constant second block for a 64-byte message: 0x80 marker word, zeros, then
# the 64-bit big-endian bit length (512 = 0x200) in the last word.
_NODE_PAD_BLOCK = np.zeros(16, dtype=np.uint32)
_NODE_PAD_BLOCK[0] = 0x80000000
_NODE_PAD_BLOCK[15] = 512

_MASK32 = 0xFFFFFFFF


def _s32(x: int) -> int:
    """uint32 value -> the int32 with the same bits (a Python int that an
    int32 tensor op accepts without overflow)."""
    x = int(x) & _MASK32
    return x - (1 << 32) if x >= (1 << 31) else x


def _const_kw(block16) -> list[int]:
    """K[t] + W[t] (mod 2^32) for all 64 rounds of a CONSTANT message block.

    The schedule of a known block is data, so it is expanded once here and
    folded into the round constant: the node hash's second compression then
    needs no schedule and one add less per round."""

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & _MASK32

    sched = [int(x) & _MASK32 for x in block16]
    for t in range(16, 64):
        wm15, wm7, wm2, wm16 = sched[t - 15], sched[t - 7], sched[t - 2], sched[t - 16]
        s0 = rotr(wm15, 7) ^ rotr(wm15, 18) ^ (wm15 >> 3)
        s1 = rotr(wm2, 17) ^ rotr(wm2, 19) ^ (wm2 >> 10)
        sched.append((wm16 + s0 + wm7 + s1) & _MASK32)
    return [(int(_K[t]) + sched[t]) & _MASK32 for t in range(64)]


_K_S32 = [_s32(k) for k in _K]
_K_INT = [int(k) for k in _K]
_IV_S32 = [_s32(v) for v in _IV]
_NODE_PAD_KW = _const_kw(_NODE_PAD_BLOCK)
_NODE_PAD_KW_S32 = [_s32(v) for v in _NODE_PAD_KW]


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 words."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (32 - n))


def _round(a, b, c, d, e, f, g, h, kw):
    """One SHA-256 round; ``kw`` is K[t] + W[t] (tensor or int)."""
    s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
    ch = (e & f) ^ (~e & g)
    t1 = h + s1 + ch + kw
    s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
    maj = (a & b) ^ (a & c) ^ (b & c)
    return t1 + s0 + maj, a, b, c, d + t1, e, f, g


def _compress(state: list, words: list) -> list:
    """One SHA-256 compression. state: 8 [N] int32 tensors; words: 16 [N]
    int32 tensors (views are fine). Returns the 8 updated state words."""
    w = list(words)  # rolling window: w[t % 16] holds the newest 16 words
    v = tuple(state)
    for t in range(64):
        if t >= 16:
            wm15, wm7, wm2, wm16 = w[(t - 15) % 16], w[(t - 7) % 16], w[(t - 2) % 16], w[t % 16]
            s0 = _rotr(wm15, 7) ^ _rotr(wm15, 18) ^ _shr(wm15, 3)
            s1 = _rotr(wm2, 17) ^ _rotr(wm2, 19) ^ _shr(wm2, 10)
            w[t % 16] = wm16 + s0 + wm7 + s1
        v = _round(*v, w[t % 16] + _K_S32[t])
    return [s + o for s, o in zip(state, v)]


def _compress_const(state: list, kw64: list[int]) -> list:
    """One compression over a CONSTANT block whose K[t] + W[t] are folded."""
    v = tuple(state)
    for t in range(64):
        v = _round(*v, kw64[t])
    return [s + o for s, o in zip(state, v)]


def _iv_state(n: int, device) -> list:
    return [torch.full((n,), iv, dtype=torch.int32, device=device) for iv in _IV_S32]


def _check_words(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {x.dtype}")


def sha256_single_block(block: torch.Tensor) -> torch.Tensor:
    """SHA-256 of messages that fit exactly one padded block.

    block: [N, 16] int32 (already padded). Returns digest [N, 8] int32."""
    _check_words(block, "block")
    state = _iv_state(block.shape[0], block.device)
    return torch.stack(_compress(state, [block[:, i] for i in range(16)]), dim=1)


def sha256_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256 over variable-block-count padded messages.

    blocks:  [N, B, 16] int32 — each message pre-padded (0x80 marker +
             bit-length) into its first ``nblocks[i]`` blocks; trailing
             blocks are ignored.
    nblocks: [N] int32 — valid block count per message. A message with
             ``nblocks == 0`` keeps the IV (callers rely on it).
    Returns: [N, 8] int32 digests.
    """
    _check_words(blocks, "blocks")
    n = blocks.shape[0]
    state = _iv_state(n, blocks.device)
    for b in range(blocks.shape[1]):
        new_state = _compress(state, [blocks[:, b, i] for i in range(16)])
        keep = nblocks > b
        state = [torch.where(keep, ns, s) for ns, s in zip(new_state, state)]
    return torch.stack(state, dim=1)


# Below this many messages still compressing, ``sha256_ragged`` finishes
# them one at a time on Python integers: a step of whole-tensor operations
# over a few rows costs more than their rounds.
_RAGGED_FEW = 32


def sha256_ragged(blocks: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256 over ragged padded messages.

    blocks:  [T, 16] int32 — message i pre-padded into
             ``blocks[offsets[i]:offsets[i + 1]]``.
    offsets: [N + 1] int64, non-decreasing, ``offsets[0] == 0``. A message
             of no blocks keeps the IV.
    Returns: [N, 8] int32 digests in message order.

    The messages run longest first, in lockstep: step b compresses block b
    of every message with more than b blocks (a prefix of that order), the
    same work the ragged kernel does, lane by lane. Once fewer than
    ``_RAGGED_FEW`` are left, each finishes alone on Python integers.
    """
    _check_words(blocks, "blocks")
    n = offsets.shape[0] - 1
    lengths = offsets[1:] - offsets[:-1]
    order = torch.argsort(lengths, descending=True, stable=True)
    starts, lens = offsets[:-1][order], lengths[order]
    state = torch.tensor([_IV_S32] * n, dtype=torch.int32, device=blocks.device).reshape(n, 8)
    b = 0
    while True:
        active = int((lens > b).sum())
        if active < _RAGGED_FEW:
            break
        rows = blocks[starts[:active] + b]
        new = _compress([state[:active, i] for i in range(8)], [rows[:, i] for i in range(16)])
        state[:active] = torch.stack(new, dim=1)
        b += 1
    for j in range(active):
        s = [x & _MASK32 for x in state[j].tolist()]
        lo, hi = int(starts[j]) + b, int(starts[j] + lens[j])
        for w in blocks[lo:hi].tolist():
            s = _compress_int(s, [x & _MASK32 for x in w])
        state[j] = torch.tensor([_s32(x) for x in s], dtype=torch.int32)
    out = torch.empty_like(state)
    out[order] = state
    return out


def _compress_int(state: list[int], block: list[int]) -> list[int]:
    """One compression on Python integers (uint32 values): ``_compress``
    for a single message."""
    m = _MASK32
    w = list(block)
    for t in range(16, 64):
        x15, x2 = w[t - 15], w[t - 2]
        s0 = ((x15 >> 7) | (x15 << 25)) ^ ((x15 >> 18) | (x15 << 14)) ^ (x15 >> 3)
        s1 = ((x2 >> 17) | (x2 << 15)) ^ ((x2 >> 19) | (x2 << 13)) ^ (x2 >> 10)
        w.append((w[t - 16] + (s0 & m) + w[t - 7] + (s1 & m)) & m)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = ((e >> 6) | (e << 26)) ^ ((e >> 11) | (e << 21)) ^ ((e >> 25) | (e << 7))
        t1 = h + (s1 & m) + ((e & f) ^ (~e & g)) + _K_INT[t] + w[t]
        s0 = ((a >> 2) | (a << 30)) ^ ((a >> 13) | (a << 19)) ^ ((a >> 22) | (a << 10))
        t2 = (s0 & m) + ((a & b) ^ (a & c) ^ (b & c))
        a, b, c, d, e, f, g, h = (t1 + t2) & m, a, b, c, (d + t1) & m, e, f, g
    return [(x + y) & m for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _node_hash_words(words: list, n: int, device) -> torch.Tensor:
    state = _compress(_iv_state(n, device), words)
    return torch.stack(_compress_const(state, _NODE_PAD_KW_S32), dim=1)


def sha256_node_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle inner-node hash: SHA256(left_digest || right_digest), batched.

    left, right: [P, 8] int32 digests. Returns [P, 8] int32."""
    _check_words(left, "left")
    _check_words(right, "right")
    words = [left[:, i] for i in range(8)] + [right[:, i] for i in range(8)]
    return _node_hash_words(words, left.shape[0], left.device)


def sha256_node_level(cur: torch.Tensor) -> torch.Tensor:
    """[M, 8] tree level -> [M//2, 8] parents of ADJACENT rows (2p, 2p+1),
    read as one 16-word message. The odd tail (M odd) is the caller's."""
    _check_words(cur, "cur")
    p = cur.shape[0] // 2
    msgs = cur[: 2 * p].reshape(p, 16)
    return _node_hash_words([msgs[:, i] for i in range(16)], p, cur.device)


# ------------------------------------------------------------------ helpers

def digest_to_bytes(digest: np.ndarray) -> bytes:
    """[8] uint32 digest words -> 32 raw bytes (big-endian words)."""
    return np.asarray(digest, dtype=">u4").tobytes()


def digests_to_bytes(digests: np.ndarray) -> list[bytes]:
    """[N, 8] uint32 -> list of 32-byte digests."""
    arr = np.asarray(digests).astype(np.uint32).astype(">u4")
    flat = arr.tobytes()
    return [flat[i * 32 : (i + 1) * 32] for i in range(arr.shape[0])]


def bytes_to_digest(b: bytes) -> np.ndarray:
    """32 raw bytes -> [8] uint32 words."""
    if len(b) != 32:
        raise ValueError("digest must be 32 bytes")
    return np.frombuffer(b, dtype=">u4").astype(np.uint32)
