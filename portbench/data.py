"""Data of the cells, made from the seed on the device in a few large calls.

Records take YCSB's shape (Cooper et al., SoCC 2010): a key is ``user``
followed by a 19-digit number, 23 bytes, and a value is 1,000 printable
bytes (10 fields of 100 bytes, stored as one value). Keys are distinct and
sorted, drawn from the seed. A ``torch.Generator`` on the card gives the same
data for the same seed on every card of one type.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.encode import blocks_per_leaf, pack_records

KEY_PREFIX = b"user"
KEY_DIGITS = 19
# Rows packed per call while the blocks are made: bounds the temporaries.
PACK_ROWS = 1 << 18


def generator(device: torch.device, *parts: int) -> torch.Generator:
    """A generator on ``device`` seeded by the seed and the given parts."""
    seed = 0
    for p in parts:
        seed = (seed * 1_000_003 + int(p)) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


def key_numbers(gen: torch.Generator, n: int, device, lo: int = 0,
                hi: int = (1 << 63) - 1) -> torch.Tensor:
    """``n`` distinct sorted int64 numbers in [lo, hi)."""
    extra = n // 1000 + 64
    while True:
        cand = torch.randint(lo, hi, (n + extra,), generator=gen, device=device,
                             dtype=torch.int64)
        uniq = torch.unique(cand)
        if uniq.numel() >= n:
            break
        extra *= 4
    if uniq.numel() > n:
        keep = torch.randperm(uniq.numel(), generator=gen, device=device)[:n]
        uniq = uniq[torch.sort(keep).values]
    return uniq


def key_bytes(numbers: torch.Tensor) -> torch.Tensor:
    """int64 numbers -> [N, 23] uint8 keys ``user`` + 19 zero-padded digits
    (byte order equals number order)."""
    n = numbers.shape[0]
    out = torch.empty((n, len(KEY_PREFIX) + KEY_DIGITS), dtype=torch.uint8,
                      device=numbers.device)
    out[:, :len(KEY_PREFIX)] = torch.tensor(list(KEY_PREFIX), dtype=torch.uint8,
                                            device=numbers.device)
    x = numbers.clone()
    for j in range(KEY_DIGITS - 1, -1, -1):
        out[:, len(KEY_PREFIX) + j] = (x % 10 + 48).to(torch.uint8)
        x = x // 10
    return out


def values(gen: torch.Generator, n: int, width: int, device) -> torch.Tensor:
    """[N, width] printable ASCII bytes."""
    return torch.randint(32, 127, (n, width), generator=gen, device=device, dtype=torch.uint8)


def ycsb_blocks(gen: torch.Generator, n: int, key_len: int, value_len: int, device,
                lo: int = 0, hi: int = (1 << 63) - 1) -> torch.Tensor:
    """[N, B, 16] int32 packed leaves of ``n`` sorted YCSB-shaped records
    whose key numbers lie in [lo, hi)."""
    if key_len != len(KEY_PREFIX) + KEY_DIGITS:
        raise ValueError(f"YCSB keys are {len(KEY_PREFIX) + KEY_DIGITS} bytes, not {key_len}")
    keys = key_bytes(key_numbers(gen, n, device, lo, hi))
    blocks = torch.empty((n, blocks_per_leaf(key_len, value_len), 16), dtype=torch.int32,
                         device=device)
    for r0 in range(0, n, PACK_ROWS):
        r1 = min(n, r0 + PACK_ROWS)
        blocks[r0:r1] = pack_records(keys[r0:r1], values(gen, r1 - r0, value_len, device))
    return blocks


def split_key_range(shards: int) -> list[tuple[int, int]]:
    """Disjoint ascending key-number ranges, one per shard, so that shard
    s's sorted keys all come before shard s+1's."""
    span = ((1 << 63) - 1) // shards
    return [(s * span, (s + 1) * span) for s in range(shards)]


# --------------------------------------------------------------- divergence

def uniform_divergence(gen: torch.Generator, digests: torch.Tensor, present: torch.Tensor,
                       fraction: float) -> None:
    """In place, every replica r >= 1 diverges at ``fraction`` of the keys,
    drawn at random without repeats: half get bit 0 of digest word r % 8
    flipped, half become absent (the rule of chip_smoke.replica_stacks)."""
    r_count, n = present.shape
    k = int(n * fraction)
    for r in range(1, r_count):
        pos = torch.randperm(n, device=digests.device, generator=gen)[:k]
        flip, gone = pos[: k // 2], pos[k // 2:]
        digests[r, flip, r % 8] ^= 1
        present[r, gone] = False


def zipf_positions(seed: int, replica: int, n: int, k: int, s: float,
                   device) -> torch.Tensor:
    """``k`` distinct key indices of [0, n), Zipf-skewed over the index
    (weights 1/(i+1)^s, Gumbel top-k), seeded by (seed, replica): the rule of
    chip_smoke.diff2d_block."""
    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + replica) % (1 << 63))
    log_w = -s * torch.log1p(torch.arange(n, device=device, dtype=torch.float64))
    u = torch.rand(n, device=device, dtype=torch.float64, generator=gen)
    return torch.topk(log_w - torch.log(-torch.log(u)), k).indices


def zipf_divergence(seed: int, digests: list, present: list, fraction: float,
                    s: float, absent_every: int, device0) -> None:
    """In place over key shards (lists, one [R, L, 8] / [R, L] pair per
    shard in key order): every replica r >= 1 diverges at ``fraction`` of
    all keys, Zipf-skewed over the global key index; every
    ``absent_every``-th drawn key loses its presence, the others get digest
    word r % 8 XORed with 0x5A5A5A5A (the rule of chip_smoke.diff2d_block)."""
    r_count, l = present[0].shape
    n = l * len(present)
    k = int(n * fraction)
    for r in range(1, r_count):
        pos = zipf_positions(seed, r, n, k, s, device0)
        gone = pos[::absent_every]
        for sh, (dig, pres) in enumerate(zip(digests, present)):
            lo = sh * l
            here = pos[(pos >= lo) & (pos < lo + l)] - lo
            off = gone[(gone >= lo) & (gone < lo + l)] - lo
            dig[r, here.to(dig.device), r % 8] ^= 0x5A5A5A5A
            pres[r, off.to(pres.device)] = False


# ------------------------------------------------------------------ streams

def zipf_ranks(rng: np.random.Generator, n_items: int, theta: float, count: int) -> np.ndarray:
    """``count`` draws of item ranks in [0, n_items), P(rank i) ~ 1/(i+1)^theta
    (YCSB's zipfian constant 0.99), by inverse CDF."""
    w = 1.0 / np.power(np.arange(1, n_items + 1, dtype=np.float64), theta)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(count), side="right"), n_items - 1)


def exponential_gaps(rng: np.random.Generator, count: int, total_s: float) -> np.ndarray:
    """``count`` gaps that sum to ``total_s``: the quantiles of an
    exponential distribution of mean total_s / count, in an order drawn
    from ``rng``. Every seed gets the same gaps, so the same arrivals, in
    another order."""
    q = (np.arange(count, dtype=np.float64) + 0.5) / count
    gaps = -np.log1p(-q)
    gaps *= total_s / gaps.sum()
    return rng.permutation(gaps)
