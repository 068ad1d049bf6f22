"""The data and the streams are fixed by the seed."""

import hashlib
import struct

import numpy as np
import pytest
import torch

from portbench import data

CPU = torch.device("cpu")


def test_keys_are_distinct_sorted_ycsb_shaped():
    nums = data.key_numbers(data.generator(CPU, 5), 5000, CPU)
    keys = data.key_bytes(nums)
    assert keys.shape == (5000, 23)
    raw = [bytes(row) for row in keys.numpy()]
    assert raw == sorted(raw) and len(set(raw)) == len(raw)
    assert all(k.startswith(b"user") and k[4:].isdigit() for k in raw)
    assert int(raw[-1][4:]) == int(nums[-1])


def test_split_ranges_keep_shards_in_key_order():
    ranges = data.split_key_range(4)
    parts = [data.key_bytes(data.key_numbers(data.generator(CPU, 1, s), 100, CPU, *ranges[s]))
             for s in range(4)]
    raw = [bytes(r) for p in parts for r in p.numpy()]
    assert raw == sorted(raw)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 4_000_000_123])
def test_blocks_hash_as_the_records(seed):
    blocks = data.ycsb_blocks(data.generator(CPU, seed), 50, 23, 1000, CPU)
    again = data.ycsb_blocks(data.generator(CPU, seed), 50, 23, 1000, CPU)
    assert torch.equal(blocks, again)
    other = data.ycsb_blocks(data.generator(CPU, seed + 1), 50, 23, 1000, CPU)
    assert not torch.equal(blocks, other)
    assert blocks.shape == (50, 17, 16)
    raw = blocks[3].numpy().astype(">i4").tobytes()
    assert raw[:4] == struct.pack(">I", 23) and raw[4:8] == b"user"
    assert raw[27:31] == struct.pack(">I", 1000)
    msg = raw[:1031]
    assert all(32 <= b < 127 for b in msg[31:])
    from portbench.reference import sha256 as ref_sha

    got = ref_sha.hash_blocks(blocks[3:4], torch.tensor([17], dtype=torch.int32))
    assert got[0].numpy().astype(">i4").tobytes() == hashlib.sha256(msg).digest()


def test_uniform_divergence_is_seeded():
    def make(seed):
        dig = torch.zeros((4, 1000, 8), dtype=torch.int32)
        pres = torch.ones((4, 1000), dtype=torch.bool)
        data.uniform_divergence(data.generator(CPU, seed, 3), dig, pres, 0.02)
        return dig, pres

    d1, p1 = make(9)
    d2, p2 = make(9)
    d3, _ = make(10)
    assert torch.equal(d1, d2) and torch.equal(p1, p2) and not torch.equal(d1, d3)
    assert int((~p1[1]).sum()) == 10 and int((d1[1, :, 1] != 0).sum()) == 10
    assert int((~p1[0]).sum()) == 0


def test_zipf_divergence_over_shards_equals_one_shard():
    def make(shards):
        l = 1024 // shards
        dig = [torch.zeros((3, l, 8), dtype=torch.int32) for _ in range(shards)]
        pres = [torch.ones((3, l), dtype=torch.bool) for _ in range(shards)]
        data.zipf_divergence(77, dig, pres, 0.05, 1.0, 8, CPU)
        return torch.cat(dig, dim=1), torch.cat(pres, dim=1)

    d1, p1 = make(1)
    d4, p4 = make(4)
    assert torch.equal(d1, d4) and torch.equal(p1, p4)
    drawn = (d1[2, :, 2] != 0) | ~p1[2]
    assert int(drawn.sum()) == 51
    # Skewed toward the low key indices.
    assert int(drawn[:256].sum()) > int(drawn[768:].sum())


def test_gaps_are_the_same_for_every_seed():
    a = data.exponential_gaps(np.random.default_rng(1), 400, 2.0)
    b = data.exponential_gaps(np.random.default_rng(2), 400, 2.0)
    assert np.isclose(a.sum(), 2.0) and np.allclose(np.sort(a), np.sort(b))
    assert not np.allclose(a, b)


def test_zipf_ranks_are_skewed_and_seeded():
    r1 = data.zipf_ranks(np.random.default_rng(3), 10_000, 0.99, 20_000)
    r2 = data.zipf_ranks(np.random.default_rng(3), 10_000, 0.99, 20_000)
    assert np.array_equal(r1, r2)
    assert r1.min() >= 0 and r1.max() < 10_000
    assert np.mean(r1 == 0) > 0.05
