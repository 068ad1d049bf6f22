"""The plain reference against hashlib and hand-made trees."""

import hashlib
import struct

import numpy as np
import pytest
import torch

from portbench.reference import sha256 as ref_sha
from portbench.reference import tree as ref_tree
from portbench.reference.encode import blocks_per_leaf, pack_records


def leaf_bytes(k: bytes, v: bytes) -> bytes:
    return struct.pack(">I", len(k)) + k + struct.pack(">I", len(v)) + v


def words(digest: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(digest, ">i4").astype(np.int32))


def hexdig(t: torch.Tensor) -> bytes:
    return t.numpy().astype(">i4").tobytes()


@pytest.mark.parametrize("kl,vl", [(0, 0), (1, 0), (23, 1000), (5, 46), (5, 47), (23, 24), (3, 117)])
def test_leaf_hash_matches_hashlib(kl, vl):
    rng = np.random.default_rng(kl * 1000 + vl)
    n = 5
    keys = rng.integers(0, 256, (n, kl), dtype=np.uint8)
    vals = rng.integers(0, 256, (n, vl), dtype=np.uint8)
    blocks = pack_records(torch.from_numpy(keys), torch.from_numpy(vals))
    assert blocks.shape == (n, blocks_per_leaf(kl, vl), 16)
    got = ref_sha.hash_blocks(blocks, torch.full((n,), blocks.shape[1], dtype=torch.int32), chunk=2)
    for i in range(n):
        want = hashlib.sha256(leaf_bytes(keys[i].tobytes(), vals[i].tobytes())).digest()
        assert hexdig(got[i]) == want


def test_fewer_valid_blocks_keep_the_state():
    rng = np.random.default_rng(7)
    blocks = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 2, 16), dtype=np.int64).astype(np.int32))
    # Row 0 pads a 1-block message; row 2 counts 0 blocks and keeps the IV.
    msg = b"abc"
    pad = msg + b"\x80" + b"\0" * (55 - len(msg)) + struct.pack(">Q", 8 * len(msg))
    blocks[0, 0] = torch.from_numpy(np.frombuffer(pad, ">i4").astype(np.int32))
    got = ref_sha.hash_blocks(blocks, torch.tensor([1, 2, 0], dtype=torch.int32))
    assert hexdig(got[0]) == hashlib.sha256(msg).digest()
    raw = blocks[1].numpy().astype(">i4").tobytes()
    assert hexdig(got[1]) != hexdig(got[0])
    assert [ref_sha.signed(x) for x in ref_sha.IV] == got[2].tolist()
    assert len(raw) == 128


@pytest.mark.parametrize("p", [1, 3, ref_sha.HOST_LEVEL - 1, ref_sha.HOST_LEVEL + 1])
def test_node_hash_matches_hashlib(p):
    rng = np.random.default_rng(p)
    left = torch.from_numpy(rng.integers(-2**31, 2**31, (p, 8), dtype=np.int64).astype(np.int32))
    right = torch.from_numpy(rng.integers(-2**31, 2**31, (p, 8), dtype=np.int64).astype(np.int32))
    got = ref_sha.node_hash(left, right)
    for i in sorted({0, p // 2, p - 1}):
        assert hexdig(got[i]) == hashlib.sha256(hexdig(left[i]) + hexdig(right[i])).digest()


def hand_root(leaves: list) -> bytes:
    level = list(leaves)
    while len(level) > 1:
        nxt = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 9, 17, 33, 100])
def test_tree_root_promotes_odd_nodes(n):
    leaves = [hashlib.sha256(b"leaf %d" % i).digest() for i in range(n)]
    t = torch.stack([words(x) for x in leaves])
    assert hexdig(ref_tree.tree_root(t)) == hand_root(leaves)
    levels = ref_tree.tree_levels(t)
    assert [lv.shape[0] for lv in levels] == ref_tree.level_sizes(n)


@pytest.mark.parametrize("n", [3, 5, 6, 100])
def test_padded_tree_breaks_the_rule_off_powers_of_two(n):
    leaves = [hashlib.sha256(b"x %d" % i).digest() for i in range(n)]
    t = torch.stack([words(x) for x in leaves])
    assert hexdig(ref_tree.padded_levels(t)[-1][0]) != hand_root(leaves)
    full = t[:1 << (n.bit_length() - 1)]
    assert torch.equal(ref_tree.padded_levels(full)[-1][0], ref_tree.tree_root(full))


def test_diff_masks_by_hand():
    d = torch.zeros((3, 5, 8), dtype=torch.int32)
    p = torch.ones((3, 5), dtype=torch.bool)
    d[1, 0, 7] = 1        # differs in the last word
    p[1, 1] = False       # absent in replica 1
    p[0, 2] = False       # absent in the reference: replica 2 holds it
    p[1, 2] = False       # absent in both: no divergence
    d[2, 3, 0] = 5        # differs in the first word
    d[2, 4, 2] = 9
    p[2, 4] = False       # absent in replica 2 with another digest: absence counts
    want = torch.tensor([[0, 0, 0, 0, 0], [1, 1, 0, 0, 0], [0, 0, 1, 1, 1]], dtype=torch.bool)
    assert torch.equal(ref_tree.diff_masks(d, p, chunk=2), want)
    # The control's 128-bit prefix misses the change in word 7.
    assert not ref_tree.diff_masks(d, p, words=4)[1, 0]
