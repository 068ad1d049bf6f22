"""The ragged leaf set (``merkle/ragged.py``) and its hash on the CPU.

Leaves of any block count lie back to back (``blocks`` [T, 16], ``offsets``
[N + 1]); ``ops.dispatch.hash_ragged`` hashes them (here the plain version,
``ops.sha256.sha256_ragged``). Held to ``hashlib``, to the padded path
(``packing.pack_leaves`` + ``hash_blocks``), to the benchmark's plain
reference (``portbench/reference/ragged.py`` and ``tree.py``), to the JAX
package's padded tree and to the golden CPU tree. Tolerance: exact
equality. The kernels' cases are in ``tests/test_torch_cuda.py``.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax

from merklekv_tpu.merkle import jax_engine
from merklekv_tpu_torch.merkle import ragged
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.merkle.cpu import MerkleTree
from merklekv_tpu_torch.merkle.encoding import leaf_hash
from merklekv_tpu_torch.merkle.packing import pack_leaves
from merklekv_tpu_torch.ops import dispatch
from merklekv_tpu_torch.ops.sha256 import digests_to_bytes
from merklekv_tpu_torch.utils.torchenv import words_np
from portbench.reference import ragged as ref_ragged
from portbench.reference import tree as ref_tree

CPU = torch.device("cpu")


def etc_records(n: int, seed: int):
    """``n`` sorted records whose key and value sizes are quantiles of the
    ETC fits (Atikoglu et al., SIGMETRICS 2012) in a seeded order."""
    rng = np.random.default_rng(seed)
    p = (np.arange(n) + 0.5) / n
    k = 0.078688
    kl = np.maximum(np.floor(30.7984 + 8.20449 / k * ((-np.log(p)) ** (-k) - 1)), 10)
    kv = 0.348238
    vl = np.floor(214.476 / kv * ((1 - p) ** (-kv) - 1))
    kl, vl = rng.permutation(kl).astype(int), rng.permutation(vl).astype(int)
    keys = sorted({b"%010d" % i + bytes(rng.integers(32, 127, int(kl[i]) - 10, dtype=np.uint8))
                   for i in range(n)})
    return keys, [bytes(rng.integers(0, 256, int(v), dtype=np.uint8)) for v in vl]


def _tail(last_byte: int):
    """Records whose message ends on byte ``last_byte`` of a block (55: the
    padding still fits; 56: it takes one block more)."""
    keys = [b"t%03d" % i for i in range(40)]
    return keys, [b"v" * (64 * (i % 3) + last_byte - 8 - len(k)) for i, k in enumerate(keys)]


CASES = {
    "etc": lambda: etc_records(2000, seed=20),
    "tail55": lambda: _tail(55),
    "tail56": lambda: _tail(56),
    "empty_value": lambda: ([b"a", b"bb", b"k" * 300], [b"", b"", b""]),
    "one_mib": lambda: ([b"big", b"small"], [bytes(range(256)) * 4096, b"x"]),
}


def _golden(keys, values) -> list:
    return [hashlib.sha256(len(k).to_bytes(4, "big") + k + len(v).to_bytes(4, "big") + v).digest()
            for k, v in zip(keys, values)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_packer_and_hash_match_hashlib(case):
    keys, values = CASES[case]()
    leaves = ragged.RaggedLeaves.pack(keys, values, CPU)
    got = dispatch.hash_ragged(leaves)
    assert digests_to_bytes(words_np(got)) == _golden(keys, values)
    mlen = np.array([8 + len(k) + len(v) for k, v in zip(keys, values)])
    assert np.array_equal(np.diff(leaves.offsets.numpy()), (mlen + 9 + 63) // 64)
    assert leaves.total_blocks == int(leaves.offsets[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_benchmark_packer_writes_the_same_blocks(case):
    keys, values = CASES[case]()
    words, offsets = ragged.pack_ragged(keys, values)
    flat = lambda items: torch.frombuffer(bytearray(b"".join(items)) or bytearray(1),  # noqa: E731
                                          dtype=torch.uint8)
    lens = lambda items: torch.tensor([len(x) for x in items])  # noqa: E731
    blocks, offs = ref_ragged.pack(flat(keys), lens(keys), flat(values), lens(values))
    assert np.array_equal(blocks.numpy(), words.view(np.int32))
    assert np.array_equal(offs.numpy(), offsets)


def test_ragged_equals_padded_where_both_fit():
    keys, values = etc_records(500, seed=3)
    keys, values = keys[:400], [v[:700] for v in values[:400]]
    padded = pack_leaves(keys, values)
    leaves = ragged.RaggedLeaves.pack(keys, values, CPU)
    for i in range(0, 400, 37):
        lo, hi = int(leaves.offsets[i]), int(leaves.offsets[i + 1])
        assert hi - lo == padded.nblocks[i]
        assert np.array_equal(leaves.blocks[lo:hi].numpy(), padded.blocks[i, :hi - lo].view(np.int32))
    want = dispatch.hash_blocks(torch.from_numpy(padded.blocks.view(np.int32)),
                                torch.from_numpy(padded.nblocks))
    assert torch.equal(dispatch.hash_ragged(leaves), want)


def test_schedule_orders_longest_first_and_counts_lane_slots():
    keys, values = etc_records(3001, seed=5)
    leaves = ragged.RaggedLeaves.pack(keys, values, CPU)
    lengths = (leaves.offsets[1:] - leaves.offsets[:-1]).numpy()
    order = leaves.order.numpy()
    assert sorted(order.tolist()) == list(range(3001))
    want = np.lexsort((np.arange(3001), -lengths))  # longest first, ties in key order
    assert np.array_equal(order, want)
    group_max = lengths[order][::32]
    assert leaves.lane_slots == 32 * int(group_max.sum())
    assert leaves.longest == int(lengths.max()) and leaves.chained == 0
    # The fill rises with N: the few long leaves' warps weigh less.
    assert 0.75 <= leaves.total_blocks / leaves.lane_slots <= 1.0
    in_key_order = np.pad(lengths, (0, (-3001) % 32)).reshape(-1, 32).max(axis=1).sum()
    assert leaves.total_blocks / (32 * in_key_order) < 0.5


@pytest.mark.parametrize("lengths,sms,warps,want", [
    ([17] * 10_000_000, 132, 10, 0),  # one record shape: no group trails the bulk
    ([3348] + [6] * 300_000, 132, 10, 1),  # one long chain leads a bulk of short leaves
    ([500] * 64 + [6] * 300_000, 132, 10, 2),  # two groups of long leaves
    ([100_000] * 4000 + [1] * 10, 132, 10, 64),  # at most one SM in eight for chains
    ([4], 132, 10, 1),  # a lone leaf is a chain
    ([17] * 3000, 132, 10, 64),  # too few warps to fill the card: each ends with the bulk
])
def test_chained_groups(lengths, sms, warps, want):
    ordered = torch.tensor(sorted(lengths, reverse=True))
    assert ragged.chained_groups(ordered[::32], sms, warps) == want


def test_set_refuses_what_it_cannot_hash():
    blocks = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        ragged.RaggedLeaves(blocks, torch.tensor([0, 4], dtype=torch.int32))
    with pytest.raises(ValueError):
        ragged.RaggedLeaves(blocks[:, :8].contiguous(), torch.tensor([0, 4]))
    with pytest.raises(ValueError):
        ragged.pack_ragged([b"a"], [])


def _replicas(n: int, r: int, seed: int):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, (1, n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)
    digests = np.repeat(base, r, axis=0)
    present = np.ones((r, n), dtype=bool)
    for rep in range(1, r):
        pos = rng.choice(n, size=min(n, max(2, n // 100)), replace=False)
        digests[rep, pos[::2], rep % 8] ^= 1
        present[rep, pos[1::2]] = False
    return torch.from_numpy(digests), torch.from_numpy(present)


@pytest.mark.parametrize("n", [1, 2, 97, 3001])
def test_anti_entropy_forward_matches_the_plain_reference(n):
    keys, values = etc_records(n, seed=n)
    digests, present = _replicas(n, 8, seed=n + 1)
    leaves = ragged.RaggedLeaves.pack(keys, values, CPU)
    root, masks, counts = te.anti_entropy_forward(leaves, None, digests, present, device=CPU)
    want_root = ref_tree.tree_root(ref_ragged.hash_ragged(leaves.blocks, leaves.offsets))
    want_masks = ref_tree.diff_masks(digests, present)
    assert torch.equal(root, want_root)
    assert torch.equal(masks, want_masks)
    assert torch.equal(counts, want_masks.sum(dim=1, dtype=torch.int32))


@pytest.mark.parametrize("n", [3, 257])
def test_anti_entropy_forward_matches_the_jax_padded_tree(n):
    keys, values = etc_records(n, seed=40 + n)
    digests, present = _replicas(n, 4, seed=n)
    padded = pack_leaves(keys, values)
    j_root, j_masks, j_counts = jax.jit(jax_engine.anti_entropy_forward)(
        padded.blocks, padded.nblocks, digests.numpy().view(np.uint32), present.numpy())
    leaves = ragged.RaggedLeaves.pack(keys, values, CPU)
    root, masks, counts = te.anti_entropy_forward(leaves, None, digests, present, device=CPU)
    np.testing.assert_array_equal(words_np(root), np.asarray(j_root))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(j_masks))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


def test_leaf_digests_and_tree_roots_match_the_golden_tree():
    keys, values = etc_records(600, seed=9)
    got = te.leaf_digests(keys, values, device=CPU)
    assert digests_to_bytes(words_np(got)) == [leaf_hash(k, v) for k, v in zip(keys, values)]
    tree, golden = te.TorchMerkleTree(device=CPU), MerkleTree()
    for k, v in zip(keys, values):
        tree.insert(k, v)
        golden.insert(k.decode("ascii"), v)
    assert tree.root_hash() == golden.root_hash()
    assert te.leaf_digests([], [], device=CPU).shape == (0, 8)
