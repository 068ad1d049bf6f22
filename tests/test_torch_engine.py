"""The torch Merkle engine and diff against the JAX package and the golden tree.

Same numpy inputs (fixed seeds) through ``merklekv_tpu.merkle.jax_engine`` /
``diff`` on the JAX CPU backend (the scan path, the Pallas kernels' own
plain reference) and through ``merklekv_tpu_torch`` on CPU tensors (the
plain PyTorch versions behind the CUDA wrappers). Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _example_batch
from merklekv_tpu.merkle import diff as jax_diff
from merklekv_tpu.merkle import jax_engine
from merklekv_tpu_torch.merkle import diff as t_diff
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.merkle.cpu import MerkleTree, build_levels
from merklekv_tpu_torch.merkle.encoding import leaf_hash
from merklekv_tpu_torch.ops import dispatch
from merklekv_tpu_torch.ops.sha256 import digest_to_bytes, digests_to_bytes
from merklekv_tpu_torch.utils.torchenv import words_np

CPU = "cpu"
SIZES = [1, 2, 3, 97, 3001]
CAPACITY = 4096
_jax_forward = jax.jit(jax_engine.anti_entropy_forward)


def _kv(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    keys = sorted({b"tk%09d:%d" % (rng.integers(0, 10**9), i) for i in range(n)})
    vals = [b"v" * int(rng.integers(0, 40)) + b"%d" % i for i in range(len(keys))]
    return keys, vals


@pytest.fixture(scope="module")
def leaves_3001():
    keys, vals = _kv(max(SIZES), seed=1)
    t = te.leaf_digests(keys, vals, device=CPU)
    j = np.asarray(jax_engine.leaf_digests(keys, vals))
    golden = [leaf_hash(k, v) for k, v in zip(keys, vals)]
    return t, j, golden


def test_leaf_digests_match_jax_and_golden(leaves_3001):
    t, j, golden = leaves_3001
    np.testing.assert_array_equal(words_np(t), j)
    assert digests_to_bytes(words_np(t)) == golden


@pytest.mark.parametrize("n", SIZES)
def test_build_levels_and_root_match_jax_and_golden(leaves_3001, n):
    t, j, golden = leaves_3001
    levels = te.build_levels_device(t[:n])
    ref = build_levels(golden[:n])
    assert len(levels) == len(ref)
    for lv, rl in zip(levels, ref):
        assert digests_to_bytes(words_np(lv)) == rl
    root = words_np(te.tree_root(t[:n]))
    np.testing.assert_array_equal(root, np.asarray(jax_engine.tree_root(jnp.asarray(j[:n]))))
    np.testing.assert_array_equal(words_np(dispatch.build_levels(t[:n])[-1][0]), root)
    assert digest_to_bytes(root) == ref[-1][0]


@pytest.mark.parametrize("n", SIZES)
def test_tree_root_capacity_matches_static_and_jax(leaves_3001, n):
    """Dynamic-n odd promotion over a power-of-two capacity."""
    t, j, golden = leaves_3001
    padded = torch.zeros((CAPACITY, 8), dtype=torch.int32)
    padded[:n] = t[:n]
    got = words_np(te.tree_root_capacity(padded, n))
    jpad = np.zeros((CAPACITY, 8), np.uint32)
    jpad[:n] = j[:n]
    np.testing.assert_array_equal(
        got, np.asarray(jax_engine.tree_root_capacity(jnp.asarray(jpad), jnp.int32(n)))
    )
    assert digest_to_bytes(got) == build_levels(golden[:n])[-1][0]


def test_tree_root_capacity_every_n_small():
    """Every live count of a small capacity, including n == C."""
    keys, vals = _kv(8, seed=2)
    t = te.leaf_digests(keys, vals, device=CPU)
    for n in range(1, 9):
        assert torch.equal(te.tree_root_capacity(t, n), te.tree_root(t[:n])), n


def test_tree_root_capacity_rejects_bad_input():
    with pytest.raises(ValueError):
        te.tree_root_capacity(torch.zeros((6, 8), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        te.tree_root_capacity(torch.zeros((8, 8), dtype=torch.int32), 0)


@pytest.mark.parametrize("absent_every", [0, 7])
def test_anti_entropy_forward_matches_jax(absent_every):
    """``__graft_entry__.entry()``'s batch shape (256 leaves, 4 replicas),
    with and without presence differences."""
    blocks, nblocks, digests, present = _example_batch(256, 4)
    present = present.copy()
    if absent_every:
        present[1, ::absent_every] = False
    root, masks, counts = te.anti_entropy_forward(blocks, nblocks, digests, present, device=CPU)
    jr, jm, jc = _jax_forward(
        jnp.asarray(blocks), jnp.asarray(nblocks), jnp.asarray(digests), jnp.asarray(present)
    )
    np.testing.assert_array_equal(words_np(root), np.asarray(jr))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.dtype == torch.int32 and counts[0] == 0 and int(counts.sum()) > 0


def _replica_maps(seed: int, r: int, n: int):
    rng = np.random.RandomState(seed)
    base = {b"dk%05d" % i: rng.bytes(32) for i in range(n)}
    reps = [dict(base)]
    for _ in range(1, r):
        rep = dict(base)
        for i in rng.choice(n, size=n // 8, replace=False):
            k = b"dk%05d" % i
            if rng.rand() < 0.3:
                del rep[k]
            else:
                rep[k] = rng.bytes(32)
        rep[b"extra%d" % rng.randint(1000)] = rng.bytes(32)
        reps.append(rep)
    return reps


def test_align_and_diff_keys_multi_match_jax():
    reps = _replica_maps(3, 4, 200)
    ta, ja = t_diff.align_replicas(reps), jax_diff.align_replicas(reps)
    assert ta.keys == ja.keys
    np.testing.assert_array_equal(ta.digests, ja.digests)
    np.testing.assert_array_equal(ta.present, ja.present)
    got = t_diff.diff_keys_multi(ta, device=CPU)
    assert got == jax_diff.diff_keys_multi(ja)
    assert all(got[r] for r in range(1, 4))


def test_diff_keys_pair_matches_jax_and_golden():
    local, remote = _replica_maps(4, 2, 150)
    got = t_diff.diff_keys_pair(local, remote, device=CPU)
    assert got == jax_diff.diff_keys_pair(local, remote)
    assert got == sorted(k for k in local.keys() | remote.keys() if local.get(k) != remote.get(k))
    assert t_diff.diff_keys_pair({}, {}, device=CPU) == []


def test_divergence_vs_ref_numpy_and_torch_agree():
    d = np.random.RandomState(5).randint(0, 3, size=(3, 50, 8)).astype(np.uint32)
    p = np.random.RandomState(6).rand(3, 50) < 0.8
    ref = jax_diff.divergence_masks_np(d, p)
    np.testing.assert_array_equal(t_diff.divergence_vs_ref(d, p, d[0:1], p[0:1]), ref)
    got = t_diff.divergence_masks(torch.from_numpy(d.view(np.int32)), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_torch_merkle_tree_matches_jax_and_cpu():
    items = [("", ""), ("\x00", "\x00v"), ("héllo", "wörld"), ("世界", "值")]
    items += [(f"key:{i:04d}", "v" * (i % 70)) for i in range(41)]
    t = te.TorchMerkleTree(device=CPU)
    j = jax_engine.JaxMerkleTree()
    cpu = MerkleTree.from_items(items)
    for k, v in items:
        t.insert(k, v)
        j.insert(k, v)
    assert t.root_hex() == j.root_hex() == cpu.root_hex()
    for tl, cl in zip(t.levels, cpu.levels):
        assert digests_to_bytes(tl) == cl
    assert t.leaves() == j.leaves()
    t.remove("héllo")
    j.remove("héllo")
    cpu.remove("héllo")
    assert t.root_hex() == j.root_hex() == cpu.root_hex()
    assert t.inorder_keys() == j.inorder_keys()
    t.clear()
    assert t.root_hash() is None and t.root_hex() == "0" * 64 and len(t) == 0
