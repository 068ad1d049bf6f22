"""The torch port's SHA-256 against hashlib and against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages.
On the torch side the functions run on CPU tensors: the plain PyTorch
versions directly, and the CUDA wrappers and the dispatch (which take the
plain version for a CPU tensor). On the JAX side, ``merklekv_tpu.ops.sha256``
is the scan formulation — the Pallas kernels' own plain reference, which the
TPU tests hold the kernels to (interpreting the kernels on the CPU is
intractable). The tolerance is exact equality everywhere: a hash is right or
it is wrong.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from merklekv_tpu.ops import sha256 as jax_sha
from merklekv_tpu_torch.merkle.encoding import encode_leaf
from merklekv_tpu_torch.merkle.packing import pack_leaves
from merklekv_tpu_torch.ops import dispatch
from merklekv_tpu_torch.ops import sha256 as t_sha
from merklekv_tpu_torch.ops import cuda_lib, sha256_cuda

_jax_blocks = jax.jit(jax_sha.sha256_blocks)
_jax_pairs = jax.jit(jax_sha.sha256_node_pairs)
_jax_single = jax.jit(jax_sha.sha256_single_block)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _hashlib_rows(msgs) -> np.ndarray:
    return np.stack(
        [np.frombuffer(hashlib.sha256(m).digest(), ">u4").astype(np.uint32) for m in msgs]
    )


def _random_leaves(seed: int, n: int, max_key: int, max_val: int):
    rng = np.random.RandomState(seed)
    keys = [rng.bytes(rng.randint(0, max_key + 1)) for _ in range(n)]
    vals = [rng.bytes(rng.randint(0, max_val + 1)) for _ in range(n)]
    return keys, vals


def _rand_words(seed: int, shape) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def test_constants_match_jax():
    np.testing.assert_array_equal(t_sha._K, jax_sha._K)
    np.testing.assert_array_equal(t_sha._IV, jax_sha._IV)
    np.testing.assert_array_equal(t_sha._NODE_PAD_BLOCK, jax_sha._NODE_PAD_BLOCK)


@pytest.mark.parametrize(
    "seed,max_key,max_val",
    [(0, 20, 20), (1, 40, 200), (2, 0, 0), (3, 64, 300)],
    ids=["single-block", "multi-block", "empty", "long"],
)
def test_blocks_random_bytes_vs_hashlib_and_jax(seed, max_key, max_val):
    """Random bytes put the top bit in many words: an unmasked int32 shift
    would show here and not in ASCII-only tests."""
    keys, vals = _random_leaves(seed, 64, max_key, max_val)
    packed = pack_leaves(keys, vals)
    got = _np(t_sha.sha256_blocks(_t(packed.blocks), torch.from_numpy(packed.nblocks)))
    np.testing.assert_array_equal(got, _hashlib_rows([encode_leaf(k, v) for k, v in zip(keys, vals)]))
    ref = np.asarray(_jax_blocks(jnp.asarray(packed.blocks), jnp.asarray(packed.nblocks)))
    np.testing.assert_array_equal(got, ref)


def test_blocks_mixed_nblocks_including_zero_vs_jax():
    """Valid-block masking: nblocks 0..3 over B = 3; nblocks == 0 keeps the IV."""
    blocks = _rand_words(5, (40, 3, 16))
    nblocks = (np.arange(40) % 4).astype(np.int32)
    got = _np(t_sha.sha256_blocks(_t(blocks), torch.from_numpy(nblocks)))
    ref = np.asarray(_jax_blocks(jnp.asarray(blocks), jnp.asarray(nblocks)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[nblocks == 0], np.tile(t_sha._IV, ((nblocks == 0).sum(), 1)))


def test_single_block_vs_jax_and_hashlib():
    msgs = [np.random.RandomState(9).bytes(i % 56) for i in range(56)]
    padded = np.stack([
        np.frombuffer(m + b"\x80" + b"\x00" * (55 - len(m)) + (8 * len(m)).to_bytes(8, "big"),
                      ">u4").astype(np.uint32)
        for m in msgs
    ])
    got = _np(t_sha.sha256_single_block(_t(padded)))
    np.testing.assert_array_equal(got, _hashlib_rows(msgs))
    np.testing.assert_array_equal(got, np.asarray(_jax_single(jnp.asarray(padded))))


def test_node_pairs_vs_hashlib_and_jax():
    left, right = _rand_words(11, (33, 8)), _rand_words(12, (33, 8))
    got = _np(t_sha.sha256_node_pairs(_t(left), _t(right)))
    msgs = [left[i].astype(">u4").tobytes() + right[i].astype(">u4").tobytes() for i in range(33)]
    np.testing.assert_array_equal(got, _hashlib_rows(msgs))
    np.testing.assert_array_equal(got, np.asarray(_jax_pairs(jnp.asarray(left), jnp.asarray(right))))


@pytest.mark.parametrize("m", [2, 3, 33, 64])
def test_node_level_is_adjacent_pairs(m):
    """Rows (2i, 2i+1) read as one message; an odd tail is left out."""
    cur = _rand_words(20 + m, (m, 8))
    got = _np(t_sha.sha256_node_level(_t(cur)))
    p = m // 2
    ref = np.asarray(_jax_pairs(jnp.asarray(cur[0 : 2 * p : 2]), jnp.asarray(cur[1 : 2 * p : 2])))
    np.testing.assert_array_equal(got, ref)


def test_cpu_wrappers_and_dispatch_take_plain_versions():
    """On CPU tensors the CUDA wrappers and the dispatch return the plain
    versions' results, without launching (and without building) anything."""
    cuda_lib.reset_launch_counts()
    keys, vals = _random_leaves(4, 20, 30, 100)
    packed = pack_leaves(keys, vals)
    blocks, nblocks = _t(packed.blocks), torch.from_numpy(packed.nblocks)
    want = t_sha.sha256_blocks(blocks, nblocks)
    assert torch.equal(sha256_cuda.leaf_digests_cuda(blocks, nblocks), want)
    assert torch.equal(dispatch.hash_blocks(blocks, nblocks), want)
    cur = _t(_rand_words(30, (21, 8)))
    assert torch.equal(dispatch.hash_node_level(cur), t_sha.sha256_node_level(cur))
    assert torch.equal(dispatch.hash_node_pairs(cur[:10], cur[10:20]),
                       t_sha.sha256_node_pairs(cur[:10], cur[10:20]))
    assert set(cuda_lib.LAUNCHES.values()) == {0}


def test_digest_byte_helpers_match_jax():
    d = _rand_words(40, (5, 8))
    assert t_sha.digests_to_bytes(d) == jax_sha.digests_to_bytes(d)
    assert t_sha.digest_to_bytes(d[0]) == jax_sha.digest_to_bytes(d[0])
    np.testing.assert_array_equal(t_sha.bytes_to_digest(d[1].astype(">u4").tobytes()), d[1])
    with pytest.raises(ValueError):
        t_sha.bytes_to_digest(b"short")
