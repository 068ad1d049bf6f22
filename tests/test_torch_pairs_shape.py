"""The pairs kernel's launch, checked on the host, and the pairs hash at the
launch's edge sizes against the JAX package and hashlib.

``merklekv_tpu_torch/csrc/node_pairs.cuh`` builds as plain host C++; this
test compiles it with the host C++ compiler and holds ``mkv_pairs_shape``
and ``mkv_pairs_row`` (the kernel's guard) to what the launch needs, for
every p up to 600 and a seeded sample up to 70,000, on cards of 1, 8, 114
and 132 SMs:

- the rows of all threads of all blocks cover 0..p-1, each exactly once;
- a block has a multiple of 32 threads, at most 1024 and at most the
  kernel's ``__launch_bounds__`` (``kMkvPairsThreads``), and no block is
  idle;
- at most 4 warps a block, and while p <= 4 * 32 * SMs at most SMs blocks
  (one warp per SM sub-partition);
- the grid fits its limit (2^31 - 1 blocks) at p = 10M and beyond.

A host rehearsal of the whole launch (the shape, every thread through the
guard, its row's loads and the hash of ``sha256_core.cuh`` that the kernel
runs) is held to hashlib. The kernel itself runs only on the card; here
``dispatch.hash_node_pairs`` on CPU tensors takes the plain version, held
to the JAX package's ``sha256_node_pairs`` (its scan formulation, the
Pallas kernel's own reference) and hashlib, bit for bit, at the edge sizes
up to 4097. The card's own edge sizes are in ``tests/test_torch_cuda.py``.
"""

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from merklekv_tpu.ops import sha256 as jax_sha
from merklekv_tpu_torch.ops import dispatch

CSRC = Path(__file__).resolve().parents[1] / "merklekv_tpu_torch" / "csrc"
SMS = (1, 8, 114, 132)
EDGES = (1, 31, 32, 33, 127, 128, 129, 4095, 4096, 4097)

HARNESS = r"""
#include <string.h>
#include "node_pairs.cuh"
#include "sha256_core.cuh"
extern "C" int host_pairs_shape(int64_t p, int64_t* blocks, int32_t* threads) {
  return mkv_pairs_shape(p, blocks, threads);
}
extern "C" int32_t host_pairs_threads() { return kMkvPairsThreads; }
// Runs every thread of the grid through the kernel's guard; counts[i] is
// how many threads took row i. Returns how many threads took a row.
extern "C" int64_t host_pairs_cover(int64_t p, int64_t blocks, int32_t threads,
                                    int32_t* counts) {
  int64_t taken = 0;
  for (int64_t b = 0; b < blocks; ++b) {
    for (int32_t t = 0; t < threads; ++t) {
      int64_t row;
      if (mkv_pairs_row(static_cast<uint32_t>(b), static_cast<uint32_t>(t),
                        static_cast<uint32_t>(threads), p, &row)) {
        ++counts[row];
        ++taken;
      }
    }
  }
  return taken;
}
// The launch on the host: the shape for p pairs, every thread through the
// guard, and each row's words hashed as node_pairs_kernel does.
extern "C" int host_pairs_grid(int64_t p, const uint32_t* left, const uint32_t* right,
                               uint32_t* out) {
  int64_t blocks;
  int32_t threads;
  if (mkv_pairs_shape(p, &blocks, &threads) != 0) return -1;
  for (int64_t b = 0; b < blocks; ++b) {
    for (int32_t t = 0; t < threads; ++t) {
      int64_t i;
      if (!mkv_pairs_row(static_cast<uint32_t>(b), static_cast<uint32_t>(t),
                         static_cast<uint32_t>(threads), p, &i)) continue;
      uint32_t w[16], s[8];
      memcpy(w, left + 8 * i, 32);
      memcpy(w + 8, right + 8 * i, 32);
      mkv_iv(s);
      mkv_compress(s, w);
      mkv_compress_node_pad(s);
      memcpy(out + 8 * i, s, 32);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def shape_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the shape harness")
    d = tmp_path_factory.mktemp("pairs_shape")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib_path = d / "libpairs_shape.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
                    str(src), "-o", str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    i32, i64, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    lib.host_pairs_shape.argtypes = [i64, ptr, ptr]
    lib.host_pairs_shape.restype = ctypes.c_int
    lib.host_pairs_threads.restype = i32
    lib.host_pairs_cover.argtypes = [i64, i64, i32, ptr]
    lib.host_pairs_cover.restype = i64
    lib.host_pairs_grid.argtypes = [i64, ptr, ptr, ptr]
    lib.host_pairs_grid.restype = ctypes.c_int
    return lib


def _shape(lib, p: int) -> tuple[int, int]:
    blocks, threads = ctypes.c_int64(-7), ctypes.c_int32(-7)
    rc = lib.host_pairs_shape(p, ctypes.byref(blocks), ctypes.byref(threads))
    assert rc == 0, p
    return blocks.value, threads.value


def _sizes() -> list[int]:
    sample = np.random.default_rng(12).integers(601, 70_001, size=150)
    edges = [m * 32 * s + o for s in SMS for m in (1, 4) for o in (-1, 0, 1)]
    return sorted(set(range(1, 601)) | set(int(x) for x in sample) | set(edges) | {70_000})


@pytest.mark.parametrize("sms", SMS)
def test_shape_covers_every_pair_once(shape_lib, sms):
    most = shape_lib.host_pairs_threads()
    for p in _sizes():
        blocks, threads = _shape(shape_lib, p)
        assert threads % 32 == 0 and 32 <= threads <= min(1024, most, 128), (p, threads)
        assert (blocks - 1) * threads < p <= blocks * threads, (p, blocks, threads)
        if p <= 4 * 32 * sms:
            assert blocks <= sms, (p, sms, blocks, threads)
        counts = np.zeros(p, dtype=np.int32)
        taken = shape_lib.host_pairs_cover(p, blocks, threads,
                                           counts.ctypes.data_as(ctypes.c_void_p))
        assert taken == p and counts.min() == 1 and counts.max() == 1, (p, sms)


@pytest.mark.parametrize("sms", SMS)
def test_shape_spreads_one_warp_per_sub_partition(shape_lib, sms):
    """Blocks of the fewest warps up to 4 that cover p: one block below 97
    pairs, then 128-thread blocks, one an SM up to 4 * 32 * SMs pairs."""
    for p in (1, 32, 33, 64, 65, 96):
        assert _shape(shape_lib, p) == (1, 32 * -(-p // 32)), p
    for p in [q for q in (97, 32 * sms + 1, 64 * sms, 128 * sms) if q >= 97]:
        blocks, threads = _shape(shape_lib, p)
        assert threads == 128 and blocks == -(-p // 128) <= sms, (p, sms)
    for p in (128 * sms + 1, 1000 * sms, 10_000_000):
        assert _shape(shape_lib, p) == (-(-p // 128), 128)
    assert shape_lib.host_pairs_threads() == 128


@pytest.mark.parametrize("p", [10_000_000 - 1, 10_000_000, 10_000_001, 2**31 - 1])
def test_shape_fits_the_grid_at_ten_million(shape_lib, p):
    blocks, threads = _shape(shape_lib, p)
    assert blocks * threads >= p and blocks <= 2**31 - 1 and threads <= 1024


@pytest.mark.parametrize("p", [0, -1, -4096, -(2**63)])
def test_shape_refuses_no_pairs(shape_lib, p):
    blocks, threads = ctypes.c_int64(), ctypes.c_int32()
    assert shape_lib.host_pairs_shape(p, ctypes.byref(blocks), ctypes.byref(threads)) == -1


@pytest.mark.parametrize("seed,p", [(0, 33), (1, 4097), (2, 16_897)])
def test_launch_rehearsal_hashes_every_pair_vs_hashlib(shape_lib, seed, p):
    """One block of two warps, past the serving batch, and past one block
    per SM on 132 SMs."""
    left, right = _rand_words(seed, (p, 8)), _rand_words(seed + 100, (p, 8))
    left[0], right[0] = 0, 0xFFFFFFFF
    out = np.zeros((p, 8), dtype=np.uint32)
    ptr = ctypes.c_void_p
    rc = shape_lib.host_pairs_grid(p, left.ctypes.data_as(ptr), right.ctypes.data_as(ptr),
                                   out.ctypes.data_as(ptr))
    assert rc == 0
    want = [hashlib.sha256(left[i].astype(">u4").tobytes() + right[i].astype(">u4").tobytes())
            .digest() for i in range(p)]
    assert [r.astype(">u4").tobytes() for r in out] == want


_jax_pairs = jax.jit(jax_sha.sha256_node_pairs)


def _rand_words(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("p", EDGES)
def test_hash_node_pairs_at_edge_sizes_vs_jax_and_hashlib(p):
    left, right = _rand_words(p, (p, 8)), _rand_words(p + 1, (p, 8))
    got = dispatch.hash_node_pairs(torch.from_numpy(left.view(np.int32)),
                                   torch.from_numpy(right.view(np.int32)))
    got = got.numpy().view(np.uint32)
    assert got.shape == (p, 8)
    np.testing.assert_array_equal(
        got, np.asarray(_jax_pairs(jnp.asarray(left), jnp.asarray(right))))
    want = [hashlib.sha256(left[i].astype(">u4").tobytes() + right[i].astype(">u4").tobytes())
            .digest() for i in range(p)]
    assert [r.astype(">u4").tobytes() for r in got] == want
