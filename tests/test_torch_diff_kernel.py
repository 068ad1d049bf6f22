"""The N-replica diff kernel's arithmetic on the host, and the diff's CPU
route through ``ops.dispatch.divergence``.

``merklekv_tpu_torch/csrc/diff_kernels.cuh`` builds as plain host C++;
this test compiles it with the host C++ compiler and holds its predicate
(``mkv_key_diverges``, ``mkv_half_differs``) and the warp-tile arithmetic
of ``diff_kernel`` to the JAX package's ``divergence_masks_np``, bit for
bit. The host rehearsal runs every tile of a launch as the kernel does: the
32 lanes' 16-byte loads (a key's two halves in a pair of lanes), the 8
ballots of differing halves, each lane's four digest bits taken from them,
the packed mask word, and the count as popcounts of the mask bytes'
ballots. Inputs: R in {1, 2, 3, 8}, N on each side of a tile and beyond,
digests that differ in one word (each of the 8, bit 31 included), keys
absent from the reference only, the replica only and both, and key-axis
slices of larger arrays (replica strides other than N).

On CPU tensors ``ops.dispatch.divergence`` is the plain version:
``ops.diff_cuda.divergence_vs_ref`` and the int32 row sum, with no launch
counted. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from merklekv_tpu.merkle import diff as jax_diff
from merklekv_tpu_torch.merkle import diff as t_diff
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.ops import dispatch
from merklekv_tpu_torch.ops import cuda_lib

CSRC = Path(__file__).resolve().parents[1] / "merklekv_tpu_torch" / "csrc"
REPLICAS = (1, 2, 3, 8)
KEYS = (1, 31, 32, 33, 127, 128, 129, 4097, 20_011)

HARNESS = r"""
#include <string.h>
#include "diff_kernels.cuh"
struct Q { uint32_t x, y, z, w; };
extern "C" int host_key_diverges(int p, int p_ref, int digest_differs) {
  return mkv_key_diverges(p != 0, p_ref != 0, digest_differs != 0);
}
extern "C" int host_half_differs(const uint32_t* a, const uint32_t* b) {
  Q qa, qb;
  memcpy(&qa, a, 16);
  memcpy(&qb, b, 16);
  return mkv_half_differs(qa, qb);
}
static Q load_half(const uint32_t* row, int64_t h) {
  Q q;
  memcpy(&q, row + 4 * h, 16);
  return q;
}
static uint32_t present4(const uint8_t* row, int64_t k, int64_t n) {
  uint32_t w = 0;
  for (int i = 0; i < 4; ++i) if (k + i < n) w |= static_cast<uint32_t>(row[k + i]) << (8 * i);
  return w;
}
static void store4(uint8_t* row, int64_t k, int64_t n, uint32_t w) {
  for (int i = 0; i < 4; ++i) if (k + i < n) row[k + i] = static_cast<uint8_t>(w >> (8 * i));
}
// diff_kernel's launch on the host: every tile, its 32 lanes' loads, the
// warp's ballots (bit l from lane l), the lanes' mask words and the counts.
extern "C" void host_divergence(const uint32_t* digests, int64_t digest_stride,
                                const uint8_t* present, int64_t present_stride,
                                uint8_t* masks, int32_t* counts, int64_t n, int32_t r_count) {
  for (int32_t r = 0; r < r_count; ++r) counts[r] = 0;
  const int64_t tiles = (n + kMkvDiffTileKeys - 1) / kMkvDiffTileKeys;
  for (int64_t t = 0; t < tiles; ++t) {
    const int64_t base = t * kMkvDiffTileKeys, left = n - base;
    Q ref[32][kMkvDiffLoads];
    uint32_t ref_present[32];
    for (uint32_t lane = 0; lane < 32; ++lane) {
      for (int j = 0; j < kMkvDiffLoads; ++j) {
        ref[lane][j] = mkv_diff_half_key(j, lane) < left
                           ? load_half(digests, 2 * base + 32 * j + lane) : Q{0, 0, 0, 0};
      }
      ref_present[lane] = present4(present, base + 4 * lane, n);
      store4(masks, base + 4 * lane, n, 0u);
    }
    for (int32_t r = 1; r < r_count; ++r) {
      const uint32_t* drow = digests + r * digest_stride;
      uint32_t ballot[kMkvDiffLoads] = {0};
      for (int j = 0; j < kMkvDiffLoads; ++j) {
        for (uint32_t lane = 0; lane < 32; ++lane) {
          const Q v = mkv_diff_half_key(j, lane) < left
                          ? load_half(drow, 2 * base + 32 * j + lane) : ref[lane][j];
          if (mkv_half_differs(v, ref[lane][j])) ballot[j] |= 1u << lane;
        }
      }
      uint32_t m[32];
      for (uint32_t lane = 0; lane < 32; ++lane) {
        const int64_t k = base + 4 * lane;
        const uint32_t p = present4(present + r * present_stride, k, n);
        m[lane] = mkv_mask_word(p, ref_present[lane], mkv_lane_digest_bytes(ballot, lane));
        store4(masks + r * n, k, n, m[lane]);
      }
      for (int i = 0; i < 4; ++i) {
        uint32_t b = 0;
        for (uint32_t lane = 0; lane < 32; ++lane) b |= mkv_mask_byte(m[lane], i) << lane;
        counts[r] += __builtin_popcount(b);
      }
    }
  }
}
extern "C" int64_t host_diff_grid(int64_t n, int sms, int resident, int beside) {
  return mkv_diff_grid(n, sms, resident, beside != 0);
}
extern "C" int host_diff_threads(int beside) { return mkv_diff_threads(beside != 0); }
extern "C" int host_diff_beside_blocks() { return kMkvDiffBesideBlocks; }
"""


@pytest.fixture(scope="module")
def tile_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the diff harness")
    d = tmp_path_factory.mktemp("diff_tile")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib_path = d / "libdiff_tile.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
                    str(src), "-o", str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.host_key_diverges.argtypes = [ctypes.c_int] * 3
    lib.host_key_diverges.restype = ctypes.c_int
    lib.host_half_differs.argtypes = [ptr, ptr]
    lib.host_half_differs.restype = ctypes.c_int
    lib.host_divergence.argtypes = [ptr, i64, ptr, i64, ptr, ptr, i64, i32]
    lib.host_divergence.restype = None
    lib.host_diff_grid.argtypes = [i64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.host_diff_grid.restype = i64
    lib.host_diff_threads.argtypes = [ctypes.c_int]
    lib.host_diff_threads.restype = ctypes.c_int
    lib.host_diff_beside_blocks.argtypes = []
    lib.host_diff_beside_blocks.restype = ctypes.c_int
    return lib


def replicas(seed: int, r: int, n: int):
    """[r, n, 8] uint32 digests and [r, n] bool presence: replica 0's random
    digests copied to every replica, then in each replica r >= 1 keys whose
    digest differs in one word (each of the 8; bit 31 in the odd words, a
    random lower bit in the even ones), keys absent from it alone, and keys
    absent from both it and replica 0; and keys absent from replica 0
    alone."""
    rng = np.random.default_rng(seed)
    some = max(1, n // 40)
    dig = np.repeat(rng.integers(0, 2**32, size=(1, n, 8), dtype=np.uint64).astype(np.uint32),
                    r, axis=0)
    pres = np.ones((r, n), bool)
    for ri in range(1, r):
        for w in range(8):
            bit = 31 if w % 2 else int(rng.integers(0, 31))
            dig[ri, rng.integers(0, n, size=some), w] ^= np.uint32(1 << bit)
        pres[ri, rng.integers(0, n, size=some)] = False
        both = rng.integers(0, n, size=some)
        pres[ri, both] = False
        pres[0, both] = False
    pres[0, rng.integers(0, n, size=some)] = False
    return dig, pres


def one_word_cases():
    """Two replicas over 17 keys: key 2 w differs from the reference in bit
    31 of word w alone, key 2 w + 1 in bit 0 of word w alone, key 16 not at
    all."""
    dig = np.zeros((2, 17, 8), np.uint32)
    dig[:] = np.arange(17 * 8, dtype=np.uint32).reshape(17, 8) * np.uint32(0x9E3779B1)
    for w in range(8):
        dig[1, 2 * w, w] ^= np.uint32(1 << 31)
        dig[1, 2 * w + 1, w] ^= np.uint32(1)
    return dig, np.ones((2, 17), bool)


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def host_divergence(lib, dig: np.ndarray, pres: np.ndarray):
    """The host rehearsal on (possibly key-sliced) arrays: inner axes
    contiguous, the replica strides whatever they are."""
    assert dig.strides[1:] == (32, 4) and pres.strides[1] == 1
    r, n = pres.shape
    masks = np.full((r, n), 7, np.uint8)
    counts = np.full(r, -1, np.int32)
    lib.host_divergence(_p(dig), dig.strides[0] // 4, _p(pres), pres.strides[0], _p(masks),
                        _p(counts), n, r)
    return masks.view(bool), counts


def test_predicate_truth_table(tile_lib):
    for p in (0, 1):
        for p_ref in (0, 1):
            for differs in (0, 1):
                d = np.zeros((2, 1, 8), np.uint32)
                d[1, 0, 0] = differs
                want = jax_diff.divergence_masks_np(d, np.array([[p_ref], [p]], bool))[1, 0]
                assert bool(tile_lib.host_key_diverges(p, p_ref, differs)) == bool(want)


def test_half_differs_in_each_word_and_bit(tile_lib):
    a = np.array([0x80000000, 0xFFFFFFFF, 0, 0x12345678], np.uint32)
    assert tile_lib.host_half_differs(_p(a), _p(a.copy())) == 0
    for w in range(4):
        for bit in range(32):
            b = a.copy()
            b[w] ^= np.uint32(1 << bit)
            assert tile_lib.host_half_differs(_p(a), _p(b)) == 1, (w, bit)


@pytest.mark.parametrize("r", REPLICAS)
@pytest.mark.parametrize("n", KEYS)
def test_host_launch_matches_numpy_twin(tile_lib, r, n):
    dig, pres = replicas(1000 * r + n, r, n)
    masks, counts = host_divergence(tile_lib, dig, pres)
    want = jax_diff.divergence_masks_np(dig, pres)
    np.testing.assert_array_equal(masks, want)
    np.testing.assert_array_equal(counts, want.sum(axis=1, dtype=np.int32))
    assert not masks[0].any()


@pytest.mark.parametrize("start,n", [(1, 33), (3, 4097), (128, 256), (5, 20_011)])
def test_host_launch_on_a_key_slice(tile_lib, start, n):
    dig, pres = replicas(start + n, 8, n + start + 11)
    sd, sp = dig[:, start:start + n], pres[:, start:start + n]
    masks, counts = host_divergence(tile_lib, sd, sp)
    want = jax_diff.divergence_masks_np(np.ascontiguousarray(sd), np.ascontiguousarray(sp))
    np.testing.assert_array_equal(masks, want)
    np.testing.assert_array_equal(counts, want.sum(axis=1, dtype=np.int32))


def test_host_launch_finds_one_word_in_each_position(tile_lib):
    dig, pres = one_word_cases()
    masks, counts = host_divergence(tile_lib, dig, pres)
    assert masks[1].tolist() == [True] * 16 + [False]
    assert counts.tolist() == [0, 16]


# ------------------------------------------------------------ the launch shapes

# One SM, then the SMs of an L4, an A100, an H100 PCIe and an H100 SXM.
GRID_SMS = (1, 58, 108, 114, 132)
GRID_KEYS = (1, 127, 128, 129, 4097, 8192 * 132 + 5, 10_000_000, 16_500_000)


def _tiles(n):
    return -(-n // 128)


@pytest.mark.parametrize("sms", GRID_SMS)
@pytest.mark.parametrize("n", GRID_KEYS)
def test_standalone_grid_is_the_blocks_the_card_holds(tile_lib, sms, n):
    """The standalone launch keeps its grid: 256-thread blocks, the
    occupancy calculator's count an SM (at least 1) times the SMs, never
    more than the tiles need at 8 warps a block."""
    assert tile_lib.host_diff_threads(0) == 256
    for resident in (0, 1, 2, 3):
        want = min(-(-_tiles(n) // 8), sms * max(resident, 1))
        assert tile_lib.host_diff_grid(n, sms, resident, 0) == want


@pytest.mark.parametrize("sms", GRID_SMS)
@pytest.mark.parametrize("n", GRID_KEYS)
def test_coresident_grid_takes_its_blocks_an_sm_and_covers_every_tile(tile_lib, sms, n):
    """The co-resident grid is one block of 128 threads an SM whatever the
    card holds (the occupancy count is not read), fewer only where the
    tiles need fewer; the kernel's warps, striding by the grid's warp count
    from block b's warp w at tile b * warps + w, visit every tile once."""
    per_sm, threads = tile_lib.host_diff_beside_blocks(), tile_lib.host_diff_threads(1)
    assert (per_sm, threads) == (1, 128)
    warps = threads // 32
    grid = tile_lib.host_diff_grid(n, sms, 5, 1)
    assert grid == tile_lib.host_diff_grid(n, sms, 0, 1)
    assert grid == min(-(-_tiles(n) // warps), sms * per_sm) and grid >= 1
    seen = np.zeros(_tiles(n), np.int64)
    for first in range(grid * warps):
        seen[first::grid * warps] += 1
    assert (seen == 1).all()


def test_the_steps_shape_is_one_the_kernel_takes(tile_lib):
    """The co-resident block is whole warps, within the kernel's
    ``__launch_bounds__`` (the standalone block), and leaves the SM room."""
    threads = tile_lib.host_diff_threads(1)
    assert threads % 32 == 0 and 32 <= threads <= tile_lib.host_diff_threads(0)
    assert 1 <= tile_lib.host_diff_beside_blocks() and \
        tile_lib.host_diff_beside_blocks() * threads <= tile_lib.host_diff_threads(0)


def test_the_coresident_launch_takes_cuda_tensors_only(monkeypatch):
    """``divergence_beside`` has no plain version: CPU tensors, or outputs
    on another device than the inputs, are refused before the library is
    built."""
    def refuse():
        raise AssertionError("a refused call reached the kernel library")

    monkeypatch.setattr(cuda_lib, "build_kernels", refuse)
    dig, pres = one_word_cases()
    d, p = torch.from_numpy(dig.view(np.int32)), torch.from_numpy(pres)
    masks, counts = torch.empty((2, 17), dtype=torch.bool), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        dispatch.divergence_beside(d, p, masks, counts)
    with pytest.raises(ValueError):
        dispatch.divergence_beside(d, p, masks.to("meta"), counts)


# ------------------------------------------------------------ the CPU route

@pytest.mark.parametrize("r", REPLICAS)
@pytest.mark.parametrize("n", KEYS[:-1])
def test_cpu_divergence_is_the_plain_predicate(r, n):
    dig, pres = replicas(7 * r + n, r, n)
    d, p = torch.from_numpy(dig.view(np.int32)), torch.from_numpy(pres)
    cuda_lib.reset_launch_counts()
    masks, counts = dispatch.divergence(d, p)
    want = t_diff.divergence_vs_ref(d, p, d[0:1], p[0:1])
    assert torch.equal(masks, want)
    assert counts.dtype == torch.int32 and torch.equal(counts, want.sum(dim=1, dtype=torch.int32))
    assert torch.equal(t_diff.divergence_masks(d, p), want)
    np.testing.assert_array_equal(masks.numpy(), jax_diff.divergence_masks_np(dig, pres))
    assert cuda_lib.LAUNCHES["diff"] == 0


def test_cpu_divergence_builds_and_launches_nothing(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(cuda_lib, "build_kernels", refuse)
    dig, pres = one_word_cases()
    masks, counts = dispatch.divergence(torch.from_numpy(dig.view(np.int32)),
                                        torch.from_numpy(pres))
    assert counts.tolist() == [0, 16]
    empty = dispatch.divergence(torch.zeros((3, 0, 8), dtype=torch.int32),
                                torch.zeros((3, 0), dtype=torch.bool))
    assert empty[0].shape == (3, 0) and empty[1].tolist() == [0, 0, 0]


def test_divergence_refuses_mixed_devices():
    d = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        dispatch.divergence(d, torch.ones((2, 4), dtype=torch.bool, device="meta"))


def test_forward_takes_masks_and_counts_from_one_call(monkeypatch):
    calls = []
    real = dispatch.divergence

    def counted(d, p):
        calls.append(d.shape)
        return real(d, p)

    monkeypatch.setattr(te, "divergence", counted)
    dig, pres = replicas(5, 3, 64)
    blocks = np.zeros((64, 1, 16), np.uint32)
    root, masks, counts = te.anti_entropy_forward(blocks, np.ones(64, np.int32), dig, pres,
                                                  device="cpu")
    assert calls == [(3, 64, 8)]
    want = jax_diff.divergence_masks_np(dig, pres)
    np.testing.assert_array_equal(masks.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), want.sum(axis=1, dtype=np.int32))
