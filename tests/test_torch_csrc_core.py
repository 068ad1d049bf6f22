"""The CUDA kernels' round math and path walk, checked on the host.

``merklekv_tpu_torch/csrc/sha256_core.cuh`` and ``merkle_paths.cuh`` build as
plain host C++ when no CUDA compiler is involved (their functions lose their
``__device__`` keyword, ``rotr`` its funnel shift, and the arrival protocol's
fences and atomics become plain loads and stores). This test compiles them
with the host C++ compiler into a small library and holds against
``hashlib``:

- the compression, the node hash (with the folded padding-block constants)
  and the IV, and the constant tables against the torch package's fold;
- the fused path-rehash walk: the k walkers of one batch run one step at a
  time in a random interleaving from a seed (every order in which walkers
  reach a shared parent occurs), with the arrival counters emulated
  sequentially; every level must equal hashlib's tree, exactly one walker
  must reach the root, and the counters must be zero again afterwards. This
  catches a slip in the sibling test, the run merge or the arrival protocol;
  it does not prove the memory fences, which only the card can test;
- the promotion-chain walk against the golden reference tree.

Equality is exact: a hash is right or it is wrong. The kernels themselves
run only on the card (``chip_smoke.py`` and the ``cuda``-marked tests).
"""

import ctypes
import hashlib
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from merklekv_tpu_torch.merkle.cpu import build_levels as golden_levels
from merklekv_tpu_torch.ops.sha256 import _IV, _K, _NODE_PAD_KW

CSRC = Path(__file__).resolve().parents[1] / "merklekv_tpu_torch" / "csrc"

HARNESS = r"""
#include <string.h>
#include <random>
#include <vector>
#include "sha256_core.cuh"
#include "merkle_paths.cuh"
extern "C" void host_iv(uint32_t* s) { mkv_iv(s); }
extern "C" void host_compress(uint32_t* s, const uint32_t* block) {
  uint32_t w[16]; memcpy(w, block, sizeof w); mkv_compress(s, w);
}
extern "C" void host_node(const uint32_t* msg16, uint32_t* out) {
  uint32_t w[16]; memcpy(w, msg16, sizeof w);
  mkv_iv(out); mkv_compress(out, w); mkv_compress_node_pad(out);
}
static MkvLevels levels_of(uint32_t* const* rows, int32_t depth) {
  MkvLevels L;
  for (int32_t l = 0; l < depth; ++l) L.rows[l] = rows[l];
  L.depth = depth;
  return L;
}
// The fused kernel's k threads, one step (a leaf hash or one level up) at a
// time, in a random interleaving. Returns how many walkers reached the root.
extern "C" int host_path_rehash(uint32_t* const* rows, int32_t depth, int32_t* ctr,
                                const uint32_t* blocks, const int32_t* nblocks,
                                int32_t nblk, const int32_t* pos, int32_t k,
                                uint64_t seed) {
  const MkvLevels L = levels_of(rows, depth);
  std::vector<MkvWalker> w(k);
  std::vector<char> begun(k, 0);
  std::vector<int32_t> live(k);
  for (int32_t i = 0; i < k; ++i) live[i] = i;
  std::mt19937_64 rng(seed);
  int roots = 0;
  while (!live.empty()) {
    const size_t j = rng() % live.size();
    const int32_t i = live[j];
    int r = kMkvClimb;
    if (!begun[i]) {
      mkv_path_begin(w[i], L, blocks + int64_t{16} * nblk * i, nblocks[i], nblk, pos, i);
      begun[i] = 1;
      if (depth == 1) r = kMkvRoot;
    } else {
      r = mkv_path_step(w[i], L, ctr, pos, k);
    }
    if (r != kMkvClimb) {
      roots += r == kMkvRoot;
      live[j] = live.back();
      live.pop_back();
    }
  }
  return roots;
}
// The chain kernel's two phases: the per-level loads, then the walk.
extern "C" void host_chain(uint32_t* const* rows, int32_t depth, int64_t n, int32_t nlev,
                           uint32_t* out) {
  const MkvLevels L = levels_of(rows, depth);
  uint32_t prev[kMkvMaxLevels * 8] = {0};
  for (int32_t l = 1; l < nlev; ++l) mkv_chain_prev(L, n, l, prev);
  mkv_chain_walk(rows[0] + 8 * (n - 1), prev, n, nlev, out);
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the round-math harness")
    d = tmp_path_factory.mktemp("csrc_core")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib_path = d / "libcore.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
         str(src), "-o", str(lib_path)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    ptr = ctypes.c_void_p
    lib.host_iv.argtypes = [ptr]
    lib.host_compress.argtypes = [ptr, ptr]
    lib.host_node.argtypes = [ptr, ptr]
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.host_path_rehash.argtypes = [ptr, i32, ptr, ptr, ptr, i32, ptr, i32, ctypes.c_uint64]
    lib.host_path_rehash.restype = ctypes.c_int
    lib.host_chain.argtypes = [ptr, i32, i64, i32, ptr]
    return lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _pad(msg: bytes) -> np.ndarray:
    padded = msg + b"\x80" + b"\x00" * ((55 - len(msg)) % 64) + (8 * len(msg)).to_bytes(8, "big")
    return np.frombuffer(padded, ">u4").astype(np.uint32)


def _c_table(name: str) -> list[int]:
    text = (CSRC / "sha256_core.cuh").read_text()
    body = re.search(name + r"\[64\] = \{(.*?)\};", text, re.S).group(1)
    return [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", body)]


def test_constant_tables_match_python_fold():
    """K and the padding block's folded K+W in the CUDA source equal the
    torch package's tables (which the plain versions use), exactly."""
    assert _c_table("kSha256K") == [int(k) for k in _K]
    assert _c_table("kNodePadKW") == list(_NODE_PAD_KW)


def test_iv(core):
    s = np.zeros(8, np.uint32)
    core.host_iv(_p(s))
    np.testing.assert_array_equal(s, _IV)


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 100, 200])
def test_compress_chain_vs_hashlib(core, length):
    """Random bytes (top bits set in many words), one to four blocks."""
    msg = np.random.RandomState(length).bytes(length)
    words = _pad(msg)
    s = np.ascontiguousarray(_IV.copy())
    for b in range(len(words) // 16):
        blk = np.ascontiguousarray(words[16 * b : 16 * b + 16])
        core.host_compress(_p(s), _p(blk))
    assert s.astype(">u4").tobytes() == hashlib.sha256(msg).digest()


def test_node_hash_vs_hashlib(core):
    rng = np.random.RandomState(7)
    for _ in range(64):
        msg = rng.bytes(64)
        w = np.frombuffer(msg, ">u4").astype(np.uint32)
        out = np.zeros(8, np.uint32)
        core.host_node(_p(np.ascontiguousarray(w)), _p(out))
        assert out.astype(">u4").tobytes() == hashlib.sha256(msg).digest()


# ------------------------------------------------------------ the path walk

PATH_C = 64


def _digest(d: bytes) -> np.ndarray:
    return np.frombuffer(d, ">u4").astype(np.uint32)


def _hashlib_levels(leaves: list[bytes]) -> list[list[bytes]]:
    """Every level of the full binary tree over a power-of-two leaf list."""
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        levels.append([hashlib.sha256(cur[i] + cur[i + 1]).digest()
                       for i in range(0, len(cur), 2)])
    return levels


def _as_rows(levels: list[list[bytes]]) -> list[np.ndarray]:
    return [np.ascontiguousarray(np.stack([_digest(d) for d in lv])) for lv in levels]


def _row_ptrs(rows: list[np.ndarray]):
    return (ctypes.c_void_p * len(rows))(*[r.ctypes.data for r in rows])


PATH_SETS = {
    "k1": lambda rng: [37],
    "sibling_pair": lambda rng: [12, 13],
    "first_and_last": lambda rng: [0, PATH_C - 1],
    "one_subtree": lambda rng: list(range(16, 32)),
    "every_leaf": lambda rng: list(range(PATH_C)),
    "random_23": lambda rng: sorted(rng.choice(PATH_C, size=23, replace=False)),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(PATH_SETS))
def test_path_walk_in_random_interleavings_vs_hashlib(core, case, seed):
    rng = np.random.RandomState(seed)
    leaves = [hashlib.sha256(rng.bytes(8)).digest() for _ in range(PATH_C)]
    rows = _as_rows(_hashlib_levels(leaves))
    pos = np.asarray(PATH_SETS[case](rng), np.int32)
    k = len(pos)
    msgs = [rng.bytes(int(rng.randint(0, 130))) for _ in range(k)]
    padded = [_pad(m) for m in msgs]
    nblk = max(len(p) // 16 for p in padded)
    blocks = np.zeros((k, nblk, 16), np.uint32)
    for i, p in enumerate(padded):
        blocks[i].reshape(-1)[: len(p)] = p
    nblocks = np.array([len(p) // 16 for p in padded], np.int32)
    ctr = np.zeros(PATH_C - 1, np.int32)

    roots = core.host_path_rehash(_row_ptrs(rows), len(rows), _p(ctr), _p(blocks),
                                  _p(nblocks), nblk, _p(pos), k, seed)
    for i, m in zip(pos, msgs):
        leaves[i] = hashlib.sha256(m).digest()
    want = _as_rows(_hashlib_levels(leaves))
    for lvl, (got, exp) in enumerate(zip(rows, want)):
        np.testing.assert_array_equal(got, exp, err_msg=f"{case}: level {lvl}")
    assert roots == 1
    assert not ctr.any()


@pytest.mark.parametrize("n", [1, 2, 3, 33, PATH_C - 1, PATH_C])
def test_promotion_chain_walk_vs_golden_tree(core, n):
    rng = np.random.RandomState(n)
    live = [hashlib.sha256(rng.bytes(8)).digest() for _ in range(n)]
    rows = _as_rows(_hashlib_levels(live + [bytes(32)] * (PATH_C - n)))
    golden = golden_levels(live)
    out = np.zeros((len(golden), 8), np.uint32)
    core.host_chain(_row_ptrs(rows), len(rows), n, len(golden), _p(out))
    assert [r.astype(">u4").tobytes() for r in out] == [lv[-1] for lv in golden]
