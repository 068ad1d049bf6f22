"""The CUDA kernels' round math and path walk, checked on the host.

``merklekv_tpu_torch/csrc/sha256_core.cuh`` and ``merkle_paths.cuh`` build as
plain host C++ when no CUDA compiler is involved (their functions lose their
``__device__`` keyword, ``rotr`` its funnel shift, and the path rehash's
copies, fences and atomics become plain loads and stores). This test
compiles them with the host C++ compiler into a small library and holds
against ``hashlib``:

- the compression, the node hash (with the folded padding-block constants)
  and the IV, each in both ways of adding (plain ``+`` and the FMA form's
  multiply-add by one) and with the message block unrolled or rolled, and
  the constant tables against the torch package's fold;
- the path rehash's phases (``mkv_path_*``: the cut, the walk of each chunk
  in its block, the one arrival per block, the last block's shared nodes
  and top levels), run for every block in a random order of blocks, phases
  and threads, with shared memory starting as garbage, at several chunk
  widths and top levels so that small trees are cut into many chunks:
  every level must equal hashlib's tree (or a full rebuild, for every
  position subset of the small trees), exactly one block must finish, every
  touched node must be hashed exactly once, and the scratch must be zero
  again. This catches a slip in the cut, the sibling test, the run merge,
  the owner test or the bitmap; it does not prove the memory ordering,
  which only the card can test;
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
#include <algorithm>
#include <random>
#include <set>
#include <utility>
#include <vector>
// Every node hash of the path rehash, as (level, node): checked for
// exactly-once below.
static std::vector<std::pair<int32_t, int64_t>> g_hashed;
#define MKV_PATH_ON_HASH(level, node) g_hashed.emplace_back((level), (node))
// Arrival groups of 4 blocks instead of 128, so that small batches cut into
// many chunks also cross group boundaries.
#define MKV_PATH_GROUP 4
#include "sha256_core.cuh"
#include "merkle_paths.cuh"
extern "C" void host_iv(uint32_t* s) { mkv_iv(s); }
// fma_one: 0 for the plain form (MkvAluAdd), else the FMA form's multiplier
// (MkvFmaAdd{1}), handed in at run time as the kernels take it; rolled:
// mkv_compress_rolled in place of mkv_compress.
template <class Add>
static void compress_as(uint32_t* s, uint32_t* w, int rolled, Add add) {
  if (rolled) mkv_compress_rolled(s, w, add); else mkv_compress(s, w, add);
}
extern "C" void host_compress(uint32_t* s, const uint32_t* block, uint32_t fma_one,
                              int rolled) {
  uint32_t w[16]; memcpy(w, block, sizeof w);
  if (fma_one) compress_as(s, w, rolled, MkvFmaAdd{fma_one});
  else compress_as(s, w, rolled, MkvAluAdd{});
}
extern "C" void host_node(const uint32_t* msg16, uint32_t* out, uint32_t fma_one, int rolled) {
  uint32_t w[16]; memcpy(w, msg16, sizeof w);
  mkv_iv(out);
  if (fma_one) {
    const MkvFmaAdd add{fma_one};
    compress_as(out, w, rolled, add); mkv_compress_node_pad(out, add);
  } else {
    compress_as(out, w, rolled, MkvAluAdd{}); mkv_compress_node_pad(out);
  }
}
static MkvLevels levels_of(uint32_t* const* rows, int32_t depth) {
  MkvLevels L;
  for (int32_t l = 0; l < depth; ++l) L.rows[l] = rows[l];
  L.depth = depth;
  return L;
}
// One thread block of path_rehash_kernel: its shared memory, its walkers,
// and where it is in the kernel's sequence of phases.
struct HostBlock {
  MkvPathBlock B;
  MkvPathShared S;
  MkvPathWalker w[kMkvPathThreads];
  MkvCutList cl;
  bool reload = false;
  int phase = 0, level = 0;
};
// The kernel's G blocks: each step runs one phase of a block picked at
// random, its 128 threads in a random order (a barrier between phases, as
// on the card). Each block has a random pace, some a thousand times slower
// than others, so a block may arrive long after its neighbours. Returns how
// many blocks finished the tree (1 expected).
static int simulate(const MkvLevels& L, int32_t* scratch, const uint32_t* blocks,
                    const int32_t* nblocks, int32_t nblk, const int32_t* pos, int32_t k,
                    int32_t width, int32_t top, std::mt19937_64& rng) {
  const int32_t groups = (k + width - 1) / width;
  std::vector<HostBlock> bl(groups);
  std::vector<int32_t> live(groups), order(kMkvPathThreads);
  for (int32_t b = 0; b < groups; ++b) {
    bl[b].B = mkv_path_block(k, width, top, L.depth, b);
    memset(&bl[b].S, 0xA5, sizeof(MkvPathShared));  // shared memory starts undefined
    live[b] = b;
  }
  for (int32_t t = 0; t < kMkvPathThreads; ++t) order[t] = t;
  auto threads = [&](auto fn) {
    std::shuffle(order.begin(), order.end(), rng);
    for (int32_t t : order) fn(t);
  };
  std::vector<double> pace(groups);
  std::lognormal_distribution<double> spread(0.0, 2.5);
  for (double& x : pace) x = spread(rng);
  int lasts = 0;
  while (!live.empty()) {
    std::vector<double> weight(live.size());
    for (size_t i = 0; i < live.size(); ++i) weight[i] = pace[live[i]];
    const size_t j = std::discrete_distribution<size_t>(weight.begin(), weight.end())(rng);
    HostBlock& h = bl[live[j]];
    MkvPathShared& S = h.S;
    const MkvPathBlock& B = h.B;
    bool done = false;
    switch (h.phase) {
      case 0:
        threads([&](int32_t t) { mkv_path_load(S, B, L, pos, nblocks, t); });
        h.phase = 1;
        break;
      case 1: threads([&](int32_t t) { mkv_path_score(S, B, t); }); h.phase = 2; break;
      case 2:
        threads([&](int32_t t) {
          mkv_path_begin(S, B, h.w[t], blocks, nblk, scratch, t);
        });
        h.phase = 3;
        h.level = 1;
        break;
      case 3: {
        bool any = false;
        for (int32_t t = 0; t < kMkvPathThreads; ++t) any = any || h.w[t].active;
        if (any && h.level < top) {
          const int32_t l = h.level++;
          threads([&](int32_t t) { mkv_path_level(S, B, h.w[t], l, t); });
        } else {
          h.phase = 4;
        }
        break;
      }
      case 4:  // the group's arrival
        S.last = mkv_path_arrive(S, B, h.w[0], scratch);
        done = !S.last;
        h.phase = 5;
        break;
      case 5:
        h.cl = mkv_path_group_cuts(B);
        threads([&](int32_t t) { mkv_path_cuts(S, B, scratch, h.cl, t); });
        if (B.ngroups == 1) threads([&](int32_t t) { mkv_path_top_load(S, B, scratch, t); });
        h.reload = B.ngroups > 1 || S.lmin < top;
        h.level = S.lmin;
        h.phase = 6;
        break;
      case 6:
        if (h.level < top) {
          const int32_t l = h.level++;
          threads([&](int32_t t) { mkv_path_shared_level(S, B, scratch, h.cl, l, t); });
        } else if (B.ngroups > 1) {  // the arrival of all groups
          S.last = mkv_path_arrive_all(S, B, scratch);
          done = !S.last;
          h.phase = 7;
        } else {
          h.phase = 9;
        }
        break;
      case 7:
        h.cl = mkv_path_boundary_cuts(B);
        threads([&](int32_t t) { mkv_path_cuts(S, B, scratch, h.cl, t); });
        h.level = S.lmin;
        h.phase = 8;
        break;
      case 8:
        if (h.level < top) {
          const int32_t l = h.level++;
          threads([&](int32_t t) { mkv_path_shared_level(S, B, scratch, h.cl, l, t); });
        } else {
          h.phase = 9;
        }
        break;
      case 9:
        if (h.reload) threads([&](int32_t t) { mkv_path_top_load(S, B, scratch, t); });
        ++lasts;
        h.level = top;
        h.phase = 10;
        break;
      case 10:
        if (h.level < L.depth) {
          const int32_t l = h.level++;
          threads([&](int32_t t) { mkv_path_top_level(S, B, l, t); });
        } else {
          threads([&](int32_t t) { mkv_path_clear(B, scratch, t); });
          done = true;
        }
        break;
    }
    if (done) {
      live[j] = live.back();
      live.pop_back();
    }
  }
  return lasts;
}
// Exactly once: the hashes were distinct (level, node) pairs, and were the
// touched internal nodes.
static bool hashed_once(const int32_t* pos, int32_t k, int32_t depth) {
  std::set<std::pair<int32_t, int64_t>> want, got(g_hashed.begin(), g_hashed.end());
  std::set<int64_t> cur(pos, pos + k);
  for (int32_t l = 1; l < depth; ++l) {
    std::set<int64_t> up;
    for (int64_t n : cur) up.insert(n >> 1);
    for (int64_t n : up) want.emplace(l, n);
    cur.swap(up);
  }
  return got.size() == g_hashed.size() && got == want;
}
// One batch in a random order of blocks, phases and threads. Returns how
// many blocks arrived last (1 expected), or -1 if a node was hashed twice
// or a touched node not at all.
extern "C" int host_path_rehash(uint32_t* const* rows, int32_t depth, int32_t* scratch,
                                const uint32_t* blocks, const int32_t* nblocks,
                                int32_t nblk, const int32_t* pos, int32_t k, int32_t width,
                                int32_t top, uint64_t seed) {
  std::mt19937_64 rng(seed);
  g_hashed.clear();
  const int lasts = simulate(levels_of(rows, depth), scratch, blocks, nblocks, nblk, pos, k,
                             width, top, rng);
  return hashed_once(pos, k, depth) ? lasts : -1;
}
// Every non-empty position subset of a 2^(depth-1)-leaf tree (or `sample`
// random ones) through simulate(), each against a full rebuild of the tree
// with mkv_node_hash, the scratch zero again, one last block and every
// touched node hashed once. Returns the number of subsets that failed and
// the first one's mask.
extern "C" int host_subsets(int32_t depth, int32_t width, int32_t top, int32_t sample,
                            uint64_t seed, uint64_t* first_bad) {
  const int32_t cap = 1 << (depth - 1);
  std::mt19937_64 rng(seed);
  std::vector<std::vector<uint32_t>> base(depth), rows(depth), want(depth);
  base[0].resize(8 * cap);
  for (auto& x : base[0]) x = static_cast<uint32_t>(rng());
  for (int32_t l = 1; l < depth; ++l) {
    base[l].resize(8 * (cap >> l));
    for (int32_t n = 0; n < (cap >> l); ++n) {
      mkv_node_hash(&base[l - 1][16 * n], &base[l - 1][16 * n + 8], &base[l][8 * n]);
    }
  }
  std::vector<int32_t> scratch(4 * cap + 64, 0), pos, nblocks(cap, 1);
  std::vector<uint32_t> blocks(16 * cap);
  const uint64_t subsets = cap >= 64 ? ~uint64_t{0} : (uint64_t{1} << cap) - 1;
  const uint64_t runs = sample ? static_cast<uint64_t>(sample) : subsets;
  int bad = 0;
  for (uint64_t r = 0; r < runs; ++r) {
    uint64_t mask = sample ? 1 + rng() % subsets : r + 1;
    pos.clear();
    for (int32_t i = 0; i < cap; ++i) {
      if (mask >> i & 1) pos.push_back(i);
    }
    const int32_t k = static_cast<int32_t>(pos.size());
    for (auto& x : blocks) x = static_cast<uint32_t>(rng());
    rows = base;
    want = base;
    for (int32_t i = 0; i < k; ++i) {
      uint32_t w[16];
      memcpy(w, &blocks[16 * i], sizeof w);
      uint32_t* leaf = &want[0][8 * pos[i]];
      mkv_iv(leaf);
      mkv_compress(leaf, w);
    }
    for (int32_t l = 1; l < depth; ++l) {
      for (int32_t n = 0; n < (cap >> l); ++n) {
        mkv_node_hash(&want[l - 1][16 * n], &want[l - 1][16 * n + 8], &want[l][8 * n]);
      }
    }
    uint32_t* ptrs[kMkvMaxLevels];
    for (int32_t l = 0; l < depth; ++l) ptrs[l] = rows[l].data();
    g_hashed.clear();
    const int lasts = simulate(levels_of(ptrs, depth), scratch.data(), blocks.data(),
                               nblocks.data(), 1, pos.data(), k, width, top, rng);
    bool ok = lasts == 1 && rows == want && hashed_once(pos.data(), k, depth);
    for (int32_t x : scratch) ok = ok && x == 0;
    if (!ok) {
      if (!bad) *first_bad = mask;
      ++bad;
      std::fill(scratch.begin(), scratch.end(), 0);
    }
  }
  return bad;
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
    u32 = ctypes.c_uint32
    lib.host_compress.argtypes = [ptr, ptr, u32, ctypes.c_int]
    lib.host_node.argtypes = [ptr, ptr, u32, ctypes.c_int]
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    u64 = ctypes.c_uint64
    lib.host_path_rehash.argtypes = [ptr, i32, ptr, ptr, ptr, i32, ptr, i32, i32, i32, u64]
    lib.host_path_rehash.restype = ctypes.c_int
    lib.host_subsets.argtypes = [i32, i32, i32, i32, u64, ptr]
    lib.host_subsets.restype = ctypes.c_int
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


# How the compression adds (csrc/sha256_core.cuh): 0 is plain `+`
# (MkvAluAdd), 1 the FMA form's multiply-add by one (MkvFmaAdd); and
# whether its rounds 16-63 run as a loop (mkv_compress_rolled).
FORMS = {"alu": 0, "fma": 1}
ROLLED = {"unrolled": 0, "rolled": 1}


@pytest.mark.parametrize("rolled", sorted(ROLLED))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("fill", ["random", "ones"])
@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 100, 200, 1015, 1016, 1079])
def test_compress_chain_vs_hashlib(core, length, fill, form, rolled):
    """Random bytes (top bits set in many words), or every byte 0xFF so that
    every message word is 0xFFFFFFFF and the adds carry; one to four blocks,
    16 and 17 (the 1 KB YCSB leaf's count)."""
    msg = np.random.RandomState(length).bytes(length) if fill == "random" else b"\xff" * length
    words = _pad(msg)
    s = np.ascontiguousarray(_IV.copy())
    for b in range(len(words) // 16):
        blk = np.ascontiguousarray(words[16 * b : 16 * b + 16])
        core.host_compress(_p(s), _p(blk), FORMS[form], ROLLED[rolled])
    assert s.astype(">u4").tobytes() == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("rolled", sorted(ROLLED))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("fill", ["random", "ones"])
def test_node_hash_vs_hashlib(core, fill, form, rolled):
    """The message block and the folded padding block, on random children
    or on children of 0xFFFFFFFF words."""
    rng = np.random.RandomState(7)
    for _ in range(64 if fill == "random" else 1):
        msg = rng.bytes(64) if fill == "random" else b"\xff" * 64
        w = np.frombuffer(msg, ">u4").astype(np.uint32)
        out = np.zeros(8, np.uint32)
        core.host_node(_p(np.ascontiguousarray(w)), _p(out), FORMS[form], ROLLED[rolled])
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
    # Dense at the left end, sparse to the right: chunks of very different
    # spans, cuts at low and high common ancestors.
    "zipf": lambda rng: sorted(set(np.minimum(rng.zipf(1.3, size=60), PATH_C) - 1)),
    "one_per_4_leaf_subtree": lambda rng: [4 * j + rng.randint(4) for j in range(PATH_C // 4)],
}
# (chunk width, top level): the kernel's own width with the top as wide as
# it may be, and narrow chunks and low or high tops that make a 64-leaf
# tree cut into many chunks, with shared nodes below the top.
PATH_SHAPES = [(64, 1), (2, 1), (2, 4), (4, 2), (4, 6), (8, 3), (2, 6)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(PATH_SETS))
def test_path_walk_in_random_interleavings_vs_hashlib(core, case, seed):
    """The path rehash's phases for every block and thread in a random order
    (``csrc/merkle_paths.cuh``), at several chunk widths and top levels:
    every level equals hashlib's tree, one block finishes, each touched node
    is hashed once, and the scratch is zero again."""
    rng = np.random.RandomState(seed)
    leaves = [hashlib.sha256(rng.bytes(8)).digest() for _ in range(PATH_C)]
    pos = np.asarray(PATH_SETS[case](rng), np.int32)
    k = len(pos)
    msgs = [rng.bytes(int(rng.randint(0, 130))) for _ in range(k)]
    padded = [_pad(m) for m in msgs]
    nblk = max(len(p) // 16 for p in padded)
    blocks = np.zeros((k, nblk, 16), np.uint32)
    for i, p in enumerate(padded):
        blocks[i].reshape(-1)[: len(p)] = p
    nblocks = np.array([len(p) // 16 for p in padded], np.int32)
    new_leaves = list(leaves)
    for i, m in zip(pos, msgs):
        new_leaves[i] = hashlib.sha256(m).digest()
    want = _as_rows(_hashlib_levels(new_leaves))
    for width, top in PATH_SHAPES:
        rows = _as_rows(_hashlib_levels(leaves))
        scratch = np.zeros(4 * PATH_C + 64, np.int32)
        lasts = core.host_path_rehash(_row_ptrs(rows), len(rows), _p(scratch), _p(blocks),
                                      _p(nblocks), nblk, _p(pos), k, width, top, seed)
        for lvl, (got, exp) in enumerate(zip(rows, want)):
            np.testing.assert_array_equal(got, exp, err_msg=f"{case} {width} {top}: level {lvl}")
        assert lasts == 1, (case, width, top, lasts)
        assert not scratch.any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["random", "every_leaf", "zipf", "one_per_4_leaf_subtree"])
def test_path_walk_in_arrival_groups_vs_hashlib(core, case, seed):
    """Many arrival groups (of 4 blocks here), so that the last block of all
    re-hashes the nodes over the groups' boundary cuts: 1024 leaves cut at
    width 2 into up to 512 chunks, at several top levels, against hashlib's
    tree."""
    c = 1024
    rng = np.random.RandomState(seed)
    pos = {
        "random": lambda: sorted(rng.choice(c, size=700, replace=False)),
        "every_leaf": lambda: list(range(c)),
        "zipf": lambda: sorted(set(np.minimum(rng.zipf(1.1, size=2000), c) - 1)),
        "one_per_4_leaf_subtree": lambda: [4 * j + rng.randint(4) for j in range(c // 4)],
    }[case]()
    pos = np.asarray(pos, np.int32)
    k = len(pos)
    leaves = [hashlib.sha256(rng.bytes(8)).digest() for _ in range(c)]
    msgs = [rng.bytes(int(rng.randint(0, 56))) for _ in range(k)]  # one block each
    blocks = np.ascontiguousarray(np.stack([_pad(m) for m in msgs]).reshape(k, 1, 16))
    nblocks = np.ones(k, np.int32)
    new_leaves = list(leaves)
    for i, m in zip(pos, msgs):
        new_leaves[i] = hashlib.sha256(m).digest()
    want = _as_rows(_hashlib_levels(new_leaves))
    for width, top in [(2, 3), (2, 5), (2, 9), (4, 3), (64, 4)]:  # C >> top <= 128
        rows = _as_rows(_hashlib_levels(leaves))
        scratch = np.zeros(4 * c + 64, np.int32)
        lasts = core.host_path_rehash(_row_ptrs(rows), len(rows), _p(scratch), _p(blocks),
                                      _p(nblocks), 1, _p(pos), k, width, top, seed)
        for lvl, (got, exp) in enumerate(zip(rows, want)):
            np.testing.assert_array_equal(got, exp, err_msg=f"{case} {width} {top}: level {lvl}")
        assert lasts == 1, (case, width, top, lasts)
        assert not scratch.any()


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6])
def test_path_walk_every_subset_of_small_trees(core, depth):
    """Every non-empty position subset of the trees of 2, 4 and 8 leaves at
    every top level and chunk widths 2, 4 and 64; of 16 leaves at width 2
    with the lowest and a high top (other shapes sampled); random subsets of
    32 and 64 leaves; each against a full rebuild of the tree."""
    levels = depth + 1
    tops = range(1, levels)
    for top in tops:
        for width in (2, 4, 64):
            every = depth <= 3 or (depth == 4 and width == 2 and top in (1, 3))
            sample = 0 if every else 2_000 if depth == 4 else 20_000 // (len(tops) * 3)
            first = ctypes.c_uint64(0)
            bad = core.host_subsets(levels, width, top, sample, depth * 100 + top,
                                    ctypes.byref(first))
            assert bad == 0, (f"{bad} subsets failed at width {width}, top {top}; "
                              f"first mask {first.value:#x}")


def test_path_group_matches_the_wrappers_scratch_sizing(tmp_path):
    """``ops/merkle_paths.py`` sizes the kernel's scratch with one counter per
    arrival group of ``cuda_lib.PATH_GROUP`` blocks: it must be the header's
    ``kMkvGroup`` as the card builds it (no ``MKV_PATH_GROUP`` given)."""
    from merklekv_tpu_torch.ops import cuda_lib

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src, exe = tmp_path / "group.cpp", tmp_path / "group"
    src.write_text('#include <stdio.h>\n#include "merkle_paths.cuh"\n'
                   'int main() { printf("%d\\n", kMkvGroup); return 0; }\n')
    subprocess.run([cxx, "-std=c++17", f"-I{CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    assert int(out) == cuda_lib.PATH_GROUP


@pytest.mark.parametrize("n", [1, 2, 3, 33, PATH_C - 1, PATH_C])
def test_promotion_chain_walk_vs_golden_tree(core, n):
    rng = np.random.RandomState(n)
    live = [hashlib.sha256(rng.bytes(8)).digest() for _ in range(n)]
    rows = _as_rows(_hashlib_levels(live + [bytes(32)] * (PATH_C - n)))
    golden = golden_levels(live)
    out = np.zeros((len(golden), 8), np.uint32)
    core.host_chain(_row_ptrs(rows), len(rows), n, len(golden), _p(out))
    assert [r.astype(">u4").tobytes() for r in out] == [lv[-1] for lv in golden]
