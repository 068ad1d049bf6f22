// The N-replica diff's per-key predicate and the warp-tile arithmetic of
// diff_kernel (diff_kernels.cu).
//
// A warp takes the keys of a replica in tiles of 128. Its 32 lanes read a
// tile's 4 KB of digests as 8 loads of 16 bytes each, load j of lane l
// reading the tile's half-digest h = 32 j + l (key h / 2, words 4 (h % 2)
// .. + 3), so each load of the warp is 512 contiguous bytes. A ballot per
// load says which halves differ from replica 0's; from the 8 ballots lane l
// takes the digest bits of its own four keys 4 l .. 4 l + 3, whose presence
// bytes it reads as one word and whose mask bytes it writes as one word.
// The warp's count of diverging keys is a popcount of four ballots.
//
// Under a host C++ compiler this builds as plain host code, so the
// predicate and the ballot arithmetic are checked against the numpy twin
// without a GPU (tests/test_torch_diff_kernel.py emulates a warp's ballots
// over its 32 lanes).

#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define MKV_DIFF_FN __host__ __device__ __forceinline__
#else
#define MKV_DIFF_FN static inline
#endif

// Keys of a warp's tile (4 a lane), and 16-byte digest loads a lane makes
// per replica and tile (32 lanes x 8 loads = 256 halves of 128 digests).
constexpr int kMkvDiffTileKeys = 128;
constexpr int kMkvDiffLoads = 8;
// Threads a block of the standalone launch (diff_kernel's
// __launch_bounds__: the most any launch takes), and the co-resident launch's
// blocks an SM and threads a block: one block of 128 threads an SM, beside
// the leaf hash (tools/torch_diff_beside.py, PERF.md).
constexpr int kMkvDiffThreads = 256;
constexpr int kMkvDiffBesideBlocks = 1;
constexpr int kMkvDiffBesideThreads = 128;

// Threads a block of diff_kernel's launch, standalone or beside.
MKV_DIFF_FN int mkv_diff_threads(bool beside) {
  return beside ? kMkvDiffBesideThreads : kMkvDiffThreads;
}

// Blocks of diff_kernel's grid over n keys (whole warps, each striding over
// the tiles), never more than the tiles need. Standalone: as many as the
// card holds at once, `resident` an SM (the occupancy calculator's count;
// at least 1) times `sms`. Beside (a diff that runs beside another kernel
// on each SM and leaves it the rest of the SM's registers):
// kMkvDiffBesideBlocks an SM.
MKV_DIFF_FN int64_t mkv_diff_grid(int64_t n, int sms, int resident, bool beside) {
  const int64_t tiles = (n + kMkvDiffTileKeys - 1) / kMkvDiffTileKeys;
  const int64_t warps = mkv_diff_threads(beside) / 32;
  const int64_t wanted = (tiles + warps - 1) / warps;
  const int64_t a_sm = beside ? kMkvDiffBesideBlocks : (resident > 0 ? resident : 1);
  const int64_t cap = static_cast<int64_t>(sms) * a_sm;
  return wanted < cap ? wanted : cap;
}

// THE divergence predicate (merkle/diff.py::divergence_vs_ref): a key
// diverges from the reference iff presence differs, or both are present
// and any of the 8 words of their digests differs.
MKV_DIFF_FN bool mkv_key_diverges(bool present, bool ref_present, bool digest_differs) {
  return present != ref_present || (present && ref_present && digest_differs);
}

// Whether half a digest (words x, y, z, w) differs from the reference's,
// in any bit of any word: uint4 on the card, any struct of four uint32_t
// on the host.
template <class Q>
MKV_DIFF_FN bool mkv_half_differs(const Q& a, const Q& b) {
  return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0u;
}

// The tile key that load j of lane `lane` reads half of.
MKV_DIFF_FN int mkv_diff_half_key(int j, uint32_t lane) {
  return 16 * j + static_cast<int>(lane >> 1);
}

// Lane `lane`'s four keys' digest bits, one a byte (0 or 1: byte i is key
// 4 lane + i of the tile), from the tile's ballots: bit l of ballot[j] is
// set iff lane l's half of load j differs. Key q's halves are bits
// 2 (q % 16) and 2 (q % 16) + 1 of ballot[q / 16], so the lane's four keys
// are byte lane % 4 of ballot[lane / 4]. The ballots are alike in every
// lane; the select chain keeps them in registers.
MKV_DIFF_FN uint32_t mkv_lane_digest_bytes(const uint32_t ballot[kMkvDiffLoads], uint32_t lane) {
  uint32_t b = ballot[0];
#pragma unroll
  for (int j = 1; j < kMkvDiffLoads; ++j) b = (lane >> 2) == static_cast<uint32_t>(j) ? ballot[j] : b;
  const uint32_t x = b >> (8 * (lane & 3));
  const uint32_t y = x | (x >> 1);  // bit 2 i: either half of key i
  return (y & 1u) | ((y >> 2) & 1u) << 8 | ((y >> 4) & 1u) << 16 | ((y >> 6) & 1u) << 24;
}

// mkv_key_diverges over four keys at once, one a byte: the replica's and
// the reference's presence bytes (0 or 1, as torch.bool stores them) and
// the digest bits of mkv_lane_digest_bytes. Byte i of the result is 1 iff
// key i diverges.
MKV_DIFF_FN uint32_t mkv_mask_word(uint32_t present, uint32_t ref_present,
                                   uint32_t digest_differs) {
  return (present ^ ref_present) | (present & ref_present & digest_differs);
}

// The bits of byte i of a mask word (0 or 1), which the warp ballots to
// count its diverging keys: the count is the sum over i < 4 of the
// ballots' popcounts.
MKV_DIFF_FN uint32_t mkv_mask_byte(uint32_t mask, int i) { return (mask >> (8 * i)) & 1u; }
