// node_pairs_kernel's launch (sha256_kernels.cu): how many blocks of how
// many threads hash p (left, right) pairs, and which row each thread takes.
//
// A node hash is about 2,300 warp instructions of which most issue to the
// 16-lane integer pipe of one SM sub-partition (SMSP): one warp alone keeps
// that pipe nearly busy, and a second warp on the same SMSP doubles the
// time (PERF.md). An SM has 4 SMSPs and places the warps of a block on them
// in turn. So a block has the fewest warps up to 4 that cover p: blocks of
// 128 threads (fewer only below 97 pairs), one warp per SMSP. The card
// gives each block an SM of its own while there are no more blocks than
// SMs, so up to 128 x SMs pairs (16,896 on 132 SMs) no SMSP holds two
// warps of the launch and it takes about one hash time; above that, the
// SMs take several blocks each and throughput decides. The shape needs no
// SM count: 32-thread blocks spread over the SMs measured slower (PERF.md).
//
// Under a host C++ compiler this builds as plain host code, so the shape
// and the row guard are checked without a GPU
// (tests/test_torch_pairs_shape.py).

#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define MKV_PAIRS_FN __host__ __device__ __forceinline__
#else
#define MKV_PAIRS_FN static inline
#endif

// Threads per block: one warp per SMSP of an SM; the kernel's
// __launch_bounds__.
constexpr int kMkvPairsThreads = 128;

// The grid for p pairs: 0, or -1 when p < 1 (no grid; the launcher
// launches nothing then).
MKV_PAIRS_FN int mkv_pairs_shape(int64_t p, int64_t* blocks, int32_t* threads) {
  if (p < 1) return -1;
  const int64_t warps = (p + 31) / 32;
  *threads = static_cast<int32_t>(warps < kMkvPairsThreads / 32 ? 32 * warps : kMkvPairsThreads);
  *blocks = (p + *threads - 1) / *threads;
  return 0;
}

// The row of thread `thread` of block `block` in blocks of `threads`:
// true with *row set when it is one of the p pairs, false for the threads
// past the last pair.
MKV_PAIRS_FN bool mkv_pairs_row(uint32_t block, uint32_t thread, uint32_t threads, int64_t p,
                                int64_t* row) {
  *row = static_cast<int64_t>(block) * threads + thread;
  return *row < p;
}
