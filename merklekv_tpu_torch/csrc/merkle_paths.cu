// The serving tree's update and root kernels for Hopper (sm_90a): one fused
// path-rehash launch per value batch, and one promotion-chain launch per
// tree version.
//
// Built at first use by merklekv_tpu_torch/ops/sha256_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
// in parallel with sha256_kernels.cu, and linked with it into one library
// with a plain C interface (mkv_error_string is defined there); the ctypes
// binding of the two entry points below is in ops/merkle_paths.py. Every
// launcher takes PyTorch's current stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() right after the launch
// (0 = launched).
//
// Replaces, on the serving path:
//   mkv_path_rehash      <- _node_kernel (merklekv_tpu/ops/sha256_pallas.py:250)
//                           as the JAX package runs it in _scatter_hash_fn
//                           (merklekv_tpu/merkle/incremental.py:118-134):
//                           leaf hashing + scatter + path re-reduction, one
//                           device program per batch.
//   mkv_promotion_chain  <- _node_kernel as run by _ref_root_fn
//                           (merklekv_tpu/merkle/incremental.py:159-183).
// The direct counterpart of _node_kernel, node_pairs_kernel, stays in
// sha256_kernels.cu for [P, 8] x [P, 8] callers.
//
// What bounds the path rehash on an H100. Work: k leaf hashes plus each
// DISTINCT touched internal node once (about 31k at k = 4096 random leaves
// of 2^20, where the per-level [k, 8] pairs launches hashed 81,920, the root
// 4096 times). Throughput bound: (distinct nodes x 1664 + leaf blocks x
// 1024) shift/logic ops / 16.7 Tops/s, about 3.6 us there. Latency floor:
// the root's path is a dependent chain of depth node hashes after a leaf
// hash, each by one thread, and one warp issues its 1664 shift/logic
// instructions through its sub-partition's 16 INT32 lanes at 2 cycles
// each: 1.7 us per node hash, about 35 us at depth 20, before the memory
// latency of one sibling read (and, where both children changed, one
// arrival) per level. So it is latency-bound. What the design does about
// that: one launch (no host round trip per level and no [k, 8] gathers or
// index_put_ between levels), threads that never wait (the first arrival at
// a touched parent yields and the second finishes: the bottom-up refit of
// GPU BVH builders, no grid barrier, no cooperative launch), 64-thread
// blocks so the bottom levels spread over the SMs, and the tree levels
// passed by value as a parameter struct. Reading the next level's sibling
// ahead, during the hash, measured no faster on the H100 and was dropped.
//
// The promotion chain is one warp: the lanes load every level's row m-2 at
// once (one memory latency instead of one per level), then one lane walks
// the dependent chain of even levels. Its floor is the chain itself: up to
// depth node hashes in series, 1.7 us each as above.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merkle_paths.cuh"

namespace {

constexpr int kPathThreads = 64;

// blocks [k, nblk, 16] u32, nblocks [k] i32, pos [k] i32 sorted unique,
// ctr [C - 1] i32 all zero on entry and on exit.
__global__ void __launch_bounds__(kPathThreads)
path_rehash_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ nblocks,
                   const int32_t* __restrict__ pos, int32_t k, int32_t nblk,
                   const MkvLevels levels, int32_t* ctr) {
  const int32_t i = static_cast<int32_t>(blockIdx.x) * kPathThreads + threadIdx.x;
  if (i >= k) return;
  MkvWalker w;
  mkv_path_begin(w, levels, blocks + static_cast<int64_t>(i) * nblk * 16, nblocks[i], nblk,
                 pos, i);
  while (mkv_path_step(w, levels, ctr, pos, k) == kMkvClimb) {
  }
}

// out [nlev, 8]: the reference tree's last node per level over n leaves.
__global__ void __launch_bounds__(32)
promotion_chain_kernel(const MkvLevels levels, int64_t n, int32_t nlev, uint32_t* out) {
  __shared__ __align__(16) uint32_t prev[kMkvMaxLevels * 8];
  for (int32_t l = 1 + threadIdx.x; l < nlev; l += 32) mkv_chain_prev(levels, n, l, prev);
  __syncwarp();
  if (threadIdx.x == 0) mkv_chain_walk(levels.rows[0] + 8 * (n - 1), prev, n, nlev, out);
}

}  // namespace

extern "C" {

int mkv_path_rehash(const MkvLevels* levels, const void* blocks, const void* nblocks,
                    const void* pos, int32_t k, int32_t nblk, void* ctr, void* stream) {
  if (k <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((k + kPathThreads - 1) / kPathThreads);
  path_rehash_kernel<<<grid, kPathThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int32_t*>(nblocks),
      static_cast<const int32_t*>(pos), k, nblk, *levels, static_cast<int32_t*>(ctr));
  return static_cast<int>(cudaGetLastError());
}

int mkv_promotion_chain(const MkvLevels* levels, int64_t n, int32_t nlev, void* out,
                        void* stream) {
  if (n <= 0 || nlev <= 0) return 0;
  promotion_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      *levels, n, nlev, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
