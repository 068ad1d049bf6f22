// Ragged leaf digests for Hopper (sm_90a): every leaf's padded message
// blocks lie back to back, leaf i's at offsets[i] .. offsets[i + 1], so a
// leaf of one block and a leaf of thousands share one tensor with no padding
// to the longest (merkle/ragged.py).
//
// Built at first use by merklekv_tpu_torch/ops/cuda_lib.py like every
// csrc/*.cu; ops/sha256_cuda.py wraps the entries. The launcher takes
// PyTorch's current stream, allocates nothing, never synchronises, and
// returns cudaGetLastError() after its launches (0 = launched).
//
// Replaces no Pallas kernel: the JAX package pads every leaf to the batch's
// longest and hashes [N, B, 16] with _leaf_kernel (sha256_pallas.py), which
// leaf_kernel (sha256_kernels.cu) ports as it is. With record sizes that vary
// widely (Facebook's ETC pool: 1 to 3,348 blocks a leaf, mean 6.45) padding
// costs terabytes, and one thread a leaf in key order keeps a warp running
// as long as its longest lane: 18% of its lane-compressions do work.
//
// What bounds it: the integer pipes, as for leaf_kernel (1024 shift/logic
// lane-ops a compression against 64 bytes read; bulk_kernel, like
// leaf_kernel, adds in the FMA form and runs its message block rolled,
// sha256_core.cuh), plus one serial chain: SHA-256 is
// serial within a message, so the longest leaf is as many dependent
// compressions as it has blocks, about 1.4 us each for a warp alone on an
// SM sub-partition (SMSP), and k times that for a warp that shares its SMSP
// with k - 1 others that keep the integer pipe busy. What the design does:
// - the set (merkle/ragged.py) orders the leaves by block count, longest
//   first, once; lane l of warp w hashes the leaf at position 32 w + l of
//   that order, so a warp's lanes do near-equal work, and its digest goes
//   to the leaf's own row in key order;
// - the first `chained` positions (whole warps, the groups the set found
//   too long to share an SMSP with the bulk) go to chain_kernel: blocks of
//   4 warps, one a sub-partition, each block holding the largest shared
//   memory a block may take, so that no other block, of this launch or any
//   other, fits on its SM while it runs: each chain runs alone on its SMSP;
// - bulk_kernel takes the other positions in blocks of 256 threads, longest
//   first, so long leaves start early and the shortest fill the end. It is
//   launched after chain_kernel on the same stream as a programmatic
//   dependent launch: it may start once every chain block has started
//   (each triggers its dependents first thing), so the chains take their
//   SMs before the bulk fills the card, and the two run side by side. Its
//   few bytes of dynamic shared memory keep a bulk block off a chain's SM
//   even if the hardware counted no reserve for a block without any;
// - a chain, alone on its SMSP, keeps its next two blocks' loads in flight
//   while it compresses one, since no other warp there hides them, and adds
//   with plain `+` (IADD3): a lone warp waits out each dependent add, and
//   IADD3's latency is the shorter.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_core.cuh"

namespace {

constexpr int kBulkThreads = 256;
// bulk_kernel's blocks an SM (48 registers a thread at most), as
// leaf_kernel's: mkv_ragged_shape reads it back for the set's schedule.
constexpr int kBulkBlocks = 5;
constexpr int kChainThreads = 128;
constexpr size_t kBulkSmem = 16;

__device__ __forceinline__ void load_block(const uint4* __restrict__ src, uint4 q[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = src[i];
}

__device__ __forceinline__ void words_of(const uint4 q[4], uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[4 * i + 0] = q[i].x; w[4 * i + 1] = q[i].y; w[4 * i + 2] = q[i].z; w[4 * i + 3] = q[i].w;
  }
}

__device__ __forceinline__ void store_digest(uint4* __restrict__ out, int32_t leaf,
                                             const uint32_t s[8]) {
  out[2 * leaf] = make_uint4(s[0], s[1], s[2], s[3]);
  out[2 * leaf + 1] = make_uint4(s[4], s[5], s[6], s[7]);
}

// The bulk's leaf: each block loaded, then compressed; the other warps on
// the SMSP hide the load.
__device__ __forceinline__ void hash_leaf(const uint4* __restrict__ blocks,
                                          const int64_t* __restrict__ offsets, int32_t leaf,
                                          uint4* __restrict__ out, MkvFmaAdd add) {
  const int64_t lo = offsets[leaf], hi = offsets[leaf + 1];
  uint32_t s[8];
  mkv_iv(s);
  for (int64_t b = lo; b < hi; ++b) {
    uint4 q[4];
    load_block(blocks + 4 * b, q);
    uint32_t w[16];
    words_of(q, w);
    mkv_compress_rolled(s, w, add);
  }
  store_digest(out, leaf, s);
}

// A chain's leaf: a warp alone on its SMSP has no other warp to hide a load
// behind, so blocks b + 1 and b + 2 are in flight while block b compresses.
__device__ __forceinline__ void hash_leaf_ahead(const uint4* __restrict__ blocks,
                                                const int64_t* __restrict__ offsets,
                                                int32_t leaf, uint4* __restrict__ out) {
  const int64_t lo = offsets[leaf], hi = offsets[leaf + 1];
  uint32_t s[8];
  mkv_iv(s);
  uint4 even[4], odd[4];
  if (lo < hi) load_block(blocks + 4 * lo, even);
  if (lo + 1 < hi) load_block(blocks + 4 * (lo + 1), odd);
  for (int64_t b = lo; b < hi; b += 2) {
    uint32_t w[16];
    words_of(even, w);
    if (b + 2 < hi) load_block(blocks + 4 * (b + 2), even);
    mkv_compress(s, w);
    if (b + 1 >= hi) break;
    words_of(odd, w);
    if (b + 3 < hi) load_block(blocks + 4 * (b + 3), odd);
    mkv_compress(s, w);
  }
  store_digest(out, leaf, s);
}

// Positions [0, chained) of order, one leaf a thread.
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const uint4* __restrict__ blocks, const int64_t* __restrict__ offsets,
             const int32_t* __restrict__ order, uint4* __restrict__ out, int64_t chained) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kChainThreads + threadIdx.x;
  if (i < chained) hash_leaf_ahead(blocks, offsets, order[i], out);
}

// Positions [first, n) of order, one leaf a thread; one == 1 (MkvFmaAdd).
__global__ void __launch_bounds__(kBulkThreads, kBulkBlocks)
bulk_kernel(const uint4* __restrict__ blocks, const int64_t* __restrict__ offsets,
            const int32_t* __restrict__ order, uint4* __restrict__ out, int64_t first, int64_t n,
            uint32_t one) {
  const int64_t i = first + static_cast<int64_t>(blockIdx.x) * kBulkThreads + threadIdx.x;
  if (i < n) hash_leaf(blocks, offsets, order[i], out, MkvFmaAdd{one});
}

}  // namespace

extern "C" {

// blocks [T, 16] u32, offsets [N + 1] i64, order [n] i32 (leaf numbers,
// longest first: all N of them, or some), out [N, 8]: the leaf at each of
// the n positions of order gets its digest in its own row. The first
// `chained` positions run in chain_kernel, the rest in bulk_kernel.
int mkv_leaf_ragged(const void* blocks, const void* offsets, const void* order, void* out,
                    int64_t n, int64_t chained, void* stream) {
  if (n <= 0) return 0;
  chained = chained < 0 ? 0 : (chained < n ? chained : n);
  const auto* b = static_cast<const uint4*>(blocks);
  const auto* off = static_cast<const int64_t*>(offsets);
  const auto* ord = static_cast<const int32_t*>(order);
  auto* o = static_cast<uint4*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (chained > 0) {
    int dev = 0, smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t grid = (chained + kChainThreads - 1) / kChainThreads;
    chain_kernel<<<static_cast<unsigned>(grid), kChainThreads, smem, s>>>(b, off, ord, o, chained);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n > chained) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>((n - chained + kBulkThreads - 1) / kBulkThreads));
    cfg.blockDim = dim3(kBulkThreads);
    cfg.dynamicSmemBytes = kBulkSmem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = chained > 0 ? 1 : 0;
    const int64_t first = chained;
    cudaError_t err = cudaLaunchKernelEx(&cfg, bulk_kernel, b, off, ord, o, first, n, 1u);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The current device's SMs and the warps bulk_kernel keeps resident on each
// SMSP (the occupancy calculator's blocks an SM, 8 warps a block, over 4
// SMSPs): what the set's schedule weighs a chain against.
int mkv_ragged_shape(int32_t* sms, int32_t* warps_per_smsp) {
  int dev = 0, count = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bulk_kernel, kBulkThreads, kBulkSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *sms = count;
  *warps_per_smsp = blocks * (kBulkThreads / 32) / 4;
  return 0;
}

}  // extern "C"
