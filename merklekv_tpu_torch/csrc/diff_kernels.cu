// The N-replica diff for Hopper (sm_90a): the [R, N] masks of the keys
// that diverge from replica 0, and the [R] per-replica counts, in one pass
// over the digests.
//
// Built at first use by merklekv_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
// in parallel with the other sources, and linked with them into one
// library with a plain C interface (mkv_error_string is defined in
// sha256_kernels.cu); cuda_lib.py binds mkv_divergence with ctypes and
// ops/diff_cuda.py wraps it. The launcher takes PyTorch's current stream, allocates
// nothing, never synchronises, and returns cudaGetLastError() right after
// the launch (0 = launched).
//
// Replaces no Pallas kernel. It replaces XLA's fusion of divergence_masks
// (merklekv_tpu/merkle/diff.py:98): the JAX package runs the predicate
// under jit, where XLA fuses the word compare, the reduction over the 8
// words and the presence logic into one pass. Run as eager PyTorch, the
// same predicate was about ten kernels, a 640 MB [R, N, 8] bool tensor
// written and read back among them: about 8 ms at 10M keys x 8 replicas.
//
// What bounds it on an H100: HBM. Every replica's digests (32 B a key) and
// presence (1 B) are read once and one mask byte a key is written:
// R N 34 bytes, 2.72 GB at 10M x 8, 0.812 ms at 3.35 TB/s, against a few
// integer operations per 16 bytes. What the design does about it:
// - every byte crosses HBM once, in whole sectors: a warp's digest loads
//   are 512 contiguous bytes each (16-byte loads; the two lanes of a pair
//   read the two halves of one key, diff_kernels.cuh), and replica 0's
//   tile is loaded once and kept in registers for the other R - 1;
// - loads and stores are streaming (__ldcs / __stcs): nothing is read
//   again, so nothing is kept in the caches for it;
// - presence is read, and masks are written, 4 keys to a 32-bit word;
// - a warp issues two replicas' loads (16 of 16 bytes a lane) before
//   their ballots, in at most 128 registers a thread (126; 2 blocks of 256
//   an SM), so few warps an SM still hold enough bytes in flight;
// - standalone, the grid is as many blocks as the card holds at once (the
//   occupancy calculator's count times the SMs), each warp striding over
//   the tiles: 16 warps an SM, several times the ~20 KB an SM needs in
//   flight by Little's law at 3.35 TB/s;
// - beside the leaf hash (the anti-entropy step's side stream), the grid is
//   co-resident: one block of 128 threads an SM (16,384 registers), which
//   leaves the leaf kernel 4 of its 5 blocks an SM; the leaf hash keeps the
//   integer pipes, the diff takes the HBM bandwidth the leaf hash leaves
//   (tools/torch_diff_beside.py measures the pair);
// - counts: a popcount of ballots per warp, summed in shared memory over
//   the block's tiles, then one atomicAdd per block and replica into the
//   caller's zeroed counts. Integer sums are exact in any order.
// Measured on an H100 (PERF.md), standalone: 0.93 ms at 10M x 8, 87% of
// the bound. One replica's loads in flight a warp ran 1-3% faster there,
// none faster at 16.5M x 64, and beside the leaf hash held too few bytes in
// flight (the pair below took 30.2 ms); 128 to 512 threads a block, 3
// blocks an SM, other load and store cache hints and L2 prefetch sizes
// measured within 1%; 1024-thread blocks were 15% slower. Beside the leaf
// hash at 16.5M keys x 64 replicas, 16.5M leaves of 17 blocks: the two end
// 25.0 ms after they start, against 35.5 ms one after the other; one block
// of 256 threads an SM (the leaf kernel keeps 3 blocks an SM) 25.7 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "diff_kernels.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// One shared int32 count a replica: within the 48 KB of dynamic shared
// memory a block has without an opt-in.
constexpr int32_t kDiffMaxReplicas = 12288;

// Presence bytes of keys k .. k + 3 of one row (0 past n), one a byte: as
// one streaming word where the rows' words are aligned (vec) and all four
// keys lie before n.
__device__ __forceinline__ uint32_t load_present4(const uint8_t* __restrict__ row, int64_t k,
                                                  int64_t n, bool vec) {
  if (vec && k + 4 <= n) return __ldcs(reinterpret_cast<const unsigned int*>(row + k));
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (k + i < n) w |= static_cast<uint32_t>(row[k + i]) << (8 * i);
  }
  return w;
}

// Mask bytes of keys k .. k + 3 of one row, those before n.
__device__ __forceinline__ void store_mask4(uint8_t* __restrict__ row, int64_t k, int64_t n,
                                            bool vec, uint32_t w) {
  if (vec && k + 4 <= n) {
    __stcs(reinterpret_cast<unsigned int*>(row + k), w);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (k + i < n) row[k + i] = static_cast<uint8_t>(w >> (8 * i));
  }
}

// Replica r's halves of a tile (tile: its first half for this lane), the
// reference's past n.
__device__ __forceinline__ void load_halves(uint4 v[kMkvDiffLoads], const uint4* __restrict__ tile,
                                            const uint4 ref[kMkvDiffLoads], uint32_t lane,
                                            int64_t left) {
#pragma unroll
  for (int j = 0; j < kMkvDiffLoads; ++j) {
    v[j] = mkv_diff_half_key(j, lane) < left ? __ldcs(tile + 32 * j) : ref[j];
  }
}

// One replica's ballots, its lane's mask word (written to mask_row) and
// the warp's count of its diverging keys (added to *block_count).
__device__ __forceinline__ void diff_replica(const uint4 v[kMkvDiffLoads],
                                             const uint4 ref[kMkvDiffLoads], uint32_t p,
                                             uint32_t ref_present, uint32_t lane,
                                             uint8_t* __restrict__ mask_row, int64_t k, int64_t n,
                                             bool vec, int32_t* block_count) {
  uint32_t ballot[kMkvDiffLoads];
#pragma unroll
  for (int j = 0; j < kMkvDiffLoads; ++j) {
    ballot[j] = __ballot_sync(kFull, mkv_half_differs(v[j], ref[j]));
  }
  const uint32_t m = mkv_mask_word(p, ref_present, mkv_lane_digest_bytes(ballot, lane));
  store_mask4(mask_row, k, n, vec, m);
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) c += __popc(__ballot_sync(kFull, mkv_mask_byte(m, i)));
  if (lane == 0 && c != 0) atomicAdd(block_count, c);
}

// digests: replica r's key i is the two uint4 at r * digest_stride + 2 i;
// present: replica r's key i is the byte at r * present_stride + i;
// masks [r_count, n] contiguous; counts [r_count], zero on entry. Any block
// of whole warps up to kMkvDiffThreads threads.
//
// Every load of a replica is issued before its first ballot: the compiler
// moves no load above a ballot, so a ballot after each load would wait out
// 8 latencies a replica (1.31 ms against 0.92 ms at 10M x 8). Replicas go
// two at a time, both loaded before either's ballots.
__global__ void __launch_bounds__(kMkvDiffThreads, 2)
diff_kernel(const uint4* __restrict__ digests, int64_t digest_stride,
            const uint8_t* __restrict__ present, int64_t present_stride,
            uint8_t* __restrict__ masks, int32_t* __restrict__ counts,
            int64_t n, int32_t r_count, bool vec) {
  extern __shared__ int32_t block_counts[];
  for (int32_t r = threadIdx.x; r < r_count; r += blockDim.x) block_counts[r] = 0;
  __syncthreads();

  const uint32_t lane = threadIdx.x & 31u;
  const int64_t block_warps = blockDim.x >> 5;
  const int64_t tiles = (n + kMkvDiffTileKeys - 1) / kMkvDiffTileKeys;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * block_warps;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * block_warps + (threadIdx.x >> 5); t < tiles;
       t += warps) {
    const int64_t base = t * kMkvDiffTileKeys;
    const int64_t left = n - base;  // keys of the tile before n
    const uint4* tile0 = digests + 2 * base + lane;  // + 32 j: this lane's half of load j
    const int64_t k = base + 4 * static_cast<int64_t>(lane);  // this lane's four keys
    const uint32_t ref_present = load_present4(present, k, n, vec);
    uint4 ref[kMkvDiffLoads];
#pragma unroll
    for (int j = 0; j < kMkvDiffLoads; ++j) {
      ref[j] = mkv_diff_half_key(j, lane) < left ? __ldcs(tile0 + 32 * j) : make_uint4(0, 0, 0, 0);
    }
    store_mask4(masks, k, n, vec, 0u);  // row 0: nothing diverges from itself

    int32_t r = 1;
    for (; r + 1 < r_count; r += 2) {
      uint4 v[kMkvDiffLoads], w[kMkvDiffLoads];
      load_halves(v, tile0 + r * digest_stride, ref, lane, left);
      load_halves(w, tile0 + (r + 1) * digest_stride, ref, lane, left);
      const uint32_t p = load_present4(present + r * present_stride, k, n, vec);
      const uint32_t q = load_present4(present + (r + 1) * present_stride, k, n, vec);
      diff_replica(v, ref, p, ref_present, lane, masks + r * n, k, n, vec, &block_counts[r]);
      diff_replica(w, ref, q, ref_present, lane, masks + (r + 1) * n, k, n, vec,
                   &block_counts[r + 1]);
    }
    if (r < r_count) {
      uint4 v[kMkvDiffLoads];
      load_halves(v, tile0 + r * digest_stride, ref, lane, left);
      const uint32_t p = load_present4(present + r * present_stride, k, n, vec);
      diff_replica(v, ref, p, ref_present, lane, masks + r * n, k, n, vec, &block_counts[r]);
    }
  }

  __syncthreads();
  for (int32_t r = threadIdx.x; r < r_count; r += blockDim.x) {
    if (block_counts[r] != 0) atomicAdd(&counts[r], block_counts[r]);
  }
}

}  // namespace

extern "C" {

// digests: int32 words, 16-byte aligned, replica stride digest_stride
// (in words, a multiple of 4), key stride 8, word stride 1; present: bytes,
// replica stride present_stride, key stride 1; masks [r_count, n]
// contiguous; counts [r_count] zeroed before the launch on its stream.
// beside 0: the standalone grid, kMkvDiffThreads-thread blocks, as many as
// the card holds; beside 1: the co-resident grid (mkv_diff_grid), for a
// stream that runs beside another kernel.
int mkv_divergence(const void* digests, int64_t digest_stride, const void* present,
                   int64_t present_stride, void* masks, void* counts, int64_t n,
                   int32_t r_count, int32_t beside, void* stream) {
  if (n <= 0 || r_count <= 0) return 0;
  if (r_count > kDiffMaxReplicas || digest_stride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(digests) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = mkv_diff_threads(beside != 0);
  const size_t shared = sizeof(int32_t) * static_cast<size_t>(r_count);
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && beside == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, diff_kernel, threads, shared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(mkv_diff_grid(n, sms, resident, beside != 0));
  const bool vec = n % 4 == 0 && present_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(present) % 4 == 0;
  diff_kernel<<<grid, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(digests), digest_stride / 4,
      static_cast<const uint8_t*>(present), present_stride, static_cast<uint8_t*>(masks),
      static_cast<int32_t*>(counts), n, r_count, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
