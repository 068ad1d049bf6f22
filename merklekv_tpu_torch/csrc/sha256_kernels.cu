// Batched SHA-256 kernels for Hopper (sm_90a): leaf digests, adjacent-row
// tree levels, and separate left/right parent pairs.
//
// Built at first use by merklekv_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
// in parallel with the other csrc/*.cu, and linked with them into one
// library with a plain C interface; cuda_lib.py binds the entry points with
// ctypes and ops/sha256_cuda.py wraps them. Every launcher
// takes PyTorch's current stream, allocates nothing, never synchronises, and
// returns cudaGetLastError() right after the launch (0 = launched).
//
// Replaces (merklekv_tpu/ops/sha256_pallas.py):
//   mkv_leaf_digests  <- _leaf_kernel       (_leaf_digests_impl, leaf_digests_pallas)
//   mkv_node_level    <- _node_level_kernel (_node_level_impl, node_level_pallas)
//   mkv_node_pairs    <- _node_kernel       (_node_pairs_impl, node_pairs_pallas)
// Each computes what its TPU kernel computes; the TPU word-plane layout
// (TILE_S x TILE_L tiles, _to_planes) fits the TPU vector unit and is not
// carried over. Here each thread hashes one message, reading its own
// row-major row with 16-byte vector loads.
//
// What bounds them on an H100: integer instructions, not HBM. With 3-input
// LOP3/IADD3 fusion a round needs 6 funnel shifts + 4 LOP3 (the two Sigmas,
// Ch, Maj) + 4 adds, a schedule word 6 shifts + 2 LOP3 + 2 adds. So a
// one-block compression is 64 x 10 + 48 x 8 = 1024 shift/logic ops (+ 360
// adds), the schedule-free pad compression 640 (+ 264). A leaf is 1024 ops
// for 100 bytes of traffic (64 B block + 4 B count + 32 B digest), a node
// 1664 ops for 96 bytes. Counted at 64 INT32 lanes an SM (132 SMs at 1.98
// GHz = 16.7 Tops/s, the benchmark's bound) that is 10-17 ops per byte
// against the card's 16.7e12 / 3.35e12 = 5 ops per byte of HBM rate; but
// each SM sub-partition issues SHF, LOP3 and IADD3 at about one warp
// instruction a cycle (tools/pipe_rates.cu), so the kernels run at the pace
// their warps issue, not at a pipe's limit. What the design does about it:
// keep every operand in registers (state, 16-word rolling schedule, rounds
// with compile-time indices), rotr as one funnel shift, K and the pad
// block's K+W in constant memory (a warp-wide broadcast operand, no extra
// instruction), fold the pad block's schedule away entirely, and touch HBM
// once per input and output word. leaf_kernel and node_level_kernel add in
// the FMA form (MkvFmaAdd, sha256_core.cuh), each taking the 1 it multiplies
// by as its last argument, with their message block rolled
// (mkv_compress_rolled): the FMA form alone left them where plain `+` had
// (241 IADD3 and 119 IMAD.IADD a block) as its unrolled block grew to 1736
// instructions; with the rolled block (824) the leaf hash at [10M, 17]
// takes 9% less time and a [10M, 8] level 4-8% less (PERF.md).
//
// A launch too small to fill the card has another bound: one node hash is
// about 2,300 warp instructions through one SM sub-partition's (SMSP's)
// 16-lane integer pipe, 2.8 us for one warp alone (hash_chain_kernel,
// merkle_paths.cu), and two warps on one SMSP take twice that. At the
// serving batch (p = 4096), 256-thread blocks would put 2 warps on each SMSP
// of 16 SMs and leave 116 SMs idle (5.9 us measured).
// node_pairs_kernel therefore launches blocks of up to 4 warps, one per
// SMSP (node_pairs.cuh): up to 128 x SMs pairs each block has an SM of
// its own, so a small launch takes about one hash time plus the slowest
// SM's lag. The hash is the same unrolled one as the other kernels'. The
// leaf and level kernels keep the fixed 256-thread shape: both run on
// levels far wider than the card in the rebuild, at their bound's pace.

#include <cuda_runtime.h>
#include <stdint.h>

#include "node_pairs.cuh"
#include "sha256_core.cuh"

namespace {

// Threads per block of leaf_kernel and node_level_kernel: 8 warps, 2 on
// each SMSP, enough to hide a load's latency behind another warp's rounds
// on levels of millions of rows. node_pairs_kernel's shape is
// mkv_pairs_shape's (node_pairs.cuh).
constexpr int kThreads = 256;
// leaf_kernel's blocks an SM: 48 registers a thread at most, so 4 blocks
// still fit beside the diff's co-resident block (csrc/diff_kernels.cuh).
constexpr int kLeafBlocks = 5;

__device__ __forceinline__ void load16(const uint4* __restrict__ src, uint32_t w[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = src[q];
    w[4 * q + 0] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void store8(uint4* __restrict__ dst, const uint32_t s[8]) {
  dst[0] = make_uint4(s[0], s[1], s[2], s[3]);
  dst[1] = make_uint4(s[4], s[5], s[6], s[7]);
}

// blocks [n, nblk, 16] u32 (4 uint4 per block), nblocks [n] i32, out [n, 8].
// Only blocks b < nblocks[i] are compressed, which is the TPU kernel's
// compress-then-mask result; a message with nblocks <= 0 keeps the IV.
__global__ void __launch_bounds__(kThreads, kLeafBlocks)
leaf_kernel(const uint4* __restrict__ blocks, const int32_t* __restrict__ nblocks,
            uint4* __restrict__ out, int64_t n, int32_t nblk, uint32_t one) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const MkvFmaAdd add{one};
  uint32_t s[8];
  mkv_iv(s);
  int32_t nb = nblocks[i];
  nb = nb < nblk ? nb : nblk;
  const uint4* row = blocks + i * static_cast<int64_t>(nblk) * 4;
  for (int32_t b = 0; b < nb; ++b) {
    uint32_t w[16];
    load16(row + 4 * b, w);
    mkv_compress_rolled(s, w, add);
  }
  store8(out + 2 * i, s);
}

// cur [2p (+1), 8] u32 -> out [p, 8]: rows 2i and 2i+1 are one contiguous
// 64-byte message (left || right), read with four 16-byte loads. No
// even/odd split of the level is materialised.
__global__ void __launch_bounds__(kThreads)
node_level_kernel(const uint4* __restrict__ cur, uint4* __restrict__ out, int64_t p,
                  uint32_t one) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p) return;
  const MkvFmaAdd add{one};
  uint32_t w[16], s[8];
  load16(cur + 4 * i, w);
  mkv_iv(s);
  mkv_compress_rolled(s, w, add);
  mkv_compress_node_pad(s, add);
  store8(out + 2 * i, s);
}

// left [p, 8], right [p, 8] -> out [p, 8] = SHA256(left[i] || right[i]),
// in blocks of the shape mkv_pairs_shape gives. Both children come in with
// 16-byte loads before the rounds.
__global__ void __launch_bounds__(kMkvPairsThreads)
node_pairs_kernel(const uint4* __restrict__ left, const uint4* __restrict__ right,
                  uint4* __restrict__ out, int64_t p) {
  int64_t i;
  if (!mkv_pairs_row(blockIdx.x, threadIdx.x, blockDim.x, p, &i)) return;
  uint32_t w[16], s[8];
  const uint4 l0 = left[2 * i], l1 = left[2 * i + 1];
  const uint4 r0 = right[2 * i], r1 = right[2 * i + 1];
  w[0] = l0.x; w[1] = l0.y; w[2] = l0.z; w[3] = l0.w;
  w[4] = l1.x; w[5] = l1.y; w[6] = l1.z; w[7] = l1.w;
  w[8] = r0.x; w[9] = r0.y; w[10] = r0.z; w[11] = r0.w;
  w[12] = r1.x; w[13] = r1.y; w[14] = r1.z; w[15] = r1.w;
  mkv_iv(s);
  mkv_compress(s, w);
  mkv_compress_node_pad(s);
  store8(out + 2 * i, s);
}

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int mkv_leaf_digests(const void* blocks, const void* nblocks, void* out,
                     int64_t n, int32_t nblk, void* stream) {
  if (n <= 0) return 0;
  leaf_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(blocks), static_cast<const int32_t*>(nblocks),
      static_cast<uint4*>(out), n, nblk, 1u);
  return static_cast<int>(cudaGetLastError());
}

int mkv_node_level(const void* cur, void* out, int64_t p, void* stream) {
  if (p <= 0) return 0;
  node_level_kernel<<<grid_for(p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(cur), static_cast<uint4*>(out), p, 1u);
  return static_cast<int>(cudaGetLastError());
}

int mkv_node_pairs(const void* left, const void* right, void* out, int64_t p, void* stream) {
  if (p <= 0) return 0;
  int64_t blocks;
  int32_t threads;
  mkv_pairs_shape(p, &blocks, &threads);  // a grid for every p >= 1
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  node_pairs_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(left), static_cast<const uint4*>(right),
      static_cast<uint4*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

const char* mkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
