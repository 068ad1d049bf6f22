// Measurement only, for tools/torch_path_split.py; never used for results.
//
// 1. split_walk: the earlier path-rehash walk (one thread per changed leaf,
//    walkers meeting through a fence / atomicExch / fence / L2-load arrival
//    per node), in three variants; variants 1 and 2 give wrong digests on
//    purpose. They are the measured split of that kernel (PERF.md) and its
//    time on big batches beside the kernel of today.
//   mode 0  that kernel as it was (csrc/merkle_paths.cu at commit d422390);
//   mode 1  the arrival sequence replaced by plain loads: where both
//           children changed, the left walker always continues and reads
//           its sibling's digest and the merged run end (precomputed on the
//           host) with two plain loads; the right walker stops;
//   mode 2  mode 1, and an untouched sibling is not read either (the
//           walker hashes its own digest twice).
// 2. split_chain_sm: one block per SM, each of its 4 warps hashing its own
//    dependent chain of node hashes, with the unrolled node hash
//    (mkv_node_hash) or the path rehash's (mkv_node_hash_rolled); warp 0
//    reports its SM, cycles and nanoseconds.
// 3. split_trace: csrc/merkle_paths.cu itself, built here with its
//    MKV_PATH_MARK hook defined: thread 0 of each block stores the global
//    timer at the kernel's phase marks (slots in merkle_paths.cu).
//
// Built by tools/torch_path_split.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -I merklekv_tpu_torch/csrc

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ uint32_t sm_id() {
  uint32_t s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

// The trace [grid, 64]: [0] the block's SM, [slot] the global timer at
// each mark; null when no trace is asked for.
__device__ int64_t* g_trace;

__device__ __forceinline__ void split_mark(int slot) {
  int64_t* tr = g_trace;
  if (threadIdx.x != 0 || tr == nullptr) return;
  tr += 64 * blockIdx.x;
  if (slot == 1) tr[0] = sm_id();
  tr[slot] = static_cast<int64_t>(now_ns());
}

}  // namespace

#define MKV_PATH_MARK(slot) split_mark(slot)
#include "merkle_paths.cu"

// Outside the anonymous namespace: split_walk below takes it, and a type
// with internal linkage would give the entry point internal linkage too.
struct Levels {
  uint32_t* rows[64];
  int32_t depth;
};

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ void load8(const uint32_t* p, uint32_t s[8]) {
  const uint4 x = reinterpret_cast<const uint4*>(p)[0];
  const uint4 y = reinterpret_cast<const uint4*>(p)[1];
  s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
  s[4] = y.x; s[5] = y.y; s[6] = y.z; s[7] = y.w;
}
__device__ __forceinline__ void load8_fresh(const uint32_t* p, uint32_t s[8]) {
  const uint4 x = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint4 y = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
  s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
  s[4] = y.x; s[5] = y.y; s[6] = y.z; s[7] = y.w;
}
__device__ __forceinline__ void store8(uint32_t* p, const uint32_t s[8]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(s[0], s[1], s[2], s[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(s[4], s[5], s[6], s[7]);
}
__device__ __forceinline__ void node_hash(const uint32_t l[8], const uint32_t r[8],
                                          uint32_t out[8]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = l[i];
    w[8 + i] = r[i];
  }
  mkv_iv(out);
  mkv_compress(out, w);
  mkv_compress_node_pad(out);
}

// runend [depth, k]: the end of the run of sorted positions under node
// pos[i] >> l (used by modes 1 and 2 only).
template <int Mode>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ nblocks,
            const int32_t* __restrict__ pos, int32_t k, int32_t nblk, const Levels L,
            int32_t* ctr, const int32_t* __restrict__ runend) {
  const int32_t i = static_cast<int32_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= k) return;
  int64_t node = pos[i];
  uint32_t s[8];
  mkv_iv(s);
  const int32_t nb = nblocks[i] < nblk ? nblocks[i] : nblk;
  for (int32_t b = 0; b < nb; ++b) {
    uint32_t blk[16];
    const uint4* msg = reinterpret_cast<const uint4*>(
        blocks + (static_cast<int64_t>(i) * nblk + b) * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = msg[q];
      blk[4 * q] = v.x; blk[4 * q + 1] = v.y; blk[4 * q + 2] = v.z; blk[4 * q + 3] = v.w;
    }
    mkv_compress(s, blk);
  }
  int32_t lv = 0, a = i, bnd = i + 1;
  store8(L.rows[0] + 8 * node, s);
  while (lv + 1 < L.depth) {
    const int64_t sib = node ^ 1, parent = node >> 1;
    const bool left = (node & 1) == 0;
    const bool touched = left ? (bnd < k && (static_cast<int64_t>(pos[bnd]) >> lv) == sib)
                              : (a > 0 && (static_cast<int64_t>(pos[a - 1]) >> lv) == sib);
    uint32_t other[8];
    if (touched) {
      if (Mode == 0) {
        const int64_t cap = int64_t{1} << (L.depth - 1);
        int32_t* c = ctr + ((cap >> (lv + 1)) + parent - 1);
        __threadfence();
        const int32_t got = atomicExch(c, (left ? a : bnd) + 1);
        if (got == 0) return;
        *c = 0;
        __threadfence();
        load8_fresh(L.rows[lv] + 8 * sib, other);
        if (left) {
          bnd = got - 1;
        } else {
          a = got - 1;
        }
      } else {
        if (!left) return;
        load8(L.rows[lv] + 8 * sib, other);
        bnd = runend[static_cast<int64_t>(lv + 1) * k + i];
      }
    } else if (Mode == 2) {
#pragma unroll
      for (int q = 0; q < 8; ++q) other[q] = s[q];
    } else {
      load8(L.rows[lv] + 8 * sib, other);
    }
    uint32_t lw[8], rw[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      lw[q] = left ? s[q] : other[q];
      rw[q] = left ? other[q] : s[q];
    }
    node_hash(lw, rw, s);
    node = parent;
    lv += 1;
    store8(L.rows[lv] + 8 * node, s);
  }
}

}  // namespace

extern "C" int split_walk(int mode, const Levels* levels, const void* blocks,
                          const void* nblocks, const void* pos, int32_t k, int32_t nblk,
                          void* ctr, const void* runend, void* stream) {
  if (k <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((k + kThreads - 1) / kThreads);
  const auto* b = static_cast<const uint32_t*>(blocks);
  const auto* nb = static_cast<const int32_t*>(nblocks);
  const auto* p = static_cast<const int32_t*>(pos);
  auto* c = static_cast<int32_t*>(ctr);
  const auto* r = static_cast<const int32_t*>(runend);
  auto st = static_cast<cudaStream_t>(stream);
  if (mode == 0) walk_kernel<0><<<grid, kThreads, 0, st>>>(b, nb, p, k, nblk, *levels, c, r);
  if (mode == 1) walk_kernel<1><<<grid, kThreads, 0, st>>>(b, nb, p, k, nblk, *levels, c, r);
  if (mode == 2) walk_kernel<2><<<grid, kThreads, 0, st>>>(b, nb, p, k, nblk, *levels, c, r);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// res [blocks, 3]: smid, cycles, ns of warp 0's chain.
template <bool Rolled>
__global__ void __launch_bounds__(128)
chain_sm_kernel(const uint32_t* in, int32_t d, uint32_t* out, int64_t* res) {
  uint32_t x[8], y[8];
  mkv_load8(in + 16 * (threadIdx.x % 32), x);
  mkv_load8(in + 16 * (threadIdx.x % 32) + 8, y);
  const uint64_t g0 = now_ns();
  const int64_t c0 = clock64();
  asm volatile("" : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
               "+r"(x[6]), "+r"(x[7]));
  for (int32_t j = 0; j < d; ++j) {
    uint32_t r[8];
    if (Rolled) {
      mkv_node_hash_rolled(x, y, r);
    } else {
      mkv_node_hash(x, y, r);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = r[i];
  }
  asm volatile("" : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
               "+r"(x[6]), "+r"(x[7]));
  const int64_t c1 = clock64();
  const uint64_t g1 = now_ns();
  mkv_store8(out + 8 * (blockIdx.x * 128 + threadIdx.x), x);
  if (threadIdx.x == 0) {
    res[3 * blockIdx.x] = sm_id();
    res[3 * blockIdx.x + 1] = c1 - c0;
    res[3 * blockIdx.x + 2] = static_cast<int64_t>(g1 - g0);
  }
}

}  // namespace

extern "C" int split_chain_sm(int rolled, const void* in, int32_t d, void* out, void* res,
                              int32_t blocks, void* stream) {
  const auto* i = static_cast<const uint32_t*>(in);
  auto* o = static_cast<uint32_t*>(out);
  auto* r = static_cast<int64_t*>(res);
  auto st = static_cast<cudaStream_t>(stream);
  if (rolled) {
    chain_sm_kernel<true><<<blocks, 128, 0, st>>>(i, d, o, r);
  } else {
    chain_sm_kernel<false><<<blocks, 128, 0, st>>>(i, d, o, r);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int split_trace(const MkvLevels* levels, const void* blocks, const void* nblocks,
                           const void* pos, int32_t k, int32_t nblk, int32_t width, int32_t top,
                           void* scratch, void* trace, void* stream) {
  cudaError_t rc = cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return mkv_path_rehash(levels, blocks, nblocks, pos, k, nblk, width, top, scratch, stream);
}
