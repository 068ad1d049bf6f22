// Measurement only, for tools/torch_pairs_sweep.py; never used for results.
//
// 1. pairs_shape: mkv_pairs_shape (csrc/node_pairs.cuh) itself, so that the
//    tool times the grid the launcher picks and not a copy of its rule.
// 2. pairs_launch: node_pairs_kernel (csrc/sha256_kernels.cu, built here)
//    at a grid the caller gives, so that launch shapes can be timed against
//    each other on the same inputs.
// 3. pairs_where: node_pairs_kernel's guard, loads and hash at a grid the
//    caller gives, with lane 0 of each warp recording its SM, its warp slot
//    on the SM (%warpid; the SM places slot w on sub-partition w % 4), and
//    the global timer before its loads and after its store: where the
//    blocks land and how long each warp takes.
//
// Built by tools/torch_pairs_sweep.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -I merklekv_tpu_torch/csrc

#include "sha256_kernels.cu"

namespace {

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// node_pairs_kernel's rows, guard, loads and hash; lane 0 of each warp
// records [SM, warp slot, start ns, end ns] at rec[4 * warp].
__global__ void __launch_bounds__(kMkvPairsThreads)
pairs_where_kernel(const uint4* __restrict__ left, const uint4* __restrict__ right,
                   uint4* __restrict__ out, int64_t p, int64_t* rec) {
  const uint64_t t0 = now_ns();
  int64_t i;
  if (mkv_pairs_row(blockIdx.x, threadIdx.x, blockDim.x, p, &i)) {
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
  __syncwarp();
  const uint64_t t1 = now_ns();
  if (threadIdx.x % 32 == 0) {
    uint32_t sm, slot;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
    rec[4 * warp] = sm;
    rec[4 * warp + 1] = slot;
    rec[4 * warp + 2] = static_cast<int64_t>(t0);
    rec[4 * warp + 3] = static_cast<int64_t>(t1);
  }
}

}  // namespace

extern "C" int pairs_shape(int64_t p, int64_t* blocks, int32_t* threads) {
  return mkv_pairs_shape(p, blocks, threads);
}

extern "C" int pairs_launch(const void* left, const void* right, void* out, int64_t p,
                            int64_t blocks, int32_t threads, void* stream) {
  node_pairs_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(left), static_cast<const uint4*>(right),
      static_cast<uint4*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pairs_where(const void* left, const void* right, void* out, int64_t p,
                           int64_t blocks, int32_t threads, void* rec, void* stream) {
  pairs_where_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(left), static_cast<const uint4*>(right),
      static_cast<uint4*>(out), p, static_cast<int64_t*>(rec));
  return static_cast<int>(cudaGetLastError());
}
