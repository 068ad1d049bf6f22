// The serving tree's update and root kernels for Hopper (sm_90a): one
// path-rehash launch per value batch, and one promotion-chain launch per
// tree version.
//
// Built at first use by merklekv_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
// in parallel with the other sources, and linked with them into one library
// with a plain C interface (mkv_error_string is defined in
// sha256_kernels.cu); cuda_lib.py binds the entry points below with ctypes
// and ops/merkle_paths.py wraps them. Every
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
// DISTINCT touched internal node once (about 33,000 at k = 4096 random
// leaves of 2^20). Throughput bound: about 3.6 us (chip_smoke.py's bound
// arithmetic). But the root's path is a dependent chain of a leaf hash and
// depth - 1 node hashes, so the floor is that chain, measured by
// hash_chain_kernel below: one warp, a one-block leaf and 20 node hashes
// that wait on each other, in registers, with the fastest node hash
// (unrolled): 48.0 us at 2^20 on the H100, 2.3-2.4 us a node hash (about
// 4,600 cycles at 1.98 GHz: some 2,300 warp instructions through a 16-lane
// integer pipe; PERF.md). The design before this one (commit d422390)
// took 97.5 us: its walkers, one thread per leaf, met through device memory
// (fence, atomicExch on a per-node counter, fence, L2 load), which cost 32
// us on the serving path (tools/torch_path_split.py, PERF.md).
//
// What the design does about it (merkle_paths.cuh has the protocol): the
// batch is cut into chunks of about 64 sorted positions, cut where two
// neighbours' lowest common ancestor is highest, one 128-thread block each;
// a chunk's walkers take the block's first threads, so about 64 positions
// fill two warps and a warp hashes with most of its lanes (a level costs
// one hash time: one warp per sub-partition). The
// walkers of a chunk meet in shared memory behind __syncthreads; every
// untouched sibling is copied into shared memory a level ahead with
// cp.async, so its latency hides behind the hash. Each block arrives once
// at its group's counter; the last blocks re-hash the nodes the chunks
// share (at most 127 per level and block) and the top levels, which are at
// most 128 nodes wide and fit one block, so no cluster is needed. No block
// ever waits for another: no grid barrier, no cooperative launch. Every
// lane of a warp runs the hash together (branch-free up to it), and the
// node hash's padding rounds are a loop: the unrolled body runs slower on
// some SMs, and the walk goes at its slowest block's pace. The lower levels
// and the top levels keep a loop each, so each body stays small.
//
// The promotion chain is one warp: the lanes load every level's row m-2 at
// once (one memory latency instead of one per level), then one lane walks
// the dependent chain of even levels. Its floor is the chain itself: up to
// depth node hashes in series, one hash time each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merkle_paths.cuh"

namespace {

// blocks [k, nblk, 16] u32, nblocks [k] i32, pos [k] i32 sorted unique;
// scratch [2 G + 3 + ceil(G / kMkvGroup)] i32, G = ceil(k / width): zero on
// entry and on exit. MKV_PATH_MARK(slot) is a no-op here; a phase trace
// (tools/path_split.cu) reads the clock there: 1 start, 2 after the load and
// scoring, 2 + l the start of lower level l, 44 after the arrival, 45 after
// the cuts and the top copy, 47 + l - top the end of top level l, 62 the
// end of the last block.
__global__ void __launch_bounds__(kMkvPathThreads)
path_rehash_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ nblocks,
                   const int32_t* __restrict__ pos, int32_t k, int32_t nblk, int32_t width,
                   int32_t top, const MkvLevels levels, int32_t* scratch) {
  __shared__ MkvPathShared S;
  const int32_t t = static_cast<int32_t>(threadIdx.x);
  MKV_PATH_MARK(1);
  const MkvPathBlock B =
      mkv_path_block(k, width, top, levels.depth, static_cast<int32_t>(blockIdx.x));
  mkv_path_load(S, B, levels, pos, nblocks, t);
  __syncthreads();
  mkv_path_score(S, B, t);
  __syncthreads();
  MKV_PATH_MARK(2);
  MkvPathWalker w;
  mkv_path_begin(S, B, w, blocks, nblk, scratch, t);
  // Two loops, each with its own copy of the hash: one loop body with both
  // would not fit the instruction cache (PERF.md).
  for (int32_t l = 1; l < top && __syncthreads_or(w.active); ++l) {
    MKV_PATH_MARK(2 + l);
    mkv_path_level(S, B, w, l, t);
  }
  mkv_copy_wait_all();
  __threadfence();  // release: this thread's stores before the block's arrival
  __syncthreads();
  if (t == 0) S.last = mkv_path_arrive(S, B, w, scratch);
  __syncthreads();
  MKV_PATH_MARK(44);
  if (!S.last) return;
  __threadfence();  // acquire: the group's stores after its last arrival
  MkvCutList cl = mkv_path_group_cuts(B);
  mkv_path_cuts(S, B, scratch, cl, t);
  if (B.ngroups == 1) mkv_path_top_load(S, B, scratch, t);
  __syncthreads();
  MKV_PATH_MARK(45);
  bool reload = B.ngroups > 1 || S.lmin < top;
  for (int32_t l = S.lmin; l < top; ++l) {
    mkv_path_shared_level(S, B, scratch, cl, l, t);
    __syncthreads();
  }
  if (B.ngroups > 1) {
    __threadfence();  // release: the group's shared nodes before its arrival
    __syncthreads();
    if (t == 0) S.last = mkv_path_arrive_all(S, B, scratch);
    __syncthreads();
    if (!S.last) return;
    __threadfence();  // acquire: every group's stores after the last arrival
    cl = mkv_path_boundary_cuts(B);
    mkv_path_cuts(S, B, scratch, cl, t);
    __syncthreads();
    for (int32_t l = S.lmin; l < top; ++l) {
      mkv_path_shared_level(S, B, scratch, cl, l, t);
      __syncthreads();
    }
  }
  if (reload) {
    mkv_path_top_load(S, B, scratch, t);
    __syncthreads();
  }
  for (int32_t l = top; l < levels.depth; ++l) {
    mkv_path_top_level(S, B, l, t);
    __syncthreads();
    MKV_PATH_MARK(47 + l - top);
  }
  mkv_path_clear(B, scratch, t);
  MKV_PATH_MARK(62);
}

// out [nlev, 8]: the reference tree's last node per level over n leaves.
__global__ void __launch_bounds__(32)
promotion_chain_kernel(const MkvLevels levels, int64_t n, int32_t nlev, uint32_t* out) {
  __shared__ __align__(16) uint32_t prev[kMkvMaxLevels * 8];
  for (int32_t l = 1 + threadIdx.x; l < nlev; l += 32) mkv_chain_prev(levels, n, l, prev);
  __syncwarp();
  if (threadIdx.x == 0) mkv_chain_walk(levels.rows[0] + 8 * (n - 1), prev, n, nlev, out);
}

// Measurement only (chip_smoke.py's [times] line, never the kernels line):
// one warp hashes, in registers, what the path rehash's root waits on in
// series: a leaf of nblk message blocks, then d node hashes that each wait
// on the one before, x <- H(x || y). Each lane takes its x and y from in
// [32, 16], and its leaf's blocks are that row nblk times (nblk = 0: no
// leaf); out [32, 8] gets the lanes' last x, and timing [2] the SM clock
// cycles and the global timer's nanoseconds lane 0 spent on the chain. The
// node hash is the fastest this file has (unrolled), so this is the least
// time the card takes for the serial part of the path rehash and of the
// promotion chain (nblk = 0): no memory traffic, nothing to wait for.
__global__ void __launch_bounds__(32)
hash_chain_kernel(const uint32_t* in, int32_t nblk, int32_t d, uint32_t* out, int64_t* timing) {
  uint32_t x[8], y[8], m[16];
  mkv_load16(in + 16 * threadIdx.x, m);
  mkv_load8(in + 16 * threadIdx.x + 8, y);
  uint64_t g0, g1;
  const int64_t c0 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  // The leaf's words as if they came in now: its hash starts after the timer.
  asm volatile("" : "+r"(m[0]), "+r"(m[1]), "+r"(m[2]), "+r"(m[3]), "+r"(m[4]), "+r"(m[5]),
               "+r"(m[6]), "+r"(m[7]), "+r"(m[8]), "+r"(m[9]), "+r"(m[10]), "+r"(m[11]),
               "+r"(m[12]), "+r"(m[13]), "+r"(m[14]), "+r"(m[15]));
  if (nblk > 0) {
    mkv_iv(x);
    for (int32_t b = 0; b < nblk; ++b) {
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = m[i];
      mkv_compress(x, w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = m[i];
  }
  asm volatile("" : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
               "+r"(x[6]), "+r"(x[7]));
  for (int32_t j = 0; j < d; ++j) {
    uint32_t r[8];
    mkv_node_hash(x, y, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = r[i];
  }
  asm volatile("" : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
               "+r"(x[6]), "+r"(x[7]));
  const int64_t c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  mkv_store8(out + 8 * threadIdx.x, x);
  if (threadIdx.x == 0) {
    timing[0] = c1 - c0;
    timing[1] = static_cast<int64_t>(g1 - g0);
  }
}

}  // namespace

extern "C" {

int mkv_hash_chain(const void* in, int32_t nblk, int32_t d, void* out, void* timing,
                   void* stream) {
  hash_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), nblk, d, static_cast<uint32_t*>(out),
      static_cast<int64_t*>(timing));
  return static_cast<int>(cudaGetLastError());
}

// The path-rehash kernel's blocks per arrival group: ops/cuda_lib.py checks
// its PATH_GROUP, with which ops/merkle_paths.py sizes the scratch, against
// this one when the library loads.
int mkv_path_group() { return kMkvGroup; }

int mkv_path_rehash(const MkvLevels* levels, const void* blocks, const void* nblocks,
                    const void* pos, int32_t k, int32_t nblk, int32_t width, int32_t top,
                    void* scratch, void* stream) {
  if (k <= 0) return 0;
  const int32_t depth = levels->depth;
  if (width < 2 || width % 2 || 2 * width > kMkvPathThreads || top < 1 || top >= depth ||
      depth - 1 - top > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>((k + width - 1) / width);
  path_rehash_kernel<<<grid, kMkvPathThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int32_t*>(nblocks),
      static_cast<const int32_t*>(pos), k, nblk, width, top, *levels,
      static_cast<int32_t*>(scratch));
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
