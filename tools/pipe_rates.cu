// Issue cost of the integer instructions SHA-256 is made of, on one NVIDIA
// GPU: per warp instruction, the SM sub-partition (SMSP) cycles it takes
// when every warp of a full SM issues nothing else.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o build/pipe_rates tools/pipe_rates.cu && build/pipe_rates
//
// Each kernel runs one wave (blocks of 256 threads, kBlocksPerSm an SM, so
// 16 warps an SMSP), each thread kChains chains of the instruction under
// test, kSteps x kIters steps each. Every block reads clock64() at its start
// and end; the median block's cycles over the warp instructions each SMSP
// issued is the cost of one (a pipe of 16 lanes takes 2 cycles a warp
// instruction, the issue slot 1). The longest block's cycles over the
// launch's event time say what clock clock64() counts. `one` and the
// multiplier are kernel arguments, so ptxas cannot fold them (`shr` shifts
// by `one`: a chain of constant shifts would fold into one); the listing
// (cuobjdump -sass) says what each kernel issued. Prints one line a kernel.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>
#include <utility>
#include <vector>

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kChains = 8;
constexpr int kSteps = 16;
constexpr int kIters = 256;

enum Op {
  kShfWrap,    // rotr by a funnel shift: SHF.R.W.U32
  kShr,        // a logical shift right: SHF.R.U32.HI
  kLop3,       // a three-input XOR: LOP3
  kIadd3,      // a + b + c: IADD3
  kImad,       // a * one + b: IMAD
  kImadHi,     // hi(a * m): IMAD.HI.U32
  kRotHi,      // rotr as a * m + hi(a * m), m = 2^(32 - n): IMAD.HI + IMAD
  kRotWide,    // rotr as lo | hi of a * m: IMAD.WIDE.U32 + LOP3
  kRotShr,     // rotr as a * m + (a >> n): SHF.R.U32.HI + IMAD
  kShfLop3,    // SHF.R.W and LOP3, one each a step
  kShfImad,    // SHF.R.W and IMAD, one each a step
  kLop3Imad,   // LOP3 and IMAD, one each a step
  kShf2Lop3Imad,  // 2 SHF.R.W, 1 LOP3, 1 IMAD a step: a round's mix without adds on the ALU
  kOps
};
const char* kNames[kOps] = {"shf_wrap", "shr", "lop3", "iadd3", "imad", "imad_hi",
                            "rot_hi", "rot_wide", "rot_shr", "shf+lop3", "shf+imad", "lop3+imad",
                            "2shf+lop3+imad"};
// Warp instructions a step issues, per chain.
const int kPerStep[kOps] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 4};

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t a, uint32_t b, uint32_t c, uint32_t one,
                                         uint32_t m) {
  uint32_t d, e;
  if constexpr (OP == kShfWrap) {
    asm("shf.r.wrap.b32 %0, %1, %1, 7;" : "=r"(d) : "r"(a));
  } else if constexpr (OP == kShr) {
    asm("shr.b32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(one));  // by a register: no fold
  } else if constexpr (OP == kLop3) {
    asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  } else if constexpr (OP == kIadd3) {
    asm("add.u32 %0, %1, %2;" : "=r"(e) : "r"(a), "r"(b));
    asm("add.u32 %0, %1, %2;" : "=r"(d) : "r"(e), "r"(c));
  } else if constexpr (OP == kImad) {
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));
  } else if constexpr (OP == kImadHi) {
    asm("mul.hi.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(m));
  } else if constexpr (OP == kRotHi) {
    asm("mul.hi.u32 %0, %1, %2;" : "=r"(e) : "r"(a), "r"(m));
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(m), "r"(e));
  } else if constexpr (OP == kRotWide) {
    uint64_t w;
    asm("mul.wide.u32 %0, %1, %2;" : "=l"(w) : "r"(a), "r"(m));
    asm("lop3.b32 %0, %1, %2, %3, 0xfe;"
        : "=r"(d) : "r"(static_cast<uint32_t>(w)), "r"(static_cast<uint32_t>(w >> 32)), "r"(b));
  } else if constexpr (OP == kRotShr) {
    asm("shr.b32 %0, %1, 7;" : "=r"(e) : "r"(a));
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(m), "r"(e));
  } else if constexpr (OP == kShfLop3) {
    asm("shf.r.wrap.b32 %0, %1, %1, 7;" : "=r"(e) : "r"(a));
    asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(e), "r"(b), "r"(c));
  } else if constexpr (OP == kShfImad) {
    asm("shf.r.wrap.b32 %0, %1, %1, 7;" : "=r"(e) : "r"(a));
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(e), "r"(one), "r"(b));
  } else if constexpr (OP == kLop3Imad) {
    asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(e) : "r"(a), "r"(b), "r"(c));
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(e), "r"(one), "r"(b));
  } else {
    uint32_t f, g;
    asm("shf.r.wrap.b32 %0, %1, %1, 7;" : "=r"(e) : "r"(a));
    asm("shf.r.wrap.b32 %0, %1, %1, 13;" : "=r"(f) : "r"(a));
    asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(g) : "r"(e), "r"(f), "r"(c));
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(g), "r"(one), "r"(b));
  }
  return d;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
rate_kernel(uint32_t seed, uint32_t one, uint32_t m, uint32_t* sink, long long* cycles) {
  uint32_t x[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) x[i] = seed ^ (threadIdx.x * kChains + i) * 0x9e3779b9u;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int i = 0; i < kChains; ++i) {
        x[i] = step<OP>(x[i], x[(i + 1) % kChains], x[(i + 2) % kChains], one, m);
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) acc ^= x[i];
  if (acc == seed) sink[0] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// (cycles a warp instruction an SMSP, the longest block's clock64 cycles
// over the launch's event time in GHz: the clock the cycles count).
template <int OP>
std::pair<double, double> run(int blocks, long long* d_cycles, uint32_t* d_sink) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  rate_kernel<OP><<<blocks, kThreads>>>(0x1234567u, 1u, 1u << 25, d_sink, d_cycles);  // warm-up
  cudaEventRecord(a);
  rate_kernel<OP><<<blocks, kThreads>>>(0x7654321u, 1u, 1u << 25, d_sink, d_cycles);
  cudaEventRecord(b);
  if (cudaDeviceSynchronize() != cudaSuccess) return {-1.0, -1.0};
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  std::vector<long long> c(blocks);
  cudaMemcpy(c.data(), d_cycles, blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  const long long longest = *std::max_element(c.begin(), c.end());
  std::nth_element(c.begin(), c.begin() + blocks / 2, c.end());
  // Warp instructions an SMSP issued in the block's time: 16 warps each.
  const double warps = kThreads / 32 * kBlocksPerSm / 4.0;
  const double instr = warps * kIters * kSteps * kChains * kPerStep[OP];
  return {static_cast<double>(c[blocks / 2]) / instr, longest / (ms * 1e6)};
}

template <int OP>
void report(int blocks, long long* d_cycles, uint32_t* d_sink) {
  if constexpr (OP < kOps) {
    const auto r = run<OP>(blocks, d_cycles, d_sink);
    printf("%-16s %.3f cycles a warp instruction an SMSP (clock64 at %.3f GHz by events)\n",
           kNames[OP], r.first, r.second);
    report<OP + 1>(blocks, d_cycles, d_sink);
  }
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * kBlocksPerSm;
  long long* d_cycles;
  uint32_t* d_sink;
  cudaMalloc(&d_cycles, blocks * sizeof(long long));
  cudaMalloc(&d_sink, sizeof(uint32_t));
  printf("%d SMs, %d blocks of %d threads (16 warps an SMSP), %d chains a thread\n", sms,
         blocks, kThreads, kChains);
  report<0>(blocks, d_cycles, d_sink);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
