// SHA-256 round math shared by the kernels in sha256_kernels.cu and
// merkle_paths.cu.
//
// Counterpart of _compress_tiles / _compress_tiles_const in
// merklekv_tpu/ops/sha256_pallas.py, written for one message per thread:
// the 8 state words and a rolling 16-word schedule window live in
// registers (the loops are fully unrolled, so every array index is a
// compile-time constant), rotr is one funnel shift, and the round
// constants are read from constant memory, where every thread of a warp
// reads the same word in the same cycle (a broadcast).
//
// Under a host C++ compiler the same functions build as plain inline host
// code (no CUDA keywords), so the round math, both ways of adding and both
// constant tables can be checked against hashlib without a GPU
// (tests/test_torch_csrc_core.py).

#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define MKV_FN __device__ __forceinline__
#define MKV_MEMBER __device__ __forceinline__
// static: each source that includes this header keeps its own copy of the
// tables, so the sources link into one library without a clash.
#define MKV_CONST static __constant__
#else
#define MKV_FN static inline
#define MKV_MEMBER inline
#define MKV_CONST static const
#endif

// FIPS 180-4 round constants.
MKV_CONST uint32_t kSha256K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// K[t] + W[t] (mod 2^32) of the constant padding block of a 64-byte message
// (0x80000000, 14 zero words, bit length 512): the same fold as _const_kw in
// sha256_pallas.py, done once. The node hash's second compression needs no
// message schedule and one add less per round.
MKV_CONST uint32_t kNodePadKW[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

MKV_FN uint32_t mkv_rotr(uint32_t x, int n) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

MKV_FN void mkv_iv(uint32_t s[8]) {
  s[0] = 0x6a09e667u; s[1] = 0xbb67ae85u; s[2] = 0x3c6ef372u; s[3] = 0xa54ff53au;
  s[4] = 0x510e527fu; s[5] = 0x9b05688cu; s[6] = 0x1f83d9abu; s[7] = 0x5be0cd19u;
}

// How the compression adds: the template argument of mkv_round,
// mkv_compress, mkv_compress_rolled and mkv_compress_node_pad. Both give the
// same sums mod 2^32 and differ only in the instructions ptxas issues.
//
// MkvAluAdd, the default: plain `+`. ptxas fuses up to three inputs into one
// IADD3 on the INT32 ALU and issues some adds as IMAD.IADD itself (241 and
// 119 of a message block's adds in the padded leaf kernel). The kernels
// bound by one warp's dependent chain (a warp alone on its SMSP) keep it:
// three inputs an add leave fewer dependent instructions from e to the next e.
struct MkvAluAdd {
  MKV_MEMBER uint32_t operator()(uint32_t a, uint32_t b) const { return a + b; }
};

// MkvFmaAdd: every add is mad.lo.u32 a * one + b, with one == 1 handed in as
// a kernel argument, so ptxas cannot fold the multiply back into an IADD3
// (it does for a literal 1) and issues IMAD on the FMA pipe; the round
// constant comes in as IMAD's constant-bank operand. The ALU then issues only
// shifts and logic, the FMA pipe the 600 two-input adds of a block. The
// kernels whose grids are far wider than the card take it together with
// mkv_compress_rolled: apart, neither made them faster (PERF.md). On the host
// it is the same multiply-add in plain C++.
struct MkvFmaAdd {
  uint32_t one;
  MKV_MEMBER uint32_t operator()(uint32_t a, uint32_t b) const {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));
    return d;
#else
    return a * one + b;
#endif
  }
};

// One round over the working variables v[0..7] = a..h; kw = K[t] + W[t].
// The rename a..h -> new a, a..g is a register relabelling after unrolling.
template <class Add = MkvAluAdd>
MKV_FN void mkv_round(uint32_t v[8], uint32_t kw, Add add = Add()) {
  const uint32_t a = v[0], b = v[1], c = v[2], d = v[3];
  const uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
  const uint32_t s1 = mkv_rotr(e, 6) ^ mkv_rotr(e, 11) ^ mkv_rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = add(add(add(h, s1), ch), kw);
  const uint32_t s0 = mkv_rotr(a, 2) ^ mkv_rotr(a, 13) ^ mkv_rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  v[7] = g; v[6] = f; v[5] = e; v[4] = add(d, t1);
  v[3] = c; v[2] = b; v[1] = a; v[0] = add(add(t1, s0), maj);
}

// Message schedule word t >= 16 into the rolling window: w[t & 15] becomes
// W[t] from W[t-16], W[t-15], W[t-7] and W[t-2], all still in the window.
template <class Add>
MKV_FN void mkv_schedule(uint32_t w[16], int t, Add add) {
  const uint32_t wm15 = w[(t - 15) & 15], wm2 = w[(t - 2) & 15];
  const uint32_t s0 = mkv_rotr(wm15, 7) ^ mkv_rotr(wm15, 18) ^ (wm15 >> 3);
  const uint32_t s1 = mkv_rotr(wm2, 17) ^ mkv_rotr(wm2, 19) ^ (wm2 >> 10);
  w[t & 15] = add(add(add(w[t & 15], s0), w[(t - 7) & 15]), s1);
}

// One compression of the 16-word block w (overwritten: it is the rolling
// schedule window) into state s.
template <class Add = MkvAluAdd>
MKV_FN void mkv_compress(uint32_t s[8], uint32_t w[16], Add add = Add()) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) mkv_schedule(w, t, add);
    mkv_round(v, add(kSha256K[t], w[t & 15]), add);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = add(s[i], v[i]);
}

// The same compression with rounds 16-63 as three trips of a loop over 16
// unrolled rounds (schedule word, then round): every window index stays a
// compile-time constant, the a..h relabelling comes back to where it began
// after each trip, and K[t0 + t] is a warp-uniform load. Half the
// instructions of mkv_compress's straight line (leaf_kernel in the FMA
// form: 824 against 1736), and the wide kernels that add in the FMA form
// run faster with it: unrolled, the FMA form gained them nothing (PERF.md).
template <class Add = MkvAluAdd>
MKV_FN void mkv_compress_rolled(uint32_t s[8], uint32_t w[16], Add add = Add()) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll
  for (int t = 0; t < 16; ++t) mkv_round(v, add(kSha256K[t], w[t]), add);
#pragma unroll 1
  for (int t0 = 16; t0 < 64; t0 += 16) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      mkv_schedule(w, t + 16, add);
      mkv_round(v, add(kSha256K[t0 + t], w[t]), add);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = add(s[i], v[i]);
}

// The second compression of a 64-byte (node) message: the constant padding
// block, with its K[t] + W[t] already folded into kNodePadKW.
template <class Add = MkvAluAdd>
MKV_FN void mkv_compress_node_pad(uint32_t s[8], Add add = Add()) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) mkv_round(v, kNodePadKW[t], add);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = add(s[i], v[i]);
}
