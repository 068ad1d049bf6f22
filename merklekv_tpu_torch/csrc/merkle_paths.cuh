// The serving tree's path walk, shared by the kernels in merkle_paths.cu and
// a host rehearsal (tests/test_torch_csrc_core.py).
//
// Like sha256_core.cuh, every function here builds as device code under nvcc
// and as plain inline host C++ under a host compiler. Only the memory
// operations of the arrival protocol differ: on the card they are
// __threadfence, atomicExch and an L2 load (__ldcg); on the host they are
// plain loads and stores, which is exact when the host runs the walkers one
// step at a time in any interleaving (a rehearsal of the protocol's logic,
// not of its memory ordering).
//
// Tree layout: a full binary tree of capacity C = 2^(depth-1) leaves;
// rows[l] is level l, C >> l nodes of 8 uint32 words, row-major. The arrival
// counters hold one int32 per internal node, heap-ordered: node j of level
// l >= 1 owns counters[(C >> l) + j - 1], C - 1 in all, all zero between
// launches.

#pragma once
#include <stdint.h>

#include "sha256_core.cuh"

// Row pointers of every level, passed to a kernel by value (a plain
// parameter struct: no device pointer table, no copy to the device).
constexpr int kMkvMaxLevels = 64;
struct MkvLevels {
  uint32_t* rows[kMkvMaxLevels];
  int32_t depth;
};

// One walker: a node whose digest s is already stored at rows[lv][node],
// with the run [a, b) of batch entries (indices into the sorted positions)
// that lie under it.
struct MkvWalker {
  int64_t node;
  int32_t lv;
  int32_t a, b;
  uint32_t s[8];
};

enum { kMkvClimb = 0, kMkvYield = 1, kMkvRoot = 2 };

#ifdef __CUDACC__
MKV_FN void mkv_load8(const uint32_t* p, uint32_t s[8]) {
  const uint4 x = reinterpret_cast<const uint4*>(p)[0];
  const uint4 y = reinterpret_cast<const uint4*>(p)[1];
  s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
  s[4] = y.x; s[5] = y.y; s[6] = y.z; s[7] = y.w;
}
// A digest another thread stored during this launch: read through L2, past
// this SM's L1, after the acquiring fence.
MKV_FN void mkv_load8_fresh(const uint32_t* p, uint32_t s[8]) {
  const uint4 x = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint4 y = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
  s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
  s[4] = y.x; s[5] = y.y; s[6] = y.z; s[7] = y.w;
}
MKV_FN void mkv_store8(uint32_t* p, const uint32_t s[8]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(s[0], s[1], s[2], s[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(s[4], s[5], s[6], s[7]);
}
MKV_FN void mkv_load16(const uint32_t* p, uint32_t w[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[q];
    w[4 * q + 0] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
}
MKV_FN void mkv_fence() { __threadfence(); }
MKV_FN int32_t mkv_exchange(int32_t* p, int32_t v) { return atomicExch(p, v); }
#else
MKV_FN void mkv_load8(const uint32_t* p, uint32_t s[8]) {
  for (int i = 0; i < 8; ++i) s[i] = p[i];
}
MKV_FN void mkv_load8_fresh(const uint32_t* p, uint32_t s[8]) { mkv_load8(p, s); }
MKV_FN void mkv_store8(uint32_t* p, const uint32_t s[8]) {
  for (int i = 0; i < 8; ++i) p[i] = s[i];
}
MKV_FN void mkv_load16(const uint32_t* p, uint32_t w[16]) {
  for (int i = 0; i < 16; ++i) w[i] = p[i];
}
MKV_FN void mkv_fence() {}
MKV_FN int32_t mkv_exchange(int32_t* p, int32_t v) {
  const int32_t old = *p;
  *p = v;
  return old;
}
#endif

// SHA256(left || right) of two digests.
MKV_FN void mkv_node_hash(const uint32_t l[8], const uint32_t r[8], uint32_t out[8]) {
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

// Walker i: hash its leaf (min(nb, nblk) blocks of 16 words at msg), store
// the digest at rows[0][pos[i]], and stand on that leaf with the run [i, i+1).
MKV_FN void mkv_path_begin(MkvWalker& w, const MkvLevels& L, const uint32_t* msg,
                           int32_t nb, int32_t nblk, const int32_t* pos, int32_t i) {
  w.node = pos[i];
  mkv_iv(w.s);
  nb = nb < nblk ? nb : nblk;
  for (int32_t b = 0; b < nb; ++b) {
    uint32_t blk[16];
    mkv_load16(msg + 16 * b, blk);
    mkv_compress(w.s, blk);
  }
  w.lv = 0;
  w.a = i;
  w.b = i + 1;
  mkv_store8(L.rows[0] + 8 * w.node, w.s);
}

// One level up. pos [k] holds the batch's leaf positions, sorted and unique,
// so the entries under any node form one contiguous run, and the entries
// under a node's sibling, if any, sit right beside that run:
// - sibling untouched (no entry under it): its digest is not written during
//   the launch; read it, hash the pair, store the parent, climb;
// - sibling touched: its own walker climbs to the same parent. Both publish
//   their digest (stored one step earlier), fence, and swap their outer run
//   bound + 1 into the parent's counter. The first arrival reads 0 and
//   yields; the second reads the other's bound, resets the counter to 0
//   (the scratch stays zero between launches without a memset), fences,
//   reads the sibling's fresh digest through L2, merges the runs, hashes,
//   stores the parent and climbs.
// Every touched node is hashed exactly once; no thread ever waits.
MKV_FN int mkv_path_step(MkvWalker& w, const MkvLevels& L, int32_t* ctr,
                         const int32_t* pos, int32_t k) {
  if (w.lv + 1 >= L.depth) return kMkvRoot;
  const int64_t sib = w.node ^ 1, parent = w.node >> 1;
  const bool left = (w.node & 1) == 0;
  const int sh = w.lv;
  const bool touched = left ? (w.b < k && (static_cast<int64_t>(pos[w.b]) >> sh) == sib)
                            : (w.a > 0 && (static_cast<int64_t>(pos[w.a - 1]) >> sh) == sib);
  uint32_t other[8];
  if (touched) {
    const int64_t cap = int64_t{1} << (L.depth - 1);
    int32_t* c = ctr + ((cap >> (w.lv + 1)) + parent - 1);
    mkv_fence();  // release: my digest before my arrival
    const int32_t got = mkv_exchange(c, (left ? w.a : w.b) + 1);
    if (got == 0) return kMkvYield;
    *c = 0;
    mkv_fence();  // acquire: the sibling's digest after its arrival
    mkv_load8_fresh(L.rows[w.lv] + 8 * sib, other);
    if (left) {
      w.b = got - 1;
    } else {
      w.a = got - 1;
    }
  } else {
    mkv_load8(L.rows[w.lv] + 8 * sib, other);
  }
  uint32_t lw[8], rw[8];  // selects, so the hash is inlined once
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lw[i] = left ? w.s[i] : other[i];
    rw[i] = left ? other[i] : w.s[i];
  }
  mkv_node_hash(lw, rw, w.s);
  w.node = parent;
  w.lv += 1;
  mkv_store8(L.rows[w.lv] + 8 * w.node, w.s);
  return w.lv + 1 >= L.depth ? kMkvRoot : kMkvClimb;
}

// Reference size of level l over n leaves (ceil-halving l times).
MKV_FN int64_t mkv_ref_size(int64_t n, int32_t l) {
  for (int32_t i = 0; i < l; ++i) n = (n + 1) / 2;
  return n;
}

// prev[l] for the chain walk below: the padded level l-1's row m - 2, where
// m is the reference size of level l-1, when m is even (the only case the
// walk reads it). The rows are independent, so the lanes of a warp load
// them all at once.
MKV_FN void mkv_chain_prev(const MkvLevels& L, int64_t n, int32_t l, uint32_t* prev) {
  const int64_t m = mkv_ref_size(n, l - 1);
  if (m % 2 == 0) {
    uint32_t s[8];
    mkv_load8(L.rows[l - 1] + 8 * (m - 2), s);
    mkv_store8(prev + 8 * l, s);
  }
}

// The odd-promotion reference tree's last node at each of its nlev levels
// over the first n leaves, from the padded levels (only that one position
// per level differs between the two trees), into out [nlev, 8]. The walk is
// the dependent chain of the even levels: last = H(prev[l], last); an odd
// level promotes last unchanged.
MKV_FN void mkv_chain_walk(const uint32_t* leaf_last, const uint32_t* prev, int64_t n,
                           int32_t nlev, uint32_t* out) {
  uint32_t last[8];
  mkv_load8(leaf_last, last);
  mkv_store8(out, last);
  int64_t m = n;
  for (int32_t l = 1; l < nlev; ++l) {
    if (m % 2 == 0) {
      uint32_t p[8], r[8];
      mkv_load8(prev + 8 * l, p);
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = last[i];
      mkv_node_hash(p, r, last);
    }
    mkv_store8(out + 8 * l, last);
    m = (m + 1) / 2;
  }
}

