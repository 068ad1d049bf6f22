// The serving tree's path rehash and promotion chain, shared by the kernels
// in merkle_paths.cu and a host rehearsal (tests/test_torch_csrc_core.py).
//
// Like sha256_core.cuh, every function here builds as device code under nvcc
// and as plain inline host C++ under a host compiler. The path rehash is
// written as per-thread phases that the kernel runs one after another with a
// block barrier between two phases; the host rehearsal runs the same phases
// for every block and thread in random orders. Only the memory operations
// differ: on the card they are cp.async copies, fences, an atomicAdd, a
// shared-memory atomicMax/atomicMin and L2 loads (__ldcg); on the host they
// are plain loads and stores, which is exact when the host runs the phases
// one at a time (a rehearsal of the protocol's logic, not of its memory
// ordering).
//
// Tree layout: a full binary tree of capacity C = 2^(depth-1) leaves;
// rows[l] is level l, C >> l nodes of 8 uint32 words, row-major.
//
// The path rehash. Positions pos [k] are sorted and unique, so the batch
// entries under any node form one run of indices. The batch is cut into
// G = ceil(k / W) chunks of indices, one thread block each: cut g (1 <= g <
// G) lies in the window [W g - W/2, W g + W/2) at the index c whose
// neighbours pos[c-1], pos[c] have the highest lowest common ancestor
// (lca(c) = bit length of pos[c-1] ^ pos[c]; ties to the lowest c), so a
// chunk holds 1 to 2W - 1 entries and, where the batch allows, whole
// aligned subtrees. The blocks of cuts g and g+1 compute the cut from the
// same positions, so they agree without talking. Below a fixed top level T
// (at most kMkvTopNodes nodes wide), a node is interior to a chunk when
// every entry under it is in that chunk, and shared otherwise: it contains
// a cut, i.e. lca(c) <= l and pos[c-1] >> l == node.
//
// 1. Each block walks its chunk up to level T - 1: one walker per entry,
//    thread t walking entry c0 + t of chunk [c0, c1), so that a chunk fills
//    the fewest warps (the block's arrays hold the 2W candidate entries, at
//    slot i - W blk + W/2); the leftmost entry under a node carries its
//    digest up (left
//    continues), and a walker whose left sibling is touched stops. Siblings
//    meet in shared memory behind the block barrier; an untouched sibling
//    is never written during the launch, so its digest is copied into
//    shared memory a level ahead (cp.async). A walker parks below T, or
//    where its parent is shared (only the chunk's two cuts can be inside
//    it). The first walker under each level-T node sets that node's bit in
//    a bitmap in the scratch.
// 2. Each block publishes its two cuts (pos[c-1], lca(c)) in the scratch,
//    fences, and arrives once at its group's counter (groups of kMkvGroup
//    consecutive blocks).
// 3. The last block of a group re-hashes the shared nodes below T whose
//    cuts all lie inside the group (the others contain one of the group's
//    two boundary cuts), level by level from the lowest lca up, each by the
//    first cut inside it (its owner; the cuts inside a node are
//    consecutive, so the owner test looks only at the cut before), from its
//    children in L2. With more than one group it then arrives at the
//    counter of all groups, and the last one re-hashes the shared nodes
//    that contain a boundary cut in the same way, owned by the first
//    boundary cut inside them. So no block hashes more than kMkvGroup - 1
//    shared nodes per level.
// 4. That last block copies levels T - 1 to the root into shared memory in
//    one round trip (with the cuts, when it is the only group and no cut
//    lies below T), hashes every touched node from T up there, one thread
//    per node, the bitmap saying which are touched, and zeroes the scratch.
// Every touched internal node is hashed exactly once: an interior one below
// T by its leftmost walker, a shared one below T by its owner, one at or
// above T by the last block of all.

#pragma once
#include <stdint.h>
#include <string.h>

#include "sha256_core.cuh"

// Row pointers of every level, passed to a kernel by value (a plain
// parameter struct: no device pointer table, no copy to the device).
constexpr int kMkvMaxLevels = 64;
struct MkvLevels {
  uint32_t* rows[kMkvMaxLevels];
  int32_t depth;
};

// Threads per path-rehash block: one walker per entry of a chunk, which
// spans at most 2W <= kMkvPathThreads entries (W = the chunk width).
constexpr int kMkvPathThreads = 128;
// Nodes of the top level T (at most): the last block holds levels T - 1 to
// the root in shared memory, in heap order (node n of level l at
// (C >> l) + n, the root at 1), fewer than 4 kMkvTopNodes digests.
constexpr int kMkvTopNodes = 128;
// Blocks per arrival group: the most cuts a finishing block walks per level
// (PATH_GROUP of ops/cuda_lib.py, which sizes the scratch, is the same; a
// rehearsal may define a smaller group, to have many groups on small trees).
#ifndef MKV_PATH_GROUP
#define MKV_PATH_GROUP 128
#endif
constexpr int kMkvGroup = MKV_PATH_GROUP;
// Cuts whose (pos[c-1], lca) a finishing block keeps in shared memory;
// further cuts are read from the scratch in L2.
constexpr int kMkvCutCache = 256;
// Scratch layout: [0] the counter of all groups, [1, 5) the level-T bitmap,
// then one counter per group, then (pos[c-1], lca(c)) of cut c at
// [cuts + 2c - 2], [cuts + 2c - 1]: 2 G + 3 + ceil(G / kMkvGroup) words.
constexpr int kMkvBitmap = 1;
constexpr int kMkvGroupCounters = 5;

// A rehearsal may count each node hash (level, node); a no-op otherwise.
#ifndef MKV_PATH_ON_HASH
#define MKV_PATH_ON_HASH(level, node)
#endif
// A phase trace may read the clock at the path-rehash kernel's phase
// boundaries (slot numbers in csrc/merkle_paths.cu); a no-op otherwise.
#ifndef MKV_PATH_MARK
#define MKV_PATH_MARK(slot)
#endif

#ifdef __CUDACC__
MKV_FN void mkv_load8(const uint32_t* p, uint32_t s[8]) {
  const uint4 x = reinterpret_cast<const uint4*>(p)[0];
  const uint4 y = reinterpret_cast<const uint4*>(p)[1];
  s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
  s[4] = y.x; s[5] = y.y; s[6] = y.z; s[7] = y.w;
}
// A digest another block or thread stored during this launch: read through
// L2, past this SM's L1, after the acquiring fence or barrier.
MKV_FN void mkv_load8_l2(const uint32_t* p, uint32_t s[8]) {
  const uint4 x = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint4 y = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
  s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
  s[4] = y.x; s[5] = y.y; s[6] = y.z; s[7] = y.w;
}
MKV_FN int32_t mkv_load_l2(const int32_t* p) { return __ldcg(p); }
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
// A digest (32 bytes, 16-byte aligned) from global into shared memory,
// without a register: two cp.async of 16 bytes through L2.
MKV_FN void mkv_copy8_async(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16), "l"(src + 4)
               : "memory");
}
MKV_FN void mkv_copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Every committed group of this thread but the newest has landed.
MKV_FN void mkv_copy_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
MKV_FN void mkv_fence() { __threadfence(); }
MKV_FN int32_t mkv_arrive(int32_t* p) { return atomicAdd(p, 1); }
MKV_FN void mkv_set_bit(int32_t* words, int32_t bit) {
  atomicOr(reinterpret_cast<unsigned*>(words) + (bit >> 5), 1u << (bit & 31));
}
MKV_FN void mkv_copy_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
MKV_FN void mkv_shared_max(int32_t* p, int32_t v) { atomicMax(p, v); }
MKV_FN void mkv_shared_min(int32_t* p, int32_t v) { atomicMin(p, v); }
MKV_FN int32_t mkv_bit_length(uint32_t x) { return 32 - __clz(static_cast<int>(x)); }
// Every lane of the warp here at once before a hash: lanes that took
// different branches above would otherwise run the hash one group after
// the other (no reconvergence point is guaranteed before it).
MKV_FN void mkv_converge() { __syncwarp(); }
// Whether the warp hashes: every lane of it at once (inactive lanes on a
// stand-in) when any lane stores, so the warp hashes once; a warp with no
// lane to store skips the hash.
MKV_FN bool mkv_warp_hashes(bool stores) { return __any_sync(0xffffffffu, stores); }
#else
MKV_FN void mkv_load8(const uint32_t* p, uint32_t s[8]) {
  for (int i = 0; i < 8; ++i) s[i] = p[i];
}
MKV_FN void mkv_load8_l2(const uint32_t* p, uint32_t s[8]) { mkv_load8(p, s); }
MKV_FN int32_t mkv_load_l2(const int32_t* p) { return *p; }
MKV_FN void mkv_store8(uint32_t* p, const uint32_t s[8]) {
  for (int i = 0; i < 8; ++i) p[i] = s[i];
}
MKV_FN void mkv_load16(const uint32_t* p, uint32_t w[16]) {
  for (int i = 0; i < 16; ++i) w[i] = p[i];
}
MKV_FN void mkv_copy8_async(uint32_t* dst, const uint32_t* src) {
  memcpy(dst, src, 32);
}
MKV_FN void mkv_copy_commit() {}
MKV_FN void mkv_copy_wait_prior() {}
MKV_FN void mkv_fence() {}
MKV_FN int32_t mkv_arrive(int32_t* p) { return (*p)++; }
MKV_FN void mkv_set_bit(int32_t* words, int32_t bit) {
  words[bit >> 5] = static_cast<int32_t>(static_cast<uint32_t>(words[bit >> 5]) |
                                         (1u << (bit & 31)));
}
MKV_FN void mkv_copy_wait_all() {}
MKV_FN void mkv_shared_max(int32_t* p, int32_t v) {
  if (v > *p) *p = v;
}
MKV_FN void mkv_shared_min(int32_t* p, int32_t v) {
  if (v < *p) *p = v;
}
MKV_FN int32_t mkv_bit_length(uint32_t x) { return 32 - __builtin_clz(x); }
MKV_FN void mkv_converge() {}
// The host runs one lane at a time: only a lane that stores hashes.
MKV_FN bool mkv_warp_hashes(bool stores) { return stores; }
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

// The path rehash's node hash: the same function, with the padding block's
// 64 rounds as two trips of 32. The unrolled node hash is about 2,400
// instructions (38 KB) of straight-line code, and on the H100 measured
// some SMs run it markedly slower than others, while the shorter loop body
// runs at one pace on every SM (tools/torch_path_split.py, PERF.md). A walk
// runs at the pace of its slowest block, so the path rehash takes this one.
MKV_FN void mkv_compress_node_pad_rolled(uint32_t s[8]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll 1
  for (int t0 = 0; t0 < 64; t0 += 32) {
#pragma unroll
    for (int t = 0; t < 32; ++t) mkv_round(v, kNodePadKW[t0 + t]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] += v[i];
}

MKV_FN void mkv_node_hash_rolled(const uint32_t l[8], const uint32_t r[8], uint32_t out[8]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = l[i];
    w[8 + i] = r[i];
  }
  mkv_iv(out);
  mkv_compress(out, w);
  mkv_compress_node_pad_rolled(out);
}

// ------------------------------------------------------------ path rehash

// What every thread of block blk knows before it reads anything.
struct MkvPathBlock {
  int32_t k, width, groups, blk;
  int32_t base;  // index of the block's first candidate entry: W blk - W/2
  int32_t top;   // the top level T: 1 <= T < depth, C >> T <= kMkvTopNodes
  int32_t depth;
  int32_t ngroups;  // arrival groups: ceil(G / kMkvGroup)
  int32_t cuts;     // scratch offset of the cuts
};

MKV_FN MkvPathBlock mkv_path_block(int32_t k, int32_t width, int32_t top, int32_t depth,
                                   int32_t blk) {
  MkvPathBlock b;
  b.k = k;
  b.width = width;
  b.groups = (k + width - 1) / width;
  b.blk = blk;
  b.base = width * blk - width / 2;
  b.top = top;
  b.depth = depth;
  b.ngroups = (b.groups + kMkvGroup - 1) / kMkvGroup;
  b.cuts = kMkvGroupCounters + b.ngroups;
  return b;
}

// One block's shared memory.
struct MkvPathShared {
  uint32_t* rows[kMkvMaxLevels];  // MkvLevels::rows
  alignas(16) uint32_t dig[kMkvPathThreads][8];     // each walker's digest
  alignas(16) uint32_t sib[2][kMkvPathThreads][8];  // untouched siblings, two levels
  int32_t pos[kMkvPathThreads + 1];  // pos[base - 1 + j] at j (-1 outside [0, k))
  int32_t run[kMkvPathThreads];      // each walker's run end
  int32_t nb[kMkvPathThreads];       // each candidate entry's block count
  int32_t best[2];                   // the two cuts' keys: lca << 8 | 255 - offset
  int32_t last;                      // this block arrived last
  int32_t lmin;                      // lowest lca over all cuts
  int32_t cut_lp[kMkvCutCache];      // pos[c-1] of the j-th cut of a list at [j]
  int32_t cut_lca[kMkvCutCache];     // its lca(c)
  int32_t bnd_lp[2], bnd_lca[2];     // a group's boundary cuts (lca kMkvMaxLevels: none)
  uint32_t bitmap[kMkvTopNodes / 32];  // touched nodes of level T
  alignas(16) uint32_t tree[4 * kMkvTopNodes][8];  // levels T - 1 .. root, heap order
};

// One walker: the entry i = c0 + thread while it is in the chunk, at slot
// e = i - base of the block's arrays (e = the thread outside the chunk,
// where only reads happen); its node holds digest s and the run [i, run)
// of entries.
struct MkvPathWalker {
  int64_t node;
  int32_t i, e, run;
  int32_t c0, c1;  // the chunk [c0, c1)
  int32_t lo, hi;  // pos[c0 - 1] and pos[c1], -1 where that cut is absent
  bool active;
  uint32_t s[8];
};

MKV_FN int32_t mkv_path_pos(const MkvPathShared& S, const MkvPathBlock& B, int32_t i) {
  return S.pos[i - B.base + 1];
}

// Phase 1: the row pointers (indexed by level below, so read from shared
// memory rather than the kernel's parameters) and the block's candidate
// positions into shared memory. Before the chunk is known, every candidate
// entry loads its block count and starts copying its level-1 sibling into
// shared memory (one copy group), so that latency hides behind the cut.
MKV_FN void mkv_path_load(MkvPathShared& S, const MkvPathBlock& B, const MkvLevels& L,
                          const int32_t* pos, const int32_t* nblocks, int32_t t) {
  if (t < L.depth) S.rows[t] = L.rows[t];
  const int32_t i = B.base + t;
  const bool in = t < 2 * B.width && i >= 0 && i < B.k;
  const int32_t p = in ? pos[i] : -1;
  if (t < 2 * B.width) {
    S.pos[t + 1] = p;
    S.nb[t] = in ? nblocks[i] : 0;
  }
  if (in) mkv_copy8_async(S.sib[1][t], L.rows[0] + 8 * (p ^ 1));
  mkv_copy_commit();
  if (t == 0) {
    S.pos[0] = B.base >= 1 ? pos[B.base - 1] : -1;
    S.best[0] = S.best[1] = -1;
    S.lmin = kMkvMaxLevels;
  }
}

// Phase 2: thread t scores the cut candidate c = base + t, in the window of
// cut blk (t < W) or of cut blk + 1.
MKV_FN void mkv_path_score(MkvPathShared& S, const MkvPathBlock& B, int32_t t) {
  if (t >= 2 * B.width) return;
  const int32_t c = B.base + t, side = t < B.width ? 0 : 1, cut = B.blk + side;
  if (cut < 1 || cut >= B.groups || c < 1 || c >= B.k) return;
  const int32_t lca = mkv_bit_length(static_cast<uint32_t>(mkv_path_pos(S, B, c - 1) ^
                                                           mkv_path_pos(S, B, c)));
  mkv_shared_max(&S.best[side], (lca << 8) | (255 - (t - side * B.width)));
}

// Phase 3: decode the chunk, mark the level-T bitmap, hash the leaf and
// store it.
MKV_FN void mkv_path_begin(MkvPathShared& S, const MkvPathBlock& B, MkvPathWalker& w,
                           const uint32_t* blocks, int32_t nblk, int32_t* scratch, int32_t t) {
  const int32_t c0 = B.blk == 0 ? 0 : B.base + (255 - (S.best[0] & 255));
  const int32_t c1 = B.blk == B.groups - 1 ? B.k : B.base + B.width + (255 - (S.best[1] & 255));
  w.i = c0 + t;
  w.c0 = c0;
  w.c1 = c1;
  w.lo = c0 > 0 ? mkv_path_pos(S, B, c0 - 1) : -1;
  w.hi = c1 < B.k ? mkv_path_pos(S, B, c1) : -1;
  w.active = w.i < c1;
  w.e = w.active ? w.i - B.base : t;
  w.node = w.active ? mkv_path_pos(S, B, w.i) : 0;
  w.run = w.i + 1;
  if (w.active) {
    if (w.i == c0 || (mkv_path_pos(S, B, w.i - 1) >> B.top) != (w.node >> B.top)) {
      mkv_set_bit(scratch + kMkvBitmap, static_cast<int32_t>(w.node >> B.top));
    }
  }
  const uint32_t* msg = blocks + static_cast<int64_t>(w.active ? w.i : 0) * nblk * 16;
  int32_t nb = w.active ? S.nb[w.e] : 0;
  nb = nb < nblk ? nb : nblk;
  mkv_iv(w.s);
  mkv_converge();
  for (int32_t b = 0; b < nb; ++b) {
    uint32_t blk[16];
    mkv_load16(msg + 16 * b, blk);
    mkv_compress(w.s, blk);
  }
  if (w.active) {
    mkv_store8(S.rows[0] + 8 * w.node, w.s);
    mkv_store8(S.dig[w.e], w.s);
    S.run[w.e] = w.run;
  }
  // Phase 1's sibling copies were issued by the thread of each slot, not by
  // the walker that reads it: each thread waits for its own here, and the
  // block barrier before level 1 makes them visible to every walker.
  mkv_copy_wait_all();
}

// Phase 4, once per level l = 1, 2, ... below T while any walker of the
// block is active: the walker's parent at level l, unless it is shared
// (park), or the walker is a right child whose left sibling is touched
// (stop: the left sibling's walker takes the parent). Every lane runs to
// the hash without a branch (mkv_warp_hashes); only the active lanes store.
MKV_FN void mkv_path_level(MkvPathShared& S, const MkvPathBlock& B, MkvPathWalker& w,
                           int32_t l, int32_t t) {
  const bool was = w.active;
  const int64_t parent = w.node >> 1, sib = w.node ^ 1;
  const int32_t sh = l - 1;
  const bool left = (w.node & 1) == 0;
  const bool shared = (w.lo >= 0 && (w.lo >> l) == parent) || (w.hi >= 0 && (w.hi >> l) == parent);
  const int32_t next = was && w.run < w.c1 ? w.run : w.c0;  // an index in the block's span
  const int32_t prev = was && w.i > w.c0 ? w.i - 1 : w.c0;
  const bool touched = left && was && w.run < w.c1 && (mkv_path_pos(S, B, next) >> sh) == sib;
  const bool yields = !left && was && w.i > w.c0 && (mkv_path_pos(S, B, prev) >> sh) == sib;
  w.active = was && l < B.top && !shared && !yields;
  // The next level's sibling, copied ahead; a group per level either way.
  if (w.active && l + 1 < B.top) {
    mkv_copy8_async(S.sib[(l + 1) & 1][w.e], S.rows[l] + 8 * (parent ^ 1));
  }
  mkv_copy_commit();
  mkv_copy_wait_prior();
  const int32_t j = next - B.base;
  uint32_t met[8], ahead[8], lw[8], rw[8], out[8];
  mkv_load8(S.dig[j], met);
  mkv_load8(S.sib[l & 1][w.e], ahead);
  const int32_t run = touched ? S.run[j] : w.run;
#pragma unroll
  for (int q = 0; q < 8; ++q) {  // selects, not branches
    const uint32_t other = touched ? met[q] : ahead[q];
    lw[q] = left ? w.s[q] : other;
    rw[q] = left ? other : w.s[q];
  }
  mkv_converge();
  if (mkv_warp_hashes(w.active)) mkv_node_hash_rolled(lw, rw, out);
  if (!w.active) return;
  MKV_PATH_ON_HASH(l, parent);
  w.node = parent;
  w.run = run;
#pragma unroll
  for (int q = 0; q < 8; ++q) w.s[q] = out[q];
  mkv_store8(S.rows[l] + 8 * parent, out);
  mkv_store8(S.dig[w.e], out);
  S.run[w.e] = run;
}

// Cut `cut` (between entries c - 1 and c) into the scratch: (pos[c-1], lca).
MKV_FN void mkv_path_publish(const MkvPathShared& S, const MkvPathBlock& B, int32_t* scratch,
                             int32_t cut, int32_t c) {
  const int32_t lp = mkv_path_pos(S, B, c - 1), rp = mkv_path_pos(S, B, c);
  scratch[B.cuts + 2 * cut - 2] = lp;
  scratch[B.cuts + 2 * cut - 1] = mkv_bit_length(static_cast<uint32_t>(lp ^ rp));
}

// Phase 5 (thread 0, after every thread's fence and a barrier): publish
// both of the block's cuts (its neighbour publishes the same values, so a
// group's boundary cuts are there when its own blocks have arrived),
// fence, arrive at the group's counter. True for the group's last block.
MKV_FN bool mkv_path_arrive(const MkvPathShared& S, const MkvPathBlock& B,
                            const MkvPathWalker& w, int32_t* scratch) {
  if (B.blk > 0) mkv_path_publish(S, B, scratch, B.blk, w.c0);
  if (B.blk < B.groups - 1) mkv_path_publish(S, B, scratch, B.blk + 1, w.c1);
  mkv_fence();
  const int32_t g = B.blk / kMkvGroup, size = B.groups - g * kMkvGroup;
  return mkv_arrive(scratch + kMkvGroupCounters + g) ==
         (size < kMkvGroup ? size : kMkvGroup) - 1;
}

// Phase 7b (thread 0 of a group's last block, more than one group, after
// every thread's fence and a barrier): arrive at the counter of all groups.
MKV_FN bool mkv_path_arrive_all(MkvPathShared& S, const MkvPathBlock& B, int32_t* scratch) {
  S.lmin = kMkvMaxLevels;
  mkv_fence();
  return mkv_arrive(scratch) == B.ngroups - 1;
}

// The cuts c = first + j stride, j < count, that a finishing block walks:
// those inside its group (bounds: exclude nodes that contain one of the
// group's boundary cuts), or the groups' boundary cuts.
struct MkvCutList {
  int32_t first, stride, count;
  bool bounds;
};

MKV_FN MkvCutList mkv_path_group_cuts(const MkvPathBlock& B) {
  const int32_t g = B.blk / kMkvGroup, size = B.groups - g * kMkvGroup;
  MkvCutList cl;
  cl.first = g * kMkvGroup + 1;
  cl.stride = 1;
  cl.count = (size < kMkvGroup ? size : kMkvGroup) - 1;
  cl.bounds = true;
  return cl;
}

MKV_FN MkvCutList mkv_path_boundary_cuts(const MkvPathBlock& B) {
  MkvCutList cl;
  cl.first = kMkvGroup;
  cl.stride = kMkvGroup;
  cl.count = B.ngroups - 1;
  cl.bounds = false;
  return cl;
}

MKV_FN void mkv_path_cut(const MkvPathShared& S, const MkvPathBlock& B, const int32_t* scratch,
                         const MkvCutList& cl, int32_t j, int32_t& lp, int32_t& lca) {
  if (j < kMkvCutCache) {
    lp = S.cut_lp[j];
    lca = S.cut_lca[j];
  } else {
    const int32_t c = cl.first + j * cl.stride;
    lp = mkv_load_l2(scratch + B.cuts + 2 * c - 2);
    lca = mkv_load_l2(scratch + B.cuts + 2 * c - 1);
  }
}

// Phase 6 (a finishing block): a cut list into shared memory, with the
// group's boundary cuts, and its lowest lca (S.lmin, set to kMkvMaxLevels
// before).
MKV_FN void mkv_path_cuts(MkvPathShared& S, const MkvPathBlock& B, const int32_t* scratch,
                          const MkvCutList& cl, int32_t t) {
  for (int32_t j = t; j < cl.count; j += kMkvPathThreads) {
    const int32_t c = cl.first + j * cl.stride;
    const int32_t lca = mkv_load_l2(scratch + B.cuts + 2 * c - 1);
    if (j < kMkvCutCache) {
      S.cut_lp[j] = mkv_load_l2(scratch + B.cuts + 2 * c - 2);
      S.cut_lca[j] = lca;
    }
    mkv_shared_min(&S.lmin, lca);
  }
  if (t < 2) {
    const int32_t c = t == 0 ? cl.first - 1 : cl.first + cl.count;
    const bool there = cl.bounds && c >= 1 && c < B.groups;
    S.bnd_lp[t] = there ? mkv_load_l2(scratch + B.cuts + 2 * c - 2) : 0;
    S.bnd_lca[t] = there ? mkv_load_l2(scratch + B.cuts + 2 * c - 1) : kMkvMaxLevels;
  }
}

// Phase 7 (a finishing block), once per level l from its lowest lca up to
// T - 1: each shared node at level l that the cut list owns, hashed from
// its two children.
MKV_FN void mkv_path_shared_level(const MkvPathShared& S, const MkvPathBlock& B,
                                  const int32_t* scratch, const MkvCutList& cl, int32_t l,
                                  int32_t t) {
  for (int32_t j0 = 0; j0 < cl.count; j0 += kMkvPathThreads) {  // the same trips for all
    const int32_t j = j0 + t < cl.count ? j0 + t : cl.count - 1;
    int32_t lp, lca, plp = 0, plca = kMkvMaxLevels;
    mkv_path_cut(S, B, scratch, cl, j, lp, lca);
    if (j > 0) mkv_path_cut(S, B, scratch, cl, j - 1, plp, plca);
    const int64_t node = lp >> l;
    const bool bounded = (S.bnd_lca[0] <= l && (S.bnd_lp[0] >> l) == node) ||
                         (S.bnd_lca[1] <= l && (S.bnd_lp[1] >> l) == node);
    // The first cut of the list inside the node owns it (the cut before is
    // not inside), unless a boundary cut is inside too.
    const bool owner = j0 + t < cl.count && lca <= l && !(plca <= l && (plp >> l) == node) &&
                       !bounded;
    uint32_t lw[8], rw[8], out[8];
    mkv_load8_l2(S.rows[l - 1] + 16 * node, lw);
    mkv_load8_l2(S.rows[l - 1] + 16 * node + 8, rw);
    mkv_converge();
    if (mkv_warp_hashes(owner)) mkv_node_hash_rolled(lw, rw, out);
    if (owner) {
      MKV_PATH_ON_HASH(l, node);
      mkv_store8(S.rows[l] + 8 * node, out);
    }
  }
}

// Phase 8 (the last block of all): the bitmap, and levels T - 1 to the
// root into shared memory, all final by now except the touched nodes from
// T up, which phase 9 overwrites before it reads them.
MKV_FN void mkv_path_top_load(MkvPathShared& S, const MkvPathBlock& B, const int32_t* scratch,
                              int32_t t) {
  if (t < kMkvTopNodes / 32) {
    S.bitmap[t] = static_cast<uint32_t>(mkv_load_l2(scratch + kMkvBitmap + t));
  }
  const int32_t below = (B.depth - 1) - (B.top - 1);  // heap rows < 2 << below
  for (int32_t h = 1 + t; h < (2 << below); h += kMkvPathThreads) {
    const int32_t l = (B.depth - 1) - (mkv_bit_length(static_cast<uint32_t>(h)) - 1);
    const int32_t n = h - (1 << (B.depth - 1 - l));
    mkv_copy8_async(S.tree[h], S.rows[l] + 8 * static_cast<int64_t>(n));  // all in flight at once
  }
  mkv_copy_commit();
  mkv_copy_wait_all();
}

// Phase 9 (the last block of all), once per level l from T to the root: every
// touched node of level l, one thread each, in shared memory.
MKV_FN void mkv_path_top_level(MkvPathShared& S, const MkvPathBlock& B, int32_t l, int32_t t) {
  const int32_t m = 1 << (B.depth - 1 - l), span = 1 << (l - B.top);
  const int32_t n = t < m ? t : m - 1;  // lanes past the level hash a stand-in
  bool touched = false;  // any bitmap bit in [n span, (n + 1) span)
  for (int32_t b = n * span; b < (n + 1) * span; b += 32) {
    const int32_t len = (n + 1) * span - b < 32 ? (n + 1) * span - b : 32;
    const uint32_t mask = len == 32 ? ~0u : ((1u << len) - 1) << (b & 31);
    touched = touched || (S.bitmap[b >> 5] & mask) != 0;
  }
  touched = touched && t < m;
  uint32_t out[8];
  mkv_converge();
  if (mkv_warp_hashes(touched)) {
    mkv_node_hash_rolled(S.tree[2 * (m + n)], S.tree[2 * (m + n) + 1], out);
  }
  if (!touched) return;
  MKV_PATH_ON_HASH(l, n);
  mkv_store8(S.tree[m + n], out);
  mkv_store8(S.rows[l] + 8 * static_cast<int64_t>(n), out);
}

// Phase 10 (the last block of all): the scratch back to zero for the next
// launch.
MKV_FN void mkv_path_clear(const MkvPathBlock& B, int32_t* scratch, int32_t t) {
  for (int32_t j = t; j < B.cuts + 2 * (B.groups - 1); j += kMkvPathThreads) scratch[j] = 0;
}

// ------------------------------------------------------------ promotion chain

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
