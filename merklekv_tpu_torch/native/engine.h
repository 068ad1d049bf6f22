// A copy of merklekv_tpu/native/engine.h, built by the port into build/native/.
// Storage engines for the native host runtime.
//
// Equivalent of the reference's KVEngineStoreTrait plugin boundary
// (the reference's src/store/kv_trait.rs:23-162) and its engines
// (rwlock_engine.rs, kv_engine.rs, sled_engine.rs), redesigned for the
// TPU-native architecture:
//   - the keyspace is SHARDED (N shards, each its own shared_mutex + map)
//     instead of one global lock — the reference serializes every op behind
//     a single tokio Mutex (the reference's src/server.rs:386), which its
//     own docs call the biggest bottleneck;
//   - `snapshot()` exports the whole (sorted) keyspace in one call so the
//     TPU data plane can rebuild Merkle state as a batched program.
#pragma once

#include <atomic>
#include <cstdint>
#include <memory>
#include <optional>
#include <shared_mutex>
#include <string>
#include <string_view>
#include <unordered_map>
#include <utility>
#include <vector>

namespace mkv {

// Error text for a write refused by slab-arena exhaustion. The server's
// dispatch matches it to answer the overload-ladder-shaped "ERROR BUSY memory retry"
// (shed the write, never abort) instead of a generic failure.
inline constexpr char kSlabExhaustedError[] = "slab arena exhausted";

// ------------------------------------------------------ value slab blocks
//
// A value is materialized ONCE at ingest into a single contiguous
// allocation (block header + payload — "slab-allocated") and shared by
// atomic refcount from then on: the engine holds one ref per live entry,
// and every in-flight response (OutQueue iovec segment) holds its own, so
// a hot GET serves with ZERO copies after ingest and a DEL/overwrite can
// never free bytes a slow reader's writev still needs.

// Per-engine slab accounting, shared (via shared_ptr) by the engine and
// every block it ever allocated — a block pinned only by an in-flight
// OutQueue keeps the account alive and keeps COUNTING, which is what lets
// memory_usage() include reader-pinned bytes so the overload-ladder memory
// watermarks stay honest.
class SlabAccount {
 public:
  SlabAccount();  // reads MKV_MAX_SLAB_BYTES (test hook; 0 = unlimited)

  // Reserve `len` payload bytes for a new block. False when the arena
  // byte limit refuses the allocation (counted; the caller sheds).
  // `credit` is the payload size of a live value this block will REPLACE:
  // the limit check admits the write as if those bytes were already
  // freed — an overwrite/APPEND near the cap must not be refused with a
  // retryable BUSY that no retry can ever satisfy (the old value only
  // leaves the account when the new one installs). The account itself is
  // not debited here (the old block frees when its last ref drops), so
  // live_bytes may transiently exceed the limit by up to `credit`; the
  // cap is a shedding watermark, not a hard allocator bound.
  bool reserve(size_t len, size_t credit = 0) {
    // len == 0 always admits: an empty value occupies no payload bytes,
    // and refusing it (possible when credit-admitted overwrites have
    // live_bytes transiently over the cap) would shed a write that frees
    // more than it takes.
    if (limit_ > 0 && len > 0) {
      long long need = (long long)len - (long long)credit;
      long long cur = live_bytes_.load(std::memory_order_relaxed);
      do {
        if (cur + need > limit_) {
          alloc_failures_.fetch_add(1, std::memory_order_relaxed);
          return false;
        }
      } while (!live_bytes_.compare_exchange_weak(
          cur, cur + (long long)len, std::memory_order_relaxed));
    } else {
      live_bytes_.fetch_add((long long)len, std::memory_order_relaxed);
    }
    blocks_.fetch_add(1, std::memory_order_relaxed);
    allocs_.fetch_add(1, std::memory_order_relaxed);
    return true;
  }
  void on_free(size_t len) {
    live_bytes_.fetch_sub((long long)len, std::memory_order_relaxed);
    blocks_.fetch_sub(1, std::memory_order_relaxed);
  }
  // Engine-held share (bytes referenced from the live map), adjusted by
  // the engine under its shard locks; live - engine = bytes NOT held by
  // the live map: in-flight responses plus values mid-ingest (reserved
  // but not yet installed) plus replaced values whose reader refs are
  // still draining.
  void engine_hold(long long delta) {
    engine_bytes_.fetch_add(delta, std::memory_order_relaxed);
  }

  uint64_t live_bytes() const {
    long long v = live_bytes_.load(std::memory_order_relaxed);
    return v > 0 ? uint64_t(v) : 0;
  }
  uint64_t blocks() const {
    long long v = blocks_.load(std::memory_order_relaxed);
    return v > 0 ? uint64_t(v) : 0;
  }
  uint64_t pinned_bytes() const {
    long long live = live_bytes_.load(std::memory_order_relaxed);
    long long eng = engine_bytes_.load(std::memory_order_relaxed);
    return live > eng ? uint64_t(live - eng) : 0;
  }
  uint64_t allocs() const {
    return allocs_.load(std::memory_order_relaxed);
  }
  uint64_t alloc_failures() const {
    return alloc_failures_.load(std::memory_order_relaxed);
  }
  long long limit() const { return limit_; }

 private:
  std::atomic<long long> live_bytes_{0};    // all live blocks' payload bytes
  std::atomic<long long> engine_bytes_{0};  // subset held by the live map
  std::atomic<long long> blocks_{0};
  std::atomic<uint64_t> allocs_{0};
  std::atomic<uint64_t> alloc_failures_{0};
  long long limit_ = 0;  // MKV_MAX_SLAB_BYTES; 0 = unlimited
};

// True exactly once after the calling thread's last failed write was
// refused by slab-arena exhaustion (ValueBlock::make sets it, this read
// clears it). Dispatch runs engine writes on the same thread, so the flag
// lets the server answer the overload-ladder-shaped "ERROR BUSY memory retry"
// instead of a generic failure without changing every write signature.
bool consume_slab_exhausted();

// Point-in-time slab accounting snapshot (STATS / exporter bridge).
struct SlabStats {
  uint64_t bytes = 0;         // live payload bytes, reader-pinned included
  uint64_t blocks = 0;        // live blocks
  uint64_t pinned_bytes = 0;  // bytes not held by the live map: in-flight
                              // responses + values mid-ingest/mid-replace
  uint64_t allocs = 0;        // lifetime block allocations
  uint64_t alloc_failures = 0;  // writes refused by the arena byte limit
};

// Immutable refcounted value block: header + payload in ONE allocation.
// Never constructed directly — make() allocates, unref() at zero frees
// and settles the account.
class ValueBlock {
 public:
  // nullptr when the account's byte limit (or malloc) refuses — a typed
  // exhaustion the write path sheds, never an abort. `credit` = payload
  // size of the live value this block replaces (see SlabAccount::reserve).
  static ValueBlock* make(std::shared_ptr<SlabAccount> acct,
                          const char* data, size_t len, size_t credit = 0);

  const char* data() const {
    return reinterpret_cast<const char*>(this) + sizeof(ValueBlock);
  }
  size_t size() const { return len_; }
  std::string_view view() const { return {data(), len_}; }
  void ref() { rc_.fetch_add(1, std::memory_order_relaxed); }
  void unref();

 private:
  ValueBlock(std::shared_ptr<SlabAccount> acct, uint32_t len)
      : rc_(1), len_(len), acct_(std::move(acct)) {}
  ~ValueBlock() = default;

  std::atomic<uint32_t> rc_;
  uint32_t len_;
  std::shared_ptr<SlabAccount> acct_;
};

// RAII handle: copying takes a ref, destruction drops one. This is what
// the engine stores per entry and what rides the OutQueue until writev
// completes.
class BlockRef {
 public:
  BlockRef() = default;
  // Adopts an already-counted ref (ValueBlock::make returns rc == 1).
  static BlockRef adopt(ValueBlock* b) {
    BlockRef r;
    r.b_ = b;
    return r;
  }
  BlockRef(const BlockRef& o) : b_(o.b_) {
    if (b_) b_->ref();
  }
  BlockRef(BlockRef&& o) noexcept : b_(o.b_) { o.b_ = nullptr; }
  BlockRef& operator=(BlockRef o) noexcept {
    std::swap(b_, o.b_);
    return *this;
  }
  ~BlockRef() {
    if (b_) b_->unref();
  }
  explicit operator bool() const { return b_ != nullptr; }
  const char* data() const { return b_ ? b_->data() : ""; }
  size_t size() const { return b_ ? b_->size() : 0; }
  std::string_view view() const {
    return b_ ? b_->view() : std::string_view{};
  }
  std::string str() const { return std::string(view()); }
  void reset() {
    if (b_) {
      b_->unref();
      b_ = nullptr;
    }
  }

 private:
  ValueBlock* b_ = nullptr;
};

template <typename T>
struct Result {
  bool ok = false;
  T value{};
  std::string error;
  static Result Ok(T v) { return Result{true, std::move(v), {}}; }
  static Result Err(std::string e) { return Result{false, {}, std::move(e)}; }
};

// One op of a replication-apply batch: an LWW-conditional install
// (set_if_newer semantics) or deletion (del_if_newer semantics) carrying
// the event's exact timestamp.
struct BatchOp {
  bool is_del = false;
  uint64_t ts = 0;
  std::string key;
  std::string value;  // empty for deletions
};

class Engine {
 public:
  virtual ~Engine() = default;

  virtual std::optional<std::string> get(const std::string& key) = 0;
  // Zero-copy read: a ref on the value's immutable block, acquired under
  // the shard lock, handed straight to the I/O plane as an iovec segment.
  // The base fallback materializes an unaccounted copy so engines without
  // block storage keep the same surface.
  virtual BlockRef get_block(const std::string& key) {
    auto v = get(key);
    if (!v) return {};
    return BlockRef::adopt(ValueBlock::make(nullptr, v->data(), v->size()));
  }
  virtual bool set(const std::string& key, const std::string& value) = 0;
  // Install a value with an explicit last-write timestamp (unix ns).
  // Used by LWW repair paths (anti-entropy, replication apply) so ordering
  // metadata propagates with the value instead of being re-stamped "now".
  virtual bool set_with_ts(const std::string& key, const std::string& value,
                           uint64_t ts) = 0;
  // Last-write timestamp (unix ns) of a present key; nullopt if absent.
  // Plain writes stamp the wall clock; replayed legacy log records carry 0.
  virtual std::optional<uint64_t> get_ts(const std::string& key) = 0;
  // Value AND its last-write ts under ONE shard lock. LEAFHASHES pairs a
  // digest with a ts for peers' LWW arbitration; reading them separately
  // can pair a stale value with a newer timestamp across a racing write.
  virtual std::optional<std::pair<std::string, uint64_t>> get_with_ts(
      const std::string& key) = 0;
  // User-intent deletion: removes the entry AND records a tombstone stamped
  // "now" so the deletion participates in LWW against concurrent writes
  // elsewhere in the cluster. The reference has no tombstones — a dropped
  // DEL event there is undone forever by any peer still holding the value
  // (sync.rs:74-83 resurrects it). True if the key existed.
  virtual bool del(const std::string& key) = 0;
  // Deletion carrying an explicit tombstone timestamp (replication apply,
  // tombstone adoption from a peer).
  virtual bool del_with_ts(const std::string& key, uint64_t ts) = 0;
  // Mirror deletion: removes the entry WITHOUT a tombstone. Pairwise
  // anti-entropy ("make local equal that peer", reference sync.rs:74-83)
  // deletes local-only keys as a *copy* operation — fabricating a
  // deletion-at-now there would later kill disjoint writes cluster-wide
  // through multi-peer LWW.
  virtual bool del_quiet(const std::string& key) = 0;
  // LWW-conditional ops, atomic per shard: apply only if ts is not older
  // than both the live entry's ts and any tombstone's ts. A VALUE WINS
  // TIES over a tombstone (set_if_newer applies at ts == tomb ts;
  // del_if_newer requires ts strictly newer than the entry) — matching the
  // sync arbitration's deterministic (ts, liveness, digest) order. Return
  // whether the op applied.
  virtual bool set_if_newer(const std::string& key, const std::string& value,
                            uint64_t ts) = 0;
  virtual bool del_if_newer(const std::string& key, uint64_t ts) = 0;
  // Apply a whole replication frame in one call: per-op set_if_newer /
  // del_if_newer semantics, returning one applied flag per op (same index).
  // The point is the FFI batching — k remote ops used to cost k Python->C
  // crossings; a frame is now ONE. The base implementation loops the
  // conditional verbs (correct for any engine, including LogEngine's
  // journaled variants); MemEngine overrides with per-shard lock grouping
  // so a frame also pays one lock acquisition per touched shard instead of
  // one per op. Ops on the same key must keep their relative order.
  virtual std::vector<uint8_t> apply_batch(const std::vector<BatchOp>& ops) {
    std::vector<uint8_t> out(ops.size(), 0);
    for (size_t i = 0; i < ops.size(); ++i) {
      out[i] = ops[i].is_del ? (del_if_newer(ops[i].key, ops[i].ts) ? 1 : 0)
                             : (set_if_newer(ops[i].key, ops[i].value,
                                             ops[i].ts)
                                    ? 1
                                    : 0);
    }
    return out;
  }
  // Tombstone timestamp for a deleted key, if one is recorded.
  virtual std::optional<uint64_t> tombstone_ts(const std::string& key) = 0;
  // Sorted (key, delete-ts) tombstones with the given prefix ("" = all).
  virtual std::vector<std::pair<std::string, uint64_t>> tombstones(
      const std::string& prefix) = 0;
  // (key, last-write-ts) for every LIVE key, in shard order (unsorted) —
  // the bulk export the multi-peer LWW arbitration consumes (a per-key
  // get_ts would pay one FFI call + shard lock per key across the whole
  // divergent set; the consumer builds a hash map, so sorting would be
  // wasted work).
  virtual std::vector<std::pair<std::string, uint64_t>> key_timestamps() = 0;
  virtual bool exists(const std::string& key) = 0;
  // Sorted keys with the given prefix ("" = all).
  virtual std::vector<std::string> scan(const std::string& prefix) = 0;
  // Up to `limit` (key, is_tombstone) rows for keys STRICTLY after the
  // cursor, live keys and tombstones merged in one sorted stream — the
  // HASHPAGE unit of resumable anti-entropy. Fewer rows than `limit`
  // means the keyspace past the cursor is exhausted, so implementations
  // must not drop rows mid-page. Base implementation pages over
  // scan()+tombstones(); MemEngine overrides with a bounded top-k
  // selection so a paged walk does not sort the whole keyspace per page.
  std::vector<std::pair<std::string, bool>> page_after(
      const std::string& after, size_t limit) {
    return page_between(after, nullptr, limit);
  }
  // Range-bounded form: rows strictly after `after` and (when `upto` is
  // non-null) strictly below `*upto` — the bisection walk's leaf fetch for
  // ONE divergent key range. Fewer rows than `limit` means the RANGE is
  // exhausted.
  virtual std::vector<std::pair<std::string, bool>> page_between(
      const std::string& after, const std::string* upto, size_t limit);
  // Monotonic mutation counter: any state change (value or tombstone)
  // bumps it, so the server's cached TREELEVEL tree knows when it is
  // stale. The base fallback is ALWAYS-CHANGING (never reuse a cache) so
  // an engine that doesn't track versions degrades to per-request rebuild
  // instead of serving stale digests.
  virtual uint64_t version() { return ++fallback_version_; }
  virtual size_t dbsize() = 0;
  virtual size_t memory_usage() = 0;  // bytes (keys + values)
  // Missing key counts as 0 (reference rwlock_engine.rs:252-320); non-numeric
  // stored value is an error.
  virtual Result<int64_t> increment(const std::string& key, int64_t amount) = 0;
  virtual Result<int64_t> decrement(const std::string& key, int64_t amount) = 0;
  // Create-if-missing (reference rwlock_engine.rs:337-390); returns new value.
  virtual Result<std::string> append(const std::string& key,
                                     const std::string& value) = 0;
  virtual Result<std::string> prepend(const std::string& key,
                                      const std::string& value) = 0;
  virtual bool truncate() = 0;  // drop all keys
  virtual bool sync() = 0;      // flush to durable storage (no-op in-mem)
  // Whole keyspace, sorted by key — the TPU rebuild input.
  virtual std::vector<std::pair<std::string, std::string>> snapshot() = 0;
  // Deletion records dropped by the bounded tombstone map (see
  // kMaxTombsPerShard). Beyond the cap an old deletion can be resurrected
  // by a stale replica; this counter makes that silent degradation visible
  // (surfaced via STATS as tombstone_evictions).
  virtual uint64_t tomb_evictions() { return 0; }
  // Slab accounting snapshot; zeros for engines without block storage.
  virtual SlabStats slab_stats() { return {}; }

 private:
  std::atomic<uint64_t> fallback_version_{0};
};

// In-memory engine: 16-way sharded hash map, per-shard reader/writer locks.
class MemEngine : public Engine {
 public:
  static constexpr size_t kShards = 16;

  MemEngine();

  std::optional<std::string> get(const std::string& key) override;
  // The zero-copy read: one shared-lock acquire, one atomic ref bump —
  // the block itself is the response bytes from here to writev.
  BlockRef get_block(const std::string& key) override;
  bool set(const std::string& key, const std::string& value) override;
  bool set_with_ts(const std::string& key, const std::string& value,
                   uint64_t ts) override;
  std::optional<uint64_t> get_ts(const std::string& key) override;
  std::optional<std::pair<std::string, uint64_t>> get_with_ts(
      const std::string& key) override;
  bool del(const std::string& key) override;
  bool del_with_ts(const std::string& key, uint64_t ts) override;
  // del_with_ts that also reports whether any state advanced (entry removed
  // OR tombstone inserted/moved forward). LogEngine uses it to skip log
  // appends for no-op deletes (repeated DELs of an absent key would
  // otherwise grow the log without bound between compactions).
  bool del_with_ts_report(const std::string& key, uint64_t ts,
                          bool* advanced);
  bool del_quiet(const std::string& key) override;
  bool set_if_newer(const std::string& key, const std::string& value,
                    uint64_t ts) override;
  bool del_if_newer(const std::string& key, uint64_t ts) override;
  std::vector<uint8_t> apply_batch(const std::vector<BatchOp>& ops) override;
  std::optional<uint64_t> tombstone_ts(const std::string& key) override;
  std::vector<std::pair<std::string, uint64_t>> tombstones(
      const std::string& prefix) override;
  std::vector<std::pair<std::string, uint64_t>> key_timestamps() override;
  bool exists(const std::string& key) override;
  std::vector<std::string> scan(const std::string& prefix) override;
  std::vector<std::pair<std::string, bool>> page_between(
      const std::string& after, const std::string* upto,
      size_t limit) override;
  size_t dbsize() override;
  size_t memory_usage() override;
  Result<int64_t> increment(const std::string& key, int64_t amount) override;
  Result<int64_t> decrement(const std::string& key, int64_t amount) override;
  Result<std::string> append(const std::string& key,
                             const std::string& value) override;
  Result<std::string> prepend(const std::string& key,
                              const std::string& value) override;
  bool truncate() override;
  bool sync() override { return true; }
  std::vector<std::pair<std::string, std::string>> snapshot() override;
  uint64_t tomb_evictions() override {
    return tomb_evictions_.load(std::memory_order_relaxed);
  }
  SlabStats slab_stats() override;
  uint64_t version() override {
    return version_.load(std::memory_order_acquire);
  }

 private:
  struct Entry {
    BlockRef value;   // engine's ref on the immutable slab block
    uint64_t ts = 0;  // last-write unix ns
  };
  struct Shard {
    mutable std::shared_mutex mu;
    std::unordered_map<std::string, Entry> map;
    // key -> deletion ts. Bounded (max_tombs_): the oldest tombstones are
    // evicted on overflow and every eviction is counted (tomb_evictions_).
    std::unordered_map<std::string, uint64_t> tombs;
    // Evicted-tombstone high-water mark: the newest deletion ts this shard
    // has ever EVICTED. Closes the resurrection hole the bounded map
    // opens: set_if_newer rejects any write older than this mark for a key
    // with no tombstone on record, because an evicted tombstone at up to
    // this ts may have covered it — a stale replica can no longer
    // resurrect a deletion just because its record was evicted. The cost
    // is conservatism: legitimately-old disjoint writes below the mark
    // also lose LWW repair on this shard (they remain repairable through
    // pairwise mirror sync, which is unconditional).
    uint64_t tomb_evict_hwm = 0;
  };
  // Records the deletion; returns whether the tombstone advanced (new, or
  // moved to a later ts). Caller holds the shard's unique lock.
  bool note_tomb(Shard& s, const std::string& key, uint64_t ts);
  // LWW-conditional cores with the caller holding the shard's unique lock
  // — shared by the single-op verbs and the per-shard-grouped apply_batch.
  bool set_if_newer_locked(Shard& s, const std::string& key,
                           const std::string& value, uint64_t ts);
  bool del_if_newer_locked(Shard& s, const std::string& key, uint64_t ts);
  Shard& shard_for(const std::string& key);
  size_t shard_index(const std::string& key) const {
    return std::hash<std::string>{}(key) % kShards;
  }
  void bump_version() {
    version_.fetch_add(1, std::memory_order_acq_rel);
  }
  // Incremental resident-bytes accounting (live keys + values), adjusted
  // at every map insert/replace/erase under the shard lock. Keeps
  // memory_usage() O(1) so the overload monitor can poll the memory
  // watermark every few hundred ms without walking 10M entries.
  void acct(long long delta) {
    approx_bytes_.fetch_add(delta, std::memory_order_relaxed);
  }
  Result<int64_t> add(const std::string& key, int64_t delta);
  Result<std::string> splice(const std::string& key, const std::string& value,
                             bool append);
  // Materialize a value into an accounted slab block; empty on arena
  // exhaustion (the thread-local exhaustion flag is set for the caller).
  // `credit` = size of the live value being replaced, so an overwrite
  // near the arena cap is admitted (see SlabAccount::reserve).
  BlockRef make_block(const char* data, size_t len, size_t credit = 0);
  BlockRef make_block(const std::string& v, size_t credit = 0) {
    return make_block(v.data(), v.size(), credit);
  }
  // Payload size of `key`'s live value (0 when absent) — the overwrite
  // credit for a write path that allocates BEFORE taking the unique lock.
  size_t live_size(const std::string& key);
  // Install `block` as the live entry for `key` in shard `s` (caller holds
  // the unique lock): settles the engine-held byte share for both the old
  // and new value and erases any tombstone.
  void install_locked(Shard& s, const std::string& key, BlockRef block,
                      uint64_t ts);
  // Remove the live entry if present (caller holds the unique lock),
  // settling accounting; returns whether it existed.
  bool erase_locked(Shard& s, const std::string& key);

  Shard shards_[kShards];
  // Default 1<<16; MKV_MAX_TOMBS_PER_SHARD overrides (tests shrink it to
  // exercise eviction without a million deletes).
  size_t max_tombs_;
  std::atomic<uint64_t> tomb_evictions_{0};
  std::atomic<uint64_t> version_{1};
  // Key bytes only: value bytes live in the slab account (which keeps
  // counting blocks pinned by in-flight responses after the engine drops
  // its ref — memory_usage() = keys + slab live bytes, so the overload-ladder
  // memory watermarks see reader-pinned memory too).
  std::atomic<long long> approx_bytes_{0};
  std::shared_ptr<SlabAccount> slab_;
};

// Durable engine: MemEngine semantics + append-only operation log
// (equivalent capability to the reference's sled engine,
// the reference's src/store/sled_engine.rs). Replays the log on open;
// `sync()` fsyncs; `truncate()`/compaction rewrite a fresh snapshot log.
class LogEngine : public Engine {
 public:
  // Creates `dir` if needed; replays `dir`/data.log when present.
  explicit LogEngine(const std::string& dir);
  ~LogEngine() override;

  std::optional<std::string> get(const std::string& key) override;
  BlockRef get_block(const std::string& key) override {
    return mem_.get_block(key);
  }
  bool set(const std::string& key, const std::string& value) override;
  bool set_with_ts(const std::string& key, const std::string& value,
                   uint64_t ts) override;
  std::optional<uint64_t> get_ts(const std::string& key) override;
  std::optional<std::pair<std::string, uint64_t>> get_with_ts(
      const std::string& key) override;
  bool del(const std::string& key) override;
  bool del_with_ts(const std::string& key, uint64_t ts) override;
  bool del_quiet(const std::string& key) override;
  bool set_if_newer(const std::string& key, const std::string& value,
                    uint64_t ts) override;
  bool del_if_newer(const std::string& key, uint64_t ts) override;
  std::optional<uint64_t> tombstone_ts(const std::string& key) override;
  std::vector<std::pair<std::string, uint64_t>> tombstones(
      const std::string& prefix) override;
  std::vector<std::pair<std::string, uint64_t>> key_timestamps() override {
    return mem_.key_timestamps();
  }
  bool exists(const std::string& key) override;
  std::vector<std::string> scan(const std::string& prefix) override;
  std::vector<std::pair<std::string, bool>> page_between(
      const std::string& after, const std::string* upto,
      size_t limit) override {
    return mem_.page_between(after, upto, limit);
  }
  uint64_t version() override { return mem_.version(); }
  size_t dbsize() override;
  size_t memory_usage() override;
  Result<int64_t> increment(const std::string& key, int64_t amount) override;
  Result<int64_t> decrement(const std::string& key, int64_t amount) override;
  Result<std::string> append(const std::string& key,
                             const std::string& value) override;
  Result<std::string> prepend(const std::string& key,
                              const std::string& value) override;
  bool truncate() override;
  bool sync() override;
  std::vector<std::pair<std::string, std::string>> snapshot() override;
  uint64_t tomb_evictions() override { return mem_.tomb_evictions(); }
  SlabStats slab_stats() override { return mem_.slab_stats(); }

  // Rewrite the log as a snapshot of current state — live entries AND
  // tombstones (dropping deletion records would let older writes resurrect
  // deleted keys after a compaction + restart).
  bool compact();
  // True when the on-disk log declared a format version newer than this
  // binary supports: replay was refused (nothing truncated, nothing lost)
  // and the engine runs empty with logging disabled.
  bool log_version_refused() const { return version_refused_; }

 private:
  bool append_record(uint8_t op, const std::string& key,
                     const std::string& value, uint64_t ts);
  static bool write_header(int fd);
  bool rewrite_snapshot();

  MemEngine mem_;
  std::string path_;
  std::shared_mutex log_mu_;
  int fd_ = -1;
  bool version_refused_ = false;
};

// Factory: kind is "mem" (default, aka "rwlock"/"kv") or "log" (aka "sled").
std::unique_ptr<Engine> make_engine(const std::string& kind,
                                    const std::string& path);

}  // namespace mkv
