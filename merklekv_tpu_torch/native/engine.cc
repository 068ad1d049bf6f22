// A copy of merklekv_tpu/native/engine.cc, built by the port into build/native/.
#include "engine.h"

#include <fcntl.h>
#include <string.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <new>

#include "merkle.h"

namespace mkv {

namespace {

uint64_t now_ns() {
  timespec ts;
  ::clock_gettime(CLOCK_REALTIME, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + uint64_t(ts.tv_nsec);
}

// Full-string i64 parse with Rust `str::parse::<i64>` semantics: optional
// +/-, decimal digits only, no whitespace, overflow is an error.
bool parse_i64(const std::string& s, int64_t* out) {
  if (s.empty()) return false;
  size_t i = 0;
  bool neg = false;
  if (s[0] == '+' || s[0] == '-') {
    neg = s[0] == '-';
    i = 1;
    if (s.size() == 1) return false;
  }
  uint64_t acc = 0;
  const uint64_t limit =
      neg ? (uint64_t(1) << 63) : (uint64_t(1) << 63) - 1;
  for (; i < s.size(); ++i) {
    if (s[i] < '0' || s[i] > '9') return false;
    uint64_t d = uint64_t(s[i] - '0');
    if (acc > (limit - d) / 10) return false;
    acc = acc * 10 + d;
  }
  *out = neg ? -int64_t(acc) : int64_t(acc);
  return true;
}

std::string not_a_number(const std::string& key) {
  return "Value for key '" + key + "' is not a valid number";
}

// Set by ValueBlock::make when the arena byte limit refuses a block; read
// (and cleared) by consume_slab_exhausted(). Thread-local is exact here:
// the server dispatches the engine write and inspects the failure on the
// same thread, so no cross-thread signal is needed.
thread_local bool t_slab_exhausted = false;

}  // namespace

bool consume_slab_exhausted() {
  bool v = t_slab_exhausted;
  t_slab_exhausted = false;
  return v;
}

// ----------------------------------------------------- value slab blocks

SlabAccount::SlabAccount() {
  // Test hook: cap the arena so exhaustion (and the BUSY-memory shed it
  // feeds) is exercisable without filling real RAM. 0/absent = unlimited.
  if (const char* env = ::getenv("MKV_MAX_SLAB_BYTES")) {
    int64_t v;
    if (parse_i64(env, &v) && v > 0) limit_ = v;
  }
}

ValueBlock* ValueBlock::make(std::shared_ptr<SlabAccount> acct,
                             const char* data, size_t len, size_t credit) {
  if (len > UINT32_MAX) return nullptr;
  if (acct && !acct->reserve(len, credit)) {
    t_slab_exhausted = true;
    return nullptr;
  }
  void* mem = std::malloc(sizeof(ValueBlock) + len);
  if (!mem) {
    if (acct) acct->on_free(len);
    return nullptr;
  }
  auto* b = new (mem) ValueBlock(std::move(acct), uint32_t(len));
  if (len) std::memcpy(const_cast<char*>(b->data()), data, len);
  return b;
}

void ValueBlock::unref() {
  if (rc_.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    // Settle the account AFTER the free so live_bytes never under-counts
    // memory that is still allocated.
    std::shared_ptr<SlabAccount> acct = std::move(acct_);
    const size_t len = len_;
    this->~ValueBlock();
    std::free(this);
    if (acct) acct->on_free(len);
  }
}

// ------------------------------------------------------------- MemEngine

MemEngine::MemEngine()
    : max_tombs_(1 << 16), slab_(std::make_shared<SlabAccount>()) {
  // Test hook: shrink the per-shard tombstone cap so eviction (and the
  // resurrection defense around it) is exercisable without ~1M deletes.
  if (const char* env = ::getenv("MKV_MAX_TOMBS_PER_SHARD")) {
    int64_t v;
    if (parse_i64(env, &v) && v > 0) max_tombs_ = size_t(v);
  }
}

BlockRef MemEngine::make_block(const char* data, size_t len, size_t credit) {
  // Clear any stale latch first so it reflects THIS allocation only: a
  // path that returns without consuming it (set_if_newer shed) must not
  // make a later plain-malloc failure read as retryable arena exhaustion.
  t_slab_exhausted = false;
  return BlockRef::adopt(ValueBlock::make(slab_, data, len, credit));
}

size_t MemEngine::live_size(const std::string& key) {
  Shard& s = shard_for(key);
  std::shared_lock lk(s.mu);
  auto it = s.map.find(key);
  return it == s.map.end() ? 0 : it->second.value.size();
}

void MemEngine::install_locked(Shard& s, const std::string& key,
                               BlockRef block, uint64_t ts) {
  const long long nsz = (long long)block.size();
  auto it = s.map.find(key);
  if (it != s.map.end()) {
    slab_->engine_hold(nsz - (long long)it->second.value.size());
    it->second.value = std::move(block);  // drops the old engine ref
    it->second.ts = ts;
  } else {
    acct((long long)key.size());
    slab_->engine_hold(nsz);
    s.map.emplace(key, Entry{std::move(block), ts});
  }
  // A present value supersedes any deletion record: without this a key
  // would be advertised live AND tombstoned to peers at once.
  s.tombs.erase(key);
}

bool MemEngine::erase_locked(Shard& s, const std::string& key) {
  auto it = s.map.find(key);
  if (it == s.map.end()) return false;
  acct(-(long long)key.size());
  slab_->engine_hold(-(long long)it->second.value.size());
  s.map.erase(it);  // drops the engine ref; in-flight responses keep theirs
  return true;
}

MemEngine::Shard& MemEngine::shard_for(const std::string& key) {
  return shards_[std::hash<std::string>{}(key) % kShards];
}

std::optional<std::string> MemEngine::get(const std::string& key) {
  Shard& s = shard_for(key);
  std::shared_lock lk(s.mu);
  auto it = s.map.find(key);
  if (it == s.map.end()) return std::nullopt;
  return it->second.value.str();
}

BlockRef MemEngine::get_block(const std::string& key) {
  Shard& s = shard_for(key);
  std::shared_lock lk(s.mu);
  auto it = s.map.find(key);
  if (it == s.map.end()) return {};
  // Copying the handle takes a ref UNDER the shard lock, which is what
  // makes the block's lifetime safe once the lock drops: a concurrent
  // DEL/overwrite only drops the engine's ref, never this one.
  return it->second.value;
}

bool MemEngine::set(const std::string& key, const std::string& value) {
  return set_with_ts(key, value, now_ns());
}

bool MemEngine::set_with_ts(const std::string& key, const std::string& value,
                            uint64_t ts) {
  // The ingest copy — the ONE copy a value ever pays — happens here,
  // outside the shard lock (the old string path copied while holding it).
  // The overwrite credit (old value's size, read under a shared lock) is
  // advisory — a racing overwrite of the same key can at worst admit one
  // extra value past the cap — but without it an overwrite near the
  // arena limit is refused with a retryable BUSY no retry can satisfy.
  // A null block NEVER installs (empty values get a real header-only
  // block; reserve always admits len 0): an entry with a null ref would
  // exist for get()/EXISTS yet serve NOT_FOUND through get_block().
  // An unlimited arena (the production default) ignores the credit, so
  // skip the extra shard lookup on the hot write path.
  BlockRef block =
      make_block(value, slab_->limit() > 0 ? live_size(key) : 0);
  if (!block) return false;  // arena exhausted (or malloc refused)
  Shard& s = shard_for(key);
  std::unique_lock lk(s.mu);
  install_locked(s, key, std::move(block), ts);
  bump_version();
  return true;
}

std::optional<uint64_t> MemEngine::get_ts(const std::string& key) {
  Shard& s = shard_for(key);
  std::shared_lock lk(s.mu);
  auto it = s.map.find(key);
  if (it == s.map.end()) return std::nullopt;
  return it->second.ts;
}

std::optional<std::pair<std::string, uint64_t>> MemEngine::get_with_ts(
    const std::string& key) {
  Shard& s = shard_for(key);
  std::shared_lock lk(s.mu);
  auto it = s.map.find(key);
  if (it == s.map.end()) return std::nullopt;
  return std::make_pair(it->second.value.str(), it->second.ts);
}

bool MemEngine::note_tomb(Shard& s, const std::string& key, uint64_t ts) {
  // Caller holds the shard's unique lock.
  auto [it, inserted] = s.tombs.try_emplace(key, ts);
  bool advanced = inserted;
  if (!inserted && it->second < ts) {
    it->second = ts;
    advanced = true;
  }
  if (s.tombs.size() > max_tombs_) {
    // Amortized eviction: one scan drops the oldest ~1/8 of the map, so a
    // delete-heavy workload at the cap pays the scan once per ~8k deletes
    // instead of on every delete (the scan holds the shard's write lock).
    std::vector<uint64_t> tss;
    tss.reserve(s.tombs.size());
    for (const auto& [k, t] : s.tombs) {
      (void)k;
      tss.push_back(t);
    }
    // Cut at ~1/8 of the map (at least 1 — size/8 truncates to zero under
    // the MKV_MAX_TOMBS_PER_SHARD test hook's small caps) and evict EVERY
    // record at or below the cutoff timestamp: eviction is then strictly
    // oldest-first, so the high-water mark below covers exactly what was
    // dropped and no old tombstone can linger past newer evictees on map
    // iteration order.
    const size_t target = std::max<size_t>(1, tss.size() / 8);
    auto cut = tss.begin() + ptrdiff_t(target);
    std::nth_element(tss.begin(), cut, tss.end());
    const uint64_t cutoff = *cut;
    size_t evicted = 0;
    for (auto i = s.tombs.begin(); i != s.tombs.end();) {
      if (i->second <= cutoff) {
        // The high-water mark remembers the newest ts this shard ever
        // evicted: set_if_newer uses it as a conservative floor so an
        // evicted deletion still blocks stale resurrection.
        if (i->second > s.tomb_evict_hwm) s.tomb_evict_hwm = i->second;
        i = s.tombs.erase(i);
        ++evicted;
      } else {
        ++i;
      }
    }
    // Every evicted record is a deletion the cluster can no longer defend
    // against stale resurrection by an unconditional write — count them
    // (surfaced via STATS; LWW installs stay defended via the HWM).
    tomb_evictions_.fetch_add(evicted, std::memory_order_relaxed);
  }
  return advanced;
}

bool MemEngine::del(const std::string& key) {
  return del_with_ts(key, now_ns());
}

bool MemEngine::del_with_ts(const std::string& key, uint64_t ts) {
  bool advanced;
  return del_with_ts_report(key, ts, &advanced);
}

bool MemEngine::del_with_ts_report(const std::string& key, uint64_t ts,
                                   bool* advanced) {
  Shard& s = shard_for(key);
  std::unique_lock lk(s.mu);
  bool existed = erase_locked(s, key);
  bool tomb_advanced = note_tomb(s, key, ts);
  *advanced = existed || tomb_advanced;
  if (*advanced) bump_version();
  return existed;
}

bool MemEngine::del_quiet(const std::string& key) {
  Shard& s = shard_for(key);
  std::unique_lock lk(s.mu);
  bool existed = erase_locked(s, key);
  if (existed) bump_version();
  return existed;
}

bool MemEngine::set_if_newer(const std::string& key, const std::string& value,
                             uint64_t ts) {
  Shard& s = shard_for(key);
  std::unique_lock lk(s.mu);
  return set_if_newer_locked(s, key, value, ts);
}

bool MemEngine::set_if_newer_locked(Shard& s, const std::string& key,
                                    const std::string& value, uint64_t ts) {
  auto it = s.map.find(key);
  if (it != s.map.end()) {
    if (ts < it->second.ts) return false;
    if (ts == it->second.ts && it->second.value.view() != value) {
      // Exact-ts cross-writer conflict: break deterministically by leaf
      // digest (larger wins), the same (ts, liveness, digest) order the
      // multi-peer sync arbitration uses. Replicas applying equal-ts
      // events in any order therefore converge on the max-digest value
      // through replication alone — no sync loop required.
      uint8_t cur[32], neu[32];
      leaf_hash(key, it->second.value.str(), cur);
      leaf_hash(key, value, neu);
      if (::memcmp(neu, cur, 32) < 0) return false;
    }
  }
  auto tt = s.tombs.find(key);
  if (tt != s.tombs.end() && ts < tt->second) return false;  // tie: value wins
  if (it == s.map.end() && tt == s.tombs.end() &&
      ts < s.tomb_evict_hwm) {
    // ABSENT key, no tombstone on record, but this shard has EVICTED
    // tombstones as new as tomb_evict_hwm — one of them may have covered
    // this key. Rejecting installs older than the mark keeps an evicted
    // deletion deletion-stable (no resurrection by a stale replica); the
    // write stays repairable through unconditional mirror sync if it was
    // genuinely disjoint. A LIVE key is exempt: its last set erased any
    // tombstone, so rejecting a newer-than-entry update would buy no
    // deletion-stability — it would only pin the stale value.
    return false;
  }
  // LWW checks passed: materialize the block (under the lock — this is
  // the replication/repair path, not the GET hot path) and install. The
  // replaced value's size credits the arena check (exact here: the lock
  // is held from lookup through install).
  BlockRef block = make_block(
      value, it == s.map.end() ? 0 : it->second.value.size());
  if (!block) return false;  // arena exhausted (or malloc): shed, never
                             // install a null ref (see set_with_ts)
  install_locked(s, key, std::move(block), ts);
  bump_version();
  return true;
}

bool MemEngine::del_if_newer(const std::string& key, uint64_t ts) {
  Shard& s = shard_for(key);
  std::unique_lock lk(s.mu);
  return del_if_newer_locked(s, key, ts);
}

bool MemEngine::del_if_newer_locked(Shard& s, const std::string& key,
                                    uint64_t ts) {
  auto it = s.map.find(key);
  if (it != s.map.end()) {
    if (ts <= it->second.ts) return false;  // tie: value wins
    erase_locked(s, key);
    note_tomb(s, key, ts);
    bump_version();
    return true;
  }
  // Absent key: record the tombstone — it blocks older writes from
  // resurrecting later. "Applied" only if it actually advanced (a newer
  // tombstone already on record means local state already covers this
  // deletion, and callers must not log/notify a no-op).
  bool advanced = note_tomb(s, key, ts);
  if (advanced) bump_version();
  return advanced;
}

std::vector<uint8_t> MemEngine::apply_batch(const std::vector<BatchOp>& ops) {
  std::vector<uint8_t> out(ops.size(), 0);
  // Group op indices per shard, preserving the frame's relative order
  // within each shard (per-key ordering only needs intra-shard order —
  // one key always hashes to one shard). One unique_lock per touched
  // shard then serves the whole group.
  std::array<std::vector<size_t>, kShards> by_shard;
  for (size_t i = 0; i < ops.size(); ++i) {
    by_shard[shard_index(ops[i].key)].push_back(i);
  }
  for (size_t si = 0; si < kShards; ++si) {
    if (by_shard[si].empty()) continue;
    Shard& s = shards_[si];
    std::unique_lock lk(s.mu);
    for (size_t i : by_shard[si]) {
      const BatchOp& op = ops[i];
      out[i] = op.is_del ? (del_if_newer_locked(s, op.key, op.ts) ? 1 : 0)
                         : (set_if_newer_locked(s, op.key, op.value, op.ts)
                                ? 1
                                : 0);
    }
  }
  return out;
}

std::optional<uint64_t> MemEngine::tombstone_ts(const std::string& key) {
  Shard& s = shard_for(key);
  std::shared_lock lk(s.mu);
  auto it = s.tombs.find(key);
  if (it == s.tombs.end()) return std::nullopt;
  return it->second;
}

std::vector<std::pair<std::string, uint64_t>> MemEngine::tombstones(
    const std::string& prefix) {
  std::vector<std::pair<std::string, uint64_t>> out;
  for (Shard& s : shards_) {
    std::shared_lock lk(s.mu);
    for (const auto& [k, ts] : s.tombs) {
      if (k.compare(0, prefix.size(), prefix) == 0) out.emplace_back(k, ts);
    }
  }
  std::sort(out.begin(), out.end());
  return out;
}

std::vector<std::pair<std::string, uint64_t>> MemEngine::key_timestamps() {
  std::vector<std::pair<std::string, uint64_t>> out;
  for (Shard& s : shards_) {
    std::shared_lock lk(s.mu);
    for (const auto& [k, e] : s.map) out.emplace_back(k, e.ts);
  }
  // Deliberately unsorted: the consumer builds a hash map, and an
  // O(N log N) string sort at 10M keys would cost more than the FFI
  // batching this export exists to save.
  return out;
}

bool MemEngine::exists(const std::string& key) {
  Shard& s = shard_for(key);
  std::shared_lock lk(s.mu);
  return s.map.count(key) > 0;
}

std::vector<std::string> MemEngine::scan(const std::string& prefix) {
  std::vector<std::string> out;
  for (Shard& s : shards_) {
    std::shared_lock lk(s.mu);
    for (const auto& [k, v] : s.map) {
      (void)v;
      if (k.compare(0, prefix.size(), prefix) == 0) out.push_back(k);
    }
  }
  std::sort(out.begin(), out.end());
  return out;
}

std::vector<std::pair<std::string, bool>> Engine::page_between(
    const std::string& after, const std::string* upto, size_t limit) {
  // Generic fallback: merge the two sorted exports. Correct for any
  // engine, but O(N log N) per page — engines with direct access to their
  // storage should override (MemEngine below).
  auto keys = scan("");
  auto tombs = tombstones("");
  std::vector<std::pair<std::string, bool>> out;
  size_t i = 0, j = 0;
  while (i < keys.size() && keys[i] <= after) ++i;
  while (j < tombs.size() && tombs[j].first <= after) ++j;
  while (out.size() < limit && (i < keys.size() || j < tombs.size())) {
    bool take_live =
        i < keys.size() && (j >= tombs.size() || keys[i] <= tombs[j].first);
    // Exclusive upper bound: the next row in merge order is out of range,
    // so the whole remaining stream is too — the range is exhausted.
    const std::string& next_key = take_live ? keys[i] : tombs[j].first;
    if (upto && next_key >= *upto) break;
    if (take_live) {
      // scan() and tombstones() are two separate reads, so a racing
      // delete can land a key in both; keep the live row (the caller
      // re-reads atomically) WITHOUT shortening the page — a short page
      // signals keyspace exhaustion to the walker.
      if (j < tombs.size() && tombs[j].first == keys[i]) ++j;
      out.emplace_back(std::move(keys[i]), false);
      ++i;
    } else {
      out.emplace_back(std::move(tombs[j].first), true);
      ++j;
    }
  }
  return out;
}

std::vector<std::pair<std::string, bool>> MemEngine::page_between(
    const std::string& after, const std::string* upto, size_t limit) {
  // Bounded top-k selection: the `limit` smallest keys strictly after the
  // cursor via a max-heap, O(N log limit) per page with no full-keyspace
  // vector or sort — a paged anti-entropy walk over N keys costs
  // O(N^2/page * log page) comparisons instead of O(N^2/page * log N)
  // plus a whole-keyspace copy per page. Within a shard the live map and
  // tombstone map are disjoint (a set erases its tombstone under the same
  // lock), and both are read under one shared_lock here, so no key can
  // appear twice and the page never comes up short while keys remain.
  // An exclusive `upto` bound drops out-of-range keys at offer time, so a
  // range-bounded page (the bisection walk's leaf fetch) never selects —
  // let alone ships — anything past the divergent range.
  using Row = std::pair<std::string, bool>;  // (key, is_tombstone)
  auto by_key = [](const Row& a, const Row& b) { return a.first < b.first; };
  std::vector<Row> heap;
  heap.reserve(limit + 1);
  auto offer = [&](const std::string& k, bool tomb) {
    if (k <= after) return;
    if (upto && k >= *upto) return;
    if (heap.size() == limit && heap.front().first <= k) return;
    heap.emplace_back(k, tomb);
    std::push_heap(heap.begin(), heap.end(), by_key);
    if (heap.size() > limit) {
      std::pop_heap(heap.begin(), heap.end(), by_key);
      heap.pop_back();
    }
  };
  for (Shard& s : shards_) {
    std::shared_lock lk(s.mu);
    for (const auto& [k, e] : s.map) {
      (void)e;
      offer(k, false);
    }
    for (const auto& [k, ts] : s.tombs) {
      (void)ts;
      offer(k, true);
    }
  }
  std::sort_heap(heap.begin(), heap.end(), by_key);
  return heap;
}

size_t MemEngine::dbsize() {
  size_t n = 0;
  for (Shard& s : shards_) {
    std::shared_lock lk(s.mu);
    n += s.map.size();
  }
  return n;
}

size_t MemEngine::memory_usage() {
  // O(1): incremental key bytes + the slab account's live value bytes.
  // The slab number INCLUDES blocks whose only remaining refs are
  // in-flight responses (a slow reader's parked writev), so the overload-ladder
  // memory watermarks see reader-pinned memory and shed before the
  // allocator, not after. Approximate by design (map overhead and
  // tombstones are not counted) — it is the watermark signal for the
  // overload monitor, not an allocator report.
  long long n = approx_bytes_.load(std::memory_order_relaxed);
  return (n > 0 ? size_t(n) : 0) + size_t(slab_->live_bytes());
}

SlabStats MemEngine::slab_stats() {
  SlabStats st;
  st.bytes = slab_->live_bytes();
  st.blocks = slab_->blocks();
  st.pinned_bytes = slab_->pinned_bytes();
  st.allocs = slab_->allocs();
  st.alloc_failures = slab_->alloc_failures();
  return st;
}

Result<int64_t> MemEngine::add(const std::string& key, int64_t delta) {
  Shard& s = shard_for(key);
  std::unique_lock lk(s.mu);
  int64_t cur = 0;
  auto it = s.map.find(key);
  if (it != s.map.end() && !parse_i64(it->second.value.str(), &cur)) {
    return Result<int64_t>::Err(not_a_number(key));
  }
  // Wrapping add (reference release-mode semantics).
  int64_t next = int64_t(uint64_t(cur) + uint64_t(delta));
  std::string text = std::to_string(next);
  BlockRef block = make_block(
      text, it == s.map.end() ? 0 : it->second.value.size());
  if (!block) {
    // Only a refusal by the arena limit earns the retryable typed error;
    // a plain malloc failure must not tell the client to retry forever.
    return Result<int64_t>::Err(consume_slab_exhausted()
                                    ? kSlabExhaustedError
                                    : "allocation failed");
  }
  install_locked(s, key, std::move(block), now_ns());
  bump_version();
  return Result<int64_t>::Ok(next);
}

Result<int64_t> MemEngine::increment(const std::string& key, int64_t amount) {
  return add(key, amount);
}

Result<int64_t> MemEngine::decrement(const std::string& key, int64_t amount) {
  return add(key, int64_t(0 - uint64_t(amount)));
}

Result<std::string> MemEngine::splice(const std::string& key,
                                      const std::string& value, bool append) {
  Shard& s = shard_for(key);
  std::unique_lock lk(s.mu);
  auto it = s.map.find(key);
  // Build `next` straight from the old block's view — no str() temporary:
  // a few-byte APPEND to a 1 MiB value must not materialize (and then
  // re-copy) the old value while holding the shard's unique lock.
  std::string next;
  if (it == s.map.end()) {
    next = value;
  } else {
    std::string_view old = it->second.value.view();
    next.reserve(old.size() + value.size());
    if (append) {
      next.append(old.data(), old.size());
      next.append(value);
    } else {
      next.append(value);
      next.append(old.data(), old.size());
    }
  }
  BlockRef block = make_block(
      next, it == s.map.end() ? 0 : it->second.value.size());
  if (!block) {
    // See add(): retryable only when the arena limit (not malloc) refused.
    // A null block never installs (see set_with_ts).
    return Result<std::string>::Err(consume_slab_exhausted()
                                        ? kSlabExhaustedError
                                        : "allocation failed");
  }
  install_locked(s, key, std::move(block), now_ns());
  bump_version();
  return Result<std::string>::Ok(next);
}

Result<std::string> MemEngine::append(const std::string& key,
                                      const std::string& value) {
  return splice(key, value, true);
}

Result<std::string> MemEngine::prepend(const std::string& key,
                                       const std::string& value) {
  return splice(key, value, false);
}

bool MemEngine::truncate() {
  for (Shard& s : shards_) {
    std::unique_lock lk(s.mu);
    for (const auto& [k, e] : s.map) {
      acct(-(long long)k.size());
      slab_->engine_hold(-(long long)e.value.size());
    }
    s.map.clear();
    // TRUNCATE is a local admin wipe, not a per-key deletion: it stays
    // local (never replicated) and drops deletion history with the data.
    s.tombs.clear();
    s.tomb_evict_hwm = 0;  // the wipe erases deletion knowledge by intent
  }
  bump_version();
  return true;
}

std::vector<std::pair<std::string, std::string>> MemEngine::snapshot() {
  std::vector<std::pair<std::string, std::string>> out;
  for (Shard& s : shards_) {
    std::shared_lock lk(s.mu);
    for (const auto& [k, e] : s.map) out.emplace_back(k, e.value.str());
  }
  std::sort(out.begin(), out.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  return out;
}

// ------------------------------------------------------------- LogEngine
//
// File header (logs created at version >= 2): magic "MKVL" + u32 LE format
// version. A binary that reads a version NEWER than it supports REFUSES to
// open (no replay, no truncation) instead of misparsing unknown records as
// corruption and cutting the file — the downgrade-safety hole a headerless
// format has. Headerless legacy files replay from offset 0 and are then
// UPGRADED in place (snapshot rewrite with a header): they may already
// contain kOpDelTs records that a pre-DelTs binary would misparse as
// corruption and truncate, so leaving them headerless would preserve
// nothing — the header is what makes every future format change refusable
// instead of destructive.
//
// Log record: u8 op | u32 klen | u32 vlen | [u64 ts] | key bytes | value
// bytes, little-endian integers. Ops: 1=SET (legacy, no ts field),
// 2=DEL, 3=TRUNCATE, 4=SET_TS (carries the entry's last-write unix-ns
// timestamp so LWW ordering survives restart), 5=DEL_TS (v2+). New records
// are written as SET_TS; legacy SET records replay with ts=0 ("unknown
// age" — loses every LWW tie, which is the conservative choice). A torn
// tail record (short read) is discarded on replay and truncated from the
// file.

namespace {
constexpr uint8_t kOpSet = 1;
constexpr uint8_t kOpDel = 2;
constexpr uint8_t kOpTruncate = 3;
constexpr uint8_t kOpSetTs = 4;
// DEL carrying its tombstone timestamp, so deletion LWW ordering survives
// restart the same way kOpSetTs preserves write ordering.
constexpr uint8_t kOpDelTs = 5;

constexpr char kLogMagic[4] = {'M', 'K', 'V', 'L'};
constexpr uint32_t kLogVersion = 2;
// No record op byte collides with 'M' (0x4D), so magic detection on legacy
// files can never misfire. Files shorter than the header are legacy too
// (either empty-after-torn-tail or a partial record).
constexpr size_t kLogHeaderSize = 8;

bool read_exact(int fd, void* buf, size_t len) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (len) {
    ssize_t r = ::read(fd, p, len);
    if (r <= 0) return false;
    p += r;
    len -= size_t(r);
  }
  return true;
}

bool write_all(int fd, const void* buf, size_t len) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (len) {
    ssize_t r = ::write(fd, p, len);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += r;
    len -= size_t(r);
  }
  return true;
}
}  // namespace

LogEngine::LogEngine(const std::string& dir) {
  ::mkdir(dir.c_str(), 0755);
  path_ = dir + "/data.log";
  bool needs_header = true;
  bool legacy = false;
  int rfd = ::open(path_.c_str(), O_RDONLY);
  if (rfd >= 0) {
    // Byte offset just past the last fully-replayed record. Anything after
    // it (a torn or corrupt tail) must be cut before reopening O_APPEND —
    // otherwise post-recovery writes land after the corrupt bytes and every
    // future replay silently drops them.
    const off_t end = ::lseek(rfd, 0, SEEK_END);
    ::lseek(rfd, 0, SEEK_SET);
    off_t good = 0;
    if (end >= off_t(kLogHeaderSize)) {
      char head[kLogHeaderSize];
      if (read_exact(rfd, head, kLogHeaderSize) &&
          ::memcmp(head, kLogMagic, 4) == 0) {
        uint32_t ver;
        ::memcpy(&ver, head + 4, 4);
        if (ver > kLogVersion) {
          // A future format: refuse rather than truncate. The file is left
          // byte-identical; the engine runs empty with logging disabled so
          // nothing this binary does can damage the newer log.
          ::close(rfd);
          version_refused_ = true;
          fd_ = -1;
          return;
        }
        good = off_t(kLogHeaderSize);
        needs_header = false;  // header already on disk
      } else {
        ::lseek(rfd, 0, SEEK_SET);  // legacy headerless file
        legacy = true;
      }
    } else if (end > 0) {
      legacy = true;  // short legacy tail; replay handles it
    }
    for (;;) {
      uint8_t op;
      uint32_t klen, vlen;
      if (!read_exact(rfd, &op, 1) || !read_exact(rfd, &klen, 4) ||
          !read_exact(rfd, &vlen, 4)) {
        break;
      }
      const off_t ts_size = (op == kOpSetTs || op == kOpDelTs) ? 8 : 0;
      const off_t rec_size = off_t(9) + ts_size + klen + vlen;
      // Torn-tail test by exact arithmetic, not a size cap: a record whose
      // claimed payload runs past the end of the file cannot be complete
      // (and allocating from a garbage length would be an OOM hazard).
      // Legitimately large records replay fine.
      if (rec_size > end - good) break;
      uint64_t ts = 0;
      if (ts_size && !read_exact(rfd, &ts, 8)) break;
      std::string key(klen, '\0'), value(vlen, '\0');
      if (klen && !read_exact(rfd, key.data(), klen)) break;
      if (vlen && !read_exact(rfd, value.data(), vlen)) break;
      if (op == kOpSet || op == kOpSetTs) {
        mem_.set_with_ts(key, value, ts);
      } else if (op == kOpDelTs) {
        mem_.del_with_ts(key, ts);
      } else if (op == kOpDel) {
        // Quiet/legacy deletes carry no deletion intent to preserve.
        mem_.del_quiet(key);
      } else if (op == kOpTruncate) {
        mem_.truncate();
      } else {
        // Unknown op: this format has no forward-compat records, so these
        // bytes are corruption and get cut too.
        break;
      }
      good += rec_size;
    }
    ::close(rfd);
    if (end > good) ::truncate(path_.c_str(), good);
  }
  if (legacy) {
    // Upgrade in place: rewrite the replayed state as a headered v2
    // snapshot (atomic tmp+rename, like compact()). On any failure fall
    // through to plain append — the data is already replayed, and the
    // next successful compaction upgrades it instead.
    if (rewrite_snapshot()) return;  // rewrite_snapshot set fd_
  }
  fd_ = ::open(path_.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd_ >= 0 && needs_header && !legacy) write_header(fd_);
}

bool LogEngine::write_header(int fd) {
  char head[kLogHeaderSize];
  ::memcpy(head, kLogMagic, 4);
  ::memcpy(head + 4, &kLogVersion, 4);
  return write_all(fd, head, kLogHeaderSize);
}

LogEngine::~LogEngine() {
  if (fd_ >= 0) {
    ::fsync(fd_);
    ::close(fd_);
  }
}

bool LogEngine::append_record(uint8_t op, const std::string& key,
                              const std::string& value, uint64_t ts) {
  if (fd_ < 0) return false;
  std::string rec;
  const bool with_ts = op == kOpSetTs || op == kOpDelTs;
  rec.reserve(9 + (with_ts ? 8 : 0) + key.size() + value.size());
  rec.push_back(char(op));
  uint32_t klen = uint32_t(key.size()), vlen = uint32_t(value.size());
  rec.append(reinterpret_cast<const char*>(&klen), 4);
  rec.append(reinterpret_cast<const char*>(&vlen), 4);
  if (with_ts) rec.append(reinterpret_cast<const char*>(&ts), 8);
  rec.append(key);
  rec.append(value);
  return write_all(fd_, rec.data(), rec.size());
}

std::optional<std::string> LogEngine::get(const std::string& key) {
  return mem_.get(key);
}

bool LogEngine::set(const std::string& key, const std::string& value) {
  return set_with_ts(key, value, now_ns());
}

bool LogEngine::set_with_ts(const std::string& key, const std::string& value,
                            uint64_t ts) {
  // Mutations serialize on log_mu_ so replay order matches final state.
  std::unique_lock lk(log_mu_);
  if (version_refused_) return false;  // nothing may touch a refused log
  if (!mem_.set_with_ts(key, value, ts)) return false;
  return append_record(kOpSetTs, key, value, ts);
}

std::optional<uint64_t> LogEngine::get_ts(const std::string& key) {
  return mem_.get_ts(key);
}

std::optional<std::pair<std::string, uint64_t>> LogEngine::get_with_ts(
    const std::string& key) {
  return mem_.get_with_ts(key);
}

bool LogEngine::del(const std::string& key) {
  return del_with_ts(key, now_ns());
}

bool LogEngine::del_with_ts(const std::string& key, uint64_t ts) {
  std::unique_lock lk(log_mu_);
  if (version_refused_) return false;
  bool advanced;
  bool existed = mem_.del_with_ts_report(key, ts, &advanced);
  // Logged even when the key is absent — the tombstone itself is state (it
  // must keep blocking older writes after a restart) — but ONLY when the
  // entry or tombstone actually advanced: DEL-miss-heavy traffic must not
  // grow the log without bound between compactions.
  if (advanced) append_record(kOpDelTs, key, "", ts);
  return existed;
}

bool LogEngine::del_quiet(const std::string& key) {
  std::unique_lock lk(log_mu_);
  if (version_refused_) return false;
  bool existed = mem_.del_quiet(key);
  if (existed) append_record(kOpDel, key, "", 0);
  return existed;
}

bool LogEngine::set_if_newer(const std::string& key, const std::string& value,
                             uint64_t ts) {
  std::unique_lock lk(log_mu_);
  if (version_refused_) return false;
  if (!mem_.set_if_newer(key, value, ts)) return false;
  append_record(kOpSetTs, key, value, ts);
  return true;
}

bool LogEngine::del_if_newer(const std::string& key, uint64_t ts) {
  std::unique_lock lk(log_mu_);
  if (version_refused_) return false;
  if (!mem_.del_if_newer(key, ts)) return false;
  append_record(kOpDelTs, key, "", ts);
  return true;
}

std::optional<uint64_t> LogEngine::tombstone_ts(const std::string& key) {
  return mem_.tombstone_ts(key);
}

std::vector<std::pair<std::string, uint64_t>> LogEngine::tombstones(
    const std::string& prefix) {
  return mem_.tombstones(prefix);
}

bool LogEngine::exists(const std::string& key) { return mem_.exists(key); }

std::vector<std::string> LogEngine::scan(const std::string& prefix) {
  return mem_.scan(prefix);
}

size_t LogEngine::dbsize() { return mem_.dbsize(); }
size_t LogEngine::memory_usage() { return mem_.memory_usage(); }

Result<int64_t> LogEngine::increment(const std::string& key, int64_t amount) {
  std::unique_lock lk(log_mu_);
  if (version_refused_)
    return Result<int64_t>::Err("log format version refused");
  auto r = mem_.increment(key, amount);
  if (r.ok) {
    append_record(kOpSetTs, key, std::to_string(r.value),
                  mem_.get_ts(key).value_or(0));
  }
  return r;
}

Result<int64_t> LogEngine::decrement(const std::string& key, int64_t amount) {
  std::unique_lock lk(log_mu_);
  if (version_refused_)
    return Result<int64_t>::Err("log format version refused");
  auto r = mem_.decrement(key, amount);
  if (r.ok) {
    append_record(kOpSetTs, key, std::to_string(r.value),
                  mem_.get_ts(key).value_or(0));
  }
  return r;
}

Result<std::string> LogEngine::append(const std::string& key,
                                      const std::string& value) {
  std::unique_lock lk(log_mu_);
  if (version_refused_)
    return Result<std::string>::Err("log format version refused");
  auto r = mem_.append(key, value);
  if (r.ok) append_record(kOpSetTs, key, r.value, mem_.get_ts(key).value_or(0));
  return r;
}

Result<std::string> LogEngine::prepend(const std::string& key,
                                       const std::string& value) {
  std::unique_lock lk(log_mu_);
  if (version_refused_)
    return Result<std::string>::Err("log format version refused");
  auto r = mem_.prepend(key, value);
  if (r.ok) append_record(kOpSetTs, key, r.value, mem_.get_ts(key).value_or(0));
  return r;
}

bool LogEngine::truncate() {
  std::unique_lock lk(log_mu_);
  // A refused (future-version) log must never be O_TRUNC'd: the constructor
  // promised the file stays byte-identical for the newer binary.
  if (version_refused_) return false;
  mem_.truncate();
  // Truncating makes all history dead weight: restart the log.
  if (fd_ >= 0) ::close(fd_);
  fd_ = ::open(path_.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd_ >= 0) write_header(fd_);
  return fd_ >= 0;
}

bool LogEngine::sync() {
  std::shared_lock lk(log_mu_);
  return fd_ >= 0 && ::fsync(fd_) == 0;
}

std::vector<std::pair<std::string, std::string>> LogEngine::snapshot() {
  return mem_.snapshot();
}

bool LogEngine::compact() {
  std::unique_lock lk(log_mu_);
  // Compacting a refused log would rename an empty snapshot over the
  // future-version file — exactly the data loss the refusal prevents.
  if (version_refused_) return false;
  return rewrite_snapshot();
}

// Rewrites the log as a headered v2 snapshot of current state (live
// entries + tombstones), atomically via tmp+rename, and reopens fd_ for
// append. Caller holds log_mu_ (or is the constructor, pre-concurrency).
bool LogEngine::rewrite_snapshot() {
  auto snap = mem_.snapshot();
  std::string tmp = path_ + ".compact";
  int nfd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (nfd < 0) return false;
  if (!write_header(nfd)) {
    ::close(nfd);
    ::unlink(tmp.c_str());
    return false;
  }
  auto emit = [&](uint8_t op, const std::string& k, const std::string& v,
                  uint64_t ts) {
    std::string rec;
    rec.push_back(char(op));
    uint32_t klen = uint32_t(k.size()), vlen = uint32_t(v.size());
    rec.append(reinterpret_cast<const char*>(&klen), 4);
    rec.append(reinterpret_cast<const char*>(&vlen), 4);
    rec.append(reinterpret_cast<const char*>(&ts), 8);
    rec.append(k);
    rec.append(v);
    return write_all(nfd, rec.data(), rec.size());
  };
  bool ok = true;
  for (const auto& [k, v] : snap) {
    if (!emit(kOpSetTs, k, v, mem_.get_ts(k).value_or(0))) {
      ok = false;
      break;
    }
  }
  // Tombstones are state too: dropping them here would let older writes
  // resurrect deleted keys after a compaction + restart.
  if (ok) {
    for (const auto& [k, ts] : mem_.tombstones("")) {
      if (!emit(kOpDelTs, k, "", ts)) {
        ok = false;
        break;
      }
    }
  }
  if (!ok) {
    ::close(nfd);
    ::unlink(tmp.c_str());
    return false;
  }
  ::fsync(nfd);
  ::close(nfd);
  if (::rename(tmp.c_str(), path_.c_str()) != 0) return false;
  if (fd_ >= 0) ::close(fd_);
  fd_ = ::open(path_.c_str(), O_WRONLY | O_APPEND, 0644);
  return fd_ >= 0;
}

// ------------------------------------------------------------- factory

std::unique_ptr<Engine> make_engine(const std::string& kind,
                                    const std::string& path) {
  if (kind == "log" || kind == "sled") {
    return std::make_unique<LogEngine>(path.empty() ? "merklekv_data" : path);
  }
  // "mem", "rwlock", "kv", "" — all map to the sharded in-memory engine.
  return std::make_unique<MemEngine>();
}

}  // namespace mkv
