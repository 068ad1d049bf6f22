// A copy of merklekv_tpu/native/events.h, built by the port into build/native/.
// Change-event staging between the native write path and the control plane.
//
// Every successful write the server executes is recorded here; the Python
// control plane drains the queue in batches to (a) publish replication
// events (reference analog: the `publishes` vector drained after dispatch,
// the reference's src/server.rs:499-506,925-938) and (b) feed incremental
// Merkle updates to the TPU data plane. Values carry the POST-OP result so
// application downstream is idempotent (reference change_event.rs:17-19).
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <string>
#include <vector>

namespace mkv {

enum class ChangeOp : uint8_t {
  Set = 1,
  Del = 2,
  Incr = 3,
  Decr = 4,
  Append = 5,
  Prepend = 6,
  // Staged so device-side Merkle mirrors see TRUNCATE/FLUSHDB, but never
  // published: the reference replicates only the six ops above
  // (replication.rs:197-254).
  Truncate = 7,
};

struct ChangeRecord {
  ChangeOp op;
  bool has_value;
  uint64_t ts_ns;   // wall-clock nanoseconds at publish
  uint64_t seq;     // monotone per-queue sequence
  std::string key;
  std::string value;  // post-op value (empty for Del)
};

class EventQueue {
 public:
  explicit EventQueue(size_t capacity = 1 << 20) : capacity_(capacity) {}

  void push(ChangeOp op, const std::string& key, const std::string& value,
            bool has_value);
  // Pops up to max_events (0 = all).
  std::vector<ChangeRecord> drain(size_t max_events);
  // Blocks until the queue is non-empty or timeout_ms elapses; returns
  // whether events are pending. The drain thread parks here instead of
  // polling on a fixed interval — the first staged write wakes it, which
  // removes both the idle-latency floor (poll-interval/2 on average) and
  // the idle wakeup CPU. timeout_ms <= 0 is a non-blocking peek.
  bool wait_nonempty(int timeout_ms);
  size_t size() const;
  uint64_t dropped() const { return dropped_.load(std::memory_order_relaxed); }

 private:
  const size_t capacity_;
  mutable std::mutex mu_;
  std::condition_variable cv_;
  std::deque<ChangeRecord> q_;
  uint64_t next_seq_ = 0;
  std::atomic<uint64_t> dropped_{0};
};

}  // namespace mkv
