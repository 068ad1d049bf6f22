// A copy of merklekv_tpu/native/events.cc, built by the port into build/native/.
#include "events.h"

#include <algorithm>
#include <chrono>
#include <ctime>

namespace mkv {

namespace {
uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + uint64_t(ts.tv_nsec);
}
}  // namespace

void EventQueue::push(ChangeOp op, const std::string& key,
                      const std::string& value, bool has_value) {
  bool was_empty;
  {
    std::lock_guard lk(mu_);
    was_empty = q_.empty();
    if (q_.size() >= capacity_) {
      q_.pop_front();
      dropped_.fetch_add(1, std::memory_order_relaxed);
    }
    q_.push_back(
        ChangeRecord{op, has_value, now_ns(), next_seq_++, key, value});
  }
  // Only the empty->non-empty edge needs a wakeup (the drainer keeps
  // draining while events remain), so the write hot path pays the notify
  // at most once per drain cycle.
  if (was_empty) cv_.notify_one();
}

bool EventQueue::wait_nonempty(int timeout_ms) {
  std::unique_lock lk(mu_);
  if (!q_.empty() || timeout_ms <= 0) return !q_.empty();
  cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
               [&] { return !q_.empty(); });
  return !q_.empty();
}

std::vector<ChangeRecord> EventQueue::drain(size_t max_events) {
  std::lock_guard lk(mu_);
  size_t n = max_events == 0 ? q_.size() : std::min(max_events, q_.size());
  std::vector<ChangeRecord> out;
  out.reserve(n);
  for (size_t i = 0; i < n; ++i) {
    out.push_back(std::move(q_.front()));
    q_.pop_front();
  }
  return out;
}

size_t EventQueue::size() const {
  std::lock_guard lk(mu_);
  return q_.size();
}

}  // namespace mkv
