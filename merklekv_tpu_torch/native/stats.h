// A copy of merklekv_tpu/native/stats.h, built by the port into build/native/.
// Server observability counters.
//
// Field set, STATS line order, and counter->command mapping mirror the
// reference's ServerStats (the reference's src/server.rs:52-321) including
// its quirks: FLUSHDB and CLIENT LIST increment `management_commands`, so
// the dedicated `flushdb_commands`/`clientlist_commands` lines always read 0
// (server.rs:255-262). RSS comes from /proc/self/status instead of shelling
// out to `ps` (server.rs:306-315) — same number, no subprocess.
#pragma once

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <string>

#include "protocol.h"

namespace mkv {

// Lock-free command-latency histogram: fixed log2 buckets over
// MICROSECONDS (upper bounds 1, 2, 4, ..., 2^21 us ≈ 2.1 s, then +inf) —
// the same bound ladder as the Python registry's seconds buckets
// (obs/metrics.py), so the exporter merges both into one namespace.
// Observation is one relaxed atomic add per command; the buckets travel in
// STATS as raw (non-cumulative) counts `cmd_latency_us_le_<bound>` plus
// `cmd_latency_us_sum` / `cmd_latency_us_count`, and p50/p90/p99 are
// derivable from the counts on any scrape.
struct LatencyHisto {
  static constexpr int kBuckets = 22;  // le = 2^0 .. 2^21 us; [22] = +inf
  std::atomic<uint64_t> buckets[kBuckets + 1]{};
  std::atomic<uint64_t> sum_us{0};
  std::atomic<uint64_t> count{0};

  void observe_ns(uint64_t ns) {
    uint64_t us = ns / 1000;
    int i = 0;
    while (i < kBuckets && us > (uint64_t(1) << i)) ++i;
    buckets[i].fetch_add(1, std::memory_order_relaxed);
    sum_us.fetch_add(us, std::memory_order_relaxed);
    count.fetch_add(1, std::memory_order_relaxed);
  }
};

struct ServerStats {
  using Clock = std::chrono::steady_clock;
  Clock::time_point start_time = Clock::now();

  std::atomic<uint64_t> total_connections{0};
  std::atomic<uint64_t> active_connections{0};
  std::atomic<uint64_t> total_commands{0};
  std::atomic<uint64_t> get_commands{0};
  std::atomic<uint64_t> scan_commands{0};
  std::atomic<uint64_t> ping_commands{0};
  std::atomic<uint64_t> echo_commands{0};
  std::atomic<uint64_t> flushdb_commands{0};
  std::atomic<uint64_t> memory_commands{0};
  std::atomic<uint64_t> clientlist_commands{0};
  std::atomic<uint64_t> exists_commands{0};
  std::atomic<uint64_t> dbsize_commands{0};
  std::atomic<uint64_t> set_commands{0};
  std::atomic<uint64_t> delete_commands{0};
  std::atomic<uint64_t> numeric_commands{0};
  std::atomic<uint64_t> string_commands{0};
  std::atomic<uint64_t> bulk_commands{0};
  std::atomic<uint64_t> stat_commands{0};
  std::atomic<uint64_t> sync_commands{0};
  std::atomic<uint64_t> hash_commands{0};
  std::atomic<uint64_t> replicate_commands{0};
  std::atomic<uint64_t> management_commands{0};

  // Overload-protection counters (extension lines; emitted by
  // Server::stats_text, not format_stats, so the reference-parity block
  // above stays byte-compatible):
  //   busy_rejected_connections — accepts refused past max_connections
  //                               (answered "ERROR BUSY connections").
  //   pipeline_rejected         — connections closed for exceeding their
  //                               in-flight pipeline budget.
  //   shed_commands             — write verbs answered "ERROR BUSY"
  //                               while the node was shedding.
  //   readonly_commands         — write verbs answered "ERROR READONLY"
  //                               while the node was read_only/draining.
  std::atomic<uint64_t> busy_rejected_connections{0};
  std::atomic<uint64_t> pipeline_rejected{0};
  std::atomic<uint64_t> shed_commands{0};
  std::atomic<uint64_t> readonly_commands{0};
  //   moved_commands            — key-bearing commands refused with
  //                               "ERROR MOVED <pid> <epoch>" because the
  //                               key (or addressed tree) belongs to a
  //                               partition this node does not own — the
  //                               stale-routing signal of partitioned
  //                               cluster mode (never a silent wrong-node
  //                               read/write).
  std::atomic<uint64_t> moved_commands{0};
  //   fenced_commands           — write verbs answered the retryable
  //                               "ERROR BUSY rebalance retry" because the
  //                               key fell inside a rebalance write fence
  //                               (the brief flip window of a live split;
  //                               reads keep serving throughout).
  std::atomic<uint64_t> fenced_commands{0};

  // Zero-copy serving plane (extension lines):
  //   serve_zero_copy     — values (> OutQueue::kInlinePayload) served as
  //                         refcounted block segments: zero copies after
  //                         ingest.
  //   serve_value_copies  — values that size that were COPIED out of the
  //                         engine instead (zero_copy=false compat path) —
  //                         the bench A/B's allocations/op numerator.
  std::atomic<uint64_t> serve_zero_copy{0};
  std::atomic<uint64_t> serve_value_copies{0};

  LatencyHisto latency;

  uint64_t uptime_seconds() const {
    return uint64_t(std::chrono::duration_cast<std::chrono::seconds>(
                        Clock::now() - start_time)
                        .count());
  }

  std::string uptime_human() const {
    uint64_t s = uptime_seconds();
    char buf[64];
    std::snprintf(buf, sizeof(buf), "%llud %lluh %llum %llus",
                  (unsigned long long)(s / 86400),
                  (unsigned long long)((s % 86400) / 3600),
                  (unsigned long long)((s % 3600) / 60),
                  (unsigned long long)(s % 60));
    return buf;
  }

  void count(const Command& cmd) {
    total_commands.fetch_add(1, std::memory_order_relaxed);
    switch (cmd.verb) {
      case Verb::Get: get_commands++; break;
      case Verb::Scan: scan_commands++; break;
      case Verb::Ping: ping_commands++; break;
      case Verb::Echo: echo_commands++; break;
      case Verb::Dbsize: dbsize_commands++; break;
      case Verb::Exists: exists_commands++; break;
      case Verb::Set: set_commands++; break;
      case Verb::Delete: delete_commands++; break;
      case Verb::Increment:
      case Verb::Decrement: numeric_commands++; break;
      case Verb::Append:
      case Verb::Prepend: string_commands++; break;
      case Verb::MultiGet:
      case Verb::MultiSet:
      case Verb::Truncate: bulk_commands++; break;
      case Verb::Stats:
      case Verb::Info: stat_commands++; break;
      case Verb::Version:
      case Verb::Flushdb:
      case Verb::Shutdown:
      case Verb::ClientList: management_commands++; break;
      case Verb::Memory: memory_commands++; break;
      case Verb::Peers: management_commands++; break;
      case Verb::Metrics: management_commands++; break;
      case Verb::Trace: management_commands++; break;
      case Verb::TraceDump: management_commands++; break;
      case Verb::Profile: management_commands++; break;
      case Verb::Flight: management_commands++; break;
      case Verb::PartMap: management_commands++; break;
      case Verb::Rebalance: management_commands++; break;
      case Verb::Sync:
      case Verb::SnapMeta:
      case Verb::SnapChunk: sync_commands++; break;
      case Verb::Hash:
      case Verb::LeafHashes:
      case Verb::HashPage:
      case Verb::TreeLevel: hash_commands++; break;
      case Verb::Replicate: replicate_commands++; break;
    }
  }

  static uint64_t rss_kb() {
    FILE* f = std::fopen("/proc/self/status", "r");
    if (!f) return 0;
    char line[256];
    uint64_t kb = 0;
    while (std::fgets(line, sizeof(line), f)) {
      if (std::sscanf(line, "VmRSS: %llu kB", (unsigned long long*)&kb) == 1) {
        break;
      }
    }
    std::fclose(f);
    return kb;
  }

  std::string format_stats() const {
    auto ld = [](const std::atomic<uint64_t>& a) {
      return a.load(std::memory_order_relaxed);
    };
    std::string out;
    char buf[128];
    auto add = [&](const char* name, uint64_t v) {
      std::snprintf(buf, sizeof(buf), "%s:%llu\r\n", name,
                    (unsigned long long)v);
      out += buf;
    };
    add("uptime_seconds", uptime_seconds());
    out += "uptime:" + uptime_human() + "\r\n";
    add("total_connections", ld(total_connections));
    add("active_connections", ld(active_connections));
    add("total_commands", ld(total_commands));
    add("get_commands", ld(get_commands));
    add("scan_commands", ld(scan_commands));
    add("ping_commands", ld(ping_commands));
    add("echo_commands", ld(echo_commands));
    add("flushdb_commands", ld(flushdb_commands));
    add("memory_commands", ld(memory_commands));
    add("clientlist_commands", ld(clientlist_commands));
    add("exists_commands", ld(exists_commands));
    add("dbsize_commands", ld(dbsize_commands));
    add("set_commands", ld(set_commands));
    add("delete_commands", ld(delete_commands));
    add("numeric_commands", ld(numeric_commands));
    add("string_commands", ld(string_commands));
    add("bulk_commands", ld(bulk_commands));
    add("stat_commands", ld(stat_commands));
    add("sync_commands", ld(sync_commands));
    add("hash_commands", ld(hash_commands));
    add("replicate_commands", ld(replicate_commands));
    add("management_commands", ld(management_commands));
    add("used_memory_kb", rss_kb());
    // Command-latency histogram (extension lines; see LatencyHisto).
    char name[64];
    for (int i = 0; i < LatencyHisto::kBuckets; ++i) {
      std::snprintf(name, sizeof(name), "cmd_latency_us_le_%llu",
                    (unsigned long long)(uint64_t(1) << i));
      add(name, latency.buckets[i].load(std::memory_order_relaxed));
    }
    add("cmd_latency_us_le_inf",
        latency.buckets[LatencyHisto::kBuckets].load(
            std::memory_order_relaxed));
    add("cmd_latency_us_sum",
        latency.sum_us.load(std::memory_order_relaxed));
    add("cmd_latency_us_count",
        latency.count.load(std::memory_order_relaxed));
    return out;
  }
};

}  // namespace mkv
