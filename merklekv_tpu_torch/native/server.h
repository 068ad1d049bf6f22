// A copy of merklekv_tpu/native/server.h, built by the port into build/native/.
// Native TCP server: CRLF text protocol over an epoll event-loop worker
// pool (memcached-class I/O plane).
//
// Equivalent of the reference's tokio server (the reference's src/server.rs:
// 376-958): accept loop, stats, client table, and post-write event
// publication. Differences by design:
//   - I/O runs on a FIXED pool of epoll workers ([server] io_threads,
//     default = hardware concurrency) instead of one thread per
//     connection: accepted fds are distributed round-robin and each
//     connection is owned by exactly ONE worker for its whole life, so
//     per-connection state (input carry, output queue, interest flags)
//     is touched by a single thread and needs no lock;
//   - requests PIPELINE: every readable event drains the socket, parses
//     ALL complete frames in the buffer (partial frames carry across
//     reads), dispatches them in order, and flushes the responses with
//     one writev per burst (see OutQueue) — per-command syscalls are
//     gone from the hot path;
//   - a slow reader cannot stall its worker: writes that hit EAGAIN park
//     the rest of the queue behind EPOLLOUT interest, and a connection
//     whose output backlog passes the high watermark stops being READ
//     until the backlog drains (backpressure instead of unbounded RAM);
//   - engine calls go straight to the SHARDED engine — workers dispatch
//     in parallel against the per-shard locks; there is no global store
//     mutex like server.rs:386;
//   - successful writes stage ChangeRecords in an EventQueue the control
//     plane drains (instead of awaiting an in-process MQTT client);
//   - SYNC / REPLICATE are delegated to a registered cluster callback (the
//     Python/TPU control plane); without one they report unavailability;
//   - SHUTDOWN optionally exits the process (standalone binary parity with
//     server.rs:909-923) or just stops the server (embedded mode).
#pragma once

#include <netinet/in.h>

#include <array>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <vector>

#include "engine.h"
#include "events.h"
#include "stats.h"

namespace mkv {

struct ClientMeta {
  uint64_t id;
  std::string addr;
  uint64_t connected_unix;
  std::atomic<uint64_t> last_cmd_unix;
  int fd;
};

// Returns the full response (without trailing CRLF appended — the callback
// provides the complete payload) for a cluster command line, or empty to
// signal "not handled".
using ClusterCallback = std::function<std::string(const std::string& line)>;

struct ServerOptions {
  std::string host = "127.0.0.1";
  uint16_t port = 7379;  // 0 = ephemeral
  std::string version = "0.1.0";
  bool exit_on_shutdown = false;
  size_t max_line = 1024 * 1024;
  // Epoll worker-pool width. 0 = hardware concurrency; 1 keeps a single
  // event loop (still pipelined unless `pipelined` is off).
  size_t io_threads = 0;
  // Compat A/B switch for the bench: false restores the pre-pool response
  // discipline — one write syscall per command response, no coalescing —
  // so `io_threads=1, pipelined=false` approximates the old
  // thread-per-connection blocking loop from the server side.
  bool pipelined = true;
  // SO_REUSEPORT accept sharding: 0 = auto (use it where the kernel
  // supports it), 1 = on (fall back with a note if unsupported), -1 = off
  // (single accept loop only). When active, every io worker owns its OWN
  // listening socket on the served port and the kernel deals connections
  // across them — the single accept thread stops being the
  // connection-storm bottleneck. Admission control (max_connections,
  // draining refusal, BUSY-in-accept) is enforced identically on both
  // paths against the shared connection count.
  int reuseport = 0;
};

// Per-connection response staging, flushed with one writev (sendmsg) per
// burst. Protocol literals coalesce into the open tail segment; computed
// bodies larger than kInlinePayload ride as their OWN (moved) string
// segments; served values ride as REFCOUNTED ENGINE BLOCKS — zero copies
// after ingest: the block the engine materialized at SET time is the
// iovec the kernel reads, and the queue's ref is the response's pin on
// it. The ref drops only when the segment is fully written (or the
// connection dies), so a DEL/overwrite can never free bytes a parked
// writev still needs — a slow reader pins memory, never corrupts it.
struct OutQueue {
  // Below this, memcpy into the coalesced literal beats the extra iovec
  // entry + allocator churn of a dedicated segment.
  static constexpr size_t kInlinePayload = 512;

  // One iovec-to-be: an owned byte string OR a zero-copy engine block.
  struct Seg {
    std::string str;
    BlockRef block;  // when set, the segment's bytes are the block's
    const char* data() const { return block ? block.data() : str.data(); }
    size_t size() const { return block ? block.size() : str.size(); }
  };

  std::vector<Seg> segs;
  size_t head = 0;      // first segment with unwritten bytes
  size_t head_off = 0;  // bytes of segs[head] already written
  size_t bytes = 0;     // unwritten bytes across all segments
  bool tail_open = false;  // segs.back() is a literal accepting appends

  void lit(std::string_view s) {
    if (s.empty()) return;
    if (!tail_open) {
      segs.emplace_back();
      tail_open = true;
    }
    segs.back().str.append(s.data(), s.size());
    bytes += s.size();
  }
  // Computed response body: moved, not re-copied, when it is big enough
  // for the extra segment to pay for itself.
  void payload(std::string&& v) {
    if (v.size() <= kInlinePayload) {
      lit(v);
      return;
    }
    bytes += v.size();
    segs.push_back(Seg{std::move(v), {}});
    tail_open = false;
  }
  // Served value: the block rides as its own segment holding its own ref
  // (zero-copy). Small values still memcpy into the coalesced literal —
  // cheaper than an iovec entry, and the copy is tiny by definition.
  // Returns true when the block path was taken (the serve_zero_copy
  // counter's signal).
  bool block(BlockRef&& b) {
    if (b.size() <= kInlinePayload) {
      lit(b.view());
      return false;
    }
    bytes += b.size();
    segs.push_back(Seg{{}, std::move(b)});
    tail_open = false;
    return true;
  }
  bool empty() const { return bytes == 0; }
  void reset() {
    segs.clear();  // drops every block ref the flush completed
    head = 0;
    head_off = 0;
    bytes = 0;
    tail_open = false;
  }
};

// Per-worker loop counters (STATS io_worker_<i>_* lines; bridged to
// /metrics as labeled mkv_native_io_worker_* families). Loop depth =
// commands/wakeups; mean flush size = writev_bytes/writev_calls.
struct IoWorkerStats {
  std::atomic<uint64_t> connections{0};   // currently owned
  std::atomic<uint64_t> commands{0};      // dispatched, lifetime
  std::atomic<uint64_t> wakeups{0};       // epoll_wait returns with events
  std::atomic<uint64_t> writev_calls{0};  // flush syscalls
  std::atomic<uint64_t> writev_bytes{0};  // bytes those syscalls moved
  // Connections this worker accepted on its OWN reuseport listener
  // (0 everywhere when accept sharding is off — the distribution signal).
  std::atomic<uint64_t> accepts{0};
};

// Slow-command log (the native half of the flight recorder): dispatch
// records verb/latency/connection for every command whose duration
// crosses the configured threshold ([observability] slow_command_us).
// Bounded ring under a mutex — only SLOW commands pay the lock, so the
// hot path's cost is one relaxed atomic load + the steady_clock reads it
// already does for the latency histogram. Drained by the FLIGHT verb
// (bare-node fallback; with a control plane attached the same records
// also reach the Python flight ring via SLOWCMD notifications) and
// hammered concurrently in tsan_stress.cc.
struct FlightSlowEntry {
  uint64_t seq;
  uint64_t wall_ns;  // wall clock at command START (completion - duration)
  uint64_t dur_us;
  std::string verb;
  std::string addr;
};

class FlightLog {
 public:
  static constexpr size_t kCap = 256;

  void record(const char* verb, const std::string& addr, uint64_t wall_ns,
              uint64_t dur_us) {
    std::lock_guard lk(mu_);
    ++total_;
    entries_.push_back({total_, wall_ns, dur_us, verb, addr});
    if (entries_.size() > kCap) entries_.pop_front();
  }

  uint64_t total() const {
    std::lock_guard lk(mu_);
    return total_;
  }

  // FLIGHT fallback response: "EVENTS <rows>" + one k=v row per entry,
  // newest first, closed by END — the same table shape the Python flight
  // ring serves, so one client parser covers both.
  std::string wire_dump(size_t n) const {
    std::lock_guard lk(mu_);
    size_t count = entries_.size() < n ? entries_.size() : n;
    std::string out = "EVENTS " + std::to_string(count) + "\r\n";
    for (size_t i = 0; i < count; ++i) {
      const FlightSlowEntry& e = entries_[entries_.size() - 1 - i];
      out += "seq=" + std::to_string(e.seq) +
             " wall_ns=" + std::to_string(e.wall_ns) +
             " kind=slow_command verb=" + e.verb +
             " dur_us=" + std::to_string(e.dur_us) + " conn=" + e.addr +
             "\r\n";
    }
    out += "END\r\n";
    return out;
  }

 private:
  mutable std::mutex mu_;
  std::deque<FlightSlowEntry> entries_;
  uint64_t total_ = 0;
};

// Node-wide degradation ladder (overload protection): each rung sheds a
// little more load so the node stays alive under resource pressure
// instead of crashing. The control plane (cluster/overload.py) folds the
// watermark signals and pushes the level here; the server enforces it on
// the request path.
//   live      — everything serves.
//   shedding  — write verbs answer "ERROR BUSY <why> retry" (retryable;
//               reads and the management plane stay open).
//   read_only — write verbs answer "ERROR READONLY <why>" (not
//               retryable until the node recovers).
//   draining  — read_only + new connections are refused BUSY (node is
//               shutting down; established connections finish).
enum class Degradation : int {
  kLive = 0,
  kShedding = 1,
  kReadOnly = 2,
  kDraining = 3,
};

// Why the node degraded (rides in the BUSY/READONLY error text so a
// client-side retry policy can tell transient shed from shutdown).
enum class DegradeReason : int {
  kNone = 0,
  kMemory = 1,
  kDisk = 2,
  kDraining = 3,
  kAdmin = 4,
};

// Split-tree partition ownership (live rebalancing; cluster/partmap.py is
// the authoritative spec). One assignment per partition id; the table is
// published wholesale on every epoch change.
struct PartAssignment {
  uint32_t root = 0;
  uint32_t depth = 0;
  uint64_t path = 0;
};

struct PartTable {
  uint32_t base = 0;  // boot partition count: h % base picks the root
  std::vector<PartAssignment> assigns;  // index = partition id
};

// One armed rebalance write fence: the moving range, as a split-tree cell.
struct PartFence {
  uint32_t base = 0;
  uint32_t root = 0;
  uint32_t depth = 0;
  uint64_t path = 0;
};

class IoWorker;

class Server {
 public:
  Server(Engine* engine, ServerOptions opts);
  ~Server();

  // Bind + listen + spawn accept thread and the io worker pool. Returns
  // false on bind failure.
  bool start();
  // Actual bound port (after start(), useful with port 0).
  uint16_t port() const { return bound_port_; }
  // Request stop: closes the listener, wakes every worker, and shuts down
  // all client sockets. Never joins — callable from a worker thread
  // (SHUTDOWN verb) as well as from outside.
  void stop();
  // True once stop was requested (by stop() or a SHUTDOWN command).
  bool stopping() const { return stop_.load(std::memory_order_acquire); }
  // Block until the accept loop and every io worker have exited.
  void wait();

  void set_cluster_callback(ClusterCallback cb);
  EventQueue& events() { return events_; }
  ServerStats& stats() { return stats_; }
  // I/O-plane shape; fixed once start() ran (workers cannot be resized
  // under live connections).
  void configure_io(size_t io_threads, bool pipelined) {
    if (started_) return;
    opts_.io_threads = io_threads;
    opts_.pipelined = pipelined;
  }
  size_t io_threads() const { return workers_live_; }
  bool pipelined() const { return opts_.pipelined; }
  // SO_REUSEPORT accept sharding (-1 off, 0 auto, 1 on); fixed at start().
  void configure_accept(int reuseport) {
    if (started_) return;
    opts_.reuseport = reuseport < 0 ? -1 : reuseport > 0 ? 1 : 0;
  }
  // True once start() actually sharded the accept path (auto/on AND the
  // kernel granted SO_REUSEPORT on every worker's listener).
  bool reuseport_active() const { return reuseport_live_; }
  // Request-line byte cap (a SET of a large value needs headroom beyond
  // the 1 MiB default); fixed at start().
  void set_max_line(size_t n) {
    if (!started_ && n > 0) opts_.max_line = n;
  }
  // Zero-copy serving A/B: when off, GET/MGET restore the copy-out discipline
  // (value copied out of the engine under the shard lock, moved into the
  // queue) — the bench's compat baseline. Wire-identical either way.
  void set_zero_copy(bool on) {
    zero_copy_.store(on, std::memory_order_release);
  }
  bool zero_copy() const {
    return zero_copy_.load(std::memory_order_acquire);
  }
  // Change-event staging is opt-in: without a drainer (standalone binary,
  // replication disabled) staging would pin up to capacity keys+values.
  void set_events_enabled(bool on) {
    events_enabled_.store(on, std::memory_order_release);
  }
  bool events_enabled() const {
    return events_enabled_.load(std::memory_order_acquire);
  }
  // Command-latency histogram toggle (on by default). The off switch exists
  // so the metrics plane's hot-path overhead is A/B-measurable in bench.py.
  void set_latency_enabled(bool on) {
    latency_enabled_.store(on, std::memory_order_release);
  }
  // Read-serving gate for node bootstrap: while off, data-plane reads and
  // anti-entropy serving verbs (GET/MGET/SCAN/EXISTS/DBSIZE/HASH/
  // LEAFHASHES/HASHPAGE/TREELEVEL/SNAPMETA/SNAPCHUNK) answer
  // "ERROR LOADING ..." — a bootstrapping node must not serve unverified
  // state to clients, nor a partial keyspace to a peer's walk (a pairwise
  // sync against a half-loaded replica would mirror its absences as
  // deletions). Writes, PING, STATS and the cluster-management verbs stay
  // available: writes are safe under LWW (the verified snapshot installs
  // through set_if_newer and never clobbers newer local state).
  void set_serving(bool on) {
    serving_.store(on, std::memory_order_release);
  }
  bool serving() const { return serving_.load(std::memory_order_acquire); }

  // Admission-control limits (overload protection). max_connections 0 =
  // unlimited: past it, accepted sockets are answered "ERROR BUSY
  // connections" and closed without entering the worker pool — a
  // connection flood can exhaust neither fds nor request state.
  // max_pipeline bounds one connection's commands BUFFERED-BUT-
  // UNANSWERED at once: exceeding it answers BUSY and closes. Coarse by
  // design — one recv() of tiny commands can carry thousands of lines,
  // so set it ABOVE the deepest pipeline well-behaved clients use (or
  // leave 0 = unlimited; the 1 MiB line buffer already bounds bytes).
  void set_limits(size_t max_connections, size_t max_pipeline) {
    max_connections_.store(max_connections, std::memory_order_release);
    max_pipeline_.store(max_pipeline, std::memory_order_release);
  }
  // Degradation ladder: the control plane pushes the folded watermark
  // level; dispatch() enforces it on write verbs, accept on connections.
  void set_degradation(Degradation level, DegradeReason reason) {
    degrade_reason_.store(int(reason), std::memory_order_release);
    degradation_.store(int(level), std::memory_order_release);
  }
  int degradation() const {
    return degradation_.load(std::memory_order_acquire);
  }
  // Partitioned cluster mode: this node owns exactly ONE partition of a
  // P-way keyspace (partition = first 8 bytes of SHA-256(key), big-endian,
  // mod P — identical to cluster/partmap.py). While count > 0, every
  // key-bearing data verb whose key hashes to a FOREIGN partition answers
  // the retryable "ERROR MOVED <pid> <epoch>" instead of serving — a
  // client or router holding a stale partition map can never silently
  // read/write the wrong node. HASH/TREELEVEL requests carrying a pt=
  // address for a foreign partition answer MOVED the same way. The epoch
  // rides in the answer so the client knows which map generation refused
  // it. count 0 = unpartitioned (the guard is off, default).
  void set_partition(uint64_t epoch, uint32_t count, uint32_t owned) {
    part_table_.store(nullptr, std::memory_order_release);
    part_epoch_.store(epoch, std::memory_order_release);
    part_owned_.store(owned, std::memory_order_release);
    part_count_.store(count, std::memory_order_release);
  }
  // Split-map generalization (live rebalancing): ownership follows the
  // split tree of cluster/partmap.py — with h the routing hash above,
  // root = h % base and sub = h / base, partition p owns its key iff
  // roots[p] == root and (sub & ((1 << depths[p]) - 1)) == paths[p]. The
  // boot map (base == count, all depths 0) reduces to h % count, which is
  // why set_partition() stays the legacy fast path (null table). The
  // table is swapped atomically; superseded tables are retired, never
  // freed mid-flight (bounded by the handful of epoch changes a process
  // ever sees).
  void set_partition_map(uint64_t epoch, uint32_t base, uint32_t count,
                         uint32_t owned,
                         std::vector<PartAssignment> assigns);
  // Rebalance write fence: while armed, key-bearing WRITE verbs whose key
  // falls inside (root, depth, path) under base answer the retryable
  // "ERROR BUSY rebalance retry" — the flip window's write stall. Reads
  // keep serving (donor data stays current precisely BECAUSE the writes
  // are refused), so fence != unavailability for the moving range.
  void set_partition_fence(uint32_t base, uint32_t root, uint32_t depth,
                           uint64_t path);
  void clear_partition_fence() {
    part_fence_.store(nullptr, std::memory_order_release);
  }
  uint32_t partition_count() const {
    return part_count_.load(std::memory_order_acquire);
  }
  // Slow-command threshold in MICROSECONDS (0 = off, the default): a
  // dispatch taking at least this long is recorded in the flight log and
  // relayed to the control plane as a SLOWCMD notification. The load is
  // one relaxed atomic on the request path; everything else happens only
  // for slow commands.
  void set_slow_threshold_us(uint64_t us) {
    slow_threshold_us_.store(us, std::memory_order_relaxed);
  }
  // FLIGHT's bare-node fallback body (also the tsan stress drain target).
  std::string flight_text(size_t n) { return flight_.wire_dump(n); }
  // STATS body shared by the wire verb and the C API bridge: the counter
  // block plus the server-scope extension lines (event-queue depth/drops,
  // engine tombstone evictions, the degradation level and its shed
  // counters, and the io-plane worker counters) so /metrics sees both the
  // overload and the io plane without a new channel.
  std::string stats_text();

 private:
  friend class IoWorker;

  void accept_loop();
  // Execute one parsed command, appending its response to `out` (values
  // ride as moved payload segments). Sets *close_conn for SHUTDOWN.
  void dispatch(const Command& cmd, OutQueue& out, bool* close_conn);
  // Parse + dispatch one request line into `out`, with the per-command
  // stats/latency/trace bookkeeping. Sets *close_conn for SHUTDOWN.
  void run_command(const std::string& line,
                   const std::shared_ptr<ClientMeta>& meta, OutQueue& out,
                   bool* close_conn);

  // Serializes (engine write + event push) per key stripe so the staged
  // event order always matches the engine's final state for a key.
  std::mutex& write_stripe(const std::string& key);
  void stage_event(ChangeOp op, const std::string& key,
                   const std::string& value, bool has_value);
  // Accept-path admission shared by the classic accept loop and the
  // per-worker reuseport listeners: true = refused (BUSY answered on the
  // still-blocking fd, closed, counted) against the SHARED connection
  // count, so overload-ladder semantics hold no matter which socket accepted.
  bool refuse_admission(int fd);
  // Post-admission connection setup (meta, client table, counters,
  // TCP_NODELAY + O_NONBLOCK), shared by both accept paths.
  std::shared_ptr<ClientMeta> register_conn(int fd, const sockaddr_in& peer);

  Engine* engine_;
  ServerOptions opts_;
  ServerStats stats_;
  EventQueue events_;
  std::atomic<bool> events_enabled_{false};
  std::atomic<bool> latency_enabled_{true};
  std::atomic<bool> serving_{true};
  std::atomic<size_t> max_connections_{0};  // 0 = unlimited
  // 0 = unlimited, like every watermark: deep pipelining is a legitimate
  // throughput pattern (the pipelined bench sends thousands of commands
  // per write), so the budget is strictly opt-in per deployment.
  std::atomic<size_t> max_pipeline_{0};
  std::atomic<int> degradation_{0};     // Degradation enum value
  std::atomic<int> degrade_reason_{0};  // DegradeReason enum value
  // Partitioned cluster mode (0 partitions = off; see set_partition).
  std::atomic<uint64_t> part_epoch_{0};
  std::atomic<uint32_t> part_count_{0};
  std::atomic<uint32_t> part_owned_{0};
  // Split-map table + rebalance fence (null = legacy h % count / no
  // fence). Readers take one acquire load on the request path; writers
  // build off-path and retire superseded objects instead of freeing them
  // under readers' feet (part_mu_ guards only the retire lists).
  std::atomic<const PartTable*> part_table_{nullptr};
  std::atomic<const PartFence*> part_fence_{nullptr};
  std::mutex part_mu_;
  std::vector<std::unique_ptr<const PartTable>> part_retired_;
  std::vector<std::unique_ptr<const PartFence>> fence_retired_;
  std::atomic<bool> zero_copy_{true};   // GET/MGET block path vs compat copy
  bool reuseport_live_ = false;         // accept sharding resolved at start
  std::atomic<uint64_t> slow_threshold_us_{0};  // 0 = slow log off
  FlightLog flight_;
  static constexpr size_t kWriteStripes = 64;
  std::mutex write_stripes_[kWriteStripes];
  std::atomic<int> listen_fd_{-1};
  std::mutex lifecycle_mu_;
  uint16_t bound_port_ = 0;
  std::thread accept_thread_;
  std::atomic<bool> stop_{false};
  bool started_ = false;
  std::atomic<uint64_t> next_client_id_{1};

  // The io worker pool. workers_live_ is the resolved width (0 until
  // start()); next_worker_ deals accepted fds round-robin.
  std::vector<std::unique_ptr<IoWorker>> workers_;
  std::unique_ptr<IoWorkerStats[]> worker_stats_;
  size_t workers_live_ = 0;
  std::atomic<size_t> next_worker_{0};

  std::mutex clients_mu_;
  std::map<uint64_t, std::shared_ptr<ClientMeta>> clients_;

  std::mutex cb_mu_;
  ClusterCallback cluster_cb_;

  // TREELEVEL host fallback: reference-tree levels built from an engine
  // snapshot, cached keyed on the engine's mutation version so one O(n)
  // build amortizes over a whole bisection walk (~log n requests). The
  // cluster callback (device-resident tree) gets first refusal; this cache
  // only serves when no control plane answers. The levels sum to ~64 B per
  // key and a walk needs them for seconds per anti-entropy period, so a
  // reaper thread frees the cache once it sits idle (tree_last_used_)
  // instead of pinning ~640 MB at the 10M-key target forever.
  void tree_reaper_loop();
  std::mutex tree_mu_;
  bool tree_valid_ = false;
  uint64_t tree_version_ = 0;
  std::chrono::steady_clock::time_point tree_last_used_{};
  std::chrono::steady_clock::time_point tree_built_{};
  std::vector<std::vector<std::array<uint8_t, 32>>> tree_levels_;
  std::thread tree_reaper_;
};

}  // namespace mkv
