// A copy of merklekv_tpu/native/server.cc, built by the port into build/native/.
#include "server.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <functional>
#include <unordered_map>

#include "merkle.h"
#include "protocol.h"
#include "sha256.h"

namespace mkv {

namespace {

uint64_t unix_now() { return uint64_t(::time(nullptr)); }

uint64_t unix_now_ns() {
  return uint64_t(std::chrono::duration_cast<std::chrono::nanoseconds>(
                      std::chrono::system_clock::now().time_since_epoch())
                      .count());
}

// Wire verb name for the TRACESPAN notification (traced cluster verbs only).
const char* traced_verb_name(Verb v) {
  switch (v) {
    case Verb::TreeLevel: return "TREELEVEL";
    case Verb::HashPage: return "HASHPAGE";
    case Verb::LeafHashes: return "LEAFHASHES";
    case Verb::SnapMeta: return "SNAPMETA";
    case Verb::SnapChunk: return "SNAPCHUNK";
    default: return "CMD";
  }
}

// Full verb-name map for the slow-command log (every verb can be slow).
const char* verb_name(Verb v) {
  switch (v) {
    case Verb::Get: return "GET";
    case Verb::Set: return "SET";
    case Verb::Delete: return "DELETE";
    case Verb::Increment: return "INC";
    case Verb::Decrement: return "DEC";
    case Verb::Append: return "APPEND";
    case Verb::Prepend: return "PREPEND";
    case Verb::MultiGet: return "MGET";
    case Verb::MultiSet: return "MSET";
    case Verb::Truncate: return "TRUNCATE";
    case Verb::Exists: return "EXISTS";
    case Verb::Scan: return "SCAN";
    case Verb::Dbsize: return "DBSIZE";
    case Verb::Hash: return "HASH";
    case Verb::LeafHashes: return "LEAFHASHES";
    case Verb::Stats: return "STATS";
    case Verb::Info: return "INFO";
    case Verb::Version: return "VERSION";
    case Verb::Memory: return "MEMORY";
    case Verb::ClientList: return "CLIENT";
    case Verb::Flushdb: return "FLUSHDB";
    case Verb::Shutdown: return "SHUTDOWN";
    case Verb::Ping: return "PING";
    case Verb::Echo: return "ECHO";
    case Verb::Sync: return "SYNC";
    case Verb::Replicate: return "REPLICATE";
    case Verb::HashPage: return "HASHPAGE";
    case Verb::TreeLevel: return "TREELEVEL";
    case Verb::Peers: return "PEERS";
    case Verb::Metrics: return "METRICS";
    case Verb::Trace: return "TRACE";
    case Verb::SnapMeta: return "SNAPMETA";
    case Verb::SnapChunk: return "SNAPCHUNK";
    case Verb::TraceDump: return "TRACEDUMP";
    case Verb::Profile: return "PROFILE";
    case Verb::Flight: return "FLIGHT";
    case Verb::PartMap: return "PARTMAP";
    case Verb::Rebalance: return "REBALANCE";
  }
  return "CMD";
}

// Blocking write for the accept-loop admission answers only (the fd is
// still blocking there; worker-owned sockets flush through OutQueue).
bool send_all(int fd, const std::string& data) {
  size_t off = 0;
  while (off < data.size()) {
    ssize_t r = ::send(fd, data.data() + off, data.size() - off, MSG_NOSIGNAL);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    off += size_t(r);
  }
  return true;
}

const char* degrade_reason_text(int reason) {
  switch (DegradeReason(reason)) {
    case DegradeReason::kMemory: return "memory";
    case DegradeReason::kDisk: return "disk";
    case DegradeReason::kDraining: return "draining";
    case DegradeReason::kAdmin: return "admin";
    default: return "overload";
  }
}

// Verbs refused while the node sheds or runs read-only. Everything else —
// reads, PING, STATS/INFO/METRICS, and the whole cluster-management plane
// (SYNC/REPLICATE/SNAPMETA/...) — keeps serving: anti-entropy is the
// mechanism that repairs what shedding drops, so it must never be behind
// the gate it exists to clean up after.
bool is_write_verb(Verb v) {
  switch (v) {
    case Verb::Set:
    case Verb::Delete:
    case Verb::Increment:
    case Verb::Decrement:
    case Verb::Append:
    case Verb::Prepend:
    case Verb::MultiSet:
    case Verb::Truncate:
    case Verb::Flushdb:
      return true;
    default:
      return false;
  }
}

// key -> routing hash: first 8 bytes of SHA-256(key) as a big-endian u64.
// MUST stay bit-identical to cluster/partmap.py::hash_of_key — the smart
// clients, the router, and this guard all route from the same hash or
// MOVED ping-pongs forever.
uint64_t routing_hash(const std::string& key) {
  uint8_t d[32];
  sha256(key.data(), key.size(), d);
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | d[i];
  return v;
}

// The guard's per-dispatch view of the partition state: identity atomics
// plus the (possibly null) split table, loaded ONCE per command so every
// key in a multi-key verb is judged against the same map generation.
struct PartView {
  uint32_t count = 0;
  uint32_t owned = 0;
  const PartTable* table = nullptr;  // null = legacy h % count

  uint32_t owner_of(const std::string& key) const {
    const uint64_t h = routing_hash(key);
    if (table == nullptr) return uint32_t(h % count);
    const uint64_t root = h % table->base;
    const uint64_t sub = h / table->base;
    for (uint32_t pid = 0; pid < table->assigns.size(); ++pid) {
      const PartAssignment& a = table->assigns[pid];
      if (a.root == root &&
          (sub & ((uint64_t(1) << a.depth) - 1)) == a.path) {
        return pid;
      }
    }
    // Unreachable against a validated map (the Python layer proves the
    // assignments tile the hash space before installing); serving beats
    // bricking dispatch if an uncovered hash ever appears.
    return owned;
  }
};

// First FOREIGN partition addressed by this command, or -1 when every key
// (and any pt= tree address) belongs to `pv.owned`. Only key-bearing data
// verbs participate: keyless verbs (PING/STATS/SCAN/TRUNCATE/...) are
// whole-node operations, and the management/anti-entropy plane must never
// be refused by routing (it repairs what routing mistakes leave behind).
int64_t foreign_partition(const Command& cmd, const PartView& pv) {
  switch (cmd.verb) {
    case Verb::Get:
    case Verb::Set:
    case Verb::Delete:
    case Verb::Increment:
    case Verb::Decrement:
    case Verb::Append:
    case Verb::Prepend: {
      uint32_t p = pv.owner_of(cmd.key);
      return p == pv.owned ? -1 : int64_t(p);
    }
    case Verb::Exists:
    case Verb::MultiGet:
      for (const auto& k : cmd.keys) {
        uint32_t p = pv.owner_of(k);
        if (p != pv.owned) return int64_t(p);
      }
      return -1;
    case Verb::MultiSet:
      for (const auto& [k, v] : cmd.pairs) {
        (void)v;
        uint32_t p = pv.owner_of(k);
        if (p != pv.owned) return int64_t(p);
      }
      return -1;
    case Verb::Hash:
    case Verb::TreeLevel:
      // Partition-scoped tree addressing: a pt= token naming a partition
      // this node does not own is a stale-map read — MOVED, never a
      // silently different partition's tree into the caller's walk.
      if (cmd.partition >= 0 && uint64_t(cmd.partition) != pv.owned) {
        return cmd.partition;
      }
      return -1;
    default:
      return -1;
  }
}

// True iff `key` falls inside the fenced (moving) range.
bool key_in_fence(const std::string& key, const PartFence& f) {
  const uint64_t h = routing_hash(key);
  if (h % f.base != f.root) return false;
  return ((h / f.base) & ((uint64_t(1) << f.depth) - 1)) == f.path;
}

// First fenced key of a WRITE verb, or false. Reads stay open (the donor's
// copy is authoritative until the flip — writes being refused is exactly
// what keeps it authoritative); keyless writes (TRUNCATE/FLUSHDB) are
// whole-node admin actions outside the fence's scope.
bool fence_blocks(const Command& cmd, const PartFence& f) {
  switch (cmd.verb) {
    case Verb::Set:
    case Verb::Delete:
    case Verb::Increment:
    case Verb::Decrement:
    case Verb::Append:
    case Verb::Prepend:
      return key_in_fence(cmd.key, f);
    case Verb::MultiSet:
      for (const auto& [k, v] : cmd.pairs) {
        (void)v;
        if (key_in_fence(k, f)) return true;
      }
      return false;
    default:
      return false;
  }
}

}  // namespace

// ------------------------------------------------------------- IoWorker
//
// One epoll event loop owning a fixed subset of the connections. All of a
// connection's state (input carry, pipeline budget, out queue, interest
// flags) is touched by this thread ONLY — the cross-thread surface is the
// inbox (accept loop hands fds over) and the atomic counters.
class IoWorker {
 public:
  IoWorker(Server* srv, size_t idx) : srv_(srv), ws_(srv->worker_stats_[idx]) {}

  ~IoWorker() {
    join_thread();
    release();
  }

  // Accept sharding: hand this worker its own SO_REUSEPORT listening
  // socket (nonblocking) BEFORE start(); the worker accepts directly in
  // its event loop — no accept-thread hop, no inbox round trip.
  void set_listen(int fd) { listen_fd_ = fd; }

  bool start() {
    epfd_ = ::epoll_create1(EPOLL_CLOEXEC);
    if (epfd_ < 0) return false;
    int p[2];
    if (::pipe2(p, O_NONBLOCK | O_CLOEXEC) != 0) {
      ::close(epfd_);
      epfd_ = -1;
      return false;
    }
    wake_r_ = p[0];
    wake_w_ = p[1];
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = wake_r_;
    ::epoll_ctl(epfd_, EPOLL_CTL_ADD, wake_r_, &ev);
    if (listen_fd_ >= 0) {
      epoll_event lv{};
      lv.events = EPOLLIN;
      lv.data.fd = listen_fd_;
      ::epoll_ctl(epfd_, EPOLL_CTL_ADD, listen_fd_, &lv);
    }
    th_ = std::thread([this] { loop(); });
    return true;
  }

  // Hand an accepted (already registered, nonblocking) fd to this worker.
  void submit(int fd, std::shared_ptr<ClientMeta> meta) {
    {
      std::lock_guard lk(inbox_mu_);
      inbox_.push_back({fd, std::move(meta)});
    }
    wake();
  }

  void wake() {
    char b = 1;
    // Nonblocking pipe: a full pipe already guarantees a pending wakeup.
    ssize_t r = ::write(wake_w_, &b, 1);
    (void)r;
  }

  // Teardown is two-phase so no fd closes while ANY worker thread can
  // still wake() a sibling (a SHUTDOWN-ing worker runs stop() — which
  // pokes every worker's wake pipe — from inside its own loop):
  // join_thread() for EVERY worker first, release() after.
  void join_thread() {
    if (th_.joinable()) th_.join();
  }

  // Release every fd this worker still references — connections it owned
  // plus inbox handoffs that raced shutdown. Only after all joins.
  void release() {
    for (auto& [fd, c] : conns_) {
      (void)c;
      deregister(*c);
      ::close(fd);
    }
    conns_.clear();
    std::lock_guard lk(inbox_mu_);
    for (auto& p : inbox_) drop_pending(p);
    inbox_.clear();
    if (listen_fd_ >= 0) ::close(listen_fd_);
    if (wake_r_ >= 0) ::close(wake_r_);
    if (wake_w_ >= 0) ::close(wake_w_);
    if (epfd_ >= 0) ::close(epfd_);
    listen_fd_ = wake_r_ = wake_w_ = epfd_ = -1;
  }

 private:
  struct Pending {
    int fd;
    std::shared_ptr<ClientMeta> meta;
  };

  struct Conn {
    int fd = -1;
    std::shared_ptr<ClientMeta> meta;
    std::string in;       // partial frame carried across reads
    size_t pending = 0;   // complete-but-unanswered lines buffered
    OutQueue out;
    bool want_write = false;   // EPOLLOUT armed (flush hit EAGAIN)
    bool read_paused = false;  // backpressure: out backlog past the HWM
    bool closing = false;      // flush what is queued, then close
    bool shutdown_req = false; // SHUTDOWN verb: act after the flush
  };

  enum class FlushResult { kDone, kBlocked, kError };

  // Intake cap per readable event: past this the worker round-robins to
  // its other connections (level-triggered epoll re-signals the rest).
  static constexpr size_t kMaxIntake = 256 * 1024;
  // Output backlog watermarks (hysteresis, applied while the socket is
  // write-blocked): past kOutHigh the connection stops being READ (a
  // reader that never drains cannot grow the queue without bound); once
  // the backlog falls below kOutLow reading resumes.
  static constexpr size_t kOutHigh = 8u << 20;
  static constexpr size_t kOutLow = 1u << 20;
  static constexpr size_t kMaxIov = 64;

  void loop() {
    epoll_event evs[128];
    for (;;) {
      int n = ::epoll_wait(epfd_, evs, 128, -1);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      if (n > 0) ws_.wakeups.fetch_add(1, std::memory_order_relaxed);
      bool woken = false;
      for (int i = 0; i < n; ++i) {
        const int fd = evs[i].data.fd;
        if (fd == wake_r_) {
          char buf[256];
          while (::read(wake_r_, buf, sizeof(buf)) > 0) {
          }
          woken = true;
          continue;
        }
        if (fd == listen_fd_) {
          accept_shard();
          continue;
        }
        auto it = conns_.find(fd);
        if (it == conns_.end()) continue;
        Conn& c = *it->second;
        const uint32_t e = evs[i].events;
        bool alive = (e & EPOLLERR) == 0;
        if (alive && (e & EPOLLOUT)) alive = drive(c);
        if (alive && !c.read_paused && (e & (EPOLLIN | EPOLLHUP))) {
          alive = on_readable(c);
        }
        if (!alive) destroy(it);
      }
      if (woken) adopt_inbox();
      if (srv_->stop_.load(std::memory_order_acquire)) break;
    }
  }

  // Drain this worker's own reuseport listener: accept until EAGAIN, run
  // the SHARED admission control, and install admitted connections
  // directly into this loop — the connection never crosses a thread.
  void accept_shard() {
    for (;;) {
      sockaddr_in peer{};
      socklen_t plen = sizeof(peer);
      int fd = ::accept(listen_fd_,
                        reinterpret_cast<sockaddr*>(&peer), &plen);
      if (fd < 0) {
        if (errno == EINTR) continue;
        break;  // EAGAIN (drained) or listener gone
      }
      if (srv_->stop_.load(std::memory_order_acquire)) {
        ::close(fd);
        break;
      }
      if (srv_->refuse_admission(fd)) continue;
      auto meta = srv_->register_conn(fd, peer);
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = fd;
      if (::epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &ev) != 0) {
        Pending p{fd, std::move(meta)};
        drop_pending(p);
        continue;
      }
      auto c = std::make_unique<Conn>();
      c->fd = fd;
      c->meta = std::move(meta);
      ws_.connections.fetch_add(1, std::memory_order_relaxed);
      ws_.accepts.fetch_add(1, std::memory_order_relaxed);
      conns_[fd] = std::move(c);
    }
  }

  void adopt_inbox() {
    std::vector<Pending> pend;
    {
      std::lock_guard lk(inbox_mu_);
      pend.swap(inbox_);
    }
    for (auto& p : pend) {
      if (srv_->stop_.load(std::memory_order_acquire)) {
        drop_pending(p);
        continue;
      }
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = p.fd;
      if (::epoll_ctl(epfd_, EPOLL_CTL_ADD, p.fd, &ev) != 0) {
        drop_pending(p);
        continue;
      }
      auto c = std::make_unique<Conn>();
      c->fd = p.fd;
      c->meta = std::move(p.meta);
      ws_.connections.fetch_add(1, std::memory_order_relaxed);
      conns_[p.fd] = std::move(c);
    }
  }

  // Undo the accept loop's registration for a connection that never made
  // it into (or is leaving) the event loop.
  void drop_pending(const Pending& p) {
    {
      std::lock_guard lk(srv_->clients_mu_);
      srv_->clients_.erase(p.meta->id);
    }
    ::close(p.fd);
    srv_->stats_.active_connections--;
  }

  void deregister(Conn& c) {
    {
      std::lock_guard lk(srv_->clients_mu_);
      srv_->clients_.erase(c.meta->id);
    }
    srv_->stats_.active_connections--;
    ws_.connections.fetch_sub(1, std::memory_order_relaxed);
  }

  void destroy(std::unordered_map<int, std::unique_ptr<Conn>>::iterator it) {
    Conn& c = *it->second;
    ::epoll_ctl(epfd_, EPOLL_CTL_DEL, c.fd, nullptr);
    deregister(c);
    ::close(c.fd);
    conns_.erase(it);
  }

  void update_interest(Conn& c) {
    epoll_event ev{};
    ev.events = (c.read_paused ? 0u : uint32_t(EPOLLIN)) |
                (c.want_write ? uint32_t(EPOLLOUT) : 0u);
    ev.data.fd = c.fd;
    ::epoll_ctl(epfd_, EPOLL_CTL_MOD, c.fd, &ev);
  }

  bool on_readable(Conn& c) {
    // A closing connection only waits out its flush; nothing it sends
    // will be parsed, so don't let it grow the input buffer either.
    if (c.closing) return drive(c);
    char chunk[65536];
    size_t got = 0;
    bool eof = false;
    for (;;) {
      ssize_t r = ::recv(c.fd, chunk, sizeof(chunk), 0);
      if (r > 0) {
        for (ssize_t i = 0; i < r; ++i) {
          if (chunk[i] == '\n') ++c.pending;
        }
        c.in.append(chunk, size_t(r));
        got += size_t(r);
        if (size_t(r) < sizeof(chunk) || got >= kMaxIntake) break;
      } else if (r == 0) {
        eof = true;
        break;
      } else if (errno == EINTR) {
        continue;
      } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
        break;
      } else {
        return false;
      }
    }
    // EOF with no complete frame buffered: plain close (a trailing
    // partial line was never answerable).
    if (eof && c.in.find('\n') == std::string::npos) return false;
    // In-flight budget: commands buffered-but-unanswered on this
    // connection (counted per newline received, decremented per line
    // dispatched). Exceeding it answers BUSY and closes — the pipelined
    // loop otherwise happily queues any depth.
    const size_t maxp = srv_->max_pipeline_.load(std::memory_order_acquire);
    if (maxp > 0 && c.pending > maxp) {
      srv_->stats_.pipeline_rejected.fetch_add(1, std::memory_order_relaxed);
      c.out.lit("ERROR BUSY pipeline retry\r\n");
      c.closing = true;
    }
    if (!drive(c)) return false;
    if (eof && !c.closing) {
      // Half-close: the commands that arrived before the FIN were
      // dispatched above — flush their responses (the peer may have only
      // shutdown its write side), then close.
      c.closing = true;
      return drive(c);
    }
    return true;
  }

  // The connection's state machine: parse + dispatch buffered frames,
  // flush the coalesced responses, manage interest + backpressure.
  // Returns false when the connection is finished (caller closes it).
  bool drive(Conn& c) {
    for (;;) {
      process_lines(c);
      if (c.closing && !c.in.empty()) {
        // Nothing past a closing point is ever parsed: free the input
        // carry instead of letting a flooding client grow it while the
        // close waits out a blocked flush.
        c.in.clear();
        c.in.shrink_to_fit();
        c.pending = 0;
      }
      FlushResult fr = flush(c);
      if (fr == FlushResult::kError) return false;
      if (fr == FlushResult::kBlocked) {
        // Backpressure hysteresis while the socket is full: stop READING
        // past kOutHigh, resume below kOutLow, hold state in between. A
        // closing connection never reads again.
        const bool pause = c.closing           ? true
                           : c.out.bytes > kOutHigh ? true
                           : c.out.bytes < kOutLow  ? false
                                                    : c.read_paused;
        bool changed = false;
        if (!c.want_write) {
          c.want_write = true;
          changed = true;
        }
        if (pause != c.read_paused) {
          c.read_paused = pause;
          changed = true;
        }
        if (changed) update_interest(c);
        return true;
      }
      // Fully flushed.
      if (c.closing) {
        if (c.shutdown_req) {
          if (srv_->opts_.exit_on_shutdown) {
            // Reference parity: SHUTDOWN exits the process
            // (server.rs:909-923) — after the OK has been flushed.
            std::exit(0);
          }
          srv_->stop();
        }
        return false;
      }
      bool changed = false;
      if (c.want_write) {
        c.want_write = false;
        changed = true;
      }
      if (c.read_paused) {
        c.read_paused = false;
        changed = true;
      }
      if (changed) update_interest(c);
      // More complete frames still buffered (compat mode processes one
      // per pass; backpressure may have paused mid-buffer): keep going.
      if (c.in.find('\n') == std::string::npos) return true;
    }
  }

  // Parse and dispatch every complete line currently buffered, appending
  // responses (in request order) to the out queue. Stops early on
  // backpressure, close, or — compat mode — after one command.
  void process_lines(Conn& c) {
    size_t pos = 0;
    const bool pipelined = srv_->opts_.pipelined;
    while (!c.closing && c.out.bytes <= kOutHigh) {
      size_t nl = c.in.find('\n', pos);
      if (nl == std::string::npos) break;
      std::string line = c.in.substr(pos, nl + 1 - pos);
      pos = nl + 1;
      if (c.pending > 0) --c.pending;
      if (line.size() > srv_->opts_.max_line) {
        c.out.lit("ERROR line too long\r\n");
        c.closing = true;
        break;
      }
      bool close_conn = false;
      srv_->run_command(line, c.meta, c.out, &close_conn);
      ws_.commands.fetch_add(1, std::memory_order_relaxed);
      if (close_conn) {
        c.closing = true;
        c.shutdown_req = true;
        break;
      }
      if (!pipelined) break;  // compat: one response per flush/syscall
    }
    if (pos > 0) c.in.erase(0, pos);
    // Unterminated input past the line cap: same answer as an oversized
    // complete line (the residue here never contains a newline).
    if (!c.closing && c.in.size() > srv_->opts_.max_line &&
        c.in.find('\n') == std::string::npos) {
      c.out.lit("ERROR line too long\r\n");
      c.closing = true;
    }
  }

  // Flush the out queue: one sendmsg (writev) over up to kMaxIov pending
  // segments per syscall, until drained or the socket blocks.
  FlushResult flush(Conn& c) {
    while (c.out.bytes > 0) {
      iovec iov[kMaxIov];
      size_t n = 0;
      size_t off = c.out.head_off;
      for (size_t i = c.out.head; i < c.out.segs.size() && n < kMaxIov; ++i) {
        const OutQueue::Seg& s = c.out.segs[i];
        if (off >= s.size()) {
          off = 0;
          continue;
        }
        iov[n].iov_base = const_cast<char*>(s.data()) + off;
        iov[n].iov_len = s.size() - off;
        ++n;
        off = 0;
      }
      if (n == 0) break;
      msghdr mh{};
      mh.msg_iov = iov;
      mh.msg_iovlen = n;
      ssize_t w = ::sendmsg(c.fd, &mh, MSG_NOSIGNAL);
      if (w < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          return FlushResult::kBlocked;
        }
        return FlushResult::kError;
      }
      ws_.writev_calls.fetch_add(1, std::memory_order_relaxed);
      ws_.writev_bytes.fetch_add(uint64_t(w), std::memory_order_relaxed);
      size_t rem = size_t(w);
      c.out.bytes -= rem;
      while (rem > 0) {
        OutQueue::Seg& s = c.out.segs[c.out.head];
        const size_t avail = s.size() - c.out.head_off;
        if (rem >= avail) {
          rem -= avail;
          // Segment fully on the wire: release its bytes NOW — for a
          // block segment that drops the response's pin on the value the
          // moment the kernel has it, not at end-of-burst.
          s.str.clear();
          s.str.shrink_to_fit();
          s.block.reset();
          ++c.out.head;
          c.out.head_off = 0;
        } else {
          c.out.head_off += rem;
          rem = 0;
        }
      }
    }
    c.out.reset();
    return FlushResult::kDone;
  }

  Server* srv_;
  IoWorkerStats& ws_;
  int epfd_ = -1;
  int wake_r_ = -1;
  int wake_w_ = -1;
  int listen_fd_ = -1;  // this worker's reuseport listener (-1 = none)
  std::thread th_;
  std::mutex inbox_mu_;
  std::vector<Pending> inbox_;
  std::unordered_map<int, std::unique_ptr<Conn>> conns_;
};

// --------------------------------------------------------------- Server

Server::Server(Engine* engine, ServerOptions opts)
    : engine_(engine), opts_(std::move(opts)) {}

Server::~Server() {
  stop();
  wait();
}

namespace {

// One extra SO_REUSEPORT listener on the already-bound address (the
// kernel load-balances accepts across every listener on the tuple).
// Nonblocking: the owning worker accepts from its epoll loop.
int make_reuseport_listener(const sockaddr_in& addr) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (::setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one)) != 0 ||
      ::bind(fd, reinterpret_cast<const sockaddr*>(&addr),
             sizeof(addr)) < 0 ||
      ::listen(fd, 1024) < 0) {
    ::close(fd);
    return -1;
  }
  ::fcntl(fd, F_SETFL, ::fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
  return fd;
}

}  // namespace

bool Server::start() {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return false;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  // Accept sharding wants SO_REUSEPORT on the PRIMARY socket too (later
  // binds to the tuple are refused otherwise). auto (0) degrades silently
  // where the kernel lacks it; on (1) degrades with a note; off (-1)
  // never asks.
  bool rp = false;
  if (opts_.reuseport >= 0) {
    rp = ::setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one)) == 0;
    if (!rp && opts_.reuseport > 0) {
      std::fprintf(stderr,
                   "merklekv: reuseport=on but SO_REUSEPORT unsupported; "
                   "falling back to the single accept loop\n");
    }
  }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(opts_.port);
  if (::inet_pton(AF_INET, opts_.host.c_str(), &addr.sin_addr) != 1) {
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
  }
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return false;
  }
  if (::listen(fd, 1024) < 0) {
    ::close(fd);
    return false;
  }
  sockaddr_in bound{};
  socklen_t blen = sizeof(bound);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&bound), &blen);
  bound_port_ = ntohs(bound.sin_port);

  // The worker pool, sized once: hardware concurrency unless configured.
  size_t n = opts_.io_threads;
  if (n == 0) {
    n = std::thread::hardware_concurrency();
    if (n == 0) n = 1;
  }
  if (n > 64) n = 64;  // sanity cap; nothing here scales past that
  worker_stats_.reset(new IoWorkerStats[n]);
  // Shard the accept path: each worker gets its own listener on the
  // bound tuple (ephemeral port 0 resolved above, so every shard binds
  // the same real port). A shard that fails to bind just leaves that
  // worker on the handoff path; sharding counts as live only when EVERY
  // worker got one — a half-sharded pool would skew the kernel's deal.
  size_t shards = 0;
  std::vector<int> shard_fds(n, -1);
  if (rp && n > 0) {
    sockaddr_in saddr = addr;
    saddr.sin_port = htons(bound_port_);
    for (size_t i = 0; i < n; ++i) {
      shard_fds[i] = make_reuseport_listener(saddr);
      if (shard_fds[i] >= 0) ++shards;
    }
    if (shards != n) {
      for (int& sfd : shard_fds) {
        if (sfd >= 0) ::close(sfd);
        sfd = -1;
      }
      shards = 0;
    }
  }
  reuseport_live_ = shards == n && shards > 0 && rp;
  for (size_t i = 0; i < n; ++i) {
    auto w = std::make_unique<IoWorker>(this, i);
    if (reuseport_live_) w->set_listen(shard_fds[i]);
    if (!w->start()) {
      stop_.store(true, std::memory_order_release);
      for (auto& live : workers_) live->wake();
      w.reset();         // releases this worker's shard listener too
      workers_.clear();  // ~IoWorker joins + releases
      // Shard listeners not yet handed to a worker.
      for (size_t j = i + 1; j < n; ++j) {
        if (shard_fds[j] >= 0) ::close(shard_fds[j]);
      }
      stop_.store(false, std::memory_order_release);
      worker_stats_.reset();
      reuseport_live_ = false;
      ::close(fd);
      return false;
    }
    workers_.push_back(std::move(w));
  }
  workers_live_ = n;
  started_ = true;

  listen_fd_.store(fd, std::memory_order_release);
  accept_thread_ = std::thread([this] { accept_loop(); });
  tree_reaper_ = std::thread([this] { tree_reaper_loop(); });
  return true;
}

void Server::tree_reaper_loop() {
  // Free the TREELEVEL host cache after it sits idle: a bisection walk
  // uses it for seconds, the anti-entropy period is minutes, and the
  // levels cost ~64 bytes per key.
  constexpr auto kIdle = std::chrono::seconds(30);
  while (!stop_.load(std::memory_order_acquire)) {
    // Short poll: ~free when idle, and server shutdown (stop -> wait
    // joins this thread) never stalls behind a long sleep.
    ::usleep(50 * 1000);
    std::lock_guard lk(tree_mu_);
    if (tree_valid_ &&
        std::chrono::steady_clock::now() - tree_last_used_ > kIdle) {
      tree_levels_.clear();
      tree_levels_.shrink_to_fit();
      tree_valid_ = false;
    }
  }
}

void Server::stop() {
  stop_.store(true, std::memory_order_release);
  {
    // Only shutdown() here — the single close() happens in wait() after the
    // accept thread has exited, so no thread ever touches a recycled fd.
    std::lock_guard lk(lifecycle_mu_);
    int fd = listen_fd_.load(std::memory_order_acquire);
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
  }
  {
    std::lock_guard lk(clients_mu_);
    for (auto& [id, meta] : clients_) {
      (void)id;
      ::shutdown(meta->fd, SHUT_RDWR);
    }
  }
  for (auto& w : workers_) w->wake();
}

void Server::wait() {
  if (accept_thread_.joinable()) accept_thread_.join();
  if (tree_reaper_.joinable()) tree_reaper_.join();
  {
    std::lock_guard lk(lifecycle_mu_);
    int fd = listen_fd_.exchange(-1, std::memory_order_acq_rel);
    if (fd >= 0) ::close(fd);
  }
  // Join EVERY worker loop before releasing ANY fd: a worker running
  // stop() (SHUTDOWN verb) pokes sibling wake pipes, so those fds must
  // outlive all worker threads. The accept thread has already exited, so
  // no new submissions can arrive either.
  for (auto& w : workers_) w->join_thread();
  for (auto& w : workers_) w->release();
}

void Server::set_cluster_callback(ClusterCallback cb) {
  std::lock_guard lk(cb_mu_);
  cluster_cb_ = std::move(cb);
}

void Server::set_partition_map(uint64_t epoch, uint32_t base, uint32_t count,
                               uint32_t owned,
                               std::vector<PartAssignment> assigns) {
  // A boot-shaped map (base == count, assignment i == (i, 0, 0)) takes
  // the legacy null-table path: owner_of stays the one-modulo fast guard
  // and STATS stays byte-identical to the pre-split format.
  bool trivial = (base == count && assigns.size() == count);
  if (trivial) {
    for (uint32_t i = 0; i < count; ++i) {
      if (assigns[i].root != i || assigns[i].depth != 0 ||
          assigns[i].path != 0) {
        trivial = false;
        break;
      }
    }
  }
  const PartTable* published = nullptr;
  if (!trivial && base > 0 && assigns.size() == count) {
    auto t = std::make_unique<PartTable>();
    t->base = base;
    t->assigns = std::move(assigns);
    published = t.get();
    std::lock_guard lk(part_mu_);
    part_retired_.push_back(std::move(t));
  }
  // Publication order: identity first, table next, count LAST — count is
  // the guard's enable bit, so a command can never observe "guard on"
  // before the rest of the new generation is visible. A command racing
  // the swap may judge one key against the outgoing generation; it then
  // answers MOVED with the NEW epoch, which is exactly the refresh signal
  // the clients heal through.
  part_epoch_.store(epoch, std::memory_order_release);
  part_owned_.store(owned, std::memory_order_release);
  part_table_.store(published, std::memory_order_release);
  part_count_.store(count, std::memory_order_release);
}

void Server::set_partition_fence(uint32_t base, uint32_t root, uint32_t depth,
                                 uint64_t path) {
  auto f = std::make_unique<PartFence>();
  f->base = base;
  f->root = root;
  f->depth = depth;
  f->path = path;
  const PartFence* published = f.get();
  {
    std::lock_guard lk(part_mu_);
    fence_retired_.push_back(std::move(f));
  }
  part_fence_.store(published, std::memory_order_release);
}

bool Server::refuse_admission(int fd) {
  // Admission control: past max_connections (or while draining) the
  // excess accept is answered BUSY and closed RIGHT HERE — it never
  // enters the worker pool, holds no request state. The answer goes out
  // within one RTT of the connect, and established connections never see
  // the flood: their worker loops keep turning. The count is the SHARED
  // active_connections atomic, CLAIMED here (not in register_conn) as a
  // fetch_add with roll-back: N workers accepting concurrently on their
  // reuseport listeners would otherwise all pass a plain load-compare at
  // maxc-1 and overshoot the cap by up to N-1 — the claim keeps the
  // limit exact on both accept paths.
  const bool draining =
      degradation_.load(std::memory_order_acquire) >=
      int(Degradation::kDraining);
  bool refuse = draining;
  if (!refuse) {
    const size_t maxc = max_connections_.load(std::memory_order_acquire);
    const uint64_t prev =
        stats_.active_connections.fetch_add(1, std::memory_order_relaxed);
    if (maxc > 0 && prev >= maxc) {
      stats_.active_connections.fetch_sub(1, std::memory_order_relaxed);
      refuse = true;
    }
  }
  if (!refuse) return false;
  stats_.busy_rejected_connections.fetch_add(1, std::memory_order_relaxed);
  send_all(fd, draining ? "ERROR BUSY draining\r\n"
                        : "ERROR BUSY connections retry\r\n");
  ::close(fd);
  return true;
}

std::shared_ptr<ClientMeta> Server::register_conn(int fd,
                                                  const sockaddr_in& peer) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  char ip[INET_ADDRSTRLEN] = "?";
  ::inet_ntop(AF_INET, &peer.sin_addr, ip, sizeof(ip));
  auto meta = std::make_shared<ClientMeta>();
  meta->id = next_client_id_.fetch_add(1);
  meta->addr = std::string(ip) + ":" + std::to_string(ntohs(peer.sin_port));
  meta->connected_unix = unix_now();
  meta->last_cmd_unix.store(meta->connected_unix);
  meta->fd = fd;
  {
    std::lock_guard lk(clients_mu_);
    clients_[meta->id] = meta;
  }
  stats_.total_connections++;
  // active_connections was already claimed by refuse_admission (the
  // claim IS the admission decision); every teardown path decrements it
  // exactly once via drop_pending/deregister.
  ::fcntl(fd, F_SETFL, ::fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
  return meta;
}

void Server::accept_loop() {
  const int lfd = listen_fd_.load(std::memory_order_acquire);
  for (;;) {
    sockaddr_in peer{};
    socklen_t plen = sizeof(peer);
    int fd = ::accept(lfd, reinterpret_cast<sockaddr*>(&peer), &plen);
    if (fd < 0) {
      if (stop_.load(std::memory_order_acquire)) break;
      if (errno == EINTR) continue;
      break;
    }
    if (stop_.load(std::memory_order_acquire)) {
      ::close(fd);
      break;
    }
    if (refuse_admission(fd)) continue;
    // Round-robin handoff: the worker owns the fd from here (stop() after
    // this point still reaches it — via the clients_ shutdown poke AND the
    // worker's own stop_-checked inbox/teardown paths). With accept
    // sharding live this loop still serves the primary listener's share
    // of the kernel's deal.
    auto meta = register_conn(fd, peer);
    const size_t w =
        next_worker_.fetch_add(1, std::memory_order_relaxed) % workers_live_;
    workers_[w]->submit(fd, std::move(meta));
  }
}

std::string Server::stats_text() {
  // One body for the STATS verb AND the C-API bridge (mkv_server_stats ->
  // /metrics): the reference-parity counter block, then the extension
  // lines — engine tombstone evictions, event-queue depth/drops (the
  // replication feed's backlog), the overload plane (degradation level +
  // shed counters), and the io plane (pool shape + per-worker loop
  // counters). All integer-valued `name:value` text, so the exporter
  // bridges every line without special cases.
  std::string out = stats_.format_stats();
  auto add = [&](const std::string& name, unsigned long long v) {
    out += name;
    out += ":";
    out += std::to_string(v);
    out += "\r\n";
  };
  auto ld = [](const std::atomic<uint64_t>& a) {
    return (unsigned long long)a.load(std::memory_order_relaxed);
  };
  add("tombstone_evictions", engine_->tomb_evictions());
  add("events_queue_depth", events_.size());
  add("events_dropped", events_.dropped());
  add("degradation", degradation_.load(std::memory_order_acquire));
  // Flight recorder: lifetime count of dispatches past the slow-command
  // threshold (the log itself streams via FLIGHT).
  add("slow_commands", flight_.total());
  add("busy_rejected_connections", ld(stats_.busy_rejected_connections));
  add("pipeline_rejected", ld(stats_.pipeline_rejected));
  add("shed_commands", ld(stats_.shed_commands));
  add("readonly_commands", ld(stats_.readonly_commands));
  // Partitioned cluster mode: the routing-guard refusal count plus the
  // partition identity lines (emitted only while partitioned, so an
  // unpartitioned node's STATS stays byte-compatible with older parsers).
  add("moved_commands", ld(stats_.moved_commands));
  add("fenced_commands", ld(stats_.fenced_commands));
  {
    const uint32_t pcount = part_count_.load(std::memory_order_acquire);
    if (pcount > 0) {
      add("partition_count", pcount);
      add("partition_id", part_owned_.load(std::memory_order_acquire));
      add("partition_epoch", part_epoch_.load(std::memory_order_acquire));
      const PartTable* t = part_table_.load(std::memory_order_acquire);
      if (t != nullptr) add("partition_base", t->base);
    }
  }
  // Zero-copy serving plane: the slab account (live/pinned bytes feed the
  // watermark story; pinned = bytes held only by in-flight responses)
  // plus the serve-path counters the bench A/B reads.
  {
    SlabStats slab = engine_->slab_stats();
    add("slab_bytes", slab.bytes);
    add("slab_blocks", slab.blocks);
    add("slab_pinned_bytes", slab.pinned_bytes);
    add("slab_allocs", slab.allocs);
    add("slab_alloc_failures", slab.alloc_failures);
  }
  add("serve_zero_copy", ld(stats_.serve_zero_copy));
  add("serve_value_copies", ld(stats_.serve_value_copies));
  // io plane: pool shape + per-worker counters (loop depth = commands /
  // wakeups; mean flush size = writev_bytes / writev_calls). Per-worker
  // lines let the top dashboard and /metrics see imbalance, not just sums.
  add("io_threads", workers_live_);
  add("io_pipelined", opts_.pipelined ? 1 : 0);
  add("io_reuseport", reuseport_live_ ? 1 : 0);
  for (size_t i = 0; i < workers_live_; ++i) {
    const IoWorkerStats& ws = worker_stats_[i];
    const std::string p = "io_worker_" + std::to_string(i) + "_";
    add(p + "connections", ld(ws.connections));
    add(p + "commands", ld(ws.commands));
    add(p + "wakeups", ld(ws.wakeups));
    add(p + "writev_calls", ld(ws.writev_calls));
    add(p + "writev_bytes", ld(ws.writev_bytes));
    add(p + "accepts", ld(ws.accepts));
  }
  return out;
}

std::mutex& Server::write_stripe(const std::string& key) {
  return write_stripes_[std::hash<std::string>{}(key) % kWriteStripes];
}

void Server::stage_event(ChangeOp op, const std::string& key,
                         const std::string& value, bool has_value) {
  if (events_enabled_.load(std::memory_order_acquire)) {
    events_.push(op, key, value, has_value);
  }
}

void Server::run_command(const std::string& line,
                         const std::shared_ptr<ClientMeta>& meta,
                         OutQueue& out, bool* close_conn) {
  auto parsed = parse_command(line);
  if (!parsed.ok) {
    out.lit("ERROR ");
    out.lit(parsed.error);
    out.lit("\r\n");
    return;
  }
  meta->last_cmd_unix.store(unix_now(), std::memory_order_relaxed);
  stats_.count(parsed.cmd);
  // Per-command dispatch latency: two steady_clock reads + one relaxed
  // atomic add per command (~50 ns against a multi-us dispatch) feed
  // the lock-free histogram behind STATS cmd_latency_us_* — cheap
  // enough to stay on by default on the SET hot path (bench.py
  // measures the overhead; set_latency_enabled is the A/B switch).
  const bool timed = latency_enabled_.load(std::memory_order_acquire);
  const bool traced = !parsed.cmd.trace.empty();
  // Slow-command log: one relaxed load on the hot path; everything past
  // the threshold comparison happens only for commands that ARE slow.
  const uint64_t slow_us =
      slow_threshold_us_.load(std::memory_order_relaxed);
  const bool want_clock = timed || traced || slow_us > 0;
  const auto t0 = want_clock ? std::chrono::steady_clock::now()
                             : std::chrono::steady_clock::time_point{};
  // Wall-clock start rides with the TRACESPAN notification so the
  // collector can place the donor span on the initiator's timeline
  // (cross-node skew is the usual Dapper caveat, documented).
  const uint64_t wall0 = traced ? unix_now_ns() : 0;
  dispatch(parsed.cmd, out, close_conn);
  if (want_clock) {
    const uint64_t dur_ns = uint64_t(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0)
            .count());
    if (timed) stats_.latency.observe_ns(dur_ns);
    if (slow_us > 0 && dur_ns / 1000 >= slow_us) {
      // Record verb/latency/connection in the native flight log, and
      // relay to the control plane (when attached) so the Python flight
      // ring carries the same record on the node's merged timeline.
      const uint64_t dur_us = dur_ns / 1000;
      const char* vn = verb_name(parsed.cmd.verb);
      flight_.record(vn, meta->addr, unix_now_ns() - dur_ns, dur_us);
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        // A traced serve relays its tc= token too: the control plane
        // stamps the trace id on the flight event, which is what lets
        // the blackbox analyzer link a donor's slow serve to the
        // initiator's cycle across two nodes' spills.
        std::string line = std::string("SLOWCMD ") + vn + " " +
                           std::to_string(dur_us) + " " + meta->addr;
        if (traced) line += " " + parsed.cmd.trace;
        cb(line);
      }
    }
    if (traced) {
      // Fire-and-forget span notification to the control plane: only
      // traced cluster verbs pay this (a handful per sync cycle, never
      // the GET/SET hot path); the response is ignored — a node
      // without a cluster plane simply drops the span.
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        cb(std::string("TRACESPAN ") + traced_verb_name(parsed.cmd.verb) +
           " " + parsed.cmd.trace + " " + std::to_string(wall0) + " " +
           std::to_string(dur_ns));
      }
    }
  }
}

void Server::dispatch(const Command& cmd, OutQueue& out, bool* close_conn) {
  // Partition guard FIRST (before the overload/serving gates): a key that
  // does not belong here must be re-ROUTED, not retried here — BUSY or
  // LOADING on a wrong-node request would send the client into a retry
  // loop against a node that can never serve it. The MOVED answer carries
  // the partition the key hashes to plus this node's map epoch, so a
  // stale client refreshes its map and re-routes (typed MovedError in the
  // clients; docs/PROTOCOL.md "Partitioned cluster mode").
  const uint32_t pcount = part_count_.load(std::memory_order_acquire);
  if (pcount > 0) {
    PartView pv;
    pv.count = pcount;
    pv.owned = part_owned_.load(std::memory_order_acquire);
    pv.table = part_table_.load(std::memory_order_acquire);
    const int64_t fp = foreign_partition(cmd, pv);
    if (fp >= 0) {
      stats_.moved_commands.fetch_add(1, std::memory_order_relaxed);
      out.lit("ERROR MOVED " + std::to_string(fp) + " " +
              std::to_string(part_epoch_.load(std::memory_order_acquire)) +
              "\r\n");
      return;
    }
  }
  // Rebalance write fence (the flip window of a live split): writes into
  // the moving range answer a RETRYABLE BUSY — the same backoff contract
  // as shedding, so every existing client retry loop already heals it.
  // Checked after the MOVED guard (a foreign key re-routes, it does not
  // wait) and before the degradation ladder (the fence is stricter).
  {
    const PartFence* fence = part_fence_.load(std::memory_order_acquire);
    if (fence != nullptr && fence_blocks(cmd, *fence)) {
      stats_.fenced_commands.fetch_add(1, std::memory_order_relaxed);
      out.lit("ERROR BUSY rebalance retry\r\n");
      return;
    }
  }
  // Degradation ladder: shedding answers writes with a RETRYABLE BUSY
  // (memory/disk pressure is transient — clients back off and retry);
  // read_only/draining answer READONLY (not retryable until the node
  // recovers). Reads and the management/anti-entropy plane stay open —
  // anti-entropy is what repairs whatever the hot path sheds.
  const int deg = degradation_.load(std::memory_order_acquire);
  if (deg >= int(Degradation::kShedding) && is_write_verb(cmd.verb)) {
    const char* why =
        degrade_reason_text(degrade_reason_.load(std::memory_order_acquire));
    if (deg == int(Degradation::kShedding)) {
      stats_.shed_commands.fetch_add(1, std::memory_order_relaxed);
      out.lit("ERROR BUSY ");
      out.lit(why);
      out.lit(" retry\r\n");
      return;
    }
    stats_.readonly_commands.fetch_add(1, std::memory_order_relaxed);
    out.lit("ERROR READONLY ");
    out.lit(why);
    out.lit("\r\n");
    return;
  }
  if (!serving_.load(std::memory_order_acquire)) {
    // Bootstrap gate: no read serves before the shipped snapshot's stamped
    // root VERIFIES (cluster/bootstrap.py flips the gate). Blocking the
    // anti-entropy verbs too keeps a peer's pairwise walk from mirroring
    // this node's half-loaded keyspace as deletions; writes and the
    // management plane (PING probes, STATS, REPLICATE) stay open.
    switch (cmd.verb) {
      case Verb::Get:
      case Verb::MultiGet:
      case Verb::Scan:
      case Verb::Exists:
      case Verb::Dbsize:
      case Verb::Hash:
      case Verb::LeafHashes:
      case Verb::HashPage:
      case Verb::TreeLevel:
      case Verb::SnapMeta:
      case Verb::SnapChunk:
        out.lit("ERROR LOADING bootstrap in progress\r\n");
        return;
      default:
        break;
    }
  }
  switch (cmd.verb) {
    case Verb::Get: {
      // The hot path, zero-copy: a ref on the value's immutable block
      // (one atomic bump under the shard lock) rides the out queue as an
      // iovec segment — NO copy of the value after ingest. The compat
      // path (zero_copy=false, the bench A/B baseline) restores the copy-out
      // discipline: one copy out of the engine, moved into the queue.
      if (zero_copy_.load(std::memory_order_acquire)) {
        BlockRef b = engine_->get_block(cmd.key);
        if (!b) {
          out.lit("NOT_FOUND\r\n");
          return;
        }
        out.lit("VALUE ");
        if (out.block(std::move(b))) {
          stats_.serve_zero_copy.fetch_add(1, std::memory_order_relaxed);
        }
        out.lit("\r\n");
        return;
      }
      auto v = engine_->get(cmd.key);
      if (!v) {
        out.lit("NOT_FOUND\r\n");
        return;
      }
      out.lit("VALUE ");
      if (v->size() > OutQueue::kInlinePayload) {
        stats_.serve_value_copies.fetch_add(1, std::memory_order_relaxed);
      }
      out.payload(std::move(*v));
      out.lit("\r\n");
      return;
    }
    case Verb::Ping:
      out.lit("PONG ");
      out.lit(cmd.message);
      out.lit("\r\n");
      return;
    case Verb::Echo:
      out.lit("ECHO ");
      out.lit(cmd.message);
      out.lit("\r\n");
      return;
    case Verb::Dbsize:
      out.lit("DBSIZE " + std::to_string(engine_->dbsize()) + "\r\n");
      return;
    case Verb::Exists: {
      size_t count = 0;
      for (const auto& k : cmd.keys) {
        if (engine_->exists(k)) ++count;
      }
      out.lit("EXISTS " + std::to_string(count) + "\r\n");
      return;
    }
    case Verb::Scan: {
      auto keys = engine_->scan(cmd.prefix);
      std::string body = "KEYS " + std::to_string(keys.size()) + "\r\n";
      for (const auto& k : keys) {
        body += k;
        body += "\r\n";
      }
      out.payload(std::move(body));
      return;
    }
    case Verb::Set: {
      std::lock_guard lk(write_stripe(cmd.key));
      // Discard any stale latch (an earlier Result-path refusal on this
      // thread) so a non-slab failure below cannot misreport as BUSY.
      (void)consume_slab_exhausted();
      if (!engine_->set(cmd.key, cmd.value)) {
        // Slab-arena exhaustion is a typed, RETRYABLE refusal feeding the
        // Overload-ladder semantics: shed the write with the same BUSY-memory
        // answer the shedding rung uses — never abort, never OOM.
        if (consume_slab_exhausted()) {
          stats_.shed_commands.fetch_add(1, std::memory_order_relaxed);
          out.lit("ERROR BUSY memory retry\r\n");
          return;
        }
        out.lit("ERROR set failed\r\n");
        return;
      }
      stage_event(ChangeOp::Set, cmd.key, cmd.value, true);
      out.lit("OK\r\n");
      return;
    }
    case Verb::Delete: {
      std::lock_guard lk(write_stripe(cmd.key));
      if (engine_->del(cmd.key)) {
        stage_event(ChangeOp::Del, cmd.key, "", false);
        out.lit("DELETED\r\n");
        return;
      }
      out.lit("NOT_FOUND\r\n");
      return;
    }
    case Verb::Memory:
      out.lit("MEMORY " + std::to_string(engine_->memory_usage()) + "\r\n");
      return;
    case Verb::ClientList: {
      std::string body = "CLIENT LIST\r\n";
      uint64_t now = unix_now();
      {
        std::lock_guard lk(clients_mu_);
        for (const auto& [id, c] : clients_) {
          uint64_t last = c->last_cmd_unix.load(std::memory_order_relaxed);
          uint64_t age =
              now >= c->connected_unix ? now - c->connected_unix : 0;
          uint64_t idle = now >= last ? now - last : 0;
          body += "id=" + std::to_string(c->id) + " addr=" + c->addr +
                  " age=" + std::to_string(age) +
                  " idle=" + std::to_string(idle) + "\r\n";
        }
      }
      body += "END\r\n";
      out.payload(std::move(body));
      return;
    }
    case Verb::PartMap: {
      // Versioned partition map (extension verb): the routing table smart
      // clients and the thin router bootstrap from. Only the control
      // plane holds a map; a bare (or unpartitioned) node answers ERROR —
      // the capability signal that this deployment has no partitions.
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string resp = cb("PARTMAP");
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      out.lit("ERROR partition map unavailable\r\n");
      return;
    }
    case Verb::Rebalance: {
      // Live resharding control verb: the whole line is relayed to the
      // cluster control plane, where the rebalance state machine lives.
      // Deliberately outside every gate — a donor mid-split may be
      // shedding, a joiner is LOADING, and both must still take
      // COMMIT/ABORT or the session can never finish either way.
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string resp = cb("REBALANCE " + cmd.message);
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      out.lit("ERROR rebalance unavailable\r\n");
      return;
    }
    case Verb::Peers: {
      // Per-peer health from the control plane's failure detector
      // (extension verb — the reference has no peer health at all).
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string resp = cb("PEERS");
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      out.lit("PEERS 0\r\nEND\r\n");
      return;
    }
    case Verb::Metrics: {
      // Control-plane counter snapshot (extension verb): transport
      // reconnects/outbox drops, anti-entropy loop stats, span counters —
      // the Python-layer numbers STATS (engine/server scope) cannot see.
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string resp = cb("METRICS");
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      out.lit("METRICS\r\nEND\r\n");
      return;
    }
    case Verb::Trace: {
      // Correlated anti-entropy cycle traces from the control plane's ring
      // buffer (extension verb; per-peer bytes/rounds/repairs/outcome).
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string resp =
            cb("TRACE " + std::to_string(cmd.amount.value_or(8)));
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      out.lit("TRACES 0\r\nEND\r\n");
      return;
    }
    case Verb::TraceDump: {
      // Raw causal-trace spans from the control plane's collector (the
      // cross-node stitching input; obs/tracewire.py assembles dumps from
      // several nodes into one Chrome trace-event JSON).
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string resp =
            cb("TRACEDUMP " + std::to_string(cmd.amount.value_or(0)));
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      out.lit("SPANS 0\r\nEND\r\n");
      return;
    }
    case Verb::Flight: {
      // Flight-recorder stream: the control plane serves its full event
      // ring (state transitions + slow commands relayed via SLOWCMD); a
      // bare native node still answers from its own slow-command log —
      // the black box must answer even with no Python attached.
      const int64_t n = cmd.amount.value_or(64);
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string resp = cb("FLIGHT " + std::to_string(n));
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      out.payload(flight_.wire_dump(size_t(n)));
      return;
    }
    case Verb::Profile: {
      // Bounded device-profiler capture; only the control plane owns a jax
      // runtime, so a bare native node reports unavailability.
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string resp =
            cb("PROFILE " + std::to_string(cmd.amount.value_or(1)));
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      out.lit("ERROR device profiler unavailable\r\n");
      return;
    }
    case Verb::SnapMeta:
    case Verb::SnapChunk: {
      // Snapshot shipping is served by the control plane (it owns the
      // durable store and retention pinning); a node without one answers
      // ERROR — the capability signal that sends a joiner to the plain
      // anti-entropy walk, exactly like a TREELEVEL-less peer degrades a
      // bisection walk to paging.
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string line =
            cmd.verb == Verb::SnapMeta
                ? std::string("SNAPMETA")
                : "SNAPCHUNK " + std::to_string(cmd.snap_seq) + " " +
                      std::to_string(cmd.snap_off) + " " +
                      std::to_string(cmd.snap_cnt);
        std::string resp = cb(line);
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      out.lit("ERROR snapshot shipping unavailable\r\n");
      return;
    }
    case Verb::Sync:
    case Verb::Replicate: {
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        // Reconstruct a canonical line for the callback.
        std::string line;
        if (cmd.verb == Verb::Sync) {
          line = "SYNC " + cmd.host + " " + std::to_string(cmd.port);
          if (cmd.full) line += " --full";
          if (cmd.verify) line += " --verify";
        } else {
          line = "REPLICATE ";
          line += cmd.action == ReplicateAction::Enable    ? "enable"
                  : cmd.action == ReplicateAction::Disable ? "disable"
                                                           : "status";
        }
        std::string resp = cb(line);
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      if (cmd.verb == Verb::Replicate &&
          cmd.action == ReplicateAction::Status) {
        out.lit("REPLICATION disabled\r\n");
        return;
      }
      if (cmd.verb == Verb::Replicate &&
          cmd.action == ReplicateAction::Disable) {
        out.lit("OK\r\n");
        return;
      }
      out.lit("ERROR replication not configured\r\n");
      return;
    }
    case Verb::Hash: {
      // Pattern semantics (server.rs:647-658): absent or "*" = all keys;
      // otherwise a plain prefix.
      std::string pat = cmd.pattern.value_or("");
      std::string prefix = (pat == "*") ? "" : pat;
      if (pat.empty()) {
        // Bare HASH only ("HASH *" echoes the pattern, a different wire
        // shape): give the control plane first refusal — it serves the
        // device pump's last-published root in O(1) instead of rehashing
        // every leaf here. The version-stamp token rides along verbatim
        // so the plane can stamp (and force-refresh) its answer.
        ClusterCallback cb;
        {
          std::lock_guard lk(cb_mu_);
          cb = cluster_cb_;
        }
        if (cb) {
          std::string line = "HASH";
          if (cmd.want_version || cmd.force_refresh) {
            // Reconstruct the exact flag set: a force-only token (vs=02)
            // must reach the cluster plane too, or its refresh silently
            // no-ops on cluster nodes while working on bare ones.
            int flags = (cmd.want_version ? 1 : 0) |
                        (cmd.force_refresh ? 2 : 0);
            line += " vs=0" + std::to_string(flags);
          }
          std::string resp = cb(line);
          if (!resp.empty()) {
            out.payload(std::move(resp));
            return;
          }
        }
      }
      // Stamp read BEFORE the scan: a mutation landing mid-scan makes the
      // root at least as fresh as the stamp, never staler than claimed.
      uint64_t hash_ver = engine_->version();
      auto keys = engine_->scan(prefix);
      std::vector<std::pair<std::string, std::string>> items;
      items.reserve(keys.size());
      for (const auto& k : keys) {
        if (auto v = engine_->get(k)) items.emplace_back(k, *v);
      }
      uint8_t root[32];
      std::string hex = merkle_root(std::move(items), root)
                            ? digest_hex(root)
                            : std::string(64, '0');
      if (pat.empty()) {
        if (cmd.want_version) {
          // Live-engine answer: the stamp is the version it reflects and
          // the lag is 0 by construction.
          out.lit("HASH " + hex + " " + std::to_string(hash_ver) +
                  " 0\r\n");
        } else {
          out.lit("HASH " + hex + "\r\n");
        }
      } else {
        out.lit("HASH " + pat + " " + hex + "\r\n");
      }
      return;
    }
    case Verb::Increment:
    case Verb::Decrement: {
      int64_t amount = cmd.amount.value_or(1);
      std::lock_guard lk(write_stripe(cmd.key));
      auto r = cmd.verb == Verb::Increment
                   ? engine_->increment(cmd.key, amount)
                   : engine_->decrement(cmd.key, amount);
      if (!r.ok) {
        if (r.error == kSlabExhaustedError) {
          // The typed error text is the verdict; consume the thread-local
          // latch too so it cannot misattribute a LATER unrelated write
          // failure on this io thread.
          (void)consume_slab_exhausted();
          stats_.shed_commands.fetch_add(1, std::memory_order_relaxed);
          out.lit("ERROR BUSY memory retry\r\n");
          return;
        }
        out.lit("ERROR " + r.error + "\r\n");
        return;
      }
      stage_event(
          cmd.verb == Verb::Increment ? ChangeOp::Incr : ChangeOp::Decr,
          cmd.key, std::to_string(r.value), true);
      out.lit("VALUE " + std::to_string(r.value) + "\r\n");
      return;
    }
    case Verb::Append:
    case Verb::Prepend: {
      // Empty value: report current value, never mutate (server.rs:772-779).
      if (cmd.value.empty()) {
        auto v = engine_->get(cmd.key);
        if (v) {
          out.lit("VALUE ");
          out.payload(std::move(*v));
          out.lit("\r\n");
        } else {
          out.lit("ERROR Key not found\r\n");
        }
        return;
      }
      std::lock_guard lk(write_stripe(cmd.key));
      auto r = cmd.verb == Verb::Append ? engine_->append(cmd.key, cmd.value)
                                        : engine_->prepend(cmd.key, cmd.value);
      if (!r.ok) {
        if (r.error == kSlabExhaustedError) {
          (void)consume_slab_exhausted();  // see the INC/DEC branch
          stats_.shed_commands.fetch_add(1, std::memory_order_relaxed);
          out.lit("ERROR BUSY memory retry\r\n");
          return;
        }
        out.lit("ERROR " + r.error + "\r\n");
        return;
      }
      stage_event(
          cmd.verb == Verb::Append ? ChangeOp::Append : ChangeOp::Prepend,
          cmd.key, r.value, true);
      out.lit("VALUE ");
      out.payload(std::move(r.value));
      out.lit("\r\n");
      return;
    }
    case Verb::MultiGet: {
      // Two passes: the found count must ride in the header BEFORE any
      // value. Zero-copy: each found value is a block ref acquired under
      // its shard lock in pass one and handed to the queue in pass two —
      // the refs double as the consistent read set (a concurrent DEL
      // cannot invalidate a value between the passes).
      if (zero_copy_.load(std::memory_order_acquire)) {
        std::vector<BlockRef> vals;
        vals.reserve(cmd.keys.size());
        size_t found = 0;
        for (const auto& k : cmd.keys) {
          vals.push_back(engine_->get_block(k));
          if (vals.back()) ++found;  // present values are 0+-byte blocks
        }
        if (found == 0) {
          out.lit("NOT_FOUND\r\n");
          return;
        }
        out.lit("VALUES " + std::to_string(found) + "\r\n");
        for (size_t i = 0; i < cmd.keys.size(); ++i) {
          out.lit(cmd.keys[i]);
          if (vals[i]) {
            out.lit(" ");
            if (out.block(std::move(vals[i]))) {
              stats_.serve_zero_copy.fetch_add(1,
                                               std::memory_order_relaxed);
            }
            out.lit("\r\n");
          } else {
            out.lit(" NOT_FOUND\r\n");
          }
        }
        return;
      }
      std::vector<std::optional<std::string>> vals;
      vals.reserve(cmd.keys.size());
      size_t found = 0;
      for (const auto& k : cmd.keys) {
        vals.push_back(engine_->get(k));
        if (vals.back()) ++found;
      }
      if (found == 0) {
        out.lit("NOT_FOUND\r\n");
        return;
      }
      out.lit("VALUES " + std::to_string(found) + "\r\n");
      for (size_t i = 0; i < cmd.keys.size(); ++i) {
        out.lit(cmd.keys[i]);
        if (vals[i]) {
          out.lit(" ");
          if (vals[i]->size() > OutQueue::kInlinePayload) {
            stats_.serve_value_copies.fetch_add(1,
                                                std::memory_order_relaxed);
          }
          out.payload(std::move(*vals[i]));
          out.lit("\r\n");
        } else {
          out.lit(" NOT_FOUND\r\n");
        }
      }
      return;
    }
    case Verb::MultiSet: {
      for (const auto& [k, v] : cmd.pairs) {
        std::lock_guard lk(write_stripe(k));
        (void)consume_slab_exhausted();  // discard any stale latch
        if (!engine_->set(k, v)) {
          if (consume_slab_exhausted()) {
            stats_.shed_commands.fetch_add(1, std::memory_order_relaxed);
            out.lit("ERROR BUSY memory retry\r\n");
            return;
          }
          out.lit("ERROR set failed\r\n");
          return;
        }
        stage_event(ChangeOp::Set, k, v, true);
      }
      out.lit("OK\r\n");
      return;
    }
    case Verb::LeafHashes: {
      // Stamp read BEFORE the scan (conservative — same rule as HASH).
      // LEAFHASHES reads the live engine, so lag is 0 and only the
      // version rides the stamped header.
      uint64_t leaf_ver = engine_->version();
      auto keys = engine_->scan(cmd.prefix);
      std::string body;
      size_t listed = 0;
      for (const auto& k : keys) {
        // One atomic (value, ts) read per key: a separate get + get_ts pair
        // can interleave with a write and ship a stale digest stamped with
        // the new write's timestamp — which peers' LWW would then treat as
        // the newest state.
        auto vt = engine_->get_with_ts(k);
        if (!vt) continue;  // deleted between scan and read
        uint8_t d[32];
        leaf_hash(k, vt->first, d);
        // Trailing last-write timestamp (unix ns) feeds the peer's LWW
        // arbitration.
        body += k + " " + digest_hex(d) + " " + std::to_string(vt->second) +
                "\r\n";
        ++listed;
      }
      // Tombstones ride along with digest "-": a peer's multi-replica LWW
      // needs deletion timestamps, or a dropped DEL event is undone forever
      // by any replica still holding the value. Current readers that meet
      // an unknown digest marker treat the payload as undecodable and
      // degrade to the full-snapshot fallback (sync.py
      // _fetch_remote_hashes decodes inside its try for exactly this).
      for (const auto& [k, ts] : engine_->tombstones(cmd.prefix)) {
        body += k + " - " + std::to_string(ts) + "\r\n";
        ++listed;
      }
      if (cmd.want_version) {
        out.lit("HASHES " + std::to_string(listed) + " " +
                std::to_string(leaf_ver) + "\r\n");
      } else {
        out.lit("HASHES " + std::to_string(listed) + "\r\n");
      }
      out.payload(std::move(body));
      return;
    }
    case Verb::HashPage: {
      // Cursor-paged LEAFHASHES: up to `count` merged (live + tombstone)
      // lines for keys strictly after the cursor, GLOBALLY SORTED — unlike
      // LEAFHASHES, which groups tombstones after live keys. Sorted order
      // is what makes a page a verified key range: a peer that has applied
      // pages up to cursor C has converged the keyspace prefix <= C and can
      // resume from C after a dead stream instead of refetching everything.
      // Fewer lines than requested means the keyspace is exhausted.
      const std::string& after = cmd.prefix;
      const int64_t want = cmd.amount.value_or(1);
      // Stamp read before the page selection (live engine, lag 0).
      uint64_t page_ver = engine_->version();
      // page_between is the engine's bounded top-k selection: O(N log page)
      // per request instead of materializing + sorting the whole keyspace
      // for every page of the walk (which made one full paged walk
      // O(N^2/page) — ruinous at the 10M-key target). The optional
      // exclusive upper bound serves the bisection walk's range-bounded
      // leaf fetch: nothing past the divergent range is selected or sent.
      const std::string* upto = cmd.upto ? &*cmd.upto : nullptr;
      auto rows = engine_->page_between(after, upto, size_t(want));
      std::string body;
      int64_t listed = 0;
      for (auto& [k, was_tomb] : rows) {
        // One atomic (value, ts) read, same as LEAFHASHES: a split
        // get + get_ts can pair a stale digest with a newer timestamp.
        // The row's live/tombstone flag is only a hint — the key may have
        // been set or deleted since the page was selected.
        auto vt = engine_->get_with_ts(k);
        if (vt) {
          uint8_t d[32];
          leaf_hash(k, vt->first, d);
          body += k + " " + digest_hex(d) + " " +
                  std::to_string(vt->second) + "\r\n";
          ++listed;
        } else if (auto ts = engine_->tombstone_ts(k)) {
          // Tombstone line: the deletion ts still reaches the peer's LWW.
          body += k + " - " + std::to_string(*ts) + "\r\n";
          ++listed;
        } else {
          // Neither live nor tombstoned (deleted + tombstone evicted since
          // page selection). Dropping the row would shorten the page, and
          // a short page signals keyspace exhaustion to the walker — which
          // would then quiet-delete every local key past the cursor. Emit
          // the ts-0 sentinel instead: "state unknown, skip this key";
          // walkers never adopt a ts-0 tombstone, and the key repairs on
          // the next cycle.
          body += k + " - 0\r\n";
          ++listed;
        }
      }
      if (cmd.want_version) {
        out.lit("HASHES " + std::to_string(listed) + " " +
                std::to_string(page_ver) + "\r\n");
      } else {
        out.lit("HASHES " + std::to_string(listed) + "\r\n");
      }
      out.payload(std::move(body));
      return;
    }
    case Verb::TreeLevel: {
      // Subtree-bisection anti-entropy: digests [lo, hi) of reference-tree
      // level `level` (0 = leaves), plus the live leaf count, so a peer's
      // walk can descend only into divergent subtrees. The cluster control
      // plane gets first refusal — it serves straight from the
      // device-resident incremental tree; without one the host fallback
      // below builds the levels once and reuses them until the engine
      // mutates (version-keyed cache), so one O(n) build amortizes over a
      // whole walk (~log n requests).
      ClusterCallback cb;
      {
        std::lock_guard lk(cb_mu_);
        cb = cluster_cb_;
      }
      if (cb) {
        std::string line = "TREELEVEL " + std::to_string(cmd.level) + " " +
                           std::to_string(cmd.lo) + " " +
                           std::to_string(cmd.hi);
        if (cmd.want_version || cmd.force_refresh) {
          // Exact flag reconstruction — see the HASH relay above.
          int flags = (cmd.want_version ? 1 : 0) |
                      (cmd.force_refresh ? 2 : 0);
          line += " vs=0" + std::to_string(flags);
        }
        std::string resp = cb(line);
        if (!resp.empty()) {
          out.payload(std::move(resp));
          return;
        }
      }
      std::lock_guard lk(tree_mu_);
      // Version read BEFORE the snapshot: a write landing in between makes
      // the cache look older than it is, which only costs one extra
      // rebuild — never an unbounded-stale answer.
      //
      // Short serve-stale TTL on top of the version check: under a live
      // write load EVERY request would otherwise miss (each write bumps
      // the version) and pay a full O(n) snapshot+hash rebuild while
      // holding tree_mu_. Serving one CONSISTENT tree for the TTL is also
      // what a mid-walk peer needs — per-request rebuilds would shift the
      // leaf count between its fetches and abort the walk as churn. The
      // walk tolerates the bounded staleness by design (the reply's
      // version stamp tells it exactly how far the tree trails; a
      // force_refresh token overrides the TTL for an exact answer).
      constexpr auto kServeStale = std::chrono::seconds(5);
      const auto now = std::chrono::steady_clock::now();
      uint64_t v = engine_->version();
      if (!tree_valid_ || cmd.force_refresh ||
          (v != tree_version_ && now - tree_built_ > kServeStale)) {
        tree_levels_ = merkle_levels(engine_->snapshot());
        tree_version_ = v;
        tree_valid_ = true;
        tree_built_ = now;
      }
      tree_last_used_ = now;
      size_t n = tree_levels_.empty() ? 0 : tree_levels_[0].size();
      std::string body;
      size_t count = 0;
      if (size_t(cmd.level) < tree_levels_.size()) {
        const auto& lvl = tree_levels_[size_t(cmd.level)];
        size_t lo = std::min(size_t(cmd.lo), lvl.size());
        size_t hi = std::min(size_t(cmd.hi), lvl.size());
        for (size_t i = lo; i < hi; ++i) {
          body += std::to_string(i) + " " + digest_hex(lvl[i].data()) +
                  "\r\n";
          ++count;
        }
      }
      if (cmd.want_version) {
        // Stamp = the engine version the CACHED tree reflects; lag = how
        // far the live engine has moved past it (0 right after a rebuild).
        uint64_t lag = v >= tree_version_ ? v - tree_version_ : 0;
        out.lit("NODES " + std::to_string(count) + " " + std::to_string(n) +
                " " + std::to_string(tree_version_) + " " +
                std::to_string(lag) + "\r\n");
      } else {
        out.lit("NODES " + std::to_string(count) + " " + std::to_string(n) +
                "\r\n");
      }
      out.payload(std::move(body));
      return;
    }
    case Verb::Truncate:
    case Verb::Flushdb: {
      // FLUSHDB truncates, like the reference (server.rs:901-908).
      if (!engine_->truncate()) {
        out.lit("ERROR truncate failed\r\n");
        return;
      }
      stage_event(ChangeOp::Truncate, "", "", false);
      out.lit("OK\r\n");
      return;
    }
    case Verb::Stats:
      out.lit("STATS\r\n");
      out.payload(stats_text());
      out.lit("END\r\n");
      return;
    case Verb::Info: {
      std::string body = "INFO\r\n";
      body += "version:" + opts_.version + "\r\n";
      body += "uptime_seconds:" + std::to_string(stats_.uptime_seconds()) +
              "\r\n";
      body += "uptime:" + stats_.uptime_human() + "\r\n";
      body += "server_time_unix:" + std::to_string(unix_now()) + "\r\n";
      body += "db_keys:" + std::to_string(engine_->dbsize()) + "\r\n";
      body += "END\r\n";
      out.payload(std::move(body));
      return;
    }
    case Verb::Version:
      out.lit("VERSION " + opts_.version + "\r\n");
      return;
    case Verb::Shutdown:
      *close_conn = true;
      out.lit("OK\r\n");
      return;
  }
  out.lit("ERROR internal\r\n");
}

}  // namespace mkv
