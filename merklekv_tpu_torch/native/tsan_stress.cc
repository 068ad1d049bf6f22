// A copy of merklekv_tpu/native/tsan_stress.cc, built with the port's native
// sources into build/tsan/ by tests/test_torch_tsan.py.
// ThreadSanitizer stress driver for the native runtime (SURVEY §5.2).
//
// The server uses detached handler threads with a hand-rolled lifecycle
// (server.cc accept/stop/wait) whose races were previously comment-argued
// only; this driver machine-checks them under -fsanitize=thread:
//   1. N socket clients hammering one server (mixed verbs incl. multiline
//      STATS/SCAN responses) while a drainer thread pulls the event queue;
//   2. server stop() racing in-flight connections and connect attempts;
//   3. direct multi-thread MemEngine ops (set/del_with_ts/set_if_newer/
//      increment/snapshot/tombstones) across shard locks;
//   4. LogEngine concurrent writers + compaction.
//
// Exit 0 = clean; TSAN reports land on stderr and force exit 66 (the
// default deadly_signals behavior) so a run fails loudly.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "engine.h"
#include "events.h"
#include "server.h"

namespace {

int connect_to(uint16_t port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  ::inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// Send a command line, read until we have at least one full line back
// (multi-line responses drain on subsequent reads — the stress cares about
// races, not response parsing).
bool round_trip(int fd, const std::string& cmd) {
  std::string line = cmd + "\r\n";
  if (::send(fd, line.data(), line.size(), MSG_NOSIGNAL) < 0) return false;
  char buf[8192];
  ssize_t r = ::recv(fd, buf, sizeof(buf), 0);
  return r > 0;
}

void client_worker(uint16_t port, int tid, int iters) {
  int fd = connect_to(port);
  if (fd < 0) return;
  char key[64], cmd[256];
  for (int i = 0; i < iters; ++i) {
    std::snprintf(key, sizeof(key), "k%d:%d", tid, i % 37);
    switch (i % 7) {
      case 0:
        std::snprintf(cmd, sizeof(cmd), "SET %s value-%d", key, i);
        break;
      case 1:
        std::snprintf(cmd, sizeof(cmd), "GET %s", key);
        break;
      case 2:
        std::snprintf(cmd, sizeof(cmd), "INC ctr%d 1", tid);
        break;
      case 3:
        std::snprintf(cmd, sizeof(cmd), "DEL %s", key);
        break;
      case 4:
        std::snprintf(cmd, sizeof(cmd), "MGET %s ctr%d", key, tid);
        break;
      case 5:
        std::snprintf(cmd, sizeof(cmd), "SCAN k%d", tid);
        break;
      default:
        std::snprintf(cmd, sizeof(cmd), "STATS");
        break;
    }
    if (!round_trip(fd, cmd)) break;
  }
  ::close(fd);
}

void stress_server_traffic() {
  mkv::MemEngine engine;
  mkv::ServerOptions opts;
  opts.port = 0;
  mkv::Server server(&engine, opts);
  if (!server.start()) {
    std::fprintf(stderr, "bind failed\n");
    std::exit(1);
  }
  server.set_events_enabled(true);
  server.set_cluster_callback(
      [](const std::string&) { return std::string(); });

  std::atomic<bool> draining{true};
  std::thread drainer([&] {
    while (draining.load(std::memory_order_acquire)) {
      server.events().drain(256);
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  });

  std::vector<std::thread> clients;
  for (int t = 0; t < 8; ++t) {
    clients.emplace_back(client_worker, server.port(), t, 400);
  }
  for (auto& t : clients) t.join();
  draining.store(false, std::memory_order_release);
  drainer.join();
  server.stop();
  server.wait();
}

// Pipelined bursts against the epoll worker pool: N clients, each sending
// whole bursts of single-line-response commands in ONE send and reading
// until every response line arrived — exercises the per-connection parse
// carry, the coalesced writev flush, and the cross-worker engine/event
// paths. A slow-reader client stalls mid-burst to push a connection
// through the EAGAIN/backpressure path while its worker keeps serving the
// others.
void pipelined_worker(uint16_t port, int tid, int bursts, int depth) {
  int fd = connect_to(port);
  if (fd < 0) return;
  for (int b = 0; b < bursts; ++b) {
    std::string burst;
    for (int j = 0; j < depth; ++j) {
      char cmd[128];
      switch ((b + j) % 4) {
        case 0:
          std::snprintf(cmd, sizeof(cmd), "SET p%d:%d value-%d-%d\r\n", tid,
                        j % 29, b, j);
          break;
        case 1:
          std::snprintf(cmd, sizeof(cmd), "GET p%d:%d\r\n", tid, j % 29);
          break;
        case 2:
          std::snprintf(cmd, sizeof(cmd), "INC pc%d 1\r\n", tid);
          break;
        default:
          std::snprintf(cmd, sizeof(cmd), "PING t%d\r\n", tid);
          break;
      }
      burst += cmd;
    }
    if (::send(fd, burst.data(), burst.size(), MSG_NOSIGNAL) < 0) break;
    int newlines = 0;
    char buf[16384];
    while (newlines < depth) {
      ssize_t r = ::recv(fd, buf, sizeof(buf), 0);
      if (r <= 0) {
        ::close(fd);
        return;
      }
      for (ssize_t i = 0; i < r; ++i) {
        if (buf[i] == '\n') ++newlines;
      }
    }
  }
  ::close(fd);
}

// Device-pump analog: the control plane's pump loop hammers version reads
// and tree serving (TREELEVEL host cache under tree_mu_, stamped + forced
// forms, stamped HASH rebuilds) while the io workers dispatch writes — the
// exact overlap the bounded-staleness serving path produces in production.
void pump_worker(uint16_t port, int iters) {
  int fd = connect_to(port);
  if (fd < 0) return;
  for (int i = 0; i < iters; ++i) {
    const char* cmd;
    switch (i % 4) {
      case 0: cmd = "TREELEVEL 0 0 4 vs=01"; break;
      case 1: cmd = "HASH vs=01"; break;
      case 2: cmd = "TREELEVEL 0 0 4 vs=03"; break;  // forced rebuild
      default: cmd = "LEAFHASHES vs=01"; break;
    }
    if (!round_trip(fd, cmd)) break;
  }
  ::close(fd);
}

void slow_reader_worker(uint16_t port, int gets, const std::string& key) {
  int fd = connect_to(port);
  if (fd < 0) return;
  std::string burst;
  for (int i = 0; i < gets; ++i) burst += "GET " + key + "\r\n";
  if (::send(fd, burst.data(), burst.size(), MSG_NOSIGNAL) < 0) {
    ::close(fd);
    return;
  }
  // Stall before reading: the server's out queue for this connection must
  // park behind EPOLLOUT / backpressure without wedging its worker.
  std::this_thread::sleep_for(std::chrono::milliseconds(50));
  int newlines = 0;
  char buf[65536];
  while (newlines < gets) {
    ssize_t r = ::recv(fd, buf, sizeof(buf), 0);
    if (r <= 0) break;
    for (ssize_t i = 0; i < r; ++i) {
      if (buf[i] == '\n') ++newlines;
    }
  }
  ::close(fd);
}

void stress_pipelined_pool() {
  mkv::MemEngine engine;
  engine.set("bigkey", std::string(64 * 1024, 'B'));
  mkv::ServerOptions opts;
  opts.port = 0;
  opts.io_threads = 4;
  mkv::Server server(&engine, opts);
  if (!server.start()) {
    std::fprintf(stderr, "bind failed\n");
    std::exit(1);
  }
  server.set_events_enabled(true);
  // Flight-recorder stress: a 1 us slow threshold makes essentially EVERY
  // dispatch record into the slow-command ring from all 4 io workers,
  // while a drain thread concurrently renders FLIGHT dumps — the exact
  // writer/reader overlap the FLIGHT verb produces in production.
  server.set_slow_threshold_us(1);
  std::atomic<bool> draining{true};
  std::thread drainer([&] {
    while (draining.load(std::memory_order_acquire)) {
      server.events().drain(512);
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  });
  std::thread flight_drainer([&] {
    while (draining.load(std::memory_order_acquire)) {
      server.flight_text(64);
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  });
  std::vector<std::thread> clients;
  for (int t = 0; t < 12; ++t) {
    clients.emplace_back(pipelined_worker, server.port(), t, 40, 32);
  }
  clients.emplace_back(slow_reader_worker, server.port(), 200,
                       std::string("bigkey"));
  // Two pump threads: forced TREELEVEL rebuilds + stamped HASH/LEAFHASHES
  // racing the write storm and each other over tree_mu_ / engine version.
  clients.emplace_back(pump_worker, server.port(), 200);
  clients.emplace_back(pump_worker, server.port(), 200);
  for (auto& t : clients) t.join();
  draining.store(false, std::memory_order_release);
  drainer.join();
  flight_drainer.join();
  server.stop();
  server.wait();
}

// Device fault-containment analog: the guard executor, the
// mirror pump, the integrity scrub, and the heal-probe warm thread all
// read the engine (get / version / snapshot) from their OWN threads while
// io-driven writers mutate it and stamped tree queries force host-cache
// rebuilds — the cross-thread seam the degradation ladder adds on top of
// the mirror pump's overlap. Engine locks must keep every combination clean.
void stress_guard_pump_scrub() {
  mkv::MemEngine engine;
  for (int i = 0; i < 256; ++i) {
    engine.set("scrub:" + std::to_string(i), "v");
  }
  mkv::ServerOptions opts;
  opts.port = 0;
  opts.io_threads = 4;
  mkv::Server server(&engine, opts);
  if (!server.start()) {
    std::fprintf(stderr, "bind failed\n");
    std::exit(1);
  }
  server.set_events_enabled(true);
  std::atomic<bool> running{true};
  // Scrub thread: version fence -> sampled gets -> version fence (the
  // quiescence check scrub_once runs under the mirror lock).
  std::thread scrubber([&] {
    while (running.load(std::memory_order_acquire)) {
      uint64_t v0 = engine.version();
      for (int i = 0; i < 32; ++i) {
        engine.get("scrub:" + std::to_string(i % 256));
      }
      (void)(engine.version() == v0);
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  });
  // Warm/heal-probe thread: whole-keyspace snapshot + watermark reads,
  // concurrent with the write storm (the replace-warm's build input).
  std::thread warmer([&] {
    for (int i = 0; i < 40; ++i) {
      engine.version();
      engine.snapshot();
      std::this_thread::sleep_for(std::chrono::milliseconds(2));
    }
  });
  std::vector<std::thread> clients;
  for (int t = 0; t < 8; ++t) {
    clients.emplace_back(pipelined_worker, server.port(), t, 30, 16);
  }
  // Pump-shaped stamped queries (forced TREELEVEL rebuilds ride tree_mu_).
  clients.emplace_back(pump_worker, server.port(), 150);
  clients.emplace_back(pump_worker, server.port(), 150);
  for (auto& t : clients) t.join();
  running.store(false, std::memory_order_release);
  scrubber.join();
  warmer.join();
  server.stop();
  server.wait();
}

// Zero-copy refcount churn: a GET storm serves refcounted
// slab blocks over the wire while overwrite/DEL/tombstone-eviction churn
// hammers the SAME keys — every served block's lifetime races the
// engine dropping its ref — plus direct get_block holders, a snapshot/
// leaf reader, and a slow reader whose parked writev pins blocks across
// their deletion. The refcount protocol (ref under shard lock, unref on
// flush/teardown, account settle on free) must keep every combination
// clean.
void zc_get_worker(uint16_t port, int bursts, int depth) {
  int fd = connect_to(port);
  if (fd < 0) return;
  for (int b = 0; b < bursts; ++b) {
    std::string burst;
    for (int j = 0; j < depth; ++j) {
      char cmd[64];
      std::snprintf(cmd, sizeof(cmd), "GET zc:%d\r\n", (b + j) % 16);
      burst += cmd;
    }
    if (::send(fd, burst.data(), burst.size(), MSG_NOSIGNAL) < 0) break;
    int newlines = 0;
    char buf[65536];
    while (newlines < depth) {
      ssize_t r = ::recv(fd, buf, sizeof(buf), 0);
      if (r <= 0) {
        ::close(fd);
        return;
      }
      for (ssize_t i = 0; i < r; ++i) {
        if (buf[i] == '\n') ++newlines;
      }
    }
  }
  ::close(fd);
}

void stress_zero_copy_churn() {
  // Tiny tombstone cap: the DEL churn below overflows it constantly, so
  // tombstone EVICTION (the third leg of the churn triad) runs under the
  // same load instead of needing ~1M deletes.
  ::setenv("MKV_MAX_TOMBS_PER_SHARD", "8", 1);
  auto engine = std::make_unique<mkv::MemEngine>();
  ::unsetenv("MKV_MAX_TOMBS_PER_SHARD");
  const std::string big(64 * 1024, 'Z');
  const std::string mid(8 * 1024, 'v');
  for (int i = 0; i < 16; ++i) {
    engine->set("zc:" + std::to_string(i), mid);
  }
  engine->set("zcbig", big);
  mkv::ServerOptions opts;
  opts.port = 0;
  opts.io_threads = 4;
  mkv::Server server(engine.get(), opts);
  if (!server.start()) {
    std::fprintf(stderr, "bind failed\n");
    std::exit(1);
  }
  std::atomic<bool> running{true};
  // Overwrite / DEL / tombstone-evict churn on the SAME keys the GET
  // storm serves: the engine's ref drops race every in-flight response's.
  std::vector<std::thread> churn;
  for (int t = 0; t < 2; ++t) {
    churn.emplace_back([&engine, &mid, t] {
      for (int i = 0; i < 1500; ++i) {
        const std::string k = "zc:" + std::to_string((t * 7 + i) % 16);
        switch (i % 5) {
          case 0: engine->set(k, mid); break;
          case 1: engine->del_with_ts(k, uint64_t(i) + 1); break;
          case 2: engine->set_if_newer(k, mid, UINT64_MAX - 1); break;
          case 3: engine->del_quiet(k); break;
          default: engine->set(k, "tiny-" + std::to_string(i)); break;
        }
      }
    });
  }
  // Direct block holders: take a ref, read it, drop it — the exact
  // engine-side race a worker's dispatch runs, without the socket.
  for (int t = 0; t < 2; ++t) {
    churn.emplace_back([&engine] {
      size_t total = 0;
      for (int i = 0; i < 3000; ++i) {
        mkv::BlockRef b = engine->get_block("zc:" + std::to_string(i % 16));
        if (b) {
          // Touch the bytes: a use-after-free here is what TSAN+ASAN-
          // style tooling must never see.
          total += b.size() ? size_t(b.data()[b.size() - 1]) : 0;
        }
      }
      (void)total;
    });
  }
  // Snapshot/leaf reader: whole-keyspace reads (what the Merkle plane
  // does) racing the churn and the block drops.
  churn.emplace_back([&engine, &running] {
    while (running.load(std::memory_order_acquire)) {
      engine->snapshot();
      engine->memory_usage();
      engine->slab_stats();
      std::this_thread::sleep_for(std::chrono::milliseconds(2));
    }
  });
  std::vector<std::thread> clients;
  for (int t = 0; t < 8; ++t) {
    clients.emplace_back(zc_get_worker, server.port(), 40, 24);
  }
  // Slow reader parked on the big value while the churn overwrites it:
  // its queued blocks must pin the ORIGINAL bytes until drained.
  clients.emplace_back(slow_reader_worker, server.port(), 100,
                       std::string("zcbig"));
  churn.emplace_back([&engine, &big] {
    for (int i = 0; i < 200; ++i) {
      engine->set("zcbig", i % 2 ? big : "small");
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  });
  for (auto& t : clients) t.join();
  running.store(false, std::memory_order_release);
  for (auto& t : churn) t.join();
  server.stop();
  server.wait();
}

void stress_stop_races() {
  // stop() racing live connections + fresh connects: the historical hazard
  // (accept/stop handshake, clients_ table vs handler deregistration).
  for (int round = 0; round < 10; ++round) {
    mkv::MemEngine engine;
    mkv::ServerOptions opts;
    opts.port = 0;
    mkv::Server server(&engine, opts);
    if (!server.start()) std::exit(1);
    std::vector<std::thread> clients;
    for (int t = 0; t < 4; ++t) {
      clients.emplace_back(client_worker, server.port(), t, 60);
    }
    std::thread stopper([&] {
      std::this_thread::sleep_for(std::chrono::milliseconds(5 * round));
      server.stop();
    });
    for (auto& t : clients) t.join();
    stopper.join();
    server.wait();
  }
}

void stress_engine_direct() {
  mkv::MemEngine eng;
  std::vector<std::thread> threads;
  for (int t = 0; t < 4; ++t) {
    threads.emplace_back([&eng, t] {
      char key[64];
      for (int i = 0; i < 2000; ++i) {
        std::snprintf(key, sizeof(key), "e%d:%d", t, i % 61);
        eng.set(key, "v");
        eng.set_if_newer(key, "w", uint64_t(i));
        if (i % 3 == 0) eng.del_with_ts(key, uint64_t(i));
        if (i % 5 == 0) eng.increment("shared", 1);
      }
    });
  }
  threads.emplace_back([&eng] {
    for (int i = 0; i < 200; ++i) {
      eng.snapshot();
      eng.tombstones("");
      eng.dbsize();
      eng.scan("e1");
    }
  });
  for (auto& t : threads) t.join();
}

void stress_log_engine() {
  std::string dir = "/tmp/mkv_tsan_log";
  ::system(("rm -rf " + dir).c_str());
  mkv::LogEngine eng(dir);
  std::vector<std::thread> threads;
  for (int t = 0; t < 4; ++t) {
    threads.emplace_back([&eng, t] {
      char key[64];
      for (int i = 0; i < 500; ++i) {
        std::snprintf(key, sizeof(key), "l%d:%d", t, i % 23);
        eng.set(key, "value");
        if (i % 4 == 0) eng.del_with_ts(key, uint64_t(i + 1));
        if (i % 7 == 0) eng.sync();
      }
    });
  }
  threads.emplace_back([&eng] {
    for (int i = 0; i < 20; ++i) {
      eng.compact();
      eng.snapshot();
    }
  });
  for (auto& t : threads) t.join();
}

}  // namespace

int main() {
  stress_engine_direct();
  std::fprintf(stderr, "engine direct: ok\n");
  stress_log_engine();
  std::fprintf(stderr, "log engine: ok\n");
  stress_server_traffic();
  std::fprintf(stderr, "server traffic: ok\n");
  stress_pipelined_pool();
  std::fprintf(stderr, "pipelined pool: ok\n");
  stress_guard_pump_scrub();
  std::fprintf(stderr, "guard/pump/scrub readers: ok\n");
  stress_zero_copy_churn();
  std::fprintf(stderr, "zero-copy refcount churn: ok\n");
  stress_stop_races();
  std::fprintf(stderr, "stop races: ok\n");
  std::puts("TSAN STRESS PASS");
  return 0;
}
