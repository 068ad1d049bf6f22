// A copy of merklekv_tpu/native/main.cc, built by the port into build/native/.
// Standalone server binary (reference analog: the reference's src/main.rs).
//
// The Python CLI (`python -m merklekv_tpu_torch`) is the full-featured entry point
// (TOML config, replication, anti-entropy, TPU data plane); this binary runs
// the bare native server for ops/bench use with flag parity:
//   merklekv-server [--host H] [--port P] [--engine mem|log]
//                   [--storage-path DIR]
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include "engine.h"
#include "server.h"

int main(int argc, char** argv) {
  std::string host = "127.0.0.1";
  int port = 7379;
  std::string engine_kind = "mem";
  std::string storage_path = "merklekv_data";
  long long io_threads = 0;  // 0 = hardware concurrency
  // Partitioned cluster mode: "--partition PID/COUNT[/EPOCH]" makes this
  // node own one partition of a COUNT-way keyspace — foreign keys answer
  // "ERROR MOVED <pid> <epoch>" (the scale-out bench and ops smoke use
  // this; the full map/PARTMAP plane lives in the Python control plane).
  long long part_id = -1, part_count = 0;
  unsigned long long part_epoch = 1;

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&](const char* flag) -> const char* {
      if (i + 1 >= argc) {
        std::fprintf(stderr, "%s requires a value\n", flag);
        std::exit(2);
      }
      return argv[++i];
    };
    if (a == "--host") {
      host = next("--host");
    } else if (a == "--port") {
      port = std::atoi(next("--port"));
    } else if (a == "--engine") {
      engine_kind = next("--engine");
    } else if (a == "--storage-path") {
      storage_path = next("--storage-path");
    } else if (a == "--io-threads") {
      io_threads = std::atoll(next("--io-threads"));
    } else if (a == "--partition") {
      const char* spec = next("--partition");
      unsigned long long pid = 0, cnt = 0, ep = 1;
      int got = std::sscanf(spec, "%llu/%llu/%llu", &pid, &cnt, &ep);
      if (got < 2 || cnt == 0 || pid >= cnt) {
        std::fprintf(stderr,
                     "--partition wants PID/COUNT[/EPOCH] with PID < "
                     "COUNT, got %s\n",
                     spec);
        return 2;
      }
      part_id = (long long)pid;
      part_count = (long long)cnt;
      part_epoch = ep;
    } else if (a == "--help" || a == "-h") {
      std::printf(
          "usage: merklekv-server [--host H] [--port P] "
          "[--engine mem|log] [--storage-path DIR] [--io-threads N] "
          "[--partition PID/COUNT[/EPOCH]]\n");
      return 0;
    } else {
      std::fprintf(stderr, "unknown flag: %s\n", a.c_str());
      return 2;
    }
  }

  auto engine = mkv::make_engine(engine_kind, storage_path);
  mkv::ServerOptions opts;
  opts.host = host;
  opts.port = uint16_t(port);
  opts.exit_on_shutdown = true;
  opts.io_threads = io_threads < 0 ? 0 : size_t(io_threads);
  mkv::Server server(engine.get(), opts);
  if (part_count > 0) {
    server.set_partition(part_epoch, uint32_t(part_count),
                         uint32_t(part_id));
  }
  if (!server.start()) {
    std::fprintf(stderr, "failed to bind %s:%d\n", host.c_str(), port);
    return 1;
  }
  std::printf("merklekv-server listening on %s:%u (engine=%s)\n", host.c_str(),
              server.port(), engine_kind.c_str());
  std::fflush(stdout);
  server.wait();
  return 0;
}
