// A copy of merklekv_tpu/native/capi.cc, built by the port into build/native/.
// C ABI for the Python control plane (ctypes).
//
// The Python side (merklekv_tpu_torch/native_bindings.py) drives engines and the
// server through these handles; buffers returned through out-params are
// malloc'd here and released with mkv_free. Serialization formats are
// little-endian length-prefixed, documented per function.
#include <fcntl.h>
#include <unistd.h>

#include <csignal>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <vector>

#include "engine.h"
#include "events.h"
#include "merkle.h"
#include "server.h"

using mkv::Engine;
using mkv::Server;

namespace {

char* dup_buffer(const std::string& s) {
  char* p = static_cast<char*>(std::malloc(s.size() ? s.size() : 1));
  if (p && !s.empty()) std::memcpy(p, s.data(), s.size());
  return p;
}

void put_u32(std::string& out, uint32_t v) {
  out.append(reinterpret_cast<const char*>(&v), 4);
}
void put_u64(std::string& out, uint64_t v) {
  out.append(reinterpret_cast<const char*>(&v), 8);
}

struct ServerHandle {
  Server* server;
  // Keeps the ctypes callback trampoline alive via Python; C++ only stores
  // the raw pointer + context.
  void* cb_ctx = nullptr;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- memory

void mkv_free(void* p) { std::free(p); }

// ---------------------------------------------------------------- engine

void* mkv_engine_create(const char* kind, const char* path) {
  auto eng = mkv::make_engine(kind ? kind : "mem", path ? path : "");
  return eng.release();
}

void mkv_engine_destroy(void* h) { delete static_cast<Engine*>(h); }

// Returns 1 if found (out/out_len set; free with mkv_free), 0 otherwise.
int mkv_engine_get(void* h, const char* key, int klen, char** out,
                   int* out_len) {
  auto v = static_cast<Engine*>(h)->get(std::string(key, size_t(klen)));
  if (!v) return 0;
  *out = dup_buffer(*v);
  *out_len = int(v->size());
  return 1;
}

int mkv_engine_set(void* h, const char* key, int klen, const char* val,
                   int vlen) {
  return static_cast<Engine*>(h)->set(std::string(key, size_t(klen)),
                                      std::string(val, size_t(vlen)))
             ? 1
             : 0;
}

int mkv_engine_set_with_ts(void* h, const char* key, int klen,
                           const char* val, int vlen,
                           unsigned long long ts) {
  return static_cast<Engine*>(h)->set_with_ts(std::string(key, size_t(klen)),
                                              std::string(val, size_t(vlen)),
                                              uint64_t(ts))
             ? 1
             : 0;
}

// Returns 1 and writes the last-write unix-ns timestamp if present, else 0.
int mkv_engine_get_ts(void* h, const char* key, int klen,
                      unsigned long long* out_ts) {
  auto ts = static_cast<Engine*>(h)->get_ts(std::string(key, size_t(klen)));
  if (!ts) return 0;
  *out_ts = *ts;
  return 1;
}

// Atomic (value, last-write ts) read: returns 1 if present with out/out_len
// (free with mkv_free) and *out_ts filled, else 0.
int mkv_engine_get_with_ts(void* h, const char* key, int klen, char** out,
                           int* out_len, unsigned long long* out_ts) {
  auto vt =
      static_cast<Engine*>(h)->get_with_ts(std::string(key, size_t(klen)));
  if (!vt) return 0;
  *out = dup_buffer(vt->first);
  *out_len = int(vt->first.size());
  *out_ts = vt->second;
  return 1;
}

int mkv_engine_del(void* h, const char* key, int klen) {
  return static_cast<Engine*>(h)->del(std::string(key, size_t(klen))) ? 1 : 0;
}

int mkv_engine_del_with_ts(void* h, const char* key, int klen,
                           unsigned long long ts) {
  return static_cast<Engine*>(h)->del_with_ts(std::string(key, size_t(klen)),
                                              uint64_t(ts))
             ? 1
             : 0;
}

int mkv_engine_del_quiet(void* h, const char* key, int klen) {
  return static_cast<Engine*>(h)->del_quiet(std::string(key, size_t(klen)))
             ? 1
             : 0;
}

// LWW-conditional install/delete; returns 1 if the op applied.
int mkv_engine_set_if_newer(void* h, const char* key, int klen,
                            const char* val, int vlen,
                            unsigned long long ts) {
  return static_cast<Engine*>(h)->set_if_newer(std::string(key, size_t(klen)),
                                               std::string(val, size_t(vlen)),
                                               uint64_t(ts))
             ? 1
             : 0;
}

int mkv_engine_del_if_newer(void* h, const char* key, int klen,
                            unsigned long long ts) {
  return static_cast<Engine*>(h)->del_if_newer(std::string(key, size_t(klen)),
                                               uint64_t(ts))
             ? 1
             : 0;
}

// Batched LWW-conditional apply: one FFI crossing for a whole replication
// frame. Input buffer: u32 count, then per op u8 kind (0=SET 1=DEL),
// u64 ts, u32 klen, key, u32 vlen, value (vlen always present; 0 for DEL).
// Output: count bytes of applied flags (same index order), free with
// mkv_free. Returns the op count, or -1 on a malformed buffer.
int mkv_engine_apply_batch(void* h, const char* buf, long long buf_len,
                           char** out_flags) {
  const size_t len = buf_len < 0 ? 0 : size_t(buf_len);
  size_t off = 0;
  auto take = [&](void* dst, size_t n) {
    if (off + n > len) return false;
    std::memcpy(dst, buf + off, n);
    off += n;
    return true;
  };
  uint32_t count = 0;
  if (!take(&count, 4)) return -1;
  std::vector<mkv::BatchOp> ops;
  ops.reserve(count);
  for (uint32_t i = 0; i < count; ++i) {
    uint8_t kind;
    uint64_t ts;
    uint32_t klen, vlen;
    if (!take(&kind, 1) || !take(&ts, 8) || !take(&klen, 4)) return -1;
    if (off + klen > len) return -1;
    std::string key(buf + off, klen);
    off += klen;
    if (!take(&vlen, 4) || off + vlen > len) return -1;
    std::string value(buf + off, vlen);
    off += vlen;
    ops.push_back(mkv::BatchOp{kind == 1, ts, std::move(key),
                               std::move(value)});
  }
  auto flags = static_cast<Engine*>(h)->apply_batch(ops);
  char* p = static_cast<char*>(std::malloc(flags.size() ? flags.size() : 1));
  if (p && !flags.empty()) std::memcpy(p, flags.data(), flags.size());
  *out_flags = p;
  return int(flags.size());
}

// Returns 1 and fills *out_ts with the key's tombstone timestamp, else 0.
int mkv_engine_tombstone_ts(void* h, const char* key, int klen,
                            unsigned long long* out_ts) {
  auto ts =
      static_cast<Engine*>(h)->tombstone_ts(std::string(key, size_t(klen)));
  if (!ts) return 0;
  *out_ts = *ts;
  return 1;
}

// tombstones: u32 count, then per item u32 klen + key + u64 delete-ts,
// sorted by key. Free with mkv_free.
int mkv_engine_tombstones(void* h, const char* prefix, int plen, char** out,
                          int* out_len) {
  auto tombs =
      static_cast<Engine*>(h)->tombstones(std::string(prefix, size_t(plen)));
  std::string buf;
  put_u32(buf, uint32_t(tombs.size()));
  for (const auto& [k, ts] : tombs) {
    put_u32(buf, uint32_t(k.size()));
    buf += k;
    put_u64(buf, ts);
  }
  *out = dup_buffer(buf);
  *out_len = int(buf.size());
  return 1;
}

// key_timestamps: same wire shape as tombstones (u32 count, then u32 klen +
// key + u64 last-write-ts) over every LIVE key, shard order (unsorted).
// Free with mkv_free.
int mkv_engine_key_timestamps(void* h, char** out, int* out_len) {
  auto items = static_cast<Engine*>(h)->key_timestamps();
  std::string buf;
  put_u32(buf, uint32_t(items.size()));
  for (const auto& [k, ts] : items) {
    put_u32(buf, uint32_t(k.size()));
    buf += k;
    put_u64(buf, ts);
  }
  *out = dup_buffer(buf);
  *out_len = int(buf.size());
  return 1;
}

int mkv_engine_exists(void* h, const char* key, int klen) {
  return static_cast<Engine*>(h)->exists(std::string(key, size_t(klen))) ? 1
                                                                          : 0;
}

long long mkv_engine_dbsize(void* h) {
  return (long long)static_cast<Engine*>(h)->dbsize();
}

long long mkv_engine_memory_usage(void* h) {
  return (long long)static_cast<Engine*>(h)->memory_usage();
}

// Deletion records evicted by the bounded tombstone map (0 for engines
// without tombstones).
long long mkv_engine_tomb_evictions(void* h) {
  return (long long)static_cast<Engine*>(h)->tomb_evictions();
}

// Slab-account snapshot: out[0]=live bytes (reader-pinned included),
// out[1]=blocks, out[2]=pinned bytes (held only by in-flight responses),
// out[3]=lifetime allocs, out[4]=allocation failures (arena byte limit).
// Zeros for engines without block storage.
void mkv_engine_slab_stats(void* h, unsigned long long out[5]) {
  mkv::SlabStats st = static_cast<Engine*>(h)->slab_stats();
  out[0] = st.bytes;
  out[1] = st.blocks;
  out[2] = st.pinned_bytes;
  out[3] = st.allocs;
  out[4] = st.alloc_failures;
}

// Engine mutation version (bumped per write). For engines that do not
// track versions the base-class fallback increments per CALL — callers
// comparing versions across reads (mirror-staleness gauge) should only do
// so against the sharded/log engines, which track real mutation counts.
unsigned long long mkv_engine_version(void* h) {
  return (unsigned long long)static_cast<Engine*>(h)->version();
}

// 1 when a durable log refused to open because its on-disk format version
// is newer than this binary (engine runs empty, logging disabled).
int mkv_engine_log_version_refused(void* h) {
  auto* log = dynamic_cast<mkv::LogEngine*>(static_cast<Engine*>(h));
  return log && log->log_version_refused() ? 1 : 0;
}

int mkv_engine_truncate(void* h) {
  return static_cast<Engine*>(h)->truncate() ? 1 : 0;
}

// Log compaction: rewrites the durable log as a snapshot of live state.
// Returns 1 on success, 0 for engines without a log (mem) or on failure.
int mkv_engine_compact(void* h) {
  auto* log = dynamic_cast<mkv::LogEngine*>(static_cast<Engine*>(h));
  return log && log->compact() ? 1 : 0;
}

int mkv_engine_sync(void* h) {
  return static_cast<Engine*>(h)->sync() ? 1 : 0;
}

// increment/decrement: returns 1 on success with *out_value set; on error
// returns 0 and fills err/err_len (free with mkv_free).
int mkv_engine_increment(void* h, const char* key, int klen, long long amount,
                         long long* out_value, char** err, int* err_len) {
  auto r = static_cast<Engine*>(h)->increment(std::string(key, size_t(klen)),
                                              int64_t(amount));
  if (r.ok) {
    *out_value = r.value;
    return 1;
  }
  *err = dup_buffer(r.error);
  *err_len = int(r.error.size());
  return 0;
}

int mkv_engine_decrement(void* h, const char* key, int klen, long long amount,
                         long long* out_value, char** err, int* err_len) {
  auto r = static_cast<Engine*>(h)->decrement(std::string(key, size_t(klen)),
                                              int64_t(amount));
  if (r.ok) {
    *out_value = r.value;
    return 1;
  }
  *err = dup_buffer(r.error);
  *err_len = int(r.error.size());
  return 0;
}

// append/prepend: returns 1 with *out/*out_len = new value, else 0 with err.
int mkv_engine_append(void* h, const char* key, int klen, const char* val,
                      int vlen, char** out, int* out_len, char** err,
                      int* err_len) {
  auto r = static_cast<Engine*>(h)->append(std::string(key, size_t(klen)),
                                           std::string(val, size_t(vlen)));
  if (r.ok) {
    *out = dup_buffer(r.value);
    *out_len = int(r.value.size());
    return 1;
  }
  *err = dup_buffer(r.error);
  *err_len = int(r.error.size());
  return 0;
}

int mkv_engine_prepend(void* h, const char* key, int klen, const char* val,
                       int vlen, char** out, int* out_len, char** err,
                       int* err_len) {
  auto r = static_cast<Engine*>(h)->prepend(std::string(key, size_t(klen)),
                                            std::string(val, size_t(vlen)));
  if (r.ok) {
    *out = dup_buffer(r.value);
    *out_len = int(r.value.size());
    return 1;
  }
  *err = dup_buffer(r.error);
  *err_len = int(r.error.size());
  return 0;
}

// scan: newline-safe serialization — u32 count, then per key u32 len + bytes.
int mkv_engine_scan(void* h, const char* prefix, int plen, char** out,
                    int* out_len) {
  auto keys =
      static_cast<Engine*>(h)->scan(std::string(prefix, size_t(plen)));
  std::string buf;
  put_u32(buf, uint32_t(keys.size()));
  for (const auto& k : keys) {
    put_u32(buf, uint32_t(k.size()));
    buf += k;
  }
  *out = dup_buffer(buf);
  *out_len = int(buf.size());
  return 1;
}

// snapshot: u32 count, then per item u32 klen + key + u32 vlen + value,
// sorted by key. This is the TPU rebuild input.
int mkv_engine_snapshot(void* h, char** out, long long* out_len) {
  auto snap = static_cast<Engine*>(h)->snapshot();
  std::string buf;
  put_u32(buf, uint32_t(snap.size()));
  for (const auto& [k, v] : snap) {
    put_u32(buf, uint32_t(k.size()));
    buf += k;
    put_u32(buf, uint32_t(v.size()));
    buf += v;
  }
  char* p = static_cast<char*>(std::malloc(buf.size() ? buf.size() : 1));
  if (p && !buf.empty()) std::memcpy(p, buf.data(), buf.size());
  *out = p;
  *out_len = (long long)buf.size();
  return 1;
}

// Merkle root over the current snapshot, written to out32 (32 bytes).
// Returns 0 for an empty keyspace.
int mkv_engine_merkle_root(void* h, unsigned char* out32) {
  auto snap = static_cast<Engine*>(h)->snapshot();
  return mkv::merkle_root(std::move(snap), out32) ? 1 : 0;
}

// ---------------------------------------------------------------- server

// Cluster callback ABI: cb(ctx, line, out_buf, out_cap) -> response length
// written into out_buf, or <= 0 for "unhandled".
typedef int (*mkv_cluster_cb)(void* ctx, const char* line, char* out_buf,
                              int out_cap);

void* mkv_server_create(void* engine, const char* host, int port,
                        const char* version, int exit_on_shutdown) {
  mkv::ServerOptions opts;
  opts.host = host ? host : "127.0.0.1";
  opts.port = uint16_t(port);
  opts.version = version ? version : "0.1.0";
  opts.exit_on_shutdown = exit_on_shutdown != 0;
  auto* hs = new ServerHandle{
      new Server(static_cast<Engine*>(engine), std::move(opts))};
  return hs;
}

// I/O-plane shape, set BEFORE mkv_server_start (ignored after):
// io_threads 0 = hardware concurrency, 1 = single event loop; pipelined 0
// restores the per-response-write compat discipline (the bench's A/B
// baseline approximating the old thread-per-connection loop).
void mkv_server_configure_io(void* h, long long io_threads, int pipelined) {
  static_cast<ServerHandle*>(h)->server->configure_io(
      io_threads < 0 ? 0 : size_t(io_threads), pipelined != 0);
}

// Resolved worker-pool width (0 before start).
long long mkv_server_io_threads(void* h) {
  return (long long)static_cast<ServerHandle*>(h)->server->io_threads();
}

// SO_REUSEPORT accept sharding, set BEFORE mkv_server_start: -1 off
// (single accept loop), 0 auto (shard where the kernel supports it),
// 1 on (falls back with a stderr note where unsupported).
void mkv_server_configure_accept(void* h, int reuseport) {
  static_cast<ServerHandle*>(h)->server->configure_accept(reuseport);
}

// 1 once start() actually sharded the accept path (every io worker owns
// its own listener); 0 before start or on the single-loop fallback.
int mkv_server_reuseport(void* h) {
  return static_cast<ServerHandle*>(h)->server->reuseport_active() ? 1 : 0;
}

// Zero-copy serving A/B toggle (default on): off restores the copy-out-
// of-the-engine compat path — wire-identical, the bench baseline.
void mkv_server_set_zero_copy(void* h, int on) {
  static_cast<ServerHandle*>(h)->server->set_zero_copy(on != 0);
}

// Request-line byte cap, set BEFORE mkv_server_start (<= 0 keeps the
// 1 MiB default). A SET of a value near or past 1 MiB needs headroom.
void mkv_server_set_max_line(void* h, long long bytes) {
  if (bytes > 0) {
    static_cast<ServerHandle*>(h)->server->set_max_line(size_t(bytes));
  }
}

int mkv_server_start(void* h) {
  return static_cast<ServerHandle*>(h)->server->start() ? 1 : 0;
}

int mkv_server_port(void* h) {
  return static_cast<ServerHandle*>(h)->server->port();
}

int mkv_server_stopping(void* h) {
  return static_cast<ServerHandle*>(h)->server->stopping() ? 1 : 0;
}

void mkv_server_stop(void* h) {
  static_cast<ServerHandle*>(h)->server->stop();
}

void mkv_server_wait(void* h) {
  static_cast<ServerHandle*>(h)->server->wait();
}

void mkv_server_destroy(void* h) {
  auto* hs = static_cast<ServerHandle*>(h);
  hs->server->stop();
  hs->server->wait();
  delete hs->server;
  delete hs;
}

void mkv_server_set_cluster_cb(void* h, mkv_cluster_cb cb, void* ctx) {
  auto* hs = static_cast<ServerHandle*>(h);
  if (!cb) {
    hs->server->set_cluster_callback(nullptr);
    return;
  }
  hs->server->set_cluster_callback([cb, ctx](const std::string& line) {
    // Sized for the largest cluster responses: a SNAPCHUNK frame (up to
    // 256 KiB raw -> ~350 KiB compressed+base64 worst case) and a
    // max-frontier TREELEVEL run; allocated per callback call, off the
    // data hot path.
    std::vector<char> buf(512 * 1024);
    int n = cb(ctx, line.c_str(), buf.data(), int(buf.size()));
    if (n <= 0) return std::string();
    return std::string(buf.data(), size_t(std::min(n, int(buf.size()))));
  });
}

void mkv_server_enable_events(void* h, int on) {
  static_cast<ServerHandle*>(h)->server->set_events_enabled(on != 0);
}

// Command-latency histogram toggle (on by default); the off switch lets
// bench.py A/B-measure the metrics plane's hot-path overhead.
void mkv_server_enable_latency(void* h, int on) {
  static_cast<ServerHandle*>(h)->server->set_latency_enabled(on != 0);
}

// Bootstrap read gate: while off, data-plane reads and anti-entropy
// serving verbs answer "ERROR LOADING ..." (see Server::set_serving).
void mkv_server_set_serving(void* h, int on) {
  static_cast<ServerHandle*>(h)->server->set_serving(on != 0);
}

int mkv_server_serving(void* h) {
  return static_cast<ServerHandle*>(h)->server->serving() ? 1 : 0;
}

// Drain up to max_events change events. Serialization per event: u8 op,
// u8 has_value, u64 ts_ns, u64 seq, u32 klen, key, u32 vlen, value; prefixed
// with u32 count. Free with mkv_free.
int mkv_server_drain_events(void* h, int max_events, char** out,
                            long long* out_len) {
  auto evs = static_cast<ServerHandle*>(h)->server->events().drain(
      max_events < 0 ? 0 : size_t(max_events));
  std::string buf;
  put_u32(buf, uint32_t(evs.size()));
  for (const auto& e : evs) {
    buf.push_back(char(uint8_t(e.op)));
    buf.push_back(char(e.has_value ? 1 : 0));
    put_u64(buf, e.ts_ns);
    put_u64(buf, e.seq);
    put_u32(buf, uint32_t(e.key.size()));
    buf += e.key;
    put_u32(buf, uint32_t(e.value.size()));
    buf += e.value;
  }
  char* p = static_cast<char*>(std::malloc(buf.size() ? buf.size() : 1));
  if (p && !buf.empty()) std::memcpy(p, buf.data(), buf.size());
  *out = p;
  *out_len = (long long)buf.size();
  return 1;
}

long long mkv_server_events_dropped(void* h) {
  return (long long)static_cast<ServerHandle*>(h)->server->events().dropped();
}

// Park until the event queue is non-empty (or timeout_ms). Returns 1 when
// events are pending — the drain thread's event-driven wait.
int mkv_server_wait_events(void* h, int timeout_ms) {
  return static_cast<ServerHandle*>(h)->server->events().wait_nonempty(
             timeout_ms)
             ? 1
             : 0;
}

// Stats text exactly as the STATS command body (for the control plane):
// the counter block plus the server-scope extension lines (event-queue
// depth/drops, tombstone evictions, degradation level + shed counters).
int mkv_server_stats(void* h, char** out, int* out_len) {
  std::string s = static_cast<ServerHandle*>(h)->server->stats_text();
  *out = dup_buffer(s);
  *out_len = int(s.size());
  return 1;
}

// Admission-control limits: max_connections (0 = unlimited; excess accepts
// answered "ERROR BUSY connections" and closed) and max_pipeline (one
// connection's in-flight pipelined-command budget; 0 = unlimited).
void mkv_server_set_limits(void* h, long long max_connections,
                           long long max_pipeline) {
  static_cast<ServerHandle*>(h)->server->set_limits(
      max_connections < 0 ? 0 : size_t(max_connections),
      max_pipeline < 0 ? 0 : size_t(max_pipeline));
}

// Degradation ladder (overload protection): level 0=live 1=shedding
// 2=read_only 3=draining; reason 0=none 1=memory 2=disk 3=draining
// 4=admin. The control plane folds the watermark signals and pushes the
// result here; the server enforces it on write verbs (BUSY/READONLY) and,
// at draining, on new connections.
void mkv_server_set_degradation(void* h, int level, int reason) {
  if (level < 0) level = 0;
  if (level > 3) level = 3;
  static_cast<ServerHandle*>(h)->server->set_degradation(
      mkv::Degradation(level), mkv::DegradeReason(reason));
}

int mkv_server_degradation(void* h) {
  return static_cast<ServerHandle*>(h)->server->degradation();
}

// Partitioned cluster mode: this node owns partition `owned` of `count`
// (map generation `epoch`). While count > 0, data verbs whose keys hash
// to a foreign partition — and HASH/TREELEVEL requests addressed pt= to
// one — answer the retryable "ERROR MOVED <pid> <epoch>". count 0 turns
// the guard off (unpartitioned default).
void mkv_server_set_partition(void* h, unsigned long long epoch,
                              long long count, long long owned) {
  if (count < 0) count = 0;
  if (owned < 0) owned = 0;
  static_cast<ServerHandle*>(h)->server->set_partition(
      epoch, uint32_t(count), uint32_t(owned));
}

// Split-map generalization (live rebalancing): install the full split-tree
// ownership table — partition p owns (roots[p], depths[p], paths[p]) under
// hash base `base` (cluster/partmap.py is the authoritative spec). A
// boot-shaped table (base == count, assignment i == (i,0,0)) collapses to
// the legacy modulo guard. The three arrays must each hold `count` entries.
void mkv_server_set_partition_map(void* h, unsigned long long epoch,
                                  long long base, long long count,
                                  long long owned, const unsigned int* roots,
                                  const unsigned int* depths,
                                  const unsigned long long* paths) {
  if (count < 0) count = 0;
  if (owned < 0) owned = 0;
  if (base < 0) base = 0;
  std::vector<mkv::PartAssignment> assigns;
  assigns.reserve(size_t(count));
  for (long long i = 0; i < count; ++i) {
    assigns.push_back(mkv::PartAssignment{uint32_t(roots[i]),
                                          uint32_t(depths[i]),
                                          uint64_t(paths[i])});
  }
  static_cast<ServerHandle*>(h)->server->set_partition_map(
      epoch, uint32_t(base), uint32_t(count), uint32_t(owned),
      std::move(assigns));
}

// Rebalance write fence: writes whose key falls inside the split-tree cell
// (root, depth, path) under `base` answer the retryable "ERROR BUSY
// rebalance retry" until the fence clears. Reads keep serving.
void mkv_server_set_partition_fence(void* h, long long base, long long root,
                                    long long depth,
                                    unsigned long long path) {
  static_cast<ServerHandle*>(h)->server->set_partition_fence(
      uint32_t(base < 0 ? 0 : base), uint32_t(root < 0 ? 0 : root),
      uint32_t(depth < 0 ? 0 : depth), uint64_t(path));
}

void mkv_server_clear_partition_fence(void* h) {
  static_cast<ServerHandle*>(h)->server->clear_partition_fence();
}

// Change-event queue depth (staged-but-undrained events) — the
// replication/WAL feed's backlog gauge.
long long mkv_server_events_depth(void* h) {
  return (long long)static_cast<ServerHandle*>(h)->server->events().size();
}

// Slow-command log threshold in microseconds (0 = off). Dispatches at or
// past it are recorded in the native flight log (FLIGHT fallback) and
// relayed to the control plane as SLOWCMD notifications.
void mkv_server_set_slow_threshold(void* h, long long us) {
  static_cast<ServerHandle*>(h)->server->set_slow_threshold_us(
      us < 0 ? 0 : uint64_t(us));
}

}  // extern "C"

// ------------------------------------------------------- crash marker
//
// Fatal-signal black-box stamp: a SIGSEGV/SIGABRT/SIGBUS appends ONE
// line — "fatal signal <n> pid <p> wall_ns <t>" — to a pre-registered
// file using only async-signal-safe calls (open/write/close, manual
// decimal formatting), then restores the previously installed handler
// (Python's faulthandler, when the control plane armed it first) and
// re-raises, so traceback dumping and the default death both still
// happen. The periodic flight spill holds the rich history; this marker
// records WHAT killed the process and WHEN, which the spill — last
// rewritten up to a spill interval earlier — cannot.

namespace {

char g_crash_path[512] = {0};
struct sigaction g_crash_prev[32];
const int g_crash_sigs[] = {SIGSEGV, SIGABRT, SIGBUS, SIGFPE};

void crash_put_u64(char* buf, size_t cap, size_t* n, unsigned long long v) {
  char tmp[24];
  int i = 0;
  if (v == 0) tmp[i++] = '0';
  while (v && i < int(sizeof(tmp))) {
    tmp[i++] = char('0' + v % 10);
    v /= 10;
  }
  while (i > 0 && *n < cap - 1) buf[(*n)++] = tmp[--i];
}

void crash_put_str(char* buf, size_t cap, size_t* n, const char* s) {
  while (*s && *n < cap - 1) buf[(*n)++] = *s++;
}

void crash_marker_handler(int sig) {
  int fd = ::open(g_crash_path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd >= 0) {
    char buf[160];
    size_t n = 0;
    struct timespec ts {};
    ::clock_gettime(CLOCK_REALTIME, &ts);
    crash_put_str(buf, sizeof(buf), &n, "fatal signal ");
    crash_put_u64(buf, sizeof(buf), &n, (unsigned long long)sig);
    crash_put_str(buf, sizeof(buf), &n, " pid ");
    crash_put_u64(buf, sizeof(buf), &n, (unsigned long long)::getpid());
    crash_put_str(buf, sizeof(buf), &n, " wall_ns ");
    crash_put_u64(buf, sizeof(buf), &n,
                  (unsigned long long)ts.tv_sec * 1000000000ull +
                      (unsigned long long)ts.tv_nsec);
    crash_put_str(buf, sizeof(buf), &n, "\n");
    ssize_t w = ::write(fd, buf, n);
    (void)w;
    ::close(fd);
  }
  // Chain: restore whatever handler was installed before ours (Python's
  // faulthandler dumps tracebacks, else the default disposition kills the
  // process) and re-deliver.
  if (sig >= 0 && sig < int(sizeof(g_crash_prev) / sizeof(g_crash_prev[0]))) {
    ::sigaction(sig, &g_crash_prev[sig], nullptr);
  }
  ::raise(sig);
}

}  // namespace

extern "C" {

// Register the crash-marker path and install the fatal-signal handlers.
// Call AFTER faulthandler.enable() so the marker chains into it. Empty
// path is a no-op; calling again just updates the path.
void mkv_install_crash_marker(const char* path) {
  if (!path || !*path) return;
  bool installed = g_crash_path[0] != 0;
  std::snprintf(g_crash_path, sizeof(g_crash_path), "%s", path);
  if (installed) return;
  struct sigaction sa {};
  sa.sa_handler = crash_marker_handler;
  // SA_ONSTACK: faulthandler (installed first) registered an alternate
  // signal stack; running the marker on it keeps stack-overflow SIGSEGVs
  // — a death class the black box exists for — deliverable. Without it
  // the kernel cannot push a frame onto the exhausted stack and forces
  // the default disposition: no marker, no chained traceback.
  sa.sa_flags = SA_ONSTACK;
  sigemptyset(&sa.sa_mask);
  for (int sig : g_crash_sigs) {
    ::sigaction(sig, &sa, &g_crash_prev[sig]);
  }
}

}  // extern "C"
