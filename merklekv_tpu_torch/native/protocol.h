// A copy of merklekv_tpu/native/protocol.h, built by the port into build/native/.
// Text protocol: one CRLF-terminated line -> Command.
//
// Reproduces the reference parser's grammar, validation rules, and error
// messages exactly (the reference's src/protocol.rs:237-774): case-insensitive
// verbs; tabs forbidden in commands/keys but allowed in values; newlines
// forbidden everywhere inside a line; SET/APPEND/PREPEND split on the first
// two spaces so values may contain spaces; EXISTS/MGET/MSET/INC/DEC split on
// whitespace runs.
#pragma once

#include <cstdint>
#include <optional>
#include <string>
#include <utility>
#include <vector>

namespace mkv {

enum class Verb {
  Get, Set, Delete, Increment, Decrement, Append, Prepend,
  MultiGet, MultiSet, Truncate, Exists, Scan, Dbsize, Hash,
  LeafHashes, Stats, Info, Version, Memory, ClientList, Flushdb, Shutdown,
  Ping, Echo, Sync, Replicate,
  // Cursor-paged LEAFHASHES: "HASHPAGE <count> [<after> [<upto>]]" emits up
  // to <count> merged (live + tombstone) hash lines for keys strictly after
  // the cursor, in sorted order — the unit of resumable anti-entropy. The
  // optional exclusive upper bound <upto> makes the page range-bounded: the
  // bisection walk fetches leaf hashes for ONE divergent key range without
  // the server selecting (or shipping) anything past the boundary.
  HashPage,
  // Subtree-bisection anti-entropy: "TREELEVEL <level> <lo> <hi>" serves
  // interior digests [lo, hi) of the reference (odd-promotion) Merkle tree
  // at `level` (0 = leaves), plus the live leaf count — so a peer can walk
  // the tree top-down and descend only into divergent subtrees.
  TreeLevel,
  // Extension (like LEAFHASHES): per-peer health table from the cluster
  // control plane's failure detector.
  Peers,
  Metrics,
  // Extension: "TRACE [n]" dumps the newest n anti-entropy cycles from the
  // control plane's correlated-trace ring buffer (per-peer bytes/rounds/
  // repairs/outcome per cycle). Without a cluster plane: "TRACES 0" + END.
  Trace,
  // Snapshot shipping (node bootstrap): "SNAPMETA" advertises the donor's
  // newest Merkle-stamped snapshot (seq, wal_seq, byte size, stamped root);
  // "SNAPCHUNK <seq> <offset> <count>" streams a CRC-framed byte range of
  // that snapshot file. Both delegate to the cluster control plane; a node
  // without durable storage answers ERROR — the capability-fallback signal
  // (same discipline as TREELEVEL) that degrades a joiner to the plain
  // anti-entropy walk.
  SnapMeta,
  SnapChunk,
  // Extension: "TRACEDUMP [n]" dumps raw causal-trace spans (the cross-node
  // complement of TRACE's per-cycle summaries) from the control plane's
  // span collector; obs/tracewire.py assembles initiator+donor dumps into
  // one Chrome trace-event JSON. Without a cluster plane: "SPANS 0" + END.
  TraceDump,
  // Extension: "PROFILE <secs>" starts a bounded jax.profiler device-trace
  // capture in the control plane (rebuild/diff/scatter programs land in the
  // capture); answers the capture directory immediately, the capture stops
  // itself after <secs>. Without a cluster plane (or without jax): ERROR.
  Profile,
  // Extension: "FLIGHT [n]" streams the newest n flight-recorder events
  // (state transitions + slow commands) as k=v rows — the live view of the
  // always-on black box (obs/flightrec.py). The control plane serves its
  // full event ring; a bare native node falls back to its own slow-command
  // log. Stays open through LOADING and every degradation rung: forensics
  // must work exactly when the node is sick.
  Flight,
  // Partitioned cluster mode: "PARTMAP" dumps the versioned partition map
  // this node holds (epoch, partition count, replica set per partition) —
  // the routing table smart clients and the thin router bootstrap from.
  // Served by the cluster control plane; a node without one answers ERROR
  // (the capability signal that the deployment is not partitioned).
  PartMap,
  // Live resharding control plane: "REBALANCE <subcommand> [...]" (SPLIT/
  // JOIN/FORWARD/FENCE/COMMIT/ABORT/STATUS) is relayed verbatim to the
  // cluster control plane, where the rebalance state machine lives
  // (cluster/rebalance.py). The raw argument tail rides in cmd.message —
  // the native layer validates nothing past the verb, exactly like the
  // other control-plane relays, so the wire grammar can evolve without a
  // native rebuild. A node without a cluster plane answers ERROR.
  Rebalance,
};

enum class ReplicateAction { Enable, Disable, Status };

struct Command {
  Verb verb{};
  std::string key;                 // Get/Set/Delete/Inc/Dec/Append/Prepend
  std::string value;               // Set/Append/Prepend
  std::optional<int64_t> amount;   // Inc/Dec; HashPage page size
  std::vector<std::string> keys;   // Exists/MultiGet
  std::vector<std::pair<std::string, std::string>> pairs;  // MultiSet
  std::string message;             // Ping/Echo
  std::string prefix;              // Scan / LeafHashes; HashPage after-cursor
  std::optional<std::string> upto;     // HashPage exclusive upper bound
  int64_t level = 0, lo = 0, hi = 0;   // TreeLevel
  int64_t snap_seq = 0, snap_off = 0, snap_cnt = 0;  // SnapChunk
  std::optional<std::string> pattern;  // Hash
  // Causal trace context: the optional trailing "tc=<trace>-<span>-<flags>"
  // token on cluster verbs (TREELEVEL/HASHPAGE/SNAPMETA/SNAPCHUNK). The
  // server relays it (with the serving wall time) to the control plane as a
  // TRACESPAN notification so the donor's spans stitch into the
  // initiator's trace; empty = untraced request. Strictly-formatted so a
  // real key can never be mistaken for it (see is_trace_token).
  std::string trace;
  // Version-stamp request: the optional trailing "vs=<2 hex flags>" token
  // on the tree-serving verbs (HASH/TREELEVEL/LEAFHASHES/HASHPAGE),
  // stripped BEFORE arity checks like the trace token. Bit 0 (want_version)
  // asks the reply header to carry the engine mutation version the served
  // tree reflects (plus its lag for snapshot-serving verbs); bit 1
  // (force_refresh) asks the server to refresh the tree to the live engine
  // before answering — the anti-entropy escalation / snapshot-exactness
  // escape hatch. Old servers reject the extra token with an arity ERROR
  // (fail closed); clients drop it per connection and retry plain.
  bool want_version = false;
  bool force_refresh = false;
  // Partition address: the optional trailing "pt=<pid>" token on the
  // tree-serving verbs HASH and TREELEVEL (stripped before arity checks,
  // after the vs=/tc= tokens). A partitioned node whose owned partition
  // differs answers "ERROR MOVED <pid> <epoch>" instead of silently
  // serving a DIFFERENT partition's tree into the caller's anti-entropy
  // walk — the stale-map safety check for partition-scoped root reads.
  // -1 = unaddressed (the legacy whole-node form).
  int64_t partition = -1;
  std::string host;                // Sync
  uint16_t port = 0;               // Sync
  bool full = false, verify = false;  // Sync flags (parsed, ignored — parity)
  ReplicateAction action{};        // Replicate
};

struct ParseResult {
  bool ok = false;
  Command cmd;
  std::string error;
};

// `line` is the raw request line (trailing \r\n included or not — it is
// trimmed here, like the reference's input.trim()).
ParseResult parse_command(const std::string& line);

// True iff `tok` is a well-formed trace-context token:
// "tc=" + 16 hex (trace id) + "-" + 16 hex (span id) + "-" + 2 hex (flags).
// The fixed shape is what lets it ride as a trailing argument on verbs
// whose other arguments are keys without ambiguity.
bool is_trace_token(const std::string& tok);

// True iff `tok` is a well-formed version-stamp token: "vs=" + exactly 2
// hex flag digits. Same trailing-token discipline as the trace token; the
// fixed 5-char shape keeps collision with real keys/cursors negligible
// (and the verbs where a collision would be silent require a settled
// capability first — docs/PROTOCOL.md "Version-stamped tree answers").
bool is_version_token(const std::string& tok);

// True iff `tok` is a well-formed partition-address token: "pt=" + 1..10
// decimal digits. Same trailing-token discipline; only parsed on verbs
// with fixed arity (TREELEVEL) or a response shape that exposes the miss
// (bare HASH echoes an unparsed token back as a pattern), so an old peer
// can never silently misread it.
bool is_partition_token(const std::string& tok);

}  // namespace mkv
