// A copy of merklekv_tpu/native/protocol.cc, built by the port into build/native/.
#include "protocol.h"

#include <algorithm>
#include <cctype>

namespace mkv {

namespace {

std::string trim(const std::string& s) {
  size_t b = 0, e = s.size();
  while (b < e && std::isspace(uint8_t(s[b]))) ++b;
  while (e > b && std::isspace(uint8_t(s[e - 1]))) --e;
  return s.substr(b, e - b);
}

std::string upper(const std::string& s) {
  std::string out = s;
  std::transform(out.begin(), out.end(), out.begin(),
                 [](uint8_t c) { return char(std::toupper(c)); });
  return out;
}

std::string lower(const std::string& s) {
  std::string out = s;
  std::transform(out.begin(), out.end(), out.begin(),
                 [](uint8_t c) { return char(std::tolower(c)); });
  return out;
}

bool has_tab(const std::string& s) { return s.find('\t') != std::string::npos; }
bool has_nl(const std::string& s) { return s.find('\n') != std::string::npos; }

std::vector<std::string> split_ws(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && std::isspace(uint8_t(s[i]))) ++i;
    size_t j = i;
    while (j < s.size() && !std::isspace(uint8_t(s[j]))) ++j;
    if (j > i) out.push_back(s.substr(i, j - i));
    i = j;
  }
  return out;
}

bool parse_i64_str(const std::string& s, int64_t* out) {
  if (s.empty()) return false;
  size_t i = 0;
  bool neg = false;
  if (s[0] == '+' || s[0] == '-') {
    neg = s[0] == '-';
    i = 1;
    if (s.size() == 1) return false;
  }
  uint64_t acc = 0;
  const uint64_t limit = neg ? (uint64_t(1) << 63) : (uint64_t(1) << 63) - 1;
  for (; i < s.size(); ++i) {
    if (s[i] < '0' || s[i] > '9') return false;
    uint64_t d = uint64_t(s[i] - '0');
    if (acc > (limit - d) / 10) return false;
    acc = acc * 10 + d;
  }
  *out = neg ? -int64_t(acc) : int64_t(acc);
  return true;
}

ParseResult err(std::string msg) {
  ParseResult r;
  r.error = std::move(msg);
  return r;
}

ParseResult ok(Command c) {
  ParseResult r;
  r.ok = true;
  r.cmd = std::move(c);
  return r;
}

// Checks shared by key-bearing commands; `what` is "key", "prefix", ...
std::optional<std::string> bad_char(const std::string& s,
                                    const std::string& what) {
  if (has_tab(s)) {
    return "Invalid character: tab character not allowed in " + what;
  }
  if (has_nl(s)) {
    return "Invalid character: newline character not allowed in " + what;
  }
  return std::nullopt;
}

// SET/APPEND/PREPEND-style "<key> <value>" split on the FIRST space only.
ParseResult parse_key_value(Verb verb, const std::string& name,
                            const std::string& rest) {
  size_t sp = rest.find(' ');
  if (sp == std::string::npos) {
    return err(name + " command requires a key and value");
  }
  std::string key = rest.substr(0, sp);
  std::string value = rest.substr(sp + 1);
  if (key.empty()) return err(name + " command key cannot be empty");
  if (auto e = bad_char(key, "key")) return err(*e);
  if (has_nl(value)) {
    return err("Invalid character: newline character not allowed in value");
  }
  Command c;
  c.verb = verb;
  c.key = std::move(key);
  c.value = std::move(value);
  return ok(std::move(c));
}

// GET/DELETE-style single-key commands.
ParseResult parse_one_key(Verb verb, const std::string& name,
                          const std::string& rest, const char* requires_what) {
  if (rest.empty()) return err(name + " command requires a " + requires_what);
  if (rest.find(' ') != std::string::npos) {
    return err(name + " command accepts only one argument");
  }
  if (auto e = bad_char(rest, "key")) return err(*e);
  Command c;
  c.verb = verb;
  c.key = rest;
  return ok(std::move(c));
}

// INC/DEC: "<key> [amount]" split on whitespace.
ParseResult parse_numeric(Verb verb, const std::string& name,
                          const std::string& rest) {
  if (rest.empty()) return err(name + " command requires a key");
  auto parts = split_ws(rest);
  int64_t probe;
  if (parts.size() == 1 && parse_i64_str(parts[0], &probe)) {
    return err(name + " command requires a key");
  }
  if (auto e = bad_char(parts[0], "key")) return err(*e);
  Command c;
  c.verb = verb;
  c.key = parts[0];
  if (parts.size() > 1) {
    int64_t amt;
    if (!parse_i64_str(parts[1], &amt)) {
      return err(name + " command amount must be a valid number");
    }
    c.amount = amt;
  }
  return ok(std::move(c));
}

// If the last whitespace token of `toks` is a trace-context token, pop it
// and return it; otherwise return "". Callers run this BEFORE arity checks
// so a traced request parses exactly like its untraced form.
std::string take_trace_token(std::vector<std::string>* toks) {
  if (toks->empty() || !is_trace_token(toks->back())) return "";
  std::string t = std::move(toks->back());
  toks->pop_back();
  return t;
}

// If the last token is a version-stamp token ("vs=" + 2 hex flags), pop it
// and return its flags; -1 when absent. Clients append it BEFORE the trace
// token, so callers strip the trace token first, then this.
int take_version_flags(std::vector<std::string>* toks) {
  if (toks->empty() || !is_version_token(toks->back())) return -1;
  const std::string& t = toks->back();
  auto hexval = [](char c) -> int {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    return c - 'A' + 10;
  };
  int flags = hexval(t[3]) * 16 + hexval(t[4]);
  toks->pop_back();
  return flags;
}

void apply_version_flags(Command* c, int flags) {
  if (flags < 0) return;
  c->want_version = (flags & 1) != 0;
  c->force_refresh = (flags & 2) != 0;
}

// If the last token is a partition-address token ("pt=" + decimal pid),
// pop it and return the pid; -1 when absent. Clients append it BEFORE the
// vs=/tc= tokens, so callers strip those first, then this.
int64_t take_partition_token(std::vector<std::string>* toks) {
  if (toks->empty() || !is_partition_token(toks->back())) return -1;
  int64_t pid = 0;
  const std::string& t = toks->back();
  for (size_t i = 3; i < t.size(); ++i) pid = pid * 10 + (t[i] - '0');
  toks->pop_back();
  return pid;
}

}  // namespace

bool is_trace_token(const std::string& tok) {
  // "tc=" + 16 hex + "-" + 16 hex + "-" + 2 hex  (= 3 + 16 + 1 + 16 + 1 + 2)
  if (tok.size() != 39 || tok.compare(0, 3, "tc=") != 0) return false;
  auto hex = [&](size_t b, size_t n) {
    for (size_t i = b; i < b + n; ++i) {
      if (!std::isxdigit(uint8_t(tok[i]))) return false;
    }
    return true;
  };
  return hex(3, 16) && tok[19] == '-' && hex(20, 16) && tok[36] == '-' &&
         hex(37, 2);
}

bool is_version_token(const std::string& tok) {
  // "vs=" + exactly 2 hex flag digits.
  return tok.size() == 5 && tok.compare(0, 3, "vs=") == 0 &&
         std::isxdigit(uint8_t(tok[3])) && std::isxdigit(uint8_t(tok[4]));
}

bool is_partition_token(const std::string& tok) {
  // "pt=" + 1..10 decimal digits (enough for any 32-bit partition id).
  if (tok.size() < 4 || tok.size() > 13 || tok.compare(0, 3, "pt=") != 0) {
    return false;
  }
  for (size_t i = 3; i < tok.size(); ++i) {
    if (tok[i] < '0' || tok[i] > '9') return false;
  }
  return true;
}

ParseResult parse_command(const std::string& line) {
  std::string input = trim(line);
  if (input.empty()) return err("Empty command");

  size_t first_space = input.find(' ');
  if (first_space == std::string::npos) {
    // Single-word command.
    if (has_tab(input)) {
      return err("Invalid character: tab character not allowed in command");
    }
    if (has_nl(input)) {
      return err("Invalid character: newline character not allowed in command");
    }
    std::string u = upper(input);
    Command c;
    if (u == "GET" || u == "SET" || u == "DELETE" || u == "DEL" ||
        u == "ECHO" || u == "EXISTS" || u == "SYNC" || u == "REPLICATE" ||
        u == "HASHPAGE" || u == "TREELEVEL" || u == "SNAPCHUNK") {
      return err(u + " command requires arguments");
    }
    if (u == "TRUNCATE") { c.verb = Verb::Truncate; return ok(std::move(c)); }
    if (u == "STATS") { c.verb = Verb::Stats; return ok(std::move(c)); }
    if (u == "INFO") { c.verb = Verb::Info; return ok(std::move(c)); }
    if (u == "VERSION") { c.verb = Verb::Version; return ok(std::move(c)); }
    if (u == "FLUSHDB") { c.verb = Verb::Flushdb; return ok(std::move(c)); }
    if (u == "MEMORY") { c.verb = Verb::Memory; return ok(std::move(c)); }
    if (u == "SCAN") { c.verb = Verb::Scan; return ok(std::move(c)); }
    if (u == "HASH") { c.verb = Verb::Hash; return ok(std::move(c)); }
    if (u == "LEAFHASHES") { c.verb = Verb::LeafHashes; return ok(std::move(c)); }
    if (u == "PEERS") { c.verb = Verb::Peers; return ok(std::move(c)); }
    if (u == "PARTMAP") { c.verb = Verb::PartMap; return ok(std::move(c)); }
    if (u == "SNAPMETA") { c.verb = Verb::SnapMeta; return ok(std::move(c)); }
    if (u == "METRICS") { c.verb = Verb::Metrics; return ok(std::move(c)); }
    if (u == "TRACEDUMP") {
      c.verb = Verb::TraceDump;
      c.amount = 0;  // bare TRACEDUMP: every span still in the collector
      return ok(std::move(c));
    }
    if (u == "PROFILE") {
      return err("PROFILE requires a positive duration in seconds");
    }
    if (u == "REBALANCE") {
      return err("REBALANCE command requires a subcommand");
    }
    if (u == "TRACE") {
      c.verb = Verb::Trace;
      c.amount = 8;  // bare TRACE: a useful default window
      return ok(std::move(c));
    }
    if (u == "FLIGHT") {
      c.verb = Verb::Flight;
      c.amount = 64;  // bare FLIGHT: a useful default window
      return ok(std::move(c));
    }
    if (u == "CLIENT") { c.verb = Verb::ClientList; return ok(std::move(c)); }
    if (u == "PING") { c.verb = Verb::Ping; return ok(std::move(c)); }
    if (u == "SHUTDOWN") { c.verb = Verb::Shutdown; return ok(std::move(c)); }
    if (u == "DBSIZE") { c.verb = Verb::Dbsize; return ok(std::move(c)); }
    return err("Unknown command: " + input);
  }

  std::string command = input.substr(0, first_space);
  std::string rest = input.substr(first_space + 1);
  if (has_tab(command)) {
    return err("Invalid character: tab character not allowed in command");
  }
  if (has_nl(command)) {
    return err("Invalid character: newline character not allowed in command");
  }
  std::string u = upper(command);

  if (u == "GET") return parse_one_key(Verb::Get, "GET", rest, "key");
  if (u == "SET") return parse_key_value(Verb::Set, "SET", rest);
  if (u == "DEL" || u == "DELETE") {
    return parse_one_key(Verb::Delete, "DELETE", rest, "key");
  }
  if (u == "DBSIZE") {
    if (!rest.empty()) {
      return err("DBSIZE command does not accept any arguments");
    }
    Command c;
    c.verb = Verb::Dbsize;
    return ok(std::move(c));
  }
  if (u == "REBALANCE") {
    // Control-plane relay: the subcommand tail is opaque here (the
    // Python state machine parses it); only the character rules apply.
    if (auto e = bad_char(rest, "subcommand")) return err(*e);
    Command c;
    c.verb = Verb::Rebalance;
    c.message = rest;
    return ok(std::move(c));
  }
  if (u == "PING" || u == "ECHO") {
    if (u == "ECHO" && rest.empty()) {
      return err("ECHO command requires a message");
    }
    if (auto e = bad_char(rest, "message")) return err(*e);
    Command c;
    c.verb = u == "PING" ? Verb::Ping : Verb::Echo;
    c.message = rest;
    return ok(std::move(c));
  }
  if (u == "EXISTS" || u == "MGET") {
    const std::string name = u == "EXISTS" ? "EXISTS" : "MGET";
    if (rest.empty()) {
      return err(name + " command requires at least one key");
    }
    auto keys = split_ws(rest);
    if (keys.empty()) {
      return err(name + " command requires at least one key");
    }
    for (const auto& k : keys) {
      if (auto e = bad_char(k, "key")) return err(*e);
    }
    Command c;
    c.verb = u == "EXISTS" ? Verb::Exists : Verb::MultiGet;
    c.keys = std::move(keys);
    return ok(std::move(c));
  }
  if (u == "SYNC") {
    if (rest.empty()) {
      return err("SYNC requires arguments: <host> <port> [--full] [--verify]");
    }
    auto toks = split_ws(rest);
    size_t i = 0;
    if (i >= toks.size()) {
      return err("SYNC requires <host> as the first argument");
    }
    std::string host = toks[i++];
    if (has_tab(host) || has_nl(host)) {
      return err("Invalid character in host: tabs/newlines are not allowed");
    }
    if (i >= toks.size()) {
      return err("SYNC requires <port> as the second argument");
    }
    const std::string& port_str = toks[i++];
    int64_t port64;
    if (!parse_i64_str(port_str, &port64) || port64 < 0 || port64 > 65535) {
      return err("Invalid port: must be an integer in 0..=65535");
    }
    bool full = false, verify = false;
    for (; i < toks.size(); ++i) {
      const std::string& t = toks[i];
      if (t == "--full") {
        if (full) return err("Duplicate option: --full");
        full = true;
      } else if (t == "--verify") {
        if (verify) return err("Duplicate option: --verify");
        verify = true;
      } else {
        return err("Unknown option: " + t);
      }
    }
    Command c;
    c.verb = Verb::Sync;
    c.host = std::move(host);
    c.port = uint16_t(port64);
    c.full = full;
    c.verify = verify;
    return ok(std::move(c));
  }
  if (u == "HASH") {
    // Optional trailing version-stamp token ("HASH [pattern] [vs=XX]"):
    // stamping is meaningful on the bare whole-keyspace form (the root
    // anti-entropy compares); the pattern form keeps its legacy shape.
    auto toks = split_ws(rest);
    int vflags = take_version_flags(&toks);
    int64_t pid = take_partition_token(&toks);
    if (toks.size() > 1) {
      return err("HASH command accepts only one argument");
    }
    if (!toks.empty()) {
      if (auto e = bad_char(toks[0], "key")) return err(*e);
    }
    Command c;
    c.verb = Verb::Hash;
    c.pattern = toks.empty() ? "" : toks[0];
    c.partition = pid;
    apply_version_flags(&c, vflags);
    return ok(std::move(c));
  }
  if (u == "REPLICATE") {
    std::string arg = trim(rest);
    if (arg.empty()) {
      return err("REPLICATE requires one of: enable|disable|status");
    }
    std::string a = lower(arg);
    Command c;
    c.verb = Verb::Replicate;
    if (a == "enable") c.action = ReplicateAction::Enable;
    else if (a == "disable") c.action = ReplicateAction::Disable;
    else if (a == "status") c.action = ReplicateAction::Status;
    else return err("Unknown REPLICATE action: " + arg);
    return ok(std::move(c));
  }
  if (u == "MEMORY") {
    if (!rest.empty()) {
      return err("MEMORY command does not accept any arguments");
    }
    Command c;
    c.verb = Verb::Memory;
    return ok(std::move(c));
  }
  if (u == "CLIENT") {
    auto toks = split_ws(rest);
    std::string sub = toks.empty() ? "" : upper(toks[0]);
    if (sub == "LIST") {
      Command c;
      c.verb = Verb::ClientList;
      return ok(std::move(c));
    }
    return err("Unknown CLIENT subcommand");
  }
  if (u == "SCAN") {
    if (rest.find(' ') != std::string::npos) {
      return err("SCAN command accepts only one argument");
    }
    if (auto e = bad_char(rest, "prefix")) return err(*e);
    Command c;
    c.verb = Verb::Scan;
    c.prefix = rest;
    return ok(std::move(c));
  }
  if (u == "LEAFHASHES") {
    // Anti-entropy wire verb: per-key leaf digests so peers can diff
    // without shipping values (the hash-walk the reference documents,
    // README.md:310-372, but never implemented — sync.rs:150-214 ships
    // full state). Traced like the other cluster verbs: the multi-peer
    // gather is the one fused fetch a cycle makes per peer, so its serve
    // span is what stitches that peer into the cycle's trace.
    auto toks = split_ws(rest);
    std::string trace = take_trace_token(&toks);
    int vflags = take_version_flags(&toks);
    if (toks.size() > 1) {
      return err("LEAFHASHES command accepts only one argument");
    }
    if (!toks.empty()) {
      if (auto e = bad_char(toks[0], "prefix")) return err(*e);
    }
    Command c;
    c.verb = Verb::LeafHashes;
    c.trace = std::move(trace);
    c.prefix = toks.empty() ? "" : toks[0];
    apply_version_flags(&c, vflags);
    return ok(std::move(c));
  }
  if (u == "HASHPAGE") {
    // "HASHPAGE <count> [<after> [<upto>]]" — the paged form of LEAFHASHES.
    // The cursor is a key (exclusive lower bound) and <upto> an exclusive
    // upper bound; keys cannot contain spaces, so plain whitespace
    // splitting is unambiguous. A trailing trace-context token is stripped
    // first (its fixed tc= shape cannot collide with a real cursor key).
    auto toks = split_ws(rest);
    std::string trace = take_trace_token(&toks);
    int vflags = take_version_flags(&toks);
    if (toks.empty() || toks.size() > 3) {
      return err("HASHPAGE requires arguments: <count> [<after> [<upto>]]");
    }
    int64_t count;
    if (!parse_i64_str(toks[0], &count) || count <= 0) {
      return err("HASHPAGE count must be a positive integer");
    }
    Command c;
    c.verb = Verb::HashPage;
    c.trace = std::move(trace);
    c.amount = count;
    if (toks.size() >= 2) {
      if (auto e = bad_char(toks[1], "key")) return err(*e);
      c.prefix = toks[1];
    }
    if (toks.size() == 3) {
      if (auto e = bad_char(toks[2], "key")) return err(*e);
      if (toks[2] <= c.prefix) {
        return err("HASHPAGE upto must be greater than after");
      }
      c.upto = toks[2];
    }
    apply_version_flags(&c, vflags);
    return ok(std::move(c));
  }
  if (u == "TREELEVEL") {
    // "TREELEVEL <level> <lo> <hi>" — interior digests [lo, hi) of the
    // reference tree at `level` (0 = leaves). lo == hi is a valid empty
    // probe (capability check + leaf-count fetch). An optional trailing
    // trace-context token stitches the serve into the walker's trace.
    auto toks = split_ws(rest);
    std::string trace = take_trace_token(&toks);
    int vflags = take_version_flags(&toks);
    int64_t pid = take_partition_token(&toks);
    if (toks.size() != 3) {
      return err("TREELEVEL requires arguments: <level> <lo> <hi>");
    }
    int64_t level, lo, hi;
    if (!parse_i64_str(toks[0], &level) || level < 0) {
      return err("TREELEVEL level must be a non-negative integer");
    }
    if (!parse_i64_str(toks[1], &lo) || !parse_i64_str(toks[2], &hi) ||
        lo < 0 || hi < lo) {
      return err("TREELEVEL range must satisfy 0 <= lo <= hi");
    }
    Command c;
    c.verb = Verb::TreeLevel;
    c.trace = std::move(trace);
    c.level = level;
    c.lo = lo;
    c.hi = hi;
    c.partition = pid;
    apply_version_flags(&c, vflags);
    return ok(std::move(c));
  }
  if (u == "SNAPMETA") {
    auto toks = split_ws(rest);
    std::string trace = take_trace_token(&toks);
    if (!toks.empty()) {
      return err("SNAPMETA command does not accept any arguments");
    }
    Command c;
    c.verb = Verb::SnapMeta;
    c.trace = std::move(trace);
    return ok(std::move(c));
  }
  if (u == "SNAPCHUNK") {
    // "SNAPCHUNK <seq> <offset> <count>" — one CRC-framed byte range of
    // the advertised snapshot file. The seq pins the exact file so a
    // donor-side compaction between chunks can never switch artifacts
    // under a transfer.
    auto toks = split_ws(rest);
    std::string trace = take_trace_token(&toks);
    if (toks.size() != 3) {
      return err("SNAPCHUNK requires arguments: <seq> <offset> <count>");
    }
    int64_t seq, off, cnt;
    if (!parse_i64_str(toks[0], &seq) || seq < 0) {
      return err("SNAPCHUNK seq must be a non-negative integer");
    }
    if (!parse_i64_str(toks[1], &off) || off < 0) {
      return err("SNAPCHUNK offset must be a non-negative integer");
    }
    if (!parse_i64_str(toks[2], &cnt) || cnt <= 0) {
      return err("SNAPCHUNK count must be a positive integer");
    }
    Command c;
    c.verb = Verb::SnapChunk;
    c.trace = std::move(trace);
    c.snap_seq = seq;
    c.snap_off = off;
    c.snap_cnt = cnt;
    return ok(std::move(c));
  }
  if (u == "TRACE") {
    // "TRACE <n>" — newest n anti-entropy cycle traces.
    auto toks = split_ws(rest);
    int64_t n = 0;
    if (toks.size() != 1 || !parse_i64_str(toks[0], &n) || n <= 0) {
      return err("TRACE requires a positive integer count");
    }
    Command c;
    c.verb = Verb::Trace;
    c.amount = n;
    return ok(std::move(c));
  }
  if (u == "TRACEDUMP") {
    // "TRACEDUMP [n]" — up to n newest causal-trace spans (0/absent = all).
    auto toks = split_ws(rest);
    int64_t n = 0;
    if (toks.size() != 1 || !parse_i64_str(toks[0], &n) || n < 0) {
      return err("TRACEDUMP accepts one non-negative integer count");
    }
    Command c;
    c.verb = Verb::TraceDump;
    c.amount = n;
    return ok(std::move(c));
  }
  if (u == "FLIGHT") {
    // "FLIGHT <n>" — newest n flight-recorder events.
    auto toks = split_ws(rest);
    int64_t n = 0;
    if (toks.size() != 1 || !parse_i64_str(toks[0], &n) || n <= 0) {
      return err("FLIGHT accepts one positive integer count");
    }
    Command c;
    c.verb = Verb::Flight;
    c.amount = n;
    return ok(std::move(c));
  }
  if (u == "PROFILE") {
    // "PROFILE <secs>" — bounded device profiler capture.
    auto toks = split_ws(rest);
    int64_t secs = 0;
    if (toks.size() != 1 || !parse_i64_str(toks[0], &secs) || secs <= 0 ||
        secs > 600) {
      return err("PROFILE requires a duration in seconds (1..600)");
    }
    Command c;
    c.verb = Verb::Profile;
    c.amount = secs;
    return ok(std::move(c));
  }
  if (u == "INC") return parse_numeric(Verb::Increment, "INC", rest);
  if (u == "DEC") return parse_numeric(Verb::Decrement, "DEC", rest);
  if (u == "APPEND") return parse_key_value(Verb::Append, "APPEND", rest);
  if (u == "PREPEND") return parse_key_value(Verb::Prepend, "PREPEND", rest);
  if (u == "MSET") {
    if (rest.empty()) {
      return err("MSET command requires at least one key-value pair");
    }
    auto args = split_ws(rest);
    if (args.size() % 2 != 0) {
      return err(
          "MSET command requires an even number of arguments (key-value "
          "pairs)");
    }
    Command c;
    c.verb = Verb::MultiSet;
    for (size_t i = 0; i < args.size(); i += 2) {
      if (auto e = bad_char(args[i], "key")) return err(*e);
      c.pairs.emplace_back(args[i], args[i + 1]);
    }
    if (c.pairs.empty()) {
      return err("MSET command requires at least one key-value pair");
    }
    return ok(std::move(c));
  }
  if (u == "FLUSHDB") { Command c; c.verb = Verb::Flushdb; return ok(std::move(c)); }
  if (u == "TRUNCATE") { Command c; c.verb = Verb::Truncate; return ok(std::move(c)); }
  if (u == "STATS") { Command c; c.verb = Verb::Stats; return ok(std::move(c)); }
  if (u == "INFO") { Command c; c.verb = Verb::Info; return ok(std::move(c)); }
  return err("Unknown command: " + command);
}

}  // namespace mkv
