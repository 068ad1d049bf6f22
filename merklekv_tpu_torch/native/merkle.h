// A copy of merklekv_tpu/native/merkle.h, built by the port into build/native/.
// Host-side Merkle root over a sorted (key, value) snapshot.
//
// Bit-identical to the reference tree (the reference's src/store/merkle.rs:
// length-prefixed leaf encoding :7-16, sorted leaves, pairwise bottom-up
// build with odd-node promotion :73-121) and to the Python/TPU engines
// (merklekv_tpu_torch/merkle/encoding.py). Used by the HASH command so the native
// server answers without a device round-trip; bulk rebuild/diff runs on TPU.
#pragma once

#include <array>
#include <cstdint>
#include <string>
#include <utility>
#include <vector>

namespace mkv {

// leaf = SHA256(u32_be(len k) || k || u32_be(len v) || v)
void leaf_hash(const std::string& key, const std::string& value,
               uint8_t out[32]);

// Root over (key, value) pairs; sorts by key internally. Returns false (and
// leaves `out` untouched) for an empty snapshot — the protocol encodes the
// empty tree as 64 zeros.
bool merkle_root(std::vector<std::pair<std::string, std::string>> items,
                 uint8_t out[32]);

// ALL tree levels bottom-up over an ALREADY-SORTED (key, value) snapshot:
// levels[0] are the leaf digests, levels.back() is [root]; an odd trailing
// node is promoted unchanged. Empty input -> empty vector. Backs the
// TREELEVEL verb's host-side fallback (the server caches the result keyed
// on the engine's mutation version, so one build amortizes over a whole
// bisection walk).
std::vector<std::vector<std::array<uint8_t, 32>>> merkle_levels(
    const std::vector<std::pair<std::string, std::string>>& items);

}  // namespace mkv
