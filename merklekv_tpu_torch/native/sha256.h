// A copy of merklekv_tpu/native/sha256.h, built by the port into build/native/.
// Native SHA-256 (FIPS 180-4) for the host-side control plane.
//
// The TPU data plane hashes leaves in bulk (merklekv_tpu_torch/ops/sha256.py);
// this host implementation serves the protocol-level HASH command and small
// incremental updates where a device round-trip is not worth it. Mirrors the
// role of the `sha2` crate in the reference (the reference's src/store/merkle.rs:2).
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>

namespace mkv {

struct Sha256 {
  uint32_t state[8];
  uint64_t bitlen = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  Sha256();
  void update(const void* data, size_t len);
  // Writes 32 bytes into out.
  void final(uint8_t out[32]);
};

// One-shot convenience: digest of `data`, written to out[32].
void sha256(const void* data, size_t len, uint8_t out[32]);

// Hex encoding of a 32-byte digest.
std::string digest_hex(const uint8_t digest[32]);

}  // namespace mkv
