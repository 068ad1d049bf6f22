// A copy of merklekv_tpu/native/merkle.cc, built by the port into build/native/.
#include "merkle.h"

#include <algorithm>
#include <array>
#include <cstring>

#include "sha256.h"

namespace mkv {

namespace {
void put_u32_be(uint32_t v, uint8_t out[4]) {
  out[0] = uint8_t(v >> 24);
  out[1] = uint8_t(v >> 16);
  out[2] = uint8_t(v >> 8);
  out[3] = uint8_t(v);
}
}  // namespace

void leaf_hash(const std::string& key, const std::string& value,
               uint8_t out[32]) {
  Sha256 h;
  uint8_t len_be[4];
  put_u32_be(uint32_t(key.size()), len_be);
  h.update(len_be, 4);
  h.update(key.data(), key.size());
  put_u32_be(uint32_t(value.size()), len_be);
  h.update(len_be, 4);
  h.update(value.data(), value.size());
  h.final(out);
}

bool merkle_root(std::vector<std::pair<std::string, std::string>> items,
                 uint8_t out[32]) {
  if (items.empty()) return false;
  std::sort(items.begin(), items.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  std::vector<std::array<uint8_t, 32>> level(items.size());
  for (size_t i = 0; i < items.size(); ++i) {
    leaf_hash(items[i].first, items[i].second, level[i].data());
  }
  while (level.size() > 1) {
    std::vector<std::array<uint8_t, 32>> next((level.size() + 1) / 2);
    size_t pairs = level.size() / 2;
    for (size_t i = 0; i < pairs; ++i) {
      uint8_t msg[64];
      std::memcpy(msg, level[2 * i].data(), 32);
      std::memcpy(msg + 32, level[2 * i + 1].data(), 32);
      sha256(msg, 64, next[i].data());
    }
    if (level.size() % 2) next[pairs] = level.back();  // odd-node promotion
    level.swap(next);
  }
  std::memcpy(out, level[0].data(), 32);
  return true;
}

std::vector<std::vector<std::array<uint8_t, 32>>> merkle_levels(
    const std::vector<std::pair<std::string, std::string>>& items) {
  std::vector<std::vector<std::array<uint8_t, 32>>> levels;
  if (items.empty()) return levels;
  levels.emplace_back(items.size());
  for (size_t i = 0; i < items.size(); ++i) {
    leaf_hash(items[i].first, items[i].second, levels[0][i].data());
  }
  while (levels.back().size() > 1) {
    const auto& cur = levels.back();
    std::vector<std::array<uint8_t, 32>> next((cur.size() + 1) / 2);
    size_t pairs = cur.size() / 2;
    for (size_t i = 0; i < pairs; ++i) {
      uint8_t msg[64];
      std::memcpy(msg, cur[2 * i].data(), 32);
      std::memcpy(msg + 32, cur[2 * i + 1].data(), 32);
      sha256(msg, 64, next[i].data());
    }
    if (cur.size() % 2) next[pairs] = cur.back();  // odd-node promotion
    levels.push_back(std::move(next));
  }
  return levels;
}

}  // namespace mkv
