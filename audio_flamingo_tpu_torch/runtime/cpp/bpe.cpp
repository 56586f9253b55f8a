// Native byte-level BPE merge engine of the port.
//
// The port's copy of audio_flamingo_tpu/runtime/cpp/bpe.cpp. Python keeps the unicode
// pretokenization; this library performs the merge loop and the vocab lookup per
// pretoken. Bound with ctypes in runtime/tokenizer.py (built by g++ into the port's
// _build/ at first use); it must produce the same ids as the Python merge loop there.
//
// Vocab format: newline-separated byte-mapped token strings, line index == token id.
// Merges format: newline-separated "left right" pairs, line index == merge rank.
//
// Build: g++ -O3 -shared -fPIC bpe.cpp -o libbpe.so

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003 ^ h(p.second);
  }
};

struct Bpe {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash> ranks;
  std::unordered_map<std::string, std::vector<int32_t>> cache;
};

std::vector<std::string> split_lines(const char* data, uint64_t len) {
  std::vector<std::string> out;
  const char* end = data + len;
  const char* line = data;
  for (const char* p = data; p <= end; ++p) {
    if (p == end || *p == '\n') {
      if (p > line) out.emplace_back(line, p - line);
      line = p + 1;
    }
  }
  return out;
}

// split a UTF-8 string into codepoint-level pieces
std::vector<std::string> utf8_chars(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    size_t n = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
    if (i + n > s.size()) n = 1;
    out.emplace_back(s.substr(i, n));
    i += n;
  }
  return out;
}

}  // namespace

extern "C" {

void* af_bpe_new(const char* vocab_data, uint64_t vocab_len, const char* merges_data,
                 uint64_t merges_len) {
  auto* bpe = new Bpe();
  auto vlines = split_lines(vocab_data, vocab_len);
  bpe->vocab.reserve(vlines.size() * 2);
  for (size_t i = 0; i < vlines.size(); ++i) bpe->vocab[vlines[i]] = (int32_t)i;
  auto mlines = split_lines(merges_data, merges_len);
  bpe->ranks.reserve(mlines.size() * 2);
  for (size_t i = 0; i < mlines.size(); ++i) {
    size_t sp = mlines[i].find(' ');
    if (sp == std::string::npos) continue;
    bpe->ranks[{mlines[i].substr(0, sp), mlines[i].substr(sp + 1)}] = (int32_t)i;
  }
  return bpe;
}

void af_bpe_free(void* handle) { delete (Bpe*)handle; }

// Encode one byte-mapped pretoken. Returns the number of ids written into out
// (capacity out_cap), or -1 on unknown token / overflow.
int64_t af_bpe_encode(void* handle, const char* pretoken, uint64_t len, int32_t* out,
                      uint64_t out_cap) {
  auto* bpe = (Bpe*)handle;
  std::string key(pretoken, len);
  auto it = bpe->cache.find(key);
  if (it == bpe->cache.end()) {
    std::vector<std::string> word = utf8_chars(key);
    while (word.size() > 1) {
      int32_t best_rank = INT32_MAX;
      size_t best_i = 0;
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        auto r = bpe->ranks.find({word[i], word[i + 1]});
        if (r != bpe->ranks.end() && r->second < best_rank) {
          best_rank = r->second;
          best_i = i;
        }
      }
      if (best_rank == INT32_MAX) break;
      // merge ALL occurrences of the best pair, left to right (GPT-2 semantics)
      const std::string first = word[best_i], second = word[best_i + 1];
      std::vector<std::string> merged;
      merged.reserve(word.size());
      for (size_t i = 0; i < word.size();) {
        if (i + 1 < word.size() && word[i] == first && word[i + 1] == second) {
          merged.emplace_back(first + second);
          i += 2;
        } else {
          merged.emplace_back(word[i]);
          i += 1;
        }
      }
      word.swap(merged);
    }
    std::vector<int32_t> ids;
    ids.reserve(word.size());
    for (auto& piece : word) {
      auto v = bpe->vocab.find(piece);
      if (v == bpe->vocab.end()) return -1;
      ids.push_back(v->second);
    }
    it = bpe->cache.emplace(std::move(key), std::move(ids)).first;
  }
  const auto& ids = it->second;
  if (ids.size() > out_cap) return -1;
  memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return (int64_t)ids.size();
}

}  // extern "C"
