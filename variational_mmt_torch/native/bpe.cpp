// Native BPE segmenter: applies learned merges to words (the apply-side
// hot path of preprocessing and of the serving front end, data/bpe.py
// BPE.segment_word).
// Same greedy lowest-rank-merge algorithm and @@-continuation output as the
// Python implementation; byte-identical results (tested).
//
// C ABI (ctypes): create a handle from the merges text ("a b\n" per line,
// '#version' header ignored), then segment UTF-8 words into a caller buffer.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr const char* kEow = "</w>";

struct BpeHandle {
  // pair "left\x01right" -> rank
  std::unordered_map<std::string, int32_t> ranks;
};

// split a UTF-8 string into codepoint-sized chunks (matching Python's
// per-character symbol init)
std::vector<std::string> utf8_chars(const std::string& w) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < w.size()) {
    unsigned char c = w[i];
    size_t n = 1;
    if ((c & 0x80) == 0x00) n = 1;
    else if ((c & 0xE0) == 0xC0) n = 2;
    else if ((c & 0xF0) == 0xE0) n = 3;
    else if ((c & 0xF8) == 0xF0) n = 4;
    if (i + n > w.size()) n = 1;  // tolerate malformed input
    out.emplace_back(w.substr(i, n));
    i += n;
  }
  return out;
}

}  // namespace

extern "C" {

void* bpe_create(const char* merges_txt) {
  auto* h = new BpeHandle();
  const char* p = merges_txt;
  int32_t rank = 0;
  while (*p) {
    const char* eol = strchr(p, '\n');
    size_t len = eol ? static_cast<size_t>(eol - p) : strlen(p);
    std::string line(p, len);
    p += len + (eol ? 1 : 0);
    // only a literal '#version' header is a comment: a merge whose left
    // symbol IS '#' (hashtag-like words) must not be dropped, or this
    // diverges from the Python ranks dict it mirrors byte-identically
    if (line.empty() || line.rfind("#version", 0) == 0) continue;
    size_t sp = line.find(' ');
    if (sp == std::string::npos) continue;
    std::string key = line.substr(0, sp);
    key.push_back('\x01');
    key.append(line.substr(sp + 1));
    h->ranks.emplace(std::move(key), rank++);
  }
  return h;
}

void bpe_free(void* handle) { delete static_cast<BpeHandle*>(handle); }

// Segment `word` (UTF-8, no spaces); writes space-separated pieces with
// "@@" continuation markers into out (NUL-terminated). Returns the number
// of bytes written (excluding NUL), or -1 if out_cap is too small.
int64_t bpe_segment(void* handle, const char* word, char* out, int64_t out_cap) {
  auto* h = static_cast<BpeHandle*>(handle);
  std::string w(word);
  if (w.empty()) {
    if (out_cap < 1) return -1;
    out[0] = '\0';
    return 0;
  }
  std::vector<std::string> sym = utf8_chars(w);
  sym.back() += kEow;

  while (sym.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < sym.size(); ++i) {
      std::string key = sym[i];
      key.push_back('\x01');
      key.append(sym[i + 1]);
      auto it = h->ranks.find(key);
      if (it != h->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    sym[best_i] += sym[best_i + 1];
    sym.erase(sym.begin() + best_i + 1);
  }

  std::string result;
  const size_t eow_len = strlen(kEow);
  for (size_t i = 0; i < sym.size(); ++i) {
    std::string s = sym[i];
    bool final_piece = s.size() >= eow_len &&
        s.compare(s.size() - eow_len, eow_len, kEow) == 0;
    if (final_piece) {
      s.resize(s.size() - eow_len);
      if (s.empty()) continue;
    } else {
      s += "@@";
    }
    if (!result.empty()) result.push_back(' ');
    result.append(s);
  }
  if (static_cast<int64_t>(result.size()) + 1 > out_cap) return -1;
  std::memcpy(out, result.data(), result.size());
  out[result.size()] = '\0';
  return static_cast<int64_t>(result.size());
}

}  // extern "C"
