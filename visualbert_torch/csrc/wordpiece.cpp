// Fast WordPiece tokenizer (C++), the host-side hot loop of the input
// pipeline: the port's copy of native/wordpiece.cpp. Exposed through a
// minimal C API consumed via ctypes (visualbert_torch/data/fast_tokenizer.py,
// which builds it with g++ into visualbert_torch/_build/).
//
// Scope: byte-exact parity with the Python BertTokenizer for ASCII input
// (the wrapper routes non-ASCII strings to the Python implementation, so
// full Unicode category tables are not needed here). Implements:
//   * basic tokenization: whitespace/control cleaning, lower-casing,
//     punctuation splitting (ASCII punct ranges),
//   * greedy longest-match-first WordPiece with "##" continuations and the
//     100-char word cutoff to [UNK].
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libwordpiece.so wordpiece.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> map;
  int32_t unk = -1;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_ws_or_ctrl(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
         (c < 32) || c == 127;
}

// Greedy longest-match wordpiece of one lower-cased word; appends ids.
// Returns false if the word maps to [UNK].
bool wordpiece(const Vocab& v, const std::string& word,
               std::vector<int32_t>* out) {
  if (word.size() > 100) return false;
  size_t start = 0;
  std::vector<int32_t> pieces;
  std::string cand;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t match = -1;
    while (start < end) {
      cand.clear();
      if (start > 0) cand = "##";
      cand.append(word, start, end - start);
      auto it = v.map.find(cand);
      if (it != v.map.end()) {
        match = it->second;
        break;
      }
      --end;
    }
    if (match < 0) return false;
    pieces.push_back(match);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
  return true;
}

}  // namespace

extern "C" {

// vocab_blob: newline-separated tokens, in id order.
void* wp_create(const char* vocab_blob, int64_t blob_len) {
  auto* v = new Vocab();
  int32_t id = 0;
  const char* p = vocab_blob;
  const char* endp = vocab_blob + blob_len;
  while (p < endp) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', endp - p));
    size_t len = (nl ? nl - p : endp - p);
    if (len > 0) {
      std::string tok(p, len);
      v->map.emplace(std::move(tok), id);
      ++id;
    }
    if (!nl) break;
    p = nl + 1;
  }
  auto unk = v->map.find("[UNK]");
  v->unk = (unk == v->map.end()) ? 0 : unk->second;
  return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Encode ASCII text → wordpiece ids. Returns the number of ids written
// (≤ max_out). Lower-cases, splits punctuation, cleans whitespace/control.
int64_t wp_encode(void* handle, const char* text, int64_t text_len,
                  int32_t* out, int64_t max_out) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(64);
  std::string word;
  std::vector<int32_t> tmp;

  auto flush_word = [&]() {
    if (word.empty()) return;
    tmp.clear();
    if (wordpiece(v, word, &tmp)) {
      ids.insert(ids.end(), tmp.begin(), tmp.end());
    } else {
      ids.push_back(v.unk);
    }
    word.clear();
  };

  for (int64_t i = 0; i < text_len; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (c == 0 || is_ws_or_ctrl(c)) {
      flush_word();
      continue;
    }
    if (is_ascii_punct(c)) {
      flush_word();
      std::string p(1, static_cast<char>(c));
      auto it = v.map.find(p);
      ids.push_back(it == v.map.end() ? v.unk : it->second);
      continue;
    }
    if (c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
    word.push_back(static_cast<char>(c));
  }
  flush_word();

  int64_t n = static_cast<int64_t>(ids.size());
  if (n > max_out) n = max_out;
  memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

// Batched encode: texts packed back-to-back with offsets[n+1].
// out is [n, max_len]; out_lens receives per-row counts.
void wp_encode_batch(void* handle, const char* blob, const int64_t* offsets,
                     int64_t n, int32_t* out, int64_t max_len,
                     int32_t* out_lens) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t len = wp_encode(handle, blob + offsets[i],
                            offsets[i + 1] - offsets[i],
                            out + i * max_len, max_len);
    out_lens[i] = static_cast<int32_t>(len);
  }
}

}  // extern "C"
