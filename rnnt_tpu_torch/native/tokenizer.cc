// Native host-side unigram tokenizer: Viterbi segmentation over a
// SentencePiece-style piece table.
//
// The port's own copy of rnnt_tpu/native/tokenizer.cc, the same C ABI:
// a first-party stand-in for the SentencePiece C++ library, loaded with
// ctypes by rnnt_tpu_torch/native/__init__.py for
// rnnt_tpu_torch/data/tokenizer.py.  Tokenization runs in the host input
// pipeline while the card trains; it keeps the text side off the Python
// interpreter's critical path.
//
// Piece table wire format (built by the Python side):
//   int32 n_pieces
//   n_pieces x { int32 id; float score; int32 len; char bytes[len] }
// Only segmentable pieces are included (normal/user-defined/byte types).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, std::pair<int32_t, float>> pieces;
  size_t max_piece_len = 1;
  int32_t unk_id = 0;
  float unk_score = -20.0f;
};

// Bytes consumed by the UTF-8 character starting at s[i].
inline size_t utf8_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xE) return 3;
  if ((c >> 3) == 0x1E) return 4;
  return 1;  // invalid byte: consume one
}

}  // namespace

extern "C" {

void* rnnt_tok_create(const char* blob, int64_t blob_len, int32_t unk_id,
                      float unk_score) {
  auto* tok = new Tokenizer();
  tok->unk_id = unk_id;
  tok->unk_score = unk_score;
  const char* p = blob;
  const char* end = blob + blob_len;
  if (p + 4 > end) return tok;
  int32_t n;
  std::memcpy(&n, p, 4);
  p += 4;
  for (int32_t i = 0; i < n && p + 12 <= end; ++i) {
    int32_t id, len;
    float score;
    std::memcpy(&id, p, 4);
    std::memcpy(&score, p + 4, 4);
    std::memcpy(&len, p + 8, 4);
    p += 12;
    if (p + len > end) break;
    std::string piece(p, len);
    p += len;
    tok->pieces.emplace(std::move(piece), std::make_pair(id, score));
    if (static_cast<size_t>(len) > tok->max_piece_len)
      tok->max_piece_len = len;
  }
  return tok;
}

void rnnt_tok_destroy(void* handle) {
  delete static_cast<Tokenizer*>(handle);
}

// Viterbi encode normalized UTF-8 text (the caller applies the dummy-prefix
// and whitespace->U+2581 normalization).  Returns the number of ids written
// (<= max_out), or -1 on overflow.
int32_t rnnt_tok_encode(void* handle, const char* text, int64_t text_len,
                        int32_t* out_ids, int32_t max_out) {
  const auto* tok = static_cast<const Tokenizer*>(handle);
  const size_t n = static_cast<size_t>(text_len);
  constexpr float kNegInf = -1e30f;

  std::vector<float> best(n + 1, kNegInf);
  std::vector<int32_t> back_pos(n + 1, -1);
  std::vector<int32_t> back_id(n + 1, -1);
  best[0] = 0.0f;

  std::string key;
  key.reserve(tok->max_piece_len);
  for (size_t i = 0; i < n; ++i) {
    if (best[i] == kNegInf) continue;
    const size_t max_j = std::min(n, i + tok->max_piece_len);
    for (size_t j = i + 1; j <= max_j; ++j) {
      key.assign(text + i, j - i);
      auto it = tok->pieces.find(key);
      if (it != tok->pieces.end()) {
        const float cand = best[i] + it->second.second;
        if (cand > best[j]) {
          best[j] = cand;
          back_pos[j] = static_cast<int32_t>(i);
          back_id[j] = it->second.first;
        }
      }
    }
    // Unknown fallback: consume one UTF-8 character.
    const size_t adv = std::min(
        utf8_len(static_cast<unsigned char>(text[i])), n - i);
    const float cand = best[i] + tok->unk_score;
    if (cand > best[i + adv]) {
      best[i + adv] = cand;
      back_pos[i + adv] = static_cast<int32_t>(i);
      back_id[i + adv] = tok->unk_id;
    }
  }

  // Backtrack (ids come out reversed; reverse in place).
  int32_t count = 0;
  size_t pos = n;
  while (pos > 0) {
    if (back_pos[pos] < 0) return 0;  // unreachable (shouldn't happen)
    if (count >= max_out) return -1;
    out_ids[count++] = back_id[pos];
    pos = static_cast<size_t>(back_pos[pos]);
  }
  for (int32_t a = 0, b = count - 1; a < b; ++a, --b) {
    const int32_t t = out_ids[a];
    out_ids[a] = out_ids[b];
    out_ids[b] = t;
  }
  return count;
}

// Word-level edit distance for WER (host-side eval helper).
int32_t rnnt_edit_distance(const int32_t* ref, int32_t ref_len,
                           const int32_t* hyp, int32_t hyp_len) {
  std::vector<int32_t> prev(hyp_len + 1), cur(hyp_len + 1);
  for (int32_t j = 0; j <= hyp_len; ++j) prev[j] = j;
  for (int32_t i = 1; i <= ref_len; ++i) {
    cur[0] = i;
    for (int32_t j = 1; j <= hyp_len; ++j) {
      const int32_t sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1] ? 1 : 0);
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
    }
    std::swap(prev, cur);
  }
  return prev[hyp_len];
}

}  // extern "C"
