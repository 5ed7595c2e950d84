// Native featurization kernels for the offline data pipeline.
//
// The reference's hottest host-side loop is per-sample supervision-label
// construction (CaSE/CaSEDataset.py:6-28: 1/3/5-gram overlap x log-frequency
// confidence over num_passage x passage_len tokens, and
// GLKS/GLKSDataset.py:6-20 window-overlap labels) — pure Python per-token
// work, O(samples * 10 * 100) with set operations per token. These C
// implementations are exact ports of the *math* (not the code): bit-for-bit
// against the Python/numpy versions (tests/test_native.py).
//
// Built as a plain shared library, bound via ctypes (no pybind11 needed).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

// labels[p, l] = 1 if passages[p, l] appears in answer
// conf[p, l]  = (inv_logfreq * g1 * g3 * g5)^0.2, 1.0 where g1 == 0
//   inv_logfreq = sum_l log(freq+2) / log(freq_l + 2)   (per passage)
//   g3/g5 = |distinct window members (size 3/5, zero-padded) in answer|
void case_token_labels(const int32_t* passages, int num_p, int len,
                       const int32_t* answer, int answer_len,
                       const float* freq, int vocab_size,
                       float* labels, float* conf) {
  // membership table over the vocabulary
  std::vector<uint8_t> in_answer(vocab_size, 0);
  for (int t = 0; t < answer_len; ++t) {
    int32_t a = answer[t];
    if (a >= 0 && a < vocab_size) in_answer[a] = 1;
  }

  std::vector<float> logf(len);
  for (int p = 0; p < num_p; ++p) {
    const int32_t* toks = passages + (size_t)p * len;
    float* lab = labels + (size_t)p * len;
    float* cf = conf + (size_t)p * len;

    double logf_sum = 0.0;
    for (int l = 0; l < len; ++l) {
      float f = (toks[l] >= 0 && toks[l] < vocab_size) ? freq[toks[l]] : 0.0f;
      logf[l] = std::log(f + 2.0f);
      logf_sum += logf[l];
    }

    for (int l = 0; l < len; ++l) {
      int32_t tok = toks[l];
      float g1 = (tok >= 0 && tok < vocab_size && in_answer[tok]) ? 1.0f : 0.0f;
      lab[l] = g1;
      if (g1 == 0.0f) {
        cf[l] = 1.0f;
        continue;
      }
      // distinct members of the centered window that appear in the answer;
      // windows are zero-padded at the edges (pad token 0 may itself match)
      auto window_overlap = [&](int size) -> float {
        int half = (size - 1) / 2;
        int32_t win[5];
        int n = 0;
        for (int k = -half; k <= half; ++k) {
          int idx = l + k;
          int32_t v = (idx >= 0 && idx < len) ? toks[idx] : 0;
          bool dup = false;
          for (int j = 0; j < n; ++j)
            if (win[j] == v) { dup = true; break; }
          if (!dup) win[n++] = v;
        }
        int count = 0;
        for (int j = 0; j < n; ++j)
          if (win[j] >= 0 && win[j] < vocab_size && in_answer[win[j]]) ++count;
        return (float)count;
      };
      float g3 = window_overlap(3);
      float g5 = window_overlap(5);
      float inv = (float)(logf_sum / logf[l]);
      float v = inv * g1 * g3 * g5;
      cf[l] = std::pow(v > 0.0f ? v : 0.0f, 0.2f);
    }
  }
}

// GLKS sliding-window overlap counts: for window sizes
// {min_ws, 2*min_ws, ..., n_windows*min_ws} with stride min_ws, the number of
// distinct window members appearing in the answer. Returns the number of
// windows written.
int glks_window_overlap(const int32_t* background, int len,
                        const int32_t* answer, int answer_len,
                        int min_window_size, int n_windows,
                        int vocab_size, float* counts_out) {
  std::vector<uint8_t> in_answer(vocab_size, 0);
  for (int t = 0; t < answer_len; ++t) {
    int32_t a = answer[t];
    if (a >= 0 && a < vocab_size) in_answer[a] = 1;
  }
  int out = 0;
  int ws = min_window_size;
  std::vector<int32_t> seen;
  for (int w = 0; w < n_windows; ++w) {
    int n_w = (len - ws) / min_window_size + 1;
    for (int s = 0; s < n_w; ++s) {
      const int32_t* seg = background + (size_t)s * min_window_size;
      seen.clear();
      int count = 0;
      for (int k = 0; k < ws; ++k) {
        int32_t v = seg[k];
        bool dup = false;
        for (int32_t sv : seen)
          if (sv == v) { dup = true; break; }
        if (dup) continue;
        seen.push_back(v);
        if (v >= 0 && v < vocab_size && in_answer[v]) ++count;
      }
      counts_out[out++] = (float)count;
    }
    ws += min_window_size;
  }
  return out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// WordPiece tokenizer fast path (ASCII texts).
//
// The reference leans on HuggingFace's (Rust-backed) BertTokenizer
// (common/Utils.py:30-37); this framework's pure-Python WordPiece
// (data/text.py) is exact but slow for corpus-scale offline prep. This C++
// path reproduces data/text.basic_tokenize + WordPieceTokenizer for ASCII
// input BYTE-FOR-BYTE (Python-side wrapper falls back to the Python
// implementation for any non-ASCII text, where Unicode normalization
// matters). Emits vocabulary ids; the wrapper maps ids back to token
// strings.
// ---------------------------------------------------------------------------

#include <string>
#include <unordered_map>

namespace {

struct WpVocab {
  std::unordered_map<std::string, int32_t> word2id;
  int32_t unk_id;
};

// HF BertTokenizer whitespace for ASCII code points: ' ', \t, \n, \r only
// (\v, \f, \x1c-\x1f are category Cc -> control -> dropped by clean_text)
inline bool ascii_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// HF clean_text drops NUL and all other ASCII controls (0x00-0x1f except
// \t\n\r, plus DEL 0x7f) WITHOUT breaking the word ("a\vb" -> "ab")
inline bool ascii_dropped(unsigned char c) {
  return (c < 32 && c != '\t' && c != '\n' && c != '\r') || c == 127;
}

// data/text._is_punct for ASCII code points (the unicodedata category
// check only adds non-ASCII punctuation)
inline bool ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// greedy longest-match-first wordpiece of one word; appends ids.
// Returns false only on overflow of the output buffer.
bool wordpiece(const WpVocab& v, const std::string& word, int max_chars,
               int32_t* out, int cap, int* n) {
  if ((int)word.size() > max_chars) {
    if (*n >= cap) return false;
    out[(*n)++] = v.unk_id;
    return true;
  }
  int pieces_start = *n;
  size_t start = 0;
  std::string sub;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t piece = -1;
    while (start < end) {
      sub.assign(start > 0 ? "##" : "");
      sub.append(word, start, end - start);
      auto it = v.word2id.find(sub);
      if (it != v.word2id.end()) {
        piece = it->second;
        break;
      }
      --end;
    }
    if (piece < 0) {   // untokenizable word -> single UNK
      *n = pieces_start;
      if (*n >= cap) return false;
      out[(*n)++] = v.unk_id;
      return true;
    }
    if (*n >= cap) return false;
    out[(*n)++] = piece;
    start = end;
  }
  return true;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_blob, int blob_len, int32_t unk_id) {
  auto* v = new WpVocab();
  v->unk_id = unk_id;
  int32_t id = 0;
  const char* p = vocab_blob;
  const char* end = vocab_blob + blob_len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (nl == nullptr) nl = end;
    v->word2id.emplace(std::string(p, nl - p), id++);
    p = nl + 1;
  }
  return v;
}

void wp_destroy(void* h) { delete (WpVocab*)h; }

// Tokenize an ASCII text: basic_tokenize (lower + punct isolation) then
// wordpiece per word. Returns the number of ids written, or -1 if out_cap
// was too small.
int wp_tokenize(void* h, const char* text, int text_len, int lower,
                int max_chars, int32_t* out, int out_cap) {
  const WpVocab& v = *(const WpVocab*)h;
  int n = 0;
  std::string buf;
  auto flush = [&]() -> bool {
    if (buf.empty()) return true;
    bool ok = wordpiece(v, buf, max_chars, out, out_cap, &n);
    buf.clear();
    return ok;
  };
  for (int i = 0; i < text_len; ++i) {
    unsigned char c = (unsigned char)text[i];
    if (ascii_dropped(c)) continue;
    if (lower && c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
    if (ascii_space(c)) {
      if (!flush()) return -1;
    } else if (ascii_punct(c)) {
      if (!flush()) return -1;
      std::string p(1, (char)c);
      if (!wordpiece(v, p, max_chars, out, out_cap, &n)) return -1;
    } else {
      buf.push_back((char)c);
    }
  }
  if (!flush()) return -1;
  return n;
}

// Batched wp_tokenize: texts arrive concatenated in `blob`, text i spanning
// bytes [offsets[i], offsets[i+1]). Ids are written consecutively into
// `out`; per-text counts land in `out_lens`. Returns the total id count,
// or -1 if out_cap was too small (caller grows the buffer and retries).
// One ctypes crossing per CHUNK instead of per sentence — the crossing
// overhead dominated the serving featurizer once the tokenizer itself was
// native (docs/PERF.md).
int wp_tokenize_batch(void* h, const char* blob, const int32_t* offsets,
                      int n_texts, int lower, int max_chars,
                      int32_t* out, int out_cap, int32_t* out_lens) {
  int total = 0;
  for (int i = 0; i < n_texts; ++i) {
    int n = wp_tokenize(h, blob + offsets[i], offsets[i + 1] - offsets[i],
                        lower, max_chars, out + total, out_cap - total);
    if (n < 0) return -1;
    out_lens[i] = n;
    total += n;
  }
  return total;
}

}  // extern "C"
