// Native greedy-wordpiece tokenizer for the SMILES fragment vocab: the
// port's copy of the JAX package's native/wordpiece.cpp.
//
// Host-side hot loop of the data pipeline: replaces the pure-Python
// tokenizer (spmm_tpu_torch/tokenizer.py) for high-throughput pretraining
// ingestion.  Exact same semantics: whitespace split, greedy longest-match
// wordpiece with "##" continuation prefixes, words longer than
// max_input_chars_per_word collapse to [UNK], special tokens are ordinary
// vocab entries (the '[CLS]' string prefix anchors the match).
//
// C ABI for the ctypes binding (NativeWordpiece in
// spmm_tpu_torch/tokenizer.py), built with the host C++ compiler by
// spmm_tpu_torch/ops/_host_build.py.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> pieces;  // includes "##" forms
  int32_t unk_id = 1;
  int32_t cls_id = 2;
  int32_t sep_id = 3;
  size_t max_piece_len = 1;  // longest piece without the "##" prefix
  int32_t max_word_chars = 250;
};

void tokenize_word(const Vocab& v, const char* word, size_t len,
                   std::vector<int32_t>* out) {
  if (len > static_cast<size_t>(v.max_word_chars)) {
    out->push_back(v.unk_id);
    return;
  }
  size_t start = 0;
  std::string buf;
  size_t first_out = out->size();
  while (start < len) {
    size_t end = std::min(len, start + v.max_piece_len);
    int32_t match = -1;
    size_t match_end = 0;
    while (start < end) {
      buf.clear();
      if (start > 0) buf.append("##");
      buf.append(word + start, end - start);
      auto it = v.pieces.find(buf);
      if (it != v.pieces.end()) {
        match = it->second;
        match_end = end;
        break;
      }
      --end;
    }
    if (match < 0) {
      out->resize(first_out);
      out->push_back(v.unk_id);
      return;
    }
    out->push_back(match);
    start = match_end;
  }
}

}  // namespace

extern "C" {

// tokens: n null-terminated vocab entries in id order.
void* wp_create(const char** tokens, int32_t n, int32_t max_word_chars) {
  auto* v = new Vocab();
  v->max_word_chars = max_word_chars;
  for (int32_t i = 0; i < n; ++i) {
    std::string t(tokens[i]);
    v->pieces.emplace(t, i);
    size_t plain = t.rfind("##", 0) == 0 ? t.size() - 2 : t.size();
    if (plain > v->max_piece_len) v->max_piece_len = plain;
    if (t == "[UNK]") v->unk_id = i;
    if (t == "[CLS]") v->cls_id = i;
    if (t == "[SEP]") v->sep_id = i;
  }
  return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Encode one text: [CLS] + pieces + [SEP], truncating the piece list to
// max_len-2 when truncate != 0.  Returns the id count written (<= out_cap),
// or -1 if out_cap is too small.
int32_t wp_encode(void* handle, const char* text, int32_t truncate,
                  int32_t max_len, int32_t* out, int32_t out_cap) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  std::vector<int32_t> ids;
  ids.push_back(v.cls_id);
  const char* p = text;
  while (*p) {
    while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
    const char* w = p;
    while (*p && !std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p > w) tokenize_word(v, w, static_cast<size_t>(p - w), &ids);
  }
  if (truncate && max_len >= 2 &&
      ids.size() > static_cast<size_t>(max_len) - 1) {
    ids.resize(static_cast<size_t>(max_len) - 1);
  }
  ids.push_back(v.sep_id);
  if (static_cast<int32_t>(ids.size()) > out_cap) return -1;
  std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int32_t>(ids.size());
}

// Batch encode into a [n, max_len] int32 matrix (0-padded) + per-row length.
// Rows longer than max_len are truncated like wp_encode(truncate=1).
void wp_encode_batch(void* handle, const char** texts, int32_t n,
                     int32_t truncate, int32_t max_len, int32_t* out_ids,
                     int32_t* out_lens) {
  std::vector<int32_t> row(static_cast<size_t>(max_len) + 8);
  for (int32_t i = 0; i < n; ++i) {
    int32_t len = wp_encode(handle, texts[i], /*truncate=*/1, max_len,
                            row.data(), max_len);
    if (len < 0) len = 0;
    (void)truncate;
    std::memset(out_ids + static_cast<size_t>(i) * max_len, 0,
                sizeof(int32_t) * max_len);
    std::memcpy(out_ids + static_cast<size_t>(i) * max_len, row.data(),
                sizeof(int32_t) * len);
    out_lens[i] = len;
  }
}

}  // extern "C"
