// Native question tokenizer + vocab encoder (SURVEY.md C4 host hot loop),
// the port's copy of vqa_tpu/native/tokenizer.cc. Only this header differs
// from the original's lines 1-11: it names the port's files. The code below
// is the original's, line for line.
//
// Replicates vqa_tpu_torch.datasets.tokenizer.tokenize_mcb byte-for-byte
// (lowercase; drop ? ! ' " $ : @ ( ) , . ; ; map - and / to space; split on
// whitespace) and encodes tokens to vocab ids in the same pass. The Python
// implementation is the semantics oracle (tests/test_torch_native.py proves
// identical output); this exists for prep throughput, where per-question
// Python regex work is most of the encode step.
//
// C ABI, loaded via ctypes (see the build notes in
// vqa_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> word_to_id;
};

constexpr int32_t kPadId = 0;
constexpr int32_t kUnkId = 1;

inline bool is_removed(char c) {
  switch (c) {
    case '?': case '!': case '\'': case '"': case '$':
    case ':': case '@': case '(': case ')': case ',':
    case '.': case ';':
      return true;
    default:
      return false;
  }
}

inline bool is_separator(char c) {
  return c == '-' || c == '/' || c == ' ' || c == '\t' || c == '\n' ||
         c == '\r' || c == '\f' || c == '\v';
}

}  // namespace

extern "C" {

// words: '\n'-joined vocab, id = line index (caller passes the full
// wid_to_word table including <pad>/<unk> at 0/1).
void* vt_build(const char* words, int64_t len) {
  auto* vocab = new Vocab();
  int32_t id = 0;
  const char* p = words;
  const char* end = words + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t n = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
    vocab->word_to_id.emplace(std::string(p, n), id++);
    p = nl ? nl + 1 : end;
  }
  return vocab;
}

void vt_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Tokenize+encode one question. Fills out[0..maxlen) (pad 0 / unk 1),
// returns the clamped token count. pad_right=0 right-aligns the ids.
int32_t vt_encode(void* handle, const char* text, int64_t text_len,
                  int32_t* out, int32_t maxlen, int32_t pad_right) {
  const Vocab* vocab = static_cast<const Vocab*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(32);
  std::string word;
  word.reserve(32);

  auto flush = [&]() {
    if (word.empty() || static_cast<int32_t>(ids.size()) >= maxlen) {
      word.clear();
      return;
    }
    auto it = vocab->word_to_id.find(word);
    ids.push_back(it == vocab->word_to_id.end() ? kUnkId : it->second);
    word.clear();
  };

  for (int64_t i = 0; i < text_len; ++i) {
    char c = text[i];
    if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
    if (is_removed(c)) continue;
    if (is_separator(c)) {
      flush();
      continue;
    }
    word.push_back(c);
  }
  flush();

  const int32_t n = static_cast<int32_t>(ids.size());
  if (pad_right) {
    for (int32_t i = 0; i < maxlen; ++i) out[i] = i < n ? ids[i] : kPadId;
  } else {
    const int32_t offset = maxlen - n;
    for (int32_t i = 0; i < maxlen; ++i)
      out[i] = i < offset ? kPadId : ids[i - offset];
  }
  return n;
}

// Batch variant: texts is a '\n'-joined blob (questions must be single-line,
// true for VQA), out is [n_texts, maxlen] row-major, lengths is [n_texts].
void vt_encode_batch(void* handle, const char* texts, int64_t len,
                     int32_t n_texts, int32_t* out, int32_t* lengths,
                     int32_t maxlen, int32_t pad_right) {
  const char* p = texts;
  const char* end = texts + len;
  for (int32_t row = 0; row < n_texts && p <= end; ++row) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    int64_t n = nl ? (nl - p) : (end - p);
    lengths[row] = vt_encode(handle, p, n, out + static_cast<int64_t>(row) * maxlen,
                             maxlen, pad_right);
    p = nl ? nl + 1 : end + 1;
  }
}

}  // extern "C"
