// fastetl: native ETL hot loops of newsreclib_tpu_torch (the port's own copy
// of the repository's native/fastetl.cpp; the two must tokenize and parse
// alike, which tests/test_torch_port_datasets.py checks).
//
// Host code, not a device kernel: at MINDlarge scale the hot loops of the
// data pipeline are (a) tokenizing ~0.7M news texts against the vocab and
// (b) parsing ~2M+ behavior lines ("N123-1 N456-0 ...") into id/label
// arrays.  This library implements both over raw buffers, exposed through
// ctypes (a plain C interface, no Python or PyTorch headers).
//
// Contract notes:
//  * Texts must be pre-lowercased by the caller (Python's str.lower is
//    vectorized and unicode-correct; doing case folding here would risk
//    diverging on non-ASCII).
//  * Tokenization matches the reference regex `[\w]+|[.,!?;|]`
//    (data_utils.py:20-34) for ASCII; any non-ASCII byte is treated as a
//    word character (correct for letters, the overwhelmingly common case
//    in news text; unicode punctuation differs).
//
// Built by newsreclib_tpu_torch/data/fastetl.py on first use:
//   g++ -O3 -shared -fPIC -std=c++17 fastetl.cpp -o build/host/libfastetl-<hash>.so

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>

namespace {

struct StrMap {
  std::unordered_map<std::string, int32_t> map;
};

inline bool is_word_char(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_' || c >= 0x80;
}

inline bool is_punct_token(unsigned char c) {
  switch (c) {
    case '.': case ',': case '!': case '?': case ';': case '|':
      return true;
    default:
      return false;
  }
}

}  // namespace

extern "C" {

// Build a string->int32 map from a concatenated blob with n+1 offsets.
void* fe_make_strmap(const char* blob, const int64_t* offsets,
                     const int32_t* values, int64_t n) {
  auto* m = new StrMap();
  m->map.reserve(static_cast<size_t>(n) * 2);
  for (int64_t i = 0; i < n; ++i) {
    m->map.emplace(
        std::string(blob + offsets[i],
                    static_cast<size_t>(offsets[i + 1] - offsets[i])),
        values[i]);
  }
  return m;
}

void fe_free_strmap(void* handle) { delete static_cast<StrMap*>(handle); }

int64_t fe_strmap_size(void* handle) {
  return static_cast<int64_t>(static_cast<StrMap*>(handle)->map.size());
}

// Tokenize n_texts texts (concatenated blob + offsets) and map each token
// through `vocab` (0 when absent). Writes up to cap ids per text into
// out_ids[i*cap ...] and the true (uncapped, clamped to cap) count into
// out_lens[i]. Returns total ids written.
int64_t fe_tokenize_ids(void* vocab, const char* blob, const int64_t* offsets,
                        int64_t n_texts, int32_t* out_ids, int64_t cap,
                        int32_t* out_lens) {
  auto& map = static_cast<StrMap*>(vocab)->map;
  int64_t total = 0;
  std::string key;
  for (int64_t i = 0; i < n_texts; ++i) {
    const char* p = blob + offsets[i];
    const char* end = blob + offsets[i + 1];
    int32_t count = 0;
    int32_t* out = out_ids + i * cap;
    while (p < end && count < cap) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (is_word_char(c)) {
        const char* start = p;
        while (p < end && is_word_char(static_cast<unsigned char>(*p))) ++p;
        key.assign(start, static_cast<size_t>(p - start));
        auto it = map.find(key);
        out[count++] = (it == map.end()) ? 0 : it->second;
      } else if (is_punct_token(c)) {
        key.assign(1, *p);
        auto it = map.find(key);
        out[count++] = (it == map.end()) ? 0 : it->second;
        ++p;
      } else {
        ++p;
      }
    }
    out_lens[i] = count;
    total += count;
  }
  return total;
}

// Parse n lines of space-separated "<id>-<label>" impressions, mapping ids
// through `nidmap` (0 when unknown). cap ids per line.
int64_t fe_parse_impressions(void* nidmap, const char* blob,
                             const int64_t* offsets, int64_t n,
                             int32_t* out_rows, int8_t* out_labels,
                             int64_t cap, int32_t* out_lens) {
  auto& map = static_cast<StrMap*>(nidmap)->map;
  int64_t total = 0;
  std::string key;
  for (int64_t i = 0; i < n; ++i) {
    const char* p = blob + offsets[i];
    const char* end = blob + offsets[i + 1];
    int32_t count = 0;
    int32_t* rows = out_rows + i * cap;
    int8_t* labels = out_labels + i * cap;
    while (p < end && count < cap) {
      while (p < end && *p == ' ') ++p;
      const char* start = p;
      const char* dash = nullptr;
      while (p < end && *p != ' ') {
        if (*p == '-') dash = p;
        ++p;
      }
      if (p > start && dash && dash > start && dash + 1 < p) {
        key.assign(start, static_cast<size_t>(dash - start));
        auto it = map.find(key);
        rows[count] = (it == map.end()) ? 0 : it->second;
        labels[count] = static_cast<int8_t>(*(dash + 1) - '0');
        ++count;
      }
    }
    out_lens[i] = count;
    total += count;
  }
  return total;
}

// Parse n lines of space-separated ids, mapping through `nidmap`.
int64_t fe_parse_id_list(void* nidmap, const char* blob,
                         const int64_t* offsets, int64_t n, int32_t* out_rows,
                         int64_t cap, int32_t* out_lens) {
  auto& map = static_cast<StrMap*>(nidmap)->map;
  int64_t total = 0;
  std::string key;
  for (int64_t i = 0; i < n; ++i) {
    const char* p = blob + offsets[i];
    const char* end = blob + offsets[i + 1];
    int32_t count = 0;
    int32_t* rows = out_rows + i * cap;
    while (p < end && count < cap) {
      while (p < end && *p == ' ') ++p;
      const char* start = p;
      while (p < end && *p != ' ') ++p;
      if (p > start) {
        key.assign(start, static_cast<size_t>(p - start));
        auto it = map.find(key);
        rows[count++] = (it == map.end()) ? 0 : it->second;
      }
    }
    out_lens[i] = count;
    total += count;
  }
  return total;
}

}  // extern "C"
