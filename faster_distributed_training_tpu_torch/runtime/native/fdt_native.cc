// fdt_native: the host data path's native core, the port's copy of the
// JAX package's runtime/native/fdt_native.cc (the same C ABI and the same
// bytes out).
//
// The per-batch host work of the reference (HTML / URL strip, stopword
// removal and tokenization inside the DataLoader collate) in C++.  The
// Python implementations in data/text.py, data/wordpiece.py and
// data/loader.py stay the semantic reference and the fallback: every
// entry point here returns byte-identical results (tests/
// test_torch_native.py).  Built with g++ at first use and bound through
// ctypes by runtime/native_lib.py.
//
// C ABI:
//   fdt_clean_text      - tag / url strip + lowercase + [a-z0-9']+
//                         tokenization + stopword filter over already
//                         html-unescaped text (== data/text.py
//                         clean_text_py after html.unescape)
//   fdt_encode_batch    - cleaned text -> CLS + crc32-bucket ids + SEP,
//                         padded to max_len (== HashTokenizer.encode)
//   fdt_gather_u8       - index gather of uint8 rows into a contiguous
//                         batch buffer (the image batch collate)
//   fdt_crc32           - zlib-compatible CRC32
//   fdt_wp_load         - register a WordPiece vocabulary (newline-joined
//                         tokens, id = line index) -> handle
//   fdt_wp_encode_batch - greedy longest-match WordPiece over CLEANED
//                         ASCII text (== data/wordpiece.py
//                         WordPieceTokenizer.encode on clean_text_py's
//                         output); a fallback code on any byte outside
//                         the cleaned alphabet, so the Python path takes
//                         general Unicode
//   fdt_stopwords       - the vendored stopword list (for the tests)

#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------- crc32
uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32_of(const uint8_t* data, size_t len) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------- stopwords
// gensim's 337-word STOPWORDS, vendored verbatim (the reference filters
// with gensim.parsing.remove_stopwords, transformer_test.py:95).
// Must equal data/text.py STOPWORDS (tests/test_torch_native.py).
const char* kStopwords[] = {
    "a", "about", "above", "across", "after", "afterwards", "again",
    "against", "all", "almost", "alone", "along", "already", "also",
    "although", "always", "am", "among", "amongst", "amoungst", "amount",
    "an", "and", "another", "any", "anyhow", "anyone", "anything", "anyway",
    "anywhere", "are", "around", "as", "at", "back", "be", "became",
    "because", "become", "becomes", "becoming", "been", "before",
    "beforehand", "behind", "being", "below", "beside", "besides", "between",
    "beyond", "bill", "both", "bottom", "but", "by", "call", "can", "cannot",
    "cant", "co", "computer", "con", "could", "couldnt", "cry", "de",
    "describe", "detail", "did", "didn", "do", "does", "doesn", "doing",
    "don", "done", "down", "due", "during", "each", "eg", "eight", "either",
    "eleven", "else", "elsewhere", "empty", "enough", "etc", "even", "ever",
    "every", "everyone", "everything", "everywhere", "except", "few",
    "fifteen", "fifty", "fill", "find", "fire", "first", "five", "for",
    "former", "formerly", "forty", "found", "four", "from", "front", "full",
    "further", "get", "give", "go", "had", "has", "hasnt", "have", "he",
    "hence", "her", "here", "hereafter", "hereby", "herein", "hereupon",
    "hers", "herself", "him", "himself", "his", "how", "however", "hundred",
    "i", "ie", "if", "in", "inc", "indeed", "interest", "into", "is", "it",
    "its", "itself", "just", "keep", "kg", "km", "last", "latter", "latterly",
    "least", "less", "ltd", "made", "make", "many", "may", "me", "meanwhile",
    "might", "mill", "mine", "more", "moreover", "most", "mostly", "move",
    "much", "must", "my", "myself", "name", "namely", "neither", "never",
    "nevertheless", "next", "nine", "no", "nobody", "none", "noone", "nor",
    "not", "nothing", "now", "nowhere", "of", "off", "often", "on", "once",
    "one", "only", "onto", "or", "other", "others", "otherwise", "our",
    "ours", "ourselves", "out", "over", "own", "part", "per", "perhaps",
    "please", "put", "quite", "rather", "re", "really", "regarding", "same",
    "say", "see", "seem", "seemed", "seeming", "seems", "serious", "several",
    "she", "should", "show", "side", "since", "sincere", "six", "sixty", "so",
    "some", "somehow", "someone", "something", "sometime", "sometimes",
    "somewhere", "still", "such", "system", "take", "ten", "than", "that",
    "the", "their", "them", "themselves", "then", "thence", "there",
    "thereafter", "thereby", "therefore", "therein", "thereupon", "these",
    "they", "thick", "thin", "third", "this", "those", "though", "three",
    "through", "throughout", "thru", "thus", "to", "together", "too", "top",
    "toward", "towards", "twelve", "twenty", "two", "un", "under", "unless",
    "until", "up", "upon", "us", "used", "using", "various", "very", "via",
    "was", "we", "well", "were", "what", "whatever", "when", "whence",
    "whenever", "where", "whereafter", "whereas", "whereby", "wherein",
    "whereupon", "wherever", "whether", "which", "while", "whither", "who",
    "whoever", "whole", "whom", "whose", "why", "will", "with", "within",
    "without", "would", "yet", "you", "your", "yours", "yourself",
    "yourselves"};

const std::unordered_set<std::string>& stopword_set() {
  static const std::unordered_set<std::string> set(
      std::begin(kStopwords), std::end(kStopwords));
  return set;
}

// -------------------------------------------------- tag / url stripping
// HTML entity unescaping stays on the Python side (html.unescape's full
// HTML5 table cannot be reproduced partially without diverging) — this
// library receives ALREADY-UNESCAPED text (data/text.py clean_text).
std::string strip_tags(const std::string& in) {   // <[^>]+> -> ' '
  std::string out;
  out.reserve(in.size());
  size_t i = 0;
  while (i < in.size()) {
    if (in[i] == '<') {
      size_t close = in.find('>', i + 1);
      if (close != std::string::npos && close > i + 1) {
        out += ' ';
        i = close + 1;
        continue;
      }
    }
    out += in[i++];
  }
  return out;
}

bool starts_with(const std::string& s, size_t i, const char* pre) {
  size_t n = std::strlen(pre);
  return s.compare(i, n, pre) == 0;
}

bool is_space(char c) {
  // must match Python's \s for ASCII: [ \t\n\r\f\v]
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f'
         || c == '\v';
}

std::string strip_urls(const std::string& in) {
  // https?://\S+ | www\.\S+  (case-sensitive, pre-lowercase — matching
  // the Python regex exactly, data/text.py _URL_RE).  The \S+ requires at
  // least ONE non-space character after the prefix: a bare "http:// "
  // or trailing "www." does NOT match (and so survives into tokens).
  std::string out;
  out.reserve(in.size());
  size_t i = 0;
  while (i < in.size()) {
    size_t pre = 0;
    if (starts_with(in, i, "https://")) pre = 8;
    else if (starts_with(in, i, "http://")) pre = 7;
    else if (starts_with(in, i, "www.")) pre = 4;
    if (pre && i + pre < in.size() && !is_space(in[i + pre])) {
      out += ' ';
      i += pre;
      while (i < in.size() && !is_space(in[i])) ++i;
      continue;
    }
    out += in[i++];
  }
  return out;
}

bool is_token_char(char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '\'';
}

std::string clean_impl(const std::string& raw) {
  std::string text = strip_urls(strip_tags(raw));
  // lowercase (ASCII; non-ASCII bytes never match the token class)
  for (auto& c : text)
    if (c >= 'A' && c <= 'Z') c += 32;
  const auto& stop = stopword_set();
  std::string out, word;
  for (size_t i = 0; i <= text.size(); ++i) {
    char c = i < text.size() ? text[i] : ' ';
    if (is_token_char(c)) {
      word += c;
    } else if (!word.empty()) {
      if (!stop.count(word)) {
        if (!out.empty()) out += ' ';
        out += word;
      }
      word.clear();
    }
  }
  return out;
}

// ------------------------------------------------------------- wordpiece
struct WpVocab {
  std::unordered_map<std::string, int32_t> map;
};

// Registration and handle lookup are mutex-guarded: two tokenizer
// instances (e.g. train memoized + test from cache file) may register /
// encode concurrently under --workers, and push_back can reallocate the
// vector's element storage out from under a concurrent reader.  The
// unique_ptr indirection keeps each WpVocab itself at a stable address,
// so encode only needs the lock long enough to copy the pointer out.
std::vector<std::unique_ptr<WpVocab>>& wp_registry() {
  static std::vector<std::unique_ptr<WpVocab>> reg;
  return reg;
}

std::mutex& wp_mutex() {
  static std::mutex m;
  return m;
}

constexpr int kWpMaxCharsPerWord = 100;  // HF WordpieceTokenizer default

// Greedy longest-match-first segmentation of one word; appends piece ids
// (unk_id for an unsegmentable word).  Mirrors data/wordpiece.py
// wordpiece_word.
void wp_segment(const WpVocab& v, const std::string& word, int32_t unk_id,
                std::vector<int32_t>* out) {
  if (word.size() > kWpMaxCharsPerWord) {
    out->push_back(unk_id);
    return;
  }
  std::vector<int32_t> pieces;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      std::string piece = word.substr(start, end - start);
      if (start > 0) piece = "##" + piece;
      auto it = v.map.find(piece);
      if (it != v.map.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out->push_back(unk_id);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

uint32_t fdt_crc32(const uint8_t* data, int64_t len) {
  return crc32_of(data, static_cast<size_t>(len));
}

// Clean `in` into `out` (NUL-terminated).  Returns the cleaned length, or
// -(needed+1) if out_cap is too small.
int64_t fdt_clean_text(const char* in, char* out, int64_t out_cap) {
  std::string cleaned = clean_impl(in);
  int64_t need = static_cast<int64_t>(cleaned.size());
  if (need + 1 > out_cap) return -(need + 1);
  std::memcpy(out, cleaned.data(), cleaned.size());
  out[need] = '\0';
  return need;
}

// HashTokenizer.encode over a batch of ALREADY-CLEANED texts:
// ids = [CLS] + [crc32(word) % (vocab-999) + 999, ...][:max_len-2] + [SEP],
// right-padded with pad_id to max_len.  out_tokens: [n, max_len] int32,
// out_lens: [n] int32 (unpadded length incl. CLS/SEP).
int32_t fdt_encode_batch(const char** texts, int32_t n, int32_t max_len,
                         int32_t vocab_size, int32_t pad_id, int32_t cls_id,
                         int32_t sep_id, int32_t reserved,
                         int32_t* out_tokens, int32_t* out_lens) {
  if (max_len < 2 || vocab_size <= reserved) return -1;
  for (int32_t b = 0; b < n; ++b) {
    int32_t* row = out_tokens + static_cast<int64_t>(b) * max_len;
    int32_t pos = 0;
    row[pos++] = cls_id;
    const char* t = texts[b];
    size_t i = 0, len = std::strlen(t);
    while (i < len && pos < max_len - 1) {
      while (i < len && t[i] == ' ') ++i;
      size_t start = i;
      while (i < len && t[i] != ' ') ++i;
      if (i > start) {
        uint32_t h = crc32_of(reinterpret_cast<const uint8_t*>(t + start),
                              i - start) %
                     static_cast<uint32_t>(vocab_size - reserved);
        row[pos++] = static_cast<int32_t>(h) + reserved;
      }
    }
    row[pos++] = sep_id;
    out_lens[b] = pos;
    for (; pos < max_len; ++pos) row[pos] = pad_id;
  }
  return 0;
}

// Register a WordPiece vocabulary: `data[0:len)` is newline-joined tokens,
// id = line index (HF vocab.txt format).  Returns a handle >= 0.
int32_t fdt_wp_load(const char* data, int64_t len) {
  auto v = std::make_unique<WpVocab>();
  int32_t id = 0;
  int64_t start = 0;
  for (int64_t i = 0; i <= len; ++i) {
    if (i == len || data[i] == '\n') {
      if (i > start)
        v->map.emplace(std::string(data + start, i - start), id);
      ++id;
      start = i + 1;
    }
  }
  std::lock_guard<std::mutex> lock(wp_mutex());
  wp_registry().push_back(std::move(v));
  return static_cast<int32_t>(wp_registry().size()) - 1;
}

// WordPiece-encode a batch of CLEANED texts ([a-z0-9' ] alphabet, the
// clean_text output): per word, apostrophes split off as punctuation
// tokens (HF BasicTokenizer._run_split_on_punc restricted to the cleaned
// alphabet), then greedy longest-match.  Frame per row:
// [CLS] + pieces[:max_len-2] + [SEP], right-padded with pad_id.
// Returns 0 ok, -1 bad args, -2 when a text contains a byte outside the
// cleaned alphabet (caller must fall back to the Python reference, which
// handles full Unicode).
int32_t fdt_wp_encode_batch(int32_t handle, const char** texts, int32_t n,
                            int32_t max_len, int32_t cls_id, int32_t sep_id,
                            int32_t unk_id, int32_t pad_id,
                            int32_t* out_tokens, int32_t* out_lens) {
  if (handle < 0 || max_len < 2) return -1;
  const WpVocab* vp = nullptr;
  {
    std::lock_guard<std::mutex> lock(wp_mutex());
    if (handle >= static_cast<int32_t>(wp_registry().size())) return -1;
    vp = wp_registry()[handle].get();  // stable address past the lock
  }
  const WpVocab& v = *vp;
  std::vector<int32_t> ids;
  std::string word;
  for (int32_t b = 0; b < n; ++b) {
    ids.clear();
    const char* t = texts[b];
    size_t len = std::strlen(t);
    for (size_t i = 0; i < len; ++i) {
      char c = t[i];
      bool ok = (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') ||
                c == '\'' || c == ' ';
      if (!ok) return -2;
    }
    word.clear();
    for (size_t i = 0; i <= len; ++i) {
      char c = i < len ? t[i] : ' ';
      if (c == ' ' || c == '\'') {
        if (!word.empty()) {
          wp_segment(v, word, unk_id, &ids);
          word.clear();
        }
        if (c == '\'') wp_segment(v, "'", unk_id, &ids);
      } else {
        word += c;
      }
    }
    int32_t* row = out_tokens + static_cast<int64_t>(b) * max_len;
    int32_t body = static_cast<int32_t>(ids.size());
    if (body > max_len - 2) body = max_len - 2;
    int32_t pos = 0;
    row[pos++] = cls_id;
    for (int32_t i = 0; i < body; ++i) row[pos++] = ids[i];
    row[pos++] = sep_id;
    out_lens[b] = pos;
    for (; pos < max_len; ++pos) row[pos] = pad_id;
  }
  return 0;
}

// Dump the vendored stopword list, newline-joined, into `out`
// (NUL-terminated).  Returns the written length, or -(needed+1) when
// out_cap is too small.  Exists so tests can assert exact set equality
// between kStopwords and data/text.py STOPWORDS instead of inferring
// it from cleaner behavior.
int64_t fdt_stopwords(char* out, int64_t out_cap) {
  std::string joined;
  for (const char* w : kStopwords) {
    if (!joined.empty()) joined += '\n';
    joined += w;
  }
  int64_t need = static_cast<int64_t>(joined.size());
  if (need + 1 > out_cap) return -(need + 1);
  std::memcpy(out, joined.data(), joined.size());
  out[need] = '\0';
  return need;
}

// Gather `n` rows of `row_bytes` each from `src` at `indices` into `dst`
// (the image-batch collate: dst[i] = src[indices[i]]).
int32_t fdt_gather_u8(const uint8_t* src, const int64_t* indices, int32_t n,
                      int64_t row_bytes, uint8_t* dst) {
  for (int32_t i = 0; i < n; ++i)
    std::memcpy(dst + static_cast<int64_t>(i) * row_bytes,
                src + indices[i] * row_bytes, row_bytes);
  return 0;
}

}  // extern "C"
