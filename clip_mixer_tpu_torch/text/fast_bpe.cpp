// Fast CLIP BPE tokenizer: a C++ core with a plain C interface, loaded with
// ctypes by text/fast.py.
//
// The port's copy of clip_mixer_tpu/text/fast_bpe.cpp. It must give exactly
// the tokens of the port's Python tokenizer (text/bpe.py), which follows the
// reference's case-insensitive pre-tokenizer:
//
//   <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
//   |[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+
//
// Design:
// * Symbols are vocab ids (int32). A word starts as per-byte ids (non-final
//   and final-with-</w> variants, passed in from Python), and merges are
//   (a, b) -> (rank, merged id), so the merge loop handles no strings.
// * The pre-tokenizer is a scanner over codepoints with three tables built
//   in Python from text/bpe.py's own classifiers: letter (\p{L}), number
//   (\p{N}) and gap (\s, and U+0345, which case-insensitive matching keeps
//   out of the negated class as a case variant of iota), one bit a
//   codepoint; and fold, one byte a codepoint: the ASCII character that
//   ch.lower() (with U+017F folded to 's') is, or 0. The literals are
//   matched with fold after their first character, as bpe.py does; that is
//   how U+017F completes "'s" and "'t" and the specials.
// * Input is already normalized (ftfy, HTML unescape, whitespace, lowercase)
//   in Python.
// * Per-token memoization, as the Python tokenizer's cache; a mutex guards it.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kNumCodepoints = 0x110000u;

struct PairHash {
  size_t operator()(const std::pair<int32_t, int32_t>& p) const {
    return (static_cast<size_t>(p.first) << 21) ^ static_cast<size_t>(p.second);
  }
};

struct Bpe {
  int32_t init_nonfinal[256];
  int32_t init_final[256];
  std::unordered_map<std::pair<int32_t, int32_t>, std::pair<int32_t, int32_t>, PairHash>
      merges;  // (a, b) -> (rank, merged id)
  std::vector<uint8_t> letter, number, gap;  // bitsets over the codepoints
  std::vector<uint8_t> fold;                 // one byte a codepoint
  int32_t sot, eot;
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex cache_mu;
};

inline bool test_bit(const std::vector<uint8_t>& mask, uint32_t cp) {
  if (cp >= kNumCodepoints) return false;
  return (mask[cp >> 3] >> (cp & 7)) & 1;
}

inline char fold_of(const Bpe& bpe, uint32_t cp) {
  return cp < kNumCodepoints ? static_cast<char>(bpe.fold[cp]) : 0;
}

// Decode one UTF-8 codepoint at s[i]; advances i. Python encodes valid
// UTF-8, so the fallback (one byte as Latin-1) is never taken.
inline uint32_t decode_utf8(const unsigned char* s, size_t n, size_t& i) {
  unsigned char c = s[i];
  if (c < 0x80) { i += 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < n) { uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F); i += 2; return cp; }
  if ((c >> 4) == 0xE && i + 2 < n) { uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F); i += 3; return cp; }
  if ((c >> 3) == 0x1E && i + 3 < n) { uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) | ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F); i += 4; return cp; }
  i += 1; return c;
}

// Greedy lowest-rank merge loop: find the adjacent pair of the smallest
// rank, merge every occurrence of it in one sweep, repeat.
void merge_word(const Bpe& bpe, std::vector<int32_t>& sym) {
  while (sym.size() > 1) {
    int32_t best_rank = INT32_MAX, best_id = -1;
    for (size_t i = 0; i + 1 < sym.size(); ++i) {
      auto it = bpe.merges.find({sym[i], sym[i + 1]});
      if (it != bpe.merges.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_id = it->second.second;
      }
    }
    if (best_id < 0) break;
    size_t w = 0;
    for (size_t i = 0; i < sym.size();) {
      if (i + 1 < sym.size()) {
        auto it = bpe.merges.find({sym[i], sym[i + 1]});
        if (it != bpe.merges.end() && it->second.first == best_rank) {
          sym[w++] = it->second.second;
          i += 2;
          continue;
        }
      }
      sym[w++] = sym[i++];
    }
    sym.resize(w);
  }
}

void encode_token(Bpe& bpe, const unsigned char* tok, size_t len, std::vector<int32_t>& out) {
  std::string key(reinterpret_cast<const char*>(tok), len);
  {
    // ctypes releases the GIL around bpe_encode_batch and the handle is one
    // per process, so concurrent callers (a source's decode threads, the
    // server's request threads) share this cache.
    std::lock_guard<std::mutex> g(bpe.cache_mu);
    auto it = bpe.cache.find(key);
    if (it != bpe.cache.end()) {
      out.insert(out.end(), it->second.begin(), it->second.end());
      return;
    }
  }
  std::vector<int32_t> sym;
  sym.reserve(len);
  for (size_t i = 0; i < len; ++i)
    sym.push_back(i + 1 == len ? bpe.init_final[tok[i]] : bpe.init_nonfinal[tok[i]]);
  merge_word(bpe, sym);
  {
    std::lock_guard<std::mutex> g(bpe.cache_mu);
    bpe.cache.emplace(std::move(key), sym);
  }
  out.insert(out.end(), sym.begin(), sym.end());
}

const char kSot[] = "<|startoftext|>";
const char kEot[] = "<|endoftext|>";

// The byte length of the literal `lit` matched at s[i], or 0: its first
// character exactly, each later codepoint through fold.
size_t match_literal(const Bpe& bpe, const unsigned char* s, size_t n, size_t i, const char* lit) {
  size_t len = std::strlen(lit);
  if (i >= n || s[i] != static_cast<unsigned char>(lit[0])) return 0;
  size_t j = i + 1;
  for (size_t k = 1; k < len; ++k) {
    if (j >= n) return 0;
    if (fold_of(bpe, decode_utf8(s, n, j)) != lit[k]) return 0;
  }
  return j - i;
}

// Pre-tokenize and BPE one normalized UTF-8 text into ids.
void encode_text(Bpe& bpe, const unsigned char* s, size_t n, std::vector<int32_t>& out) {
  static const char* kSpecials[] = {kSot, kEot};
  static const char* kContractions[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
  size_t i = 0;
  while (i < n) {
    size_t matched = 0;
    if (s[i] == '<') {
      for (const char* lit : kSpecials)
        if ((matched = match_literal(bpe, s, n, i, lit))) break;
    } else if (s[i] == '\'') {
      for (const char* lit : kContractions)
        if ((matched = match_literal(bpe, s, n, i, lit))) break;
    }
    if (matched) {
      // the specials' own spelling is their id; a folded spelling is a word
      if (matched == sizeof(kSot) - 1 && std::memcmp(s + i, kSot, matched) == 0)
        out.push_back(bpe.sot);
      else if (matched == sizeof(kEot) - 1 && std::memcmp(s + i, kEot, matched) == 0)
        out.push_back(bpe.eot);
      else
        encode_token(bpe, s + i, matched, out);
      i += matched;
      continue;
    }
    size_t start = i;
    uint32_t cp = decode_utf8(s, n, i);
    if (test_bit(bpe.letter, cp)) {  // [\p{L}]+
      size_t end = i;
      while (end < n) {
        size_t j = end;
        if (!test_bit(bpe.letter, decode_utf8(s, n, j))) break;
        end = j;
      }
      encode_token(bpe, s + start, end - start, out);
      i = end;
    } else if (test_bit(bpe.number, cp)) {  // one [\p{N}]
      encode_token(bpe, s + start, i - start, out);
    } else if (test_bit(bpe.gap, cp)) {
      // no token
    } else {  // [^\s\p{L}\p{N}]+, greedy: it takes apostrophes and '<' too
      size_t end = i;
      while (end < n) {
        size_t j = end;
        uint32_t c2 = decode_utf8(s, n, j);
        if (test_bit(bpe.letter, c2) || test_bit(bpe.number, c2) || test_bit(bpe.gap, c2)) break;
        end = j;
      }
      encode_token(bpe, s + start, end - start, out);
      i = end;
    }
  }
}

}  // namespace

extern "C" {

void* bpe_create(const int32_t* init_nonfinal, const int32_t* init_final, int n_merges,
                 const int32_t* merge_a, const int32_t* merge_b, const int32_t* merge_out,
                 const uint8_t* letter, const uint8_t* number, const uint8_t* gap,
                 const uint8_t* fold, int32_t sot, int32_t eot) {
  auto* bpe = new Bpe();
  std::memcpy(bpe->init_nonfinal, init_nonfinal, 256 * sizeof(int32_t));
  std::memcpy(bpe->init_final, init_final, 256 * sizeof(int32_t));
  bpe->merges.reserve(n_merges * 2);
  for (int i = 0; i < n_merges; ++i) bpe->merges[{merge_a[i], merge_b[i]}] = {i, merge_out[i]};
  const size_t bits = kNumCodepoints / 8;
  bpe->letter.assign(letter, letter + bits);
  bpe->number.assign(number, number + bits);
  bpe->gap.assign(gap, gap + bits);
  bpe->fold.assign(fold, fold + kNumCodepoints);
  bpe->sot = sot;
  bpe->eot = eot;
  return bpe;
}

void bpe_destroy(void* h) { delete static_cast<Bpe*>(h); }

// Drop the per-word memo (cold timings; bounded memory for callers feeding
// unbounded unique text).
void bpe_clear_cache(void* h) {
  auto* bpe = static_cast<Bpe*>(h);
  std::lock_guard<std::mutex> g(bpe->cache_mu);
  bpe->cache.clear();
}

// Encode a batch of normalized UTF-8 texts (concatenated, with offsets) into
// a zero-padded [n, context_length] int32 matrix of <sot> + BPE + <eot>;
// with truncate, an over-long row is clipped and ends in <eot>. Returns -1,
// or without truncate the index of the first text that is too long.
int bpe_encode_batch(void* h, const char* buf, const int64_t* offsets, int n,
                     int context_length, int truncate, int32_t* out) {
  auto* bpe = static_cast<Bpe*>(h);
  std::vector<int32_t> ids;
  for (int t = 0; t < n; ++t) {
    ids.clear();
    ids.push_back(bpe->sot);
    encode_text(*bpe, reinterpret_cast<const unsigned char*>(buf) + offsets[t],
                static_cast<size_t>(offsets[t + 1] - offsets[t]), ids);
    ids.push_back(bpe->eot);
    if (static_cast<int>(ids.size()) > context_length) {
      if (!truncate) return t;
      ids.resize(context_length);
      ids[context_length - 1] = bpe->eot;
    }
    int32_t* row = out + static_cast<int64_t>(t) * context_length;
    std::memset(row, 0, context_length * sizeof(int32_t));
    std::memcpy(row, ids.data(), ids.size() * sizeof(int32_t));
  }
  return -1;
}

}  // extern "C"
