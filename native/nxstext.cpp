// Native host text pipeline: ASCII word segmentation + normalizer +
// stopwords + Porter2 stemming, with per-document token aggregation.
//
// The reference engine's ingest hot loop is native C (ICU word break +
// filter pipeline per token, src/core/tokenizer.c:234-302); this is the
// JAX rebuild's native equivalent for the host side.  It implements the
// ASCII subset of the Python pipeline bit-for-bit (UAX#29 word rules
// restricted to ASCII classes, ASCII lowercase, the Porter2 algorithm
// of text/porter2.py); any text containing a non-ASCII byte is rejected
// with -1 and the caller falls back to the Python implementation, so
// behavior is identical on every input.
//
// C ABI (ctypes-friendly):
//   void* nxs_text_ctx_new(int flags, const char* stopwords, long n);
//   void  nxs_text_ctx_free(void*);
//   long  nxs_text_process(void* ctx, const char* text, long len,
//                          char* out_tokens, long out_cap,
//                          int* out_counts, long counts_cap,
//                          long* out_seen, long* out_nbytes);
// Returns the number of unique tokens (first-seen order, NUL-separated
// in out_tokens, per-token counts in out_counts, total surviving token
// count in *out_seen), -1 for non-ASCII input, -2 if a buffer is small.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// ASCII word-break classes (text/wordbreak.py restricted to ASCII).
// ---------------------------------------------------------------------
enum WbClass : unsigned char {
  OTHER = 0, CR, LF, NEWLINE, ALETTER, SINGLE_QUOTE, DOUBLE_QUOTE,
  MIDNUMLET, MIDLETTER, MIDNUM, NUMERIC, EXTENDNUMLET, WSEGSPACE,
};

struct ClassTable {
  unsigned char cls[128];
  ClassTable() {
    std::memset(cls, OTHER, sizeof(cls));
    cls['\r'] = CR;
    cls['\n'] = LF;
    cls[0x0B] = NEWLINE;
    cls[0x0C] = NEWLINE;
    cls['\''] = SINGLE_QUOTE;
    cls['"'] = DOUBLE_QUOTE;
    cls['.'] = MIDNUMLET;
    cls[':'] = MIDLETTER;
    cls[','] = MIDNUM;
    cls[';'] = MIDNUM;
    cls['_'] = EXTENDNUMLET;
    cls[' '] = WSEGSPACE;  // tab is control -> OTHER, like the Python
    for (int c = '0'; c <= '9'; c++) cls[c] = NUMERIC;
    for (int c = 'a'; c <= 'z'; c++) cls[c] = ALETTER;
    for (int c = 'A'; c <= 'Z'; c++) cls[c] = ALETTER;
  }
};
const ClassTable kClasses;

inline bool is_mid_letter_q(unsigned char c) {
  return c == MIDLETTER || c == MIDNUMLET || c == SINGLE_QUOTE;
}
inline bool is_mid_num_q(unsigned char c) {
  return c == MIDNUM || c == MIDNUMLET || c == SINGLE_QUOTE;
}

// Word boundary before position i (ASCII classes: no Extend/Format/ZWJ
// skipping needed, WB7a-c never fire).  Mirrors wordbreak._is_break.
inline bool is_break(const unsigned char* cls, long n, long i) {
  unsigned char right = cls[i];
  unsigned char left = cls[i - 1];
  if (left == CR && right == LF) return false;                 // WB3
  if (left == CR || left == LF || left == NEWLINE ||
      right == CR || right == LF || right == NEWLINE)
    return true;                                               // WB3a/b
  if (left == WSEGSPACE && right == WSEGSPACE) return false;   // WB3d
  unsigned char ll = (i >= 2) ? cls[i - 2]
                              : static_cast<unsigned char>(OTHER);
  unsigned char rr = (i + 1 < n) ? cls[i + 1]
                                 : static_cast<unsigned char>(OTHER);
  if (left == ALETTER && right == ALETTER) return false;       // WB5
  if (left == ALETTER && is_mid_letter_q(right) && rr == ALETTER)
    return false;                                              // WB6
  if (is_mid_letter_q(left) && right == ALETTER && ll == ALETTER)
    return false;                                              // WB7
  if (left == NUMERIC && right == NUMERIC) return false;       // WB8
  if (left == ALETTER && right == NUMERIC) return false;       // WB9
  if (left == NUMERIC && right == ALETTER) return false;       // WB10
  if (is_mid_num_q(left) && right == NUMERIC && ll == NUMERIC)
    return false;                                              // WB11
  if (left == NUMERIC && is_mid_num_q(right) && rr == NUMERIC)
    return false;                                              // WB12
  if ((left == ALETTER || left == NUMERIC || left == EXTENDNUMLET) &&
      right == EXTENDNUMLET)
    return false;                                              // WB13a
  if (left == EXTENDNUMLET && (right == ALETTER || right == NUMERIC))
    return false;                                              // WB13b
  return true;                                                 // WB999
}

// ---------------------------------------------------------------------
// Porter2 stemmer: a C++ port of text/porter2.py (itself implementing
// the published Snowball "english" algorithm).  Same steps, same
// exceptional forms, same Y-marking sentinel.
// ---------------------------------------------------------------------
inline bool p2_is_vowel_ch(char c) {
  return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' ||
         c == 'y';  // lowercase y only; 'Y' sentinel is a consonant
}

inline bool ends_with(const std::string& w, const char* suf, size_t len) {
  return w.size() >= len && std::memcmp(w.data() + w.size() - len, suf,
                                        len) == 0;
}

void p2_regions(const std::string& w, size_t* r1, size_t* r2) {
  size_t n = w.size();
  *r1 = n;
  static const char* kPrefixes[] = {"gener", "commun", "arsen"};
  bool prefixed = false;
  for (const char* p : kPrefixes) {
    size_t pl = std::strlen(p);
    if (n >= pl && std::memcmp(w.data(), p, pl) == 0) {
      *r1 = pl;
      prefixed = true;
      break;
    }
  }
  if (!prefixed) {
    for (size_t i = 1; i < n; i++) {
      if (!p2_is_vowel_ch(w[i]) && p2_is_vowel_ch(w[i - 1])) {
        *r1 = i + 1;
        break;
      }
    }
  }
  *r2 = n;
  for (size_t i = *r1 + 1; i < n; i++) {
    if (!p2_is_vowel_ch(w[i]) && p2_is_vowel_ch(w[i - 1])) {
      *r2 = i + 1;
      break;
    }
  }
}

bool p2_ends_short_syllable(const std::string& w) {
  size_t n = w.size();
  if (n == 2)
    return p2_is_vowel_ch(w[0]) && !p2_is_vowel_ch(w[1]);
  if (n >= 3)
    return !p2_is_vowel_ch(w[n - 3]) && p2_is_vowel_ch(w[n - 2]) &&
           !p2_is_vowel_ch(w[n - 1]) && w[n - 1] != 'w' &&
           w[n - 1] != 'x' && w[n - 1] != 'Y';
  return false;
}

bool p2_has_vowel(const std::string& w, size_t end) {
  for (size_t i = 0; i < end && i < w.size(); i++)
    if (p2_is_vowel_ch(w[i])) return true;
  return false;
}

struct Except {
  const char* from;
  const char* to;
};
static const Except kExceptions[] = {
    {"skis", "ski"},   {"skies", "sky"},   {"dying", "die"},
    {"lying", "lie"},  {"tying", "tie"},   {"idly", "idl"},
    {"gently", "gentl"}, {"ugly", "ugli"}, {"early", "earli"},
    {"only", "onli"},  {"singly", "singl"}, {"sky", "sky"},
    {"news", "news"},  {"howe", "howe"},   {"atlas", "atlas"},
    {"cosmos", "cosmos"}, {"bias", "bias"}, {"andes", "andes"},
};
static const char* kExceptions1a[] = {
    "inning", "outing", "canning", "herring", "earring",
    "proceed", "exceed", "succeed",
};

std::string porter2_stem(std::string word) {
  if (word.size() <= 2) return word;

  for (const Except& e : kExceptions)
    if (word == e.from) return e.to;

  if (word[0] == '\'') {
    word.erase(0, 1);
    if (word.size() <= 2) return word;
  }
  // Mark consonant-y as 'Y' (after a vowel, or word-initial).
  if (word[0] == 'y') word[0] = 'Y';
  for (size_t i = 1; i < word.size(); i++) {
    char prev = word[i - 1];
    bool prev_vowel = (prev == 'a' || prev == 'e' || prev == 'i' ||
                       prev == 'o' || prev == 'u' || prev == 'y');
    if (word[i] == 'y' && prev_vowel) word[i] = 'Y';
  }

  size_t r1, r2;
  p2_regions(word, &r1, &r2);

  // Step 0: longest among 's' | 's | '
  if (ends_with(word, "'s'", 3)) word.resize(word.size() - 3);
  else if (ends_with(word, "'s", 2)) word.resize(word.size() - 2);
  else if (ends_with(word, "'", 1)) word.resize(word.size() - 1);

  // Step 1a.
  if (ends_with(word, "sses", 4)) {
    word.resize(word.size() - 2);
  } else if (ends_with(word, "ied", 3) || ends_with(word, "ies", 3)) {
    word.resize(word.size() - 3);
    word += (word.size() + 3 > 4) ? "i" : "ie";
  } else if (ends_with(word, "us", 2) || ends_with(word, "ss", 2)) {
    // keep
  } else if (ends_with(word, "s", 1)) {
    if (word.size() >= 2 && p2_has_vowel(word, word.size() - 2))
      word.resize(word.size() - 1);
  }

  for (const char* e : kExceptions1a)
    if (word == e) return word;

  // Step 1b.
  {
    static const char* kSufs[] = {"eedly", "ingly", "edly",
                                  "eed",   "ing",   "ed"};
    const char* suffix = nullptr;
    size_t slen = 0;
    for (const char* s : kSufs) {
      size_t l = std::strlen(s);
      if (ends_with(word, s, l)) {
        suffix = s;
        slen = l;
        break;
      }
    }
    if (suffix && (std::strcmp(suffix, "eed") == 0 ||
                   std::strcmp(suffix, "eedly") == 0)) {
      if (word.size() - slen >= r1) {
        word.resize(word.size() - slen);
        word += "ee";
      }
    } else if (suffix) {
      std::string stemmed = word.substr(0, word.size() - slen);
      if (p2_has_vowel(stemmed, stemmed.size())) {
        word = stemmed;
        static const char* kDoubles[] = {"bb", "dd", "ff", "gg", "mm",
                                         "nn", "pp", "rr", "tt"};
        bool doubled = false;
        for (const char* d : kDoubles)
          if (ends_with(word, d, 2)) { doubled = true; break; }
        if (ends_with(word, "at", 2) || ends_with(word, "bl", 2) ||
            ends_with(word, "iz", 2)) {
          word += "e";
        } else if (doubled) {
          word.resize(word.size() - 1);
        } else if (r1 >= word.size() && p2_ends_short_syllable(word)) {
          word += "e";
        }
      }
    }
  }

  // Step 1c.
  if (word.size() > 2) {
    char last = word[word.size() - 1];
    char prev = word[word.size() - 2];
    bool prev_vowel = (prev == 'a' || prev == 'e' || prev == 'i' ||
                       prev == 'o' || prev == 'u' || prev == 'y');
    if ((last == 'y' || last == 'Y') && !prev_vowel)
      word[word.size() - 1] = 'i';
  }

  auto in_r1 = [&](size_t sl) { return word.size() - sl >= r1; };
  auto in_r2 = [&](size_t sl) { return word.size() - sl >= r2; };

  // Step 2.
  {
    struct Rule { const char* suf; const char* repl; };
    static const Rule kStep2[] = {
        {"ational", "ate"}, {"fulness", "ful"}, {"iveness", "ive"},
        {"ization", "ize"}, {"ousness", "ous"}, {"biliti", "ble"},
        {"lessli", "less"}, {"tional", "tion"}, {"alism", "al"},
        {"aliti", "al"},    {"ation", "ate"},   {"entli", "ent"},
        {"fulli", "ful"},   {"iviti", "ive"},   {"ousli", "ous"},
        {"abli", "able"},   {"alli", "al"},     {"anci", "ance"},
        {"ator", "ate"},    {"enci", "ence"},   {"izer", "ize"},
        {"bli", "ble"},     {"ogi", nullptr},   {"li", nullptr},
    };
    for (const Rule& rule : kStep2) {
      size_t sl = std::strlen(rule.suf);
      if (!ends_with(word, rule.suf, sl)) continue;
      if (std::strcmp(rule.suf, "ogi") == 0) {
        if (in_r1(3) && word.size() > 3 && word[word.size() - 4] == 'l')
          word.resize(word.size() - 1);
      } else if (std::strcmp(rule.suf, "li") == 0) {
        static const std::string kLi = "cdeghkmnrt";
        if (in_r1(2) && word.size() > 2 &&
            kLi.find(word[word.size() - 3]) != std::string::npos)
          word.resize(word.size() - 2);
      } else if (in_r1(sl)) {
        word.resize(word.size() - sl);
        word += rule.repl;
      }
      break;
    }
  }

  // Step 3.
  {
    struct Rule { const char* suf; const char* repl; };
    static const Rule kStep3[] = {
        {"ational", "ate"}, {"tional", "tion"}, {"alize", "al"},
        {"icate", "ic"},    {"iciti", "ic"},    {"ative", ""},
        {"ical", "ic"},     {"ness", ""},       {"ful", ""},
    };
    for (const Rule& rule : kStep3) {
      size_t sl = std::strlen(rule.suf);
      if (!ends_with(word, rule.suf, sl)) continue;
      if (std::strcmp(rule.suf, "ative") == 0) {
        if (in_r2(5)) word.resize(word.size() - 5);
      } else if (in_r1(sl)) {
        word.resize(word.size() - sl);
        word += rule.repl;
      }
      break;
    }
  }

  // Step 4.
  {
    static const char* kStep4[] = {"ement", "ance", "ence", "able",
                                   "ible",  "ment", "ant",  "ent",
                                   "ism",   "ate",  "iti",  "ous",
                                   "ive",   "ize",  "ion",  "al",
                                   "er",    "ic"};
    for (const char* suf : kStep4) {
      size_t sl = std::strlen(suf);
      if (!ends_with(word, suf, sl)) continue;
      if (in_r2(sl)) {
        if (std::strcmp(suf, "ion") == 0) {
          if (word.size() > 3) {
            char c = word[word.size() - 4];
            if (c == 's' || c == 't') word.resize(word.size() - 3);
          }
        } else {
          word.resize(word.size() - sl);
        }
      }
      break;
    }
  }

  // Step 5.
  if (ends_with(word, "e", 1)) {
    if (in_r2(1)) {
      word.resize(word.size() - 1);
    } else if (in_r1(1)) {
      std::string trimmed = word.substr(0, word.size() - 1);
      if (!p2_ends_short_syllable(trimmed)) word.resize(word.size() - 1);
    }
  } else if (ends_with(word, "l", 1)) {
    if (in_r2(1) && word.size() > 1 && word[word.size() - 2] == 'l')
      word.resize(word.size() - 1);
  }

  for (char& c : word)
    if (c == 'Y') c = 'y';
  return word;
}

// ---------------------------------------------------------------------
// FastMap: open-addressing byte-string map with a flat arena.
//
// std::unordered_map<std::string, size_t> was measured at ~500 ns per
// lookup in the ingest hot loop (node allocations + pointer-chased
// string compares); this table keeps keys contiguous in one arena and
// probes linearly over two flat vectors, and is the backbone of the
// token memo that makes repeated tokens cost one lookup total.
// ---------------------------------------------------------------------
struct FastMap {
  struct Entry {
    uint32_t off;
    uint32_t len;
    int32_t val;
  };
  std::vector<uint64_t> slot_hash;  // 0 = empty slot
  std::vector<int32_t> slot_entry;
  std::vector<Entry> entries;
  std::string arena;
  size_t mask = 0;

  FastMap() { reset(); }

  void reset() {
    slot_hash.assign(1 << 12, 0);
    slot_entry.assign(1 << 12, -1);
    entries.clear();
    arena.clear();
    mask = (1 << 12) - 1;
  }

  static uint64_t hash_bytes(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a 64
    for (size_t i = 0; i < n; i++) {
      h ^= static_cast<unsigned char>(s[i]);
      h *= 1099511628211ull;
    }
    return h | 1;  // nonzero: 0 marks an empty slot
  }

  void grow() {
    size_t ncap = (mask + 1) * 2;
    std::vector<uint64_t> nh(ncap, 0);
    std::vector<int32_t> ne(ncap, -1);
    size_t nmask = ncap - 1;
    for (size_t i = 0; i <= mask; i++) {
      if (!slot_hash[i]) continue;
      size_t j = slot_hash[i] & nmask;
      while (nh[j]) j = (j + 1) & nmask;
      nh[j] = slot_hash[i];
      ne[j] = slot_entry[i];
    }
    slot_hash.swap(nh);
    slot_entry.swap(ne);
    mask = nmask;
  }

  // Entry index for the key, inserting (val = -2) when absent.
  int32_t find_or_add(const char* s, size_t n, bool* created) {
    if (entries.size() * 2 >= mask + 1) grow();
    uint64_t h = hash_bytes(s, n);
    size_t j = h & mask;
    while (slot_hash[j]) {
      if (slot_hash[j] == h) {
        const Entry& e = entries[static_cast<size_t>(slot_entry[j])];
        if (e.len == n && std::memcmp(arena.data() + e.off, s, n) == 0) {
          *created = false;
          return slot_entry[j];
        }
      }
      j = (j + 1) & mask;
    }
    Entry e{static_cast<uint32_t>(arena.size()),
            static_cast<uint32_t>(n), -2};
    arena.append(s, n);
    int32_t idx = static_cast<int32_t>(entries.size());
    entries.push_back(e);
    slot_hash[j] = h;
    slot_entry[j] = idx;
    *created = true;
    return idx;
  }

  const char* str(int32_t idx, uint32_t* len) const {
    const Entry& e = entries[static_cast<size_t>(idx)];
    *len = e.len;
    return arena.data() + e.off;
  }
};

// ---------------------------------------------------------------------
// Pipeline context.
// ---------------------------------------------------------------------
constexpr int kFlagNormalizer = 1;
constexpr int kFlagStopwords = 2;
constexpr int kFlagStemmer = 4;

// Clear the memo/intern tables past this many entries (correctness-
// neutral: they are pure caches of a deterministic filter chain).
constexpr size_t kMemoCapEntries = size_t(1) << 23;

struct TextCtx {
  int flags;
  std::unordered_set<std::string> stopwords;

  // Token memo: post-normalization token bytes -> resolved result.
  // val >= 0: id in `terms` of the filtered output; -1: DISCARD
  // (stopword or empty stem).  Persists across calls, so the full
  // filter chain (stopword probe + Porter2) runs once per unique
  // token ever seen by this context.
  FastMap memo;
  // Final-term interner: filtered term bytes -> stable id (the entry
  // index).  Output strings are copied out of its arena.
  FastMap terms;

  // Reusable per-call scratch (callers serialize calls per ctx).
  std::vector<int32_t> batch_idx;      // term id -> batch table index
  std::vector<int32_t> batch_touched;  // term ids stamped this call
  std::vector<int32_t> local_pos;      // batch index -> doc pair slot
  std::vector<int32_t> local_touched;  // batch indexes stamped per doc
  std::string token;                   // normalized-token scratch

  void maybe_trim_caches() {
    if (memo.entries.size() > kMemoCapEntries ||
        terms.entries.size() > kMemoCapEntries) {
      memo.reset();
      terms.reset();
      batch_idx.clear();
    }
  }
};

// Run the filter chain on one segmented token (already in ctx->token,
// pre-normalization) through the memo.  Returns the `terms` id of the
// filtered output, or -1 for DISCARD.
inline int32_t resolve_token(TextCtx* ctx) {
  std::string& token = ctx->token;
  if (ctx->flags & kFlagNormalizer) {
    for (char& c : token)
      if (c >= 'A' && c <= 'Z') c += 'a' - 'A';
  }
  bool created;
  int32_t mi = ctx->memo.find_or_add(token.data(), token.size(), &created);
  if (!created) return ctx->memo.entries[static_cast<size_t>(mi)].val;

  int32_t val = -1;
  if (!((ctx->flags & kFlagStopwords) && !ctx->stopwords.empty() &&
        ctx->stopwords.count(token))) {
    std::string out = token;
    if (ctx->flags & kFlagStemmer) out = porter2_stem(std::move(out));
    if (!out.empty()) {
      bool created2;
      val = ctx->terms.find_or_add(out.data(), out.size(), &created2);
    }
  }
  ctx->memo.entries[static_cast<size_t>(mi)].val = val;
  return val;
}

}  // namespace

extern "C" {

void* nxs_text_ctx_new(int flags, const char* stopwords, long sw_len) {
  TextCtx* ctx = new TextCtx;
  ctx->flags = flags;
  if (stopwords && sw_len > 0) {
    const char* p = stopwords;
    const char* end = stopwords + sw_len;
    while (p < end) {
      const char* nl = static_cast<const char*>(
          std::memchr(p, '\n', static_cast<size_t>(end - p)));
      size_t len = nl ? static_cast<size_t>(nl - p)
                      : static_cast<size_t>(end - p);
      if (len > 0) ctx->stopwords.emplace(p, len);
      p += len + 1;
    }
  }
  return ctx;
}

void nxs_text_ctx_free(void* ctx) { delete static_cast<TextCtx*>(ctx); }

long nxs_text_process(void* vctx, const char* text, long len,
                      char* out_tokens, long out_cap, int* out_counts,
                      long counts_cap, long* out_seen,
                      long* out_nbytes) {
  TextCtx* ctx = static_cast<TextCtx*>(vctx);
  const unsigned char* u = reinterpret_cast<const unsigned char*>(text);

  // ASCII gate: any high byte -> caller uses the Python pipeline.
  for (long i = 0; i < len; i++)
    if (u[i] >= 0x80) return -1;

  std::vector<unsigned char> cls(static_cast<size_t>(len));
  for (long i = 0; i < len; i++) cls[static_cast<size_t>(i)] =
      kClasses.cls[u[i]];

  ctx->maybe_trim_caches();
  // uniq[i] = terms id of the i-th first-seen unique token; counts
  // parallel.  ctx->batch_idx (terms id -> uniq position) is stamped
  // through batch_touched and reset before returning.
  std::vector<int32_t> uniq;
  std::vector<int> counts;
  long seen = 0;

  auto emit = [&](long s, long e) {
    // Segment "is word" check: contains a letter or digit.
    bool wordy = false;
    for (long i = s; i < e; i++) {
      unsigned char c = cls[static_cast<size_t>(i)];
      if (c == ALETTER || c == NUMERIC) { wordy = true; break; }
    }
    if (!wordy) return;
    ctx->token.assign(text + s, static_cast<size_t>(e - s));
    int32_t tid = resolve_token(ctx);
    if (tid < 0) return;
    seen++;
    if (static_cast<size_t>(tid) >= ctx->batch_idx.size())
      ctx->batch_idx.resize(ctx->terms.entries.size(), -1);
    int32_t pos = ctx->batch_idx[static_cast<size_t>(tid)];
    if (pos < 0) {
      pos = static_cast<int32_t>(uniq.size());
      ctx->batch_idx[static_cast<size_t>(tid)] = pos;
      ctx->batch_touched.push_back(tid);
      uniq.push_back(tid);
      counts.push_back(1);
    } else {
      counts[static_cast<size_t>(pos)]++;
    }
  };

  if (len > 0) {
    long start = 0;
    for (long i = 1; i < len; i++) {
      if (is_break(cls.data(), len, i)) {
        emit(start, i);
        start = i;
      }
    }
    emit(start, len);
  }
  for (int32_t tid : ctx->batch_touched)
    ctx->batch_idx[static_cast<size_t>(tid)] = -1;
  ctx->batch_touched.clear();

  // Serialize.
  long need = 0;
  for (int32_t tid : uniq) {
    uint32_t tl;
    ctx->terms.str(tid, &tl);
    need += static_cast<long>(tl) + 1;
  }
  if (need > out_cap || static_cast<long>(uniq.size()) > counts_cap)
    return -2;
  char* w = out_tokens;
  for (int32_t tid : uniq) {
    uint32_t tl;
    const char* ts = ctx->terms.str(tid, &tl);
    std::memcpy(w, ts, tl);
    w += tl;
    *w++ = '\0';
  }
  for (size_t i = 0; i < counts.size(); i++) out_counts[i] = counts[i];
  *out_seen = seen;
  *out_nbytes = need;
  return static_cast<long>(uniq.size());
}

long nxs_text_process_batch(void* vctx, const char* texts,
                            const long* doc_off, long n_docs,
                            char* out_table, long table_cap,
                            long* out_table_n, long* out_table_bytes,
                            unsigned* out_pairs, long pairs_cap,
                            long* out_doc_ptr, unsigned* out_seen) {
  // Whole-batch ingest tokenization: one call per add_many() batch.
  // Documents are concatenated in `texts` with doc_off[i]..doc_off[i+1]
  // boundaries.  Produces a batch-level string table of unique tokens
  // (NUL-separated, first-seen order) and, per document, flattened
  // (table_index, count) pairs delimited by out_doc_ptr, plus the
  // surviving token count (seen).  A document containing non-ASCII
  // bytes contributes no pairs and gets seen == 0xFFFFFFFF: the
  // caller reprocesses just those through the Python pipeline.
  // Returns 0, or -2 when a buffer is too small (caller grows+retries).
  TextCtx* ctx = static_cast<TextCtx*>(vctx);
  ctx->maybe_trim_caches();

  // table_order[i] = terms id of the i-th first-seen unique token of
  // the batch; ctx->batch_idx maps terms id -> batch table index and
  // ctx->local_pos maps batch table index -> the doc's pair slot, both
  // stamped through touched lists and reset on the way out.
  std::vector<int32_t> table_order;
  std::vector<unsigned> pairs;  // (table_idx, count) flattened
  ctx->local_pos.clear();
  std::vector<unsigned char> cls;

  long pair_ptr = 0;
  for (long d = 0; d < n_docs; d++) {
    out_doc_ptr[d] = pair_ptr;
    const char* text = texts + doc_off[d];
    long len = doc_off[d + 1] - doc_off[d];
    const unsigned char* u = reinterpret_cast<const unsigned char*>(text);

    bool ascii = true;
    for (long i = 0; i < len; i++)
      if (u[i] >= 0x80) { ascii = false; break; }
    if (!ascii) {
      out_seen[d] = 0xFFFFFFFFu;
      continue;
    }

    cls.resize(static_cast<size_t>(len));
    for (long i = 0; i < len; i++)
      cls[static_cast<size_t>(i)] = kClasses.cls[u[i]];

    unsigned seen = 0;
    auto emit = [&](long s, long e) {
      bool wordy = false;
      for (long i = s; i < e; i++) {
        unsigned char c = cls[static_cast<size_t>(i)];
        if (c == ALETTER || c == NUMERIC) { wordy = true; break; }
      }
      if (!wordy) return;
      ctx->token.assign(text + s, static_cast<size_t>(e - s));
      int32_t tid = resolve_token(ctx);
      if (tid < 0) return;
      seen++;
      if (static_cast<size_t>(tid) >= ctx->batch_idx.size())
        ctx->batch_idx.resize(ctx->terms.entries.size(), -1);
      int32_t tix = ctx->batch_idx[static_cast<size_t>(tid)];
      if (tix < 0) {
        tix = static_cast<int32_t>(table_order.size());
        ctx->batch_idx[static_cast<size_t>(tid)] = tix;
        ctx->batch_touched.push_back(tid);
        table_order.push_back(tid);
        ctx->local_pos.push_back(-1);
      }
      int32_t lp = ctx->local_pos[static_cast<size_t>(tix)];
      if (lp < 0) {
        ctx->local_pos[static_cast<size_t>(tix)] =
            static_cast<int32_t>(pairs.size() / 2);
        ctx->local_touched.push_back(tix);
        pairs.push_back(static_cast<unsigned>(tix));
        pairs.push_back(1);
      } else {
        pairs[static_cast<size_t>(lp) * 2 + 1]++;
      }
    };

    if (len > 0) {
      long start = 0;
      for (long i = 1; i < len; i++) {
        if (is_break(cls.data(), len, i)) {
          emit(start, i);
          start = i;
        }
      }
      emit(start, len);
    }
    for (int32_t tix : ctx->local_touched)
      ctx->local_pos[static_cast<size_t>(tix)] = -1;
    ctx->local_touched.clear();
    out_seen[d] = seen;
    pair_ptr = static_cast<long>(pairs.size() / 2);
  }
  out_doc_ptr[n_docs] = pair_ptr;
  for (int32_t tid : ctx->batch_touched)
    ctx->batch_idx[static_cast<size_t>(tid)] = -1;
  ctx->batch_touched.clear();

  long need_bytes = 0;
  for (int32_t tid : table_order) {
    uint32_t tl;
    ctx->terms.str(tid, &tl);
    need_bytes += static_cast<long>(tl) + 1;
  }
  if (need_bytes > table_cap ||
      static_cast<long>(pairs.size()) > pairs_cap)
    return -2;
  char* w = out_table;
  for (int32_t tid : table_order) {
    uint32_t tl;
    const char* ts = ctx->terms.str(tid, &tl);
    std::memcpy(w, ts, tl);
    w += tl;
    *w++ = '\0';
  }
  if (!pairs.empty())
    std::memcpy(out_pairs, pairs.data(), pairs.size() * sizeof(unsigned));
  *out_table_n = static_cast<long>(table_order.size());
  *out_table_bytes = need_bytes;
  return 0;
}

long nxs_text_filter_tokens(void* vctx, const char* blob,
                            const long* offs, long n, char* out,
                            long out_cap, long* out_offs,
                            signed char* status) {
  // Batch form of nxs_text_filter_token: token i is
  // blob[offs[i], offs[i+1]); filtered bytes are concatenated into
  // ``out`` with out_offs[i+1] marking each token's end.  status[i]:
  // 1 = filtered (range in out), 0 = DISCARD, -1 = non-ASCII (the
  // caller runs the Python pipeline).  Returns 0, or -2 when ``out``
  // is too small.  One call amortizes the FFI overhead that
  // dominates per-token calls from the query batch path.
  TextCtx* ctx = static_cast<TextCtx*>(vctx);
  long w = 0;
  out_offs[0] = 0;
  for (long t = 0; t < n; t++) {
    const char* value = blob + offs[t];
    const long len = offs[t + 1] - offs[t];
    const unsigned char* u = reinterpret_cast<const unsigned char*>(value);
    bool ascii = true;
    for (long i = 0; i < len; i++) {
      if (u[i] >= 0x80) { ascii = false; break; }
    }
    if (!ascii) {
      status[t] = -1;
      out_offs[t + 1] = w;
      continue;
    }
    ctx->token.assign(value, static_cast<size_t>(len));
    int32_t tid = resolve_token(ctx);
    if (tid < 0) {
      status[t] = 0;
      out_offs[t + 1] = w;
      continue;
    }
    uint32_t tl;
    const char* ts = ctx->terms.str(tid, &tl);
    if (w + static_cast<long>(tl) > out_cap) return -2;
    std::memcpy(out + w, ts, tl);
    w += static_cast<long>(tl);
    status[t] = 1;
    out_offs[t + 1] = w;
  }
  return 0;
}

long nxs_text_filter_token(void* vctx, const char* value, long len,
                           char* out, long out_cap) {
  // Run the filter chain on ONE token without segmentation -- the
  // query-preparation path (tokenize_value runs each query leaf
  // through the pipeline whole, src/core/tokenizer.c:205-227).
  // Returns the output length, 0 for DISCARD, -1 for non-ASCII input,
  // -2 if the buffer is too small.
  TextCtx* ctx = static_cast<TextCtx*>(vctx);
  const unsigned char* u = reinterpret_cast<const unsigned char*>(value);
  for (long i = 0; i < len; i++)
    if (u[i] >= 0x80) return -1;

  ctx->token.assign(value, static_cast<size_t>(len));
  int32_t tid = resolve_token(ctx);
  if (tid < 0) return 0;
  uint32_t tl;
  const char* ts = ctx->terms.str(tid, &tl);
  if (static_cast<long>(tl) > out_cap) return -2;
  std::memcpy(out, ts, tl);
  return static_cast<long>(tl);
}

}  // extern "C"
