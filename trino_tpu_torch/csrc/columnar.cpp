// The port's host-side native tier (C ABI, loaded via ctypes by
// trino_tpu_torch/native.py): the two entry points the port calls,
//
//   - tt_dict_encode: dictionary encoding of a varchar batch (string ->
//     dense int32 code, first-seen order);
//   - tt_tpch_textpool: the TPC-H dbgen text pool that comment columns
//     slice.
//
// Copied from the reference engine's native/columnar.cpp (the same code,
// so codes and pool bytes equal the reference's); the reference's integer
// codecs, compression and ORC/Parquet decoders are not part of the port.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (driven by native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" {


// ===== dictionary encode ====================================================
// Strings are given as a concatenated UTF-8 buffer + (n+1) offsets.
// Produces: codes[i] = dense id of string i (first-seen order), and
// first_occurrence[j] = row index introducing code j. Returns #unique.
// (MultiChannelGroupByHash-style open addressing, FILL_RATIO 0.5.)

static inline uint64_t hash_bytes(const char* p, int64_t len) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (int64_t i = 0; i < len; i++) {
        h ^= (unsigned char)p[i];
        h *= 1099511628211ull;
    }
    return h;
}

int64_t tt_dict_encode(const char* bytes, const int64_t* offsets, int64_t n,
                       int32_t* codes, int64_t* first_occurrence) {
    if (n <= 0) return 0;
    int64_t cap = 16;
    while (cap < n * 2) cap <<= 1;
    std::vector<int64_t> table(cap, -1);  // slot -> first row of that string
    std::vector<int32_t> slot_code(cap, -1);
    const uint64_t mask = (uint64_t)cap - 1;
    int64_t n_unique = 0;
    for (int64_t i = 0; i < n; i++) {
        const char* s = bytes + offsets[i];
        const int64_t len = offsets[i + 1] - offsets[i];
        uint64_t slot = hash_bytes(s, len) & mask;
        for (;;) {
            int64_t row = table[slot];
            if (row < 0) {  // new string
                table[slot] = i;
                slot_code[slot] = (int32_t)n_unique;
                first_occurrence[n_unique] = i;
                codes[i] = (int32_t)n_unique;
                n_unique++;
                break;
            }
            const int64_t rlen = offsets[row + 1] - offsets[row];
            if (rlen == len && memcmp(bytes + offsets[row], s, (size_t)len) == 0) {
                codes[i] = slot_code[slot];
                break;
            }
            slot = (slot + 1) & mask;
        }
    }
    return n_unique;
}

}  // extern "C"


// ---------------------------------------------------------------------------
// TPC-H dbgen text pool: grammar-driven sentence stream from weighted word
// distributions, drawn from one Lehmer stream (seed' = seed*16807 mod 2^31-1).
// The distribution tables arrive serialized from Python so the word lists
// live in one place (trino_tpu/connectors/dbgen.py).
// Blob layout per distribution: i32 n_entries, then per entry
// { i32 weight, i32 len, bytes }. Distribution order:
// grammar, np, vp, nouns, verbs, adjectives, adverbs, prepositions,
// auxiliaries, terminators.

namespace tpch_text {

struct Entry { int32_t weight; std::string text; };
struct Dist {
    std::vector<Entry> entries;
    std::vector<int64_t> cum;
    int64_t total = 0;
    void finish() {
        cum.reserve(entries.size());
        int64_t c = 0;
        for (auto& e : entries) { c += e.weight; cum.push_back(c); }
        total = c;
    }
};

static const int64_t kM = 2147483647;
static const int64_t kA = 16807;

struct Rng {
    int64_t seed;
    int64_t next() { seed = (seed * kA) % kM; return seed; }
    int64_t bounded(int64_t lo, int64_t hi) {
        int64_t range = hi - lo + 1;
        next();
        return lo + (int64_t)(((double)seed / (double)kM) * (double)range);
    }
};

static const std::string& pick(Dist& d, Rng& rng) {
    int64_t v = rng.bounded(0, d.total - 1);
    size_t idx = std::upper_bound(d.cum.begin(), d.cum.end(), v) - d.cum.begin();
    return d.entries[idx].text;
}

struct Builder {
    uint8_t* out;
    int64_t size;
    int64_t len = 0;
    void append(const std::string& s) {
        for (char c : s) { if (len < size) out[len] = (uint8_t)c; len++; }
    }
    void append(char c) { if (len < size) out[len] = (uint8_t)c; len++; }
    char last() const {
        if (len == 0) return '\0';
        int64_t i = len <= size ? len - 1 : size - 1;
        return (char)out[i];
    }
    void erase1() { if (len > 0) len--; }
};

static void word_phrase(Dist& syntax_dist, Dist* word_dists[], Rng& rng, Builder& b) {
    // syntax like "J, J N": letters pick words, ',' and ' ' are literal
    const std::string& syntax = pick(syntax_dist, rng);
    for (char c : syntax) {
        if (c == ',') { b.append(','); }
        else if (c == ' ') { b.append(' '); }
        else { b.append(pick(*word_dists[(unsigned char)c], rng)); }
    }
}

}  // namespace tpch_text

extern "C" {

// Generates `size` bytes of pool into `out`. Returns bytes written, or -1
// on malformed blob.
int64_t tt_tpch_textpool(uint8_t* out, int64_t size, const uint8_t* blob,
                         int64_t blob_len, int64_t seed) {
    using namespace tpch_text;
    std::vector<Dist> dists;
    int64_t p = 0;
    auto rd32 = [&](int32_t* v) -> bool {
        if (p + 4 > blob_len) return false;
        std::memcpy(v, blob + p, 4);
        p += 4;
        return true;
    };
    for (int d = 0; d < 10; d++) {
        int32_t n;
        if (!rd32(&n)) return -1;
        if (n < 1) return -1;
        Dist dist;
        dist.entries.reserve(n);
        for (int32_t i = 0; i < n; i++) {
            int32_t w, len;
            if (!rd32(&w) || !rd32(&len)) return -1;
            if (w < 1 || len < 0 || p + len > blob_len) return -1;
            dist.entries.push_back({w, std::string((const char*)blob + p, (size_t)len)});
            p += len;
        }
        dist.finish();
        dists.push_back(std::move(dist));
    }
    Dist& grammar = dists[0];
    Dist& np = dists[1];
    Dist& vp = dists[2];
    Dist* words[128] = {nullptr};
    words['N'] = &dists[3];
    words['V'] = &dists[4];
    words['J'] = &dists[5];
    words['D'] = &dists[6];
    Dist& prepositions = dists[7];
    Dist* aux_words[128] = {nullptr};
    aux_words['V'] = &dists[4];
    aux_words['X'] = &dists[8];
    aux_words['D'] = &dists[6];
    Dist& terminators = dists[9];

    Rng rng{seed};
    Builder b{out, size};
    while (b.len < size) {
        const std::string& syntax = pick(grammar, rng);
        for (size_t i = 0; i < syntax.size(); i += 2) {
            switch (syntax[i]) {
                case 'V': word_phrase(vp, aux_words, rng, b); break;
                case 'N': word_phrase(np, words, rng, b); break;
                case 'P': {
                    b.append(pick(prepositions, rng));
                    b.append(std::string(" the "));
                    word_phrase(np, words, rng, b);
                    break;
                }
                case 'T': {
                    b.erase1();
                    b.append(pick(terminators, rng));
                    break;
                }
            }
            if (b.last() != ' ') b.append(' ');
        }
    }
    return size;
}

}  // extern "C"
