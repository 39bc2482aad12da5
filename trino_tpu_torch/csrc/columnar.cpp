// The port's host-side native tier (C ABI, loaded via ctypes by
// trino_tpu_torch/native.py). Copied from the reference engine's
// native/columnar.cpp, every entry point, so codes, codec streams and pool
// bytes equal the reference's:
//
//   - tt_dict_encode: dictionary encoding of a varchar batch (string ->
//     dense int32 code, first-seen order);
//   - varint, RLE and bit-pack integer codecs (the pages wire format);
//   - LZ and Snappy compression;
//   - the Parquet RLE/bit-pack hybrid (definition levels, dictionary
//     indices), both directions;
//   - ORC RLEv1, RLEv2, byte-RLE and decimal64 decoding, and the ORC
//     RLEv2, byte-RLE and varint encoders;
//   - tt_tpch_textpool: the TPC-H dbgen text pool that comment columns
//     slice;
//   - tt_pack_arena: the reference's word-aligned staging arena.
//
// The port adds tt_scatter_segments, which fills the pinned host buffer of
// one coalesced host-to-device copy (trino_tpu_torch/ingest.py) at offsets
// the caller aligns.
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

// ===== integer codecs =======================================================
// Zigzag varint: small signed deltas -> few bytes (PagesSerde's long
// encodings analog). Returns bytes written; out must hold 10*n bytes.

static inline uint64_t zigzag(int64_t v) {
    return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}
static inline int64_t unzigzag(uint64_t u) {
    return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
}

int64_t tt_varint_encode(const int64_t* values, int64_t n, uint8_t* out) {
    uint8_t* p = out;
    int64_t prev = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t u = zigzag(values[i] - prev);  // delta encoding
        prev = values[i];
        while (u >= 0x80) {
            *p++ = (uint8_t)(u | 0x80);
            u >>= 7;
        }
        *p++ = (uint8_t)u;
    }
    return p - out;
}

// Returns bytes consumed, or -1 if the input is truncated/corrupt.
int64_t tt_varint_decode(const uint8_t* in, int64_t in_len, int64_t n_values,
                         int64_t* out) {
    const uint8_t* p = in;
    const uint8_t* end = in + in_len;
    int64_t prev = 0;
    for (int64_t i = 0; i < n_values; i++) {
        uint64_t u = 0;
        int shift = 0;
        for (;;) {
            if (p >= end || shift > 63) return -1;
            uint8_t b = *p++;
            u |= (uint64_t)(b & 0x7f) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        prev += unzigzag(u);
        out[i] = prev;
    }
    return p - in;
}

// RLE: (run_len varint, value varint) pairs. Good for sorted/constant
// columns (RunLengthEncodedBlock analog). Returns bytes written.

int64_t tt_rle_encode(const int64_t* values, int64_t n, uint8_t* out) {
    uint8_t* p = out;
    int64_t i = 0;
    while (i < n) {
        int64_t run = 1;
        while (i + run < n && values[i + run] == values[i]) run++;
        uint64_t u = (uint64_t)run;
        while (u >= 0x80) { *p++ = (uint8_t)(u | 0x80); u >>= 7; }
        *p++ = (uint8_t)u;
        u = zigzag(values[i]);
        while (u >= 0x80) { *p++ = (uint8_t)(u | 0x80); u >>= 7; }
        *p++ = (uint8_t)u;
        i += run;
    }
    return p - out;
}

// Returns bytes consumed, or -1 if the input is truncated/corrupt.
int64_t tt_rle_decode(const uint8_t* in, int64_t in_len, int64_t n_values,
                      int64_t* out) {
    const uint8_t* p = in;
    const uint8_t* end = in + in_len;
    int64_t i = 0;
    while (i < n_values) {
        uint64_t run = 0, u = 0;
        int shift = 0;
        for (;;) { if (p >= end || shift > 63) return -1;
                   uint8_t b = *p++; run |= (uint64_t)(b & 0x7f) << shift;
                   if (!(b & 0x80)) break; shift += 7; }
        shift = 0;
        for (;;) { if (p >= end || shift > 63) return -1;
                   uint8_t b = *p++; u |= (uint64_t)(b & 0x7f) << shift;
                   if (!(b & 0x80)) break; shift += 7; }
        if (run == 0) return -1;
        int64_t v = unzigzag(u);
        for (uint64_t r = 0; r < run && i < n_values; r++) out[i++] = v;
    }
    return p - in;
}

// Bitpack: n values of fixed bit_width (caller computes width from max).
// Returns bytes written = ceil(n*width/8).

int64_t tt_bitpack_encode(const uint64_t* values, int64_t n, int32_t width,
                          uint8_t* out) {
    int64_t nbytes = (n * width + 7) / 8;
    memset(out, 0, (size_t)nbytes);
    int64_t bit = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t v = values[i];
        for (int32_t b = 0; b < width; b++, bit++) {
            if ((v >> b) & 1) out[bit >> 3] |= (uint8_t)(1u << (bit & 7));
        }
    }
    return nbytes;
}

void tt_bitpack_decode(const uint8_t* in, int64_t n, int32_t width,
                       uint64_t* out) {
    int64_t bit = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t v = 0;
        for (int32_t b = 0; b < width; b++, bit++) {
            if ((in[bit >> 3] >> (bit & 7)) & 1) v |= (1ull << b);
        }
        out[i] = v;
    }
}

// ===== byte compression =====================================================
// LZ-style with 64Ki hash table, greedy matching (format: literal runs +
// (offset,len) copies). The PagesSerde LZ4-compression analog for
// spill/exchange pages. Self-inverse pair; not LZ4-frame compatible.

int64_t tt_lz_compress(const uint8_t* in, int64_t n, uint8_t* out) {
    // token: 1 byte — high bit 0: literal run (len = tok+1, max 128)
    //                 high bit 1: match (len = (tok&0x7f)+4), then 2-byte LE offset
    if (n == 0) return 0;
    std::vector<int64_t> table(1 << 16, -1);
    uint8_t* op = out;
    int64_t i = 0, lit_start = 0;
    auto flush_literals = [&](int64_t end) {
        int64_t len = end - lit_start;
        while (len > 0) {
            int64_t take = len > 128 ? 128 : len;
            *op++ = (uint8_t)(take - 1);
            memcpy(op, in + lit_start, (size_t)take);
            op += take;
            lit_start += take;
            len -= take;
        }
    };
    while (i + 4 <= n) {
        uint32_t key;
        memcpy(&key, in + i, 4);
        uint32_t h = (key * 2654435761u) >> 16;
        int64_t cand = table[h];
        table[h] = i;
        if (cand >= 0 && i - cand <= 0xffff &&
            memcmp(in + cand, in + i, 4) == 0) {
            int64_t len = 4;
            while (i + len < n && len < 131 && in[cand + len] == in[i + len]) len++;
            flush_literals(i);
            *op++ = (uint8_t)(0x80 | (len - 4));
            uint16_t off = (uint16_t)(i - cand);
            *op++ = (uint8_t)(off & 0xff);
            *op++ = (uint8_t)(off >> 8);
            i += len;
            lit_start = i;
        } else {
            i++;
        }
    }
    flush_literals(n);
    return op - out;
}

// Returns bytes written, or -1 on truncated/corrupt input or out_cap
// overflow (bounds-checked: pages arrive over the network).
int64_t tt_lz_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                         int64_t out_cap) {
    const uint8_t* ip = in;
    const uint8_t* end = in + in_len;
    uint8_t* op = out;
    const uint8_t* out_end = out + out_cap;
    while (ip < end) {
        uint8_t tok = *ip++;
        if (tok & 0x80) {
            int64_t len = (tok & 0x7f) + 4;
            if (ip + 2 > end || op + len > out_end) return -1;
            uint16_t off = (uint16_t)(ip[0] | (ip[1] << 8));
            ip += 2;
            if (off == 0 || op - off < out) return -1;
            uint8_t* src = op - off;
            for (int64_t k = 0; k < len; k++) op[k] = src[k];  // may overlap
            op += len;
        } else {
            int64_t len = tok + 1;
            if (ip + len > end || op + len > out_end) return -1;
            memcpy(op, ip, (size_t)len);
            ip += len;
            op += len;
        }
    }
    return op - out;
}

}  // extern "C"

extern "C" {

// ===== Parquet host decode ==================================================
// Reference: lib/trino-parquet (from-scratch reader: row-group pruning,
// dictionary/RLE decoding — ParquetReader.java:65,161). Host tier decodes
// pages into fixed-width arrays the device ingests directly.

// Snappy block-format decompression (format spec: varint length +
// literal/copy tagged elements). Returns decompressed size or -1.
int64_t tt_snappy_decompress(const uint8_t* in, int64_t in_len,
                             uint8_t* out, int64_t out_cap) {
    int64_t ip = 0, op = 0;
    // preamble: uncompressed length varint
    uint64_t ulen = 0;
    int shift = 0;
    while (ip < in_len) {
        uint8_t b = in[ip++];
        ulen |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if ((int64_t)ulen > out_cap) return -1;
    while (ip < in_len) {
        uint8_t tag = in[ip++];
        uint32_t kind = tag & 3;
        if (kind == 0) {  // literal
            int64_t len = (tag >> 2) + 1;
            if ((tag >> 2) >= 60) {
                int n_bytes = (tag >> 2) - 59;  // 1..4 length bytes
                if (ip + n_bytes > in_len) return -1;
                uint32_t l = 0;
                for (int i = 0; i < n_bytes; i++) l |= (uint32_t)in[ip + i] << (8 * i);
                len = (int64_t)l + 1;
                ip += n_bytes;
            }
            if (ip + len > in_len || op + len > out_cap) return -1;
            std::memcpy(out + op, in + ip, len);
            ip += len;
            op += len;
        } else {
            int64_t len, offset;
            if (kind == 1) {  // copy with 1-byte offset
                if (ip + 1 > in_len) return -1;
                len = ((tag >> 2) & 7) + 4;
                offset = ((int64_t)(tag >> 5) << 8) | in[ip];
                ip += 1;
            } else if (kind == 2) {  // 2-byte offset
                if (ip + 2 > in_len) return -1;
                len = (tag >> 2) + 1;
                offset = (int64_t)in[ip] | ((int64_t)in[ip + 1] << 8);
                ip += 2;
            } else {  // 4-byte offset
                if (ip + 4 > in_len) return -1;
                len = (tag >> 2) + 1;
                offset = (int64_t)in[ip] | ((int64_t)in[ip + 1] << 8) |
                         ((int64_t)in[ip + 2] << 16) | ((int64_t)in[ip + 3] << 24);
                ip += 4;
            }
            if (offset <= 0 || offset > op || op + len > out_cap) return -1;
            // overlapping copies are byte-by-byte by spec
            for (int64_t i = 0; i < len; i++) {
                out[op] = out[op - offset];
                op++;
            }
        }
    }
    return op;
}

// Snappy compression: literal-only emission (valid, ~1.0 ratio; the
// writer favors simplicity — real compression is the LZ codec's job).
int64_t tt_snappy_compress(const uint8_t* in, int64_t n, uint8_t* out) {
    int64_t op = 0;
    uint64_t len = (uint64_t)n;
    while (len >= 0x80) {
        out[op++] = (uint8_t)(len | 0x80);
        len >>= 7;
    }
    out[op++] = (uint8_t)len;
    int64_t ip = 0;
    while (ip < n) {
        int64_t chunk = n - ip < 65536 ? n - ip : 65536;
        int64_t l = chunk - 1;
        if (l < 60) {
            out[op++] = (uint8_t)(l << 2);
        } else {
            out[op++] = (uint8_t)(61 << 2);  // 61 => two length bytes
            out[op++] = (uint8_t)(l & 0xff);
            out[op++] = (uint8_t)((l >> 8) & 0xff);
        }
        std::memcpy(out + op, in + ip, chunk);
        op += chunk;
        ip += chunk;
    }
    return op;
}

// Parquet RLE/bit-packed hybrid decoder (definition levels + dictionary
// indices; format: <varint header> runs — LSB run type).
int64_t tt_parquet_rle_decode(const uint8_t* in, int64_t in_len,
                              int32_t bit_width, int64_t n_values,
                              int32_t* out) {
    int64_t ip = 0, op = 0;
    int64_t byte_width = (bit_width + 7) / 8;
    while (op < n_values && ip < in_len) {
        // varint header
        uint64_t header = 0;
        int shift = 0;
        while (ip < in_len) {
            uint8_t b = in[ip++];
            header |= (uint64_t)(b & 0x7f) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        if (header & 1) {  // bit-packed run: (header>>1) groups of 8
            int64_t count = (int64_t)(header >> 1) * 8;
            int64_t bits_avail = (in_len - ip) * 8;
            uint64_t acc = 0;
            int acc_bits = 0;
            for (int64_t i = 0; i < count; i++) {
                while (acc_bits < bit_width && ip < in_len) {
                    acc |= (uint64_t)in[ip++] << acc_bits;
                    acc_bits += 8;
                }
                if (acc_bits < bit_width) return -1;
                if (op < n_values)
                    out[op++] = (int32_t)(acc & ((bit_width == 32)
                                                     ? 0xffffffffull
                                                     : ((1ull << bit_width) - 1)));
                acc >>= bit_width;
                acc_bits -= bit_width;
            }
            (void)bits_avail;
        } else {  // RLE run: value in ceil(bw/8) little-endian bytes
            int64_t count = (int64_t)(header >> 1);
            uint32_t v = 0;
            if (ip + byte_width > in_len) return -1;
            for (int64_t i = 0; i < byte_width; i++) v |= (uint32_t)in[ip + i] << (8 * i);
            ip += byte_width;
            for (int64_t i = 0; i < count && op < n_values; i++) out[op++] = (int32_t)v;
        }
    }
    return op;
}

// Parquet RLE encoder (RLE runs only — used for def levels / dict indices
// by our writer; readers accept pure-RLE streams).
int64_t tt_parquet_rle_encode(const int32_t* values, int64_t n,
                              int32_t bit_width, uint8_t* out) {
    int64_t byte_width = (bit_width + 7) / 8;
    int64_t op = 0, i = 0;
    while (i < n) {
        int64_t j = i;
        while (j < n && values[j] == values[i]) j++;
        uint64_t header = (uint64_t)(j - i) << 1;  // RLE run
        while (header >= 0x80) {
            out[op++] = (uint8_t)(header | 0x80);
            header >>= 7;
        }
        out[op++] = (uint8_t)header;
        uint32_t v = (uint32_t)values[i];
        for (int64_t b = 0; b < byte_width; b++) out[op++] = (uint8_t)(v >> (8 * b));
        i = j;
    }
    return op;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ORC integer decoders (hot path of lib/trino-orc's RunLengthIntegerReaderV2,
// reimplemented from the public ORC spec).

namespace orc_rle {

static inline int fbw(int code) {
    if (code <= 23) return code + 1;
    static const int tail[] = {26, 28, 30, 32, 40, 48, 56, 64};
    return tail[code - 24];
}

static inline int closest_fixed_bits(int n) {
    if (n <= 24) return n < 1 ? 1 : n;
    if (n <= 26) return 26;
    if (n <= 28) return 28;
    if (n <= 30) return 30;
    if (n <= 32) return 32;
    if (n <= 40) return 40;
    if (n <= 48) return 48;
    if (n <= 56) return 56;
    return 64;
}

struct BitReader {
    const uint8_t* buf;
    int64_t pos;        // byte position
    int64_t end;        // buffer length (reads past it set `bad`)
    int bit = 0;        // bits consumed within current byte
    bool bad = false;
    uint64_t take(int width) {
        uint64_t v = 0;
        int need = width;
        while (need > 0) {
            if (pos >= end) { bad = true; return 0; }
            int avail = 8 - bit;
            int n = need < avail ? need : avail;
            int shift = avail - n;
            v = (v << n) | (uint64_t)((buf[pos] >> shift) & ((1u << n) - 1));
            bit += n;
            need -= n;
            if (bit == 8) { bit = 0; pos++; }
        }
        return v;
    }
    void align() { if (bit) { bit = 0; pos++; } }
};

// Bounds- and shift-checked varint (mirrors tt_varint_decode's guards).
static inline bool read_varint(const uint8_t* buf, int64_t* pos, int64_t end,
                               uint64_t* out) {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
        if (*pos >= end || shift > 63) return false;
        uint8_t b = buf[(*pos)++];
        v |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *out = v; return true; }
        shift += 7;
    }
}

}  // namespace orc_rle

extern "C" {

// Decode `count` RLEv2 integers; returns bytes consumed or -1.
int64_t tt_orc_rle2(const uint8_t* buf, int64_t buf_len, int64_t count,
                    int32_t is_signed, int64_t* out) {
    using namespace orc_rle;
    int64_t pos = 0, filled = 0;
    while (filled < count) {
        if (pos >= buf_len) return -1;
        uint8_t first = buf[pos];
        int enc = first >> 6;
        if (enc == 0) {  // SHORT_REPEAT
            int width = ((first >> 3) & 0x7) + 1;
            int repeat = (first & 0x7) + 3;
            pos += 1;
            if (pos + width > buf_len) return -1;
            uint64_t u = 0;
            for (int i = 0; i < width; i++) u = (u << 8) | buf[pos++];
            int64_t val = is_signed ? unzigzag(u) : (int64_t)u;
            for (int i = 0; i < repeat && filled < count; i++) out[filled++] = val;
        } else if (enc == 1) {  // DIRECT
            if (pos + 1 >= buf_len) return -1;
            int width = fbw((first >> 1) & 0x1F);
            int length = (((int)(first & 1) << 8) | buf[pos + 1]) + 1;
            BitReader br{buf, pos + 2, buf_len};
            for (int i = 0; i < length && filled < count; i++) {
                uint64_t u = br.take(width);
                out[filled++] = is_signed ? unzigzag(u) : (int64_t)u;
            }
            if (br.bad) return -1;
            br.align();
            pos = br.pos;
            continue;
        } else if (enc == 3) {  // DELTA
            if (pos + 1 >= buf_len) return -1;
            int wcode = (first >> 1) & 0x1F;
            int width = wcode == 0 ? 0 : fbw(wcode);
            int length = (((int)(first & 1) << 8) | buf[pos + 1]) + 1;
            pos += 2;
            uint64_t bu, du;
            if (!read_varint(buf, &pos, buf_len, &bu)) return -1;
            int64_t base = is_signed ? unzigzag(bu) : (int64_t)bu;
            if (!read_varint(buf, &pos, buf_len, &du)) return -1;
            int64_t d0 = unzigzag(du);
            out[filled++] = base;
            int64_t cur = base;
            if (length > 1 && filled < count) {
                cur += d0;
                out[filled++] = cur;
                if (width == 0) {
                    for (int i = 2; i < length && filled < count; i++) {
                        cur += d0;
                        out[filled++] = cur;
                    }
                } else {
                    int64_t sign = d0 >= 0 ? 1 : -1;
                    BitReader br{buf, pos, buf_len};
                    for (int i = 2; i < length && filled < count; i++) {
                        cur += sign * (int64_t)br.take(width);
                        out[filled++] = cur;
                    }
                    if (br.bad) return -1;
                    br.align();
                    pos = br.pos;
                }
            }
            continue;
        } else {  // PATCHED_BASE
            if (pos + 3 >= buf_len) return -1;
            int width = fbw((first >> 1) & 0x1F);
            int length = (((int)(first & 1) << 8) | buf[pos + 1]) + 1;
            uint8_t third = buf[pos + 2], fourth = buf[pos + 3];
            int base_width = ((third >> 5) & 0x7) + 1;
            int patch_width = fbw(third & 0x1F);
            int gap_width = ((fourth >> 5) & 0x7) + 1;
            int patch_count = fourth & 0x1F;
            pos += 4;
            if (pos + base_width > buf_len) return -1;
            if (filled + length > count) return -1;  // run exceeds request
            uint64_t braw = 0;
            for (int i = 0; i < base_width; i++) braw = (braw << 8) | buf[pos++];
            uint64_t msb = 1ULL << (base_width * 8 - 1);
            int64_t base = (braw & msb) ? -(int64_t)(braw & ~msb) : (int64_t)braw;
            BitReader br{buf, pos, buf_len};
            int64_t start = filled;
            for (int i = 0; i < length; i++) out[filled++] = (int64_t)br.take(width);
            br.align();
            int pbits = closest_fixed_bits(patch_width + gap_width);
            int64_t idx = 0;
            for (int i = 0; i < patch_count; i++) {
                uint64_t p = br.take(pbits);
                int64_t gap = (int64_t)(p >> patch_width);
                uint64_t patch = p & ((patch_width == 64) ? ~0ULL
                                     : ((1ULL << patch_width) - 1));
                idx += gap;
                if (start + idx >= filled) return -1;  // corrupt patch gap
                out[start + idx] |= (int64_t)(patch << width);
            }
            if (br.bad) return -1;
            br.align();
            pos = br.pos;
            for (int64_t i = start; i < filled; i++) out[i] += base;
            continue;
        }
    }
    return pos;
}

// Decode `count` RLEv1 integers; returns bytes consumed or -1.
int64_t tt_orc_rle1(const uint8_t* buf, int64_t buf_len, int64_t count,
                    int32_t is_signed, int64_t* out) {
    using namespace orc_rle;
    int64_t pos = 0, filled = 0;
    while (filled < count) {
        if (pos >= buf_len) return -1;
        uint8_t ctrl = buf[pos++];
        if (ctrl < 128) {
            int run = ctrl + 3;
            if (pos >= buf_len) return -1;
            int8_t delta = (int8_t)buf[pos++];
            uint64_t bu;
            if (!read_varint(buf, &pos, buf_len, &bu)) return -1;
            int64_t base = is_signed ? unzigzag(bu) : (int64_t)bu;
            for (int i = 0; i < run && filled < count; i++)
                out[filled++] = base + (int64_t)i * delta;
        } else {
            int lit = 256 - ctrl;
            for (int i = 0; i < lit && filled < count; i++) {
                uint64_t u;
                if (!read_varint(buf, &pos, buf_len, &u)) return -1;
                out[filled++] = is_signed ? unzigzag(u) : (int64_t)u;
            }
        }
    }
    return pos;
}

// Byte-RLE (present/boolean framing); returns bytes consumed or -1.
int64_t tt_orc_byte_rle(const uint8_t* buf, int64_t buf_len, int64_t count,
                        uint8_t* out) {
    int64_t pos = 0, filled = 0;
    while (filled < count) {
        if (pos >= buf_len) return -1;
        uint8_t ctrl = buf[pos++];
        if (ctrl < 128) {
            int run = ctrl + 3;
            if (pos >= buf_len) return -1;
            uint8_t v = buf[pos++];
            for (int i = 0; i < run && filled < count; i++) out[filled++] = v;
        } else {
            int lit = 256 - ctrl;
            for (int i = 0; i < lit && filled < count; i++) {
                if (pos >= buf_len) return -1;
                out[filled++] = buf[pos++];
            }
        }
    }
    return pos;
}

// Decimal DATA: `count` zigzag unbounded varints.
int64_t tt_orc_decimal64(const uint8_t* buf, int64_t buf_len, int64_t count,
                         int64_t* out) {
    using namespace orc_rle;
    int64_t pos = 0;
    for (int64_t i = 0; i < count; i++) {
        uint64_t u;
        if (!read_varint(buf, &pos, buf_len, &u)) return -1;
        out[i] = unzigzag(u);
    }
    return pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TPC-H dbgen text pool: grammar-driven sentence stream from weighted word
// distributions, drawn from one Lehmer stream (seed' = seed*16807 mod 2^31-1).
// The distribution tables arrive serialized from Python so the word lists
// live in one place (trino_tpu_torch/connectors/dbgen.py).
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

// ---------------------------------------------------------------------------
// ORC integer/byte encoders (writer-side mirror of the decoders above;
// reference lib/trino-orc RunLengthIntegerWriterV2 semantics, rebuilt from
// the public ORC spec). Greedy: constant runs >=6 become SHORT_REPEAT (3..10)
// or DELTA-with-zero-delta chunks (<=512); everything else packs as DIRECT.

namespace orc_enc {

static inline uint64_t zigzag64(int64_t v) {
    return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}

static inline int width_code(int w) {
    if (w <= 24) return w - 1;
    if (w <= 26) return 24;
    if (w <= 28) return 25;
    if (w <= 30) return 26;
    if (w <= 32) return 27;
    if (w <= 40) return 28;
    if (w <= 48) return 29;
    if (w <= 56) return 30;
    return 31;
}

static inline int closest_fixed_bits_enc(int n) {
    if (n < 1) return 1;
    if (n <= 24) return n;
    if (n <= 26) return 26;
    if (n <= 28) return 28;
    if (n <= 30) return 30;
    if (n <= 32) return 32;
    if (n <= 40) return 40;
    if (n <= 48) return 48;
    if (n <= 56) return 56;
    return 64;
}

static inline int bits_of(uint64_t v) {
    int b = 0;
    while (v) { b++; v >>= 1; }
    return b ? b : 1;
}

struct BitWriter {
    uint8_t* out;
    int64_t pos = 0;
    uint8_t cur = 0;
    int bit = 0;
    void put(uint64_t v, int width) {
        for (int i = width - 1; i >= 0; i--) {
            cur = (uint8_t)((cur << 1) | ((v >> i) & 1));
            if (++bit == 8) { out[pos++] = cur; cur = 0; bit = 0; }
        }
    }
    void flush() {
        if (bit) { out[pos++] = (uint8_t)(cur << (8 - bit)); cur = 0; bit = 0; }
    }
};

static inline void put_varint(uint8_t* out, int64_t* pos, uint64_t u) {
    while (u >= 0x80) { out[(*pos)++] = (uint8_t)(u | 0x80); u >>= 7; }
    out[(*pos)++] = (uint8_t)u;
}

// DIRECT chunk of `n` (<=512) pre-zigzagged values.
static void emit_direct(const uint64_t* u, int64_t n, uint8_t* out, int64_t* pos) {
    uint64_t maxv = 0;
    for (int64_t i = 0; i < n; i++) if (u[i] > maxv) maxv = u[i];
    int width = closest_fixed_bits_enc(bits_of(maxv));
    int code = width_code(width);
    int64_t ln = n - 1;
    out[(*pos)++] = (uint8_t)(0x40 | (code << 1) | (ln >> 8));
    out[(*pos)++] = (uint8_t)(ln & 0xFF);
    BitWriter bw{out + *pos};
    for (int64_t i = 0; i < n; i++) bw.put(u[i], width);
    bw.flush();
    *pos += bw.pos;
}

static void emit_constant(int64_t value, int64_t run, int32_t is_signed,
                          uint8_t* out, int64_t* pos) {
    uint64_t uval = is_signed ? zigzag64(value) : (uint64_t)value;
    while (run > 0) {
        if (run >= 3 && run <= 10) {
            int width = (bits_of(uval) + 7) / 8;
            if (width < 1) width = 1;
            out[(*pos)++] = (uint8_t)(((width - 1) << 3) | (run - 3));
            for (int b = width - 1; b >= 0; b--)
                out[(*pos)++] = (uint8_t)(uval >> (8 * b));
            return;
        }
        int64_t take = run < 512 ? run : 512;
        if (take < 3) {  // trailing 1-2: DIRECT them
            uint64_t tmp[2] = {uval, uval};
            emit_direct(tmp, take, out, pos);
            return;
        }
        int64_t ln = take - 1;
        out[(*pos)++] = (uint8_t)(0xC0 | (ln >> 8));  // DELTA, width code 0
        out[(*pos)++] = (uint8_t)(ln & 0xFF);
        put_varint(out, pos, is_signed ? zigzag64(value) : (uint64_t)value);
        put_varint(out, pos, 0);  // delta0 = 0
        run -= take;
    }
}

}  // namespace orc_enc

extern "C" {

// RLEv2-encode `n` int64s; returns bytes written (caller sizes out at
// n*9 + 64 worst case).
int64_t tt_orc_rle2_encode(const int64_t* vals, int64_t n, int32_t is_signed,
                           uint8_t* out) {
    using namespace orc_enc;
    if (n == 0) return 0;
    std::vector<uint64_t> u((size_t)n);
    for (int64_t i = 0; i < n; i++)
        u[i] = is_signed ? zigzag64(vals[i]) : (uint64_t)vals[i];
    int64_t pos = 0, i = 0, lit = 0;  // lit = start of pending literals
    while (i < n) {
        int64_t j = i + 1;
        while (j < n && vals[j] == vals[i]) j++;
        int64_t run = j - i;
        if (run >= 6) {
            for (int64_t c = lit; c < i; c += 512)
                emit_direct(&u[c], (i - c) < 512 ? (i - c) : 512, out, &pos);
            emit_constant(vals[i], run, is_signed, out, &pos);
            lit = j;
        }
        i = j;
    }
    for (int64_t c = lit; c < n; c += 512)
        emit_direct(&u[c], (n - c) < 512 ? (n - c) : 512, out, &pos);
    return pos;
}

// Byte-RLE encode; returns bytes written (out sized n*2 + 64).
int64_t tt_orc_byte_rle_encode(const uint8_t* b, int64_t n, uint8_t* out) {
    int64_t pos = 0, i = 0, lit = 0;
    while (i < n) {
        int64_t j = i + 1;
        while (j < n && b[j] == b[i]) j++;
        int64_t run = j - i;
        if (run >= 3) {
            while (lit < i) {  // flush literals
                int64_t take = (i - lit) < 128 ? (i - lit) : 128;
                out[pos++] = (uint8_t)(256 - take);
                for (int64_t k = 0; k < take; k++) out[pos++] = b[lit + k];
                lit += take;
            }
            int64_t rem = run;
            while (rem > 0) {
                int64_t take = rem < 130 ? rem : 130;
                if (rem - take == 1 || rem - take == 2) take -= 3 - (rem - take);
                out[pos++] = (uint8_t)(take - 3);
                out[pos++] = b[i];
                rem -= take;
            }
            lit = j;
        }
        i = j;
    }
    while (lit < n) {
        int64_t take = (n - lit) < 128 ? (n - lit) : 128;
        out[pos++] = (uint8_t)(256 - take);
        for (int64_t k = 0; k < take; k++) out[pos++] = b[lit + k];
        lit += take;
    }
    return pos;
}

// Plain LEB128 of uint64 values (ORC string-length / dictionary-code aux
// streams, decimal unscaled varints after host-side zigzag).
int64_t tt_orc_varint_encode(const uint64_t* vals, int64_t n, uint8_t* out) {
    using namespace orc_enc;
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) put_varint(out, &pos, vals[i]);
    return pos;
}

// ===== H2D staging arena ====================================================
// Coalesced host->device ingest: every column buffer of one split/shard
// (data, validity lanes, selection) is copied into ONE contiguous
// uint32-word arena, so the engine issues a single DMA per device instead
// of one per column (amortizing the per-transfer latency floor). Each
// source lands at a 4-byte-aligned offset; tail pad bytes are zeroed so
// arenas are bit-deterministic (the parity test compares raw words).
// Returns total words written, or -1 if a source would overrun capacity.

int64_t tt_pack_arena(const uint8_t** srcs, const int64_t* nbytes,
                      int64_t n_srcs, uint8_t* dst, int64_t dst_words) {
    int64_t pos = 0;  // byte offset, always word-aligned
    int64_t cap = dst_words * 4;
    for (int64_t i = 0; i < n_srcs; i++) {
        int64_t nb = nbytes[i];
        int64_t padded = (nb + 3) & ~int64_t(3);
        if (pos + padded > cap) return -1;
        std::memcpy(dst + pos, srcs[i], nb);
        for (int64_t k = nb; k < padded; k++) dst[pos + k] = 0;
        pos += padded;
    }
    return pos / 4;
}

}  // extern "C"

extern "C" {

// ===== pinned copy staging ==================================================
// Copy source i to dst + offsets[i] and zero the gap up to the next
// segment's offset (or dst_bytes after the last), so a staging buffer is
// bit-deterministic. Offsets must ascend and leave room for each source.
// Returns the bytes written, or -1 when a source would overrun.

int64_t tt_scatter_segments(const uint8_t** srcs, const int64_t* nbytes,
                            const int64_t* offsets, int64_t n_srcs,
                            uint8_t* dst, int64_t dst_bytes) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n_srcs; i++) {
        int64_t off = offsets[i], nb = nbytes[i];
        if (off < pos || off + nb > dst_bytes) return -1;
        if (off > pos) std::memset(dst + pos, 0, off - pos);
        if (nb) std::memcpy(dst + off, srcs[i], nb);
        pos = off + nb;
    }
    if (dst_bytes > pos) std::memset(dst + pos, 0, dst_bytes - pos);
    return dst_bytes;
}

}  // extern "C"
