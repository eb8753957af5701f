// Zstandard frame decoding (RFC 8878), as libzstd 1.5 decodes it.
//
// Two entry points, bound with ctypes by scene/zstd.py:
//
// * rls_zstd_tiff: one strip or tile of a ZSTD-compressed TIFF as
//   libtiff's ZSTD codec reads it: ZSTD_decompressStream called until the
//   strip's rows are full, the input is spent or a frame ends. A frame
//   whose content size fits the rows and whose bytes are all there is
//   decoded in one pass (every check, the checksum too); any other is
//   decoded block by block, and decoding stops where a block's output
//   runs past the rows, so blocks and a checksum after that point are
//   never read. The strip decodes only where the rows fill up with no
//   error on the way.
// * rls_zstd_frames: every frame of a buffer in one pass each, skippable
//   frames skipped, as ZSTD_decompress does.
//
// Corrupt data decodes as libzstd decodes it, so its Huffman decoders are
// followed where they differ from the RFC: the double-symbol table (X2)
// where HUF_selectDecoder picks it, and the fast four-stream loop, which
// does not check where a stream's bits end (`huf_fast`).
//
// Both return 0, or 1 with a message for data libzstd fails, or 2 for a
// legacy (v0.5-v0.7) frame, which libzstd decodes and this file does not.
#include <cstdint>
#include <cstdio>
#include <algorithm>
#include <cstring>
#include <vector>

namespace {

struct Fail {
    const char* what;
};
struct Legacy {};

[[noreturn]] void fail(const char* what) { throw Fail{what}; }

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

uint32_t le(const uint8_t* p, int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v = v << 8 | p[i];
    return v;
}

// ---- XXH64, whose low 32 bits are a frame's checksum -------------------
const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;

uint64_t rotl(uint64_t x, int r) { return x << r | x >> (64 - r); }
uint64_t rd64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}
uint64_t round64(uint64_t acc, uint64_t in) {
    return rotl(acc + in * P2, 31) * P1;
}
uint64_t merge64(uint64_t acc, uint64_t v) {
    return (acc ^ round64(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        while (end - p >= 32) {
            v1 = round64(v1, rd64(p));
            v2 = round64(v2, rd64(p + 8));
            v3 = round64(v3, rd64(p + 16));
            v4 = round64(v4, rd64(p + 24));
            p += 32;
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = merge64(merge64(merge64(merge64(h, v1), v2), v3), v4);
    } else {
        h = P5;
    }
    h += len;
    while (end - p >= 8) {
        h = rotl(h ^ round64(0, rd64(p)), 27) * P1 + P4;
        p += 8;
    }
    if (end - p >= 4) {
        h = rotl(h ^ (uint64_t)le(p, 4) * P1, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) h = rotl(h ^ *p++ * P5, 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ h >> 32;
}

// ---- bit streams --------------------------------------------------------
// A backward stream: the last byte's highest set bit ends the padding,
// and fields are read from there towards the first byte, most
// significant bit first. Bits before the first byte read as 0; `left`
// going below 0 is libzstd's overflow.
struct Back {
    const uint8_t* p = nullptr;
    int64_t n = 0, left = 0;
    Back() = default;
    Back(const uint8_t* src, int64_t size) : p(src), n(size) {
        if (size < 1) fail("empty bit stream");
        if (!src[size - 1]) fail("bit stream without its end mark");
        left = (size - 1) * 8 + highbit(src[size - 1]);
    }
    uint64_t window(int64_t lo) const {     // 64 bits from bit lo
        int64_t b = lo >> 3;
        uint64_t v = 0;
        if (b >= 0 && b + 8 <= n) {
            v = rd64(p + b);
        } else {
            for (int i = 7; i >= 0; --i) {
                int64_t k = b + i;
                v = v << 8 | (k >= 0 && k < n ? p[k] : 0);
            }
        }
        return v >> (lo & 7);
    }
    uint32_t peek(int k) const {
        if (!k) return 0;
        int64_t lo = left - k;
        if (lo >= 0) return window(lo) & ((1ULL << k) - 1);
        if (lo <= -k) return 0;
        return (window(0) << -lo) & ((1ULL << k) - 1);
    }
    uint32_t read(int k) {
        uint32_t v = peek(k);
        left -= k;
        return v;
    }
};

// a forward stream (FSE table descriptions), least significant bit first
struct Fwd {
    const uint8_t* p;
    int64_t n, at = 0;
    uint32_t peek(int k) const {
        uint32_t v = 0;
        for (int i = 0; i < k; ++i) {
            int64_t b = at + i;
            if ((b >> 3) < n && (p[b >> 3] >> (b & 7) & 1)) v |= 1u << i;
        }
        return v;
    }
    uint32_t read(int k) {
        uint32_t v = peek(k);
        at += k;
        return v;
    }
};

// ---- FSE ----------------------------------------------------------------
struct FseCell {
    uint8_t sym, bits;
    uint16_t base;
};
struct Fse {
    int log = 0;
    std::vector<FseCell> t;
};

// FSE_readNCount: the normalized counts of a table description; returns
// the bytes it takes.
int64_t read_ncount(const uint8_t* src, int64_t n, int16_t* norm, int& maxsym,
                    int& log) {
    Fwd f{src, n};
    log = (int)f.read(4) + 5;
    if (log > 15) fail("FSE table log too large");
    int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
    int ch = 0, maxsv1 = maxsym + 1;
    bool prev0 = false;
    for (int s = 0; s <= maxsym; ++s) norm[s] = 0;
    for (;;) {
        if (prev0) {
            uint32_t r;
            while ((r = f.read(2)) == 3) ch += 3;
            ch += (int)r;
            if (ch >= maxsv1) break;
        }
        int max = (2 * threshold - 1) - remaining, count;
        uint32_t low = f.peek(nbits - 1);
        if ((int)low < max) {
            count = (int)low;
            f.at += nbits - 1;
        } else {
            count = (int)f.peek(nbits);
            if (count >= threshold) count -= max;
            f.at += nbits;
        }
        --count;
        remaining -= count < 0 ? -count : count;
        norm[ch++] = (int16_t)count;
        prev0 = count == 0;
        if (remaining < threshold) {
            if (remaining <= 1) break;
            nbits = highbit((uint32_t)remaining) + 1;
            threshold = 1 << (nbits - 1);
        }
        if (ch >= maxsv1) break;
    }
    if (remaining != 1) fail("FSE table description does not sum up");
    if (ch > maxsv1) fail("FSE table description past its last symbol");
    int64_t size = (f.at + 7) >> 3;
    if (size > n) fail("FSE table description runs past its data");
    maxsym = ch - 1;
    return size;
}

void build_fse(Fse& f, const int16_t* norm, int maxsym, int log) {
    int size = 1 << log, high = size - 1;
    std::vector<int> next(maxsym + 1);
    f.log = log;
    f.t.assign(size, FseCell{0, 0, 0});
    for (int s = 0; s <= maxsym; ++s) {
        if (norm[s] == -1) {
            f.t[high--].sym = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = norm[s];
        }
    }
    int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    for (int s = 0; s <= maxsym; ++s)
        for (int i = 0; i < norm[s]; ++i) {
            f.t[pos].sym = (uint8_t)s;
            do pos = (pos + step) & mask;
            while (pos > high);
        }
    for (int u = 0; u < size; ++u) {
        int nx = next[f.t[u].sym]++;
        int bits = log - highbit((uint32_t)nx);
        f.t[u].bits = (uint8_t)bits;
        f.t[u].base = (uint16_t)((nx << bits) - size);
    }
}

// ---- Huffman ------------------------------------------------------------
// A Huffman table as libzstd keeps it: the prefix code of `log` bits, its
// decoding table widened to `dlog` bits (11 where the code has at most
// 11, as HUF_readDTableX1 and X2 rescale it), each entry's symbol and
// length, and the double-symbol entry of X2 (a second symbol where its
// whole code fits in the dlog bits after the first).
struct Huf {
    int log = 0, dlog = 0;
    bool valid = false, x2 = false;
    std::vector<uint8_t> sym, bits, sym2, bits2;
};

// HUF_readStats then HUF_readDTableX1; returns the bytes it takes
int64_t read_huf(Huf& h, const uint8_t* src, int64_t n) {
    if (n < 1) fail("Huffman tree description missing");
    uint8_t w[256];
    int nw = 0, hdr = src[0];
    int64_t used;
    if (hdr >= 128) {
        nw = hdr - 127;
        used = (nw + 1) / 2 + 1;
        if (used > n) fail("Huffman weights run past the block");
        for (int i = 0; i < nw; ++i)
            w[i] = i & 1 ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4;
    } else {
        used = hdr + 1;
        if (used > n) fail("Huffman weights run past the block");
        int16_t norm[256];
        int maxsym = 255, log;
        int64_t hs = read_ncount(src + 1, hdr, norm, maxsym, log);
        if (log > 6) fail("Huffman weight table log too large");
        Fse f;
        build_fse(f, norm, maxsym, log);
        Back br(src + 1 + hs, hdr - hs);
        uint32_t s1 = br.read(log), s2 = br.read(log);
        if (br.left < 0) fail("Huffman weights stream overflow");
        for (;;) {
            if (nw > 253) fail("too many Huffman weights");
            w[nw++] = f.t[s1].sym;
            s1 = f.t[s1].base + br.read(f.t[s1].bits);
            if (br.left < 0) {
                w[nw++] = f.t[s2].sym;
                break;
            }
            if (nw > 253) fail("too many Huffman weights");
            w[nw++] = f.t[s2].sym;
            s2 = f.t[s2].base + br.read(f.t[s2].bits);
            if (br.left < 0) {
                w[nw++] = f.t[s1].sym;
                break;
            }
        }
    }
    uint32_t rank[13] = {0}, total = 0;
    for (int i = 0; i < nw; ++i) {
        if (w[i] > 12) fail("Huffman weight above 12");
        rank[w[i]]++;
        total += (1u << w[i]) >> 1;
    }
    if (!total) fail("Huffman weights all zero");
    int log = highbit(total) + 1;
    if (log > 12) fail("Huffman table log above 12");
    uint32_t rest = (1u << log) - total;
    if ((1u << highbit(rest)) != rest) fail("Huffman weights do not sum up");
    w[nw] = (uint8_t)(highbit(rest) + 1);
    rank[w[nw]]++;
    if (rank[1] < 2 || (rank[1] & 1)) fail("Huffman tree invalid");
    int nsym = nw + 1;
    uint32_t start[13] = {0}, at = 0;
    for (int k = 1; k <= log; ++k) {
        start[k] = at;
        at += rank[k] << (k - 1);
    }
    std::vector<uint8_t> sym(1u << log), bits(1u << log);
    for (int s = 0; s < nsym; ++s) {
        if (!w[s]) continue;
        uint32_t len = (1u << w[s]) >> 1;
        for (uint32_t u = start[w[s]]; u < start[w[s]] + len; ++u) {
            sym[u] = (uint8_t)s;
            bits[u] = (uint8_t)(log + 1 - w[s]);
        }
        start[w[s]] += len;
    }
    int dlog = log <= 11 ? 11 : log;
    uint32_t size = 1u << dlog, mask = size - 1;
    h.log = log;
    h.dlog = dlog;
    h.sym.assign(size, 0);
    h.bits.assign(size, 0);
    h.sym2.assign(size, 0);
    h.bits2.assign(size, 0);
    for (uint32_t v = 0; v < size; ++v) {
        h.sym[v] = sym[v >> (dlog - log)];
        h.bits[v] = bits[v >> (dlog - log)];
    }
    for (uint32_t v = 0; v < size; ++v) {
        uint32_t l1 = h.bits[v], v2 = (v << l1) & mask;
        if (h.bits[v2] <= dlog - (int)l1) {
            h.sym2[v] = h.sym[v2];
            h.bits2[v] = (uint8_t)(l1 + h.bits[v2]);
        }
    }
    h.valid = true;
    return used;
}

// HUF_selectDecoder: libzstd's time model picks the double-symbol decoder
// (X2) for a fresh table of four streams where it decodes faster
bool select_x2(int64_t dst, int64_t csrc) {
    static const uint32_t T[16][2][2] = {
        {{0, 0}, {1, 1}}, {{0, 0}, {1, 1}},
        {{150, 216}, {381, 119}}, {{170, 205}, {514, 112}},
        {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}},
        {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}},
        {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}},
        {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
        {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}},
        {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
    uint32_t q = csrc >= dst ? 15 : (uint32_t)(csrc * 16 / dst);
    uint32_t d256 = (uint32_t)(dst >> 8);
    uint32_t t0 = T[q][0][0] + T[q][0][1] * d256;
    uint32_t t1 = T[q][1][0] + T[q][1][1] * d256;
    t1 += t1 >> 5;
    return t1 < t0;
}

// One stream as libzstd's plain decoders read it (HUF_decodeStreamX1 and
// X2 over BIT_DStream_t): bits before the stream read as 0, and the
// stream must end exactly where its bits do, but that X2's last symbol,
// where its table entry holds two, may run past the end (libzstd clamps
// the count of bits it read to the container's).
void huf_stream(const Huf& h, bool x2, const uint8_t* src, int64_t n,
                uint8_t* out, int64_t count) {
    Back br(src, n);
    int64_t i = 0;
    if (x2) {
        while (count - i >= 2) {
            uint32_t v = br.peek(h.dlog);
            out[i++] = h.sym[v];
            if (h.bits2[v]) {
                out[i++] = h.sym2[v];
                br.left -= h.bits2[v];
            } else {
                br.left -= h.bits[v];
            }
        }
        if (i < count) {
            uint32_t v = br.peek(h.dlog);
            out[i++] = h.sym[v];
            if (!h.bits2[v]) {
                br.left -= h.bits[v];
            } else if (br.left > 0) {
                br.left -= h.bits2[v];
                if (br.left < 0) br.left = 0;
            }
        }
    } else {
        for (; i < count; ++i) {
            uint32_t v = br.peek(h.dlog);
            out[i] = h.sym[v];
            br.left -= h.bits[v];
        }
    }
    if (br.left != 0) fail("Huffman stream not consumed exactly");
}

// The bits of libzstd's fast four-stream loop: memory read downward from
// a stream's end, on past its start into the bytes before it, down to
// `low` (the jump table); there its last container, the 8 bytes at low,
// holds: below them bits read as 0 until 64 past its top have been read,
// then the reads wrap round the container (BIT_lookBitsFast's shift by
// the count modulo 64).
struct FastBits {
    const uint8_t* low;
    int64_t n;              // bytes from low to the end of the streams
    int64_t pos;            // bits of memory below the next one to read
    uint32_t peek(int k) const {
        if (pos - k >= 0) {
            int64_t lo = pos - k, b = lo >> 3;
            uint64_t v = 0;
            if (b + 8 <= n) {
                v = rd64(low + b);
            } else {
                for (int i = 7; i >= 0; --i)
                    v = v << 8 | (b + i < n ? low[b + i] : 0);
            }
            return (uint32_t)((v >> (lo & 7)) & ((1ULL << k) - 1));
        }
        uint64_t c = rd64(low);
        int sh = pos > 0 ? (int)(64 - pos) : (int)((-pos) & 63);
        return (uint32_t)((c << sh) >> (64 - k));
    }
};

// HUF_decompress4X1/4X2_usingDTable_internal_fast: the fast loop over
// the four streams (5 lookups a stream a round, rounds as many as the
// input before stream 1's window and the outputs allow, leaving early if
// a stream's window has crossed the one before it), the check that no
// window went more than 8 bytes below its stream, then each stream
// finished alone; nothing checks where a stream's bits end.
void huf_fast(const Huf& h, bool x2, const uint8_t* low,
              const uint8_t* const* starts, const uint8_t* const* ends,
              uint8_t* out, int64_t count, int64_t seg) {
    FastBits fb[4];
    int64_t win[4], done[4] = {0, 0, 0, 0}, size[4];
    for (int k = 0; k < 4; ++k) {
        int64_t n = ends[k] - low;
        uint8_t last = ends[k][-1];
        fb[k] = FastBits{low, ends[3] - low,
                         last ? (n - 1) * 8 + highbit(last) : n * 8};
        win[k] = n - 8;
        size[k] = k < 3 ? seg : count - 3 * seg;
    }
    auto look = [&](int k) {
        uint8_t* o = out + k * seg + done[k];
        uint32_t v = fb[k].peek(h.dlog);
        o[0] = h.sym[v];
        if (x2 && h.bits2[v]) {
            o[1] = h.sym2[v];
            fb[k].pos -= h.bits2[v];
            done[k] += 2;
        } else {
            fb[k].pos -= h.bits[v];
            done[k] += 1;
        }
    };
    auto reload = [&](int k) {
        int64_t x = fb[k].pos - 64;          // ceil(x / 8)
        win[k] = x >= 0 ? (x + 7) / 8 : -((-x) / 8);
    };
    for (;;) {
        int64_t iters = win[0] / 7;
        if (x2) {
            for (int k = 0; k < 4; ++k)
                iters = std::min(iters, (size[k] - done[k]) / 10);
        } else {
            iters = std::min(iters, (size[3] - done[3]) / 5);
        }
        if (iters == 0) break;
        bool crossed = false;
        for (int k = 1; k < 4; ++k) crossed = crossed || win[k] < win[k - 1];
        if (crossed) break;
        int64_t limit = done[3] + 5 * iters;
        do {
            for (int r = 0; r < 5; ++r)
                for (int k = 0; k < 4; ++k) look(k);
            for (int k = 0; k < 4; ++k) reload(k);
        } while (done[3] < limit);
    }
    for (int k = 0; k < 4; ++k)
        if (win[k] < (starts[k] - low) - 8)
            fail("Huffman stream read past its start");
    for (int k = 0; k < 4; ++k) {
        uint8_t* o = out + k * seg;
        if (x2) {
            while (size[k] - done[k] >= 2) look(k);
            if (done[k] < size[k]) {
                uint32_t v = fb[k].peek(h.dlog);
                o[done[k]++] = h.sym[v];
            }
        } else {
            while (done[k] < size[k]) look(k);
        }
    }
}

// ---- sequences ----------------------------------------------------------
const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,  14,  15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};
enum { LL = 0, OF = 1, ML = 2 };
const int MAXSYM[3] = {35, 31, 52}, MAXLOG[3] = {9, 8, 9};

struct Header {
    bool skippable = false, single = false, checksum = false;
    int64_t size = 0;           // header bytes
    int64_t fcs = -1;           // content size, -1 unknown
    uint64_t window = 0, skip = 0;
    int64_t block_max = 0;
};

// ZSTD_getFrameHeader: 0 with the header, or the bytes it needs
int64_t frame_header(const uint8_t* p, int64_t n, Header& h) {
    if (n < 4) {
        uint8_t b[4] = {0x28, 0xB5, 0x2F, 0xFD}, s[4] = {0x50, 0x2A, 0x4D, 0x18};
        memcpy(b, p, n);
        memcpy(s, p, n);
        if (le(b, 4) != 0xFD2FB528u && (le(s, 4) & 0xFFFFFFF0u) != 0x184D2A50u)
            fail("not a Zstandard frame");
        return 5;
    }
    uint32_t magic = le(p, 4);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (n < 8) return 8;
        h.skippable = true;
        h.size = 8;
        h.skip = le(p + 4, 4);
        return 0;
    }
    if (magic >= 0xFD2FB525u && magic <= 0xFD2FB527u) throw Legacy{};
    if (magic != 0xFD2FB528u) fail("not a Zstandard frame");
    if (n < 5) return 5;
    uint8_t d = p[4];
    int fcs_flag = d >> 6, did_flag = d & 3;
    h.single = d >> 5 & 1;
    h.checksum = d >> 2 & 1;
    int did_size = (int[]){0, 1, 2, 4}[did_flag];
    int fcs_size = (int[]){h.single ? 1 : 0, 2, 4, 8}[fcs_flag];
    h.size = 5 + !h.single + did_size + fcs_size;
    if (n < h.size) return h.size;
    if (d & 8) fail("reserved bit of the frame header set");
    const uint8_t* q = p + 5;
    if (!h.single) {
        int exp = *q >> 3, mant = *q & 7;
        int wlog = 10 + exp;
        if (wlog > 31) fail("window too large");
        uint64_t base = 1ULL << wlog;
        h.window = base + (base >> 3) * mant;
        ++q;
    }
    uint32_t did = did_size ? le(q, did_size) : 0;
    q += did_size;
    if (fcs_size == 8)
        h.fcs = (int64_t)((uint64_t)le(q, 4) | (uint64_t)le(q + 4, 4) << 32);
    else if (fcs_size)
        h.fcs = le(q, fcs_size) + (fcs_size == 2 ? 256 : 0);
    if (h.single) h.window = (uint64_t)h.fcs;
    h.block_max = (int64_t)(h.window < 131072 ? h.window : 131072);
    if (did) fail("frame needs a dictionary");
    return 0;
}

// the state of one frame's decoding: its output so far in `out` from
// `start`, its tables and repeat offsets
struct Frame {
    std::vector<uint8_t>& out;
    size_t start;
    Header h;
    Huf huf;
    Fse tab[3];
    bool have_seq = false;
    uint32_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> lits;

    Frame(std::vector<uint8_t>& o, const Header& hd)
        : out(o), start(o.size()), h(hd) {}

    int64_t literals(const uint8_t* p, int64_t n, int64_t limit) {
        if (n < 2) fail("block too small");
        int type = p[0] & 3, fmt = p[0] >> 2 & 3;
        int64_t lh, size;
        if (type < 2) {
            lh = fmt == 1 ? 2 : fmt == 3 ? 3 : 1;
            if (type == 1 && n < lh + 1) fail("RLE literals cut");
            if (lh == 3 && n < 3) fail("literals header cut");
            size = lh == 1 ? p[0] >> 3 : le(p, lh) >> 4;
            if (size > h.block_max) fail("literals larger than a block");
            if (size > limit) fail("literals past the output");
            if (type == 0) {
                if (lh + size > n) fail("raw literals past the block");
                lits.assign(p + lh, p + lh + size);
                return lh + size;
            }
            lits.assign(size, p[lh]);
            return lh + 1;
        }
        if (type == 3 && !huf.valid) fail("treeless literals without a table");
        if (n < 5) fail("compressed literals header cut");
        uint32_t hc = le(p, 4);
        int64_t csize;
        bool one = fmt == 0;
        if (fmt < 2) {
            lh = 3;
            size = hc >> 4 & 0x3FF;
            csize = hc >> 14 & 0x3FF;
        } else if (fmt == 2) {
            lh = 4;
            size = hc >> 4 & 0x3FFF;
            csize = hc >> 18;
        } else {
            lh = 5;
            size = hc >> 4 & 0x3FFFF;
            csize = (hc >> 22) + ((int64_t)p[4] << 10);
        }
        if (size > h.block_max) fail("literals larger than a block");
        if (!one && size < 6) fail("too few literals for four streams");
        if (csize + lh > n) fail("compressed literals past the block");
        if (size > limit) fail("literals past the output");
        const uint8_t* q = p + lh;
        int64_t m = csize;
        if (type == 2) {
            int64_t used = read_huf(huf, q, m);
            q += used;
            m -= used;
        }
        lits.assign(size, 0);
        if (type == 2) huf.x2 = !one && select_x2(size, csize);
        if (one) {
            huf_stream(huf, huf.x2, q, m, lits.data(), size);
        } else {
            if (m < 10) fail("four literal streams too small");
            int64_t l1 = le(q, 2), l2 = le(q + 2, 2), l3 = le(q + 4, 2);
            int64_t l4 = m - 6 - l1 - l2 - l3;
            if (l4 < 0) fail("literal streams past their section");
            int64_t seg = (size + 3) / 4;
            const uint8_t* s = q + 6;
            const uint8_t* starts[4] = {s, s + l1, s + l1 + l2,
                                        s + l1 + l2 + l3};
            const uint8_t* ends[4] = {s + l1, s + l1 + l2, s + l1 + l2 + l3,
                                      q + m};
            int64_t lens[4] = {l1, l2, l3, l4};
            // HUF_DecompressFastArgs_init's conditions for the fast loop
            bool fast = huf.dlog == 11 && 3 * seg < size;
            for (int k = 0; k < 4; ++k) fast = fast && lens[k] >= 8;
            if (fast) {
                huf_fast(huf, huf.x2, q, starts, ends, lits.data(), size,
                         seg);
            } else {
                for (int k = 0; k < 4; ++k)
                    huf_stream(huf, huf.x2, starts[k], lens[k],
                               lits.data() + k * seg,
                               k < 3 ? seg : size - 3 * seg);
            }
        }
        return lh + csize;
    }

    int64_t table(int k, int mode, const uint8_t* p, int64_t n) {
        static const int16_t* DEF[3] = {LL_DEFAULT, OF_DEFAULT, ML_DEFAULT};
        static const int DEFMAX[3] = {35, 28, 52}, DEFLOG[3] = {6, 5, 6};
        if (mode == 0) {
            build_fse(tab[k], DEF[k], DEFMAX[k], DEFLOG[k]);
            return 0;
        }
        if (mode == 1) {
            if (n < 1) fail("RLE sequence table cut");
            if (p[0] > MAXSYM[k]) fail("RLE sequence symbol out of range");
            tab[k].log = 0;
            tab[k].t.assign(1, FseCell{p[0], 0, 0});
            return 1;
        }
        if (mode == 3) {
            if (!have_seq) fail("repeated sequence table without a table");
            return 0;
        }
        int16_t norm[64];
        int maxsym = MAXSYM[k], log;
        int64_t used = read_ncount(p, n, norm, maxsym, log);
        if (log > MAXLOG[k]) fail("sequence table log too large");
        build_fse(tab[k], norm, maxsym, log);
        return used;
    }

    // a compressed block's output, at most `limit` bytes
    void block(const uint8_t* p, int64_t n, int64_t limit) {
        if (n > h.block_max) fail("compressed block larger than a block");
        int64_t used = literals(p, n, limit);
        p += used;
        n -= used;
        if (n < 1) fail("sequences section missing");
        int64_t nseq = p[0], i = 1;
        if (nseq > 127) {
            if (nseq == 255) {
                if (n < 3) fail("sequence count cut");
                nseq = le(p + 1, 2) + 0x7F00;
                i = 3;
            } else {
                if (n < 2) fail("sequence count cut");
                nseq = ((nseq - 128) << 8) + p[1];
                i = 2;
            }
        }
        const uint8_t* lit = lits.data();
        const uint8_t* lend = lit + lits.size();
        int64_t base = (int64_t)out.size();
        if (nseq == 0) {
            if (i != n) fail("data after an empty sequences section");
        } else {
            if (i + 1 > n) fail("sequence modes missing");
            uint8_t modes = p[i++];
            if (modes & 3) fail("reserved sequence mode bits set");
            i += table(LL, modes >> 6, p + i, n - i);
            i += table(OF, modes >> 4 & 3, p + i, n - i);
            i += table(ML, modes >> 2 & 3, p + i, n - i);
            have_seq = true;
            Back br(p + i, n - i);
            uint32_t sl = br.read(tab[LL].log), so = br.read(tab[OF].log),
                     sm = br.read(tab[ML].log);
            for (int64_t s = 0; s < nseq; ++s) {
                int ofc = tab[OF].t[so].sym, mlc = tab[ML].t[sm].sym,
                    llc = tab[LL].t[sl].sym;
                uint64_t off;
                bool ll0 = llc == 0;
                if (ofc > 1) {
                    off = (1ULL << ofc) - 3 + br.read(ofc);
                    rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = (uint32_t)off;
                } else if (ofc == 0) {
                    off = rep[ll0];
                    rep[1] = rep[!ll0];
                    rep[0] = (uint32_t)off;
                } else {
                    int k = 1 + ll0 + (int)br.read(1);
                    uint64_t t = k == 3 ? (uint64_t)rep[0] - 1 : rep[k];
                    if (t == 0) t = ~0ULL;
                    if (k != 1) rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = (uint32_t)t;
                    off = t;
                }
                uint64_t ml = ML_BASE[mlc] + br.read(ML_BITS[mlc]);
                uint64_t ll = LL_BASE[llc] + br.read(LL_BITS[llc]);
                if (s + 1 < nseq) {
                    const FseCell& a = tab[LL].t[sl];
                    sl = a.base + br.read(a.bits);
                    const FseCell& b = tab[ML].t[sm];
                    sm = b.base + br.read(b.bits);
                    const FseCell& c = tab[OF].t[so];
                    so = c.base + br.read(c.bits);
                }
                int64_t pos = out.size();
                if ((uint64_t)(pos - base) + ll + ml > (uint64_t)limit)
                    fail("sequence past the block's output");
                if ((uint64_t)(lend - lit) < ll)
                    fail("sequence past the literals");
                if (off > (uint64_t)pos + ll - start)
                    fail("match offset before the frame");
                out.insert(out.end(), lit, lit + ll);
                lit += ll;
                size_t from = out.size() - off;
                out.resize(out.size() + ml);
                uint8_t* d = out.data() + out.size() - ml;
                const uint8_t* sp = out.data() + from;
                for (uint64_t j = 0; j < ml; ++j) d[j] = sp[j];
            }
            if (br.left != 0) fail("sequences stream not consumed exactly");
        }
        if ((int64_t)out.size() - base + (lend - lit) > limit)
            fail("literals past the block's output");
        out.insert(out.end(), lit, lend);
    }
};

struct Blk {
    int type;
    bool last;
    int64_t csize, size;     // bytes in the frame, bytes it decodes to
};

Blk block_header(const uint8_t* p, const Header& h) {
    uint32_t v = le(p, 3);
    Blk b{(int)(v >> 1 & 3), (bool)(v & 1), v >> 3, v >> 3};
    if (b.type == 3) fail("reserved block type");
    if (b.type == 1) b.csize = 1;
    if (b.csize > h.block_max) fail("block larger than the frame's blocks");
    return b;
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or -1 where they are
// not all there (or a block header is invalid)
int64_t frame_size(const uint8_t* p, int64_t n, const Header& h) {
    int64_t at = h.size;
    for (;;) {
        if (at + 3 > n) return -1;
        uint32_t v = le(p + at, 3);
        int type = v >> 1 & 3;
        if (type == 3) return -1;
        int64_t cs = type == 1 ? 1 : v >> 3;
        if (at + 3 + cs > n) return -1;
        at += 3 + cs;
        if (v & 1) break;
    }
    if (h.checksum) {
        if (at + 4 > n) return -1;
        at += 4;
    }
    return at;
}

// one whole frame at p in one pass into out (at most `cap` bytes):
// its bytes
int64_t one_pass(const uint8_t* p, int64_t n, const Header& h,
                 std::vector<uint8_t>& out, int64_t cap) {
    Frame f(out, h);
    int64_t at = h.size;
    for (;;) {
        if (at + 3 > n) fail("frame cut in a block header");
        Blk b = block_header(p + at, h);
        at += 3;
        if (at + b.csize > n) fail("frame cut in a block");
        int64_t room = cap - (int64_t)(out.size() - f.start);
        int64_t limit = room < h.block_max ? room : h.block_max;
        if (b.type == 2) {
            f.block(p + at, b.csize, limit);
        } else {
            if (b.size > limit) fail("block past the output");
            if (b.type == 0)
                out.insert(out.end(), p + at, p + at + b.size);
            else
                out.insert(out.end(), b.size, p[at]);
        }
        at += b.csize;
        if (b.last) break;
    }
    int64_t got = out.size() - f.start;
    if (h.fcs >= 0 && got != h.fcs) fail("frame content size mismatch");
    if (h.checksum) {
        if (at + 4 > n) fail("checksum cut");
        if ((uint32_t)xxh64(out.data() + f.start, got) != le(p + at, 4))
            fail("checksum mismatch");
        at += 4;
    }
    return at;
}

// libtiff's ZSTDDecode of one strip: `need` bytes into out, or a throw
void tiff_strip(const uint8_t* p, int64_t n, uint8_t* dst, int64_t need) {
    Header h;
    if (frame_header(p, n, h)) fail("strip ends in its frame header");
    if (h.skippable) fail("strip's frame is a skippable frame");
    std::vector<uint8_t> out;
    if (h.fcs >= 0 && need >= h.fcs && frame_size(p, n, h) >= 0) {
        one_pass(p, n, h, out, need);
        if ((int64_t)out.size() < need) fail("frame shorter than the strip");
        memcpy(dst, out.data(), need);
        return;
    }
    uint64_t window = h.window < 1024 ? 1024 : h.window;
    if (window > (1ULL << 27) + 1) fail("window larger than libzstd allows");
    // the streaming output buffer: its room bounds a block where the frame
    // content size is known and smaller
    int64_t bs = h.block_max < (int64_t)window ? h.block_max : (int64_t)window;
    int64_t ring = (int64_t)window + 2 * bs + 64;
    bool bounded = h.fcs >= 0 && h.fcs <= ring;
    Frame f(out, h);
    int64_t at = h.size;
    for (;;) {
        if (at + 3 > n) break;
        Blk b = block_header(p + at, h);
        at += 3;
        int64_t have = (int64_t)out.size();
        int64_t limit = h.block_max;
        if (bounded && h.fcs - have < limit) limit = h.fcs - have;
        if (b.type == 0) {
            // libzstd copies what the input holds of a raw block
            int64_t k = b.size < n - at ? b.size : n - at;
            if (k > limit) fail("block past the output");
            out.insert(out.end(), p + at, p + at + k);
            at += k;
            if (k < b.size) break;
        } else {
            if (at + b.csize > n) break;
            if (b.type == 2) {
                f.block(p + at, b.csize, limit);
            } else {
                if (b.size > limit) fail("block past the output");
                out.insert(out.end(), b.size, p[at]);
            }
            at += b.csize;
        }
        if (b.last && h.fcs >= 0 && (int64_t)out.size() != h.fcs)
            fail("frame content size mismatch");
        // a block whose output the rows cannot take ends the call
        if ((int64_t)out.size() > need) break;
        if (b.last) {
            if (h.checksum) {
                if (at + 4 > n) break;
                if ((uint32_t)xxh64(out.data(), out.size()) != le(p + at, 4))
                    fail("checksum mismatch");
                at += 4;
            }
            break;
        }
    }
    if ((int64_t)out.size() < need) fail("strip data ends before its rows");
    memcpy(dst, out.data(), need);
}

int report(const char* what, char* msg, int len) {
    if (msg && len > 0) snprintf(msg, len, "%s", what);
    return 1;
}

}  // namespace

extern "C" int rls_zstd_tiff(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t need, char* msg, int msglen) {
    try {
        tiff_strip(src, n, dst, need);
        return 0;
    } catch (const Fail& e) {
        return report(e.what, msg, msglen);
    } catch (const Legacy&) {
        return 2;
    }
}

// every frame of src into dst (cap bytes); *got is the bytes written
extern "C" int rls_zstd_frames(const uint8_t* src, int64_t n, uint8_t* dst,
                               int64_t cap, int64_t* got, char* msg,
                               int msglen) {
    try {
        std::vector<uint8_t> out;
        int64_t at = 0;
        while (at < n) {
            Header h;
            if (frame_header(src + at, n - at, h)) fail("input cut in a frame header");
            if (h.skippable) {
                if (h.skip > (uint64_t)(n - at - 8)) fail("skippable frame cut");
                at += 8 + (int64_t)h.skip;
                continue;
            }
            at += one_pass(src + at, n - at, h, out,
                           cap - (int64_t)out.size());
        }
        memcpy(dst, out.data(), out.size());
        *got = (int64_t)out.size();
        return 0;
    } catch (const Fail& e) {
        return report(e.what, msg, msglen);
    } catch (const Legacy&) {
        return 2;
    }
}
