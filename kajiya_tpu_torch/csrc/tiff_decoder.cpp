// The sequential codecs of the TIFF texture decoder (scene/tiff.py), as
// libtiff 4.7.1 runs them for PIL 12.1.0's "libtiff" decoder: PackBits
// (tif_packbits.c PackBitsDecode) and LZW (tif_lzw.c LZWDecode, and
// LZWDecodeCompat for the old bit-reversed codes). Each call decodes one
// strip or tile into `occ` bytes, as TIFFReadEncodedStrip / Tile asks for
// them. Python parses the directory and does the rest (predictors, deflate,
// LZMA, JPEG, unpacking). The encoders of the port's TIFF writer
// (`tiff.write_tiff`, the TIFF-textured city's maps) are here too: LZW as
// libtiff writes it (a clear code first, the width growing one code early,
// a clear when the table fills) and PackBits. Built with g++ at first use
// (hostlib.load) and called through ctypes.
//
// Status codes: 0 done; 1 the codec reports an error (libtiff's decode
// returns 0, TIFFReadEncodedStrip -1, and PIL raises "decoder error").

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { kOk = 0, kError = 1 };

constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kCsize = (1 << kBitsMax) - 1 + 1024;  // libtiff's CSIZE

inline int maxcode(int n) { return (1 << n) - 1; }

struct Entry {
    int next;        // prefix entry, -1 for none
    int length;      // 0 for an entry not filled
    uint8_t value;
    uint8_t firstchar;
};

struct Table {
    std::vector<Entry> e;
    Table() : e(kCsize) {
        for (int c = 0; c < 256; ++c) e[c] = {-1, 1, (uint8_t)c, (uint8_t)c};
        for (int c = 256; c < kCsize; ++c) e[c] = {-1, 0, 0, 0};
    }
    // write the string of entry `c` (its first `n` bytes when n < length)
    void emit(int c, uint8_t* op, long long n) const {
        while (e[c].length > n) c = e[c].next;
        for (long long i = n - 1; i >= 0; --i) {
            op[i] = e[c].value;
            c = e[c].next;
        }
    }
};

// LZWDecode (the rewrite in libtiff 4.3+): MSB-first codes, the width grows
// one code early, running out of bits before `occ` bytes is an error
int lzw_new(const uint8_t* bp, long long n, uint8_t* op, long long occ) {
    Table t;
    int free_ent = -1;          // dec_free_entp; -1 before the first clear
    int old = 0;                // dec_oldcodep
    int nbits = kBitsMin;
    int maxc = maxcode(kBitsMin) - 1;
    uint64_t bitpos = 0;
    const uint64_t nbitsall = (uint64_t)n * 8;
    auto next_code = [&](int& code) -> bool {
        if (bitpos + nbits > nbitsall) return false;   // no EOI
        uint32_t v = 0;
        for (int i = 0; i < nbits; ++i) {
            const uint64_t p = bitpos + i;
            v = (v << 1) | ((bp[p >> 3] >> (7 - (p & 7))) & 1);
        }
        bitpos += nbits;
        code = (int)v;
        return true;
    };
    auto grow = [&]() {
        if (++free_ent > maxc) {
            if (++nbits > kBitsMax) nbits = kBitsMax;
            maxc = maxcode(nbits) - 1;
            if (free_ent >= kCsize) free_ent = -1;
        }
    };
    while (occ > 0) {
        int code;
        if (!next_code(code)) return kError;
        if (code == kEoi) break;
        if (code == kClear) {
            free_ent = kFirst;
            nbits = kBitsMin;
            maxc = maxcode(kBitsMin) - 1;
            do {
                if (!next_code(code)) return kError;
            } while (code == kClear);
            if (code == kEoi) break;
            if (code > kEoi) return kError;
            *op++ = (uint8_t)code;
            --occ;
            old = code;
            continue;
        }
        if (code < 256) {
            if (code > free_ent) return kError;   // includes free_ent == -1
            Entry& f = t.e[free_ent];
            f.next = old;
            f.firstchar = t.e[old].firstchar;
            f.length = t.e[old].length + 1;
            f.value = (uint8_t)code;
            grow();
            old = code;
            *op++ = (uint8_t)code;
            --occ;
            continue;
        }
        // code >= 258
        if (free_ent < 0 || code > free_ent) return kError;
        uint8_t value = code == free_ent ? t.e[old].firstchar
                                         : t.e[code].firstchar;
        Entry& f = t.e[free_ent];
        f.value = value;
        f.next = old;
        f.firstchar = t.e[old].firstchar;
        f.length = t.e[old].length + 1;
        grow();
        old = code;
        const long long len = t.e[code].length;
        const long long k = len < occ ? len : occ;
        t.emit(code, op, k);
        op += k;
        occ -= k;
    }
    return occ > 0 ? kError : kOk;
}

// LZWDecodeCompat: the old LSB-first codes, the width grows when the table
// passes the code's mask, and running out of bits reads as EOI
int lzw_compat(const uint8_t* bp, long long n, uint8_t* op, long long occ) {
    Table t;
    int free_ent = -1;
    int old = 0;
    int nbits = kBitsMin;
    int maxc = maxcode(kBitsMin) - 1;
    uint64_t bitpos = 0;
    const uint64_t nbitsall = (uint64_t)n * 8;
    auto next_code = [&](int& code) {
        if (bitpos + nbits > nbitsall) {
            code = kEoi;
            return;
        }
        uint32_t v = 0;
        for (int i = 0; i < nbits; ++i) {
            const uint64_t p = bitpos + i;
            v |= (uint32_t)((bp[p >> 3] >> (p & 7)) & 1) << i;
        }
        bitpos += nbits;
        code = (int)v;
    };
    while (occ > 0) {
        int code;
        next_code(code);
        if (code == kEoi) break;
        if (code == kClear) {
            do {
                free_ent = kFirst;
                for (int c = kFirst; c < kCsize; ++c) t.e[c] = {-1, 0, 0, 0};
                nbits = kBitsMin;
                maxc = maxcode(kBitsMin);
                next_code(code);
            } while (code == kClear);
            if (code == kEoi) break;
            if (code > kClear) return kError;
            *op++ = (uint8_t)code;
            --occ;
            old = code;
            continue;
        }
        if (free_ent < 0 || free_ent >= kCsize) return kError;
        Entry& f = t.e[free_ent];
        f.next = old;
        f.firstchar = t.e[old].firstchar;
        f.length = t.e[old].length + 1;
        f.value = code < free_ent ? t.e[code].firstchar : f.firstchar;
        if (++free_ent > maxc) {
            if (++nbits > kBitsMax) nbits = kBitsMax;
            maxc = maxcode(nbits);
        }
        old = code;
        if (code >= 256) {
            const long long len = t.e[code].length;
            if (len == 0) return kError;
            const long long k = len < occ ? len : occ;
            t.emit(code, op, k);
            op += k;
            occ -= k;
        } else {
            *op++ = (uint8_t)code;
            --occ;
        }
    }
    return occ > 0 ? kError : kOk;
}

}  // namespace

extern "C" {

// PackBitsDecode over one strip or tile: runs may cross rows, a run that
// passes the end is cut, and data that ends before `occ` bytes is an error.
int kt_tiff_packbits(const uint8_t* bp, long long cc, uint8_t* op,
                     long long occ) {
    while (cc > 0 && occ > 0) {
        long n = (int8_t)*bp++;
        cc--;
        if (n < 0) {
            if (n == -128) continue;
            n = -n + 1;
            if (occ < n) n = (long)occ;
            if (cc == 0) break;
            occ -= n;
            const uint8_t b = *bp++;
            cc--;
            std::memset(op, b, (size_t)n);
            op += n;
        } else {
            if (occ < n + 1) n = (long)occ - 1;
            if (cc < n + 1) break;
            ++n;
            std::memcpy(op, bp, (size_t)n);
            op += n;
            occ -= n;
            bp += n;
            cc -= n;
        }
    }
    return occ > 0 ? kError : kOk;
}

// LZW over one strip or tile. *compat is in-out: libtiff switches to the
// old decoder at the first strip that starts 00 x1 (odd), and keeps it for
// the rest of the image.
int kt_tiff_lzw(const uint8_t* bp, long long cc, uint8_t* op, long long occ,
                int* compat) {
    if (cc >= 2 && bp[0] == 0 && (bp[1] & 1)) *compat = 1;
    return *compat ? lzw_compat(bp, cc, op, occ) : lzw_new(bp, cc, op, occ);
}

// LZW-encode n bytes into out (capacity cap); returns the bytes written,
// or -1 where cap is too small.
long long kt_tiff_lzw_encode(const uint8_t* in, long long n, uint8_t* out,
                             long long cap) {
    // (prefix, byte) -> code; a slot counts only when stamped with the
    // current table's generation, so a clear costs nothing
    std::vector<int32_t> table((size_t)4096 * 256, -1);
    std::vector<int32_t> stamp((size_t)4096 * 256, -1);
    int gen = 0;
    long long len = 0;
    uint64_t acc = 0;
    int nacc = 0, nbits = kBitsMin, next = kFirst;
    bool full = false;
    auto put = [&](int code) {
        acc = (acc << nbits) | (uint64_t)code;
        nacc += nbits;
        while (nacc >= 8) {
            if (len >= cap) full = true;
            else out[len] = (uint8_t)(acc >> (nacc - 8));
            ++len;
            nacc -= 8;
        }
    };
    put(kClear);
    if (n > 0) {
        int w = in[0];
        for (long long i = 1; i < n; ++i) {
            const int c = in[i];
            const size_t k = (size_t)w * 256 + c;
            if (stamp[k] == gen) {
                w = table[k];
                continue;
            }
            put(w);
            stamp[k] = gen;
            table[k] = next++;
            if (next == 512 || next == 1024 || next == 2048) ++nbits;
            if (next == 4094) {
                put(kClear);
                ++gen;
                next = kFirst;
                nbits = kBitsMin;
            }
            w = c;
        }
        put(w);
    }
    put(kEoi);
    if (nacc > 0) {
        if (len >= cap) full = true;
        else out[len] = (uint8_t)(acc << (8 - nacc));
        ++len;
    }
    return full ? -1 : len;
}

// PackBits-encode n bytes (runs of 2 to 128 equal bytes, literals of up to
// 128) into out, which holds 2 n + 2 bytes; returns the length.
long long kt_tiff_packbits_encode(const uint8_t* in, long long n,
                                  uint8_t* out) {
    long long i = 0, len = 0;
    while (i < n) {
        long long j = i;
        while (j + 1 < n && in[j + 1] == in[i] && j - i < 127) ++j;
        if (j > i) {
            out[len++] = (uint8_t)(257 - (j - i + 1));
            out[len++] = in[i];
            i = j + 1;
            continue;
        }
        j = i;
        while (j < n && j - i < 128 && !(j + 1 < n && in[j + 1] == in[j])) ++j;
        if (j == i) j = i + 1;
        out[len++] = (uint8_t)(j - i - 1);
        std::memcpy(out + len, in + i, (size_t)(j - i));
        len += j - i;
        i = j;
    }
    return len;
}

}  // extern "C"
