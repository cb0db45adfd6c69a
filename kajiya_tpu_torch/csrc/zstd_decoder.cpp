// zstd (RFC 8878) for the TIFF texture decoder (scene/tiff.py, compression
// 50000), as libtiff 4.7.1's tif_zstd.c drives libzstd 1.5.7 under PIL
// 12.1.0: ZSTDDecode calls ZSTD_decompressStream until the frame ends, the
// input runs out or `occ` bytes are out, and fails on an error or on short
// output. The decoder follows libzstd's frame, block, literals and
// sequences decoding with its validity checks (the reserved bits and block
// type, FSE accuracy limits, the Huffman weights, an offset beyond the
// history, a match or literals past the block, the exact end of each
// bitstream, the frame content size, the XXH64 checksum), and its two
// routes: the single pass libzstd takes when the whole frame is in the input
// and its content size fits the output, and the buffered stream otherwise,
// whose output can fill before the frame's end is checked. The encoder
// writes the frames of the port's TIFF writer: compressed blocks from a
// hash-chain LZ77 matcher with raw literals and predefined-mode sequences,
// RLE blocks for constant runs and raw blocks where nothing is gained.
// Built with g++ at first use (hostlib.load) and called through ctypes.
//
// Status codes: 0 done; 1 libzstd reports an error or the output is short
// (TIFFReadEncodedStrip fails, PIL raises); 2 an outcome the port does not
// model (NotImplementedError in Python).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { kOk = 0, kFail = 1, kUnmodelled = 2 };
struct Stop {
  int code;
};
[[noreturn]] void fail() { throw Stop{kFail}; }
[[noreturn]] void unmodelled() { throw Stop{kUnmodelled}; }

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t)p[1] << 8; }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t)p[2] << 16; }
inline uint32_t rd32(const uint8_t* p) { return rd24(p) | (uint32_t)p[3] << 24; }
inline uint64_t rd64(const uint8_t* p) {
  return rd32(p) | (uint64_t)rd32(p + 4) << 32;
}
inline unsigned highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// XXH64 (the frame checksum is its low 32 bits, seed 0)
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round1(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t merge(uint64_t acc, uint64_t v) {
  acc ^= round1(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (p + 32 <= end) {
      v1 = round1(v1, rd64(p));
      v2 = round1(v2, rd64(p + 8));
      v3 = round1(v3, rd64(p + 16));
      v4 = round1(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= round1(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// the backward bit stream (bitstream.h's BIT_DStream_t, 64-bit container)
// ---------------------------------------------------------------------------

enum { kUnfinished = 0, kEndOfBuffer = 1, kCompleted = 2, kOverflow = 3 };

struct BitD {
  uint64_t c = 0;
  unsigned consumed = 0;
  const uint8_t* ptr = nullptr;  // nullptr: libzstd's zero-filled word
  const uint8_t* start = nullptr;
  const uint8_t* limit = nullptr;

  // BIT_initDStream: false where libzstd returns an error
  bool init(const uint8_t* src, size_t size) {
    if (size < 1) return false;
    start = src;
    limit = src + 8;
    const uint8_t last = src[size - 1];
    if (size >= 8) {
      ptr = src + size - 8;
      c = rd64(ptr);
      consumed = last ? 8 - highbit(last) : 0;
      if (!last) return false;
    } else {
      ptr = start;
      c = 0;
      for (size_t i = 0; i < size; i++) c |= (uint64_t)src[i] << (8 * i);
      consumed = last ? 8 - highbit(last) : 0;
      if (!last) return false;
      consumed += (unsigned)(8 - size) * 8;
    }
    return true;
  }
  uint64_t look(unsigned nb) const {
    const unsigned start_bit = (64 - consumed - nb) & 63;
    return (c >> start_bit) & ((nb >= 64 ? 0 : (1ULL << nb)) - 1);
  }
  uint64_t look_fast(unsigned nb) const {
    return (c << (consumed & 63)) >> ((64 - nb) & 63);
  }
  uint64_t read(unsigned nb) {
    uint64_t v = look(nb);
    consumed += nb;
    return v;
  }
  uint64_t read_fast(unsigned nb) {
    uint64_t v = look_fast(nb);
    consumed += nb;
    return v;
  }
  int reload_internal() {
    ptr -= consumed >> 3;
    consumed &= 7;
    c = rd64(ptr);
    return kUnfinished;
  }
  int reload() {
    if (consumed > 64) {
      ptr = nullptr;
      return kOverflow;
    }
    if (ptr == nullptr) return kOverflow;  // stays in overflow mode
    if (ptr >= limit) return reload_internal();
    if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
    unsigned nbytes = consumed >> 3;
    int result = kUnfinished;
    if (ptr - nbytes < start) {
      nbytes = (unsigned)(ptr - start);
      result = kEndOfBuffer;
    }
    ptr -= nbytes;
    consumed -= nbytes * 8;
    c = rd64(ptr);
    return result;
  }
  bool end() const { return ptr == start && consumed == 64; }
};

// ---------------------------------------------------------------------------
// FSE (entropy_common.c's FSE_readNCount, the decoding tables)
// ---------------------------------------------------------------------------

inline unsigned ctz32(uint32_t v) { return (unsigned)__builtin_ctz(v); }

// FSE_readNCount_body; returns the header size, throws on an error
size_t read_ncount_body(int16_t* norm, unsigned* max_sv, unsigned* table_log,
                        const uint8_t* hb, size_t hb_size) {
  const uint8_t* const istart = hb;
  const uint8_t* const iend = hb + hb_size;
  const uint8_t* ip = istart;
  const unsigned max_sv1 = *max_sv + 1;
  int previous0 = 0;
  std::memset(norm, 0, (*max_sv + 1) * sizeof(int16_t));
  uint32_t bits = rd32(ip);
  int nb = (int)(bits & 0xF) + 5;
  if (nb > 15) fail();
  bits >>= 4;
  int bit_count = 4;
  *table_log = (unsigned)nb;
  int remaining = (1 << nb) + 1;
  int threshold = 1 << nb;
  nb++;
  unsigned charnum = 0;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (bit_count >> 3) <= iend - 4) {
      ip += bit_count >> 3;
      bit_count &= 7;
    } else {
      bit_count -= (int)(8 * (iend - 4 - ip));
      bit_count &= 31;
      ip = iend - 4;
    }
    bits = rd32(ip) >> bit_count;
  };
  for (;;) {
    if (previous0) {
      int repeats = (int)(ctz32(~bits | 0x80000000u) >> 1);
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bit_count -= (int)(8 * (iend - 7 - ip));
          bit_count &= 31;
          ip = iend - 4;
        }
        bits = rd32(ip) >> bit_count;
        repeats = (int)(ctz32(~bits | 0x80000000u) >> 1);
      }
      charnum += 3 * repeats;
      bits >>= 2 * repeats;
      bit_count += 2 * repeats;
      charnum += bits & 3;
      bit_count += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    {
      const int max = (2 * threshold - 1) - remaining;
      int count;
      if ((int)(bits & (threshold - 1)) < max) {
        count = (int)(bits & (threshold - 1));
        bit_count += nb - 1;
      } else {
        count = (int)(bits & (2 * threshold - 1));
        if (count >= threshold) count -= max;
        bit_count += nb;
      }
      count--;
      if (count >= 0)
        remaining -= count;
      else
        remaining += count;
      norm[charnum++] = (int16_t)count;
      previous0 = !count;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nb = (int)highbit((uint32_t)remaining) + 1;
        threshold = 1 << (nb - 1);
      }
      if (charnum >= max_sv1) break;
      advance();
    }
  }
  if (remaining != 1) fail();
  if (charnum > max_sv1) fail();
  if (bit_count > 32) fail();
  *max_sv = charnum - 1;
  ip += (bit_count + 7) >> 3;
  return (size_t)(ip - istart);
}

size_t read_ncount(int16_t* norm, unsigned* max_sv, unsigned* table_log,
                   const uint8_t* hb, size_t hb_size) {
  if (hb_size < 8) {
    uint8_t buf[8] = {0};
    std::memcpy(buf, hb, hb_size);
    size_t n = read_ncount_body(norm, max_sv, table_log, buf, 8);
    if (n > hb_size) fail();
    return n;
  }
  return read_ncount_body(norm, max_sv, table_log, hb, hb_size);
}

// symbol spread shared by both table kinds: symbols by position
bool spread(const int16_t* norm, unsigned max_sv, unsigned table_log,
            uint16_t* symbol_of, uint16_t* next) {
  const uint32_t size = 1u << table_log;
  uint32_t high = size - 1;
  for (unsigned s = 0; s <= max_sv; s++) {
    if (norm[s] == -1) {
      symbol_of[high--] = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)norm[s];
    }
  }
  const uint32_t mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  uint32_t pos = 0;
  for (unsigned s = 0; s <= max_sv; s++)
    for (int i = 0; i < norm[s]; i++) {
      symbol_of[pos] = (uint16_t)s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  return pos == 0;
}

struct SeqSym {
  uint16_t next;
  uint8_t add_bits;
  uint8_t nb_bits;
  uint32_t base;
};
struct SeqTable {
  unsigned log = 0;
  SeqSym t[512];
};

void build_seq_table(SeqTable& dt, const int16_t* norm, unsigned max_sv,
                     unsigned table_log, const uint32_t* base,
                     const uint8_t* bits) {
  uint16_t sym[512], next[64];
  spread(norm, max_sv, table_log, sym, next);
  const uint32_t size = 1u << table_log;
  dt.log = table_log;
  for (uint32_t u = 0; u < size; u++) {
    const unsigned s = sym[u];
    const uint32_t ns = next[s]++;
    const uint8_t nb = (uint8_t)(table_log - highbit(ns));
    dt.t[u].nb_bits = nb;
    dt.t[u].next = (uint16_t)((ns << nb) - size);
    dt.t[u].add_bits = bits[s];
    dt.t[u].base = base[s];
  }
}

const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,
    13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40, 48, 64,
    0x80, 0x100, 0x200, 0x400, 0x800, 0x1000, 0x2000, 0x4000, 0x8000,
    0x10000};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 0x83, 0x103, 0x203, 0x403, 0x803, 0x1003,
    0x2003, 0x4003, 0x8003, 0x10003};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
uint32_t OF_BASE[32];
uint8_t OF_BITS[32];
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
  SeqTable ll, ml, of;
  Defaults() {
    for (int i = 0; i < 32; i++) {
      OF_BITS[i] = (uint8_t)i;
      OF_BASE[i] = i < 2 ? (uint32_t)i : (1u << i) - 3;
    }
    build_seq_table(ll, LL_DEFAULT, 35, 6, LL_BASE, LL_BITS);
    build_seq_table(ml, ML_DEFAULT, 52, 6, ML_BASE, ML_BITS);
    build_seq_table(of, OF_DEFAULT, 28, 5, OF_BASE, OF_BITS);
  }
};
const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// FSE_decompress_wksp for the Huffman weights: at most `cap` symbols
size_t fse_decode_weights(uint8_t* dst, size_t cap, const uint8_t* src,
                          size_t size) {
  int16_t norm[256];
  unsigned max_sv = 255, table_log;
  const size_t hsize = read_ncount(norm, &max_sv, &table_log, src, size);
  if (table_log > 6) fail();
  src += hsize;
  size -= hsize;
  struct Ent {
    uint16_t next;
    uint8_t sym, nb;
  } t[64];
  uint16_t sym[64], next[256];
  const uint32_t tsize = 1u << table_log;
  bool fast = true;
  for (unsigned s = 0; s <= max_sv; s++)
    if (norm[s] >= (int16_t)(1 << (table_log - 1))) fast = false;
  if (!spread(norm, max_sv, table_log, sym, next)) fail();
  for (uint32_t u = 0; u < tsize; u++) {
    const unsigned s = sym[u];
    const uint32_t ns = next[s]++;
    t[u].sym = (uint8_t)s;
    t[u].nb = (uint8_t)(table_log - highbit(ns));
    t[u].next = (uint16_t)((ns << t[u].nb) - tsize);
  }
  BitD bd;
  if (!bd.init(src, size)) fail();
  uint32_t s1 = (uint32_t)bd.read(table_log);
  bd.reload();
  uint32_t s2 = (uint32_t)bd.read(table_log);
  bd.reload();
  if (bd.reload() == kOverflow) fail();
  auto get = [&](uint32_t& st) -> uint8_t {
    const Ent& e = t[st];
    const uint64_t low = fast ? bd.read_fast(e.nb) : bd.read(e.nb);
    st = e.next + (uint32_t)low;
    return e.sym;
  };
  uint8_t* op = dst;
  uint8_t* const omax = dst + cap;
  uint8_t* const olimit = omax - 3;
  for (; (bd.reload() == kUnfinished) & (op < olimit); op += 4) {
    op[0] = get(s1);
    op[1] = get(s2);
    op[2] = get(s1);
    op[3] = get(s2);
  }
  for (;;) {
    if (op > omax - 2) fail();
    *op++ = get(s1);
    if (bd.reload() == kOverflow) {
      *op++ = get(s2);
      break;
    }
    if (op > omax - 2) fail();
    *op++ = get(s2);
    if (bd.reload() == kOverflow) {
      *op++ = get(s1);
      break;
    }
  }
  return (size_t)(op - dst);
}

// ---------------------------------------------------------------------------
// Huffman literals (huf_decompress.c)
// ---------------------------------------------------------------------------

struct Huff {
  bool defined = false;
  bool x2 = false;  // the table type of the last 4-stream build
  unsigned log = 0;
  std::vector<uint8_t> sym, nb;  // by (log)-bit lookup value
};

// HUF_readStats + the table; returns the header size
size_t read_huff(Huff& h, const uint8_t* src, size_t size) {
  if (!size) fail();
  uint8_t w[256];
  size_t isize = src[0], osize;
  if (isize >= 128) {
    osize = isize - 127;
    isize = (osize + 1) / 2;
    if (isize + 1 > size) fail();
    for (size_t n = 0; n < osize; n += 2) {
      w[n] = src[1 + n / 2] >> 4;
      w[n + 1] = src[1 + n / 2] & 15;
    }
  } else {
    if (isize + 1 > size) fail();
    osize = fse_decode_weights(w, 255, src + 1, isize);
  }
  uint32_t rank[13] = {0}, total = 0;
  for (size_t n = 0; n < osize; n++) {
    if (w[n] > 12) fail();
    rank[w[n]]++;
    total += (1u << w[n]) >> 1;
  }
  if (total == 0) fail();
  const unsigned log = highbit(total) + 1;
  if (log > 12) fail();
  const uint32_t rest = (1u << log) - total;
  if ((1u << highbit(rest)) != rest) fail();
  const unsigned last = highbit(rest) + 1;
  w[osize] = (uint8_t)last;
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) fail();
  const size_t nsym = osize + 1;
  // canonical codes: weight w -> length log + 1 - w, codes assigned from
  // the longest (weight 1) up, symbols in order within a weight
  h.log = log;
  h.sym.assign((size_t)1 << log, 0);
  h.nb.assign((size_t)1 << log, 0);
  uint32_t start[14] = {0};
  {
    uint32_t next = 0;
    for (unsigned wt = 1; wt <= log; wt++) {
      start[wt] = next;
      next += rank[wt] << (wt - 1);
    }
  }
  for (size_t s = 0; s < nsym; s++) {
    const unsigned wt = w[s];
    if (!wt) continue;
    const uint32_t len = 1u << (wt - 1);
    for (uint32_t i = 0; i < len; i++) {
      h.sym[start[wt] + i] = (uint8_t)s;
      h.nb[start[wt] + i] = (uint8_t)(log + 1 - wt);
    }
    start[wt] += len;
  }
  h.defined = true;
  return isize + 1;
}

// the `nb` bits of a stream below its bit `r` (bit i is bit i % 8 of byte
// i / 8; bits before the stream's first read as zeros), highest first
inline uint32_t peek(const uint8_t* s, size_t size, long long r,
                     unsigned nb) {
  const long long lo = r - nb;
  const long long from = lo < 0 ? 0 : lo;
  uint32_t w = 0;
  for (size_t k = 0, b = (size_t)(from >> 3); k < 4 && b + k < size; k++)
    w |= (uint32_t)s[b + k] << (8 * k);
  if (lo >= 0) return (w >> (lo & 7)) & ((1u << nb) - 1);
  return r <= 0 ? 0 : (w & ((1u << r) - 1)) << (-lo);
}

// one stream of n symbols; false where the stream does not end exactly
bool huff_stream(const Huff& h, const uint8_t* src, size_t size, uint8_t* out,
                 size_t n) {
  BitD bd;
  if (!bd.init(src, size)) fail();
  // a lookup past the stream's first bit reads zeros; a stream whose codes
  // do not use its bits exactly is the decoder's error
  long long remaining = (long long)(bd.ptr - bd.start) * 8 + 64 - bd.consumed;
  for (size_t k = 0; k < n; k++) {
    const uint32_t v = peek(src, size, remaining, h.log);
    out[k] = h.sym[v];
    remaining -= h.nb[v];
  }
  return remaining == 0;
}

// HUF_selectDecoder: 1 for the double-symbol decoder
bool select_x2(size_t dst, size_t csrc) {
  static const uint32_t t[16][2][2] = {
      {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},
      {{150, 216}, {381, 119}}, {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}},
      {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}},
      {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}},
      {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  const uint32_t q = csrc >= dst ? 15 : (uint32_t)(csrc * 16 / dst);
  const uint32_t d256 = (uint32_t)(dst >> 8);
  const uint32_t t0 = t[q][0][0] + t[q][0][1] * d256;
  uint32_t t1 = t[q][1][0] + t[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// HUF_decompress4X1_usingDTable_internal_fast: libzstd's fast loop over
// the four streams (11-bit lookups, 5 symbols a stream between reloads),
// then each stream finished by HUF_decodeStreamX1 from a bit stream whose
// start is the first byte of the jump table. It checks neither stream's
// exact end: corrupt streams decode to what these reads give. Returns -1
// where libzstd does not take it.
int huff_fast_x1(const Huff& h, const uint8_t* src, size_t size, uint8_t* out,
                 size_t n) {
  if (h.log > 11) return -1;
  const size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  const size_t l4 = size - (l1 + l2 + l3 + 6);
  if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return -1;
  if (l4 > size) fail();
  const uint8_t* iend[4] = {src + 6, src + 6 + l1, src + 6 + l1 + l2,
                            src + 6 + l1 + l2 + l3};
  const uint8_t* ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8,
                          src + size - 8};
  const size_t seg = (n + 3) / 4;
  size_t op[4] = {0, seg, 2 * seg, 3 * seg};
  if (op[3] >= n) return -1;
  // the 11-bit table: (symbol << 8) | length
  uint16_t dt[2048];
  for (uint32_t v = 0; v < 2048; v++) {
    const uint32_t i = v >> (11 - h.log);
    dt[v] = (uint16_t)((h.sym[i] << 8) | h.nb[i]);
  }
  uint64_t bits[4];
  for (int k = 0; k < 4; k++) {
    const uint8_t last = ip[k][7];
    const unsigned c = last ? 8 - highbit(last) : 0;
    bits[k] = (rd64(ip[k]) | 1) << c;
  }
  for (;;) {
    const size_t oiters = (n - op[3]) / 5;
    const size_t iiters = (size_t)(ip[0] - src) / 7;
    const size_t olimit = op[3] + std::min(oiters, iiters) * 5;
    if (op[3] == olimit) break;
    bool crossed = false;
    for (int k = 1; k < 4; k++) crossed |= ip[k] < ip[k - 1];
    if (crossed) break;
    do {
      for (int j = 0; j < 5; j++)
        for (int k = 0; k < 4; k++) {
          const uint16_t e = dt[bits[k] >> 53];
          bits[k] <<= (e & 0x3F);
          out[op[k] + j] = (uint8_t)(e >> 8);
        }
      for (int k = 0; k < 4; k++) {
        const int ctz = __builtin_ctzll(bits[k]);
        op[k] += 5;
        ip[k] -= ctz >> 3;
        bits[k] = (rd64(ip[k]) | 1) << (ctz & 7);
      }
    } while (op[3] < olimit);
  }
  size_t seg_end = 0;
  for (int k = 0; k < 4; k++) {
    seg_end = seg <= n - seg_end ? seg_end + seg : n;
    if (op[k] > seg_end) fail();
    if (ip[k] < iend[k] - 8) fail();
    BitD bd;
    bd.c = rd64(ip[k]);
    bd.consumed = (unsigned)__builtin_ctzll(bits[k]);
    bd.start = src;
    bd.limit = src + 8;
    bd.ptr = ip[k];
    size_t p = op[k];
    auto one = [&]() {
      const uint16_t e = dt[bd.look_fast(11)];
      bd.consumed += e & 0xFF;
      out[p++] = (uint8_t)(e >> 8);
    };
    if (seg_end - p > 3) {
      while ((bd.reload() == kUnfinished) & (p < seg_end - 3)) {
        one();
        one();
        one();
        one();
      }
    } else {
      bd.reload();
    }
    while (p < seg_end) one();
  }
  return 1;
}

void huff_decode(const Huff& h, bool four, const uint8_t* src, size_t size,
                 uint8_t* out, size_t n, bool x2) {
  if (four && !x2 && size >= 10 && n > 0 && huff_fast_x1(h, src, size, out, n) >= 0)
    return;
  if (!four) {
    if (!huff_stream(h, src, size, out, n)) {
      if (x2) unmodelled();
      fail();
    }
    return;
  }
  if (size < 10) fail();
  if (n < 6) fail();
  const size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  const size_t l4 = size - (l1 + l2 + l3 + 6);
  if (l4 > size) fail();
  const size_t seg = (n + 3) / 4;
  if (3 * seg > n) fail();
  const uint8_t* p = src + 6;
  bool ok = true;
  ok &= huff_stream(h, p, l1, out, seg);
  ok &= huff_stream(h, p + l1, l2, out + seg, seg);
  ok &= huff_stream(h, p + l1 + l2, l3, out + 2 * seg, seg);
  ok &= huff_stream(h, p + l1 + l2 + l3, l4, out + 3 * seg, n - 3 * seg);
  if (!ok) {
    if (x2) unmodelled();
    fail();
  }
}

// ---------------------------------------------------------------------------
// the frame decoder
// ---------------------------------------------------------------------------

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint64_t kUnknown = ~0ULL;

struct Frame {
  uint64_t fcs = kUnknown;
  uint64_t window = 0;
  size_t block_max = 0;
  bool checksum = false;
  uint32_t dict = 0;
  size_t header = 0;
  bool skippable = false;
  uint32_t skip_size = 0;
};

// ZSTD_getFrameHeader_advanced over a complete header; false when the input
// holds less than the header (throws on an error; for ZSTDDecode both end
// the same way)
bool frame_header(const uint8_t* s, size_t n, Frame& f) {
  if (n < 5) return false;
  const uint32_t magic = rd32(s);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) return false;
    f.skippable = true;
    f.skip_size = rd32(s + 4);
    f.header = 8;
    return true;
  }
  if (magic != 0xFD2FB528u) fail();
  const uint8_t fhd = s[4];
  const unsigned dict_id = fhd & 3, checksum = (fhd >> 2) & 1,
                 single = (fhd >> 5) & 1, fcs_id = fhd >> 6;
  static const size_t dict_sz[4] = {0, 1, 2, 4};
  static const size_t fcs_sz[4] = {0, 2, 4, 8};
  const size_t hsize = 5 + !single + dict_sz[dict_id] + fcs_sz[fcs_id] +
                       (single && !fcs_id);
  if (n < hsize) return false;
  if (fhd & 0x08) fail();  // reserved bit
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    const uint8_t wl = s[pos++];
    const unsigned wlog = (wl >> 3) + 10;
    if (wlog > 31) fail();
    window = 1ULL << wlog;
    window += (window >> 3) * (wl & 7);
  }
  uint32_t dict = 0;
  if (dict_id == 1) dict = s[pos];
  if (dict_id == 2) dict = rd16(s + pos);
  if (dict_id == 3) dict = rd32(s + pos);
  pos += dict_sz[dict_id];
  uint64_t fcs = kUnknown;
  switch (fcs_id) {
    case 0: if (single) fcs = s[pos]; break;
    case 1: fcs = rd16(s + pos) + 256; break;
    case 2: fcs = rd32(s + pos); break;
    case 3: fcs = rd64(s + pos); break;
  }
  if (single) window = fcs;
  f.fcs = fcs;
  f.window = window;
  f.block_max = (size_t)std::min<uint64_t>(window, kBlockMax);
  f.checksum = checksum;
  f.dict = dict;
  f.header = hsize;
  return true;
}

struct Decoder {
  // frame state
  Frame f;
  std::vector<uint8_t> hist;  // the frame's output so far
  uint32_t rep[3] = {1, 4, 8};
  Huff huf;
  bool lit_entropy = false, fse_entropy = false;
  SeqTable ll_t, of_t, ml_t;
  const SeqTable *ll = nullptr, *of = nullptr, *ml = nullptr;
  bool wrapped = false;  // the stream's buffer restarted from its start

  std::vector<uint8_t> lit;

  size_t seq_table(SeqTable& space, const SeqTable*& cur, int type,
                   unsigned max, unsigned max_log, const uint8_t* src,
                   size_t size, const uint32_t* base, const uint8_t* bits,
                   const SeqTable& def) {
    switch (type) {
      case 1: {  // RLE
        if (!size) fail();
        if (src[0] > max) fail();
        space.log = 0;
        space.t[0] = {0, bits[src[0]], 0, base[src[0]]};
        cur = &space;
        return 1;
      }
      case 0:
        cur = &def;
        return 0;
      case 3:
        if (!fse_entropy) fail();
        return 0;
      default: {
        int16_t norm[64];
        unsigned log, m = max;
        const size_t hs = read_ncount(norm, &m, &log, src, size);
        if (log > max_log) fail();
        build_seq_table(space, norm, m, log, base, bits);
        cur = &space;
        return hs;
      }
    }
  }

  // ZSTD_decompressBlock_internal: the block appended to hist; `cap` is
  // the room the block may fill
  void compressed_block(const uint8_t* src, size_t size, size_t cap) {
    if (size > f.block_max) fail();
    // literals
    if (size < 2) fail();
    const int ltype = src[0] & 3;
    const size_t expected = std::min(f.block_max, cap);
    size_t lsize, consumed;
    if (ltype == 0 || ltype == 1) {
      const unsigned lhl = (src[0] >> 2) & 3;
      size_t lh;
      if (lhl == 1) {
        lh = 2;
        if (ltype == 1 && size < 3) fail();
        lsize = rd16(src) >> 4;
      } else if (lhl == 3) {
        lh = 3;
        if (size < (ltype == 1 ? 4u : 3u)) fail();
        lsize = rd24(src) >> 4;
      } else {
        lh = 1;
        lsize = src[0] >> 3;
      }
      if (lsize > f.block_max) fail();
      if (expected < lsize) fail();
      lit.resize(lsize);
      if (ltype == 0) {
        if (lh + lsize > size) fail();
        std::memcpy(lit.data(), src + lh, lsize);
        consumed = lh + lsize;
      } else {
        std::memset(lit.data(), src[lh], lsize);
        consumed = lh + 1;
      }
    } else {
      if (ltype == 3 && !lit_entropy) fail();
      if (size < 5) fail();
      const unsigned lhl = (src[0] >> 2) & 3;
      const uint32_t lhc = rd32(src);
      size_t lh, csize;
      bool single = false;
      if (lhl <= 1) {
        single = lhl == 0;
        lh = 3;
        lsize = (lhc >> 4) & 0x3FF;
        csize = (lhc >> 14) & 0x3FF;
      } else if (lhl == 2) {
        lh = 4;
        lsize = (lhc >> 4) & 0x3FFF;
        csize = lhc >> 18;
      } else {
        lh = 5;
        lsize = (lhc >> 4) & 0x3FFFF;
        csize = (lhc >> 22) + ((size_t)src[4] << 10);
      }
      if (lsize > f.block_max) fail();
      if (!single && lsize < 6) fail();
      if (csize + lh > size) fail();
      if (expected < lsize) fail();
      lit.resize(lsize);
      const uint8_t* hp = src + lh;
      size_t hsize = csize;
      if (ltype == 2) {
        const size_t th = read_huff(huf, hp, hsize);
        hp += th;
        hsize -= th;
        // the 4-stream route builds the table type libzstd selects
        huf.x2 = !single && select_x2(lsize, csize);
      }
      if (ltype == 2 && hsize == 0) fail();
      if (csize == 0) fail();
      huff_decode(huf, !single, hp, hsize, lit.data(), lsize, huf.x2);
      lit_entropy = true;
      consumed = lh + csize;
    }
    src += consumed;
    size -= consumed;
    // sequences header
    if (size < 1) fail();
    const uint8_t* ip = src;
    const uint8_t* const iend = src + size;
    int nb_seq = *ip++;
    if (nb_seq > 0x7F) {
      if (nb_seq == 0xFF) {
        if (ip + 2 > iend) fail();
        nb_seq = (int)rd16(ip) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) fail();
        nb_seq = ((nb_seq - 0x80) << 8) + *ip++;
      }
    }
    const size_t start = hist.size();
    if (nb_seq == 0) {
      if (ip != iend) fail();
    } else {
      if (ip + 1 > iend) fail();
      if (*ip & 3) fail();
      const int llt = *ip >> 6, oft = (*ip >> 4) & 3, mlt = (*ip >> 2) & 3;
      ip++;
      const Defaults& d = defaults();
      ip += seq_table(ll_t, ll, llt, 35, 9, ip, (size_t)(iend - ip), LL_BASE,
                      LL_BITS, d.ll);
      ip += seq_table(of_t, of, oft, 31, 8, ip, (size_t)(iend - ip), OF_BASE,
                      OF_BITS, d.of);
      ip += seq_table(ml_t, ml, mlt, 52, 9, ip, (size_t)(iend - ip), ML_BASE,
                      ML_BITS, d.ml);
    }
    if (cap == 0 && nb_seq > 0) fail();
    size_t litpos = 0;
    const size_t oend = start + cap;
    if (nb_seq) {
      fse_entropy = true;
      size_t prev[3] = {rep[0], rep[1], rep[2]};
      BitD bd;
      if (!bd.init(ip, (size_t)(iend - ip))) fail();
      uint32_t sll = (uint32_t)bd.read(ll->log);
      bd.reload();
      uint32_t sof = (uint32_t)bd.read(of->log);
      bd.reload();
      uint32_t sml = (uint32_t)bd.read(ml->log);
      bd.reload();
      for (int k = nb_seq; k; k--) {
        const SeqSym& le = ll->t[sll];
        const SeqSym& me = ml->t[sml];
        const SeqSym& oe = of->t[sof];
        size_t mlen = me.base, llen = le.base;
        const unsigned total = le.add_bits + me.add_bits + oe.add_bits;
        size_t offset;
        if (oe.add_bits > 1) {
          offset = oe.base + bd.read_fast(oe.add_bits);
          prev[2] = prev[1];
          prev[1] = prev[0];
          prev[0] = offset;
        } else {
          const unsigned ll0 = le.base == 0;
          if (oe.add_bits == 0) {
            offset = prev[ll0];
            prev[1] = prev[!ll0];
            prev[0] = offset;
          } else {
            offset = oe.base + ll0 + bd.read_fast(1);
            size_t temp = offset == 3 ? prev[0] - 1 : prev[offset];
            temp -= !temp;
            if (offset != 1) prev[2] = prev[1];
            prev[1] = prev[0];
            prev[0] = temp;
            offset = temp;
          }
        }
        if (me.add_bits) mlen += bd.read_fast(me.add_bits);
        if (total >= 57 - (9 + 9 + 8)) bd.reload();
        if (le.add_bits) llen += bd.read_fast(le.add_bits);
        if (k != 1) {
          sll = le.next + (uint32_t)bd.read(le.nb_bits);
          sml = me.next + (uint32_t)bd.read(me.nb_bits);
          sof = oe.next + (uint32_t)bd.read(oe.nb_bits);
          bd.reload();
        }
        // ZSTD_execSequence
        const size_t op = hist.size();
        if (llen + mlen > oend - op) fail();
        if (llen > lit.size() - litpos) fail();
        hist.insert(hist.end(), lit.begin() + (long)litpos,
                    lit.begin() + (long)(litpos + llen));
        litpos += llen;
        const size_t here = hist.size();
        if (offset > here) fail();
        if (wrapped && offset > f.window) unmodelled();
        if (offset == 0) fail();
        const size_t from = here - offset;
        hist.resize(here + mlen);
        for (size_t i = 0; i < mlen; i++) hist[here + i] = hist[from + i];
      }
      if (!bd.end()) fail();
      rep[0] = (uint32_t)prev[0];
      rep[1] = (uint32_t)prev[1];
      rep[2] = (uint32_t)prev[2];
    }
    const size_t last = lit.size() - litpos;
    if (last > oend - hist.size()) fail();
    hist.insert(hist.end(), lit.begin() + (long)litpos, lit.end());
  }
};

// the size of the first frame, as ZSTD_findFrameCompressedSize finds it;
// false where it errors (the single pass is then not taken)
bool frame_size(const uint8_t* s, size_t n, const Frame& f, size_t& out) {
  size_t pos = f.header;
  for (;;) {
    if (n - pos < 3) return false;
    const uint32_t bh = rd24(s + pos);
    const unsigned type = (bh >> 1) & 3;
    if (type == 3) return false;
    const size_t csize = type == 1 ? 1 : bh >> 3;
    if (3 + csize > n - pos) return false;
    pos += 3 + csize;
    if (bh & 1) break;
  }
  if (f.checksum) {
    if (n - pos < 4) return false;
    pos += 4;
  }
  out = pos;
  return true;
}

// ZSTDDecode over one strip or tile
int tiff_decode(const uint8_t* src, size_t n, uint8_t* out, size_t occ,
                long long* bufs) {
  Decoder d;
  Frame& f = d.f;
  if (!frame_header(src, n, f)) return kFail;  // error or a partial header
  if (f.skippable) return kFail;  // the frame ends with no output
  // the single pass
  size_t csize;
  if (f.fcs != kUnknown && occ >= f.fcs && frame_size(src, n, f, csize)) {
    if (f.dict) fail();
    size_t pos = f.header;
    for (;;) {
      if (csize - pos < 3) fail();
      const uint32_t bh = rd24(src + pos);
      pos += 3;
      const unsigned type = (bh >> 1) & 3;
      const size_t bsize = bh >> 3;
      const size_t cap = occ - d.hist.size();
      if (type == 0) {
        if (bsize > csize - pos) fail();
        if (bsize > cap) fail();
        d.hist.insert(d.hist.end(), src + pos, src + pos + bsize);
        pos += bsize;
      } else if (type == 1) {
        if (1 > csize - pos) fail();
        if (bsize > cap) fail();
        d.hist.insert(d.hist.end(), bsize, src[pos]);
        pos += 1;
      } else if (type == 2) {
        if (bsize > csize - pos) fail();
        d.compressed_block(src + pos, bsize, cap);
        pos += bsize;
      } else {
        fail();
      }
      if (bh & 1) break;
    }
    if (d.hist.size() != f.fcs) fail();
    if (f.checksum) {
      if (csize - pos < 4) fail();
      if ((uint32_t)xxh64(d.hist.data(), d.hist.size()) != rd32(src + pos))
        fail();
    }
    if (d.hist.size() < occ) return kFail;
    std::memcpy(out, d.hist.data(), occ);
    return kOk;
  }
  // the buffered stream; its buffers outlive the strip (ZSTD_initDStream
  // keeps them), so `bufs` carries their sizes and the count of frames
  // they were oversized for from one call to the next
  if (f.dict) fail();
  uint64_t window = std::max<uint64_t>(f.window, 1024);
  if (window > (1ULL << 27) + 1) fail();
  const size_t bsize_min = (size_t)std::min<uint64_t>(
      std::min<uint64_t>(window, kBlockMax), f.block_max);
  const uint64_t ring = window + 2 * bsize_min + 64;
  const uint64_t need_out = std::min<uint64_t>(f.fcs, ring);
  const uint64_t need_in = std::max<uint64_t>(f.block_max, 4);
  if ((uint64_t)(bufs[0] + bufs[1]) >= (need_in + need_out) * 3)
    bufs[2]++;
  else
    bufs[2] = 0;
  if ((uint64_t)bufs[0] < need_in || (uint64_t)bufs[1] < need_out ||
      bufs[2] >= 128) {
    bufs[0] = (long long)need_in;
    bufs[1] = (long long)need_out;
  }
  const uint64_t buf_size = (uint64_t)bufs[1];
  uint64_t out_start = 0;
  size_t flushed = 0;  // bytes of hist copied to out
  size_t pos = f.header;
  auto flush = [&](size_t produced) -> bool {  // true: the flush completed
    const size_t room = occ - flushed;
    const size_t k = std::min(room, produced);
    std::memcpy(out + flushed, d.hist.data() + (d.hist.size() - produced), k);
    flushed += k;
    out_start += k;
    if (k < produced) return false;
    if (buf_size < f.fcs && out_start + f.block_max > buf_size) {
      out_start = 0;
      d.wrapped = true;
    }
    return true;
  };
  for (;;) {
    if (n - pos < 3) return flushed == occ ? kOk : kFail;
    const uint32_t bh = rd24(src + pos);
    const unsigned type = (bh >> 1) & 3;
    if (type == 3) fail();
    const size_t csize = type == 1 ? 1 : bh >> 3;
    if (csize > f.block_max) fail();
    pos += 3;
    const bool last = bh & 1;
    if (csize == 0) {
      // an empty raw or compressed block: no output, no flush stage
      if (last) break;
      continue;
    }
    const size_t cap = (size_t)(buf_size - out_start);
    if (n - pos < csize) {
      // a raw block streams what the input holds of it; any other waits
      // for the rest of its bytes, which never come
      if (type == 0 && n > pos) {
        if (n - pos > cap) fail();
        d.hist.insert(d.hist.end(), src + pos, src + n);
        flush(n - pos);
      }
      return flushed == occ ? kOk : kFail;
    }
    const size_t before = d.hist.size();
    if (type == 0) {
      if (csize > cap) fail();
      d.hist.insert(d.hist.end(), src + pos, src + pos + csize);
    } else if (type == 1) {
      const size_t rsize = bh >> 3;
      if (rsize > cap) fail();
      d.hist.insert(d.hist.end(), rsize, src[pos]);
    } else {
      d.compressed_block(src + pos, csize, cap);
    }
    pos += csize;
    const size_t produced = d.hist.size() - before;
    if (produced > f.block_max) fail();
    if (last && f.fcs != kUnknown && d.hist.size() != f.fcs) fail();
    if (produced) {
      if (!flush(produced)) return kOk;  // the output is full
    }
    if (last) {
      if (f.checksum) {
        if (n - pos < 4) return flushed == occ ? kOk : kFail;
        if ((uint32_t)xxh64(d.hist.data(), d.hist.size()) != rd32(src + pos))
          fail();
      }
      return flushed == occ ? kOk : kFail;
    }
  }
  // an empty last block ends the frame without the content size check
  if (f.checksum) {
    if (n - pos < 4) return flushed == occ ? kOk : kFail;
    if ((uint32_t)xxh64(d.hist.data(), d.hist.size()) != rd32(src + pos))
      fail();
  }
  return flushed == occ ? kOk : kFail;
}

// ---------------------------------------------------------------------------
// the encoder
// ---------------------------------------------------------------------------

struct BitW {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  unsigned n = 0;
  explicit BitW(std::vector<uint8_t>& o) : out(o) {}
  void add(uint64_t v, unsigned nb) {
    if (!nb) return;
    acc |= (v & ((1ULL << nb) - 1)) << n;
    n += nb;
    while (n >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      n -= 8;
    }
  }
  void close() {
    add(1, 1);
    if (n) out.push_back((uint8_t)acc);
    acc = 0;
    n = 0;
  }
};

struct CTable {
  unsigned log;
  std::vector<uint16_t> state;
  std::vector<int32_t> delta_nb, delta_find;
};

CTable build_ctable(const int16_t* norm, unsigned max_sv, unsigned log) {
  CTable ct;
  ct.log = log;
  const uint32_t size = 1u << log;
  std::vector<uint16_t> sym(size), next(max_sv + 1);
  spread(norm, max_sv, log, sym.data(), next.data());
  std::vector<uint32_t> cumul(max_sv + 2);
  cumul[0] = 0;
  for (unsigned s = 1; s <= max_sv + 1; s++)
    cumul[s] = cumul[s - 1] + (norm[s - 1] == -1 ? 1 : (uint32_t)norm[s - 1]);
  ct.state.resize(size);
  for (uint32_t u = 0; u < size; u++)
    ct.state[cumul[sym[u]]++] = (uint16_t)(size + u);
  ct.delta_nb.resize(max_sv + 1);
  ct.delta_find.resize(max_sv + 1);
  int total = 0;
  for (unsigned s = 0; s <= max_sv; s++) {
    const int c = norm[s];
    if (c == 0) {
      ct.delta_nb[s] = (int32_t)(((log + 1) << 16) - (1u << log));
    } else if (c == -1 || c == 1) {
      ct.delta_nb[s] = (int32_t)((log << 16) - (1u << log));
      ct.delta_find[s] = total - 1;
      total++;
    } else {
      const unsigned max_out = log - highbit((uint32_t)c - 1);
      const uint32_t min_plus = (uint32_t)c << max_out;
      ct.delta_nb[s] = (int32_t)((max_out << 16) - min_plus);
      ct.delta_find[s] = total - c;
      total += c;
    }
  }
  return ct;
}

struct CState {
  const CTable* t;
  uint64_t value;
  void init(const CTable& ct, unsigned s) {
    t = &ct;
    const uint32_t nb_out = (uint32_t)(ct.delta_nb[s] + (1 << 15)) >> 16;
    uint64_t v = ((uint64_t)nb_out << 16) - (uint64_t)(int64_t)ct.delta_nb[s];
    value = ct.state[(size_t)((int64_t)(v >> nb_out) + ct.delta_find[s])];
  }
  void encode(BitW& bw, unsigned s) {
    const uint32_t nb_out =
        (uint32_t)((value + (uint64_t)(int64_t)t->delta_nb[s]) >> 16);
    bw.add(value, nb_out);
    value = t->state[(size_t)((int64_t)(value >> nb_out) + t->delta_find[s])];
  }
  void flush(BitW& bw) { bw.add(value, t->log); }
};

struct Encoders {
  CTable ll, ml, of;
  Encoders() {
    defaults();
    ll = build_ctable(LL_DEFAULT, 35, 6);
    ml = build_ctable(ML_DEFAULT, 52, 6);
    of = build_ctable(OF_DEFAULT, 28, 5);
  }
};
const Encoders& encoders() {
  static const Encoders e;
  return e;
}

unsigned code_of(const uint32_t* base, unsigned n, uint32_t v) {
  unsigned c = 0;
  while (c + 1 < n && base[c + 1] <= v) c++;
  return c;
}

struct Seq {
  uint32_t lit, match, offset;
};

// one compressed block: raw literals, predefined sequences; empty where it
// cannot be coded so (the caller writes a raw block)
std::vector<uint8_t> encode_block(const uint8_t* lits, size_t nlit,
                                  const std::vector<Seq>& seqs) {
  std::vector<uint8_t> b;
  if (nlit < 32) {
    b.push_back((uint8_t)(nlit << 3));
  } else if (nlit < 4096) {
    b.push_back((uint8_t)(((nlit & 15) << 4) | (1 << 2)));
    b.push_back((uint8_t)(nlit >> 4));
  } else {
    const uint32_t h = (uint32_t)(nlit << 4) | (3 << 2);
    b.push_back((uint8_t)h);
    b.push_back((uint8_t)(h >> 8));
    b.push_back((uint8_t)(h >> 16));
  }
  b.insert(b.end(), lits, lits + nlit);
  const size_t n = seqs.size();
  if (n < 128) {
    b.push_back((uint8_t)n);
  } else if (n < 0x7F00) {
    b.push_back((uint8_t)((n >> 8) + 0x80));
    b.push_back((uint8_t)n);
  } else {
    b.push_back(0xFF);
    b.push_back((uint8_t)(n - 0x7F00));
    b.push_back((uint8_t)((n - 0x7F00) >> 8));
  }
  if (!n) return b;
  b.push_back(0);  // all three predefined
  const Encoders& e = encoders();
  std::vector<uint8_t> llc(n), mlc(n), ofc(n);
  for (size_t i = 0; i < n; i++) {
    llc[i] = (uint8_t)code_of(LL_BASE, 36, seqs[i].lit);
    mlc[i] = (uint8_t)code_of(ML_BASE, 53, seqs[i].match);
    ofc[i] = (uint8_t)highbit(seqs[i].offset + 3);
    if (ofc[i] > 28) return {};
  }
  BitW bw(b);
  CState sml, sof, sll;
  const size_t l = n - 1;
  sml.init(e.ml, mlc[l]);
  sof.init(e.of, ofc[l]);
  sll.init(e.ll, llc[l]);
  bw.add(seqs[l].lit - LL_BASE[llc[l]], LL_BITS[llc[l]]);
  bw.add(seqs[l].match - ML_BASE[mlc[l]], ML_BITS[mlc[l]]);
  bw.add(seqs[l].offset + 3 - (1u << ofc[l]), ofc[l]);
  for (size_t k = n - 1; k-- > 0;) {
    sof.encode(bw, ofc[k]);
    sml.encode(bw, mlc[k]);
    sll.encode(bw, llc[k]);
    bw.add(seqs[k].lit - LL_BASE[llc[k]], LL_BITS[llc[k]]);
    bw.add(seqs[k].match - ML_BASE[mlc[k]], ML_BITS[mlc[k]]);
    bw.add(seqs[k].offset + 3 - (1u << ofc[k]), ofc[k]);
  }
  sml.flush(bw);
  sof.flush(bw);
  sll.flush(bw);
  bw.close();
  return b;
}

void put_block(std::vector<uint8_t>& out, int type, size_t size, bool last,
               const uint8_t* body, size_t body_len) {
  const uint32_t h = (uint32_t)(size << 3) | (uint32_t)(type << 1) | last;
  out.push_back((uint8_t)h);
  out.push_back((uint8_t)(h >> 8));
  out.push_back((uint8_t)(h >> 16));
  out.insert(out.end(), body, body + body_len);
}

}  // namespace

extern "C" {

// One strip or tile of `occ` bytes, as ZSTDDecode gives it (0, 1 or 2 as
// above); `bufs` (three values, zero before an image's first strip) is the
// stream's buffer state, carried from strip to strip.
int kt_zstd_tiff(const uint8_t* src, long long n, uint8_t* out,
                 long long occ, long long* bufs) {
  try {
    return tiff_decode(src, (size_t)n, out, (size_t)occ, bufs);
  } catch (const Stop& s) {
    return s.code;
  } catch (...) {
    return kUnmodelled;
  }
}

// A zstd frame of n bytes into out (capacity cap): no content size, a
// window of 2^window_log, the XXH64 checksum when `checksum`. Returns the
// length, or -1 where cap is too small.
long long kt_zstd_encode(const uint8_t* in, long long n, uint8_t* out,
                         long long cap, int window_log, int checksum) {
  std::vector<uint8_t> o;
  o.push_back(0x28);
  o.push_back(0xB5);
  o.push_back(0x2F);
  o.push_back(0xFD);
  o.push_back((uint8_t)(checksum ? 4 : 0));
  o.push_back((uint8_t)((window_log - 10) << 3));
  const size_t window = (size_t)1 << window_log;
  const size_t block = std::min(window, kBlockMax);
  const int hbits = 16;
  std::vector<int64_t> head((size_t)1 << hbits, -1);
  std::vector<int64_t> chain((size_t)n, -1);
  auto hash = [&](size_t i) {
    return (uint32_t)((rd32(in + i) * 2654435761u) >> (32 - hbits));
  };
  size_t pos = 0;
  const size_t total = (size_t)n;
  if (total == 0) put_block(o, 0, 0, true, nullptr, 0);
  while (pos < total) {
    const size_t end = std::min(total, pos + block);
    const bool last = end == total;
    bool constant = true;
    for (size_t i = pos + 1; i < end && constant; i++)
      constant = in[i] == in[pos];
    if (constant) {
      put_block(o, 1, end - pos, last, in + pos, 1);
      pos = end;
      continue;
    }
    std::vector<Seq> seqs;
    std::vector<uint8_t> lits;
    size_t i = pos, anchor = pos;
    while (i + 4 <= end) {
      const uint32_t h = hash(i);
      size_t best = 0, best_off = 0;
      int64_t cand = head[h];
      for (int tries = 0; cand >= 0 && tries < 16; tries++) {
        const size_t off = i - (size_t)cand;
        if (off > window - 64 || off >= (1u << 28) - 3) break;
        size_t len = 0;
        while (i + len < end && in[(size_t)cand + len] == in[i + len]) len++;
        if (len > best) {
          best = len;
          best_off = off;
        }
        cand = chain[(size_t)cand];
      }
      chain[i] = head[h];
      head[h] = (int64_t)i;
      if (best >= 4) {
        seqs.push_back({(uint32_t)(i - anchor), (uint32_t)best,
                        (uint32_t)best_off});
        lits.insert(lits.end(), in + anchor, in + i);
        for (size_t k = i + 1; k < i + best && k + 4 <= end; k++) {
          const uint32_t hk = hash(k);
          chain[k] = head[hk];
          head[hk] = (int64_t)k;
        }
        i += best;
        anchor = i;
      } else {
        i++;
      }
    }
    lits.insert(lits.end(), in + anchor, in + end);
    std::vector<uint8_t> body = encode_block(lits.data(), lits.size(), seqs);
    if (!body.empty() && body.size() < end - pos && body.size() <= block)
      put_block(o, 2, body.size(), last, body.data(), body.size());
    else
      put_block(o, 0, end - pos, last, in + pos, end - pos);
    pos = end;
  }
  if (checksum) {
    const uint32_t c = (uint32_t)xxh64(in, total);
    for (int k = 0; k < 4; k++) o.push_back((uint8_t)(c >> (8 * k)));
  }
  if ((long long)o.size() > cap) return -1;
  std::memcpy(out, o.data(), o.size());
  return (long long)o.size();
}

}  // extern "C"
