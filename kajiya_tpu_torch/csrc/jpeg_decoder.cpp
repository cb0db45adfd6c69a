// JPEG decoder for texture sources (kajiya_tpu_torch/scene/jpeg.py): the
// bytes that libjpeg-turbo gives through PIL's `Image.open(f).convert("RGBA")`
// with its default settings, which the JAX package's bake uses.
//
// Covered: SOF0 / SOF1 / SOF2 frames of 8-bit samples with Huffman coding,
// 1, 3 or 4 components, any integer sampling factors; DQT with 8- and 16-bit
// tables, DHT, DRI and RSTn, tables between scans, several scans a frame
// (sequential or progressive, with spectral selection and successive
// approximation; the coefficients of every scan are gathered before the
// inverse DCT, as libjpeg gathers them for a multi-scan file).
// Output follows libjpeg's decompression path:
// - the accurate integer inverse DCT (jidctint.c, jpeg_idct_islow), as the
//   x86 SIMD builds compute it (16-bit lanes that wrap or saturate where a
//   corrupt file's coefficients leave the range);
// - fancy upsampling (jdsample.c): h2v1 and h2v2 triangle filters (the
//   latter with its alternating 8 / 7 rounding bias) when the component is
//   more than two samples wide, h1v2, and box replication otherwise;
// - the fixed-point YCbCr -> RGB tables of jdcolor.c, or no conversion for
//   an RGB-coded frame (Adobe transform 0 or component ids 'R' 'G' 'B');
// - CMYK and YCCK frames as PIL reads them ("CMYK;I", Adobe polarity), then
//   PIL's CMYK -> RGB conversion.
//
// Markers are dispatched as libjpeg-turbo's read_markers does: DNL and DAC
// are read and skipped, a second SOI, the hierarchical and JPG processes
// (SOF5-7, SOF13-15, JPG) and the codes libjpeg does not know (DHP, EXP,
// JPGn, reserved) are fatal. PIL's own header walk (JpegImageFile._open,
// which refuses more) runs first, in scene/jpeg.py.
//
// Refused with status 2 (not implemented): arithmetic coding, lossless
// frames, other sample precisions, non-integer sampling ratios, progressive
// files that libjpeg would block-smooth (an AC band of the first nine
// coefficients incomplete after the last scan), and corrupt entropy data
// that libjpeg decodes with a warning (a segment that ends early, a code of
// no table, a restart marker out of sequence). Status 1 (corrupt): what
// makes PIL raise, such as bytes that end before the image does.
//
// Built with g++ at first use (scene/jpeg.py) and called through ctypes.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fail {
  int code;  // 1 corrupt, 2 not implemented, 3 the data ends (libjpeg suspends)
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Fail{1, m}; }
[[noreturn]] void unported(const std::string& m) { throw Fail{2, m}; }
[[noreturn]] void ends(const std::string& m) { throw Fail{3, m}; }

// natural order of the zigzag index, with 16 guard entries (jutils.c)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K.3 (jstdhuff.c): the tables libjpeg-turbo gives DC / AC tables 0
// and 1 that the header leaves undefined (motion JPEG)
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huff {
  bool defined = false;
  // the DHT segment's table, derived (and checked) where a scan uses it,
  // as jpeg_make_d_derived_tbl does
  uint8_t counts[16];
  uint8_t symbols[256];
  int nsymbols = 0;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, 0 where the code is longer
  uint16_t look[512];
};

void define_huff(Huff& h, const uint8_t* counts, const uint8_t* vals,
                 int nvals) {
  std::memcpy(h.counts, counts, 16);
  std::memcpy(h.symbols, vals, nvals);
  h.nsymbols = nvals;
  h.defined = true;
}

void build_huff(Huff& h, const uint8_t* counts, const uint8_t* vals, int nvals,
                bool dc) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < counts[l - 1]; i++) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) corrupt("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      h.valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0x7FFFFFFF;
  std::memset(h.vals, 0, sizeof h.vals);
  std::memcpy(h.vals, vals, nvals);
  std::memset(h.look, 0, sizeof h.look);
  p = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 0; i < counts[l - 1]; i++, p++) {
      int look = huffcode[p] << (9 - l);
      for (int c = 0; c < (1 << (9 - l)); c++)
        h.look[look + c] = (uint16_t)((l << 8) | vals[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < nvals; i++)
      if (vals[i] > 15) corrupt("bad DC Huffman table");
  }
  h.defined = true;
}

// jdcolor.c build_ycc_rgb_table: 16-bit fixed point, indexed by Cb or Cr
struct YccTables {
  int cr_r[256], cb_b[256];
  long long cr_g[256], cb_g[256];
  YccTables() {
    const long long half = 1LL << 15;
    auto fix = [](double x) { return (long long)(x * (1LL << 16) + 0.5); };
    for (int i = 0; i < 256; i++) {
      long long x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables tables;  // built once, thread-safe
  return tables;
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;        // downsampled width and height
  int bw = 0, bh = 0;        // blocks that hold samples
  int aw = 0, ah = 0;        // allocated blocks (whole MCUs)
  std::vector<int16_t> coef;  // aw * ah blocks of 64
  int coef_bits[64];          // progressive: -1 until a scan sets the bits
  int dc_pred = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;

  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huff dc_tab[4], ac_tab[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;

  bool have_frame = false, progressive = false;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Comp comp[4];
  bool saw_eoi = false;
  int color = 0;             // 0 by the markers, 1 YCbCr -> RGB, 2 as coded,
                             // 3 by the markers, four components as CMYK
  bool scanned = false;      // a scan was decoded
  bool single_done = false;  // single-scan mode, and its scan is decoded

  // entropy bit reader
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  int padbits = 0;         // zero bits appended after a marker or the end
  bool at_marker = false;  // the reader stopped at a marker (pos is its FF)
  bool at_end = false;     // the reader ran off the end of the data
  int eobrun = 0;

  int u8() {
    if (pos >= n) ends("unexpected end of data");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
    padbits = 0;
    at_marker = false;
    at_end = false;
  }

  void fill() {
    while (bitcnt <= 56) {
      int byte = 0;
      if (!at_marker && !at_end) {
        if (pos >= n) {
          at_end = true;
        } else if (d[pos] != 0xFF) {
          byte = d[pos++];
        } else {
          // FF 00 is a data FF; runs of FF pad a marker (jdhuff.c)
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q >= n) {
            at_end = true;
          } else if (d[q] == 0x00) {
            byte = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;
            pos = q - 1;
          }
        }
      }
      if (at_marker || at_end) padbits += 8;
      bitbuf |= (uint64_t)byte << (56 - bitcnt);
      bitcnt += 8;
    }
  }
  void consumed() {
    if (padbits > bitcnt) {
      if (at_end) corrupt("image file is truncated");
      unported("corrupt JPEG data: premature end of data segment "
               "(libjpeg decodes it with a warning)");
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    if (bitcnt < k) fill();
    int v = (int)(bitbuf >> (64 - k));
    bitbuf <<= k;
    bitcnt -= k;
    consumed();
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huff& h) {
    if (bitcnt < 16) fill();
    int look = (int)(bitbuf >> 55);
    int e = h.look[look];
    if (e) {
      int l = e >> 8;
      bitbuf <<= l;
      bitcnt -= l;
      consumed();
      return e & 0xFF;
    }
    int code = (int)(bitbuf >> 55);
    int l = 9;
    while (l <= 16 && code > h.maxcode[l]) {
      code = (code << 1) | (int)((bitbuf >> (63 - l)) & 1);
      l++;
    }
    if (l > 16)
      unported("corrupt JPEG data: bad Huffman code (libjpeg decodes it "
               "with a warning)");
    bitbuf <<= l;
    bitcnt -= l;
    consumed();
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v + (int)((unsigned)-1 << s) + 1 : v;
  }

  // the next marker code; skips bytes that are not FF as libjpeg and PIL do
  int next_marker() {
    for (;;) {
      if (pos >= n) ends("image file is truncated (no marker)");
      int c = d[pos++];
      if (c != 0xFF) continue;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) ends("image file is truncated (no marker)");
      c = d[pos++];
      if (c != 0) return c;
    }
  }

  void read_dqt() {
    int len = u16() - 2;
    size_t end = pos + len;
    if (len < 0) corrupt("bad DQT length");
    if (end > n) ends("truncated DQT");
    while (pos < end) {
      int pq = u8();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3) corrupt("bad DQT table id");
      for (int i = 0; i < 64; i++) {
        int v = prec ? u16() : u8();
        quant[t][kNatural[i]] = (uint16_t)v;
      }
      quant_defined[t] = true;
    }
    if (pos != end) corrupt("bad DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    size_t end = pos + len;
    if (len < 0) corrupt("bad DHT length");
    if (end > n) ends("truncated DHT");
    while (pos + 17 <= end) {
      int tc = u8();
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = (uint8_t)u8();
        total += counts[i];
      }
      if (total > 256 || pos + total > end) corrupt("bad DHT table");
      uint8_t vals[256];
      for (int i = 0; i < total; i++) vals[i] = (uint8_t)u8();
      int cls = tc >> 4, id = tc & 15;
      if (id > 3 || cls > 1) corrupt("bad DHT table id");
      define_huff(cls ? ac_tab[id] : dc_tab[id], counts, vals, total);
    }
    if (pos != end) corrupt("bad DHT length");
  }

  void read_app(int marker) {
    int len = u16() - 2;
    if (len < 0) return;  // skip_variable skips nothing, and goes on
    if (pos + len > n) ends("truncated APP segment");
    const uint8_t* s = d + pos;
    if (marker == 0xE0 && len >= 14 && std::memcmp(s, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = s[11];
    }
    pos += len;
  }

  void read_sof(int marker) {
    if (have_frame) corrupt("two frame headers");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      unported("lossless JPEG frames are not decoded");
    if (marker >= 0xC9)
      unported("arithmetic-coded JPEG frames are not decoded");
    int len = u16();
    size_t end = pos + len - 2;
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (prec != 8) unported("JPEG sample precision other than 8 bits");
    if (height == 0) unported("JPEG frame height in a DNL marker");
    if (width == 0) corrupt("empty JPEG frame");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      corrupt("JPEG with a component count PIL cannot handle");
    if (len != 8 + 3 * ncomp || end > n) corrupt("bad SOF length");
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        corrupt("bad sampling factors or table");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    progressive = marker == 0xC2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        unported("non-integer JPEG sampling ratios are not decoded");
      c.dw = (int)(((long long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long long)height * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.aw = mcux * c.h;
      c.ah = mcuy * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  // ---------------------------------------------------------------------
  // scans
  // ---------------------------------------------------------------------

  void decode_block_seq(Comp& c, int16_t* blk) {
    const Huff& dct = dc_tab[c.td];
    const Huff& act = ac_tab[c.ta];
    int s = decode(dct);
    int diff = s ? extend(bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; k++) {
      int rs = decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(bits(s), s);
        blk[kNatural[k]] = (int16_t)v;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(Comp& c, int16_t* blk, int al) {
    int s = decode(dc_tab[c.td]);
    int diff = s ? extend(bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)(int)((unsigned)c.dc_pred << al);
  }

  void decode_dc_refine(int16_t* blk, int al) {
    if (bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void decode_ac_first(Comp& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huff& act = ac_tab[c.ta];
    for (int k = ss; k <= se; k++) {
      int rs = decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(bits(s), s);
        blk[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          eobrun--;
          break;
        }
      }
    }
  }

  void decode_ac_refine(Comp& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al;
    const int m1 = (int)((unsigned)-1 << al);
    const Huff& act = ac_tab[c.ta];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1)
            unported("corrupt JPEG data: bad refinement code (libjpeg "
                     "decodes it with a warning)");
          s = bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        do {
          int16_t* co = blk + kNatural[k];
          if (*co != 0) {
            if (bit()) {
              if ((*co & p1) == 0) *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* co = blk + kNatural[k];
        if (*co != 0) {
          if (bit()) {
            if ((*co & p1) == 0) *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
          }
        }
      }
      eobrun--;
    }
  }

  void restart(int& next_rst, Comp** sc, int ns) {
    // discard the bits left (the reader never reads past a marker), then
    // find the marker, skipping junk bytes as libjpeg does
    reset_bits();
    int m;
    for (;;) {
      if (pos >= n) corrupt("image file is truncated (restart marker)");
      if (d[pos] != 0xFF) {
        pos++;
        continue;
      }
      size_t r = pos + 1;
      while (r < n && d[r] == 0xFF) r++;
      if (r >= n) corrupt("image file is truncated (restart marker)");
      if (d[r] == 0) {
        pos = r + 1;
        continue;
      }
      m = d[r];
      pos = r + 1;
      break;
    }
    if (m != 0xD0 + next_rst)
      unported("corrupt JPEG data: restart marker out of sequence (libjpeg "
               "resynchronises with a warning)");
    next_rst = (next_rst + 1) & 7;
    for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
    eobrun = 0;
  }

  void read_sos() {
    if (!have_frame) corrupt("scan before the frame header");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) corrupt("bad SOS length");
    Comp* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = u8();
      int t = u8();
      Comp* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) corrupt("scan names an unknown component");
      for (int j = 0; j < i; j++)
        if (sc[j] == c) corrupt("scan names a component twice");
      c->td = t >> 4;
      c->ta = t & 15;
      sc[i] = c;
    }
    int ss = u8(), se = u8(), a = u8();
    // jdinput.c consume_markers: a scan after single-scan mode's one
    if (single_done) corrupt("a second scan in single-scan mode");
    if (ns > 1) {
      // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) corrupt("too many blocks in an MCU");
    }
    int ah = a >> 4, al = a & 15;
    if (progressive) {
      if (ss == 0) {
        if (se != 0) corrupt("bad progression");
      } else {
        if (se < ss || se > 63 || ns != 1) corrupt("bad progression");
      }
      if (ah != 0 && ah - 1 != al) corrupt("bad progression");
      if (al > 13) corrupt("bad progression");
      for (int i = 0; i < ns; i++) {
        int* cb = sc[i]->coef_bits;
        if (ss != 0 && cb[0] < 0)
          unported("progressive AC scan before its DC (libjpeg warns)");
        for (int k = ss; k <= se; k++) {
          int expected = cb[k] < 0 ? 0 : cb[k];
          if (ah != expected)
            unported("progressive scan out of sequence (libjpeg warns)");
          cb[k] = al;
        }
      }
    } else {
      if (ss != 0 || se != 63 || a != 0) {
        // libjpeg warns and decodes as a baseline scan
        unported("sequential scan with spectral parameters (libjpeg warns)");
      }
    }
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      bool need_dc = (!progressive || ss == 0) && !(progressive && ah != 0);
      bool need_ac = !progressive || ss != 0;
      // libjpeg's jpeg_make_d_derived_tbl errs on a selector above 3 where
      // the scan uses the table (a DC refinement scan uses none)
      if ((need_dc && c.td > 3) || (need_ac && c.ta > 3))
        corrupt("bad Huffman table selector");
      if (need_dc && !dc_tab[c.td].defined)
        corrupt("scan uses an undefined DC Huffman table");
      if (need_ac && !ac_tab[c.ta].defined)
        corrupt("scan uses an undefined AC Huffman table");
      if (need_dc) {
        Huff& t = dc_tab[c.td];
        build_huff(t, t.counts, t.symbols, t.nsymbols, true);
      }
      if (need_ac) {
        Huff& t = ac_tab[c.ta];
        build_huff(t, t.counts, t.symbols, t.nsymbols, false);
      }
      c.dc_pred = 0;
    }
    // the coefficient buffers are allocated at the first scan, so parsing
    // the markers alone (kt_jpeg_dims) allocates nothing of the image's size
    for (int i = 0; i < ncomp; i++)
      if (comp[i].coef.empty())
        comp[i].coef.assign((size_t)comp[i].aw * comp[i].ah * 64, 0);
    eobrun = 0;
    reset_bits();

    int next_rst = 0, todo = restart_interval;
    auto unit_done = [&]() {
      if (restart_interval) {
        if (--todo == 0) {
          todo = restart_interval;
          return true;
        }
      }
      return false;
    };
    auto block = [&](Comp& c, int bx, int by) {
      int16_t* blk = c.coef.data() + ((size_t)by * c.aw + bx) * 64;
      if (!progressive) {
        std::memset(blk, 0, 64 * sizeof(int16_t));
        decode_block_seq(c, blk);
      } else if (ss == 0) {
        if (ah == 0)
          decode_dc_first(c, blk, al);
        else
          decode_dc_refine(blk, al);
      } else if (ah == 0) {
        decode_ac_first(c, blk, ss, se, al);
      } else {
        decode_ac_refine(c, blk, ss, se, al);
      }
    };
    if (ns == 1) {
      Comp& c = *sc[0];
      long long units = (long long)c.bw * c.bh;
      long long u = 0;
      for (int by = 0; by < c.bh; by++) {
        for (int bx = 0; bx < c.bw; bx++) {
          block(c, bx, by);
          u++;
          if (u < units && unit_done()) restart(next_rst, sc, ns);
        }
      }
    } else {
      long long units = (long long)mcux * mcuy;
      long long u = 0;
      for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
          for (int i = 0; i < ns; i++) {
            Comp& c = *sc[i];
            for (int y = 0; y < c.v; y++)
              for (int x = 0; x < c.h; x++)
                block(c, mx * c.h + x, my * c.v + y);
          }
          u++;
          if (u < units && unit_done()) restart(next_rst, sc, ns);
        }
      }
    }
    // The data ended inside the scan's read-ahead, and no bit past it was
    // needed. libjpeg reads ahead too (up to 57 bits, on its own schedule),
    // and if its reader meets the end before the last MCU it suspends, and
    // PIL raises "image file is truncated". A multi-scan file needs its EOI
    // anyway; in single-scan mode the outcome is libjpeg's read schedule's.
    const bool single = !progressive && ns == ncomp && !scanned;
    if (at_end) {
      if (single)
        unported("JPEG data that ends within the last bytes of its scan "
                 "(PIL's result depends on libjpeg's read-ahead)");
      corrupt("image file is truncated");
    }
    if (single && !at_marker && n - pos <= 16) {
      // no marker stopped the reader, and the data ends within the 16
      // bytes that libjpeg's read-ahead may still have wanted
      size_t q = pos;
      while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] != 0 && d[q + 1] != 0xFF))
        q++;
      if (q + 1 >= n)
        unported("JPEG data that ends within the last bytes of its scan "
                 "(PIL's result depends on libjpeg's read-ahead)");
    }
    // leave pos at the marker that ends the scan (any bits left are padding)
    reset_bits();
    // an interleaved sequential first scan is libjpeg's single-scan mode:
    // the image is complete, and PIL only finishes the decompressor
    if (single) single_done = true;
    scanned = true;
  }

  // jstdhuff.c std_huff_tables, as jinit_huff_decoder runs it at the
  // start of sequential decompression (the progressive decoder does not):
  // tables 0 and 1 the header left undefined
  void default_tables() {
    if (!dc_tab[0].defined) define_huff(dc_tab[0], kDcLumaBits, kDcVals, 12);
    if (!ac_tab[0].defined)
      define_huff(ac_tab[0], kAcLumaBits, kAcLumaVals, 162);
    if (!dc_tab[1].defined) define_huff(dc_tab[1], kDcChromaBits, kDcVals, 12);
    if (!ac_tab[1].defined)
      define_huff(ac_tab[1], kAcChromaBits, kAcChromaVals, 162);
  }

  // jdmarker.c get_dac: arithmetic conditioning values, checked and then
  // unused by a Huffman-coded frame
  void read_dac() {
    int len = u16() - 2;
    while (len > 0) {
      int index = u8(), val = u8();
      len -= 2;
      if (index >= 32) corrupt("bad DAC index");
      if (index < 16 && (val & 15) > (val >> 4)) corrupt("bad DAC value");
    }
    if (len != 0) corrupt("bad DAC length");
  }

  // jdmarker.c read_markers: the markers libjpeg-turbo reads, skips or
  // stops at; `frame_only` stops after the frame header. In single-scan
  // mode the markers after the scan are read by jpeg_finish_decompress,
  // whose errors PIL raises but whose running out of data it ignores.
  void parse(bool frame_only = false) {
    try {
      markers(frame_only);
    } catch (const Fail& f) {
      // libtiff's JPEGDecode takes any outcome of jpeg_finish_decompress
      // as done, once the rows are read
      if (!(single_done && (color == 1 || color == 2)) && f.code != 3)
        throw;
      if (!single_done) corrupt(f.msg);
    }
    if (!single_done && !saw_eoi) corrupt("image file is truncated (no EOI)");
  }

  void markers(bool frame_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) {
        saw_eoi = true;
        break;
      }
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
        case 0xCB:
          read_sof(m);
          if (frame_only) {
            saw_eoi = true;  // the walk stops here
            return;
          }
          break;
        case 0xC5: case 0xC6: case 0xC7: case 0xC8: case 0xCD: case 0xCE:
        case 0xCF:
          corrupt("unsupported JPEG process (libjpeg's JERR_SOF_UNSUPPORTED)");
        case 0xD8: corrupt("duplicate SOI marker");
        case 0xDA:
          if (frame_only) corrupt("no JPEG frame header");
          if (!scanned && !progressive) default_tables();
          read_sos();
          break;
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xCC: read_dac(); break;
        case 0xDD: {
          int len = u16();
          if (len != 4) corrupt("bad DRI length");
          restart_interval = u16();
          break;
        }
        case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4:
        case 0xD5: case 0xD6: case 0xD7:
          break;  // TEM and stray RSTn have no segment
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
            read_app(m);
          } else if (m == 0xDC) {  // DNL: skipped
            int len = u16() - 2;
            if (pos + std::max(len, 0) > n) ends("truncated segment");
            pos += std::max(len, 0);
          } else {
            // DHP, EXP, JPGn and the reserved codes are fatal
            corrupt("unknown JPEG marker");
          }
      }
    }
    if (frame_only) corrupt("no JPEG frame header");
    if (!have_frame) corrupt("no JPEG frame");
  }

  // ---------------------------------------------------------------------
  // output
  // ---------------------------------------------------------------------

  static inline uint8_t clamp8(int x) {
    return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
  }

  // jpeg_idct_islow as libjpeg-turbo's x86 SIMD builds compute it
  // (jidctint-sse2.asm / -avx2.asm), which equal jidctint.c while the
  // coefficients stay in range and part from it on corrupt data: the
  // dequantised coefficients are 16-bit products (pmullw), the sums that
  // feed a multiply (in0 +- in4, in7 + in3, in5 + in1) wrap in 16 bits,
  // each pass's results saturate to 16 bits (packssdw), and a block whose
  // rows 1-7 are all zero takes the DC shortcut, row 0 << 2 in 16 bits.
  static inline int16_t w16(int v) { return (int16_t)v; }
  static inline int16_t sat16(int v) {
    return (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
  }

  // one 8-point pass (the columns of pass 1, the rows of pass 2) of
  // x[0..7] -> out[0..7] with the given descale
  static void idct_pass(const int16_t* x, int sh, int32_t* out) {
    const int CB = 13;
    const int z2 = x[2], z3 = x[6];
    const int tmp3e = z2 * (4433 + 6270) + z3 * 4433;
    const int tmp2e = z2 * 4433 + z3 * (4433 - 15137);
    const int tmp0e = (int)w16(x[0] + x[4]) * (1 << CB);
    const int tmp1e = (int)w16(x[0] - x[4]) * (1 << CB);
    const int t10 = tmp0e + tmp3e, t13 = tmp0e - tmp3e;
    const int t11 = tmp1e + tmp2e, t12 = tmp1e - tmp2e;
    const int i7 = x[7], i5 = x[5], i3 = x[3], i1 = x[1];
    const int oz3 = w16(i7 + i3), oz4 = w16(i5 + i1);
    const int z3o = oz3 * (9633 - 16069) + oz4 * 9633;
    const int z4o = oz3 * 9633 + oz4 * (9633 - 3196);
    const int tmp0 = i7 * (2446 - 7373) + i1 * -7373 + z3o;
    const int tmp3 = i7 * -7373 + i1 * (12299 - 7373) + z4o;
    const int tmp1 = i5 * (16819 - 20995) + i3 * -20995 + z4o;
    const int tmp2 = i5 * -20995 + i3 * (25172 - 20995) + z3o;
    const int rnd = 1 << (sh - 1);
    out[0] = (t10 + tmp3 + rnd) >> sh;
    out[7] = (t10 - tmp3 + rnd) >> sh;
    out[1] = (t11 + tmp2 + rnd) >> sh;
    out[6] = (t11 - tmp2 + rnd) >> sh;
    out[2] = (t12 + tmp1 + rnd) >> sh;
    out[5] = (t12 - tmp1 + rnd) >> sh;
    out[3] = (t13 + tmp0 + rnd) >> sh;
    out[4] = (t13 - tmp0 + rnd) >> sh;
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    const int CB = 13, P1 = 2;
    int16_t ws[64];  // ws[8 * r + c], after pass 1
    bool ac_zero = true;
    for (int k = 8; k < 64; k++) ac_zero = ac_zero && in[k] == 0;
    if (ac_zero) {
      for (int c = 0; c < 8; c++) {
        const int16_t dc = w16(w16(in[c] * q[c]) * (1 << P1));
        for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
      }
    } else {
      for (int c = 0; c < 8; c++) {
        int16_t x[8];
        int32_t o[8];
        for (int r = 0; r < 8; r++) x[r] = w16(in[8 * r + c] * q[8 * r + c]);
        idct_pass(x, CB - P1, o);
        for (int r = 0; r < 8; r++) ws[8 * r + c] = sat16(o[r]);
      }
    }
    for (int r = 0; r < 8; r++) {
      int32_t o[8];
      idct_pass(ws + 8 * r, CB + P1 + 3, o);
      uint8_t* op = out + (size_t)r * stride;
      for (int c = 0; c < 8; c++) op[c] = clamp8(sat16(o[c]) + 128);
    }
  }

  // one component's samples: (ah * 8) rows of aw * 8
  std::vector<uint8_t> samples(const Comp& c) {
    if (!quant_defined[c.tq]) corrupt("component uses an undefined DQT");
    int stride = c.aw * 8;
    std::vector<uint8_t> out((size_t)stride * c.ah * 8);
    const uint16_t* q = quant[c.tq];
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.coef.data() + ((size_t)by * c.aw + bx) * 64, q,
                   out.data() + (size_t)by * 8 * stride + bx * 8, stride);
    return out;
  }

  // component c upsampled to width x height (jdsample.c)
  std::vector<uint8_t> upsample(const Comp& c) {
    std::vector<uint8_t> s = samples(c);
    int stride = c.aw * 8;
    int fx = hmax / c.h, fy = vmax / c.v;
    std::vector<uint8_t> out((size_t)width * height);
    auto at = [&](int y, int x) -> int { return s[(size_t)y * stride + x]; };
    bool fancy_h2 = fx == 2 && c.dw > 2;
    if (fx == 1 && fy == 1) {
      for (int y = 0; y < height; y++)
        std::memcpy(&out[(size_t)y * width], &s[(size_t)y * stride], width);
    } else if (fx == 2 && fy == 1 && fancy_h2) {
      for (int y = 0; y < height; y++) {
        uint8_t* o = &out[(size_t)y * width];
        for (int x = 0; x < width; x++) {
          int i = x >> 1;
          int v3 = at(y, i) * 3;
          if (x & 1)
            o[x] = (uint8_t)((v3 + at(y, std::min(i + 1, c.dw - 1)) + 2) >> 2);
          else
            o[x] = (uint8_t)((v3 + at(y, std::max(i - 1, 0)) + 1) >> 2);
        }
      }
    } else if (fx == 1 && fy == 2) {
      for (int y = 0; y < height; y++) {
        int r = y >> 1;
        int r1 = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
        int bias = (y & 1) ? 2 : 1;
        uint8_t* o = &out[(size_t)y * width];
        for (int x = 0; x < width; x++)
          o[x] = (uint8_t)((at(r, x) * 3 + at(r1, x) + bias) >> 2);
      }
    } else if (fx == 2 && fy == 2 && fancy_h2) {
      std::vector<int> colsum(c.dw);
      for (int y = 0; y < height; y++) {
        int r = y >> 1;
        int r1 = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
        for (int i = 0; i < c.dw; i++) colsum[i] = at(r, i) * 3 + at(r1, i);
        uint8_t* o = &out[(size_t)y * width];
        for (int x = 0; x < width; x++) {
          int i = x >> 1;
          int t3 = colsum[i] * 3;
          if (x & 1)
            o[x] = (uint8_t)((t3 + colsum[std::min(i + 1, c.dw - 1)] + 7) >> 4);
          else
            o[x] = (uint8_t)((t3 + colsum[std::max(i - 1, 0)] + 8) >> 4);
        }
      }
    } else {
      // box replication (h2v1 / h2v2 at two samples or fewer, int_upsample)
      for (int y = 0; y < height; y++) {
        uint8_t* o = &out[(size_t)y * width];
        for (int x = 0; x < width; x++) o[x] = (uint8_t)at(y / fy, x / fx);
      }
    }
    return out;
  }

  void check_smoothing() {
    if (!progressive) return;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Comp& c = comp[i];
      if (!quant_defined[c.tq]) return;
      for (int k = 0; k < 10; k++)
        if (quant[c.tq][kPos[k]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      unported("progressive JPEG whose first AC bands are incomplete "
               "(libjpeg block-smooths it; not decoded)");
  }

  void output(uint8_t* rgba) {
    check_smoothing();
    std::vector<uint8_t> p[4];
    for (int i = 0; i < ncomp; i++) p[i] = upsample(comp[i]);
    size_t np = (size_t)width * height;
    if (ncomp == 1) {
      for (size_t i = 0; i < np; i++) {
        uint8_t g = p[0][i];
        rgba[4 * i] = rgba[4 * i + 1] = rgba[4 * i + 2] = g;
        rgba[4 * i + 3] = 255;
      }
      return;
    }
    const YccTables& t = ycc_tables();
    if (ncomp == 3) {
      bool rgb;
      if (color == 1 || color == 2)  // libtiff names the colour space
        rgb = color == 2;
      else if (jfif)
        rgb = false;
      else if (adobe)
        rgb = adobe_transform == 0;
      else
        rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
      for (size_t i = 0; i < np; i++) {
        int y = p[0][i], cb = p[1][i], cr = p[2][i];
        if (rgb) {
          rgba[4 * i] = (uint8_t)y;
          rgba[4 * i + 1] = (uint8_t)cb;
          rgba[4 * i + 2] = (uint8_t)cr;
        } else {
          rgba[4 * i] = clamp8(y + t.cr_r[cr]);
          rgba[4 * i + 1] = clamp8(y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
          rgba[4 * i + 2] = clamp8(y + t.cb_b[cb]);
        }
        rgba[4 * i + 3] = 255;
      }
      return;
    }
    if (color == 1 || color == 2)
      unported("a named colour space for four components");
    // four components: CMYK, or YCCK under Adobe transform 2 (or another
    // nonzero transform, which libjpeg reads as YCCK with a warning);
    // BlpImagePlugin's jpegmode "CMYK" (color 3) sets libjpeg's colour
    // space to CMYK whatever the markers say
    bool ycck = adobe && adobe_transform != 0 && color != 3;
    for (size_t i = 0; i < np; i++) {
      int c0 = p[0][i], c1 = p[1][i], c2 = p[2][i], k = p[3][i];
      if (ycck) {
        int y = c0, cb = c1, cr = c2;
        c0 = clamp8(255 - (y + t.cr_r[cr]));
        c1 = clamp8(255 - (y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
        c2 = clamp8(255 - (y + t.cb_b[cb]));
      }
      // PIL reads "CMYK;I" (inverted), then converts CMYK -> RGB:
      // each channel (255 - k) - round(c (255 - k) / 255)
      int cc[3] = {255 - c0, 255 - c1, 255 - c2};
      int nk = k;  // 255 - (255 - k)
      for (int j = 0; j < 3; j++) {
        int t = cc[j] * nk + 128;
        int m = ((t >> 8) + t) >> 8;
        rgba[4 * i + j] = clamp8(nk - m);
      }
      rgba[4 * i + 3] = 255;
    }
  }
};

int finish(const Fail& f, char* msg, int cap) {
  if (cap > 0) {
    std::strncpy(msg, f.msg.c_str(), cap - 1);
    msg[cap - 1] = 0;
  }
  return f.code;
}

}  // namespace

// Width and height of the frame (the markers are parsed, no scan decoded).
extern "C" int kt_jpeg_dims(const uint8_t* data, long long n, int* w, int* h,
                            char* msg, int cap) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)n;
    dec.parse(true);
    *w = dec.width;
    *h = dec.height;
    return 0;
  } catch (const Fail& f) {
    return finish(f, msg, cap);
  } catch (...) {  // std::bad_alloc and the like never cross the C boundary
    return finish(Fail{1, "out of memory decoding JPEG"}, msg, cap);
  }
}

// Decode into rgba (w * h * 4 bytes, w and h from kt_jpeg_dims). Returns 0,
// 1 for corrupt data, 2 for what is not decoded; msg gets the reason.
// `color` 0 takes the colour space from the markers as libjpeg guesses it;
// 1 and 2 set it as libtiff does for a JPEG strip or tile (YCbCr converted
// to RGB, or the components as coded); 3 is 0 with four components taken
// as CMYK, never YCCK (PIL's BLP reader sets the JPEG mode "CMYK").
extern "C" int kt_jpeg_decode_as(const uint8_t* data, long long n,
                                 uint8_t* rgba, int w, int h, int color,
                                 char* msg, int cap) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)n;
    dec.color = color;
    dec.parse();
    if (dec.width != w || dec.height != h) corrupt("size changed");
    if (dec.comp[0].coef.empty()) corrupt("JPEG frame without a scan");
    dec.output(rgba);
    return 0;
  } catch (const Fail& f) {
    return finish(f, msg, cap);
  } catch (...) {  // std::bad_alloc and the like never cross the C boundary
    return finish(Fail{1, "out of memory decoding JPEG"}, msg, cap);
  }
}

extern "C" int kt_jpeg_decode(const uint8_t* data, long long n, uint8_t* rgba,
                              int w, int h, char* msg, int cap) {
  return kt_jpeg_decode_as(data, n, rgba, w, h, 0, msg, cap);
}

// The frame of a JPEG stream for raw data output: info[0] the component
// count, info[1..4] width, height, the largest h and v factors, then per
// component its h, v and the plane's width and rows (whole MCUs).
extern "C" int kt_jpeg_planes_info(const uint8_t* data, long long n, int* info,
                                   char* msg, int cap) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)n;
    dec.parse(true);
    info[0] = dec.ncomp;
    info[1] = dec.width;
    info[2] = dec.height;
    info[3] = dec.hmax;
    info[4] = dec.vmax;
    for (int i = 0; i < dec.ncomp; i++) {
      info[5 + 4 * i] = dec.comp[i].h;
      info[6 + 4 * i] = dec.comp[i].v;
      info[7 + 4 * i] = dec.comp[i].aw * 8;
      info[8 + 4 * i] = dec.comp[i].ah * 8;
    }
    return 0;
  } catch (const Fail& f) {
    return finish(f, msg, cap);
  } catch (...) {
    return finish(Fail{1, "out of memory decoding JPEG"}, msg, cap);
  }
}

// libjpeg's raw data output (jpeg_read_raw_data, as libtiff's old-style
// JPEG codec reads it): each component's samples at its own resolution,
// the planes of kt_jpeg_planes_info one after the other, blocks outside the
// image left 0. The stream is decoded as libtiff's codecs decode theirs
// (the markers after the scan are not read).
extern "C" int kt_jpeg_planes(const uint8_t* data, long long n, uint8_t* out,
                              char* msg, int cap) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)n;
    dec.color = 2;
    dec.parse();
    for (int i = 0; i < dec.ncomp; i++)
      if (dec.comp[i].coef.empty()) corrupt("JPEG component without a scan");
    dec.check_smoothing();
    for (int i = 0; i < dec.ncomp; i++) {
      std::vector<uint8_t> s = dec.samples(dec.comp[i]);
      std::memcpy(out, s.data(), s.size());
      out += s.size();
    }
    return 0;
  } catch (const Fail& f) {
    return finish(f, msg, cap);
  } catch (...) {
    return finish(Fail{1, "out of memory decoding JPEG"}, msg, cap);
  }
}
