// JPEG decoder for texture sources (kajiya_tpu_torch/scene/jpeg.py): the
// bytes that libjpeg-turbo 3.1.3 gives through PIL's
// `Image.open(f).convert("RGBA")` with its default settings, which the JAX
// package's bake uses.
//
// Covered: SOF0 / SOF1 / SOF2 frames of 8-bit samples with Huffman coding
// and SOF9 / SOF10 with arithmetic coding (jdarith.c, DAC conditioning, the
// QM-coder's states of T.81 Table D.2), 1, 3 or 4 components, any integer
// sampling factors; SOF3 lossless frames (predictors 1-7, a point
// transform); DQT with 8- and 16-bit tables, DHT, DRI and RSTn, tables
// between scans, several scans a frame (sequential or progressive, with
// spectral selection and successive approximation; the coefficients of
// every scan are gathered before the inverse DCT, as libjpeg gathers them
// for a multi-scan file).
// Output follows libjpeg's decompression path:
// - the accurate integer inverse DCT (jidctint.c, jpeg_idct_islow), as the
//   x86 SIMD builds compute it (16-bit lanes that wrap or saturate where a
//   corrupt file's coefficients leave the range);
// - block smoothing of progressive files whose first AC coefficients are
//   not all known (jdcoefct.c decompress_smooth_data: DC and the first nine
//   AC coefficients estimated from a 5 x 5 window of DC values);
// - fancy upsampling (jdsample.c): h2v1 and h2v2 triangle filters (the
//   latter with its alternating 8 / 7 rounding bias) when the component is
//   more than two samples wide, h1v2, and box replication otherwise (and
//   always for a lossless frame, whose one-sample data units turn fancy
//   upsampling off);
// - the fixed-point YCbCr -> RGB tables of jdcolor.c, or no conversion for
//   an RGB-coded frame (Adobe transform 0 or component ids 'R' 'G' 'B');
// - CMYK and YCCK frames as PIL reads them ("CMYK;I", Adobe polarity), then
//   PIL's CMYK -> RGB conversion.
//
// Corrupt entropy data is decoded as libjpeg decodes it with a warning: a
// segment that ends early (JWRN_HIT_MARKER: zero bits, then the rest of the
// segment skipped), a code of no table (JWRN_HUFF_BAD_CODE: symbol 0 after
// 17 bits), a refinement code of another size, restart markers out of
// sequence (jpeg_resync_to_restart), scans out of the progression or a
// sequential scan with spectral parameters. Where the data runs out inside a
// scan, PIL's suspending source stops the decode ("image file is
// truncated"); whether libjpeg's read-ahead reaches the end depends on its
// bit buffer's fill schedule (decode_mcu_fast while 512 bytes a block stay
// in the buffer, the slow path near its end), and PIL hands libjpeg the file
// in 65536-byte blocks, so the reader follows both. The arithmetic decoder
// cannot suspend at all: its scan must lie inside the blocks PIL has handed
// over when it starts (JERR_CANT_SUSPEND).
//
// Markers are dispatched as libjpeg-turbo's read_markers does: DNL and DAC
// are read and skipped, a second SOI, the hierarchical and JPG processes
// (SOF5-7, SOF13-15, JPG) and the codes libjpeg does not know (DHP, EXP,
// JPGn, reserved) are fatal. PIL's own header walk (JpegImageFile._open,
// which refuses more) runs first, in scene/jpeg.py.
//
// Status 1 (corrupt): what makes PIL raise, such as bytes that end before
// the image does.
//
// Built with g++ at first use (scene/jpeg.py) and called through ctypes.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fail {
  int code;  // 1 corrupt, 3 the data ends (libjpeg suspends)
  std::string msg;
};

// PIL's buffer ran out inside an MCU before the end of the file: PIL reads
// the next block and libjpeg decodes the MCU again from its start
struct Suspend {};

[[noreturn]] void corrupt(const std::string& m) { throw Fail{1, m}; }
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

// jdhuff.h: HUFF_LOOKAHEAD bits decode a code of up to that length at once
const int kLook = 8;

// ITU-T T.81 Table D.2, the QM-coder's probability estimation: for each
// state its Qe value, the next state after an LPS and after an MPS, and
// whether an LPS switches the MPS sense; packed as jaricom.c packs it,
// Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS. State
// 113 is the fixed probability of one half (T.851) that libjpeg codes
// sign and refinement bits with.
#define QM(qe, nlps, nmps, sw) \
  (((int32_t)(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int32_t kQmStates[114] = {
    QM(0x5a1d, 1, 1, 1),    QM(0x2586, 14, 2, 0),   QM(0x1114, 16, 3, 0),
    QM(0x080b, 18, 4, 0),   QM(0x03d8, 20, 5, 0),   QM(0x01da, 23, 6, 0),
    QM(0x00e5, 25, 7, 0),   QM(0x006f, 28, 8, 0),   QM(0x0036, 30, 9, 0),
    QM(0x001a, 33, 10, 0),  QM(0x000d, 35, 11, 0),  QM(0x0006, 9, 12, 0),
    QM(0x0003, 10, 13, 0),  QM(0x0001, 12, 13, 0),  QM(0x5a7f, 15, 15, 1),
    QM(0x3f25, 36, 16, 0),  QM(0x2cf2, 38, 17, 0),  QM(0x207c, 39, 18, 0),
    QM(0x17b9, 40, 19, 0),  QM(0x1182, 42, 20, 0),  QM(0x0cef, 43, 21, 0),
    QM(0x09a1, 45, 22, 0),  QM(0x072f, 46, 23, 0),  QM(0x055c, 48, 24, 0),
    QM(0x0406, 49, 25, 0),  QM(0x0303, 51, 26, 0),  QM(0x0240, 52, 27, 0),
    QM(0x01b1, 54, 28, 0),  QM(0x0144, 56, 29, 0),  QM(0x00f5, 57, 30, 0),
    QM(0x00b7, 59, 31, 0),  QM(0x008a, 60, 32, 0),  QM(0x0068, 62, 33, 0),
    QM(0x004e, 63, 34, 0),  QM(0x003b, 32, 35, 0),  QM(0x002c, 33, 9, 0),
    QM(0x5ae1, 37, 37, 1),  QM(0x484c, 64, 38, 0),  QM(0x3a0d, 65, 39, 0),
    QM(0x2ef1, 67, 40, 0),  QM(0x261f, 68, 41, 0),  QM(0x1f33, 69, 42, 0),
    QM(0x19a8, 70, 43, 0),  QM(0x1518, 72, 44, 0),  QM(0x1177, 73, 45, 0),
    QM(0x0e74, 74, 46, 0),  QM(0x0bfb, 75, 47, 0),  QM(0x09f8, 77, 48, 0),
    QM(0x0861, 78, 49, 0),  QM(0x0706, 79, 50, 0),  QM(0x05cd, 48, 51, 0),
    QM(0x04de, 50, 52, 0),  QM(0x040f, 50, 53, 0),  QM(0x0363, 51, 54, 0),
    QM(0x02d4, 52, 55, 0),  QM(0x025c, 53, 56, 0),  QM(0x01f8, 54, 57, 0),
    QM(0x01a4, 55, 58, 0),  QM(0x0160, 56, 59, 0),  QM(0x0125, 57, 60, 0),
    QM(0x00f6, 58, 61, 0),  QM(0x00cb, 59, 62, 0),  QM(0x00ab, 61, 63, 0),
    QM(0x008f, 61, 32, 0),  QM(0x5b12, 65, 65, 1),  QM(0x4d04, 80, 66, 0),
    QM(0x412c, 81, 67, 0),  QM(0x37d8, 82, 68, 0),  QM(0x2fe8, 83, 69, 0),
    QM(0x293c, 84, 70, 0),  QM(0x2379, 86, 71, 0),  QM(0x1edf, 87, 72, 0),
    QM(0x1aa9, 87, 73, 0),  QM(0x174e, 72, 74, 0),  QM(0x1424, 72, 75, 0),
    QM(0x119c, 74, 76, 0),  QM(0x0f6b, 74, 77, 0),  QM(0x0d51, 75, 78, 0),
    QM(0x0bb6, 77, 79, 0),  QM(0x0a40, 77, 48, 0),  QM(0x5832, 80, 81, 1),
    QM(0x4d1c, 88, 82, 0),  QM(0x438e, 89, 83, 0),  QM(0x3bdd, 90, 84, 0),
    QM(0x34ee, 91, 85, 0),  QM(0x2eae, 92, 86, 0),  QM(0x299a, 93, 87, 0),
    QM(0x2516, 86, 71, 0),  QM(0x5570, 88, 89, 1),  QM(0x4ca9, 95, 90, 0),
    QM(0x44d9, 96, 91, 0),  QM(0x3e22, 97, 92, 0),  QM(0x3824, 99, 93, 0),
    QM(0x32b4, 99, 94, 0),  QM(0x2e17, 93, 86, 0),  QM(0x56a8, 95, 96, 1),
    QM(0x4f46, 101, 97, 0), QM(0x47e5, 102, 98, 0), QM(0x41cf, 103, 99, 0),
    QM(0x3c3d, 104, 100, 0), QM(0x375e, 99, 93, 0), QM(0x5231, 105, 102, 0),
    QM(0x4c0f, 106, 103, 0), QM(0x4639, 107, 104, 0), QM(0x415e, 103, 99, 0),
    QM(0x5627, 105, 106, 1), QM(0x50e7, 108, 107, 0), QM(0x4b85, 109, 103, 0),
    QM(0x5597, 110, 109, 0), QM(0x504f, 111, 107, 0), QM(0x5a10, 110, 111, 1),
    QM(0x5522, 112, 109, 0), QM(0x59eb, 112, 111, 1), QM(0x5a1d, 113, 113, 0)};
#undef QM

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
  // (length << 8) | symbol, or (kLook + 1) << 8 where the code is longer
  uint16_t look[1 << kLook];
};

void define_huff(Huff& h, const uint8_t* counts, const uint8_t* vals,
                 int nvals) {
  std::memcpy(h.counts, counts, 16);
  std::memcpy(h.symbols, vals, nvals);
  h.nsymbols = nvals;
  h.defined = true;
}

// jpeg_make_d_derived_tbl; `dc_max` the largest DC symbol allowed (15, or
// 16 in a lossless frame), -1 for an AC table
void build_huff(Huff& h, int dc_max) {
  const uint8_t* counts = h.counts;
  const int nvals = h.nsymbols;
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
  h.maxcode[17] = 0xFFFFF;
  std::memset(h.vals, 0, sizeof h.vals);
  std::memcpy(h.vals, h.symbols, nvals);
  for (int i = 0; i < (1 << kLook); i++) h.look[i] = (kLook + 1) << 8;
  p = 0;
  for (int l = 1; l <= kLook; l++) {
    for (int i = 0; i < counts[l - 1]; i++, p++) {
      int look = huffcode[p] << (kLook - l);
      for (int c = 0; c < (1 << (kLook - l)); c++)
        h.look[look + c] = (uint16_t)((l << 8) | h.symbols[p]);
    }
  }
  if (dc_max >= 0) {
    for (int i = 0; i < nvals; i++)
      if (h.symbols[i] > dc_max) corrupt("bad DC Huffman table");
  }
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
  std::vector<uint8_t> lossless;  // a lossless frame's dw * dh samples
  int coef_bits[64];          // progressive: -1 until a scan sets the bits
  int prev_bits[64];          // coef_bits before the component's last scan
  bool latched = false;       // the DQT copied at the component's first scan
  uint16_t quant[64];
  int dc_pred = 0;
  int dc_ctx = 0;             // arithmetic: the DC conditioning context
  bool first_row = true;      // lossless: the next row is undifferenced as
                              // a first row (jpeg_undifference_first_row)
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

  bool have_frame = false, progressive = false, lossless = false;
  bool arith = false;        // arithmetic coding (SOF9 / SOF10)
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Comp comp[4];
  bool saw_eoi = false;
  int color = 0;             // 0 by the markers, 1 YCbCr -> RGB, 2 as coded,
                             // 3 by the markers, four components as CMYK
  bool scanned = false;      // a scan was decoded
  bool single_done = false;  // single-scan mode, and its scan is decoded
  int scan_number = 0;       // SOS markers read (input_scan_number)
  int last_good_row = 0;     // the last iMCU row an MCU of began with data
                             // (master->last_good_iMCU_row)

  // libjpeg's entropy decoder: its bit buffer (kept left-aligned here, the
  // bits below the valid ones zero), the marker its reader stopped at
  // (unread_marker; pos is past the code) and insufficient_data
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  int unread = 0;
  bool insufficient = false;
  int eobrun = 0;
  int next_rst = 0, restarts_to_go = 0;
  // the end of the data PIL has handed libjpeg: 65536-byte blocks from the
  // start of the file (`chunked`), or all of it (libtiff's source)
  bool chunked = false;
  size_t bufend = 0;

  // jdarith.c: the DAC conditioning (reset by SOI: L 0, U 1, Kx 5), the
  // statistics bins of the 16 tables, and the decoder's C, A and CT
  // registers (CT -1 after a code error: the MCUs up to the next restart
  // are not decoded)
  uint8_t dac_l[16], dac_u[16], dac_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  int64_t qc = 0, qa = 0;
  int qct = -16;

  int u8() {
    if (pos >= n) ends("unexpected end of data");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // PIL has handed libjpeg every byte up to q
  void cover(size_t q) {
    while (bufend <= q && bufend < n) bufend = std::min(n, bufend + 65536);
  }

  // ---------------------------------------------------------------------
  // the bit reader (jdhuff.c jpeg_fill_bit_buffer, jdhuff.h)
  // ---------------------------------------------------------------------

  int src_byte() {
    if (pos >= bufend) {
      if (bufend >= n) corrupt("image file is truncated (inside a scan)");
      throw Suspend{};
    }
    return d[pos++];
  }

  // jpeg_fill_bit_buffer: up to 57 bits, stopping at a marker; past one,
  // zero bits where `nbits` are wanted (JWRN_HIT_MARKER)
  void fill_slow(int nbits) {
    if (!unread) {
      while (bitcnt < 57) {
        int c = src_byte();
        if (c == 0xFF) {
          do c = src_byte();
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread = c;
            goto no_more;
          }
        }
        bitbuf |= (uint64_t)c << (56 - bitcnt);
        bitcnt += 8;
      }
      return;
    }
  no_more:
    if (nbits > bitcnt) {
      insufficient = true;
      bitcnt = 57;
    }
  }

  // FILL_BIT_BUFFER_FAST: six bytes once 16 bits or fewer are left; a marker
  // is backed out and read as zero bits (the MCU is then decoded again on
  // the slow path)
  void fill_fast() {
    if (bitcnt > 16) return;
    for (int i = 0; i < 6; i++) {
      if (pos + 1 >= n) {  // the guard libjpeg's buffer test gives
        unread = 0xD9;
        bitcnt += 8;
        continue;
      }
      int c0 = d[pos++], c1 = d[pos];
      bitbuf |= (uint64_t)c0 << (56 - bitcnt);
      bitcnt += 8;
      if (c0 == 0xFF) {
        pos++;
        if (c1 != 0) {
          unread = c1;
          pos -= 2;
          bitbuf &= ~((uint64_t)0xFF << (64 - bitcnt));
        }
      }
    }
  }

  int take(int k) {
    int v = (int)(bitbuf >> (64 - k));
    bitbuf <<= k;
    bitcnt -= k;
    return v;
  }

  template <bool FAST>
  int bits(int k) {
    if (FAST)
      fill_fast();
    else if (bitcnt < k)
      fill_slow(k);
    return take(k);
  }

  // HUFF_DECODE (jpeg_huff_decode beyond the lookahead) and
  // HUFF_DECODE_FAST: a code of no table reads as symbol 0 after 17 bits
  template <bool FAST>
  int decode(const Huff& h) {
    int nb, code;
    if (FAST) {
      fill_fast();
      int e = h.look[bitbuf >> (64 - kLook)];
      nb = e >> 8;
      if (nb <= kLook) {
        take(nb);
        return e & 0xFF;
      }
      code = take(nb);
      while (code > h.maxcode[nb]) {
        code = (code << 1) | take(1);
        nb++;
      }
      if (nb > 16) return 0;
      return h.vals[(code + h.valoffset[nb]) & 0xFF];
    }
    if (bitcnt < kLook) {
      fill_slow(0);
      if (bitcnt < kLook) {
        nb = 1;
        goto slow;
      }
    }
    {
      int e = h.look[bitbuf >> (64 - kLook)];
      nb = e >> 8;
      if (nb <= kLook) {
        take(nb);
        return e & 0xFF;
      }
    }
  slow:
    if (bitcnt < nb) fill_slow(nb);
    code = take(nb);
    while (code > h.maxcode[nb]) {
      if (bitcnt < 1) fill_slow(1);
      code = (code << 1) | take(1);
      nb++;
    }
    if (nb > 16) return 0;  // JWRN_HUFF_BAD_CODE
    return h.vals[(code + h.valoffset[nb]) & 0xFF];
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

  // get_dqt / get_dht read their segments byte by byte: an error inside
  // one comes before the data runs out
  void read_dqt() {
    int len = u16() - 2;
    size_t end = pos + len;
    if (len < 0) corrupt("bad DQT length");
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
    // libjpeg-turbo codes lossless frames with Huffman tables only
    if (marker == 0xCB) corrupt("lossless arithmetic-coded JPEG frame");
    int len = u16();
    size_t end = pos + len - 2;
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    // libjpeg's 8-bit API (jpeg_read_scanlines, jpeg_read_raw_data) errs
    // on other precisions (JERR_BAD_PRECISION); PIL's `_open` refuses them
    // first
    if (prec != 8) corrupt("JPEG sample precision other than 8 bits");
    // libjpeg-turbo reads no DNL height (JERR_EMPTY_IMAGE)
    if (height == 0 || width == 0) corrupt("empty JPEG frame");
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
    progressive = marker == 0xC2 || marker == 0xCA;
    lossless = marker == 0xC3;
    arith = marker >= 0xC9;
    // a lossless frame's data unit is one sample
    const int unit = lossless ? 1 : 8;
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.dw = (int)(((long long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long long)height * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + unit - 1) / unit;
      c.bh = (c.dh + unit - 1) / unit;
      c.aw = mcux * c.h;
      c.ah = mcuy * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = c.prev_bits[k] = -1;
    }
    have_frame = true;
  }

  // ---------------------------------------------------------------------
  // scans
  // ---------------------------------------------------------------------

  // decode_mcu_slow / decode_mcu_fast: the blocks of one MCU
  template <bool FAST>
  void decode_mcu_seq(Comp* const* mc, int16_t* const* mb, int nblk) {
    for (int b = 0; b < nblk; b++) {
      Comp& c = *mc[b];
      int16_t* blk = mb[b];
      const Huff& act = ac_tab[c.ta];
      int s = decode<FAST>(dc_tab[c.td]);
      if (s) s = extend(bits<FAST>(s), s);
      c.dc_pred = (int)((unsigned)c.dc_pred + (unsigned)s);
      blk[0] = (int16_t)c.dc_pred;
      for (int k = 1; k < 64; k++) {
        int rs = decode<FAST>(act);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = (int16_t)extend(bits<FAST>(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  void decode_dc_first(Comp& c, int16_t* blk, int al) {
    int s = decode<false>(dc_tab[c.td]);
    if (s) s = extend(bits<false>(s), s);
    // jdphuff.c: a prediction that leaves int's range is fatal
    if ((c.dc_pred >= 0 && s > INT_MAX - c.dc_pred) ||
        (c.dc_pred < 0 && s < INT_MIN - c.dc_pred))
      corrupt("DC coefficient out of range (JERR_BAD_DCT_COEF)");
    c.dc_pred += s;
    blk[0] = (int16_t)(int)((unsigned)c.dc_pred << al);
  }

  void decode_dc_refine(int16_t* blk, int al) {
    if (bits<false>(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void decode_ac_first(Comp& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huff& act = ac_tab[c.ta];
    for (int k = ss; k <= se; k++) {
      int rs = decode<false>(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(bits<false>(s), s);
        blk[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += bits<false>(r);
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
        int rs = decode<false>(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // a size other than 1: JWRN_HUFF_BAD_CODE, read as 1
          s = bits<false>(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits<false>(r);
          break;
        }
        do {
          int16_t* co = blk + kNatural[k];
          if (*co != 0) {
            if (bits<false>(1)) {
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
          if (bits<false>(1)) {
            if ((*co & p1) == 0) *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
          }
        }
      }
      eobrun--;
    }
  }

  // jdmarker.c jpeg_resync_to_restart: the marker found where RSTn
  // (`desired`) was due is discarded, skipped to the next marker, or left
  // for the entropy decoder to meet as an empty segment
  void resync(int desired) {
    int marker = unread;
    for (;;) {
      int action;
      if (marker < 0xC0)
        action = 2;  // not a marker libjpeg knows: scan on
      else if (marker < 0xD0 || marker > 0xD7)
        action = 3;  // a marker that is not RSTn
      else if (marker == 0xD0 + ((desired + 1) & 7) ||
               marker == 0xD0 + ((desired + 2) & 7))
        action = 3;  // one of the next two restarts
      else if (marker == 0xD0 + ((desired - 1) & 7) ||
               marker == 0xD0 + ((desired - 2) & 7))
        action = 2;  // a restart already passed
      else
        action = 1;  // the desired restart, or one too far away
      if (action == 1) {
        unread = 0;
        return;
      }
      if (action == 3) return;
      unread = marker = scan_marker();
    }
  }

  // a marker read inside a scan: PIL hands libjpeg more data, but the
  // arithmetic decoder cannot suspend (JERR_CANT_SUSPEND)
  int scan_marker() {
    int m = next_marker();
    if (arith && pos > bufend)
      corrupt("arithmetic-coded scan past PIL's data (JERR_CANT_SUSPEND)");
    cover(pos - 1);
    return m;
  }

  // jdmarker.c read_restart_marker
  void read_restart_marker() {
    if (!unread) unread = scan_marker();
    if (unread == 0xD0 + next_rst)
      unread = 0;
    else
      resync(next_rst);
    next_rst = (next_rst + 1) & 7;
  }

  // process_restart (jdhuff.c, jdphuff.c, jdlhuff.c): the bits left are
  // dropped, the marker read (read_restart_marker), the predictions reset
  void process_restart(Comp* const* sc, int ns) {
    bitbuf = 0;
    bitcnt = 0;
    read_restart_marker();
    for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    // a marker left unread makes the next segment empty
    if (!unread) insufficient = false;
  }

  // jdinput.c latch_quant_tables: a component's DQT is copied at its first
  // scan (JERR_NO_QUANT_TABLE where there is none)
  void latch_quant(Comp& c) {
    if (c.latched) return;
    if (!quant_defined[c.tq]) corrupt("component uses an undefined DQT");
    std::memcpy(c.quant, quant[c.tq], sizeof c.quant);
    c.latched = true;
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
    scan_number++;
    next_rst = 0;
    // jdinput.c consume_markers: a scan after single-scan mode's one
    if (single_done) corrupt("a second scan in single-scan mode");
    if (ns > 1) {
      // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) corrupt("too many blocks in an MCU");
    }
    if (!lossless)
      for (int i = 0; i < ns; i++) latch_quant(*sc[i]);
    int ah = a >> 4, al = a & 15;
    if (lossless) {
      // jdlossls.c start_pass_lossless
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
        corrupt("bad lossless scan parameters");
    } else if (progressive) {
      if (ss == 0) {
        if (se != 0) corrupt("bad progression");
      } else {
        if (se < ss || se > 63 || ns != 1) corrupt("bad progression");
      }
      if (ah != 0 && ah - 1 != al) corrupt("bad progression");
      if (al > 13) corrupt("bad progression");
      // start_pass_phuff_decoder: a scan out of the progression is decoded
      // with a warning (JWRN_BOGUS_PROGRESSION); the bits before the scan
      // are kept for block smoothing
      for (int i = 0; i < ns; i++) {
        int* cb = sc[i]->coef_bits;
        int* prev = sc[i]->prev_bits;
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          prev[k] = scan_number > 1 ? cb[k] : 0;
        for (int k = ss; k <= se; k++) cb[k] = al;
      }
    }
    // a sequential scan with Ss, Se, Ah or Al set is decoded as a baseline
    // one (JWRN_NOT_SEQUENTIAL)
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      bool need_dc = lossless || !progressive || (ss == 0 && ah == 0);
      bool need_ac = !lossless && (!progressive || ss != 0);
      if (arith) {
        // jdarith.c start_pass: the scan's statistics bins zeroed
        if (need_dc) {
          std::memset(dc_stats[c.td], 0, 64);
          c.dc_pred = 0;
          c.dc_ctx = 0;
        }
        if (need_ac) std::memset(ac_stats[c.ta], 0, 256);
        continue;
      }
      // libjpeg's jpeg_make_d_derived_tbl errs on a selector above 3 where
      // the scan uses the table (a DC refinement scan uses none)
      if ((need_dc && c.td > 3) || (need_ac && c.ta > 3))
        corrupt("bad Huffman table selector");
      if (need_dc && !dc_tab[c.td].defined)
        corrupt("scan uses an undefined DC Huffman table");
      if (need_ac && !ac_tab[c.ta].defined)
        corrupt("scan uses an undefined AC Huffman table");
      if (need_dc) build_huff(dc_tab[c.td], lossless ? 16 : 15);
      if (need_ac) build_huff(ac_tab[c.ta], -1);
      c.dc_pred = 0;
    }
    // the buffers are allocated at the first scan, so parsing the markers
    // alone (kt_jpeg_dims) allocates nothing of the image's size
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      if (lossless && c.lossless.empty())
        c.lossless.assign((size_t)c.dw * c.dh, 0);
      else if (!lossless && c.coef.empty())
        c.coef.assign((size_t)c.aw * c.ah * 64, 0);
    }
    eobrun = 0;
    bitbuf = 0;
    bitcnt = 0;
    insufficient = false;
    restarts_to_go = restart_interval;
    qc = qa = 0;
    qct = -16;
    const bool single = !progressive && ns == ncomp && !scanned;
    // PIL's blocks decide only where libjpeg's sequential Huffman decoder
    // picks its fast path (the other decoders read the same bits whatever
    // the blocks)
    const bool seq = !progressive && !lossless;
    if (!seq && !arith) bufend = n;
    cover(pos - 1);

    if (arith)
      arith_scan(sc, ns, single, ss, se, ah, al);
    else if (lossless)
      lossless_scan(sc, ns, ss, al);
    else if (seq)
      sequential_scan(sc, ns, single);
    else
      progressive_scan(sc, ns, ss, se, ah, al);
    // the bits left are dropped; the markers go on from the one the reader
    // stopped at, if any
    bitbuf = 0;
    bitcnt = 0;
    // an interleaved sequential first scan is libjpeg's single-scan mode:
    // the image is complete, and PIL only finishes the decompressor
    if (single) single_done = true;
    scanned = true;
  }

  // the MCUs of a scan: (component, block column, block row) of each block
  // of MCU (mx, my), or of block (mx, my) of a one-component scan
  int mcu_blocks(Comp* const* sc, int ns, int mx, int my, Comp** mc,
                 int16_t** mb) {
    auto at = [](Comp& c, int bx, int by) {
      return c.coef.data() + ((size_t)by * c.aw + bx) * 64;
    };
    if (ns == 1) {
      mc[0] = sc[0];
      mb[0] = at(*sc[0], mx, my);
      return 1;
    }
    int nb = 0;
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      for (int y = 0; y < c.v; y++)
        for (int x = 0; x < c.h; x++) {
          mc[nb] = &c;
          mb[nb++] = at(c, mx * c.h + x, my * c.v + y);
        }
    }
    return nb;
  }

  // fn(nblk, mc, mb) for each MCU of the scan in order; an MCU that
  // begins with data marks its iMCU row good (consume_data's
  // last_good_iMCU_row, before decode_mcu's restart)
  template <class F>
  void each_mcu(Comp* const* sc, int ns, F&& fn) {
    const int cols = ns == 1 ? sc[0]->bw : mcux;
    const int rows = ns == 1 ? sc[0]->bh : mcuy;
    const int rows_per_imcu = ns == 1 ? sc[0]->v : 1;
    Comp* mc[10];
    int16_t* mb[10];
    for (int my = 0; my < rows; my++) {
      for (int mx = 0; mx < cols; mx++) {
        const int nblk = mcu_blocks(sc, ns, mx, my, mc, mb);
        if (!insufficient) last_good_row = my / rows_per_imcu;
        fn(nblk, mc, mb);
      }
    }
  }

  void sequential_scan(Comp* const* sc, int ns, bool single) {
    each_mcu(sc, ns, [&](int nblk, Comp** mc, int16_t** mb) {
      if (restart_interval && restarts_to_go == 0) process_restart(sc, ns);
      // single-scan mode decodes into a zeroed MCU buffer; a multi-scan
      // file's blocks keep what an earlier scan of theirs left
      if (single)
        for (int b = 0; b < nblk; b++) std::memset(mb[b], 0, 128);
      if (!insufficient) {
        const uint64_t b0 = bitbuf;
        const int c0 = bitcnt;
        const size_t p0 = pos;
        const int u0 = unread;
        int pred[4];
        for (int i = 0; i < ns; i++) pred[i] = sc[i]->dc_pred;
        auto restore = [&]() {
          bitbuf = b0;
          bitcnt = c0;
          pos = p0;
          unread = u0;
          for (int i = 0; i < ns; i++) sc[i]->dc_pred = pred[i];
        };
        for (;;) {
          try {
            // decode_mcu: the fast path while no restart interval is set,
            // no marker has been met and 512 bytes a block are left in
            // the buffer
            if (!restart_interval && !unread &&
                bufend - pos >= (size_t)512 * nblk) {
              decode_mcu_seq<true>(mc, mb, nblk);
              if (unread) {
                restore();
                decode_mcu_seq<false>(mc, mb, nblk);
              }
            } else {
              decode_mcu_seq<false>(mc, mb, nblk);
            }
            break;
          } catch (const Suspend&) {
            cover(bufend);
            restore();
          }
        }
      }
      if (restart_interval) restarts_to_go--;
    });
  }

  void progressive_scan(Comp* const* sc, int ns, int ss, int se, int ah,
                        int al) {
    each_mcu(sc, ns, [&](int nblk, Comp** mc, int16_t** mb) {
      if (restart_interval && restarts_to_go == 0) process_restart(sc, ns);
      if (ss == 0 && ah != 0) {
        // decode_mcu_DC_refine reads on past the data (zero bits change
        // nothing)
        for (int b = 0; b < nblk; b++) decode_dc_refine(mb[b], al);
      } else if (!insufficient) {
        for (int b = 0; b < nblk; b++) {
          if (ss == 0)
            decode_dc_first(*mc[b], mb[b], al);
          else if (ah == 0)
            decode_ac_first(*mc[b], mb[b], ss, se, al);
          else
            decode_ac_refine(*mc[b], mb[b], ss, se, al);
        }
      }
      if (restart_interval) restarts_to_go--;
    });
  }

  // jddiffct.c / jdlhuff.c / jdlossls.c: a lossless scan, one row of MCUs
  // at a time, each iMCU row undifferenced once decoded
  void lossless_scan(Comp* const* sc, int ns, int psv, int pt) {
    const int cols = ns == 1 ? sc[0]->dw : mcux;
    // jddiffct.c start_input_pass: restarts fall between rows of MCUs
    if (restart_interval % cols)
      corrupt("restart interval not a multiple of the MCU row "
              "(JERR_BAD_RESTART)");
    const int restart_rows = restart_interval / cols;
    int rows_to_go = restart_rows;
    // start_pass_lossless: every component's next row is a first row
    for (int i = 0; i < ncomp; i++) comp[i].first_row = true;
    const int imcu_rows = mcuy;
    std::vector<int> diff[4], undiff[4];
    int dstride[4];
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      dstride[i] = ns == 1 ? c.dw : cols * c.h;
      diff[i].assign((size_t)dstride[i] * c.v, 0);
      undiff[i].assign((size_t)c.dw * c.v, 0);
    }
    const int initial = 1 << (8 - pt - 1);
    for (int r = 0; r < imcu_rows; r++) {
      const bool last = r == imcu_rows - 1;
      const int mcu_rows =
          ns > 1 ? 1 : (last ? (sc[0]->dh % sc[0]->v ?: sc[0]->v) : sc[0]->v);
      for (int y = 0; y < mcu_rows; y++) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            process_restart(sc, ns);
            for (int i = 0; i < ncomp; i++) comp[i].first_row = true;
            rows_to_go = restart_rows;
          }
        }
        if (insufficient) {
          // decode_mcus: zero differences, and the predictors reset, so the
          // rest of the segment comes out at the initial prediction
          for (int i = 0; i < ns; i++) {
            Comp& c = *sc[i];
            int rows_c = ns > 1 ? c.v : 1;
            for (int yy = 0; yy < rows_c; yy++)
              std::fill_n(diff[i].begin() + (size_t)(ns > 1 ? yy : y) *
                                                dstride[i],
                          dstride[i], 0);
          }
          for (int i = 0; i < ncomp; i++) comp[i].first_row = true;
        } else {
          for (int mx = 0; mx < cols; mx++) {
            for (int i = 0; i < ns; i++) {
              Comp& c = *sc[i];
              const Huff& h = dc_tab[c.td];
              const int mh = ns > 1 ? c.h : 1, mv = ns > 1 ? c.v : 1;
              for (int yy = 0; yy < mv; yy++)
                for (int xx = 0; xx < mh; xx++) {
                  int s = decode<false>(h);
                  if (s == 16)
                    s = 32768;
                  else if (s)
                    s = extend(bits<false>(s), s);
                  int row = ns > 1 ? yy : y;
                  diff[i][(size_t)row * dstride[i] + mx * mh + xx] = s;
                }
            }
          }
        }
        if (restart_interval) rows_to_go--;
      }
      // undifference and scale the rows of this iMCU row (not the dummy
      // rows at the bottom, nor the dummy samples at a row's end)
      for (int i = 0; i < ns; i++) {
        Comp& c = *sc[i];
        const int nrows = last ? (c.dh % c.v ?: c.v) : c.v;
        for (int row = 0, prev = c.v - 1; row < nrows; prev = row, row++) {
          const int* df = diff[i].data() + (size_t)row * dstride[i];
          int* out = undiff[i].data() + (size_t)row * c.dw;
          const int* up = undiff[i].data() + (size_t)prev * c.dw;
          if (c.first_row) {
            int ra = (df[0] + initial) & 0xFFFF;
            out[0] = ra;
            for (int x = 1; x < c.dw; x++) out[x] = ra = (df[x] + ra) & 0xFFFF;
            c.first_row = false;
          } else {
            // UNDIFFERENCE_2D: `up` is `out` when v is 1, so Rb is read
            // before its sample is overwritten and Rc kept from it
            int rb = up[0];
            int ra = (df[0] + rb) & 0xFFFF;
            out[0] = ra;
            for (int x = 1; x < c.dw; x++) {
              const int rc = rb;
              rb = up[x];
              const long long a = ra, b = rb, cc = rc;
              long long p;
              switch (psv) {
                case 1: p = a; break;
                case 2: p = b; break;
                case 3: p = cc; break;
                case 4: p = a + b - cc; break;
                case 5: p = a + ((b - cc) >> 1); break;
                case 6: p = b + ((a - cc) >> 1); break;
                default: p = (a + b) >> 1; break;
              }
              out[x] = ra = (int)((df[x] + p) & 0xFFFF);
            }
          }
          uint8_t* dst = c.lossless.data() + (size_t)(r * c.v + row) * c.dw;
          for (int x = 0; x < c.dw; x++) dst[x] = (uint8_t)(out[x] << pt);
        }
      }
    }
  }

  // ---------------------------------------------------------------------
  // arithmetic coding (jdarith.c)
  // ---------------------------------------------------------------------

  // get_byte: the arithmetic decoder cannot suspend, so PIL's data running
  // out inside the scan, at a 65536-byte block or at the end, is fatal
  int arith_byte() {
    if (pos >= bufend)
      corrupt("arithmetic-coded scan past PIL's data (JERR_CANT_SUSPEND)");
    return d[pos++];
  }

  // arith_decode: one binary decision with the statistics bin `st`
  // (sections D.2.4-D.2.6); past a marker the data reads as zeros
  int arith_decode(uint8_t* st) {
    while (qa < 0x8000) {
      if (--qct < 0) {
        int data = 0;
        if (!unread) {
          data = arith_byte();
          if (data == 0xFF) {
            do data = arith_byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread = data;
              data = 0;
            }
          }
        }
        qc = (qc << 8) | data;
        if ((qct += 8) < 0)
          if (++qct == 0) qa = 0x8000;  // two initial bytes read
      }
      qa <<= 1;
    }
    int sv = *st;
    int64_t qe = kQmStates[sv & 0x7F];
    const int nl = (int)(qe & 0xFF);
    qe >>= 8;
    const int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = qa - qe;
    qa = temp;
    temp <<= qct;
    if (qc >= temp) {
      qc -= temp;
      if (qa < qe) {
        qa = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        qa = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (qa < 0x8000) {
      if (qa < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // a DC difference (figures F.19-F.24) into c.dc_pred; false on a
  // magnitude overflow (JWRN_ARITH_BAD_CODE: CT set to -1)
  bool arith_dc(Comp& c) {
    const int tbl = c.td;
    uint8_t* st = dc_stats[tbl] + c.dc_ctx;
    if (arith_decode(st) == 0) {
      c.dc_ctx = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          qct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < (int)((1L << dac_l[tbl]) >> 1))
      c.dc_ctx = 0;
    else if (m > (int)((1L << dac_u[tbl]) >> 1))
      c.dc_ctx = 12 + sign * 4;
    else
      c.dc_ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c.dc_pred = (c.dc_pred + v) & 0xFFFF;
    return true;
  }

  // AC coefficients ss..se of a block (figure F.20), each scaled by al;
  // false on a spectral or magnitude overflow
  bool arith_ac(Comp& c, int16_t* blk, int ss, int se, int al) {
    const int tbl = c.ta;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          qct = -1;
          return false;
        }
      }
      const int sign = arith_decode(fixed_bin);
      st += 2;
      int m = arith_decode(st);
      if (m) {
        if (arith_decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= dac_k[tbl] ? 189 : 217);
          while (arith_decode(st)) {
            if ((m <<= 1) == 0x8000) {
              qct = -1;
              return false;
            }
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
    }
    return true;
  }

  // decode_mcu_AC_refine
  void arith_ac_refine(Comp& c, int16_t* blk, int ss, int se, int al) {
    const int tbl = c.ta;
    const int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* co = blk + kNatural[k];
        if (*co) {
          if (arith_decode(st + 2))
            *co = (int16_t)(*co < 0 ? *co + m1 : *co + p1);
          break;
        }
        if (arith_decode(st + 1)) {
          *co = (int16_t)(arith_decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          qct = -1;
          return;
        }
      }
    }
  }

  // jdarith.c process_restart: the marker, then the scan's statistics and
  // predictions reset, and C, A and CT
  void arith_restart(Comp* const* sc, int ns, int ss, int ah) {
    read_restart_marker();
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c.td], 0, 64);
        c.dc_pred = 0;
        c.dc_ctx = 0;
      }
      if (!progressive || ss) std::memset(ac_stats[c.ta], 0, 256);
    }
    qc = qa = 0;
    qct = -16;
    restarts_to_go = restart_interval;
  }

  // (the arithmetic decoder never runs out of data: insufficient_data stays
  // false, so every row is a good one)
  void arith_scan(Comp* const* sc, int ns, bool single, int ss, int se,
                  int ah, int al) {
    each_mcu(sc, ns, [&](int nblk, Comp** mc, int16_t** mb) {
      if (restart_interval) {
        if (restarts_to_go == 0) arith_restart(sc, ns, ss, ah);
        restarts_to_go--;
      }
      if (single)
        for (int b = 0; b < nblk; b++) std::memset(mb[b], 0, 128);
      if (progressive && ss == 0 && ah != 0) {
        // decode_mcu_DC_refine decodes even after a code error
        for (int b = 0; b < nblk; b++)
          if (arith_decode(fixed_bin))
            mb[b][0] = (int16_t)(mb[b][0] | (1 << al));
        return;
      }
      if (qct == -1) return;
      for (int b = 0; b < nblk; b++) {
        Comp& c = *mc[b];
        if (!progressive) {
          if (!arith_dc(c)) break;
          mb[b][0] = (int16_t)c.dc_pred;
          if (!arith_ac(c, mb[b], 1, 63, 0)) break;
        } else if (ss == 0) {
          if (!arith_dc(c)) break;
          mb[b][0] = (int16_t)(int)((unsigned)c.dc_pred << al);
        } else if (ah == 0) {
          arith_ac(c, mb[b], ss, se, al);
        } else {
          arith_ac_refine(c, mb[b], ss, se, al);
        }
      }
    });
  }

  // jstdhuff.c std_huff_tables, as jinit_huff_decoder runs it at the
  // start of sequential decompression (the progressive and lossless
  // decoders do not):
  // tables 0 and 1 the header left undefined
  void default_tables() {
    if (!dc_tab[0].defined) define_huff(dc_tab[0], kDcLumaBits, kDcVals, 12);
    if (!ac_tab[0].defined)
      define_huff(ac_tab[0], kAcLumaBits, kAcLumaVals, 162);
    if (!dc_tab[1].defined) define_huff(dc_tab[1], kDcChromaBits, kDcVals, 12);
    if (!ac_tab[1].defined)
      define_huff(ac_tab[1], kAcChromaBits, kAcChromaVals, 162);
  }

  // jdmarker.c get_dac: arithmetic conditioning values (unused by a
  // Huffman-coded frame)
  void read_dac() {
    int len = u16() - 2;
    while (len > 0) {
      int index = u8(), val = u8();
      len -= 2;
      if (index >= 32) corrupt("bad DAC index");
      if (index >= 16) {
        dac_k[index - 16] = (uint8_t)val;
      } else {
        dac_l[index] = (uint8_t)(val & 15);
        dac_u[index] = (uint8_t)(val >> 4);
        if (dac_l[index] > dac_u[index]) corrupt("bad DAC value");
      }
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
    // get_soi's defaults
    std::memset(dac_l, 0, sizeof dac_l);
    std::memset(dac_u, 1, sizeof dac_u);
    std::memset(dac_k, 5, sizeof dac_k);
    bufend = chunked ? std::min(n, (size_t)65536) : n;
    for (;;) {
      int m = unread;
      unread = 0;
      if (!m) m = next_marker();
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
          if (!scanned && !progressive && !lossless) default_tables();
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

  // jdcoefct.c smoothing_ok: block smoothing applies to a progressive file
  // whose DC is known for every component and some of whose first nine AC
  // coefficients are not known to full precision
  bool smoothing_ok() const {
    if (!progressive) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Comp& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k < 10; k++)
        if (c.quant[kPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data: a block of component `c`
  // with its first coefficients estimated from the DC values `dc` of the
  // 5 x 5 blocks around it, where they are still zero and not known
  // exactly; `bits` are the coefficients' Al (coef_bits_latch).
  static void smooth_block(const Comp& c, const int* dc, const int* bits,
                           bool change_dc, int16_t* ws) {
    const long long Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8],
                    Q20 = c.quant[16], Q11 = c.quant[9], Q02 = c.quant[2],
                    Q03 = c.quant[3], Q12 = c.quant[10], Q21 = c.quant[17],
                    Q30 = c.quant[24];
    // DC01..DC25 of libjpeg: rows -2..2, columns -2..2
    const int DC01 = dc[0], DC02 = dc[1], DC03 = dc[2], DC04 = dc[3],
              DC05 = dc[4], DC06 = dc[5], DC07 = dc[6], DC08 = dc[7],
              DC09 = dc[8], DC10 = dc[9], DC11 = dc[10], DC12 = dc[11],
              DC13 = dc[12], DC14 = dc[13], DC15 = dc[14], DC16 = dc[15],
              DC17 = dc[16], DC18 = dc[17], DC19 = dc[18], DC20 = dc[19],
              DC21 = dc[20], DC22 = dc[21], DC23 = dc[22], DC24 = dc[23],
              DC25 = dc[24];
    auto predict = [&](int slot, int pos, long long q, long long num) {
      int al = bits[slot];
      if (al == 0 || ws[pos] != 0) return;
      int pred;
      if (num >= 0) {
        pred = (int)(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = (int)(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      ws[pos] = (int16_t)pred;
    };
    // AC01
    predict(1, 1, Q01,
            Q00 * (change_dc
                       ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                          13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                          38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                          13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                       : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)));
    // AC10
    predict(2, 8, Q10,
            Q00 * (change_dc
                       ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                          DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 +
                          DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 +
                          DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                       : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)));
    // AC20
    predict(3, 16, Q20,
            Q00 * (change_dc
                       ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                          14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                          2 * DC19 + DC23)
                       : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)));
    // AC11
    predict(4, 9, Q11,
            Q00 * (change_dc
                       ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                          9 * DC19 + DC21 - DC25)
                       : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                          DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                          10 * DC09)));
    // AC02
    predict(5, 2, Q02,
            Q00 * (change_dc
                       ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                          14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                          2 * DC19)
                       : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)));
    if (!change_dc) return;
    // AC03, AC12, AC21, AC30, then the DC itself
    predict(6, 3, Q03,
            Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19));
    predict(7, 10, Q12,
            Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19));
    predict(8, 17, Q21,
            Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19));
    predict(9, 24, Q30,
            Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19));
    const long long num =
        Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
               6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
               8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
               6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
               2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
    int pred;
    if (num >= 0)
      pred = (int)(((Q00 << 7) + num) / (Q00 << 8));
    else
      pred = -(int)(((Q00 << 7) - num) / (Q00 << 8));
    ws[0] = (int16_t)pred;
  }

  // one component's samples: (ah * 8) rows of aw * 8 (a lossless frame's:
  // dh rows of dw)
  std::vector<uint8_t> samples(const Comp& c, bool smooth) {
    if (lossless) return c.lossless;
    int stride = c.aw * 8;
    std::vector<uint8_t> out((size_t)stride * c.ah * 8);
    // a component no scan named keeps zero coefficients (and no table)
    static const uint16_t kZero[64] = {};
    const uint16_t* q = c.latched ? c.quant : kZero;
    auto block = [&](int bx, int by) {
      return c.coef.data() + ((size_t)by * c.aw + bx) * 64;
    };
    if (!smooth) {
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(block(bx, by), q,
                     out.data() + (size_t)by * 8 * stride + bx * 8, stride);
      return out;
    }
    // decompress_smooth_data, one iMCU row (v block rows) at a time
    const int total = mcuy, last = total - 1;
    const bool prev_scan_rows = last_good_row < last;
    const int* cur_bits = c.coef_bits;
    int prev_bits[10];
    for (int k = 0; k < 10; k++)
      prev_bits[k] = scan_number > 1 ? c.prev_bits[k] : -1;
    int16_t ws[64];
    for (int r = 0; r < total; r++) {
      int block_rows = c.v;
      if (r == last) {
        block_rows = c.bh % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      // the rows of an incomplete last scan use the bits before it
      const int* bits_r =
          (prev_scan_rows && r > last_good_row) ? prev_bits : cur_bits;
      bool change_dc = true;
      for (int k = 1; k < 10; k++) change_dc = change_dc && bits_r[k] == -1;
      const int image_rows = block_rows * total;
      for (int br = 0; br < block_rows; br++) {
        const int image_row = r * block_rows + br;
        const int cur = r * c.v + br;
        const int prev = image_row > 0 ? cur - 1 : cur;
        const int prev2 = image_row > 1 ? cur - 2 : prev;
        const int next = image_row < image_rows - 1 ? cur + 1 : cur;
        const int next2 = image_row < image_rows - 2 ? cur + 2 : next;
        const int rowsel[5] = {prev2, prev, cur, next, next2};
        const int16_t* rows[5];
        for (int k = 0; k < 5; k++)
          rows[k] = c.coef.data() + (size_t)rowsel[k] * c.aw * 64;
        auto dcat = [&](int k, int bx) {
          return (int)rows[k][(size_t)bx * 64];
        };
        int dc[25];
        for (int k = 0; k < 5; k++)
          for (int j = 0; j < 5; j++) dc[5 * k + j] = dcat(k, 0);
        const int last_col = c.bw - 1;
        for (int bx = 0; bx < c.bw; bx++) {
          std::memcpy(ws, rows[2] + (size_t)bx * 64, sizeof ws);
          if (bx == 0 && bx < last_col)
            for (int k = 0; k < 5; k++)
              dc[5 * k + 3] = dc[5 * k + 4] = dcat(k, bx + 1);
          if (bx + 1 < last_col)
            for (int k = 0; k < 5; k++) dc[5 * k + 4] = dcat(k, bx + 2);
          smooth_block(c, dc, bits_r, change_dc, ws);
          idct_islow(ws, q, out.data() + (size_t)cur * 8 * stride + bx * 8,
                     stride);
          for (int k = 0; k < 5; k++)
            for (int j = 0; j < 4; j++) dc[5 * k + j] = dc[5 * k + j + 1];
        }
      }
    }
    return out;
  }

  // component c upsampled to width x height (jdsample.c)
  std::vector<uint8_t> upsample(const Comp& c, bool smooth) {
    // jinit_upsampler: only integer ratios (JERR_FRACT_SAMPLE_NOTIMPL)
    if (hmax % c.h || vmax % c.v)
      corrupt("non-integer JPEG sampling ratios (JERR_FRACT_SAMPLE_NOTIMPL)");
    std::vector<uint8_t> s = samples(c, smooth);
    int stride = lossless ? c.dw : c.aw * 8;
    int fx = hmax / c.h, fy = vmax / c.v;
    std::vector<uint8_t> out((size_t)width * height);
    auto at = [&](int y, int x) -> int { return s[(size_t)y * stride + x]; };
    // do_fancy: the frame's data units are more than one sample wide
    const bool fancy = !lossless;
    bool fancy_h2 = fancy && fx == 2 && c.dw > 2;
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
    } else if (fancy && fx == 1 && fy == 2) {
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

  void output(uint8_t* rgba) {
    const bool smooth = smoothing_ok();
    std::vector<uint8_t> p[4];
    for (int i = 0; i < ncomp; i++) p[i] = upsample(comp[i], smooth);
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
    // four components under libtiff's colour spaces: YCbCr needs three
    // (JERR_BAD_J_COLORSPACE); JCS_UNKNOWN passes them as coded
    if (color == 1) corrupt("YCbCr with four components");
    if (color == 2) {
      for (size_t i = 0; i < np; i++)
        for (int j = 0; j < 4; j++) rgba[4 * i + j] = p[j][i];
      return;
    }
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
// or 1 for corrupt data; msg gets the reason.
// `color` 0 takes the colour space from the markers as libjpeg guesses it;
// 1 and 2 set it as libtiff does for a JPEG strip or tile (YCbCr converted
// to RGB, or the components as coded); 3 is 0 with four components taken
// as CMYK, never YCCK (PIL's BLP reader sets the JPEG mode "CMYK"). Under 0
// and 3 the data comes as PIL hands it over, in 65536-byte blocks; libtiff
// hands over all of it.
extern "C" int kt_jpeg_decode_as(const uint8_t* data, long long n,
                                 uint8_t* rgba, int w, int h, int color,
                                 char* msg, int cap) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)n;
    dec.color = color;
    dec.chunked = color == 0 || color == 3;
    dec.parse();
    if (dec.width != w || dec.height != h) corrupt("size changed");
    if (!dec.scanned) corrupt("JPEG frame without a scan");
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
// (the markers after the scan are not read). libtiff's old-style codec
// writes a baseline frame header of its own, so no lossless frame comes
// here.
extern "C" int kt_jpeg_planes(const uint8_t* data, long long n, uint8_t* out,
                              char* msg, int cap) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)n;
    dec.color = 2;
    dec.parse();
    if (dec.lossless) corrupt("raw data output of a lossless frame");
    for (int i = 0; i < dec.ncomp; i++)
      if (dec.comp[i].coef.empty()) corrupt("JPEG component without a scan");
    const bool smooth = dec.smoothing_ok();
    for (int i = 0; i < dec.ncomp; i++) {
      std::vector<uint8_t> s = dec.samples(dec.comp[i], smooth);
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
