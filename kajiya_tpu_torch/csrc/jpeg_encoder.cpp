// Baseline JFIF encoder for the live viewer's MJPEG stream
// (kajiya_tpu_torch/apps/stream.py): 8-bit RGB in, 4:2:0 YCbCr, the Annex K
// quantisation tables scaled as IJG quality 85 scales them, the Annex K
// Huffman tables, markers SOI APP0 DQT SOF0 DHT SOS EOI (and DRI and RSTn
// with a restart interval). The colour
// conversion, the 2x2 chroma box filter and the float AAN forward DCT with
// its quantiser follow libjpeg (jccolor.c, jcsample.c, jfdctflt.c,
// jcdctmgr.c), the library behind the JAX package's encoder. Blocks that
// straddle the image's edge repeat its last column and row; luma blocks of a
// 16x16 MCU wholly outside it are jccoefct.c's dummy blocks.
//
// kt_jpeg_encode_lossless writes a grey lossless (SOF3) JPEG: one
// predictor for the scan (H.1.2.1), no point transform, the Annex K
// luminance DC table for the differences.
//
// Built with g++ at first use (scene/jpeg.py) and called through ctypes,
// which releases the interpreter lock for the call.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1, natural order
const int kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code counts per length 1..16, then the symbols
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

// the most bytes one 8x8 block can take: 16 + 11 DC bits, 63 x (16 + 10)
// AC bits, each byte possibly stuffed
const long long kBlockBound = 2 * ((27 + 63 * 26) / 8 + 1);

struct Huffman {
  uint16_t code[256];
  uint8_t size[256];
};

void make_huffman(const uint8_t* bits, const uint8_t* vals, Huffman* h) {
  std::memset(h, 0, sizeof(*h));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      h->code[vals[k]] = static_cast<uint16_t>(code++);
      h->size[vals[k]] = static_cast<uint8_t>(len);
    }
    code <<= 1;
  }
}

class BitWriter {
 public:
  explicit BitWriter(uint8_t* out) : out_(out) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    n_ += size;
    while (n_ >= 8) {
      n_ -= 8;
      uint8_t byte = static_cast<uint8_t>(acc_ >> n_);
      out_[len_++] = byte;
      if (byte == 0xFF) out_[len_++] = 0;
    }
  }
  void flush() {               // pad the last byte with 1 bits
    if (n_ > 0) put(0x7F, 8 - n_);
  }
  void marker(int code) {      // after flush(): a marker, not stuffed
    out_[len_++] = 0xFF;
    out_[len_++] = static_cast<uint8_t>(code);
  }
  long long len() const { return len_; }

 private:
  uint8_t* out_;
  long long len_ = 0;
  uint64_t acc_ = 0;
  int n_ = 0;
};

int nbits(int v) {
  if (v < 0) v = -v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// jfdctflt.c: the AAN float forward DCT, in place, rows then columns
void fdct_float(float* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;     // element stride in a line
    const int next = pass == 0 ? 8 : 1;     // stride between lines
    for (int line = 0; line < 8; ++line) {
      float* p = d + line * next;
      float tmp0 = p[0 * step] + p[7 * step], tmp7 = p[0 * step] - p[7 * step];
      float tmp1 = p[1 * step] + p[6 * step], tmp6 = p[1 * step] - p[6 * step];
      float tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      float tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];

      float tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      float tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      p[0 * step] = tmp10 + tmp11;
      p[4 * step] = tmp10 - tmp11;
      float z1 = (tmp12 + tmp13) * 0.707106781f;
      p[2 * step] = tmp13 + z1;
      p[6 * step] = tmp13 - z1;

      tmp10 = tmp4 + tmp5;
      tmp11 = tmp5 + tmp6;
      tmp12 = tmp6 + tmp7;
      float z5 = (tmp10 - tmp12) * 0.382683433f;
      float z2 = 0.541196100f * tmp10 + z5;
      float z4 = 1.306562965f * tmp12 + z5;
      float z3 = tmp11 * 0.707106781f;
      float z11 = tmp7 + z3, z13 = tmp7 - z3;
      p[5 * step] = z13 + z2;
      p[3 * step] = z13 - z2;
      p[1 * step] = z11 + z4;
      p[7 * step] = z11 - z4;
    }
  }
}

struct Encoder {
  float divisor[2][64];        // natural order, AAN scale folded in
  uint8_t qtable[2][64];       // zigzag order, as DQT writes them
  Huffman dc[2], ac[2];

  Encoder() {
    // jcparam.c's jpeg_quality_scaling at quality 85 (PIL's setting in the
    // JAX package's viewer): 200 - 2 * 85 percent
    const int scale = 30;
    static const double aan[8] = {1.0, 1.387039845, 1.306562965, 1.175875602,
                                  1.0, 0.785694958, 0.541196100, 0.275899379};
    const int* base[2] = {kLumaQ, kChromaQ};
    for (int t = 0; t < 2; ++t) {
      for (int i = 0; i < 64; ++i) {
        long q = (static_cast<long>(base[t][i]) * scale + 50) / 100;
        if (q < 1) q = 1;
        if (q > 255) q = 255;
        divisor[t][i] = static_cast<float>(
            1.0 / (q * aan[i / 8] * aan[i % 8] * 8.0));
      }
      for (int k = 0; k < 64; ++k) {
        long q = (static_cast<long>(base[t][kZigzag[k]]) * scale + 50) / 100;
        qtable[t][k] = static_cast<uint8_t>(q < 1 ? 1 : (q > 255 ? 255 : q));
      }
    }
    make_huffman(kDcLumaBits, kDcVals, &dc[0]);
    make_huffman(kDcChromaBits, kDcVals, &dc[1]);
    make_huffman(kAcLumaBits, kAcLumaVals, &ac[0]);
    make_huffman(kAcChromaBits, kAcChromaVals, &ac[1]);
  }

  // level-shifted 8x8 samples -> entropy-coded block; `pred` is the
  // component's previous DC
  void block(float* d, int t, int* pred, BitWriter* w) const {
    fdct_float(d);
    int q[64];
    for (int i = 0; i < 64; ++i)     // jcdctmgr.c: round half up
      q[i] = static_cast<int>(d[i] * divisor[t][i] + 16384.5f) - 16384;
    int diff = q[0] - *pred;
    *pred = q[0];
    int n = nbits(diff);
    w->put(dc[t].code[n], dc[t].size[n]);
    if (n) w->put(diff < 0 ? diff - 1 : diff, n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = q[kZigzag[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        w->put(ac[t].code[0xF0], ac[t].size[0xF0]);
        run -= 16;
      }
      n = nbits(v);
      int sym = (run << 4) | n;
      w->put(ac[t].code[sym], ac[t].size[sym]);
      w->put(v < 0 ? v - 1 : v, n);
      run = 0;
    }
    if (run) w->put(ac[t].code[0], ac[t].size[0]);
  }

  // jccoefct.c's dummy block, an MCU's block that lies wholly outside the
  // image: its neighbour's DC (a difference of 0) and no AC
  void dummy(int t, BitWriter* w) const {
    w->put(dc[t].code[0], dc[t].size[0]);
    w->put(ac[t].code[0], ac[t].size[0]);
  }
};

void put16(std::vector<uint8_t>* h, int v) {
  h->push_back(static_cast<uint8_t>(v >> 8));
  h->push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>* h, int cls_id, const uint8_t* bits,
             const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  h->push_back(0xFF);
  h->push_back(0xC4);
  put16(h, 2 + 1 + 16 + n);
  h->push_back(static_cast<uint8_t>(cls_id));
  h->insert(h->end(), bits, bits + 16);
  h->insert(h->end(), vals, vals + n);
}

std::vector<uint8_t> headers(const Encoder& e, int width, int height,
                             int restart) {
  std::vector<uint8_t> h = {0xFF, 0xD8,                     // SOI
                            0xFF, 0xE0, 0x00, 0x10,         // APP0 JFIF 1.1
                            'J',  'F',  'I',  'F',  0x00, 0x01, 0x01,
                            0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (int t = 0; t < 2; ++t) {                             // DQT
    h.insert(h.end(), {0xFF, 0xDB, 0x00, 0x43, static_cast<uint8_t>(t)});
    h.insert(h.end(), e.qtable[t], e.qtable[t] + 64);
  }
  h.insert(h.end(), {0xFF, 0xC0, 0x00, 0x11, 0x08});       // SOF0
  put16(&h, height);
  put16(&h, width);
  h.insert(h.end(), {0x03, 0x01, 0x22, 0x00, 0x02, 0x11, 0x01, 0x03, 0x11,
                     0x01});
  put_dht(&h, 0x00, kDcLumaBits, kDcVals);
  put_dht(&h, 0x10, kAcLumaBits, kAcLumaVals);
  put_dht(&h, 0x01, kDcChromaBits, kDcVals);
  put_dht(&h, 0x11, kAcChromaBits, kAcChromaVals);
  if (restart) {                                            // DRI
    h.insert(h.end(), {0xFF, 0xDD, 0x00, 0x04});
    put16(&h, restart);
  }
  h.insert(h.end(), {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02, 0x11,
                     0x03, 0x11, 0x00, 0x3F, 0x00});        // SOS
  return h;
}

}  // namespace

extern "C" {

// The most bytes kt_jpeg_encode can write for a width x height image.
long long kt_jpeg_bound(int width, int height) {
  const long long mw = (width + 15) / 16, mh = (height + 15) / 16;
  return 1024 + mw * mh * (6 * kBlockBound + 3);
}

// Encode `rgb` (height packed rows of width x 3 bytes) into `out` (`cap`
// bytes), with a restart marker every `restart` MCUs (0: none). Returns the
// JFIF's length, -1 for a bad size or interval, -2 when `cap` is below
// kt_jpeg_bound.
long long kt_jpeg_encode_rst(const uint8_t* rgb, int width, int height,
                             int restart, uint8_t* out, long long cap) {
  if (width < 1 || height < 1 || width > 65535 || height > 65535 ||
      restart < 0 || restart > 65535)
    return -1;
  if (cap < kt_jpeg_bound(width, height)) return -2;
  static const Encoder e;
  const std::vector<uint8_t> hdr = headers(e, width, height, restart);
  std::memcpy(out, hdr.data(), hdr.size());
  BitWriter w(out + hdr.size());

  // jccolor.c's fixed point: 16 fraction bits, rounded
  const int kScale = 16;
  const int32_t kHalf = 1 << (kScale - 1), kOff = 128 << kScale;
  auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
  const int32_t yr = fix(0.29900), yg = fix(0.58700), yb = fix(0.11400);
  const int32_t cbr = fix(0.16874), cbg = fix(0.33126), half = fix(0.5);
  const int32_t crg = fix(0.41869), crb = fix(0.08131);

  const int mcus_x = (width + 15) / 16, mcus_y = (height + 15) / 16;
  const int luma_bx = (width + 7) / 8, luma_by = (height + 7) / 8;
  // one MCU row of 16 converted rows, padded to whole MCUs
  const int pw = mcus_x * 16;
  std::vector<uint8_t> ybuf(16 * pw), cb(16 * pw), cr(16 * pw);
  int pred[3] = {0, 0, 0};
  float blk[64];
  int todo = restart, rst = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int r = 0; r < 16; ++r) {
      int sy = my * 16 + r;
      if (sy >= height) sy = height - 1;
      const uint8_t* row = rgb + 3LL * sy * width;
      for (int x = 0; x < pw; ++x) {
        const uint8_t* p = row + 3 * (x < width ? x : width - 1);
        const int32_t R = p[0], G = p[1], B = p[2];
        ybuf[r * pw + x] = static_cast<uint8_t>(
            (yr * R + yg * G + yb * B + kHalf) >> kScale);
        cb[r * pw + x] = static_cast<uint8_t>(
            (-cbr * R - cbg * G + half * B + kOff + kHalf - 1) >> kScale);
        cr[r * pw + x] = static_cast<uint8_t>(
            (half * R - crg * G - crb * B + kOff + kHalf - 1) >> kScale);
      }
    }
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (restart && todo == 0) {  // RSTn: the bits padded, DC reset
        w.flush();
        w.marker(0xD0 + rst);
        rst = (rst + 1) & 7;
        pred[0] = pred[1] = pred[2] = 0;
        todo = restart;
      }
      --todo;
      for (int by = 0; by < 2; ++by) {
        for (int bx = 0; bx < 2; ++bx) {
          if (mx * 2 + bx >= luma_bx || my * 2 + by >= luma_by) {
            e.dummy(0, &w);
            continue;
          }
          for (int i = 0; i < 8; ++i)
            for (int j = 0; j < 8; ++j)
              blk[i * 8 + j] = static_cast<float>(
                  ybuf[(by * 8 + i) * pw + mx * 16 + bx * 8 + j]) - 128.0f;
          e.block(blk, 0, &pred[0], &w);
        }
      }
      const std::vector<uint8_t>* planes[2] = {&cb, &cr};
      for (int c = 0; c < 2; ++c) {
        const uint8_t* s = planes[c]->data();
        for (int i = 0; i < 8; ++i) {
          for (int j = 0; j < 8; ++j) {
            // jcsample.c h2v2: 2x2 box with a bias of 1, 2, 1, 2, ...
            const int x = mx * 16 + 2 * j, y = 2 * i;
            const int sum = s[y * pw + x] + s[y * pw + x + 1] +
                            s[(y + 1) * pw + x] + s[(y + 1) * pw + x + 1];
            blk[i * 8 + j] = static_cast<float>(
                (sum + 1 + (j & 1)) >> 2) - 128.0f;
          }
        }
        e.block(blk, 1, &pred[1 + c], &w);
      }
    }
  }
  w.flush();
  long long n = static_cast<long long>(hdr.size()) + w.len();
  out[n++] = 0xFF;                                          // EOI
  out[n++] = 0xD9;
  return n;
}

long long kt_jpeg_encode(const uint8_t* rgb, int width, int height,
                         uint8_t* out, long long cap) {
  return kt_jpeg_encode_rst(rgb, width, height, 0, out, cap);
}

// The most bytes kt_jpeg_encode_lossless can write.
long long kt_jpeg_lossless_bound(int width, int height) {
  return 1024 + 4LL * width * height;
}

// Encode `grey` (height rows of width bytes) as a lossless JPEG with
// predictor `psv` (1-7) into `out` (`cap` bytes). Returns the length, -1
// for a bad size or predictor, -2 when `cap` is below
// kt_jpeg_lossless_bound.
long long kt_jpeg_encode_lossless(const uint8_t* grey, int width, int height,
                                  int psv, uint8_t* out, long long cap) {
  if (width < 1 || height < 1 || width > 65535 || height > 65535 || psv < 1 ||
      psv > 7)
    return -1;
  if (cap < kt_jpeg_lossless_bound(width, height)) return -2;
  std::vector<uint8_t> h = {0xFF, 0xD8, 0xFF, 0xC3, 0x00, 0x0B, 0x08};
  put16(&h, height);
  put16(&h, width);
  h.insert(h.end(), {0x01, 0x01, 0x11, 0x00});              // SOF3
  put_dht(&h, 0x00, kDcLumaBits, kDcVals);
  h.insert(h.end(), {0xFF, 0xDA, 0x00, 0x08, 0x01, 0x01, 0x00,
                     static_cast<uint8_t>(psv), 0x00, 0x00});  // SOS
  std::memcpy(out, h.data(), h.size());
  BitWriter w(out + h.size());
  Huffman dc;
  make_huffman(kDcLumaBits, kDcVals, &dc);
  for (int y = 0; y < height; ++y) {
    const uint8_t* row = grey + static_cast<long long>(y) * width;
    const uint8_t* up = row - width;
    for (int x = 0; x < width; ++x) {
      int p;
      if (y == 0) {
        p = x == 0 ? 128 : row[x - 1];   // the first row: 2^(P-1), then Ra
      } else if (x == 0) {
        p = up[0];                       // the first column: Rb
      } else {
        const int a = row[x - 1], b = up[x], c = up[x - 1];
        switch (psv) {
          case 1: p = a; break;
          case 2: p = b; break;
          case 3: p = c; break;
          case 4: p = a + b - c; break;
          case 5: p = a + ((b - c) >> 1); break;
          case 6: p = b + ((a - c) >> 1); break;
          default: p = (a + b) >> 1; break;
        }
      }
      const int diff = row[x] - p;
      const int n = nbits(diff);
      w.put(dc.code[n], dc.size[n]);
      if (n) w.put(diff < 0 ? diff - 1 : diff, n);
    }
  }
  w.flush();
  long long n = static_cast<long long>(h.size()) + w.len();
  out[n++] = 0xFF;                                          // EOI
  out[n++] = 0xD9;
  return n;
}

}  // extern "C"
