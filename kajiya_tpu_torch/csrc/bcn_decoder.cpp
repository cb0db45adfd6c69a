// BC1-BC7 block decoder for DDS texture sources (kajiya_tpu_torch/scene/
// dds.py): the RGBA bytes that PIL's "bcn" decoder (DdsImagePlugin) and
// `convert("RGBA")` give, which the JAX package's bake uses.
//
// - BC1 (DXT1): 5:6:5 endpoints widened by bit replication, thirds by
//   integer division; c0 <= c1 selects the half point and a transparent
//   black fourth colour.
// - BC2 (DXT3): BC1 colour always in four-colour mode, 4-bit alpha
//   replicated to 8 bits. BC3 (DXT5): the same colour, BC4-style alpha.
// - BC4: one 8-endpoint channel (sevenths, or fifths with 0 and 255) read
//   as grey. BC5: two such channels as red and green, blue 0; the signed
//   variant offsets each endpoint by 128 before the same interpolation.
// - BC6H: the fourteen modes of the format, endpoints unquantized to 16
//   bits, interpolated, scaled by 31/64 (31/32 signed) into half floats and
//   written as 8 bits: 0 below 0.0, 255 above 1.0, else truncated x * 255.
//   The four reserved modes decode to black.
// - BC7: the eight modes with partitions, rotation, index selection and
//   p-bits; a block whose first byte is 0 (no mode) decodes to transparent
//   black.
//
// Blocks are read in rows of ceil(w / 4); pixels beyond the image are
// dropped. Built with g++ at first use (scene/dds.py), called through ctypes.
#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

// BC7 / BC6H partition tables: subset of each pixel, 64 partitions
const uint8_t kPart2[64][16] = {
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1}, {0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1},
    {0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1}, {0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1}, {0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1}, {0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1}, {0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1}, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1},
    {0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}, {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1},
    {0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1}, {0, 1, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0}, {0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0},
    {0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0}, {0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0}, {0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1},
    {0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0}, {0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0},
    {0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0}, {0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 0},
    {0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0}, {0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0},
    {0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0}, {0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0},
    {0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1}, {0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1},
    {0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0}, {0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0},
    {0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0}, {0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0},
    {0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1}, {0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 1},
    {0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 0}, {0, 0, 0, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0},
    {0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0}, {0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 0},
    {0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0}, {0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1},
    {0, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1}, {0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0},
    {0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0}, {0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0}, {0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0},
    {0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1}, {0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1},
    {0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0}, {0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0},
    {0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1}, {0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1},
    {0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1}, {0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1},
    {0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1}, {0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0},
    {0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0}, {0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1}};

const uint8_t kPart3[64][16] = {
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 1, 2, 2, 2, 2}, {0, 0, 0, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 2, 1},
    {0, 0, 0, 0, 2, 0, 0, 1, 2, 2, 1, 1, 2, 2, 1, 1}, {0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 1, 0, 1, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2}, {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 2, 2},
    {0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1}, {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1},
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2}, {0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2},
    {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2}, {0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2},
    {0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2}, {0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2},
    {0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2, 1, 2, 2, 2}, {0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0, 2, 2, 2, 0},
    {0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2}, {0, 1, 1, 1, 0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0},
    {0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2}, {0, 0, 2, 2, 0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1},
    {0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2, 0, 2, 2, 2}, {0, 0, 0, 1, 0, 0, 0, 1, 2, 2, 2, 1, 2, 2, 2, 1},
    {0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2}, {0, 0, 0, 0, 1, 1, 0, 0, 2, 2, 1, 0, 2, 2, 1, 0},
    {0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1, 0, 0, 0, 0}, {0, 0, 1, 2, 0, 0, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2},
    {0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1, 0, 1, 1, 0}, {0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1},
    {0, 0, 2, 2, 1, 1, 0, 2, 1, 1, 0, 2, 0, 0, 2, 2}, {0, 1, 1, 0, 0, 1, 1, 0, 2, 0, 0, 2, 2, 2, 2, 2},
    {0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1}, {0, 0, 0, 0, 2, 0, 0, 0, 2, 2, 1, 1, 2, 2, 2, 1},
    {0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 2, 2, 2}, {0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 2, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 2, 0, 2, 2, 2}, {0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0},
    {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0}, {0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0},
    {0, 1, 2, 0, 2, 0, 1, 2, 1, 2, 0, 1, 0, 1, 2, 0}, {0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2, 2, 0, 0, 1, 1},
    {0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0, 1, 1}, {0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2},
    {0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1}, {0, 0, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2, 1, 1, 2, 2},
    {0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 1, 1}, {0, 2, 2, 0, 1, 2, 2, 1, 0, 2, 2, 0, 1, 2, 2, 1},
    {0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 0, 1, 0, 1}, {0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1},
    {0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2}, {0, 2, 2, 2, 0, 1, 1, 1, 0, 2, 2, 2, 0, 1, 1, 1},
    {0, 0, 0, 2, 1, 1, 1, 2, 0, 0, 0, 2, 1, 1, 1, 2}, {0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2},
    {0, 2, 2, 2, 0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2}, {0, 0, 0, 2, 1, 1, 1, 2, 1, 1, 1, 2, 0, 0, 0, 2},
    {0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2}, {0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2},
    {0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2, 2, 2, 2, 2}, {0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2},
    {0, 0, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2}, {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2},
    {0, 0, 0, 2, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 1}, {0, 2, 2, 2, 1, 2, 2, 2, 0, 2, 2, 2, 1, 2, 2, 2},
    {0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2}, {0, 1, 1, 1, 2, 0, 1, 1, 2, 2, 0, 1, 2, 2, 2, 0}};

// anchor (fix-up) pixel of subset 1 in two-subset partitions, and of
// subsets 1 and 2 in three-subset partitions
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const uint8_t kW2[4] = {0, 21, 43, 64};
const uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kW2 : (bits == 3 ? kW3 : kW4);
}

// bits [pos, pos + n) of a 16-byte block, least significant first
inline int get_bits(const uint8_t* src, int pos, int n) {
  int v = 0;
  for (int i = 0; i < n; i++) {
    int b = pos + i;
    v |= ((src[b >> 3] >> (b & 7)) & 1) << i;
  }
  return v;
}

Rgba decode_565(uint16_t x) {
  Rgba c;
  int r = (x & 0xF800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7E0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1F) << 3;
  b |= b >> 5;
  c.r = (uint8_t)r;
  c.g = (uint8_t)g;
  c.b = (uint8_t)b;
  c.a = 255;
  return c;
}

void bc1_color(Rgba* dst, const uint8_t* src, bool four_colour) {
  uint16_t c0 = (uint16_t)(src[0] | (src[1] << 8));
  uint16_t c1 = (uint16_t)(src[2] | (src[3] << 8));
  uint32_t lut = (uint32_t)src[4] | ((uint32_t)src[5] << 8) |
                 ((uint32_t)src[6] << 16) | ((uint32_t)src[7] << 24);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four_colour) {
    p[2] = Rgba{(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3),
                (uint8_t)((2 * b0 + b1) / 3), 255};
    p[3] = Rgba{(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3),
                (uint8_t)((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = Rgba{(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2),
                (uint8_t)((b0 + b1) / 2), 255};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) dst[n] = p[3 & (lut >> (2 * n))];
}

// BC3 alpha / BC4 / BC5 channel: 8 bytes into channel `o` of dst
void bc3_alpha(Rgba* dst, const uint8_t* src, int o, bool sign) {
  int a0, a1;
  if (sign) {
    a0 = (int8_t)src[0] + 128;
    a1 = (int8_t)src[1] + 128;
  } else {
    a0 = src[0];
    a1 = src[1];
  }
  uint8_t a[8];
  a[0] = (uint8_t)a0;
  a[1] = (uint8_t)a1;
  if (a0 > a1) {
    for (int i = 1; i < 7; i++) a[i + 1] = (uint8_t)(((7 - i) * a0 + i * a1) / 7);
  } else {
    for (int i = 1; i < 5; i++) a[i + 1] = (uint8_t)(((5 - i) * a0 + i * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  uint32_t lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  uint32_t lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  for (int n = 0; n < 16; n++) {
    uint32_t lut = n < 8 ? lut1 : lut2;
    uint8_t v = a[7 & (lut >> (3 * (n & 7)))];
    uint8_t* px = &dst[n].r;
    px[o] = v;
  }
}

void bc2_block(Rgba* col, const uint8_t* src) {
  bc1_color(col, src + 8, true);
  for (int n = 0; n < 16; n++) {
    int bit = n * 4;
    int av = 0xF & (src[bit >> 3] >> (bit & 7));
    col[n].a = (uint8_t)((av << 4) | av);
  }
}

// ---------------------------------------------------------------------------
// BC7
// ---------------------------------------------------------------------------

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

inline int subset_of(int ns, int partition, int i) {
  if (ns == 2) return kPart2[partition][i];
  if (ns == 3) return kPart3[partition][i];
  return 0;
}

inline uint8_t expand(int v, int bits) {
  uint8_t x = (uint8_t)(v << (8 - bits));
  return (uint8_t)(x | (x >> bits));
}

void bc7_block(Rgba* col, const uint8_t* src) {
  int first = src[0];
  if (!first) {
    for (int i = 0; i < 16; i++) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(first & (1 << mode))) mode++;
  const Bc7Mode& m = kBc7[mode];
  int bit = mode + 1;
  auto load = [&](int n) {
    int v = get_bits(src, bit, n);
    bit += n;
    return v;
  };
  int partition = load(m.pb);
  int rotation = load(m.rb);
  int index_sel = load(m.isb);
  int numep = m.ns * 2;
  int e[6][4];
  for (int c = 0; c < 3; c++)
    for (int i = 0; i < numep; i++) e[i][c] = load(m.cb);
  for (int i = 0; i < numep; i++) e[i][3] = m.ab ? load(m.ab) : 255;
  int cb = m.cb, ab = m.ab;
  if (m.epb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i++) {
      int p = load(1);
      for (int c = 0; c < 3; c++) e[i][c] = (e[i][c] << 1) | p;
      if (m.ab) e[i][3] = (e[i][3] << 1) | p;
    }
  }
  if (m.spb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i += 2) {
      int p = load(1);
      for (int j = 0; j < 2; j++) {
        for (int c = 0; c < 3; c++) e[i + j][c] = (e[i + j][c] << 1) | p;
        if (m.ab) e[i + j][3] = (e[i + j][3] << 1) | p;
      }
    }
  }
  Rgba ep[6];
  for (int i = 0; i < numep; i++) {
    ep[i].r = expand(e[i][0], cb);
    ep[i].g = expand(e[i][1], cb);
    ep[i].b = expand(e[i][2], cb);
    ep[i].a = ab ? expand(e[i][3], ab) : (uint8_t)e[i][3];
  }
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights((m.ab && m.ib2) ? m.ib2 : m.ib);
  int cibit = bit;
  int aibit = cibit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; i++) {
    int s = subset_of(m.ns, partition, i) << 1;
    int ib = m.ib;
    if (i == 0) {
      ib--;
    } else if (m.ns == 2) {
      if (i == kAnchor2[partition]) ib--;
    } else if (m.ns == 3) {
      if (i == kAnchor3a[partition] || i == kAnchor3b[partition]) ib--;
    }
    int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    int wc, wa;
    if (m.ab && m.ib2) {
      int ib2 = m.ib2 - (i == 0 ? 1 : 0);
      int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) {
        wc = aw[i1];
        wa = cw[i0];
      } else {
        wc = cw[i0];
        wa = aw[i1];
      }
    } else {
      wc = wa = cw[i0];
    }
    const Rgba& a = ep[s];
    const Rgba& b = ep[s + 1];
    Rgba o;
    o.r = (uint8_t)(((64 - wc) * a.r + wc * b.r + 32) >> 6);
    o.g = (uint8_t)(((64 - wc) * a.g + wc * b.g + 32) >> 6);
    o.b = (uint8_t)(((64 - wc) * a.b + wc * b.b + 32) >> 6);
    o.a = (uint8_t)(((64 - wa) * a.a + wa * b.a + 32) >> 6);
    uint8_t t;
    if (rotation == 1) {
      t = o.r; o.r = o.a; o.a = t;
    } else if (rotation == 2) {
      t = o.g; o.g = o.a; o.a = t;
    } else if (rotation == 3) {
      t = o.b; o.b = o.a; o.a = t;
    }
    col[i] = o;
  }
}

// ---------------------------------------------------------------------------
// BC6H
// ---------------------------------------------------------------------------

struct Bc6Mode {
  int ns, tr, epb, rb, gb, bb;
};

// A run of header bits for endpoint `what` (endpoint * 3 + channel: w x y z,
// r g b) or the partition index (PD): bits hi..lo, stored low bit first;
// hi < lo marks the runs the format stores in reverse ([10:11], [10:15]).
struct Run {
  int8_t what, hi, lo;
};

// a mode's header runs, after its mode bits, up to the first index bit
struct Bc6Desc {
  int mode_bits, mode;
  Bc6Mode info;
  Run runs[24];
};

// endpoint-channel codes
enum { RW = 0, GW = 1, BW = 2, RX = 3, GX = 4, BX = 5,
       RY = 6, GY = 7, BY = 8, RZ = 9, GZ = 10, BZ = 11, PD = 12 };

const Bc6Desc kBc6[14] = {
    {2, 0x00, {2, 1, 10, 5, 5, 5},
     {{GY, 4, 4}, {BY, 4, 4}, {BZ, 4, 4}, {RW, 9, 0}, {GW, 9, 0}, {BW, 9, 0},
      {RX, 4, 0}, {GZ, 4, 4}, {GY, 3, 0}, {GX, 4, 0}, {BZ, 0, 0}, {GZ, 3, 0},
      {BX, 4, 0}, {BZ, 1, 1}, {BY, 3, 0}, {RY, 4, 0}, {BZ, 2, 2}, {RZ, 4, 0},
      {BZ, 3, 3}, {PD, 4, 0}}},
    {2, 0x01, {2, 1, 7, 6, 6, 6},
     {{GY, 5, 5}, {GZ, 4, 4}, {GZ, 5, 5}, {RW, 6, 0}, {BZ, 0, 0}, {BZ, 1, 1},
      {BY, 4, 4}, {GW, 6, 0}, {BY, 5, 5}, {BZ, 2, 2}, {GY, 4, 4}, {BW, 6, 0},
      {BZ, 3, 3}, {BZ, 5, 5}, {BZ, 4, 4}, {RX, 5, 0}, {GY, 3, 0}, {GX, 5, 0},
      {GZ, 3, 0}, {BX, 5, 0}, {BY, 3, 0}, {RY, 5, 0}, {RZ, 5, 0}, {PD, 4, 0}}},
    {5, 0x02, {2, 1, 11, 5, 4, 4},
     {{RW, 9, 0}, {GW, 9, 0}, {BW, 9, 0}, {RX, 4, 0}, {RW, 10, 10},
      {GY, 3, 0}, {GX, 3, 0}, {GW, 10, 10}, {BZ, 0, 0}, {GZ, 3, 0},
      {BX, 3, 0}, {BW, 10, 10}, {BZ, 1, 1}, {BY, 3, 0}, {RY, 4, 0},
      {BZ, 2, 2}, {RZ, 4, 0}, {BZ, 3, 3}, {PD, 4, 0}}},
    {5, 0x06, {2, 1, 11, 4, 5, 4},
     {{RW, 9, 0}, {GW, 9, 0}, {BW, 9, 0}, {RX, 3, 0}, {RW, 10, 10},
      {GZ, 4, 4}, {GY, 3, 0}, {GX, 4, 0}, {GW, 10, 10}, {GZ, 3, 0},
      {BX, 3, 0}, {BW, 10, 10}, {BZ, 1, 1}, {BY, 3, 0}, {RY, 3, 0},
      {BZ, 0, 0}, {BZ, 2, 2}, {RZ, 3, 0}, {GY, 4, 4}, {BZ, 3, 3}, {PD, 4, 0}}},
    {5, 0x0A, {2, 1, 11, 4, 4, 5},
     {{RW, 9, 0}, {GW, 9, 0}, {BW, 9, 0}, {RX, 3, 0}, {RW, 10, 10},
      {BY, 4, 4}, {GY, 3, 0}, {GX, 3, 0}, {GW, 10, 10}, {BZ, 0, 0},
      {GZ, 3, 0}, {BX, 4, 0}, {BW, 10, 10}, {BY, 3, 0}, {RY, 3, 0},
      {BZ, 1, 1}, {BZ, 2, 2}, {RZ, 3, 0}, {BZ, 4, 4}, {BZ, 3, 3}, {PD, 4, 0}}},
    {5, 0x0E, {2, 1, 9, 5, 5, 5},
     {{RW, 8, 0}, {BY, 4, 4}, {GW, 8, 0}, {GY, 4, 4}, {BW, 8, 0},
      {BZ, 4, 4}, {RX, 4, 0}, {GZ, 4, 4}, {GY, 3, 0}, {GX, 4, 0},
      {BZ, 0, 0}, {GZ, 3, 0}, {BX, 4, 0}, {BZ, 1, 1}, {BY, 3, 0},
      {RY, 4, 0}, {BZ, 2, 2}, {RZ, 4, 0}, {BZ, 3, 3}, {PD, 4, 0}}},
    {5, 0x12, {2, 1, 8, 6, 5, 5},
     {{RW, 7, 0}, {GZ, 4, 4}, {BY, 4, 4}, {GW, 7, 0}, {BZ, 2, 2},
      {GY, 4, 4}, {BW, 7, 0}, {BZ, 3, 3}, {BZ, 4, 4}, {RX, 5, 0},
      {GY, 3, 0}, {GX, 4, 0}, {BZ, 0, 0}, {GZ, 3, 0}, {BX, 4, 0},
      {BZ, 1, 1}, {BY, 3, 0}, {RY, 5, 0}, {RZ, 5, 0}, {PD, 4, 0}}},
    {5, 0x16, {2, 1, 8, 5, 6, 5},
     {{RW, 7, 0}, {BZ, 0, 0}, {BY, 4, 4}, {GW, 7, 0}, {GY, 5, 5},
      {GY, 4, 4}, {BW, 7, 0}, {GZ, 5, 5}, {BZ, 4, 4}, {RX, 4, 0},
      {GZ, 4, 4}, {GY, 3, 0}, {GX, 5, 0}, {GZ, 3, 0}, {BX, 4, 0},
      {BZ, 1, 1}, {BY, 3, 0}, {RY, 4, 0}, {BZ, 2, 2}, {RZ, 4, 0},
      {BZ, 3, 3}, {PD, 4, 0}}},
    {5, 0x1A, {2, 1, 8, 5, 5, 6},
     {{RW, 7, 0}, {BZ, 1, 1}, {BY, 4, 4}, {GW, 7, 0}, {BY, 5, 5},
      {GY, 4, 4}, {BW, 7, 0}, {BZ, 5, 5}, {BZ, 4, 4}, {RX, 4, 0},
      {GZ, 4, 4}, {GY, 3, 0}, {GX, 4, 0}, {BZ, 0, 0}, {GZ, 3, 0},
      {BX, 5, 0}, {BY, 3, 0}, {RY, 4, 0}, {BZ, 2, 2}, {RZ, 4, 0},
      {BZ, 3, 3}, {PD, 4, 0}}},
    {5, 0x1E, {2, 0, 6, 6, 6, 6},
     {{RW, 5, 0}, {GZ, 4, 4}, {BZ, 0, 0}, {BZ, 1, 1}, {BY, 4, 4},
      {GW, 5, 0}, {GY, 5, 5}, {BY, 5, 5}, {BZ, 2, 2}, {GY, 4, 4},
      {BW, 5, 0}, {GZ, 5, 5}, {BZ, 3, 3}, {BZ, 5, 5}, {BZ, 4, 4},
      {RX, 5, 0}, {GY, 3, 0}, {GX, 5, 0}, {GZ, 3, 0}, {BX, 5, 0},
      {BY, 3, 0}, {RY, 5, 0}, {RZ, 5, 0}, {PD, 4, 0}}},
    {5, 0x03, {1, 0, 10, 10, 10, 10},
     {{RW, 9, 0}, {GW, 9, 0}, {BW, 9, 0}, {RX, 9, 0}, {GX, 9, 0},
      {BX, 9, 0}}},
    {5, 0x07, {1, 1, 11, 9, 9, 9},
     {{RW, 9, 0}, {GW, 9, 0}, {BW, 9, 0}, {RX, 8, 0}, {RW, 10, 10},
      {GX, 8, 0}, {GW, 10, 10}, {BX, 8, 0}, {BW, 10, 10}}},
    {5, 0x0B, {1, 1, 12, 8, 8, 8},
     {{RW, 9, 0}, {GW, 9, 0}, {BW, 9, 0}, {RX, 7, 0}, {RW, 10, 11},
      {GX, 7, 0}, {GW, 10, 11}, {BX, 7, 0}, {BW, 10, 11}}},
    {5, 0x0F, {1, 1, 16, 4, 4, 4},
     {{RW, 9, 0}, {GW, 9, 0}, {BW, 9, 0}, {RX, 3, 0}, {RW, 10, 15},
      {GX, 3, 0}, {GW, 10, 15}, {BX, 3, 0}, {BW, 10, 15}}}};

inline int sign_extend(int v, int bits) {
  return (v & (1 << (bits - 1))) ? v - (1 << bits) : v;
}

int bc6_unquantize(int v, int prec, bool sign) {
  if (!sign) {
    if (prec >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << prec) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (prec - 1);
  }
  if (prec >= 16) return v;
  bool s = false;
  if (v < 0) {
    s = true;
    v = -v;
  }
  if (v != 0) {
    if (v >= (1 << (prec - 1)) - 1)
      v = 0x7FFF;
    else
      v = ((v << 15) + 0x4000) >> (prec - 1);
  }
  return s ? -v : v;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000u;
  o.u = (uint32_t)(h & 0x7FFF) << 13;
  o.f *= m.f;
  m.u = 0x47800000u;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= (uint32_t)(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) {
      v = ((-v) * 31) / 32;
      return half_to_float((uint16_t)(0x8000 | v));
    }
    return half_to_float((uint16_t)((v * 31) / 32));
  }
  return half_to_float((uint16_t)((v * 31) / 64));
}

uint8_t bc6_clamp(float x) {
  if (x < 0.0f) return 0;
  if (x > 1.0f) return 255;
  return (uint8_t)(x * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int low2 = src[0] & 3;
  int mode = low2 < 2 ? low2 : (src[0] & 31);
  const Bc6Desc* desc = nullptr;
  for (const Bc6Desc& d : kBc6)
    if (d.mode == mode && (d.mode_bits == 2) == (low2 < 2)) desc = &d;
  if (!desc) {
    for (int i = 0; i < 16; i++) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  const int header_end = desc->info.ns == 2 ? 82 : 65;
  int bit = desc->mode_bits;
  int ep[12] = {0};
  int partition = 0;
  for (int r = 0; bit < header_end; r++) {
    const Run& run = desc->runs[r];
    bool fwd = run.hi >= run.lo;
    int count = (fwd ? run.hi - run.lo : run.lo - run.hi) + 1;
    for (int k = 0; k < count; k++) {
      int b = fwd ? run.lo + k : run.lo - k;
      int v = (src[bit >> 3] >> (bit & 7)) & 1;
      bit++;
      if (run.what == PD)
        partition |= v << b;
      else
        ep[run.what] |= v << b;
    }
  }
  const Bc6Mode& m = desc->info;
  int numep = m.ns * 2;
  int mask = (1 << m.epb) - 1;
  int dbits[3] = {m.rb, m.gb, m.bb};
  if (sign) {
    for (int c = 0; c < 3; c++) ep[c] = sign_extend(ep[c], m.epb);
  }
  for (int i = 1; i < numep; i++) {
    for (int c = 0; c < 3; c++) {
      int& v = ep[i * 3 + c];
      if (m.tr) {
        // PIL keeps the masked sum unsigned; its 16-bit store reads back
        // negative in the signed format only at 16 endpoint bits
        v = (ep[c] + sign_extend(v, dbits[c])) & mask;
        if (sign) v = (int16_t)v;
      } else if (sign) {
        v = sign_extend(v, m.epb);
      }
    }
  }
  int uq[12];
  for (int i = 0; i < numep * 3; i++) uq[i] = bc6_unquantize(ep[i], m.epb, sign);
  int ib = m.ns == 2 ? 3 : 4;
  const uint8_t* w = weights(ib);
  int ibit = m.ns == 2 ? 82 : 65;
  for (int i = 0; i < 16; i++) {
    int s = m.ns == 2 ? kPart2[partition][i] : 0;
    int nb = ib;
    if (i == 0 || (m.ns == 2 && i == kAnchor2[partition])) nb--;
    int idx = get_bits(src, ibit, nb);
    ibit += nb;
    int wt = w[idx];
    const int* e0 = uq + s * 6;
    const int* e1 = e0 + 3;
    uint8_t out[3];
    for (int c = 0; c < 3; c++) {
      int v = (e0[c] * (64 - wt) + e1[c] * wt) >> 6;
      out[c] = bc6_clamp(bc6_finalize(v, sign));
    }
    col[i] = Rgba{out[0], out[1], out[2], 255};
  }
}

}  // namespace

// Decode the top-level image of w x h pixels from `nbytes` of block data.
// fmt 1-7 is BCn, `sign` the signed BC5 / BC6H variant. Writes w * h RGBA
// pixels as PIL's convert("RGBA") gives them (BC4 grey, BC5 / BC6H opaque).
// Returns 0, or 1 when the data holds fewer blocks than the image needs.
extern "C" int kt_bcn_decode(const uint8_t* src, long long nbytes, int fmt,
                             int sign, int w, int h, uint8_t* rgba) {
  const int bsize = (fmt == 1 || fmt == 4) ? 8 : 16;
  const long long bx = (w + 3) / 4, by = (h + 3) / 4;
  if (nbytes < bx * by * bsize) return 1;
  Rgba col[16];
  for (long long j = 0; j < by; j++) {
    for (long long i = 0; i < bx; i++) {
      const uint8_t* blk = src + (j * bx + i) * bsize;
      std::memset(col, 0, sizeof col);
      switch (fmt) {
        case 1: bc1_color(col, blk, false); break;
        case 2: bc2_block(col, blk); break;
        case 3:
          bc1_color(col, blk + 8, true);
          bc3_alpha(col, blk, 3, false);
          break;
        case 4: bc3_alpha(col, blk, 0, false); break;
        case 5:
          bc3_alpha(col, blk, 0, sign != 0);
          bc3_alpha(col, blk + 8, 1, sign != 0);
          break;
        case 6: bc6_block(col, blk, sign != 0); break;
        case 7: bc7_block(col, blk); break;
        default: return 1;
      }
      for (int y = 0; y < 4; y++) {
        long long py = j * 4 + y;
        if (py >= h) break;
        for (int x = 0; x < 4; x++) {
          long long px = i * 4 + x;
          if (px >= w) break;
          Rgba c = col[y * 4 + x];
          if (fmt == 4) {
            c.g = c.b = c.r;
            c.a = 255;
          } else if (fmt == 5 || fmt == 6) {
            if (fmt == 5) c.b = sign ? 128 : 0;
            c.a = 255;
          }
          std::memcpy(rgba + 4 * (py * w + px), &c, 4);
        }
      }
    }
  }
  return 0;
}
