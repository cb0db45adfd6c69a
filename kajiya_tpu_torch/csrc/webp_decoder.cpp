// WebP texture decoding (scene/webp.py): the VP8L lossless image stream
// (RFC 9649), the VP8 lossy key frame (RFC 6386) and the ALPH alpha chunk,
// each giving what libwebp 1.6.0 gives PIL 12.1.0 (`_webp.WebPAnimDecoder`,
// MODE_RGBA, fancy upsampling, no dithering), byte for byte. Python walks
// the RIFF container; these functions decode one frame's chunks. Built with
// g++ at first use (hostlib.load) and called through ctypes.
//
// VP8 is decoded as libwebp decodes it: intra prediction from the
// unfiltered reconstruction, the loop filter over the whole frame in
// macroblock order afterwards, libwebp's TransformOne / TransformWHT
// roundings (the full inverse transform in the 16-bit lanes of its x86
// build, which wrap where a corrupt stream's coefficients leave the range),
// its fixed-point YUV -> RGB (src/dsp/yuv.h) and its "fancy" 4:2:0
// upsampler, which averages the two diagonals before halving
// (src/dsp/upsampling.c). The bit readers keep libwebp's loading schedule
// and end-of-data rules, so a corrupt or truncated stream reads and fails
// where libwebp's does.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// RFC 6386 section 13.5 (default_coeff_probs) and 13.4
// (coeff_update_probs): [block type][band][context][node]
const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {
      {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
      {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
      {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {
      {1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
      {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
      {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {
      {1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
      {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
      {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {
      {1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
      {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
      {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {
      {1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
      {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
      {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {
      {1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
      {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
      {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {
      {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
  {
    {
      {198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
      {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
      {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {
      {1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
      {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
      {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {
      {1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
      {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
      {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {
      {1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
      {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
      {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {
      {1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
      {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
      {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {
      {1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
      {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
      {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {
      {1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
      {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
      {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {
      {1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
      {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
  {
    {
      {253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
      {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
      {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {
      {1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
      {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
      {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {
      {1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
      {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
      {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {
      {1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
      {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
      {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {
      {1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
      {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {
      {1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {
      {1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
      {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
      {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
  {
    {
      {202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
      {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
      {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {
      {1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
      {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
      {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {
      {1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
      {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
      {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {
      {1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
      {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
      {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {
      {1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
      {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
      {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {
      {1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
      {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
      {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {
      {1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
      {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
      {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {
      {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
      {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {
    {
      {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
      {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {
    {
      {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
      {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {
      {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {
    {
      {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};
// RFC 6386 section 11.5 (kf_bmode_probs): [above mode][left mode][node],
// the modes in the order of the enum below (libwebp's)
const uint8_t kBModesProba[10][10][9] = {
  {
    {231, 120, 48, 89, 115, 113, 120, 152, 112},
    {152, 179, 64, 126, 170, 118, 46, 70, 95},
    {175, 69, 143, 80, 85, 82, 72, 155, 103},
    {56, 58, 10, 171, 218, 189, 17, 13, 152},
    {114, 26, 17, 163, 44, 195, 21, 10, 173},
    {121, 24, 80, 195, 26, 62, 44, 64, 85},
    {144, 71, 10, 38, 171, 213, 144, 34, 26},
    {170, 46, 55, 19, 136, 160, 33, 206, 71},
    {63, 20, 8, 114, 114, 208, 12, 9, 226},
    {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {
    {134, 183, 89, 137, 98, 101, 106, 165, 148},
    {72, 187, 100, 130, 157, 111, 32, 75, 80},
    {66, 102, 167, 99, 74, 62, 40, 234, 128},
    {41, 53, 9, 178, 241, 141, 26, 8, 107},
    {74, 43, 26, 146, 73, 166, 49, 23, 157},
    {65, 38, 105, 160, 51, 52, 31, 115, 128},
    {104, 79, 12, 27, 217, 255, 87, 17, 7},
    {87, 68, 71, 44, 114, 51, 15, 186, 23},
    {47, 41, 14, 110, 182, 183, 21, 17, 194},
    {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {
    {88, 88, 147, 150, 42, 46, 45, 196, 205},
    {43, 97, 183, 117, 85, 38, 35, 179, 61},
    {39, 53, 200, 87, 26, 21, 43, 232, 171},
    {56, 34, 51, 104, 114, 102, 29, 93, 77},
    {39, 28, 85, 171, 58, 165, 90, 98, 64},
    {34, 22, 116, 206, 23, 34, 43, 166, 73},
    {107, 54, 32, 26, 51, 1, 81, 43, 31},
    {68, 25, 106, 22, 64, 171, 36, 225, 114},
    {34, 19, 21, 102, 132, 188, 16, 76, 124},
    {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {
    {193, 101, 35, 159, 215, 111, 89, 46, 111},
    {60, 148, 31, 172, 219, 228, 21, 18, 111},
    {112, 113, 77, 85, 179, 255, 38, 120, 114},
    {40, 42, 1, 196, 245, 209, 10, 25, 109},
    {88, 43, 29, 140, 166, 213, 37, 43, 154},
    {61, 63, 30, 155, 67, 45, 68, 1, 209},
    {100, 80, 8, 43, 154, 1, 51, 26, 71},
    {142, 78, 78, 16, 255, 128, 34, 197, 171},
    {41, 40, 5, 102, 211, 183, 4, 1, 221},
    {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {
    {138, 31, 36, 171, 27, 166, 38, 44, 229},
    {67, 87, 58, 169, 82, 115, 26, 59, 179},
    {63, 59, 90, 180, 59, 166, 93, 73, 154},
    {40, 40, 21, 116, 143, 209, 34, 39, 175},
    {47, 15, 16, 183, 34, 223, 49, 45, 183},
    {46, 17, 33, 183, 6, 98, 15, 32, 183},
    {57, 46, 22, 24, 128, 1, 54, 17, 37},
    {65, 32, 73, 115, 28, 128, 23, 128, 205},
    {40, 3, 9, 115, 51, 192, 18, 6, 223},
    {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {
    {104, 55, 44, 218, 9, 54, 53, 130, 226},
    {64, 90, 70, 205, 40, 41, 23, 26, 57},
    {54, 57, 112, 184, 5, 41, 38, 166, 213},
    {30, 34, 26, 133, 152, 116, 10, 32, 134},
    {39, 19, 53, 221, 26, 114, 32, 73, 255},
    {31, 9, 65, 234, 2, 15, 1, 118, 73},
    {75, 32, 12, 51, 192, 255, 160, 43, 51},
    {88, 31, 35, 67, 102, 85, 55, 186, 85},
    {56, 21, 23, 111, 59, 205, 45, 37, 192},
    {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {
    {125, 98, 42, 88, 104, 85, 117, 175, 82},
    {95, 84, 53, 89, 128, 100, 113, 101, 45},
    {75, 79, 123, 47, 51, 128, 81, 171, 1},
    {57, 17, 5, 71, 102, 57, 53, 41, 49},
    {38, 33, 13, 121, 57, 73, 26, 1, 85},
    {41, 10, 67, 138, 77, 110, 90, 47, 114},
    {115, 21, 2, 10, 102, 255, 166, 23, 6},
    {101, 29, 16, 10, 85, 128, 101, 196, 26},
    {57, 18, 10, 102, 102, 213, 34, 20, 43},
    {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {
    {102, 61, 71, 37, 34, 53, 31, 243, 192},
    {69, 60, 71, 38, 73, 119, 28, 222, 37},
    {68, 45, 128, 34, 1, 47, 11, 245, 171},
    {62, 17, 19, 70, 146, 85, 55, 62, 70},
    {37, 43, 37, 154, 100, 163, 85, 160, 1},
    {63, 9, 92, 136, 28, 64, 32, 201, 85},
    {75, 15, 9, 9, 64, 255, 184, 119, 16},
    {86, 6, 28, 5, 64, 255, 25, 248, 1},
    {56, 8, 17, 132, 137, 255, 55, 116, 128},
    {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {
    {164, 50, 31, 137, 154, 133, 25, 35, 218},
    {51, 103, 44, 131, 131, 123, 31, 6, 158},
    {86, 40, 64, 135, 148, 224, 45, 183, 128},
    {22, 26, 17, 131, 240, 154, 14, 1, 209},
    {45, 16, 21, 91, 64, 222, 7, 1, 197},
    {56, 21, 39, 155, 60, 138, 23, 102, 213},
    {83, 12, 13, 54, 192, 255, 68, 47, 28},
    {85, 26, 85, 85, 128, 128, 32, 146, 171},
    {18, 11, 7, 63, 144, 171, 4, 4, 246},
    {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {
    {190, 80, 35, 99, 180, 80, 126, 54, 45},
    {85, 126, 47, 87, 176, 51, 41, 20, 32},
    {101, 75, 128, 139, 118, 146, 116, 128, 85},
    {56, 41, 15, 176, 236, 85, 37, 9, 62},
    {71, 30, 17, 119, 118, 255, 17, 18, 138},
    {101, 38, 60, 138, 55, 70, 43, 26, 142},
    {146, 36, 19, 30, 171, 255, 97, 27, 20},
    {138, 45, 61, 62, 219, 1, 81, 188, 64},
    {32, 41, 20, 117, 151, 142, 20, 21, 163},
    {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

}  // namespace


namespace {

enum { kOk = 0, kError = 1 };

struct Fail {
    const char* what;
};

[[noreturn]] void fail(const char* what) { throw Fail{what}; }

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ---------------------------------------------------------------------------
// VP8 boolean decoder (RFC 6386 section 7), with libwebp's loading schedule
// and end-of-data rule: the first byte read past the end sets eof and shifts
// in zeros.
// ---------------------------------------------------------------------------

struct BoolReader {
    const uint8_t* buf = nullptr;
    const uint8_t* end = nullptr;
    uint64_t value = 0;
    uint32_t range = 254;   // range - 1
    int bits = -8;          // bits available in value, minus 8
    int eof = 0;

    void init(const uint8_t* b, size_t size) {
        buf = b;
        end = b + size;
        value = 0;
        range = 254;
        bits = -8;
        eof = 0;
        load();
    }
    void load() {
        if (end - buf >= 8) {
            // libwebp's VP8LoadNewBytes: 56 bits at a time while 8 bytes
            // remain. On a corrupt stream the value outgrows its range, and
            // which high bits the 64-bit shift drops depends on this schedule
            uint64_t in = 0;
            for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
            buf += 7;
            value = (value << 56) | in;
            bits += 56;
        } else if (buf < end) {
            bits += 8;
            value = (value << 8) | *buf++;
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = 1;
        } else {
            bits = 0;
        }
    }
    int get_bit(int prob) {
        uint32_t r = range;
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = (r * (uint32_t)prob) >> 8;
        const uint32_t v = (uint32_t)(value >> pos);
        int bit;
        if (v > split) {
            r -= split;
            value -= (uint64_t)(split + 1) << pos;
            bit = 1;
        } else {
            r = split + 1;
            bit = 0;
        }
        const int shift = 7 ^ (31 - __builtin_clz(r));   // r in [1, 255]
        r <<= shift;
        bits -= shift;
        range = r - 1;
        return bit;
    }
    uint32_t get_value(int nbits) {
        uint32_t v = 0;
        while (nbits-- > 0) v |= (uint32_t)get_bit(0x80) << nbits;
        return v;
    }
    int get_signed_value(int nbits) {
        const int v = (int)get_value(nbits);
        return get_value(1) ? -v : v;
    }
};

// ---------------------------------------------------------------------------
// VP8 key frame decoding (RFC 6386), reconstructed and filtered as libwebp
// does it, then converted to RGBA with libwebp's fancy upsampler.
// ---------------------------------------------------------------------------

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       TM_PRED = B_TM_PRED, B_DC_NOTOP = NUM_BMODES, B_DC_NOLEFT,
       B_DC_NOTOPLEFT };

const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129,
                         0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71,
    72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154,
    157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64,
    66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100,
    102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137,
    140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185,
    189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249,
    254, 259, 264, 269, 274, 279, 284};

struct Quant {
    int y1[2], y2[2], uv[2];
};

struct FInfo {
    int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MBData {
    int16_t coeffs[384];
    uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
    uint32_t non_zero_y, non_zero_uv;
};

const int BPS = 32;

// the bottom row of the macroblock above, unfiltered (intra prediction's
// top samples)
struct TopSamples {
    uint8_t y[16], u[8], v[8];
};

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    const int tl = top[-1];
    for (int y = 0; y < size; ++y) {
        const int l = dst[-1];
        for (int x = 0; x < size; ++x) dst[x] = (uint8_t)clip255(l + top[x] - tl);
        dst += BPS;
    }
}

void fill(uint8_t* dst, int size, int v) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void pred16(uint8_t* dst, int mode) {
    switch (mode) {
        case B_DC_PRED: {
            int dc = 16;
            for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
            fill(dst, 16, dc >> 5);
            break;
        }
        case B_TM_PRED: true_motion(dst, 16); break;
        case B_VE_PRED:
            for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
            break;
        case B_HE_PRED:
            for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
            break;
        case B_DC_NOTOP: {
            int dc = 8;
            for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
            fill(dst, 16, dc >> 4);
            break;
        }
        case B_DC_NOLEFT: {
            int dc = 8;
            for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
            fill(dst, 16, dc >> 4);
            break;
        }
        default: fill(dst, 16, 0x80); break;
    }
}

void pred8(uint8_t* dst, int mode) {
    switch (mode) {
        case B_DC_PRED: {
            int dc = 8;
            for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, 8, dc >> 4);
            break;
        }
        case B_TM_PRED: true_motion(dst, 8); break;
        case B_VE_PRED:
            for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
            break;
        case B_HE_PRED:
            for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
            break;
        case B_DC_NOTOP: {
            int dc = 4;
            for (int i = 0; i < 8; ++i) dc += dst[i * BPS - 1];
            fill(dst, 8, dc >> 3);
            break;
        }
        case B_DC_NOLEFT: {
            int dc = 4;
            for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
            fill(dst, 8, dc >> 3);
            break;
        }
        default: fill(dst, 8, 0x80); break;
    }
}

void pred4(uint8_t* dst, int mode) {
    const uint8_t* top = dst - BPS;
    switch (mode) {
        case B_DC_PRED: {
            uint32_t dc = 4;
            for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, 4, dc >> 3);
            break;
        }
        case B_TM_PRED: true_motion(dst, 4); break;
        case B_VE_PRED: {
            const uint8_t vals[4] = {
                (uint8_t)avg3(top[-1], top[0], top[1]),
                (uint8_t)avg3(top[0], top[1], top[2]),
                (uint8_t)avg3(top[1], top[2], top[3]),
                (uint8_t)avg3(top[2], top[3], top[4])};
            for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
            break;
        }
        case B_HE_PRED: {
            const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS],
                      D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
            std::memset(dst + 0 * BPS, avg3(A, B, C), 4);
            std::memset(dst + 1 * BPS, avg3(B, C, D), 4);
            std::memset(dst + 2 * BPS, avg3(C, D, E), 4);
            std::memset(dst + 3 * BPS, avg3(D, E, E), 4);
            break;
        }
        case B_RD_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                      L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                      B = top[1], C = top[2], D = top[3];
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        }
        case B_LD_PRED: {
            const int A = top[0], B = top[1], C = top[2], D = top[3],
                      E = top[4], F = top[5], G = top[6], H = top[7];
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        }
        case B_VR_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                      X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2],
                      D = top[3];
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        }
        case B_VL_PRED: {
            const int A = top[0], B = top[1], C = top[2], D = top[3],
                      E = top[4], F = top[5], G = top[6], H = top[7];
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        }
        case B_HD_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                      L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                      B = top[1], C = top[2];
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        }
        case B_HU_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                      L = dst[-1 + 3 * BPS];
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
                DST(3, 3) = L;
            break;
        }
    }
}

#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// libwebp's TransformOne: vertical pass, then horizontal with rounding
void transform(const int16_t* in, uint8_t* dst) {
    int C[16];
    int* tmp = C;
    for (int i = 0; i < 4; ++i) {
        const int a = in[0] + in[8];
        const int b = in[0] - in[8];
        const int c = mul2(in[4]) - mul1(in[12]);
        const int d = mul1(in[4]) + mul2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - d;
        tmp += 4;
        in++;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8];
        const int b = dc - tmp[8];
        const int c = mul2(tmp[4]) - mul1(tmp[12]);
        const int d = mul1(tmp[4]) + mul2(tmp[12]);
        dst[0] = (uint8_t)clip255(dst[0] + ((a + d) >> 3));
        dst[1] = (uint8_t)clip255(dst[1] + ((b + c) >> 3));
        dst[2] = (uint8_t)clip255(dst[2] + ((b - c) >> 3));
        dst[3] = (uint8_t)clip255(dst[3] + ((a - d) >> 3));
        tmp++;
        dst += BPS;
    }
}

// libwebp's Transform_SSE2, which the x86 builds use for a block with more
// than three coefficients (and for the chroma blocks when any has an AC
// coefficient): the same arithmetic in 16-bit lanes that wrap. A valid
// stream stays in range, where it equals `transform`; a corrupt one does
// not, and its pixels are the wrapped lanes'.
inline int16_t w16(int v) { return (int16_t)v; }
inline int16_t mulhi16(int16_t x, int k) { return (int16_t)(((int)x * k) >> 16); }

void transform_lanes(const int16_t* in, uint8_t* dst) {
    int16_t t[4][4];   // t[k][i]: output k of the vertical pass on column i
    for (int i = 0; i < 4; ++i) {
        const int16_t x0 = in[i], x1 = in[4 + i], x2 = in[8 + i], x3 = in[12 + i];
        const int16_t a = w16(x0 + x2), b = w16(x0 - x2);
        const int16_t c = w16(w16(x1 - x3) +
                              w16(mulhi16(x1, -30068) - mulhi16(x3, 20091)));
        const int16_t d = w16(w16(x1 + x3) +
                              w16(mulhi16(x1, 20091) + mulhi16(x3, -30068)));
        t[0][i] = w16(a + d);
        t[1][i] = w16(b + c);
        t[2][i] = w16(b - c);
        t[3][i] = w16(a - d);
    }
    for (int l = 0; l < 4; ++l) {
        const int16_t* x = t[l];
        const int16_t dc = w16(x[0] + 4);
        const int16_t a = w16(dc + x[2]), b = w16(dc - x[2]);
        const int16_t c = w16(w16(x[1] - x[3]) +
                              w16(mulhi16(x[1], -30068) - mulhi16(x[3], 20091)));
        const int16_t d = w16(w16(x[1] + x[3]) +
                              w16(mulhi16(x[1], 20091) + mulhi16(x[3], -30068)));
        const int16_t o[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
        for (int k = 0; k < 4; ++k)
            dst[k] = (uint8_t)clip255(dst[k] + (o[k] >> 3));
        dst += BPS;
    }
}

// frame_dec.c DoTransform: the 2-bit code of a 4x4 block (3: full, 2: the
// first three coefficients, 1: DC only)
inline void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if ((bits >> 30) == 3)
        transform_lanes(src, dst);
    else if (bits >> 30)
        transform(src, dst);
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

// loop filters (RFC 6386 section 15, as libwebp's dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline int uclip(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = (uint8_t)uclip(p0 + a2);
    p[0] = (uint8_t)uclip(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = (uint8_t)uclip(p1 + a3);
    p[-step] = (uint8_t)uclip(p0 + a2);
    p[0] = (uint8_t)uclip(q0 - a1);
    p[step] = (uint8_t)uclip(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = (uint8_t)uclip(p2 + a3);
    p[-2 * step] = (uint8_t)uclip(p1 + a2);
    p[-step] = (uint8_t)uclip(p0 + a1);
    p[0] = (uint8_t)uclip(q0 - a1);
    p[step] = (uint8_t)uclip(q1 - a2);
    p[2 * step] = (uint8_t)uclip(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return (std::abs(p1 - p0) > thresh) || (std::abs(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
           std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
           std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_v16(uint8_t* p, int stride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i)
        if (needs_filter(p + i, stride, t2)) do_filter2(p + i, stride);
}

void simple_h16(uint8_t* p, int stride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i)
        if (needs_filter(p + i * stride, 1, t2)) do_filter2(p + i * stride, 1);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size,
                   int thresh, int ithresh, int hev_thresh) {
    const int t2 = 2 * thresh + 1;
    while (size-- > 0) {
        if (needs_filter2(p, hstride, t2, ithresh)) {
            if (hev(p, hstride, hev_thresh))
                do_filter2(p, hstride);
            else
                do_filter6(p, hstride);
        }
        p += vstride;
    }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size,
                   int thresh, int ithresh, int hev_thresh) {
    const int t2 = 2 * thresh + 1;
    while (size-- > 0) {
        if (needs_filter2(p, hstride, t2, ithresh)) {
            if (hev(p, hstride, hev_thresh))
                do_filter2(p, hstride);
            else
                do_filter4(p, hstride);
        }
        p += vstride;
    }
}

struct VP8 {
    // headers
    int width = 0, height = 0, mb_w = 0, mb_h = 0;
    int use_segment = 0, update_map = 0, absolute_delta = 1;
    int seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
    uint8_t seg_probs[3] = {255, 255, 255};
    int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
    int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
    int filter_type = 0;
    int num_parts_minus_one = 0;
    BoolReader br, parts[8];
    Quant dqm[4];
    uint8_t proba[4][8][3][11];
    int use_skip_proba = 0, skip_p = 0;
    FInfo fstrengths[4][2];
    // state
    std::vector<uint8_t> intra_t;
    uint8_t intra_l[4];
    std::vector<uint8_t> nz_top, nz_dc_top;
    uint8_t nz_left = 0, nz_dc_left = 0;
    std::vector<MBData> mbs;      // one row of macroblocks
    std::vector<TopSamples> yuv_t;
    std::vector<FInfo> finfo;     // every macroblock's filter
    // planes (mb_w * 16 by mb_h * 16, and chroma)
    std::vector<uint8_t> Y, U, V;
    int ys = 0, uvs = 0;

    void parse_header(const uint8_t* buf, size_t size);
    void parse_intra_mode(int mb_x);
    int get_coeffs(BoolReader& tbr, int type, int ctx, const int dq[2],
                   int n, int16_t* out);
    int parse_residuals(int mb_x, BoolReader& tbr);
    void reconstruct_row(int mb_y);
    void filter_all();
    void precompute_filter_strengths();
};

void VP8::parse_header(const uint8_t* buf, size_t buf_size) {
    if (buf_size < 4) fail("Truncated header.");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const int key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const int show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3) fail("Incorrect keyframe parameters.");
    if (!show) fail("Frame not displayable.");
    buf += 3;
    buf_size -= 3;
    if (key_frame) {
        if (buf_size < 7) fail("cannot parse picture header");
        if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a))
            fail("Bad code word");
        width = ((buf[4] << 8) | buf[3]) & 0x3fff;
        height = ((buf[6] << 8) | buf[5]) & 0x3fff;
        buf += 7;
        buf_size -= 7;
        mb_w = (width + 15) >> 4;
        mb_h = (height + 15) >> 4;
        std::memcpy(proba, kCoeffsProba0, sizeof(proba));
    }
    if (partition_length > buf_size) fail("bad partition length");
    br.init(buf, partition_length);
    buf += partition_length;
    buf_size -= partition_length;
    if (key_frame) {
        br.get_value(1);   // colour space
        br.get_value(1);   // clamping type
    }
    // segment header
    use_segment = br.get_value(1);
    if (use_segment) {
        update_map = br.get_value(1);
        if (br.get_value(1)) {
            absolute_delta = br.get_value(1);
            for (int s = 0; s < 4; ++s)
                seg_quant[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
            for (int s = 0; s < 4; ++s)
                seg_filter[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
        }
        if (update_map)
            for (int s = 0; s < 3; ++s)
                seg_probs[s] = br.get_value(1) ? (uint8_t)br.get_value(8) : 255;
    } else {
        update_map = 0;
    }
    if (br.eof) fail("cannot parse segment header");
    // filter header
    simple = br.get_value(1);
    level = br.get_value(6);
    sharpness = br.get_value(3);
    use_lf_delta = br.get_value(1);
    if (use_lf_delta) {
        if (br.get_value(1)) {
            for (int i = 0; i < 4; ++i)
                if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
            for (int i = 0; i < 4; ++i)
                if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
        }
    }
    filter_type = (level == 0) ? 0 : simple ? 1 : 2;
    if (br.eof) fail("cannot parse filter header");
    // partitions
    {
        const uint8_t* sz = buf;
        const uint8_t* buf_end = buf + buf_size;
        num_parts_minus_one = (1 << br.get_value(2)) - 1;
        const size_t last_part = num_parts_minus_one;
        if (buf_size < 3 * last_part) fail("cannot parse partitions");
        const uint8_t* part_start = buf + last_part * 3;
        size_t size_left = buf_size - last_part * 3;
        for (size_t p = 0; p < last_part; ++p) {
            size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
            if (psize > size_left) psize = size_left;
            parts[p].init(part_start, psize);
            part_start += psize;
            size_left -= psize;
            sz += 3;
        }
        parts[last_part].init(part_start, size_left);
        if (!(part_start < buf_end)) fail("cannot parse partitions");
    }
    // quantiser
    {
        const int base_q0 = br.get_value(7);
        const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
        const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
        const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
        const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
        const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
        auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
        for (int i = 0; i < 4; ++i) {
            int q;
            if (use_segment) {
                q = seg_quant[i];
                if (!absolute_delta) q += base_q0;
            } else {
                if (i > 0) {
                    dqm[i] = dqm[0];
                    continue;
                }
                q = base_q0;
            }
            Quant& m = dqm[i];
            m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
            m.y1[1] = kAcTable[clip(q + 0, 127)];
            m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
            m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
            if (m.y2[1] < 8) m.y2[1] = 8;
            m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
            m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
        }
    }
    if (!key_frame) fail("Not a key frame.");
    br.get_value(1);   // update_proba, ignored
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p)
                    proba[t][b][c][p] = br.get_bit(kCoeffsUpdateProba[t][b][c][p])
                                            ? (uint8_t)br.get_value(8)
                                            : kCoeffsProba0[t][b][c][p];
    use_skip_proba = br.get_value(1);
    if (use_skip_proba) skip_p = br.get_value(8);
}

void VP8::precompute_filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
        int base_level;
        if (use_segment) {
            base_level = seg_filter[s];
            if (!absolute_delta) base_level += level;
        } else {
            base_level = level;
        }
        for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
            FInfo& info = fstrengths[s][i4x4];
            int lvl = base_level;
            if (use_lf_delta) {
                lvl += ref_lf_delta[0];
                if (i4x4) lvl += mode_lf_delta[0];
            }
            lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
            if (lvl > 0) {
                int ilevel = lvl;
                if (sharpness > 0) {
                    ilevel >>= (sharpness > 4) ? 2 : 1;
                    if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
                }
                if (ilevel < 1) ilevel = 1;
                info.ilevel = ilevel;
                info.limit = 2 * lvl + ilevel;
                info.hev = (lvl >= 40) ? 2 : (lvl >= 15) ? 1 : 0;
            } else {
                info.limit = 0;
            }
            info.inner = i4x4;
        }
    }
}

void VP8::parse_intra_mode(int mb_x) {
    uint8_t* top = intra_t.data() + 4 * mb_x;
    uint8_t* left = intra_l;
    MBData& block = mbs[mb_x];
    if (update_map) {
        block.segment = !br.get_bit(seg_probs[0]) ? br.get_bit(seg_probs[1])
                                                  : br.get_bit(seg_probs[2]) + 2;
    } else {
        block.segment = 0;
    }
    if (use_skip_proba) block.skip = br.get_bit(skip_p);
    block.is_i4x4 = !br.get_bit(145);
    if (!block.is_i4x4) {
        const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                          : (br.get_bit(163) ? V_PRED : DC_PRED);
        block.imodes[0] = ymode;
        std::memset(top, ymode, 4);
        std::memset(left, ymode, 4);
    } else {
        uint8_t* modes = block.imodes;
        for (int y = 0; y < 4; ++y) {
            int ymode = left[y];
            for (int x = 0; x < 4; ++x) {
                const uint8_t* prob = kBModesProba[top[x]][ymode];
                int i = kYModesIntra4[br.get_bit(prob[0])];
                while (i > 0) i = kYModesIntra4[2 * i + br.get_bit(prob[i])];
                ymode = -i;
                top[x] = ymode;
            }
            std::memcpy(modes, top, 4);
            modes += 4;
            left[y] = ymode;
        }
    }
    block.uvmode = !br.get_bit(142) ? DC_PRED
                 : !br.get_bit(114) ? V_PRED
                 : br.get_bit(183) ? TM_PRED : H_PRED;
}

int VP8::get_coeffs(BoolReader& tbr, int type, int ctx, const int dq[2],
                    int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!tbr.get_bit(p[0])) return n;
        while (!tbr.get_bit(p[1])) {
            ++n;
            p = proba[type][kBands[n]][0];
            if (n == 16) return 16;
        }
        {
            int v;
            const int band_next = kBands[n + 1];
            if (!tbr.get_bit(p[2])) {
                v = 1;
                p = proba[type][band_next][1];
            } else {
                if (!tbr.get_bit(p[3])) {
                    if (!tbr.get_bit(p[4]))
                        v = 2;
                    else
                        v = 3 + tbr.get_bit(p[5]);
                } else {
                    if (!tbr.get_bit(p[6])) {
                        if (!tbr.get_bit(p[7])) {
                            v = 5 + tbr.get_bit(159);
                        } else {
                            v = 7 + 2 * tbr.get_bit(165);
                            v += tbr.get_bit(145);
                        }
                    } else {
                        const int bit1 = tbr.get_bit(p[8]);
                        const int bit0 = tbr.get_bit(p[9 + bit1]);
                        const int cat = 2 * bit1 + bit0;
                        v = 0;
                        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
                            v += v + tbr.get_bit(*tab);
                        v += 3 + (8 << cat);
                    }
                }
                p = proba[type][band_next][2];
            }
            const int s = tbr.get_bit(0x80) ? -v : v;
            out[kZigzag[n]] = (int16_t)(s * dq[n > 0]);
        }
    }
    return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
}

int VP8::parse_residuals(int mb_x, BoolReader& tbr) {
    MBData& block = mbs[mb_x];
    const Quant& q = dqm[block.segment];
    int16_t* dst = block.coeffs;
    uint8_t& top_nz = nz_top[mb_x];
    uint8_t& top_nz_dc = nz_dc_top[mb_x];
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    std::memset(dst, 0, 384 * sizeof(*dst));
    if (!block.is_i4x4) {
        int16_t dc[16] = {0};
        const int ctx = top_nz_dc + nz_dc_left;
        const int nz = get_coeffs(tbr, 1, ctx, q.y2, 0, dc);
        top_nz_dc = nz_dc_left = (nz > 0);
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
        }
        first = 1;
        ac_type = 0;
    } else {
        first = 0;
        ac_type = 3;
    }
    uint8_t tnz = top_nz & 0x0f;
    uint8_t lnz = nz_left & 0x0f;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        uint32_t nz_coeffs = 0;
        for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(tbr, ac_type, ctx, q.y1, first, dst);
            l = (nz > first);
            tnz = (uint8_t)((tnz >> 1) | (l << 7));
            nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
            dst += 16;
        }
        tnz >>= 4;
        lnz = (uint8_t)((lnz >> 1) | (l << 7));
        non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
        uint32_t nz_coeffs = 0;
        tnz = (uint8_t)(top_nz >> (4 + ch));
        lnz = (uint8_t)(nz_left >> (4 + ch));
        for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
                const int ctx = l + (tnz & 1);
                const int nz = get_coeffs(tbr, 2, ctx, q.uv, 0, dst);
                l = (nz > 0);
                tnz = (uint8_t)((tnz >> 1) | (l << 3));
                nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 2;
            lnz = (uint8_t)((lnz >> 1) | (l << 5));
        }
        non_zero_uv |= nz_coeffs << (4 * ch);
        out_t_nz |= (uint32_t)(tnz << 4) << ch;
        out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
    }
    top_nz = (uint8_t)out_t_nz;
    nz_left = (uint8_t)out_l_nz;
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
}

inline int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
        if (mb_x == 0) return (mb_y == 0) ? B_DC_NOTOPLEFT : B_DC_NOLEFT;
        return (mb_y == 0) ? B_DC_NOTOP : B_DC_PRED;
    }
    return mode;
}

const int kScan[16] = {0 + 0 * BPS, 4 + 0 * BPS, 8 + 0 * BPS, 12 + 0 * BPS,
                       0 + 4 * BPS, 4 + 4 * BPS, 8 + 4 * BPS, 12 + 4 * BPS,
                       0 + 8 * BPS, 4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

void VP8::reconstruct_row(int mb_y) {
    uint8_t ybuf[BPS * 21], ubuf[BPS * 10], vbuf[BPS * 10];
    uint8_t* const y_dst = ybuf + BPS + 8;
    uint8_t* const u_dst = ubuf + BPS + 8;
    uint8_t* const v_dst = vbuf + BPS + 8;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
        u_dst[j * BPS - 1] = 129;
        v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MBData& block = mbs[mb_x];
        if (mb_x > 0) {
            for (int j = -1; j < 16; ++j)
                std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
            for (int j = -1; j < 8; ++j) {
                std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
                std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
            }
        }
        TopSamples* const top_yuv = yuv_t.data() + mb_x;
        const int16_t* const coeffs = block.coeffs;
        uint32_t bits = block.non_zero_y;
        if (mb_y > 0) {
            std::memcpy(y_dst - BPS, top_yuv[0].y, 16);
            std::memcpy(u_dst - BPS, top_yuv[0].u, 8);
            std::memcpy(v_dst - BPS, top_yuv[0].v, 8);
        }
        if (block.is_i4x4) {
            uint8_t* const top_right = y_dst - BPS + 16;
            if (mb_y > 0) {
                if (mb_x >= mb_w - 1)
                    std::memset(top_right, top_yuv[0].y[15], 4);
                else
                    std::memcpy(top_right, top_yuv[1].y, 4);
            }
            for (int r = 1; r <= 3; ++r)
                std::memcpy(top_right + 4 * r * BPS, top_right, 4);
            for (int n = 0; n < 16; ++n, bits <<= 2) {
                uint8_t* const dst = y_dst + kScan[n];
                pred4(dst, block.imodes[n]);
                do_transform(bits, coeffs + n * 16, dst);
            }
        } else {
            pred16(y_dst, check_mode(mb_x, mb_y, block.imodes[0]));
            if (bits != 0)
                for (int n = 0; n < 16; ++n, bits <<= 2)
                    do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
        }
        {
            const uint32_t bits_uv = block.non_zero_uv;
            const int mode = check_mode(mb_x, mb_y, block.uvmode);
            pred8(u_dst, mode);
            pred8(v_dst, mode);
            // DoUVTransform: TransformUV (the lanes) when any block of the
            // plane has an AC coefficient, else TransformDCUV
            for (int p = 0; p < 2; ++p) {
                const uint32_t b = (bits_uv >> (8 * p)) & 0xff;
                if (!b) continue;
                uint8_t* const pdst = p ? v_dst : u_dst;
                for (int n = 0; n < 4; ++n) {
                    const int16_t* const src = coeffs + 256 + 64 * p + n * 16;
                    uint8_t* const dst = pdst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
                    if (b & 0xaa)
                        transform_lanes(src, dst);
                    else
                        transform(src, dst);
                }
            }
        }
        if (mb_y < mb_h - 1) {
            std::memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
            std::memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
            std::memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j)
            std::memcpy(&Y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16],
                        y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
            std::memcpy(&U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8],
                        u_dst + j * BPS, 8);
            std::memcpy(&V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8],
                        v_dst + j * BPS, 8);
        }
    }
}

void VP8::filter_all() {
    if (filter_type == 0) return;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
            const int limit = f.limit;
            if (limit == 0) continue;
            uint8_t* y_dst = &Y[(size_t)mb_y * 16 * ys + mb_x * 16];
            if (filter_type == 1) {
                if (mb_x > 0) simple_h16(y_dst, ys, limit + 4);
                if (f.inner)
                    for (int k = 1; k <= 3; ++k) simple_h16(y_dst + 4 * k, ys, limit);
                if (mb_y > 0) simple_v16(y_dst, ys, limit + 4);
                if (f.inner)
                    for (int k = 1; k <= 3; ++k)
                        simple_v16(y_dst + 4 * k * ys, ys, limit);
            } else {
                uint8_t* u_dst = &U[(size_t)mb_y * 8 * uvs + mb_x * 8];
                uint8_t* v_dst = &V[(size_t)mb_y * 8 * uvs + mb_x * 8];
                const int il = f.ilevel, hv = f.hev;
                if (mb_x > 0) {
                    filter_loop26(y_dst, 1, ys, 16, limit + 4, il, hv);
                    filter_loop26(u_dst, 1, uvs, 8, limit + 4, il, hv);
                    filter_loop26(v_dst, 1, uvs, 8, limit + 4, il, hv);
                }
                if (f.inner) {
                    for (int k = 1; k <= 3; ++k)
                        filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, il, hv);
                    filter_loop24(u_dst + 4, 1, uvs, 8, limit, il, hv);
                    filter_loop24(v_dst + 4, 1, uvs, 8, limit, il, hv);
                }
                if (mb_y > 0) {
                    filter_loop26(y_dst, ys, 1, 16, limit + 4, il, hv);
                    filter_loop26(u_dst, uvs, 1, 8, limit + 4, il, hv);
                    filter_loop26(v_dst, uvs, 1, 8, limit + 4, il, hv);
                }
                if (f.inner) {
                    for (int k = 1; k <= 3; ++k)
                        filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hv);
                    filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, il, hv);
                    filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, il, hv);
                }
            }
        }
    }
}

// libwebp's fixed-point YUV -> RGB (src/dsp/yuv.h)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) {
    return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
    rgba[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgba[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                                 mult_hi(v, 13320) + 8708);
    rgba[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
    rgba[3] = 0xff;
}

// libwebp's UpsampleRgbaLinePair (src/dsp/upsampling.c): u and v packed in
// one word, the two diagonals averaged before the halving
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
    const int last_pixel_pair = (len - 1) >> 1;
    uint32_t tl_uv = top_u[0] | ((uint32_t)top_v[0] << 16);
    uint32_t l_uv = cur_u[0] | ((uint32_t)cur_v[0] << 16);
    {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_rgba(top_y[0], uv0 & 0xff, (uv0 >> 16), top_dst);
    }
    if (bottom_y != nullptr) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_rgba(bottom_y[0], uv0 & 0xff, (uv0 >> 16), bottom_dst);
    }
    for (int x = 1; x <= last_pixel_pair; ++x) {
        const uint32_t t_uv = top_u[x] | ((uint32_t)top_v[x] << 16);
        const uint32_t uv = cur_u[x] | ((uint32_t)cur_v[x] << 16);
        const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
        const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
        const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
        {
            const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
            const uint32_t uv1 = (diag_03 + t_uv) >> 1;
            yuv_to_rgba(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16),
                        top_dst + (2 * x - 1) * 4);
            yuv_to_rgba(top_y[2 * x - 0], uv1 & 0xff, (uv1 >> 16),
                        top_dst + (2 * x - 0) * 4);
        }
        if (bottom_y != nullptr) {
            const uint32_t uv0 = (diag_03 + l_uv) >> 1;
            const uint32_t uv1 = (diag_12 + uv) >> 1;
            yuv_to_rgba(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16),
                        bottom_dst + (2 * x - 1) * 4);
            yuv_to_rgba(bottom_y[2 * x + 0], uv1 & 0xff, (uv1 >> 16),
                        bottom_dst + (2 * x + 0) * 4);
        }
        tl_uv = t_uv;
        l_uv = uv;
    }
    if (!(len & 1)) {
        {
            const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
            yuv_to_rgba(top_y[len - 1], uv0 & 0xff, (uv0 >> 16),
                        top_dst + (len - 1) * 4);
        }
        if (bottom_y != nullptr) {
            const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
            yuv_to_rgba(bottom_y[len - 1], uv0 & 0xff, (uv0 >> 16),
                        bottom_dst + (len - 1) * 4);
        }
    }
}

// the whole picture through EmitFancyRGB's row pairs
void emit_fancy_rgba(const VP8& d, uint8_t* out, long long stride) {
    const int w = d.width, h = d.height;
    const uint8_t* Y = d.Y.data();
    const uint8_t* U = d.U.data();
    const uint8_t* V = d.V.data();
    const int ys = d.ys, uvs = d.uvs;
    upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w);
    int y = 0;
    for (; y + 2 < h; y += 2) {
        const int cu = (y >> 1) + 1;
        upsample_pair(Y + (size_t)(y + 1) * ys, Y + (size_t)(y + 2) * ys,
                      U + (size_t)(cu - 1) * uvs, V + (size_t)(cu - 1) * uvs,
                      U + (size_t)cu * uvs, V + (size_t)cu * uvs,
                      out + (y + 1) * stride, out + (y + 2) * stride, w);
    }
    if (!(h & 1)) {
        const int cu = (h >> 1) - 1;
        upsample_pair(Y + (size_t)(h - 1) * ys, nullptr,
                      U + (size_t)cu * uvs, V + (size_t)cu * uvs,
                      U + (size_t)cu * uvs, V + (size_t)cu * uvs,
                      out + (h - 1) * stride, nullptr, w);
    }
}

void vp8_decode(const uint8_t* data, size_t size, VP8& d) {
    d.parse_header(data, size);
    d.ys = d.mb_w * 16;
    d.uvs = d.mb_w * 8;
    d.Y.assign((size_t)d.ys * d.mb_h * 16, 0);
    d.U.assign((size_t)d.uvs * d.mb_h * 8, 0);
    d.V.assign((size_t)d.uvs * d.mb_h * 8, 0);
    d.intra_t.assign((size_t)4 * d.mb_w, B_DC_PRED);
    d.nz_top.assign(d.mb_w, 0);
    d.nz_dc_top.assign(d.mb_w, 0);
    d.mbs.resize(d.mb_w);
    d.yuv_t.assign(d.mb_w, TopSamples{});
    for (auto& m : d.mbs) m.skip = 0;
    d.finfo.assign((size_t)d.mb_w * d.mb_h, FInfo{});
    d.precompute_filter_strengths();
    for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
        BoolReader& tbr = d.parts[mb_y & d.num_parts_minus_one];
        std::memset(d.intra_l, B_DC_PRED, 4);
        for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) d.parse_intra_mode(mb_x);
        if (d.br.eof) fail("Premature end-of-partition0 encountered.");
        d.nz_left = 0;
        d.nz_dc_left = 0;
        for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
            MBData& block = d.mbs[mb_x];
            int skip = d.use_skip_proba ? block.skip : 0;
            if (!skip) {
                skip = d.parse_residuals(mb_x, tbr);
            } else {
                d.nz_left = 0;
                d.nz_top[mb_x] = 0;
                if (!block.is_i4x4) {
                    d.nz_dc_left = 0;
                    d.nz_dc_top[mb_x] = 0;
                }
                block.non_zero_y = 0;
                block.non_zero_uv = 0;
            }
            if (d.filter_type > 0) {
                FInfo& f = d.finfo[(size_t)mb_y * d.mb_w + mb_x];
                f = d.fstrengths[block.segment][block.is_i4x4];
                f.inner |= !skip;
            }
            if (tbr.eof) fail("Premature end-of-file encountered.");
        }
        d.reconstruct_row(mb_y);
    }
    d.filter_all();
}

// ---------------------------------------------------------------------------
// VP8L (RFC 9649), with libwebp's end-of-stream rule: reading past the end
// (at least 64 bits are always readable) is an error where libwebp checks.
// ---------------------------------------------------------------------------

struct BitReaderL {
    const uint8_t* buf;
    size_t len;
    uint64_t pos = 0;        // bits consumed
    uint64_t limit;          // bits readable before end of stream
    int eos = 0;

    BitReaderL(const uint8_t* b, size_t n) : buf(b), len(n) {
        limit = 8 * (uint64_t)(n > 8 ? n : 8);
    }
    // n <= 24 bits from the position, least significant first; zeros
    // past the data
    uint32_t peek(int n) const {
        const size_t byte = (size_t)(pos >> 3);
        uint64_t v = 0;
        if (byte + 8 <= len) {
            std::memcpy(&v, buf + byte, 8);   // little-endian host
        } else {
            for (size_t i = 0; byte + i < len && i < 8; ++i)
                v |= (uint64_t)buf[byte + i] << (8 * i);
        }
        return (uint32_t)((v >> (pos & 7)) & ((1ull << n) - 1));
    }
    // VP8LReadBits: 0 once at the end of the stream
    uint32_t read(int n) {
        if (eos) return 0;
        const uint32_t v = peek(n);
        pos += n;
        if (pos > limit) {
            eos = 1;
        }
        return v;
    }
    void advance(int n) {
        pos += n;
    }
    bool at_end() const { return eos || pos > limit; }
};

// canonical prefix code: symbols sorted by (length, symbol); the first bit
// read is the code's most significant
struct Huffman {
    int single = -1;                 // a one-symbol code reads no bits
    std::vector<uint16_t> table;     // 8-bit lookup: symbol << 4 | length
    std::vector<int> count, first_code, first_index;
    std::vector<uint16_t> sorted;
    int max_len = 0;

    // the validity rules of libwebp's BuildHuffmanTable
    bool build(const int* lengths, int n) {
        count.assign(16, 0);
        for (int s = 0; s < n; ++s) {
            if (lengths[s] > 15) return false;
            ++count[lengths[s]];
        }
        if (count[0] == n) return false;
        std::vector<int> offset(17, 0);
        for (int l = 1; l < 15; ++l) {
            if (count[l] > (1 << l)) return false;
            offset[l + 1] = offset[l] + count[l];
        }
        sorted.assign(n, 0);
        std::vector<int> off = offset;
        int nsym = 0;
        for (int s = 0; s < n; ++s)
            if (lengths[s] > 0) {
                sorted[off[lengths[s]]++] = (uint16_t)s;
                ++nsym;
            }
        if (nsym == 1) {
            single = sorted[0];
            return true;
        }
        single = -1;
        int num_nodes = 1, num_open = 1;
        for (int l = 1; l <= 15; ++l) {
            num_open <<= 1;
            num_nodes += num_open;
            num_open -= count[l];
            if (num_open < 0) return false;
        }
        if (num_nodes != 2 * nsym - 1) return false;
        first_code.assign(17, 0);
        first_index.assign(17, 0);
        int code = 0, idx = 0;
        max_len = 0;
        for (int l = 1; l <= 15; ++l) {
            first_code[l] = code;
            first_index[l] = idx;
            code = (code + count[l]) << 1;
            idx += count[l];
            if (count[l]) max_len = l;
        }
        // 8-bit table of the codes up to 8 bits, keyed by the bits as read
        table.assign(256, 0);
        for (int l = 1; l <= 8; ++l)
            for (int k = 0; k < count[l]; ++k) {
                const int c = first_code[l] + k;
                int rev = 0;
                for (int b = 0; b < l; ++b) rev |= ((c >> (l - 1 - b)) & 1) << b;
                for (int fill = rev; fill < 256; fill += 1 << l)
                    table[fill] = (uint16_t)((sorted[first_index[l] + k] << 4) | l);
            }
        return true;
    }
    int read(BitReaderL& br) const {
        if (single >= 0) return single;
        const uint32_t bits = br.peek(15);
        const uint16_t e = table[bits & 255];
        if (e) {
            br.advance(e & 15);
            return e >> 4;
        }
        int code = 0;
        for (int l = 1; l <= 15; ++l) {
            code = (code << 1) | ((bits >> (l - 1)) & 1);
            const int k = code - first_code[l];
            if (k >= 0 && k < count[l]) {
                br.advance(l);
                return sorted[first_index[l] + k];
            }
        }
        br.advance(15);
        return 0;
    }
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8,
                                      9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

struct HTreeGroup {
    Huffman codes[5];   // green (+ lengths + cache), red, blue, alpha, dist
};

struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
};

struct VP8L {
    BitReaderL br;
    std::vector<Transform> transforms;
    unsigned transforms_seen = 0;
    VP8L(const uint8_t* d, size_t n) : br(d, n) {}

    bool read_code(int alphabet_size, Huffman& h);
    bool read_code_lengths(const int* cl_lengths, int num_symbols,
                           int* lengths);
    bool decode_stream(int xsize, int ysize, bool level0,
                       std::vector<uint32_t>& out);
    bool read_transform(int& xsize, int ysize);
    bool decode_data(std::vector<uint32_t>& data, int width, int height,
                     std::vector<HTreeGroup>& groups,
                     const std::vector<uint32_t>& meta, int meta_bits,
                     int meta_xsize, int cache_bits);
};

bool VP8L::read_code_lengths(const int* cl_lengths, int num_symbols,
                             int* lengths) {
    Huffman table;
    if (!table.build(cl_lengths, 19)) return false;
    int max_symbol;
    if (br.read(1)) {
        const int length_nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(length_nbits);
        if (max_symbol > num_symbols) return false;
    } else {
        max_symbol = num_symbols;
    }
    int prev = 8;
    int symbol = 0;
    while (symbol < num_symbols) {
        if (max_symbol-- == 0) break;
        const int code_len = table.read(br);
        if (code_len < 16) {
            lengths[symbol++] = code_len;
            if (code_len != 0) prev = code_len;
        } else {
            static const int extra[3] = {2, 3, 7}, offs[3] = {3, 3, 11};
            const int slot = code_len - 16;
            int repeat = br.read(extra[slot]) + offs[slot];
            if (symbol + repeat > num_symbols) return false;
            const int length = code_len == 16 ? prev : 0;
            while (repeat-- > 0) lengths[symbol++] = length;
        }
    }
    return true;
}

bool VP8L::read_code(int alphabet_size, Huffman& h) {
    std::vector<int> lengths(alphabet_size > 256 ? alphabet_size : 256, 0);
    bool ok;
    if (br.read(1)) {   // simple code
        const int num_symbols = br.read(1) + 1;
        const int first_bits = br.read(1);
        int symbol = br.read(first_bits == 0 ? 1 : 8);
        lengths[symbol] = 1;
        if (num_symbols == 2) {
            symbol = br.read(8);
            lengths[symbol] = 1;
        }
        ok = true;
    } else {
        int cl[19] = {0};
        const int num_codes = br.read(4) + 4;
        for (int i = 0; i < num_codes; ++i)
            cl[kCodeLengthCodeOrder[i]] = br.read(3);
        ok = read_code_lengths(cl, alphabet_size, lengths.data());
    }
    ok = ok && !br.eos;
    return ok && h.build(lengths.data(), alphabet_size);
}

inline int subsample(int size, int bits) {
    return (size + (1 << bits) - 1) >> bits;
}

bool VP8L::read_transform(int& xsize, int ysize) {
    const int type = br.read(2);
    if (transforms_seen & (1u << type)) return false;
    transforms_seen |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    t.bits = 0;
    bool ok = true;
    if (type == 0 || type == 1) {
        t.bits = br.read(3) + 2;
        ok = decode_stream(subsample(t.xsize, t.bits),
                           subsample(t.ysize, t.bits), false, t.data);
    } else if (type == 3) {
        const int num_colors = br.read(8) + 1;
        const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                       : num_colors > 2 ? 2 : 3;
        xsize = subsample(t.xsize, bits);
        t.bits = bits;
        std::vector<uint32_t> pal;
        ok = decode_stream(num_colors, 1, false, pal);
        if (ok) {
            const int final_num = 1 << (8 >> bits);
            t.data.assign(final_num, 0);
            t.data[0] = pal[0];
            for (int i = 1; i < num_colors; ++i) {
                const uint32_t a = t.data[i - 1], b = pal[i];
                uint32_t v = 0;
                for (int c = 0; c < 32; c += 8)
                    v |= (((a >> c) + (b >> c)) & 0xff) << c;
                t.data[i] = v;
            }
        }
    }
    transforms.push_back(std::move(t));
    return ok;
}

bool VP8L::decode_stream(int xsize, int ysize, bool level0,
                         std::vector<uint32_t>& out) {
    int txsize = xsize;
    if (level0) {
        while (br.read(1)) {
            if (!read_transform(txsize, ysize)) return false;
        }
    }
    int cache_bits = 0;
    if (br.read(1)) {
        cache_bits = br.read(4);
        if (cache_bits < 1 || cache_bits > 11) return false;
    }
    // prefix codes, with the meta image at level 0
    std::vector<uint32_t> meta;
    int meta_bits = 0, meta_xsize = 0, num_groups = 1;
    if (level0 && br.read(1)) {
        meta_bits = br.read(3) + 2;
        meta_xsize = subsample(txsize, meta_bits);
        const int meta_ysize = subsample(ysize, meta_bits);
        if (!decode_stream(meta_xsize, meta_ysize, false, meta)) return false;
        for (auto& m : meta) {
            m = (m >> 8) & 0xffff;
            if ((int)m >= num_groups) num_groups = (int)m + 1;
        }
    }
    std::vector<HTreeGroup> groups(num_groups);
    const int cache_size = cache_bits > 0 ? 1 << cache_bits : 0;
    for (auto& g : groups) {
        static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
        for (int j = 0; j < 5; ++j) {
            const int size = kAlphabet[j] + (j == 0 ? cache_size : 0);
            if (!read_code(size, g.codes[j])) return false;
        }
    }
    out.assign((size_t)txsize * ysize, 0);
    if (!decode_data(out, txsize, ysize, groups, meta, meta_bits, meta_xsize,
                     cache_bits))
        return false;
    return !br.eos;
}

inline int copy_distance(int sym, BitReaderL& br) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra;
    return offset + br.read(extra) + 1;
}

bool VP8L::decode_data(std::vector<uint32_t>& data, int width, int height,
                       std::vector<HTreeGroup>& groups,
                       const std::vector<uint32_t>& meta, int meta_bits,
                       int meta_xsize, int cache_bits) {
    const size_t total = (size_t)width * height;
    std::vector<uint32_t> cache(cache_bits > 0 ? 1u << cache_bits : 0, 0);
    const int len_limit = 256 + 24;
    const int cache_limit = len_limit + (int)cache.size();
    size_t src = 0, last_cached = 0;
    int col = 0, row = 0;
    auto insert_cache = [&]() {
        if (cache_bits > 0)
            while (last_cached < src) {
                const uint32_t argb = data[last_cached++];
                cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
            }
    };
    auto group_at = [&](int c, int r) -> HTreeGroup& {
        if (meta_bits == 0) return groups[0];
        return groups[meta[(size_t)meta_xsize * (r >> meta_bits) + (c >> meta_bits)]];
    };
    while (src < total) {
        HTreeGroup& g = group_at(col, row);
        const int code = g.codes[0].read(br);
        if (br.at_end()) break;
        if (code < 256) {
            const int red = g.codes[1].read(br);
            const int blue = g.codes[2].read(br);
            const int alpha = g.codes[3].read(br);
            if (br.at_end()) break;
            data[src] = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
        } else if (code < len_limit) {
            const int length = copy_distance(code - 256, br);
            const int dist_sym = g.codes[4].read(br);
            const int dist_code = copy_distance(dist_sym, br);
            int dist;
            if (dist_code > 120) {
                dist = dist_code - 120;
            } else {
                const int dc = kCodeToPlane[dist_code - 1];
                const int yoff = dc >> 4, xoff = 8 - (dc & 0xf);
                dist = yoff * width + xoff;
                if (dist < 1) dist = 1;
            }
            if (br.at_end()) break;
            if (src < (size_t)dist || total - src < (size_t)length) return false;
            for (int i = 0; i < length; ++i) data[src + i] = data[src + i - dist];
            src += length;
            col += length;
            while (col >= width) {
                col -= width;
                ++row;
            }
            insert_cache();
            continue;
        } else if (code < cache_limit) {
            insert_cache();
            data[src] = cache[code - len_limit];
        } else {
            return false;
        }
        ++src;
        if (++col >= width) {
            col = 0;
            ++row;
            insert_cache();
        }
    }
    if (br.at_end()) {
        br.eos = 1;
        return false;
    }
    return true;
}

inline uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t select_px(uint32_t a, uint32_t b, uint32_t c) {  // T, L, TL
    int d = 0;
    for (int s = 0; s < 32; s += 8) {
        const int aa = (a >> s) & 0xff, bb = (b >> s) & 0xff, cc = (c >> s) & 0xff;
        d += std::abs(bb - cc) - std::abs(aa - cc);
    }
    return d <= 0 ? a : b;
}
inline uint32_t clamp_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t v = 0;
    for (int s = 0; s < 32; s += 8)
        v |= (uint32_t)clip255((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) -
                               (int)((c2 >> s) & 0xff)) << s;
    return v;
}
inline uint32_t clamp_half(uint32_t c0, uint32_t c1) {
    const uint32_t ave = c0;   // caller passes the average
    uint32_t v = 0;
    for (int s = 0; s < 32; s += 8) {
        const int a = (ave >> s) & 0xff, b = (c1 >> s) & 0xff;
        v |= (uint32_t)clip255(a + (a - b) / 2) << s;
    }
    return v;
}
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

uint32_t predict(int mode, const uint32_t* px, int width) {
    const uint32_t L = px[-1], T = px[-width], TL = px[-width - 1],
                   TR = px[-width + 1];
    switch (mode) {
        case 1: return L;
        case 2: return T;
        case 3: return TR;
        case 4: return TL;
        case 5: return average2(average2(L, TR), T);
        case 6: return average2(L, TL);
        case 7: return average2(L, T);
        case 8: return average2(TL, T);
        case 9: return average2(T, TR);
        case 10: return average2(average2(L, TL), average2(T, TR));
        case 11: return select_px(T, L, TL);
        case 12: return clamp_full(L, T, TL);
        case 13: return clamp_half(average2(L, T), TL);
        default: return 0xff000000u;
    }
}

inline int color_delta(int8_t pred, int8_t color) {
    return ((int)pred * color) >> 5;
}

// inverse transforms, last read first, on the decoded ARGB image
void inverse_transforms(std::vector<Transform>& ts, std::vector<uint32_t>& px,
                        int height) {
    for (int k = (int)ts.size() - 1; k >= 0; --k) {
        Transform& t = ts[k];
        const int w = t.xsize;
        if (t.type == 0) {   // predictor
            const int tiles = subsample(w, t.bits);
            for (int y = 0; y < height; ++y)
                for (int x = 0; x < w; ++x) {
                    uint32_t* p = &px[(size_t)y * w + x];
                    uint32_t pred;
                    if (y == 0)
                        pred = x == 0 ? 0xff000000u : p[-1];
                    else if (x == 0)
                        pred = p[-w];
                    else
                        pred = predict((t.data[(size_t)(y >> t.bits) * tiles +
                                               (x >> t.bits)] >> 8) & 0xf,
                                       p, w);
                    *p = add_pixels(*p, pred);
                }
        } else if (t.type == 1) {   // cross colour
            const int tiles = subsample(w, t.bits);
            for (int y = 0; y < height; ++y)
                for (int x = 0; x < w; ++x) {
                    const uint32_t m = t.data[(size_t)(y >> t.bits) * tiles +
                                              (x >> t.bits)];
                    uint32_t& argb = px[(size_t)y * w + x];
                    const int8_t green = (int8_t)(argb >> 8);
                    int new_red = (argb >> 16) & 0xff;
                    int new_blue = argb & 0xff;
                    new_red += color_delta((int8_t)(m & 0xff), green);
                    new_red &= 0xff;
                    new_blue += color_delta((int8_t)((m >> 8) & 0xff), green);
                    new_blue += color_delta((int8_t)((m >> 16) & 0xff),
                                            (int8_t)new_red);
                    new_blue &= 0xff;
                    argb = (argb & 0xff00ff00u) | (new_red << 16) | new_blue;
                }
        } else if (t.type == 2) {   // subtract green
            for (auto& argb : px) {
                const uint32_t g = (argb >> 8) & 0xff;
                uint32_t rb = argb & 0x00ff00ffu;
                rb += (g << 16) | g;
                argb = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
            }
        } else {   // colour indexing
            const int bits_per_pixel = 8 >> t.bits;
            const int count_mask = (1 << t.bits) - 1;
            const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
            const int src_w = subsample(t.xsize, t.bits);
            std::vector<uint32_t> dst((size_t)t.xsize * height);
            for (int y = 0; y < height; ++y) {
                uint32_t packed = 0;
                const uint32_t* src = &px[(size_t)y * src_w];
                for (int x = 0; x < t.xsize; ++x) {
                    if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
                    dst[(size_t)y * t.xsize + x] = t.data[packed & bit_mask];
                    packed >>= bits_per_pixel;
                }
            }
            px.swap(dst);
        }
    }
}

// an ARGB image stream (the VP8L header read by the caller, or an ALPH
// payload): decoded and inverse-transformed, width x height
bool vp8l_image(VP8L& dec, int width, int height, std::vector<uint32_t>& px) {
    if (!dec.decode_stream(width, height, true, px)) return false;
    inverse_transforms(dec.transforms, px, height);
    return true;
}

bool vp8l_header(BitReaderL& br, int& w, int& h, int& alpha) {
    if (br.read(8) != 0x2f) return false;
    w = br.read(14) + 1;
    h = br.read(14) + 1;
    alpha = br.read(1);
    if (br.read(3) != 0) return false;
    return !br.eos;
}

// ALPH: raw, or VP8L-compressed in the green channel, then unfiltered
bool decode_alpha(const uint8_t* data, size_t size, int width, int height,
                  std::vector<uint8_t>& alpha) {
    if (size <= 1) return false;
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
    const int pre = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0) return false;
    const uint8_t* payload = data + 1;
    const size_t n = size - 1;
    std::vector<uint8_t> deltas((size_t)width * height);
    if (method == 0) {
        if (n < deltas.size()) return false;
        std::memcpy(deltas.data(), payload, deltas.size());
    } else {
        VP8L dec(payload, n);
        std::vector<uint32_t> px;
        if (!vp8l_image(dec, width, height, px)) return false;
        for (size_t i = 0; i < deltas.size(); ++i) deltas[i] = (px[i] >> 8) & 0xff;
    }
    // libwebp's unfilters (src/dsp/filters.c): a first row, or a
    // horizontal filter, predicts from the left (from the pixel above at
    // x = 0)
    alpha.assign(deltas.size(), 0);
    for (int y = 0; y < height; ++y) {
        const uint8_t* in = &deltas[(size_t)y * width];
        uint8_t* out = &alpha[(size_t)y * width];
        const uint8_t* prev = y > 0 ? out - width : nullptr;
        if (filter == 0) {
            std::memcpy(out, in, width);
        } else if (filter == 1 || prev == nullptr) {
            uint8_t pred = prev == nullptr ? 0 : prev[0];
            for (int i = 0; i < width; ++i) {
                out[i] = (uint8_t)(pred + in[i]);
                pred = out[i];
            }
        } else if (filter == 2) {
            for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + in[i]);
        } else {
            uint8_t top = prev[0], top_left = top, left = top;
            for (int i = 0; i < width; ++i) {
                top = prev[i];
                const int g = left + top - top_left;
                const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
                left = (uint8_t)(in[i] + pred);
                top_left = top;
                out[i] = left;
            }
        }
    }
    return true;
}

void set_msg(char* msg, int msglen, const char* what) {
    if (msglen > 0) {
        std::strncpy(msg, what, msglen - 1);
        msg[msglen - 1] = 0;
    }
}

}  // namespace

extern "C" {

// A VP8 key frame (the payload after its chunk header, `size` bytes as
// libwebp's decoder is handed them) with its ALPH payload (or none), as
// (height, width) RGBA rows of `stride` bytes. 0 on success.
int kt_vp8_decode(const uint8_t* data, long long size, const uint8_t* alph,
                  long long alph_size, int width, int height, uint8_t* out,
                  long long stride, char* msg, int msglen) {
    try {
        VP8 d;
        vp8_decode(data, (size_t)size, d);
        if (d.width != width || d.height != height)
            fail("frame size differs from the container's");
        std::vector<uint8_t> alpha;
        if (alph != nullptr && !decode_alpha(alph, (size_t)alph_size, width,
                                             height, alpha))
            fail("Could not decode alpha data.");
        emit_fancy_rgba(d, out, stride);
        if (!alpha.empty())
            for (int y = 0; y < height; ++y)
                for (int x = 0; x < width; ++x)
                    out[y * stride + 4 * x + 3] = alpha[(size_t)y * width + x];
        return kOk;
    } catch (const Fail& f) {
        set_msg(msg, msglen, f.what);
        return kError;
    }
}

// A VP8L image (the payload after its chunk header) as RGBA rows.
int kt_vp8l_decode(const uint8_t* data, long long size, int width, int height,
                   uint8_t* out, long long stride, char* msg, int msglen) {
    VP8L dec(data, (size_t)size);
    int w, h, a;
    if (!vp8l_header(dec.br, w, h, a) || w != width || h != height) {
        set_msg(msg, msglen, "bad VP8L header");
        return kError;
    }
    std::vector<uint32_t> px;
    if (!vp8l_image(dec, width, height, px)) {
        set_msg(msg, msglen, "corrupt VP8L data");
        return kError;
    }
    for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) {
            const uint32_t argb = px[(size_t)y * width + x];
            uint8_t* o = out + y * stride + 4 * x;
            o[0] = (argb >> 16) & 0xff;
            o[1] = (argb >> 8) & 0xff;
            o[2] = argb & 0xff;
            o[3] = argb >> 24;
        }
    return kOk;
}

}  // extern "C"
