// LAB -> RGBA as PIL 12.1.0's `convert("RGBA")` of a LAB image gives it:
// LittleCMS 2.17's transform from `createProfile("LAB")` (a D50 V2 Lab
// profile) to its built-in sRGB profile, 8-bit LabV2 in, 8-bit RGBA out,
// perceptual intent, flags 0 (scene/lab.py).
//
// lcms links the two profiles into a float pipeline (Lab -> XYZ, the
// inverse of sRGB's colorant matrix, the inverse sRGB curve; the Lab
// profile's identity CLUT is removed, and neither black point calls for
// compensation), then resamples it into a 33^3 16-bit CLUT
// (OptimizeByResampling: each node evaluated in float32 stages and
// quantised as _cmsQuickSaturateWord does) that the transform reads by
// tetrahedral interpolation in 16-bit fixed point (its sums in 64 bits
// here: lcms's 32-bit ones never overflow on this table, which the tests
// check on every input). An 8-bit channel v
// enters as v * 257 and leaves as (w * 65281 + 2^23) >> 24. The white
// point fixup finds Lab white off the grid and changes nothing.
//
// Built with g++ at first use (hostlib.load) and called through ctypes;
// -O2 without -march keeps every double and float operation unfused.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kGrid = 33;

typedef double Mat3[3][3];

// _cmsMAT3inverse
void inverse(const Mat3 a, Mat3 b) {
    double c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
    double c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0];
    double c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
    double det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2;
    b[0][0] = c0 / det;
    b[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det;
    b[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det;
    b[1][0] = c1 / det;
    b[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det;
    b[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det;
    b[2][0] = c2 / det;
    b[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det;
    b[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det;
}

// _cmsMAT3eval
void eval(const Mat3 a, const double v[3], double r[3]) {
    for (int i = 0; i < 3; ++i)
        r[i] = a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2];
}

// _cmsMAT3per: r = a b
void per(const Mat3 a, const Mat3 b, Mat3 r) {
    Mat3 t;
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            t[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] +
                      a[i][2] * b[2][j];
    std::memcpy(r, t, sizeof(Mat3));
}

const double kD50[3] = {0.9642, 1.0, 0.8249};

// cmsCreate_sRGBProfile's colorant matrix (RGB -> XYZ, columns R, G, B):
// _cmsBuildRGB2XYZtransferMatrix of the Rec. 709 primaries and D65
// (x 0.3127, y 0.3290), adapted to D50 by Bradford (_cmsAdaptMatrixToD50).
void srgb_colorants(Mat3 out) {
    const double xn = 0.3127, yn = 0.3290;
    const double xr = 0.64, yr = 0.33, xg = 0.30, yg = 0.60, xb = 0.15,
                 yb = 0.06;
    Mat3 prim = {{xr, xg, xb}, {yr, yg, yb},
                 {(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)}};
    Mat3 inv;
    inverse(prim, inv);
    double white[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn}, coef[3];
    eval(inv, white, coef);
    Mat3 r = {{coef[0] * xr, coef[1] * xg, coef[2] * xb},
              {coef[0] * yr, coef[1] * yg, coef[2] * yb},
              {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
               coef[2] * (1.0 - xb - yb)}};
    // cmsxyY2XYZ of the white (Y 1), then ComputeChromaticAdaptation
    double dn[3] = {(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0};
    Mat3 brad = {{0.8951, 0.2664, -0.1614},
                 {-0.7502, 1.7135, 0.0367},
                 {0.0389, -0.0685, 1.0296}};
    Mat3 brad_inv;
    inverse(brad, brad_inv);
    double src[3], dst[3];
    eval(brad, dn, src);
    eval(brad, kD50, dst);
    Mat3 cone = {{dst[0] / src[0], 0.0, 0.0},
                 {0.0, dst[1] / src[1], 0.0},
                 {0.0, 0.0, dst[2] / src[2]}};
    Mat3 tmp, conv;
    per(cone, brad, tmp);
    per(brad_inv, tmp, conv);
    per(conv, r, out);
}

// cmsLab2XYZ's f^-1
double f_1(double t) {
    const double limit = 24.0 / 116.0;
    if (t <= limit) return (108.0 / 841.0) * (t - (16.0 / 116.0));
    return t * t * t;
}

// the sRGB curve's analytic inverse, parametric type -4
double inv_srgb(double r) {
    const double g = 2.4, a = 1. / 1.055, b = 0.055 / 1.055, c = 1. / 12.92,
                 d = 0.04045;
    double e = a * d + b;
    double disc = e < 0 ? 0 : std::pow(e, g);
    if (r >= disc) return (std::pow(r, 1.0 / g) - b) / a;
    return r / c;
}

// _cmsQuickSaturateWord, its floor through the 16.16 magic number
uint16_t quick_saturate_word(double d) {
    d += 0.5;
    if (d <= 0) return 0;
    if (d >= 65535.0) return 0xffff;
    double t = (d - 32767.0) + 68719476736.0 * 1.5;
    uint64_t bits;
    std::memcpy(&bits, &t, sizeof bits);
    int32_t low = (int32_t)(uint32_t)bits;
    return (uint16_t)((low >> 16) + 32767);
}

int to_fixed(int a) { return a + ((a + 0x7fff) / 0xffff); }

}  // namespace

extern "C" {

// The CLUT's kGrid^3 nodes (L slowest, then a, then b) of 3 words each.
void kt_lab_nodes(uint16_t* out) {
    const double enc = 1.0 + 32767.0 / 32768.0;  // MAX_ENCODEABLE_XYZ
    Mat3 m, inv;
    srgb_colorants(m);
    inverse(m, inv);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) inv[i][j] *= enc;
    uint16_t q[kGrid];
    for (int i = 0; i < kGrid; ++i)  // _cmsQuantizeVal
        q[i] = quick_saturate_word(i * 65535. / (kGrid - 1));
    for (int i = 0; i < kGrid; ++i)
        for (int j = 0; j < kGrid; ++j)
            for (int k = 0; k < kGrid; ++k) {
                // XFormSampler16: the node's words as float32
                float in[3] = {(float)(q[i] / 65535.0),
                               (float)(q[j] / 65535.0),
                               (float)(q[k] / 65535.0)};
                // EvaluateLab2XYZ (V4 encoding)
                double L = in[0] * 100.0, A = in[1] * 255.0 - 128.0,
                       B = in[2] * 255.0 - 128.0;
                double y = (L + 16.0) / 116.0;
                double x = y + 0.002 * A, z = y - 0.005 * B;
                float xyz[3] = {(float)(f_1(x) * kD50[0] / enc),
                                (float)(f_1(y) * kD50[1] / enc),
                                (float)(f_1(z) * kD50[2] / enc)};
                uint16_t* o = out + 3 * ((i * kGrid + j) * kGrid + k);
                for (int c = 0; c < 3; ++c) {
                    double t = 0;  // EvaluateMatrix
                    for (int s = 0; s < 3; ++s) t += xyz[s] * inv[c][s];
                    float rgb = (float)t;
                    float v = (float)inv_srgb(rgb);  // EvaluateCurves
                    o[c] = quick_saturate_word(v * 65535.0);
                }
            }
}

// n pixels of PIL's LAB storage (L, a + 128, b + 128, pad) -> RGBA, the
// pad byte becoming alpha as PIL's pyCMScopyAux copies it.
void kt_lab_to_rgba(const uint8_t* px, long long n, const uint16_t* nodes,
                    uint8_t* out) {
    const int oz = 3, oy = 3 * kGrid, ox = 3 * kGrid * kGrid;
    for (long long p = 0; p < n; ++p) {
        const uint8_t* s = px + 4 * p;
        int in[3] = {s[0] * 257, s[1] * 257, s[2] * 257};
        int f[3], r[3], i0[3];
        for (int c = 0; c < 3; ++c) {
            f[c] = to_fixed(in[c] * (kGrid - 1));
            i0[c] = f[c] >> 16;
            r[c] = f[c] & 0xffff;
        }
        int rx = r[0], ry = r[1], rz = r[2];
        int X1 = in[0] == 0xffff ? 0 : ox, Y1 = in[1] == 0xffff ? 0 : oy,
            Z1 = in[2] == 0xffff ? 0 : oz;
        const uint16_t* t = nodes + i0[0] * ox + i0[1] * oy + i0[2] * oz;
        // TetrahedralInterp16
        int a1, a2, a3;
        if (rx >= ry) {
            if (ry >= rz) {
                a1 = X1; a2 = X1 + Y1; a3 = X1 + Y1 + Z1;
            } else if (rz >= rx) {
                a1 = X1 + Z1; a2 = X1 + Y1 + Z1; a3 = Z1;
            } else {
                a1 = X1; a2 = X1 + Y1 + Z1; a3 = X1 + Z1;
            }
        } else {
            if (rx >= rz) {
                a1 = X1 + Y1; a2 = Y1; a3 = X1 + Y1 + Z1;
            } else if (ry >= rz) {
                a1 = X1 + Y1 + Z1; a2 = Y1; a3 = Y1 + Z1;
            } else {
                a1 = X1 + Y1 + Z1; a2 = Y1 + Z1; a3 = Z1;
            }
        }
        uint8_t* o = out + 4 * p;
        for (int c = 0; c < 3; ++c) {
            long long c0 = t[c], c1 = t[a1 + c], c2 = t[a2 + c],
                      c3 = t[a3 + c];
            long long rest;
            if (rx >= ry) {
                if (ry >= rz)
                    rest = (c1 - c0) * rx + (c2 - c1) * ry + (c3 - c2) * rz;
                else if (rz >= rx)
                    rest = (c1 - c3) * rx + (c2 - c1) * ry + (c3 - c0) * rz;
                else
                    rest = (c1 - c0) * rx + (c2 - c3) * ry + (c3 - c1) * rz;
            } else {
                if (rx >= rz)
                    rest = (c1 - c2) * rx + (c2 - c0) * ry + (c3 - c1) * rz;
                else if (ry >= rz)
                    rest = (c1 - c3) * rx + (c2 - c0) * ry + (c3 - c2) * rz;
                else
                    rest = (c1 - c2) * rx + (c2 - c3) * ry + (c3 - c0) * rz;
            }
            rest += 0x8001;
            unsigned w = (uint16_t)(c0 + ((rest + (rest >> 16)) >> 16));
            o[c] = (uint8_t)(((w * 65281u + 8388608u) >> 24) & 0xff);
        }
        o[3] = s[3];
    }
}

}  // extern "C"
