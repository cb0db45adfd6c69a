// JPEG 2000 (ITU-T T.800 / ISO/IEC 15444-1) tile decoding and a lossless
// encoder, for scene/j2k.py, as OpenJPEG 2.5.4 computes them.
//
// Python parses the codestream's markers and gathers each tile's data;
// kt_j2k_decode_tile then does the rest of one tile:
//  - tier 2: the packet iterator (LRCP, RLCP, RPCL, PCRL, CPRL, POC),
//    packet headers (tag trees, inclusion, zero bit-planes, pass counts,
//    Lblock, code-word segment lengths; SOP / EPH; headers from PPM / PPT);
//  - tier 1: the MQ decoder (T.800 Table C.2, with the two 0xFF bytes the
//    decoder meets past a segment's end), the three coding passes with
//    Annex D's context rules, and every Part 1 code-block style (BYPASS,
//    RESET, TERMALL, VSC, PTERM, SEGSYM), ROI maxshift;
//  - dequantisation (the reversible path's halving, the irreversible
//    step size in double, its product in float32);
//  - the inverse 5/3 (integer lifting) and 9/7 (float32 lifting, OpenJPEG's
//    constants and order, its 2 / K high-pass scale) transforms, RCT / ICT,
//    the DC level shift with lrintf and the clamp to the component's range.
// Code-blocks decode on several threads; each writes only its own samples,
// so the output does not depend on the thread count.
//
// Build with -ffp-contract=off (no fused multiply-adds: every float32
// operation rounds on its own, as OpenJPEG's SSE code does) and -fwrapv
// (OpenJPEG's int32 sums wrap).
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// the MQ coder's probability states, T.800 Table C.2: Qe, NMPS, NLPS, SWITCH
// ---------------------------------------------------------------------------
struct QeState { uint32_t qe; uint8_t nmps, nlps, sw; };
const QeState QE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run length,
// 18 uniform
enum { CX_ZC = 0, CX_SC = 9, CX_MAG = 14, CX_RL = 17, CX_UNI = 18, NCX = 19 };

struct Contexts {
    uint8_t st[NCX], mps[NCX];
    void reset() {
        std::memset(st, 0, sizeof st);
        std::memset(mps, 0, sizeof mps);
        st[CX_UNI] = 46;
        st[CX_RL] = 3;
        st[CX_ZC] = 4;
    }
};

// C.3: the decoder reads a segment followed by the two 0xFF bytes OpenJPEG
// writes past its end, so that it stops there (adding 0xFF00 each time).
struct MqDec {
    const uint8_t* d = nullptr;
    int64_t len = 0, bp = 0;
    uint32_t a = 0, c = 0;
    int ct = 0;
    int at(int64_t i) const { return i < len ? d[i] : 0xFF; }
    void bytein() {
        if (at(bp) == 0xFF) {
            if (at(bp + 1) > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                bp++;
                c += (uint32_t)at(bp) << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += (uint32_t)at(bp) << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* data, int64_t n) {
        d = data;
        len = n;
        bp = 0;
        c = (uint32_t)at(0) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    int decode(Contexts& cx, int k) {
        const QeState& s = QE[cx.st[k]];
        int d;
        a -= s.qe;
        if ((c >> 16) < s.qe) {
            if (a < s.qe) {
                d = cx.mps[k];
                cx.st[k] = s.nmps;
            } else {
                d = 1 - cx.mps[k];
                if (s.sw) cx.mps[k] ^= 1;
                cx.st[k] = s.nlps;
            }
            a = s.qe;
            renorm();
        } else {
            c -= s.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) {
                    d = 1 - cx.mps[k];
                    if (s.sw) cx.mps[k] ^= 1;
                    cx.st[k] = s.nlps;
                } else {
                    d = cx.mps[k];
                    cx.st[k] = s.nmps;
                }
                renorm();
            } else {
                d = cx.mps[k];
            }
        }
        return d;
    }
    // BYPASS segments: raw bits, with the same stop at 0xFF > 0x8F
    void raw_init(const uint8_t* data, int64_t n) {
        d = data;
        len = n;
        bp = 0;
        c = 0;
        ct = 0;
    }
    int raw() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (at(bp) > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = at(bp);
                    bp++;
                    ct = 7;
                }
            } else {
                c = at(bp);
                bp++;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1;
    }
};

// ---------------------------------------------------------------------------
// Annex D's context labels, computed from its rules
// ---------------------------------------------------------------------------
// zero coding (Table D.1) by band (0 LL, 1 HL, 2 LH, 3 HH) and the counts of
// significant horizontal (0-2), vertical (0-2) and diagonal (0-4) neighbours
uint8_t ZC[4][3][3][5];
// sign coding (Table D.3) by the clamped horizontal and vertical
// contributions (+1 each): context and the bit to xor
uint8_t SC_CX[3][3], SC_XOR[3][3];

int zc_rule(int band, int h, int v, int d) {
    if (band == 1) std::swap(h, v);
    if (band == 3) {
        int hv = h + v;
        if (d >= 3) return 8;
        if (d == 2) return hv >= 1 ? 7 : 6;
        if (d == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
        return hv >= 2 ? 2 : hv;
    }
    if (h == 2) return 8;
    if (h == 1) return v >= 1 ? 7 : d >= 1 ? 6 : 5;
    if (v == 2) return 4;
    if (v == 1) return 3;
    return d >= 2 ? 2 : d;
}

struct TablesInit {
    TablesInit() {
        for (int b = 0; b < 4; b++)
            for (int h = 0; h < 3; h++)
                for (int v = 0; v < 3; v++)
                    for (int d = 0; d < 5; d++) ZC[b][h][v][d] = zc_rule(b, h, v, d);
        for (int h = -1; h <= 1; h++)
            for (int v = -1; v <= 1; v++) {
                int cx, x = 0;
                int hh = h, vv = v;
                if (hh < 0 || (hh == 0 && vv < 0)) {
                    hh = -hh;
                    vv = -vv;
                    x = 1;
                }
                // now (hh, vv) in {(1,1),(1,0),(1,-1),(0,1),(0,0)}
                if (hh == 1) cx = vv == 1 ? 13 : vv == 0 ? 12 : 11;
                else cx = vv == 1 ? 10 : 9;
                SC_CX[h + 1][v + 1] = (uint8_t)cx;
                SC_XOR[h + 1][v + 1] = (uint8_t)x;
            }
    }
} tables_init;

// ---------------------------------------------------------------------------
// tier 1: one code-block
// ---------------------------------------------------------------------------
enum { SIG = 1, NEG = 2, PI = 4, MU = 8 };
enum {
    STY_LAZY = 1, STY_RESET = 2, STY_TERMALL = 4, STY_VSC = 8,
    STY_PTERM = 16, STY_SEGSYM = 32
};

struct Seg {
    int64_t len = 0;
    int numpasses = 0, maxpasses = 0, numnewpasses = 0;
    int64_t newlen = 0;
};

struct Cblk {
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    int32_t numbps = 0;
    uint32_t numlenbits = 0;
    int numnewpasses = 0;
    int numsegs = 0;
    std::vector<Seg> segs;
    std::vector<std::pair<const uint8_t*, int64_t>> chunks;
};

// the neighbour mask of a sample: which of its eight neighbours are
// significant
enum { NB_W = 1, NB_E = 2, NB_N = 4, NB_S = 8, NB_NW = 16, NB_NE = 32,
       NB_SW = 64, NB_SE = 128 };
// zero coding context by band and neighbour mask
uint8_t ZC8[4][256];
struct Zc8Init {
    Zc8Init() {
        for (int b = 0; b < 4; b++)
            for (int m = 0; m < 256; m++) {
                int hc = !!(m & NB_W) + !!(m & NB_E), vc = !!(m & NB_N) + !!(m & NB_S);
                int dc = !!(m & NB_NW) + !!(m & NB_NE) + !!(m & NB_SW) + !!(m & NB_SE);
                ZC8[b][m] = ZC[b][hc][vc][dc];
            }
    }
} zc8_init;

struct T1 {
    int w = 0, h = 0, stride = 0;
    std::vector<uint8_t> f;      // (w + 2) x (h + 2) flags
    std::vector<uint8_t> nb;     // (w + 2) x (h + 2) neighbour masks
    std::vector<int32_t> data;   // w x h
    bool vsc = false;
    int band = 0;
    MqDec mq;
    Contexts cx;

    void reset(int w_, int h_, int band_, bool vsc_) {
        w = w_;
        h = h_;
        stride = w + 2;
        f.assign((size_t)(w + 2) * (h + 2), 0);
        nb.assign((size_t)(w + 2) * (h + 2), 0);
        band = band_;
        vsc = vsc_;
        cx.reset();
    }
    size_t at(int x, int y) const { return (size_t)(y + 1) * stride + x + 1; }
    uint8_t& F(int x, int y) { return f[at(x, y)]; }
    // the mask a sample sees: with VSC, the last row of a stripe does not
    // see the row below
    int mask(int x, int y) const {
        int m = nb[at(x, y)];
        if (vsc && (y & 3) == 3) m &= ~(NB_S | NB_SW | NB_SE);
        return m;
    }
    bool any_neighbour(int x, int y) const { return mask(x, y) != 0; }
    int zc(int x, int y) const { return ZC8[band][mask(x, y)]; }
    static int contrib(uint8_t n) { return (n & SIG) ? ((n & NEG) ? -1 : 1) : 0; }
    void sc(int x, int y, int& ctx, int& xr) {
        const uint8_t* r = &f[at(x, y)];
        bool below = !(vsc && (y & 3) == 3);
        int hs = contrib(r[-1]) + contrib(r[1]);
        int vs = contrib(r[-stride]) + (below ? contrib(r[stride]) : 0);
        hs = hs > 0 ? 1 : hs < 0 ? -1 : 0;
        vs = vs > 0 ? 1 : vs < 0 ? -1 : 0;
        ctx = SC_CX[hs + 1][vs + 1];
        xr = SC_XOR[hs + 1][vs + 1];
    }
    void set_sig(int x, int y, int neg) {
        size_t i = at(x, y);
        f[i] |= SIG | (neg ? NEG : 0);
        uint8_t* n = &nb[i];
        n[-1] |= NB_E;
        n[1] |= NB_W;
        n[-stride] |= NB_S;
        n[stride] |= NB_N;
        n[-stride - 1] |= NB_SE;
        n[-stride + 1] |= NB_SW;
        n[stride - 1] |= NB_NE;
        n[stride + 1] |= NB_NW;
    }
    void make_sig(int x, int y, int neg, int32_t oph) {
        data[(size_t)y * w + x] = neg ? -oph : oph;
        set_sig(x, y, neg);
    }
    void decode_sign(int x, int y, int32_t oph) {
        int ctx, xr;
        sc(x, y, ctx, xr);
        int v = mq.decode(cx, ctx) ^ xr;
        make_sig(x, y, v, oph);
    }

    void sigpass(int bp, bool raw) {
        int32_t one = (int32_t)(1u << bp), oph = one | (one >> 1);
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; x++)
                for (int y = k; y < std::min(k + 4, h); y++) {
                    uint8_t& fl = F(x, y);
                    if ((fl & (SIG | PI)) || !any_neighbour(x, y)) continue;
                    if (raw) {
                        if (mq.raw()) make_sig(x, y, mq.raw(), oph);
                    } else if (mq.decode(cx, CX_ZC + zc(x, y))) {
                        decode_sign(x, y, oph);
                    }
                    F(x, y) |= PI;
                }
    }
    void refpass(int bp, bool raw) {
        int32_t poshalf = (int32_t)((1u << bp) >> 1);
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; x++)
                for (int y = k; y < std::min(k + 4, h); y++) {
                    uint8_t& fl = F(x, y);
                    if ((fl & (SIG | PI)) != SIG) continue;
                    int v;
                    if (raw) {
                        v = mq.raw();
                    } else {
                        int ctx = (fl & MU) ? CX_MAG + 2
                                  : any_neighbour(x, y) ? CX_MAG + 1 : CX_MAG;
                        v = mq.decode(cx, ctx);
                    }
                    int32_t& d = data[(size_t)y * w + x];
                    d += (v ^ (d < 0)) ? poshalf : -poshalf;
                    F(x, y) |= MU;
                }
    }
    void clnstep(int x, int y, int32_t oph, bool partial) {
        if (!partial && !mq.decode(cx, CX_ZC + zc(x, y))) return;
        decode_sign(x, y, oph);
    }
    void clnpass(int bp, bool segsym) {
        int32_t one = (int32_t)(1u << bp), oph = one | (one >> 1);
        int k = 0;
        for (; k + 4 <= h; k += 4)
            for (int x = 0; x < w; x++) {
                bool run = true;
                for (int y = k; y < k + 4 && run; y++)
                    run = !(F(x, y) & (SIG | PI)) && !any_neighbour(x, y);
                int first = k;
                bool partial = false;
                if (run) {
                    if (!mq.decode(cx, CX_RL)) {
                        for (int y = k; y < k + 4; y++) F(x, y) &= ~PI;
                        continue;
                    }
                    int r = mq.decode(cx, CX_UNI);
                    r = (r << 1) | mq.decode(cx, CX_UNI);
                    first = k + r;
                    partial = true;
                }
                for (int y = first; y < k + 4; y++) {
                    if (partial) {
                        clnstep(x, y, oph, true);
                        partial = false;
                    } else if (!(F(x, y) & (SIG | PI))) {
                        clnstep(x, y, oph, false);
                    }
                }
                for (int y = k; y < k + 4; y++) F(x, y) &= ~PI;
            }
        if (k < h)
            for (int x = 0; x < w; x++) {
                for (int y = k; y < h; y++)
                    if (!(F(x, y) & (SIG | PI))) clnstep(x, y, oph, false);
                for (int y = k; y < h; y++) F(x, y) &= ~PI;
            }
        if (segsym)
            for (int i = 0; i < 4; i++) mq.decode(cx, CX_UNI);
    }
};

// ---------------------------------------------------------------------------
// tier 2: tag trees and the packet header bit reader
// ---------------------------------------------------------------------------
struct TagTree {
    std::vector<int> parent, value, low;
    void build(int w, int h) {
        std::vector<int> lw, lh, off;
        int n, total = 0;
        lw.push_back(w);
        lh.push_back(h);
        do {
            n = lw.back() * lh.back();
            off.push_back(total);
            total += n;
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        } while (n > 1);
        int levels = (int)off.size();
        parent.assign(total, -1);
        for (int l = 0; l + 1 < levels; l++)
            for (int y = 0; y < lh[l]; y++)
                for (int x = 0; x < lw[l]; x++)
                    parent[off[l] + y * lw[l] + x] =
                        off[l + 1] + (y / 2) * lw[l + 1] + x / 2;
        value.assign(total, 999);
        low.assign(total, 0);
    }
};

struct Bio {
    const uint8_t* start;
    const uint8_t* end;
    const uint8_t* bp;
    uint32_t buf = 0;
    int ct = 0;
    Bio(const uint8_t* s, int64_t n) : start(s), end(s + n), bp(s) {}
    void bytein() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        if (bp >= end) return;
        buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = n - 1; i >= 0; i--) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xFF) == 0xFF) bytein();
        ct = 0;
    }
    int64_t numbytes() const { return bp - start; }
};

uint32_t tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
    int stk[64], n = 0;
    int node = leaf;
    while (t.parent[node] >= 0) {
        stk[n++] = node;
        node = t.parent[node];
    }
    int low = 0;
    for (;;) {
        if (low > t.low[node]) t.low[node] = low;
        else low = t.low[node];
        while (low < threshold && low < t.value[node]) {
            if (bio.read(1)) t.value[node] = low;
            else ++low;
        }
        t.low[node] = low;
        if (n == 0) break;
        node = stk[--n];
    }
    return t.value[node] < threshold ? 1 : 0;
}

uint32_t numpasses(Bio& bio) {
    uint32_t n;
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    if ((n = bio.read(2)) != 3) return 3 + n;
    if ((n = bio.read(5)) != 31) return 6 + n;
    return 37 + bio.read(7);
}

int floorlog2(uint32_t a) {
    int l = 0;
    while (a > 1) {
        a >>= 1;
        l++;
    }
    return l;
}

// ---------------------------------------------------------------------------
// the tile's structure (B.5 - B.7 as OpenJPEG's tcd lays it out)
// ---------------------------------------------------------------------------
int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, int b) { return (a + ((int64_t)1 << b) - 1) >> b; }
int64_t floordivpow2(int64_t a, int b) { return a >> b; }

struct Prec {
    int x0, y0, x1, y1, cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    int bandno = 0;
    int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    int32_t numbps = 0;
    float stepsize = 0;
    std::vector<Prec> precs;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
    int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    int pw = 0, ph = 0, pdx = 15, pdy = 15, numbands = 0;
    Band bands[3];
};

// one component's coding parameters, as j2k.py packs them
enum {
    P_DX, P_DY, P_PREC, P_SGND, P_NUMRES, P_CBLKW, P_CBLKH, P_CBLKSTY,
    P_QMFBID, P_QNTSTY, P_NUMGBITS, P_ROISHIFT, P_PRCW, P_PRCH = P_PRCW + 33,
    P_EXPN = P_PRCH + 33, P_MANT = P_EXPN + 97, P_COMP_STRIDE = P_MANT + 97
};
// the tile's
enum {
    T_X0, T_Y0, T_X1, T_Y1, T_NUMCOMPS, T_NUMLAYERS, T_PRG, T_CSTY, T_MCT,
    T_HEADERS, T_NUMPOCS, T_POCS
};

struct Comp {
    const int32_t* p;
    int64_t x0, y0, x1, y1;
    int numres;
    std::vector<Res> res;
    std::vector<int32_t> idata;
    std::vector<float> fdata;
    int64_t w() const { return x1 - x0; }
    int64_t h() const { return y1 - y0; }
};

struct Error {
    int code;        // 1: OpenJPEG fails (white), 2: not modelled
    std::string msg;
};

void build_comp(Comp& c, const int32_t* tp) {
    const int32_t* p = c.p;
    c.x0 = ceildiv(tp[T_X0], p[P_DX]);
    c.y0 = ceildiv(tp[T_Y0], p[P_DY]);
    c.x1 = ceildiv(tp[T_X1], p[P_DX]);
    c.y1 = ceildiv(tp[T_Y1], p[P_DY]);
    c.numres = p[P_NUMRES];
    c.res.resize(c.numres);
    int prec = p[P_PREC];
    for (int r = 0; r < c.numres; r++) {
        Res& R = c.res[r];
        int level = c.numres - 1 - r;
        R.x0 = ceildivpow2(c.x0, level);
        R.y0 = ceildivpow2(c.y0, level);
        R.x1 = ceildivpow2(c.x1, level);
        R.y1 = ceildivpow2(c.y1, level);
        R.pdx = p[P_PRCW + r];
        R.pdy = p[P_PRCH + r];
        int64_t px0 = floordivpow2(R.x0, R.pdx) << R.pdx;
        int64_t py0 = floordivpow2(R.y0, R.pdy) << R.pdy;
        int64_t px1 = ceildivpow2(R.x1, R.pdx) << R.pdx;
        int64_t py1 = ceildivpow2(R.y1, R.pdy) << R.pdy;
        R.pw = R.x0 == R.x1 ? 0 : (int)((px1 - px0) >> R.pdx);
        R.ph = R.y0 == R.y1 ? 0 : (int)((py1 - py0) >> R.pdy);
        int64_t cbgx0, cbgy0;
        int cbgw, cbgh;
        if (r == 0) {
            cbgx0 = px0;
            cbgy0 = py0;
            cbgw = R.pdx;
            cbgh = R.pdy;
            R.numbands = 1;
        } else {
            cbgx0 = ceildivpow2(px0, 1);
            cbgy0 = ceildivpow2(py0, 1);
            cbgw = R.pdx - 1;
            cbgh = R.pdy - 1;
            R.numbands = 3;
        }
        int cbw = std::min(p[P_CBLKW], cbgw), cbh = std::min(p[P_CBLKH], cbgh);
        for (int b = 0; b < R.numbands; b++) {
            Band& B = R.bands[b];
            if (r == 0) {
                B.bandno = 0;
                B.x0 = ceildivpow2(c.x0, level);
                B.y0 = ceildivpow2(c.y0, level);
                B.x1 = ceildivpow2(c.x1, level);
                B.y1 = ceildivpow2(c.y1, level);
            } else {
                B.bandno = b + 1;
                int64_t xb = B.bandno & 1, yb = B.bandno >> 1;
                B.x0 = ceildivpow2(c.x0 - (xb << level), level + 1);
                B.y0 = ceildivpow2(c.y0 - (yb << level), level + 1);
                B.x1 = ceildivpow2(c.x1 - (xb << level), level + 1);
                B.y1 = ceildivpow2(c.y1 - (yb << level), level + 1);
            }
            int si = r == 0 ? 0 : 3 * (r - 1) + b + 1;
            int expn = p[P_EXPN + si], mant = p[P_MANT + si];
            // the decoder's nominal range ignores the band gain on the 9/7
            // path (OpenJPEG's two_invK compensation)
            int gain = p[P_QMFBID] == 0 ? 0 : B.bandno == 0 ? 0 : B.bandno == 3 ? 2 : 1;
            int rb = prec + gain;
            B.stepsize = (float)((1.0 + mant / 2048.0) * std::pow(2.0, (double)(rb - expn)));
            B.numbps = expn + p[P_NUMGBITS] - 1;
            int nprec = R.pw * R.ph;
            B.precs.resize(nprec);
            for (int pi = 0; pi < nprec; pi++) {
                Prec& P = B.precs[pi];
                int64_t sx = cbgx0 + (int64_t)(pi % R.pw) * ((int64_t)1 << cbgw);
                int64_t sy = cbgy0 + (int64_t)(pi / R.pw) * ((int64_t)1 << cbgh);
                int64_t ex = sx + ((int64_t)1 << cbgw), ey = sy + ((int64_t)1 << cbgh);
                P.x0 = (int)std::max(sx, B.x0);
                P.y0 = (int)std::max(sy, B.y0);
                P.x1 = (int)std::min(ex, B.x1);
                P.y1 = (int)std::min(ey, B.y1);
                int64_t tlx = floordivpow2(P.x0, cbw) << cbw;
                int64_t tly = floordivpow2(P.y0, cbh) << cbh;
                int64_t brx = ceildivpow2(P.x1, cbw) << cbw;
                int64_t bry = ceildivpow2(P.y1, cbh) << cbh;
                P.cw = (int)std::max<int64_t>(0, (brx - tlx) >> cbw);
                P.ch = (int)std::max<int64_t>(0, (bry - tly) >> cbh);
                int nb = P.cw * P.ch;
                P.cblks.resize(nb);
                for (int k = 0; k < nb; k++) {
                    Cblk& C = P.cblks[k];
                    int64_t cx = tlx + (int64_t)(k % P.cw) * ((int64_t)1 << cbw);
                    int64_t cy = tly + (int64_t)(k / P.cw) * ((int64_t)1 << cbh);
                    C.x0 = (int)std::max<int64_t>(cx, P.x0);
                    C.y0 = (int)std::max<int64_t>(cy, P.y0);
                    C.x1 = (int)std::min<int64_t>(cx + ((int64_t)1 << cbw), P.x1);
                    C.y1 = (int)std::min<int64_t>(cy + ((int64_t)1 << cbh), P.y1);
                }
                if (nb) {
                    P.incl.build(P.cw, P.ch);
                    P.imsb.build(P.cw, P.ch);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// the packet iterator (OpenJPEG's pi.c for a decoder: no tile-parts)
// ---------------------------------------------------------------------------
struct Packet { int lay, res, comp, prec; };

struct Poc { int res0, comp0, lay1, res1, comp1, prg; };

void iterate(const std::vector<Comp>& comps, const int32_t* tp, const Poc& poc,
             int maxres, int maxprec, std::vector<uint8_t>& include,
             std::vector<Packet>& out) {
    int numcomps = (int)comps.size();
    int64_t step_c = maxprec, step_r = (int64_t)numcomps * step_c,
            step_l = (int64_t)maxres * step_r;
    if (poc.comp0 >= numcomps || poc.comp1 >= numcomps + 1) return;
    auto emit = [&](int l, int r, int c, int p) -> bool {
        int64_t idx = l * step_l + r * step_r + c * step_c + p;
        if (idx >= (int64_t)include.size()) return false;
        if (!include[idx]) {
            include[idx] = 1;
            out.push_back({l, r, c, p});
        }
        return true;
    };
    int lay0 = 0, lay1 = poc.lay1;
    // the packets of one (layer, resolution): every component, precinct
    auto lr = [&](int l, int r) -> bool {
        for (int c = poc.comp0; c < poc.comp1; c++) {
            const Comp& C = comps[c];
            if (r >= C.numres) continue;
            int np = C.res[r].pw * C.res[r].ph;
            for (int p = 0; p < np; p++)
                if (!emit(l, r, c, p)) return false;
        }
        return true;
    };
    if (poc.prg == 0) {  // LRCP
        for (int l = lay0; l < lay1; l++)
            for (int r = poc.res0; r < poc.res1; r++)
                if (!lr(l, r)) return;
        return;
    }
    if (poc.prg == 1) {  // RLCP
        for (int r = poc.res0; r < poc.res1; r++)
            for (int l = lay0; l < lay1; l++)
                if (!lr(l, r)) return;
        return;
    }
    if (poc.prg > 4) return;
    uint64_t tx0 = (uint32_t)tp[T_X0], ty0 = (uint32_t)tp[T_Y0],
             tx1 = (uint32_t)tp[T_X1], ty1 = (uint32_t)tp[T_Y1];
    // the smallest precinct step on the reference grid, over the components
    // (CPRL: over one component)
    auto steps = [&](int c0, int c1, uint64_t& dx, uint64_t& dy) {
        dx = dy = 0;
        for (int c = c0; c < c1; c++) {
            const Comp& C = comps[c];
            for (int r = 0; r < C.numres; r++) {
                const Res& R = C.res[r];
                int lx = R.pdx + C.numres - 1 - r, ly = R.pdy + C.numres - 1 - r;
                if (lx < 32 && (uint64_t)C.p[P_DX] <= (0xFFFFFFFFull >> lx)) {
                    uint64_t v = (uint64_t)C.p[P_DX] << lx;
                    dx = dx ? std::min(dx, v) : v;
                }
                if (ly < 32 && (uint64_t)C.p[P_DY] <= (0xFFFFFFFFull >> ly)) {
                    uint64_t v = (uint64_t)C.p[P_DY] << ly;
                    dy = dy ? std::min(dy, v) : v;
                }
            }
        }
    };
    // the packets of (r, y, x, c), all layers, if the position starts a
    // precinct of that resolution; false when the include table overflows
    auto at = [&](int r, uint64_t y, uint64_t x, int c) -> bool {
        const Comp& C = comps[c];
        if (r >= C.numres) return true;
        const Res& R = C.res[r];
        int level = C.numres - 1 - r;
        uint64_t cdx = (uint64_t)C.p[P_DX], cdy = (uint64_t)C.p[P_DY];
        if ((((cdx << level) & 0xFFFFFFFFull) >> level) != cdx ||
            (((cdy << level) & 0xFFFFFFFFull) >> level) != cdy)
            return true;
        uint64_t trx0 = ceildiv(tx0, cdx << level), try0 = ceildiv(ty0, cdy << level);
        uint64_t trx1 = ceildiv(tx1, cdx << level), try1 = ceildiv(ty1, cdy << level);
        int rpx = R.pdx + level, rpy = R.pdy + level;
        if ((((cdx << rpx) & 0xFFFFFFFFull) >> rpx) != cdx ||
            (((cdy << rpy) & 0xFFFFFFFFull) >> rpy) != cdy)
            return true;
        if (!((y % (cdy << rpy) == 0) ||
              (y == ty0 && ((try0 << level) % ((uint64_t)1 << rpy)))))
            return true;
        if (!((x % (cdx << rpx) == 0) ||
              (x == tx0 && ((trx0 << level) % ((uint64_t)1 << rpx)))))
            return true;
        if (R.pw == 0 || R.ph == 0) return true;
        if (trx0 == trx1 || try0 == try1) return true;
        uint64_t prci = (ceildiv(x, cdx << level) >> R.pdx) - (trx0 >> R.pdx);
        uint64_t prcj = (ceildiv(y, cdy << level) >> R.pdy) - (try0 >> R.pdy);
        int p = (int)(prci + prcj * R.pw);
        for (int l = lay0; l < lay1; l++)
            if (!emit(l, r, c, p)) return false;
        return true;
    };
    uint64_t dx, dy;
    if (poc.prg == 2) {  // RPCL
        steps(0, numcomps, dx, dy);
        if (!dx || !dy) return;
        for (int r = poc.res0; r < poc.res1; r++)
            for (uint64_t y = ty0; y < ty1; y += dy - (y % dy))
                for (uint64_t x = tx0; x < tx1; x += dx - (x % dx))
                    for (int c = poc.comp0; c < poc.comp1; c++)
                        if (!at(r, y, x, c)) return;
    } else if (poc.prg == 3) {  // PCRL
        steps(0, numcomps, dx, dy);
        if (!dx || !dy) return;
        for (uint64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (uint64_t x = tx0; x < tx1; x += dx - (x % dx))
                for (int c = poc.comp0; c < poc.comp1; c++)
                    for (int r = poc.res0; r < std::min(poc.res1, comps[c].numres); r++)
                        if (!at(r, y, x, c)) return;
    } else {  // CPRL
        for (int c = poc.comp0; c < poc.comp1; c++) {
            steps(c, c + 1, dx, dy);
            if (!dx || !dy) return;
            for (uint64_t y = ty0; y < ty1; y += dy - (y % dy))
                for (uint64_t x = tx0; x < tx1; x += dx - (x % dx))
                    for (int r = poc.res0; r < std::min(poc.res1, comps[c].numres); r++)
                        if (!at(r, y, x, c)) return;
        }
    }
}

// ---------------------------------------------------------------------------
// tier 2: one packet
// ---------------------------------------------------------------------------
void init_seg(Cblk& C, int index, int sty, bool first) {
    if ((int)C.segs.size() <= index) C.segs.resize(index + 1);
    Seg& s = C.segs[index];
    s = Seg();
    if (sty & STY_TERMALL) s.maxpasses = 1;
    else if (sty & STY_LAZY) {
        if (first) s.maxpasses = 10;
        else {
            int prev = C.segs[index - 1].maxpasses;
            s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
        }
    } else s.maxpasses = 109;
}

struct Headers {
    const uint8_t* d;   // PPM / PPT packet headers, or null (in the data)
    int64_t len, pos;
};

// returns bytes of tile data used, or -1 with err set
int64_t read_packet(std::vector<Comp>& comps, const Packet& pk, int csty,
                    const uint8_t* src, int64_t maxlen, Headers& hd, Error& err,
                    int64_t* span) {
    Comp& C = comps[pk.comp];
    Res& R = C.res[pk.res];
    int sty = C.p[P_CBLKSTY];
    const uint8_t* cur = src;
    if (csty & 2) {  // SOP
        if (maxlen >= 6 && cur[0] == 0xFF && cur[1] == 0x91) cur += 6;
    }
    const uint8_t* hstart;
    int64_t hlen;
    if (hd.d) {
        hstart = hd.d + hd.pos;
        hlen = hd.len - hd.pos;
    } else {
        hstart = cur;
        hlen = src + maxlen - cur;
    }
    Bio bio(hstart, hlen);
    bool present = bio.read(1);
    if (present) {
        for (int b = 0; b < R.numbands; b++) {
            Band& B = R.bands[b];
            if (B.empty()) continue;
            Prec& P = B.precs[pk.prec];
            int nb = P.cw * P.ch;
            for (int k = 0; k < nb; k++) {
                Cblk& K = P.cblks[k];
                uint32_t included;
                if (!K.numsegs) included = tgt_decode(bio, P.incl, k, pk.lay + 1);
                else included = bio.read(1);
                if (!included) {
                    K.numnewpasses = 0;
                    continue;
                }
                if (!K.numsegs) {
                    int i = 0;
                    while (!tgt_decode(bio, P.imsb, k, i)) ++i;
                    K.numbps = (int32_t)((uint32_t)B.numbps + 1u - (uint32_t)i);
                    K.numlenbits = 3;
                }
                K.numnewpasses = (int)numpasses(bio);
                uint32_t inc = 0;
                while (bio.read(1)) ++inc;
                K.numlenbits += inc;
                int segno = 0;
                if (!K.numsegs) {
                    init_seg(K, 0, sty, true);
                } else {
                    segno = K.numsegs - 1;
                    if (K.segs[segno].numpasses == K.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(K, segno, sty, false);
                    }
                }
                int n = K.numnewpasses;
                do {
                    Seg& s = K.segs[segno];
                    s.numnewpasses = std::min(s.maxpasses - s.numpasses, n);
                    uint32_t bits = K.numlenbits + floorlog2((uint32_t)s.numnewpasses);
                    if (bits > 32) {
                        err = {1, "invalid bit number in a packet header"};
                        return -1;
                    }
                    s.newlen = bio.read((int)bits);
                    n -= s.numnewpasses;
                    if (n > 0) {
                        ++segno;
                        init_seg(K, segno, sty, false);
                    }
                } while (n > 0);
            }
        }
        bio.inalign();
    } else {
        bio.inalign();
    }
    const uint8_t* hend = hstart + bio.numbytes();
    if (csty & 4) {  // EPH
        if (hlen - bio.numbytes() >= 2 && hend[0] == 0xFF && hend[1] == 0x92) hend += 2;
    }
    if (hd.d) hd.pos += hend - hstart;
    else cur = hend;
    if (span) span[1] = cur - src;
    if (present) {
        const uint8_t* end = src + maxlen;
        for (int b = 0; b < R.numbands; b++) {
            Band& B = R.bands[b];
            if (B.empty()) continue;
            Prec& P = B.precs[pk.prec];
            int nb = P.cw * P.ch;
            for (int k = 0; k < nb; k++) {
                Cblk& K = P.cblks[k];
                if (!K.numnewpasses) continue;
                int si;
                if (!K.numsegs) {
                    si = 0;
                    K.numsegs = 1;
                } else {
                    si = K.numsegs - 1;
                    if (K.segs[si].numpasses == K.segs[si].maxpasses) {
                        ++si;
                        ++K.numsegs;
                    }
                }
                do {
                    Seg& s = K.segs[si];
                    if (s.newlen > end - cur) {
                        err = {1, "segment too long (strict mode)"};
                        return -1;
                    }
                    K.chunks.push_back({cur, s.newlen});
                    cur += s.newlen;
                    s.len += s.newlen;
                    s.numpasses += s.numnewpasses;
                    K.numnewpasses -= s.numnewpasses;
                    if (K.numnewpasses > 0) {
                        ++si;
                        ++K.numsegs;
                    }
                } while (K.numnewpasses > 0);
            }
        }
    }
    if (span) span[2] = cur - src;
    return cur - src;
}

// ---------------------------------------------------------------------------
// tier 1 over the code-blocks, then dequantisation into the component
// ---------------------------------------------------------------------------
struct Job { int comp, res, band; Cblk* cb; };

bool decode_cblk(T1& t, Cblk& K, int bandno, int roishift, int sty, Error& err) {
    int w = K.x1 - K.x0, h = K.y1 - K.y0;
    t.reset(w, h, bandno, (sty & STY_VSC) != 0);
    t.data.assign((size_t)w * h, 0);
    int32_t bpno = (int32_t)((uint32_t)roishift + (uint32_t)K.numbps);
    if (bpno >= 31) {
        err = {1, "unsupported bpno_plus_one >= 31"};
        return false;
    }
    std::vector<uint8_t> buf;
    for (auto& ch : K.chunks) buf.insert(buf.end(), ch.first, ch.first + ch.second);
    int passtype = 2;
    int64_t off = 0;
    for (int si = 0; si < K.numsegs; si++) {
        Seg& s = K.segs[si];
        bool raw = (sty & STY_LAZY) && passtype < 2 &&
                   bpno <= (int32_t)K.numbps - 4;
        const uint8_t* d = buf.data() + off;
        if (raw) t.mq.raw_init(d, s.len);
        else t.mq.init(d, s.len);
        off += s.len;
        for (int p = 0; p < s.numpasses && bpno >= 1; p++) {
            if (passtype == 0) t.sigpass(bpno, raw);
            else if (passtype == 1) t.refpass(bpno, raw);
            else t.clnpass(bpno, (sty & STY_SEGSYM) != 0);
            if ((sty & STY_RESET) && !raw) t.cx.reset();
            if (++passtype == 3) {
                passtype = 0;
                bpno--;
            }
        }
    }
    if (roishift) {
        if (roishift >= 31) {
            std::fill(t.data.begin(), t.data.end(), 0);
        } else {
            int32_t thresh = (int32_t)(1u << roishift);
            for (auto& v : t.data) {
                int32_t mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                    mag >>= roishift;
                    v = v < 0 ? -mag : mag;
                }
            }
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// the inverse transforms
// ---------------------------------------------------------------------------
// one line of the 5/3, interleaved in x (n samples, the first on an even
// position when cas is 0): T.800 F.3.8 with symmetric extension
void idwt53_line(int32_t* x, int n, int cas, std::vector<int32_t>& tmp) {
    if (n == 1) {
        if (cas) x[0] /= 2;
        return;
    }
    tmp.assign(x, x + n);
    int32_t* X = tmp.data();
    auto at = [&](int i) -> int32_t {
        if (i < 0) i = -i;
        if (i >= n) i = 2 * (n - 1) - i;
        return X[i];
    };
    for (int i = cas; i < n; i += 2)   // even positions
        X[i] -= (int32_t)((uint32_t)at(i - 1) + (uint32_t)at(i + 1) + 2u) >> 2;
    for (int i = 1 - cas; i < n; i += 2)
        X[i] += (int32_t)((uint32_t)at(i - 1) + (uint32_t)at(i + 1)) >> 1;
    std::copy(X, X + n, x);
}

const float K97 = 1.230174105f, TWO_INV_K = 1.625732422f;
const float C_DELTA = -0.443506852f, C_GAMMA = -0.882911075f,
            C_BETA = 0.052980118f, C_ALPHA = 1.586134342f;

void idwt97_line(float* x, int n, int cas) {
    if (n <= 1) return;
    int lo = cas, hi = 1 - cas;
    for (int i = lo; i < n; i += 2) x[i] = x[i] * K97;
    for (int i = hi; i < n; i += 2) x[i] = x[i] * TWO_INV_K;
    auto step = [&](int first, float c) {
        for (int i = first; i < n; i += 2) {
            float l = i - 1 >= 0 ? x[i - 1] : x[i + 1];
            float r = i + 1 < n ? x[i + 1] : x[i - 1];
            if (i - 1 < 0 || i + 1 >= n) x[i] = x[i] + l * (c + c);
            else x[i] = x[i] + ((l + r) * c);
        }
    };
    step(lo, C_DELTA);
    step(hi, C_GAMMA);
    step(lo, C_BETA);
    step(hi, C_ALPHA);
}

// the interleave of a resolution's row or column: low samples first in the
// buffer, placed on the parity cas
template <typename T>
void interleave(const T* src, int64_t stride, int n, int sn, int cas, T* dst) {
    for (int i = 0; i < sn; i++) dst[cas + 2 * i] = src[i * stride];
    for (int i = 0; i < n - sn; i++) dst[1 - cas + 2 * i] = src[(sn + i) * stride];
}

template <typename T, typename F>
void idwt(Comp& C, T* data, F line) {
    int64_t w = C.w();
    std::vector<T> buf;
    for (int r = 1; r < C.numres; r++) {
        const Res& lo = C.res[r - 1];
        const Res& R = C.res[r];
        int rw = (int)(R.x1 - R.x0), rh = (int)(R.y1 - R.y0);
        int snh = (int)(lo.x1 - lo.x0), snv = (int)(lo.y1 - lo.y0);
        int cash = (int)(R.x0 & 1), casv = (int)(R.y0 & 1);
        buf.resize(std::max(rw, rh) + 1);
        if (rw > 0)
            for (int y = 0; y < rh; y++) {
                T* row = data + (int64_t)y * w;
                interleave(row, 1, rw, snh, cash, buf.data());
                line(buf.data(), rw, cash);
                std::copy(buf.data(), buf.data() + rw, row);
            }
        if (rh > 0)
            for (int x = 0; x < rw; x++) {
                T* col = data + x;
                interleave(col, w, rh, snv, casv, buf.data());
                line(buf.data(), rh, casv);
                for (int y = 0; y < rh; y++) col[(int64_t)y * w] = buf[y];
            }
    }
}

template <typename Fn>
void parallel(int n, int threads, Fn fn) {
    threads = std::max(1, std::min(threads, n));
    if (threads == 1) {
        for (int i = 0; i < n; i++) fn(i);
        return;
    }
    std::atomic<int> next(0);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; t++)
        pool.emplace_back([&]() {
            for (int i; (i = next.fetch_add(1)) < n;) fn(i);
        });
    for (auto& th : pool) th.join();
}

void set_msg(char* msg, int msglen, const std::string& s) {
    if (msg && msglen > 0) std::snprintf(msg, msglen, "%s", s.c_str());
}


// ---------------------------------------------------------------------------
// the lossless writer: RCT, forward 5/3, tier 1 with every pass in one MQ
// segment, one layer, packets in the decoder's iterator order
// ---------------------------------------------------------------------------
struct MqEnc {
    std::vector<uint8_t> buf{0};   // buf[0] is the byte before the first
    size_t bp = 0;
    uint32_t a = 0x8000, c = 0;
    int ct = 12;
    void byteout() {
        if (buf[bp] == 0xFF) {
            bp++;
            buf.resize(bp + 1);
            buf[bp] = (uint8_t)(c >> 20);
            c &= 0xFFFFF;
            ct = 7;
        } else if ((c & 0x8000000) == 0) {
            bp++;
            buf.resize(bp + 1);
            buf[bp] = (uint8_t)(c >> 19);
            c &= 0x7FFFF;
            ct = 8;
        } else {
            buf[bp]++;
            if (buf[bp] == 0xFF) {
                c &= 0x7FFFFFF;
                bp++;
                buf.resize(bp + 1);
                buf[bp] = (uint8_t)(c >> 20);
                c &= 0xFFFFF;
                ct = 7;
            } else {
                bp++;
                buf.resize(bp + 1);
                buf[bp] = (uint8_t)(c >> 19);
                c &= 0x7FFFF;
                ct = 8;
            }
        }
    }
    void renorm() {
        do {
            a <<= 1;
            c <<= 1;
            ct--;
            if (ct == 0) byteout();
        } while ((a & 0x8000) == 0);
    }
    void encode(Contexts& cx, int k, int d) {
        const QeState& s = QE[cx.st[k]];
        if (d == cx.mps[k]) {
            a -= s.qe;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) a = s.qe;
                else c += s.qe;
                cx.st[k] = s.nmps;
                renorm();
            } else {
                c += s.qe;
            }
        } else {
            a -= s.qe;
            if (a < s.qe) c += s.qe;
            else a = s.qe;
            if (s.sw) cx.mps[k] ^= 1;
            cx.st[k] = s.nlps;
            renorm();
        }
    }
    // the segment's bytes
    std::vector<uint8_t> flush() {
        uint32_t tempc = c + a;
        c |= 0xFFFF;
        if (c >= tempc) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
        if (buf[bp] != 0xFF) bp++;
        return std::vector<uint8_t>(buf.begin() + 1, buf.begin() + bp);
    }
};

// one code-block's coefficients -> (bit-planes, passes, bytes)
struct EncBlock { int numbps = 0, passes = 0; std::vector<uint8_t> data; };

EncBlock encode_cblk(const int32_t* coef, int w, int h, int64_t stride, int band) {
    T1 t;   // its flags and context rules
    t.reset(w, h, band, false);
    uint32_t maxmag = 0;
    std::vector<uint32_t> mag((size_t)w * h);
    std::vector<uint8_t> neg((size_t)w * h);
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            int32_t v = coef[y * stride + x];
            mag[(size_t)y * w + x] = (uint32_t)(v < 0 ? -(int64_t)v : v);
            neg[(size_t)y * w + x] = v < 0;
            maxmag = std::max(maxmag, mag[(size_t)y * w + x]);
        }
    EncBlock out;
    while (maxmag >> out.numbps) out.numbps++;
    if (!out.numbps) return out;
    MqEnc mq;
    auto bit = [&](int x, int y, int bp) { return (int)((mag[(size_t)y * w + x] >> bp) & 1); };
    auto sign = [&](int x, int y) {
        int ctx, xr;
        t.sc(x, y, ctx, xr);
        int n = neg[(size_t)y * w + x];
        mq.encode(t.cx, ctx, n ^ xr);
        t.set_sig(x, y, n);
    };
    for (int bp = out.numbps - 1; bp >= 0; bp--) {
        if (bp != out.numbps - 1) {
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; x++)
                    for (int y = k; y < std::min(k + 4, h); y++) {
                        if ((t.F(x, y) & (SIG | PI)) || !t.any_neighbour(x, y)) continue;
                        int b = bit(x, y, bp);
                        mq.encode(t.cx, CX_ZC + t.zc(x, y), b);
                        if (b) sign(x, y);
                        t.F(x, y) |= PI;
                    }
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; x++)
                    for (int y = k; y < std::min(k + 4, h); y++) {
                        uint8_t fl = t.F(x, y);
                        if ((fl & (SIG | PI)) != SIG) continue;
                        int ctx = (fl & MU) ? CX_MAG + 2
                                  : t.any_neighbour(x, y) ? CX_MAG + 1 : CX_MAG;
                        mq.encode(t.cx, ctx, bit(x, y, bp));
                        t.F(x, y) |= MU;
                    }
            out.passes += 2;
        }
        int k = 0;
        for (; k + 4 <= h; k += 4)
            for (int x = 0; x < w; x++) {
                bool run = true;
                for (int y = k; y < k + 4 && run; y++)
                    run = !(t.F(x, y) & (SIG | PI)) && !t.any_neighbour(x, y);
                int first = k;
                if (run) {
                    int r = -1;
                    for (int y = k; y < k + 4; y++)
                        if (bit(x, y, bp)) {
                            r = y - k;
                            break;
                        }
                    mq.encode(t.cx, CX_RL, r >= 0);
                    if (r < 0) {
                        for (int y = k; y < k + 4; y++) t.F(x, y) &= ~PI;
                        continue;
                    }
                    mq.encode(t.cx, CX_UNI, r >> 1);
                    mq.encode(t.cx, CX_UNI, r & 1);
                    sign(x, k + r);
                    first = k + r + 1;
                }
                for (int y = first; y < k + 4; y++) {
                    if (t.F(x, y) & (SIG | PI)) continue;
                    int b = bit(x, y, bp);
                    mq.encode(t.cx, CX_ZC + t.zc(x, y), b);
                    if (b) sign(x, y);
                }
                for (int y = k; y < k + 4; y++) t.F(x, y) &= ~PI;
            }
        for (int x = 0; k < h && x < w; x++) {
            for (int y = k; y < h; y++) {
                if (t.F(x, y) & (SIG | PI)) continue;
                int b = bit(x, y, bp);
                mq.encode(t.cx, CX_ZC + t.zc(x, y), b);
                if (b) sign(x, y);
            }
            for (int y = k; y < h; y++) t.F(x, y) &= ~PI;
        }
        out.passes++;
    }
    out.data = mq.flush();
    return out;
}

struct BioEnc {
    std::vector<uint8_t> out;
    uint32_t buf = 0;
    int ct = 8;
    void byteout() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        out.push_back((uint8_t)(buf >> 8));
    }
    void put(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; i--) {
            if (ct == 0) byteout();
            ct--;
            buf |= ((v >> i) & 1u) << ct;
        }
    }
    void flush() {
        byteout();
        if (ct == 7) byteout();
    }
};

struct TagEnc {
    TagTree t;
    std::vector<int> known;
    void build(int w, int h, const std::vector<int>& leaves) {
        t.build(w, h);
        t.value.assign(t.value.size(), 999);
        for (size_t i = 0; i < leaves.size(); i++) {
            int n = (int)i;
            while (n >= 0 && t.value[n] > leaves[i]) {
                t.value[n] = leaves[i];
                n = t.parent[n];
            }
        }
        known.assign(t.value.size(), 0);
    }
    void encode(BioEnc& bio, int leaf, int threshold) {
        int stk[64], n = 0, node = leaf;
        while (t.parent[node] >= 0) {
            stk[n++] = node;
            node = t.parent[node];
        }
        int low = 0;
        for (;;) {
            if (low > t.low[node]) t.low[node] = low;
            else low = t.low[node];
            while (low < threshold) {
                if (low >= t.value[node]) {
                    if (!known[node]) {
                        bio.put(1, 1);
                        known[node] = 1;
                    }
                    break;
                }
                bio.put(0, 1);
                ++low;
            }
            t.low[node] = low;
            if (n == 0) break;
            node = stk[--n];
        }
    }
};

void fdwt53_line(int32_t* x, int n, std::vector<int32_t>& tmp) {
    // the image sits at the origin: every line starts on an even position
    if (n == 1) return;
    auto at = [&](int i) -> int32_t {
        if (i < 0) i = -i;
        if (i >= n) i = 2 * (n - 1) - i;
        return x[i];
    };
    for (int i = 1; i < n; i += 2) x[i] -= (at(i - 1) + at(i + 1)) >> 1;
    for (int i = 0; i < n; i += 2) x[i] += (at(i - 1) + at(i + 1) + 2) >> 2;
    tmp.resize(n);
    int sn = (n + 1) / 2;
    for (int i = 0; i < sn; i++) tmp[i] = x[2 * i];
    for (int i = 0; i < n - sn; i++) tmp[sn + i] = x[2 * i + 1];
    std::copy(tmp.begin(), tmp.begin() + n, x);
}

void put16(std::vector<uint8_t>& o, int v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}
void put32(std::vector<uint8_t>& o, uint32_t v) {
    put16(o, (int)(v >> 16));
    put16(o, (int)(v & 0xFFFF));
}

}  // namespace

extern "C" {

// A lossless codestream of a (h, w, ncomp) uint8 image (ncomp 1, 3 or 4;
// the RCT over the first three): 5/3 with `levels` decomposition levels,
// 2^cblk square code-blocks, one layer, one tile, progression `prg` (0
// LRCP ... 4 CPRL), precincts of 2^prec (15: the default, no PRT flag),
// the code-blocks coded on `threads` threads. Returns its length (written to out when it fits in cap), or -1.
int64_t kt_j2k_encode(const uint8_t* px, int w, int h, int ncomp, int levels,
                      int cblk, int prg, int prec, int threads, uint8_t* out,
                      int64_t cap) {
    const int numgbits = 2;
    std::vector<int32_t> cp((size_t)ncomp * P_COMP_STRIDE, 0);
    int32_t tp[T_POCS] = {0, 0, w, h, ncomp, 1, prg, prec == 15 ? 0 : 1, ncomp >= 3, 0, 0};
    for (int c = 0; c < ncomp; c++) {
        int32_t* p = &cp[(size_t)c * P_COMP_STRIDE];
        p[P_DX] = p[P_DY] = 1;
        p[P_PREC] = 8;
        p[P_NUMRES] = levels + 1;
        p[P_CBLKW] = p[P_CBLKH] = cblk;
        p[P_QMFBID] = 1;
        p[P_NUMGBITS] = numgbits;
        for (int r = 0; r <= levels; r++) p[P_PRCW + r] = p[P_PRCH + r] = prec;
        for (int b = 0; b < 3 * levels + 1; b++) {
            int bandno = b == 0 ? 0 : (b - 1) % 3 + 1;
            p[P_EXPN + b] = 8 + (bandno == 0 ? 0 : bandno == 3 ? 2 : 1);
        }
    }
    std::vector<Comp> comps(ncomp);
    int maxprec = 0;
    for (int c = 0; c < ncomp; c++) {
        comps[c].p = &cp[(size_t)c * P_COMP_STRIDE];
        build_comp(comps[c], tp);
        for (auto& R : comps[c].res) maxprec = std::max(maxprec, R.pw * R.ph);
        comps[c].idata.resize((size_t)w * h);
    }
    // level shift, RCT, forward 5/3
    size_t n = (size_t)w * h;
    for (size_t i = 0; i < n; i++)
        for (int c = 0; c < ncomp; c++) comps[c].idata[i] = (int32_t)px[i * ncomp + c] - 128;
    if (ncomp >= 3)
        for (size_t i = 0; i < n; i++) {
            int32_t r = comps[0].idata[i], g = comps[1].idata[i], b = comps[2].idata[i];
            comps[0].idata[i] = (r + 2 * g + b) >> 2;
            comps[1].idata[i] = b - g;
            comps[2].idata[i] = r - g;
        }
    std::vector<int32_t> tmp, line;
    for (auto& C : comps)
        for (int r = C.numres - 1; r >= 1; r--) {
            const Res& R = C.res[r];
            int rw = (int)(R.x1 - R.x0), rh = (int)(R.y1 - R.y0);
            line.resize(std::max(rw, rh));
            for (int x = 0; x < rw; x++) {
                for (int y = 0; y < rh; y++) line[y] = C.idata[(size_t)y * w + x];
                fdwt53_line(line.data(), rh, tmp);
                for (int y = 0; y < rh; y++) C.idata[(size_t)y * w + x] = line[y];
            }
            for (int y = 0; y < rh; y++) fdwt53_line(&C.idata[(size_t)y * w], rw, tmp);
        }
    // tier 1, the code-blocks on several threads
    std::vector<std::vector<std::vector<std::vector<std::vector<EncBlock>>>>> blocks(ncomp);
    struct EncJob { Comp* C; int r; Band* B; Cblk* K; EncBlock* out; };
    std::vector<EncJob> jobs;
    for (int c = 0; c < ncomp; c++) {
        Comp& C = comps[c];
        blocks[c].resize(C.numres);
        for (int r = 0; r < C.numres; r++) {
            blocks[c][r].resize(C.res[r].numbands);
            for (int b = 0; b < C.res[r].numbands; b++) {
                Band& B = C.res[r].bands[b];
                blocks[c][r][b].resize(B.precs.size());
                for (size_t pi = 0; pi < B.precs.size(); pi++)
                    blocks[c][r][b][pi].resize(B.precs[pi].cblks.size());
            }
        }
    }
    for (int c = 0; c < ncomp; c++)
        for (int r = 0; r < comps[c].numres; r++)
            for (int b = 0; b < comps[c].res[r].numbands; b++) {
                Band& B = comps[c].res[r].bands[b];
                for (size_t pi = 0; pi < B.precs.size(); pi++)
                    for (size_t k = 0; k < B.precs[pi].cblks.size(); k++)
                        jobs.push_back({&comps[c], r, &B, &B.precs[pi].cblks[k],
                                        &blocks[c][r][b][pi][k]});
            }
    parallel((int)jobs.size(), threads, [&](int j) {
        EncJob& jb = jobs[j];
        Comp& C = *jb.C;
        Band& B = *jb.B;
        Cblk& K = *jb.K;
        int64_t x = K.x0 - B.x0, y = K.y0 - B.y0;
        if (B.bandno & 1) x += C.res[jb.r - 1].x1 - C.res[jb.r - 1].x0;
        if (B.bandno & 2) y += C.res[jb.r - 1].y1 - C.res[jb.r - 1].y0;
        if (K.x1 > K.x0 && K.y1 > K.y0)
            *jb.out = encode_cblk(&C.idata[(size_t)y * w + x], K.x1 - K.x0, K.y1 - K.y0, w,
                                  B.bandno);
    });
    for (auto& jb : jobs)
        if (jb.out->numbps > jb.B->numbps) return -1;
    // tier 2
    Poc poc{0, 0, 1, levels + 1, ncomp, prg};
    std::vector<uint8_t> include((size_t)2 * (levels + 1) * ncomp * maxprec);
    std::vector<Packet> order;
    iterate(comps, tp, poc, levels + 1, maxprec, include, order);
    std::vector<uint8_t> body;
    for (auto& pk : order) {
        Res& R = comps[pk.comp].res[pk.res];
        BioEnc bio;
        bool any = false;
        for (int b = 0; b < R.numbands; b++)
            for (auto& eb : blocks[pk.comp][pk.res][b][pk.prec]) any |= eb.passes > 0;
        bio.put(any, 1);
        std::vector<uint8_t> data;
        if (any)
            for (int b = 0; b < R.numbands; b++) {
                Band& B = R.bands[b];
                if (B.empty()) continue;
                Prec& P = B.precs[pk.prec];
                auto& ebs = blocks[pk.comp][pk.res][b][pk.prec];
                int nb = P.cw * P.ch;
                if (!nb) continue;
                std::vector<int> incl(nb), zbp(nb);
                for (int k = 0; k < nb; k++) {
                    incl[k] = ebs[k].passes > 0 ? 0 : 1;
                    zbp[k] = ebs[k].passes > 0 ? B.numbps - ebs[k].numbps : 0;
                }
                TagEnc ti, tz;
                ti.build(P.cw, P.ch, incl);
                tz.build(P.cw, P.ch, zbp);
                for (int k = 0; k < nb; k++) {
                    EncBlock& eb = ebs[k];
                    ti.encode(bio, k, 1);
                    if (!eb.passes) continue;
                    tz.encode(bio, k, 999);
                    int np = eb.passes;
                    if (np == 1) bio.put(0, 1);
                    else if (np == 2) bio.put(2, 2);
                    else if (np <= 5) bio.put(0xC | (np - 3), 4);
                    else if (np <= 36) bio.put(0x1E0 | (np - 6), 9);
                    else bio.put(0xFF80 | (np - 37), 16);
                    uint32_t len = (uint32_t)eb.data.size();
                    int need = 0;
                    while ((len >> need) != 0) need++;
                    int inc = std::max(0, need - (3 + floorlog2((uint32_t)np)));
                    for (int i = 0; i < inc; i++) bio.put(1, 1);
                    bio.put(0, 1);
                    bio.put(len, 3 + inc + floorlog2((uint32_t)np));
                    data.insert(data.end(), eb.data.begin(), eb.data.end());
                }
            }
        bio.flush();
        body.insert(body.end(), bio.out.begin(), bio.out.end());
        body.insert(body.end(), data.begin(), data.end());
    }
    // the codestream
    std::vector<uint8_t> o{0xFF, 0x4F, 0xFF, 0x51};
    put16(o, 38 + 3 * ncomp);
    put16(o, 0);
    put32(o, w);
    put32(o, h);
    put32(o, 0);
    put32(o, 0);
    put32(o, w);
    put32(o, h);
    put32(o, 0);
    put32(o, 0);
    put16(o, ncomp);
    for (int c = 0; c < ncomp; c++) {
        o.push_back(7);
        o.push_back(1);
        o.push_back(1);
    }
    bool prt = prec != 15;
    o.push_back(0xFF);
    o.push_back(0x52);
    put16(o, 12 + (prt ? levels + 1 : 0));
    o.push_back(prt ? 1 : 0);
    o.push_back((uint8_t)prg);
    put16(o, 1);
    o.push_back(ncomp >= 3 ? 1 : 0);
    o.push_back((uint8_t)levels);
    o.push_back((uint8_t)(cblk - 2));
    o.push_back((uint8_t)(cblk - 2));
    o.push_back(0);
    o.push_back(1);
    if (prt)
        for (int r = 0; r <= levels; r++) o.push_back((uint8_t)(prec | (prec << 4)));
    o.push_back(0xFF);
    o.push_back(0x5C);
    put16(o, 3 + 3 * levels + 1);
    o.push_back((uint8_t)(numgbits << 5));
    for (int b = 0; b < 3 * levels + 1; b++) o.push_back((uint8_t)(cp[P_EXPN + b] << 3));
    o.push_back(0xFF);
    o.push_back(0x90);
    put16(o, 10);
    put16(o, 0);
    put32(o, (uint32_t)(12 + 2 + body.size()));
    o.push_back(0);
    o.push_back(1);
    o.push_back(0xFF);
    o.push_back(0x93);
    o.insert(o.end(), body.begin(), body.end());
    o.push_back(0xFF);
    o.push_back(0xD9);
    if ((int64_t)o.size() <= cap) std::memcpy(out, o.data(), o.size());
    return (int64_t)o.size();
}


// Decode one tile. tp: the tile (T_*; POCs 6 ints each: res0, comp0, lay1,
// res1, comp1, prg), cp: the components (P_COMP_STRIDE ints each). data:
// the tile's data (its tile-parts after SOD), hdr: PPM / PPT packet headers
// (null when they sit in the data), *hdr_pos advanced over what the tile
// read. out: each component's samples (its tile-component size), int32,
// one after another. spans (if nspans > 0): per packet its start, header
// end and data end in the data. Returns 0, 1 (OpenJPEG fails: white) or 2
// (not modelled), with msg set.
int kt_j2k_decode_tile(const int32_t* tp, const int32_t* cp, const uint8_t* data,
                       int64_t len, const uint8_t* hdr, int64_t hdrlen,
                       int64_t* hdr_pos, int32_t* out, int threads, int64_t* spans,
                       int64_t nspans, char* msg, int msglen) {
    int numcomps = tp[T_NUMCOMPS], numlayers = tp[T_NUMLAYERS];
    std::vector<Comp> comps(numcomps);
    int maxres = 0, maxprec = 0;
    for (int c = 0; c < numcomps; c++) {
        comps[c].p = cp + (int64_t)c * P_COMP_STRIDE;
        build_comp(comps[c], tp);
        maxres = std::max(maxres, comps[c].numres);
        for (auto& R : comps[c].res) maxprec = std::max(maxprec, R.pw * R.ph);
    }
    // the packet order
    std::vector<Poc> pocs;
    int npocs = tp[T_NUMPOCS];
    if (npocs == 0) {
        if (tp[T_PRG] < 0 || tp[T_PRG] > 4) {
            set_msg(msg, msglen, "unknown progression order");
            return 1;
        }
        pocs.push_back({0, 0, numlayers, maxres, numcomps, tp[T_PRG]});
    } else {
        for (int i = 0; i < npocs; i++) {
            const int32_t* q = tp + T_POCS + 6 * i;
            pocs.push_back({q[0], q[1], std::min(q[2], numlayers), q[3], q[4], q[5]});
        }
    }
    std::vector<uint8_t> include((size_t)(numlayers + 1) * maxres * numcomps * maxprec);
    std::vector<Packet> order;
    for (auto& poc : pocs) iterate(comps, tp, poc, maxres, maxprec, include, order);
    // resolutions decoded per component (OpenJPEG's resno_decoded)
    std::vector<int> decoded(numcomps, 0);
    Headers hd{hdr, hdrlen, hdr_pos ? *hdr_pos : 0};
    int64_t pos = 0;
    Error err{0, ""};
    int64_t k = 0;
    for (auto& pk : order) {
        int64_t* span = (spans && k < nspans) ? spans + 3 * k : nullptr;
        if (span) span[0] = pos;
        int64_t used = read_packet(comps, pk, tp[T_CSTY], data + pos, len - pos, hd, err,
                                   span);
        if (used < 0) {
            set_msg(msg, msglen, err.msg);
            return err.code;
        }
        if (span) {
            span[1] += pos;
            span[2] += pos;
        }
        pos += used;
        decoded[pk.comp] = std::max(decoded[pk.comp], pk.res);
        k++;
    }
    if (spans && nspans > k) spans[3 * k] = -1;
    if (hdr_pos) *hdr_pos = hd.pos;
    for (int c = 0; c < numcomps; c++) {
        const Res& top = comps[c].res.back();
        if (top.x1 > top.x0 && top.y1 > top.y0 && decoded[c] != comps[c].numres - 1) {
            set_msg(msg, msglen, "a component whose top resolution was not decoded");
            return 2;
        }
    }
    // tier 1
    std::vector<Job> jobs;
    for (int c = 0; c < numcomps; c++) {
        Comp& C = comps[c];
        if (C.p[P_QMFBID] == 1) C.idata.assign((size_t)C.w() * C.h(), 0);
        else C.fdata.assign((size_t)C.w() * C.h(), 0.0f);
        for (int r = 0; r < C.numres; r++)
            for (int b = 0; b < C.res[r].numbands; b++)
                for (auto& P : C.res[r].bands[b].precs)
                    for (auto& K : P.cblks)
                        if (K.x1 > K.x0 && K.y1 > K.y0) jobs.push_back({c, r, b, &K});
    }
    std::vector<Error> errs(jobs.size(), Error{0, ""});
    parallel((int)jobs.size(), threads, [&](int j) {
        thread_local T1 t;
        Job& jb = jobs[j];
        Comp& C = comps[jb.comp];
        Band& B = C.res[jb.res].bands[jb.band];
        Cblk& K = *jb.cb;
        if (!decode_cblk(t, K, B.bandno, C.p[P_ROISHIFT], C.p[P_CBLKSTY], errs[j])) return;
        int64_t x = K.x0 - B.x0, y = K.y0 - B.y0;
        if (B.bandno & 1) x += C.res[jb.res - 1].x1 - C.res[jb.res - 1].x0;
        if (B.bandno & 2) y += C.res[jb.res - 1].y1 - C.res[jb.res - 1].y0;
        int w = K.x1 - K.x0, h = K.y1 - K.y0;
        int64_t tw = C.w();
        if (C.p[P_QMFBID] == 1) {
            for (int yy = 0; yy < h; yy++)
                for (int xx = 0; xx < w; xx++)
                    C.idata[(y + yy) * tw + x + xx] = t.data[(size_t)yy * w + xx] / 2;
        } else {
            float step = 0.5f * B.stepsize;
            for (int yy = 0; yy < h; yy++)
                for (int xx = 0; xx < w; xx++)
                    C.fdata[(y + yy) * tw + x + xx] =
                        (float)t.data[(size_t)yy * w + xx] * step;
        }
    });
    for (auto& e : errs)
        if (e.code) {
            set_msg(msg, msglen, e.msg);
            return e.code;
        }
    // the inverse transforms, a component a thread
    parallel(numcomps, threads, [&](int c) {
        Comp& C = comps[c];
        if (C.p[P_QMFBID] == 1) {
            std::vector<int32_t> tmp;
            idwt(C, C.idata.data(),
                 [&](int32_t* x, int n, int cas) { idwt53_line(x, n, cas, tmp); });
        } else {
            idwt(C, C.fdata.data(), [](float* x, int n, int cas) { idwt97_line(x, n, cas); });
        }
    });
    // the multiple component transform
    if (tp[T_MCT] && numcomps >= 3) {
        int64_t n = comps[0].w() * comps[0].h();
        for (int c = 1; c < 3; c++)
            if (comps[c].numres != comps[0].numres || comps[c].w() * comps[c].h() != n) {
                set_msg(msg, msglen, "tiles don't all have the same dimension: MCT fails");
                return 1;
            }
        if (comps[0].p[P_QMFBID] == 0) {
            if (comps[1].p[P_QMFBID] != 0 || comps[2].p[P_QMFBID] != 0) {
                set_msg(msg, msglen, "an ICT over components of both transforms");
                return 2;
            }
            float *a = comps[0].fdata.data(), *b = comps[1].fdata.data(),
                  *c2 = comps[2].fdata.data();
            for (int64_t i = 0; i < n; i++) {
                float y = a[i], u = b[i], v = c2[i];
                float r = y + (v * 1.402f);
                float g = y - (u * 0.34413f) - (v * 0.71414f);
                float bb = y + (u * 1.772f);
                a[i] = r;
                b[i] = g;
                c2[i] = bb;
            }
        } else {
            if (comps[1].p[P_QMFBID] != 1 || comps[2].p[P_QMFBID] != 1) {
                set_msg(msg, msglen, "an RCT over components of both transforms");
                return 2;
            }
            int32_t *a = comps[0].idata.data(), *b = comps[1].idata.data(),
                    *c2 = comps[2].idata.data();
            for (int64_t i = 0; i < n; i++) {
                int32_t y = a[i], u = b[i], v = c2[i];
                int32_t g = y - ((int32_t)((uint32_t)u + (uint32_t)v) >> 2);
                a[i] = v + g;
                b[i] = g;
                c2[i] = u + g;
            }
        }
    }
    // DC level shift and clamp
    int64_t o = 0;
    for (int c = 0; c < numcomps; c++) {
        Comp& C = comps[c];
        int prec = C.p[P_PREC];
        bool sg = C.p[P_SGND] != 0;
        int64_t lo = sg ? -((int64_t)1 << (prec - 1)) : 0;
        int64_t hi = sg ? ((int64_t)1 << (prec - 1)) - 1 : ((int64_t)1 << prec) - 1;
        int32_t shift = sg ? 0 : (int32_t)(1u << (prec - 1));
        int64_t n = C.w() * C.h();
        if (C.p[P_QMFBID] == 1) {
            for (int64_t i = 0; i < n; i++) {
                int64_t v = (int32_t)((uint32_t)C.idata[i] + (uint32_t)shift);
                out[o + i] = (int32_t)std::min(std::max(v, lo), hi);
            }
        } else {
            for (int64_t i = 0; i < n; i++) {
                float v = C.fdata[i];
                int64_t q;
                if (v > (float)INT32_MAX) q = hi;
                else if (v < (float)INT32_MIN) q = lo;
                else q = std::min(std::max((int64_t)lrintf(v) + shift, lo), hi);
                out[o + i] = (int32_t)q;
            }
        }
        o += n;
    }
    return 0;
}

}  // extern "C"
