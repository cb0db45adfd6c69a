// The sequential codecs of the TIFF texture decoder (scene/tiff.py), as
// libtiff 4.7.1 runs them for PIL 12.1.0's "libtiff" decoder: PackBits
// (tif_packbits.c PackBitsDecode), LZW (tif_lzw.c LZWDecode, and
// LZWDecodeCompat for the old bit-reversed codes), the CCITT codecs
// (tif_fax3.c: Fax3DecodeRLE for RLE and RLEW, Fax3Decode1D / Fax3Decode2D
// for Group 3, Fax4Decode for Group 4, over run tables built from the T.4
// codes as tif_fax3sm.c's are) and ThunderScan (tif_thunder.c). Each call
// decodes one strip or tile into `occ` bytes, as TIFFReadEncodedStrip /
// Tile asks for them. Python parses the directory and does the rest
// (predictors, deflate, LZMA, zstd, JPEG, unpacking). The encoders of the
// port's TIFF writer (`tiff.write_tiff`, the TIFF-textured cities' maps) are
// here too: LZW as libtiff writes it (a clear code first, the width growing
// one code early, a clear when the table fills), PackBits, the CCITT codes
// and ThunderScan. Built with g++ at first use (hostlib.load) and called
// through ctypes.
//
// Status codes: 0 done; 1 the codec reports an error (libtiff's decode
// returns 0, TIFFReadEncodedStrip -1, and PIL raises "decoder error").

#include <algorithm>
#include <cstdint>
#include <cstdlib>
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


// ---------------------------------------------------------------------------
// CCITT (tif_fax3.c, tif_fax3.h)
// ---------------------------------------------------------------------------

enum FaxState : uint8_t {
  S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct FaxEnt {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

// the T.4 codes, most significant bit first
struct Code {
  uint16_t run;
  const char* bits;
};
const Code kWhiteTerm[64] = {
    {0, "00110101"}, {1, "000111"}, {2, "0111"}, {3, "1000"}, {4, "1011"},
    {5, "1100"}, {6, "1110"}, {7, "1111"}, {8, "10011"}, {9, "10100"},
    {10, "00111"}, {11, "01000"}, {12, "001000"}, {13, "000011"},
    {14, "110100"}, {15, "110101"}, {16, "101010"}, {17, "101011"},
    {18, "0100111"}, {19, "0001100"}, {20, "0001000"}, {21, "0010111"},
    {22, "0000011"}, {23, "0000100"}, {24, "0101000"}, {25, "0101011"},
    {26, "0010011"}, {27, "0100100"}, {28, "0011000"}, {29, "00000010"},
    {30, "00000011"}, {31, "00011010"}, {32, "00011011"}, {33, "00010010"},
    {34, "00010011"}, {35, "00010100"}, {36, "00010101"}, {37, "00010110"},
    {38, "00010111"}, {39, "00101000"}, {40, "00101001"}, {41, "00101010"},
    {42, "00101011"}, {43, "00101100"}, {44, "00101101"}, {45, "00000100"},
    {46, "00000101"}, {47, "00001010"}, {48, "00001011"}, {49, "01010010"},
    {50, "01010011"}, {51, "01010100"}, {52, "01010101"}, {53, "00100100"},
    {54, "00100101"}, {55, "01011000"}, {56, "01011001"}, {57, "01011010"},
    {58, "01011011"}, {59, "01001010"}, {60, "01001011"}, {61, "00110010"},
    {62, "00110011"}, {63, "00110100"}};
const Code kWhiteMakeUp[27] = {
    {64, "11011"}, {128, "10010"}, {192, "010111"}, {256, "0110111"},
    {320, "00110110"}, {384, "00110111"}, {448, "01100100"},
    {512, "01100101"}, {576, "01101000"}, {640, "01100111"},
    {704, "011001100"}, {768, "011001101"}, {832, "011010010"},
    {896, "011010011"}, {960, "011010100"}, {1024, "011010101"},
    {1088, "011010110"}, {1152, "011010111"}, {1216, "011011000"},
    {1280, "011011001"}, {1344, "011011010"}, {1408, "011011011"},
    {1472, "010011000"}, {1536, "010011001"}, {1600, "010011010"},
    {1664, "011000"}, {1728, "010011011"}};
const Code kBlackTerm[64] = {
    {0, "0000110111"}, {1, "010"}, {2, "11"}, {3, "10"}, {4, "011"},
    {5, "0011"}, {6, "0010"}, {7, "00011"}, {8, "000101"}, {9, "000100"},
    {10, "0000100"}, {11, "0000101"}, {12, "0000111"}, {13, "00000100"},
    {14, "00000111"}, {15, "000011000"}, {16, "0000010111"},
    {17, "0000011000"}, {18, "0000001000"}, {19, "00001100111"},
    {20, "00001101000"}, {21, "00001101100"}, {22, "00000110111"},
    {23, "00000101000"}, {24, "00000010111"}, {25, "00000011000"},
    {26, "000011001010"}, {27, "000011001011"}, {28, "000011001100"},
    {29, "000011001101"}, {30, "000001101000"}, {31, "000001101001"},
    {32, "000001101010"}, {33, "000001101011"}, {34, "000011010010"},
    {35, "000011010011"}, {36, "000011010100"}, {37, "000011010101"},
    {38, "000011010110"}, {39, "000011010111"}, {40, "000001101100"},
    {41, "000001101101"}, {42, "000011011010"}, {43, "000011011011"},
    {44, "000001010100"}, {45, "000001010101"}, {46, "000001010110"},
    {47, "000001010111"}, {48, "000001100100"}, {49, "000001100101"},
    {50, "000001010010"}, {51, "000001010011"}, {52, "000000100100"},
    {53, "000000110111"}, {54, "000000111000"}, {55, "000000100111"},
    {56, "000000101000"}, {57, "000001011000"}, {58, "000001011001"},
    {59, "000000101011"}, {60, "000000101100"}, {61, "000001011010"},
    {62, "000001100110"}, {63, "000001100111"}};
const Code kBlackMakeUp[27] = {
    {64, "0000001111"}, {128, "000011001000"}, {192, "000011001001"},
    {256, "000001011011"}, {320, "000000110011"}, {384, "000000110100"},
    {448, "000000110101"}, {512, "0000001101100"}, {576, "0000001101101"},
    {640, "0000001001010"}, {704, "0000001001011"}, {768, "0000001001100"},
    {832, "0000001001101"}, {896, "0000001110010"}, {960, "0000001110011"},
    {1024, "0000001110100"}, {1088, "0000001110101"},
    {1152, "0000001110110"}, {1216, "0000001110111"},
    {1280, "0000001010010"}, {1344, "0000001010011"},
    {1408, "0000001010100"}, {1472, "0000001010101"},
    {1536, "0000001011010"}, {1600, "0000001011011"},
    {1664, "0000001100100"}, {1728, "0000001100101"}};
const Code kExtMakeUp[13] = {
    {1792, "00000001000"}, {1856, "00000001100"}, {1920, "00000001101"},
    {1984, "000000010010"}, {2048, "000000010011"}, {2112, "000000010100"},
    {2176, "000000010101"}, {2240, "000000010110"}, {2304, "000000010111"},
    {2368, "000000011100"}, {2432, "000000011101"}, {2496, "000000011110"},
    {2560, "000000011111"}};

struct FaxTables {
  FaxEnt main[128], white[4096], black[8192];
  // every index whose low `len` bits are the code, first bit lowest
  static void fill(FaxEnt* t, int size, const char* bits, uint8_t state,
                   uint32_t param) {
    const int len = (int)std::strlen(bits);
    int code = 0;
    for (int i = 0; i < len; i++) code |= (bits[i] - '0') << i;
    for (int i = code; i < size; i += 1 << len)
      t[i] = {state, (uint8_t)len, param};
  }
  FaxTables() {
    fill(main, 128, "1", S_V0, 0);
    fill(main, 128, "011", S_VR, 1);
    fill(main, 128, "000011", S_VR, 2);
    fill(main, 128, "0000011", S_VR, 3);
    fill(main, 128, "010", S_VL, 1);
    fill(main, 128, "000010", S_VL, 2);
    fill(main, 128, "0000010", S_VL, 3);
    fill(main, 128, "0001", S_Pass, 0);
    fill(main, 128, "001", S_Horiz, 0);
    fill(main, 128, "0000001", S_Ext, 0);
    fill(main, 128, "0000000", S_EOL, 0);
    for (const Code& c : kWhiteTerm) fill(white, 4096, c.bits, S_TermW, c.run);
    for (const Code& c : kWhiteMakeUp)
      fill(white, 4096, c.bits, S_MakeUpW, c.run);
    for (const Code& c : kBlackTerm) fill(black, 8192, c.bits, S_TermB, c.run);
    for (const Code& c : kBlackMakeUp)
      fill(black, 8192, c.bits, S_MakeUpB, c.run);
    for (const Code& c : kExtMakeUp) {
      fill(white, 4096, c.bits, S_MakeUp, c.run);
      fill(black, 8192, c.bits, S_MakeUp, c.run);
    }
    fill(white, 4096, "00000000000", S_EOL, 0);
    fill(black, 8192, "00000000000", S_EOL, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

uint8_t kRev[256];
struct RevInit {
  RevInit() {
    for (int i = 0; i < 256; i++) {
      int r = 0;
      for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
      kRev[i] = (uint8_t)r;
    }
  }
} rev_init;

enum { kRowDone, kRowEof, kRowOverflow };

// one strip or tile of tif_fax3.c's decoder state: the bit reader, the run
// arrays (shared by the strips of an image, as libtiff's are) and a row
struct Fax {
  const FaxTables& T = fax_tables();
  const uint8_t* cp;
  const uint8_t* ep;
  const uint8_t* base;
  uint32_t acc = 0;
  int avail = 0;
  int eolcnt = 0;
  uint32_t* runs;  // 2 * nruns (+1 slack), runs[-1] readable
  int nruns;
  uint32_t* curruns;
  uint32_t* refruns;
  uint32_t* thisrun = nullptr;
  uint32_t* pa = nullptr;
  uint32_t* pb = nullptr;
  int a0 = 0, b1 = 0, run_length = 0, lastx;
  bool oob = false;  // a read before the run arrays (libtiff reads the heap)
  const FaxEnt* te = nullptr;

  bool need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)kRev[*cp++] << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)kRev[*cp++] << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= (uint32_t)kRev[*cp++] << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  bool lookup8(int wid, const FaxEnt* tab) {
    if (!need8(wid)) return false;
    te = tab + get(wid);
    clr(te->width);
    return true;
  }
  bool lookup16(int wid, const FaxEnt* tab) {
    if (!need16(wid)) return false;
    te = tab + get(wid);
    clr(te->width);
    return true;
  }
  bool setvalue(int x) {
    if (pa >= thisrun + nruns) return false;
    *pa++ = (uint32_t)(run_length + x);
    a0 += x;
    run_length = 0;
    return true;
  }
  bool cleanup() {
    if (run_length && !setvalue(0)) return false;
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= (int)*--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1)
          if (!setvalue(0)) return false;
        if (!setvalue(lastx - a0)) return false;
      } else if (a0 > lastx) {
        if (!setvalue(lastx)) return false;
        if (!setvalue(0)) return false;
      }
    }
    return true;
  }
  // SYNC_EOL: kSynced, or where the data ended: before an EOL's zeros
  // were found (kNoEol, libtiff's end of data) or in the zeros after them
  // (kNoEolBit, where libtiff 4.7.1 retries the strip as data without EOLs)
  enum { kSynced, kNoEol, kNoEolBit };
  int sync_eol() {
    if (eolcnt == 0) {
      for (;;) {
        if (!need16(11)) return kNoEol;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) return kNoEolBit;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
    return kSynced;
  }
  int expand1d() {
    for (;;) {
      for (;;) {
        if (!lookup16(12, T.white)) goto eof1d;
        switch (te->state) {
          case S_EOL: eolcnt = 1; goto done1d;
          case S_TermW:
            if (!setvalue((int)te->param)) return kRowOverflow;
            goto done_white;
          case S_MakeUpW: case S_MakeUp:
            a0 += (int)te->param;
            run_length += (int)te->param;
            break;
          default: goto done1d;
        }
      }
    done_white:
      if (a0 >= lastx) goto done1d;
      for (;;) {
        if (!lookup16(13, T.black)) goto eof1d;
        switch (te->state) {
          case S_EOL: eolcnt = 1; goto done1d;
          case S_TermB:
            if (!setvalue((int)te->param)) return kRowOverflow;
            goto done_black;
          case S_MakeUpB: case S_MakeUp:
            a0 += (int)te->param;
            run_length += (int)te->param;
            break;
          default: goto done1d;
        }
      }
    done_black:
      if (a0 >= lastx) goto done1d;
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
  eof1d:
    if (!cleanup()) return kRowOverflow;
    return kRowEof;
  done1d:
    if (!cleanup()) return kRowOverflow;
    return kRowDone;
  }
  bool check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) return false;
        if (pb < runs) oob = true;
        b1 += (int)(pb[0] + pb[1]);
        pb += 2;
      }
    return true;
  }
  // a horizontal mode's two runs, `first` then the other colour
  int horiz(bool black_first) {
    for (int k = 0; k < 2; k++) {
      const bool black = (k == 0) == black_first;
      for (;;) {
        if (!lookup16(black ? 13 : 12, black ? T.black : T.white))
          return kRowEof;
        const uint8_t st = te->state;
        if (st == (black ? S_TermB : S_TermW)) {
          if (!setvalue((int)te->param)) return kRowOverflow;
          break;
        }
        if (st == (black ? S_MakeUpB : S_MakeUpW) || st == S_MakeUp) {
          a0 += (int)te->param;
          run_length += (int)te->param;
          continue;
        }
        return kRowDone;  // a bad code word: the row ends
      }
    }
    return -1;
  }
  int expand2d() {
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) return kRowOverflow;
      if (!lookup8(7, T.main)) goto eof2d;
      switch (te->state) {
        case S_Pass:
          if (!check_b1()) return kRowOverflow;
          if (pb + 1 >= refruns + nruns) return kRowOverflow;
          if (pb < runs) oob = true;
          b1 += (int)*pb++;
          run_length += b1 - a0;
          a0 = b1;
          b1 += (int)*pb++;
          break;
        case S_Horiz: {
          const int r = horiz((pa - thisrun) & 1);
          if (r == kRowOverflow) return kRowOverflow;
          if (r == kRowEof) goto eof2d;
          if (r == kRowDone) goto eol2d;
          if (!check_b1()) return kRowOverflow;
          break;
        }
        case S_V0:
          if (!check_b1()) return kRowOverflow;
          if (!setvalue(b1 - a0)) return kRowOverflow;
          if (pb >= refruns + nruns) return kRowOverflow;
          if (pb < runs) oob = true;
          b1 += (int)*pb++;
          break;
        case S_VR:
          if (!check_b1()) return kRowOverflow;
          if (!setvalue(b1 - a0 + (int)te->param)) return kRowOverflow;
          if (pb >= refruns + nruns) return kRowOverflow;
          if (pb < runs) oob = true;
          b1 += (int)*pb++;
          break;
        case S_VL:
          if (!check_b1()) return kRowOverflow;
          if (b1 < (int)(a0 + te->param)) goto eol2d;
          if (!setvalue(b1 - a0 - (int)te->param)) return kRowOverflow;
          --pb;
          if (pb < runs) oob = true;
          b1 -= (int)*pb;
          break;
        case S_Ext:
          *pa++ = (uint32_t)(lastx - a0);
          goto eol2d;
        case S_EOL:
          *pa++ = (uint32_t)(lastx - a0);
          if (!need8(4)) goto eof2d;
          clr(4);
          eolcnt = 1;
          goto eol2d;
        default:
          goto eol2d;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {
        if (!need8(1)) goto eof2d;
        if (!get(1)) goto eol2d;
        clr(1);
      }
      if (!setvalue(0)) return kRowOverflow;
    }
  eol2d:
    if (!cleanup()) return kRowOverflow;
    return kRowDone;
  eof2d:
    if (!cleanup()) return kRowOverflow;
    return kRowEof;
  }
};

// _TIFFFax3fillruns: white runs clear bits, black runs set them
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0,
                                  0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; k++) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      const uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          if (k == 0)
            *cp++ &= (uint8_t)(0xff << (8 - bx));
          else
            *cp++ |= (uint8_t)(0xff >> bx);
          run -= 8 - bx;
        }
        const uint32_t n = run >> 3;
        if (n) {
          std::memset(cp, k == 0 ? 0x00 : 0xff, n);
          cp += n;
          run &= 7;
        }
        if (run) {
          if (k == 0)
            cp[0] &= (uint8_t)(0xff >> run);
          else
            cp[0] = (uint8_t)((cp[0] | (0xff00 >> run)) & 0xff);
        }
      } else {
        if (k == 0)
          cp[0] &= (uint8_t)~(masks[run] >> bx);
        else
          cp[0] |= (uint8_t)(masks[run] >> bx);
      }
      x += runs[k];
    }
  }
}

// the T.4 / T.6 writer: MSB-first bits
struct FaxWriter {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int n = 0;
  // RLEW: the reads of libtiff's decoder (NeedBits16 before each code,
  // loading a byte or two), whose word alignment a row's end must follow
  bool track = false;
  int savail = 0;
  long long sloaded = 0;
  void read_code(int len, int lookup) {
    if (!track) return;
    if (savail < lookup) {
      sloaded++;
      savail += 8;
      if (savail < lookup) {
        sloaded++;
        savail += 8;
      }
    }
    savail -= len;
  }
  // Fax3DecodeRLE's word alignment at a row's end (the data starts at an
  // even address): pad to where the decoder reads the next row
  void word_align() {
    savail &= ~15;
    if (savail == 0 && (sloaded & 1)) sloaded++;
    const long long target = sloaded * 8 - savail;
    while (bitpos() < target) put(0, 1);
  }
  void put(uint32_t code, int len) {
    for (int i = len - 1; i >= 0; i--) {
      acc = (acc << 1) | ((code >> i) & 1);
      if (++n == 8) {
        out.push_back((uint8_t)acc);
        acc = 0;
        n = 0;
      }
    }
  }
  void put_bits(const char* bits) {
    for (const char* p = bits; *p; ++p) put((uint32_t)(*p - '0'), 1);
  }
  void align8() {
    while (n) put(0, 1);
  }
  long long bitpos() const { return (long long)out.size() * 8 + n; }
  void code(const char* bits, bool black) {
    read_code((int)std::strlen(bits), black ? 13 : 12);
    put_bits(bits);
  }
  void span(int run, bool black) {
    const Code* term = black ? kBlackTerm : kWhiteTerm;
    const Code* makeup = black ? kBlackMakeUp : kWhiteMakeUp;
    while (run >= 2560 + 64) {
      code(kExtMakeUp[12].bits, black);
      run -= 2560;
    }
    if (run >= 64) {
      const int m = run >> 6;
      code(m <= 27 ? makeup[m - 1].bits : kExtMakeUp[m - 28].bits, black);
      run -= m << 6;
    }
    code(term[run].bits, black);
  }
  void eol() { put(1, 12); }
};

inline int pixel(const uint8_t* row, int x) {
  return (row[x >> 3] >> (7 - (x & 7))) & 1;
}
// the first x > from (x >= 0) whose pixel differs from `color`, or width
inline int find_color(const uint8_t* row, int from, int width, int color) {
  int x = from < 0 ? 0 : from + 1;
  while (x < width && pixel(row, x) == color) x++;
  return x;
}

void encode_1d(FaxWriter& w, const uint8_t* row, int width) {
  int x = 0, color = 0;
  while (x < width) {
    int e = x;
    while (e < width && pixel(row, e) == color) e++;
    w.span(e - x, color);
    x = e;
    color ^= 1;
  }
  if (width == 0) w.span(0, false);
}

void encode_2d(FaxWriter& w, const uint8_t* row, const uint8_t* ref,
               int width) {
  static const char* vr[4] = {"1", "011", "000011", "0000011"};
  static const char* vl[4] = {"1", "010", "000010", "0000010"};
  int a0 = -1, color = 0;
  while (a0 < width) {
    const int a1 = find_color(row, a0, width, color);
    // b1: the first change on the reference line right of a0 to the
    // opposite of `color`
    int b1 = a0 < 0 ? 0 : a0 + 1;
    while (b1 < width &&
           !(pixel(ref, b1) != color &&
             (b1 == 0 ? color == 0 : pixel(ref, b1 - 1) == color)))
      b1++;
    int b2 = b1;
    while (b2 < width && pixel(ref, b2) != color) b2++;
    if (b2 < a1) {
      w.put_bits("0001");
      a0 = b2;
    } else if (std::abs(a1 - b1) <= 3) {
      const int d = a1 - b1;
      w.put_bits(d >= 0 ? vr[d] : vl[-d]);
      a0 = a1;
      color ^= 1;
    } else {
      const int a2 = find_color(row, a1, width, color ^ 1);
      w.put_bits("001");
      w.span(a1 - (a0 < 0 ? 0 : a0), color);
      w.span(a2 - a1, !color);
      a0 = a2;
    }
  }
}

// ---------------------------------------------------------------------------
// ThunderScan (tif_thunder.c)
// ---------------------------------------------------------------------------

const int kDelta2[4] = {0, 1, 0, -1};
const int kDelta3[8] = {0, 1, 2, 3, 0, -3, -2, -1};

// ThunderDecode of one row; false where its pixel count is not maxpixels
bool thunder_row(const uint8_t*& bp, long long& cc, uint8_t* op,
                 long long maxpixels) {
  unsigned lastpixel = 0;
  long long npixels = 0;
  auto setpixel = [&](unsigned v) {
    lastpixel = v & 0xf;
    if (npixels < maxpixels) {
      if (npixels++ & 1)
        *op++ |= (uint8_t)lastpixel;
      else
        op[0] = (uint8_t)(lastpixel << 4);
    }
  };
  while (cc > 0 && npixels < maxpixels) {
    int n = *bp++, delta;
    cc--;
    switch (n & 0xc0) {
      case 0x00:
        n &= 0x3f;
        if (npixels & 1) {
          op[0] |= (uint8_t)lastpixel;
          lastpixel = *op++;
          npixels++;
          n--;
        } else {
          lastpixel |= lastpixel << 4;
        }
        npixels += n;
        if (npixels > maxpixels) break;
        for (; n > 0; n -= 2) *op++ = (uint8_t)lastpixel;
        if (n == -1) *--op &= 0xf0;
        lastpixel &= 0xf;
        break;
      case 0x40:
        if ((delta = (n >> 4) & 3) != 2)
          setpixel((unsigned)((int)lastpixel + kDelta2[delta]));
        if ((delta = (n >> 2) & 3) != 2)
          setpixel((unsigned)((int)lastpixel + kDelta2[delta]));
        if ((delta = n & 3) != 2)
          setpixel((unsigned)((int)lastpixel + kDelta2[delta]));
        break;
      case 0x80:
        if ((delta = (n >> 3) & 7) != 4)
          setpixel((unsigned)((int)lastpixel + kDelta3[delta]));
        if ((delta = n & 7) != 4)
          setpixel((unsigned)((int)lastpixel + kDelta3[delta]));
        break;
      default:
        setpixel((unsigned)n);
        break;
    }
  }
  return npixels == maxpixels;
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

// CCITT over one strip or tile: `mode` 2 (RLE), 32771 (RLEW), 3 (Group 3,
// `opts` its T4Options: bit 0 two-dimensional) or 4 (Group 4). `runs` holds
// 2 * nruns + 2 words kept for the whole image (runs + 1 is libtiff's run
// array: its reads before the array go to runs[0]), nruns as Fax3SetupState
// computes it; `parity` is the parity of the data's first byte address
// (PIL's buffer holds the file from an even address). Returns 0 where
// libtiff's decoder returns 1, 1 where it returns -1 (an error for a strip;
// TIFFReadEncodedTile takes any nonzero return for success), 2 where
// libtiff reads before its run arrays; *rows_out is the number of rows
// written (the rest of the buffer is left as it was: Group 4 also stops
// at an EOFB or the end of the data with success). *noeol (kept for the
// image) is libtiff's FAXMODE_NOEOL, which Group 3 data that ends between
// an EOL's zeros and its 1 bit sets.
int kt_tiff_fax(const uint8_t* bp, long long cc, uint8_t* op, long long occ,
                int mode, int opts, int width, long long rowbytes,
                uint32_t* runs_mem, int nruns, int parity,
                long long* rows_out, int* noeol) {
  Fax f;
  f.cp = bp;
  f.ep = bp + cc;
  f.base = bp;
  f.lastx = width;
  f.runs = runs_mem + 1;
  f.nruns = nruns;
  const bool two_d = mode == 4 || (mode == 3 && (opts & 1));
  f.curruns = f.runs;
  f.refruns = two_d ? f.runs + nruns : nullptr;
  if (f.refruns) {
    f.refruns[0] = (uint32_t)width;
    f.refruns[1] = 0;
  }
  *rows_out = 0;
  if (rowbytes <= 0 || occ % rowbytes) return kError;
  long long line = 0;
  // `filled`: the row the codec stopped in was written too
  auto done = [&](int status, bool filled = false) {
    *rows_out = line + (filled ? 1 : 0);
    if (f.oob) return 2;
    return status;
  };
  if (mode == 2 || mode == 32771) {
    f.thisrun = f.curruns;
    while (occ > 0) {
      f.a0 = 0;
      f.run_length = 0;
      f.pa = f.thisrun;
      const int r = f.expand1d();
      if (r == kRowOverflow) return done(kError);
      fill_runs(op, f.thisrun, f.pa, (uint32_t)width);
      if (r == kRowEof) return done(kError, true);
      if (mode == 2) {
        f.clr(f.avail - (f.avail & ~7));
      } else {
        f.clr(f.avail - (f.avail & ~15));
        if (f.avail == 0 && ((f.cp - f.base + parity) & 1)) f.cp++;
      }
      op += rowbytes;
      occ -= rowbytes;
      line++;
    }
    return done(kOk);
  }
  if (mode == 3) {
    while (occ > 0) {
      f.a0 = 0;
      f.run_length = 0;
      f.pa = f.thisrun = f.curruns;
      int r;
      // the data ends after an EOL's zeros, before its 1 bit: libtiff
      // 4.7.1 takes the strip for Group 3 data without EOLs, and decodes it
      // again from its first byte, from this row on, with no EOL search
      // (for this strip and the image's strips after it)
      const int sync = *noeol ? (int)Fax::kSynced : f.sync_eol();
      if (sync == Fax::kNoEol) {
        if (!f.cleanup()) return done(kError);
        fill_runs(op, f.thisrun, f.pa, (uint32_t)width);
        return done(kError, true);
      }
      if (sync == Fax::kNoEolBit) {
        *noeol = 1;
        f.cp = f.base;
        f.acc = 0;
        f.avail = 0;
        f.eolcnt = 0;
      }
      if (two_d) {
        if (!f.need8(1)) {
          if (!f.cleanup()) return done(kError);
          fill_runs(op, f.thisrun, f.pa, (uint32_t)width);
          return done(kError, true);
        }
        const uint32_t is1d = f.get(1);
        f.clr(1);
        f.pb = f.refruns;
        f.b1 = (int)*f.pb++;
        r = is1d ? f.expand1d() : f.expand2d();
      } else {
        r = f.expand1d();
      }
      if (r == kRowOverflow) return done(kError);
      fill_runs(op, f.thisrun, f.pa, (uint32_t)width);
      if (r == kRowEof) return done(kError, true);
      if (two_d) {
        if (f.pa < f.thisrun + f.nruns) f.setvalue(0);
        std::swap(f.curruns, f.refruns);
      }
      op += rowbytes;
      occ -= rowbytes;
      line++;
    }
    return done(kOk);
  }
  // Fax4Decode
  while (occ > 0) {
    f.a0 = 0;
    f.run_length = 0;
    f.pa = f.thisrun = f.curruns;
    f.pb = f.refruns;
    f.b1 = (int)*f.pb++;
    const int r = f.expand2d();
    if (r == kRowOverflow) return done(kError);
    if (r == kRowEof || f.eolcnt) {
      f.need16(13);
      f.clr(13);
      if (((width + 7) >> 3) > occ) return done(kError);
      fill_runs(op, f.thisrun, f.pa, (uint32_t)width);
      return done(line > 0 ? kOk : kError, true);
    }
    if (((width + 7) >> 3) > occ) return done(kError);
    fill_runs(op, f.thisrun, f.pa, (uint32_t)width);
    if (!f.setvalue(0)) return done(kError);
    std::swap(f.curruns, f.refruns);
    op += rowbytes;
    occ -= rowbytes;
    line++;
  }
  return done(kOk);
}

// CCITT-encode `rows` rows of `width` pixels (MSB-first bits, 1 black,
// `rowbytes` apart) as `mode` (2, 32771, 3, 4; for 3 `opts` bit 0 codes
// every second row two-dimensionally, bit 2 pads each EOL to end a byte)
// into out (capacity cap); RLEW rows end where libtiff's decoder aligns
// them. Returns the length, or -1 where cap is too small.
long long kt_tiff_fax_encode(const uint8_t* rows_in, int width, int rows,
                             long long rowbytes, int mode, int opts,
                             uint8_t* out, long long cap) {
  FaxWriter w;
  w.track = mode == 32771;
  std::vector<uint8_t> white((size_t)rowbytes, 0);
  const uint8_t* ref = white.data();
  for (int r = 0; r < rows; r++) {
    const uint8_t* row = rows_in + (size_t)r * rowbytes;
    if (mode == 2 || mode == 32771) {
      encode_1d(w, row, width);
      if (mode == 32771)
        w.word_align();
      else
        w.align8();
    } else if (mode == 3) {
      if (opts & 4)
        while ((w.bitpos() + 12 + ((opts & 1) ? 1 : 0)) % 8) w.put(0, 1);
      w.eol();
      const bool one_d = !(opts & 1) || r % 2 == 0;
      if (opts & 1) w.put(one_d ? 1 : 0, 1);
      if (one_d)
        encode_1d(w, row, width);
      else
        encode_2d(w, row, ref, width);
    } else {
      encode_2d(w, row, ref, width);
    }
    ref = row;
  }
  if (mode == 2 || mode == 32771) {
    // libtiff's look-ahead past the last row: where the data ends inside
    // it, NeedBits16 pads with zeros and counts them, and the row's
    // alignment then skips real bits
    w.put(0, 16);
  } else if (mode == 4) {
    w.eol();
    w.eol();
  } else if (mode == 3) {
    for (int k = 0; k < 6; k++) {
      w.eol();
      if (opts & 1) w.put(1, 1);
    }
  }
  w.align8();
  if ((long long)w.out.size() > cap) return -1;
  std::memcpy(out, w.out.data(), w.out.size());
  return (long long)w.out.size();
}

// ThunderScan over one strip: rows of `width` 4-bit pixels, `rowbytes`
// apart, one ThunderDecode a row over the strip's bytes. 0, or 1 where a
// row's pixel count is short or long (libtiff's error).
int kt_tiff_thunder(const uint8_t* bp, long long cc, uint8_t* op,
                    long long occ, int width, long long rowbytes) {
  if (rowbytes <= 0 || occ % rowbytes) return kError;
  while (occ > 0) {
    if (!thunder_row(bp, cc, op, width)) return kError;
    op += rowbytes;
    occ -= rowbytes;
  }
  return kOk;
}

// ThunderScan-encode `rows` rows of `width` 4-bit pixels (one a byte) into
// out, which holds rows * (width + 1) bytes: runs of the last pixel, two-
// and three-bit deltas where they fit, raw values otherwise, and no run
// ends a row. Returns the length.
long long kt_tiff_thunder_encode(const uint8_t* px, int width, int rows,
                                 uint8_t* out) {
  long long len = 0;
  for (int r = 0; r < rows; r++) {
    const uint8_t* p = px + (size_t)r * width;
    int last = 0, x = 0;
    while (x < width) {
      int run = 0;
      while (x + run < width && p[x + run] == last && run < 63) run++;
      if (run >= 2 && x + run < width) {
        out[len++] = (uint8_t)run;
        x += run;
        continue;
      }
      if (x + 3 <= width) {
        const int d0 = p[x] - last, d1 = p[x + 1] - p[x], d2 = p[x + 2] - p[x + 1];
        auto c2 = [](int d) { return d == 0 ? 0 : d == 1 ? 1 : d == -1 ? 3 : -1; };
        if (c2(d0) >= 0 && c2(d1) >= 0 && c2(d2) >= 0) {
          out[len++] = (uint8_t)(0x40 | c2(d0) << 4 | c2(d1) << 2 | c2(d2));
          last = p[x + 2];
          x += 3;
          continue;
        }
      }
      if (x + 2 <= width) {
        const int d0 = p[x] - last, d1 = p[x + 1] - p[x];
        auto c3 = [](int d) { return d >= 0 && d <= 3 ? d : d >= -3 && d < 0 ? 8 + d : -1; };
        if (c3(d0) >= 0 && c3(d1) >= 0) {
          out[len++] = (uint8_t)(0x80 | c3(d0) << 3 | c3(d1));
          last = p[x + 1];
          x += 2;
          continue;
        }
      }
      out[len++] = (uint8_t)(0xc0 | p[x]);
      last = p[x];
      x++;
    }
  }
  return len;
}

}  // extern "C"
