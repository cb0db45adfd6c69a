// The sequential loops of the raster texture decoders, each as PIL 12.1.0
// runs it: BmpImagePlugin.BmpRleDecoder (RLE8 / RLE4, scene/bmp.py),
// TgaRleDecode.c (scene/tga.py), GifDecode.c (scene/gif.py), PcxDecode.c
// (scene/pcx.py), SgiRleDecode.c (scene/sgi.py), PackDecode.c (scene/psd.py),
// QoiImagePlugin.QoiDecoder (scene/qoi.py), BlpImagePlugin's decode_dxt1
// / 3 / 5 (scene/blp.py), SunRleDecode.c (scene/sun.py), BitDecode.c
// (scene/raster.py, for IM's odd bit depths) and FliDecode.c
// (scene/fli.py), and the encoders of the port's SGI, PCX, QOI, SUN and
// FLC writers (scene/assets.py's studio, plugin and rare-format cities). Python parses the headers and
// unpacks the rows; these functions only expand the compressed streams.
// Built with g++ at first use (hostlib.load) and called through ctypes.
//
// Status codes: 0 done, 1 the data ends first (PIL: "image file is
// truncated"), 2 a broken stream, 3 an overrun, 4 a short delta record
// (PIL: "not enough values to unpack").

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { kOk = 0, kTruncated = 1, kBroken = 2, kOverrun = 3, kUnpack = 4 };

}  // namespace

extern "C" {

// BmpRleDecoder.decode: reads from byte `pos` of the file (`n` bytes in
// all; the 16-bit alignment of absolute runs is on the file position) and
// appends palette indices to `out` (capacity `cap`) until `dest_len`
// indices are there or the stream ends; *out_len gets their count (it may
// pass dest_len, as PIL's buffer does).
int kt_bmp_rle(const char* data_, long long n, long long pos, int rle4,
               int xsize, long long dest_len, uint8_t* out, long long cap,
               long long* out_len) {
    const uint8_t* data = reinterpret_cast<const uint8_t*>(data_);
    long long len = 0;
    long long x = 0;
    int status = kOk;
    auto push = [&](uint8_t v) {
        if (len < cap) out[len] = v;
        ++len;
    };
    while (len < dest_len) {
        if (pos + 2 > n) break;
        int num_pixels = data[pos];
        int byte = data[pos + 1];
        pos += 2;
        if (num_pixels) {
            if (x + num_pixels > xsize) {
                num_pixels = (int)(xsize - x > 0 ? xsize - x : 0);
            }
            if (rle4) {
                for (int i = 0; i < num_pixels; ++i)
                    push(i % 2 == 0 ? (uint8_t)(byte >> 4)
                                    : (uint8_t)(byte & 0x0F));
            } else {
                for (int i = 0; i < num_pixels; ++i) push((uint8_t)byte);
            }
            x += num_pixels;
        } else if (byte == 0) {
            while (len % xsize != 0) push(0);
            x = 0;
        } else if (byte == 1) {
            break;
        } else if (byte == 2) {
            // PIL reads two bytes, then the two that it uses
            long long got = n - pos < 2 ? (n - pos > 0 ? n - pos : 0) : 2;
            pos += got;
            if (got < 2) break;
            if (n - pos < 2) {
                status = kUnpack;
                break;
            }
            int right = data[pos], up = data[pos + 1];
            pos += 2;
            long long add = right + (long long)up * xsize;
            for (long long i = 0; i < add; ++i) push(0);
            x = len % xsize;
        } else {
            long long byte_count = rle4 ? byte / 2 : byte;
            long long avail = n - pos > 0 ? n - pos : 0;
            long long got = byte_count < avail ? byte_count : avail;
            for (long long i = 0; i < got; ++i) {
                uint8_t b = data[pos + i];
                if (rle4) {
                    push(b >> 4);
                    push(b & 0x0F);
                } else {
                    push(b);
                }
            }
            pos += got;
            if (got < byte_count) break;
            x += byte;
            if (pos % 2 != 0) pos += 1;
        }
    }
    *out_len = len;
    return status;
}

// TgaRleDecode: `depth` bytes a pixel, `row_bytes` bytes a row, `rows`
// rows, written in stream order into `out` (rows * row_bytes bytes; the
// caller flips them for a bottom-up file). A literal packet runs on into
// the next row; a run that passes the end of its row is an overrun.
int kt_tga_rle(const char* data_, long long n, long long pos, int depth,
               int row_bytes, int rows, uint8_t* out) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(data_) + pos;
    long long bytes = n - pos;
    if (bytes < 0) bytes = 0;
    std::vector<uint8_t> line(row_bytes > 0 ? row_bytes : 1);
    long long x = 0;
    int y = 0;
    for (;;) {
        if (bytes < 1) return kTruncated;
        int extra = 0;
        long long cnt = (long long)depth * ((p[0] & 0x7f) + 1);
        if (p[0] & 0x80) {
            if (bytes < 1 + depth) return kTruncated;
            if (x + cnt > row_bytes) return kOverrun;
            for (long long i = 0; i < cnt; i += depth)
                std::memcpy(line.data() + x + i, p + 1, depth);
            p += 1 + depth;
            bytes -= 1 + depth;
        } else {
            if (bytes < 1 + cnt) return kTruncated;
            if (x + cnt > row_bytes) {
                extra = (int)cnt;
                cnt = row_bytes - x;
                extra -= (int)cnt;
            }
            std::memcpy(line.data() + x, p + 1, cnt);
            p += 1 + cnt;
            bytes -= 1 + cnt;
        }
        for (;;) {
            x += cnt;
            if (x >= row_bytes) {
                std::memcpy(out + (long long)y * row_bytes, line.data(),
                            row_bytes);
                x = 0;
                if (++y >= rows) return kOk;
            }
            if (extra == 0 || x > 0) break;
            cnt = extra >= row_bytes ? row_bytes : extra;
            std::memcpy(line.data() + x, p, cnt);
            p += cnt;
            bytes -= cnt;
            extra -= (int)cnt;
        }
    }
}

// GifDecode: the LZW codes (initial size bits + 1, 12 bits at most, clear
// and end codes, a full table that stops growing) in the sub-blocks from
// `pos`, written into the (ysize, xsize) frame `out` of row stride
// `stride`, rows in GIF's interlaced order when `interlace`. Returns kOk
// when the frame is full; a stream that ends first is truncated, one that
// refers past the table broken.
int kt_gif_lzw(const char* data_, long long n, long long pos, int bits,
               int interlace, int xsize, int ysize, uint8_t* out,
               int stride) {
    const int kTable = 4096, kBits = 12;
    const uint8_t* ptr = reinterpret_cast<const uint8_t*>(data_) + pos;
    long long bytes = n - pos;
    if (bytes < 0) bytes = 0;
    uint8_t buffer[4096];
    uint8_t dat[4096] = {0};
    uint16_t link[4096] = {0};
    const int clear = 1 << bits, end = clear + 1;
    int ilace = interlace ? 1 : 0, step = interlace ? 8 : 1;
    uint8_t last = 0;
    int state = 1, next = 0, codesize = 0, codemask = 0, bufferindex = 0;
    int lastdata = 0, lastcode = 0, blocksize = 0, bitcount = 0;
    uint32_t bitbuffer = 0;
    int x = 0, y = 0;
    uint8_t* row = out;
    // advance to the next row; false once the frame is full
    auto newline = [&]() -> bool {
        x = 0;
        y += step;
        while (y >= ysize) {
            switch (ilace) {
                case 1: y = 4; ilace = 2; break;
                case 2: step = 4; y = 2; ilace = 3; break;
                case 3: step = 2; y = 1; ilace = 0; break;
                default: return false;
            }
        }
        row = out + (long long)y * stride;
        return true;
    };
    for (;;) {
        if (state == 1) {
            next = clear + 2;
            codesize = bits + 1;
            codemask = (1 << codesize) - 1;
            bufferindex = kTable;
            state = 2;
        }
        const uint8_t* p;
        int i;
        if (bufferindex < kTable) {
            i = kTable - bufferindex;
            p = &buffer[bufferindex];
            bufferindex = kTable;
        } else {
            while (bitcount < codesize) {
                if (blocksize > 0) {
                    int c = *ptr++;
                    bytes--;
                    blocksize--;
                    bitbuffer |= (uint32_t)c << bitcount;
                    bitcount += 8;
                } else {
                    if (bytes < 1) return kTruncated;
                    int c = *ptr;
                    if (bytes < c + 1) return kTruncated;
                    blocksize = c;
                    ptr++;
                    bytes--;
                }
            }
            int c = (int)(bitbuffer & (uint32_t)codemask);
            bitbuffer >>= codesize;
            bitcount -= codesize;
            if (c == clear) {
                if (state != 2) state = 1;
                continue;
            }
            if (c == end) {
                // PIL's decoder returns for more data here, and its loader
                // finds the file's end first
                return kTruncated;
            }
            i = 1;
            if (state == 2) {
                if (c > clear) return kBroken;
                lastdata = lastcode = c;
                state = 3;
            } else {
                int thiscode = c;
                if (c > next) return kBroken;
                if (c == next) {
                    if (bufferindex <= 0) return kBroken;
                    buffer[--bufferindex] = (uint8_t)lastdata;
                    c = lastcode;
                }
                while (c >= clear) {
                    if (bufferindex <= 0 || c >= kTable) return kBroken;
                    buffer[--bufferindex] = dat[c];
                    c = link[c];
                }
                lastdata = c;
                if (next < kTable) {
                    dat[next] = (uint8_t)c;
                    link[next] = (uint16_t)lastcode;
                    if (next == codemask && codesize < kBits) {
                        codesize++;
                        codemask = (1 << codesize) - 1;
                    }
                    next++;
                }
                lastcode = thiscode;
            }
            last = (uint8_t)lastdata;
            p = &last;
        }
        if (y >= ysize) return kOverrun;
        for (int k = 0; k < i; ++k) {
            row[x] = p[k];
            if (++x >= xsize) {
                if (!newline()) return kOk;
            }
        }
    }
}

// PcxDecode: rows of `bytes` bytes (planes x stride) from `pos`, written
// into `out` (rows * bytes). A run that passes its row's end is cut and
// flags an overrun (PIL decodes on and raises at the end). Before a row is
// unpacked, PIL moves its planes together where their stride is longer
// than a plane: for the bit-plane modes (`bits` 2 or 4, the planes) a
// plane is (xsize + 7) / 8 bytes, else xsize bytes, bytes / xsize of them.
int kt_pcx_rle(const char* data_, long long n, long long pos, int xsize,
               int bits, int bytes, int rows, uint8_t* out) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(data_);
    std::vector<uint8_t> line(bytes > 0 ? bytes : 1);
    int x = 0, y = 0;
    bool overrun = false;
    for (;;) {
        if (pos >= n) return kTruncated;
        if ((p[pos] & 0xC0) == 0xC0) {
            if (pos + 1 >= n) return kTruncated;
            int cnt = p[pos] & 0x3F;
            for (; cnt > 0; --cnt) {
                if (x >= bytes) {
                    overrun = true;
                    break;
                }
                line[x++] = p[pos + 1];
            }
            pos += 2;
        } else {
            line[x++] = p[pos++];
        }
        if (x >= bytes) {
            int xs, bands, stride;
            if (bits == 2 || bits == 4) {
                xs = (xsize + 7) / 8;
                bands = bits;
                stride = bytes / bits;
            } else {
                xs = xsize;
                bands = bytes / xsize;
                stride = bands ? bytes / bands : 0;
            }
            if (stride > xs)
                for (int i = 1; i < bands; ++i)
                    std::memmove(&line[(size_t)i * xs],
                                 &line[(size_t)i * stride], xs);
            std::memcpy(out + (long long)y * bytes, line.data(), bytes);
            x = 0;
            if (++y >= rows) return overrun ? kOverrun : kOk;
        }
    }
}

namespace {

inline uint32_t be32(const uint8_t* b) {
    return (uint32_t)b[0] << 24 | (uint32_t)b[1] << 16 | (uint32_t)b[2] << 8 |
           (uint32_t)b[3];
}

// SgiRleDecode's expandrow (bpc 1) and expandrow2 (bpc 2): -1 an overrun, 1
// the row's bytes end without a terminator (PIL stops decoding, no error),
// 0 done. `n` counts down from the row's byte length once per chunk.
int sgi_row(uint8_t* dest, const uint8_t* src, int n, int z, int xsize,
            const uint8_t* end, int bpc) {
    int x = 0;
    for (; n > 0; n--) {
        uint8_t pixel;
        if (bpc == 1) {
            if (src > end) return -1;
            pixel = *src++;
        } else {
            if (src + 1 > end) return -1;
            pixel = src[1];
            src += 2;
        }
        if (n == 1 && pixel != 0) return n;
        uint8_t count = pixel & 0x7F;
        if (!count) return 0;
        if (x + count > xsize) return -1;
        x += count;
        if (pixel & 0x80) {
            if (src + (long long)bpc * count > end) return -1;
            while (count--) {
                std::memcpy(dest, src, bpc);
                src += bpc;
                dest += (long long)z * bpc;
            }
        } else {
            if (src + (bpc - 1) > end || (bpc == 2 && src + 2 > end))
                return -1;
            while (count--) {
                std::memcpy(dest, src, bpc);
                dest += (long long)z * bpc;
            }
            src += bpc;
        }
    }
    return 0;
}

}  // namespace

// ImagingSgiRleDecode over the whole file (the header is 512 bytes): the
// offset and length tables, then each row of each of `zsize` channels into
// one interleaved row buffer that persists from row to row, stored bottom-up
// into `out` (ysize rows of xsize * zsize * bpc bytes). A row whose bytes
// end without a terminator stops the decode with no error; rows not reached
// stay as they are (zero).
int kt_sgi_rle(const char* data_, long long n, int bpc, int xsize, int ysize,
               int zsize, uint8_t* out) {
    const uint8_t* base = reinterpret_cast<const uint8_t*>(data_);
    long long bufsize = n - 512;
    long long tablen = (long long)zsize * ysize;
    if (bufsize < 8 * tablen) return kOverrun;
    const uint8_t* ptr = base + 512;
    const uint8_t* end = ptr + bufsize - 1;
    long long row_bytes = (long long)xsize * zsize * bpc;
    std::vector<uint8_t> buffer((size_t)xsize * zsize * 2, 0);
    int y = ysize - 1;
    for (int rowno = 0; rowno < ysize; ++rowno, --y) {
        for (int ch = 0; ch < zsize; ++ch) {
            long long t = rowno + (long long)ch * ysize;
            uint32_t off = be32(ptr + 4 * t);
            uint32_t len = be32(ptr + 4 * tablen + 4 * t);
            if (off < 512) return kOverrun;
            off -= 512;
            // no check of the length: the row stops at its terminator, and
            // reading past the file's end is the overrun
            int st = sgi_row(&buffer[(size_t)ch * bpc], ptr + off, (int)len,
                             zsize, xsize, end, bpc);
            if (st == -1) return kOverrun;
            if (st == 1) return kOk;
        }
        std::memcpy(out + (long long)y * row_bytes, buffer.data(),
                    (size_t)row_bytes);
    }
    return kOk;
}

// PackDecode (PIL's packbits, as the PSD plugin uses it): one band of
// `rows` rows of `bytes` bytes from `pos` to the end of the file; a run or
// literal that passes its row's end is cut, 0x80 is a no-op, and data that
// ends before the last row is truncated.
int kt_packbits_rows(const char* data_, long long n, long long pos, int bytes,
                     int rows, uint8_t* out) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(data_);
    int x = 0, y = 0;
    uint8_t* row = out;
    for (;;) {
        if (pos >= n) return kTruncated;
        uint8_t h = p[pos];
        if (h & 0x80) {
            if (h == 0x80) {
                ++pos;
                continue;
            }
            if (pos + 2 > n) return kTruncated;
            for (int k = 257 - h; k > 0 && x < bytes; --k) row[x++] = p[pos + 1];
            pos += 2;
        } else {
            long long m = (long long)h + 2;
            if (n - pos < m) return kTruncated;
            for (long long i = 1; i < m && x < bytes; ++i) row[x++] = p[pos + i];
            pos += m;
        }
        if (x >= bytes) {
            x = 0;
            if (++y >= rows) return kOk;
            row += bytes;
        }
    }
}

// QoiDecoder.decode: ops from `pos` until `npix` pixels of `bands` (3 or 4)
// bytes are out (a run may pass the end: `out` holds 62 pixels more). The
// index keeps the pixels that PIL's dict keeps: set after every op but a
// run, and read as (0, 0, 0, 0) where unset. Data that ends inside an op is
// truncated (PIL raises there).
int kt_qoi(const char* data_, long long n, long long pos, long long npix,
           int bands, uint8_t* out) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(data_);
    uint8_t index[64][4] = {{0}};
    bool seen[64] = {false};
    uint8_t px[4] = {0, 0, 0, 255};
    long long dest = npix * bands, len = 0;
    while (len < dest) {
        if (pos >= n) return kTruncated;
        int b = p[pos++];
        uint8_t v[4];
        if (b == 0xFE) {
            if (n - pos < 3) return kTruncated;
            v[0] = p[pos], v[1] = p[pos + 1], v[2] = p[pos + 2], v[3] = px[3];
            pos += 3;
        } else if (b == 0xFF) {
            if (n - pos < 4) return kTruncated;
            std::memcpy(v, p + pos, 4);
            pos += 4;
        } else {
            int op = b >> 6;
            if (op == 0) {
                int k = b & 0x3F;
                if (seen[k]) std::memcpy(v, index[k], 4);
                else v[0] = v[1] = v[2] = v[3] = 0;
            } else if (op == 1) {
                v[0] = (uint8_t)(px[0] + ((b >> 4) & 3) - 2);
                v[1] = (uint8_t)(px[1] + ((b >> 2) & 3) - 2);
                v[2] = (uint8_t)(px[2] + (b & 3) - 2);
                v[3] = px[3];
            } else if (op == 2) {
                if (pos >= n) return kTruncated;
                int b2 = p[pos++];
                int dg = (b & 0x3F) - 32;
                v[0] = (uint8_t)(px[0] + dg + ((b2 >> 4) & 0xF) - 8);
                v[1] = (uint8_t)(px[1] + dg);
                v[2] = (uint8_t)(px[2] + dg + (b2 & 0xF) - 8);
                v[3] = px[3];
            } else {
                int run = (b & 0x3F) + 1;
                for (int r = 0; r < run; ++r, len += bands)
                    std::memcpy(out + len, px, bands);
                continue;
            }
        }
        std::memcpy(px, v, 4);
        int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
        std::memcpy(index[h], v, 4);
        seen[h] = true;
        std::memcpy(out + len, v, bands);
        len += bands;
    }
    return kOk;
}

// BlpImagePlugin's decode_dxt1 / 3 / 5 over ceil(h / 4) block rows of
// `linesize` bytes from `pos`: the byte stream PIL hands to its raw
// decoder, each block row as 4 rows of ceil(w / 4) * 4 pixels of `bpp`
// bytes (DXT1 without alpha 3, else 4). `kind` 0 DXT1, 1 DXT3, 7 DXT5.
int kt_blp_dxt(const char* data_, long long n, long long pos, int w, int h,
               int kind, int alpha, uint8_t* out) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(data_);
    int blocks = (w + 3) / 4, brows = (h + 3) / 4;
    int bsize = kind == 0 ? 8 : 16;
    int bpp = (kind == 0 && !alpha) ? 3 : 4;
    long long linesize = (long long)blocks * bsize;
    if (pos < 0 || n - pos < linesize * brows) return kTruncated;
    long long row_len = (long long)blocks * 4 * bpp;
    for (int yb = 0; yb < brows; ++yb) {
        const uint8_t* line = p + pos + linesize * yb;
        uint8_t* rows = out + (long long)yb * 4 * row_len;
        for (int bi = 0; bi < blocks; ++bi) {
            const uint8_t* blk = line + (long long)bi * bsize;
            const uint8_t* col = kind == 0 ? blk : blk + 8;
            int c0 = col[0] | col[1] << 8, c1 = col[2] | col[3] << 8;
            uint32_t code = (uint32_t)col[4] | (uint32_t)col[5] << 8 |
                            (uint32_t)col[6] << 16 | (uint32_t)col[7] << 24;
            int r0 = ((c0 >> 11) & 0x1F) << 3, g0 = ((c0 >> 5) & 0x3F) << 2,
                b0 = (c0 & 0x1F) << 3;
            int r1 = ((c1 >> 11) & 0x1F) << 3, g1 = ((c1 >> 5) & 0x3F) << 2,
                b1 = (c1 & 0x1F) << 3;
            uint64_t abits = 0;
            if (kind == 7)
                for (int k = 0; k < 6; ++k) abits |= (uint64_t)blk[2 + k] << (8 * k);
            for (int j = 0; j < 4; ++j) {
                for (int i = 0; i < 4; ++i) {
                    int t = 4 * j + i;
                    int c = (code >> (2 * t)) & 3;
                    int r, g, b, a = 255;
                    bool three = kind == 0 && !(c0 > c1);
                    if (c == 0) r = r0, g = g0, b = b0;
                    else if (c == 1) r = r1, g = g1, b = b1;
                    else if (c == 2 && !three)
                        r = (2 * r0 + r1) / 3, g = (2 * g0 + g1) / 3,
                        b = (2 * b0 + b1) / 3;
                    else if (c == 2)
                        r = (r0 + r1) / 2, g = (g0 + g1) / 2, b = (b0 + b1) / 2;
                    else if (!three)
                        r = (2 * r1 + r0) / 3, g = (2 * g1 + g0) / 3,
                        b = (2 * b1 + b0) / 3;
                    else
                        r = g = b = a = 0;
                    if (kind == 1) {
                        int nib = blk[t / 2];
                        a = 17 * ((t & 1) ? nib >> 4 : nib & 0xF);
                    } else if (kind == 7) {
                        int a0 = blk[0], a1 = blk[1];
                        int ac = (int)((abits >> (3 * t)) & 7);
                        if (ac == 0) a = a0;
                        else if (ac == 1) a = a1;
                        else if (a0 > a1)
                            a = ((8 - ac) * a0 + (ac - 1) * a1) / 7;
                        else if (ac == 6) a = 0;
                        else if (ac == 7) a = 255;
                        else a = ((6 - ac) * a0 + (ac - 1) * a1) / 5;
                    }
                    uint8_t* o = rows + j * row_len + ((long long)bi * 4 + i) * bpp;
                    o[0] = (uint8_t)r, o[1] = (uint8_t)g, o[2] = (uint8_t)b;
                    if (bpp == 4) o[3] = (uint8_t)a;
                }
            }
        }
    }
    return kOk;
}

// The SGI writer's RLE of one row of one channel (`n` samples `step` bytes
// apart): runs of 3 to 127 equal bytes, literals of up to 127, then the
// terminating 0. `out` holds 2 n + 2 bytes; returns the length.
long long kt_sgi_rle_encode(const uint8_t* in, long long n, long long step,
                            uint8_t* out) {
    long long i = 0, len = 0;
    auto at = [&](long long k) { return in[k * step]; };
    while (i < n) {
        long long j = i;
        while (j + 1 < n && at(j + 1) == at(i) && j - i < 126) ++j;
        if (j - i >= 2) {
            out[len++] = (uint8_t)(j - i + 1);
            out[len++] = at(i);
            i = j + 1;
            continue;
        }
        j = i;
        while (j < n && j - i < 127 &&
               !(j + 2 < n && at(j + 1) == at(j) && at(j + 2) == at(j)))
            ++j;
        if (j == i) j = i + 1;
        out[len++] = (uint8_t)(0x80 | (j - i));
        for (long long k = i; k < j; ++k) out[len++] = at(k);
        i = j;
    }
    out[len++] = 0;
    return len;
}

// The PCX writer's RLE of one row: runs of up to 63 equal bytes as
// (0xC0 | count, byte), a single byte below 0xC0 as itself. `out` holds 2 n
// bytes; returns the length.
long long kt_pcx_rle_encode(const uint8_t* in, long long n, uint8_t* out) {
    long long i = 0, len = 0;
    while (i < n) {
        long long j = i;
        while (j + 1 < n && in[j + 1] == in[i] && j - i < 62) ++j;
        long long cnt = j - i + 1;
        if (cnt > 1 || (in[i] & 0xC0) == 0xC0) out[len++] = (uint8_t)(0xC0 | cnt);
        out[len++] = in[i];
        i = j + 1;
    }
    return len;
}

// The QOI writer: `npix` pixels of `bands` (3 or 4) bytes into ops that
// PIL's QoiDecoder reads back to the same pixels (its index, which a run
// leaves alone, is tracked as it keeps it). `out` holds 5 npix + 1 bytes;
// returns the length of the ops.
long long kt_qoi_encode(const uint8_t* in, long long npix, int bands,
                        uint8_t* out) {
    uint8_t index[64][4] = {{0}};
    bool seen[64] = {false};
    uint8_t px[4] = {0, 0, 0, 255};
    long long len = 0, run = 0;
    for (long long k = 0; k < npix; ++k) {
        uint8_t v[4] = {in[k * bands], in[k * bands + 1], in[k * bands + 2],
                        bands == 4 ? in[k * bands + 3] : px[3]};
        if (std::memcmp(v, px, 4) == 0) {
            if (++run == 62) {
                out[len++] = (uint8_t)(0xC0 | (run - 1));
                run = 0;
            }
            continue;
        }
        if (run) {
            out[len++] = (uint8_t)(0xC0 | (run - 1));
            run = 0;
        }
        int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
        int dr = (int8_t)(uint8_t)(v[0] - px[0]);
        int dg = (int8_t)(uint8_t)(v[1] - px[1]);
        int db = (int8_t)(uint8_t)(v[2] - px[2]);
        if (seen[h] && std::memcmp(index[h], v, 4) == 0) {
            out[len++] = (uint8_t)h;
        } else if (v[3] != px[3]) {
            out[len++] = 0xFF;
            std::memcpy(out + len, v, 4);
            len += 4;
        } else if (dr >= -2 && dr <= 1 && dg >= -2 && dg <= 1 && db >= -2 &&
                   db <= 1) {
            out[len++] = (uint8_t)(0x40 | (dr + 2) << 4 | (dg + 2) << 2 |
                                   (db + 2));
        } else if (dg >= -32 && dg <= 31 && dr - dg >= -8 && dr - dg <= 7 &&
                   db - dg >= -8 && db - dg <= 7) {
            out[len++] = (uint8_t)(0x80 | (dg + 32));
            out[len++] = (uint8_t)((dr - dg + 8) << 4 | (db - dg + 8));
        } else {
            out[len++] = 0xFE;
            std::memcpy(out + len, v, 3);
            len += 3;
        }
        std::memcpy(px, v, 4);
        std::memcpy(index[h], v, 4);
        seen[h] = true;
    }
    if (run) out[len++] = (uint8_t)(0xC0 | (run - 1));
    return len;
}

// SunRleDecode.c: rows of `bytes` bytes (no padding) from byte `pos`; a
// byte 0x80 starts an escape: 0x80 0x00 is a literal 0x80, 0x80 n v a run
// of n + 1 bytes v, which may run on into the next rows. Status 1 when the
// data ends before the last row (PIL then reads no more: "image file is
// truncated").
int kt_sun_rle(const char* data_, long long n, long long pos, long long bytes,
               int ysize, uint8_t* out) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(data_) + pos;
    long long left = n - pos;
    long long total = bytes * ysize, x = 0;
    while (x < total) {
        if (left <= 0) return kTruncated;
        if (p[0] == 0x80) {
            if (left < 2) return kTruncated;
            long long run = p[1];
            if (run == 0) {
                out[x++] = 0x80;
                p += 2;
                left -= 2;
                continue;
            }
            if (left < 3) return kTruncated;
            run += 1;
            if (run > total - x) run = total - x;
            std::memset(out + x, p[2], (size_t)run);
            x += run;
            p += 3;
            left -= 3;
        } else {
            out[x++] = p[0];
            p += 1;
            left -= 1;
        }
    }
    return kOk;
}

// The SUN writer's RLE (SunRleDecode.c's inverse): runs of 3 to 256 bytes,
// a 0x80 byte escaped; returns the bytes written.
long long kt_sun_rle_encode(const uint8_t* in, long long n, uint8_t* out) {
    long long len = 0, i = 0;
    while (i < n) {
        long long j = i;
        while (j + 1 < n && in[j + 1] == in[i] && j - i < 255) ++j;
        long long run = j - i + 1;
        if (run >= 3 || in[i] == 0x80) {
            if (run == 1) {
                out[len++] = 0x80;
                out[len++] = 0;
            } else {
                out[len++] = 0x80;
                out[len++] = (uint8_t)(run - 1);
                out[len++] = in[i];
            }
            i = j + 1;
        } else {
            out[len++] = in[i++];
        }
    }
    return len;
}

// BitDecode.c with the settings IM gives it (pad 8, fill 3, unsigned,
// bottom-up): fields of `bits` bits from byte `pos` into a float image of
// xsize x ysize. A byte enters the bit buffer above the bits it holds and
// a field leaves from the buffer's low end. The bit count (not the buffer)
// is reset at the end of each row, so a row's leftover high bits stay in
// the buffer and are OR-ed into the next row's first byte, as in PIL. Rows
// run from the bottom up. Status 1 when the bytes end before the last row.
int kt_bit_decode(const char* data_, long long n, long long pos, int xsize,
                  int ysize, int bits, float* out) {
    const uint8_t* data = reinterpret_cast<const uint8_t*>(data_);
    if (bits < 1 || bits >= 32) return kBroken;
    unsigned long mask = (1UL << bits) - 1;
    unsigned long bitbuffer = 0;
    int bitcount = 0;
    long long x = 0, y = ysize - 1;
    for (long long k = pos; k < n; ++k) {
        uint8_t byte = data[k];
        bitbuffer |= (unsigned long)byte << bitcount;
        bitcount += 8;
        while (bitcount >= bits) {
            unsigned long v = bitbuffer & mask;
            if (bitcount > 32)
                bitbuffer = byte >> (8 - (bitcount - bits));
            else
                bitbuffer >>= bits;
            bitcount -= bits;
            out[y * xsize + x] = (float)v;
            if (++x >= xsize) {
                if (--y < 0) return kOk;
                x = 0;
                bitcount = 0;
            }
        }
    }
    return kTruncated;
}

namespace {

inline int fli_i16(const uint8_t* p) { return p[0] + (p[1] << 8); }

inline int fli_i32(const uint8_t* p) {
    return (int32_t)((uint32_t)p[0] | (uint32_t)p[1] << 8 |
                     (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24);
}

}  // namespace

// FliDecode.c on one buffer of `bytes` bytes, as ImageFile.load hands it
// over: the frame chunk (size, 0xF1FA, subchunk count) and its subchunks
// (4 / 11 colour and 18 postage stamp ignored, 7 SS2 word delta, 12 LC
// byte delta, 13 BLACK, 15 BRUN, 16 COPY), drawn into `img`, xsize x
// ysize palette indices. Returns what PIL's decoder returns: -1 at the end
// of the frame, else the bytes consumed (0: the frame is not all there
// yet); *err is 0, or PIL's error code (-2 broken, -9 overrun, -10 unknown
// chunk).
long long kt_fli(const char* buf_, long long bytes, int xsize, int ysize,
                 uint8_t* img, int* err) {
    const uint8_t* buf = reinterpret_cast<const uint8_t*>(buf_);
    const uint8_t* ptr = buf;
    const int kBrokenCode = -2, kOverrunCode = -9, kUnknownCode = -10;
    *err = 0;
    if (bytes < 4) return 0;
    long long framesize = (uint32_t)fli_i32(ptr);
    if (bytes + (bytes % 2) < framesize) return 0;
    if (bytes < 8) {
        *err = kOverrunCode;
        return -1;
    }
    if (fli_i16(ptr + 4) != 0xF1FA) {
        *err = kUnknownCode;
        return -1;
    }
    int chunks = fli_i16(ptr + 6);
    ptr += 16;
    bytes -= 16;
#define KT_FLI_OOB(off)                                  \
    if ((data + (off)) > ptr + bytes) {                  \
        *err = kOverrunCode;                             \
        return -1;                                       \
    }
    for (int c = 0; c < chunks; c++) {
        if (bytes < 10) {
            *err = kOverrunCode;
            return -1;
        }
        const uint8_t* data = ptr + 6;
        int i = 0, x = 0, y, l, lines, ymax;
        switch (fli_i16(ptr + 4)) {
            case 4:
            case 11:
                break;
            case 7: {
                lines = fli_i16(data);
                data += 2;
                for (l = y = 0; l < lines && y < ysize; l++, y++) {
                    uint8_t* local = img + (long long)y * xsize;
                    int p, packets;
                    KT_FLI_OOB(2)
                    packets = fli_i16(data);
                    data += 2;
                    while (packets & 0x8000) {
                        if (packets & 0x4000) {
                            y += 65536 - packets;
                            if (y >= ysize) {
                                *err = kOverrunCode;
                                return -1;
                            }
                            local = img + (long long)y * xsize;
                        } else {
                            local[xsize - 1] = (uint8_t)packets;
                        }
                        KT_FLI_OOB(2)
                        packets = fli_i16(data);
                        data += 2;
                    }
                    for (p = x = 0; p < packets; p++) {
                        KT_FLI_OOB(2)
                        x += data[0];
                        if (data[1] >= 128) {
                            KT_FLI_OOB(4)
                            i = 256 - data[1];
                            if (x + i + i > xsize) break;
                            for (int j = 0; j < i; j++) {
                                local[x++] = data[2];
                                local[x++] = data[3];
                            }
                            data += 2 + 2;
                        } else {
                            i = 2 * (int)data[1];
                            if (x + i > xsize) break;
                            KT_FLI_OOB(2 + i)
                            std::memcpy(local + x, data + 2, i);
                            data += 2 + i;
                            x += i;
                        }
                    }
                    if (p < packets) break;
                }
                if (l < lines) {
                    *err = kOverrunCode;
                    return -1;
                }
                break;
            }
            case 12: {
                y = fli_i16(data);
                ymax = y + fli_i16(data + 2);
                data += 4;
                for (; y < ymax && y < ysize; y++) {
                    uint8_t* out = img + (long long)y * xsize;
                    KT_FLI_OOB(1)
                    int p, packets = *data++;
                    for (p = x = 0; p < packets; p++, x += i) {
                        KT_FLI_OOB(2)
                        x += data[0];
                        if (data[1] & 0x80) {
                            i = 256 - data[1];
                            if (x + i > xsize) break;
                            KT_FLI_OOB(3)
                            std::memset(out + x, data[2], i);
                            data += 3;
                        } else {
                            i = data[1];
                            if (x + i > xsize) break;
                            KT_FLI_OOB(2 + i)
                            std::memcpy(out + x, data + 2, i);
                            data += i + 2;
                        }
                    }
                    if (p < packets) break;
                }
                if (y < ymax) {
                    *err = kOverrunCode;
                    return -1;
                }
                break;
            }
            case 13:
                std::memset(img, 0, (size_t)xsize * ysize);
                break;
            case 15:
                for (y = 0; y < ysize; y++) {
                    uint8_t* out = img + (long long)y * xsize;
                    data += 1;
                    for (x = 0; x < xsize; x += i) {
                        KT_FLI_OOB(2)
                        if (data[0] & 0x80) {
                            i = 256 - data[0];
                            if (x + i > xsize) break;
                            KT_FLI_OOB(i + 1)
                            std::memcpy(out + x, data + 1, i);
                            data += i + 1;
                        } else {
                            i = data[0];
                            if (x + i > xsize) break;
                            std::memset(out + x, data[1], i);
                            data += 2;
                        }
                    }
                    if (x != xsize) {
                        *err = kOverrunCode;
                        return -1;
                    }
                }
                break;
            case 16:
                if (data + (long long)xsize * ysize > ptr + bytes)
                    return ptr - buf;
                std::memcpy(img, data, (size_t)xsize * ysize);
                break;
            case 18:
                break;
            default:
                *err = kUnknownCode;
                return -1;
        }
        int advance = fli_i32(ptr);
        if (advance == 0) {
            *err = kBrokenCode;
            return -1;
        }
        if (advance < 0 || advance > bytes) {
            *err = kOverrunCode;
            return -1;
        }
        ptr += advance;
        bytes -= advance;
    }
#undef KT_FLI_OOB
    return -1;
}

// The FLC writer's BRUN lines (FliDecode.c's case 15 inverse): a packet
// count byte, then runs (count 1..127, one byte) and literals (-count
// 1..128, the bytes); returns the bytes written.
long long kt_fli_brun_encode(const uint8_t* in, int xsize, int ysize,
                             uint8_t* out) {
    long long len = 0;
    for (int y = 0; y < ysize; ++y) {
        const uint8_t* row = in + (long long)y * xsize;
        long long count_at = len++;
        int packets = 0, x = 0;
        while (x < xsize) {
            int j = x;
            while (j + 1 < xsize && row[j + 1] == row[x] && j - x < 126) ++j;
            if (j - x >= 2) {
                out[len++] = (uint8_t)(j - x + 1);
                out[len++] = row[x];
                x = j + 1;
            } else {
                int k = x + 1;
                while (k < xsize && k - x < 128 &&
                       !(k + 2 < xsize && row[k] == row[k + 1] &&
                         row[k] == row[k + 2]))
                    ++k;
                out[len++] = (uint8_t)(256 - (k - x));
                std::memcpy(out + len, row + x, k - x);
                len += k - x;
                x = k;
            }
            ++packets;
        }
        out[count_at] = (uint8_t)(packets > 255 ? 0 : packets);
    }
    return len;
}

}  // extern "C"
