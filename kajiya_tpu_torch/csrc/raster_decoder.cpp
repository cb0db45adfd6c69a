// The sequential loops of the BMP, TGA and GIF texture decoders
// (scene/bmp.py, scene/tga.py, scene/gif.py), each as PIL 12.1.0 runs it:
// BmpImagePlugin.BmpRleDecoder (RLE8 / RLE4), TgaRleDecode.c and
// GifDecode.c. Python parses the headers and unpacks the rows; these
// functions only expand the compressed streams. Built with g++ at first use
// (hostlib.load) and called through ctypes.
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

}  // extern "C"
