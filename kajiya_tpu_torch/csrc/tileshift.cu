// Per-tile shift for Hopper (sm_90a): kernel S.
//
// Replaces kajiya_tpu/ops/tileshift_pallas.py:41 `_kernel` (via tile_shift):
//   out[y, x, :] = img[clamp(y + dy_t, 0, H-1), clamp(x + dx_t, 0, W-1), :]
// where (dy_t, dx_t) is one int32 offset per (8, 128) tile t of the output,
// clipped to +-16 rows / +-64 columns. The ReSTIR spatial passes fetch every
// neighbour tap of a whole half-res plane this way.
//
// The TPU kernel edge-pads the image so that one aligned (16, 256) window DMA
// per tile never clamps, and rolls the window into place in registers. None
// of that carries over: here a gather is a load, so the clamp is per pixel and
// nothing is padded or staged.
//
// Bound on this card: bytes (each input float read once, each output float
// written once, no arithmetic). The image is HWC with channels contiguous, so
// one row of one tile is a run of 128 * C consecutive output floats whose
// sources are consecutive too (except where the column clamps). One thread
// block copies one such run, neighbouring threads on neighbouring floats, so
// loads and stores are both coalesced whatever C is. The grid is
// (tiles across, tiles down, 8 rows): at (540, 960, 20) that is 4,320 blocks,
// enough to keep every SM's memory pipeline full.
//
// Pure data movement: the result equals the plain gather bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;        // tile rows
constexpr int TW = 128;      // tile columns
constexpr int MAX_DY = 16;   // |dy| clip
constexpr int MAX_DX = 64;   // |dx| clip
constexpr int THREADS = 256;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void tile_shift_kernel(const float* __restrict__ img, int h, int w,
                                  int c, const int* __restrict__ dy,
                                  const int* __restrict__ dx,
                                  float* __restrict__ out) {
  const int y = blockIdx.y * TH + blockIdx.z;
  if (y >= h) return;                       // ragged last tile row
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  const int oy = clampi(dy[t], -MAX_DY, MAX_DY);
  const int ox = clampi(dx[t], -MAX_DX, MAX_DX);
  const int x0 = blockIdx.x * TW;
  const int cols = min(TW, w - x0);         // ragged last tile column
  const int n = cols * c;
  const int sy = clampi(y + oy, 0, h - 1);
  const float* __restrict__ srow = img + (int64_t)sy * w * c;
  float* __restrict__ orow = out + ((int64_t)y * w + x0) * c;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int px = i / c;
    const int ch = i - px * c;
    const int sx = clampi(x0 + px + ox, 0, w - 1);
    orow[i] = srow[(int64_t)sx * c + ch];
  }
}

}  // namespace

extern "C" int kt_tile_shift(const float* img, int h, int w, int c,
                             const int* dy, const int* dx, int nty, int ntx,
                             float* out, void* stream) {
  const dim3 grid((unsigned)ntx, (unsigned)nty, TH);
  tile_shift_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      img, h, w, c, dy, dx, out);
  return (int)cudaGetLastError();
}
