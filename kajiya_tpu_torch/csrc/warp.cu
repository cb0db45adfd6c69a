// Image warp for Hopper (sm_90a): kernel W.
//
// Replaces kajiya_tpu/ops/warp_pallas.py:57 `_kernel` (via warp2d_pallas):
// samples an (H, W, C) float32 image at a per-pixel uv, bilinear or nearest,
// with clamp-to-edge addressing per tap. The TPU kernel's window clamp and
// two-hot matmul formulation were TPU workarounds for slow gathers; here a
// gather is a plain load, so the kernel is one thread per output pixel that
// loops over the channels and is held to core/img.py's sample_bilinear /
// sample_nearest.
//
// Bound on this card: bytes. Each pixel reads its uv (8 B) and up to four
// taps (4 C x 4 B, mostly L2 hits for a local warp) and writes C x 4 B.
//
// Arithmetic uses the _rn intrinsics in the order of sample_bilinear, so no
// FMA contraction separates it from the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void warp_kernel(const float* __restrict__ img, int h, int w,
                            int c, const float* __restrict__ uv, int64_t n,
                            int bilinear, float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float u = uv[2 * p], v = uv[2 * p + 1];
  float* o = out + p * c;
  if (bilinear) {
    const float x = __fsub_rn(__fmul_rn(u, (float)w), 0.5f);
    const float y = __fsub_rn(__fmul_rn(v, (float)h), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    const int xi = (int)x0, yi = (int)y0;
    const int ix0 = clampi(xi, 0, w - 1), ix1 = clampi(xi + 1, 0, w - 1);
    const int iy0 = clampi(yi, 0, h - 1), iy1 = clampi(yi + 1, 0, h - 1);
    const float* r0 = img + (int64_t)iy0 * w * c;
    const float* r1 = img + (int64_t)iy1 * w * c;
    for (int k = 0; k < c; ++k) {
      const float c00 = r0[(int64_t)ix0 * c + k], c10 = r0[(int64_t)ix1 * c + k];
      const float c01 = r1[(int64_t)ix0 * c + k], c11 = r1[(int64_t)ix1 * c + k];
      const float top = __fadd_rn(__fmul_rn(c00, gx), __fmul_rn(c10, fx));
      const float bot = __fadd_rn(__fmul_rn(c01, gx), __fmul_rn(c11, fx));
      o[k] = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
    }
  } else {
    const int ix = clampi((int)floorf(__fmul_rn(u, (float)w)), 0, w - 1);
    const int iy = clampi((int)floorf(__fmul_rn(v, (float)h)), 0, h - 1);
    const float* src = img + ((int64_t)iy * w + ix) * c;
    for (int k = 0; k < c; ++k) o[k] = src[k];
  }
}

}  // namespace

extern "C" int kt_warp(const float* img, int h, int w, int c, const float* uv,
                       long long n, int bilinear, float* out, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  warp_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      img, h, w, c, uv, (int64_t)n, bilinear, out);
  return (int)cudaGetLastError();
}
