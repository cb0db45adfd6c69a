// Image warp for Hopper (sm_90a): kernel W.
//
// Replaces kajiya_tpu/ops/warp_pallas.py:57 `_kernel` (via warp2d_pallas):
// samples an (H, W, C) float32 image at a per-pixel uv, bilinear or nearest,
// with clamp-to-edge addressing per tap. The TPU kernel's window clamp and
// two-hot matmul formulation were TPU workarounds for slow gathers; here a
// gather is a plain load, and the kernel is held to core/img.py's
// sample_bilinear / sample_nearest.
//
// Bound on this card: bytes. Each pixel reads its uv (8 B) and up to four
// taps (4 C x 4 B, mostly L2 hits for a local warp) and writes C x 4 B.
// What decides the time is how many 32-byte sectors a warp's loads and stores
// touch. The image is channel-last, so one thread per pixel that loops over
// C channels strides its warp's accesses by 4 C bytes (52 B at 13 channels:
// every load and every store touches ~13 sectors for 128 useful bytes).
// The design spreads the channels over the threads instead: the output is a
// flat run of n x C elements, thread q takes pixel q / C and channel q % C,
// so the stores of a warp are one contiguous run, and so are the loads where
// neighbouring outputs sample neighbouring sources (a local warp). The C
// threads of a pixel read the same uv (one broadcast 8-byte load). The
// element is the widest vector that divides C (float4 for C = 4, 16;
// float2 for C = 2), so a 4-channel pixel is one thread with 16-byte taps,
// and C / width is a template constant for the widths a frame uses, which
// makes the division a multiply. What is left after that is latency: an
// element is a chain of two dependent loads (uv, then the taps) for 4 to 16
// bytes, so each thread takes several elements and issues their loads
// together.
//
// Arithmetic uses the _rn intrinsics in the order of sample_bilinear, so no
// FMA contraction separates it from the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// (a gx + b fx) gy + (c gx + d fx) fy, in sample_bilinear's order
__device__ __forceinline__ float lerp2(float c00, float c10, float c01,
                                       float c11, float gx, float fx,
                                       float gy, float fy) {
  const float top = __fadd_rn(__fmul_rn(c00, gx), __fmul_rn(c10, fx));
  const float bot = __fadd_rn(__fmul_rn(c01, gx), __fmul_rn(c11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

__device__ __forceinline__ float2 lerp2(float2 a, float2 b, float2 c, float2 d,
                                        float gx, float fx, float gy,
                                        float fy) {
  return make_float2(lerp2(a.x, b.x, c.x, d.x, gx, fx, gy, fy),
                     lerp2(a.y, b.y, c.y, d.y, gx, fx, gy, fy));
}

__device__ __forceinline__ float4 lerp2(float4 a, float4 b, float4 c, float4 d,
                                        float gx, float fx, float gy,
                                        float fy) {
  return make_float4(lerp2(a.x, b.x, c.x, d.x, gx, fx, gy, fy),
                     lerp2(a.y, b.y, c.y, d.y, gx, fx, gy, fy),
                     lerp2(a.z, b.z, c.z, d.z, gx, fx, gy, fy),
                     lerp2(a.w, b.w, c.w, d.w, gx, fx, gy, fy));
}

// T: the element (float, float2 or float4). CV: elements per pixel where it
// is a compile-time constant, 0 where it is `cv_rt`. total = pixels x
// elements per pixel. A thread takes U elements, blockDim.x apart: all their
// uv loads are issued first, then all their taps, then the stores, so that
// U independent chains of dependent loads are in flight per thread.
template <typename T, int CV, bool BILINEAR, int U>
__global__ void warp_kernel(const T* __restrict__ img, int h, int w,
                            int cv_rt, const float2* __restrict__ uv,
                            unsigned total, T* __restrict__ out) {
  const unsigned cv = CV > 0 ? (unsigned)CV : (unsigned)cv_rt;
  const unsigned q0 = blockIdx.x * (blockDim.x * U) + threadIdx.x;
  unsigned k[U];
  float2 t[U];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const unsigned q = min(q0 + i * blockDim.x, total - 1);
    const unsigned p = q / cv;
    k[i] = q - p * cv;
    t[i] = uv[p];
  }
  if (BILINEAR) {
    T c00[U], c10[U], c01[U], c11[U];
    float fx[U], fy[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const float x = __fsub_rn(__fmul_rn(t[i].x, (float)w), 0.5f);
      const float y = __fsub_rn(__fmul_rn(t[i].y, (float)h), 0.5f);
      const float x0 = floorf(x), y0 = floorf(y);
      fx[i] = __fsub_rn(x, x0);
      fy[i] = __fsub_rn(y, y0);
      const int xi = (int)x0, yi = (int)y0;
      const unsigned ix0 = clampi(xi, 0, w - 1), ix1 = clampi(xi + 1, 0, w - 1);
      const unsigned iy0 = clampi(yi, 0, h - 1), iy1 = clampi(yi + 1, 0, h - 1);
      const T* r0 = img + (size_t)iy0 * w * cv + k[i];
      const T* r1 = img + (size_t)iy1 * w * cv + k[i];
      c00[i] = r0[ix0 * cv]; c10[i] = r0[ix1 * cv];
      c01[i] = r1[ix0 * cv]; c11[i] = r1[ix1 * cv];
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const unsigned q = q0 + i * blockDim.x;
      if (q < total)
        out[q] = lerp2(c00[i], c10[i], c01[i], c11[i], __fsub_rn(1.0f, fx[i]),
                       fx[i], __fsub_rn(1.0f, fy[i]), fy[i]);
    }
  } else {
    T v[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const unsigned ix =
          clampi((int)floorf(__fmul_rn(t[i].x, (float)w)), 0, w - 1);
      const unsigned iy =
          clampi((int)floorf(__fmul_rn(t[i].y, (float)h)), 0, h - 1);
      v[i] = img[((size_t)iy * w + ix) * cv + k[i]];
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const unsigned q = q0 + i * blockDim.x;
      if (q < total) out[q] = v[i];
    }
  }
}

template <typename T, int CV, bool BILINEAR, int U>
cudaError_t launch_u(const void* img, int h, int w, int cv, const float* uv,
                     unsigned total, void* out, cudaStream_t stream) {
  const unsigned threads = 256;
  const unsigned blocks = (total + threads * U - 1) / (threads * U);
  warp_kernel<T, CV, BILINEAR, U><<<blocks, threads, 0, stream>>>(
      (const T*)img, h, w, cv, (const float2*)uv, total, (T*)out);
  return cudaGetLastError();
}

// Elements per thread, measured on an H100 at the frame's shapes: four for
// nearest; for bilinear (four taps an element) as many as keep 16 floats of
// taps in flight: 4 for float, 2 for float2, 1 for float4.
template <typename T, int CV>
cudaError_t launch(const void* img, int h, int w, int cv, const float* uv,
                   unsigned total, int bilinear, void* out,
                   cudaStream_t stream) {
  constexpr int UB = 16 / sizeof(T);
  return bilinear
             ? launch_u<T, CV, true, UB>(img, h, w, cv, uv, total, out, stream)
             : launch_u<T, CV, false, 4>(img, h, w, cv, uv, total, out, stream);
}

// The element counts per pixel that get their own instance: 1 (C = 1, 2, 4),
// 3, 4 (C = 16) and 13; anything else divides at run time.
template <typename T>
cudaError_t dispatch(const void* img, int h, int w, int cv, const float* uv,
                     unsigned total, int bilinear, void* out,
                     cudaStream_t stream) {
  switch (cv) {
    case 1: return launch<T, 1>(img, h, w, cv, uv, total, bilinear, out, stream);
    case 3: return launch<T, 3>(img, h, w, cv, uv, total, bilinear, out, stream);
    case 4: return launch<T, 4>(img, h, w, cv, uv, total, bilinear, out, stream);
    case 13: return launch<T, 13>(img, h, w, cv, uv, total, bilinear, out, stream);
    default: return launch<T, 0>(img, h, w, cv, uv, total, bilinear, out, stream);
  }
}

}  // namespace

// img: (h, w, c) float32, uv: (n, 2), out: (n, c). img and out must be
// aligned to the element the kernel picks (16 B where c % 4 == 0, 8 B where
// c % 2 == 0), uv to 8 B; n x c must stay below 2^31.
extern "C" int kt_warp(const float* img, int h, int w, int c, const float* uv,
                       long long n, int bilinear, float* out, void* stream) {
  const int width = c % 4 == 0 ? 4 : (c % 2 == 0 ? 2 : 1);
  const uintptr_t align = (uintptr_t)img | (uintptr_t)out;
  if (c <= 0 || n <= 0 || n * c >= (1ll << 31) || align % (4 * width) != 0 ||
      (uintptr_t)uv % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int cv = c / width;
  const unsigned total = (unsigned)(n * cv);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (width == 4)
    err = dispatch<float4>(img, h, w, cv, uv, total, bilinear, out, s);
  else if (width == 2)
    err = dispatch<float2>(img, h, w, cv, uv, total, bilinear, out, s);
  else
    err = dispatch<float>(img, h, w, cv, uv, total, bilinear, out, s);
  return (int)err;
}
