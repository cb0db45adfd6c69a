// Woop ray/triangle intersectors for Hopper (sm_90a): kernels B and C.
//
// B  woop_brute_kernel   replaces kajiya_tpu/ops/woop_pallas.py:31 `_kernel`
//    (via intersect_brute_pallas): every ray against the whole resident
//    coefficient table. One thread per ray; the table is staged through
//    shared memory a tile of TILE triangles at a time and read as broadcasts.
//    Bound on this card: fp32 operations, ~30 per ray x triangle visit
//    (21 products/sums for q and r, one division, the barycentric tests).
//    The design does nothing clever about it yet: one ray per thread keeps
//    the running best in registers and the table reads are broadcasts.
//
// C  woop_culled_kernel  replaces kajiya_tpu/ops/woop_pallas.py:243
//    `_kernel_culled` (via intersect_culled_pallas): each ray chunk walks its
//    own front-to-back list of active 128-triangle blocks. One thread block
//    per chunk, one thread per ray; each visited block's 21 x 128
//    coefficients are loaded into shared memory once and shared by the
//    chunk's rays. Bound: fp32 operations, ~30 per visited ray x triangle.
//    Every exit (front-to-back early stop, any-hit park) is a block-wide
//    decision taken before a block is loaded, so nothing is left in flight.
//
// Arithmetic: products and sums use the _rn intrinsics in the order of the
// Pallas kernel, so nvcc contracts nothing into FMAs and the kernels agree
// bit for bit with their plain PyTorch versions (ops/woop_cuda.py).
// Triangle ids are int32 throughout (the Pallas kernels carried them as f32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;
constexpr int kCoef = 21;        // 12 a_o + 9 a_d coefficients per triangle
constexpr int kCullTB = 128;     // triangles per culled block
constexpr int kBruteTile = 256;  // triangles per shared-memory tile (B)

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmax;
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }

// Woop test of one ray against one triangle whose 21 coefficients lie at
// c[0], c[s], ..., c[20 s] in the order
// [a_o u(4), a_o v(4), a_o w(4), a_d u(3), a_d v(3), a_d w(3)].
__device__ __forceinline__ bool woop_hit(const float* c, int s, const Ray& r,
                                         float t_min, float t_best,
                                         float& t, float& u, float& v) {
  float qu = fadd(fadd(fadd(fmul(c[0 * s], r.ox), fmul(c[1 * s], r.oy)),
                       fmul(c[2 * s], r.oz)), c[3 * s]);
  float qv = fadd(fadd(fadd(fmul(c[4 * s], r.ox), fmul(c[5 * s], r.oy)),
                       fmul(c[6 * s], r.oz)), c[7 * s]);
  float qw = fadd(fadd(fadd(fmul(c[8 * s], r.ox), fmul(c[9 * s], r.oy)),
                       fmul(c[10 * s], r.oz)), c[11 * s]);
  float ru = fadd(fadd(fmul(c[12 * s], r.dx), fmul(c[13 * s], r.dy)),
                  fmul(c[14 * s], r.dz));
  float rv = fadd(fadd(fmul(c[15 * s], r.dx), fmul(c[16 * s], r.dy)),
                  fmul(c[17 * s], r.dz));
  float rw = fadd(fadd(fmul(c[18 * s], r.dx), fmul(c[19 * s], r.dy)),
                  fmul(c[20 * s], r.dz));
  bool rw_ok = fabsf(rw) >= 1e-12f;
  float rw_safe = rw_ok ? rw : 1e-12f;
  t = __fdiv_rn(-qw, rw_safe);
  u = fadd(qu, fmul(t, ru));
  v = fadd(qv, fmul(t, rv));
  return rw_ok && u >= -1e-5f && v >= -1e-5f && fadd(u, v) <= 1.00001f &&
         t > t_min && t < t_best && t < r.tmax;
}

__device__ __forceinline__ Ray load_ray(const float* org, const float* dir,
                                        const float* tmax, int64_t i) {
  Ray r;
  r.ox = org[3 * i]; r.oy = org[3 * i + 1]; r.oz = org[3 * i + 2];
  r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
  r.tmax = tmax[i];
  return r;
}

// coef: (T, 21) row-major. Closest hit with the lowest index winning ties;
// any-hit stops a thread at its first hit (only tri >= 0 is the contract).
__global__ void woop_brute_kernel(const float* __restrict__ org,
                                  const float* __restrict__ dir,
                                  const float* __restrict__ tmax,
                                  const float* __restrict__ coef,
                                  int n_rays, int n_tris, float t_min,
                                  int any_hit, float* __restrict__ t_out,
                                  int* __restrict__ tri_out,
                                  float* __restrict__ u_out,
                                  float* __restrict__ v_out) {
  __shared__ float tile[kBruteTile * kCoef];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  Ray r = {0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f};
  if (live) r = load_ray(org, dir, tmax, i);
  float t_best = kInf, u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  bool done = !live || !(r.tmax > t_min);
  for (int base = 0; base < n_tris; base += kBruteTile) {
    if (any_hit && !__syncthreads_or(!done)) break;
    const int n = min(kBruteTile, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n * kCoef; k += blockDim.x)
      tile[k] = coef[(int64_t)base * kCoef + k];
    __syncthreads();
    if (done && any_hit) continue;
    for (int j = 0; j < n; ++j) {
      float t, u, v;
      if (woop_hit(&tile[j * kCoef], 1, r, t_min, t_best, t, u, v)) {
        t_best = t; u_best = u; v_best = v; tri_best = base + j;
        if (any_hit) { done = true; break; }
      }
    }
  }
  if (live) {
    t_out[i] = t_best; tri_out[i] = tri_best;
    u_out[i] = u_best; v_out[i] = v_best;
  }
}

// Block-wide max; every thread gets the result. blockDim.x % 32 == 0.
__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = red[0];
  const int nw = blockDim.x >> 5;
  for (int k = 1; k < nw; ++k) m = fmaxf(m, red[k]);
  return m;
}

// One block per ray chunk of blockDim.x rays. blist/bdist: (n_chunks, nt)
// front-to-back block ids and their t lower bounds; count: (n_chunks,).
// coef: (n_blocks, 21, 128).
__global__ void woop_culled_kernel(const float* __restrict__ org,
                                   const float* __restrict__ dir,
                                   const float* __restrict__ tmax,
                                   const int* __restrict__ blist,
                                   const float* __restrict__ bdist,
                                   const int* __restrict__ count, int nt,
                                   const float* __restrict__ coef,
                                   float t_min, int any_hit, int early_stop,
                                   float* __restrict__ t_out,
                                   int* __restrict__ tri_out,
                                   float* __restrict__ u_out,
                                   float* __restrict__ v_out) {
  __shared__ float cblk[kCoef * kCullTB];
  __shared__ float red[32];
  const int64_t chunk = blockIdx.x;
  const int64_t i = chunk * blockDim.x + threadIdx.x;
  const Ray r = load_ray(org, dir, tmax, i);
  const int cnt = count[chunk];
  const int* bl = blist + chunk * nt;
  const float* bd = bdist + chunk * nt;
  float t_best = kInf, u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  for (int k = 0; k < cnt; ++k) {
    if (any_hit) {
      if (!__syncthreads_or(tri_best < 0 && r.tmax > t_min)) break;
    } else if (early_stop) {
      // blocks arrive sorted by their conservative t lower bound: once every
      // ray's best hit is closer than the next block's bound, stop
      const float worst = block_max(fminf(t_best, r.tmax), red);
      if (!(bd[k] <= worst)) break;
    }
    const int64_t blk = bl[k];
    __syncthreads();
    for (int q = threadIdx.x; q < kCoef * kCullTB; q += blockDim.x)
      cblk[q] = coef[blk * (kCoef * kCullTB) + q];
    __syncthreads();
    for (int j = 0; j < kCullTB; ++j) {
      float t, u, v;
      if (woop_hit(&cblk[j], kCullTB, r, t_min, t_best, t, u, v)) {
        t_best = t; u_best = u; v_best = v;
        tri_best = (int)(blk * kCullTB) + j;
      }
    }
  }
  t_out[i] = t_best; tri_out[i] = tri_best;
  u_out[i] = u_best; v_out[i] = v_best;
}

}  // namespace

extern "C" {

int kt_woop_brute(const float* org, const float* dir, const float* tmax,
                  const float* coef, int n_rays, int n_tris, float t_min,
                  int any_hit, float* t_out, int* tri_out, float* u_out,
                  float* v_out, void* stream) {
  const int threads = 256;
  const int blocks = (n_rays + threads - 1) / threads;
  woop_brute_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      org, dir, tmax, coef, n_rays, n_tris, t_min, any_hit, t_out, tri_out,
      u_out, v_out);
  return (int)cudaGetLastError();
}

int kt_woop_culled(const float* org, const float* dir, const float* tmax,
                   const int* blist, const float* bdist, const int* count,
                   int n_chunks, int rb, int nt, const float* coef,
                   float t_min, int any_hit, int early_stop, float* t_out,
                   int* tri_out, float* u_out, float* v_out, void* stream) {
  woop_culled_kernel<<<n_chunks, rb, 0, (cudaStream_t)stream>>>(
      org, dir, tmax, blist, bdist, count, nt, coef, t_min, any_hit,
      early_stop, t_out, tri_out, u_out, v_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
