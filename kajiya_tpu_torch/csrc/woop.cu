// Woop ray/triangle intersectors for Hopper (sm_90a): kernels B and C.
//
// B  woop_brute_kernel   replaces kajiya_tpu/ops/woop_pallas.py:31 `_kernel`
//    (via intersect_brute_pallas): every ray against the whole resident
//    coefficient table. One thread per ray; the table is staged through
//    shared memory a tile of TILE triangles at a time and read as broadcasts.
//    Bound on this card: fp32 operations, ~30 per ray x triangle visit
//    (21 products/sums for q and r, one division, the barycentric tests).
//    The design does nothing clever about it: one ray per thread keeps the
//    running best in registers and the table reads are broadcasts. It costs
//    the frame well under a millisecond on the scenes that take it.
//
// C  woop_culled_kernel  replaces kajiya_tpu/ops/woop_pallas.py:243
//    `_kernel_culled` (via intersect_culled_pallas): each ray chunk walks its
//    own front-to-back list of active 128-triangle blocks.
//    Bound: fp32 operations, ~30 per tested ray x triangle. That bound
//    counts the tests of the ray x block pairs the per-ray walk below keeps
//    (`culled_plain(ray_skip=True)` counts them; the chunk-level walk's
//    pairs are several times more and are no bound, since this kernel skips
//    most of them) over the card's fp32 peak, which counts a fused
//    multiply-add as two operations; this kernel may fuse nothing and
//    divides exactly, so half of that rate is the ceiling of its arithmetic.
//    What held the first version back was not fp32 but shared memory: one
//    thread per ray read 21 broadcast words per test, one load per 1.5
//    multiplies and adds, behind four block-wide barriers per visited block,
//    and a chunk walked on for its worst ray.
//    The design turns the loop inside out. A warp owns 32 consecutive rays
//    of a chunk and walks the chunk's list on its own. For a visited block
//    every lane loads the coefficients of four consecutive triangles into
//    registers (21 coalesced 16-byte loads from the (21, 128) slab; one warp
//    holds the whole block), and the warp then loops over its rays that are
//    still live, one ray at a time, broadcast from shared memory (two
//    16-byte loads per four tests). A hit is rare, so it is found by a vote
//    and reduced over the lanes by (t, triangle id), which reproduces the
//    sequential scan's tie rule; lane j keeps ray j's running best.
//    Because the ray is the loop variable, every exit is per ray. A ray
//    whose min(t_best, tmax) lies below the block's lower bound (closest
//    hit) or that already has a hit (any-hit) is left out of the block, and
//    a warp stops at the first block that none of its rays needs (the list
//    is sorted, the bounds only grow). Of the rays that are left, lane j
//    tests ray j against the block's padded bounding box (a slab test, ~30
//    operations for 32 rays) and only rays that cross the box within
//    (t_min, min(t_best, tmax)) are looped over; a block no ray crosses is
//    not even loaded. A skipped triangle cannot be hit (the box holds its
//    block with a margin far above the rounding of the slab test) or has
//    t >= bound > t_best, so no result changes: this is lazy evaluation of
//    the chunk-level walk, and `early_stop = 0` switches both off for an
//    exhaustive walk to check that against. The next block's id, bound and
//    box are fetched one block ahead; no thread block-wide barrier is left,
//    and coefficient loads of different warps overlap through occupancy.
//    What bounds a test now is the rate at which an SM issues its ~70
//    operations (exact _rn arithmetic fuses nothing; more warps per SM
//    change nothing), so the time follows the number of tests made.
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
  // every term is one compare: evaluate them all rather than branch
  return rw_ok & (u >= -1e-5f) & (v >= -1e-5f) & (fadd(u, v) <= 1.00001f) &
         (t > t_min) & (t < t_best) & (t < r.tmax);
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

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTriPerLane = kCullTB / 32;  // 4: one warp holds a whole block
constexpr int kCullWarps = 4;              // ray groups per thread block

// The reciprocal the slab test multiplies by: near-zero components become
// +-1e-12, as in the scene-box clamp of the wrapper.
__device__ __forceinline__ float slab_inv(float d) {
  const float tiny = 1e-12f;
  return __fdiv_rn(1.0f, fabsf(d) < tiny ? (d < 0.f ? -tiny : tiny) : d);
}

// One warp per group of 32 consecutive rays; a chunk is `groups_per_chunk`
// consecutive groups. blist/bdist: (n_chunks, nt) front-to-back block ids and
// their t lower bounds; count: (n_chunks,). coef: (n_blocks, 21, 128).
// bounds: (n_blocks, 2) float4, each block's padded box [min | max].
// `tested`, where not null, receives the number of ray x block pairs tested.
__global__ void __launch_bounds__(kCullWarps * 32)
woop_culled_kernel(const float* __restrict__ org,
                   const float* __restrict__ dir,
                   const float* __restrict__ tmax,
                   const int* __restrict__ blist,
                   const float* __restrict__ bdist,
                   const int* __restrict__ count, int nt,
                   const float* __restrict__ coef,
                   const float4* __restrict__ bounds, int64_t n_groups,
                   int groups_per_chunk, float t_min, int any_hit,
                   int early_stop, float* __restrict__ t_out,
                   int* __restrict__ tri_out, float* __restrict__ u_out,
                   float* __restrict__ v_out,
                   unsigned long long* __restrict__ tested) {
  __shared__ float4 s_org[kCullWarps][32];  // ox, oy, oz, tmax
  __shared__ float4 s_dir[kCullWarps][32];  // dx, dy, dz, -
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t group = (int64_t)blockIdx.x * kCullWarps + warp;
  if (group >= n_groups) return;  // warps never meet at a barrier
  const int64_t chunk = group / groups_per_chunk;
  const int64_t i = group * 32 + lane;
  const Ray r = load_ray(org, dir, tmax, i);
  float4* my_org = s_org[warp];
  float4* my_dir = s_dir[warp];
  my_org[lane] = make_float4(r.ox, r.oy, r.oz, r.tmax);
  my_dir[lane] = make_float4(r.dx, r.dy, r.dz, 0.f);
  __syncwarp();
  const bool alive = r.tmax > t_min;  // a dead lane can pass no test
  const int cnt = count[chunk];
  const int* bl = blist + chunk * nt;
  const float* bd = bdist + chunk * nt;
  // slab test of this lane's ray: reciprocal direction, and a pad on the
  // box that grows with the magnitudes the test rounds
  const float ix = slab_inv(r.dx), iy = slab_inv(r.dy), iz = slab_inv(r.dz);
  const float pad = __fmul_rn(
      1e-5f, __fadd_rn(__fadd_rn(__fadd_rn(fabsf(r.ox), fabsf(r.oy)),
                                 fabsf(r.oz)), r.tmax));
  // lane j holds the running best of ray j
  float t_best = kInf, u_best = 0.f, v_best = 0.f;
  int tri_best = -1;
  unsigned long long n_tested = 0;
  // block k's id, bound and box, fetched while block k - 1 is tested
  int blk_next = 0;
  float bd_next = 0.f;
  float4 lo_next = make_float4(0.f, 0.f, 0.f, 0.f), hi_next = lo_next;
  if (cnt > 0) {
    blk_next = bl[0];
    bd_next = bd[0];
    lo_next = __ldg(bounds + 2 * blk_next);
    hi_next = __ldg(bounds + 2 * blk_next + 1);
  }
  for (int k = 0; k < cnt; ++k) {
    const int blk = blk_next;
    const float bound = bd_next;
    const float4 lo = lo_next, hi = hi_next;
    if (k + 1 < cnt) {
      blk_next = bl[k + 1];
      bd_next = bd[k + 1];
      lo_next = __ldg(bounds + 2 * blk_next);
      hi_next = __ldg(bounds + 2 * blk_next + 1);
    }
    const float limit = fminf(t_best, r.tmax);
    bool live = alive;
    if (any_hit) live = live && tri_best < 0;
    else if (early_stop) live = live && bound <= limit;
    // blocks arrive sorted by their bound and a ray's limit only falls: a
    // block no ray needs ends the walk
    if (!__any_sync(kFullMask, live)) break;
    if (early_stop) {
      const float ax = __fmul_rn(__fsub_rn(__fsub_rn(lo.x, pad), r.ox), ix);
      const float bx = __fmul_rn(__fsub_rn(__fadd_rn(hi.x, pad), r.ox), ix);
      const float ay = __fmul_rn(__fsub_rn(__fsub_rn(lo.y, pad), r.oy), iy);
      const float by = __fmul_rn(__fsub_rn(__fadd_rn(hi.y, pad), r.oy), iy);
      const float az = __fmul_rn(__fsub_rn(__fsub_rn(lo.z, pad), r.oz), iz);
      const float bz = __fmul_rn(__fsub_rn(__fadd_rn(hi.z, pad), r.oz), iz);
      const float t_in = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                               fminf(az, bz));
      const float t_out_ = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                                 fmaxf(az, bz));
      // written as a rejection, so that a NaN keeps the ray in
      if (t_in > t_out_ || t_out_ < t_min || t_in > limit) live = false;
    }
    unsigned mask = __ballot_sync(kFullMask, live);
    if (!mask) continue;  // no ray crosses the box: the block is not loaded
    n_tested += __popc(mask);
    const float4* slab = reinterpret_cast<const float4*>(
        coef + (int64_t)blk * (kCoef * kCullTB)) + lane;
    float c[kCoef * kTriPerLane];  // c[4 q + m]: coefficient q, triangle m
#pragma unroll
    for (int q = 0; q < kCoef; ++q) {
      const float4 x = __ldg(slab + q * (kCullTB / 4));
      c[4 * q] = x.x; c[4 * q + 1] = x.y; c[4 * q + 2] = x.z; c[4 * q + 3] = x.w;
    }
    const int tri0 = blk * kCullTB + kTriPerLane * lane;
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      const float4 o = my_org[j], d = my_dir[j];
      const float lim = __shfl_sync(kFullMask, limit, j);
      // t < t_best && t < tmax is t < min(t_best, tmax)
      const Ray rj = {o.x, o.y, o.z, d.x, d.y, d.z, lim};
      float t[kTriPerLane], u[kTriPerLane], v[kTriPerLane];
      bool ok[kTriPerLane];
      bool any = false;
#pragma unroll
      for (int m = 0; m < kTriPerLane; ++m) {
        ok[m] = woop_hit(&c[m], kTriPerLane, rj, t_min, lim, t[m], u[m], v[m]);
        any = any || ok[m];
      }
      if (!__any_sync(kFullMask, any)) continue;
      // the lane's closest hit, lowest index on equal t ...
      float bt = kInf, bu = 0.f, bv = 0.f;
      int bi = 0x7fffffff;
#pragma unroll
      for (int m = 0; m < kTriPerLane; ++m)
        if (ok[m] && t[m] < bt) { bt = t[m]; bu = u[m]; bv = v[m]; bi = tri0 + m; }
      // ... then the warp's, by (t, triangle id)
      float wt = bt;
      int wi = bi;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float t2 = __shfl_xor_sync(kFullMask, wt, off);
        const int i2 = __shfl_xor_sync(kFullMask, wi, off);
        if (t2 < wt || (t2 == wt && i2 < wi)) { wt = t2; wi = i2; }
      }
      const int src = (wi - blk * kCullTB) / kTriPerLane;  // the winner's lane
      bu = __shfl_sync(kFullMask, bu, src);
      bv = __shfl_sync(kFullMask, bv, src);
      if (lane == j) { t_best = wt; tri_best = wi; u_best = bu; v_best = bv; }
    }
  }
  t_out[i] = t_best; tri_out[i] = tri_best;
  u_out[i] = u_best; v_out[i] = v_best;
  if (tested != nullptr && lane == 0) atomicAdd(tested, n_tested);
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

// rb: rays per chunk, a multiple of 32. bounds: (n_blocks, 8) floats,
// 16-byte aligned. `tested` may be null.
int kt_woop_culled(const float* org, const float* dir, const float* tmax,
                   const int* blist, const float* bdist, const int* count,
                   int n_chunks, int rb, int nt, const float* coef,
                   const float* bounds, float t_min, int any_hit,
                   int early_stop, float* t_out,
                   int* tri_out, float* u_out, float* v_out,
                   unsigned long long* tested, void* stream) {
  if (rb <= 0 || rb % 32 != 0 || (uintptr_t)bounds % 16 != 0 ||
      (uintptr_t)coef % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int groups_per_chunk = rb / 32;
  const int64_t n_groups = (int64_t)n_chunks * groups_per_chunk;
  const int64_t blocks = (n_groups + kCullWarps - 1) / kCullWarps;
  woop_culled_kernel<<<(unsigned int)blocks, kCullWarps * 32, 0,
                       (cudaStream_t)stream>>>(
      org, dir, tmax, blist, bdist, count, nt, coef,
      reinterpret_cast<const float4*>(bounds), n_groups, groups_per_chunk, t_min, any_hit, early_stop, t_out, tri_out, u_out,
      v_out, tested);
  return (int)cudaGetLastError();
}

}  // extern "C"
