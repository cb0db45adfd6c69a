// Woop ray/triangle intersectors for Hopper (sm_90a): kernels B and C.
//
// B  woop_brute_kernel   replaces kajiya_tpu/ops/woop_pallas.py:31 `_kernel`
//    (via intersect_brute_pallas): every live ray against the whole
//    resident coefficient table, for scenes without cluster tables (up to
//    BRUTE_FORCE_MAX_TRIS = 8,192 triangles).
//    Bound: fp32 operations, ~30 per ray x triangle test (21 products/sums
//    for q and r, one division, the barycentric tests), over the card's fp32
//    peak. Exact _rn arithmetic fuses nothing, so half of that rate is the
//    ceiling of the arithmetic. The first version (one ray a thread, 21
//    scalar shared loads and an IEEE division for every pair, every lane of
//    a warp walking the table for its one live ray) issued ~90 instructions
//    a test. The design:
//    (a) the table is read as (T, 24) rows, 6 float4 (coef_rows24), staged
//        through shared memory 256 triangles at a time (a one-tile table
//        once a block) and read as 16-byte broadcasts;
//    (b) a thread holds R = 2 rays (1 when the rays would not give every
//        block a full round), so each triangle's 6 loads serve 2 tests;
//        R = 4 measured slower (its registers halve the resident warps;
//        PERF.md section 6);
//    (c) live rays are compacted inside the thread block: block b takes the
//        128-ray spans b, b + G, b + 2G, ... (G: one wave of resident blocks
//        for a table of several tiles, so that every round is full whatever
//        the share of live rays; a block for each R spans for a one-tile
//        table, whose short rounds cannot hide the loads), writes its dead
//        rays (tmax <= t_min) as misses and appends the indices of its live
//        ones to a list in shared memory (ballots and a prefix over the
//        warps; no host read, no extra launch); a round takes 128 R rays of
//        the list. An any-hit ray leaves at its first hit: its slot stays
//        empty, a warp whose rays all have a hit leaves the tile, and the
//        round ends at the first tile no ray of the block needs;
//    (d) exact rejects before the division: only a pair whose t can be
//        positive and below the ray's limit computes the division and u,
//        and only a pair whose u passed computes v and the other tests, in
//        the exact test's order (the rejects' proof is above the kernel).
//        The rejects act per lane and a branch costs its warp where one
//        lane takes it; a branch per ray slot still measured faster than
//        running every slot's whole test without one (PERF.md section 6).
//    Rays visit the triangles in index order, so the closest hit keeps the
//    lowest index on equal t, and each result is written at its ray's index.
//    What bounds it now: ~24 instructions on every pair, ~27 more where a
//    warp runs the test up to u, ~21 more where u passes; a warp of
//    coherent camera rays runs it for half the pairs, a warp of scattered
//    secondary rays for nearly all (PERF.md section 6).
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

#include <algorithm>

namespace {

constexpr float kInf = 1e30f;
constexpr int kCoef = 21;        // 12 a_o + 9 a_d coefficients per triangle
constexpr int kCullTB = 128;     // triangles per culled block
constexpr int kBruteTile = 256;  // triangles per shared-memory tile (B)
constexpr int kBruteThreads = 128;
constexpr int kRow4 = 6;         // float4 per (T, 24) row: 21 coefficients + 3 zeros

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

constexpr unsigned kFullMask = 0xffffffffu;

// The exact rejects of kernel B (plain model: ops/woop_cuda.py
// `brute_reject_plain`). A pair is kept only if
//   rw_ok:  |rw| >= 1e-12 (the exact test requires it), and
//   sign:   y = qw * sign(rw) < 0, i.e. qw != 0 and of the opposite sign to
//           rw, so that t = fl(-qw / rw) can be > 0; otherwise t <= 0 <= t_min
//           (t_min >= 0 is checked by the wrapper), and
//   limit:  |qw| < p = fl(limg * |rw|), limg = fl(lim * (1 + 2^-20)),
//           lim = min(t_best, tmax).
// Why the limit reject is exact: for lim >= 1e-25 and |rw| >= 1e-12 both
// products are normal floats (>= 1e-37), so each rounding loses at most a
// factor (1 - 2^-24): p >= lim |rw| (1 + 2^-20)(1 - 2^-24)^2 > lim |rw| in
// real numbers (an overflow gives p = inf, which rejects only |qw| = inf,
// whose t is +-inf or NaN). So |qw| >= p implies |qw| / |rw| >= lim, and
// since round-to-nearest is monotone and lim is a float, the correctly
// rounded t = fl(|qw| / |rw|) >= lim: the exact test's t < t_best && t < tmax
// fails. For lim < 1e-25 (only possible with t_min = 0) limg is +inf and the
// limit reject is off. limg = 0 marks a slot with no ray or an any-hit ray
// that is done: nothing passes. NaN anywhere fails every compare (kept
// never), and the exact test rejects NaN too.
constexpr float kRejectGrow = 1.0f + 0x1p-20f;
constexpr float kLimFloor = 1e-25f;

__device__ __forceinline__ float scaled_limit(float lim) {
  return lim >= kLimFloor ? __fmul_rn(lim, kRejectGrow) : __int_as_float(0x7f800000);
}

struct BruteRay {
  float ox, oy, oz, dx, dy, dz, tmax;
  float limg;                 // scaled min(t_best, tmax); 0 = no ray / done
  float t_best, u_best, v_best;
  int tri_best;
};

// The exact test of a kept pair, in woop_hit's order and with its compares
// (the pair passed |rw| >= 1e-12, so rw_safe is rw). u and v in that order:
__device__ __forceinline__ float brute_u(const float4& c0, const float4& c3,
                                         float t, const BruteRay& r) {
  const float qu = fadd(fadd(fadd(fmul(c0.x, r.ox), fmul(c0.y, r.oy)),
                             fmul(c0.z, r.oz)), c0.w);
  const float ru = fadd(fadd(fmul(c3.x, r.dx), fmul(c3.y, r.dy)),
                        fmul(c3.z, r.dz));
  return fadd(qu, fmul(t, ru));
}

__device__ __forceinline__ float brute_v(const float4& c1, const float4& c3,
                                         const float4& c4, float t,
                                         const BruteRay& r) {
  const float qv = fadd(fadd(fadd(fmul(c1.x, r.ox), fmul(c1.y, r.oy)),
                             fmul(c1.z, r.oz)), c1.w);
  const float rv = fadd(fadd(fmul(c3.w, r.dx), fmul(c4.x, r.dy)),
                        fmul(c4.y, r.dz));
  return fadd(qv, fmul(t, rv));
}

// The rest of the test once u passed, and the update of the slot's best.
__device__ __forceinline__ void brute_accept(float t, float u, float v,
                                             float t_min, int tri,
                                             int any_hit, BruteRay& r) {
  if ((u >= -1e-5f) & (v >= -1e-5f) & (fadd(u, v) <= 1.00001f) &
      (t > t_min) & (t < r.t_best) & (t < r.tmax)) {
    r.t_best = t; r.u_best = u; r.v_best = v; r.tri_best = tri;
    r.limg = any_hit ? 0.f : scaled_limit(t);
  }
}

// R rays a thread, 128 threads a block; a round tests up to 128 R live rays
// of the block's list against every tile of the table. rows: (T, 6) float4.
// kCount: counts[0..2] += pairs of a live ray and a table row visited, pairs
// the rejects kept, and pairs whose exact test a warp executed.
// 8 resident blocks (64 registers); the counting builds get the registers
// to run without spills.
template <int R, bool kCount>
__global__ void __launch_bounds__(kBruteThreads, kCount ? 4 : 8)
woop_brute_kernel(const float* __restrict__ org, const float* __restrict__ dir,
                  const float* __restrict__ tmax,
                  const float4* __restrict__ rows, int n_rays, int n_tris,
                  float t_min, int any_hit, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out,
                  unsigned long long* __restrict__ counts) {
  constexpr int kSpan = kBruteThreads * R;     // rays a round
  constexpr int kWarps = kBruteThreads / 32;
  __shared__ float4 tile[kBruteTile * kRow4];
  __shared__ int s_list[2 * kSpan];   // a round's rays and up to one more
  __shared__ int s_warp[R][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_spans = (n_rays + kBruteThreads - 1) / kBruteThreads;
  unsigned long long n_visit = 0, n_keep = 0, n_exact = 0;
  // a table of one tile is staged once for all of the block's rounds
  const bool one_tile = n_tris <= kBruteTile;
  if (one_tile) {
    for (int k = tid; k < n_tris * kRow4; k += kBruteThreads) tile[k] = rows[k];
    __syncthreads();
  }
  int span = blockIdx.x;
  int pending = 0;  // live rays in s_list; the same value in every thread
  for (;;) {
    // fill the list: append the live rays of the block's next R spans (their
    // tmax loads in flight together), write the dead ones as misses
    while (pending < kSpan && span < n_spans) {
      int ray_i[R];
      bool live[R];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int sp = span + s * gridDim.x;
        ray_i[s] = sp < n_spans ? sp * kBruteThreads + tid : n_rays;
        live[s] = ray_i[s] < n_rays && tmax[ray_i[s]] > t_min;
      }
      unsigned bal[R];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int i = ray_i[s];
        if (i < n_rays && !live[s]) {
          t_out[i] = kInf; tri_out[i] = -1; u_out[i] = 0.f; v_out[i] = 0.f;
        }
        bal[s] = __ballot_sync(kFullMask, live[s]);
        if (lane == 0) s_warp[s][warp] = __popc(bal[s]);
      }
      __syncthreads();
      // the list keeps span order, then warp order, then lane order
      int total = 0;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        int before = 0, count = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int c = s_warp[s][w];
          before += w < warp ? c : 0;
          count += c;
        }
        if (live[s])
          s_list[pending + total + before +
                 __popc(bal[s] & ((1u << lane) - 1u))] = ray_i[s];
        total += count;
      }
      pending += total;
      span += R * gridDim.x;
      __syncthreads();  // s_warp is rewritten; the list is complete
    }
    if (pending == 0) break;
    const int take = min(pending, kSpan);
    // slot s of lane l in warp w: entry 32 (R w + s) + l, so each slot of a
    // warp reads 32 consecutive entries (coalesced) and a warp's rays are
    // 32 R consecutive live rays
    BruteRay ray[R];
    int idx[R];
    bool active = false;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int e = 32 * (R * warp + s) + lane;
      idx[s] = e < take ? s_list[e] : -1;
      BruteRay& r = ray[s];
      r.t_best = kInf; r.u_best = 0.f; r.v_best = 0.f; r.tri_best = -1;
      if (idx[s] >= 0) {
        const int64_t i = idx[s];
        r.ox = org[3 * i]; r.oy = org[3 * i + 1]; r.oz = org[3 * i + 2];
        r.dx = dir[3 * i]; r.dy = dir[3 * i + 1]; r.dz = dir[3 * i + 2];
        r.tmax = tmax[i];
        r.limg = scaled_limit(fminf(kInf, r.tmax));
        active = true;
      } else {
        r.ox = r.oy = r.oz = 0.f; r.dx = r.dy = r.dz = 1.f;
        r.tmax = 0.f; r.limg = 0.f;
      }
    }
    for (int base = 0; base < n_tris; base += kBruteTile) {
      const int n = min(kBruteTile, n_tris - base);
      if (!one_tile) {
        // any-hit: the round ends at the first tile no ray of the block
        // needs (a block-wide vote, so no warp waits at a barrier alone)
        if (any_hit) {
          if (!__syncthreads_or(active)) break;
        } else {
          __syncthreads();  // the previous tile has been read
        }
        for (int k = tid; k < n * kRow4; k += kBruteThreads)
          tile[k] = rows[(int64_t)base * kRow4 + k];
        __syncthreads();
      }
      // a warp none of whose rays needs the tile skips it; the others walk
      // it with all 32 lanes, so the votes below see the whole warp
      if (!__any_sync(kFullMask, active)) continue;
      const float4* const tbase = tile;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        const float4* row = tbase + j * kRow4;
        const float4 c2 = row[2], c4 = row[4], c5 = row[5];
        float qw[R], rw[R];
        bool keep[R];
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const BruteRay& r = ray[s];
          // q_w and r_w in the exact test's order: all the rejects need
          qw[s] = fadd(fadd(fadd(fmul(c2.x, r.ox), fmul(c2.y, r.oy)),
                            fmul(c2.z, r.oz)), c2.w);
          rw[s] = fadd(fadd(fmul(c4.z, r.dx), fmul(c4.w, r.dy)),
                       fmul(c5.x, r.dz));
          const float y = __int_as_float(__float_as_int(qw[s]) ^
                                         (__float_as_int(rw[s]) & 0x80000000));
          keep[s] = (fabsf(rw[s]) >= 1e-12f) & (y < 0.f) &
                    (-y < __fmul_rn(r.limg, fabsf(rw[s])));
          if (kCount) { n_visit += r.limg > 0.f; n_keep += keep[s]; }
        }
        // one branch per slot; v and the rest only where u passed (the
        // test's terms are ANDed, so their order changes no result)
        const float4 c0 = row[0], c1 = row[1], c3 = row[3];
#pragma unroll
        for (int s = 0; s < R; ++s) {
          if (keep[s]) {
            if (kCount && __ffs(__activemask()) - 1 == lane) n_exact += 32;
            const float t = __fdiv_rn(-qw[s], rw[s]);
            const float u = brute_u(c0, c3, t, ray[s]);
            if (u >= -1e-5f)
              brute_accept(t, u, brute_v(c1, c3, c4, t, ray[s]), t_min,
                           base + j, any_hit, ray[s]);
          }
        }
        if (any_hit) {
          // a warp whose rays all have a hit leaves the tile
          bool still = false;
#pragma unroll
          for (int s = 0; s < R; ++s) still |= ray[s].limg > 0.f;
          active = still;
          if (!__any_sync(kFullMask, still)) break;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (idx[s] < 0) continue;
      const int i = idx[s];
      t_out[i] = ray[s].t_best; tri_out[i] = ray[s].tri_best;
      u_out[i] = ray[s].u_best; v_out[i] = ray[s].v_best;
    }
    // move the entries past this round to the front of the list
    __syncthreads();
    const int rest = pending - take;
    for (int k = tid; k < rest; k += kBruteThreads) s_list[k] = s_list[take + k];
    pending = rest;
    __syncthreads();
  }
  if (kCount) {
    atomicAdd(&counts[0], n_visit);
    atomicAdd(&counts[1], n_keep);
    atomicAdd(&counts[2], n_exact);
  }
}

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

template <bool kCount>
void launch_brute(int rays, const int* grid, const float* org,
                  const float* dir, const float* tmax, const float4* rows,
                  int n_rays, int n_tris, float t_min, int any_hit,
                  float* t_out, int* tri_out, float* u_out, float* v_out,
                  unsigned long long* counts, cudaStream_t st) {
  if (rays == 2)
    woop_brute_kernel<2, kCount><<<grid[1], kBruteThreads, 0, st>>>(
        org, dir, tmax, rows, n_rays, n_tris, t_min, any_hit, t_out,
        tri_out, u_out, v_out, counts);
  else
    woop_brute_kernel<1, kCount><<<grid[0], kBruteThreads, 0, st>>>(
        org, dir, tmax, rows, n_rays, n_tris, t_min, any_hit, t_out,
        tri_out, u_out, v_out, counts);
}

}  // namespace

extern "C" {

// rows: (n_tris, 24) floats, 16-byte aligned. counts, where not null: 3
// zeroed uint64 (visited, kept and exactly tested pairs; a checking launch).
int kt_woop_brute(const float* org, const float* dir, const float* tmax,
                  const float* rows, int n_rays, int n_tris, float t_min,
                  int any_hit, float* t_out, int* tri_out, float* u_out,
                  float* v_out, unsigned long long* counts, void* stream) {
  if (n_rays <= 0) return 0;
  if (!(t_min >= 0.f) || (uintptr_t)rows % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // a table of several tiles: one wave of resident blocks, each walking the
  // spans b, b + G, ... (rounds are long, so they are filled whatever the
  // share of live rays); a one-tile table: a block for each R spans, so
  // that blocks start and end out of step and hide each other's loads
  // (a round of 32 triangles is too short to). R = 2 rays a thread where
  // that still gives every block of the wave a full round, else 1.
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  static int resident[2] = {0, 0};
  if (resident[0] == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident[0], woop_brute_kernel<1, false>, kBruteThreads, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident[1], woop_brute_kernel<2, false>, kBruteThreads, 0);
  }
  const int64_t spans = ((int64_t)n_rays + kBruteThreads - 1) / kBruteThreads;
  int grid[2];
  for (int k = 0; k < 2; ++k) {
    const int64_t per_block = int64_t{1} << k;   // R = 1, 2 spans a fill
    grid[k] = (int)(n_tris <= kBruteTile
        ? (spans + per_block - 1) / per_block
        : std::min<int64_t>(spans, (int64_t)std::max(1, resident[k]) * sms));
  }
  const int wave1 = std::max(1, resident[1]) * sms;
  const int rays = (int64_t)n_rays >= (int64_t)wave1 * kBruteThreads * 2 ? 2 : 1;
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  const cudaStream_t st = (cudaStream_t)stream;
  if (counts != nullptr)
    launch_brute<true>(rays, grid, org, dir, tmax, r4, n_rays, n_tris, t_min,
                       any_hit, t_out, tri_out, u_out, v_out, counts, st);
  else
    launch_brute<false>(rays, grid, org, dir, tmax, r4, n_rays, n_tris, t_min,
                        any_hit, t_out, tri_out, u_out, v_out, nullptr, st);
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
