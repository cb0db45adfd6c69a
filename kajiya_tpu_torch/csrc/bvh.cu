// BVH walk for Hopper (sm_90a): the port's software TraceRay for scenes on
// the BVH route (above brute_max_tris triangles, world.py).
//
// bvh_walk_kernel  replaces the XLA `lax.while_loop` `_traverse` of
//    kajiya_tpu/rt/trace.py:78 (trace_closest / trace_shadow); there is no
//    Pallas kernel for it. JAX steps every ray of the batch in lockstep
//    until the last one ends; in PyTorch that loop would need one host read
//    a step, so the walk is one kernel, a thread a ray at a time, its
//    state in registers (and a short stack in shared memory).
//    Bound: fp32 operations over the card's fp32 peak, counted from this
//    body: 22 a box test (the slab test: 6 subtractions, 6
//    multiplications, 10 min / max) and 46 a triangle test (two crosses,
//    four dot products, 3 subtractions, 3 multiplications, a division, the
//    u + v addition), compares not counted. What held the first version
//    (one thread a ray, the skip-link walk over the build's arrays) at
//    20-68x that bound, as its counts read (no stall profiler runs on the
//    card), was the memory hierarchy and idle lanes, not the
//    arithmetic: five scattered 32-byte sectors a node visit (float3 boxes
//    and three int32 arrays) and a triangle fetched through tri_order and
//    three float3 gathers, in tables of ~76 MB that the L1 cannot hold;
//    boxes behind the closest hit walked because the skip-link order is
//    fixed at build time; warps running to their slowest lane; dead lanes
//    (t_max <= t_min, the path tracer's ended paths) walking every box
//    around their origin. The design, in the four steps it was built in
//    (each step's times on city40 are in PERF.md section 6):
//    (a) packed tables (rt/bvh.py::pack_walk_tables, repacked after every
//        build and refit): a node is one 32-byte record read as two
//        aligned float4 (min, skip | max, link: the right child of an
//        internal node, -1 - first of a leaf), a tri_order slot one
//        48-byte record (v0, id | e1 | e2), so a leaf's triangles are one
//        contiguous run of at most leaf_size * 48 bytes;
//    (b) a ray with t_max <= t_min cannot be hit (a win needs t > t_min and
//        t < t_best <= t_max): it is written (t_max, -1, 0, 0) with no
//        visit;
//    (c) persistent ray fetch: one wave of blocks; a lane whose ray has
//        ended writes its result and takes a new ray in a refill round of
//        its warp ("while-while" with refill, Aila & Laine, HPG 2009): the
//        round takes as many consecutive rays as the warp has idle lanes
//        from a counter in device memory (one atomicAdd a round, zeroed
//        on the stream by the launch: no host read; handing out rays
//        from a pool of 32 or 64 a warp measured slower and held more
//        registers). A round starts once 8 lanes of a front-to-back warp are
//        idle (1 refills too often and mixes far rays into a coherent
//        warp, 32 leaves lanes idle); a skip-link step is a single node,
//        so those warps refill once all their lanes are idle (a check a
//        step cost more than it saved). Dead rays are written and
//        replaced within the round, so they hold no lane;
//    (d) closest-hit calls without a step cap walk front to back: a
//        64-byte pair record a node holds both children's boxes and codes
//        (an internal child's index, a leaf's -1 - first), so a descent is
//        one aligned 64-byte fetch; both boxes are tested, the nearer child
//        is entered (the left one on a tie) and the farther pushed with
//        its entry distance on a per-thread stack in shared memory, one
//        entry a BVH level (19 on city40, so a shallow BVH leaves room for
//        more blocks); a leaf's triangles are tested in slot order, then
//        the stack pops entries whose entry distance is still within
//        t_cull. A triangle wins on t < t_best, or t == t_best from a lower
//        tri_order slot; once a ray has a hit its boxes are tested against
//        t_cull = t_best + |t_best| 2^-16, so a triangle that ties the hit
//        is still reached where its box's entry distance rounds above it.
//        Any-hit calls and calls with a step cap keep the skip-link walk
//        (the cap counts its steps); the mode is a template parameter.
//
// Every result equals the plain version on the card bit for bit
// (rt/trace.py: `walk_ordered_plain` for the front-to-back walk,
// `walk_plain` for the skip-link walk), counts included: every rounding is
// explicit (__fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn, nothing
// contracts into an FMA, no fast reciprocal), dot products are summed
// (x x' + y y') + z z', crosses are taken in ops/smallvec.py's order, and
// min / max propagate NaN as torch.minimum / torch.maximum do.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWalkThreads = 128;
// idle lanes of a front-to-back warp before it refills (1, 4, 16 and 32
// were slower on city40's frame wavefronts taken together)
constexpr int kRefillIdle = 8;
constexpr float kTieMargin = 0x1p-16f;  // rt/trace.py TIE_MARGIN

enum Mode { kSkipClosest = 0, kSkipAnyHit = 1, kOrdered = 2 };

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float dot3_rn(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// a x b in ops/smallvec.py's order
__device__ __forceinline__ void cross_rn(float ax, float ay, float az,
                                         float bx, float by, float bz,
                                         float& cx, float& cy, float& cz) {
  cx = __fsub_rn(__fmul_rn(ay, bz), __fmul_rn(az, by));
  cy = __fsub_rn(__fmul_rn(az, bx), __fmul_rn(ax, bz));
  cz = __fsub_rn(__fmul_rn(ax, by), __fmul_rn(ay, bx));
}

// rt/trace.py::_safe_inv
__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-12f;
  const float x = fabsf(d) < eps ? (d < 0.f ? -eps : eps) : d;
  return __fdiv_rn(1.0f, x);
}

struct Params {
  const float* org;
  const float* dir;
  const float* tmax;
  const float4* nodes;     // 2 a node
  const float4* leaves;    // 3 a tri_order slot
  const float4* pairs;     // 4 a node: its children's boxes
  int* counter;
  float* t_out;
  int* tri_out;
  float* u_out;
  float* v_out;
  int* visits_out;
  int* tests_out;
  float t_min;
  int n_nodes;
  int leaf_size;
  int n_rays;
  int max_steps;
};

// One ray's walk; `stack` is this thread's column of the block's stack
// (entry k at stack[k * kWalkThreads]). The skip-link walk's position is
// `node`; the front-to-back walk's is `code`: an internal node's index
// (>= 0), a leaf's -1 - first (< 0), kDone when the ray has ended.
template <int kMode>
struct Walker {
  static constexpr int kDone = INT_MIN;
  const Params& p;
  int2* stack;
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float t_best, t_cull, u_best, v_best;
  int tri_best, pos_best, node, code, sp, visits, tests, ray;

  // rt/trace.py::_slab: entry and exit distances through a node's box
  __device__ __forceinline__ void slab(const float4 lo, const float4 hi,
                                       float& tn, float& tf) const {
    const float t0x = __fmul_rn(__fsub_rn(lo.x, ox), ix);
    const float t0y = __fmul_rn(__fsub_rn(lo.y, oy), iy);
    const float t0z = __fmul_rn(__fsub_rn(lo.z, oz), iz);
    const float t1x = __fmul_rn(__fsub_rn(hi.x, ox), ix);
    const float t1y = __fmul_rn(__fsub_rn(hi.y, oy), iy);
    const float t1z = __fmul_rn(__fsub_rn(hi.z, oz), iz);
    tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                 nan_min(t0z, t1z));
    tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                 nan_max(t0z, t1z));
  }

  static __device__ __forceinline__ bool box_hit(float tn, float tf,
                                                 float t) {
    return (tn <= tf) && (tf >= 0.f) && (tn <= t);
  }

  // rt/trace.py::_tri_intersect on slot `pos` (v0, id | e1 | e2)
  __device__ __forceinline__ void test_tri(const float4 a, const float4 b,
                                           const float4 c, int id, int pos) {
    float px, py, pz;
    cross_rn(dx, dy, dz, c.x, c.y, c.z, px, py, pz);
    const float det = dot3_rn(b.x, b.y, b.z, px, py, pz);
    bool valid = fabsf(det) > 1e-12f;
    const float inv_det = __fdiv_rn(1.0f, valid ? det : 1.0f);
    const float tx = __fsub_rn(ox, a.x);
    const float ty = __fsub_rn(oy, a.y);
    const float tz = __fsub_rn(oz, a.z);
    const float u = __fmul_rn(dot3_rn(tx, ty, tz, px, py, pz), inv_det);
    float qx, qy, qz;
    cross_rn(tx, ty, tz, b.x, b.y, b.z, qx, qy, qz);
    const float v = __fmul_rn(dot3_rn(dx, dy, dz, qx, qy, qz), inv_det);
    const float t = __fmul_rn(dot3_rn(c.x, c.y, c.z, qx, qy, qz), inv_det);
    valid = valid && u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.0f;
    bool win = valid && t > p.t_min && t < t_best;
    if constexpr (kMode == kOrdered)
      win = win || (valid && t > p.t_min && t == t_best && tri_best >= 0 &&
                    pos < pos_best);
    if (win) {
      t_best = t;
      tri_best = id;
      u_best = u;
      v_best = v;
      pos_best = pos;
      if constexpr (kMode == kOrdered)
        t_cull = __fadd_rn(t, __fmul_rn(fabsf(t), kTieMargin));
    }
  }

  // the triangles of the leaf whose link is `leaf_link`, in slot order
  __device__ __forceinline__ void test_leaf(int leaf_link) {
    const int first = -1 - leaf_link;
    for (int k = 0; k < p.leaf_size; ++k) {
      const int pos = first + k;
      const float4* rec = p.leaves + 3 * (int64_t)pos;
      const float4 a = __ldg(rec);
      const int id = __float_as_int(a.w);
      if (id < 0) break;               // the run's padding
      ++tests;
      test_tri(a, __ldg(rec + 1), __ldg(rec + 2), id, pos);
    }
  }

  // Take ray r. Returns true when the ray has already ended (a dead lane,
  // a missed root, a cap of 0 steps).
  __device__ __forceinline__ bool start(int r) {
    ray = r;
    t_best = t_cull = __ldg(p.tmax + r);
    u_best = v_best = 0.f;
    tri_best = -1;
    pos_best = 0;
    visits = tests = 0;
    node = 0;
    sp = 0;
    if (t_best <= p.t_min) return true;
    ox = __ldg(p.org + 3 * (int64_t)r);
    oy = __ldg(p.org + 3 * (int64_t)r + 1);
    oz = __ldg(p.org + 3 * (int64_t)r + 2);
    dx = __ldg(p.dir + 3 * (int64_t)r);
    dy = __ldg(p.dir + 3 * (int64_t)r + 1);
    dz = __ldg(p.dir + 3 * (int64_t)r + 2);
    ix = safe_inv(dx);
    iy = safe_inv(dy);
    iz = safe_inv(dz);
    if constexpr (kMode == kOrdered) {
      const float4 hi = __ldg(p.nodes + 1);
      float tn, tf;
      slab(__ldg(p.nodes), hi, tn, tf);
      visits = 1;
      const int link = __float_as_int(hi.w);
      code = link < 0 ? link : 0;
      return !box_hit(tn, tf, t_cull);
    } else {
      return p.n_nodes <= 0 || p.max_steps == 0;
    }
  }

  // the next stack entry still within t_cull, or kDone
  __device__ __forceinline__ void pop() {
    code = kDone;
    while (sp > 0) {
      const int2 e = stack[--sp * kWalkThreads];
      if (__int_as_float(e.y) <= t_cull) {
        code = e.x;
        return;
      }
    }
  }

  // One step of the walk. Returns true when the ray has ended.
  __device__ __forceinline__ bool step() {
    if constexpr (kMode == kOrdered) {
      // descend until a leaf is reached or nothing is left: one pair
      // record a descent holds both children's boxes and codes
      while (code >= 0) {
        const float4* rec = p.pairs + 4 * (int64_t)code;
        const float4 a = __ldg(rec), b = __ldg(rec + 1);
        const float4 c = __ldg(rec + 2), d = __ldg(rec + 3);
        float tn0, tf0, tn1, tf1;
        slab(a, b, tn0, tf0);
        slab(c, d, tn1, tf1);
        visits += 2;
        const bool h0 = box_hit(tn0, tf0, t_cull);
        const bool h1 = box_hit(tn1, tf1, t_cull);
        const int w0 = __float_as_int(a.w), w1 = __float_as_int(b.w);
        const int code0 = w0 < 0 ? w0 : code + 1;
        const int code1 = w1 < 0 ? w1 : __float_as_int(c.w);
        if (h0 && h1) {
          const bool swap = tn1 < tn0;
          stack[sp++ * kWalkThreads] = make_int2(
              swap ? code0 : code1, __float_as_int(swap ? tn0 : tn1));
          code = swap ? code1 : code0;
        } else if (h0 || h1) {
          code = h0 ? code0 : code1;
        } else {
          pop();
          if (code == kDone) return true;
        }
      }
      test_leaf(code);
      pop();
      return code == kDone;
    } else {
      ++visits;
      const float4 lo = __ldg(p.nodes + 2 * (int64_t)node);
      const float4 hi = __ldg(p.nodes + 2 * (int64_t)node + 1);
      float tn, tf;
      slab(lo, hi, tn, tf);
      const bool hit = box_hit(tn, tf, t_best);
      const int link = __float_as_int(hi.w);
      if (hit && link < 0) test_leaf(link);
      node = (hit && link >= 0) ? node + 1 : __float_as_int(lo.w);
      if (kMode == kSkipAnyHit && tri_best >= 0) node = p.n_nodes;
      return node >= p.n_nodes ||
             (p.max_steps >= 0 && visits >= p.max_steps);
    }
  }

  __device__ __forceinline__ void finish() const {
    p.t_out[ray] = t_best;
    p.tri_out[ray] = tri_best;
    p.u_out[ray] = u_best;
    p.v_out[ray] = v_best;
    if (p.visits_out != nullptr) {
      p.visits_out[ray] = visits;
      p.tests_out[ray] = tests;
    }
  }
};

template <int kMode>
__global__ void __launch_bounds__(kWalkThreads)
    bvh_walk_kernel(const __grid_constant__ Params p) {
  extern __shared__ int2 stack_mem[];
  Walker<kMode> w{p, stack_mem + threadIdx.x};
  // a skip-link step is one node: a check every step costs more than it
  // saves, so those warps refill once all their rays have ended
  const int refill_idle = kMode == kOrdered ? kRefillIdle : 32;
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  bool exhausted = false, has = false;   // exhausted: warp-uniform
  for (;;) {
    // a refill round starts once refill_idle lanes are idle; it gives
    // every idle lane a ray, and rays that end at once (dead lanes, a
    // missed root) are written and replaced within the round
    unsigned want = __ballot_sync(0xffffffffu, !has);
    if (__popc(want) < refill_idle) want = 0u;
    while (want != 0u && !exhausted) {
      const int k = __popc(want);
      const int rank = __popc(want & below);
      int base = 0;
      if (lane == 0) base = atomicAdd(p.counter, k);
      base = __shfl_sync(0xffffffffu, base, 0);
      const int r = base + rank;
      exhausted = base + k >= p.n_rays;
      if (!has && r < p.n_rays) {
        if (w.start(r))
          w.finish();
        else
          has = true;
      }
      want = __ballot_sync(0xffffffffu, !has);
    }
    if (__ballot_sync(0xffffffffu, has) == 0u) break;
    if constexpr (kMode == kOrdered) {
      if (has && w.step()) {
        w.finish();
        has = false;
      }
    } else {
      while (has) {
        if (w.step()) {
          w.finish();
          has = false;
        }
      }
    }
  }
}

template <int kMode>
int launch_walk(const Params& p, int stack_depth, cudaStream_t st) {
  // the stack holds as many entries as the BVH has internal levels, so a
  // shallower BVH leaves room for more resident blocks
  const size_t smem = kMode == kOrdered
      ? sizeof(int2) * (stack_depth > 0 ? stack_depth : 1) * kWalkThreads
      : 0;
  // one wave of resident blocks on the current device, asked at every
  // launch (host-side queries: nothing cached across devices or threads)
  int dev = 0, sms = 0, resident = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, bvh_walk_kernel<kMode>, kWalkThreads, smem);
  const int wave = (resident > 0 ? resident : 1) * sms;
  const int needed = (p.n_rays + kWalkThreads - 1) / kWalkThreads;
  const int grid = needed < wave ? needed : wave;
  bvh_walk_kernel<kMode><<<grid, kWalkThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// org, dir: (n_rays, 3); tmax: (n_rays,); nodes: (n_nodes, 8), leaves:
// (P, 12) and pairs: (n_nodes, 16) from pack_walk_tables, 16-byte aligned;
// stack_depth: the BVH's internal levels (rt/trace.py::walk_depth), the
// front-to-back walk's stack entries; counter: one int32 of scratch
// (zeroed here, on the stream). Closest-hit calls without a cap (any_hit
// 0, max_steps < 0) walk front to back, the others take the skip-link
// walk. visits / tests, where not null: (n_rays,) int32 per ray node
// visits (front to back: box tests) and triangle tests (a checking
// launch). Launches on `stream`; returns the launch's error code.
int kt_bvh_walk(const float* org, const float* dir, const float* tmax,
                float t_min, const float* nodes, int n_nodes,
                const float* leaves, const float* pairs, int leaf_size,
                int stack_depth, int n_rays, int any_hit,
                int max_steps, int* counter, float* t_out, int* tri_out,
                float* u_out, float* v_out, int* visits, int* tests,
                void* stream) {
  if (n_rays <= 0) return 0;
  if ((visits == nullptr) != (tests == nullptr) || counter == nullptr ||
      leaf_size < 1 || n_nodes < 1 || n_rays > INT_MAX - (1 << 26) ||
      stack_depth < 0 || stack_depth > 32 ||
      (uintptr_t)nodes % 16 != 0 || (uintptr_t)leaves % 16 != 0 ||
      (uintptr_t)pairs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t zero = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (zero != cudaSuccess) return (int)zero;
  const Params p{org, dir, tmax,
                 reinterpret_cast<const float4*>(nodes),
                 reinterpret_cast<const float4*>(leaves),
                 reinterpret_cast<const float4*>(pairs), counter, t_out,
                 tri_out, u_out, v_out, visits, tests, t_min, n_nodes,
                 leaf_size, n_rays, max_steps};
  if (any_hit) return launch_walk<kSkipAnyHit>(p, 0, st);
  if (max_steps >= 0)
    return launch_walk<kSkipClosest>(p, 0, st);
  return launch_walk<kOrdered>(p, stack_depth, st);
}

}  // extern "C"
