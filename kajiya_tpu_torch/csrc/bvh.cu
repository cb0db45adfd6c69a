// Skip-link BVH walk for Hopper (sm_90a): the port's software TraceRay for
// scenes on the BVH route (above brute_max_tris triangles, world.py).
//
// bvh_walk_kernel  replaces the XLA `lax.while_loop` `_traverse` of
//    kajiya_tpu/rt/trace.py:78 (trace_closest / trace_shadow); there is no
//    Pallas kernel for it. JAX steps every ray of the batch in lockstep
//    until the last one ends; in PyTorch that loop would need one host read
//    a step, so the walk is one kernel, one thread a ray, all state in
//    registers (node, steps, best t, tri, u, v), no stack: a hit internal
//    node descends to node + 1, anything else jumps to node_skip[node].
//    At a hit leaf its triangles are tested in order (double-sided
//    Moller-Trumbore); a test wins on t > t_min && t < t_best, so on a tie
//    the first triangle visited keeps the hit. An any-hit ray ends after
//    the first leaf that gives it a hit. A ray ends at node == n_nodes or
//    after max_steps node visits (max_steps < 0: no cap), as the lockstep
//    loop's global step cap ends it.
//    Bound: fp32 operations over the card's fp32 peak, counted from this
//    body: 22 a node visit (the slab test: 6 subtractions, 6
//    multiplications, 10 min / max) and 46 a triangle test (two crosses,
//    four dot products, 3 subtractions, 3 multiplications, a division, the
//    u + v addition), compares not counted; the visits and tests are this
//    run's (the checking launch counts them per ray). The first design
//    is the simple one: the node arrays are read as the build lays them out
//    (float3 boxes, three int32 arrays), rays are walked in the order they
//    come, and nothing is sorted; divergence between neighbouring rays and
//    the node fetch latency set its time (PERF.md section 6).
//
// Every result equals `walk_plain` (rt/trace.py) on the card bit for bit:
// every rounding is explicit (__fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn,
// nothing contracts into an FMA, no fast reciprocal), dot products are
// summed (x x' + y y') + z z', crosses are taken in ops/smallvec.py's order,
// and min / max propagate NaN as torch.minimum / torch.maximum do.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWalkThreads = 128;

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

__global__ void __launch_bounds__(kWalkThreads) bvh_walk_kernel(
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ tmax, float t_min,
    const float* __restrict__ node_min, const float* __restrict__ node_max,
    const int* __restrict__ node_first, const int* __restrict__ node_count,
    const int* __restrict__ node_skip, int n_nodes,
    const int* __restrict__ tri_order, const float* __restrict__ v0,
    const float* __restrict__ e1, const float* __restrict__ e2, int n_rays,
    int any_hit, int max_steps, float* __restrict__ t_out,
    int* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ visits_out,
    int* __restrict__ tests_out) {
  const int r = blockIdx.x * kWalkThreads + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = org[3 * r], oy = org[3 * r + 1], oz = org[3 * r + 2];
  const float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float t_best = tmax[r], u_best = 0.f, v_best = 0.f;
  int tri_best = -1, node = 0, steps = 0, tests = 0;
  while (node < n_nodes && (max_steps < 0 || steps < max_steps)) {
    ++steps;
    // slab test against the current best t (rt/trace.py::_aabb_hit)
    const float* bmin = node_min + 3 * (int64_t)node;
    const float* bmax = node_max + 3 * (int64_t)node;
    const float t0x = __fmul_rn(__fsub_rn(__ldg(bmin), ox), ix);
    const float t0y = __fmul_rn(__fsub_rn(__ldg(bmin + 1), oy), iy);
    const float t0z = __fmul_rn(__fsub_rn(__ldg(bmin + 2), oz), iz);
    const float t1x = __fmul_rn(__fsub_rn(__ldg(bmax), ox), ix);
    const float t1y = __fmul_rn(__fsub_rn(__ldg(bmax + 1), oy), iy);
    const float t1z = __fmul_rn(__fsub_rn(__ldg(bmax + 2), oz), iz);
    const float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                             nan_min(t0z, t1z));
    const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                             nan_max(t0z, t1z));
    const bool box_hit = (tn <= tf) && (tf >= 0.f) && (tn <= t_best);
    const int count = __ldg(node_count + node);
    if (box_hit && count > 0) {
      const int first = __ldg(node_first + node);
      for (int k = 0; k < count; ++k) {
        const int tid = __ldg(tri_order + first + k);
        if (tid < 0) continue;
        ++tests;
        const float* a = v0 + 3 * (int64_t)tid;
        const float* b = e1 + 3 * (int64_t)tid;
        const float* c = e2 + 3 * (int64_t)tid;
        const float e1x = __ldg(b), e1y = __ldg(b + 1), e1z = __ldg(b + 2);
        const float e2x = __ldg(c), e2y = __ldg(c + 1), e2z = __ldg(c + 2);
        // rt/trace.py::_tri_intersect
        float px, py, pz;
        cross_rn(dx, dy, dz, e2x, e2y, e2z, px, py, pz);
        const float det = dot3_rn(e1x, e1y, e1z, px, py, pz);
        bool valid = fabsf(det) > 1e-12f;
        const float inv_det = __fdiv_rn(1.0f, valid ? det : 1.0f);
        const float tx = __fsub_rn(ox, __ldg(a));
        const float ty = __fsub_rn(oy, __ldg(a + 1));
        const float tz = __fsub_rn(oz, __ldg(a + 2));
        const float u = __fmul_rn(dot3_rn(tx, ty, tz, px, py, pz), inv_det);
        float qx, qy, qz;
        cross_rn(tx, ty, tz, e1x, e1y, e1z, qx, qy, qz);
        const float v = __fmul_rn(dot3_rn(dx, dy, dz, qx, qy, qz), inv_det);
        const float t = __fmul_rn(dot3_rn(e2x, e2y, e2z, qx, qy, qz),
                                  inv_det);
        valid = valid && u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.0f;
        if (valid && t > t_min && t < t_best) {
          t_best = t;
          tri_best = tid;
          u_best = u;
          v_best = v;
        }
      }
    }
    node = (box_hit && count == 0) ? node + 1 : __ldg(node_skip + node);
    if (any_hit && tri_best >= 0) node = n_nodes;
  }
  t_out[r] = t_best;
  tri_out[r] = tri_best;
  u_out[r] = u_best;
  v_out[r] = v_best;
  if (visits_out != nullptr) {
    visits_out[r] = steps;
    tests_out[r] = tests;
  }
}

}  // namespace

extern "C" {

// org, dir: (n_rays, 3); tmax: (n_rays,); node_min / node_max: (n_nodes, 3);
// node_first / node_count / node_skip: (n_nodes,); tri_order: padded runs;
// v0 / e1 / e2: (T, 3). visits / tests, where not null: (n_rays,) int32 per
// ray node visits and triangle tests (a checking launch). Launches on
// `stream`; returns the launch's error code.
int kt_bvh_walk(const float* org, const float* dir, const float* tmax,
                float t_min, const float* node_min, const float* node_max,
                const int* node_first, const int* node_count,
                const int* node_skip, int n_nodes, const int* tri_order,
                const float* v0, const float* e1, const float* e2, int n_rays,
                int any_hit, int max_steps, float* t_out, int* tri_out,
                float* u_out, float* v_out, int* visits, int* tests,
                void* stream) {
  if (n_rays <= 0) return 0;
  if ((visits == nullptr) != (tests == nullptr))
    return (int)cudaErrorInvalidValue;
  const int grid = (n_rays + kWalkThreads - 1) / kWalkThreads;
  bvh_walk_kernel<<<grid, kWalkThreads, 0, (cudaStream_t)stream>>>(
      org, dir, tmax, t_min, node_min, node_max, node_first, node_count,
      node_skip, n_nodes, tri_order, v0, e1, e2, n_rays, any_hit, max_steps,
      t_out, tri_out, u_out, v_out, visits, tests);
  return (int)cudaGetLastError();
}

}  // extern "C"
