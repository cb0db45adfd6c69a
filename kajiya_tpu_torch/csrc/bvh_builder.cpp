// Native BVH builder: Morton-ordered median-split tree flattened to the
// skip-link layout consumed by kajiya_tpu_torch.rt.bvh (the port's own copy
// of kajiya_tpu/native/bvh_builder.cpp, unchanged below this header).
//
// Role of the reference's native acceleration-structure build (the BLAS /
// TLAS build and compaction behind `vulkan/ray_tracing.rs:96-275`): the
// host-side part of "rebuild tlas". The Python builder (rt/bvh.py) is kept as
// the reference implementation and gives the same bytes; this one handles
// production-size meshes (millions of triangles) at C++ speed. It is built
// with the host compiler (g++ -O2 -shared -fPIC -std=c++17) at first use.
//
// Exposed via a C ABI for ctypes:
//   int build_bvh(const float* tri_min, const float* tri_max, int n_tris,
//                 int leaf_size,
//                 float* node_min, float* node_max,     // cap 2*n_tris
//                 int* node_first, int* node_count, int* node_skip,
//                 int* node_depth,
//                 int* tri_order,                       // cap 2*n_tris
//                 int* out_n_nodes, int* out_n_order);
// Returns 0 on success. Caller allocates all buffers.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Range { int start, end, depth, parent_slot; };

inline uint32_t expand_bits(uint32_t v) {
    v = (v * 0x00010001u) & 0xFF0000FFu;
    v = (v * 0x00000101u) & 0x0F00F00Fu;
    v = (v * 0x00000011u) & 0xC30C30C3u;
    v = (v * 0x00000005u) & 0x49249249u;
    return v;
}

inline uint32_t morton3(float x, float y, float z) {
    uint32_t xi = (uint32_t)std::min(std::max(x * 1024.0f, 0.0f), 1023.0f);
    uint32_t yi = (uint32_t)std::min(std::max(y * 1024.0f, 0.0f), 1023.0f);
    uint32_t zi = (uint32_t)std::min(std::max(z * 1024.0f, 0.0f), 1023.0f);
    return (expand_bits(xi) << 2) | (expand_bits(yi) << 1) | expand_bits(zi);
}

}  // namespace

extern "C" int build_bvh(
    const float* tri_min, const float* tri_max, int n_tris, int leaf_size,
    float* node_min, float* node_max,
    int* node_first, int* node_count, int* node_skip, int* node_depth,
    int* tri_order, int* out_n_nodes, int* out_n_order) {
    if (n_tris <= 0 || leaf_size <= 0) return 1;

    // ---- morton order over centroid bounds
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    std::vector<float> cx(n_tris), cy(n_tris), cz(n_tris);
    for (int i = 0; i < n_tris; ++i) {
        float c[3];
        for (int k = 0; k < 3; ++k) {
            c[k] = 0.5f * (tri_min[i * 3 + k] + tri_max[i * 3 + k]);
            lo[k] = std::min(lo[k], c[k]);
            hi[k] = std::max(hi[k], c[k]);
        }
        cx[i] = c[0]; cy[i] = c[1]; cz[i] = c[2];
    }
    float inv[3];
    for (int k = 0; k < 3; ++k) {
        float d = hi[k] - lo[k];
        inv[k] = d > 1e-12f ? 1.0f / d : 0.0f;
    }
    std::vector<std::pair<uint32_t, int>> keyed(n_tris);
    for (int i = 0; i < n_tris; ++i) {
        keyed[i] = { morton3((cx[i] - lo[0]) * inv[0],
                             (cy[i] - lo[1]) * inv[1],
                             (cz[i] - lo[2]) * inv[2]), i };
    }
    std::stable_sort(keyed.begin(), keyed.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    std::vector<int> order(n_tris);
    for (int i = 0; i < n_tris; ++i) order[i] = keyed[i].second;

    // ---- iterative DFS emission (explicit stack; preorder => skip links)
    int n_nodes = 0, n_leaves = 0;
    std::vector<Range> stack;
    stack.push_back({0, n_tris, 0, -1});
    // To emit in DFS *preorder* with correct child order from a LIFO stack,
    // push right child first. skip[] is fixed after each subtree completes:
    // record for each node the index AFTER its subtree = next emission index
    // at the time its range is fully consumed. We instead compute skips in a
    // second pass from subtree sizes tracked via a parallel stack.
    std::vector<int> subtree_end(2 * (size_t)n_tris, 0);

    struct Frame { int start, end, depth, node; bool expanded; };
    std::vector<Frame> fs;
    fs.push_back({0, n_tris, 0, -1, false});
    while (!fs.empty()) {
        Frame f = fs.back(); fs.pop_back();
        if (!f.expanded) {
            int node = n_nodes++;
            node_depth[node] = f.depth;
            if (f.end - f.start <= leaf_size) {
                node_first[node] = n_leaves * leaf_size;
                node_count[node] = f.end - f.start;
                float bmin[3] = {1e30f, 1e30f, 1e30f};
                float bmax[3] = {-1e30f, -1e30f, -1e30f};
                for (int i = f.start; i < f.end; ++i) {
                    int t = order[i];
                    tri_order[n_leaves * leaf_size + (i - f.start)] = t;
                    for (int k = 0; k < 3; ++k) {
                        bmin[k] = std::min(bmin[k], tri_min[t * 3 + k]);
                        bmax[k] = std::max(bmax[k], tri_max[t * 3 + k]);
                    }
                }
                for (int i = f.end - f.start; i < leaf_size; ++i)
                    tri_order[n_leaves * leaf_size + i] = -1;
                ++n_leaves;
                std::memcpy(node_min + node * 3, bmin, 12);
                std::memcpy(node_max + node * 3, bmax, 12);
                subtree_end[node] = n_nodes;  // leaf: subtree = itself
                node_skip[node] = 0;          // fixed up below
            } else {
                node_first[node] = 0;
                node_count[node] = 0;
                int mid = (f.start + f.end) / 2;
                // re-push self (expanded) to finalize bounds after children,
                // then right child, then left child (left pops first)
                fs.push_back({f.start, f.end, f.depth, node, true});
                fs.push_back({mid, f.end, f.depth + 1, -1, false});
                fs.push_back({f.start, mid, f.depth + 1, -1, false});
            }
        } else {
            int node = f.node;
            // children are node+1 (left) and subtree_end[node+1] (right)
            int left = node + 1;
            int right = subtree_end[left];
            for (int k = 0; k < 3; ++k) {
                node_min[node * 3 + k] = std::min(node_min[left * 3 + k],
                                                  node_min[right * 3 + k]);
                node_max[node * 3 + k] = std::max(node_max[left * 3 + k],
                                                  node_max[right * 3 + k]);
            }
            subtree_end[node] = subtree_end[right];
        }
    }
    for (int i = 0; i < n_nodes; ++i) node_skip[i] = subtree_end[i];

    *out_n_nodes = n_nodes;
    *out_n_order = n_leaves * leaf_size;
    return 0;
}
