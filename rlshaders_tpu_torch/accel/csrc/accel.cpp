// Native BVH / cluster builder for rlshaders_tpu.
//
// Host-side runtime component (the tier the reference implements in C++ —
// its whole plugin is native; here the device compute path is JAX/Pallas and
// the scene-build runtime is native). Builds the same flattened threaded
// ("skip-link") BVH layout as rlshaders_tpu.accel.bvh.build: DFS node order,
// left child = i+1, miss link = i + subtree size, binned SAH splits.
//
// C ABI only (consumed via ctypes — no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libaccel.so accel.cpp
//
// Copied verbatim from rlshaders_tpu/accel/csrc/accel.cpp: the torch port
// may neither import nor read the JAX package, so it builds its own copy.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
    Vec3 min(const Vec3& o) const {
        return {std::min(x, o.x), std::min(y, o.y), std::min(z, o.z)};
    }
    Vec3 max(const Vec3& o) const {
        return {std::max(x, o.x), std::max(y, o.y), std::max(z, o.z)};
    }
    float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

struct Box {
    Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    void grow(const Box& b) {
        lo = lo.min(b.lo);
        hi = hi.max(b.hi);
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    const float* v0;
    const float* e1;
    const float* e2;
    int leaf_size;
    int n_bins;
    std::vector<Box> tri_box;
    std::vector<Vec3> cent;
    std::vector<int> order;

    // output arrays (DFS order)
    std::vector<float> bmin, bmax;
    std::vector<int> first, count, subtree;

    int build_node(int lo, int hi) {
        int me = static_cast<int>(first.size());
        Box b;
        for (int i = lo; i < hi; ++i) b.grow(tri_box[order[i]]);
        bmin.insert(bmin.end(), {b.lo.x, b.lo.y, b.lo.z});
        bmax.insert(bmax.end(), {b.hi.x, b.hi.y, b.hi.z});
        first.push_back(-1);
        count.push_back(0);
        subtree.push_back(1);

        int n = hi - lo;
        if (n <= leaf_size) {
            first[me] = lo;
            count[me] = n;
            return me;
        }

        // centroid bounds + widest axis
        Vec3 cmin{FLT_MAX, FLT_MAX, FLT_MAX}, cmax{-FLT_MAX, -FLT_MAX, -FLT_MAX};
        for (int i = lo; i < hi; ++i) {
            cmin = cmin.min(cent[order[i]]);
            cmax = cmax.max(cent[order[i]]);
        }
        float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int mid;
        if (ext[axis] < 1e-12f) {
            mid = lo + n / 2;
        } else {
            const int nb = n_bins;
            std::vector<Box> bin_box(nb);
            std::vector<int> bin_cnt(nb, 0);
            float scale = nb * (1.0f - 1e-6f) / ext[axis];
            for (int i = lo; i < hi; ++i) {
                int t = order[i];
                int b_ = static_cast<int>((cent[t][axis] - cmin[axis]) * scale);
                bin_box[b_].grow(tri_box[t]);
                bin_cnt[b_]++;
            }
            std::vector<float> la(nb), ra(nb);
            std::vector<int> lc(nb);
            Box acc;
            int c = 0;
            for (int b_ = 0; b_ < nb; ++b_) {
                acc.grow(bin_box[b_]);
                c += bin_cnt[b_];
                la[b_] = acc.area();
                lc[b_] = c;
            }
            Box racc;
            for (int b_ = nb - 1; b_ >= 0; --b_) {
                racc.grow(bin_box[b_]);
                ra[b_] = racc.area();
            }
            float best_cost = FLT_MAX;
            int best = -1;
            for (int b_ = 0; b_ < nb - 1; ++b_) {
                int nl = lc[b_], nr = n - nl;
                if (!nl || !nr) continue;
                float cost = la[b_] * nl + ra[b_ + 1] * nr;
                if (cost < best_cost) {
                    best_cost = cost;
                    best = b_;
                }
            }
            if (best < 0) {
                mid = lo + n / 2;
            } else {
                auto it = std::partition(
                    order.begin() + lo, order.begin() + hi, [&](int t) {
                        return static_cast<int>((cent[t][axis] - cmin[axis]) * scale)
                               <= best;
                    });
                mid = static_cast<int>(it - order.begin());
                if (mid == lo || mid == hi) mid = lo + n / 2;
            }
        }

        int left = build_node(lo, mid);
        int right = build_node(mid, hi);
        subtree[me] = 1 + subtree[left] + subtree[right];
        return me;
    }
};

}  // namespace

extern "C" {

// Returns node count (or -1 if capacity exceeded). Arrays:
//   bbox_min/bbox_max: max_nodes*3 floats
//   first/count/miss:  max_nodes ints
//   order:             n_tris ints (triangle permutation, leaf-contiguous)
int rls_build_bvh(const float* v0, const float* e1, const float* e2,
                  int n_tris, int leaf_size, int n_bins,
                  float* bbox_min, float* bbox_max,
                  int* first, int* count, int* miss, int* order,
                  int max_nodes) {
    Builder b;
    b.v0 = v0;
    b.e1 = e1;
    b.e2 = e2;
    b.leaf_size = leaf_size;
    b.n_bins = n_bins;
    b.tri_box.resize(n_tris);
    b.cent.resize(n_tris);
    b.order.resize(n_tris);
    for (int i = 0; i < n_tris; ++i) {
        Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
        Vec3 p1{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
        Vec3 p2{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
        Box box;
        box.lo = a.min(p1).min(p2);
        box.hi = a.max(p1).max(p2);
        b.tri_box[i] = box;
        b.cent[i] = {(box.lo.x + box.hi.x) * 0.5f, (box.lo.y + box.hi.y) * 0.5f,
                     (box.lo.z + box.hi.z) * 0.5f};
        b.order[i] = i;
    }
    b.build_node(0, n_tris);

    int n_nodes = static_cast<int>(b.first.size());
    if (n_nodes > max_nodes) return -1;
    std::memcpy(bbox_min, b.bmin.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(bbox_max, b.bmax.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(first, b.first.data(), sizeof(int) * n_nodes);
    std::memcpy(count, b.count.data(), sizeof(int) * n_nodes);
    std::memcpy(order, b.order.data(), sizeof(int) * n_tris);
    for (int i = 0; i < n_nodes; ++i) miss[i] = i + b.subtree[i];
    return n_nodes;
}
}
