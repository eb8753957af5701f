// Ray queries over the skip-link BVH: closest hit and any-hit shadow test.
//
// Replaces the two TPU kernels of rlshaders_tpu/ops/intersect_pallas.py:
//   rls_nearest  <- _nearest_kernel  (driven by _intersect / intersect)
//   rls_occluded <- _occluded_kernel (driven by _occluded / occluded)
// Both are written from what those kernels compute, not from their block
// structure: the TPU version tests every ray of a block against every
// triangle of a pre-culled 128-triangle cluster, because the TPU can neither
// chase pointers nor gather cheaply. Here one thread walks one ray down the
// skip-link BVH of rlshaders_tpu_torch/accel/bvh.py, with one int of state
// and no stack: an AABB hit on an inner node goes to node+1, a miss or a
// finished leaf jumps to the node's miss link.
//
// Hit rules (the same as the plain walk in accel/bvh.py, operation for
// operation; build with -fmad=false so that no multiply-add is fused and the
// float results equal the plain version's):
//   |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, t > t_eps, t < current best,
//   (vis & vis_mask) != 0, original id != exclude_tri;
//   occluded additionally needs opaque != 0 and t < t_max.
// Ties: a triangle replaces the best only at a strictly smaller t, so among
// equal-t hits the first met in the walk wins (the TPU kernel kept the
// largest id instead). A miss reports t = min(t_max, 1e30) and tri = -1.
// Lanes with t_max <= 0 are dead and miss without walking.
//
// What bounds it on an H100: each visited node and each tested triangle is a
// dependent load from global memory (through L1/L2), so a thread waits on
// memory latency, not on arithmetic or bandwidth, and neighbouring threads
// diverge as their rays take different paths. The simple design does nothing
// about it yet: no ray sorting, no shared-memory copy of the tree's top, no
// wide nodes. The trees of the ported scenes are small enough to stay in L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Tree {
  const float* bmin;    // (N, 3)
  const float* bmax;    // (N, 3)
  const int* first;     // (N,) leaf: first slot; inner: -1
  const int* count;     // (N,)
  const int* miss;      // (N,)
  const int* order;     // (T,) slot -> original triangle id
  const float* v0;      // (T, 3) slot order
  const float* e1;      // (T, 3)
  const float* e2;      // (T, 3)
  const int* vis;       // (T,)
  const uint8_t* opaque;  // (T,) bool
  int n_nodes;
};

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

__device__ __forceinline__ bool box_hit(const Tree& tr, int node, float ox,
                                        float oy, float oz, float ix, float iy,
                                        float iz, float t_best) {
  const float* lo = tr.bmin + 3 * node;
  const float* hi = tr.bmax + 3 * node;
  float t0x = (lo[0] - ox) * ix, t1x = (hi[0] - ox) * ix;
  float t0y = (lo[1] - oy) * iy, t1y = (hi[1] - oy) * iy;
  float t0z = (lo[2] - oz) * iz, t1z = (hi[2] - oz) * iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tf >= fmaxf(tn, 0.0f) && tn < t_best;
}

// Moller-Trumbore in the plain version's order of operations.
__device__ __forceinline__ bool tri_test(const Tree& tr, int s, float ox,
                                         float oy, float oz, float dx,
                                         float dy, float dz, float t_eps,
                                         float t_best, float* t_hit,
                                         float* u_hit, float* v_hit) {
  const float* a = tr.v0 + 3 * s;
  const float* b = tr.e1 + 3 * s;
  const float* c = tr.e2 + 3 * s;
  float px = dy * c[2] - dz * c[1];
  float py = dz * c[0] - dx * c[2];
  float pz = dx * c[1] - dy * c[0];
  float det = b[0] * px + b[1] * py + b[2] * pz;
  if (!(fabsf(det) > 1e-12f)) return false;
  float inv = 1.0f / det;
  float tx = ox - a[0], ty = oy - a[1], tz = oz - a[2];
  float u = (tx * px + ty * py + tz * pz) * inv;
  float qx = ty * b[2] - tz * b[1];
  float qy = tz * b[0] - tx * b[2];
  float qz = tx * b[1] - ty * b[0];
  float v = (dx * qx + dy * qy + dz * qz) * inv;
  float t = (c[0] * qx + c[1] * qy + c[2] * qz) * inv;
  *t_hit = t;
  *u_hit = u;
  *v_hit = v;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_eps && t < t_best;
}

__global__ void nearest_kernel(Tree tr, const float* __restrict__ o,
                               const float* __restrict__ d,
                               const float* __restrict__ t_max,
                               const int* __restrict__ exclude, int n_rays,
                               int vis_mask, float t_eps,
                               float* __restrict__ t_out,
                               int* __restrict__ tri_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float tm = t_max[r];
  float t_best = fminf(tm, 1e30f);
  int tri = -1;
  float ub = 0.0f, vb = 0.0f;
  if (tm > 0.0f) {
    float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    int excl = exclude[r];
    int node = 0;
    while (node < tr.n_nodes) {
      bool hit = box_hit(tr, node, ox, oy, oz, ix, iy, iz, t_best);
      int first = tr.first[node];
      if (hit && first < 0) {
        node += 1;
        continue;
      }
      if (hit) {
        int cnt = tr.count[node];
        for (int s = first; s < first + cnt; ++s) {
          float t, u, v;
          if (tri_test(tr, s, ox, oy, oz, dx, dy, dz, t_eps, t_best, &t, &u,
                       &v) &&
              tr.order[s] != excl && (tr.vis[s] & vis_mask) != 0) {
            t_best = t;
            tri = tr.order[s];
            ub = u;
            vb = v;
          }
        }
      }
      node = tr.miss[node];
    }
  }
  t_out[r] = t_best;
  tri_out[r] = tri;
  u_out[r] = ub;
  v_out[r] = vb;
}

__global__ void occluded_kernel(Tree tr, const float* __restrict__ o,
                                const float* __restrict__ d,
                                const float* __restrict__ t_max,
                                const int* __restrict__ exclude, int n_rays,
                                int vis_mask, float t_eps,
                                uint8_t* __restrict__ blocked_out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float tm = t_max[r];
  uint8_t blocked = 0;
  if (tm > 0.0f) {
    float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    int excl = exclude[r];
    int node = 0;
    while (node < tr.n_nodes && !blocked) {
      bool hit = box_hit(tr, node, ox, oy, oz, ix, iy, iz, tm);
      int first = tr.first[node];
      if (hit && first < 0) {
        node += 1;
        continue;
      }
      if (hit) {
        int cnt = tr.count[node];
        for (int s = first; s < first + cnt; ++s) {
          float t, u, v;
          if (tri_test(tr, s, ox, oy, oz, dx, dy, dz, t_eps, tm, &t, &u,
                       &v) &&
              tr.opaque[s] && tr.order[s] != excl &&
              (tr.vis[s] & vis_mask) != 0) {
            blocked = 1;
            break;
          }
        }
      }
      node = tr.miss[node];
    }
  }
  blocked_out[r] = blocked;
}

constexpr int kThreads = 128;

Tree make_tree(const float* bmin, const float* bmax, const int* first,
               const int* count, const int* miss, const int* order,
               const float* v0, const float* e1, const float* e2,
               const int* vis, const uint8_t* opaque, int n_nodes) {
  Tree tr;
  tr.bmin = bmin;
  tr.bmax = bmax;
  tr.first = first;
  tr.count = count;
  tr.miss = miss;
  tr.order = order;
  tr.v0 = v0;
  tr.e1 = e1;
  tr.e2 = e2;
  tr.vis = vis;
  tr.opaque = opaque;
  tr.n_nodes = n_nodes;
  return tr;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns cudaGetLastError() of the launch; 0 means it was accepted.
extern "C" int rls_nearest(const float* bmin, const float* bmax,
                           const int* first, const int* count,
                           const int* miss, const int* order, const float* v0,
                           const float* e1, const float* e2, const int* vis,
                           const uint8_t* opaque, int n_nodes, const float* o,
                           const float* d, const float* t_max,
                           const int* exclude, int n_rays, int vis_mask,
                           float t_eps, float* t_out, int* tri_out,
                           float* u_out, float* v_out, void* stream) {
  if (n_rays <= 0) return 0;
  Tree tr = make_tree(bmin, bmax, first, count, miss, order, v0, e1, e2, vis,
                      opaque, n_nodes);
  int blocks = (n_rays + kThreads - 1) / kThreads;
  nearest_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tr, o, d, t_max, exclude, n_rays, vis_mask, t_eps, t_out, tri_out,
      u_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int rls_occluded(const float* bmin, const float* bmax,
                            const int* first, const int* count,
                            const int* miss, const int* order,
                            const float* v0, const float* e1, const float* e2,
                            const int* vis, const uint8_t* opaque, int n_nodes,
                            const float* o, const float* d,
                            const float* t_max, const int* exclude,
                            int n_rays, int vis_mask, float t_eps,
                            uint8_t* blocked_out, void* stream) {
  if (n_rays <= 0) return 0;
  Tree tr = make_tree(bmin, bmax, first, count, miss, order, v0, e1, e2, vis,
                      opaque, n_nodes);
  int blocks = (n_rays + kThreads - 1) / kThreads;
  occluded_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tr, o, d, t_max, exclude, n_rays, vis_mask, t_eps, blocked_out);
  return (int)cudaGetLastError();
}
