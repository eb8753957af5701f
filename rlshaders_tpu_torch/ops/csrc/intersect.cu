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
// Tables (packed once per Accel by ops/intersect.py::pack). A node is one
// 32-byte record of two 16-byte words, (bmin.xyz, code) and (bmax.xyz,
// miss), where code is -1 for an inner node and first << 3 | count for a
// leaf. A triangle slot is one 48-byte record, (v0.xyz, id), (e1.xyz, vis),
// (e2.xyz, opaque). Every read of a record is a 16-byte load.
//
// Paths, chosen per Accel by table size (ops/intersect.py::table_path):
//   shared  both tables staged into shared memory, once per block;
//   global  both read from global memory through the read-only cache.
// A block stages lazily: the first of its warps that has a live ray issues
// one TMA bulk copy per table, completing on an mbarrier, and each warp
// with a live ray waits on that barrier. A block whose rays are all dead
// never stages, and a warp whose rays are all dead never waits.
//
// What bounds it on an H100, and what the design does about it: a launch
// lasts as long as its slowest warps, and a warp as long as the longest
// walk among its lanes, a chain of dependent loads and slab tests (up to
// hundreds of steps for a ray that starts inside the glass sphere); not
// the launch's bytes or operations (the glass launches run at a few
// percent of their byte bound; PERF.md). So:
//   - one ray a lane, 512 lanes a block, a grid of all the rays: the
//     block scheduler hands a finished block's place to the next block,
//     which beat a grid of resident blocks looping over shares of the rays
//     and warps compacting their live rays (PERF.md);
//   - dead lanes answer at once; a warp with no live lane exits;
//   - a lane postpones a hit leaf's triangle tests until the other lanes
//     of its warp have reached a leaf or the end (the while-while walk of
//     Aila and Laine, 2009, in skip-link form), so a warp does not pay a
//     leaf on nearly every step; reciprocals are __frcp_rn, which rounds
//     as the division it replaces;
//   - any-hit: a warp with few live rays splits each ray's walk over the
//     subtrees of the tree's cut (ops/intersect.py::pack) among its idle
//     lanes and ORs their answers. With t_max fixed, whether a node's box
//     is hit does not depend on the order of the walk, and a child's box
//     lies inside its parent's (also in float32), so the triangles tested
//     are the plain walk's and the answer is the same;
//   - the tables sit in shared memory where they fit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kThreads = 512;
constexpr int kSplitMax = 8;  // any-hit: most live rays a warp splits

enum Path : int { kGlobal = 0, kShared = 1 };

struct Query {
  const int4* nodes;  // 2 words per node
  const int4* tris;   // 3 words per triangle slot
  const int* cut;     // roots of subtrees that partition the tree, DFS order
  int n_nodes;
  int n_tris;
  int n_cut;
  const float* o;      // (n, 3)
  const float* d;      // (n, 3)
  const float* t_max;  // (n,)
  const int* exclude;  // (n,)
  int n;
  int vis_mask;
  float t_eps;
  void* out;  // nearest: (4, n) floats t, tri (int bits), u, v; any-hit: n bytes
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int excl;
};

template <bool kShared>
__device__ __forceinline__ int4 word(const int4* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

__device__ __forceinline__ float fl(int bits) { return __int_as_float(bits); }

// 1 / d rounded to nearest, as the plain version's division
__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) > 1e-12f ? __frcp_rn(d) : 1e12f;
}

__device__ __forceinline__ bool box_hit(int4 lo, int4 hi, const Ray& r,
                                        float t_best) {
  float t0x = (fl(lo.x) - r.ox) * r.ix, t1x = (fl(hi.x) - r.ox) * r.ix;
  float t0y = (fl(lo.y) - r.oy) * r.iy, t1y = (fl(hi.y) - r.oy) * r.iy;
  float t0z = (fl(lo.z) - r.oz) * r.iz, t1z = (fl(hi.z) - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tf >= fmaxf(tn, 0.0f) && tn < t_best;
}

// Moller-Trumbore in the plain version's order of operations; a = (v0, id),
// b = (e1, vis), c = (e2, opaque). Returns whether the triangle passes the
// rules other than t < t_best, which the caller tests against its best.
__device__ __forceinline__ bool tri_test(int4 a, int4 b, int4 c, const Ray& r,
                                         int vis_mask, float t_eps,
                                         float* t_hit, float* u_hit,
                                         float* v_hit) {
  float px = r.dy * fl(c.z) - r.dz * fl(c.y);
  float py = r.dz * fl(c.x) - r.dx * fl(c.z);
  float pz = r.dx * fl(c.y) - r.dy * fl(c.x);
  float det = fl(b.x) * px + fl(b.y) * py + fl(b.z) * pz;
  float inv = __frcp_rn(det);
  float tx = r.ox - fl(a.x), ty = r.oy - fl(a.y), tz = r.oz - fl(a.z);
  float u = (tx * px + ty * py + tz * pz) * inv;
  float qx = ty * fl(b.z) - tz * fl(b.y);
  float qy = tz * fl(b.x) - tx * fl(b.z);
  float qz = tx * fl(b.y) - ty * fl(b.x);
  float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  float t = (fl(c.x) * qx + fl(c.y) * qy + fl(c.z) * qz) * inv;
  *t_hit = t;
  *u_hit = u;
  *v_hit = v;
  return fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t > t_eps && a.w != r.excl && (b.w & vis_mask) != 0;
}

// The walk of one ray over the nodes [node, end): the whole tree, or one
// subtree (its nodes are contiguous in DFS order and their links stay
// inside it). Nearest: updates the best hit and returns false. Any-hit
// (t_best = t_max, fixed): returns true at the first opaque blocker.
// A lane runs slab tests until it reaches a leaf whose box it hits, and
// only then tests that leaf's triangles: the lanes of a warp leave the
// inner loop at different steps and meet after it, so the warp tests its
// lanes' leaves together instead of paying a leaf on nearly every step.
// Each lane still makes its own tests in the plain walk's order.
template <bool kShared, bool kAnyHit>
__device__ __forceinline__ bool walk(const int4* nodes, const int4* tris,
                                     int node, int end, const Ray& r,
                                     int vis_mask, float t_eps, float& t_best,
                                     int& tri, float& ub, float& vb) {
  while (node < end) {
    int leaf = -1;  // the code of the hit leaf to test
    while (node < end) {
      const int4 lo = word<kShared>(nodes + 2 * node);
      const int4 hi = word<kShared>(nodes + 2 * node + 1);
      const bool hit = box_hit(lo, hi, r, t_best);
      if (hit && lo.w < 0) {  // an inner node's left child is node + 1
        node += 1;
        continue;
      }
      node = hi.w;
      if (hit) {
        leaf = lo.w;
        break;
      }
    }
    if (leaf < 0) break;
    const int first = leaf >> 3, stop = first + (leaf & 7);
    for (int s = first; s < stop; ++s) {
      const int4 a = word<kShared>(tris + 3 * s);
      const int4 b = word<kShared>(tris + 3 * s + 1);
      const int4 c = word<kShared>(tris + 3 * s + 2);
      float t, u, v;
      if (tri_test(a, b, c, r, vis_mask, t_eps, &t, &u, &v) && t < t_best) {
        if constexpr (kAnyHit) {
          if (c.w != 0) return true;
        } else {
          t_best = t;
          tri = a.w;
          ub = u;
          vb = v;
        }
      }
    }
  }
  return false;
}

__device__ __forceinline__ Ray load_ray(const Query& q, int i) {
  Ray r;
  r.ox = q.o[3 * i];
  r.oy = q.o[3 * i + 1];
  r.oz = q.o[3 * i + 2];
  r.dx = q.d[3 * i];
  r.dy = q.d[3 * i + 1];
  r.dz = q.d[3 * i + 2];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  r.excl = q.exclude[i];
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_bulk(int4* dst, const int4* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Called by a whole warp with a live ray: the first such warp of the block
// issues the copies of the tables; every caller waits for them.
__device__ __forceinline__ void acquire_tables(const Query& q, int4* s_nodes,
                                               int4* s_tris, uint64_t* bar,
                                               int* issued) {
  if ((threadIdx.x & 31) == 0 && atomicCAS(issued, 0, 1) == 0) {
    const uint32_t nb = 32u * q.n_nodes;
    const uint32_t tb = 48u * q.n_tris;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(nb + tb)
        : "memory");
    if (nb) copy_bulk(s_nodes, q.nodes, nb, bar);
    if (tb) copy_bulk(s_tris, q.tris, tb, bar);
  }
  __syncwarp();
  uint32_t done = 0;
  const uint32_t phase = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// Any-hit for a warp with few live rays (mask `live`, at most kSplitMax):
// lane groups of `width` lanes, one per live ray, each lane of a group
// walking every width-th subtree of the cut; each live lane writes the OR
// of its group.
template <bool kShared>
__device__ __forceinline__ void occluded_split(const Query& q,
                                               const int4* nodes,
                                               const int4* tris,
                                               unsigned live, int base) {
  const int lane = threadIdx.x & 31;
  const int n_live = __popc(live);
  const int width = 1 << (31 - __clz(32 / n_live));  // a power of two
  const int g = lane / width, j = lane % width;
  bool blocked = false;
  if (g < n_live) {
    unsigned m = live;
    for (int k = 0; k < g; ++k) m &= m - 1;
    const int i = base + __ffs(m) - 1;
    const Ray r = load_ray(q, i);
    float t_best = q.t_max[i];
    int tri = -1;
    float ub = 0.0f, vb = 0.0f;
    for (int c = j; c < q.n_cut && !blocked; c += width) {
      const int root = __ldg(q.cut + c);
      const int end = word<kShared>(nodes + 2 * root + 1).w;
      blocked = walk<kShared, true>(
          nodes, tris, root, end, r, q.vis_mask, q.t_eps, t_best, tri, ub,
          vb);
    }
  }
  const unsigned votes = __ballot_sync(0xffffffffu, blocked);
  if ((live >> lane) & 1u) {
    const int g_mine = __popc(live & ((1u << lane) - 1u));
    const unsigned group = width == 32 ? 0xffffffffu : (1u << width) - 1u;
    static_cast<uint8_t*>(q.out)[base + lane] =
        ((votes >> (g_mine * width)) & group) != 0u ? 1 : 0;
  }
}

template <int kPath, bool kAnyHit>
__device__ __forceinline__ void run(const Query& q) {
  constexpr bool kStaged = kPath == kShared;
  extern __shared__ int4 smem[];
  __shared__ uint64_t bar;
  __shared__ int issued;
  int4* s_nodes = smem;
  int4* s_tris = s_nodes + 2 * q.n_nodes;
  const int4* nodes = kStaged ? s_nodes : q.nodes;
  const int4* tris = kStaged ? s_tris : q.tris;
  if constexpr (kStaged) {
    if (threadIdx.x == 0) {
      issued = 0;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&bar))
                   : "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kThreads + (threadIdx.x - lane);
  const int i = base + lane;
  float tm = 0.0f;
  if (i < q.n) tm = q.t_max[i];
  const bool live = tm > 0.0f;
  if (i < q.n && !live) {  // a dead lane misses without walking
    if constexpr (kAnyHit) {
      static_cast<uint8_t*>(q.out)[i] = 0;
    } else {
      float* out = static_cast<float*>(q.out);
      out[i] = fminf(tm, 1e30f);
      reinterpret_cast<int*>(out)[q.n + i] = -1;
      out[2 * q.n + i] = 0.0f;
      out[3 * q.n + i] = 0.0f;
    }
  }
  const unsigned lives = __ballot_sync(0xffffffffu, live);
  if (lives == 0u) return;
  if constexpr (kStaged) acquire_tables(q, s_nodes, s_tris, &bar, &issued);
  if constexpr (kAnyHit) {
    if (__popc(lives) <= kSplitMax) {
      occluded_split<kStaged>(q, nodes, tris, lives, base);
      return;
    }
  }
  if (!live) return;
  const Ray r = load_ray(q, i);
  float t_best = kAnyHit ? tm : fminf(tm, 1e30f);
  int tri = -1;
  float ub = 0.0f, vb = 0.0f;
  const bool blocked = walk<kStaged, kAnyHit>(
      nodes, tris, 0, q.n_nodes, r, q.vis_mask, q.t_eps, t_best, tri, ub, vb);
  if constexpr (kAnyHit) {
    static_cast<uint8_t*>(q.out)[i] = blocked ? 1 : 0;
  } else {
    float* out = static_cast<float*>(q.out);
    out[i] = t_best;
    reinterpret_cast<int*>(out)[q.n + i] = tri;
    out[2 * q.n + i] = ub;
    out[3 * q.n + i] = vb;
  }
}

template <int kPath>
__global__ void __launch_bounds__(kThreads) nearest_kernel(Query q) {
  run<kPath, false>(q);
}

template <int kPath>
__global__ void __launch_bounds__(kThreads) occluded_kernel(Query q) {
  run<kPath, true>(q);
}

template <bool kAnyHit>
const void* kernel_for(int path) {
  switch (path) {
#define RLS_CASE(P)                                                   \
  case P:                                                             \
    return kAnyHit ? reinterpret_cast<const void*>(occluded_kernel<P>) \
                   : reinterpret_cast<const void*>(nearest_kernel<P>);
    RLS_CASE(kGlobal)
    RLS_CASE(kShared)
#undef RLS_CASE
    default:
      return nullptr;
  }
}

// The first launch of a kernel on a device opts it in to the device's
// largest dynamic shared memory (remembered per device and kernel). Whether
// the tables fit is decided once, by ops/intersect.py::table_path; a launch
// that asks for more than the device gives fails with its CUDA error.
cudaError_t opt_in(const void* fn) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({dev, fn})) return cudaSuccess;
  cudaFuncAttributes attr;
  int optin;
  if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(fn,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin - (int)attr.sharedSizeBytes)) !=
      cudaSuccess)
    return err;
  done.insert({dev, fn});
  return cudaSuccess;
}

template <bool kAnyHit>
int launch(int path, Query q, void* stream) {
  if (q.n <= 0) return 0;
  const void* fn = kernel_for<kAnyHit>(path);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = path == kShared ? 32 * q.n_nodes + 48 * q.n_tris : 0;
  cudaError_t err = smem > 0 ? opt_in(fn) : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&q};
  err = cudaLaunchKernel(fn, dim3((q.n + kThreads - 1) / kThreads),
                         dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

Query make_query(const void* nodes, const void* tris, const int* cut,
                 int n_nodes, int n_tris, int n_cut, const float* o,
                 const float* d, const float* t_max, const int* exclude,
                 int n_rays, int vis_mask, float t_eps, void* out) {
  Query q;
  q.nodes = static_cast<const int4*>(nodes);
  q.tris = static_cast<const int4*>(tris);
  q.cut = cut;
  q.n_nodes = n_nodes;
  q.n_tris = n_tris;
  q.n_cut = n_cut;
  q.o = o;
  q.d = d;
  q.t_max = t_max;
  q.exclude = exclude;
  q.n = n_rays;
  q.vis_mask = vis_mask;
  q.t_eps = t_eps;
  q.out = out;
  return q;
}

}  // namespace

// Plain C entry points (bound with ctypes). `nodes` and `tris` are the
// packed tables, 16-byte aligned, and `cut` the n_cut subtree roots that
// partition the tree; `path` is a Path code. Each launches on `stream`
// and returns the launch's CUDA error; 0 means it was accepted.
extern "C" int rls_nearest(const void* nodes, const void* tris,
                           const int* cut, int n_nodes, int n_tris,
                           int n_cut, int path, const float* o,
                           const float* d, const float* t_max,
                           const int* exclude, int n_rays, int vis_mask,
                           float t_eps, float* out, void* stream) {
  return launch<false>(
      path,
      make_query(nodes, tris, cut, n_nodes, n_tris, n_cut, o, d, t_max,
                 exclude, n_rays, vis_mask, t_eps, out),
      stream);
}

extern "C" int rls_occluded(const void* nodes, const void* tris,
                            const int* cut, int n_nodes, int n_tris,
                            int n_cut, int path, const float* o,
                            const float* d, const float* t_max,
                            const int* exclude, int n_rays, int vis_mask,
                            float t_eps, uint8_t* blocked_out, void* stream) {
  return launch<true>(
      path,
      make_query(nodes, tris, cut, n_nodes, n_tris, n_cut, o, d, t_max,
                 exclude, n_rays, vis_mask, t_eps, blocked_out),
      stream);
}
