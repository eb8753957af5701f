// The port's random draws (core/rng.py) as CUDA kernels: one launch a draw,
// one thread an output element (a float, or a row of two for the Sobol
// points), every word a uint32 in registers.
//
// They replace no TPU kernel: the JAX package leaves its draws to XLA,
// which fuses each into the kernels around it. core/rng.py's int64 tensor
// code, the plain version, runs each step of the hashes as its own
// elementwise kernel over 8-byte words in device memory, some 170 launches
// a threefry draw and 360 a Sobol draw. Here only the lanes' int32 or int64
// inputs are read and the float32 outputs written: the bound is those
// bytes at 3.35 TB/s, about 70 integer operations a threefry value and 60
// a Sobol row sit far below the card's integer rate.
//
// Built with -fmad=false and nvcc's IEEE division, so every element equals
// core/rng.py's on the CPU bit for bit (rng.cuh's float steps are single
// IEEE operations). Each entry point launches on `stream`, makes no launch
// for an empty draw and returns the launch's CUDA error; 0 means accepted.
#include <cuda_runtime.h>

#include "rng.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void threefry_kernel(uint32_t k0, uint32_t k1, int64_t n,
                                int mode, int s, int64_t lanes, void* out) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (e >= n) return;
  if (mode == rls_rng::kBits) {
    static_cast<int64_t*>(out)[e] =
        rls_rng::bits(k0, k1, static_cast<uint32_t>(e));
  } else {
    static_cast<float*>(out)[e] =
        rls_rng::threefry_value(mode, k0, k1, e, s, lanes);
  }
}

__global__ void sobol_stream_kernel(const void* pix, int pix64,
                                    const void* aa, int aa64, int64_t n,
                                    int s, int layout, uint32_t key,
                                    float2* out) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (r >= n * s) return;
  float v[2];
  rls_rng::sobol_stream_row(pix, pix64, aa, aa64, n, s, layout, key, r, v);
  out[r] = make_float2(v[0], v[1]);
}

__global__ void sobol_at_kernel(const void* pix, int pix64, const void* idx,
                                int idx64, const int64_t* purposes,
                                int64_t n, int k, uint32_t key, int seeded,
                                float2* out) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (r >= n * k) return;
  float v[2];
  rls_rng::sobol_at_row(pix, pix64, idx, idx64, purposes, k, key, seeded, r,
                        v);
  out[r] = make_float2(v[0], v[1]);
}

dim3 blocks(int64_t n) { return dim3((n + kThreads - 1) / kThreads); }

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// n elements of a threefry draw under key (k0, k1), by rls_rng::Mode: int64
// words (kBits) or float32 values; s strata a side and `lanes` for the
// stratified layouts.
extern "C" int rls_rng_threefry(uint32_t k0, uint32_t k1, int64_t n, int mode,
                                int s, int64_t lanes, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  threefry_kernel<<<blocks(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(k0, k1, n, mode, s,
                                                         lanes, out);
  return last_error();
}

// n * s rows (float2) of sobol2_flat (layout 0) or sobol2_rep (layout 1);
// pix and aa are int32 or int64 (pix64, aa64); key = lowbias32(purpose) ^
// salt.
extern "C" int rls_rng_sobol_stream(const void* pix, int pix64,
                                    const void* aa, int aa64, int64_t n,
                                    int s, int layout, uint32_t key,
                                    void* out, void* stream) {
  if (n <= 0 || s <= 0) return 0;
  sobol_stream_kernel<<<blocks(n * s), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pix, pix64, aa, aa64, n, s, layout, key, static_cast<float2*>(out));
  return last_error();
}

// n * k rows (float2) of sobol2_at (k purposes a lane, or k = 1 and key =
// lowbias32(purpose) ^ salt) or, with `seeded`, of sobol2 (pix = seeds).
extern "C" int rls_rng_sobol_at(const void* pix, int pix64, const void* idx,
                                int idx64, const int64_t* purposes,
                                int64_t n, int k, uint32_t key, int seeded,
                                void* out, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  sobol_at_kernel<<<blocks(n * k), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      pix, pix64, idx, idx64, purposes, n, k, key, seeded,
      static_cast<float2*>(out));
  return last_error();
}
