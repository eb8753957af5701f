// rng.cu's three entry points as loops on the host, over rng.cuh's same
// per-element functions: built by g++ (accel/native.build) for the CPU
// tests, which hold every element to core/rng.py's int64 tensor code where
// no card and no nvcc exist. Arguments as rng.cu's, less the stream.
#include "rng.cuh"

extern "C" int rls_rng_threefry(uint32_t k0, uint32_t k1, int64_t n, int mode,
                                int s, int64_t lanes, void* out) {
  for (int64_t e = 0; e < n; ++e) {
    if (mode == rls_rng::kBits) {
      static_cast<int64_t*>(out)[e] =
          rls_rng::bits(k0, k1, static_cast<uint32_t>(e));
    } else {
      static_cast<float*>(out)[e] =
          rls_rng::threefry_value(mode, k0, k1, e, s, lanes);
    }
  }
  return 0;
}

extern "C" int rls_rng_sobol_stream(const void* pix, int pix64,
                                    const void* aa, int aa64, int64_t n,
                                    int s, int layout, uint32_t key,
                                    void* out) {
  for (int64_t r = 0; r < n * s; ++r) {
    rls_rng::sobol_stream_row(pix, pix64, aa, aa64, n, s, layout, key, r,
                              static_cast<float*>(out) + 2 * r);
  }
  return 0;
}

extern "C" int rls_rng_sobol_at(const void* pix, int pix64, const void* idx,
                                int idx64, const int64_t* purposes,
                                int64_t n, int k, uint32_t key, int seeded,
                                void* out) {
  for (int64_t r = 0; r < n * k; ++r) {
    rls_rng::sobol_at_row(pix, pix64, idx, idx64, purposes, k, key, seeded,
                          r, static_cast<float*>(out) + 2 * r);
  }
  return 0;
}
