// The arithmetic of the port's random draws (core/rng.py) on uint32 words,
// one output element at a time. Plain C++: nvcc compiles it into rng.cu's
// kernels, and g++ into the host library the CPU tests hold to core/rng.py's
// int64 tensor code (rng_host.cpp). The two compilers must give the same
// bits, so every float step is one IEEE operation in float32 (no fused
// multiply-add: nvcc builds with -fmad=false, g++ with -ffp-contract=off).
//
// Element e of a draw is a pure function of its key or pixel, purpose, salt
// and e: no element reads another's result.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define RLS_HD __host__ __device__ __forceinline__
#else
#define RLS_HD inline
#endif

namespace rls_rng {

// ---------------------------------------------------------------------------
// threefry2x32 (jax._src.prng._threefry2x32_lowering), 20 rounds
// ---------------------------------------------------------------------------

RLS_HD uint32_t rotl(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

RLS_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                         uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.bits: the xor of the two hash words of the counter pair (0, j)
RLS_HD uint32_t bits(uint32_t k0, uint32_t k1, uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

RLS_HD float as_float(uint32_t w) {
  float f;
  memcpy(&f, &w, sizeof f);
  return f;
}

// jax.random.uniform on [0, 1): the top 23 bits as the mantissa of a float
// in [1, 2), minus one (exact), clamped at 0
RLS_HD float unit_float(uint32_t b) {
  const float f = as_float((b >> 9) | 0x3F800000u) - 1.0f;
  return f < 0.0f ? 0.0f : f;
}

// Stratum k of s x s, plane c (0: k % s, 1: k / s), jittered by u, over s:
// core/rng.py's (base + jitter) / s, an IEEE add and division
RLS_HD float stratified(int64_t k, int c, int s, float u) {
  const int64_t base = c == 0 ? k % s : k / s;
  return (static_cast<float>(base) + u) / static_cast<float>(s);
}

// Element e of a threefry draw, by mode:
//   kBits:    bits(e) (the uint32 word)
//   kUniform: uniform(e)
//   kStratBatch: stratified2's (..., s*s, 2) layout, stratum (e / 2) % s^2
//   kStratFlat:  stratified2_flat's (s*s, lanes, 2) layout, stratum
//                e / (2 lanes)
enum Mode { kBits = 0, kUniform = 1, kStratBatch = 2, kStratFlat = 3 };

RLS_HD float threefry_value(int mode, uint32_t k0, uint32_t k1, int64_t e,
                            int s, int64_t lanes) {
  const float u = unit_float(bits(k0, k1, static_cast<uint32_t>(e)));
  if (mode == kUniform) return u;
  const int64_t k = mode == kStratBatch ? (e >> 1) % (int64_t(s) * s)
                                        : e / (2 * lanes);
  return stratified(k, static_cast<int>(e & 1), s, u);
}

// ---------------------------------------------------------------------------
// Owen-scrambled Sobol (0,2) points
// ---------------------------------------------------------------------------

// lowbias32 integer hash
RLS_HD uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

RLS_HD uint32_t reverse32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __brev(x);
#else
  x = ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
#endif
}

// Laine-Karras hash permutation: an Owen scramble in reversed-bit order
RLS_HD uint32_t lk_permute(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

RLS_HD uint32_t owen(uint32_t x, uint32_t seed) {
  return reverse32(lk_permute(reverse32(x), seed));
}

// The second Sobol dimension, MSB-aligned: only the low 16 bits of the
// index count, as in core/rng.py's _sobol_d1
RLS_HD uint32_t sobol_d1(uint32_t idx) {
  uint32_t y = 0u, v = 0x80000000u;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if ((idx >> b) & 1u) y ^= v;
    v ^= v >> 1;
  }
  return y;
}

// 24 mantissa-exact bits; [0, 1); the product by 2^-24 is exact
RLS_HD float to_unit(uint32_t x) {
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

// core/rng.py's sobol2 of one index under one scramble seed
RLS_HD void sobol2(uint32_t idx, uint32_t seed, float* out) {
  const uint32_t sx = hash_u32(seed);
  const uint32_t sy = hash_u32(seed ^ 0x9E3779B9u);
  out[0] = to_unit(owen(reverse32(idx), sx));
  out[1] = to_unit(owen(sobol_d1(idx), sy));
}

// A lane's word of an int32 or int64 tensor, as uint32 (mod 2^32)
RLS_HD uint32_t word(const void* p, int is64, int64_t i) {
  return is64 ? static_cast<uint32_t>(static_cast<const int64_t*>(p)[i])
              : static_cast<uint32_t>(static_cast<const int32_t*>(p)[i]);
}

RLS_HD int64_t wide(const void* p, int is64, int64_t i) {
  return is64 ? static_cast<const int64_t*>(p)[i]
              : static_cast<int64_t>(static_cast<const int32_t*>(p)[i]);
}

// Row r of sobol2_flat (layout 0, COLUMN-major: r = c * n + i) or
// sobol2_rep (layout 1, LANE-major: r = i * s + c): lane i's c-th sample,
// index aa[i] * s + c in the stream of pixel pix[i] under
// key = lowbias32(purpose) ^ salt
RLS_HD void sobol_stream_row(const void* pix, int pix64, const void* aa,
                             int aa64, int64_t n, int s, int layout,
                             uint32_t key, int64_t r, float* out) {
  const int64_t i = layout == 0 ? r % n : r / s;
  const int64_t c = layout == 0 ? r / n : r % s;
  const uint32_t idx = static_cast<uint32_t>(wide(aa, aa64, i) * s + c);
  sobol2(idx, hash_u32(word(pix, pix64, i) ^ key), out);
}

// Row r = i * k + j of sobol2_at (lane i, column j of k): index idx[i] in
// the stream of pixel pix[i] and purpose purposes[j] (or, with no
// purposes, key = lowbias32(purpose) ^ salt); with `seeded`, pix holds the
// scramble seeds themselves (sobol2)
RLS_HD void sobol_at_row(const void* pix, int pix64, const void* idx,
                         int idx64, const int64_t* purposes, int k,
                         uint32_t key, int seeded, int64_t r, float* out) {
  const int64_t i = r / k;
  const uint32_t p = word(pix, pix64, i);
  uint32_t seed = p;
  if (!seeded) {
    const uint32_t h =
        purposes ? hash_u32(static_cast<uint32_t>(purposes[r % k])) ^ key
                 : key;
    seed = hash_u32(p ^ h);
  }
  sobol2(word(idx, idx64, i), seed, out);
}

}  // namespace rls_rng
