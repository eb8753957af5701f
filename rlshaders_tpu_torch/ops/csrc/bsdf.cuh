// The arithmetic of the lobes of models/dispatch.py, one lane at a time:
// the five entry points eval_diffuse, sample_diffuse, eval_specular,
// sample_specular and sample_refract over bsdf/ggx.py, beckmann.py,
// orennayar.py and disney.py. Plain C++: nvcc compiles it into bsdf.cu's
// kernels, and g++ into the host library the CPU tests hold to the eager
// torch code (bsdf_host.cpp).
//
// Each lane branches on its material type and evaluates only its own model,
// where the eager code computes every model for every lane and selects.
// Every step is the eager code's, in its order and its rounding, so that a
// lane equals the torch result on the same device:
//   * one IEEE float32 operation a torch op (no fused multiply-add: nvcc
//     builds with -fmad=false, g++ with -ffp-contract=off);
//   * a Python float constant is the float32 torch casts it to, and an
//     expression of constants is folded in double first, as Python does;
//   * `c / t` is torch's `t.reciprocal() * c`, a tensor divided by a Python
//     float is a multiply by the float's reciprocal on the card and a
//     division on the CPU (div_scalar), `torch.rsqrt` is rsqrtf on the card
//     and 1 / sqrt on the CPU (rsqrt);
//   * clamp, clamp_min, maximum and minimum propagate NaN as torch's do.
// The transcendentals (expf, logf, sinf, cosf, tanf, acosf) are the
// platform's: libdevice on the card as torch's kernels reach it, libm on
// the host where torch's CPU kernels use their own vector library.
//
// The lanes' inputs are read through a table of (pointer, stride) pairs in
// the order of `Field`; a null pointer is a part the material table lacks
// (rlSkin's sheen lobe, rlDisney's lobes), a stride of 0 a 0-dim field.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RLS_HD __host__ __device__ __forceinline__
#else
#define RLS_HD inline
#endif

namespace rls_bsdf {

// scene/build.py's material types
constexpr int kSkin = 3;
constexpr int kDisney = 2;

// The lanes' inputs, in the order of ops/bsdf.py's FIELDS.
enum Field {
  kWoX, kWoY, kWoZ, kWiX, kWiY, kWiZ, kRx, kRy,
  kMtype, kFresnelMode, kDist,                        // int32
  kHasDiffuse, kHasSpec, kHasRefract,                 // bool
  kDiffR, kDiffG, kDiffB, kDiffRough,
  kSpecR, kSpecG, kSpecB, kKsn,
  kAx, kAy, kAg, kIorIn, kIorOut,                     // MatG.ggx
  kAx2, kAy2, kAg2, kIorIn2, kIorOut2,                // MatG.ggx2 (rlSkin)
  kSpec2R, kSpec2G, kSpec2B, kSheenLayer,
  kBaseR, kBaseG, kBaseB, kRough, kSubsurface, kMetallic,   // MatG.dsy
  kSheenR, kSheenG, kSheenB, kF0R, kF0G, kF0B, kClearcoat, kGloss,
  kDax, kDay, kDspecRough,
  kKtR, kKtG, kKtB,
  kFields
};

struct Arr {
  const char* p;
  int64_t s;  // elements
};

struct Fields {
  Arr a[kFields];
};

// ---------------------------------------------------------------------------
// constants as Python folds them
// ---------------------------------------------------------------------------

constexpr double kPi = 3.141592653589793;
#define F(x) static_cast<float>(x)

// ---------------------------------------------------------------------------
// torch's elementwise semantics
// ---------------------------------------------------------------------------

RLS_HD float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

RLS_HD float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

RLS_HD float maximum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

RLS_HD float minimum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

RLS_HD float sign(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}

RLS_HD float rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// a tensor over a Python float c
RLS_HD float div_scalar(float x, float c) {
#ifdef __CUDA_ARCH__
  return x * (1.0f / c);
#else
  return x / c;
#endif
}

// ---------------------------------------------------------------------------
// core/vec3.py
// ---------------------------------------------------------------------------

struct V {
  float x, y, z;
};

RLS_HD V add(V a, V b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
RLS_HD V scale(V a, float s) { return {a.x * s, a.y * s, a.z * s}; }
RLS_HD float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
RLS_HD float maxc(V a) { return maximum(a.x, maximum(a.y, a.z)); }

RLS_HD V normalize(V a) {
  const float inv = rsqrt(clamp_min(dot(a, a), 1e-20f));
  return scale(a, inv);
}

// 2(w.n)n - w
RLS_HD V reflect(V w, V n) {
  const float k = 2.0f * dot(w, n);
  return {k * n.x - w.x, k * n.y - w.y, k * n.z - w.z};
}

// ---------------------------------------------------------------------------
// bsdf/ggx.py
// ---------------------------------------------------------------------------

struct Ggx {
  float ax, ay, ag, ior_in, ior_out;
};

constexpr float kGgxEps = 1e-4f;

RLS_HD float d_ggx_aniso(V m, float ax, float ay) {
  const float qx = m.x / ax;
  const float qy = m.y / ay;
  const float t = qx * qx + qy * qy + m.z * m.z;
  const float denom = ax * ay * t * t;
  return (1.0f / clamp_min(denom, 1e-20f)) * F(1.0 / kPi);
}

RLS_HD float smith_g1(V w, V m, float ag) {
  const float wdotn = w.z;
  const bool same_side = dot(w, m) * wdotn > 0.0f;
  const float cos2 = clamp(wdotn * wdotn, 1e-12f, 1.0f);
  const float tan2 = 1.0f / cos2 - 1.0f;
  const float g = (1.0f / (1.0f + sqrtf(1.0f + ag * ag * tan2))) * 2.0f;
  return same_side ? g : 0.0f;
}

RLS_HD float smith_g1_aniso(V w, V m, float ax, float ay) {
  const bool same_side = dot(w, m) * w.z > 0.0f;
  const float axw = ax * w.x;
  const float ayw = ay * w.y;
  const float a2 = axw * axw + ayw * ayw;
  const float g = (1.0f / (1.0f + sqrtf(1.0f + a2 / clamp_min(w.z * w.z,
                                                             1e-12f)))) *
                  2.0f;
  return same_side ? g : 0.0f;
}

RLS_HD float fresnel_dielectric(V i, V m, float ior_in, float ior_out) {
  const float c = fabsf(dot(i, m));
  const float eta = ior_out / ior_in;
  const float g_sqr = eta * eta - 1.0f + c * c;
  if (g_sqr < 0.0f) return 1.0f;  // total internal reflection
  const float g = sqrtf(clamp_min(g_sqr, 0.0f));
  const float gmc = g - c;
  const float gpc = g + c;
  const float a = gmc / (fabsf(gpc) < 1e-12f ? 1e-12f : gpc);
  const float b_den = c * gmc + 1.0f;
  const float b = (c * gpc - 1.0f) / (fabsf(b_den) < 1e-12f ? 1e-12f : b_den);
  return clamp(0.5f * a * a * (1.0f + b * b), 0.0f, 1.0f);
}

struct Slope {
  float x, y;
};

// the isotropic full-NDF slope sample used at normal incidence
RLS_HD Slope sample_slope_uniform(float rx, float ry) {
  const float r = sqrtf(rx / clamp_min(1.0f - rx, 1e-12f));
  const float phi = F(2.0 * kPi) * ry;
  return {r * cosf(phi), r * sinf(phi)};
}

// Slopes of the visible-normal distribution (ggx.sample_slope_tan)
RLS_HD Slope sample_slope_tan(float tan_theta, bool near_normal, float rx,
                              float ry) {
  const float b = clamp_min(tan_theta, 0.0f);
  const float b2 = b * b;
  const float g1 = (1.0f / (1.0f + sqrtf(1.0f + b2))) * 2.0f;
  const float a = 2.0f * rx / clamp_min(g1, 1e-12f) - 1.0f;
  const float a2 = a * a;
  const bool degenerate = fabsf(a2 - 1.0f) < kGgxEps;
  if (near_normal || degenerate) return sample_slope_uniform(rx, ry);
  const float tmp = 1.0f / (a2 - 1.0f);
  const float disc = sqrtf(clamp_min(b2 * tmp * tmp - (a2 - b2) * tmp, 0.0f));
  const float x1 = b * tmp - disc;
  const float x2 = b * tmp + disc;
  const bool use_x1 = (a < 0.0f) || (x2 > 1.0f / clamp_min(b, 1e-12f));
  const float slope_x = use_x1 ? x1 : x2;
  // slope_y via the rational-polynomial fit of the inverse CDF
  const bool flip = ry > 0.5f;
  const float sgn = flip ? 1.0f : -1.0f;
  const float ry2 = flip ? 2.0f * (ry - 0.5f) : 2.0f * (0.5f - ry);
  const float z =
      (ry2 * (ry2 * (ry2 * F(0.27385) - F(0.73369)) + F(0.46341))) /
      (ry2 * (ry2 * (ry2 * F(0.093073) + F(0.309420)) - 1.0f) + F(0.597999));
  return {slope_x, sgn * z * sqrtf(1.0f + slope_x * slope_x)};
}

RLS_HD V sample_vndf(V wo, float ax, float ay, float rx, float ry) {
  const V v = normalize({wo.x * ax, wo.y * ay, wo.z});
  const float vz = clamp(v.z, -1.0f, 1.0f);
  const float sin_t = sqrtf(clamp_min(1.0f - vz * vz, 0.0f));
  const bool on_pole = vz >= F(1.0 - 1e-4);
  const float inv_sin = 1.0f / clamp_min(sin_t, 1e-12f);
  const float cos_phi = on_pole ? 1.0f : v.x * inv_sin;
  const float sin_phi = on_pole ? 0.0f : v.y * inv_sin;
  const float tan_theta = sin_t / clamp_min(fabsf(vz), 1e-12f);
  const Slope sl = sample_slope_tan(tan_theta, on_pole, rx, ry);
  const float mx = -(cos_phi * sl.x - sin_phi * sl.y) * ax;
  const float my = -(sin_phi * sl.x + cos_phi * sl.y) * ay;
  return normalize({mx, my, 1.0f});
}

RLS_HD float ggx_pdf(const Ggx& p, V wo, V wi) {
  const V h = normalize(add(wo, wi));
  const float pdf = d_ggx_aniso(h, p.ax, p.ay) *
                    smith_g1_aniso(wo, h, p.ax, p.ay) /
                    clamp_min(fabsf(wo.z), 1e-12f) * 0.25f;
  return h.z > 0.0f ? clamp_min(pdf, kGgxEps) : kGgxEps;
}

// the half vector of Walter Eq.20, turned to wo's side
RLS_HD V reflection_half(V wo, V wi) {
  float s = sign(wo.z);
  s = s == 0.0f ? 1.0f : s;
  return scale(normalize(add(wo, wi)), s);
}

// G*D/(4 |l.n||v.n|) of Walter Eq.20 (ggx.reflection_parts' second part)
RLS_HD float reflection_gd(const Ggx& p, V wo, V wi, V hr) {
  const float g = smith_g1(wo, hr, p.ag) * smith_g1(wi, hr, p.ag);
  const float d = d_ggx_aniso(hr, p.ax, p.ay);
  return g * d * 0.25f / clamp_min(fabsf(wi.z) * fabsf(wo.z), 1e-12f);
}

RLS_HD float reflection_term(const Ggx& p, V wo, V wi) {
  const V hr = reflection_half(wo, wi);
  return fresnel_dielectric(wo, hr, p.ior_in, p.ior_out) *
         reflection_gd(p, wo, wi, hr);
}

RLS_HD V ggx_sample(const Ggx& p, V wo, float rx, float ry) {
  return reflect(wo, sample_vndf(wo, p.ax, p.ay, rx, ry));
}

struct Refracted {
  V wi;
  float weight;  // Walter Eq.41
};

// ggx.sample_refract
RLS_HD Refracted ggx_sample_refract(const Ggx& p, V wo, float rx, float ry) {
  const V m = sample_vndf(wo, p.ax, p.ay, rx, ry);
  const float eta = p.ior_in / p.ior_out;
  const float idotm = dot(wo, m);
  float s = sign(wo.z);
  s = s == 0.0f ? 1.0f : s;
  const float cos2 = 1.0f - eta * eta * (1.0f - idotm * idotm);
  V wi;
  if (cos2 < 0.0f) {  // total internal reflection: mirror instead
    wi = reflect(wo, m);
  } else {
    const float k = eta * idotm - s * sqrtf(clamp_min(cos2, 0.0f));
    wi = normalize({m.x * k - wo.x * eta, m.y * k - wo.y * eta,
                    m.z * k - wo.z * eta});
  }
  const float g = smith_g1(wo, m, p.ag) * smith_g1(wi, m, p.ag);
  const float den = clamp_min(fabsf(wo.z) * fabsf(m.z), 1e-12f);
  return {wi, g * fabsf(idotm / den)};
}

// ---------------------------------------------------------------------------
// bsdf/beckmann.py
// ---------------------------------------------------------------------------

RLS_HD float d_beckmann(V m, float alpha) {
  if (!(m.z > 0.0f)) return 0.0f;
  const float cos2 = clamp(m.z * m.z, 1e-12f, 1.0f);
  const float a2 = clamp_min(alpha * alpha, 1e-12f);
  return expf((1.0f - 1.0f / cos2) / a2) /
         (F(kPi) * a2 * cos2 * cos2);
}

RLS_HD float beckmann_g1(V w, V m, float alpha) {
  if (!(dot(w, m) * w.z > 0.0f)) return 0.0f;
  const float cosv = clamp(fabsf(w.z), 1e-6f, 1.0f);
  const float tanv = sqrtf(clamp_min(1.0f - cosv * cosv, 0.0f)) / cosv;
  const float a = 1.0f / clamp_min(alpha * tanv, 1e-9f);
  if (!(a < 1.6f)) return 1.0f;
  return (F(3.535) * a + F(2.181) * a * a) /
         (1.0f + F(2.276) * a + F(2.577) * a * a);
}

RLS_HD float beckmann_gd(V wo, V wi, float alpha) {
  const V h = normalize(add(wo, wi));
  const float denom = 4.0f * clamp_min(fabsf(wo.z) * fabsf(wi.z), 1e-9f);
  return d_beckmann(h, alpha) * beckmann_g1(wo, h, alpha) *
         beckmann_g1(wi, h, alpha) / denom;
}

RLS_HD V beckmann_sample(V wo, float alpha, float rx, float ry) {
  const float a2 = clamp_min(alpha * alpha, 1e-12f);
  const float tan2 = -a2 * logf(clamp_min(1.0f - rx, 1e-12f));
  const float cos_t = 1.0f / sqrtf(1.0f + tan2);
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const float phi = F(2.0 * kPi) * ry;
  const V m = {sin_t * cosf(phi), sin_t * sinf(phi), cos_t};
  const float k = 2.0f * dot(wo, m);
  return {m.x * k - wo.x, m.y * k - wo.y, m.z * k - wo.z};
}

RLS_HD float beckmann_pdf(V wo, V wi, float alpha) {
  const V h = normalize(add(wo, wi));
  const float idoth = clamp_min(fabsf(dot(wi, h)), 1e-9f);
  return d_beckmann(h, alpha) * fabsf(h.z) / (4.0f * idoth);
}

// ---------------------------------------------------------------------------
// bsdf/orennayar.py and core/vecmath.py's concentric map
// ---------------------------------------------------------------------------

RLS_HD float orennayar(float rough, V wo, V wi) {
  const float cos_i = wi.z;
  const float cos_o = wo.z;
  if (!(cos_i > 0.0f && cos_o > 0.0f)) return 0.0f;
  const float s2 = rough * rough;
  const float a = 1.0f - 0.5f * s2 / (s2 + F(0.33));
  const float b = F(0.45) * s2 / (s2 + F(0.09));
  const float sin_i = sqrtf(clamp_min(1.0f - cos_i * cos_i, 0.0f));
  const float sin_o = sqrtf(clamp_min(1.0f - cos_o * cos_o, 0.0f));
  float cos_dphi = (sin_i > 1e-6f && sin_o > 1e-6f)
                       ? (wi.x * wo.x + wi.y * wo.y) /
                             clamp_min(sin_i * sin_o, 1e-12f)
                       : 0.0f;
  cos_dphi = clamp(cos_dphi, -1.0f, 1.0f);
  const float sin_alpha = maximum(sin_i, sin_o);
  const float cos_beta = maximum(cos_i, cos_o);
  const float tan_beta = minimum(sin_i, sin_o) / clamp_min(cos_beta, 1e-6f);
  const float alpha = acosf(clamp(minimum(cos_i, cos_o), -1.0f, 1.0f));
  const float beta = acosf(clamp(maximum(cos_i, cos_o), -1.0f, 1.0f));
  // C2: the negative-cos_dphi branch subtracts (2 beta / pi)^3
  const float bp = div_scalar(2.0f * beta, F(kPi));
  const float c2 = cos_dphi >= 0.0f ? b * sin_alpha
                                    : b * (sin_alpha - bp * (bp * bp));
  const float ab = div_scalar(4.0f * alpha * beta, F(kPi * kPi));
  const float c3 = (F(0.125) * s2 / (s2 + F(0.09))) * (ab * ab);
  const float tan_halfsum = tanf(clamp((alpha + beta) * 0.5f, 0.0f, F(1.55)));
  const float f = F(1.0 / kPi) *
                  (a + c2 * cos_dphi * tan_beta +
                   c3 * (1.0f - fabsf(cos_dphi)) * tan_halfsum);
  return clamp_min(f, 0.0f) * cos_i;
}

RLS_HD V cosine_sample(float rx, float ry) {
  const float ox = rx * 2.0f - 1.0f;
  const float oy = ry * 2.0f - 1.0f;
  float x = 0.0f, y = 0.0f;
  if (!(ox == 0.0f && oy == 0.0f)) {
    const bool use_x = fabsf(ox) > fabsf(oy);
    const float safe_ox = ox == 0.0f ? 1.0f : ox;
    const float safe_oy = oy == 0.0f ? 1.0f : oy;
    const float r = use_x ? ox : oy;
    const float phi = use_x ? F(kPi / 4.0) * (oy / safe_ox)
                            : F(kPi / 2.0) * (1.0f - 0.5f * ox / safe_oy);
    x = r * cosf(phi);
    y = r * sinf(phi);
  }
  return {x, y, sqrtf(clamp_min(1.0f - x * x - y * y, 0.0f))};
}

// ---------------------------------------------------------------------------
// bsdf/disney.py (clearcoat always on: at clearcoat 0 it equals the off
// branch)
// ---------------------------------------------------------------------------

struct Disney {
  V base, sheen, f0;
  float rough, subsurface, metallic, clearcoat, gloss, ax, ay, spec_rough;
};

constexpr float kDisneyEps = 1e-7f;

RLS_HD float schlick5(float x) {
  const float s = clamp(1.0f - x, 0.0f, 1.0f);
  const float s2 = s * s;
  return s * (s2 * s2);
}

RLS_HD float d_gtr1(float gloss, float mdotn2) {
  const float alpha = F(0.1) + F(0.001 - 0.1) * gloss;
  const float a2 = alpha * alpha;
  const float denom = logf(a2) * (1.0f + (a2 - 1.0f) * mdotn2);
  return (a2 - 1.0f) * F(1.0 / kPi) / denom;
}

// one division, as disney._over
RLS_HD float d_gtr2_aniso(float ax, float ay, V m, float mdotn2) {
  const float qx = m.x / ax;
  const float qy = m.y / ay;
  const float t = qx * qx + qy * qy + mdotn2;
  const float denom = ax * ay * t * t;
  return F(1.0 / kPi) / clamp_min(denom, 1e-20f);
}

RLS_HD float smith_g_over_2ndotv(float ndotv, float alpha_g) {
  const float a = alpha_g * alpha_g;
  const float b = ndotv * ndotv;
  return 1.0f /
         clamp_min(ndotv + sqrtf(clamp_min(a + b - a * b, 0.0f)), 1e-12f);
}

// disney.eval_diffuse_cos: the reference gates on dot(wo, h) as 'NdotH'
RLS_HD V disney_diffuse_cos(const Disney& p, V wo, V wi) {
  const float ldotn = wi.z;
  const float vdotn = wo.z;
  const V h = normalize(add(wi, wo));
  const float ldoth = dot(wi, h);
  const float ndoth = dot(wo, h);
  const bool valid = ldotn > kDisneyEps && vdotn > kDisneyEps &&
                     ndoth > kDisneyEps && ldoth > kDisneyEps;
  float sc = 0.0f;
  if (valid) {
    const float ldoth2 = ldoth * ldoth;
    const float fl = schlick5(ldotn);
    const float fv = schlick5(vdotn);
    const float f90 = 0.5f + 2.0f * p.rough * ldoth2;
    const float df = (1.0f + (f90 - 1.0f) * fl) * (1.0f + (f90 - 1.0f) * fv);
    const float fss90 = p.rough * ldoth2;
    const float fss =
        (1.0f + (fss90 - 1.0f) * fl) * (1.0f + (fss90 - 1.0f) * fv);
    const float ss =
        1.25f * (fss * (1.0f / clamp_min(ldotn + vdotn, 1e-12f) - 0.5f) +
                 0.5f);
    const float factor = df + (ss - df) * p.subsurface;
    sc = F(1.0 / kPi) * factor * (1.0f - p.metallic);
  }
  return scale(scale(p.base, sc), wi.z);
}

// disney.eval_specular_cos
RLS_HD V disney_specular_cos(const Disney& p, V wo, V wi) {
  const float ldotn = wi.z;
  const float vdotn = wo.z;
  const V m = normalize(add(wi, wo));
  const float ldotm = dot(wi, m);
  const float ndotm = m.z;
  const bool valid = ldotn > kDisneyEps && vdotn > kDisneyEps &&
                     ndotm > kDisneyEps && ldotm > kDisneyEps;
  V f = {0.0f, 0.0f, 0.0f};
  if (valid) {
    const float ndotm2 = ndotm * ndotm;
    const float ds = d_gtr2_aniso(p.ax, p.ay, m, ndotm2);
    const float fh = schlick5(ldotm);
    const V fs = {p.f0.x + (1.0f - p.f0.x) * fh, p.f0.y + (1.0f - p.f0.y) * fh,
                  p.f0.z + (1.0f - p.f0.z) * fh};
    const float gs = smith_g_over_2ndotv(ldotn, p.spec_rough) *
                     smith_g_over_2ndotv(vdotn, p.spec_rough);
    const V fsheen = scale(p.sheen, fh * (1.0f - p.metallic));
    f = add(scale(fs, ds * gs), fsheen);
    const float dr = d_gtr1(p.gloss, ndotm2);
    const float fr = F(0.04) + F(1.0 - 0.04) * fh;
    const float gr = smith_g_over_2ndotv(ldotn, 0.25f) *
                     smith_g_over_2ndotv(vdotn, 0.25f);
    const float cc = p.clearcoat * dr * fr * gr;
    f = {f.x + cc, f.y + cc, f.z + cc};
  }
  return scale(f, wi.z);
}

// disney.pdf_specular: the exact anisotropic Smith G1 in the GTR2 branch
RLS_HD float disney_pdf_specular(const Disney& p, V wo, V wi) {
  const V m = normalize(add(wi, wo));
  const float mdotn = m.z;
  if (mdotn < 0.0f) return 0.0f;
  const float idotm = fabsf(dot(wi, m));
  const float mdotn2 = mdotn * mdotn;
  const float vdotn = clamp_min(wo.z, 1e-4f);
  const float p_gtr2 = d_gtr2_aniso(p.ax, p.ay, m, mdotn2) *
                       smith_g1_aniso(wo, m, p.ax, p.ay) / vdotn;
  const float cc_w = p.clearcoat / (p.clearcoat + 1.0f);
  const float p_gtr1 =
      d_gtr1(p.gloss, mdotn2) * fabsf(mdotn) / clamp_min(idotm, 1e-12f);
  const float d_mix = p_gtr2 + (p_gtr1 - p_gtr2) * cc_w;
  return d_mix * 0.25f;
}

// disney._sample_gtr1: the RAW roughness^2, pow as exp(log), a2 = 1's branch
RLS_HD V sample_gtr1(float rough, float rx, float ry) {
  const float phi = F(2.0 * kPi) * rx;
  const float a2 = rough * rough;
  float cos_t;
  if (fabsf(a2 - 1.0f) < 1e-6f) {
    cos_t = sqrtf(clamp_min(1.0f - ry, 0.0f));
  } else {
    const float log_a2 = logf(clamp_min(a2, 1e-20f));
    const float pow_term = expf((1.0f - ry) * log_a2);
    cos_t = sqrtf(clamp((1.0f - pow_term) / (1.0f - a2), 0.0f, 1.0f));
  }
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  return {sin_t * cosf(phi), sin_t * sinf(phi), cos_t};
}

// disney.sample_specular: GTR2 VNDF with weight 1/(clearcoat+1), else GTR1
RLS_HD V disney_sample_specular(const Disney& p, V wo, float rx, float ry) {
  const float gtr2_w = 1.0f / (p.clearcoat + 1.0f);
  V m;
  if (rx < gtr2_w) {
    m = sample_vndf(wo, p.ax, p.ay, rx / clamp_min(gtr2_w, 1e-12f), ry);
  } else {
    m = sample_gtr1(p.rough,
                    (rx - gtr2_w) / clamp_min(1.0f - gtr2_w, 1e-12f), ry);
  }
  if (m.z < 0.0f) return {0.0f, 0.0f, 0.0f};
  return reflect(wo, m);
}

// ---------------------------------------------------------------------------
// the lanes' fields
// ---------------------------------------------------------------------------

RLS_HD float ld(const Fields& f, int k, int64_t i) {
  return reinterpret_cast<const float*>(f.a[k].p)[i * f.a[k].s];
}

RLS_HD int ldi(const Fields& f, int k, int64_t i) {
  return reinterpret_cast<const int32_t*>(f.a[k].p)[i * f.a[k].s];
}

RLS_HD bool ldb(const Fields& f, int k, int64_t i) {
  return reinterpret_cast<const uint8_t*>(f.a[k].p)[i * f.a[k].s] != 0;
}

RLS_HD V ldv(const Fields& f, int k, int64_t i) {
  return {ld(f, k, i), ld(f, k + 1, i), ld(f, k + 2, i)};
}

RLS_HD bool has(const Fields& f, int k) { return f.a[k].p != nullptr; }

RLS_HD Ggx ld_ggx(const Fields& f, int k, int64_t i) {
  return {ld(f, k, i), ld(f, k + 1, i), ld(f, k + 2, i), ld(f, k + 3, i),
          ld(f, k + 4, i)};
}

// rlDisney's lanes, where the table has its lobes
RLS_HD bool is_disney(const Fields& f, int64_t i) {
  return has(f, kBaseR) && ldi(f, kMtype, i) == kDisney;
}

RLS_HD Disney ld_disney(const Fields& f, int64_t i) {
  Disney p;
  p.base = ldv(f, kBaseR, i);
  p.sheen = ldv(f, kSheenR, i);
  p.f0 = ldv(f, kF0R, i);
  p.rough = ld(f, kRough, i);
  p.subsurface = ld(f, kSubsurface, i);
  p.metallic = ld(f, kMetallic, i);
  p.clearcoat = ld(f, kClearcoat, i);
  p.gloss = ld(f, kGloss, i);
  p.ax = ld(f, kDax, i);
  p.ay = ld(f, kDay, i);
  p.spec_rough = ld(f, kDspecRough, i);
  return p;
}

RLS_HD void put(float* out, int64_t n, int64_t i, int row, float v) {
  out[row * n + i] = v;
}

RLS_HD void putv(float* out, int64_t n, int64_t i, int row, V v) {
  put(out, n, i, row, v.x);
  put(out, n, i, row + 1, v.y);
  put(out, n, i, row + 2, v.z);
}

// ---------------------------------------------------------------------------
// models/dispatch.py's entry points: lane i of n, written to rows of `out`
// ---------------------------------------------------------------------------

// (f*cos rows 0-2, pdf row 3); the cosine sampler's pdf on every lane
RLS_HD void eval_diffuse(const Fields& f, int64_t i, int64_t n, float* out) {
  const V wo = ldv(f, kWoX, i);
  const V wi = ldv(f, kWiX, i);
  V fv = {0.0f, 0.0f, 0.0f};
  if (ldb(f, kHasDiffuse, i)) {
    fv = is_disney(f, i)
             ? disney_diffuse_cos(ld_disney(f, i), wo, wi)
             : scale(ldv(f, kDiffR, i), orennayar(ld(f, kDiffRough, i), wo,
                                                  wi));
  }
  putv(out, n, i, 0, fv);
  put(out, n, i, 3,
      clamp_min(div_scalar(clamp_min(wi.z, 0.0f), F(kPi)), 1e-9f));
}

// (wi rows 0-2)
RLS_HD void sample_diffuse(const Fields& f, int64_t i, int64_t n,
                           float* out) {
  putv(out, n, i, 0, cosine_sample(ld(f, kRx, i), ld(f, kRy, i)));
}

// (f*cos rows 0-2, pdf row 3): GGX or Beckmann with the material's Fresnel
// mode, rlSkin's sheen lobe over it, or rlDisney's mixture
RLS_HD void eval_specular(const Fields& f, int64_t i, int64_t n, float* out) {
  const V wo = ldv(f, kWoX, i);
  const V wi = ldv(f, kWiX, i);
  const bool spec = ldb(f, kHasSpec, i);
  V fv = {0.0f, 0.0f, 0.0f};
  float pdf;
  if (is_disney(f, i)) {
    const Disney p = ld_disney(f, i);
    if (spec) fv = disney_specular_cos(p, wo, wi);
    pdf = disney_pdf_specular(p, wo, wi);
  } else {
    const Ggx g = ld_ggx(f, kAx, i);
    const bool beck = ldi(f, kDist, i) == 1;
    if (spec) {
      const int mode = ldi(f, kFresnelMode, i);
      float fres = 1.0f;
      V hr = {0.0f, 0.0f, 0.0f};
      if (mode == 0 || !beck) hr = reflection_half(wo, wi);
      if (mode == 0) {
        fres = fresnel_dielectric(wo, hr, g.ior_in, g.ior_out);
      } else if (mode == 1) {
        const V h = normalize(add(wo, wi));
        const float s = clamp(1.0f - fabsf(dot(wi, h)), 0.0f, 1.0f);
        const float s2 = s * s;
        const float ksn = ld(f, kKsn, i);
        fres = ksn + (1.0f - ksn) * (s * (s2 * s2));
      }
      const float gd = beck ? beckmann_gd(wo, wi, g.ag)
                            : reflection_gd(g, wo, wi, hr);
      const bool valid = dot(wi, wi) > 1e-12f;
      const float refl = valid ? fres * gd * wi.z : 0.0f;
      fv = scale(ldv(f, kSpecR, i), refl);
    }
    pdf = beck ? beckmann_pdf(wo, wi, g.ag) : ggx_pdf(g, wo, wi);
    if (has(f, kAx2) && ldi(f, kMtype, i) == kSkin) {
      // rlSkin: the sheen lobe over the specular one, which the
      // view-averaged sheen Fresnel attenuates
      const Ggx g2 = ld_ggx(f, kAx2, i);
      const V s2w = ldv(f, kSpec2R, i);
      if (spec) {
        const bool valid = dot(wi, wi) > 1e-12f;
        const float refl2 = valid ? reflection_term(g2, wo, wi) * wi.z : 0.0f;
        fv = add(scale(s2w, refl2), scale(fv, ld(f, kSheenLayer, i)));
      }
      if (maxc(s2w) > 1e-5f) pdf = 0.5f * (pdf + ggx_pdf(g2, wo, wi));
    }
  }
  putv(out, n, i, 0, fv);
  put(out, n, i, 3, clamp_min(pdf, 1e-9f));
}

// (wi rows 0-2)
RLS_HD void sample_specular(const Fields& f, int64_t i, int64_t n,
                            float* out) {
  const V wo = ldv(f, kWoX, i);
  const float rx = ld(f, kRx, i);
  const float ry = ld(f, kRy, i);
  V wi;
  if (is_disney(f, i)) {
    wi = disney_sample_specular(ld_disney(f, i), wo, rx, ry);
  } else {
    const bool beck = ldi(f, kDist, i) == 1;
    float rx_spec = rx;
    bool use_sheen = false;
    if (has(f, kAx2)) {
      // with rlSkin's lobes in the table, a lane with sheen picks the
      // sheen or the specular lobe 50/50 and remaps rx for the one picked
      const bool has_sheen = maxc(ldv(f, kSpec2R, i)) > 1e-5f;
      use_sheen = rx < 0.5f && has_sheen && ldi(f, kMtype, i) == kSkin;
      rx_spec = has_sheen ? (rx - 0.5f) * 2.0f : rx;
    }
    if (use_sheen) {
      wi = ggx_sample(ld_ggx(f, kAx2, i), wo, rx * 2.0f, ry);
    } else if (beck) {
      wi = beckmann_sample(wo, ld(f, kAg, i), rx_spec, ry);
    } else {
      wi = ggx_sample(ld_ggx(f, kAx, i), wo, rx_spec, ry);
    }
  }
  putv(out, n, i, 0, wi);
}

// (wi rows 0-2, weight rows 3-5): one rough-refraction sample
RLS_HD void sample_refract(const Fields& f, int64_t i, int64_t n,
                           float* out) {
  const Refracted r = ggx_sample_refract(ld_ggx(f, kAx, i), ldv(f, kWoX, i),
                                         ld(f, kRx, i), ld(f, kRy, i));
  putv(out, n, i, 0, r.wi);
  putv(out, n, i, 3,
       ldb(f, kHasRefract, i) ? scale(ldv(f, kKtR, i), r.weight)
                              : V{0.0f, 0.0f, 0.0f});
}

#undef F

}  // namespace rls_bsdf
