// bsdf.cu's five entry points as loops on the host, over bsdf.cuh's same
// per-lane functions: built by g++ (accel/native.build) for the CPU tests,
// which hold every lane to models/dispatch.py's eager torch code where no
// card and no nvcc exist. Arguments as bsdf.cu's, less the stream.
#include <string.h>

#include "bsdf.cuh"

namespace {

using Entry = void (*)(const rls_bsdf::Fields&, int64_t, int64_t, float*);

int loop(Entry entry, const int64_t* fields, int64_t n, float* out) {
  rls_bsdf::Fields f;
  memcpy(&f, fields, sizeof f);
  for (int64_t i = 0; i < n; ++i) entry(f, i, n, out);
  return 0;
}

}  // namespace

extern "C" int rls_bsdf_eval_diffuse(const int64_t* fields, int64_t n,
                                     float* out) {
  return loop(rls_bsdf::eval_diffuse, fields, n, out);
}

extern "C" int rls_bsdf_sample_diffuse(const int64_t* fields, int64_t n,
                                       float* out) {
  return loop(rls_bsdf::sample_diffuse, fields, n, out);
}

extern "C" int rls_bsdf_eval_specular(const int64_t* fields, int64_t n,
                                      float* out) {
  return loop(rls_bsdf::eval_specular, fields, n, out);
}

extern "C" int rls_bsdf_sample_specular(const int64_t* fields, int64_t n,
                                        float* out) {
  return loop(rls_bsdf::sample_specular, fields, n, out);
}

extern "C" int rls_bsdf_sample_refract(const int64_t* fields, int64_t n,
                                       float* out) {
  return loop(rls_bsdf::sample_refract, fields, n, out);
}
