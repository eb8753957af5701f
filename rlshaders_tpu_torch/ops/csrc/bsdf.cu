// The lobes of models/dispatch.py as CUDA kernels: one launch an entry-point
// call (eval_diffuse, sample_diffuse, eval_specular, sample_specular,
// sample_refract), one thread a lane. Each thread loads its lane's gathered
// material fields and directions or random numbers, evaluates its own
// model in registers (bsdf.cuh) and writes its rows of the output.
//
// They replace no TPU kernel: the JAX package leaves the lobes to XLA,
// which fuses each entry point's jnp into a few kernels. The eager torch
// code of models/dispatch.py, the plain version, runs every model for
// every lane as some 15 to 300 elementwise launches a call, each reading
// and writing its intermediates in device memory. Here only the lane's
// inputs are read and its 3 to 6 output floats written: the bound is those
// bytes at 3.35 TB/s (a few hundred float operations a lane sit below it).
//
// Built with -fmad=false and nvcc's IEEE division and square root, so a
// lane follows the eager code's float32 roundings on the card (bsdf.cuh).
// Each entry point launches on `stream`, makes no launch for n = 0 and
// returns the launch's CUDA error; 0 means accepted. `fields` is a host
// table of rls_bsdf::kFields (pointer, stride) pairs; `out` holds the
// rows, n floats each.
#include <cuda_runtime.h>

#include <string.h>

#include "bsdf.cuh"

namespace {

constexpr int kThreads = 256;

using Kernel = void (*)(rls_bsdf::Fields, int64_t, float*);

// one kernel an entry point, named for it in profiles
#define RLS_BSDF_KERNEL(entry)                                            \
  __global__ void __launch_bounds__(kThreads)                             \
      entry##_kernel(const rls_bsdf::Fields f, int64_t n, float* out) {   \
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +     \
                      threadIdx.x;                                        \
    if (i < n) rls_bsdf::entry(f, i, n, out);                             \
  }

RLS_BSDF_KERNEL(eval_diffuse)
RLS_BSDF_KERNEL(sample_diffuse)
RLS_BSDF_KERNEL(eval_specular)
RLS_BSDF_KERNEL(sample_specular)
RLS_BSDF_KERNEL(sample_refract)

int launch(Kernel kernel, const int64_t* fields, int64_t n, float* out,
           void* stream) {
  if (n <= 0) return 0;
  rls_bsdf::Fields f;
  memcpy(&f, fields, sizeof f);
  kernel<<<dim3((n + kThreads - 1) / kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(f, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

static_assert(sizeof(rls_bsdf::Fields) == 16 * rls_bsdf::kFields,
              "the field table is (pointer, stride) pairs");

// (f*cos, pdf): 4 rows
extern "C" int rls_bsdf_eval_diffuse(const int64_t* fields, int64_t n,
                                     float* out, void* stream) {
  return launch(eval_diffuse_kernel, fields, n, out, stream);
}

// wi: 3 rows
extern "C" int rls_bsdf_sample_diffuse(const int64_t* fields, int64_t n,
                                       float* out, void* stream) {
  return launch(sample_diffuse_kernel, fields, n, out, stream);
}

// (f*cos, pdf): 4 rows
extern "C" int rls_bsdf_eval_specular(const int64_t* fields, int64_t n,
                                      float* out, void* stream) {
  return launch(eval_specular_kernel, fields, n, out, stream);
}

// wi: 3 rows
extern "C" int rls_bsdf_sample_specular(const int64_t* fields, int64_t n,
                                        float* out, void* stream) {
  return launch(sample_specular_kernel, fields, n, out, stream);
}

// (wi, weight): 6 rows
extern "C" int rls_bsdf_sample_refract(const int64_t* fields, int64_t n,
                                       float* out, void* stream) {
  return launch(sample_refract_kernel, fields, n, out, stream);
}
