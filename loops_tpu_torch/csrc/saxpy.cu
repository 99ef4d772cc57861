// SAXPY for Hopper (sm_90a): out = a * x + y in float32.
//
// K12 saxpy_kernel  replaces examples/saxpy.py saxpy_pallas (the Pallas
// hello world: one VMEM block, a from SMEM, `a * x + y`), whose reference
// is the grid-stride-loop hello world examples/saxpy.cu.
//
// What bounds it on an H100: bytes, 12 per element (x and y read, out
// written) against 2 flops. The design is the reference's grid-stride loop
// with 16-byte loads and stores (float4) when x, y and out all start on 16
// bytes, and a scalar loop over the tail and over unaligned arrays.
//
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn:
// no contraction into one FMA), so the result equals the plain PyTorch
// `a * x + y`, which rounds a * x to f32 before adding y, bit for bit.
//
// The C entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSaxpyThreads = 256;

__device__ __forceinline__ float axpy(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__global__ void __launch_bounds__(kSaxpyThreads)
saxpy_kernel(float a, const float* __restrict__ x, const float* __restrict__ y,
             float* __restrict__ out, long long n, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = t; i < n4; i += stride) {
      const float4 xv = x4[i], yv = y4[i];
      o4[i] = make_float4(axpy(a, xv.x, yv.x), axpy(a, xv.y, yv.y),
                          axpy(a, xv.z, yv.z), axpy(a, xv.w, yv.w));
    }
    done = n4 * 4;
  }
  for (long long i = done + t; i < n; i += stride) out[i] = axpy(a, x[i], y[i]);
}

}  // namespace

extern "C" {

int loops_saxpy_f32(float a, const void* x, const void* y, void* out, int n,
                    int blocks, void* stream) {
  if (n < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  saxpy_kernel<<<blocks, kSaxpyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
