// K12's body with its design choices as switches, for
// scripts/saxpy_variants_torch.py only: the port builds
// loops_tpu_torch/csrc/saxpy.cu, which has none of them.
//
// out = a * x + y in float32, a grid-stride loop over float4 when x, y and
// out all start on 16 bytes, a scalar loop over the tail and over
// unaligned arrays, the product and the sum rounded separately (bit for
// bit `a * x + y`). The switches:
//
//   K12_THREADS      threads a CTA;
//   K12_CTAS_PER_SM  the second __launch_bounds__ argument (K12_THREADS x
//                    K12_CTAS_PER_SM threads an SM; 2,048 caps a thread at
//                    32 registers);
//   K12_UNROLL       float4 of x and of y a thread loads before its first
//                    store, the grid's width apart;
//   K12_STREAMING    evict-first loads and stores (__ldcs, __stcs).
//
// The C entry point has the port's signature (loops_saxpy_f32) and returns
// cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#ifndef K12_THREADS
#define K12_THREADS 256
#endif
#ifndef K12_CTAS_PER_SM
#define K12_CTAS_PER_SM 4
#endif
#ifndef K12_UNROLL
#define K12_UNROLL 1
#endif
#ifndef K12_STREAMING
#define K12_STREAMING 0
#endif

namespace {

constexpr int kThreads = K12_THREADS;
constexpr int kUnroll = K12_UNROLL;

__device__ __forceinline__ float axpy(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__device__ __forceinline__ float4 load4(const float4* p) {
#if K12_STREAMING
  return __ldcs(p);
#else
  return *p;
#endif
}

__device__ __forceinline__ void store4(float4* p, float4 v) {
#if K12_STREAMING
  __stcs(p, v);
#else
  *p = v;
#endif
}

__global__ void __launch_bounds__(kThreads, K12_CTAS_PER_SM)
saxpy_kernel(float a, const float* __restrict__ x, const float* __restrict__ y,
             float* __restrict__ out, long long n, int vec) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i0 = t; i0 < nv; i0 += stride * kUnroll) {
      float4 xv[kUnroll], yv[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long i = i0 + j * stride;
        if (i < nv) {
          xv[j] = load4(x4 + i);
          yv[j] = load4(y4 + i);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long i = i0 + j * stride;
        if (i < nv) {
          store4(o4 + i, make_float4(axpy(a, xv[j].x, yv[j].x),
                                     axpy(a, xv[j].y, yv[j].y),
                                     axpy(a, xv[j].z, yv[j].z),
                                     axpy(a, xv[j].w, yv[j].w)));
        }
      }
    }
    done = nv * 4;
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
  saxpy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
