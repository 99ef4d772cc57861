// Device-memory read stream for Hopper (sm_90a): the measured roofline.
//
// K11 stream_read_kernel  replaces bench.py measure_stream_gbps (a Pallas
// stream over a 64 MiB f32 array in (2048, 512) tiles, one 8 x 128 corner
// of each tile added into a small output so the loads stay live).
//
// Here every element of every pass is read, with 16-byte loads, and folded
// into a per-thread sum; each CTA writes the sum of its threads to
// out[blockIdx.x], so no load is dead. `passes` sweeps of the whole array
// run in one launch, each in the same order, so the slope of time over
// passes is the time of one sweep (as the TPU version timed 616 passes
// against 16). A CTA's sweeps are not synchronised with other CTAs'.
//
// What bounds it: the bytes read, n * 4 per pass, over the card's memory
// rate; an array that fits the 50 MB L2 (or nearly does, as the JAX
// bench's 64 MiB) may be served partly from L2 and read above it.
//
// The C entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStreamThreads = 512;

__global__ void __launch_bounds__(kStreamThreads)
stream_read_kernel(const float4* __restrict__ x, long long n4, int passes,
                   float* __restrict__ out) {
  __shared__ float warp_sums[kStreamThreads / 32];
  const long long stride = static_cast<long long>(gridDim.x) * kStreamThreads;
  float acc = 0.f;
  for (int p = 0; p < passes; ++p) {
    for (long long i = static_cast<long long>(blockIdx.x) * kStreamThreads +
                       threadIdx.x;
         i < n4; i += stride) {
      const float4 v = __ldcs(x + i);  // streaming: no reuse expected
      acc += (v.x + v.y) + (v.z + v.w);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < kStreamThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    if (threadIdx.x == 0) out[blockIdx.x] = s;
  }
}

}  // namespace

extern "C" {

int loops_stream_read_f32(const void* x, void* out, int n4, int passes,
                          int blocks, void* stream) {
  if (blocks <= 0 || passes < 0 || n4 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  stream_read_kernel<<<blocks, kStreamThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), n4, passes, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
