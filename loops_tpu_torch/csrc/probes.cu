// K13 probes for Hopper (sm_90a): K2's scan and its constructs in
// isolation, as the TPU probes checked Mosaic's lowering of them.
//
// seg_scan_probe_kernel  replaces scripts/tpu_mosaic_probe2.py scan_kernel:
//   a segmented inclusive scan over [rows, 128] f32 that restarts at every
//   block of `sub` rows, in row-major order, keep == 0 starting a segment
//   (the script's np_reference). One CTA scans one block with
//   loops_scan::block_seg_scan, the very function K2 runs (seg_scan.cuh),
//   in chunks of 256 elements linked by the carry.
// construct_probe_kernel replaces scripts/tpu_mosaic_probe.py run with the
//   kernels k_reshape_s1 ... k_dynbase: each case computes the same
//   function on the same [8, 128], [1, 512], [32, 128] or [4, 128] inputs,
//   the way a kernel of the port does it: lane shifts by __shfl_up_sync
//   inside a warp, rows and last lanes across warps through shared memory,
//   and a runtime base into a shared-memory window (as K3 writes its rows).
//
// What bounds them: the launch. The inputs are a few KB; these kernels
// check lowering and order, and their time is the card's launch latency.
//
// C entry points return cudaGetLastError().
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

constexpr int kProbeThreads = 256;
constexpr int kProbeWarps = kProbeThreads / 32;
// the TPU scripts' shapes (tpu_mosaic_probe.py:18-21, :52)
constexpr int kS = 128, kLanes = 128, kGS = 32, kSub = 4, kR = 512;
constexpr int kHot = 16, kYRows = 16, kVRows = 4;

__global__ void __launch_bounds__(kProbeThreads)
seg_scan_probe_kernel(const float* __restrict__ v, const float* __restrict__ keep,
                      float* __restrict__ out, int L) {
  __shared__ float warp_v[kProbeWarps];
  __shared__ int warp_f[kProbeWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * L;
  float carry = 0.f;  // each block starts a segment
  for (int c0 = 0; c0 < L; c0 += kProbeThreads) {
    const int k = c0 + threadIdx.x;
    const bool in = k < L;
    float x = 0.f;
    int f = 1;
    if (in) {
      x = v[base + k];
      f = keep[base + k] == 0.f;
    }
    x = loops_scan::block_seg_scan<kProbeWarps>(x, f, carry, warp_v, warp_f);
    if (in) out[base + k] = x;
  }
}

// One CTA; `which` selects the construct (the order of
// loops_tpu_torch/probes/mosaic.py CONSTRUCTS).
__global__ void __launch_bounds__(kProbeThreads)
construct_probe_kernel(int which, const float* __restrict__ a,
                       const float* __restrict__ b, const int* __restrict__ idx,
                       float* __restrict__ out, int base) {
  __shared__ float tile[kGS * kLanes];
  const int t = threadIdx.x, lane = t & 31;
  constexpr int kMat = kGS * kLanes;
  if (which >= 2 && which <= 5) {  // the [32, 128] cases stage the matrix
    for (int e = t; e < kMat; e += kProbeThreads) tile[e] = a[e];
    __syncthreads();
  }
  switch (which) {
    case 0:  // k_reshape_s1: row 0 of idx as a column, one-hot over 16
      if (t < kS) {
        const int r = idx[t];
        float4* o = reinterpret_cast<float4*>(out + t * kHot);
        for (int q = 0; q < kHot / 4; ++q) {
          o[q] = make_float4(r == 4 * q, r == 4 * q + 1, r == 4 * q + 2,
                             r == 4 * q + 3);
        }
      }
      break;
    case 1:  // k_out_reshape: [1, R] -> [R/128, 128], a copy
      for (int e = t; e < kR; e += kProbeThreads) out[e] = a[e];
      break;
    case 2:  // k_shift_sub: rows down by 2, zeros in; rows cross warps
      for (int e = t; e < kMat; e += kProbeThreads) {
        out[e] = e >= 2 * kLanes ? tile[e - 2 * kLanes] : 0.f;
      }
      break;
    case 3:  // k_shift_lane: lanes right by 3, zeros in. A warp holds 32
             // lanes of one row: shuffle inside it, and the 3 lanes that
             // come from the warp before through shared memory
      for (int e = t; e < kMat; e += kProbeThreads) {
        const int j = e % kLanes;
        float up = __shfl_up_sync(loops_scan::kFullMask, tile[e], 3);
        if (lane < 3) up = j >= 3 ? tile[e - 3] : 0.f;
        out[e] = up;
      }
      break;
    case 4:  // k_iota_mod: rows whose index % SUB is 0 are zeroed
      for (int e = t; e < kMat; e += kProbeThreads) {
        out[e] = (e / kLanes) % kSub >= 1 ? tile[e] : 0.f;
      }
      break;
    case 5:  // k_lane_bcast: each row's last lane across the row
      for (int e = t; e < kMat; e += kProbeThreads) {
        out[e] = tile[(e / kLanes) * kLanes + kLanes - 1];
      }
      break;
    case 6:  // k_dot0: out[l, s] = sum_u a[u, l] * b[u, s], a [SUB, 128],
             // b [SUB, S]; a 4-term f32 sum in u order
      for (int e = t; e < kLanes * kS; e += kProbeThreads) {
        const int l = e / kS, s = e % kS;
        float acc = 0.f;
        for (int u = 0; u < kSub; ++u) acc = fmaf(a[u * kLanes + l], b[u * kS + s], acc);
        out[e] = acc;
      }
      break;
    case 7:  // k_dynbase: a zeroed [16, 128] window, rows base..base+3 += v
      for (int e = t; e < kYRows * kLanes; e += kProbeThreads) tile[e] = 0.f;
      __syncthreads();
      for (int e = t; e < kVRows * kLanes; e += kProbeThreads) {
        tile[base * kLanes + e] += a[e];
      }
      __syncthreads();
      for (int e = t; e < kYRows * kLanes; e += kProbeThreads) out[e] = tile[e];
      break;
  }
}

}  // namespace

extern "C" {

int loops_seg_scan_probe(const void* v, const void* keep, void* out,
                         int n_blocks, int L, void* stream) {
  if (n_blocks <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  seg_scan_probe_kernel<<<n_blocks, kProbeThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(keep),
      static_cast<float*>(out), L);
  return static_cast<int>(cudaGetLastError());
}

int loops_construct_probe(int which, const void* a, const void* b,
                          const void* idx, void* out, int base, void* stream) {
  if (which < 0 || which > 7 || base < 0 || base > kYRows - kVRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  construct_probe_kernel<<<1, kProbeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      which, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int*>(idx), static_cast<float*>(out), base);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
