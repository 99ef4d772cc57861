// K13 probes for Hopper (sm_90a): K2's scan and its constructs in
// isolation, as the TPU probes checked Mosaic's lowering of them.
//
// seg_scan_probe_kernel  replaces scripts/tpu_mosaic_probe2.py scan_kernel:
//   a segmented inclusive scan over [rows, 128] f32 that restarts at every
//   block of `sub` rows, in row-major order, keep == 0 starting a segment
//   (the script's np_reference). One CTA scans one block with
//   loops_scan::block_seg_scan, the very function K2 runs (seg_scan.cuh),
//   as K2 runs it: each thread folds its two elements into one (value,
//   reset) pair, scans the pairs, and adds its elements in order from the
//   value before them. Chunks of 512 elements are linked by the carry (one
//   chunk at SUB = 4: one round of loads a launch).
// construct_probe_kernel replaces scripts/tpu_mosaic_probe.py run with the
//   kernels k_reshape_s1 ... k_dynbase: each case computes the same
//   function on the same [8, 128], [1, 512], [32, 128] or [4, 128] inputs,
//   the way a kernel of the port does it: lane shifts by __shfl_up_sync
//   inside a warp, the lanes and rows from other warps read from global
//   memory, and a runtime base into a shared-memory window (as K3 writes
//   its rows). The [32, 128] cases and dot0 run one output a thread over
//   16 and 64 CTAs, so that no case takes twice the launch floor.
//
// launch_floor_kernel: one CTA of 32 threads that writes one word, the
//   least a launch costs the card; the K13 kernels' bound.
//
// What bounds them: the launch. The inputs are a few KB; these kernels
// check lowering and order, and their time is the card's launch latency
// (launch_floor_kernel measures it).
//
// C entry points return cudaGetLastError().
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

constexpr int kProbeThreads = 256;
// the scan: two elements a thread, one chunk of 512 a CTA (a block of
// SUB = 4 rows)
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanChunk = 2 * kScanThreads;
// the TPU scripts' shapes (tpu_mosaic_probe.py:18-21, :52)
constexpr int kS = 128, kLanes = 128, kGS = 32, kSub = 4, kR = 512;
constexpr int kHot = 16, kYRows = 16, kVRows = 4;
// CTAs of the cases that run one output a thread: the [32, 128] ones
// (2-5) and dot0's [128, 128] (6)
constexpr int kMatCtas = kGS * kLanes / kProbeThreads;
constexpr int kDotCtas = kLanes * kS / kProbeThreads;

__global__ void __launch_bounds__(kScanThreads)
seg_scan_probe_kernel(const float* __restrict__ v, const float* __restrict__ keep,
                      float* __restrict__ out, int L) {
  __shared__ float warp_v[kScanWarps];
  __shared__ int warp_f[kScanWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * L;
  float carry = 0.f;  // each block starts a segment
  for (int c0 = 0; c0 < L; c0 += kScanChunk) {
    const int k = c0 + 2 * threadIdx.x;
    float x[2] = {0.f, 0.f};
    int f[2] = {1, 1};
    for (int h = 0; h < 2; ++h) {
      if (k + h < L) {
        x[h] = v[base + k + h];
        f[h] = keep[base + k + h] == 0.f;
      }
    }
    // the thread's pair folded, as K2 folds its own slots: its value and
    // whether a segment starts in it; then its elements from `before`
    float before;
    loops_scan::block_seg_scan<kScanWarps>(f[1] ? x[1] : x[0] + x[1], f[0] | f[1],
                                           carry, warp_v, warp_f, before);
    const float y0 = f[0] ? x[0] : before + x[0];
    const float y1 = f[1] ? x[1] : y0 + x[1];
    if (k < L) out[base + k] = y0;
    if (k + 1 < L) out[base + k + 1] = y1;
  }
}

// `which` selects the construct (the order of
// loops_tpu_torch/probes/mosaic.py CONSTRUCTS). The [32, 128] cases and
// dot0 give each thread one output of their grid (construct_ctas), its
// operands read straight from global memory: no staging, no barrier.
__global__ void __launch_bounds__(kProbeThreads)
construct_probe_kernel(int which, const float* __restrict__ a,
                       const float* __restrict__ b, const int* __restrict__ idx,
                       float* __restrict__ out, int base) {
  __shared__ float tile[kYRows * kLanes];  // dynbase's window
  const int t = threadIdx.x, lane = t & 31;
  const int e = blockIdx.x * kProbeThreads + t;  // cases 2-6: the output
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
      for (int q = t; q < kR; q += kProbeThreads) out[q] = a[q];
      break;
    case 2:  // k_shift_sub: rows down by 2, zeros in
      out[e] = e >= 2 * kLanes ? a[e - 2 * kLanes] : 0.f;
      break;
    case 3: {  // k_shift_lane: lanes right by 3, zeros in. A warp holds 32
               // lanes of one row: shuffle inside it, and the 3 lanes that
               // come from the warp before read from global memory
      const float x = a[e];
      float up = __shfl_up_sync(loops_scan::kFullMask, x, 3);
      if (lane < 3) up = e % kLanes >= 3 ? a[e - 3] : 0.f;
      out[e] = up;
      break;
    }
    case 4:  // k_iota_mod: rows whose index % SUB is 0 are zeroed
      out[e] = (e / kLanes) % kSub >= 1 ? a[e] : 0.f;
      break;
    case 5:  // k_lane_bcast: each row's last lane across the row
      out[e] = a[(e / kLanes) * kLanes + kLanes - 1];
      break;
    case 6: {  // k_dot0: out[l, s] = sum_u a[u, l] * b[u, s], a [SUB, 128],
               // b [SUB, S]; a 4-term f32 sum in u order
      const int l = e / kS, s = e % kS;
      float acc = 0.f;
      for (int u = 0; u < kSub; ++u) acc = fmaf(a[u * kLanes + l], b[u * kS + s], acc);
      out[e] = acc;
      break;
    }
    case 7:  // k_dynbase: a zeroed [16, 128] window, rows base..base+3 += v
      for (int q = t; q < kYRows * kLanes; q += kProbeThreads) tile[q] = 0.f;
      __syncthreads();
      for (int q = t; q < kVRows * kLanes; q += kProbeThreads) {
        tile[base * kLanes + q] += a[q];
      }
      __syncthreads();
      for (int q = t; q < kYRows * kLanes; q += kProbeThreads) out[q] = tile[q];
      break;
  }
}

int construct_ctas(int which) {
  return which >= 2 && which <= 5 ? kMatCtas : which == 6 ? kDotCtas : 1;
}

__global__ void __launch_bounds__(32) launch_floor_kernel(int* __restrict__ out, int v) {
  if (threadIdx.x == 0) *out = v;
}

}  // namespace

extern "C" {

// out [1] int32: set to v
int loops_launch_floor(void* out, int v, void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), v);
  return static_cast<int>(cudaGetLastError());
}

int loops_seg_scan_probe(const void* v, const void* keep, void* out,
                         int n_blocks, int L, void* stream) {
  if (n_blocks <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  seg_scan_probe_kernel<<<n_blocks, kScanThreads, 0,
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
  construct_probe_kernel<<<construct_ctas(which), kProbeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      which, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int*>(idx), static_cast<float*>(out), base);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
