// The segmented inclusive scan of K2 (csrc/spmv.cu flat_spmv_v2_kernel),
// shared with the K13 probe kernel seg_scan_probe_kernel (csrc/probes.cu)
// so that the probe measures and checks the very code K2 runs.
//
// A CTA of kWarps warps scans kWarps * 32 elements per call ("a chunk"),
// each element a (value, flag) pair; flag 1 means a segment starts at or
// before this element within the chunk. Each warp scans its 32 elements
// with __shfl_up_sync carrying (value, flag); the warp aggregates are
// folded in warp order through shared memory; `carry` holds the open
// segment's running value from the chunks before, and is updated for the
// next chunk. Every thread of the CTA computes the same carry.
//
// K2 scans one (tail value, has a reset) pair per thread, each thread's
// fold of its own slots, and takes `before`: the open segment's value
// before the thread's first element (the last lane's value of the warp
// before, or the carry). The probe scans one element per thread.
//
// The order of the f32 additions is fixed (the shuffle tree, then the
// warp fold in warp order), so two runs give bitwise-equal results.
#pragma once

#include <cuda_runtime.h>

namespace loops_scan {

constexpr unsigned kFullMask = 0xffffffffu;

// One chunk of the CTA-wide scan; returns this thread's inclusive value
// and sets `before` to the value before it (exclusive). warp_v / warp_f
// are shared arrays of kWarps entries. All threads of the CTA must call it
// (it synchronises twice: after the warp aggregates are written, and
// before they may be written again).
template <int kWarps>
__device__ __forceinline__ float block_seg_scan(float v, int f, float& carry,
                                                float* warp_v, int* warp_f,
                                                float& before) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const float pv = __shfl_up_sync(kFullMask, v, d);
    const int pf = __shfl_up_sync(kFullMask, f, d);
    if (lane >= d) {
      if (!f) v = pv + v;
      f |= pf;
    }
  }
  if (lane == 31) {
    warp_v[warp] = v;
    warp_f[warp] = f;
  }
  __syncthreads();
  float pre = carry;
  for (int w = 0; w < warp; ++w) pre = warp_f[w] ? warp_v[w] : pre + warp_v[w];
  const float warp_before = pre;
  if (!f) v = pre + v;
  before = __shfl_up_sync(kFullMask, v, 1);
  if (lane == 0) before = warp_before;
  for (int w = warp; w < kWarps; ++w) pre = warp_f[w] ? warp_v[w] : pre + warp_v[w];
  carry = pre;
  __syncthreads();  // warp_v/warp_f are rewritten by the next chunk
  return v;
}

template <int kWarps>
__device__ __forceinline__ float block_seg_scan(float v, int f, float& carry,
                                                float* warp_v, int* warp_f) {
  float before;
  return block_seg_scan<kWarps>(v, f, carry, warp_v, warp_f, before);
}

}  // namespace loops_scan
