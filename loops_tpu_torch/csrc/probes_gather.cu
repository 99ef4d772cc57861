// K15 probes for Hopper (sm_90a): what a gathered element or row costs,
// from shared memory, from L2 and from device memory. These are the floors
// that K4's and K5's row gathers pay.
//
// gather_axis0_kernel  replaces scripts/tpu_r3_gather_probe.py probe_axis0:
//   out[i, j] = src[idx[i, j], j], src [S, 128] f32, idx [n, 128] int32.
//   src is staged in shared memory when it fits (S <= 256: 128 KB) and
//   read through the read-only path (__ldg, from L2) when it does not
//   (S = 1024, 512 KB). A thread takes 4 neighbouring j: one int4 of idx,
//   one float4 out.
// gather_axis1_kernel  replaces tpu_r3_gather_probe.py probe_axis1:
//   out[i, j] = src[i, idx[i, j]]. A warp holds row i in registers (a
//   float4 a lane) and gathers inside the row by __shfl_sync.
// row_gather_kernel  replaces scripts/tpu_r4_gather_probe.py _dynload_run
//   and g3_onehot_expand:
//   rows of a [S, 128] slab (f32 or bf16) gathered by idx, either summed
//   in groups of 8 (G1: out[g*8 + j] = sum_k0 slab[idx[g*K + k0 + j]], f32
//   sums in k0 order) or materialized (G2: out[r] = slab[idx[r]]; G3:
//   out[g*K + k] = f32(win[idx[(g*rep)*K + k]]), the first of the rep = 8
//   repeated idx rows of each block of K output rows, each bf16 value
//   widened to f32). A warp takes one output row, a lane 4 of its 128
//   values; a warp's indices are loaded 32 at a time and passed by
//   __shfl_sync. The grid is persistent (a few CTAs an SM, a grid-stride
//   loop), so each CTA stages the slab once. The slab sits in shared
//   memory when a CTA can hold it (G1/G2: S = 256; G3: W <= 512, 128 KB of
//   bf16) or is read through __ldg: from L2 at the TPU's S and at G3's
//   W = 2048 and, for the most part, at the 169,343-row arxiv table (86.7
//   MB, whose rows recur); from device memory at a 2,097,152-row table,
//   over 10 times the 50 MB L2.
//   G3 was a one-hot product on the TPU's MXU only because the TPU has no
//   general gather; here it is the gather it computes, bit for bit.
//
// What bounds them: bytes, what each index and output moves, plus the
// table once (G3: the window, one idx row per block, the f32 rows).
//
// C entry points return cudaGetLastError().
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

using loops_tc::set_smem;

constexpr int kLanes = 128;
constexpr int kGatherThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ P1
template <bool kSmem>
__global__ void __launch_bounds__(kGatherThreads)
gather_axis0_kernel(const float* __restrict__ src, const int4* __restrict__ idx,
                    float4* __restrict__ out, int S, long long n4) {
  extern __shared__ float tab[];
  const float* from = src;
  if (kSmem) {
    for (int e = threadIdx.x; e < S * kLanes / 4; e += kGatherThreads) {
      reinterpret_cast<float4*>(tab)[e] = reinterpret_cast<const float4*>(src)[e];
    }
    __syncthreads();
    from = tab;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kGatherThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
       e < n4; e += stride) {
    const int j = static_cast<int>(e % (kLanes / 4)) * 4;
    const int4 i = idx[e];
    float4 v;
    if (kSmem) {
      v = make_float4(from[i.x * kLanes + j], from[i.y * kLanes + j + 1],
                      from[i.z * kLanes + j + 2], from[i.w * kLanes + j + 3]);
    } else {
      v = make_float4(__ldg(from + i.x * kLanes + j), __ldg(from + i.y * kLanes + j + 1),
                      __ldg(from + i.z * kLanes + j + 2), __ldg(from + i.w * kLanes + j + 3));
    }
    out[e] = v;
  }
}

// ------------------------------------------------------------------ P2
__device__ __forceinline__ float pick(const float4& v, int c) {
  // lane (c >> 2) holds column c as component c & 3
  const int l = c >> 2;
  const float x = __shfl_sync(kFull, v.x, l), y = __shfl_sync(kFull, v.y, l);
  const float z = __shfl_sync(kFull, v.z, l), w = __shfl_sync(kFull, v.w, l);
  const int q = c & 3;
  return q == 0 ? x : q == 1 ? y : q == 2 ? z : w;
}

__global__ void __launch_bounds__(kGatherThreads)
gather_axis1_kernel(const float4* __restrict__ src, const int4* __restrict__ idx,
                    float4* __restrict__ out, int rows) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kGatherThreads / 32);
  for (int r = blockIdx.x * (kGatherThreads / 32) + (threadIdx.x >> 5); r < rows;
       r += warps) {  // the same trip count for the whole warp
    const size_t e = static_cast<size_t>(r) * (kLanes / 4) + lane;
    const float4 v = src[e];
    const int4 i = idx[e];
    out[e] = make_float4(pick(v, i.x), pick(v, i.y), pick(v, i.z), pick(v, i.w));
  }
}

// -------------------------------------------------------------- G1, G2
// 4 values of a row: float4 for f32, 4 bf16 (8 bytes) for bf16
__device__ __forceinline__ float4 load4(const float* p, bool ldg) {
  return ldg ? __ldg(reinterpret_cast<const float4*>(p))
             : *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool ldg) {
  const uint2 u = ldg ? __ldg(reinterpret_cast<const uint2*>(p))
                      : *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}
__device__ __forceinline__ void copy4(float* o, const float* p, bool ldg) {
  *reinterpret_cast<float4*>(o) = load4(p, ldg);
}
__device__ __forceinline__ void copy4(__nv_bfloat16* o, const __nv_bfloat16* p,
                                      bool ldg) {
  *reinterpret_cast<uint2*>(o) = ldg ? __ldg(reinterpret_cast<const uint2*>(p))
                                     : *reinterpret_cast<const uint2*>(p);
}
// G3: 4 bf16 widened to one float4
__device__ __forceinline__ void copy4(float* o, const __nv_bfloat16* p, bool ldg) {
  *reinterpret_cast<float4*>(o) = load4(p, ldg);
}

// O: the materialized rows' type (T, or f32 for G3; G1 writes f32 sums)
template <typename T, typename O, bool kSmem, bool kSum>
__global__ void __launch_bounds__(kGatherThreads)
row_gather_kernel(const T* __restrict__ slab, const int* __restrict__ idx,
                  void* __restrict__ out_, int S, int K, int n, int rep) {
  extern __shared__ __align__(16) unsigned char gsmem[];
  const T* from = slab;
  if (kSmem) {
    T* tab = reinterpret_cast<T*>(gsmem);
    const int pieces = S * kLanes * static_cast<int>(sizeof(T)) / 16;
    for (int e = threadIdx.x; e < pieces; e += kGatherThreads) {
      reinterpret_cast<uint4*>(tab)[e] = reinterpret_cast<const uint4*>(slab)[e];
    }
    __syncthreads();
    from = tab;
  }
  const int lane = threadIdx.x & 31, col = 4 * lane;
  const int warps = gridDim.x * (kGatherThreads / 32);
  const int w0 = blockIdx.x * (kGatherThreads / 32) + (threadIdx.x >> 5);
  if (kSum) {
    // output row o = g * 8 + j sums rows idx[g*K + k0 + j], k0 = 0, 8, ...
    float* out = static_cast<float*>(out_);
    const int per = K / 8, outs = n / K * 8;
    for (int o = w0; o < outs; o += warps) {
      const int g = o >> 3, j = o & 7;
      const int* ib = idx + static_cast<size_t>(g) * K + j;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int b = 0; b < per; b += 32) {
        const int mine = b + lane < per ? ib[(b + lane) * 8] : 0;
        const int m = min(32, per - b);
        for (int q = 0; q < m; ++q) {
          const int r = __shfl_sync(kFull, mine, q);
          const float4 v = load4(from + static_cast<size_t>(r) * kLanes + col, !kSmem);
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      }
      reinterpret_cast<float4*>(out + static_cast<size_t>(o) * kLanes)[lane] = acc;
    }
  } else {
    // output row o reads idx[o + (o / K) * (rep - 1) * K]: the first of
    // the rep idx rows of its block of K (G2: rep = 1, idx[o])
    O* out = static_cast<O*>(out_);
    for (int b = w0 * 32; b < n; b += warps * 32) {  // 32 rows a warp a step
      const int o = b + lane;
      const int mine =
          o < n ? idx[static_cast<size_t>(o) + static_cast<size_t>(o / K) * (rep - 1) * K]
                : 0;
      const int m = min(32, n - b);
      for (int q = 0; q < m; ++q) {
        const int r = __shfl_sync(kFull, mine, q);
        copy4(out + static_cast<size_t>(b + q) * kLanes + col,
              from + static_cast<size_t>(r) * kLanes + col, !kSmem);
      }
    }
  }
}

// The grid is persistent: at most `blocks` CTAs, and no more than the SMs
// hold at once, so that no CTA waits for a second wave with its share of
// the rows.
template <typename T, typename O, bool kSum>
int launch_rows(const void* slab, const void* idx, void* out, int S, int K,
                int n, int rep, int smem, int blocks, cudaStream_t s) {
  const int bytes = smem ? S * kLanes * static_cast<int>(sizeof(T)) : 0;
  auto k = smem ? row_gather_kernel<T, O, true, kSum> : row_gather_kernel<T, O, false, kSum>;
  if (const int e = set_smem(k, bytes)) return e;
  int dev = 0, sms = 0, fit = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) {
    return static_cast<int>(e);
  }
  if (const cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, k, kGatherThreads, bytes)) {
    return static_cast<int>(e);
  }
  blocks = min(blocks, max(fit, 1) * sms);
  k<<<blocks, kGatherThreads, bytes, s>>>(static_cast<const T*>(slab),
                                          static_cast<const int*>(idx), out, S, K, n, rep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int loops_gather_axis0(const void* src, const void* idx, void* out, int S,
                       int n4, int smem, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || n4 < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (smem) {
    const int bytes = S * kLanes * 4;
    if (const int e = set_smem(gather_axis0_kernel<true>, bytes)) return e;
    gather_axis0_kernel<true><<<blocks, kGatherThreads, bytes, s>>>(
        static_cast<const float*>(src), static_cast<const int4*>(idx),
        static_cast<float4*>(out), S, n4);
  } else {
    gather_axis0_kernel<false><<<blocks, kGatherThreads, 0, s>>>(
        static_cast<const float*>(src), static_cast<const int4*>(idx),
        static_cast<float4*>(out), S, n4);
  }
  return static_cast<int>(cudaGetLastError());
}

int loops_gather_axis1(const void* src, const void* idx, void* out, int rows,
                       int blocks, void* stream) {
  if (rows < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gather_axis1_kernel<<<blocks, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), static_cast<const int4*>(idx),
      static_cast<float4*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

int loops_row_gather(const void* slab, const void* idx, void* out, int S, int K,
                     int n, int bf16, int smem, int sum, int blocks,
                     void* stream) {
  if (S <= 0 || K <= 0 || K % 8 || n % K || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (sum) {
    return bf16 ? launch_rows<bf, float, true>(slab, idx, out, S, K, n, 1, smem, blocks, s)
                : launch_rows<float, float, true>(slab, idx, out, S, K, n, 1, smem, blocks, s);
  }
  return bf16 ? launch_rows<bf, bf, false>(slab, idx, out, S, K, n, 1, smem, blocks, s)
              : launch_rows<float, float, false>(slab, idx, out, S, K, n, 1, smem, blocks, s);
}

// G3: win [W, 128] bf16, idx [rows / Kc * 8, Kc] int32, out [rows, 128] f32
int loops_onehot_expand(const void* win, const void* idx, void* out, int W,
                        int Kc, int rows, int smem, int blocks, void* stream) {
  if (W <= 0 || Kc <= 0 || rows % Kc || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows<__nv_bfloat16, float, false>(win, idx, out, W, Kc, rows, 8, smem,
                                                  blocks, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
