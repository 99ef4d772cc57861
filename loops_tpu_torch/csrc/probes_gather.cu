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
// row_gather_kernel  replaces scripts/tpu_r4_gather_probe.py _dynload_run:
//   rows of a [S, 128] slab (f32 or bf16) gathered by idx, either summed
//   in groups of 8 (G1: out[g*8 + j] = sum_k0 slab[idx[g*K + k0 + j]], f32
//   sums in k0 order) or materialized (G2: out[r] = slab[idx[r]]). A warp
//   takes one output row, a lane 4 of its 128 values; a warp's indices are
//   loaded 32 at a time and passed by __shfl_sync. The slab sits in shared
//   memory (kSmem: S = 256) or is read through __ldg: from L2 at the
//   TPU's S and, for the most part, at the 169,343-row arxiv table (86.7
//   MB, whose rows recur); from device memory at a 2,097,152-row table,
//   over 10 times the 50 MB L2.
// onehot_expand_kernel  replaces tpu_r4_gather_probe.py g3_onehot_expand:
//   OH[Kc, W] @ win[W, 128] with a bf16 one-hot, on the tensor cores
//   (mma.sync m16n8k16, f32 sums). The one-hot is built in registers from
//   each row's index, straight into the A fragments; the bf16 window is
//   staged through shared memory in steps of 64 rows (W = 2048 is 512 KB)
//   and read by ldmatrix.trans. A CTA computes 128 rows x 128 columns,
//   each of its 8 warps 16 rows. Exact: each output is one window value
//   plus zeros.
//
// What bounds them: bytes for the gathers (what each index and output
// moves, plus the table once); operations for the one-hot expand
// (2 * W * 128 per row at 989 TFLOP/s bf16).
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

template <typename T, bool kSmem, bool kSum>
__global__ void __launch_bounds__(kGatherThreads)
row_gather_kernel(const T* __restrict__ slab, const int* __restrict__ idx,
                  void* __restrict__ out_, int S, int K, int n) {
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
    T* out = static_cast<T*>(out_);
    for (int b = w0 * 32; b < n; b += warps * 32) {  // 32 rows a warp a step
      const int mine = b + lane < n ? idx[b + lane] : 0;
      const int m = min(32, n - b);
      for (int q = 0; q < m; ++q) {
        const int r = __shfl_sync(kFull, mine, q);
        copy4(out + static_cast<size_t>(b + q) * kLanes + col,
              from + static_cast<size_t>(r) * kLanes + col, !kSmem);
      }
    }
  }
}

template <typename T>
int launch_rows(const void* slab, const void* idx, void* out, int S, int K,
                int n, int smem, int sum, int blocks, cudaStream_t s) {
  const int bytes = smem ? S * kLanes * static_cast<int>(sizeof(T)) : 0;
  const T* sl = static_cast<const T*>(slab);
  const int* ix = static_cast<const int*>(idx);
#define LOOPS_ROWS(SM, SU)                                          \
  {                                                                 \
    auto k = row_gather_kernel<T, SM, SU>;                          \
    if (const int e = set_smem(k, bytes)) return e;                 \
    k<<<blocks, kGatherThreads, bytes, s>>>(sl, ix, out, S, K, n);  \
  }
  if (smem && sum) LOOPS_ROWS(true, true)
  else if (smem) LOOPS_ROWS(true, false)
  else if (sum) LOOPS_ROWS(false, true)
  else LOOPS_ROWS(false, false)
#undef LOOPS_ROWS
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ G3
constexpr int kOhRows = 128;  // output rows per CTA, 16 per warp
constexpr int kOhStep = 64;   // window rows staged per step
constexpr int kOhLd = kLanes + 8;  // padded bf16 row: ldmatrix conflict-free

__device__ __forceinline__ unsigned onehot_pair(int i, int c) {
  // two bf16 (c, c + 1): 1.0 is 0x3f80; the lower column in the low half
  return (i == c ? 0x3f80u : 0u) | (i == c + 1 ? 0x3f800000u : 0u);
}

__global__ void __launch_bounds__(256)
onehot_expand_kernel(const __nv_bfloat16* __restrict__ win,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int W, int Kc) {
  __shared__ __align__(16) __nv_bfloat16 ws[kOhStep * kOhLd];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * kOhRows + warp * 16;
  const long long g = row0 / Kc;  // the block of Kc rows these belong to
  // the block's indices are the first of its 8 repeated idx rows
  const int* ib = idx + g * 8 * Kc + (row0 - g * Kc);
  const int i0 = ib[gid], i1 = ib[gid + 8];
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  for (int w0 = 0; w0 < W; w0 += kOhStep) {
    __syncthreads();
    for (int e = threadIdx.x; e < kOhStep * kLanes / 8; e += 256) {
      const int r = e / (kLanes / 8), q = e % (kLanes / 8);
      *reinterpret_cast<uint4*>(ws + r * kOhLd + 8 * q) =
          *reinterpret_cast<const uint4*>(win + static_cast<size_t>(w0 + r) * kLanes + 8 * q);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOhStep; k += 16) {
      const int c = w0 + k + 2 * tig;
      const unsigned a[4] = {onehot_pair(i0, c), onehot_pair(i1, c),
                             onehot_pair(i0, c + 8), onehot_pair(i1, c + 8)};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        unsigned b[2];
        loops_tc::ldmatrix_x2_trans(b, ws + (k + (lane & 15)) * kOhLd + j * 8);
        loops_tc::mma_bf16(acc[j], a, b);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(out + (row0 + gid + 8 * h) * kLanes + col) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
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
  return bf16 ? launch_rows<__nv_bfloat16>(slab, idx, out, S, K, n, smem, sum, blocks, s)
              : launch_rows<float>(slab, idx, out, S, K, n, smem, sum, blocks, s);
}

// win [W, 128] bf16, idx [rows / Kc * 8, Kc] int32, out [rows, 128] f32
int loops_onehot_expand(const void* win, const void* idx, void* out, int W,
                        int Kc, int rows, void* stream) {
  if (W <= 0 || W % kOhStep || Kc % kOhRows || rows % Kc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  onehot_expand_kernel<<<rows / kOhRows, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(win), static_cast<const int*>(idx),
      static_cast<float*>(out), W, Kc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
