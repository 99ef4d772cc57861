// K15 probes for Hopper (sm_90a): what a gathered element or row costs,
// from shared memory, from L2 and from device memory. These are the floors
// that K4's and K5's row gathers pay.
//
// gather_axis0_kernel  replaces scripts/tpu_r3_gather_probe.py probe_axis0:
//   out[i, j] = src[idx[i, j], j], src [S, 128] f32, idx [n, 128] int32.
//   An item is 4 neighbouring j of one row: one int4 of idx, one float4
//   out. At S <= 256 (128 KB) a CTA of 1024 threads stages src in shared
//   memory with row r's column j at r*128 + (j & 3)*32 + (j >> 2): lane l
//   reads component c at word c*32 + l of its row, so a warp's loads hit
//   32 banks (unpermuted, lanes l, l+8, l+16, l+24 shared one); a thread
//   keeps 4 items in flight, their index loads issued before any table
//   read (the first step's before the table is staged). S = 1024 (512
//   KB) is read through __ldg from L2 by CTAs of 256, an item at a time.
// gather_axis1_kernel  replaces tpu_r3_gather_probe.py probe_axis1:
//   out[i, j] = src[i, idx[i, j]]. A warp holds row i in registers (a
//   float4 a lane) and gathers inside the row by __shfl_sync.
// row_gather_sum_kernel  replaces scripts/tpu_r4_gather_probe.py
//   _dynload_run, sum (G1): rows of a [S, 128] slab (f32 or bf16) gathered
//   by idx and summed in groups of 8, out[g*8 + j] = sum_k0 slab[idx[g*K +
//   k0*8 + j]], f32 sums in k0 order from +0 (bit for bit the plain
//   version on any values). A warp takes one output row, a lane 4 of its
//   128 sums; the row's indices come 32 at a time, the next 32 loaded
//   ahead. f32 rows go 4 at a time, loaded before any is added, their
//   indices read 4 a load from the warp's slice of shared memory; bf16
//   rows one at a time by __shfl_sync, at 32 registers, so that 2048
//   threads run an SM. With the slab in shared memory (S = 256) a CTA of
//   1024 threads (32 warps on one 128 KB f32 table, or two CTAs on the
//   64 KB bf16 one) has it staged by one thread's bulk copy
//   (cp.async.bulk onto an mbarrier) while the first indices load; from
//   L2 or device memory CTAs of 256 read it through __ldg.
// row_gather_kernel  replaces _dynload_run, materialize (G2: out[r] =
//   slab[idx[r]]) and g3_onehot_expand (G3: out[g*K + k] =
//   f32(win[idx[(g*rep)*K + k]]), the first of the rep = 8 repeated idx
//   rows of each block of K output rows, each bf16 value widened to f32).
//   A warp takes one output row, a lane 4 of its 128 values; a warp's
//   indices are loaded 32 at a time and passed by __shfl_sync.
// Every grid is persistent (a grid-stride loop, cut to the CTAs the SMs
// hold at once), so each CTA stages its table once. The slab sits in
// shared memory when a CTA can hold it (G1/G2: S = 256; G3: W <= 512,
// 128 KB of bf16) or is read through __ldg: from L2 at the TPU's S and at
// G3's W = 2048 and, for the most part, at the 169,343-row arxiv table
// (86.7 MB, whose rows recur); from device memory at a 2,097,152-row
// table, over 10 times the 50 MB L2. G3 was a one-hot product on the
// TPU's MXU only because the TPU has no general gather; here it is the
// gather it computes, bit for bit.
//
// What bounds them: bytes, what each index and output moves, plus the
// table once (G3: the window, one idx row per block, the f32 rows). G1
// also reads N rows of 512 B that the bound does not count: from shared
// memory at 128 B a clock an SM they cost about 0.032-0.036 ms at N =
// 2,097,152, against the 0.0226 ms byte bound.
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
// Items (one int4 of idx, one float4 out) a thread keeps in flight, and
// the CTA of the shared-memory kernel: one staged table for 32 warps.
// From L2 one item at a time: more were slower (their random 4-byte
// reads run at the L2's rate, not its latency).
constexpr int kAxis0Items = 4;
constexpr int kAxis0SmemThreads = 1024;

// Load the indices of a thread's kU items of the step at e0 (items
// e0 + u * kThreads; those past n4 are not loaded).
template <int kThreads, int kU>
__device__ __forceinline__ void axis0_indices(int4 (&i)[kU], const int4* __restrict__ idx,
                                              long long e0, long long n4) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long e = e0 + static_cast<long long>(u) * kThreads;
    if (e < n4) i[u] = idx[e];
  }
}

// Item e covers out[e / 32, 4l .. 4l + 3], l = e mod 32, and every
// multiple of 32 that e steps by keeps l the thread's lane. In shared
// memory row r's column j sits at r * 128 + (j & 3) * 32 + (j >> 2):
// component c of lane l reads word c * 32 + l of its row, bank l, so a
// warp's 32 loads of one component hit 32 banks.
template <bool kSmem, int kThreads, int kU>
__global__ void __launch_bounds__(kThreads)
gather_axis0_kernel(const float* __restrict__ src, const int4* __restrict__ idx,
                    float4* __restrict__ out, int S, long long n4) {
  extern __shared__ float tab[];
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kThreads * kU;
  long long e0 = static_cast<long long>(blockIdx.x) * kThreads * kU + threadIdx.x;
  int4 i[kU];
  axis0_indices<kThreads, kU>(i, idx, e0, n4);  // in flight while the table is staged
  if (kSmem) {
    for (int e = threadIdx.x; e < S * kLanes / 4; e += kThreads) {
      const float4 v = reinterpret_cast<const float4*>(src)[e];
      float* t = tab + (e >> 5) * kLanes + lane;  // e mod 32 == lane
      t[0] = v.x;
      t[32] = v.y;
      t[64] = v.z;
      t[96] = v.w;
    }
    __syncthreads();
  }
  for (; e0 < n4; e0 += step) {
    float4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (e0 + static_cast<long long>(u) * kThreads >= n4) continue;
      if (kSmem) {
        const float* t = tab + lane;
        v[u] = make_float4(t[i[u].x * kLanes], t[i[u].y * kLanes + 32],
                           t[i[u].z * kLanes + 64], t[i[u].w * kLanes + 96]);
      } else {
        const float* f = src + 4 * lane;
        v[u] = make_float4(__ldg(f + i[u].x * kLanes), __ldg(f + i[u].y * kLanes + 1),
                           __ldg(f + i[u].z * kLanes + 2), __ldg(f + i[u].w * kLanes + 3));
      }
    }
    axis0_indices<kThreads, kU>(i, idx, e0 + step, n4);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long e = e0 + static_cast<long long>(u) * kThreads;
      if (e < n4) out[e] = v[u];
    }
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

// ------------------------------------------------------------------ G1
// f32 rows a warp loads before it adds any of them, and the CTA that
// shares one staged table.
constexpr int kSumRows = 4;
constexpr int kSumSmemThreads = 1024;

// Output row o = g * 8 + j sums rows idx[g*K + k0*8 + j], k0 = 0 .. K/8 - 1,
// in k0 order from +0: a warp takes one output row at a time, a lane 4
// of its 128 sums. The row's indices come 32 at a time, one a lane, the
// next 32 (of this row or the warp's next) loaded before this chunk's
// rows. At kR == 1 they pass by __shfl_sync and each row is added as it
// lands. At kR > 1 (a multiple of 4) the warp writes them to its 32 ints
// of shared memory and reads them back 4 a load (one broadcast in place
// of 4 shuffles), and a chunk's rows go kR at a time: all kR loads are
// issued, then added in k0 order.
template <typename T, bool kSmem, int kThreads, int kR>
__global__ void __launch_bounds__(kThreads)
row_gather_sum_kernel(const T* __restrict__ slab, const int* __restrict__ idx,
                      float* __restrict__ out, int S, int K, int n) {
  static_assert(kR == 1 || kR % 4 == 0, "rows in flight: 1 or a multiple of 4");
  extern __shared__ __align__(16) unsigned char gsmem[];
  __shared__ __align__(8) unsigned long long staged;  // the table's mbarrier
  constexpr int kWarps = kThreads / 32;
  __shared__ __align__(16) int ibuf[kR > 1 ? kWarps : 1][32];
  const int lane = threadIdx.x & 31, col = 4 * lane;
  const int warps = gridDim.x * kWarps;
  const int per = K / 8, outs = n / K * 8;
  const T* from = slab;
  const unsigned bar = loops_tc::smem_addr(&staged);
  if (kSmem) {
    if (threadIdx.x == 0) {
      const unsigned bytes = S * kLanes * static_cast<unsigned>(sizeof(T));
      loops_tc::mbar_init(bar, 1);
      loops_tc::mbar_expect_tx(bar, bytes);
      loops_tc::bulk_copy(gsmem, slab, bytes, bar);
    }
    from = reinterpret_cast<const T*>(gsmem);
  }
  // the chunk (o, b): indices b .. b + 31 of output row o
  auto index = [&](int o, int b) {
    return o < outs && b + lane < per
               ? idx[static_cast<size_t>(o >> 3) * K + (o & 7) + (b + lane) * 8]
               : 0;
  };
  int* wbuf = ibuf[kR > 1 ? threadIdx.x >> 5 : 0];
  int o = blockIdx.x * kWarps + (threadIdx.x >> 5), b = 0;
  int mine = index(o, b);  // in flight while the table is copied
  if (kSmem) {
    __syncthreads();  // the barrier is initialized
    loops_tc::mbar_wait(bar, 0);
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  while (o < outs) {  // the same trip count for the whole warp
    int o2 = o, b2 = b + 32;
    if (b2 >= per) {
      o2 = o + warps;
      b2 = 0;
    }
    const int next = index(o2, b2);
    const int m = min(32, per - b);
    if constexpr (kR == 1) {
      for (int q = 0; q < m; ++q) {
        const int r = __shfl_sync(kFull, mine, q);
        const float4 v = load4(from + static_cast<size_t>(r) * kLanes + col, !kSmem);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    } else {
      __syncwarp();
      wbuf[lane] = mine;
      __syncwarp();
      for (int q = 0; q < m; q += kR) {
        int r[kR];
#pragma unroll
        for (int u = 0; u < kR; u += 4) {
          const int4 t = *reinterpret_cast<const int4*>(wbuf + ((q + u) & 31));
          r[u] = t.x;
          r[u + 1] = t.y;
          r[u + 2] = t.z;
          r[u + 3] = t.w;
        }
        float4 v[kR];
#pragma unroll
        for (int u = 0; u < kR; ++u) {
          if (q + u < m) v[u] = load4(from + static_cast<size_t>(r[u]) * kLanes + col, !kSmem);
        }
#pragma unroll
        for (int u = 0; u < kR; ++u) {
          if (q + u < m) {
            acc.x += v[u].x;
            acc.y += v[u].y;
            acc.z += v[u].z;
            acc.w += v[u].w;
          }
        }
      }
    }
    if (b2 == 0) {
      reinterpret_cast<float4*>(out + static_cast<size_t>(o) * kLanes)[lane] = acc;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    o = o2;
    b = b2;
    mine = next;
  }
}

// ---------------------------------------------------------------- G2, G3
// O: the materialized rows' type (T, or f32 for G3)
template <typename T, typename O, bool kSmem>
__global__ void __launch_bounds__(kGatherThreads)
row_gather_kernel(const T* __restrict__ slab, const int* __restrict__ idx,
                  O* __restrict__ out, int S, int K, int n, int rep) {
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
  // output row o reads idx[o + (o / K) * (rep - 1) * K]: the first of
  // the rep idx rows of its block of K (G2: rep = 1, idx[o])
  for (int b = w0 * 32; b < n; b += warps * 32) {  // 32 rows a warp a step
    const int o = b + lane;
    const int mine =
        o < n ? idx[static_cast<size_t>(o) + static_cast<size_t>(o / K) * (rep - 1) * K] : 0;
    const int m = min(32, n - b);
    for (int q = 0; q < m; ++q) {
      const int r = __shfl_sync(kFull, mine, q);
      copy4(out + static_cast<size_t>(b + q) * kLanes + col,
            from + static_cast<size_t>(r) * kLanes + col, !kSmem);
    }
  }
}

// The grid is persistent: at most `blocks` CTAs, and no more than the SMs
// hold at once, so that no CTA waits for a second wave with its share of
// the rows.
template <typename K>
int launch_one_wave(K k, int threads, int bytes, int& blocks) {
  if (const int e = set_smem(k, bytes)) return e;
  int dev = 0, sms = 0, fit = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) {
    return static_cast<int>(e);
  }
  if (const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, k, threads, bytes)) {
    return static_cast<int>(e);
  }
  blocks = min(blocks, max(fit, 1) * sms);
  return 0;
}

template <typename T, typename O>
int launch_rows(const void* slab, const void* idx, void* out, int S, int K, int n, int rep,
                int smem, int blocks, cudaStream_t s) {
  const int bytes = smem ? S * kLanes * static_cast<int>(sizeof(T)) : 0;
  auto k = smem ? row_gather_kernel<T, O, true> : row_gather_kernel<T, O, false>;
  if (const int e = launch_one_wave(k, kGatherThreads, bytes, blocks)) return e;
  k<<<blocks, kGatherThreads, bytes, s>>>(static_cast<const T*>(slab),
                                          static_cast<const int*>(idx), static_cast<O*>(out), S,
                                          K, n, rep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSmem, int kThreads, int kR>
int launch_sum_as(const void* slab, const void* idx, void* out, int S, int K, int n, int blocks,
                  cudaStream_t s) {
  const int bytes = kSmem ? S * kLanes * static_cast<int>(sizeof(T)) : 0;
  auto k = row_gather_sum_kernel<T, kSmem, kThreads, kR>;
  if (const int e = launch_one_wave(k, kThreads, bytes, blocks)) return e;
  k<<<blocks, kThreads, bytes, s>>>(static_cast<const T*>(slab), static_cast<const int*>(idx),
                                    static_cast<float*>(out), S, K, n);
  return static_cast<int>(cudaGetLastError());
}

// f32 rows 4 in flight a warp (the f32 table leaves one CTA an SM); bf16
// one, at the 32 registers that let 2048 threads run an SM
template <typename T>
int launch_sum(const void* slab, const void* idx, void* out, int S, int K, int n, int smem,
               int blocks, cudaStream_t s) {
  constexpr int kR = sizeof(T) == 4 ? kSumRows : 1;
  return smem ? launch_sum_as<T, true, kSumSmemThreads, kR>(slab, idx, out, S, K, n, blocks, s)
              : launch_sum_as<T, false, kGatherThreads, kR>(slab, idx, out, S, K, n, blocks, s);
}

template <bool kSmem, int kThreads, int kU>
int launch_axis0(const void* src, const void* idx, void* out, int S, int n4, int blocks,
                 cudaStream_t s) {
  const int bytes = kSmem ? S * kLanes * 4 : 0;
  auto k = gather_axis0_kernel<kSmem, kThreads, kU>;
  if (const int e = launch_one_wave(k, kThreads, bytes, blocks)) return e;
  k<<<blocks, kThreads, bytes, s>>>(static_cast<const float*>(src),
                                    static_cast<const int4*>(idx), static_cast<float4*>(out), S,
                                    n4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int loops_gather_axis0(const void* src, const void* idx, void* out, int S,
                       int n4, int smem, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || n4 < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return smem ? launch_axis0<true, kAxis0SmemThreads, kAxis0Items>(src, idx, out, S, n4, blocks, s)
              : launch_axis0<false, kGatherThreads, 1>(src, idx, out, S, n4, blocks, s);
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
    return bf16 ? launch_sum<bf>(slab, idx, out, S, K, n, smem, blocks, s)
                : launch_sum<float>(slab, idx, out, S, K, n, smem, blocks, s);
  }
  return bf16 ? launch_rows<bf, bf>(slab, idx, out, S, K, n, 1, smem, blocks, s)
              : launch_rows<float, float>(slab, idx, out, S, K, n, 1, smem, blocks, s);
}

// G3: win [W, 128] bf16, idx [rows / Kc * 8, Kc] int32, out [rows, 128] f32
int loops_onehot_expand(const void* win, const void* idx, void* out, int W,
                        int Kc, int rows, int smem, int blocks, void* stream) {
  if (W <= 0 || Kc <= 0 || rows % Kc || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows<__nv_bfloat16, float>(win, idx, out, W, Kc, rows, 8, smem, blocks,
                                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
