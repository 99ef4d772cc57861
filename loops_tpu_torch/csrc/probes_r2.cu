// K14 probes for Hopper (sm_90a): the per-chunk cost of the BCSR block
// product and of its shared-memory scatter accumulator.
//
// block_dot_f32_kernel / block_dot_bf16_kernel  replace
//   scripts/tpu_r2_probe.py dot_probe: acc += A[c] @ B over NCH chunks of
//   A [M, 128] (M in {8, 64, 128}), B [128, 512] resident or a distinct
//   B[c] streamed per chunk, `passes` sweeps over the chunks inside one
//   launch (the TPU's reps), so the slope over passes is the cost of one
//   sweep. Every product is consumed: a CTA owns a column tile of acc and
//   a strided share of the chunks, keeps its share of acc in registers
//   across all its chunks and passes, and writes it to partial[g] at the
//   end; the wrapper sums the partials over g. (The TPU kept an [8, 128]
//   corner; on the card a corner alone would let the compiler drop the
//   rest.)
//   * f32: IEEE fmaf on the CUDA cores, the unit of K7 and K9. A chunk and
//     the CTA's B tile are staged in shared memory; each thread holds a
//     register tile of rows x 4 columns, one float4 of B and a broadcast
//     of A per k. Bound: 67 TFLOP/s.
//   * bf16: A and B in bf16, f32 sums, on the tensor cores with mma.sync
//     m16n8k16 (what the TPU's MXU did at default precision). Fragments
//     come from shared memory by ldmatrix (B with .trans), rows padded by
//     16 bytes so that the eight 16-byte rows of a fragment fall in eight
//     bank groups. Bound: 989 TFLOP/s.
//   Neither overlaps the staging of a chunk with its products: what a
//   chunk costs is the question.
// scatter_smem_kernel / scatter_l2_kernel  replace tpu_r2_probe.py
//   scatter_probe: per chunk, KCH = 8 accumulates of an (R = 8, F) slab
//   into a resident accumulator at offsets that are random multiples of R.
//   One thread owns each (row-in-block j, feature f), as in K7: it adds
//   every slab row j into acc[off * R + j][f], so no two threads touch one
//   element and no atomics are needed.
//   * smem: the accumulator a CTA can hold, K7's 256 rows x 64 features
//     (64 KB of shared memory); the 512 features run as 8 CTA column
//     tiles, and the chunks are shared over `groups` CTAs per tile, each
//     with its own accumulator, summed by the wrapper.
//   * l2: the TPU's [4096, 512] f32 accumulator (8 MB) in device memory,
//     where it lies in the 50 MB L2: one thread per (j, f), 4096 in all.
//
// C entry points return cudaGetLastError().
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

using loops_tc::ldmatrix_x2_trans;
using loops_tc::ldmatrix_x4;
using loops_tc::mma_bf16;
using loops_tc::set_smem;

constexpr int kK = 128;    // the contraction: A chunks are [M, 128]
constexpr int kN = 512;    // B is [128, 512]
constexpr int kDotThreads = 256;
constexpr int kApad = kK + 1;  // f32 A rows padded: rows in distinct banks

// ------------------------------------------------------------- f32 dot
template <int M>
struct F32Tile {
  static constexpr int NT = M >= 16 ? 64 : 128;         // columns per CTA
  static constexpr int C4 = NT / 4;                      // threads per row group
  static constexpr int RPT = M * NT / (kDotThreads * 4);  // rows per thread
  static constexpr int kSmemFloats = M * kApad + kK * NT;
};

// the CTA's [kK][NT] column tile of src [kK][kN] into shared memory
template <int NT>
__device__ __forceinline__ void stage_b_f32(float* Bs, const float* src, int n0) {
  for (int e = threadIdx.x; e < kK * NT / 4; e += kDotThreads) {
    const int k = e / (NT / 4), q = e % (NT / 4);
    reinterpret_cast<float4*>(Bs)[e] =
        reinterpret_cast<const float4*>(src + static_cast<size_t>(k) * kN + n0)[q];
  }
}

// (min 1 CTA per SM: without it ptxas held M = 8 to 32 registers and
// spilled)
template <int M>
__global__ void __launch_bounds__(kDotThreads, 1)
block_dot_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ partial, int nch, int stream_b,
                     int passes) {
  using T = F32Tile<M>;
  extern __shared__ float smem[];
  float* As = smem;               // [M][kApad]
  float* Bs = smem + M * kApad;   // [kK][NT]
  const int t = threadIdx.x;
  const int c4 = t % T::C4, rg = t / T::C4;
  const int n0 = blockIdx.x * T::NT;
  const int g = blockIdx.y, groups = gridDim.y;
  float acc[T::RPT][4];
#pragma unroll
  for (int i = 0; i < T::RPT; ++i)
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  if (!stream_b) stage_b_f32<T::NT>(Bs, B, n0);
  for (int p = 0; p < passes; ++p) {
    for (int c = g; c < nch; c += groups) {
      __syncthreads();  // the previous chunk's reads are done
      const float4* a4 = reinterpret_cast<const float4*>(A + static_cast<size_t>(c) * M * kK);
      for (int e = t; e < M * kK / 4; e += kDotThreads) {
        const float4 v = a4[e];
        const int r = (4 * e) / kK, k = (4 * e) % kK;
        float* dst = As + r * kApad + k;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
      if (stream_b) stage_b_f32<T::NT>(Bs, B + static_cast<size_t>(c) * kK * kN, n0);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kK; ++k) {
        const float4 b = reinterpret_cast<const float4*>(Bs + k * T::NT)[c4];
#pragma unroll
        for (int i = 0; i < T::RPT; ++i) {
          const float a = As[(rg * T::RPT + i) * kApad + k];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < T::RPT; ++i) {
    const int r = rg * T::RPT + i;
    reinterpret_cast<float4*>(partial + (static_cast<size_t>(g) * M + r) * kN + n0)[c4] =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ------------------------------------------------------------ bf16 dot
constexpr int kBfPad = 8;  // bf16 rows padded by 16 bytes

// A CTA of 4 warps. M = 8: one 16-row tile (rows 8..15 zero), the warps
// side by side over 256 columns. M = 64: a 16-row tile per warp, 64
// columns. M = 128: two 16-row tiles per warp, 64 columns.
template <int M>
struct Bf16Tile {
  static constexpr int kWarps = 4;
  static constexpr int MP = M < 16 ? 16 : M;                  // padded rows
  static constexpr int MT = MP / 16 / (M >= 64 ? kWarps : 1);  // m-tiles per warp
  static constexpr int WN = M >= 64 ? 1 : kWarps;              // warps along n
  static constexpr int NT = 64 * WN;                           // columns per CTA
  static constexpr int LDA = kK + kBfPad, LDB = NT + kBfPad;
  static constexpr int kSmemHalves = MP * LDA + kK * LDB;
};

// the CTA's [kK][NT] column tile of src [kK][kN] into rows of LDB halves
template <int NT, int LDB>
__device__ __forceinline__ void stage_b_bf16(__nv_bfloat16* Bs,
                                             const __nv_bfloat16* src, int n0) {
  constexpr int V = NT / 8;  // 16-byte pieces per row
  for (int e = threadIdx.x; e < kK * V; e += 128) {
    const int k = e / V, q = e % V;
    *reinterpret_cast<uint4*>(Bs + k * LDB + 8 * q) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(k) * kN + n0 + 8 * q);
  }
}

template <int M>
__global__ void __launch_bounds__(128)
block_dot_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                      const __nv_bfloat16* __restrict__ B,
                      float* __restrict__ partial, int nch, int stream_b,
                      int passes) {
  using T = Bf16Tile<M>;
  extern __shared__ __align__(16) __nv_bfloat16 hsmem[];
  __nv_bfloat16* As = hsmem;                 // [MP][LDA]
  __nv_bfloat16* Bs = hsmem + T::MP * T::LDA;  // [kK][LDB]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n0 = blockIdx.x * T::NT;
  const int g = blockIdx.y, groups = gridDim.y;
  const int wm = M >= 64 ? warp : 0, wn = M >= 64 ? 0 : warp;
  float acc[T::MT][8][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  if (M < 16) {  // the pad rows stay zero
    for (int e = t; e < (T::MP - M) * T::LDA; e += 128) {
      As[M * T::LDA + e] = __float2bfloat16(0.f);
    }
  }
  if (!stream_b) stage_b_bf16<T::NT, T::LDB>(Bs, B, n0);
  for (int p = 0; p < passes; ++p) {
    for (int c = g; c < nch; c += groups) {
      __syncthreads();
      const __nv_bfloat16* a = A + static_cast<size_t>(c) * M * kK;
      for (int e = t; e < M * kK / 8; e += 128) {
        const int r = e / (kK / 8), q = e % (kK / 8);
        *reinterpret_cast<uint4*>(As + r * T::LDA + 8 * q) =
            *reinterpret_cast<const uint4*>(a + r * kK + 8 * q);
      }
      if (stream_b) {
        stage_b_bf16<T::NT, T::LDB>(Bs, B + static_cast<size_t>(c) * kK * kN, n0);
      }
      __syncthreads();
#pragma unroll 2
      for (int k0 = 0; k0 < kK; k0 += 16) {
        unsigned af[T::MT][4];
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          const int row = (wm * T::MT + i) * 16 + (lane & 15);
          ldmatrix_x4(af[i], As + row * T::LDA + k0 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          unsigned bf[2];
          ldmatrix_x2_trans(bf, Bs + (k0 + (lane & 15)) * T::LDB + wn * 64 + j * 8);
#pragma unroll
          for (int i = 0; i < T::MT; ++i) mma_bf16(acc[i][j], af[i], bf);
        }
      }
    }
  }
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn * 64 + j * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wm * T::MT + i) * 16 + gid + 8 * h;
        if (row < M) {
          *reinterpret_cast<float2*>(partial + (static_cast<size_t>(g) * M + row) * kN + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

template <int M>
int launch_dot(int bf16, const void* A, const void* B, void* partial, int nch,
               int stream_b, int passes, int groups, cudaStream_t s) {
  if (bf16) {
    using T = Bf16Tile<M>;
    const int bytes = T::kSmemHalves * 2;
    auto k = block_dot_bf16_kernel<M>;
    if (const int e = set_smem(k, bytes)) return e;
    k<<<dim3(kN / T::NT, groups), 128, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
        static_cast<float*>(partial), nch, stream_b, passes);
  } else {
    using T = F32Tile<M>;
    const int bytes = T::kSmemFloats * 4;
    auto k = block_dot_f32_kernel<M>;
    if (const int e = set_smem(k, bytes)) return e;
    k<<<dim3(kN / T::NT, groups), kDotThreads, bytes, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<float*>(partial), nch, stream_b, passes);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- scatter
constexpr int kScatterFT = 64;  // features per CTA of the smem accumulator

// thread (j, f) of a CTA: j = threadIdx.x / 64, f = threadIdx.x % 64
__global__ void __launch_bounds__(1024)
scatter_smem_kernel(const int* __restrict__ offs, const float* __restrict__ a,
                    float* __restrict__ partial, int nch, int kch, int rr,
                    int F, int acc_rows, int passes) {
  extern __shared__ float acc[];  // [acc_rows][kScatterFT]
  const int j = threadIdx.x / kScatterFT, f = threadIdx.x % kScatterFT;
  const int f0 = blockIdx.x * kScatterFT;
  const int g = blockIdx.y, groups = gridDim.y;
  // this thread owns rows r with r % rr == j, column f
  for (int r = j; r < acc_rows; r += rr) acc[r * kScatterFT + f] = 0.f;
  const size_t slab = static_cast<size_t>(kch) * rr * F;
  for (int p = 0; p < passes; ++p) {
    for (int c = g; c < nch; c += groups) {
      const float* ac = a + c * slab + static_cast<size_t>(j) * F + f0 + f;
      for (int i = 0; i < kch; ++i) {
        const int row = offs[c * kch + i] * rr + j;
        acc[row * kScatterFT + f] += ac[static_cast<size_t>(i) * rr * F];
      }
    }
  }
  for (int r = j; r < acc_rows; r += rr) {
    partial[(static_cast<size_t>(g) * acc_rows + r) * F + f0 + f] =
        acc[r * kScatterFT + f];
  }
}

// thread T of the grid: j = T / F, f = T % F; acc is [acc_rows][F]
__global__ void __launch_bounds__(256)
scatter_l2_kernel(const int* __restrict__ offs, const float* __restrict__ a,
                  float* __restrict__ acc, int nch, int kch, int rr, int F,
                  int acc_rows, int passes) {
  const int T = blockIdx.x * blockDim.x + threadIdx.x;
  if (T >= rr * F) return;
  const int j = T / F, f = T % F;
  for (int r = j; r < acc_rows; r += rr) acc[static_cast<size_t>(r) * F + f] = 0.f;
  const size_t slab = static_cast<size_t>(kch) * rr * F;
  for (int p = 0; p < passes; ++p) {
    for (int c = 0; c < nch; ++c) {
      const float* ac = a + c * slab + static_cast<size_t>(j) * F + f;
      for (int i = 0; i < kch; ++i) {
        const size_t row = static_cast<size_t>(offs[c * kch + i]) * rr + j;
        acc[row * F + f] += ac[static_cast<size_t>(i) * rr * F];
      }
    }
  }
}

}  // namespace

extern "C" {

// A [nch, M, 128], B [128, 512] or [nch, 128, 512] (f32, or bf16 when
// bf16), partial [groups, M, 512] f32
int loops_block_dot(const void* A, const void* B, void* partial, int nch,
                    int M, int stream_b, int passes, int groups, int bf16,
                    void* stream) {
  if (nch <= 0 || passes < 0 || groups <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 8: return launch_dot<8>(bf16, A, B, partial, nch, stream_b, passes, groups, s);
    case 64: return launch_dot<64>(bf16, A, B, partial, nch, stream_b, passes, groups, s);
    case 128: return launch_dot<128>(bf16, A, B, partial, nch, stream_b, passes, groups, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// smem: out is partial [groups, acc_rows, F]; else out is acc [acc_rows, F]
int loops_scatter_probe(const void* offs, const void* a, void* out, int nch,
                        int kch, int rr, int F, int acc_rows, int passes,
                        int groups, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nch <= 0 || kch <= 0 || rr <= 0 || passes < 0 || acc_rows % rr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem) {
    const int bytes = acc_rows * kScatterFT * 4;
    if (F % kScatterFT || rr * kScatterFT > 1024 || groups <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (const int e = set_smem(scatter_smem_kernel, bytes)) return e;
    scatter_smem_kernel<<<dim3(F / kScatterFT, groups), rr * kScatterFT, bytes, s>>>(
        static_cast<const int*>(offs), static_cast<const float*>(a),
        static_cast<float*>(out), nch, kch, rr, F, acc_rows, passes);
  } else {
    scatter_l2_kernel<<<(rr * F + 255) / 256, 256, 0, s>>>(
        static_cast<const int*>(offs), static_cast<const float*>(a),
        static_cast<float*>(out), nch, kch, rr, F, acc_rows, passes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
