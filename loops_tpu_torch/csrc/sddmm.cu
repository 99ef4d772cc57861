// SDDMM (sampled dense-dense matrix products) for Hopper (sm_90a): the
// second half of the GNN primitive pair, per CSR nonzero or per BCSR block.
//
// K5  sddmm_flat_kernel  replaces loops_tpu/ops/kernels/sddmm_flat.py
//                        flat_sddmm_pallas
// K10 sddmm_bcsr_kernel  replaces loops_tpu/ops/kernels/sddmm_bcsr.py
//                        bcsr_sddmm_pallas
//
// Neither kernel uses atomics or a seam: every output element is summed by
// one thread (K10) or one fixed shuffle tree (K5), so two applies are
// bitwise equal.
//
// ---------------------------------------------------------------- K5
// out[e] = sum_f bf16(A[row_e, f]) * bf16(vals_e * bf16(B[col_e, f])), f32
// products and sums, f32 out [nnz], over a work_oriented FlatBlockPlan of K
// atoms per block (every block full but the last, so slot b*K + s IS atom e
// and the output is in storage order). The row of slot s of block b is
// tile_starts[b] + rel[b*K + s]. The rounding is the TPU kernel's: vals are
// folded into the gathered B row, rounded to bf16 (sddmm_flat.py:166-167),
// and multiplied by the bf16 A row; a bf16 x bf16 product is exact in f32,
// so only the f32 sum's order differs from the TPU.
//
// Design: a group of G lanes (4, 8, 16 or 32, the power of two that covers
// F in VEC-wide pieces) per atom; lane j reads pieces j, j+G, ... of the A
// and B rows (16-byte loads when VEC = 4), rounds them to bf16 in
// registers, folds vals in, and sums its products in order; then a fixed
// xor-shuffle tree over the group. The ragged end of F is masked (the TPU
// padded F to 128 lanes with zeros). Dropped with the TPU mechanism: the
// 16-row-aligned A windows and their clamping, the power-of-two RW, the
// rw_cap and "fewer than RW rows" refusals, GROUP padding, the one-hot MXU
// expansion of A, the eye-mask transposes, and the [B_blk*K, Fp] gb array
// XLA wrote before the kernel (here the B row is gathered and scaled in
// registers).
//
// What bounds K5 on an H100: bytes. A and B are read as f32 (F * 8 bytes
// per nonzero, the A row mostly from L1/L2 since consecutive atoms share a
// row, the B row a random gather from L2 when B fits its 50 MB), 2 flops
// per feature.
//
// ---------------------------------------------------------------- K10
// out[t] = vals[t] .* (A[i*R:(i+1)*R, :] @ B[k*C:(k+1)*C, :]^T), f32 [NB, R,
// C], for stored block t at block row i, block column k (R % 8 == 0, C % 128
// == 0, as the TPU kernel requires). IEEE f32 with fmaf, never TF32: each
// (r, c) is summed over all of F in order, then scaled by vals once
// (sddmm_bcsr.py:59-61).
//
// Design: one CTA of 128 threads per (stored block, sub-tile of ROWS rows x
// 128 columns), ROWS = 16 when R % 16 == 0 else 8. The TPU's innermost grid
// axis over feature tiles becomes the CTA's own loop: A [ROWS, FT] (stored
// transposed, so a thread reads its ROWS values as float4 broadcasts) and B
// [128, FT] (row pitch FT + 1, so the 128 threads read distinct banks) are
// staged in shared memory per FT = 64 columns; thread c keeps ROWS sums of
// column c in registers. Rows of A past `rows` and of B past `cols` load as
// zeros (the JAX side pads both). What bounds K10 on an H100: 2 * R * C * F
// flops per block on the CUDA cores (67 TFLOP/s f32); the A and B tiles
// come mostly from L2.
//
// Offsets into A, B, vals and out are 64-bit. Each C entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------- K5
constexpr int kFlatThreads = 256;

template <int VEC>
struct Piece;
template <>
struct Piece<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};
template <>
struct Piece<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

template <int G, int VEC>
__global__ void __launch_bounds__(kFlatThreads)
sddmm_flat_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                  const int* __restrict__ rel,
                  const int* __restrict__ tile_starts,
                  const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ out, int nnz, int K, int F) {
  const int lane = threadIdx.x % G;
  const long long e =
      static_cast<long long>(blockIdx.x) * (kFlatThreads / G) + threadIdx.x / G;
  // whole groups leave together, so the shuffles below see full groups
  if (e >= nnz) return;
  const int row = tile_starts[e / K] + rel[e];
  const float v = vals[e];
  const float* arow = A + static_cast<long long>(row) * F;
  const float* brow = B + static_cast<long long>(cols[e]) * F;
  float acc = 0.f;
  for (int f = lane * VEC; f < F; f += G * VEC) {
    float a[VEC], b[VEC];
    Piece<VEC>::load(arow + f, a);
    Piece<VEC>::load(brow + f, b);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      acc = fmaf(bf16r(a[k]), bf16r(__fmul_rn(v, bf16r(b[k]))), acc);
    }
  }
  // lanes of one group are G consecutive lanes of a warp, G a power of two
  const unsigned mask = G == 32 ? 0xffffffffu
                                : ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(mask, acc, off));
  }
  if (lane == 0) out[e] = acc;
}

template <int G>
int launch_flat(const float* vals, const int* cols, const int* rel,
                const int* ts, const float* A, const float* B, float* out,
                int nnz, int K, int F, int vec, cudaStream_t s) {
  const long long per = kFlatThreads / G;
  const long long blocks = (nnz + per - 1) / per;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec == 4) {
    sddmm_flat_kernel<G, 4><<<grid, kFlatThreads, 0, s>>>(
        vals, cols, rel, ts, A, B, out, nnz, K, F);
  } else {
    sddmm_flat_kernel<G, 1><<<grid, kFlatThreads, 0, s>>>(
        vals, cols, rel, ts, A, B, out, nnz, K, F);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K10
constexpr int kBcsrThreads = 128;  // one per column of a 128-wide sub-tile
constexpr int kFT = 64;            // feature tile staged in shared memory

template <int ROWS>
__global__ void __launch_bounds__(kBcsrThreads)
sddmm_bcsr_kernel(const int* __restrict__ brow, const int* __restrict__ bcols,
                  const float* __restrict__ vals, const float* __restrict__ A,
                  const float* __restrict__ B, float* __restrict__ out, int R,
                  int C, int rows, int cols, int F) {
  __shared__ __align__(16) float sA[kFT * ROWS];        // [f][r]
  __shared__ float sB[kBcsrThreads * (kFT + 1)];        // [c][f], pitch FT+1
  const int t = blockIdx.x;
  const int subs_c = C / kBcsrThreads;
  const int r0 = (blockIdx.y / subs_c) * ROWS;
  const int c0 = (blockIdx.y % subs_c) * kBcsrThreads;
  const long long arow0 = static_cast<long long>(brow[t]) * R + r0;
  const long long bcol0 = static_cast<long long>(bcols[t]) * C + c0;
  const int c = threadIdx.x;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int f0 = 0; f0 < F; f0 += kFT) {
    const int fn = min(kFT, F - f0);
    __syncthreads();  // the previous tile has been read
    for (int i = threadIdx.x; i < ROWS * kFT; i += kBcsrThreads) {
      const int r = i / kFT, f = i % kFT;
      const long long ar = arow0 + r;
      sA[f * ROWS + r] =
          (ar < rows && f < fn) ? __ldg(A + ar * F + f0 + f) : 0.f;
    }
    for (int i = threadIdx.x; i < kBcsrThreads * kFT; i += kBcsrThreads) {
      const int cc = i / kFT, f = i % kFT;
      const long long bc = bcol0 + cc;
      sB[cc * (kFT + 1) + f] =
          (bc < cols && f < fn) ? __ldg(B + bc * F + f0 + f) : 0.f;
    }
    __syncthreads();
    for (int f = 0; f < fn; ++f) {
      const float b = sB[c * (kFT + 1) + f];
#pragma unroll
      for (int r = 0; r < ROWS; r += 4) {
        const float4 a = *reinterpret_cast<const float4*>(sA + f * ROWS + r);
        acc[r] = fmaf(a.x, b, acc[r]);
        acc[r + 1] = fmaf(a.y, b, acc[r + 1]);
        acc[r + 2] = fmaf(a.z, b, acc[r + 2]);
        acc[r + 3] = fmaf(a.w, b, acc[r + 3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long o = (static_cast<long long>(t) * R + r0 + r) * C + c0 + c;
    out[o] = __fmul_rn(__ldg(vals + o), acc[r]);
  }
}

}  // namespace

extern "C" {

int loops_sddmm_flat(const void* vals, const void* cols, const void* rel,
                     const void* tile_starts, const void* A, const void* B,
                     void* out, int nnz, int K, int F, int vec, int group,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(vals);
  const auto* c = static_cast<const int*>(cols);
  const auto* r = static_cast<const int*>(rel);
  const auto* ts = static_cast<const int*>(tile_starts);
  const auto* a = static_cast<const float*>(A);
  const auto* b = static_cast<const float*>(B);
  auto* o = static_cast<float*>(out);
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  switch (group) {
    case 4: return launch_flat<4>(v, c, r, ts, a, b, o, nnz, K, F, vec, s);
    case 8: return launch_flat<8>(v, c, r, ts, a, b, o, nnz, K, F, vec, s);
    case 16: return launch_flat<16>(v, c, r, ts, a, b, o, nnz, K, F, vec, s);
    case 32: return launch_flat<32>(v, c, r, ts, a, b, o, nnz, K, F, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int loops_bcsr_sddmm_f32(const void* brow, const void* bcols,
                         const void* vals, const void* A, const void* B,
                         void* out, int nb, int R, int C, int rows, int cols,
                         int F, int rows_per_cta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R % rows_per_cta || C % kBcsrThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long subs =
      static_cast<long long>(R / rows_per_cta) * (C / kBcsrThreads);
  if (subs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nb, static_cast<unsigned>(subs));
  const auto* br = static_cast<const int*>(brow);
  const auto* bc = static_cast<const int*>(bcols);
  const auto* v = static_cast<const float*>(vals);
  const auto* a = static_cast<const float*>(A);
  const auto* b = static_cast<const float*>(B);
  auto* o = static_cast<float*>(out);
  if (rows_per_cta == 16) {
    sddmm_bcsr_kernel<16><<<grid, kBcsrThreads, 0, s>>>(br, bc, v, a, b, o, R,
                                                        C, rows, cols, F);
  } else if (rows_per_cta == 8) {
    sddmm_bcsr_kernel<8><<<grid, kBcsrThreads, 0, s>>>(br, bc, v, a, b, o, R,
                                                       C, rows, cols, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
