// CSR SpMM for Hopper (sm_90a): C[rows, F] = A(csr) @ B[cols, F], f32 out.
//
// K4 — replaces loops_tpu/ops/kernels/spmm_flat.py flat_spmm_pallas
// (schedule='merge_path', impl='pallas'; the GCN aggregation, forward and,
// over A^T, its gradient). It works over a merge-path FlatBlockPlan: each
// plan block holds at most K atoms and spans at most K rows.
//
// What crosses over from the TPU kernel is what it computes and its
// contract: per-row f32 sums of vals * B[col, :] over the block's atoms,
// with seam rows combined in block order and no atomics, so two applies
// are bitwise equal. Two modes:
//   * f32: products vals * B in f32, summed in f32;
//   * bf16: bf16(bf16(vals) * bf16(B)) — each product rounded to bf16 as
//     the TPU kernel's staged products were — summed in f32.
// The wrapper makes one bf16 copy of B for the bf16 mode (halving the
// gather's bytes); vals are rounded to bf16 on load. Products and sums
// use __fmul_rn/__fadd_rn (no FMA contraction), so the plain PyTorch
// version, which sums each row run in storage order and the runs in block
// order, gives the same bits.
// What does not cross over: the [K, R] one-hot MXU contraction, the 3-way
// bf16 split of the f32 mode (the card multiplies f32 exactly), the
// 4096-row VMEM output stripes with their re-cut and GROUP padding, and
// pad_groups/pad_R (the out-of-core tier).
//
// Design: one CTA per (plan block, feature tile of 32*FPL columns); the
// grid tiles F, so F = 40 is one tile of 64 columns, not 128 lanes. Warp
// w sums the block's rows w, w+8, ... in CSR order; lane l owns columns
// l, l+32, ... of the tile, so the B[col, :] row gather is coalesced and
// vals/cols are warp-wide broadcasts. Rows wholly inside the block go
// straight to C; the block's first and last row go to seam[2b], seam[2b+1]
// ([nb, 2, F]) and spmm_seam_kernel adds them in block order.
//
// What bounds K4 on an H100: bytes of the B gather, F * 4 B (f32) or
// F * 2 B (bf16) per nonzero, from L2 when B fits in its 50 MB. At 2 flops
// per gathered element this is far below the card's ridge point.
//
// Offsets into B, C and seam are 64-bit. The C entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kBf16>
struct BElem {
  using T = float;
};
template <>
struct BElem<true> {
  using T = __nv_bfloat16;
};

__device__ __forceinline__ float load_b(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_b(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <bool kBf16>
__device__ __forceinline__ float product(float v, float b) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, b)));
  } else {
    return __fmul_rn(v, b);
  }
}

template <int FPL, bool kBf16>
__global__ void __launch_bounds__(kThreads)
flat_spmm_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                 const int* __restrict__ offsets,
                 const int* __restrict__ atom_starts,
                 const int* __restrict__ row_first,
                 const int* __restrict__ row_last,
                 const typename BElem<kBf16>::T* __restrict__ B,
                 float* __restrict__ C, float* __restrict__ seam, int K,
                 int F) {
  const int b = blockIdx.x;
  const int a0 = atom_starts[b], a1 = atom_starts[b + 1];
  if (a0 == a1) return;
  const int rf = row_first[b], rl = row_last[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * (32 * FPL) + lane;
  // atom a of this block sits at staged slot b*K + (a - a0)
  const long long slot0 = static_cast<long long>(b) * K - a0;
  for (int r = rf + warp; r <= rl; r += kWarps) {
    const int lo = max(offsets[r], a0);
    const int hi = min(offsets[r + 1], a1);
    if (lo >= hi) continue;  // no atom of row r here: C[r] stays 0
    float acc[FPL];
#pragma unroll
    for (int j = 0; j < FPL; ++j) acc[j] = 0.f;
    for (int a = lo; a < hi; ++a) {
      float v = vals[slot0 + a];
      if constexpr (kBf16) v = __bfloat162float(__float2bfloat16_rn(v));
      const auto* brow = B + static_cast<long long>(cols[slot0 + a]) * F;
#pragma unroll
      for (int j = 0; j < FPL; ++j) {
        const int f = f0 + 32 * j;
        if (f < F) {
          acc[j] = __fadd_rn(acc[j], product<kBf16>(v, load_b(brow + f)));
        }
      }
    }
    float* dst = r == rf   ? seam + 2LL * b * F
                 : r == rl ? seam + (2LL * b + 1) * F
                           : C + static_cast<long long>(r) * F;
#pragma unroll
    for (int j = 0; j < FPL; ++j) {
      const int f = f0 + 32 * j;
      if (f < F) dst[f] = acc[j];
    }
  }
}

// Sum of row r's partials (feature f) from block c onwards, in block
// order, while the blocks still start inside row r.
__device__ __forceinline__ float walk_row(int r, int c, float s,
                                          const int* __restrict__ row_first,
                                          const int* __restrict__ row_last,
                                          const float* __restrict__ seam,
                                          int nb, int F, int f) {
  for (; c < nb && row_first[c] == r; ++c) {
    s = __fadd_rn(s, seam[2LL * c * F + f]);
    if (row_last[c] != r) break;
  }
  return s;
}

// Seam pass: one thread per (block, feature). The first block that
// touches a boundary row owns it and writes the row's total; later blocks
// that start inside the row only contribute through the walk. row_first/
// row_last are -1 for a block with no atoms (it never sits inside a row).
__global__ void __launch_bounds__(kThreads)
spmm_seam_kernel(const int* __restrict__ row_first,
                 const int* __restrict__ row_last,
                 const float* __restrict__ seam, float* __restrict__ C, int nb,
                 int F) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(nb) * F) return;
  const int b = static_cast<int>(t / F), f = static_cast<int>(t % F);
  const int rf = row_first[b];
  if (rf < 0) return;
  const int rl = row_last[b];
  if (b == 0 || row_last[b - 1] != rf) {
    float s = seam[2LL * b * F + f];
    if (rl == rf) s = walk_row(rf, b + 1, s, row_first, row_last, seam, nb, F, f);
    C[static_cast<long long>(rf) * F + f] = s;
  }
  if (rl != rf) {
    C[static_cast<long long>(rl) * F + f] =
        walk_row(rl, b + 1, seam[(2LL * b + 1) * F + f], row_first, row_last,
                 seam, nb, F, f);
  }
}

template <int FPL>
int launch_fpl(const float* vals, const int* cols, const int* offsets,
               const int* atom_starts, const int* row_first,
               const int* row_last, const void* B, float* C, float* seam,
               int nb, int K, int F, bool bf16, cudaStream_t s) {
  const dim3 grid(nb, (F + 32 * FPL - 1) / (32 * FPL));
  if (bf16) {
    flat_spmm_kernel<FPL, true><<<grid, kThreads, 0, s>>>(
        vals, cols, offsets, atom_starts, row_first, row_last,
        static_cast<const __nv_bfloat16*>(B), C, seam, K, F);
  } else {
    flat_spmm_kernel<FPL, false><<<grid, kThreads, 0, s>>>(
        vals, cols, offsets, atom_starts, row_first, row_last,
        static_cast<const float*>(B), C, seam, K, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int loops_flat_spmm(const void* vals, const void* cols, const void* offsets,
                    const void* atom_starts, const void* row_first,
                    const void* row_last, const void* B, void* C, void* seam,
                    int nb, int K, int F, int fpl, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(vals);
  const auto* c = static_cast<const int*>(cols);
  const auto* o = static_cast<const int*>(offsets);
  const auto* as = static_cast<const int*>(atom_starts);
  const auto* rf = static_cast<const int*>(row_first);
  const auto* rl = static_cast<const int*>(row_last);
  auto* out = static_cast<float*>(C);
  auto* sm = static_cast<float*>(seam);
  int err;
  switch (fpl) {
    case 1: err = launch_fpl<1>(v, c, o, as, rf, rl, B, out, sm, nb, K, F, bf16, s); break;
    case 2: err = launch_fpl<2>(v, c, o, as, rf, rl, B, out, sm, nb, K, F, bf16, s); break;
    case 4: err = launch_fpl<4>(v, c, o, as, rf, rl, B, out, sm, nb, K, F, bf16, s); break;
    case 8: err = launch_fpl<8>(v, c, o, as, rf, rl, B, out, sm, nb, K, F, bf16, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  const long long threads = static_cast<long long>(nb) * F;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  spmm_seam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      rf, rl, sm, out, nb, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
