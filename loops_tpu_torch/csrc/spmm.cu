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
//     the TPU kernel's staged products were — summed in f32. B is read as
//     a bf16 copy the wrapper makes once per call (half the gather's
//     bytes; reading f32 B and rounding it in registers was slower on the
//     card, PERF.md has the times).
// Products and sums use __fmul_rn/__fadd_rn (no FMA contraction), so the
// plain PyTorch version, which sums the same runs in the same order,
// gives the same bits.
// What does not cross over: the [K, R] one-hot MXU contraction, the 3-way
// bf16 split of the f32 mode (the card multiplies f32 exactly), the
// 4096-row VMEM output stripes with their re-cut and GROUP padding, and
// pad_groups/pad_R (the out-of-core tier).
//
// What bounds K4 on an H100: bytes of the B gather, F * 4 B (f32) or
// F * 2 B (bf16) per nonzero, mostly from L2; at 2 flops per gathered
// element it is far below the card's ridge point. The first port gave each
// warp whole rows, one atom at a time, each B load waiting on its index
// load: one row in flight per warp, and a block holding one long row kept
// 1 of its 8 warps busy (0.172 ns per nonzero on the arxiv-shaped graph,
// against 0.132 ns for the K15 probe's gather of the same table).
//
// Design: one CTA of 8 warps per (plan block, feature tile of 32*FPL
// columns); lane l owns the FPL consecutive columns l*FPL, ... of the
// tile, loaded and stored as one vector where F and B's alignment allow.
//   1. The block's atom range [a0, a1) is cut into 8 warp ranges at
//      a0 + n*w/8 (n = a1 - a0), whatever the rows. A warp reads its
//      range's rows, columns and values 32 atoms at a time, one per lane
//      (the next 32 before this 32's B rows are used), and hands them out
//      by shuffles; then kUnroll atoms at a time it issues their B-row
//      gathers and only then adds them in storage order. The kernel holds
//      64 registers a thread, so 32 warps of an SM keep their gathers in
//      flight (the f32 FPL = 8 instances, F past 128, spill 52-92 bytes
//      to fit). In bf16,
//      products are rounded two at a time (cvt.rn.bf16x2.f32): conversions
//      run at a quarter of the FMA rate.
//   2. A row strictly inside a warp's range is wholly its own and goes
//      straight to C. The warp's first and last rows go to shared memory,
//      where the block adds the partials of each row in warp order; the
//      block's first and last rows then go to seam[2b], seam[2b+1]
//      ([nb, 2, F]) and spmm_seam_kernel adds them in block order, the
//      rest to C.
//   3. Every row of C is written once, so C needs no zeroing: a row with
//      atoms by step 2 or the seam pass, a row with none (offsets[r] ==
//      offsets[r+1]) as zeros by the block whose row range [row_starts[b],
//      row_starts[b+1]) holds it.
//
// Offsets into B, C and seam are 64-bit. The C entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // atoms whose B rows a warp gathers at once
// at most 64 registers a thread: 4 CTAs of 8 warps on an SM
constexpr int kMinBlocks = 4;

template <bool kBf16>
struct BElem {
  using T = float;
};
template <>
struct BElem<true> {
  using T = __nv_bfloat16;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the lane's FPL columns f, ..., f+FPL-1 of one B row, kept as the raw
// words of the load (a bf16 word holds two columns) until they are used;
// kVec: F % FPL == 0 and the row is aligned for one vector load, so the
// lane's columns are all inside F or all past it
template <typename TB, int FPL, bool kVec>
struct Cols {
  static constexpr bool kHalf = sizeof(TB) == 2;
  static constexpr int kWords = kHalf ? (FPL + 1) / 2 : FPL;
  unsigned w[kWords];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void load(const TB* row, int f, int F) {
    if constexpr (kVec && FPL > 1) {
      const auto* p = reinterpret_cast<const unsigned*>(row + f);
      if constexpr (kWords >= 4) {
#pragma unroll
        for (int i = 0; i < kWords; i += 4) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + i));
          w[i] = q.x;
          w[i + 1] = q.y;
          w[i + 2] = q.z;
          w[i + 3] = q.w;
        }
      } else if constexpr (kWords == 2) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = q.x;
        w[1] = q.y;
      } else {
        w[0] = __ldg(p);
      }
    } else if constexpr (kHalf) {
      const auto* p = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
      for (int j = 0; j < FPL; ++j) {
        const unsigned bits = f + j < F ? __ldg(p + f + j) : 0u;
        w[j / 2] = j % 2 ? w[j / 2] | (bits << 16) : bits;
      }
    } else {
#pragma unroll
      for (int j = 0; j < FPL; ++j) {
        w[j] = f + j < F ? __float_as_uint(__ldg(row + f + j)) : 0u;
      }
    }
  }
  __device__ __forceinline__ float operator[](int j) const {
    if constexpr (kHalf) {
      const unsigned x = w[j / 2];
      return __uint_as_float(j % 2 ? (x & 0xffff0000u) : (x << 16));
    } else {
      return __uint_as_float(w[j]);
    }
  }
};

template <int FPL, bool kVec>
__device__ __forceinline__ void store_cols(float* row, int f, int F,
                                           const float (&x)[FPL]) {
  if constexpr (kVec && FPL >= 4) {
    if (f < F) {
#pragma unroll
      for (int j = 0; j < FPL; j += 4) {
        *reinterpret_cast<float4*>(row + f + j) =
            make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
      }
    }
  } else if constexpr (kVec && FPL == 2) {
    if (f < F) *reinterpret_cast<float2*>(row + f) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int j = 0; j < FPL; ++j) {
      if (f + j < F) row[f + j] = x[j];
    }
  }
}

// x and y rounded to bf16 (to nearest, ties to even) by one packed
// conversion, then widened back exactly
__device__ __forceinline__ void bf16r2(float& x, float& y) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(y), "f"(x));
  x = __uint_as_float(d << 16);
  y = __uint_as_float(d & 0xffff0000u);
}

// acc[j] += v * x[j] in f32, or, in the bf16 mode (v and x rounded
// already), bf16(v * x[j])
template <int FPL, bool kBf16, typename X>
__device__ __forceinline__ void add_products(float (&acc)[FPL], float v,
                                             const X& x) {
  if constexpr (!kBf16) {
#pragma unroll
    for (int j = 0; j < FPL; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v, x[j]));
  } else if constexpr (FPL == 1) {
    acc[0] = __fadd_rn(acc[0], bf16r(__fmul_rn(v, x[0])));
  } else {
#pragma unroll
    for (int j = 0; j < FPL; j += 2) {
      float p0 = __fmul_rn(v, x[j]), p1 = __fmul_rn(v, x[j + 1]);
      bf16r2(p0, p1);
      acc[j] = __fadd_rn(acc[j], p0);
      acc[j + 1] = __fadd_rn(acc[j + 1], p1);
    }
  }
}

// kBf16: the bf16 mode (vals and B rounded, each product rounded), B the
// wrapper's bf16 copy; else f32
template <int FPL, bool kBf16, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flat_spmm_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                 const int* __restrict__ rows,
                 const int* __restrict__ offsets,
                 const int* __restrict__ atom_starts,
                 const int* __restrict__ row_starts,
                 const int* __restrict__ row_first,
                 const int* __restrict__ row_last,
                 const typename BElem<kBf16>::T* __restrict__ B,
                 float* __restrict__ C, float* __restrict__ seam, int K,
                 int F) {
  using TB = typename BElem<kBf16>::T;
  constexpr int TILE = 32 * FPL;
  constexpr int U = kUnroll;
  // partials of each warp's first [0] and last [1] row, and those rows
  __shared__ __align__(16) float part[kWarps][2][TILE];
  __shared__ int prow[kWarps][2];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile0 = blockIdx.y * TILE;
  const int f = tile0 + lane * FPL;

  // 3. rows without atoms in this block's row range: zeros
  float acc[FPL];
#pragma unroll
  for (int j = 0; j < FPL; ++j) acc[j] = 0.f;
  for (int r = row_starts[b] + warp; r < row_starts[b + 1]; r += kWarps) {
    if (offsets[r] == offsets[r + 1]) {
      store_cols<FPL, kVec>(C + static_cast<long long>(r) * F, f, F, acc);
    }
  }
  const int a0 = atom_starts[b], a1 = atom_starts[b + 1];
  if (a0 == a1) return;  // the whole block leaves: no partials
  const int n = a1 - a0;
  // 1. the warp's atom range; slot s of block b holds atom a0 + s
  const int lo = static_cast<int>(static_cast<long long>(n) * warp / kWarps);
  const int hi =
      static_cast<int>(static_cast<long long>(n) * (warp + 1) / kWarps);
  const long long slot0 = static_cast<long long>(b) * K;
  const int wf = lo < hi ? rows[slot0 + lo] : -1;
  const int wl = lo < hi ? rows[slot0 + hi - 1] : -1;
  if (lane == 0) {
    prow[warp][0] = wf;
    prow[warp][1] = wl;
  }
  // 2. a row's sum: to shared memory if the warp's first or last row,
  // else (wholly the warp's) to C
  auto emit = [&](int r) {
    if (r == wf || r == wl) {
      float* dst = part[warp][r == wf ? 0 : 1] + lane * FPL;
#pragma unroll
      for (int j = 0; j < FPL; ++j) dst[j] = acc[j];
    } else {
      store_cols<FPL, kVec>(C + static_cast<long long>(r) * F, f, F, acc);
    }
  };
  // the warp's atoms in chunks of 32: lane l holds the row, column and
  // value of atom i0 + l, and the next chunk's are loaded before this
  // one's B rows are used; each group of U atoms then issues its U
  // gathers before adding any of them, in storage order
  int cur = wf;
  int cr = -1, cc = 0;
  float cv = 0.f;
  if (lo + lane < hi) {
    cr = rows[slot0 + lo + lane];
    cc = cols[slot0 + lo + lane];
    cv = vals[slot0 + lo + lane];
  }
  for (int i0 = lo; i0 < hi; i0 += 32) {
    int nr = -1, nc = 0;
    float nv = 0.f;
    if (i0 + 32 + lane < hi) {
      nr = rows[slot0 + i0 + 32 + lane];
      nc = cols[slot0 + i0 + 32 + lane];
      nv = vals[slot0 + i0 + 32 + lane];
    }
    const int cnt = min(32, hi - i0);
    for (int g = 0; g < cnt; g += U) {
      int c[U], r[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        r[u] = __shfl_sync(0xffffffffu, cr, g + u);
        c[u] = __shfl_sync(0xffffffffu, cc, g + u);
        v[u] = __shfl_sync(0xffffffffu, cv, g + u);
        if (g + u >= cnt) r[u] = -1;
      }
      Cols<TB, FPL, kVec> x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x[u].zero();
        if (r[u] >= 0 && f < F) {
          x[u].load(B + static_cast<long long>(c[u]) * F, f, F);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r[u] < 0) break;
        if (r[u] != cur) {
          emit(cur);
          cur = r[u];
#pragma unroll
          for (int j = 0; j < FPL; ++j) acc[j] = 0.f;
        }
        add_products<FPL, kBf16>(acc, kBf16 ? bf16r(v[u]) : v[u], x[u]);
      }
    }
    cr = nr;
    cc = nc;
    cv = nv;
  }
  if (lo < hi) emit(cur);
  __syncthreads();

  // 2. the warps' partial rows, added in warp order, one thread per column
  const int t = threadIdx.x;
  if (t >= TILE || tile0 + t >= F) return;
  const int rf = row_first[b], rl = row_last[b];
  auto put = [&](int r, float s) {
    float* dst = r == rf   ? seam + 2LL * b * F
                 : r == rl ? seam + (2LL * b + 1) * F
                           : C + static_cast<long long>(r) * F;
    dst[tile0 + t] = s;
  };
  int row = -1;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = prow[w][k];
      if (r < 0 || (k == 1 && r == prow[w][0])) continue;
      const float p = part[w][k][t];
      if (r == row) {
        s = __fadd_rn(s, p);
      } else {
        if (row >= 0) put(row, s);
        row = r;
        s = p;
      }
    }
  }
  put(row, s);
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

struct Args {
  const float* vals;
  const int* cols;
  const int* rows;
  const int* offsets;
  const int* atom_starts;
  const int* row_starts;
  const int* row_first;
  const int* row_last;
  const void* B;
  float* C;
  float* seam;
  int K, F;
};

template <int FPL, bool kBf16, bool kVec>
int launch_k4(const Args& a, dim3 grid, cudaStream_t s) {
  using TB = typename BElem<kBf16>::T;
  flat_spmm_kernel<FPL, kBf16, kVec><<<grid, kThreads, 0, s>>>(
      a.vals, a.cols, a.rows, a.offsets, a.atom_starts, a.row_starts,
      a.row_first, a.row_last, static_cast<const TB*>(a.B), a.C, a.seam, a.K,
      a.F);
  return static_cast<int>(cudaGetLastError());
}

template <int FPL, bool kVec>
int launch_mode(const Args& a, dim3 grid, int bf16, cudaStream_t s) {
  return bf16 ? launch_k4<FPL, true, kVec>(a, grid, s)
              : launch_k4<FPL, false, kVec>(a, grid, s);
}

template <int FPL>
int launch_fpl(const Args& a, int nb, int bf16, int vec, cudaStream_t s) {
  const dim3 grid(nb, (a.F + 32 * FPL - 1) / (32 * FPL));
  if constexpr (FPL > 1) {
    if (vec) return launch_mode<FPL, true>(a, grid, bf16, s);
  }
  return launch_mode<FPL, false>(a, grid, bf16, s);
}

}  // namespace

extern "C" {

int loops_flat_spmm(const void* vals, const void* cols, const void* rows,
                    const void* offsets, const void* atom_starts,
                    const void* row_starts, const void* row_first,
                    const void* row_last, const void* B, void* C, void* seam,
                    int nb, int K, int F, int fpl, int bf16, int vec,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(vals),
               static_cast<const int*>(cols),
               static_cast<const int*>(rows),
               static_cast<const int*>(offsets),
               static_cast<const int*>(atom_starts),
               static_cast<const int*>(row_starts),
               static_cast<const int*>(row_first),
               static_cast<const int*>(row_last),
               B,
               static_cast<float*>(C),
               static_cast<float*>(seam),
               K,
               F};
  if (vec && F % fpl) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err;
  switch (fpl) {
    case 1: err = launch_fpl<1>(a, nb, bf16, vec, s); break;
    case 2: err = launch_fpl<2>(a, nb, bf16, vec, s); break;
    case 4: err = launch_fpl<4>(a, nb, bf16, vec, s); break;
    case 8: err = launch_fpl<8>(a, nb, bf16, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  const long long threads = static_cast<long long>(nb) * F;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  spmm_seam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      a.row_first, a.row_last, a.seam, a.C, nb, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
