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
// products and sums, f32 out [nnz] in storage order, over the CSR's row
// ids, columns and values staged as they are stored. The rounding is the
// TPU kernel's: vals are folded into the gathered B row, rounded to bf16
// (sddmm_flat.py:166-167), and multiplied by the bf16 A row; a bf16 x bf16
// product is exact in f32, so only the f32 sum's order differs from the
// TPU.
//
// What bounds K5 on an H100: the latency of its row gathers, not their
// bytes. The first port ran one nonzero per lane group with two dependent
// loads each (index, then row) and sat at 0.28 ns per nonzero whether A
// and B were in L2 or not, against 0.034-0.098 ns for a bf16 row gather
// that keeps rows in flight (the K15 probe).
//
// Design: a group of G lanes (a power of two, 1 to 32, covering F in
// VEC-wide pieces) takes runs of kFlatUnroll consecutive nonzeros, and a
// warp kFlatSteps consecutive runs of its groups. For a run the group
// loads the row ids, columns and values, then the B pieces of every
// nonzero and the A piece of every row the run starts (a nonzero on the
// same row as the one before reuses its A piece), and only then multiplies;
// the next run's indices are loaded before this run's rows are used. Lane
// j sums pieces j, j+G, ... of each product in order, then a fixed
// xor-shuffle tree sums the group; lane u % G writes out[e0 + u], so a
// warp's stores are contiguous. The kernel holds 64 registers a thread
// (ptxas spills 48 bytes of the 16-byte-piece instance to reach it), so
// 32 warps of an SM keep their gathers in flight: faster on the card than
// 24 warps without the spill. A and B are read as bf16 copies the wrapper
// makes once per call: 16-byte pieces of 8 values, half the bytes of
// every gather, and bf16(v * bf16(B)) is the same from the rounded B.
// (Reading f32 and rounding in registers was slower on the card; PERF.md
// has the times.) The products are rounded to bf16 two at a time
// (cvt.rn.bf16x2.f32): conversions run at a quarter of the FMA rate. A
// ragged F (F % VEC != 0 for every VEC > 1) takes 1-wide pieces; pieces
// past F and nonzeros past nnz are masked. No atomics: every out[e] is one
// group's fixed reduction, so two applies are bitwise equal.
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
constexpr int kFlatUnroll = 4;  // nonzeros in flight per lane group
constexpr int kFlatSteps = 4;   // runs of nonzeros per warp
// at most 64 registers a thread: 4 CTAs of 8 warps on an SM
constexpr int kFlatMinBlocks = 4;

// VEC consecutive bf16 values of one row, kept as the raw 32-bit words of
// the load (two values per word) until they are used
template <int VEC>
struct Piece {
  static constexpr int kBytes = 2 * VEC;
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  unsigned w[kWords];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    if constexpr (kBytes == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    } else if constexpr (kBytes == 8) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x;
      w[1] = q.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }
  // value k of the piece as a float (bf16 widens exactly)
  __device__ __forceinline__ float operator[](int k) const {
    const unsigned x = w[k / 2];
    return __uint_as_float(k % 2 ? (x & 0xffff0000u) : (x << 16));
  }
};

// x and y rounded to bf16 (to nearest, ties to even) by one packed
// conversion, then widened back exactly
__device__ __forceinline__ void bf16r2(float& x, float& y) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(y), "f"(x));
  x = __uint_as_float(d << 16);
  y = __uint_as_float(d & 0xffff0000u);
}

template <int U>
__device__ __forceinline__ void load_run(const int* __restrict__ rows,
                                         const int* __restrict__ cols,
                                         const float* __restrict__ vals,
                                         long long e0, int nnz, int (&r)[U],
                                         int (&c)[U], float (&v)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool ok = e0 + u < nnz;
    r[u] = ok ? __ldg(rows + e0 + u) : -1;
    c[u] = ok ? __ldg(cols + e0 + u) : 0;
    v[u] = ok ? __ldg(vals + e0 + u) : 0.f;
  }
}

// A and B are the wrapper's bf16 copies. A warp takes kFlatSteps
// consecutive runs of (32 / G) * U nonzeros; the next run's indices are
// loaded before the current run's rows are used.
template <int VEC>
__global__ void __launch_bounds__(kFlatThreads, kFlatMinBlocks)
sddmm_flat_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const __nv_bfloat16* __restrict__ A,
                  const __nv_bfloat16* __restrict__ B,
                  float* __restrict__ out, int nnz, int F, int G) {
  constexpr int U = kFlatUnroll;
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);
  const long long per_step = static_cast<long long>(32 / G) * U;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kFlatThreads + threadIdx.x) >> 5;
  const long long run0 = warp * per_step * kFlatSteps;
  // whole warps leave together, so the shuffles below see every lane
  if (run0 >= nnz) return;
  const long long g0 = run0 + static_cast<long long>(lane / G) * U;
  const int pieces = (F + VEC - 1) / VEC;  // VEC divides F when VEC > 1
  int r[U], c[U];
  float v[U];
  load_run<U>(rows, cols, vals, g0, nnz, r, c, v);
  for (int step = 0; step < kFlatSteps; ++step) {
    if (run0 + step * per_step >= nnz) break;  // the same for the warp
    const long long e0 = g0 + step * per_step;
    int nr[U], nc[U];
    float nv[U];
    if (step + 1 < kFlatSteps) {
      load_run<U>(rows, cols, vals, e0 + per_step, nnz, nr, nc, nv);
    }
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.f;
    for (int p0 = 0; p0 < pieces; p0 += G) {
      const int p = p0 + j;
      const bool on = p < pieces;
      Piece<VEC> a[U], b[U];
      // every load of the run first: B pieces, then the A piece of each
      // row
#pragma unroll
      for (int u = 0; u < U; ++u) {
        b[u].zero();
        if (on && r[u] >= 0) {
          b[u].load(B + static_cast<long long>(c[u]) * F + p * VEC);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u > 0 && r[u] == r[u - 1]) {
          a[u] = a[u - 1];
        } else {
          a[u].zero();
          if (on && r[u] >= 0) {
            a[u].load(A + static_cast<long long>(r[u]) * F + p * VEC);
          }
        }
      }
      if (on) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < VEC; k += 2) {
            if (k + 1 < VEC) {
              float g0 = __fmul_rn(v[u], b[u][k]);
              float g1 = __fmul_rn(v[u], b[u][k + 1]);
              bf16r2(g0, g1);
              acc[u] = fmaf(a[u][k], g0, acc[u]);
              acc[u] = fmaf(a[u][k + 1], g1, acc[u]);
            } else {
              acc[u] = fmaf(a[u][k], bf16r(__fmul_rn(v[u], b[u][k])),
                            acc[u]);
            }
          }
        }
      }
    }
    // lanes of one group are G consecutive lanes of a warp, G a power of
    // two, so an xor below G stays inside the group
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int off = G / 2; off > 0; off >>= 1) {
        acc[u] = __fadd_rn(acc[u], __shfl_xor_sync(0xffffffffu, acc[u], off));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if ((u & (G - 1)) == j && e0 + u < nnz) out[e0 + u] = acc[u];
    }
    if (step + 1 < kFlatSteps) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        r[u] = nr[u];
        c[u] = nc[u];
        v[u] = nv[u];
      }
    }
  }
}

template <int VEC>
int launch_flat(const int* rows, const int* cols, const float* vals,
                const void* A, const void* B, float* out, int nnz, int F,
                int G, cudaStream_t s) {
  const long long per_cta = static_cast<long long>(kFlatThreads / 32) *
                            (32 / G) * kFlatUnroll * kFlatSteps;
  const long long blocks = (nnz + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sddmm_flat_kernel<VEC>
      <<<static_cast<unsigned>(blocks), kFlatThreads, 0, s>>>(
          rows, cols, vals, static_cast<const __nv_bfloat16*>(A),
          static_cast<const __nv_bfloat16*>(B), out, nnz, F, G);
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

// A and B: bf16 [rows, F] and [cols, F]
int loops_sddmm_flat(const void* rows, const void* cols, const void* vals,
                     const void* A, const void* B, void* out, int nnz, int F,
                     int vec, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int*>(rows);
  const auto* c = static_cast<const int*>(cols);
  const auto* v = static_cast<const float*>(vals);
  auto* o = static_cast<float*>(out);
  if (group < 1 || group > 32 || (group & (group - 1)) ||
      (vec > 1 && F % vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (vec) {
    case 1: return launch_flat<1>(r, c, v, A, B, o, nnz, F, group, s);
    case 2: return launch_flat<2>(r, c, v, A, B, o, nnz, F, group, s);
    case 4: return launch_flat<4>(r, c, v, A, B, o, nnz, F, group, s);
    case 8: return launch_flat<8>(r, c, v, A, B, o, nnz, F, group, s);
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
