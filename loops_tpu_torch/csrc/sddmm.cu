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
// What bounds K10 on an H100: 2 * R * C * F flops per block on the CUDA
// cores (67 TFLOP/s f32: 0.239 ms at the bench's 16384^2, F = 512 regime).
// The blocks of one block column (~119 at the bench's density) all need
// the same 128 x F slab of B: read once per block, that is 4.0 GB an
// apply from L2.
//
// Design: the wrapper stages at bind a permutation of the stored blocks
// sorted by block column (storage order within a column), cut into groups
// of at most G blocks of one column (gptr). One CTA of 2 * ROWS threads
// takes a group's ROWS rows (G blocks of R rows, G = ROWS / R; a block of
// more than ROWS rows spreads over blockIdx.z) by a 128-column slice of C
// (blockIdx.y), and loads each B feature tile once for its G blocks:
// FT features of A's rows and B's 128 rows are double-buffered in shared
// memory with cp.async (rows past the matrix, features past F
// zero-filled), the next tile's copy under this tile's FMAs. Thread (row
// group rg, column group cg) keeps an 8 x 8 register tile: rows 8 rg..8 rg
// + 7, columns cg + 16 j; per 4 features it reads 8 float4 of A (the
// lanes of a phase share a row: a broadcast) and 8 of B (rows at pitch FT
// + 4: the 8 lanes of a phase read distinct banks), for 256 FMAs. B's L2
// traffic falls by G (0.5 GB at G = 8); A's rows are read once per block
// and column slice. Every output is written through the permutation to
// out[t], so out stays [NB, R, C] in storage order. ROWS = 64 and FT = 32
// ran fastest of the shapes tried on the card (PERF.md §6).
//
// Offsets into A, B, vals and out are 64-bit. Each C entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

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
constexpr int kK10Cols = 128;  // output columns of a CTA: a slice of C
constexpr int kK10Rows = 64;   // A rows of a CTA: G = 64 / R blocks
constexpr int kK10FT = 32;     // features a step

__global__ void __launch_bounds__(2 * kK10Rows)
sddmm_bcsr_kernel(const int* __restrict__ gptr, const int* __restrict__ perm,
                  const int* __restrict__ brow, const int* __restrict__ bcols,
                  const float* __restrict__ vals, const float* __restrict__ A,
                  const float* __restrict__ B, float* __restrict__ out, int R,
                  int C, int rows, int cols, int F, int lda, int ldb) {
  constexpr int ROWS = kK10Rows, FT = kK10FT;
  constexpr int kThreads = 2 * ROWS;  // ROWS / 8 row groups x 16 col groups
  constexpr int kPitch = FT + 4;      // row pitch of the staged tiles
  constexpr int kQuads = FT / 4;      // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [2][ROWS][kPitch]
  float* Bs = As + 2 * ROWS * kPitch;          // [2][kK10Cols][kPitch]
  __shared__ long long arow[ROWS];  // A's row of each CTA row, or -1
  __shared__ long long orow[ROWS];  // out's offset of the row, or -1
  const int g0 = gptr[blockIdx.x], n = gptr[blockIdx.x + 1] - g0;
  const int c0 = blockIdx.y * kK10Cols;
  const long long bcol0 = static_cast<long long>(bcols[perm[g0]]) * C + c0;
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const int v = blockIdx.z * ROWS + i, b = v / R, r = v % R;
    long long ar = -1, o = -1;
    if (b < n) {
      const int t = perm[g0 + b];
      ar = static_cast<long long>(brow[t]) * R + r;
      if (ar >= rows) ar = -1;
      o = (static_cast<long long>(t) * R + r) * C + c0;
    }
    arow[i] = ar;
    orow[i] = o;
  }
  __syncthreads();
  // feature tile k of the CTA's A rows and B rows into buffer `slot`
  auto stage = [&](int k, int slot) {
    const int f0 = k * FT;
    float* as = As + slot * ROWS * kPitch;
    float* bs = Bs + slot * kK10Cols * kPitch;
    for (int i = threadIdx.x; i < ROWS * kQuads; i += kThreads) {
      const int r = i / kQuads, f = (i % kQuads) * 4;
      const long long ar = arow[r];
      const float* src = A;
      int bytes = 0;
      if (ar >= 0 && f0 + f < F) {
        src = A + ar * lda + f0 + f;
        bytes = min(4, F - f0 - f) * 4;
      }
      loops_tc::cp_async16(as + r * kPitch + f, src, bytes);
    }
    for (int i = threadIdx.x; i < kK10Cols * kQuads; i += kThreads) {
      const int c = i / kQuads, f = (i % kQuads) * 4;
      const float* src = B;
      int bytes = 0;
      if (bcol0 + c < cols && f0 + f < F) {
        src = B + (bcol0 + c) * ldb + f0 + f;
        bytes = min(4, F - f0 - f) * 4;
      }
      loops_tc::cp_async16(bs + c * kPitch + f, src, bytes);
    }
  };
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }
  const int steps = (F + FT - 1) / FT;
  if (steps > 0) stage(0, 0);
  loops_tc::cp_async_commit();
  for (int k = 0; k < steps; ++k) {
    const int slot = k & 1;
    if (k + 1 < steps) stage(k + 1, 1 - slot);
    loops_tc::cp_async_commit();
    loops_tc::cp_async_wait_prior();
    __syncthreads();
    const float* as = As + (slot * ROWS + 8 * rg) * kPitch;
    const float* bs = Bs + (slot * kK10Cols + cg) * kPitch;
#pragma unroll 2
    for (int f = 0; f < FT; f += 4) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = *reinterpret_cast<const float4*>(bs + 16 * j * kPitch + f);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(as + r * kPitch + f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[r][j] = fmaf(a.x, b[j].x, acc[r][j]);
          acc[r][j] = fmaf(a.y, b[j].y, acc[r][j]);
          acc[r][j] = fmaf(a.z, b[j].z, acc[r][j]);
          acc[r][j] = fmaf(a.w, b[j].w, acc[r][j]);
        }
      }
    }
    __syncthreads();  // before the next copy overwrites this slot
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long o = orow[8 * rg + r];
    if (o < 0) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long e = o + cg + 16 * j;
      out[e] = __fmul_rn(__ldg(vals + e), acc[r][j]);
    }
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

// A and B: f32 [rows, F] and [cols, F] at row pitches lda and ldb
// (multiples of 4, 16-byte aligned bases); groups of at most G blocks
int loops_bcsr_sddmm_f32(const void* gptr, const void* perm, const void* brow,
                         const void* bcols, const void* vals, const void* A,
                         const void* B, void* out, int groups, int G, int R,
                         int C, int rows, int cols, int F, int lda, int ldb,
                         void* stream) {
  const int zs = (G * R + kK10Rows - 1) / kK10Rows;
  if (C % kK10Cols || lda % 4 || ldb % 4 || C / kK10Cols > 65535 ||
      zs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = (2 * kK10Rows + 2 * kK10Cols) * (kK10FT + 4) * 4;
  int err = loops_tc::set_smem(sddmm_bcsr_kernel, smem);
  if (err) return err;
  const dim3 grid(static_cast<unsigned>(groups), C / kK10Cols, zs);
  sddmm_bcsr_kernel<<<grid, 2 * kK10Rows, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gptr), static_cast<const int*>(perm),
      static_cast<const int*>(brow), static_cast<const int*>(bcols),
      static_cast<const float*>(vals), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<float*>(out), R, C, rows,
      cols, F, lda, ldb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
