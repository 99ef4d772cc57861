// Block-sparse (BCSR) SpMV and SpMM for Hopper (sm_90a), f32 sums.
//
// A BCSR matrix stores dense R x C blocks (R % 8 == 0, C % 128 == 0) with
// block-row offsets and a block column per block. Every kernel here reads x
// or B as dense C-wide segments per stored block: there is no per-nonzero
// gather. None uses float atomics: every output element is summed by one
// thread in one fixed order, so two applies are bitwise equal.
//
// K6  bcsr_spmv_kernel     replaces loops_tpu/ops/kernels/spmv_bcsr.py
//                          bcsr_spmv_pallas
// K9  bcsr_spmm_kernel     replaces loops_tpu/ops/kernels/spmm_bcsr.py
//                          bcsr_spmm_pallas
// K8  bcsr_spmm_v2_kernel  replaces loops_tpu/ops/kernels/spmm_bcsr_v2.py
//                          bcsr_spmm_pallas_v2
// K7  bcsr_spmm_v3_kernel  replaces loops_tpu/ops/kernels/spmm_bcsr_v3.py
//                          bcsr_spmm_pallas_v3
//
// Precision. f32 is IEEE f32 on the CUDA cores (fmaf; no TF32). The bf16
// mode of K7/K8 rounds the operands (A blocks and B) to bf16 and multiplies
// and sums in f32: a bf16 x bf16 product is exact in f32, so this is what
// the TPU's jnp.dot(bf16, bf16, preferred_element_type=f32) computes. Both
// do it on the tensor cores (mma.sync, f32 sums).
//
// Not carried over from the TPU kernels: the (8, 128) register tiling, K6's
// GROUP/KCH chunking with its 3-way bf16 split and ones-contraction on the
// MXU, the VMEM-resident output tiles, scalar prefetch, and K9's
// _pad_empty_rows (here a CTA of an empty block row writes its zeros).
//
// What bounds them on an H100 (per PERF.md): K6 streams the stored blocks
// once (bytes; 2 flops per 4-byte value). The SpMMs do 2 * R * C * F flops
// per stored block; in IEEE f32 on the CUDA cores (67 TFLOP/s) that is the
// bound at F = 512, while in bf16 only the tensor cores could reach the
// byte bound. Below the bound, what the card pays is the B tiles re-read
// from L2 (K9 and K8: one per stored block; K7: one per super-row and
// column) and, per staged tile, the FMAs each shared load feeds. K7 and K8
// share their units of work (8 rows x 16 features a warp, below).
//
// Offsets into vals, B and the output are 64-bit. Each C entry point
// returns cudaGetLastError() so the Python wrapper raises on a refused
// launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

// ---------------------------------------------------------------- K6
// One warp per block row. Lane l owns columns l, l+32, l+64, l+96 of the
// 128-wide block; for a group of 8 rows it keeps 8 partial sums in
// registers and walks the row's blocks in storage order (x segment loaded
// once per block, coalesced block loads), then a fixed shuffle tree sums
// each row across the lanes and lane r writes row r of the group.
constexpr int kSpmvThreads = 256;
constexpr int kRowGroup = 8;

__global__ void __launch_bounds__(kSpmvThreads)
bcsr_spmv_kernel(const int* __restrict__ offsets, const int* __restrict__ bcols,
                 const float* __restrict__ vals, const float* __restrict__ x,
                 float* __restrict__ y, int nbr, int R, int rows, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int br = blockIdx.x * (kSpmvThreads / 32) + warp;
  if (br >= nbr) return;
  const int t0 = offsets[br], t1 = offsets[br + 1];
  for (int r0 = 0; r0 < R; r0 += kRowGroup) {
    float acc[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) acc[r] = 0.f;
    for (int t = t0; t < t1; ++t) {
      const long long c0 = static_cast<long long>(bcols[t]) * 128;
      float xs[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long c = c0 + lane + 32 * j;
        xs[j] = c < cols ? __ldg(x + c) : 0.f;
      }
      const float* blk = vals + (static_cast<long long>(t) * R + r0) * 128 + lane;
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[r] = fmaf(__ldg(blk + r * 128 + 32 * j), xs[j], acc[r]);
        }
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
      if (lane == r) mine = acc[r];
    }
    const long long row = static_cast<long long>(br) * R + r0 + lane;
    if (lane < kRowGroup && row < rows) y[row] = mine;
  }
}

// ------------------------------------------------- K7/K8 shared pieces
// Both walk a super-row (SUPER consecutive block rows) for one feature tile
// of FT columns with 256 threads: the f32 accumulator tile [SUPER*R][FT]
// lives in shared memory, A and (but for K8 in f32) the C x FT B tile are
// double-buffered into shared memory with cp.async (16-byte copies; bytes
// past the matrix or past F are zero-filled), and the tile is written to
// the output once.
constexpr int kSuperThreads = 256;

using loops_tc::cp_async16;
using loops_tc::cp_async_commit;
using loops_tc::cp_async_wait_prior;
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// B rows [row0, row0 + C), columns [f0, f0 + FT) into dst[C][FT] at row
// pitch dp; ld is B's row pitch in elements (ld * sizeof(T) and
// dp * sizeof(T) multiples of 16)
template <typename T>
__device__ __forceinline__ void load_b_tile(T* dst, int dp, const T* B,
                                            long long row0, int C, int FT,
                                            int f0, int cols, int F, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = FT / V;
  for (int i = threadIdx.x; i < C * per_row; i += blockDim.x) {
    const int c = i / per_row, v = (i % per_row) * V;
    const long long row = row0 + c;
    const int f = f0 + v;
    const T* src = B;
    int bytes = 0;
    if (row < cols && f < F) {
      src = B + row * ld + f;
      bytes = min(V, F - f) * static_cast<int>(sizeof(T));
    }
    cp_async16(dst + c * dp + v, src, bytes);
  }
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// ------------------------------------------------- K7/K8 units of work
// A step's work (a chunk of K7, a block of K8) is cut into units: 8 rows
// of the staged A (one block, or an 8-row part of a taller one) x 16
// features. Warp w owns feature group w % G (G = FT / 16, a divisor of the
// 8 warps) and units w / G, w / G + 8 / G, ...; it adds each unit's sums
// into the accumulator rows row_of(unit). A step's units lie in distinct
// accumulator rows or feature groups and a warp's units are its own, so
// no two writes meet; steps are separated by barriers: each (row, f) is
// summed in step order.
//
// bf16: the transposed product outᵀ = Bᵀ Aᵀ on mma.sync m16n8k16 (f32
// sums): 16 features are the mma's M, a unit's 8 rows its N, C its K. The
// warp keeps Bᵀ's fragments for its 16 features over 128 columns in 32
// registers (ldmatrix.trans of the row-major B tile) and, per unit, reads
// A's fragments with ldmatrix over the row-major A: 8 mma per unit, the
// even and the odd k-steps in two chains, added at the end. Accumulator
// fragment (feature gid (+8), rows 2 tig, 2 tig + 1) lands at
// acc[row_of(unit) + 2 tig (+1)][16 g + gid (+8)]. Rows of A and B are
// padded by 16 bytes so ldmatrix reads no bank twice.
//
// f32: IEEE fmaf on the CUDA cores. Lane (split s, quad fq) keeps 8 rows x
// 4 features over columns 32 j + 4 s + i: 8 float4 of A (two addresses a
// phase) and 4 float4 of B feed 128 FMAs. The 8 splits are then summed
// across lanes in three shuffle rounds, each lane keeping half of what it
// holds, so lane s ends with row s: (((S_s + S_s^4) + (S_s^2 + S_s^6)) +
// ((S_s^1 + S_s^5) + (S_s^3 + S_s^7))), the same lanes in the same order
// on every run. B's rows are padded by 16 bytes: a phase reads two rows.
constexpr int kK7Warps = kSuperThreads / 32;
constexpr int kK7Unit = 16;  // features of a unit

template <typename T>
struct K7Layout {  // row pads (elements) of the staged A and B tile
  static constexpr int kPadA = sizeof(T) == 2 ? 8 : 0;
  static constexpr int kPadB = sizeof(T) == 2 ? 8 : 4;
};

// n rows of C contiguous elements into dst at row pitch dp
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int dp, const T* src, int n,
                                          int C) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = C / V;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int r = i / per_row, v = (i % per_row) * V;
    cp_async16(dst + r * dp + v, src + static_cast<long long>(r) * C + v, 16);
  }
}

// one unit's 8 mma (bf16): the even and the odd k-steps in two chains
__device__ __forceinline__ void k7_mma(float d[4], float e[4],
                                       const __nv_bfloat16* ar,
                                       const unsigned (&bf)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 8; ks += 2) {
    unsigned af[4];
    loops_tc::ldmatrix_x4(af, ar + 16 * ks);
    loops_tc::mma_bf16(d, bf[ks], af);
    loops_tc::mma_bf16(e, bf[ks + 1], af + 2);
  }
}

// a unit's fragments (feature gid (+8), rows 2 tig, 2 tig + 1) into acc
__device__ __forceinline__ void k7_add(float* acc, const float d[4],
                                       const float e[4], int row, int accp,
                                       int col) {
  const int lane = threadIdx.x & 31;
  float* dst = acc + (row + 2 * (lane & 3)) * accp + col + (lane >> 2);
  dst[0] += d[0] + e[0];
  dst[accp] += d[1] + e[1];
  dst[8] += d[2] + e[2];
  dst[accp + 8] += d[3] + e[3];
}

// one warp: the step's units of feature group g, bf16; two units at a
// time, their mma chains interleaved
template <typename RowOf>
__device__ __forceinline__ void k7_units(
    const __nv_bfloat16* a, const __nv_bfloat16* b, float* acc,
    RowOf row_of, int tiles, int C, int ap, int bp, int accp, int g,
    int first, int stride) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < C; c0 += 128) {
    unsigned bf[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int row = c0 + 16 * ks + (lane & 7) + 8 * (lane >> 4);
      loops_tc::ldmatrix_x4_trans(
          bf[ks], b + row * bp + kK7Unit * g + 8 * ((lane >> 3) & 1));
    }
    const int lrow = (lane & 7) * ap + c0 + 8 * (lane >> 3);
    int q = first;
    for (; q + stride < tiles; q += 2 * stride) {
      float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
      float d2[4] = {0.f, 0.f, 0.f, 0.f}, e2[4] = {0.f, 0.f, 0.f, 0.f};
      const int q2 = q + stride;
      k7_mma(d, e, a + 8 * q * ap + lrow, bf);
      k7_mma(d2, e2, a + 8 * q2 * ap + lrow, bf);
      k7_add(acc, d, e, row_of(q), accp, kK7Unit * g);
      k7_add(acc, d2, e2, row_of(q2), accp, kK7Unit * g);
    }
    if (q < tiles) {
      float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
      k7_mma(d, e, a + 8 * q * ap + lrow, bf);
      k7_add(acc, d, e, row_of(q), accp, kK7Unit * g);
    }
  }
}

// the 8 column splits of a warp's f32 unit summed across lanes in three
// shuffle rounds; lane (s, fq) adds row s, features 4 fq.. into acc at
// row0 + s, column col + 4 fq
__device__ __forceinline__ void k7_fold_f32(const float (&sum)[8][4],
                                            float* acc, int row0, int accp,
                                            int col) {
  const int lane = threadIdx.x & 31, s = lane >> 2, fq = lane & 3;
  const bool h2 = s & 4, h1 = s & 2, h0 = s & 1;
  // splits s and s ^ 4 (lane ^ 16): the upper split keeps rows 4..7
  float p[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float send = h2 ? sum[r][k] : sum[r + 4][k];
      const float keep = h2 ? sum[r + 4][k] : sum[r][k];
      p[r][k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  }
  // then s ^ 2 (lane ^ 8) keeps two of the four rows, s ^ 1 (lane ^ 4) one
  float u[2][4], v[4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float send = h1 ? p[r][k] : p[r + 2][k];
      const float keep = h1 ? p[r + 2][k] : p[r][k];
      u[r][k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = h0 ? u[0][k] : u[1][k];
    const float keep = h0 ? u[1][k] : u[0][k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  float4* dst = reinterpret_cast<float4*>(acc + (row0 + s) * accp + col + 4 * fq);
  float4 o = *dst;
  o.x += v[0]; o.y += v[1]; o.z += v[2]; o.w += v[3];
  *dst = o;
}

// one warp: the step's units of feature group g, f32
template <typename RowOf>
__device__ __forceinline__ void k7_units(
    const float* a, const float* b, float* acc, RowOf row_of, int tiles,
    int C, int ap, int bp, int accp, int g, int first, int stride) {
  const int lane = threadIdx.x & 31, s = lane >> 2, fq = lane & 3;
  const float* bq = b + kK7Unit * g + 4 * fq;
  for (int q = first; q < tiles; q += stride) {
    const float* ar = a + 8 * q * ap;
    float sum[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[r][k] = 0.f;
    }
    for (int c0 = 4 * s; c0 < C; c0 += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 32 * j;
        float av[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r) load4(ar + r * ap + c, av[r]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float bv[4];
          load4(bq + (c + i) * bp, bv);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
#pragma unroll
            for (int k = 0; k < 4; ++k) sum[r][k] = fmaf(av[r][i], bv[k], sum[r][k]);
          }
        }
      }
    }
    k7_fold_f32(sum, acc, row_of(q), accp, kK7Unit * g);
  }
}

__device__ __forceinline__ void zero_tile(float* acc, int n) {
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    reinterpret_cast<float4*>(acc)[i] = zero4;
  }
}

// the accumulator tile [SR][FT] (row pitch accp) into out's rows from row0,
// four features a store where F and out's alignment allow
__device__ __forceinline__ void store_tile(const float* acc, int accp,
                                           float* out, long long row0, int SR,
                                           int FT, int f0, int rows, int F) {
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = threadIdx.x; i < SR * FT / 4; i += blockDim.x) {
    const int r = i / (FT / 4), f = (i % (FT / 4)) * 4;
    const long long row = row0 + r;
    if (row >= rows) break;
    const float4 v = *reinterpret_cast<const float4*>(acc + r * accp + f);
    float* o = out + row * F + f0 + f;
    if (vec && f0 + f + 4 <= F) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float w[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < 4 && f0 + f + k < F; ++k) o[k] = w[k];
    }
  }
}

// ---------------------------------------------------------------- K7
// The super-row's stored blocks come as column-sorted chunks of KCH blocks
// (loops_tpu's _stage_chunks): a chunk's A slab [KCH*R][C] is one
// contiguous copy, and the B tile of its column is loaded only where
// bfetch == 1 (into buffer bslot), once per (super-row, column), and reused
// by the following chunks of that column. The card's tiles are large
// (SUPER * R output rows, the f32 accumulator [SUPER*R][FT] in shared
// memory) so that chunks fill and each B tile serves many blocks.
//
// Chunk t + 1's slab, rowoff and B tile are copied in with cp.async while
// chunk t is computed; the chunk arrays of t + 2 are read into registers
// at the same time, so no step waits on an index load. A chunk's blocks
// lie in distinct block rows; unit q of a chunk adds into the rows of its
// block's rowoff.
template <typename T>
__global__ void __launch_bounds__(kSuperThreads)
bcsr_spmm_v3_kernel(const int* __restrict__ chunk_ptr,
                    const int* __restrict__ ccol, const int* __restrict__ bfetch,
                    const int* __restrict__ bslot,
                    const int* __restrict__ rowoff,
                    const int* __restrict__ nlive, const T* __restrict__ a3d,
                    const T* __restrict__ B, float* __restrict__ out, int R,
                    int C, int rows, int cols, int F, int ld, int SUPER,
                    int KCH, int FT) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ap = C + K7Layout<T>::kPadA, bp = FT + K7Layout<T>::kPadB;
  const int accp = FT + 4;
  const int SR = SUPER * R, QR = KCH * R;
  float* acc = reinterpret_cast<float*>(smem);
  T* abuf = reinterpret_cast<T*>(acc + SR * accp);  // [2][QR][ap]
  T* bbuf = abuf + 2 * QR * ap;                      // [2][C][bp]
  int* robuf = reinterpret_cast<int*>(bbuf + 2 * C * bp);  // [2][KCH]
  const int s = blockIdx.x, f0 = blockIdx.y * FT;
  const long long QC = static_cast<long long>(QR) * C;
  const int G = FT / kK7Unit, warp = threadIdx.x >> 5;
  // chunk t's slab and rowoff into slot `slot`, its B tile if it fetches
  auto stage = [&](int t, int slot, int n, int fetch, int col, int bs) {
    load_rows(abuf + slot * QR * ap, ap, a3d + t * QC, n * R, C);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      cp_async4(robuf + slot * KCH + k,
                rowoff + static_cast<long long>(t) * KCH + k);
    }
    if (fetch) {
      load_b_tile(bbuf + bs * C * bp, bp, B, static_cast<long long>(col) * C,
                  C, FT, f0, cols, F, ld);
    }
  };
  zero_tile(acc, SR * accp);
  const int t0 = chunk_ptr[s], t1 = chunk_ptr[s + 1];
  int n0 = 0, bs0 = 0;                  // chunk t: live blocks, B slot
  int n1 = 0, f1 = 0, c1 = 0, bs1 = 0;  // chunk t + 1
  if (t0 < t1) {  // a super-row's first chunk always fetches
    n0 = nlive[t0];
    bs0 = bslot[t0];
    stage(t0, 0, n0, 1, ccol[t0], bs0);
  }
  cp_async_commit();
  if (t0 + 1 < t1) {
    n1 = nlive[t0 + 1]; f1 = bfetch[t0 + 1];
    c1 = ccol[t0 + 1]; bs1 = bslot[t0 + 1];
  }
  for (int t = t0; t < t1; ++t) {
    const int aslot = (t - t0) & 1;
    int n2 = 0, f2 = 0, c2 = 0, bs2 = 0;  // chunk t + 2, read now
    if (t + 2 < t1) {
      n2 = nlive[t + 2]; f2 = bfetch[t + 2];
      c2 = ccol[t + 2]; bs2 = bslot[t + 2];
    }
    // a fetch goes to the other B buffer than the one chunk t reads
    if (t + 1 < t1) stage(t + 1, 1 - aslot, n1, f1, c1, bs1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int* ro = robuf + aslot * KCH;
    k7_units(abuf + aslot * QR * ap, bbuf + bs0 * C * bp, acc,
             [ro, R](int q) { return ro[8 * q / R] * R + (8 * q) % R; },
             n0 * R / 8, C, ap, bp, accp, warp % G, warp / G, kK7Warps / G);
    __syncthreads();  // before the next prefetch overwrites these buffers
    n0 = n1; bs0 = bs1;
    n1 = n2; f1 = f2; c1 = c2; bs1 = bs2;
  }
  __syncthreads();  // an empty super-row's zeros, written by all threads
  store_tile(acc, accp, out, static_cast<long long>(s) * SR, SR, FT, f0,
             rows, F);
}

// ---------------------------------------------------------------- K8
// The super-row's stored blocks in storage order, one block a step: the
// block's R x C values (and, in bf16, its B tile) are copied in with
// cp.async while the block before is computed (the block row and column of
// t + 1 and t + 2 are read into registers ahead, so no step waits on an
// index load), and the block's R / 8 units of every feature group add into
// the accumulator rows of its block row. The units are K7's: in bf16 the
// transposed product on mma.sync over the staged B tile; in f32 the 8 x 4
// register tiles summed across lanes in a fixed order, with B's float4s
// read straight from L2, 8 rows in flight (k8_units). Every (row, f) is
// summed in block order, each block's sum over C in the units' fixed
// order.
//
// Every block re-reads its B tile (C x FT) from L2: 4.00 GB an apply in
// f32, 2.00 GB in bf16 at the bench's 16384^2, F = 512 regime, and that
// sets the time. In f32, loads straight from L2 ran 2x faster on the card
// than cp.async tiles (PERF.md §6): with no B tile in shared memory
// and 128 registers, two CTAs share an SM. Super-rows of one block row ran
// faster than taller ones.

// K8 f32: lane (s, fq) loads the float4s of B it multiplies straight from
// L2 (rows past the matrix and features past F as zeros), 8 rows in
// flight, where k7_units (f32) reads a staged tile: the same sums in the
// same order
template <typename RowOf>
__device__ __forceinline__ void k8_units(
    const float* a, const float* __restrict__ B, long long col0, int cn,
    int ld, int fcol, bool live, float* acc, RowOf row_of, int tiles, int C,
    int ap, int accp, int g, int first, int stride) {
  const int lane = threadIdx.x & 31, s = lane >> 2;
  const float* bq = B + col0 * ld + fcol;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = first; q < tiles; q += stride) {
    const float* ar = a + 8 * q * ap;
    float sum[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[r][k] = 0.f;
    }
    for (int c0 = 4 * s; c0 < C; c0 += 128) {
#pragma unroll
      for (int jj = 0; jj < 4; jj += 2) {
        float4 bv[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = c0 + 32 * (jj + (k >> 2)) + (k & 3);
          bv[k] = live && c < cn
                      ? __ldg(reinterpret_cast<const float4*>(
                            bq + static_cast<long long>(c) * ld))
                      : zero4;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 32 * (jj + h);
          float av[8][4];
#pragma unroll
          for (int r = 0; r < 8; ++r) load4(ar + r * ap + c, av[r]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float bw[4] = {bv[4 * h + i].x, bv[4 * h + i].y,
                                 bv[4 * h + i].z, bv[4 * h + i].w};
#pragma unroll
            for (int r = 0; r < 8; ++r) {
#pragma unroll
              for (int k = 0; k < 4; ++k) sum[r][k] = fmaf(av[r][i], bw[k], sum[r][k]);
            }
          }
        }
      }
    }
    k7_fold_f32(sum, acc, row_of(q), accp, kK7Unit * g);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSuperThreads, sizeof(T) == 4 ? 2 : 1)
bcsr_spmm_v2_kernel(const int* __restrict__ offsets,
                    const int* __restrict__ bcols, const int* __restrict__ brow,
                    const T* __restrict__ vals, const T* __restrict__ B,
                    float* __restrict__ out, int nbr, int R, int C, int rows,
                    int cols, int F, int ld, int SUPER, int FT) {
  constexpr bool kDirect = sizeof(T) == 4;  // f32: B straight from L2
  extern __shared__ __align__(16) unsigned char smem[];
  const int ap = C + K7Layout<T>::kPadA, bp = FT + K7Layout<T>::kPadB;
  const int accp = FT + 4;
  const int SR = SUPER * R;
  float* acc = reinterpret_cast<float*>(smem);
  T* abuf = reinterpret_cast<T*>(acc + SR * accp);  // [2][R][ap]
  T* bbuf = abuf + 2 * R * ap;                       // [2][C][bp], bf16
  const int s = blockIdx.x, f0 = blockIdx.y * FT;
  const long long RC = static_cast<long long>(R) * C;
  const int G = FT / kK7Unit, warp = threadIdx.x >> 5;
  auto stage = [&](int t, int slot, int col) {
    load_rows(abuf + slot * R * ap, ap, vals + t * RC, R, C);
    if (!kDirect) {
      load_b_tile(bbuf + slot * C * bp, bp, B,
                  static_cast<long long>(col) * C, C, FT, f0, cols, F, ld);
    }
  };
  zero_tile(acc, SR * accp);
  const int t0 = offsets[min(s * SUPER, nbr)];
  const int t1 = offsets[min((s + 1) * SUPER, nbr)];
  if (t0 < t1) stage(t0, 0, bcols[t0]);
  cp_async_commit();
  int rcur = 0, ccur = 0, rnext = 0, cnext = 0;  // blocks t and t + 1
  if (t0 < t1) {
    rcur = brow[t0];
    ccur = bcols[t0];
  }
  if (t0 + 1 < t1) {
    rnext = brow[t0 + 1];
    cnext = bcols[t0 + 1];
  }
  for (int t = t0; t < t1; ++t) {
    const int slot = (t - t0) & 1;
    int r2 = 0, c2 = 0;  // block t + 2, read now
    if (t + 2 < t1) {
      r2 = brow[t + 2];
      c2 = bcols[t + 2];
    }
    if (t + 1 < t1) stage(t + 1, 1 - slot, cnext);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int arow = (rcur - s * SUPER) * R;
    const auto row_of = [arow](int q) { return arow + 8 * q; };
    if constexpr (kDirect) {
      const long long col0 = static_cast<long long>(ccur) * C;
      const int fcol = f0 + kK7Unit * (warp % G) + 4 * ((threadIdx.x & 31) & 3);
      k8_units(abuf + slot * R * ap, reinterpret_cast<const float*>(B), col0,
               static_cast<int>(min(static_cast<long long>(C), cols - col0)),
               ld, fcol, fcol < F, acc, row_of, R / 8, C, ap, accp, warp % G,
               warp / G, kK7Warps / G);
    } else {
      k7_units(abuf + slot * R * ap, bbuf + slot * C * bp, acc, row_of,
               R / 8, C, ap, bp, accp, warp % G, warp / G, kK7Warps / G);
    }
    __syncthreads();  // before the next prefetch overwrites this slot
    rcur = rnext; ccur = cnext;
    rnext = r2; cnext = c2;
  }
  __syncthreads();  // an empty super-row's zeros, written by all threads
  store_tile(acc, accp, out, static_cast<long long>(s) * SR, SR, FT, f0,
             rows, F);
}

// ---------------------------------------------------------------- K9
// One CTA of 128 threads per (block row, group of 8 rows, feature tile of
// 512 columns). Thread i owns the 4 contiguous features 4i..4i+3 and keeps
// 8 rows x 4 features in registers. For each stored block of the row, in
// storage order, the 8 x 128 sub-block is staged transposed in shared
// memory (a column's 8 values are two float4, read by every thread: a
// broadcast), and B's rows are read straight from L2 as 16-byte loads,
// 8 columns' loads in flight before their 32 FMAs each (80 registers, 4 KB
// of shared memory: 24 warps an SM). Every output is one thread's fmaf
// chain over the row's blocks in storage order and their columns in
// order.
constexpr int kSpmmThreads = 128;
constexpr int kK9Tile = 4 * kSpmmThreads;  // feature columns of a CTA
constexpr int kK9Cols = 8;                 // B rows in flight a thread

__global__ void __launch_bounds__(kSpmmThreads)
bcsr_spmm_kernel(const int* __restrict__ offsets, const int* __restrict__ bcols,
                 const float* __restrict__ vals, const float* __restrict__ B,
                 float* __restrict__ out, int R, int C, int rows, int cols,
                 int F, int ld) {
  __shared__ __align__(16) float sA[128 * kRowGroup];  // [c][r]
  const int groups = R / kRowGroup;
  const int br = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * kRowGroup;
  const int f = blockIdx.y * kK9Tile + 4 * threadIdx.x;
  // B's row pitch ld is a multiple of 4 and ld >= F: a float4 at f < F
  // lies in its row
  const bool live = f < F;
  float acc[kRowGroup][4];
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
  }
  const int t0 = offsets[br], t1 = offsets[br + 1];
  for (int t = t0; t < t1; ++t) {
    const long long col0 = static_cast<long long>(bcols[t]) * C;
    const float* blk = vals + (static_cast<long long>(t) * R + r0) * C;
    for (int c0 = 0; c0 < C && col0 + c0 < cols; c0 += 128) {
      __syncthreads();  // the previous sub-block has been read
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        sA[threadIdx.x * kRowGroup + r] = __ldg(blk + r * C + c0 + threadIdx.x);
      }
      __syncthreads();
      // columns past the matrix hold zeros and have no row of B
      const int cn = static_cast<int>(min(128LL, cols - col0 - c0));
      const float* brow = B + (col0 + c0) * ld + f;
      for (int c = 0; c < cn; c += kK9Cols) {
        float4 b[kK9Cols];
#pragma unroll
        for (int i = 0; i < kK9Cols; ++i) {
          b[i] = live && c + i < cn
                     ? __ldg(reinterpret_cast<const float4*>(
                           brow + static_cast<long long>(c + i) * ld))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kK9Cols; ++i) {
          if (c + i < cn) {
            float a[kRowGroup];
            load4(sA + (c + i) * kRowGroup, a);
            load4(sA + (c + i) * kRowGroup + 4, a + 4);
            const float bv[4] = {b[i].x, b[i].y, b[i].z, b[i].w};
#pragma unroll
            for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(a[r], bv[k], acc[r][k]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) {
    const long long row = static_cast<long long>(br) * R + r0 + r;
    if (row >= rows) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (f + k < F) out[row * F + f + k] = acc[r][k];
    }
  }
}

template <typename K>
int set_smem(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

extern "C" {

int loops_bcsr_spmv_f32(const void* offsets, const void* bcols,
                        const void* vals, const void* x, void* y, int nbr,
                        int R, int rows, int cols, void* stream) {
  const int per_cta = kSpmvThreads / 32;
  const unsigned grid = static_cast<unsigned>((nbr + per_cta - 1) / per_cta);
  bcsr_spmv_kernel<<<grid, kSpmvThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(bcols),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), nbr, R, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

int loops_bcsr_spmm_f32(const void* offsets, const void* bcols,
                        const void* vals, const void* B, void* out, int nbr,
                        int R, int C, int rows, int cols, int F, int ld,
                        void* stream) {
  const dim3 grid(static_cast<unsigned>(nbr) * (R / kRowGroup),
                  (F + kK9Tile - 1) / kK9Tile);
  bcsr_spmm_kernel<<<grid, kSpmmThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(bcols),
      static_cast<const float*>(vals), static_cast<const float*>(B),
      static_cast<float*>(out), R, C, rows, cols, F, ld);
  return static_cast<int>(cudaGetLastError());
}

int loops_bcsr_spmm_v2(const void* offsets, const void* bcols,
                       const void* brow, const void* vals, const void* B,
                       void* out, int nbr, int R, int C, int rows, int cols,
                       int F, int ld, int SUPER, int FT, int bf16, int smem,
                       void* stream) {
  const int nsup = (nbr + SUPER - 1) / SUPER;
  const dim3 grid(nsup, (F + FT - 1) / FT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int*>(offsets);
  const auto* bc = static_cast<const int*>(bcols);
  const auto* br = static_cast<const int*>(brow);
  auto* c = static_cast<float*>(out);
  if (FT % kK7Unit || kK7Warps % (FT / kK7Unit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err;
  if (bf16) {
    auto k = bcsr_spmm_v2_kernel<__nv_bfloat16>;
    if ((err = set_smem(k, smem))) return err;
    k<<<grid, kSuperThreads, smem, s>>>(
        o, bc, br, static_cast<const __nv_bfloat16*>(vals),
        static_cast<const __nv_bfloat16*>(B), c, nbr, R, C, rows, cols, F, ld,
        SUPER, FT);
  } else {
    auto k = bcsr_spmm_v2_kernel<float>;
    if ((err = set_smem(k, smem))) return err;
    k<<<grid, kSuperThreads, smem, s>>>(
        o, bc, br, static_cast<const float*>(vals),
        static_cast<const float*>(B), c, nbr, R, C, rows, cols, F, ld, SUPER,
        FT);
  }
  return static_cast<int>(cudaGetLastError());
}

int loops_bcsr_spmm_v3(const void* chunk_ptr, const void* ccol,
                       const void* bfetch, const void* bslot,
                       const void* rowoff, const void* nlive, const void* a3d,
                       const void* B, void* out, int nsup, int R, int C,
                       int rows, int cols, int F, int ld, int SUPER, int KCH,
                       int FT, int bf16, int smem, void* stream) {
  const dim3 grid(nsup, (F + FT - 1) / FT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cp = static_cast<const int*>(chunk_ptr);
  const auto* cc = static_cast<const int*>(ccol);
  const auto* bf = static_cast<const int*>(bfetch);
  const auto* bs = static_cast<const int*>(bslot);
  const auto* ro = static_cast<const int*>(rowoff);
  const auto* nl = static_cast<const int*>(nlive);
  auto* c = static_cast<float*>(out);
  int err;
  if (bf16) {
    auto k = bcsr_spmm_v3_kernel<__nv_bfloat16>;
    if ((err = set_smem(k, smem))) return err;
    k<<<grid, kSuperThreads, smem, s>>>(
        cp, cc, bf, bs, ro, nl, static_cast<const __nv_bfloat16*>(a3d),
        static_cast<const __nv_bfloat16*>(B), c, R, C, rows, cols, F, ld,
        SUPER, KCH, FT);
  } else {
    auto k = bcsr_spmm_v3_kernel<float>;
    if ((err = set_smem(k, smem))) return err;
    k<<<grid, kSuperThreads, smem, s>>>(
        cp, cc, bf, bs, ro, nl, static_cast<const float*>(a3d),
        static_cast<const float*>(B), c, R, C, rows, cols, F, ld, SUPER, KCH,
        FT);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
