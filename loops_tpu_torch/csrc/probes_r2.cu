// K14 probes for Hopper (sm_90a): the per-chunk cost of the BCSR block
// product and of its shared-memory scatter accumulator.
//
// block_dot_f32_kernel / block_dot_f32_rows_kernel / block_dot_bf16_kernel
//   replace scripts/tpu_r2_probe.py dot_probe: acc += A[c] @ B over NCH
//   chunks of A [M, 128] (M in {8, 64, 128}), B [128, 512] resident or a
//   distinct B[c] streamed per chunk, `passes` sweeps over the chunks
//   inside one launch (the TPU's reps), so the slope over passes is the
//   cost of one sweep. Every product is consumed: a CTA owns a column tile
//   of acc and a strided share of the chunks, keeps its share of acc in
//   registers across all its chunks and passes, and writes it to
//   partial[g] at the end; the wrapper sums the partials over g. (The TPU
//   kept an [8, 128] corner; on the card a corner alone would let the
//   compiler drop the rest.)
//   * f32, M = 64 and 128 (block_dot_f32_kernel): IEEE fmaf on the CUDA
//     cores, the unit of K7 and K9; bound by 67 TFLOP/s, which the FMAs
//     reach only while shared loads issue well below them (one
//     shared-load wavefront a clock against four FMA instructions). So
//     each thread keeps an 8 x 8 register tile (rows rg*4.. and
//     M/2 + rg*4.., columns cg*4.. and NT/2 + cg*4..), and A is stored
//     k-major in shared memory: one k costs two float4 loads of A and two
//     of B for 64 FMAs, and a warp's loads cover 64 and 128 contiguous
//     bytes (one wavefront each). A
//     chunk runs as 4 k-slices of 32 through a ring of two stages: the
//     next slice's B comes by cp.async and its A into registers (then
//     transposed into its stage) while the current slice's FMAs run, one
//     barrier a slice. Resident B takes the same path (its slices come
//     from L2). 128 columns a CTA at M = 128 (256 at M = 64), two CTAs an
//     SM.
//   * f32, M = 8 (block_dot_f32_rows_kernel): the first design, kept
//     there: 8 rows do not fill an 8 x 8 tile of 256 threads. A chunk and
//     the CTA's B tile are staged in shared memory; each thread holds one
//     row x 4 columns, one float4 of B and a broadcast of A per k.
//   * bf16: A and B in bf16, f32 sums, on the tensor cores with mma.sync
//     m16n8k16 (what the TPU's MXU did at default precision). Fragments
//     come from shared memory by ldmatrix (B with .trans), rows padded by
//     16 bytes so that the eight 16-byte rows of a fragment fall in eight
//     bank groups. Bound: 989 TFLOP/s. It does not overlap the staging of
//     a chunk with its products.
// scatter_smem_kernel / scatter_l2_kernel  replace tpu_r2_probe.py
//   scatter_probe: per chunk, KCH = 8 accumulates of an (R = 8, F) slab
//   into a resident accumulator at offsets that are random multiples of R.
//   No float atomics: each output's terms are added in a fixed order.
//   * smem: the accumulator a CTA can hold, K7's 256 rows x 64 features
//     (64 KB of shared memory); the 512 features run as 8 tiles, and a
//     tile's chunks are shared over `groups` CTAs (12, in clusters of 4:
//     24 clusters, one wave; the card runs 15 of 8 and 7 of 16 at once). Bound: the 67 MB of slabs from device memory (one pass from
//     an empty L2). So the slabs come by bulk copy, not by thread loads:
//     a producer thread keeps a ring of 4 stages (a chunk's 64 rows
//     x 64 features, 16 KB, by one 2-D TMA copy, each stage on an
//     mbarrier) in flight, 64 KB an SM, while one
//     consumer thread per (row-in-block j, feature f) adds each slab row
//     j into acc[off * R + j][f], slab after slab, and its warp frees
//     the slot on an "empty" mbarrier (no CTA barrier a step). The groups
//     of a tile are summed in the same launch, from distributed shared
//     memory: rank r of a cluster adds its share of the rows over the
//     ranks in rank order (clusters, where a tile has more than one, in
//     cluster order through a ticket), so no partials are summed by a
//     second kernel and the order is fixed (probes/r2.py
//     scatter_smem_order).
//   * l2: the TPU's [4096, 512] f32 accumulator in device memory, as a
//     segment sum over a plan staged on the host (probes/r2.py
//     scatter_plan): the slabs sorted stably by destination block (perm)
//     and each block's run of them (seg). A persistent grid (8 CTAs of 256
//     threads an SM) walks the items (destination block, 128-feature
//     tile): a thread sums its float4 of the block's R x 128 outputs in
//     registers over the block's slabs, 16-byte loads with 8 slabs in
//     flight, and writes it once a pass (zeros for a block no slab hits).
//     The stable sort keeps each output's terms in (pass, chunk, slab)
//     order, that of a sequential loop. Bound: reading the 67 MB of
//     slabs from device memory, which
//     is what one pass does when the L2 holds none of them (the probe
//     times it so, the L2 emptied first); every SM streams them, 2048
//     threads an SM with 8 loads in flight each.
//
// C entry points return cudaGetLastError() (loops_scatter_smem_clusters a
// count).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda
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

// ------------------------------------------------------------- f32 dot
using loops_tc::cp_async16;
using loops_tc::cp_async_commit;
using loops_tc::cp_async_wait_all;

// M = 64 and 128: 8 x 8 register tiles, k-major A, two-stage k-slices
template <int M, int NT>
struct DotTile {
  static constexpr int RG = M / 8, CG = NT / 8;  // row and column groups
  static constexpr int kThreads = RG * CG;
  static constexpr int WR = RG / 4;              // warps along the rows
  static constexpr int KS = 32;                  // k a slice
  static constexpr int kSlices = kK / KS;
  static constexpr int LDA = M + 4;              // As[k][LDA], 16-byte rows
  static constexpr int kStage = KS * LDA + KS * NT;  // floats: A, then B
  static constexpr int kSmemFloats = 2 * kStage;
  static constexpr int kALoads = M * KS / 4 / kThreads;   // float4s a thread
  static constexpr int kBCopies = KS * NT / 4 / kThreads;  // 16-byte copies
  static_assert(RG % 4 == 0 && CG % 8 == 0 && kALoads >= 1 && kBCopies >= 1,
                "a warp is 4 row groups x 8 column groups");
};

// where a thread's i-th float4 of an A slice lies: row m, k-quad kq (a
// warp reads 8 rows x 4 quads, 64 contiguous bytes a row)
template <class T>
__device__ __forceinline__ void a_slot(int i, int& m, int& kq) {
  const int idx = threadIdx.x + T::kThreads * i;
  const int lane = idx & 31, w = idx >> 5;
  kq = (lane & 3) + 4 * (w & 1);
  m = (lane >> 2) + 8 * (w >> 1);
}

template <int M, int NT>
__global__ void __launch_bounds__(DotTile<M, NT>::kThreads, 2)
block_dot_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ partial, int nch, int stream_b,
                     int passes) {
  using T = DotTile<M, NT>;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int rg = (warp % T::WR) * 4 + (lane & 3);
  const int cg = (warp / T::WR) * 8 + (lane >> 2);
  const int n0 = blockIdx.x * NT;
  const int g = blockIdx.y, groups = gridDim.y;
  const int mine = (nch - g + groups - 1) / groups;  // chunks of this CTA
  const int items = passes * mine * T::kSlices;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  float4 ra[T::kALoads];
  // item -> (chunk, k0): passes x this CTA's chunks x k-slices, in order
  auto chunk_of = [&](int item) { return g + groups * ((item / T::kSlices) % mine); };
  auto load_a = [&](int item) {
    const float* src = A + static_cast<size_t>(chunk_of(item)) * M * kK +
                       (item % T::kSlices) * T::KS;
#pragma unroll
    for (int i = 0; i < T::kALoads; ++i) {
      int m, kq;
      a_slot<T>(i, m, kq);
      ra[i] = __ldg(reinterpret_cast<const float4*>(src + m * kK + 4 * kq));
    }
  };
  auto store_a = [&](float* As) {  // transposed: As[k][m]
#pragma unroll
    for (int i = 0; i < T::kALoads; ++i) {
      int m, kq;
      a_slot<T>(i, m, kq);
      float* d = As + 4 * kq * T::LDA + m;
      d[0] = ra[i].x;
      d[T::LDA] = ra[i].y;
      d[2 * T::LDA] = ra[i].z;
      d[3 * T::LDA] = ra[i].w;
    }
  };
  auto copy_b = [&](float* Bs, int item) {
    const float* src = B + (stream_b ? static_cast<size_t>(chunk_of(item)) * kK * kN : 0) +
                       static_cast<size_t>((item % T::kSlices) * T::KS) * kN + n0;
#pragma unroll
    for (int i = 0; i < T::kBCopies; ++i) {
      const int e = t + T::kThreads * i;
      const int k = e / (NT / 4), q = e % (NT / 4);
      cp_async16(Bs + k * NT + 4 * q, src + static_cast<size_t>(k) * kN + 4 * q, 16);
    }
    cp_async_commit();
  };

  if (items > 0) {
    load_a(0);
    copy_b(smem + T::KS * T::LDA, 0);
    store_a(smem);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int it = 0; it < items; ++it) {
    float* As = smem + (it & 1) * T::kStage;
    const float* Bs = As + T::KS * T::LDA;
    float* nxt = smem + ((it + 1) & 1) * T::kStage;
    const bool more = it + 1 < items;
    if (more) {
      load_a(it + 1);
      copy_b(nxt + T::KS * T::LDA, it + 1);
    }
#pragma unroll
    for (int k = 0; k < T::KS; ++k) {
      const float4 a0 = reinterpret_cast<const float4*>(As + k * T::LDA)[rg];
      const float4 a1 = reinterpret_cast<const float4*>(As + k * T::LDA + M / 2)[rg];
      const float4 b0 = reinterpret_cast<const float4*>(Bs + k * NT)[cg];
      const float4 b1 = reinterpret_cast<const float4*>(Bs + k * NT + NT / 2)[cg];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    if (more) store_a(nxt);
    cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = (r < 4 ? 0 : M / 2) + rg * 4 + (r & 3);
    float* dst = partial + (static_cast<size_t>(g) * M + row) * kN + n0;
    reinterpret_cast<float4*>(dst)[cg] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    reinterpret_cast<float4*>(dst + NT / 2)[cg] =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// M = 8: one row x 4 columns a thread, the chunk and B tile staged whole
constexpr int kRowsThreads = 256;
constexpr int kRowsNT = 128;             // columns per CTA
constexpr int kApad = kK + 1;            // A rows padded: rows in distinct banks
constexpr int kRowsSmemFloats = 8 * kApad + kK * kRowsNT;

// (min 1 CTA per SM: without it ptxas held the kernel to 32 registers
// and spilled)
__global__ void __launch_bounds__(kRowsThreads, 1)
block_dot_f32_rows_kernel(const float* __restrict__ A, const float* __restrict__ B,
                          float* __restrict__ partial, int nch, int stream_b,
                          int passes) {
  constexpr int M = 8, NT = kRowsNT, C4 = NT / 4;
  extern __shared__ float smem[];
  float* As = smem;               // [M][kApad]
  float* Bs = smem + M * kApad;   // [kK][NT]
  const int t = threadIdx.x;
  const int c4 = t % C4, r = t / C4;
  const int n0 = blockIdx.x * NT;
  const int g = blockIdx.y, groups = gridDim.y;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // the CTA's [kK][NT] column tile of a [kK][kN] B into shared memory
  auto stage_b = [&](const float* src) {
    for (int e = t; e < kK * C4; e += kRowsThreads) {
      const int k = e / C4, q = e % C4;
      reinterpret_cast<float4*>(Bs)[e] =
          reinterpret_cast<const float4*>(src + static_cast<size_t>(k) * kN + n0)[q];
    }
  };
  if (!stream_b) stage_b(B);
  for (int p = 0; p < passes; ++p) {
    for (int c = g; c < nch; c += groups) {
      __syncthreads();  // the previous chunk's reads are done
      const float4* a4 = reinterpret_cast<const float4*>(A + static_cast<size_t>(c) * M * kK);
      for (int e = t; e < M * kK / 4; e += kRowsThreads) {
        const float4 v = a4[e];
        float* dst = As + (4 * e) / kK * kApad + (4 * e) % kK;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
      if (stream_b) stage_b(B + static_cast<size_t>(c) * kK * kN);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kK; ++k) {
        const float4 b = reinterpret_cast<const float4*>(Bs + k * NT)[c4];
        const float a = As[r * kApad + k];
        acc[0] = fmaf(a, b.x, acc[0]);
        acc[1] = fmaf(a, b.y, acc[1]);
        acc[2] = fmaf(a, b.z, acc[2]);
        acc[3] = fmaf(a, b.w, acc[3]);
      }
    }
  }
  reinterpret_cast<float4*>(partial + (static_cast<size_t>(g) * M + r) * kN + n0)[c4] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
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

// the f32 tile's columns a CTA: 128 at M = 128, 256 at M = 64
template <int M>
constexpr int dot_nt() { return M == 128 ? 128 : 256; }

template <int M, int NT>
int launch_dot_f32(const void* A, const void* B, void* partial, int nch,
                   int stream_b, int passes, int groups, cudaStream_t s) {
  using T = DotTile<M, NT>;
  const int bytes = T::kSmemFloats * 4;
  auto k = block_dot_f32_kernel<M, NT>;
  if (const int e = set_smem(k, bytes)) return e;
  k<<<dim3(kN / NT, groups), T::kThreads, bytes, s>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(partial), nch, stream_b, passes);
  return static_cast<int>(cudaGetLastError());
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
  } else if constexpr (M == 8) {
    const int bytes = kRowsSmemFloats * 4;
    if (const int e = set_smem(block_dot_f32_rows_kernel, bytes)) return e;
    block_dot_f32_rows_kernel<<<dim3(kN / kRowsNT, groups), kRowsThreads, bytes, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<float*>(partial), nch, stream_b, passes);
  } else {
    return launch_dot_f32<M, dot_nt<M>()>(A, B, partial, nch, stream_b, passes,
                                          groups, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- scatter
// The smem accumulator's shapes: KCH slabs of R rows a chunk, a CTA's
// 64-feature tile of a chunk (64 x 64 f32, 16 KB) one stage of its ring.
constexpr int kScatterFT = 64;
constexpr int kScatterKch = 8, kScatterR = 8;
constexpr int kChunkRows = kScatterKch * kScatterR;
constexpr int kStageFloats = kChunkRows * kScatterFT;
constexpr int kScatterConsumers = kScatterR * kScatterFT;  // one per (j, f)
constexpr int kScatterThreads = kScatterConsumers + 32;    // + the producer
constexpr int kScatterStages = 4;       // the ring
constexpr int kScatterCluster = 4;      // CTAs a cluster
constexpr int kScatterMaxClusters = 8;  // clusters a tile

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

// CTA (g, tile) of a cluster of C = 4 along g: group g of `groups` takes the
// chunks g, g + groups, ... (passes times over) and adds them into its
// accumulator acc [acc_rows][64] in shared memory. Thread 512 is the
// producer: it waits for a free slot, arms its barrier with the stage's
// bytes and copies the chunk's [64 rows x 64 features] tile into it by
// one 2-D TMA copy (tmap: a as [nch * 64, F]), and the chunk's 8 block
// offsets beside it by a bulk copy. Consumer thread (j, f) owns column f
// of every accumulator row r with r % R == j: for each slab i it adds the
// stage's row i*R + j into row off[i]*R + j, slab after slab (a stage's
// loads issued together, the slabs of one block summed in registers),
// and its warp frees the slot. After the last chunk, rank r of the
// cluster sums its share of the accumulator rows over ranks 0..C-1, in
// rank order, read from their shared memory, and writes them to cpart
// [groups / C][acc_rows][F]; the cluster that takes a share's ticket last
// sums that share over the clusters in order into out (no float atomics).
__global__ void __launch_bounds__(kScatterThreads, 1)
scatter_smem_kernel(const __grid_constant__ CUtensorMap tmap,
                    const int* __restrict__ offs, float* __restrict__ out,
                    float* __restrict__ cpart, int* __restrict__ tickets,
                    int nch, int F, int acc_rows, int passes) {
  constexpr int C = kScatterCluster, stages = kScatterStages;
  extern __shared__ __align__(1024) float ssm[];
  float* ring = ssm;                                 // [stages][64][64]
  float* acc = ssm + stages * kStageFloats;          // [acc_rows][64]
  __shared__ __align__(8) unsigned long long full[stages];
  __shared__ __align__(8) unsigned long long empty[stages];
  __shared__ int4 soffs[stages][2];  // each stage's 8 block offsets
  __shared__ int last;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, lane = t & 31;
  const int g = blockIdx.x, groups = gridDim.x, tile = blockIdx.y;
  const int f0 = tile * kScatterFT;
  const int mine = g < nch ? (nch - g + groups - 1) / groups : 0;
  const int items = passes * mine;
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      loops_tc::mbar_init(loops_tc::smem_addr(&full[s]), 1);
      loops_tc::mbar_init(loops_tc::smem_addr(&empty[s]), kScatterConsumers / 32);
    }
  }
  for (int e = t; e < acc_rows * kScatterFT / 4; e += kScatterThreads) {
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  if (t == kScatterConsumers) {  // the producer: lane 0 of the last warp
    for (int it = 0; it < items; ++it) {
      const int s = it % stages;
      const unsigned use = it / stages;
      const unsigned fb = loops_tc::smem_addr(&full[s]);
      loops_tc::mbar_wait(loops_tc::smem_addr(&empty[s]), (use & 1) ^ 1);
      loops_tc::mbar_expect_tx(fb, kStageFloats * 4 + sizeof(soffs[s]));
      const int c = g + groups * (it % mine);
      loops_tc::bulk_copy(soffs[s], offs + c * kScatterKch, sizeof(soffs[s]), fb);
      loops_tc::tma_load_2d(ring + s * kStageFloats, &tmap, f0, c * kChunkRows, fb);
    }
  } else if (t < kScatterConsumers) {
    const int j = t / kScatterFT, f = t % kScatterFT;
    float* col = acc + j * kScatterFT + f;  // row j of block 0, column f
    for (int it = 0; it < items; ++it) {
      const int s = it % stages;
      loops_tc::mbar_wait(loops_tc::smem_addr(&full[s]), (it / stages) & 1);
      const int4 oa = soffs[s][0], ob = soffs[s][1];
      const int off[kScatterKch] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
      const float* st = ring + s * kStageFloats + j * kScatterFT + f;
      // all 8 loads of the stage and of the accumulator rows first; a
      // slab whose block an earlier slab of the chunk also hits takes
      // that one's sum, so each row still adds its slabs in slab order
      float x[kScatterKch], v[kScatterKch];
#pragma unroll
      for (int i = 0; i < kScatterKch; ++i) {
        x[i] = st[i * kScatterR * kScatterFT];
        v[i] = col[off[i] * (kScatterR * kScatterFT)];
      }
#pragma unroll
      for (int i = 0; i < kScatterKch; ++i) {
#pragma unroll
        for (int k = 0; k < i; ++k) v[i] = off[k] == off[i] ? v[k] : v[i];
        v[i] += x[i];
      }
      __syncwarp();
      if (lane == 0) loops_tc::mbar_arrive(loops_tc::smem_addr(&empty[s]));
      // in slab order: the last store to a row holds all its slabs
#pragma unroll
      for (int i = 0; i < kScatterKch; ++i) col[off[i] * (kScatterR * kScatterFT)] = v[i];
    }
  }
  cluster.sync();  // every accumulator of the cluster is complete
  const int rank = static_cast<int>(cluster.block_rank());
  const int share = (acc_rows + C - 1) / C;
  const int r0 = min(acc_rows, rank * share), r1 = min(acc_rows, r0 + share);
  const int n4 = (r1 - r0) * kScatterFT / 4;
  const int clusters = groups / C;
  float* dst = cpart + static_cast<size_t>(g / C) * acc_rows * F;
  for (int e = t; e < n4; e += kScatterThreads) {
    float4 v[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      v[q] = cluster.map_shared_rank(reinterpret_cast<float4*>(acc + r0 * kScatterFT), q)[e];
    }
    float4 sum = v[0];
#pragma unroll
    for (int q = 1; q < C; ++q) sum = add4(sum, v[q]);
    const int row = r0 + e / (kScatterFT / 4), c4 = e % (kScatterFT / 4);
    reinterpret_cast<float4*>(dst + static_cast<size_t>(row) * F + f0)[c4] = sum;
  }
  cluster.sync();  // no CTA leaves while another reads its accumulator
  __threadfence();
  __syncthreads();
  if (t == 0) {
    int* ticket = tickets + tile * C + rank;
    last = atomicAdd(ticket, 1) == clusters - 1;
    if (last) *ticket = 0;  // every cluster has arrived: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = t; e < n4; e += kScatterThreads) {
    const int row = r0 + e / (kScatterFT / 4), c4 = e % (kScatterFT / 4);
    const size_t at = static_cast<size_t>(row) * F + f0 + 4 * c4;
    float4 p[kScatterMaxClusters];  // every cluster's rows loaded, then added
#pragma unroll
    for (int q = 0; q < kScatterMaxClusters; ++q) {
      if (q < clusters) {
        p[q] = __ldcg(reinterpret_cast<const float4*>(
            cpart + static_cast<size_t>(q) * acc_rows * F + at));
      }
    }
    float4 sum = p[0];
#pragma unroll
    for (int q = 1; q < kScatterMaxClusters; ++q) {
      if (q < clusters) sum = add4(sum, p[q]);
    }
    reinterpret_cast<float4*>(out + at)[0] = sum;
  }
}

constexpr int kScatterSmem = (kScatterStages * kChunkRows) * kScatterFT * 4;

cudaLaunchConfig_t scatter_smem_config(int groups, int tiles, int acc_rows, cudaStream_t s,
                                       cudaLaunchAttribute* attr, int* err) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, tiles);
  cfg.blockDim = dim3(kScatterThreads);
  cfg.dynamicSmemBytes = kScatterSmem + acc_rows * kScatterFT * 4;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kScatterCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  *err = set_smem(scatter_smem_kernel, static_cast<int>(cfg.dynamicSmemBytes));
  return cfg;
}

// cuTensorMapEncodeTiled looked up at run time through the CUDA runtime,
// so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, F] f32 seen by the TMA in boxes of [64 rows x 64 features]
int slab_map(CUtensorMap* m, const float* a, int rows, int F) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(F) * 4};
  const cuuint32_t box[2] = {kScatterFT, kChunkRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A persistent grid over the items (destination block, feature tile),
// item = blk * tiles + tile: thread (j, q) of a CTA takes the float4 at
// row j, features 4q.. of the tile of each of its items. Each pass walks
// all the CTA's items, so a slab is read again only after the rest of a
// sweep (67 MB) has gone by; the L2 (50 MB) still holds part of it then,
// so a later pass reads less from device memory than the first. Pass 0
// starts each output at 0; a later pass carries it on from acc, where the
// same thread left it. passes >= 1 (the wrapper writes zeros for 0).
template <int FT, int U>
__global__ void __launch_bounds__(1024)
scatter_l2_kernel(const int* __restrict__ perm, const int* __restrict__ seg,
                  const float* __restrict__ a, float* __restrict__ acc,
                  int blocks, int rr, int F, int passes) {
  const int tiles = F / FT, items = blocks * tiles;
  const int j = threadIdx.x / (FT / 4), q = threadIdx.x % (FT / 4);
  const size_t slab = static_cast<size_t>(rr) * F;  // floats a slab
  auto load = [&](const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  };
  for (int pass = 0; pass < passes; ++pass) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int blk = item / tiles;
      const int f = (item % tiles) * FT + 4 * q;
      float4* dst = reinterpret_cast<float4*>(
          acc + (static_cast<size_t>(blk) * rr + j) * F + f);
      float4 sum = pass == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *dst;
      const float* src = a + static_cast<size_t>(j) * F + f;
      const int s1 = seg[blk + 1];
      int k = seg[blk];
      for (; k + U <= s1; k += U) {  // U slabs in flight, added in order
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) v[u] = load(src + perm[k + u] * slab);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sum.x += v[u].x;
          sum.y += v[u].y;
          sum.z += v[u].z;
          sum.w += v[u].w;
        }
      }
      for (; k < s1; ++k) {
        const float4 v = load(src + perm[k] * slab);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      *dst = sum;
    }
  }
}

template <int FT, int U>
int launch_scatter_l2(const void* perm, const void* seg, const void* a,
                      void* acc, int blocks, int rr, int F, int passes,
                      int ctas, cudaStream_t s) {
  if (F % FT || rr * FT / 4 > 1024 || ctas <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scatter_l2_kernel<FT, U><<<ctas, rr * FT / 4, 0, s>>>(
      static_cast<const int*>(perm), static_cast<const int*>(seg),
      static_cast<const float*>(a), static_cast<float*>(acc), blocks, rr, F,
      passes);
  return static_cast<int>(cudaGetLastError());
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

// offs [nch * 8] block offsets, a [nch, 64, F] (8 slabs of 8 rows a
// chunk; 16-byte aligned), out [acc_rows, F] (every element written);
// groups CTAs a 64-feature tile, a multiple of 4 up to 32; cpart
// [groups / 4, acc_rows, F] and tickets [F / 64 * 4] (zeros; left zero)
int loops_scatter_smem(const void* offs, const void* a, void* out, void* cpart,
                       void* tickets, int nch, int F, int acc_rows, int passes,
                       int groups, void* stream) {
  if (nch <= 0 || passes < 0 || acc_rows <= 0 || acc_rows % kScatterR || F <= 0 ||
      F % kScatterFT || kScatterSmem + acc_rows * kScatterFT * 4 > 227 * 1024 ||
      groups <= 0 || groups % kScatterCluster ||
      groups > kScatterMaxClusters * kScatterCluster || !cpart || !tickets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr[1];
  int err = 0;
  cudaLaunchConfig_t cfg = scatter_smem_config(groups, F / kScatterFT, acc_rows,
                                               static_cast<cudaStream_t>(stream), attr, &err);
  if (err) return err;
  const float* af = static_cast<const float*>(a);
  CUtensorMap tmap;
  if (const int e = slab_map(&tmap, af, nch * kChunkRows, F)) return e;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, scatter_smem_kernel, tmap, static_cast<const int*>(offs), static_cast<float*>(out),
      static_cast<float*>(cpart), static_cast<int*>(tickets), nch, F, acc_rows, passes));
}

// the clusters of the smem scatter (4 CTAs each, an accumulator of
// acc_rows rows) that the card runs at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error
int loops_scatter_smem_clusters(int acc_rows) {
  if (acc_rows <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  int err = 0;
  cudaLaunchConfig_t cfg = scatter_smem_config(kScatterCluster, 1, acc_rows, nullptr, attr, &err);
  int n = 0;
  if (!err) {
    err = static_cast<int>(cudaOccupancyMaxActiveClusters(&n, scatter_smem_kernel, &cfg));
  }
  return err ? -err : n;
}

// perm [nslabs] slab indices sorted stably by destination block, seg
// [blocks + 1] each block's run in perm, a [nslabs, rr, F], acc
// [blocks * rr, F] (every element written), over a grid of ctas CTAs
int loops_scatter_l2(const void* perm, const void* seg, const void* a,
                     void* acc, int blocks, int rr, int F, int passes,
                     int ctas, void* stream) {
  if (blocks <= 0 || rr <= 0 || passes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_scatter_l2<128, 8>(perm, seg, a, acc, blocks, rr, F, passes,
                                   ctas, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
