// CSR SpMV kernels for Hopper (sm_90a): y = A * x in float32.
//
// Three kernels, one per TPU kernel of loops_tpu's SpMV main path, plus
// the seam pass they share. All three keep the TPU kernels' contract:
//   * each row's atoms inside one plan block are summed in f32;
//   * a row split across block seams is combined deterministically: the
//     per-block partials are added in block order by one thread, so two
//     runs give bitwise-equal y;
//   * no float atomics anywhere.
// On the TPU the Pallas grid runs in order on one core and carries y
// across grid steps in VMEM. CUDA blocks run in no order, so each block
// writes the rows that lie wholly inside it straight to y and the partial
// sums of its first and last row to seam[2*b], seam[2*b+1];
// seam_kernel then adds those partials into y in block order.
//
// What bounds them on an H100: bytes. Per nonzero a kernel reads its
// value (4 B) and column (4 B) and gathers x[col] (4 B, a 32-byte sector
// from L2 when x fits in the 50 MB L2); per row it writes y (4 B). At 2
// flops per 8+ bytes SpMV sits far below the card's ridge point, so the
// design goal is coalesced streams over vals/cols and no extra passes
// over y; the random x[col] reads are what is left.
//
// C entry points take device pointers and the CUDA stream as void*,
// launch on that stream, never synchronize, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Sum of row r's partials from block c onwards, in block order, while the
// blocks still start inside row r.
__device__ __forceinline__ float walk_row(int r, int c, float s,
                                          const int* __restrict__ row_first,
                                          const int* __restrict__ row_last,
                                          const float* __restrict__ seam,
                                          int nb) {
  for (; c < nb && row_first[c] == r; ++c) {
    s += seam[2 * c];
    if (row_last[c] != r) break;
  }
  return s;
}

// Seam pass: one thread per block. The first block that touches a
// boundary row owns it and writes the row's total; later blocks that
// start inside the row only contribute their partial through the walk.
// row_first/row_last are the rows of a block's first and last atom, -1
// for a block with no atoms (such a block never sits inside a row).
__global__ void __launch_bounds__(kThreads)
seam_kernel(const int* __restrict__ row_first, const int* __restrict__ row_last,
            const float* __restrict__ seam, float* __restrict__ y, int nb) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int rf = row_first[b];
  if (rf < 0) return;
  const int rl = row_last[b];
  if (b == 0 || row_last[b - 1] != rf) {
    float s = seam[2 * b];
    if (rl == rf) s = walk_row(rf, b + 1, s, row_first, row_last, seam, nb);
    y[rf] = s;
  }
  if (rl != rf) {
    y[rl] = walk_row(rl, b + 1, seam[2 * b + 1], row_first, row_last, seam, nb);
  }
}

__device__ __forceinline__ void store_row(int row, int rf, int rl, int b,
                                          float s, float* __restrict__ y,
                                          float* __restrict__ seam) {
  if (row == rf) {
    seam[2 * b] = s;
  } else if (row == rl) {
    seam[2 * b + 1] = s;
  } else {
    y[row] = s;
  }
}

// K1 — replaces loops_tpu/ops/kernels/spmv_sorted.py sorted_spmv_bind
// (the sorted-gather kernel behind schedule='sorted_flat' and 'auto').
// The host plan's block cuts are kept: merge-path atoms <= K, row span
// <= 896, no block across a 32768-row stripe. The TPU's column sort,
// Benes unpermute and touch-loop gathers existed because the TPU has no
// general gather; Hopper gathers x[col] natively, so each block reads its
// atoms in CSR order straight from the CSR arrays.
//
// What bounds it on an H100 is the x[col] gather: one random 32-byte
// sector per nonzero, from L2 (or L1 for an x that fits there). A lane
// that walks one row at a time keeps one gather in flight and waits on
// its latency; measured on the card, once a thread keeps four or more in
// flight the time no longer moves with the count (1, 2, 4 quads), so
// what is left is the rate at which the card serves random sectors.
// The block works in two phases that do not look at rows until the
// second:
//   1. products: the block streams its atom range [cuts[b], cuts[b+1])
//      as 16-byte quads of vals and cols (cache-streaming loads, so the
//      stream of a matrix past L2 does not push x out), each
//      thread holding kK1Quads quads, that is 4 * kK1Quads gathers, in
//      flight, and writes vals[i] * x[cols[i]] to shared memory, aligned
//      so that a quad is one 16-byte store;
//   2. rows: each row of the block is summed from shared memory by a
//      group of `lanes_per_row` lanes (a power of two <= 32, picked on
//      the host from the mean row length), lane-strided partials then an
//      xor-shuffle tree: a fixed order, so two runs are bitwise equal.
// Interior rows go straight to y, the first and last row to the seam
// pass; the block also zero-writes the empty rows between its last row
// and the next block's first (block 0 those before its first), so every
// row of y is written and the wrapper allocates y with torch.empty.
// The products are rounded to f32 before they are summed, as in the plain
// version (vals * x[cols], then segment sums).
constexpr int kK1Threads = 256;
constexpr int kK1Quads = 2;      // 16-byte quads in flight per thread
constexpr int kK1MinBlocks = 4;  // CTAs an SM: 64 registers a thread
// row offsets of a block held in shared memory; a block whose span is
// wider (the host's span split gave up) reads them from device memory
constexpr int kK1RowWindow = 1024;

__global__ void __launch_bounds__(kK1Threads, kK1MinBlocks)
sorted_spmv_kernel(const int* __restrict__ offsets, const int* __restrict__ cols,
                   const float* __restrict__ vals, const int* __restrict__ cuts,
                   const int* __restrict__ row_first,
                   const int* __restrict__ row_last, const float* __restrict__ x,
                   float* __restrict__ y, float* __restrict__ seam, int rows,
                   int nb, int lanes_per_row, int vec) {
  extern __shared__ float4 prod4[];  // products of atoms [base, a1)
  __shared__ int offs[kK1RowWindow + 1];
  float* prod = reinterpret_cast<float*>(prod4);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int a0 = cuts[b], a1 = cuts[b + 1];
  const int r0 = row_first[b], r1 = row_last[b];
  const int nrows = r1 - r0 + 1;
  const int base = a0 & ~3;  // prod[i - base] holds atom i's product
  const bool offs_shared = nrows < kK1RowWindow;
  if (offs_shared) {
    for (int j = tid; j <= nrows; j += kK1Threads) offs[j] = offsets[r0 + j];
  }
  // empty rows up to the next block's first row (and, in block 0, before
  // this one's): nobody else writes them
  const int next = b + 1 < nb ? row_first[b + 1] : rows;
  for (int r = r1 + 1 + tid; r < next; r += kK1Threads) y[r] = 0.f;
  if (b == 0) {
    for (int r = tid; r < r0; r += kK1Threads) y[r] = 0.f;
  }

  // ---- 1. products into shared memory: whole quads [q0, q1) inside
  // [a0, a1), then the head [a0, head_end) and tail [tail_begin, a1) one
  // atom at a time (every atom when the arrays are not 16-byte aligned)
  int head_end = a1, tail_begin = a1;
  if (vec) {
    const int q0 = (a0 + 3) >> 2;
    const int q1 = max(q0, a1 >> 2);
    head_end = min(4 * q0, a1);
    tail_begin = max(4 * q1, head_end);
    const int4* c4 = reinterpret_cast<const int4*>(cols);
    const float4* v4 = reinterpret_cast<const float4*>(vals);
    for (int q = q0 + tid; q < q1; q += kK1Threads * kK1Quads) {
      int4 c[kK1Quads];
      float4 v[kK1Quads];
#pragma unroll
      for (int u = 0; u < kK1Quads; ++u) {
        const int qu = q + u * kK1Threads;
        if (qu < q1) {
          c[u] = __ldcs(c4 + qu);
          v[u] = __ldcs(v4 + qu);
        }
      }
      float4 xv[kK1Quads];
#pragma unroll
      for (int u = 0; u < kK1Quads; ++u) {
        if (q + u * kK1Threads < q1) {
          xv[u] = make_float4(__ldg(x + c[u].x), __ldg(x + c[u].y),
                              __ldg(x + c[u].z), __ldg(x + c[u].w));
        }
      }
#pragma unroll
      for (int u = 0; u < kK1Quads; ++u) {
        const int qu = q + u * kK1Threads;
        if (qu < q1) {
          prod4[qu - (base >> 2)] =
              make_float4(__fmul_rn(v[u].x, xv[u].x), __fmul_rn(v[u].y, xv[u].y),
                          __fmul_rn(v[u].z, xv[u].z), __fmul_rn(v[u].w, xv[u].w));
        }
      }
    }
  }
  for (int i = a0 + tid; i < head_end; i += kK1Threads) {
    prod[i - base] =
        __fmul_rn(__ldcs(vals + i), __ldg(x + __ldcs(cols + i)));
  }
  for (int i = tail_begin + tid; i < a1; i += kK1Threads) {
    prod[i - base] =
        __fmul_rn(__ldcs(vals + i), __ldg(x + __ldcs(cols + i)));
  }
  __syncthreads();

  // ---- 2. row sums from shared memory
  const int* ro = offs_shared ? offs : offsets + r0;
  const int g = lanes_per_row;
  const int lane = tid & (g - 1);
  const int group = tid / g;
  const int groups = kK1Threads / g;
  // the same trip count for every thread keeps the shuffles convergent
  const int trips = (nrows + groups - 1) / groups;
  for (int t = 0; t < trips; ++t) {
    const int j = t * groups + group;
    float acc = 0.f;
    if (j < nrows) {
      const int lo = max(ro[j], a0) - base;
      const int hi = min(ro[j + 1], a1) - base;
      for (int i = lo + lane; i < hi; i += g) acc += prod[i];
    }
    for (int off = g >> 1; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, off);
    }
    if (lane == 0 && j < nrows) store_row(r0 + j, r0, r1, b, acc, y, seam);
  }
}

// The rows of y that block b writes although no run of its own lands
// there, and no other block owns: the rows strictly inside (rf, rl) (the
// empty ones among them; the others are stored again after a
// __syncthreads), the empty rows from rl up to the next block with atoms
// (to the end of y when there is none), and in block 0 the rows before
// the first block with atoms. A block without atoms (rf == -1) writes
// none of the others. With these, K2 and K3 write every row of y, and
// the wrappers allocate it with torch.empty. The row_first of the 32
// blocks after b are loaded when the block starts (`ahead`, one a lane)
// and the rows written once its products are formed, so that the load's
// latency does not hold back the block's stream.
__device__ __forceinline__ int ahead_row_first(const int* __restrict__ row_first,
                                               int b, int nb) {
  const int c = b + 1 + (threadIdx.x & 31);
  return c < nb ? row_first[c] : -1;
}

__device__ __forceinline__ int next_row_first(const int* __restrict__ row_first,
                                              int ahead, int b, int nb,
                                              int rows) {
  // the first row_first[c] >= 0 with c > b, else rows; past the 32 blocks
  // of `ahead` each warp reads 32 at a time (the whole warp calls it)
  const int lane = threadIdx.x & 31;
  int v = ahead;
  for (int c = b + 1;;) {
    const unsigned m = __ballot_sync(kFull, v >= 0);
    if (m) return __shfl_sync(kFull, v, __ffs(m) - 1);
    c += 32;
    if (c >= nb) return rows;
    v = c + lane < nb ? row_first[c + lane] : -1;
  }
}

__device__ __forceinline__ void zero_unowned_rows(
    int b, int nb, int rows, int rf, int rl, int ahead,
    const int* __restrict__ row_first, float* __restrict__ y) {
  const int tid = threadIdx.x;
  if (rf >= 0) {
    for (int r = rf + 1 + tid; r < rl; r += blockDim.x) y[r] = 0.f;
    const int next = next_row_first(row_first, ahead, b, nb, rows);
    for (int r = rl + 1 + tid; r < next; r += blockDim.x) y[r] = 0.f;
  }
  if (b == 0) {
    const int first =
        rf >= 0 ? rf : next_row_first(row_first, ahead, 0, nb, rows);
    for (int r = tid; r < first; r += blockDim.x) y[r] = 0.f;
  }
}

// K2 — replaces loops_tpu/ops/kernels/spmv_flat_v2.py flat_spmv_pallas_v2
// (schedule='merge_path', impl='pallas2').
// Over the FlatBlockPlan's staged [B, K] arrays: the products
// vals*x[cols] (fused here; the TPU formed them outside its kernel) go
// through an in-block segmented inclusive scan keyed on the keep flags of
// the reference's _stage_extraction (keep == 0 starts a segment); the
// last slot of each row run holds the run's total and writes it to its
// row, t0 + rel (or to the seam buffer). The TPU's Mosaic compile
// envelopes (R > 4096, S*R > 2^22) do not exist here.
//
// What bounds it on an H100 is what bounds K1: the x[col] gather, one
// random sector per nonzero, served at the card's random-sector rate
// once enough gathers are in flight; on top of K1's bytes it streams 1 B
// of keep per slot and the rows of the quads that end a run. A scan that
// takes one slot a thread keeps one gather in flight and pays a CTA scan
// per 256 slots, so the design is CUB's reduce-by-key, register-blocked:
//   * each thread owns kK2Items = 8 consecutive slots, read as two
//     16-byte quads of vals and cols and one 32-bit word of keep flags
//     per quad (cache-streaming loads), so 8 gathers are in flight; the
//     rel quads that hold a run end are asked for before the gathers are
//     waited on, so their latency hides behind them;
//   * it folds its slots sequentially into (tail value, has a reset);
//   * one loops_scan::block_seg_scan over those pairs per kK2Chunk slots
//     (seg_scan.cuh, the very scan the K13 probe runs) gives each thread
//     the open segment's value before its first slot, and links chunks;
//   * the thread folds again from that value and stores each run end;
//     the keep flag of the slot after its last comes from the next lane
//     by a shuffle (lane 31 reads the byte).
// CTAs of 128 threads, 8 an SM: with merge-path blocks of ~1000 slots,
// 256-thread CTAs left half their threads without slots and ran 20–26%
// slower (measured on an H100 80GB HBM3 at 700 W, PERF.md section 6).
// The products are rounded to f32 before they are summed, as in the plain
// version; the order of the f32 additions is fixed, so two runs are
// bitwise equal.
constexpr int kK2Threads = 128;
constexpr int kK2Warps = kK2Threads / 32;
constexpr int kK2Quads = 2;
constexpr int kK2Items = 4 * kK2Quads;  // consecutive slots a thread
constexpr int kK2Chunk = kK2Threads * kK2Items;
constexpr int kK2MinBlocks = 8;  // CTAs an SM: 64 registers a thread

__device__ __forceinline__ int quad_at(const int4& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

__global__ void __launch_bounds__(kK2Threads, kK2MinBlocks)
flat_spmv_v2_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                    const uint8_t* __restrict__ keep, const int* __restrict__ rel,
                    const int* __restrict__ tile_starts,
                    const int* __restrict__ atom_starts,
                    const int* __restrict__ row_first,
                    const int* __restrict__ row_last, const float* __restrict__ x,
                    float* __restrict__ y, float* __restrict__ seam, int K,
                    int rows, int nb, int vec) {
  __shared__ float warp_v[kK2Warps];
  __shared__ int warp_f[kK2Warps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int n = atom_starts[b + 1] - atom_starts[b];
  const int rf = row_first[b], rl = row_last[b], t0 = tile_starts[b];
  const int ahead = ahead_row_first(row_first, b, nb);
  if (n == 0) {
    zero_unowned_rows(b, nb, rows, rf, rl, ahead, row_first, y);
    return;
  }
  const size_t base = static_cast<size_t>(b) * K;
  float carry = 0.f;  // the open segment's value before this chunk
  for (int c0 = 0; c0 < n; c0 += kK2Chunk) {
    const int s = c0 + kK2Items * threadIdx.x;  // this thread's first slot
    float p[kK2Items];
    // bit i: slot s + i starts a segment (keep == 0) or lies past n
    unsigned resets = 0;
    int4 c[kK2Quads], r[kK2Quads];
    float4 v[kK2Quads];
    if (vec) {
      unsigned kw[kK2Quads];
#pragma unroll
      for (int u = 0; u < kK2Quads; ++u) {
        const int q = s + 4 * u;
        if (q < n) {
          c[u] = __ldcs(reinterpret_cast<const int4*>(cols + base + q));
          v[u] = __ldcs(reinterpret_cast<const float4*>(vals + base + q));
          kw[u] = __ldcs(reinterpret_cast<const unsigned*>(keep + base + q));
        }
      }
#pragma unroll
      for (int u = 0; u < kK2Quads; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = s + 4 * u + e;
          if (k >= n || ((kw[u] >> (8 * e)) & 0xffu) == 0) {
            resets |= 1u << (4 * u + e);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kK2Items; ++i) {
        const int k = s + i;
        if (k < n) {
          const size_t a = base + k;
          p[i] = __fmul_rn(__ldcs(vals + a), __ldg(x + __ldcs(cols + a)));
          if (__ldcs(keep + a) == 0) resets |= 1u << i;
        } else {
          p[i] = 0.f;
          resets |= 1u << i;
        }
      }
    }
    // before the first store: block_seg_scan synchronises in between
    if (c0 == 0) zero_unowned_rows(b, nb, rows, rf, rl, ahead, row_first, y);
    // the flag of slot s + kK2Items: the next lane's first, or read
    const unsigned from_next = __shfl_down_sync(kFull, resets, 1) & 1u;
    unsigned next_reset = from_next;
    if (lane == 31) {
      const int k = s + kK2Items;
      next_reset = k < n ? __ldcs(keep + base + k) == 0 : 1u;
    }
    // bit i: slot s + i ends a run (the slot after it starts one)
    const unsigned ends = (resets >> 1) | (next_reset << (kK2Items - 1));
    if (vec) {
      // the rows of the quads that end a run, asked for before the
      // gathers are waited on
#pragma unroll
      for (int u = 0; u < kK2Quads; ++u) {
        const int q = s + 4 * u;
        if (q < n && (ends >> (4 * u) & 0xfu)) {
          r[u] = __ldcs(reinterpret_cast<const int4*>(rel + base + q));
        }
      }
#pragma unroll
      for (int u = 0; u < kK2Quads; ++u) {
        const int q = s + 4 * u;
        if (q < n) {
          const float4 xv = make_float4(__ldg(x + c[u].x), __ldg(x + c[u].y),
                                        __ldg(x + c[u].z), __ldg(x + c[u].w));
          p[4 * u] = __fmul_rn(v[u].x, xv.x);
          p[4 * u + 1] = __fmul_rn(v[u].y, xv.y);
          p[4 * u + 2] = __fmul_rn(v[u].z, xv.z);
          p[4 * u + 3] = __fmul_rn(v[u].w, xv.w);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (q + e >= n) p[4 * u + e] = 0.f;
        }
      }
    }
    float tail = 0.f;
#pragma unroll
    for (int i = 0; i < kK2Items; ++i) {
      tail = (resets >> i & 1u) ? p[i] : tail + p[i];
    }
    float run;  // the open segment's value before slot s
    loops_scan::block_seg_scan<kK2Warps>(tail, resets != 0, carry, warp_v,
                                         warp_f, run);
#pragma unroll
    for (int i = 0; i < kK2Items; ++i) {
      run = (resets >> i & 1u) ? p[i] : run + p[i];
      if (s + i < n && (ends >> i & 1u)) {
        const int row =
            vec ? quad_at(r[i >> 2], i & 3) : __ldcs(rel + base + s + i);
        store_row(t0 + row, rf, rl, b, run, y, seam);
      }
    }
  }
}

// K3 — replaces loops_tpu/ops/kernels/spmv_flat.py flat_spmv_pallas
// (schedule='merge_path', impl='pallas').
// The TPU reduced each block with a [K, R] one-hot matmul into its
// 128-aligned row window y[s0*128 : s0*128 + R]; here the same staging
// (rel relative to s0*128) is read, and each row run of the block is
// summed on its own.
//
// What bounds it on an H100 is what bounds K1: the x[col] gather, one
// random sector per nonzero, served at the card's random-sector rate once
// enough gathers are in flight; on top of K1's bytes it streams 4 B of
// rel per slot. A thread that walks a run alone keeps one gather in
// flight behind a chain of dependent loads, so the block works as K1's in
// two phases, over pieces of at most kK3Piece slots (the host's `piece`,
// a multiple of 4):
//   1. products: the piece's slots are streamed as 16-byte quads of vals,
//      cols and rel (cache-streaming loads), one quad a thread, and
//      vals[i] * x[cols[i]] and rel[i] go to shared memory;
//   2. runs: a run starts where rel changes; the warps find the starts by
//      ballots and write them in order; a group of `lanes_per_row` lanes
//      (a power of two <= 32, picked on the host from the plan's mean run
//      length) sums each run, lane-strided partials then an xor-shuffle
//      tree. The piece's last run is carried to the next piece (carry +
//      its next part), so a run across pieces is summed in a fixed order.
// CTAs of 128 threads, 8 an SM, and pieces of 512 slots: measured on an
// H100 80GB HBM3 at 700 W (PERF.md section 6), 256-thread CTAs of 2 quads
// a thread ran 22% slower on a matrix past L2, and 2 quads a thread in
// 128 ran 1–16% slower than one (a piece's shared memory takes from the
// L1 that serves x).
// Interior rows go to y[s0*128 + rel], the first and last row to the seam
// pass; two runs are bitwise equal, and no atomics are used.
constexpr int kK3Threads = 128;
constexpr int kK3Warps = kK3Threads / 32;
constexpr int kK3Piece = 4 * kK3Threads;  // one quad a thread: 512 slots
constexpr int kK3MinBlocks = 8;  // CTAs an SM: 64 registers a thread
// ballot rounds per warp to cover its share of a piece
constexpr int kK3Rounds = kK3Piece / kK3Warps / 32;

__global__ void __launch_bounds__(kK3Threads, kK3MinBlocks)
flat_spmv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                 const int* __restrict__ rel, const int* __restrict__ s0,
                 const int* __restrict__ atom_starts,
                 const int* __restrict__ row_first,
                 const int* __restrict__ row_last, const float* __restrict__ x,
                 float* __restrict__ y, float* __restrict__ seam, int K,
                 int rows, int nb, int piece, int lanes_per_row, int vec) {
  extern __shared__ float4 smem4[];
  float* prod = reinterpret_cast<float*>(smem4);  // [piece]
  // rel < MAX_WINDOW (58112, bounded on the host) fits 16 bits, and so
  // does a slot of the piece: 8 bytes of shared memory a slot, which
  // leaves the SM's L1 more room for x
  unsigned short* rels =
      reinterpret_cast<unsigned short*>(prod + piece);  // [piece]
  unsigned short* starts = rels + piece;  // [piece]: run starts, in order
  __shared__ int warp_count[kK3Warps];
  __shared__ float carry_v;  // the piece's last run, open at its end
  __shared__ int carry_r;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = atom_starts[b + 1] - atom_starts[b];
  const int rf = row_first[b], rl = row_last[b];
  const int ahead = ahead_row_first(row_first, b, nb);
  if (n == 0) {
    zero_unowned_rows(b, nb, rows, rf, rl, ahead, row_first, y);
    return;
  }
  const size_t base = static_cast<size_t>(b) * K;
  const int ybase = s0[b] * 128;
  const int g = lanes_per_row;
  const int glane = tid & (g - 1);
  const int group = tid / g;
  const int groups = kK3Threads / g;
  // each warp's share of a piece, whole ballot rounds
  const int wspan = ((piece + kK3Warps - 1) / kK3Warps + 31) & ~31;
  for (int p0 = 0; p0 < n; p0 += piece) {
    const int pn = min(piece, n - p0);
    // ---- 1. products and rel into shared memory
    if (vec) {
      // quads inside the row, as K % 4 == 0; one trip, as piece <= 4 *
      // kK3Threads, but as a loop it ran 10% faster on a matrix that fits
      // L2 than a guarded single quad (1% slower past L2; PERF.md sec. 6)
      const int nq = (pn + 3) >> 2;
      const int4* c4 = reinterpret_cast<const int4*>(cols + base + p0);
      const float4* v4 = reinterpret_cast<const float4*>(vals + base + p0);
      const int4* r4 = reinterpret_cast<const int4*>(rel + base + p0);
      for (int q = tid; q < nq; q += kK3Threads) {
        const int4 c = __ldcs(c4 + q);
        const float4 v = __ldcs(v4 + q);
        const int4 r = __ldcs(r4 + q);
        const float4 xv = make_float4(__ldg(x + c.x), __ldg(x + c.y),
                                      __ldg(x + c.z), __ldg(x + c.w));
        smem4[q] = make_float4(__fmul_rn(v.x, xv.x), __fmul_rn(v.y, xv.y),
                               __fmul_rn(v.z, xv.z), __fmul_rn(v.w, xv.w));
        reinterpret_cast<ushort4*>(rels)[q] = make_ushort4(r.x, r.y, r.z, r.w);
      }
    } else {
      for (int i = tid; i < pn; i += kK3Threads) {
        const size_t a = base + p0 + i;
        prod[i] = __fmul_rn(__ldcs(vals + a), __ldg(x + __ldcs(cols + a)));
        rels[i] = static_cast<unsigned short>(__ldcs(rel + a));
      }
    }
    // before the first store, a __syncthreads in between
    if (p0 == 0) zero_unowned_rows(b, nb, rows, rf, rl, ahead, row_first, y);
    __syncthreads();
    // the run left open by the last piece, read before it is rewritten
    const float cv = carry_v;
    const int cr = carry_r;
    const bool continued = p0 > 0 && rels[0] == cr;

    // ---- 2a. run starts (slot 0 of the piece always starts one)
    unsigned masks[kK3Rounds];
    int count = 0;
#pragma unroll
    for (int j = 0; j < kK3Rounds; ++j) {
      const int i = warp * wspan + 32 * j + lane;
      const bool start = 32 * j < wspan && i < pn &&
                         (i == 0 || rels[i] != rels[i - 1]);
      masks[j] = __ballot_sync(kFull, start);
      count += __popc(masks[j]);
    }
    if (lane == 0) warp_count[warp] = count;
    __syncthreads();
    int at = 0, ns = 0;
    for (int w = 0; w < kK3Warps; ++w) {
      const int cw = warp_count[w];
      if (w < warp) at += cw;
      ns += cw;
    }
#pragma unroll
    for (int j = 0; j < kK3Rounds; ++j) {
      const unsigned m = masks[j];
      if (m >> lane & 1u) {
        starts[at + __popc(m & ((1u << lane) - 1u))] =
            warp * wspan + 32 * j + lane;
      }
      at += __popc(m);
    }
    __syncthreads();

    // ---- 2b. each run summed by a lane group; the same trip count for
    // every thread keeps the shuffles convergent
    const int trips = (ns + groups - 1) / groups;
    for (int t = 0; t < trips; ++t) {
      const int j = t * groups + group;
      float acc = 0.f;
      int lo = 0;
      if (j < ns) {
        lo = starts[j];
        const int hi = j + 1 < ns ? starts[j + 1] : pn;
        for (int i = lo + glane; i < hi; i += g) acc += prod[i];
      }
      for (int off = g >> 1; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (glane == 0 && j < ns) {
        if (j == 0 && continued) acc = cv + acc;
        if (j == ns - 1) {
          carry_v = acc;
          carry_r = rels[lo];
        } else {
          store_row(ybase + rels[lo], rf, rl, b, acc, y, seam);
        }
      }
    }
    // the last piece's open run ended with it
    if (tid == 0 && p0 > 0 && !continued) {
      store_row(ybase + cr, rf, rl, b, cv, y, seam);
    }
    __syncthreads();
  }
  if (tid == 0) store_row(ybase + carry_r, rf, rl, b, carry_v, y, seam);
}

int launch_seam(const int* row_first, const int* row_last, const float* seam,
                float* y, int nb, cudaStream_t stream) {
  seam_kernel<<<(nb + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      row_first, row_last, seam, y, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// max_atoms: the longest block's atom count, which sizes the products'
// shared memory (opted in past the default 48 KB)
int loops_sorted_spmv_f32(const void* offsets, const void* cols,
                          const void* vals, const void* cuts,
                          const void* row_first, const void* row_last,
                          const void* x, void* y, void* seam, int rows, int nb,
                          int lanes_per_row, int max_atoms, void* stream) {
  if (nb <= 0 || max_atoms <= 0 || lanes_per_row <= 0 || lanes_per_row > 32 ||
      (lanes_per_row & (lanes_per_row - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // room for the quad-aligned range [a0 & ~3, a1)
  const int smem = (max_atoms + 4) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sorted_spmv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec = (reinterpret_cast<uintptr_t>(cols) |
                   reinterpret_cast<uintptr_t>(vals)) % 16 == 0;
  sorted_spmv_kernel<<<nb, kK1Threads, smem, s>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const int*>(cuts),
      static_cast<const int*>(row_first), static_cast<const int*>(row_last),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(seam), rows, nb, lanes_per_row, vec);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_seam(static_cast<const int*>(row_first),
                     static_cast<const int*>(row_last),
                     static_cast<const float*>(seam), static_cast<float*>(y),
                     nb, s);
}

int loops_flat_spmv_v2_f32(const void* vals, const void* cols,
                           const void* keep, const void* rel,
                           const void* tile_starts, const void* atom_starts,
                           const void* row_first, const void* row_last,
                           const void* x, void* y, void* seam, int rows,
                           int nb, int K, void* stream) {
  if (nb <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // quads of vals, cols and rel, words of keep: every row of [B, K]
  // starts on a quad when K % 4 == 0
  const int vec = K % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(cols) |
                   reinterpret_cast<uintptr_t>(vals) |
                   reinterpret_cast<uintptr_t>(rel)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(keep) % 4 == 0;
  flat_spmv_v2_kernel<<<nb, kK2Threads, 0, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const uint8_t*>(keep), static_cast<const int*>(rel),
      static_cast<const int*>(tile_starts), static_cast<const int*>(atom_starts),
      static_cast<const int*>(row_first), static_cast<const int*>(row_last),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(seam), K, rows, nb, vec);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_seam(static_cast<const int*>(row_first),
                     static_cast<const int*>(row_last),
                     static_cast<const float*>(seam), static_cast<float*>(y),
                     nb, s);
}

// piece: the slots a block takes at a time, a multiple of 4 up to
// kK3Piece (the host passes min(kK3Piece, K rounded up to 4)); it sizes
// the shared memory, 8 bytes a slot. Every rel must be below 65536 (the
// host bounds it by 58112).
int loops_flat_spmv_f32(const void* vals, const void* cols, const void* rel,
                        const void* s0, const void* atom_starts,
                        const void* row_first, const void* row_last,
                        const void* x, void* y, void* seam, int rows, int nb,
                        int K, int piece, int lanes_per_row, void* stream) {
  if (nb <= 0 || K <= 0 || piece <= 0 || piece > kK3Piece || piece % 4 ||
      lanes_per_row <= 0 || lanes_per_row > 32 ||
      (lanes_per_row & (lanes_per_row - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = 8 * piece;
  const int vec = K % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(cols) |
                   reinterpret_cast<uintptr_t>(vals) |
                   reinterpret_cast<uintptr_t>(rel)) % 16 == 0;
  flat_spmv_kernel<<<nb, kK3Threads, smem, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const int*>(rel), static_cast<const int*>(s0),
      static_cast<const int*>(atom_starts), static_cast<const int*>(row_first),
      static_cast<const int*>(row_last), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<float*>(seam), K, rows, nb, piece,
      lanes_per_row, vec);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_seam(static_cast<const int*>(row_first),
                     static_cast<const int*>(row_last),
                     static_cast<const float*>(seam), static_cast<float*>(y),
                     nb, s);
}

}  // extern "C"
