// CSR SpMV kernels for Hopper (sm_90a): y = A * x in float32.
//
// Three kernels, one per TPU kernel of loops_tpu's SpMV main path, and
// the seam pass K2 and K3 share. All three keep the TPU kernels' contract:
//   * each row's atoms inside one plan block are summed in f32;
//   * a row split across block seams is combined deterministically: the
//     per-block partials are added in block order by one thread, so two
//     runs give bitwise-equal y;
//   * no float atomics anywhere.
// On the TPU the Pallas grid runs in order on one core and carries y
// across grid steps in VMEM. CUDA blocks run in no order: K2 and K3
// write the rows that lie wholly inside a block straight to y and the
// partial sums of its first and last row to seam[2*b], seam[2*b+1], and
// seam_kernel then adds those partials into y in block order; K1 walks a
// contiguous range of blocks per CTA, carries the partials from block to
// block itself, and its last CTA adds the few seams between ranges (one
// launch).
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
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "seg_scan.cuh"
#include "tensor_core.cuh"

namespace {

using loops_tc::bulk_copy_hint;
using loops_tc::cp_async4;
using loops_tc::cp_async_arrive;
using loops_tc::fence_proxy_async;
using loops_tc::l2_evict_first;
using loops_tc::mbar_arrive;
using loops_tc::mbar_expect_tx;
using loops_tc::mbar_init;
using loops_tc::mbar_wait;
using loops_tc::smem_addr;

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
// What bounds it on an H100: the bytes of vals and cols (8 per nonzero,
// read once) and the work of summing rows when x's gathers are local,
// the x[col] gather (one random L2 sector per nonzero) when they are
// not. The stream wants loads in flight all the time: ~25 KB an SM to
// keep the HBM rate. So K1 is one persistent launch:
//   * grid: min(nb, CTAs_an_SM * SMs) CTAs; CTA k walks the plan blocks
//     [k * nb / grid, (k + 1) * nb / grid) in block order, each block in
//     pieces of at most `piece` atoms (one piece for blocks of <= 1024);
//   * a producer warp stages each coming piece's vals and cols, and its
//     block's row offsets, into a ring of kK1Stages shared-memory stages:
//     the 16-byte aligned middle of each range by one cp.async.bulk, the
//     few 4-byte ends by cp.async, all counted on the stage's mbarrier;
//     it waits only for a free stage, so the stream never stops for the
//     row sums;
//   * 8 consumer warps form each piece's products vals * x[cols] in place
//     (the gathers of the next piece are issued before the row sums of
//     the current one, so their latency hides behind them), then sum
//     each row of the piece from shared memory in the order the
//     two-phase kernel before it did: `lanes_per_row` lane partials (a
//     power of two <= 32, picked on the host from the mean row length),
//     lane-strided, then the xor tree. A piece of short rows is summed
//     one row a thread, any other four lanes a thread (k1_rows); a
//     lane's partial of a row cut by a piece boundary is carried to the
//     next piece, so the sum's order does not depend on the pieces;
//   * the seams: the value of a row cut by a block boundary is the
//     partials of its blocks added in block order, the first partial
//     first (walk_row's order). Inside a CTA the fold is carried in
//     shared memory from block to block. A row cut by a CTA boundary
//     leaves the prefix its first CTA folded in seam_tail[k] and each
//     later block's partial in seam_part[b]; the last CTA to finish
//     (an integer ticket, which it resets for the next launch) adds them
//     in block order. So an apply is one launch, and y is written once
//     per row, empty rows included (y comes from torch.empty).
// The products are rounded to f32 before they are summed, as in the plain
// version (vals * x[cols], then segment sums); the order of every f32
// addition is fixed, so two runs are bitwise equal and equal the
// two-kernel K1 of earlier versions bit for bit. No float atomics.
constexpr int kK1ConsumerWarps = 8;
constexpr int kK1Consumers = 32 * kK1ConsumerWarps;
constexpr int kK1Threads = kK1Consumers + 32;  // + the producer warp
constexpr int kK1Stages = 4;
constexpr int kK1MinBlocks = 3;  // CTAs an SM: 72 registers a thread
// a piece's atoms and a stage's row offsets at most (the host's `piece`
// and `window` are multiples of 4 up to these); a block with more rows
// reads its offsets from device memory
constexpr int kK1PieceMax = 1024;
constexpr int kK1WindowMax = 1024;
constexpr int kK1MetaWords = 12;
// the largest stage: vals, cols (4 words of slack each, for the quad
// alignment), offsets and the piece's description, in 4-byte words
constexpr int kK1MaxStageWords =
    2 * (kK1PieceMax + 4) + kK1WindowMax + 4 + kK1MetaWords;
constexpr int kK1MaxSmem = kK1Stages * kK1MaxStageWords * 4;
// Meta flags
constexpr int kK1Cin = 1;      // the block's first row goes on from block b - 1
constexpr int kK1Cout = 2;     // its last row goes on into block b + 1
constexpr int kK1Window = 4;   // its row offsets are staged
constexpr int kK1Named = 1;    // the consumers' named barrier

// The plan as the host packs it once at bind (spmv_sorted._SortedPlan
// mirrors it field for field).
struct SortedPlan {
  const int* offsets;
  const int* cols;
  const float* vals;
  const int* cuts;
  const int* row_first;
  const int* row_last;
  int rows, nb, lanes_per_row, grid, piece, window;
};

__device__ __forceinline__ int k1_range_start(int k, int nb, int grid) {
  return static_cast<int>(static_cast<long long>(k) * nb / grid);
}

// The ring: stage s holds vals [piece + 4], cols [piece + 4], offsets
// [window + 4] and the piece's description, atom i at [i - (p0 & ~3)]
// and row offset r at [r - (r0 & ~3)], so aligned quads stay aligned.
struct K1Ring {
  int* base;
  int cap_p, cap_w, stride;
  __device__ float* vals(int s) const {
    return reinterpret_cast<float*>(base + s * stride);
  }
  __device__ int* cols(int s) const { return base + s * stride + cap_p; }
  __device__ int* offs(int s) const { return base + s * stride + 2 * cap_p; }
  __device__ int* meta(int s) const {
    return base + s * stride + 2 * cap_p + cap_w;
  }
};

// The description of a staged piece: atoms [p0, p1) of block b, whose
// atoms are [a0, a1) and rows [r0, r1]; `next` is the next block's first
// row (rows after the last block).
struct K1Piece {
  int b, p0, p1, a0, a1, r0, r1, next, flags;
};

__device__ __forceinline__ K1Piece k1_read_meta(const int* m) {
  const int4 u = reinterpret_cast<const int4*>(m)[0];
  const int4 v = reinterpret_cast<const int4*>(m)[1];
  return K1Piece{u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w, m[8]};
}

// Elements [i0, i1) of a 4-byte array go to dst[i - (i0 & ~3)]: the
// 16-byte aligned middle [m0, m1) (empty unless `aligned`) by one bulk
// copy, the rest 4 bytes a lane (k1_copy_ends).
__device__ __forceinline__ void k1_split(int i0, int i1, bool aligned, int& m0,
                                         int& m1) {
  m0 = i1;
  m1 = i1;
  if (aligned) {
    m0 = min((i0 + 3) & ~3, i1);
    m1 = max(m0, i1 & ~3);
  }
}

__device__ __forceinline__ void k1_copy_ends(int* dst, const int* src, int i0,
                                             int i1, int m0, int m1,
                                             int lane) {
  const int base = i0 & ~3;
  for (int i = i0 + lane; i < m0; i += 32) cp_async4(dst + (i - base), src + i);
  for (int i = m1 + lane; i < i1; i += 32) cp_async4(dst + (i - base), src + i);
}

// The producer warp: every piece of blocks [B0, B1) in order into the
// ring, each once its stage is free.
__device__ void k1_produce(const SortedPlan& p, const K1Ring& ring,
                           unsigned long long* full, unsigned long long* empty,
                           int B0, int B1, int lane) {
  const bool vec = (reinterpret_cast<uintptr_t>(p.cols) |
                    reinterpret_cast<uintptr_t>(p.vals)) % 16 == 0;
  const bool ovec = reinterpret_cast<uintptr_t>(p.offsets) % 16 == 0;
  // the stream is read once: it must not push x and y out of L2
  const unsigned long long once = l2_evict_first();
  int stage = 0;
  unsigned phase = 0;
  for (int base = B0; base < B1; base += 32) {
    // 32 blocks' descriptions at a time, one a lane
    const int bl = base + lane;
    int a0 = 0, a1 = 0, r0 = 0, r1 = 0, nxt = 0, fl = 0;
    if (bl < B1) {
      a0 = __ldg(p.cuts + bl);
      a1 = __ldg(p.cuts + bl + 1);
      r0 = __ldg(p.row_first + bl);
      r1 = __ldg(p.row_last + bl);
      nxt = bl + 1 < p.nb ? __ldg(p.row_first + bl + 1) : p.rows;
      const int prev = bl > 0 ? __ldg(p.row_last + bl - 1) : -1;
      fl = (prev == r0 ? kK1Cin : 0) | (nxt == r1 ? kK1Cout : 0) |
           (r1 - r0 + 2 <= p.window ? kK1Window : 0);
    }
    const int n = min(32, B1 - base);
    for (int u = 0; u < n; ++u) {
      const int A0 = __shfl_sync(kFull, a0, u), A1 = __shfl_sync(kFull, a1, u);
      const int R0 = __shfl_sync(kFull, r0, u), R1 = __shfl_sync(kFull, r1, u);
      const int NX = __shfl_sync(kFull, nxt, u), FL = __shfl_sync(kFull, fl, u);
      for (int p0 = A0; p0 < A1; p0 += p.piece) {
        const int p1 = min(A1, p0 + p.piece);
        const unsigned fb = smem_addr(full + stage);
        mbar_wait(smem_addr(empty + stage), phase ^ 1);
        float* sv = ring.vals(stage);
        int* sc = ring.cols(stage);
        int* so = ring.offs(stage);
        int q0, q1, o0, o1;
        k1_split(p0, p1, vec, q0, q1);
        const bool window = FL & kK1Window;
        if (window) {
          k1_split(R0, R1 + 2, ovec, o0, o1);
        } else {
          o0 = o1 = 0;
        }
        if (lane == 0) {
          int* m = ring.meta(stage);
          reinterpret_cast<int4*>(m)[0] = make_int4(base + u, p0, p1, A0);
          reinterpret_cast<int4*>(m)[1] = make_int4(A1, R0, R1, NX);
          m[8] = FL;
          mbar_expect_tx(fb, 8u * (q1 - q0) + 4u * (o1 - o0));
          if (q1 > q0) {
            const int at = q0 - (p0 & ~3);
            bulk_copy_hint(sv + at, p.vals + q0, 4u * (q1 - q0), fb, once);
            bulk_copy_hint(sc + at, p.cols + q0, 4u * (q1 - q0), fb, once);
          }
          if (o1 > o0) {
            bulk_copy_hint(so + (o0 - (R0 & ~3)), p.offsets + o0,
                           4u * (o1 - o0), fb, once);
          }
        }
        k1_copy_ends(reinterpret_cast<int*>(sv),
                     reinterpret_cast<const int*>(p.vals), p0, p1, q0, q1, lane);
        k1_copy_ends(sc, p.cols, p0, p1, q0, q1, lane);
        if (window) k1_copy_ends(so, p.offsets, R0, R1 + 2, o0, o1, lane);
        cp_async_arrive(fb);
        if (++stage == kK1Stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

// A consumer thread's quads of a piece, their values and gathered x,
// loaded before the row sums of the piece before, multiplied after: the
// piece's first kK1QuadSlots * kK1Consumers quads (1024 atoms); the few
// past them (a piece of 1024 atoms not on a quad boundary spans 257)
// are gathered and multiplied at once.
constexpr int kK1QuadSlots = kK1PieceMax / 4 / kK1Consumers;
struct K1Quads {
  float4 v[kK1QuadSlots], xv[kK1QuadSlots];
};

// What only some pieces need (their ragged ends, rows cut by a piece,
// the row search of a cut block) is called out of line, to keep the
// consumers' loop over pieces short and its registers free.

// x at the ragged quad of a piece whose atoms i = 4 q' ... start at i:
// the atoms outside [p0, p1) gather nothing
__device__ __noinline__ float4 k1_xquad_ragged(int i, int p0, int p1, int4 c,
                                               const float* __restrict__ x) {
  return make_float4(i >= p0 && i < p1 ? __ldg(x + c.x) : 0.f,
                     i + 1 >= p0 && i + 1 < p1 ? __ldg(x + c.y) : 0.f,
                     i + 2 >= p0 && i + 2 < p1 ? __ldg(x + c.z) : 0.f,
                     i + 3 >= p0 && i + 3 < p1 ? __ldg(x + c.w) : 0.f);
}

// x at quad q of a piece (atoms 4 q ... of the stage, sb = p0 & ~3)
__device__ __forceinline__ float4 k1_xquad(const K1Piece& m, int sb, int q,
                                           int4 c, const float* __restrict__ x) {
  const int i = sb + 4 * q;
  if (i >= m.p0 && i + 4 <= m.p1) {
    return make_float4(__ldg(x + c.x), __ldg(x + c.y), __ldg(x + c.z),
                       __ldg(x + c.w));
  }
  return k1_xquad_ragged(i, m.p0, m.p1, c, x);
}

__device__ __forceinline__ float4 k1_mul4(float4 v, float4 x) {
  return make_float4(__fmul_rn(v.x, x.x), __fmul_rn(v.y, x.y),
                     __fmul_rn(v.z, x.z), __fmul_rn(v.w, x.w));
}

__device__ __forceinline__ void k1_gather(const K1Ring& ring, int s,
                                          const K1Piece& m,
                                          const float* __restrict__ x,
                                          int ctid, K1Quads& g) {
  const int sb = m.p0 & ~3;
  const int nq = (m.p1 - sb + 3) >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(ring.vals(s));
  const int4* c4 = reinterpret_cast<const int4*>(ring.cols(s));
#pragma unroll
  for (int u = 0; u < kK1QuadSlots; ++u) {
    const int q = ctid + u * kK1Consumers;
    if (q < nq) {
      g.v[u] = v4[q];
      g.xv[u] = k1_xquad(m, sb, q, c4[q], x);
    }
  }
}

// Forms the piece's products; returns whether its rows are all short (a
// whole block, its offsets staged, every row at most 2 g products), for
// the AND over the consumers (k1_consumers_all).
__device__ __forceinline__ bool k1_products(const K1Ring& ring, int s,
                                            const K1Piece& m,
                                            const float* __restrict__ x,
                                            float* __restrict__ y, int ctid,
                                            const K1Quads& g, int lanes_per_row) {
  const int sb = m.p0 & ~3;
  const int nq = (m.p1 - sb + 3) >> 2;
  float4* v4 = reinterpret_cast<float4*>(ring.vals(s));
#pragma unroll
  for (int u = 0; u < kK1QuadSlots; ++u) {
    const int q = ctid + u * kK1Consumers;
    if (q < nq) v4[q] = k1_mul4(g.v[u], g.xv[u]);
  }
  for (int q = ctid + kK1QuadSlots * kK1Consumers; q < nq; q += kK1Consumers) {
    const int4 c = reinterpret_cast<const int4*>(ring.cols(s))[q];
    v4[q] = k1_mul4(v4[q], k1_xquad(m, sb, q, c, x));
  }
  // the products overwrite bytes a bulk copy will write again
  fence_proxy_async();
  if (m.p0 == m.a0) {
    // the empty rows up to the next block's first (block 0: before its
    // own first too): nobody else writes them
    for (int r = m.r1 + 1 + ctid; r < m.next; r += kK1Consumers) y[r] = 0.f;
    if (m.b == 0) {
      for (int r = ctid; r < m.r0; r += kK1Consumers) y[r] = 0.f;
    }
  }
  if (m.p0 != m.a0 || m.p1 != m.a1 || !(m.flags & kK1Window)) return false;
  const int* ro = ring.offs(s) + (m.r0 & 3);
  bool short_rows = true;
  for (int j = ctid; j <= m.r1 - m.r0; j += kK1Consumers) {
    short_rows &= min(ro[j + 1], m.a1) - max(ro[j], m.a0) <= 2 * lanes_per_row;
  }
  return short_rows;
}

// first m in [1, n] with ro[m] >= key (ro[n] >= key)
__device__ __forceinline__ int k1_lower_bound(const int* ro, int n, int key) {
  int lo = 1, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ro[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The rows [jf, jl] a piece of a cut block holds atoms of, and the empty
// rows at its atoms (a whole block: all of them).
__device__ __noinline__ int2 k1_piece_rows(const int* ro, int nrows, int p0,
                                           int p1, int a0, int a1) {
  int jf = 0, jl = nrows - 1;
  if (p0 > a0) {
    const int lb = k1_lower_bound(ro, nrows, p0);
    jf = ro[lb] == p0 ? lb : lb - 1;
  }
  if (p1 < a1) jl = k1_lower_bound(ro, nrows, p1) - 1;
  return make_int2(jf, jl);
}

struct K1Seams {
  float* tail;   // [grid]: the prefix of the row a CTA's range ends inside
  float* part;   // [nb]: a block's partial of a row that came from an
                 // earlier CTA's range
  float* row;    // shared [2]: the fold carried into block b, at b & 1
  float* lanes;  // shared [2][32]: lane partials carried into a piece
};

// Row j of the piece, whose value in this block is v: to y, or folded
// into the carry to the next block, or left in the seams.
__device__ __forceinline__ void k1_finish(const K1Piece& m, int j, int nrows,
                                          float v, int hc, int k, int B1,
                                          float* __restrict__ y,
                                          const K1Seams& seams) {
  const int r = m.r0 + j;
  if (r == hc) {
    seams.part[m.b] = v;
    return;
  }
  if (j == 0 && (m.flags & kK1Cin)) v = seams.row[m.b & 1] + v;
  if (j == nrows - 1 && (m.flags & kK1Cout)) {
    if (m.b + 1 < B1) {
      seams.row[(m.b + 1) & 1] = v;
    } else {
      seams.tail[k] = v;
    }
  } else {
    y[r] = v;
  }
}

// Lane l's partial of a row that began in an earlier piece, from that
// piece's carry a: a += prod[i - sb] for i = s0 + l, s0 + l + g, ... in
// [lo, hi).
__device__ __forceinline__ float k1_lane(const float* prod, int sb, int s0,
                                         int lo, int hi, int l, int g,
                                         float a) {
  int i = s0 + l;
  if (i < lo) i += (lo - i + g - 1) / g * g;
  for (; i < hi; i += g) a += prod[i - sb];
  return a;
}

// The four lanes (l0, l1, l2, l3; as many as g has) of a row that began
// in an earlier piece, each from its carried partial.
__device__ __noinline__ float4 k1_lanes_carried(const float* prod, int sb,
                                                int s0, int p0, int hi,
                                                int4 l, int g,
                                                const float* carry) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  a.x = k1_lane(prod, sb, s0, p0, hi, l.x, g, carry[l.x]);
  if (g >= 2) a.y = k1_lane(prod, sb, s0, p0, hi, l.y, g, carry[l.y]);
  if (g >= 4) {
    a.z = k1_lane(prod, sb, s0, p0, hi, l.z, g, carry[l.z]);
    a.w = k1_lane(prod, sb, s0, p0, hi, l.w, g, carry[l.w]);
  }
  return a;
}

// A short row's value (at most 2 G products from p) summed by one thread
// in the order the lane groups sum it: lane l's partial 0 + p[l] +
// p[l + G], then lane 0 of the xor tree, F(0, 1) with F(l, o) = F(l, 2 o)
// + F(l + o, 2 o) and F(l, G) lane l's partial (IEEE addition commutes,
// so which lane's value comes first does not change a sum). All indices
// are constants: no array, no local memory.
template <int G, int O, int L>
__device__ __forceinline__ float k1_tree(const float* p, int n) {
  if constexpr (O == G) {
    float a = 0.f;
    if (L < n) a += p[L];
    if (L + G < n) a += p[L + G];
    return a;
  } else {
    return k1_tree<G, 2 * O, L>(p, n) + k1_tree<G, 2 * O, L + O>(p, n);
  }
}

__device__ __forceinline__ float k1_row_value(const float* p, int n, int g) {
  switch (g) {
    case 1: return k1_tree<1, 1, 0>(p, n);
    case 2: return k1_tree<2, 1, 0>(p, n);
    case 4: return k1_tree<4, 1, 0>(p, n);
    case 8: return k1_tree<8, 1, 0>(p, n);
    case 16: return k1_tree<16, 1, 0>(p, n);
    default: return k1_tree<32, 1, 0>(p, n);
  }
}

// The row sums of one staged piece (its products formed), parity `par`
// of the lane carry; `hc` is the row this CTA's range starts inside of
// (-1 when it starts on a row boundary). A row's value is lanes_per_row
// = g lane partials (lane l: products l, l + g, ... from the row's start)
// reduced by the xor tree, lane 0's value. A thread holds four lanes,
// tau + k T for T = g / 4 (g < 4: all g lanes, T = 1), and reduces them
// to the tree's node F(tau, T) = (a0 + a2) + (a1 + a3); the T threads of
// a row then finish the tree by xor shuffles: the same additions in the
// same order as one lane a partial, with a quarter of the threads a row
// and two fewer shuffle levels. A piece whose rows are all short (at
// most 2 g products; `short_rows`, k1_products) is summed one row a
// thread instead (k1_row_value): the fewest instructions per product,
// which is what bounds the loop when the gathers are local (on an H100,
// xl_banded_67108864: a thread a row 0.27 ms, four lanes a thread 0.33;
// PERF.md section 6, PR 23).
__device__ __forceinline__ void k1_rows(const SortedPlan& p, const K1Ring& ring,
                                        int s, const K1Piece& m, int par, int hc,
                                        int k, int B1, float* __restrict__ y,
                                        const K1Seams& seams, int ctid,
                                        bool short_rows) {
  const float* prod = ring.vals(s);
  const int sb = m.p0 & ~3;
  const int nrows = m.r1 - m.r0 + 1;
  if (short_rows) {
    const int* ro = ring.offs(s) + (m.r0 & 3);
    for (int j = ctid; j < nrows; j += kK1Consumers) {
      const int s0 = max(ro[j], m.a0);
      const float v = k1_row_value(prod + (s0 - sb),
                                   min(ro[j + 1], m.a1) - s0, p.lanes_per_row);
      k1_finish(m, j, nrows, v, hc, k, B1, y, seams);
    }
    return;
  }
  // staged, or (a block past the window) in device memory
  const int* ro = (m.flags & kK1Window) ? ring.offs(s) + (m.r0 & 3)
                                       : p.offsets + m.r0;
  int jf = 0, jl = nrows - 1;
  if (m.p0 > m.a0 || m.p1 < m.a1) {
    const int2 r = k1_piece_rows(ro, nrows, m.p0, m.p1, m.a0, m.a1);
    jf = r.x;
    jl = r.y;
  }
  const int g = p.lanes_per_row;
  const int T = g >= 4 ? g >> 2 : 1;
  const int logT = __ffs(T) - 1;  // T is a power of two
  const int tau = ctid & (T - 1);
  const int group = ctid >> logT;
  const int groups = kK1Consumers >> logT;
  const int l1 = g >= 4 ? tau + T : 1, l2 = tau + 2 * T, l3 = tau + 3 * T;
  // the same trip count for every thread keeps the shuffles convergent
  const int trips = (jl - jf + groups) >> (__ffs(groups) - 1);
  for (int t = 0; t < trips; ++t) {
    const int j = jf + t * groups + group;
    const bool valid = j <= jl;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    bool goes_on = false;
    if (valid) {
      const int s0 = max(ro[j], m.a0), e0 = min(ro[j + 1], m.a1);
      const int hi = min(e0, m.p1);
      if (s0 >= m.p0) {
        // the row starts in this piece: the four lanes column by column,
        // their loads independent
        const float* q = prod + (s0 - sb);
        const int n = hi - s0;
        for (int c = 0; c < n; c += g) {
          if (tau + c < n) a.x += q[tau + c];
          if (g >= 2 && l1 + c < n) a.y += q[l1 + c];
          if (g >= 4 && l2 + c < n) a.z += q[l2 + c];
          if (g >= 4 && l3 + c < n) a.w += q[l3 + c];
        }
      } else {
        a = k1_lanes_carried(prod, sb, s0, m.p0, hi, make_int4(tau, l1, l2, l3),
                             g, seams.lanes + 32 * par);
      }
      goes_on = e0 > m.p1;
    }
    float v = g >= 4 ? (a.x + a.z) + (a.y + a.w) : g == 2 ? a.x + a.y : a.x;
    for (int off = T >> 1; off > 0; off >>= 1) {
      v += __shfl_xor_sync(kFull, v, off);
    }
    if (!valid) continue;
    if (goes_on) {
      float* carry = seams.lanes + 32 * (par ^ 1);
      carry[tau] = a.x;
      if (g >= 2) carry[l1] = a.y;
      if (g >= 4) {
        carry[l2] = a.z;
        carry[l3] = a.w;
      }
    } else if (tau == 0) {
      k1_finish(m, j, nrows, v, hc, k, B1, y, seams);
    }
  }
}

// the consumers' barrier, and whether `b` holds for all of them
__device__ __forceinline__ bool k1_consumers_all(bool b) {
  unsigned all;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n"
      " bar.red.and.pred q, %2, %3, p;\n selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(all)
      : "r"(static_cast<unsigned>(b)), "r"(kK1Named), "r"(kK1Consumers)
      : "memory");
  return all != 0;
}

// The last CTA: the row that CTA k's range ends inside of, when it began
// in that range, is its prefix plus each later block's partial, in block
// order, while the blocks start inside it (walk_row's rule).
__device__ __forceinline__ void k1_combine(const SortedPlan& p, int k,
                                           const float* __restrict__ tail,
                                           const float* __restrict__ part,
                                           float* __restrict__ y) {
  const int c0 = k1_range_start(k, p.nb, p.grid);
  const int c1 = k1_range_start(k + 1, p.nb, p.grid);
  if (c1 >= p.nb) return;
  const int t = __ldg(p.row_last + c1 - 1);
  if (__ldg(p.row_first + c1) != t) return;
  // a row the range lies wholly inside of began in an earlier range
  if (__ldg(p.row_first + c0) == t && c0 > 0 && __ldg(p.row_last + c0 - 1) == t) {
    return;
  }
  float s = __ldcg(tail + k);
  for (int c = c1; c < p.nb && __ldg(p.row_first + c) == t; ++c) {
    s += __ldcg(part + c);
    if (__ldg(p.row_last + c) != t) break;
  }
  y[t] = s;
}

// scratch: [0] the ticket (0 between launches), [4, 4 + grid) the range
// prefixes, [4 + grid, 4 + grid + nb) the block partials (as floats)
__global__ void __launch_bounds__(kK1Threads, kK1MinBlocks)
sorted_spmv_kernel(const SortedPlan p, const float* __restrict__ x,
                   float* __restrict__ y, int* __restrict__ scratch) {
  extern __shared__ int4 k1_ring[];
  __shared__ __align__(8) unsigned long long full[kK1Stages], empty[kK1Stages];
  __shared__ float carry_row[2];
  __shared__ float carry_lanes[2 * 32];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int k = blockIdx.x;
  const int B0 = k1_range_start(k, p.nb, p.grid);
  const int B1 = k1_range_start(k + 1, p.nb, p.grid);
  const int cap_p = p.piece + 4, cap_w = p.window + 4;
  const K1Ring ring{reinterpret_cast<int*>(k1_ring), cap_p, cap_w,
                    2 * cap_p + cap_w + kK1MetaWords};
  float* tail = reinterpret_cast<float*>(scratch + 4);
  float* part = tail + p.grid;
  if (tid == 0) {
    for (int s = 0; s < kK1Stages; ++s) {
      mbar_init(smem_addr(full + s), 33);  // expect_tx + 32 cp.async lanes
      mbar_init(smem_addr(empty + s), kK1ConsumerWarps);
    }
  }
  __syncthreads();
  if (tid >= kK1Consumers) {
    k1_produce(p, ring, full, empty, B0, B1, tid & 31);
  } else {
    const K1Seams seams{tail, part, carry_row, carry_lanes};
    int stage = 0, par = 0;
    unsigned phase = 0;
    mbar_wait(smem_addr(full), 0);
    K1Piece m = k1_read_meta(ring.meta(0));
    // the row this range starts inside of: its partials go to the seams
    const int hc = (m.flags & kK1Cin) ? m.r0 : -1;
    K1Quads g;
    k1_gather(ring, 0, m, x, tid, g);
    bool short_rows = k1_products(ring, 0, m, x, y, tid, g, p.lanes_per_row);
    for (;;) {
      // the products of `stage` are formed
      short_rows = k1_consumers_all(short_rows);
      const bool more = m.b + 1 < B1 || m.p1 < m.a1;
      const int next = stage + 1 == kK1Stages ? 0 : stage + 1;
      const unsigned next_phase = next == 0 ? phase ^ 1 : phase;
      K1Piece mn;
      if (more) {
        mbar_wait(smem_addr(full + next), next_phase);
        mn = k1_read_meta(ring.meta(next));
        k1_gather(ring, next, mn, x, tid, g);
      }
      k1_rows(p, ring, stage, m, par, hc, k, B1, y, seams, tid, short_rows);
      if (more) {
        short_rows = k1_products(ring, next, mn, x, y, tid, g, p.lanes_per_row);
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(smem_addr(empty + stage));
      if (!more) break;
      stage = next;
      phase = next_phase;
      par ^= 1;
      m = mn;
    }
  }
  // every row and seam of this CTA is written: the last CTA adds the
  // seams between ranges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(scratch, 1) == p.grid - 1;
    if (last) *scratch = 0;  // every CTA has arrived: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = tid; c < p.grid; c += kK1Threads) k1_combine(p, c, tail, part, y);
}

// the dynamic shared-memory opt-in, once per device and library load
std::atomic<unsigned long long> k1_configured{0};

int k1_configure() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (k1_configured.load(std::memory_order_relaxed) & bit) return 0;
  e = cudaFuncSetAttribute(sorted_spmv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kK1MaxSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k1_configured.fetch_or(bit, std::memory_order_relaxed);
  return 0;
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

// plan: a SortedPlan the host packed at bind; scratch: 4 + grid + nb
// 4-byte words, zero at the first launch on a stream (the last CTA resets
// the ticket), one set per stream the kernel runs on
int loops_sorted_spmv_f32(const void* plan, const void* x, void* y,
                          void* scratch, void* stream) {
  const SortedPlan& p = *static_cast<const SortedPlan*>(plan);
  if (p.nb <= 0 || p.grid <= 0 || p.grid > p.nb || p.lanes_per_row <= 0 ||
      p.lanes_per_row > 32 || (p.lanes_per_row & (p.lanes_per_row - 1)) ||
      p.piece < 4 || p.piece > kK1PieceMax || p.piece % 4 || p.window < 4 ||
      p.window > kK1WindowMax || p.window % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = k1_configure();
  if (err) return err;
  const int smem =
      kK1Stages * (2 * (p.piece + 4) + p.window + 4 + kK1MetaWords) * 4;
  sorted_spmv_kernel<<<p.grid, kK1Threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
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
