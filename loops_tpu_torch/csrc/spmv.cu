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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
// Design: one CUDA block per plan block; each row of the block is summed
// by a group of `lanes_per_row` lanes (a power of two <= 32, picked on
// the host from the mean row length) so that neighbouring lanes read
// neighbouring vals/cols; the group's strided partials are combined by
// an xor-shuffle tree (fixed order, so deterministic).
__global__ void __launch_bounds__(kThreads)
sorted_spmv_kernel(const int* __restrict__ offsets, const int* __restrict__ cols,
                   const float* __restrict__ vals, const int* __restrict__ cuts,
                   const int* __restrict__ row_first,
                   const int* __restrict__ row_last, const float* __restrict__ x,
                   float* __restrict__ y, float* __restrict__ seam,
                   int lanes_per_row) {
  const int b = blockIdx.x;
  const int a0 = cuts[b], a1 = cuts[b + 1];
  const int r0 = row_first[b], r1 = row_last[b];
  const int g = lanes_per_row;
  const int lane = threadIdx.x & (g - 1);
  const int group = threadIdx.x / g;
  const int groups = blockDim.x / g;
  // the same trip count for every thread keeps the shuffles convergent
  const int trips = (r1 - r0 + groups) / groups;
  for (int t = 0; t < trips; ++t) {
    const int r = r0 + t * groups + group;
    float acc = 0.f;
    if (r <= r1) {
      const int lo = max(offsets[r], a0);
      const int hi = min(offsets[r + 1], a1);
      for (int i = lo + lane; i < hi; i += g) {
        acc = fmaf(vals[i], __ldg(x + cols[i]), acc);
      }
    }
    for (int off = g >> 1; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, off);
    }
    if (lane == 0 && r <= r1) store_row(r, r0, r1, b, acc, y, seam);
  }
}

// K2 — replaces loops_tpu/ops/kernels/spmv_flat_v2.py flat_spmv_pallas_v2
// (schedule='merge_path', impl='pallas2').
// Over the FlatBlockPlan's staged [B, K] arrays: products vals*x[cols]
// (fused here; the TPU formed them outside its kernel) go through an
// in-block segmented inclusive scan keyed on the keep flags of the
// reference's _stage_extraction (keep == 0 starts a segment). Each warp
// scans 32 atoms with __shfl_up_sync carrying (value, flag); warp aggregates are
// folded in warp order through shared memory, and a carry links the
// block's 256-atom chunks. The last atom of each row run holds the run's
// total and writes it to its row (or to the seam buffer). The TPU's
// Mosaic compile envelopes (R > 4096, S*R > 2^22) do not exist here.
__global__ void __launch_bounds__(kThreads)
flat_spmv_v2_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                    const uint8_t* __restrict__ keep, const int* __restrict__ rel,
                    const int* __restrict__ tile_starts,
                    const int* __restrict__ atom_starts,
                    const int* __restrict__ row_first,
                    const int* __restrict__ row_last, const float* __restrict__ x,
                    float* __restrict__ y, float* __restrict__ seam, int K) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_f[kWarps];
  const int b = blockIdx.x;
  const int n = atom_starts[b + 1] - atom_starts[b];
  const int rf = row_first[b], rl = row_last[b], t0 = tile_starts[b];
  const size_t base = static_cast<size_t>(b) * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;  // open segment's running value before this chunk
  for (int c0 = 0; c0 < n; c0 += kThreads) {
    const int k = c0 + threadIdx.x;
    const bool in = k < n;
    float v = 0.f;
    int f = 1;  // a segment starts at or before this atom (within the scan)
    if (in) {
      v = vals[base + k] * __ldg(x + cols[base + k]);
      f = keep[base + k] == 0;
    }
    for (int d = 1; d < 32; d <<= 1) {
      const float pv = __shfl_up_sync(kFull, v, d);
      const int pf = __shfl_up_sync(kFull, f, d);
      if (lane >= d) {
        if (!f) v = pv + v;
        f |= pf;
      }
    }
    if (lane == 31) {
      warp_v[warp] = v;
      warp_f[warp] = f;
    }
    __syncthreads();
    float pre = carry;
    for (int w = 0; w < warp; ++w) pre = warp_f[w] ? warp_v[w] : pre + warp_v[w];
    if (!f) v = pre + v;
    if (in && (k == n - 1 || keep[base + k + 1] == 0)) {
      store_row(t0 + rel[base + k], rf, rl, b, v, y, seam);
    }
    for (int w = warp; w < kWarps; ++w) pre = warp_f[w] ? warp_v[w] : pre + warp_v[w];
    carry = pre;
    __syncthreads();  // warp_v/warp_f are rewritten by the next chunk
  }
}

// K3 — replaces loops_tpu/ops/kernels/spmv_flat.py flat_spmv_pallas
// (schedule='merge_path', impl='pallas').
// The TPU reduced each block with a [K, R] one-hot matmul into
// y[s0*128 : s0*128 + R]. Here the block owns a shared-memory row window
// of R floats (R <= 58112: 227 KB, the H100's opt-in maximum of dynamic
// shared memory per block, bounded on the host; past the default 48 KB
// the entry point opts the kernel in). Each row run is
// summed in CSR order by the one thread that owns the run's first atom
// (no shared-memory atomics), then the window goes to y, with the first
// and last row through the seam pass.
__global__ void __launch_bounds__(kThreads)
flat_spmv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                 const int* __restrict__ rel, const int* __restrict__ s0,
                 const int* __restrict__ atom_starts,
                 const int* __restrict__ row_first,
                 const int* __restrict__ row_last, const float* __restrict__ x,
                 float* __restrict__ y, float* __restrict__ seam, int K, int R) {
  extern __shared__ float win[];
  const int b = blockIdx.x;
  const int n = atom_starts[b + 1] - atom_starts[b];
  if (n == 0) return;
  const size_t base = static_cast<size_t>(b) * K;
  for (int j = threadIdx.x; j < R; j += blockDim.x) win[j] = 0.f;
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int r = rel[base + k];
    if (k == 0 || rel[base + k - 1] != r) {
      float s = 0.f;
      for (int i = k; i < n && rel[base + i] == r; ++i) {
        s = fmaf(vals[base + i], __ldg(x + cols[base + i]), s);
      }
      win[r] = s;
    }
  }
  __syncthreads();
  const int rf = row_first[b], rl = row_last[b];
  const int ybase = s0[b] * 128;
  for (int j = threadIdx.x; j < R; j += blockDim.x) {
    const int row = ybase + j;
    if (row >= rf && row <= rl) store_row(row, rf, rl, b, win[j], y, seam);
  }
}

int launch_seam(const int* row_first, const int* row_last, const float* seam,
                float* y, int nb, cudaStream_t stream) {
  seam_kernel<<<(nb + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      row_first, row_last, seam, y, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int loops_sorted_spmv_f32(const void* offsets, const void* cols,
                          const void* vals, const void* cuts,
                          const void* row_first, const void* row_last,
                          const void* x, void* y, void* seam, int nb,
                          int lanes_per_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sorted_spmv_kernel<<<nb, kThreads, 0, s>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const int*>(cuts),
      static_cast<const int*>(row_first), static_cast<const int*>(row_last),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(seam), lanes_per_row);
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
                           const void* x, void* y, void* seam, int nb, int K,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flat_spmv_v2_kernel<<<nb, kThreads, 0, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const uint8_t*>(keep), static_cast<const int*>(rel),
      static_cast<const int*>(tile_starts), static_cast<const int*>(atom_starts),
      static_cast<const int*>(row_first), static_cast<const int*>(row_last),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(seam), K);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_seam(static_cast<const int*>(row_first),
                     static_cast<const int*>(row_last),
                     static_cast<const float*>(seam), static_cast<float*>(y),
                     nb, s);
}

int loops_flat_spmv_f32(const void* vals, const void* cols, const void* rel,
                        const void* s0, const void* atom_starts,
                        const void* row_first, const void* row_last,
                        const void* x, void* y, void* seam, int nb, int K,
                        int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = R * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flat_spmv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flat_spmv_kernel<<<nb, kThreads, smem, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const int*>(rel), static_cast<const int*>(s0),
      static_cast<const int*>(atom_starts), static_cast<const int*>(row_first),
      static_cast<const int*>(row_last), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<float*>(seam), K, R);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_seam(static_cast<const int*>(row_first),
                     static_cast<const int*>(row_last),
                     static_cast<const float*>(seam), static_cast<float*>(y),
                     nb, s);
}

}  // extern "C"
