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
// the TPU's jnp.dot(bf16, bf16, preferred_element_type=f32) computes.
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
// byte bound: these FMA kernels are the simple first version.
//
// Offsets into vals, B and the output are 64-bit. Each C entry point
// returns cudaGetLastError() so the Python wrapper raises on a refused
// launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// ---------------------------------------------------------------- K9
// One CTA of 128 threads per (block row, group of 8 rows, feature tile of
// 128 * FPT columns). For each stored block of the row, in order, the 8 x
// 128 sub-blocks are staged in shared memory (transposed, so a thread reads
// a column's 8 values as two float4); thread i owns features i, i+128, ...
// and keeps 8 x FPT sums in registers, reading B[col, f] coalesced.
constexpr int kSpmmThreads = 128;

template <int FPT>
__global__ void __launch_bounds__(kSpmmThreads)
bcsr_spmm_kernel(const int* __restrict__ offsets, const int* __restrict__ bcols,
                 const float* __restrict__ vals, const float* __restrict__ B,
                 float* __restrict__ out, int R, int C, int rows, int cols,
                 int F) {
  __shared__ __align__(16) float sA[128 * kRowGroup];  // [c][r]
  const int groups = R / kRowGroup;
  const int br = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * kRowGroup;
  const int f0 = blockIdx.y * (kSpmmThreads * FPT) + threadIdx.x;
  float acc[kRowGroup][FPT];
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
    for (int k = 0; k < FPT; ++k) acc[r][k] = 0.f;
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
      for (int c = 0; c < cn; ++c) {
        const float* brow = B + (col0 + c0 + c) * F;
        float b[FPT];
#pragma unroll
        for (int k = 0; k < FPT; ++k) {
          const int f = f0 + kSpmmThreads * k;
          b[k] = f < F ? __ldg(brow + f) : 0.f;
        }
        const float4 a0 = *reinterpret_cast<const float4*>(sA + c * kRowGroup);
        const float4 a1 = *reinterpret_cast<const float4*>(sA + c * kRowGroup + 4);
        const float a[kRowGroup] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
          for (int k = 0; k < FPT; ++k) acc[r][k] = fmaf(a[r], b[k], acc[r][k]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) {
    const long long row = static_cast<long long>(br) * R + r0 + r;
    if (row >= rows) break;
#pragma unroll
    for (int k = 0; k < FPT; ++k) {
      const int f = f0 + kSpmmThreads * k;
      if (f < F) out[row * F + f] = acc[r][k];
    }
  }
}

// ------------------------------------------------- K7/K8 shared pieces
// Both walk a super-row (SUPER consecutive block rows) for one feature tile
// of FT columns with 256 threads: the f32 accumulator tile [SUPER*R][FT]
// lives in shared memory, A and the C x FT B tile are double-buffered into
// shared memory with cp.async (16-byte copies; bytes past the matrix or
// past F are zero-filled), and the tile is written to the output once.
constexpr int kSuperThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// n contiguous elements (n * sizeof(T) a multiple of 16) into shared memory
template <typename T>
__device__ __forceinline__ void load_contig(T* dst, const T* src, long long n) {
  constexpr int V = 16 / sizeof(T);
  for (long long i = threadIdx.x; i < n / V; i += blockDim.x) {
    cp_async16(dst + i * V, src + i * V, 16);
  }
}

// B rows [row0, row0 + C), columns [f0, f0 + FT) into dst[C][FT]; ld is B's
// row pitch in elements (ld * sizeof(T) a multiple of 16)
template <typename T>
__device__ __forceinline__ void load_b_tile(T* dst, const T* B, long long row0,
                                            int C, int FT, int f0, int cols,
                                            int F, int ld) {
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
    cp_async16(dst + c * FT + v, src, bytes);
  }
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(p + 2);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

__device__ __forceinline__ void zero_acc(float* acc, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc[i] = 0.f;
}

__device__ __forceinline__ void store_acc(const float* acc, float* out,
                                          long long row0, int SR, int FT,
                                          int f0, int rows, int F) {
  for (int i = threadIdx.x; i < SR * FT; i += blockDim.x) {
    const long long row = row0 + i / FT;
    const int f = f0 + i % FT;
    if (row < rows && f < F) out[row * F + f] = acc[i];
  }
}

// ---------------------------------------------------------------- K8
// Stored blocks of the super-row in storage order; per block each thread
// sums whole dot products (r, f) over C and adds them into the accumulator
// row of the block's block row. A given (row, f) is always owned by the
// same thread, and blocks are separated by barriers: sums in block order.
template <typename T>
__global__ void __launch_bounds__(kSuperThreads)
bcsr_spmm_v2_kernel(const int* __restrict__ offsets,
                    const int* __restrict__ bcols, const int* __restrict__ brow,
                    const T* __restrict__ vals, const T* __restrict__ B,
                    float* __restrict__ out, int nbr, int R, int C, int rows,
                    int cols, int F, int ld, int SUPER, int FT) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SR = SUPER * R;
  float* acc = reinterpret_cast<float*>(smem);
  T* abuf = reinterpret_cast<T*>(acc + SR * FT);  // [2][R*C]
  T* bbuf = abuf + 2 * R * C;                      // [2][C*FT]
  const int s = blockIdx.x, f0 = blockIdx.y * FT;
  const long long RC = static_cast<long long>(R) * C;
  zero_acc(acc, SR * FT);
  const int t0 = offsets[min(s * SUPER, nbr)];
  const int t1 = offsets[min((s + 1) * SUPER, nbr)];
  if (t0 < t1) {
    load_contig(abuf, vals + t0 * RC, RC);
    load_b_tile(bbuf, B, static_cast<long long>(bcols[t0]) * C, C, FT, f0,
                cols, F, ld);
  }
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int slot = (t - t0) & 1;
    if (t + 1 < t1) {
      load_contig(abuf + (1 - slot) * RC, vals + (t + 1) * RC, RC);
      load_b_tile(bbuf + (1 - slot) * C * FT, B,
                  static_cast<long long>(bcols[t + 1]) * C, C, FT, f0, cols,
                  F, ld);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const T* a = abuf + slot * RC;
    const T* b = bbuf + slot * C * FT;
    const int arow = (brow[t] - s * SUPER) * R;
    for (int o = threadIdx.x; o < R * FT; o += blockDim.x) {
      const int r = o / FT, f = o % FT;
      float sum = 0.f;
      for (int c = 0; c < C; ++c) {
        sum = fmaf(to_f(a[r * C + c]), to_f(b[c * FT + f]), sum);
      }
      acc[(arow + r) * FT + f] += sum;
    }
    __syncthreads();  // before the next prefetch overwrites this slot
  }
  __syncthreads();
  store_acc(acc, out, static_cast<long long>(s) * SR, SR, FT, f0, rows, F);
}

// ---------------------------------------------------------------- K7
// The super-row's stored blocks come as column-sorted chunks of KCH blocks
// (loops_tpu's _stage_chunks): a chunk's A slab [KCH*R][C] is one
// contiguous copy, and the B tile of its column is loaded only where
// bfetch == 1 (into buffer bslot), once per (super-row, column), and reused
// by the following chunks of that column. Each thread owns 4 x 4 register
// tiles of the chunk's live rows x FT and adds them into the accumulator at
// the blocks' rowoff; chunks are separated by barriers, so each (row, f)
// is summed in chunk order.
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
  const int SR = SUPER * R, QR = KCH * R;
  float* acc = reinterpret_cast<float*>(smem);
  T* abuf = reinterpret_cast<T*>(acc + SR * FT);  // [2][QR*C]
  T* bbuf = abuf + 2 * QR * C;                     // [2][C*FT]
  const int s = blockIdx.x, f0 = blockIdx.y * FT;
  const long long QC = static_cast<long long>(QR) * C;
  const long long RC = static_cast<long long>(R) * C;
  zero_acc(acc, SR * FT);
  const int t0 = chunk_ptr[s], t1 = chunk_ptr[s + 1];
  if (t0 < t1) {  // a super-row's first chunk always fetches
    load_contig(abuf, a3d + t0 * QC, nlive[t0] * RC);
    load_b_tile(bbuf + bslot[t0] * C * FT, B,
                static_cast<long long>(ccol[t0]) * C, C, FT, f0, cols, F, ld);
  }
  cp_async_commit();
  const int nf = FT / 4;
  for (int t = t0; t < t1; ++t) {
    const int aslot = (t - t0) & 1;
    if (t + 1 < t1) {
      load_contig(abuf + (1 - aslot) * QC, a3d + (t + 1) * QC,
                  nlive[t + 1] * RC);
      // a fetch goes to the other B buffer than the one chunk t reads
      if (bfetch[t + 1]) {
        load_b_tile(bbuf + bslot[t + 1] * C * FT, B,
                    static_cast<long long>(ccol[t + 1]) * C, C, FT, f0, cols,
                    F, ld);
      }
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const T* a = abuf + aslot * QC;
    const T* b = bbuf + bslot[t] * C * FT;
    const int* ro = rowoff + static_cast<long long>(t) * KCH;
    const int tiles = nlive[t] * R / 4 * nf;
    for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
      const int q0 = tile / nf * 4, fq = tile % nf * 4;
      float sum[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[i][j] = 0.f;
      }
      for (int c = 0; c < C; ++c) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = to_f(a[(q0 + i) * C + c]);
        load4(b + c * FT + fq, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) sum[i][j] = fmaf(av[i], bv[j], sum[i][j]);
        }
      }
      // R % 8 == 0: the 4 rows lie in one block of the chunk
      const int arow = ro[q0 / R] * R + q0 % R;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[(arow + i) * FT + fq + j] += sum[i][j];
      }
    }
    __syncthreads();  // before the next prefetch overwrites these buffers
  }
  __syncthreads();
  store_acc(acc, out, static_cast<long long>(s) * SR, SR, FT, f0, rows, F);
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
                        int R, int C, int rows, int cols, int F, int fpt,
                        void* stream) {
  const dim3 grid(static_cast<unsigned>(nbr) * (R / kRowGroup),
                  (F + kSpmmThreads * fpt - 1) / (kSpmmThreads * fpt));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int*>(offsets);
  const auto* bc = static_cast<const int*>(bcols);
  const auto* v = static_cast<const float*>(vals);
  const auto* b = static_cast<const float*>(B);
  auto* c = static_cast<float*>(out);
  switch (fpt) {
    case 1: bcsr_spmm_kernel<1><<<grid, kSpmmThreads, 0, s>>>(o, bc, v, b, c, R, C, rows, cols, F); break;
    case 2: bcsr_spmm_kernel<2><<<grid, kSpmmThreads, 0, s>>>(o, bc, v, b, c, R, C, rows, cols, F); break;
    case 3: bcsr_spmm_kernel<3><<<grid, kSpmmThreads, 0, s>>>(o, bc, v, b, c, R, C, rows, cols, F); break;
    case 4: bcsr_spmm_kernel<4><<<grid, kSpmmThreads, 0, s>>>(o, bc, v, b, c, R, C, rows, cols, F); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
