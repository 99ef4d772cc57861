// Hopper helpers shared by the probe kernels (csrc/probes_r2.cu,
// csrc/probes_gather.cu), K7/K8 (csrc/bcsr.cu) and K10 (csrc/sddmm.cu):
// the dynamic shared-memory opt-in, 16-byte cp.async copies, ldmatrix and
// mma.sync m16n8k16 with bf16 inputs and f32 sums.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 * gid + tig):
//   A (16 x 16): a[0] = (row gid, cols 2tig, 2tig+1), a[1] = row gid + 8,
//                a[2] = row gid, cols + 8, a[3] = row gid + 8, cols + 8;
//   B (16 x 8):  b[0] = (rows 2tig, 2tig+1; col gid), b[1] = rows + 8;
//   C (16 x 8):  c[0..1] = (row gid, cols 2tig, 2tig+1), c[2..3] = row + 8.
// Each 32-bit register holds two bf16, the lower column (or row) in the
// low half. ldmatrix.x4 over row-major A (lane l gives row l % 16 at
// column k0 + 8 (l / 16)) yields a[0..3]; ldmatrix.x2.trans over
// row-major B [k][n] (lane l gives row k0 + l % 16 at column n0) yields
// b[0..1]. tests/test_torch_probes.py mirrors both in numpy.
#pragma once

#include <cuda_runtime.h>

namespace loops_tc {

// Past the default 48 KB a kernel must opt into its dynamic shared memory.
template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the bytes past `bytes` zero-filled (L2 only)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait for all but the newest committed group
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// four 8x8 matrices, each transposed: over row-major B [k][n] (lane l
// gives row k0 + l % 8 + 8 (l / 16) at column n0 + 8 ((l / 8) % 2)) it
// yields the A fragment of the product Bᵀ (16 n x 16 k).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 sums
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace loops_tc
