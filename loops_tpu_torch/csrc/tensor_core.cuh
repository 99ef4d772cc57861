// Hopper helpers shared by the probe kernels (csrc/probes_r2.cu,
// csrc/probes_gather.cu), K1 (csrc/spmv.cu), K7/K8 (csrc/bcsr.cu) and
// K10 (csrc/sddmm.cu): the dynamic shared-memory opt-in, 16- and 4-byte
// cp.async copies, mbarriers and bulk copies (cp.async.bulk) onto them,
// ldmatrix and mma.sync m16n8k16 with bf16 inputs and f32 sums.
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
// wait for every committed group
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// 4 bytes global -> shared (any 4-byte aligned address), tracked by the
// issuing thread's next cp_async_arrive
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// An mbarrier in shared memory (its shared-space address `bar`) that
// completes a phase when `count` threads have arrived and every byte it
// was told to expect has landed.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// wait until the phase of parity `parity` has completed (parity 1 passes
// at once on a new barrier: a ring's producer starts with its slots free)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive, and have the phase also wait for `bytes` more to land
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// one of the barrier's expected arrivals, made once every cp.async this
// thread has issued so far has landed
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
// order this thread's earlier generic-proxy shared-memory writes before
// later async-proxy (bulk copy) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory by one bulk copy, counted on `bar` as they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// an L2 policy that evicts first what it tags: for bytes streamed once,
// so they do not push out what is read again (as __ldcs does for a load)
__device__ __forceinline__ unsigned long long l2_evict_first() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}
// bulk_copy under an L2 policy (l2_evict_first)
__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src,
                                               unsigned bytes, unsigned bar,
                                               unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// the box of a 2-D tensor map at (x, y) (x the inner coordinate) from
// global to shared memory (128-byte aligned) by one TMA copy, counted on
// `bar` as it lands
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, int x, int y,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(tmap)), "r"(x), "r"(y), "r"(bar)
      : "memory");
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
