// Device helpers shared by the band kernels of the fused BN->ReLU->3x3 conv
// (conv3x3_dw.cu, the bf16 weight gradient, and conv3x3_fwd.cu, the bf16
// forwards): cp.async copies into shared memory, ldmatrix fragment loads,
// the bf16 mma.sync.m16n8k16 product with f32 accumulation, and a
// division-free walk over the pixels of a grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moco_band {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One 16-byte cp.async (VEC == 8, both pointers 16-byte aligned) or one
// plain 2-byte copy (VEC == 1).
template <int VEC>
__device__ __forceinline__ void copy_in(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  if constexpr (VEC == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src));
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i in the mma fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A thread's walk over the pixels of a width-w grid: pixel p0 first, then
// every dp-th, as row j and column c, with no division after the start.
struct PixelWalk {
  int j, c, w, dj, dc;
  __device__ __forceinline__ PixelWalk(int p0, int dp, int width)
      : j(p0 / width), c(p0 % width), w(width), dj(dp / width), dc(dp % width) {}
  __device__ __forceinline__ void step() {
    c += dc;
    j += dj;
    if (c >= w) {
      c -= w;
      ++j;
    }
  }
};

}  // namespace moco_band
