// Device helpers shared by the bf16 tensor-core kernels of the fused
// BN->ReLU->conv family (conv3x3_dw.cu and conv3x3_fwd.cu, the 3x3 weight
// gradient and forwards; matmul_fwd.cu and matmul_dw.cu, the 1x1 pair):
// cp.async copies into shared memory, ldmatrix fragment loads, the bf16
// mma.sync.m16n8k16 product with f32 accumulation, a division-free walk
// over the pixels of a grid, and the in-place normalize of a row tile.

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

struct alignas(16) Bf16x8 {
  __nv_bfloat16 v[8];
};

// z = relu(x*a + b) in place over a ROWS x COLS tile of channels
// k0 .. k0+COLS-1 (row pitch PITCH bf16): x*a + b rounded twice (no FMA
// contraction), then to bf16, as the plain version does. Rows at or past
// `valid` and channels at or past k hold 0 afterwards, whatever was there:
// channels by index, not by value, since stale shared memory may hold a
// NaN and 0*NaN is NaN. Each thread keeps one 8-channel vector.
template <int ROWS, int COLS, int PITCH, int THREADS>
__device__ __forceinline__ void normalize_tile(__nv_bfloat16* z, int valid, int k0, int k,
                                               const float* __restrict__ a,
                                               const float* __restrict__ b) {
  constexpr int CV = COLS / 8, RS = THREADS / CV;
  static_assert(COLS % 8 == 0 && THREADS % CV == 0, "a thread keeps one channel vector");
  const int v = threadIdx.x % CV;
  const int kv = k - (k0 + v * 8);  // channels of this vector inside K
  float av[8], bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    av[i] = i < kv ? __ldg(a + k0 + v * 8 + i) : 0.f;
    bv[i] = i < kv ? __ldg(b + k0 + v * 8 + i) : 0.f;
  }
#pragma unroll 4
  for (int r = threadIdx.x / CV; r < ROWS; r += RS) {
    Bf16x8* ptr = reinterpret_cast<Bf16x8*>(z + r * PITCH) + v;
    Bf16x8 val;
    if (r < valid) {
      val = *ptr;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = __fadd_rn(__fmul_rn(__bfloat162float(val.v[i]), av[i]), bv[i]);
        val.v[i] = __float2bfloat16(i < kv && t > 0.f ? t : 0.f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) val.v[i] = __float2bfloat16(0.f);
    }
    *ptr = val;
  }
}

}  // namespace moco_band
