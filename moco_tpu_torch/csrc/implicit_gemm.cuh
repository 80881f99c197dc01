// Building blocks shared by the f32 fused BN->ReLU->conv kernels
// (fused_conv.cu, forward) and their weight-gradient twins (fused_conv_dw.cu);
// the bf16 kernels take `Pack`, `store_out` and `wide_stores` from here.
//
// Both are implicit GEMMs over an NHWC activation x [B, H, W, K]. A "row" is
// one pixel of the GEMM's M axis; a "tap" (di, dj) in {-1, 0, 1}^2 of a 3x3
// conv (pad 1) reads input pixel (oh*stride + di, ow*stride + dj) of the same
// image. The A operand is never read from memory as such: it is
// z = relu(x*a + b) computed from x while the tile is loaded, cast to the
// operand type, and set to 0 where the tap falls outside the image (the
// conv's zero padding applies to z, not to x) or past the last channel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace moco_gemm {

constexpr int kThreads = 256;  // threads per block, 8 warps

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The conv as a GEMM. 1x1: h = w = ho = wo = 1, bsz = rows, taps = 1.
struct ConvGeom {
  int bsz, h, w;     // input grid
  int ho, wo;        // output grid
  int k, n;          // input / output channels
  int stride, taps;  // taps: 1 (1x1) or 9 (3x3, zero pad 1)
  int64_t m;         // output pixels, bsz * ho * wo
};

__device__ __forceinline__ void tap_offsets(int taps, int tap, int& di, int& dj) {
  di = taps == 1 ? 0 : tap / 3 - 1;
  dj = taps == 1 ? 0 : tap % 3 - 1;
}

// Per-row image index and the tap-(0, 0) input coordinates of output pixels
// p0 .. p0+rows-1; rows at or past `limit` get image -1 (they load zeros).
__device__ __forceinline__ void decode_rows(const ConvGeom& g, int64_t p0, int rows,
                                            int64_t limit, int* s_img, int* s_ih,
                                            int* s_iw) {
  const int hw = g.ho * g.wo;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int64_t p = p0 + r;
    if (p < limit) {
      const int img = (int)(p / hw);
      const int rem = (int)(p - (int64_t)img * hw);
      const int oh = rem / g.wo;
      s_img[r] = img;
      s_ih[r] = oh * g.stride;
      s_iw[r] = (rem - oh * g.wo) * g.stride;
    } else {
      s_img[r] = -1;
      s_ih[r] = 0;
      s_iw[r] = 0;
    }
  }
}

// VEC values of a per-channel f32 vector from channel k: 16-byte loads when
// VEC is a multiple of 4 (the caller checked the alignment).
template <int VEC>
__device__ __forceinline__ void load_affine(const float* __restrict__ v, int k,
                                            float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(v + k) + q);
      out[4 * q] = f.x;
      out[4 * q + 1] = f.y;
      out[4 * q + 2] = f.z;
      out[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = __ldg(v + k + i);
  }
}

// One thread's share of a ROWS x COLS tile of z (rows of the GEMM, channels
// k0 .. k0+COLS-1, tap (di, dj)), split in two so that the global loads of
// the next tile are in flight while the current one is multiplied:
// `fetch` starts the loads of x into registers, `commit` applies x*a + b
// and the ReLU, zeroes what lies outside the image or past K, and stores
// z to shared memory (row pitch LD). VEC channels per load: VEC > 1 only
// when K % VEC == 0 and the pointers are aligned, so a vector lies wholly
// inside [0, K) or wholly past it.
template <typename T, int ROWS, int COLS, int LD, int VEC>
struct ZTile {
  static constexpr int CV = COLS / VEC;
  static constexpr int ITERS = ROWS * CV / kThreads;
  static_assert(COLS % VEC == 0 && ROWS * CV % kThreads == 0, "tile does not split evenly");
  Pack<T, VEC> raw[ITERS];

  // this thread's vector `it`: its tile coordinates, and its x offset if z
  // there comes from x at all
  __device__ __forceinline__ bool locate(const ConvGeom& g, int di, int dj, int k0,
                                         const int* s_img, const int* s_ih, const int* s_iw,
                                         int it, int& r, int& c, int64_t& off) const {
    const int idx = it * kThreads + threadIdx.x;
    r = idx / CV;
    c = (idx - r * CV) * VEC;
    const int k = k0 + c;
    const int img = s_img[r];
    const int ih = s_ih[r] + di;
    const int iw = s_iw[r] + dj;
    const bool ok = img >= 0 && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w && k < g.k;
    off = ok ? (((int64_t)img * g.h + ih) * g.w + iw) * g.k + k : 0;
    return ok;
  }

  __device__ __forceinline__ void fetch(const T* __restrict__ x, const ConvGeom& g, int di,
                                        int dj, int k0, const int* s_img, const int* s_ih,
                                        const int* s_iw) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      int r, c;
      int64_t off;
      if (locate(g, di, dj, k0, s_img, s_ih, s_iw, it, r, c, off))
        raw[it] = *reinterpret_cast<const Pack<T, VEC>*>(x + off);
    }
  }

  __device__ __forceinline__ void commit(const float* __restrict__ a,
                                         const float* __restrict__ b, const ConvGeom& g,
                                         int di, int dj, int k0, const int* s_img,
                                         const int* s_ih, const int* s_iw, T* sz) const {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      int r, c;
      int64_t off;
      Pack<T, VEC> out;
      if (locate(g, di, dj, k0, s_img, s_ih, s_iw, it, r, c, off)) {
        float av[VEC], bv[VEC];
        load_affine<VEC>(a, k0 + c, av);
        load_affine<VEC>(b, k0 + c, bv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          // x*a + b rounded twice (no FMA contraction), as the plain version
          const float v = __fadd_rn(__fmul_rn(to_f32(raw[it].v[i]), av[i]), bv[i]);
          out.v[i] = from_f32<T>(v > 0.f ? v : 0.f);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) out.v[i] = from_f32<T>(0.f);
      }
      *reinterpret_cast<Pack<T, VEC>*>(sz + r * LD + c) = out;
    }
  }
};

// One thread's share of a ROWS x COLS tile of a row-major matrix (a slice of
// W, or rows of dy): t[r][c] = src[(row0 + r) * ld + col0 + c] where
// row0 + r < nrows and col0 + c < ncols, else 0; `fetch` to registers,
// `commit` to shared memory (row pitch LD).
template <typename T, int ROWS, int COLS, int LD, int VEC>
struct RowTile {
  static constexpr int CV = COLS / VEC;
  static constexpr int ITERS = ROWS * CV / kThreads;
  static_assert(COLS % VEC == 0 && ROWS * CV % kThreads == 0, "tile does not split evenly");
  Pack<T, VEC> raw[ITERS];

  __device__ __forceinline__ void fetch(const T* __restrict__ src, int64_t row0, int64_t nrows,
                                        int ld, int col0, int ncols) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int r = idx / CV;
      const int c = (idx - r * CV) * VEC;
      if (row0 + r < nrows && col0 + c < ncols) {
        raw[it] = *reinterpret_cast<const Pack<T, VEC>*>(src + (row0 + r) * ld + col0 + c);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) raw[it].v[i] = from_f32<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void commit(T* dst) const {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int r = idx / CV;
      *reinterpret_cast<Pack<T, VEC>*>(dst + r * LD + (idx - r * CV) * VEC) = raw[it];
    }
  }
};

// Store CNT consecutive f32 values at element i of y (bf16 or f32): one
// or two 16-byte stores when `vec` (the caller checked the alignment).
template <int CNT>
__device__ __forceinline__ void store_out(void* y, bool bf16, bool vec, int64_t i,
                                          const float* v, int count) {
  if (vec && count == CNT) {
    if (bf16) {
      Pack<__nv_bfloat16, CNT> p;
#pragma unroll
      for (int q = 0; q < CNT; ++q) p.v[q] = __float2bfloat16(v[q]);
      *reinterpret_cast<Pack<__nv_bfloat16, CNT>*>(static_cast<__nv_bfloat16*>(y) + i) = p;
    } else {
#pragma unroll
      for (int q = 0; q < CNT; q += 4)
        *reinterpret_cast<float4*>(static_cast<float*>(y) + i + q) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    }
  } else {
    for (int q = 0; q < count; ++q) {
      if (bf16)
        static_cast<__nv_bfloat16*>(y)[i + q] = __float2bfloat16(v[q]);
      else
        static_cast<float*>(y)[i + q] = v[q];
    }
  }
}

// acc[64 x 64] += A[64 x BK] * B[BK x 64] with plain FMA (never TF32),
// 16 x 16 threads of 4 x 4 outputs each. A(m, k) is sa[m * LDA + k] when
// A_ROW, else sa[k * LDA + m] (the weight gradient's transposed operand);
// B(k, n) is sb[k * LDB + n].
template <bool A_ROW, int BK, int LDA, int LDB>
struct FmaAcc {
  static constexpr int BM = 64, BN = 64, RUN = 4;
  float c[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* sa, const float* sb) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty * 4 + i;
        av[i] = A_ROW ? sa[m * LDA + kk] : sa[kk * LDA + m];
        bv[i] = sb[kk * LDB + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }

  template <typename Emit>
  __device__ __forceinline__ void store(Emit emit) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) emit(ty * 4 + i, tx * 4, c[i], 4);
  }
};

// 16-byte loads along the channel axis (and of a and b) when both channel
// counts are multiples of the vector and every pointer is 16-byte aligned.
template <typename T>
inline bool wide_loads(int k, int n, const void* x, const void* q, const float* a,
                       const float* b) {
  const int vec = 16 / (int)sizeof(T);
  return k % vec == 0 && n % vec == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)q % 16 == 0 &&
         (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
}

// 16-byte stores of the output when its rows are whole 16-byte runs.
inline bool wide_stores(int n, const void* y) { return n % 8 == 0 && (uintptr_t)y % 16 == 0; }

}  // namespace moco_gemm
