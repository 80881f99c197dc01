// BatchNorm-normalize -> ReLU fused into a convolution in f32, for Hopper
// (sm_90a), bound to Python through ctypes by moco_tpu_torch/ops/fused_conv.py
// and moco_tpu_torch/ops/fused_conv3x3.py.
//
// Serves the f32 routes, reached only by f32 checks, of three Pallas TPU
// kernels:
//   bn_relu_matmul      moco_tpu/ops/pallas_fused_conv.py:121 (pallas_call :137)
//   bn_relu_conv3x3     moco_tpu/ops/pallas_fused_conv3x3.py:199 (pallas_call :237)
//   bn_relu_conv3x3_s2  moco_tpu/ops/pallas_fused_conv3x3.py:318 (pallas_call :351)
// Their bf16 routes, the training path, are other kernels: the 1x1 is
// matmul_fwd.cu's panel kernel, the two 3x3 are conv3x3_fwd.cu's band kernel.
//
// Work: y = relu(x*a + b) (*) W with a = gamma*rstd, b = beta - mean*a, the
// ResNet Bottleneck's bn->relu->conv interior. x is NHWC [B, H, W, K] (a
// channels_last activation), W is [taps, K, N] (the 1x1 [K, N], or the 3x3
// [3, 3, K, N]), y is NHWC [B, Ho, Wo, N]; f32 in, f32 accumulate, bf16 or
// f32 out. The 3x3 convs pad 1 on every side, at stride 1 or 2.
//
// Bound: f32 moves twice the bytes of bf16 and runs outside the tensor
// cores (67 TFLOP/s), so the operations bound the 3x3 and, at wide K and N,
// the 1x1. The fusion's point is that z = relu(x*a + b) is never written:
// the unfused block writes z and reads it back.
//
// Design: one implicit-GEMM template for all three. A block owns 64 output
// pixels x 64 output channels and loops over taps x K-chunks of 16. The
// block decodes once which input pixel every output row reads (per image,
// so no halo crosses an image, and stride 2 reads rows 2r-1, 2r, 2r+1);
// each chunk, it loads x with 16-byte loads along K where K and the
// pointers allow (element loads otherwise), applies x*a+b and the ReLU in
// registers, zeroes out-of-image taps AFTER the normalize (an out-of-image
// tap contributes 0, not relu(b)), and stores z to shared memory beside the
// matching [16, 64] slice of W. The next chunk's global loads start into
// registers before this chunk's product, so their latency hides behind it.
// The product is plain FMA, never TF32. The epilogue casts to the output
// type and stores 16 bytes at a time.

#include "implicit_gemm.cuh"

#include <limits.h>

namespace {

using namespace moco_gemm;

template <typename T>
struct FwdTile;
template <>
struct FwdTile<float> {
  static constexpr int BK = 16, LDA = BK + 8, LDB = 64 + 8;
  using Acc = FmaAcc<true, BK, LDA, LDB>;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
bn_relu_conv_gemm(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const T* __restrict__ w, void* __restrict__ y,
                  int out_bf16, int out_vec, ConvGeom g) {
  using Tile = FwdTile<T>;
  using Acc = typename Tile::Acc;
  constexpr int BM = Acc::BM, BN = Acc::BN, BK = Tile::BK;
  __shared__ __align__(128) T sa[BM * Tile::LDA];
  __shared__ __align__(128) T sb[BK * Tile::LDB];
  __shared__ int s_img[BM], s_ih[BM], s_iw[BM];

  const int64_t p0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  decode_rows(g, p0, BM, g.m, s_img, s_ih, s_iw);
  __syncthreads();

  // chunk t: tap t / kchunks, channels k0 .. k0+BK-1
  const int kchunks = (g.k + BK - 1) / BK;
  const int chunks = g.taps * kchunks;
  int tap = 0, k0 = 0, di, dj;
  tap_offsets(g.taps, tap, di, dj);
  ZTile<T, BM, BK, Tile::LDA, VEC> zt;
  RowTile<T, BK, BN, Tile::LDB, VEC> wt;
  zt.fetch(x, g, di, dj, k0, s_img, s_ih, s_iw);
  wt.fetch(w, k0, g.k, g.n, n0, g.n);
  Acc acc;
  acc.zero();
  for (int t = 0; t < chunks; ++t) {
    __syncthreads();  // the previous chunk's product has read the tiles
    zt.commit(a, b, g, di, dj, k0, s_img, s_ih, s_iw, sa);
    wt.commit(sb);
    __syncthreads();
    if (t + 1 < chunks) {  // the next chunk's loads fly while this one multiplies
      k0 += BK;
      if (k0 >= g.k) {
        k0 = 0;
        tap_offsets(g.taps, ++tap, di, dj);
      }
      zt.fetch(x, g, di, dj, k0, s_img, s_ih, s_iw);
      wt.fetch(w + (int64_t)tap * g.k * g.n, k0, g.k, g.n, n0, g.n);
    }
    acc.mma(sa, sb);
  }
  acc.store([&](int r, int c, const float* v, int count) {
    const int64_t row = p0 + r;
    const int col = n0 + c;
    if (row < g.m && col < g.n) {
      const int in_row = g.n - col < count ? g.n - col : count;
      store_out<Acc::RUN>(y, out_bf16, out_vec, row * g.n + col, v, in_row);
    }
  });
}

template <typename T>
int launch(const void* x, const float* a, const float* b, const void* w, void* y,
           int out_bf16, const ConvGeom& g, cudaStream_t st) {
  constexpr int BM = FwdTile<T>::Acc::BM, BN = FwdTile<T>::Acc::BN;
  const dim3 grid((unsigned)((g.m + BM - 1) / BM), (unsigned)((g.n + BN - 1) / BN));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const int out_vec = wide_stores(g.n, y);
  if (wide_loads<T>(g.k, g.n, x, w, a, b))
    bn_relu_conv_gemm<T, 16 / sizeof(T)><<<grid, kThreads, 0, st>>>(xt, a, b, wt, y, out_bf16,
                                                                     out_vec, g);
  else
    bn_relu_conv_gemm<T, 1><<<grid, kThreads, 0, st>>>(xt, a, b, wt, y, out_bf16, out_vec, g);
  return (int)cudaGetLastError();
}

int run(const void* x, const float* a, const float* b, const void* w, void* y, int dtype,
        int out_dtype, const ConvGeom& g, void* stream) {
  if (g.m <= 0 || g.m > INT_MAX || g.k <= 0 || g.n <= 0 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // bf16 (dtype 1) is matmul_fwd.cu's and conv3x3_fwd.cu's
  if (dtype == 0) return launch<float>(x, a, b, w, y, out_dtype, g, st);
  return (int)cudaErrorInvalidValue;
}

ConvGeom conv3x3_geom(int bsz, int h, int wd, int k, int n, int stride) {
  ConvGeom g;
  g.bsz = bsz;
  g.h = h;
  g.w = wd;
  g.ho = stride == 1 ? h : h / 2;
  g.wo = stride == 1 ? wd : wd / 2;
  g.k = k;
  g.n = n;
  g.stride = stride;
  g.taps = 9;
  g.m = (int64_t)bsz * g.ho * g.wo;
  return g;
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError()
// after the launch (0 = success).

// y[M, N] = relu(x[M, K]*a + b) @ w[K, N]; dtype (of x and w) must be 0 =
// float32: bfloat16 (1) is moco_matmul_fwd_bf16's and returns
// cudaErrorInvalidValue here
extern "C" int moco_bn_relu_matmul(const void* x, const float* a, const float* b,
                                   const void* w, void* y, int dtype, int out_dtype,
                                   int64_t m, int k, int n, void* stream) {
  ConvGeom g;
  g.bsz = (int)(m > INT_MAX ? INT_MAX : m);
  g.h = g.w = g.ho = g.wo = 1;
  g.k = k;
  g.n = n;
  g.stride = 1;
  g.taps = 1;
  g.m = m;
  return run(x, a, b, w, y, dtype, out_dtype, g, stream);
}

// y[B, H, W, N] = relu(x*a + b) conv w[3, 3, K, N], stride 1, zero pad 1;
// x and w f32
extern "C" int moco_bn_relu_conv3x3_f32(const void* x, const float* a, const float* b,
                                        const void* w, void* y, int out_dtype, int bsz, int h,
                                        int wd, int k, int n, void* stream) {
  if (bsz <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  return run(x, a, b, w, y, 0, out_dtype, conv3x3_geom(bsz, h, wd, k, n, 1), stream);
}

// y[B, H/2, W/2, N]: the same at stride 2, symmetric pad 1 (H and W even)
extern "C" int moco_bn_relu_conv3x3_s2_f32(const void* x, const float* a, const float* b,
                                           const void* w, void* y, int out_dtype, int bsz,
                                           int h, int wd, int k, int n, void* stream) {
  if (bsz <= 0 || h <= 0 || wd <= 0 || h % 2 != 0 || wd % 2 != 0)
    return (int)cudaErrorInvalidValue;
  return run(x, a, b, w, y, 0, out_dtype, conv3x3_geom(bsz, h, wd, k, n, 2), stream);
}
