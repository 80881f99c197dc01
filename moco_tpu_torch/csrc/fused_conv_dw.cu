// Weight gradients of the fused BN->ReLU->conv in f32, for Hopper (sm_90a),
// bound to Python through ctypes by moco_tpu_torch/ops/fused_conv.py and
// moco_tpu_torch/ops/fused_conv3x3.py. It serves the f32 routes, reached
// only by f32 checks, of
//   bn_relu_matmul_dw  moco_tpu/ops/pallas_fused_conv.py:84 (pallas_call :101)
//   conv3x3_dw         moco_tpu/ops/pallas_fused_conv3x3.py:371 (pallas_call :412)
// Their bf16 routes, the training path, are matmul_dw.cu (the 1x1) and
// conv3x3_dw.cu (the 3x3).
//
// Work: dW[tap, K, N] = sum over output pixels p of z_tap[p, K]^T dy[p, N],
// with z = relu(x*a + b) recomputed from x (never stored) and z_tap the
// tap-shifted z under the forward's zero padding; f32 in and out. 1x1: one
// tap, x [M, K], dy [M, N]. 3x3 (stride 1, pad 1): nine taps,
// x [B, H, W, K] and dy [B, H, W, N] NHWC.
//
// Bound: one read of x and dy against a taps*K*N*4-byte output, and the
// operations at the f32 rate outside the tensor cores (67 TFLOP/s).
//
// Design: the TPU kernels carry the sum in a VMEM accumulator across a
// sequential grid axis over rows (pallas_fused_conv.py:66-80). Hopper
// blocks run in no order, so the sum is two passes with no atomics, as
// csrc/channel_stats.cu does. Pass 1: a block owns one tap, a
// [64 K x 64 N] tile of dW and a slab of rows; it walks its slab 16 rows at
// a time, builds z for those rows in shared memory with the forward's
// loader (per-image masks, 16-byte loads along K where possible), loads
// the matching dy rows, and multiplies z^T dy with FMA into f32 registers,
// with the next rows' global loads in flight during the product; the
// slab's partial goes to part[slab, tap, K, N]. Pass 2 sums the slabs of
// each element in slab order, so two runs on the same input give the same
// bits.

#include "implicit_gemm.cuh"

#include <limits.h>

namespace {

using namespace moco_gemm;

template <typename T>
struct DwTile;
template <>
struct DwTile<float> {
  static constexpr int BR = 16, LDZ = 64 + 8, LDD = 64 + 8;
  using Acc = FmaAcc<false, BR, LDZ, LDD>;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
conv_dw_partial(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const T* __restrict__ dy,
                float* __restrict__ part, int out_vec, ConvGeom g, int64_t rows_per_slab) {
  using Tile = DwTile<T>;
  using Acc = typename Tile::Acc;
  constexpr int BKO = Acc::BM, BN = Acc::BN, BR = Tile::BR;
  __shared__ __align__(128) T sz[BR * Tile::LDZ];
  __shared__ __align__(128) T sd[BR * Tile::LDD];
  // row decodes of the current and the next chunk, alternating
  __shared__ int s_img[2][BR], s_ih[2][BR], s_iw[2][BR];

  const int n_tiles = (g.n + BN - 1) / BN;
  const int k0 = (blockIdx.x / n_tiles) * BKO;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int tap = blockIdx.y;
  int di, dj;
  tap_offsets(g.taps, tap, di, dj);
  const int64_t r0 = (int64_t)blockIdx.z * rows_per_slab;
  const int64_t r1 = r0 + rows_per_slab < g.m ? r0 + rows_per_slab : g.m;

  ZTile<T, BR, BKO, Tile::LDZ, VEC> zt;
  RowTile<T, BR, BN, Tile::LDD, VEC> dt;
  decode_rows(g, r0, BR, r1, s_img[0], s_ih[0], s_iw[0]);
  __syncthreads();
  zt.fetch(x, g, di, dj, k0, s_img[0], s_ih[0], s_iw[0]);
  dt.fetch(dy, r0, r1, g.n, n0, g.n);
  Acc acc;
  acc.zero();
  int cur = 0;
  for (int64_t p0 = r0; p0 < r1; p0 += BR, cur ^= 1) {
    __syncthreads();  // the previous chunk's product has read the tiles
    zt.commit(a, b, g, di, dj, k0, s_img[cur], s_ih[cur], s_iw[cur], sz);
    dt.commit(sd);
    const bool more = p0 + BR < r1;
    if (more) decode_rows(g, p0 + BR, BR, r1, s_img[cur ^ 1], s_ih[cur ^ 1], s_iw[cur ^ 1]);
    __syncthreads();
    if (more) {  // the next rows' loads fly while these multiply
      zt.fetch(x, g, di, dj, k0, s_img[cur ^ 1], s_ih[cur ^ 1], s_iw[cur ^ 1]);
      dt.fetch(dy, p0 + BR, r1, g.n, n0, g.n);
    }
    acc.mma(sz, sd);  // z^T dy: z is the column-major A operand
  }
  float* out = part + ((int64_t)blockIdx.z * g.taps + tap) * g.k * g.n;
  acc.store([&](int r, int c, const float* v, int count) {
    const int k = k0 + r;
    const int n = n0 + c;
    if (k < g.k && n < g.n) {
      const int in_row = g.n - n < count ? g.n - n : count;
      store_out<Acc::RUN>(out, false, out_vec, (int64_t)k * g.n + n, v, in_row);
    }
  });
}

// out[i] = sum over slabs s of part[s * total + i], in slab order
__global__ void __launch_bounds__(kThreads)
sum_slabs(const float* __restrict__ part, int slabs, int64_t total, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sl = 0; sl < slabs; ++sl) s += part[(int64_t)sl * total + i];
  out[i] = s;
}

template <typename T>
int launch(const void* x, const float* a, const float* b, const void* dy, float* part,
           float* out, const ConvGeom& g, int slabs, cudaStream_t st) {
  constexpr int BKO = DwTile<T>::Acc::BM, BN = DwTile<T>::Acc::BN, BR = DwTile<T>::BR;
  // rows per slab, rounded up to whole row chunks
  int64_t rows = (g.m + slabs - 1) / slabs;
  rows = (rows + BR - 1) / BR * BR;
  const int tiles = ((g.k + BKO - 1) / BKO) * ((g.n + BN - 1) / BN);
  const dim3 grid((unsigned)tiles, (unsigned)g.taps, (unsigned)slabs);
  // one slab writes its partial straight into the output
  float* dst = slabs == 1 ? out : part;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const int out_vec = wide_stores(g.n, dst);
  if (wide_loads<T>(g.k, g.n, x, dy, a, b))
    conv_dw_partial<T, 16 / sizeof(T)><<<grid, kThreads, 0, st>>>(xt, a, b, dyt, dst, out_vec, g,
                                                                   rows);
  else
    conv_dw_partial<T, 1><<<grid, kThreads, 0, st>>>(xt, a, b, dyt, dst, out_vec, g, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return (int)err;
  const int64_t total = (int64_t)g.taps * g.k * g.n;
  sum_slabs<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(part, slabs,
                                                                              total, out);
  return (int)cudaGetLastError();
}

int run(const void* x, const float* a, const float* b, const void* dy, float* part,
        float* out, int dtype, const ConvGeom& g, int slabs, void* stream) {
  if (g.m <= 0 || g.m > INT_MAX || g.k <= 0 || g.n <= 0 || slabs <= 0 || slabs > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // bf16 (dtype 1) is matmul_dw.cu's and conv3x3_dw.cu's
  if (dtype == 0) return launch<float>(x, a, b, dy, part, out, g, slabs, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// part: f32 [slabs, taps, K, N] scratch (unused when slabs == 1); out: f32
// [taps, K, N]. Each returns cudaGetLastError() after the launches
// (0 = success).

// dW[K, N] = relu(x[M, K]*a + b)^T @ dy[M, N]; dtype (of x and dy) must be
// 0 = float32: bfloat16 (1) is moco_matmul_dw_bf16's and returns
// cudaErrorInvalidValue here
extern "C" int moco_bn_relu_matmul_dw(const void* x, const float* a, const float* b,
                                      const void* dy, float* part, float* out, int dtype,
                                      int64_t m, int k, int n, int slabs, void* stream) {
  ConvGeom g;
  g.bsz = (int)(m > INT_MAX ? INT_MAX : m);
  g.h = g.w = g.ho = g.wo = 1;
  g.k = k;
  g.n = n;
  g.stride = 1;
  g.taps = 1;
  g.m = m;
  return run(x, a, b, dy, part, out, dtype, g, slabs, stream);
}

// dW[3, 3, K, N] of relu(x*a + b) conv W (stride 1, zero pad 1) against dy,
// x and dy float32
extern "C" int moco_conv3x3_dw_f32(const void* x, const float* a, const float* b,
                                   const void* dy, float* part, float* out, int bsz, int h,
                                   int wd, int k, int n, int slabs, void* stream) {
  if (bsz <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  ConvGeom g;
  g.bsz = bsz;
  g.h = g.ho = h;
  g.w = g.wo = wd;
  g.k = k;
  g.n = n;
  g.stride = 1;
  g.taps = 9;
  g.m = (int64_t)bsz * h * wd;
  return run(x, a, b, dy, part, out, 0, g, slabs, stream);
}
