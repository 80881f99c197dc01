// Per-channel BatchNorm reductions for Hopper (sm_90a), bound to Python
// through ctypes by moco_tpu_torch/ops/stats.py.
//
// Replaces the Pallas TPU kernels of moco_tpu/ops/pallas_stats.py:
//   channel_sums       (:113, body _sums_kernel :43, pallas_call :121)
//   channel_grad_sums  (:139, body _grad_sums_kernel :56, pallas_call :155)
//
// Work: x is a [M, C] row-major matrix (a channels_last NCHW activation
// viewed as [N*H*W, C]), bf16 or f32.
//   channel_sums       -> (sum x, sum x*x) per channel, f32
//   channel_grad_sums  -> (sum dy, sum dy*xhat) per channel, f32, with
//                         xhat = (x - mean) * rstd recomputed in registers
//
// Bound: both are streaming reads; the outputs are 2*C floats. On an H100
// SXM (3.35 TB/s) channel_sums over the ResNet-50 stem BN at batch 256
// ([3 211 264, 64] bf16, 411 MB) takes at least ~0.12 ms, and
// channel_grad_sums twice that (it reads dy and x).
//
// Design: the TPU kernel walks its grid in order and carries the sums in
// an accumulator block from one grid step to the next. Hopper runs blocks in
// no order, so the reduction is two passes. Pass 1: each block owns a tile
// of channels and a slab of rows. A thread loads 16 bytes of a row (8 bf16
// or 4 f32 channels) with its neighbours on the neighbouring addresses, so a
// warp reads whole rows; it accumulates in f32 registers, and the block
// folds its row lanes through shared memory into one partial per channel.
// Pass 2 sums each channel's slab partials in slab order. There are no float
// atomics, so two runs on the same input give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per pass-1 block
constexpr int kMaxVec = 8;      // channels per 16-byte bf16 load
constexpr int kLanes = 8;       // slab lanes per pass-2 block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_pack(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> r = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(r.v[i]);
}

// Fold the block's row lanes (threadIdx.y) into one partial per channel, in
// lane order, and store it at row `blockIdx.y` of the [slabs, C] partials.
template <int VEC>
__device__ __forceinline__ void fold_lanes(const float (&a)[VEC], const float (&b)[VEC],
                                           int c, float* pa, float* pb) {
  __shared__ float sh_a[kThreads * kMaxVec];
  __shared__ float sh_b[kThreads * kMaxVec];
  const int width = blockDim.x * VEC;  // channels of this block's tile
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh_a[threadIdx.y * width + threadIdx.x * VEC + i] = a[i];
    sh_b[threadIdx.y * width + threadIdx.x * VEC + i] = b[i];
  }
  __syncthreads();
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int cc = blockIdx.x * width + t;
  if (t < width && cc < c) {
    float sa = 0.f, sb = 0.f;
    for (int y = 0; y < blockDim.y; ++y) {
      sa += sh_a[y * width + t];
      sb += sh_b[y * width + t];
    }
    pa[(int64_t)blockIdx.y * c + cc] = sa;
    pb[(int64_t)blockIdx.y * c + cc] = sb;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
sums_partial(const T* __restrict__ x, int64_t m, int c, int64_t rows_per_slab,
             float* __restrict__ psum, float* __restrict__ psq) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_slab;
  const int64_t r1 = r0 + rows_per_slab < m ? r0 + rows_per_slab : m;
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (c0 < c) {
#pragma unroll 4
    for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      float v[VEC];
      load_pack<T, VEC>(x + r * c + c0, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        q[i] += v[i] * v[i];
      }
    }
  }
  fold_lanes<VEC>(s, q, c, psum, psq);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
grad_sums_partial(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  int64_t m, int c, int64_t rows_per_slab,
                  float* __restrict__ pdsum, float* __restrict__ pdxh) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_slab;
  const int64_t r1 = r0 + rows_per_slab < m ? r0 + rows_per_slab : m;
  float s[VEC], q[VEC], mu[VEC], rs[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = mu[i] = rs[i] = 0.f;
  if (c0 < c) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mu[i] = mean[c0 + i];
      rs[i] = rstd[c0 + i];
    }
#pragma unroll 4
    for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      float d[VEC], v[VEC];
      load_pack<T, VEC>(dy + r * c + c0, d);
      load_pack<T, VEC>(x + r * c + c0, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (v[i] - mu[i]) * rs[i];
        s[i] += d[i];
        q[i] += d[i] * xh;
      }
    }
  }
  fold_lanes<VEC>(s, q, c, pdsum, pdxh);
}

// Pass 2: out[c] = sum over slabs of partial[slab, c], lanes over slabs,
// then the lanes folded in lane order.
__global__ void __launch_bounds__(32 * kLanes)
sum_partials(const float* __restrict__ pa, const float* __restrict__ pb,
             int slabs, int c, float* __restrict__ oa, float* __restrict__ ob) {
  __shared__ float sh_a[kLanes][32];
  __shared__ float sh_b[kLanes][32];
  const int cc = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (cc < c) {
    for (int s = threadIdx.y; s < slabs; s += kLanes) {
      a += pa[(int64_t)s * c + cc];
      b += pb[(int64_t)s * c + cc];
    }
  }
  sh_a[threadIdx.y][threadIdx.x] = a;
  sh_b[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && cc < c) {
    float ta = 0.f, tb = 0.f;
    for (int y = 0; y < kLanes; ++y) {
      ta += sh_a[y][threadIdx.x];
      tb += sh_b[y][threadIdx.x];
    }
    oa[cc] = ta;
    ob[cc] = tb;
  }
}

// Widest load (in channels) that divides C and keeps every row aligned.
int pick_vec(int c, int elem_bytes, uintptr_t a, uintptr_t b) {
  int vec = 16 / elem_bytes;
  while (vec > 1 && (c % vec != 0 || a % (vec * elem_bytes) != 0 ||
                     b % (vec * elem_bytes) != 0))
    vec /= 2;
  return vec;
}

struct Geometry {
  dim3 grid, block;
  int64_t rows_per_slab;
};

Geometry geometry(int64_t m, int c, int vec, int slabs) {
  const int cvec = c / vec;
  const int bx = cvec < 32 ? cvec : 32;
  Geometry g;
  g.block = dim3(bx, kThreads / bx);
  g.grid = dim3((cvec + bx - 1) / bx, slabs);
  g.rows_per_slab = (m + slabs - 1) / slabs;
  return g;
}

template <typename T>
void launch_sums(const T* x, int64_t m, int c, int slabs, float* psum, float* psq,
                 cudaStream_t st) {
  const int vec = pick_vec(c, sizeof(T), (uintptr_t)x, (uintptr_t)x);
  const Geometry g = geometry(m, c, vec, slabs);
  switch (vec) {
    case 8: sums_partial<T, 8><<<g.grid, g.block, 0, st>>>(x, m, c, g.rows_per_slab, psum, psq); break;
    case 4: sums_partial<T, 4><<<g.grid, g.block, 0, st>>>(x, m, c, g.rows_per_slab, psum, psq); break;
    case 2: sums_partial<T, 2><<<g.grid, g.block, 0, st>>>(x, m, c, g.rows_per_slab, psum, psq); break;
    default: sums_partial<T, 1><<<g.grid, g.block, 0, st>>>(x, m, c, g.rows_per_slab, psum, psq); break;
  }
}

template <typename T>
void launch_grad_sums(const T* dy, const T* x, const float* mean, const float* rstd,
                      int64_t m, int c, int slabs, float* pdsum, float* pdxh,
                      cudaStream_t st) {
  const int vec = pick_vec(c, sizeof(T), (uintptr_t)dy, (uintptr_t)x);
  const Geometry g = geometry(m, c, vec, slabs);
  switch (vec) {
    case 8: grad_sums_partial<T, 8><<<g.grid, g.block, 0, st>>>(dy, x, mean, rstd, m, c, g.rows_per_slab, pdsum, pdxh); break;
    case 4: grad_sums_partial<T, 4><<<g.grid, g.block, 0, st>>>(dy, x, mean, rstd, m, c, g.rows_per_slab, pdsum, pdxh); break;
    case 2: grad_sums_partial<T, 2><<<g.grid, g.block, 0, st>>>(dy, x, mean, rstd, m, c, g.rows_per_slab, pdsum, pdxh); break;
    default: grad_sums_partial<T, 1><<<g.grid, g.block, 0, st>>>(dy, x, mean, rstd, m, c, g.rows_per_slab, pdsum, pdxh); break;
  }
}

void launch_finish(const float* pa, const float* pb, int slabs, int c, float* oa,
                   float* ob, cudaStream_t st) {
  sum_partials<<<(c + 31) / 32, dim3(32, kLanes), 0, st>>>(pa, pb, slabs, c, oa, ob);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. partials: two [slabs, C] f32 buffers.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int moco_channel_sums(const void* x, int dtype, int64_t m, int c, int slabs,
                                 float* psum, float* psq, float* out_sum, float* out_sq,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || c <= 0 || slabs <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_sums(static_cast<const float*>(x), m, c, slabs, psum, psq, st);
  else if (dtype == 1)
    launch_sums(static_cast<const __nv_bfloat16*>(x), m, c, slabs, psum, psq, st);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_finish(psum, psq, slabs, c, out_sum, out_sq, st);
  return (int)cudaGetLastError();
}

extern "C" int moco_channel_grad_sums(const void* dy, const void* x, int dtype,
                                      const float* mean, const float* rstd, int64_t m,
                                      int c, int slabs, float* pdsum, float* pdxh,
                                      float* out_dsum, float* out_dxh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || c <= 0 || slabs <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_grad_sums(static_cast<const float*>(dy), static_cast<const float*>(x), mean,
                     rstd, m, c, slabs, pdsum, pdxh, st);
  else if (dtype == 1)
    launch_grad_sums(static_cast<const __nv_bfloat16*>(dy),
                     static_cast<const __nv_bfloat16*>(x), mean, rstd, m, c, slabs,
                     pdsum, pdxh, st);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_finish(pdsum, pdxh, slabs, c, out_dsum, out_dxh, st);
  return (int)cudaGetLastError();
}

// Text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* moco_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
