// Per-channel BatchNorm reductions for Hopper (sm_90a), bound to Python
// through ctypes by moco_tpu_torch/ops/stats.py.
//
// Replaces the Pallas TPU kernels of moco_tpu/ops/pallas_stats.py:
//   channel_sums       (:113, body _sums_kernel :43, pallas_call :121)
//                      -> channel_sums_rows<T, VEC>
//   channel_grad_sums  (:139, body _grad_sums_kernel :56, pallas_call :155)
//                      -> channel_grad_sums_rows<T, VEC>
//
// Work: x is a [M, C] row-major matrix (a channels_last NCHW activation
// viewed as [N*H*W, C]), bf16 or f32.
//   channel_sums       -> (sum x, sum x*x) per channel, f32
//   channel_grad_sums  -> (sum dy, sum dy*xhat) per channel, f32, with
//                         xhat = (x - mean) * rstd recomputed in registers
//
// Bound: both are streaming reads of every input element once; the outputs
// are 2*C floats. On an H100 SXM (3.35 TB/s) channel_sums over the ResNet-50
// stem BN at batch 256 ([3 211 264, 64] bf16, 411 MB) takes at least
// 0.123 ms, channel_grad_sums twice that (it reads dy and x). The smallest
// BN shapes of the step ([12 544, 512], 12.8 MB) are bounded near 4 us, so
// there the launch, the ramp of the first loads and the cross-block fold
// are the time.
//
// Design. The TPU kernel walks its grid in order and carries the sums in an
// accumulator block from one grid step to the next. Hopper runs blocks in
// no order, so the reduction crosses blocks, here inside one launch:
// - A block of 256 threads owns a tile of channels (`lanes` threads of VEC
//   channels, one 16-byte load each where C and the pointers allow) and a
//   slab of rows; its `256 / lanes` row lanes walk the slab. The launch plan
//   (`stats_plan` in ops/stats.py) makes a tile 128 bytes of each row (one
//   whole line: 64 bf16 channels) and gives it `264 / tiles` slabs, so the
//   grid is one wave of two blocks per SM at every ResNet-50 shape (256 of
//   264 slots at C = 1024 and 2048). Wider tiles need more slabs for the
//   same wave, and so more partials to fold; narrower ones split a line
//   between SMs.
// - Each thread issues the loads of a batch of rows into registers before it
//   adds any of them: 8 rows of x (channel_sums), or 4 rows each of dy and x
//   (channel_grad_sums; 8 of each spill past 128 registers), so 8 16-byte
//   loads are in flight a thread. The loads carry no cache hint: the caller
//   reads x again right after.
// - The block folds its row lanes in a fixed order (a shuffle butterfly in
//   each warp, then the warps in warp order through shared memory) and
//   stores one f32 partial per channel at row `slab` of the workspace.
// - It then fences and takes an integer ticket for its tile (atomicAdd on an
//   unsigned counter). The block that draws the last ticket reads the tile's
//   partials through L2 (__ldcg, a float4 a thread where C allows), sums them
//   in slab order in lanes over the slabs, folds the lanes in lane order,
//   writes the outputs and puts the ticket back to 0. The tickets are a
//   zeroed int32 tensor the wrapper keeps per (device, stream), so a call
//   needs no memset and can be captured into a CUDA graph and replayed.
// No float is ever added atomically and every sum has a fixed order, so two
// runs on the same input give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;   // blocks per SM the plan counts on (<= 128 registers)
constexpr int kMaxTile = 256;   // channels of the widest tile: 32 lanes x 8
constexpr int kMaxSlabs = 65535;
constexpr int kLoads = 8;       // 16-byte loads in flight a thread (8 rows of two operands spill)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> zero_pack() {
  Pack<T, VEC> z;
#pragma unroll
  for (int i = 0; i < VEC; ++i) z.v[i] = T(0.f);
  return z;
}

struct Fold {
  float a[kWarps * kMaxTile];
  float b[kWarps * kMaxTile];
  unsigned last;
};

// Where a thread sits: `lane_c` of the tile's `lanes` channel lanes, `lane_r`
// of the block's kThreads / lanes row lanes. Threads of one row lane are
// neighbours, so a warp reads 32 / lanes whole row segments.
struct Place {
  int lanes, lane_c, lane_r, rows, c0;
  int64_t r0, r1;
};

template <int VEC>
__device__ __forceinline__ Place place(int64_t m, int c, int lanes, int64_t rows_per_slab) {
  Place p;
  p.lanes = lanes;
  p.lane_c = threadIdx.x % lanes;
  p.lane_r = threadIdx.x / lanes;
  p.rows = kThreads / lanes;
  p.c0 = (blockIdx.x * lanes + p.lane_c) * VEC;
  p.r0 = (int64_t)blockIdx.y * rows_per_slab;
  p.r1 = p.r0 + rows_per_slab < m ? p.r0 + rows_per_slab : m;
  return p;
}

// The last block of a tile: the tile's slab partials read through L2, W
// channels a load, summed in slab order by lanes over the slabs
// (`kThreads * W / tile` of them: lane l takes slabs l, l + lanes, ...), the
// lanes then folded in lane order; the outputs written.
template <int W>
__device__ __forceinline__ void fold_slabs(const float* pa, const float* pb, int c, int tile0,
                                           int tile, int slabs, Fold& sh, float* out_a,
                                           float* out_b) {
  const int groups = tile / W;  // W-channel groups of the tile
  const int lanes_s = kThreads / groups;
  const int t = threadIdx.x, g = t % groups, l = t / groups;
  const int ch = tile0 + g * W;  // W = 4 only where C % 4 == 0: all W in range
  float sa[W], sb[W];
#pragma unroll
  for (int w = 0; w < W; ++w) sa[w] = sb[w] = 0.f;
  if (ch < c) {
#pragma unroll 4
    for (int s = l; s < slabs; s += lanes_s) {
      const int64_t at = (int64_t)s * c + ch;
      if constexpr (W == 4) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(pa + at));
        const float4 b = __ldcg(reinterpret_cast<const float4*>(pb + at));
        sa[0] += a.x; sa[1] += a.y; sa[2] += a.z; sa[3] += a.w;
        sb[0] += b.x; sb[1] += b.y; sb[2] += b.z; sb[3] += b.w;
      } else {
        sa[0] += __ldcg(pa + at);
        sb[0] += __ldcg(pb + at);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    sh.a[l * tile + g * W + w] = sa[w];
    sh.b[l * tile + g * W + w] = sb[w];
  }
  __syncthreads();
  if (t < tile && tile0 + t < c) {
    float ta = 0.f, tb = 0.f;
    for (int i = 0; i < lanes_s; ++i) {
      ta += sh.a[i * tile + t];
      tb += sh.b[i * tile + t];
    }
    out_a[tile0 + t] = ta;
    out_b[tile0 + t] = tb;
  }
}

// The block's fold and the cross-block fold. a and b are this thread's sums
// over its rows for channels c0 .. c0 + VEC; the outputs land at out_a/out_b.
template <int VEC>
__device__ __forceinline__ void finish(float (&a)[VEC], float (&b)[VEC], const Place& p,
                                       int c, float* __restrict__ ws,
                                       unsigned* __restrict__ tickets) {
  __shared__ Fold sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = p.lanes * VEC;  // channels of this block's tile
  const int tile0 = blockIdx.x * tile;
  const int slabs = gridDim.y;
  float* pa = ws;
  float* pb = ws + (int64_t)slabs * c;
  float* out_a = ws + 2 * (int64_t)slabs * c;
  float* out_b = out_a + c;

  // 1. The row lanes of each warp: a butterfly over lane bits >= log2(lanes).
  for (int off = p.lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
      b[i] += __shfl_xor_sync(0xffffffffu, b[i], off);
    }
  }
  if (lane < p.lanes) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sh.a[warp * tile + lane * VEC + i] = a[i];
      sh.b[warp * tile + lane * VEC + i] = b[i];
    }
  }
  __syncthreads();
  // 2. The warps in warp order: the block's partial, at row `slab`.
  const int t = threadIdx.x;
  if (t < tile && tile0 + t < c) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sa += sh.a[w * tile + t];
      sb += sh.b[w * tile + t];
    }
    pa[(int64_t)blockIdx.y * c + tile0 + t] = sa;
    pb[(int64_t)blockIdx.y * c + tile0 + t] = sb;
  }
  // 3. The ticket: the last block of the tile folds the tile's partials.
  __threadfence();
  __syncthreads();
  if (t == 0) sh.last = atomicAdd(&tickets[blockIdx.x], 1u) == (unsigned)(slabs - 1);
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  if (tile % 4 == 0 && c % 4 == 0)
    fold_slabs<4>(pa, pb, c, tile0, tile, slabs, sh, out_a, out_b);
  else
    fold_slabs<1>(pa, pb, c, tile0, tile, slabs, sh, out_a, out_b);
  if (t == 0) tickets[blockIdx.x] = 0u;
}

// One row's terms: (x, x*x), or (dy, dy*xhat) with xhat = (x - mean) * rstd.
template <typename T, int VEC>
__device__ __forceinline__ void add_sums(const Pack<T, VEC>& v, float (&s)[VEC],
                                         float (&q)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float f = to_f32(v.v[i]);
    s[i] += f;
    q[i] += f * f;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void add_grad_sums(const Pack<T, VEC>& d, const Pack<T, VEC>& v,
                                              const float (&mu)[VEC], const float (&rs)[VEC],
                                              float (&s)[VEC], float (&q)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float g = to_f32(d.v[i]);
    s[i] += g;
    q[i] += g * ((to_f32(v.v[i]) - mu[i]) * rs[i]);
  }
}

// A lane's rows r, r + rows, ... of its slab: whole batches with BATCH loads
// in flight and then the adds in row order, and a last, partial batch.
template <typename T, int VEC, int BATCH = kLoads>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
channel_sums_rows(const T* __restrict__ x, int64_t m, int c, int lanes, int64_t rows_per_slab,
                  float* __restrict__ ws, unsigned* __restrict__ tickets) {
  const Place p = place<VEC>(m, c, lanes, rows_per_slab);
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (p.c0 < c) {
    const int64_t step = (int64_t)p.rows * c;  // elements between a lane's rows
    int64_t r = p.r0 + p.lane_r;
    const T* src = x + r * c + p.c0;
    Pack<T, VEC> v[BATCH];
    for (; r + (BATCH - 1) * p.rows < p.r1; r += BATCH * p.rows, src += BATCH * step) {
#pragma unroll
      for (int j = 0; j < BATCH; ++j) v[j] = load_pack<T, VEC>(src + j * step);
#pragma unroll
      for (int j = 0; j < BATCH; ++j) add_sums<T, VEC>(v[j], s, q);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      v[j] = r + j * p.rows < p.r1 ? load_pack<T, VEC>(src + j * step) : zero_pack<T, VEC>();
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (r + j * p.rows < p.r1) add_sums<T, VEC>(v[j], s, q);
  }
  finish<VEC>(s, q, p, c, ws, tickets);
}

template <typename T, int VEC, int BATCH = kLoads / 2>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
channel_grad_sums_rows(const T* __restrict__ dy, const T* __restrict__ x,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       int64_t m, int c, int lanes, int64_t rows_per_slab,
                       float* __restrict__ ws, unsigned* __restrict__ tickets) {
  const Place p = place<VEC>(m, c, lanes, rows_per_slab);
  float s[VEC], q[VEC], mu[VEC], rs[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = mu[i] = rs[i] = 0.f;
  if (p.c0 < c) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mu[i] = mean[p.c0 + i];
      rs[i] = rstd[p.c0 + i];
    }
    const int64_t step = (int64_t)p.rows * c;
    int64_t r = p.r0 + p.lane_r;
    const T* dsrc = dy + r * c + p.c0;
    const T* xsrc = x + r * c + p.c0;
    Pack<T, VEC> d[BATCH], v[BATCH];
    for (; r + (BATCH - 1) * p.rows < p.r1;
         r += BATCH * p.rows, dsrc += BATCH * step, xsrc += BATCH * step) {
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        d[j] = load_pack<T, VEC>(dsrc + j * step);
        v[j] = load_pack<T, VEC>(xsrc + j * step);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) add_grad_sums<T, VEC>(d[j], v[j], mu, rs, s, q);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const bool in = r + j * p.rows < p.r1;
      d[j] = in ? load_pack<T, VEC>(dsrc + j * step) : zero_pack<T, VEC>();
      v[j] = in ? load_pack<T, VEC>(xsrc + j * step) : zero_pack<T, VEC>();
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (r + j * p.rows < p.r1) add_grad_sums<T, VEC>(d[j], v[j], mu, rs, s, q);
  }
  finish<VEC>(s, q, p, c, ws, tickets);
}

// The plan's numbers, checked against [m, c] and the pointers: a supported
// pack that divides C and the alignment, lanes a power of two up to a warp,
// the kernel's batch (kLoads rows of one operand, half as many of two), and
// slabs that cover every row with none empty.
bool plan_ok(int64_t m, int c, int elem, int operands, int vec, int lanes, int batch, int slabs,
             int64_t rows_per_slab, uintptr_t a, uintptr_t b) {
  if (m <= 0 || c <= 0) return false;
  if (vec != 1 && vec != 2 && vec != 4 && vec != 8) return false;
  if (vec * elem > 16 || c % vec != 0 || (a | b) % (uintptr_t)(vec * elem) != 0) return false;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return false;
  if (batch * operands != kLoads) return false;
  if (slabs < 1 || slabs > kMaxSlabs || rows_per_slab < 1) return false;
  return (int64_t)slabs * rows_per_slab >= m && (int64_t)(slabs - 1) * rows_per_slab < m;
}

dim3 grid_of(int c, int vec, int lanes, int slabs) {
  const int tile = lanes * vec;
  return dim3((c + tile - 1) / tile, slabs);
}

template <typename T, int VEC>
void sums_at(dim3 grid, const T* x, int64_t m, int c, int lanes, int64_t rps, float* ws,
             unsigned* tickets, cudaStream_t st) {
  channel_sums_rows<T, VEC><<<grid, kThreads, 0, st>>>(x, m, c, lanes, rps, ws, tickets);
}

template <typename T>
void launch_sums(const T* x, int64_t m, int c, int vec, int lanes, int slabs, int64_t rps,
                 float* ws, unsigned* tickets, cudaStream_t st) {
  const dim3 grid = grid_of(c, vec, lanes, slabs);
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) sums_at<T, 8>(grid, x, m, c, lanes, rps, ws, tickets, st);
      break;
    case 4: sums_at<T, 4>(grid, x, m, c, lanes, rps, ws, tickets, st); break;
    case 2: sums_at<T, 2>(grid, x, m, c, lanes, rps, ws, tickets, st); break;
    default: sums_at<T, 1>(grid, x, m, c, lanes, rps, ws, tickets, st); break;
  }
}

template <typename T, int VEC>
void grad_sums_at(dim3 grid, const T* dy, const T* x, const float* mean, const float* rstd,
                  int64_t m, int c, int lanes, int64_t rps, float* ws, unsigned* tickets,
                  cudaStream_t st) {
  channel_grad_sums_rows<T, VEC><<<grid, kThreads, 0, st>>>(dy, x, mean, rstd, m, c, lanes, rps,
                                                            ws, tickets);
}

template <typename T>
void launch_grad_sums(const T* dy, const T* x, const float* mean, const float* rstd, int64_t m,
                      int c, int vec, int lanes, int slabs, int64_t rps, float* ws,
                      unsigned* tickets, cudaStream_t st) {
  const dim3 grid = grid_of(c, vec, lanes, slabs);
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2)
        grad_sums_at<T, 8>(grid, dy, x, mean, rstd, m, c, lanes, rps, ws, tickets, st);
      break;
    case 4: grad_sums_at<T, 4>(grid, dy, x, mean, rstd, m, c, lanes, rps, ws, tickets, st); break;
    case 2: grad_sums_at<T, 2>(grid, dy, x, mean, rstd, m, c, lanes, rps, ws, tickets, st); break;
    default: grad_sums_at<T, 1>(grid, dy, x, mean, rstd, m, c, lanes, rps, ws, tickets, st); break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The plan (ops/stats.py::stats_plan):
// vec channels a load, lanes threads across a tile, batch rows a thread
// loads at once (8, or 4 for channel_grad_sums), slabs of rows_per_slab
// rows. ws: 2 * slabs * C f32 partials followed by the two [C] outputs.
// tickets: one zeroed counter per channel tile, left at 0. Returns
// cudaErrorInvalidValue where the plan does not cover [m, c], else
// cudaGetLastError() after the launch (0 = success).
extern "C" int moco_channel_sums(const void* x, int dtype, int64_t m, int c, int vec, int lanes,
                                 int batch, int slabs, int64_t rows_per_slab, float* ws,
                                 unsigned* tickets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (!plan_ok(m, c, elem, 1, vec, lanes, batch, slabs, rows_per_slab, (uintptr_t)x,
               (uintptr_t)x))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_sums(static_cast<const float*>(x), m, c, vec, lanes, slabs, rows_per_slab, ws,
                tickets, st);
  else
    launch_sums(static_cast<const __nv_bfloat16*>(x), m, c, vec, lanes, slabs, rows_per_slab, ws,
                tickets, st);
  return (int)cudaGetLastError();
}

extern "C" int moco_channel_grad_sums(const void* dy, const void* x, int dtype, const float* mean,
                                      const float* rstd, int64_t m, int c, int vec, int lanes,
                                      int batch, int slabs, int64_t rows_per_slab, float* ws,
                                      unsigned* tickets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (!plan_ok(m, c, elem, 2, vec, lanes, batch, slabs, rows_per_slab, (uintptr_t)dy,
               (uintptr_t)x))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_grad_sums(static_cast<const float*>(dy), static_cast<const float*>(x), mean, rstd, m,
                     c, vec, lanes, slabs, rows_per_slab, ws, tickets, st);
  else
    launch_grad_sums(static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(x),
                     mean, rstd, m, c, vec, lanes, slabs, rows_per_slab, ws, tickets, st);
  return (int)cudaGetLastError();
}

// Text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* moco_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
