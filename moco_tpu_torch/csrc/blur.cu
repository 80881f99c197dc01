// Per-sample separable Gaussian blur for Hopper (sm_90a), bound to Python
// through ctypes by moco_tpu_torch/ops/blur.py (`gaussian_blur_batch`, whose
// plan `blur_plan` chooses the row bands and the shared memory).
//
// Replaces the Pallas TPU kernel moco_tpu/ops/pallas_blur.py
// gaussian_blur_batch (:56, body _blur_kernel :37, pallas_call :77)
//   -> blur_rows<T, 11> (R = 11, blur_radius(224)) and blur_rows<T, 0> (any R).
//
// Work: images [B, H, W, 3] (NHWC, bf16 or f32), taps [B, 2R+1] f32 per
// sample; out[b] = image[b] blurred first along H, then along W, with the
// image's edge pixels repeated beyond its border; f32 accumulation, output
// in the input dtype. A sample that skips the blur carries one-hot taps and
// goes through the same code.
//
// Bound: one read of the images and one write of the result,
// 2*B*H*W*3*bytes (154 MB for the MoCo-v2 batch of 256 bf16 224x224 views,
// 0.046 ms at 3.35 TB/s), against 2*(2R+1) multiply-adds per output value
// (R = 11 at 224 px) on the f32 units, 0.053 ms at 67 TFLOP/s. Both are
// met only if each input byte leaves device memory once and each counted
// multiply-add issues from registers, without a shared-memory load of its
// own.
//
// Design. The TPU kernel edge-pads the whole image in HBM, keeps it in VMEM
// and transposes it there so that both passes shift along sublanes. Here a
// block of 256 threads owns one sample, or a band of its rows (the plan
// splits samples into bands where the batch alone would not fill a wave of
// the card), and walks it down in chunks of kRun = 8 output rows:
// - Ring. Input rows live in a ring of 2*kRun + 2R row slots in shared
//   memory. Row y goes to slot y % slots, copied with 16-byte cp.async from
//   the granule that holds its first byte to the one that holds its last
//   (so rows and samples at any 2-byte offset take the same copy; the
//   granules at the ends may hold bytes of a neighbour, which are never
//   read). A chunk reads rows c0 - R .. c0 + kRun - 1 + R, clamped to the
//   image through a table of row offsets: the clamp is the top and bottom
//   edge padding, with no padded copy.
// - H pass over exactly the block's outputs. A thread owns one column
//   element (pixel x, channel ch) and the chunk's 8 rows: it loads the 8+2R
//   values of its column once, each into a register, and does the
//   8*(2R+1) multiply-adds from there. The result goes to a mid buffer in
//   f32, one plane per channel, each plane padded by R columns that repeat
//   the edge pixel (the left and right edge padding; the H pass acts on each
//   column alone, so this gives the bits of a padded image). A plane puts a
//   pad float after every 8 (`skew`) and has a pitch of 3 * runs mod 32
//   floats, so a W-pass warp's 32 runs fall on 32 banks.
// - W pass. A thread owns 8 consecutive pixels of one row, all 3 channels:
//   per channel 8+2R loads, 8*(2R+1) multiply-adds, then the 24 values go
//   out as three (bf16) or six (f32) 16-byte stores where the row allows
//   (`packed`), else one element at a time.
// - Pipeline. There are two mid buffers and two row tables. Between two
//   barriers a block runs the H pass of chunk c beside the W pass of chunk
//   c - 1 and copies chunk c + 1's new rows, so the copy has a whole
//   chunk's compute to land and a chunk costs one barrier. W runs are
//   dealt from the first thread up and H columns from the last thread
//   down, so that the SM's four sub-partitions (each holds warps w and
//   w + 4 of a block) get about the same work: at 224 px the busiest one
//   has 2 warps' W runs and 5 warps' H columns a chunk, against 2 and 6
//   when both are dealt from the first thread.
// - Taps. One sample per block makes the taps uniform. blur_rows<T, 11>
//   keeps them in registers and unrolls every loop over them;
//   blur_rows<T, 0> takes R at run time and reads the taps and the row
//   table from shared memory.
// Shared memory per block at 224 px bf16, R = 11: 38 slots of 1360 bytes
// and 2 x 3 x 8 planes of 308 floats, 111 KB, so two blocks share an SM;
// 109 registers a thread (R = 11, bf16), no spills. Every sum has a fixed
// order, so a run gives the same bits every time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_mma.cuh"

namespace {

using moco_band::copy_commit;
using moco_band::copy_wait_all;
using moco_band::smem_addr;

constexpr int kRun = 8;           // rows of a chunk and an H-pass thread; pixels of a W-pass thread
constexpr int kThreads = 256;     // threads per block
constexpr int kFixedRadius = 11;  // blur_radius(224): the instantiation with taps in registers
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Index of padded column p in a mid plane: a pad float after every 8.
__host__ __device__ __forceinline__ int skew(int p) { return p + (p >> 3); }

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Shared layout, in bytes: the ring (slots x slot_pitch), two mid buffers
// [kRun][3][mid_pitch] f32, two row tables (kRun + 2R ints each), the taps
// (2R + 1 floats; read by the run-time-radius instantiation only).
size_t smem_bytes(int radius, int slots, int slot_pitch, int mid_pitch) {
  return (size_t)slots * slot_pitch +
         4 * ((size_t)2 * kRun * 3 * mid_pitch + 2 * (kRun + 2 * radius) + (2 * radius + 1));
}

// The 24 values of a W-pass run (8 pixels x 3 channels, o[ch][pixel]) as
// 16-byte stores; d is 16-byte aligned.
__device__ __forceinline__ void store_run(__nv_bfloat16* d, const float (&o)[3][kRun]) {
  uint32_t pk[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    const int f0 = 2 * q, f1 = 2 * q + 1;  // flat NHWC elements: pixel f / 3, channel f % 3
    __nv_bfloat162 v = __floats2bfloat162_rn(o[f0 % 3][f0 / 3], o[f1 % 3][f1 / 3]);
    pk[q] = *reinterpret_cast<uint32_t*>(&v);
  }
  uint4* d4 = reinterpret_cast<uint4*>(d);
#pragma unroll
  for (int s = 0; s < 3; ++s)
    d4[s] = make_uint4(pk[4 * s], pk[4 * s + 1], pk[4 * s + 2], pk[4 * s + 3]);
}

__device__ __forceinline__ void store_run(float* d, const float (&o)[3][kRun]) {
  float4* d4 = reinterpret_cast<float4*>(d);
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const int f = 4 * s;
    d4[s] = make_float4(o[f % 3][f / 3], o[(f + 1) % 3][(f + 1) / 3], o[(f + 2) % 3][(f + 2) / 3],
                        o[(f + 3) % 3][(f + 3) / 3]);
  }
}

// acc[t] += w[j - t] * v for the t whose tap j - t exists: window value j
// of a run, in tap order for every output t.
template <int R_>
__device__ __forceinline__ void fma_window(float (&acc)[kRun], const float* wr, const float* w_s,
                                           int taps, int j, float v) {
#pragma unroll
  for (int t = 0; t < kRun; ++t) {
    const int k = j - t;
    if constexpr (R_ > 0) {
      if (k >= 0 && k < 2 * R_ + 1) acc[t] = fmaf(wr[k], v, acc[t]);
    } else {
      if (k >= 0 && k < taps) acc[t] = fmaf(w_s[k], v, acc[t]);
    }
  }
}

template <typename T, int R_>
__global__ void __launch_bounds__(kThreads, 2)
blur_rows(const T* __restrict__ img, const float* __restrict__ weights, T* __restrict__ out,
          int h, int w, int radius_rt, int bands, int band_rows, int slots, int slot_pitch,
          int mid_pitch, int packed) {
  constexpr bool kFixed = R_ > 0;
  const int R = kFixed ? R_ : radius_rt;
  const int taps = 2 * R + 1;
  const int win = kRun + 2 * R;  // input rows a chunk reads
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* mid = reinterpret_cast<float*>(smem + (size_t)slots * slot_pitch);
  int* rows_s = reinterpret_cast<int*>(mid + 2 * kRun * 3 * mid_pitch);  // two row tables
  float* w_s = reinterpret_cast<float*>(rows_s + 2 * win);

  const int sample = blockIdx.x / bands;
  const int y_begin = (blockIdx.x - sample * bands) * band_rows;
  const int y_end = min(h, y_begin + band_rows);
  const int w3 = w * 3;
  const int row_bytes = w3 * (int)sizeof(T);
  const int64_t sample_elems = (int64_t)h * w3;
  const uintptr_t base = reinterpret_cast<uintptr_t>(img + sample * sample_elems);
  const unsigned char* base16 = reinterpret_cast<const unsigned char*>(base & ~(uintptr_t)15);
  const int head = (int)(base & 15);  // the sample starts this far into its first granule
  T* dst = out + sample * sample_elems;
  const float* wt = weights + (int64_t)sample * taps;

  float wr[kFixed ? 2 * R_ + 1 : 1];
  if constexpr (kFixed) {
#pragma unroll
    for (int k = 0; k < 2 * R_ + 1; ++k) wr[k] = __ldg(wt + k);
  } else {
    for (int k = threadIdx.x; k < taps; k += kThreads) w_s[k] = wt[k];
  }

  // rows [y0, y1) into their slots, a warp per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = kThreads / 32;
  auto copy_rows = [&](int y0, int y1) {
    for (int y = y0 + warp; y < y1; y += nwarps) {
      const int64_t first = head + (int64_t)y * row_bytes;  // byte offset from base16
      const int64_t g0 = first & ~(int64_t)15;
      const int n = (int)((first + row_bytes + 15 - g0) >> 4);  // granules of the row
      unsigned char* slot = ring + (size_t)(y % slots) * slot_pitch;
      for (int i = lane; i < n; i += 32) copy16(slot + 16 * i, base16 + g0 + 16 * i);
    }
  };
  // rows a chunk at c0 reads, clamped to the image: [c0 - R, c0 + kRun + R)
  auto need_hi = [&](int c0) { return min(c0 + kRun + R, h); };

  // Ring offset of each row of the window of the chunk at c0 (the clamp is
  // the top and bottom edge padding).
  auto fill_table = [&](int c0, int* table) {
    for (int j = threadIdx.x; j < win; j += kThreads) {
      const int y = min(max(c0 - R + j, 0), h - 1);
      table[j] = (y % slots) * slot_pitch + (int)(((unsigned)head + (unsigned)y * row_bytes) & 15);
    }
  };

  // One H-pass column into the mid planes, and into the R padding columns
  // on either side where it is an edge pixel.
  auto put_mid = [&](float* buf, int e, const float (&acc)[kRun]) {
    const int x = e / 3;
    float* plane = buf + (e - 3 * x) * mid_pitch;  // channel e % 3, row 0 of the chunk
#pragma unroll
    for (int t = 0; t < kRun; ++t) plane[t * 3 * mid_pitch + skew(x + R)] = acc[t];
    if (x == 0) {  // left padding: column 0 repeated
      for (int p = 0; p < R; ++p) {
#pragma unroll
        for (int t = 0; t < kRun; ++t) plane[t * 3 * mid_pitch + skew(p)] = acc[t];
      }
    }
    if (x == w - 1) {  // right padding: column w - 1 repeated
      for (int p = w + R; p < w + 2 * R; ++p) {
#pragma unroll
        for (int t = 0; t < kRun; ++t) plane[t * 3 * mid_pitch + skew(p)] = acc[t];
      }
    }
  };

  // H pass, one column element e of the chunk whose row table is `table`
  // (in registers as `rowoff` for the fixed radius):
  // buf[t][ch][skew(x + R)] = sum_k w[k] * in[c0 + t - R + k][x][ch], e = 3x + ch
  int rowoff[kFixed ? kRun + 2 * R_ : 1];
  auto h_item = [&](float* buf, const int* table, int e) {
    const unsigned char* col = ring + e * (int)sizeof(T);
    float acc[kRun];
#pragma unroll
    for (int t = 0; t < kRun; ++t) acc[t] = 0.f;
    if constexpr (kFixed) {
#pragma unroll
      for (int j = 0; j < kRun + 2 * R_; ++j)
        fma_window<R_>(acc, wr, w_s, taps, j, to_f32(*reinterpret_cast<const T*>(col + rowoff[j])));
    } else {
      for (int j = 0; j < win; ++j)
        fma_window<R_>(acc, wr, w_s, taps, j, to_f32(*reinterpret_cast<const T*>(col + table[j])));
    }
    put_mid(buf, e, acc);
  };

  // W pass, one run of 8 pixels (the last run of a row may be shorter) of
  // row t of the chunk at c0, item it = t * runs + i:
  // out[c0 + t][x][ch] = sum_k w[k] * buf[t][ch][skew(x + k)]
  const int runs = (w + kRun - 1) / kRun;
  auto w_item = [&](int c0, const float* buf, int it) {
    const int t = it / runs, i = it - t * runs;
    const int x0 = i * kRun;
    float o[3][kRun];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* m = buf + (t * 3 + ch) * mid_pitch + 9 * i;  // skew(x0 + j) = 9i + skew(j)
#pragma unroll
      for (int u = 0; u < kRun; ++u) o[ch][u] = 0.f;
      if constexpr (kFixed) {
#pragma unroll
        for (int j = 0; j < kRun + 2 * R_; ++j) fma_window<R_>(o[ch], wr, w_s, taps, j, m[skew(j)]);
      } else {
        for (int j = 0; j < win; ++j) fma_window<R_>(o[ch], wr, w_s, taps, j, m[skew(j)]);
      }
    }
    T* d = dst + ((int64_t)(c0 + t) * w + x0) * 3;
    const int n = min(kRun, w - x0);
    if (packed && n == kRun) {
      store_run(d, o);
    } else {
#pragma unroll
      for (int u = 0; u < kRun; ++u)
        if (u < n) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) d[u * 3 + ch] = from_f32<T>(o[ch][u]);
        }
    }
  };

  // Iteration c runs the H pass of chunk c into mid[c % 2] beside the W
  // pass of chunk c - 1 from mid[(c - 1) % 2]: one barrier a chunk, and
  // every thread has both kinds of work between two barriers. Chunk c + 1's
  // new rows are copied during iteration c, into the slots of rows above
  // chunk c's window, which only the H pass of chunk c - 1 read.
  const int chunks = (y_end - y_begin + kRun - 1) / kRun;
  const int mid_floats = kRun * 3 * mid_pitch;
  copy_rows(max(y_begin - R, 0), need_hi(y_begin));
  copy_commit();
  fill_table(y_begin, rows_s);
  int have = need_hi(y_begin);
  for (int c = 0; c <= chunks; ++c) {
    const int c0 = y_begin + c * kRun;
    copy_wait_all();
    __syncthreads();  // chunk c's rows and row table are in; iteration c - 1 is done
    if (c + 1 < chunks) {
      const int next = need_hi(c0 + kRun);
      copy_rows(have, next);
      copy_commit();
      have = next;
      fill_table(c0 + kRun, rows_s + ((c + 1) & 1) * win);
    }
    if (c > 0) {
      const int w_items = min(kRun, y_end - c0 + kRun) * runs;
      for (int it = threadIdx.x; it < w_items; it += kThreads)
        w_item(c0 - kRun, mid + ((c - 1) & 1) * mid_floats, it);
    }
    if (c < chunks) {
      const int* table = rows_s + (c & 1) * win;
      if constexpr (kFixed) {
#pragma unroll
        for (int j = 0; j < kRun + 2 * R_; ++j) rowoff[j] = table[j];
      }
      float* buf = mid + (c & 1) * mid_floats;
      // from the last thread down: the warps short of a W run take the
      // extra columns
      for (int e = kThreads - 1 - threadIdx.x; e < w3; e += kThreads) h_item(buf, table, e);
    }
  }
}

template <typename T, int R_>
int launch(const T* img, const float* weights, T* out, int b, int h, int w, int radius, int bands,
           int band_rows, int slots, int slot_pitch, int mid_pitch, int packed, cudaStream_t st) {
  const size_t smem = smem_bytes(radius, slots, slot_pitch, mid_pitch);
  cudaError_t err = cudaFuncSetAttribute(
      blur_rows<T, R_>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  blur_rows<T, R_><<<b * bands, kThreads, smem, st>>>(img, weights, out, h, w, radius, bands,
                                                     band_rows, slots, slot_pitch, mid_pitch,
                                                     packed);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* img, const float* weights, void* out, int b, int h, int w, int radius,
             int fixed, int bands, int band_rows, int slots, int slot_pitch, int mid_pitch,
             int packed, cudaStream_t st) {
  const T* x = static_cast<const T*>(img);
  T* y = static_cast<T*>(out);
  if (fixed)
    return launch<T, kFixedRadius>(x, weights, y, b, h, w, radius, bands, band_rows, slots,
                                   slot_pitch, mid_pitch, packed, st);
  return launch<T, 0>(x, weights, y, b, h, w, radius, bands, band_rows, slots, slot_pitch,
                      mid_pitch, packed, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. fixed = 1 takes blur_rows<T, 11>
// (radius must be 11), 0 the run-time radius. The plan's fields are checked
// here too: a plan that does not cover the image, a ring too small for a
// chunk and the next one's rows, a mid plane too narrow for the padded row,
// packed stores the output cannot take, or shared memory past the limit is
// refused with cudaErrorInvalidValue. Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int moco_gaussian_blur(const void* img, int dtype, const float* weights, void* out,
                                  int b, int h, int w, int radius, int fixed, int bands,
                                  int band_rows, int slots, int slot_pitch, int mid_pitch,
                                  int packed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (elem == 0 || b <= 0 || h <= 0 || w <= 0 || radius < 0) return (int)cudaErrorInvalidValue;
  if (fixed && radius != kFixedRadius) return (int)cudaErrorInvalidValue;
  if (bands <= 0 || band_rows <= 0 || (int64_t)bands * band_rows < h ||
      (int64_t)(bands - 1) * band_rows >= h || (int64_t)b * bands > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int64_t row_bytes = (int64_t)w * 3 * elem;
  if (slots < 2 * kRun + 2 * radius || slot_pitch % 16 ||
      slot_pitch < (row_bytes + 15) / 16 * 16 + 16 || mid_pitch < skew(w + 2 * radius + kRun - 1) + 1)
    return (int)cudaErrorInvalidValue;
  if (packed && ((uintptr_t)out % 16 || row_bytes % 16)) return (int)cudaErrorInvalidValue;
  if (smem_bytes(radius, slots, slot_pitch, mid_pitch) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(img, weights, out, b, h, w, radius, fixed, bands, band_rows, slots,
                           slot_pitch, mid_pitch, packed, st);
  return dispatch<__nv_bfloat16>(img, weights, out, b, h, w, radius, fixed, bands, band_rows,
                                 slots, slot_pitch, mid_pitch, packed, st);
}
