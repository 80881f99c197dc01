// Per-sample separable Gaussian blur for Hopper (sm_90a), bound to Python
// through ctypes by moco_tpu_torch/ops/blur.py.
//
// Replaces the Pallas TPU kernel moco_tpu/ops/pallas_blur.py
// gaussian_blur_batch (:56, body _blur_kernel :37, pallas_call :77).
//
// Work: images [B, H, W, 3] (NHWC, bf16 or f32), taps [B, 2R+1] f32 per
// sample; out[b] = image[b] blurred first along H, then along W, with the
// image's edge pixels repeated beyond its border; f32 accumulation, output
// in the input dtype. A sample that skips the blur carries one-hot taps and
// goes through the same code.
//
// Bound: one read of the images and one write of the result,
// 2*B*H*W*3*bytes (154 MB for the MoCo-v2 batch of 256 bf16 224x224 views,
// ~0.05 ms at 3.35 TB/s), against 2*(2R+1) multiply-adds per output value
// (R = 11 at 224 px) on the f32 units, which is about as long.
//
// Design: the TPU kernel edge-pads the whole image in HBM, keeps it in VMEM
// and transposes it there so that both passes shift along sublanes. Here one
// block owns a 32x32 output tile of one sample. It loads the tile plus its
// R-pixel halo into shared memory as f32, clamping the source coordinates
// (that clamp is the edge padding, with no padded copy in device memory),
// runs the H pass over the halo's full width into a second shared buffer,
// then the W pass, and writes the tile. Loads and stores walk NHWC rows, so
// neighbouring threads touch neighbouring addresses. The halo is re-read by
// the neighbouring tiles from L2, not from device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // output tile edge (pixels)
constexpr int kThreads = 256;  // threads per block
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Shared layout, in floats: taps (rounded up to 4), the haloed input tile
// [kTile + 2R][kTile + 2R][3], the H-pass result [kTile][kTile + 2R][3].
size_t smem_bytes(int radius) {
  const size_t taps = (2 * radius + 1 + 3) / 4 * 4;
  const size_t pw = kTile + 2 * radius;
  return (taps + (pw * pw + kTile * pw) * 3) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
blur_tile(const T* __restrict__ img, const float* __restrict__ weights,
          T* __restrict__ out, int h, int w, int radius) {
  extern __shared__ float smem[];
  const int taps = 2 * radius + 1;
  const int pw = kTile + 2 * radius;  // haloed tile edge
  const int row3 = pw * 3;            // floats in one haloed row
  float* w_s = smem;
  float* in_s = smem + (taps + 3) / 4 * 4;
  float* mid_s = in_s + pw * row3;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const T* src = img + (int64_t)b * h * w * 3;
  T* dst = out + (int64_t)b * h * w * 3;

  for (int i = threadIdx.x; i < taps; i += blockDim.x) w_s[i] = weights[(int64_t)b * taps + i];
  for (int i = threadIdx.x; i < pw * row3; i += blockDim.x) {
    const int r = i / row3;
    const int rem = i - r * row3;
    const int col = rem / 3;
    const int ch = rem - col * 3;
    const int gy = min(max(y0 - radius + r, 0), h - 1);
    const int gx = min(max(x0 - radius + col, 0), w - 1);
    in_s[i] = to_f32(src[((int64_t)gy * w + gx) * 3 + ch]);
  }
  __syncthreads();

  // H pass: mid[r][col][ch] = sum_j w[j] * in[r + j][col][ch]
  for (int i = threadIdx.x; i < kTile * row3; i += blockDim.x) {
    const int r = i / row3;
    const int rem = i - r * row3;
    const float* p = in_s + r * row3 + rem;
    float acc = 0.f;
    for (int j = 0; j < taps; ++j) acc += w_s[j] * p[j * row3];
    mid_s[i] = acc;
  }
  __syncthreads();

  // W pass: out[r][col][ch] = sum_j w[j] * mid[r][col + j][ch]
  for (int i = threadIdx.x; i < kTile * kTile * 3; i += blockDim.x) {
    const int r = i / (kTile * 3);
    const int rem = i - r * (kTile * 3);
    const int col = rem / 3;
    const int ch = rem - col * 3;
    const int gy = y0 + r;
    const int gx = x0 + col;
    if (gy < h && gx < w) {
      const float* p = mid_s + r * row3 + col * 3 + ch;
      float acc = 0.f;
      for (int j = 0; j < taps; ++j) acc += w_s[j] * p[j * 3];
      dst[((int64_t)gy * w + gx) * 3 + ch] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(const T* img, const float* weights, T* out, int b, int h, int w, int radius,
           cudaStream_t st) {
  const size_t smem = smem_bytes(radius);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      blur_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  blur_tile<T><<<grid, kThreads, smem, st>>>(img, weights, out, h, w, radius);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest radius the shared-memory tile holds (the wrapper checks against it).
extern "C" int moco_blur_max_radius() {
  int r = 0;
  while (smem_bytes(r + 1) <= (size_t)kMaxSmem) ++r;
  return r;
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int moco_gaussian_blur(const void* img, int dtype, const float* weights,
                                  void* out, int b, int h, int w, int radius,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || w <= 0 || radius < 0 || b > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch(static_cast<const float*>(img), weights, static_cast<float*>(out), b, h,
                  w, radius, st);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(img), weights,
                  static_cast<__nv_bfloat16*>(out), b, h, w, radius, st);
  return (int)cudaErrorInvalidValue;
}
