// Weight gradient of the fused BN->ReLU->3x3 conv in bf16, for Hopper
// (sm_90a), bound to Python through ctypes by
// moco_tpu_torch/ops/fused_conv3x3.py (`conv3x3_dw`, whose plan
// `conv3x3_dw_plan` chooses the band rows, the slabs and the shared memory).
//
// Replaces the Pallas TPU kernel conv3x3_dw
// (moco_tpu/ops/pallas_fused_conv3x3.py:371, pallas_call :412, body
// _dw3x3_kernel :118).
//
// Work: dW[3, 3, K, N] (f32) = sum over output pixels p of
// z_tap[p, K]^T dy[p, N], x [B, H, W, K] and dy [B, H, W, N] NHWC bf16,
// z = relu(x*a + b) rounded to bf16 and z_tap its (di, dj)-shifted view
// under the conv's zero padding (applied to z, not x).
//
// Bound: 2*B*H*W*9*K*N operations on the bf16 tensor cores against one read
// of x and dy; at the ResNet-50 batch-256 shapes the operations bound it
// (layer 1 about evenly with the bytes).
//
// Design. The TPU kernel normalizes one haloed row-block once and builds
// all nine shifted views from it; this kernel does the same per block:
// - A band is R output rows of one image. The block copies its x rows
//   (R + 2, with the row above and below) and its dy rows into shared
//   memory with cp.async, then normalizes x in place into z, writing 0 at
//   every pixel outside the image: the padded band holds (R + 2) x (W + 2)
//   pixels of 64 channels, 72 bf16 apart, so that the 8 rows of an
//   ldmatrix fall in 8 distinct bank groups.
// - The product runs over padded output pixels q = r*(W + 2) + c with dy
//   0 for c >= W, so tap (di, dj) of pixel q is z pixel
//   q + (1 + di)*(W + 2) + (1 + dj): one constant offset per tap, read
//   straight from the band by ldmatrix.trans with per-lane row addresses.
//   The extra work is (W + 2)/W.
// - A block of 12 warps owns a 64 x 64 tile of dW for all nine taps. Warp
//   w holds tap row di = w / 4 (its three dj) for a 32 x 32 quarter of the
//   tile: 3 x 2 x 4 mma.sync.m16n8k16 fragments, 96 f32 accumulators a
//   thread, and per 16 pixels 6 ldmatrix.x4 of z and 2 of dy (the dy
//   fragments serve all three dj).
// - The block walks the bands of one slab through three stages: band i + 2's
//   copies fly and band i + 1 is normalized (no barrier between the two
//   phases, so some warps normalize while others multiply) while band i
//   multiplies. Slab s writes partial s of [9, K, N]; a second pass sums
//   the slabs in slab order, so two runs give the same bits. No float
//   atomics.
// - K and N beyond the last whole tile are masked: z and dy are 0 there and
//   the epilogue stores only what lies inside. 16-byte copies need K and N
//   multiples of 8 and 16-byte aligned x and dy; otherwise 2-byte loads.

#include "band_mma.cuh"
#include "implicit_gemm.cuh"

#include <limits.h>

namespace {

using moco_gemm::Pack;
using namespace moco_band;

constexpr int kTile = 64;                // dW tile: kTile input x kTile output channels
constexpr int kPitch = kTile + 8;        // bf16 per pixel row in shared memory
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;               // bands in shared memory at once
constexpr int kSmemLimit = 232448;       // bytes a block may use on sm_90

struct BandGeom {
  int h, w, k, n;
  int rows;            // output rows per band
  int q_pad;           // contracted (padded) pixels per band, a multiple of 16
  int z_pix;           // z pixels per stage
  int tiles_n, tiles;  // dW tiles along N, and in all
  int bands_per_img, slabs;
  int64_t bands;
};

// Start the copies of one band's x rows (image rows row0 - 1 .. row0 + R,
// into band rows 0 .. R + 1, columns 1 .. W) and dy rows (row0 .. row0 + R - 1,
// at q = r*(W + 2) + c) into one stage. dy rows past the image are written
// as zeros; everything else outside the image is left for `normalize` (z)
// or was zeroed once at the start (dy columns c >= W, pixels past the band,
// channels past K or N). kThreads is a multiple of kTile / VEC, so each
// thread keeps one channel vector v and walks every (kThreads / CV)-th pixel.
template <int VEC>
__device__ __forceinline__ void load_band(const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ dy,
                                          const BandGeom& g, int img, int row0, int k0,
                                          int n0, __nv_bfloat16* sz, __nv_bfloat16* sd) {
  constexpr int CV = kTile / VEC;
  constexpr int DP = kThreads / CV;
  static_assert(kThreads % CV == 0, "a thread keeps one channel vector");
  const int wp = g.w + 2;
  const int v = threadIdx.x % CV;
  const int k = k0 + v * VEC;
  if (k < g.k) {
    const __nv_bfloat16* src = x + ((int64_t)img * g.h * g.w) * g.k + k;
    PixelWalk at(threadIdx.x / CV, DP, g.w);
    for (; at.j < g.rows + 2; at.step()) {
      const int ir = row0 - 1 + at.j;
      if (ir >= 0 && ir < g.h)
        copy_in<VEC>(sz + (at.j * wp + at.c + 1) * kPitch + v * VEC,
                     src + ((int64_t)ir * g.w + at.c) * g.k);
    }
  }
  const int n = n0 + v * VEC;
  if (n < g.n) {
    const __nv_bfloat16* src = dy + ((int64_t)img * g.h * g.w) * g.n + n;
    PixelWalk at(threadIdx.x / CV, DP, g.w);
    for (; at.j < g.rows; at.step()) {
      const int orow = row0 + at.j;
      __nv_bfloat16* dst = sd + (at.j * wp + at.c) * kPitch + v * VEC;
      if (orow < g.h) {
        copy_in<VEC>(dst, src + ((int64_t)orow * g.w + at.c) * g.n);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[i] = __float2bfloat16(0.f);
      }
    }
  }
}

// z = relu(x*a + b) in place over the band's (R + 2) x (W + 2) pixels, 0
// outside the image: x*a + b rounded twice (no FMA contraction), then to
// bf16, as the plain version does. Channels past K hold 0 (never copied)
// and a = b = 0 there, so they stay 0. Each thread keeps one 8-channel
// vector and walks every (kThreads / 8)-th pixel.
__device__ __forceinline__ void normalize(const BandGeom& g, int row0, const float* s_a,
                                          const float* s_b, __nv_bfloat16* sz) {
  constexpr int DP = kThreads / (kTile / 8);
  const int wp = g.w + 2;
  const int v = threadIdx.x % (kTile / 8);
  float av[8], bv[8];
  *reinterpret_cast<float4*>(av) = reinterpret_cast<const float4*>(s_a + v * 8)[0];
  *reinterpret_cast<float4*>(av + 4) = reinterpret_cast<const float4*>(s_a + v * 8)[1];
  *reinterpret_cast<float4*>(bv) = reinterpret_cast<const float4*>(s_b + v * 8)[0];
  *reinterpret_cast<float4*>(bv + 4) = reinterpret_cast<const float4*>(s_b + v * 8)[1];
  PixelWalk at(threadIdx.x / (kTile / 8), DP, wp);
  for (; at.j < g.rows + 2; at.step()) {
    const int ir = row0 - 1 + at.j;
    Pack<__nv_bfloat16, 8>* ptr =
        reinterpret_cast<Pack<__nv_bfloat16, 8>*>(sz + (at.j * wp + at.c) * kPitch) + v;
    Pack<__nv_bfloat16, 8> val;
    if (ir >= 0 && ir < g.h && at.c >= 1 && at.c <= g.w) {
      val = *ptr;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = __fadd_rn(__fmul_rn(__bfloat162float(val.v[i]), av[i]), bv[i]);
        val.v[i] = __float2bfloat16(t > 0.f ? t : 0.f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) val.v[i] = __float2bfloat16(0.f);
    }
    *ptr = val;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_dw_bands(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ b, const __nv_bfloat16* __restrict__ dy,
                 float* __restrict__ part, BandGeom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_b = s_a + kTile;
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem + 2 * kTile * 4);
  const int stage_elems = (g.z_pix + g.q_pad) * kPitch;

  const int tile = blockIdx.x % g.tiles;
  const int slab = blockIdx.x / g.tiles;
  const int k0 = tile / g.tiles_n * kTile;
  const int n0 = tile % g.tiles_n * kTile;
  const int64_t band0 = slab * g.bands / g.slabs;
  const int64_t band1 = (slab + 1) * g.bands / g.slabs;

  // zero the stages once: the padding that no copy ever writes stays 0
  {
    uint4* s = reinterpret_cast<uint4*>(stages);
    const int n16 = kStages * stage_elems * 2 / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) s[i] = make_uint4(0, 0, 0, 0);
    for (int c = threadIdx.x; c < kTile; c += kThreads) {
      const bool in = k0 + c < g.k;
      s_a[c] = in ? a[k0 + c] : 0.f;
      s_b[c] = in ? b[k0 + c] : 0.f;
    }
  }
  __syncthreads();

  // this warp's share: tap row di, K quarter kb, N quarter nb
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int di = warp / 4;
  const int kb = (warp % 4) / 2 * 32;
  const int nb = (warp % 2) * 32;
  const int mat = lane / 8, r8 = lane % 8;
  const int wp = g.w + 2;
  // byte offsets of this lane's ldmatrix row at pixel 0 of a stage: z for
  // tap (di, dj) and K sub-tile mt (matrices: q 0-7 / 8-15 by mat / 2, K
  // +0 / +8 by mat % 2); dy for N sub-tile pair np (q by mat % 2, N +0 / +8
  // by mat / 2)
  uint32_t a_off[3][2], b_off[2];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      a_off[dj][mt] =
          ((di * wp + dj + r8 + (mat / 2) * 8) * kPitch + kb + mt * 16 + (mat % 2) * 8) * 2;
#pragma unroll
  for (int np = 0; np < 2; ++np)
    b_off[np] = ((g.z_pix + r8 + (mat % 2) * 8) * kPitch + nb + np * 16 + (mat / 2) * 8) * 2;

  float acc[3][2][4][4];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[dj][mt][nt][i] = 0.f;

  // band i uses stage (i - band0) % kStages: copies start two bands ahead,
  // and band i + 1 is normalized while band i multiplies
  auto stage_of = [&](int64_t band) {
    return stages + (int)((band - band0) % kStages) * stage_elems;
  };
  auto first_row = [&](int64_t band) { return (int)(band % g.bands_per_img) * g.rows; };
  auto start_copies = [&](int64_t band) {
    if (band < band1) {
      __nv_bfloat16* sz = stage_of(band);
      load_band<VEC>(x, dy, g, (int)(band / g.bands_per_img), first_row(band), k0, n0, sz,
                     sz + g.z_pix * kPitch);
    }
    copy_commit();  // a group per band, empty past the slab, so the waits count bands
  };
  start_copies(band0);
  start_copies(band0 + 1);
  copy_wait_all_but_one();  // band0 has landed
  __syncthreads();
  if (band0 < band1) normalize(g, first_row(band0), s_a, s_b, stage_of(band0));
  __syncthreads();

  for (int64_t band = band0; band < band1; ++band) {
    // the stage of band + 2 was last read by the product of band - 1
    start_copies(band + 2);
    copy_wait_all_but_one();  // band + 1 has landed
    __syncthreads();
    if (band + 1 < band1)  // no barrier between: other warps multiply meanwhile
      normalize(g, first_row(band + 1), s_a, s_b, stage_of(band + 1));

    const uint32_t base = smem_addr(stage_of(band));
    for (int q0 = 0; q0 < g.q_pad; q0 += 16) {
      const uint32_t step = base + q0 * kPitch * 2;
      uint32_t bf[4][2];
      ldmatrix_x4_trans(step + b_off[0], bf[0][0], bf[0][1], bf[1][0], bf[1][1]);
      ldmatrix_x4_trans(step + b_off[1], bf[2][0], bf[2][1], bf[3][0], bf[3][1]);
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t af[4];
          ldmatrix_x4_trans(step + a_off[dj][mt], af[0], af[1], af[2], af[3]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[dj][mt][nt], af, bf[nt][0], bf[nt][1]);
        }
    }
    __syncthreads();  // band + 1 is normalized; this stage may be refilled
  }

  // accumulator (mt, nt): rows k (g, g + 8), columns n (2t, 2t + 1)
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    float* out = part + ((int64_t)slab * 9 + di * 3 + dj) * g.k * g.n;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = k0 + kb + mt * 16 + gq + half * 8;
          const int n = n0 + nb + nt * 8 + tq * 2;
          if (k >= g.k) continue;
          const float v0 = acc[dj][mt][nt][half * 2], v1 = acc[dj][mt][nt][half * 2 + 1];
          float* dst = out + (int64_t)k * g.n + n;
          if (n + 1 < g.n && g.n % 2 == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (n < g.n) dst[0] = v0;
            if (n + 1 < g.n) dst[1] = v1;
          }
        }
  }
}

// out[i] = sum over slabs s of part[s * total + i], in slab order
__global__ void __launch_bounds__(256)
sum_slabs(const float* __restrict__ part, int slabs, int64_t total, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sl = 0; sl < slabs; ++sl) s += part[(int64_t)sl * total + i];
  out[i] = s;
}

template <int VEC>
cudaError_t launch_bands(const __nv_bfloat16* x, const float* a, const float* b,
                         const __nv_bfloat16* dy, float* dst, const BandGeom& g, int smem,
                         cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_dw_bands<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv3x3_dw_bands<VEC><<<(unsigned)(g.tiles * g.slabs), kThreads, smem, st>>>(x, a, b, dy,
                                                                              dst, g);
  return cudaGetLastError();
}

}  // namespace

// dW[3, 3, K, N] (f32) of relu(x*a + b) conv W (stride 1, zero pad 1) against
// dy, x and dy bf16 NHWC. rows, slabs and smem_bytes come from the plan
// (ops/fused_conv3x3.py: conv3x3_dw_plan); smem_bytes must be what these
// rows need. part: f32 [slabs, 9, K, N] scratch (unused when slabs == 1).
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int moco_conv3x3_dw_bf16(const void* x, const float* a, const float* b,
                                    const void* dy, float* part, float* out, int bsz, int h,
                                    int wd, int k, int n, int rows, int slabs, int smem_bytes,
                                    void* stream) {
  if (bsz <= 0 || h <= 0 || wd <= 0 || k <= 0 || n <= 0 || rows <= 0 || rows > h ||
      slabs <= 0)
    return (int)cudaErrorInvalidValue;
  BandGeom g;
  g.h = h;
  g.w = wd;
  g.k = k;
  g.n = n;
  g.rows = rows;
  g.q_pad = (rows * (wd + 2) + 15) / 16 * 16;
  g.z_pix = g.q_pad + 2 * (wd + 2) + 2;
  g.tiles_n = (n + kTile - 1) / kTile;
  g.tiles = ((k + kTile - 1) / kTile) * g.tiles_n;
  g.bands_per_img = (h + rows - 1) / rows;
  g.slabs = slabs;
  g.bands = (int64_t)bsz * g.bands_per_img;
  const int64_t smem = 2 * kTile * 4 + kStages * ((int64_t)g.z_pix + g.q_pad) * kPitch * 2;
  if (smem != smem_bytes || smem > kSmemLimit || slabs > g.bands ||
      (int64_t)g.tiles * slabs > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = slabs == 1 ? out : part;  // one slab writes the output directly
  const auto* xt = static_cast<const __nv_bfloat16*>(x);
  const auto* dyt = static_cast<const __nv_bfloat16*>(dy);
  const bool wide = k % 8 == 0 && n % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)dy % 16 == 0;
  cudaError_t err = wide ? launch_bands<8>(xt, a, b, dyt, dst, g, smem_bytes, st)
                         : launch_bands<1>(xt, a, b, dyt, dst, g, smem_bytes, st);
  if (err != cudaSuccess || slabs == 1) return (int)err;
  const int64_t total = (int64_t)9 * k * n;
  sum_slabs<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, slabs, total, out);
  return (int)cudaGetLastError();
}
