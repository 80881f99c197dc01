// BatchNorm-normalize -> ReLU fused into a 3x3 conv (zero pad 1, stride 1
// or 2) in bf16, for Hopper (sm_90a), bound to Python through ctypes by
// moco_tpu_torch/ops/fused_conv3x3.py (`bn_relu_conv3x3` and
// `bn_relu_conv3x3_s2`, whose plan `conv3x3_fwd_plan` chooses the tile, the
// K-chunk depth, the band rows and the shared memory).
//
// Replaces two Pallas TPU kernels:
//   bn_relu_conv3x3     moco_tpu/ops/pallas_fused_conv3x3.py:199 (pallas_call :237,
//                       body _conv3x3_kernel :47)
//   bn_relu_conv3x3_s2  moco_tpu/ops/pallas_fused_conv3x3.py:318 (pallas_call :351,
//                       body _conv3x3s2_kernel :256)
//
// Work: y[B, Ho, Wo, N] = relu(x*a + b) conv W[3, 3, K, N], x NHWC bf16,
// z = relu(x*a + b) rounded to bf16, zero padding 1 applied to z (not x); at
// stride 2 output row r reads input rows 2r - 1, 2r, 2r + 1 (and likewise
// columns). f32 accumulation, bf16 or f32 out.
//
// Bound: 2*M*9*K*N operations on the bf16 tensor cores against one read of
// x and W and one write of y; at the ResNet-50 batch-256 shapes the
// operations bound it (layer 1 about evenly with the bytes).
//
// Design. The TPU kernels normalize one haloed row-block once and build all
// nine shifted views from it; this kernel does the same per block:
// - A block owns BM consecutive output pixels (the M tile, in image-major
//   order, so it may pack several small images) and BN output channels:
//   BM x BN = 128 x 128, or 256 x 64 where N <= 64, over 8 warps of
//   64 x 32 each (64 f32 accumulators a thread).
// - The band of an M tile holds, per image it touches, the padded input
//   rows its output rows read (S*r_lo - 1 .. S*r_hi + 1), W + 2 pixels each,
//   BK channels (one K-chunk: 64, or 32 where a 64-deep band would keep a
//   second block off the SM) at a pitch of BK + 8 bf16 (144 or 80 bytes).
//   The block copies x into it with cp.async and normalizes it in place
//   once per K-chunk, writing 0 at every pixel outside the image.
// - Each M row (output pixel) has one base offset into the band, from a
//   table built once per block; tap (di, dj) adds a constant to it, so all
//   nine taps read the same band through ldmatrix (one row address per
//   lane). No output pixel is padded.
// - Stride 2: a band row stores its even padded columns first, then its odd
//   ones. Consecutive output pixels of a row then read consecutive pixels of
//   one half at every tap, so the 8 rows of an ldmatrix phase fall in 8
//   distinct 16-byte bank groups (pitch 9 or 5 x 16 bytes); without the
//   split they would be 2 pixels apart and share 4 groups (a 2-way
//   conflict).
// - W[tap][k0:k0+BK, n0:n0+BN] moves through two shared-memory stages with
//   cp.async: tap t + 1's tile lands while tap t multiplies (ldmatrix.trans
//   into mma.sync.m16n8k16). One band stage: the next K-chunk's band is
//   copied after this chunk's last tap, while the SM's other block
//   multiplies (a second band stage, copied during the taps, measured
//   slower: it halves the blocks per SM, and at equal blocks its per-tap
//   waits cost more than they hide).
// - The epilogue stages each warp's accumulators through shared memory and
//   stores 16 bytes at a time where N and y allow. Every output is written
//   once by one block: no partials, no atomics, the same bits every run.
// - K and N beyond the last whole chunk or tile are masked: z and W are 0
//   there and the epilogue stores only what lies inside. 16-byte copies
//   need K and N multiples of 8 and 16-byte aligned x and W; otherwise
//   2-byte loads.

#include "band_mma.cuh"
#include "implicit_gemm.cuh"

#include <limits.h>

namespace {

using moco_gemm::Pack;
using moco_gemm::store_out;
using namespace moco_band;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWStages = 2;             // W tiles in shared memory at once
constexpr int kStagePitch = 36;         // f32 per row of a warp's 16 x 32 epilogue staging
constexpr int kStagingBytes = kWarps * 16 * kStagePitch * 4;
constexpr int kSmemLimit = 232448;      // bytes a block may use on sm_90

struct FwdGeom {
  int stride;
  int h, w, k, n;
  int ho, wo, hw;    // output grid, hw = ho*wo
  int wp, half;      // pixels per band row (w + 2); stride 2: first odd-column slot
  int kc;            // K-chunks
  int tiles_n;
  int band_rows;     // rows of the band
  int64_t m;         // output pixels, B*ho*wo
};

// The input rows an M tile reads: its first image's segment (rows0 band
// rows from image row S*rlo0 - 1), then `full` rows per later image (from
// image row -1); `rows` in all.
struct TileSpan {
  int64_t p0, p1;  // first and last output pixel
  int img0, rlo0, rows0, full, rows;
};

__host__ __device__ inline TileSpan tile_span(const FwdGeom& g, int64_t tile, int bm) {
  TileSpan t;
  const int s = g.stride;
  t.p0 = tile * bm;
  t.p1 = (t.p0 + bm < g.m ? t.p0 + bm : g.m) - 1;
  t.img0 = (int)(t.p0 / g.hw);
  const int img1 = (int)(t.p1 / g.hw);
  t.rlo0 = (int)(t.p0 - (int64_t)t.img0 * g.hw) / g.wo;
  const int rhi1 = (int)(t.p1 - (int64_t)img1 * g.hw) / g.wo;
  t.full = s * (g.ho - 1) + 3;
  if (img1 == t.img0) {
    t.rows0 = s * (rhi1 - t.rlo0) + 3;
    t.rows = t.rows0;
  } else {
    t.rows0 = s * (g.ho - 1 - t.rlo0) + 3;
    t.rows = t.rows0 + (img1 - t.img0 - 1) * t.full + s * rhi1 + 3;
  }
  return t;
}

// The band rows the largest M tile needs. A tile's span depends only on its
// first pixel's place in its image, so the first hw / gcd(bm, hw) tiles
// cover every span (and the last tile where there are fewer).
int band_rows_needed(const FwdGeom& g, int bm) {
  int64_t a = bm, b = g.hw;
  while (b) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  const int64_t tiles = (g.m + bm - 1) / bm;
  const int64_t period = g.hw / a;
  int rows = 0;
  for (int64_t t = 0; t < (tiles < period ? tiles : period); ++t) {
    const int r = tile_span(g, t, bm).rows;
    rows = r > rows ? r : rows;
  }
  return rows;
}

int64_t smem_needed(const FwdGeom& g, int bn, int bm, int bk) {
  const int64_t band = (int64_t)g.band_rows * g.wp * (bk + 8) * 2;
  const int64_t w = (int64_t)kWStages * bk * (bn + 8) * 2;
  int64_t region = band + w;
  if (region < kStagingBytes) region = kStagingBytes;
  return region + 4 * ((int64_t)g.band_rows + bm);
}

// Start the copies of one K-chunk's band (channels k0 .. k0+BK-1 of the
// in-image pixels of band rows 0 .. rows-1) into sz. Padding pixels and
// channels past K are left for `normalize`. Each thread keeps one
// 8-channel vector and walks every (kThreads / (BK / 8))-th pixel.
template <int S, int VEC, int BK>
__device__ __forceinline__ void copy_band(const __nv_bfloat16* __restrict__ x, const FwdGeom& g,
                                          const int* s_row, int rows, int k0,
                                          __nv_bfloat16* sz) {
  constexpr int CV = BK / 8, DP = kThreads / CV;
  const int v = threadIdx.x % CV;
  const int k = k0 + v * 8;
  if (k >= g.k) return;
  PixelWalk at(threadIdx.x / CV, DP, g.w);
  for (; at.j < rows; at.step()) {
    const int src_row = s_row[at.j];
    if (src_row < 0) continue;
    // padded column c + 1; stride 2 keeps even padded columns first
    const int slot = S == 1 ? at.c + 1 : ((at.c & 1) ? (at.c + 1) / 2 : g.half + at.c / 2);
    __nv_bfloat16* dst = sz + (at.j * g.wp + slot) * (BK + 8) + v * 8;
    const __nv_bfloat16* src = x + ((int64_t)src_row * g.w + at.c) * g.k + k;
    if constexpr (VEC == 8) {
      copy_in<8>(dst, src);
    } else {
#pragma unroll 1
      for (int e = 0; e < 8 && k + e < g.k; ++e) dst[e] = src[e];
    }
  }
}

// z = relu(x*a + b) in place over the band's rows x (W + 2) pixels: x*a + b
// rounded twice (no FMA contraction), then to bf16, as the plain version
// does; 0 at padding pixels (rows outside the image, padded columns 0 and
// W + 1) and at channels past K.
template <int S, int BK>
__device__ __forceinline__ void normalize(const FwdGeom& g, const int* s_row, int rows, int k0,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b, __nv_bfloat16* sz) {
  constexpr int CV = BK / 8, DP = kThreads / CV;
  const int v = threadIdx.x % CV;
  const int kv = g.k - (k0 + v * 8);  // channels of this vector inside K
  float av[8], bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    av[i] = i < kv ? __ldg(a + k0 + v * 8 + i) : 0.f;
    bv[i] = i < kv ? __ldg(b + k0 + v * 8 + i) : 0.f;
  }
  PixelWalk at(threadIdx.x / CV, DP, g.wp);
  for (; at.j < rows; at.step()) {
    const int pc = S == 1 ? at.c : (at.c < g.half ? 2 * at.c : 2 * (at.c - g.half) + 1);
    Pack<__nv_bfloat16, 8>* ptr =
        reinterpret_cast<Pack<__nv_bfloat16, 8>*>(sz + (at.j * g.wp + at.c) * (BK + 8)) + v;
    Pack<__nv_bfloat16, 8> val;
    if (s_row[at.j] >= 0 && pc >= 1 && pc <= g.w) {
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

// W[tap][k0 .. k0+BK-1, n0 .. n0+BN-1] into a stage of pitch BN + 8, 0
// past K or N.
template <int VEC, int BN, int BK>
__device__ __forceinline__ void load_w_tile(const __nv_bfloat16* __restrict__ wt,
                                            const FwdGeom& g, int k0, int n0,
                                            __nv_bfloat16* dst) {
  constexpr int CV = BN / 8;
  constexpr int RS = kThreads / CV;
  const int v = threadIdx.x % CV;
  const int n = n0 + v * 8;
  for (int r = threadIdx.x / CV; r < BK; r += RS) {
    const int k = k0 + r;
    __nv_bfloat16* d = dst + r * (BN + 8) + v * 8;
    const __nv_bfloat16* s = wt + (int64_t)k * g.n + n;
    if constexpr (VEC == 8) {
      if (k < g.k && n < g.n)
        copy_in<8>(d, s);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll 1
      for (int e = 0; e < 8; ++e) d[e] = k < g.k && n + e < g.n ? s[e] : __float2bfloat16(0.f);
    }
  }
}

template <int S, int VEC, int BN, int BK>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_fwd_bands(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const __nv_bfloat16* __restrict__ w,
                  void* __restrict__ y, int out_bf16, int out_wide, FwdGeom g) {
  constexpr int WN = BN / 32, WM = kWarps / WN, BM = 64 * WM;
  constexpr int PITCH = BK + 8;  // bf16 per band pixel
  constexpr int LDW = BN + 8;
  constexpr int W_ELEMS = BK * LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int band_elems = g.band_rows * g.wp * PITCH;
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wst = zs + band_elems;
  int region = (band_elems + kWStages * W_ELEMS) * 2;
  region = region > kStagingBytes ? region : kStagingBytes;
  int* s_row = reinterpret_cast<int*>(smem + region);  // band row -> image row b*H + ir, or -1
  int* s_base = s_row + g.band_rows;                    // M row -> its band pixel at tap (0, 0)

  const int64_t tile = blockIdx.x / g.tiles_n;
  const int n0 = (int)(blockIdx.x % g.tiles_n) * BN;
  const TileSpan sp = tile_span(g, tile, BM);
  for (int j = threadIdx.x; j < sp.rows; j += kThreads) {
    int img, ir;
    if (j < sp.rows0) {
      img = sp.img0;
      ir = S * sp.rlo0 - 1 + j;
    } else {
      const int jj = j - sp.rows0;
      img = sp.img0 + 1 + jj / sp.full;
      ir = jj % sp.full - 1;
    }
    s_row[j] = ir >= 0 && ir < g.h ? img * g.h + ir : -1;
  }
  for (int m = threadIdx.x; m < BM; m += kThreads) {
    // rows past the last pixel repeat it; the epilogue stores none of them
    const int64_t p = sp.p0 + m < sp.p1 ? sp.p0 + m : sp.p1;
    const int img = (int)(p / g.hw);
    const int rem = (int)(p - (int64_t)img * g.hw);
    const int r = rem / g.wo, c = rem - r * g.wo;
    const int seg = img == sp.img0 ? 0 : sp.rows0 + (img - sp.img0 - 1) * sp.full;
    const int rlo = img == sp.img0 ? sp.rlo0 : 0;
    s_base[m] = (seg + S * (r - rlo) + 1) * g.wp + (S == 1 ? c + 1 : g.half + c);
  }
  __syncthreads();

  // this warp's 64 x 32 share of the tile, and its lanes' ldmatrix rows: A
  // (pixels) by mat % 2 (rows +0 / +8) and mat / 2 (K +0 / +8); W (k rows
  // by mat % 2, N +0 / +8 by mat / 2)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int mat = lane / 8, r8 = lane % 8;
  const int* a_base = s_base + wm * 64 + (mat % 2) * 8 + r8;  // + mt * 16
  const uint32_t a_koff = (mat / 2) * 16;
  const uint32_t b_off = ((r8 + (mat % 2) * 8) * LDW + wn * 32 + (mat / 2) * 8) * 2;

  auto load_w = [&](int idx) {  // W tile idx: K-chunk idx / 9, tap idx % 9
    const int c = idx / 9, tap = idx - c * 9;
    load_w_tile<VEC, BN, BK>(w + (int64_t)tap * g.k * g.n, g, c * BK, n0,
                             wst + (idx % kWStages) * W_ELEMS);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  copy_band<S, VEC, BK>(x, g, s_row, sp.rows, 0, zs);
  load_w(0);
  copy_commit();
  const int last = g.kc * 9;
  for (int c = 0; c < g.kc; ++c) {
    if (c > 0) {
      __syncthreads();  // the previous chunk's taps have read the band
      copy_band<S, VEC, BK>(x, g, s_row, sp.rows, c * BK, zs);
      copy_commit();
    }
    copy_wait_all();  // this chunk's band and its first W tile have landed
    __syncthreads();
    normalize<S, BK>(g, s_row, sp.rows, c * BK, a, b, zs);
    __syncthreads();
    const uint32_t zbase = smem_addr(zs) + a_koff;
    for (int tap = 0; tap < 9; ++tap) {
      const int idx = c * 9 + tap;
      if (tap > 0) {
        copy_wait_all();  // W tile idx has landed ...
        __syncthreads();  // ... for every thread, and tile idx - 1 has been read
      }
      if (idx + 1 < last) load_w(idx + 1);
      copy_commit();

      const int di = tap / 3 - 1, dj = tap % 3 - 1;
      const int toff =
          di * g.wp + (S == 1 ? dj : (dj < 0 ? -g.half : (dj == 0 ? 0 : 1 - g.half)));
      uint32_t a_addr[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        a_addr[mt] = zbase + (uint32_t)((a_base[mt * 16] + toff) * PITCH * 2);
      const uint32_t wb = smem_addr(wst + (idx % kWStages) * W_ELEMS) + b_off;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t bf[4][2];
        ldmatrix_x4_trans(wb + kk * 16 * LDW * 2, bf[0][0], bf[0][1], bf[1][0], bf[1][1]);
        ldmatrix_x4_trans(wb + kk * 16 * LDW * 2 + 32, bf[2][0], bf[2][1], bf[3][0], bf[3][1]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t af[4];
          ldmatrix_x4(a_addr[mt] + kk * 32, af[0], af[1], af[2], af[3]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
        }
      }
    }
  }

  // accumulator (mt, nt): rows g, g + 8 of the 16, columns 2t, 2t + 1 of
  // the 8; each warp stages 16 x 32 at a time and stores rows of 8 values
  __syncthreads();  // every warp is done with the band: the staging overlays it
  float* stg = reinterpret_cast<float*>(smem) + warp * 16 * kStagePitch;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(stg + (gq + half * 8) * kStagePitch + nt * 8 + tq * 2) =
            make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
    __syncwarp();
#pragma unroll
    for (int q = lane; q < 64; q += 32) {
      const int row = q / 4, c8 = (q % 4) * 8;
      const int64_t p = sp.p0 + wm * 64 + mt * 16 + row;
      const int n = n0 + wn * 32 + c8;
      if (p <= sp.p1 && n < g.n)
        store_out<8>(y, out_bf16, out_wide, p * g.n + n, stg + row * kStagePitch + c8,
                     g.n - n < 8 ? g.n - n : 8);
    }
    __syncwarp();
  }
}

template <int S, int VEC, int BN, int BK>
cudaError_t launch(const __nv_bfloat16* x, const float* a, const float* b,
                   const __nv_bfloat16* w, void* y, int out_bf16, const FwdGeom& g, int smem,
                   cudaStream_t st) {
  constexpr int BM = 64 * (kWarps / (BN / 32));
  cudaError_t err = cudaFuncSetAttribute(conv3x3_fwd_bands<S, VEC, BN, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (g.m + BM - 1) / BM * g.tiles_n;
  conv3x3_fwd_bands<S, VEC, BN, BK><<<(unsigned)blocks, kThreads, smem, st>>>(
      x, a, b, w, y, out_bf16, moco_gemm::wide_stores(g.n, y), g);
  return cudaGetLastError();
}

// the tile (bn, bk) of stride S and load width VEC
template <int S, int VEC>
cudaError_t launch_tile(int bn, int bk, const __nv_bfloat16* x, const float* a, const float* b,
                        const __nv_bfloat16* w, void* y, int out_bf16, const FwdGeom& g,
                        int smem, cudaStream_t st) {
  if (bk == 64)
    return bn == 64 ? launch<S, VEC, 64, 64>(x, a, b, w, y, out_bf16, g, smem, st)
                    : launch<S, VEC, 128, 64>(x, a, b, w, y, out_bf16, g, smem, st);
  return bn == 64 ? launch<S, VEC, 64, 32>(x, a, b, w, y, out_bf16, g, smem, st)
                  : launch<S, VEC, 128, 32>(x, a, b, w, y, out_bf16, g, smem, st);
}

}  // namespace

// y[B, Ho, Wo, N] (bf16 if out_dtype == 1, f32 if 0) = relu(x*a + b) conv
// w[3, 3, K, N], zero pad 1, at stride 1 (Ho = H) or 2 (H and W even,
// Ho = H/2); x and w bf16. bn (64 or 128), bk (64 or 32), band_rows and
// smem_bytes come from the plan (ops/fused_conv3x3.py: conv3x3_fwd_plan):
// band_rows must be what the largest M tile needs and smem_bytes what
// those rows need. Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int moco_conv3x3_fwd_bf16(const void* x, const float* a, const float* b,
                                     const void* w, void* y, int out_dtype, int bsz, int h,
                                     int wd, int k, int n, int stride, int bn, int bk,
                                     int band_rows, int smem_bytes, void* stream) {
  if (bsz <= 0 || h <= 0 || wd <= 0 || k <= 0 || n <= 0 || (stride != 1 && stride != 2) ||
      (stride == 2 && (h % 2 != 0 || wd % 2 != 0)) || (out_dtype != 0 && out_dtype != 1) ||
      (bn != 64 && bn != 128) || (bk != 64 && bk != 32))
    return (int)cudaErrorInvalidValue;
  const int bm = 64 * (kWarps / (bn / 32));
  FwdGeom g;
  g.stride = stride;
  g.h = h;
  g.w = wd;
  g.k = k;
  g.n = n;
  g.ho = h / stride;
  g.wo = wd / stride;
  g.hw = g.ho * g.wo;
  g.wp = wd + 2;
  g.half = g.wp / 2;
  g.kc = (k + bk - 1) / bk;
  g.tiles_n = (n + bn - 1) / bn;
  g.m = (int64_t)bsz * g.hw;
  g.band_rows = band_rows;
  if (band_rows != band_rows_needed(g, bm)) return (int)cudaErrorInvalidValue;
  const int64_t smem = smem_needed(g, bn, bm, bk);
  if (smem != smem_bytes || smem > kSmemLimit ||
      (g.m + bm - 1) / bm * g.tiles_n > INT_MAX || (int64_t)bsz * h > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const __nv_bfloat16*>(x);
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  const bool wide = k % 8 == 0 && n % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
  cudaError_t err;
  if (stride == 1)
    err = wide ? launch_tile<1, 8>(bn, bk, xt, a, b, wt, y, out_dtype, g, smem_bytes, st)
               : launch_tile<1, 1>(bn, bk, xt, a, b, wt, y, out_dtype, g, smem_bytes, st);
  else
    err = wide ? launch_tile<2, 8>(bn, bk, xt, a, b, wt, y, out_dtype, g, smem_bytes, st)
               : launch_tile<2, 1>(bn, bk, xt, a, b, wt, y, out_dtype, g, smem_bytes, st);
  return (int)err;
}
