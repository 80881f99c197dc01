// BatchNorm-normalize -> ReLU fused into a 1x1 conv (a matmul over rows) in
// bf16, for Hopper (sm_90a), bound to Python through ctypes by
// moco_tpu_torch/ops/fused_conv.py (`bn_relu_matmul`, whose plan
// `matmul_fwd_plan` chooses the tile, the N span, the panel slots and the
// shared memory). The f32 route stays on fused_conv.cu.
//
// Replaces the Pallas TPU kernel bn_relu_matmul
// (moco_tpu/ops/pallas_fused_conv.py:121, pallas_call :137, body _kernel :36).
//
// Work: y[M, N] = relu(x[M, K]*a + b) @ W[K, N], x and W bf16, z =
// relu(x*a + b) rounded to bf16, f32 accumulation, bf16 or f32 out.
//
// Bound: one read of x and W and one write of y against 2*M*K*N operations
// on the bf16 tensor cores; at the ResNet-50 batch-256 shapes layers 1-3
// are bound by the bytes (layer 1: x 103 MB + y 411 MB) and layer 4 by the
// operations.
//
// Design. The TPU kernel normalizes an x tile in VMEM and feeds the MXU; a
// z tile there is reused across the whole N axis of its grid row. Here:
// - A block owns BM rows and a span of N tiles of BN columns: BM x BN =
//   128 x 128, or 256 x 64 where N <= 64, over 8 warps of 64 x 32 (64 f32
//   accumulators a thread).
// - Its x rows live in shared memory as a panel of 64-channel chunks at a
//   144-byte row pitch (the 8 rows of an ldmatrix phase fall in 8 distinct
//   bank groups). Each chunk is copied with cp.async and normalized in place
//   once; channels past K and rows past M hold 0. Where the whole panel
//   fits ("resident", every ResNet-50 shape), the block copies and
//   normalizes x once and sweeps its N tiles over it, so x is read
//   ceil(N / span) times in all; otherwise the chunks stream through three
//   slots and are copied again for every N tile.
// - The block walks steps (N tile, K-chunk). W[k0:k0+64, n0:n0+BN] moves
//   through a ring of three cp.async stages, read by ldmatrix.trans; the
//   panel by ldmatrix; both into mma.sync.m16n8k16. One block barrier per
//   step: after it, step s + 2's copies start, step s + 1's chunk is
//   normalized (when it is new) and step s multiplies, so the copies have a
//   step to land. (Four stages and two steps ahead ran no faster at layer 4
//   on an H100, and leave no room for the staging below.)
// - After an N tile's last chunk each warp stages its accumulators through
//   its own shared-memory tile and stores 16 bytes at a time where N and y
//   allow, with no block barrier: the stores drain while the next tile
//   multiplies. (Storing two outputs at a time straight from registers ran
//   1.7x slower at layer 1 on an H100, whose 411 MB output bounds it.) Every
//   output is written once by one block: no partials, no atomics, the same
//   bits every run.
// - K and N beyond the last whole chunk or tile are masked: z and W are 0
//   there and the epilogue stores only what lies inside. 16-byte copies
//   need K and N multiples of 8 and 16-byte aligned x and W; otherwise
//   2-byte loads.

#include "band_mma.cuh"
#include "implicit_gemm.cuh"

#include <limits.h>

namespace {

using moco_gemm::store_out;
using namespace moco_band;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;          // channels per panel chunk and W tile row count
constexpr int kPitch = kChunk + 8;  // bf16 per panel row: 144 bytes
constexpr int kWStages = 3;         // W tiles in shared memory at once
constexpr int kStagePitch = 36;     // f32 per row of a warp's 16 x 32 epilogue staging
constexpr int kStagingBytes = kWarps * 16 * kStagePitch * 4;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

struct FwdGeom {
  int64_t m;
  int k, n;
  int kc;          // K-chunks
  int slots;       // panel chunks in shared memory (kc or more: resident; else 3 or more)
  int span_tiles;  // N tiles per block
  int tiles_n;     // N tiles
  int spans;       // blocks per M tile, ceil(tiles_n / span_tiles)
};

int64_t smem_needed(int bn, int slots) {
  const int bm = 64 * (kWarps / (bn / 32));
  return (int64_t)slots * bm * kPitch * 2 + (int64_t)kWStages * kChunk * (bn + 8) * 2 +
         kStagingBytes;
}

// Start the copies of channels k0 .. k0+63 of rows m0 .. m0+BM-1 of x into a
// panel slot. Rows past M and channels past K are left for normalize_tile.
template <int VEC, int BM>
__device__ __forceinline__ void copy_chunk(const __nv_bfloat16* __restrict__ x,
                                           const FwdGeom& g, int64_t m0, int k0,
                                           __nv_bfloat16* dst) {
  constexpr int CV = kChunk / 8, RS = kThreads / CV;
  const int v = threadIdx.x % CV;
  const int k = k0 + v * 8;
  if (k >= g.k) return;
  const int rows = g.m - m0 < BM ? (int)(g.m - m0) : BM;
  for (int r = threadIdx.x / CV; r < rows; r += RS) {
    __nv_bfloat16* d = dst + r * kPitch + v * 8;
    const __nv_bfloat16* s = x + (m0 + r) * g.k + k;
    if constexpr (VEC == 8) {
      copy_in<8>(d, s);
    } else {
#pragma unroll 1
      for (int e = 0; e < 8 && k + e < g.k; ++e) d[e] = s[e];
    }
  }
}

// W[k0 .. k0+63, n0 .. n0+BN-1] into a stage of pitch BN + 8, 0 past K or N.
template <int VEC, int BN>
__device__ __forceinline__ void load_w_tile(const __nv_bfloat16* __restrict__ w,
                                            const FwdGeom& g, int k0, int n0,
                                            __nv_bfloat16* dst) {
  constexpr int CV = BN / 8, RS = kThreads / CV;
  const int v = threadIdx.x % CV;
  const int n = n0 + v * 8;
  for (int r = threadIdx.x / CV; r < kChunk; r += RS) {
    const int k = k0 + r;
    __nv_bfloat16* d = dst + r * (BN + 8) + v * 8;
    const __nv_bfloat16* s = w + (int64_t)k * g.n + n;
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

template <int VEC, int BN>
__global__ void __launch_bounds__(kThreads, 2)
matmul_fwd_panel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ b, const __nv_bfloat16* __restrict__ w,
                 void* __restrict__ y, int out_bf16, int out_wide, FwdGeom g) {
  constexpr int WN = BN / 32, WM = kWarps / WN, BM = 64 * WM;
  constexpr int LDW = BN + 8;
  constexpr int W_ELEMS = kChunk * LDW;
  constexpr int SLOT = BM * kPitch;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* panel = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wst = panel + g.slots * SLOT;
  float* staging = reinterpret_cast<float*>(wst + kWStages * W_ELEMS);

  const int64_t m0 = (int64_t)(blockIdx.x / g.spans) * BM;
  const int tile0 = (int)(blockIdx.x % g.spans) * g.span_tiles;
  const int tiles = g.tiles_n - tile0 < g.span_tiles ? g.tiles_n - tile0 : g.span_tiles;
  const int steps = tiles * g.kc;
  const bool resident = g.slots >= g.kc;
  const int valid = g.m - m0 < BM ? (int)(g.m - m0) : BM;

  // this warp's 64 x 32 share of the tile, and its lanes' ldmatrix rows:
  // panel rows by mat % 2 (+0 / +8) and K by mat / 2 (+0 / +8); W k rows by
  // mat % 2, N +0 / +8 by mat / 2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int mat = lane / 8, r8 = lane % 8;
  const uint32_t a_off = ((wm * 64 + (mat % 2) * 8 + r8) * kPitch + (mat / 2) * 8) * 2;
  const uint32_t b_off = ((r8 + (mat % 2) * 8) * LDW + wn * 32 + (mat / 2) * 8) * 2;

  // step s: N tile s / kc of the span, K-chunk s % kc; a resident panel
  // keeps chunk c in slot c and copies it at step c only
  auto slot_of = [&](int s) { return (resident ? s % g.kc : s) % g.slots; };
  auto fresh = [&](int s) { return !resident || s < g.kc; };
  auto issue = [&](int s) {
    if (s < steps) {
      const int t = s / g.kc, c = s - t * g.kc;
      if (fresh(s)) copy_chunk<VEC, BM>(x, g, m0, c * kChunk, panel + slot_of(s) * SLOT);
      load_w_tile<VEC, BN>(w, g, c * kChunk, (tile0 + t) * BN, wst + (s % kWStages) * W_ELEMS);
    }
    copy_commit();  // a group per step, empty past the last, so the waits count steps
  };
  auto prepare = [&](int s) {
    if (s < steps && fresh(s))
      normalize_tile<BM, kChunk, kPitch, kThreads>(panel + slot_of(s) * SLOT, valid,
                                                   (s % g.kc) * kChunk, g.k, a, b);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  issue(0);
  issue(1);
  copy_wait_all_but_one();  // step 0 has landed
  __syncthreads();
  prepare(0);
  float* stg = staging + warp * 16 * kStagePitch;
  const int gq = lane / 4, tq = lane % 4;
  for (int s = 0; s < steps; ++s) {
    copy_wait_all();  // step s + 1 has landed ...
    __syncthreads();  // ... for every thread; step s is normalized, step s - 1 multiplied
    issue(s + 2);     // into the W stage (and streaming slot) step s - 1 used
    prepare(s + 1);   // no barrier between: other warps multiply meanwhile

    const uint32_t zb = smem_addr(panel + slot_of(s) * SLOT) + a_off;
    const uint32_t wb = smem_addr(wst + (s % kWStages) * W_ELEMS) + b_off;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t bf[4][2];
      ldmatrix_x4_trans(wb + kk * 16 * LDW * 2, bf[0][0], bf[0][1], bf[1][0], bf[1][1]);
      ldmatrix_x4_trans(wb + kk * 16 * LDW * 2 + 32, bf[2][0], bf[2][1], bf[3][0], bf[3][1]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(zb + mt * 16 * kPitch * 2 + kk * 32, af[0], af[1], af[2], af[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
    if (s % g.kc != g.kc - 1) continue;

    // the N tile is done. accumulator (mt, nt): rows gq, gq + 8 of the 16,
    // columns 2tq, 2tq + 1 of the 8; each warp stages 16 x 32 at a time in
    // its own tile and stores rows of 8 values
    const int n_tile = (tile0 + s / g.kc) * BN + wn * 32;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<float2*>(stg + (gq + half * 8) * kStagePitch + nt * 8 + tq * 2) =
              make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
          acc[mt][nt][half * 2] = acc[mt][nt][half * 2 + 1] = 0.f;
        }
      __syncwarp();
#pragma unroll
      for (int q = lane; q < 64; q += 32) {
        const int row = q / 4, c8 = (q % 4) * 8;
        const int r = wm * 64 + mt * 16 + row;
        const int n = n_tile + c8;
        if (r < valid && n < g.n)
          store_out<8>(y, out_bf16, out_wide, (m0 + r) * g.n + n, stg + row * kStagePitch + c8,
                       g.n - n < 8 ? g.n - n : 8);
      }
      __syncwarp();
    }
  }
}

template <int VEC, int BN>
cudaError_t launch(const __nv_bfloat16* x, const float* a, const float* b,
                   const __nv_bfloat16* w, void* y, int out_bf16, const FwdGeom& g, int smem,
                   int64_t blocks, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(matmul_fwd_panel<VEC, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  matmul_fwd_panel<VEC, BN><<<(unsigned)blocks, kThreads, smem, st>>>(
      x, a, b, w, y, out_bf16, moco_gemm::wide_stores(g.n, y), g);
  return cudaGetLastError();
}

}  // namespace

// y[M, N] (bf16 if out_dtype == 1, f32 if 0) = relu(x[M, K]*a + b) @ w[K, N],
// x and w bf16. bn (64 or 128), span (N columns per block, a multiple of
// bn), slots (panel chunks in shared memory: at least ceil(K / 64), or at
// least 3 to stream) and smem_bytes come from the plan
// (ops/fused_conv.py: matmul_fwd_plan); smem_bytes must be what they need.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int moco_matmul_fwd_bf16(const void* x, const float* a, const float* b,
                                    const void* w, void* y, int out_dtype, int64_t m, int k,
                                    int n, int bn, int span, int slots, int smem_bytes,
                                    void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (out_dtype != 0 && out_dtype != 1) ||
      (bn != 64 && bn != 128) || span <= 0 || span % bn != 0 || slots <= 0)
    return (int)cudaErrorInvalidValue;
  const int bm = 64 * (kWarps / (bn / 32));
  FwdGeom g;
  g.m = m;
  g.k = k;
  g.n = n;
  g.kc = (k + kChunk - 1) / kChunk;
  g.slots = slots;
  g.span_tiles = span / bn;
  g.tiles_n = (n + bn - 1) / bn;
  g.spans = (g.tiles_n + g.span_tiles - 1) / g.span_tiles;
  const int64_t smem = smem_needed(bn, slots);
  const int64_t blocks = (m + bm - 1) / bm * g.spans;
  if ((slots < g.kc && slots < kWStages) || smem != smem_bytes || smem > kSmemLimit ||
      blocks > INT_MAX || (int64_t)g.span_tiles * g.kc > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const __nv_bfloat16*>(x);
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  const bool wide = k % 8 == 0 && n % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
  cudaError_t err;
  if (bn == 64)
    err = wide ? launch<8, 64>(xt, a, b, wt, y, out_dtype, g, smem_bytes, blocks, st)
               : launch<1, 64>(xt, a, b, wt, y, out_dtype, g, smem_bytes, blocks, st);
  else
    err = wide ? launch<8, 128>(xt, a, b, wt, y, out_dtype, g, smem_bytes, blocks, st)
               : launch<1, 128>(xt, a, b, wt, y, out_dtype, g, smem_bytes, blocks, st);
  return (int)err;
}
