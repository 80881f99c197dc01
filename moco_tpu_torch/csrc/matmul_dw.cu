// Weight gradient of the fused BN->ReLU->1x1 conv in bf16, for Hopper
// (sm_90a), bound to Python through ctypes by moco_tpu_torch/ops/fused_conv.py
// (`bn_relu_matmul_dw`, whose plan `matmul_dw_plan` chooses the tile, the
// stages, the row slabs, the cluster size and the shared memory). The f32
// route stays on fused_conv_dw.cu.
//
// Replaces the Pallas TPU kernel bn_relu_matmul_dw
// (moco_tpu/ops/pallas_fused_conv.py:84, pallas_call :101, body _dw_kernel :63).
//
// Work: dW[K, N] (f32) = relu(x[M, K]*a + b)^T @ dy[M, N], x and dy bf16,
// z = relu(x*a + b) rounded to bf16, f32 accumulation.
//
// Bound: one read of x and dy against 2*M*K*N operations on the bf16 tensor
// cores; at the ResNet-50 batch-256 shapes layers 1-3 are bound by the
// bytes (layer 1: x 103 MB + dy 411 MB) and layer 4 by the operations.
//
// Design. The TPU kernel carries the sum in a VMEM accumulator across a
// sequential grid axis over rows. Hopper blocks run in no order, so:
// - A block owns a BKO x BN tile of dW (128 x 128, or 64 x 256 where
//   K <= 64, so no product is half padding) over 8 warps of 64 x 32 (64 f32
//   accumulators a thread), and one slab of consecutive rows.
// - It walks its slab 64 rows at a time through a ring of three cp.async
//   stages, each holding x[64, BKO] and dy[64, BN] at a pitch of an odd
//   number of 16-byte units (the 8 rows of an ldmatrix phase fall in 8
//   distinct bank groups). One block barrier per chunk: after it, the copies
//   of chunk i + 2 start, chunk i + 1's x is normalized in place
//   (once: this block is its only reader) and chunk i multiplies, z^T and dy
//   both read by ldmatrix.trans into mma.sync.m16n8k16. No per-row
//   division.
// - The sum over slabs is two-level and deterministic, with no float
//   atomics. The blocks of `cluster` consecutive slabs of a tile form a
//   thread-block cluster: each puts its f32 tile in its own shared memory,
//   and after cluster.sync() rank r sums its 1/cluster share of the tile
//   over the ranks' shared memory in rank order. The tile's first cluster
//   writes its sum into dW; any later one writes a partial to an HBM
//   scratch, and a second kernel adds the partials to dW in cluster order.
//   The plan keeps those partials under 1/8 of the bytes of x and dy, and
//   its clusters at two blocks (larger ones ran slower on an H100).
// - Rows past the slab are 0 in both z and dy (a stale NaN in either would
//   reach every output through the product); channels past K or N are
//   masked, and the epilogue stores only what lies inside. 16-byte copies
//   need K and N multiples of 8 and 16-byte aligned x and dy; otherwise
//   2-byte loads.

#include "band_mma.cuh"

#include <cooperative_groups.h>
#include <limits.h>

namespace {

namespace cg = cooperative_groups;
using namespace moco_band;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;           // rows per chunk
constexpr int kStages = 3;          // chunks in shared memory at once (four: slower on an H100)
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

struct DwGeom {
  int64_t m;
  int k, n;
  int tiles_n;
  int slabs, cluster;     // row slabs per tile; slabs per cluster
  int64_t rows_per_slab;  // the last slab has fewer, or none
};

template <int BKO>
__host__ __device__ constexpr int tile_n() {
  return 32 * (kWarps / (BKO / 64));
}

int64_t smem_needed(int bko) {
  const int bn = bko == 64 ? tile_n<64>() : tile_n<128>();
  const int64_t ring = (int64_t)kStages * kRows * ((bko + 8) + (bn + 8)) * 2;
  const int64_t tile = (int64_t)bko * (bn + 8) * 4;  // the f32 tile overlays the ring
  return ring > tile ? ring : tile;
}

// Start the copies of rows p0 .. p0+63 (x channels k0 .. k0+BKO-1, dy
// channels n0 .. n0+BN-1) into one stage. dy rows at or past r1 and dy
// channels past N are written as 0; x rows past r1 and x channels past K
// are left for normalize_tile.
template <int VEC, int BKO, int BN>
__device__ __forceinline__ void copy_rows(const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ dy,
                                          const DwGeom& g, int64_t p0, int64_t r1, int k0,
                                          int n0, __nv_bfloat16* sx, __nv_bfloat16* sd) {
  constexpr int LDX = BKO + 8, LDD = BN + 8;
  const int rows = r1 - p0 < kRows ? (int)(r1 - p0) : kRows;
  {
    constexpr int CV = BKO / 8, RS = kThreads / CV;
    const int v = threadIdx.x % CV;
    const int k = k0 + v * 8;
    if (k < g.k) {
      for (int r = threadIdx.x / CV; r < rows; r += RS) {
        __nv_bfloat16* d = sx + r * LDX + v * 8;
        const __nv_bfloat16* s = x + (p0 + r) * g.k + k;
        if constexpr (VEC == 8) {
          copy_in<8>(d, s);
        } else {
#pragma unroll 1
          for (int e = 0; e < 8 && k + e < g.k; ++e) d[e] = s[e];
        }
      }
    }
  }
  constexpr int CV = BN / 8, RS = kThreads / CV;
  const int v = threadIdx.x % CV;
  const int n = n0 + v * 8;
  for (int r = threadIdx.x / CV; r < kRows; r += RS) {
    __nv_bfloat16* d = sd + r * LDD + v * 8;
    const __nv_bfloat16* s = dy + (p0 + r) * g.n + n;
    if (VEC == 8 && r < rows && n < g.n) {
      copy_in<8>(d, s);
    } else if (r < rows && n < g.n) {
#pragma unroll 1
      for (int e = 0; e < 8; ++e) d[e] = n + e < g.n ? s[e] : __float2bfloat16(0.f);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int VEC, int BKO>
__global__ void __launch_bounds__(kThreads, 2)
matmul_dw_rows(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ b, const __nv_bfloat16* __restrict__ dy,
               float* __restrict__ part, float* __restrict__ out, DwGeom g) {
  constexpr int WK = BKO / 64, WN = kWarps / WK, BN = tile_n<BKO>();
  constexpr int LDX = BKO + 8, LDD = BN + 8, LDT = BN + 8;
  constexpr int X_ELEMS = kRows * LDX, STAGE = kRows * (LDX + LDD);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  // blocks of one tile are consecutive, slab fastest, so that the
  // `cluster` slabs of a cluster are neighbours in blockIdx.x
  const int slab = blockIdx.x % g.slabs;
  const int tile = blockIdx.x / g.slabs;
  const int k0 = tile / g.tiles_n * BKO;
  const int n0 = tile % g.tiles_n * BN;
  const int64_t r0 = slab * g.rows_per_slab < g.m ? slab * g.rows_per_slab : g.m;
  const int64_t r1 = r0 + g.rows_per_slab < g.m ? r0 + g.rows_per_slab : g.m;
  const int chunks = (int)((r1 - r0 + kRows - 1) / kRows);

  // this warp's share: K rows kb .. kb+63, N columns nb .. nb+31. ldmatrix
  // rows: z^T by row q +0 / +8 (mat / 2) and K +0 / +8 (mat % 2); dy by row
  // q (mat % 2) and N +0 / +8 (mat / 2)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kb = (warp / WN) * 64, nb = (warp % WN) * 32;
  const int mat = lane / 8, r8 = lane % 8;
  const uint32_t a_off = ((r8 + (mat / 2) * 8) * LDX + kb + (mat % 2) * 8) * 2;
  const uint32_t b_off = (X_ELEMS + (r8 + (mat % 2) * 8) * LDD + nb + (mat / 2) * 8) * 2;

  auto stage_of = [&](int i) { return ring + (i % kStages) * STAGE; };
  auto issue = [&](int i) {
    if (i < chunks) {
      __nv_bfloat16* sx = stage_of(i);
      copy_rows<VEC, BKO, BN>(x, dy, g, r0 + (int64_t)i * kRows, r1, k0, n0, sx, sx + X_ELEMS);
    }
    copy_commit();  // a group per chunk, empty past the slab, so the waits count chunks
  };
  auto prepare = [&](int i) {
    if (i < chunks) {
      const int64_t left = r1 - r0 - (int64_t)i * kRows;
      normalize_tile<kRows, BKO, LDX, kThreads>(stage_of(i), left < kRows ? (int)left : kRows,
                                                k0, g.k, a, b);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  static_assert(kStages == 3, "the waits below count one chunk ahead");
  issue(0);
  issue(1);
  copy_wait_all_but_one();  // chunk 0 has landed
  __syncthreads();
  prepare(0);
  for (int i = 0; i < chunks; ++i) {
    copy_wait_all();  // chunk i + 1 has landed ...
    __syncthreads();  // ... for every thread; chunk i is normalized, chunk i - 1 multiplied
    issue(i + 2);     // into the stage chunk i - 1 used
    prepare(i + 1);   // no barrier between: other warps multiply meanwhile

    const uint32_t base = smem_addr(stage_of(i));
#pragma unroll
    for (int q0 = 0; q0 < kRows; q0 += 16) {
      uint32_t bf[4][2];
      const uint32_t bq = base + b_off + q0 * LDD * 2;
      ldmatrix_x4_trans(bq, bf[0][0], bf[0][1], bf[1][0], bf[1][1]);
      ldmatrix_x4_trans(bq + 32, bf[2][0], bf[2][1], bf[3][0], bf[3][1]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ldmatrix_x4_trans(base + a_off + q0 * LDX * 2 + mt * 32, af[0], af[1], af[2], af[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }

  // the block's f32 tile into its shared memory, over the ring: accumulator
  // (mt, nt) holds rows k (gq, gq + 8), columns n (2tq, 2tq + 1)
  copy_wait_all();  // only empty groups are left, but leave none behind
  __syncthreads();  // every warp has read the ring
  float* tile_f = reinterpret_cast<float*>(smem);
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(tile_f + (kb + mt * 16 + gq + half * 8) * LDT + nb + nt * 8 +
                                   tq * 2) =
            make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);

  // rank r sums its share of the tile over the cluster's ranks, in rank
  // order, and writes it: cluster 0 of a tile into out, cluster c > 0 into
  // part[c - 1], added to out later in cluster order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int cs = g.cluster;
  const int rank = (int)cluster.block_rank();
  const int group = slab / cs;
  float* dst = group == 0 ? out : part + (int64_t)(group - 1) * g.k * g.n;
  constexpr int Q = BN / 4;  // float4 per tile row
  const int lo = rank * (BKO * Q) / cs, hi = (rank + 1) * (BKO * Q) / cs;
  for (int idx = lo + threadIdx.x; idx < hi; idx += kThreads) {
    const int row = idx / Q, col = (idx % Q) * 4;
    const int k = k0 + row, n = n0 + col;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < cs; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(tile_f, q) + row * LDT + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (k >= g.k || n >= g.n) continue;
    float* o = dst + (int64_t)k * g.n + n;
    if (g.n % 4 == 0) {
      *reinterpret_cast<float4*>(o) = s;
    } else {
      const float e[4] = {s.x, s.y, s.z, s.w};
      for (int j = 0; j < 4 && n + j < g.n; ++j) o[j] = e[j];
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// out[i] += part[c * total + i] for c = 0 .. partials - 1, in that order
__global__ void __launch_bounds__(256)
sum_groups(const float* __restrict__ part, int partials, int64_t total,
           float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = out[i];
  for (int c = 0; c < partials; ++c) s += part[(int64_t)c * total + i];
  out[i] = s;
}

template <int VEC, int BKO>
cudaError_t launch(const __nv_bfloat16* x, const float* a, const float* b,
                   const __nv_bfloat16* dy, float* part, float* out, const DwGeom& g,
                   int smem, int64_t blocks, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(matmul_dw_rows<VEC, BKO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, matmul_dw_rows<VEC, BKO>, x, a, b, dy, part, out, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dW[K, N] (f32) = relu(x[M, K]*a + b)^T @ dy[M, N], x and dy bf16. bko (64
// or 128), slabs (row slabs per dW tile), cluster (slabs per thread-block
// cluster, at most 8, dividing slabs) and smem_bytes come
// from the plan (ops/fused_conv.py: matmul_dw_plan); smem_bytes must be what
// they need. part: f32 [slabs / cluster - 1, K, N] scratch for the partials
// of every cluster of a tile but its first, unused when one cluster covers
// the slabs. Returns cudaGetLastError() after the launches
// (0 = success).
extern "C" int moco_matmul_dw_bf16(const void* x, const float* a, const float* b,
                                   const void* dy, float* part, float* out, int64_t m, int k,
                                   int n, int bko, int slabs, int cluster, int smem_bytes,
                                   void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (bko != 64 && bko != 128) || slabs <= 0 || cluster <= 0 ||
      cluster > kMaxCluster || slabs % cluster != 0)
    return (int)cudaErrorInvalidValue;
  DwGeom g;
  g.m = m;
  g.k = k;
  g.n = n;
  const int bn = bko == 64 ? tile_n<64>() : tile_n<128>();
  g.tiles_n = (n + bn - 1) / bn;
  g.slabs = slabs;
  g.cluster = cluster;
  g.rows_per_slab = (m + slabs - 1) / slabs;
  const int64_t smem = smem_needed(bko);
  const int64_t blocks = (int64_t)((k + bko - 1) / bko) * g.tiles_n * slabs;
  if (smem != smem_bytes || smem > kSmemLimit || blocks > INT_MAX ||
      g.rows_per_slab / kRows > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const __nv_bfloat16*>(x);
  const auto* dyt = static_cast<const __nv_bfloat16*>(dy);
  const bool wide = k % 8 == 0 && n % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)dy % 16 == 0;
  cudaError_t err;
  if (bko == 64)
    err = wide ? launch<8, 64>(xt, a, b, dyt, part, out, g, smem_bytes, blocks, st)
               : launch<1, 64>(xt, a, b, dyt, part, out, g, smem_bytes, blocks, st);
  else
    err = wide ? launch<8, 128>(xt, a, b, dyt, part, out, g, smem_bytes, blocks, st)
               : launch<1, 128>(xt, a, b, dyt, part, out, g, smem_bytes, blocks, st);
  const int groups = slabs / cluster;
  if (err != cudaSuccess || groups == 1) return (int)err;
  const int64_t total = (int64_t)k * n;
  sum_groups<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, groups - 1, total, out);
  return (int)cudaGetLastError();
}
