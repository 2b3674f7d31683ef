// Fused corrected sampled-softmax loss with shared negatives (paper eq.
// 2-3), forward only:
//
//   loss[t] = logsumexp([pos[t], <h_t, w_j> - logq[j] - log m_total for
//                        j < m]) - pos[t]
//
// h: (T, d) and w_neg: (m, d) both fp32 or both bf16; logq: (m,), pos:
// (T,) and loss: (T,) fp32.
//
// Replaces: src/repro/kernels/sampled_loss.py::sampled_loss (the Pallas
// kernel over a (T tiles, m tiles) grid whose running (max, sumexp) lives
// in VMEM scratch across the sequential m axis; its wrapper
// src/repro/kernels/ops.py::sampled_loss pads m with logq = 1e30).  No
// reference path calls it; it is reached through kernels/ops.py::
// sampled_loss.
//
// Bound on an H100, by route (2 T m d FLOP against the inputs read once):
//  * tensor cores (bf16): llama3-8b's entry run, T = 2,176, m = 512, d =
//    4,096: 9.13 GFLOP = 9.2 us at 989 TFLOP/s against 22 MB = 6.7 us at
//    3.35 TB/s: operations.  On the CUDA cores the same work would take
//    136 us at the 67 TFLOP/s fp32 rate.
//  * CUDA cores (fp32): T = 1,024, m = 512, d = 128: 134 MFLOP = 2.0 us
//    at 67 TFLOP/s against 0.8 MB = 0.25 us: operations.
//
// Design.  The logits of a (token tile x negative tile) never leave the
// block: they fold into a running (max, sumexp) per token while still in
// registers, the running max starting at -1e30 as the Pallas scratch does.
// Negatives past m carry no mass, so T and m need not be multiples of a
// tile.  What held the kernel this one replaced back (one block per 32
// tokens walking all of m on the CUDA cores, one shared load per FMA, 32
// blocks for 132 SMs), and what this one does about it:
//  1. Too few blocks: the grid is (token tiles, m-splits), each split a
//     run of whole negative tiles.  Each block writes its split's partial
//     (max, sumexp) per token to a (2, splits, T) workspace, and a second
//     kernel folds the splits in a fixed order, then the positive logit:
//     c = max(pos, max_s m_s), loss = log(sum_s l_s e^(m_s - c) +
//     e^(pos - c)) + c - pos.  No atomics: two calls give the same bits.
//     With one split the first kernel writes the loss itself.
//  2. bf16 work on the CUDA cores: where h and w_neg are bf16, d is a
//     multiple of 8 and both bases are 16-byte aligned, the tile is a
//     product on the tensor cores: mma.sync m16n8k16 bf16 -> fp32, each
//     warp a (WM x WN) piece of it, fragments read by ldmatrix.  bf16 x
//     bf16 products are exact in fp32, so this computes what the Pallas
//     kernel computes after its fp32 cast, up to the order of sums.  On
//     this route the loads, not the products, bound the first design
//     (cp.async copies through each SM's load path, at llama3-8b's entry
//     shape).  So the TMA loads the tiles: one 2-D box per tile and
//     64-column chunk (zeros past T, m and d), 128-byte swizzled so that
//     ldmatrix reads no two rows from one bank group, into a kStages-deep
//     ring whose slots' barriers count the bytes landed; the ring runs on
//     across the block's negative tiles.  T = 2,176 is 17 x 128, so 64-
//     and 128-token tiles left 4 or 8 blocks over whole waves of 132 SMs;
//     80 x 128 tiles (one warp row of 80 tokens, four of 32 negatives)
//     give 28 x 4 = 112 blocks, one wave.
//  3. One shared load per FMA: the CUDA-core route (fp32, and bf16 at
//     other widths or alignments) gives each thread an M x M register
//     micro-tile (M tokens x M negatives: M / 2 16-byte shared loads feed
//     M^2 FMAs), over 32-column chunks of h and w_neg staged transposed
//     through a cp.async ring (4-byte copies, a warp's 32 in 32 distinct
//     banks); bf16 there is converted to fp32 on load.
// The wrapper (kernels/sampled_loss.py::plan) picks the route, the tiling
// and the splits by shape; kInstances below lists what is built.
#include <cuda.h>  // CUtensorMap, cuTensorMapEncodeTiled's types
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInit = -1e30f;  // the running max's start
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCombineThreads = 256;
constexpr int kMaxDevices = 64;

// The partial (max M, sumexp L) of a token over the negatives of one
// split: with one split, the loss itself; else the workspace's entries.
__device__ __forceinline__ void finish(float M, float L, int t, int T,
                                       int split, int splits,
                                       const float* __restrict__ pos,
                                       float* __restrict__ out,
                                       float* __restrict__ ws) {
  if (splits == 1) {
    const float p = pos[t];
    const float c = fmaxf(M, p);
    out[t] = logf(L * expf(M - c) + expf(p - c)) + c - p;
  } else {
    ws[static_cast<size_t>(split) * T + t] = M;
    ws[static_cast<size_t>(splits + split) * T + t] = L;
  }
}

// Fold a tile's adjusted logits x[0..n) of one token (this lane's share;
// -inf where a negative is past m) into its running (m_run, l_run); the
// `lanes` lanes that share the token (lane bits below `lanes`) agree on
// the max.
template <int N, int LANES>
__device__ __forceinline__ void fold_row(const float (&x)[N], float& m_run,
                                         float& l_run) {
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < N; ++i) mx = fmaxf(mx, x[i]);
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  const float m_new = fmaxf(m_run, mx);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += expf(x[i] - m_new);
  l_run = l_run * expf(m_run - m_new) + s;
  m_run = m_new;
}

// Each warp column's (max, lane-summed sumexp) per token, merged in a
// fixed order; then `finish`.
template <int NW, int BT>
__device__ __forceinline__ void merge_warps(const float (&red_m)[NW][BT],
                                            const float (&red_l)[NW][BT],
                                            int t0, int T, int split,
                                            int splits,
                                            const float* __restrict__ pos,
                                            float* __restrict__ out,
                                            float* __restrict__ ws) {
  for (int r = threadIdx.x; r < BT; r += blockDim.x) {
    const int t = t0 + r;
    if (t >= T) continue;
    float M = red_m[0][r];
#pragma unroll
    for (int w = 1; w < NW; ++w) M = fmaxf(M, red_m[w][r]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) L += red_l[w][r] * expf(red_m[w][r] - M);
    finish(M, L, t, T, split, splits, pos, out, ws);
  }
}

namespace tc {  // the bf16 tensor-core route

using bf16 = __nv_bfloat16;

constexpr int kDC = 64;  // columns per staged chunk: one 128-byte row
constexpr int kStages = 3;

// A block of BT tokens x BN negatives, warps of WM tokens x WN negatives.
template <int BT, int BN, int WM, int WN>
struct Tile {
  static constexpr int kWarpsT = BT / WM;
  static constexpr int kWarpsN = BN / WN;
  static_assert(kWarpsT * WM == BT && kWarpsN * WN == BN, "tiles");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tiles");
  static_assert(BT % 8 == 0 && BN % 8 == 0, "1,024-byte aligned tiles");
  static constexpr int kThreads = 32 * kWarpsT * kWarpsN;
  static constexpr int kMi = WM / 16;  // m16 tiles per warp
  static constexpr int kNj = WN / 8;   // n8 tiles per warp
  static constexpr int kStage = (BT + BN) * kDC;  // bf16 per ring slot
  static constexpr unsigned kStageBytes = kStage * sizeof(bf16);
  // the ring, and room to start it on a 1,024-byte boundary
  static constexpr size_t kSmem =
      static_cast<size_t>(kStages) * kStageBytes + 1024;
};

template <int BT, int BN, int WM, int WN>
__global__ void __launch_bounds__(Tile<BT, BN, WM, WN>::kThreads)
    sampled_loss_mma_kernel(const __grid_constant__ CUtensorMap map_h,
                            const __grid_constant__ CUtensorMap map_w,
                            const float* __restrict__ logq,
                            const float* __restrict__ pos,
                            float* __restrict__ out, float* __restrict__ ws,
                            int T, int m, int d, float log_m, int per_split) {
  using C = Tile<BT, BN, WM, WN>;
  extern __shared__ unsigned char smem[];
  // [kStages][BT + BN][kDC], each slot's h tile then w_neg tile
  bf16* ring = reinterpret_cast<bf16*>(
      smem + (1024 - tcore::smem_addr(smem) % 1024) % 1024);
  __shared__ uint64_t full[kStages];  // slot s's chunk has landed
  __shared__ float red_m[C::kWarpsN][BT];
  __shared__ float red_l[C::kWarpsN][BT];

  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y, splits = gridDim.y;
  const int jt0 = split * per_split;
  const int jt1 = min((m + BN - 1) / BN, jt0 + per_split);
  const int n_dc = (d + kDC - 1) / kDC;
  const int n_chunks = (jt1 - jt0) * n_dc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wn = warp % C::kWarpsN;
  const int wr0 = (warp / C::kWarpsN) * WM, wc0 = wn * WN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) tcore::mbar_init(&full[s], 1);
    tcore::fence_mbar_init();
  }
  __syncthreads();
  // thread 0 stages chunk pc (columns (pc % n_dc) * kDC .. of the h tile
  // and of negative tile jt0 + pc / n_dc; the TMA zero-fills rows past T
  // or m and columns past d) into `slot`
  int pc = 0;
  auto prefetch = [&](int slot) {
    if (pc < n_chunks) {
      bf16* s = ring + slot * C::kStage;
      const int k0 = (pc % n_dc) * kDC, j0 = (jt0 + pc / n_dc) * BN;
      tcore::mbar_arrive_expect_tx(&full[slot], C::kStageBytes);
      tcore::tma_load_2d(s, &map_h, k0, t0, &full[slot]);
      tcore::tma_load_2d(s + BT * kDC, &map_w, k0, j0, &full[slot]);
    }
    ++pc;
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  float acc[C::kMi][C::kNj][4];
  float m_run[C::kMi][2], l_run[C::kMi][2];
#pragma unroll
  for (int i = 0; i < C::kMi; ++i) {
#pragma unroll
    for (int n = 0; n < C::kNj; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    m_run[i][0] = m_run[i][1] = kNegInit;
    l_run[i][0] = l_run[i][1] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // every warp is done with the slot read last
    if (threadIdx.x == 0) {
      tcore::fence_proxy_async();
      prefetch((c + kStages - 1) % kStages);
    }
    tcore::mbar_wait(&full[c % kStages], (c / kStages) & 1);
    const bf16* hs = ring + (c % kStages) * C::kStage;
    const bf16* wsm = hs + BT * kDC;
#pragma unroll
    for (int ks = 0; ks < kDC / 16; ++ks) {
      unsigned a[C::kMi][4];
#pragma unroll
      for (int i = 0; i < C::kMi; ++i)
        tcore::ldsm_x4(tcore::swizzled(hs, wr0 + i * 16 + (lane & 15),
                                       ks * 16 + (lane >> 4) * 8),
                       a[i]);
#pragma unroll
      for (int n = 0; n < C::kNj / 2; ++n) {
        unsigned b[4];  // n8 tiles 2n (b[0], b[1]) and 2n + 1 (b[2], b[3])
        tcore::ldsm_x4(
            tcore::swizzled(wsm, wc0 + n * 16 + (lane & 7) + (lane >> 4) * 8,
                            ks * 16 + ((lane >> 3) & 1) * 8),
            b);
#pragma unroll
        for (int i = 0; i < C::kMi; ++i) {
          tcore::mma(acc[i][2 * n], a[i], b[0], b[1]);
          tcore::mma(acc[i][2 * n + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (c % n_dc != n_dc - 1) continue;

    // the negative tile is done: adjusted logits, folded per token row
    // (g and g + 8 of each m16 tile, shared by the 4 lanes of a quad)
    const int jb = (jt0 + c / n_dc) * BN + wc0 + 2 * tig;
    float lq[C::kNj][2];
#pragma unroll
    for (int n = 0; n < C::kNj; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = jb + n * 8 + e;
        lq[n][e] = j < m ? logq[j] : CUDART_INF_F;  // past m: no mass
      }
#pragma unroll
    for (int i = 0; i < C::kMi; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x[2 * C::kNj];
#pragma unroll
        for (int n = 0; n < C::kNj; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[2 * n + e] = acc[i][n][2 * hh + e] - lq[n][e] - log_m;
            acc[i][n][2 * hh + e] = 0.f;
          }
        fold_row<2 * C::kNj, 4>(x, m_run[i][hh], l_run[i][hh]);
      }
  }

#pragma unroll
  for (int i = 0; i < C::kMi; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[i][hh];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      if (tig == 0) {
        const int r = wr0 + i * 16 + g + 8 * hh;
        red_m[wn][r] = m_run[i][hh];
        red_l[wn][r] = l;
      }
    }
  __syncthreads();
  merge_warps<C::kWarpsN, BT>(red_m, red_l, t0, T, split, splits, pos, out,
                              ws);
}

}  // namespace tc

namespace simt {  // the CUDA-core route

constexpr int kK = 32;  // columns of d per staged chunk
constexpr int kStages = 3;

// A block of BT tokens x BN negatives: (BT / 4M) x (BN / 8M) warps; in a
// warp 4 x 8 lanes, each with an M x M micro-tile of (M / 4)^2 float4
// groups, 16 tokens and 32 negatives apart: one 16-byte shared load of a
// warp then reads 4 (h) or 8 (w_neg) distinct float4, one wavefront.
template <int BT, int BN, int M>
struct Tile {
  static constexpr int kG = M / 4;
  static constexpr int kWarpsT = BT / (4 * M);
  static constexpr int kWarpsN = BN / (8 * M);
  static_assert(kWarpsT * 4 * M == BT && kWarpsN * 8 * M == BN, "tiles");
  static constexpr int kThreads = 32 * kWarpsT * kWarpsN;
  // transposed rows padded by 4 floats: 16-byte aligned, and a warp's
  // copies (4 rows x 8 columns) land in 32 distinct banks
  static constexpr int kHPitch = BT + 4;
  static constexpr int kWPitch = BN + 4;
  static constexpr int kStage = kK * (kHPitch + kWPitch);
  static constexpr size_t kSmem =
      static_cast<size_t>(kStages) * kStage * sizeof(float);
};

// src[row0 + r, k0 + kk] -> dst[kk * PITCH + r] for r < ROWS, kk < kK; each
// group of 32 copies takes 4 rows x 8 consecutive columns (32-byte sectors
// of src).  fp32 by 4-byte cp.async; bf16 converted through registers.
template <typename Tin, int ROWS, int PITCH>
__device__ __forceinline__ void stage_t(float* dst, const Tin* src,
                                        int row0, int n_rows, int k0, int d,
                                        int threads) {
  for (int e = threadIdx.x; e < ROWS * kK; e += threads) {
    const int grp = e / 32, l = e % 32;
    const int r = (grp / (kK / 8)) * 4 + l / 8;
    const int kk = (grp % (kK / 8)) * 8 + l % 8;
    const bool ok = row0 + r < n_rows && k0 + kk < d;
    const Tin* p = src + static_cast<size_t>(row0 + r) * d + k0 + kk;
    if constexpr (std::is_same<Tin, float>::value)
      tcore::cp_async<4>(dst + kk * PITCH + r, ok ? p : src, ok);
    else
      dst[kk * PITCH + r] = ok ? __bfloat162float(*p) : 0.f;
  }
}

template <typename Tin, int BT, int BN, int M>
__global__ void __launch_bounds__(Tile<BT, BN, M>::kThreads)
    sampled_loss_simt_kernel(const Tin* __restrict__ h,
                             const Tin* __restrict__ w,
                             const float* __restrict__ logq,
                             const float* __restrict__ pos,
                             float* __restrict__ out, float* __restrict__ ws,
                             int T, int m, int d, float log_m,
                             int per_split) {
  using C = Tile<BT, BN, M>;
  constexpr int kG = C::kG;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][kStage]
  __shared__ float red_m[C::kWarpsN][BT];
  __shared__ float red_l[C::kWarpsN][BT];

  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y, splits = gridDim.y;
  const int jt0 = split * per_split;
  const int jt1 = min((m + BN - 1) / BN, jt0 + per_split);
  const int n_dc = (d + kK - 1) / kK;
  const int n_chunks = (jt1 - jt0) * n_dc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % C::kWarpsN;
  // this lane's tokens trow + 16 g + e and negatives jcol + 32 g + f
  const int trow = (warp / C::kWarpsN) * 4 * M + (lane / 8) * 4;
  const int jcol = wn * 8 * M + (lane % 8) * 4;

  int pc = 0;  // the next chunk to stage
  auto prefetch = [&](int slot) {
    if (pc < n_chunks) {
      float* s = ring + slot * C::kStage;
      const int j0 = (jt0 + pc / n_dc) * BN, k0 = (pc % n_dc) * kK;
      stage_t<Tin, BT, C::kHPitch>(s, h, t0, T, k0, d, C::kThreads);
      stage_t<Tin, BN, C::kWPitch>(s + kK * C::kHPitch, w, j0, m, k0, d,
                                   C::kThreads);
    }
    ++pc;
    tcore::cp_async_commit();  // possibly empty: one group per chunk
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  float acc[M][M];
  float m_run[M], l_run[M];
#pragma unroll
  for (int e = 0; e < M; ++e) {
#pragma unroll
    for (int f = 0; f < M; ++f) acc[e][f] = 0.f;
    m_run[e] = kNegInit;
    l_run[e] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    tcore::cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();  // ... for every thread; the slot read last is free
    prefetch((c + kStages - 1) % kStages);
    const float* hs = ring + (c % kStages) * C::kStage + trow;
    const float* wsm = ring + (c % kStages) * C::kStage + kK * C::kHPitch +
                       jcol;
#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      float4 a[kG], b[kG];
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        a[q] = *reinterpret_cast<const float4*>(hs + kk * C::kHPitch +
                                                q * 16);
        b[q] = *reinterpret_cast<const float4*>(wsm + kk * C::kWPitch +
                                                q * 32);
      }
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        const float ae[4] = {a[gi].x, a[gi].y, a[gi].z, a[gi].w};
#pragma unroll
        for (int gj = 0; gj < kG; ++gj) {
          const float bf[4] = {b[gj].x, b[gj].y, b[gj].z, b[gj].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int f = 0; f < 4; ++f)
              acc[gi * 4 + e][gj * 4 + f] =
                  fmaf(ae[e], bf[f], acc[gi * 4 + e][gj * 4 + f]);
        }
      }
    }
    if (c % n_dc != n_dc - 1) continue;

    // the negative tile is done: fold each of this lane's M tokens (the 8
    // lanes of a row group share them)
    const int jb = (jt0 + c / n_dc) * BN + jcol;
    float lq[M];
#pragma unroll
    for (int gj = 0; gj < kG; ++gj)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = jb + gj * 32 + f;
        lq[gj * 4 + f] = j < m ? logq[j] : CUDART_INF_F;  // past m: no mass
      }
#pragma unroll
    for (int e = 0; e < M; ++e) {
      float x[M];
#pragma unroll
      for (int f = 0; f < M; ++f) {
        x[f] = acc[e][f] - lq[f] - log_m;
        acc[e][f] = 0.f;
      }
      fold_row<M, 8>(x, m_run[e], l_run[e]);
    }
  }

#pragma unroll
  for (int e = 0; e < M; ++e) {
    float l = l_run[e];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) l += __shfl_xor_sync(kFull, l, off);
    if (lane % 8 == 0) {
      const int r = trow + (e / 4) * 16 + e % 4;
      red_m[wn][r] = m_run[e];
      red_l[wn][r] = l;
    }
  }
  __syncthreads();
  merge_warps<C::kWarpsN, BT>(red_m, red_l, t0, T, split, splits, pos, out,
                              ws);
}

}  // namespace simt

// loss[t] from the splits' partials in ws, in a fixed order
__global__ void __launch_bounds__(kCombineThreads)
    sampled_loss_combine_kernel(const float* __restrict__ ws,
                                const float* __restrict__ pos,
                                float* __restrict__ out, int T, int splits) {
  const int t = blockIdx.x * kCombineThreads + threadIdx.x;
  if (t >= T) return;
  const float p = pos[t];
  float c = p;
  for (int s = 0; s < splits; ++s)
    c = fmaxf(c, ws[static_cast<size_t>(s) * T + t]);
  float total = 0.f;
  for (int s = 0; s < splits; ++s)
    total += ws[static_cast<size_t>(splits + s) * T + t] *
             expf(ws[static_cast<size_t>(s) * T + t] - c);
  total += expf(p - c);
  out[t] = logf(total) + c - p;
}

// A (rows, d) row-major bf16 tensor's map for the TMA: boxes of box_rows
// rows x kDC columns, 128-byte swizzled, zeros past its edges
bool encode(CUtensorMap* map, const void* base, int rows, int d,
            int box_rows) {
  const tcore::EncodeTiled fn = tcore::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {tc::kDC, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BT, int BN, int WM, int WN>
cudaError_t launch_mma(const void* h, const void* w, const float* logq,
                       const float* pos, float* out, float* ws, int T, int m,
                       int d, float log_m, int per_split, int splits,
                       int device, cudaStream_t stream) {
  using C = tc::Tile<BT, BN, WM, WN>;
  auto kernel = tc::sampled_loss_mma_kernel<BT, BN, WM, WN>;
  static bool ready[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  CUtensorMap map_h{}, map_w{};  // w's is not read where m = 0
  if (!encode(&map_h, h, T, d, BT) ||
      (m > 0 && !encode(&map_w, w, m, d, BN)))
    return cudaErrorInvalidValue;
  const dim3 grid((T + BT - 1) / BT, splits);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      map_h, map_w, logq, pos, out, ws, T, m, d, log_m, per_split);
  return cudaGetLastError();
}

template <typename Tin, int BT, int BN, int M>
cudaError_t launch_simt(const void* h, const void* w, const float* logq,
                        const float* pos, float* out, float* ws, int T,
                        int m, int d, float log_m, int per_split, int splits,
                        int device, cudaStream_t stream) {
  using C = simt::Tile<BT, BN, M>;
  auto kernel = simt::sampled_loss_simt_kernel<Tin, BT, BN, M>;
  static bool ready[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device] && C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return err;
  }
  ready[device] = true;
  const dim3 grid((T + BT - 1) / BT, splits);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const Tin*>(h), static_cast<const Tin*>(w), logq, pos, out,
      ws, T, m, d, log_m, per_split);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const float*,
                               const float*, float*, float*, int, int, int,
                               float, int, int, int, cudaStream_t);

// the tilings of kernels/sampled_loss.py::TILINGS: (route: 1 tensor
// cores, 0 CUDA cores; bf16; BT; BN; e1, e2: the warp tile (WM, WN) on
// the tensor cores, the micro-tile edge M twice on the CUDA cores)
struct Instance {
  int mma, bf16, bt, bn, e1, e2;
  Launch launch;
};
constexpr Instance kInstances[] = {
    {1, 1, 64, 64, 32, 32, launch_mma<64, 64, 32, 32>},
    {1, 1, 80, 128, 80, 32, launch_mma<80, 128, 80, 32>},
    {0, 0, 32, 64, 4, 4, launch_simt<float, 32, 64, 4>},
    {0, 1, 32, 64, 4, 4, launch_simt<__nv_bfloat16, 32, 64, 4>},
};

}  // namespace

// h: (T, d), w: (m, d) contiguous, both fp32 (bf16 = 0) or both bf16
// (bf16 = 1); logq: (m,), pos: (T,), out: (T,) fp32; log_m = log(m_total).
// The plan (kernels/sampled_loss.py::plan): route mma = 1 (bf16, d % 8 ==
// 0, 16-byte aligned h and w) or 0, tiles of bt tokens x bn negatives,
// (e1, e2) as in kInstances, and `splits` runs of whole negative tiles;
// with splits > 1, ws holds (2, splits, T) fp32 partials and a second
// kernel folds them, else ws is not read.  Launches on `stream` of
// `device`; returns the first non-zero cudaError_t.
extern "C" int sampled_loss_fwd(const void* h, const void* w,
                                const float* logq, const float* pos,
                                float* out, float* ws, int T, int m, int d,
                                float log_m, int bf16, int mma, int bt,
                                int bn, int e1, int e2, int splits,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch launch = nullptr;
  for (const Instance& x : kInstances)
    if (x.mma == mma && x.bf16 == bf16 && x.bt == bt && x.bn == bn &&
        x.e1 == e1 && x.e2 == e2)
      launch = x.launch;
  const int n_nt = (m + bn - 1) / (bn > 0 ? bn : 1);
  const int per_split = splits > 0 ? (n_nt + splits - 1) / splits : 0;
  const bool bad_splits = n_nt > 0 ? (splits - 1) * per_split >= n_nt
                                    : splits != 1;  // no split is empty
  if (launch == nullptr || T <= 0 || m < 0 || d <= 0 || splits <= 0 ||
      splits > 65535 || bad_splits ||
      (mma && (d % 8 != 0 || reinterpret_cast<size_t>(h) % 16 != 0 ||
               reinterpret_cast<size_t>(w) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch(h, w, logq, pos, out, ws, T, m, d, log_m, per_split, splits,
               device, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  sampled_loss_combine_kernel<<<(T + kCombineThreads - 1) / kCombineThreads,
                                kCombineThreads, 0, st>>>(ws, pos, out, T,
                                                          splits);
  return static_cast<int>(cudaGetLastError());
}
