// Batched quadratic forms  out[t, n] = alpha * h_t^T Z_n h_t + cnt_n  (fp32).
//
// Replaces: src/repro/kernels/block_scores.py::block_scores (the Pallas
// kernel: two MXU contractions per (query tile, node tile)).  The block
// sampler's root step and the tree's dense levels call it
// (core/hierarchy.py::descend); on the serving path it is the exact gram
// bound of the beam descent's dense levels (serve/retrieval.py::_ub_dense,
// alpha = 1 and cnt = 0, when gram_cap > 0).  Z is any fp32 matrix: no
// symmetry is assumed, as the Pallas kernel assumes none.
//
// Bound on an H100 (every Z_n read once at 3.35 TB/s against 2 T r^2 FLOPs
// per node at the 67 TFLOP/s fp32 rate; T / 2 FLOP per byte of Z):
//  * training root, T = 256, N = 391, r = 128: 3.3 GFLOP = 49 us against
//    26 MB = 8 us: operations.  The tree's nine levels at T = 256 (1,022
//    nodes): 129 us, operations.
//  * serving's nine levels, T = 16, r = 128: 67 MB = 20 us, bytes.
//  * r = 4,096, T = 16, N = 8: 537 MB = 160 us, bytes.
//
// Design.  The form is bilinear, so it splits over any tiling of Z_n into
// row strips I and column strips J:
//   s[t, n] = sum_(I,J) sum_(j in J) h_tj V_tj,  V_tj = sum_(i in I) h_ti Z_ij
// A unit of work is (node n, tile I x J, a tile of TQ queries); the plan
// (kernels/block_scores.py::plan) picks the tiles.  What held the kernel
// it replaced back, and what this one does about it:
//  1. One shared load per FMA.  Each thread owns an M x M register
//     micro-tile of V (M queries x M columns): per row i, M / 2 16-byte
//     shared loads of h and Z feed M^2 FMAs (M = 8 where T is large: 4
//     loads, 64 FMAs), and a warp's loads are one wavefront each (4 x 8
//     lanes over 16 queries and 32 columns, float4 groups 16 queries and
//     32 columns apart).
//  2. 16 queries per block, so Z crossed L2 16 times at T = 256: units of
//     TQ = 64 queries where T > 16 (the compute-bound shapes), 16 where T
//     <= 16 (the byte-bound ones).
//  3. Too few blocks (8 at r = 4,096): the plan splits Z_n's rows into
//     tiles until there are ~2 units per SM, and one block, resident for
//     the whole call, runs units blockIdx.x, + gridDim.x, ... as one
//     stream of 32-row chunks.  Each chunk's Z[chunk, J] (row-major,
//     16-byte cp.async) and h[queries, chunk] transposed (4-byte cp.async,
//     a warp's copies in 32 distinct banks) go through a ring of kStages
//     chunks that runs ahead across units, so the next unit's first
//     chunks load while this one's last ones are multiplied.
// The epilogue multiplies V by h_tj, sums each query's row over the unit's
// columns (shuffles, then the warps in a fixed order through shared
// memory) and writes one partial per (tile, query): V never reaches device
// memory (einsum writes it: 51 MB at the training root).  With one tile
// per node the unit writes alpha * s + cnt itself; with more, a second
// kernel sums the partials over tiles in a fixed order (a warp per (t, n),
// lanes over tiles, then a shuffle tree).  No atomics: two calls on the
// same inputs return the same bits.  Ragged T, r and tiles are masked
// (zero-filled copies); r % 4 != 0 or an unaligned Z takes 4-byte copies.
// fp32 FMAs only: one TF32 product keeps about 3 digits, far over the
// 1e-5 * max|plain| gate.
#include <cuda_runtime.h>

#include <climits>

#include "tensor_core.cuh"

namespace {

constexpr int kK = 32;       // rows of Z (i) per staged chunk
constexpr int kStages = 3;   // chunks in the ring
constexpr int kCombineThreads = 256;
constexpr int kMaxDevices = 64;  // per-device launch sizes kept

using tcore::cp_async;  // 4 or 16 bytes; ok = false zero-fills
using tcore::cp_async_commit;
using tcore::cp_async_wait;

// A block of TQ queries x BJ columns: (TQ / 4M) x (BJ / 8M) warps; in a
// warp 4 x 8 lanes, each with an M x M micro-tile of (M / 4)^2 float4
// groups, 16 queries and 32 columns apart: one 16-byte shared load of a
// warp then reads 4 (h) or 8 (Z) distinct float4, one wavefront.
template <int TQ, int BJ, int M>
struct Tile {
  static constexpr int kG = M / 4;  // float4 groups per micro-tile edge
  static constexpr int kWarpsT = TQ / (4 * M);
  static constexpr int kWarpsJ = BJ / (8 * M);
  static_assert(kWarpsT * 4 * M == TQ && kWarpsJ * 8 * M == BJ, "tiles");
  static constexpr int kThreads = 32 * kWarpsT * kWarpsJ;
  // h^T rows padded to TQ + 4: 16-byte aligned, and a warp's 4 queries x
  // 8 rows of copies land in 32 distinct banks
  static constexpr int kHPitch = TQ + 4;
  static constexpr int kZStage = kK * BJ;
  static constexpr int kHStage = kK * kHPitch;
  static constexpr size_t kSmem =
      static_cast<size_t>(kStages) * (kZStage + kHStage) * sizeof(float);
};

// A unit of work: (node n, row tile ti, column tile tj, query tile qt),
// numbered with queries fastest, so that the units that share a Z tile run
// together and meet it in L2.
struct Unit {
  int n, ti, tj, qt;
};

__device__ __forceinline__ Unit unit_of(int w, int n_qt, int n_i, int n_j) {
  Unit u;
  u.qt = w % n_qt;
  w /= n_qt;
  u.tj = w % n_j;
  w /= n_j;
  u.ti = w % n_i;
  u.n = w / n_i;
  return u;
}

template <int TQ, int BJ, int M>
__global__ void __launch_bounds__(Tile<TQ, BJ, M>::kThreads)
    block_scores_tile_kernel(const float* __restrict__ h,
                             const float* __restrict__ z,
                             const float* __restrict__ cnt,
                             float* __restrict__ out, float* __restrict__ ws,
                             int T, int N, int r, float alpha, int bi,
                             int n_qt, int n_i, int n_j, int units, int vec) {
  using C = Tile<TQ, BJ, M>;
  constexpr int kG = C::kG;
  extern __shared__ float4 smem4[];
  float* z_s = reinterpret_cast<float*>(smem4);  // [kStages][kK][BJ]
  float* h_s = z_s + kStages * C::kZStage;       // [kStages][kK][kHPitch]
  __shared__ float red[C::kWarpsJ][TQ];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wj = warp % C::kWarpsJ;
  // this lane's queries trow + 16 g + e and columns jcol + 32 g + f
  const int trow = (warp / C::kWarpsJ) * 4 * M + (lane / 8) * 4;
  const int jcol = wj * 8 * M + (lane % 8) * 4;
  auto chunks_of = [&](const Unit& u) {
    return (min(r, u.ti * bi + bi) - u.ti * bi + kK - 1) / kK;
  };

  // stage chunk c of unit u (rows i0 + c kK ..) into ring slot `slot`
  auto load = [&](const Unit& u, int c, int slot) {
    const int i1 = min(r, u.ti * bi + bi);
    const int k0 = u.ti * bi + c * kK, j0 = u.tj * BJ, t0 = u.qt * TQ;
    const float* zn = z + static_cast<size_t>(u.n) * r * r;
    float* zs = z_s + slot * C::kZStage;
    float* hs = h_s + slot * C::kHStage;
    if (vec) {
      for (int e = threadIdx.x; e < kK * BJ / 4; e += C::kThreads) {
        const int kk = e / (BJ / 4), cc = (e % (BJ / 4)) * 4;
        const bool ok = k0 + kk < i1 && j0 + cc < r;
        cp_async<16>(zs + kk * BJ + cc,
                     ok ? zn + static_cast<size_t>(k0 + kk) * r + j0 + cc
                        : zn,
                     ok);
      }
    } else {
      for (int e = threadIdx.x; e < kK * BJ; e += C::kThreads) {
        const int kk = e / BJ, cc = e % BJ;
        const bool ok = k0 + kk < i1 && j0 + cc < r;
        cp_async<4>(zs + kk * BJ + cc,
                    ok ? zn + static_cast<size_t>(k0 + kk) * r + j0 + cc
                       : zn,
                    ok);
      }
    }
    // h[t0 + t, k0 + kk] -> hs[kk][t]: each group of 32 copies takes 4
    // queries x 8 consecutive rows (32-byte sectors of h)
    for (int e = threadIdx.x; e < TQ * kK; e += C::kThreads) {
      const int grp = e / 32, l = e % 32;
      const int t = (grp / (kK / 8)) * 4 + l / 8;
      const int kk = (grp % (kK / 8)) * 8 + l % 8;
      const bool ok = k0 + kk < i1 && t0 + t < T;
      cp_async<4>(hs + kk * C::kHPitch + t,
                  ok ? h + static_cast<size_t>(t0 + t) * r + k0 + kk : h,
                  ok);
    }
  };

  // The block runs units blockIdx.x, + gridDim.x, ... as one stream of
  // chunks: the ring is kept kStages - 1 chunks ahead across units, so the
  // next unit's first chunks load during this one's last ones.
  int pw = blockIdx.x, pc = 0, slot_in = 0;  // the next chunk to stage
  Unit pu = unit_of(pw, n_qt, n_i, n_j);
  auto prefetch = [&]() {
    if (pw < units) {
      load(pu, pc, slot_in);
      if (++pc == chunks_of(pu)) {
        pc = 0;
        pw += gridDim.x;
        pu = unit_of(pw, n_qt, n_i, n_j);
      }
    }
    cp_async_commit();  // possibly empty: one group per stream position
    slot_in = slot_in == kStages - 1 ? 0 : slot_in + 1;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch();

  int slot = 0;
  for (int w = blockIdx.x; w < units; w += gridDim.x) {
    const Unit u = unit_of(w, n_qt, n_i, n_j);
    float acc[M][M];
#pragma unroll
    for (int e = 0; e < M; ++e)
#pragma unroll
      for (int f = 0; f < M; ++f) acc[e][f] = 0.f;

    const int n_chunks = chunks_of(u);
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<kStages - 2>();  // this chunk has landed
      __syncthreads();  // ... for every thread; the last slot read is free
      prefetch();
      const float* hs = h_s + slot * C::kHStage + trow;
      const float* zs = z_s + slot * C::kZStage + jcol;
      slot = slot == kStages - 1 ? 0 : slot + 1;
#pragma unroll 4
      for (int kk = 0; kk < kK; ++kk) {
        float4 a[kG], b[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          a[g] = *reinterpret_cast<const float4*>(hs + kk * C::kHPitch +
                                                  g * 16);
          b[g] = *reinterpret_cast<const float4*>(zs + kk * BJ + g * 32);
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
    }

    // partial[t] = sum_(j in J) h_tj V_tj: this lane's M columns, then
    // the warp's 8 column groups (lane bits 0-2), then the warps in order
    const int t0 = u.qt * TQ, j0 = u.tj * BJ;
    float part[M];
#pragma unroll
    for (int gi = 0; gi < kG; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + trow + gi * 16 + e;
        float s = 0.f;
#pragma unroll
        for (int gj = 0; gj < kG; ++gj)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int j = j0 + jcol + gj * 32 + f;
            const float hv = t < T && j < r
                                 ? __ldg(h + static_cast<size_t>(t) * r + j)
                                 : 0.f;
            s = fmaf(hv, acc[gi * 4 + e][gj * 4 + f], s);
          }
        part[gi * 4 + e] = s;
      }
#pragma unroll
    for (int e = 0; e < M; ++e)
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        part[e] += __shfl_xor_sync(0xffffffffu, part[e], off);
    if (lane % 8 == 0)
#pragma unroll
      for (int gi = 0; gi < kG; ++gi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[wj][trow + gi * 16 + e] = part[gi * 4 + e];
    __syncthreads();
    const int t = t0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < TQ && t < T) {
      float s = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < C::kWarpsJ; ++w2) s += red[w2][threadIdx.x];
      const int tiles = n_i * n_j;
      if (tiles == 1)
        out[static_cast<size_t>(t) * N + u.n] = alpha * s + cnt[u.n];
      else
        ws[(static_cast<size_t>(u.n) * T + t) * tiles + u.ti * n_j + u.tj] =
            s;
    }
    // red is written again only after the next unit's first __syncthreads
  }
}

// out[t, n] = alpha * sum_k ws[n, t, k] + cnt[n], the tiles k summed in a
// fixed order: lane l takes k = l, l + 32, ..., then a shuffle tree
__global__ void __launch_bounds__(kCombineThreads)
    block_scores_combine_kernel(const float* __restrict__ ws,
                                const float* __restrict__ cnt,
                                float* __restrict__ out, int T, int N,
                                int tiles, float alpha) {
  const int pair = (blockIdx.x * kCombineThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= N * T) return;  // whole warps
  const float* p = ws + static_cast<size_t>(pair) * tiles;
  float s = 0.f;
  for (int k = lane; k < tiles; k += 32) s += p[k];
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  const int n = pair / T, t = pair % T;
  if (lane == 0) out[static_cast<size_t>(t) * N + n] = alpha * s + cnt[n];
}

template <int TQ, int BJ, int M>
cudaError_t launch_tiles(const float* h, const float* z, const float* cnt,
                         float* out, float* ws, int T, int N, int r,
                         float alpha, int bi, int n_qt, int n_i, int n_j,
                         int units, int device, cudaStream_t stream) {
  using C = Tile<TQ, BJ, M>;
  auto kernel = block_scores_tile_kernel<TQ, BJ, M>;
  // as many blocks as stay resident at once, each a stream of units; the
  // count is found once per device (with the shared-memory attribute
  // set), then kept: a call costs a launch, not a device query
  static int resident[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    cudaError_t err;
    if (C::kSmem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(C::kSmem));
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, C::kThreads, C::kSmem);
    if (err != cudaSuccess) return err;
    if (sms * per_sm == 0) return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
  }
  const int blocks = resident[device] < units ? resident[device] : units;
  const int vec = r % 4 == 0 && reinterpret_cast<size_t>(z) % 16 == 0;
  kernel<<<blocks, C::kThreads, C::kSmem, stream>>>(
      h, z, cnt, out, ws, T, N, r, alpha, bi, n_qt, n_i, n_j, units, vec);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const float*, const float*, const float*,
                               float*, float*, int, int, int, float, int,
                               int, int, int, int, int, cudaStream_t);

// the tilings (TQ, BJ, M) of kernels/block_scores.py::TILINGS
struct Instance {
  int tq, bj, m;
  Launch launch;
};
constexpr Instance kInstances[] = {
    {16, 128, 4, launch_tiles<16, 128, 4>},
    {64, 128, 8, launch_tiles<64, 128, 8>},
};

}  // namespace

// h: (T, r); z: (N, r, r); cnt: (N,); out: (T, N) — fp32, contiguous.
// The tiling (kernels/block_scores.py::plan): tq queries by bj columns by
// bi rows per block, an m x m micro-tile per thread.  With more than one
// (bi x bj) tile per node, ws holds (N, T, tiles) fp32 partials and a
// second kernel sums them; else ws is not read.  Launches both on `stream`
// of `device`; returns the first non-zero cudaError_t.
extern "C" int block_scores_f32(const float* h, const float* z,
                                const float* cnt, float* out, float* ws,
                                int T, int N, int r, float alpha, int tq,
                                int bj, int m, int bi, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch launch = nullptr;
  for (const Instance& x : kInstances)
    if (x.tq == tq && x.bj == bj && x.m == m) launch = x.launch;
  if (launch == nullptr || bi <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_qt = (T + tq - 1) / tq;
  const int n_i = (r + bi - 1) / bi, n_j = (r + bj - 1) / bj;
  const long long blocks = static_cast<long long>(N) * n_qt * n_i * n_j;
  const long long threads = static_cast<long long>(N) * T * 32;
  if (blocks > INT_MAX || (n_i * n_j > 1 && threads > INT_MAX))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = launch(h, z, cnt, out, ws, T, N, r, alpha, bi, n_qt, n_i, n_j,
               static_cast<int>(blocks), device, st);
  if (err != cudaSuccess || n_i * n_j == 1) return static_cast<int>(err);
  const int grid =
      static_cast<int>((threads + kCombineThreads - 1) / kCombineThreads);
  block_scores_combine_kernel<<<grid, kCombineThreads, 0, st>>>(
      ws, cnt, out, T, N, n_i * n_j, alpha);
  return static_cast<int>(cudaGetLastError());
}
