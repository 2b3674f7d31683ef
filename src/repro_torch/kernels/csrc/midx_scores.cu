// The midx sampler's two scoring kernels.
//
// midx_pair_masses:   out[t, p] = cnt[p] * (alpha * <h[t], ct[p]>^2 + 1)
// midx_member_scores: out[g, l] = alpha * <rows[g, l], h[g]>^2 + 1
//
// Replace: src/repro/kernels/midx_scores.py::midx_pair_masses (stage 1: one
// MXU contraction h @ ct^T per (query tile, list tile), the kernel transform
// and the count multiply fused behind it) and ::midx_member_scores (stage
// 2: a VPU-batched matvec over each draw's gathered posting list).  The
// sampler (core/midx.py) calls each once per sampling step: stage 1 scores
// every posting list for every query, stage 2 the lists that were drawn.
//
// Stage 1 has two entry points over one kernel: midx_pair_masses takes the
// pair-expanded codewords ct (P, d), as the Pallas kernel does;
// midx_list_masses takes c1, c2 and codes (P, 2) and forms each row
// ct[p] = c1[codes[p, 0]] + c2[codes[p, 1]] (in fp32) while staging it, so
// the caller's expansion (two index casts, two gathers and an add) is gone
// (kernels/ops.py::midx_list_masses uses it).  Both read fp32 or bf16
// inputs and accumulate in fp32, as the Pallas kernel casts what it loads.
//
// Bounds on an H100 at the training shapes:
//  * pair masses, T = 256 queries, P = 512 lists, d = 128: 33.6 MFLOP and
//    0.9 MB moved, 0.5 us of operations at 67 TFLOP/s fp32: far below a
//    launch, so the kernel is latency bound: what counts is how many
//    dependent round trips a block makes and how long its FMA chain is.
//    Design: a block of 8 warps per (32 queries x 32 lists) tile, 128
//    blocks at this shape (16-query tiles, 256 blocks, were slower through
//    both entries on an H100).  Every 16-byte load of the tile's h rows
//    and codeword rows (128 columns of each per round; one round at
//    d <= 128) is issued before any is used, converted to fp32 and stored
//    behind one barrier into rows 16 bytes apart in the banks; the codes
//    entry reads its lists' codes first, one dependent round trip more.
//    The 8 warps split the round's columns, 16 each, and each lane keeps
//    an 8 x 4 register tile of its warp's partial dots (queries 4 apart,
//    lists 8 apart: a float4 read of shared memory serves 4 or 8 lanes).
//    The 8 partials of each output are added in warp order (a fixed
//    order: every run gives the same bits), and the epilogue writes
//    cnt * (alpha * dot^2 + 1) with 16-byte stores.  Lists with cnt = 0
//    get exactly 0.  Widths or addresses that do not allow 16-byte loads
//    take scalar loads into the same layout.
//  * member scores, G = T*m = 32,768 draws of L = 256 rows, d = 128: 4.3 GB
//    of gathered rows read for 2 FLOPs per 4-byte element, 1.28 ms at 3.35
//    TB/s — bound by bytes.  Design: leaf_scores' square mode, whose body
//    and plan it shares (row_dots.cuh): a block per (draw, chunk of rows),
//    h[g] staged in shared memory, each warp eight rows per pass with one
//    16-byte streaming load of each in flight per lane, a shuffle
//    reduction per row.  Reading the rows of wq in place, instead of the
//    caller's gathered copy, removes the copy and most of the bound:
//    later work.
#include <cuda_runtime.h>

#include "row_dots.cuh"

namespace {

constexpr int kPairThreads = 256;
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kTq = 32;              // queries per pair-mass block
constexpr int kTp = 32;              // lists per pair-mass block
constexpr int kDc = 128;             // columns staged per round
constexpr int kStride = kDc + 4;     // staged row stride, floats
constexpr int kRedStride = kTp + 8;  // partial-dot row stride, floats
constexpr int kWarpCols = kDc / kPairWarps;  // 16 columns a warp per round

// Element e (of 16 / kB) of a 16-byte unit as fp32: kB = 4 fp32 words,
// kB = 2 bf16 halves (the low half first).
template <int kB>
__device__ __forceinline__ float unit_elem(const uint4& u, int e) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  if (kB == 4) return __uint_as_float(w[e]);
  const unsigned x = w[e >> 1];
  return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
}

// The 16 bytes of row `row` (width d elements of kB bytes) from column
// `col` (a multiple of 16 / kB); elements past d, and the whole unit when
// !valid, are zero.  kVec: d is a multiple of 16 / kB and the base is 16-
// byte aligned, so one load; else one load per element.
template <int kB, bool kVec>
__device__ __forceinline__ uint4 load_unit(const void* base, long long row,
                                           int col, int d, bool valid) {
  constexpr int kN = 16 / kB;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (!valid || col >= d) return u;
  const char* p = static_cast<const char*>(base) + (row * d + col) * kB;
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    if (col + e >= d) break;
    if (kB == 4) {
      w[e] = __ldg(reinterpret_cast<const unsigned*>(p) + e);
    } else {
      const unsigned x = __ldg(reinterpret_cast<const unsigned short*>(p) + e);
      w[e >> 1] |= (e & 1) ? (x << 16) : x;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage-1 masses of one (kTq queries x kTp lists) tile.  kB: bytes per
// input element (4 fp32, 2 bf16); kCodes: rows are c1[codes[p, 0]] +
// c2[codes[p, 1]] (else ct = c1); kVec: 16-byte loads.
template <int kB, bool kCodes, bool kVec>
__global__ void __launch_bounds__(kPairThreads)
pair_masses_kernel(const void* __restrict__ h, const void* __restrict__ c1,
                   const void* __restrict__ c2, const int* __restrict__ codes,
                   const float* __restrict__ cnt, float* __restrict__ out,
                   int T, int P, int d, float alpha) {
  constexpr int kN = 16 / kB;                   // elements per 16-byte unit
  constexpr int kUnitsRow = kDc / kN;           // units per staged row
  constexpr int kUnits = (kTq + kTp) * kUnitsRow;
  static_assert(kUnits % kPairThreads == 0, "units split evenly");
  constexpr int kPer = kUnits / kPairThreads;   // units per thread
  constexpr int kMq = kTq / 4;                   // queries per lane
  // the staged rows, later reused for the warps' partial dots
  constexpr int kStaged = (kTq + kTp) * kStride;
  constexpr int kPartials = kPairWarps * kTq * kRedStride;
  __shared__ __align__(16) float smem[kStaged > kPartials ? kStaged
                                                          : kPartials];

  const int tid = threadIdx.x;
  const int t0 = blockIdx.y * kTq;
  const int p0 = blockIdx.x * kTp;
  const int warp = tid >> 5, lane = tid & 31;
  const int qg = lane & 3;   // queries qg + 4i
  const int pg = lane >> 2;  // lists pg + 8j

  // Each thread's units: unit tid + k * kPairThreads, row-major over the
  // (kTq + kTp) staged rows, h's rows first.  A list row's codes are read
  // once per round, before its codeword loads.
  int a1[kPer], a2[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int row = (tid + k * kPairThreads) / kUnitsRow;
    const int p = p0 + row - kTq;
    a1[k] = a2[k] = 0;
    if (row >= kTq && p < P) {
      if (kCodes) {
        a1[k] = __ldg(codes + 2 * static_cast<long long>(p));
        a2[k] = __ldg(codes + 2 * static_cast<long long>(p) + 1);
      } else {
        a1[k] = p;
      }
    }
  }

  float acc[kMq][4];
#pragma unroll
  for (int i = 0; i < kMq; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < d; c0 += kDc) {
    // every load of the round in flight before any is used
    uint4 ua[kPer], ub[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int unit = tid + k * kPairThreads;
      const int row = unit / kUnitsRow;
      const int col = c0 + (unit % kUnitsRow) * kN;
      if (row < kTq) {
        ua[k] = load_unit<kB, kVec>(h, t0 + row, col, d, t0 + row < T);
        ub[k] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        const bool ok = p0 + row - kTq < P;
        ua[k] = load_unit<kB, kVec>(c1, a1[k], col, d, ok);
        ub[k] = kCodes ? load_unit<kB, kVec>(c2, a2[k], col, d, ok)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();  // the previous round's reads of smem are done
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int unit = tid + k * kPairThreads;
      const int row = unit / kUnitsRow;
      float* dst = smem + row * kStride + (unit % kUnitsRow) * kN;
      const bool sum = kCodes && row >= kTq;
#pragma unroll
      for (int e = 0; e < kN; e += 4) {
        float4 v;
        v.x = unit_elem<kB>(ua[k], e);
        v.y = unit_elem<kB>(ua[k], e + 1);
        v.z = unit_elem<kB>(ua[k], e + 2);
        v.w = unit_elem<kB>(ua[k], e + 3);
        if (sum) {
          v.x += unit_elem<kB>(ub[k], e);
          v.y += unit_elem<kB>(ub[k], e + 1);
          v.z += unit_elem<kB>(ub[k], e + 2);
          v.w += unit_elem<kB>(ub[k], e + 3);
        }
        *reinterpret_cast<float4*>(dst + e) = v;
      }
    }
    __syncthreads();
    const float* hs = smem;
    const float* cs = smem + kTq * kStride;
#pragma unroll
    for (int s = 0; s < kWarpCols; s += 4) {
      const int col = warp * kWarpCols + s;
      float4 a[kMq], b[4];
#pragma unroll
      for (int i = 0; i < kMq; ++i)
        a[i] = *reinterpret_cast<const float4*>(hs + (qg + 4 * i) * kStride
                                                + col);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(cs + (pg + 8 * j) * kStride
                                                + col);
#pragma unroll
      for (int i = 0; i < kMq; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }

  // the warps' partial dots, then their sum in warp order
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int i = 0; i < kMq; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(warp * kTq + qg + 4 * i) * kRedStride + pg + 8 * j] = acc[i][j];
  __syncthreads();
  if (tid >= kTq * (kTp / 4)) return;
  const int q = tid / (kTp / 4);
  const int pc = (tid % (kTp / 4)) * 4;
  const int t = t0 + q, p = p0 + pc;
  if (t >= T || p >= P) return;
  float4 dot = *reinterpret_cast<const float4*>(red + q * kRedStride + pc);
#pragma unroll
  for (int w = 1; w < kPairWarps; ++w) {
    const float4 v = *reinterpret_cast<const float4*>(
        red + (w * kTq + q) * kRedStride + pc);
    dot.x += v.x;
    dot.y += v.y;
    dot.z += v.z;
    dot.w += v.w;
  }
  const float dots[4] = {dot.x, dot.y, dot.z, dot.w};
  float m[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    m[e] = p + e < P ? __ldg(cnt + p + e) * (alpha * dots[e] * dots[e] + 1.f)
                     : 0.f;
  float* o = out + static_cast<long long>(t) * P + p;
  if ((P & 3) == 0) {  // rows 16-byte aligned, and p + 3 < P
    *reinterpret_cast<float4*>(o) = make_float4(m[0], m[1], m[2], m[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p + e < P) o[e] = m[e];
  }
}

using PairKernel = void (*)(const void*, const void*, const void*,
                            const int*, const float*, float*, int, int, int,
                            float);

template <bool kCodes>
int launch_pair(const void* h, const void* c1, const void* c2,
                const int* codes, const float* cnt, float* out, int T, int P,
                int d, float alpha, int elem_bytes, int vec, int grid_t,
                int grid_p, int device, void* stream) {
  if ((elem_bytes != 4 && elem_bytes != 2) ||
      static_cast<long long>(grid_t) * kTq < T ||
      static_cast<long long>(grid_p) * kTp < P)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PairKernel k =
      elem_bytes == 4 ? (vec ? pair_masses_kernel<4, kCodes, true>
                             : pair_masses_kernel<4, kCodes, false>)
                      : (vec ? pair_masses_kernel<2, kCodes, true>
                             : pair_masses_kernel<2, kCodes, false>);
  k<<<dim3(grid_p, grid_t), kPairThreads, 0,
       static_cast<cudaStream_t>(stream)>>>(h, c1, c2, codes, cnt, out, T, P,
                                            d, alpha);
  return static_cast<int>(cudaGetLastError());
}

template <int U>
__global__ void member_scores_kernel(const float* __restrict__ h,
                                     const float* __restrict__ rows,
                                     float* __restrict__ out, int L, int d,
                                     float alpha, int square, int chunk,
                                     int n_chunks, int vec) {
  row_dots::score_rows<U>(h, rows, out, L, d, alpha, square, chunk, n_chunks,
                          vec);
}

}  // namespace

// h: (T, d); ct: (P, d), h's type; cnt: (P,) fp32; out: (T, P) fp32 —
// contiguous, on `device`; elem_bytes 4 (fp32) or 2 (bf16); vec: d and
// the value pointers allow 16-byte loads; grid_t x grid_p blocks of kTq x
// kTp outputs (kernels/midx_scores.py::plan).  Launches on `stream`;
// returns the launch's cudaError_t.
extern "C" int midx_pair_masses_f32(const void* h, const void* ct,
                                    const float* cnt, float* out, int T,
                                    int P, int d, float alpha, int elem_bytes,
                                    int vec, int grid_t, int grid_p,
                                    int device, void* stream) {
  return launch_pair<false>(h, ct, nullptr, nullptr, cnt, out, T, P, d,
                            alpha, elem_bytes, vec, grid_t, grid_p, device,
                            stream);
}

// As midx_pair_masses_f32, with ct[p] = c1[codes[p, 0]] + c2[codes[p, 1]]
// formed in the kernel: c1 (K1, d) and c2 (K2, d) of h's type, codes
// (P, 2) int32 indexing them.
extern "C" int midx_list_masses_f32(const void* h, const void* c1,
                                    const void* c2, const int* codes,
                                    const float* cnt, float* out, int T,
                                    int P, int d, float alpha, int elem_bytes,
                                    int vec, int grid_t, int grid_p,
                                    int device, void* stream) {
  return launch_pair<true>(h, c1, c2, codes, cnt, out, T, P, d, alpha,
                           elem_bytes, vec, grid_t, grid_p, device, stream);
}

// h: (G, d); rows: (G, L, d); out: (G, L) — fp32, contiguous, on `device`;
// chunk and unroll from kernels/leaf_scores.py::plan.  Launches on
// `stream`; returns the launch's cudaError_t.
extern "C" int midx_member_scores_f32(const float* h, const float* rows,
                                      float* out, int G, int L, int d,
                                      float alpha, int chunk, int unroll,
                                      int device, void* stream) {
  static const row_dots::Kernel kernels[2] = {member_scores_kernel<1>,
                                              member_scores_kernel<8>};
  return row_dots::launch(kernels, h, rows, out, G, L, d, alpha,
                          /*square=*/1, chunk, unroll, device, stream);
}
