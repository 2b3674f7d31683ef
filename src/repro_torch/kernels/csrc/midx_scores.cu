// The midx sampler's two scoring kernels, fp32.
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
// ct[p] = c1[a1_p] + c2[a2_p] is expanded by the caller (ops.py), as the
// reference's wrapper does.
//
// Bounds on an H100 at the training shapes:
//  * pair masses, T = 256 queries, P = 512 lists, d = 128: 33.6 MFLOP and
//    0.9 MB moved, 0.5 us of operations at 67 TFLOP/s fp32 — far below a
//    launch, so the kernel is latency bound.  Design: a plain shared-memory
//    GEMM, one block of 256 threads per (32 queries x 32 lists) tile, d in
//    chunks of 32, a 2 x 2 register tile per thread, the transform and the
//    count in the epilogue.  Lists with cnt = 0 get exactly 0.
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

constexpr int kTile = 32;   // queries and lists per pair-mass block
constexpr int kDc = 32;     // width chunk staged in shared memory
constexpr int kPairThreads = 256;

__global__ void __launch_bounds__(kPairThreads)
pair_masses_kernel(const float* __restrict__ h, const float* __restrict__ ct,
                   const float* __restrict__ cnt, float* __restrict__ out,
                   int T, int P, int d, float alpha) {
  __shared__ float h_s[kDc][kTile + 1];  // [c][query]
  __shared__ float c_s[kDc][kTile + 1];  // [c][list]
  const int t0 = blockIdx.y * kTile;
  const int p0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // lists tx and tx + 16
  const int ty = tid >> 4;   // queries ty and ty + 16
  float acc[2][2] = {};
  for (int c0 = 0; c0 < d; c0 += kDc) {
    for (int i = tid; i < kTile * kDc; i += kPairThreads) {
      const int row = i / kDc, c = i % kDc, cc = c0 + c;
      const int t = t0 + row, p = p0 + row;
      h_s[c][row] = (t < T && cc < d)
                        ? __ldg(h + static_cast<size_t>(t) * d + cc) : 0.f;
      c_s[c][row] = (p < P && cc < d)
                        ? __ldg(ct + static_cast<size_t>(p) * d + cc) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kDc; ++c) {
      const float a0 = h_s[c][ty], a1 = h_s[c][ty + 16];
      const float b0 = c_s[c][tx], b1 = c_s[c][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = p0 + tx + 16 * j;
      if (p >= P) continue;
      const float dot = acc[i][j];
      out[static_cast<size_t>(t) * P + p] =
          cnt[p] * (alpha * dot * dot + 1.f);
    }
  }
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

// h: (T, d); ct: (P, d); cnt: (P,); out: (T, P) — fp32, contiguous, on
// `device`.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int midx_pair_masses_f32(const float* h, const float* ct,
                                    const float* cnt, float* out, int T,
                                    int P, int d, float alpha, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kTile - 1) / kTile, (T + kTile - 1) / kTile);
  pair_masses_kernel<<<grid, kPairThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      h, ct, cnt, out, T, P, d, alpha);
  return static_cast<int>(cudaGetLastError());
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
