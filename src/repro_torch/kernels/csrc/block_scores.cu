// Batched quadratic forms  out[t, n] = alpha * h_t^T Z_n h_t + cnt_n  (fp32).
//
// Replaces: src/repro/kernels/block_scores.py::block_scores (the Pallas
// kernel: two MXU contractions per (query tile, node tile)).  On the serving
// path it is the exact gram bound of the beam descent's dense levels
// (serve/retrieval.py::_ub_dense, alpha = 1 and cnt = 0, when gram_cap > 0).
//
// Bound on an H100 at the path's shapes (r = 128, T <= 16 queries): every
// node's Z is read once, r^2 * 4 = 64 KB, and used for only 2*T FLOPs per
// element (T/2 FLOP per byte), far below the 20 FLOP/byte where the fp32
// units would limit; the 1,022 nodes of levels 1-9 are 67 MB per decode,
// 20 us at 3.35 TB/s.  The kernel is memory bound.
//
// Simple design: one thread block per (node n, tile of up to 16 queries).
// The query tile is staged in shared memory in column chunks of kChunk =
// 1,024 (64 KB for 16 queries), so any r runs: the quadratic form splits
// over column chunks c, sum_i h_ti sum_{j in c} Z_ij h_tj.  Per chunk, 8
// warps stream the rows i of Z_n's column strip, each lane reading every
// 32nd column j (coalesced along j).  A lane keeps its partial u_t =
// sum_{j in c} Z_ij h_tj for all queries of the tile in registers and
// folds h_ti * u_t into a per-query accumulator (h_ti from the staged
// chunk when i lies in it, else from global memory), so each Z element is
// loaded once per query tile.  At r <= kChunk there is one chunk and the
// sums run in the order of the unchunked kernel.  A warp shuffle reduction
// and an 8-way shared-memory reduction finish the sum.  Vector (16-byte)
// loads, larger query tiles and TMA are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kQueries = 16;  // queries per block (T tile)
constexpr int kWarps = 8;
constexpr int kChunk = 1024;  // columns of the query tile staged at once

__global__ void block_scores_kernel(const float* __restrict__ h,
                                    const float* __restrict__ z,
                                    const float* __restrict__ cnt,
                                    float* __restrict__ out, int T, int N,
                                    int r, float alpha) {
  extern __shared__ float h_s[];  // kQueries * min(r, kChunk)
  __shared__ float red[kWarps][kQueries];
  const int n = blockIdx.x;
  const int t0 = blockIdx.y * kQueries;
  const int tq = min(kQueries, T - t0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* zn = z + static_cast<size_t>(n) * r * r;
  const float* ht = h + static_cast<size_t>(t0) * r;
  float acc[kQueries];
#pragma unroll
  for (int t = 0; t < kQueries; ++t) acc[t] = 0.f;

  for (int c0 = 0; c0 < r; c0 += kChunk) {
    const int cw = min(kChunk, r - c0);  // this chunk's width
    __syncthreads();  // the previous chunk's reads are done
    for (int e = threadIdx.x; e < kQueries * cw; e += blockDim.x) {
      const int t = e / cw;
      h_s[e] = t < tq ? ht[static_cast<size_t>(t) * r + c0 + e % cw] : 0.f;
    }
    __syncthreads();

    for (int i = warp; i < r; i += kWarps) {
      const float* zrow = zn + static_cast<size_t>(i) * r + c0;
      float u[kQueries];
#pragma unroll
      for (int t = 0; t < kQueries; ++t) u[t] = 0.f;
      for (int j = lane; j < cw; j += 32) {
        const float zij = __ldg(zrow + j);
#pragma unroll
        for (int t = 0; t < kQueries; ++t)
          u[t] = fmaf(zij, h_s[t * cw + j], u[t]);
      }
      const int ic = i - c0;
      if (ic >= 0 && ic < cw) {  // warp-uniform: row i is in this chunk
#pragma unroll
        for (int t = 0; t < kQueries; ++t)
          acc[t] = fmaf(h_s[t * cw + ic], u[t], acc[t]);
      } else {
#pragma unroll
        for (int t = 0; t < kQueries; ++t)
          acc[t] = fmaf(t < tq ? __ldg(ht + static_cast<size_t>(t) * r + i)
                               : 0.f,
                        u[t], acc[t]);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kQueries; ++t) {
    float v = acc[t];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < tq) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[static_cast<size_t>(t0 + threadIdx.x) * N + n] = alpha * s + cnt[n];
  }
}

}  // namespace

// h: (T, r); z: (N, r, r); cnt: (N,); out: (T, N) — fp32, contiguous.
// Launches on `stream` of `device`; returns the launch's cudaError_t.
extern "C" int block_scores_f32(const float* h, const float* z,
                                const float* cnt, float* out, int T, int N,
                                int r, float alpha, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(kQueries) * (r < kChunk ? r : kChunk) *
      sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(block_scores_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(N, (T + kQueries - 1) / kQueries);
  block_scores_kernel<<<grid, kWarps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      h, z, cnt, out, T, N, r, alpha);
  return static_cast<int>(cudaGetLastError());
}
