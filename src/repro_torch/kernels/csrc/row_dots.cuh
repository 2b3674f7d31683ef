// Per-row dots against one query, fp32: out[g, b] = rows[g, b, :] . h[g, :]
// (raw) or  alpha * dot^2 + 1  (square).  Shared by leaf_scores.cu and
// midx_scores.cu, whose kernels score gathered rows this way and differ
// only in the rows they are given; each keeps its own __global__ entry and
// launch so that each is built, launched and counted as its own kernel.
//
// Bound on an H100: the rows are read once for 2 FLOPs per 4-byte element,
// so bytes bound every shape (3.35 TB/s): training's (32,768, 256, 128)
// 4.3 GB = 1.30 ms, serving's (4,096, 128, 128) 268 MB = 81 us, llama3-8b's
// full beam (128, 4,096, 4,096) 8.6 GB = 2.57 ms.  Keeping 3.35 TB/s busy
// at ~0.7 us of latency takes ~2.3 MB in flight, ~18 KB per SM.
//
// Design: a 1-D grid over (g, chunk of B rows); the plan
// (kernels/leaf_scores.py::plan) picks the chunk so that a few wide g
// still give several blocks per SM (llama's 128 g, one block each, left
// 4 of 132 SMs idle and kept ~4 KB in flight per SM).  A block of
// kRowWarps warps stages h[g] once in shared memory.  Each warp takes 8 / U
// rows per pass and each lane U float4 of each of them per step, so that 8
// independent 16-byte loads are in flight per lane, 32 KB per block.  Two
// variants: U = 8 at r >= 1,024 (one row per pass; llama's r = 4,096) and
// U = 1 below it (eight rows per pass, one float4 of each; the samplers'
// r = 128).  The rows are read once: streaming loads (ld.global.cs), so
// they do not evict what is reused from L2.  A shuffle reduction per row
// finishes the dot.
// Rows whose width or address does not allow 16-byte loads take a scalar
// loop, one row per warp.
#pragma once
#include <cuda_runtime.h>

#include <climits>

namespace row_dots {

constexpr int kRowWarps = 8;
constexpr int kLoads = 8;  // 16-byte loads in flight per lane

// The body of a kernel launched by `launch` below: grid G * n_chunks,
// kRowWarps * 32 threads, (r + 3) / 4 float4 of dynamic shared memory.
template <int U>
__device__ __forceinline__ void score_rows(const float* __restrict__ h,
                                           const float* __restrict__ rows,
                                           float* __restrict__ out, int B,
                                           int r, float alpha, int square,
                                           int chunk, int n_chunks, int vec) {
  constexpr int R = kLoads / U;  // rows per warp pass
  extern __shared__ float4 h_s4[];  // r floats, 16-byte aligned
  float* h_s = reinterpret_cast<float*>(h_s4);
  const int g = blockIdx.x / n_chunks;
  const int b0 = (blockIdx.x % n_chunks) * chunk;
  const int b1 = min(B, b0 + chunk);
  for (int c = threadIdx.x; c < r; c += blockDim.x)
    h_s[c] = h[static_cast<size_t>(g) * r + c];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* rows_g = rows + static_cast<size_t>(g) * B * r;
  float* out_g = out + static_cast<size_t>(g) * B;
  if (vec) {
    const int n4 = r / 4;
    for (int b = b0 + warp * R; b < b1; b += kRowWarps * R) {
      float acc[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = 0.f;
      for (int c0 = lane; c0 < n4; c0 += 32 * U) {
        float4 x[R][U];
#pragma unroll
        for (int q = 0; q < R; ++q)
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = c0 + 32 * u;
            x[q][u] = b + q < b1 && c < n4
                          ? __ldcs(reinterpret_cast<const float4*>(
                                       rows_g + static_cast<size_t>(b + q) *
                                                    r) +
                                   c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u;
          if (c < n4) {
            const float4 y = h_s4[c];
#pragma unroll
            for (int q = 0; q < R; ++q) {
              acc[q] = fmaf(x[q][u].x, y.x, acc[q]);
              acc[q] = fmaf(x[q][u].y, y.y, acc[q]);
              acc[q] = fmaf(x[q][u].z, y.z, acc[q]);
              acc[q] = fmaf(x[q][u].w, y.w, acc[q]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float s = acc[q];
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0 && b + q < b1)
          out_g[b + q] = square ? alpha * s * s + 1.f : s;
      }
    }
  } else {
    for (int b = b0 + warp; b < b1; b += kRowWarps) {
      const float* row = rows_g + static_cast<size_t>(b) * r;
      float acc = 0.f;
      for (int c = lane; c < r; c += 32)
        acc = fmaf(__ldcs(row + c), h_s[c], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) out_g[b] = square ? alpha * acc * acc + 1.f : acc;
    }
  }
}

using Kernel = void (*)(const float*, const float*, float*, int, int, float,
                        int, int, int, int);

// Launch kernels[0] (unroll 1) or kernels[1] (unroll 8), the __global__
// wrappers of score_rows<1> and <8> with the same arguments, over h: (G,
// r), rows: (G, B, r), out: (G, B), in chunks of `chunk` rows, on `stream`
// of `device`; returns the launch's cudaError_t.
inline int launch(const Kernel (&kernels)[2], const float* h,
                  const float* rows, float* out, int G, int B, int r,
                  float alpha, int square, int chunk, int unroll, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k = unroll == 1 ? 0 : unroll == kLoads ? 1 : -1;
  if (k < 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (B + chunk - 1) / chunk;
  const long long blocks = static_cast<long long>(G) * n_chunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int vec = (r % 4 == 0) &&
                  (reinterpret_cast<size_t>(rows) % 16 == 0);
  const size_t smem = (static_cast<size_t>(r) + 3) / 4 * sizeof(float4);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernels[k]),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernels[k]<<<static_cast<int>(blocks), kRowWarps * 32, smem,
               static_cast<cudaStream_t>(stream)>>>(
      h, rows, out, B, r, alpha, square, chunk, n_chunks, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace row_dots
