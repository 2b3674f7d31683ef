// Per-row dots against one query, fp32: out[g, b] = rows[g, b, :] . h[g, :]
// (raw) or  alpha * dot^2 + 1  (square).  Shared by leaf_scores.cu and
// midx_scores.cu, whose kernels score gathered rows this way and differ
// only in the rows they are given; each keeps its own __global__ entry and
// launch so that each is built, launched and counted as its own kernel.
//
// Design: one thread block of kRowWarps warps per g; h[g] is staged once in
// shared memory and each warp computes whole output rows, one (g, b) row at
// a time: every lane reads 16 bytes of the row per step (float4, coalesced
// over the 512-byte row at r = 128) and a shuffle reduction finishes the
// dot.  Rows whose width or address does not allow 16-byte loads take a
// scalar loop.  The work is bound by the bytes of the rows.
#pragma once
#include <cuda_runtime.h>

namespace row_dots {

constexpr int kRowWarps = 8;

// The body of a kernel launched by `launch` below: grid G, kRowWarps * 32
// threads, (r + 3) / 4 float4 of dynamic shared memory.
__device__ __forceinline__ void score_rows(const float* __restrict__ h,
                                           const float* __restrict__ rows,
                                           float* __restrict__ out, int B,
                                           int r, float alpha, int square,
                                           int vec) {
  extern __shared__ float4 h_s4[];  // r floats, 16-byte aligned
  float* h_s = reinterpret_cast<float*>(h_s4);
  const int g = blockIdx.x;
  for (int c = threadIdx.x; c < r; c += blockDim.x)
    h_s[c] = h[static_cast<size_t>(g) * r + c];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kRowWarps) {
    const float* row = rows + (static_cast<size_t>(g) * B + b) * r;
    float acc = 0.f;
    if (vec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (int c = lane; c < r / 4; c += 32) {
        const float4 x = __ldg(row4 + c);
        const float4 y = h_s4[c];
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    } else {
      for (int c = lane; c < r; c += 32)
        acc = fmaf(__ldg(row + c), h_s[c], acc);
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0)
      out[static_cast<size_t>(g) * B + b] =
          square ? alpha * acc * acc + 1.f : acc;
  }
}

using Kernel = void (*)(const float*, const float*, float*, int, int, float,
                        int, int);

// Launch `kernel` (a __global__ wrapper of score_rows with the same
// arguments) over h: (G, r), rows: (G, B, r), out: (G, B) on `stream` of
// `device`; returns the launch's cudaError_t.
inline int launch(Kernel kernel, const float* h, const float* rows,
                  float* out, int G, int B, int r, float alpha, int square,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (r % 4 == 0) &&
                  (reinterpret_cast<size_t>(rows) % 16 == 0);
  const size_t smem = (static_cast<size_t>(r) + 3) / 4 * sizeof(float4);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<G, kRowWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      h, rows, out, B, r, alpha, square, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace row_dots
