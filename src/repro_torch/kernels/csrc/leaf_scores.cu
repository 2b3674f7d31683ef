// Per-draw within-leaf scores  out[g, b] = rows[g, b, :] . h[g, :]  (dot
// mode) or  alpha * dot^2 + 1  (square mode), fp32.
//
// Replaces: src/repro/kernels/leaf_scores.py::leaf_scores (the Pallas
// kernel: an elementwise multiply and lane reduction on the VPU).  On the
// serving path its dot mode re-scores the surviving leaves exactly
// (serve/retrieval.py::leaf_topk via ops.leaf_dots); the square mode serves
// the sampler's within-leaf categorical in the training slice.
//
// Bound on an H100 at the path's shape (T = 16 queries x beam 256 leaves =
// G 4096, B = 128 rows of r = 128): 268 MB of gathered rows read for 2 FLOPs
// per 4-byte element, 80 us at 3.35 TB/s.  The kernel is memory bound.
//
// Simple design: one thread block per g, 8 warps; h[g] is staged once in
// shared memory and each warp computes whole output rows, one (g, b) row at
// a time: every lane reads 16 bytes of the row per step (float4, coalesced
// over the 512-byte row at r = 128) and a shuffle reduction finishes the
// dot.  Rows whose width or address does not allow 16-byte loads take a
// scalar loop.  Fusing the caller's wq[leaves] gather into this kernel (so
// the 268 MB copy is never written) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void leaf_scores_kernel(const float* __restrict__ h,
                                   const float* __restrict__ rows,
                                   float* __restrict__ out, int B, int r,
                                   float alpha, int square, int vec) {
  extern __shared__ float4 h_s4[];  // r floats, 16-byte aligned
  float* h_s = reinterpret_cast<float*>(h_s4);
  const int g = blockIdx.x;
  for (int c = threadIdx.x; c < r; c += blockDim.x)
    h_s[c] = h[static_cast<size_t>(g) * r + c];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kWarps) {
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

}  // namespace

// h: (G, r); rows: (G, B, r); out: (G, B) — fp32, contiguous.
// square != 0: alpha * dot^2 + 1; square == 0: raw dots (alpha ignored).
// Launches on `stream` of `device`; returns the launch's cudaError_t.
extern "C" int leaf_scores_f32(const float* h, const float* rows, float* out,
                               int G, int B, int r, float alpha, int square,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (r % 4 == 0) &&
                  (reinterpret_cast<size_t>(rows) % 16 == 0);
  const size_t smem = (static_cast<size_t>(r) + 3) / 4 * sizeof(float4);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(leaf_scores_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  leaf_scores_kernel<<<G, kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      h, rows, out, B, r, alpha, square, vec);
  return static_cast<int>(cudaGetLastError());
}
