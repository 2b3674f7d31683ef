// Per-block Gram matrices  Z_b = W_b^T W_b  (fp32).
//
// Replaces: src/repro/kernels/zstats.py::zstats (the Pallas kernel, one MXU
// contraction per class block).  On the serving path it computes the
// retrieval index build's leaf Grams (core/hierarchy.py::build).
//
// Bound on an H100 at the path's shape (1024 leaves, B = 128, r = 128):
// 67 MB read + 67 MB written = 40 us at 3.35 TB/s.  Z_b is symmetric, so
// the function needs only r(r+1)/2 distinct dots: 1024*128*128*129 =
// 2.2 GFLOP = 32 us at the 67 TFLOP/s fp32 (non-tensor-core) rate.  The
// floor is memory traffic; this kernel computes all r^2 entries (4.3
// GFLOP, 64 us of fp32 FMA), so its own FMA work sits above that floor.
//
// Simple design: one thread block per (class block b, 32x32 output tile).
// The block walks the B class rows in chunks of 32, staging the two 32-wide
// column strips of W_b in shared memory (coalesced along r), and each of
// the 256 threads keeps 4 outputs of the tile in registers (fp32 FMA).  The
// strip element a[k][i] is a warp-wide broadcast and b[k][j] is read
// conflict-free, so each FMA costs ~1.25 shared loads.  Tensor cores
// (wgmma, TMA) and exploiting the symmetry of Z are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;   // output tile edge; also blockDim.x
constexpr int kRows = 8;    // blockDim.y; a thread owns kTile / kRows outputs
constexpr int kChunk = 32;  // class rows staged per shared-memory chunk

__global__ void zstats_kernel(const float* __restrict__ w,
                              float* __restrict__ z, int rows, int r) {
  __shared__ float a_s[kChunk][kTile];
  __shared__ float b_s[kChunk][kTile];
  const int blk = blockIdx.x;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.z * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const float* wb = w + static_cast<size_t>(blk) * rows * r;

  float acc[kTile / kRows];
#pragma unroll
  for (int q = 0; q < kTile / kRows; ++q) acc[q] = 0.f;

  for (int k0 = 0; k0 < rows; k0 += kChunk) {
    for (int kk = ty; kk < kChunk; kk += kRows) {
      const int k = k0 + kk;
      const float* wrow = wb + static_cast<size_t>(k) * r;
      a_s[kk][tx] = (k < rows && i0 + tx < r) ? wrow[i0 + tx] : 0.f;
      b_s[kk][tx] = (k < rows && j0 + tx < r) ? wrow[j0 + tx] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      const float b = b_s[kk][tx];
#pragma unroll
      for (int q = 0; q < kTile / kRows; ++q)
        acc[q] = fmaf(a_s[kk][ty + q * kRows], b, acc[q]);
    }
    __syncthreads();
  }

  const int j = j0 + tx;
#pragma unroll
  for (int q = 0; q < kTile / kRows; ++q) {
    const int i = i0 + ty + q * kRows;
    if (i < r && j < r)
      z[(static_cast<size_t>(blk) * r + i) * r + j] = acc[q];
  }
}

}  // namespace

// w: (n_blocks, rows, r) fp32 contiguous; z: (n_blocks, r, r) fp32.
// Launches on `stream` of `device`; returns the launch's cudaError_t.
extern "C" int zstats_f32(const float* w, float* z, int n_blocks, int rows,
                          int r, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (r + kTile - 1) / kTile;
  dim3 grid(n_blocks, tiles, tiles);
  dim3 block(kTile, kRows);
  zstats_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      w, z, rows, r);
  return static_cast<int>(cudaGetLastError());
}
