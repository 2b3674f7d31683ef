// Masked per-leaf sums of positive random features, fp32:
//
//   out[l, k] = D^{-1/2} * sum_b mask[l, b] *
//               exp(<omega_k, w[l, b]> / sqrt(tau) - |w[l, b]|^2 / (2 tau)
//                   - logshift)
//
// Replaces: src/repro/kernels/rff_features.py::rff_features (the Pallas
// kernel: one MXU contraction per (leaf tile, feature tile), exp and mask on
// the VPU, a reduction over the leaf axis).  The rff sampler's refresh
// (core/hierarchy.py::build_features) builds the leaf level of its
// feature-sum tree through it, once per refresh.
//
// Bound on an H100 at the training shape (L = 512 leaves of B = 256 rows,
// d = 128, D = 128 features): L*B*D*d = 2.1 G fp32 FMAs (4.3 GFLOP), 64 us
// at 67 TFLOP/s without the tensor cores, against 67 MB read (20 us at 3.35
// TB/s).  The kernel is bound by operations.
//
// Simple design: the function is a (L*B, d) x (d, D) product whose epilogue
// (exp, mask, sum over each leaf's B rows) never leaves the block, so the
// (L*B, D) feature matrix is never written.  One block of 256 threads per
// (leaf, tile of 64 features) walks its leaf's rows 64 at a time; each
// (64 rows x 64 features) tile is a shared-memory GEMM over d in chunks of
// 32, every thread holding a 4 x 4 register tile.  The squared row norms
// ride along on the staged row chunks.  After a tile's dots, each thread
// adds exp(...) * mask of its 4 rows into 4 per-feature partial sums; the
// 16 row groups are summed through shared memory at the end.  Ragged rows,
// features and widths are masked (zero-filled) in the loads.  logshift is
// read from device memory, so the caller never syncs on it.  expf, not
// __expf: the plain version is held at 1e-5.  Tensor cores (TF32 would
// lose the digits the exp amplifies; 3xTF32 keeps them) are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;   // rows of a leaf per tile
constexpr int kFeat = 64;   // features per block
constexpr int kDc = 32;     // width chunk staged in shared memory
constexpr int kPad = 4;     // keeps the float4 reads 16-byte aligned
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rff_features_kernel(const float* __restrict__ w,
                    const float* __restrict__ omega,
                    const float* __restrict__ mask,
                    const float* __restrict__ logshift,
                    float* __restrict__ out, int B, int d, int D,
                    float inv_sqrt_tau, float inv_2tau, float inv_sqrt_d) {
  __shared__ __align__(16) float w_s[kDc][kRows + kPad];   // [c][row]
  __shared__ __align__(16) float om_s[kDc][kFeat + kPad];  // [c][feature]
  __shared__ float nrm_s[kRows];
  __shared__ float mask_s[kRows];
  __shared__ float red_s[kThreads / 16][kFeat];

  const int l = blockIdx.x;
  const int k0 = blockIdx.y * kFeat;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // features tx*4 .. tx*4+3
  const int ty = tid >> 4;   // rows ty*4 .. ty*4+3
  const float shift = *logshift;
  const float* wl = w + static_cast<size_t>(l) * B * d;

  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = 0; b0 < B; b0 += kRows) {
    float acc[4][4] = {};
    float nrm = 0.f;  // thread tid < kRows: squared norm of row b0 + tid
    for (int c0 = 0; c0 < d; c0 += kDc) {
      for (int i = tid; i < kRows * kDc; i += kThreads) {
        const int row = i / kDc, c = i % kDc;
        const int b = b0 + row, cc = c0 + c;
        w_s[c][row] = (b < B && cc < d)
                          ? __ldg(wl + static_cast<size_t>(b) * d + cc)
                          : 0.f;
      }
      for (int i = tid; i < kFeat * kDc; i += kThreads) {
        const int f = i / kDc, c = i % kDc;
        const int k = k0 + f, cc = c0 + c;
        om_s[c][f] = (k < D && cc < d)
                         ? __ldg(omega + static_cast<size_t>(k) * d + cc)
                         : 0.f;
      }
      __syncthreads();
      if (tid < kRows) {
        for (int c = 0; c < kDc; ++c) nrm = fmaf(w_s[c][tid], w_s[c][tid], nrm);
      }
#pragma unroll 8
      for (int c = 0; c < kDc; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&w_s[c][ty * 4]);
        const float4 o = *reinterpret_cast<const float4*>(&om_s[c][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], ov[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < kRows) {
      const int b = b0 + tid;
      nrm_s[tid] = nrm;
      mask_s[tid] = b < B ? mask[static_cast<size_t>(l) * B + b] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const float base = nrm_s[row] * inv_2tau + shift;
      const float mk = mask_s[row];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[j] += expf(acc[i][j] * inv_sqrt_tau - base) * mk;
    }
    __syncthreads();  // nrm_s / mask_s are rewritten by the next row tile
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) red_s[ty][tx * 4 + j] = part[j];
  __syncthreads();
  if (tid < kFeat && k0 + tid < D) {
    float s = 0.f;
    for (int g = 0; g < kThreads / 16; ++g) s += red_s[g][tid];
    out[static_cast<size_t>(l) * D + k0 + tid] = s * inv_sqrt_d;
  }
}

}  // namespace

// w: (L, B, d); omega: (D, d); mask: (L, B); logshift: one float; out:
// (L, D) — fp32, contiguous, on `device`.  inv_sqrt_d = D_total^{-1/2}.
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int rff_features_f32(const float* w, const float* omega,
                                const float* mask, const float* logshift,
                                float* out, int L, int B, int d, int D,
                                float inv_sqrt_tau, float inv_2tau,
                                float inv_sqrt_d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L, (D + kFeat - 1) / kFeat);
  rff_features_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      w, omega, mask, logshift, out, B, d, D, inv_sqrt_tau, inv_2tau,
      inv_sqrt_d);
  return static_cast<int>(cudaGetLastError());
}
