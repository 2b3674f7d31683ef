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
// Bound on an H100 at T = 1024, m = 512, d = 128 (fp32): 2*T*m*d = 134
// MFLOP, 2.0 us at the 67 TFLOP/s fp32 rate, over 0.8 MB of inputs, 0.25
// us at 3.35 TB/s: the operations bound it.
//
// Simple design.  One thread block of 256 threads per 32-token tile, eight
// threads per token.  The block walks the negatives in tiles of 64; for
// each it stages 32-wide column chunks of the token tile's h and of the
// 64 negative rows in shared memory (fp32, padded rows to avoid bank
// conflicts), and each thread accumulates the dots of its token with 8
// negatives in registers.  The tile's adjusted logits fold into the
// token's online (max, sumexp), started at -1e30 as the Pallas scratch is
// and merged across the eight threads by shuffles; the positive logit
// joins at the end.  The (T, m) logits never leave the block.  Negatives
// past m carry no mass, so m need not be a multiple of a tile (the Pallas
// wrapper's padding with logq = 1e30 gives the same zero mass).  Tensor
// cores and keeping h resident across m tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTT = 32;                  // tokens per block
constexpr int kMT = 64;                  // negatives per tile
constexpr int kDC = 32;                  // columns per staged chunk
constexpr int kLanes = 8;                // threads per token
constexpr int kThreads = kTT * kLanes;   // 256
constexpr int kPer = kMT / kLanes;       // negatives per thread and tile
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float lanes_max(float v) {
  for (int off = 1; off < kLanes; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float lanes_sum(float v) {
  for (int off = 1; off < kLanes; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sampled_loss_kernel(const T* __restrict__ h, const T* __restrict__ w,
                        const float* __restrict__ logq,
                        const float* __restrict__ pos,
                        float* __restrict__ out, int n_tok, int m, int d,
                        float log_m) {
  __shared__ float h_s[kTT][kDC + 1];
  __shared__ float w_s[kMT][kDC + 1];
  const int t0 = blockIdx.x * kTT;
  const int tid = threadIdx.x;
  const int tok = tid / kLanes;
  const int lane = tid % kLanes;

  float m_run = kNegInit;
  float s_run = 0.f;
  for (int j0 = 0; j0 < m; j0 += kMT) {
    float acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kDC) {
      for (int idx = tid; idx < kTT * kDC; idx += kThreads) {
        const int r = idx / kDC, c = c0 + idx % kDC, t = t0 + r;
        h_s[r][idx % kDC] =
            (t < n_tok && c < d) ? to_f32(h[static_cast<size_t>(t) * d + c])
                                 : 0.f;
      }
      for (int idx = tid; idx < kMT * kDC; idx += kThreads) {
        const int r = idx / kDC, c = c0 + idx % kDC, j = j0 + r;
        w_s[r][idx % kDC] =
            (j < m && c < d) ? to_f32(w[static_cast<size_t>(j) * d + c])
                             : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDC; ++c) {
        const float a = h_s[tok][c];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          acc[i] = fmaf(a, w_s[lane + kLanes * i][c], acc[i]);
      }
      __syncthreads();
    }

    float adj[kPer];
    float tmax = kNegInit;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = j0 + lane + kLanes * i;
      adj[i] = acc[i] - (j < m ? logq[j] : 0.f) - log_m;  // eq. 2
      if (j < m) tmax = fmaxf(tmax, adj[i]);
    }
    const float m_new = fmaxf(m_run, lanes_max(tmax));
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (j0 + lane + kLanes * i < m) psum += expf(adj[i] - m_new);
    s_run = s_run * expf(m_run - m_new) + lanes_sum(psum);
    m_run = m_new;
  }

  const int t = t0 + tok;
  if (lane == 0 && t < n_tok) {
    const float p = pos[t];
    const float c = fmaxf(m_run, p);
    const float total = s_run * expf(m_run - c) + expf(p - c);
    out[t] = logf(total) + c - p;
  }
}

}  // namespace

// h: (T, d), w: (m, d) contiguous, both fp32 (bf16 = 0) or both bf16
// (bf16 = 1); logq: (m,), pos: (T,), out: (T,) fp32; log_m = log(m_total).
// Launches on `stream` of `device`; returns the launch's cudaError_t.
extern "C" int sampled_loss_fwd(const void* h, const void* w,
                                const float* logq, const float* pos,
                                float* out, int T, int m, int d, float log_m,
                                int bf16, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kTT - 1) / kTT);
  if (bf16)
    sampled_loss_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(w), logq, pos, out, T, m, d,
        log_m);
  else
    sampled_loss_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), logq,
        pos, out, T, m, d, log_m);
  return static_cast<int>(cudaGetLastError());
}
