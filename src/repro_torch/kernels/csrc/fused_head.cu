// Fused sampled-softmax head: per-token corrected logsumexp and its VJP.
//
//   lse[t]   = logsumexp_k adj[t, k],
//   adj[t,k] = f(<h_t, w[ids[t,k]]> + biasg[t,k]) - corr[t,k],
//   f = identity, or |.| in abs mode,
//
// over K = 1 + m gathered head rows per token (slot 0 the label, slots
// 1..m the sampled negatives; corr = 1e30 masks a slot to zero mass).
//
// Replaces: src/repro/kernels/fused_head.py::fused_lse (forward) and
// ::fused_lse_bwd (backward), Pallas kernels over a sequential (T, K) grid
// that fetch one head row per step.  On the training path they are the loss
// of every step (core/sampled_softmax.py::_fused_from_embeddings through
// kernels/ops.py::fused_head_lse).
//
// Bound on an H100 at the training shape (T = 256 tokens, K = 129, d = 128,
// a 100,000-row head): the forward reads at most T*K rows of 512 B, 17 MB,
// 5 us at 3.35 TB/s, for 2 FLOPs per element: memory bound.  The backward
// reads the same rows and writes the dense (n, d) dL/dw, 51 MB, which
// the wrapper zero-fills first: about 20 us.
//
// Simple design.  One thread block per token, 8 warps; h_t is staged once in
// shared memory.  Each warp walks every 8th slot, two slots at a time so
// two row loads are in flight: every lane reads 16 bytes of the row
// (float4, coalesced over the 512-byte row at d = 128) and a shuffle
// reduction finishes the dot.  The forward folds each slot into an online
// (max, sumexp) pair in registers, started at -1e30 as the Pallas kernel's
// scratch is, so a masked slot gives exp(-1e30 - m) = 0 and never
// exp(-inf + inf) = NaN; the 8 warps' pairs merge in shared memory.  The
// backward recomputes adj, forms p = exp(adj - lse[t]) * gbar[t], writes
// dcorr = -p (corr applies after |.|), chains sign(o) in abs mode, writes
// dcoef = p, accumulates p * row into a per-warp dh_t strip in shared
// memory and scatters p * h_t into dL/dw with fp32 atomicAdd: ids repeat
// within a token (draws with replacement) and across tokens (one token's
// label is another's negative), and the atomics add every repeat.  Their
// order, and so the low bits of dL/dw, varies from run to run; a sorted,
// segmented (deterministic) reduction is later work.  Slots with p == 0
// (masked) skip the scatter.  Rows whose width or address does not allow
// 16-byte loads take a scalar loop.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This lane's part of <row, h>; h_s is 16-byte aligned shared memory.
__device__ __forceinline__ float part_dot(const float* __restrict__ row,
                                          const float* h_s, int d, int vec,
                                          int lane) {
  float acc = 0.f;
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float4* h4 = reinterpret_cast<const float4*>(h_s);
    for (int c = lane; c < d / 4; c += 32) {
      const float4 x = __ldg(row4 + c);
      const float4 y = h4[c];
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  } else {
    for (int c = lane; c < d; c += 32) acc = fmaf(__ldg(row + c), h_s[c], acc);
  }
  return acc;
}

// jnp.sign: -1, 0 or +1 (and NaN for NaN).
__device__ __forceinline__ float sign_of(float o) {
  return o > 0.f ? 1.f : (o < 0.f ? -1.f : o);
}

__device__ __forceinline__ void stage_h(const float* __restrict__ h,
                                        float* h_s, int t, int d) {
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    h_s[c] = h[static_cast<size_t>(t) * d + c];
}

__global__ void fused_lse_kernel(const float* __restrict__ w,
                                 const float* __restrict__ h,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ corr,
                                 const float* __restrict__ biasg,
                                 float* __restrict__ lse, int K, int d,
                                 int abs_mode, int vec) {
  extern __shared__ float4 smem4[];  // h_t: d floats, 16-byte aligned
  float* h_s = reinterpret_cast<float*>(smem4);
  __shared__ float m_s[kWarps];
  __shared__ float s_s[kWarps];
  const int t = blockIdx.x;
  stage_h(h, h_s, t, d);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(t) * K;
  float m = kNegInf, s = 0.f;
  for (int k0 = warp; k0 < K; k0 += 2 * kWarps) {
    const int k1 = k0 + kWarps;
    const bool two = k1 < K;
    float dot0 = part_dot(w + static_cast<size_t>(ids[base + k0]) * d, h_s,
                          d, vec, lane);
    float dot1 = two ? part_dot(w + static_cast<size_t>(ids[base + k1]) * d,
                                h_s, d, vec, lane)
                     : 0.f;
    dot0 = warp_sum(dot0);
    dot1 = warp_sum(dot1);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      const int k = u == 0 ? k0 : k1;
      const float o = (u == 0 ? dot0 : dot1) + biasg[base + k];
      const float adj = (abs_mode ? fabsf(o) : o) - corr[base + k];
      const float m_new = fmaxf(m, adj);
      s = s * expf(m - m_new) + expf(adj - m_new);
      m = m_new;
    }
  }
  if (lane == 0) {
    m_s[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = kNegInf, ss = 0.f;
    for (int v = 0; v < kWarps; ++v) {
      const float m_new = fmaxf(mm, m_s[v]);
      ss = ss * expf(mm - m_new) + s_s[v] * expf(m_s[v] - m_new);
      mm = m_new;
    }
    lse[t] = logf(ss) + mm;
  }
}

// One slot of the backward, for a warp that holds the slot's full dot.
__device__ __forceinline__ void bwd_slot(
    const float* __restrict__ row, float* __restrict__ dw_row,
    const float* h_s, float* dh_w, float dot, size_t slot,
    const float* __restrict__ corr, const float* __restrict__ biasg,
    float* __restrict__ dcoef, float* __restrict__ dcorr, float lse_t,
    float g_t, int d, int abs_mode, int vec, int lane) {
  const float o = dot + biasg[slot];
  const float adj = (abs_mode ? fabsf(o) : o) - corr[slot];
  float p = expf(adj - lse_t) * g_t;
  if (lane == 0) dcorr[slot] = -p;  // corr applies after |.|: unsigned
  if (abs_mode) p *= sign_of(o);
  if (lane == 0) dcoef[slot] = p;
  if (p == 0.f) return;  // masked slot: nothing to add
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float4* h4 = reinterpret_cast<const float4*>(h_s);
    float4* dh4 = reinterpret_cast<float4*>(dh_w);
    for (int c = lane; c < d / 4; c += 32) {
      const float4 x = __ldg(row4 + c);
      const float4 y = h4[c];
      float4 a = dh4[c];
      a.x = fmaf(p, x.x, a.x);
      a.y = fmaf(p, x.y, a.y);
      a.z = fmaf(p, x.z, a.z);
      a.w = fmaf(p, x.w, a.w);
      dh4[c] = a;
      atomicAdd(dw_row + 4 * c + 0, p * y.x);
      atomicAdd(dw_row + 4 * c + 1, p * y.y);
      atomicAdd(dw_row + 4 * c + 2, p * y.z);
      atomicAdd(dw_row + 4 * c + 3, p * y.w);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      dh_w[c] = fmaf(p, __ldg(row + c), dh_w[c]);
      atomicAdd(dw_row + c, p * h_s[c]);
    }
  }
}

__global__ void fused_lse_bwd_kernel(
    const float* __restrict__ w, const float* __restrict__ h,
    const int* __restrict__ ids, const float* __restrict__ corr,
    const float* __restrict__ biasg, const float* __restrict__ lse,
    const float* __restrict__ gbar, float* __restrict__ dw,
    float* __restrict__ dh, float* __restrict__ dcoef,
    float* __restrict__ dcorr, int K, int d, int dp, int abs_mode, int vec) {
  // h_t (dp floats) then one dh_t strip per warp (dp floats each); dp is d
  // rounded up to a multiple of 4, so every strip is 16-byte aligned.
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);
  float* dh_s = h_s + dp;
  const int t = blockIdx.x;
  stage_h(h, h_s, t, d);
  for (int c = threadIdx.x; c < kWarps * dp; c += blockDim.x) dh_s[c] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* dh_w = dh_s + warp * dp;
  const size_t base = static_cast<size_t>(t) * K;
  const float lse_t = lse[t];
  const float g_t = gbar[t];
  for (int k0 = warp; k0 < K; k0 += 2 * kWarps) {
    const int k1 = k0 + kWarps;
    const bool two = k1 < K;
    const size_t id0 = static_cast<size_t>(ids[base + k0]);
    const size_t id1 = two ? static_cast<size_t>(ids[base + k1]) : 0;
    float dot0 = part_dot(w + id0 * d, h_s, d, vec, lane);
    float dot1 = two ? part_dot(w + id1 * d, h_s, d, vec, lane) : 0.f;
    dot0 = warp_sum(dot0);
    dot1 = warp_sum(dot1);
    bwd_slot(w + id0 * d, dw + id0 * d, h_s, dh_w, dot0, base + k0, corr,
             biasg, dcoef, dcorr, lse_t, g_t, d, abs_mode, vec, lane);
    if (two)
      bwd_slot(w + id1 * d, dw + id1 * d, h_s, dh_w, dot1, base + k1, corr,
               biasg, dcoef, dcorr, lse_t, g_t, d, abs_mode, vec, lane);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) acc += dh_s[v * dp + c];
    dh[static_cast<size_t>(t) * d + c] = acc;
  }
}

int vec_ok(const float* w, int d) {
  return (d % 4 == 0) && (reinterpret_cast<size_t>(w) % 16 == 0);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// w: (n, d); h: (T, d); ids: (T, K) int32; corr, biasg: (T, K); lse: (T,)
// — fp32 unless stated, contiguous.  Launches on `stream` of `device`;
// returns the launch's cudaError_t.
extern "C" int fused_lse_f32(const float* w, const float* h, const int* ids,
                             const float* corr, const float* biasg,
                             float* lse, int T, int K, int d, int abs_mode,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
  err = allow_smem(fused_lse_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_lse_kernel<<<T, kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      w, h, ids, corr, biasg, lse, K, d, abs_mode, vec_ok(w, d));
  return static_cast<int>(cudaGetLastError());
}

// As fused_lse_f32, plus lse, gbar: (T,) in; dw: (n, d) ZEROED by the
// caller, accumulated into; dh: (T, d), dcoef, dcorr: (T, K) written.
extern "C" int fused_lse_bwd_f32(const float* w, const float* h,
                                 const int* ids, const float* corr,
                                 const float* biasg, const float* lse,
                                 const float* gbar, float* dw, float* dh,
                                 float* dcoef, float* dcorr, int T, int K,
                                 int d, int abs_mode, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dp = (d + 3) / 4 * 4;
  const size_t smem = static_cast<size_t>(1 + kWarps) * dp * sizeof(float);
  err = allow_smem(fused_lse_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_lse_bwd_kernel<<<T, kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      w, h, ids, corr, biasg, lse, gbar, dw, dh, dcoef, dcorr, K, d, dp,
      abs_mode, vec_ok(w, d) && (reinterpret_cast<size_t>(dw) % 16 == 0));
  return static_cast<int>(cudaGetLastError());
}
