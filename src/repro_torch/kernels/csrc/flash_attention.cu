// Causal (or full) online-softmax attention, GQA, forward only:
//
//   o[b, i, h, :] = sum_j softmax_j(scale * <q[b, i, h], k[b, j, h / g]>) v[b, j, h / g]
//
// over keys j < s_valid (and j <= i when causal), scale = 1 / sqrt(hd),
// g = H / KV query heads per KV head.  q, o: (B, S, H, hd); k, v: (B, S,
// KV, hd); fp32 or bf16 in, computed in fp32, written in q's type.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas kernel over a (B*H, q tiles, kv tiles) grid whose running (max,
// sum, acc) live in VMEM scratch across the sequential kv axis; its
// wrapper src/repro/kernels/ops.py::flash_attention repeats the KV heads
// and pads S to the tiles).  On the serving path it is every layer's
// attention in the transformer prefill (models/transformer.py::prefill
// through kernels/ops.py::flash_attention).
//
// Bound on an H100 at the prefill's shape (B 4, S 512, H 32, KV 8, hd 128,
// causal, bf16): 8.6 GFLOP of the causal half, which the bf16 tensor cores
// could do in 8.7 us, under the 42 MB of q/k/v/o traffic, 12.5 us at 3.35
// TB/s: bytes bound the function.  This kernel runs fp32 FMAs on the CUDA
// cores, whose 67 TFLOP/s make 128 us its own floor.
//
// Simple design.  One thread block of 256 threads per (b*h, 64-query tile);
// four threads share a query row.  The block stages its 64 query rows in
// shared memory once (converted to fp32, then scaled, as the Pallas kernel
// scales after its fp32 cast), then walks the KV tiles of 32 keys up to the
// tile's diagonal (causal) or to the end, each staged in shared memory as
// fp32 and read from KV head h / g in place: no repeated-KV copy.  A
// thread scores 8 keys of its row (16-byte shared loads along hd), the
// four threads of a row merge the tile's max and sum with shuffles, keep
// the running (max, sum) in registers, pass the row's probabilities
// through shared memory, and each accumulates a quarter of the row's
// (hd,) output in fp32 registers.  Keys at or after s_valid, and after the
// query when causal, carry no mass; rows and keys past S are masked, so S
// need not be a multiple of a tile.  Staged rows are zero-padded to the
// next compiled width (32, 64, 128 or 256), so any hd <= 256 runs.
// Tensor cores (mma.sync / wgmma), TMA and a pipelined K/V ring are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per staged KV tile
constexpr int kQuad = 4;       // threads per query row
constexpr int kThreads = kBQ * kQuad;
constexpr int kKeys = kBK / kQuad;  // keys scored per thread and tile
constexpr int kPStride = kBK + 4;   // floats per row of the P tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <int HDMAX>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kBQ + 2 * kBK) * (HDMAX + 4) +
          static_cast<size_t>(kBQ) * kPStride) * sizeof(float);
}

template <int HDMAX, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, int hd, int s_valid, int causal, float scale) {
  constexpr int kStride = HDMAX + 4;   // floats per staged row, 16B aligned
  constexpr int kCols = HDMAX / kQuad;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][kStride]
  float* k_s = q_s + kBQ * kStride;              // [kBK][kStride]
  float* v_s = k_s + kBK * kStride;              // [kBK][kStride]
  float* p_s = v_s + kBK * kStride;              // [kBQ][kPStride]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int row = tid / kQuad;
  const int quad = tid % kQuad;
  const int qi = q0 + row;

  const size_t q_row = static_cast<size_t>(H) * hd;   // elements per token
  const size_t kv_row = static_cast<size_t>(KV) * hd;
  const T* qb = q + static_cast<size_t>(b) * S * q_row +
                static_cast<size_t>(h) * hd;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row +
                static_cast<size_t>(kvh) * hd;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row +
                static_cast<size_t>(kvh) * hd;

  for (int idx = tid; idx < kBQ * kStride; idx += kThreads) {
    const int r = idx / kStride, c = idx % kStride, s = q0 + r;
    q_s[idx] = (s < S && c < hd)
                   ? to_f32(qb[static_cast<size_t>(s) * q_row + c]) * scale
                   : 0.f;
  }

  int kv_end = causal ? min(S, q0 + kBQ) : S;
  kv_end = min(kv_end, s_valid);
  const int hd4 = (hd + 3) / 4;

  float m_run = -CUDART_INF_F;
  float l_run = 0.f;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // q_s staged; the previous tile's reads are done
    for (int idx = tid; idx < kBK * kStride; idx += kThreads) {
      const int r = idx / kStride, c = idx % kStride, s = k0 + r;
      const bool ok = s < kv_end && c < hd;
      const size_t off = static_cast<size_t>(s) * kv_row + c;
      k_s[idx] = ok ? to_f32(kb[off]) : 0.f;
      v_s[idx] = ok ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores of keys quad + kQuad * i of this tile
    float sc[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) sc[i] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(q_s + row * kStride);
    for (int c4 = 0; c4 < hd4; ++c4) {
      const float4 a = q4[c4];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const float4 x = reinterpret_cast<const float4*>(
            k_s + (quad + kQuad * i) * kStride)[c4];
        sc[i] = fmaf(a.x, x.x, sc[i]);
        sc[i] = fmaf(a.y, x.y, sc[i]);
        sc[i] = fmaf(a.z, x.z, sc[i]);
        sc[i] = fmaf(a.w, x.w, sc[i]);
      }
    }
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int kj = k0 + quad + kQuad * i;
      if (kj >= kv_end || (causal && kj > qi)) sc[i] = -CUDART_INF_F;
      tmax = fmaxf(tmax, sc[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    // a row with no valid key yet (m_new = -inf) adds nothing
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const float p = sc[i] == -CUDART_INF_F ? 0.f : expf(sc[i] - m_use);
      p_s[row * kPStride + quad + kQuad * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = m_run == -CUDART_INF_F ? 0.f : expf(m_run - m_new);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncwarp();  // the row's four threads (one warp) wrote its P

    // acc += P @ V over this tile; a thread owns the float4 column chunks
    // quad + kQuad * j4 (neighbouring threads on neighbouring banks)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= corr;
    const int n_keys = min(kBK, kv_end - k0);
    for (int kk = 0; kk < n_keys; ++kk) {
      const float p = p_s[row * kPStride + kk];
      const float4* v4 = reinterpret_cast<const float4*>(v_s + kk * kStride);
#pragma unroll
      for (int j4 = 0; j4 < kCols / 4; ++j4) {
        const float4 x = v4[quad + kQuad * j4];
        acc[4 * j4 + 0] = fmaf(p, x.x, acc[4 * j4 + 0]);
        acc[4 * j4 + 1] = fmaf(p, x.y, acc[4 * j4 + 1]);
        acc[4 * j4 + 2] = fmaf(p, x.z, acc[4 * j4 + 2]);
        acc[4 * j4 + 3] = fmaf(p, x.w, acc[4 * j4 + 3]);
      }
    }
  }

  if (qi < S) {
    const float denom = fmaxf(l_run, 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * S + qi) * q_row +
              static_cast<size_t>(h) * hd;
#pragma unroll
    for (int j4 = 0; j4 < kCols / 4; ++j4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (quad + kQuad * j4) + e;
        if (c < hd) store(orow + c, acc[4 * j4 + e] / denom);
      }
    }
  }
}

template <int HDMAX, typename T>
int launch_width(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int KV, int hd, int s_valid, int causal,
                 float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDMAX>();
  auto kernel = flash_kernel<HDMAX, T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, hd, s_valid,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int KV, int hd, int s_valid, int causal,
                 float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch_width<32, T>(q, k, v, o, B, S, H, KV, hd, s_valid, causal,
                               scale, stream);
  if (hd <= 64)
    return launch_width<64, T>(q, k, v, o, B, S, H, KV, hd, s_valid, causal,
                               scale, stream);
  if (hd <= 128)
    return launch_width<128, T>(q, k, v, o, B, S, H, KV, hd, s_valid, causal,
                                scale, stream);
  if (hd <= 256)
    return launch_width<256, T>(q, k, v, o, B, S, H, KV, hd, s_valid, causal,
                                scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); contiguous, all fp32
// (bf16 = 0) or all bf16 (bf16 = 1); H a multiple of KV; 1 <= hd <= 256;
// keys at or after s_valid carry no mass.  Launches on `stream` of
// `device`; returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KV, int hd, int s_valid,
                                   int causal, float scale, int bf16,
                                   int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, s_valid,
                                       causal, scale, st);
  return launch_typed<float>(q, k, v, o, B, S, H, KV, hd, s_valid, causal,
                             scale, st);
}
