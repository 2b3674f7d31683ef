// The backward of causal (or full) online-softmax attention, GQA:
//
//   P   = exp(scale * Q K^T - lse)          recomputed, never stored
//   dP  = dO V^T
//   D   = rowsum(P o dP)  (= rowsum(dO o O), (B, H, S) fp32 scratch)
//   dV  = P^T dO
//   dS  = P o (dP - D)
//   dK  = scale * dS^T Q
//   dQ  = scale * dS K
//
// over keys j < s_valid (and j <= i when causal); q, dO, dQ: (B, S, H,
// hd); k, v, dK, dV: (B, S, KV, hd); lse: (B, H, S) fp32 from the forward
// (flash_attention.cu's *_lse entries); fp32 or bf16 in, fp32 sums,
// gradients written in q's type.  A query head h reads and writes the
// gradients of KV head h / (H / KV) in place: no repeated-KV copy.
//
// D is summed from the recomputed fp32 P and dP, not from the forward's
// output: O is stored in q's type, and its bf16 rounding (2^-9) enters
// dS = P o (dP - D) as a per-row error, which dQ and dK then carry along
// the attention-weighted mean key (query): with keys that share a large
// mean, as a trained model's (and a QKV bias's) do, that made dQ and dK
// ~1% of their max off the fp32 chain rule; rowsum(P o dP) is what
// autograd of the fp32 softmax sums.
//
// Replaces: the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention has no backward; the reference trains the dense family
// by differentiating the pure-jnp src/repro/models/layers.py::
// chunked_attention.  Here every training step's attention gradient is
// this kernel (kernels/ops.py::flash_attention's autograd Function).
//
// Deterministic, with no float atomics: every gradient element is summed
// by one thread in a fixed order.  Two kernels behind one entry point
// (counted as one launch), launched in this order:
//   dQ       one block per (b, head, 64-query tile): a first pass over
//            the key tiles the queries see sums D (and writes it), a
//            second forms dS and dQ;
//   dK, dV   one block per (b, KV head, 64-key tile), looping over the
//            group's g query heads and the query tiles that see the keys;
//            dK and dV stay in registers and are written once.
//
// Bound on an H100 at starcoder2-3b's training shape (B 4, S 1,024, H 24,
// KV 2, hd 128, causal, bf16): the five products over the causal half
// (QK^T, P^T dO, dO V^T, dS^T Q, dS K) are 2.5 x the forward's 2, 6.4e10
// FLOP, 65 us at 989 TFLOP/s, over the ~85 MB of q, k, v, dO, lse in and
// dq, dk, dv out (25 us at 3.35 TB/s): operations bound the function.
// The dQ kernel's first pass recomputes QK^T and dO V^T once more.
//
// Tensor-core design (bf16, hd a multiple of 16 up to 128; the forward's
// tiles and copies: tensor_core.cuh).  Each product is mma.sync m16n8k16
// (bf16 in, fp32 accumulate) fed by ldmatrix from rows padded by 16 bytes;
// the K and V (or Q and dO) tiles of the next loop step stream in through a
// two-stage cp.async ring while this one computes.  In the dK/dV kernel a
// warp owns 16 keys and walks each staged 64-query tile in halves of 32:
// S^T = K Q^T, P^T from lse, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T
// Q.  In the dQ kernel a warp owns 16 queries: S = Q K^T, P, dP = dO V^T,
// then D (first pass) or dS and dQ += dS K (second).  P and dS enter the
// products as A operands straight from the accumulator registers, each as
// two bf16 halves (hi = bf16(x), lo = bf16(x - hi)) in two mmas into one
// fp32 sum, as the forward's P V does, so they keep ~16 bits where one
// bf16 would carry a 2^-9 relative error into every gradient.  Key tiles
// of the dK/dV kernel run longest first (key tile 0 sees every query tile
// when causal), query tiles of the dQ kernel too.  The dK/dV grid is only
// B * KV * S / 64 blocks (128 at the training shape, one wave on 132 SMs,
// with the causal work spread 16:1 over them): splitting a block's query
// heads over several blocks, with a fixed-order sum of their partials, is
// later work, as are wgmma and TMA.
//
// CUDA-core design (fp32, and bf16 at other widths up to 256): 256 threads
// per block, tiles of 32 keys and 32 queries staged in shared memory as
// fp32; each thread scores 4 (key, query) pairs of a tile (S and dP as
// float4 dot products over hd), the tile's P and dS pass through shared
// memory, and each thread accumulates a 32-key (or 32-query) row's float4
// column chunks of dK and dV (or dQ) in registers.  D takes the same two
// passes in its dQ kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tensor_core.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// --- CUDA-core kernels -------------------------------------------------------
namespace simt {

constexpr int kT = 32;         // keys (and queries) per staged tile
constexpr int kThreads = 256;  // 8 threads per tile row
constexpr int kPS = kT + 1;    // floats per row of the P and dS tiles

template <int HDMAX>
constexpr size_t smem_bytes() {  // four row tiles, P, dS, lse, D
  return (static_cast<size_t>(4 * kT) * (HDMAX + 4) +
          static_cast<size_t>(2 * kT) * kPS + 2 * kT) * sizeof(float);
}

// rows [r0, r0 + kT) of x (row stride ld, head offset applied) into xs as
// fp32, rows at or past n and columns past hd zero
template <int HDMAX, typename T>
__device__ __forceinline__ void stage(float* xs, const T* x, size_t ld,
                                      int r0, int n, int hd) {
  constexpr int kStride = HDMAX + 4;
  for (int e = threadIdx.x; e < kT * kStride; e += kThreads) {
    const int r = e / kStride, c = e % kStride;
    xs[e] = (r0 + r < n && c < hd)
                ? to_f32(x[static_cast<size_t>(r0 + r) * ld + c])
                : 0.f;
  }
}

__device__ __forceinline__ float dot4(const float* a, const float* b,
                                      int hd4) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
  for (int c = 0; c < hd4; ++c) {
    const float4 x = a4[c], y = b4[c];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// acc[j4] += w * row's float4 chunk (t % 8) + 8 * j4
template <int HDMAX>
__device__ __forceinline__ void axpy_row(float (&acc)[HDMAX / 8], float w,
                                         const float* row, int lane8) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int j4 = 0; j4 < HDMAX / 32; ++j4) {
    const float4 x = r4[lane8 + 8 * j4];
    acc[4 * j4 + 0] = fmaf(w, x.x, acc[4 * j4 + 0]);
    acc[4 * j4 + 1] = fmaf(w, x.y, acc[4 * j4 + 1]);
    acc[4 * j4 + 2] = fmaf(w, x.z, acc[4 * j4 + 2]);
    acc[4 * j4 + 3] = fmaf(w, x.w, acc[4 * j4 + 3]);
  }
}

template <int HDMAX, typename T>
__device__ __forceinline__ void write_row(T* out, const float (&acc)[HDMAX / 8],
                                          float mul, int lane8, int hd) {
#pragma unroll
  for (int j4 = 0; j4 < HDMAX / 32; ++j4)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (lane8 + 8 * j4) + e;
      if (c < hd) store(out + c, acc[4 * j4 + e] * mul);
    }
}

// one block per (b * KV + kv head, 32-key tile)
template <int HDMAX, typename T>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV,
               int hd, int s_valid, int causal, float scale) {
  constexpr int kStride = HDMAX + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kT][kStride]
  float* v_s = k_s + kT * kStride;
  float* q_s = v_s + kT * kStride;
  float* do_s = q_s + kT * kStride;
  float* p_s = do_s + kT * kStride;  // [key][query]
  float* ds_s = p_s + kT * kPS;
  float* lse_s = ds_s + kT * kPS;
  float* d_s = lse_s + kT;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int group = H / KV;
  const int k0 = blockIdx.y * kT;  // causal: the low key tiles work longest
  const int tid = threadIdx.x, row = tid / 8, lane8 = tid % 8;
  const int kv_lim = min(S, s_valid);
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(KV) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kvh) * hd;
  const int hd4 = (hd + 3) / 4;

  float dk_acc[HDMAX / 8], dv_acc[HDMAX / 8];
#pragma unroll
  for (int j = 0; j < HDMAX / 8; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  if (k0 < kv_lim) {
    stage<HDMAX>(k_s, k + kv_off, kv_row, k0, kv_lim, hd);
    stage<HDMAX>(v_s, v + kv_off, kv_row, k0, kv_lim, hd);
    const int qt_first = causal ? k0 / kT : 0;
    const int n_qt = (S + kT - 1) / kT;
    for (int hh = 0; hh < group; ++hh) {
      const int h = kvh * group + hh;
      const size_t q_off = static_cast<size_t>(b) * S * q_row +
                           static_cast<size_t>(h) * hd;
      const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
      const float* d_h = delta + (static_cast<size_t>(b) * H + h) * S;
      for (int qt = qt_first; qt < n_qt; ++qt) {
        const int q0 = qt * kT;
        __syncthreads();  // the previous tile's reads are done
        stage<HDMAX>(q_s, q + q_off, q_row, q0, S, hd);
        stage<HDMAX>(do_s, dout + q_off, q_row, q0, S, hd);
        if (tid < kT) {
          lse_s[tid] = q0 + tid < S ? lse_h[q0 + tid] : 0.f;
          d_s[tid] = q0 + tid < S ? d_h[q0 + tid] : 0.f;
        }
        __syncthreads();
        // key `row`, queries lane8 + 8 * j
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) {
          const int qq = lane8 + 8 * j;
          const int key = k0 + row, qi = q0 + qq;
          float p = 0.f, ds = 0.f;
          if (key < kv_lim && qi < S && !(causal && key > qi)) {
            const float s = dot4(k_s + row * kStride, q_s + qq * kStride,
                                 hd4);
            const float dp = dot4(v_s + row * kStride, do_s + qq * kStride,
                                  hd4);
            p = expf(s * scale - lse_s[qq]);
            ds = p * (dp - d_s[qq]);
          }
          p_s[row * kPS + qq] = p;
          ds_s[row * kPS + qq] = ds;
        }
        __syncthreads();
        for (int qq = 0; qq < kT; ++qq) {
          axpy_row<HDMAX>(dv_acc, p_s[row * kPS + qq], do_s + qq * kStride,
                          lane8);
          axpy_row<HDMAX>(dk_acc, ds_s[row * kPS + qq], q_s + qq * kStride,
                          lane8);
        }
      }
    }
  }
  const int key = k0 + row;
  if (key < S) {
    const size_t off = kv_off + static_cast<size_t>(key) * kv_row;
    write_row<HDMAX>(dk + off, dk_acc, scale, lane8, hd);
    write_row<HDMAX>(dv + off, dv_acc, 1.f, lane8, hd);
  }
}

// one block per (b * H + head, 32-query tile): a first pass over the key
// tiles sums D = rowsum(P o dP) and writes it, a second forms dS and dQ
template <int HDMAX, typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              T* __restrict__ dq, int S, int H, int KV, int hd, int s_valid,
              int causal, float scale) {
  constexpr int kStride = HDMAX + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kT * kStride;
  float* q_s = v_s + kT * kStride;
  float* do_s = q_s + kT * kStride;
  float* ds_s = do_s + kT * kStride;  // [query][key]
  float* lse_s = ds_s + 2 * kT * kPS;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;  // longest rows first
  const int tid = threadIdx.x, row = tid / 8, lane8 = tid % 8;
  const int qi = q0 + row;
  const int kv_lim = min(S, s_valid);
  const int kv_end = causal ? min(kv_lim, q0 + kT) : kv_lim;
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(KV) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_row +
                       static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kvh) * hd;
  const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
  float* d_h = delta + (static_cast<size_t>(b) * H + h) * S;
  const int hd4 = (hd + 3) / 4;

  stage<HDMAX>(q_s, q + q_off, q_row, q0, S, hd);
  stage<HDMAX>(do_s, dout + q_off, q_row, q0, S, hd);
  if (tid < kT) lse_s[tid] = q0 + tid < S ? lse_h[q0 + tid] : 0.f;
  float dq_acc[HDMAX / 8];
#pragma unroll
  for (int j = 0; j < HDMAX / 8; ++j) dq_acc[j] = 0.f;
  float d_row = 0.f;  // this row's D once the first pass is done

  for (int pass = 0; pass < 2; ++pass) {
    float dsum = 0.f;
    for (int k0 = 0; k0 < kv_end; k0 += kT) {
      __syncthreads();  // Q staged; the previous tile's reads are done
      stage<HDMAX>(k_s, k + kv_off, kv_row, k0, kv_lim, hd);
      stage<HDMAX>(v_s, v + kv_off, kv_row, k0, kv_lim, hd);
      __syncthreads();
      // query `row`, keys lane8 + 8 * j
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
        const int kk = lane8 + 8 * j;
        const int key = k0 + kk;
        float p = 0.f, dp = 0.f;
        if (key < kv_lim && qi < S && !(causal && key > qi)) {
          const float s = dot4(q_s + row * kStride, k_s + kk * kStride, hd4);
          dp = dot4(do_s + row * kStride, v_s + kk * kStride, hd4);
          p = expf(s * scale - lse_s[row]);
        }
        if (pass == 0)
          dsum = fmaf(p, dp, dsum);
        else
          ds_s[row * kPS + kk] = p * (dp - d_row);
      }
      if (pass == 1) {
        __syncthreads();
        for (int kk = 0; kk < kT; ++kk)
          axpy_row<HDMAX>(dq_acc, ds_s[row * kPS + kk], k_s + kk * kStride,
                          lane8);
      }
    }
    if (pass == 0) {  // the row's 8 threads, a fixed shuffle tree
      dsum += __shfl_xor_sync(kFull, dsum, 1);
      dsum += __shfl_xor_sync(kFull, dsum, 2);
      dsum += __shfl_xor_sync(kFull, dsum, 4);
      d_row = dsum;
      if (lane8 == 0 && qi < S) d_h[qi] = dsum;
    }
  }
  if (qi < S)
    write_row<HDMAX>(dq + q_off + static_cast<size_t>(qi) * q_row, dq_acc,
                     scale, lane8, hd);
}

template <int HDMAX, typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv,
           int B, int S, int H, int KV, int hd, int s_valid, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDMAX>();
  auto dkv = dkv_kernel<HDMAX, T>;
  auto dqk = dq_kernel<HDMAX, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (S + kT - 1) / kT;
  dqk<<<dim3(B * H, tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, KV, hd, s_valid, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv<<<dim3(B * KV, tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, hd, s_valid,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int B, int S, int H, int KV, int hd,
                 int s_valid, int causal, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<32, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV,
                         hd, s_valid, causal, scale, stream);
  if (hd <= 64)
    return launch<64, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV,
                         hd, s_valid, causal, scale, stream);
  if (hd <= 128)
    return launch<128, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H,
                          KV, hd, s_valid, causal, scale, stream);
  if (hd <= 256)
    return launch<256, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H,
                          KV, hd, s_valid, causal, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt

// --- tensor-core kernels -----------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // queries per staged tile
constexpr int kBK = 64;  // keys per staged tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

using tcore::cp_async_commit;
using tcore::ldsm_x4;
using tcore::ldsm_x4_trans;
using tcore::mma;

template <int HDP>
__host__ __device__ constexpr int pitch() {  // bf16 per staged row
  return HDP + 8;
}

template <int HDP>
constexpr size_t smem_bytes() {  // two single and two double-buffered
  return static_cast<size_t>(6 * 64) * pitch<HDP>() * sizeof(bf16) +
         4 * 64 * sizeof(float);  // tiles, then lse and D (two stages)
}

// (x, y) as a bf16 pair hi, and what hi leaves out as a bf16 pair lo
__device__ __forceinline__ void split(float x, float y, unsigned& hi,
                                      unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// the A fragments (hi and lo) of columns 16j..16j+15 of a 16-row block
// held as n-tiles of 8 columns in accumulator layout
__device__ __forceinline__ void a_frag(const float (&x0)[4],
                                       const float (&x1)[4], unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  split(x0[0], x0[1], hi[0], lo[0]);
  split(x0[2], x0[3], hi[1], lo[1]);
  split(x1[0], x1[1], hi[2], lo[2]);
  split(x1[2], x1[3], hi[3], lo[3]);
}

// rows [r0, r0 + 64) of x (row stride ld, head offset applied) into xs;
// rows at or past n and columns past hd are zero
template <int HDP>
__device__ __forceinline__ void load_rows(bf16* xs, const bf16* x, size_t ld,
                                          int r0, int n, int hd) {
  constexpr int P = pitch<HDP>();
  constexpr int kChunks = HDP / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < 64 * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool ok = r0 + r < n && c < hd;
    tcore::cp_async<16>(xs + r * P + c,
                        ok ? x + static_cast<size_t>(r0 + r) * ld + c : x, ok);
  }
}

// lse and D of rows [r0, r0 + 64) (those at or past S zero)
__device__ __forceinline__ void load_stats(float* ls, float* ds,
                                           const float* lse_h,
                                           const float* d_h, int r0, int S) {
  const int t = threadIdx.x;  // 128 threads: 64 for lse, 64 for D
  const int r = t % 64;
  const bool ok = r0 + r < S;
  if (t < 64)
    tcore::cp_async<4>(ls + r, ok ? lse_h + r0 + r : lse_h, ok);
  else
    tcore::cp_async<4>(ds + r, ok ? d_h + r0 + r : d_h, ok);
}

// acc (16 rows x 8 n-tiles of keys/queries) += rows16 (A, 16 rows of a tile
// at row0) . cols^T (B, 64 rows of a tile: its rows are the n dim), over
// the width HDP
template <int HDP, int NT>
__device__ __forceinline__ void qk_product(float (&acc)[NT][4],
                                           const bf16* arow, const bf16* brow,
                                           int lane) {
  constexpr int P = pitch<HDP>();
#pragma unroll
  for (int d = 0; d < HDP / 16; ++d) {
    unsigned a[4];
    ldsm_x4(arow + (lane & 15) * P + d * 16 + (lane >> 4) * 8, a);
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      unsigned bf[4];
      ldsm_x4(brow + (n * 16 + (lane & 7) + (lane >> 4) * 8) * P + d * 16 +
                  ((lane >> 3) & 1) * 8,
              bf);
      mma(acc[2 * n], a, bf[0], bf[1]);
      mma(acc[2 * n + 1], a, bf[2], bf[3]);
    }
  }
}

// out (16 rows x HDP) += x (16 rows x 16*KS columns, accumulator layout,
// split hi/lo) . rows [0, 16*KS) of a tile whose rows are the k dim
template <int HDP, int KS>
__device__ __forceinline__ void pv_product(float (&out)[HDP / 8][4],
                                           const float (&x)[2 * KS][4],
                                           const bf16* brow, int lane) {
  constexpr int P = pitch<HDP>();
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    unsigned hi[4], lo[4];
    a_frag(x[2 * j], x[2 * j + 1], hi, lo);
#pragma unroll
    for (int n = 0; n < HDP / 16; ++n) {
      unsigned bf[4];
      ldsm_x4_trans(brow + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                        n * 16 + (lane >> 4) * 8,
                    bf);
      mma(out[2 * n], hi, bf[0], bf[1]);
      mma(out[2 * n], lo, bf[0], bf[1]);
      mma(out[2 * n + 1], hi, bf[2], bf[3]);
      mma(out[2 * n + 1], lo, bf[2], bf[3]);
    }
  }
}

// one block per (b * KV + kv head, 64-key tile); warp w owns keys 16w..
template <int HDP>
__global__ void __launch_bounds__(kThreads)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int S, int H, int KV, int hd,
                   int s_valid, int causal, float scale, float scale_log2) {
  constexpr int P = pitch<HDP>();
  constexpr int kOT = HDP / 8;  // n-tiles of a gradient row block
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);  // [kBK][P]
  bf16* v_s = k_s + kBK * P;                   // [kBK][P]
  bf16* q_s = v_s + kBK * P;                   // [2][kBQ][P]
  bf16* do_s = q_s + 2 * kBQ * P;              // [2][kBQ][P]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBQ * P);  // [2][kBQ]
  float* d_s = lse_s + 2 * kBQ;                                 // [2][kBQ]

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int group = H / KV;
  const int k0 = blockIdx.y * kBK;  // causal: the low key tiles work longest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int kv_lim = min(S, s_valid);
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(KV) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kvh) * hd;
  const int qt_first = causal ? k0 / kBQ : 0;
  const int per_head = k0 < kv_lim ? (S + kBQ - 1) / kBQ - qt_first : 0;
  const int n_iter = group * per_head;

  // iteration t: query head kvh * group + t / per_head, query tile
  // qt_first + t % per_head
  auto stage = [&](int t, int buf) {
    const int h = kvh * group + t / per_head;
    const int q0 = (qt_first + t % per_head) * kBQ;
    const size_t q_off = static_cast<size_t>(b) * S * q_row +
                         static_cast<size_t>(h) * hd;
    load_rows<HDP>(q_s + buf * kBQ * P, q + q_off, q_row, q0, S, hd);
    load_rows<HDP>(do_s + buf * kBQ * P, dout + q_off, q_row, q0, S, hd);
    const size_t st = (static_cast<size_t>(b) * H + h) * S;
    load_stats(lse_s + buf * kBQ, d_s + buf * kBQ, lse + st, delta + st, q0,
               S);
  };

  float dk_acc[kOT][4], dv_acc[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (n_iter > 0) {
    load_rows<HDP>(k_s, k + kv_off, kv_row, k0, kv_lim, hd);
    load_rows<HDP>(v_s, v + kv_off, kv_row, k0, kv_lim, hd);
    stage(0, 0);
  }
  cp_async_commit();
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  for (int t = 0; t < n_iter; ++t) {
    if (t + 1 < n_iter) stage(t + 1, (t + 1) & 1);
    cp_async_commit();  // possibly empty: one group per iteration
    tcore::cp_async_wait<1>();  // K, V and tile t have landed
    __syncthreads();
    const int buf = t & 1;
    const bf16* qs = q_s + buf * kBQ * P;
    const bf16* dos = do_s + buf * kBQ * P;
    const float* ls = lse_s + buf * kBQ;
    const float* dd = d_s + buf * kBQ;
    const int q0 = (qt_first + t % per_head) * kBQ;
    const bool edge = q0 + kBQ > S || k0 + kBK > kv_lim ||
                      (causal && q0 < k0 + kBK - 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qh = half * 32;  // this pass's 32 queries of the tile
      float st[4][4], dpt[4][4];  // S^T then P^T; dP^T then dS^T
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      qk_product<HDP, 4>(st, k_s + warp * 16 * P, qs + qh * P, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = qh + n * 8 + 2 * tig + (e & 1);
          const int key = key0 + 8 * (e >> 1), qi = q0 + qq;
          float p = exp2f(st[n][e] * scale_log2 - ls[qq] * kLog2e);
          if (edge && (key >= kv_lim || qi >= S || (causal && key > qi)))
            p = 0.f;
          st[n][e] = p;
        }
      pv_product<HDP, 2>(dv_acc, st, dos + qh * P, lane);
      qk_product<HDP, 4>(dpt, v_s + warp * 16 * P, dos + qh * P, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[n][e] = st[n][e] * (dpt[n][e] - dd[qh + n * 8 + 2 * tig +
                                                 (e & 1)]);
      pv_product<HDP, 2>(dk_acc, dpt, qs + qh * P, lane);
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
    const size_t off = kv_off + static_cast<size_t>(key) * kv_row;
#pragma unroll
    for (int n = 0; n < kOT; ++n) {
      const int c = n * 8 + 2 * tig;
      if (c < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
            __floats2bfloat162_rn(dk_acc[n][2 * i] * scale,
                                  dk_acc[n][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
            __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }
}

// one block per (b * H + head, 64-query tile); warp w owns queries 16w..;
// the key tiles stream through twice: the first pass sums D = rowsum(P o
// dP) (and writes it for the dK/dV kernel), the second forms dS and dQ
template <int HDP>
__global__ void __launch_bounds__(kThreads, 2)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  bf16* __restrict__ dq,
                  int S, int H, int KV, int hd, int s_valid, int causal,
                  float scale, float scale_log2) {
  constexpr int P = pitch<HDP>();
  constexpr int kOT = HDP / 8;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // [kBQ][P]
  bf16* do_s = q_s + kBQ * P;                  // [kBQ][P]
  bf16* k_s = do_s + kBQ * P;                  // [2][kBK][P]
  bf16* v_s = k_s + 2 * kBK * P;               // [2][kBK][P]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * kBK * P);  // [kBQ]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int kv_lim = min(S, s_valid);
  const int kv_end = causal ? min(kv_lim, q0 + kBQ) : kv_lim;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(KV) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_row +
                       static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_row +
                        static_cast<size_t>(kvh) * hd;
  const size_t st_off = (static_cast<size_t>(b) * H + h) * S;

  load_rows<HDP>(q_s, q + q_off, q_row, q0, S, hd);
  load_rows<HDP>(do_s, dout + q_off, q_row, q0, S, hd);
  if (threadIdx.x < kBQ) {
    const bool ok = q0 + static_cast<int>(threadIdx.x) < S;
    tcore::cp_async<4>(lse_s + threadIdx.x,
                       ok ? lse + st_off + q0 + threadIdx.x : lse, ok);
  }
  if (n_tiles > 0) {
    load_rows<HDP>(k_s, k + kv_off, kv_row, 0, kv_lim, hd);
    load_rows<HDP>(v_s, v + kv_off, kv_row, 0, kv_lim, hd);
  }
  cp_async_commit();

  float dq_acc[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
  const int r0 = warp * 16 + g;  // this thread's rows: r0, r0 + 8
  float lse2[2], dr[2], dsum[2] = {0.f, 0.f};

  for (int t = 0; t < 2 * n_tiles; ++t) {  // pass t / n_tiles, tile t % n
    if (t + 1 < 2 * n_tiles) {
      const int nx = (t + 1) % n_tiles;
      load_rows<HDP>(k_s + ((t + 1) & 1) * kBK * P, k + kv_off, kv_row,
                     nx * kBK, kv_lim, hd);
      load_rows<HDP>(v_s + ((t + 1) & 1) * kBK * P, v + kv_off, kv_row,
                     nx * kBK, kv_lim, hd);
    }
    cp_async_commit();
    tcore::cp_async_wait<1>();  // tile t (and Q, dO, lse) have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) lse2[i] = lse_s[r0 + 8 * i] * kLog2e;
    }
    const bool second = t >= n_tiles;
    const bf16* ks = k_s + (t & 1) * kBK * P;
    const bf16* vs = v_s + (t & 1) * kBK * P;
    const int k0 = (t % n_tiles) * kBK;
    const bool edge = q0 + kBQ > S || k0 + kBK > kv_lim ||
                      (causal && k0 + kBK > q0 + 1);
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    qk_product<HDP, 8>(s, q_s + warp * 16 * P, ks, lane);
    qk_product<HDP, 8>(dp, do_s + warp * 16 * P, vs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * tig + (e & 1);
        const int qi = q0 + r0 + 8 * (e >> 1);
        float p = exp2f(s[n][e] * scale_log2 - lse2[e >> 1]);
        if (edge && (key >= kv_lim || qi >= S || (causal && key > qi)))
          p = 0.f;
        if (second)
          s[n][e] = p * (dp[n][e] - dr[e >> 1]);  // dS
        else
          dsum[e >> 1] = fmaf(p, dp[n][e], dsum[e >> 1]);
      }
    if (second) {
      pv_product<HDP, 4>(dq_acc, s, ks, lane);
    } else if (t == n_tiles - 1) {  // D of rows r0, r0 + 8: quad sums
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = dsum[i];
        x += __shfl_xor_sync(kFull, x, 1);
        x += __shfl_xor_sync(kFull, x, 2);
        dr[i] = x;
        const int qi = q0 + r0 + 8 * i;
        if (tig == 0 && qi < S) delta[st_off + qi] = x;
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    if (qi >= S) continue;
    bf16* row = dq + q_off + static_cast<size_t>(qi) * q_row;
#pragma unroll
    for (int n = 0; n < kOT; ++n) {
      const int c = n * 8 + 2 * tig;
      if (c < hd)
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
            dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv,
           int B, int S, int H, int KV, int hd, int s_valid, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  auto dkv = dkv_mma_kernel<HDP>;
  auto dqk = dq_mma_kernel<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  const int tiles = (S + kBQ - 1) / kBQ;
  dqk<<<dim3(B * H, tiles), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), S, H, KV, hd, s_valid, causal, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv<<<dim3(B * KV, tiles), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, KV, hd, s_valid,
      causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// The tensor-core entry point: q, dout, dq: (B, S, H, hd); k, v, dk, dv:
// (B, S, KV, hd); contiguous bf16 with 16-byte aligned bases; lse: (B, H,
// S) fp32 from flash_attention_mma_bf16_lse; delta: (B, H, S) fp32
// scratch; H a multiple of KV; hd a multiple of 16 up to 128.  Launches
// the dQ then the dK/dV kernel on `stream` of `device`; returns the first
// failing launch's cudaError_t (0 when both launched).
extern "C" int flash_attention_bwd_mma_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S,
    int H, int KV, int hd, int s_valid, int causal, float scale, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd < 16 || hd > 128 || hd % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  const float* l = static_cast<const float*>(lse);
  if (hd <= 32)
    return tc::launch<32>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, hd,
                          s_valid, causal, scale, st);
  if (hd <= 64)
    return tc::launch<64>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, hd,
                          s_valid, causal, scale, st);
  return tc::launch<128>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, hd,
                         s_valid, causal, scale, st);
}

// The CUDA-core entry point: the same arguments, all fp32 (bf16 = 0) or all
// bf16 (bf16 = 1), 1 <= hd <= 256, lse from flash_attention_fwd_lse.
extern "C" int flash_attention_bwd_simt(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S,
    int H, int KV, int hd, int s_valid, int causal, float scale, int bf16,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  const float* l = static_cast<const float*>(lse);
  if (bf16)
    return simt::launch_typed<__nv_bfloat16>(q, k, v, dout, l, d, dq, dk, dv,
                                             B, S, H, KV, hd, s_valid,
                                             causal, scale, st);
  return simt::launch_typed<float>(q, k, v, dout, l, d, dq, dk, dv, B, S, H,
                                   KV, hd, s_valid, causal, scale, st);
}
