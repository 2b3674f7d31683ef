// The backward of causal (or full) online-softmax attention, GQA:
//
//   P   = exp(scale * Q K^T - lse)          recomputed, never stored
//   dP  = dO V^T
//   D   = rowsum(P o dP)  (= rowsum(dO o O), (B, H, Sq) fp32 scratch)
//   dV  = P^T dO
//   dS  = P o (dP - D)
//   dK  = scale * dS^T Q
//   dQ  = scale * dS K
//
// over keys j < s_valid (and j <= i when causal); q, dQ: (B, Sq, H, hd);
// dO: (B, Sq, H, hv); k, dK: (B, Sk, KV, hd); v, dV: (B, Sk, KV, hv), the
// value width hv apart from the q/k width hd (MLA's expanded form: hd
// 192, hv 128) and the key length Sk apart from the query length Sq (a
// cross attention; Sk = Sq when causal); lse: (B, H, Sq) fp32 from the
// forward
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
// in a fixed order.  Two kernels behind one entry point (counted as one
// launch), launched in this order:
//   dQ       a block per (b, head, 128-query tile): a first sweep over the
//            key tiles the queries see sums D (and writes it), a second
//            forms dS and dQ;
//   dK, dV   a block per (b, KV head, 128-key tile, share): the key
//            tile's (query head, 64-query tile) steps are cut into shares
//            of at most `chunk` steps (kernels/flash_attention.py::plan);
//            each share's block sums fp32 partials of dK and dV, and the
//            last of a tile's blocks to end (an integer counter) folds
//            them in share order and writes the tile once.
//
// Bound on an H100 at starcoder2-3b's training shape (B 4, S 1,024, H 24,
// KV 2, hd 128, causal, bf16): the five products over the causal half
// (QK^T, P^T dO, dO V^T, dS^T Q, dS K) are 2.5 x the forward's 2, 6.4e10
// FLOP, 65 us at 989 TFLOP/s, over the ~85 MB of q, k, v, dO, lse in and
// dq, dk, dv out (25 us at 3.35 TB/s): operations bound the function.
// The kernels run 12 products a (query, key) pair against those 5: QK^T
// and dO V^T three times (the dK/dV kernel's, and the dQ kernel's two
// sweeps), P and dS each as bf16 hi + lo into dV, dK and dQ; so 2.4 x
// the bound is their floor at the tensor cores' rate, and the fold's fp32
// partials (128 KB a split block at hd 128) travel through L2.  D from
// the forward's bf16 output plus its bf16 remainder would drop the first
// sweep, but keeps dQ 2.4e-6-2.2e-5 off the exact chain rule against
// rowsum(P o dP)'s 1.3e-7-7.7e-7 (tools/flash_bwd_delta_error.py).
//
// Tensor-core design (bf16, hd and hv multiples of 16, hd up to 192 and
// hv up to 128, compiled at (64, 64) and (128, 128) columns for hd = hv
// and at (192, 128) for any hv != hd; Hopper's wgmma, TMA, mbarrier and
// setmaxnreg helpers in tensor_core.cuh).  A block is three warpgroups: a producer, whose first
// warp keeps a 3-stage ring of TMA copies in flight behind full / empty
// mbarriers and gives up its registers (24), and two consumers of 64 rows
// each (240 registers).  Tiles land 128-byte swizzled (rows of 64 bf16;
// columns past hd and rows past Sq or Sk zero-filled by the TMA), the
// layout the wgmma descriptors read.  K, V, dK and dV are mapped at their
// own length Sk, Q, dO, dQ, lse and D at Sq: the dQ kernel sweeps Sk
// keys, the dK/dV grid's key tiles run over Sk and their (query head,
// query step) steps over Sq, and a cross attention's K and V are read as
// they are, never padded to Sq.  In the dK/dV kernel the block holds its 128
// keys' K and V; each stage brings one 64-query Q and dO tile with its lse
// and D, and each consumer forms S^T = K Q^T and dP^T = V dO^T (SS
// products, both operands from shared memory), P^T and dS^T in fp32
// registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as A
// operands straight from the registers (the RS form), each as two bf16
// halves (hi = bf16(x), lo = bf16(x - hi)) in two products into one fp32
// sum, so they keep ~16 bits where one bf16 would carry a 2^-9 relative
// error into every gradient.  dK and dV stay in registers and are written
// once.  The dQ kernel holds 128 queries' Q and dO, and each stage brings
// one 64-key K and V tile: S = Q K^T and dP = dO V^T, then (second sweep)
// dQ += dS K in the RS form.  The dK/dV grid runs key tiles in order, the
// causal sweep's longest first, and the plan cuts every tile into near-
// equal shares, so the grid fills the card (256 blocks at the training
// shape, where one block per key tile gave 128 with the work spread 16:1);
// the dQ kernel's query tiles run longest first.  Fully masked causal
// steps are skipped; only a step that holds the diagonal, s_valid, Sq or
// Sk is masked element by element.  At (192, 128) a consumer holding both a 64 x
// 192 dK and a 64 x 128 dV in fp32 would need 160 registers a thread for
// them alone, and would spill past setmaxnreg's 240 once S^T, dP^T and the
// bf16 halves are live; so there a dK/dV block holds 64 keys, and its two
// consumers split the work by role: both form S^T and dP^T, consumer 0
// sums dK (96 accumulator registers) and consumer 1 dV (64).  The Q and
// dO ring keeps its 3 stages (120 KB; 160 KB in all for the dK/dV
// kernel, 200 KB for the dQ kernel, whose dQ takes 96 registers), the
// products over 192 columns take 12 depth steps in the SS form and an N =
// 128 plus an N = 64 product in the RS form.
//
// CUDA-core design (fp32, and bf16 at other widths up to 256): 256 threads
// per block, tiles of 32 keys and 32 queries staged in shared memory as
// fp32; each thread scores 4 (key, query) pairs of a tile (S and dP as
// float4 dot products over hd and hv), the tile's P and dS pass through
// shared memory, and each thread accumulates a 32-key (or 32-query) row's
// float4 column chunks of dK and dV (or dQ) in registers.  D takes the same two
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

// one block per (b * KV + kv head, 32-key tile).  kOwnV: v, dO and dV
// carry a width hv of their own; without it hv = hd, and the kernel is the
// one the dense family's calls (hd = hv) always ran
template <int HDMAX, typename T, bool kOwnV>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
               int KV, int hd, int hv_arg, int s_valid, int causal,
               float scale) {
  const int hv = kOwnV ? hv_arg : hd;
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
  const int kv_lim = min(Sk, s_valid);
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t o_row = kOwnV ? static_cast<size_t>(H) * hv : q_row;
  const size_t kv_row = static_cast<size_t>(KV) * hd;
  const size_t v_row = kOwnV ? static_cast<size_t>(KV) * hv : kv_row;
  const size_t kv_off = static_cast<size_t>(b) * Sk * kv_row +
                        static_cast<size_t>(kvh) * hd;
  const size_t v_off = kOwnV ? static_cast<size_t>(b) * Sk * v_row +
                                   static_cast<size_t>(kvh) * hv
                             : kv_off;
  const int hd4 = (hd + 3) / 4, hv4 = kOwnV ? (hv + 3) / 4 : hd4;

  float dk_acc[HDMAX / 8], dv_acc[HDMAX / 8];
#pragma unroll
  for (int j = 0; j < HDMAX / 8; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  if (k0 < kv_lim) {
    stage<HDMAX>(k_s, k + kv_off, kv_row, k0, kv_lim, hd);
    stage<HDMAX>(v_s, v + v_off, v_row, k0, kv_lim, hv);
    const int qt_first = causal ? k0 / kT : 0;
    const int n_qt = (Sq + kT - 1) / kT;
    for (int hh = 0; hh < group; ++hh) {
      const int h = kvh * group + hh;
      const size_t q_off = static_cast<size_t>(b) * Sq * q_row +
                           static_cast<size_t>(h) * hd;
      const size_t o_off = kOwnV ? static_cast<size_t>(b) * Sq * o_row +
                                       static_cast<size_t>(h) * hv
                                 : q_off;
      const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * Sq;
      const float* d_h = delta + (static_cast<size_t>(b) * H + h) * Sq;
      for (int qt = qt_first; qt < n_qt; ++qt) {
        const int q0 = qt * kT;
        __syncthreads();  // the previous tile's reads are done
        stage<HDMAX>(q_s, q + q_off, q_row, q0, Sq, hd);
        stage<HDMAX>(do_s, dout + o_off, o_row, q0, Sq, hv);
        if (tid < kT) {
          lse_s[tid] = q0 + tid < Sq ? lse_h[q0 + tid] : 0.f;
          d_s[tid] = q0 + tid < Sq ? d_h[q0 + tid] : 0.f;
        }
        __syncthreads();
        // key `row`, queries lane8 + 8 * j
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) {
          const int qq = lane8 + 8 * j;
          const int key = k0 + row, qi = q0 + qq;
          float p = 0.f, ds = 0.f;
          if (key < kv_lim && qi < Sq && !(causal && key > qi)) {
            const float s = dot4(k_s + row * kStride, q_s + qq * kStride,
                                 hd4);
            const float dp = dot4(v_s + row * kStride, do_s + qq * kStride,
                                  hv4);
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
  if (key < Sk) {
    write_row<HDMAX>(dk + kv_off + static_cast<size_t>(key) * kv_row, dk_acc,
                     scale, lane8, hd);
    write_row<HDMAX>(dv + v_off + static_cast<size_t>(key) * v_row, dv_acc,
                     1.f, lane8, hv);
  }
}

// one block per (b * H + head, 32-query tile): a first pass over the key
// tiles sums D = rowsum(P o dP) and writes it, a second forms dS and dQ
template <int HDMAX, typename T, bool kOwnV>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Sk, int H, int KV, int hd,
              int hv_arg, int s_valid, int causal, float scale) {
  const int hv = kOwnV ? hv_arg : hd;
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
  const int kv_lim = min(Sk, s_valid);
  const int kv_end = causal ? min(kv_lim, q0 + kT) : kv_lim;
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t o_row = kOwnV ? static_cast<size_t>(H) * hv : q_row;
  const size_t kv_row = static_cast<size_t>(KV) * hd;
  const size_t v_row = kOwnV ? static_cast<size_t>(KV) * hv : kv_row;
  const size_t q_off = static_cast<size_t>(b) * Sq * q_row +
                       static_cast<size_t>(h) * hd;
  const size_t o_off = kOwnV ? static_cast<size_t>(b) * Sq * o_row +
                                   static_cast<size_t>(h) * hv
                             : q_off;
  const size_t kv_off = static_cast<size_t>(b) * Sk * kv_row +
                        static_cast<size_t>(kvh) * hd;
  const size_t v_off = kOwnV ? static_cast<size_t>(b) * Sk * v_row +
                                   static_cast<size_t>(kvh) * hv
                             : kv_off;
  const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * Sq;
  float* d_h = delta + (static_cast<size_t>(b) * H + h) * Sq;
  const int hd4 = (hd + 3) / 4, hv4 = kOwnV ? (hv + 3) / 4 : hd4;

  stage<HDMAX>(q_s, q + q_off, q_row, q0, Sq, hd);
  stage<HDMAX>(do_s, dout + o_off, o_row, q0, Sq, hv);
  if (tid < kT) lse_s[tid] = q0 + tid < Sq ? lse_h[q0 + tid] : 0.f;
  float dq_acc[HDMAX / 8];
#pragma unroll
  for (int j = 0; j < HDMAX / 8; ++j) dq_acc[j] = 0.f;
  float d_row = 0.f;  // this row's D once the first pass is done

  for (int pass = 0; pass < 2; ++pass) {
    float dsum = 0.f;
    for (int k0 = 0; k0 < kv_end; k0 += kT) {
      __syncthreads();  // Q staged; the previous tile's reads are done
      stage<HDMAX>(k_s, k + kv_off, kv_row, k0, kv_lim, hd);
      stage<HDMAX>(v_s, v + v_off, v_row, k0, kv_lim, hv);
      __syncthreads();
      // query `row`, keys lane8 + 8 * j
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
        const int kk = lane8 + 8 * j;
        const int key = k0 + kk;
        float p = 0.f, dp = 0.f;
        if (key < kv_lim && qi < Sq && !(causal && key > qi)) {
          const float s = dot4(q_s + row * kStride, k_s + kk * kStride, hd4);
          dp = dot4(do_s + row * kStride, v_s + kk * kStride, hv4);
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
      if (lane8 == 0 && qi < Sq) d_h[qi] = dsum;
    }
  }
  if (qi < Sq)
    write_row<HDMAX>(dq + q_off + static_cast<size_t>(qi) * q_row, dq_acc,
                     scale, lane8, hd);
}

template <int HDMAX, typename T, bool kOwnV = false>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv,
           int B, int Sq, int Sk, int H, int KV, int hd, int hv,
           int s_valid, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDMAX>();
  auto dkv = dkv_kernel<HDMAX, T, kOwnV>;
  auto dqk = dq_kernel<HDMAX, T, kOwnV>;
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
  dqk<<<dim3(B * H, (Sq + kT - 1) / kT), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Sq, Sk, H, KV, hd, hv, s_valid, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv<<<dim3(B * KV, (Sk + kT - 1) / kT), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV, hd, hv,
      s_valid, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                 int hd, int hv, int s_valid, int causal, float scale,
                 cudaStream_t stream) {
  if (hd < 1 || hv < 1 || hd > 256 || hv > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd != hv)  // a value width of its own: one instantiation takes all
    return launch<256, T, true>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq,
                                Sk, H, KV, hd, hv, s_valid, causal, scale,
                                stream);
  if (hd <= 32)
    return launch<32, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                         H, KV, hd, hv, s_valid, causal, scale, stream);
  if (hd <= 64)
    return launch<64, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                         H, KV, hd, hv, s_valid, causal, scale, stream);
  if (hd <= 128)
    return launch<128, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                          KV, hd, hv, s_valid, causal, scale, stream);
  return launch<256, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                        KV, hd, hv, s_valid, causal, scale, stream);
}

}  // namespace simt

// --- tensor-core kernels ----------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using tcore::fence_regs;
using tcore::mbar_wait;
using tcore::wgmma_desc;

constexpr int kRows = 64;       // keys (dK/dV) or queries (dQ) a consumer owns
constexpr int kConsumers = 2;   // consumer warpgroups a block
constexpr int kBlockRows = kRows * kConsumers;
constexpr int kStep = 64;       // queries (dK/dV) or keys (dQ) a ring stage
constexpr int kStages = 3;
constexpr int kAtom = 64;       // bf16 columns of a 128-byte swizzled row
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kProducerRegs = 24;   // 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr int kFoldSync = 1;        // named barrier of the consumers
constexpr int kMaxDevices = 64;

// Whether the dK/dV kernel at the compiled widths (HDP, HVP) splits its
// consumers by role: at (192, 128) a consumer holding both a 64 x 192 dK
// and a 64 x 128 dV in fp32 (160 registers a thread) would pass the 240
// that setmaxnreg grants once S^T, dP^T and the bf16 halves are live, so
// the two consumers take the same 64 keys, one summing dK and the other
// dV (96 and 64 accumulator registers).
template <int HDP, int HVP>
__host__ __device__ constexpr bool split_roles() {
  return HDP + HVP > 256;
}

// keys a dK/dV block holds
template <int HDP, int HVP>
__host__ __device__ constexpr int dkv_keys() {
  return split_roles<HDP, HVP>() ? kRows : kBlockRows;
}

// dynamic shared memory of either kernel: two 128-row tiles held for the
// block (Q at HDP columns and dO at HVP, or the dK/dV kernel's K and V,
// at most as large), a ring of kStages pairs of 64-row tiles, and 1,024
// bytes to align
template <int HDP, int HVP>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(HDP + HVP) *
                    (kBlockRows + kStages * kStep) * sizeof(bf16);
}

// this thread's warpgroup, read from lane 0 so that the compiler knows it
// is one value across the warp: the roles branch on it, and ptxas gives a
// role the registers its setmaxnreg sets only on a warp-uniform branch
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

__device__ __forceinline__ bf16* align1024(void* p) {
  const unsigned a = tcore::smem_addr(p);
  return reinterpret_cast<bf16*>(static_cast<char*>(p) +
                                 (((a + 1023) & ~1023u) - a));
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

// x (a 64 x 64 accumulator) as the A operands (hi and lo) of the 4
// depth-16 steps of a product whose depth is x's columns
__device__ __forceinline__ void a_operands(const float (&x)[32],
                                           unsigned (&hi)[4][4],
                                           unsigned (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    split(x[2 * j], x[2 * j + 1], hi[j / 4][j % 4], lo[j / 4][j % 4]);
}

// acc's first kA atoms of 64 x 64 += x B as hi + lo, B the 64-row tile `b`
// (its rows the depth, kA atoms of 64 columns, `rows` rows an atom)
// MN-major.  Atoms 0 and 1 go in one product of 128 columns, the atoms
// `rows` x 128 bytes apart (the descriptor's LBO); a third atom (192
// columns) in a product of its own.
template <int kA, int kN>
__device__ __forceinline__ void product_rs(float (&acc)[kN][32],
                                           const unsigned (&hi)[4][4],
                                           const unsigned (&lo)[4][4],
                                           const bf16* b, int rows) {
  static_assert(kA >= 1 && kA <= 3 && kA <= kN, "64, 128 or 192 columns");
  const uint64_t atom = static_cast<uint64_t>(rows * kAtom * 2 / 16);
  const uint64_t db = wgmma_desc(b);
  const uint64_t d2 = (db & ~(0x3fffull << 16)) | (atom << 16);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t step = kk * 16 * kAtom * 2 / 16;  // 16 rows
    if constexpr (kA >= 2) {
      tcore::wgmma_rs_n128(acc[0], acc[1], hi[kk], d2 + step);
      tcore::wgmma_rs_n128(acc[0], acc[1], lo[kk], d2 + step);
    } else {
      tcore::wgmma_rs(acc[0], hi[kk], db + step);
      tcore::wgmma_rs(acc[0], lo[kk], db + step);
    }
    if constexpr (kA == 3) {
      tcore::wgmma_rs(acc[2], hi[kk], db + 2 * atom + step);
      tcore::wgmma_rs(acc[2], lo[kk], db + 2 * atom + step);
    }
  }
}

// d = A B^T over the width W: A the 64 rows at `a` of a tile of `a_rows`
// rows an atom, B the 64 rows at `b` of a tile of `b_rows`, both K-major
// (their columns the depth).  A descriptor counts 16 bytes a unit.
template <int W>
__device__ __forceinline__ void product_ss(float (&d)[32], const bf16* a,
                                           int a_rows, const bf16* b,
                                           int b_rows) {
  const uint64_t da = wgmma_desc(a), db = wgmma_desc(b);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const int atom = kk / 4, c = (kk % 4) * 16;  // c: bf16 along the row
    tcore::wgmma_ss(d, da + (atom * a_rows * kAtom + c) * 2 / 16,
                    db + (atom * b_rows * kAtom + c) * 2 / 16, kk > 0);
  }
}

template <int kA>
__device__ __forceinline__ void zero(float (&acc)[kA][32]) {
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
}

template <int kA>
__device__ __forceinline__ void fence_acc(float (&acc)[kA][32]) {
#pragma unroll
  for (int a = 0; a < kA; ++a) fence_regs(acc[a]);
}

__device__ __forceinline__ void fence_ops(unsigned (&x)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(x[kk]);
}

// rows row0, row0 + 8 of acc's first kA atoms (times mul) as bf16 into out
// (row stride ld, the tile's first row at out); rows at or past n,
// columns past w skipped
template <int kA, int kN>
__device__ __forceinline__ void store_rows(bf16* out, size_t ld,
                                           const float (&acc)[kN][32],
                                           float mul, int row0, int n,
                                           int w, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = a * kAtom + j * 8 + 2 * tq;
        if (c < w)
          *reinterpret_cast<__nv_bfloat162*>(out + row * ld + c) =
              __floats2bfloat162_rn(acc[a][4 * j + 2 * r] * mul,
                                    acc[a][4 * j + 2 * r + 1] * mul);
      }
  }
}

// acc's first n atoms into (put) or added from (add) a fold slot, from
// the slot's atom `at` on: a float4 a lane, 8 an atom
template <int kN>
__device__ __forceinline__ void put(float4* slot, const float (&acc)[kN][32],
                                    int n, int at, int t_in) {
#pragma unroll
  for (int a = 0; a < kN; ++a)
    if (a < n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        slot[((at + a) * 8 + j) * 128 + t_in] =
            make_float4(acc[a][4 * j], acc[a][4 * j + 1], acc[a][4 * j + 2],
                        acc[a][4 * j + 3]);
}

template <int kN>
__device__ __forceinline__ void add(const float4* slot, float (&acc)[kN][32],
                                    int n, int at, int t_in) {
#pragma unroll
  for (int a = 0; a < kN; ++a)
    if (a < n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = __ldcg(slot + ((at + a) * 8 + j) * 128 + t_in);
        acc[a][4 * j] += x.x;
        acc[a][4 * j + 1] += x.y;
        acc[a][4 * j + 2] += x.z;
        acc[a][4 * j + 3] += x.w;
      }
}

// The fold of a split key tile, run by both consumers: this share's sums
// (n1 atoms of x, then n2 of y) into its slot of `slot4` float4s; the last
// share of the tile to end (the counter finds it) sums every share's slot
// into x and y in split order and returns true, the others false.
template <int kN1, int kN2>
__device__ __forceinline__ bool fold(float (&x)[kN1][32], int n1,
                                     float (&y)[kN2][32], int n2,
                                     float4* ws, size_t slot4, int split_i,
                                     int ns, int* counter, int* last,
                                     int wg, int t_in) {
  const size_t first = static_cast<size_t>(blockIdx.x) - split_i;
  put(ws + (static_cast<size_t>(blockIdx.x) * kConsumers + wg) * slot4, x,
      n1, 0, t_in);
  put(ws + (static_cast<size_t>(blockIdx.x) * kConsumers + wg) * slot4, y,
      n2, n1, t_in);
  __threadfence();
  tcore::named_sync(kFoldSync, kConsumerThreads);
  if (threadIdx.x == 0) *last = atomicAdd(counter, 1) == ns - 1;
  tcore::named_sync(kFoldSync, kConsumerThreads);
  if (!*last) return false;
  __threadfence();
  zero(x);
  zero(y);
  for (int sp = 0; sp < ns; ++sp) {  // split order, whoever ended last
    const float4* part = ws + ((first + sp) * kConsumers + wg) * slot4;
    add(part, x, n1, 0, t_in);
    add(part, y, n2, n1, t_in);
  }
  return true;
}

// The dK/dV kernel.  Block: the kKeys keys [k0, k0 + kKeys) of KV head kvh
// in batch b and the steps [t_begin, t_end) of that key tile's (query
// head, 64-query tile) sweep: step t is query head kvh * group + t /
// per_head, query tile qt_first + t % per_head.  kKeys is 128, consumer
// warpgroup w owning keys [k0 + 64 w, +64) and summing their dK and dV,
// or, where the roles split (split_roles), 64 keys that both consumers
// take, consumer 0 summing dK and consumer 1 dV.  Blocks run key tile by
// key tile (the causal sweep's longest first); a tile's sweep is cut into
// ns = ceil(steps / chunk) near-equal shares, one block each, whose fp32
// partials the last of them to finish folds in split order (an integer
// counter finds it).
template <int HDP, int HVP>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ ws,
                     int* __restrict__ counters, int B, int Sq, int Sk,
                     int H, int KV, int hd, int hv_arg, int s_valid,
                     int causal, float scale, float scale_log2, int chunk) {
  // at HDP = HVP the value width is hd (the dense family's calls)
  const int hv = HDP == HVP ? hd : hv_arg;
  constexpr bool kRoles = split_roles<HDP, HVP>();
  constexpr int kKeys = dkv_keys<HDP, HVP>();
  constexpr int kAd = HDP / kAtom, kAv = HVP / kAtom;
  constexpr int kK = kKeys * HDP;  // bf16 of the K tile
  constexpr int kV = kKeys * HVP;  // bf16 of the V tile
  constexpr int kQ = kStep * HDP;  // bf16 of a Q stage
  constexpr int kO = kStep * HVP;  // bf16 of a dO stage
  // float4s of a consumer's fold slot: its dK and dV, or its role's sum
  constexpr size_t kSlot4 = (kRoles ? kAd : kAd + kAv) * 8 * 128;
  extern __shared__ uint8_t smem_raw[];
  bf16* k_s = align1024(smem_raw);
  bf16* v_s = k_s + kK;
  bf16* q_s = v_s + kV;              // [kStages][kQ]
  bf16* do_s = q_s + kStages * kQ;   // [kStages][kO]
  __shared__ float lse_s[kStages][kStep], d_s[kStages][kStep];
  __shared__ uint64_t kv_bar, full[kStages], empty[kStages];
  __shared__ int last;

  const int group = H / KV;
  const int n_qt = (Sq + kStep - 1) / kStep;
  const int n_kt = (Sk + kKeys - 1) / kKeys;
  constexpr int kTilesPerKey = kKeys / kStep;
  int idx = blockIdx.x, kt = 0, steps = 0, ns = 1;
  for (;; ++kt) {
    steps = group * (n_qt - (causal ? kt * kTilesPerKey : 0));
    ns = max(1, (steps + chunk - 1) / chunk);
    if (idx < B * KV * ns || kt == n_kt - 1) break;
    idx -= B * KV * ns;
  }
  const int bkv = idx / ns, split_i = idx % ns;
  const int b = bkv / KV, kvh = bkv % KV;
  const int k0 = kt * kKeys;
  const int qt_first = causal ? kt * kTilesPerKey : 0;
  const int per_head = n_qt - qt_first;
  const int t_begin = static_cast<int>(static_cast<long long>(split_i) *
                                       steps / ns);
  const int t_end = static_cast<int>(static_cast<long long>(split_i + 1) *
                                     steps / ns);
  const int kv_lim = min(Sk, s_valid);
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    tcore::mbar_init(&kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      tcore::mbar_init(&full[s], 32);  // the producer warp's lanes
      tcore::mbar_init(&empty[s], 4 * kConsumers);  // the consumer warps
    }
    tcore::fence_mbar_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer: its first warp stages the tiles
    tcore::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      tcore::mbar_arrive_expect_tx(&kv_bar, (kK + kV) * sizeof(bf16));
      for (int a = 0; a < kAd; ++a)
        tcore::tma_load_4d(k_s + a * kKeys * kAtom, &map_k, a * kAtom, kvh,
                           k0, b, &kv_bar);
      for (int a = 0; a < kAv; ++a)
        tcore::tma_load_4d(v_s + a * kKeys * kAtom, &map_v, a * kAtom, kvh,
                           k0, b, &kv_bar);
    }
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int s = i % kStages, n = i / kStages;
      if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
      const int h = kvh * group + t / per_head;
      const int q0 = (qt_first + t % per_head) * kStep;
      const size_t st = (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
      for (int e = 0; e < kStep / 32; ++e) {
        const int r = lane + 32 * e, qi = q0 + r;
        lse_s[s][r] = qi < Sq ? lse[st + qi] * kLog2e : 0.f;
        d_s[s][r] = qi < Sq ? delta[st + qi] : 0.f;
      }
      if (lane == 0) {
        tcore::mbar_arrive_expect_tx(&full[s], (kQ + kO) * sizeof(bf16));
        for (int a = 0; a < kAd; ++a)
          tcore::tma_load_4d(q_s + s * kQ + a * kStep * kAtom, &map_q,
                             a * kAtom, h, q0, b, &full[s]);
        for (int a = 0; a < kAv; ++a)
          tcore::tma_load_4d(do_s + s * kO + a * kStep * kAtom, &map_do,
                             a * kAtom, h, q0, b, &full[s]);
      } else {
        tcore::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys [kw0, kw0 + 64), and with split roles dK
  // (wg 0) or dV (wg 1) alone
  tcore::setmaxnreg_inc<kConsumerRegs>();
  const int t_in = threadIdx.x % 128, warp = t_in / 32, lane = t_in % 32;
  const int g = lane / 4, tq = lane % 4;
  const int kw0 = k0 + (kRoles ? 0 : wg * kRows);
  const int key_a = kw0 + warp * 16 + g;  // this thread's keys: +0, +8
  const bf16* k_w = k_s + (kw0 - k0) * kAtom;
  const bf16* v_w = v_s + (kw0 - k0) * kAtom;
  const bool want_dk = !kRoles || wg == 0, want_dv = !kRoles || wg == 1;
  // dK's sum and dV's; with split roles dk_acc holds this role's sum
  float dk_acc[kAd][32], dv_acc[kRoles ? 1 : kAv][32];
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(&kv_bar, 0);
  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const int q0 = (qt_first + t % per_head) * kStep;
    if (kw0 < kv_lim && !(causal && kw0 > q0 + kStep - 1)) {
      const bf16* qs = q_s + s * kQ;
      const bf16* dos = do_s + s * kO;
      float st[32], dpt[32];  // S^T = K Q^T, dP^T = V dO^T
      tcore::wgmma_fence();
      product_ss<HDP>(st, k_w, kKeys, qs, kStep);
      product_ss<HVP>(dpt, v_w, kKeys, dos, kStep);
      tcore::wgmma_commit();
      tcore::wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const bool edge = q0 + kStep > Sq || kw0 + kRows > kv_lim ||
                        (causal && q0 < kw0 + kRows - 1);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = (e / 4) * 8 + 2 * tq + (e & 1);  // query q0 + col
        const int key = key_a + 8 * ((e >> 1) & 1);
        float p = exp2f(st[e] * scale_log2 - lse_s[s][col]);
        if (edge &&
            (key >= kv_lim || q0 + col >= Sq || (causal && key > q0 + col)))
          p = 0.f;
        st[e] = p;                                  // P^T
        dpt[e] = p * (dpt[e] - d_s[s][col]);  // dS^T
      }
      // dV's product, then dK's: P^T's halves are dead before dS^T's are
      // formed (as fast on the card as issuing both in one group)
      unsigned hi[4][4], lo[4][4];
      if (want_dv) {
        a_operands(st, hi, lo);
        tcore::wgmma_fence();
        if constexpr (kRoles)  // dV += P^T dO
          product_rs<kAv>(dk_acc, hi, lo, dos, kStep);
        else
          product_rs<kAv>(dv_acc, hi, lo, dos, kStep);
        tcore::wgmma_commit();
        tcore::wgmma_wait<0>();
        fence_ops(hi);
        fence_ops(lo);
        fence_acc(dk_acc);
        fence_acc(dv_acc);
      }
      if (want_dk) {
        a_operands(dpt, hi, lo);
        tcore::wgmma_fence();
        product_rs<kAd>(dk_acc, hi, lo, qs, kStep);   // dK += dS^T Q
        tcore::wgmma_commit();
        tcore::wgmma_wait<0>();
        fence_ops(hi);
        fence_ops(lo);
        fence_acc(dk_acc);
      }
    }
    __syncwarp();
    if (lane == 0) tcore::mbar_arrive(&empty[s]);  // the stage is read
  }

  if (ns > 1 &&
      !fold(dk_acc, kRoles ? (wg == 0 ? kAd : kAv) : kAd, dv_acc,
            kRoles ? 0 : kAv, reinterpret_cast<float4*>(ws), kSlot4, split_i,
            ns, &counters[kt * B * KV + bkv], &last, wg, t_in))
    return;
  bf16* dk_t = dk + (static_cast<size_t>(b) * Sk * KV + kvh) * hd;
  bf16* dv_t = dv + (static_cast<size_t>(b) * Sk * KV + kvh) * hv;
  if (want_dk)
    store_rows<kAd>(dk_t, static_cast<size_t>(KV) * hd, dk_acc, scale,
                    key_a, Sk, hd, tq);
  if (want_dv) {
    if constexpr (kRoles)
      store_rows<kAv>(dv_t, static_cast<size_t>(KV) * hv, dk_acc, 1.f,
                      key_a, Sk, hv, tq);
    else
      store_rows<kAv>(dv_t, static_cast<size_t>(KV) * hv, dv_acc, 1.f,
                      key_a, Sk, hv, tq);
  }
}

// The dQ kernel.  Block: the 128 queries [q0, q0 + 128) of head h in batch
// b (consumer warpgroup w owns [q0 + 64 w, +64)), query tiles longest
// first; the key tiles the queries see stream through the ring twice.  The
// first sweep sums D = rowsum(P o dP) from the fp32 P and dP and writes it
// for the dK/dV kernel; the second forms dS and dQ.  Block 0 also zeroes
// the dK/dV kernel's fold counters.
template <int HDP, int HVP>
__global__ void __launch_bounds__(kThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int* __restrict__ counters,
                    int n_counters, int B, int Sq, int Sk, int H, int KV,
                    int hd, int s_valid, int causal, float scale,
                    float scale_log2) {
  constexpr int kAd = HDP / kAtom, kAv = HVP / kAtom;
  constexpr int kQ = kBlockRows * HDP;  // bf16 of the Q tile
  constexpr int kO = kBlockRows * HVP;  // bf16 of the dO tile
  constexpr int kK = kStep * HDP;       // bf16 of a K stage
  constexpr int kV = kStep * HVP;       // bf16 of a V stage
  extern __shared__ uint8_t smem_raw[];
  bf16* q_s = align1024(smem_raw);
  bf16* do_s = q_s + kQ;
  bf16* k_s = do_s + kO;            // [kStages][kK]
  bf16* v_s = k_s + kStages * kK;   // [kStages][kV]
  __shared__ float lse_s[kBlockRows];
  __shared__ uint64_t qd_bar, full[kStages], empty[kStages];

  const int n_qt = (Sq + kBlockRows - 1) / kBlockRows;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / (B * H)) *
                 kBlockRows;  // longest rows first
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int kv_lim = min(Sk, s_valid);
  const int kv_end = causal ? min(kv_lim, q0 + kBlockRows) : kv_lim;
  const int n_kt = (kv_end + kStep - 1) / kStep;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    tcore::mbar_init(&qd_bar, 32);  // the producer warp's lanes
    for (int s = 0; s < kStages; ++s) {
      tcore::mbar_init(&full[s], 1);
      tcore::mbar_init(&empty[s], 4 * kConsumers);
    }
    tcore::fence_mbar_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer
    tcore::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x % 32;
    if (blockIdx.x == 0)
      for (int c = lane; c < n_counters; c += 32) counters[c] = 0;
    const size_t st = (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
    for (int e = 0; e < kBlockRows / 32; ++e) {
      const int r = lane + 32 * e, qi = q0 + r;
      lse_s[r] = qi < Sq ? lse[st + qi] * kLog2e : 0.f;
    }
    if (lane != 0) {
      tcore::mbar_arrive(&qd_bar);
      return;
    }
    tcore::mbar_arrive_expect_tx(&qd_bar, (kQ + kO) * sizeof(bf16));
    for (int a = 0; a < kAd; ++a)
      tcore::tma_load_4d(q_s + a * kBlockRows * kAtom, &map_q, a * kAtom, h,
                         q0, b, &qd_bar);
    for (int a = 0; a < kAv; ++a)
      tcore::tma_load_4d(do_s + a * kBlockRows * kAtom, &map_do, a * kAtom,
                         h, q0, b, &qd_bar);
    for (int i = 0; i < 2 * n_kt; ++i) {  // key tile i % n_kt, twice
      const int s = i % kStages, n = i / kStages, k0 = (i % n_kt) * kStep;
      if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
      tcore::mbar_arrive_expect_tx(&full[s], (kK + kV) * sizeof(bf16));
      for (int a = 0; a < kAd; ++a)
        tcore::tma_load_4d(k_s + s * kK + a * kStep * kAtom, &map_k,
                           a * kAtom, kvh, k0, b, &full[s]);
      for (int a = 0; a < kAv; ++a)
        tcore::tma_load_4d(v_s + s * kV + a * kStep * kAtom, &map_v,
                           a * kAtom, kvh, k0, b, &full[s]);
    }
    return;
  }

  // consumer warpgroup wg: queries [qw0, qw0 + 64)
  tcore::setmaxnreg_inc<kConsumerRegs>();
  const int t_in = threadIdx.x % 128, warp = t_in / 32, lane = t_in % 32;
  const int g = lane / 4, tq = lane % 4;
  const int qw0 = q0 + wg * kRows;
  const int qi_a = qw0 + warp * 16 + g;  // this thread's rows: +0, +8
  const bf16* q_w = q_s + wg * kRows * kAtom;
  const bf16* do_w = do_s + wg * kRows * kAtom;
  mbar_wait(&qd_bar, 0);
  const float l2[2] = {lse_s[qi_a - q0], lse_s[qi_a + 8 - q0]};
  float dr[2] = {0.f, 0.f};  // the rows' D: partial sums, then whole
  float dq_acc[kAd][32];
  zero(dq_acc);
  for (int i = 0; i < 2 * n_kt; ++i) {
    const int s = i % kStages;
    const bool second = i >= n_kt;
    mbar_wait(&full[s], (i / kStages) & 1);
    const int k0 = (i % n_kt) * kStep;
    if (qw0 < Sq && !(causal && k0 > qw0 + kRows - 1)) {
      const bf16* ks = k_s + s * kK;
      const bf16* vs = v_s + s * kV;
      float sc[32], dp[32];  // S = Q K^T, dP = dO V^T
      tcore::wgmma_fence();
      product_ss<HDP>(sc, q_w, kBlockRows, ks, kStep);
      product_ss<HVP>(dp, do_w, kBlockRows, vs, kStep);
      tcore::wgmma_commit();
      tcore::wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool edge = qw0 + kRows > Sq || k0 + kStep > kv_lim ||
                        (causal && k0 + kStep - 1 > qw0);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = k0 + (e / 4) * 8 + 2 * tq + (e & 1);
        const int r = (e >> 1) & 1;
        const int qi = qi_a + 8 * r;
        float p = exp2f(sc[e] * scale_log2 - l2[r]);
        if (edge && (key >= kv_lim || qi >= Sq || (causal && key > qi)))
          p = 0.f;
        if (second)
          sc[e] = p * (dp[e] - dr[r]);  // dS
        else
          dr[r] = fmaf(p, dp[e], dr[r]);
      }
      if (second) {
        unsigned sh[4][4], sl[4][4];
        a_operands(sc, sh, sl);
        tcore::wgmma_fence();
        product_rs<kAd>(dq_acc, sh, sl, ks, kStep);  // dQ += dS K
        tcore::wgmma_commit();
        tcore::wgmma_wait<0>();
        fence_ops(sh);
        fence_ops(sl);
        fence_acc(dq_acc);
      }
    }
    if (i == n_kt - 1) {  // the first sweep is done: D of the two rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the quad's lanes, a fixed tree
        dr[r] += __shfl_xor_sync(kFull, dr[r], 1);
        dr[r] += __shfl_xor_sync(kFull, dr[r], 2);
        const int qi = qi_a + 8 * r;
        if (tq == 0 && qi < Sq)
          delta[(static_cast<size_t>(b) * H + h) * Sq + qi] = dr[r];
      }
    }
    __syncwarp();
    if (lane == 0) tcore::mbar_arrive(&empty[s]);
  }
  const size_t ld = static_cast<size_t>(H) * hd;
  store_rows<kAd>(dq + (static_cast<size_t>(b) * Sq * H + h) * hd, ld,
                  dq_acc, scale, qi_a, Sq, hd, tq);
}

// A (B, S, heads, w) bf16 tensor's map for the TMA: boxes of 64 columns
// (128 bytes, swizzled) of one head and `rows` tokens; columns past w and
// tokens past S read as zeros
bool encode(CUtensorMap* map, const void* base, int B, int S, int heads,
            int w, int rows) {
  const tcore::EncodeTiled fn = tcore::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(w) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {kAtom, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// blocks of the dK/dV grid: every `keys`-key tile of every (b, KV head)
// cut into max(1, ceil(steps / chunk)) shares
// (kernels/flash_attention.py::plan)
int dkv_blocks(int B, int Sq, int Sk, int H, int KV, int causal, int chunk,
               int keys) {
  const int group = H / KV, n_qt = (Sq + kStep - 1) / kStep;
  const int n_kt = (Sk + keys - 1) / keys;
  int blocks = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int steps = group * (n_qt - (causal ? kt * (keys / kStep) : 0));
    blocks += B * KV * max(1, (steps + chunk - 1) / chunk);
  }
  return blocks;
}

template <int HDP, int HVP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv,
           float* ws, int* counters, int B, int Sq, int Sk, int H, int KV,
           int hd, int hv, int s_valid, int causal, float scale, int chunk,
           int device, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP, HVP>();
  constexpr int kKeys = dkv_keys<HDP, HVP>();
  auto dqk = dq_wgmma_kernel<HDP, HVP>;
  auto dkv = dkv_wgmma_kernel<HDP, HVP>;
  static bool ready[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(dkv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const float scale_log2 = scale * kLog2e;
  const int n_counters = B * KV * ((Sk + kKeys - 1) / kKeys);
  CUtensorMap mq{}, mdo{}, mk{}, mv{};
  // dQ: the block's 128 queries held, 64-key stages
  if (!encode(&mq, q, B, Sq, H, hd, kBlockRows) ||
      !encode(&mdo, dout, B, Sq, H, hv, kBlockRows) ||
      !encode(&mk, k, B, Sk, KV, hd, kStep) ||
      !encode(&mv, v, B, Sk, KV, hv, kStep))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (Sq + kBlockRows - 1) / kBlockRows;
  dqk<<<B * H * q_tiles, kThreads, smem, stream>>>(
      mq, mdo, mk, mv, lse, delta, static_cast<bf16*>(dq), counters,
      n_counters, B, Sq, Sk, H, KV, hd, s_valid, causal, scale,
      scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dK/dV: the block's kKeys keys held, 64-query stages
  if (!encode(&mq, q, B, Sq, H, hd, kStep) ||
      !encode(&mdo, dout, B, Sq, H, hv, kStep) ||
      !encode(&mk, k, B, Sk, KV, hd, kKeys) ||
      !encode(&mv, v, B, Sk, KV, hv, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  dkv<<<dkv_blocks(B, Sq, Sk, H, KV, causal, chunk, kKeys), kThreads, smem,
        stream>>>(mq, mdo, mk, mv, lse, delta, static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv), ws, counters, B, Sq, Sk, H, KV, hd,
                  hv, s_valid, causal, scale, scale_log2, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// The tensor-core entry point: q, dq: (B, Sq, H, hd); dout: (B, Sq, H,
// hv); k, dk: (B, Sk, KV, hd); v, dv: (B, Sk, KV, hv); contiguous bf16
// with 16-byte aligned bases; Sk = Sq when causal; lse: (B, H, Sq) fp32
// from flash_attention_mma_bf16_lse; delta: (B, H, Sq) fp32 scratch; H a
// multiple of KV; hd and hv multiples of 16, hd up to 192 and hv up to
// 128, compiled at (64, 64) or (128, 128) for hd = hv and (192, 128) for
// any hv != hd.
// chunk: the most (query head, 64-query tile) steps a dK/dV block takes
// (kernels/flash_attention.py::plan); ws: fp32 scratch of 2 * 128 * 32 *
// atoms floats per dK/dV block (atoms = 2 * hd_p / 64 at (64, 64) and
// (128, 128), 3 at (192, 128)), read only where a key tile is split;
// counters: B * KV * ceil(Sk / keys) ints (keys = 128, or 64 at (192,
// 128)), zeroed by the dQ kernel.  Launches the dQ then the dK/dV kernel
// on `stream` of `device`; returns the first failing launch's cudaError_t
// (0 when both launched).
extern "C" int flash_attention_bwd_mma_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, void* ws,
    void* counters, int B, int Sq, int Sk, int H, int KV, int hd, int hv,
    int s_valid, int causal, float scale, int chunk, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd < 16 || hd > 192 || hd % 16 != 0 || hv < 16 || hv > 128 ||
      hv % 16 != 0 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  if (hd != hv)  // a value width of its own: the (192, 128) pair
    return tc::launch<192, 128>(q, k, v, dout, l, d, dq, dk, dv, w, c, B,
                                Sq, Sk, H, KV, hd, hv, s_valid, causal,
                                scale, chunk, device, st);
  if (hd <= 64)
    return tc::launch<64, 64>(q, k, v, dout, l, d, dq, dk, dv, w, c, B, Sq,
                              Sk, H, KV, hd, hv, s_valid, causal, scale,
                              chunk, device, st);
  return tc::launch<128, 128>(q, k, v, dout, l, d, dq, dk, dv, w, c, B, Sq,
                              Sk, H, KV, hd, hv, s_valid, causal, scale,
                              chunk, device, st);
}

// The CUDA-core entry point: the same arguments, all fp32 (bf16 = 0) or all
// bf16 (bf16 = 1), 1 <= hd, hv <= 256, lse from flash_attention_fwd_lse.
extern "C" int flash_attention_bwd_simt(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B,
    int Sq, int Sk, int H, int KV, int hd, int hv, int s_valid, int causal,
    float scale, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  const float* l = static_cast<const float*>(lse);
  if (bf16)
    return simt::launch_typed<__nv_bfloat16>(q, k, v, dout, l, d, dq, dk, dv,
                                             B, Sq, Sk, H, KV, hd, hv,
                                             s_valid, causal, scale, st);
  return simt::launch_typed<float>(q, k, v, dout, l, d, dq, dk, dv, B, Sq,
                                   Sk, H, KV, hd, hv, s_valid, causal, scale,
                                   st);
}
