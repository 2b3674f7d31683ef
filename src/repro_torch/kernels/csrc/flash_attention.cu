// Causal (or full) online-softmax attention, GQA, forward only:
//
//   o[b, i, h, :] = sum_j softmax_j(scale * <q[b, i, h], k[b, j, h / g]>) v[b, j, h / g]
//
// over keys j < s_valid (and j <= i when causal), scale = 1 / sqrt(hd),
// g = H / KV query heads per KV head.  q: (B, Sq, H, hd); k: (B, Sk, KV,
// hd); v: (B, Sk, KV, hv); o: (B, Sq, H, hv), the value width hv apart
// from the q/k width hd (MLA's expanded form: hd 192, hv 128) and the key
// length Sk apart from the query length Sq (an encoder-decoder's cross
// attention: whisper's 448 text tokens over 1,500 audio frames; a causal
// call has Sk = Sq); fp32 or bf16 in, computed in fp32, written in q's
// type.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas kernel over a (B*H, q tiles, kv tiles) grid whose running (max,
// sum, acc) live in VMEM scratch across the sequential kv axis; its
// wrapper src/repro/kernels/ops.py::flash_attention repeats the KV heads
// and pads S to the tiles).  On the serving path it is every layer's
// attention in the transformer prefill (models/transformer.py::prefill
// through kernels/ops.py::flash_attention).
//
// Two entry points, picked by the wrapper from dtype and widths (never on
// failure): flash_attention_mma_bf16, the tensor-core kernel, for bf16
// with hd and hv multiples of 16, hd up to 192 and hv up to 128
// (llama3-8b's prefill at (128, 128), deepseek-v3-671b's MLA at (192,
// 128)); and flash_attention_fwd, the CUDA-core kernel, for fp32 and for
// the other widths up to 256 each.
//
// Bound on an H100 at the prefill's shape (B 4, S 512, H 32, KV 8, hd 128,
// causal, bf16): 8.6 GFLOP of the causal half, which the bf16 tensor cores
// could do in 8.7 us, under the 42 MB of q/k/v/o traffic, 12.5 us at 3.35
// TB/s: bytes bound the function.  At (B 1, S 4096) the 137 GFLOP take
// 139 us: operations.  At MLA's serving shape (B 4, S 512, H = KV 128, hd
// 192, hv 128) the 42.9 GFLOP take 43 us and the 335 MB of q/k/v/o 100
// us: bytes, since MLA's expanded form shares no K/V between heads.  At
// whisper-large-v3's cross attention in training (B 8, Sq 448, Sk 1,500,
// H = KV 20, hd 64, not causal) the 27.5 GFLOP take 28 us and the 80 MB
// 24 us: operations.
//
// Tensor-core design (flash_mma_kernel).  One block of 4 warps per (b*h,
// 64-query tile); each warp owns 16 query rows.  S = Q K^T comes from
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) with Q and K fed from
// shared memory by ldmatrix; S, the running (max, sum) and O stay in
// registers in the mma fragment layout, and the four lanes of a fragment
// row merge the max and the sum with two shuffles.  K and V tiles of 64
// keys are staged as bf16 in a two-stage cp.async ring, the next tile
// loading while this one computes; staged rows are padded by 16 bytes, so
// the eight rows an ldmatrix reads fall in distinct banks.  The fp32
// scores are scaled by log2(e) / sqrt(hd) after the product (the
// reference scales q after its fp32 cast: the two orders differ by an fp32
// ulp, where a bf16 q * scale would round by 2^-9) and exponentiated with
// exp2.  O += P V takes P as two bf16 halves, P_hi = bf16(P) and P_lo =
// bf16(P - P_hi), in two mmas into one fp32 accumulator (V through
// ldmatrix.trans), so P keeps ~16 bits where one bf16 P would carry a
// 2^-9 relative error into every output: the reference multiplies fp32 P
// by V.  Causal tiles past the query tile's diagonal are skipped, and only
// a tile that holds the diagonal, s_valid or Sk is masked element by
// element; a row with no valid key yet adds nothing, with no NaN.  Query
// tiles run longest first (reversed blockIdx.y).  K and V are addressed by
// their own length Sk (batch offsets, key tiles, the s_valid clip), so a
// cross attention reads them as they are: nothing pads them to Sq.  Q and K are staged at
// the compiled q/k width HDP and V at the value width HVP, columns past
// hd (hv) zero-filled: (32, 32), (64, 64) and (128, 128) for hd = hv (the
// dense family's calls, compiled as before the value width existed), and
// (192, 128) for any hv != hd.  At (192, 128) S = Q K^T takes 12 k-steps
// of 16 where (128, 128) takes 8; the O accumulator stays 64 x 128 fp32,
// and the Q, K and V tiles take 109 KB of shared memory (two stages of K
// and V), so two blocks still share an SM.  wgmma with TMA
// and warp specialisation, and one K/V tile shared by the g query heads of
// a KV head, are later work.
//
// CUDA-core design (flash_kernel).  One thread block of 256
// threads per (b*h, 64-query tile); four threads share a query row.  The
// block stages its 64 query rows in shared memory once (converted to fp32,
// then scaled, as the Pallas kernel scales after its fp32 cast), then
// walks the KV tiles of 32 keys up to the tile's diagonal (causal) or to
// the end, each staged in shared memory as fp32 and read from KV head h /
// g in place: no repeated-KV copy.  A thread scores 8 keys of its row
// (16-byte shared loads along hd), the four threads of a row merge the
// tile's max and sum with shuffles, keep the running (max, sum) in
// registers, pass the row's probabilities through shared memory, and each
// accumulates a quarter of the row's (hv,) output in fp32 registers.  Its
// fp32 FMAs make 128 us its own floor at the prefill's shape.  Keys at or
// after s_valid, and after the query when causal, carry no mass; rows past
// Sq and keys past Sk are masked, so neither need be a multiple of a tile.
// Staged rows are zero-padded to the next compiled width (32, 64, 128 or
// 256) of hd = hv, or to 256 for any hv != hd, so any hd and hv <= 256
// run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tensor_core.cuh"

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

// kOwnV: v and o carry a width hv of their own; without it hv = hd, and
// the kernel is the one the dense family's calls (hd = hv) always ran
template <int HDMAX, typename T, bool kOwnV>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int hd, int hv_arg, int s_valid, int causal, float scale) {
  const int hv = kOwnV ? hv_arg : hd;
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
  const size_t v_row = kOwnV ? static_cast<size_t>(KV) * hv : kv_row;
  const size_t o_row = kOwnV ? static_cast<size_t>(H) * hv : q_row;
  const T* qb = q + static_cast<size_t>(b) * Sq * q_row +
                static_cast<size_t>(h) * hd;
  const T* kb = k + static_cast<size_t>(b) * Sk * kv_row +
                static_cast<size_t>(kvh) * hd;
  const T* vb = v + static_cast<size_t>(b) * Sk * v_row +
                static_cast<size_t>(kvh) * hv;

  for (int idx = tid; idx < kBQ * kStride; idx += kThreads) {
    const int r = idx / kStride, c = idx % kStride, s = q0 + r;
    q_s[idx] = (s < Sq && c < hd)
                   ? to_f32(qb[static_cast<size_t>(s) * q_row + c]) * scale
                   : 0.f;
  }

  int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
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
      if constexpr (kOwnV) {
        k_s[idx] = s < kv_end && c < hd
                       ? to_f32(kb[static_cast<size_t>(s) * kv_row + c])
                       : 0.f;
        v_s[idx] = s < kv_end && c < hv
                       ? to_f32(vb[static_cast<size_t>(s) * v_row + c])
                       : 0.f;
      } else {
        const bool ok = s < kv_end && c < hd;
        const size_t off = static_cast<size_t>(s) * kv_row + c;
        k_s[idx] = ok ? to_f32(kb[off]) : 0.f;
        v_s[idx] = ok ? to_f32(vb[off]) : 0.f;
      }
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

  if (qi < Sq && lse != nullptr && quad == 0)  // +inf: a row with no key
    lse[(static_cast<size_t>(b) * H + h) * Sq + qi] =
        l_run > 0.f ? m_run + logf(l_run) : CUDART_INF_F;
  if (qi < Sq) {
    const float denom = fmaxf(l_run, 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * Sq + qi) * o_row +
              static_cast<size_t>(h) * hv;
#pragma unroll
    for (int j4 = 0; j4 < kCols / 4; ++j4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (quad + kQuad * j4) + e;
        if (c < hv) store(orow + c, acc[4 * j4 + e] / denom);
      }
    }
  }
}

template <int HDMAX, typename T, bool kOwnV = false>
int launch_width(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
                 int hv, int s_valid, int causal, float scale,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes<HDMAX>();
  auto kernel = flash_kernel<HDMAX, T, kOwnV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KV, hd,
      hv, s_valid, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
                 int hv, int s_valid, int causal, float scale,
                 cudaStream_t stream) {
  if (hd < 1 || hv < 1 || hd > 256 || hv > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd != hv)  // a value width of its own: one instantiation takes all
    return launch_width<256, T, true>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                      hd, hv, s_valid, causal, scale,
                                      stream);
  if (hd <= 32)
    return launch_width<32, T>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, hv,
                               s_valid, causal, scale, stream);
  if (hd <= 64)
    return launch_width<64, T>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, hv,
                               s_valid, causal, scale, stream);
  if (hd <= 128)
    return launch_width<128, T>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, hv,
                                s_valid, causal, scale, stream);
  return launch_width<256, T>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, hv,
                              s_valid, causal, scale, stream);
}

}  // namespace

// The CUDA-core entry point: q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v:
// (B, Sk, KV, hv); o: (B, Sq, H, hv); contiguous, all fp32 (bf16 = 0) or
// all bf16 (bf16 = 1); H a multiple of KV; 1 <= hd, hv <= 256; Sk = Sq
// when causal; keys at or after s_valid carry no mass.  Launches on
// `stream` of `device`; returns the launch's cudaError_t.
// flash_attention_fwd_lse also writes lse (B, H, Sq) fp32, each row's
// natural-log sum of exp(scale * q.k) over its keys (+inf for a row with
// none): the residual of the backward (flash_attention_bwd.cu).
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Sq, int Sk, int H,
                                       int KV, int hd, int hv, int s_valid,
                                       int causal, float scale, int bf16,
                                       int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, o, l, B, Sq, Sk, H, KV, hd,
                                       hv, s_valid, causal, scale, st);
  return launch_typed<float>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, hv,
                             s_valid, causal, scale, st);
}

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int KV, int hd, int hv,
                                   int s_valid, int causal, float scale,
                                   int bf16, int device, void* stream) {
  return flash_attention_fwd_lse(q, k, v, o, nullptr, B, Sq, Sk, H, KV, hd,
                                 hv, s_valid, causal, scale, bf16, device,
                                 stream);
}

namespace {
namespace tc {  // the bf16 tensor-core kernel

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // query rows per block: 16 per warp
constexpr int kBK = 64;  // keys per staged K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

using tcore::cp_async_commit;
using tcore::ldsm_x4;
using tcore::ldsm_x4_trans;
using tcore::mma;

// bf16 per staged row: hd padded to HDP plus 16 bytes, so that the eight
// 16-byte rows one ldmatrix reads start in eight different bank groups
template <int HDP>
__host__ __device__ constexpr int pitch() {
  return HDP + 8;
}

template <int HDP, int HVP>
constexpr size_t smem_bytes() {  // Q tile, then two K and two V stages
  return (static_cast<size_t>(kBQ + 2 * kBK) * pitch<HDP>() +
          static_cast<size_t>(2 * kBK) * pitch<HVP>()) *
         sizeof(bf16);
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

// Stage keys [k0, k0 + kBK) of a K (or V) tile of W columns, row stride
// `row`, into xs; keys at or past kv_end and columns past w are zero.
template <int W>
__device__ __forceinline__ void load_rows(bf16* xs, const bf16* xb, int k0,
                                          int kv_end, size_t row, int w) {
  constexpr int P = pitch<W>();
  constexpr int kChunks = W / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < kBK * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool ok = k0 + r < kv_end && c < w;
    const size_t off = static_cast<size_t>(k0 + r) * row + c;
    tcore::cp_async<16>(xs + r * P + c, ok ? xb + off : xb, ok);
  }
}

// K and V tiles of one width (hv = hd), in one pass: the same rows and
// offsets for both
template <int HDP>
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs,
                                        const bf16* kb, const bf16* vb,
                                        int k0, int kv_end, size_t kv_row,
                                        int hd) {
  constexpr int P = pitch<HDP>();
  constexpr int kChunks = HDP / 8;
  for (int e = threadIdx.x; e < kBK * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool ok = k0 + r < kv_end && c < hd;
    const size_t off = static_cast<size_t>(k0 + r) * kv_row + c;
    tcore::cp_async<16>(ks + r * P + c, ok ? kb + off : kb, ok);
    tcore::cp_async<16>(vs + r * P + c, ok ? vb + off : vb, ok);
  }
}

// keys [k0, k0 + kBK) of K and V into ks and vs
template <int HDP, int HVP>
__device__ __forceinline__ void load_tiles(bf16* ks, bf16* vs,
                                           const bf16* kb, const bf16* vb,
                                           int k0, int kv_end,
                                           size_t kv_row, size_t v_row,
                                           int hd, int hv) {
  if constexpr (HDP == HVP) {
    load_kv<HDP>(ks, vs, kb, vb, k0, kv_end, kv_row, hd);
  } else {
    load_rows<HDP>(ks, kb, k0, kv_end, kv_row, hd);
    load_rows<HVP>(vs, vb, k0, kv_end, v_row, hv);
  }
}

// (HDP, HVP): the compiled q/k and value widths; at HDP = HVP the value
// width is hd (the dense family's calls), else hv
template <int HDP, int HVP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                     int hd, int hv_arg, int s_valid, int causal,
                     float scale_log2) {
  constexpr bool kOwnV = HDP != HVP;
  const int hv = kOwnV ? hv_arg : hd;
  constexpr int P = pitch<HDP>();    // Q and K rows
  constexpr int PV = pitch<HVP>();   // V rows
  constexpr int kChunks = HDP / 8;
  constexpr int kDSteps = HDP / 16;  // k-steps of Q K^T over hd
  constexpr int kSTiles = kBK / 8;   // n-tiles of S (8 keys each)
  constexpr int kOTiles = HVP / 8;   // n-tiles of O (8 columns each)
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // [kBQ][P]
  bf16* k_s = q_s + kBQ * P;                   // [2][kBK][P]
  bf16* v_s = k_s + 2 * kBK * P;               // [2][kBK][PV]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int qi0 = q0 + warp * 16 + g;  // this thread's rows: qi0, qi0 + 8

  const size_t q_row = static_cast<size_t>(H) * hd;  // elements per token
  const size_t kv_row = static_cast<size_t>(KV) * hd;
  const size_t v_row = kOwnV ? static_cast<size_t>(KV) * hv : kv_row;
  const size_t o_row = kOwnV ? static_cast<size_t>(H) * hv : q_row;
  const bf16* qb = q + static_cast<size_t>(b) * Sq * q_row +
                   static_cast<size_t>(h) * hd;
  const bf16* kb = k + static_cast<size_t>(b) * Sk * kv_row +
                   static_cast<size_t>(kvh) * hd;
  const bf16* vb = v + static_cast<size_t>(b) * Sk * v_row +
                   static_cast<size_t>(kvh) * hv;

  const int kv_lim = min(Sk, s_valid);
  const int kv_end = causal ? min(kv_lim, q0 + kBQ) : kv_lim;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int e = threadIdx.x; e < kBQ * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool ok = q0 + r < Sq && c < hd;
    tcore::cp_async<16>(
        q_s + r * P + c,
        ok ? qb + static_cast<size_t>(q0 + r) * q_row + c : qb, ok);
  }
  load_tiles<HDP, HVP>(k_s, v_s, kb, vb, 0, kv_end, kv_row, v_row, hd, hv);
  cp_async_commit();

  float o_acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles)
      load_tiles<HDP, HVP>(k_s + ((t + 1) & 1) * kBK * P,
                           v_s + ((t + 1) & 1) * kBK * PV, kb, vb,
                           (t + 1) * kBK, kv_end, kv_row, v_row, hd, hv);
    cp_async_commit();  // possibly empty: one group per tile
    tcore::cp_async_wait<1>();  // tile t (and Q) have landed
    __syncthreads();
    const bf16* ks = k_s + (t & 1) * kBK * P;
    const bf16* vs = v_s + (t & 1) * kBK * PV;
    const int k0 = t * kBK;

    // S = Q K^T: 16 rows x 64 keys per warp, fp32 in fragment layout
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d = 0; d < kDSteps; ++d) {
      unsigned a[4];
      ldsm_x4(q_s + (warp * 16 + (lane & 15)) * P + d * 16 + (lane >> 4) * 8,
              a);
#pragma unroll
      for (int n = 0; n < kSTiles / 2; ++n) {
        unsigned kf[4];
        ldsm_x4(ks + (n * 16 + (lane & 7) + (lane >> 4) * 8) * P + d * 16 +
                    ((lane >> 3) & 1) * 8,
                kf);
        mma(s[2 * n], a, kf[0], kf[1]);
        mma(s[2 * n + 1], a, kf[2], kf[3]);
      }
    }

    // scale after the product, mask the tiles that need it, new max
    const bool edge = k0 + kBK > kv_lim || (causal && k0 + kBK > q0 + 1);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = k0 + n * 8 + 2 * tig + (e & 1);
          if (key >= kv_lim || (causal && key > qi0 + (e >> 1) * 8))
            x = -CUDART_INF_F;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // a row with no valid key yet (m_new = -inf) adds nothing
      m_use[i] = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float corr =
          m_run[i] == -CUDART_INF_F ? 0.f : exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= corr;
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        o_acc[n][2 * i] *= corr;
        o_acc[n][2 * i + 1] *= corr;
      }
    }

    // O += P V over 16 keys at a time, P as P_hi + P_lo
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      float p[2][4];  // n-tiles 2j and 2j + 1 of S
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[u][e] = exp2f(s[2 * j + u][e] - m_use[e >> 1]);
          l_run[e >> 1] += p[u][e];
        }
      unsigned hi[4], lo[4];  // the A fragment: rows g, g + 8; keys 0-7, 8-15
      split(p[0][0], p[0][1], hi[0], lo[0]);
      split(p[0][2], p[0][3], hi[1], lo[1]);
      split(p[1][0], p[1][1], hi[2], lo[2]);
      split(p[1][2], p[1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < kOTiles / 2; ++n) {
        unsigned vf[4];
        ldsm_x4_trans(vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PV +
                          n * 16 + (lane >> 4) * 8,
                      vf);
        mma(o_acc[2 * n], hi, vf[0], vf[1]);
        mma(o_acc[2 * n], lo, vf[0], vf[1]);
        mma(o_acc[2 * n + 1], hi, vf[2], vf[3]);
        mma(o_acc[2 * n + 1], lo, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int qi = qi0 + 8 * i;
    if (qi < Sq && lse != nullptr && tig == 0)  // natural log; +inf: no key
      lse[(static_cast<size_t>(b) * H + h) * Sq + qi] =
          l > 0.f ? (m_run[i] + log2f(l)) * 0.69314718055994531f
                  : CUDART_INF_F;
    if (qi < Sq) {
      bf16* orow = o + (static_cast<size_t>(b) * Sq + qi) * o_row +
                   static_cast<size_t>(h) * hv;
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        const int c = n * 8 + 2 * tig;
        if (c < hv)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o_acc[n][2 * i] / denom,
                                    o_acc[n][2 * i + 1] / denom);
      }
    }
  }
}

template <int HDP, int HVP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KV, int hd, int hv,
           int s_valid, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP, HVP>();
  auto kernel = flash_mma_kernel<HDP, HVP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Sk, H,
      KV, hd, hv, s_valid, causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// The tensor-core entry point: q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v:
// (B, Sk, KV, hv); o: (B, Sq, H, hv); contiguous bf16 with 16-byte aligned
// bases; H a multiple of KV; hd and hv multiples of 16, hd up to 192 and
// hv up to 128; Sk = Sq when causal; keys at or after s_valid carry no
// mass.  flash_attention_mma_bf16_lse also writes lse (B, H, Sq) fp32, as
// flash_attention_fwd_lse does.  Launches on `stream` of `device`;
// returns the launch's cudaError_t.
extern "C" int flash_attention_mma_bf16_lse(const void* q, const void* k,
                                            const void* v, void* o,
                                            void* lse, int B, int Sq,
                                            int Sk, int H, int KV, int hd,
                                            int hv, int s_valid, int causal,
                                            float scale, int device,
                                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd < 16 || hd > 192 || hd % 16 != 0 || hv < 16 || hv > 128 ||
      hv % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd != hv)  // a value width of its own: the (192, 128) pair
    return tc::launch<192, 128>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, hv,
                                s_valid, causal, scale, st);
  if (hd <= 32)
    return tc::launch<32, 32>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, hv,
                              s_valid, causal, scale, st);
  if (hd <= 64)
    return tc::launch<64, 64>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, hv,
                              s_valid, causal, scale, st);
  return tc::launch<128, 128>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, hv,
                              s_valid, causal, scale, st);
}

extern "C" int flash_attention_mma_bf16(const void* q, const void* k,
                                        const void* v, void* o, int B,
                                        int Sq, int Sk, int H, int KV,
                                        int hd, int hv, int s_valid,
                                        int causal, float scale, int device,
                                        void* stream) {
  return flash_attention_mma_bf16_lse(q, k, v, o, nullptr, B, Sq, Sk, H,
                                      KV, hd, hv, s_valid, causal, scale,
                                      device, stream);
}
