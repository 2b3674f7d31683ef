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
// d = 128, D = 128 features), for the route it takes: the (L*B, d) x (d, D)
// product is 4.3 GFLOP, and 3xTF32 spends three TF32 products on each
// fp32-accurate one, so 12.9 GFLOP at the 495 TFLOP/s TF32 tensor-core
// rate = 26 us (the same work on the CUDA cores at 67 TFLOP/s: 64 us),
// against 67 MB read = 20 us at 3.35 TB/s.  Operations bound it, closely
// followed by bytes.
//
// Design.  The function is a (L*B, d) x (d, D) product whose epilogue
// (exp, mask, sum over each leaf's B rows) never leaves the block, so the
// (L*B, D) feature matrix is never written.  What held the kernel this one
// replaced back (fp32 FMAs in 4 x 4 micro-tiles, loads not overlapped with
// the math, transposed scalar stores that conflicted on banks, omega read
// once per 64 features), and what this one does about it:
//  1. The product runs on the tensor cores in 3xTF32: mma.sync m16n8k8
//     .tf32 with each fp32 operand split as x = hi + lo (hi = x rounded to
//     TF32, lo = the remainder rounded to TF32) and a_lo b_hi + a_hi b_lo +
//     a_hi b_hi summed in fp32, which keeps about fp32's digits.  One TF32
//     product keeps about 3, and the exp amplifies what it loses: the gate
//     holds the sums to 1e-5 of their largest.  The tensor cores' own
//     accumulation truncates, so each 32-column chunk's products go into
//     fresh fragments that fp32 adds (round to nearest) fold into the
//     running sums: a running sum kept in the tensor cores failed the
//     ragged gate (37, 50, 126) on the card.
//  2. One block of 8 warps per (leaf, 128 features), 4 x 2 warps of 32
//     rows x 64 features (2 m16 x 8 n8 tiles) over the leaf's rows 128
//     at a time (acc and the chunk's fresh fragments take ~240 registers
//     a thread, so one block per SM).  Every warp splits the values it
//     multiplies as it loads them, by integer adds and masks (see
//     tensor_core.cuh::split_tf32): a split pass into shared memory once
//     per chunk cost a second barrier per chunk and was slower.  omega's
//     chunk is staged once per block and pass: read twice per 256-row
//     leaf, against four times before.
//  3. 32-column chunks of the rows and of omega, in their natural layout,
//     go through a kStages-deep cp.async ring (16-byte copies; 4-byte ones
//     where d % 4 != 0 or a base is not 16-byte aligned).  Rows are padded
//     to 36 floats, so a warp's fragment reads (8 rows x 4 columns) fall
//     in 32 distinct banks.
// The squared row norms ride along on the A fragments (each row's values
// pass through its quad of lanes once).  After a pass each thread sums
// exp(...) * mask of its rows per feature straight from the accumulator
// fragments; shuffles sum a warp's rows into shared memory, and the row
// warps are summed in a fixed order at the end.  Ragged rows, widths and
// features are zero-filled in the copies and masked in the epilogue.
// logshift is read from device memory, so the caller never syncs on it.
// expf, not __expf: the plain version is held at 1e-5.
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kRows = 128;  // rows of a leaf per pass
constexpr int kFeat = 128;  // features per block
constexpr int kWarpsR = 4;  // warps over rows
constexpr int kWarpsF = 2;  // warps over features
constexpr int kThreads = 32 * kWarpsR * kWarpsF;
constexpr int kWR = kRows / kWarpsR;  // rows per warp
constexpr int kWF = kFeat / kWarpsF;  // features per warp
constexpr int kMi = kWR / 16;         // m16 tiles per warp
constexpr int kNj = kWF / 8;          // n8 tiles per warp
constexpr int kDc = 32;               // columns per staged chunk
constexpr int kPitch = kDc + 4;       // = 4 (mod 32) floats per staged row
constexpr int kStages = 3;
constexpr int kStage = (kRows + kFeat) * kPitch;  // floats per ring slot
constexpr size_t kSmem = static_cast<size_t>(kStages) * kStage * 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads, 1)
    rff_features_kernel(const float* __restrict__ w,
                        const float* __restrict__ omega,
                        const float* __restrict__ mask,
                        const float* __restrict__ logshift,
                        float* __restrict__ out, int B, int d, int D,
                        float inv_sqrt_tau, float inv_2tau, float inv_sqrt_d,
                        int vec) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][kStage]
  __shared__ float red[kWarpsR][kFeat];  // per-feature sums by row warp

  const int l = blockIdx.x;
  const int k0 = blockIdx.y * kFeat;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wr = warp / kWarpsF;
  const int wr0 = wr * kWR, wf0 = (warp % kWarpsF) * kWF;
  const float* wl = w + static_cast<size_t>(l) * B * d;
  const int n_dc = (d + kDc - 1) / kDc;
  const int n_chunks = (B + kRows - 1) / kRows * n_dc;

  // chunk c: columns (c % n_dc) * kDc .. of the leaf's rows (c / n_dc) *
  // kRows .. and of omega's features k0 ..; past B, D or d zero-filled
  auto load = [&](int c, int slot) {
    const int b0 = (c / n_dc) * kRows, c0 = (c % n_dc) * kDc;
    float* s = ring + slot * kStage;
    if (vec) {
      for (int e = threadIdx.x; e < (kRows + kFeat) * (kDc / 4);
           e += kThreads) {
        const int r = e / (kDc / 4), cc = (e % (kDc / 4)) * 4;
        const bool is_w = r < kRows;
        const int row = is_w ? b0 + r : k0 + r - kRows;
        const float* base = is_w ? wl : omega;
        const bool ok = row < (is_w ? B : D) && c0 + cc < d;
        tcore::cp_async<16>(
            s + r * kPitch + cc,
            ok ? base + static_cast<size_t>(row) * d + c0 + cc : base, ok);
      }
    } else {
      for (int e = threadIdx.x; e < (kRows + kFeat) * kDc; e += kThreads) {
        const int r = e / kDc, cc = e % kDc;
        const bool is_w = r < kRows;
        const int row = is_w ? b0 + r : k0 + r - kRows;
        const float* base = is_w ? wl : omega;
        const bool ok = row < (is_w ? B : D) && c0 + cc < d;
        tcore::cp_async<4>(
            s + r * kPitch + cc,
            ok ? base + static_cast<size_t>(row) * d + c0 + cc : base, ok);
      }
    }
  };
  int pc = 0;  // the next chunk to stage
  auto prefetch = [&](int slot) {
    if (pc < n_chunks) load(pc, slot);
    ++pc;
    tcore::cp_async_commit();  // possibly empty: one group per chunk
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  for (int f = threadIdx.x; f < kWarpsR * kFeat; f += kThreads)
    red[f / kFeat][f % kFeat] = 0.f;  // read after the loop's barriers
  const float shift = *logshift;
  float acc[kMi][kNj][4];
  float nrm[kMi][2];
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
    nrm[i][0] = nrm[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < kNj; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    tcore::cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();  // ... for every thread; the slot read last is free
    prefetch((c + kStages - 1) % kStages);
    const float* chunk = ring + (c % kStages) * kStage;
    const float* ws = chunk + (wr0 + g) * kPitch;
    const float* os = chunk + (kRows + wf0 + g) * kPitch;
    // the chunk's products go into fresh fragments, added to the running
    // sums by fp32 adds, which round to nearest: the tensor cores' own
    // accumulation truncates, and a running sum kept there over d = 126
    // drifted past the ragged gate
    float t[kMi][kNj][4];
#pragma unroll
    for (int i = 0; i < kMi; ++i)
#pragma unroll
      for (int n = 0; n < kNj; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDc; kk += 8) {
      unsigned ahi[kMi][4], alo[kMi][4];
#pragma unroll
      for (int i = 0; i < kMi; ++i) {
        // rows g, g + 8 of m16 tile i; columns kk + tig, kk + tig + 4
        const float* p = ws + i * 16 * kPitch + kk + tig;
        const float x[4] = {p[0], p[8 * kPitch], p[4],
                            p[8 * kPitch + 4]};
        nrm[i][0] = fmaf(x[0], x[0], fmaf(x[2], x[2], nrm[i][0]));
        nrm[i][1] = fmaf(x[1], x[1], fmaf(x[3], x[3], nrm[i][1]));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tcore::split_tf32(x[e], ahi[i][e], alo[i][e]);
      }
#pragma unroll
      for (int n = 0; n < kNj; ++n) {
        // feature g of n8 tile n, split here by every warp that uses it
        const float* o = os + n * 8 * kPitch + kk;
        uint2 b0, b1;  // (hi, lo) at columns kk + tig, kk + tig + 4
        tcore::split_tf32(o[tig], b0.x, b0.y);
        tcore::split_tf32(o[tig + 4], b1.x, b1.y);
#pragma unroll
        for (int i = 0; i < kMi; ++i) {
          tcore::mma_tf32(t[i][n], alo[i], b0.x, b1.x);
          tcore::mma_tf32(t[i][n], ahi[i], b0.y, b1.y);
          tcore::mma_tf32(t[i][n], ahi[i], b0.x, b1.x);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMi; ++i)
#pragma unroll
      for (int n = 0; n < kNj; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += t[i][n][e];
    if (c % n_dc != n_dc - 1) continue;

    // the pass's rows are done: this thread's rows g, g + 8 of each m16
    // tile (norms summed over the quad), summed per feature over the
    // warp's rows (lanes of one tig: xor 4, 8, 16) into red[wr]
    const int b0 = (c / n_dc) * kRows + wr0;
    float base[kMi][2], mk[kMi][2];
#pragma unroll
    for (int i = 0; i < kMi; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float n2 = nrm[i][hh];
        n2 += __shfl_xor_sync(kFull, n2, 1);
        n2 += __shfl_xor_sync(kFull, n2, 2);
        nrm[i][hh] = 0.f;
        const int b = b0 + i * 16 + g + 8 * hh;
        mk[i][hh] = b < B ? mask[static_cast<size_t>(l) * B + b] : 0.f;
        base[i][hh] = n2 * inv_2tau + shift;
      }
#pragma unroll
    for (int n = 0; n < kNj; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kMi; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            s += expf(acc[i][n][2 * hh + e] * inv_sqrt_tau - base[i][hh]) *
                 mk[i][hh];
            acc[i][n][2 * hh + e] = 0.f;
          }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          s += __shfl_xor_sync(kFull, s, off);
        if (g == 0) red[wr][wf0 + n * 8 + 2 * tig + e] += s;
      }
  }

  __syncthreads();
  for (int f = threadIdx.x; f < kFeat; f += kThreads) {
    if (k0 + f >= D) continue;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kWarpsR; ++r) sum += red[r][f];
    out[static_cast<size_t>(l) * D + k0 + f] = sum * inv_sqrt_d;
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
  static bool ready[kMaxDevices] = {};  // shared-memory limit set
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(rff_features_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const int vec = d % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0 &&
                  reinterpret_cast<size_t>(omega) % 16 == 0;
  const dim3 grid(L, (D + kFeat - 1) / kFeat);
  rff_features_kernel<<<grid, kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      w, omega, mask, logshift, out, B, d, D, inv_sqrt_tau, inv_2tau,
      inv_sqrt_d, vec);
  return static_cast<int>(cudaGetLastError());
}
