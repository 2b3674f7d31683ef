// Per-block Gram matrices  Z_b = W_b^T W_b  (fp32).
//
// Replaces: src/repro/kernels/zstats.py::zstats (the Pallas kernel, one MXU
// contraction per class block).  It computes the block sampler's and the
// tree's leaf Grams at every refresh (core/hierarchy.py::build) and the
// retrieval index's leaf Grams (serve/retrieval.py::build_index).
//
// Bound on an H100.  Z_b is symmetric, so the function needs only its
// r(r+1)/2 distinct dots: 2 * n * B * r(r+1)/2 flops at the 67 TFLOP/s fp32
// (non-tensor-core) rate, against W read once and Z written once at 3.35
// TB/s.  Training (391, 256, 128): 1.65 GFLOP = 24.7 us against 77 MB =
// 23 us, so operations bound it.  Serving index (1024, 128, 128): 134 MB =
// 40 us, bytes.  llama3-8b's index (32, 4096, 4096): 2.2 TFLOP = 32.8 ms,
// operations.
//
// Design: register-tiled fp32 FMA on the CUDA cores, upper triangle only.
// One block of 256 threads per (class block b, output tile (i0, j0) with
// i0 <= j0); a tile is BT x BT, BT = 128 from r = 1,024 on and 64 below it
// (where the 64-wide tiles measured faster: more blocks per SM, and at r =
// 128 the 391 or 1,024 class blocks still fill 132 SMs).  The block walks
// the B class rows in chunks of kK = 32, staging the two BT-wide column
// strips W_b[k, i0:i0+BT] and W_b[k, j0:j0+BT] in shared memory with
// cp.async in a ring of STAGES chunks (2 at BT = 64, 4 at BT = 128), so
// later chunks load while one is multiplied (a diagonal tile stages one
// strip).  The 8 warps tile the output 4 x 2; a lane owns a TM x TM
// register micro-tile (8 x 8 at BT = 128, 4 x 4 at BT = 64) of float4
// groups read with 16-byte shared loads, each of which a warp serves in one
// wavefront (4 or 8 distinct float4): 2 * TM / 4 loads feed TM^2 FMAs.  In
// a diagonal tile the warps below the diagonal skip their FMAs and their
// entries are mirrored.  The finished tile goes through shared memory once
// and is written twice, as (i0, j0) and transposed as (j0, i0), both along
// rows, coalesced.  Ragged r and row counts are masked (zero-filled
// copies); r % 4 != 0 or an unaligned base takes 4-byte copies.  3xTF32 on
// the tensor cores (same digits, tensor-core rate) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads per tile
constexpr int kK = 32;         // class rows per staged chunk

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// n bytes (4 or 16) from src to shared dst; ok = false zero-fills dst
// without reading src
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const int bytes = ok ? N : 0;
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // <= N groups pending
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BT, int STAGES>
constexpr size_t smem_bytes() {
  const size_t strips = STAGES * 2 * kK * BT * sizeof(float);
  const size_t tile = static_cast<size_t>(BT) * (BT + 1) * sizeof(float);
  return strips > tile ? strips : tile;
}

// Stage rows [k0, k0 + kK) of the strip starting at column c0 into s
// ([kK][BT]); rows past `rows` and columns past r are zero.
template <int BT>
__device__ __forceinline__ void load_strip(float* s, const float* wb,
                                           int k0, int c0, int rows, int r,
                                           bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < kK * BT / 4; e += kThreads) {
      const int kk = e / (BT / 4), c = (e % (BT / 4)) * 4;
      const bool ok = k0 + kk < rows && c0 + c < r;
      cp_async<16>(s + kk * BT + c,
                   ok ? wb + static_cast<size_t>(k0 + kk) * r + c0 + c : wb,
                   ok);
    }
  } else {
    for (int e = threadIdx.x; e < kK * BT; e += kThreads) {
      const int kk = e / BT, c = e % BT;
      const bool ok = k0 + kk < rows && c0 + c < r;
      cp_async<4>(s + kk * BT + c,
                  ok ? wb + static_cast<size_t>(k0 + kk) * r + c0 + c : wb,
                  ok);
    }
  }
}

template <int BT, int TM, int STAGES>
__global__ void __launch_bounds__(kThreads)
    zstats_kernel(const float* __restrict__ w, float* __restrict__ z,
                  int rows, int r, int n_tiles, int vec) {
  // 8 warps in a 4 x 2 grid, each over a (BT / 4) x (BT / 2) region; in a
  // warp, 4 x 8 lanes, each with a TM x TM micro-tile of (TM / 4)^2 float4
  // groups, 16 rows and 32 columns apart: one 16-byte shared load of a
  // warp then reads 4 (rows) or 8 (columns) distinct float4, one
  // wavefront
  constexpr int kG = TM / 4;  // float4 groups per micro-tile edge
  static_assert(kG * 16 == BT / 4 && kG * 32 == BT / 2, "tile / micro-tile");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* a_s = smem;                      // [STAGES][kK][BT]
  float* b_s = smem + STAGES * kK * BT;  // [STAGES][kK][BT]

  // upper-triangle tile (ti, tj), ti <= tj, from the linear index
  int p = blockIdx.x, ti = 0;
  while (p >= n_tiles - ti) {
    p -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int i0 = ti * BT, j0 = tj * BT;
  const bool diag = ti == tj;
  const float* wb = w + static_cast<size_t>(blockIdx.y) * rows * r;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp / 2) * (BT / 4) + (lane / 8) * 4;  // + 16 g + e
  const int col0 = (warp % 2) * (BT / 2) + (lane % 8) * 4;  // + 32 g + f
  // in a diagonal tile a warp whose region lies below the diagonal skips
  // its FMAs: the epilogue mirrors those entries from above it
  const bool skip = diag && (warp / 2) * (BT / 4) >
                                (warp % 2) * (BT / 2) + BT / 2 - 1;
  const bool v = vec != 0;

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  // a ring of STAGES chunks: STAGES - 1 in flight while one is multiplied
  const int n_chunks = (rows + kK - 1) / kK;
  auto load = [&](int c) {
    const int buf = c % STAGES;
    load_strip<BT>(a_s + buf * kK * BT, wb, c * kK, i0, rows, r, v);
    if (!diag) load_strip<BT>(b_s + buf * kK * BT, wb, c * kK, j0, rows, r, v);
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_async_commit();  // possibly empty: one group per chunk
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed
    __syncthreads();  // ... for every thread; chunk c - 1's buffer is free
    if (c + STAGES - 1 < n_chunks) load(c + STAGES - 1);
    cp_async_commit();
    if (skip) continue;
    const float* as = a_s + (c % STAGES) * kK * BT + row0;
    const float* bs = (diag ? a_s : b_s) + (c % STAGES) * kK * BT + col0;
#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      float4 a[kG], b[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        a[g] = *reinterpret_cast<const float4*>(as + kk * BT + g * 16);
        b[g] = *reinterpret_cast<const float4*>(bs + kk * BT + g * 32);
      }
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        const float ai[4] = {a[gi].x, a[gi].y, a[gi].z, a[gi].w};
#pragma unroll
        for (int gj = 0; gj < kG; ++gj) {
          const float bj[4] = {b[gj].x, b[gj].y, b[gj].z, b[gj].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int f = 0; f < 4; ++f)
              acc[gi * 4 + e][gj * 4 + f] =
                  fmaf(ai[e], bj[f], acc[gi * 4 + e][gj * 4 + f]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the strips

  // the tile through shared memory, t_s[i][j] with an odd pitch, so that
  // both the row-wise and the transposed read are conflict-free
  constexpr int kPitch = BT + 1;
  float* t_s = smem;
#pragma unroll
  for (int gi = 0; gi < kG; ++gi)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int gj = 0; gj < kG; ++gj)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          t_s[(row0 + gi * 16 + e) * kPitch + col0 + gj * 32 + f] =
              acc[gi * 4 + e][gj * 4 + f];
  __syncthreads();
  float* zb = z + static_cast<size_t>(blockIdx.y) * r * r;
  for (int e = threadIdx.x; e < BT * BT; e += kThreads) {
    const int a = e / BT, b = e % BT;  // consecutive threads: consecutive b
    if (i0 + a < r && j0 + b < r)  // a diagonal tile mirrors a > b
      zb[static_cast<size_t>(i0 + a) * r + j0 + b] =
          diag && a > b ? t_s[b * kPitch + a] : t_s[a * kPitch + b];
    if (!diag && j0 + a < r && i0 + b < r)
      zb[static_cast<size_t>(j0 + a) * r + i0 + b] = t_s[b * kPitch + a];
  }
}

template <int BT, int TM, int STAGES>
int launch_tiles(const float* w, float* z, int n_blocks, int rows, int r,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes<BT, STAGES>();
  auto kernel = zstats_kernel<BT, TM, STAGES>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = (r + BT - 1) / BT;
  const int vec = r % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0;
  // blockIdx.y is the class block: launch at most 65,535 of them at once
  constexpr int kMaxY = 65535;
  for (int b0 = 0; b0 < n_blocks; b0 += kMaxY) {
    const dim3 grid(n_tiles * (n_tiles + 1) / 2,
                    n_blocks - b0 < kMaxY ? n_blocks - b0 : kMaxY);
    kernel<<<grid, kThreads, smem, stream>>>(
        w + static_cast<size_t>(b0) * rows * r,
        z + static_cast<size_t>(b0) * r * r, rows, r, n_tiles, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// w: (n_blocks, rows, r) fp32 contiguous; z: (n_blocks, r, r) fp32; tile
// 128 or 64 (the output tile edge; the wrapper picks it by r).  Launches
// on `stream` of `device`; returns the launch's cudaError_t.
extern "C" int zstats_f32(const float* w, float* z, int n_blocks, int rows,
                          int r, int tile, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // ring depths as measured best on an H100: 2 at BT = 64, 4 at BT = 128
  if (tile == 128) return launch_tiles<128, 8, 4>(w, z, n_blocks, rows, r, st);
  if (tile == 64) return launch_tiles<64, 4, 2>(w, z, n_blocks, rows, r, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
