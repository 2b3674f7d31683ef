// Fused sampled-softmax head: per-token corrected logsumexp and its VJP.
//
//   lse[t]   = logsumexp_k adj[t, k],
//   adj[t,k] = f(<h_t, w[ids[t,k]]> + biasg[t,k]) - corr[t,k],
//   f = identity, or |.| in abs mode,
//
// over K = 1 + m gathered head rows per token (slot 0 the label, slots
// 1..m the sampled negatives; corr = 1e30 masks a slot to zero mass).
// w and h are fp32 or bf16 (one type for both), read as they are and
// computed in fp32; every output is fp32.
//
// Replaces: src/repro/kernels/fused_head.py::fused_lse (forward) and
// ::fused_lse_bwd (backward), Pallas kernels over a sequential (T, K) grid
// that fetch one head row per step.  On the training path they are the loss
// of every step (core/sampled_softmax.py::_fused_from_embeddings through
// kernels/ops.py::fused_head_lse).
//
// Bound on an H100 at the training shape (T = 256 tokens, K = 129, d = 128,
// a 100,000-row fp32 head): the forward reads at most T*K rows of 512 B, 17
// MB, 5 us at 3.35 TB/s, for 2 FLOPs per element: memory bound, and a
// chain of dependent loads (ids -> row -> reduce) makes it latency bound
// unless many rows are in flight.  The backward reads the same rows and
// writes the dense (n, d) dL/dw once, 51 MB: about 20 us.
//
// Forward design.  One block per token, W = ceil(K / 8) warps (17 at K =
// 129; kMaxWarps at most).  A warp takes 8 slots per pass: lanes 0..7 load
// the slots' ids, corr and biasg in one coalesced load, the ids are
// broadcast by shuffles, and every lane issues its 16-byte (fp32) or
// 8-byte (bf16) load of all 8 rows before it reduces any, so one round of
// loads covers a token at K = 129.  h_t's 4 columns of the lane stay in
// registers.  8 butterfly reductions give every lane the 8 dots; lane q
// forms slot q's adj and the warp folds the pass into an online (max,
// sumexp) started at -1e30, as the Pallas scratch is, so a masked slot
// gives exp(-1e30 - m) = 0, never exp(-inf + inf) = NaN; the warps' pairs
// merge in a fixed order.
//
// Backward design: deterministic, no float atomics, no zero fill.  Three
// kernels behind one entry point (fused_head.plan sizes them):
//  1. front: T token blocks recompute the forward's dots in the same
//     layout (at d <= 128 the rows stay in registers) and write dcorr =
//     -p, dcoef = p * sign(o) (abs mode) and dh, each warp's dh strip
//     folded in warp order.  Beside them, `n_chunks` blocks each rank a
//     chunk of slots by list (a list: the slots of q tiles of kTileRows
//     rows): a stable counting sort with integer counts only, the lanes
//     of a 32-slot step grouped by list with one ballot per key bit.
//  2. scan: the chunks' counts summed and scanned over the lists give
//     each list one contiguous run of places; a slot's place is its
//     list's start, the earlier chunks' counts and its rank, so each list
//     holds its slots in ascending slot order on every run.  The slots
//     are placed as (p, token, row in the list).  Block 0 also cuts the
//     lists into runs of `run` slots and writes the dw pass's units, the
//     split lists' runs first.
//  3. dw: one block per unit (a run of a list).  For each of the list's q
//     tiles it groups the run's slots of the tile by row (stable: ballots
//     again), and each warp adds its rows' slots in that order into a
//     shared-memory tile, acc = acc + p * h[t] in fp32, product and sum
//     each rounded, so the Pallas grid's ascending order holds; a row's
//     sum stays in registers while its slots last.  A list of one run
//     writes every row of its tiles, zeros included: that write replaces
//     the memset.  A list longer than `run` (skewed ids: a sampler that
//     sends thousands of draws to a few rows) is split over several
//     blocks, so it never serialises the call: each writes its touched
//     rows as partials, and the last block of a tile to finish (an
//     integer counter behind a release fence) folds them, eight slices of
//     runs in parallel, the slices' sums added in slice order.  Those
//     fences wait behind the other blocks' stores, which is why the split
//     runs go first.
// The bound is the dw pass's 51 MB write; the measured split and what
// holds each kernel back are in PERF.md.
// Rows whose width or address does not allow vector loads take scalar
// loads of the same columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kGroup = 8;      // slots per warp pass
constexpr int kMaxWarps = 20;  // warps per token block, at most
constexpr int kColChunk = 128;  // columns per lane pass: 32 lanes x 4
constexpr int kTileRows = 64;  // rows of a dw tile
constexpr int kDwThreads = 256;  // dw block: 8 warps, 8 rows each
constexpr int kDwWarps = kDwThreads / 32;
constexpr int kRowsPerWarp = kTileRows / kDwWarps;  // contiguous rows
static_assert(kDwWarps * kDwWarps == kTileRows,
              "the fold takes kDwWarps rows of kDwWarps slices at a time");
constexpr int kDwBlocks = 3;  // dw blocks resident per SM (registers; one
                              // fewer on the scalar path)
constexpr int kStage = kDwThreads;  // slots staged per dw sub-batch
constexpr int kBatch = 4;  // row loads in flight per lane in the dw pass
constexpr int kFoldBatch = 4;  // partial rows in flight per lane, the fold
constexpr int kMaxRuns = 512;  // runs of a list, at most (plan's run)
constexpr int kScanThreads = 512;
constexpr int kScanSplit = 4;  // scan blocks per chunk, a part each
constexpr int kSortAhead = 8;  // 32-slot steps whose ids a sort warp loads
                               // ahead
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// jnp.sign: -1, 0 or +1 (and NaN for NaN).
__device__ __forceinline__ float sign_of(float o) {
  return o > 0.f ? 1.f : (o < 0.f ? -1.f : o);
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float bf16_bits(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
// Four consecutive elements (16-byte aligned fp32, 8-byte aligned bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// A lane's 4 columns of column chunk cc of a row of d elements, as fp32
// (0 past d): columns cc*128 + 4*lane + {0..3} with vector loads (VEC),
// cc*128 + lane + 32*{0..3} with scalar ones.  Every piece of code that
// reads or writes a row by pieces uses this same layout.
template <typename T, bool VEC>
__device__ __forceinline__ float4 piece(const T* __restrict__ row, int cc,
                                        int lane, int d) {
  const int c0 = cc * kColChunk;
  if (VEC) {
    const int c = c0 + 4 * lane;
    return c < d ? load4(row + c) : zero4();
  }
  float4 r;
  r.x = c0 + lane < d ? load1(row + c0 + lane) : 0.f;
  r.y = c0 + 32 + lane < d ? load1(row + c0 + 32 + lane) : 0.f;
  r.z = c0 + 64 + lane < d ? load1(row + c0 + 64 + lane) : 0.f;
  r.w = c0 + 96 + lane < d ? load1(row + c0 + 96 + lane) : 0.f;
  return r;
}

template <bool VEC>
__device__ __forceinline__ void store_piece(float* __restrict__ row, int cc,
                                            int lane, int d, float4 v) {
  const int c0 = cc * kColChunk;
  if (VEC) {
    const int c = c0 + 4 * lane;
    if (c < d) *reinterpret_cast<float4*>(row + c) = v;
    return;
  }
  if (c0 + lane < d) row[c0 + lane] = v.x;
  if (c0 + 32 + lane < d) row[c0 + 32 + lane] = v.y;
  if (c0 + 64 + lane < d) row[c0 + 64 + lane] = v.z;
  if (c0 + 96 + lane < d) row[c0 + 96 + lane] = v.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc + p * x, product and sum each rounded (no contraction into an FMA):
// the order of dL/dw's sums is part of its contract.
__device__ __forceinline__ float4 add_scaled(float4 acc, float p, float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(p, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(p, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(p, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(p, x.w));
  return acc;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// One warp pass over slots g0 .. g0+7 of token row `base`: the 8 full
// dots (every lane holds all 8) and this lane's slot data (lane q < 8 owns
// slot g0 + q).  ONE (d <= 128): the rows' pieces stay in x for the
// caller.
struct SlotPass {
  float dot[kGroup];
  float corr, biasg;
  bool own;
};

template <typename T, bool VEC, bool ONE>
__device__ __forceinline__ void slot_pass(
    const T* __restrict__ w, const T* __restrict__ h_t,
    const int* __restrict__ ids, const float* __restrict__ corr,
    const float* __restrict__ biasg, size_t base, int g0, int K, int d,
    int lane, SlotPass& sp, float4 (&x)[kGroup]) {
  const int k = g0 + lane;
  sp.own = lane < kGroup && k < K;
  const int id = sp.own ? ids[base + k] : 0;
  sp.corr = sp.own ? corr[base + k] : 0.f;
  sp.biasg = sp.own ? biasg[base + k] : 0.f;
  int rid[kGroup];
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    rid[q] = __shfl_sync(kFull, id, q);
    sp.dot[q] = 0.f;
  }
  const int nch = ONE ? 1 : (d + kColChunk - 1) / kColChunk;
  for (int cc = 0; cc < nch; ++cc) {
    const float4 hv = piece<T, VEC>(h_t, cc, lane, d);
    float4 xl[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      xl[q] = g0 + q < K
                  ? piece<T, VEC>(w + static_cast<size_t>(rid[q]) * d, cc,
                                  lane, d)
                  : zero4();
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      sp.dot[q] = dot4(xl[q], hv, sp.dot[q]);
      if (ONE) x[q] = xl[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kGroup; ++q) sp.dot[q] = warp_sum(sp.dot[q]);
}

// This lane's slot's full dot (lane q < 8 takes dot[q]).
__device__ __forceinline__ float own_dot(const SlotPass& sp, int lane) {
  float v = sp.dot[0];
#pragma unroll
  for (int q = 1; q < kGroup; ++q)
    if (lane == q) v = sp.dot[q];
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32)
    fused_lse_kernel(const T* __restrict__ w, const T* __restrict__ h,
                     const int* __restrict__ ids,
                     const float* __restrict__ corr,
                     const float* __restrict__ biasg,
                     float* __restrict__ lse, int K, int d, int abs_mode) {
  __shared__ float m_s[kMaxWarps];
  __shared__ float s_s[kMaxWarps];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const size_t base = static_cast<size_t>(t) * K;
  const T* h_t = h + static_cast<size_t>(t) * d;
  float m = kNegInf, s = 0.f;
  for (int g0 = warp * kGroup; g0 < K; g0 += warps * kGroup) {
    SlotPass sp;
    float4 x[kGroup];
    slot_pass<T, VEC, false>(w, h_t, ids, corr, biasg, base, g0, K, d, lane,
                             sp, x);
    const float o = own_dot(sp, lane) + sp.biasg;
    const float adj = (abs_mode ? fabsf(o) : o) - sp.corr;
    const float m_new = fmaxf(m, warp_max(sp.own ? adj : -CUDART_INF_F));
    const float e = sp.own ? expf(adj - m_new) : 0.f;
    s = s * expf(m - m_new) + warp_sum(e);
    m = m_new;
  }
  if (lane == 0) {
    m_s[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = kNegInf, ss = 0.f;
    for (int v = 0; v < warps; ++v) {
      const float m_new = fmaxf(mm, m_s[v]);
      ss = ss * expf(mm - m_new) + s_s[v] * expf(m_s[v] - m_new);
      mm = m_new;
    }
    lse[t] = logf(ss) + mm;
  }
}

// ---------------------------------------------------------------- backward

// The workspace, int32 words in this order (fused_head.workspace_parts).
// A list tile is `q` dw tiles (q * kTileRows rows); its slots form one list.
struct Workspace {
  int* cnt;        // [n_lists][ncp] slots of each chunk in a list (ncp:
                   // n_chunks rounded up to 4, for 16-byte loads)
  int4* unit;      // [n_lists + ceil(S / run)] the dw pass's units, the
                   // split lists' runs first: (list * kMaxRuns + run, the
                   // list's slots, its start, its first partial slot)
  float* lp;       // [S] every list's slots, list by list, ascending: p,
  int* lrt;        //     and token * list rows + row in the list tile
  int* rk;         // [S] a slot's rank among its chunk's slots of its list
  int* etot;       // [n_lists] slots of a list
  int* toff;       // [n_lists] start of a list
  int* nsb;        // [n_lists + 1] split lists before a list; [n_lists]:
                   // the dw pass's units in all
  int* done;       // [n_tiles][col_chunks] runs finished (split lists)
  unsigned* pmask;  // [partials][q][col_chunks][2] rows a partial touched
  float* partial;  // [partials][q][kTileRows][d] split lists' partial rows
  size_t words;
};

Workspace carve(int* base, long long S, int d, int q, int n_chunks,
                int n_lists, int n_tiles, long long extra,
                long long partials, int col_chunks) {
  Workspace ws;
  size_t o = 0;
  auto take = [&](size_t n) {
    int* p = base + o;
    o += n;
    return p;
  };
  ws.cnt = take(static_cast<size_t>(n_lists) * ((n_chunks + 3) / 4 * 4));
  ws.unit = reinterpret_cast<int4*>(  // 16-byte aligned: cnt's rows are
      take(4 * (static_cast<size_t>(n_lists) + extra)));  // 4-int multiples
  ws.lp = reinterpret_cast<float*>(take(static_cast<size_t>(S)));
  ws.lrt = take(static_cast<size_t>(S));
  ws.rk = take(static_cast<size_t>(S));
  ws.etot = take(n_lists);
  ws.toff = take(n_lists);
  ws.nsb = take(static_cast<size_t>(n_lists) + 1);
  ws.done = take(static_cast<size_t>(n_tiles) * col_chunks);
  ws.pmask = reinterpret_cast<unsigned*>(
      take(static_cast<size_t>(partials) * q * col_chunks * 2));
  o += (4 - o % 4) % 4;  // 16-byte aligned partial rows
  ws.partial = reinterpret_cast<float*>(
      take(static_cast<size_t>(partials) * q * kTileRows * d));
  ws.words = o;
  return ws;
}

// Token part of the front kernel: dcorr, dcoef and dh of token t.  ONE
// (d <= 128): the pass's rows stay in registers for dh; wider rows are
// read again, a column chunk at a time.  Shared memory: one dh strip per
// warp, in piece layout (nch * 32 float4).
template <typename T, bool VEC, bool ONE>
__device__ __forceinline__ void token_bwd(
    int t, const T* __restrict__ w, const T* __restrict__ h,
    const int* __restrict__ ids, const float* __restrict__ corr,
    const float* __restrict__ biasg, const float* __restrict__ lse,
    const float* __restrict__ gbar, float* __restrict__ dh,
    float* __restrict__ dcoef, float* __restrict__ dcorr, int K, int d,
    int abs_mode, float4* strips) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int nch = ONE ? 1 : (d + kColChunk - 1) / kColChunk;
  float4* strip = strips + static_cast<size_t>(warp) * nch * 32;
  for (int j = lane; j < nch * 32; j += 32) strip[j] = zero4();
  const size_t base = static_cast<size_t>(t) * K;
  const T* h_t = h + static_cast<size_t>(t) * d;
  const float lse_t = lse[t];
  const float g_t = gbar[t];
  float4 dha = zero4();  // ONE: this lane's piece of the warp's dh
  for (int g0 = warp * kGroup; g0 < K; g0 += warps * kGroup) {
    SlotPass sp;
    float4 x[kGroup];
    slot_pass<T, VEC, ONE>(w, h_t, ids, corr, biasg, base, g0, K, d, lane,
                           sp, x);
    const float o = own_dot(sp, lane) + sp.biasg;
    const float adj = (abs_mode ? fabsf(o) : o) - sp.corr;
    float p = expf(adj - lse_t) * g_t;
    if (sp.own) dcorr[base + g0 + lane] = -p;  // corr applies after |.|
    if (abs_mode) p *= sign_of(o);
    if (sp.own) dcoef[base + g0 + lane] = p;
    if (!sp.own) p = 0.f;
    if (ONE) {
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const float pq = __shfl_sync(kFull, p, q);
        dha.x = fmaf(pq, x[q].x, dha.x);
        dha.y = fmaf(pq, x[q].y, dha.y);
        dha.z = fmaf(pq, x[q].z, dha.z);
        dha.w = fmaf(pq, x[q].w, dha.w);
      }
      continue;
    }
    int rid[kGroup];
    float pq[kGroup];
    const int id = sp.own ? ids[base + g0 + lane] : 0;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      rid[q] = __shfl_sync(kFull, id, q);
      pq[q] = __shfl_sync(kFull, p, q);
    }
    for (int cc = 0; cc < nch; ++cc) {
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        x[q] = g0 + q < K
                   ? piece<T, VEC>(w + static_cast<size_t>(rid[q]) * d, cc,
                                   lane, d)
                   : zero4();
      float4 a = strip[cc * 32 + lane];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        a.x = fmaf(pq[q], x[q].x, a.x);
        a.y = fmaf(pq[q], x[q].y, a.y);
        a.z = fmaf(pq[q], x[q].z, a.z);
        a.w = fmaf(pq[q], x[q].w, a.w);
      }
      strip[cc * 32 + lane] = a;
    }
  }
  if (ONE) strip[lane] = dha;
  __syncthreads();
  // fold the warps' strips in warp order; piece j = (cc, lane)
  float* dh_t = dh + static_cast<size_t>(t) * d;
  for (int j = threadIdx.x; j < nch * 32; j += blockDim.x) {
    float4 a = strips[j];
    for (int v = 1; v < warps; ++v) {
      const float4 b = strips[static_cast<size_t>(v) * nch * 32 + j];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    store_piece<VEC>(dh_t, j >> 5, j & 31, d, a);
  }
}

// Exclusive scan of v over the block (up to 32 warps); `total` gets the
// sum.  Every thread of the block calls it.
__device__ __forceinline__ int4 block_scan(int4 v, int4* warp_s,
                                           int4& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int4 inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(kFull, inc.x, off);
    const int b = __shfl_up_sync(kFull, inc.y, off);
    const int c = __shfl_up_sync(kFull, inc.z, off);
    const int e = __shfl_up_sync(kFull, inc.w, off);
    if (lane >= off) {
      inc.x += a;
      inc.y += b;
      inc.z += c;
      inc.w += e;
    }
  }
  if (lane == 31) warp_s[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int4 s = lane < nw ? warp_s[lane] : make_int4(0, 0, 0, 0);
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(kFull, s.x, off);
      const int b = __shfl_up_sync(kFull, s.y, off);
      const int c = __shfl_up_sync(kFull, s.z, off);
      const int e = __shfl_up_sync(kFull, s.w, off);
      if (lane >= off) {
        s.x += a;
        s.y += b;
        s.z += c;
        s.w += e;
      }
    }
    if (lane < nw) warp_s[lane] = s;  // inclusive warp prefixes
  }
  __syncthreads();
  const int4 before = warp == 0 ? make_int4(0, 0, 0, 0) : warp_s[warp - 1];
  total = warp_s[nw - 1];
  __syncthreads();  // warp_s is reused by the next call
  return make_int4(before.x + inc.x - v.x, before.y + inc.y - v.y,
                   before.z + inc.z - v.z, before.w + inc.w - v.w);
}

// The list tile of a row (-1 below 0, n_lists past the last list tile:
// both dropped).
__device__ __forceinline__ int list_of(int id, int list_rows, int n_lists) {
  return id < 0 ? -1 : min(id / list_rows, n_lists);
}

// The lanes whose `key` equals this lane's (key < 2^nbits), from one
// ballot per bit: __match_any_sync's result, at full ballot throughput.
__device__ __forceinline__ unsigned match_key(unsigned key, int nbits) {
  unsigned m = kFull;
  for (int bit = 0; bit < nbits; ++bit) {
    const unsigned set = (key >> bit) & 1u;
    const unsigned bal = __ballot_sync(kFull, set);
    m &= set ? bal : ~bal;
  }
  return m;
}

// Sort part of the front kernel: chunk c of `chunk` slots, a stable
// counting sort by list with integer counts only.  Warp w owns a span of
// the chunk (whole steps of 32 slots) and walks it in order: a step's
// lanes are grouped by list (match_key) and the group's lowest lane adds
// the group's size to the warp's count of that list.  The counts are
// scanned over the warps, each warp walks its span again and every slot
// gets its rank among the chunk's slots of its list (earlier warps' and
// earlier steps' counts, plus its rank in its group), and the chunk's
// count of each list is written out.  Shared memory: warps x n_lists
// counts.
__device__ __forceinline__ void sort_chunk(int c, const int* __restrict__ ids,
                                           long long S, int chunk,
                                           int n_lists, int list_rows,
                                           int* cnt_s, const Workspace& ws) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long first = static_cast<long long>(c) * chunk;
  const int len = static_cast<int>(min(static_cast<long long>(chunk),
                                       S - first));
  const int span = ((len + warps - 1) / warps + 31) / 32 * 32;
  const int lo = warp * span;
  const int hi = min(len, lo + span);
  const int nbits = 32 - __clz(n_lists + 2);  // keys list + 2 >= 0
  int* cnt = cnt_s + static_cast<size_t>(warp) * n_lists;
  for (int x = threadIdx.x; x < warps * n_lists; x += blockDim.x)
    cnt_s[x] = 0;
  __syncthreads();
  int xs[kSortAhead];  // the lists of kSortAhead steps, loaded ahead
  for (int i0 = lo; i0 < hi; i0 += 32 * kSortAhead) {
#pragma unroll
    for (int u = 0; u < kSortAhead; ++u) {
      const int i = i0 + 32 * u + lane;
      xs[u] = i < hi ? list_of(ids[first + i], list_rows, n_lists) : -2;
    }
#pragma unroll
    for (int u = 0; u < kSortAhead; ++u) {
      if (i0 + 32 * u >= hi) break;  // warp-uniform
      const unsigned peers = match_key(static_cast<unsigned>(xs[u] + 2),
                                       nbits);
      if (xs[u] >= 0 && xs[u] < n_lists && lane == __ffs(peers) - 1)
        cnt[xs[u]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  const int ncp = (static_cast<int>((S + chunk - 1) / chunk) + 3) / 4 * 4;
  for (int x = threadIdx.x; x < n_lists; x += blockDim.x) {
    int run = 0;
    for (int v = 0; v < warps; ++v) {
      const int n = cnt_s[v * n_lists + x];
      cnt_s[v * n_lists + x] = run;
      run += n;
    }
    ws.cnt[static_cast<size_t>(x) * ncp + c] = run;
  }
  __syncthreads();
  for (int i0 = lo; i0 < hi; i0 += 32 * kSortAhead) {
    if (hi - lo > 32 * kSortAhead) {  // else xs still holds the span's lists
#pragma unroll
      for (int u = 0; u < kSortAhead; ++u) {
        const int i = i0 + 32 * u + lane;
        xs[u] = i < hi ? list_of(ids[first + i], list_rows, n_lists) : -2;
      }
    }
#pragma unroll
    for (int u = 0; u < kSortAhead; ++u) {
      if (i0 + 32 * u >= hi) break;  // warp-uniform
      const int x = xs[u];
      const unsigned peers = match_key(static_cast<unsigned>(x + 2), nbits);
      const bool ok = x >= 0 && x < n_lists;
      if (ok)
        ws.rk[first + i0 + 32 * u + lane] =
            cnt[x] + __popc(peers & ((1u << lane) - 1u));
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) cnt[x] += __popc(peers);
      __syncwarp();
    }
  }
}

// Blocks [0, n_chunks) sort a chunk each, blocks past them take a token.
template <typename T, bool VEC, bool ONE>
__global__ void __launch_bounds__(kMaxWarps * 32) fused_bwd_front_kernel(
    const T* __restrict__ w, const T* __restrict__ h,
    const int* __restrict__ ids, const float* __restrict__ corr,
    const float* __restrict__ biasg, const float* __restrict__ lse,
    const float* __restrict__ gbar, float* __restrict__ dh,
    float* __restrict__ dcoef, float* __restrict__ dcorr, Workspace ws,
    long long S, int K, int d, int abs_mode, int chunk, int n_chunks,
    int n_lists, int list_rows) {
  extern __shared__ float4 smem4[];
  if (static_cast<int>(blockIdx.x) < n_chunks) {
    sort_chunk(blockIdx.x, ids, S, chunk, n_lists, list_rows,
               reinterpret_cast<int*>(smem4), ws);
    return;
  }
  token_bwd<T, VEC, ONE>(blockIdx.x - n_chunks, w, h, ids, corr, biasg, lse,
                         gbar, dh, dcoef, dcorr, K, d, abs_mode, smem4);
}

// kScanSplit blocks per chunk: the lists' starts (counts summed over
// chunks and scanned over lists, by every block) and a part of the
// chunk's slots placed into them: a slot's
// place is its list's start, the earlier chunks' counts of its list and
// its rank in the chunk, so every list holds its slots in ascending order
// on every run.  Placed as (p = dcoef, token * list rows + row in the
// list tile), what the dw pass reads.  Block 0 also writes etot, toff and
// the runs' tables, and zeroes the split lists' `done` counters.
// Shared memory: n_lists ints.
__global__ void __launch_bounds__(kScanThreads) fused_bwd_scan_kernel(
    const int* __restrict__ ids, const float* __restrict__ dcoef,
    Workspace ws, long long S, int K, int chunk, int n_chunks, int n_lists,
    int list_rows, int q, int n_tiles, int run, int col_chunks) {
  extern __shared__ int dst_s[];
  __shared__ int4 warp_s[32];
  const int c = blockIdx.x / kScanSplit;
  const int part = blockIdx.x % kScanSplit;
  const bool tables = blockIdx.x == 0;
  const int ncp = (n_chunks + 3) / 4 * 4;
  int4 carry = make_int4(0, 0, 0, 0);  // toff, extra runs, partial slots
  for (int x0 = 0; x0 < n_lists; x0 += blockDim.x) {
    const int x = x0 + threadIdx.x;
    int e = 0, pre = 0;
    if (x < n_lists) {  // the list's counts, 8 16-byte loads at a time
      const int4* row =
          reinterpret_cast<const int4*>(ws.cnt + static_cast<size_t>(x) * ncp);
      for (int v0 = 0; v0 < ncp; v0 += 32) {
        int4 got[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (v0 + 4 * u < ncp) got[u] = row[v0 / 4 + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (v0 + 4 * u >= ncp) break;
          const int n4[4] = {got[u].x, got[u].y, got[u].z, got[u].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int v = v0 + 4 * u + j;
            if (v < n_chunks) {
              e += n4[j];
              if (v < c) pre += n4[j];
            }
          }
        }
      }
    }
    const int runs = e > run ? (e + run - 1) / run : 1;
    const bool split = x < n_lists && runs > 1;
    int4 total;
    const int4 ex = block_scan(make_int4(e, split, split ? runs : 0, 0),
                               warp_s, total);
    if (x < n_lists) {
      const int toff = carry.x + ex.x;
      dst_s[x] = toff + pre;
      if (tables) {  // the split lists' runs lead the units
        const int poff = carry.z + ex.z;
        ws.etot[x] = e;
        ws.toff[x] = toff;
        ws.nsb[x] = carry.y + ex.y;
        if (split) {
          for (int j = 0; j < runs; ++j)
            ws.unit[poff + j] = make_int4(x * kMaxRuns + j, e, toff, poff);
          for (int t = x * q; t < min(n_tiles, x * q + q); ++t)
            for (int cc = 0; cc < col_chunks; ++cc)
              ws.done[static_cast<size_t>(t) * col_chunks + cc] = 0;
        }
      }
    }
    carry.x += total.x;
    carry.y += total.y;
    carry.z += total.z;
  }
  if (tables) {  // then the other lists, one unit each
    __syncthreads();  // nsb, etot, toff written
    for (int x = threadIdx.x; x < n_lists; x += blockDim.x)
      if (ws.etot[x] <= run)
        ws.unit[carry.z + x - ws.nsb[x]] =
            make_int4(x * kMaxRuns, ws.etot[x], ws.toff[x], 0);
    if (threadIdx.x == 0) ws.nsb[n_lists] = carry.z + n_lists - carry.y;
  }
  __syncthreads();
  const long long first = static_cast<long long>(c) * chunk;
  const int len = static_cast<int>(min(static_cast<long long>(chunk),
                                       S - first));
  const int share = (chunk + kScanSplit - 1) / kScanSplit;
  for (int i = part * share + threadIdx.x; i < min(len, (part + 1) * share);
       i += blockDim.x) {
    const long long slot = first + i;
    const int id = ids[slot];
    const int x = list_of(id, list_rows, n_lists);
    if (x < 0 || x >= n_lists) continue;  // a row outside w
    const int pos = dst_s[x] + ws.rk[slot];
    ws.lp[pos] = dcoef[slot];
    ws.lrt[pos] = static_cast<int>(slot / K) * list_rows + (id - x * list_rows);
  }
}

// One block per (unit, column chunk): a unit is a run of a list (every
// list has one, an empty list too: its rows are written 0), the split
// lists' runs first, so that they write their partials and pass their
// fences before the other blocks' stores fill the memory system.  The
// block writes the dL/dw rows of the list's q tiles of kTileRows rows,
// one tile after another; the run's slots are staged once when they fit
// kStage.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kDwThreads, VEC ? kDwBlocks : kDwBlocks - 1)
    fused_bwd_dw_kernel(
    const T* __restrict__ h, float* __restrict__ dw, Workspace ws, int n,
    int d, int q, int n_tiles, int run, int col_chunks) {
  __shared__ float4 acc_s[kTileRows * 32];
  __shared__ float s_p[kStage];  // a staged slot's p, token, row in list
  __shared__ int s_t[kStage];
  __shared__ int s_r[kStage];
  __shared__ int e_r[kStage];  // its row in the tile, or -1
  __shared__ int order[kStage];
  __shared__ int rc[kTileRows];
  __shared__ int rs[kTileRows];
  __shared__ int wc[kDwWarps * kTileRows];  // per-warp counts of each row
  __shared__ int touched[kTileRows];
  __shared__ unsigned mask_s[2 * kMaxRuns];
  __shared__ int last_s;
  // loads in flight per lane: fewer on the scalar path (4 loads a piece)
  constexpr int kB = VEC ? kBatch : kBatch / 2;
  constexpr int kFoldB = VEC ? kFoldBatch : kFoldBatch / 2;
  const int b = blockIdx.x;
  const int cc = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_lists = (n_tiles + q - 1) / q;
  if (b >= ws.nsb[n_lists]) return;  // past the units: block-uniform
  const int4 u = ws.unit[b];
  const int l = u.x / kMaxRuns;  // the list
  const int k = u.x % kMaxRuns;  // the run of the list
  const int e_all = u.y;
  const int x_end = min(n_tiles, l * q + q);
  if (e_all == 0) {  // no slot names a row of the list
    for (int x = l * q; x < x_end; ++x)
      for (int r = warp; r < min(kTileRows, n - x * kTileRows);
           r += kDwWarps)
        store_piece<VEC>(dw + static_cast<size_t>(x * kTileRows + r) * d,
                         cc, lane, d, zero4());
    return;
  }
  const int runs = e_all > run ? (e_all + run - 1) / run : 1;
  const int e0 = k * run;
  const int e1 = min(e_all, e0 + run);
  const float* lp = ws.lp + u.z;
  const int* lrt = ws.lrt + u.z;
  const int list_rows = q * kTileRows;
  const bool staged = e1 - e0 <= kStage;  // staged once for every tile
  if (staged && tid < e1 - e0) {
    const int v = lrt[e0 + tid];
    s_p[tid] = lp[e0 + tid];
    s_t[tid] = v / list_rows;
    s_r[tid] = v % list_rows;
  }
  for (int x = l * q; x < x_end; ++x) {  // block-uniform
    const int r0 = x * kTileRows;
    const int rows = min(kTileRows, n - r0);
    const int rl0 = (x - l * q) * kTileRows;  // the tile's first list row
    __syncthreads();  // the previous tile is done with the shared arrays
    for (int j = tid; j < kTileRows * 32; j += kDwThreads) acc_s[j] = zero4();
    if (tid < kTileRows) touched[tid] = 0;
    for (int sb = e0; sb < e1; sb += kStage) {
      const int nb = min(kStage, e1 - sb);
      __syncthreads();  // the previous sub-batch is applied
      if (!staged && tid < nb) {
        const int v = lrt[sb + tid];
        s_p[tid] = lp[sb + tid];
        s_t[tid] = v / list_rows;
        s_r[tid] = v % list_rows;
      }
      for (int j = tid; j < kDwWarps * kTileRows; j += kDwThreads) wc[j] = 0;
      __syncthreads();
      // a stable rank of each slot among the sub-batch's slots of its row:
      // the lanes of a warp grouped by row (match_key), each group's
      // lowest lane adding its size to the warp's count of the row
      int row = -1;
      if (tid < nb) {
        row = s_r[tid] - rl0;
        if (row < 0 || row >= kTileRows) row = -1;  // another tile's row
        e_r[tid] = row;
      }
      const unsigned peers = match_key(static_cast<unsigned>(row + 1), 7);
      if (row >= 0 && lane == __ffs(peers) - 1)
        wc[warp * kTileRows + row] = __popc(peers);
      __syncthreads();
      if (tid < kTileRows) {  // counts over the warps, scanned per row
        int n_r = 0;
        for (int v = 0; v < kDwWarps; ++v) {
          const int c = wc[v * kTileRows + tid];
          wc[v * kTileRows + tid] = n_r;
          n_r += c;
        }
        rc[tid] = n_r;
      }
      __syncthreads();
      if (warp == 0) {  // rs = exclusive scan of rc; lane l: rows 2l, 2l+1
        const int c0 = rc[2 * lane], c1 = rc[2 * lane + 1];
        int inc = c0 + c1;
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(kFull, inc, off);
          if (lane >= off) inc += y;
        }
        rs[2 * lane] = inc - c0 - c1;
        rs[2 * lane + 1] = inc - c1;
        if (c0) touched[2 * lane] = 1;
        if (c1) touched[2 * lane + 1] = 1;
      }
      __syncthreads();
      if (row >= 0)  // each row's slots in slot order
        order[rs[row] + wc[warp * kTileRows + row] +
              __popc(peers & ((1u << lane) - 1u))] = tid;
      __syncthreads();
      // warp w adds the slots of its rows, kRowsPerWarp * w on: one range
      // of `order`, walked in order (a row's slots in slot order, one row
      // after another).  32 slots' (p, token, row) at a time, one a lane,
      // broadcast by shuffles; their h loads kBatch at a time; the row
      // being summed stays in registers until the next row starts.
      const int qa = rs[kRowsPerWarp * warp];
      const int last = kRowsPerWarp * (warp + 1) - 1;
      const int qb = rs[last] + rc[last];
      int cur = -1;  // the row held in `a`
      float4 a = zero4();
      for (int q0 = qa; q0 < qb; q0 += 32) {
        int rj = 0, tj = 0;
        float pj = 0.f;
        if (q0 + lane < qb) {
          const int e = order[q0 + lane];
          rj = e_r[e];
          tj = s_t[e];
          pj = s_p[e];
        }
        const int nq = min(32, qb - q0);
        for (int j0 = 0; j0 < nq; j0 += kB) {
          float4 hv[kB];
#pragma unroll
          for (int u = 0; u < kB; ++u) {
            const int t = __shfl_sync(kFull, tj, (j0 + u) & 31);
            if (j0 + u < nq)
              hv[u] = piece<T, VEC>(h + static_cast<size_t>(t) * d, cc, lane,
                                    d);
          }
#pragma unroll
          for (int u = 0; u < kB; ++u) {
            const int r = __shfl_sync(kFull, rj, (j0 + u) & 31);
            const float p = __shfl_sync(kFull, pj, (j0 + u) & 31);
            if (j0 + u < nq) {
              if (r != cur) {
                if (cur >= 0) acc_s[cur * 32 + lane] = a;
                a = acc_s[r * 32 + lane];
                cur = r;
              }
              a = add_scaled(a, p, hv[u]);
            }
          }
        }
      }
      if (cur >= 0) acc_s[cur * 32 + lane] = a;
    }
    __syncthreads();
    if (runs == 1) {  // every row of the tile, zeros included
      for (int r = kRowsPerWarp * warp; r < kRowsPerWarp * (warp + 1); ++r)
        if (r < rows)
          store_piece<VEC>(dw + static_cast<size_t>(r0 + r) * d, cc, lane, d,
                           acc_s[r * 32 + lane]);
      continue;
    }
    // A split list: this run's touched rows of the tile become a partial;
    // the last of the tile's runs to finish folds the partials.
    const size_t p0 = static_cast<size_t>(u.w) * q + (x - l * q);
    const size_t pstep = q;  // partial slots of consecutive runs of a tile
    float* part = ws.partial + (p0 + k * pstep) * kTileRows * d;
    for (int r = warp; r < rows; r += kDwWarps)
      if (touched[r])
        store_piece<VEC>(part + static_cast<size_t>(r) * d, cc, lane, d,
                         acc_s[r * 32 + lane]);
    if (tid < 2) {
      unsigned m = 0;
      for (int r = 0; r < 32; ++r) m |= touched[32 * tid + r] ? 1u << r : 0u;
      ws.pmask[((p0 + k * pstep) * col_chunks + cc) * 2 + tid] = m;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last_s = atomicAdd(&ws.done[static_cast<size_t>(x) * col_chunks + cc],
                         1) == runs - 1;
    __syncthreads();
    if (!last_s) continue;
    __threadfence();
    // The fold.  The rows no run touched are written 0; the touched ones,
    // 8 at a time: warp v sums slice v of the runs (kDwWarps slices of
    // `span` runs, in run order), each row's touched runs only (the masks
    // staged in shared memory), their partials kFoldB at a time; then
    // warp i adds row i's slice sums in slice order.
    for (int j = tid; j < 2 * runs; j += kDwThreads)
      mask_s[j] = __ldcg(ws.pmask +
                         (p0 + (j >> 1) * pstep) * col_chunks * 2 + cc * 2 +
                         (j & 1));
    __syncthreads();
    if (tid < kTileRows) {  // touched[r]: a run touched row r
      int hit = 0;
      for (int j = 0; j < runs && !hit; ++j)
        hit = (mask_s[2 * j + (tid >> 5)] >> (tid & 31)) & 1u;
      touched[tid] = hit;
    }
    __syncthreads();
    if (warp == 0) {  // the touched rows, listed in order into order[]
      const bool h0 = touched[2 * lane], h1 = touched[2 * lane + 1];
      int inc = h0 + h1;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += y;
      }
      if (h0) order[inc - h0 - h1] = 2 * lane;
      if (h1) order[inc - h1] = 2 * lane + 1;
      if (lane == 31) last_s = inc;  // touched rows in all
    }
    __syncthreads();
    const int n_hit = last_s;
    for (int r = warp; r < rows; r += kDwWarps)
      if (!touched[r])
        store_piece<VEC>(dw + static_cast<size_t>(r0 + r) * d, cc, lane, d,
                         zero4());
    const int c0 = cc * kColChunk;
    const int span = (runs + kDwWarps - 1) / kDwWarps;
    const int ja = warp * span;
    const int jb = min(runs, ja + span);
    for (int g = 0; g < n_hit; g += kDwWarps) {
      __syncthreads();  // the previous group's sums are read
      for (int i = 0; i < kDwWarps && g + i < n_hit; ++i) {
        const int r = order[g + i];
        float4 sum = zero4();
        bool any = false;
        for (int j0 = ja; j0 < jb; j0 += 32) {
          const int jl = j0 + lane;
          const bool hit =
              jl < jb && ((mask_s[2 * jl + (r >> 5)] >> (r & 31)) & 1u);
          unsigned todo = __ballot_sync(kFull, hit);
          any = any || todo;
          while (todo) {  // warp-uniform
            int js[kFoldB];
            float4 pv[kFoldB];
#pragma unroll
            for (int u = 0; u < kFoldB; ++u) {
              js[u] = -1;
              if (todo) {
                js[u] = j0 + __ffs(todo) - 1;
                todo &= todo - 1;
              }
            }
#pragma unroll
            for (int u = 0; u < kFoldB; ++u) {
              if (js[u] < 0) continue;
              const float* src = ws.partial +
                                 (p0 + static_cast<size_t>(js[u]) * pstep) *
                                     kTileRows * d +
                                 static_cast<size_t>(r) * d;
              if (VEC) {
                const int c = c0 + 4 * lane;
                pv[u] = c < d
                            ? __ldcg(reinterpret_cast<const float4*>(src + c))
                            : zero4();
              } else {
                pv[u].x = c0 + lane < d ? __ldcg(src + c0 + lane) : 0.f;
                pv[u].y = c0 + 32 + lane < d ? __ldcg(src + c0 + 32 + lane)
                                             : 0.f;
                pv[u].z = c0 + 64 + lane < d ? __ldcg(src + c0 + 64 + lane)
                                             : 0.f;
                pv[u].w = c0 + 96 + lane < d ? __ldcg(src + c0 + 96 + lane)
                                             : 0.f;
              }
            }
#pragma unroll
            for (int u = 0; u < kFoldB; ++u)
              if (js[u] >= 0) sum = add4(sum, pv[u]);
          }
        }
        acc_s[(warp * kDwWarps + i) * 32 + lane] = sum;
        if (lane == 0) rc[warp * kDwWarps + i] = any;
      }
      __syncthreads();
      if (g + warp < n_hit) {
        const int r = order[g + warp];
        float4 a = zero4();
        for (int v = 0; v < kDwWarps; ++v)
          if (rc[v * kDwWarps + warp])
            a = add4(a, acc_s[(v * kDwWarps + warp) * 32 + lane]);
        if (r < rows)
          store_piece<VEC>(dw + static_cast<size_t>(r0 + r) * d, cc, lane, d,
                           a);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<size_t>(p) % bytes == 0;
}

template <typename T>
int vec_ok(const T* w, const T* h, int d) {
  return d % 4 == 0 && aligned(w, 4 * sizeof(T)) && aligned(h, 4 * sizeof(T));
}

template <typename T>
int launch_fwd(const T* w, const T* h, const int* ids, const float* corr,
               const float* biasg, float* lse, int T_, int K, int d,
               int abs_mode, int warps, cudaStream_t stream) {
  const dim3 block(warps * 32);
  if (vec_ok(w, h, d))
    fused_lse_kernel<T, true><<<T_, block, 0, stream>>>(w, h, ids, corr,
                                                       biasg, lse, K, d,
                                                       abs_mode);
  else
    fused_lse_kernel<T, false><<<T_, block, 0, stream>>>(w, h, ids, corr,
                                                        biasg, lse, K, d,
                                                        abs_mode);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC, bool ONE>
cudaError_t launch_front(int grid, int threads, size_t smem,
                         cudaStream_t stream, const T* w, const T* h,
                         const int* ids, const float* corr,
                         const float* biasg, const float* lse,
                         const float* gbar, float* dh, float* dcoef,
                         float* dcorr, const Workspace& ws, long long S,
                         int K, int d, int abs_mode, int chunk, int n_chunks,
                         int n_lists, int list_rows) {
  auto kernel = fused_bwd_front_kernel<T, VEC, ONE>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(w, h, ids, corr, biasg, lse, gbar,
                                          dh, dcoef, dcorr, ws, S, K, d,
                                          abs_mode, chunk, n_chunks, n_lists,
                                          list_rows);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* w, const T* h, const int* ids, const float* corr,
               const float* biasg, const float* lse, const float* gbar,
               float* dw, float* dh, float* dcoef, float* dcorr, int* wsp,
               int T_, int K, int d, int n, int abs_mode, int warps,
               int chunk, int q, int run, long long ws_words,
               cudaStream_t stream) {
  const long long S = static_cast<long long>(T_) * K;
  if (warps < 1 || warps > kMaxWarps || chunk < 32 || q < 1 || run < 1 ||
      S > INT_MAX || (S + run - 1) / run > kMaxRuns)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = static_cast<int>((S + chunk - 1) / chunk);
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int n_lists = (n_tiles + q - 1) / q;
  const int list_rows = q * kTileRows;
  const int col_chunks = (d + kColChunk - 1) / kColChunk;
  const long long extra = (S + run - 1) / run;
  const long long partials = (2 * S + run - 1) / run + 1;
  const long long units = n_lists + extra;
  if (units > INT_MAX || col_chunks > 65535 ||
      static_cast<long long>(n_lists) * list_rows > INT_MAX ||
      static_cast<long long>(T_) * list_rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Workspace ws = carve(wsp, S, d, q, n_chunks, n_lists, n_tiles, extra,
                             partials, col_chunks);
  if (static_cast<long long>(ws.words) > ws_words)
    return static_cast<int>(cudaErrorInvalidValue);

  // 1. front: the sort blocks first, then the tokens
  const int vec = vec_ok(w, h, d) && aligned(dw, 16);
  const bool one = d <= kColChunk;
  const size_t strips = static_cast<size_t>(warps) *
                        (one ? 1 : col_chunks) * 32 * sizeof(float4);
  const size_t counts = static_cast<size_t>(warps) * n_lists * sizeof(int);
  const size_t smem = strips > counts ? strips : counts;
  auto front = vec ? (one ? launch_front<T, true, true>
                          : launch_front<T, true, false>)
                   : (one ? launch_front<T, false, true>
                          : launch_front<T, false, false>);
  cudaError_t err = front(n_chunks + T_, warps * 32, smem, stream, w, h, ids,
                          corr, biasg, lse, gbar, dh, dcoef, dcorr, ws, S, K,
                          d, abs_mode, chunk, n_chunks, n_lists, list_rows);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 2. the lists
  const size_t scan_smem = static_cast<size_t>(n_lists) * sizeof(int);
  err = allow_smem(fused_bwd_scan_kernel, scan_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_bwd_scan_kernel<<<n_chunks * kScanSplit, kScanThreads, scan_smem,
                          stream>>>(ids, dcoef, ws, S, K, chunk, n_chunks,
                                    n_lists, list_rows, q, n_tiles, run,
                                    col_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 3. dL/dw
  const dim3 grid3(static_cast<unsigned>(units), col_chunks);
  if (vec)
    fused_bwd_dw_kernel<T, true><<<grid3, kDwThreads, 0, stream>>>(
        h, dw, ws, n, d, q, n_tiles, run, col_chunks);
  else
    fused_bwd_dw_kernel<T, false><<<grid3, kDwThreads, 0, stream>>>(
        h, dw, ws, n, d, q, n_tiles, run, col_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w: (n, d), h: (T, d), fp32 (bf16 = 0) or bf16 (bf16 = 1); ids: (T, K)
// int32; corr, biasg: (T, K) fp32; lse: (T,) fp32 out — contiguous.
// `warps` per token block (fused_head.plan).  Launches on `stream` of
// `device`; returns the launch's cudaError_t.
extern "C" int fused_lse_f32(const void* w, const void* h, const int* ids,
                             const float* corr, const float* biasg,
                             float* lse, int T, int K, int d, int abs_mode,
                             int bf16, int warps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fwd(static_cast<const __nv_bfloat16*>(w),
                      static_cast<const __nv_bfloat16*>(h), ids, corr, biasg,
                      lse, T, K, d, abs_mode, warps, s);
  return launch_fwd(static_cast<const float*>(w),
                    static_cast<const float*>(h), ids, corr, biasg, lse, T,
                    K, d, abs_mode, warps, s);
}

// As fused_lse_f32, plus lse, gbar: (T,) in; dw: (n, d), dh: (T, d),
// dcoef, dcorr: (T, K) fp32 out, every element written (dw is not zeroed
// by the caller); ws: `ws_words` int32 of workspace; `warps`, `chunk`
// (slots per sort block), `q` (dw tiles per list tile) and `run` from
// fused_head.plan.
extern "C" int fused_lse_bwd_f32(const void* w, const void* h, const int* ids,
                                 const float* corr, const float* biasg,
                                 const float* lse, const float* gbar,
                                 float* dw, float* dh, float* dcoef,
                                 float* dcorr, int* ws, int T, int K, int d,
                                 int n, int abs_mode, int bf16, int warps,
                                 int chunk, int q, int run, long long ws_words,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd(static_cast<const __nv_bfloat16*>(w),
                      static_cast<const __nv_bfloat16*>(h), ids, corr, biasg,
                      lse, gbar, dw, dh, dcoef, dcorr, ws, T, K, d, n,
                      abs_mode, warps, chunk, q, run, ws_words, s);
  return launch_bwd(static_cast<const float*>(w),
                    static_cast<const float*>(h), ids, corr, biasg, lse,
                    gbar, dw, dh, dcoef, dcorr, ws, T, K, d, n, abs_mode,
                    warps, chunk, q, run, ws_words, s);
}
