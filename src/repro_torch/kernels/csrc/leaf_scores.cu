// Per-draw within-leaf scores  out[g, b] = rows[g, b, :] . h[g, :]  (dot
// mode) or  alpha * dot^2 + 1  (square mode), fp32.
//
// Replaces: src/repro/kernels/leaf_scores.py::leaf_scores (the Pallas
// kernel: an elementwise multiply and lane reduction on the VPU).  On the
// serving paths its dot mode re-scores the surviving leaves exactly
// (serve/retrieval.py::leaf_topk via ops.leaf_dots): youtube-dnn's beam
// decode and llama3-8b's top-k step through the index; the square mode
// serves the block and tree samplers' within-leaf categorical in training,
// and the dot mode rff's leaf step.
//
// Bound on an H100, all by the bytes of the gathered rows (read once, 2
// FLOPs per 4-byte element, 3.35 TB/s): training (G 32,768 draws, B 256,
// r 128) 4.3 GB = 1.30 ms; youtube-dnn serving (T 16 x beam 256 = G
// 4,096, B 128, r 128) 268 MB = 81 us; llama3-8b's full beam (G 128 leaves
// of B 4,096 rows, r 4,096) 8.6 GB = 2.57 ms.
//
// Design (row_dots.cuh, shared with midx_member_scores): a 1-D grid over
// (g, chunk of rows) from kernels/leaf_scores.py::plan, so that llama's 128
// wide leaves give thousands of blocks, not 128; h[g] staged in shared
// memory; eight independent 16-byte streaming loads in flight per lane
// (eight rows per warp pass at r = 128, eight float4 of one row at r =
// 4,096), a shuffle reduction per row.  Fusing the caller's wq[leaves]
// gather into this kernel (so the copy is never written) is later work.
#include "row_dots.cuh"

namespace {

template <int U>
__global__ void leaf_scores_kernel(const float* __restrict__ h,
                                   const float* __restrict__ rows,
                                   float* __restrict__ out, int B, int r,
                                   float alpha, int square, int chunk,
                                   int n_chunks, int vec) {
  row_dots::score_rows<U>(h, rows, out, B, r, alpha, square, chunk, n_chunks,
                          vec);
}

}  // namespace

// h: (G, r); rows: (G, B, r); out: (G, B) — fp32, contiguous.
// square != 0: alpha * dot^2 + 1; square == 0: raw dots (alpha ignored).
// chunk and unroll from kernels/leaf_scores.py::plan.  Launches on
// `stream` of `device`; returns the launch's cudaError_t.
extern "C" int leaf_scores_f32(const float* h, const float* rows, float* out,
                               int G, int B, int r, float alpha, int square,
                               int chunk, int unroll, int device,
                               void* stream) {
  static const row_dots::Kernel kernels[2] = {leaf_scores_kernel<1>,
                                              leaf_scores_kernel<8>};
  return row_dots::launch(kernels, h, rows, out, G, B, r, alpha, square,
                          chunk, unroll, device, stream);
}
