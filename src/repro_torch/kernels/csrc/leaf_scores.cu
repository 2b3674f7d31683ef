// Per-draw within-leaf scores  out[g, b] = rows[g, b, :] . h[g, :]  (dot
// mode) or  alpha * dot^2 + 1  (square mode), fp32.
//
// Replaces: src/repro/kernels/leaf_scores.py::leaf_scores (the Pallas
// kernel: an elementwise multiply and lane reduction on the VPU).  On the
// serving path its dot mode re-scores the surviving leaves exactly
// (serve/retrieval.py::leaf_topk via ops.leaf_dots); the square mode serves
// the sampler's within-leaf categorical in the training slice.
//
// Bound on an H100 at the path's shape (T = 16 queries x beam 256 leaves =
// G 4096, B = 128 rows of r = 128): 268 MB of gathered rows read for 2 FLOPs
// per 4-byte element, 80 us at 3.35 TB/s.  The kernel is memory bound.
//
// Simple design (row_dots.cuh, shared with midx_member_scores): one thread
// block of 8 warps per g, h[g] staged in shared memory, one warp per output
// row reading it 16 bytes a lane, a shuffle reduction.  Fusing the caller's
// wq[leaves] gather into this kernel (so the 268 MB copy is never written)
// is later work.
#include "row_dots.cuh"

namespace {

__global__ void leaf_scores_kernel(const float* __restrict__ h,
                                   const float* __restrict__ rows,
                                   float* __restrict__ out, int B, int r,
                                   float alpha, int square, int vec) {
  row_dots::score_rows(h, rows, out, B, r, alpha, square, vec);
}

}  // namespace

// h: (G, r); rows: (G, B, r); out: (G, B) — fp32, contiguous.
// square != 0: alpha * dot^2 + 1; square == 0: raw dots (alpha ignored).
// Launches on `stream` of `device`; returns the launch's cudaError_t.
extern "C" int leaf_scores_f32(const float* h, const float* rows, float* out,
                               int G, int B, int r, float alpha, int square,
                               int device, void* stream) {
  return row_dots::launch(leaf_scores_kernel, h, rows, out, G, B, r, alpha,
                          square, device, stream);
}
