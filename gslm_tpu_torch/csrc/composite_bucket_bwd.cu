// Kernel D: backward compositor of bucket mode (the VJP of kernel A when
// tiles walk bucket segments).
//
// Replaces the Pallas TPU bucket backward of gslm_tpu:
// _bucket_bwd_call / _make_bucket_bwd_kernel
// (gslm_tpu/ops/rasterize_pallas.py).
//
// What it computes: with RasterConfig.bucket = BK > 1 the records are
// binned per BK x BK-tile bucket and each of a bucket's BK^2 member tiles
// walks the bucket's whole segment under the rect gate (a record counts for
// a tile only inside the record's own tile rect). A record of bucket b's
// segment is therefore shared by b's member tiles, and its cotangent drec
// (Lb, 10) is the SUM over b's valid member tiles of the 10 per-record
// terms kernel C computes for one tile: each tile's reverse walk from the
// exit state kernel A saved for it (rows 5-6 of A's output: exit
// log-transmittance and exit position, in bucket-segment coordinates), with
// the suffix accumulator S_i (composite_bwd_walk.cuh). Member slot
// s = dy * BK + dx of bucket (bx, by) is tile
// (view * view_rows + by_in_view * BK + dy) * ntx + bx * BK + dx; a member
// past the last tile column (ntx % BK != 0) or past its view's rows does
// not exist and is skipped. Every row of every segment is written: exact
// zeros where no member tile contributes.
//
// No float atomics: one block owns one bucket's segment, so every drec row
// is written by one block only. The block zero-fills its rows, then takes
// the member tiles one at a time in slot order and adds each tile's
// per-record sums (kernel C's deterministic reduction: warp shuffles, then a
// fixed-order sum of the 8 warps) into the rows. The same inputs give the
// same bits on every run.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// that pass the rect gate before each pixel's exit, summed over the member
// tiles (kernel C's arithmetic per pair); gated records cost a shared-memory
// flag per thread. Bytes: records and rects read once per member tile that
// walks them (the bound counts them once), drec read and written per member.
// Design: one block per bucket, one thread per pixel (256 threads), the
// member tiles in turn through kernel C's reverse walk (reverse_walk), each
// from its own largest exit position. Simple and right first: one bucket
// per block is few blocks (510 at 1080p with BK = 4) and the members run
// one after another.
#include <cuda_runtime.h>

#include "composite_bwd_walk.cuh"

namespace {

using namespace gslm;

__global__ void __launch_bounds__(PIX)
composite_bucket_bwd_kernel(const float* __restrict__ records,
                            const int* __restrict__ rects,
                            const int* __restrict__ bstarts,
                            const int* __restrict__ bcounts, int ntx,
                            int nty, int view_rows, int bucket,
                            const float* __restrict__ gtiles,
                            const float* __restrict__ state, int depth_grad,
                            float* __restrict__ drec) {
  __shared__ WalkShared sm;
  __shared__ int s_n_eff;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int start = bstarts[b];
  const int count = bcounts[b];
  const float* seg = records + (size_t)start * NF;
  const int* seg_rects = rects + (size_t)start * 4;
  float* out = drec + (size_t)start * NF;
  for (int j = lane; j < count * NF; j += PIX) out[j] = 0.f;

  // the bucket's place: global bucket row, its view and row in the view
  const int nbx = (ntx + bucket - 1) / bucket;
  const int vrow_b = view_rows / bucket;
  const int byv = b / nbx;
  const int bx = b % nbx;
  const int view = byv / vrow_b;
  const int by_in_view = byv % vrow_b;

  for (int s = 0; s < bucket * bucket; ++s) {
    const int ty_in_view = by_in_view * bucket + s / bucket;
    const int tx = bx * bucket + s % bucket;
    const int ty = view * view_rows + ty_in_view;
    if (tx >= ntx || ty >= nty) continue;   // no such tile (uniform)
    const int t = ty * ntx + tx;
    float px, py;
    tile_pixel(t, lane, ntx, view_rows, px, py);

    const float* g = gtiles + (size_t)t * IMG_ROWS * PIX + lane;
    const float g_r = g[0 * PIX], g_g = g[1 * PIX], g_b = g[2 * PIX];
    const float g_i = depth_grad ? g[3 * PIX] : 0.f;
    const float g_T = g[4 * PIX];
    const float* st = state + (size_t)t * 2 * PIX + lane;
    const float lsum = st[0];
    // clamped to the segment, so no state can address rows outside it
    const int exit_pos = min(max((int)st[PIX], 0), count);

    // the previous member's walk (and the zero fill) are done, and every
    // thread has read s_n_eff, before it is reset
    __syncthreads();
    if (lane == 0) s_n_eff = 0;
    __syncthreads();
    atomicMax(&s_n_eff, exit_pos);
    __syncthreads();
    const int n_eff = s_n_eff;   // records any pixel of this tile reached

    reverse_walk<true, true>(seg, seg_rects, out, sm, n_eff, exit_pos, px,
                             py, tx * TILE, ty_in_view * TILE, g_r, g_g, g_b,
                             g_i, g_T * expf(lsum), lsum);
  }
}

}  // namespace

// records (Lb, 10) f32 and rects (Lb, 4) i32 in bucket-segment order,
// bstarts/bcounts (nseg,) i32, gtiles (ntiles, 5, 256) f32 and state
// (ntiles, 2, 256) f32 [exit lsum, exit position] in tile order (ntiles =
// ntx * nty, tile rows stacking views of view_rows rows, view_rows % bucket
// == 0) → drec (Lb, 10) f32 (every row of every segment written). Launches
// on ``stream``; returns cudaGetLastError.
extern "C" int composite_bucket_bwd(const float* records, const int* rects,
                                    const int* bstarts, const int* bcounts,
                                    int nseg, int ntx, int nty, int view_rows,
                                    int bucket, const float* gtiles,
                                    const float* state, int depth_grad,
                                    float* drec, cudaStream_t stream) {
  if (nseg > 0) {
    composite_bucket_bwd_kernel<<<nseg, PIX, 0, stream>>>(
        records, rects, bstarts, bcounts, ntx, nty, view_rows, bucket, gtiles,
        state, depth_grad, drec);
  }
  return (int)cudaGetLastError();
}
