// Kernel C: backward tile compositor (the VJP of kernel A).
//
// Replaces the Pallas TPU backward compositor of gslm_tpu:
// _bwd_call / _make_tile_bwd_kernel (gslm_tpu/ops/rasterize_pallas.py).
//
// What it computes: the cotangent of every record field, drec (L, 10), from
// the image cotangent gtiles (ntiles, 5, 256) [r, g, b, invdepth, t_final]
// and the exit state kernel A saved per pixel: the log-transmittance sum at
// the exit and the exit position e (the in-segment index of the first
// record that failed T_after >= 1e-4, or count). Each thread walks its own
// pixel's records in REVERSE from e - 1 down to 0 with the suffix
// accumulator S_i (composite_bwd_walk.cuh), started at g_T * exp(lsum_exit):
// t_final is exactly that transmittance, whether the pixel exited (the
// first failing record's T_before) or not (T_end). Each record's 10 terms
// are summed over the tile's 256 pixels (the invdepth term is zero without
// depth_grad). Records at or past a pixel's exit contribute nothing for it;
// rows past every pixel's exit are written as exact zeros, so no row of
// drec is left unwritten.
//
// No global atomics: records are duplicated per tile, so every drec row
// belongs to exactly one tile and one block writes it. The per-record sum
// over the tile's pixels is deterministic (composite_bwd_walk.cuh: warp
// shuffles, then a fixed-order sum of the 8 warps), so the same inputs give
// the same bits on every run.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// before each pixel's exit (the power gate, then expf, log1pf, expf and
// about 40 multiply-adds per contributing pair), plus the reduction's adds;
// bytes (records read once, drec written once, gtiles and the exit state)
// are small beside that. Design: one block per tile, one thread per pixel,
// as kernel A. The block walks from the largest exit position among its
// pixels (``reverse_walk``, shared with kernel D), staging 64-record chunks
// in shared memory last chunk first.
#include <cuda_runtime.h>

#include "composite_bwd_walk.cuh"

namespace {

using namespace gslm;

__global__ void __launch_bounds__(PIX)
composite_bwd_kernel(const float* __restrict__ records,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx, int view_rows,
                     const float* __restrict__ gtiles,
                     const float* __restrict__ state, int depth_grad,
                     float* __restrict__ drec) {
  __shared__ WalkShared sm;
  __shared__ int s_n_eff;
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  float px, py;
  tile_pixel(t, lane, ntx, view_rows, px, py);
  const int start = starts[t];
  const int count = counts[t];

  const float* g = gtiles + (size_t)t * IMG_ROWS * PIX + lane;
  const float g_r = g[0 * PIX], g_g = g[1 * PIX], g_b = g[2 * PIX];
  const float g_i = depth_grad ? g[3 * PIX] : 0.f;
  const float g_T = g[4 * PIX];
  const float* st = state + (size_t)t * 2 * PIX + lane;
  const float lsum = st[0];
  // clamped to the segment, so no state can address rows outside it
  const int exit_pos = min(max((int)st[PIX], 0), count);

  if (lane == 0) s_n_eff = 0;
  __syncthreads();
  atomicMax(&s_n_eff, exit_pos);
  __syncthreads();
  const int n_eff = s_n_eff;   // records any pixel of the tile reached

  float* out = drec + (size_t)start * NF;
  for (int j = n_eff * NF + lane; j < count * NF; j += PIX) out[j] = 0.f;

  reverse_walk<false, false>(records + (size_t)start * NF, nullptr, out, sm,
                             n_eff, exit_pos, px, py, 0, 0, g_r, g_g, g_b,
                             g_i, g_T * expf(lsum), lsum);
}

}  // namespace

// records (L, 10) f32, starts/counts (ntiles,) i32, gtiles (ntiles, 5, 256)
// f32, state (ntiles, 2, 256) f32 [exit lsum, exit position] → drec (L, 10)
// f32 (every row of every segment written). Launches on ``stream``; returns
// cudaGetLastError.
extern "C" int composite_bwd(const float* records, const int* starts,
                             const int* counts, int ntiles, int ntx,
                             int view_rows, const float* gtiles,
                             const float* state, int depth_grad, float* drec,
                             cudaStream_t stream) {
  if (ntiles > 0) {
    composite_bwd_kernel<<<ntiles, PIX, 0, stream>>>(
        records, starts, counts, ntx, view_rows, gtiles, state, depth_grad,
        drec);
  }
  return (int)cudaGetLastError();
}
