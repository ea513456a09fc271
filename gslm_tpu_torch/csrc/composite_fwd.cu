// Kernel A: forward tile compositor.
//
// Replaces the Pallas TPU forward compositor of gslm_tpu:
// _fwd_call / _make_tile_kernel (gslm_tpu/ops/rasterize_pallas.py).
//
// What it computes: for every 16x16 tile, front-to-back alpha compositing
// over the tile's depth-sorted record segment. A record is 10 float32
// fields: mean2d (2), conic (3), opacity, rgb (3), invdepth. Per pixel:
//   power = -0.5 (c0 dx^2 + c2 dy^2) - c1 dx dy, dx = mean_x - px
//   gate power <= 0; a = min(o exp(power), 0.99); contributes iff a >= 1/255
//   weight a*T while T_before >= 1e-4 and T_after >= 1e-4; at the first
//   record that fails, t_final freezes at its T_before and the pixel stops.
// Pixel coordinates carry no +0.5 and tile rows wrap modulo view_rows, so a
// stacked multi-view batch composites each view exactly as a single view.
// Transmittance is a running log sum (lsum += log1pf(-a); T = expf(lsum)),
// the Pallas kernel's formulation.
//
// Outputs: per tile (7, 256) float32 rows [r, g, b, invdepth, t_final,
// exit lsum, exit position] and the number of records the block walked
// (what bounds its work). Rows 5-6 are the exit state kernel C starts its
// reverse walk from (the Pallas forward saves the same in its spare rows
// 5-6): the log-transmittance sum at the exit, and the in-segment index of
// the first record that fails T_after >= 1e-4, or count when none fails.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// walked; the records read are 40 B per record per tile, tiny beside that.
// Per pair (sm_90a SASS): 9 FFMA/FADD/FMUL for the power and its gate; past
// it 7 more and one MUFU.EX2 (expf); past the 1/255 gate 23 more (log1pf is
// 16) and one MUFU.EX2; 5 more to accumulate. Design: one
// block per tile, one thread per pixel (256 threads). The block stages a
// chunk of 256 records in shared memory with one coalesced copy, every
// thread composites it in order from shared memory (all threads read the
// same record: a broadcast, no bank conflicts), and the block stops at the
// first chunk boundary where every pixel has exited (__syncthreads_count),
// so the walk ends early on deep segments as the CUDA reference's does.
//
// Bucket mode (a non-null ``rects``, the RECT instantiation): a tile walks
// its parent bucket's segment, and a record counts for it only inside the
// record's own tile rect (rect_gate, composite_common.cuh). The block
// evaluates the gate once per record as it stages the chunk and every
// thread skips a gated record before its power; the exit position is in
// bucket-segment coordinates. RECT = false compiles the bucket-1 loop
// unchanged.
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gslm;

template <bool RECT>
__global__ void __launch_bounds__(PIX)
composite_fwd_kernel(const float* __restrict__ records,
                     const int* __restrict__ rects,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx, int view_rows,
                     float* __restrict__ out, int* __restrict__ walked) {
  __shared__ float rec[PIX * NF];
  __shared__ bool gate[RECT ? PIX : 1];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  float px, py;
  tile_pixel(t, lane, ntx, view_rows, px, py);
  int txc, tyc;
  tile_origin(t, ntx, view_rows, txc, tyc);
  const int start = starts[t];
  const int count = counts[t];

  float lsum = 0.f, T = 1.f, t_final = 1.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f;
  bool done = false;
  int exit_pos = count;
  int n_walked = 0;

  for (int base = 0; base < count; base += PIX) {
    // barrier: the previous chunk is consumed before it is overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(PIX, count - base);
    const float* src = records + (size_t)(start + base) * NF;
    for (int j = lane; j < n * NF; j += PIX) rec[j] = src[j];
    if (RECT && lane < n) {
      gate[lane] = rect_gate(rects + (size_t)(start + base + lane) * 4, txc,
                             tyc);
    }
    __syncthreads();
    n_walked += n;
    for (int i = 0; i < n && !done; ++i) {
      if (RECT && !gate[i]) continue;
      const float* r = rec + i * NF;
      Pair p;
      if (!pair_alpha(r, px, py, p)) continue;
      const float a = p.a;
      const float l_after = lsum + log1pf(-a);
      const float t_after = expf(l_after);
      if (t_after < T_EPS) {  // T_before >= 1e-4 holds here by induction
        t_final = T;
        exit_pos = base + i;
        done = true;
        break;
      }
      const float w = a * T;
      acc_r += w * r[6];
      acc_g += w * r[7];
      acc_b += w * r[8];
      acc_d += w * r[9];
      lsum = l_after;
      T = t_after;
    }
  }
  if (!done) t_final = T;

  float* o = out + (size_t)t * OUT_ROWS * PIX + lane;
  o[0 * PIX] = acc_r;
  o[1 * PIX] = acc_g;
  o[2 * PIX] = acc_b;
  o[3 * PIX] = acc_d;
  o[4 * PIX] = t_final;
  o[5 * PIX] = lsum;
  o[6 * PIX] = (float)exit_pos;  // exact: segments hold far fewer than 2^24
  if (lane == 0) walked[t] = n_walked;
}

}  // namespace

// records (L, 10) f32, rects (L, 4) i32 or null (bucket 1), starts/counts
// (ntiles,) i32 → out (ntiles, 7, 256) f32, walked (ntiles,) i32. Launches
// on ``stream``; returns cudaGetLastError.
extern "C" int composite_fwd(const float* records, const int* rects,
                             const int* starts, const int* counts, int ntiles,
                             int ntx, int view_rows, float* out, int* walked,
                             cudaStream_t stream) {
  if (ntiles > 0) {
    if (rects) {
      composite_fwd_kernel<true><<<ntiles, PIX, 0, stream>>>(
          records, rects, starts, counts, ntx, view_rows, out, walked);
    } else {
      composite_fwd_kernel<false><<<ntiles, PIX, 0, stream>>>(
          records, rects, starts, counts, ntx, view_rows, out, walked);
    }
  }
  return (int)cudaGetLastError();
}
