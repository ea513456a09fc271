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
// pixel's records in REVERSE from e - 1 down to 0, recovering T_before of
// each contributing record by subtracting log1pf(-a) from the carried sum,
// and carries the suffix accumulator
//   S_i = sum_{j > i, contributing} dw_j w_j + g_T t_final,
// started at g_T * exp(lsum_exit): t_final is exactly that transmittance,
// whether the pixel exited (the first failing record's T_before) or not
// (T_end). For a contributing record (a >= 1/255, before the exit):
//   w = a T,  dw = rgb . g_rgb (+ invdepth g_inv with depth_grad),
//   da = dw T - S_i / (1 - a),  dpow = da * a_raw (the 0.99 clip is
//   straight-through: a_raw = o exp(power) unclipped),
// and the 10 per-pair terms are mean2d (2): dpow * dpower/dmean,
// conic (3): dpow * dpower/dconic, opacity: da * exp(power),
// rgb (3): w * g_rgb, invdepth: w * g_inv (zero without depth_grad).
// Each record's terms are summed over the tile's 256 pixels. Records at or
// past a pixel's exit contribute nothing for it; rows past every pixel's
// exit are written as exact zeros, so no row of drec is left unwritten.
//
// No global atomics: records are duplicated per tile, so every drec row
// belongs to exactly one tile and one block writes it. The reduction is
// deterministic: each warp sums a record's 10 terms with __shfl_down_sync,
// lane 0 stores the warp's partial in shared memory, and after a barrier
// the block adds the 8 warps' partials in a fixed order and writes the
// chunk's rows coalesced. The same inputs give the same bits on every run.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// before each pixel's exit (the power gate, then expf, log1pf, expf and
// about 40 multiply-adds per contributing pair), plus the reduction's adds;
// bytes (records read once, drec written once, gtiles and the exit state)
// are small beside that. Design: one block per tile, one thread per pixel,
// as kernel A. The block walks from the largest exit position among its
// pixels, staging 64-record chunks in shared memory last chunk first; a
// warp with no contributing lane skips its shuffles.
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gslm;

constexpr int CH = 64;             // records per staged chunk
constexpr int WARPS = PIX / 32;    // 8
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(PIX)
composite_bwd_kernel(const float* __restrict__ records,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx, int view_rows,
                     const float* __restrict__ gtiles,
                     const float* __restrict__ state, int depth_grad,
                     float* __restrict__ drec) {
  __shared__ float rec[CH * NF];
  __shared__ float part[WARPS * CH * NF];   // [warp][record][field]
  __shared__ int s_n_eff;
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  float px, py;
  tile_pixel(t, lane, ntx, view_rows, px, py);
  const int start = starts[t];
  const int count = counts[t];

  const float* g = gtiles + (size_t)t * IMG_ROWS * PIX + lane;
  const float g_r = g[0 * PIX], g_g = g[1 * PIX], g_b = g[2 * PIX];
  const float g_i = depth_grad ? g[3 * PIX] : 0.f;
  const float g_T = g[4 * PIX];
  const float* st = state + (size_t)t * 2 * PIX + lane;
  float lsum = st[0];
  // clamped to the segment, so no state can address rows outside it
  const int exit_pos = min(max((int)st[PIX], 0), count);

  if (lane == 0) s_n_eff = 0;
  __syncthreads();
  atomicMax(&s_n_eff, exit_pos);
  __syncthreads();
  const int n_eff = s_n_eff;   // records any pixel of the tile reached

  float* out = drec + (size_t)start * NF;
  for (int j = n_eff * NF + lane; j < count * NF; j += PIX) out[j] = 0.f;

  float S = g_T * expf(lsum);
  for (int lo = n_eff > 0 ? ((n_eff - 1) / CH) * CH : -1; lo >= 0;
       lo -= CH) {
    const int n = min(CH, n_eff - lo);
    const float* src = records + (size_t)(start + lo) * NF;
    for (int j = lane; j < n * NF; j += PIX) rec[j] = src[j];
    __syncthreads();   // chunk staged; the previous chunk's sums are read
    for (int i = n - 1; i >= 0; --i) {
      float v[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) v[f] = 0.f;
      bool active = false;
      const float* r = rec + i * NF;
      Pair p;
      if (lo + i < exit_pos && pair_alpha(r, px, py, p)) {
        active = true;
        const float a = p.a, dx = p.dx, dy = p.dy;
        const float l_before = fminf(lsum - log1pf(-a), 0.f);
        const float T = expf(l_before);
        const float w = a * T;
        const float dw = r[6] * g_r + r[7] * g_g + r[8] * g_b + r[9] * g_i;
        const float da = dw * T - S / (1.f - a);
        S += dw * w;
        const float dpow = da * p.a_raw;
        v[0] = dpow * -(r[2] * dx + r[3] * dy);
        v[1] = dpow * -(r[4] * dy + r[3] * dx);
        v[2] = dpow * (-0.5f * dx * dx);
        v[3] = dpow * (-dx * dy);
        v[4] = dpow * (-0.5f * dy * dy);
        v[5] = da * p.expp;
        v[6] = w * g_r;
        v[7] = w * g_g;
        v[8] = w * g_b;
        v[9] = w * g_i;
        lsum = l_before;
      }
      if (__any_sync(FULL, active)) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[f] += __shfl_down_sync(FULL, v[f], off);
          }
        }
      }
      if ((lane & 31) == 0) {
        float* p = part + (warp * CH + i) * NF;
#pragma unroll
        for (int f = 0; f < NF; ++f) p[f] = v[f];
      }
    }
    __syncthreads();   // every warp's partials are in
    for (int j = lane; j < n * NF; j += PIX) {
      float s = part[j];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += part[w * CH * NF + j];
      out[lo * NF + j] = s;
    }
  }
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
