// The reverse walk of one tile over its records under 16x2 strips, kernel
// D's (composite_bucket_bwd.cu: a bucket's member tiles one after another).
// Kernel C walked it too before it moved to 8x4 patches, the patch mask and
// a reduce-scatter sum (composite_bwd.cu); D keeps this walk until its own
// redesign.
//
// Each thread walks its own pixel's records in REVERSE from the block's
// largest exit position, recovering T_before of each contributing record by
// subtracting log1pf(-a) from the carried log-transmittance sum, and carries
// the suffix accumulator S_i = sum_{j > i, contributing} dw_j w_j
// + g_T t_final. For a contributing record (a >= 1/255, before the pixel's
// exit): w = a T, dw = rgb . g_rgb (+ invdepth g_inv with depth_grad),
// da = dw T - S_i / (1 - a), dpow = da * a_raw (the 0.99 clip is straight
// through), and the 10 per-pair terms are mean2d (2): dpow * dpower/dmean,
// conic (3): dpow * dpower/dconic, opacity: da * exp(power), rgb (3):
// w * g_rgb, invdepth: w * g_inv.
//
// Records are staged 64 at a time in shared memory, last chunk first. Each
// record's terms are summed over the block's 256 pixels deterministically:
// warp shuffles (skipped by a warp with no contributing lane), lane 0's
// partial into shared memory, then after a barrier a fixed-order sum of the
// 8 warps, written (C) or added (D) to the record's row, coalesced. With
// RECT, a record outside the tile's rect gate is skipped before its power;
// the gate is evaluated once per staged record.
#pragma once

#include "composite_common.cuh"

namespace gslm {

constexpr int BWD_CH = 64;            // records per staged chunk
constexpr int BWD_WARPS = PIX / 32;   // 8

// Shared memory of one walk; a block walks one tile at a time.
struct WalkShared {
  float rec[BWD_CH * NF];
  float part[BWD_WARPS * BWD_CH * NF];   // [warp][record][field]
  bool gate[BWD_CH];
};

// Walks records [0, n_eff) of the segment whose first record is ``seg``
// (rects ``seg_rects``, read with RECT only) for pixel (px, py) of the tile
// with pixel origin (txc, tyc), from the pixel's exit position ``exit_pos``
// (<= n_eff), the exit log-transmittance sum ``lsum`` and S = g_T t_final.
// Writes (ACCUM false) or adds (ACCUM true) the walked records' summed terms
// to ``out``, the segment's rows of drec. Every thread of the block calls it
// with the same n_eff; it ends after its last barrier.
template <bool RECT, bool ACCUM>
__device__ __forceinline__ void reverse_walk(
    const float* __restrict__ seg, const int* __restrict__ seg_rects,
    float* __restrict__ out, WalkShared& sm, int n_eff, int exit_pos,
    float px, float py, int txc, int tyc, float g_r, float g_g, float g_b,
    float g_i, float S, float lsum) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  for (int lo = n_eff > 0 ? ((n_eff - 1) / BWD_CH) * BWD_CH : -1; lo >= 0;
       lo -= BWD_CH) {
    const int n = min(BWD_CH, n_eff - lo);
    const float* src = seg + (size_t)lo * NF;
    for (int j = lane; j < n * NF; j += PIX) sm.rec[j] = src[j];
    if (RECT && lane < n) {
      sm.gate[lane] = rect_gate(seg_rects + (size_t)(lo + lane) * 4, txc,
                                tyc);
    }
    __syncthreads();   // chunk staged; the previous chunk's sums are read
    for (int i = n - 1; i >= 0; --i) {
      float v[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) v[f] = 0.f;
      bool active = false;
      const float* r = sm.rec + i * NF;
      Pair p;
      if (lo + i < exit_pos && (!RECT || sm.gate[i])
          && pair_alpha(r, px, py, p)) {
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
        float* q = sm.part + (warp * BWD_CH + i) * NF;
#pragma unroll
        for (int f = 0; f < NF; ++f) q[f] = v[f];
      }
    }
    __syncthreads();   // every warp's partials are in
    for (int j = lane; j < n * NF; j += PIX) {
      float s = sm.part[j];
#pragma unroll
      for (int w = 1; w < BWD_WARPS; ++w) s += sm.part[w * BWD_CH * NF + j];
      if (ACCUM) {
        out[lo * NF + j] += s;
      } else {
        out[lo * NF + j] = s;
      }
    }
  }
}

}  // namespace gslm
