// Kernel A's 8x4 warp patches and per-record patch mask, shared by kernel A
// (composite_fwd.cu), kernels C and D (composite_bwd_tile.cuh) and kernel E
// (composite_jvp.cu). Plain version of the mask:
// ops/rasterize_cuda.py ``patch_masks``; of the mapping: ``PATCH_PIXELS``.
//
// Warps own 8x4 pixel patches: warp w covers x in [8 (w % 2), +8) and y in
// [4 (w / 2), +4) of the tile, lane l its pixel (l % 8, l / 8): the most
// compact 32-pixel footprint a tile offers, so a splat's edge leaves fewer
// warps with lanes that contribute beside lanes that idle than 16x2 strips
// do. Outputs stay at each pixel's row-major index y * 16 + x.
//
// Bit w of a record's mask is clear only where the record's alpha provably
// stays below 1/255 on every pixel of patch w, so a pair whose bit is clear
// fails the 1/255 gate and skipping it is exact. The test is the tile front
// end's exact one (quad_min_rect, rasterize_tiled._cell_masks) over the
// patch's pixel rectangle: q = c0 dx^2 + 2 c1 dx dy + c2 dy^2, the bit kept
// unless qmin (1 - 1e-4) - 4e-6 S > s2 + 1e-3, s2 = 2 ln(255 o). Why that
// is sound for every kernel's pair arithmetic, FMA contraction included:
// - A kernel's (dx, dy) at a pixel is fl(mean - p), the negation of
//   fl(p - mean), and rounding is monotone, so it lies in the float
//   rectangle the mask minimises over (q is even in (dx, dy)).
// - quad_min_rect is exact for c0, c2 > 0 up to the roundings of q: each
//   evaluation of q, the kernel's and the mask's, is a few products and
//   sums, off by at most ~10 u S with u = 2^-24 and S = c0 X^2 + 2 |c1| X Y
//   + c2 Y^2 the sum of the terms' magnitudes at the rectangle's largest
//   |dx| = X and |dy| = Y (an inexact parabola minimiser costs O(u^2 S)).
//   4e-6 S (~67 u S) covers both. The front end's own margin (1e-4 qmin +
//   1e-3) covers it only where the terms do not cancel: along the long
//   axis of a strongly anisotropic conic S exceeds q by up to twice the
//   conic's condition number, which preprocess does not bound (it bounds
//   the large eigenvalue by 1/0.3, not the small one).
// - The 1/255 gate itself: a = fl(o expf(power)) with expf within 2 ulp and
//   1/255 rounded to float move the threshold on q by ~1e-6, and s2 in
//   float is within ~1e-5 of 2 ln(255 o): the 1e-3 covers both.
// - Where the test does not hold, every bit is set: c0 or c2 below 1e-12
//   (the front end's clamp; 1/c0 would lose the minimiser), c0 c2 <= c1^2
//   (no parabola argument), NaN conic fields, and a non-finite opacity
//   (with it fminf(NaN, 0.99) makes a pair contribute). Any overflow or NaN
//   in the test makes the comparison false, so the bit stays set.
#pragma once

#include "composite_common.cuh"

namespace gslm {

constexpr int WARP = 32;
constexpr int WARPS = PIX / WARP;  // 8 warps, 8 patches a tile
constexpr int PATCH_W = 8;         // patch columns; 2 patches across a tile
constexpr int PATCH_H = 4;         // patch rows; 4 patches down a tile
constexpr unsigned FULL = 0xffffffffu;

// Tile pixel (x, y) of lane ``lane`` of warp ``warp``.
__device__ __forceinline__ void patch_pixel(int warp, int lane, int& x,
                                            int& y) {
  x = PATCH_W * (warp & 1) + lane % PATCH_W;
  y = PATCH_H * (warp >> 1) + lane / PATCH_W;
}

// Minimum of q = a dx^2 + 2 b dx dy + c dy^2 (a, c > 0; ia = 1/a, ic = 1/c)
// over [dx0, dx1] x [dy0, dy1]: 0 when the centre is inside, else the least
// of the four edges' clamped parabolas (ops/projection.py quad_min_rect).
__device__ __forceinline__ float quad_min_rect(float a, float b, float c,
                                               float ia, float ic, float dx0,
                                               float dx1, float dy0,
                                               float dy1) {
  if (dx0 <= 0.f && 0.f <= dx1 && dy0 <= 0.f && 0.f <= dy1) return 0.f;
  auto q = [&](float dx, float dy) {
    return a * dx * dx + 2.f * b * dx * dy + c * dy * dy;
  };
  auto edge_x = [&](float dx) {  // x fixed, minimise over y
    return q(dx, fminf(fmaxf(-b * dx * ic, dy0), dy1));
  };
  auto edge_y = [&](float dy) {  // y fixed, minimise over x
    return q(fminf(fmaxf(-b * dy * ia, dx0), dx1), dy);
  };
  return fminf(fminf(edge_x(dx0), edge_x(dx1)),
               fminf(edge_y(dy0), edge_y(dy1)));
}

// False only where the record's alpha provably stays below 1/255 on every
// pixel of the 8x4 patch whose top-left pixel is (x0, y0): geo = (mean x,
// mean y, c0, c1), c2, inv = (1/c0, 1/c2), s2 = 2 ln(255 o).
__device__ __forceinline__ bool patch_keeps(float4 geo, float c, float2 inv,
                                            float s2, int x0, int y0) {
  const float mx = geo.x, my = geo.y, a = geo.z, b = geo.w;
  const float dx0 = (float)x0 - mx, dx1 = (float)(x0 + PATCH_W - 1) - mx;
  const float dy0 = (float)y0 - my, dy1 = (float)(y0 + PATCH_H - 1) - my;
  const float qmin =
      quad_min_rect(a, b, c, inv.x, inv.y, dx0, dx1, dy0, dy1);
  const float X = fmaxf(fabsf(dx0), fabsf(dx1));
  const float Y = fmaxf(fabsf(dy0), fabsf(dy1));
  const float S = a * X * X + 2.f * fabsf(b) * X * Y + c * Y * Y;
  return !(qmin * (1.f - 1e-4f) - 4e-6f * S > s2 + 1e-3f);
}

// The test's set-up for one record (mean, c0, c1 in geo; c2; opacity o):
// false where the test does not hold (every bit set), else inv = (1/c0,
// 1/c2) and s2 = 2 ln(255 o).
__device__ __forceinline__ bool patch_setup(float4 geo, float c, float o,
                                           float2& inv, float& s2) {
  const float a = geo.z, b = geo.w;
  if (!isfinite(o) || !(a > 1e-12f && c > 1e-12f && a * c > b * b)) {
    return false;
  }
  inv = make_float2(1.f / a, 1.f / c);
  s2 = 2.f * logf(fmaxf(o * 255.f, 1e-12f));
  return true;
}

// Bit w set unless the record provably has alpha < 1/255 on every pixel of
// patch w of the tile at pixel origin (txc, tyc) (one thread, all 8
// patches; kernel A).
__device__ __forceinline__ unsigned patch_mask(float4 geo, float c, float o,
                                               int txc, int tyc) {
  float2 inv;
  float s2;
  if (!patch_setup(geo, c, o, inv, s2)) return 0xffu;
  unsigned m = 0u;
#pragma unroll 2
  for (int w = 0; w < WARPS; ++w) {
    if (patch_keeps(geo, c, inv, s2, txc + PATCH_W * (w & 1),
                    tyc + PATCH_H * (w >> 1))) {
      m |= 1u << w;
    }
  }
  return m;
}

// Bit w of the same mask, by itself (one thread per (record, patch);
// kernels C and D): the same set-up and test, so the same bit.
__device__ __forceinline__ bool patch_bit(float4 geo, float c, float o,
                                          int txc, int tyc, int w) {
  float2 inv;
  float s2;
  if (!patch_setup(geo, c, o, inv, s2)) return true;
  return patch_keeps(geo, c, inv, s2, txc + PATCH_W * (w & 1),
                     tyc + PATCH_H * (w >> 1));
}

}  // namespace gslm
