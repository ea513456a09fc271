// Shared by kernel A (composite_fwd.cu), kernels C and D (composite_bwd.cu,
// composite_bucket_bwd.cu, through composite_bwd_tile.cuh) and kernel E
// (composite_jvp.cu): the record layout, the compositing constants, the
// per-pair alpha arithmetic and bucket mode's rect gate. The guard
// E<MASK=false> evaluates a (record, pixel) pair through pair_alpha;
// kernels A, C, D and the masked E call splat_power and write pair_alpha's
// alpha and two gates out as branches (a call to it cost kernel A 32 more
// SASS instructions and 5-7 % of its time on an H100). E<MASK=false>'s
// primal, held equal bit for bit to kernel A's and to the masked E's
// (chip_smoke.py phases 7 and 8, tests/test_torch_cuda.py), guards that
// copy, so the backward's and the tangent's gates (rect, power <= 0,
// alpha >= 1/255) see the very bits the forward saw.
#pragma once

namespace gslm {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, one per pixel
constexpr int NF = 10;            // float32 fields per record:
                                  // mean2d 2, conic 3, opacity, rgb 3, invdepth
constexpr int IMG_ROWS = 5;       // r, g, b, invdepth, t_final
constexpr int OUT_ROWS = 7;       // + exit log-transmittance, exit position
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

// Pixel origin of tile ``t`` (tile rows wrap modulo view_rows, so y is
// view-local), the point bucket mode's rect gate tests.
__device__ __forceinline__ void tile_origin(int t, int ntx, int view_rows,
                                            int& txc, int& tyc) {
  txc = (t % ntx) * TILE;
  tyc = ((t / ntx) % view_rows) * TILE;
}

// Bucket mode's rect gate: a record of a bucket segment counts for the tile
// whose pixel origin is (txc, tyc) only inside the record's own tile rect
// q = [x0, x1) x [y0, y1) in pixels, y view-local (the 4 int32 of its row of
// ``rects``). It is uniform across a tile's block: evaluated once per staged
// record, it skips the record before its power is computed.
__device__ __forceinline__ bool rect_gate(const int* q, int txc, int tyc) {
  return txc >= q[0] && txc < q[1] && tyc >= q[2] && tyc < q[3];
}

// power = -0.5 (c0 dx^2 + c2 dy^2) - c1 dx dy of record r at (px, py).
__device__ __forceinline__ float splat_power(const float* r, float px,
                                             float py, float& dx, float& dy) {
  dx = r[0] - px;
  dy = r[1] - py;
  return -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
}

// One (record, pixel) pair past the power gate: the offsets, exp(power),
// the unclipped alpha o exp(power) and the clipped a = min(a_raw, 0.99).
struct Pair {
  float dx, dy, expp, a_raw, a;
};

// Evaluate record r at (px, py): false when the pair contributes nothing
// (power > 0, or a < 1/255), true with ``p`` filled when it contributes.
// Kernels A, C and E repeat these operations written out: change them
// together.
__device__ __forceinline__ bool pair_alpha(const float* r, float px, float py,
                                           Pair& p) {
  const float power = splat_power(r, px, py, p.dx, p.dy);
  if (!(power <= 0.f)) return false;
  p.expp = expf(power);
  p.a_raw = r[5] * p.expp;
  p.a = fminf(p.a_raw, ALPHA_MAX);
  return p.a >= ALPHA_MIN;
}

}  // namespace gslm
