// Kernel G: the exact ellipse-tile cull masks of the tile front end.
//
// Replaces no Pallas kernel: in the JAX package the masks are array code
// that XLA fuses (gslm_tpu/ops/rasterize_tiled.py: _cell_masks). The port's
// plain version (ops/rasterize_tiled.py: _cell_masks_plain) is a Python
// loop over the 64 cells, ~110 elementwise PyTorch launches a cell over all
// P Gaussians: ~7,000 launches a rendered view. This kernel is one.
//
// What it computes, per Gaussian: its tile rect [x0, x1) x [y0, y1) (grid
// units of tile_px pixels; y0 wrapped into its view, y0 mod view_rows) is
// cut into an 8x8 grid of cells of cw x ch units (cw = ceil(w / 8), w the
// rect's width clamped to >= 1). A cell of nx x ny units survives iff
// nx > 0, ny > 0 and the exact minimum q of the conic quadratic over the
// cell's pixel rectangle satisfies q * (1 - 1e-4) <= s2 + 1e-3, with
// s2 = 2 log(max(opacity * 255, 1e-12)): the alpha >= 1/255 level set. q
// is 0 when the mean lies in the rectangle, else the least of the four
// edges' clamped parabolas (ops/projection.py: quad_min_rect). Outputs, five
// (P,) int32 arrays: three packed mask words (cells 0-21, 22-43, 44-63 of
// b = 8 * cell row + cell column), (ch << cwb) | cw, and nlive, the summed
// nx * ny of the surviving cells (0 where tile_count is 0).
//
// Exactness: the outputs equal the plain version's on CUDA tensors bit for
// bit. Every float32 product, sum and difference is a separate IEEE
// operation in the plain version's order (__fmul_rn, __fadd_rn, __fsub_rn:
// never contracted to an FMA), the reciprocal and logf are IEEE (no
// --use_fast_math), the int-to-float conversions round to nearest, and the
// clamps and minima propagate NaN as torch.clamp and torch.minimum do
// (fminf / fmaxf alone would drop it). A NaN q fails the test, as there.
//
// Bound on this card: bytes, barely. One pass reads 44 B of each
// Gaussian's row and writes 20 B, 64 B x P: 0.06 ms at 3.1 M Gaussians and
// 3.35 TB/s. The cells are ~70 float32 operations each, and a cell with
// nx == 0 or ny == 0 is never kept, so the walk stops at min(8, ceil(w /
// cw)) columns and min(8, ceil(h / ch)) rows: most rects are a few tiles,
// so most threads evaluate a handful of cells. A thread per Gaussian in a
// grid-stride loop; the five outputs are coalesced stores, with no atomics
// and nothing read back by the host.
#include <cuda_runtime.h>

namespace {

constexpr int G_THREADS = 256;
constexpr int G_MAX_BLOCKS = 4096;

// The five (n,) int32 outputs, each its own allocation: the caller frees
// each as it is done with it, as it would the plain version's.
struct Outs {
  int *w0, *w1, *w2, *cwch, *nlive;
};

// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi) with tensor bounds: a NaN among them wins.
__device__ __forceinline__ float clamp_range(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// torch.minimum: NaN if either is.
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// a dx^2 + 2 b dx dy + c dy^2 as ((a dx) dx + ((2b) dx) dy) + (c dy) dy.
__device__ __forceinline__ float quad(float a, float b2, float c, float dx,
                                      float dy) {
  const float t1 = __fmul_rn(__fmul_rn(a, dx), dx);
  const float t2 = __fmul_rn(__fmul_rn(b2, dx), dy);
  const float t3 = __fmul_rn(__fmul_rn(c, dy), dy);
  return __fadd_rn(__fadd_rn(t1, t2), t3);
}

__global__ void __launch_bounds__(G_THREADS)
cell_masks_kernel(const int* __restrict__ rect_min,
                  const int* __restrict__ rect_max,
                  const float* __restrict__ mean2d,
                  const float* __restrict__ conic,
                  const float* __restrict__ opacity,
                  const int* __restrict__ tile_count, int n, int view_rows,
                  int cwb, float ftile, Outs out) {
  const float keep_scale = (float)(1.0 - 1e-4);
  const float keep_slack = (float)1e-3;
  const float tiny = (float)1e-12;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int x0 = __ldg(rect_min + 2 * i);
    const int y0 = __ldg(rect_min + 2 * i + 1);
    const int x1 = __ldg(rect_max + 2 * i);
    const int y1 = __ldg(rect_max + 2 * i + 1);
    const float mx = __ldg(mean2d + 2 * i);
    const float my = __ldg(mean2d + 2 * i + 1);
    const float a = clamp_min(__ldg(conic + 3 * i), tiny);
    const float b = __ldg(conic + 3 * i + 1);
    const float c = clamp_min(__ldg(conic + 3 * i + 2), tiny);
    const float op = __ldg(opacity + i);
    const int tc = __ldg(tile_count + i);

    const int w = max(x1 - x0, 1);
    const int h = max(y1 - y0, 1);
    const int cw = (w + 7) >> 3;
    const int ch = (h + 7) >> 3;
    int y0loc = y0 % view_rows;            // torch.remainder: a floor mod
    if (y0loc != 0 && ((y0loc < 0) != (view_rows < 0))) y0loc += view_rows;
    // 1 / clamp(a, 1e-12): reciprocal, then * 1.0 (exact)
    const float ia = __fdiv_rn(1.0f, a);
    const float ic = __fdiv_rn(1.0f, c);
    const float nb = -b;
    const float b2 = __fmul_rn(2.0f, b);
    const float s2 = __fmul_rn(
        2.0f, logf(clamp_min(__fmul_rn(op, 255.0f), tiny)));
    const float limit = __fadd_rn(s2, keep_slack);

    unsigned w0 = 0u, w1 = 0u, w2 = 0u;
    int nlive = 0;
    for (int cy = 0; cy < 8; ++cy) {
      const int ay0 = cy * ch;
      if (ay0 >= h) break;                 // ny == 0 from here on
      const int ay1 = min(ay0 + ch, h);
      const float dy0 = __fsub_rn(
          __fmul_rn(__int2float_rn(y0loc + ay0), ftile), my);
      const float dy1 = __fsub_rn(
          __fsub_rn(__fmul_rn(__int2float_rn(y0loc + ay1), ftile), 1.0f), my);
      for (int cx = 0; cx < 8; ++cx) {
        const int ax0 = cx * cw;
        if (ax0 >= w) break;               // nx == 0 from here on
        const int ax1 = min(ax0 + cw, w);
        const float dx0 = __fsub_rn(
            __fmul_rn(__int2float_rn(x0 + ax0), ftile), mx);
        const float dx1 = __fsub_rn(
            __fsub_rn(__fmul_rn(__int2float_rn(x0 + ax1), ftile), 1.0f), mx);
        float qmin = 0.0f;
        if (!(dx0 <= 0.0f && 0.0f <= dx1 && dy0 <= 0.0f && 0.0f <= dy1)) {
          // x fixed at an edge: y at the clamped vertex, and likewise
          const float ex0 = quad(a, b2, c, dx0, clamp_range(
              __fmul_rn(__fmul_rn(nb, dx0), ic), dy0, dy1));
          const float ex1 = quad(a, b2, c, dx1, clamp_range(
              __fmul_rn(__fmul_rn(nb, dx1), ic), dy0, dy1));
          const float ey0 = quad(a, b2, c, clamp_range(
              __fmul_rn(__fmul_rn(nb, dy0), ia), dx0, dx1), dy0);
          const float ey1 = quad(a, b2, c, clamp_range(
              __fmul_rn(__fmul_rn(nb, dy1), ia), dx0, dx1), dy1);
          qmin = minimum(minimum(ex0, ex1), minimum(ey0, ey1));
        }
        if (__fmul_rn(qmin, keep_scale) <= limit) {
          const int bit = cy * 8 + cx;
          if (bit < 22) w0 |= 1u << bit;
          else if (bit < 44) w1 |= 1u << (bit - 22);
          else w2 |= 1u << (bit - 44);
          nlive += (ax1 - ax0) * (ay1 - ay0);
        }
      }
    }
    out.w0[i] = (int)w0;
    out.w1[i] = (int)w1;
    out.w2[i] = (int)w2;
    out.cwch[i] = (ch << cwb) | cw;
    out.nlive[i] = tc > 0 ? nlive : 0;
  }
}

}  // namespace

// rect_min, rect_max: (n, 2) int32; mean2d: (n, 2), conic: (n, 3),
// opacity: (n,) float32; tile_count: (n,) int32, all contiguous.
// view_rows: tile rows per view (> 0); cwb: the bits of cw in the packed
// cell size; tile_px: pixels per grid unit. w0, w1, w2, cwch, nlive: (n,)
// int32 outputs (the three words, the packed cell size, nlive). Launches
// on ``stream``; returns the first CUDA error (cudaErrorInvalidValue for a
// bad argument), or 0.
extern "C" int cell_masks(const int* rect_min, const int* rect_max,
                          const float* mean2d, const float* conic,
                          const float* opacity, const int* tile_count, int n,
                          int view_rows, int cwb, int tile_px, int* w0,
                          int* w1, int* w2, int* cwch, int* nlive,
                          cudaStream_t stream) {
  if (n < 0 || n > 0x7fffffff / 3 || view_rows <= 0 || cwb < 0 || cwb > 30 ||
      tile_px <= 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + G_THREADS - 1) / G_THREADS < G_MAX_BLOCKS
                         ? (n + G_THREADS - 1) / G_THREADS
                         : G_MAX_BLOCKS;
  cell_masks_kernel<<<blocks, G_THREADS, 0, stream>>>(
      rect_min, rect_max, mean2d, conic, opacity, tile_count, n, view_rows,
      cwb, (float)tile_px, Outs{w0, w1, w2, cwch, nlive});
  return (int)cudaGetLastError();
}

// out[0..2]: registers per thread, static shared memory per block (bytes)
// and resident 256-thread blocks per SM. Returns the first CUDA error, or 0.
extern "C" int cell_masks_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, cell_masks_kernel);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], cell_masks_kernel, G_THREADS, 0);
}
