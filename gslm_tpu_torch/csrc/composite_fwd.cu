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
// exit lsum, exit position], each pixel at its row-major index in the tile,
// and the number of records the block walked (what bounds its work). Rows
// 5-6 are the exit state kernels C and D start their reverse walk from (the
// Pallas forward saves the same in its spare rows 5-6): the
// log-transmittance sum at the exit, and the in-segment index of the first
// record that fails T_after >= 1e-4, or count when none fails.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// evaluated; the records read are 40 B per record per tile, tiny beside
// that. Per pair (sm_90a SASS): 9 FFMA/FADD/FMUL for the power and its gate;
// past it 7 more and one MUFU.EX2 (expf); past the 1/255 gate 24 more
// (log1pf is 16 and a predicated FFMA) and one MUFU.EX2; 5 more to
// accumulate. Beside them a pair costs loads, compares, branches and loop
// work, and a warp issues a step for all 32 lanes when any lane takes it.
//
// Design. One block per tile, one thread per pixel (256 threads); the
// block stops at the first chunk boundary where every pixel has exited
// (__syncthreads_count), so ``walked`` counts the records of the chunks
// staged. What the design does about the bound:
// - Warps own 8x4 pixel patches (patch_pixel, composite_patch.cuh): the
//   most compact 32-pixel footprint a tile offers, so a splat's edge leaves
//   fewer warps with lanes that contribute beside lanes that idle than
//   16x2 strips did.
// - A per-record patch mask, computed once per staged record by the thread
//   that repacks it: bit w is clear only where the record's alpha provably
//   stays below 1/255 on every pixel of patch w, and a warp walks only the
//   records whose bit it has (a ballot over 32 records at a time, then the
//   set bits in order), so the branch is warp-uniform and a skipped record
//   is never read. The test is the tile front end's exact one
//   (quad_min_rect, rasterize_tiled._cell_masks) over the patch's pixel
//   rectangle: q = c0 dx^2 + 2 c1 dx dy + c2 dy^2, the bit kept unless
//   qmin (1 - 1e-4) - 4e-6 S > s2 + 1e-3, s2 = 2 ln(255 o).
// - Records staged for vector loads: the chunk is copied as one flat
//   coalesced range and repacked in shared memory, padded to 12 floats:
//   the six fields every pair reads as a float4 and a float2 of one 48-B
//   row, the four read only past the 1/255 gate (rgb, invdepth) as a float4
//   loaded only there (one address per record: separate hot and cold
//   arrays ran slower).
// - At most 40 registers, so 6 blocks (48 warps) are resident per SM.
//
// Why the outputs are the unmasked walk's (the guard E<MASK=false>'s
// primal, composite_jvp.cu) bit for bit:
// a pair whose bit is clear fails a >= 1/255, and such a pair changes
// nothing (no lsum, T, accumulator or exit position), while every other
// pair runs pair_alpha's operations (splat_power, then its two gates
// written out) and the accumulation, in record order per pixel. Why the
// mask is sound for that: composite_patch.cuh, which kernels C and E share.
//
// Bucket mode (a non-null ``rects``, the RECT instantiation): a tile walks
// its parent bucket's segment, and a record counts for it only inside the
// record's own tile rect (rect_gate, composite_common.cuh). The gate is
// folded into the mask: a gated record gets mask 0. The exit position is in
// bucket-segment coordinates.
#include <cuda_runtime.h>

#include "composite_patch.cuh"

namespace {

using namespace gslm;

// The staged chunk: per record a 48-B row, the fields every pair reads
// (hot) then those read past the 1/255 gate (cold), and its patch mask.
struct Chunk {
  float4 rec[PIX][3];  // [mx my c0 c1] [c2 o - -] [r g b invdepth]
  unsigned char mask[PIX];  // bit w: patch w may take the record
};

// At most 40 registers a thread, so 6 blocks fit on an SM.
template <bool RECT>
__global__ void __launch_bounds__(PIX, 6)
composite_fwd_kernel(const float* __restrict__ records,
                     const int* __restrict__ rects,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx, int view_rows,
                     float* __restrict__ out, int* __restrict__ walked) {
  __shared__ __align__(16) float flat[PIX * NF];  // the chunk as copied
  __shared__ Chunk ch;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / WARP, lane = tid % WARP;
  int x, y;
  patch_pixel(warp, lane, x, y);
  int txc, tyc;
  tile_origin(t, ntx, view_rows, txc, tyc);
  const float px = (float)(txc + x), py = (float)(tyc + y);
  const int start = starts[t];
  const int count = counts[t];

  // T is t_final at the end: the exit leaves T at its T_before
  float lsum = 0.f, T = 1.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f;
  bool done = false;
  int exit_pos = count;

  int base = 0;
  for (; base < count; base += PIX) {
    // barrier: the previous chunk is consumed before it is overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(PIX, count - base);
    // one flat coalesced copy ...
    const float* src = records + (size_t)(start + base) * NF;
    for (int j = tid; j < n * NF; j += PIX) flat[j] = src[j];
    __syncthreads();
    // ... then each thread repacks one record (40 B: 8-B aligned) and
    // computes its patch mask (0 outside the rect gate)
    if (tid < n) {
      const float2* f = reinterpret_cast<const float2*>(flat + tid * NF);
      const float2 f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4];
      const float4 geo = make_float4(f0.x, f0.y, f1.x, f1.y);
      ch.rec[tid][0] = geo;
      ch.rec[tid][1] = make_float4(f2.x, f2.y, 0.f, 0.f);
      ch.rec[tid][2] = make_float4(f3.x, f3.y, f4.x, f4.y);
      ch.mask[tid] =
          !RECT || rect_gate(rects + (size_t)(start + base + tid) * 4, txc,
                             tyc)
              ? (unsigned char)patch_mask(geo, f2.x, f2.y, txc, tyc)
              : (unsigned char)0;
    }
    __syncthreads();
    for (int g = 0; g < n; g += WARP) {
      if (__all_sync(FULL, done)) break;
      const int j = g + lane;
      unsigned todo = __ballot_sync(FULL, j < n && (ch.mask[j] >> warp) & 1u);
      if (done) todo = 0u;
      for (; todo != 0u; todo &= todo - 1u) {
        const int i = g + __ffs(todo) - 1;
        const float4 geo = ch.rec[i][0];
        const float2 co = make_float2(ch.rec[i][1].x, ch.rec[i][1].y);
        const float r[6] = {geo.x, geo.y, geo.z, geo.w, co.x, co.y};
        // pair_alpha's alpha and gates, written out: the same operations
        // (kernel E's primal, which calls pair_alpha, is checked equal bit
        // for bit), but a branch at each gate instead of a bool the loop
        // re-tests (composite_common.cuh)
        float dx, dy;
        const float power = splat_power(r, px, py, dx, dy);
        if (!(power <= 0.f)) continue;
        const float a = fminf(r[5] * expf(power), ALPHA_MAX);
        if (!(a >= ALPHA_MIN)) continue;
        const float l_after = lsum + log1pf(-a);
        const float t_after = expf(l_after);
        if (t_after < T_EPS) {  // T_before >= 1e-4 holds here by induction
          exit_pos = base + i;
          done = true;
          break;
        }
        const float4 col = ch.rec[i][2];
        const float w = a * T;
        acc_r += w * col.x;
        acc_g += w * col.y;
        acc_b += w * col.z;
        acc_d += w * col.w;
        lsum = l_after;
        T = t_after;
      }
    }
  }

  float* o = out + (size_t)t * OUT_ROWS * PIX + y * TILE + x;
  o[0 * PIX] = acc_r;
  o[1 * PIX] = acc_g;
  o[2 * PIX] = acc_b;
  o[3 * PIX] = acc_d;
  o[4 * PIX] = T;
  o[5 * PIX] = lsum;
  o[6 * PIX] = (float)exit_pos;  // exact: segments hold far fewer than 2^24
  // every chunk up to the one the block stopped at was staged
  if (tid == 0) walked[t] = min(base, count);
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

#include "composite_fwd_attrs.cuh"
