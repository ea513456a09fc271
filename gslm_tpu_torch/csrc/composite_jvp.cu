// Kernel E: fused forward + tangent tile compositor (the JVP of kernel A).
//
// Replaces the Pallas TPU JVP compositor of gslm_tpu:
// _jvp_call / _make_tile_jvp_kernel (gslm_tpu/ops/rasterize_pallas_jvp.py).
//
// What it computes: kernel A's composite of every 16x16 tile AND its
// directional derivative along a tangent of the records, in one walk. The
// records are (L, 10) float32 [mean2d 2, conic 3, opacity, rgb 3, invdepth]
// and their tangents the same layout. Per contributing (record, pixel)
// pair, with dx = mean_x - px, dy = mean_y - py and the primal as in A:
//   pow_dot = -(c0 dx + c1 dy) mx_dot - (c2 dy + c1 dx) my_dot
//             - 0.5 dx^2 c0_dot - dx dy c1_dot - 0.5 dy^2 c2_dot
//   a_dot   = o_dot exp(power) + a_raw pow_dot   (the 0.99 clip is straight
//             through; the power <= 0 and 1/255 gates are constants)
//   T_dot   = T lsum_dot, lsum_dot the running sum of -a_dot / (1 - a)
//             (the tangent of the log-transmittance sum)
//   w_dot   = a_dot T + a T_dot;  acc_dot += w_dot c + w c_dot
// over r, g, b and invdepth. At the first record whose T_after < 1e-4,
// t_final freezes at its T_before and t_final_dot at its T_before_dot.
//
// Outputs: per tile the primal (7, 256) float32, rows as kernel A writes
// them [r, g, b, invdepth, t_final, exit lsum, exit position], and the
// tangent (5, 256) [r, g, b, invdepth, t_final], each pixel at its
// row-major index.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// walked, as kernel A, with 41 fp32 instructions and one reciprocal per
// accumulated pair where A has 5 (sm_90a SASS); the records and tangents
// read are 80 B per record per tile.
//
// Design: kernel A's (composite_fwd.cu), with the tangent beside it. One
// block per tile, one thread per pixel (256 threads), warps on A's 8x4
// patches; a chunk of 256 records is copied flat and repacked into A's
// padded 48-B rows, each with A's patch mask (composite_patch.cuh; the rect
// gate folded in as mask 0), and its 256 tangents copied flat beside it;
// a warp walks only the records whose bit it has (a ballot over 32
// records, then the set bits in order), with pair_alpha's gates written
// out as A has them; the colours and the tangent are read only past the
// 1/255 gate and the T check; the block stops at the first chunk boundary
// where every pixel has exited. Rows 0-6 are kernel A's bits: the same
// records contribute to a pixel, in the same order, through the same
// operations.
//
// MASK = false is the guard, used by the tests and chip_smoke.py only,
// never by the render path: no patch mask, every record through
// pair_alpha (composite_common.cuh), the rect gate alone skipping records.
// Kernel A's rows and the masked E's primal are held equal to its primal
// bit for bit, which checks that A's mask is sound and that A's written-out
// copy of pair_alpha's gates is right.
#include <cuda_runtime.h>

#include "composite_patch.cuh"

namespace {

using namespace gslm;

constexpr int E_MIN_BLOCKS = 5;   // resident blocks per SM asked of ptxas

// The staged chunk: A's 48-B rows and patch masks, the tangents as copied.
struct JvpChunk {
  float4 rec[PIX][3];       // [mx my c0 c1] [c2 o - -] [r g b invdepth]
  float tng[PIX * NF];      // the tangents, record-major
  unsigned char mask[PIX];  // bit w: patch w may take the record
};

template <bool RECT, bool MASK>
__global__ void __launch_bounds__(PIX, E_MIN_BLOCKS)
composite_jvp_kernel(const float* __restrict__ records,
                     const float* __restrict__ tangents,
                     const int* __restrict__ rects,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx, int view_rows,
                     float* __restrict__ out, float* __restrict__ out_dot) {
  __shared__ __align__(16) float flat[PIX * NF];  // the records as copied
  __shared__ __align__(16) JvpChunk ch;
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

  // T is t_final at the end: the exit leaves T at its T_before, and
  // lsum_dot at its lsum_dot, so t_final_dot = T lsum_dot
  float lsum = 0.f, T = 1.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f;
  float lsum_dot = 0.f;
  float dot_r = 0.f, dot_g = 0.f, dot_b = 0.f, dot_d = 0.f;
  bool done = false;
  int exit_pos = count;

  for (int base = 0; base < count; base += PIX) {
    // barrier: the previous chunk is consumed before it is overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(PIX, count - base);
    const size_t off = (size_t)(start + base) * NF;
    for (int j = tid; j < n * NF; j += PIX) {
      flat[j] = records[off + j];
      ch.tng[j] = tangents[off + j];
    }
    __syncthreads();
    if (tid < n) {
      const float2* f = reinterpret_cast<const float2*>(flat + tid * NF);
      const float2 f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4];
      const float4 geo = make_float4(f0.x, f0.y, f1.x, f1.y);
      ch.rec[tid][0] = geo;
      ch.rec[tid][1] = make_float4(f2.x, f2.y, 0.f, 0.f);
      ch.rec[tid][2] = make_float4(f3.x, f3.y, f4.x, f4.y);
      const bool in_rect =
          !RECT || rect_gate(rects + (size_t)(start + base + tid) * 4, txc,
                             tyc);
      ch.mask[tid] = !in_rect ? (unsigned char)0
                     : MASK   ? (unsigned char)patch_mask(geo, f2.x, f2.y,
                                                          txc, tyc)
                              : (unsigned char)0xff;
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
        Pair p;
        if (MASK) {
          // pair_alpha's alpha and gates, written out as kernel A has them
          const float power = splat_power(r, px, py, p.dx, p.dy);
          if (!(power <= 0.f)) continue;
          p.expp = expf(power);
          p.a_raw = r[5] * p.expp;
          p.a = fminf(p.a_raw, ALPHA_MAX);
          if (!(p.a >= ALPHA_MIN)) continue;
        } else if (!pair_alpha(r, px, py, p)) {
          continue;
        }
        const float a = p.a;
        const float l_after = lsum + log1pf(-a);
        const float t_after = expf(l_after);
        if (t_after < T_EPS) {  // T_before >= 1e-4 holds here by induction
          exit_pos = base + i;
          done = true;
          break;
        }
        const float T_dot = T * lsum_dot;
        const float4 col = ch.rec[i][2];
        const float2* dv = reinterpret_cast<const float2*>(ch.tng + i * NF);
        const float2 d0 = dv[0], d1 = dv[1], d2 = dv[2], d3 = dv[3],
                     d4 = dv[4];
        const float dx = p.dx, dy = p.dy;
        const float pow_dot = -(r[2] * dx + r[3] * dy) * d0.x
                              - (r[4] * dy + r[3] * dx) * d0.y
                              - 0.5f * dx * dx * d1.x - dx * dy * d1.y
                              - 0.5f * dy * dy * d2.x;
        const float a_dot = d2.y * p.expp + p.a_raw * pow_dot;
        const float w = a * T;
        const float w_dot = a_dot * T + a * T_dot;
        acc_r += w * col.x;
        acc_g += w * col.y;
        acc_b += w * col.z;
        acc_d += w * col.w;
        dot_r += w_dot * col.x + w * d3.x;
        dot_g += w_dot * col.y + w * d3.y;
        dot_b += w_dot * col.z + w * d4.x;
        dot_d += w_dot * col.w + w * d4.y;
        lsum = l_after;
        T = t_after;
        lsum_dot -= a_dot / (1.f - a);
      }
    }
  }

  const int pix = y * TILE + x;
  float* o = out + (size_t)t * OUT_ROWS * PIX + pix;
  o[0 * PIX] = acc_r;
  o[1 * PIX] = acc_g;
  o[2 * PIX] = acc_b;
  o[3 * PIX] = acc_d;
  o[4 * PIX] = T;
  o[5 * PIX] = lsum;
  o[6 * PIX] = (float)exit_pos;  // exact: segments hold far fewer than 2^24
  float* od = out_dot + (size_t)t * IMG_ROWS * PIX + pix;
  od[0 * PIX] = dot_r;
  od[1 * PIX] = dot_g;
  od[2 * PIX] = dot_b;
  od[3 * PIX] = dot_d;
  od[4 * PIX] = T * lsum_dot;
}

template <bool MASK>
int launch(const float* records, const float* tangents, const int* rects,
           const int* starts, const int* counts, int ntiles, int ntx,
           int view_rows, float* out, float* out_dot, cudaStream_t stream) {
  if (ntiles > 0) {
    if (rects) {
      composite_jvp_kernel<true, MASK><<<ntiles, PIX, 0, stream>>>(
          records, tangents, rects, starts, counts, ntx, view_rows, out,
          out_dot);
    } else {
      composite_jvp_kernel<false, MASK><<<ntiles, PIX, 0, stream>>>(
          records, tangents, rects, starts, counts, ntx, view_rows, out,
          out_dot);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// records, tangents (L, 10) f32, rects (L, 4) i32 or null (bucket 1),
// starts/counts (ntiles,) i32 → out (ntiles, 7, 256) f32 (kernel A's rows),
// out_dot (ntiles, 5, 256) f32. Launches on ``stream``; returns
// cudaGetLastError.
extern "C" int composite_jvp(const float* records, const float* tangents,
                             const int* rects, const int* starts,
                             const int* counts, int ntiles, int ntx,
                             int view_rows, float* out, float* out_dot,
                             cudaStream_t stream) {
  return launch<true>(records, tangents, rects, starts, counts, ntiles, ntx,
                      view_rows, out, out_dot, stream);
}

// The same through E<MASK=false>, the guard (tests and chip_smoke.py).
extern "C" int composite_jvp_unmasked(const float* records,
                                      const float* tangents, const int* rects,
                                      const int* starts, const int* counts,
                                      int ntiles, int ntx, int view_rows,
                                      float* out, float* out_dot,
                                      cudaStream_t stream) {
  return launch<false>(records, tangents, rects, starts, counts, ntiles, ntx,
                       view_rows, out, out_dot, stream);
}

// out[0..11]: registers per thread, static shared memory per block (bytes)
// and resident 256-thread blocks per SM of E (bucket 1), E<RECT>, then of
// E<MASK=false> and E<RECT, MASK=false>. Returns the first CUDA error, or 0.
extern "C" int composite_jvp_attrs(int* out) {
  const void* fns[4] = {(const void*)composite_jvp_kernel<false, true>,
                        (const void*)composite_jvp_kernel<true, true>,
                        (const void*)composite_jvp_kernel<false, false>,
                        (const void*)composite_jvp_kernel<true, false>};
  for (int k = 0; k < 4; ++k) {
    cudaFuncAttributes a;
    cudaError_t rc = cudaFuncGetAttributes(&a, fns[k]);
    if (rc != cudaSuccess) return (int)rc;
    out[3 * k] = a.numRegs;
    out[3 * k + 1] = (int)a.sharedSizeBytes;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3 * k + 2],
                                                       fns[k], PIX, 0);
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}
