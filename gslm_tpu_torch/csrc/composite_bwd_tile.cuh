// The reverse walk of one tile, kernel C's body (composite_bwd.cu), shared
// with kernel D (composite_bucket_bwd.cu), which runs it once per member
// tile of a bucket. One block per tile, one thread per pixel (256 threads).
//
// What it computes, per record of the tile's segment: the sum over the
// tile's 256 pixels of the 10 per-pair cotangent terms. Each pixel's
// records are walked in REVERSE from its exit position e - 1 down to 0
// (kernel A's exit state: the log-transmittance sum at the exit and e),
// recovering T_before of each contributing record by subtracting
// log1pf(-a) from the carried sum, with the suffix accumulator S_i =
// sum_{j > i, contributing} dw_j w_j + g_T t_final, started at
// g_T * exp(lsum_exit): t_final is exactly that transmittance, whether the
// pixel exited (the first failing record's T_before) or not (T_end). For a
// contributing record (a >= 1/255, before the pixel's exit): w = a T, dw =
// rgb . g_rgb (+ invdepth g_inv with depth_grad), da = dw T - S_i / (1 - a),
// dpow = da * a_raw (the 0.99 clip is straight through), and the 10 terms
// are mean2d (2): dpow * dpower/dmean, conic (3): dpow * dpower/dconic,
// opacity: da * exp(power), rgb (3): w * g_rgb, invdepth: w * g_inv.
//
// How it walks (the bound: fp32 and SFU issue over the pairs before each
// pixel's exit):
// - Warps own kernel A's 8x4 patches (composite_patch.cuh); each thread
//   reads its gtiles and exit state at its pixel's row-major index.
// - Records are staged in chunks of CH, last chunk first. Kernel A's patch
//   mask is recomputed as the chunk is staged, one thread per (record,
//   patch), the record's 8 bits gathered by a ballot: a warp walks only the
//   records whose bit it has (a ballot over 32 records, then the set bits
//   from the highest down), so a pair whose alpha provably stays below
//   1/255 on the whole patch, which adds nothing to S, lsum or the terms,
//   is never evaluated. With the rect gate (Out::RECT, bucket mode: a
//   record counts for the tile only inside its own tile rect), the rect is
//   tested first and a record outside it gets mask 0 without a patch test.
// - Each warp starts at the largest exit position among its own 32 lanes,
//   not the block's: the records between the two are skipped without
//   evaluation. The block stages from the block's largest down, and every
//   warp reaches every barrier.
// - The per-record sum pays for the work done: a (record, warp) step in
//   which no lane contributes writes nothing; any other takes a
//   reduce-scatter over the warp (warp_sum_fields: 12 shuffles, where a
//   butterfly per field takes 50), after which 10 lanes store the 10 sums
//   in one instruction. A per-(warp, record) bit says which warps wrote a
//   record's partials; the 8 warps' partials are then summed in warp order,
//   the unwritten ones skipped (each exactly zero), and handed to Out.
// - DEPTH (depth_grad) is a template parameter: without it the invdepth
//   cotangent is neither loaded nor computed (its partials are exact
//   zeros).
// - MASK=false is the guard: every patch bit set (inside the rect gate).
//   Skipping a pair whose bit is clear changes nothing, so a kernel's
//   output equals its guard's bit for bit, an exact check of patch_bit.
//
// No atomics on floats: the sums run in a fixed order, so the same inputs
// give the same bits on every run.
#pragma once

#include "composite_patch.cuh"

namespace gslm {

constexpr int CH = 64;   // records per staged chunk

// The staged chunk and the warps' partial sums of it.
struct BwdShared {
  float4 rec[CH][3];           // [mx my c0 c1] [c2 o - -] [r g b invdepth]
  float part[WARPS][CH][NF];   // each warp's sum over its patch, per record
  unsigned wrote[WARPS][CH / WARP];  // bit j: warp w wrote part[w][j]
  unsigned char mask[CH];      // bit w: patch w may take the record
};

// The sum over the warp's 32 lanes of each of v[0..9], reduce-scatter: the
// lanes split the fields in halves at each xor level (16: 5 fields each, 8:
// 3 or 2, 4: 2 or 1, 2: 1, then 1), so 5 + 3 + 2 + 1 + 1 = 12 shuffles.
// Returns the sum of field sum_field(lane) (valid where sum_writer(lane)
// or its xor-1 partner is). Per field it is the xor butterfly 16, 8, 4, 2,
// 1 of the lanes' values, (own + partner) at each level.
__device__ __forceinline__ float warp_sum_fields(const float (&v)[NF],
                                                 int lane) {
  const bool b1 = lane & 16, b2 = lane & 8, b3 = lane & 4, b4 = lane & 2;
  float u[6], w[4], x[2];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float send = b1 ? v[k] : v[5 + k];
    u[k] = (b1 ? v[5 + k] : v[k]) + __shfl_xor_sync(FULL, send, 16);
  }
  u[5] = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float send = b2 ? u[k] : u[3 + k];
    w[k] = (b2 ? u[3 + k] : u[k]) + __shfl_xor_sync(FULL, send, 8);
  }
  w[3] = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = b3 ? w[k] : w[2 + k];
    x[k] = (b3 ? w[2 + k] : w[k]) + __shfl_xor_sync(FULL, send, 4);
  }
  const float y = (b4 ? x[1] : x[0]) + __shfl_xor_sync(FULL, b4 ? x[0] : x[1],
                                                       2);
  return y + __shfl_xor_sync(FULL, y, 1);
}

// The field whose sum warp_sum_fields leaves at ``lane``, and whether the
// lane stores it (one lane of each xor-1 pair, where the field exists).
__device__ __forceinline__ int sum_field(int lane) {
  return 5 * ((lane >> 4) & 1) + 3 * ((lane >> 3) & 1) + 2 * ((lane >> 2) & 1)
         + ((lane >> 1) & 1);
}
__device__ __forceinline__ bool sum_writer(int lane) {
  const int local = sum_field(lane) - 5 * ((lane >> 4) & 1);
  return !(lane & 1) && local < ((lane & 8) ? 5 : 3);
}

// Walks tile ``t`` (pixel origin from tile_origin) over segment ``sid``,
// records [start, start + count) of ``records`` (and, with Out::RECT, of
// ``rects``), start = starts[sid] and count = counts[sid], and hands the
// per-record sums to rows = out.at(start), the segment's share of Out:
// - rows.zero_past(n_eff, count, tid): the records [n_eff, count) of the
//   segment lie at or past every pixel's exit, so no pixel reached them
//   (the block's threads share the rows, tid first);
// - rows.store(j, e, f, s, wrote): field f of the sum s of record j (its
//   position in the segment; element e = j * NF + f), ``wrote`` whether
//   any warp wrote a partial of it (where none did, s is exactly zero).
// Every thread of the block calls it; it ends after its last barrier.
template <bool DEPTH, bool MASK, class Out>
__device__ __forceinline__ void bwd_tile_walk(
    const float* __restrict__ records, const int* __restrict__ rects,
    const int* __restrict__ starts, const int* __restrict__ counts, int sid,
    int t, int ntx, int view_rows, const float* __restrict__ gtiles,
    const float* __restrict__ state, const Out& out) {
  __shared__ BwdShared sm;
  __shared__ int s_n_eff;
  const int tid = threadIdx.x;
  const int warp = tid / WARP, lane = tid % WARP;
  int x, y;
  patch_pixel(warp, lane, x, y);
  int txc, tyc;
  tile_origin(t, ntx, view_rows, txc, tyc);
  const float px = (float)(txc + x), py = (float)(tyc + y);
  const int start = starts[sid];
  const int count = counts[sid];

  const float* g = gtiles + (size_t)t * IMG_ROWS * PIX + y * TILE + x;
  const float g_r = g[0 * PIX], g_g = g[1 * PIX], g_b = g[2 * PIX];
  const float g_i = DEPTH ? g[3 * PIX] : 0.f;
  const float* st = state + (size_t)t * 2 * PIX + y * TILE + x;
  float lsum = st[0];
  float S = g[4 * PIX] * expf(lsum);
  // clamped to the segment, so no state can address rows outside it
  const int exit_pos = min(max((int)st[PIX], 0), count);
  const int warp_eff = __reduce_max_sync(FULL, exit_pos);

  if (tid == 0) s_n_eff = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&s_n_eff, warp_eff);
  __syncthreads();
  const int n_eff = s_n_eff;   // records any pixel of the tile reached

  const float* seg = records + (size_t)start * NF;
  const Out rows = out.at(start);
  rows.zero_past(n_eff, count, tid);
  const int field = sum_field(lane);
  const bool writer = sum_writer(lane);

  for (int lo = n_eff > 0 ? ((n_eff - 1) / CH) * CH : -1; lo >= 0;
       lo -= CH) {
    const int n = min(CH, n_eff - lo);
    // stage: thread (record j, patch p) loads the record, one of the
    // first three repacks it, each tests its patch (inside the rect
    // gate); a ballot gathers the record's 8 bits
    for (int j0 = 0; j0 < n; j0 += PIX / WARPS) {
      const int j = j0 + tid / WARPS, p = tid % WARPS;
      bool keep = false;
      if (j < n) {
        const float2* f =
            reinterpret_cast<const float2*>(seg + (size_t)(lo + j) * NF);
        const float2 f0 = f[0], f1 = f[1], f2 = f[2];
        const float4 geo = make_float4(f0.x, f0.y, f1.x, f1.y);
        if (p == 0) {
          sm.rec[j][0] = geo;
        } else if (p == 1) {
          sm.rec[j][1] = make_float4(f2.x, f2.y, 0.f, 0.f);
        } else if (p == 2) {
          const float2 f3 = f[3], f4 = f[4];
          sm.rec[j][2] = make_float4(f3.x, f3.y, f4.x, f4.y);
        }
        keep = (!Out::RECT
                || rect_gate(rects + (size_t)(start + lo + j) * 4, txc, tyc))
               && (!MASK || patch_bit(geo, f2.x, f2.y, txc, tyc, p));
      }
      const unsigned bits = __ballot_sync(FULL, keep);
      if (j < n && p == 0) {
        sm.mask[j] = (unsigned char)(bits >> (lane & ~(WARPS - 1)));
      }
    }
    __syncthreads();   // chunk staged; the previous chunk's sums are read

    // this warp's records of the chunk: below its own largest exit (every
    // group's bits are written, the empty ones too)
    const int lim = min(n, warp_eff - lo);
    for (int g0 = ((n - 1) / WARP) * WARP; g0 >= 0; g0 -= WARP) {
      const int jj = g0 + lane;
      unsigned todo =
          __ballot_sync(FULL, jj < lim && ((sm.mask[jj] >> warp) & 1u));
      unsigned wrote = 0u;
      while (todo != 0u) {
        const int k = 31 - __clz(todo);
        todo ^= 1u << k;
        const int i = g0 + k;
        float v[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) v[f] = 0.f;
        bool active = false;
        if (lo + i < exit_pos) {
          const float4 geo = sm.rec[i][0];
          const float2 co = make_float2(sm.rec[i][1].x, sm.rec[i][1].y);
          const float r[6] = {geo.x, geo.y, geo.z, geo.w, co.x, co.y};
          // pair_alpha's alpha and gates, written out as kernel A has them
          float dx, dy;
          const float power = splat_power(r, px, py, dx, dy);
          if (power <= 0.f) {
            const float expp = expf(power);
            const float a_raw = r[5] * expp;
            const float a = fminf(a_raw, ALPHA_MAX);
            if (a >= ALPHA_MIN) {
              active = true;
              const float4 col = sm.rec[i][2];
              const float l_before = fminf(lsum - log1pf(-a), 0.f);
              const float T = expf(l_before);
              const float w = a * T;
              float dw = col.x * g_r + col.y * g_g + col.z * g_b;
              if (DEPTH) dw += col.w * g_i;
              const float da = dw * T - S / (1.f - a);
              S += dw * w;
              const float dpow = da * a_raw;
              v[0] = dpow * -(r[2] * dx + r[3] * dy);
              v[1] = dpow * -(r[4] * dy + r[3] * dx);
              v[2] = dpow * (-0.5f * dx * dx);
              v[3] = dpow * (-dx * dy);
              v[4] = dpow * (-0.5f * dy * dy);
              v[5] = da * expp;
              v[6] = w * g_r;
              v[7] = w * g_g;
              v[8] = w * g_b;
              if (DEPTH) v[9] = w * g_i;
              lsum = l_before;
            }
          }
        }
        if (__ballot_sync(FULL, active) == 0u) continue;
        wrote |= 1u << k;
        const float s = warp_sum_fields(v, lane);
        if (writer) sm.part[warp][i][field] = s;
      }
      if (lane == 0) sm.wrote[warp][g0 / WARP] = wrote;
    }
    __syncthreads();   // every warp's partials are in

    // the 8 warps' partials of each (record, field) in warp order
    for (int e = tid; e < n * NF; e += PIX) {
      const int j = e / NF, f = e - j * NF;
      float s = 0.f;
      bool any = false;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if ((sm.wrote[w][j / WARP] >> (j % WARP)) & 1u) {
          s += sm.part[w][j][f];
          any = true;
        }
      }
      rows.store(lo + j, (size_t)lo * NF + e, f, s, any);
    }
  }
}

}  // namespace gslm
