// Kernel C: backward tile compositor (the VJP of kernel A).
//
// Replaces the Pallas TPU backward compositor of gslm_tpu:
// _bwd_call / _make_tile_bwd_kernel (gslm_tpu/ops/rasterize_pallas.py).
//
// What it computes: the cotangent of every record field, drec (L, 10), from
// the image cotangent gtiles (ntiles, 5, 256) [r, g, b, invdepth, t_final]
// and the exit state kernel A saved per pixel: the log-transmittance sum at
// the exit and the exit position e (the in-segment index of the first
// record that failed T_after >= 1e-4, or count). Each pixel's records are
// walked in REVERSE from e - 1 down to 0, recovering T_before of each
// contributing record by subtracting log1pf(-a) from the carried sum, with
// the suffix accumulator S_i = sum_{j > i, contributing} dw_j w_j
// + g_T t_final, started at g_T * exp(lsum_exit): t_final is exactly that
// transmittance, whether the pixel exited (the first failing record's
// T_before) or not (T_end). For a contributing record (a >= 1/255, before
// the pixel's exit): w = a T, dw = rgb . g_rgb (+ invdepth g_inv with
// depth_grad), da = dw T - S_i / (1 - a), dpow = da * a_raw (the 0.99 clip
// is straight through), and the 10 per-pair terms are mean2d (2): dpow *
// dpower/dmean, conic (3): dpow * dpower/dconic, opacity: da * exp(power),
// rgb (3): w * g_rgb, invdepth: w * g_inv. Each record's terms are summed
// over the tile's 256 pixels. Records at or past a pixel's exit contribute
// nothing for it; rows past every pixel's exit are written as exact zeros,
// so no row of drec is left unwritten.
//
// No atomics on floats: records are duplicated per tile, so every drec row
// belongs to exactly one tile and one block writes it, and the per-record
// sum over the tile's pixels runs in a fixed order (below), so the same
// inputs give the same bits on every run.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// before each pixel's exit (the power gate, then expf, log1pf, expf, a
// reciprocal and about 40 multiply-adds per contributing pair), plus the
// reduction's adds; bytes (records read once, drec written once, gtiles
// and the exit state) are small beside that.
//
// Design. One block per tile, one thread per pixel (256 threads), records
// staged in chunks of CH, last chunk first. What it does about the bound:
// - Warps own kernel A's 8x4 patches (composite_patch.cuh); each thread
//   reads its gtiles and exit state at its pixel's row-major index.
// - Kernel A's patch mask, recomputed here as the chunk is staged, one
//   thread per (record, patch) and the record's 8 bits gathered by a
//   ballot: a warp walks only the records whose bit it has (a ballot over
//   32 records, then the set bits from the highest down), so a pair whose
//   alpha provably stays below 1/255 on the whole patch, which adds
//   nothing to S, lsum or the terms, is never evaluated. (A saved mask was
//   measured against this: PERF.md §6.)
// - Each warp starts at the largest exit position among its own 32 lanes,
//   not the block's: the records between the two are skipped without
//   evaluation. The block stages from the block's largest down, and every
//   warp reaches every barrier.
// - The per-record sum pays for the work done: a (record, warp) step in
//   which no lane contributes writes nothing; any other takes a
//   reduce-scatter over the warp (warp_sum_fields: 12 shuffles, where a
//   butterfly per field takes 50), after which 10 lanes store the 10 sums
//   in one instruction. A
//   per-(warp, record) bit says which warps wrote a record's partials; the
//   8 warps' partials are then summed in warp order into the record's row,
//   the unwritten ones skipped (each exactly zero).
// - DEPTH (depth_grad) is a template parameter: without it the invdepth
//   cotangent is neither loaded nor computed (its partials are exact
//   zeros).
//
// The guard C<MASK=false> (composite_bwd_unmasked) sets every patch bit:
// each warp walks every record below its own largest exit. Skipping a pair
// whose bit is clear changes nothing, so the masked kernel's drec equals
// the guard's bit for bit; the tests and chip_smoke.py hold it to that (an
// exact check of patch_bit), and no render path launches the guard.
#include <cuda_runtime.h>

#include "composite_patch.cuh"

namespace {

using namespace gslm;

constexpr int CH = 64;            // records per staged chunk
constexpr int C_MIN_BLOCKS = 5;   // resident blocks per SM asked of ptxas

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

// MASK=false: the guard, every patch bit set.
template <bool DEPTH, bool MASK>
__global__ void __launch_bounds__(PIX, C_MIN_BLOCKS)
composite_bwd_kernel(const float* __restrict__ records,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx, int view_rows,
                     const float* __restrict__ gtiles,
                     const float* __restrict__ state,
                     float* __restrict__ drec) {
  __shared__ BwdShared sm;
  __shared__ int s_n_eff;
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
  float* out = drec + (size_t)start * NF;
  for (int j = n_eff * NF + tid; j < count * NF; j += PIX) out[j] = 0.f;
  const int field = sum_field(lane);
  const bool writer = sum_writer(lane);

  for (int lo = n_eff > 0 ? ((n_eff - 1) / CH) * CH : -1; lo >= 0;
       lo -= CH) {
    const int n = min(CH, n_eff - lo);
    // stage: thread (record j, patch p) loads the record, one of the
    // first three repacks it, each tests its patch; a ballot gathers the
    // record's 8 bits
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
        keep = !MASK || patch_bit(geo, f2.x, f2.y, txc, tyc, p);
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
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if ((sm.wrote[w][j / WARP] >> (j % WARP)) & 1u) s += sm.part[w][j][f];
      }
      out[(size_t)lo * NF + e] = s;
    }
  }
}

template <bool MASK>
int launch(const float* records, const int* starts, const int* counts,
           int ntiles, int ntx, int view_rows, const float* gtiles,
           const float* state, int depth_grad, float* drec,
           cudaStream_t stream) {
  if (ntiles > 0) {
    if (depth_grad) {
      composite_bwd_kernel<true, MASK><<<ntiles, PIX, 0, stream>>>(
          records, starts, counts, ntx, view_rows, gtiles, state, drec);
    } else {
      composite_bwd_kernel<false, MASK><<<ntiles, PIX, 0, stream>>>(
          records, starts, counts, ntx, view_rows, gtiles, state, drec);
    }
  }
  return (int)cudaGetLastError();
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
  return launch<true>(records, starts, counts, ntiles, ntx, view_rows,
                      gtiles, state, depth_grad, drec, stream);
}

// The same through the guard C<MASK=false> (every patch bit set).
extern "C" int composite_bwd_unmasked(const float* records,
                                      const int* starts, const int* counts,
                                      int ntiles, int ntx, int view_rows,
                                      const float* gtiles,
                                      const float* state, int depth_grad,
                                      float* drec, cudaStream_t stream) {
  return launch<false>(records, starts, counts, ntiles, ntx, view_rows,
                       gtiles, state, depth_grad, drec, stream);
}

// out[0..5]: registers per thread, static shared memory per block (bytes)
// and resident 256-thread blocks per SM of the depth_grad instantiation,
// then of the one without. Returns the first CUDA error, or 0.
extern "C" int composite_bwd_attrs(int* out) {
  const void* fns[2] = {(const void*)composite_bwd_kernel<true, true>,
                        (const void*)composite_bwd_kernel<false, true>};
  for (int k = 0; k < 2; ++k) {
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
