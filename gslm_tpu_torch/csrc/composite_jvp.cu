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
// tangent (5, 256) [r, g, b, invdepth, t_final]. The primal arithmetic is
// kernel A's, through the same inline pair function
// (composite_common.cuh), so rows 0-6 are kernel A's bits.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// walked, as kernel A, with 41 fp32 instructions and one reciprocal per
// accumulated pair where A has 5 (sm_90a SASS); the records and tangents
// read are 80 B per record per tile. Design: kernel A's. One block per tile, one
// thread per pixel (256 threads); the block stages a chunk of 256 records
// and their 256 tangents in shared memory (2 x 10 KB) with coalesced
// copies, every thread composites the chunk in order (all threads read the
// same record: a broadcast), and the block stops at the first chunk
// boundary where every pixel has exited.
//
// Bucket mode (a non-null ``rects``): kernel A's rect gate, evaluated once
// per staged record; RECT = false compiles the bucket-1 loop unchanged.
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gslm;

template <bool RECT>
__global__ void __launch_bounds__(PIX)
composite_jvp_kernel(const float* __restrict__ records,
                     const float* __restrict__ tangents,
                     const int* __restrict__ rects,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx, int view_rows,
                     float* __restrict__ out, float* __restrict__ out_dot) {
  __shared__ float rec[PIX * NF];
  __shared__ float tng[PIX * NF];
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
  float lsum_dot = 0.f, t_final_dot = 0.f;
  float dot_r = 0.f, dot_g = 0.f, dot_b = 0.f, dot_d = 0.f;
  bool done = false;
  int exit_pos = count;

  for (int base = 0; base < count; base += PIX) {
    // barrier: the previous chunk is consumed before it is overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(PIX, count - base);
    const size_t off = (size_t)(start + base) * NF;
    for (int j = lane; j < n * NF; j += PIX) {
      rec[j] = records[off + j];
      tng[j] = tangents[off + j];
    }
    if (RECT && lane < n) {
      gate[lane] = rect_gate(rects + (size_t)(start + base + lane) * 4, txc,
                             tyc);
    }
    __syncthreads();
    for (int i = 0; i < n && !done; ++i) {
      if (RECT && !gate[i]) continue;
      const float* r = rec + i * NF;
      Pair p;
      if (!pair_alpha(r, px, py, p)) continue;
      const float a = p.a;
      const float l_after = lsum + log1pf(-a);
      const float t_after = expf(l_after);
      const float T_dot = T * lsum_dot;
      if (t_after < T_EPS) {  // T_before >= 1e-4 holds here by induction
        t_final = T;
        t_final_dot = T_dot;
        exit_pos = base + i;
        done = true;
        break;
      }
      const float* d = tng + i * NF;
      const float dx = p.dx, dy = p.dy;
      const float pow_dot = -(r[2] * dx + r[3] * dy) * d[0]
                            - (r[4] * dy + r[3] * dx) * d[1]
                            - 0.5f * dx * dx * d[2] - dx * dy * d[3]
                            - 0.5f * dy * dy * d[4];
      const float a_dot = d[5] * p.expp + p.a_raw * pow_dot;
      const float w = a * T;
      const float w_dot = a_dot * T + a * T_dot;
      acc_r += w * r[6];
      acc_g += w * r[7];
      acc_b += w * r[8];
      acc_d += w * r[9];
      dot_r += w_dot * r[6] + w * d[6];
      dot_g += w_dot * r[7] + w * d[7];
      dot_b += w_dot * r[8] + w * d[8];
      dot_d += w_dot * r[9] + w * d[9];
      lsum = l_after;
      T = t_after;
      lsum_dot -= a_dot / (1.f - a);
    }
  }
  if (!done) {
    t_final = T;
    t_final_dot = T * lsum_dot;
  }

  float* o = out + (size_t)t * OUT_ROWS * PIX + lane;
  o[0 * PIX] = acc_r;
  o[1 * PIX] = acc_g;
  o[2 * PIX] = acc_b;
  o[3 * PIX] = acc_d;
  o[4 * PIX] = t_final;
  o[5 * PIX] = lsum;
  o[6 * PIX] = (float)exit_pos;  // exact: segments hold far fewer than 2^24
  float* od = out_dot + (size_t)t * IMG_ROWS * PIX + lane;
  od[0 * PIX] = dot_r;
  od[1 * PIX] = dot_g;
  od[2 * PIX] = dot_b;
  od[3 * PIX] = dot_d;
  od[4 * PIX] = t_final_dot;
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
  if (ntiles > 0) {
    if (rects) {
      composite_jvp_kernel<true><<<ntiles, PIX, 0, stream>>>(
          records, tangents, rects, starts, counts, ntx, view_rows, out,
          out_dot);
    } else {
      composite_jvp_kernel<false><<<ntiles, PIX, 0, stream>>>(
          records, tangents, rects, starts, counts, ntx, view_rows, out,
          out_dot);
    }
  }
  return (int)cudaGetLastError();
}
