// Kernel C: backward tile compositor (the VJP of kernel A).
//
// Replaces the Pallas TPU backward compositor of gslm_tpu:
// _bwd_call / _make_tile_bwd_kernel (gslm_tpu/ops/rasterize_pallas.py).
//
// What it computes: the cotangent of every record field, drec (L, 10), from
// the image cotangent gtiles (ntiles, 5, 256) [r, g, b, invdepth, t_final]
// and the exit state kernel A saved per pixel (the log-transmittance sum at
// the exit and the exit position e: the in-segment index of the first
// record that failed T_after >= 1e-4, or count). Each record's row is the
// sum over its tile's 256 pixels of the 10 per-pair terms of the reverse
// walk from that exit state (composite_bwd_tile.cuh). Records at or past a
// pixel's exit contribute nothing for it; rows past every pixel's exit are
// written as exact zeros, so no row of drec is left unwritten.
//
// No atomics on floats: records are duplicated per tile, so every drec row
// belongs to exactly one tile and one block writes it, and the per-record
// sum over the tile's pixels runs in a fixed order, so the same inputs give
// the same bits on every run.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// before each pixel's exit (the power gate, then expf, log1pf, expf, a
// reciprocal and about 40 multiply-adds per contributing pair), plus the
// reduction's adds; bytes (records read once, drec written once, gtiles
// and the exit state) are small beside that.
//
// Design: one block per tile, one thread per pixel (256 threads), the walk
// of composite_bwd_tile.cuh (kernel A's 8x4 patches and patch mask,
// per-warp starts, a reduce-scatter per-record sum that pays only for
// (record, warp) steps with a contributing lane, a fixed-order sum of the 8
// warps), its sums written straight to drec's rows (TileRows). At most 48
// registers, so 5 blocks are resident per SM.
//
// The guard C<MASK=false> (composite_bwd_unmasked) sets every patch bit:
// each warp walks every record below its own largest exit. Skipping a pair
// whose bit is clear changes nothing, so the masked kernel's drec equals
// the guard's bit for bit; the tests and chip_smoke.py hold it to that (an
// exact check of patch_bit), and no render path launches the guard.
#include <cuda_runtime.h>

#include "composite_bwd_tile.cuh"

namespace {

using namespace gslm;

constexpr int C_MIN_BLOCKS = 5;   // resident blocks per SM asked of ptxas

// Where kernel C puts a tile's sums: its segment's rows of drec, all of
// them (zeros where no warp wrote, and past every exit).
struct TileRows {
  static constexpr bool RECT = false;
  float* out;   // drec; at(start): the segment's first row

  __device__ __forceinline__ TileRows at(int start) const {
    return {out + (size_t)start * NF};
  }
  __device__ __forceinline__ void zero_past(int n_eff, int count,
                                            int tid) const {
    for (int j = n_eff * NF + tid; j < count * NF; j += PIX) out[j] = 0.f;
  }
  __device__ __forceinline__ void store(int, size_t e, int, float s,
                                        bool) const {
    out[e] = s;
  }
};

// MASK=false: the guard, every patch bit set.
template <bool DEPTH, bool MASK>
__global__ void __launch_bounds__(PIX, C_MIN_BLOCKS)
composite_bwd_kernel(const float* __restrict__ records,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int ntx, int view_rows,
                     const float* __restrict__ gtiles,
                     const float* __restrict__ state,
                     float* __restrict__ drec) {
  bwd_tile_walk<DEPTH, MASK>(records, nullptr, starts, counts, blockIdx.x,
                             blockIdx.x, ntx, view_rows, gtiles, state,
                             TileRows{drec});
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
