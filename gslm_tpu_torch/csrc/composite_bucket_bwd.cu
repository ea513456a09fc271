// Kernel D: backward compositor of bucket mode (the VJP of kernel A when
// tiles walk bucket segments).
//
// Replaces the Pallas TPU bucket backward of gslm_tpu:
// _bucket_bwd_call / _make_bucket_bwd_kernel
// (gslm_tpu/ops/rasterize_pallas.py).
//
// What it computes: with RasterConfig.bucket = BK > 1 the records are
// binned per BK x BK-tile bucket and each of a bucket's BK^2 member tiles
// walks the bucket's whole segment under the rect gate (a record counts for
// a tile only inside the record's own tile rect). A record of bucket b's
// segment is therefore shared by b's member tiles, and its cotangent drec
// (Lb, 10) is the SUM over b's valid member tiles of the 10 per-record
// terms kernel C computes for one tile: each tile's reverse walk from the
// exit state kernel A saved for it (rows 5-6 of A's output: exit
// log-transmittance and exit position, in bucket-segment coordinates).
// Member slot s = dy * BK + dx of bucket (bx, by) is tile
// (view * view_rows + by_in_view * BK + dy) * ntx + bx * BK + dx; a member
// past the last tile column (ntx % BK != 0) or past its view's rows does
// not exist and is skipped. Every row of every segment is written: exact
// zeros where no member tile contributes.
//
// Bound on this card: fp32 and SFU issue over the (record, pixel) pairs
// that pass the rect gate before each pixel's exit, summed over the member
// tiles (kernel C's arithmetic per pair). Bytes: records and rects read
// once per member tile that walks them (the bound counts them once), each
// member's per-record sums written and read once, drec written once.
//
// Design: two kernels, one launch of D.
// 1. The walk: one 256-thread block per tile, as kernel C at bucket 1,
//    with kernel C's walk (composite_bwd_tile.cuh: 8x4 patches, the patch
//    mask, per-warp starts, the reduce-scatter sum, a fixed-order sum of
//    the 8 warps) over the tile's bucket segment. The rect gate is folded
//    into the staged mask: the rect is tested first, once per staged
//    (record, patch), and a record outside it gets mask 0, so it costs no
//    warp anything beyond the ballot. The tile's sum of each record goes to
//    ``part`` (BK^2, Lb, 10), the plane of its member slot, where any warp
//    wrote a partial of it, and ``flags`` (Lb, 16) says which slots did: a
//    flag is 0 where the tile wrote nothing, or where the row lies at or
//    past the tile's largest exit.
// 2. The sum: one 256-thread block per bucket, a thread per row, adds the
//    flagged slots' sums of each row in slot order, skipping member tiles
//    that do not exist, and writes drec once.
// So a gated record costs a rect test, drec is written once instead of read
// and written per member, and the walk runs on 8,160 blocks at 1080p where
// one block per bucket serialised its 16 member tiles on 510.
//
// No float atomics: a row's sum over a tile's pixels runs in kernel C's
// fixed order, and its sum over the members in slot order, so the same
// inputs give the same bits on every run.
//
// The guard D<MASK=false> (composite_bucket_bwd_unmasked) sets every patch
// bit inside the rect gate. Skipping a pair whose bit is clear changes
// nothing, so D's drec equals the guard's bit for bit; the tests and
// chip_smoke.py hold it to that (an exact check of patch_bit under the rect
// gate), and no render path launches the guard.
#include <cuda_runtime.h>

#include "composite_bwd_tile.cuh"

namespace {

using namespace gslm;

constexpr int D_MIN_BLOCKS = 5;   // resident blocks per SM asked of ptxas
constexpr int SLOTS = 16;         // flags per row: BK^2 <= 16

// Where kernel D's walk puts a member tile's sums: its slot's plane of
// ``part`` where a warp wrote, and a flag per row of the segment.
struct MemberRows {
  static constexpr bool RECT = true;
  float* out;            // the slot's plane; at(start): the segment's rows
  unsigned char* flag;   // row 0's flag of the slot; at(start): the segment's

  __device__ __forceinline__ MemberRows at(int start) const {
    return {out + (size_t)start * NF, flag + (size_t)start * SLOTS};
  }

  __device__ __forceinline__ void zero_past(int n_eff, int count,
                                            int tid) const {
    for (int j = n_eff + tid; j < count; j += PIX) flag[(size_t)j * SLOTS] = 0;
  }
  __device__ __forceinline__ void store(int j, size_t e, int f, float s,
                                        bool wrote) const {
    if (wrote) out[e] = s;
    if (f == 0) flag[(size_t)j * SLOTS] = wrote;
  }
};

// Tile t's bucket and member slot (rasterize_cuda.bucket_of_tile).
__device__ __forceinline__ void tile_bucket(int t, int ntx, int view_rows,
                                            int bucket, int& b, int& slot) {
  const int tx = t % ntx, ty = t / ntx;
  const int tyv = ty % view_rows;
  const int by = (ty / view_rows) * (view_rows / bucket) + tyv / bucket;
  b = by * ((ntx + bucket - 1) / bucket) + tx / bucket;
  slot = (tyv % bucket) * bucket + tx % bucket;
}

// MASK=false: the guard, every patch bit set inside the rect gate.
template <bool DEPTH, bool MASK>
__global__ void __launch_bounds__(PIX, D_MIN_BLOCKS)
bucket_walk_kernel(const float* __restrict__ records,
                   const int* __restrict__ rects,
                   const int* __restrict__ bstarts,
                   const int* __restrict__ bcounts, int n_rows, int ntx,
                   int view_rows, int bucket,
                   const float* __restrict__ gtiles,
                   const float* __restrict__ state,
                   float* __restrict__ part,
                   unsigned char* __restrict__ flags) {
  const int t = blockIdx.x;
  int b, slot;
  tile_bucket(t, ntx, view_rows, bucket, b, slot);
  bwd_tile_walk<DEPTH, MASK>(
      records, rects, bstarts, bcounts, b, t, ntx, view_rows, gtiles, state,
      MemberRows{part + (size_t)slot * n_rows * NF, flags + slot});
}

// Bucket b's rows: the flagged member slots' sums in slot order.
__global__ void __launch_bounds__(PIX)
bucket_sum_kernel(const float* __restrict__ part,
                  const unsigned char* __restrict__ flags,
                  const int* __restrict__ bstarts,
                  const int* __restrict__ bcounts, int n_rows, int ntx,
                  int nty, int view_rows, int bucket,
                  float* __restrict__ drec) {
  const int b = blockIdx.x;
  const int start = bstarts[b];
  const int count = bcounts[b];
  // the member slots whose tile exists
  const int nbx = (ntx + bucket - 1) / bucket;
  const int vrow_b = view_rows / bucket;
  const int byv = b / nbx;
  const int tx0 = (b % nbx) * bucket;
  const int ty0 = (byv / vrow_b) * view_rows + (byv % vrow_b) * bucket;
  unsigned members = 0u;
  for (int s = 0; s < bucket * bucket; ++s) {
    if (tx0 + s % bucket < ntx && ty0 + s / bucket < nty) members |= 1u << s;
  }
  for (int j = threadIdx.x; j < count; j += PIX) {
    const size_t row = (size_t)start + j;
    const uint4 fl = *reinterpret_cast<const uint4*>(flags + row * SLOTS);
    const unsigned words[4] = {fl.x, fl.y, fl.z, fl.w};
    float s[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) s[f] = 0.f;
    for (unsigned m = members; m != 0u; m &= m - 1u) {
      const int slot = __ffs(m) - 1;
      if (!((words[slot >> 2] >> (8 * (slot & 3))) & 0xffu)) continue;
      const float2* p = reinterpret_cast<const float2*>(
          part + ((size_t)slot * n_rows + row) * NF);
#pragma unroll
      for (int k = 0; k < NF / 2; ++k) {
        const float2 v = p[k];
        s[2 * k] += v.x;
        s[2 * k + 1] += v.y;
      }
    }
    float2* o = reinterpret_cast<float2*>(drec + row * NF);
#pragma unroll
    for (int k = 0; k < NF / 2; ++k) o[k] = make_float2(s[2 * k], s[2 * k + 1]);
  }
}

template <bool MASK>
int launch(const float* records, const int* rects, const int* bstarts,
           const int* bcounts, int nseg, int n_rows, int ntx, int nty,
           int view_rows, int bucket, const float* gtiles, const float* state,
           int depth_grad, float* part, unsigned char* flags, float* drec,
           cudaStream_t stream) {
  if (bucket * bucket > SLOTS) return (int)cudaErrorInvalidValue;
  const int ntiles = ntx * nty;
  if (nseg > 0 && ntiles > 0) {
    if (depth_grad) {
      bucket_walk_kernel<true, MASK><<<ntiles, PIX, 0, stream>>>(
          records, rects, bstarts, bcounts, n_rows, ntx, view_rows, bucket,
          gtiles, state, part, flags);
    } else {
      bucket_walk_kernel<false, MASK><<<ntiles, PIX, 0, stream>>>(
          records, rects, bstarts, bcounts, n_rows, ntx, view_rows, bucket,
          gtiles, state, part, flags);
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    bucket_sum_kernel<<<nseg, PIX, 0, stream>>>(
        part, flags, bstarts, bcounts, n_rows, ntx, nty, view_rows, bucket,
        drec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// records (Lb, 10) f32 and rects (Lb, 4) i32 in bucket-segment order,
// bstarts/bcounts (nseg,) i32, gtiles (ntiles, 5, 256) f32 and state
// (ntiles, 2, 256) f32 [exit lsum, exit position] in tile order (ntiles =
// ntx * nty, tile rows stacking views of view_rows rows, view_rows % bucket
// == 0, bucket^2 <= 16); scratch part (bucket^2, Lb, 10) f32 and flags
// (Lb, 16) u8, neither read before it is written → drec (Lb, 10) f32 (every
// row of every segment written). Launches the walk and the sum on
// ``stream``; returns the first cudaGetLastError that is not 0.
extern "C" int composite_bucket_bwd(const float* records, const int* rects,
                                    const int* bstarts, const int* bcounts,
                                    int nseg, int n_rows, int ntx, int nty,
                                    int view_rows, int bucket,
                                    const float* gtiles, const float* state,
                                    int depth_grad, float* part,
                                    unsigned char* flags, float* drec,
                                    cudaStream_t stream) {
  return launch<true>(records, rects, bstarts, bcounts, nseg, n_rows, ntx,
                      nty, view_rows, bucket, gtiles, state, depth_grad, part,
                      flags, drec, stream);
}

// The same through the guard D<MASK=false> (every patch bit set inside the
// rect gate).
extern "C" int composite_bucket_bwd_unmasked(
    const float* records, const int* rects, const int* bstarts,
    const int* bcounts, int nseg, int n_rows, int ntx, int nty,
    int view_rows, int bucket, const float* gtiles, const float* state,
    int depth_grad, float* part, unsigned char* flags, float* drec,
    cudaStream_t stream) {
  return launch<false>(records, rects, bstarts, bcounts, nseg, n_rows, ntx,
                       nty, view_rows, bucket, gtiles, state, depth_grad,
                       part, flags, drec, stream);
}

// out[0..5]: registers per thread, static shared memory per block (bytes)
// and resident 256-thread blocks per SM of the walk's depth_grad
// instantiation, then of the sum. Returns the first CUDA error, or 0.
extern "C" int composite_bucket_bwd_attrs(int* out) {
  const void* fns[2] = {(const void*)bucket_walk_kernel<true, true>,
                        (const void*)bucket_sum_kernel};
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
