// Kernel F: exact mean squared distance to the 3 nearest other points, by
// a grid search.
//
// Replaces no Pallas kernel: the JAX package computes it on the host, in
// its native library's grid-ring search (native/gslm_native.cpp,
// mean_sq_dist_3nn, through gslm_tpu/native.py), which its
// create_from_pcd prefers to the brute force of gslm_tpu/ops/knn.py; the
// reference's counterpart is simple-knn's CUDA distCUDA2. It runs once per
// model made from a point cloud (Scene -> create_from_pcd).
//
// What it computes: for every point i, the three smallest squared
// distances d1 <= d2 <= d3 to the points j != i, each formed as
// (dx*dx + dy*dy) + dz*dz with dx = p_i.x - p_j.x, every operation a
// separate IEEE float32 one (__fsub_rn, __fmul_rn, __fadd_rn: never
// contracted to an FMA), then out[i] = ((d1 + d2) + d3) / 3. With fewer than
// four points the P - 1 distances there are are summed, still over 3 (the
// plain version's rule). A duplicate point keeps its zero distance. So
// out equals the plain version's (ops/knn.py: mean_sq_dist_3nn_plain) and
// the JAX package's native library's bit for bit: the three values are an
// exact multiset, whatever order the candidates are met in.
//
// The grid (built by the wrapper in PyTorch, ops/knn.py: build_grid): a
// box per axis from the cloud's quantiles, BOX_TAIL of the points beyond
// each face, cells of about equal size, about POINTS_PER_CELL points per
// cell, an axis without extent one cell thick; points outside the box are
// clamped into the boundary cells, which so reach to infinity. The points
// come sorted by cell id (x fastest), with each cell's start.
//
// Search: rings of cells. Ring r is the shell of cells at Chebyshev index
// distance r from the point's own cell, clipped to the grid; a row of the
// shell along x is one contiguous range of the sorted points. After ring r
// every point not yet met lies in a cell beyond one of the six faces of
// the visited block, so its distance is at least the gap from the point's
// own coordinates to that face: a cell index k along an axis means
// lo + k*c - m <= x < lo + (k+1)*c + m, m the rounding slack of the index
// (the wrapper's margin, 1e-6 of the box's extent; the index itself rounds
// by at most ~3 float32 ulps of it). The gaps are taken in double, the
// least one rounded down to float g, and the search stops once
// fl(g*g) >= d3 with three found: every distance not met is then at least
// fl(g*g) (rounding is monotone), so none could enter the three. It stops
// too once the visited block covers the grid.
//
// Two passes, so that a far point does not hold up its warp:
// - knn_kernel: one thread per point, in cell order, the best three in
//   registers. A point not done after ring RING_DEFER (an outlier, or a
//   point in an emptier part of the box) is handed on to a list.
// - knn_warp_kernel: one warp per listed point, from ring 0 again. Each
//   ring's rows are split over the lanes (one row each; a row longer than
//   LONG_ROW is walked by the whole warp), each lane keeps its own best
//   three, and at the end of the ring an xor butterfly merges them into
//   the warp's (the three smallest of the union: exact), which lane 0 then
//   keeps and the others clear. A far outlier's scan of most of the grid
//   so runs 32 wide. On an H100 (700 W), 131,072 points in clusters with
//   1 % far outliers took 52.7 ms in one pass and 5.3 ms in the two
//   (PERF.md).
//
// Bound on this card: bytes. The function reads each point once (12 B)
// and writes one float (4 B); the candidate pairs it evaluates (about 50
// per point on a uniform cloud) are 9 fp32 operations each and come from
// L1 and L2. Clustered clouds put more points into a cell and so cost more
// pairs.
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int F_THREADS = 256;
constexpr int RING_DEFER = 2;    // the last ring of the first pass
constexpr int LONG_ROW = 32;     // rows past this many points: the warp's
constexpr int WARP_BLOCKS = 1056;  // 8 warps each: 64 per SM of 132
constexpr unsigned FULL = 0xffffffffu;

struct Grid {
  double lo[3];     // the box's low corner (float32 values)
  double cell[3];   // cell size per axis (float32 values)
  double margin[3]; // slack of a cell index, in coordinates
  int dims[3];      // cells per axis
};

__device__ __forceinline__ float sq_dist(float4 p, float4 q) {
  const float dx = __fsub_rn(p.x, q.x);
  const float dy = __fsub_rn(p.y, q.y);
  const float dz = __fsub_rn(p.z, q.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The three smallest values pushed (held of them so far, at most 3),
// ascending.
struct Best3 {
  float d0 = FLT_MAX, d1 = FLT_MAX, d2 = FLT_MAX;
  int held = 0;

  __device__ __forceinline__ void push(float d) {
    if (held < 3) {   // the first three enter whatever their value
      if (held == 0) {
        d0 = d;
      } else if (held == 1) {
        if (d < d0) { d1 = d0; d0 = d; } else { d1 = d; }
      } else {
        if (d < d0) { d2 = d1; d1 = d0; d0 = d; }
        else if (d < d1) { d2 = d1; d1 = d; }
        else { d2 = d; }
      }
      ++held;
      return;
    }
    if (d < d2) {
      if (d < d1) {
        d2 = d1;
        if (d < d0) { d1 = d0; d0 = d; } else { d1 = d; }
      } else {
        d2 = d;
      }
    }
  }

  // (d1 + d2) + d3 over the values held, then / 3
  __device__ __forceinline__ float mean3() const {
    float s = 0.f;
    if (held >= 1) s = d0;
    if (held >= 2) s = __fadd_rn(s, d1);
    if (held >= 3) s = __fadd_rn(s, d2);
    return __fdiv_rn(s, 3.0f);
  }
};

// The point's cell coordinates.
__device__ __forceinline__ void cell_of(int cid, const Grid& g, int* k) {
  k[0] = cid % g.dims[0];
  k[1] = (cid / g.dims[0]) % g.dims[1];
  k[2] = cid / (g.dims[0] * g.dims[1]);
}

// After ring r: whether the visited block leaves cells of the grid
// unvisited, and if so the least gap from p to one of its faces inside
// the grid (double; may be <= 0).
__device__ __forceinline__ bool gap_after(const Grid& g, const int* k,
                                          const double* pc, int r,
                                          double& gap) {
  gap = DBL_MAX;
  bool inside = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (k[a] + r + 1 < g.dims[a]) {
      inside = true;
      gap = fmin(gap, (g.lo[a] + (k[a] + r + 1) * g.cell[a] - g.margin[a])
                          - pc[a]);
    }
    if (k[a] - r - 1 >= 0) {
      inside = true;
      gap = fmin(gap, pc[a] - (g.lo[a] + (k[a] - r) * g.cell[a]
                               + g.margin[a]));
    }
  }
  return inside;
}

// Whether no distance past the gap can enter ``best``.
__device__ __forceinline__ bool done(const Best3& best, double gap) {
  if (best.held < 3 || gap <= 0.0) return false;
  const float gf = __double2float_rd(gap);
  return __fmul_rn(gf, gf) >= best.d2;
}

// The points of sorted positions [b, e), but t itself.
template <bool COUNT>
__device__ __forceinline__ void scan(const float4* __restrict__ pts, int b,
                                     int e, int t, float4 p, Best3& best,
                                     int& pairs) {
  for (int j = b; j < e; ++j) {
    if (j == t) continue;
    best.push(sq_dist(p, __ldg(pts + j)));
    if (COUNT) ++pairs;
  }
}

// Pass 1: one thread per sorted point t.
template <bool COUNT>
__global__ void __launch_bounds__(F_THREADS)
knn_kernel(const float4* __restrict__ pts, const int* __restrict__ cells,
           const int* __restrict__ starts,
           const long long* __restrict__ order, int n, Grid g,
           float* __restrict__ out, int* __restrict__ pairs_out,
           int* __restrict__ deferred, int* __restrict__ n_deferred) {
  const int t = blockIdx.x * F_THREADS + threadIdx.x;
  if (t >= n) return;
  const float4 p = pts[t];
  int k[3];
  cell_of(cells[t], g, k);
  const int dx = g.dims[0], dy = g.dims[1], dz = g.dims[2];
  const double pc[3] = {p.x, p.y, p.z};
  Best3 best;
  int pairs = 0;
  bool handed_on = false;
  for (int r = 0;; ++r) {
    const int x0 = max(k[0] - r, 0), x1 = min(k[0] + r, dx - 1);
    const int y0 = max(k[1] - r, 0), y1 = min(k[1] + r, dy - 1);
    const int z0 = max(k[2] - r, 0), z1 = min(k[2] + r, dz - 1);
    for (int z = z0; z <= z1; ++z) {
      const bool zedge = abs(z - k[2]) == r;
      for (int y = y0; y <= y1; ++y) {
        const int row = (z * dy + y) * dx;
        if (zedge || abs(y - k[1]) == r) {
          // the whole row of the shell: one contiguous range
          scan<COUNT>(pts, starts[row + x0], starts[row + x1 + 1], t, p,
                      best, pairs);
        } else {
          if (k[0] - r >= 0) {
            const int c = row + k[0] - r;
            scan<COUNT>(pts, starts[c], starts[c + 1], t, p, best, pairs);
          }
          if (k[0] + r < dx) {
            const int c = row + k[0] + r;
            scan<COUNT>(pts, starts[c], starts[c + 1], t, p, best, pairs);
          }
        }
      }
    }
    double gap;
    if (!gap_after(g, k, pc, r, gap) || done(best, gap)) break;
    if (r == RING_DEFER) {
      deferred[atomicAdd(n_deferred, 1)] = t;
      handed_on = true;
      break;
    }
  }
  const long long i = order[t];
  if (!handed_on) out[i] = best.mean3();
  if (COUNT) pairs_out[i] = pairs;
}

// Pass 2: one warp per point handed on by pass 1, from ring 0 again.
template <bool COUNT>
__global__ void __launch_bounds__(F_THREADS)
knn_warp_kernel(const float4* __restrict__ pts, const int* __restrict__ cells,
                const int* __restrict__ starts,
                const long long* __restrict__ order, Grid g,
                const int* __restrict__ deferred,
                const int* __restrict__ n_deferred, float* __restrict__ out,
                int* __restrict__ pairs_out) {
  const int lane = threadIdx.x & 31;
  const int nwarps = (gridDim.x * F_THREADS) >> 5;
  const int nd = *n_deferred;
  const int dx = g.dims[0], dy = g.dims[1], dz = g.dims[2];
  for (int w = (blockIdx.x * F_THREADS + threadIdx.x) >> 5; w < nd;
       w += nwarps) {
    const int t = deferred[w];
    const float4 p = pts[t];
    int k[3];
    cell_of(cells[t], g, k);
    const double pc[3] = {p.x, p.y, p.z};
    Best3 best;
    int pairs = 0;
    for (int r = 0;; ++r) {
      const int x0 = max(k[0] - r, 0), x1 = min(k[0] + r, dx - 1);
      const int y0 = max(k[1] - r, 0), y1 = min(k[1] + r, dy - 1);
      const int z0 = max(k[2] - r, 0), z1 = min(k[2] + r, dz - 1);
      const int ny = y1 - y0 + 1;
      // two items per (z, y) row of the block: a shell row is one range
      // (item 0); elsewhere the shell's two cells x = k - r and k + r
      const int items = 2 * ny * (z1 - z0 + 1);
      for (int base = 0; base < items; base += 32) {
        const int q = base + lane;
        int b = 0, e = 0;
        if (q < items) {
          const int z = z0 + (q >> 1) / ny, y = y0 + (q >> 1) % ny;
          const int row = (z * dy + y) * dx;
          if (abs(z - k[2]) == r || abs(y - k[1]) == r) {
            if ((q & 1) == 0) {
              b = starts[row + x0];
              e = starts[row + x1 + 1];
            }
          } else {
            const int x = (q & 1) ? k[0] + r : k[0] - r;
            if (x >= 0 && x < dx) {
              b = starts[row + x];
              e = starts[row + x + 1];
            }
          }
        }
        const bool wide = e - b > LONG_ROW;
        if (!wide) scan<COUNT>(pts, b, e, t, p, best, pairs);
        for (unsigned m = __ballot_sync(FULL, wide); m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          const int bb = __shfl_sync(FULL, b, src);
          const int ee = __shfl_sync(FULL, e, src);
          for (int j = bb + lane; j < ee; j += 32) {
            if (j == t) continue;
            best.push(sq_dist(p, __ldg(pts + j)));
            if (COUNT) ++pairs;
          }
        }
      }
      // the warp's three: every lane pushes its partner's (disjoint sets
      // at every step of the butterfly)
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) {
        const float o0 = __shfl_xor_sync(FULL, best.d0, s);
        const float o1 = __shfl_xor_sync(FULL, best.d1, s);
        const float o2 = __shfl_xor_sync(FULL, best.d2, s);
        const int oh = __shfl_xor_sync(FULL, best.held, s);
        if (oh >= 1) best.push(o0);
        if (oh >= 2) best.push(o1);
        if (oh >= 3) best.push(o2);
      }
      double gap;
      if (!gap_after(g, k, pc, r, gap) || done(best, gap)) break;
      if (lane != 0) best = Best3();   // lane 0 keeps the warp's three
    }
    if (COUNT) {
      for (int s = 16; s >= 1; s >>= 1)
        pairs += __shfl_xor_sync(FULL, pairs, s);
    }
    if (lane == 0) {
      const long long i = order[t];
      out[i] = best.mean3();
      if (COUNT) pairs_out[i] += pairs;
    }
  }
}

template <bool COUNT>
int launch(const void* pts, const int* cells, const int* starts,
           const long long* order, int n, const double* geom,
           const int* dims, float* out, int* pairs, int* scratch,
           cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  Grid g;
  for (int a = 0; a < 3; ++a) {
    g.lo[a] = geom[a];
    g.cell[a] = geom[3 + a];
    g.margin[a] = geom[6 + a];
    g.dims[a] = dims[a];
    if (dims[a] < 1) return (int)cudaErrorInvalidValue;
  }
  // scratch: the count of points handed on, then their list
  cudaError_t rc = cudaMemsetAsync(scratch, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return (int)rc;
  const float4* p4 = (const float4*)pts;
  knn_kernel<COUNT><<<(n + F_THREADS - 1) / F_THREADS, F_THREADS, 0,
                      stream>>>(p4, cells, starts, order, n, g, out, pairs,
                                scratch + 1, scratch);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (n + 7) / 8 < WARP_BLOCKS ? (n + 7) / 8 : WARP_BLOCKS;
  knn_warp_kernel<COUNT><<<blocks, F_THREADS, 0, stream>>>(
      p4, cells, starts, order, g, scratch + 1, scratch, out, pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// pts: (n, 4) float32 in cell order (w unused); cells: (n,) int32 cell id
// of each; starts: (ncells + 1,) int32; order: (n,) int64, each sorted
// point's index in the caller's order; geom: 9 doubles on the host (lo,
// cell size, margin per axis); dims: 3 ints on the host; scratch: (n + 1,)
// int32 on the card (on return scratch[0] is the count of points the
// second pass took). Writes out[order[t]]. Launches both passes on
// ``stream``; returns the first CUDA error (cudaErrorInvalidValue for bad
// dims), or 0.
extern "C" int knn_mean_sq_dist(const void* pts, const int* cells,
                                const int* starts, const long long* order,
                                int n, const double* geom, const int* dims,
                                float* out, int* scratch,
                                cudaStream_t stream) {
  return launch<false>(pts, cells, starts, order, n, geom, dims, out,
                       nullptr, scratch, stream);
}

// The same, and the candidate pairs each point evaluated (both passes)
// into pairs (n,) int32, in the caller's order: for the measurements only.
extern "C" int knn_mean_sq_dist_pairs(const void* pts, const int* cells,
                                      const int* starts,
                                      const long long* order, int n,
                                      const double* geom, const int* dims,
                                      float* out, int* pairs, int* scratch,
                                      cudaStream_t stream) {
  return launch<true>(pts, cells, starts, order, n, geom, dims, out, pairs,
                      scratch, stream);
}

// out[0..11]: registers per thread, static shared memory per block (bytes)
// and resident 256-thread blocks per SM of the first pass, then of the
// second, then of their pair-counting instantiations. Returns the first
// CUDA error, or 0.
extern "C" int knn_attrs(int* out) {
  const void* fns[4] = {(const void*)knn_kernel<false>,
                        (const void*)knn_warp_kernel<false>,
                        (const void*)knn_kernel<true>,
                        (const void*)knn_warp_kernel<true>};
  for (int k = 0; k < 4; ++k) {
    cudaFuncAttributes a;
    cudaError_t rc = cudaFuncGetAttributes(&a, fns[k]);
    if (rc != cudaSuccess) return (int)rc;
    out[3 * k] = a.numRegs;
    out[3 * k + 1] = (int)a.sharedSizeBytes;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3 * k + 2],
                                                       fns[k], F_THREADS, 0);
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}
