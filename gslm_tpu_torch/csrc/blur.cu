// Kernel B: zero-padded SAME separable blur.
//
// Replaces the Pallas TPU blur of gslm_tpu: _blur_call / _make_blur_kernel,
// wrapped by blur_same (gslm_tpu/ops/blur_pallas.py). SSIM runs its five
// windowed statistics (15 planes per image pair) through it.
//
// What it computes: per plane, out = blur_W(blur_H(x)) with k 1-D taps
// (k = 11, a sigma-1.5 Gaussian, for SSIM), samples outside the image read
// as zero. Each pass sums its terms in tap order as separate IEEE multiply
// and add (__fmul_rn / __fadd_rn, never contracted to FMA), the order of the
// JAX kernel and of the plain PyTorch version, so the three agree to the
// last bit where their inputs do.
//
// Bound on this card: memory. One read and one write of planes*H*W*4 bytes;
// 2k operations per pixel per pass are far below the fp32 rate. Design: one
// block per (plane, 32-row x 64-column output tile). The block stages its
// input tile with a k/2 halo on every side in shared memory (coalesced
// row-major copy, zeros outside the image), runs the vertical pass into
// shared memory for the tile's rows and halo columns, then the horizontal
// pass, and writes each output once.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 15;
constexpr int BR = 32;        // output rows per block
constexpr int BC = 64;        // output columns per block
constexpr int THREADS = 256;

struct Taps {
  float w[MAX_TAPS];
};

__global__ void __launch_bounds__(THREADS)
blur_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W,
            Taps taps, int k) {
  extern __shared__ float smem[];
  const int halo = k / 2;
  const int in_cols = BC + 2 * halo;
  const int in_rows = BR + 2 * halo;
  float* xin = smem;                       // in_rows x in_cols
  float* vmid = smem + in_rows * in_cols;  // BR x in_cols
  const int r0 = blockIdx.y * BR;
  const int c0 = blockIdx.x * BC;
  const size_t plane = (size_t)blockIdx.z * H * W;

  for (int j = threadIdx.x; j < in_rows * in_cols; j += THREADS) {
    const int r = r0 - halo + j / in_cols;
    const int c = c0 - halo + j % in_cols;
    xin[j] = (r >= 0 && r < H && c >= 0 && c < W) ? x[plane + (size_t)r * W + c]
                                                  : 0.f;
  }
  __syncthreads();

  // vertical pass (columns outside the image stay exactly zero)
  for (int j = threadIdx.x; j < BR * in_cols; j += THREADS) {
    const float* col = xin + j;  // row j / in_cols, column j % in_cols
    float v = __fmul_rn(taps.w[0], col[0]);
    for (int t = 1; t < k; ++t) {
      v = __fadd_rn(v, __fmul_rn(taps.w[t], col[t * in_cols]));
    }
    vmid[j] = v;
  }
  __syncthreads();

  // horizontal pass
  for (int j = threadIdx.x; j < BR * BC; j += THREADS) {
    const int rr = j / BC, cc = j % BC;
    const int r = r0 + rr, c = c0 + cc;
    if (r >= H || c >= W) continue;
    const float* row = vmid + rr * in_cols + cc;
    float o = __fmul_rn(taps.w[0], row[0]);
    for (int t = 1; t < k; ++t) o = __fadd_rn(o, __fmul_rn(taps.w[t], row[t]));
    y[plane + (size_t)r * W + c] = o;
  }
}

}  // namespace

// x, y: (planes, H, W) f32 contiguous; taps: k host floats (k odd, <= 15).
// Launches on ``stream``; returns cudaGetLastError (or cudaErrorInvalidValue
// for an unsupported k).
extern "C" int blur_same(const float* x, float* y, int planes, int H, int W,
                         const float* taps, int k, cudaStream_t stream) {
  if (k < 1 || k > MAX_TAPS || k % 2 == 0) return (int)cudaErrorInvalidValue;
  Taps tp = {};
  for (int t = 0; t < k; ++t) tp.w[t] = taps[t];
  const int halo = k / 2;
  const size_t smem =
      sizeof(float) * (size_t)(BC + 2 * halo) * (2 * BR + 2 * halo);
  dim3 grid((W + BC - 1) / BC, (H + BR - 1) / BR, planes);
  if (planes > 0 && H > 0 && W > 0) {
    blur_kernel<<<grid, THREADS, smem, stream>>>(x, y, H, W, tp, k);
  }
  return (int)cudaGetLastError();
}
