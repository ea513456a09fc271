// Kernel B: zero-padded SAME separable blur.
//
// Replaces the Pallas TPU blur of gslm_tpu: _blur_call / _make_blur_kernel,
// wrapped by blur_same (gslm_tpu/ops/blur_pallas.py). SSIM runs its five
// windowed statistics (15 planes per image pair) through it.
//
// What it computes: per plane, out = blur_W(blur_H(x)) with k 1-D taps
// (k = 11, a sigma-1.5 Gaussian, for SSIM; any odd k <= 15), samples
// outside the image read as zero. Each pass sums its terms in tap order as
// separate IEEE multiply and add (__fmul_rn / __fadd_rn, never contracted
// to FMA), the order of the JAX kernel and of the plain PyTorch version, so
// the three agree to the last bit where their inputs do.
//
// Bound on this card: memory. One read and one write of planes*H*W*4
// bytes; the 2k - 1 operations per output per pass (no FMA: the tap-order
// sums fix each rounding) come close to it, so the design keeps every other
// instruction off the hot path.
//
// Design. One 256-thread block per (plane, 64-row x 112-column output
// tile); K, the tap count, is a template parameter (every odd K from 1 to
// 15 is instantiated), so both tap loops unroll and the taps are operands
// in the kernel's parameter bank.
// - Vertical pass in registers: the block covers 128 columns, the tile's
//   112 and up to 7 halo columns on each side. Thread (column, half) reads
//   its column's 32 + K - 1 input rows straight from global memory, each
//   read coalesced across the warp, holds them in registers and writes its
//   32 vertical results once to shared memory. Columns outside the image
//   write exact zeros, as the plain version's padding is.
// - Horizontal pass: each thread makes 4 consecutive outputs of one row
//   from ceil((K + 3) / 4) float4 reads of that row in shared memory (8
//   threads of a quarter warp read 128 contiguous bytes: no bank
//   conflicts), and writes them once, as one float4 where the row allows.
// - Ragged edges: rows outside the image read zeros and are not written;
//   the last tile's columns past W, and planes narrower or shorter than
//   the halo, are masked the same way.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 15;
constexpr int THREADS = 256;
constexpr int VC = 128;          // columns of the vertical pass
constexpr int BC = 112;          // output columns per block (VC - 2 * 8)
constexpr int BR = 64;           // output rows per block
constexpr int RUN = 32;          // vertical outputs per thread
constexpr int HRUN = 4;          // horizontal outputs per thread
constexpr int NQ = BC / HRUN;    // horizontal runs per row

struct Taps {
  float w[MAX_TAPS];
};

template <int K>
__global__ void __launch_bounds__(THREADS, 4)
blur_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W,
            Taps taps) {
  constexpr int HALO = K / 2;
  constexpr int NV = (HRUN + K - 1 + 3) / 4;   // float4 reads per run
  __shared__ __align__(16) float vmid[BR][VC];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * BR;
  const int c0 = blockIdx.x * BC;
  const size_t plane = (size_t)blockIdx.z * H * W;

  // vertical pass: column col of the tile's 128, output rows
  // [r0 + RUN * half, +RUN)
  {
    const int col = tid % VC, half = tid / VC;
    const int c = c0 - HALO + col;
    const int ro = r0 + RUN * half;
    float* dst = &vmid[RUN * half][col];
    if (c < 0 || c >= W) {
#pragma unroll
      for (int o = 0; o < RUN; ++o) dst[o * VC] = 0.f;
    } else {
      float v[RUN + K - 1];
      const float* src = x + plane + c;
      const int rt = ro - HALO;   // the first input row
      if (rt >= 0 && rt + RUN + K - 1 <= H) {
        const float* p = src + (size_t)rt * W;
#pragma unroll
        for (int i = 0; i < RUN + K - 1; ++i) v[i] = p[(size_t)i * W];
      } else {
#pragma unroll
        for (int i = 0; i < RUN + K - 1; ++i) {
          const int r = rt + i;
          v[i] = (r >= 0 && r < H) ? src[(size_t)r * W] : 0.f;
        }
      }
#pragma unroll
      for (int o = 0; o < RUN; ++o) {
        float s = __fmul_rn(taps.w[0], v[o]);
#pragma unroll
        for (int t = 1; t < K; ++t) {
          s = __fadd_rn(s, __fmul_rn(taps.w[t], v[o + t]));
        }
        dst[o * VC] = s;
      }
    }
  }
  __syncthreads();

  // horizontal pass: row rr, output columns [c0 + HRUN * q, +HRUN)
  for (int it = tid; it < BR * NQ; it += THREADS) {
    const int rr = it / NQ, q = it - rr * NQ;
    const int r = r0 + rr;
    const int c = c0 + HRUN * q;
    if (r >= H || c >= W) continue;
    float h[4 * NV];
    const float4* row = reinterpret_cast<const float4*>(&vmid[rr][HRUN * q]);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float4 f = row[k];
      h[4 * k] = f.x;
      h[4 * k + 1] = f.y;
      h[4 * k + 2] = f.z;
      h[4 * k + 3] = f.w;
    }
    float o[HRUN];
#pragma unroll
    for (int u = 0; u < HRUN; ++u) {
      float s = __fmul_rn(taps.w[0], h[u]);
#pragma unroll
      for (int t = 1; t < K; ++t) {
        s = __fadd_rn(s, __fmul_rn(taps.w[t], h[u + t]));
      }
      o[u] = s;
    }
    float* out = y + plane + (size_t)r * W + c;
    if ((W & 3) == 0 && c + HRUN <= W) {
      *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int u = 0; u < HRUN; ++u) {
        if (c + u < W) out[u] = o[u];
      }
    }
  }
}

template <int K>
void launch(const float* x, float* y, int planes, int H, int W,
            const Taps& tp, cudaStream_t stream) {
  static_assert(2 * (K / 2) <= VC - BC, "the halo must fit the 128 columns");
  dim3 grid((W + BC - 1) / BC, (H + BR - 1) / BR, planes);
  blur_kernel<K><<<grid, THREADS, 0, stream>>>(x, y, H, W, tp);
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
  if (planes > 0 && H > 0 && W > 0) {
    switch (k) {
      case 1: launch<1>(x, y, planes, H, W, tp, stream); break;
      case 3: launch<3>(x, y, planes, H, W, tp, stream); break;
      case 5: launch<5>(x, y, planes, H, W, tp, stream); break;
      case 7: launch<7>(x, y, planes, H, W, tp, stream); break;
      case 9: launch<9>(x, y, planes, H, W, tp, stream); break;
      case 11: launch<11>(x, y, planes, H, W, tp, stream); break;
      case 13: launch<13>(x, y, planes, H, W, tp, stream); break;
      default: launch<15>(x, y, planes, H, W, tp, stream); break;
    }
  }
  return (int)cudaGetLastError();
}
