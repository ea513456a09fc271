// Kernel H: the per-Gaussian preprocess of one camera, forward, no grad.
//
// Replaces no Pallas kernel: in the JAX package the preprocess is array code
// that XLA fuses (gslm_tpu/ops/projection.py: preprocess, ops/sh.py). The
// port's plain version (ops/projection.py: preprocess, ops/sh.py: eval_sh)
// is ~420 elementwise PyTorch launches a view over all P Gaussians, with a
// concatenation of the SH coefficients and a (P, 16, 3) product in device
// memory. This kernel is one launch, a thread per Gaussian, and writes all
// eleven fields of Splats2D: the projection through world_view and
// full_proj (w + 1e-7 guard, near cull at view z 0.2), the normalized
// quaternion and Σ, the EWA 2D covariance (1.3 tanfov clamp, 0.3 px
// low-pass, antialiasing's conv_scale), the sigmoid opacity, the radius and
// the opacity-aware tile rect (to_int32's saturating cast), tile_count and
// visible (with alive), the SH colour read straight from features_dc and
// features_rest, and the sanitizing of invisible rows.
//
// Exactness: the outputs equal the plain version's on CUDA tensors bit for
// bit. Every float32 product, sum, difference and quotient is a separate
// IEEE operation in the plain version's order (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: never contracted to an FMA); sqrtf, expf, logf and
// ceilf are the IEEE library functions PyTorch's kernels call (no
// --use_fast_math). PyTorch's ``scalar / tensor`` is the tensor's
// reciprocal times the scalar, so fx = W / (2 tanfovx), 1 / (w + 1e-7),
// 1 / det and 1 / z are reciprocals here too; a Python number enters as
// the float32 it rounds to, a 0-d camera tensor as its float32. The clamps
// propagate NaN as torch.clamp does. The two reductions follow PyTorch's
// reduce kernel on the card (checked there): the vector norm of a row of 3
// (the view direction) or 4 (the quaternion) is split over two lanes of
// its block-x reduction, elements 0, 2 and 1, 3, then joined; the SH sum
// over the coefficient axis (a strided reduction, one thread an output)
// keeps four partial sums by coefficient index mod 4, then joins them in
// order.
//
// Bound on this card: bytes. A Gaussian reads 237 B (xyz, scaling,
// rotation, opacity, 48 SH floats at degree 3, alive) and writes 69 B:
// 306 B x 3,103,446 = 0.95 GB, 0.283 ms at 3.35 TB/s. The 45 floats of a
// row of features_rest (an odd stride of 45 words) are not read by each
// thread on its own: a block stages its 128 rows through shared memory with
// coalesced 16-byte loads (the block's span starts 16-byte aligned), and
// each thread reads its row there; the odd word stride keeps those reads
// free of bank conflicts (an even one is padded to odd). The camera is read
// from device memory once a block. The SH degree is a template parameter,
// so the basis and the sum unroll.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H_THREADS = 128;
constexpr int TILE = 16;

struct Gaussians {
  const float *xyz, *scaling, *rotation, *opacity, *dc, *rest;
  int rest_rows;                 // K - 1, the coefficients of rest per row
  const uint8_t* alive;          // (P,) bool or null
  const float* color_override;   // (P, 3) or null
  const float* mean2d_offset;    // (P, 2) or null
};

struct Cam {
  const float *world_view, *full_proj, *campos, *tanfovx, *tanfovy;
};

// The eleven fields, each its own allocation as the plain version's.
struct Outs {
  float *mean2d, *conic, *color, *opacity, *depth, *invdepth;
  int *radius, *rect_min, *rect_max, *tile_count;
  uint8_t* visible;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// PyTorch's reciprocal (1 / a); ``s / tensor`` multiplies it by s after.
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }

// torch.clamp(v, min=lo) with a number: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi) with tensor bounds: a NaN among them wins.
__device__ __forceinline__ float clamp_range(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// torch.nan_to_num(v, nan=0, posinf=0, neginf=0)
__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.0f;
}

// ops/projection.to_int32: NaN -> 0, saturating, then truncation.
__device__ __forceinline__ int to_int32(float x) {
  const float hi = 2147483520.0f, lo = -2147483648.0f;
  if (isnan(x)) x = 0.0f;
  else if (isinf(x)) x = x > 0.0f ? hi : lo;
  return __float2int_rz(fminf(fmaxf(x, lo), hi));
}

__device__ __forceinline__ int floor_div_tile(int a) {
  const int q = a / TILE;
  return (a % TILE != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// row r of (m @ [x, y, z, 1]) for a row-major 4x4 m, in xform's order.
__device__ __forceinline__ float xform(const float* m, int r, float x, float y,
                                       float z) {
  return add(add(add(mul(m[4 * r], x), mul(m[4 * r + 1], y)),
                 mul(m[4 * r + 2], z)),
             m[4 * r + 3]);
}

// (a, b, c) . (u, v, w) as ((a u + b v) + c w).
__device__ __forceinline__ float dot3(float a, float b, float c, float u,
                                      float v, float w) {
  return add(add(mul(a, u), mul(b, v)), mul(c, w));
}

// torch.linalg.vector_norm of a row of 3 on the card: lanes 0 and 1 of the
// block-x reduction hold x0² + x2² and x1², then join.
__device__ __forceinline__ float norm3(float x0, float x1, float x2) {
  return __fsqrt_rn(add(add(mul(x0, x0), mul(x2, x2)), mul(x1, x1)));
}

// The same of a row of 4: lanes 0 and 1 hold q0² + q2² and q1² + q3².
__device__ __forceinline__ float norm4(float q0, float q1, float q2, float q3) {
  return __fsqrt_rn(add(add(mul(q0, q0), mul(q2, q2)),
                        add(mul(q1, q1), mul(q3, q3))));
}

// sh_basis(DEG, dirs), each column in the plain version's order.
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = (float)0.28209479177387814;
  if (DEG > 0) {
    const float c1 = (float)0.4886025119029199;
    const float nc1 = (float)-0.4886025119029199;
    b[1] = mul(nc1, y);
    b[2] = mul(c1, z);
    b[3] = mul(nc1, x);
  }
  if (DEG > 1) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    b[4] = mul((float)1.0925484305920792, xy);
    b[5] = mul((float)-1.0925484305920792, yz);
    b[6] = mul((float)0.31539156525252005, sub(sub(mul(2.0f, zz), xx), yy));
    b[7] = mul((float)-1.0925484305920792, xz);
    b[8] = mul((float)0.5462742152960396, sub(xx, yy));
    if (DEG > 2) {
      const float t4 = sub(sub(mul(4.0f, zz), xx), yy);
      b[9] = mul(mul((float)-0.5900435899266435, y), sub(mul(3.0f, xx), yy));
      b[10] = mul(mul((float)2.890611442640554, xy), z);
      b[11] = mul(mul((float)-0.4570457994644658, y), t4);
      b[12] = mul(mul((float)0.3731763325901154, z),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      b[13] = mul(mul((float)-0.4570457994644658, x), t4);
      b[14] = mul(mul((float)1.445305721320277, z), sub(xx, yy));
      b[15] = mul(mul((float)-0.5900435899266435, x), sub(xx, mul(3.0f, yy)));
    }
    if (DEG > 3) {
      const float z7m1 = sub(mul(7.0f, zz), 1.0f);
      const float z7m3 = sub(mul(7.0f, zz), 3.0f);
      b[16] = mul(mul((float)2.5033429417967046, xy), sub(xx, yy));
      b[17] = mul(mul((float)-1.7701307697799304, yz),
                  sub(mul(3.0f, xx), yy));
      b[18] = mul(mul((float)0.9461746957575601, xy), z7m1);
      b[19] = mul(mul((float)-0.6690465435572892, yz), z7m3);
      b[20] = mul((float)0.10578554691520431,
                  add(mul(zz, sub(mul(35.0f, zz), 30.0f)), 3.0f));
      b[21] = mul(mul((float)-0.6690465435572892, xz), z7m3);
      b[22] = mul(mul((float)0.47308734787878004, sub(xx, yy)), z7m1);
      b[23] = mul(mul((float)-1.7701307697799304, xz),
                  sub(xx, mul(3.0f, yy)));
      b[24] = mul((float)0.6258357354491761,
                  sub(mul(xx, sub(xx, mul(3.0f, yy))),
                      mul(yy, sub(mul(3.0f, xx), yy))));
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(H_THREADS)
preprocess_kernel(Gaussians g, Cam cam, int n, int width, int height,
                  int antialiasing, float scaling_modifier, Outs out) {
  constexpr int NK = (DEG + 1) * (DEG + 1);
  extern __shared__ float4 smem4[];
  float* srest = reinterpret_cast<float*>(smem4);
  __shared__ float scam[37];
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * H_THREADS;
  const int rows = min(H_THREADS, n - row0);
  const int R = 3 * g.rest_rows;           // floats a row of rest
  const int RS = R | 1;                    // its odd stride in shared memory

  if (t < 16) scam[t] = cam.world_view[t];
  else if (t < 32) scam[t] = cam.full_proj[t - 16];
  else if (t < 35) scam[t] = cam.campos[t - 32];
  else if (t == 35) scam[35] = *cam.tanfovx;
  else if (t == 36) scam[36] = *cam.tanfovy;
  if (DEG > 0 && g.color_override == nullptr) {
    const float* src = g.rest + (size_t)row0 * R;
    const int total = rows * R;
    if (RS == R && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      // the block's span, 16 bytes a load, in its row-major order
      const float4* s4 = reinterpret_cast<const float4*>(src);
      for (int j = t; j < total / 4; j += H_THREADS) smem4[j] = __ldg(s4 + j);
      for (int j = total / 4 * 4 + t; j < total; j += H_THREADS)
        srest[j] = __ldg(src + j);
    } else {
      for (int j = t; j < total; j += H_THREADS)
        srest[(j / R) * RS + j % R] = __ldg(src + j);
    }
  }
  __syncthreads();
  if (t >= rows) return;
  const int i = row0 + t;

  const float W = (float)width, H = (float)height;
  const float* wv = scam;
  const float* fp = scam + 16;
  const float tanfx = scam[35], tanfy = scam[36];
  const float fx = mul(rcp(mul(2.0f, tanfx)), W);
  const float fy = mul(rcp(mul(2.0f, tanfy)), H);

  // ---- projection -------------------------------------------------------
  const float x = __ldg(g.xyz + 3 * i), y = __ldg(g.xyz + 3 * i + 1),
              z = __ldg(g.xyz + 3 * i + 2);
  const float tx_ = xform(wv, 0, x, y, z);
  const float ty_ = xform(wv, 1, x, y, z);
  const float tz_ = xform(wv, 2, x, y, z);
  const float hx = xform(fp, 0, x, y, z);
  const float hy = xform(fp, 1, x, y, z);
  const float hw = xform(fp, 3, x, y, z);
  const float inv_w = rcp(add(hw, (float)1e-7));
  const float p_x = mul(hx, inv_w), p_y = mul(hy, inv_w);
  const bool in_front = tz_ > (float)0.2;
  const float tz = in_front ? tz_ : 1.0f;
  float mx = mul(sub(mul(add(p_x, 1.0f), W), 1.0f), 0.5f);
  float my = mul(sub(mul(add(p_y, 1.0f), H), 1.0f), 0.5f);
  if (g.mean2d_offset != nullptr) {
    mx = add(mx, mul(__ldg(g.mean2d_offset + 2 * i), (float)(0.5 * width)));
    my = add(my, mul(__ldg(g.mean2d_offset + 2 * i + 1),
                     (float)(0.5 * height)));
  }

  // ---- Σ from scaling and the normalized quaternion ---------------------
  float qw = __ldg(g.rotation + 4 * i), qx = __ldg(g.rotation + 4 * i + 1),
        qy = __ldg(g.rotation + 4 * i + 2), qz = __ldg(g.rotation + 4 * i + 3);
  const float qn = clamp_min(norm4(qw, qx, qy, qz), (float)1e-12);
  qw = dvd(qw, qn);
  qx = dvd(qx, qn);
  qy = dvd(qy, qn);
  qz = dvd(qz, qn);
  const float r00 = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  const float r01 = mul(2.0f, sub(mul(qx, qy), mul(qw, qz)));
  const float r02 = mul(2.0f, add(mul(qx, qz), mul(qw, qy)));
  const float r10 = mul(2.0f, add(mul(qx, qy), mul(qw, qz)));
  const float r11 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  const float r12 = mul(2.0f, sub(mul(qy, qz), mul(qw, qx)));
  const float r20 = mul(2.0f, sub(mul(qx, qz), mul(qw, qy)));
  const float r21 = mul(2.0f, add(mul(qy, qz), mul(qw, qx)));
  const float r22 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
  const float s0 = mul(expf(__ldg(g.scaling + 3 * i)), scaling_modifier);
  const float s1 = mul(expf(__ldg(g.scaling + 3 * i + 1)), scaling_modifier);
  const float s2_ = mul(expf(__ldg(g.scaling + 3 * i + 2)), scaling_modifier);
  const float v0 = mul(s0, s0), v1 = mul(s1, s1), v2 = mul(s2_, s2_);
  const float sxx = dot3(mul(r00, r00), mul(r01, r01), mul(r02, r02), v0, v1, v2);
  const float sxy = dot3(mul(r00, r10), mul(r01, r11), mul(r02, r12), v0, v1, v2);
  const float sxz = dot3(mul(r00, r20), mul(r01, r21), mul(r02, r22), v0, v1, v2);
  const float syy = dot3(mul(r10, r10), mul(r11, r11), mul(r12, r12), v0, v1, v2);
  const float syz = dot3(mul(r10, r20), mul(r11, r21), mul(r12, r22), v0, v1, v2);
  const float szz = dot3(mul(r20, r20), mul(r21, r21), mul(r22, r22), v0, v1, v2);

  // ---- EWA 2D covariance ------------------------------------------------
  const float limx = mul((float)1.3, tanfx), limy = mul((float)1.3, tanfy);
  const float txz = mul(clamp_range(dvd(tx_, tz), -limx, limx), tz);
  const float tyz = mul(clamp_range(dvd(ty_, tz), -limy, limy), tz);
  const float tz2 = mul(tz, tz);
  const float j00 = dvd(fx, tz);
  const float j02 = dvd(-mul(fx, txz), tz2);
  const float j11 = dvd(fy, tz);
  const float j12 = dvd(-mul(fy, tyz), tz2);
  float T0[3], T1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T0[k] = add(mul(j00, wv[k]), mul(j02, wv[8 + k]));
    T1[k] = add(mul(j11, wv[4 + k]), mul(j12, wv[8 + k]));
  }
  const float U00 = dot3(sxx, sxy, sxz, T0[0], T0[1], T0[2]);
  const float U01 = dot3(sxy, syy, syz, T0[0], T0[1], T0[2]);
  const float U02 = dot3(sxz, syz, szz, T0[0], T0[1], T0[2]);
  const float U10 = dot3(sxx, sxy, sxz, T1[0], T1[1], T1[2]);
  const float U11 = dot3(sxy, syy, syz, T1[0], T1[1], T1[2]);
  const float U12 = dot3(sxz, syz, szz, T1[0], T1[1], T1[2]);
  const float c00 = dot3(U00, U01, U02, T0[0], T0[1], T0[2]);
  const float c01 = dot3(U00, U01, U02, T1[0], T1[1], T1[2]);
  const float c11 = dot3(U10, U11, U12, T1[0], T1[1], T1[2]);
  const float det_orig = sub(mul(c00, c11), mul(c01, c01));
  const float c00d = add(c00, (float)0.3), c11d = add(c11, (float)0.3);
  const float det = sub(mul(c00d, c11d), mul(c01, c01));
  const bool det_ok = det > 0.0f;
  const float inv_det = det_ok ? rcp(det) : 0.0f;
  float con0 = mul(c11d, inv_det), con1 = mul(-c01, inv_det),
        con2 = mul(c00d, inv_det);

  float op = rcp(add(1.0f, expf(-__ldg(g.opacity + i))));   // sigmoid
  if (antialiasing) {
    const float ratio = det_ok ? dvd(det_orig, det) : (float)1e-6;
    op = mul(op, __fsqrt_rn(clamp_min(ratio, (float)1e-6)));
  }

  // ---- screen radius and the opacity-aware tile rect --------------------
  const float mid = mul(0.5f, add(c00d, c11d));
  const float lam1 = add(mid, __fsqrt_rn(clamp_min(sub(mul(mid, mid), det),
                                                   (float)0.1)));
  const float radius_f = ceilf(mul(3.0f, __fsqrt_rn(lam1)));
  float s2 = mul(2.0f, logf(clamp_min(mul(op, 255.0f), (float)1e-12)));
  const bool opa_vis = s2 > 0.0f;
  s2 = clamp_min(s2, 0.0f);
  const float rx = add(__fsqrt_rn(mul(s2, clamp_min(c00d, 0.0f))), (float)0.01);
  const float ry = add(__fsqrt_rn(mul(s2, clamp_min(c11d, 0.0f))), (float)0.01);
  const int ntx = (width + TILE - 1) / TILE, nty = (height + TILE - 1) / TILE;
  const int tx0 = clamp_int(floor_div_tile(to_int32(sub(mx, rx))), 0, ntx);
  const int ty0 = clamp_int(floor_div_tile(to_int32(sub(my, ry))), 0, nty);
  const float inv_tile = 1.0f / TILE;      // tensor / number: its reciprocal
  const int tx1 = clamp_int(
      to_int32(mul(sub(add(add(mx, rx), (float)TILE), 1.0f), inv_tile)), 0,
      ntx);
  const int ty1 = clamp_int(
      to_int32(mul(sub(add(add(my, ry), (float)TILE), 1.0f), inv_tile)), 0,
      nty);
  int tiles = max(tx1 - tx0, 0) * max(ty1 - ty0, 0);
  bool visible = in_front && det_ok && opa_vis && radius_f > 0.0f && tiles > 0;
  if (g.alive != nullptr) visible = visible && g.alive[i] != 0;
  if (!visible) tiles = 0;

  // ---- colour -----------------------------------------------------------
  float col[3];
  if (g.color_override != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) col[c] = __ldg(g.color_override + 3 * i + c);
  } else {
    float dx = sub(x, scam[32]), dy = sub(y, scam[33]), dz = sub(z, scam[34]);
    const float dn = clamp_min(norm3(dx, dy, dz), (float)1e-12);
    dx = dvd(dx, dn);
    dy = dvd(dy, dn);
    dz = dvd(dz, dn);
    float b[NK];
    sh_basis<DEG>(dx, dy, dz, b);
    const float* row = srest + t * RS;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // torch.sum over the coefficient axis: partial sums by index mod 4
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      acc[0] = add(acc[0], mul(b[0], __ldg(g.dc + 3 * i + c)));
#pragma unroll
      for (int k = 1; k < NK; ++k)
        acc[k & 3] = add(acc[k & 3], mul(b[k], row[3 * (k - 1) + c]));
      const float sum = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
      col[c] = clamp_min(add(sum, 0.5f), 0.0f);
    }
  }

  // ---- sanitize invisible rows ------------------------------------------
  const float vis_f = visible ? 1.0f : 0.0f;
  const float hide = mul(sub(1.0f, vis_f), 1e4f);
  out.mean2d[2 * i] = sub(mul(isfinite(mx) ? mx : 0.0f, vis_f), hide);
  out.mean2d[2 * i + 1] = sub(mul(isfinite(my) ? my : 0.0f, vis_f), hide);
  out.conic[3 * i] = mul(finite_or_zero(con0), vis_f);
  out.conic[3 * i + 1] = mul(finite_or_zero(con1), vis_f);
  out.conic[3 * i + 2] = mul(finite_or_zero(con2), vis_f);
#pragma unroll
  for (int c = 0; c < 3; ++c) out.color[3 * i + c] = finite_or_zero(col[c]);
  out.opacity[i] = visible ? op : 0.0f;
  out.depth[i] = visible ? tz : INFINITY;
  out.invdepth[i] = visible ? rcp(tz) : 0.0f;
  out.radius[i] = visible ? __float2int_rz(radius_f) : 0;
  out.rect_min[2 * i] = tx0;
  out.rect_min[2 * i + 1] = ty0;
  out.rect_max[2 * i] = tx1;
  out.rect_max[2 * i + 1] = ty1;
  out.tile_count[i] = tiles;
  out.visible[i] = visible ? 1 : 0;
}

template <int DEG>
int launch(const Gaussians& g, const Cam& cam, int n, int width, int height,
           int antialiasing, float scaling_modifier, const Outs& out,
           cudaStream_t stream) {
  const int blocks = (n + H_THREADS - 1) / H_THREADS;
  const bool staged = DEG > 0 && g.color_override == nullptr;
  // at most 128 x 73 floats (degree 4), under the 48 KiB default
  const size_t shared = staged ? sizeof(float) * H_THREADS *
                                     ((3 * g.rest_rows) | 1) : 0;
  preprocess_kernel<DEG><<<blocks, H_THREADS, shared, stream>>>(
      g, cam, n, width, height, antialiasing, scaling_modifier, out);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz, scaling: (n, 3); rotation: (n, 4) wxyz; opacity: (n, 1) logits;
// features_dc: (n, 1, 3); features_rest: (n, rest_rows, 3), all float32 and
// contiguous; alive: (n,) bool or null; color_override: (n, 3) or null;
// mean2d_offset: (n, 2) or null. world_view, full_proj: (4, 4) row-major;
// campos: (3,); tanfovx, tanfovy: () float32, all on the device. degree:
// the active SH degree, 0-4, with (degree + 1)^2 - 1 <= rest_rows. Outputs
// as Splats2D: mean2d (n, 2), conic (n, 3), color (n, 3), opacity, depth,
// invdepth (n,) float32; radius (n,), rect_min, rect_max (n, 2),
// tile_count (n,) int32; visible (n,) bool. Launches on ``stream``;
// returns the first CUDA error (cudaErrorInvalidValue for a bad argument),
// or 0.
extern "C" int preprocess(
    const float* xyz, const float* scaling, const float* rotation,
    const float* opacity, const float* features_dc,
    const float* features_rest, int rest_rows, const uint8_t* alive,
    const float* color_override, const float* mean2d_offset,
    const float* world_view, const float* full_proj, const float* campos,
    const float* tanfovx, const float* tanfovy, int n, int width, int height,
    int degree, int antialiasing, float scaling_modifier, float* mean2d,
    float* conic, float* color, float* opacity_out, float* depth,
    float* invdepth, int* radius, int* rect_min, int* rect_max,
    int* tile_count, uint8_t* visible, cudaStream_t stream) {
  if (n < 0 || n > 0x7fffffff / 4 || width <= 0 || height <= 0 ||
      degree < 0 || degree > 4 || rest_rows < 0 || rest_rows > 24 ||
      (degree + 1) * (degree + 1) - 1 > rest_rows)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Gaussians g{xyz, scaling, rotation, opacity, features_dc,
                    features_rest, rest_rows, alive, color_override,
                    mean2d_offset};
  const Cam cam{world_view, full_proj, campos, tanfovx, tanfovy};
  const Outs out{mean2d, conic, color, opacity_out, depth, invdepth,
                 radius, rect_min, rect_max, tile_count, visible};
  switch (degree) {
    case 0: return launch<0>(g, cam, n, width, height, antialiasing,
                             scaling_modifier, out, stream);
    case 1: return launch<1>(g, cam, n, width, height, antialiasing,
                             scaling_modifier, out, stream);
    case 2: return launch<2>(g, cam, n, width, height, antialiasing,
                             scaling_modifier, out, stream);
    case 3: return launch<3>(g, cam, n, width, height, antialiasing,
                             scaling_modifier, out, stream);
    default: return launch<4>(g, cam, n, width, height, antialiasing,
                              scaling_modifier, out, stream);
  }
}

// out[0..2]: registers per thread, static shared memory per block (bytes)
// and resident 128-thread blocks per SM of the degree-3 instance with its
// 45-float rows staged. Returns the first CUDA error, or 0.
extern "C" int preprocess_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, preprocess_kernel<3>);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], preprocess_kernel<3>, H_THREADS, sizeof(float) * H_THREADS * 45);
}
