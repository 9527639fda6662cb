// Fused GFL dense loss (QFL + GIoU + DFL), forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/models/heads/gfl_head.py:211 `gfl_loss` (with
// ops/integral.py `integral`, losses/gfocal.py `quality_focal_loss` and
// `distribution_focal_loss`, losses/iou_loss.py `giou_loss`), which XLA
// lowers on the TPU to dense (B*N, C) and (B*N, 4, reg_max + 1) passes.
// ops/gfl_loss.py holds the formulas and the plain version.
//
// Bound on this card: bytes. Every row's class logits, label, label
// weight and positive flag are read by the forward and again by the
// backward, which writes both gradients; the distribution logits and the
// box targets of a row matter only where the row is positive (elsewhere
// its IoU quality is 0 and its GIoU and DFL terms carry the weight 0), so
// only positive rows' are read. At B = 16, N = 22400 and 40 classes that
// is ~280 MB, ~84 us at 3.35 TB/s; ~2 kflop a row stay far below the
// float32 peak.
//
// Design. A warp owns 8 consecutive rows, a lane one (row, side) pair:
//   * the class part: lane s of a row takes the 16-byte chunks s, s + 4,
//     ... of its classes (single classes s, s + 4, ... where C or the row
//     stride is not a multiple of 4): their sigmoid, softplus and QFL
//     term (the gradient in the backward), the row's largest sigmoid by
//     quad shuffles. Classes are read with the row stride of the class
//     map (a slice of a wider map is read in place), the gradient is
//     written (B, N, C) contiguous;
//   * the geometry runs only in a warp that holds a positive row: each
//     lane softmaxes its side's reg_max + 1 bins (read three times from
//     L1, no padded lanes), the four lanes of a row exchange their corners
//     by quad shuffles and each computes the decoded box, the IoU quality
//     and GIoU; the lane's side gives the DFL term, and in the backward
//     its bins' gradient. A warp with no positive row writes its 8 rows'
//     distribution gradient as zeros in 16-byte stores;
//   * the forward keeps per-thread partial sums, reduces them by warp
//     shuffles and per block in a fixed order, and a one-block second
//     pass adds the blocks' partials in a fixed order and forms the three
//     losses and the two normalisers, which the backward reads from the
//     device: deterministic, no atomics.
// Semantics: quality and weights detached; max / min split an exact tie
// 1/2 : 1/2 as jax.lax.max does; qfl_beta = 2 is specialised, any other
// positive beta takes the general powers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* cls;
  long long cls_stride;
  const float* reg;
  const int64_t* labels;
  const float* lw;
  const float* bt;
  const uint8_t* pos;
  const float* centers;
  const float* strides;
  long long m;  // rows, B * N
  int n, c, nb;
  float dmax, beta, qfl_w, bbox_w, dfl_w, eps;
};

// share of a in d max(a, b) (and of the smaller in d min): 1, 1/2 or 0
__device__ __forceinline__ float share_gt(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

// x ** beta for x >= 0 (0 at 0)
template <bool kBeta2>
__device__ __forceinline__ float powb(float x, float beta) {
  if (kBeta2) return x * x;
  return x > 0.f ? __expf(beta * __logf(x)) : 0.f;
}

// One row's class logit: sigmoid s, softplus sp = log(1 + e^x), relu and
// log1p(e^-|x|), from one exp (the log1p by log(u) * (e / (u - 1)), exact
// where u rounds to 1).
struct Logit {
  float s, sp, relu, l1p;
};

__device__ __forceinline__ Logit logit(float x) {
  const float ex = __expf(-fabsf(x));
  const float u = 1.f + ex;
  const float r = __fdividef(1.f, u);
  Logit o;
  o.s = x >= 0.f ? r : ex * r;
  o.l1p = u == 1.f ? ex : __logf(u) * __fdividef(ex, u - 1.f);
  o.relu = fmaxf(x, 0.f);
  o.sp = o.relu + o.l1p;
  return o;
}

// One class logit's QFL term (onehot: the row's label class), with the
// running largest sigmoid.
template <bool kBeta2>
__device__ __forceinline__ float qfl_term(float x, bool onehot, float q,
                                          float beta, float& smax) {
  const Logit o = logit(x);
  smax = fmaxf(smax, o.s);
  if (onehot)
    return (o.relu - x * q + o.l1p) * powb<kBeta2>(fabsf(q - o.s), beta);
  return o.sp * powb<kBeta2>(o.s, beta);
}

// d/dx of the QFL term: of sp * s^b, and of bce(x, q) * |q - s|^b
template <bool kBeta2>
__device__ __forceinline__ float qfl_grad(float x, bool onehot, float q,
                                          float beta, float& smax) {
  const Logit o = logit(x);
  smax = fmaxf(smax, o.s);
  const float sig = o.s * (1.f - o.s);
  if (onehot) {
    const float bce_q = o.relu - x * q + o.l1p;
    const float dsq = o.s - q;
    const float dq = fabsf(dsq);
    if (kBeta2) return dsq * (dq * dq) + bce_q * 2.f * dsq * sig;
    const float sgn = dsq > 0.f ? 1.f : (dsq < 0.f ? -1.f : 0.f);
    const float dpow = dq > 0.f ? __expf((beta - 1.f) * __logf(dq)) : 0.f;
    return dsq * powb<false>(dq, beta) + bce_q * beta * dpow * sgn * sig;
  }
  const float b = kBeta2 ? 2.f : beta;
  return powb<kBeta2>(o.s, beta) * (o.s + b * o.sp * (1.f - o.s));
}

// The geometry of one row, as every lane of its quad computes it.
struct Geo {
  float corner, lse, mx, se;               // own side's softmax
  float px1, py1, px2, py2, tx1, ty1, tx2, ty2;
  float wp, hp, iw, ih, ov, u0, uni, ex1, ey1, ex2, ey2, ew, eh, ea0, ea;
  float q, giou;
  float wl, wr;                            // own side's DFL target weights
  int dli, dri;
};

__device__ __forceinline__ Geo geometry(const Params& p, long long row,
                                        int side) {
  Geo g;
  const int a = static_cast<int>(row % p.n);
  const float st = p.strides[a];
  const float cx = p.centers[2 * a] / st;
  const float cy = p.centers[2 * a + 1] / st;
  const float* t = p.bt + row * 4;
  g.tx1 = t[0] / st;
  g.ty1 = t[1] / st;
  g.tx2 = t[2] / st;
  g.ty2 = t[3] / st;

  const float* x = p.reg + (row * 4 + side) * p.nb;
  float mx = -INFINITY;
  for (int j = 0; j < p.nb; ++j) mx = fmaxf(mx, x[j]);
  float se = 0.f, sj = 0.f;
  for (int j = 0; j < p.nb; ++j) {
    const float e = __expf(x[j] - mx);
    se += e;
    sj += e * static_cast<float>(j);
  }
  g.mx = mx;
  g.se = se;
  g.corner = sj / se;
  g.lse = mx + __logf(se);

  const int base = (threadIdx.x & 31) & ~3;
  const float c0 = __shfl_sync(kFull, g.corner, base);
  const float c1 = __shfl_sync(kFull, g.corner, base + 1);
  const float c2 = __shfl_sync(kFull, g.corner, base + 2);
  const float c3 = __shfl_sync(kFull, g.corner, base + 3);
  g.px1 = cx - c0;
  g.py1 = cy - c1;
  g.px2 = cx + c2;
  g.py2 = cy + c3;

  // IoU quality (eps 1e-6) and the GIoU terms (eps 1e-7)
  g.wp = fmaxf(g.px2 - g.px1, 0.f);
  g.hp = fmaxf(g.py2 - g.py1, 0.f);
  const float ap = g.wp * g.hp;
  const float at = fmaxf(g.tx2 - g.tx1, 0.f) * fmaxf(g.ty2 - g.ty1, 0.f);
  g.iw = fmaxf(fminf(g.px2, g.tx2) - fmaxf(g.px1, g.tx1), 0.f);
  g.ih = fmaxf(fminf(g.py2, g.ty2) - fmaxf(g.py1, g.ty1), 0.f);
  g.ov = g.iw * g.ih;
  g.u0 = ap + at - g.ov;
  g.q = g.ov / fmaxf(g.u0, 1e-6f);
  g.uni = fmaxf(g.u0, 1e-7f);
  g.ex1 = fminf(g.px1, g.tx1);
  g.ey1 = fminf(g.py1, g.ty1);
  g.ex2 = fmaxf(g.px2, g.tx2);
  g.ey2 = fmaxf(g.py2, g.ty2);
  g.ew = fmaxf(g.ex2 - g.ex1, 0.f);
  g.eh = fmaxf(g.ey2 - g.ey1, 0.f);
  g.ea0 = g.ew * g.eh;
  g.ea = fmaxf(g.ea0, 1e-7f);
  g.giou = g.ov / g.uni - (g.ea - g.uni) / g.ea;

  // DFL target of the lane's side
  const float d = side == 0 ? cx - g.tx1
                : side == 1 ? cy - g.ty1
                : side == 2 ? g.tx2 - cx
                            : g.ty2 - cy;
  const float tt = fminf(fmaxf(d, 0.f), p.dmax);
  const float dl = floorf(tt);
  g.wl = dl + 1.f - tt;
  g.wr = tt - dl;
  const int di = static_cast<int>(dl);
  g.dli = min(max(di, 0), p.nb - 1);
  g.dri = min(max(di + 1, 0), p.nb - 1);
  return g;
}

// kVec: C and the class map's row stride are multiples of 4 and the map
// 16-byte aligned, so that the classes go in 16-byte chunks
template <bool kBeta2, bool kVec>
__global__ void __launch_bounds__(kThreads)
gfl_loss_rows_kernel(Params p, float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int side = lane & 3;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                        warp * kRowsPerWarp + (lane >> 2);
  const bool live = row < p.m;
  const bool pos = live && p.pos[row] != 0;
  const int lab = live ? static_cast<int>(p.labels[row]) : -1;
  const float lw = live ? p.lw[row] : 0.f;

  float q = 0.f, giou = 0.f, dfl = 0.f;
  if (__any_sync(kFull, pos)) {
    // every lane of the warp takes part in the quad shuffles; rows that
    // are not positive (or past the end) keep none of it
    const Geo g = geometry(p, live ? row : 0, side);
    if (pos) {
      const float* x = p.reg + ((live ? row : 0) * 4 + side) * p.nb;
      q = g.q;
      giou = g.giou;
      dfl = g.wl * (g.lse - x[g.dli]) + g.wr * (g.lse - x[g.dri]);
    }
  }

  float qfl = 0.f, smax = -INFINITY;
  if (live && kVec) {
    // lane s takes the 16-byte chunks s, s + 4, ... of its row
    const float4* x4 =
        reinterpret_cast<const float4*>(p.cls + row * p.cls_stride);
#pragma unroll 2
    for (int j = side; j < p.c / 4; j += 4) {
      const float4 v = x4[j];
      qfl += qfl_term<kBeta2>(v.x, 4 * j == lab, q, p.beta, smax);
      qfl += qfl_term<kBeta2>(v.y, 4 * j + 1 == lab, q, p.beta, smax);
      qfl += qfl_term<kBeta2>(v.z, 4 * j + 2 == lab, q, p.beta, smax);
      qfl += qfl_term<kBeta2>(v.w, 4 * j + 3 == lab, q, p.beta, smax);
    }
  } else if (live) {
    const float* xr = p.cls + row * p.cls_stride;
#pragma unroll 4
    for (int c = side; c < p.c; c += 4)
      qfl += qfl_term<kBeta2>(xr[c], c == lab, q, p.beta, smax);
  }
  smax = quad_max(smax);
  const float wt = pos ? smax : 0.f;
  float acc[4] = {qfl * lw, (pos && side == 0) ? (1.f - giou) * wt : 0.f,
                  pos ? dfl * wt : 0.f, side == 0 ? wt : 0.f};

  __shared__ float warp_part[kWarps][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += warp_part[w][threadIdx.x];
    part[blockIdx.x * 4 + threadIdx.x] = v;
  }
}

// One block: the blocks' partials in a fixed order; out = (loss_cls,
// loss_bbox, loss_dfl, avg_cls, avg_reg).
__global__ void __launch_bounds__(kThreads)
gfl_loss_reduce_kernel(const float* __restrict__ part, int nblk,
                       const float* __restrict__ num_pos, float qfl_w,
                       float bbox_w, float dfl_w, float eps,
                       float* __restrict__ out) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < nblk; i += kThreads)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += part[i * 4 + k];
  __shared__ float warp_part[kWarps][4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < kWarps; ++w)
      for (int k = 0; k < 4; ++k) s[k] += warp_part[w][k];
    const float avg_cls = fmaxf(*num_pos, 1.f);
    const float avg_reg = fmaxf(s[3], 1.f);
    out[0] = qfl_w * (s[0] / (avg_cls + eps));
    out[1] = bbox_w * s[1] / avg_reg;
    out[2] = dfl_w * s[2] / (4.f + eps) / avg_reg;
    out[3] = avg_cls;
    out[4] = avg_reg;
  }
}

template <bool kBeta2, bool kVec>
__global__ void __launch_bounds__(kThreads)
gfl_loss_backward_kernel(Params p, const float* __restrict__ gout,
                         const float* __restrict__ stats,
                         float* __restrict__ gcls, float* __restrict__ greg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int side = lane & 3;
  const long long group = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long row = group * kRowsPerWarp + (lane >> 2);
  const bool live = row < p.m;
  const bool pos = live && p.pos[row] != 0;
  const int lab = live ? static_cast<int>(p.labels[row]) : -1;
  const float lw = live ? p.lw[row] : 0.f;
  const float avg_cls = stats[3];
  const float avg_reg = stats[4];
  const float kc = gout[0] * (p.qfl_w / (avg_cls + p.eps));
  const float kb = gout[1] * p.bbox_w / avg_reg;
  const float kd = gout[2] * p.dfl_w / (4.f + p.eps) / avg_reg;
  const bool any_pos = __any_sync(kFull, pos);

  Geo g;
  float q = 0.f;
  if (any_pos) {
    g = geometry(p, live ? row : 0, side);
    if (pos) q = g.q;
  }

  // class logits: the gradient, written (B, N, C) contiguous
  float smax = -INFINITY;
  const float kcl = kc * lw;
  if (live && kVec) {
    const float4* x4 =
        reinterpret_cast<const float4*>(p.cls + row * p.cls_stride);
    float4* g4 = reinterpret_cast<float4*>(gcls + row * p.c);
#pragma unroll 2
    for (int j = side; j < p.c / 4; j += 4) {
      const float4 v = x4[j];
      float4 d;
      d.x = qfl_grad<kBeta2>(v.x, 4 * j == lab, q, p.beta, smax) * kcl;
      d.y = qfl_grad<kBeta2>(v.y, 4 * j + 1 == lab, q, p.beta, smax) * kcl;
      d.z = qfl_grad<kBeta2>(v.z, 4 * j + 2 == lab, q, p.beta, smax) * kcl;
      d.w = qfl_grad<kBeta2>(v.w, 4 * j + 3 == lab, q, p.beta, smax) * kcl;
      g4[j] = d;
    }
  } else if (live) {
    const float* xr = p.cls + row * p.cls_stride;
    float* gr = gcls + row * p.c;
#pragma unroll 4
    for (int c = side; c < p.c; c += 4)
      gr[c] = qfl_grad<kBeta2>(xr[c], c == lab, q, p.beta, smax) * kcl;
  }

  float* gw = greg + group * kRowsPerWarp * 4 * p.nb;
  if (!any_pos) {
    // 8 rows of 4 * nb floats: 8 * nb float4, 16-byte aligned
    const long long total4 = p.m * p.nb;  // float4 in greg
    float4* g4 = reinterpret_cast<float4*>(gw);
    const long long first = group * kRowsPerWarp * p.nb;
    for (int i = lane; i < kRowsPerWarp * p.nb; i += 32)
      if (first + i < total4) g4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  smax = quad_max(smax);
  if (!live) return;
  float* out = greg + (row * 4 + side) * p.nb;
  if (!pos) {
    for (int j = 0; j < p.nb; ++j) out[j] = 0.f;
    return;
  }
  const float wt = smax;

  // GIoU backward
  const float gg = -(kb * wt);
  const float g_uni = gg * (1.f / g.ea - g.ov / (g.uni * g.uni));
  float g_ov = gg / g.uni;
  const float g_ea = -gg * g.uni / (g.ea * g.ea);
  const float g_u0 = g_uni * share_gt(g.u0, 1e-7f);
  const float g_ap = g_u0;
  g_ov = g_ov - g_u0;
  const float g_ea0 = g_ea * share_gt(g.ea0, 1e-7f);
  const float g_dxe = g_ea0 * g.eh * share_gt(g.ex2 - g.ex1, 0.f);
  const float g_dye = g_ea0 * g.ew * share_gt(g.ey2 - g.ey1, 0.f);
  const float dxi = fminf(g.px2, g.tx2) - fmaxf(g.px1, g.tx1);
  const float dyi = fminf(g.py2, g.ty2) - fmaxf(g.py1, g.ty1);
  const float g_dxi = g_ov * g.ih * share_gt(dxi, 0.f);
  const float g_dyi = g_ov * g.iw * share_gt(dyi, 0.f);
  const float g_dxp = g_ap * g.hp * share_gt(g.px2 - g.px1, 0.f);
  const float g_dyp = g_ap * g.wp * share_gt(g.py2 - g.py1, 0.f);
  // share of p in min(p, t) and in max(p, t)
  const float lo_x1 = share_gt(g.tx1, g.px1);
  const float lo_y1 = share_gt(g.ty1, g.py1);
  const float lo_x2 = share_gt(g.tx2, g.px2);
  const float lo_y2 = share_gt(g.ty2, g.py2);
  float g_corner;
  if (side == 0)
    g_corner = g_dxe * lo_x1 + g_dxi * (1.f - lo_x1) + g_dxp;
  else if (side == 1)
    g_corner = g_dye * lo_y1 + g_dyi * (1.f - lo_y1) + g_dyp;
  else if (side == 2)
    g_corner = g_dxe * (1.f - lo_x2) + g_dxi * lo_x2 + g_dxp;
  else
    g_corner = g_dye * (1.f - lo_y2) + g_dyi * lo_y2 + g_dyp;

  const float* x = p.reg + (row * 4 + side) * p.nb;
  const float inv = 1.f / g.se;
  const float kdw = kd * wt;
  for (int j = 0; j < p.nb; ++j) {
    const float pj = __expf(x[j] - g.mx) * inv;
    const float jf = static_cast<float>(j);
    const float g_int = pj * (jf - g.corner) * g_corner;
    const float hit = (j == g.dli ? g.wl : 0.f) + (j == g.dri ? g.wr : 0.f);
    out[j] = g_int + ((g.wl + g.wr) * pj - hit) * kdw;
  }
}

Params make_params(const void* cls, long long cls_stride, const void* reg,
                   const void* labels, const void* lw, const void* bt,
                   const void* pos, const void* centers, const void* strides,
                   int batch, int n, int c, int nb, float beta, float qfl_w,
                   float bbox_w, float dfl_w, float eps) {
  Params p;
  p.cls = static_cast<const float*>(cls);
  p.cls_stride = cls_stride;
  p.reg = static_cast<const float*>(reg);
  p.labels = static_cast<const int64_t*>(labels);
  p.lw = static_cast<const float*>(lw);
  p.bt = static_cast<const float*>(bt);
  p.pos = static_cast<const uint8_t*>(pos);
  p.centers = static_cast<const float*>(centers);
  p.strides = static_cast<const float*>(strides);
  p.m = static_cast<long long>(batch) * n;
  p.n = n;
  p.c = c;
  p.nb = nb;
  p.dmax = static_cast<float>(nb - 1) - 0.1f;
  p.beta = beta;
  p.qfl_w = qfl_w;
  p.bbox_w = bbox_w;
  p.dfl_w = dfl_w;
  p.eps = eps;
  return p;
}

// whether the classes can go in 16-byte chunks (kVec)
bool vectorized(const void* cls, long long cls_stride, int c) {
  return c % 4 == 0 && cls_stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(cls) % 16 == 0;
}

typedef void (*RowsKernel)(Params, float*);
typedef void (*BackwardKernel)(Params, const float*, const float*, float*,
                               float*);

RowsKernel rows_kernel(bool beta2, bool vec) {
  if (beta2)
    return vec ? gfl_loss_rows_kernel<true, true>
               : gfl_loss_rows_kernel<true, false>;
  return vec ? gfl_loss_rows_kernel<false, true>
             : gfl_loss_rows_kernel<false, false>;
}

BackwardKernel backward_kernel(bool beta2, bool vec) {
  if (beta2)
    return vec ? gfl_loss_backward_kernel<true, true>
               : gfl_loss_backward_kernel<true, false>;
  return vec ? gfl_loss_backward_kernel<false, true>
             : gfl_loss_backward_kernel<false, false>;
}

}  // namespace

// Blocks of the row kernels (the forward's partials are (blocks, 4)).
extern "C" long long erd_gfl_loss_blocks(int batch, int n) {
  const long long m = static_cast<long long>(batch) * n;
  return (m + kRowsPerBlock - 1) / kRowsPerBlock;
}

// cls (B, N, C) fp32 with row stride cls_stride (class dim contiguous);
// reg (B, N, 4 * nb) fp32 contiguous; labels (B, N) int64; lw (B, N)
// fp32; bt (B, N, 4) fp32; pos (B, N) uint8; centers (N, 2), strides (N,)
// fp32; num_pos () fp32; part (blocks, 4) fp32 scratch; out (5,) fp32:
// loss_cls, loss_bbox, loss_dfl, avg_cls, avg_reg.
extern "C" int erd_gfl_loss_forward(
    const void* cls, long long cls_stride, const void* reg,
    const void* labels, const void* lw, const void* bt, const void* pos,
    const void* centers, const void* strides, const void* num_pos,
    int batch, int n, int c, int nb, float beta, float qfl_w, float bbox_w,
    float dfl_w, float eps, void* part, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p = make_params(cls, cls_stride, reg, labels, lw, bt, pos,
                               centers, strides, batch, n, c, nb, beta,
                               qfl_w, bbox_w, dfl_w, eps);
  const long long blocks = erd_gfl_loss_blocks(batch, n);
  if (blocks > 0) {
    rows_kernel(beta == 2.f, vectorized(cls, cls_stride, c))<<<
        static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, static_cast<float*>(part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gfl_loss_reduce_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<int>(blocks),
      static_cast<const float*>(num_pos), qfl_w, bbox_w, dfl_w, eps,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The forward's arguments less num_pos, part and out; gout (3,) fp32, the
// losses' gradients; stats, the forward's out; writes gcls (B, N, C) and
// greg (B, N, 4 * nb) fp32, both contiguous.
extern "C" int erd_gfl_loss_backward(
    const void* cls, long long cls_stride, const void* reg,
    const void* labels, const void* lw, const void* bt, const void* pos,
    const void* centers, const void* strides, const void* gout,
    const void* stats, int batch, int n, int c, int nb, float beta,
    float qfl_w, float bbox_w, float dfl_w, float eps, void* gcls,
    void* greg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p = make_params(cls, cls_stride, reg, labels, lw, bt, pos,
                               centers, strides, batch, n, c, nb, beta,
                               qfl_w, bbox_w, dfl_w, eps);
  const long long blocks = erd_gfl_loss_blocks(batch, n);
  if (blocks == 0) return 0;
  backward_kernel(beta == 2.f, vectorized(cls, cls_stride, c))<<<
      static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      p, static_cast<const float*>(gout), static_cast<const float*>(stats),
      static_cast<float*>(gcls), static_cast<float*>(greg));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
