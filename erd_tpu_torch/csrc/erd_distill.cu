// Fused ERD distillation loss (L2 on the ERS-selected old-class logits,
// KD-KL on the NMS-kept distribution logits, per image), forward and
// backward, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/models/detectors/gfl_erd.py:178 `distill_single` (with
// erd_tpu/losses/kd_loss.py `l2_response_loss` and
// `knowledge_distillation_kl_div_loss`), vmapped over the batch, which XLA
// lowers on the TPU to dense (B, N, C) and (B, N, 4, reg_max + 1) passes.
// ops/erd_distill.py holds the formulas and the plain version.
//
// Bound on this card: bytes. A row matters only where one of its two masks
// is set (a few per cent of the rows): the forward reads the two mask
// bytes of every row and the logits of selected rows only; the backward
// reads the same again and writes the gradient of the whole student class
// map (the columns past C are zeros) and of the distribution logits, for
// every row. At B = 16, N = 22400, an 80-wide map: ~0.21 GB, ~0.065 ms at
// 3.35 TB/s, nearly all of it the backward's dense writes.
//
// Design. A warp owns 8 consecutive rows, a lane one (row, side) pair:
//   * the warp reads its 8 rows' mask bytes; where no row is selected it
//     skips every logit load and transcendental (the forward adds nothing,
//     the backward writes the 8 rows' gradients as 16-byte zeros);
//   * the class part: lane s of a row takes the 16-byte chunks s, s + 4,
//     ... of its first C classes (single classes where C, the map's row
//     stride or its width is not a multiple of 4), read in place through
//     the map's row stride: the squared differences on ERS-cls rows, and
//     on kept rows the largest logit by quad shuffles, whose sigmoid is
//     the detached weight w;
//   * the distribution part (kept rows only) is taken a kept row at a
//     time by the whole warp: lane l holds side l / 8 and the bins l % 8,
//     l % 8 + 8, ... of it, times 1 / T (no division a bin), and the
//     eight lanes of a side reduce the softmaxes' maxima and sums by
//     shuffles; the KL term takes log(target) as the teacher's
//     log-softmax (0 * log 0 = 0). Most warps hold one kept row: a lane
//     walking its own side's bins would leave 7 of 8 lanes idle;
//   * the forward keeps per-thread partials (squared sum, ERS-cls rows,
//     w * KD), reduces them by warp shuffles and per block in a fixed
//     order into per-(image, block) partials, and a second pass, a block
//     an image, adds them in a fixed order and forms l_cls, l_reg and the
//     normaliser max(C * rows, 1), which the backward reads from the
//     device: deterministic, no atomics;
//   * the backward recomputes each selected row's values and writes the
//     gradient of the whole (B, N, width) class map, so that autograd
//     adds no zero-fill and no slice copy around the call; it writes a
//     warp's 8 rows of distribution gradient as 16-byte zeros and then a
//     kept row's 68 values over them, by the whole warp.
// Semantics: the teacher and w are detached; l_reg = ld_weight * sum(w *
// KD) / (4 + eps), KD = T^2 * the mean over the bins of the KL terms.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* s_cls;
  long long cls_stride;
  const float* s_reg;
  const float* t_cls;
  const float* t_reg;
  const uint8_t* cm;
  const uint8_t* kept;
  long long m;  // rows, B * N
  int n, c, nb;
  float t, inv_t, ld_weight, eps;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The first C class logits of a selected row: the squared differences to
// the teacher's (ERS-cls rows) and the largest student logit.
template <bool kVec>
__device__ __forceinline__ void class_terms(const Params& p, long long row,
                                            int side, bool sel_c, float& sq,
                                            float& xmax) {
  const float* s = p.s_cls + row * p.cls_stride;
  const float* t = p.t_cls + row * p.c;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* t4 = reinterpret_cast<const float4*>(t);
    for (int j = side; j < p.c / 4; j += 4) {
      const float4 v = s4[j];
      xmax = fmaxf(xmax, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      if (sel_c) {
        const float4 u = t4[j];
        const float dx = v.x - u.x, dy = v.y - u.y;
        const float dz = v.z - u.z, dw = v.w - u.w;
        sq += dx * dx + dy * dy + dz * dz + dw * dw;
      }
    }
  } else {
    for (int j = side; j < p.c; j += 4) {
      const float v = s[j];
      xmax = fmaxf(xmax, v);
      if (sel_c) {
        const float d = v - t[j];
        sq += d * d;
      }
    }
  }
}

// A kept row's distribution part is taken by the whole warp: lane l holds
// side l / 8 and the bins l % 8, l % 8 + 8, ... of it, and the eight lanes
// of a side reduce by shuffles (a row is 8x the work of a lane that would
// walk its side's bins alone, and most warps hold one kept row).
__device__ __forceinline__ float group8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 4));
}

__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v + __shfl_xor_sync(kFull, v, 4);
}

// The softmaxes of the lane's side of a kept row, on the logits times 1 / T:
// student and teacher maxima and sums of exps, for every lane of the side.
struct Side {
  const float* xs;
  const float* xt;
  float ms, ss, mt, st;
};

__device__ __forceinline__ Side side_softmax(const Params& p, long long row,
                                             int lane) {
  Side o;
  o.xs = p.s_reg + (row * 4 + (lane >> 3)) * p.nb;
  o.xt = p.t_reg + (row * 4 + (lane >> 3)) * p.nb;
  o.ms = -INFINITY;
  o.mt = -INFINITY;
  for (int j = lane & 7; j < p.nb; j += 8) {
    o.ms = fmaxf(o.ms, o.xs[j] * p.inv_t);
    o.mt = fmaxf(o.mt, o.xt[j] * p.inv_t);
  }
  o.ms = group8_max(o.ms);
  o.mt = group8_max(o.mt);
  o.ss = 0.f;
  o.st = 0.f;
  for (int j = lane & 7; j < p.nb; j += 8) {
    o.ss += expf(o.xs[j] * p.inv_t - o.ms);
    o.st += expf(o.xt[j] * p.inv_t - o.mt);
  }
  o.ss = group8_sum(o.ss);
  o.st = group8_sum(o.st);
  return o;
}

// The lane's bins' share of T^2 * mean over the bins of tgt * (log tgt -
// log p) (the teacher's log-softmax for log tgt: 0 * log 0 = 0)
__device__ __forceinline__ float row_kd_part(const Params& p, long long row,
                                             int lane) {
  const Side o = side_softmax(p, row, lane);
  const float lss = logf(o.ss), lst = logf(o.st);
  const float inv_st = 1.f / o.st;
  float kl = 0.f;
  for (int j = lane & 7; j < p.nb; j += 8) {
    const float yt = o.xt[j] * p.inv_t - o.mt;
    const float tgt = expf(yt) * inv_st;
    kl += tgt * ((yt - lst) - (o.xs[j] * p.inv_t - o.ms - lss));
  }
  return kl / static_cast<float>(p.nb) * (p.t * p.t);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
erd_distill_rows_kernel(Params p, float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int side = lane & 3;
  const int b = blockIdx.y;
  const int r = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + (lane >> 2);
  const bool live = r < p.n;
  const long long row = static_cast<long long>(b) * p.n + (live ? r : 0);
  const bool sel_c = live && p.cm[row] != 0;
  const bool sel_k = live && p.kept[row] != 0;

  float acc[3] = {0.f, 0.f, 0.f};
  if (__any_sync(kFull, sel_c || sel_k)) {
    float sq = 0.f, xmax = -INFINITY;
    if (sel_c || sel_k) class_terms<kVec>(p, row, side, sel_c, sq, xmax);
    xmax = quad_max(xmax);
    const float w = sel_k ? sigmoid(xmax) : 0.f;
    acc[0] = sq;
    acc[1] = (sel_c && side == 0) ? 1.f : 0.f;
    // the kept rows one after another, each by the whole warp
    for (unsigned kr = __ballot_sync(kFull, sel_k && side == 0); kr;
         kr &= kr - 1) {
      const int src = __ffs(kr) - 1;
      acc[2] += __shfl_sync(kFull, w, src) *
                row_kd_part(p, __shfl_sync(kFull, row, src), lane);
    }
  }

  __shared__ float warp_part[kWarps][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += warp_part[w][threadIdx.x];
    part[(static_cast<long long>(b) * gridDim.x + blockIdx.x) * 3 +
         threadIdx.x] = v;
  }
}

// A block an image: its blocks' partials in a fixed order; out (B, 2) =
// (l_cls, l_reg), den (B,) = max(C * rows, 1).
__global__ void __launch_bounds__(kThreads)
erd_distill_reduce_kernel(const float* __restrict__ part, int nblk, int c,
                          float ld_weight, float eps, float* __restrict__ out,
                          float* __restrict__ den) {
  const int b = blockIdx.x;
  const float* pb = part + static_cast<long long>(b) * nblk * 3;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < nblk; i += kThreads)
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] += pb[i * 3 + k];
  __shared__ float warp_part[kWarps][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s[3] = {0.f, 0.f, 0.f};
    for (int w = 0; w < kWarps; ++w)
      for (int k = 0; k < 3; ++k) s[k] += warp_part[w][k];
    const float d = fmaxf(s[1] * static_cast<float>(c), 1.f);
    out[b * 2] = s[0] / d;
    out[b * 2 + 1] = ld_weight * s[2] / (4.f + eps);
    den[b] = d;
  }
}

// count floats from base (16-byte aligned) set to zero by one warp
__device__ __forceinline__ void zero_span(float* base, long long count,
                                          int lane) {
  float4* b4 = reinterpret_cast<float4*>(base);
  const long long n4 = count >> 2;
  for (long long i = lane; i < n4; i += 32)
    b4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = (n4 << 2) + lane; i < count; i += 32) base[i] = 0.f;
}

// Rows are taken over the whole batch (a warp's 8 rows may straddle two
// images), so that a warp's gradient rows are one 16-byte aligned span.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
erd_distill_backward_kernel(Params p, const float* __restrict__ gout,
                            const float* __restrict__ den, int width,
                            float* __restrict__ gcls,
                            float* __restrict__ greg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int side = lane & 3;
  const long long group = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long first = group * kRowsPerWarp;
  if (first >= p.m) return;  // whole warp
  const long long row = first + (lane >> 2);
  const bool live = row < p.m;
  const bool sel_c = live && p.cm[row] != 0;
  const bool sel_k = live && p.kept[row] != 0;
  const long long rows = p.m - first < kRowsPerWarp ? p.m - first
                                                    : kRowsPerWarp;
  // the distribution gradient of the warp's rows: zeros, as 16-byte
  // stores; a kept row's are written over below
  zero_span(greg + first * 4 * p.nb, rows * 4 * p.nb, lane);
  if (!__any_sync(kFull, sel_c || sel_k)) {
    zero_span(gcls + first * width, rows * width, lane);
    return;
  }
  const int b = live ? static_cast<int>(row / p.n) : 0;
  const long long r = live ? row : 0;

  // the largest student logit of kept rows (w, detached)
  float sq = 0.f, xmax = -INFINITY;
  if (sel_k) class_terms<kVec>(p, r, side, false, sq, xmax);
  xmax = quad_max(xmax);
  const float w = sel_k ? sigmoid(xmax) : 0.f;

  // class gradient, the whole width (zeros past C and on other rows)
  if (live) {
    const float kc = sel_c ? 2.f * gout[b * 2] / den[b] : 0.f;
    const float* s = p.s_cls + r * p.cls_stride;
    const float* t = p.t_cls + r * p.c;
    float* gc = gcls + r * width;
    if (kVec) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
      const float4* t4 = reinterpret_cast<const float4*>(t);
      float4* g4 = reinterpret_cast<float4*>(gc);
      for (int j = side; j < width / 4; j += 4) {
        float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
        if (sel_c && j < p.c / 4) {
          const float4 v = s4[j];
          const float4 u = t4[j];
          d = make_float4((v.x - u.x) * kc, (v.y - u.y) * kc,
                          (v.z - u.z) * kc, (v.w - u.w) * kc);
        }
        g4[j] = d;
      }
    } else {
      for (int j = side; j < width; j += 4)
        gc[j] = (sel_c && j < p.c) ? (s[j] - t[j]) * kc : 0.f;
    }
  }

  // the kept rows' distribution gradient, a row by the whole warp, over
  // the zeros (ordered after them by the warp barrier)
  __syncwarp();
  for (unsigned kr = __ballot_sync(kFull, sel_k && side == 0); kr;
       kr &= kr - 1) {
    const int src = __ffs(kr) - 1;
    const long long krow = __shfl_sync(kFull, r, src);
    const int kb = __shfl_sync(kFull, b, src);
    const Side o = side_softmax(p, krow, lane);
    const float inv_ss = 1.f / o.ss, inv_st = 1.f / o.st;
    float st = 0.f;
    for (int j = lane & 7; j < p.nb; j += 8)
      st += expf(o.xt[j] * p.inv_t - o.mt) * inv_st;
    st = group8_sum(st);
    const float k = gout[kb * 2 + 1] * p.ld_weight / (4.f + p.eps) * p.t /
                    static_cast<float>(p.nb) * __shfl_sync(kFull, w, src);
    float* out = greg + (krow * 4 + (lane >> 3)) * p.nb;
    for (int j = lane & 7; j < p.nb; j += 8) {
      const float pj = expf(o.xs[j] * p.inv_t - o.ms) * inv_ss;
      const float tj = expf(o.xt[j] * p.inv_t - o.mt) * inv_st;
      out[j] = (pj * st - tj) * k;
    }
  }
}

Params make_params(const void* s_cls, long long cls_stride, const void* s_reg,
                   const void* t_cls, const void* t_reg, const void* cm,
                   const void* kept, int batch, int n, int c, int nb,
                   float t, float ld_weight, float eps) {
  Params p;
  p.s_cls = static_cast<const float*>(s_cls);
  p.cls_stride = cls_stride;
  p.s_reg = static_cast<const float*>(s_reg);
  p.t_cls = static_cast<const float*>(t_cls);
  p.t_reg = static_cast<const float*>(t_reg);
  p.cm = static_cast<const uint8_t*>(cm);
  p.kept = static_cast<const uint8_t*>(kept);
  p.m = static_cast<long long>(batch) * n;
  p.n = n;
  p.c = c;
  p.nb = nb;
  p.t = t;
  p.inv_t = 1.f / t;
  p.ld_weight = ld_weight;
  p.eps = eps;
  return p;
}

typedef void (*BackwardKernel)(Params, const float*, const float*, int,
                               float*, float*);

// whether the classes go in 16-byte chunks: C, the row stride and the
// gradient's width multiples of 4, both class maps 16-byte aligned
bool vectorized(const void* s_cls, long long cls_stride, const void* t_cls,
                int c, int width) {
  return c % 4 == 0 && cls_stride % 4 == 0 && width % 4 == 0 &&
         reinterpret_cast<uintptr_t>(s_cls) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(t_cls) % 16 == 0;
}

}  // namespace

// Row blocks of an image in the forward (its partials are (B, blocks, 3)).
extern "C" int erd_distill_blocks(int n) {
  return (n + kRowsPerBlock - 1) / kRowsPerBlock;
}

// s_cls (B, N, width) fp32 with row stride cls_stride (class dim
// contiguous; its first C columns are read); s_reg, t_reg (B, N, 4 * nb)
// and t_cls (B, N, C) fp32 contiguous; cm, kept (B, N) uint8; part (B,
// blocks, 3) fp32 scratch; out (B, 2) fp32: l_cls, l_reg; den (B,) fp32:
// max(C * rows, 1), which the backward reads. B <= 65535.
extern "C" int erd_distill_forward(
    const void* s_cls, long long cls_stride, int width, const void* s_reg,
    const void* t_cls, const void* t_reg, const void* cm, const void* kept,
    int batch, int n, int c, int nb, float t, float ld_weight, float eps,
    void* part, void* out, void* den, void* stream) {
  if (batch <= 0) return 0;
  if (batch > 65535 || c < 1 || nb < 1) return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p = make_params(s_cls, cls_stride, s_reg, t_cls, t_reg, cm,
                               kept, batch, n, c, nb, t, ld_weight, eps);
  const int blocks = erd_distill_blocks(n);
  if (blocks > 0) {
    const dim3 grid(blocks, batch);
    if (vectorized(s_cls, cls_stride, t_cls, c, width))
      erd_distill_rows_kernel<true><<<grid, kThreads, 0, s>>>(
          p, static_cast<float*>(part));
    else
      erd_distill_rows_kernel<false><<<grid, kThreads, 0, s>>>(
          p, static_cast<float*>(part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  erd_distill_reduce_kernel<<<batch, kThreads, 0, s>>>(
      static_cast<const float*>(part), blocks, c, ld_weight, eps,
      static_cast<float*>(out), static_cast<float*>(den));
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs; gout (B, 2) fp32, the losses' gradients; den, the
// forward's; writes gcls (B, N, width) and greg (B, N, 4 * nb) fp32, both
// contiguous, every element.
extern "C" int erd_distill_backward(
    const void* s_cls, long long cls_stride, int width, const void* s_reg,
    const void* t_cls, const void* t_reg, const void* cm, const void* kept,
    int batch, int n, int c, int nb, float t, float ld_weight, float eps,
    const void* gout, const void* den, void* gcls, void* greg,
    void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (c < 1 || nb < 1 || width < c) return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p = make_params(s_cls, cls_stride, s_reg, t_cls, t_reg, cm,
                               kept, batch, n, c, nb, t, ld_weight, eps);
  const long long blocks = (p.m + kRowsPerBlock - 1) / kRowsPerBlock;
  const BackwardKernel kernel =
      vectorized(s_cls, cls_stride, t_cls, c, width)
          ? erd_distill_backward_kernel<true>
          : erd_distill_backward_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      p, static_cast<const float*>(gout), static_cast<const float*>(den),
      width, static_cast<float*>(gcls), static_cast<float*>(greg));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
