// CornerNet's corner targets (gaussian heatmaps, offsets, offset weights),
// hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/gaussian.py `render_corner_targets`, as
// erd_tpu/models/detectors/cornernet.py `loss_and_state` vmaps it over the
// batch. On the TPU it was a fori_loop over the padded gts, each step
// rendering a dense (H, W) gaussian and max-compositing it into its class
// channel with a scatter, and overwriting the offsets at the corner pixel
// with jnp.where.
//
// One launch takes the (B, G, 4) boxes, labels and mask as the path holds
// them, and writes every output byte once; nothing zero-fills the outputs.
// A block is an (image, corner, band of 1024 pixels of the flat H * W
// plane):
//   1. its first G threads compute the gts' scalars in shared memory, in
//      erd_tpu's float32 order as ``corner_scalars`` computes them: the
//      scaled corner (x * ratio, __fmul_rn), capped at the last pixel and
//      truncated; the box size by ceilf; ``gaussian_radius`` with the
//      host's float32 constants and __fsqrt_rn (the correctly rounded root
//      that the float64 root rounded to float32 is), floored, clamped at 0;
//      sigma's denominator (2r + 1)^2 * f32(2 / 36) + f32(1e-12); the
//      clipped label, the validity and the sub-pixel offsets. The bands at
//      0 also write the corner pixels (tl_xy / br_xy, int64 (x, y)).
//   2. warp 0 lists, in gt order, the valid gts whose (2r + 1)^2 square
//      meets the band's rows, and marks their classes in a bitmap.
//   3. a thread owns 4 consecutive pixels. For every class channel it
//      writes one 16-byte store: zeros where no listed gt has the class,
//      else the max of 0 and those gts' gaussians
//      exp(-(dx * dx + dy * dy) / denom) inside their squares (the max is
//      exact in any order). Then the offsets and the weight, overwritten
//      by each listed gt whose corner is the pixel, so the last valid gt
//      wins as in erd_tpu's loop. Where H * W is not a multiple of 4, the
//      planes are not 16-byte aligned and the stores are scalar.
// dx * dx + dy * dy and the quotient are rounded as the plain version
// rounds them (__fmul_rn, __fadd_rn, __fdiv_rn); expf may differ from the
// host's exp by an ulp.
//
// Bound on this card: bytes, the outputs written once (2 * B * (C + 3) *
// H * W float32: 196 MB at bs 6, 80 classes, 192 x 256).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;                    // pixels a thread
constexpr int kBand = kThreads * kPix;     // pixels a block

struct RadiusConsts {
  float k1, c07, cm06, cm07, c48, k3, csig, eps;
};

__device__ __forceinline__ float sqrt0(float v) {
  return __fsqrt_rn(v < 0.f ? 0.f : v);  // torch's clamp keeps a NaN
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;  // torch.minimum
}

// ``gaussian_radius(h, w)`` of ops/gaussian.py, op for op
__device__ float radius_of(float h, float w, const RadiusConsts& k) {
  const float b1 = __fadd_rn(h, w);
  const float r1 = __fmul_rn(
      __fsub_rn(b1, sqrt0(__fsub_rn(__fmul_rn(b1, b1),
                                    __fmul_rn(__fmul_rn(w, h), k.k1)))),
      0.5f);
  const float b2 = __fmul_rn(b1, 2.f);
  const float r2 = __fmul_rn(
      __fsub_rn(b2, sqrt0(__fsub_rn(
                        __fmul_rn(b2, b2),
                        __fmul_rn(__fmul_rn(__fmul_rn(w, k.c07), h), 16.f)))),
      0.125f);
  const float b3 = __fmul_rn(b1, k.cm06);
  const float c3 = __fmul_rn(__fmul_rn(w, k.cm07), h);
  const float r3 = __fmul_rn(
      __fadd_rn(-b3, sqrt0(__fsub_rn(__fmul_rn(b3, b3), __fmul_rn(c3, k.c48)))),
      k.k3);
  return nan_min(nan_min(r1, r2), r3);
}

__device__ __forceinline__ int trunc_capped(float v, float cap) {
  return static_cast<int>(v > cap ? cap : v);  // clamp(max=cap).to(int32)
}

template <typename Label, bool kVec>
__global__ void __launch_bounds__(kThreads)
corner_targets_kernel(const float4* __restrict__ boxes,
                      const Label* __restrict__ labels,
                      const uint8_t* __restrict__ mask, int g, int c, int h,
                      int w, float rx, float ry, RadiusConsts rk,
                      float* __restrict__ tl_heat, float* __restrict__ br_heat,
                      float* __restrict__ tl_off, float* __restrict__ br_off,
                      float* __restrict__ tl_w, float* __restrict__ br_w,
                      int64_t* __restrict__ tl_xy,
                      int64_t* __restrict__ br_xy) {
  extern __shared__ int sm[];
  __shared__ int n_list;
  const int corner = blockIdx.y;
  const size_t img = blockIdx.z;
  const int hw = h * w;
  const int p0 = blockIdx.x * kBand;
  const int p1 = min(hw, p0 + kBand);
  const int ylo = p0 / w, yhi = (p1 - 1) / w;
  const int words = (c + 31) / 32;
  int* gx = sm;            // corner pixel x
  int* gy = gx + g;        // corner pixel y
  int* gr = gy + g;        // radius
  int* glab = gr + g;      // clipped label
  int* list = glab + g;    // listed gts, in order
  unsigned* bits = reinterpret_cast<unsigned*>(list + g);  // classes listed
  float* gden = reinterpret_cast<float*>(bits + words);
  float* gox = gden + g;
  float* goy = gox + g;
  const int tid = threadIdx.x;
  for (int i = tid; i < words; i += kThreads) bits[i] = 0u;

  // 1. the gts' scalars
  for (int j = tid; j < g; j += kThreads) {
    const float4 bx = boxes[img * g + j];
    const float sl = __fmul_rn(bx.x, rx), st = __fmul_rn(bx.y, ry);
    const float sr = __fmul_rn(bx.z, rx), sb = __fmul_rn(bx.w, ry);
    const float capx = static_cast<float>(w - 1);
    const float capy = static_cast<float>(h - 1);
    const int li = trunc_capped(sl, capx), ti = trunc_capped(st, capy);
    const int ri = trunc_capped(sr, capx), bi = trunc_capped(sb, capy);
    const float bw = ceilf(__fsub_rn(sr, sl)), bh = ceilf(__fsub_rn(sb, st));
    float rf = floorf(radius_of(bh, bw, rk));
    rf = rf < 0.f ? 0.f : rf;
    const int r = static_cast<int>(rf);
    const float side = __fadd_rn(__fmul_rn(2.f, static_cast<float>(r)), 1.f);
    const int cx = corner ? ri : li, cy = corner ? bi : ti;
    gx[j] = cx;
    gy[j] = cy;
    gr[j] = r;
    const long long lab = static_cast<long long>(labels[img * g + j]);
    glab[j] = mask[img * g + j]
                  ? static_cast<int>(lab < 0 ? 0 : (lab > c - 1 ? c - 1 : lab))
                  : -1;  // -1: invalid
    gden[j] = __fadd_rn(__fmul_rn(__fmul_rn(side, side), rk.csig), rk.eps);
    gox[j] = __fsub_rn(corner ? sr : sl, static_cast<float>(cx));
    goy[j] = __fsub_rn(corner ? sb : st, static_cast<float>(cy));
    if (blockIdx.x == 0) {
      int64_t* xy = (corner ? br_xy : tl_xy) + (img * g + j) * 2;
      xy[0] = cx;
      xy[1] = cy;
    }
  }
  __syncthreads();

  // 2. the valid gts whose squares meet the band's rows, in order
  if (tid < 32) {
    int n = 0;
    for (int base = 0; base < g; base += 32) {
      const int j = base + tid;
      bool meets = false;
      if (j < g && glab[j] >= 0) {
        const long long cy = gy[j], r = gr[j];
        meets = cy - r <= yhi && cy + r >= ylo;
      }
      const unsigned m = __ballot_sync(0xffffffffu, meets);
      if (meets) {
        list[n + __popc(m & ((1u << tid) - 1u))] = j;
        atomicOr(&bits[glab[j] / 32], 1u << (glab[j] % 32));
      }
      n += __popc(m);
    }
    if (tid == 0) n_list = n;
  }
  __syncthreads();

  // 3. a thread's 4 pixels in every channel, then offsets and weight
  const int n = n_list;
  const int q0 = p0 + tid * kPix;
  if (q0 >= p1) return;
  float fx[kPix], fy[kPix];
  int px[kPix], py[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int p = min(q0 + q, p1 - 1);
    py[q] = p / w;
    px[q] = p - py[q] * w;
    fx[q] = static_cast<float>(px[q]);
    fy[q] = static_cast<float>(py[q]);
  }
  const size_t plane = static_cast<size_t>(hw);
  float* heat = (corner ? br_heat : tl_heat) + img * c * plane + q0;
  for (int ch = 0; ch < c; ++ch, heat += plane) {
    float v[kPix] = {0.f, 0.f, 0.f, 0.f};
    if (bits[ch / 32] & (1u << (ch % 32))) {
      for (int l = 0; l < n; ++l) {
        const int j = list[l];
        if (glab[j] != ch) continue;
        const float cx = static_cast<float>(gx[j]);
        const float cy = static_cast<float>(gy[j]);
        const float r = static_cast<float>(gr[j]);
        const float den = gden[j];
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          const float dy = __fsub_rn(fy[q], cy);
          const float dx = __fsub_rn(fx[q], cx);
          if (fabsf(dy) <= r && fabsf(dx) <= r) {
            const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
            v[q] = fmaxf(v[q], expf(__fdiv_rn(-d, den)));
          }
        }
      }
    }
    if (kVec) {
      __stcs(reinterpret_cast<float4*>(heat),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int q = 0; q < kPix; ++q)
        if (q0 + q < p1) __stcs(heat + q, v[q]);
    }
  }
  float ox[kPix] = {0.f, 0.f, 0.f, 0.f}, oy[kPix] = {0.f, 0.f, 0.f, 0.f};
  float wt[kPix] = {0.f, 0.f, 0.f, 0.f};
  for (int l = 0; l < n; ++l) {
    const int j = list[l];
#pragma unroll
    for (int q = 0; q < kPix; ++q)
      if (px[q] == gx[j] && py[q] == gy[j]) {
        ox[q] = gox[j];
        oy[q] = goy[j];
        wt[q] = 1.f;
      }
  }
  float* off = (corner ? br_off : tl_off) + img * 2 * plane + q0;
  float* wgt = (corner ? br_w : tl_w) + img * plane + q0;
  if (kVec) {
    __stcs(reinterpret_cast<float4*>(off),
           make_float4(ox[0], ox[1], ox[2], ox[3]));
    __stcs(reinterpret_cast<float4*>(off + plane),
           make_float4(oy[0], oy[1], oy[2], oy[3]));
    __stcs(reinterpret_cast<float4*>(wgt),
           make_float4(wt[0], wt[1], wt[2], wt[3]));
  } else {
#pragma unroll
    for (int q = 0; q < kPix; ++q)
      if (q0 + q < p1) {
        __stcs(off + q, ox[q]);
        __stcs(off + plane + q, oy[q]);
        __stcs(wgt + q, wt[q]);
      }
  }
}

template <typename Label, bool kVec>
int launch(const void* boxes, const void* labels, const void* mask,
           void* const* out, int b, int g, int c, int h, int w, float rx,
           float ry, const RadiusConsts& rk, cudaStream_t s) {
  const dim3 grid((h * w + kBand - 1) / kBand, 2, b);
  const size_t smem = static_cast<size_t>(g) * 8 * 4 +
                      static_cast<size_t>((c + 31) / 32) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corner_targets_kernel<Label, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  corner_targets_kernel<Label, kVec><<<grid, kThreads, smem, s>>>(
      static_cast<const float4*>(boxes), static_cast<const Label*>(labels),
      static_cast<const uint8_t*>(mask), g, c, h, w, rx, ry, rk,
      static_cast<float*>(out[0]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[3]),
      static_cast<float*>(out[4]), static_cast<float*>(out[5]),
      static_cast<int64_t*>(out[6]), static_cast<int64_t*>(out[7]));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes (b, g, 4) float32 xyxy in image units, labels (b, g) int32
// (label_bytes 4) or int64 (8), mask (b, g) bool; ratio (rx, ry) and
// consts (8 float32: gaussian_radius's k1, f32(1 - m), f32(-2 m),
// f32(m - 1), f32(16 m), k3; f32(2 / 36), f32(1e-12)) as float32. out:
// tl_heat, br_heat (b, c, h, w), tl_off, br_off (b, 2, h, w), tl_w, br_w
// (b, 1, h, w) float32 and tl_xy, br_xy (b, g, 2) int64, every element
// written by the launch. Returns cudaGetLastError() after the launch.
extern "C" int erd_render_corner_targets(const void* boxes, const void* labels,
                                         const void* mask, int label_bytes,
                                         void* const* out, int b, int g, int c,
                                         int h, int w, float rx, float ry,
                                         const float* consts, void* stream) {
  if (b <= 0 || g <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  const RadiusConsts rk{consts[0], consts[1], consts[2], consts[3],
                        consts[4], consts[5], consts[6], consts[7]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (static_cast<long long>(h) * w) % kPix == 0;
  if (label_bytes == 8)
    return vec ? launch<int64_t, true>(boxes, labels, mask, out, b, g, c, h,
                                       w, rx, ry, rk, s)
               : launch<int64_t, false>(boxes, labels, mask, out, b, g, c, h,
                                        w, rx, ry, rk, s);
  if (label_bytes == 4)
    return vec ? launch<int32_t, true>(boxes, labels, mask, out, b, g, c, h,
                                       w, rx, ry, rk, s)
               : launch<int32_t, false>(boxes, labels, mask, out, b, g, c, h,
                                        w, rx, ry, rk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
