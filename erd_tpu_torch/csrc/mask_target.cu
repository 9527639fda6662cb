// Mask targets: each sampled RoI's box-normalised gt crop resampled to an
// out x out grid over the RoI, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/data/masks.py `crop_resize_mask`, as
// erd_tpu/models/detectors/mask_rcnn.py (28 x 28) and point_rend.py
// (14 x 14) vmap it over every sampled RoI and its assigned gt. On the TPU
// it was four clipped gathers of the crop times an in-box mask; here each
// thread computes one output cell.
//
// Thread layout: one thread per output cell (b, s, y, x). It reads the RoI
// and its gt's box, forms the cell centre in the crop's frame,
// my = (ys - gy1) / gh * R - 0.5 (likewise mx), floors it, clips the two
// indices into [0, R) and sums the four corners' uint8 values with the
// bilinear weights, zero where (my, mx) falls outside [-0.5, R - 0.5]. The
// arithmetic is erd_tpu's as XLA compiles it on the CPU: the division by
// out is a product with its float32 reciprocal, and three multiply-adds are
// fused (the sample position, the crop coordinate, the last three terms of
// the bilinear sum), here __fmaf_rn; every other product, sum and quotient
// is rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn, and the library
// is built with -fmad=false). So a floor near an integer lands where
// erd_tpu's does, and the targets equal the plain version's to the bit.
//
// Bound on this card: bytes. The output (B * S * out^2 float32, 25.7 MB for
// a bs-16 Mask R-CNN step of 512 RoIs an image) is written once; the crops
// (B * G * 56^2 uint8, 0.8 MB) and the boxes are read from L2 by every RoI
// that uses them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Axis {
  int i0, i1;
  float w;
  bool inside;
};

// The cell centre i of the cells over [lo, hi] (inv_out = 1 / their count),
// in a crop of r cells over [glo, glo + extent).
__device__ __forceinline__ Axis crop_axis(float lo, float hi, int i,
                                          float inv_out, float glo,
                                          float extent, int r) {
  const float t = __fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), inv_out);
  const float pos = __fmaf_rn(t, __fsub_rn(hi, lo), lo);
  const float m = __fmaf_rn(__fdiv_rn(__fsub_rn(pos, glo), extent),
                            static_cast<float>(r), -0.5f);
  const float f = floorf(m);
  Axis a;
  // clip in float first, so a far-off RoI never converts out of int range
  a.i0 = static_cast<int>(fminf(fmaxf(f, 0.f), static_cast<float>(r - 1)));
  a.i1 = min(a.i0 + 1, r - 1);
  a.w = __fsub_rn(m, f);
  a.inside = m >= -0.5f && m <= static_cast<float>(r) - 0.5f;
  return a;
}

__global__ void crop_resize_mask_kernel(const uint8_t* __restrict__ masks,
                                        const float* __restrict__ boxes,
                                        const int* __restrict__ gt_idx,
                                        const float* __restrict__ rois,
                                        float* __restrict__ out, int b,
                                        int s, int g, int r, int size) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long cells = static_cast<long long>(size) * size;
  if (t >= static_cast<long long>(b) * s * cells) return;
  const long long roi = t / cells;  // b * s + s
  const int y = static_cast<int>((t % cells) / size);
  const int x = static_cast<int>(t % size);
  const long long img = roi / s;
  const int gi = min(max(gt_idx[roi], 0), g - 1);
  const float* box = boxes + (img * g + gi) * 4;
  const float* rb = rois + roi * 4;
  const float gw = fmaxf(__fsub_rn(box[2], box[0]), 1e-3f);
  const float gh = fmaxf(__fsub_rn(box[3], box[1]), 1e-3f);
  const float inv = __fdiv_rn(1.f, static_cast<float>(size));
  const Axis ay = crop_axis(rb[1], rb[3], y, inv, box[1], gh, r);
  const Axis ax = crop_axis(rb[0], rb[2], x, inv, box[0], gw, r);
  const uint8_t* m = masks + (img * g + gi) * static_cast<long long>(r) * r;
  const float v00 = m[ay.i0 * r + ax.i0], v01 = m[ay.i0 * r + ax.i1];
  const float v10 = m[ay.i1 * r + ax.i0], v11 = m[ay.i1 * r + ax.i1];
  const float hy = __fsub_rn(1.f, ay.w), hx = __fsub_rn(1.f, ax.w);
  float acc = __fmul_rn(__fmul_rn(v00, hy), hx);
  acc = __fmaf_rn(__fmul_rn(v01, hy), ax.w, acc);
  acc = __fmaf_rn(__fmul_rn(v10, ay.w), hx, acc);
  acc = __fmaf_rn(__fmul_rn(v11, ay.w), ax.w, acc);
  out[t] = ay.inside && ax.inside ? acc : 0.f;
}

}  // namespace

// masks (b, g, r, r) uint8; boxes (b, g, 4) float32 xyxy; gt_idx (b, s)
// int32; rois (b, s, 4) float32 xyxy; out (b, s, size, size) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int erd_crop_resize_mask(const void* masks, const void* boxes,
                                    const void* gt_idx, const void* rois,
                                    void* out, int b, int s, int g, int r,
                                    int size, void* stream) {
  const long long n = static_cast<long long>(b) * s * size * size;
  if (n <= 0) return 0;
  if (g <= 0 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  crop_resize_mask_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const float*>(boxes),
      static_cast<const int*>(gt_idx), static_cast<const float*>(rois),
      static_cast<float*>(out), b, s, g, r, size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
