// Mask targets: each sampled RoI's box-normalised gt crop resampled to an
// out x out grid over the RoI, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/data/masks.py `crop_resize_mask`, as
// erd_tpu/models/detectors/mask_rcnn.py (28 x 28) and point_rend.py
// (14 x 14) vmap it over every sampled RoI and its assigned gt. On the TPU
// it was four clipped gathers of the crop times an in-box mask.
//
// A cell (y, x) of a RoI takes the crop's rows of the RoI's row axis at y
// and its columns of the column axis at x: my = (ys - gy1) / gh * R - 0.5
// (likewise mx), floored, the two indices clipped into [0, R), the upper
// weight my - floor(my), and whether my lies in [-0.5, R - 0.5]. The cell
// sums the four corners' uint8 values with the bilinear weights, zero
// where (my, mx) falls outside. The arithmetic is erd_tpu's as XLA
// compiles it on the CPU: the division by out is a product with its
// float32 reciprocal, and three multiply-adds are fused (the sample
// position, the crop coordinate, the last three terms of the bilinear
// sum), here __fmaf_rn; every other product, sum and quotient is rounded
// on its own (__fmul_rn / __fadd_rn / __fdiv_rn, and the library is built
// with -fmad=false). So a floor near an integer lands where erd_tpu's
// does, and the targets equal the plain version's to the bit.
//
// Layout: a warp a run of consecutive RoIs (one at 28 x 28, three at
// 14 x 14: about kItemsPerWarp float4s), kWarps warps a block, no block
// barrier. The warp first computes each RoI's out row axes and out column
// axes once (2 * out evaluations a RoI instead of 2 * out^2, one
// reciprocal of out a thread, no 64-bit division) into its own shared
// memory, an axis entry one 16-byte load. Then each lane writes 4
// consecutive cells of a RoI's flattened out x out grid at a time with
// one float4 store (out^2 is a multiple of 4 at 28 and 14, so every RoI's
// cells start 16-byte aligned), reading the crop's corners through L1: a
// RoI's 4 * out^2 corner reads fall in its gt's 3136-byte crop, and the
// crops of an image (0.8 MB for a bs-16 step) stay in L1 and L2. The
// path's sizes, 28 and 14, are compiled as constants, so that the cell
// and RoI indices divide by constants (10-15 % faster). Tried and slower
// or level: each RoI's crop staged in shared memory first (4x
// the output's bytes read at 14 x 14), a block of RoIs behind one
// barrier, a RoI a warp at 14 x 14, a crop byte converted through its
// float bits. What is left is instructions, ~45 a cell (four byte loads
// and their 64-bit addresses, the weights' products, the select): the
// store and the conversion cost nothing measurable, the crop loads ~20 %.
//
// Bound on this card: bytes. The output (B * S * out^2 float32, 25.7 MB
// for a bs-16 Mask R-CNN step of 512 RoIs an image) is written once; the
// crops (B * G * 56^2 uint8, 0.8 MB) and the boxes are read from L2 by
// every RoI that uses them.
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

// One axis entry of a RoI in shared memory, one 16-byte load: the upper
// weight w, 1 - w, the two crop indices (the row axis's multiplied by r)
// as i0 | i1 << 16, and whether the cell centre lies inside the crop.
__device__ __forceinline__ float4 axis_entry(const Axis& a, int scale) {
  return make_float4(a.w, __fsub_rn(1.f, a.w),
                     __int_as_float(a.i0 * scale | (a.i1 * scale) << 16),
                     __int_as_float(a.inside ? 1 : 0));
}

// a warp a run of RoIs of about kItemsPerWarp items, kWarps warps a block
constexpr int kWarps = 8;
constexpr int kItemsPerWarp = 160;

// a crop byte as float32 (exact; building 2^23 + v in the bits and
// subtracting 2^23 instead was no faster)
__device__ __forceinline__ float byte_to_float(unsigned v) {
  return static_cast<float>(v);
}

// the gt slot of RoI roi, clipped into [0, g)
__device__ __forceinline__ int gt_slot(const void* gt_idx, int idx64,
                                       int roi, int g) {
  const long long raw =
      idx64 ? static_cast<const long long*>(gt_idx)[roi]
            : static_cast<long long>(static_cast<const int*>(gt_idx)[roi]);
  return static_cast<int>(min(max(raw, 0ll), static_cast<long long>(g - 1)));
}

// VEC cells a lane at a time (4 where size^2 % 4 == 0, else 1); SIZE the
// out size where it is fixed at compile time (0: size_arg), so that the
// cell and RoI indices divide by constants; gt_idx int32 or, with idx64,
// int64; a warp takes rois_per_warp consecutive RoIs. No block barrier: a
// warp's axes are its own.
template <int VEC, int SIZE>
__global__ void __launch_bounds__(kWarps * 32) crop_resize_mask_kernel(
    const uint8_t* __restrict__ masks, const float* __restrict__ boxes,
    const void* __restrict__ gt_idx, int idx64,
    const float* __restrict__ rois, float* __restrict__ out, int b, int s,
    int g, int r, int size_arg, int rois_per_warp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int size = SIZE ? SIZE : size_arg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int roi0 = (blockIdx.x * kWarps + warp) * rois_per_warp;
  const int n_roi = min(rois_per_warp, b * s - roi0);
  if (n_roi <= 0) return;
  // each RoI's row axes (entries 0 .. size - 1) and column axes, then
  // each RoI's crop offset
  float4* axes =
      reinterpret_cast<float4*>(smem) + warp * rois_per_warp * 2 * size;
  int* crop = reinterpret_cast<int*>(reinterpret_cast<float4*>(smem) +
                                     kWarps * rois_per_warp * 2 * size) +
              warp * rois_per_warp;
  const float inv = __fdiv_rn(1.f, static_cast<float>(size));
  for (int t = lane; t < n_roi * 2 * size; t += 32) {
    const int j = t / (2 * size);
    const int roi = roi0 + j;
    const int slot = (roi / s) * g + gt_slot(gt_idx, idx64, roi, g);
    const float* box = boxes + static_cast<long long>(slot) * 4;
    const float* rb = rois + static_cast<long long>(roi) * 4;
    // a = 0: y (rows 1 and 3 of the boxes), a = 1: x (rows 0 and 2)
    const int i = t - j * 2 * size;
    const int a = i >= size ? 1 : 0;
    const int lo = 1 - a;
    const float extent = fmaxf(__fsub_rn(box[lo + 2], box[lo]), 1e-3f);
    axes[t] = axis_entry(crop_axis(rb[lo], rb[lo + 2], i - a * size, inv,
                                   box[lo], extent, r),
                         a == 0 ? r : 1);
    if (i == 0) crop[j] = slot * r * r;
  }
  __syncwarp();
  const int per_roi = size * size / VEC;
  float* dst = out + static_cast<long long>(roi0) * size * size;
#pragma unroll 2
  for (int t = lane; t < n_roi * per_roi; t += 32) {
    const int j = t / per_roi;
    const int c0 = (t - j * per_roi) * VEC;
    const uint8_t* m = masks + crop[j];
    const float4* rows = axes + j * 2 * size;
    const float4* cols = rows + size;
    int y = c0 / size, x = c0 - y * size;
    float4 ay = rows[y];
    float res[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float4 ax = cols[x];
      const int iy = __float_as_int(ay.z), ix = __float_as_int(ax.z);
      const int y0 = iy & 0xffff, y1 = iy >> 16;
      const int x0 = ix & 0xffff, x1 = ix >> 16;
      const float v00 = byte_to_float(__ldg(m + y0 + x0));
      const float v01 = byte_to_float(__ldg(m + y0 + x1));
      const float v10 = byte_to_float(__ldg(m + y1 + x0));
      const float v11 = byte_to_float(__ldg(m + y1 + x1));
      // weights: .x = w, .y = 1 - w
      float acc = __fmul_rn(__fmul_rn(v00, ay.y), ax.y);
      acc = __fmaf_rn(__fmul_rn(v01, ay.y), ax.x, acc);
      acc = __fmaf_rn(__fmul_rn(v10, ay.x), ax.y, acc);
      acc = __fmaf_rn(__fmul_rn(v11, ay.x), ax.x, acc);
      res[e] = __float_as_int(ay.w) && __float_as_int(ax.w) ? acc : 0.f;
      if (e + 1 < VEC && ++x == size) {
        x = 0;
        ay = rows[++y];
      }
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst + t * 4) =
          make_float4(res[0], res[1], res[2], res[3]);
    } else {
      dst[t] = res[0];
    }
  }
}

}  // namespace

// masks (b, g, r, r) uint8; boxes (b, g, 4) float32 xyxy; gt_idx (b, s)
// int32 or, with idx64, int64; rois (b, s, 4) float32 xyxy; out (b, s,
// size, size) float32 (fewer than 2^31 cells; crops of fewer than 2^31
// bytes). Returns cudaGetLastError()
// after the launch.
extern "C" int erd_crop_resize_mask(const void* masks, const void* boxes,
                                    const void* gt_idx, int idx64,
                                    const void* rois, void* out, int b, int s,
                                    int g, int r, int size, void* stream) {
  const long long n = static_cast<long long>(b) * s * size * size;
  if (n <= 0) return 0;
  if (g <= 0 || r <= 0 || n >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v4 = size * size % 4 == 0;
  // about kItemsPerWarp items (VEC cells each) a warp
  const int rpw = max(1, kItemsPerWarp / (size * size / (v4 ? 4 : 1)));
  const size_t smem = static_cast<size_t>(kWarps) * rpw *
                      (2 * size * sizeof(float4) + sizeof(int));
  if (smem > 48 * 1024 ||
      static_cast<long long>(b) * g * r * r >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(kWarps) * rpw;
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(b) * s + per_block - 1) / per_block);
  // PointRend's 14 x 14 and Mask R-CNN's 28 x 28 targets at a fixed size
  auto kernel = size == 14   ? crop_resize_mask_kernel<4, 14>
                : size == 28 ? crop_resize_mask_kernel<4, 28>
                : v4         ? crop_resize_mask_kernel<4, 0>
                             : crop_resize_mask_kernel<1, 0>;
  kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const float*>(boxes),
      gt_idx, idx64, static_cast<const float*>(rois), static_cast<float*>(out),
      b, s, g, r, size, rpw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
