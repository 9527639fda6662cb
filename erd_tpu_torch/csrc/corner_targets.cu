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
// Thread layout: one thread per pixel (b, y, x). It walks the image's G gts
// in order and, for each valid gt whose (2r + 1)^2 square holds the pixel,
// takes the max of exp(-(dx * dx + dy * dy) / (2 sigma^2 + 1e-12)) into the
// gt's class channel of the top-left (or bottom-right) heatmap; at the
// corner pixel itself it writes the gt's offsets and a weight of 1, so the
// last valid gt there wins, as erd_tpu's overwrite order has it. A thread
// owns its pixel in every channel, so the read-modify-write of the max needs
// no atomics; the caller zero-fills the maps, and a thread writes only the
// channels of its gts. The per-gt scalars (corner pixels, radius, label,
// validity, offsets and sigma's denominator) are computed by the same torch
// code for this kernel and for the plain version. dx * dx + dy * dy and the
// quotient are rounded as the plain version rounds them (__fmul_rn,
// __fadd_rn, __fdiv_rn); expf may differ from the host's exp by an ulp.
//
// Bound on this card: bytes. The two heatmaps (2 * B * C * H * W float32,
// 189 MB at bs 6, 80 classes, 192 x 256) are written once, with the offsets
// and weights; the gts are read from L1 by every pixel of the image.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInts = 7;    // tl_x, tl_y, br_x, br_y, radius, label, valid
constexpr int kFloats = 5;  // tl_off (2), br_off (2), denom

__global__ void corner_targets_kernel(const int* __restrict__ ints,
                                      const float* __restrict__ floats,
                                      float* __restrict__ tl_heat,
                                      float* __restrict__ br_heat,
                                      float* __restrict__ tl_off,
                                      float* __restrict__ br_off,
                                      float* __restrict__ tl_w,
                                      float* __restrict__ br_w, int b, int g,
                                      int c, int h, int w) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long hw = static_cast<long long>(h) * w;
  if (t >= b * hw) return;
  const long long img = t / hw;
  const long long pix = t % hw;
  const int y = static_cast<int>(pix / w), x = static_cast<int>(pix % w);
  const float fy = static_cast<float>(y), fx = static_cast<float>(x);
  for (int corner = 0; corner < 2; ++corner) {
    float* heat = (corner ? br_heat : tl_heat) + img * c * hw + pix;
    float* off = (corner ? br_off : tl_off) + img * 2 * hw + pix;
    float* weight = (corner ? br_w : tl_w) + img * hw + pix;
    for (int j = 0; j < g; ++j) {
      const int* gi = ints + (img * g + j) * kInts;
      const float* gf = floats + (img * g + j) * kFloats;
      if (!gi[6]) continue;
      const int cx = gi[2 * corner], cy = gi[2 * corner + 1], r = gi[4];
      const float dy = __fsub_rn(fy, static_cast<float>(cy));
      const float dx = __fsub_rn(fx, static_cast<float>(cx));
      if (fabsf(dy) <= static_cast<float>(r) &&
          fabsf(dx) <= static_cast<float>(r)) {
        const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float v = expf(__fdiv_rn(-d, gf[4]));
        float* at = heat + gi[5] * hw;
        *at = fmaxf(*at, v);
      }
      if (y == cy && x == cx) {
        off[0] = gf[2 * corner];
        off[hw] = gf[2 * corner + 1];
        *weight = 1.f;
      }
    }
  }
}

}  // namespace

// ints (b, g, 7) int32 and floats (b, g, 5) float32 per-gt scalars; the
// heatmaps (b, c, h, w), offsets (b, 2, h, w) and weights (b, 1, h, w)
// float32, zeroed by the caller. Returns cudaGetLastError() after the
// launch.
extern "C" int erd_render_corner_targets(const void* ints, const void* floats,
                                         void* tl_heat, void* br_heat,
                                         void* tl_off, void* br_off,
                                         void* tl_w, void* br_w, int b,
                                         int g, int c, int h, int w,
                                         void* stream) {
  const long long n = static_cast<long long>(b) * h * w;
  if (n <= 0 || g <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  corner_targets_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ints), static_cast<const float*>(floats),
      static_cast<float*>(tl_heat), static_cast<float*>(br_heat),
      static_cast<float*>(tl_off), static_cast<float*>(br_off),
      static_cast<float*>(tl_w), static_cast<float*>(br_w), b, g, c, h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
