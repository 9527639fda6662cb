// Bilinear point sampling, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/sampling.py `point_sample` (align_corners=False)
// with `_grid_sample_bilinear`, as erd_tpu/models/detectors/point_rend.py
// calls it: the coarse call samples each RoI's (14, 14, C) logit map at its
// own points, the fine call one image's P2 map at the points of all its
// RoIs. On the TPU both were gathers of four clipped corners times 0/1
// validity masks; here each point reads only its four corners.
//
// Thread layout: one warp per point (n, k). Every lane forms the point's
// coordinates and its four bilinear weights once, then loops over the
// channels lane, lane + 32, ..., so a warp writes 32 neighbouring output
// floats of the (N, K, C) row at a time. The map is read through its four
// element strides (NCHW or channels-last memory alike); bf16 maps are
// widened in registers, which gives erd_tpu's astype(float32) values.
// A corner off the map reads 0 (zero padding per corner, as the reference's
// validity mask). The sum is the plain version's: v00*(1-wy)*(1-wx) +
// v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx, left to right, each op rounded
// on its own (the library is built with -fmad=false), so kernel and plain
// version agree to the bit.
//
// Bound on this card: bytes. Each output float must be written (20.1 MB
// for the fine call's 19600 points x 256 channels) and each map row under
// the points read (at most the 34.4 MB of a bf16 800x1344 P2); the ~12
// flops per sample are far below the float32 peak. Points of one RoI are
// neighbours on the map, so their corners mostly come from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float widen(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void point_sample_kernel(const T* __restrict__ maps,
                                    const float* __restrict__ points, int c,
                                    int h, int w, int k, long long n_points,
                                    long long sn, long long sc, long long sy,
                                    long long sx, float* __restrict__ out) {
  const long long p = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n_points) return;
  const long long img = p / k;
  const float xs = __fsub_rn(__fmul_rn(points[2 * p], static_cast<float>(w)),
                             0.5f);
  const float ys = __fsub_rn(
      __fmul_rn(points[2 * p + 1], static_cast<float>(h)), 0.5f);
  const float x0f = floorf(xs), y0f = floorf(ys);
  const float wx = __fsub_rn(xs, x0f), wy = __fsub_rn(ys, y0f);
  const float hx = __fsub_rn(1.f, wx), hy = __fsub_rn(1.f, wy);
  // validity in float, so a far-off point never converts out of int range
  const bool oy0 = y0f >= 0.f && y0f < static_cast<float>(h);
  const bool oy1 = y0f >= -1.f && y0f < static_cast<float>(h - 1);
  const bool ox0 = x0f >= 0.f && x0f < static_cast<float>(w);
  const bool ox1 = x0f >= -1.f && x0f < static_cast<float>(w - 1);
  const long long y0 = oy0 || oy1 ? static_cast<long long>(y0f) : 0;
  const long long x0 = ox0 || ox1 ? static_cast<long long>(x0f) : 0;
  const long long o00 = y0 * sy + x0 * sx;
  const long long o01 = o00 + sx, o10 = o00 + sy, o11 = o00 + sy + sx;
  const bool ok00 = oy0 && ox0, ok01 = oy0 && ox1;
  const bool ok10 = oy1 && ox0, ok11 = oy1 && ox1;
  const T* base = maps + img * sn;
  float* dst = out + p * c;
  for (int ch = lane; ch < c; ch += 32) {
    const T* m = base + ch * sc;
    const float v00 = ok00 ? widen(m, o00) : 0.f;
    const float v01 = ok01 ? widen(m, o01) : 0.f;
    const float v10 = ok10 ? widen(m, o10) : 0.f;
    const float v11 = ok11 ? widen(m, o11) : 0.f;
    float acc = __fmul_rn(__fmul_rn(v00, hy), hx);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, hy), wx));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, wy), hx));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, wy), wx));
    dst[ch] = acc;
  }
}

}  // namespace

// maps (n, c, h, w) float32 or bf16 (is_bf16) with element strides sn, sc,
// sy, sx; points (n, k, 2) float32 (x, y) in [0, 1]; out (n, k, c) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int erd_point_sample(const void* maps, const void* points,
                                void* out, int n, int c, int h, int w, int k,
                                long long sn, long long sc, long long sy,
                                long long sx, int is_bf16, void* stream) {
  const long long n_points = static_cast<long long>(n) * k;
  if (n_points <= 0 || c <= 0) return 0;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;  // 8 points a block
  const unsigned blocks =
      static_cast<unsigned>((n_points * 32 + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pts = static_cast<const float*>(points);
  float* o = static_cast<float*>(out);
  if (is_bf16) {
    point_sample_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(maps), pts, c, h, w, k, n_points,
        sn, sc, sy, sx, o);
  } else {
    point_sample_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(maps), pts, c, h, w, k, n_points, sn, sc,
        sy, sx, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
