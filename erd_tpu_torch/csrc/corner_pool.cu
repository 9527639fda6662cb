// CornerNet corner pooling (running maxima), hand-written for Hopper
// (sm_90a).
//
// Replaces: erd_tpu/ops/extra_nms.py `corner_pool`, as
// erd_tpu/models/detectors/cornernet.py `BiCornerPool` calls it on its two
// 128-channel direction convs. On the TPU it was `lax.cummax` between two
// flips; here one pass scans the ray in the direction's own order and no
// flipped copy is made.
//
// Thread layout: one thread per (plane, column) scanning the rows of an
// NCHW plane (top: from the last row up; bottom: from the first row down),
// or one per (plane, row) scanning the columns (left: from the last column;
// right: from the first). For the row scans neighbouring threads read and
// write neighbouring columns of one row, coalesced; for the column scans
// each thread walks its own row, and the cache lines it pulls serve its
// next iterations. A max picks one of its inputs, so the output is
// bit-equal to the plain version's torch.cummax in any order; bf16 values
// are compared widened and written back as they were.
//
// Bound on this card: bytes, each input read once and each output written
// once (25.2 MB each way for one (1, 128, 192, 256) float32 call of a
// 768x1024 HG-104 request); one compare per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void corner_pool_kernel(const T* __restrict__ x,
                                   T* __restrict__ out, int planes, int h,
                                   int w, int along_w, int backward) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  // a thread's ray: `len` elements `step` apart from `first`
  const int rays = along_w ? h : w;
  const int len = along_w ? w : h;
  if (t >= static_cast<long long>(planes) * rays) return;
  const long long plane = t / rays;
  const int ray = static_cast<int>(t % rays);
  const long long origin =
      plane * h * w + (along_w ? ray * static_cast<long long>(w) : ray);
  const long long step = along_w ? 1 : w;
  T best = x[origin + (backward ? (len - 1) * step : 0)];
  for (int i = 0; i < len; ++i) {
    const long long at = origin + (backward ? len - 1 - i : i) * step;
    const T v = x[at];
    if (widen(v) > widen(best)) best = v;
    out[at] = best;
  }
}

}  // namespace

// x and out (planes, h, w), float32 or bf16 (is_bf16); along_w 0 scans the
// rows of each column (top / bottom), 1 the columns of each row (left /
// right); backward 1 scans from the last element (top, left). Returns
// cudaGetLastError() after the launch.
extern "C" int erd_corner_pool(const void* x, void* out, int planes, int h,
                               int w, int along_w, int backward, int is_bf16,
                               void* stream) {
  const long long rays =
      static_cast<long long>(planes) * (along_w ? h : w);
  if (rays <= 0 || h <= 0 || w <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((rays + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    corner_pool_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), planes, h, w, along_w, backward);
  } else {
    corner_pool_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), planes, h, w,
        along_w, backward);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
