// GFL distribution decode of the candidate rows, hand-written for Hopper
// (sm_90a).
//
// Replaces: erd_tpu/ops/integral.py `integral` times the level stride, then
// erd_tpu/structures/boxes.py `distance2bbox(max_shape=img_shape)`, as
// erd_tpu/models/heads/gfl_head.py `gfl_predict` uses them. On the TPU every
// anchor row of every level was decoded (softmax over 17 bins per side, an
// einsum with 0..16) and the top-k candidates gathered afterwards. Decoding
// only the gathered candidate rows gives the same boxes, so the kernel reads
// just those rows: one launch per batch covers all five levels.
//
// Thread layout: one thread per (image, candidate, side). It reads the 17
// contiguous fp32 logits of its side, subtracts their max, exponentiates,
// sums, normalises (p_i = e_i / sum) and takes E = sum_i p_i * i; then
// d = E * stride, v = centre -/+ d (x for sides 0 and 2, y for 1 and 3) and
// clips v to [0, W] or [0, H] of that image's img_shape: the reference's
// order of operations, (E * stride) first, then centre +/- distance.
//
// Bound on this card: bytes. A candidate moves 4 * 17 * 4 B of logits, its
// row index, its anchor centre and stride, and 16 B of box: about 310 B, so
// 5000 candidates per image are ~1.5 MB, under a microsecond at 3.35 TB/s;
// the arithmetic (~100 flops per side) is far below the fp32 peak. At this
// size a launch costs more than the traffic, which is why one launch covers
// every level and image. The 17 logits of a side are contiguous, so a
// thread's loads fall in 1-2 cache lines; the exponentials are recomputed
// (cheap) rather than kept in a per-thread array (which would go to local
// memory).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void integral_decode_kernel(const float* __restrict__ reg,
                                       const int64_t* __restrict__ rows,
                                       const float* __restrict__ centers,
                                       const float* __restrict__ strides,
                                       const float* __restrict__ img_shape,
                                       int batch, int n, int k, int bins,
                                       float* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= static_cast<long long>(batch) * k * 4) return;
  const int side = static_cast<int>(t & 3);
  const long long bk = t >> 2;  // b * k + candidate
  const long long b = bk / k;
  const long long row = rows[bk];
  const float* x = reg + ((b * n + row) * 4 + side) * bins;

  float m = x[0];
  for (int i = 1; i < bins; ++i) m = fmaxf(m, x[i]);
  float sum = 0.f;
  for (int i = 0; i < bins; ++i) sum = __fadd_rn(sum, expf(__fsub_rn(x[i], m)));
  float e = 0.f;
  for (int i = 0; i < bins; ++i) {
    const float p = __fdiv_rn(expf(__fsub_rn(x[i], m)), sum);
    e = __fadd_rn(e, __fmul_rn(p, static_cast<float>(i)));
  }
  const float d = __fmul_rn(e, strides[row]);
  const int axis = side & 1;  // 0: x, 1: y
  const float c = centers[row * 2 + axis];
  float v = side < 2 ? __fsub_rn(c, d) : __fadd_rn(c, d);
  // img_shape is (H, W): x sides clip to W, y sides to H
  const float hi = img_shape[b * 2 + (axis ? 0 : 1)];
  v = fminf(fmaxf(v, 0.f), hi);
  out[t] = v;
}

}  // namespace

// reg (B, N, 4 * bins) fp32; rows (B, K) int64 in [0, N); centers (N, 2)
// fp32; strides (N,) fp32; img_shape (B, 2) fp32 (H, W); out (B, K, 4) fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int erd_integral_decode(const void* reg, const void* rows,
                                   const void* centers, const void* strides,
                                   const void* img_shape, void* out,
                                   int batch, int n, int k, int bins,
                                   void* stream) {
  const long long total = static_cast<long long>(batch) * k * 4;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  integral_decode_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(reg), static_cast<const int64_t*>(rows),
      static_cast<const float*>(centers), static_cast<const float*>(strides),
      static_cast<const float*>(img_shape), batch, n, k, bins,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
