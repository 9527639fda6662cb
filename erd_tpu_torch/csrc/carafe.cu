// CARAFE reassembly with its pixel shuffle and softmax, hand-written for
// Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/carafe.py `carafe_reassemble` (:23) and the tail of
// `CARAFEPack.__call__` (:58-68): the pixel shuffle of the content
// encoder's up^2 * 25 logits into the x2 grid, the float32 softmax over the
// 25 taps, and the reassembly, out[c, i, j] = sum_k w[k, i, j] *
// xpad[c, i/2 + ky, j/2 + kx] over the zero-padded 5x5 neighbourhood of the
// source pixel, in float32, cast back to the map's dtype. On the TPU, XLA
// gathered (H, W, 25, C) patches and contracted them against the kernels in
// one batched einsum. FPN_CARAFE runs it in each of its three top-down
// steps.
//
// Thread layout: one thread per (image, 16-channel chunk, output pixel), the
// output pixel fastest, as in deform_conv.cu. A thread reads its sub-pixel's
// 25 logits (erd_tpu's channel order (a*2 + b)*25 + k, not
// F.pixel_shuffle's), computes the softmax weights once into registers,
// exp(l - max) / sum with the sum taken in tap order, then for each of its
// channels sums the 25 taps in order k = 0..24 in float32 (bf16 maps
// widened in registers) and writes the output in the map's dtype.
// Neighbouring threads take neighbouring output pixels: the writes are
// coalesced, and the 2x2 output pixels of one source pixel read the same
// map values, which L1 serves.
//
// Arithmetic: every product and sum rounded on its own (-fmad=false), in the
// plain version's order (the softmax's sum and the reassembly in tap order),
// so kernel and carafe_plain agree to the bit unless expf and torch's exp
// differ by an ulp, which moves the output by about 1e-7 relative.
//
// Bound on this card: bytes and operations about evenly. The largest call
// of an 800x1344 request (100x168 -> 200x336, C = 256, bf16) reads 8.6 MB of
// map and 3.4 MB of logits and writes 34.4 MB of output: 0.014 ms at
// 3.35 TB/s; its 25 float32 multiply-adds per output element (0.86 GFLOP)
// take 0.013 ms at 67 TFLOP/s.
//
// Backward (`erd_carafe_backward`), which erd_tpu got by autodiff of the
// shuffle, the float32 softmax and the einsum; two passes in one call.
//  1. One thread per (image, output pixel): the softmax weights as the
//     forward computes them, kept in a float32 scratch (B, 25, 2h, 2w);
//     dw[k] = sum_c g[c] * xpad[c, tap k] over all channels in float32;
//     the softmax's backward dlogit[k] = w[k] * (dw[k] - sum_j w[j] dw[j]),
//     written to erd_tpu's channel (a*2 + b)*25 + k of the source pixel
//     (the inverse of the forward's shuffle) in the logits' dtype.
//  2. One thread per (image, 16-channel chunk, source pixel): dx as a
//     gather, no atomics: for each tap k = 0..24 in order whose window
//     covers the pixel through the zero padding, the sum of w * g over the
//     2x2 output pixels of the window's centre, added to the channel's
//     float32 sum; rounded once to x's dtype.
// Pass 2 is deterministic; both sum in another order than the plain
// version (torch's channel reduction), so they agree to float32 rounding,
// not to the bit.
// Bound: operations, about 50 float32 flops per (channel, output pixel) in
// each pass (27.5 GFLOP, 0.41 ms at 67 TFLOP/s, for the 100x168 call of a
// batch-16 step), above the bytes (x, logits and g read, dx and dlogits
// written: 0.93 GB in bf16, 0.28 ms at 3.35 TB/s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kUp = 2;
constexpr int kKUp = 5;
constexpr int kTaps = kKUp * kKUp;
constexpr int kPad = (kKUp - 1) / 2;
// most channels a backward thread gathers (its float32 sums in registers)
constexpr int kMaxChunk = 16;

__device__ __forceinline__ float widen(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float widen(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16_rn(v);
}

// The softmax weights of one output pixel's sub-pixel, as the forward
// computes them: exp(l - max) / sum, the sum in tap order.
template <typename T>
__device__ __forceinline__ void softmax_weights(const T* lg, long long hw,
                                                float* wt) {
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    wt[k] = widen(lg, k * hw);
    mx = fmaxf(mx, wt[k]);
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    wt[k] = expf(__fsub_rn(wt[k], mx));
    sum = __fadd_rn(sum, wt[k]);
  }
#pragma unroll
  for (int k = 0; k < kTaps; ++k) wt[k] = __fdiv_rn(wt[k], sum);
}

template <typename T>
__global__ void carafe_kernel(const T* __restrict__ x,
                              const T* __restrict__ logits, int c, int h,
                              int w, int chunk, int n_chunks, long long total,
                              T* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= total) return;
  const int h2 = h * kUp, w2 = w * kUp;
  const long long hw2 = static_cast<long long>(h2) * w2;
  const int pix = static_cast<int>(t % hw2);
  const long long r = t / hw2;
  const int part = static_cast<int>(r % n_chunks);
  const long long n = r / n_chunks;
  const int oy = pix / w2, ox = pix % w2;
  const int i = oy / kUp, j = ox / kUp;
  const int sub = (oy % kUp) * kUp + (ox % kUp);
  const long long hw = static_cast<long long>(h) * w;

  // the sub-pixel's 25 logits -> softmax weights, exp(l - max) / sum
  const T* lg = logits + (n * (kUp * kUp * kTaps) + sub * kTaps) * hw +
                static_cast<long long>(i) * w + j;
  float wt[kTaps];
  softmax_weights(lg, hw, wt);

  // the taps' offsets in the plane and whether each lies on the map
  int off[kTaps];
  bool in[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int sy = i + k / kKUp - kPad, sx = j + k % kKUp - kPad;
    in[k] = sy >= 0 && sy < h && sx >= 0 && sx < w;
    off[k] = sy * w + sx;
  }

  const int c_begin = part * chunk;
  const int c_end = min(c, c_begin + chunk);
  for (int ch = c_begin; ch < c_end; ++ch) {
    const T* plane = x + (n * c + ch) * hw;
    float acc = __fmul_rn(wt[0], in[0] ? widen(plane, off[0]) : 0.f);
#pragma unroll
    for (int k = 1; k < kTaps; ++k)
      acc = __fadd_rn(acc,
                      __fmul_rn(wt[k], in[k] ? widen(plane, off[k]) : 0.f));
    store(out, (n * c + ch) * hw2 + pix, acc);
  }
}


// Pass 1: softmax weights to the scratch, dw over the channels, the
// softmax's backward, un-shuffled into dlogits.
template <typename T>
__global__ void carafe_backward_logits_kernel(
    const T* __restrict__ x, const T* __restrict__ logits,
    const T* __restrict__ grad, int c, int h, int w, long long total,
    float* __restrict__ wts, T* __restrict__ dlogits) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= total) return;
  const int h2 = h * kUp, w2 = w * kUp;
  const long long hw2 = static_cast<long long>(h2) * w2;
  const int pix = static_cast<int>(t % hw2);
  const long long n = t / hw2;
  const int oy = pix / w2, ox = pix % w2;
  const int i = oy / kUp, j = ox / kUp;
  const int sub = (oy % kUp) * kUp + (ox % kUp);
  const long long hw = static_cast<long long>(h) * w;
  const long long src = static_cast<long long>(i) * w + j;

  float wt[kTaps];
  softmax_weights(logits + (n * (kUp * kUp * kTaps) + sub * kTaps) * hw +
                      src, hw, wt);
#pragma unroll
  for (int k = 0; k < kTaps; ++k) wts[(n * kTaps + k) * hw2 + pix] = wt[k];

  int off[kTaps];
  bool in[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int sy = i + k / kKUp - kPad, sx = j + k % kKUp - kPad;
    in[k] = sy >= 0 && sy < h && sx >= 0 && sx < w;
    off[k] = sy * w + sx;
  }
  float dw[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) dw[k] = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float g = widen(grad, (n * c + ch) * hw2 + pix);
    const T* plane = x + (n * c + ch) * hw;
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      if (in[k]) dw[k] = __fadd_rn(dw[k], __fmul_rn(g, widen(plane, off[k])));
  }
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    dot = __fadd_rn(dot, __fmul_rn(wt[k], dw[k]));
  T* dl = dlogits + (n * (kUp * kUp * kTaps) + sub * kTaps) * hw + src;
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    store(dl, k * hw, __fmul_rn(wt[k], __fsub_rn(dw[k], dot)));
}

// Pass 2: dx of a chunk of channels at one source pixel, gathered from the
// output pixels whose windows cover it.
template <typename T>
__global__ void carafe_backward_x_kernel(const T* __restrict__ grad,
                                         const float* __restrict__ wts,
                                         int c, int h, int w, int chunk,
                                         int n_chunks, long long total,
                                         T* __restrict__ dx) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= total) return;
  const long long hw = static_cast<long long>(h) * w;
  const int pix = static_cast<int>(t % hw);
  const long long r = t / hw;
  const int part = static_cast<int>(r % n_chunks);
  const long long n = r / n_chunks;
  const int sy = pix / w, sx = pix % w;
  const int w2 = w * kUp;
  const long long hw2 = hw * kUp * kUp;
  const int c_begin = part * chunk;
  const int nc = min(c, c_begin + chunk) - c_begin;

  float acc[kMaxChunk];
#pragma unroll
  for (int q = 0; q < kMaxChunk; ++q) acc[q] = 0.f;
  for (int k = 0; k < kTaps; ++k) {
    // the source pixel is tap k of the window centred on (i, j)
    const int i = sy + kPad - k / kKUp, j = sx + kPad - k % kKUp;
    if (i < 0 || i >= h || j < 0 || j >= w) continue;
    long long p[kUp * kUp];
    float wv[kUp * kUp];
#pragma unroll
    for (int q = 0; q < kUp * kUp; ++q) {
      p[q] = static_cast<long long>(i * kUp + q / kUp) * w2 + j * kUp +
             q % kUp;
      wv[q] = wts[(n * kTaps + k) * hw2 + p[q]];
    }
#pragma unroll
    for (int q = 0; q < kMaxChunk; ++q) {
      if (q >= nc) break;
      const T* g = grad + (n * c + c_begin + q) * hw2;
      float s = __fmul_rn(wv[0], widen(g, p[0]));
#pragma unroll
      for (int u = 1; u < kUp * kUp; ++u)
        s = __fadd_rn(s, __fmul_rn(wv[u], widen(g, p[u])));
      acc[q] = __fadd_rn(acc[q], s);
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxChunk; ++q) {
    if (q >= nc) break;
    store(dx, (n * c + c_begin + q) * hw + pix, acc[q]);
  }
}

}  // namespace

// x (B, c, h, w) and logits (B, 4*25, h, w), both float32 or both bf16
// (is_bf16); out (B, c, 2h, 2w) of the same dtype. `chunk` channels per
// thread. Returns cudaGetLastError() after the launch.
extern "C" int erd_carafe(const void* x, const void* logits, void* out,
                          int batch, int c, int h, int w, int chunk,
                          int is_bf16, void* stream) {
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (c + chunk - 1) / chunk;
  const long long total = static_cast<long long>(batch) * n_chunks * h * kUp *
                          w * kUp;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    carafe_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(logits), c, h, w, chunk, n_chunks,
        total, static_cast<__nv_bfloat16*>(out));
  } else {
    carafe_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(logits), c,
        h, w, chunk, n_chunks, total, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// x (B, c, h, w), logits (B, 4*25, h, w) and grad (B, c, 2h, 2w), all
// float32 or all bf16 (is_bf16); wts (B, 25, 2h, 2w) float32 scratch; dx
// and dlogits shaped and typed as x and logits. `chunk` (at most 16)
// channels per thread of pass 2. Returns cudaGetLastError() after the
// launches.
extern "C" int erd_carafe_backward(const void* x, const void* logits,
                                   const void* grad, void* wts, void* dx,
                                   void* dlogits, int batch, int c, int h,
                                   int w, int chunk, int is_bf16,
                                   void* stream) {
  if (chunk < 1 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(batch) * h * kUp * w * kUp;
  if (pixels <= 0 || c <= 0) return 0;
  const int n_chunks = (c + chunk - 1) / chunk;
  const long long sources = static_cast<long long>(batch) * n_chunks * h * w;
  const int threads = 256;
  const unsigned b1 = static_cast<unsigned>((pixels + threads - 1) / threads);
  const unsigned b2 = static_cast<unsigned>((sources + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wf = static_cast<float*>(wts);
  if (is_bf16) {
    using T = __nv_bfloat16;
    carafe_backward_logits_kernel<T><<<b1, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(logits),
        static_cast<const T*>(grad), c, h, w, pixels, wf,
        static_cast<T*>(dlogits));
    carafe_backward_x_kernel<T><<<b2, threads, 0, st>>>(
        static_cast<const T*>(grad), wf, c, h, w, chunk, n_chunks, sources,
        static_cast<T*>(dx));
  } else {
    carafe_backward_logits_kernel<float><<<b1, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(logits),
        static_cast<const float*>(grad), c, h, w, pixels, wf,
        static_cast<float*>(dlogits));
    carafe_backward_x_kernel<float><<<b2, threads, 0, st>>>(
        static_cast<const float*>(grad), wf, c, h, w, chunk, n_chunks,
        sources, static_cast<float*>(dx));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
