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
// Layout: a block takes a tile of source pixels of one image (and a group
// of its channels where the tiles alone would leave SMs idle), a thread a
// source pixel (i, j). The thread reads its pixel's 4 x 25 logits
// (erd_tpu's channel order (a*2 + b)*25 + k, not F.pixel_shuffle's) and
// computes the 4 sub-pixels' softmax weights once into registers,
// exp(l - max) / sum with the sum taken in tap order. x of the tile and its
// 2-pixel halo (zero off the map) is staged in shared memory a chunk of
// channels at a time, by asynchronous copies (cp.async) into a ring of
// stages, the next chunks' copies in flight while a chunk is summed. For
// each channel the thread reads its 25 taps from shared memory once, each
// serving the 4 outputs (2i + a, 2j + b), sums each output's taps in order
// k = 0..24 in float32 (bf16 maps widened in registers), and stores the
// two outputs of a row together in the map's dtype.
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
// take 0.013 ms at 67 TFLOP/s. Rounded on their own, the multiplies and
// adds are 49 instructions an output, not 25: at one a lane a clock the
// floor of the batch-16 call at 100x168 (275 M outputs) is ~0.46 ms.
//
// Backward (`erd_carafe_backward`), which erd_tpu got by autodiff of the
// shuffle, the float32 softmax and the einsum: two launches in one call,
// no scratch. Both work on tiles of kTileH x kTileW source pixels of one
// image, a thread a source pixel (window centre), and recompute the
// softmax weights from the logits as the forward computes them. Each
// stages its inputs a channel chunk at a time with asynchronous copies
// (cp.async) into a ring of shared-memory stages, the next chunks' copies
// in flight while a chunk is summed.
//  1. dlogits (`carafe_backward_logits_kernel`): the thread's 4 output
//     pixels x 25 taps, dw[k][sub] = sum_c g[c, sub] * xpad[c, tap k], as
//     float32 sums in registers over every channel, in channel order with
//     fused multiply-adds, from x of the chunk with its 2-pixel halo (zero
//     off the map) and the tile's output gradient, both staged. Then the
//     softmax's backward dlogit[k] = w[k] * (dw[k] - sum_j w[j] dw[j]),
//     written to erd_tpu's channel (a*2 + b)*25 + k of the source pixel
//     in the logits' dtype.
//  2. dx (`carafe_backward_x_kernel`): the thread's source pixel q is tap
//     k of the window centred on q - (k / 5 - 2, k % 5 - 2); its 100
//     weights w[k][sub] of those windows go into registers once, from the
//     softmax statistics (max, sum) of the tile's and the halo's centres
//     kept in shared memory. Then for each channel chunk the output
//     gradient of the tile's and the halo's centres is staged (a centre's
//     4 sub-pixels in 8 bytes for bf16, 16 for float32), and dx[c, q] =
//     the sum over sub-pixels in order of the sums over k in order of
//     w * g (fused multiply-adds), rounded once to x's dtype. Channel
//     groups split the small maps' calls across blocks.
// No atomics, and every sum runs in a fixed order: deterministic. The
// sums run in another order than the plain version's (torch's channel
// reduction), with FMAs, so they agree to float32 rounding, not to the
// bit.
// Bound: operations, about 50 float32 flops per (channel, output pixel)
// in each launch (27.5 GFLOP, 0.41 ms at 67 TFLOP/s, for the 100x168 call
// of a batch-16 step), above the bytes (x, logits and g read, dx and
// dlogits written: 0.93 GB in bf16, 0.28 ms at 3.35 TB/s); the bound
// `chip_smoke.py` states counts dw as bf16 tensor-core work. Shared
// memory sets the pace once the copies are hidden: 25 staged x reads per
// channel and centre in the first launch, 25 8-byte g reads per channel
// and pixel in the second.
#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kUp = 2;
constexpr int kKUp = 5;
constexpr int kTaps = kKUp * kKUp;
constexpr int kPad = (kKUp - 1) / 2;
// the backward's tiles of source pixels (a thread each), the multiple of
// channels a channel group of the dx launch holds, and the tiles' 2-pixel
// halos
constexpr int kTileH = 4;
constexpr int kTileW = 32;
constexpr int kChunk = 8;
constexpr int kHaloH = kTileH + 2 * kPad;
constexpr int kHaloW = kTileW + 2 * kPad;
constexpr int kHalo = kHaloH * kHaloW;

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

// Asynchronous copies into shared memory (cp.async): 4 or 8 bytes from
// src, aligned alike, or zeros where !valid (src is then not read).
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy8(void* dst, const void* src,
                                      bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of copies are still pending
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a pair of consecutive elements (4- or 8-byte aligned), widened
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// copy one pair of elements of T (4 or 8 bytes)
template <typename T>
__device__ __forceinline__ void copy_pair(T* dst, const T* src, bool valid) {
  if constexpr (sizeof(T) == 2)
    copy4(dst, src, valid);
  else
    copy8(dst, src, valid);
}

// The forward's tiles: kFwdTileH x kFwdTileW source pixels of one image,
// a thread each (the FPN levels of an 800x1344 canvas, 25 / 50 / 100 x
// 42 / 84 / 168, take them with no idle row or column), their 2-pixel
// halo, and the channels a stage holds.
constexpr int kFwdTileH = 5;
constexpr int kFwdTileW = 42;
constexpr int kFwdThreads = kFwdTileH * kFwdTileW;
constexpr int kFwdHaloH = kFwdTileH + 2 * kPad;
constexpr int kFwdHaloW = kFwdTileW + 2 * kPad;
constexpr int kFwdHalo = kFwdHaloH * kFwdHaloW;
constexpr int kFwdChunk = 8;
constexpr int kFwdStages = 3;

// The forward's copies of one chunk into a stage: x of the tile and its
// halo, zero off the map (element pairs where `pairs`: bf16 on an even
// width from a 4-byte aligned map, so that pairs are aligned; float32
// element by element; bf16 otherwise through registers).
template <typename T>
__device__ __forceinline__ void stage_forward_chunk(
    T (*xs)[kFwdHaloH][kFwdHaloW], const T* __restrict__ x, long long n,
    int c, int c0, int c_end, int h, int w, int i0, int j0, bool pairs,
    int t) {
  const int nch = min(kFwdChunk, c_end - c0);
  const long long hw = static_cast<long long>(h) * w;
  if (sizeof(T) == 2 && pairs) {
    constexpr int kPairs = kFwdHalo / 2;
    for (int e = t; e < kFwdChunk * kPairs; e += kFwdThreads) {
      const int ch = e / kPairs, p = 2 * (e % kPairs);
      const int sy = i0 - kPad + p / kFwdHaloW;
      const int sx = j0 - kPad + p % kFwdHaloW;
      const bool ok = ch < nch && sy >= 0 && sy < h && sx >= 0 && sx < w;
      copy4(&xs[ch][p / kFwdHaloW][p % kFwdHaloW],
            ok ? x + (n * c + c0 + ch) * hw + sy * w + sx : x, ok);
    }
  } else {
    for (int e = t; e < kFwdChunk * kFwdHalo; e += kFwdThreads) {
      const int ch = e / kFwdHalo, p = e % kFwdHalo;
      const int sy = i0 - kPad + p / kFwdHaloW;
      const int sx = j0 - kPad + p % kFwdHaloW;
      const bool ok = ch < nch && sy >= 0 && sy < h && sx >= 0 && sx < w;
      const T* src = ok ? x + (n * c + c0 + ch) * hw + sy * w + sx : x;
      if constexpr (sizeof(T) == 4)
        copy4(&xs[ch][p / kFwdHaloW][p % kFwdHaloW], src, ok);
      else
        xs[ch][p / kFwdHaloW][p % kFwdHaloW] = ok ? *src : T(0.f);
    }
  }
}

// two horizontally neighbouring outputs, stored together
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The forward. Block kFwdThreads threads, grid (tiles across, tiles down,
// B * groups); a block takes `per_group` channels from per_group *
// (blockIdx.z % groups). A thread's source pixel (i, j): its 4 x 25
// softmax weights once into registers, then for each staged channel its
// 25 taps read from shared memory once each, each serving the 4 outputs
// (2i + a, 2j + b), a = sub / 2, b = sub % 2, summed in tap order, every
// product and sum rounded on its own. The chunks' copies run
// kFwdStages - 1 chunks ahead of the sums (cp.async).
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 2)
carafe_kernel(const T* __restrict__ x, const T* __restrict__ logits, int c,
              int h, int w, int groups, int per_group, bool pairs,
              T* __restrict__ out) {
  __shared__ __align__(16) T xs[kFwdStages][kFwdChunk][kFwdHaloH][kFwdHaloW];
  const int t = threadIdx.x;
  const int ty = t / kFwdTileW, tx = t % kFwdTileW;
  const int i0 = blockIdx.y * kFwdTileH, j0 = blockIdx.x * kFwdTileW;
  const int i = i0 + ty, j = j0 + tx;
  const long long n = blockIdx.z / groups;
  const int c_begin = per_group * (blockIdx.z % groups);
  const int c_end = min(c, c_begin + per_group);
  const bool mine = i < h && j < w;
  const long long hw = static_cast<long long>(h) * w;
  const int chunks = (c_end - c_begin + kFwdChunk - 1) / kFwdChunk;
  for (int k = 0; k < kFwdStages - 1; ++k) {
    if (k < chunks)
      stage_forward_chunk(xs[k], x, n, c, c_begin + k * kFwdChunk, c_end, h,
                          w, i0, j0, pairs, t);
    copies_commit();
  }

  // the 4 sub-pixels' softmax weights, under the first chunks' copies
  float wt[kUp * kUp][kTaps];
  if (mine) {
    const T* lg = logits + n * (kUp * kUp * kTaps) * hw +
                  static_cast<long long>(i) * w + j;
#pragma unroll
    for (int q = 0; q < kUp * kUp; ++q)
      softmax_weights(lg + q * kTaps * hw, hw, wt[q]);
  }

  const int w2 = kUp * w;
  const long long hw2 = static_cast<long long>(kUp * h) * w2;
  const long long row0 = static_cast<long long>(kUp * i) * w2 + kUp * j;
  for (int it = 0; it < chunks; ++it) {
    const int ahead = it + kFwdStages - 1;
    if (ahead < chunks)
      stage_forward_chunk(xs[ahead % kFwdStages], x, n, c,
                          c_begin + ahead * kFwdChunk, c_end, h, w, i0, j0,
                          pairs, t);
    copies_commit();
    copies_wait<kFwdStages - 1>();  // chunk it's copies have landed
    __syncthreads();
    const int c0 = c_begin + it * kFwdChunk;
    const int nch = min(kFwdChunk, c_end - c0);
    const T(*xc)[kFwdHaloH][kFwdHaloW] = xs[it % kFwdStages];
    if (mine) {
      for (int ch = 0; ch < nch; ++ch) {
        float a[kUp * kUp];
        {
          const float v = widen(&xc[ch][ty][tx], 0);
#pragma unroll
          for (int q = 0; q < kUp * kUp; ++q) a[q] = __fmul_rn(wt[q][0], v);
        }
#pragma unroll
        for (int k = 1; k < kTaps; ++k) {
          const float v = widen(&xc[ch][ty + k / kKUp][tx + k % kKUp], 0);
#pragma unroll
          for (int q = 0; q < kUp * kUp; ++q)
            a[q] = __fadd_rn(a[q], __fmul_rn(wt[q][k], v));
        }
        T* o = out + (n * c + c0 + ch) * hw2 + row0;
        store_pair(o, a[0], a[1]);
        store_pair(o + w2, a[2], a[3]);
      }
    }
    __syncthreads();  // the stage is read before it is refilled
  }
}

constexpr int kThreads = kTileH * kTileW;
// launch 1: channels a chunk, and chunks in flight (a ring of stages)
constexpr int kChunk1 = 4;
constexpr int kStages1 = 3;

// Launch 1's copies of one chunk into a stage: x of the tile and its halo
// (element pairs where the map's width is even, so that pairs are
// aligned; float32 element by element; bf16 on an odd width through
// registers), and the tile's 2 x 2 output-gradient pixels (pairs).
template <typename T>
__device__ __forceinline__ void stage_logits_chunk(
    T (*xs)[kHaloH][kHaloW], T (*gsm)[2 * kTileH][2 * kTileW],
    const T* __restrict__ x, const T* __restrict__ grad, long long n, int c,
    int c0, int h, int w, int i0, int j0, int t) {
  const int nch = min(kChunk1, c - c0);
  const long long hw = static_cast<long long>(h) * w;
  if (sizeof(T) == 2 && w % 2 == 0) {
    constexpr int kPairs = kHaloH * kHaloW / 2;
    for (int e = t; e < kChunk1 * kPairs; e += kThreads) {
      const int ch = e / kPairs, p = 2 * (e % kPairs);
      const int sy = i0 - kPad + p / kHaloW, sx = j0 - kPad + p % kHaloW;
      const bool ok = ch < nch && sy >= 0 && sy < h && sx >= 0 && sx < w;
      copy4(&xs[ch][p / kHaloW][p % kHaloW],
            ok ? x + (n * c + c0 + ch) * hw + sy * w + sx : x, ok);
    }
  } else {
    for (int e = t; e < kChunk1 * kHalo; e += kThreads) {
      const int ch = e / kHalo, p = e % kHalo;
      const int sy = i0 - kPad + p / kHaloW, sx = j0 - kPad + p % kHaloW;
      const bool ok = ch < nch && sy >= 0 && sy < h && sx >= 0 && sx < w;
      const T* src = ok ? x + (n * c + c0 + ch) * hw + sy * w + sx : x;
      if constexpr (sizeof(T) == 4)
        copy4(&xs[ch][p / kHaloW][p % kHaloW], src, ok);
      else
        xs[ch][p / kHaloW][p % kHaloW] = ok ? *src : T(0.f);
    }
  }
  constexpr int kGPairs = 2 * kTileH * kTileW;  // pairs of a channel
  for (int e = t; e < kChunk1 * kGPairs; e += kThreads) {
    const int ch = e / kGPairs, r = e % kGPairs / kTileW, q = e % kTileW;
    const int gy = 2 * i0 + r;
    const bool ok = ch < nch && gy < 2 * h && j0 + q < w;
    copy_pair(&gsm[ch][r][2 * q],
              ok ? grad + ((n * c + c0 + ch) * 4 * hw +
                           static_cast<long long>(gy) * 2 * w + 2 * (j0 + q))
                 : grad,
              ok);
  }
}

// Launch 1: dw of the tile's centres over every channel, then dlogits.
// Block (kTileW, kTileH) threads, grid (tiles across, tiles down, B). The
// chunks' copies run kStages1 - 1 chunks ahead of the sums (cp.async).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
carafe_backward_logits_kernel(const T* __restrict__ x,
                              const T* __restrict__ logits,
                              const T* __restrict__ grad, int c, int h,
                              int w, T* __restrict__ dlogits) {
  __shared__ __align__(16) T xs[kStages1][kChunk1][kHaloH][kHaloW];
  __shared__ __align__(16) T gsm[kStages1][kChunk1][2 * kTileH][2 * kTileW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kTileW + tx;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  const int i = i0 + ty, j = j0 + tx;
  const long long n = blockIdx.z;
  const bool mine = i < h && j < w;
  const long long hw = static_cast<long long>(h) * w;
  float dw[kTaps][kUp * kUp];
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
#pragma unroll
    for (int q = 0; q < kUp * kUp; ++q) dw[k][q] = 0.f;

  const int chunks = (c + kChunk1 - 1) / kChunk1;
  for (int k = 0; k < kStages1 - 1; ++k) {
    if (k < chunks)
      stage_logits_chunk(xs[k], gsm[k], x, grad, n, c, k * kChunk1, h, w,
                         i0, j0, t);
    copies_commit();
  }
  for (int it = 0; it < chunks; ++it) {
    const int ahead = it + kStages1 - 1;
    if (ahead < chunks)
      stage_logits_chunk(xs[ahead % kStages1], gsm[ahead % kStages1], x,
                         grad, n, c, ahead * kChunk1, h, w, i0, j0, t);
    copies_commit();
    copies_wait<kStages1 - 1>();  // chunk it's copies have landed
    __syncthreads();
    const int st = it % kStages1;
    const int nch = min(kChunk1, c - it * kChunk1);
    if (mine) {
#pragma unroll
      for (int ch = 0; ch < kChunk1; ++ch) {
        if (ch >= nch) break;
        const float2 g0 = pair(&gsm[st][ch][2 * ty][2 * tx]);
        const float2 g1 = pair(&gsm[st][ch][2 * ty + 1][2 * tx]);
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const float v = widen(&xs[st][ch][ty + k / kKUp][tx + k % kKUp], 0);
          dw[k][0] = __fmaf_rn(g0.x, v, dw[k][0]);
          dw[k][1] = __fmaf_rn(g0.y, v, dw[k][1]);
          dw[k][2] = __fmaf_rn(g1.x, v, dw[k][2]);
          dw[k][3] = __fmaf_rn(g1.y, v, dw[k][3]);
        }
      }
    }
    __syncthreads();  // the stage is read before it is refilled
  }
  if (!mine) return;
  const long long src = static_cast<long long>(i) * w + j;
#pragma unroll
  for (int q = 0; q < kUp * kUp; ++q) {  // sub-pixel (q / 2, q % 2)
    const long long base = (n * (kUp * kUp * kTaps) + q * kTaps) * hw + src;
    float wt[kTaps];
    softmax_weights(logits + base, hw, wt);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) dot = __fmaf_rn(wt[k], dw[k][q], dot);
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      store(dlogits + base, k * hw,
            __fmul_rn(wt[k], __fsub_rn(dw[k][q], dot)));
  }
}

// The staged form of a source pixel's 4 output-gradient values (rows 2i
// and 2i + 1, columns 2j and 2j + 1): float4 for float32, the two bf16
// pairs as they lie for bf16 (half the shared memory read a tap), widened
// when read.
template <typename T>
struct Staged;

template <>
struct Staged<float> {
  using type = float4;
  static __device__ float4 widen4(const float4& v) { return v; }
};

template <>
struct Staged<__nv_bfloat16> {
  using type = uint2;
  static __device__ float4 widen4(const uint2& v) {  // exact, as widen
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
};

// launch 2: channels a chunk (within 48 KB of shared memory with two
// stages and the softmax statistics)
template <typename T>
__host__ __device__ constexpr int chunk2() {
  return sizeof(T) == 2 ? 8 : 4;
}

// Launch 2's copies of one chunk into a stage: the output gradient of the
// tile's and the halo's centres, each centre's two rows as pairs.
template <typename T>
__device__ __forceinline__ void stage_x_chunk(
    typename Staged<T>::type (*gs)[kHalo], const T* __restrict__ grad,
    long long n, int c, int c0, int c_end, int h, int w, int i0, int j0,
    int t) {
  constexpr int kC = chunk2<T>();
  const int nch = min(kC, c_end - c0);
  const long long hw = static_cast<long long>(h) * w;
  for (int e = t; e < kC * kHalo * 2; e += kThreads) {
    const int ch = e / (2 * kHalo), p = e % (2 * kHalo) / 2, row = e % 2;
    const int sy = i0 - kPad + p / kHaloW, sx = j0 - kPad + p % kHaloW;
    const bool ok = ch < nch && sy >= 0 && sy < h && sx >= 0 && sx < w;
    copy_pair(reinterpret_cast<T*>(&gs[ch][p]) + 2 * row,
              ok ? grad + ((n * c + c0 + ch) * 4 * hw +
                           static_cast<long long>(2 * sy + row) * 2 * w +
                           2 * sx)
                 : grad,
              ok);
  }
}

// Launch 2: dx. Block (kTileW, kTileH) threads, grid (tiles across, tiles
// down, B * groups); a block takes `per_group` channels from
// per_group * (blockIdx.z % groups). The next chunk's copies run while a
// chunk is summed.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
carafe_backward_x_kernel(const T* __restrict__ logits,
                         const T* __restrict__ grad, int c, int h, int w,
                         int groups, int per_group, T* __restrict__ dx) {
  using S = Staged<T>;
  constexpr int kC = chunk2<T>();
  __shared__ __align__(16) typename S::type gs[2][kC][kHalo];
  __shared__ float smax[kUp * kUp][kHalo], ssum[kUp * kUp][kHalo];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kTileW + tx;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  const int i = i0 + ty, j = j0 + tx;
  const long long n = blockIdx.z / groups;
  const int c_begin = per_group * (blockIdx.z % groups);
  const int c_end = min(c, c_begin + per_group);
  const bool mine = i < h && j < w;
  const long long hw = static_cast<long long>(h) * w;
  const T* lg = logits + n * (kUp * kUp * kTaps) * hw;
  if (c_begin < c_end)  // the first chunk's copies run under the weights
    stage_x_chunk<T>(gs[0], grad, n, c, c_begin, c_end, h, w, i0, j0, t);
  copies_commit();

  // the softmax statistics of every (centre, sub-pixel) of tile and halo,
  // the 25 logits of one loaded together
  for (int e = t; e < kUp * kUp * kHalo; e += kThreads) {
    const int q = e / kHalo, p = e % kHalo;
    const int sy = i0 - kPad + p / kHaloW, sx = j0 - kPad + p % kHaloW;
    float mx = 0.f, sum = 1.f;
    if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
      const T* l = lg + q * kTaps * hw + sy * w + sx;
      float lv[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) lv[k] = widen(l, k * hw);
      mx = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) mx = fmaxf(mx, lv[k]);
      sum = 0.f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        sum = __fadd_rn(sum, expf(__fsub_rn(lv[k], mx)));
    }
    smax[q][p] = mx;
    ssum[q][p] = sum;
  }
  __syncthreads();
  // q is tap k of the centre at halo place (ty + 4 - k / 5, tx + 4 - k % 5)
  float wq[kTaps][kUp * kUp];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int cy = i + kPad - k / kKUp, cx = j + kPad - k % kKUp;
    const int p = (ty + 2 * kPad - k / kKUp) * kHaloW + tx + 2 * kPad -
                  k % kKUp;
    const bool on = mine && cy >= 0 && cy < h && cx >= 0 && cx < w;
#pragma unroll
    for (int q = 0; q < kUp * kUp; ++q)
      wq[k][q] = on ? __fdiv_rn(expf(__fsub_rn(
                                    widen(lg, (q * kTaps + k) * hw +
                                                  cy * w + cx),
                                    smax[q][p])),
                                ssum[q][p])
                    : 0.f;
  }

  for (int c0 = c_begin, it = 0; c0 < c_end; c0 += kC, ++it) {
    if (c0 + kC < c_end)
      stage_x_chunk<T>(gs[(it + 1) % 2], grad, n, c, c0 + kC, c_end, h, w,
                       i0, j0, t);
    copies_commit();
    copies_wait<1>();  // this chunk's copies have landed
    __syncthreads();
    const int nch = min(kC, c_end - c0);
    const typename S::type (*g)[kHalo] = gs[it % 2];
    if (mine) {
      // two channels at once, a sum per (channel, sub-pixel) over the
      // taps in order, then the four in order: eight independent chains
      for (int ch = 0; ch < nch; ch += 2) {
        const int ch1 = min(ch + 1, nch - 1);
        float a[kUp * kUp] = {0.f, 0.f, 0.f, 0.f};
        float b[kUp * kUp] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const int p = (ty + 2 * kPad - k / kKUp) * kHaloW + tx + 2 * kPad -
                        k % kKUp;
          const float4 g0 = S::widen4(g[ch][p]);
          const float4 g1 = S::widen4(g[ch1][p]);
          a[0] = __fmaf_rn(wq[k][0], g0.x, a[0]);
          a[1] = __fmaf_rn(wq[k][1], g0.y, a[1]);
          a[2] = __fmaf_rn(wq[k][2], g0.z, a[2]);
          a[3] = __fmaf_rn(wq[k][3], g0.w, a[3]);
          b[0] = __fmaf_rn(wq[k][0], g1.x, b[0]);
          b[1] = __fmaf_rn(wq[k][1], g1.y, b[1]);
          b[2] = __fmaf_rn(wq[k][2], g1.z, b[2]);
          b[3] = __fmaf_rn(wq[k][3], g1.w, b[3]);
        }
        const long long at = (n * c + c0 + ch) * hw +
                             static_cast<long long>(i) * w + j;
        store(dx, at,
              __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]));
        if (ch + 1 < nch)
          store(dx, at + hw,
                __fadd_rn(__fadd_rn(__fadd_rn(b[0], b[1]), b[2]), b[3]));
      }
    }
    __syncthreads();  // the stage is read before it is refilled
  }
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* logits,
                            const void* grad, void* dx, void* dlogits,
                            int batch, int c, int h, int w, int groups,
                            int per_group, cudaStream_t st) {
  const dim3 block(kTileW, kTileH);
  const unsigned across = (w + kTileW - 1) / kTileW;
  const unsigned down = (h + kTileH - 1) / kTileH;
  carafe_backward_logits_kernel<T><<<dim3(across, down, batch), block, 0,
                                      st>>>(
      static_cast<const T*>(x), static_cast<const T*>(logits),
      static_cast<const T*>(grad), c, h, w, static_cast<T*>(dlogits));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carafe_backward_x_kernel<T><<<dim3(across, down, batch * groups), block, 0,
                                 st>>>(
      static_cast<const T*>(logits), static_cast<const T*>(grad), c, h, w,
      groups, per_group, static_cast<T*>(dx));
  return cudaGetLastError();
}

}  // namespace

// x (B, c, h, w) and logits (B, 4*25, h, w), both float32 or both bf16
// (is_bf16); out (B, c, 2h, 2w) of the same dtype. The channels are split
// into groups where the image tiles alone would leave the card's SMs
// (`sms`) short of blocks. Returns cudaGetLastError() after the launch.
extern "C" int erd_carafe(const void* x, const void* logits, void* out,
                          int batch, int c, int h, int w, int sms,
                          int is_bf16, void* stream) {
  if (static_cast<long long>(batch) * h * w <= 0 || c <= 0) return 0;
  const unsigned across = (w + kFwdTileW - 1) / kFwdTileW;
  const unsigned down = (h + kFwdTileH - 1) / kFwdTileH;
  const long long tiles = static_cast<long long>(batch) * across * down;
  const int chunks = (c + kFwdChunk - 1) / kFwdChunk;
  // about 4 blocks an SM
  const long long want = (4LL * sms + tiles - 1) / tiles;
  const int split = static_cast<int>(
      std::min<long long>(std::max(want, 1LL), chunks));
  const int per_group = (chunks + split - 1) / split * kFwdChunk;
  const int groups = (c + per_group - 1) / per_group;
  const dim3 grid(across, down, batch * groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bool pairs = w % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
    carafe_kernel<__nv_bfloat16><<<grid, kFwdThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(logits), c, h, w, groups,
        per_group, pairs, static_cast<__nv_bfloat16*>(out));
  } else {
    carafe_kernel<float><<<grid, kFwdThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(logits), c,
        h, w, groups, per_group, false, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// x (B, c, h, w), logits (B, 4*25, h, w) and grad (B, c, 2h, 2w), all
// float32 or all bf16 (is_bf16); dx and dlogits shaped and typed as x and
// logits. The dx launch splits the channels into groups where the image
// tiles alone would leave the card's SMs (`sms`) short of blocks.
// Returns cudaGetLastError() after the launches.
extern "C" int erd_carafe_backward(const void* x, const void* logits,
                                   const void* grad, void* dx,
                                   void* dlogits, int batch, int c, int h,
                                   int w, int sms, int is_bf16,
                                   void* stream) {
  if (static_cast<long long>(batch) * h * w <= 0 || c <= 0) return 0;
  const long long tiles = static_cast<long long>(batch) *
                          ((h + kTileH - 1) / kTileH) *
                          ((w + kTileW - 1) / kTileW);
  const int chunks = (c + kChunk - 1) / kChunk;
  // about 8 blocks an SM
  const long long want = (8LL * sms + tiles - 1) / tiles;
  const int split = static_cast<int>(
      std::min<long long>(std::max(want, 1LL), chunks));
  const int per_group = (chunks + split - 1) / split * kChunk;
  const int groups = (c + per_group - 1) / per_group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_backward<__nv_bfloat16>(x, logits, grad, dx, dlogits,
                                               batch, c, h, w, groups,
                                               per_group, st)
              : launch_backward<float>(x, logits, grad, dx, dlogits, batch,
                                       c, h, w, groups, per_group, st));
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
