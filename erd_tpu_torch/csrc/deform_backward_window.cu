// The deformable im2col backward as a tiled design that stages a window
// of the map in shared memory: a measured alternative to csrc/
// deform_conv.cu's `erd_deform_im2col_backward`, on no path of the port.
// erd_tpu_torch/tools/atomic_backward_probe.py holds it to the plain
// version and times it beside the path's kernel.
//
// Design. A block of 256 threads takes one (image, deform group, kernel
// point, tile of tile_h x tile_w = 256 output pixels), a thread a pixel's
// sample, and walks the group's channels in chunks:
//   1. The window. The block finds the box of its samples' top-left
//      corners (those that can touch the map), plus one row and column
//      for the bottom-right corners. If that box fits the tile's receptive
//      field plus `margin` on each side, it is the window; else, per axis,
//      the receptive field plus the margin is. A sample is "inside" when
//      its 2x2 corner square lies in the window.
//   2. Per chunk, in shared memory: the map's values over the window (0
//      off the map) and a zeroed float32 accumulator of the map gradient,
//      as many channels as `capacity` elements hold.
//   3. Inside samples read their corners from the staged values and add
//      their four products to the accumulator with shared-memory atomics;
//      the others read and add on the global map (global atomics).
//   4. At the chunk's end the block adds its accumulator once into the
//      global float32 map gradient, on-map elements that received
//      something only, with atomics (the windows of neighbouring tiles
//      overlap), in the same pass that stages the next chunk.
// The offset and mask gradients stay in registers across the chunks,
// summed over the channels in order, as the path's kernel sums them.
// Arithmetic and the per-corner zero rule are csrc/deform_conv.cu's.
#include <climits>
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

// The window along one axis: the tile's samples' top-left corners span
// [lo, hi] (lo > hi: no sample touches the map); the window is [lo, hi + 1]
// when that fits `cap`, else the `cap` rows or columns from rf_lo; both
// within [-1, size].
__device__ __forceinline__ void place_window(int lo, int hi, int cap,
                                             int rf_lo, int size, int& start,
                                             int& len) {
  if (lo > hi) {
    start = 0;
    len = 0;
  } else if (hi + 2 - lo <= cap) {
    start = lo;
    len = hi + 2 - lo;
  } else {
    start = max(rf_lo, -1);
    len = max(0, min(rf_lo + cap, size + 1) - start);
  }
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

constexpr int kThreads = 256;

// A block: one (image, group, kernel point, tile of tile_h x tile_w =
// kThreads output pixels), a thread a pixel's sample. `capacity` elements
// of shared memory for each of the window's staged values (acc null: no
// map gradient) and its float32 accumulator (vals null: no offset
// gradient). One pass over a chunk's window: the accumulator of the `nf`
// channels from c_flush into the map gradient (on-map elements that
// received something) and zeroed for the next `ns` channels, whose values
// are staged from c_stage (0 off the map); rows over warps, columns over
// lanes.
template <typename T>
__device__ __forceinline__ void window_pass(
    const T* __restrict__ x, float* __restrict__ grad_x, float* acc, T* vals,
    size_t plane0, int h, int w, int wy0, int wh, int wx0, int ww,
    int c_flush, int nf, int c_stage, int ns) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t hw = static_cast<size_t>(h) * w;
  const int rows = max(nf, ns) * wh;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int cc = r / wh;
    const int yy = wy0 + (r - cc * wh);
    const bool row_on = yy >= 0 && yy < h;
    for (int col = lane; col < ww; col += 32) {
      const int xx = wx0 + col;
      const bool on = row_on && xx >= 0 && xx < w;
      const size_t at = static_cast<size_t>(yy) * w + xx;  // when `on`
      if (acc != nullptr) {
        if (cc < nf) {
          const float v = acc[r * ww + col];
          if (on && v != 0.f)
            atomicAdd(grad_x + plane0 + (c_flush + cc) * hw + at, v);
        }
        if (cc < ns) acc[r * ww + col] = 0.f;
      }
      if (vals != nullptr && cc < ns)
        vals[r * ww + col] = on ? x[plane0 + (c_stage + cc) * hw + at]
                                : zero_of<T>();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 6) window_backward_kernel(
    const T* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const float* __restrict__ grad, int cin,
    int h, int w, int ho, int wo, int k, int stride, int pad, int dil,
    int dg, int tile_h, int tile_w, int tiles_x, int tiles, int margin,
    int capacity, float* __restrict__ grad_x,
    float* __restrict__ grad_offset, float* __restrict__ grad_mask) {
  extern __shared__ float4 smem4[];
  __shared__ int bounds[4];
  const int kk = k * k, hw = ho * wo, cpg = cin / dg;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int kidx = static_cast<int>(blockIdx.x / tiles % kk);
  const long long rest = blockIdx.x / tiles / kk;
  const int g = static_cast<int>(rest % dg);
  const long long n = rest / dg;
  const int oy0 = tile / tiles_x * tile_h, ox0 = tile % tiles_x * tile_w;
  const int oy = oy0 + threadIdx.x / tile_w, ox = ox0 + threadIdx.x % tile_w;
  const bool live = oy < ho && ox < wo;
  const int pix = live ? oy * wo + ox : 0;
  const bool need_x = grad_x != nullptr, need_off = grad_offset != nullptr;
  float* acc = need_x ? reinterpret_cast<float*>(smem4) : nullptr;
  T* vals = need_off ? reinterpret_cast<T*>(reinterpret_cast<float*>(smem4) +
                                            (need_x ? capacity : 0))
                     : nullptr;

  // the sample, the first design's arithmetic
  const long long point = (n * dg + g) * kk + kidx;
  const int ky = kidx / k, kx = kidx % k;
  const float dy = offset[(point * 2) * hw + pix];
  const float dx = offset[(point * 2 + 1) * hw + pix];
  const float ys = __fadd_rn(static_cast<float>(oy * stride - pad + ky * dil),
                             dy);
  const float xs = __fadd_rn(static_cast<float>(ox * stride - pad + kx * dil),
                             dx);
  const float y0f = floorf(ys);
  const float x0f = floorf(xs);
  const float wy = __fsub_rn(ys, y0f);
  const float wx = __fsub_rn(xs, x0f);
  const float hy = __fsub_rn(1.f, wy);
  const float hx = __fsub_rn(1.f, wx);
  const int y0 = static_cast<int>(y0f);
  const int x0 = static_cast<int>(x0f);
  const float m = mask != nullptr ? mask[point * hw + pix] : 1.f;

  // the window: the box of the top-left corners of the tile's samples that
  // touch the map
  const bool touch = live && y0 >= -1 && y0 < h && x0 >= -1 && x0 < w;
  if (threadIdx.x == 0) {
    bounds[0] = bounds[2] = INT_MAX;
    bounds[1] = bounds[3] = INT_MIN;
  }
  __syncthreads();
  const int ylo = warp_min(touch ? y0 : INT_MAX);
  const int yhi = warp_max(touch ? y0 : INT_MIN);
  const int xlo = warp_min(touch ? x0 : INT_MAX);
  const int xhi = warp_max(touch ? x0 : INT_MIN);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(bounds, ylo);
    atomicMax(bounds + 1, yhi);
    atomicMin(bounds + 2, xlo);
    atomicMax(bounds + 3, xhi);
  }
  __syncthreads();
  int wy0, wh, wx0, ww;
  place_window(bounds[0], bounds[1], (tile_h - 1) * stride + 2 * margin + 2,
               oy0 * stride - pad + ky * dil - margin, h, wy0, wh);
  place_window(bounds[2], bounds[3], (tile_w - 1) * stride + 2 * margin + 2,
               ox0 * stride - pad + kx * dil - margin, w, wx0, ww);
  const int area = wh * ww;
  const bool inside = live && y0 >= wy0 && y0 + 1 < wy0 + wh &&
                      x0 >= wx0 && x0 + 1 < wx0 + ww;
  const int lin = (y0 - wy0) * ww + (x0 - wx0);
  const bool iny0 = y0 >= 0 && y0 < h, iny1 = y0 + 1 >= 0 && y0 + 1 < h;
  const bool inx0 = x0 >= 0 && x0 < w, inx1 = x0 + 1 >= 0 && x0 + 1 < w;
  const bool ok00 = iny0 && inx0, ok01 = iny0 && inx1;
  const bool ok10 = iny1 && inx0, ok11 = iny1 && inx1;
  const long long i00 = static_cast<long long>(y0) * w + x0;  // may be < 0
  // channels a chunk stages: as many as the capacity holds
  const int chunk = area > 0 ? max(1, min(cpg, capacity / area)) : cpg;
  const size_t plane0 = (static_cast<size_t>(n) * cin + g * cpg) *
                        static_cast<size_t>(h) * w;
  const float* gp = grad + ((static_cast<size_t>(n) * cin + g * cpg) * kk +
                            kidx) * hw + pix;

  window_pass(x, grad_x, acc, vals, plane0, h, w, wy0, wh, wx0, ww, 0, 0, 0,
              chunk);
  __syncthreads();
  float sy = 0.f, sx = 0.f, sm = 0.f;
  for (int c0 = 0; c0 < cpg; c0 += chunk) {
    const int nc = min(chunk, cpg - c0);
    if (live) {
#pragma unroll 4
      for (int cc = 0; cc < nc; ++cc) {
        const int c = c0 + cc;
        const float gc = gp[static_cast<size_t>(c) * kk * hw];
        if (need_x) {
          const float a = mask != nullptr ? __fmul_rn(gc, m) : gc;
          const float ahx = __fmul_rn(a, hx), awx = __fmul_rn(a, wx);
          if (inside) {
            float* q = acc + cc * area + lin;
            atomicAdd(q, __fmul_rn(ahx, hy));
            atomicAdd(q + 1, __fmul_rn(awx, hy));
            atomicAdd(q + ww, __fmul_rn(ahx, wy));
            atomicAdd(q + ww + 1, __fmul_rn(awx, wy));
          } else {
            float* q = grad_x + plane0 + static_cast<size_t>(c) * h * w;
            if (ok00) atomicAdd(q + i00, __fmul_rn(ahx, hy));
            if (ok01) atomicAdd(q + i00 + 1, __fmul_rn(awx, hy));
            if (ok10) atomicAdd(q + i00 + w, __fmul_rn(ahx, wy));
            if (ok11) atomicAdd(q + i00 + w + 1, __fmul_rn(awx, wy));
          }
        }
        if (need_off) {
          float v00, v01, v10, v11;
          if (inside) {
            const T* vp = vals + cc * area + lin;
            v00 = widen(vp, 0);
            v01 = widen(vp, 1);
            v10 = widen(vp, ww);
            v11 = widen(vp, ww + 1);
          } else {
            const T* xp = x + plane0 + static_cast<size_t>(c) * h * w;
            v00 = ok00 ? widen(xp, i00) : 0.f;
            v01 = ok01 ? widen(xp, i00 + 1) : 0.f;
            v10 = ok10 ? widen(xp, i00 + w) : 0.f;
            v11 = ok11 ? widen(xp, i00 + w + 1) : 0.f;
          }
          const float ty = __fadd_rn(__fmul_rn(__fsub_rn(v10, v00), hx),
                                     __fmul_rn(__fsub_rn(v11, v01), wx));
          const float tx = __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), hy),
                                     __fmul_rn(__fsub_rn(v11, v10), wy));
          sy = __fadd_rn(sy, __fmul_rn(gc, ty));
          sx = __fadd_rn(sx, __fmul_rn(gc, tx));
          if (mask != nullptr) {
            float v = __fmul_rn(__fmul_rn(v00, hy), hx);
            v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, hy), wx));
            v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), hx));
            v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
            sm = __fadd_rn(sm, __fmul_rn(gc, v));
          }
        }
      }
    }
    __syncthreads();
    const int next = c0 + nc;
    window_pass(x, grad_x, acc, vals, plane0, h, w, wy0, wh, wx0, ww, c0, nc,
                next, min(chunk, cpg - next));
    __syncthreads();
  }
  if (need_off && live) {
    grad_offset[(point * 2) * hw + pix] =
        mask != nullptr ? __fmul_rn(sy, m) : sy;
    grad_offset[(point * 2 + 1) * hw + pix] =
        mask != nullptr ? __fmul_rn(sx, m) : sx;
    if (grad_mask != nullptr) grad_mask[point * hw + pix] = sm;
  }
}

}  // namespace

// A block's shared memory at most (227 KB on sm_90).
constexpr long long kMaxSharedBytes = 232448;

// The gradients of csrc/deform_conv.cu's erd_deform_im2col, arguments as
// erd_deform_im2col_backward's there (grad_x a ZEROED float32 buffer),
// and: tiles of tile_h x tile_w = 256 output pixels, one block for each
// (image, group, kernel point, tile); windows of at most the tile's span
// plus `margin` on each side; `capacity` window elements in each shared
// buffer (the staged map values when grad_offset is asked for, float32
// accumulators when grad_x is). One launch. Returns cudaGetLastError()
// after it.
extern "C" int erd_deform_backward_window(
    const void* x, const void* offset, const void* mask, const void* grad,
    void* grad_x, void* grad_offset, void* grad_mask, int batch, int cin,
    int h, int w, int ho, int wo, int k, int stride, int pad, int dil,
    int dg, int is_bf16, int tile_h, int tile_w, int margin, int capacity,
    void* stream) {
  if (dg < 1 || cin % dg != 0 || k < 1 || tile_h * tile_w != kThreads ||
      tile_h < 1 || margin < 0 ||
      (grad_mask != nullptr && (mask == nullptr || grad_offset == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * ho * wo <= 0 ||
      (grad_x == nullptr && grad_offset == nullptr))
    return 0;
  const long long window =
      ((tile_h - 1) * static_cast<long long>(stride) + 2 * margin + 2) *
      ((tile_w - 1) * static_cast<long long>(stride) + 2 * margin + 2);
  const long long bytes =
      static_cast<long long>(capacity) *
      ((grad_x != nullptr ? 4 : 0) +
       (grad_offset != nullptr ? (is_bf16 ? 2 : 4) : 0));
  if (capacity < window || bytes > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (wo + tile_w - 1) / tile_w;
  const int tiles = tiles_x * ((ho + tile_h - 1) / tile_h);
  const long long blocks = static_cast<long long>(batch) * dg * k * k * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offset);
  const float* msk = static_cast<const float*>(mask);
  const float* g = static_cast<const float*>(grad);
  float* gx = static_cast<float*>(grad_x);
  float* goff = static_cast<float*>(grad_offset);
  float* gm = static_cast<float*>(grad_mask);
  const int sb = static_cast<int>(bytes);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (is_bf16) {
    auto kernel = window_backward_kernel<__nv_bfloat16>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sb);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<nb, kThreads, sb, st>>>(
        static_cast<const __nv_bfloat16*>(x), off, msk, g, cin, h, w, ho, wo,
        k, stride, pad, dil, dg, tile_h, tile_w, tiles_x, tiles, margin,
        capacity, gx, goff, gm);
  } else {
    auto kernel = window_backward_kernel<float>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sb);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<nb, kThreads, sb, st>>>(
        static_cast<const float*>(x), off, msk, g, cin, h, w, ho, wo, k,
        stride, pad, dil, dg, tile_h, tile_w, tiles_x, tiles, margin,
        capacity, gx, goff, gm);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
