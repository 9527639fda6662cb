// Multi-level aligned RoIAlign, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/roi_align.py `multilevel_roi_align` (with
// `roi_align` and `_bilinear_gather`), as erd_tpu/models/detectors/
// faster_rcnn.py `_roi_feats` calls it. On the TPU every RoI was sampled on
// all four FPN levels (static shapes) and a one-hot over the level map
// picked one; here each RoI reads only its own level, which gives the same
// numbers (x * 1 + 0 + 0 + 0 == x for finite x) at a quarter of the work.
// The level map is an input, computed once by the caller, so the kernel and
// the plain version see the same levels.
//
// Forward design (the comment above `roi_align_kernel` has the details).
// ran a thread per output element, each recomputing its RoI's geometry
// (nine IEEE divides, six axis samples), which set its pace: without its
// map reads it kept ~80 % of its time at a bs-16 training call
// (erd_tpu_torch/tools/atomic_backward_probe.py, part 7). Now a block
// takes one (image, RoI), image-major, computes the RoI's sample rows and
// columns once into shared tables, and its warps walk down the sample
// rows of four channels at a time, a lane a sample column, reading each
// pixel row once where neighbouring sample rows share it (training RoIs
// are ~6-16 pixels on their level, so they do). Each output still sums
// its samples in the plain version's order: sample rows outer, sample
// columns inner, each sample v00*hy*hx + v01*hy*lx + v10*ly*hx +
// v11*ly*lx left to right (bf16 maps widened, the values of erd_tpu's
// astype(float32)), then one divide by sampling_ratio^2. Every op is
// rounded on its own (the library is built with -fmad=false), so kernel
// and plain version agree to the bit.
//
// Boundary rules of _bilinear_gather: a sample outside [-1, H] x [-1, W]
// is 0; inside, the coordinate clamps at 0; y_low = min(int(y), H - 1), and
// where y_low >= H - 1 the sample takes row H - 1 with weight 0 on the next
// one (likewise in x).
//
// Bound on this card: bytes. The output is B * R * C * out^2 floats (411
// MB at a bs-16 box call, 1.64 GB at the out-14 mask call) and must be
// written; the reads are the feature pixels under the RoIs. The exact
// arithmetic (48 float32 operations an output) takes about as long as the
// output's write at 67 TFLOP/s, and with the walk's tests and shuffles it
// sets the pace.
//
// Backward (`erd_roi_align_backward`): the transpose of the same gathers,
// which erd_tpu got by autodiff (a scatter-add of each sample's four
// corners into the level map, 0 * g for the RoIs of other levels).
// Bound: bytes. At the box call of a bs-16 800x1344 step (R = 512, C =
// 256, out 7) it reads the (B, R, C, 7, 7) float32 output gradient (0.41
// GB) and writes P2-P5's gradients in the maps' dtype (0.73 GB in bf16);
// at the mask call (out 14) the gradient it reads is 1.64 GB, zero on
// every negative RoI.
//
// Design. The first design ran a thread per (RoI, channel, bin): each
// recomputed its RoI's geometry and issued 16 scalar float32 atomicAdds
// into NCHW float32 buffers (1.46 GB, 30 times the L2), a warp's lanes
// spread over ~15 rows of a plane; zeroing those buffers and rounding
// them took another third of the call. Now:
//   - A block takes one (image, RoI) and a chunk of channels, a thread 4
//     channels (a float4). It first reads its slab of the output gradient
//     (the (C, out, out) block of a RoI is contiguous) with float4 loads
//     until it finds a nonzero, and leaves if there is none: every
//     negative RoI of the mask call. Then it computes the RoI's sample
//     columns (pixel, weights) and, per bin row, the pixel rows its
//     samples reach with their summed weights, once, into shared memory,
//     with the forward's arithmetic.
//   - Bin row by bin row it stages the gradient's row of its channels in
//     shared memory (a row that is zero on every channel is skipped).
//   - Bilinear sampling is separable, so a bin row's gradient in pixel
//     (y, x) is W_y * T(x), with T(x) the sum over the row's sample
//     columns of g(bin) * (their weight at x). A thread sums T in
//     registers while it walks the columns (they move right, at most one
//     pixel pending beside the current one) and adds each finished pixel
//     once per pixel row of the bin row: out 7's 784 corner adds of a
//     (RoI, channel) become ~3 (rows) x ~20 (pixels) per bin row, out
//     14's 3136 about as many. No shared-memory float atomics (they are
//     compare-and-swap loops on this card).
//   - The adds go into a channels-last float32 scratch (B, H, W, C'),
//     C' = C rounded up to 4, as float4 atomics (sm_90's vector global
//     atomicAdd): 8 lanes cover a 128-byte line. A block also flags the
//     32-pixel tiles of the level's flat map that its bin rows reach.
//   - One pass after the kernel writes the NCHW gradients through 32 x 32
//     shared-memory tiles, each float32 sum rounded once to the maps'
//     dtype; a tile no RoI reached is written as zeros without reading
//     the scratch. One memset zeroes scratch and flags before. The three
//     run in one call on the caller's stream.
//   The scratch's traffic sets the pace: at the box call the kernel with
//   plain stores for its adds takes most of the kernel's time
//   (erd_tpu_torch/tools/atomic_backward_probe.py).
// The float32 sums are reordered (and products of weights regrouped), as
// the first design's atomics already reordered them: kernel and plain
// version agree to float32 rounding of reordered sums, and the order of
// the float4 atomics changes from run to run (not deterministic).
#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Levels {
  const void* feat[4];
  int h[4];
  int w[4];
  float scale[4];
};

// the largest sampling_ratio of both kernels' tables
constexpr int kMaxRatio = 8;

__device__ __forceinline__ float widen(const float* p, size_t i) {
  return p[i];
}

__device__ __forceinline__ float widen(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Sample coordinate along one axis: sets the two indices and the weight of
// the upper one; returns false when the sample lies outside [-1, size].
__device__ __forceinline__ bool axis_sample(float pos, int size, int* i0,
                                            int* i1, float* frac) {
  if (!(pos >= -1.f && pos <= static_cast<float>(size))) return false;
  float p = fmaxf(pos, 0.f);
  int lo = min(static_cast<int>(p), size - 1);
  if (lo >= size - 1) p = static_cast<float>(size - 1);
  *i0 = lo;
  *i1 = min(lo + 1, size - 1);
  *frac = __fsub_rn(p, static_cast<float>(lo));
  return true;
}

// Forward: at most kMaxSamples sample rows (and columns) a side,
// out_size * sampling_ratio, so that a bin row's samples fit in a warp.
constexpr int kMaxSamples = 32;
constexpr int kFwdThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The values of one pixel row at the lane's two sample pixels in each of
// kLaneChannels channel planes, from a cache of the last two rows a walk
// down the samples fetched (the rows only move down, and the lanes of a
// warp share them, so the tests are uniform): the row offset y * w of
// each, and the values at x0 and x1 in each plane.
constexpr int kLaneChannels = 4;

template <typename T>
struct RowCache {
  int ya = -2, yb = -2;
  float a0[kLaneChannels] = {}, a1[kLaneChannels] = {};
  float b0[kLaneChannels] = {}, b1[kLaneChannels] = {};

  __device__ __forceinline__ void get(const T* const* f, int y, int x0,
                                      int x1, float* v0, float* v1) {
    if (y != yb && y != ya) {  // fetch the row, dropping the older one
      ya = yb;
      yb = y;
#pragma unroll
      for (int k = 0; k < kLaneChannels; ++k) {
        a0[k] = b0[k];
        a1[k] = b1[k];
        b0[k] = x0 >= 0 ? widen(f[k], y + x0) : 0.f;
        b1[k] = x0 >= 0 ? widen(f[k], y + x1) : 0.f;
      }
    }
    const bool newer = y == yb;
#pragma unroll
    for (int k = 0; k < kLaneChannels; ++k) {
      v0[k] = newer ? b0[k] : a0[k];
      v1[k] = newer ? b1[k] : a1[k];
    }
  }
};

// Block: one (image, RoI) and one group of its channels, blockIdx.x =
// (b * r + roi) * groups + group: image-major, so that the RoIs of one
// image run together and its maps stay in L2. Threads [0, 2 * n_s)
// compute the RoI's n_s = out_size * s sample rows and columns once, as
// the plain version places them, into shared tables (the weights 1 -
// frac and frac, the two pixels' offsets, -1 off the map). Then a warp
// takes 32 / n_s channels at a time, four times over (interleaved, so that
// four planes' loads are in flight together), a lane a sample column of one,
// and walks down the channel's sample rows: it reads a pixel row (the lane's
// two pixels of it) only where the rows it last read do not hold it, so
// that the samples of neighbouring rows, which share pixel rows, read them
// once, and the lanes of a channel read along one row of its plane. A lane
// computes its sample of each row, v00*hy*hx + v01*hy*lx + v10*ly*hx +
// v11*ly*lx left to right (0 off the map); after each bin row, the bin's
// first lane sums the bin's samples in the plain version's order (rows
// outer, columns inner; the other lanes' by shuffles) and divides by s^2
// (a product where s^2 is a power of two: the same value). Every op rounds
// alike, so kernel and plain agree to the bit.
// S > 0: the kernel for sampling ratio S (the models' 2), its loops
// unrolled; S = 0: any ratio up to kMaxRatio, read from `ratio`.
template <typename T, int S>
__global__ void __launch_bounds__(kFwdThreads)
roi_align_kernel(Levels lv, const float* __restrict__ rois,
                 const int* __restrict__ levels, int r, int c, int out_size,
                 int ratio, int groups, int per_group,
                 float* __restrict__ out) {
  constexpr int kR = S > 0 ? S : kMaxRatio;
  const int s = S > 0 ? S : ratio;
  // per sample row (column): (1 - frac, frac, offset of pixel 0, of pixel
  // 1): y * w for rows, x for columns, as int bits; -1 off the map
  __shared__ float4 row_tab[kMaxSamples], col_tab[kMaxSamples];
  const int t = threadIdx.x;
  const long long n = blockIdx.x / groups;  // b * r + roi
  const int group = static_cast<int>(blockIdx.x - n * groups);
  const long long b = n / r;
  const int lvl = levels[n];
  const int h = lv.h[lvl], w = lv.w[lvl];
  const float scale = lv.scale[lvl];
  const int n_s = out_size * s;
  if (t < 2 * n_s) {
    const bool is_row = t < n_s;
    const int i = is_row ? t : t - n_s;
    const float* roi = rois + n * 4;
    const float lo = __fsub_rn(__fmul_rn(roi[is_row ? 1 : 0], scale), 0.5f);
    const float hi = __fsub_rn(__fmul_rn(roi[is_row ? 3 : 2], scale), 0.5f);
    const float bin = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1e-6f),
                                static_cast<float>(out_size));
    const float g = __fadd_rn(static_cast<float>(i / s),
                              __fdiv_rn(__fadd_rn(static_cast<float>(i % s),
                                                  0.5f),
                                        static_cast<float>(s)));
    int i0 = 0, i1 = 0;
    float frac = 0.f;
    const int size = is_row ? h : w, unit = is_row ? w : 1;
    const bool in = axis_sample(__fadd_rn(lo, __fmul_rn(bin, g)), size, &i0,
                                &i1, &frac);
    const float4 e = make_float4(__fsub_rn(1.f, frac), frac,
                                 __int_as_float(in ? i0 * unit : -1),
                                 __int_as_float(i1 * unit));
    if (is_row)
      row_tab[i] = e;
    else
      col_tab[i] = e;
  }
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  const int per_warp = 32 / n_s;  // channels a warp takes at once
  const int sub = lane / n_s;
  const int j = lane - sub * n_s;  // the lane's sample column
  const int pw = j / s, ix = j - pw * s;
  const bool active = sub < per_warp;
  const float4 cx = col_tab[active ? j : 0];
  const int x0 = active ? __float_as_int(cx.z) : -1;
  const int x1i = __float_as_int(cx.w);
  const float hx = cx.x, lx = cx.y;
  const int c_begin = group * per_group;
  const int c_end = min(c, c_begin + per_group);
  const bool pow2 = (s & (s - 1)) == 0;
  const float per_bin = 1.f / static_cast<float>(s * s);  // exact if pow2
  const float fss = static_cast<float>(s * s);
  const size_t plane = static_cast<size_t>(h) * w;
  const int bins = out_size * out_size;
  const T* fb = static_cast<const T*>(lv.feat[lvl]) +
                static_cast<size_t>(b) * c * plane;
  float* ob = out + n * c * bins;

  // a lane takes channel ch and ch + per_warp (kLaneChannels of them),
  // their loads issued together
  constexpr int kStep = kLaneChannels * (kFwdThreads / 32);
  for (int c0 = c_begin + warp * kLaneChannels * per_warp; c0 < c_end;
       c0 += kStep * per_warp) {
    const T* f[kLaneChannels];
    bool live[kLaneChannels];
#pragma unroll
    for (int k = 0; k < kLaneChannels; ++k) {
      const int ch = c0 + k * per_warp + sub;
      live[k] = active && ch < c_end;
      f[k] = fb + static_cast<size_t>(live[k] ? ch : c_begin) * plane;
    }
    RowCache<T> cache;
    for (int ph = 0; ph < out_size; ++ph) {
      float v[kR][kLaneChannels];
#pragma unroll
      for (int iy = 0; iy < kR; ++iy) {
        if (iy >= s) break;
        const float4 ry = row_tab[ph * s + iy];
        const int r0 = __float_as_int(ry.z), r1 = __float_as_int(ry.w);
        const float hy = ry.x, ly = ry.y;
#pragma unroll
        for (int k = 0; k < kLaneChannels; ++k) v[iy][k] = 0.f;
        if (r0 >= 0) {
          float v00[kLaneChannels], v01[kLaneChannels];
          float v10[kLaneChannels], v11[kLaneChannels];
          cache.get(f, r0, x0, x1i, v00, v01);
          cache.get(f, r1, x0, x1i, v10, v11);
          if (x0 >= 0) {
#pragma unroll
            for (int k = 0; k < kLaneChannels; ++k) {
              float val = __fmul_rn(__fmul_rn(v00[k], hy), hx);
              val = __fadd_rn(val, __fmul_rn(__fmul_rn(v01[k], hy), lx));
              val = __fadd_rn(val, __fmul_rn(__fmul_rn(v10[k], ly), hx));
              val = __fadd_rn(val, __fmul_rn(__fmul_rn(v11[k], ly), lx));
              v[iy][k] = val;
            }
          }
        }
      }
      // the bin's samples in order, on its first lane
#pragma unroll
      for (int k = 0; k < kLaneChannels; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int iy = 0; iy < kR; ++iy) {
          if (iy >= s) break;
          acc = __fadd_rn(acc, v[iy][k]);
#pragma unroll
          for (int dx = 1; dx < kR; ++dx) {
            if (dx >= s) break;
            acc = __fadd_rn(acc, __shfl_down_sync(kFull, v[iy][k], dx));
          }
        }
        if (live[k] && ix == 0)
          ob[(static_cast<size_t>(c0 + k * per_warp + sub) * out_size + ph) *
                 out_size + pw] =
              pow2 ? __fmul_rn(acc, per_bin) : __fdiv_rn(acc, fss);
      }
    }
  }
}

// the largest out_size of the backward's shared tables
constexpr int kMaxOut = 32;
constexpr int kTile = 32;  // pixels (of a level's flat H * W) a flag covers

struct BackwardLevels {
  float* scratch[4];        // (B, H, W, cp) float32
  unsigned char* flags[4];  // (B, ceil(H * W / kTile)): a tile was added to
  void* out[4];             // (B, C, H, W) in the maps' dtype
  int h[4];
  int w[4];
  float scale[4];
  long long tiles[5];  // the finishing pass's blocks (flags) by level
};

__device__ __forceinline__ bool any4(const float4& v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}

__device__ __forceinline__ float4 scale4(const float4& v, float a) {
  return make_float4(v.x * a, v.y * a, v.z * a, v.w * a);
}

__device__ __forceinline__ void add4(float4* acc, const float4& g, float a) {
  acc->x = __fmaf_rn(g.x, a, acc->x);
  acc->y = __fmaf_rn(g.y, a, acc->y);
  acc->z = __fmaf_rn(g.z, a, acc->z);
  acc->w = __fmaf_rn(g.w, a, acc->w);
}

// Whether the block's slab of the output gradient (n floats from p) holds
// a nonzero, uniform over the block: a first round of float4 loads (4 a
// thread), which finds one in any RoI with a gradient, then the rest of
// the slab with 8 loads a thread in flight and no barrier between them.
__device__ bool slab_live(const float* p, long long n) {
  const long long head = min(static_cast<long long>(
      (16 - reinterpret_cast<uintptr_t>(p) % 16) % 16 / 4), n);
  const float4* v = reinterpret_cast<const float4*>(p + head);
  const long long quads = (n - head) / 4;
  const long long tail = head + quads * 4;
  const int t = threadIdx.x, nt = blockDim.x;
  bool live = false;
  if (t < head) live = p[t] != 0.f;
  if (t < n - tail) live |= p[tail + t] != 0.f;
  const long long first = min(quads, 4LL * nt);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long j = k * nt + t;
    if (j < first) live |= any4(v[j]);
  }
  if (__syncthreads_or(live)) return true;
  for (long long i = first; i < quads; i += 8LL * nt) {
    float4 u[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long j = i + k * nt + t;
      u[k] = j < quads ? v[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) live |= any4(u[k]);
  }
  return __syncthreads_or(live) != 0;
}

// Block: (image, RoI) = blockIdx.x, channels [4 * threads * blockIdx.y,
// ...), thread t channels 4q..4q+3 with q = threads * blockIdx.y + t.
// Dynamic shared memory: the sample columns' pixel (-1 off the map) and
// weights, S = out * s each; per bin row up to 2s (pixel row, weight)
// pairs and their count; the staged gradient row, out x (4 * threads + 4).
__global__ void roi_align_backward_kernel(
    const float* __restrict__ grad, const float* __restrict__ rois,
    const int* __restrict__ levels, BackwardLevels lv, int r, int c, int cp,
    int out_size, int s) {
  extern __shared__ float4 smem4[];
  __shared__ int col_lo, col_hi;  // the pixel columns the samples reach
  const int threads = blockDim.x, t = threadIdx.x;
  const int chunk = 4 * threads;  // channels of the block
  const int stride = chunk + 4;   // a gradient row's, off by 4 banks
  const int n_s = out_size * s;
  const long long n = blockIdx.x;  // b * r + roi
  const int c0 = chunk * blockIdx.y;
  const int nch = min(chunk, c - c0);
  const float* gslab = grad + (n * c + c0) * out_size * out_size;
  // a RoI with no gradient on these channels adds nothing (the mask
  // call's negatives)
  if (!slab_live(gslab, static_cast<long long>(nch) * out_size * out_size))
    return;

  float* gsh = reinterpret_cast<float*>(smem4);  // [out][stride]
  float* col_hx = gsh + out_size * stride;        // [S]
  float* col_lx = col_hx + n_s;                   // [S]
  float* row_w = col_lx + n_s;                    // [out][2s]
  int* col_x = reinterpret_cast<int*>(row_w + out_size * 2 * s);  // [S]
  int* row_y = col_x + n_s;                       // [out][2s]
  int* row_n = row_y + out_size * 2 * s;          // [out]

  const long long b = n / r;
  const int lvl = levels[n];
  const int h = lv.h[lvl], w = lv.w[lvl];
  const float scale = lv.scale[lvl];
  const float* roi = rois + n * 4;
  const float x1 = __fsub_rn(__fmul_rn(roi[0], scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(roi[1], scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], scale), 0.5f);
  const float fout = static_cast<float>(out_size);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1e-6f), fout);
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1e-6f), fout);
  const float fs = static_cast<float>(s);

  if (t == 0) {
    col_lo = w;
    col_hi = -1;
  }
  __syncthreads();
  // the sample columns, as the forward places them
  for (int i = t; i < n_s; i += threads) {
    const float gx = __fadd_rn(static_cast<float>(i / s),
                               __fdiv_rn(__fadd_rn(static_cast<float>(i % s),
                                                   0.5f), fs));
    int x0 = 0, x1i = 0;
    float lx = 0.f;
    const bool in = axis_sample(__fadd_rn(x1, __fmul_rn(bin_w, gx)), w, &x0,
                                &x1i, &lx);
    col_x[i] = in ? x0 : -1;
    col_hx[i] = __fsub_rn(1.f, lx);
    col_lx[i] = lx;  // the weight of pixel x0 + 1 (0 where it is clamped)
    if (in) {
      atomicMin(&col_lo, x0);
      atomicMax(&col_hi, x1i);
    }
  }
  // per bin row: the pixel rows its s sample rows reach, weights summed
  for (int ph = t; ph < out_size; ph += threads) {
    int cnt = 0;
    int* ys = row_y + ph * 2 * s;
    float* ws = row_w + ph * 2 * s;
    for (int iy = 0; iy < s; ++iy) {
      const float gy = __fadd_rn(static_cast<float>(ph),
                                 __fdiv_rn(__fadd_rn(static_cast<float>(iy),
                                                     0.5f), fs));
      int y0 = 0, y1i = 0;
      float ly = 0.f;
      if (!axis_sample(__fadd_rn(y1, __fmul_rn(bin_h, gy)), h, &y0, &y1i,
                       &ly))
        continue;
      const int py[2] = {y0, y1i};
      const float pw[2] = {__fsub_rn(1.f, ly), ly};
      for (int k = 0; k < 2; ++k) {
        if (pw[k] == 0.f) continue;
        int j = 0;
        while (j < cnt && ys[j] != py[k]) ++j;
        if (j == cnt) {
          ys[cnt] = py[k];
          ws[cnt++] = pw[k];
        } else {
          ws[j] = __fadd_rn(ws[j], pw[k]);
        }
      }
    }
    row_n[ph] = cnt;
  }
  __syncthreads();
  if (col_hi < 0) return;  // every sample column lies off the map

  const int q = c0 / 4 + t;
  const bool mine = 4 * q < c;
  float* sc = lv.scratch[lvl] + static_cast<size_t>(b) * h * w * cp + 4 * q;
  unsigned char* flags = lv.flags[lvl] +
                         b * ((static_cast<long long>(h) * w + kTile - 1) /
                              kTile);
  // g / s^2 (exact for s = 1, 2, 4, 8); an element's channel by a float
  // product, exact for the few thousand elements of a bin row
  const float per_bin = 1.f / static_cast<float>(s * s);
  const float inv_out = 1.f / static_cast<float>(out_size);

  for (int ph = 0; ph < out_size; ++ph) {
    const int rows = row_n[ph];
    if (rows == 0) continue;  // the bin row lies off the map
    __syncthreads();  // the last row's gradient is read
    bool live = false;
    // element i = k * threads + t of the row, 4 * out_size a thread,
    // loaded 8 at a time so that the loads overlap
    for (int k0 = 0; k0 < 4 * out_size; k0 += 8) {
      float g[8];
      int at[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = (k0 + k) * threads + t;
        const int ch = static_cast<int>((static_cast<float>(i) + 0.5f) *
                                        inv_out);
        const int pw = i - ch * out_size;
        at[k] = k0 + k < 4 * out_size ? pw * stride + ch : -1;
        g[k] = at[k] >= 0 && ch < nch
                   ? gslab[(static_cast<size_t>(ch) * out_size + ph) *
                           out_size + pw]
                   : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (at[k] < 0) continue;
        const float v = g[k] * per_bin;
        live |= v != 0.f;
        gsh[at[k]] = v;
      }
    }
    if (!__syncthreads_or(live)) continue;

    const int* ys = row_y + ph * 2 * s;
    const float* ws = row_w + ph * 2 * s;
    if (t < rows) {  // the finishing pass reads the tiles added to
      const long long p0 = static_cast<long long>(ys[t]) * w;
      for (long long k = (p0 + col_lo) / kTile; k <= (p0 + col_hi) / kTile;
           ++k)
        flags[k] = 1;
    }
    if (!mine) continue;
    const auto flush = [&](int x, const float4& v) {
      if (x < 0 || x >= w || !any4(v)) return;
      for (int k = 0; k < rows; ++k) {
        float4* dst = reinterpret_cast<float4*>(
            sc + (static_cast<size_t>(ys[k]) * w + x) * cp);
        atomicAdd(dst, scale4(v, ws[k]));
      }
    };
    int px = -1;  // the pending pixels px and px + 1
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    for (int pw = 0; pw < out_size; ++pw) {
      const float4 g = reinterpret_cast<const float4*>(gsh + pw * stride)[t];
      for (int ix = 0; ix < s; ++ix) {
        const int i = pw * s + ix;
        const int x0 = col_x[i];
        if (x0 < 0) continue;
        if (x0 != px) {  // the columns only move right
          flush(px, a0);
          if (x0 == px + 1) {
            a0 = a1;
          } else {
            flush(px + 1, a1);
            a0 = make_float4(0.f, 0.f, 0.f, 0.f);
          }
          a1 = make_float4(0.f, 0.f, 0.f, 0.f);
          px = x0;
        }
        add4(&a0, g, col_hx[i]);
        add4(&a1, g, col_lx[i]);
      }
    }
    flush(px, a0);
    flush(px + 1, a1);
  }
}

// The finishing pass: a block of 256 threads takes 32 pixels (one flag's
// tile) of one image and level, and every channel. A tile that no RoI
// reached is written as zeros without reading the scratch; another goes
// through shared memory 32 channels at a time, read a pixel's 32
// channels at a time (a float4 a thread) and written to NCHW a channel's
// 32 pixels at a time, each float32 sum rounded once to T.
template <typename T>
__device__ __forceinline__ T narrow(float v);

template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
roi_align_backward_finish(BackwardLevels lv, int c, int cp) {
  __shared__ float tile[32][33];
  const long long id = blockIdx.x;
  int lvl = 0;
  while (lvl < 3 && id >= lv.tiles[lvl + 1]) ++lvl;
  const long long hw = static_cast<long long>(lv.h[lvl]) * lv.w[lvl];
  const long long tiles_p = (hw + kTile - 1) / kTile;
  const long long local = id - lv.tiles[lvl];
  const long long pt = local % tiles_p, b = local / tiles_p;
  const int t = threadIdx.x;
  T* dst = static_cast<T*>(lv.out[lvl]) + b * c * hw;
  const long long p_out = pt * kTile + t % 32;  // the pixel t writes
  if (!lv.flags[lvl][local]) {
    if (p_out < hw)
      for (int ch = t / 32; ch < c; ch += 8)
        dst[ch * hw + p_out] = narrow<T>(0.f);
    return;
  }
  const long long p_in = pt * kTile + t / 8;  // the pixel t reads
  const float* src = lv.scratch[lvl] + (b * hw + p_in) * cp + 4 * (t % 8);
  for (int c0 = 0; c0 < c; c0 += 32) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p_in < hw && c0 + 4 * (t % 8) < c)
      v = *reinterpret_cast<const float4*>(src + c0);
    tile[4 * (t % 8)][t / 8] = v.x;
    tile[4 * (t % 8) + 1][t / 8] = v.y;
    tile[4 * (t % 8) + 2][t / 8] = v.z;
    tile[4 * (t % 8) + 3][t / 8] = v.w;
    __syncthreads();
    if (p_out < hw)
      for (int j = t / 32; j < 32 && c0 + j < c; j += 8)
        dst[(c0 + j) * hw + p_out] = narrow<T>(tile[j][t % 32]);
    __syncthreads();
  }
}

}  // namespace

// f0..f3: per-level (B, C, H_l, W_l) maps, fp32 or bf16 (is_bf16), unused
// levels null with h = w = 0; rois (B, R, 4) fp32; levels (B, R) int32;
// out (B, R, C, out_size, out_size) fp32. scale_l = 1 / stride_l.
// out_size * sampling_ratio <= 32 and sampling_ratio <= 8 (the tables),
// else cudaErrorInvalidValue. The channels are split into groups where
// the RoIs alone would leave the card's SMs (`sms`) short of blocks.
// Returns cudaGetLastError() after the launch.
extern "C" int erd_roi_align(const void* f0, const void* f1, const void* f2,
                             const void* f3, const void* rois,
                             const void* levels, void* out, int h0, int w0,
                             int h1, int w1, int h2, int w2, int h3, int w3,
                             float s0, float s1, float s2, float s3,
                             int batch, int r, int c, int out_size,
                             int sampling_ratio, int sms, int is_bf16,
                             void* stream) {
  if (out_size < 1 || sampling_ratio < 1 || sampling_ratio > kMaxRatio ||
      out_size * sampling_ratio > kMaxSamples)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rois_n = static_cast<long long>(batch) * r;
  if (rois_n <= 0 || c <= 0) return 0;
  Levels lv = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3},
               {s0, s1, s2, s3}};
  // about 8 blocks an SM, each group at least 8 channels
  const long long want = (8LL * sms + rois_n - 1) / rois_n;
  const int split = static_cast<int>(
      std::min<long long>(want, std::max((c + 7) / 8, 1)));
  const int per_group = (c + split - 1) / split;
  const int groups = (c + per_group - 1) / per_group;
  const unsigned blocks = static_cast<unsigned>(rois_n * groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<blocks, kFwdThreads, 0, st>>>(
        lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
        r, c, out_size, sampling_ratio, groups, per_group,
        static_cast<float*>(out));
  };
  const bool two = sampling_ratio == 2;
  if (is_bf16)
    launch(two ? roi_align_kernel<__nv_bfloat16, 2>
               : roi_align_kernel<__nv_bfloat16, 0>);
  else
    launch(two ? roi_align_kernel<float, 2> : roi_align_kernel<float, 0>);
  return static_cast<int>(cudaGetLastError());
}

// grad (B, R, C, out_size, out_size) fp32; rois (B, R, 4) fp32; levels
// (B, R) int32; scratch: float32, the levels' (B, H_l, W_l, cp) one after
// another, cp = C rounded up to 4 (float4 rows), then a byte a 32-pixel
// tile of each level's flat H_l * W_l, (B, ceil(H_l * W_l / 32)) a level;
// o0..o3: per-level (B, C, H_l, W_l) outputs, bf16 (is_bf16) or fp32,
// unused levels null with h = w = 0. Zeroes the scratch, adds the RoIs'
// samples into it and rounds it into the outputs: three device operations
// on `stream`. out_size <= 32, 1 <= sampling_ratio <= 8. Returns
// cudaGetLastError() after the launches.
extern "C" int erd_roi_align_backward(
    const void* grad, const void* rois, const void* levels, void* scratch,
    void* o0, void* o1, void* o2, void* o3, int h0, int w0, int h1, int w1,
    int h2, int w2, int h3, int w3, float s0, float s1, float s2, float s3,
    int batch, int r, int c, int out_size, int sampling_ratio, int is_bf16,
    void* stream) {
  if (out_size < 1 || out_size > kMaxOut || sampling_ratio < 1 ||
      sampling_ratio > kMaxRatio)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cp = (c + 3) / 4 * 4;
  const int hs[4] = {h0, h1, h2, h3}, ws[4] = {w0, w1, w2, w3};
  const float ss[4] = {s0, s1, s2, s3};
  BackwardLevels lv = {};
  void* outs[4] = {o0, o1, o2, o3};
  float* base = static_cast<float*>(scratch);
  size_t floats = 0, flag_bytes = 0;
  for (int l = 0; l < 4; ++l)
    floats += static_cast<size_t>(batch) * hs[l] * ws[l] * cp;
  unsigned char* fbase = reinterpret_cast<unsigned char*>(base + floats);
  floats = 0;
  lv.tiles[0] = 0;
  for (int l = 0; l < 4; ++l) {
    const long long hw = static_cast<long long>(hs[l]) * ws[l];
    lv.scratch[l] = base + floats;
    lv.flags[l] = fbase + flag_bytes;
    lv.out[l] = outs[l];
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    lv.scale[l] = ss[l];
    floats += static_cast<size_t>(batch) * hw * cp;
    flag_bytes += static_cast<size_t>(batch) * ((hw + kTile - 1) / kTile);
    lv.tiles[l + 1] = lv.tiles[l] + static_cast<long long>(batch) *
                                        ((hw + kTile - 1) / kTile);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (floats > 0) {
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, floats * sizeof(float) + flag_bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rois_n = static_cast<long long>(batch) * r;
  if (rois_n > 0 && c > 0) {
    const int quads = cp / 4;
    int threads = quads >= 64 ? 64 : 32;
    const int n_s = out_size * sampling_ratio;
    const auto smem = [&](int th) {
      return static_cast<size_t>(out_size) * (4 * th + 4) * sizeof(float) +
             static_cast<size_t>(n_s) * 3 * sizeof(float) +
             static_cast<size_t>(out_size) * 2 * sampling_ratio *
                 (sizeof(float) + sizeof(int)) +
             static_cast<size_t>(out_size) * sizeof(int);
    };
    if (smem(threads) > 40 * 1024) threads = 32;
    const dim3 grid(static_cast<unsigned>(rois_n),
                    static_cast<unsigned>((quads + threads - 1) / threads));
    roi_align_backward_kernel<<<grid, threads, smem(threads), st>>>(
        static_cast<const float*>(grad), static_cast<const float*>(rois),
        static_cast<const int*>(levels), lv, r, c, cp, out_size,
        sampling_ratio);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (lv.tiles[4] > 0) {
    const unsigned blocks = static_cast<unsigned>(lv.tiles[4]);
    if (is_bf16)
      roi_align_backward_finish<__nv_bfloat16><<<blocks, 256, 0, st>>>(
          lv, c, cp);
    else
      roi_align_backward_finish<float><<<blocks, 256, 0, st>>>(lv, c, cp);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
