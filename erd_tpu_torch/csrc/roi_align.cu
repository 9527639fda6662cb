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
// Thread layout: one thread per output element (roi, channel, bin row, bin
// column), the bin column fastest, so a warp covers 32 of one channel's 49
// bins and neighbouring threads read neighbouring pixels of one plane.
// A thread computes its bin's sampling_ratio^2 sample positions, reads 4
// pixels per sample (bf16 maps are widened in registers; the values equal
// erd_tpu's astype(float32)) and sums the weighted samples in the plain
// version's order: sample rows outer, sample columns inner, each sample
// v00*hy*hx + v01*hy*lx + v10*ly*hx + v11*ly*lx left to right, then one
// divide by sampling_ratio^2. Every op is rounded on its own (the library is
// built with -fmad=false), so kernel and plain version agree to the bit.
//
// Boundary rules of _bilinear_gather: a sample outside [-1, H] x [-1, W]
// is 0; inside, the coordinate clamps at 0; y_low = min(int(y), H - 1), and
// where y_low >= H - 1 the sample takes row H - 1 with weight 0 on the next
// one (likewise in x).
//
// Bound on this card: bytes. The output is R * C * 49 floats (50 MB at
// R = 1000, C = 256) and must be written; the reads are the feature pixels
// under the RoIs (bf16, at most the 46 MB of P2-P5 at 800x1344), mostly
// served from L2 since neighbouring bins and channels share cache lines.
// The arithmetic (~60 flops per output) is far below the fp32 peak.
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

template <typename T>
__global__ void roi_align_kernel(Levels lv, const float* __restrict__ rois,
                                 const int* __restrict__ levels, int r, int c,
                                 int out_size, int s, long long total,
                                 float* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= total) return;
  const int bins = out_size * out_size;
  const int pw = static_cast<int>(t % out_size);
  const int ph = static_cast<int>((t / out_size) % out_size);
  const long long nc = t / bins;  // roi * c + channel
  const int ch = static_cast<int>(nc % c);
  const long long n = nc / c;  // b * r + roi
  const long long b = n / r;
  const int lvl = levels[n];
  const int h = lv.h[lvl], w = lv.w[lvl];
  const float scale = lv.scale[lvl];
  const T* f = static_cast<const T*>(lv.feat[lvl]) +
               (static_cast<size_t>(b) * c + ch) * h * w;

  const float* roi = rois + n * 4;
  const float x1 = __fsub_rn(__fmul_rn(roi[0], scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(roi[1], scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], scale), 0.5f);
  const float fout = static_cast<float>(out_size);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1e-6f), fout);
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1e-6f), fout);
  const float fs = static_cast<float>(s);

  // sample offsets within a bin, (i + 0.5) / s, as the plain version's
  const auto sub = [fs](int i) {
    return __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f), fs);
  };
  float acc = 0.f;
  for (int iy = 0; iy < s; ++iy) {
    const float gy = __fadd_rn(static_cast<float>(ph), sub(iy));
    int y0 = 0, y1i = 0;
    float ly = 0.f;
    const bool in_y = axis_sample(__fadd_rn(y1, __fmul_rn(bin_h, gy)), h, &y0,
                                  &y1i, &ly);
    const float hy = __fsub_rn(1.f, ly);
    for (int ix = 0; ix < s; ++ix) {
      const float gx = __fadd_rn(static_cast<float>(pw), sub(ix));
      int x0 = 0, x1i = 0;
      float lx = 0.f;
      const bool in_x = axis_sample(__fadd_rn(x1, __fmul_rn(bin_w, gx)), w,
                                    &x0, &x1i, &lx);
      float v = 0.f;
      if (in_y && in_x) {
        const float hx = __fsub_rn(1.f, lx);
        const size_t r0 = static_cast<size_t>(y0) * w;
        const size_t r1 = static_cast<size_t>(y1i) * w;
        v = __fmul_rn(__fmul_rn(widen(f, r0 + x0), hy), hx);
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(widen(f, r0 + x1i), hy), lx));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(widen(f, r1 + x0), ly), hx));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(widen(f, r1 + x1i), ly), lx));
      }
      acc = __fadd_rn(acc, v);
    }
  }
  out[t] = __fdiv_rn(acc, static_cast<float>(s * s));
}

}  // namespace

// f0..f3: per-level (B, C, H_l, W_l) maps, fp32 or bf16 (is_bf16), unused
// levels null with h = w = 0; rois (B, R, 4) fp32; levels (B, R) int32;
// out (B, R, C, out_size, out_size) fp32. scale_l = 1 / stride_l.
// Returns cudaGetLastError() after the launch.
extern "C" int erd_roi_align(const void* f0, const void* f1, const void* f2,
                             const void* f3, const void* rois,
                             const void* levels, void* out, int h0, int w0,
                             int h1, int w1, int h2, int w2, int h3, int w3,
                             float s0, float s1, float s2, float s3,
                             int batch, int r, int c, int out_size,
                             int sampling_ratio, int is_bf16, void* stream) {
  const long long total =
      static_cast<long long>(batch) * r * c * out_size * out_size;
  if (total <= 0) return 0;
  Levels lv = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3},
               {s0, s1, s2, s3}};
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
        r, c, out_size, sampling_ratio, total, static_cast<float*>(out));
  } else {
    roi_align_kernel<float><<<blocks, threads, 0, st>>>(
        lv, static_cast<const float*>(rois), static_cast<const int*>(levels),
        r, c, out_size, sampling_ratio, total, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
