// GFL distribution decode of the candidate rows, hand-written for Hopper
// (sm_90a).
//
// Replaces: erd_tpu/ops/integral.py `integral` times the level stride, then
// erd_tpu/structures/boxes.py `distance2bbox(max_shape=img_shape)`, as
// erd_tpu/models/heads/gfl_head.py `gfl_predict` uses them (and the
// distillation's teacher boxes, erd_tpu/models/detectors/gfl_erd.py:147-148,
// with unit strides and no clip). On the TPU every anchor row of every level
// was decoded (softmax over 17 bins a side, an einsum with 0..16) and the
// top-k candidates gathered afterwards. Decoding only the gathered rows
// gives the same boxes, so the kernel reads just those rows: one launch a
// batch covers every level.
//
// Where the rows lie: up to kMaxLevels maps of (B, H, W, 68) logits, each
// with its own element strides, float32 or bf16 (the head's level maps as
// the network leaves them: no cast, no concatenation before the launch), or
// one flat (B, N, 68) map (a single level of height 1). A row index is an
// anchor of the flattened levels; its level is the last whose first row is
// not above it. bf16 logits are widened to float32 in registers, which is
// exact: the values are those a cast would make.
//
// Design. A block takes kCand candidates, a thread a (candidate, side):
//   1. kCand threads read their candidate's row index (int64, in place),
//      find its level and element offset, its anchor centre and stride;
//   2. the block stages the candidates' 68 logits into shared memory with
//      16-byte (float32) or 8-byte (bf16) loads where the channels are
//      unit-stride and aligned, each thread taking the next vector of the
//      same or the next row (a row is 17 such loads), else element by
//      element through the strides, a thread's 17 loads all in flight
//      before any is stored (GFL serving's maps are NHWC views of NCHW maps: a
//      logit a 32-byte sector, read from L2);
//   3. a thread reads its side's 17 logits from shared memory (68 and 17
//      floats apart: no bank conflict among the warp's 8 candidates x 4
//      sides), keeps their exponentials in registers (bins are a
//      compile-time 17) and takes E = sum_i e_i * i / sum_i e_i: one
//      division a side. d = E * stride, v = centre -/+ d (x for sides 0 and
//      2, y for 1 and 3), clipped to [0, W] or [0, H] of the image's
//      img_shape where one is given.
// The expectation's rounding differs from the plain version's softmax
// (e_i / sum, then sum_i p_i * i) by a few ulps of E; the gate against
// plain is 1e-4 * stride + 1e-5 * |box| px.
//
// Bound on this card: bytes. A candidate moves 272 B of float32 logits
// (136 B of bf16), its row index, its anchor centre and stride, and 16 B of
// box. GFL's serving call (5000 candidates of one image) is ~1.5 MB, under
// a microsecond at 3.35 TB/s, so a launch costs more than its traffic;
// ERD's training call (16 x 4481 rows of the flat teacher map) is ~21 MB,
// ~6.4 us, and wants every SM streaming: 128-thread blocks of 32
// candidates, 4-5 vector loads in flight a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 17;
constexpr int kRow = 4 * kBins;  // logits a candidate
constexpr int kCand = 32;        // candidates a block
constexpr int kThreads = 4 * kCand;
constexpr int kMaxLevels = 8;

struct Levels {
  const void* ptr[kMaxLevels];
  long long sb[kMaxLevels], sh[kMaxLevels], sw[kMaxLevels], sc[kMaxLevels];
  int start[kMaxLevels];  // a level's first row of the flattened anchors
  int width[kMaxLevels];
  int count;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC logits of type T at p (VEC * sizeof(T) bytes, aligned) into dst
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* dst) {
  if constexpr (VEC == 1) {
    dst[0] = widen(__ldg(p));
  } else if constexpr (sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    *reinterpret_cast<float4*>(dst) = make_float4(fa.x, fa.y, fb.x, fb.y);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
integral_decode_kernel(Levels lv, const int64_t* __restrict__ rows,
                       const float* __restrict__ centers,
                       const float* __restrict__ strides,
                       const float* __restrict__ img_shape, int k,
                       long long total, float* __restrict__ out) {
  __shared__ __align__(16) float buf[kCand * kRow];
  __shared__ const T* src[kCand];      // a candidate's first logit
  __shared__ long long step[kCand];    // its channel stride (elements)
  __shared__ float2 ctr[kCand];
  __shared__ float str[kCand];
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kCand;
  const int here =
      total - first < kCand ? static_cast<int>(total - first) : kCand;
  if (tid < here) {
    const long long bk = first + tid;  // b * k + candidate
    const long long b = bk / k;
    const long long row = rows[bk];
    int l = 0;
#pragma unroll
    for (int i = 1; i < kMaxLevels; ++i)
      l = (i < lv.count && row >= lv.start[i]) ? i : l;
    const int r = static_cast<int>(row - lv.start[l]);
    const int h = r / lv.width[l], w = r - h * lv.width[l];
    src[tid] = static_cast<const T*>(lv.ptr[l]) + b * lv.sb[l] +
               h * lv.sh[l] + w * lv.sw[l];
    step[tid] = lv.sc[l];
    ctr[tid] = __ldg(reinterpret_cast<const float2*>(centers) + row);
    str[tid] = __ldg(strides + row);
  }
  __syncthreads();
  if constexpr (VEC == 1) {
    // a thread's 17 strided loads all in flight before its first store
    constexpr int kPer = kCand * kRow / kThreads;
    float r[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int e = tid + t * kThreads;
      const int c = e / kRow;
      r[t] = c < here ? widen(__ldg(src[c] + (e - c * kRow) * step[c])) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) buf[tid + t * kThreads] = r[t];
  } else {
    constexpr int kVecs = kRow / VEC;
#pragma unroll 5
    for (int e = tid; e < here * kVecs; e += kThreads) {
      const int c = e / kVecs, part = e - c * kVecs;
      load_vec<T, VEC>(src[c] + part * VEC, buf + c * kRow + part * VEC);
    }
  }
  __syncthreads();
  const int c = tid >> 2, side = tid & 3;
  if (c >= here) return;
  const float* x = buf + c * kRow + side * kBins;
  float v[kBins];
#pragma unroll
  for (int i = 0; i < kBins; ++i) v[i] = x[i];
  float m = v[0];
#pragma unroll
  for (int i = 1; i < kBins; ++i) m = fmaxf(m, v[i]);
  float sum = 0.f, num = 0.f;
#pragma unroll
  for (int i = 0; i < kBins; ++i) {
    const float e = expf(__fsub_rn(v[i], m));
    sum = __fadd_rn(sum, e);
    num = __fadd_rn(num, __fmul_rn(e, static_cast<float>(i)));
  }
  const float d = __fmul_rn(__fdiv_rn(num, sum), str[c]);
  const int axis = side & 1;  // 0: x, 1: y
  const float ctr_v = axis ? ctr[c].y : ctr[c].x;
  float val = side < 2 ? __fsub_rn(ctr_v, d) : __fadd_rn(ctr_v, d);
  const long long bk = first + c;
  if (img_shape != nullptr) {  // (H, W): x sides clip to W, y sides to H
    const float hi = __ldg(img_shape + (bk / k) * 2 + (axis ? 0 : 1));
    val = fminf(fmaxf(val, 0.f), hi);
  }
  out[bk * 4 + side] = val;
}

template <typename T, int VEC>
int launch(const Levels& lv, const void* rows, const void* centers,
           const void* strides, const void* img_shape, void* out, int k,
           long long total, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((total + kCand - 1) / kCand);
  integral_decode_kernel<T, VEC><<<blocks, kThreads, 0, s>>>(
      lv, static_cast<const int64_t*>(rows),
      static_cast<const float*>(centers), static_cast<const float*>(strides),
      static_cast<const float*>(img_shape), k, total,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The level maps: count (1..8) pointers `ptrs`; `strides` count x 4 element
// strides (batch, row, column, channel); `starts` each level's first row of
// the flattened anchors (ascending, starts[0] = 0); `widths` each level's
// columns. bf16: 0 float32, 1 bfloat16. vec: 1 where every map's channels
// are unit-stride and every row starts on a 16-byte (float32) or 8-byte
// (bf16) boundary, else 0. rows (B, K) int64; centers (N, 2) float32;
// strides_per_row (N,) float32; img_shape (B, 2) float32
// (H, W) or null for no clip; out (B, K, 4) float32. One launch; returns
// cudaGetLastError() after it (cudaErrorInvalidValue for arguments out of
// range).
extern "C" int erd_integral_decode(const void* const* ptrs,
                                   const long long* strides,
                                   const int* starts, const int* widths,
                                   int count, int bf16, int vec,
                                   const void* rows, const void* centers,
                                   const void* strides_per_row,
                                   const void* img_shape, void* out,
                                   int batch, int k, void* stream) {
  if (count < 1 || count > kMaxLevels || batch < 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(batch) * k;
  if (total == 0) return 0;
  Levels lv = {};
  for (int i = 0; i < count; ++i) {
    lv.ptr[i] = ptrs[i];
    lv.sb[i] = strides[4 * i];
    lv.sh[i] = strides[4 * i + 1];
    lv.sw[i] = strides[4 * i + 2];
    lv.sc[i] = strides[4 * i + 3];
    lv.start[i] = starts[i];
    lv.width[i] = widths[i];
    if (widths[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  lv.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec ? launch<__nv_bfloat16, 4>(lv, rows, centers, strides_per_row,
                                          img_shape, out, k, total, s)
               : launch<__nv_bfloat16, 1>(lv, rows, centers, strides_per_row,
                                          img_shape, out, k, total, s);
  return vec ? launch<float, 4>(lv, rows, centers, strides_per_row, img_shape,
                                out, k, total, s)
             : launch<float, 1>(lv, rows, centers, strides_per_row, img_shape,
                                out, k, total, s);
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
