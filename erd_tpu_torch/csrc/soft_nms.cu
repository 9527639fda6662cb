// Soft-NMS scan (linear or gaussian decay), hand-written for Hopper
// (sm_90a).
//
// Replaces: erd_tpu/ops/nms.py `soft_nms_select` (:170), whose body is a
// `lax.scan` of min(max_out, K) steps over the (K,) score vector. Each step
//   1. i = argmax(cur), lowest index on ties (jnp.argmax);
//   2. emits (i, cur[i]);
//   3. decays every live score: cur *= w(iou(i, .)), with
//      w = 1 - iou where iou > thr else 1 (linear), or exp(-iou^2 / sigma)
//      (gaussian); -inf entries stay -inf;
//   4. drops decayed scores below min_score to -inf;
//   5. consumes i (cur[i] = -inf).
// The scan is serial in its steps, so the kernel is one thread block per
// image, and each step is a block-wide argmax (a strided scan per thread,
// warp shuffles, one pass over the warps' winners) and one strided decay
// pass. Two variants of one templated scan, picked by K:
//   - shared (K <= erd_soft_nms_max_k(), about 9600 on an H100): the block
//     holds the class-shifted boxes, their areas and the current scores of
//     all K candidates in shared memory (6 floats each: 47 KB at K = 2000,
//     dynamic shared memory, up to the 227 KB a block may use). Nothing but
//     the outputs touches device memory after the first load.
//   - global (larger K): the current scores and the areas live in a
//     (B, 2, K) float32 scratch that the wrapper allocates, and the boxes
//     are read from device memory at every step; at K = 12000 that is
//     240 KB per image, which stays in L2. __syncthreads() orders the
//     block's own device-memory writes as it orders shared memory.
//
// Exactness: the IoU repeats the reference op for op, each op rounded on
// its own (__fsub_rn etc.; the library is built with -fmad=false):
// area = max(x2-x1,0)*max(y2-y1,0), iw = max(min(x2_i,x2)-max(x1_i,x1),0),
// iou = (iw*ih) / max((area_i + area) - iw*ih, 1e-6). The linear decay is
// then bit-exact with the plain version in both variants; the gaussian one
// goes through expf, which may differ from the host's exp by an ulp.
//
// Bound on this card: neither bytes nor operations. The inputs are 20 B per
// candidate (40 KB at K = 2000) and the work is ~20 flops per candidate and
// step (4 MFLOP at K = 2000, 100 steps), both microseconds at most; the
// kernel is bound by the latency of its 2 * steps block-wide barriers, and
// in the global variant also by the L2 latency of each step's two passes.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (value, index) pair order of jnp.argmax: larger value, then lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// All K candidates of one image in shared memory, as planes.
struct SharedStore {
  float *x1, *y1, *x2, *y2, *area, *cur;
  __device__ SharedStore(float* smem, int k)
      : x1(smem), y1(smem + k), x2(smem + 2 * k), y2(smem + 3 * k),
        area(smem + 4 * k), cur(smem + 5 * k) {}
  __device__ void load(int j, float4 b, float score) {
    x1[j] = b.x;
    y1[j] = b.y;
    x2[j] = b.z;
    y2[j] = b.w;
    area[j] = box_area(b);
    cur[j] = score;
  }
  __device__ float4 box(int j) const {
    return make_float4(x1[j], y1[j], x2[j], y2[j]);
  }
};

// Boxes read from device memory; scores and areas in the (2, K) scratch.
struct GlobalStore {
  const float4* boxes;
  float *cur, *area;
  __device__ GlobalStore(const float4* b, float* scratch, int k)
      : boxes(b), cur(scratch), area(scratch + k) {}
  __device__ void load(int j, float4 b, float score) {
    area[j] = box_area(b);
    cur[j] = score;
  }
  __device__ float4 box(int j) const { return boxes[j]; }
};

template <typename Store>
__device__ void soft_nms_scan(Store st, const float4* __restrict__ boxes,
                              const float* __restrict__ scores, int k,
                              int steps, float thr, float sigma,
                              float min_score, int gaussian,
                              int64_t* __restrict__ out_idx,
                              float* __restrict__ out_score) {
  __shared__ float warp_val[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ int sel;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < k; j += kThreads) st.load(j, boxes[j], scores[j]);
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    // 1. block-wide argmax, lowest index on ties
    float bv = -CUDART_INF_F;
    int bi = k;  // loses every tie against a real index
    for (int j = tid; j < k; j += kThreads) {
      const float c = st.cur[j];
      if (better(c, j, bv, bi)) {
        bv = c;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      warp_val[warp] = bv;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = warp_val[lane];
      bi = warp_idx[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        sel = bi;
        // 2. emit the selection with its current score
        out_idx[step] = bi;
        out_score[step] = st.cur[bi];
      }
    }
    __syncthreads();

    // 3-5. decay, drop below min_score, consume the selection
    const int i = sel;
    const float4 bi4 = st.box(i);
    const float ia = st.area[i];
    for (int j = tid; j < k; j += kThreads) {
      float c = st.cur[j];
      if (c > -CUDART_INF_F) {
        const float4 bj = st.box(j);
        const float iw =
            fmaxf(__fsub_rn(fminf(bi4.z, bj.z), fmaxf(bi4.x, bj.x)), 0.f);
        const float ih =
            fmaxf(__fsub_rn(fminf(bi4.w, bj.w), fmaxf(bi4.y, bj.y)), 0.f);
        const float ov = __fmul_rn(iw, ih);
        const float uni =
            fmaxf(__fsub_rn(__fadd_rn(ia, st.area[j]), ov), 1e-6f);
        const float iou = __fdiv_rn(ov, uni);
        float w;
        if (gaussian)
          w = expf(__fdiv_rn(-__fmul_rn(iou, iou), sigma));
        else
          w = iou > thr ? __fsub_rn(1.f, iou) : 1.f;
        c = __fmul_rn(c, w);
      }
      if (c < min_score || j == i) c = -CUDART_INF_F;
      st.cur[j] = c;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
soft_nms_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores, int k, int steps, float thr,
                float sigma, float min_score, int gaussian,
                int64_t* __restrict__ out_idx,
                float* __restrict__ out_score) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x;
  soft_nms_scan(SharedStore(smem, k), boxes + b * k, scores + b * k, k,
                steps, thr, sigma, min_score, gaussian, out_idx + b * steps,
                out_score + b * steps);
}

__global__ void __launch_bounds__(kThreads)
soft_nms_global_kernel(const float4* __restrict__ boxes,
                       const float* __restrict__ scores, float* scratch,
                       int k, int steps, float thr, float sigma,
                       float min_score, int gaussian,
                       int64_t* __restrict__ out_idx,
                       float* __restrict__ out_score) {
  const size_t b = blockIdx.x;
  soft_nms_scan(GlobalStore(boxes + b * k, scratch + 2 * b * k, k),
                boxes + b * k, scores + b * k, k, steps, thr, sigma,
                min_score, gaussian, out_idx + b * steps,
                out_score + b * steps);
}

}  // namespace

// shared memory the kernels declare statically (warp winners, selection)
constexpr int kStaticBytes = kWarps * 8 + 4;

// The most candidates one block holds in shared memory; above it the
// wrapper passes a scratch and the global variant runs.
extern "C" int erd_soft_nms_max_k() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (optin - kStaticBytes) / static_cast<int>(6 * sizeof(float));
}

// boxes (B, K, 4) fp32, class-shifted; scores (B, K) fp32, -inf for
// invalid entries; scratch null (shared variant, K <= erd_soft_nms_max_k())
// or (B, 2, K) fp32 (global variant, any K); out_idx (B, steps) int64 and
// out_score (B, steps) fp32, steps = min(max_out, K). gaussian: 0 linear,
// 1 gaussian. Returns cudaGetLastError() after the launch.
extern "C" int erd_soft_nms(const void* boxes, const void* scores,
                            void* scratch, void* out_idx, void* out_score,
                            int batch, int k, int steps, float thr,
                            float sigma, float min_score, int gaussian,
                            void* stream) {
  if (batch <= 0 || k <= 0 || steps <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  int64_t* oi = static_cast<int64_t*>(out_idx);
  float* os = static_cast<float*>(out_score);
  if (scratch != nullptr) {
    soft_nms_global_kernel<<<batch, kThreads, 0, s>>>(
        bx, sc, static_cast<float*>(scratch), k, steps, thr, sigma,
        min_score, gaussian, oi, os);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 6 * sizeof(float) * static_cast<size_t>(k);
  if (smem + kStaticBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        soft_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  soft_nms_kernel<<<batch, kThreads, smem, s>>>(bx, sc, k, steps, thr, sigma,
                                                min_score, gaussian, oi, os);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
