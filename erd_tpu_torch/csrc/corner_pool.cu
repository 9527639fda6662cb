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
//
// Backward (`erd_corner_pool_backward`), the gradient that erd_tpu takes by
// autodiff: JAX differentiates cummax through lax.associative_scan with
// lax.max as the combine (jax/_src/lax/control_flow/loops.py), and lax.max
// hands half the tangent to each of two tied operands. So a tied run of a
// ray (common: the pools' inputs come out of a ReLU) shares the gradient by
// the scan's tree, not by position. The kernel replays that tree: one block
// per ray, the ray in scan order in shared memory, then
//   up the levels:   e[l+1][i] = max(e[l][2i], e[l][2i+1]) (pairs);
//   down the levels: the scan's outputs o[l] from o[l+1] (odd outputs are
//                    o[l+1][i], even ones max(o[l+1][i-1], e[l][2i]));
//   down again:      the output gradient g[l] split onto each combine's
//                    operands with weight 1, 0.5 (a tie) or 0, giving
//                    g[l+1] and the leaves' share ge[l];
//   up again:        ge[l+1] split onto the pairs that formed e[l+1].
// Every gradient is the sum of at most two such products, so the result
// equals the plain version's (torch autograd through the same recursion) to
// the bit. Shared memory: 4 floats per node of the tree, < 8 per element
// (8 KB for a 256-long ray). Bound: bytes, x and the output gradient read
// once, the input gradient written once (3 x 25.2 MB for a (1, 128, 192,
// 256) float32 call); the tree's passes stay in shared memory.
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// d max(a, b) / d a at c = max(a, b): 1, or 0.5 where b ties (lax.max's
// _balanced_eq), 0 where a is not the max
__device__ __forceinline__ float share(float a, float b, float c) {
  return a == c ? (b == c ? 0.5f : 1.f) : 0.f;
}

constexpr int kMaxLevels = 32;

template <typename T>
__global__ void corner_pool_backward_kernel(const T* __restrict__ x,
                                            const T* __restrict__ grad,
                                            T* __restrict__ out, int h,
                                            int w, int along_w,
                                            int backward) {
  extern __shared__ float smem[];
  const int rays = along_w ? h : w;
  const int n = along_w ? w : h;
  const long long plane = blockIdx.x / rays;
  const int ray = static_cast<int>(blockIdx.x % rays);
  const long long origin =
      plane * h * w + (along_w ? ray * static_cast<long long>(w) : ray);
  const long long step = along_w ? 1 : w;
  const int tid = threadIdx.x, nt = blockDim.x;
  // level l holds len[l] = floor(n / 2^l) nodes at off[l]; the last level
  // has one node
  int len[kMaxLevels], off[kMaxLevels];
  int top = 0, total = 0;
  for (int m = n;; m >>= 1, ++top) {
    len[top] = m;
    off[top] = total;
    total += m;
    if (m < 2) break;
  }
  float* e = smem;          // the combines' values, per level
  float* o = e + total;     // the scan's outputs, per level
  float* g = o + total;     // gradients of the scan's outputs
  float* ge = g + total;    // gradients of the level's elements
  for (int i = tid; i < n; i += nt) {
    const long long at = origin + (backward ? n - 1 - i : i) * step;
    e[i] = widen(x[at]);
    g[i] = widen(grad[at]);
  }
  __syncthreads();
  for (int l = 0; l < top; ++l) {
    for (int i = tid; i < len[l + 1]; i += nt)
      e[off[l + 1] + i] = fmaxf(e[off[l] + 2 * i], e[off[l] + 2 * i + 1]);
    __syncthreads();
  }
  if (tid == 0) o[off[top]] = e[off[top]];
  __syncthreads();
  for (int l = top - 1; l >= 0; --l) {
    for (int k = tid; k < len[l]; k += nt) {
      float v;
      if (k == 0) {
        v = e[off[l]];
      } else if (k & 1) {
        v = o[off[l + 1] + (k >> 1)];
      } else {
        v = fmaxf(o[off[l + 1] + (k >> 1) - 1], e[off[l] + k]);
      }
      o[off[l] + k] = v;
    }
    __syncthreads();
  }
  for (int l = 0; l < top; ++l) {
    const float* el = e + off[l];
    const float* ol = o + off[l];
    const float* gl = g + off[l];
    for (int i = tid; i < len[l + 1]; i += nt) {
      // odd output 2i + 1 is o[l+1][i], which the even output 2i + 2 also
      // combines with e[l][2i+2]
      float sum = gl[2 * i + 1];
      const int k = 2 * i + 2;
      if (k < len[l])
        sum = __fadd_rn(sum, __fmul_rn(gl[k], share(ol[k - 1], el[k],
                                                     ol[k])));
      g[off[l + 1] + i] = sum;
    }
    for (int k = tid; k < len[l]; k += nt) {
      float v = 0.f;
      if (k == 0) {
        v = gl[0];
      } else if (!(k & 1)) {
        v = __fmul_rn(gl[k], share(el[k], ol[k - 1], ol[k]));
      }
      ge[off[l] + k] = v;
    }
    __syncthreads();
  }
  if (tid == 0) ge[off[top]] = g[off[top]];
  __syncthreads();
  for (int l = top - 1; l >= 0; --l) {
    for (int i = tid; i < len[l + 1]; i += nt) {
      const float gi = ge[off[l + 1] + i], c = e[off[l + 1] + i];
      const float a = e[off[l] + 2 * i], b = e[off[l] + 2 * i + 1];
      float* dst = ge + off[l] + 2 * i;
      dst[0] = __fadd_rn(dst[0], __fmul_rn(gi, share(a, b, c)));
      dst[1] = __fadd_rn(dst[1], __fmul_rn(gi, share(b, a, c)));
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += nt)
    store(out + origin + (backward ? n - 1 - i : i) * step, ge[i]);
}

// nodes of the scan tree over a ray of n elements
long long tree_nodes(int n) {
  long long total = 0;
  for (int m = n;; m >>= 1) {
    total += m;
    if (m < 2) break;
  }
  return total;
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

// x, grad and out (planes, h, w), float32 or bf16 (is_bf16); along_w and
// backward as erd_corner_pool's. out receives the gradient in x of
// sum(corner_pool(x) * grad). Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a ray whose tree exceeds shared memory.
extern "C" int erd_corner_pool_backward(const void* x, const void* grad,
                                        void* out, int planes, int h, int w,
                                        int along_w, int backward,
                                        int is_bf16, void* stream) {
  const long long rays =
      static_cast<long long>(planes) * (along_w ? h : w);
  if (rays <= 0 || h <= 0 || w <= 0) return 0;
  const size_t smem = 4 * sizeof(float) * tree_nodes(along_w ? w : h);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (is_bf16) {
    auto kernel = corner_pool_backward_kernel<__nv_bfloat16>;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(rays), threads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(grad),
        static_cast<__nv_bfloat16*>(out), h, w, along_w, backward);
  } else {
    auto kernel = corner_pool_backward_kernel<float>;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(rays), threads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(grad),
        static_cast<float*>(out), h, w, along_w, backward);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
