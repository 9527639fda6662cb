// CornerNet corner pooling (running maxima), hand-written for Hopper
// (sm_90a).
//
// Replaces: erd_tpu/ops/extra_nms.py `corner_pool`, as
// erd_tpu/models/detectors/cornernet.py `BiCornerPool` calls it on its two
// 128-channel direction convs. On the TPU it was `lax.cummax` between two
// flips; here one pass scans the ray in the direction's own order and no
// flipped copy is made.
//
// The combine is a max that carries NaN, as lax.cummax and torch.cummax
// do: the later element b replaces the earlier a where b > a or b is NaN,
// so a NaN and everything after it read NaN, and a tie keeps the earlier
// element. It picks one of its inputs and is associative, so any scan tree
// gives the sequential loop's values to the bit; bf16 values are compared
// widened and written back as they were.
//
// Bound on this card: bytes, each input read once and each output written
// once (25.2 MB each way for one (1, 128, 192, 256) float32 call of a
// 768x1024 HG-104 request, 0.0150 ms at 3.35 TB/s); one compare per
// element. The design keeps many 16-byte loads in flight and every access
// coalesced:
//   left / right (along W): a warp a row. Each lane loads V consecutive
//     elements with 16-byte loads (V = 8: two float4, or one 16-byte load of
//     bf16), scans them in registers in scan order, and a warp-inclusive
//     scan of the lane totals (5 __shfl_up_sync steps, the lanes numbered
//     in scan order) gives each lane the max of the elements before it.
//     A row longer than 32 V runs in chunks that carry the running max;
//     the lanes past the row's end hold -inf, the combine's identity.
//   top / bottom (along H): a block a (plane, tile of 32 V columns), V = 4
//     float32 or 8 bf16 columns a lane (one 16-byte load a row); its 8
//     warps split the rows into chunks of R = 4 in scan order, 32 rows a
//     pass. Each warp issues all R loads of its chunk before it scans them,
//     puts the chunk's maximum in shared memory, then folds in the chunks
//     before it (and the carry of the earlier passes) in scan order, and
//     writes. Short chunks keep few registers, so many blocks fit an SM.
// A row that does not split into 16-byte pieces (W not a multiple of V, or
// a pointer off 16 bytes) takes V = 1: scalar loads, the same scans.
// The hourglass's maps are channels-last on the card, and the convs after
// the pools run fastest on NCHW maps, so `erd_corner_pool_nhwc` reads a
// channels-last map where it lies and writes NCHW (a copy to NCHW first
// cost three times the scan): a thread a ray, loads along C, the scan in
// registers, the stores along W through a shared-memory tile.
//
// Backward (`erd_corner_pool_backward`), the gradient that erd_tpu takes by
// autodiff: JAX differentiates cummax through lax.associative_scan with
// lax.max as the combine (jax/_src/lax/control_flow/loops.py), and lax.max
// hands half the tangent to each of two tied operands (none to either
// where its output is NaN). So a tied run of a ray (common: the pools'
// inputs come out of a ReLU) shares the gradient by the scan's tree, not by
// position. The kernel replays that tree: one block per ray, the ray in
// scan order in shared memory, then
//   up the levels:   e[l+1][i] = max(e[l][2i], e[l][2i+1]) (pairs);
//   down the levels: the scan's outputs o[l] from o[l+1] (odd outputs are
//                    o[l+1][i], even ones max(o[l+1][i-1], e[l][2i]));
//   down again:      the output gradient g[l] split onto each combine's
//                    operands with weight 1, 0.5 (a tie) or 0, giving
//                    g[l+1] and the leaves' share ge[l];
//   up again:        ge[l+1] split onto the pairs that formed e[l+1].
// Every max there carries NaN as the forward's does. Every gradient is the
// sum of at most two such products, so the result equals the plain
// version's (torch autograd through the same recursion) to the bit. Shared
// memory: 4 floats per node of the tree, < 8 per element (8 KB for a
// 256-long ray). Bound: bytes, x and the output gradient read once, the
// input gradient written once (3 x 25.2 MB for a (1, 128, 192, 256) float32
// call); the tree's passes stay in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);  // to nearest: exact for a widened bf16
}

// the max of an earlier element a and a later one b: b where b > a or b is
// NaN, else a (a tie keeps the earlier element)
__device__ __forceinline__ float later_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// V consecutive elements at p, widened; 16-byte loads where V elements
// fill whole 16-byte words (p then 16-byte aligned)
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[V]) {
  constexpr int kWords = static_cast<int>(V * sizeof(T) / 16);
  if constexpr (kWords * 16 == V * sizeof(T)) {
    uint4 u[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      u[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* t = reinterpret_cast<const T*>(u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = widen(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = widen(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[V]) {
  constexpr int kWords = static_cast<int>(V * sizeof(T) / 16);
  if constexpr (kWords * 16 == V * sizeof(T)) {
    uint4 u[kWords];
    T* t = reinterpret_cast<T*>(u);
#pragma unroll
    for (int i = 0; i < V; ++i) narrow(v[i], t + i);
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      reinterpret_cast<uint4*>(p)[i] = u[i];
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) narrow(v[i], p + i);
  }
}

constexpr unsigned kFull = 0xffffffffu;

// left / right: a warp a row of w elements (w a multiple of V); kBackward
// scans from the last element (left)
template <typename T, int V, bool kBackward>
__global__ void pool_rows_kernel(const T* __restrict__ x,
                                 T* __restrict__ out, long long rows,
                                 int w) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  if (row >= rows) return;  // the whole warp: a row is a warp's
  const T* src = x + row * w;
  T* dst = out + row * w;
  float carry = -INFINITY;
  for (int c0 = 0; c0 < w; c0 += 32 * V) {
    const int s0 = c0 + lane * V;  // the lane's first position, scan order
    const bool live = s0 < w;
    const int p0 = kBackward ? w - s0 - V : s0;  // its first element
    float v[V];
    if (live) {
      load_vec<T, V>(src + p0, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = -INFINITY;
    }
    // the lane's inclusive scan; element i in scan order is v[V - 1 - i]
    // when scanning backward
#pragma unroll
    for (int i = 1; i < V; ++i) {
      const int at = kBackward ? V - 1 - i : i;
      const int before = kBackward ? V - i : i - 1;
      v[at] = later_max(v[before], v[at]);
    }
    const float total = v[kBackward ? 0 : V - 1];
    float incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = later_max(o, incl);
    }
    float pre = __shfl_up_sync(kFull, incl, 1);
    pre = lane == 0 ? carry : later_max(carry, pre);
    carry = later_max(carry, __shfl_sync(kFull, incl, 31));
    if (live) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = later_max(pre, v[i]);
      store_vec<T, V>(dst + p0, v);
    }
  }
}

constexpr int kColWarps = 8;  // warps a block along H

// top / bottom: a block a (plane, tile of 32 V columns); its warps take R
// rows each a pass, in scan order; kBackward scans from the last row (top)
template <typename T, int V, int R, bool kBackward>
__global__ void __launch_bounds__(32 * kColWarps)
    pool_cols_kernel(const T* __restrict__ x, T* __restrict__ out, int h,
                     int w, int tiles) {
  __shared__ float totals[kColWarps][32 * V];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long plane = blockIdx.x / tiles;
  const int col = (blockIdx.x % tiles) * 32 * V + lane * V;
  const bool live = col < w;
  const long long base = plane * h * static_cast<long long>(w) + col;
  float carry[V];
#pragma unroll
  for (int i = 0; i < V; ++i) carry[i] = -INFINITY;
  for (int pass0 = 0; pass0 < h; pass0 += kColWarps * R) {
    const int s0 = pass0 + warp * R;
    float v[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r;
      if (live && s < h) {
        const int y = kBackward ? h - 1 - s : s;
        load_vec<T, V>(x + base + static_cast<long long>(y) * w, v[r]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[r][i] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 1; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[r][i] = later_max(v[r - 1][i], v[r][i]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) totals[warp][lane * V + i] = v[R - 1][i];
    __syncthreads();
    float pre[V];
#pragma unroll
    for (int i = 0; i < V; ++i) pre[i] = carry[i];
    for (int k = 0; k < kColWarps; ++k) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float t = totals[k][lane * V + i];
        if (k < warp) pre[i] = later_max(pre[i], t);
        carry[i] = later_max(carry[i], t);
      }
    }
    // carry now folds every chunk of this pass, pre the chunks before ours
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r;
      if (live && s < h) {
        const int y = kBackward ? h - 1 - s : s;
#pragma unroll
        for (int i = 0; i < V; ++i) v[r][i] = later_max(pre[i], v[r][i]);
        store_vec<T, V>(out + base + static_cast<long long>(y) * w, v[r]);
      }
    }
    __syncthreads();  // totals are rewritten by the next pass
  }
}

template <typename T, int V, bool kBackward>
cudaError_t launch_rows(const T* x, T* out, long long rows, int w,
                        cudaStream_t st) {
  const int threads = 256;
  const long long blocks = (rows * 32 + threads - 1) / threads;
  pool_rows_kernel<T, V, kBackward>
      <<<static_cast<unsigned>(blocks), threads, 0, st>>>(x, out, rows, w);
  return cudaGetLastError();
}

template <typename T, int V, int R, bool kBackward>
cudaError_t launch_cols(const T* x, T* out, long long planes, int h, int w,
                        cudaStream_t st) {
  const int tiles = (w + 32 * V - 1) / (32 * V);
  pool_cols_kernel<T, V, R, kBackward>
      <<<static_cast<unsigned>(planes * tiles), 32 * kColWarps, 0, st>>>(
          x, out, h, w, tiles);
  return cudaGetLastError();
}

// V = kVec where rows split into 16-byte pieces, else 1
template <typename T, int kRowVec, int kColVec, int kColRows>
cudaError_t corner_pool_launch(const T* x, T* out, long long planes, int h,
                               int w, int along_w, int backward,
                               cudaStream_t st) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (along_w) {
    const long long rows = planes * h;
    const bool vec = aligned && w % kRowVec == 0;
    if (vec)
      return backward ? launch_rows<T, kRowVec, true>(x, out, rows, w, st)
                      : launch_rows<T, kRowVec, false>(x, out, rows, w, st);
    return backward ? launch_rows<T, 1, true>(x, out, rows, w, st)
                    : launch_rows<T, 1, false>(x, out, rows, w, st);
  }
  const bool vec = aligned && w % kColVec == 0;
  if (vec)
    return backward
               ? launch_cols<T, kColVec, kColRows, true>(x, out, planes, h, w,
                                                         st)
               : launch_cols<T, kColVec, kColRows, false>(x, out, planes, h,
                                                          w, st);
  return backward ? launch_cols<T, 1, 16, true>(x, out, planes, h, w, st)
                  : launch_cols<T, 1, 16, false>(x, out, planes, h, w, st);
}

// Channels-last maps, NCHW output: a block takes 32 channels (kClC) of kO
// rays (neighbours along the other axis), a thread a ray, 32 elements of
// it a pass (kClS). The loads run along C (a warp reads 32 neighbouring
// channels of one pixel); the thread scans its pass in registers, and the
// pass goes through shared memory to be stored along W: the ray itself for
// left / right (kO = 2, small blocks spread evenly over the SMs; kO = 8
// ran as fast on the H100), the block's 8 rays for top / bottom (kO = 8:
// 32-byte runs).
// The next pass's loads are in flight while a pass is scanned and stored.
constexpr int kClC = 32, kClS = 32;

// the shared tile's index of ray element s of ray o, channel c: the loads'
// and the scans' lanes (c) and the stores' (s for left / right, o and c
// for top / bottom) fall in distinct banks, or two to a bank
template <bool kAlongW, int kO>
__device__ __forceinline__ int nhwc_tile_index(int s, int o, int c) {
  return kAlongW ? (o * kClC + c) * (kClS + 1) + s
                 : (s * kClC + c) * (kO + 1) + o;
}

// pass of the ray at src (elements step apart, ls long), in scan order;
// -inf past the ray's end or where the thread has no ray
template <typename T, bool kBackward>
__device__ __forceinline__ void nhwc_load(const T* __restrict__ src,
                                          long long step, int ls, int pass,
                                          bool live, float (&v)[kClS]) {
#pragma unroll
  for (int j = 0; j < kClS; ++j) {
    const int s = pass * kClS + j;
    const int y = kBackward ? ls - 1 - s : s;
    v[j] = live && s < ls ? widen(src[y * step]) : -INFINITY;
  }
}

template <typename T, bool kAlongW, bool kBackward, int kO>
__global__ void __launch_bounds__(kClC * kO)
    pool_nhwc_kernel(const T* __restrict__ x, T* __restrict__ out, int ch,
                     int h, int w, int o_tiles, int c_tiles) {
  __shared__ float tile[kAlongW ? kO * kClC * (kClS + 1)
                                : kClS * kClC * (kO + 1)];
  const int ls = kAlongW ? w : h, lo = kAlongW ? h : w;
  const int ct = blockIdx.x % c_tiles;
  const int ot = (blockIdx.x / c_tiles) % o_tiles;
  const long long n = blockIdx.x / (c_tiles * o_tiles);
  const int cl = threadIdx.x % kClC, ol = threadIdx.x / kClC;
  const int c0 = ct * kClC, o0 = ot * kO;
  const bool live = c0 + cl < ch && o0 + ol < lo;
  const long long pixels = static_cast<long long>(h) * w;
  // the thread's ray: (row o, column s) along W, (row s, column o) along H
  const long long step = kAlongW ? ch : static_cast<long long>(w) * ch;
  const T* src = x + n * pixels * ch + c0 + cl +
                 (kAlongW ? static_cast<long long>(o0 + ol) * w * ch
                          : static_cast<long long>(o0 + ol) * ch);
  T* dst = out + n * pixels * ch;
  const int passes = (ls + kClS - 1) / kClS;
  float carry = -INFINITY;
  float v[kClS], next[kClS];
  nhwc_load<T, kBackward>(src, step, ls, 0, live, v);
  for (int pass = 0; pass < passes; ++pass) {
    if (pass + 1 < passes)
      nhwc_load<T, kBackward>(src, step, ls, pass + 1, live, next);
#pragma unroll
    for (int j = 0; j < kClS; ++j) {
      carry = later_max(carry, v[j]);
      tile[nhwc_tile_index<kAlongW, kO>(j, ol, cl)] = carry;
    }
    __syncthreads();
    // kO * kClC * kClS elements, a thread's every blockDim.x-th
#pragma unroll 4
    for (int k = 0; k < kClS; ++k) {
      const int e = k * kClC * kO + threadIdx.x;
      int s, o, c;
      if (kAlongW) {  // lanes along the ray
        s = e % kClS, c = (e / kClS) % kClC, o = e / (kClS * kClC);
      } else {  // lanes along the block's rays, then channels
        o = e % kO, c = (e / kO) % kClC, s = e / (kO * kClC);
      }
      const int sp = pass * kClS + s;
      if (c0 + c < ch && o0 + o < lo && sp < ls) {
        const int y = kBackward ? ls - 1 - sp : sp;
        const long long at = static_cast<long long>(c0 + c) * pixels +
                             (kAlongW ? static_cast<long long>(o0 + o) * w + y
                                      : static_cast<long long>(y) * w + o0 +
                                            o);
        narrow(tile[nhwc_tile_index<kAlongW, kO>(s, o, c)], dst + at);
      }
    }
    __syncthreads();  // the tile is rewritten by the next pass
#pragma unroll
    for (int j = 0; j < kClS; ++j) v[j] = next[j];
  }
}

template <typename T, bool kAlongW, bool kBackward>
cudaError_t launch_nhwc(const T* x, T* out, int n, int ch, int h, int w,
                        cudaStream_t st) {
  constexpr int kO = kAlongW ? 2 : 8;
  const int o_tiles = ((kAlongW ? h : w) + kO - 1) / kO;
  const int c_tiles = (ch + kClC - 1) / kClC;
  pool_nhwc_kernel<T, kAlongW, kBackward, kO>
      <<<static_cast<unsigned>(static_cast<long long>(n) * o_tiles *
                               c_tiles),
         kClC * kO, 0, st>>>(x, out, ch, h, w, o_tiles, c_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t corner_pool_nhwc_launch(const T* x, T* out, int n, int ch,
                                    int h, int w, int along_w, int backward,
                                    cudaStream_t st) {
  if (along_w)
    return backward ? launch_nhwc<T, true, true>(x, out, n, ch, h, w, st)
                    : launch_nhwc<T, true, false>(x, out, n, ch, h, w, st);
  return backward ? launch_nhwc<T, false, true>(x, out, n, ch, h, w, st)
                  : launch_nhwc<T, false, false>(x, out, n, ch, h, w, st);
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
      e[off[l + 1] + i] = later_max(e[off[l] + 2 * i],
                                     e[off[l] + 2 * i + 1]);
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
        v = later_max(o[off[l + 1] + (k >> 1) - 1], e[off[l] + k]);
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
    narrow(ge[i], out + origin + (backward ? n - 1 - i : i) * step);
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

// x and out (planes, h, w), float32 or bf16 (is_bf16); along_w 0 scans
// the rows of each column (top / bottom), 1 the columns of each row (left /
// right); backward 1 scans from the last element (top, left). Returns
// cudaGetLastError() after the launch.
extern "C" int erd_corner_pool(const void* x, void* out, int planes, int h,
                               int w, int along_w, int backward, int is_bf16,
                               void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = corner_pool_launch<__nv_bfloat16, 8, 8, 4>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), planes, h, w, along_w, backward,
        st);
  } else {
    err = corner_pool_launch<float, 8, 4, 4>(
        static_cast<const float*>(x), static_cast<float*>(out), planes, h, w,
        along_w, backward, st);
  }
  return static_cast<int>(err);
}

// x (n, ch, h, w) channels-last (ch the innermost), out (n, ch, h, w)
// NCHW; the rest as erd_corner_pool's.
extern "C" int erd_corner_pool_nhwc(const void* x, void* out, int n, int ch,
                                    int h, int w, int along_w, int backward,
                                    int is_bf16, void* stream) {
  if (n <= 0 || ch <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = corner_pool_nhwc_launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), n, ch, h, w, along_w, backward,
        st);
  } else {
    err = corner_pool_nhwc_launch<float>(static_cast<const float*>(x),
                                         static_cast<float*>(out), n, ch, h,
                                         w, along_w, backward, st);
  }
  return static_cast<int>(err);
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
