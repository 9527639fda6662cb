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
// position. The kernel replays that tree, level l holding floor(n / 2^l)
// nodes:
//   up the levels:   e[l+1][i] = max(e[l][2i], e[l][2i+1]) (pairs);
//   down the levels: the scan's outputs o[l] from o[l+1] (odd outputs are
//                    o[l+1][i], even ones max(o[l+1][i-1], e[l][2i]));
//   up again:        the output gradient g[l] split onto each combine's
//                    operands with weight 1, 0.5 (a tie) or 0, giving
//                    g[l+1] and the leaves' share ge[l];
//   down again:      ge[l+1] split onto the pairs that formed e[l+1].
// Every max there carries NaN as the forward's does. Every gradient is the
// sum of at most two such products, so the result equals the plain
// version's (torch autograd through the same recursion) to the bit.
// Design: a block of 8 warps takes a tile of 32 rays (32 channels; or 8
// channels x 4 columns, or 32 columns, where a tensor is NCHW and the rays
// run along H) and stages x and the output gradient in shared memory, each
// with loads along its own unit-stride axis: channels-last maps (the
// hourglass's direction convs on the card) and NCHW ones are read where
// they lie, and the result is written in x's layout. Then a warp a ray:
// lane L holds leaves 8L .. 8L + 7 (16 for rays of 257-512), so the first
// three (four) levels are pairs inside a lane's registers; the levels above
// hold node i in lane i and pass values by shuffles. No block-wide barrier
// inside the tree: two a tile, around it. Bound: bytes, x and the output
// gradient read once, the input gradient written once (3 x 151 MB for a
// (6, 128, 192, 256) float32 call of a bs-6 CornerNet step).
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

// the backward's tile: 32 rays (rc channels x 32 / rc of the other spatial
// axis, rc fastest) by the ray's n positions, each tensor in shared memory
// at p * 32 + (r ^ swizzle(p)): a warp reading lane L's V consecutive
// leaves of one ray, a warp filling 32 rays' element at one position, and
// a warp filling 32 consecutive positions of one ray all hit 32 banks
constexpr int kRays = 32;
constexpr int kBackwardThreads = 256;
constexpr int kWarps = kBackwardThreads / 32;
constexpr int kMaxRay = 512;  // 32 lanes of 16 leaves
constexpr int kBatch = 8;     // loads in flight a thread while staging

__device__ __forceinline__ int tile_at(int p, int r) {
  return p * kRays + (r ^ (((p >> 3) ^ ((p & 7) << 2)) & 31));
}

struct Strides {
  long long n, c, p, o;  // image, channel, along the ray, the other axis
};

// A tile's geometry: rc_n = 2^rc_log2 channels from c0, 32 / rc_n places
// of the other axis from o0; ray r = ro * rc_n + rc. `fast` is the axis
// along which a tensor's elements are adjacent: 0 channels, 1 the ray, 2
// the other axis.
struct Tile {
  long long image;
  int c0, o0, ch, other, n, rc_log2;
  __device__ __forceinline__ bool has(int r) const {
    return c0 + (r & ((1 << rc_log2) - 1)) < ch && o0 + (r >> rc_log2) < other;
  }
  __device__ __forceinline__ long long ray_offset(const Strides& s,
                                                  int r) const {
    return image * s.n + (c0 + (r & ((1 << rc_log2) - 1))) * s.c +
           (o0 + (r >> rc_log2)) * s.o;
  }
  // the ray that lane takes where a warp covers 32 rays at one position
  __device__ __forceinline__ int lane_ray(int lane, int fast) const {
    if (fast == 0) return lane;  // rc fastest: the ray index itself
    const int ro_log2 = 5 - rc_log2;  // ro fastest
    return ((lane & ((1 << ro_log2) - 1)) << rc_log2) | (lane >> ro_log2);
  }
};

// the tile of src (global, layout s) into dst (shared), kBatch loads in
// flight a thread: along the ray, a warp a ray and its lanes along it;
// else a warp a position and its lanes across the 32 rays
template <typename T>
__device__ __forceinline__ void stage_in(const T* __restrict__ src,
                                         const Strides& s, int fast,
                                         const Tile& t,
                                         float* __restrict__ dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (fast == 1) {
    for (int r = warp; r < kRays; r += kWarps) {
      if (!t.has(r)) continue;
      const T* base = src + t.ray_offset(s, r);
      for (int p0 = lane; p0 < t.n; p0 += 32 * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int p = p0 + 32 * q;
          v[q] = p < t.n ? widen(base[p * s.p]) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (p0 + 32 * q < t.n) dst[tile_at(p0 + 32 * q, r)] = v[q];
      }
    }
    return;
  }
  const int r = t.lane_ray(lane, fast);
  const bool ok = t.has(r);
  const T* base = src + (ok ? t.ray_offset(s, r) : 0);
  for (int p0 = warp; p0 < t.n; p0 += kWarps * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int p = p0 + kWarps * q;
      v[q] = ok && p < t.n ? widen(base[p * s.p]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (p0 + kWarps * q < t.n) dst[tile_at(p0 + kWarps * q, r)] = v[q];
  }
}

// the tile in src (shared) out to dst (global, layout s), as stage_in
template <typename T>
__device__ __forceinline__ void stage_out(const float* __restrict__ src,
                                          const Strides& s, int fast,
                                          const Tile& t,
                                          T* __restrict__ dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (fast == 1) {
    for (int r = warp; r < kRays; r += kWarps) {
      if (!t.has(r)) continue;
      T* base = dst + t.ray_offset(s, r);
      for (int p = lane; p < t.n; p += 32)
        narrow(src[tile_at(p, r)], base + p * s.p);
    }
    return;
  }
  const int r = t.lane_ray(lane, fast);
  if (!t.has(r)) return;
  T* base = dst + t.ray_offset(s, r);
  for (int p = warp; p < t.n; p += kWarps)
    narrow(src[tile_at(p, r)], base + p * s.p);
}

// One level of the scan tree in a lane's registers: N nodes (N = V >> j at
// level j, the lane's nodes lane N .. lane N + N - 1), and the levels above
// it, down to one node a lane (level S). e: the combines' values; o: the
// scan's outputs; g: the outputs' gradients, then in place the leaves'
// shares ge.
template <int N>
struct Levels {
  float e[N], o[N], g[N];
  Levels<N / 2> up;
};
template <>
struct Levels<1> {
  float e[1], o[1], g[1];
};

__device__ __forceinline__ Levels<1>& lane_top(Levels<1>& l) { return l; }
template <int N>
__device__ __forceinline__ Levels<1>& lane_top(Levels<N>& l) {
  return lane_top(l.up);
}

__device__ __forceinline__ void combine_up(Levels<1>&) {}
template <int N>
__device__ __forceinline__ void combine_up(Levels<N>& l) {
#pragma unroll
  for (int u = 0; u < N / 2; ++u)
    l.up.e[u] = later_max(l.e[2 * u], l.e[2 * u + 1]);
  combine_up(l.up);
}

// o of level j (and below it) from o of level j + 1; levels at or above
// the top keep o = e (the top's own output; nothing above it)
__device__ __forceinline__ void outputs_down(Levels<1>&, int, int, int) {}
template <int N>
__device__ __forceinline__ void outputs_down(Levels<N>& l, int j, int top,
                                             int lane) {
  outputs_down(l.up, j + 1, top, lane);
  const float prev = __shfl_up_sync(kFull, l.up.o[N / 2 - 1], 1);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float v;
    if (u & 1)
      v = l.up.o[u >> 1];
    else if (u == 0)
      v = lane == 0 ? l.e[0] : later_max(prev, l.e[0]);
    else
      v = later_max(l.up.o[u == 0 ? 0 : (u >> 1) - 1], l.e[u]);
    l.o[u] = j < top ? v : l.e[u];
  }
}

// g of level j + 1 from g of level j, whose nodes then take their leaf
// shares, and so on up to level S
__device__ __forceinline__ void grads_up(Levels<1>&, int, int, int) {}
template <int N>
__device__ __forceinline__ void grads_up(Levels<N>& l, int j, int n,
                                         int lane) {
  const int len = n >> j;
  const float prev = __shfl_up_sync(kFull, l.o[N - 1], 1);
  float term[N], leaf[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const float before = u == 0 ? prev : l.o[u == 0 ? 0 : u - 1];
    term[u] = __fmul_rn(l.g[u], share(before, l.e[u], l.o[u]));
    leaf[u] = (u & 1) ? 0.f
              : (u == 0 && lane == 0)
                  ? l.g[0]
                  : __fmul_rn(l.g[u], share(l.e[u], before, l.o[u]));
  }
  const float next = __shfl_down_sync(kFull, term[0], 1);
#pragma unroll
  for (int u = 0; u < N / 2; ++u) {
    const int i = lane * (N / 2) + u;
    const float t = 2 * u + 2 < N ? term[2 * u + 2 < N ? 2 * u + 2 : 0]
                                  : next;
    l.up.g[u] = 2 * i + 2 < len ? __fadd_rn(l.g[2 * u + 1], t)
                                : l.g[2 * u + 1];
  }
#pragma unroll
  for (int u = 0; u < N; ++u) l.g[u] = leaf[u];
  grads_up(l.up, j + 1, n, lane);
}

// each pair's share at level j + 1 split onto its two nodes at level j
__device__ __forceinline__ void shares_down(Levels<1>&, int, int, int,
                                            int) {}
template <int N>
__device__ __forceinline__ void shares_down(Levels<N>& l, int j, int n,
                                            int top, int lane) {
  shares_down(l.up, j + 1, n, top, lane);
  const int paired = 2 * (n >> (j + 1));
#pragma unroll
  for (int u = 0; u < N; ++u)
    if (j < top && lane * N + u < paired)
      l.g[u] = __fadd_rn(l.g[u], __fmul_rn(l.up.g[u >> 1], share(
                                     l.e[u], l.e[u ^ 1], l.up.e[u >> 1])));
}

// One ray of n leaves in scan order (n <= 32 V), lane L holding leaves
// V L .. V L + V - 1 in l.e (x) and l.g (the output gradient): l.g becomes
// the gradient in x of sum(scan_max(x) * g). Levels 0..S (V = 2^S) are in
// each lane's registers (a level-j node's two children are in its lane);
// levels S..S+5 hold node i in lane i.
template <int S>
__device__ __forceinline__ void ray_backward(Levels<(1 << S)>& l, int n,
                                             int lane) {
  constexpr int kCross = 6;  // levels S .. S + 5: 32 V >> 5 ... 1 nodes
  float ex[kCross], ox[kCross], gx[kCross];
  const int top = 31 - __clz(n);  // len_j = n >> j, len_top = 1
  Levels<1>& mid = lane_top(l);
  combine_up(l);
  ex[0] = mid.e[0];
#pragma unroll
  for (int x = 0; x < kCross - 1; ++x)
    ex[x + 1] = later_max(__shfl_sync(kFull, ex[x], 2 * lane),
                          __shfl_sync(kFull, ex[x], 2 * lane + 1));
#pragma unroll
  for (int x = 0; x < kCross; ++x) ox[x] = ex[x];  // the top's own value
#pragma unroll
  for (int x = kCross - 2; x >= 0; --x) {
    const float odd = __shfl_sync(kFull, ox[x + 1], lane >> 1);
    const float even =
        __shfl_sync(kFull, ox[x + 1], max((lane >> 1) - 1, 0));
    if (S + x < top)
      ox[x] = lane == 0 ? ex[x] : (lane & 1) ? odd : later_max(even, ex[x]);
  }
  mid.o[0] = ox[0];
  outputs_down(l, 0, top, lane);
  grads_up(l, 0, n, lane);
  gx[0] = mid.g[0];
#pragma unroll
  for (int x = 0; x < kCross; ++x) {
    const int len = n >> (S + x);
    const float before = __shfl_up_sync(kFull, ox[x], 1);
    const float term = __fmul_rn(gx[x], share(before, ex[x], ox[x]));
    const float leaf = lane == 0 ? gx[x]
                       : (lane & 1) ? 0.f
                                    : __fmul_rn(gx[x],
                                                share(ex[x], before, ox[x]));
    if (x + 1 < kCross) {
      const float a = __shfl_sync(kFull, gx[x], 2 * lane + 1);
      const float t = __shfl_sync(kFull, term, 2 * lane + 2);
      if (S + x < top) gx[x + 1] = 2 * lane + 2 < len ? __fadd_rn(a, t) : a;
    }
    gx[x] = leaf;
  }
#pragma unroll
  for (int x = kCross - 2; x >= 0; --x) {
    const float gp = __shfl_sync(kFull, gx[x + 1], lane >> 1);
    const float c = __shfl_sync(kFull, ex[x + 1], lane >> 1);
    const float sib = __shfl_sync(kFull, ex[x], lane ^ 1);
    if (S + x < top && lane < 2 * (n >> (S + x + 1)))
      gx[x] = __fadd_rn(gx[x], __fmul_rn(gp, share(ex[x], sib, c)));
  }
  mid.g[0] = gx[0];
  shares_down(l, 0, n, top, lane);
}

// One block a tile of 32 rays of one image: x and the output gradient
// staged in shared memory along each tensor's unit-stride axis (x_fast,
// g_fast), a warp a ray for the tree, the result written over x's tile and
// stored in x's layout. `other` is the size of the axis across the rays
// besides C. Rays up to 256 fit in 80 registers a thread, so three blocks
// (64 KB of shared memory each) share an SM, faster than two on the
// CornerNet step's calls.
template <typename T, int S>
__global__ void __launch_bounds__(kBackwardThreads, S == 3 ? 3 : 1)
    corner_pool_backward_kernel(const T* __restrict__ x,
                                const T* __restrict__ grad,
                                T* __restrict__ out, Strides xs, Strides gs,
                                int ch, int other, int n, int rc_log2,
                                int x_fast, int g_fast, int backward) {
  extern __shared__ float tile[];
  float* tx = tile;
  float* tg = tile + static_cast<size_t>(n) * kRays;
  const int c_tiles = (ch + (1 << rc_log2) - 1) >> rc_log2;
  const int ro_n = kRays >> rc_log2;
  const int o_tiles = (other + ro_n - 1) / ro_n;
  const long long per_image = static_cast<long long>(c_tiles) * o_tiles;
  const int rest = static_cast<int>(blockIdx.x % per_image);
  const Tile t{blockIdx.x / per_image, (rest / o_tiles) << rc_log2,
               (rest % o_tiles) * ro_n, ch, other, n, rc_log2};
  stage_in(x, xs, x_fast, t, tx);
  stage_in(grad, gs, g_fast, t, tg);
  __syncthreads();
  constexpr int V = 1 << S;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kRays; r += kWarps) {
    if (!t.has(r)) continue;  // the whole warp: a ray is a warp's
    Levels<V> l;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int q = lane * V + v;
      const int p = backward ? n - 1 - q : q;
      l.e[v] = q < n ? tx[tile_at(p, r)] : -INFINITY;
      l.g[v] = q < n ? tg[tile_at(p, r)] : 0.f;
    }
    ray_backward<S>(l, n, lane);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int q = lane * V + v;
      if (q < n) tx[tile_at(backward ? n - 1 - q : q, r)] = l.g[v];
    }
  }
  __syncthreads();
  stage_out(tx, xs, x_fast, t, out);
}

template <typename T, int S>
cudaError_t backward_launch(const T* x, const T* grad, T* out,
                            const Strides& xs, const Strides& gs, int images,
                            int ch, int other, int n, int rc_log2,
                            int x_fast, int g_fast, int backward,
                            cudaStream_t st) {
  const size_t smem = 2 * sizeof(float) * kRays * static_cast<size_t>(n);
  auto kernel = corner_pool_backward_kernel<T, S>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int ro_n = kRays >> rc_log2;
  const long long blocks = static_cast<long long>(images) *
                           ((ch + (1 << rc_log2) - 1) >> rc_log2) *
                           ((other + ro_n - 1) / ro_n);
  kernel<<<static_cast<unsigned>(blocks), kBackwardThreads, smem, st>>>(
      x, grad, out, xs, gs, ch, other, n, rc_log2, x_fast, g_fast, backward);
  return cudaGetLastError();
}

template <typename T>
cudaError_t corner_pool_backward_launch(const T* x, const T* grad, T* out,
                                        const long long* x_strides,
                                        const long long* g_strides,
                                        int images, int ch, int h, int w,
                                        int along_w, int backward,
                                        cudaStream_t st) {
  const int n = along_w ? w : h, other = along_w ? h : w;
  // strides (n, c, h, w) of each tensor, as ray (p) and other axis (o)
  auto strides = [along_w](const long long* s) {
    return Strides{s[0], s[1], along_w ? s[3] : s[2], along_w ? s[2] : s[3]};
  };
  const Strides xs = strides(x_strides), gs = strides(g_strides);
  auto fast = [](const Strides& s) {
    return s.c == 1 ? 0 : s.p == 1 ? 1 : 2;
  };
  const int x_fast = fast(xs), g_fast = fast(gs);
  // channels a tile: 32 where every tensor reads whole lines along C or
  // along the ray, 1 where both read along the other axis, 8 (32-byte
  // pieces of both) where one reads along C and one along the other axis;
  // never more than C rounds up to
  int rc_log2 = 5;
  if (x_fast == 2 && g_fast == 2)
    rc_log2 = 0;
  else if (x_fast == 2 || g_fast == 2)
    rc_log2 = 3;
  while (rc_log2 > 0 && (1 << (rc_log2 - 1)) >= ch) --rc_log2;
  if (n <= 256)
    return backward_launch<T, 3>(x, grad, out, xs, gs, images, ch, other, n,
                                 rc_log2, x_fast, g_fast, backward, st);
  return backward_launch<T, 4>(x, grad, out, xs, gs, images, ch, other, n,
                               rc_log2, x_fast, g_fast, backward, st);
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

// x, grad and out (images, ch, h, w), float32 or bf16 (is_bf16), each
// NCHW or channels-last as its strides (x_strides, g_strides: 4 element
// strides in n, c, h, w order) say; out has x's strides. along_w and
// backward as erd_corner_pool's. out receives the gradient in x of
// sum(corner_pool(x) * grad). Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a ray longer than 512.
extern "C" int erd_corner_pool_backward(const void* x, const void* grad,
                                        void* out,
                                        const long long* x_strides,
                                        const long long* g_strides,
                                        int images, int ch, int h, int w,
                                        int along_w, int backward,
                                        int is_bf16, void* stream) {
  if (images <= 0 || ch <= 0 || h <= 0 || w <= 0) return 0;
  if ((along_w ? w : h) > kMaxRay)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = corner_pool_backward_launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(grad),
        static_cast<__nv_bfloat16*>(out), x_strides, g_strides, images, ch,
        h, w, along_w, backward, st);
  } else {
    err = corner_pool_backward_launch<float>(
        static_cast<const float*>(x), static_cast<const float*>(grad),
        static_cast<float*>(out), x_strides, g_strides, images, ch, h, w,
        along_w, backward, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
