// Bilinear point sampling, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/sampling.py `point_sample` (align_corners=False)
// with `_grid_sample_bilinear`, as erd_tpu/models/detectors/point_rend.py
// calls it: the coarse calls sample each RoI's (14, 14, C) logit map at its
// own points, the fine call one image's P2 map at the points of all its
// RoIs. On the TPU both were gathers of four clipped corners times 0/1
// validity masks; here each point reads only its four corners.
//
// Every layout forms a point's coordinates and its four bilinear weights
// as the plain version does, and sums v00*(1-wy)*(1-wx) + v01*(1-wy)*wx +
// v10*wy*(1-wx) + v11*wy*wx left to right, each op rounded on its own (the
// library is built with -fmad=false), so every layout agrees with the
// plain version to the bit. bf16 maps are widened in registers, which
// gives erd_tpu's astype(float32) values; a corner off the map reads 0
// (zero padding per corner, as the reference's validity mask).
//
// Bound on this card: bytes. Each output float is written once and each
// map pixel under the points read once; the ~11 flops a sample are far
// below the float32 peak. The wrapper's plan (`point_sample_plan` in
// ops/sampling.py) picks one of three layouts of the forward:
// - Staged map (`point_sample_staged_kernel`): where a map's C x H x W
//   elements fit in shared memory (PointRend's 14 x 14 logit maps: 80
//   channels, 62.7 KB, or one channel). A block copies its maps into
//   shared memory once (16-byte cp.async where a map is dense in (H, W, C)
//   order and aligned, else element by element through the strides),
//   forms each point's corners and weights once into shared memory (C >
//   1), then its threads walk the maps' (K, C) outputs in memory order, 4
//   channels a thread where C % 4 == 0 (one float4 store), a point a
//   thread where C = 1. Corners come from shared memory.
// - Unit-stride channels (`point_sample_unit_kernel`): where the channel
//   stride is 1, C is a multiple of 16 bytes' elements and the map 16-byte
//   aligned (the bf16 channels-last P2 of the fine calls). A lane takes 8
//   bf16 (4 float32) channels with one 16-byte load a corner, so a warp
//   covers 256 bf16 channels of a point in one pass, and stores them as
//   float4s; a thread keeps 2 points in flight (4 or 8 were slower).
// - General strides (`point_sample_kernel`): any other layout, a warp a
//   point, a lane a channel (lane, lane + 32, ...).
// Index math is 32-bit wherever the plan proves the sizes fit.
//
// Backward (`erd_point_sample_backward`), the transpose of the four corner
// gathers: a gather by tile of pixels, with no float atomics and no
// float32 buffer. A gather block owns a tile of one map, its float32 sums
// in shared memory, a warp a slice of 32 channels (lane = channel, the
// maps' unit-stride axis on the path), and takes the points whose corners
// reach the tile, one after another: each point's gradient slice is read
// once a tile and times its corners' weights, (g * wx) * wy as the plain
// version forms them, added to the sums of its corners in the tile. No
// two warps share a sum, so there are no atomics, and each sum takes its
// terms in the list's order: the result is the same every run (a float32
// sum in another order than the plain version's index_add_). The tile is
// then rounded once to the map's dtype and written once, zeros where no
// corner fell, in the map's strides.
// - A map of at most 255 pixels whose sums fit in 96 KB (the coarse call's
//   14 x 14 logits of one RoI) is one tile, and its points are its list,
//   in point order: one launch.
// - A larger map (the fine call's P2) is cut into 8 x 8 tiles, and its
//   points are binned by tile first, by a stable counting sort: a warp
//   ranks 512 points of a map in order against each tile they reach
//   (integer counts in shared memory), the counts of each (map, tile,
//   block of points) are scanned, and each point is written into each of
//   its tiles' lists at its rank. The lists hold a tile's points block by
//   block, in order within a block.
// The gather loads the gradients of 16 entries a warp while it sums 16.
// Bound: bytes (the gradient read, the map written: 2.2 GB at a bs-16 P2
// call, 0.66 ms at 3.35 TB/s); the lists add ~4 int32 a point.
#include <algorithm>

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive elements, aligned to their size
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__global__ void point_sample_kernel(const T* __restrict__ maps,
                                    const float* __restrict__ points, int c,
                                    int h, int w, int k, long long n_points,
                                    long long sn, long long sc, long long sy,
                                    long long sx, float* __restrict__ out) {
  const long long p = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n_points) return;
  const long long img = p / k;
  const float xs = __fsub_rn(__fmul_rn(points[2 * p], static_cast<float>(w)),
                             0.5f);
  const float ys = __fsub_rn(
      __fmul_rn(points[2 * p + 1], static_cast<float>(h)), 0.5f);
  const float x0f = floorf(xs), y0f = floorf(ys);
  const float wx = __fsub_rn(xs, x0f), wy = __fsub_rn(ys, y0f);
  const float hx = __fsub_rn(1.f, wx), hy = __fsub_rn(1.f, wy);
  // validity in float, so a far-off point never converts out of int range
  const bool oy0 = y0f >= 0.f && y0f < static_cast<float>(h);
  const bool oy1 = y0f >= -1.f && y0f < static_cast<float>(h - 1);
  const bool ox0 = x0f >= 0.f && x0f < static_cast<float>(w);
  const bool ox1 = x0f >= -1.f && x0f < static_cast<float>(w - 1);
  const long long y0 = oy0 || oy1 ? static_cast<long long>(y0f) : 0;
  const long long x0 = ox0 || ox1 ? static_cast<long long>(x0f) : 0;
  const long long o00 = y0 * sy + x0 * sx;
  const long long o01 = o00 + sx, o10 = o00 + sy, o11 = o00 + sy + sx;
  const bool ok00 = oy0 && ox0, ok01 = oy0 && ox1;
  const bool ok10 = oy1 && ox0, ok11 = oy1 && ox1;
  const T* base = maps + img * sn;
  float* dst = out + p * c;
  for (int ch = lane; ch < c; ch += 32) {
    const T* m = base + ch * sc;
    const float v00 = ok00 ? widen(m, o00) : 0.f;
    const float v01 = ok01 ? widen(m, o01) : 0.f;
    const float v10 = ok10 ? widen(m, o10) : 0.f;
    const float v11 = ok11 ? widen(m, o11) : 0.f;
    float acc = __fmul_rn(__fmul_rn(v00, hy), hx);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, hy), wx));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, wy), hx));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, wy), wx));
    dst[ch] = acc;
  }
}

// A point's bilinear corners: the weights in the plain version's
// arithmetic, the upper-left corner (y0, x0) (0 on an axis where no corner
// is on the map) and bit q for corner q = 2 * dy + dx on the map.
struct Geo {
  float wx, wy, hx, hy;
  int y0, x0;
  unsigned ok;
};

__device__ __forceinline__ Geo point_geo(float px, float py, int h, int w) {
  const float xs = __fsub_rn(__fmul_rn(px, static_cast<float>(w)), 0.5f);
  const float ys = __fsub_rn(__fmul_rn(py, static_cast<float>(h)), 0.5f);
  const float x0f = floorf(xs), y0f = floorf(ys);
  Geo g;
  g.wx = __fsub_rn(xs, x0f);
  g.wy = __fsub_rn(ys, y0f);
  g.hx = __fsub_rn(1.f, g.wx);
  g.hy = __fsub_rn(1.f, g.wy);
  // validity in float, so a far-off point never converts out of int range
  const bool oy0 = y0f >= 0.f && y0f < static_cast<float>(h);
  const bool oy1 = y0f >= -1.f && y0f < static_cast<float>(h - 1);
  const bool ox0 = x0f >= 0.f && x0f < static_cast<float>(w);
  const bool ox1 = x0f >= -1.f && x0f < static_cast<float>(w - 1);
  g.y0 = oy0 || oy1 ? static_cast<int>(y0f) : 0;
  g.x0 = ox0 || ox1 ? static_cast<int>(x0f) : 0;
  g.ok = (oy0 && ox0 ? 1u : 0u) | (oy0 && ox1 ? 2u : 0u) |
         (oy1 && ox0 ? 4u : 0u) | (oy1 && ox1 ? 8u : 0u);
  return g;
}

// the plain version's sum of one channel's four corners
__device__ __forceinline__ float bilinear(const Geo& g, float v00, float v01,
                                          float v10, float v11) {
  float acc = __fmul_rn(__fmul_rn(v00, g.hy), g.hx);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, g.hy), g.wx));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, g.wy), g.hx));
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, g.wy), g.wx));
}

// VEC consecutive elements widened to float32 (VEC = 1 or 4)
template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const __nv_bfloat16* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    r.v[0] = __uint_as_float(q.x << 16);
    r.v[1] = __uint_as_float(q.x & 0xffff0000u);
    r.v[2] = __uint_as_float(q.y << 16);
    r.v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
    r.v[0] = __bfloat162float(*p);
  }
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int kStagedThreads = 256;

// Staged map: a block takes maps m0 .. m0 + g - 1 (g = maps_per_block, the
// last block fewer), copies each into shared memory in (H, W, C) order
// (`vec_copy`: 16-byte cp.async of a dense (H, W, C) map; else element by
// element through the strides sc, sy, sx), forms each point's Geo into
// shared memory where C > 1, then walks the maps' (K, C) outputs, which
// are contiguous in `out`, VEC channels a thread.
template <typename T, int VEC>
__global__ void __launch_bounds__(kStagedThreads) point_sample_staged_kernel(
    const T* __restrict__ maps, const float* __restrict__ points, int n,
    int c, int h, int w, int k, long long sn, int sc, int sy, int sx,
    int maps_per_block, int vec_copy, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * maps_per_block;
  const int g = min(maps_per_block, n - m0);
  const int hw = h * w, hwc = hw * c;
  T* staged = reinterpret_cast<T*>(smem);
  // the Geo table after the maps, 16-byte aligned
  const int map_bytes =
      (maps_per_block * hwc * static_cast<int>(sizeof(T)) + 15) & ~15;
  float4* weights = reinterpret_cast<float4*>(smem + map_bytes);
  int2* meta = reinterpret_cast<int2*>(weights + maps_per_block * k);
  if (vec_copy) {
    constexpr int per16 = 16 / sizeof(T);
    const int chunks = hwc / per16;
    for (int j = 0; j < g; ++j) {
      const T* src = maps + static_cast<long long>(m0 + j) * sn;
      for (int i = threadIdx.x; i < chunks; i += kStagedThreads)
        cp_async16(staged + j * hwc + i * per16, src + i * per16);
    }
  } else {
    for (int j = 0; j < g; ++j) {
      const T* src = maps + static_cast<long long>(m0 + j) * sn;
      for (int i = threadIdx.x; i < hwc; i += kStagedThreads) {
        const int ch = i % c, pix = i / c;
        const int y = pix / w, x = pix - y * w;
        staged[j * hwc + i] = src[ch * sc + y * sy + x * sx];
      }
    }
  }
  const float2* pts =
      reinterpret_cast<const float2*>(points) + static_cast<long long>(m0) * k;
  if (c > 1) {
    for (int i = threadIdx.x; i < g * k; i += kStagedThreads) {
      const float2 pt = pts[i];
      const Geo q = point_geo(pt.x, pt.y, h, w);
      weights[i] = make_float4(q.wx, q.wy, q.hx, q.hy);
      meta[i] = make_int2(q.y0 * w + q.x0, static_cast<int>(q.ok));
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const int cv = c / VEC;
  const int per_map = k * cv;
  float* dst = out + static_cast<long long>(m0) * k * c;
  for (int i = threadIdx.x; i < g * per_map; i += kStagedThreads) {
    const int j = i / per_map;
    const int r = i - j * per_map;
    const int p = r / cv;
    const int ch = (r - p * cv) * VEC;
    // the corners' pixel: base, base + 1, base + w, base + w + 1 (each
    // >= 0 where its bit is set)
    Geo q;
    int base;
    if (c == 1) {
      const float2 pt = pts[i];
      q = point_geo(pt.x, pt.y, h, w);
      base = q.y0 * w + q.x0;
    } else {
      const float4 wt = weights[j * k + p];
      const int2 mt = meta[j * k + p];
      q.wx = wt.x;
      q.wy = wt.y;
      q.hx = wt.z;
      q.hy = wt.w;
      base = mt.x;
      q.ok = static_cast<unsigned>(mt.y);
    }
    const T* m = staged + j * hwc + ch;
    Vec<VEC> v00{}, v01{}, v10{}, v11{};
    if (q.ok & 1u) v00 = load_vec<VEC>(m + base * c);
    if (q.ok & 2u) v01 = load_vec<VEC>(m + (base + 1) * c);
    if (q.ok & 4u) v10 = load_vec<VEC>(m + (base + w) * c);
    if (q.ok & 8u) v11 = load_vec<VEC>(m + (base + w + 1) * c);
    float res[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      res[e] = bilinear(q, v00.v[e], v01.v[e], v10.v[e], v11.v[e]);
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst + i * 4) =
          make_float4(res[0], res[1], res[2], res[3]);
    } else {
      dst[i] = res[0];
    }
  }
}

// 16 bytes of a map: 8 bf16 or 4 float32 channels, widened
template <typename T>
struct Wide;

template <>
struct Wide<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void get(const uint4& q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
};

template <>
struct Wide<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void get(const uint4& q, float* v) {
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(u[e] << 16);
      v[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
};

constexpr int kUnitThreads = 256;
constexpr int kUnitPoints = 2;  // items a thread keeps in flight

// Unit-stride channels: item i is (point i / cv, channels (i % cv) * VEC
// .. + VEC - 1), cv = c / VEC; a thread takes kUnitPoints items a block's
// width apart, so a warp's lanes read and write neighbouring 16-byte
// vectors. I is int where the plan proves every index fits.
template <typename T, typename I>
__global__ void __launch_bounds__(kUnitThreads) point_sample_unit_kernel(
    const T* __restrict__ maps, const float* __restrict__ points, int c,
    int h, int w, int k, I n_items, I sn, I sy, I sx, int cv,
    float* __restrict__ out) {
  constexpr int VEC = Wide<T>::kVec;
  const I first = static_cast<I>(blockIdx.x) * (kUnitThreads * kUnitPoints) +
                  threadIdx.x;
  uint4 v[kUnitPoints][4];
  Geo q[kUnitPoints];
  I dst[kUnitPoints];
#pragma unroll
  for (int u = 0; u < kUnitPoints; ++u) {
    const I i = first + u * kUnitThreads;
    dst[u] = -1;
    q[u].ok = 0u;
    if (i < n_items) {
      const I p = i / cv;
      const int chunk = static_cast<int>(i - p * cv);
      const float2 pt = reinterpret_cast<const float2*>(points)[p];
      q[u] = point_geo(pt.x, pt.y, h, w);
      // the corners' element offsets: o00, o00 + sx, o00 + sy, o00 + sy +
      // sx (each >= 0 where its bit is set)
      const I o00 = (p / k) * sn + static_cast<I>(chunk) * VEC +
                    static_cast<I>(q[u].y0) * sy +
                    static_cast<I>(q[u].x0) * sx;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      const uint4* src = reinterpret_cast<const uint4*>(maps);
      // 16-byte units: every offset is a multiple of VEC elements
      v[u][0] = q[u].ok & 1u ? __ldg(src + o00 / VEC) : z;
      v[u][1] = q[u].ok & 2u ? __ldg(src + (o00 + sx) / VEC) : z;
      v[u][2] = q[u].ok & 4u ? __ldg(src + (o00 + sy) / VEC) : z;
      v[u][3] = q[u].ok & 8u ? __ldg(src + (o00 + sy + sx) / VEC) : z;
      dst[u] = p * c + static_cast<I>(chunk) * VEC;
    }
  }
#pragma unroll
  for (int u = 0; u < kUnitPoints; ++u) {
    if (dst[u] < 0) continue;
    float a[VEC], b[VEC], d[VEC], e[VEC], res[VEC];
    Wide<T>::get(v[u][0], a);
    Wide<T>::get(v[u][1], b);
    Wide<T>::get(v[u][2], d);
    Wide<T>::get(v[u][3], e);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      res[j] = bilinear(q[u], a[j], b[j], d[j], e[j]);
    float4* o = reinterpret_cast<float4*>(out + dst[u]);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      o[j] = make_float4(res[4 * j], res[4 * j + 1], res[4 * j + 2],
                         res[4 * j + 3]);
  }
}

// The backward's tiles of pixels: a map whose pixels (at most kMapTile)
// and accumulators fit is one tile; a larger map is cut into kTile x kTile
// tiles, and its points are binned by tile first.
constexpr int kTile = 8;
constexpr int kMapTile = 255;
constexpr int kMapTileBytes = 96 * 1024;
// channels a gather block sums (a warp's 32 lanes, a channel each), and the
// entries whose corners and weights a block forms at once (pixel indices
// in 16 bits: a tile has at most 255 pixels)
constexpr int kGatherChannels = 256;
constexpr int kBatch = 256;
// points a binning block ranks (a warp, 32 at a time), and the tiles a map
// may have for its counts to stay in shared memory
constexpr int kRankPoints = 512;
constexpr int kSharedTiles = 8192;
// the pixels a scan block covers
constexpr int kScanBlock = 1024;

// The corners of point p that lie on the map: bit q for corner q = 2 * dy
// + dx at (y0 + dy, x0 + dx), with (y0, x0) and the weights, by the
// forward's arithmetic; 0 where every corner is off the map.
struct Corners {
  unsigned ok;
  int y0, x0;
  float wx, wy, hx, hy;
};

__device__ __forceinline__ Corners corners(const float* __restrict__ points,
                                           long long p, int h, int w) {
  Corners r;
  const float xs = __fsub_rn(__fmul_rn(points[2 * p], static_cast<float>(w)),
                             0.5f);
  const float ys = __fsub_rn(
      __fmul_rn(points[2 * p + 1], static_cast<float>(h)), 0.5f);
  const float x0f = floorf(xs), y0f = floorf(ys);
  r.wx = __fsub_rn(xs, x0f);
  r.wy = __fsub_rn(ys, y0f);
  r.hx = __fsub_rn(1.f, r.wx);
  r.hy = __fsub_rn(1.f, r.wy);
  // validity in float, so a far-off point never converts out of int range
  const bool oy0 = y0f >= 0.f && y0f < static_cast<float>(h);
  const bool oy1 = y0f >= -1.f && y0f < static_cast<float>(h - 1);
  const bool ox0 = x0f >= 0.f && x0f < static_cast<float>(w);
  const bool ox1 = x0f >= -1.f && x0f < static_cast<float>(w - 1);
  r.ok = (oy0 && ox0 ? 1u : 0u) | (oy0 && ox1 ? 2u : 0u) |
         (oy1 && ox0 ? 4u : 0u) | (oy1 && ox1 ? 8u : 0u);
  r.y0 = r.ok ? static_cast<int>(y0f) : 0;
  r.x0 = r.ok ? static_cast<int>(x0f) : 0;
  return r;
}

// The distinct kTile x kTile tiles (in corner order) that point p's
// corners reach, as indices into its map's tiles, -1 after the last.
__device__ __forceinline__ int4 corner_tiles(const Corners& r,
                                             int tiles_across) {
  int t[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    t[q] = r.ok >> q & 1u ? (r.y0 + q / 2) / kTile * tiles_across +
                                (r.x0 + q % 2) / kTile
                          : -1;
  // a corner's tile counts once, at its first corner
#pragma unroll
  for (int q = 1; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < q; ++i)
      if (t[q] == t[i]) t[q] = -1;
  int4 out = make_int4(-1, -1, -1, -1);
  int n = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (t[q] < 0) continue;
    if (n == 0) out.x = t[q];
    else if (n == 1) out.y = t[q];
    else if (n == 2) out.z = t[q];
    else out.w = t[q];
    ++n;
  }
  return out;
}

__device__ __forceinline__ int nth(const int4& v, int d) {
  return d == 0 ? v.x : d == 1 ? v.y : d == 2 ? v.z : v.w;
}

// Pass 1 (binned maps): a warp ranks a block of kRankPoints points of one
// map, 32 at a time in order, against each tile they reach: for each
// group of 32, the d-th tile of each point for d = 0..3, the rank of the
// entry among the block's earlier entries of its tile (a fixed order, so
// a stable counting sort). Its tiles' counts after the block go to hist
// ((map, tile) major, block minor).
__global__ void __launch_bounds__(32)
point_sample_rank_kernel(const float* __restrict__ points, int h, int w,
                         int k, int tiles, int tiles_across, int blocks,
                         int* __restrict__ hist, int* __restrict__ ranks) {
  __shared__ int shared_counts[kSharedTiles];
  const int lane = threadIdx.x;
  const long long img = blockIdx.x / blocks;
  const int b = blockIdx.x % blocks;
  // counts in shared memory, or where there are too many tiles, in the
  // block's own column of hist (zeroed by the caller)
  const bool in_shared = tiles <= kSharedTiles;
  const long long column = img * tiles * static_cast<long long>(blocks) + b;
  if (in_shared)
    for (int t = lane; t < tiles; t += 32) shared_counts[t] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = 0; i0 < kRankPoints; i0 += 32) {
    const int e = b * kRankPoints + i0 + lane;
    const long long p = img * k + e;
    int4 mine = make_int4(-1, -1, -1, -1);
    if (e < k) mine = corner_tiles(corners(points, p, h, w), tiles_across);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int t = nth(mine, d);
      const unsigned peers = __match_any_sync(0xffffffffu, t);
      int* at = t < 0 ? nullptr
                      : in_shared ? shared_counts + t
                                  : hist + column + t * static_cast<long long>(
                                                            blocks);
      int before = 0;
      if (t >= 0) {
        before = *at;
        ranks[4 * p + d] = before + __popc(peers & below);
      }
      __syncwarp();
      if (t >= 0 && (peers & below) == 0) *at = before + __popc(peers);
      __syncwarp();
    }
  }
  if (in_shared)
    for (int t = lane; t < tiles; t += 32)
      hist[column + t * static_cast<long long>(blocks)] = shared_counts[t];
}

// Pass 2: the exclusive scan of the counts, in place, a block's 1024 at a
// time; each block's total into sums[blockIdx.x].
__global__ void __launch_bounds__(256)
point_sample_scan_kernel(int* __restrict__ counts, long long m,
                         int* __restrict__ sums) {
  __shared__ int warp_tot[8];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = blockIdx.x * static_cast<long long>(kScanBlock) +
                         4 * t;
  int v[4], tot = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = base + i < m ? counts[base + i] : 0;
    tot += v[i];
  }
  int inc = tot;  // inclusive scan of the threads' totals in the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += warp_tot[i];
  int run = before + inc - tot;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (base + i < m) counts[base + i] = run;
    run += v[i];
  }
  if (t == 255) sums[blockIdx.x] = run;
}

// Pass 3: the exclusive scan of the blocks' totals, in place (one block).
__global__ void __launch_bounds__(1024)
point_sample_scan_sums_kernel(int* __restrict__ sums, int nb) {
  __shared__ int warp_tot[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += 1024) {
    const int v = b0 + t < nb ? sums[b0 + t] : 0;
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    int before = carry;
    for (int i = 0; i < warp; ++i) before += warp_tot[i];
    if (b0 + t < nb) sums[b0 + t] = before + inc - v;
    int total = 0;
    for (int i = 0; i < 32; ++i) total += warp_tot[i];
    __syncthreads();
    carry += total;
  }
}

// an entry's place in the scanned counts: its scanned count plus its scan
// block's offset
__device__ __forceinline__ int scanned(const int* __restrict__ counts,
                                       const int* __restrict__ sums,
                                       long long i) {
  return counts[i] + sums[i / kScanBlock];
}

// Pass 4: each point into the list of each tile its corners reach, at its
// rank.
__global__ void point_sample_scatter_kernel(
    const float* __restrict__ points, int h, int w, int k, int tiles,
    int tiles_across, int blocks, long long n_points,
    const int* __restrict__ hist, const int* __restrict__ sums,
    const int* __restrict__ ranks, int* __restrict__ list) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (p >= n_points) return;
  const long long img = p / k;
  const int b = static_cast<int>(p % k) / kRankPoints;
  const int4 mine = corner_tiles(corners(points, p, h, w), tiles_across);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int t = nth(mine, d);
    if (t < 0) break;
    list[scanned(hist, sums, (img * tiles + t) * blocks + b) +
         ranks[4 * p + d]] = static_cast<int>(p);
  }
}

// Pass 5: the gather. A block takes one tile (th x tw pixels of one map)
// and up to kGatherChannels channels from blockIdx.y * kGatherChannels,
// its warps 32 channels each, lane = channel. The tile's float32 sums live
// in shared memory, a pixel's channels side by side (no bank conflicts),
// and one more row takes the terms of corners outside the tile. The
// tile's points are taken in their list's order (binned maps) or in point
// order (a map that is one tile): the block forms kBatch entries' corner
// rows and weights at once, then each warp adds every entry's gradient
// (g * cx) * cy to its corners' sums, the gradients of the next kGroup
// entries loading while a group is summed. No two warps share a sum, and
// each sum takes its terms in the list's order: deterministic. Then the
// tile's sums are rounded once and written once, zeros where no corner
// fell.
template <typename T>
__global__ void __launch_bounds__(256)
point_sample_gather_kernel(const float* __restrict__ grad,
                           const float* __restrict__ points,
                           const int* __restrict__ hist,
                           const int* __restrict__ sums,
                           const int* __restrict__ list, int c, int h, int w,
                           int k, int th, int tw, int tiles_across,
                           int tiles, int blocks, long long sn, long long sc,
                           long long sy, long long sx, T* __restrict__ out) {
  extern __shared__ float acc[];  // [th * tw + 1][the group's channels]
  __shared__ int rec_p[kBatch];
  // an entry's corners' pixels in the tile (16 bits each, pixels for a
  // corner outside it) and its weights wx, wy: one 16-byte load
  __shared__ uint4 rec[kBatch];
  constexpr int kGroup = 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x;
  const long long img = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int y_lo = tile / tiles_across * th, x_lo = tile % tiles_across * tw;
  const int cb = blockIdx.y * kGatherChannels;
  const int width = min(kGatherChannels, c - cb);  // a pixel's sums
  const int ch = cb + 32 * warp + lane;
  const int pixels = th * tw;
  const int warps = threads / 32;
  for (int e = tid; e < (pixels + 1) * width; e += threads) acc[e] = 0.f;
  int first = 0, count = k;  // a map that is one tile: all its points
  if (list) {
    const long long at = (img * tiles + tile) * blocks;
    first = scanned(hist, sums, at);
    count = scanned(hist, sums, at + blocks) - first;
  }
  const bool live = ch < c;
  float* mine = acc + (live ? 32 * warp + lane : 0);
  const float* g = grad + (live ? ch : 0);
  for (int e0 = 0; e0 < count; e0 += kBatch) {
    const int cnt = min(kBatch, count - e0);
    __syncthreads();  // the last batch's entries are used
    for (int e = tid; e < cnt; e += threads) {
      const long long p = list ? list[first + e0 + e] : img * k + e0 + e;
      const Corners r = corners(points, p, h, w);
      unsigned px[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int yy = r.y0 + q / 2 - y_lo, xx = r.x0 + q % 2 - x_lo;
        const bool in = r.ok >> q & 1u && yy >= 0 && yy < th && xx >= 0 &&
                        xx < tw;
        px[q] = in ? yy * tw + xx : pixels;
      }
      rec_p[e] = static_cast<int>(p);
      rec[e] = make_uint4(px[0] | px[1] << 16, px[2] | px[3] << 16,
                          __float_as_uint(r.wx), __float_as_uint(r.wy));
    }
    __syncthreads();
    if (!live) continue;
    float cur[kGroup], nxt[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      cur[i] = i < cnt ? __ldg(g + static_cast<long long>(rec_p[i]) * c)
                       : 0.f;
    for (int e = 0; e < cnt; e += kGroup) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int nx = e + kGroup + i;
        nxt[i] = nx < cnt ? __ldg(g + static_cast<long long>(rec_p[nx]) * c)
                          : 0.f;
      }
      // the next entry's record is read before this entry's sums are
      // stored, so that its load need not wait for them
      uint4 r = rec[e];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (e + i >= cnt) break;
        const uint4 r_next = rec[min(e + i + 1, kBatch - 1)];
        const int a0 = (r.x & 0xffffu) * width, a1 = (r.x >> 16) * width;
        const int a2 = (r.y & 0xffffu) * width, a3 = (r.y >> 16) * width;
        const float wx = __uint_as_float(r.z), wy = __uint_as_float(r.w);
        const float hx = __fsub_rn(1.f, wx), hy = __fsub_rn(1.f, wy);
        // the corners' sums read together, then added, then stored
        float s0 = mine[a0], s1 = mine[a1];
        float s2 = mine[a2], s3 = mine[a3];
        s0 = __fadd_rn(s0, __fmul_rn(__fmul_rn(cur[i], hx), hy));
        s1 = __fadd_rn(s1, __fmul_rn(__fmul_rn(cur[i], wx), hy));
        s2 = __fadd_rn(s2, __fmul_rn(__fmul_rn(cur[i], hx), wy));
        s3 = __fadd_rn(s3, __fmul_rn(__fmul_rn(cur[i], wx), wy));
        mine[a0] = s0;
        mine[a1] = s1;
        mine[a2] = s2;
        mine[a3] = s3;
        r = r_next;
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) cur[i] = nxt[i];
    }
  }
  __syncthreads();
  // a warp a pixel at a time, lanes over its channels (four at a time
  // where they are the map's unit-stride axis and the rows stay aligned)
  const bool quads = sc == 1 && width % 4 == 0 && cb % 4 == 0 &&
                     sn % 4 == 0 && sy % 4 == 0 && sx % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  int ly = warp / tw, lx = warp % tw;
  for (int li = warp; li < pixels; li += warps) {
    const int y = y_lo + ly, x = x_lo + lx;
    lx += warps;
    while (lx >= tw) {
      lx -= tw;
      ++ly;
    }
    if (y >= h || x >= w) continue;
    T* dst = out + img * sn + y * sy + x * sx + cb * sc;
    const float* src = acc + li * width;
    if (quads) {
      for (int cl = 4 * lane; cl < width; cl += 128)
        store4(dst + cl, *reinterpret_cast<const float4*>(src + cl));
    } else {
      for (int cl = lane; cl < width; cl += 32)
        store1(dst + cl * sc, src[cl]);
    }
  }
}

// The forward's layouts (`point_sample_plan` in ops/sampling.py).
enum PointLayout { kGeneral = 0, kStaged = 1, kUnit = 2 };

template <typename T, int VEC>
cudaError_t launch_staged(const void* maps, const float* pts, float* o, int n,
                          int c, int h, int w, int k, long long sn,
                          long long sc, long long sy, long long sx,
                          int maps_per_block, int vec_copy, cudaStream_t st) {
  const long long hwc = static_cast<long long>(h) * w * c;
  const long long map_bytes =
      (maps_per_block * hwc * static_cast<long long>(sizeof(T)) + 15) & ~15ll;
  const long long smem =
      map_bytes +
      (c > 1 ? maps_per_block * static_cast<long long>(k) * 24 : 0);
  // the kernel's within-map offsets and a block's outputs in 32 bits
  const long long inner = (c - 1) * sc + (h - 1) * sy + (w - 1) * sx;
  if (maps_per_block < 1 || smem > 227 * 1024 || sc < 0 || sy < 0 ||
      sx < 0 || inner >= (1ll << 31) ||
      static_cast<long long>(maps_per_block) * k * c >= (1ll << 31) ||
      (vec_copy && (hwc * sizeof(T) % 16 != 0 || sn * sizeof(T) % 16 != 0 ||
                    reinterpret_cast<uintptr_t>(maps) % 16 != 0)) ||
      (VEC == 4 && c % 4 != 0))
    return cudaErrorInvalidValue;
  auto kernel = point_sample_staged_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    // the shared memory granted so far on each device (set once a size)
    static int granted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || granted[dev] < smem) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (dev < 64) granted[dev] = static_cast<int>(smem);
    }
  }
  const unsigned blocks = (n + maps_per_block - 1) / maps_per_block;
  kernel<<<blocks, kStagedThreads, static_cast<size_t>(smem), st>>>(
      static_cast<const T*>(maps), pts, n, c, h, w, k, sn,
      static_cast<int>(sc), static_cast<int>(sy), static_cast<int>(sx),
      maps_per_block, vec_copy, o);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_unit(const void* maps, const float* pts, float* o, int n,
                        int c, int h, int w, int k, long long sn, long long sc,
                        long long sy, long long sx, cudaStream_t st) {
  constexpr int VEC = Wide<T>::kVec;
  if (sc != 1 || c % VEC != 0 || sn % VEC != 0 || sy % VEC != 0 ||
      sx % VEC != 0 || sn < 0 || sy < 0 || sx < 0 ||
      reinterpret_cast<uintptr_t>(maps) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long items = static_cast<long long>(n) * k * (c / VEC);
  const long long per_block = kUnitThreads * kUnitPoints;
  // 32-bit index math only where every index fits, a block's width of
  // items past the last included
  if (sizeof(I) == 4 &&
      ((items + per_block) * VEC >= (1ll << 31) ||
       (n - 1) * sn + (h - 1) * sy + (w - 1) * sx + c >= (1ll << 31)))
    return cudaErrorInvalidValue;
  point_sample_unit_kernel<T, I>
      <<<static_cast<unsigned>((items + per_block - 1) / per_block),
         kUnitThreads, 0, st>>>(static_cast<const T*>(maps), pts, c, h, w, k,
                                static_cast<I>(items), static_cast<I>(sn),
                                static_cast<I>(sy), static_cast<I>(sx),
                                c / VEC, o);
  return cudaGetLastError();
}

}  // namespace

// maps (n, c, h, w) float32 or bf16 (is_bf16) with element strides sn, sc,
// sy, sx; points (n, k, 2) float32 (x, y) in [0, 1]; out (n, k, c) float32.
// layout: kGeneral, kStaged (maps_per_block maps a block; vec_copy: each
// map dense in (H, W, C) order and 16-byte aligned) or kUnit (wide: 64-bit
// index math). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue where the layout does not take these arguments.
extern "C" int erd_point_sample(const void* maps, const void* points,
                                void* out, int n, int c, int h, int w, int k,
                                long long sn, long long sc, long long sy,
                                long long sx, int is_bf16, int layout,
                                int maps_per_block, int vec_copy, int wide,
                                void* stream) {
  const long long n_points = static_cast<long long>(n) * k;
  if (n_points <= 0 || c <= 0) return 0;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pts = static_cast<const float*>(points);
  float* o = static_cast<float*>(out);
  if (layout == kStaged) {
    const bool v4 = c % 4 == 0;
    cudaError_t err;
    if (is_bf16)
      err = (v4 ? launch_staged<__nv_bfloat16, 4>
                : launch_staged<__nv_bfloat16, 1>)(
          maps, pts, o, n, c, h, w, k, sn, sc, sy, sx, maps_per_block,
          vec_copy, st);
    else
      err = (v4 ? launch_staged<float, 4> : launch_staged<float, 1>)(
          maps, pts, o, n, c, h, w, k, sn, sc, sy, sx, maps_per_block,
          vec_copy, st);
    return static_cast<int>(err);
  }
  if (layout == kUnit) {
    cudaError_t err;
    if (is_bf16)
      err = (wide ? launch_unit<__nv_bfloat16, long long>
                  : launch_unit<__nv_bfloat16, int>)(
          maps, pts, o, n, c, h, w, k, sn, sc, sy, sx, st);
    else
      err = (wide ? launch_unit<float, long long> : launch_unit<float, int>)(
          maps, pts, o, n, c, h, w, k, sn, sc, sy, sx, st);
    return static_cast<int>(err);
  }
  if (layout != kGeneral) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;  // 8 points a block
  const unsigned blocks =
      static_cast<unsigned>((n_points * 32 + threads - 1) / threads);
  if (is_bf16) {
    point_sample_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(maps), pts, c, h, w, k, n_points,
        sn, sc, sy, sx, o);
  } else {
    point_sample_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(maps), pts, c, h, w, k, n_points, sn, sc,
        sy, sx, o);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// the backward's tiling of n maps of h x w with c channels and k points a
// map: a map that is one tile needs no binning
struct Tiling {
  int th, tw, across, tiles, blocks, width;
  bool binned;
};

Tiling tiling(int n, int c, int h, int w, int k) {
  Tiling t;
  t.width = std::min(c, kGatherChannels);
  t.binned = static_cast<long long>(h) * w > kMapTile ||
             (static_cast<long long>(h) * w + 1) * t.width * 4 >
                 kMapTileBytes;
  t.th = t.binned ? kTile : h;
  t.tw = t.binned ? kTile : w;
  t.across = (w + t.tw - 1) / t.tw;
  t.tiles = (h + t.th - 1) / t.th * t.across;
  t.blocks = t.binned ? (k + kRankPoints - 1) / kRankPoints : 1;
  return t;
}

// The gather's shared memory: its tile's sums, and the most the SM can
// give, so that several blocks stay resident (CUDA's default
// carveout keeps more L1 and fits one).
template <typename K>
cudaError_t gather_attributes(K kernel, size_t shared) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// The int32 workspace the backward takes for n maps of h x w, c channels
// and k points a map: for a map cut into tiles, the counts of each (map,
// tile, block of points) and their scan, the scan blocks' offsets, 4
// ranks a point and the tiles' lists (a point in each tile it reaches);
// none for maps that are one tile.
extern "C" long long erd_point_sample_backward_workspace(int n, int c, int h,
                                                         int w, int k) {
  const Tiling t = tiling(n, c, h, w, k);
  if (!t.binned) return 0;
  const long long m = static_cast<long long>(n) * t.tiles * t.blocks + 1;
  const long long nb = (m + kScanBlock - 1) / kScanBlock;
  return m + nb + 8LL * n * k;
}

// grad (n, k, c) float32; points (n, k, 2) float32, n * k below 2^29; out
// (n, c, h, w) float32 or bf16 (is_bf16) with element strides sn, sc, sy,
// sx, every element written; work the int32 workspace of
// erd_point_sample_backward_workspace. One launch where a map is one tile;
// else four launches of binning and scans, and the gather. Returns
// cudaGetLastError() after the launches.
extern "C" int erd_point_sample_backward(const void* grad, const void* points,
                                         void* out, void* work, int n, int c,
                                         int h, int w, int k, long long sn,
                                         long long sc, long long sy,
                                         long long sx, int is_bf16,
                                         void* stream) {
  const long long n_points = static_cast<long long>(n) * k;
  if (static_cast<long long>(n) * h * w <= 0 || c <= 0 || k <= 0 ||
      n_points >= (1LL << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tiling t = tiling(n, c, h, w, k);
  const float* pts = static_cast<const float*>(points);
  int *hist = nullptr, *sums = nullptr, *list = nullptr;
  if (t.binned) {
    const long long m = static_cast<long long>(n) * t.tiles * t.blocks + 1;
    const long long nb = (m + kScanBlock - 1) / kScanBlock;
    hist = static_cast<int*>(work);
    sums = hist + m;
    int* ranks = sums + nb;
    list = ranks + 4 * n_points;
    // the counts: zero where the rank pass keeps them in hist, and the
    // last one (the lists' end) in any case
    cudaError_t err =
        t.tiles > kSharedTiles
            ? cudaMemsetAsync(hist, 0, m * sizeof(int), st)
            : cudaMemsetAsync(hist + m - 1, 0, sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    point_sample_rank_kernel<<<static_cast<unsigned>(n * t.blocks), 32, 0,
                               st>>>(pts, h, w, k, t.tiles, t.across,
                                     t.blocks, hist, ranks);
    point_sample_scan_kernel<<<static_cast<unsigned>(nb), 256, 0, st>>>(
        hist, m, sums);
    point_sample_scan_sums_kernel<<<1, 1024, 0, st>>>(sums,
                                                      static_cast<int>(nb));
    point_sample_scatter_kernel<<<static_cast<unsigned>(
                                      (n_points + 255) / 256),
                                  256, 0, st>>>(
        pts, h, w, k, t.tiles, t.across, t.blocks, n_points, hist, sums,
        ranks, list);
  }
  const size_t shared = (static_cast<size_t>(t.th) * t.tw + 1) * t.width * 4;
  const int threads = 32 * ((t.width + 31) / 32);  // a warp 32 channels
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(n) * t.tiles),
                  (c + kGatherChannels - 1) / kGatherChannels);
  const float* g = static_cast<const float*>(grad);
  cudaError_t err;
  if (is_bf16) {
    err = gather_attributes(point_sample_gather_kernel<__nv_bfloat16>,
                            shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    point_sample_gather_kernel<__nv_bfloat16><<<grid, threads, shared, st>>>(
        g, pts, hist, sums, list, c, h, w, k, t.th, t.tw, t.across, t.tiles,
        t.blocks, sn, sc, sy, sx, static_cast<__nv_bfloat16*>(out));
  } else {
    err = gather_attributes(point_sample_gather_kernel<float>, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    point_sample_gather_kernel<float><<<grid, threads, shared, st>>>(
        g, pts, hist, sums, list, c, h, w, k, t.th, t.tw, t.across, t.tiles,
        t.blocks, sn, sc, sy, sx, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
