// Bilinear point sampling, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/sampling.py `point_sample` (align_corners=False)
// with `_grid_sample_bilinear`, as erd_tpu/models/detectors/point_rend.py
// calls it: the coarse call samples each RoI's (14, 14, C) logit map at its
// own points, the fine call one image's P2 map at the points of all its
// RoIs. On the TPU both were gathers of four clipped corners times 0/1
// validity masks; here each point reads only its four corners.
//
// Thread layout: one warp per point (n, k). Every lane forms the point's
// coordinates and its four bilinear weights once, then loops over the
// channels lane, lane + 32, ..., so a warp writes 32 neighbouring output
// floats of the (N, K, C) row at a time. The map is read through its four
// element strides (NCHW or channels-last memory alike); bf16 maps are
// widened in registers, which gives erd_tpu's astype(float32) values.
// A corner off the map reads 0 (zero padding per corner, as the reference's
// validity mask). The sum is the plain version's: v00*(1-wy)*(1-wx) +
// v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx, left to right, each op rounded
// on its own (the library is built with -fmad=false), so kernel and plain
// version agree to the bit.
//
// Bound on this card: bytes. Each output float must be written (20.1 MB
// for the fine call's 19600 points x 256 channels) and each map row under
// the points read (at most the 34.4 MB of a bf16 800x1344 P2); the ~12
// flops per sample are far below the float32 peak. Points of one RoI are
// neighbours on the map, so their corners mostly come from L2.
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

}  // namespace

// maps (n, c, h, w) float32 or bf16 (is_bf16) with element strides sn, sc,
// sy, sx; points (n, k, 2) float32 (x, y) in [0, 1]; out (n, k, c) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int erd_point_sample(const void* maps, const void* points,
                                void* out, int n, int c, int h, int w, int k,
                                long long sn, long long sc, long long sy,
                                long long sx, int is_bf16, void* stream) {
  const long long n_points = static_cast<long long>(n) * k;
  if (n_points <= 0 || c <= 0) return 0;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;  // 8 points a block
  const unsigned blocks =
      static_cast<unsigned>((n_points * 32 + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pts = static_cast<const float*>(points);
  float* o = static_cast<float*>(out);
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
