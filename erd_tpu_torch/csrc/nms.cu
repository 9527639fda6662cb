// Greedy class-aware NMS keep mask, CrowdDet's set-NMS and nms_match's
// leader, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/nms.py `_suppress_matrix` + `_greedy_fixpoint`
// (reached through `nms_mask`, `batched_nms_mask`, `nms_select`), the
// leader pass of erd_tpu/ops/extra_nms.py `nms_match` (:84), and
// `set_nms_mask` (:107), the same recursion with
// sup[i, j] &= group[i] != group[j]: two boxes of one group (the two
// instances that one CrowdDet proposal predicts) never suppress each other.
// On the TPU
// the greedy recursion
//     alive[j] = valid[j] && !exists i < j: sup[i, j] && alive[i]
// was solved as a Jacobi fixpoint of (K)x(K, K) 0/1 products on the MXU over
// a dense bf16 suppression matrix. Here it is the bitmask form of the same
// recursion, in two launches per batch (two C entry points, so that each
// can be timed alone), and for nms_match a third that reads their words:
//   1. nms_mask_kernel (`erd_nms_mask`), a block of 64 threads per pair of
//      64-box tiles (row tile r, column tile c >= r) of the upper triangle
//      and image: the block stages the column tile's boxes, areas, groups
//      and their span (the least x1, y1 and the largest x2, y2) in shared
//      memory; thread t owns row i = 64 r + t and its 64-bit word for the
//      column tile: bit j set <=> j > i && valid[i] && iou(i, j) > thr,
//      and for set-NMS && group[i] != group[j] (a null `group` is plain
//      NMS). A row whose box misses the span skips the tile, and a pair
//      whose overlap is zero skips the division. The word is stored only
//      where it is nonzero, or on the diagonal; each warp's ballot of its
//      rows' nonzero words goes to nz[image][r][c], the bitmap of the rows
//      whose word for tile c is nonzero.
//   2. nms_reduce_kernel (`erd_nms_reduce`), one block of 4 warps per
//      image, walks the sorted rows a tile at a time. Warp 0 resolves the
//      tile against its diagonal words, held in registers, loaded a tile
//      ahead: it jumps from one live row with a nonzero diagonal word to
//      the next (the rows between have none and live if not removed),
//      taking the words by shuffles, and scatters the tile's keep bits to
//      the caller's original order through `order`. Then the block ORs,
//      into `removed`, the words of the live rows that nz marks nonzero,
//      thread w % 128 owning word w; nz's row for the next tile is on its
//      way into shared memory meanwhile (cp.async). Two barriers a tile.
//   3. nms_leader_kernel (`erd_nms_match_leader`), nms_match's leader
//      (erd_tpu/ops/extra_nms.py:84), after the two launches above, which
//      it reads: a block of 256 threads per column tile and image. The
//      greedy recursion makes the leader (the highest-scoring kept box j
//      with iou > thr, lowest index on ties) the suppressor:
//        - a valid box c that NMS removed takes the first kept row r < c
//          in the sorted order whose word has bit c set. The sort is
//          stable and descending, so a later candidate has a lower score,
//          or the same score and a higher index. The same holds for a
//          box the caller calls valid and scored -inf: it sorts after
//          every kept box;
//        - a kept box leads itself iff iou(i, i) > thr (zero area or thr
//          >= 1: none): no other kept box overlaps it above thr;
//        - a valid box scored NaN sorts first and has no bits: it takes
//          the long way, the first kept row in sorted order whose IoU
//          with it is above thr;
//        - a leader scored +inf gives -1 (erd_tpu's `isfinite(max)`), and
//          so does an invalid slot.
//      The block takes rows in groups of 2048 (8 a thread): the tile's nz
//      bits, the rows' original indices, their keep flags and, where nz
//      marks a word, the word itself, all in flight together; then the
//      first row of each column by prefix ORs across lanes, warps and
//      the 8 rows a thread, and stops when every column that needs a
//      leader has one. Leaders are written in the input order.
// The caller (erd_tpu_torch/ops/nms.py) does the stable descending sort, the
// gather and the class offset (set-NMS is class-agnostic). K and B are
// runtime arguments, any K >= 1 (the callers pass 2000 at predict and in
// CrowdDet's set-NMS, 4819 at the Faster R-CNN RPN's predict, 8819 at its
// training call at bs 16, 1024 and 4481 in the ERD distillation NMS at bs
// 16); the reduce's shared memory, 24 bytes a tile, takes K up to ~600,000.
//
// Exactness: the IoU is computed op for op as the reference does, every op
// rounded on its own (__fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, and
// the library is built with -fmad=false): area = max(x2-x1,0)*max(y2-y1,0),
// union = max((a_i + a_j) - ov, 1e-6), iou = ov / union, then a strict `>`.
// An FMA contraction of (a_i + a_j) - iw*ih would flip keep bits at the
// threshold. The shortcuts give the division's answer exactly:
//   - ov == 0: iou is +-0 (union >= 1e-6), so the bit is `0 > thr`;
//   - a row box that misses the tile's span (row x2 <= least column x1,
//     ...) has iw or ih 0 with every column, and the bit is 0 when
//     thr >= 0; the span is NaN where a coordinate is NaN (no skip), and
//     thr < 0 or NaN skips nothing;
//   - for 1e-30 <= thr, p = thr * union rounded: ov < p * 0.99999 (rounded)
//     implies ov / union < thr, so the rounded quotient is <= thr; ov >
//     p * 1.00001 implies a quotient above thr by 5e-6 of it, 40 ulps;
//     only the pairs between divide.
//
// Bound on this card: the work is K^2/2 IoUs (about 14 fp32 operations each)
// and the boxes read once: 0.13 ms at the RPN's training call (16 images at
// K = 8819), 0.0004 ms at K = 2000. The bitmask launch is bound by its
// instructions: most pairs are disjoint (the RPN's levels and the classes
// are offset apart), so most take the cheap path. The reduce is
// latency-bound: one image is a serial chain of K / 64 tiles, each a
// resolve and one round of dependent loads (the live rows' nonzero words),
// which the design keeps short. The leader's function is K x kept IoUs
// (0.00017 ms at K = 2000); its launch reads the words instead, a few
// rounds of dependent loads a block: latency-bound.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kReduceThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// min / max that give NaN when either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

// the (row tile, column tile) of upper-triangle entry p of a words x words
// grid of tiles, rows in order: row r starts at r * words - r (r - 1) / 2
__device__ __forceinline__ void tile_pair(long long p, int words, int& r,
                                          int& c) {
  const double w2 = 2.0 * words + 1.0;
  int row = static_cast<int>((w2 - sqrt(w2 * w2 - 8.0 * p)) * 0.5);
  auto start = [words](long long q) {
    return q * words - q * (q - 1) / 2;
  };
  row = max(0, min(row, words - 1));
  while (row > 0 && start(row) > p) --row;
  while (row + 1 < words && start(row + 1) <= p) ++row;
  r = row;
  c = row + static_cast<int>(p - start(row));
}

__global__ void __launch_bounds__(kTile)
    nms_mask_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    const int64_t* __restrict__ group, int k, int words,
                    float thr, unsigned long long* __restrict__ mask,
                    unsigned* __restrict__ nz) {
  int row_tile, col_tile;
  tile_pair(blockIdx.x, words, row_tile, col_tile);
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int row_start = row_tile * kTile;
  const int col_start = col_tile * kTile;
  const int rows = min(k - row_start, kTile);
  const int cols = min(k - col_start, kTile);
  const float4* bb = boxes + b * k;
  const int64_t* gb = group == nullptr ? nullptr : group + b * k;

  __shared__ float4 col_box[kTile];
  __shared__ float col_area[kTile];
  __shared__ int64_t col_group[kTile];
  __shared__ float4 span_part[kTile / 32];
  float4 lo_hi = make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
  if (tid < cols) {
    const float4 c = bb[col_start + tid];
    col_box[tid] = c;
    col_area[tid] = box_area(c);
    if (gb != nullptr) col_group[tid] = gb[col_start + tid];
    lo_hi = c;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo_hi.x = nan_min(lo_hi.x, __shfl_xor_sync(kFull, lo_hi.x, s));
    lo_hi.y = nan_min(lo_hi.y, __shfl_xor_sync(kFull, lo_hi.y, s));
    lo_hi.z = nan_max(lo_hi.z, __shfl_xor_sync(kFull, lo_hi.z, s));
    lo_hi.w = nan_max(lo_hi.w, __shfl_xor_sync(kFull, lo_hi.w, s));
  }
  if ((tid & 31) == 0) span_part[tid >> 5] = lo_hi;
  __syncthreads();
  const float4 s0 = span_part[0], s1 = span_part[1];
  const float4 span = make_float4(nan_min(s0.x, s1.x), nan_min(s0.y, s1.y),
                                  nan_max(s0.z, s1.z), nan_max(s0.w, s1.w));

  const bool zero_gt = 0.f > thr;  // the bit of a pair with no overlap
  const bool filter = thr >= 1e-30f;
  const int i = row_start + tid;
  unsigned long long bits = 0ULL;
  if (tid < rows && valid[b * k + i]) {
    const float4 r = bb[i];
    const bool misses = r.z <= span.x || r.x >= span.z || r.w <= span.y ||
                        r.y >= span.w;
    if (zero_gt || !misses) {
      const float ra = box_area(r);
      const int64_t rg = gb != nullptr ? gb[i] : 0;
      const int j0 = (row_tile == col_tile) ? tid + 1 : 0;
      for (int j = j0; j < cols; ++j) {
        const float4 c = col_box[j];
        const float iw =
            fmaxf(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 0.f);
        const float ih =
            fmaxf(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 0.f);
        const float ov = __fmul_rn(iw, ih);
        bool hit = zero_gt;
        if (ov != 0.f) {
          const float uni =
              fmaxf(__fsub_rn(__fadd_rn(ra, col_area[j]), ov), 1e-6f);
          const float p = __fmul_rn(thr, uni);
          if (filter && ov < __fmul_rn(p, 0.99999f)) {
            hit = false;
          } else if (filter && ov > __fmul_rn(p, 1.00001f)) {
            hit = true;
          } else {
            hit = __fdiv_rn(ov, uni) > thr;
          }
        }
        if (hit && (gb == nullptr || col_group[j] != rg)) bits |= 1ULL << j;
      }
    }
  }
  if (tid < rows && (bits != 0ULL || row_tile == col_tile))
    mask[(b * k + i) * words + col_tile] = bits;
  const unsigned ballot = __ballot_sync(kFull, bits != 0ULL);
  if ((tid & 31) == 0)
    nz[((b * words + row_tile) * words + col_tile) * 2 + (tid >> 5)] = ballot;
}

__global__ void __launch_bounds__(kReduceThreads)
    nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                      const unsigned long long* __restrict__ nz,
                      const uint8_t* __restrict__ valid,
                      const int64_t* __restrict__ order, int k, int words,
                      uint8_t* __restrict__ keep) {
  // shared: removed[words], then nz's rows of two tiles, nz_row[2][words]
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;
  unsigned long long* nz_row = smem + words;
  __shared__ unsigned long long live_bits;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned long long* mb = mask + b * k * words;
  const unsigned long long* zb = nz + b * words * words;
  const uint8_t* vb = valid + b * k;
  const int64_t* ob = order + b * k;
  uint8_t* kb = keep + b * k;
  for (int w = tid; w < words; w += kReduceThreads) removed[w] = 0ULL;
  // nz's row of tile t, words right of the diagonal, into buffer t & 1
  auto fetch_row = [&](int t) {
    if (t < words) {
      unsigned long long* dst = nz_row + (t & 1) * words;
      for (int w = t + 1 + tid; w < words; w += kReduceThreads)
        __pipeline_memcpy_async(dst + w, zb + static_cast<size_t>(t) * words
                                             + w, sizeof(unsigned long long));
    }
    __pipeline_commit();
  };
  // warp 0's registers for one tile: its rows' diagonal words, valid
  // flags and original indices, lanes holding rows lane and lane + 32
  unsigned long long d0 = 0, d1 = 0;
  int v0 = 0, v1 = 0;
  int64_t o0 = 0, o1 = 0;
  auto load_tile = [&](int t, unsigned long long& a0, unsigned long long& a1,
                       int& f0, int& f1, int64_t& p0, int64_t& p1) {
    const int row0 = t * kTile;
    const int rows = min(k - row0, kTile);
    a0 = a1 = 0ULL;
    f0 = f1 = 0;
    if (lane < rows) {
      a0 = mb[static_cast<size_t>(row0 + lane) * words + t];
      f0 = vb[row0 + lane];
      p0 = ob[row0 + lane];
    }
    if (lane + 32 < rows) {
      a1 = mb[static_cast<size_t>(row0 + lane + 32) * words + t];
      f1 = vb[row0 + lane + 32];
      p1 = ob[row0 + lane + 32];
    }
  };
  fetch_row(0);
  if (tid < 32) load_tile(0, d0, d1, v0, v1, o0, o1);
  __syncthreads();  // removed[] zeroed

  for (int t = 0; t < words; ++t) {
    const int row0 = t * kTile;
    const int rows = min(k - row0, kTile);
    fetch_row(t + 1);
    if (tid < 32) {
      unsigned long long n0 = 0, n1 = 0;
      int nv0 = 0, nv1 = 0;
      int64_t no0 = 0, no1 = 0;
      if (t + 1 < words) load_tile(t + 1, n0, n1, nv0, nv1, no0, no1);
      const unsigned long long vbits =
          static_cast<unsigned long long>(__ballot_sync(kFull, v0 != 0)) |
          (static_cast<unsigned long long>(__ballot_sync(kFull, v1 != 0))
           << 32);
      const unsigned long long nzd =
          static_cast<unsigned long long>(__ballot_sync(kFull, d0 != 0)) |
          (static_cast<unsigned long long>(__ballot_sync(kFull, d1 != 0))
           << 32);
      unsigned long long rem = removed[t];
      unsigned long long cand = vbits & ~rem;
      unsigned long long live = 0ULL;
      while (true) {
        const unsigned long long next = cand & nzd;
        if (next == 0ULL) {
          live |= cand;
          break;
        }
        const int p = __ffsll(static_cast<long long>(next)) - 1;
        const unsigned long long upto = p == 63 ? ~0ULL : (2ULL << p) - 1;
        live |= cand & upto;  // rows before p have no diagonal word
        rem |= __shfl_sync(kFull, p < 32 ? d0 : d1, p & 31);
        cand = vbits & ~rem & ~upto;
      }
      if (lane < rows) kb[o0] = (live >> lane) & 1ULL;
      if (lane + 32 < rows) kb[o1] = (live >> (lane + 32)) & 1ULL;
      if (lane == 0) live_bits = live;
      d0 = n0, d1 = n1, v0 = nv0, v1 = nv1, o0 = no0, o1 = no1;
    }
    __pipeline_wait_prior(1);  // this tile's nz row is in
    __syncthreads();
    const unsigned long long live = live_bits;
    if (live != 0ULL) {
      const unsigned long long* row_nz = nz_row + (t & 1) * words;
      for (int w = t + 1 + tid; w < words; w += kReduceThreads) {
        unsigned long long m = row_nz[w] & live;
        if (m == 0ULL) continue;
        unsigned long long acc = 0ULL;
        while (m != 0ULL) {
          unsigned long long v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[q] = 0ULL;
            if (m != 0ULL) {
              const int r = __ffsll(static_cast<long long>(m)) - 1;
              m &= m - 1;
              v[q] = mb[static_cast<size_t>(row0 + r) * words + w];
            }
          }
          acc |= v[0] | v[1] | v[2] | v[3];
        }
        removed[w] |= acc;
      }
    }
    __syncthreads();  // removed[t + 1] complete; this tile's buffer free
  }
}

constexpr int kLeaderThreads = 256;
constexpr int kLeaderWarps = kLeaderThreads / 32;
constexpr int kLeaderRows = 8;  // rows a thread in flight
constexpr int kSegments = kLeaderRows * kLeaderWarps;  // of 32 rows
constexpr int kSegmentsPerLane = kSegments / 32;
static_assert(kSegments % 32 == 0, "a warp scans the segments");
// a column's case
constexpr int kNone = 0, kSelf = 1, kWords = 2, kLongWay = 3;

// bbox_overlaps of one pair, op for op as the bitmask launch rounds it
__device__ __forceinline__ float pair_iou(float4 r, float4 c) {
  const float iw = fmaxf(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 0.f);
  const float ov = __fmul_rn(iw, ih);
  return __fdiv_rn(
      ov, fmaxf(__fsub_rn(__fadd_rn(box_area(r), box_area(c)), ov), 1e-6f));
}

__global__ void __launch_bounds__(kLeaderThreads)
    nms_leader_kernel(const unsigned long long* __restrict__ mask,
                      const unsigned long long* __restrict__ nz,
                      const int64_t* __restrict__ order,
                      const uint8_t* __restrict__ keep,
                      const float4* __restrict__ boxes,
                      const float* __restrict__ scores,
                      const uint8_t* __restrict__ valid, int k, int words,
                      float thr, int64_t* __restrict__ leader) {
  __shared__ int lead[kTile];  // a column's leader row (sorted), or -1
  __shared__ int kind[kTile];
  __shared__ unsigned long long seg_or[kSegments], seg_before[kSegments];
  __shared__ unsigned long long need_bits[2], assigned;
  const int col_tile = blockIdx.x;
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = col_tile * kTile;
  mask += b * k * static_cast<size_t>(words);
  nz += b * static_cast<size_t>(words) * words;
  order += b * k;
  keep += b * k;
  boxes += b * k;
  scores += b * k;
  if (valid != nullptr) valid += b * k;
  leader += b * k;
  // each column's case; a kept box's leader now
  if (tid < kTile) {
    const int c = col0 + tid;
    int what = kNone;
    if (c < k) {
      const int64_t o = order[c];
      const float s = scores[o];
      const bool v = valid == nullptr || valid[o] != 0;
      if (v && keep[o]) {
        what = kSelf;
        const float4 bo = boxes[o];
        leader[o] = (pair_iou(bo, bo) > thr && s != INFINITY) ? o : -1;
      } else if (v) {
        what = s != s ? kLongWay : kWords;
      } else {
        leader[o] = -1;
      }
    }
    kind[tid] = what;
    lead[tid] = -1;
    const unsigned ballot = __ballot_sync(kFull, what == kWords);
    if (lane == 0) need_bits[warp] = ballot;
  }
  if (tid == 0) assigned = 0ULL;
  const bool any_long = __syncthreads_or(tid < kTile && kind[tid] == kLongWay);
  const unsigned long long need = need_bits[0] | (need_bits[1] << 32);
  // rows in sorted order, up to the column tile's last: a column's first
  // kept row whose word has its bit
  const int row_end = min(k, col0 + kTile);
  for (int base = 0; base < row_end && (need & ~assigned) != 0ULL;
       base += kLeaderThreads * kLeaderRows) {
    int64_t o[kLeaderRows];
    bool marked[kLeaderRows];
    unsigned long long w[kLeaderRows];
#pragma unroll
    for (int u = 0; u < kLeaderRows; ++u) {
      const int r = base + u * kLeaderThreads + tid;
      marked[u] = false;
      o[u] = 0;
      if (r < row_end) {
        o[u] = order[r];
        marked[u] = (nz[static_cast<size_t>(r / kTile) * words + col_tile] >>
                     (r % kTile)) & 1ULL;
      }
    }
#pragma unroll
    for (int u = 0; u < kLeaderRows; ++u) {
      const int r = base + u * kLeaderThreads + tid;
      // the word where nz marks it (written only there), with the keep
      // flag in flight beside it
      w[u] = marked[u] ? mask[static_cast<size_t>(r) * words + col_tile]
                       : 0ULL;
      marked[u] = marked[u] && keep[o[u]] != 0;
    }
    // a row's new columns: its word less the words of the rows before it
    // in its 32-row segment (an OR scan across the lanes), then less those
    // of the segments before (an OR scan of the segments' totals)
    unsigned long long prior[kLeaderRows];
#pragma unroll
    for (int u = 0; u < kLeaderRows; ++u) {
      if (!marked[u]) w[u] = 0ULL;
      unsigned long long incl = w[u];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl |= y;
      }
      prior[u] = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) prior[u] = 0ULL;
      if (lane == 31) seg_or[u * kLeaderWarps + warp] = incl;
    }
    __syncthreads();
    if (warp == 0) {  // segments in row order (u, then warp), a lane's run
      unsigned long long v[kSegmentsPerLane], incl = 0ULL;
#pragma unroll
      for (int e = 0; e < kSegmentsPerLane; ++e) {
        v[e] = seg_or[lane * kSegmentsPerLane + e];
        incl |= v[e];
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl |= y;
      }
      unsigned long long before = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) before = 0ULL;
      before |= assigned;
#pragma unroll
      for (int e = 0; e < kSegmentsPerLane; ++e) {
        seg_before[lane * kSegmentsPerLane + e] = before;
        before |= v[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kLeaderRows; ++u) {
      unsigned long long first =
          w[u] & ~prior[u] & ~seg_before[u * kLeaderWarps + warp];
      const int r = base + u * kLeaderThreads + tid;
      while (first != 0ULL) {
        lead[__ffsll(static_cast<long long>(first)) - 1] = r;
        first &= first - 1;
      }
    }
    __syncthreads();
    if (tid == 0) assigned = seg_before[kSegments - 1] | seg_or[kSegments - 1];
    __syncthreads();
  }
  // a valid box scored NaN: the first kept row in sorted order whose IoU
  // with it is above thr, a warp a column (rare: the long way)
  if (any_long) {
    for (int t = warp; t < kTile; t += kLeaderWarps) {
      if (kind[t] != kLongWay) continue;
      const float4 bc = boxes[order[col0 + t]];
      for (int r0 = 0; r0 < k; r0 += 32) {
        const int r = r0 + lane;
        bool hit = false;
        if (r < k) {
          const int64_t o = order[r];
          hit = keep[o] != 0 && pair_iou(bc, boxes[o]) > thr;
        }
        const unsigned ballot = __ballot_sync(kFull, hit);
        if (ballot != 0u) {
          if (lane == 0) lead[t] = r0 + __ffs(ballot) - 1;
          break;
        }
      }
    }
    __syncthreads();
  }
  // the leaders of removed and NaN-scored boxes, in the input order
  if (tid < kTile) {
    const int c = col0 + tid;
    if (c < k && (kind[tid] == kWords || kind[tid] == kLongWay)) {
      const int r = lead[tid];
      int64_t out = -1;
      if (r >= 0) {
        const int64_t o = order[r];
        if (scores[o] != INFINITY) out = o;
      }
      leader[order[c]] = out;
    }
  }
}

}  // namespace

// Launch 1. boxes (B, K, 4) fp32 sorted and class-shifted; valid (B, K)
// uint8 sorted; group null (NMS) or (B, K) int64 sorted group ids
// (set-NMS); mask (B, K, ceil(K/64)) uint64 scratch, written where nonzero
// and on the diagonal; nz (B, ceil(K/64), ceil(K/64)) uint64 scratch, its
// upper triangle written. Returns cudaGetLastError() after the launch.
extern "C" int erd_nms_mask(const void* boxes, const void* valid,
                            const void* group, void* mask, void* nz,
                            int batch, int k, float thr, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int words = (k + kTile - 1) / kTile;
  const long long pairs = static_cast<long long>(words) * (words + 1) / 2;
  if (pairs > 0x7fffffffLL || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  nms_mask_kernel<<<dim3(static_cast<unsigned>(pairs), batch), kTile, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(group), k, words, thr,
      static_cast<unsigned long long*>(mask), static_cast<unsigned*>(nz));
  return static_cast<int>(cudaGetLastError());
}

// Launch 2, after erd_nms_mask on the same stream: mask and nz as it wrote
// them; valid as there; order (B, K) int64, order[b, i] = original index of
// sorted entry i; keep (B, K) uint8 out, original order. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue where K
// needs more shared memory than a block has.
extern "C" int erd_nms_reduce(const void* mask, const void* nz,
                              const void* valid, const void* order,
                              void* keep, int batch, int k, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int words = (k + kTile - 1) / kTile;
  const size_t smem = 3 * sizeof(unsigned long long) * words;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_reduce_kernel<<<batch, kReduceThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const unsigned long long*>(nz),
      static_cast<const uint8_t*>(valid), static_cast<const int64_t*>(order),
      k, words, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

// Launch 3 (nms_match), after erd_nms_mask and erd_nms_reduce on the same
// stream: mask, nz and order as they read them; keep (B, K) uint8 as the
// reduce wrote it (input order); boxes (B, K, 4) float32 and scores (B, K)
// float32 in the input order (unshifted, unmasked); valid null (all
// valid) or (B, K) uint8, input order; leader (B, K) int64 out, input
// order. Returns cudaGetLastError() after the launch.
extern "C" int erd_nms_match_leader(const void* mask, const void* nz,
                                    const void* order, const void* keep,
                                    const void* boxes, const void* scores,
                                    const void* valid, void* leader,
                                    int batch, int k, float thr,
                                    void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (k + kTile - 1) / kTile;
  nms_leader_kernel<<<dim3(words, batch), kLeaderThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const unsigned long long*>(nz),
      static_cast<const int64_t*>(order), static_cast<const uint8_t*>(keep),
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), k, words, thr,
      static_cast<int64_t*>(leader));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
