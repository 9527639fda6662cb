// Matrix NMS (score decay) and fast NMS, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/extra_nms.py `matrix_nms` (:17) and `fast_nms`
// (:44), and the inline mask-IoU decay of SOLOv2's decode
// (erd_tpu/models/detectors/solov2.py:399-410). On the TPU each was one
// dense (N, N) matrix expression that XLA fused: where, max / min over an
// axis, exp. Here each is a pass over the pairs whose entries are
// computed where they are used, never stored, but for the precomputed
// mask IoU of SOLOv2, which is read; fast NMS visits only the pairs of a
// class.
//
// 1. Matrix decay, two launches (`erd_matrix_decay`), one block per row i
//    of one image, grid (N, B), the block's threads striding over j:
//      decay_iou[i, j] = same(i, j) && s_j > s_i ? iou(i, j) : 0
//      comp[i]  = max_j decay_iou[i, j]                     (launch 1)
//      out[i]   = s_i * min_j f(decay_iou[i, j], comp[j])   (launch 2)
//    with f = exp(-sigma * (d * d - c * c)) (gaussian) or (1 - d) /
//    max(1 - c, 1e-6) (linear). iou(i, j) is read from a precomputed (B, N,
//    N) matrix (SOLOv2's mask IoU), or computed from boxes as erd_tpu's
//    matrix_nms has it, bbox_overlaps(boxes, boxes)[j, i]. A max and a min
//    pick one of their inputs, so the order of the block's reduction does
//    not matter: each term is rounded as the plain version rounds it (the
//    library is built with -fmad=false, and every op here is an explicitly
//    rounded intrinsic), and the result differs from it only where the
//    device's expf and the host's exp differ (an ulp).
//    Ties: s_j > s_i is strict, so equal scores never decay each other (in
//    SOLOv2 most of the 500 slots carry score 0).
// 2. Fast NMS (`erd_fast_nms`), one launch from the op's own inputs: no
//    sort, no gather. Box j stays unless a live box i of its class that
//    comes earlier in the stable descending score order overlaps it above
//    the threshold. "Earlier" is computed in the kernel as torch.sort(-s,
//    stable=True) and jnp.argsort(-s) order: a larger score first, equal
//    scores (-0 and +0 included) by index. Live means valid, scored
//    neither NaN nor -inf: the sort puts the others after every live box,
//    so they precede no live box and are never kept. An image takes `per`
//    blocks (from K, on the host); each block buckets the image's live
//    boxes by a hash of their int64 (or int32) labels in shared memory (a
//    counting sort: a warp whose live boxes share a bucket takes one
//    integer atomic, any other warp one a lane), then owns a range of the
//    columns by index, a warp a column: the lanes walk the column's
//    bucket 64 members at a time (2 a lane, loads in flight together) and
//    stop at the first member that suppresses it (a NaN IoU counts, as
//    erd_tpu's max propagates NaN). Labels are compared exactly, so a
//    bucket collision costs work, never correctness. The members' boxes,
//    scores and labels are read in place (L1 / L2); keep is written in
//    the input order.
// 3. nms_match's leader: in csrc/nms.cu (`erd_nms_match_leader`), read
//    from row 1's suppression words.
//
// 4. SOLOv2's mask-IoU decay fused with its IoU (`erd_mask_matrix_decay`,
//    one launch): from inter (B, N, N), the binarised masks' pixel
//    overlaps, and area (B, N), their pixel counts, as
//    erd_tpu/models/detectors/solov2.py:400-410 has them,
//      miou[i, j] = inter[i, j] / max((area_i + area_j) - inter[i, j], 1)
//    op for op (the four elementwise launches that made miou before the
//    decay are gone), then the decay of 1. A cooperative launch: an image
//    takes `per` blocks on as many SMs, a warp a row, the lanes over j,
//    the row of inter read coalesced (the GEMM that made it leaves it in
//    L2), kChunk entries a lane in flight before any is used. Pass 1
//    writes each row's comp to a (B, N) scratch; one grid-wide barrier;
//    each block reads its image's comps into shared memory, and pass 2
//    takes each row's decay. Where a warp has one row and the row fits
//    one chunk (SOLOv2's N = 500), the row's decay_iou stays in registers
//    over the barrier: pass 2 neither reloads nor divides. The gaussian's
//    exp falls as x = d^2 - c^2 grows (sigma >= 0), so a row takes the
//    largest x of its terms and one exp (the min of the terms' exps up
//    to an ulp of expf); the linear decay takes each term's division.
//    (A design with an image a cluster of 8 blocks, the comps exchanged
//    through distributed shared memory, was bound by its 8 SMs'
//    instruction rate: 0.018 ms at SOLOv2's call against 0.0085 for this
//    one.)
//    The skipped work is exact (pinned by tests against plain):
//      - a term whose condition fails (another class, or s_j <= s_i) has
//        decay_iou 0, f(0, c) >= 1 (c in [0, 1], sigma >= 0), and a slot
//        of the largest score has comp 0, so its term is f(d, 0) <= 1:
//        the min over j is min(1, min over the terms whose condition
//        holds). Pass 2 starts at 1 and takes those terms only;
//      - a zero score gives s_i * decay = s_i (decay in (0, 1] or 0: a
//        signed zero either way), and such a row is no higher than any
//        nonnegative row, so its comp is never read: rows with s_i == 0
//        skip both passes.
//    Where any score is negative or NaN, or sigma < 0, every row and term
//    is computed as in 1. Masks give 0 <= inter[i, j] <= min(area_i,
//    area_j), hence miou in [0, 1].
//
// IoU: op for op as erd_tpu's bbox_overlaps, each op rounded on its own:
// area = max(x2 - x1, 0) * max(y2 - y1, 0), ov = max(min(x2) - max(x1), 0)
// * max(min(y2) - max(y1), 0), iou = ov / max((a_1 + a_2) - ov, 1e-6).
// The sum a_1 + a_2 commutes exactly, so iou(i, j) == iou(j, i) bitwise.
//
// Bound on this card: operations. A matrix-decay call does N^2 pair terms
// (an IoU of ~14 float32 operations where computed, plus an exp or a
// division): at N = 500 (SOLOv2's nms_pre) about 10 MFLOP, at N = 2000
// about 60 MFLOP, 0.15-1 microsecond at 67 TFLOP/s; the bytes are a few KB
// (boxes) or 1 MB (a 500 x 500 IoU). Fast NMS needs the same-class pairs
// alone (~20,000 at K = 2000 over 80 classes: bytes-bound, 0.00002 ms).
// Every launch is far below a launch's own cost, so the launches bound
// these kernels in practice; the design keeps them to two (matrix decay)
// or one (the others) per call, whatever the batch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// bbox_overlaps(b1, b2) of one pair, b1's and b2's areas given
__device__ __forceinline__ float pair_iou(float4 a, float area_a, float4 c,
                                          float area_c) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.f);
  const float ov = __fmul_rn(iw, ih);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_c), ov), 1e-6f);
  return __fdiv_rn(ov, uni);
}

// block-wide max (take_max) or min of one value per thread; every thread
// gets the result
__device__ float block_reduce(float v, bool take_max) {
  __shared__ float part[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = take_max ? fmaxf(v, o) : fminf(v, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = part[0];
  for (int w = 1; w < kThreads / 32; ++w)
    v = take_max ? fmaxf(v, part[w]) : fminf(v, part[w]);
  __syncthreads();  // part[] may be reused by the caller's next reduction
  return v;
}

// decay_iou[i, j] of row i (scores s, labels lab, of one image)
__device__ __forceinline__ float decay_iou(const float* __restrict__ iou,
                                           const float4* __restrict__ boxes,
                                           const float* __restrict__ s,
                                           const int64_t* __restrict__ lab,
                                           int n, int i, int j, float si,
                                           int64_t li, float4 bi,
                                           float area_i) {
  if (lab[j] != li || !(s[j] > si)) return 0.f;
  if (iou != nullptr) return iou[static_cast<size_t>(i) * n + j];
  const float4 bj = boxes[j];
  return pair_iou(bj, box_area(bj), bi, area_i);  // iou.T[i, j]
}

__global__ void matrix_comp_kernel(const float* __restrict__ scores,
                                   const float* __restrict__ iou,
                                   const float4* __restrict__ boxes,
                                   const int64_t* __restrict__ labels, int n,
                                   float* __restrict__ comp) {
  const int i = blockIdx.x;
  const size_t b = blockIdx.y;
  const float* s = scores + b * n;
  const int64_t* lab = labels + b * n;
  const float* m = iou == nullptr ? nullptr : iou + b * n * n;
  const float4* bx = boxes == nullptr ? nullptr : boxes + b * n;
  const float si = s[i];
  const int64_t li = lab[i];
  const float4 bi = bx == nullptr ? make_float4(0, 0, 0, 0) : bx[i];
  const float area_i = bx == nullptr ? 0.f : box_area(bi);
  float best = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    best = fmaxf(best, decay_iou(m, bx, s, lab, n, i, j, si, li, bi, area_i));
  best = block_reduce(best, true);
  if (threadIdx.x == 0) comp[b * n + i] = best;
}

__global__ void matrix_decay_kernel(const float* __restrict__ scores,
                                    const float* __restrict__ iou,
                                    const float4* __restrict__ boxes,
                                    const int64_t* __restrict__ labels, int n,
                                    const float* __restrict__ comp,
                                    float neg_sigma, int linear,
                                    float* __restrict__ out) {
  const int i = blockIdx.x;
  const size_t b = blockIdx.y;
  const float* s = scores + b * n;
  const int64_t* lab = labels + b * n;
  const float* c = comp + b * n;
  const float* m = iou == nullptr ? nullptr : iou + b * n * n;
  const float4* bx = boxes == nullptr ? nullptr : boxes + b * n;
  const float si = s[i];
  const int64_t li = lab[i];
  const float4 bi = bx == nullptr ? make_float4(0, 0, 0, 0) : bx[i];
  const float area_i = bx == nullptr ? 0.f : box_area(bi);
  float low = INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float d = decay_iou(m, bx, s, lab, n, i, j, si, li, bi, area_i);
    const float cj = c[j];
    float f;
    if (linear) {
      f = __fdiv_rn(__fsub_rn(1.f, d), fmaxf(__fsub_rn(1.f, cj), 1e-6f));
    } else {
      f = expf(__fmul_rn(neg_sigma,
                         __fsub_rn(__fmul_rn(d, d), __fmul_rn(cj, cj))));
    }
    low = fminf(low, f);
  }
  low = block_reduce(low, false);
  if (threadIdx.x == 0) out[b * n + i] = __fmul_rn(si, low);
}

constexpr int kDecayThreads = 256;
constexpr int kDecayWarps = kDecayThreads / 32;
constexpr int kChunk = 16;  // row entries a lane has in flight

// the mask IoU of (i, j): inter / max((area_i + area_j) - inter, 1)
__device__ __forceinline__ float mask_iou(float inter, float area_i,
                                          float area_j) {
  return __fdiv_rn(inter,
                   fmaxf(__fsub_rn(__fadd_rn(area_i, area_j), inter), 1.f));
}

// a lane's kChunk entries of a row, 32 apart from j0, loaded before any
// is used (all in flight; 0 past the row's end)
__device__ __forceinline__ void load_chunk(const float* __restrict__ row,
                                           int j0, int n, float* v) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int j = j0 + 32 * u;
    v[u] = j < n ? __ldg(row + j) : 0.f;
  }
}

// row i's comp: the max over its terms (j of i's class with a strictly
// higher score) of the mask IoU, 0 where it has none; every lane gets it
__device__ __forceinline__ float row_comp(const float* __restrict__ row,
                                          const int64_t* lab, const float* s,
                                          const float* ar, int n, int i,
                                          int lane) {
  const float si = s[i], ai = ar[i];
  const int64_t li = lab[i];
  float best = 0.f;
  for (int j0 = lane; j0 < n; j0 += 32 * kChunk) {
    float v[kChunk];
    load_chunk(row, j0, n, v);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int j = j0 + 32 * u;
      if (j < n && lab[j] == li && s[j] > si)
        best = fmaxf(best, mask_iou(v[u], ai, ar[j]));
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
  return best;
}

// a warp's row decay from its lanes' partial min (linear) or extreme x
// (gaussian): the gaussian's one exp, then the min over the lanes
__device__ __forceinline__ float finish_low(float low, float x, bool grows,
                                            float neg_sigma, int linear) {
  if (!linear) {
    for (int o = 16; o > 0; o >>= 1) {
      const float t = __shfl_xor_sync(0xffffffffu, x, o);
      x = grows ? fmaxf(x, t) : fminf(x, t);
    }
    if (x != (grows ? -INFINITY : INFINITY))  // a term was taken
      low = fminf(low, expf(__fmul_rn(neg_sigma, x)));
  }
  for (int o = 16; o > 0; o >>= 1)
    low = fminf(low, __shfl_xor_sync(0xffffffffu, low, o));
  return low;
}

// row i's decay, the min over j of f(decay_iou[i, j], comp[j]); sparse:
// min(1, the min over its terms). The gaussian's exp falls as x = d^2 -
// c^2 grows (sigma >= 0), so a row takes the largest x of its terms and
// one exp (the smallest where sigma < 0): the min of the terms' exps up
// to an ulp of expf. The linear decay takes each term's division.
__device__ __forceinline__ float row_decay(const float* __restrict__ row,
                                           const int64_t* lab, const float* s,
                                           const float* ar, const float* comp,
                                           int n, int i, int lane, bool sparse,
                                           float neg_sigma, int linear) {
  const float si = s[i], ai = ar[i];
  const int64_t li = lab[i];
  const bool grows = neg_sigma <= 0.f;
  float low = sparse ? 1.f : INFINITY;
  float x = grows ? -INFINITY : INFINITY;  // the gaussian's extreme
  for (int j0 = lane; j0 < n; j0 += 32 * kChunk) {
    float v[kChunk];
    load_chunk(row, j0, n, v);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int j = j0 + 32 * u;
      if (j >= n) continue;
      const bool on = lab[j] == li && s[j] > si;
      if (!on && sparse) continue;
      const float d = on ? mask_iou(v[u], ai, ar[j]) : 0.f;
      const float c = comp[j];
      if (linear) {
        low = fminf(low, __fdiv_rn(__fsub_rn(1.f, d),
                                   fmaxf(__fsub_rn(1.f, c), 1e-6f)));
      } else {
        const float t = __fsub_rn(__fmul_rn(d, d), __fmul_rn(c, c));
        x = grows ? fmaxf(x, t) : fminf(x, t);
      }
    }
  }
  return finish_low(low, x, grows, neg_sigma, linear);
}

// one image's scores, labels and areas into shared memory; true where the
// skipped work is exact (every score >= 0, sigma >= 0 or linear)
__device__ __forceinline__ bool stage_image(const float* __restrict__ sc,
                                            const int64_t* __restrict__ lb,
                                            const float* __restrict__ ara,
                                            int n, float neg_sigma,
                                            int linear, int64_t* lab,
                                            float* s, float* ar) {
  bool odd = neg_sigma > 0.f && !linear;  // sigma < 0
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float v = sc[j];
    s[j] = v;
    lab[j] = lb[j];
    ar[j] = ara[j];
    odd |= !(v >= 0.f);
  }
  return !__syncthreads_or(odd);
}

__global__ void __launch_bounds__(kDecayThreads)
mask_matrix_decay_kernel(const float* __restrict__ scores,
                         const float* __restrict__ inter,
                         const float* __restrict__ area,
                         const int64_t* __restrict__ labels, int n, int per,
                         float neg_sigma, int linear, float* comps,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* lab = reinterpret_cast<int64_t*>(smem);
  float* s = reinterpret_cast<float*>(lab + n);
  float* ar = s + n;
  float* comp = ar + n;
  const size_t img = blockIdx.x / per;
  const int part = static_cast<int>(blockIdx.x % per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* m = inter + img * n * static_cast<size_t>(n);
  const int first = part * kDecayWarps + warp, step = per * kDecayWarps;
  // a warp one row and a row one chunk (SOLOv2's N = 500): the row is
  // loaded before the image is staged (the two reads overlap), its
  // decay_iou stays in registers over the barrier (-1 marks a term
  // skipped), and pass 2 neither reloads nor divides
  const bool held = step >= n && n <= 32 * kChunk;
  float d[kChunk];
  if (held && first < n)
    load_chunk(m + static_cast<size_t>(first) * n, lane, n, d);
  // sparse: rows scored 0 skipped, terms whose condition fails skipped
  const bool sparse = stage_image(scores + img * n, labels + img * n,
                                  area + img * n, n, neg_sigma, linear, lab,
                                  s, ar);
  if (held) {
    const int i = first;
    float best = 0.f;
    if (i < n && (!sparse || s[i] != 0.f)) {
      const float si = s[i], ai = ar[i];
      const int64_t li = lab[i];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = lane + 32 * u;
        const bool on = j < n && lab[j] == li && s[j] > si;
        d[u] = on ? mask_iou(d[u], ai, ar[j]) : (sparse || j >= n ? -1.f
                                                                   : 0.f);
        best = fmaxf(best, d[u]);
      }
      for (int o = 16; o > 0; o >>= 1)
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
    }
    if (i < n && lane == 0) comps[img * n + i] = best;
  } else {
    for (int i = first; i < n; i += step) {
      const bool live = !sparse || s[i] != 0.f;
      const float best = live ? row_comp(m + static_cast<size_t>(i) * n, lab,
                                         s, ar, n, i, lane) : 0.f;
      if (lane == 0) comps[img * n + i] = best;
    }
  }
  cg::this_grid().sync();  // every image's comps are written
  for (int j = tid; j < n; j += kDecayThreads)
    comp[j] = __ldcg(comps + img * n + j);
  __syncthreads();
  if (held) {
    const int i = first;
    if (i >= n) return;
    float low = sparse ? 1.f : INFINITY;
    if (!sparse || s[i] != 0.f) {
      const bool grows = neg_sigma <= 0.f;
      float x = grows ? -INFINITY : INFINITY;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {  // branch-free: a skipped term
        const int j = lane + 32 * u;      // gives the extreme's identity
        const bool skip = d[u] < 0.f;
        const float c = comp[j < n ? j : 0];
        if (linear) {
          const float f = __fdiv_rn(__fsub_rn(1.f, d[u]),
                                    fmaxf(__fsub_rn(1.f, c), 1e-6f));
          low = fminf(low, skip ? INFINITY : f);
        } else {
          const float t = __fsub_rn(__fmul_rn(d[u], d[u]), __fmul_rn(c, c));
          const float none = grows ? -INFINITY : INFINITY;
          x = grows ? fmaxf(x, skip ? none : t) : fminf(x, skip ? none : t);
        }
      }
      low = finish_low(low, x, grows, neg_sigma, linear);
    }
    if (lane == 0) out[img * n + i] = __fmul_rn(s[i], low);
    return;
  }
  for (int i = first; i < n; i += step) {
    const bool live = !sparse || s[i] != 0.f;
    const float low = live ? row_decay(m + static_cast<size_t>(i) * n, lab,
                                       s, ar, comp, n, i, lane, sparse,
                                       neg_sigma, linear) : 1.f;
    if (lane == 0) out[img * n + i] = __fmul_rn(s[i], low);
  }
}

// ---------------------------------------------------------------- fast NMS
constexpr int kFastThreads = 512;
constexpr int kFastWarps = kFastThreads / 32;
constexpr int kBuckets = 1024;
constexpr int kFastStage = 8;        // a lane's boxes in flight in pass 1
constexpr int kFastWalk = 2;         // a lane's bucket members in flight
constexpr int kFastColsPerWarp = 1;  // the plan's columns a warp
constexpr unsigned kAll = 0xffffffffu;

// a label's bucket: the identity on 0..1023 (class indices never collide),
// the high bits folded in for any other int64
__device__ __forceinline__ int label_bucket(int64_t label) {
  uint64_t x = static_cast<uint64_t>(label);
  x ^= x >> 32;
  x ^= x >> 16;
  return static_cast<int>((x ^ (x >> 10)) & (kBuckets - 1));
}

// exclusive prefix sum of one value a thread over the block; every thread
// gets the block's total
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums,
                                                   int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kFastWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kFastWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  total = warp_sums[kFastWarps - 1];
  return (warp == 0 ? 0 : warp_sums[warp - 1]) + x - v;
}

// shared memory, all of it dynamic (the kernel has no static shared
// memory, so this is all a block takes): start[kBuckets + 1] (bucket h's
// members at [start[h], start[h + 1])), cursor[kBuckets],
// warp_sums[kFastWarps], members[n] (the live boxes, bucket by bucket),
// bucket[n] (a box's bucket, kBuckets where it is not live); mirrored by
// ops/extra_nms.py fast_nms_smem
constexpr size_t fast_nms_smem(int n) {
  return sizeof(int) * (2 * kBuckets + 1 + kFastWarps) + sizeof(int) * n +
         sizeof(uint16_t) * n;
}
constexpr size_t kMaxBlockShared = 232448;  // an H100 block's opt-in

template <typename L>
__global__ void __launch_bounds__(kFastThreads)
    fast_nms_kernel(const float4* __restrict__ boxes,
                    const float* __restrict__ scores,
                    const L* __restrict__ labels,
                    const uint8_t* __restrict__ valid, int n, int per,
                    float thr, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) int fsm[];
  int* start = fsm;
  int* cursor = start + kBuckets + 1;
  int* warp_sums = cursor + kBuckets;
  int* members = warp_sums + kFastWarps;
  uint16_t* bucket = reinterpret_cast<uint16_t*>(members + n);
  const size_t img = blockIdx.x / per;
  const int part = static_cast<int>(blockIdx.x % per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  boxes += img * n;
  scores += img * n;
  labels += img * n;
  if (valid != nullptr) valid += img * n;
  keep += img * n;
  for (int h = tid; h < kBuckets; h += kFastThreads) cursor[h] = 0;
  __syncthreads();
  // pass 1: each box's bucket, counted
  for (int base = warp * 32; base < n; base += kFastThreads * kFastStage) {
    float s[kFastStage];
    int64_t lab[kFastStage];
    bool on[kFastStage];
#pragma unroll
    for (int u = 0; u < kFastStage; ++u) {
      const int i = base + u * kFastThreads + lane;
      on[u] = i < n && (valid == nullptr || valid[i] != 0);
      s[u] = i < n ? scores[i] : 0.f;
      lab[u] = i < n ? static_cast<int64_t>(labels[i]) : 0;
    }
#pragma unroll
    for (int u = 0; u < kFastStage; ++u) {
      const int i = base + u * kFastThreads + lane;
      const bool live = on[u] && s[u] == s[u] && s[u] != -INFINITY;
      const int h = live ? label_bucket(lab[u]) : kBuckets;
      if (i < n) bucket[i] = static_cast<uint16_t>(h);
      const unsigned on_b = __ballot_sync(kAll, h < kBuckets);
      if (on_b == 0u) continue;
      const int first = __ffs(on_b) - 1;
      const int hf = __shfl_sync(kAll, h, first);
      if (__all_sync(kAll, h == hf || h == kBuckets)) {
        if (lane == first) atomicAdd(&cursor[hf], __popc(on_b));
      } else if (h < kBuckets) {
        atomicAdd(&cursor[h], 1);
      }
    }
  }
  __syncthreads();
  // the buckets' starts: an exclusive sum of their counts
  constexpr int kPer = kBuckets / kFastThreads;
  int counts[kPer], sum = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    counts[u] = cursor[tid * kPer + u];
    sum += counts[u];
  }
  int live_n;
  int at = block_exclusive_sum(sum, warp_sums, live_n);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    start[tid * kPer + u] = at;
    cursor[tid * kPer + u] = at;
    at += counts[u];
  }
  if (tid == 0) start[kBuckets] = live_n;
  __syncthreads();
  // pass 2: the live boxes into their buckets (in an order that the
  // atomics pick, another in each block: only a bucket's set is read)
  for (int base = warp * 32; base < n; base += kFastThreads) {
    const int i = base + lane;
    const int h = i < n ? bucket[i] : kBuckets;
    const unsigned on_b = __ballot_sync(kAll, h < kBuckets);
    if (on_b == 0u) continue;
    const int first = __ffs(on_b) - 1;
    const int hf = __shfl_sync(kAll, h, first);
    int pos = 0;
    if (__all_sync(kAll, h == hf || h == kBuckets)) {
      if (lane == first) pos = atomicAdd(&cursor[hf], __popc(on_b));
      pos = __shfl_sync(kAll, pos, first) +
            __popc(on_b & ((1u << lane) - 1u));
    } else if (h < kBuckets) {
      pos = atomicAdd(&cursor[h], 1);
    }
    if (h < kBuckets) members[pos] = i;
  }
  __syncthreads();
  // the block's share of the columns, a range of indices, a warp a
  // column: a live j stays unless an earlier live box of its class
  // overlaps it above thr (keep iff max(0, those IoUs) <= thr: nothing is
  // kept where 0 > thr); a box that is not live is never kept
  const int j0 = static_cast<int>(static_cast<long long>(n) * part / per);
  const int j1 = static_cast<int>(static_cast<long long>(n) * (part + 1) /
                                  per);
  const bool open = 0.f <= thr;
  for (int j = j0 + warp; j < j1; j += kFastWarps) {
    const int h = bucket[j];
    if (h == kBuckets) {
      if (lane == 0) keep[j] = 0;
      continue;
    }
    const float4 bj = boxes[j];
    const float area_j = box_area(bj);
    const float sj = scores[j];
    const int64_t lj = static_cast<int64_t>(labels[j]);
    const int end = start[h + 1];
    bool hit = !open;
    for (int p0 = start[h]; p0 < end && !hit; p0 += 32 * kFastWalk) {
      // kFastWalk members a lane, their loads all in flight together
      int i[kFastWalk];
      float si[kFastWalk];
      int64_t li[kFastWalk];
      float4 bi[kFastWalk];
#pragma unroll
      for (int u = 0; u < kFastWalk; ++u) {
        const int p = p0 + 32 * u + lane;
        i[u] = p < end ? members[p] : j;  // j itself never suppresses j
      }
#pragma unroll
      for (int u = 0; u < kFastWalk; ++u) {
        si[u] = scores[i[u]];
        li[u] = static_cast<int64_t>(labels[i[u]]);
        bi[u] = boxes[i[u]];
      }
      bool mine = false;
#pragma unroll
      for (int u = 0; u < kFastWalk; ++u) {
        if ((si[u] > sj || (si[u] == sj && i[u] < j)) && li[u] == lj)
          mine |= !(pair_iou(bi[u], box_area(bi[u]), bj, area_j) <= thr);
      }
      hit = __any_sync(kAll, mine);
    }
    if (lane == 0) keep[j] = hit ? 0 : 1;
  }
}

}  // namespace

// scores (B, N) float32 (invalid slots already 0); iou null or (B, N, N)
// float32; boxes null or (B, N, 4) float32 (exactly one of the two);
// labels (B, N) int64; comp (B, N) float32 scratch; out (B, N) float32.
// Two launches; returns cudaGetLastError() after each.
extern "C" int erd_matrix_decay(const void* scores, const void* iou,
                                const void* boxes, const void* labels,
                                void* comp, void* out, int batch, int n,
                                float sigma, int linear, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n, batch);
  matrix_comp_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(scores), static_cast<const float*>(iou),
      static_cast<const float4*>(boxes), static_cast<const int64_t*>(labels),
      n, static_cast<float*>(comp));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  matrix_decay_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(scores), static_cast<const float*>(iou),
      static_cast<const float4*>(boxes), static_cast<const int64_t*>(labels),
      n, static_cast<const float*>(comp), -sigma, linear,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// SOLOv2's fused decay: scores (B, N) float32; inter (B, N, N) float32;
// area (B, N) float32; labels (B, N) int64; comps (B, N) float32 scratch;
// out (B, N) float32. One cooperative launch (an image `per` blocks, all
// resident); returns cudaGetLastError() after it, or
// cudaErrorCooperativeLaunchTooLarge where the batch's images cannot be
// resident together.
extern "C" int erd_mask_matrix_decay(const void* scores, const void* inter,
                                     const void* area, const void* labels,
                                     void* comps, void* out, int batch, int n,
                                     float sigma, int linear, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const long long smem = 20LL * n;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // above the default limit of dynamic memory
    err = cudaFuncSetAttribute(mask_matrix_decay_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the blocks the card holds at once (the last query's answer kept: it
  // depends on the device and the shared memory alone)
  static int known_dev = -1, resident = 0;
  static long long known_smem = -1;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != known_dev || smem != known_smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mask_matrix_decay_kernel, kDecayThreads,
          static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    known_dev = dev;
    known_smem = smem;
    resident = per_sm * sms;
  }
  if (batch > resident)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // a warp a row where the card holds that many blocks
  const int per = max(1, min((n + kDecayWarps - 1) / kDecayWarps,
                             resident / batch));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * per));
  cfg.blockDim = dim3(kDecayThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, mask_matrix_decay_kernel, static_cast<const float*>(scores),
      static_cast<const float*>(inter), static_cast<const float*>(area),
      static_cast<const int64_t*>(labels), n, per, -sigma, linear,
      static_cast<float*>(comps), static_cast<float*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the multiprocessors of the current device (the last answer kept: it
// depends on the device alone)
static int sm_count(int* sms) {
  static int known_dev = -1, known_sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != known_dev) {
    err = cudaDeviceGetAttribute(&known_sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    known_dev = dev;
  }
  *sms = known_sms;
  return 0;
}

// boxes (B, N, 4) float32, scores (B, N) float32, labels (B, N) int64
// (wide_labels 1) or int32 (0), valid null (all valid) or (B, N) uint8, all
// in the input order; keep (B, N) uint8 out, input order. One launch (an
// image `per` blocks); returns cudaGetLastError() after it, or
// cudaErrorInvalidValue where an image's buckets, warp sums, members and
// boxes' buckets exceed a block's 227 KB of shared memory (N > 37,364).
extern "C" int erd_fast_nms(const void* boxes, const void* scores,
                            const void* labels, int wide_labels,
                            const void* valid, void* keep, int batch, int n,
                            float thr, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = fast_nms_smem(n);
  if (smem > kMaxBlockShared)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {  // above the default limit of dynamic memory
    err = cudaFuncSetAttribute(fast_nms_kernel<int64_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fast_nms_kernel<int32_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int sms = 0;
  const int got = sm_count(&sms);
  if (got != 0) return got;
  // kFastColsPerWarp columns a warp, at most two blocks an SM in all
  const int cols = kFastWarps * kFastColsPerWarp;
  const int per = max(1, min((n + cols - 1) / cols, 2 * sms / batch));
  const long long grid = static_cast<long long>(batch) * per;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide_labels) {
    fast_nms_kernel<int64_t><<<static_cast<unsigned>(grid), kFastThreads,
                               smem, s>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores),
        static_cast<const int64_t*>(labels),
        static_cast<const uint8_t*>(valid), n, per, thr,
        static_cast<uint8_t*>(keep));
  } else {
    fast_nms_kernel<int32_t><<<static_cast<unsigned>(grid), kFastThreads,
                               smem, s>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores),
        static_cast<const int32_t*>(labels),
        static_cast<const uint8_t*>(valid), n, per, thr,
        static_cast<uint8_t*>(keep));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
