// Matrix NMS (score decay), fast NMS and nms_match's grouping, hand-written
// for Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/extra_nms.py `matrix_nms` (:17), `fast_nms` (:44)
// and the leader pass of `nms_match` (:84), and the inline mask-IoU decay
// of SOLOv2's decode (erd_tpu/models/detectors/solov2.py:399-410). On the
// TPU each was one dense (N, N) matrix expression that XLA fused: where,
// max / min over an axis, exp. Here each is a pass over the matrix whose
// entries are computed where they are used, never stored, but for the
// precomputed mask IoU of SOLOv2, which is read.
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
// 2. Fast NMS (`erd_fast_nms_keep`): the caller sorts (stable, descending,
//    invalid last) and gathers; one thread per sorted column j computes
//    max over i < j of the same class of iou(i, j) and keeps j if that is
//    <= thr and j is valid, written back to j's original slot through
//    `order`. The rows i come through shared memory in tiles of 128.
// 3. nms_match's leader (`erd_nms_match_leader`): given the greedy keep mask
//    (row 1's kernel, csrc/nms.cu), one thread per box i takes the first
//    argmax by score over kept j with iou(i, j) > thr, or -1 where no finite
//    candidate exists or i is invalid; the candidates j come through
//    shared memory in tiles of 128, walked in index order, so a tie keeps
//    the lowest index as argmax does.
//
// IoU: op for op as erd_tpu's bbox_overlaps, each op rounded on its own:
// area = max(x2 - x1, 0) * max(y2 - y1, 0), ov = max(min(x2) - max(x1), 0)
// * max(min(y2) - max(y1), 0), iou = ov / max((a_1 + a_2) - ov, 1e-6).
// The sum a_1 + a_2 commutes exactly, so iou(i, j) == iou(j, i) bitwise.
//
// Bound on this card: operations. A call does N^2 pair terms (an IoU of
// ~14 float32 operations where computed, plus an exp or a division): at
// N = 500 (SOLOv2's nms_pre) about 10 MFLOP, at N = 2000 about 60 MFLOP,
// 0.15-1 microsecond at 67 TFLOP/s; the bytes are a few KB (boxes) or 1 MB
// (a 500 x 500 IoU). Every launch is far below a launch's own cost, so the
// launches bound these kernels in practice; the design keeps them to two
// (matrix decay) or one (the others) per call, whatever the batch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;

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

__global__ void fast_nms_kernel(const float4* __restrict__ sboxes,
                                const int64_t* __restrict__ slabels,
                                const uint8_t* __restrict__ svalid,
                                const int64_t* __restrict__ order, int n,
                                float thr, uint8_t* __restrict__ keep) {
  __shared__ float4 tb[kTile];
  __shared__ float ta[kTile];
  __shared__ int64_t tl[kTile];
  const size_t b = blockIdx.y;
  const float4* bx = sboxes + b * n;
  const int64_t* lab = slabels + b * n;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < n;
  const float4 bj = live ? bx[j] : make_float4(0, 0, 0, 0);
  const float area_j = box_area(bj);
  const int64_t lj = live ? lab[j] : 0;
  // rows i < j only: the block's last column bounds the tiles it needs
  const int last = min(n, (blockIdx.x + 1) * blockDim.x);
  float best = 0.f;
  bool nan = false;
  for (int t0 = 0; t0 < last - 1; t0 += kTile) {
    __syncthreads();
    for (int r = threadIdx.x; r < kTile && t0 + r < n; r += blockDim.x) {
      const float4 bi = bx[t0 + r];
      tb[r] = bi;
      ta[r] = box_area(bi);
      tl[r] = lab[t0 + r];
    }
    __syncthreads();
    const int stop = min(kTile, j - t0);
    for (int r = 0; r < stop; ++r) {
      if (tl[r] != lj) continue;
      const float v = pair_iou(tb[r], ta[r], bj, area_j);
      nan |= isnan(v);
      best = fmaxf(best, v);
    }
  }
  if (live)
    keep[b * n + order[b * n + j]] =
        (!nan && best <= thr && svalid[b * n + j]) ? 1 : 0;
}

__global__ void nms_match_leader_kernel(const float4* __restrict__ boxes,
                                        const float* __restrict__ scores,
                                        const uint8_t* __restrict__ keep,
                                        const uint8_t* __restrict__ valid,
                                        int n, float thr,
                                        int64_t* __restrict__ leader) {
  __shared__ float4 tb[kTile];
  __shared__ float ta[kTile];
  __shared__ float ts[kTile];
  __shared__ uint8_t tk[kTile];
  const size_t b = blockIdx.y;
  const float4* bx = boxes + b * n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const bool vi = live && valid[b * n + i];
  const float4 bi = live ? bx[i] : make_float4(0, 0, 0, 0);
  const float area_i = box_area(bi);
  float best = -INFINITY;
  int64_t arg = 0;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();
    for (int r = threadIdx.x; r < kTile && t0 + r < n; r += blockDim.x) {
      const float4 bj = bx[t0 + r];
      tb[r] = bj;
      ta[r] = box_area(bj);
      ts[r] = scores[b * n + t0 + r];
      tk[r] = keep[b * n + t0 + r];
    }
    __syncthreads();
    if (!vi) continue;
    const int stop = min(kTile, n - t0);
    for (int r = 0; r < stop; ++r) {
      if (!tk[r] || !(pair_iou(bi, area_i, tb[r], ta[r]) > thr)) continue;
      if (ts[r] > best) {  // strict: the first maximum stays
        best = ts[r];
        arg = t0 + r;
      }
    }
  }
  if (live) leader[b * n + i] = (vi && isfinite(best)) ? arg : -1;
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

// sboxes (B, N, 4) float32, slabels (B, N) int64, svalid (B, N) uint8, all
// sorted by descending score; order (B, N) int64 (original index of sorted
// entry j); keep (B, N) uint8 out, original order.
extern "C" int erd_fast_nms_keep(const void* sboxes, const void* slabels,
                                 const void* svalid, const void* order,
                                 void* keep, int batch, int n, float thr,
                                 void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, batch);
  fast_nms_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(sboxes),
      static_cast<const int64_t*>(slabels),
      static_cast<const uint8_t*>(svalid),
      static_cast<const int64_t*>(order), n, thr, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

// boxes (B, N, 4) float32, scores (B, N) float32, keep and valid (B, N)
// uint8, input order; leader (B, N) int64 out.
extern "C" int erd_nms_match_leader(const void* boxes, const void* scores,
                                    const void* keep, const void* valid,
                                    void* leader, int batch, int n, float thr,
                                    void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, batch);
  nms_match_leader_kernel<<<grid, kTile, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(keep), static_cast<const uint8_t*>(valid),
      n, thr, static_cast<int64_t*>(leader));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
