// ATSS anchor assignment, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/task/atss.py `atss_assign` (vmapped over the batch by
// erd_tpu/models/heads/gfl_head.py `gfl_targets`). On the TPU the
// assignment is dense: an (N, G) IoU matrix and an (N, G) distance matrix,
// a lax.top_k per level over -distance, a gather of the candidates' IoUs,
// a scatter-max of the positives back into an (N, G) mask and an argmax
// over G. Here neither (N, G) matrix exists in memory:
//   1. atss_candidates_kernel, one block of 256 threads per (image, gt):
//      for each level it picks the topk nearest valid anchor centres by
//      topk passes of a block-wide lexicographic argmin over
//      (distance, anchor index) above the previous pick, which gives
//      lax.top_k's order (equal distances lowest index first). Thread 0
//      then computes the candidates' IoUs, their mean and sample std one
//      slot at a time in candidate order (the plain version sums in the
//      same order, so both round alike), the >= threshold and centre-in-gt
//      tests, and posts every positive to its anchor with one 64-bit
//      atomicMax of (IoU bits | 2^31) << 32 | (2^32 - 1 - gt): the largest
//      IoU wins and, among equal IoUs, the lowest gt index (argmax's first
//      maximum). IoU >= 0, so its bits order as the floats do.
//   2. atss_resolve_kernel, one thread per (image, anchor), decodes that
//      word into pos_mask, gt_idx, max_overlaps and labels.
// Distances and IoUs are rounded op for op as the reference computes them
// (every op rounded on its own, the library built with -fmad=false):
// centre = (x1 + x2) / 2, d = sqrt(dx*dx + dy*dy), union = (a1 + a2) - ov,
// iou = ov / max(union, 1e-6).
//
// Bound on this card: bytes. The inputs are the (N, 4) anchors, the padded
// gts and the (B, N) valid flags; the outputs are four (B, N) arrays, about
// 19 B per anchor and image, 7 MB at B = 16, N = 22400: ~2 us at 3.35 TB/s.
// The arithmetic, B*G*topk*N distance evaluations, is ~50 M flops. The
// kernel re-reads the anchors topk times per level from L2 (358 KB, always
// resident) instead of keeping per-thread candidate lists, which would go
// to local memory; the serial per-gt statistics are 45 slots.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 8 * 32;  // levels * topk
constexpr float kInf = 1e8f;

__device__ __forceinline__ bool lex_less(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

__device__ __forceinline__ float center(float a, float b) {
  return __fdiv_rn(__fadd_rn(a, b), 2.f);
}

__global__ void atss_candidates_kernel(
    const float4* __restrict__ anchors, const int* __restrict__ starts,
    int levels, const float4* __restrict__ gts,
    const uint8_t* __restrict__ gt_mask, const uint8_t* __restrict__ valid,
    int n, int g_count, int topk,
    unsigned long long* __restrict__ best) {
  const int b = blockIdx.x / g_count;
  const int g = blockIdx.x - b * g_count;
  if (!gt_mask[b * g_count + g]) return;
  const float4 gt = gts[b * g_count + g];
  const float gcx = center(gt.x, gt.z);
  const float gcy = center(gt.y, gt.w);
  const uint8_t* vb = valid + static_cast<size_t>(b) * n;

  __shared__ int slot_idx[kMaxSlots];
  __shared__ float slot_d[kMaxSlots];
  __shared__ float warp_d[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int slots = 0;
  for (int l = 0; l < levels; ++l) {
    const int s = starts[l];
    const int e = starts[l + 1];
    const int k = min(topk, e - s);
    float prev_d = -INFINITY;
    int prev_i = -1;
    for (int r = 0; r < k; ++r) {
      float bd = INFINITY;
      int bi = 0x7fffffff;
      for (int a = s + threadIdx.x; a < e; a += kThreads) {
        float d = kInf;
        if (vb[a]) {
          const float4 an = anchors[a];
          const float dx = __fsub_rn(center(an.x, an.z), gcx);
          const float dy = __fsub_rn(center(an.y, an.w), gcy);
          d = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        }
        if (lex_less(prev_d, prev_i, d, a) && lex_less(d, a, bd, bi)) {
          bd = d;
          bi = a;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_down_sync(0xffffffffu, bd, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (lex_less(od, oi, bd, bi)) {
          bd = od;
          bi = oi;
        }
      }
      if (lane == 0) {
        warp_d[warp] = bd;
        warp_i[warp] = bi;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 1; w < kThreads / 32; ++w)
          if (lex_less(warp_d[w], warp_i[w], bd, bi)) {
            bd = warp_d[w];
            bi = warp_i[w];
          }
        slot_idx[slots + r] = bi;
        slot_d[slots + r] = bd;
      }
      __syncthreads();
      prev_d = slot_d[slots + r];
      prev_i = slot_idx[slots + r];
    }
    slots += k;
  }
  if (threadIdx.x != 0) return;

  const float garea = __fmul_rn(fmaxf(__fsub_rn(gt.z, gt.x), 0.f),
                                fmaxf(__fsub_rn(gt.w, gt.y), 0.f));
  float ov[kMaxSlots];
  float sum = 0.f, cnt = 0.f;
  for (int k = 0; k < slots; ++k) {
    const float4 an = anchors[slot_idx[k]];
    const float aarea = __fmul_rn(fmaxf(__fsub_rn(an.z, an.x), 0.f),
                                  fmaxf(__fsub_rn(an.w, an.y), 0.f));
    const float iw = fmaxf(__fsub_rn(fminf(an.z, gt.z), fmaxf(an.x, gt.x)),
                           0.f);
    const float ih = fmaxf(__fsub_rn(fminf(an.w, gt.w), fmaxf(an.y, gt.y)),
                           0.f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = fmaxf(__fsub_rn(__fadd_rn(aarea, garea), inter), 1e-6f);
    ov[k] = __fdiv_rn(inter, uni);
    const float cv = slot_d[k] < kInf ? 1.f : 0.f;
    sum = __fadd_rn(sum, __fmul_rn(ov[k], cv));
    cnt = __fadd_rn(cnt, cv);
  }
  cnt = fmaxf(cnt, 1.f);
  const float mean = __fdiv_rn(sum, cnt);
  float sq = 0.f;
  for (int k = 0; k < slots; ++k) {
    const float cv = slot_d[k] < kInf ? 1.f : 0.f;
    const float dv = __fsub_rn(ov[k], mean);
    sq = __fadd_rn(sq, __fmul_rn(__fmul_rn(dv, dv), cv));
  }
  const float var = __fdiv_rn(sq, fmaxf(__fsub_rn(cnt, 1.f), 1.f));
  const float thr = __fadd_rn(mean, __fsqrt_rn(fmaxf(var, 0.f)));
  for (int k = 0; k < slots; ++k) {
    if (!(slot_d[k] < kInf) || !(ov[k] >= thr)) continue;
    const float4 an = anchors[slot_idx[k]];
    const float cx = center(an.x, an.z);
    const float cy = center(an.y, an.w);
    const float side =
        fminf(fminf(__fsub_rn(cx, gt.x), __fsub_rn(cy, gt.y)),
              fminf(__fsub_rn(gt.z, cx), __fsub_rn(gt.w, cy)));
    if (!(side > 0.01f)) continue;
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(ov[k]) |
                                         0x80000000u) << 32) |
        (0xffffffffull - static_cast<unsigned long long>(g));
    atomicMax(best + static_cast<size_t>(b) * n + slot_idx[k], key);
  }
}

__global__ void atss_resolve_kernel(const unsigned long long* __restrict__ best,
                                    const int* __restrict__ gt_labels,
                                    int batch, int n, int g_count,
                                    uint8_t* __restrict__ pos,
                                    int64_t* __restrict__ gt_idx,
                                    float* __restrict__ max_ov,
                                    int64_t* __restrict__ labels) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= static_cast<long long>(batch) * n) return;
  const unsigned long long key = best[t];
  if (key == 0ull) {
    pos[t] = 0;
    gt_idx[t] = 0;
    max_ov[t] = -kInf;
    labels[t] = -1;
    return;
  }
  const int b = static_cast<int>(t / n);
  const int g = static_cast<int>(0xffffffffull - (key & 0xffffffffull));
  pos[t] = 1;
  gt_idx[t] = g;
  max_ov[t] = __uint_as_float(static_cast<unsigned>(key >> 32) & 0x7fffffffu);
  labels[t] = gt_labels[b * g_count + g];
}

}  // namespace

// anchors (N, 4) fp32; starts (levels + 1,) int32 level offsets; gts
// (B, G, 4) fp32; gt_labels (B, G) int32; gt_mask (B, G) uint8; valid
// (B, N) uint8; best (B, N) uint64 scratch; outputs pos (B, N) uint8,
// gt_idx (B, N) int64, max_ov (B, N) fp32, labels (B, N) int64. topk <= 32,
// levels <= 8. Returns the first CUDA error of the three steps.
extern "C" int erd_atss_assign(const void* anchors, const void* starts,
                               const void* gts, const void* gt_labels,
                               const void* gt_mask, const void* valid,
                               int batch, int n, int g_count, int levels,
                               int topk, void* best, void* pos, void* gt_idx,
                               void* max_ov, void* labels, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (topk < 1 || topk > 32 || levels < 1 || levels > 8) return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      best, 0, sizeof(unsigned long long) * static_cast<size_t>(batch) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_count > 0) {
    atss_candidates_kernel<<<batch * g_count, kThreads, 0, s>>>(
        static_cast<const float4*>(anchors), static_cast<const int*>(starts),
        levels, static_cast<const float4*>(gts),
        static_cast<const uint8_t*>(gt_mask),
        static_cast<const uint8_t*>(valid), n, g_count, topk,
        static_cast<unsigned long long*>(best));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = static_cast<long long>(batch) * n;
  atss_resolve_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        s>>>(
      static_cast<const unsigned long long*>(best),
      static_cast<const int*>(gt_labels), batch, n, g_count,
      static_cast<uint8_t*>(pos), static_cast<int64_t*>(gt_idx),
      static_cast<float*>(max_ov), static_cast<int64_t*>(labels));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
