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
//
// The scan is serial in its steps, so the design attacks the cost of a
// step. An image is one thread block, or a thread-block cluster of 2, 4 or
// 8 blocks where K exceeds 3072 slots a block or one block's shared memory
// (the wrapper plans the cluster from K, `soft_nms_plan`); block r of the
// cluster takes the slots [r * slice, (r + 1) * slice).
//   - Compact at load: a block packs its live slots (score > -inf), in
//     index order, into shared-memory planes: the box (float4), its area
//     and its offset in the slice (uint16), 22 B a candidate. Thread t
//     owns the packed slots t + i * threads, i < PER (a compile-time
//     count), and keeps their current scores in registers (their boxes
//     too where PER <= 8).
//   - One pass and one barrier a step: the pass decays each owned score
//     by the previous step's winner (a disjoint box keeps its score times
//     w(0), so its IoU is not computed), drops it below min_score,
//     consumes the winner and takes the thread's best of the new scores.
//     A warp finds its best value by one integer max reduction (REDUX) of
//     an order-preserving key; the lane holding it (or each tied lane)
//     folds (value, lowest key, the sign of a zero) as one 64-bit word into
//     the block's word for the step by a shared-memory atomicMax; then
//     __syncthreads. In a cluster, lanes 0..cs-1 of warp 0 then store the
//     block's word, tagged with the step in its free bits, into a slot of
//     every block's shared memory (DSMEM), and every thread polls its own
//     block's slots until each holds this step's word and takes the
//     largest, in place of a cluster barrier (the tag is the flag: one
//     one-way store a block and step). The word gives the winner's key and
//     value; its box and area come from its owner's planes. The key,
//     (block rank, packed slot), orders as the original index does, so
//     ties go to the lowest index. Words are triple-buffered (reset two
//     steps ahead), slots double-buffered.
//   - Early exit: once the word is empty, nothing is live anywhere; the
//     remaining steps get (0, -inf), as jnp.argmax of an all -inf vector
//     gives, and the blocks stop.
//
// Exactness: the IoU repeats the reference op for op, each op rounded on
// its own (__fsub_rn etc.; the library is built with -fmad=false):
// area = max(x2-x1,0)*max(y2-y1,0), iw = max(min(x2_i,x2)-max(x1_i,x1),0),
// iou = (iw*ih) / max((area_i + area) - iw*ih, 1e-6). The linear decay is
// then bit-exact with the plain version; the gaussian one goes through
// expf, which may differ from the host's exp by an ulp.
//
// Bound on this card: neither bytes nor operations. The inputs are 20 B per
// candidate and the work ~20 flops per candidate and step, microseconds at
// most; the scan is bound by the latency of its steps: a pass over a
// thread's candidates, a warp reduction, shared-memory atomics and one
// barrier each.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kScale = 1024 / kThreads;  // the per-thread counts' scale
constexpr int kMaxCluster = 8;
constexpr int kMaxPer = 11 * kScale;  // candidates a thread, at most
constexpr int kRegBoxesPer = 8;       // up to this many: boxes in registers
constexpr int kBytesPer = 16 + 4 + 2;  // box, area, offset in the slice
constexpr int kStaticReserve = 1024;   // the kernel's static shared memory
constexpr int kNoKey = 0x7fffffff;     // no live candidate
constexpr int kMaxKey = 0x7ffff;       // rank (3 bits), packed slot (16)
// a block's word sent to a peer carries the step in its free bits 20-31
constexpr unsigned long long kTagMask = 0xfffull;
constexpr int kTagShift = 20;

// An unsigned key that orders as the floats do (-0 taken as +0, which
// argmax ties with it).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned i = __float_as_uint(v + 0.f);
  return (i & 0x80000000u) ? ~i : (i | 0x80000000u);
}

__device__ __forceinline__ float order_value(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// A step's word: the value's key, then the key inverted (a lower key wins
// a tie), then the value's sign (read back for a zero). 0: nothing live.
__device__ __forceinline__ unsigned long long pack_best(float v, int key) {
  return (static_cast<unsigned long long>(order_key(v)) << 32) |
         (static_cast<unsigned>(kMaxKey - key) << 1) |
         (__float_as_uint(v) >> 31);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ float decay_weight(float iou, float thr,
                                              float sigma, int gaussian) {
  if (gaussian) return expf(__fdiv_rn(-__fmul_rn(iou, iou), sigma));
  return iou > thr ? __fsub_rn(1.f, iou) : 1.f;
}

template <int PER>
__global__ void __launch_bounds__(kThreads, 1)
soft_nms_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores, int k, int slice, int cs,
                int steps, float thr, float sigma, float min_score,
                int gaussian, int64_t* __restrict__ out_idx,
                float* __restrict__ out_score) {
  extern __shared__ float4 smem[];
  __shared__ int warp_count[kWarps];
  __shared__ unsigned long long word[3];
  __shared__ unsigned long long best_of[2 * kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cs > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const size_t img = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* box = smem;
  float* area = reinterpret_cast<float*>(box + slice);
  uint16_t* off = reinterpret_cast<uint16_t*>(area + slice);
  const float4* bx = boxes + img * k;
  const float* sc = scores + img * k;
  const int lo = rank * slice;
  const int hi = min(k, lo + slice);
  if (tid == 0) word[0] = word[1] = word[2] = 0ull;
  if (tid < 2 * kMaxCluster) best_of[tid] = 0ull;

  // compact the live slots of [lo, hi) in index order
  int n = 0;
  for (int base = lo; base < hi; base += kThreads) {
    const int j = base + tid;
    const bool live = j < hi && sc[j] > -CUDART_INF_F;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (live)
      off[n + before + __popc(m & ((1u << lane) - 1u))] =
          static_cast<uint16_t>(j - lo);
    n += total;
    __syncthreads();
  }
  // a few candidates a thread keep their boxes in registers too
  constexpr bool kRegs = PER <= kRegBoxesPer;
  float cur[PER];
  float4 rbox[kRegs ? PER : 1];
  float rarea[kRegs ? PER : 1];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int p = tid + i * kThreads;
    cur[i] = -CUDART_INF_F;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < n) {
      const int j = lo + off[p];
      b = bx[j];
      box[p] = b;
      area[p] = box_area(b);
      cur[i] = sc[j];
    }
    if constexpr (kRegs) {
      rbox[i] = b;
      rarea[i] = box_area(b);
    }
  }
  if (cs > 1)
    cluster.sync();  // every block's planes, words and slots are set
  else
    __syncthreads();

  const float w0 = decay_weight(0.f, thr, sigma, gaussian);
  const int key0 = rank << 16;
  int wkey = -1;  // the previous step's winner
  float4 wbox = make_float4(0.f, 0.f, 0.f, 0.f);
  float warea = 0.f;
  for (int step = 0; step < steps; ++step) {
    // decay by the previous winner, drop, consume; the thread's best
    float bv = -CUDART_INF_F;
    int bkey = kNoKey;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = tid + i * kThreads;
      float c = cur[i];
      if (step > 0 && c > -CUDART_INF_F) {
        if (key0 + p == wkey) {
          c = -CUDART_INF_F;
        } else {
          const float4 bj = kRegs ? rbox[kRegs ? i : 0] : box[p];
          const float iw = fmaxf(
              __fsub_rn(fminf(wbox.z, bj.z), fmaxf(wbox.x, bj.x)), 0.f);
          const float ih = fmaxf(
              __fsub_rn(fminf(wbox.w, bj.w), fmaxf(wbox.y, bj.y)), 0.f);
          const float ov = __fmul_rn(iw, ih);
          float w = w0;
          if (ov != 0.f) {
            const float aj = kRegs ? rarea[kRegs ? i : 0] : area[p];
            const float uni = fmaxf(__fsub_rn(__fadd_rn(warea, aj), ov),
                                    1e-6f);
            w = decay_weight(__fdiv_rn(ov, uni), thr, sigma, gaussian);
          }
          c = __fmul_rn(c, w);
          if (c < min_score) c = -CUDART_INF_F;
        }
        cur[i] = c;
      }
      if (c > bv) {  // slots in index order: the lowest one keeps a tie
        bv = c;
        bkey = key0 + p;
      }
    }
    // the warp's best value: each tied lane folds it into the block's word
    const unsigned o = order_key(bv);
    const unsigned best = __reduce_max_sync(0xffffffffu, o);
    unsigned long long* w = word + step % 3;
    if (tid == 0) word[(step + 1) % 3] = 0ull;
    if (o == best && bkey != kNoKey) atomicMax(w, pack_best(bv, bkey));
    __syncthreads();
    unsigned long long win = *w;
    if (cs > 1) {
      // lane r of warp 0 stores the block's word, tagged with the step, in
      // block r's slot for this block (DSMEM); every thread polls its own
      // slots until each holds this step's word, and takes the largest
      unsigned long long* got = best_of + (step & 1) * kMaxCluster;
      const unsigned long long tag =
          static_cast<unsigned long long>((step + 1) & kTagMask) << kTagShift;
      if (tid < cs) *cluster.map_shared_rank(got + rank, tid) = win | tag;
      win = 0ull;
      for (int r = 0; r < cs; ++r) {
        unsigned long long v;
        do {
          v = *reinterpret_cast<volatile unsigned long long*>(got + r);
        } while ((v & (kTagMask << kTagShift)) != tag);
        win = max(win, v & ~(kTagMask << kTagShift));
      }
    }
    if (win == 0ull) {  // nothing live: (0, -inf) from here on
      if (rank == 0)
        for (int s = step + tid; s < steps; s += kThreads) {
          out_idx[img * steps + s] = 0;
          out_score[img * steps + s] = -CUDART_INF_F;
        }
      break;
    }
    wkey = kMaxKey - static_cast<int>((win & 0xffffffffu) >> 1);
    const int owner = wkey >> 16, p = wkey & 0xffff;
    if (owner == rank) {
      wbox = box[p];
      warea = area[p];
    } else {
      wbox = cluster.map_shared_rank(box, owner)[p];
      warea = cluster.map_shared_rank(area, owner)[p];
    }
    if (rank == 0 && tid == 0) {
      float v = order_value(static_cast<unsigned>(win >> 32));
      if (v == 0.f && (win & 1ull)) v = -0.f;
      const int at =
          owner == 0 ? off[p] : cluster.map_shared_rank(off, owner)[p];
      out_idx[img * steps + step] = owner * slice + at;
      out_score[img * steps + step] = v;
    }
  }
  if (cs > 1) cluster.sync();  // no block leaves while a peer may read
}

template <int PER>
int launch(const float4* bx, const float* sc, int64_t* oi, float* os,
           int batch, int k, int cs, int slice, int steps, float thr,
           float sigma, float min_score, int gaussian, cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(slice) * kBytesPer + 15) & ~15;
  cudaError_t err = cudaFuncSetAttribute(
      soft_nms_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, soft_nms_kernel<PER>, bx, sc, k, slice, cs,
                           steps, thr, sigma, min_score, gaussian, oi, os);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The candidates one block holds when an image is a cluster of cs blocks
// (1, 2, 4 or 8): its shared memory over 22 B, at most kMaxPer a thread.
// 0 when the device cannot be queried.
extern "C" int erd_soft_nms_capacity(int cs) {
  int dev = 0, optin = 0;
  if (cs < 1 || cs > kMaxCluster) return 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return min((optin - kStaticReserve) / kBytesPer, kMaxPer * kThreads);
}

// The threads of a block; the per-thread counts the kernel is compiled for
// are 1, 2, 3, 4, 6, 8 and 11 times 1024 / threads.
extern "C" int erd_soft_nms_threads() { return kThreads; }

// boxes (B, K, 4) fp32, class-shifted; scores (B, K) fp32, -inf for
// invalid entries; out_idx (B, steps) int64 and out_score (B, steps) fp32,
// steps = min(max_out, K). An image is a cluster of cs blocks (1, 2, 4 or
// 8), each taking `slice` slots (slice <= erd_soft_nms_capacity(cs)) with
// `per` of them a thread (per * threads >= slice; per is one of the
// compiled counts, erd_soft_nms_threads()). gaussian: 0 linear, 1
// gaussian. Returns cudaGetLastError() after the launch.
extern "C" int erd_soft_nms(const void* boxes, const void* scores,
                            void* out_idx, void* out_score, int batch, int k,
                            int cs, int slice, int per, int steps, float thr,
                            float sigma, float min_score, int gaussian,
                            void* stream) {
  if (batch <= 0 || k <= 0 || steps <= 0) return 0;
  if (cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) != 0 ||
      static_cast<long long>(slice) * cs < k ||
      static_cast<long long>(per) * kThreads < slice ||
      slice > erd_soft_nms_capacity(cs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  int64_t* oi = static_cast<int64_t*>(out_idx);
  float* os = static_cast<float*>(out_score);
#define ERD_SOFT_NMS_CASE(P)                                                \
  case P:                                                                   \
    return launch<P>(bx, sc, oi, os, batch, k, cs, slice, steps, thr, sigma, \
                     min_score, gaussian, s);
  switch (per) {
    ERD_SOFT_NMS_CASE(1 * kScale)
    ERD_SOFT_NMS_CASE(2 * kScale)
    ERD_SOFT_NMS_CASE(3 * kScale)
    ERD_SOFT_NMS_CASE(4 * kScale)
    ERD_SOFT_NMS_CASE(6 * kScale)
    ERD_SOFT_NMS_CASE(8 * kScale)
    ERD_SOFT_NMS_CASE(11 * kScale)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ERD_SOFT_NMS_CASE
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
