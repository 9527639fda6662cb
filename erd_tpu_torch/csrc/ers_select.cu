// ERS (Elastic Response Selection) of the ERD distillation, hand-written
// for Hopper (sm_90a).
//
// Replaces: erd_tpu/models/detectors/gfl_erd.py `ers_cls_mask_dense` (:96)
// and the reg branch of `erd_distill_losses` (:135-142, :159-176), built
// from erd_tpu/ops/misc.py `masked_mean_std` (:50) and `topk_mask_select`
// (:36). Per image, over the N anchor rows of the teacher's outputs:
//   cls criterion  c_i = max_j sigmoid(t_cls[i, j])  (the teacher's classes)
//   reg criterion  r_i = max_j t_reg[i, j]           (4 * (reg_max + 1) bins)
//   threshold      mean + 2 * sqrt(max(var, 1e-12)), var with ddof 1
//   cls_mask[i]  = c_i > thr_cls                      (dense, uncapped)
//   reg list     = the top-`cap` rows by r, descending, equal values lowest
//                  row first (lax.top_k's order), reg_mask = r > thr_reg,
//                  count = the number of masked slots.
// On the TPU this is a vmapped reduction plus a lax.top_k (a full sort of
// each image's N values). Here four launches:
//   1. ers_criteria_kernel, one thread per (image, row): c_i and r_i, each
//      sigmoid rounded as torch's (1 / (1 + expf(-x)), IEEE division), and
//      r_i's order-preserving 32-bit key (-0 counted as +0).
//   2. ers_stats_kernel, one block per image: the two-pass mean and sample
//      variance of both criteria (block tree sums), the two thresholds, and
//      a radix select (four 8-bit histogram passes over the keys) of the
//      cap-th largest key k.
//   3. ers_compact_kernel, one thread per (image, row): the row's cls mask;
//      rows with key >= k join the image's candidate set (about cap rows,
//      more only where values tie at k), in any order.
//   4. ers_rank_kernel, one thread per candidate: its rank among the
//      candidates, counted against tiles of them staged in shared memory
//      (rank = #{j : r_j > r_i or (r_j == r_i and j < i)}, unique by
//      construction, and equal to the rank among all N rows since every
//      row outside the set is smaller). A candidate of rank < cap writes its
//      slot of the list directly; the masked slots are counted with one
//      atomicAdd per slot (integer, so the count is deterministic).
// The slots past the count matter as much as the others: they are the rows
// of the next-largest criteria, and their decoded boxes still feed the
// class offset of the batched NMS that follows.
//
// Bound on this card: bytes. The function reads the teacher's 40 class and
// 68 distribution logits of every row (432 B) and writes 1 B of mask per row
// and 9 B per list slot: 155 MB at B = 16, N = 22400, ~46 us at 3.35 TB/s.
// The ranking does M^2 comparisons for M ~ cap candidates per image (a
// sort would do M log M); they read shared-memory broadcasts and need no
// merge pass. Ranking all N rows instead would cost N^2 (25x more at
// N = 22400, cap = 4481): the radix select is what keeps the set at ~cap.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStatThreads = 1024;
constexpr int kTile = 1024;

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// Unsigned key whose order is the order of the floats (no NaN); -0 == +0.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void ers_criteria_kernel(const float* __restrict__ t_cls,
                                    const float* __restrict__ t_reg,
                                    int n, int c_cls, int c_reg,
                                    float* __restrict__ crit,
                                    unsigned* __restrict__ keys) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(b) * n + i;
  const float* xc = t_cls + row * c_cls;
  float c = sigmoid_rn(xc[0]);
  for (int j = 1; j < c_cls; ++j) c = fmaxf(c, sigmoid_rn(xc[j]));
  const float* xr = t_reg + row * c_reg;
  float r = xr[0];
  for (int j = 1; j < c_reg; ++j) r = fmaxf(r, xr[j]);
  crit[(static_cast<size_t>(b) * 2) * n + i] = c;
  crit[(static_cast<size_t>(b) * 2 + 1) * n + i] = r;
  keys[row] = order_key(r);
}

// Sum of v over the block (all threads get the result).
__device__ float block_sum(float v, float* scratch) {
  scratch[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      scratch[threadIdx.x] = __fadd_rn(scratch[threadIdx.x],
                                       scratch[threadIdx.x + s]);
    __syncthreads();
  }
  const float total = scratch[0];
  __syncthreads();
  return total;
}

__global__ void ers_stats_kernel(const float* __restrict__ crit,
                                 const unsigned* __restrict__ keys, int n,
                                 int cap, float* __restrict__ thr,
                                 unsigned* __restrict__ kth) {
  __shared__ float scratch[kStatThreads];
  __shared__ int hist[256];
  __shared__ unsigned prefix_s;
  __shared__ int remaining_s;
  const int b = blockIdx.x;
  const float cnt = static_cast<float>(n);
  for (int which = 0; which < 2; ++which) {
    const float* x = crit + (static_cast<size_t>(b) * 2 + which) * n;
    float s = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s = __fadd_rn(s, x[i]);
    const float mean = __fdiv_rn(block_sum(s, scratch), fmaxf(cnt, 1.f));
    float q = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float d = __fsub_rn(x[i], mean);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(block_sum(q, scratch),
                                fmaxf(__fsub_rn(cnt, 1.f), 1.f));
    if (threadIdx.x == 0)
      thr[b * 2 + which] =
          __fadd_rn(mean, __fmul_rn(2.f, __fsqrt_rn(fmaxf(var, 1e-12f))));
  }
  // radix select of the cap-th largest key, most significant byte first
  const unsigned* k = keys + static_cast<size_t>(b) * n;
  if (threadIdx.x == 0) {
    prefix_s = 0u;
    remaining_s = cap;
  }
  unsigned mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (threadIdx.x < 256) hist[threadIdx.x] = 0;
    __syncthreads();
    const unsigned prefix = prefix_s;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      if ((k[i] & mask) == prefix) atomicAdd(&hist[(k[i] >> shift) & 255u], 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      int rem = remaining_s;
      int d = 255;
      for (; d > 0 && hist[d] < rem; --d) rem -= hist[d];
      prefix_s = prefix | (static_cast<unsigned>(d) << shift);
      remaining_s = rem;
    }
    mask |= 255u << shift;
    __syncthreads();
  }
  if (threadIdx.x == 0) kth[b] = prefix_s;
}

__global__ void ers_compact_kernel(const float* __restrict__ crit,
                                   const unsigned* __restrict__ keys,
                                   const float* __restrict__ thr,
                                   const unsigned* __restrict__ kth, int n,
                                   uint8_t* __restrict__ cls_mask,
                                   int* __restrict__ cand,
                                   int* __restrict__ n_cand) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(b) * n + i;
  cls_mask[row] = crit[(static_cast<size_t>(b) * 2) * n + i] > thr[b * 2];
  if (keys[row] >= kth[b])
    cand[static_cast<size_t>(b) * n + atomicAdd(n_cand + b, 1)] = i;
}

__global__ void ers_rank_kernel(const float* __restrict__ crit,
                                const unsigned* __restrict__ keys,
                                const float* __restrict__ thr,
                                const int* __restrict__ cand,
                                const int* __restrict__ n_cand, int n,
                                int cap, int64_t* __restrict__ reg_idx,
                                uint8_t* __restrict__ reg_mask,
                                int* __restrict__ count) {
  __shared__ unsigned tile_key[kTile];
  __shared__ int tile_idx[kTile];
  const int b = blockIdx.y;
  const int m = n_cand[b];
  if (static_cast<int>(blockIdx.x * blockDim.x) >= m) return;  // whole block
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int* cb = cand + static_cast<size_t>(b) * n;
  const unsigned* kb = keys + static_cast<size_t>(b) * n;
  const int i = t < m ? cb[t] : 0;
  const unsigned ki = kb[i];
  int rank = 0;
  for (int base = 0; base < m; base += kTile) {
    const int len = min(kTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int idx = cb[base + j];
      tile_idx[j] = idx;
      tile_key[j] = kb[idx];
    }
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const unsigned kj = tile_key[j];
      rank += (kj > ki || (kj == ki && tile_idx[j] < i)) ? 1 : 0;
    }
  }
  if (t >= m || rank >= cap) return;
  const float ri = crit[(static_cast<size_t>(b) * 2 + 1) * n + i];
  const bool sel = ri > thr[b * 2 + 1];
  reg_idx[static_cast<size_t>(b) * cap + rank] = i;
  reg_mask[static_cast<size_t>(b) * cap + rank] = sel ? 1 : 0;
  if (sel) atomicAdd(count + b, 1);
}

}  // namespace

// t_cls (B, N, c_cls) fp32; t_reg (B, N, c_reg) fp32; scratch: crit
// (B, 2, N) fp32, keys (B, N) uint32, cand (B, N) int32, thr (B, 2) fp32,
// kth (B,) uint32, n_cand (B,) int32; outputs cls_mask (B, N) uint8, reg_idx
// (B, cap) int64, reg_mask (B, cap) uint8, count (B,) int32. cap <= N.
// Returns the first CUDA error of the steps.
extern "C" int erd_ers_select(const void* t_cls, const void* t_reg,
                              int batch, int n, int c_cls, int c_reg, int cap,
                              void* crit, void* keys, void* cand, void* thr,
                              void* kth, void* n_cand, void* cls_mask,
                              void* reg_idx, void* reg_mask, void* count,
                              void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (cap < 1 || cap > n || c_cls < 1 || c_reg < 1 || batch > 65535)
    return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * batch, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(n_cand, 0, sizeof(int) * batch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  ers_criteria_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(t_cls), static_cast<const float*>(t_reg), n,
      c_cls, c_reg, static_cast<float*>(crit), static_cast<unsigned*>(keys));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ers_stats_kernel<<<batch, kStatThreads, 0, s>>>(
      static_cast<const float*>(crit), static_cast<const unsigned*>(keys), n,
      cap, static_cast<float*>(thr), static_cast<unsigned*>(kth));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ers_compact_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(crit), static_cast<const unsigned*>(keys),
      static_cast<const float*>(thr), static_cast<const unsigned*>(kth), n,
      static_cast<uint8_t*>(cls_mask), static_cast<int*>(cand),
      static_cast<int*>(n_cand));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ers_rank_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(crit), static_cast<const unsigned*>(keys),
      static_cast<const float*>(thr), static_cast<const int*>(cand),
      static_cast<const int*>(n_cand), n, cap,
      static_cast<int64_t*>(reg_idx), static_cast<uint8_t*>(reg_mask),
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
