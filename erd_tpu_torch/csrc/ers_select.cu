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
//                  row first and +0 before -0 (lax.top_k's order),
//                  reg_mask = r > thr_reg,
//                  count = the number of masked slots.
// On the TPU this is a vmapped reduction plus a lax.top_k (a full sort of
// each image's N values).
//
// Bound on this card: bytes. The function reads the teacher's 40 class and
// 68 distribution logits of every row (432 B) and writes 1 B of mask per row
// and 9 B per list slot: 155 MB at B = 16, N = 22400, ~46 us at 3.35 TB/s.
// Everything after the read works on 4 bytes a row that stay in L2.
//
// Design, three launches and no memset:
//   1. ers_criteria_kernel, a warp a run of 32 rows: the rows' class and
//      distribution logits read as coalesced 16-byte loads (each 16 bytes
//      lie in one row when the widths are multiples of 4), each load's
//      maximum staged in shared memory and a row's maxima taken by its
//      lane; c_i = sigmoid(max logit) rounded as torch's sigmoid (1 / (1 +
//      expf(-x)), IEEE division; the sigmoid is monotone, so this is the
//      largest sigmoid up to its rounding), and r_i's 32-bit key in IEEE
//      totalOrder (-0 below +0, lax.top_k's order). Each block writes its
//      sums, its sums of squares about its own mean (Chan's form) and its
//      smallest and largest key.
//   2. ers_select_kernel, a block an image: the blocks' statistics in a
//      fixed order (mean, and the variance as sum(M2_k + n_k (mean_k -
//      mean)^2)), the two thresholds; then a radix select of the cap-th
//      largest of the unique 64-bit keys (r's key, then the complemented
//      row index) over the image's keys staged in shared memory: each
//      round histograms the 11 bits below the common prefix of the rows
//      still in play, so the rows that tie at the cap-th criterion are
//      split by their row index and the selection is exactly `cap` rows;
//      once the rows in play fit in 2048 they are listed in shared memory
//      (the rows tied at the cap-th criterion, ~200 here) and the later
//      rounds read the list alone.
//      The selected keys are then grouped by an 11-bit digit below their
//      own common prefix (a counting sort: bins in descending order,
//      arbitrary order within a bin) into the image's slot range.
//   3. ers_rank_kernel, a thread a slot and a row: a slot's rank is its
//      bin's start plus the keys of its bin that are larger (keys are
//      unique, so ranks are exact and deterministic); it writes the slot's
//      row, its mask and counts the masked slots with one integer atomic a
//      warp; a row writes its cls mask.
// The slots past the count matter as much as the others: they are the rows
// of the next-largest criteria, and their decoded boxes still feed the
// class offset of the batched NMS that follows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = kThreads;  // a warp 32 rows
constexpr int kVecMaxWidth = 128;        // widest row the 16-byte path stages
constexpr int kSelThreads = 1024;
constexpr int kDigitBits = 11;
constexpr int kBins = 1 << kDigitBits;
constexpr int kStageRows = 40960;  // keys staged in shared memory up to this N
constexpr int kPlay = 2048;        // keys in play listed in shared memory
constexpr int kPart = 6;  // a criteria block: sum_c, m2_c, sum_r, m2_r, keys
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// Unsigned key whose order is IEEE totalOrder of the floats (no NaN): -0
// below +0, as lax.top_k ranks them.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The unique 64-bit key of row i: larger for a larger criterion, and for
// an equal one, larger for a lower row.
__device__ __forceinline__ u64 full_key(unsigned ok, int i) {
  return (static_cast<u64>(ok) << 32) | static_cast<unsigned>(~i);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The largest value of each of a warp's `rows` rows of q4 16-byte chunks
// (from base, 16-byte aligned), returned to lane r for row r: each chunk's
// maximum staged in fm, then each lane's row reduced.
__device__ __forceinline__ float warp_row_max(const float* base, int rows,
                                              int q4, float* fm, int lane) {
  const float4* b4 = reinterpret_cast<const float4*>(base);
  const int total = rows * q4;
#pragma unroll 4
  for (int q = lane; q < total; q += 32) {
    const float4 v = __ldg(b4 + q);
    fm[q] = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
  }
  __syncwarp();
  float m = -INFINITY;
  if (lane < rows)
    for (int k = 0; k < q4; ++k) m = fmaxf(m, fm[lane * q4 + k]);
  __syncwarp();
  return m;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ers_criteria_kernel(const float* __restrict__ t_cls,
                    const float* __restrict__ t_reg, int n, int c_cls,
                    int c_reg, float* __restrict__ crit_c,
                    unsigned* __restrict__ okeys, float* __restrict__ part) {
  extern __shared__ float stage[];
  __shared__ float red[kWarps][2];
  __shared__ unsigned redk[kWarps][2];
  __shared__ float mean_s[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRowsPerBlock + warp * 32;
  const int rows = max(0, min(32, n - r0));
  const bool live = lane < rows;
  const size_t g0 = static_cast<size_t>(b) * n + r0;

  float cmax = -INFINITY, rmax = -INFINITY;
  if (kVec) {
    float* fm = stage + warp * 32 * (max(c_cls, c_reg) / 4);
    cmax = warp_row_max(t_cls + g0 * c_cls, rows, c_cls / 4, fm, lane);
    rmax = warp_row_max(t_reg + g0 * c_reg, rows, c_reg / 4, fm, lane);
  } else if (live) {
    const float* xc = t_cls + (g0 + lane) * c_cls;
    for (int j = 0; j < c_cls; ++j) cmax = fmaxf(cmax, xc[j]);
    const float* xr = t_reg + (g0 + lane) * c_reg;
    for (int j = 0; j < c_reg; ++j) rmax = fmaxf(rmax, xr[j]);
  }
  const float c = live ? sigmoid_rn(cmax) : 0.f;
  const float rv = live ? rmax : 0.f;
  const unsigned ok = order_key(rmax);
  if (live) {
    crit_c[g0 + lane] = c;
    okeys[g0 + lane] = ok;
  }

  // the block's sums, then its sums of squares about its own mean, each in
  // a fixed order; its smallest and largest key
  const float sc = warp_sum(c), sr = warp_sum(rv);
  const unsigned kmin = __reduce_min_sync(kFull, live ? ok : 0xffffffffu);
  const unsigned kmax = __reduce_max_sync(kFull, live ? ok : 0u);
  if (lane == 0) {
    red[warp][0] = sc;
    red[warp][1] = sr;
    redk[warp][0] = kmin;
    redk[warp][1] = kmax;
  }
  __syncthreads();
  const int cnt = min(kRowsPerBlock, n - static_cast<int>(blockIdx.x) *
                                             kRowsPerBlock);
  if (threadIdx.x < 2) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    mean_s[threadIdx.x] = s / static_cast<float>(cnt);
    part[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kPart +
         threadIdx.x * 2] = s;
  }
  __syncthreads();
  const float dc = live ? c - mean_s[0] : 0.f;
  const float dr = live ? rv - mean_s[1] : 0.f;
  const float qc = warp_sum(dc * dc), qr = warp_sum(dr * dr);
  __syncthreads();
  if (lane == 0) {
    red[warp][0] = qc;
    red[warp][1] = qr;
  }
  __syncthreads();
  float* out = part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                          kPart;
  if (threadIdx.x < 2) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x * 2 + 1] = s;
  } else if (threadIdx.x < 4) {
    const int k = threadIdx.x - 2;
    unsigned v = redk[0][k];
    for (int w = 1; w < kWarps; ++w)
      v = k == 0 ? min(v, redk[w][k]) : max(v, redk[w][k]);
    out[4 + k] = __uint_as_float(v);
  }
}

// Exclusive prefix sum of v over the block (kSelThreads threads); wsum is
// 32 ints of shared scratch.
__device__ int block_excl_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? wsum[warp - 1] : 0);
  __syncthreads();
  return excl;
}

// The bins of hist (nbins, a power of two <= kBins) in descending order:
// start[d] = the count of the bins above d. Also returns, in *bin and
// *above, the bin that holds the rem-th largest entry and the count above
// it (when rem >= 1 and the bins hold at least rem).
__device__ void descending_starts(const int* hist, int nbins, int rem,
                                  int* start, int* wsum, int* bin,
                                  int* above) {
  // thread t takes the bins nbins - 1 - 2t and nbins - 2 - 2t
  const int d0 = nbins - 1 - 2 * static_cast<int>(threadIdx.x);
  const int h0 = d0 >= 0 ? hist[d0] : 0;
  const int h1 = d0 >= 1 ? hist[d0 - 1] : 0;
  const int excl = block_excl_scan(h0 + h1, wsum);
  if (d0 >= 0) start[d0] = excl;
  if (d0 >= 1) start[d0 - 1] = excl + h0;
  if (d0 >= 0 && excl < rem && rem <= excl + h0) {
    *bin = d0;
    *above = excl;
  } else if (d0 >= 1 && excl + h0 < rem && rem <= excl + h0 + h1) {
    *bin = d0 - 1;
    *above = excl + h0;
  }
  __syncthreads();
}

// The key of entry i: row i's of the n keys, or the i-th listed one.
__device__ __forceinline__ u64 key_at(const unsigned* keys, const u64* play,
                                      bool listed, int i) {
  return listed ? play[i] : full_key(keys[i], i);
}

// min and max over the block of the keys in play (bits under pmask equal
// to prefix) among the n keys or the m listed ones; with `compact`, the
// keys in play are also listed in play (their count *np).
__device__ void block_key_range(const unsigned* keys, int n, u64* play,
                                int m, bool listed, bool compact, u64 pmask,
                                u64 prefix, u64* lo, u64* hi, int* np,
                                u64 (*red)[2]) {
  u64 mn = ~0ull, mx = 0ull;
  for (int i = threadIdx.x; i < (listed ? m : n); i += kSelThreads) {
    const u64 k = key_at(keys, play, listed, i);
    if ((k & pmask) == prefix) {
      mn = min(mn, k);
      mx = max(mx, k);
      if (compact) play[atomicAdd(np, 1)] = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(kFull, mn, off));
    mx = max(mx, __shfl_xor_sync(kFull, mx, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp][0] = mn;
    red[warp][1] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSelThreads / 32; ++w) {
      mn = min(mn, red[w][0]);
      mx = max(mx, red[w][1]);
    }
    *lo = mn;
    *hi = mx;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kSelThreads)
ers_select_kernel(const float* __restrict__ part, int nblk,
                  const unsigned* __restrict__ okeys, int n, int cap,
                  float* __restrict__ thr, u64* __restrict__ grp,
                  int2* __restrict__ seg, int* __restrict__ count) {
  extern __shared__ unsigned staged[];
  __shared__ int hist[kBins];
  __shared__ int start[kBins];
  __shared__ int cursor[kBins];
  __shared__ int wsum[32];
  __shared__ u64 red[kSelThreads / 32][2];
  __shared__ u64 play[kPlay];
  __shared__ u64 lo_s, hi_s;
  __shared__ unsigned kmin_s, kmax_s;
  __shared__ int bin_s, above_s, np_s;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned* kg = okeys + static_cast<size_t>(b) * n;
  const unsigned* keys = n <= kStageRows ? staged : kg;
  if (n <= kStageRows)
    for (int i = threadIdx.x; i < n; i += kSelThreads) staged[i] = kg[i];

  // statistics of the image: its blocks' partials in a fixed order
  if (threadIdx.x < 32) {
    const float* pb = part + static_cast<size_t>(b) * nblk * kPart;
    float sc = 0.f, sr = 0.f;
    unsigned mn = 0xffffffffu, mx = 0u;
    for (int k = lane; k < nblk; k += 32) {
      sc += pb[k * kPart];
      sr += pb[k * kPart + 2];
      mn = min(mn, __float_as_uint(pb[k * kPart + 4]));
      mx = max(mx, __float_as_uint(pb[k * kPart + 5]));
    }
    const float cnt = static_cast<float>(n);
    const float mean_c = warp_sum(sc) / cnt;
    const float mean_r = warp_sum(sr) / cnt;
    float qc = 0.f, qr = 0.f;
    for (int k = lane; k < nblk; k += 32) {
      const float nk = static_cast<float>(min(kRowsPerBlock,
                                              n - k * kRowsPerBlock));
      const float dc = pb[k * kPart] / nk - mean_c;
      const float dr = pb[k * kPart + 2] / nk - mean_r;
      qc += pb[k * kPart + 1] + nk * dc * dc;
      qr += pb[k * kPart + 3] + nk * dr * dr;
    }
    const float den = fmaxf(cnt - 1.f, 1.f);
    const float var_c = warp_sum(qc) / den;
    const float var_r = warp_sum(qr) / den;
    const unsigned kmin = __reduce_min_sync(kFull, mn);
    const unsigned kmax = __reduce_max_sync(kFull, mx);
    if (lane == 0) {
      thr[b * 2] = mean_c + 2.f * sqrtf(fmaxf(var_c, 1e-12f));
      thr[b * 2 + 1] = mean_r + 2.f * sqrtf(fmaxf(var_r, 1e-12f));
      kmin_s = kmin;
      kmax_s = kmax;
      np_s = 0;
      count[b] = 0;
    }
  }
  __syncthreads();

  // radix select of the cap-th largest 64-bit key. Invariant: the rows in
  // play are those whose key's bits under pmask equal prefix; rem of them
  // are still to be taken; lo <= their keys <= hi. Once they fit in kPlay,
  // they are listed (the first round's boundary bin: the rows tied at the
  // cap-th criterion, in the common case) and the later rounds read only
  // the list.
  u64 prefix = 0ull, pmask = 0ull, kt;
  u64 lo = full_key(kmin_s, n - 1);
  u64 hi = full_key(kmax_s, 0);
  int rem = cap, m = 0;
  bool listed = false;
  while (true) {
    if (lo == hi) {  // one row left in play
      kt = lo;
      break;
    }
    const int d = 63 - __clzll(lo ^ hi);
    const u64 common = d == 63 ? 0ull : ~0ull << (d + 1);
    prefix = lo & common;
    pmask = common;
    const int shift = max(d - kDigitBits + 1, 0);
    const int nbits = d - shift + 1;
    const int nbins = 1 << nbits;
    for (int i = threadIdx.x; i < nbins; i += kSelThreads) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < (listed ? m : n); i += kSelThreads) {
      const u64 k = key_at(keys, play, listed, i);
      if ((k & pmask) == prefix)
        atomicAdd(&hist[(k >> shift) & (nbins - 1)], 1);
    }
    __syncthreads();
    descending_starts(hist, nbins, rem, start, wsum, &bin_s, &above_s);
    const int bin = bin_s;
    rem -= above_s;
    prefix |= static_cast<u64>(bin) << shift;
    pmask |= static_cast<u64>(nbins - 1) << shift;
    const int in_bin = hist[bin];
    __syncthreads();
    if (in_bin == rem) {  // the bin is taken whole: every key >= its least
      kt = prefix;
      break;
    }
    const bool compact = !listed && in_bin <= kPlay;
    block_key_range(keys, n, play, m, listed, compact, pmask, prefix, &lo_s,
                    &hi_s, &np_s, red);
    lo = lo_s;
    hi = hi_s;
    if (compact) {
      listed = true;
      m = in_bin;
    }
  }

  // group the cap selected keys (key >= kt) by a digit below their common
  // prefix, bins in descending order
  const u64 top = full_key(kmax_s, 0);
  const int d = kt == top ? 0 : 63 - __clzll(kt ^ top);
  const int shift = max(d - kDigitBits + 1, 0);
  const int nbins = 1 << (d - shift + 1);
  for (int i = threadIdx.x; i < nbins; i += kSelThreads) {
    hist[i] = 0;
    cursor[i] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSelThreads) {
    const u64 k = full_key(keys[i], i);
    if (k >= kt) atomicAdd(&hist[(k >> shift) & (nbins - 1)], 1);
  }
  __syncthreads();
  descending_starts(hist, nbins, 0, start, wsum, &bin_s, &above_s);
  u64* gb = grp + static_cast<size_t>(b) * cap;
  int2* sb = seg + static_cast<size_t>(b) * cap;
  for (int i = threadIdx.x; i < n; i += kSelThreads) {
    const u64 k = full_key(keys[i], i);
    if (k >= kt) {
      const int bin = static_cast<int>((k >> shift) & (nbins - 1));
      const int pos = start[bin] + atomicAdd(&cursor[bin], 1);
      gb[pos] = k;
      sb[pos] = make_int2(start[bin], start[bin] + hist[bin]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ers_rank_kernel(const float* __restrict__ crit_c,
                const float* __restrict__ thr, const u64* __restrict__ grp,
                const int2* __restrict__ seg, int n, int cap,
                uint8_t* __restrict__ cls_mask, int64_t* __restrict__ reg_idx,
                uint8_t* __restrict__ reg_mask, int* __restrict__ count) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const size_t row = static_cast<size_t>(b) * n + t;
  if (t < n) cls_mask[row] = crit_c[row] > thr[b * 2];
  bool sel = false;
  if (t < cap) {
    const u64* gb = grp + static_cast<size_t>(b) * cap;
    const u64 k = gb[t];
    const int2 sg = seg[static_cast<size_t>(b) * cap + t];
    int rank = sg.x;
    for (int j = sg.x; j < sg.y; ++j) rank += gb[j] > k ? 1 : 0;
    sel = key_value(static_cast<unsigned>(k >> 32)) > thr[b * 2 + 1];
    const size_t slot = static_cast<size_t>(b) * cap + rank;
    reg_idx[slot] = static_cast<int>(~static_cast<unsigned>(k));
    reg_mask[slot] = sel ? 1 : 0;
  }
  const unsigned votes = __ballot_sync(kFull, sel);
  if ((threadIdx.x & 31) == 0 && votes != 0u)
    atomicAdd(count + b, __popc(votes));
}

}  // namespace

// Criteria blocks of an image (the statistics scratch is (B, blocks, 6)).
extern "C" int erd_ers_blocks(int n) {
  return (n + kRowsPerBlock - 1) / kRowsPerBlock;
}

// t_cls (B, N, c_cls) fp32; t_reg (B, N, c_reg) fp32; scratch: crit (B, N)
// fp32, keys (B, N) uint32, part (B, blocks, 6) fp32, thr (B, 2) fp32, grp
// (B, cap) uint64, seg (B, cap, 2) int32; outputs cls_mask (B, N) uint8,
// reg_idx (B, cap) int64, reg_mask (B, cap) uint8, count (B,) int32.
// 1 <= cap <= N, B <= 65535. Returns the first CUDA error of the steps.
extern "C" int erd_ers_select(const void* t_cls, const void* t_reg,
                              int batch, int n, int c_cls, int c_reg, int cap,
                              void* crit, void* keys, void* part, void* thr,
                              void* grp, void* seg, void* cls_mask,
                              void* reg_idx, void* reg_mask, void* count,
                              void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (cap < 1 || cap > n || c_cls < 1 || c_reg < 1 || batch > 65535)
    return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = erd_ers_blocks(n);
  const dim3 grid(blocks, batch);
  const int width = c_cls > c_reg ? c_cls : c_reg;
  const bool vec = c_cls % 4 == 0 && c_reg % 4 == 0 &&
                   width <= kVecMaxWidth &&
                   reinterpret_cast<uintptr_t>(t_cls) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(t_reg) % 16 == 0;
  if (vec)
    ers_criteria_kernel<true><<<grid, kThreads,
                                kWarps * 32 * (width / 4) * sizeof(float),
                                s>>>(
        static_cast<const float*>(t_cls), static_cast<const float*>(t_reg),
        n, c_cls, c_reg, static_cast<float*>(crit),
        static_cast<unsigned*>(keys), static_cast<float*>(part));
  else
    ers_criteria_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(t_cls), static_cast<const float*>(t_reg),
        n, c_cls, c_reg, static_cast<float*>(crit),
        static_cast<unsigned*>(keys), static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t staged = n <= kStageRows ? n * sizeof(unsigned) : 0;
  err = cudaFuncSetAttribute(ers_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(staged));
  if (err != cudaSuccess) return static_cast<int>(err);
  ers_select_kernel<<<batch, kSelThreads, staged, s>>>(
      static_cast<const float*>(part), blocks,
      static_cast<const unsigned*>(keys), n, cap, static_cast<float*>(thr),
      static_cast<u64*>(grp), static_cast<int2*>(seg),
      static_cast<int*>(count));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rgrid((n + kThreads - 1) / kThreads, batch);  // cap <= n
  ers_rank_kernel<<<rgrid, kThreads, 0, s>>>(
      static_cast<const float*>(crit), static_cast<const float*>(thr),
      static_cast<const u64*>(grp), static_cast<const int2*>(seg), n, cap,
      static_cast<uint8_t*>(cls_mask), static_cast<int64_t*>(reg_idx),
      static_cast<uint8_t*>(reg_mask), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
