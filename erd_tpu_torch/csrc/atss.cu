// ATSS anchor assignment, hand-written for Hopper (sm_90a).
//
// Replaces: erd_tpu/task/atss.py:46 `atss_assign` (vmapped over the batch
// by erd_tpu/models/heads/gfl_head.py `gfl_targets`). On the TPU the
// assignment is dense: an (N, G) IoU matrix and an (N, G) distance matrix,
// a lax.top_k per level over -distance, a gather of the candidates' IoUs,
// a scatter-max of the positives back into an (N, G) mask and an argmax
// over G. Here neither (N, G) matrix exists in memory, and each level is
// scanned once:
//   1. atss_scan_kernel, a block of 256 threads per (image, gt, chunk of
//      2048 anchors of one level), so that the grid fills the card at a
//      few gts an image: each thread keeps its best keys in a sorted list
//      in registers, a key (float bits of the distance) << 32 | anchor
//      index (distances are >= 0, so the bits order as the floats, and
//      equal distances give the lowest index first: lax.top_k's order);
//      each warp merges its lanes' lists by warp minimum reductions over
//      the list heads (the owning lane pops), one warp ranks the 8 warps'
//      lists (a key's slot is the count of smaller keys: no serial
//      rounds), and the chunk's min(topk, level size) keys go to a
//      scratch.
//   2. atss_select_kernel, a warp per (image, gt): it ranks each level's
//      chunk lists into the level's candidates, the lanes compute the
//      candidates' IoUs, one
//      lane takes their mean and sample std one slot at a time in
//      candidate order (the plain version sums in the same order, so both
//      round alike), and the lanes post every positive that passes the
//      >= threshold and centre-in-gt tests to its anchor with one 64-bit
//      atomicMax of (IoU bits | 2^31) << 32 | (2^32 - 1 - gt): the largest
//      IoU wins and, among equal IoUs, the lowest gt index (argmax's first
//      maximum). IoU >= 0, so its bits order as the floats do.
//   3. atss_resolve_kernel, one thread per (image, anchor), decodes that
//      word into pos_mask, gt_idx, max_overlaps and labels.
// Distances and IoUs are rounded op for op as the reference computes them
// (every op rounded on its own, the library built with -fmad=false):
// centre = (x1 + x2) / 2, d = sqrt(dx*dx + dy*dy), union = (a1 + a2) - ov,
// iou = ov / max(union, 1e-6). Padded gts leave at once; an invalid anchor
// is at distance 1e8 (a candidate, never positive); a level smaller than
// topk gives all its anchors.
//
// Bound on this card: bytes. The inputs are the (N, 4) anchors, the padded
// gts and the (B, N) valid flags; the outputs are four (B, N) arrays and
// the 64-bit word, about 22 B per anchor and image, 8 MB at B = 16,
// N = 22400: ~2.5 us at 3.35 TB/s. The arithmetic, a distance per real
// (gt, anchor), is ~7 flops each. The time is set by the chains: one scan
// of a chunk, a warp merge of topk rounds, the serial statistics of ~45
// slots, and the four launches (memset, scan, select, resolve).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long Key;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;  // anchors a scan block takes
constexpr int kMaxSlots = 8 * 32;  // levels * topk
constexpr float kInf = 1e8f;
constexpr Key kNone = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

// (a + b) / 2, rounded as the division: halving is exact, so the product
// by 0.5 rounds alike and costs no division
__device__ __forceinline__ float center(float a, float b) {
  return __fmul_rn(__fadd_rn(a, b), 0.5f);
}

__device__ __forceinline__ Key warp_min(Key v) {
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// the distance of a key
__device__ __forceinline__ float dist(Key key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

// chunks of a level of `size` anchors
__device__ __forceinline__ int chunks(int size) {
  return (size + kChunk - 1) / kChunk;
}

// insert key into the ascending list l (its largest entry drops out)
template <int K>
__device__ __forceinline__ void insert(Key (&l)[K], Key key) {
  if (key >= l[K - 1]) return;
#pragma unroll
  for (int i = K - 1; i > 0; --i) {
    const Key up = l[i - 1] > key ? l[i - 1] : key;
    l[i] = l[i] < up ? l[i] : up;
  }
  l[0] = l[0] < key ? l[0] : key;
}

template <int K>
__device__ __forceinline__ void pop(Key (&l)[K]) {
#pragma unroll
  for (int i = 0; i < K - 1; ++i) l[i] = l[i + 1];
  l[K - 1] = kNone;
}

// The keys of `keys` (count of them, in shared memory) whose rank among
// them (the count of smaller keys) is below len, written at out[rank] by
// the calling warp; out holds kNone where no key ranks. Keys are unique
// but for the empty entries (kNone), which rank past every real key. The
// comparisons read every key without an early exit, so that the loads do
// not wait one on another.
__device__ __forceinline__ void rank_into(const Key* keys, int count,
                                          int len, Key* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < len; i += 32) out[i] = kNone;
  __syncwarp();
  for (int i = lane; i < count; i += 32) {
    const Key key = keys[i];
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < count; ++j) rank += keys[j] < key;
    if (rank < len) out[rank] = key;
  }
  __syncwarp();
}

// K: the register list's length, >= topk
template <int K>
__global__ void __launch_bounds__(kThreads)
atss_scan_kernel(const float4* __restrict__ anchors,
                 const int* __restrict__ starts, int levels,
                 const float4* __restrict__ gts,
                 const uint8_t* __restrict__ gt_mask,
                 const uint8_t* __restrict__ valid, int n, int g_count,
                 int topk, int t_max, Key* __restrict__ keys) {
  const int bg = blockIdx.x;
  if (!gt_mask[bg]) return;
  int c = blockIdx.y, l = 0, s = 0, e = 0;
  for (; l < levels; ++l) {
    s = starts[l];
    e = starts[l + 1];
    if (c < chunks(e - s)) break;
    c -= chunks(e - s);
  }
  if (l == levels) return;
  const int lo = s + c * kChunk;
  const int hi = min(e, lo + kChunk);
  const int rounds = min(topk, e - s);
  const float4 gt = gts[bg];
  const float gcx = center(gt.x, gt.z);
  const float gcy = center(gt.y, gt.w);
  const uint8_t* vb = valid + static_cast<size_t>(bg / g_count) * n;

  Key list[K];
#pragma unroll
  for (int i = 0; i < K; ++i) list[i] = kNone;
  for (int a = lo + threadIdx.x; a < hi; a += kThreads) {
    float d = kInf;
    if (vb[a]) {
      const float4 an = anchors[a];
      const float dx = __fsub_rn(center(an.x, an.z), gcx);
      const float dy = __fsub_rn(center(an.y, an.w), gcy);
      d = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    }
    insert(list, (static_cast<Key>(__float_as_uint(d)) << 32) |
                     static_cast<unsigned>(a));
  }

  __shared__ Key warp_top[kWarps * K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < rounds; ++r) {
    const Key m = warp_min(list[0]);
    if (m != kNone && list[0] == m) pop(list);
    if (lane == 0) warp_top[warp * rounds + r] = m;
  }
  __syncthreads();
  if (warp != 0) return;
  // the 8 warps' lists: each key's rank among them is its slot
  Key* out = keys + (static_cast<size_t>(bg) * t_max + blockIdx.y) * topk;
  rank_into(warp_top, kWarps * rounds, rounds, out);
}

// A warp (block) an (image, gt); dynamic shared memory: t_max * topk keys.
__global__ void __launch_bounds__(32)
atss_select_kernel(const float4* __restrict__ anchors,
                   const int* __restrict__ starts, int levels,
                   const float4* __restrict__ gts,
                   const uint8_t* __restrict__ gt_mask, int n, int g_count,
                   int topk, int t_max, const Key* __restrict__ keys,
                   Key* __restrict__ best) {
  const int lane = threadIdx.x;
  const int bg = blockIdx.x;
  if (!gt_mask[bg]) return;
  const int b = bg / g_count;
  const int g = bg - b * g_count;
  const float4 gt = gts[bg];

  extern __shared__ Key staged[];
  __shared__ Key cand[kMaxSlots];
  __shared__ float ov[kMaxSlots];

  // every level's chunk lists, packed level by level, in one pass of loads
  const Key* kb = keys + static_cast<size_t>(bg) * t_max * topk;
  int chunk0 = 0, packed = 0;
  for (int l = 0; l < levels; ++l) {
    const int size = starts[l + 1] - starts[l];
    const int nc = chunks(size);
    const int k = min(topk, size);
    for (int i = lane; i < nc * k; i += 32)
      staged[packed + i] = kb[(chunk0 + i / k) * topk + i % k];
    chunk0 += nc;
    packed += nc * k;
  }
  __syncwarp();
  // each level's keys: a key's rank among them is its candidate slot
  int slots = 0;
  packed = 0;
  for (int l = 0; l < levels; ++l) {
    const int size = starts[l + 1] - starts[l];
    const int count = chunks(size) * min(topk, size);
    rank_into(staged + packed, count, min(topk, size), cand + slots);
    slots += min(topk, size);
    packed += count;
  }

  const float garea = __fmul_rn(fmaxf(__fsub_rn(gt.z, gt.x), 0.f),
                                fmaxf(__fsub_rn(gt.w, gt.y), 0.f));
  for (int k = lane; k < slots; k += 32) {
    const float4 an = anchors[cand[k] & 0xffffffffull];
    const float aarea = __fmul_rn(fmaxf(__fsub_rn(an.z, an.x), 0.f),
                                  fmaxf(__fsub_rn(an.w, an.y), 0.f));
    const float iw = fmaxf(__fsub_rn(fminf(an.z, gt.z), fmaxf(an.x, gt.x)),
                           0.f);
    const float ih = fmaxf(__fsub_rn(fminf(an.w, gt.w), fmaxf(an.y, gt.y)),
                           0.f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = fmaxf(__fsub_rn(__fadd_rn(aarea, garea), inter), 1e-6f);
    ov[k] = __fdiv_rn(inter, uni);
  }
  __syncwarp();

  float thr = 0.f;
  if (lane == 0) {
    float sum = 0.f, cnt = 0.f;
    for (int k = 0; k < slots; ++k) {
      const float cv = dist(cand[k]) < kInf ? 1.f : 0.f;
      sum = __fadd_rn(sum, __fmul_rn(ov[k], cv));
      cnt = __fadd_rn(cnt, cv);
    }
    cnt = fmaxf(cnt, 1.f);
    const float mean = __fdiv_rn(sum, cnt);
    float sq = 0.f;
    for (int k = 0; k < slots; ++k) {
      const float cv = dist(cand[k]) < kInf ? 1.f : 0.f;
      const float dv = __fsub_rn(ov[k], mean);
      sq = __fadd_rn(sq, __fmul_rn(__fmul_rn(dv, dv), cv));
    }
    const float var = __fdiv_rn(sq, fmaxf(__fsub_rn(cnt, 1.f), 1.f));
    thr = __fadd_rn(mean, __fsqrt_rn(fmaxf(var, 0.f)));
  }
  thr = __shfl_sync(kFull, thr, 0);

  for (int k = lane; k < slots; k += 32) {
    if (!(dist(cand[k]) < kInf) || !(ov[k] >= thr)) continue;
    const int a = static_cast<int>(cand[k] & 0xffffffffull);
    const float4 an = anchors[a];
    const float cx = center(an.x, an.z);
    const float cy = center(an.y, an.w);
    const float side =
        fminf(fminf(__fsub_rn(cx, gt.x), __fsub_rn(cy, gt.y)),
              fminf(__fsub_rn(gt.z, cx), __fsub_rn(gt.w, cy)));
    if (!(side > 0.01f)) continue;
    const Key key =
        (static_cast<Key>(__float_as_uint(ov[k]) | 0x80000000u) << 32) |
        (0xffffffffull - static_cast<Key>(g));
    atomicMax(best + static_cast<size_t>(b) * n + a, key);
  }
}

__global__ void atss_resolve_kernel(const Key* __restrict__ best,
                                    const int* __restrict__ gt_labels,
                                    int batch, int n, int g_count,
                                    uint8_t* __restrict__ pos,
                                    int64_t* __restrict__ gt_idx,
                                    float* __restrict__ max_ov,
                                    int64_t* __restrict__ labels) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= static_cast<long long>(batch) * n) return;
  const Key key = best[t];
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

// scan blocks an (image, gt): at most one chunk more per level than the
// anchors' chunks in all
int chunk_slots(int n, int levels) {
  return (n + kChunk - 1) / kChunk + levels;
}

}  // namespace

// 64-bit words of erd_atss_assign's workspace: the (B, N) word each anchor
// resolves from, then the scan blocks' candidate keys.
extern "C" long long erd_atss_workspace_words(int batch, int n, int g_count,
                                              int levels, int topk) {
  return static_cast<long long>(batch) * n +
         static_cast<long long>(batch) * g_count * chunk_slots(n, levels) *
             topk;
}

// anchors (N, 4) fp32; starts (levels + 1,) int32 level offsets; gts
// (B, G, 4) fp32; gt_labels (B, G) int32; gt_mask (B, G) uint8; valid
// (B, N) uint8; best the workspace (erd_atss_workspace_words 64-bit
// words); outputs pos (B, N) uint8, gt_idx (B, N) int64, max_ov (B, N)
// fp32, labels (B, N) int64. topk <= 32, levels <= 8. Returns the first
// CUDA error of the four steps.
extern "C" int erd_atss_assign(const void* anchors, const void* starts,
                               const void* gts, const void* gt_labels,
                               const void* gt_mask, const void* valid,
                               int batch, int n, int g_count, int levels,
                               int topk, void* best, void* pos, void* gt_idx,
                               void* max_ov, void* labels, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (topk < 1 || topk > 32 || levels < 1 || levels > 8) return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Key* words = static_cast<Key*>(best);
  cudaError_t err = cudaMemsetAsync(
      words, 0, sizeof(Key) * static_cast<size_t>(batch) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_count > 0) {
    const int t_max = chunk_slots(n, levels);
    Key* keys = words + static_cast<size_t>(batch) * n;
    const dim3 grid(batch * g_count, t_max);
    const float4* an = static_cast<const float4*>(anchors);
    const int* st = static_cast<const int*>(starts);
    const float4* gt = static_cast<const float4*>(gts);
    const uint8_t* gm = static_cast<const uint8_t*>(gt_mask);
    if (topk <= 9)
      atss_scan_kernel<9><<<grid, kThreads, 0, s>>>(
          an, st, levels, gt, gm, static_cast<const uint8_t*>(valid), n,
          g_count, topk, t_max, keys);
    else
      atss_scan_kernel<32><<<grid, kThreads, 0, s>>>(
          an, st, levels, gt, gm, static_cast<const uint8_t*>(valid), n,
          g_count, topk, t_max, keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t staged = sizeof(Key) * t_max * topk;
    if (staged > 48 * 1024) {
      err = cudaFuncSetAttribute(atss_select_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(staged));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    atss_select_kernel<<<batch * g_count, 32, staged, s>>>(
        an, st, levels, gt, gm, n, g_count, topk, t_max, keys, words);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = static_cast<long long>(batch) * n;
  atss_resolve_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        s>>>(
      words, static_cast<const int*>(gt_labels), batch, n, g_count,
      static_cast<uint8_t*>(pos), static_cast<int64_t*>(gt_idx),
      static_cast<float*>(max_ov), static_cast<int64_t*>(labels));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
