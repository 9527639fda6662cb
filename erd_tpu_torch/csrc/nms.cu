// Greedy class-aware NMS keep mask, and CrowdDet's set-NMS, hand-written
// for Hopper (sm_90a).
//
// Replaces: erd_tpu/ops/nms.py `_suppress_matrix` + `_greedy_fixpoint`
// (reached through `nms_mask`, `batched_nms_mask`, `nms_select`), and
// `set_nms_mask` (:107), the same recursion with
// sup[i, j] &= group[i] != group[j]: two boxes of one group (the two
// instances that one CrowdDet proposal predicts) never suppress each other.
// On the TPU
// the greedy recursion
//     alive[j] = valid[j] && !exists i < j: sup[i, j] && alive[i]
// was solved as a Jacobi fixpoint of (K)x(K, K) 0/1 products on the MXU over
// a dense bf16 suppression matrix. Here it is the bitmask form of the same
// recursion, in two launches per batch:
//   1. nms_mask_kernel, grid (ceil(K/64), ceil(K/64), B), 64 threads: each
//      block stages 64 column boxes in shared memory; thread r writes the
//      64-bit word of row i = 64 * blockIdx.y + r for that column block:
//      bit j set <=> j > i && valid[i] && iou(i, j) > thr, and for set-NMS
//      && group[i] != group[j] (the column block's groups are staged beside
//      its boxes; a null `group` is plain NMS). Blocks below the diagonal
//      are never read and exit at once.
//   2. nms_reduce_kernel, one block per image: walks the sorted rows in
//      tiles of 64. The block stages the tile's mask words right of the
//      diagonal in shared memory; one thread resolves the tile's 64 rows
//      serially against the diagonal word in a register (a row lives if it
//      is valid and its `removed` bit is clear, and then removes the bits of
//      its diagonal word); then every thread ORs the live rows' words into
//      its share of the later `removed` words, and the tile's keep bits are
//      scattered back to the caller's original order through `order`.
// The caller (erd_tpu_torch/ops/nms.py) does the stable descending sort, the
// gather and the class offset (set-NMS is class-agnostic). K is a runtime
// argument (2000 at predict and in CrowdDet's set-NMS, 4481 in the ERD
// distillation NMS; up to about 28,000, where one tile of mask words fills
// the 227 KB of shared memory).
//
// Exactness: the IoU is computed op for op as the reference does, every op
// rounded on its own (__fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, and
// the library is built with -fmad=false): area = max(x2-x1,0)*max(y2-y1,0),
// union = max((a_i + a_j) - ov, 1e-6), iou = ov / union, then a strict `>`.
// An FMA contraction of (a_i + a_j) - iw*ih would flip keep bits at the
// threshold.
//
// Bound on this card: the work is K^2/2 IoUs (about 14 fp32 operations each,
// 28 MFLOP per image at K = 2000) and tens of KB of traffic, a roofline of
// well under a microsecond. What bounds the kernel in practice is the greedy
// recursion, which is serial in the rows. A first version walked all K rows
// with one warp and read each kept row's words from device memory: 0.80 ms
// at K = 2000, latency of dependent loads. This version keeps the serial
// part to one register and shared memory: per tile, 64 cheap serial steps
// in one thread, then a parallel OR over the later words, with the tile's
// words brought in by one coalesced load of the whole block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                const int64_t* __restrict__ group, int k,
                                int words, float thr,
                                unsigned long long* __restrict__ mask) {
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;  // lower triangle: never read
  const size_t b = blockIdx.z;
  const int row_start = row_block * kTile;
  const int col_start = col_block * kTile;
  const int rows = min(k - row_start, kTile);
  const int cols = min(k - col_start, kTile);
  const float4* bb = boxes + b * k;

  __shared__ float4 col_box[kTile];
  __shared__ float col_area[kTile];
  __shared__ int64_t col_group[kTile];
  const int64_t* gb = group == nullptr ? nullptr : group + b * k;
  if (threadIdx.x < cols) {
    const float4 c = bb[col_start + threadIdx.x];
    col_box[threadIdx.x] = c;
    col_area[threadIdx.x] = box_area(c);
    if (gb != nullptr) col_group[threadIdx.x] = gb[col_start + threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;

  const int i = row_start + threadIdx.x;
  unsigned long long bits = 0ULL;
  if (valid[b * k + i]) {
    const float4 r = bb[i];
    const float ra = box_area(r);
    const int64_t rg = gb != nullptr ? gb[i] : 0;
    const int j0 = (row_block == col_block) ? threadIdx.x + 1 : 0;
    for (int j = j0; j < cols; ++j) {
      const float4 c = col_box[j];
      const float iw =
          fmaxf(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 0.f);
      const float ih =
          fmaxf(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 0.f);
      const float ov = __fmul_rn(iw, ih);
      const float uni = fmaxf(__fsub_rn(__fadd_rn(ra, col_area[j]), ov), 1e-6f);
      if (__fdiv_rn(ov, uni) > thr && (gb == nullptr || col_group[j] != rg))
        bits |= 1ULL << j;
    }
  }
  mask[(b * k + i) * words + col_block] = bits;
}

__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const uint8_t* __restrict__ valid,
                                  const int64_t* __restrict__ order, int k,
                                  int words, uint8_t* __restrict__ keep) {
  // shared: removed[words], then the tile's words tile[64][words - t]
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;
  unsigned long long* tile = smem + words;
  __shared__ unsigned long long live_bits;
  __shared__ uint8_t tile_valid[kTile];
  const size_t b = blockIdx.x;
  const unsigned long long* mb = mask + b * k * words;
  const uint8_t* vb = valid + b * k;
  const int64_t* ob = order + b * k;
  uint8_t* kb = keep + b * k;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ULL;

  for (int t = 0; t < words; ++t) {
    const int row0 = t * kTile;
    const int rows = min(k - row0, kTile);
    const int ncols = words - t;  // words t .. words-1 of each tile row
    __syncthreads();  // removed[] of the previous tile is complete
    for (int e = threadIdx.x; e < rows * ncols; e += blockDim.x) {
      const int r = e / ncols;
      const int c = e - r * ncols;
      tile[e] = mb[(size_t)(row0 + r) * words + t + c];
    }
    if (threadIdx.x < rows) tile_valid[threadIdx.x] = vb[row0 + threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long rem = removed[t];
      unsigned long long live = 0ULL;
      for (int r = 0; r < rows; ++r) {
        if (tile_valid[r] && !((rem >> r) & 1ULL)) {
          live |= 1ULL << r;
          rem |= tile[r * ncols];
        }
      }
      removed[t] = rem;
      live_bits = live;
    }
    __syncthreads();
    const unsigned long long live = live_bits;
    for (int c = 1 + threadIdx.x; c < ncols; c += blockDim.x) {
      unsigned long long acc = removed[t + c];
      for (int r = 0; r < rows; ++r)
        if ((live >> r) & 1ULL) acc |= tile[r * ncols + c];
      removed[t + c] = acc;
    }
    if (threadIdx.x < rows)
      kb[ob[row0 + threadIdx.x]] = ((live >> threadIdx.x) & 1ULL) ? 1 : 0;
  }
}

}  // namespace

// boxes (B, K, 4) fp32 sorted and class-shifted; valid (B, K) uint8 sorted;
// group null (NMS) or (B, K) int64 sorted group ids (set-NMS);
// order (B, K) int64, order[b, i] = original index of sorted entry i;
// mask (B, K, ceil(K/64)) uint64 scratch; keep (B, K) uint8 out, original
// order. Returns cudaGetLastError() after the two launches.
extern "C" int erd_nms_keep(const void* boxes, const void* valid,
                            const void* group, const void* order, void* mask,
                            void* keep, int batch, int k, float thr,
                            void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int words = (k + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(group), k, words, thr,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(unsigned long long) * (words + kTile * words);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_reduce_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_reduce_kernel<<<batch, 128, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<const int64_t*>(order),
      k, words, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* erd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
